"""The scatter transpose (``nl_transpose="scatter"``) on row bands under a
space mesh (``pipeline.row_sharded`` is true for it), on the CPU over gloo
ranks.

One world of 2 ranks and one of 3 (``tests/torch_shard_scatter_workers.py``,
which imports no JAX) run every case once, each in a thread, while this
process runs JAX's pair.  The rules:

  * the band scatter operator (every pair deposits at its target slot;
    each band's slot sums add in float64, then over the bands in rank
    order, and round once), both preconditioners (mg and block-Jacobi)
    and a solve of each at pinned iterations are bitwise the single
    process, with bands of 1, 3 and 5 rows and of 4-row units, for a pair
    and for a batch folded into rows, on a P = 3 graph;
  * the TINY variants pair (``knn_memberships=3``, the scatter transpose,
    Jacobi WLS) over 2 and 3 ranks, fed JAX's draws: identical on every
    rank, bitwise the single process (oneDNN off on both sides) with its
    iteration counts, and within ``test_torch_space_shard.py``'s bound of
    JAX's ``transfer_pair`` with the same Config (2 LSB at >= 95%, mean
    <= 1.0);
  * a ``make_batch_transfer(TINY_SCATTER, mesh)`` bucket of 2 over 1x2
    bitwise its single-process vmap bucket.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as mesh_workers
import torch_shard_scatter_workers as workers
from nct_tpu import pipeline as jpipe
from nct_tpu.config import Config as JaxConfig
from nct_tpu_torch import pipeline
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.parallel import batch as tbatch
from nct_tpu_torch.parallel import mesh as tmesh
from nct_tpu_torch.solve import cluster, knn, nonlocal_solve
from test_torch_space_shard import JAX_LSB, JAX_MEAN_MAX, JAX_WITHIN_MIN
from test_torch_space_shard import TINY_JAX
from test_torch_space_shard_multi import _graph_inputs
from test_torch_space_shard_pm import RecordingJaxDraws

torch.set_num_threads(1)

WORLDS = (2, 3)
MEMBERSHIPS = 3


def _stage_inputs(lead):
    """A P = 3 graph on a 53x45 grid (``lead``: a batch axis or none),
    its operands and a vector to apply the operator to."""
    rng = np.random.default_rng(19 + len(lead))
    h, w = 53, 45
    inp = {k: rng.standard_normal(lead + (h, w, 3)).astype(np.float32)
           for k in ("xa", "xb")}
    for k in ("src", "ref"):
        inp[k] = rng.random(lead + (h, w, 3)).astype(np.float32)
    inp["conf"] = (0.05 + rng.random(lead + (h, w))).astype(np.float32)
    label_map, membership, _, cands = _graph_inputs(rng, lead, h, w, 4, 64)
    labels = cluster.multi_labels_for_pixels(label_map, membership, h, w, 8,
                                             MEMBERSHIPS)
    ids, wts, slots = knn.knn_graph(torch.from_numpy(inp["src"]), labels,
                                    cands, 8)
    inp.update(cands=cands.numpy(), ids=ids.numpy(), wts=wts.numpy(),
               slots=slots.numpy())
    return inp


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _single_operator(inp):
    """The single process's operator, preconditioners and pinned solves,
    as ``torch_shard_scatter_workers.operator_case`` returns them."""
    args = (_t(inp["src"]), _t(inp["ref"]), _t(inp["conf"]), _t(inp["ids"]),
            _t(inp["wts"]), 3.0, 0.125, 1.2, 2.0)
    cands, slots = _t(inp["cands"]), _t(inp["slots"])
    xa, xb = _t(inp["xa"]), _t(inp["xb"])
    out = {}
    for kind in nonlocal_solve.PRECOND_KINDS:
        op, _, pre = nonlocal_solve.make_nonlocal_system(
            *args, cands, slots, kind, 0, "scatter")
        if kind == "mg":
            out["op"] = op((xa, xb))
        out[f"pre_{kind}"] = pre((xa, xb))
        a, b, it, _ = nonlocal_solve.solve_nonlocal(
            xa, xb, *args, iters=workers.SOLVE_ITERS, tol=0.0,
            candidates=cands, nbr_slots=slots, precond_kind=kind,
            transpose="scatter")
        out[f"solve_{kind}"] = (a, b, it.tolist() if torch.is_tensor(it)
                                else int(it))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's pair in a thread from the start; meanwhile the port's
    single-process references (oneDNN off, as in the ranks), whose JAX
    draws the ranks replay, then both worlds at once, a thread each."""
    params = mesh_workers.seeded_vgg_params()
    model = vgg19.params_from_numpy(params)
    cnt, stl, seeds = mesh_workers.tiny_pairs(2, *workers.PAIR_HW)
    jax_out = {}

    def jax_pair():
        jax_out["pair"] = np.asarray(jpipe.transfer_pair(
            params, cnt[0], stl[0], 2.0,
            JaxConfig(**TINY_JAX, knn_memberships=MEMBERSHIPS,
                      nl_transpose="scatter", wls_precond="jacobi"),
            key=jax.random.PRNGKey(seeds[0])))

    jax_thread = threading.Thread(target=jax_pair)
    jax_thread.start()
    single, worlds = {}, {}
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            rec = RecordingJaxDraws(seeds[0])
            out, trace = pipeline.transfer_pair(
                model, cnt[0], stl[0], 2.0, mesh_workers.TINY_VARIANTS,
                draws=rec, device="cpu", return_intermediates="stats")
            single["pair"] = (out.numpy(), [
                (int(t["nl_iters"]), int(t["wls_iters"])) for t in trace])
            single["bucket"] = tbatch.make_batch_transfer(
                mesh_workers.TINY_SCATTER, mode="vmap", device="cpu")(
                    model, cnt, stl, seeds, 2.0).numpy()
        stage_inputs = {lead: _stage_inputs(lead) for lead in workers.LEADS}
        single["operator"] = {len(lead): _single_operator(inp)
                              for lead, inp in stage_inputs.items()}
        weights = str(tmp_path_factory.mktemp("vgg") / "vgg.npz")
        mesh_workers.save_taps_weights(weights, params)
        pipe_inputs = {"vgg": weights, "draws": rec.record}
        stores = {n: str(tmp_path_factory.mktemp(f"shard_scatter{n}"))
                  for n in WORLDS}

        def spawn(n):
            worlds[n] = tmesh.launch(workers.scatter_world, n, n,
                                     stage_inputs, pipe_inputs,
                                     store_dir=stores[n], device="cpu")

        threads = [threading.Thread(target=spawn, args=(n,)) for n in WORLDS]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        jax_thread.join()
    assert set(worlds) == set(WORLDS), "a world failed"
    assert "pair" in jax_out, "the JAX pair failed"
    return {"worlds": worlds, "single": single, "jax": jax_out,
            "inputs": stage_inputs}


def _ranks(runs, n, key):
    return [r[key] for r in runs["worlds"][n]]


@pytest.mark.parametrize("lead", [0, 1], ids=["pair", "batch"])
@pytest.mark.parametrize("layout", workers.LAYOUTS)
@pytest.mark.parametrize("n", WORLDS)
def test_band_scatter_operator_and_preconditioners_bitwise(runs, n, layout,
                                                           lead):
    """A x, the V-cycle and the block-Jacobi inverse of one vector: the
    single process's bits on every rank."""
    want = runs["single"]["operator"][lead]
    for st in _ranks(runs, n, "operator"):
        got = st[layout, lead]
        for key in ("op", "pre_mg", "pre_block_jacobi"):
            for g, w in zip(got[key], want[key]):
                assert torch.equal(g, w), key


@pytest.mark.parametrize("lead", [0, 1], ids=["pair", "batch"])
@pytest.mark.parametrize("layout", workers.LAYOUTS)
@pytest.mark.parametrize("n", WORLDS)
def test_band_scatter_solves_bitwise(runs, n, layout, lead):
    """A solve of each preconditioner at pinned iterations: the single
    process's coefficients and iteration counts."""
    want = runs["single"]["operator"][lead]
    for st in _ranks(runs, n, "operator"):
        got = st[layout, lead]
        for kind in nonlocal_solve.PRECOND_KINDS:
            a, b, it = got[f"solve_{kind}"]
            wa, wb, wit = want[f"solve_{kind}"]
            assert torch.equal(a, wa) and torch.equal(b, wb), kind
            assert it == wit
            assert it == ([workers.SOLVE_ITERS] * 2 if lead
                          else workers.SOLVE_ITERS)


@pytest.mark.parametrize("n", WORLDS)
def test_variants_pair_identical_on_every_rank(runs, n):
    ranks = _ranks(runs, n, "pipeline")
    for p in ranks:
        assert p["row_sharded"]
        np.testing.assert_array_equal(p["pair"], ranks[0]["pair"])


@pytest.mark.parametrize("n", WORLDS)
def test_variants_pair_bitwise_single_process(runs, n):
    """Every rank: the single-process pair bit for bit with its (nl, wls)
    iterations per level."""
    out, iters = runs["single"]["pair"]
    for p in _ranks(runs, n, "pipeline"):
        np.testing.assert_array_equal(p["pair"], out)
        assert p["pair_iters"] == iters


@pytest.mark.parametrize("n", WORLDS)
def test_variants_pair_within_jax_bound(runs, n):
    want = runs["jax"]["pair"].astype(int)
    for p in _ranks(runs, n, "pipeline"):
        diff = np.abs(p["pair"].astype(int) - want)
        within, mean = (diff <= JAX_LSB).mean(), diff.mean()
        assert within >= JAX_WITHIN_MIN and mean <= JAX_MEAN_MAX, (within,
                                                                   mean)


def test_scatter_bucket_over_two_ranks_bitwise_vmap(runs):
    for p in _ranks(runs, 2, "pipeline"):
        np.testing.assert_array_equal(p["bucket"], runs["single"]["bucket"])
