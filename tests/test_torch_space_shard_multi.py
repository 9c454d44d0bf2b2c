"""The several-membership (P > 1) k-NN merge on row bands under a space
mesh (``pipeline.row_sharded`` is true for ``knn_memberships > 1``), on
the CPU over gloo ranks.

One world of 2 ranks and one of 3 (``tests/torch_shard_multi_workers.py``,
which imports no JAX) run every case once, each in a thread, while this
process runs JAX's pair.  The rules:

  * the band P = 2 graph (``multi_labels_for_pixels(rows=)``, the
    candidates' colours gathered, global query ids) is the whole graph's
    rows bit for bit, at bands of 1, 3 and 5 rows, for one pair and for a
    batch folded into rows;
  * the band nonlocal operator of a P = 2 graph (its slots owner cluster
    * M + offset, the widest slots capped and ranked across bands) and its
    solve are bitwise the single process;
  * ``TINY_P2`` over 2 and 3 ranks, fed JAX's draws: identical on every
    rank, bitwise the single process (oneDNN off on both sides) with its
    iteration counts, and within ``test_torch_space_shard.py``'s bound of
    JAX's ``transfer_pair`` (2 LSB at >= 95%, mean <= 1.0);
  * a ``make_batch_transfer(TINY_P2, mesh)`` bucket of 2 over 1x2 bitwise
    its single-process vmap bucket.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as mesh_workers
import torch_shard_multi_workers as workers
from nct_tpu import pipeline as jpipe
from nct_tpu.config import Config as JaxConfig
from nct_tpu_torch import Config, pipeline
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.parallel import batch as tbatch
from nct_tpu_torch.parallel import mesh as tmesh
from nct_tpu_torch.solve import cluster, knn, nonlocal_solve
from test_torch_space_shard import JAX_LSB, JAX_MEAN_MAX, JAX_WITHIN_MIN
from test_torch_space_shard import TINY_JAX
from test_torch_space_shard_pm import RecordingJaxDraws

torch.set_num_threads(1)

WORLDS = (2, 3)
IN_CAP = 8


class _FakeMesh:
    shape = {"data": 1, "space": 2}


def test_row_sharded_for_several_memberships():
    """P > 1 runs on row bands, with either transpose."""
    for p in (2, 3):
        assert pipeline.row_sharded(Config(knn_memberships=p,
                                           space_mesh=_FakeMesh()))
        assert pipeline.row_sharded(Config(
            knn_memberships=p, nl_transpose="scatter",
            space_mesh=_FakeMesh()))


def _graph_inputs(rng, lead, h=13, w=11, k=4, m=24, p=2):
    """Labels of P memberships (``multi_labels_for_pixels`` of a random
    conv5_1 grid, stride 2), candidates per cluster and Lab colours."""
    label_map = torch.from_numpy(rng.integers(0, k, lead + (7, 6)))
    membership = cluster.cluster_membership(label_map, k)
    lab = torch.from_numpy(rng.random(lead + (h, w, 3)).astype(np.float32))
    scores = torch.from_numpy(rng.random(lead + (k, h * w)).astype(
        np.float32))
    cands = knn.sample_cluster_candidates(
        cluster.membership_for_pixels(membership, h, w, 2), scores, m)
    return label_map, membership, lab, cands


@pytest.mark.parametrize("lead", [(), (2,)], ids=["pair", "batch"])
@pytest.mark.parametrize("rows", [1, 3, 5])
def test_band_multi_graph_bitwise_whole_rows(rows, lead):
    """Every band of ``rows`` rows (the last shorter): its labels, graph
    ids, weights and slots are the whole graph's rows bit for bit."""
    rng = np.random.default_rng(rows)
    label_map, membership, lab, cands = _graph_inputs(rng, lead)
    h, w = lab.shape[-3], lab.shape[-2]
    labels = cluster.multi_labels_for_pixels(label_map, membership, h, w, 2,
                                             2)
    want = knn.knn_graph(lab, labels, cands, 8, chunk=16)
    colours = lab.reshape(lead + (h * w, 3))
    if lead:
        cand_colors = torch.stack([c[i] for c, i in zip(colours, cands)])
    else:
        cand_colors = colours[cands]
    for y0 in range(0, h, rows):
        y1 = min(y0 + rows, h)
        got_labels = cluster.multi_labels_for_pixels(
            label_map, membership, h, w, 2, 2, rows=(y0, y1))
        assert torch.equal(got_labels, labels[..., y0:y1, :, :])
        got = knn.knn_graph(lab[..., y0:y1, :, :], got_labels, cands, 8,
                            chunk=16, cand_colors=cand_colors, row0=y0 * w,
                            n_total=h * w)
        for g, ref in zip(got, want):
            assert torch.equal(g, ref[..., y0 * w:y1 * w, :])


def _stage_inputs():
    """A P = 2 graph on a 53x45 grid whose widest slots exceed the in-edge
    width (``in_cap`` 8 gives the 1.5x mean width)."""
    rng = np.random.default_rng(18)
    h, w = 53, 45
    inp = {k: rng.standard_normal((h, w, 3)).astype(np.float32)
           for k in ("xa", "xb")}
    for k in ("src", "ref"):
        inp[k] = rng.random((h, w, 3)).astype(np.float32)
    inp["conf"] = (0.05 + rng.random((h, w))).astype(np.float32)
    label_map, membership, _, cands = _graph_inputs(rng, (), h, w, 4, 64)
    labels = cluster.multi_labels_for_pixels(label_map, membership, h, w, 8,
                                             2)
    ids, wts, slots = knn.knn_graph(torch.from_numpy(inp["src"]), labels,
                                    cands, 8)
    inp.update(cands=cands.numpy(), ids=ids.numpy(), wts=wts.numpy(),
               slots=slots.numpy(), in_cap=IN_CAP)
    return inp


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
            JaxConfig(**TINY_JAX, knn_memberships=2),
            key=jax.random.PRNGKey(seeds[0])))

    jax_thread = threading.Thread(target=jax_pair)
    jax_thread.start()
    single, worlds = {}, {}
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            rec = RecordingJaxDraws(seeds[0])
            out, trace = pipeline.transfer_pair(
                model, cnt[0], stl[0], 2.0, mesh_workers.TINY_P2, draws=rec,
                device="cpu", return_intermediates="stats")
            single["pair"] = (out.numpy(), [
                (int(t["nl_iters"]), int(t["wls_iters"])) for t in trace])
            single["bucket"] = tbatch.make_batch_transfer(
                mesh_workers.TINY_P2, mode="vmap", device="cpu")(
                    model, cnt, stl, seeds, 2.0).numpy()
        stage_inputs = _stage_inputs()
        weights = str(tmp_path_factory.mktemp("vgg") / "vgg.npz")
        mesh_workers.save_taps_weights(weights, params)
        pipe_inputs = {"vgg": weights, "draws": rec.record}
        stores = {n: str(tmp_path_factory.mktemp(f"shard_multi{n}"))
                  for n in WORLDS}

        def spawn(n):
            worlds[n] = tmesh.launch(workers.multi_world, n, n, stage_inputs,
                                     pipe_inputs, store_dir=stores[n],
                                     device="cpu")

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


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", WORLDS)
def test_band_multi_operator_and_solve_bitwise(runs, n):
    """The capped slot-keyed operator of the P = 2 graph and a 6-iteration
    solve: bitwise the single process on every rank."""
    inp = runs["inputs"]
    n_slots = inp["cands"].size
    width = nonlocal_solve.in_edge_width(inp["ids"].size, n_slots, IN_CAP)
    assert np.bincount(inp["slots"].ravel()).max() > width, (
        "no slot is capped")
    args = (_t(inp["src"]), _t(inp["ref"]), _t(inp["conf"]), _t(inp["ids"]),
            _t(inp["wts"]), 3.0, 0.125, 1.2, 2.0)
    op, _, _ = nonlocal_solve.make_nonlocal_system(
        *args, _t(inp["cands"]), _t(inp["slots"]), "mg", IN_CAP)
    xa, xb = _t(inp["xa"]), _t(inp["xb"])
    want_op = op((xa, xb))
    a, b, it, _ = nonlocal_solve.solve_nonlocal(
        xa, xb, *args, iters=6, tol=0.0, candidates=_t(inp["cands"]),
        nbr_slots=_t(inp["slots"]), in_cap=IN_CAP)
    for st in _ranks(runs, n, "nonlocal"):
        assert torch.equal(st["op"][0], want_op[0])
        assert torch.equal(st["op"][1], want_op[1])
        assert torch.equal(st["solve"][0], a)
        assert torch.equal(st["solve"][1], b)
        assert st["solve"][2] == it == 6


@pytest.mark.parametrize("n", WORLDS)
def test_pair_row_sharded_and_bitwise_single_process(runs, n):
    """Every rank: on row bands, the single-process pair bit for bit with
    its (nl, wls) iterations per level."""
    out, iters = runs["single"]["pair"]
    for p in _ranks(runs, n, "pipeline"):
        assert p["row_sharded"]
        np.testing.assert_array_equal(p["pair"], out)
        assert p["pair_iters"] == iters


@pytest.mark.parametrize("n", WORLDS)
def test_pair_within_jax_bound(runs, n):
    want = runs["jax"]["pair"].astype(int)
    for p in _ranks(runs, n, "pipeline"):
        diff = np.abs(p["pair"].astype(int) - want)
        within, mean = (diff <= JAX_LSB).mean(), diff.mean()
        assert within >= JAX_WITHIN_MIN and mean <= JAX_MEAN_MAX, (within,
                                                                   mean)


def test_bucket_over_two_ranks_bitwise_vmap(runs):
    for p in _ranks(runs, 2, "pipeline"):
        np.testing.assert_array_equal(p["bucket"], runs["single"]["bucket"])
