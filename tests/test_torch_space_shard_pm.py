"""Row bands for PatchMatch, block-Jacobi and Jacobi WLS under a space
mesh (``pipeline.row_sharded``), on the CPU over gloo ranks.

One world of 2 ranks and one of 3 each run every case once
(``tests/torch_shard_pm_workers.py``, which imports no JAX), and one of 4
runs both configurations on a taller pair, each world in a thread, while
this process runs the JAX pairs.  The rules:

  * band PatchMatch (``patchmatch(..., band=)``: a 15-row halo of the
    field per iteration, the other level gathered) is bitwise the
    whole-field call, with bands of 3 and 5 rows (halos reaching past a
    neighbour: the 8-row jumps), edge bands, a batch, bf16 and float32;
  * the band block-Jacobi preconditioner and solve, and the Jacobi WLS
    solve, are bitwise the single process (per-pixel once the diagonals
    take their halos and cross-band degrees);
  * ``Config.reference_parity`` and ``Config(fine_strategy="patchmatch",
    wls_precond="jacobi")`` run on row bands: identical on every rank,
    bitwise the single process (oneDNN off on both sides, as
    ``test_torch_space_shard.py`` holds the default family) with its
    iteration counts, and within the JAX package's batch contract (2 LSB
    at >= 95% of values, mean |diff| <= 0.5) of JAX's ``transfer_pair``
    fed the same draws; a parity bucket of 2 bitwise the single-process
    vmap bucket, and a 2-frame parity sequence (level-0 PatchMatch
    warm-started on bands) bitwise the single-process sequence; over 4
    ranks (a 64x48 / 68x52 pair) both configurations bitwise too;
  * every configuration runs on row bands under a mesh of more than one
    space rank, the scatter transpose too
    (``test_torch_space_shard_scatter.py``; several memberships:
    ``test_torch_space_shard_multi.py``).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as mesh_workers
import torch_shard_pm_workers as workers
from nct_tpu import pipeline as jpipe
from nct_tpu.config import Config as JaxConfig
from nct_tpu.models import vgg19 as jvgg
from nct_tpu.solve import knn as jknn
from nct_tpu_torch import Config, pipeline
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops import patchmatch as pm
from nct_tpu_torch.parallel import batch as tbatch
from nct_tpu_torch.parallel import mesh as tmesh
from nct_tpu_torch.solve import knn, nonlocal_solve, wls

torch.set_num_threads(1)

WORLDS = (2, 3)
# the JAX package's batch contract (nct_tpu/parallel/batch.py): a pair on
# the mesh against the same pair alone, here the port's against JAX's
JAX_LSB, JAX_WITHIN_MIN, JAX_MEAN_MAX = 2, 0.95, 0.5


class _FakeMesh:
    def __init__(self, n):
        self.shape = {"data": 1, "space": n}


@pytest.mark.parametrize("overrides,want", [
    ({}, True),
    ({"fine_strategy": "patchmatch"}, True),
    ({"exact_nn_levels": 0}, True),
    ({"nl_precond": "block_jacobi"}, True),
    ({"wls_precond": "jacobi"}, True),
    ({"nl_transpose": "tables"}, True),
    ({"knn_memberships": 2}, True),
    ({"nl_transpose": "scatter"}, True),
    ({"knn_memberships": 3, "nl_transpose": "scatter",
      "wls_precond": "jacobi"}, True),
], ids=["default", "patchmatch", "pm_level0", "block_jacobi", "wls_jacobi",
        "tables", "memberships2", "scatter", "variants"])
def test_row_sharded_truth_table(overrides, want):
    """Every search, preconditioner, transpose and membership count runs
    on row bands; one space rank or no mesh never shards."""
    assert pipeline.row_sharded(Config(space_mesh=_FakeMesh(2),
                                       **overrides)) is want
    assert not pipeline.row_sharded(Config(space_mesh=_FakeMesh(1),
                                           **overrides))
    assert not pipeline.row_sharded(Config(**overrides))


def test_reference_parity_row_sharded():
    assert pipeline.row_sharded(Config.reference_parity(
        space_mesh=_FakeMesh(4), vgg_compute_dtype="float32"))
    assert pipeline.row_sharded(Config.reference_parity(
        space_mesh=_FakeMesh(2), nl_transpose="scatter"))


def _unit(rng, shape):
    f = rng.standard_normal(shape).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def _pm_case(rng, lead, ha, wa, hb, wb, dtype, iters, rs, bounds):
    f0 = np.stack([rng.integers(0, wb, lead + (ha, wa)),
                   rng.integers(0, hb, lead + (ha, wa))], -1).astype(np.int32)
    n_mags = max(len(pm.random_search_mags(rs, hb, wb)), 1)
    return {"a": _unit(rng, lead + (ha, wa, 16)),
            "b": _unit(rng, lead + (hb, wb, 16)), "dtype": dtype, "f0": f0,
            "u": rng.random(lead + (iters, n_mags, ha, wa, 2)).astype(
                np.float32), "iters": iters, "rs": rs, "bounds": bounds}


def _stage_inputs():
    rng = np.random.default_rng(15)
    inp = {"pm": [
        # bands of 5 and 3 rows: the 8- and 4-row jumps and the 15-row
        # halo reach past them; the last band an edge band
        _pm_case(rng, (), 37, 13, 17, 15, "float32", 3, 8,
                 {2: [0, 5, 37], 3: [0, 3, 20, 37]}),
        # a batch of 2 in bf16, the 1-, 2-row halo steps at the boundary
        _pm_case(rng, (2,), 29, 11, 23, 19, "bfloat16", 2, 6,
                 {2: [0, 20, 29], 3: [0, 8, 16, 29]}),
        # no random search radius, even bands
        _pm_case(rng, (), 24, 9, 12, 10, "float32", 2, 0,
                 {2: [0, 12, 24], 3: [0, 8, 16, 24]}),
    ]}
    h, w = 53, 45
    for k in ("xa", "xb"):
        inp[k] = rng.standard_normal((h, w, 3)).astype(np.float32)
    for k in ("src", "ref", "lab_unit"):
        inp[k] = rng.random((h, w, 3)).astype(np.float32)
    inp["conf"] = (0.05 + rng.random((h, w))).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 4, (h, w)))
    member = torch.stack([labels == c for c in range(4)])
    cands = knn.sample_cluster_candidates(
        member, torch.from_numpy(rng.random((4, h * w)).astype(np.float32)),
        64)
    ids, wts, slots = knn.knn_graph(torch.from_numpy(inp["src"]), labels,
                                    cands, 8)
    inp.update(cands=cands.numpy(), ids=ids.numpy(), wts=wts.numpy(),
               slots=slots.numpy(), in_cap=8)
    return inp


class RecordingJaxDraws:
    """The JAX pipeline's key sequence (``test_torch_pipeline.JaxDraws``:
    k-means; per PatchMatch level one split in three, "ab" then "ba"; per
    level one split for the candidates), recording what it returns for
    ``torch_shard_pm_workers.ReplayDraws``."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.record = {}

    def kmeans_init(self, n, k):
        self.key, sub = jax.random.split(self.key)
        idx = jax.random.choice(sub, n, shape=(k,), replace=n < k)
        self.record["kmeans"] = np.asarray(idx)
        return torch.tensor(self.record["kmeans"])

    def patchmatch_uniforms(self, level, direction, shape):
        if direction == "ab":
            self.key, key, self.key_ba = jax.random.split(self.key, 3)
        else:
            key = self.key_ba
        u = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))
        self.record[f"pm{level}{direction}"] = u
        return torch.tensor(u)

    def candidates(self, level, member_pix, m):
        self.key, sub = jax.random.split(self.key)
        c = np.asarray(jknn.sample_cluster_candidates(
            jnp.asarray(member_pix.cpu().numpy()), sub, m))
        self.record[f"cand{level}"] = c
        return torch.tensor(c)


def _jax_config(name):
    if name == "parity":
        return JaxConfig.reference_parity(**workers.SMALL)
    return JaxConfig(fine_strategy="patchmatch", wls_precond="jacobi",
                     exact_nn_levels=1, **workers.SMALL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's pairs in one thread from the start; meanwhile the port's
    single-process references (oneDNN off, as in the ranks), whose JAX
    draws the ranks replay, then both worlds at once, a thread each."""
    params = {k: {"w": np.asarray(v["w"]), "b": np.asarray(v["b"])}
              for k, v in jvgg.init_params().items()}
    model = vgg19.params_from_numpy(params)
    cnt, stl, seeds = mesh_workers.tiny_pairs(2, *workers.PAIR_HW)
    jax_out = {}

    def jax_pairs():
        for name in workers.CONFIGS:
            jax_out[name] = np.asarray(jpipe.transfer_pair(
                params, cnt[0], stl[0], 2.0, _jax_config(name),
                key=jax.random.PRNGKey(seeds[0])))

    jax_thread = threading.Thread(target=jax_pairs)
    jax_thread.start()
    single, draws, worlds = {}, {}, {}
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            for name, config in workers.CONFIGS.items():
                rec = RecordingJaxDraws(seeds[0])
                out, trace = pipeline.transfer_pair(
                    model, cnt[0], stl[0], 2.0, config, draws=rec,
                    device="cpu", return_intermediates="stats")
                single[name] = (out.numpy(), [(int(t["nl_iters"]),
                                               int(t["wls_iters"]))
                                              for t in trace])
                draws[name] = rec.record
            parity = workers.CONFIGS["parity"]
            single["bucket"] = tbatch.make_batch_transfer(
                parity, mode="vmap", device="cpu")(
                    model, cnt, stl, seeds, 2.0).numpy()
            single["sequence"] = [
                f.numpy() for f in pipeline.transfer_sequence(
                    model, [cnt[0], cnt[1]], stl[0], 2.0, parity,
                    seed=seeds[0], device="cpu")]
            tall_c, tall_s, tall_seeds = mesh_workers.tiny_pairs(
                1, *workers.TALL_HW)
            single["tall"] = {name: pipeline.transfer_pair(
                model, tall_c[0], tall_s[0], 2.0, config, seed=tall_seeds[0],
                device="cpu").numpy()
                for name, config in workers.CONFIGS.items()}
        stage_inputs = _stage_inputs()
        # made here: mktemp from several threads at once races to make the
        # session's base directory
        stores = {n: str(tmp_path_factory.mktemp(f"shard_pm{n}"))
                  for n in WORLDS + (4,)}

        def spawn(n):
            store = stores[n]
            if n == 4:
                worlds[n] = tmesh.launch(workers.four_rank_world, 4, params,
                                         store_dir=store, device="cpu")
                return
            worlds[n] = tmesh.launch(workers.shard_world, n, n, stage_inputs,
                                     {"vgg": params, "draws": draws},
                                     store_dir=store, device="cpu")

        threads = [threading.Thread(target=spawn, args=(n,))
                   for n in WORLDS + (4,)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        jax_thread.join()
    assert set(worlds) == set(WORLDS + (4,)), "a world failed"
    assert set(jax_out) == set(workers.CONFIGS), "a JAX pair failed"
    return {"worlds": worlds, "single": single, "jax": jax_out,
            "inputs": stage_inputs}


def _ranks(runs, n, key):
    return [r[key] for r in runs["worlds"][n]]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("case", [0, 1, 2])
@pytest.mark.parametrize("n", WORLDS)
def test_band_patchmatch_bitwise(runs, n, case):
    """Bitwise the whole call, with one halo of A's rows per call and one
    of the field per iteration (1 + iters exchanges, where a halo per
    vertical jump would take 1 + 8 iters)."""
    c = runs["inputs"]["pm"][case]
    want = pm.patchmatch(*workers.pm_operands(c), c["iters"], c["rs"])
    for st in _ranks(runs, n, "stages"):
        nnf, d = st["pm"][case]
        assert torch.equal(nnf, want[0])
        assert torch.equal(d, want[1])
        assert st["pm_halos"][case] == 1 + c["iters"]


@pytest.mark.parametrize("n", WORLDS)
def test_band_block_jacobi_bitwise(runs, n):
    """The preconditioner of a residual and a 6-iteration solve."""
    inp = runs["inputs"]
    args = (_t(inp["src"]), _t(inp["ref"]), _t(inp["conf"]), _t(inp["ids"]),
            _t(inp["wts"]), 3.0, 0.125, 1.2, 2.0)
    xa, xb = _t(inp["xa"]), _t(inp["xb"])
    _, _, pre = nonlocal_solve.make_nonlocal_system(
        *args, _t(inp["cands"]), _t(inp["slots"]), "block_jacobi",
        inp["in_cap"])
    za, zb = pre((xa, xb))
    a_s, b_s, it, _ = nonlocal_solve.solve_nonlocal(
        xa, xb, *args, iters=6, tol=0.0, candidates=_t(inp["cands"]),
        nbr_slots=_t(inp["slots"]), precond_kind="block_jacobi",
        in_cap=inp["in_cap"])
    for st in _ranks(runs, n, "stages"):
        got = st["block_jacobi"]
        for g, w in zip(got[:4], (za, zb, a_s, b_s)):
            assert torch.equal(g, w)
        assert got[4] == it == 6


@pytest.mark.parametrize("n", WORLDS)
def test_band_wls_jacobi_bitwise(runs, n):
    inp = runs["inputs"]
    a_w, b_w, it, _ = wls.solve_wls(_t(inp["xa"]), _t(inp["xb"]),
                                    _t(inp["lab_unit"]), 0.3, iters=6,
                                    tol=0.0, precond_kind="jacobi")
    for st in _ranks(runs, n, "stages"):
        got = st["wls_jacobi"]
        assert torch.equal(got[0], a_w) and torch.equal(got[1], b_w)
        assert got[2] == it == 6


@pytest.mark.parametrize("name", sorted(workers.CONFIGS))
@pytest.mark.parametrize("n", WORLDS)
def test_pair_row_sharded_and_identical_on_every_rank(runs, n, name):
    ranks = _ranks(runs, n, "pipeline")
    for p in ranks:
        assert p[f"{name}_row_sharded"]
        np.testing.assert_array_equal(p[name], ranks[0][name])


@pytest.mark.parametrize("name", sorted(workers.CONFIGS))
@pytest.mark.parametrize("n", WORLDS)
def test_pair_bitwise_single_process(runs, n, name):
    """With the same (nl, wls) iterations per level."""
    out, iters = runs["single"][name]
    for p in _ranks(runs, n, "pipeline"):
        np.testing.assert_array_equal(p[name], out)
        assert p[f"{name}_iters"] == iters


@pytest.mark.parametrize("n", WORLDS)
def test_bucket_and_sequence_bitwise_single_process(runs, n):
    """A parity bucket of 2 (vmap over row bands) and a 2-frame parity
    sequence (level-0 PatchMatch warm-started from the band fields)."""
    single = runs["single"]
    for p in _ranks(runs, n, "pipeline"):
        np.testing.assert_array_equal(p["bucket"], single["bucket"])
        for got, want in zip(p["sequence"], single["sequence"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(workers.CONFIGS))
@pytest.mark.parametrize("n", WORLDS)
def test_pair_within_jax_batch_contract(runs, n, name):
    """JAX's ``transfer_pair`` of the same pair, configuration and draws."""
    want = runs["jax"][name].astype(int)
    for p in _ranks(runs, n, "pipeline"):
        diff = np.abs(p[name].astype(int) - want)
        within, mean = (diff <= JAX_LSB).mean(), diff.mean()
        assert within >= JAX_WITHIN_MIN and mean <= JAX_MEAN_MAX, (within,
                                                                   mean)


@pytest.mark.parametrize("name", sorted(workers.CONFIGS))
def test_pair_on_four_ranks_bitwise_single_process(runs, name):
    """Over a 1 x 4 mesh (the 64x48 / 68x52 pair, seeded draws): row
    bands on every rank, identical on every rank, bitwise the single
    process."""
    want = runs["single"]["tall"][name]
    for p in runs["worlds"][4]:
        assert p[f"{name}_row_sharded"]
        np.testing.assert_array_equal(p[name], want)
