"""The row-sharded space mesh (``pipeline.row_sharded``): each band stage
and the pair on the CPU, over gloo ranks in spawned processes.

One world of 2 ranks and one of 3 (uneven bands) each run every case once
(``tests/torch_shard_workers.py``, which imports no JAX), in a thread,
while this process runs the JAX pairs.  The rules:

  * stages with no cross-rank reduction are bitwise the port's
    single-process stage: pyramid and resizes, NNF upsampling, BDS vote
    and colour guide, window refine on the gathered level, the k-NN rows,
    the grid terms (gradient weights, Laplacian, degree), the V-cycle
    (band levels, then gathered ones), the error confidence (the level-0
    patch moments run on the gathered conv5_1 grid, as k-means does);
  * VGG taps over bands: within float32 rounding (rtol 1e-5) of the whole
    image's with oneDNN on here (its convolution over a band may add in
    another order); the ranks run with oneDNN off, where a band's rows
    take the whole image's bits;
  * cross-rank sums (the nonlocal in-edge sums and degrees, the CG dots)
    add the bands' float64 partials in rank order and round once to
    float32, as the single process rounds its float64 sums: not the
    single-process order, yet the same bits here (the order could show
    only where a float64 sum lies within its rounding of a float32
    halfway point), so the operator, both solves and a dot are held
    bitwise;
  * the ring over row bands is bitwise JAX's ``exact_nn`` on integer
    features and within JAX's ring-test bounds on random ones;
  * the TINY pair (also with ``exact_nn_levels=1``, whose level 1 runs the
    window refine on bands) and a bucket of 2: identical on every rank and
    from run to run, bitwise the single-process output (both with oneDNN
    off), with its iteration counts, and within
    ``test_torch_pipeline.py``'s bound of
    JAX's ``transfer_pair`` (2 LSB at >= 95%, mean <= 1.0) fed the same
    draws; the ``ring_nn=False`` bucket bitwise the ring's.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as mesh_workers
import torch_shard_workers as workers
from nct_tpu import pipeline as jpipe
from nct_tpu.config import Config as JaxConfig
from nct_tpu.models import vgg19 as jvgg
from nct_tpu.ops.exact_nn import exact_nn as jax_exact_nn
from nct_tpu.solve import knn as jknn
from nct_tpu_torch import pipeline
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops import bds, nnf, resize, window_refine
from nct_tpu_torch.parallel import batch as tbatch
from nct_tpu_torch.parallel import mesh as tmesh
from nct_tpu_torch.solve import cg, knn, nonlocal_solve, stats, wls

torch.set_num_threads(1)

WORLDS = (2, 3)
JAX_LSB, JAX_WITHIN_MIN, JAX_MEAN_MAX = 2, 0.95, 1.0   # test_torch_pipeline
TINY_JAX = dict(pm_iters=2, cg_iters=8, cg_iters_final=8, cg_iters_mg=6,
                cg_iters_final_mg=4, wls_cg_iters=8, kmeans_iters=3,
                num_levels=2, feature_dtype="float32",
                vgg_compute_dtype="float32")


def _unit(rng, shape):
    f = rng.standard_normal(shape).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def _integer(rng, h, w, c=16):
    """{-2..2} features from a 3-vector palette: exact sums, many ties."""
    return rng.integers(-2, 3, (3, c))[rng.integers(0, 3, (h, w))].astype(
        np.float32)


def _field(rng, lead, h, w, th, tw):
    return np.stack([rng.integers(0, tw, lead + (h, w)),
                     rng.integers(0, th, lead + (h, w))], -1).astype(np.int32)


def _stage_inputs(vgg):
    rng = np.random.default_rng(14)
    inp = {"vgg": vgg}
    inp["img"] = rng.integers(0, 256, (53, 37, 3)).astype(np.uint8)
    inp["coarse"] = rng.random((7, 5, 3)).astype(np.float32)
    inp["field"] = _field(rng, (), 14, 10, 10, 9)
    inp["field_b"] = (20, 17)
    inp["ann"] = _field(rng, (2,), 19, 13, 17, 15)
    inp["bnn"] = _field(rng, (2,), 17, 15, 19, 13)
    inp["payload"] = rng.standard_normal((2, 17, 15, 5)).astype(np.float32)
    inp["colors"] = rng.integers(0, 256, (17, 15, 3)).astype(np.uint8)
    inp["wr_a"] = _unit(rng, (2, 19, 13, 16))
    inp["wr_b"] = _unit(rng, (2, 17, 15, 16))
    inp["wr_nnf"] = _field(rng, (2,), 19, 13, 17, 15)
    inp["lab"] = rng.random((23, 17, 3)).astype(np.float32)
    inp["labels"] = rng.integers(0, 4, (23, 17))
    inp["cands"] = rng.integers(0, 23 * 17, (4, 32))
    inp["err"] = rng.standard_normal((23, 17)).astype(np.float32)
    h, w = 53, 45                       # coarsens once on 2-row bands
    inp["lum"] = rng.random((h, w)).astype(np.float32)
    for k in ("u", "u2", "xa", "xb"):
        inp[k] = rng.standard_normal((h, w, 3)).astype(np.float32)
    inp["blk_aa"] = (1.0 + rng.random((h, w, 3))).astype(np.float32)
    inp["blk_bb"] = (1.0 + rng.random((h, w, 3))).astype(np.float32)
    inp["blk_ab"] = (0.1 * rng.random((h, w, 3))).astype(np.float32)
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
    inp.update(nl_cands=cands.numpy(), ids=ids.numpy(), wts=wts.numpy(),
               slots=slots.numpy(), in_cap=8)
    inp["ring"] = {"integer": (_integer(rng, 21, 11), _integer(rng, 19, 13)),
                   "random": (_unit(rng, (21, 11, 16)),
                              _unit(rng, (19, 13, 16)))}
    return inp


class RecordingJaxDraws:
    """The JAX pipeline's key sequence (``test_torch_pipeline.JaxDraws``:
    k-means, then one split per level for the candidates), recording what
    it returns for ``torch_shard_workers.ReplayDraws``."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.record = {}

    def kmeans_init(self, n, k):
        self.key, sub = jax.random.split(self.key)
        idx = jax.random.choice(sub, n, shape=(k,), replace=n < k)
        self.record["kmeans"] = np.asarray(idx)
        return torch.tensor(self.record["kmeans"])

    def candidates(self, level, member_pix, m):
        self.key, sub = jax.random.split(self.key)
        c = np.asarray(jknn.sample_cluster_candidates(
            jnp.asarray(member_pix.cpu().numpy()), sub, m))
        self.record[f"cand{level}"] = c
        return torch.tensor(c)


# (name, item, exact_nn_levels) of the pairs run with JAX's draws
JAX_PAIRS = (("pair", 0, 4), ("pair_exact1", 0, 1), ("item1", 1, 4))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds (in a thread) and, meanwhile, the JAX pairs; the port's
    single-process references."""
    params = {k: {"w": np.asarray(v["w"]), "b": np.asarray(v["b"])}
              for k, v in jvgg.init_params().items()}
    model = vgg19.params_from_numpy(params)
    cnt, stl, seeds = mesh_workers.tiny_pairs(2, 40, 48, 44, 52)
    single, draws = {}, {}
    with torch.backends.mkldnn.flags(enabled=False):     # as in the ranks
        for name, i, exact in JAX_PAIRS:
            rec = RecordingJaxDraws(seeds[i])
            config = dataclasses.replace(mesh_workers.TINY,
                                         exact_nn_levels=exact)
            out, trace = pipeline.transfer_pair(
                model, cnt[i], stl[i], 2.0, config, draws=rec, device="cpu",
                return_intermediates="stats")
            single[name] = (out.numpy(), [(int(t["nl_iters"]),
                                           int(t["wls_iters"]))
                                          for t in trace])
            draws[name] = rec.record
        single["bucket"] = tbatch.make_batch_transfer(
            mesh_workers.TINY, mode="vmap", device="cpu")(
                model, cnt, stl, seeds, 2.0).numpy()
    stage_inputs = _stage_inputs(params)
    worlds = {}

    def spawn():
        for n in WORLDS:
            store = str(tmp_path_factory.mktemp(f"shard{n}"))
            worlds[n] = tmesh.launch(workers.shard_world, n, n, stage_inputs,
                                     {"vgg": params, "draws": draws},
                                     store_dir=store, device="cpu")

    thread = threading.Thread(target=spawn)
    thread.start()
    jax_out = {}
    try:
        for name, i, exact in JAX_PAIRS:
            jax_out[name] = np.asarray(jpipe.transfer_pair(
                params, cnt[i], stl[i], 2.0,
                JaxConfig(**TINY_JAX, exact_nn_levels=exact),
                key=jax.random.PRNGKey(seeds[i])))
    finally:
        thread.join()
    assert set(worlds) == set(WORLDS), "a world failed"
    return {"worlds": worlds, "single": single, "jax": jax_out,
            "inputs": stage_inputs, "model": model}


def _ranks(runs, n, key):
    return [r[key] for r in runs["worlds"][n]]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("h,n,bounds", [
    (40, 2, [0, 16, 40]), (40, 3, [0, 16, 32, 40]),
    (665, 2, [0, 336, 665]), (665, 4, [0, 160, 336, 496, 665]),
    (452, 2, [0, 224, 452]), (33, 3, [0, 16, 32, 33])])
def test_image_bands_rule(h, n, bounds):
    """Boundaries on multiples of 16 rows, nearest the even split, the
    last band taking the overhang; every VGG grid then starts each band
    on a whole row."""
    got = tmesh.image_bands(h, n)
    assert got == bounds
    for shift in range(5):
        assert all((b >> shift) << shift == b for b in got[:-1])


@pytest.mark.parametrize("h,n,bounds", [
    (32, 3, [0, 16, 32, 32]), (40, 4, [0, 16, 32, 40, 40]),
    (64, 8, [0, 16, 32, 48, 64, 64, 64, 64, 64]),
    (68, 8, [0, 16, 32, 48, 64, 68, 68, 68, 68]), (15, 2, [0, 15, 15])])
def test_image_bands_too_many_ranks_gives_empty_bands(h, n, bounds):
    """Fewer 16-row units than ranks: one unit for each of the first
    ranks, a band of zero rows (boundaries at h) for the others
    (``tests/test_torch_space_shard_short.py`` runs the pairs)."""
    assert tmesh.image_bands(h, n) == bounds


@pytest.mark.parametrize("n", WORLDS)
def test_band_vgg_taps_within_float32_rounding(runs, n):
    inp = runs["inputs"]
    want = runs["model"](_t(inp["img"]), vgg19.PIPELINE_TAPS)
    for st in _ranks(runs, n, "stages"):
        for tap, got in st["vgg"].items():
            np.testing.assert_allclose(got.numpy(), want[tap].numpy(),
                                       rtol=1e-5, atol=1e-5 * float(
                                           want[tap].abs().max()))


@pytest.mark.parametrize("n", WORLDS)
def test_band_pyramid_and_resize_bitwise(runs, n):
    inp = runs["inputs"]
    img = _t(inp["img"])
    dims = vgg19.feature_dims(*img.shape[:2])
    want = pipeline.image_pyramid(img, [dims[t] for t in vgg19.PIPELINE_TAPS])
    up = resize.resize_bilinear(_t(inp["coarse"]), *img.shape[:2])
    for st in _ranks(runs, n, "stages"):
        for got, ref in zip(st["pyramid"], want):
            assert torch.equal(got, ref)
        assert torch.equal(st["resize"], up)


@pytest.mark.parametrize("n", WORLDS)
def test_band_upsample_bitwise(runs, n):
    inp = runs["inputs"]
    dims = vgg19.feature_dims(*inp["img"].shape[:2])
    want = nnf.upsample(_t(inp["field"]), *dims["conv2_1"], *inp["field_b"])
    for st in _ranks(runs, n, "stages"):
        assert torch.equal(st["upsample"], want)


@pytest.mark.parametrize("n", WORLDS)
def test_band_bds_vote_bitwise(runs, n):
    """The exchange by owner adds each target's completeness samples in
    ascending global source order, as the whole vote's sorted scatter."""
    inp = runs["inputs"]
    ann, bnn = _t(inp["ann"]), _t(inp["bnn"])
    voted, wsum = bds.bds_vote(_t(inp["payload"]), ann, bnn, 1.0, 2.0, 3)
    guide = bds.bds_reconstruct_color(_t(inp["colors"]), ann[0], bnn[0], 1.0,
                                      2.0, 3)
    for st in _ranks(runs, n, "stages"):
        assert torch.equal(st["bds"][0], voted)
        assert torch.equal(st["bds"][1], wsum)
        assert torch.equal(st["guide"], guide)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_window_refine_gather_taps_bitwise_tables(lead):
    """``gather_taps`` (the band path's tap-by-tap gathers from B) gives
    the strip- and patch-table refine's result bit for bit, for one pair
    and a batch, with the stage-1 channel subset."""
    rng = np.random.default_rng(41)
    a, b = _unit(rng, lead + (19, 13, 16)), _unit(rng, lead + (17, 15, 16))
    f0 = _t(_field(rng, lead, 19, 13, 17, 15))
    for stage1 in (0, 8):
        want = window_refine.window_refine(_t(a), _t(b), f0, 2, 3, 3, stage1)
        got = window_refine.window_refine(_t(a), _t(b), f0, 2, 3, 3, stage1,
                                          gather_taps=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", WORLDS)
def test_band_window_refine_bitwise(runs, n):
    """Each band gathers tap by tap from the whole level (as the pipeline's
    band path does); the reference is the single-process table refine."""
    inp = runs["inputs"]
    want = window_refine.window_refine(_t(inp["wr_a"]), _t(inp["wr_b"]),
                                       _t(inp["wr_nnf"]), 2, 3, 3, 8)
    for st in _ranks(runs, n, "stages"):
        assert torch.equal(st["window"][0], want[0])
        assert torch.equal(st["window"][1], want[1])


@pytest.mark.parametrize("n", WORLDS)
def test_band_knn_graph_bitwise(runs, n):
    inp = runs["inputs"]
    want = knn.knn_graph(_t(inp["lab"]), _t(inp["labels"]), _t(inp["cands"]),
                         8, chunk=64)
    for st in _ranks(runs, n, "stages"):
        for got, ref in zip(st["knn"], want):
            assert torch.equal(got.reshape(ref.shape), ref)


@pytest.mark.parametrize("n", WORLDS)
def test_band_error_confidence_bitwise(runs, n):
    """The confidence's min and max over the bands are exact."""
    conf = stats.error_confidence(_t(runs["inputs"]["err"]))
    for st in _ranks(runs, n, "stages"):
        assert torch.equal(st["stats"], conf)


@pytest.mark.parametrize("n", WORLDS)
def test_band_grid_terms_and_vcycle_bitwise(runs, n):
    """Gradient weights, Laplacian, degree and the V-cycle (its first
    coarsening on bands, the next levels gathered) on halos, bit for bit."""
    inp = runs["inputs"]
    gx, gy = nonlocal_solve.gradient_weights(_t(inp["lum"]), 0.5, 1.2)
    u = _t(inp["u"])
    lap = nonlocal_solve.laplacian_apply(u, gx, gy)
    deg = nonlocal_solve.laplacian_degree(gx, gy)
    pre = nonlocal_solve.make_mg_preconditioner(
        *(_t(inp[k]) for k in ("blk_aa", "blk_ab", "blk_bb")), gx, gy)
    za, zb = pre((u, _t(inp["u2"])))
    for st in _ranks(runs, n, "stages"):
        for got, ref in zip(st["grid"], (gx, gy, lap, deg, za, zb)):
            assert torch.equal(got, ref)


@pytest.mark.parametrize("n", WORLDS)
def test_band_nonlocal_operator_and_solves(runs, n):
    """The capped slot-keyed operator (``in_cap`` 8: slots over the cap
    ranked across bands), the nonlocal and WLS solves at 6 fixed
    iterations and a CG dot: bitwise the single process on every rank."""
    inp = runs["inputs"]
    args = (_t(inp["src"]), _t(inp["ref"]), _t(inp["conf"]), _t(inp["ids"]),
            _t(inp["wts"]), 3.0, 0.125, 1.2, 2.0)
    kw = dict(candidates=_t(inp["nl_cands"]), nbr_slots=_t(inp["slots"]),
              in_cap=inp["in_cap"])
    op, _, _ = nonlocal_solve.make_nonlocal_system(
        *args, kw["candidates"], kw["nbr_slots"], "mg", inp["in_cap"])
    xa, xb = _t(inp["xa"]), _t(inp["xb"])
    want_op = op((xa, xb))
    a_s, b_s, it_nl, _ = nonlocal_solve.solve_nonlocal(
        xa, xb, *args, iters=6, tol=0.0, **kw)
    a_w, b_w, it_w, _ = wls.solve_wls(xa, xb, _t(inp["lab_unit"]), 0.3,
                                      iters=6, tol=0.0)
    for st in _ranks(runs, n, "stages"):
        for got, ref in zip(st["nonlocal"][:4] + st["wls"][:2],
                            want_op + (a_s, b_s, a_w, b_w)):
            assert torch.equal(got, ref)
        assert (st["nonlocal"][4], st["wls"][2]) == (it_nl, it_w) == (6, 6)
        assert st["dot"] == float(cg._dot((xa,), (xb,)))


@pytest.mark.parametrize("n", WORLDS)
def test_band_ring_matches_jax_exact_nn(runs, n):
    """The ring over row bands: JAX's exact search (bf16 tables) bit for
    bit on integer features; on random ones within JAX's ring test's
    bounds (distances rtol 1e-5 / atol 1e-6, >= 99% of indices equal)."""
    for name, (a, b) in runs["inputs"]["ring"].items():
        nnf_ref, d_ref = (np.asarray(t) for t in jax_exact_nn(
            jnp.asarray(a), jnp.asarray(b), 3, bf16=True))
        for st in _ranks(runs, n, "stages"):
            got, d = (t.numpy() for t in st["ring"][name])
            if name == "integer":
                np.testing.assert_array_equal(got, nnf_ref)
                np.testing.assert_array_equal(d, d_ref)
            else:
                np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-6)
                assert (got == nnf_ref).all(-1).mean() >= 0.99


@pytest.mark.parametrize("n", WORLDS)
def test_pair_identical_on_every_rank_and_run(runs, n):
    ranks = _ranks(runs, n, "pipeline")
    for p in ranks:
        assert np.array_equal(p["pair"][0], p["pair"][1])
        for key in ("pair_exact1", "bucket", "bucket_replicated",
                    "bucket_jax_draws"):
            got, first = p[key], ranks[0][key]
            assert np.array_equal(got[0] if key == "pair_exact1" else got,
                                  first[0] if key == "pair_exact1" else first)
        assert np.array_equal(p["pair"][0], ranks[0]["pair"][0])


def _rule(got, want, lsb, within_min, mean_max):
    diff = np.abs(got.astype(int) - want.astype(int))
    within, mean = (diff <= lsb).mean(), diff.mean()
    assert within >= within_min and mean <= mean_max, (within, mean)


@pytest.mark.parametrize("n", WORLDS)
def test_pair_bitwise_single_process(runs, n):
    """The pair (both exact settings, JAX's draws) and the bucket bitwise
    the single process (oneDNN off on both sides), with the same iteration
    counts per level."""
    single = runs["single"]
    for p in _ranks(runs, n, "pipeline"):
        for name in ("pair", "pair_exact1"):
            np.testing.assert_array_equal(p[name][0], single[name][0])
            assert p[f"{name}_iters"] == single[name][1]
        np.testing.assert_array_equal(p["bucket"], single["bucket"])


@pytest.mark.parametrize("n", WORLDS)
def test_pair_within_jax_bound(runs, n):
    """JAX's ``transfer_pair`` of the same pairs and draws: the pair, the
    pair with ``exact_nn_levels=1`` and both items of the bucket."""
    jx = runs["jax"]
    for p in _ranks(runs, n, "pipeline"):
        for got, want in ((p["pair"][0], jx["pair"]),
                          (p["pair_exact1"][0], jx["pair_exact1"]),
                          (p["bucket_jax_draws"][0], jx["pair"]),
                          (p["bucket_jax_draws"][1], jx["item1"])):
            _rule(got, want, JAX_LSB, JAX_WITHIN_MIN, JAX_MEAN_MAX)


@pytest.mark.parametrize("n", WORLDS)
def test_ring_nn_false_bucket_bitwise_ring(runs, n):
    """Both matchers are exact and the rest of the path is the same."""
    for p in _ranks(runs, n, "pipeline"):
        np.testing.assert_array_equal(p["bucket_replicated"], p["bucket"])
