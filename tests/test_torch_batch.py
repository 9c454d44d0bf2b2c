"""The port's batched (vmap) serving path against ``jax.vmap`` of the JAX
stages and against the port's own single-pair path.

Each batched stage takes a leading batch axis.  Where the JAX package has a
batch rule (the Pallas NN kernels' grid axis, the window refine's and the
k-NN graph's row folds, the WLS channel fold) the port's batched stage is
held against ``jax.vmap`` of the JAX stage with the contract of the JAX
package's own batched test; the rest are held against per-item calls of the
port.  End to end, ``make_batch_transfer(mode="vmap")`` is held against the
scan mode item by item with the contract of ``tests/test_parallel_batch.py``
(within 2 LSB at >= 95% of values, mean difference <= 0.5) and equal solver
iteration counts.  JAX's ``transfer_pair`` is never run under ``jax.vmap``
here: the scan mode is already held against JAX.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nct_tpu.ops import window_refine as jwr
from nct_tpu.solve import knn as jknn
from nct_tpu.solve import wls as jwls
from nct_tpu_torch import Config, pipeline
from nct_tpu_torch.models import vgg19 as tvgg
from nct_tpu_torch.ops import bds as tbds
from nct_tpu_torch.ops import cuda_nn
from nct_tpu_torch.ops import window_refine as twr
from nct_tpu_torch.ops.exact_nn import exact_nn_bidir_plain, exact_nn_plain
from nct_tpu_torch.parallel import batch as tbatch
from nct_tpu_torch.solve import cg as tcg
from nct_tpu_torch.solve import cluster as tcl
from nct_tpu_torch.solve import knn as tknn
from nct_tpu_torch.solve import nonlocal_solve as tnl
from nct_tpu_torch.solve import stats as tst
from nct_tpu_torch.solve import wls as twls

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def T(x):
    return torch.tensor(np.asarray(x))


def _norm(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _integer(rng, shape):
    """{-2..2} features from a 3-vector palette per item: exact f32 sums
    and many exactly tied patches (first-match is exercised)."""
    *lead, h, w, c = shape
    out = [rng.integers(-2, 3, (3, c))[rng.integers(0, 3, (h, w))]
           for _ in range(int(np.prod(lead)))]
    return np.stack(out).reshape(shape).astype(np.float32)


def _random_nnf(rng, b, h, w, th, tw):
    return np.stack([rng.integers(0, tw, (b, h, w)),
                     rng.integers(0, th, (b, h, w))], axis=-1).astype(np.int32)


def _assert_mostly_equal(got, want, max_lsb=2, frac=0.95, mean_tol=0.5):
    """The JAX package's batch contract (tests/test_parallel_batch.py)."""
    diff = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert (diff <= max_lsb).mean() >= frac, (
        f"{(diff > max_lsb).mean():.2%} of values differ by more than "
        f"{max_lsb} LSB (max {diff.max()})")
    assert diff.mean() <= mean_tol, f"mean abs diff {diff.mean():.3f}"


# --- the exact NN search: plain batched vs jax.vmap of the Pallas kernels ---

@pytest.mark.parametrize("directed", [False, True])
def test_plain_batched_nn_vs_vmapped_pallas_interpret(rng, directed):
    """Bitwise on integer features: the batch grid axis that jax.vmap
    prepends to the Pallas grid, against the port's plain batched search
    (the CPU path and the card-side oracle of the kernel's batch axis)."""
    from jax.experimental.pallas import tpu as pltpu

    from nct_tpu.ops.pallas_nn import exact_nn_pallas, exact_nn_pallas_bidir

    a = _integer(rng, (2, 8, 9, 8))
    b = _integer(rng, (2, 9, 11, 8))
    with pltpu.force_tpu_interpret_mode():
        if directed:
            ref = jax.vmap(lambda x, y: exact_nn_pallas(
                x, y, 3, a_tile=32, b_tile=32))(jnp.asarray(a), jnp.asarray(b))
        else:
            ref = jax.vmap(lambda x, y: exact_nn_pallas_bidir(
                x, y, 3, a_tile=32, b_tile=32))(jnp.asarray(a), jnp.asarray(b))
    plain = exact_nn_plain if directed else exact_nn_bidir_plain
    got = plain(T(a), T(b), 3)
    wrapper = cuda_nn.exact_nn if directed else cuda_nn.exact_nn_bidir
    via_wrapper = wrapper(T(a), T(b), 3)       # CPU tensors: the plain path
    assert len(got) == len(ref)
    for g, w, r in zip(got, via_wrapper, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(w.numpy(), np.asarray(r))


def test_batched_tables_shapes_and_checks(rng):
    """The kernel's batched operands: one table and one mask row per item at
    one padded size; a batch whose sizes disagree is refused."""
    a = T(_norm(rng.standard_normal((3, 7, 9, 16))))
    fa, ma = cuda_nn.padded_tables(a, 3)
    assert fa.shape == (3, 128, 192) and ma.shape == (3, 128)
    assert fa.is_contiguous() and ma.is_contiguous()
    f1, m1 = cuda_nn.padded_tables(a[1], 3)
    assert torch.equal(fa[1], f1) and torch.equal(ma[1], m1)
    with pytest.raises(ValueError, match="batch sizes"):
        cuda_nn._check_tables(fa, ma, fa[:2], ma[:2])
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_nn.nn_bidir_tables(fa, ma, fa, ma)


# --- window refine, k-NN graph, WLS: against jax.vmap -----------------------

def test_window_refine_batched_vs_vmap(rng):
    """nnf bitwise, distances rtol 1e-5 (tests/test_window_refine.py)."""
    from nct_tpu.ops import features as jfeat

    bsz, ha, wa, hb, wb, c = 3, 14, 18, 12, 20, 16
    fa = jnp.asarray(rng.standard_normal((bsz, ha, wa, c)), jnp.float32)
    fb = jnp.asarray(rng.standard_normal((bsz, hb, wb, c)), jnp.float32)
    fa_n = jax.vmap(lambda x: jfeat.l2_normalize(x)[0])(fa)
    fb_n = jax.vmap(lambda x: jfeat.l2_normalize(x)[0])(fb)
    n0 = jnp.asarray(_random_nnf(rng, bsz, ha, wa, hb, wb))
    ref_n, ref_d = jax.jit(jax.vmap(
        lambda a, b, n: jwr.window_refine(a, b, n, 3, 2, 3)))(fa_n, fb_n, n0)
    got_n, got_d = twr.window_refine(T(fa_n), T(fb_n), T(n0), 3, 2, 3)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-5,
                               atol=1e-6)
    for i in range(bsz):     # and each item is its own single call, bitwise
        one_n, one_d = twr.window_refine(T(fa_n[i]), T(fb_n[i]), T(n0[i]),
                                         3, 2, 3)
        assert torch.equal(got_n[i], one_n) and torch.equal(got_d[i], one_d)


def test_knn_graph_batched_vs_vmap(rng):
    """ids and slots bitwise, weights rtol 1e-6
    (tests/test_stats_cluster_knn.py)."""
    bsz, h, w, kc, m = 3, 12, 16, 4, 32
    lab = rng.uniform(0, 1, (bsz, h, w, 3)).astype(np.float32)
    labels = rng.integers(0, kc, (bsz, h, w)).astype(np.int32)
    cands = rng.integers(0, h * w, (bsz, kc, m)).astype(np.int32)
    ref = jax.jit(jax.vmap(lambda l, pl, cd: jknn.knn_graph(
        l, pl, cd, k_num=5, chunk=64)))(
            jnp.asarray(lab), jnp.asarray(labels), jnp.asarray(cands))
    got = tknn.knn_graph(T(lab), T(labels), T(cands), k_num=5, chunk=64)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for i in range(bsz):     # the fold is bitwise each item's own graph
        one = tknn.knn_graph(T(lab[i]), T(labels[i]), T(cands[i]), k_num=5,
                             chunk=64)
        for x, y in zip(got, one):
            assert torch.equal(x[i], y)


def test_solve_wls_batched_vs_vmap(rng):
    """Iteration counts equal, coefficients rtol 2e-3 / atol 2e-4
    (tests/test_solvers.py)."""
    bsz, h, w = 3, 24, 32
    a_up = rng.uniform(0.5, 1.5, (bsz, h, w, 3)).astype(np.float32)
    b_up = rng.uniform(-0.2, 0.2, (bsz, h, w, 3)).astype(np.float32)
    cnt = rng.uniform(0, 1, (bsz, h, w, 3)).astype(np.float32)
    lam = 0.4
    av, bv, itv, _ = jax.jit(jax.vmap(lambda a, b, c: jwls.solve_wls(
        a, b, c, lam, iters=8, dynamic=False, return_iters=True)))(
            jnp.asarray(a_up), jnp.asarray(b_up), jnp.asarray(cnt))
    ta, tb, tit, tr2 = twls.solve_wls(T(a_up), T(b_up), T(cnt), lam,
                                      iters=8)
    assert tit.tolist() == np.asarray(itv).tolist()
    assert tr2.shape == (bsz,)
    np.testing.assert_allclose(ta.numpy(), np.asarray(av), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(bv), rtol=2e-3,
                               atol=2e-4)


# --- grouped CG and the batched nonlocal solve: against per-item solves -----

def test_grouped_cg_runs_each_item_to_its_own_exit():
    """Per-item alpha, beta and live masks: each item stops where its own
    cg_solve stops, and its iterate is that solve's."""
    diags = torch.stack([torch.linspace(1.0, s, 40)
                         for s in (5.0, 50.0, 500.0)])
    op = lambda x: (diags * x[0],)                  # noqa: E731
    b = (torch.ones(3, 40),)
    x, r2, n = tcg.cg_solve_grouped(op, b, (torch.zeros(3, 40),), iters=100,
                                    tol=1e-4)
    assert r2.shape == (3,) and n.dtype == torch.int64
    for i in range(3):
        xi, _, ni = tcg.cg_solve(lambda v: (diags[i] * v[0],), (b[0][i],),
                                 (torch.zeros(40),), iters=100, tol=1e-4)
        assert int(n[i]) == ni
        torch.testing.assert_close(x[0][i], xi[0], rtol=1e-5, atol=1e-6)
    assert len(set(n.tolist())) == 3          # three different exits
    _, _, n = tcg.cg_solve_grouped(op, b, (torch.zeros(3, 40),), iters=3,
                                   tol=0.0)
    assert n.tolist() == [3, 3, 3]


def _nl_items(rng):
    """Two systems of one geometry: the captured nl_L0 fixture, and one
    whose graph the port builds from other colours, labels and
    candidates."""
    d = dict(np.load(os.path.join(FIXTURES, "nl_L0.npz")))
    h, w, _ = d["src_lab"].shape
    lab = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (h, w))
    cands = rng.integers(0, h * w, d["candidates"].shape)
    ids, wts, slots = tknn.knn_graph(T(lab), T(labels), T(cands))
    e = {"a0": d["a0"] * 0.9, "b0": d["b0"] + 0.05, "src_lab": lab,
         "ref_lab": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
         "confidence": rng.uniform(0.1, 1, (h, w)).astype(np.float32),
         "nbr_ids": ids.numpy(), "nbr_w": wts.numpy(),
         "candidates": cands, "nbr_slots": slots.numpy()}
    return d, e, float(d["norm_factor"])


@pytest.mark.parametrize("in_cap", [128, 4])
def test_solve_nonlocal_batched_vs_items(rng, in_cap):
    """Iteration counts equal; coefficients rtol 2e-3 / atol 2e-4.  At
    in_cap=4 the in-edge tables overflow, so each item must keep its own
    pairs (its own rank < in_max)."""
    d, e, nf = _nl_items(rng)
    keys = ("a0", "b0", "src_lab", "ref_lab", "confidence", "nbr_ids",
            "nbr_w")
    kw = {"iters": 10, "tol": 1e-4, "in_cap": in_cap}
    stacked = [T(np.stack([np.asarray(d[k]), np.asarray(e[k])])) for k in keys]
    a, b, its, r2 = tnl.solve_nonlocal(
        *stacked, nf, candidates=T(np.stack([d["candidates"],
                                             e["candidates"]])),
        nbr_slots=T(np.stack([d["nbr_slots"], e["nbr_slots"]])), **kw)
    assert its.shape == r2.shape == (2,)
    for i, item in enumerate((d, e)):
        ai, bi, it_i, _ = tnl.solve_nonlocal(
            *(T(item[k]) for k in keys), nf, candidates=T(item["candidates"]),
            nbr_slots=T(item["nbr_slots"]), **kw)
        assert int(its[i]) == it_i
        torch.testing.assert_close(a[i], ai, rtol=2e-3, atol=2e-4)
        torch.testing.assert_close(b[i], bi, rtol=2e-3, atol=2e-4)


def test_batched_nonlocal_refuses_unbatched_options(rng):
    """The options the batched system once refused (block-Jacobi, the
    scatter transpose, pixel-keyed tables) now build over the fold: A x and
    the preconditioner are bitwise each item's own system's."""
    d, e, nf = _nl_items(rng)
    keys = ("src_lab", "ref_lab", "confidence", "nbr_ids", "nbr_w")
    args = [T(np.stack([np.asarray(d[k]), np.asarray(e[k])])) for k in keys]
    slots = {"candidates": T(np.stack([d["candidates"], e["candidates"]])),
             "nbr_slots": T(np.stack([d["nbr_slots"], e["nbr_slots"]]))}
    x = [T(rng.standard_normal((2,) + d["a0"].shape).astype(np.float32))
         for _ in range(2)]
    for kw in ({"precond_kind": "block_jacobi", **slots},
               {"transpose": "scatter", **slots}, {}):
        op, _, pc = tnl.make_nonlocal_system(*args, nf, **kw)
        got_op, got_pc = op(tuple(x)), pc(tuple(x))
        for i, item in enumerate((d, e)):
            one = {k: (v[i] if isinstance(v, torch.Tensor) else v)
                   for k, v in kw.items()}
            op_i, _, pc_i = tnl.make_nonlocal_system(
                *(T(item[k]) for k in keys), nf, **one)
            xi = (x[0][i], x[1][i])
            for g, w in zip(got_op + got_pc, op_i(xi) + pc_i(xi)):
                assert torch.equal(g[i], w)


# --- VGG, BDS vote, stats, clusters: against per-item calls -----------------

def test_vgg_batched_equals_items(rng):
    model = tvgg.init_params()
    x = T(rng.integers(0, 256, (2, 20, 28, 3)).astype(np.uint8))
    taps = ("conv2_1", "conv1_1")
    got = model(x, taps, torch.bfloat16)
    for i in range(2):
        one = model(x[i], taps, torch.bfloat16)
        for t in taps:
            assert got[t].shape[0] == 2 and torch.equal(got[t][i], one[t])


def test_bds_vote_and_guide_batched_equal_items(rng):
    bsz, ha, wa, hb, wb = 3, 9, 11, 10, 8
    ann = T(_random_nnf(rng, bsz, ha, wa, hb, wb))
    bnn = T(_random_nnf(rng, bsz, hb, wb, ha, wa))
    feat = T(rng.standard_normal((bsz, hb, wb, 5)).astype(np.float32))
    img = T(rng.integers(0, 256, (bsz, hb, wb, 3)).astype(np.uint8))
    voted, wsum = tbds.bds_vote(feat, ann, bnn, 1.0, 2.0, 3)
    guide = tbds.bds_reconstruct_color(img, ann, bnn, 1.0, 2.0, 3)
    for i in range(bsz):
        v, ws = tbds.bds_vote(feat[i], ann[i], bnn[i], 1.0, 2.0, 3)
        assert torch.equal(voted[i], v) and torch.equal(wsum[i], ws)
        assert torch.equal(guide[i], tbds.bds_reconstruct_color(
            img[i], ann[i], bnn[i], 1.0, 2.0, 3))


def test_stats_and_clusters_batched_equal_items(rng):
    bsz, h, w = 2, 13, 17
    cnt = T(rng.integers(0, 256, (bsz, h, w, 3)).astype(np.uint8))
    gd = T(rng.integers(0, 256, (bsz, h, w, 3)).astype(np.uint8))
    err = T(rng.standard_normal((bsz, h, w)).astype(np.float32))
    a, b = tst.init_ab(cnt, gd, 3, 0.6)
    conf = tst.error_confidence(err)
    pts = T(rng.standard_normal((bsz, 40, 8)).astype(np.float32))
    init = torch.stack([torch.randperm(40)[:5] for _ in range(bsz)])
    labels, centers = tcl.kmeans(pts, init, 5, 4)
    lmap = labels.reshape(bsz, 5, 8)
    memb = tcl.cluster_membership(lmap, 5)
    pix = tcl.labels_for_pixels(lmap, h, w, 3)
    mpix = tcl.membership_for_pixels(memb, h, w, 3)
    for i in range(bsz):
        ai, bi = tst.init_ab(cnt[i], gd[i], 3, 0.6)
        assert torch.equal(a[i], ai) and torch.equal(b[i], bi)
        assert torch.equal(conf[i], tst.error_confidence(err[i]))
        li, ci = tcl.kmeans(pts[i], init[i], 5, 4)
        assert torch.equal(labels[i], li)
        torch.testing.assert_close(centers[i], ci, rtol=1e-6, atol=1e-6)
        assert torch.equal(memb[i], tcl.cluster_membership(lmap[i], 5))
        assert torch.equal(pix[i], tcl.labels_for_pixels(lmap[i], h, w, 3))
        assert torch.equal(mpix[i],
                           tcl.membership_for_pixels(memb[i], h, w, 3))


# --- end to end: the vmap mode against the scan mode ------------------------

SMALL = Config(num_levels=2, cg_iters_mg=4, cg_iters_final_mg=3,
               wls_cg_iters_mg=3, kmeans_iters=3)


@pytest.fixture(scope="module")
def bucket():
    rng = np.random.default_rng(4)
    cnt = rng.integers(0, 256, (2, 40, 48, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (2, 44, 52, 3)).astype(np.uint8)
    return tvgg.init_params(), cnt, stl, [5, 9]


def test_vmap_mode_matches_scan_mode(bucket):
    model, cnt, stl, seeds = bucket
    vmap = tbatch.make_batch_transfer(SMALL, mode="vmap", device="cpu")
    scan = tbatch.make_batch_transfer(SMALL, mode="scan", device="cpu")
    got = vmap(model, cnt, stl, seeds, 2.0)
    want = scan(model, cnt, stl, seeds, 2.0)
    assert got.shape == (2, 40, 48, 3) and got.dtype == torch.uint8
    for i in range(2):
        _assert_mostly_equal(got[i].numpy(), want[i].numpy())


def test_vmap_trace_iterations_equal_transfer_pair(bucket):
    model, cnt, stl, seeds = bucket
    out, traces = pipeline.transfer_batch(
        model, cnt, stl, 2.0, SMALL, seeds=seeds, device="cpu",
        return_intermediates="stats")
    assert len(traces) == 2
    for i, seed in enumerate(seeds):
        ref, ref_trace = pipeline.transfer_pair(
            model, cnt[i], stl[i], 2.0, SMALL, seed=seed, device="cpu",
            return_intermediates="stats")
        _assert_mostly_equal(out[i].numpy(), ref.numpy())
        for key in ("nl_iters", "wls_iters"):
            assert [t[key] for t in traces[i]] == \
                [int(t[key]) for t in ref_trace]


@pytest.mark.parametrize("overrides", [
    {"fine_strategy": "patchmatch"}, {"exact_nn_levels": 0},
    {"knn_memberships": 3}, {"nl_precond": "block_jacobi"},
    {"wls_precond": "jacobi"}, {"nl_transpose": "scatter"}])
def test_vmap_excluded_configs_raise(bucket, overrides):
    """The Config values the vmap mode once excluded now run there: each
    item within the batch contract of its own pair, with its iteration
    counts (a space_mesh or mesh of the wrong type raises, below)."""
    import dataclasses

    model, cnt, stl, seeds = bucket
    config = dataclasses.replace(SMALL, **{
        "exact_nn_levels": 1, "pm_iters": 2, "pm_iters_fine": 2,
        **overrides})
    got = tbatch.make_batch_transfer(config, mode="vmap", device="cpu")(
        model, cnt, stl, seeds, 2.0)
    _, traces = pipeline.transfer_batch(model, cnt, stl, 2.0, config,
                                        seeds=seeds, device="cpu",
                                        return_intermediates="stats")
    for i, seed in enumerate(seeds):
        ref, ref_trace = pipeline.transfer_pair(
            model, cnt[i], stl[i], 2.0, config, seed=seed, device="cpu",
            return_intermediates="stats")
        _assert_mostly_equal(got[i].numpy(), ref.numpy())
        for key in ("nl_iters", "wls_iters"):
            assert [t[key] for t in traces[i]] == \
                [int(t[key]) for t in ref_trace]
    # the scan mode still takes them
    tbatch.make_batch_transfer(config, mode="scan", device="cpu")


def test_vmap_mesh_and_bad_inputs_raise(bucket):
    """A mesh or space_mesh that is not a parallel.mesh.Mesh raises (the
    mesh paths themselves: tests/test_torch_mesh.py)."""
    model, cnt, stl, seeds = bucket
    with pytest.raises(ValueError, match="parallel.mesh.Mesh"):
        tbatch.make_batch_transfer(SMALL, mesh=object(), mode="vmap",
                                   device="cpu")
    mesh_cfg = Config(space_mesh=object())
    with pytest.raises(ValueError, match="space_mesh"):
        tbatch.make_batch_transfer(mesh_cfg, mode="vmap", device="cpu")
    with pytest.raises(ValueError, match="space_mesh"):
        pipeline.transfer_batch(model, cnt, stl, 2.0, mesh_cfg, seeds=seeds,
                                device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tbatch.make_batch_transfer(SMALL, mode="pmap", device="cpu")
    fn = tbatch.make_batch_transfer(SMALL, mode="vmap", device="cpu")
    with pytest.raises(ValueError, match="B seeds"):
        fn(model, cnt, stl, seeds[:1], 2.0)
    with pytest.raises(ValueError, match="B seeds"):
        pipeline.transfer_batch(model, cnt[0], stl[0], 2.0, SMALL,
                                seeds=[1], device="cpu")


def test_transfer_batch_without_device_needs_a_card(bucket):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    model, cnt, stl, seeds = bucket
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.transfer_batch(model, cnt, stl, 2.0, SMALL, seeds=seeds)


# --- the per-stage batch profiler -------------------------------------------

BATCH_STAGES = ["nn_directed_L3", "bds_vote_L3", "knn_graph_L3",
                "nonlocal_mg10_L3", "window_refine_L4", "bds_vote_L4",
                "knn_graph_L4", "nonlocal_mg6_L4", "wls_mg8_fullres"]


def test_profile_batch_stages_cpu_small(capsys):
    """The tool's main in this process, on the file's one thread (a new
    process would take every core while the other test workers run)."""
    from nct_tpu_torch.tools import profile_batch_stages

    assert profile_batch_stages.main(
        ["--device", "cpu", "--small", "--reps", "1", "--batch", "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1])
    assert result["device"] == "cpu" and result["batch"] == 3
    assert list(result["stages"]) == BATCH_STAGES
    for name in BATCH_STAGES:
        assert sum(line.startswith(f"{name}: b=1 ") and "scaling" in line
                   for line in lines) == 1
        r = result["stages"][name]
        assert r["b1_ms"] > 0.0 and r["bB_ms"] > 0.0
        assert r["scaling"] == pytest.approx(r["bB_ms"] / (3 * r["b1_ms"]))
