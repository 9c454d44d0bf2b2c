"""Parity of the port's clustering, k-NN graph and solvers with nct_tpu.

Draws the JAX package makes with jax.random (k-means initial centres,
candidate scores) are made with JAX here and injected into the port.
Solver comparisons pin the iteration count (tol=0) so early exits cannot
make the two sides run different trip counts.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nct_tpu.solve import cluster as jcl
from nct_tpu.solve import knn as jknn
from nct_tpu.solve import nonlocal_solve as jnl
from nct_tpu.solve import stats as jst
from nct_tpu.solve import wls as jwls
from nct_tpu_torch.solve import cg as tcg
from nct_tpu_torch.solve import cluster as tcl
from nct_tpu_torch.solve import knn as tknn
from nct_tpu_torch.solve import nonlocal_solve as tnl
from nct_tpu_torch.solve import stats as tst
from nct_tpu_torch.solve import wls as twls

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def T(x):
    return torch.tensor(np.asarray(x))


def _fixture(name):
    return dict(np.load(os.path.join(FIXTURES, f"{name}.npz")))


# --- k-means and cluster maps -----------------------------------------------

def test_kmeans_injected_init_equal_labels(rng):
    pts = rng.standard_normal((150, 32)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    # a few well-separated blobs so no point sits on an assignment tie
    pts[:50] += 2.0
    pts[50:100, :4] -= 2.0
    key = jax.random.PRNGKey(4)
    ref_labels, ref_centers = jcl.kmeans(jnp.asarray(pts), key, 10, 11)
    init = np.asarray(jax.random.choice(key, 150, shape=(10,), replace=False))
    labels, centers = tcl.kmeans(T(pts), T(init), 10, 11)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    np.testing.assert_allclose(centers.numpy(), np.asarray(ref_centers),
                               rtol=1e-5, atol=1e-6)


def test_kmeans_init_draw():
    g = torch.Generator().manual_seed(0)
    idx = tcl.draw_kmeans_init(100, 10, g)
    assert len(set(idx.tolist())) == 10 and int(idx.max()) < 100
    small = tcl.draw_kmeans_init(4, 10, g)
    assert small.shape == (10,) and int(small.max()) < 4


def test_membership_and_pixel_maps_bitwise(rng):
    lm = rng.integers(0, 5, (6, 7)).astype(np.int32)
    mem_j = np.asarray(jcl.cluster_membership(jnp.asarray(lm), 5))
    mem_t = tcl.cluster_membership(T(lm), 5)
    np.testing.assert_array_equal(mem_t.numpy(), mem_j)
    for h, w, stride in ((6, 7, 1), (12, 13, 2), (50, 57, 8)):
        np.testing.assert_array_equal(
            tcl.labels_for_pixels(T(lm), h, w, stride).numpy(),
            np.asarray(jcl.labels_for_pixels(jnp.asarray(lm), h, w, stride)))
        np.testing.assert_array_equal(
            tcl.membership_for_pixels(mem_t, h, w, stride).numpy(),
            np.asarray(jcl.membership_for_pixels(jnp.asarray(mem_j), h, w,
                                                 stride)))


def test_candidates_with_injected_scores_equal(rng):
    lm = rng.integers(0, 4, (5, 6)).astype(np.int32)
    lm[0, 0] = 3                       # cluster 3 is tiny: repeats members
    lm[lm == 3] = 0
    lm[0, 0] = 3
    mem = np.asarray(jcl.membership_for_pixels(
        jcl.cluster_membership(jnp.asarray(lm), 4), 20, 24, 4))
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jknn.sample_cluster_candidates(jnp.asarray(mem), key, 64))
    scores = np.asarray(jax.random.uniform(key, (4, 20 * 24),
                                           dtype=jnp.float32))
    got = tknn.sample_cluster_candidates(T(mem), T(scores), 64)
    np.testing.assert_array_equal(got.numpy(), ref)


# --- k-NN graph -------------------------------------------------------------

def _knn_case(rng, quantised):
    d = _fixture("nl_L1")
    lab = d["src_lab"]
    if quantised:
        # multiples of 1/64: every product and sum is exact in f32, so the
        # bf16 ranking keys are identical and the graphs must be too
        lab = (np.round(lab * 64) / 64).astype(np.float32)
    h, w, _ = lab.shape
    labels = rng.integers(0, 10, (h, w)).astype(np.int32)
    ref = [np.asarray(x) for x in jknn.knn_graph(
        jnp.asarray(lab), jnp.asarray(labels), jnp.asarray(d["candidates"]))]
    got = [x.numpy() for x in tknn.knn_graph(T(lab), T(labels),
                                             T(d["candidates"]))]
    return lab, ref, got


def test_knn_graph_quantised_equal(rng):
    _, (ri, rw, rs), (gi, gw, gs) = _knn_case(rng, quantised=True)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gs, rs)
    # exp(1 - d/3): torch's and XLA's exp differ by an ulp
    np.testing.assert_allclose(gw, rw, rtol=1e-5, atol=0)


def test_knn_graph_random_tie_equivalent(rng):
    """With unquantised colours XLA's fused distance differs from the
    port's by an ulp, which can move a value across a bf16 rounding
    boundary and reorder candidates whose keys tie; every pixel must still
    pick the same multiset of bf16 distance keys, and equal picks carry
    equal weights."""
    lab, (ri, rw, rs), (gi, gw, gs) = _knn_case(rng, quantised=False)
    col = torch.from_numpy(lab.reshape(-1, 3))

    def keys(ids):
        d = ((col[:, None, :] - col[torch.tensor(ids)]) ** 2).sum(-1)
        return np.sort(d.to(torch.bfloat16).float().numpy(), axis=1)

    np.testing.assert_array_equal(keys(gi), keys(ri))
    same = gi == ri
    assert same.mean() >= 0.9
    np.testing.assert_allclose(gw[same], rw[same], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(gs[same], rs[same])


# --- patch statistics -------------------------------------------------------

@pytest.mark.parametrize("hw", [(40, 48), (17, 23), (64, 85)])
def test_init_ab_and_confidence_bitwise(rng, hw):
    c = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    g = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    ja, jb = jst.init_ab(jnp.asarray(c), jnp.asarray(g), 3, 0.6)
    ta, tb = tst.init_ab(T(c), T(g), 3, 0.6)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    err = rng.standard_normal(hw).astype(np.float32)
    np.testing.assert_array_equal(
        tst.error_confidence(T(err)).numpy(),
        np.asarray(jst.error_confidence(jnp.asarray(err))))


# --- solvers ----------------------------------------------------------------

_NL_ARGS = ("src_lab", "ref_lab", "confidence", "nbr_ids", "nbr_w")


def _systems(d, in_cap):
    nf = float(d["norm_factor"])
    j = jnl.make_nonlocal_system(
        *(jnp.asarray(d[k]) for k in _NL_ARGS), nf,
        candidates=jnp.asarray(d["candidates"]),
        nbr_slots=jnp.asarray(d["nbr_slots"]), precond_kind="mg",
        in_cap=in_cap)
    t = tnl.make_nonlocal_system(
        *(T(d[k]) for k in _NL_ARGS), nf, candidates=T(d["candidates"]),
        nbr_slots=T(d["nbr_slots"]), in_cap=in_cap)
    return j, t


@pytest.mark.parametrize("name", ["nl_L0", "nl_L1"])
@pytest.mark.parametrize("in_cap", [128, 4])
def test_nonlocal_operator_and_preconditioner(rng, name, in_cap):
    """in_cap=4 forces the auto-widened, overflow-dropping tables."""
    d = _fixture(name)
    (jop, jrhs, jpc), (top, trhs, tpc) = _systems(d, in_cap)
    x = tuple(rng.standard_normal(d["a0"].shape).astype(np.float32)
              for _ in range(2))
    for fj, ft in ((jop, top), (jpc, tpc)):
        outj = jax.jit(fj)(tuple(jnp.asarray(v) for v in x))
        outt = ft(tuple(T(v) for v in x))
        for r, g in zip(outj, outt):
            r = np.asarray(r)
            # same terms, summed in another order: f32 rounding of the scale
            np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                       atol=1e-5 * np.abs(r).max())
    for r, g in zip(jrhs, trhs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_in_edge_width_auto_widening():
    # mean in-degree 259 over the configured cap 128: widened to 1.5x mean
    assert tnl.in_edge_width(5_300_000, 20_480, 128) == 389
    assert tnl.in_edge_width(43_520, 20_480, 128) == 8
    assert tnl.in_edge_width(72, 90, 128) == 72        # exact operator


@pytest.mark.parametrize("name", ["nl_L0", "nl_L1"])
def test_solve_nonlocal_pinned_iterations(name):
    d = _fixture(name)
    nf = float(d["norm_factor"])
    ja, jb, jit, _ = jnl.solve_nonlocal(
        *(jnp.asarray(d[k]) for k in ("a0", "b0") + _NL_ARGS), nf, iters=6,
        tol=0.0, candidates=jnp.asarray(d["candidates"]),
        nbr_slots=jnp.asarray(d["nbr_slots"]), precond_kind="mg",
        return_iters=True)
    ta, tb, tit, _ = tnl.solve_nonlocal(
        *(T(d[k]) for k in ("a0", "b0") + _NL_ARGS), nf, iters=6, tol=0.0,
        candidates=T(d["candidates"]), nbr_slots=T(d["nbr_slots"]))
    assert tit == int(jit) == 6
    # CG dot products reduce in another order; 6 iterations keep the
    # drift at ~1e-6 of these O(1) coefficients (measured <= 4e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=5e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=5e-5)


@pytest.mark.parametrize("name", ["nl_L0", "nl_L1"])
def test_solve_wls_pinned_iterations(name):
    d = _fixture(name)
    lab, a0, b0 = d["src_lab"], d["a0"], d["b0"]
    ja, jb, jit, _ = jwls.solve_wls(
        jnp.asarray(a0), jnp.asarray(b0), jnp.asarray(lab), 0.5, 1.2,
        iters=8, tol=0.0, return_iters=True)
    ta, tb, tit, _ = twls.solve_wls(T(a0), T(b0), T(lab), 0.5, 1.2,
                                    iters=8, tol=0.0)
    assert tit == int(jit) == 8
    # as above: reduction order only (measured <= 1.2e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)


def test_roughness_gate_and_apply_bitwise(rng):
    a = rng.uniform(-1, 3, (6, 7, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (6, 7, 3)).astype(np.float32)
    lab = rng.random((6, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        twls.roughness_gate(T(a), T(b), T(lab)).numpy(),
        np.asarray(jwls.roughness_gate(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(lab))))
    np.testing.assert_array_equal(
        twls.apply_transform(T(a), T(b), T(lab)).numpy(),
        np.asarray(jwls.apply_transform(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(lab))))


def test_cg_early_exit_and_budget():
    """Dynamic exit at ||r||^2 <= tol^2 ||b||^2, else the full budget."""
    diag = torch.linspace(1.0, 50.0, 40)
    op = lambda x: (diag * x[0],)                      # noqa: E731
    b = (torch.ones(40),)
    x, r2, n = tcg.cg_solve(op, b, (torch.zeros(40),), iters=100, tol=1e-4)
    assert n < 40 and float(r2) <= 1e-8 * 40
    torch.testing.assert_close(x[0], 1.0 / diag, rtol=1e-3, atol=0)
    _, _, n = tcg.cg_solve(op, b, (torch.zeros(40),), iters=3, tol=0.0)
    assert n == 3
