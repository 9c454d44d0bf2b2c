"""Parity of the port's clustering, k-NN graph and solvers with nct_tpu:
the default solvers, the several-membership merge, the solver variants and
the retune tools.  They share one module, so one process compiles each JAX
program at each shape of the captured systems
(tests/fixtures/nl_L{0,1}.npz) once for them all.

The default solvers.  Draws the JAX package makes with jax.random (k-means
initial centres, candidate scores) are made with JAX here and injected into
the port.  Solver comparisons pin the iteration count (tol=0) so early
exits cannot make the two sides run different trip counts.

The several-membership k-NN merge: ``cluster.multi_labels_for_pixels``,
the P > 1 path of ``knn.knn_graph`` and the numpy exact oracle
``knn_exact``.  Labels, ids and slots bitwise; weights rtol 1e-5 (torch's
and XLA's float32 ``exp`` differ by an ulp); the recall fence of
tests/test_stats_cluster_knn.py (id and weight recall 1.0 within 1e-6) on
the same inputs and the same candidate draw.

The solver variants: the block-Jacobi nonlocal preconditioner, the scatter
transpose, the pixel-keyed in-edge tables of graphs without candidate
slots, and the Jacobi WLS preconditioner.  Operators and preconditioners
are compared on one random vector; solves pin their trip counts (tol=0).
Tolerances: operators and preconditioners within 1e-5 of the output's max
magnitude (the same terms summed in another order), solves as the default
solvers' (CG dot products reduce in another order).

The retune tools (``solve/retune.py``): the capped nonlocal and WLS solves,
the residual curves at the same caps, and the matcher-free WLS system.
The WLS system is built from a seeded smooth 48x64 pair (the JAX package's
own WLS fence reads the reference's demo images, absent here).
Tolerances: residuals rtol 1e-3 at caps <= 10 and the curve's reductions
rtol 1e-2 (the CG dot products reduce in another order, and that drift
grows with the cap and as r2 falls toward the float32 floor); solutions
atol 5e-5 (as the default solvers'); the WLS start bitwise.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nct_tpu.config import Config as JaxConfig
from nct_tpu.solve import cluster as jcl
from nct_tpu.solve import knn as jknn
from nct_tpu.solve import knn_exact as jke
from nct_tpu.solve import nonlocal_solve as jnl
from nct_tpu.solve import retune as jrt
from nct_tpu.solve import stats as jst
from nct_tpu.solve import wls as jwls
from nct_tpu_torch import Config
from nct_tpu_torch.solve import cg as tcg
from nct_tpu_torch.solve import cluster as tcl
from nct_tpu_torch.solve import knn as tknn
from nct_tpu_torch.solve import knn_exact as tke
from nct_tpu_torch.solve import nonlocal_solve as tnl
from nct_tpu_torch.solve import retune as trt
from nct_tpu_torch.solve import stats as tst
from nct_tpu_torch.solve import wls as twls

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
NL_ARGS = ("src_lab", "ref_lab", "confidence", "nbr_ids", "nbr_w")
# the solver variants' tolerances
OP_TOL = 1e-5        # relative to the output's max magnitude
SOLVE_ATOL = 5e-5
# the retune tools' caps
CAPS = (4, 10)
CONVERGED = 24           # a converged reference that keeps the test short


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
    np.testing.assert_array_equal(gw, rw)


def test_knn_graph_random_tie_equivalent(rng):
    """With unquantised colours the ranking keys depend on how each 3-term
    sum is rounded; the port rounds them as XLA's CPU backend does (fused
    multiply-add chains, and XLA's exp for the weights), so ids, weights
    and slots are bitwise the JAX package's."""
    _, (ri, rw, rs), (gi, gw, gs) = _knn_case(rng, quantised=False)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gw, rw)
    np.testing.assert_array_equal(gs, rs)


# --- several memberships (the P > 1 merge) --------------------------------

@pytest.mark.parametrize("k,p", [(10, 2), (10, 3), (3, 5), (5, 1), (4, 4)])
def test_multi_labels_for_pixels_bitwise(rng, k, p):
    lm = rng.integers(0, k, (7, 9)).astype(np.int32)
    mem = jcl.cluster_membership(jnp.asarray(lm), k)
    for h, w, stride in ((7, 9, 1), (28, 36, 4), (30, 37, 4)):
        ref = np.asarray(jcl.multi_labels_for_pixels(
            jnp.asarray(lm), mem, h, w, stride, p))
        got = tcl.multi_labels_for_pixels(T(lm), T(mem), h, w, stride, p)
        assert got.shape == ref.shape == (h, w, min(p, k))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_multi_labels_ties_keep_lower_cluster_first():
    """A cell in three dilated memberships lists them in cluster order
    after its primary (lax.top_k's stable order); a cell in two repeats
    its primary in the third place."""
    lm = np.array([[2, 0], [1, 1]], np.int32)
    mem = tcl.cluster_membership(T(lm), 3)
    got = tcl.multi_labels_for_pixels(T(lm), mem, 2, 2, 1, 3).numpy()
    np.testing.assert_array_equal(got[0, 0], [2, 0, 1])
    np.testing.assert_array_equal(got[1, 1], [1, 0, 1])


def _graph_inputs(rng, p, quantised=True):
    d = dict(np.load(os.path.join(FIXTURES, "nl_L1.npz")))
    lab = d["src_lab"]
    if quantised:
        # multiples of 1/64: every product and sum is exact in float32
        lab = (np.round(lab * 64) / 64).astype(np.float32)
    h, w, _ = lab.shape
    lm = rng.integers(0, 10, (h // 8 + 1, w // 8 + 1)).astype(np.int32)
    mem = jcl.cluster_membership(jnp.asarray(lm), 10)
    labels = np.asarray(jcl.multi_labels_for_pixels(jnp.asarray(lm), mem, h,
                                                    w, 8, p))
    return lab, labels, d["candidates"]


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("quantised", [True, False])
def test_multi_graph_equal(rng, p, quantised):
    """Equal ids and slots: bitwise on quantised colours by construction,
    and on continuous ones too, since the port rounds the three 3-term
    sums of the distance as XLA does (ops/fmath.dot3_fma)."""
    lab, labels, cand = _graph_inputs(rng, p, quantised)
    ri, rw, rs = (np.asarray(x) for x in jknn.knn_graph(
        jnp.asarray(lab), jnp.asarray(labels), jnp.asarray(cand)))
    gi, gw, gs = (x.numpy() for x in tknn.knn_graph(T(lab), T(labels),
                                                    T(cand)))
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gs, rs)
    np.testing.assert_allclose(gw, rw, rtol=1e-5, atol=0)
    # slots point at the selected ids in the flat candidate table
    np.testing.assert_array_equal(cand.reshape(-1)[gs], gi)


def test_multi_graph_does_not_depend_on_chunk(rng):
    lab, labels, cand = _graph_inputs(rng, 3, quantised=False)
    a = tknn.knn_graph(T(lab), T(labels), T(cand))
    b = tknn.knn_graph(T(lab), T(labels), T(cand), chunk=777)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_single_membership_column_is_the_sorted_path(rng):
    """[H, W, 1] labels take the P == 1 path, bitwise the [H, W] call."""
    lab, labels, cand = _graph_inputs(rng, 1)
    a = tknn.knn_graph(T(lab), T(labels[..., 0]), T(cand))
    b = tknn.knn_graph(T(lab), T(labels), T(cand))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_multi_graph_union_bruteforce(rng):
    """P = 2 over two clusters that split the pixels: the k best of the
    union of both candidate tables (float64 brute force)."""
    h, w, k = 4, 6, 3
    n = h * w
    lab = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    cand = torch.stack([torch.arange(n // 2), torch.arange(n // 2, n)])
    multi = torch.tensor([0, 1]).repeat(h, w, 1)
    ids, _, slots = tknn.knn_graph(T(lab), multi, cand, k_num=k)
    torch.testing.assert_close(cand.reshape(-1)[slots], ids)
    flat = lab.reshape(n, 3).astype(np.float64)
    for i in range(n):
        d = ((flat - flat[i]) ** 2).sum(axis=1)
        d[i] = np.inf
        assert set(ids[i].tolist()) == set(np.argsort(d)[:k].tolist())


def _fence_case():
    """The inputs of the JAX package's exact-reference fence."""
    rng = np.random.default_rng(3)
    h, w, stride = 48, 64, 4
    lab = rng.uniform(0, 1, (h, w, 3))
    for _ in range(2):
        lab = (lab + np.roll(lab, 1, 0) + np.roll(lab, -1, 0)
               + np.roll(lab, 1, 1) + np.roll(lab, -1, 1)) / 5
    lab = lab.astype(np.float32)
    lm = rng.integers(0, 10, (h // stride, w // stride)).astype(np.int32)
    return lab, lm, h, w, stride


def test_knn_exact_copy_equals_jax_package():
    lab, lm, h, w, stride = _fence_case()
    memb = tcl.cluster_membership(T(lm), 10)
    member_pix = tcl.membership_for_pixels(memb, h, w, stride).numpy()
    got = tke.exact_knn_graph(lab, member_pix, 8)
    ref = jke.exact_knn_graph(lab, member_pix, 8)
    for g, r in zip(got, ref):
        assert len(g) == len(r) == h * w
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
    ids = np.stack([np.pad(x, (0, 8 - x.size)) for x in got[0]])
    wts = np.stack([np.pad(x, (0, 8 - x.size)) for x in got[1]])
    assert tke.graph_recall(ids, wts, *got) == jke.graph_recall(ids, wts,
                                                               *ref)


def test_multi_graph_recall_fence():
    """All members as candidates (the JAX package's draw) and every dilated
    membership queried: the port's graph is the exact graph (id and weight
    recall 1.0 against the port's knn_exact)."""
    lab, lm, h, w, stride = _fence_case()
    memb = tcl.cluster_membership(T(lm), 10)
    member_pix = tcl.membership_for_pixels(memb, h, w, stride)
    ex_ids, ex_w = tke.exact_knn_graph(lab, member_pix.numpy(), 8)
    cand = jknn.sample_cluster_candidates(
        jnp.asarray(member_pix.numpy()), jax.random.PRNGKey(0), h * w)
    labels = tcl.multi_labels_for_pixels(T(lm), memb, h, w, stride, 5)
    ids, ws, _ = tknn.knn_graph(T(lab), labels, T(cand), k_num=8)
    rid, rw = tke.graph_recall(ids.numpy(), ws.numpy(), ex_ids, ex_w)
    assert rid == pytest.approx(1.0, abs=1e-6)
    assert rw == pytest.approx(1.0, abs=1e-6)


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

def _systems(d, in_cap):
    nf = float(d["norm_factor"])
    j = jnl.make_nonlocal_system(
        *(jnp.asarray(d[k]) for k in NL_ARGS), nf,
        candidates=jnp.asarray(d["candidates"]),
        nbr_slots=jnp.asarray(d["nbr_slots"]), precond_kind="mg",
        in_cap=in_cap)
    t = tnl.make_nonlocal_system(
        *(T(d[k]) for k in NL_ARGS), nf, candidates=T(d["candidates"]),
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
        *(jnp.asarray(d[k]) for k in ("a0", "b0") + NL_ARGS), nf, iters=6,
        tol=0.0, candidates=jnp.asarray(d["candidates"]),
        nbr_slots=jnp.asarray(d["nbr_slots"]), precond_kind="mg",
        return_iters=True)
    ta, tb, tit, _ = tnl.solve_nonlocal(
        *(T(d[k]) for k in ("a0", "b0") + NL_ARGS), nf, iters=6, tol=0.0,
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


# --- the solver variants --------------------------------------------------

def _random_graph(rng, h=12, w=14, k=5):
    """A graph without candidate slots whose hub pixels overflow the
    pixel-keyed tables' width of 2k."""
    n = h * w
    ids = rng.integers(0, n - 1, (n, k))
    ids += ids >= np.arange(n)[:, None]  # no self pairs
    ids[4:n // 2, 0] = 3                 # pixel 3 gets ~n/2 in-edges
    return {
        "src_lab": rng.random((h, w, 3)).astype(np.float32),
        "ref_lab": rng.random((h, w, 3)).astype(np.float32),
        "confidence": rng.random((h, w)).astype(np.float32),
        "nbr_ids": ids.astype(np.int32),
        "nbr_w": np.exp(1.0 - rng.random((n, k)) / 3.0).astype(np.float32),
        "norm_factor": np.float32(4.0),
        "a0": rng.random((h, w, 3)).astype(np.float32),
        "b0": rng.random((h, w, 3)).astype(np.float32),
    }


def _case(name, rng):
    return _random_graph(rng) if name == "random" else _fixture(name)


def _slots(d, slots):
    if not slots or "candidates" not in d:
        return {}
    return {"candidates": d["candidates"], "nbr_slots": d["nbr_slots"]}


def _compare_system(d, rng, slots=True, **kw):
    nf = float(d["norm_factor"])
    extra = _slots(d, slots)
    j = jnl.make_nonlocal_system(
        *(jnp.asarray(d[k]) for k in NL_ARGS), nf,
        **{k: jnp.asarray(v) for k, v in extra.items()}, **kw)
    t = tnl.make_nonlocal_system(
        *(T(d[k]) for k in NL_ARGS), nf,
        **{k: T(v) for k, v in extra.items()}, **kw)
    x = tuple(rng.standard_normal(d["src_lab"].shape).astype(np.float32)
              for _ in range(2))
    for fj, ft in ((j[0], t[0]), (j[2], t[2])):
        outj = jax.jit(fj)(tuple(jnp.asarray(v) for v in x))
        outt = ft(tuple(T(v) for v in x))
        for r, g in zip(outj, outt):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                       atol=OP_TOL * np.abs(r).max())
    for r, g in zip(j[1], t[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _compare_solve(d, iters, slots=True, **kw):
    nf = float(d["norm_factor"])
    extra = _slots(d, slots)
    ja, jb, jit, _ = jnl.solve_nonlocal(
        *(jnp.asarray(d[k]) for k in ("a0", "b0") + NL_ARGS), nf,
        iters=iters, tol=0.0, return_iters=True,
        **{k: jnp.asarray(v) for k, v in extra.items()}, **kw)
    ta, tb, tit, _ = tnl.solve_nonlocal(
        *(T(d[k]) for k in ("a0", "b0") + NL_ARGS), nf, iters=iters,
        tol=0.0, **{k: T(v) for k, v in extra.items()}, **kw)
    assert tit == int(jit) == iters
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=SOLVE_ATOL)


# --- block-Jacobi and the transposes on the captured systems ---------------

@pytest.mark.parametrize("name", ["nl_L0", "nl_L1"])
@pytest.mark.parametrize("kw", [
    {"precond_kind": "block_jacobi"},
    {"precond_kind": "block_jacobi", "in_cap": 4},
    {"precond_kind": "block_jacobi", "transpose": "scatter"},
    {"precond_kind": "mg", "transpose": "scatter"},
], ids=["bj-tables", "bj-tables-cap4", "bj-scatter", "mg-scatter"])
def test_operator_and_preconditioner(rng, name, kw):
    _compare_system(_fixture(name), rng, **kw)


@pytest.mark.parametrize("name", ["nl_L0", "nl_L1"])
@pytest.mark.parametrize("kw", [
    {"precond_kind": "block_jacobi"},
    {"precond_kind": "block_jacobi", "transpose": "scatter"},
    {"precond_kind": "mg", "transpose": "scatter"},
], ids=["bj-tables", "bj-scatter", "mg-scatter"])
def test_solve_pinned_iterations(name, kw):
    _compare_solve(_fixture(name), 10, **kw)


# --- pixel-keyed in-edge tables (no candidate slots) ------------------------

@pytest.mark.parametrize("name", ["random", "nl_L0"])
@pytest.mark.parametrize("precond_kind", ["block_jacobi", "mg"])
def test_pixel_keyed_tables(rng, name, precond_kind):
    d = _case(name, rng)
    _compare_system(d, rng, slots=False, precond_kind=precond_kind)
    _compare_solve(d, 10, slots=False, precond_kind=precond_kind)


def test_pixel_keyed_tables_drop_hub_overflow(rng):
    """The hub's in-edges beyond 2k are dropped on both sides: the tables
    operator differs from the exact scatter operator, and stays
    symmetric."""
    d = _random_graph(rng)
    nf = float(d["norm_factor"])
    args = [T(d[k]) for k in NL_ARGS]
    op_t = tnl.make_nonlocal_system(*args, nf, transpose="tables")[0]
    op_s = tnl.make_nonlocal_system(*args, nf, transpose="scatter")[0]
    x, y = (tuple(torch.from_numpy(rng.standard_normal(
        d["src_lab"].shape).astype(np.float32)) for _ in range(2))
        for _ in range(2))

    def dot(u, v):
        return sum(float((a.double() * b.double()).sum()) for a, b in zip(u, v))

    assert dot(op_t(x), y) == pytest.approx(dot(x, op_t(y)), rel=1e-5)
    assert max(float((a - b).abs().max())
               for a, b in zip(op_t(x), op_s(x))) > 1e-3


# --- scatter vs tables, auto, dense-free reference --------------------------

@pytest.mark.parametrize("name", ["nl_L0", "nl_L1"])
def test_scatter_equals_tables_at_ample_cap(rng, name):
    """An in_cap >= n*k keeps every pair: the two transposes are one
    operator (relative max difference of A x <= 1e-5)."""
    d = _fixture(name)
    nf = float(d["norm_factor"])
    args = [T(d[k]) for k in NL_ARGS]
    slots = {"candidates": T(d["candidates"]), "nbr_slots": T(d["nbr_slots"])}
    ample = d["nbr_ids"].size
    op_t = tnl.make_nonlocal_system(*args, nf, **slots, in_cap=ample,
                                    transpose="tables")[0]
    op_s = tnl.make_nonlocal_system(*args, nf, **slots,
                                    transpose="scatter")[0]
    x = tuple(torch.from_numpy(rng.standard_normal(
        d["src_lab"].shape).astype(np.float32)) for _ in range(2))
    for a, b in zip(op_t(x), op_s(x)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


def test_auto_transpose_is_tables_and_follows_threshold(rng, monkeypatch):
    d = _fixture("nl_L0")
    nf = float(d["norm_factor"])
    args = [T(d[k]) for k in NL_ARGS]
    x = tuple(torch.from_numpy(rng.standard_normal(
        d["src_lab"].shape).astype(np.float32)) for _ in range(2))
    kw = {"candidates": T(d["candidates"]), "nbr_slots": T(d["nbr_slots"]),
          "in_cap": 4}

    def apply(transpose):
        return tnl.make_nonlocal_system(*args, nf, transpose=transpose,
                                        **kw)[0](x)

    assert tnl._TABLES_MAX_PAIRS == jnl._TABLES_MAX_PAIRS
    for a, b in zip(apply("auto"), apply("tables")):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    monkeypatch.setattr(tnl, "_TABLES_MAX_PAIRS", 0)
    for a, b in zip(apply("auto"), apply("scatter")):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["random", "nl_L1"])
def test_nonlocal_apply_and_degree(rng, name):
    d = _case(name, rng)
    n, k = d["nbr_ids"].shape
    u = rng.standard_normal((n, 6)).astype(np.float32)
    ref = np.asarray(jnl.nonlocal_apply(jnp.asarray(u),
                                        jnp.asarray(d["nbr_ids"]),
                                        jnp.asarray(d["nbr_w"])))
    got = tnl.nonlocal_apply(T(u), T(d["nbr_ids"]), T(d["nbr_w"])).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=OP_TOL * np.abs(ref).max())
    ref = np.asarray(jnl.nonlocal_degree(jnp.asarray(d["nbr_ids"]),
                                         jnp.asarray(d["nbr_w"]), n))
    got = tnl.nonlocal_degree(T(d["nbr_ids"]), T(d["nbr_w"]), n).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_scatter_operator_equals_dense_free_reference(rng):
    """The scatter transpose is the exact graph term: its nonlocal part is
    nonlocal_apply with the pair weights w * w_nl / k."""
    d = _random_graph(rng)
    h, w, _ = d["src_lab"].shape
    n, k = d["nbr_ids"].shape
    args = [T(d[key]) for key in NL_ARGS]
    zeros = torch.zeros(h, w)
    op = tnl.make_nonlocal_system(*args[:2], zeros, *args[3:], 1.0,
                                  local_weight=0.0, nonlocal_weight=2.0,
                                  transpose="scatter")[0]
    a = torch.from_numpy(rng.standard_normal((h, w, 3)).astype(np.float32))
    got = op((a, torch.zeros_like(a)))[0].reshape(n, 3)
    ref = tnl.nonlocal_apply(a.reshape(n, 3), args[3],
                             args[4] * (2.0 / k))
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=OP_TOL * float(ref.abs().max()))


def test_unknown_kinds_raise():
    d = _random_graph(np.random.default_rng(0))
    args = [T(d[k]) for k in NL_ARGS]
    with pytest.raises(ValueError, match="precond_kind"):
        tnl.make_nonlocal_system(*args, 1.0, precond_kind="jacobi")
    with pytest.raises(ValueError, match="transpose"):
        tnl.make_nonlocal_system(*args, 1.0, transpose="dense")
    with pytest.raises(ValueError, match="precond_kind"):
        twls.solve_wls(T(d["a0"]), T(d["b0"]), T(d["src_lab"]), 0.5,
                       precond_kind="block_jacobi")


# --- WLS Jacobi ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["nl_L0", "nl_L1"])
def test_solve_wls_jacobi_pinned_iterations(name):
    d = _fixture(name)
    lab, a0, b0 = d["src_lab"], d["a0"], d["b0"]
    ja, jb, jit, _ = jwls.solve_wls(
        jnp.asarray(a0), jnp.asarray(b0), jnp.asarray(lab), 0.5, 1.2,
        iters=20, tol=0.0, return_iters=True, precond_kind="jacobi")
    ta, tb, tit, _ = twls.solve_wls(T(a0), T(b0), T(lab), 0.5, 1.2, iters=20,
                                    tol=0.0, precond_kind="jacobi")
    assert tit == int(jit) == 20
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=SOLVE_ATOL)


# --- the retune tools -----------------------------------------------------

def _system(name):
    return trt.load_nl_system(os.path.join(FIXTURES, f"{name}.npz"))


def _configs(**kw):
    return Config(**kw), JaxConfig(**kw)


@pytest.mark.parametrize("name", ["nl_L0", "nl_L1"])
@pytest.mark.parametrize("kw", [{}, {"nl_precond": "block_jacobi"},
                                {"nl_transpose": "scatter"}],
                         ids=["mg", "block_jacobi", "scatter"])
def test_nl_solve_at_cap(name, kw):
    system = _system(name)
    tcfg, jcfg = _configs(**kw)
    for cap in (0,) + CAPS:
        ta, tb, tr2 = trt.nl_solve_at_cap(system, cap, tcfg, device="cpu")
        ja, jb, jr2 = jrt.nl_solve_at_cap(system, cap, jcfg)
        assert tr2 == pytest.approx(jr2, rel=1e-3)
        np.testing.assert_allclose(ta, ja, rtol=0, atol=5e-5)
        np.testing.assert_allclose(tb, jb, rtol=0, atol=5e-5)


@pytest.mark.parametrize("precond", ["mg", "block_jacobi"])
def test_nl_residual_curve(precond):
    system = _system("nl_L0")
    tcfg, jcfg = _configs(nl_precond=precond)
    got = trt.residual_curve(
        lambda c: trt.nl_solve_at_cap(system, c, tcfg, device="cpu"), CAPS,
        CONVERGED)
    ref = jrt.residual_curve(lambda c: jrt.nl_solve_at_cap(system, c, jcfg),
                             CAPS, CONVERGED)
    assert sorted(got["caps"]) == sorted(ref["caps"]) == list(CAPS)
    assert got["converged"]["iters"] == CONVERGED
    assert got["converged"]["r2_init"] == pytest.approx(
        ref["converged"]["r2_init"], rel=1e-5)
    for cap in CAPS:
        g, r = got["caps"][cap], ref["caps"][cap]
        assert g["reduction"] == pytest.approx(r["reduction"], rel=1e-2)
        assert g["sol_err"] == pytest.approx(r["sol_err"], rel=1e-2,
                                             abs=1e-5)
    reductions = [got["caps"][c]["reduction"] for c in CAPS]
    assert 1.0 > reductions[0] > reductions[1]
    assert trt.recommend_cap(got, reductions[0]) == CAPS[0]


def test_recommend_cap_picks_smallest_meeting_target():
    curve = {
        "converged": {"iters": 200, "r2": 1e-9, "r2_init": 1.0},
        "caps": {4: {"reduction": 1e-2}, 8: {"reduction": 1e-4},
                 12: {"reduction": 1e-6}},
    }
    for rt in (trt, jrt):
        assert rt.recommend_cap(curve, 1e-3) == 8
        assert rt.recommend_cap(curve, 1e-7) is None
    assert trt.CONVERGED_ITERS == jrt.CONVERGED_ITERS


def _pair():
    rng = np.random.default_rng(5)
    out = []
    for h, w in ((48, 64), (52, 60)):
        x = rng.uniform(0, 255, (6, 8, 3))
        x = np.kron(x, np.ones((h // 6 + 1, w // 8 + 1, 1)))[:h, :w]
        out.append((x + rng.uniform(-20, 20, x.shape)).clip(0, 255)
                   .astype(np.uint8))
    return out


@pytest.mark.parametrize("level", [0, 4])
def test_wls_system_from_image(level):
    cnt, stl = _pair()
    got = trt.wls_system_from_image(cnt, stl, level, Config(), device="cpu")
    ref = jrt.wls_system_from_image(cnt, stl, level, JaxConfig())
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[3] == ref[3]


@pytest.mark.parametrize("precond", ["mg", "jacobi"])
def test_wls_solve_at_cap(precond):
    cnt, stl = _pair()
    tcfg, jcfg = _configs(wls_precond=precond)
    tsys = trt.wls_system_from_image(cnt, stl, 0, tcfg, device="cpu")
    jsys = jrt.wls_system_from_image(cnt, stl, 0, jcfg)
    r2s = []
    for cap in (0,) + CAPS:
        ta, tb, tr2 = trt.wls_solve_at_cap(tsys, cap, tcfg)
        ja, jb, jr2 = jrt.wls_solve_at_cap(jsys, cap, jcfg)
        assert tr2 == pytest.approx(jr2, rel=1e-3)
        np.testing.assert_allclose(ta, ja, rtol=0, atol=5e-5)
        np.testing.assert_allclose(tb, jb, rtol=0, atol=5e-5)
        r2s.append(tr2)
    assert r2s[0] > r2s[1] > r2s[2]


@pytest.mark.parametrize("case", ["nl_L0", "identity"])
def test_tol_zero_trip_count_matches_fixed_trip_loop(case):
    """tol=0 makes the cap exact: the port's loop runs ``iters`` times and
    reports the count the JAX package's fixed-trip loop reports; both stop
    counting once the residual is exactly 0 (the identity: one step)."""
    from nct_tpu.solve import cg as jcg
    from nct_tpu.solve import nonlocal_solve as jnl
    from nct_tpu_torch.solve import nonlocal_solve as tnl

    if case == "identity":
        top = jop = lambda x: x                        # noqa: E731
        tpc = jpc = None
        b = np.linspace(1.0, 2.0, 12).astype(np.float32)
        tb, jb = (torch.from_numpy(b),), (jnp.asarray(b),)
        tx0, jx0 = (torch.zeros(12),), (jnp.zeros(12),)
    else:
        d = _system(case)
        args = ("src_lab", "ref_lab", "confidence", "nbr_ids", "nbr_w")
        nf = float(d["norm_factor"])
        top, tb, tpc = tnl.make_nonlocal_system(
            *(torch.from_numpy(d[k]) for k in args), nf,
            precond_kind="block_jacobi")
        jop, jb, jpc = jnl.make_nonlocal_system(
            *(jnp.asarray(d[k]) for k in args), nf,
            precond_kind="block_jacobi")
        tx0 = (torch.from_numpy(d["a0"]), torch.from_numpy(d["b0"]))
        jx0 = (jnp.asarray(d["a0"]), jnp.asarray(d["b0"]))
    _, _, n = tcg.cg_solve(top, tb, tx0, iters=30, tol=0.0,
                           preconditioner=tpc)
    _, _, jn = jcg.cg_solve(jop, jb, jx0, iters=30, tol=0.0,
                            preconditioner=jpc, dynamic=False,
                            return_info=True)
    assert n == int(jn) == (1 if case == "identity" else 30)


def test_solves_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.nl_solve_at_cap(_system("nl_L0"), 2)
