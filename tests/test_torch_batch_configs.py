"""The port's vmap path under every single-card Config: PatchMatch, the
P > 1 merge, block-Jacobi, the scatter transpose, pixel-keyed in-edge
tables and Jacobi WLS, each over a leading batch axis.

Each batched stage is held against ``jax.vmap`` of its JAX stage on
numpy-seeded inputs (bitwise where the inputs make every sum exact, else
with the tolerance of the stage's own parity test) and against per-item
calls of the port (bitwise, on this one CPU thread).  End to end, the
vmap mode is held against the scan mode on 2 pairs for each Config of
``chip_smoke.py`` phase 10, cut to CPU size, with the batch contract of
``tests/test_parallel_batch.py`` and equal solver iteration counts.  No
whole-pipeline JAX vmap runs here: the scan mode is held against JAX in
the pipeline files, and JAX's own vmap against its pairs in
``tests/test_parallel_batch.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nct_tpu.ops import patchmatch as jpm
from nct_tpu.solve import cluster as jcl
from nct_tpu.solve import knn as jknn
from nct_tpu.solve import nonlocal_solve as jnl
from nct_tpu.solve import wls as jwls
from nct_tpu_torch import Config, pipeline
from nct_tpu_torch.models import vgg19 as tvgg
from nct_tpu_torch.ops import patchmatch as tpm
from nct_tpu_torch.solve import cluster as tcl
from nct_tpu_torch.solve import knn as tknn
from nct_tpu_torch.solve import nonlocal_solve as tnl
from nct_tpu_torch.solve import wls as twls
from test_torch_batch import (
    T, _assert_mostly_equal, _integer, _nl_items, _random_nnf,
)

torch.set_num_threads(1)

NL_ARGS = ("a0", "b0", "src_lab", "ref_lab", "confidence", "nbr_ids",
           "nbr_w")
# tests/test_torch_solve_variants.py: solves at pinned iterations
SOLVE_ATOL = 5e-5


# --- PatchMatch --------------------------------------------------------------

def test_patchmatch_batched_vs_vmap_integer(rng):
    """Bitwise on integer features: jax.vmap of JAX's PatchMatch, each item
    drawing its uniforms from its own key, against one batched call fed
    those uniforms; and each item is its own single call."""
    bsz, ha, wa, hb, wb, c, iters, rs = 3, 9, 11, 10, 8, 8, 2, 4
    a = _integer(rng, (bsz, ha, wa, c))
    b = _integer(rng, (bsz, hb, wb, c))
    nnf0 = _random_nnf(rng, bsz, ha, wa, hb, wb)
    keys = jax.random.split(jax.random.PRNGKey(11), bsz)
    jn, jd = jax.jit(jax.vmap(lambda x, y, n, k: jpm.patchmatch(
        x, y, n, k, iters=iters, rs_max=rs)))(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(nnf0), keys)
    n_mags = max(len(jpm.random_search_mags(rs, hb, wb)), 1)
    u = np.stack([np.asarray(jax.random.uniform(
        k, (iters, n_mags, ha, wa, 2), dtype=jnp.float32)) for k in keys])
    tn, td = tpm.patchmatch(T(a), T(b), T(nnf0), T(u), iters=iters,
                            rs_max=rs)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for i in range(bsz):
        one = tpm.patchmatch(T(a[i]), T(b[i]), T(nnf0[i]), T(u[i]),
                             iters=iters, rs_max=rs)
        assert torch.equal(tn[i], one[0]) and torch.equal(td[i], one[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_patchmatch_batched_equals_items_random(rng, dtype):
    """Random features, where sums round: every item bitwise its single
    call (each item's row sums run on their own); a shared start field
    broadcasts; the uniforms' batch shape is checked."""
    bsz, ha, wa, hb, wb, c, iters, rs = 2, 12, 14, 11, 13, 16, 3, 8
    x = rng.standard_normal((bsz, ha, wa, c)).astype(np.float32)
    y = rng.standard_normal((bsz, hb, wb, c)).astype(np.float32)
    a = (T(x) / T(x).norm(dim=-1, keepdim=True)).to(dtype)
    b = (T(y) / T(y).norm(dim=-1, keepdim=True)).to(dtype)
    nnf0 = T(np.zeros((ha, wa, 2), np.int32))
    n_mags = max(len(tpm.random_search_mags(rs, hb, wb)), 1)
    u = torch.rand((bsz, iters, n_mags, ha, wa, 2),
                   generator=torch.Generator().manual_seed(2))
    tn, td = tpm.patchmatch(a, b, nnf0.expand(bsz, ha, wa, 2), u, iters, rs)
    assert tn.shape == (bsz, ha, wa, 2) and td.shape == (bsz, ha, wa)
    for i in range(bsz):
        one = tpm.patchmatch(a[i], b[i], nnf0, u[i], iters, rs)
        assert torch.equal(tn[i], one[0]) and torch.equal(td[i], one[1])
    with pytest.raises(ValueError, match="uniforms"):
        tpm.patchmatch(a, b, nnf0.expand(bsz, ha, wa, 2), u[0], iters, rs)


def test_batch_draws_stack_each_items_patchmatch_uniforms():
    """Item i's uniforms are what GeneratorDraws(seeds[i]) draws at the
    same point of its sequence (k-means, then "ab", "ba", candidates)."""
    seeds = [4, 9]
    draws = pipeline.BatchDraws(seeds)
    singles = [pipeline.GeneratorDraws(s) for s in seeds]
    got_k = draws.kmeans_init(30, 5)
    got_ab = draws.patchmatch_uniforms(0, "ab", (2, 3, 4, 5, 2))
    got_ba = draws.patchmatch_uniforms(0, "ba", (2, 3, 5, 4, 2))
    for i, one in enumerate(singles):
        assert torch.equal(got_k[i], one.kmeans_init(30, 5))
        assert torch.equal(got_ab[i],
                           one.patchmatch_uniforms(0, "ab", (2, 3, 4, 5, 2)))
        assert torch.equal(got_ba[i],
                           one.patchmatch_uniforms(0, "ba", (2, 3, 5, 4, 2)))


# --- the P > 1 merge ---------------------------------------------------------

def test_multi_labels_batched_vs_vmap(rng):
    bsz, k, p = 3, 6, 3
    lm = rng.integers(0, k, (bsz, 7, 9)).astype(np.int32)
    mem = jax.vmap(lambda m: jcl.cluster_membership(m, k))(jnp.asarray(lm))
    for h, w, stride in ((7, 9, 1), (30, 37, 4)):
        ref = jax.jit(jax.vmap(lambda m, mb: jcl.multi_labels_for_pixels(
            m, mb, h, w, stride, p)))(jnp.asarray(lm), mem)
        got = tcl.multi_labels_for_pixels(T(lm), T(mem), h, w, stride, p)
        assert got.shape == (bsz, h, w, p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        for i in range(bsz):
            assert torch.equal(got[i], tcl.multi_labels_for_pixels(
                T(lm[i]), T(mem[i]), h, w, stride, p))


def test_knn_graph_multi_folded_vs_vmap(rng):
    """P = 2 folded into rows: ids, weights and slots bitwise jax.vmap of
    the JAX graph, and each item bitwise its own graph."""
    bsz, h, w, k, m, p = 2, 12, 16, 4, 32, 2
    lab = rng.uniform(0, 1, (bsz, h, w, 3)).astype(np.float32)
    lm = rng.integers(0, k, (bsz, 3, 4)).astype(np.int32)
    mem = jax.vmap(lambda x: jcl.cluster_membership(x, k))(jnp.asarray(lm))
    labels = np.asarray(jax.vmap(lambda x, mb: jcl.multi_labels_for_pixels(
        x, mb, h, w, 4, p))(jnp.asarray(lm), mem))
    cands = rng.integers(0, h * w, (bsz, k, m)).astype(np.int32)
    ref = jax.jit(jax.vmap(lambda l, pl, cd: jknn.knn_graph(
        l, pl, cd, k_num=5)))(
            jnp.asarray(lab), jnp.asarray(labels), jnp.asarray(cands))
    got = tknn.knn_graph(T(lab), T(labels), T(cands), k_num=5, chunk=64)
    for x, r in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(r))
    for i in range(bsz):
        one = tknn.knn_graph(T(lab[i]), T(labels[i]), T(cands[i]), k_num=5)
        for x, y in zip(got, one):
            assert torch.equal(x[i], y)


# --- block-Jacobi, the scatter transpose, pixel-keyed tables -----------------

NL_VARIANTS = {
    "block_jacobi": ({"precond_kind": "block_jacobi"}, True),
    "scatter": ({"precond_kind": "mg", "transpose": "scatter"}, True),
    "pixel_keyed": ({"precond_kind": "block_jacobi"}, False),
}


@pytest.mark.parametrize("variant", list(NL_VARIANTS))
def test_solve_nonlocal_batched_variants(rng, variant):
    """Bitwise each item's own port solve; within SOLVE_ATOL of jax.vmap of
    the JAX solve, with the same (pinned) iteration counts."""
    kw, slots = NL_VARIANTS[variant]
    d, e, nf = _nl_items(rng)
    items = [d, e]
    keys = NL_ARGS + (("candidates", "nbr_slots") if slots else ())
    stacked = {k: np.stack([np.asarray(it[k]) for it in items])
               for k in keys}

    def port(x):
        extra = {k: T(x[k]) for k in keys[len(NL_ARGS):]}
        return tnl.solve_nonlocal(*(T(x[k]) for k in NL_ARGS), nf, iters=8,
                                  tol=0.0, **extra, **kw)

    a, b, its, r2 = port(stacked)
    assert its.tolist() == [8, 8] and r2.shape == (2,)
    for i, item in enumerate(items):
        ai, bi, _, _ = port(item)
        assert torch.equal(a[i], ai) and torch.equal(b[i], bi)

    def jax_one(*xs):
        args = dict(zip(keys, xs))
        extra = {k: args[k] for k in keys[len(NL_ARGS):]}
        return jnl.solve_nonlocal(*(args[k] for k in NL_ARGS), nf, iters=8,
                                  tol=0.0, return_iters=True, **extra, **kw)

    ja, jb, jit, _ = jax.jit(jax.vmap(jax_one))(
        *(jnp.asarray(stacked[k]) for k in keys))
    assert np.asarray(jit).tolist() == [8, 8]
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0,
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0,
                               atol=SOLVE_ATOL)


# --- Jacobi WLS ----------------------------------------------------------------

def test_solve_wls_jacobi_batched_vs_vmap(rng):
    """Iteration counts equal, coefficients rtol 2e-3 / atol 2e-4
    (tests/test_solvers.py); each item bitwise its own solve."""
    bsz, h, w = 3, 24, 32
    a_up = rng.uniform(0.5, 1.5, (bsz, h, w, 3)).astype(np.float32)
    b_up = rng.uniform(-0.2, 0.2, (bsz, h, w, 3)).astype(np.float32)
    cnt = rng.uniform(0, 1, (bsz, h, w, 3)).astype(np.float32)
    lam = 0.4
    av, bv, itv, _ = jax.jit(jax.vmap(lambda a, b, c: jwls.solve_wls(
        a, b, c, lam, iters=12, dynamic=False, return_iters=True,
        precond_kind="jacobi")))(
            jnp.asarray(a_up), jnp.asarray(b_up), jnp.asarray(cnt))
    ta, tb, tit, _ = twls.solve_wls(T(a_up), T(b_up), T(cnt), lam, iters=12,
                                    precond_kind="jacobi")
    assert tit.tolist() == np.asarray(itv).tolist()
    np.testing.assert_allclose(ta.numpy(), np.asarray(av), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(bv), rtol=2e-3,
                               atol=2e-4)
    for i in range(bsz):
        ai, bi, _, _ = twls.solve_wls(T(a_up[i]), T(b_up[i]), T(cnt[i]),
                                      lam, iters=12, precond_kind="jacobi")
        assert torch.equal(ta[i], ai) and torch.equal(tb[i], bi)


# --- end to end: phase 10's Configs, vmap against scan ---------------------

CUT = dict(num_levels=2, kmeans_iters=3, pm_iters=2, pm_iters_fine=2)
PHASE10 = {
    # 10a: exact level 0, PatchMatch above it
    "pm_fine": Config(fine_strategy="patchmatch", exact_nn_levels=1,
                      cg_iters_mg=4, cg_iters_final_mg=3, wls_cg_iters_mg=3,
                      **CUT),
    # 10b: PatchMatch at every level, block-Jacobi at tol 1e-6, mg WLS
    "parity": Config.reference_parity(cg_iters=40, cg_iters_final=30,
                                      wls_cg_iters_mg=6, **CUT),
    # 10c: exact level 0, window refine above, P = 3, scatter, Jacobi WLS
    "variants": Config(knn_memberships=3, nl_transpose="scatter",
                       wls_precond="jacobi", exact_nn_levels=1,
                       cg_iters_mg=4, cg_iters_final_mg=3, wls_cg_iters=12,
                       **CUT),
}


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(4)
    cnt = rng.integers(0, 256, (2, 40, 48, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (2, 44, 52, 3)).astype(np.uint8)
    return tvgg.init_params(), cnt, stl, [5, 9]


@pytest.mark.parametrize("name", list(PHASE10))
def test_phase10_config_vmap_matches_scan(pairs, name):
    """Each item within the batch contract of its scan item, with its
    iteration counts.  Under the parity Config the block-Jacobi solves stop
    early at tol 1e-6, where the grouped CG must freeze each item."""
    model, cnt, stl, seeds = pairs
    config = PHASE10[name]
    out, traces = pipeline.transfer_batch(
        model, cnt, stl, 2.0, config, seeds=seeds, device="cpu",
        return_intermediates="stats")
    assert out.shape == (2, 40, 48, 3) and out.dtype == torch.uint8
    for i, seed in enumerate(seeds):
        ref, ref_trace = pipeline.transfer_pair(
            model, cnt[i], stl[i], 2.0, config, seed=seed, device="cpu",
            return_intermediates="stats")
        _assert_mostly_equal(out[i].numpy(), ref.numpy())
        for key in ("nl_iters", "wls_iters"):
            assert [t[key] for t in traces[i]] == \
                [int(t[key]) for t in ref_trace]
    if name == "parity":
        caps = [config.cg_iters, config.cg_iters_final]
        assert any(t["nl_iters"] < cap for trace in traces
                   for t, cap in zip(trace, caps))
