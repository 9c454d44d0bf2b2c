"""Parity of the port's ``solve/retune.py`` with nct_tpu's: the capped
nonlocal and WLS solves, the residual curves at the same caps, and the
matcher-free WLS system.

The captured systems are tests/fixtures/nl_L{0,1}.npz; the WLS system is
built from a seeded smooth 48x64 pair (the JAX package's own WLS fence
reads the reference's demo images, absent here).  Tolerances: residuals
rtol 1e-3 at caps <= 10 and the curve's reductions rtol 1e-2 (the CG dot
products reduce in another order, and that drift grows with the cap and
as r2 falls toward the float32 floor); solutions atol 5e-5 (as in
tests/test_torch_solve.py); the WLS start bitwise.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nct_tpu.config import Config as JaxConfig
from nct_tpu.solve import retune as jrt
from nct_tpu_torch import Config
from nct_tpu_torch.solve import cg as tcg
from nct_tpu_torch.solve import retune as trt

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CAPS = (4, 10)
CONVERGED = 24           # a converged reference that keeps the test short


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
