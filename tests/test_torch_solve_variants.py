"""Parity of the port's solver variants with nct_tpu: the block-Jacobi
nonlocal preconditioner, the scatter transpose, the pixel-keyed in-edge
tables of graphs without candidate slots, and the Jacobi WLS
preconditioner.

Operators and preconditioners are compared on one random vector; solves
pin their trip counts (tol=0).  Tolerances: operators and preconditioners
within 1e-5 of the output's max magnitude (the same terms summed in another
order), solves as in tests/test_torch_solve.py (CG dot products reduce in
another order).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nct_tpu.solve import nonlocal_solve as jnl
from nct_tpu.solve import wls as jwls
from nct_tpu_torch.solve import nonlocal_solve as tnl
from nct_tpu_torch.solve import wls as twls

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
NL_ARGS = ("src_lab", "ref_lab", "confidence", "nbr_ids", "nbr_w")
OP_TOL = 1e-5        # relative to the output's max magnitude
SOLVE_ATOL = 5e-5


def T(x):
    return torch.tensor(np.asarray(x))


def _fixture(name):
    return dict(np.load(os.path.join(FIXTURES, f"{name}.npz")))


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
