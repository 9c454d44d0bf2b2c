"""Preconditioned conjugate gradient (port of ``nct_tpu/solve/cg.py``).

Operands are tuples of tensors (the (a, b) coefficient maps).  The loop
stops once ``||r||^2 <= tol^2 ||b||^2`` or after ``iters`` iterations,
the semantics of the JAX package's ``dynamic=True`` while_loop.  The stop
test reads ``||r||^2`` on the host once per iteration: one device sync per
iteration on the card (``tol=0`` runs exactly ``iters`` iterations).
Dot products sum the float32 products in float64 and round once to
float32: the result does not depend on the order of the terms (unless the
float64 sum lies within its own rounding of a float32 halfway point), so
a batch's items, a grid's row bands and the whole grid agree.
``cg_solve_grouped`` runs a batch of independent systems in lockstep with
per-item step sizes and convergence masks, still one sync per iteration.

Over row bands (``band=``, a ``parallel.mesh.RowBand``; every operand one
band's rows) each dot product sums the band and adds the bands' partials
in rank order (``RowBand.reduce_sum``): every rank gets the same bits, so
the stop test takes the same branch everywhere, and no rank waits in a
collective the others skipped.  The sum is not the whole grid's order.
"""

from __future__ import annotations

from typing import Callable

import torch


def _dot(x, y) -> torch.Tensor:
    total = None
    for a, b in zip(x, y):
        s = torch.sum(a.double() * b.double())
        total = s if total is None else total + s
    return total.float()


def _band_dot(band, grouped: bool):
    """The dot of ``cg_solve`` (or, ``grouped``, ``_dot_grouped``) over
    row bands: each leaf's float64 partial, the bands' partials added in
    rank order, then the leaves in order, rounded once."""
    def dot(x, y):
        parts = []
        for a, b in zip(x, y):
            p = (a.double() * b.double()).reshape(
                (a.shape[0], -1) if grouped else (1, -1))
            parts.append(torch.sum(p, dim=1))
        leaves = band.reduce_sum(torch.stack(parts))
        total = leaves[0]
        for leaf in leaves[1:]:
            total = total + leaf
        return (total if grouped else total[0]).float()
    return dot


def cg_solve(operator: Callable, b, x0, iters: int, tol: float = 1e-6,
             preconditioner: Callable | None = None, band=None):
    """Solve operator(x) = b.  Returns (x, final ||r||^2, iterations run).

    operator / preconditioner map tuples of tensors to tuples of tensors
    (operator SPD, preconditioner an approximation of its inverse).
    ``band``: the operands are one band's rows (see the module notes).
    """
    if preconditioner is None:
        preconditioner = lambda r: r  # noqa: E731
    dot = _dot if band is None else _band_dot(band, False)
    x = tuple(x0)
    r = tuple(bi - axi for bi, axi in zip(b, operator(x)))
    p = preconditioner(r)
    rz = dot(r, p)
    threshold = torch.tensor(tol, dtype=torch.float32) ** 2 * dot(b, b)

    n_it = 0
    while n_it < iters and bool(dot(r, r) > threshold):
        ap = operator(p)
        pap = dot(p, ap)
        alpha = rz / torch.where(pap != 0.0, pap, 1.0)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri + (-alpha) * api for ri, api in zip(r, ap))
        z = preconditioner(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz != 0.0, rz, 1.0)
        p = tuple(zi + beta * pi for zi, pi in zip(z, p))
        rz = rz_new
        n_it += 1
    return x, dot(r, r), n_it


def _dot_grouped(x, y) -> torch.Tensor:
    """Per-item dot over leaves whose leading axis is the batch: [B], each
    item's as ``_dot`` sums one system (float64, rounded once)."""
    total = None
    for a, b in zip(x, y):
        s = torch.sum((a.double() * b.double()).reshape(a.shape[0], -1),
                      dim=1)
        total = s if total is None else total + s
    return total.float()


def cg_solve_grouped(operator: Callable, b, x0, iters: int, tol: float = 1e-6,
                     preconditioner: Callable | None = None, band=None):
    """PCG over B independent systems stacked on the leading axis of every
    operand (counterpart of ``nct_tpu/solve/cg.py::cg_solve_grouped``).

    The operator and preconditioner must not mix items.  Each item has its
    own alpha, beta and live mask (``||r_i||^2 > tol^2 ||b_i||^2``), its
    dot products summed as ``cg_solve`` sums them; a dead item's state is
    frozen, so it runs exactly the iterations its own ``cg_solve`` would
    (and, where the operator gives each item its single result, the same
    iterates).  The loop ends when no item is live or after ``iters``
    iterations; its stop test reads the [B] live flags on the host once per
    iteration.  Returns (x, final ||r||^2 [B], iterations run [B] int64).
    ``band``: the operands are one band's rows (see the module notes).
    """
    if preconditioner is None:
        preconditioner = lambda r: r  # noqa: E731
    dot = _dot_grouped if band is None else _band_dot(band, True)

    def expand(v, leaf):
        return v.reshape((-1,) + (1,) * (leaf.dim() - 1))

    x = tuple(x0)
    r = tuple(bi - axi for bi, axi in zip(b, operator(x)))
    p = preconditioner(r)
    rz = dot(r, p)
    threshold = (torch.tensor(tol, dtype=torch.float32) ** 2
                 * dot(b, b))
    n_it = torch.zeros(x[0].shape[0], dtype=torch.int64, device=x[0].device)

    for _ in range(iters):
        live = dot(r, r) > threshold
        if not bool(live.any()):
            break
        ap = operator(p)
        pap = dot(p, ap)
        alpha = rz / torch.where(pap != 0.0, pap, 1.0)
        xn = tuple(xi + expand(alpha, pi) * pi for xi, pi in zip(x, p))
        rn = tuple(ri + expand(-alpha, api) * api for ri, api in zip(r, ap))
        z = preconditioner(rn)
        rz_new = dot(rn, z)
        beta = rz_new / torch.where(rz != 0.0, rz, 1.0)
        pn = tuple(zi + expand(beta, pi) * pi for zi, pi in zip(z, p))

        def keep(new, old):
            return tuple(torch.where(expand(live, o), nw, o)
                         for nw, o in zip(new, old))
        x, r, p = keep(xn, x), keep(rn, r), keep(pn, p)
        rz = torch.where(live, rz_new, rz)
        n_it = n_it + live.long()
    return x, dot(r, r), n_it
