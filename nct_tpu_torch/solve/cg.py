"""Preconditioned conjugate gradient (port of ``nct_tpu/solve/cg.py``).

Operands are tuples of tensors (the (a, b) coefficient maps).  The loop
stops once ``||r||^2 <= tol^2 ||b||^2`` or after ``iters`` iterations,
the semantics of the JAX package's ``dynamic=True`` while_loop.  The stop
test reads ``||r||^2`` on the host once per iteration: one device sync per
iteration on the card (``tol=0`` runs exactly ``iters`` iterations).
"""

from __future__ import annotations

from typing import Callable

import torch


def _dot(x, y) -> torch.Tensor:
    total = None
    for a, b in zip(x, y):
        s = torch.sum(a.float() * b.float())
        total = s if total is None else total + s
    return total


def cg_solve(operator: Callable, b, x0, iters: int, tol: float = 1e-6,
             preconditioner: Callable | None = None):
    """Solve operator(x) = b.  Returns (x, final ||r||^2, iterations run).

    operator / preconditioner map tuples of tensors to tuples of tensors
    (operator SPD, preconditioner an approximation of its inverse).
    """
    if preconditioner is None:
        preconditioner = lambda r: r  # noqa: E731
    x = tuple(x0)
    r = tuple(bi - axi for bi, axi in zip(b, operator(x)))
    p = preconditioner(r)
    rz = _dot(r, p)
    threshold = torch.tensor(tol, dtype=torch.float32) ** 2 * _dot(b, b)

    n_it = 0
    while n_it < iters and bool(_dot(r, r) > threshold):
        ap = operator(p)
        pap = _dot(p, ap)
        alpha = rz / torch.where(pap != 0.0, pap, 1.0)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri + (-alpha) * api for ri, api in zip(r, ap))
        z = preconditioner(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.where(rz != 0.0, rz, 1.0)
        p = tuple(zi + beta * pi for zi, pi in zip(z, p))
        rz = rz_new
        n_it += 1
    return x, _dot(r, r), n_it
