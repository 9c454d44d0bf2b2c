"""Preconditioned conjugate gradient (port of ``nct_tpu/solve/cg.py``).

Operands are tuples of tensors (the (a, b) coefficient maps).  The loop
stops once ``||r||^2 <= tol^2 ||b||^2`` or after ``iters`` iterations,
the semantics of the JAX package's ``dynamic=True`` while_loop.  The stop
test reads ``||r||^2`` on the host once per iteration: one device sync per
iteration on the card (``tol=0`` runs exactly ``iters`` iterations).
``cg_solve_grouped`` runs a batch of independent systems in lockstep with
per-item step sizes and convergence masks, still one sync per iteration.
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


# Row stride (floats) of the per-item products in _dot_grouped: rows start
# on 512-byte boundaries, as a tensor of its own does.
_DOT_ROW_ALIGN = 128


def _dot_grouped(x, y) -> torch.Tensor:
    """Per-item dot over leaves whose leading axis is the batch: [B].

    Each item's sum is a full reduction of its own row, the reduction
    ``_dot`` runs on one system, and each row starts on the alignment of a
    tensor of its own: the card's sum kernel peels a misaligned start, so
    a row-wise sum of the [B, L] products, or a sum of a misaligned row,
    adds in another order, and on the card such last-bit differences grew
    into outputs up to 36 LSB away from the item's single pair
    (chip_smoke.py phase 9b).  B small reductions a dot cost little
    beside the V-cycle."""
    total = None
    for a, b in zip(x, y):
        n = a[0].numel()
        rows = torch.empty((a.shape[0], -(-n // _DOT_ROW_ALIGN)
                            * _DOT_ROW_ALIGN), dtype=torch.float32,
                           device=a.device)[:, :n]
        torch.mul(a.float().reshape(-1, n), b.float().reshape(-1, n),
                  out=rows)
        s = torch.stack([torch.sum(p) for p in rows])
        total = s if total is None else total + s
    return total


def cg_solve_grouped(operator: Callable, b, x0, iters: int, tol: float = 1e-6,
                     preconditioner: Callable | None = None):
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
    """
    if preconditioner is None:
        preconditioner = lambda r: r  # noqa: E731

    def expand(v, leaf):
        return v.reshape((-1,) + (1,) * (leaf.dim() - 1))

    x = tuple(x0)
    r = tuple(bi - axi for bi, axi in zip(b, operator(x)))
    p = preconditioner(r)
    rz = _dot_grouped(r, p)
    threshold = (torch.tensor(tol, dtype=torch.float32) ** 2
                 * _dot_grouped(b, b))
    n_it = torch.zeros(x[0].shape[0], dtype=torch.int64, device=x[0].device)

    for _ in range(iters):
        live = _dot_grouped(r, r) > threshold
        if not bool(live.any()):
            break
        ap = operator(p)
        pap = _dot_grouped(p, ap)
        alpha = rz / torch.where(pap != 0.0, pap, 1.0)
        xn = tuple(xi + expand(alpha, pi) * pi for xi, pi in zip(x, p))
        rn = tuple(ri + expand(-alpha, api) * api for ri, api in zip(r, ap))
        z = preconditioner(rn)
        rz_new = _dot_grouped(rn, z)
        beta = rz_new / torch.where(rz != 0.0, rz, 1.0)
        pn = tuple(zi + expand(beta, pi) * pi for zi, pi in zip(z, p))

        def keep(new, old):
            return tuple(torch.where(expand(live, o), nw, o)
                         for nw, o in zip(new, old))
        x, r, p = keep(xn, x), keep(rn, r), keep(pn, p)
        rz = torch.where(live, rz_new, rz)
        n_it = n_it + live.long()
    return x, _dot_grouped(r, r), n_it
