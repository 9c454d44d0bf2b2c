"""Edge-aware WLS smoothing of the upsampled (a, b) coefficient maps
(port of ``nct_tpu/solve/wls.py``).

Solves (diag(roughness) + L) x = roughness * x_up for a and b, L the
5-point Laplacian with edge weights lam / (|dL|^alpha + 1e-4), by
multigrid-PCG started from the upsampled coefficients.
"""

from __future__ import annotations

import torch

from nct_tpu_torch.solve.cg import cg_solve
from nct_tpu_torch.solve.nonlocal_solve import (
    gradient_weights, laplacian_apply, make_mg_preconditioner,
)


def roughness_gate(a_up: torch.Tensor, b_up: torch.Tensor,
                   cnt_lab_unit: torch.Tensor) -> torch.Tensor:
    """Data weight: 1.0 where a*src+b stays in [0, 1], else 1e-6.  As in the
    reference, which overwrites the flag per channel, the LAST channel (Lab
    b) alone decides."""
    last = (cnt_lab_unit.float() * a_up + b_up)[..., 2]
    ok = (last >= 0.0) & (last <= 1.0)
    return torch.where(ok, 1.0, 1e-6)


def solve_wls(a_up: torch.Tensor, b_up: torch.Tensor,
              cnt_lab_unit: torch.Tensor, lam: float, alpha: float = 1.2,
              iters: int = 400, tol: float = 1e-6):
    """Smooth (a, b) [H, W, 3] at full resolution with the multigrid
    preconditioner.  ``lam`` includes the area scaling (and the final-level
    boost).  Returns (a, b, iterations run, final ||r||^2)."""
    rough = roughness_gate(a_up, b_up, cnt_lab_unit)[..., None]
    gx, gy = gradient_weights(cnt_lab_unit[..., 0], 1.0, alpha)
    lam32 = torch.tensor(lam, dtype=torch.float32).to(gx.device)
    gx2 = gx * gx * lam32
    gy2 = gy * gy * lam32

    def operator(x):
        a, b = x
        return (rough * a + laplacian_apply(a, gx2, gy2),
                rough * b + laplacian_apply(b, gx2, gy2))

    a0, b0 = a_up.float(), b_up.float()
    precond = make_mg_preconditioner(rough, torch.zeros_like(rough), rough,
                                     gx2, gy2)
    (a, b), r2, n_it = cg_solve(operator, (rough * a0, rough * b0), (a0, b0),
                                iters=iters, tol=tol, preconditioner=precond)
    return a, b, n_it, r2


def apply_transform(a: torch.Tensor, b: torch.Tensor,
                    cnt_lab_unit: torch.Tensor) -> torch.Tensor:
    """out = clamp(a * lab + b, 0, 1)."""
    return torch.clamp(cnt_lab_unit.float() * a + b, 0.0, 1.0)
