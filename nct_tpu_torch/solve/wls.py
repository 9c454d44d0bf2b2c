"""Edge-aware WLS smoothing of the upsampled (a, b) coefficient maps
(port of ``nct_tpu/solve/wls.py``).

Solves (diag(roughness) + L) x = roughness * x_up for a and b, L the
5-point Laplacian with edge weights lam / (|dL|^alpha + 1e-4), by
PCG started from the upsampled coefficients, preconditioned by the
multigrid V-cycle or by the diagonal (Jacobi).
"""

from __future__ import annotations

import torch

from nct_tpu_torch.solve.cg import cg_solve, cg_solve_grouped
from nct_tpu_torch.solve.nonlocal_solve import (
    gradient_weights, laplacian_apply, laplacian_degree,
    make_mg_preconditioner,
)

PRECOND_KINDS = ("mg", "jacobi")


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
              iters: int = 400, tol: float = 1e-6,
              precond_kind: str = "mg", band=None):
    """Smooth (a, b) [H, W, 3] at full resolution.  ``lam`` includes the
    area scaling (and the final-level boost); ``precond_kind`` is "mg" (the
    V-cycle with zero cross-blocks) or "jacobi" (the diagonal).  Returns
    (a, b, iterations run, final ||r||^2).

    With a leading batch axis ([B, H, W, 3] operands; the counterpart of
    the JAX package's batch fold ``_solve_wls_folded``) every stencil and
    V-cycle op runs once over the bucket, each pair with its own roughness
    gate and gradient weights, and ``cg_solve_grouped`` keeps each pair's
    step sizes: iterations and ||r||^2 are then [B] tensors.

    With ``band`` (a ``parallel.mesh.RowBand``) every operand is one
    band's rows: the gradient weights, the Laplacian, the V-cycle and the
    Jacobi diagonal take one-row halos, and the dot products add over the
    bands in rank order (``solve.cg``)."""
    if precond_kind not in PRECOND_KINDS:
        raise ValueError(f"precond_kind={precond_kind!r}")
    rough = roughness_gate(a_up, b_up, cnt_lab_unit)[..., None]
    gx, gy = gradient_weights(cnt_lab_unit[..., 0], 1.0, alpha, band)
    lam32 = torch.tensor(lam, dtype=torch.float32).to(gx.device)
    gx2 = gx * gx * lam32
    gy2 = gy * gy * lam32

    gy2_ext = gy2 if band is None else band.halo(gy2, 1, 0, dim=-2)[0]
    if band is None:
        def operator(x):
            a, b = x
            return (rough * a + laplacian_apply(a, gx2, gy2),
                    rough * b + laplacian_apply(b, gx2, gy2))
    else:
        def operator(x):
            a, b = x
            # one halo for both: the Laplacian is elementwise over channels
            lap = laplacian_apply(torch.cat([a, b], dim=-1), gx2, gy2_ext,
                                  band)
            c = a.shape[-1]
            return rough * a + lap[..., :c], rough * b + lap[..., c:]

    a0, b0 = a_up.float(), b_up.float()
    if precond_kind == "mg":
        precond = make_mg_preconditioner(rough, torch.zeros_like(rough),
                                         rough, gx2, gy2, band)
    else:
        diag = (rough[..., 0] + laplacian_degree(gx2, gy2_ext,
                                                 band))[..., None]

        def precond(res):
            return (res[0] / diag, res[1] / diag)
    solve = cg_solve_grouped if a_up.dim() == 4 else cg_solve
    (a, b), r2, n_it = solve(operator, (rough * a0, rough * b0), (a0, b0),
                             iters=iters, tol=tol, preconditioner=precond,
                             band=band)
    return a, b, n_it, r2


def apply_transform(a: torch.Tensor, b: torch.Tensor,
                    cnt_lab_unit: torch.Tensor) -> torch.Tensor:
    """out = clamp(a * lab + b, 0, 1)."""
    return torch.clamp(cnt_lab_unit.float() * a + b, 0.0, 1.0)
