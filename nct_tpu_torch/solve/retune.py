"""Residual-targeted re-derivation of the solver iteration caps (port of
``nct_tpu/solve/retune.py``).

  * :func:`residual_curve` runs a capped solver at each candidate cap plus
    a converged reference and returns per-cap residual reductions and
    solution errors;
  * :func:`recommend_cap` picks the smallest cap meeting a
    residual-reduction target;
  * loaders for captured nonlocal systems (the ``tests/fixtures/nl_L*.npz``
    layout) and matcher-free WLS systems built from an image pair.

The solves at a cap run with ``tol=0``, so each runs exactly ``cap``
iterations (``cg_solve`` stops early only once ``||r||^2`` is exactly 0, as
the JAX package's fixed-trip loop stops counting).  Like the pipeline, the
solves run on ``cuda`` unless given ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from nct_tpu_torch.config import Config
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops.color import bgr_u8_to_lab_u8
from nct_tpu_torch.ops.resize import resize_bilinear
from nct_tpu_torch.pipeline import _resolve_device
from nct_tpu_torch.solve import stats
from nct_tpu_torch.solve.nonlocal_solve import solve_nonlocal
from nct_tpu_torch.solve.wls import solve_wls

# Converged-reference budget: far past the measured knees of the captured
# systems (mg-PCG reaches the f32 floor well under 200 iterations there).
CONVERGED_ITERS = 200

_NL_TENSORS = ("a0", "b0", "src_lab", "ref_lab", "confidence", "nbr_ids",
               "nbr_w")


def load_nl_system(npz_path: str) -> dict:
    """Load one captured nonlocal system (numpy arrays by name)."""
    d = np.load(npz_path)
    return {k: d[k] for k in d.files}


def nl_solve_at_cap(system: dict, cap: int, config: Config | None = None,
                    device: torch.device | str | None = None):
    """Run the pipeline-shaped nonlocal solve capped at ``cap`` iterations
    (``config.nl_precond``, ``nl_in_cap``, ``nl_transpose``).  Returns
    (a, b, r2) as numpy arrays and a float, r2 the final ||r||^2."""
    config = config or Config()
    dev = _resolve_device(device)

    def t(name):
        return torch.from_numpy(np.asarray(system[name])).to(dev)

    a, b, _it, r2 = solve_nonlocal(
        *(t(k) for k in _NL_TENSORS), float(system["norm_factor"]),
        config.local_weight, config.wls_alpha, config.nonlocal_weight,
        iters=cap, tol=0.0, candidates=t("candidates"),
        nbr_slots=t("nbr_slots"), precond_kind=config.nl_precond,
        in_cap=config.nl_in_cap, transpose=config.nl_transpose)
    return a.cpu().numpy(), b.cpu().numpy(), float(r2)


def wls_system_from_image(cnt_bgr: np.ndarray, stl_bgr: np.ndarray,
                          level: int, config: Config | None = None,
                          device: torch.device | str | None = None):
    """The real WLS operator and a realistic start for an image pair at
    pyramid ``level``, without the matcher: the operator depends only on
    the content image and the lam schedule; the start is the patch-moment
    init against the style resized onto the level grid.  Returns
    (a_up, b_up, cnt_lab_unit, lam) with the tensors on ``device``."""
    config = config or Config()
    dev = _resolve_device(device)
    cnt = torch.from_numpy(np.ascontiguousarray(cnt_bgr)).to(dev)
    stl = torch.from_numpy(np.ascontiguousarray(stl_bgr)).to(dev)
    h, w = cnt.shape[:2]
    ah, aw = vgg19.feature_dims(h, w)[config.vgg_layers()[level]]
    cnt_lab_unit = bgr_u8_to_lab_u8(cnt).float() / 255.0
    a_d, b_d = stats.init_ab(
        bgr_u8_to_lab_u8(resize_bilinear(cnt, ah, aw)),
        bgr_u8_to_lab_u8(resize_bilinear(stl, ah, aw)),
        config.patch_size, config.var_epsilon)
    lam = config.wls_lambda_init * (float(h * w) / float(ah * aw))
    if (ah, aw) == (h, w):
        lam *= 4.0
    return (resize_bilinear(a_d, h, w), resize_bilinear(b_d, h, w),
            cnt_lab_unit, lam)


def wls_solve_at_cap(system, cap: int, config: Config | None = None):
    """Capped pipeline-shaped WLS solve (``config.wls_precond``) on the
    system's device; returns (a, b, r2) as numpy arrays and a float."""
    config = config or Config()
    a_up, b_up, cnt_lab_unit, lam = system
    a, b, _it, r2 = solve_wls(a_up, b_up, cnt_lab_unit, lam, config.wls_alpha,
                              iters=cap, tol=0.0,
                              precond_kind=config.wls_precond)
    return a.cpu().numpy(), b.cpu().numpy(), float(r2)


def residual_curve(solve_at_cap, caps,
                   converged_iters: int = CONVERGED_ITERS) -> dict:
    """Measure each cap against the converged solution.

    solve_at_cap: cap -> (a, b, r2).  Returns::

        {"converged": {"iters", "r2", "r2_init"},
         "caps": {cap: {"r2", "reduction", "sol_err"}}}

    ``reduction`` = r2(cap) / r2(cap=0); ``sol_err`` = max-norm error of the
    a-map against the converged solution, relative to the converged a-map's
    max-norm.
    """
    _a0, _b0, r2_init = solve_at_cap(0)
    a_star, _b_star, r2_star = solve_at_cap(converged_iters)
    scale = max(float(np.abs(a_star).max()), 1e-12)
    out = {
        "converged": {"iters": converged_iters, "r2": r2_star,
                      "r2_init": r2_init},
        "caps": {},
    }
    for cap in caps:
        a, _b, r2 = solve_at_cap(cap)
        out["caps"][int(cap)] = {
            "r2": r2,
            "reduction": r2 / max(r2_init, 1e-300),
            "sol_err": float(np.abs(a - a_star).max()) / scale,
        }
    return out


def recommend_cap(curve: dict, target_reduction: float) -> int | None:
    """Smallest measured cap whose residual reduction meets the target
    (None if none does)."""
    for cap in sorted(curve["caps"]):
        if curve["caps"][cap]["reduction"] <= target_reduction:
            return cap
    return None
