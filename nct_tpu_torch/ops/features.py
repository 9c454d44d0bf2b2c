"""Feature normalization for correspondence search (port of
``nct_tpu/ops/features.py``).  Features are [H, W, C]."""

from __future__ import annotations

import torch

from nct_tpu_torch.ops.fmath import sqrt32


def l2_normalize(feat: torch.Tensor, eps: float = 1e-12):
    """Per-pixel channel L2 normalization.

    Returns (normalized [H,W,C] in feat's dtype, response [H,W]) where
    response is the min-max normalized L2 magnitude.
    """
    f32 = feat.float()
    mag = sqrt32(torch.sum(f32 * f32, dim=-1))
    normalized = (f32 / torch.clamp(mag, min=eps)[..., None]).to(feat.dtype)
    lo, hi = torch.min(mag), torch.max(mag)
    response = (mag - lo) / torch.clamp(hi - lo, min=eps)
    return normalized, response


def cosine_error(a_norm: torch.Tensor, b_norm: torch.Tensor) -> torch.Tensor:
    """Per-pixel matching error ``-<a, b>`` over channels."""
    return -torch.sum(a_norm.float() * b_norm.float(), dim=-1)
