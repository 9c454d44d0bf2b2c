"""Feature normalization for correspondence search (port of
``nct_tpu/ops/features.py``).  Features are [H, W, C], or [B, H, W, C]
for a batch."""

from __future__ import annotations

import torch

from nct_tpu_torch.ops.fmath import sqrt32, sum_last


def l2_normalize(feat: torch.Tensor, eps: float = 1e-12):
    """Per-pixel channel L2 normalization.

    Returns (normalized [H,W,C] in feat's dtype, response [H,W]) where
    response is the min-max normalized L2 magnitude (per item of a batch).
    """
    f32 = feat.float()
    mag = sqrt32(sum_last(f32 * f32))
    normalized = (f32 / torch.clamp(mag, min=eps)[..., None]).to(feat.dtype)
    if not mag.numel():                 # a row band of zero rows
        return normalized, mag
    lo = torch.amin(mag, dim=(-2, -1), keepdim=True)
    hi = torch.amax(mag, dim=(-2, -1), keepdim=True)
    response = (mag - lo) / torch.clamp(hi - lo, min=eps)
    return normalized, response


def cosine_error(a_norm: torch.Tensor, b_norm: torch.Tensor) -> torch.Tensor:
    """Per-pixel matching error ``-<a, b>`` over channels."""
    return -sum_last(a_norm.float() * b_norm.float())
