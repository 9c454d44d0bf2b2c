"""float32 elementwise functions rounded as the JAX package rounds them.

torch's CPU ``sqrt`` and ``pow`` on float32 are not correctly rounded,
and XLA's are not torch's.  Evaluating in float64 and rounding once to
float32 gives XLA's float32 results on the values the pipeline produces
(for ``pow``, with the exponent first rounded to float32 as XLA holds it).
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


def pow32(x: torch.Tensor, e: float) -> torch.Tensor:
    """x ** e for x >= 0, with the float32 exponent."""
    return x.double().pow(float(np.float32(e))).float()


def dot3_fma(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_i x_i y_i over a last axis of 3 as the fused multiply-add chain
    fma(x2, y2, fma(x1, y1, x0 y0)) that XLA's CPU backend emits for a
    3-term dot or sum of products.  Each step is exact in float64 (the
    float32 product has 48 bits) and rounded once to float32."""
    xd, yd = x.double(), y.double()
    t = (xd[..., 0] * yd[..., 0]).float()
    t = (xd[..., 1] * yd[..., 1] + t.double()).float()
    return (xd[..., 2] * yd[..., 2] + t.double()).float()
