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
