"""float32 elementwise functions rounded as the JAX package rounds them.

torch's CPU ``sqrt`` and ``pow`` on float32 are not correctly rounded,
and XLA's are not torch's.  Evaluating in float64 and rounding once to
float32 gives XLA's float32 results on the values the pipeline produces
(for ``pow``, with the exponent first rounded to float32 as XLA holds it).

XLA's CPU backend contracts a product feeding an add into one fused
multiply-add, and evaluates ``exp`` with a Cephes polynomial in such
fused steps; ``fma32``, ``dot3_fma`` and ``exp32`` reproduce those
roundings.  Every step is float64 arithmetic, exact on the card as on the
CPU, so both give the same bits.  ``sum_last`` sums rows in an order that
does not depend on the row count, so that a row band's sums are the whole
grid's on the card too.
"""

from __future__ import annotations

import numpy as np
import torch


# CUDA's reduction splits each output's sum over more threads when there
# are fewer outputs than this (ATen's ``setReduceConfig``: the block holds
# up to 16 outputs a row), so a sum's order would follow the row count
_MIN_ROWS = 16


def sum_last(x: torch.Tensor, dtype: torch.dtype | None = None
             ) -> torch.Tensor:
    """``x.sum(-1, dtype=dtype)`` in an order that does not depend on how
    many rows ``x`` holds: on the card fewer than 16 rows are summed
    padded with zero rows to 16, so a row band of a few pixels (or a tiny
    level) adds each row as the whole grid does.  The CPU's order is per
    row already."""
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if not x.is_cuda or rows == 0 or rows >= _MIN_ROWS:
        return x.sum(-1, dtype=dtype)
    flat = torch.nn.functional.pad(x.reshape(rows, x.shape[-1]),
                                   (0, 0, 0, _MIN_ROWS - rows))
    return flat.sum(-1, dtype=dtype)[:rows].reshape(x.shape[:-1])


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


def pow32(x: torch.Tensor, e: float) -> torch.Tensor:
    """x ** e for x >= 0, with the float32 exponent."""
    return x.double().pow(float(np.float32(e))).float()


def fma32(a, b, c) -> torch.Tensor:
    """Correctly rounded float32 fma(a, b, c) of finite float32 operands.

    The float64 product is exact (48 bits); the float64 sum is rounded to
    odd (its two-sum error decides), so the one rounding to float32 that
    follows is the only one that counts."""
    dev = next(v.device for v in (a, b, c) if isinstance(v, torch.Tensor))
    a, b, c = (torch.as_tensor(v, dtype=torch.float32, device=dev)
               for v in (a, b, c))
    p, cd = torch.broadcast_tensors(a.double() * b.double(), c.double())
    s = p + cd
    t = s - p
    err = (p - (s - t)) + (cd - t)
    bits = s.view(torch.int64)
    to_odd = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    s = torch.where(to_odd, (bits + step).view(torch.float64), s)
    return s.float()


def dot3_fma(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_i x_i y_i over a last axis of 3 as the fused multiply-add chain
    fma(x2, y2, fma(x1, y1, x0 y0)) that XLA's CPU backend emits for a
    3-term dot or sum of products.  Each float64 product is exact (48
    bits); each float64 sum is exact unless the partial sum exceeds the
    product by more than 2^5 (or falls below it by more than 2^29), and
    even then its rounding to float32 differs from ``fma32``'s only when
    the float64 sum lands exactly on a float32 tie.  This is ``fma32``
    without its two-sum correction, a quarter of the cost on the [rows,
    candidates] cross terms of ``knn_graph``."""
    xd, yd = x.double(), y.double()
    t = (xd[..., 0] * yd[..., 0]).float()
    t = torch.addcmul(t.double(), xd[..., 1], yd[..., 1]).float()
    return torch.addcmul(t.double(), xd[..., 2], yd[..., 2]).float()


# XLA's float32 exp (Cephes): clamp, n = floor(x log2(e) + 1/2), a two-step
# Cody-Waite reduction, a degree-5 polynomial, then a scale by 2^n built
# from the exponent bits.  The constants are the float32 values XLA's CPU
# backend holds, written exactly.
_EXP_LO = -87.80000305175781
_EXP_HI = 88.80000305175781
_LOG2E = 1.4426950216293335
_LN2_HI = 0.693359375
_LN2_LO = -0.00021219444170128554
_EXP_POLY = (0.00019875691214110702, 0.001398199936375022,
             0.008333452045917511, 0.04166579619050026, 0.1666666567325592,
             0.5)
_ONE_THIRD = 0.3333333432674408          # float32(1/3)
_F32_TINY = 2.0 ** -126


def exp32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp rounded step by step as XLA's CPU backend computes it
    (results below the normal range flush to zero, as there)."""
    x = torch.clamp(x.float(), _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma32(x, _LOG2E, 0.5)), -127.0, 127.0)
    a = fma32(-_LN2_HI, n, x)
    a = fma32(-_LN2_LO, n, a)
    y = fma32(a, _EXP_POLY[0], _EXP_POLY[1])
    for coef in _EXP_POLY[2:]:
        y = fma32(y, a, coef)
    y = 1.0 + fma32(y, a * a, a)
    out = y * ((n.int() + 127) << 23).view(torch.float32)
    return torch.where(out.abs() < _F32_TINY, 0.0, out)


def knn_weight(d: torch.Tensor) -> torch.Tensor:
    """exp(1 - d / 3) as XLA rounds it: the division becomes a product by
    float32(1/3), contracted with the subtraction, then ``exp32``."""
    return exp32(fma32(-d, _ONE_THIRD, 1.0))
