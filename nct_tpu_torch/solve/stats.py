"""Patch statistics and the initial per-pixel linear colour transform
(port of ``nct_tpu/solve/stats.py``).

Statistics are over uint8-scale Lab values (0..255): a = sigma_ref /
(sigma_src + eps), b = (mu_ref - a * mu_src) / 255, from 2-D integral
images.  The integral of squared values exceeds float32's exact-integer
range, so its rounding depends on the order of the prefix sums; ``_cumsum``
adds in the order the JAX package's ``jnp.cumsum`` does off the TPU, so
the CPU results agree bitwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nct_tpu_torch.ops.fmath import sqrt32


_SCAN_BLOCK = 16


def _seq_cumsum0(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 prefix sum along dim 0 (torch.cumsum may
    accumulate in float64 or in a parallel order)."""
    out = torch.empty_like(x)
    acc = x[0]
    out[0] = acc
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
        out[i] = acc
    return out


def _scan0(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        return _seq_cumsum0(x)
    nb = -(-n // _SCAN_BLOCK)
    pad = x.new_zeros((nb * _SCAN_BLOCK - n,) + x.shape[1:])
    blocks = torch.cat([x, pad]).reshape((nb, _SCAN_BLOCK) + x.shape[1:])
    inner = _seq_cumsum0(blocks.movedim(1, 0)).movedim(0, 1)
    carry = _scan0(inner[:, -1])
    carry = torch.cat([torch.zeros_like(carry[:1]), carry[:-1]])
    return (inner + carry[:, None]).reshape((nb * _SCAN_BLOCK,)
                                            + x.shape[1:])[:n]


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sum in the order XLA runs ``jnp.cumsum``
    outside the TPU: sequential within blocks of 16, block totals scanned
    the same way recursively and added back."""
    return _scan0(x.movedim(dim, 0)).movedim(0, dim)


def _integral(img: torch.Tensor) -> torch.Tensor:
    """Zero-padded 2-D integral image of img [..., H, W, C]: I[y, x] = sum
    img[:y, :x]."""
    s = _cumsum(_cumsum(img.float(), -3), -2)
    return F.pad(s, (0, 0, 1, 0, 1, 0))


def window_sums(img: torch.Tensor, patch_size: int):
    """Clipped-window sums and counts for every pixel of img [..., H, W,
    C] (leading axes are a batch).  Returns (sums [..., H, W, C] f32,
    counts [H, W] f32)."""
    h, w = img.shape[-3], img.shape[-2]
    half = patch_size // 2
    left = -half
    right = patch_size + left
    dev = img.device

    integ = _integral(img)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    sy = torch.clamp(ys + left, min=0)
    ey = torch.clamp(ys + right, max=h)
    sx = torch.clamp(xs + left, min=0)
    ex = torch.clamp(xs + right, max=w)

    a = integ[..., ey[:, None], ex[None, :], :]
    b = integ[..., ey[:, None], sx[None, :], :]
    c = integ[..., sy[:, None], ex[None, :], :]
    d = integ[..., sy[:, None], sx[None, :], :]
    sums = a - b - c + d
    counts = (ey - sy).float()[:, None] * (ex - sx).float()[None, :]
    return sums, counts


def patch_moments(img_u8: torch.Tensor, patch_size: int):
    """Per-pixel patch mean and std of a uint8 image, 0..255 domain."""
    x = img_u8.float()
    sums, counts = window_sums(x, patch_size)
    sums2, _ = window_sums(x * x, patch_size)
    mean = sums / counts[..., None]
    var = torch.clamp(sums2 / counts[..., None] - mean * mean, min=0.0)
    return mean, sqrt32(var)


def init_ab(cnt_lab_u8: torch.Tensor, guide_lab_u8: torch.Tensor,
            patch_size: int = 3, var_epsilon: float = 0.6):
    """Initial (a [H,W,3], b [H,W,3]) from patch moments of the content and
    the BDS guidance (uint8-scale Lab on the same grid; a leading batch
    axis passes through)."""
    mu_s, sd_s = patch_moments(cnt_lab_u8, patch_size)
    mu_r, sd_r = patch_moments(guide_lab_u8, patch_size)
    a = sd_r / (sd_s + var_epsilon)
    b = (mu_r - mu_s * a) / 255.0
    return a, b


def error_confidence(err: torch.Tensor, band=None) -> torch.Tensor:
    """BDS feature error [..., H, W] -> data-term confidence
    max(1 - minmax(err), 1e-6), the min and max taken per item (over
    every band of ``band``'s axis when ``err`` is one band's rows)."""
    if err.numel():
        lo = torch.amin(err, dim=(-2, -1), keepdim=True)
        hi = torch.amax(err, dim=(-2, -1), keepdim=True)
    else:                               # a band of zero rows
        lo = err.new_full(err.shape[:-2] + (1, 1), float("inf"))
        hi = -lo
    if band is not None:
        lo, hi = band.reduce(lo, "min"), band.reduce(hi, "max")
    e = (err - lo) / torch.clamp(hi - lo, min=1e-30)
    return torch.clamp(1.0 - e, min=1e-6)
