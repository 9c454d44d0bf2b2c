"""Bilinear resize matching OpenCV ``cv::resize(..., INTER_LINEAR)``.

Port of ``nct_tpu/ops/resize.py``: half-pixel-centre mapping
src = (dst + 0.5) * scale - 0.5, no anti-aliasing on downscale, border
samples replicated, as two separable gathers.  uint8 input is rounded
half-to-even back to uint8, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch


def _axis_weights(dst_n: int, src_n: int, device):
    """Return (lo_idx, hi_idx, hi_frac) tensors of length dst_n."""
    scale = src_n / dst_n
    coords = (torch.arange(dst_n, dtype=torch.float32, device=device)
              + 0.5) * scale - 0.5
    lo = torch.floor(coords)
    frac = coords - lo
    lo_idx = torch.clamp(lo.long(), 0, src_n - 1)
    hi_idx = torch.clamp(lo_idx + 1, 0, src_n - 1)
    # OpenCV clamps the source coordinate, replicating the border sample.
    frac = torch.where(coords < 0, 0.0, frac)
    frac = torch.where(coords > src_n - 1, 0.0, frac)
    return lo_idx, hi_idx, frac


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize [H, W, C] (or [H, W]) to [out_h, out_w, C].

    Returns float32 unless the input was uint8 (then rounds back to uint8
    like OpenCV's saturate_cast).
    """
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    src_h, src_w = img.shape[0], img.shape[1]
    x = img.float()

    if src_h != out_h:
        lo, hi, f = _axis_weights(out_h, src_h, img.device)
        x = x[lo] * (1.0 - f)[:, None, None] + x[hi] * f[:, None, None]
    if src_w != out_w:
        lo, hi, f = _axis_weights(out_w, src_w, img.device)
        x = x[:, lo] * (1.0 - f)[None, :, None] + x[:, hi] * f[None, :, None]

    if img.dtype == torch.uint8:
        x = torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
    if squeeze:
        x = x[..., 0]
    return x


def max_size_resize_dims(h: int, w: int, max_size: int) -> tuple[int, int]:
    """Longer-side cap with the reference's integer math (main.cu:499-522).

    Returns (new_h, new_w); identity if already within max_size.
    """
    if w <= max_size and h <= max_size:
        return h, w
    if w >= h:
        nw = max_size
        nh = int(nw / float(w) * h)
    else:
        nh = max_size
        nw = int(nh / float(h) * w)
    return nh, nw
