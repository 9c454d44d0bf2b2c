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


def source_rows(out_h: int, src_h: int, y0: int, y1: int) -> tuple[int, int]:
    """The source rows [first, last] that output rows [y0, y1) of a resize
    from ``src_h`` to ``out_h`` rows read."""
    if src_h == out_h:
        return y0, y1 - 1
    lo, hi, _ = _axis_weights(out_h, src_h, "cpu")
    return int(lo[y0:y1].min()), int(hi[y0:y1].max())


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    rows: tuple[int, int, int, int] | None = None
                    ) -> torch.Tensor:
    """Resize [H, W, C] (or [H, W], or a batch [B, H, W, C]) to [out_h,
    out_w, C].

    Returns float32 unless the input was uint8 (then rounds back to uint8
    like OpenCV's saturate_cast).  ``rows`` = (src_row0, src_h, y0, y1)
    resizes a band: ``img`` holds source rows [src_row0, ..) of a
    ``src_h``-row image (every row ``source_rows`` names), and the result
    is rows [y0, y1) of the whole resize, bit for bit.
    """
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    src_h, src_w = img.shape[-3], img.shape[-2]
    src_row0, y0, y1 = 0, 0, out_h
    if rows is not None:
        src_row0, src_h, y0, y1 = rows
    x = img.float()

    if src_h != out_h:
        lo, hi, f = (t[y0:y1] for t in _axis_weights(out_h, src_h,
                                                      img.device))
        lo, hi = lo - src_row0, hi - src_row0
        x = (x[..., lo, :, :] * (1.0 - f)[:, None, None]
             + x[..., hi, :, :] * f[:, None, None])
    elif rows is not None:
        x = x[..., y0 - src_row0:y1 - src_row0, :, :]
    if src_w != out_w:
        lo, hi, f = _axis_weights(out_w, src_w, img.device)
        x = (x[..., lo, :] * (1.0 - f)[None, :, None]
             + x[..., hi, :] * f[None, :, None])

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
