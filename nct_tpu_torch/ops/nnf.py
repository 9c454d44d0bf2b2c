"""Nearest-neighbour-field init and coarse-to-fine upsampling (port of
``nct_tpu/ops/nnf.py``).  An NNF is int32 [H, W, 2] of (x, y) targets."""

from __future__ import annotations

import torch


def _grid(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    return xs.expand(h, w), ys.expand(h, w)


def init_scaled_identity(ah: int, aw: int, bh: int, bw: int,
                         device=None) -> torch.Tensor:
    """Scaled-identity init: bx = min(int(ax/(aw-1)*(bw-1)), bw-1)."""
    xs, ys = _grid(ah, aw, device)
    if aw > 1:
        bx = torch.clamp((xs.float() / (aw - 1) * (bw - 1)).int(), max=bw - 1)
    else:
        bx = torch.zeros_like(xs)
    if ah > 1:
        by = torch.clamp((ys.float() / (ah - 1) * (bh - 1)).int(), max=bh - 1)
    else:
        by = torch.zeros_like(ys)
    return torch.stack([bx, by], dim=-1)


def upsample(nnf_half: torch.Tensor, ah: int, aw: int, bh: int,
             bw: int) -> torch.Tensor:
    """Coarse-to-fine NNF upsampling preserving match offsets scaled by the
    resolution ratio."""
    ah_half, aw_half = nnf_half.shape[0], nnf_half.shape[1]
    aw_ratio = aw / aw_half
    ah_ratio = ah / ah_half

    xs, ys = _grid(ah, aw, nnf_half.device)
    xf, yf = xs.float(), ys.float()
    ax_half = torch.clamp(((xf + 0.5) / aw_ratio).int(), 0, aw_half - 1)
    ay_half = torch.clamp(((yf + 0.5) / ah_ratio).int(), 0, ah_half - 1)

    coarse = nnf_half[ay_half.long(), ax_half.long()]     # [ah, aw, 2]
    bx_half = coarse[..., 0].float()
    by_half = coarse[..., 1].float()

    bx = torch.floor(xf + (bx_half - ax_half.float()) * aw_ratio + 0.5).int()
    by = torch.floor(yf + (by_half - ay_half.float()) * ah_ratio + 0.5).int()
    return torch.stack([torch.clamp(bx, 0, bw - 1),
                        torch.clamp(by, 0, bh - 1)], dim=-1)
