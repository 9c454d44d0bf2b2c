"""Patch helpers shared by the NN search, window refine and BDS vote.

Port of ``patch_offsets`` and ``patchify`` from ``nct_tpu/ops/patchmatch.py``.
The PatchMatch search itself is not ported yet (ROADMAP Queue 1 #13).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def patch_offsets(patch_size: int) -> list[tuple[int, int]]:
    """(dx, dy) taps, dy-major over [-ps/2, ps/2]."""
    half = patch_size // 2
    return [
        (dx, dy)
        for dy in range(-half, patch_size - half)
        for dx in range(-half, patch_size - half)
    ]


def patchify(feat: torch.Tensor, patch_size: int):
    """[H,W,C] -> ([H,W,K,C] zero-padded patch stack, [H,W,K] validity)."""
    h, w, c = feat.shape
    half = patch_size // 2
    padded = F.pad(feat, (0, 0, half, half, half, half))
    mask = F.pad(torch.ones((h, w), dtype=feat.dtype, device=feat.device),
                 (half, half, half, half))
    stack, mstack = [], []
    for dx, dy in patch_offsets(patch_size):
        stack.append(padded[half + dy:half + dy + h, half + dx:half + dx + w])
        mstack.append(mask[half + dy:half + dy + h, half + dx:half + dx + w])
    return torch.stack(stack, dim=2), torch.stack(mstack, dim=2)
