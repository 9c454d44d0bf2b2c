"""Debug visualisations (counterpart of ``nct_tpu/utils/vis.py``, the
reference's ENABLE_VIS surface: Config.h:8; ``reconstruct_flow``,
GeneralizedPatchMatch.cu:337-353; ``getHeat``, ColorTransfer.cpp:1128-1177;
the cluster and coefficient views, ColorTransfer.cpp:223-252 and
main.cu:333-421).  Every function takes tensors and returns uint8 BGR
tensors on their device.
"""

from __future__ import annotations

import numpy as np
import torch

# First 64 entries of the reference's 260-colour random list (Config.h:17-52),
# used to paint cluster ids; 0xRRGGBB ints exactly as the reference.
RANDOM_COLOR_LIST = (
    0xFF0000, 0x00FF00, 0x0000FF, 0xFFFF00, 0x00FFFF, 0xFF00FF, 0x9F7262,
    0xD31B4B, 0x48AA9E, 0x42FB40, 0x3F21D8, 0x04B383, 0x188C50, 0xDBF8B0,
    0x9C96EA, 0x39C3C3, 0xBF2688, 0x46CBC8, 0xDD979E, 0xC4DC91, 0x9D161C,
    0x87F9F8, 0x135CB6, 0x5DB6EE, 0xE43484, 0xC8A9E3, 0x269B97, 0xEADA0A,
    0x203BC7, 0xF949DC, 0x115C9E, 0x92723C, 0xE06264, 0xACB122, 0xF9E5B2,
    0x953E82, 0x5BF530, 0x398773, 0xDDEAB2, 0x3EC10A, 0x21D7C8, 0xCB0373,
    0x26E79D, 0xD33755, 0x66FAA7, 0x8DC6AC, 0x5630D8, 0x76BA99, 0x3E2816,
    0xEF8475, 0x9E8B07, 0x036A64, 0x578371, 0x6EE4D4, 0xC21A7E, 0x2D9CDF,
    0x5978EE, 0x09AA85, 0x7FFFA7, 0x5E0D31, 0xFA6354, 0xF7FF00, 0x1BF7D7,
    0x5BC6CA,
)


def flow_image(nnf: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """NNF -> BGR: B = 255*x/bw, G = 0, R = 255*y/bh."""
    x = nnf[..., 0].float()
    y = nnf[..., 1].float()
    b = (255.0 * x / bw).to(torch.uint8)
    r = (255.0 * y / bh).to(torch.uint8)
    return torch.stack([b, torch.zeros_like(b), r], dim=-1)


def heat_image(err: torch.Tensor, vmin: float = 0.0,
               vmax: float = 1.0) -> torch.Tensor:
    """Error map -> BGR heat map, the reference's piecewise jet (getHeat)."""
    v = torch.clamp(err.float(), vmin, vmax)
    v = (v - vmin) / (vmax - vmin)
    w = torch.where

    db = w(v < 0.1242, 0.504 + ((1.0 - 0.504) / 0.1242) * v,
           w(v < 0.3747, 1.0,
             w(v < 0.6253, (0.6253 - v) / (0.6253 - 0.3747), 0.0)))
    dg = w(v < 0.1242, 0.0,
           w(v < 0.3747, (v - 0.1242) / (0.3747 - 0.1242),
             w(v < 0.6253, 1.0,
               w(v < 0.8758, (0.8758 - v) / (0.8758 - 0.6253), 0.0))))
    dr = w(v < 0.3747, 0.0,
           w(v < 0.6253, (v - 0.3747) / (0.6253 - 0.3747),
             w(v < 0.8758, 1.0,
               1.0 - (v - 0.8758) * ((1.0 - 0.504) / (1.0 - 0.8758)))))

    def to_u8(d):
        return torch.clamp((255.0 * d).to(torch.int32), max=255).to(torch.uint8)

    return torch.stack([to_u8(db), to_u8(dg), to_u8(dr)], dim=-1)


def cluster_image(label_map: torch.Tensor) -> torch.Tensor:
    """Label map -> BGR id colours; the reference unpacks r = val % 256,
    g = (val >> 8) % 256, b = (val >> 16) % 256 and stores (r, g, b) as
    BGR."""
    table = np.asarray(RANDOM_COLOR_LIST, dtype=np.uint32)
    rgb = np.stack([table % 256, (table >> 8) % 256, (table >> 16) % 256],
                   axis=-1).astype(np.uint8)
    bgr = torch.from_numpy(rgb).to(label_map.device)
    return bgr[torch.clamp(label_map.long(), 0, len(RANDOM_COLOR_LIST) - 1)]


def coefficient_images(a: torch.Tensor, b: torch.Tensor):
    """(a, b) maps -> visualisations: a*50 and b*255+127, clamped to
    [0, 255]."""
    a_vis = torch.clamp((a * 50.0).to(torch.int32), 0, 255).to(torch.uint8)
    b_vis = torch.clamp((b * 255.0 + 127.0).to(torch.int32), 0,
                        255).to(torch.uint8)
    return a_vis, b_vis
