"""SSIM and PSNR (counterpart of ``nct_tpu/utils/ssim.py``).

Standard Wang et al. SSIM: 11x11 Gaussian window (sigma 1.5), K1=0.01,
K2=0.03, L=255, computed per channel in float32 and averaged; the JAX
package holds its outputs to SSIM >= 0.98 against the reference's.  The
valid-mode correlation is ``F.conv2d`` in float32 with TF32 off: the
variance terms E[x^2] - mu^2 need full float32 or SSIM can exceed 1.
It runs on the device of its tensor inputs (numpy arrays: the CPU).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nct_tpu_torch.models.vgg19 import no_tf32


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def _filter2(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Valid-mode 2-D correlation per channel. img: [H, W, C]."""
    x = img.permute(2, 0, 1)[:, None]                 # [C, 1, H, W]
    with no_tf32():
        out = F.conv2d(x, kern[None, None])
    return out[:, 0].permute(1, 2, 0)


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def ssim(a, b, data_range: float = 255.0) -> float:
    """Mean SSIM between two uint8/float [H, W, C] (or [H, W]) images,
    arrays or tensors; computed on ``a``'s device when it is a tensor."""
    device = a.device if isinstance(a, torch.Tensor) else torch.device("cpu")
    a, b = _as_f32(a, device), _as_f32(b, device)
    if a.dim() == 2:
        a, b = a[..., None], b[..., None]
    kern = _gaussian_kernel(device=device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    mu_a = _filter2(a, kern)
    mu_b = _filter2(b, kern)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    s_aa = _filter2(a * a, kern) - mu_aa
    s_bb = _filter2(b * b, kern) - mu_bb
    s_ab = _filter2(a * b, kern) - mu_ab

    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return float(torch.mean(num / den))


def psnr(a, b, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB (float64; inf for equal images)."""
    a, b = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                       np.float64) for x in (a, b))
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))
