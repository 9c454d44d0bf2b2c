"""VGG-19 feature extractor with Caffe inference semantics (port of
``nct_tpu/models/vgg19.py``).

  * input is float BGR with the per-channel mean (103.939, 116.779, 123.68)
    subtracted;
  * 3x3 convolutions, pad 1, stride 1, plus bias;
  * MAX 2x2/2 pooling in Caffe ceil mode (``F.max_pool2d(ceil_mode=True)``
    clips the border window exactly as the JAX package's -inf-padded
    reduce_window does);
  * taps ("conv5_1".."conv1_1") are post-ReLU, returned [H', W', C] f32.

With ``compute_dtype=torch.bfloat16`` the activations, weights and bias are
rounded to bf16 where the JAX package casts them, and each convolution runs
in float32 on those values: a bf16 x bf16 product is exact in f32, so this
is JAX's ``preferred_element_type=f32`` (an f32 tap from bf16 operands),
where a bf16 ``F.conv2d`` would round its output to bf16.  Convolutions run
with TF32 off (``torch.backends.cudnn.allow_tf32 = False`` for the call),
so float32 means float32 on the card as on the CPU.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (name, out_channels); pools sit between stages.  Full VGG-19 conv body.
VGG19_CONV_LAYERS: tuple[tuple[str, int], ...] = (
    ("conv1_1", 64), ("conv1_2", 64),
    ("conv2_1", 128), ("conv2_2", 128),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512),
)
_POOL_AFTER = {"conv1_2", "conv2_2", "conv3_4", "conv4_4", "conv5_4"}

BGR_MEAN = (103.939, 116.779, 123.68)

# The progressive pipeline's taps, coarse-to-fine.
PIPELINE_TAPS = ("conv5_1", "conv4_1", "conv3_1", "conv2_1", "conv1_1")


def ceil_pool_dim(n: int) -> int:
    """Caffe ceil-mode pooled size for k=2,s=2: ceil(n/2)."""
    return -(-n // 2)


def feature_dims(h: int, w: int) -> dict[str, tuple[int, int]]:
    """(H, W) of every conv tap for an (h, w) input, Caffe ceil-pool rules."""
    dims = {}
    ch, cw = h, w
    for name, _ in VGG19_CONV_LAYERS:
        dims[name] = (ch, cw)
        if name in _POOL_AFTER:
            ch, cw = ceil_pool_dim(ch), ceil_pool_dim(cw)
    return dims


def tap_channels() -> dict[str, int]:
    return {name: c for name, c in VGG19_CONV_LAYERS}


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class VGG19(nn.Module):
    """The VGG-19 conv body (the layers present in ``weights``, which may
    stop early: the body up to conv5_1 suffices for the pipeline)."""

    def __init__(self, weights: dict[str, tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.convs = nn.ModuleDict()
        for name, _ in VGG19_CONV_LAYERS:
            if name not in weights:
                break
            w, b = weights[name]
            conv = nn.Conv2d(w.shape[1], w.shape[0], 3, padding=1)
            with torch.no_grad():
                conv.weight.copy_(w)
                conv.bias.copy_(b)
            self.convs[name] = conv
        self.requires_grad_(False)

    @torch.no_grad()
    def forward(self, bgr_u8: torch.Tensor,
                taps: tuple[str, ...] = PIPELINE_TAPS,
                compute_dtype: torch.dtype = torch.float32
                ) -> dict[str, torch.Tensor]:
        """uint8 BGR [H, W, 3] -> {tap: [H', W', C] float32}."""
        bf16 = compute_dtype == torch.bfloat16

        def rnd(t):
            return t.to(torch.bfloat16).float() if bf16 else t

        needed = set(taps)
        deepest = max(i for i, (name, _) in enumerate(VGG19_CONV_LAYERS)
                      if name in needed)
        mean = torch.tensor(BGR_MEAN, device=bgr_u8.device)
        x = rnd((bgr_u8.float() - mean).permute(2, 0, 1)[None])
        out: dict[str, torch.Tensor] = {}
        with _no_tf32():
            for i, (name, _) in enumerate(VGG19_CONV_LAYERS):
                conv = self.convs[name]
                x = F.conv2d(x, rnd(conv.weight), padding=1)
                x = torch.relu(x + rnd(conv.bias)[None, :, None, None])
                if name in needed:
                    out[name] = x[0].permute(1, 2, 0).contiguous()
                if i == deepest:
                    break
                x = rnd(x)
                if name in _POOL_AFTER:
                    x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        return out


def params_from_numpy(np_params: dict) -> VGG19:
    """The JAX package's {name: {"w": HWIO, "b": [out]}} -> VGG19 (OIHW)."""
    weights = {
        name: (torch.tensor(np.asarray(p["w"], np.float32)
                            ).permute(3, 2, 0, 1).contiguous(),
               torch.tensor(np.asarray(p["b"], np.float32)))
        for name, p in np_params.items()
    }
    return VGG19(weights)


def init_params(generator: torch.Generator | None = None) -> VGG19:
    """Seeded He-init weights (the weight-free fallback backbone).  Draws
    from ``generator`` (default: seed 19); the numbers differ from the JAX
    package's key-19 draw."""
    if generator is None:
        generator = torch.Generator().manual_seed(19)
    weights = {}
    in_c = 3
    for name, out_c in VGG19_CONV_LAYERS:
        w = torch.randn((out_c, in_c, 3, 3), generator=generator)
        weights[name] = (w * np.sqrt(2.0 / (9 * in_c)),
                         torch.zeros(out_c))
        in_c = out_c
    return VGG19(weights)


def load_params(npz_path: str) -> VGG19:
    """Load converted weights: npz with ``<layer>_w`` [3,3,in,out] HWIO and
    ``<layer>_b`` entries (the JAX package's format); truncated files are
    allowed."""
    data = np.load(npz_path)
    params = {}
    for name, out_c in VGG19_CONV_LAYERS:
        wkey, bkey = f"{name}_w", f"{name}_b"
        if wkey not in data:
            break
        if data[wkey].shape[-1] != out_c:
            raise ValueError(f"{name}: expected {out_c} filters, "
                             f"got {data[wkey].shape}")
        params[name] = {"w": data[wkey], "b": data[bkey]}
    return params_from_numpy(params)
