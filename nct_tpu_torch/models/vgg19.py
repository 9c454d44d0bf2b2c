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
in float32 on those values through ``F.conv2d``: a bf16 x bf16 product is
exact in f32, so this is JAX's ``preferred_element_type=f32`` (an f32 tap
from bf16 operands), where a bf16 ``F.conv2d`` would round its output to
bf16.  With float32 (the space mesh's rule, ``nct_tpu/parallel/batch.py``)
each convolution goes through ``ops.conv3x3``, with the ReLU after it: on
the card the hand kernel ``csrc/conv3x3.cu``, whose sum order for an
output depends only on (ci, ky, kx) and which applies the ReLU in its
epilogue, on the CPU ``F.conv2d``.  Convolutions run with TF32 off
(``no_tf32``: cuDNN's and cuBLAS's TF32 flags off for the call), so float32
means float32 on the card as on the CPU.

Under a space mesh, ``forward(..., band=)`` runs the body on one band of
the input's rows (``parallel.mesh.RowBand``): each 3x3 convolution takes a
one-row halo from the neighbouring bands (zero rows at the image's edges,
the convolution's own padding), and each pool works on its band alone,
which starts on an even row (the band rule's 16-row units).  A band of
zero rows (a short image over many ranks) convolves and pools nothing but
still serves its neighbours' halos.  In float32 a band's taps are the
whole image's rows bit for bit: on the card by the kernel's
construction, on the CPU with oneDNN off (the plain convolution
gives a row the same bits either way; oneDNN's may round a band's rows
otherwise, within float32 rounding).  A bfloat16 forward stays on
``F.conv2d`` for bands too, where cuDNN may add a band's rows in another
order than the whole image's: its taps are within float32 rounding of the
whole image's, and a row-sharded pair's floor is then the JAX package's
batch contract.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nct_tpu_torch.ops.conv3x3 import conv3x3, kernel_weight, no_tf32

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
        self._kernel_weights: dict[str, tuple] = {}

    def _kernel_weight(self, name: str, weight: torch.Tensor) -> torch.Tensor:
        """``conv3x3``'s layout of a layer's weight, made once for each
        storage and version of the weight (a move to another device or an
        in-place update makes it anew)."""
        key = (weight.device, weight.data_ptr(), weight._version)
        hit = self._kernel_weights.get(name)
        if hit is None or hit[0] != key:
            hit = self._kernel_weights[name] = (key, kernel_weight(weight))
        return hit[1]

    @torch.no_grad()
    def forward(self, bgr_u8: torch.Tensor,
                taps: tuple[str, ...] = PIPELINE_TAPS,
                compute_dtype: torch.dtype = torch.float32,
                band=None) -> dict[str, torch.Tensor]:
        """uint8 BGR [H, W, 3] -> {tap: [H', W', C] float32}.

        A batch [B, H, W, 3] gives [B, H', W', C] taps, each item's
        convolutions run on their own: a batched convolution sums in
        another order, every later stage of a pair reads these taps, and
        so each item keeps its own pair's bits.  The body is
        compute-bound; the batch would save little there.  With ``band``
        (the input grid's ``RowBand``) ``bgr_u8`` holds the band's rows
        and each tap the band's rows of its grid."""
        if bgr_u8.dim() == 4:
            items = [self(x, taps, compute_dtype, band) for x in bgr_u8]
            return {k: torch.stack([t[k] for t in items]) for k in items[0]}
        bf16 = compute_dtype == torch.bfloat16

        def rnd(t):
            return t.to(torch.bfloat16).float() if bf16 else t

        needed = set(taps)
        deepest = max(i for i, (name, _) in enumerate(VGG19_CONV_LAYERS)
                      if name in needed)
        mean = torch.tensor(BGR_MEAN, device=bgr_u8.device)
        x = rnd((bgr_u8.float() - mean).permute(2, 0, 1)[None])
        out: dict[str, torch.Tensor] = {}
        with no_tf32():
            for i, (name, _) in enumerate(VGG19_CONV_LAYERS):
                conv = self.convs[name]
                if band is not None:
                    x, top, bottom = band.halo(x, 1, 1, dim=2)
                if not bf16:
                    # rows padded here (zero rows at the image's edges)
                    pad = (1, 1) if band is None else (1 - top, 1 - bottom)
                    wt = (self._kernel_weight(name, conv.weight)
                          if x.is_cuda else None)
                    # the ReLU in the kernel's epilogue
                    x = conv3x3(F.pad(x, (0, 0) + pad), conv.weight,
                                conv.bias, wt, relu=True)
                elif band is None:
                    x = F.conv2d(x, rnd(conv.weight), padding=1)
                    x = torch.relu(x + rnd(conv.bias)[None, :, None, None])
                elif x.shape[2]:
                    x = F.conv2d(F.pad(x, (0, 0, 1 - top, 1 - bottom)),
                                 rnd(conv.weight), padding=(0, 1))
                    x = torch.relu(x + rnd(conv.bias)[None, :, None, None])
                else:                           # a band of zero rows
                    x = x.new_empty((1, conv.out_channels, 0, x.shape[3]))
                if name in needed:
                    out[name] = x[0].permute(1, 2, 0).contiguous()
                if i == deepest:
                    break
                x = rnd(x)
                if name in _POOL_AFTER:
                    x = (F.max_pool2d(x, 2, 2, ceil_mode=True) if x.shape[2]
                         else x[..., ::2])      # zero rows: only W halves
                    if band is not None:
                        band = band.coarsen()
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
