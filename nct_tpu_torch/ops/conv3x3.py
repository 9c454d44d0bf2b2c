"""VGG-19's 3x3, stride-1 float32 convolution plus bias (and, on request,
the ReLU after it), with a sum order that does not depend on the tensor's
shape.

``conv3x3`` launches the hand-written CUDA kernel ``csrc/conv3x3.cu`` for
CUDA tensors and runs the plain version ``conv3x3_plain`` (``F.conv2d``
with TF32 off) for CPU tensors.  There is no switch and no fallback: on a
CUDA tensor a failed build or launch raises.  The kernel sums each output
as one float32 ``fmaf`` chain over (ci, ky, kx) in ascending order, so a
band of rows convolved on its own gives the whole image's rows bit for bit
(cuDNN picks its algorithm, and so its order, by shape; see
``models/vgg19.py``).  ``conv3x3_chain`` writes that chain out in correctly
rounded steps: the kernel is held bitwise to it at every tile, and within
rtol 1e-5 of cuDNN (it matched cuDNN bit for bit at every VGG-19 layer
tried, which cuDNN does not promise).  The kernel has three tiles
(``CONFIGS``); ``pick_config`` chooses one per launch by a fixed rule.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from nct_tpu_torch import _build
from nct_tpu_torch.ops.fmath import fma32

LAUNCHES = {"conv3x3": 0}


class Tile(NamedTuple):
    """One of the kernel's compile-time tiles (``csrc/conv3x3.cu``): output
    rows x columns x channels of a block, its threads, and the resident
    blocks per SM its launch bounds are built for."""
    rows: int
    cols: int
    channels: int
    threads: int
    min_blocks: int


# csrc/conv3x3.cu's Tile0..Tile2, in its order (the build phase of
# chip_smoke.py checks them against the library's conv3x3_config_info, and
# prints each one's resident blocks on the card)
CONFIGS = (
    Tile(8, 32, 32, 128, 4),    # 2 rows x 4 columns x 8 channels a thread
    Tile(8, 16, 32, 128, 5),    # 1 x 4 x 8
    Tile(8, 16, 16, 128, 6),    # 1 x 4 x 4
)
# Tile 0 is taken when its grid keeps the card's resident slots at least
# this full on average over its waves (a last wave mostly empty idles the
# card); below, the smaller tiles' blocks spread the work more evenly.
FILL_MIN = 0.7
H100_SMS = 132


def grid_blocks(config: int, n: int, h: int, w: int, cout: int) -> int:
    """Blocks of the kernel's grid for tile ``config`` at an [n, cout, h, w]
    output."""
    t = CONFIGS[config]
    return (-(-w // t.cols)) * (-(-h // t.rows)) * n * (-(-cout // t.channels))


def pick_config(n: int, h: int, w: int, cout: int, sms: int = H100_SMS) -> int:
    """The tile for an [n, cout, h, w] output on a card of ``sms`` SMs,
    by a fixed rule (no run-time tuning): tile 0 when its grid, in waves of
    ``sms`` x its resident blocks, fills them to at least ``FILL_MIN`` on
    average (waves / ceil(waves)); else tile 1 when its grid gives every SM
    two blocks at least; else tile 2."""
    waves = grid_blocks(0, n, h, w, cout) / (sms * CONFIGS[0].min_blocks)
    if waves / math.ceil(waves) >= FILL_MIN:
        return 0
    if grid_blocks(1, n, h, w, cout) >= 2 * sms:
        return 1
    return 2


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and products in float32, not TF32."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.conv3x3_launch.restype = i
    lib.conv3x3_configs.argtypes = []
    lib.conv3x3_configs.restype = i
    lib.conv3x3_config_info.argtypes = [i, p]
    lib.conv3x3_config_info.restype = i
    lib.conv3x3_occupancy.argtypes = [i, p]
    lib.conv3x3_occupancy.restype = i
    lib.conv3x3_error_string.argtypes = [i]
    lib.conv3x3_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"conv3x3 {what} failed: "
                           + _lib().conv3x3_error_string(err).decode())


def occupancy(config: int) -> int:
    """Resident blocks per SM of tile ``config`` on the current card."""
    blocks = ctypes.c_int(0)
    _raise_on(_lib().conv3x3_occupancy(config, ctypes.byref(blocks)),
              "occupancy query")
    return blocks.value


def library_configs() -> list[dict]:
    """The tiles as the built library states them."""
    out = []
    for i in range(_lib().conv3x3_configs()):
        v = (ctypes.c_int * 7)()
        _raise_on(_lib().conv3x3_config_info(i, v), "config query")
        out.append(dict(zip(("threads", "rows", "cols", "channels", "stages",
                             "smem", "min_blocks"), list(v))))
    return out


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """``F.conv2d`` over rows already padded (width padding 1), TF32 off,
    then the bias (and ``torch.relu``): x [N, Cin, H + 2, W] ->
    [N, Cout, H, W]."""
    with no_tf32():
        out = F.conv2d(x, weight, padding=(0, 1))
    out = out + bias[None, :, None, None]
    return torch.relu(out) if relu else out


def conv3x3_chain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  relu: bool = False) -> torch.Tensor:
    """The kernel's sum, written out: for each output, acc = 0, then
    acc = fma(w[co, ci, ky, kx], x[ci, y + ky, x + kx - 1], acc) over
    (ci, ky, kx) ascending, each step the correctly rounded float32 fma
    (``fmath.fma32``), then acc + bias (and ``torch.relu``).  Bit for bit
    the kernel's result on the CPU or the card; 9 Cin whole-tensor steps,
    so for tests and checks only.  x [N, Cin, H + 2, W] (rows padded),
    weight [Cout, Cin, 3, 3] -> [N, Cout, H, W]."""
    n, cin, hp, w = x.shape
    h = hp - 2
    xp = F.pad(x.float(), (1, 1))
    acc = torch.zeros((n, weight.shape[0], h, w), dtype=torch.float32,
                      device=x.device)
    for ci in range(cin):
        for ky in range(3):
            for kx in range(3):
                acc = fma32(weight[:, ci, ky, kx][None, :, None, None],
                            xp[:, ci, None, ky:ky + h, kx:kx + w], acc)
    out = acc + bias[None, :, None, None]
    return torch.relu(out) if relu else out


def kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """The kernel's layout of an OIHW weight: [Cin, 3, 3, Cout]."""
    return weight.permute(1, 2, 3, 0).contiguous()


def _check(x, weight, bias, weight_t) -> None:
    if x.dim() != 4 or x.dtype != torch.float32 or x.shape[2] < 3:
        raise ValueError(f"x: expected float32 [N, Cin, H + 2, W], got "
                         f"{x.dtype} {tuple(x.shape)}")
    cout, cin = weight.shape[0], x.shape[1]
    if (tuple(weight.shape) != (cout, cin, 3, 3)
            or weight.dtype != torch.float32):
        raise ValueError(f"weight: expected float32 [Cout, {cin}, 3, 3], got "
                         f"{weight.dtype} {tuple(weight.shape)}")
    if tuple(bias.shape) != (cout,) or bias.dtype != torch.float32:
        raise ValueError(f"bias: expected float32 [{cout}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if weight_t is not None and (
            tuple(weight_t.shape) != (cin, 3, 3, cout)
            or weight_t.dtype != torch.float32
            or not weight_t.is_contiguous()):
        raise ValueError(f"weight_t: expected contiguous float32 [{cin}, 3, "
                         f"3, {cout}], got {weight_t.dtype} "
                         f"{tuple(weight_t.shape)}")
    dev = x.device
    if (dev.type != "cuda" or weight.device != dev or bias.device != dev
            or (weight_t is not None and weight_t.device != dev)):
        raise ValueError("conv3x3 needs x, weight and bias on one CUDA device")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            weight_t: torch.Tensor | None = None, relu: bool = False,
            config: int | None = None) -> torch.Tensor:
    """3x3 stride-1 convolution of x [N, Cin, H + 2, W] (rows padded by
    the caller; columns padded with zeros here) by weight [Cout, Cin, 3, 3]
    (OIHW), plus bias [Cout], then ``max(., 0)`` with ``relu``:
    [N, Cout, H, W] float32.  CUDA tensors go through the kernel, which
    reads ``weight_t`` (``kernel_weight(weight)``, made here when not
    given: a caller that convolves with one weight again and again keeps
    it) with the tile ``pick_config`` chooses (``config`` forces one: the
    tests run every tile); CPU tensors through ``conv3x3_plain``.  Zero
    output rows (H = 0: a row band that holds none) give an empty result
    and launch nothing."""
    n, hp, w = x.shape[0], x.shape[-2], x.shape[-1]
    cout = weight.shape[0]
    if x.dim() == 4 and hp == 2:
        # a band of zero rows (its two padding rows only): nothing to
        # convolve, and nothing is launched
        return x.new_empty((n, cout, 0, w), dtype=torch.float32)
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, relu)
    _check(x, weight, bias, weight_t)
    cin = x.shape[1]
    if config is None:
        config = pick_config(n, hp - 2, w, cout, _sms(x.device.index or 0))
    elif not 0 <= config < len(CONFIGS):
        raise ValueError(f"config: expected 0..{len(CONFIGS) - 1}, got "
                         f"{config}")
    x = x.contiguous()
    wt = kernel_weight(weight) if weight_t is None else weight_t
    bias = bias.contiguous()
    y = torch.empty((n, cout, hp - 2, w), dtype=torch.float32,
                    device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(_lib().conv3x3_launch(x.data_ptr(), wt.data_ptr(),
                                    bias.data_ptr(), y.data_ptr(), n, cin,
                                    cout, hp - 2, w, int(relu), config,
                                    stream), "kernel launch")
    LAUNCHES["conv3x3"] += 1
    return y
