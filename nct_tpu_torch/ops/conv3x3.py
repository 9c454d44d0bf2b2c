"""VGG-19's 3x3, stride-1 float32 convolution plus bias, with a sum order
that does not depend on the tensor's shape.

``conv3x3`` launches the hand-written CUDA kernel ``csrc/conv3x3.cu`` for
CUDA tensors and runs the plain version ``conv3x3_plain`` (``F.conv2d``
with TF32 off) for CPU tensors.  There is no switch and no fallback: on a
CUDA tensor a failed build or launch raises.  The kernel sums each output
as one float32 ``fmaf`` chain over (ci, ky, kx) in ascending order, so a
band of rows convolved on its own gives the whole image's rows bit for bit
(cuDNN picks its algorithm, and so its order, by shape; see
``models/vgg19.py``).  Within float32 rounding of cuDNN's result, not
bitwise it.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from nct_tpu_torch import _build

LAUNCHES = {"conv3x3": 0}


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
    lib.conv3x3_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.conv3x3_launch.restype = i
    lib.conv3x3_occupancy.argtypes = [p]
    lib.conv3x3_occupancy.restype = i
    lib.conv3x3_error_string.argtypes = [i]
    lib.conv3x3_error_string.restype = ctypes.c_char_p
    return lib


def occupancy() -> int:
    """Resident blocks per SM of the kernel on the current card."""
    blocks = ctypes.c_int(0)
    err = _lib().conv3x3_occupancy(ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError("conv3x3 occupancy query failed: "
                           + _lib().conv3x3_error_string(err).decode())
    return blocks.value


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` over rows already padded (width padding 1), TF32 off,
    then the bias: x [N, Cin, H + 2, W] -> [N, Cout, H, W]."""
    with no_tf32():
        out = F.conv2d(x, weight, padding=(0, 1))
    return out + bias[None, :, None, None]


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


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            weight_t: torch.Tensor | None = None) -> torch.Tensor:
    """3x3 stride-1 convolution of x [N, Cin, H + 2, W] (rows padded by
    the caller; columns padded with zeros here) by weight [Cout, Cin, 3, 3]
    (OIHW), plus bias [Cout]: [N, Cout, H, W] float32.  CUDA tensors go
    through the kernel, which reads ``weight_t`` (``kernel_weight(weight)``,
    made here when not given: a caller that convolves with one weight
    again and again keeps it); CPU tensors through ``conv3x3_plain``."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    _check(x, weight, bias, weight_t)
    n, cin, hp, w = x.shape
    cout = weight.shape[0]
    x = x.contiguous()
    wt = kernel_weight(weight) if weight_t is None else weight_t
    bias = bias.contiguous()
    y = torch.empty((n, cout, hp - 2, w), dtype=torch.float32,
                    device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().conv3x3_launch(x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                                y.data_ptr(), n, cin, cout, hp - 2, w, stream)
    if err != 0:
        raise RuntimeError("conv3x3 kernel launch failed: "
                           + _lib().conv3x3_error_string(err).decode())
    LAUNCHES["conv3x3"] += 1
    return y
