"""BGR <-> CIE Lab conversion with OpenCV uint8 conventions.

Port of ``nct_tpu/ops/color.py``: sRGB gamma, D65 white point and the
0.008856 knee, in float32, with the uint8 Lab encoding (L*255/100, a+128,
b+128) that the pipeline's statistics and solver weights live in.

The fractional powers (2.4, 1/2.4 and the cube root) are evaluated in
float64 with the float32-rounded exponent and rounded back to float32.
That reproduces the JAX package's float32 ``pow``/``cbrt`` bitwise on the
uint8 domain (all 2**24 BGR triples give the same uint8 Lab), where a
float32 ``Tensor.pow`` flips single LSBs of the output.  torch has no
``cbrt``; ``_cbrt`` is the sign-safe cube root built the same way.
"""

from __future__ import annotations

import torch

from nct_tpu_torch.ops.fmath import pow32 as _pow

# D65 RGB->XYZ (linear sRGB primaries), rows X,Y,Z — the matrix OpenCV uses.
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XYZ2RGB = (
    (3.240479, -1.537150, -0.498535),
    (-0.969256, 1.875992, 0.041556),
    (0.055648, -0.204043, 1.057311),
)
_XN = 0.950456
_ZN = 1.088754
_T0 = 0.008856          # CIE knee (6/29)^3
_CBRT_KNEE = 7.787      # (1/3)(29/6)^2
_L_SCALE = 903.3        # (29/3)^3


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    """Sign-safe cube root matching ``jnp.cbrt`` (copysign(|t|^(1/3), t))."""
    return torch.copysign(_pow(t.abs(), 1.0 / 3.0), t)


def _srgb_to_linear(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0.04045, _pow((v + 0.055) / 1.055, 2.4), v / 12.92)


def _linear_to_srgb(v: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(v, min=0.0)
    return torch.where(
        v > 0.0031308, 1.055 * _pow(v, 1.0 / 2.4) - 0.055, v * 12.92)


def _f_cbrt(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _T0, _cbrt(t), _CBRT_KNEE * t + 16.0 / 116.0)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def bgr_u8_to_lab_u8(bgr: torch.Tensor) -> torch.Tensor:
    """uint8 BGR [..., 3] -> uint8 Lab, OpenCV conventions (CV_BGR2Lab)."""
    x = bgr.float() / 255.0
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    rl, gl, bl = _srgb_to_linear(r), _srgb_to_linear(g), _srgb_to_linear(b)

    m = _RGB2XYZ
    X = (m[0][0] * rl + m[0][1] * gl + m[0][2] * bl) / _XN
    Y = m[1][0] * rl + m[1][1] * gl + m[1][2] * bl
    Z = (m[2][0] * rl + m[2][1] * gl + m[2][2] * bl) / _ZN

    fx, fy, fz = _f_cbrt(X), _f_cbrt(Y), _f_cbrt(Z)
    L = torch.where(Y > _T0, 116.0 * _cbrt(Y) - 16.0, _L_SCALE * Y)
    a = 500.0 * (fx - fy) + 128.0
    bb = 200.0 * (fy - fz) + 128.0
    return _to_u8(torch.stack([L * (255.0 / 100.0), a, bb], dim=-1))


def lab_u8_to_bgr_u8(lab: torch.Tensor) -> torch.Tensor:
    """uint8 Lab (OpenCV encoding) -> uint8 BGR (CV_Lab2BGR)."""
    x = lab.float()
    L = x[..., 0] * (100.0 / 255.0)
    a = x[..., 1] - 128.0
    b = x[..., 2] - 128.0

    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def f_inv(f):
        f3 = f * f * f
        return torch.where(f3 > _T0, f3, (f - 16.0 / 116.0) / _CBRT_KNEE)

    Y = torch.where(L > _L_SCALE * _T0, fy * fy * fy, L / _L_SCALE)
    X = f_inv(fx) * _XN
    Z = f_inv(fz) * _ZN

    m = _XYZ2RGB
    rl = m[0][0] * X + m[0][1] * Y + m[0][2] * Z
    gl = m[1][0] * X + m[1][1] * Y + m[1][2] * Z
    bl = m[2][0] * X + m[2][1] * Y + m[2][2] * Z

    r, g, bch = _linear_to_srgb(rl), _linear_to_srgb(gl), _linear_to_srgb(bl)
    return _to_u8(torch.stack([bch, g, r], dim=-1) * 255.0)


def unit_lab_to_bgr_u8(lab_unit: torch.Tensor) -> torch.Tensor:
    """float [0,1] Lab -> uint8 Lab -> uint8 BGR."""
    return lab_u8_to_bgr_u8(_to_u8(lab_unit * 255.0))
