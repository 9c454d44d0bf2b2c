"""Weight fillers: Caffe FillerParameter semantics on ``torch.Generator``
draws (port of ``nct_tpu/nn/fillers.py``).

Rebuilds include/caffe/filler.hpp (ConstantFiller, UniformFiller,
GaussianFiller, XavierFiller, MSRAFiller, PositiveUnitballFiller,
BilinearFiller) and the FillerParameter message
(src/caffe/proto/caffe.proto:43-62): ``type`` defaults to 'constant',
``variance_norm`` (FAN_IN/FAN_OUT/AVERAGE) scales xavier/msra.

Shapes are Caffe's blob layouts (conv OIHW, InnerProduct (out, in)), so the
default fans are filler.hpp's: fan_in = count/num, fan_out =
count/channels.  Draws come from the caller's generator on the CPU, so a
seed gives the same numbers whatever device the net later runs on; they
differ from the JAX package's ``jax.random`` draws.
"""

from __future__ import annotations

import math

import torch


def fill(generator: torch.Generator, spec: dict | None, shape,
         fan_in: int | None = None, fan_out: int | None = None,
         dtype=torch.float32) -> torch.Tensor:
    """Create one parameter tensor (on the CPU) from a FillerParameter-shaped
    dict.

    ``spec`` is the parsed prototxt message (e.g. ``{'type': 'xavier'}``);
    None or missing 'type' means Caffe's default constant-0 filler.
    ``fan_in``/``fan_out`` default to count/shape[0] and count/shape[1].
    """
    spec = spec or {}
    ftype = str(spec.get("type", "constant"))
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape) if shape else 1
    if fan_in is None:
        fan_in = n // shape[0] if len(shape) >= 2 else n
    if fan_out is None:
        fan_out = n // shape[1] if len(shape) >= 2 else n

    def uniform(lo, hi):
        u = torch.rand(shape, generator=generator, dtype=dtype)
        return lo + (hi - lo) * u

    if ftype == "constant":
        return torch.full(shape, float(spec.get("value", 0.0)), dtype=dtype)
    if ftype == "uniform":
        return uniform(float(spec.get("min", 0.0)), float(spec.get("max", 1.0)))
    if ftype == "gaussian":
        mean = float(spec.get("mean", 0.0))
        std = float(spec.get("std", 1.0))
        return mean + std * torch.randn(shape, generator=generator,
                                        dtype=dtype)
    if ftype in ("xavier", "msra"):
        vn = str(spec.get("variance_norm", "FAN_IN"))
        if vn == "FAN_OUT":
            fan = float(fan_out)
        elif vn == "AVERAGE":
            fan = (fan_in + fan_out) / 2.0
        else:
            fan = float(fan_in)
        if ftype == "xavier":
            scale = math.sqrt(3.0 / fan)
            return uniform(-scale, scale)
        std = math.sqrt(2.0 / fan)
        return std * torch.randn(shape, generator=generator, dtype=dtype)
    if ftype == "positive_unitball":
        # uniform then L1-normalize per output unit (filler.hpp): the
        # count/num values of each unit along axis 0 sum to 1.
        x = uniform(0.0, 1.0)
        flat = x.reshape(shape[0], -1) if len(shape) >= 2 else x[None]
        return (flat / flat.sum(dim=1, keepdim=True)).reshape(shape)
    if ftype == "bilinear":
        # upsampling kernel for Deconvolution (filler.hpp BilinearFiller);
        # the spatial axes are the last two, square.
        k = shape[-1]
        f = math.ceil(k / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        r = torch.arange(k, dtype=dtype)
        w1 = 1.0 - torch.abs(r / f - c)
        return (w1[:, None] * w1[None, :]).expand(shape).clone()
    raise ValueError(f"unknown filler type {ftype!r}")
