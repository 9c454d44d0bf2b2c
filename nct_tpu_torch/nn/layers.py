"""Layer op library + registry (port of ``nct_tpu/nn/layers.py``).

The PyTorch counterpart of Caffe's layer zoo and factory (reference:
include/caffe/layer.hpp, src/caffe/layer_factory.cpp:42-90,
src/caffe/layers/*).  Each op is a function
``fn(params, layer_cfg, *bottoms) -> tops`` over **NCHW** tensors, Caffe's
own layout, so prototxt axis fields apply as written and ``Flatten`` /
``InnerProduct`` flatten in Caffe's (c, h, w) order.  Weights keep Caffe's
blob layouts: Convolution OIHW, InnerProduct (out, in), Deconvolution
(C_in, C_out/g, kh, kw).  Register custom layers with
``@register_layer("MyType")``.

Products run in float32.  For a bfloat16 (or float16) input the weights
are rounded to the input's dtype and the product runs in float32 on those
values, then rounds back: the JAX package's ``preferred_element_type=f32``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

LAYER_REGISTRY: dict[str, Callable] = {}


def register_layer(name: str):
    def deco(fn):
        LAYER_REGISTRY[name] = fn
        return fn
    return deco


def _int(v, default=None):
    if v is None:
        return default
    if isinstance(v, list):
        v = v[0]
    return int(v)


def _pool_out(n: int, k: int, s: int, p: int) -> int:
    """Caffe ceil-mode pooled size (pooling_layer.cpp Reshape), including
    the padded-mode clip: the last window must start strictly inside the
    image + left pad."""
    out = max(-(-(n + 2 * p - k) // s) + 1, 1)
    if p and (out - 1) * s >= n + p:
        out -= 1
    return out


def _axis(axis, ndim: int) -> int:
    """Caffe's CanonicalAxisIndex: a negative axis counts from the end."""
    axis = int(axis)
    return axis + ndim if axis < 0 else axis


def channel_view(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast along axis 1 of ``x``."""
    return v.reshape([1, -1] + [1] * (x.dim() - 2))


def _f32_operands(x: torch.Tensor, w: torch.Tensor):
    """(x, w) for a float32 product: w rounded to x's dtype first."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return x, w
    return x.float(), w.float()


def _bias_out(out: torch.Tensor, params, dtype) -> torch.Tensor:
    if "b" in params:
        out = out + channel_view(params["b"].float(), out)
    return out.to(dtype)


@register_layer("Convolution")
def conv_layer(params, cfg, x):
    cp = cfg.get("convolution_param", {})
    xf, w = _f32_operands(x, params["w"])        # OIHW
    out = F.conv2d(xf, w, stride=_int(cp.get("stride"), 1),
                   padding=_int(cp.get("pad"), 0),
                   dilation=_int(cp.get("dilation"), 1),
                   groups=_int(cp.get("group"), 1))
    return _bias_out(out, params, x.dtype)


@register_layer("InnerProduct")
def inner_product_layer(params, cfg, x):
    xf, w = _f32_operands(x.reshape(x.shape[0], -1), params["w"])  # (out, in)
    return _bias_out(F.linear(xf, w), params, x.dtype)


@register_layer("ReLU")
def relu_layer(params, cfg, x):
    slope = cfg.get("relu_param", {}).get("negative_slope", 0.0)
    if slope:
        return torch.where(x > 0, x, x * slope)
    return torch.relu(x)


@register_layer("Sigmoid")
def sigmoid_layer(params, cfg, x):
    return torch.sigmoid(x)


@register_layer("TanH")
def tanh_layer(params, cfg, x):
    return torch.tanh(x)


@register_layer("Pooling")
def pooling_layer(params, cfg, x):
    """Caffe pooling (pooling_layer.cpp): ceil-mode output size with the
    padded clip, and the window built explicitly: the input is padded by
    ``pad`` on the left and by what the last window needs on the right
    (-inf for MAX, 0 for AVE), then pooled with no implicit padding.
    PyTorch's own ``ceil_mode`` drops a last window by another test, and
    ``count_include_pad`` cannot give Caffe's AVE divisor at the overhang."""
    pp = cfg.get("pooling_param", {})
    method = str(pp.get("pool", "MAX")).upper()
    h, w = x.shape[2], x.shape[3]
    # rectangular *_h/*_w fields override the square ones
    # (pooling_layer.cpp LayerSetUp)
    if pp.get("global_pooling") in (True, "true"):
        k_h, k_w = h, w
        s_h = s_w = 1
    else:
        k = _int(pp.get("kernel_size"), 2)
        k_h = _int(pp.get("kernel_h"), k)
        k_w = _int(pp.get("kernel_w"), k)
        s = _int(pp.get("stride"), 1)
        s_h = _int(pp.get("stride_h"), s)
        s_w = _int(pp.get("stride_w"), s)
    pad = _int(pp.get("pad"), 0)
    p_h = _int(pp.get("pad_h"), pad)
    p_w = _int(pp.get("pad_w"), pad)
    oh = _pool_out(h, k_h, s_h, p_h)
    ow = _pool_out(w, k_w, s_w, p_w)
    extra_h = max((oh - 1) * s_h + k_h - h - p_h, 0)
    extra_w = max((ow - 1) * s_w + k_w - w - p_w, 0)
    if method == "AVE":
        xp = F.pad(x, (p_w, extra_w, p_h, extra_h))
        summed = F.avg_pool2d(xp, (k_h, k_w), (s_h, s_w), divisor_override=1)
        # Caffe's AVE divisor counts PADDING cells: pool_size =
        # (hend - hstart) * (wend - wstart) with hend clipped at
        # height + pad BEFORE the [0, height) clip (pooling_layer.cpp:
        # 197-212) — border windows divide by the padded window area.
        def count(n_out, k, s, p, dim):
            start = torch.arange(n_out, dtype=torch.float32,
                                 device=x.device) * s - p
            return torch.clamp(start + k, max=dim + p) - start
        area = count(oh, k_h, s_h, p_h, h)[:, None] * count(ow, k_w, s_w,
                                                            p_w, w)[None, :]
        return summed / area.to(summed.dtype)
    xp = F.pad(x, (p_w, extra_w, p_h, extra_h), value=float("-inf"))
    return F.max_pool2d(xp, (k_h, k_w), (s_h, s_w))


@register_layer("Softmax")
def softmax_layer(params, cfg, x):
    axis = cfg.get("softmax_param", {}).get("axis", 1)
    return torch.softmax(x, dim=_axis(axis, x.dim()))


@register_layer("Dropout")
def dropout_layer(params, cfg, x):
    """TEST phase is identity; TRAIN phase (the Net passes the caller's
    ``torch.Generator``, on any device, as ``__generator__``) applies the
    inverted-scale Bernoulli mask of dropout_layer.cpp: keep with prob
    1-ratio, scale kept values by 1/(1-ratio).  With ``__shard__ = (i,
    n)`` the mask is drawn for n row blocks and block i is taken (one data
    rank's share of the whole batch's mask)."""
    gen = params.get("__generator__")
    if gen is None:
        return x
    ratio = float(cfg.get("dropout_param", {}).get("dropout_ratio", 0.5))
    keep = 1.0 - ratio
    i, n = params.get("__shard__") or (0, 1)
    rows = x.shape[0]
    # drawn on the generator's device, so a CPU generator gives a card
    # the CPU's masks
    mask = (torch.rand((n * rows, *x.shape[1:]), generator=gen,
                       device=gen.device)[i * rows:(i + 1) * rows]
            < keep).to(x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


@register_layer("LRN")
def lrn_layer(params, cfg, x):
    """lrn_layer.cpp.  ACROSS_CHANNELS is the classic AlexNet response
    norm over the channel axis (the window of channel c is [c - size//2,
    c - size//2 + size), as in the JAX package; Caffe's own pre-pad is
    (size-1)/2, the same for the odd sizes deploy nets use);
    WITHIN_CHANNEL is the spatial variant the reference composes from
    square -> AVE-pool -> power -> product (lrn_layer.cpp:17-66)."""
    lp = cfg.get("lrn_param", {})
    local_size = _int(lp.get("local_size"), 5)
    alpha = float(lp.get("alpha", 1.0))
    beta = float(lp.get("beta", 0.75))
    half = local_size // 2
    region = str(lp.get("norm_region", "ACROSS_CHANNELS")).upper()
    if region == "WITHIN_CHANNEL":
        pooled = pooling_layer(
            {},
            {"pooling_param": {"pool": "AVE", "kernel_size": local_size,
                               "stride": 1, "pad": half}},
            x * x,
        )
        return x * (1.0 + alpha * pooled) ** (-beta)
    c = x.shape[1]
    sq = F.pad((x * x).transpose(1, -1), (half, half)).transpose(1, -1)
    acc = torch.zeros_like(x)
    for i in range(local_size):
        acc = acc + sq.narrow(1, i, c)
    return x * (1.0 + (alpha / local_size) * acc) ** (-beta)


@register_layer("Concat")
def concat_layer(params, cfg, *xs):
    axis = cfg.get("concat_param", {}).get("axis", 1)
    return torch.cat(xs, dim=_axis(axis, xs[0].dim()))


@register_layer("Eltwise")
def eltwise_layer(params, cfg, *xs):
    op = str(cfg.get("eltwise_param", {}).get("operation", "SUM")).upper()
    out = xs[0]
    for other in xs[1:]:
        if op == "PROD":
            out = out * other
        elif op == "MAX":
            out = torch.maximum(out, other)
        else:
            out = out + other
    return out


@register_layer("BatchNorm")
def batchnorm_layer(params, cfg, x):
    eps = float(cfg.get("batch_norm_param", {}).get("eps", 1e-5))
    scale = params.get("scale_factor")
    scale = (torch.ones((), device=x.device) if scale is None
             else scale.float())
    inv = 1.0 / torch.clamp(scale, min=1e-30)
    mean = channel_view(params["mean"] * inv, x)
    var = channel_view(params["var"] * inv, x)
    return (x - mean) * torch.rsqrt(var + eps)


@register_layer("Scale")
def scale_layer(params, cfg, x):
    out = x * channel_view(params["w"], x)
    if "b" in params:
        out = out + channel_view(params["b"], x)
    return out


@register_layer("Flatten")
def flatten_layer(params, cfg, x):
    return x.reshape(x.shape[0], -1)


@register_layer("Input")
def input_layer(params, cfg, x):
    return x


# --- elementwise / activation vocabulary (src/caffe/layers/*) -----------

@register_layer("Power")
def power_layer(params, cfg, x):
    pp = cfg.get("power_param", {})
    power = float(pp.get("power", 1.0))
    scale = float(pp.get("scale", 1.0))
    shift = float(pp.get("shift", 0.0))
    base = shift + scale * x
    if power == 1.0:
        return base
    return torch.pow(base, power)


@register_layer("Exp")
def exp_layer(params, cfg, x):
    ep = cfg.get("exp_param", {})
    base = float(ep.get("base", -1.0))
    inner = float(ep.get("shift", 0.0)) + float(ep.get("scale", 1.0)) * x
    if base == -1.0:            # Caffe sentinel for e
        return torch.exp(inner)
    return torch.pow(base, inner)


@register_layer("Log")
def log_layer(params, cfg, x):
    lp = cfg.get("log_param", {})
    base = float(lp.get("base", -1.0))
    out = torch.log(float(lp.get("shift", 0.0))
                    + float(lp.get("scale", 1.0)) * x)
    if base != -1.0:
        out = out / math.log(base)
    return out


@register_layer("AbsVal")
def absval_layer(params, cfg, x):
    return torch.abs(x)


@register_layer("BNLL")
def bnll_layer(params, cfg, x):
    # log(1 + exp(x)), computed stably as in bnll_layer.cpp
    return torch.where(x > 0, x + torch.log1p(torch.exp(-x)),
                       torch.log1p(torch.exp(x)))


@register_layer("ELU")
def elu_layer(params, cfg, x):
    alpha = float(cfg.get("elu_param", {}).get("alpha", 1.0))
    return torch.where(x > 0, x,
                       alpha * (torch.exp(torch.clamp(x, max=0)) - 1.0))


@register_layer("PReLU")
def prelu_layer(params, cfg, x):
    """Channel-wise learned slope (prelu_layer.cpp) along axis 1
    (channel_shared => a one-element blob)."""
    slope = params.get("w", params.get("0"))
    if slope is None:
        slope = torch.tensor(0.25, dtype=x.dtype, device=x.device)
    slope = slope.reshape(-1)
    slope = slope[0] if slope.numel() == 1 else channel_view(slope, x)
    return torch.where(x > 0, x, x * slope)


@register_layer("Threshold")
def threshold_layer(params, cfg, x):
    t = float(cfg.get("threshold_param", {}).get("threshold", 0.0))
    return (x > t).to(x.dtype)


@register_layer("Bias")
def bias_layer(params, cfg, x, *rest):
    """Adds a per-channel bias along axis 1 — learned blob or second
    bottom (bias_layer.cpp)."""
    b = rest[0] if rest else params.get("b", params.get("0"))
    return x + channel_view(b.reshape(-1), x)


@register_layer("MVN")
def mvn_layer(params, cfg, x):
    mp = cfg.get("mvn_param", {})
    across = mp.get("across_channels", False) in (True, "true")
    normalize = mp.get("normalize_variance", True) in (True, "true")
    eps = float(mp.get("eps", 1e-9))
    dims = (1, 2, 3) if across else (2, 3)
    out = x - x.mean(dim=dims, keepdim=True)
    if normalize:
        var = (out * out).mean(dim=dims, keepdim=True)
        out = out / (torch.sqrt(var) + eps)
    return out


# --- shape / routing vocabulary -----------------------------------------

@register_layer("Split")
def split_layer(params, cfg, x):
    n = len(cfg.get("top")) if isinstance(cfg.get("top"), list) else 1
    return tuple(x for _ in range(n)) if n > 1 else x


@register_layer("Slice")
def slice_layer(params, cfg, x):
    sp = cfg.get("slice_param", {})
    axis = _axis(sp.get("axis", sp.get("slice_dim", 1)), x.dim())
    tops = cfg.get("top")
    n_tops = len(tops) if isinstance(tops, list) else 1
    points = sp.get("slice_point")
    if points is None:
        size = x.shape[axis] // n_tops
        points = [size * i for i in range(1, n_tops)]
    elif not isinstance(points, list):
        points = [points]
    return tuple(torch.tensor_split(x, [int(p) for p in points], dim=axis))


@register_layer("Crop")
def crop_layer(params, cfg, x, ref):
    """Crop x to ref's shape from ``axis`` on, at ``offset``
    (crop_layer.cpp); one offset for all axes or one per axis."""
    cp = cfg.get("crop_param", {})
    axis = _axis(cp.get("axis", 2), x.dim())
    offsets = cp.get("offset", 0)
    if not isinstance(offsets, list):
        offsets = [offsets]
    for i, ax in enumerate(range(axis, x.dim())):
        off = int(offsets[i]) if i < len(offsets) else int(offsets[-1])
        x = x.narrow(ax, off, ref.shape[ax])
    return x


@register_layer("Reshape")
def reshape_layer(params, cfg, x):
    """Caffe reshape dims (0 = copy the input's dim, -1 = infer)."""
    dims = cfg.get("reshape_param", {}).get("shape", {}).get("dim", [])
    if not isinstance(dims, list):
        dims = [dims]
    shape = [x.shape[i] if int(d) == 0 else int(d)
             for i, d in enumerate(dims)]
    return x.reshape(shape)


@register_layer("Reduction")
def reduction_layer(params, cfg, x):
    """Reduce over the trailing axes from ``axis`` on
    (reduction_layer.cpp); the output keeps the leading axes."""
    rp = cfg.get("reduction_param", {})
    op = str(rp.get("operation", "SUM")).upper()
    axis = _axis(rp.get("axis", 0), x.dim())
    coeff = float(rp.get("coeff", 1.0))
    flat = x.reshape(tuple(x.shape[:axis]) + (-1,))
    if op == "ASUM":
        out = flat.abs().sum(dim=-1)
    elif op == "SUMSQ":
        out = (flat * flat).sum(dim=-1)
    elif op == "MEAN":
        out = flat.mean(dim=-1)
    else:  # SUM
        out = flat.sum(dim=-1)
    return out * coeff


@register_layer("ArgMax")
def argmax_layer(params, cfg, x):
    ap = cfg.get("argmax_param", {})
    top_k = int(ap.get("top_k", 1))
    axis = ap.get("axis")
    if axis is not None:
        ax = _axis(axis, x.dim())
        if top_k == 1:
            return torch.argmax(x, dim=ax, keepdim=True).float()
        return torch.topk(x, top_k, dim=ax).indices.float()
    vals, idx = torch.topk(x.reshape(x.shape[0], -1), top_k, dim=-1)
    out = idx.float()
    if ap.get("out_max_val") in (True, "true"):
        out = torch.cat([out, vals], dim=-1)
    return out


@register_layer("Silence")
def silence_layer(params, cfg, *xs):
    """Consumes its bottoms and produces nothing (silence_layer.cpp)."""
    return ()


@register_layer("Parameter")
def parameter_layer(params, cfg, *unused):
    """Exposes its learnable blob as a top (parameter_layer.hpp)."""
    return params["w"]


@register_layer("Im2col")
def im2col_layer(params, cfg, x):
    """Patch extraction as a layer (im2col_layer.cpp): output channels =
    C * kh * kw in Caffe's (c, ky, kx) order — ``F.unfold``'s own — and
    the spatial dims strided like a conv."""
    cp = cfg.get("convolution_param", {})
    k = _int(cp.get("kernel_size"), 1)
    stride = _int(cp.get("stride"), 1)
    pad = _int(cp.get("pad"), 0)
    n, c, h, w = x.shape
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    cols = F.unfold(x, k, padding=pad, stride=stride)
    return cols.reshape(n, c * k * k, oh, ow)


@register_layer("Filter")
def filter_layer(params, cfg, *xs):
    """Select batch items whose selector entry is nonzero
    (filter_layer.cpp); the output batch size depends on the data."""
    keep = torch.nonzero(xs[-1].reshape(-1)).reshape(-1)
    outs = tuple(x.index_select(0, keep.to(x.device)) for x in xs[:-1])
    return outs if len(outs) > 1 else outs[0]


@register_layer("HDF5Output")
def hdf5_output_layer(params, cfg, data, label):
    """Write the (data, label) batch to an HDF5 file as data_0 / label_0
    (hdf5_output_layer.cpp SaveBlobs), blobs in Caffe's NCHW layout.
    Imports h5py when it runs; without it, raises ImportError."""
    import numpy as np

    try:
        import h5py
    except ImportError as e:
        raise ImportError("the HDF5Output layer needs h5py, which is not "
                          "installed") from e
    file_name = str(cfg.get("hdf5_output_param", {}).get("file_name"))
    with h5py.File(file_name, "w") as f:
        f.create_dataset("data_0", data=np.asarray(data.detach().cpu()))
        f.create_dataset("label_0", data=np.asarray(label.detach().cpu()))
    return ()


@register_layer("Embed")
def embed_layer(params, cfg, x):
    """Lookup-table layer (embed_layer.cpp): bottom holds integer indices
    in [0, input_dim); top = bottom shape + (num_output,).  The weight is
    [input_dim, num_output], Caffe's own blob ("transposed from
    InnerProductLayer", embed_layer.cpp:26-30)."""
    out = params["w"][x.long()]
    if "b" in params:
        out = out + params["b"]
    return out


@register_layer("Tile")
def tile_layer(params, cfg, x):
    """Repeat the blob ``tiles`` times along ``axis`` as whole-block copies
    (tile_layer.cpp Forward_cpu: outer x tiles x inner copy order)."""
    tp = cfg.get("tile_param", {})
    reps = [1] * x.dim()
    reps[_axis(tp.get("axis", 1), x.dim())] = int(tp.get("tiles"))
    return x.repeat(reps)


@register_layer("BatchReindex")
def batch_reindex_layer(params, cfg, x, idx):
    """top[i] = bottom[idx[i]] along the batch axis
    (batch_reindex_layer.cpp Forward_cpu)."""
    return x.index_select(0, idx.reshape(-1).long())


@register_layer("SPP")
def spp_layer(params, cfg, x):
    """Spatial pyramid pooling (spp_layer.cpp): for level i in
    [0, pyramid_height), pool with num_bins = 2^i uniform bins
    (kernel = ceil(dim/bins), stride = kernel,
    pad = (kernel*bins - dim + 1)/2 — GetPoolingParam, spp_layer.cpp:17-63),
    flatten each pooled map in (c, y, x) order and concat.
    Output [N, C * sum_i 4^i]."""
    sp = cfg.get("spp_param", {})
    height = int(sp.get("pyramid_height", 1))
    pool = str(sp.get("pool", "MAX")).upper()
    n, h, w = x.shape[0], x.shape[2], x.shape[3]
    outs = []
    for i in range(height):
        bins = 2 ** i
        k_h = -(-h // bins)
        k_w = -(-w // bins)
        pcfg = {"pooling_param": {
            "pool": pool, "kernel_h": k_h, "kernel_w": k_w,
            "stride_h": k_h, "stride_w": k_w,
            "pad_h": (k_h * bins - h + 1) // 2,
            "pad_w": (k_w * bins - w + 1) // 2,
        }}
        pooled = pooling_layer({}, pcfg, x)[:, :, :bins, :bins]
        outs.append(pooled.reshape(n, -1))
    return torch.cat(outs, dim=1)


@register_layer("Deconvolution")
def deconv_layer(params, cfg, x):
    """Transposed convolution (deconv_layer.cpp); out = stride*(in-1) +
    kernel - 2*pad.  The weight is Caffe's (C_in, C_out/g, kh, kw) blob,
    which is ``conv_transpose2d``'s own layout, and Caffe's pad is its
    ``padding``."""
    cp = cfg.get("convolution_param", {})
    xf, w = _f32_operands(x, params["w"])
    out = F.conv_transpose2d(xf, w, stride=_int(cp.get("stride"), 1),
                             padding=_int(cp.get("pad"), 0),
                             groups=_int(cp.get("group"), 1))
    return _bias_out(out, params, x.dtype)
