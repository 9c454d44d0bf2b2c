"""Analytic FLOP / HBM-byte counts per pipeline stage, MFU and roofline
shares (a copy of ``nct_tpu/utils/flops.py`` on the port's ``Config`` and
``vgg19``).

The counts are exact for the matmul stages (exact-NN dims, VGG conv dims)
and first-order models for the gather/stencil stages.  A benchmark reports
``mfu`` (analytic FLOPs / wall / peak) and the share of each ceiling a
stage reached (``roofline_fraction``).  The matchers run bf16 on the
tensor cores; the solvers f32, whose ceiling is the memory rate.

The ceilings come from ``DEVICE_PEAKS``, keyed on
``torch.cuda.get_device_name()``: only cards the port has run on are
listed, and any other card needs its peaks passed in.
"""

from __future__ import annotations

from nct_tpu_torch.config import Config
from nct_tpu_torch.models import vgg19

# name -> (dense bf16 tensor-core FLOP/s, memory bytes/s), data-sheet rates
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),      # H100 SXM
}
# name -> dense float32 FLOP/s outside the tensor cores (data sheet): the
# ceiling of a float32 convolution or product with TF32 off
F32_PEAKS = {
    "NVIDIA H100 80GB HBM3": 67e12,
}


def device_peaks(device_name: str | None = None) -> tuple[float, float]:
    """(peak FLOP/s, peak bytes/s) of ``device_name`` (default: the current
    card's name); raises ValueError for a card not in ``DEVICE_PEAKS``."""
    if device_name is None:
        import torch

        device_name = torch.cuda.get_device_name()
    try:
        return DEVICE_PEAKS[device_name]
    except KeyError:
        raise ValueError(
            f"no peak rates recorded for {device_name!r}: pass peak_flops "
            f"and peak_bytes") from None


# VGG-19 conv body: (name, out_c); in_c follows the chain, input 3ch.
_VGG_CHAIN = [
    ("conv1_1", 64), ("conv1_2", 64),
    ("conv2_1", 128), ("conv2_2", 128),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    ("conv5_1", 512),
]


def vgg_forward_flops(h: int, w: int, upto: str = "conv5_1") -> float:
    """2*H*W*9*Cin*Cout per 3x3 conv at each stage's resolution."""
    dims = vgg19.feature_dims(h, w)
    stage_of = {n: f"conv{n[4]}_1" for n, _ in _VGG_CHAIN}
    flops = 0.0
    in_c = 3
    for name, out_c in _VGG_CHAIN:
        hh, ww = dims[stage_of[name]]
        flops += 2.0 * hh * ww * 9 * in_c * out_c
        in_c = out_c
        if name == upto:
            break
    return flops


def _level_shapes(h, w, sh, sw, config: Config):
    """Per level: (ah, aw, bh, bw, C) for content/style feature grids."""
    dims_a = vgg19.feature_dims(h, w)
    dims_b = vgg19.feature_dims(sh, sw)
    chans = vgg19.tap_channels()
    out = []
    for tap in config.vgg_layers():
        (ah, aw), (bh, bw) = dims_a[tap], dims_b[tap]
        out.append((ah, aw, bh, bw, chans[tap]))
    return out


_K = 9                                     # 3x3 patch taps
_BF16 = 2


def match_counts(na, nb, c, exact: bool, config: Config):
    """Both matching directions at one level: (flops, bytes)."""
    if exact:
        # bidirectional fused kernel: ONE [Na, 9C] x [9C, Nb] matmul
        # serves both argmin directions
        f = 2.0 * na * nb * _K * c
        # patch tables built once; the B table streams per row tile
        # (count the logical table traffic)
        b = (na + nb) * _K * c * _BF16 * 2
        return f, b
    r = config.window_radius
    win = (2 * r + 1) ** 2
    # window refine per direction: stage-1 centre distances over the
    # (2r+1)^2 window + box-sum ranking + exact rescores of 9C rows +
    # 16 far-ring probes
    per_dir = (2.0 * na * win * c
               + na * win * _K
               + 2.0 * na * config.window_shortlist * _K * c
               + 2.0 * na * 16 * c)
    f = 2.0 * per_dir
    # strip-table gathers: (2r+1) dy-row gathers of (2r+1)C-wide rows
    # per pixel + rescore patch rows
    b = 2.0 * (na * (2 * r + 1) * (2 * r + 1) * c * _BF16
               + na * config.window_shortlist * _K * c * _BF16)
    return f, b


def bds_counts(na, nb, c):
    """Gather A-side patch rows + sorted scatter B-side; feature payload
    Kc (+ the small color payload), f32 accumulation."""
    return 4.0 * (na + nb) * _K * c, (na + nb) * _K * c * 4 * 2


def knn_counts(na, config: Config):
    """Lab distances vs M candidates + k argmin-extraction passes."""
    m = min(2048, na)
    return 2.0 * na * m * 3 + config.k_num * na * m, na * m * 4.0


def nonlocal_counts(na, is_final: bool, config: Config):
    """mg-PCG: per iteration ~2 stencil operator passes over 6 maps +
    V-cycle (~4 sweeps x 4/3 hierarchy overhead) + graph gathers
    (out-edges n*k + in-tables) at 6 channels."""
    iters = (config.cg_iters_final_mg if is_final else config.cg_iters_mg)
    maps_bytes = na * 3 * 4
    per_iter_b = (2 * 6 * maps_bytes
                  + 4 * (4 / 3) * 6 * maps_bytes
                  + 2 * na * config.k_num * 6 * 4)
    return iters * per_iter_b / 4 * 1.5, iters * per_iter_b


def wls_counts(h, w, config: Config):
    """One full-res WLS solve: operator (2 Laplacians over 6 maps) +
    V-cycle per iteration."""
    wf = h * w * 3 * 4
    per_iter_b = 2 * 6 * wf + 4 * (4 / 3) * 6 * wf
    iters = (config.wls_cg_iters_mg if config.wls_precond == "mg"
             else config.wls_cg_iters)
    return iters * per_iter_b / 4 * 1.5, iters * per_iter_b


def pipeline_counts(h: int, w: int, sh: int, sw: int,
                    config: Config | None = None) -> dict:
    """Per-stage {"flops": F, "bytes": B} for one pair, all levels.

    Stage keys: vgg, match, bds, knn, nonlocal, wls.  "match" covers the
    exact-NN matmul levels AND the window-refine fine levels.
    """
    config = config or Config()
    levels = _level_shapes(h, w, sh, sw, config)
    n_levels = len(levels)

    # VGG: full 5-tap forward x2 images + progressive single-tap
    # re-extractions (level l re-extracts tap l+1 only; pipeline.py
    # _level_solve)
    taps = config.vgg_layers()
    vgg_f = vgg_forward_flops(h, w) + vgg_forward_flops(sh, sw)
    for l in range(n_levels - 1):
        vgg_f += vgg_forward_flops(h, w, upto=taps[l + 1])
    vgg_b = 2.0 * (h * w + sh * sw) * 3 * 4          # image io (lower bound)

    acc = {k: [0.0, 0.0] for k in ("match", "bds", "knn", "nonlocal",
                                   "wls")}
    for l, (ah, aw, bh, bw, c) in enumerate(levels):
        na, nb = ah * aw, bh * bw
        for key, (f, b) in (
            ("match", match_counts(na, nb, c,
                                   l < config.exact_nn_levels, config)),
            ("bds", bds_counts(na, nb, c)),
            ("knn", knn_counts(na, config)),
            ("nonlocal", nonlocal_counts(na, l == n_levels - 1, config)),
            ("wls", wls_counts(h, w, config)),
        ):
            acc[key][0] += f
            acc[key][1] += b

    stages = {"vgg": {"flops": vgg_f, "bytes": vgg_b}}
    stages.update({k: {"flops": f, "bytes": b}
                   for k, (f, b) in acc.items()})
    stages["total"] = {
        "flops": sum(s["flops"] for s in stages.values()),
        "bytes": sum(s["bytes"] for s in stages.values()),
    }
    return stages


def mfu(total_flops: float, seconds: float, peak_flops: float | None = None,
        device_name: str | None = None) -> float:
    """Analytic FLOPs over wall time over the card's peak (``peak_flops``,
    else ``device_peaks(device_name)``)."""
    if peak_flops is None:
        peak_flops = device_peaks(device_name)[0]
    return total_flops / (seconds * peak_flops)


def roofline_fraction(flops: float, nbytes: float, seconds: float,
                      peak_flops: float | None = None,
                      peak_bytes: float | None = None,
                      device_name: str | None = None) -> dict:
    """Fractions of the two ceilings a stage achieved in ``seconds``; the
    larger one names the stage's binding resource.  The peaks default to
    ``device_peaks(device_name)``."""
    if peak_flops is None or peak_bytes is None:
        dev_flops, dev_bytes = device_peaks(device_name)
        peak_flops = dev_flops if peak_flops is None else peak_flops
        peak_bytes = dev_bytes if peak_bytes is None else peak_bytes
    cf = flops / (seconds * peak_flops)
    cb = nbytes / (seconds * peak_bytes)
    return {
        "compute_frac": cf,
        "bandwidth_frac": cb,
        "bound": "compute" if cf >= cb else "bandwidth",
    }
