"""Per-stage roofline table of the port: measured time against the analytic
FLOPs and memory bytes (port of ``tools/roofline.py``).

    python -m nct_tpu_torch.tools.roofline [--size N] [--reps N]
        [--out FILE] [--device cuda|cpu] [--small]

The benchmark pair (``bench.load_pair``) fitted to ``--size`` (default
680: content 452x680, style 425x680) gives the shapes of the JAX tool's
rows: the VGG-19 forward of the content (``vgg_5taps(content)``); per
level the exact bidirectional NN search (``L{l}_exact_nn_bidir``, the
``nn_bidir`` kernel through ``ops.cuda_nn``) at the exact levels, else the
window refine of one direction doubled (``L{l}_window_refine(x2 dirs)``);
at the finest level the BDS vote, the k-NN graph and the nonlocal
multigrid PCG; the full-resolution WLS PCG.  The operands and stage calls
are ``profile_stages``' (``LevelStages``, ``wls_solve``; features, guides
and labels from a generator of seed 0), each row runs once to warm up
and is timed over ``reps`` calls with CUDA events
(``utils.profiling.time_call``).  Each row's counts come from
``utils.flops`` and its shares of the card's two ceilings
(``device_peaks``: bf16 tensor-core rate, memory rate) from
``roofline_fraction``; the larger names the binding resource.

Prints one line per row, the markdown table, and last one JSON object
(``--out`` also writes {"size", "rows"}).  On the CPU the shares are null:
the table has no ceilings there.  ``--device`` defaults to ``cuda`` and
fails without a card; ``--small`` fits the pair to 32 px.
"""

from __future__ import annotations

import argparse
import json

import torch

from nct_tpu_torch.config import Config
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.tools import bench
from nct_tpu_torch.tools.profile_stages import LevelStages, wls_solve
from nct_tpu_torch.utils import flops as fl
from nct_tpu_torch.utils.profiling import time_call


def plan(h: int, w: int, sh: int, sw: int, cfg: Config) -> list[dict]:
    """The table's rows in order for content (h, w) and style (sh, sw):
    {"stage", "kind", "shape", "flops", "bytes"}, where "shape" is the
    level's (ah, aw, bh, bw, C) (content (h, w) for "vgg" and "wls")."""
    dims_a, dims_b = vgg19.feature_dims(h, w), vgg19.feature_dims(sh, sw)
    chans = vgg19.tap_channels()
    taps = cfg.vgg_layers()
    rows = [{"stage": "vgg_5taps(content)", "kind": "vgg", "shape": (h, w),
             "flops": fl.vgg_forward_flops(h, w), "bytes": h * w * 3 * 4}]
    for l, tap in enumerate(taps):
        (ah, aw), (bh, bw) = dims_a[tap], dims_b[tap]
        shape = (ah, aw, bh, bw, chans[tap])
        na, nb, c = ah * aw, bh * bw, chans[tap]
        exact = l < cfg.exact_nn_levels
        f, b = fl.match_counts(na, nb, c, exact, cfg)
        rows.append({"stage": f"L{l}_exact_nn_bidir" if exact
                     else f"L{l}_window_refine(x2 dirs)",
                     "kind": "nn" if exact else "window", "shape": shape,
                     "flops": f, "bytes": b})
        if l == len(taps) - 1:
            iters = cfg.cg_iters_final_mg
            for stage, kind, (f, b) in (
                    (f"L{l}_bds_vote", "bds", fl.bds_counts(na, nb, c)),
                    (f"L{l}_knn_graph", "knn", fl.knn_counts(na, cfg)),
                    (f"L{l}_nonlocal_mg{iters}", "nonlocal",
                     fl.nonlocal_counts(na, True, cfg))):
                rows.append({"stage": stage, "kind": kind, "shape": shape,
                             "flops": f, "bytes": b})
    f, b = fl.wls_counts(h, w, cfg)
    rows.append({"stage": f"wls_mg{cfg.wls_cg_iters_mg}_fullres",
                 "kind": "wls", "shape": (h, w), "flops": f, "bytes": b})
    return rows


def _row_fn(row: dict, level, model, cnt_d, g, cfg: Config, hw):
    """(the callable a row times, its multiplier); ``level`` gives the
    row's ``profile_stages.LevelStages`` by shape."""
    kind, shape, device = row["kind"], row["shape"], cnt_d.device
    if kind == "vgg":
        return (lambda: model(cnt_d)), 1
    if kind == "wls":
        return wls_solve(*shape, g, device, cfg.wls_cg_iters_mg, cfg), 1
    lv = level(shape)
    if kind == "nn":
        return lv.nn_bidir, 1
    if kind == "window":
        return lv.window_refine, 2
    if kind == "bds":
        return (lambda: lv.bds_vote(lv.ann0)), 1
    if kind == "knn":
        return lv.knn_graph, 1
    # nonlocal
    nf = float(hw[0] * hw[1]) / (shape[0] * shape[1])
    return lv.nonlocal_solve(lv.knn_graph(), cfg.cg_iters_final_mg, nf), 1


def run(size: int = 680, reps: int = 3, device: torch.device | str = "cuda",
        small: bool = False) -> dict:
    device = bench.resolve_device(device)
    cfg = Config()
    size = bench.SMALL_SIZE if small else size
    cnt, stl = bench.load_pair(size)
    h, w = cnt.shape[:2]
    peaks = None
    if device.type == "cuda":
        peaks = fl.device_peaks(torch.cuda.get_device_name(device))
    model = bench.seeded_model(device)
    cnt_d = torch.from_numpy(cnt).to(device)
    g = torch.Generator().manual_seed(0)
    levels = {}

    def level(shape):
        if shape not in levels:
            levels[shape] = LevelStages(shape, g, device, cfg)
        return levels[shape]

    rows = []
    for row in plan(h, w, *stl.shape[:2], cfg):
        fn, mult = _row_fn(row, level, model, cnt_d, g, cfg, (h, w))
        ms = mult * time_call(fn, reps, device)[1]
        f, b = row["flops"], row["bytes"]
        rf = {"compute_frac": None, "bandwidth_frac": None, "bound": None}
        if peaks is not None:
            rf = fl.roofline_fraction(f, b, ms / 1e3, *peaks)
        rows.append({"stage": row["stage"], "ms": ms, "gflops": f / 1e9,
                     "gbytes": b / 1e9, **rf})
        share = ("" if peaks is None else
                 f" | tensor core {rf['compute_frac'] * 100:.1f}% HBM "
                 f"{rf['bandwidth_frac'] * 100:.1f}% -> {rf['bound']}")
        print(f"{row['stage']}: {ms:.1f} ms | {f / 1e9:.1f} GF "
              f"{b / 1e9:.2f} GB{share}", flush=True)
    return {"size": size, "geometry": bench.geometry(cnt, stl),
            "reps": reps, "device": bench.device_record(device),
            "rows": rows}


def _pct(x) -> str:
    return "-" if x is None else f"{x * 100:.1f}"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=680)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default=None, help="also write the rows here")
    bench.add_device_args(p)
    args = p.parse_args(argv)
    result = run(args.size, args.reps, args.device, args.small)
    print("\n| stage | ms | GF | GB | tensor-core % | HBM % | bound |")
    print("|---|---|---|---|---|---|---|")
    for r in result["rows"]:
        print(f"| {r['stage']} | {r['ms']:.3f} | {r['gflops']:.2f} | "
              f"{r['gbytes']:.3f} | {_pct(r['compute_frac'])} | "
              f"{_pct(r['bandwidth_frac'])} | {r['bound'] or '-'} |")
    if args.out:
        with open(args.out, "w") as fo:
            json.dump({"size": args.size, "rows": result["rows"]}, fo,
                      indent=1)
        print(f"wrote {args.out}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
