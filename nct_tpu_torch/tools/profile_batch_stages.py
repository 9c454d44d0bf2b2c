"""Per-stage batch scaling of the port: the time of a batch of B over B
times the time of one item (port of ``tools/profile_batch_stages.py``).

    python -m nct_tpu_torch.tools.profile_batch_stages [--batch B]
        [--device cuda|cpu] [--reps N] [--small]

At the JAX tool's shapes (content 300x452, style 283x452; levels 3 and 4)
each hot stage of the batched (vmap) pipeline runs with a leading batch
axis of 1 and of B: the directed NN kernel over its batch grid axis at
level 3, window refine at level 4, the BDS vote, the k-NN graph, the
nonlocal multigrid PCG and, at full resolution, the WLS PCG.  Each runs
once to warm up and is then timed over ``reps`` calls, with CUDA events on
the card and the host clock on the CPU.  Prints one line per stage with
both times and the per-item scaling ``t_B / (B t_1)`` (1.0: the batch costs
B single items; 1/B: it costs one), then one JSON line.  ``--device``
defaults to ``cuda`` and fails without a card; ``--small`` shrinks every
shape so that a CPU test can drive the tool.
"""

from __future__ import annotations

import argparse
import json

import torch

from nct_tpu_torch.config import Config
from nct_tpu_torch.ops import bds, cuda_nn, features, nnf
from nct_tpu_torch.ops.window_refine import window_refine
from nct_tpu_torch.solve import knn
from nct_tpu_torch.solve.nonlocal_solve import solve_nonlocal
from nct_tpu_torch.solve.wls import solve_wls
from nct_tpu_torch.utils.profiling import time_call

# (H, W) of the content and {level: (ah, aw, bh, bw, C)}, as the JAX tool
SHAPES = {
    "real": ((300, 452), {3: (150, 226, 142, 226, 128),
                          4: (300, 452, 283, 452, 64)}),
    "small": ((24, 36), {3: (12, 18, 11, 18, 16),
                         4: (24, 36, 22, 36, 8)}),
}


def run(device: torch.device | str = "cuda", batch: int = 4, reps: int = 3,
        small: bool = False) -> dict[str, dict[str, float]]:
    """Time every stage at b = 1 and b = ``batch``; returns {stage:
    {"b1_ms", "bB_ms", "scaling"}} and prints each line."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but no CUDA device is "
                           "available (pass --device cpu to run on the CPU)")
    (h, w), levels = SHAPES["small" if small else "real"]
    g = torch.Generator().manual_seed(0)
    cfg = Config()
    stages: dict[str, dict[str, float]] = {}

    def put(x):
        return x.to(device)

    def timed(name, fn):
        """fn(b) at b = 1 and b = batch; returns the batch's output."""
        t1 = time_call(lambda: fn(1), reps, device)[1]
        out, tb = time_call(lambda: fn(batch), reps, device)
        scaling = tb / (batch * t1)
        stages[name] = {"b1_ms": t1, "bB_ms": tb, "scaling": scaling}
        print(f"{name}: b=1 {t1:.3f} ms, b={batch} {tb:.3f} ms, per-item "
              f"scaling {scaling:.3f}", flush=True)
        return out

    for lvl, (ah, aw, bh, bw, c) in levels.items():
        print(f"== level {lvl}: A {ah}x{aw}, B {bh}x{bw}, C={c} ==",
              flush=True)
        shape_a, shape_b = (batch, ah, aw, c), (batch, bh, bw, c)
        fa = put(torch.randn(shape_a, generator=g).to(torch.bfloat16))
        fb = put(torch.randn(shape_b, generator=g).to(torch.bfloat16))
        fa_n = features.l2_normalize(fa.float())[0].to(torch.bfloat16)
        fb_n = features.l2_normalize(fb.float())[0].to(torch.bfloat16)
        ann0 = nnf.init_scaled_identity(ah, aw, bh, bw, device).expand(
            batch, -1, -1, -1).contiguous()
        bnn0 = nnf.init_scaled_identity(bh, bw, ah, aw, device).expand(
            batch, -1, -1, -1).contiguous()

        if lvl <= 3:
            ann = timed(f"nn_directed_L{lvl}", lambda b: cuda_nn.exact_nn(
                fa_n[:b], fb_n[:b], 3))[0]
        else:
            ann = timed(f"window_refine_L{lvl}", lambda b: window_refine(
                fa_n[:b], fb_n[:b], ann0[:b], cfg.window_radius,
                cfg.window_shortlist)[0])
        payload = fb.float()
        timed(f"bds_vote_L{lvl}", lambda b: bds.bds_vote(
            payload[:b], ann[:b], bnn0[:b], 1.0, 2.0, 3))

        lab = put(torch.rand((batch, ah, aw, 3), generator=g))
        m = min(2048, ah * aw)
        cand = put(torch.randint(0, ah * aw, (batch, 10, m), generator=g))
        plabels = put(torch.randint(0, 10, (batch, ah, aw), generator=g))
        ids, wts, slots = timed(f"knn_graph_L{lvl}", lambda b: knn.knn_graph(
            lab[:b], plabels[:b], cand[:b], 8))

        conf = put(0.2 + 0.8 * torch.rand((batch, ah, aw), generator=g))
        # a near-constant start, as the cross-level upsample gives
        a0 = put(torch.ones((batch, ah, aw, 3)))
        b0 = put(torch.zeros((batch, ah, aw, 3)))
        glab = put(torch.rand((batch, ah, aw, 3), generator=g))
        nf = float(h * w) / (ah * aw)
        iters = cfg.cg_iters_final_mg if lvl == 4 else cfg.cg_iters_mg
        timed(f"nonlocal_mg{iters}_L{lvl}", lambda b: solve_nonlocal(
            a0[:b], b0[:b], lab[:b], glab[:b], conf[:b], ids[:b], wts[:b],
            nf, iters=iters, tol=cfg.cg_tol, candidates=cand[:b],
            nbr_slots=slots[:b]))

    print("== WLS at full res ==", flush=True)
    cnt_lab = put(torch.rand((batch, h, w, 3), generator=g))
    a_up = put(torch.ones((batch, h, w, 3)))
    b_up = put(torch.zeros((batch, h, w, 3)))
    timed(f"wls_mg{cfg.wls_cg_iters_mg}_fullres", lambda b: solve_wls(
        a_up[:b], b_up[:b], cnt_lab[:b], 0.024 * 16.0,
        iters=cfg.wls_cg_iters_mg, tol=cfg.cg_tol))
    return stages


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4,
                   help="the batch B timed against one item (default 4)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without a card)")
    p.add_argument("--reps", type=int, default=3,
                   help="timed calls per stage and batch after one warm-up")
    p.add_argument("--small", action="store_true",
                   help="tiny shapes, for driving the tool in a CPU test")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    stages = run(device, args.batch, args.reps, args.small)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(json.dumps({"device": kind, "shapes": "small" if args.small
                      else "real", "batch": args.batch, "reps": args.reps,
                      "stages": stages}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
