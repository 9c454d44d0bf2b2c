"""Per-stage timing of the port at the pipeline's real shapes (port of
``tools/profile_stages.py``: 452x680 content / 600x960 style, levels L2-L4).

    python -m nct_tpu_torch.tools.profile_stages [--device cuda|cpu] [--reps N]

Times the hot stages one by one on seeded inputs: the VGG forward, the
exact NN search at L2-L3 (plain version ``exact_nn_L*``, directed kernel
``nn_directed_L*``, bidirectional kernel ``nn_bidir_L*``), window refine,
PatchMatch at L4, BDS vote, k-NN graph, the nonlocal multigrid PCG and the
full-resolution WLS PCG.  Each stage runs once to warm up and is then timed
over ``reps`` calls, with CUDA events on the card (the device's elapsed
time, host waits inside a stage included) and the host clock on the CPU.
Prints one ``name: X ms`` line per stage and, last, one JSON object with
every stage.  ``--device`` defaults to ``cuda`` and fails without a card;
``--small`` shrinks every shape so that a CPU test can drive the tool.
"""

from __future__ import annotations

import argparse
import json

import torch

from nct_tpu_torch.config import Config
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops import bds, cuda_nn, features, nnf
from nct_tpu_torch.ops.exact_nn import exact_nn_plain
from nct_tpu_torch.ops.patchmatch import patchmatch, random_search_mags
from nct_tpu_torch.ops.window_refine import window_refine
from nct_tpu_torch.solve import knn
from nct_tpu_torch.solve.nonlocal_solve import solve_nonlocal
from nct_tpu_torch.solve.wls import solve_wls
from nct_tpu_torch.utils.profiling import time_call

# (H, W) of the content and {level: (ah, aw, bh, bw, C, rs)}, as the JAX tool
SHAPES = {
    "real": ((452, 680), {2: (113, 170, 150, 240, 256, 15),
                          3: (226, 340, 300, 480, 128, 32),
                          4: (452, 680, 600, 960, 64, 32)}),
    "small": ((40, 56), {2: (10, 14, 12, 16, 32, 2),
                         3: (20, 28, 24, 30, 32, 4),
                         4: (40, 56, 46, 60, 8, 4)}),
}


def run(device: torch.device | str = "cuda", reps: int = 3,
        small: bool = False) -> dict[str, float]:
    """Time every stage; returns {stage name: ms} and prints each line."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but no CUDA device is "
                           "available (pass --device cpu to run on the CPU)")
    (h, w), levels = SHAPES["small" if small else "real"]
    g = torch.Generator().manual_seed(0)
    cfg = Config()
    stages: dict[str, float] = {}

    def put(x):
        return x.to(device)

    def timed(name, fn):
        out, stages[name] = time_call(fn, reps, device)
        print(f"{name}: {stages[name]:.3f} ms", flush=True)
        return out

    model = vgg19.init_params(torch.Generator().manual_seed(19)).to(device)
    cnt = put(torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8))
    timed("vgg_5taps", lambda: model(cnt))

    for lvl, (ah, aw, bh, bw, c, rs) in levels.items():
        print(f"== level {lvl}: A {ah}x{aw}, B {bh}x{bw}, C={c} ==",
              flush=True)
        fa = put(torch.randn((ah, aw, c), generator=g).to(torch.bfloat16))
        fb = put(torch.randn((bh, bw, c), generator=g).to(torch.bfloat16))
        fa_n = features.l2_normalize(fa.float())[0].to(torch.bfloat16)
        fb_n = features.l2_normalize(fb.float())[0].to(torch.bfloat16)
        ann0 = nnf.init_scaled_identity(ah, aw, bh, bw, device)
        bnn0 = nnf.init_scaled_identity(bh, bw, ah, aw, device)

        def refine():
            return window_refine(fa_n, fb_n, ann0, cfg.window_radius,
                                 cfg.window_shortlist)[0]

        if lvl <= 3:
            timed(f"exact_nn_L{lvl}", lambda: exact_nn_plain(fa_n, fb_n, 3))
            ann = timed(f"nn_directed_L{lvl}",
                        lambda: cuda_nn.exact_nn(fa_n, fb_n, 3))[0]
            timed(f"nn_bidir_L{lvl}",
                  lambda: cuda_nn.exact_nn_bidir(fa_n, fb_n, 3))
            if lvl == 3:
                timed(f"window_refine_L{lvl}", refine)
        else:
            ann = timed(f"window_refine_L{lvl}", refine)
            iters = cfg.pm_iters_fine
            n_mags = max(len(random_search_mags(rs, bh, bw)), 1)
            u = put(torch.rand((iters, n_mags, ah, aw, 2), generator=g))
            timed(f"patchmatch{iters}_ab_L{lvl}",
                  lambda: patchmatch(fa_n, fb_n, ann0, u, iters, rs, 3))

        timed(f"bds_vote_L{lvl}",
              lambda: bds.bds_vote(fb.float(), ann, bnn0, 1.0, 2.0, 3))

        lab = put(torch.rand((ah, aw, 3), generator=g))
        m = min(2048, ah * aw)
        cand = put(torch.randint(0, ah * aw, (10, m), generator=g))
        plabels = put(torch.randint(0, 10, (ah, aw), generator=g))
        ids, wts, slots = timed(
            f"knn_graph_L{lvl}", lambda: knn.knn_graph(lab, plabels, cand, 8))

        conf = put(0.2 + 0.8 * torch.rand((ah, aw), generator=g))
        # a near-constant start, as the cross-level upsample gives
        a0 = put(torch.ones((ah, aw, 3)))
        b0 = put(torch.zeros((ah, aw, 3)))
        glab = put(torch.rand((ah, aw, 3), generator=g))
        nf = float(h * w) / (ah * aw)
        iters = cfg.cg_iters_final_mg if lvl == 4 else cfg.cg_iters_mg
        timed(f"nonlocal_mg{iters}_tol{cfg.cg_tol:g}_L{lvl}",
              lambda: solve_nonlocal(
                  a0, b0, lab, glab, conf, ids, wts, nf, iters=iters,
                  tol=cfg.cg_tol, candidates=cand, nbr_slots=slots))

    print("== WLS at full res ==", flush=True)
    cnt_lab = put(torch.rand((h, w, 3), generator=g))
    a_up = put(torch.ones((h, w, 3)))
    b_up = put(torch.zeros((h, w, 3)))
    timed(f"wls_cg{cfg.wls_cg_iters}_fullres",
          lambda: solve_wls(a_up, b_up, cnt_lab, 0.024 * 16.0,
                            iters=cfg.wls_cg_iters))
    return stages


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without a card)")
    p.add_argument("--reps", type=int, default=3,
                   help="timed calls per stage after one warm-up call")
    p.add_argument("--small", action="store_true",
                   help="tiny shapes, for driving the tool in a CPU test")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    stages = run(device, args.reps, args.small)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(json.dumps({"device": kind, "shapes": "small" if args.small
                      else "real", "reps": args.reps, "stages_ms": stages}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
