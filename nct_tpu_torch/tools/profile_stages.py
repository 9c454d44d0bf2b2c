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
A level's operands and stage calls (``LevelStages``) and the WLS call
(``wls_solve``) are shared with ``tools/roofline``.
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


WLS_LAMBDA = 0.024 * 16.0


class LevelStages:
    """Seeded operands of the stages of one level (A ah x aw, B bh x bw,
    C channels), drawn from ``g`` in the order the stages first need them,
    and the stages as callables.  ``roofline`` times the same stages on
    the same kind of operands."""

    def __init__(self, shape, g: torch.Generator, device: torch.device,
                 cfg: Config):
        ah, aw, bh, bw, c = shape
        self.shape, self.g, self.device, self.cfg = shape, g, device, cfg
        self.fa = self.put(torch.randn((ah, aw, c), generator=g)
                           .to(torch.bfloat16))
        self.fb = self.put(torch.randn((bh, bw, c), generator=g)
                           .to(torch.bfloat16))
        self.fa_n, self.fb_n = (
            features.l2_normalize(x.float())[0].to(torch.bfloat16)
            for x in (self.fa, self.fb))
        self.ann0 = nnf.init_scaled_identity(ah, aw, bh, bw, device)
        self.bnn0 = nnf.init_scaled_identity(bh, bw, ah, aw, device)
        self._graph_in = None

    def put(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device)

    def window_refine(self):
        return window_refine(self.fa_n, self.fb_n, self.ann0,
                             self.cfg.window_radius,
                             self.cfg.window_shortlist)[0]

    def nn_directed(self):
        return cuda_nn.exact_nn(self.fa_n, self.fb_n, 3)

    def nn_bidir(self):
        return cuda_nn.exact_nn_bidir(self.fa_n, self.fb_n, 3)

    def bds_vote(self, ann):
        return bds.bds_vote(self.fb.float(), ann, self.bnn0, 1.0, 2.0, 3)

    def graph_inputs(self):
        """(Lab guide, k-means labels, candidate ids), drawn on first use."""
        if self._graph_in is None:
            ah, aw = self.shape[:2]
            lab = self.put(torch.rand((ah, aw, 3), generator=self.g))
            cand = self.put(torch.randint(0, ah * aw, (10, min(2048, ah * aw)),
                                          generator=self.g))
            plabels = self.put(torch.randint(0, 10, (ah, aw),
                                              generator=self.g))
            self._graph_in = (lab, plabels, cand)
        return self._graph_in

    def knn_graph(self):
        lab, plabels, cand = self.graph_inputs()
        return knn.knn_graph(lab, plabels, cand, 8)

    def nonlocal_solve(self, graph, iters: int, nf: float):
        """The nonlocal multigrid PCG over ``graph`` (``knn_graph()``'s
        output) as a callable, from a near-constant start as the
        cross-level upsample gives."""
        ah, aw = self.shape[:2]
        lab, _, cand = self.graph_inputs()
        ids, wts, slots = graph
        conf = self.put(0.2 + 0.8 * torch.rand((ah, aw), generator=self.g))
        a0 = self.put(torch.ones((ah, aw, 3)))
        b0 = self.put(torch.zeros((ah, aw, 3)))
        glab = self.put(torch.rand((ah, aw, 3), generator=self.g))
        cfg = self.cfg
        return lambda: solve_nonlocal(
            a0, b0, lab, glab, conf, ids, wts, nf, iters=iters,
            tol=cfg.cg_tol, candidates=cand, nbr_slots=slots,
            precond_kind=cfg.nl_precond)


def wls_solve(h: int, w: int, g: torch.Generator, device: torch.device,
              iters: int, cfg: Config):
    """The full-resolution WLS PCG on a seeded guide as a callable."""
    cnt_lab = torch.rand((h, w, 3), generator=g).to(device)
    a_up = torch.ones((h, w, 3), device=device)
    b_up = torch.zeros((h, w, 3), device=device)
    return lambda: solve_wls(a_up, b_up, cnt_lab, WLS_LAMBDA, iters=iters,
                             precond_kind=cfg.wls_precond)


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

    def timed(name, fn):
        out, stages[name] = time_call(fn, reps, device)
        print(f"{name}: {stages[name]:.3f} ms", flush=True)
        return out

    model = vgg19.init_params(torch.Generator().manual_seed(19)).to(device)
    cnt = torch.randint(0, 256, (h, w, 3), generator=g,
                        dtype=torch.uint8).to(device)
    timed("vgg_5taps", lambda: model(cnt))

    for lvl, (ah, aw, bh, bw, c, rs) in levels.items():
        print(f"== level {lvl}: A {ah}x{aw}, B {bh}x{bw}, C={c} ==",
              flush=True)
        lv = LevelStages((ah, aw, bh, bw, c), g, device, cfg)
        if lvl <= 3:
            timed(f"exact_nn_L{lvl}",
                  lambda: exact_nn_plain(lv.fa_n, lv.fb_n, 3))
            ann = timed(f"nn_directed_L{lvl}", lv.nn_directed)[0]
            timed(f"nn_bidir_L{lvl}", lv.nn_bidir)
            if lvl == 3:
                timed(f"window_refine_L{lvl}", lv.window_refine)
        else:
            ann = timed(f"window_refine_L{lvl}", lv.window_refine)
            iters = cfg.pm_iters_fine
            n_mags = max(len(random_search_mags(rs, bh, bw)), 1)
            u = torch.rand((iters, n_mags, ah, aw, 2), generator=g).to(device)
            timed(f"patchmatch{iters}_ab_L{lvl}",
                  lambda: patchmatch(lv.fa_n, lv.fb_n, lv.ann0, u, iters, rs,
                                     3))

        timed(f"bds_vote_L{lvl}", lambda: lv.bds_vote(ann))
        graph = timed(f"knn_graph_L{lvl}", lv.knn_graph)
        iters = cfg.cg_iters_final_mg if lvl == 4 else cfg.cg_iters_mg
        timed(f"nonlocal_mg{iters}_tol{cfg.cg_tol:g}_L{lvl}",
              lv.nonlocal_solve(graph, iters, float(h * w) / (ah * aw)))

    print("== WLS at full res ==", flush=True)
    timed(f"wls_cg{cfg.wls_cg_iters}_fullres",
          wls_solve(h, w, g, device, cfg.wls_cg_iters, cfg))
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
