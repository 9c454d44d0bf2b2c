"""Per-level CG convergence profile over the demo pairs (port of
``tools/profile_cg.py``).

    python -m nct_tpu_torch.tools.profile_cg [--size 680] [--pairs 0,1,2,3,4]
        [--tol T] [--iters N] [--weights W.npz] [--device cuda|cpu]
        [--example DIR]

Runs ``pipeline.transfer_pair(..., return_intermediates="stats")`` per pair
(seed 7, the default ``Config`` with ``--tol`` as ``cg_tol`` and ``--iters``
as ``cg_iters_mg``) and prints, per pair and level, the nonlocal mg-PCG and
WLS PCG iterations run and sqrt of their final ||r||^2, in the JAX tool's
table.  ``--weights`` (default ``$NCT_VGG_WEIGHTS``) loads converted
weights through ``models.vgg19.load_params``; without it the seeded VGG-19.
Deviations from the JAX tool: ``--staged`` is dropped (a TPU workaround),
and ``--device`` (default cuda, raising without a card) and ``--example``
are added (``tools/demo.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from nct_tpu_torch import pipeline
from nct_tpu_torch.config import Config
from nct_tpu_torch.tools import demo
from nct_tpu_torch.tools.bench import resolve_device, sync


def profile(model, draws, device, example: str, size: int = 680,
            pairs=(0, 1, 2, 3, 4), config: Config | None = None,
            out=demo.say) -> list[dict]:
    """Print the table; returns its rows: {"pair", "level", "nl_iters",
    "nl_r2", "wls_iters", "wls_r2"} with r2 the final ||r||^2."""
    config = config or Config()
    out(f"backend={device.type} size={size} tol={config.cg_tol} caps mg="
        f"{config.cg_iters_mg}/{config.cg_iters_final_mg} wls="
        f"{config.wls_cg_iters}")
    out("| pair | level (geometry) | nl iters | nl rel-res | wls iters | "
        "wls rel-res |")
    out("|---|---|---|---|---|---|")
    rows = []
    for i in pairs:
        cnt, stl = demo.read_pair(example, i, size)
        sync(device)
        t0 = time.perf_counter()
        _, trace = pipeline.transfer_pair(
            model, cnt, stl, 2.0, config, draws=draws(), device=device,
            return_intermediates="stats")
        sync(device)
        dt = time.perf_counter() - t0
        for tr in trace:
            row = {"pair": i, "level": tr["level"],
                   "nl_iters": int(tr["nl_iters"]),
                   "nl_r2": float(tr["nl_r2"]),
                   "wls_iters": int(tr["wls_iters"]),
                   "wls_r2": float(tr["wls_r2"])}
            rows.append(row)
            # residuals come back as ||r||^2
            out(f"| in{i} | L{row['level']} | {row['nl_iters']} | "
                f"{np.sqrt(row['nl_r2']):.3e} | {row['wls_iters']} | "
                f"{np.sqrt(row['wls_r2']):.3e} |")
        out(f"[profile_cg] pair {i} done {dt:.1f}s (incl. compile on "
            "first geometry)")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=680)
    ap.add_argument("--pairs", default="0,1,2,3,4")
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--iters", type=int, default=None,
                    help="override cg_iters_mg (coarse-level cap)")
    ap.add_argument("--weights", default=os.environ.get("NCT_VGG_WEIGHTS"))
    demo.add_options(ap)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    example = demo.example_dir(args.example)
    over = {}
    if args.tol is not None:
        over["cg_tol"] = args.tol
    if args.iters is not None:
        over["cg_iters_mg"] = args.iters
    config = dataclasses.replace(Config(), **over)
    profile(demo.load_model(args.weights, device), demo.seeded_draws(),
            device, example, args.size,
            [int(p) for p in args.pairs.split(",")], config)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
