"""Quality table over the demo pairs (port of ``tools/quality_table.py``).

    python -m nct_tpu_torch.tools.quality_table [--size 512]
        [--pairs 0,1,2,3,4] [--skip-parity] [--shared] [--weights W.npz]
        [--device cuda|cpu] [--example DIR]

Per pair, capped to ``--size`` (or with ``--shared`` resized to one
geometry, (2 x size) // 3 rounded down to a multiple of 4 by ``size``), with
seed 7: the golden-MAE ratio MAE(out, golden) / MAE(source, golden) against
``res/in{i}_tar{i}_2.00.png`` resized onto the content; the BDS movement
MAE(out at bds 8, out at bds 0); the SSIM of the default output against
``Config.reference_parity()``'s (nan with ``--skip-parity``); and the
default run's seconds (the first pair's includes the cold start).
``--weights`` (default ``$NCT_VGG_WEIGHTS``) loads converted weights;
without it the seeded VGG-19.  Deviations from the JAX tool: ``--device``
(default cuda, raising without a card) and ``--example`` are added
(``tools/demo.py``).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from nct_tpu_torch import pipeline
from nct_tpu_torch.config import Config
from nct_tpu_torch.tools import demo
from nct_tpu_torch.tools.bench import resolve_device, sync
from nct_tpu_torch.utils.ssim import ssim


def shared_geometry(size: int) -> tuple[int, int]:
    sh = (size * 2) // 3
    return sh - sh % 4, size


def table(model, draws, device, example: str, size: int = 512,
          pairs=(0, 1, 2, 3, 4), skip_parity: bool = False,
          shared: bool = False, out=demo.say) -> list[dict]:
    """Print the table; returns its rows: {"pair", "geometry", "ratio",
    "bds_move", "ssim_parity", "seconds", "output"}."""
    config = Config()
    parity = Config.reference_parity()

    def run(cnt, stl, bds, cfg):
        res = pipeline.transfer_pair(model, cnt, stl, bds, cfg,
                                     draws=draws(), device=device)
        return res.cpu().numpy()

    rows = []
    for i in pairs:
        if shared:
            sh, sw = shared_geometry(size)
            cnt = demo.resized(demo.read(example, f"in/in{i}.png"), sh, sw)
            stl = demo.resized(demo.read(example, f"in/tar{i}.png"), sh, sw)
        else:
            cnt, stl = demo.read_pair(example, i, size)
        gold = demo.resized(demo.golden(example, i), *cnt.shape[:2])

        sync(device)
        t0 = time.perf_counter()
        res = run(cnt, stl, 2.0, config)
        t_pair = time.perf_counter() - t0
        mae_out = np.abs(res.astype(int) - gold.astype(int)).mean()
        mae_src = np.abs(cnt.astype(int) - gold.astype(int)).mean()

        out0 = run(cnt, stl, 0.0, config)
        out8 = run(cnt, stl, 8.0, config)
        bds_move = np.abs(out8.astype(int) - out0.astype(int)).mean()
        s_parity = (float("nan") if skip_parity
                    else ssim(res, run(cnt, stl, 2.0, parity)))
        rows.append({"pair": i, "geometry": f"{cnt.shape[1]}x{cnt.shape[0]}",
                     "ratio": float(mae_out / mae_src),
                     "bds_move": float(bds_move), "ssim_parity": s_parity,
                     "seconds": t_pair, "output": res})
        out(f"[quality] pair {i} done ({t_pair:.1f}s warm-run)")

    out("\n| pair | geometry | golden-MAE ratio | BDS movement (8 vs 0) | "
        "default-vs-parity SSIM | warm s/pair |")
    out("|---|---|---|---|---|---|")
    for r in rows:
        out(f"| in{r['pair']}/tar{r['pair']} | {r['geometry']} | "
            f"{r['ratio']:.3f} | {r['bds_move']:.2f} | "
            f"{r['ssim_parity']:.4f} | {r['seconds']:.2f} |")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--pairs", default="0,1,2,3,4")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--shared", action="store_true",
                    help="resize every pair to one shared geometry "
                    "((2 x size) // 3 by size)")
    ap.add_argument("--weights", default=os.environ.get("NCT_VGG_WEIGHTS"))
    demo.add_options(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    table(demo.load_model(args.weights, device), demo.seeded_draws(), device,
          demo.example_dir(args.example), args.size,
          [int(p) for p in args.pairs.split(",")], args.skip_parity,
          args.shared)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
