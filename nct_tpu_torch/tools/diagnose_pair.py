"""Per-level closure diagnosis of one demo pair (port of
``tools/diagnose_pair.py``).

    python -m nct_tpu_torch.tools.diagnose_pair [--pair 3] [--size 452]
        [--config default|parity|knn2|pm_fine] [--bds 2.0] [--out R.json]
        [--dump-pngs DIR] [--device cuda|cpu] [--example DIR]

Runs the pipeline with every intermediate (seed 7) and reports per level:
the refined ratio MAE(refined, golden) / MAE(source, golden); the guide
ratio MAE(guide, golden at the level grid) / MAE(source, golden there);
the mean BDS matching error; and (iterations, final ||r||^2) of the
nonlocal and WLS solves.  The golden is ``res/in{p}_tar{p}_{bds:.2f}.png``
resized onto the content.  ``--out`` writes the report as JSON,
``--dump-pngs`` each level's guide and refined image.  Without converted
weights, the seeded VGG-19.  Deviations from the JAX tool: ``--staged`` is
dropped (a TPU workaround), and ``--device`` (default cuda, raising
without a card) and ``--example`` are added (``tools/demo.py``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from nct_tpu_torch import pipeline
from nct_tpu_torch.config import Config
from nct_tpu_torch.io import imwrite_bgr
from nct_tpu_torch.tools import demo
from nct_tpu_torch.tools.bench import resolve_device

CONFIG_NAMES = ("default", "parity", "knn2", "pm_fine")


def named_config(name: str) -> Config:
    return {"default": Config,
            "parity": Config.reference_parity,
            "knn2": lambda: Config(knn_memberships=2),
            "pm_fine": lambda: Config(fine_strategy="patchmatch")}[name]()


def _f64(t) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def diagnose(model, draws, device, example: str, pair: int = 3,
             size: int = 452, config_name: str = "default", bds: float = 2.0,
             out_path: str | None = None, dump_pngs: str | None = None,
             out=demo.say) -> dict:
    """Print the table; returns the report (``final_ratio`` and per level
    ``refined_ratio``, ``guide_ratio``, ``mean_bds_err``, ``nl``,
    ``wls``)."""
    cnt, stl = demo.read_pair(example, pair, size)
    gold_full = demo.golden(example, pair, bds)
    gold = demo.resized(gold_full, *cnt.shape[:2]).astype(np.float64)

    res, trace = pipeline.transfer_pair(
        model, cnt, stl, bds, named_config(config_name), draws=draws(),
        device=device, return_intermediates=True)
    res = _f64(res)

    mae_src = np.abs(cnt.astype(np.float64) - gold).mean()
    report = {
        "pair": pair, "size": size, "config": config_name,
        "geometry": f"{cnt.shape[1]}x{cnt.shape[0]}",
        "mae_src_vs_golden": round(float(mae_src), 3),
        "final_ratio": round(float(np.abs(res - gold).mean() / mae_src), 4),
        "levels": [],
    }
    out(f"pair in{pair} {report['geometry']} config={config_name} "
        f"src-vs-golden MAE {mae_src:.2f}")
    out("| L | grid | refined ratio | guide ratio | mean bds_err | "
        "nl (it, r2) | wls (it, r2) |")
    out("|---|---|---|---|---|---|---|")
    for tr in trace:
        lvl = int(tr["level"])
        refined = _f64(tr["refined"])
        guide = _f64(tr["guide"])
        gh, gw = guide.shape[:2]
        gold_lvl = demo.resized(gold_full, gh, gw).astype(np.float64)
        cnt_lvl = demo.resized(cnt, gh, gw).astype(np.float64)
        mae_src_lvl = np.abs(cnt_lvl - gold_lvl).mean()
        row = {
            "level": lvl, "grid": f"{gw}x{gh}",
            "refined_ratio": round(
                float(np.abs(refined - gold).mean() / mae_src), 4),
            "guide_ratio": round(float(np.abs(guide - gold_lvl).mean()
                                       / max(mae_src_lvl, 1e-9)), 4),
            "mean_bds_err": round(float(tr["bds_err"].float().mean()), 4),
            "nl": [int(tr["nl_iters"]), float(tr["nl_r2"])],
            "wls": [int(tr["wls_iters"]), float(tr["wls_r2"])],
        }
        report["levels"].append(row)
        out(f"| {lvl} | {row['grid']} | {row['refined_ratio']} | "
            f"{row['guide_ratio']} | {row['mean_bds_err']} | "
            f"{row['nl'][0]}, {row['nl'][1]:.2e} | "
            f"{row['wls'][0]}, {row['wls'][1]:.2e} |")
        if dump_pngs:
            os.makedirs(dump_pngs, exist_ok=True)
            imwrite_bgr(f"{dump_pngs}/L{lvl}_guide.png",
                        tr["guide"].cpu().numpy().astype(np.uint8))
            imwrite_bgr(f"{dump_pngs}/L{lvl}_refined.png",
                        tr["refined"].cpu().numpy().astype(np.uint8))

    out(f"final ratio {report['final_ratio']} (<1 = closer to the golden "
        f"than the source)")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
        out(f"wrote {out_path}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", type=int, default=3)
    ap.add_argument("--size", type=int, default=452)
    ap.add_argument("--config", default="default", choices=CONFIG_NAMES)
    ap.add_argument("--bds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dump-pngs", default=None)
    demo.add_options(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    diagnose(demo.load_model(None, device), demo.seeded_draws(), device,
             demo.example_dir(args.example), args.pair, args.size,
             args.config, args.bds, args.out, args.dump_pngs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
