"""Re-derive the solver iteration caps from residual targets (port of
``tools/retune_caps.py``).

    python -m nct_tpu_torch.tools.retune_caps [--nl-dir DIR] [--capture]
        [--pair 1] [--size 680] [--target 1e-2] [--caps N ...]
        [--wls-levels 0 4] [--out caps.json] [--device cuda|cpu]
        [--example DIR]

Sweeps the candidate caps (default ``DEFAULT_CAPS``) on each captured
nonlocal system ``DIR/nl_L*.npz`` (``capture_nl``; ``--capture`` runs it
first, into ``--nl-dir`` or a directory under the temp dir) and on the
matcher-free WLS systems of the same pair at ``--wls-levels``, each
against a converged solve of ``retune.CONVERGED_ITERS`` iterations
(``solve/retune.py``).  Prints each curve and the smallest cap meeting the
residual-reduction target, and the recommended ``cg_iters_mg`` (the
largest over the coarse levels), ``cg_iters_final_mg`` (the finest level)
and ``wls_cg_iters_mg``; ``--out`` writes the JSON report (``nl``,
``wls``, ``recommended``).  Deviations from the JAX tool: ``--device``
(default cuda, raising without a card) and ``--example`` are added
(``tools/demo.py``).  ``--capture`` runs with ``$NCT_VGG_WEIGHTS``
(``capture_nl``'s default) or the seeded VGG-19.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from nct_tpu_torch.config import Config
from nct_tpu_torch.solve import retune
from nct_tpu_torch.tools import capture_nl, demo
from nct_tpu_torch.tools.bench import resolve_device

DEFAULT_CAPS = (4, 6, 8, 10, 12, 16, 24, 32, 48)


def _show(out, name: str, curve: dict) -> None:
    conv = curve["converged"]
    out(f"\n{name}: r2 init {conv['r2_init']:.3e} -> converged "
        f"{conv['r2']:.3e} @ {conv['iters']} iters")
    out("| cap | r2 | reduction | sol err (max-norm rel) |")
    out("|---|---|---|---|")
    for cap in sorted(curve["caps"]):
        c = curve["caps"][cap]
        out(f"| {cap} | {c['r2']:.3e} | {c['reduction']:.3e} | "
            f"{c['sol_err']:.3f} |")


def retune_caps(model, draws, device, example: str, nl_dir: str | None = None,
                capture: bool = False, pair: int = 1, size: int = 680,
                target: float = 1e-2, caps=DEFAULT_CAPS,
                wls_levels=(0, 4), out_path: str | None = None,
                out=demo.say) -> dict:
    """Print the curves; returns the report.  ``model`` and ``draws`` serve
    ``capture`` only."""
    caps = tuple(caps)
    config = Config()
    report = {"pair": pair, "size": size, "target": target, "nl": {},
              "wls": {}, "recommended": {}}

    if capture:
        if not nl_dir:
            nl_dir = os.path.join(tempfile.gettempdir(),
                                  f"retune_nl_in{pair}_{size}")
        capture_nl.capture(model, draws, device, example, nl_dir, pair, size,
                           out=out)

    # nonlocal systems
    nl_recs = {}
    if nl_dir and os.path.isdir(nl_dir):
        for fname in sorted(os.listdir(nl_dir)):
            if not fname.startswith("nl_L"):
                continue
            level = int(fname[4])
            system = retune.load_nl_system(os.path.join(nl_dir, fname))
            curve = retune.residual_curve(
                lambda cap: retune.nl_solve_at_cap(system, cap, config,
                                                   device), caps)
            rec = retune.recommend_cap(curve, target)
            nl_recs[level] = rec
            report["nl"][level] = {"curve": curve, "recommended": rec}
            _show(out, f"nonlocal L{level} {system['src_lab'].shape[:2]}",
                  curve)
            out(f"recommended cap @ target {target:g}: {rec}")
    else:
        out("no --nl-dir given (or missing): skipping nonlocal sweep; pass "
            "--capture to generate one")

    # WLS systems (matcher-free, the real operator)
    cnt, stl = demo.read_pair(example, pair, size)
    wls_recs = {}
    for level in wls_levels:
        system = retune.wls_system_from_image(cnt, stl, level, config, device)
        curve = retune.residual_curve(
            lambda cap: retune.wls_solve_at_cap(system, cap, config), caps)
        rec = retune.recommend_cap(curve, target)
        wls_recs[level] = rec
        report["wls"][level] = {"curve": curve, "recommended": rec}
        _show(out, f"WLS L{level} lam={system[3]:.3f}", curve)
        out(f"recommended cap @ target {target:g}: {rec}")

    numl = config.num_levels
    coarse_nl = [r for lv, r in nl_recs.items() if lv < numl - 1 and r]
    fine_nl = [r for lv, r in nl_recs.items() if lv == numl - 1 and r]
    report["recommended"] = {
        "cg_iters_mg": max(coarse_nl) if coarse_nl else None,
        "cg_iters_final_mg": max(fine_nl) if fine_nl else None,
        "wls_cg_iters_mg": (max(r for r in wls_recs.values() if r)
                            if any(wls_recs.values()) else None),
    }
    out(f"\nrecommended config overrides @ target {target:g}: "
        f"{report['recommended']}")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
        out(f"wrote {out_path}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nl-dir", default=None,
                    help="directory of captured nl_L*.npz systems")
    ap.add_argument("--capture", action="store_true",
                    help="run capture_nl into --nl-dir first")
    ap.add_argument("--pair", type=int, default=1)
    ap.add_argument("--size", type=int, default=680)
    ap.add_argument("--target", type=float, default=1e-2,
                    help="residual-reduction target r2(cap)/r2(init)")
    ap.add_argument("--caps", type=int, nargs="*", default=None)
    ap.add_argument("--wls-levels", type=int, nargs="*", default=[0, 4])
    ap.add_argument("--out", default=None, help="write the JSON here")
    demo.add_options(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = (demo.load_model(os.environ.get("NCT_VGG_WEIGHTS"), device)
             if args.capture else None)
    retune_caps(model,
                demo.seeded_draws(), device, demo.example_dir(args.example),
                args.nl_dir, args.capture, args.pair, args.size, args.target,
                args.caps or DEFAULT_CAPS, args.wls_levels, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
