"""Golden closure against the nonlocal mg-PCG budget and V-cycle strength
(port of ``tools/sweep_nl_quality.py``).

    python -m nct_tpu_torch.tools.sweep_nl_quality [--iters 40]
        [--coarse-sweeps N] [--coarsest N] [--tol T] [--wls-iters N]
        [--device cuda|cpu] [--example DIR]

Runs the five demo pairs resized to 120x160 (one geometry) with seed 7
under ``cg_iters_mg = --iters`` (and ``cg_tol``, ``wls_cg_iters_mg`` when
given) and prints one line: each pair's golden-MAE ratio MAE(out, golden)
/ MAE(source, golden) against ``res/in{i}_tar{i}_2.00.png``.
``--coarse-sweeps`` and ``--coarsest`` rebind
``solve/nonlocal_solve.make_mg_preconditioner`` with ``functools.partial``
for the run (restored afterwards), as the JAX tool does: that reaches the
nonlocal solve only, since ``solve/wls.py`` imports the function by name.
Without converted weights, the seeded VGG-19.  Deviations from the JAX
tool: ``--device`` (default cuda, raising without a card) and
``--example`` are added (``tools/demo.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time

import numpy as np

from nct_tpu_torch import pipeline
from nct_tpu_torch.config import Config
from nct_tpu_torch.solve import nonlocal_solve as NL
from nct_tpu_torch.tools import demo
from nct_tpu_torch.tools.bench import resolve_device

HW = (120, 160)


def sweep(model, draws, device, example: str, iters: int = 40,
          coarse_sweeps: int | None = None, coarsest: int | None = None,
          tol: float | None = None, wls_iters: int | None = None,
          pairs=range(5), out=demo.say) -> dict:
    """Print the line; returns {"closures": [ratio per pair], "outputs":
    [uint8 array per pair], "tag": the line's settings}."""
    kw = {}
    if coarse_sweeps is not None:
        kw["coarse_sweeps"] = coarse_sweeps
    if coarsest is not None:
        kw["coarsest"] = coarsest
    over = {"cg_iters_mg": iters}
    if tol is not None:
        over["cg_tol"] = tol
    if wls_iters is not None:
        over["wls_cg_iters_mg"] = wls_iters
    config = dataclasses.replace(Config(), **over)
    h, w = HW

    original = NL.make_mg_preconditioner
    if kw:
        NL.make_mg_preconditioner = functools.partial(original, **kw)
    try:
        t0 = time.perf_counter()
        closures, outputs = [], []
        for i in pairs:
            # the resize of a uint8 image already rounds to uint8
            cnt = demo.resized(demo.read(example, f"in/in{i}.png"), h, w)
            stl = demo.resized(demo.read(example, f"in/tar{i}.png"), h, w)
            gold = demo.resized(demo.golden(example, i), h, w)
            res = pipeline.transfer_pair(model, cnt, stl, 2.0, config,
                                         draws=draws(),
                                         device=device).cpu().numpy()
            mae_out = np.abs(res.astype(int) - gold.astype(int)).mean()
            mae_src = np.abs(cnt.astype(int) - gold.astype(int)).mean()
            closures.append(float(mae_out / mae_src))
            outputs.append(res)
    finally:
        NL.make_mg_preconditioner = original
    tag = (f"iters={iters} cs={coarse_sweeps} coarsest={coarsest} "
           f"tol={config.cg_tol} wls={config.wls_cg_iters_mg}")
    out(f"{tag}: closures "
        + " ".join(f"p{i}={r:.3f}" for i, r in zip(pairs, closures))
        + f"  ({time.perf_counter() - t0:.0f}s)")
    return {"closures": closures, "outputs": outputs, "tag": tag}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--coarse-sweeps", type=int, default=None)
    ap.add_argument("--coarsest", type=int, default=None)
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--wls-iters", type=int, default=None,
                    help="override wls_cg_iters_mg")
    demo.add_options(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sweep(demo.load_model(None, device), demo.seeded_draws(), device,
          demo.example_dir(args.example), args.iters, args.coarse_sweeps,
          args.coarsest, args.tol, args.wls_iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
