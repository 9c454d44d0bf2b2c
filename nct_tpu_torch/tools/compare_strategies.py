"""Quality and speed of named configurations on a demo pair (port of
``tools/compare_strategies.py``).

    python -m nct_tpu_torch.tools.compare_strategies [size] [names ...]
        [--device cuda|cpu] [--example DIR]

Runs pair 0 of the demo directory, capped to ``size`` (default 700), under
each named configuration of ``CONFIGS`` (default ``default patchmatch``):
one cold run, then one timed warm run, each with seed 7.  Prints each
configuration's warm seconds and the SSIM (``utils/ssim.py``) of the
first configuration's output against each other's.  Deviations from the
JAX tool: ``--device`` (default cuda, raising without a card) and
``--example`` are added (``tools/demo.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from nct_tpu_torch import pipeline
from nct_tpu_torch.config import Config
from nct_tpu_torch.tools import demo
from nct_tpu_torch.tools.bench import resolve_device, sync
from nct_tpu_torch.utils.ssim import ssim

_BASE = Config()

CONFIGS = {
    "default": _BASE,
    "patchmatch": dataclasses.replace(_BASE, fine_strategy="patchmatch"),
    # block-Jacobi PCG at the halved reference budgets
    "bj": dataclasses.replace(_BASE, nl_precond="block_jacobi"),
    # the reference's multi-cluster k-NN merge (2 memberships)
    "knn2": dataclasses.replace(_BASE, knn_memberships=2),
    # window-refine rescore-count ablation
    "w2": dataclasses.replace(_BASE, window_shortlist=2),
    "w4": dataclasses.replace(_BASE, window_shortlist=4),
    "w8": dataclasses.replace(_BASE, window_shortlist=8),
    # window refinement in place of the exact search at conv2_1 too
    "xnn3": dataclasses.replace(_BASE, exact_nn_levels=3),
    # nonlocal in-edge cap ablation
    "cap32": dataclasses.replace(_BASE, nl_in_cap=32),
    # the default matcher with the reference's solver budgets
    "cgfull": dataclasses.replace(
        _BASE, nl_precond="block_jacobi", cg_iters=100, cg_iters_final=50,
        wls_cg_iters=400, cg_tol=1e-6),
    # the reference-shaped search and solver budgets
    "parity": Config.reference_parity(),
}


def compare(model, draws, device, example: str, size: int = 700,
            names=("default", "patchmatch"), out=demo.say) -> dict:
    """Print the times and SSIMs; returns {"seconds": {name: s},
    "outputs": {name: uint8 tensor}, "ssim": {other: SSIM(first, other)}}."""
    cnt, stl = demo.read_pair(example, 0, size)
    seconds, outs = {}, {}
    for name in names:
        config = CONFIGS[name]

        def run():
            return pipeline.transfer_pair(model, cnt, stl, 2.0, config,
                                          draws=draws(), device=device)
        run()                                   # cold
        sync(device)
        t0 = time.perf_counter()
        outs[name] = run()
        sync(device)
        seconds[name] = time.perf_counter() - t0
        out(f"{name}: {seconds[name]:.2f} s")

    base = names[0]
    scores = {}
    for other in names[1:]:
        scores[other] = ssim(outs[base], outs[other])
        out(f"SSIM({base}, {other}) = {scores[other]:.4f}")
    return {"seconds": seconds, "outputs": outs, "ssim": scores}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("size", type=int, nargs="?", default=700)
    ap.add_argument("names", nargs="*",
                    help=f"configurations, of {', '.join(CONFIGS)}")
    demo.add_options(ap)
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in CONFIGS]
    if unknown:
        ap.error(f"unknown configurations {unknown}")
    device = resolve_device(args.device)
    compare(demo.load_model(None, device), demo.seeded_draws(), device,
            demo.example_dir(args.example), args.size,
            args.names or ["default", "patchmatch"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
