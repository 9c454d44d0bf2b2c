"""Capture the nonlocal-solve inputs of a demo-pair run to npz files (port
of ``tools/capture_nl.py``).

    python -m nct_tpu_torch.tools.capture_nl --out DIR [--pair 1]
        [--size 680] [--weights W.npz] [--device cuda|cpu] [--example DIR]

Runs ``pipeline.transfer_pair`` (default ``Config``, seed 7) with the
pipeline's ``solve_nonlocal`` swapped for a wrapper that saves each
level's system to ``DIR/nl_L{level}.npz`` and then calls the real solve;
the original is restored afterwards.  The files have the layout of
``tests/fixtures/nl_L*.npz``: ``a0 b0 src_lab ref_lab`` float32 [h, w, 3],
``confidence`` [h, w], ``nbr_ids nbr_slots`` int32 [N, 8], ``nbr_w``
float32 [N, 8], ``norm_factor`` a float32 scalar and ``candidates`` int32
[K, M].  ``solve/retune.py`` replays them (``retune_caps``).
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


def _np(t, dtype=None):
    a = t.cpu().numpy()
    return a if dtype is None else a.astype(dtype)


def capture(model, draws, device, example: str, out_dir: str, pair: int = 1,
            size: int = 680, out=demo.say) -> list[dict]:
    """Capture every level's system of pair ``pair``; returns per level
    {"level", "path", "iters", "r2", "a", "b"}: the real solve's
    iterations, final ||r||^2 and coefficients (tensors on ``device``)."""
    os.makedirs(out_dir, exist_ok=True)
    solve_nonlocal = pipeline.solve_nonlocal
    calls = []

    def capturing(a0, b0, src_lab, ref_lab, confidence, nbr_ids, nbr_w,
                  norm_factor, *posargs, **kw):
        lvl = len(calls)
        path = os.path.join(out_dir, f"nl_L{lvl}.npz")
        np.savez_compressed(
            path, a0=_np(a0), b0=_np(b0), src_lab=_np(src_lab),
            ref_lab=_np(ref_lab), confidence=_np(confidence),
            nbr_ids=_np(nbr_ids, np.int32), nbr_w=_np(nbr_w),
            norm_factor=np.float32(norm_factor),
            candidates=_np(kw["candidates"], np.int32),
            nbr_slots=_np(kw["nbr_slots"], np.int32))
        a, b, it, r2 = solve_nonlocal(a0, b0, src_lab, ref_lab, confidence,
                                      nbr_ids, nbr_w, norm_factor, *posargs,
                                      **kw)
        calls.append({"level": lvl, "path": path, "iters": int(it),
                      "r2": float(r2), "a": a, "b": b})
        out(f"[capture] L{lvl} {tuple(src_lab.shape)} saved")
        return a, b, it, r2

    cnt, stl = demo.read_pair(example, pair, size)
    pipeline.solve_nonlocal = capturing
    try:
        sync(device)
        t0 = time.perf_counter()
        pipeline.transfer_pair(model, cnt, stl, 2.0, Config(), draws=draws(),
                               device=device)
        sync(device)
        out(f"[capture] pair {pair} done {time.perf_counter() - t0:.1f}s, "
            f"{len(calls)} levels -> {out_dir}")
    finally:
        pipeline.solve_nonlocal = solve_nonlocal
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", type=int, default=1)
    ap.add_argument("--size", type=int, default=680)
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", default=os.environ.get("NCT_VGG_WEIGHTS"))
    demo.add_options(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    capture(demo.load_model(args.weights, device), demo.seeded_draws(),
            device, demo.example_dir(args.example), args.out, args.pair,
            args.size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
