"""Batched-serving throughput of the port: one bucket of same-size pairs
(port of ``tools/bench_batch.py``).

    python -m nct_tpu_torch.tools.bench_batch [--batch B] [--size N]
        [--mode vmap|scan|both] [--reps N] [--device cuda|cpu] [--small]

The benchmark pair (``bench.load_pair``) stacked B times, seeds 0..B-1,
through ``make_batch_transfer(Config(), None, mode=...)`` on one card:

  * ``vmap`` runs the bucket as one batched pass (``transfer_batch``);
  * ``scan`` runs the single-pair pipeline over the items in turn.

Each mode runs once to warm up, then ``reps`` timed calls, each ending in
``torch.cuda.synchronize()``.  Prints one line per mode, then one JSON
object with, per mode, ``s_total`` (median), ``s_per_pair``, ``mps``,
``reps``, ``p10_s``, ``p90_s`` and ``nn_bidir_launches`` per call.  Every
timed output must be bitwise the warm-up's, and every call on the card
must launch ``nn_bidir`` once per exact level (vmap: over the B items) or
B times that (scan).  ``--size`` defaults to the pair as it is (the JAX
tool's default of 452 caps its demo pair to 300x452); ``--device``
defaults to ``cuda`` and fails without a card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from nct_tpu_torch.config import Config
from nct_tpu_torch.parallel.batch import make_batch_transfer
from nct_tpu_torch.tools import bench


def run(batch: int = 4, size: int | None = None, mode: str = "vmap",
        reps: int = 3, device: torch.device | str = "cuda",
        small: bool = False) -> dict:
    device = bench.resolve_device(device)
    modes = ("vmap", "scan") if mode == "both" else (mode,)
    size = bench.SMALL_SIZE if small else size
    cnt, stl = bench.load_pair(size)
    h, w = cnt.shape[:2]
    model = bench.seeded_model(device)
    cnt_b = torch.from_numpy(np.stack([cnt] * batch)).to(device)
    stl_b = torch.from_numpy(np.stack([stl] * batch)).to(device)
    seeds = list(range(batch))
    mp = batch * h * w / 1e6

    results = {}
    for m in modes:
        step = make_batch_transfer(Config(), None, mode=m, device=device)
        # vmap: one launch of B items per exact level; scan: B pairs
        launches = bench.expected_launches(Config(), device) * (
            1 if m == "vmap" else batch)
        counts = []

        def call():
            (out, dt), n = bench.launched(lambda: bench.timed(
                lambda: step(model, cnt_b, stl_b, seeds, bench.BDS_WEIGHT),
                device))
            if n != launches:
                raise AssertionError(f"{m}: {n} nn_bidir launches, expected "
                                     f"{launches}")
            counts.append(n)
            return out, dt

        first, _ = call()                                # warm-up
        bench.check_image(first, (h, w))
        times = []
        for _ in range(reps):
            out, dt = call()
            times.append(dt)
            if not torch.equal(out, first):
                raise AssertionError(f"{m}: a timed bucket differs from "
                                     f"the warm-up")
        stats = bench.spread(times)
        dt = stats["median_s"]
        results[m] = {"s_total": dt, "s_per_pair": dt / batch,
                      "mps": mp / dt, "reps": times,
                      "p10_s": stats["p10_s"], "p90_s": stats["p90_s"],
                      "nn_bidir_launches": counts[0]}
        print(f"{m}: batch={batch} pair={w}x{h}: {dt:.2f}s -> "
              f"{mp / dt:.4f} MP/s ({dt / batch:.3f} s/pair amortized)",
              flush=True)
    return {"batch": batch, "size": size, "geometry": f"{w}x{h}",
            "style": f"{stl.shape[1]}x{stl.shape[0]}",
            "device": bench.device_record(device), **results}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--size", type=int, default=None,
                   help="fit both images to this long side (default: the "
                        "pair as it is)")
    p.add_argument("--mode", choices=("vmap", "scan", "both"),
                   default="vmap")
    p.add_argument("--reps", type=int, default=3,
                   help="timed calls per mode after one warm-up")
    bench.add_device_args(p)
    args = p.parse_args(argv)
    result = run(args.batch, args.size, args.mode, args.reps, args.device,
                 args.small)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
