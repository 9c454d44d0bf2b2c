"""Frame-sequence throughput of the port (port of
``tools/bench_sequence.py``).

    python -m nct_tpu_torch.tools.bench_sequence [--frames N] [--size N]
        [--pm] [--device cuda|cpu] [--small]

Transfers N same-size "video" frames against one style through
``transfer_sequence``: each frame warm-starts its level-0 fields from the
previous frame's.  The frames are the benchmark content image
(``bench.load_pair``) under small integer pans and a slow brightness drift
(``make_frames``, bitwise the JAX tool's), so consecutive frames correlate
like video.  ``--pm`` sets ``exact_nn_levels=0`` and nothing else, as the
JAX tool's ``pm`` token does: PatchMatch, which the warm start seeds, at
level 0 and the window refine above it; the default Config searches
exactly at L0-L3, where the warm start is inert.

Reports the host seconds of each frame (each ends in
``torch.cuda.synchronize()``): frame 0 cold, frame 1 the first warm-started
frame, and the steady s/frame as the mean over frames 2..N (frames 1..N
when N <= 3, as the JAX tool does).  Prints the JAX tool's lines, then one
JSON object.  ``--size`` defaults to the pair as it is (the JAX tool's 452
caps its demo content to 300x452); ``--device`` defaults to ``cuda`` and
fails without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from nct_tpu_torch.config import Config
from nct_tpu_torch.pipeline import transfer_sequence
from nct_tpu_torch.tools import bench


def make_frames(base: np.ndarray, n: int) -> list[np.ndarray]:
    """Synthetic video: integer pans (a +-2 px per frame walk) and a slow
    brightness drift over ``base``; bitwise the JAX tool's frames."""
    rng = np.random.default_rng(3)
    frames = []
    dy = dx = 0
    for i in range(n):
        f = np.roll(base, (dy, dx), axis=(0, 1)).astype(np.int16)
        f = np.clip(f + int(3 * np.sin(i / 3)), 0, 255).astype(np.uint8)
        frames.append(f)
        dy += int(rng.integers(-2, 3))
        dx += int(rng.integers(-2, 3))
    return frames


def run(n: int = 8, size: int | None = None, pm: bool = False,
        device: torch.device | str = "cuda", small: bool = False) -> dict:
    device = bench.resolve_device(device)
    if n < 2:
        raise ValueError(f"n={n}: the steady rate needs at least 2 frames")
    base, stl = bench.load_pair(bench.SMALL_SIZE if small else size)
    h, w = base.shape[:2]
    frames = [torch.from_numpy(f).to(device) for f in make_frames(base, n)]
    stl_d = torch.from_numpy(stl).to(device)
    model = bench.seeded_model(device)
    config = Config()
    if pm:
        config = dataclasses.replace(config, exact_nn_levels=0)
    mp = h * w / 1e6
    label = "pm" if pm else "default"
    print(f"geometry {w}x{h}, n={n}, config={label}", flush=True)

    def frame_times():
        times = []
        bench.sync(device)
        t_prev = time.perf_counter()
        for out in transfer_sequence(model, frames, stl_d, bench.BDS_WEIGHT,
                                     config, seed=bench.SEED, device=device):
            bench.sync(device)
            t_now = time.perf_counter()
            times.append(t_now - t_prev)
            t_prev = t_now
            bench.check_image(out, (h, w))
        return times

    times, launches = bench.launched(frame_times)
    want = n * bench.expected_launches(config, device)
    if len(times) != n or launches != want:
        raise AssertionError(f"{len(times)} frames and {launches} nn_bidir "
                             f"launches, expected {n} and {want}")
    steady = times[2:] if len(times) > 3 else times[1:]
    s_frame = float(np.mean(steady))
    print(f"frame times: cold {times[0]:.2f}s, warm-compile "
          f"{times[1]:.2f}s, steady {s_frame:.3f}s/frame "
          f"({mp / s_frame:.4f} MP/s/card)", flush=True)
    return {"n": n, "config": label, "geometry": f"{w}x{h}",
            "style": f"{stl.shape[1]}x{stl.shape[0]}",
            "frame_s": times, "cold_s": times[0], "warm_start_s": times[1],
            "s_per_frame": s_frame, "mps": mp / s_frame,
            "nn_bidir_launches": launches,
            "device": bench.device_record(device)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--size", type=int, default=None,
                   help="fit both images to this long side (default: the "
                        "pair as it is)")
    p.add_argument("--pm", action="store_true",
                   help="exact_nn_levels=0: PatchMatch at level 0")
    bench.add_device_args(p)
    args = p.parse_args(argv)
    result = run(args.frames, args.size, args.pm, args.device, args.small)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
