"""End-to-end benchmark of the port: the 5-level pipeline on one pair
(port of ``bench.py``).

    python -m nct_tpu_torch.tools.bench [--size N] [--reps N] [--no-scan]
        [--device cuda|cpu] [--small]

Runs ``pipeline.transfer_pair`` under the default ``Config`` with the seeded
VGG-19 (``vgg19.init_params`` of generator seed 19) and seed 7: one cold
call (cuDNN plans, allocator growth), then ``reps`` warm calls, each ending
in ``torch.cuda.synchronize()`` and read on the host clock.  Then, unless
``--no-scan``, one warm and one timed scan batch (``parallel.batch``,
``mode="scan"``) of the pair repeated 4 times with seed 7.  Prints one JSON
object as the last line: ``bench.py``'s keys (``metric``, ``value`` in
MP/s, ``unit``, ``median_s``, ``reps_s``, ``scan_mps``,
``analytic_gflops``, ``analytic_hbm_gb``, ``mfu``, ``hbm_frac``, and
``vs_baseline``, always null: the JAX value divides by a TPU target),
then ``p10_s``, ``p90_s``, ``n_reps``, ``cold_s``, ``peak_mem_gib``,
``geometry``, ``nn_bidir_launches_per_pair`` (counted in each pair),
``nn_bidir_launches`` (counted over the whole run, scan included),
``device``, ``output_sha256`` and ``correct``.  The tool raises, and
prints no result, when an output check fails (shape, type, finite and not
constant; every warm output bitwise the cold one; ``exact_nn_levels``
kernel launches in every pair on the card, none on the CPU; every scan
item bitwise the single pair).

The pair is ``bench.py``'s seeded fallback (content 452x680, style
600x960).  ``--size`` fits both images to that long side: larger images
are capped as the CLI caps them, smaller ones upscaled bilinearly (the
JAX tool upscales only its demo images; the fallback there ignores the
size).  ``--device`` defaults to ``cuda`` and fails without a card;
``--small`` runs a 32 px pair so that a CPU test can drive the tool.

This module also holds the input and timing helpers of the other
benchmark tools (``bench_batch``, ``bench_serving``, ``bench_sequence``,
``roofline``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from nct_tpu_torch import pipeline
from nct_tpu_torch.config import Config
from nct_tpu_torch.io import cap_max_size
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops import cuda_nn
from nct_tpu_torch.ops.resize import resize_bilinear
from nct_tpu_torch.parallel.batch import make_batch_transfer
from nct_tpu_torch.utils import flops

SEED = 7            # the pipeline seed (PRNGKey(7) in the JAX tool)
MODEL_SEED = 19     # the seeded VGG-19 of chip_smoke.py
BDS_WEIGHT = 2.0
SCAN_ITEMS = 4
SMALL_SIZE = 32     # --small: the pair fitted to 32 px (21x32 / 20x32)


# ---- inputs -------------------------------------------------------------

def synthetic_pair() -> tuple[np.ndarray, np.ndarray]:
    """``bench.py``'s fallback pair, bitwise: content 452x680, style
    600x960, uint8 BGR from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    cnt = rng.integers(0, 256, (452, 680, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (600, 960, 3)).astype(np.uint8)
    return cnt, stl


def _fit_to_size(img: np.ndarray, size: int) -> np.ndarray:
    """Cap the long side to ``size`` (``io.cap_max_size``), or upscale it
    bilinearly to exactly ``size`` (``bench.py:43-57``)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if max(h, w) >= size:
        return np.asarray(cap_max_size(img, size))
    scale = size / max(h, w)
    out = resize_bilinear(torch.from_numpy(np.ascontiguousarray(img)),
                          int(round(h * scale)), int(round(w * scale)))
    # the resize of a uint8 image already rounds to uint8, as JAX's does
    return out.numpy().astype(np.uint8)


def load_pair(size: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The benchmark pair, ``synthetic_pair()``, both images fitted to
    ``size`` when it is given."""
    cnt, stl = synthetic_pair()
    if size is not None:
        cnt, stl = _fit_to_size(cnt, size), _fit_to_size(stl, size)
    return cnt, stl


# ---- device, model, timing ----------------------------------------------

def resolve_device(device: torch.device | str) -> torch.device:
    """``device``, a card's with its index (``cuda`` is the current card);
    raises RuntimeError for ``cuda`` without a card (the tools never fall
    back to the CPU unasked)."""
    device = pipeline._resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_record(device: torch.device) -> dict:
    """The card's name and power limit (as ``nvidia-smi`` prints it), or
    {"name": "cpu"}."""
    if device.type != "cuda":
        return {"name": "cpu"}
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
         f"--id={device.index}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return {"name": torch.cuda.get_device_name(device), "power_limit": limit}


def seeded_model(device: torch.device) -> vgg19.VGG19:
    return vgg19.init_params(
        torch.Generator().manual_seed(MODEL_SEED)).to(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device: torch.device):
    """(fn(), host seconds until the device has finished it)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def spread(times: list[float]) -> dict:
    """Median, 10th and 90th percentiles (linear) of ``times``, in s."""
    return {"median_s": statistics.median(times),
            "p10_s": float(np.percentile(times, 10)),
            "p90_s": float(np.percentile(times, 90))}


def launched(fn):
    """(fn(), the ``nn_bidir`` kernel launches it made).  The counter is
    read, not reset, so a caller's count spans every call."""
    before = cuda_nn.LAUNCHES["nn_bidir"]
    out = fn()
    return out, cuda_nn.LAUNCHES["nn_bidir"] - before


def expected_launches(config: Config, device: torch.device) -> int:
    """``nn_bidir`` launches per pair: one per exact level on the card;
    the CPU runs the plain version and launches nothing."""
    return config.exact_nn_levels if device.type == "cuda" else 0


def check_image(out: torch.Tensor, hw: tuple[int, int]) -> None:
    """Raise unless ``out`` is a [*hw, 3] uint8 image (so finite) that is
    not constant."""
    if tuple(out.shape[-3:]) != (*hw, 3) or out.dtype != torch.uint8:
        raise AssertionError(f"bad output {tuple(out.shape)} {out.dtype}, "
                             f"expected [..., {hw[0]}, {hw[1]}, 3] uint8")
    if int(out.max()) == int(out.min()):
        raise AssertionError("constant output")


def geometry(cnt: np.ndarray, stl: np.ndarray) -> dict:
    return {"content": list(cnt.shape[:2]), "style": list(stl.shape[:2])}


# ---- the benchmark ------------------------------------------------------

def run(size: int | None = None, reps: int = 10, scan: bool = True,
        device: torch.device | str = "cuda", small: bool = False) -> dict:
    """Benchmark one pair; returns the result dict (see the module doc)."""
    device = resolve_device(device)
    if reps < 1:
        raise ValueError(f"reps={reps}: at least one warm rep")
    cnt, stl = load_pair(SMALL_SIZE if small else size)
    h, w = cnt.shape[:2]
    config = Config()
    model = seeded_model(device)
    cnt_d = torch.from_numpy(cnt).to(device)
    stl_d = torch.from_numpy(stl).to(device)
    want = expected_launches(config, device)

    def transfer():
        return pipeline.transfer_pair(model, cnt_d, stl_d, BDS_WEIGHT,
                                      config, seed=SEED, device=device)

    per_pair = []

    def pair():
        (out, dt), n = launched(lambda: timed(transfer, device))
        if n != want:
            raise AssertionError(f"{n} nn_bidir launches in a pair, "
                                 f"expected {want}")
        per_pair.append(n)
        return out, dt

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    at_start = cuda_nn.LAUNCHES["nn_bidir"]
    first, cold = pair()
    check_image(first, (h, w))
    reps_s = []
    for _ in range(reps):
        out, dt = pair()
        reps_s.append(dt)
        if not torch.equal(out, first):
            raise AssertionError("a warm output differs from the cold one")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda else None
    stats = spread(reps_s)
    dt = stats["median_s"]
    mp = h * w / 1e6

    scan_mps = None
    if scan:
        step = make_batch_transfer(config, mode="scan", device=device)
        cnt_b = cnt_d.expand((SCAN_ITEMS,) + cnt_d.shape)
        stl_b = stl_d.expand((SCAN_ITEMS,) + stl_d.shape)
        seeds = [SEED] * SCAN_ITEMS
        step(model, cnt_b, stl_b, seeds, BDS_WEIGHT)          # warm
        out_b, scan_dt = timed(
            lambda: step(model, cnt_b, stl_b, seeds, BDS_WEIGHT), device)
        if not all(torch.equal(o, first) for o in out_b):
            raise AssertionError("a scan item differs from the single pair")
        scan_mps = SCAN_ITEMS * mp / scan_dt

    launches = cuda_nn.LAUNCHES["nn_bidir"] - at_start
    total = flops.pipeline_counts(h, w, *stl.shape[:2], config)["total"]
    dev = device_record(device)
    mfu = hbm_frac = None
    if cuda:
        peak_flops, peak_bytes = flops.device_peaks(dev["name"])
        mfu = flops.mfu(total["flops"], dt, peak_flops)
        hbm_frac = total["bytes"] / (dt * peak_bytes)
    return {
        "metric": "e2e_megapixels_per_sec",
        "value": mp / dt,
        "unit": f"MP/s on one {dev['name']} (pair {w}x{h}, style "
                f"{stl.shape[1]}x{stl.shape[0]}, 5 levels, median of "
                f"{reps} warm reps)",
        "vs_baseline": None,
        "median_s": dt,
        "reps_s": reps_s,
        "scan_mps": scan_mps,
        "analytic_gflops": total["flops"] / 1e9,
        "analytic_hbm_gb": total["bytes"] / 1e9,
        "mfu": mfu,
        "hbm_frac": hbm_frac,
        "p10_s": stats["p10_s"],
        "p90_s": stats["p90_s"],
        "n_reps": reps,
        "cold_s": cold,
        "peak_mem_gib": peak,
        "geometry": geometry(cnt, stl),
        "nn_bidir_launches_per_pair": per_pair[0],
        "nn_bidir_launches": launches,
        "device": dev,
        "output_sha256": hashlib.sha256(
            first.cpu().numpy().tobytes()).hexdigest(),
        "correct": True,
    }


def add_device_args(p: argparse.ArgumentParser) -> None:
    """``--device`` and ``--small``, as every benchmark tool takes them."""
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without a card)")
    p.add_argument("--small", action="store_true",
                   help="a 32 px pair, for driving the tool in a CPU test")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=None,
                   help="fit both images to this long side (default: the "
                        "pair as it is, 452x680 / 600x960)")
    p.add_argument("--reps", type=int, default=10,
                   help="timed warm reps after the cold call")
    p.add_argument("--no-scan", dest="scan", action="store_false",
                   help="skip the scan batch of 4 (scan_mps null)")
    add_device_args(p)
    args = p.parse_args(argv)
    result = run(args.size, args.reps, args.scan, args.device, args.small)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
