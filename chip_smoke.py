#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits non-zero, printing
no result, without them.  Phases, each of which raises on failure:

  1. device: torch / CUDA versions and the card's name and power limit;
  2. build: compiles every kernel of the main path from nct_tpu_torch/csrc;
  3. kernels: the NN kernel against its plain PyTorch version at the four
     L0-L3 shapes of the 452x680 / 600x960 pair — index agreement >= 99%,
     distance at the kernel's match <= the plain minimum + 1e-3, and
     bitwise equality on integer-valued features with exact ties — with
     CUDA-event times of both;
  4. slice: ``transfer_pair`` under the default Config on the seeded
     452x680 / 600x960 pair with seeded VGG-19 weights, one cold and three
     warm runs, 4 kernel launches per pair; plus a small pair run on the
     card and on the CPU (plain path), which must agree.

The line before the last holds {"kernels": [...]}, the one before it the
card's name and power limit; the last line is {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

CONTENT_HW = (452, 680)
STYLE_HW = (600, 960)
# (Ha, Wa, Hb, Wb, C) of the exact-NN levels L0-L3 at the pair above.
NN_SHAPES = (
    (29, 43, 38, 60, 512),
    (57, 85, 75, 120, 512),
    (113, 170, 150, 240, 256),
    (226, 340, 300, 480, 128),
)
AGREE_MIN = 0.99      # share of equal indices, kernel vs plain
DIST_TOL = 1e-3       # distance at the kernel's match vs the plain minimum
# card vs CPU on the small pair: values within 2 LSB.  Summation order
# differs (cuDNN, the kernel, reductions), which moves near-tied matches;
# the JAX package's own fused-vs-staged test allows 95%.
SMALL_WITHIN2_MIN = 0.95


def log(msg: str) -> None:
    print(msg, flush=True)


def device_info(torch) -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(0), smi


def build_kernels() -> None:
    from nct_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build("nn_bidir")
    log(f"[build] nn_bidir.cu -> {path} in {time.perf_counter() - t0:.1f} s")
    with open(path[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "smem" in line or "spill" in line:
                log("[build]   " + line.strip())


def _features(torch, gen, h, w, c, integer: bool):
    """Seeded post-ReLU-like L2-normalised features, or integer-valued ones
    drawn from a 3-vector palette in {-2..2} (many exact ties)."""
    if integer:
        palette = torch.randint(-2, 3, (3, c), generator=gen).float()
        pick = torch.randint(0, 3, (h, w), generator=gen)
        return palette[pick].cuda()
    x = torch.relu(torch.randn(h, w, c, generator=gen)).cuda()
    return x / torch.clamp(x.norm(dim=-1, keepdim=True), min=1e-12)


def _time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(torch) -> dict:
    from nct_tpu_torch.ops import cuda_nn
    from nct_tpu_torch.ops.exact_nn import nn_bidir_tables_plain

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in full f32
    gen = torch.Generator().manual_seed(0)
    tot_ms = tot_plain = max_err = 0.0
    for lvl, (ha, wa, hb, wb, c) in enumerate(NN_SHAPES):
        na, nb = ha * wa, hb * wb
        for integer in (False, True):
            fa, ma = cuda_nn.padded_tables(
                _features(torch, gen, ha, wa, c, integer), 3)
            fb, mb = cuda_nn.padded_tables(
                _features(torch, gen, hb, wb, c, integer), 3)
            got = cuda_nn.nn_bidir_tables(fa, ma, fb, mb)
            torch.cuda.synchronize()
            # the plain version on the same tables (masks as 0/1 columns)
            ma01 = ((ma[:, None] >> torch.arange(9, device="cuda")) & 1).float()
            mb01 = ((mb[:, None] >> torch.arange(9, device="cuda")) & 1).float()
            ref = nn_bidir_tables_plain(fa, ma01, fb, mb01)
            d_ab, i_ab, d_ba, i_ba = (t for t in got)
            r_dab, r_iab, r_dba, r_iba = ref
            d_ab, i_ab, r_dab, r_iab = (t[:na] for t in (d_ab, i_ab, r_dab, r_iab))
            d_ba, i_ba, r_dba, r_iba = (t[:nb] for t in (d_ba, i_ba, r_dba, r_iba))
            if integer:
                same = (torch.equal(i_ab, r_iab) and torch.equal(i_ba, r_iba)
                        and torch.equal(d_ab, r_dab) and torch.equal(d_ba, r_dba))
                log(f"[kernel] L{lvl} integer case: bitwise equal={same} "
                    f"({r_dab.unique().numel()} distinct row minima over "
                    f"{na} rows)")
                if not same:
                    raise AssertionError(f"L{lvl}: integer case not bitwise equal")
                continue
            agree_ab = (i_ab == r_iab).float().mean().item()
            agree_ba = (i_ba == r_iba).float().mean().item()

            def at_match(f_from, m_from, f_to, m_to, idx, n):
                """f32 distance at the kernel's matches, row by row."""
                dots = (f_from[:n].float() * f_to[idx].float()).sum(-1)
                cnt = (m_from[:n] * m_to[idx]).sum(-1)
                return torch.where(cnt > 0, -dots / cnt.clamp(min=1),
                                   torch.full_like(dots, float("inf")))
            m_ab = at_match(fa, ma01, fb, mb01, i_ab, na)
            m_ba = at_match(fb, mb01, fa, ma01, i_ba, nb)
            slack = max((m_ab - r_dab).max().item(), (m_ba - r_dba).max().item())
            err = max((d_ab - r_dab).abs().max().item(),
                      (d_ba - r_dba).abs().max().item())
            ms = _time_ms(torch, lambda: cuda_nn.nn_bidir_tables(fa, ma, fb, mb), 3)
            plain = _time_ms(
                torch, lambda: nn_bidir_tables_plain(fa, ma01, fb, mb01), 3)
            flops = 2.0 * na * nb * (9 * c + 9)
            log(f"[kernel] L{lvl} Na={na} Nb={nb} C={c}: agree a->b {agree_ab:.5f} "
                f"b->a {agree_ba:.5f}; match slack {slack:.2e}; max |d err| "
                f"{err:.2e}; kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                f"plain {plain:.3f} ms")
            if min(agree_ab, agree_ba) < AGREE_MIN or slack > DIST_TOL:
                raise AssertionError(f"L{lvl}: kernel disagrees with plain")
            tot_ms += ms
            tot_plain += plain
            max_err = max(max_err, err)
    return {"name": "nn_bidir", "route": "cuda",
            "source": "nct_tpu_torch/csrc/nn_bidir.cu",
            "replaces": "nct_tpu/ops/pallas_nn.py:86",
            "launches": 0, "max_abs_err": max_err,
            "ms": tot_ms, "plain_ms": tot_plain}


def _pair(torch, gen, hw_c, hw_s, smooth: bool):
    """Seeded uint8 BGR content/style pair; ``smooth`` low-pass fields
    (bilinear-upsampled 8x8 noise) instead of white noise."""
    out = []
    for h, w in (hw_c, hw_s):
        if smooth:
            x = torch.rand(1, 3, 8, 8, generator=gen) * 255.0
            x = torch.nn.functional.interpolate(x, size=(h, w), mode="bilinear",
                                                align_corners=False)[0]
            img = x.permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
        else:
            img = torch.randint(0, 256, (h, w, 3), generator=gen,
                                dtype=torch.uint8)
        out.append(img.numpy())
    return out


def check_slice(torch) -> int:
    """The default-Config slice on the card; returns the kernel launches of
    the cold run."""
    from nct_tpu_torch import Config, pipeline
    from nct_tpu_torch.models import vgg19
    from nct_tpu_torch.ops import cuda_nn

    gen = torch.Generator().manual_seed(0)
    model = vgg19.init_params(torch.Generator().manual_seed(19)).cuda()
    config = Config()
    cnt, stl = _pair(torch, gen, CONTENT_HW, STYLE_HW, smooth=False)
    mp = CONTENT_HW[0] * CONTENT_HW[1] / 1e6
    per_pair = config.exact_nn_levels

    times, launches = [], []
    torch.cuda.reset_peak_memory_stats()
    for run in range(4):
        torch.cuda.synchronize()
        cuda_nn.LAUNCHES = 0
        t0 = time.perf_counter()
        out, trace = pipeline.transfer_pair(model, cnt, stl, 2.0, config,
                                            seed=7, return_intermediates=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(cuda_nn.LAUNCHES)
        log(f"[slice] run {run} ({'cold' if run == 0 else 'warm'}): "
            f"{times[-1]:.3f} s, {cuda_nn.LAUNCHES} kernel launches")
        if tuple(out.shape) != (*CONTENT_HW, 3) or out.dtype != torch.uint8:
            raise AssertionError(f"bad output {tuple(out.shape)} {out.dtype}")
        if int(out.max()) == int(out.min()):
            raise AssertionError("constant output")
        for tr in trace:
            for key in ("a", "b", "bds_err"):
                if not bool(torch.isfinite(tr[key]).all()):
                    raise AssertionError(f"non-finite {key} at L{tr['level']}")
        if cuda_nn.LAUNCHES != per_pair:
            raise AssertionError(f"{cuda_nn.LAUNCHES} kernel launches, "
                                 f"expected {per_pair} (L0-L3)")
    warm = statistics.median(times[1:])
    log(f"[slice] 452x680 / 600x960 default Config: cold {times[0]:.3f} s, "
        f"warm median {warm:.3f} s ({mp / warm:.4f} MP/s), "
        f"nl iters {[int(t['nl_iters']) for t in trace]}, "
        f"wls iters {[int(t['wls_iters']) for t in trace]}, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # small smooth pair: the card path against the CPU path of the port
    cnt_s, stl_s = _pair(torch, gen, (64, 80), (72, 88), smooth=True)
    small = Config(feature_dtype="float32", cg_tol=0.0)
    got = pipeline.transfer_pair(model, cnt_s, stl_s, 2.0, small, seed=3)
    ref = pipeline.transfer_pair(vgg19.init_params(
        torch.Generator().manual_seed(19)), cnt_s, stl_s, 2.0, small, seed=3,
        device="cpu")
    diff = (got.cpu().int() - ref.int()).abs()
    within = (diff <= 2).float().mean().item()
    log(f"[slice] 64x80 / 72x88 smooth pair, card vs CPU: <=2 LSB at "
        f"{within:.4f} of values, mean |diff| {diff.float().mean().item():.4f}")
    if within < SMALL_WITHIN2_MIN:
        raise AssertionError("card and CPU paths disagree on the small pair")
    return launches[0]


def main() -> int:
    import torch

    import nct_tpu_torch  # noqa: F401  (fails here when run outside the repo)

    kind, smi = device_info(torch)
    build_kernels()
    record = check_kernels(torch)
    record["launches"] = check_slice(torch)
    log(json.dumps({"kernels": [record]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
