#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits non-zero, printing
no result, without them.  Phases, each of which raises on failure:

  1. device: torch / CUDA versions and the card's name and power limit;
  2. build: compiles every kernel from nct_tpu_torch/csrc and prints
     ptxas's register, spill and wgmma lines and each kernel's resident
     blocks per SM;
  3. kernels: the bidirectional NN kernel against its plain PyTorch version
     at the four L0-L3 shapes of the 452x680 / 600x960 pair — index
     agreement >= 99%, distance at the kernel's match <= the plain minimum
     + 1e-3, and bitwise equality on integer-valued features with exact
     ties — with CUDA-event times of both (TFLOP/s and share of the bound
     per shape) and of one cuBLAS bf16 GEMM over the same tables (the
     yardstick of the products alone: no single PyTorch call computes the
     masked argmin);
  3b. the directed NN kernel at the same shapes and checks, and bitwise
     equal to the bidirectional kernel's row result on the same tables;
  3c. ``conv3x3`` (VGG-19's float32 3x3 convolution, one fmaf chain per
     output): every tile, with and without the fused ReLU, bitwise
     ``conv3x3_chain`` (the chain in correctly rounded steps) and each
     other at ``conv_chain_cases()``; then against ``F.conv2d`` with TF32
     off at every VGG-19 layer shape of the 452x680 and 665x1000 images
     (rtol 1e-5, atol 1e-5 of the largest output), with the tile the rule
     picks, its blocks and resident blocks per SM, CUDA-event times of
     every tile, the plain version, one ``F.conv2d`` call with the bias
     and the float32 bound per layer, and the float32 VGG forward of each
     geometry's pair through the kernel and through cuDNN;
  4. slice: ``transfer_pair`` under the default Config on the seeded
     452x680 / 600x960 pair with seeded VGG-19 weights, one cold and three
     warm runs, 4 kernel launches per pair, every output bitwise equal to
     the first; plus a small pair run on the card and on the CPU (plain
     path), which must agree;
  5. PatchMatch: ``Config(fine_strategy="patchmatch")`` on the same pair
     (exact L0-L3, PatchMatch at L4), one cold and one warm run with the
     checks of phase 4; then a 2-frame ``transfer_sequence`` under
     ``Config(exact_nn_levels=0, fine_strategy="patchmatch")``, whose
     second frame must start from the first frame's level-0 fields;
  6. profiler: ``nct_tpu_torch.tools.profile_stages`` at its real shapes,
     the path of the directed kernel;
  7. solver variants: (7a) ``Config.reference_parity()`` on the same pair
     (PatchMatch at every level, block-Jacobi PCG), one cold run, no NN
     kernel launch, and its stage split over one more (warm) pair; (7b)
     ``Config(knn_memberships=3, nl_transpose="scatter",
     wls_precond="jacobi")``, one cold and one warm run, 4 ``nn_bidir``
     launches per pair (the warm output bitwise equal to the cold one);
     (7c) on the captured systems
     ``tests/fixtures/nl_L{0,1}.npz``: the scatter and tables transposes at
     an ample ``in_cap`` are one operator, the block-Jacobi and mg solves at
     ``retune.CONVERGED_ITERS`` give one colour transform, and the residual
     curve over the default caps falls;
  8. serving: (a) ``python3 -m nct_tpu_torch.cli --device cuda`` in a new
     process over a pairs.txt of the smooth pair written as PNG (a 3-field
     line, a 2-field line, a line naming a missing file): the missing pair
     is skipped, the kernel library is reused, and each output PNG is
     bitwise equal to an in-process ``transfer_pair``; (b) a scan batch
     (``parallel.batch``) of 4 seeded pairs, each item bitwise equal to its
     own ``transfer_pair``, 4 x ``exact_nn_levels`` kernel launches; (c)
     the analytic FLOP / byte counts of the pair (``utils.flops``) and the
     MFU and memory-rate share of phase 4's warm median; (d) the SSIM of
     the card's output against the CPU's on phase 4's small pair (>= 0.98);
  9. vmap batch: (a) both NN kernel instances launched once over a batch
     of 4 items at each L0-L3 shape, each item bitwise equal to its own
     single launch on random and on integer features, with CUDA-event
     times against 4 single launches, the bound (4 x the single bound)
     and a cuBLAS batched GEMM (``torch.bmm``) over the same tables;
     (b) ``make_batch_transfer(Config(), mode="vmap")`` on phase 8b's 4
     pairs, one cold (traced) and one warm run, every output bitwise
     equal to the first, 4 ``nn_bidir`` launches of 16 items per bucket, a
     stage split of one more bucket, and each item against 8b's scan
     item: the same solver iteration counts per level, within 2 LSB at
     >= 95% of values and a mean difference <= 0.5 (the JAX package's
     batch contract), with the seconds per pair of both; (c)
     ``nct_tpu_torch.tools.profile_batch_stages`` at its real shapes,
     b = 1 and b = 4;
 10. vmap of every single-card Config, on phase 8b's pairs, each bucket
     beside a scan of the same items in the same call and held to 9b's
     checks: (a) ``Config(fine_strategy="patchmatch")``, B = 4 (4
     ``nn_bidir`` launches of 16 items, batched PatchMatch at L4); (b)
     ``Config.reference_parity()``, B = 2 (PatchMatch at every level,
     block-Jacobi at tol 1e-6; no NN launch); (c)
     ``Config(knn_memberships=3, nl_transpose="scatter",
     wls_precond="jacobi")``, B = 4 (4 launches of 16 items, the folded
     P = 3 merge, the scatter transpose, Jacobi WLS); one cold bucket
     each;
 11. mesh: 2 ranks spawned by ``parallel.mesh.launch``, both on the one
     card (gloo): (a) ``ring_exact_nn`` a -> b and b -> a at the L0-L3
     shapes, random and integer features, bitwise equal to
     ``exact_nn_bidir`` on every rank with 2 x 2 ``nn_directed`` launches
     per level, and at L3 the CUDA-event ms per ring step, the ring's ms
     per direction beside one ``nn_bidir``, the host staging and the
     matcher's peak bytes beside the single-card search's; (b) the default
     pair under ``Config(space_mesh=mesh, vgg_compute_dtype="float32")``,
     which runs every stage on row bands (``pipeline.row_sharded``), one
     cold and one warm run (warm bitwise cold), 16 ``nn_directed``, no ``nn_bidir`` and 44 ``conv3x3``
     launches per pair per rank, both ranks equal, bitwise the
     single-process pair, with the (nl, wls) iterations of both; (c)
     ``make_batch_transfer(
     Config(), mesh)`` over a 2x1 data mesh on phase 8b's 4 pairs, every
     item bitwise its 8b scan item; (d) a vmap bucket of 2 under the 1x2
     space mesh (row bands), each ring step one launch of 2 items, each
     item bitwise its single-process item under float32 VGG; (c) one cold
     and two warm runs, every warm output bitwise the cold one, (d) one
     cold and one warm run, warm bitwise cold; (e) (d)'s bucket with ``ring_nn=False`` (each
     rank one ``nn_bidir`` launch of 2 items per exact level on the
     gathered levels), one cold run, bitwise (d)'s; the band exchanges'
     calls and host ms per rank;
 12. Caffe framework (``nct_tpu_torch.nn``), float32 with TF32 off:
     (a) the VGG_ILSVRC_19_layers deploy net at its published widths
     (10x3x224x224, 143.7M parameters), written with the port's NetSpec,
     convolutions from ``models.vgg19.init_params`` and fc6-8 from
     seeded fillers: its conv1_1..conv5_1 blobs against ``models.vgg19``'s
     taps (max relative error <= 2e-3), the card against the CPU on one
     224 crop (fc8 and prob within 2e-3 of the largest value, the same
     top-5), ``Classifier.predict`` on two PNGs with 10-crop
     oversampling (each prob row sums to 1 within 1e-5), and the warm
     median ms of a batch of 10, images/s and TFLOP/s (and again with
     ``cudnn.benchmark`` on); (b) the
     bvlc_reference_caffenet deploy net (10x3x227x227: grouped
     convolutions, LRN, InnerProduct on a 4-D bottom) card against CPU
     and its warm ms; (c) ``tools.caffe_tool time`` on (a)'s net (CUDA
     events per layer and the whole forward) and ``caffe_tool test`` on a
     DummyData -> InnerProduct -> SoftmaxWithLoss + Accuracy net, 5
     iterations; (d) every case of ``tests/torch_caffe_cases.py`` (each
     layer type of the registry and the extra pooling / LRN modes) card
     against CPU (rtol 1e-4, atol 1e-5); HDF5Output is not run (the card's
     machine has no h5py);
 13. JPEG and training: (a) every fixture of ``tests/fixtures/jpeg``
     decoded by ``data.jpeg`` (built from csrc/jpeg_decode.cpp with the
     host compiler in phase 2) bitwise the sha256 of Pillow's decode in
     ``digests.json``, and the host decode ms (and ms per megapixel) of the
     452x680 / 600x960 pair, baseline and progressive; (b) the CLI
     (``--device cuda``, default Config) on that pair and its progressive
     twin and on the same pixels written as PNG, one process, each output
     bitwise its PNG twin's, with the seconds per pair; (c) CaffeNet's
     train_val at its published widths and solver (SGD, base_lr 0.01,
     momentum 0.9, weight_decay 0.0005, step policy), its LMDB layer
     replaced by ImageData over the 16 fixture JPEGs (256x256, crop 227,
     mirror, batch 256): 12 NetSolver iterations with finite losses, 12
     steps on one resident batch whose loss must fall, the warm CUDA-event
     ms per iteration device only and with the host feed, images/s and
     TFLOP/s at 3 x the forward FLOPs, then the card against the CPU over
     3 steps at batch 8 with CPU-drawn Dropout masks (losses within rtol
     1e-4, TF32 off); (d) ``caffe_tool train --deterministic`` in a new
     process with a snapshot at iteration 4 of 8, and a second one
     resuming from it: its params and history bitwise the uninterrupted
     run's; a third resumes without ``--deterministic``: within rtol 1e-4
     atol 1e-6; (e) over a 2x1 data mesh (2 gloo ranks on the card)
     against this process (rtol 1e-6): one step without and with Dropout,
     and 3 NetSolver iterations over ImageData with Dropout in which each
     rank decodes half of every batch;
 14. data sources and dataset tools, in a temporary directory removed at
     the end: (a) ``tools.convert_imageset --backend records`` over a
     3,072-line list of the 16 fixture JPEGs (labels i % 1000, 256x256,
     shuffled, shard size 2048: two shards) and ``tools.compute_image_mean``
     over it, with seconds, images/s and shard bytes; (b) CaffeNet's
     train_val at its published widths from its own ``Data`` layer over
     those shards (crop 227, mirror, the mean file, batch 256): 12 logged
     NetSolver iterations with finite losses, the warm CUDA-event ms per
     iteration with the feed and on a resident batch beside 13c's ImageData
     figure, the host ms per batch of the Data and ImageData sources, then
     the card against the CPU over 3 steps at batch 8 (rtol 1e-4); (c) the
     first 64 records exported by ``tools.convert_db`` records2lmdb and
     records2leveldb and by ``write_leveldb(..., as_table=True)``: a Data
     layer over each gives the shards' batches bitwise (batch 32, 4
     batches, wrapping); (d) CaffeNet's body with a 21-class fc8 fed by
     WindowData (context_pad 16, crop 227, batch 128) for 5 iterations with
     finite losses, and card against CPU over 2 steps at batch 8; (e) 3
     NetSolver iterations over the Data source with Dropout on a 2x1 data
     mesh (2 gloo ranks) against this process (rtol 1e-6), each rank
     copying half of every batch, and an in-process snapshot at iteration
     4 of 8 under ``cudnn.deterministic`` whose resume is bitwise the
     uninterrupted run and reads no used batch again; (f)
     ``tools.parse_log`` over (b)'s log (12 train rows),
     ``tools.upgrade_proto`` and ``tools.draw_net`` on (b)'s train_val.
     HDF5 is left to the CPU tests (the card's machine has no h5py).  The
     training path adds no kernel: its products are ``F.conv2d`` /
     ``F.linear`` and autograd's;
 15. benchmark tools (``nct_tpu_torch/tools``), seeded VGG-19 at full
     width.  First ``nn_bidir`` against its plain version at the L0-L3
     shapes of the 700 and 1000 px pairs, random features (AGREE_MIN,
     DIST_TOL) and integer ones (bitwise), as phase 3 at the 452 px
     pair's.  Then (a) ``python3 -m nct_tpu_torch.tools.bench --reps 1``
     in a new process on ``bench.py``'s 452x680 / 600x960 pair (one cold
     and one warm pair, a warm and a timed scan batch of 4), its last line
     parsed, ``correct`` true; (b) ``bench.run`` at 700 px (465x700 /
     437x700: the stage-1 subset in one direction) and 1000 px (665x1000
     / 625x1000: both directions), one cold and one warm pair each, with
     peak device memory, the counts set to 0 before each run; in (a) and
     (b) 4 ``nn_bidir`` launches in each pair and 4 per pair in the run;
     (c) ``bench_batch`` over a bucket of 4, vmap and scan; (d)
     ``bench_serving`` of 2 requests, sync, pipelined and on a 1x1 mesh;
     (e) ``bench_sequence`` of 2 frames, the default Config and
     ``exact_nn_levels=0``; (f) the ``roofline`` table.  Every tool checks
     its own outputs and raises; each prints its JSON line.
     ``nn_bidir``'s record gains the shapes held against plain and the
     bench's launches by geometry;
 16. row bands at full width: the bench's 665x1000 / 625x1000 pair under
     ``Config(space_mesh=mesh, vgg_compute_dtype="float32")`` over a 1x2
     mesh (2 gloo ranks on the card): one cold and one warm run, then a
     single-process run of the same call on rank 0; per rank the seconds,
     the launches (16 ``nn_directed``, no ``nn_bidir``), the host ms and
     calls of the halos, reductions, gathers and exchanges
     (``parallel.mesh.COMM``), ``max_memory_allocated`` in total and by
     stage (``StagePeaks`` wraps the pipeline's stage functions here) and
     the (nl, wls) iterations; the ranks equal, the warm run bitwise the
     cold one, each rank bitwise the single process and its peak at most
     0.65x the single process's; then one run over a
     1x4 mesh for the per-rank peaks;
 17. PatchMatch, block-Jacobi and Jacobi WLS on row bands, 2 gloo ranks
     on the card: (a) the float32 VGG taps over 1x2 row bands bitwise the
     whole image's at 120x160, 128x176, 452x680 and 600x960, and the
     120x160 / 128x176 white-noise pair of ``tests/test_torch_cuda.py``
     on 1x2 row bands bitwise the single process; then the bench's
     452x680 / 600x960 pair under ``Config.reference_parity`` (PatchMatch
     at every level, block-Jacobi nonlocal, mg WLS; no NN launch) and
     ``Config(fine_strategy="patchmatch", wls_precond="jacobi")`` (16
     ``nn_directed`` a rank, PatchMatch at L4, Jacobi WLS), float32 VGG,
     one cold 1x2 run each beside a single-process run on rank 0: ranks
     equal, bitwise the single process with its iterations, 44
     ``conv3x3`` launches, each rank's peak at most 0.65x the single
     process's, with the seconds, the exchanges' host ms and calls and
     the peak GiB by stage; then pm_jacobi over 1x4, one cold run for
     its per-rank peaks, every rank bitwise the 1x2 phase's
     single-process pair with its iterations;
 18. the P > 1 k-NN merge and short images on row bands: (a) the bench's
     452x680 / 600x960 pair under ``Config(knn_memberships=3)`` (float32
     VGG) over 1x2 (2 gloo ranks on the card), one cold run beside a
     single-process run on rank 0: ranks equal, bitwise the single
     process with its iterations, 16 ``nn_directed`` and 44 ``conv3x3``
     launches a rank, each rank's peak at most 0.65x the single
     process's, with the seconds, the exchanges' host ms and calls and
     the peak GiB by stage; (b) a 40x64 / 48x64 pair (3 units of 16 rows
     each) under the default Config over 1x4, so that rank 3 holds a band
     of zero rows at every grid: every rank bitwise the single process
     with its iterations, and each rank's launches those of its bands (a
     ring step launches only where its A band and the visiting B block
     hold rows, a convolution only on rows: none on rank 3); (c) in (a)'s
     world, the same pair under ``Config(knn_memberships=3,
     nl_transpose="scatter", wls_precond="jacobi")`` (the variants
     configuration: the scatter transpose on row bands), with (a)'s
     checks.
The line before the last holds {"kernels": [...]}, the one before it the
card's name and power limit; the last line is {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import math
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
# card vs CPU on the small pair: the contract of nct_tpu/utils/ssim.py
SMALL_SSIM_MIN = 0.98
# phase 9: batch of the kernel check, and the JAX package's batch contract
# (tests/test_parallel_batch.py) of a vmap item against its scan item
NN_BATCH = 4
# rows of one item's table whose masks phase 9a zeroes
TILE_ROWS_MASKED = 200
BATCH_LSB = 2
BATCH_WITHIN_MIN = 0.95
BATCH_MEAN_MAX = 0.5


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
    """Build every source of csrc/ at once, one compiler each: the CUDA
    kernels and the host JPEG decoder."""
    from concurrent.futures import ThreadPoolExecutor

    from nct_tpu_torch import _build

    t0 = time.perf_counter()
    names = ("nn_bidir", "conv3x3", "jpeg_decode")
    with ThreadPoolExecutor(len(names)) as pool:
        path, conv_path, jpeg_path = pool.map(_build.build, names)
    log(f"[build] nn_bidir.cu (instances nn_bidir, nn_directed) -> {path}, "
        f"conv3x3.cu -> {conv_path} and jpeg_decode.cpp (host) -> "
        f"{jpeg_path} in {time.perf_counter() - t0:.1f} s")
    wgmma_lines = 0
    for lib in (path, conv_path):
        with open(lib[:-3] + ".log") as f:
            for line in f:
                if any(w in line for w in ("registers", "smem", "spill",
                                           "wgmma", "Compiling entry")):
                    log("[build]   " + line.strip())
                    wgmma_lines += "wgmma" in line
    log(f"[build]   ptxas lines that mention wgmma: {wgmma_lines}")
    from nct_tpu_torch.ops import conv3x3, cuda_nn
    for name in ("nn_bidir", "nn_directed"):
        blocks, smem = cuda_nn.occupancy(name)
        log(f"[build]   {name}: {blocks} resident blocks per SM at {smem} B "
            f"of dynamic shared memory each")
    tiles = conv3x3.library_configs()
    for i, (t, want) in enumerate(zip(tiles, conv3x3.CONFIGS)):
        log(f"[build]   conv3x3 tile {i}: {t['rows']}x{t['cols']}x"
            f"{t['channels']}, {t['threads']} threads, {t['stages']} stages "
            f"of {t['smem']} B in all, {conv3x3.occupancy(i)} resident "
            f"blocks per SM (built for {t['min_blocks']})")
        if (len(tiles) != len(conv3x3.CONFIGS)
                or tuple(t[k] for k in want._fields) != tuple(want)):
            raise AssertionError(f"conv3x3 tile {i}: the library's {t} is "
                                 f"not ops/conv3x3.py's {want}")


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


def reset_counts() -> None:
    from nct_tpu_torch.ops import conv3x3, cuda_nn

    for name in cuda_nn.LAUNCHES:
        cuda_nn.LAUNCHES[name] = 0
        cuda_nn.LAUNCH_ITEMS[name] = 0
    conv3x3.LAUNCHES["conv3x3"] = 0


def _tables(torch, gen, shape, integer: bool):
    """Seeded patch tables of both images at one level shape (Ha, Wa, Hb,
    Wb, C), as the kernels take them and as the plain versions take them
    (masks as 0/1 columns): (fa, ma, fb, mb, ma01, mb01)."""
    from nct_tpu_torch.ops import cuda_nn

    ha, wa, hb, wb, c = shape
    fa, ma = cuda_nn.padded_tables(_features(torch, gen, ha, wa, c, integer), 3)
    fb, mb = cuda_nn.padded_tables(_features(torch, gen, hb, wb, c, integer), 3)
    bits = torch.arange(9, device="cuda")
    ma01 = ((ma[:, None] >> bits) & 1).float()
    mb01 = ((mb[:, None] >> bits) & 1).float()
    return fa, ma, fb, mb, ma01, mb01


def _at_match(torch, f_from, m_from, f_to, m_to, idx, n):
    """f32 distance at the kernel's matches, row by row."""
    dots = (f_from[:n].float() * f_to[idx].float()).sum(-1)
    cnt = (m_from[:n] * m_to[idx]).sum(-1)
    return torch.where(cnt > 0, -dots / cnt.clamp(min=1),
                       torch.full_like(dots, float("inf")))


def _bidir_vs_plain(torch, tab, got, ref, na: int, nb: int):
    """``nn_bidir``'s keys ``got`` against the plain ``ref`` on the tables
    ``tab``: (bitwise equal, least share of equal indices over the two
    directions, largest f32 distance at the kernel's match above the plain
    minimum, max |d err|)."""
    fa, _, fb, _, ma01, mb01 = tab
    d_ab, i_ab, r_dab, r_iab = (t[:na] for t in (got[0], got[1], ref[0], ref[1]))
    d_ba, i_ba, r_dba, r_iba = (t[:nb] for t in (got[2], got[3], ref[2], ref[3]))
    same = (torch.equal(i_ab, r_iab) and torch.equal(i_ba, r_iba)
            and torch.equal(d_ab, r_dab) and torch.equal(d_ba, r_dba))
    agree = min((i_ab == r_iab).float().mean().item(),
                (i_ba == r_iba).float().mean().item())
    m_ab = _at_match(torch, fa, ma01, fb, mb01, i_ab, na)
    m_ba = _at_match(torch, fb, mb01, fa, ma01, i_ba, nb)
    slack = max((m_ab - r_dab).max().item(), (m_ba - r_dba).max().item())
    err = max((d_ab - r_dab).abs().max().item(),
              (d_ba - r_dba).abs().max().item())
    return same, agree, slack, err


def _gemm_ms(torch, fa, fb) -> float:
    """CUDA-event time of the bf16 products alone: one cuBLAS ``torch.mm``
    per chunk of A rows, chunked so that the bf16 output fits 2 GiB."""
    rows = max(128, (2 ** 30 // (fb.shape[0] * 2)) // 128 * 128)
    out = torch.empty((rows, fb.shape[0]), dtype=torch.bfloat16,
                      device="cuda")
    fbt = fb.T

    def run():
        for a0 in range(0, fa.shape[0], rows):
            chunk = fa[a0:a0 + rows]
            torch.mm(chunk, fbt, out=out[:chunk.shape[0]])
    return _time_ms(torch, run, 3)


def _bound_ms(na, nb, c, directed: bool, peaks) -> float:
    """Least time for the work on the card: 2 Na Nb (9C + 9) operations at
    the bf16 rate against the tables read once and the keys written once;
    ``peaks`` = (FLOP/s, bytes/s) from ``utils.flops.device_peaks``."""
    flops = 2.0 * na * nb * (9 * c + 9)
    nbytes = (na + nb) * (9 * c * 2 + 4) + (na if directed else na + nb) * 8
    return max(flops / peaks[0], nbytes / peaks[1]) * 1e3


def check_kernels(torch) -> tuple[dict, dict]:
    """Phases 3 and 3b; returns the kernel records (launches filled in by
    the phases that drive their paths)."""
    from nct_tpu_torch.ops import cuda_nn
    from nct_tpu_torch.ops.exact_nn import (
        nn_bidir_tables_plain, nn_tables_plain,
    )
    from nct_tpu_torch.utils import flops as flops_mod

    peaks = flops_mod.device_peaks()
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in full f32
    gen = torch.Generator().manual_seed(0)
    rec = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "cublas_gemm_ms": 0.0, "max_abs_err": 0.0,
                  "ms_by_level": []}
           for name in ("nn_bidir", "nn_directed")}
    for lvl, (ha, wa, hb, wb, c) in enumerate(NN_SHAPES):
        na, nb = ha * wa, hb * wb
        for integer in (False, True):
            tab = _tables(torch, gen, NN_SHAPES[lvl], integer)
            fa, ma, fb, mb, ma01, mb01 = tab
            got = cuda_nn.nn_bidir_tables(fa, ma, fb, mb)
            got_dir = cuda_nn.nn_directed_tables(fa, ma, fb, mb)
            torch.cuda.synchronize()
            # the plain versions on the same tables
            ref = nn_bidir_tables_plain(fa, ma01, fb, mb01)
            ref_dir = nn_tables_plain(fa, ma01, fb, mb01)
            row_same = (torch.equal(got_dir[0], got[0])
                        and torch.equal(got_dir[1], got[1]))
            log(f"[directed] L{lvl} {'integer' if integer else 'random'} "
                f"case: bitwise equal to nn_bidir's row keys={row_same}")
            if not row_same:
                raise AssertionError(f"L{lvl}: nn_directed differs from the "
                                     f"row result of nn_bidir")
            same, agree, slack, err = _bidir_vs_plain(torch, tab, got, ref,
                                                      na, nb)
            dd_ab, di_ab = (t[:na] for t in got_dir)
            rd_ab, ri_ab = (t[:na] for t in ref_dir)
            if integer:
                same_dir = torch.equal(di_ab, ri_ab) and torch.equal(dd_ab, rd_ab)
                log(f"[kernel] L{lvl} integer case: bitwise equal={same}, "
                    f"directed bitwise equal={same_dir} "
                    f"({ref[0][:na].unique().numel()} distinct row minima "
                    f"over {na} rows)")
                if not (same and same_dir):
                    raise AssertionError(f"L{lvl}: integer case not bitwise equal")
                continue
            agree_dir = (di_ab == ri_ab).float().mean().item()
            m_dir = _at_match(torch, fa, ma01, fb, mb01, di_ab, na)
            slack_dir = (m_dir - rd_ab).max().item()
            err_dir = (dd_ab - rd_ab).abs().max().item()
            gemm = _gemm_ms(torch, fa, fb)
            flops = 2.0 * na * nb * (9 * c + 9)
            for name, kernel, plain, agree, slk, e in (
                    ("nn_bidir",
                     lambda: cuda_nn.nn_bidir_tables(fa, ma, fb, mb),
                     lambda: nn_bidir_tables_plain(fa, ma01, fb, mb01),
                     agree, slack, err),
                    ("nn_directed",
                     lambda: cuda_nn.nn_directed_tables(fa, ma, fb, mb),
                     lambda: nn_tables_plain(fa, ma01, fb, mb01),
                     agree_dir, slack_dir, err_dir)):
                ms = _time_ms(torch, kernel, 3)
                plain_ms = _time_ms(torch, plain, 3)
                bound = _bound_ms(na, nb, c, name == "nn_directed", peaks)
                log(f"[{name}] L{lvl} Na={na} Nb={nb} C={c}: agree {agree:.5f}; "
                    f"match slack {slk:.2e}; max |d err| {e:.2e}; kernel "
                    f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                    f"{bound / ms:.3f} of bound {bound:.3f} ms), plain "
                    f"{plain_ms:.3f} ms, cuBLAS bf16 GEMM {gemm:.3f} ms")
                if agree < AGREE_MIN or slk > DIST_TOL:
                    raise AssertionError(f"L{lvl}: {name} disagrees with plain")
                r = rec[name]
                r["ms"] += ms
                r["ms_by_level"].append(ms)
                r["plain_ms"] += plain_ms
                r["bound_ms"] += bound
                r["cublas_gemm_ms"] += gemm
                r["max_abs_err"] = max(r["max_abs_err"], e)
    source = "nct_tpu_torch/csrc/nn_bidir.cu"
    design = "wgmma-cp.async-2cta"
    bidir = {"name": "nn_bidir", "route": "cuda", "source": source,
             "replaces": "nct_tpu/ops/pallas_nn.py:86", "launches": 0,
             **rec["nn_bidir"], "bound_by": "operations", "library_ms": None,
             "design": design}
    directed = {"name": "nn_directed", "route": "cuda", "source": source,
                "replaces": "nct_tpu/ops/pallas_nn.py:33", "launches": 0,
                **rec["nn_directed"], "bound_by": "operations",
                "library_ms": None, "design": design}
    return bidir, directed


# phase 3c: conv3x3 at every VGG-19 layer of the 452x680 and 665x1000
# images (the default pair's and the bench's 1000 px content), and the
# float32 VGG forward of each geometry's pair (content and style to conv5_1)
CONV_GEOMETRIES = (((452, 680), (600, 960)), ((665, 1000), (625, 1000)))
CONV_RTOL = 1e-5       # rtol, and atol as a share of the largest output
CONV_REPS = 5
CONV_DESIGN = ("one fmaf chain per output over (ci, ky, kx) ascending; a "
               "thread owns 1-2 rows x 4 consecutive columns x 4-8 "
               "channels and runs every tap from registers (6 input values "
               "a row, broadcast float4 weights); a 2-stage cp.async ring "
               "of 8-channel chunks with offsets computed once; three tiles "
               "(8x32x32, 8x16x32, 8x16x16; 128 threads) picked by a fixed "
               "rule on the grid's fill; bias and ReLU in the epilogue")


def conv_chain_cases() -> list[tuple[str, int, int, int, int, int]]:
    """(label, n, cin, cout, h, w) at which every tile of ``conv3x3`` is
    held bitwise to ``conv3x3_chain``: every VGG-19 layer of a ragged 61x93
    content (cin 3 at conv1_1; widths 93, 47, 24, 12, 6), a batch of 2, a
    one-row band, channel counts that fill no chunk and no tile (one not a
    multiple of 4), and conv1_2 and conv5_1 of 452x680."""
    from nct_tpu_torch.models import vgg19

    cases = []
    dims = vgg19.feature_dims(61, 93)
    cin = 3
    for name, cout in vgg19.VGG19_CONV_LAYERS:
        cases.append((f"61x93 {name}", 1, cin, cout) + dims[name])
        cin = cout
    return cases + [("n=2 at 31x47", 2, 64, 128, 31, 47),
                    ("one-row band of 85", 1, 512, 512, 1, 85),
                    ("cin 5, cout 6", 1, 5, 6, 9, 13),
                    ("cin 11, cout 70", 1, 11, 70, 17, 37),
                    ("452x680 conv1_2", 1, 64, 64, 452, 680),
                    ("452x680 conv5_1", 1, 512, 512, 29, 43)]


def conv_chain_check(torch, case, seed: int) -> dict:
    """Every tile of ``conv3x3`` with and without ReLU at one
    ``conv_chain_cases()`` case on the card: {(relu, tile): bitwise
    ``conv3x3_chain``}, and the other tiles' outputs bitwise tile 0's."""
    import torch.nn.functional as F

    from nct_tpu_torch.ops import conv3x3

    _, n, cin, cout, h, w = case
    gen = torch.Generator().manual_seed(seed)
    xp = F.pad(torch.randn(n, cin, h, w, generator=gen), (0, 0, 1, 1)).cuda()
    wt = (torch.randn(cout, cin, 3, 3, generator=gen)
          * math.sqrt(2.0 / (9 * cin))).cuda()
    b = (0.1 * torch.randn(cout, generator=gen)).cuda()
    wk = conv3x3.kernel_weight(wt)
    held = {}
    chain = conv3x3.conv3x3_chain(xp, wt, b)
    for relu in (False, True):
        # conv3x3_chain(..., relu=True) is torch.relu of its result
        want = torch.relu(chain) if relu else chain
        outs = [conv3x3.conv3x3(xp, wt, b, wk, relu=relu, config=c)
                for c in range(len(conv3x3.CONFIGS))]
        torch.cuda.synchronize()
        for c, got in enumerate(outs):
            held[(relu, c)] = (torch.equal(got, want)
                               and torch.equal(got, outs[0]))
    return held


def _conv_bound_ms(h, w, cin, cout, f32_peak, bytes_peak) -> float:
    """Least time of one layer: 2 H W Cin Cout 9 float32 operations at the
    card's non-tensor peak against its operands read once and its output
    written once."""
    flops = 2.0 * h * w * cin * cout * 9
    nbytes = 4.0 * (cin * (h + 2) * w + cout * h * w + 9 * cin * cout + cout)
    return max(flops / f32_peak, nbytes / bytes_peak) * 1e3


def check_conv3x3(torch) -> dict:
    """Phase 3c: every tile of ``conv3x3`` bitwise ``conv3x3_chain`` and
    each other at each shape of ``conv_chain_cases()`` (the card test runs
    every case), with and without ReLU; then ``conv3x3`` against its plain
    version (``F.conv2d``, TF32 off) at every VGG-19 layer shape of both
    geometries, with the tile the rule picks, its grid and resident
    blocks, CUDA-event times of every tile, the plain version, one
    ``F.conv2d`` call with the bias (the library yardstick) and the bound
    per layer; then the float32 VGG forward of each geometry's pair through
    the kernel and through cuDNN.  Returns the kernels-line record (the
    452x680 layers' sums at the picked tiles; the launches per pair filled
    in by phase 11b)."""
    import torch.nn.functional as F

    from nct_tpu_torch.models import vgg19
    from nct_tpu_torch.ops import conv3x3
    from nct_tpu_torch.utils import flops as flops_mod

    t0 = time.perf_counter()
    bad, seen = [], set()
    for i, case in enumerate(conv_chain_cases()):
        if case[1:] in seen:        # a layer of the shape of one checked
            continue
        seen.add(case[1:])
        held = conv_chain_check(torch, case, 100 + i)
        log(f"[conv3x3] chain {case[0]} (n {case[1]}, {case[2]}->{case[3]}, "
            f"{case[4]}x{case[5]}): every tile bitwise conv3x3_chain and "
            f"tile 0, with and without ReLU: {all(held.values())}")
        bad += [f"{case[0]} tile {c} relu {r}" for (r, c), ok in held.items()
                if not ok]
    log(f"[conv3x3] chain checks of {len(seen)} shapes done in "
        f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError(f"phase 3c: conv3x3 is not its chain at {bad}")
    f32_peak = flops_mod.F32_PEAKS[torch.cuda.get_device_name()]
    bytes_peak = flops_mod.device_peaks()[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = [conv3x3.occupancy(c) for c in range(len(conv3x3.CONFIGS))]
    gen = torch.Generator().manual_seed(3)
    rec = {"name": "conv3x3", "route": "cuda",
           "source": "nct_tpu_torch/csrc/conv3x3.cu",
           "replaces": "nct_tpu/models/vgg19.py:149 (XLA's convolution, "
                       "no Pallas kernel)",
           "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "bound_by": "operations", "library_ms": 0.0,
           "design": CONV_DESIGN, "geometries": {}}
    model = vgg19.init_params(torch.Generator().manual_seed(19)).cuda()
    for gi, (hw_c, hw_s) in enumerate(CONV_GEOMETRIES):
        dims = vgg19.feature_dims(*hw_c)
        geo = {"layers": {}}
        sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        cin = 3
        for name, cout in vgg19.VGG19_CONV_LAYERS:
            h, w = dims[name]
            x = torch.relu(torch.randn(1, cin, h, w, generator=gen)).cuda()
            xp = F.pad(x, (0, 0, 1, 1))
            wt = (torch.randn(cout, cin, 3, 3, generator=gen)
                  * math.sqrt(2.0 / (9 * cin))).cuda()
            b = (0.1 * torch.randn(cout, generator=gen)).cuda()
            # the kernel's weight layout, made once as VGG19 keeps it
            wk = conv3x3.kernel_weight(wt)
            pick = conv3x3.pick_config(1, h, w, cout, sms)
            got = conv3x3.conv3x3(xp, wt, b, wk)
            want = conv3x3.conv3x3_plain(xp, wt, b)
            torch.cuda.synchronize()
            top = float(want.abs().max())
            err = float((got - want).abs().max())
            close = torch.allclose(got, want, rtol=CONV_RTOL,
                                   atol=CONV_RTOL * top)

            def library():
                with conv3x3.no_tf32():
                    return F.conv2d(xp, wt, b, padding=(0, 1))
            tiles = [_time_ms(torch, lambda c=c: conv3x3.conv3x3(
                xp, wt, b, wk, config=c), CONV_REPS)
                for c in range(len(conv3x3.CONFIGS))]
            ms = tiles[pick]
            plain = _time_ms(torch, lambda: conv3x3.conv3x3_plain(xp, wt, b),
                             CONV_REPS)
            lib = _time_ms(torch, library, CONV_REPS)
            bound = _conv_bound_ms(h, w, cin, cout, f32_peak, bytes_peak)
            blocks = conv3x3.grid_blocks(pick, 1, h, w, cout)
            geo["layers"][name] = {"hw": [h, w], "cin": cin, "cout": cout,
                                   "tile": pick, "blocks": blocks,
                                   "resident_per_sm": resident[pick],
                                   "ms": ms, "tile_ms": tiles,
                                   "plain_ms": plain, "library_ms": lib,
                                   "bound_ms": bound, "max_abs_err": err}
            tflops = 2.0 * h * w * cin * cout * 9 / ms / 1e9
            log(f"[conv3x3] {hw_c[0]}x{hw_c[1]} {name} {h}x{w} {cin}->{cout}: "
                f"max |err| {err:.3g} of {top:.4g} (within rtol "
                f"{CONV_RTOL}: {close}); tile {pick} ({blocks} blocks, "
                f"{resident[pick]} resident per SM, {blocks / sms:.2f} per "
                f"SM): kernel {ms:.3f} ms ({tflops:.1f} "
                f"TFLOP/s, {bound / ms:.3f} of bound {bound:.3f} ms, "
                f"{ms / lib:.3f}x F.conv2d); tiles "
                f"{' / '.join(f'{t:.3f}' for t in tiles)} ms; plain "
                f"{plain:.3f} ms, F.conv2d {lib:.3f} ms")
            if not close:
                raise AssertionError(f"phase 3c: conv3x3 disagrees with "
                                     f"F.conv2d at {hw_c} {name}")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            for k, v in (("ms", ms), ("plain_ms", plain),
                         ("library_ms", lib), ("bound_ms", bound)):
                sums[k] += v
                if gi == 0:
                    rec[k] += v
            cin = cout
            del x, xp, got, want, wk
        worst = max(v["ms"] / v["library_ms"] for v in geo["layers"].values())
        log(f"[conv3x3] {hw_c[0]}x{hw_c[1]}, 16 layers: kernel "
            f"{sums['ms']:.3f} ms, F.conv2d {sums['library_ms']:.3f} ms "
            f"({sums['ms'] / sums['library_ms']:.3f}x), plain "
            f"{sums['plain_ms']:.3f} ms, bound "
            f"{sums['bound_ms']:.3f} ms ({sums['bound_ms'] / sums['ms']:.3f} "
            f"of it); the slowest layer against F.conv2d {worst:.3f}x")
        # the float32 forward of the pair: through the kernel, then cuDNN
        imgs = [torch.randint(0, 256, hw + (3,), dtype=torch.uint8,
                              generator=gen).cuda() for hw in (hw_c, hw_s)]

        def forward():
            for img in imgs:
                model(img, vgg19.PIPELINE_TAPS, torch.float32)
        conv3x3.LAUNCHES["conv3x3"] = 0
        forward()
        launches = conv3x3.LAUNCHES["conv3x3"]
        fwd = _time_ms(torch, forward, 3)
        vgg19.conv3x3 = (lambda x, w, b, wk, relu=False:
                         conv3x3.conv3x3_plain(x, w, b, relu))
        try:
            fwd_cudnn = _time_ms(torch, forward, 3)
        finally:
            vgg19.conv3x3 = conv3x3.conv3x3
        geo.update(sums, pair_forward_ms=fwd, pair_forward_cudnn_ms=fwd_cudnn,
                   pair_forward_launches=launches)
        log(f"[conv3x3] float32 VGG forward of the {hw_c[0]}x{hw_c[1]} / "
            f"{hw_s[0]}x{hw_s[1]} pair to conv5_1: kernel {fwd:.3f} ms "
            f"({launches} launches), cuDNN {fwd_cudnn:.3f} ms")
        rec["geometries"]["{}x{}".format(*hw_c)] = geo
        torch.cuda.empty_cache()
    log(f"[conv3x3] phase 3c took {time.perf_counter() - t0:.1f} s")
    return rec


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


def _check_output(torch, out, hw, trace=None) -> None:
    """The output checks of phase 4: shape [*hw, 3] and type, not constant,
    and a finite per-level trace."""
    if tuple(out.shape) != (*hw, 3) or out.dtype != torch.uint8:
        raise AssertionError(f"bad output {tuple(out.shape)} {out.dtype}")
    if int(out.max()) == int(out.min()):
        raise AssertionError("constant output")
    for tr in trace or ():
        for key in ("a", "b", "bds_err"):
            if not bool(torch.isfinite(tr[key]).all()):
                raise AssertionError(f"non-finite {key} at L{tr['level']}")


def _timed_pairs(torch, label, model, config, cnt, stl, runs: int,
                 launches: dict) -> tuple[dict, float]:
    """``runs`` checked transfer_pair runs (the first cold); each must make
    exactly ``launches`` kernel launches and give the first run's output
    bit for bit.  Prints the times; returns the launch counts read just
    after the cold run and the median warm seconds (the cold run's when
    ``runs`` is 1)."""
    from nct_tpu_torch import pipeline
    from nct_tpu_torch.ops import cuda_nn

    times = []
    first = None
    torch.cuda.reset_peak_memory_stats()
    for run in range(runs):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out, trace = pipeline.transfer_pair(model, cnt, stl, 2.0, config,
                                            seed=7, return_intermediates=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        log(f"[{label}] run {run} ({'cold' if run == 0 else 'warm'}): "
            f"{times[-1]:.3f} s, kernel launches {cuda_nn.LAUNCHES}")
        _check_output(torch, out, CONTENT_HW, trace)
        if cuda_nn.LAUNCHES != launches:
            raise AssertionError(f"kernel launches {cuda_nn.LAUNCHES}, "
                                 f"expected {launches}")
        if run == 0:
            cold_launches = dict(cuda_nn.LAUNCHES)
            first = out
        elif not torch.equal(out, first):
            diff = (out.int() - first.int()).abs()
            raise AssertionError(
                f"[{label}] run {run} differs from run 0 at "
                f"{int((diff > 0).sum())} values (max {int(diff.max())})")
    warm = statistics.median(times[1:] or times)
    mp = CONTENT_HW[0] * CONTENT_HW[1] / 1e6
    log(f"[{label}] 452x680 / 600x960: {_timed(times)} "
        f"({mp / warm:.4f} MP/s), nl iters "
        f"{[int(t['nl_iters']) for t in trace]}, wls iters "
        f"{[int(t['wls_iters']) for t in trace]}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; all "
        f"{runs} outputs bitwise equal")
    return cold_launches, warm


def check_slice(torch) -> dict:
    """The default-Config slice on the card; returns the nn_bidir launches
    of the cold run, the warm median and the small pair's card and CPU
    outputs."""
    from nct_tpu_torch import Config, pipeline
    from nct_tpu_torch.models import vgg19

    gen = torch.Generator().manual_seed(0)
    model = vgg19.init_params(torch.Generator().manual_seed(19)).cuda()
    config = Config()
    cnt, stl = _pair(torch, gen, CONTENT_HW, STYLE_HW, smooth=False)
    per_pair = {"nn_bidir": config.exact_nn_levels, "nn_directed": 0}
    launches, warm = _timed_pairs(torch, "slice", model, config, cnt, stl, 4,
                                  per_pair)

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
    return {"launches": launches["nn_bidir"], "warm_s": warm,
            "small_card": got, "small_cpu": ref}


SEQUENCE_FRAMES = 2    # phase 5's pan: a cold frame and a warm-started one


def check_patchmatch(torch) -> None:
    """Phase 5: the PatchMatch configuration and the video sequence."""
    from nct_tpu_torch import Config, pipeline
    from nct_tpu_torch.models import vgg19

    gen = torch.Generator().manual_seed(0)
    model = vgg19.init_params(torch.Generator().manual_seed(19)).cuda()
    cnt, stl = _pair(torch, gen, CONTENT_HW, STYLE_HW, smooth=False)
    config = Config(fine_strategy="patchmatch")
    _timed_pairs(torch, "patchmatch", model, config, cnt, stl, 2,
                 {"nn_bidir": config.exact_nn_levels, "nn_directed": 0})

    # a panning shot: each frame is the previous one moved 2 px right
    frames = [cnt.copy()]
    for _ in range(SEQUENCE_FRAMES - 1):
        frames.append(frames[-1][:, [0, 0, *range(CONTENT_HW[1] - 2)]])
    seq = Config(exact_nn_levels=0, fine_strategy="patchmatch")
    given, returned = [], []
    transfer_pair = pipeline.transfer_pair

    def recording(*args, **kwargs):
        """transfer_pair, noting the warm start each frame gets."""
        given.append(kwargs.get("warm_start"))
        out = transfer_pair(*args, **kwargs)
        returned.append(out[1])
        return out

    torch.cuda.synchronize()
    reset_counts()
    pipeline.transfer_pair = recording
    try:
        t0 = time.perf_counter()
        outs = []
        for out in pipeline.transfer_sequence(model, frames, stl, 2.0, seq,
                                              seed=7):
            torch.cuda.synchronize()
            outs.append(time.perf_counter() - t0)
            _check_output(torch, out, CONTENT_HW)
    finally:
        pipeline.transfer_pair = transfer_pair
    from nct_tpu_torch.ops import cuda_nn
    per_frame = [round(b - a, 3) for a, b in zip([0.0, *outs], outs)]
    warm = [given[k] is returned[k - 1] for k in range(1, SEQUENCE_FRAMES)]
    log(f"[sequence] {SEQUENCE_FRAMES} frames 452x680 / 600x960, PatchMatch "
        f"at every level: {per_frame} s per frame; frames after the first "
        f"warm-started from the previous frame's level-0 fields: {warm}; "
        f"kernel launches {cuda_nn.LAUNCHES}")
    if len(outs) != SEQUENCE_FRAMES or given[0] is not None or not all(warm):
        raise AssertionError("the sequence did not chain its warm starts")
    if any(v for v in cuda_nn.LAUNCHES.values()):
        raise AssertionError("no exact level, yet an NN kernel launched")


def check_profiler(torch) -> int:
    """Phase 6: the per-stage profiler at its real shapes; returns the
    directed kernel's launches on that path."""
    from nct_tpu_torch.ops import cuda_nn
    from nct_tpu_torch.tools import profile_stages

    torch.cuda.synchronize()
    reset_counts()
    stages = profile_stages.run("cuda", reps=3)
    launches = cuda_nn.LAUNCHES["nn_directed"]
    log(json.dumps({"profile_stages_ms": stages}))
    bad = [k for k, v in stages.items() if not v > 0.0]
    if bad or launches == 0:
        raise AssertionError(f"profiler: stages {bad} not timed, "
                             f"{launches} directed launches")
    return launches


# 7c: relative max difference of A x between the scatter and the tables
# transpose at an ample in_cap (the same pairs, summed in another order)
TRANSPOSE_REL_TOL = 1e-5
# 7c: block-Jacobi against mg, both after retune.CONVERGED_ITERS, compared
# on the colour a*s+b in unit Lab (a alone is weakly determined where the
# confidence is low); the mg solve is near the float32 floor by then, the
# block-Jacobi one is not, so the limits leave room for its distance
CONVERGED_COLOUR_MAX = 0.05
CONVERGED_COLOUR_MEAN = 0.005
RETUNE_CAPS = (4, 6, 8, 10, 12, 16, 24, 32, 48)


def _stage_split(torch, label, model, config, cnt, stl, run=None) -> None:
    """One more warm pair (or ``run()``) with every stage function wrapped
    in a synchronised host-clock span; prints seconds per stage and the
    rest."""
    from nct_tpu_torch import pipeline
    from nct_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    hooks = [(pipeline, "_setup"), (pipeline.cuda_nn, "exact_nn_bidir"),
             (pipeline, "window_refine"), (pipeline, "patchmatch"),
             (pipeline.bds, "bds_reconstruct_color"),
             (pipeline.bds, "bds_vote"), (pipeline.knn, "knn_graph"),
             (pipeline, "solve_nonlocal"), (pipeline, "solve_wls")]
    saved = [getattr(mod, name) for mod, name in hooks]

    def timed(name, fn):
        return lambda *a, **k: timer.timed(name, fn, *a, **k)

    for (mod, name), fn in zip(hooks, saved):
        setattr(mod, name, timed(name, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run is None:
            pipeline.transfer_pair(model, cnt, stl, 2.0, config, seed=7)
        else:
            run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for (mod, name), fn in zip(hooks, saved):
            setattr(mod, name, fn)
    parts = sorted(timer.spans.items(), key=lambda kv: -kv[1])
    log(f"[{label}] stage split of one warm {'pair' if run is None else 'run'} "
        f"({total:.3f} s, synchronised after each stage): " + ", ".join(f"{k} {v:.3f} s" for k, v in parts)
        + f", rest {total - sum(timer.spans.values()):.3f} s")


def check_variants(torch) -> None:
    """Phase 7: the solver-variant configurations and the solver checks."""
    from nct_tpu_torch import Config
    from nct_tpu_torch.models import vgg19

    gen = torch.Generator().manual_seed(0)
    model = vgg19.init_params(torch.Generator().manual_seed(19)).cuda()
    cnt, stl = _pair(torch, gen, CONTENT_HW, STYLE_HW, smooth=False)
    # Config.reference_parity()'s single-process pairs run in phase 10b's
    # scan (bf16 VGG) and phase 17 (float32 VGG), launches checked there
    variants = Config(knn_memberships=3, nl_transpose="scatter",
                      wls_precond="jacobi")
    _timed_pairs(torch, "variants", model, variants, cnt, stl, 2,
                 {"nn_bidir": variants.exact_nn_levels, "nn_directed": 0})
    check_solvers(torch)


def check_solvers(torch) -> None:
    """Phase 7c on the captured nonlocal systems of tests/fixtures."""
    import os

    import numpy as np

    from nct_tpu_torch import Config
    from nct_tpu_torch.solve import retune
    from nct_tpu_torch.solve.nonlocal_solve import make_nonlocal_system

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures")
    l0 = retune.load_nl_system(os.path.join(fixtures, "nl_L0.npz"))
    l1 = retune.load_nl_system(os.path.join(fixtures, "nl_L1.npz"))

    # scatter against tables at an ample in_cap, on nl_L1
    d = {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in l1.items()}
    args = [d[k] for k in ("src_lab", "ref_lab", "confidence", "nbr_ids",
                           "nbr_w")]
    slots = {"candidates": d["candidates"], "nbr_slots": d["nbr_slots"]}
    g = torch.Generator().manual_seed(1)
    x = tuple(torch.randn(d["a0"].shape, generator=g).cuda() for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op_t = make_nonlocal_system(*args, float(d["norm_factor"]), **slots,
                                in_cap=d["nbr_ids"].numel(),
                                transpose="tables")[0]
    op_s = make_nonlocal_system(*args, float(d["norm_factor"]), **slots,
                                transpose="scatter")[0]
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(op_t(x), op_s(x)))
    torch.cuda.synchronize()
    log(f"[solvers] nl_L1 scatter vs tables at in_cap={d['nbr_ids'].numel()}: "
        f"relative max |A x difference| {rel:.2e} (limit {TRANSPOSE_REL_TOL:g}), "
        f"{time.perf_counter() - t0:.3f} s")
    if not rel <= TRANSPOSE_REL_TOL:
        raise AssertionError("the scatter and tables transposes differ")

    # block-Jacobi against mg, each run to CONVERGED_ITERS
    cap = retune.CONVERGED_ITERS
    for name, system in (("nl_L0", l0), ("nl_L1", l1)):
        out = {}
        for precond in ("mg", "block_jacobi"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a, b, r2 = retune.nl_solve_at_cap(
                system, cap, Config(nl_precond=precond))
            out[precond] = (a * system["src_lab"] + b, r2,
                            time.perf_counter() - t0)
        diff = np.abs(out["mg"][0] - out["block_jacobi"][0])
        log(f"[solvers] {name} at {cap} iterations: mg r2 "
            f"{out['mg'][1]:.3g} in {out['mg'][2]:.3f} s, block-Jacobi r2 "
            f"{out['block_jacobi'][1]:.3g} in {out['block_jacobi'][2]:.3f} s; "
            f"colour a*s+b differs by max {diff.max():.4f} / mean "
            f"{diff.mean():.5f} (limits {CONVERGED_COLOUR_MAX:g} / "
            f"{CONVERGED_COLOUR_MEAN:g})")
        if not (diff.max() <= CONVERGED_COLOUR_MAX
                and diff.mean() <= CONVERGED_COLOUR_MEAN):
            raise AssertionError(f"{name}: block-Jacobi and mg disagree")

    # residual curves on nl_L0 over the caps tools/retune_caps.py sweeps,
    # then the falling check over the default Config's caps
    cfg = Config()
    for precond in ("mg", "block_jacobi"):
        c = Config(nl_precond=precond)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        curve = retune.residual_curve(
            lambda k: retune.nl_solve_at_cap(l0, k, c), RETUNE_CAPS)
        log(f"[solvers] nl_L0 {precond} residual curve "
            f"({time.perf_counter() - t0:.3f} s): r2_init "
            f"{curve['converged']['r2_init']:.4g}, reduction by cap "
            + ", ".join(f"{k}: {v['reduction']:.3g}"
                        for k, v in curve["caps"].items()))
    default_caps = (4, cfg.cg_iters_final_mg, cfg.cg_iters_mg)
    curve = retune.residual_curve(
        lambda k: retune.nl_solve_at_cap(l0, k, cfg), default_caps)
    r2s = [curve["converged"]["r2_init"]] + [
        curve["caps"][k]["r2"] for k in default_caps]
    log(f"[solvers] nl_L0 mg r2 at caps (0, *{default_caps}): "
        f"{[f'{v:.4g}' for v in r2s]}; recommended cap for a 1e-4 "
        f"reduction: {retune.recommend_cap(curve, 1e-4)}")
    if not all(a > b for a, b in zip(r2s, r2s[1:])):
        raise AssertionError("the residual curve at the default caps does "
                             "not fall")


def check_serving(torch, slice_info: dict) -> None:
    """Phase 8: the CLI in a new process, a scan batch, the FLOP counts
    and the SSIM of the card against the CPU."""
    import os
    import tempfile

    import numpy as np

    from nct_tpu_torch import Config, pipeline
    from nct_tpu_torch import io as tio
    from nct_tpu_torch import _build
    from nct_tpu_torch.models import vgg19
    from nct_tpu_torch.ops import cuda_nn
    from nct_tpu_torch.parallel.batch import make_batch_transfer
    from nct_tpu_torch.utils import flops, ssim

    model = vgg19.init_params(torch.Generator().manual_seed(19)).cuda()
    config = Config()
    repo = os.path.dirname(os.path.abspath(__file__))

    # (a) the CLI in a new process, over PNG files written by the port
    cnt, stl = _pair(torch, torch.Generator().manual_seed(8), CONTENT_HW,
                     STYLE_HW, smooth=True)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        tio.imwrite_bgr(os.path.join(src, "cnt.png"), cnt)
        tio.imwrite_bgr(os.path.join(src, "stl.png"), stl)
        with open(os.path.join(src, "pairs.txt"), "w") as f:
            f.write("cnt.png stl.png 1.5\ncnt.png missing.png 2.0\n"
                    "cnt.png stl.png\n")
        built = sorted(os.listdir(_build.BUILD_DIR))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nct_tpu_torch.cli", "-i", src, "-o", dst,
             "--device", "cuda"], capture_output=True, text=True, cwd=repo,
            env=dict(os.environ, PYTHONPATH=repo), timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the CLI exited {proc.returncode}:\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        per_pair = [float(line.split()[2]) for line in proc.stdout.splitlines()
                    if line.startswith("**Finished Time:")]
        skipped = ("error: failed reading pair cnt.png/missing.png; skipping"
                   in proc.stdout)
        outs = sorted(os.listdir(dst))
        rebuilt = sorted(os.listdir(_build.BUILD_DIR)) != built
        log(f"[serving] CLI in a new process: exit 0 in {wall:.3f} s, "
            f"per-pair seconds {per_pair} (first cold), missing pair skipped "
            f"{skipped}, outputs {outs}, kernel rebuilt {rebuilt}")
        if (not skipped or outs != ["cnt_stl_1.50.png", "cnt_stl_2.00.png"]
                or rebuilt or len(per_pair) != 2):
            raise AssertionError("the CLI run is not what pairs.txt asks for")
        for name, bds in (("cnt_stl_1.50.png", 1.5), ("cnt_stl_2.00.png", 2.0)):
            got = tio.imread_bgr(os.path.join(dst, name))
            want = pipeline.transfer_pair(model, cnt, stl, bds, config,
                                          seed=7).cpu().numpy()
            same = got.shape == (*CONTENT_HW, 3) and np.array_equal(got, want)
            log(f"[serving] {name}: {got.shape}, bitwise equal to the "
                f"in-process transfer_pair: {same}")
            if not same:
                raise AssertionError(f"{name} differs from transfer_pair")

    # (b) a scan batch of 4 seeded pairs
    gen = torch.Generator().manual_seed(9)
    pairs = [_pair(torch, gen, CONTENT_HW, STYLE_HW, smooth=False)
             for _ in range(4)]
    cnt_b = np.stack([c for c, _ in pairs])
    stl_b = np.stack([s for _, s in pairs])
    seeds = [0, 1, 2, 3]
    batch = make_batch_transfer(config, mode="scan")
    times, outs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        outs.append(batch(model, cnt_b, stl_b, seeds, 2.0))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        want = {"nn_bidir": 4 * config.exact_nn_levels, "nn_directed": 0}
        if cuda_nn.LAUNCHES != want:
            raise AssertionError(f"scan batch launches {cuda_nn.LAUNCHES}, "
                                 f"expected {want}")
    mp = 4 * CONTENT_HW[0] * CONTENT_HW[1] / 1e6
    log(f"[serving] scan batch of 4 pairs {CONTENT_HW[0]}x{CONTENT_HW[1]} / "
        f"{STYLE_HW[0]}x{STYLE_HW[1]}: cold "
        f"{times[0]:.3f} s, warm {times[1]:.3f} s ({times[1] / 4:.3f} s per "
        f"pair, {mp / times[1]:.4f} MP/s), kernel launches per batch "
        f"{cuda_nn.LAUNCHES}")
    singles, traces = [], []
    for i, seed in enumerate(seeds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one, trace = pipeline.transfer_pair(model, cnt_b[i], stl_b[i], 2.0,
                                            config, seed=seed,
                                            return_intermediates="stats")
        torch.cuda.synchronize()
        singles.append(round(time.perf_counter() - t0, 3))
        traces.append(trace)
        if not (torch.equal(outs[0][i], one) and torch.equal(outs[1][i], one)):
            raise AssertionError(f"batch item {i} differs from its own "
                                 f"transfer_pair")
    log(f"[serving] every batch item (cold and warm) is bitwise equal to its "
        f"own transfer_pair, which took {singles} s")

    # (c) analytic counts, and phase 4's warm median against the ceilings
    counts = flops.pipeline_counts(*CONTENT_HW, *STYLE_HW, config)
    total = counts["total"]
    warm = slice_info["warm_s"]
    hbm_frac = flops.roofline_fraction(total["flops"], total["bytes"],
                                       warm)["bandwidth_frac"]
    log(json.dumps({"flops_pipeline_counts": counts}))
    log(f"[serving] default pair: {total['flops'] / 1e12:.3f} TFLOP, "
        f"{total['bytes'] / 1e9:.3f} GB analytic; at phase 4's warm median "
        f"{warm:.3f} s: mfu {flops.mfu(total['flops'], warm):.4e}, hbm_frac "
        f"{hbm_frac:.4e}")

    # (d) SSIM of the card's output against the CPU's on the small pair
    value = ssim.ssim(slice_info["small_card"], slice_info["small_cpu"])
    log(f"[serving] SSIM card vs CPU on the 64x80 / 72x88 small pair: "
        f"{value:.6f} (limit {SMALL_SSIM_MIN})")
    if not value >= SMALL_SSIM_MIN:
        raise AssertionError("card and CPU outputs differ in SSIM")
    return {"cnt_b": cnt_b, "stl_b": stl_b, "seeds": seeds, "outs": outs[0],
            "traces": traces, "warm_s": times[1]}


def _bmm_ms(torch, fa, fb) -> float:
    """CUDA-event time of the batched bf16 products alone: one cuBLAS
    ``torch.bmm`` per chunk of A rows, chunked so that the output fits
    2 GiB."""
    bsz, nb = fb.shape[0], fb.shape[1]
    rows = max(128, (2 ** 30 // (bsz * nb * 2)) // 128 * 128)
    out = torch.empty((bsz, rows, nb), dtype=torch.bfloat16, device="cuda")
    fbt = fb.transpose(1, 2)

    def run():
        for a0 in range(0, fa.shape[1], rows):
            chunk = fa[:, a0:a0 + rows]
            torch.bmm(chunk, fbt, out=out[:, :chunk.shape[1]])
    return _time_ms(torch, run, 3)


def check_batched_kernels(torch, bidir: dict, directed: dict) -> None:
    """Phase 9a: each instance over a batch grid axis of NN_BATCH items at
    the L0-L3 shapes, every item bitwise equal to its own single launch;
    adds the batched launch's times and bounds to the kernel records."""
    from nct_tpu_torch.ops import cuda_nn
    from nct_tpu_torch.utils import flops as flops_mod

    peaks = flops_mod.device_peaks()
    gen = torch.Generator().manual_seed(1)
    for rec in (bidir, directed):
        rec.update({"batch": NN_BATCH, "batched_ms_by_level": [],
                    "batched_single_launches_ms_by_level": [],
                    "batched_bound_ms_by_level": [],
                    "batched_bmm_ms_by_level": []})
    for lvl, (ha, wa, hb, wb, c) in enumerate(NN_SHAPES):
        na, nb = ha * wa, hb * wb
        for integer in (True, False):
            a = torch.stack([_features(torch, gen, ha, wa, c, integer)
                             for _ in range(NN_BATCH)])
            b = torch.stack([_features(torch, gen, hb, wb, c, integer)
                             for _ in range(NN_BATCH)])
            fa, ma = cuda_nn.padded_tables(a, 3)
            fb, mb = cuda_nn.padded_tables(b, 3)
            # items with different zero-mask rows: item 1 loses its first
            # A rows, item 2 its first B rows
            ma[1, :TILE_ROWS_MASKED] = 0
            mb[2, :TILE_ROWS_MASKED] = 0
            launches = dict(cuda_nn.LAUNCHES)
            got = cuda_nn.nn_bidir_tables(fa, ma, fb, mb)
            got_dir = cuda_nn.nn_directed_tables(fa, ma, fb, mb)
            if {k: cuda_nn.LAUNCHES[k] - launches[k] for k in launches} != {
                    "nn_bidir": 1, "nn_directed": 1}:
                raise AssertionError("a batched call made more than one "
                                     "launch per instance")
            same = True
            for i in range(NN_BATCH):
                one = cuda_nn.nn_bidir_tables(fa[i], ma[i], fb[i], mb[i])
                one_dir = cuda_nn.nn_directed_tables(fa[i], ma[i], fb[i],
                                                     mb[i])
                same &= all(torch.equal(x[i], y) for x, y in zip(got, one))
                same &= all(torch.equal(x[i], y)
                            for x, y in zip(got_dir, one_dir))
            torch.cuda.synchronize()
            kind = "integer" if integer else "random"
            log(f"[batched] L{lvl} {kind} case, {NN_BATCH} items: every item "
                f"bitwise equal to its own single launch (both instances): "
                f"{same}")
            if not same:
                raise AssertionError(f"L{lvl}: a batched item differs from "
                                     f"its single launch")
            if integer:
                continue
            bmm = _bmm_ms(torch, fa, fb)
            for name, rec, launch in (
                    ("nn_bidir", bidir, cuda_nn.nn_bidir_tables),
                    ("nn_directed", directed, cuda_nn.nn_directed_tables)):
                ms = _time_ms(torch, lambda: launch(fa, ma, fb, mb), 3)
                singles = _time_ms(torch, lambda: [
                    launch(fa[i], ma[i], fb[i], mb[i])
                    for i in range(NN_BATCH)], 3)
                bound = NN_BATCH * _bound_ms(na, nb, c, name == "nn_directed",
                                             peaks)
                log(f"[batched] {name} L{lvl} B={NN_BATCH}: one launch "
                    f"{ms:.3f} ms against {NN_BATCH} single launches "
                    f"{singles:.3f} ms ({singles / ms:.2f}x); bound "
                    f"{bound:.3f} ms ({bound / ms:.3f} of it); cuBLAS bmm "
                    f"{bmm:.3f} ms")
                rec["batched_ms_by_level"].append(ms)
                rec["batched_single_launches_ms_by_level"].append(singles)
                rec["batched_bound_ms_by_level"].append(bound)
                rec["batched_bmm_ms_by_level"].append(bmm)


def _vmap_bucket(torch, label, model, config, cnt_b, stl_b, seeds, scan,
                 warm_runs: int, split: bool = False) -> dict:
    """One cold run (traced for the iteration counts) and ``warm_runs``
    warm runs of ``make_batch_transfer(config, mode="vmap")`` on the
    bucket, each with the kernel counts set to 0 just before it and read
    just after; every warm output bitwise the cold one, and each item held
    to the batch contract of its scan item (``scan``: "outs", "traces" and
    the scan's seconds "s").  With ``split``, a stage split of one more
    warm bucket.  Returns the bucket's launch and item counts and times."""
    import numpy as np

    from nct_tpu_torch import pipeline
    from nct_tpu_torch.ops import cuda_nn
    from nct_tpu_torch.parallel.batch import make_batch_transfer

    bsz = len(seeds)
    exact = min(config.exact_nn_levels, config.num_levels)
    want = {"nn_bidir": exact, "nn_directed": 0}
    want_items = {"nn_bidir": bsz * exact, "nn_directed": 0}
    batch = make_batch_transfer(config, mode="vmap")
    torch.cuda.reset_peak_memory_stats()
    times, first, traces = [], None, None
    for run in range(1 + warm_runs):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        if run == 0:
            out, traces = pipeline.transfer_batch(
                model, cnt_b, stl_b, 2.0, config, seeds=seeds,
                return_intermediates="stats")
        else:
            out = batch(model, cnt_b, stl_b, seeds, 2.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = (dict(cuda_nn.LAUNCHES), dict(cuda_nn.LAUNCH_ITEMS))
        log(f"[{label}] bucket run {run} ({'cold' if run == 0 else 'warm'}): "
            f"{times[-1]:.3f} s, kernel launches {counts[0]}, items "
            f"{counts[1]}")
        if counts != (want, want_items):
            raise AssertionError(f"[{label}] launches {counts}, expected "
                                 f"{(want, want_items)}")
        if run == 0:
            first = out
        elif not torch.equal(out, first):
            raise AssertionError(f"[{label}] run {run} differs from run 0")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if split:
        _stage_split(torch, label, model, config, cnt_b, stl_b,
                     run=lambda: batch(model, cnt_b, stl_b, seeds, 2.0))
    broken, shares = [], []
    for i in range(bsz):
        got = first[i].cpu().numpy().astype(int)
        ref = scan["outs"][i].cpu().numpy().astype(int)
        diff = np.abs(got - ref)
        within = float((diff <= BATCH_LSB).mean())
        shares.append(float((diff == 0).mean()))
        its = [(t["nl_iters"], t["wls_iters"]) for t in traces[i]]
        ref_its = [(int(t["nl_iters"]), int(t["wls_iters"]))
                   for t in scan["traces"][i]]
        log(f"[{label}] item {i} (seed {seeds[i]}) against its scan item: "
            f"bitwise equal at {shares[-1]:.4f} of values, <= {BATCH_LSB} "
            f"LSB at {within:.4f}, mean |diff| {diff.mean():.4f}, max "
            f"{diff.max()}; (nl, wls) iterations per level {its}, scan "
            f"{ref_its}")
        if (within < BATCH_WITHIN_MIN or diff.mean() > BATCH_MEAN_MAX
                or its != ref_its):
            broken.append(i)
    if broken:
        raise AssertionError(f"[{label}] items {broken} break the batch "
                             f"contract")
    mp = bsz * CONTENT_HW[0] * CONTENT_HW[1] / 1e6
    which = "warm" if warm_runs else "cold"
    t = statistics.median(times[1:] or times)
    log(f"[{label}] bucket of {bsz} pairs {CONTENT_HW[0]}x{CONTENT_HW[1]} / "
        f"{STYLE_HW[0]}x{STYLE_HW[1]}: {_timed(times)}; {which} "
        f"{t / bsz:.3f} s per pair, {mp / t:.4f} MP/s; scan of the same "
        f"items {scan['s']:.3f} s ({scan['s'] / bsz:.3f} s per pair, "
        f"{mp / scan['s']:.4f} MP/s); {scan['s'] / t:.2f}x the {which} "
        f"bucket; bitwise share per item {[round(v, 4) for v in shares]}; "
        f"peak device memory {peak:.2f} GiB")
    return {"launches": want["nn_bidir"], "items": want_items["nn_bidir"],
            f"{which}_s_per_pair": t / bsz,
            "scan_s_per_pair": scan["s"] / bsz, "peak_gib": peak}


def check_vmap_bucket(torch, scan: dict) -> dict:
    """Phase 9b: the vmap bucket of phase 8b's pairs against 8b's scan
    items; returns the bucket's launch and item counts."""
    from nct_tpu_torch import Config
    from nct_tpu_torch.models import vgg19

    model = vgg19.init_params(torch.Generator().manual_seed(19)).cuda()
    return _vmap_bucket(
        torch, "vmap", model, Config(), scan["cnt_b"], scan["stl_b"],
        scan["seeds"], {"outs": scan["outs"], "traces": scan["traces"],
                        "s": scan["warm_s"]}, warm_runs=1, split=True)


def _scan_items(torch, model, config, cnt_b, stl_b, seeds) -> dict:
    """The scan of a bucket's items: ``transfer_pair`` per item in turn
    (what ``make_batch_transfer(mode="scan")`` runs), with their traces;
    each item must launch ``nn_bidir`` once per exact level and nothing
    else, counted from 0 just before it, and give a checked output."""
    from nct_tpu_torch import pipeline
    from nct_tpu_torch.ops import cuda_nn

    want = {"nn_bidir": min(config.exact_nn_levels, config.num_levels),
            "nn_directed": 0}
    outs, traces, launches = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, seed in enumerate(seeds):
        reset_counts()
        out, trace = pipeline.transfer_pair(model, cnt_b[i], stl_b[i], 2.0,
                                            config, seed=seed,
                                            return_intermediates="stats")
        launches.append(dict(cuda_nn.LAUNCHES))
        outs.append(out)
        traces.append(trace)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    for i, out in enumerate(outs):
        _check_output(torch, out, CONTENT_HW)
        if launches[i] != want:
            raise AssertionError(f"scan item {i}: kernel launches "
                                 f"{launches[i]}, expected {want}")
    return {"outs": outs, "traces": traces, "s": s}


# phase 10: (label, Config, bucket size, warm runs, stage split)
VMAP_CONFIGS = (
    ("10a-pm", "patchmatch", 2, 0, False),
    ("10b-parity", "parity", 2, 0, False),
    ("10c-variants", "variants", 2, 0, False),
)


def check_vmap_configs(torch, scan: dict) -> dict:
    """Phase 10: the vmap buckets of the Configs beyond the default family
    on phase 8b's pairs, each beside a scan of the same items in the same
    call; returns each bucket's launch and item counts."""
    from nct_tpu_torch import Config
    from nct_tpu_torch.models import vgg19

    model = vgg19.init_params(torch.Generator().manual_seed(19)).cuda()
    configs = {
        "patchmatch": Config(fine_strategy="patchmatch"),
        "parity": Config.reference_parity(),
        "variants": Config(knn_memberships=3, nl_transpose="scatter",
                           wls_precond="jacobi"),
    }
    out = {}
    for label, name, bsz, warm_runs, split in VMAP_CONFIGS:
        config = configs[name]
        cnt_b, stl_b = scan["cnt_b"][:bsz], scan["stl_b"][:bsz]
        seeds = scan["seeds"][:bsz]
        items = _scan_items(torch, model, config, cnt_b, stl_b, seeds)
        out[label] = _vmap_bucket(torch, label, model, config, cnt_b, stl_b,
                                  seeds, items, warm_runs, split)
    return out


def check_batch_profiler(torch) -> None:
    """Phase 9c: the per-stage batch profiler at its real shapes."""
    from nct_tpu_torch.tools import profile_batch_stages

    stages = profile_batch_stages.run("cuda", batch=NN_BATCH, reps=3)
    log(json.dumps({"profile_batch_stages": stages}))
    bad = [k for k, v in stages.items()
           if not (v["b1_ms"] > 0.0 and v["bB_ms"] > 0.0)]
    if bad:
        raise AssertionError(f"batch profiler: stages {bad} not timed")


# phase 11: the ranks of the mesh phases (gloo, both on the one card), and
# the runs of 11b's pair and 11d's bucket on row bands (one cold, one warm
# that must be bitwise it; 11e's bucket runs once, cold)
MESH_RANKS = 2
MESH_PAIR_RUNS = 2
# float32 VGG convolutions of a 5-level pair (conv3x3 launches): the two
# setup forwards to conv5_1 (2 x 13) and the re-extractions of conv4_1,
# conv3_1, conv2_1 and conv1_1 (9 + 5 + 3 + 1)
CONVS_PER_PAIR = 44


def _ring_check(torch, mesh, a, b, timing=None) -> dict:
    """The ring a -> b and b -> a against ``exact_nn_bidir`` of the same
    features on this rank: bitwise flags, the directed launches of the two
    rings, their CUDA-event times and the matcher's peak bytes beside the
    single-card search's."""
    from nct_tpu_torch.ops import cuda_nn
    from nct_tpu_torch.parallel.ring_nn import ring_exact_nn

    def measured(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), (
            torch.cuda.max_memory_allocated() - base)

    ref, bidir_ms, bidir_bytes = measured(
        lambda: cuda_nn.exact_nn_bidir(a, b, 3))
    before = cuda_nn.LAUNCHES["nn_directed"]
    ab, ab_ms, ab_bytes = measured(
        lambda: ring_exact_nn(a, b, mesh, timing=timing))
    ba, ba_ms, ba_bytes = measured(
        lambda: ring_exact_nn(b, a, mesh, timing=timing))
    rec = {"launches": cuda_nn.LAUNCHES["nn_directed"] - before,
           "ring_ab_ms": ab_ms, "ring_ba_ms": ba_ms, "bidir_ms": bidir_ms,
           "ring_peak_bytes": max(ab_bytes, ba_bytes),
           "bidir_peak_bytes": bidir_bytes}
    for name, got, want in (("ab", ab, ref[:2]), ("ba", ba, ref[2:])):
        rec[f"{name}_bitwise"] = (torch.equal(got[0], want[0])
                                  and torch.equal(got[1], want[1]))
        rec[f"{name}_index_diff"] = int(
            (got[0] != want[0]).any(-1).sum())
        rec[f"{name}_max_d_diff"] = float((got[1] - want[1]).abs().max())
    return rec


def _iters(trace) -> list:
    """(nl, wls) iterations per level of a "stats" trace."""
    return [(int(t["nl_iters"]), int(t["wls_iters"])) for t in trace]


def _mesh_runs(torch, runs: int, fn) -> dict:
    """``runs`` synchronised runs of ``fn`` (the first cold), each with the
    kernel counts set to 0 just before it and read just after; every
    output must equal the first.  ``fn`` returns the output or (output,
    "stats" trace); the first run's iterations per level are kept."""
    from nct_tpu_torch.ops import conv3x3, cuda_nn

    times, launches, first, iters = [], None, None, None
    torch.cuda.reset_peak_memory_stats()
    for run in range(runs):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if isinstance(out, tuple):
            out, trace = out
            iters = iters or _iters(trace)
        counts = (dict(cuda_nn.LAUNCHES), dict(cuda_nn.LAUNCH_ITEMS),
                  conv3x3.LAUNCHES["conv3x3"])
        if run == 0:
            first, launches = out, counts
        elif counts != launches or not torch.equal(out, first):
            raise AssertionError(f"run {run} differs from run 0 in its "
                                 f"output or launches {counts}")
    return {"out": first.cpu(), "s": times, "launches": launches[0],
            "items": launches[1], "conv3x3": launches[2], "iters": iters,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def bitwise(torch, got, want) -> tuple[bool, int, int]:
    """(equal, values that differ, max |diff|) of two uint8 results."""
    diff = (got.cpu().int() - want.cpu().int()).abs()
    return (torch.equal(got.cpu(), want.cpu()), int((diff > 0).sum()),
            int(diff.max()))


def _timed(times: list) -> str:
    """"cold x s, warm [...] s (median m s)", or "cold x s (no warm run)"
    when the phase ran once."""
    if len(times) == 1:
        return f"cold {times[0]:.3f} s (no warm run)"
    return (f"cold {times[0]:.3f} s, warm {[round(t, 3) for t in times[1:]]}"
            f" s (median {statistics.median(times[1:]):.3f} s)")


def mesh_rank(cnt_b, stl_b, seeds) -> dict:
    """Phase 11 in one rank of a 2-rank gloo world on the one card (run by
    ``parallel.mesh.launch``); returns what the parent checks and prints."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from nct_tpu_torch import Config, pipeline
    from nct_tpu_torch.models import vgg19
    from nct_tpu_torch.parallel import mesh as mesh_mod
    from nct_tpu_torch.parallel.batch import make_batch_transfer
    from nct_tpu_torch.parallel.mesh import make_mesh
    from nct_tpu_torch.parallel.ring_nn import RingTiming

    torch.backends.cuda.matmul.allow_tf32 = False
    space = make_mesh(n_data=1, n_space=MESH_RANKS)
    data = make_mesh(n_data=MESH_RANKS, n_space=1)
    lead = space.index("space") == 0
    out = {"rank": dist.get_rank(), "backend": space.backend,
           "device": str(space.device), "ring": []}

    # 11a: the ring at the L0-L3 shapes, random and integer features
    gen = torch.Generator().manual_seed(11)
    for lvl, (ha, wa, hb, wb, c) in enumerate(NN_SHAPES):
        for integer in (False, True):
            a = _features(torch, gen, ha, wa, c, integer)
            b = _features(torch, gen, hb, wb, c, integer)
            rec = _ring_check(torch, space, a, b)
            rec.update(level=lvl, integer=integer)
            if lvl == len(NN_SHAPES) - 1 and not integer:
                timing = RingTiming()     # warm now: time one more pass
                rec["timed"] = _ring_check(torch, space, a, b, timing)
                rec["timed"].update(step_ms=timing.step_ms(),
                                    staging_ms=timing.staging_s * 1e3,
                                    wait_ms=timing.wait_s * 1e3)
            out["ring"].append(rec)
            del a, b
    torch.cuda.empty_cache()

    # 11b: the default pair under a 1x2 space mesh with float32 VGG
    model = vgg19.init_params(torch.Generator().manual_seed(19)).cuda()
    cnt, stl = _pair(torch, torch.Generator().manual_seed(0), CONTENT_HW,
                     STYLE_HW, smooth=False)
    f32 = Config(vgg_compute_dtype="float32")
    sharded = dataclasses.replace(f32, space_mesh=space)
    dist.barrier()
    out["pair"] = _mesh_runs(torch, MESH_PAIR_RUNS,
                             lambda: pipeline.transfer_pair(
                                 model, cnt, stl, 2.0, sharded, seed=7,
                                 return_intermediates="stats"))
    if lead:
        single, trace = pipeline.transfer_pair(
            model, cnt, stl, 2.0, f32, seed=7, return_intermediates="stats")
        out["pair_single"] = (single.cpu(), _iters(trace))
    torch.cuda.empty_cache()

    # 11c: phase 8b's 4 pairs over a 2x1 data mesh, 2 per rank as vmap
    dist.barrier()
    out["data"] = _mesh_runs(torch, 2, lambda: make_batch_transfer(
        Config(), data)(model, cnt_b, stl_b, seeds, 2.0))
    torch.cuda.empty_cache()

    # 11d: a bucket of 2 under the 1x2 space mesh, vmap (float32 VGG)
    dist.barrier()
    out["bucket"] = _mesh_runs(torch, MESH_PAIR_RUNS,
                               lambda: make_batch_transfer(Config(), space)(
                                   model, cnt_b[:2], stl_b[:2], seeds[:2],
                                   2.0))
    torch.cuda.empty_cache()

    # 11e: 11d's bucket with ring_nn=False: each rank searches the whole
    # tables with nn_bidir, and must give the ring's bucket bit for bit
    dist.barrier()
    out["replicated"] = _mesh_runs(torch, 1, lambda: make_batch_transfer(
        Config(), space, ring_nn=False)(
            model, cnt_b[:2], stl_b[:2], seeds[:2], 2.0))
    if lead:
        out["bucket_single"] = [pipeline.transfer_pair(
            model, cnt_b[i], stl_b[i], 2.0, f32, seed=seeds[i]).cpu()
            for i in range(2)]
    out["comm"] = dict(mesh_mod.COMM)
    return out


def check_mesh(torch, scan: dict, directed: dict, conv: dict) -> None:
    """Phase 11: ``mesh_rank`` in 2 ranks on the card; checks every rank's
    results and prints them; ``conv``'s launches are 11b's per pair."""
    from nct_tpu_torch import Config
    from nct_tpu_torch.parallel.mesh import launch

    exact = Config().exact_nn_levels
    ring = 2 * MESH_RANKS * exact      # directed launches per pair per rank
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(mesh_rank, MESH_RANKS, scan["cnt_b"], scan["stl_b"],
                   scan["seeds"])
    log(f"[mesh] {MESH_RANKS} ranks ({ranks[0]['backend']}, "
        f"{[r['device'] for r in ranks]}) done in "
        f"{time.perf_counter() - t0:.1f} s with the spawn")
    per_pair = {"nn_bidir": 0, "nn_directed": ring}
    bad = []
    for r in ranks:
        for rec in r["ring"]:
            kind = "integer" if rec["integer"] else "random"
            log(f"[mesh] 11a rank {r['rank']} L{rec['level']} {kind}: ring "
                f"bitwise nn_bidir a->b {rec['ab_bitwise']} b->a "
                f"{rec['ba_bitwise']} (indices differing {rec['ab_index_diff']}"
                f" / {rec['ba_index_diff']}, max |d diff| "
                f"{rec['ab_max_d_diff']:.3g} / {rec['ba_max_d_diff']:.3g}); "
                f"nn_directed launches {rec['launches']}")
            if not (rec["ab_bitwise"] and rec["ba_bitwise"]
                    and rec["launches"] == 2 * MESH_RANKS):
                bad.append(f"11a rank {r['rank']} L{rec['level']} {kind}")
            timed = rec.get("timed")
            if timed:
                steps = [round(v, 3) for v in timed["step_ms"]]
                log(f"[mesh] 11a rank {r['rank']} L{rec['level']}: ms per "
                    f"ring step {steps} (a->b, then b->a); ring a->b "
                    f"{timed['ring_ab_ms']:.3f} ms, b->a "
                    f"{timed['ring_ba_ms']:.3f} ms, one nn_bidir "
                    f"{timed['bidir_ms']:.3f} ms; host staging "
                    f"{timed['staging_ms']:.3f} ms, rotation wait "
                    f"{timed['wait_ms']:.3f} ms; matcher peak "
                    f"{timed['ring_peak_bytes'] / 2 ** 20:.1f} MiB against "
                    f"the single-card search's "
                    f"{timed['bidir_peak_bytes'] / 2 ** 20:.1f} MiB")
                directed.setdefault("ring_step_ms_L3", []).append(steps)
    single, single_iters = ranks[0]["pair_single"]
    mp = CONTENT_HW[0] * CONTENT_HW[1] / 1e6
    for r in ranks:
        p = r["pair"]
        warm = statistics.median(p["s"][1:] or p["s"])
        held, n_diff, max_diff = bitwise(torch, p["out"], single)
        log(f"[mesh] 11b rank {r['rank']} space mesh 1x{MESH_RANKS} pair "
            f"452x680 / 600x960 (row bands): {_timed(p['s'])}, "
            f"{mp / warm:.4f} MP/s, launches per pair {p['launches']}, "
            f"conv3x3 {p['conv3x3']}, "
            f"peak {p['peak_gib']:.2f} GiB; bitwise the single-process pair "
            f"{held} ({n_diff} values differ, max |diff| {max_diff}); "
            f"(nl, wls) iterations {p['iters']}, single process "
            f"{single_iters}")
        if (not held or p["launches"] != per_pair
                or p["conv3x3"] != CONVS_PER_PAIR):
            bad.append(f"11b rank {r['rank']}")
        if not torch.equal(p["out"], ranks[0]["pair"]["out"]):
            bad.append(f"11b rank {r['rank']} differs from rank 0")
    directed["ring_launches"] = ranks[0]["pair"]["launches"]["nn_directed"]
    conv["launches"] = ranks[0]["pair"]["conv3x3"]
    for label, key, bsz, want in (
            ("11c data mesh 2x1", "data", 4,
             [o.cpu() for o in scan["outs"]]),
            ("11d space mesh 1x2 bucket (row bands)", "bucket", 2,
             ranks[0]["bucket_single"]),
            ("11e space mesh 1x2 bucket, ring_nn=False", "replicated", 2,
             ranks[0]["bucket"]["out"])):
        for r in ranks:
            b = r[key]
            rules = [bitwise(torch, b["out"][i], want[i]) for i in range(bsz)]
            same = [h for h, _, _ in rules]
            what = ("bitwise the ring's bucket" if key == "replicated"
                    else "bitwise their single-process items")
            s_pair = statistics.median(b["s"][1:] or b["s"]) / bsz
            log(f"[mesh] {label} rank {r['rank']}: {_timed(b['s'])}, "
                f"{s_pair:.3f} s per pair of the bucket of {bsz} "
                f"({'warm' if len(b['s']) > 1 else 'cold'}), launches "
                f"{b['launches']}, items {b['items']}, conv3x3 "
                f"{b['conv3x3']}, peak "
                f"{b['peak_gib']:.2f} GiB; items {what}: {same} (values "
                f"differing {[n for _, n, _ in rules]})")
            if not all(same):
                bad.append(f"{label} rank {r['rank']}")
            if not all(torch.equal(b["out"][i], ranks[0][key]["out"][i])
                       for i in range(bsz)):
                bad.append(f"{label} rank {r['rank']} differs from rank 0")
    for r in ranks:
        c = r["comm"]
        log(f"[mesh] rank {r['rank']} band exchanges over phase 11: "
            + ", ".join(f"{k} {c[k + '_calls']} calls {c[k + '_s'] * 1e3:.1f}"
                        f" ms" for k in ("halo", "reduce", "gather",
                                         "exchange")))
    for r in ranks:
        if r["data"]["launches"] != {"nn_bidir": exact, "nn_directed": 0} or (
                r["data"]["items"]["nn_bidir"] != 2 * exact):
            bad.append(f"11c rank {r['rank']} launches")
        if r["bucket"]["launches"] != {"nn_bidir": 0, "nn_directed": ring} or (
                r["bucket"]["items"]["nn_directed"] != 2 * ring) or (
                r["bucket"]["conv3x3"] != 2 * CONVS_PER_PAIR):
            bad.append(f"11d rank {r['rank']} launches")
        if r["replicated"]["launches"] != {
                "nn_bidir": exact, "nn_directed": 0} or (
                r["replicated"]["items"]["nn_bidir"] != 2 * exact):
            bad.append(f"11e rank {r['rank']} launches")
    if bad:
        raise AssertionError(f"phase 11 failed: {bad}")


# phase 12: the Caffe framework's Net at the published widths of two
# ILSVRC deploy nets (VGG_ILSVRC_19_layers_deploy.prototxt and
# bvlc_reference_caffenet/deploy.prototxt), written with the port's NetSpec
VGG_TAPS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
VGG_TAP_RTOL = 2e-3    # Net taps vs models.vgg19 (tests/test_nn.py's bound)
# card vs CPU: max |difference| over max |CPU value| of a blob, and the
# same top-5 classes of fc8 per row
NET_CARD_CPU_RTOL = 2e-3
PROB_SUM_TOL = 1e-5    # each prob row of Classifier.predict sums to 1
# phase 12d: card vs CPU of every case of tests/torch_caffe_cases.py (the
# card's math library and summation order differ from the CPU's)
CASE_RTOL, CASE_ATOL = 1e-4, 1e-5
# fc weights of the two nets (bvlc_reference_caffenet/train_val.prototxt's
# fillers); VGG-19's convolutions come from models.vgg19.init_params
FC_FILLERS = ((0.005, 1.0), (0.005, 1.0), (0.01, 0.0))
# the published inputs and widths (a CPU rehearsal shrinks them)
VGG_INPUT = (10, 3, 224, 224)
CAFFENET_INPUT = (10, 3, 227, 227)
NET_WIDTHS = {"div": 1, "fc": 4096, "classes": 1000}


def _fc_head(L, n, x, fc: int, classes: int, prob: bool = True) -> None:
    """fc6 / fc7 with ReLU and Dropout, fc8, and prob unless ``prob`` is
    False (both deploy nets and CaffeNet's train_val)."""
    for i, (name, width) in enumerate((("fc6", fc), ("fc7", fc),
                                       ("fc8", classes))):
        std, bias = FC_FILLERS[i]
        n[name] = L.InnerProduct(
            x, num_output=width,
            weight_filler=dict(type="gaussian", std=std),
            bias_filler=dict(type="constant", value=bias))
        x = n[name]
        if name != "fc8":
            n[f"relu{name[2]}"] = L.ReLU(x, in_place=True)
            n[f"drop{name[2]}"] = L.Dropout(x, in_place=True,
                                            dropout_ratio=0.5)
    if prob:
        n.prob = L.Softmax(x)


def vgg19_deploy(batch=10, h=224, w=224, div=1, fc=4096, classes=1000):
    """VGG_ILSVRC_19_layers_deploy as a NetParameter dict (``div`` narrows
    every convolution for tests)."""
    from nct_tpu_torch.models.vgg19 import VGG19_CONV_LAYERS
    from nct_tpu_torch.nn import L, NetSpec

    n = NetSpec()
    n.data = L.Input(shape=dict(dim=[batch, 3, h, w]))
    x = n.data
    names = [name for name, _ in VGG19_CONV_LAYERS]
    for i, (name, c) in enumerate(VGG19_CONV_LAYERS):
        n[name] = L.Convolution(x, num_output=c // div, kernel_size=3, pad=1)
        n[f"relu{name[4:]}"] = L.ReLU(n[name], in_place=True)
        x = n[name]
        if i + 1 == len(names) or names[i + 1][4] != name[4]:
            n[f"pool{name[4]}"] = L.Pooling(x, pool="MAX", kernel_size=2,
                                           stride=2)
            x = n[f"pool{name[4]}"]
    _fc_head(L, n, x, fc, classes)
    return n.to_dict(name="VGG_ILSVRC_19_layers")


def caffenet_deploy(batch=10, h=227, w=227, div=1, fc=4096, classes=1000):
    """bvlc_reference_caffenet deploy as a NetParameter dict, with the
    train_val fillers."""
    from nct_tpu_torch.nn import L, NetSpec

    n = NetSpec()
    n.data = L.Input(shape=dict(dim=[batch, 3, h, w]))
    _caffenet_body(L, n, div)
    _fc_head(L, n, n.pool5, fc, classes)
    return n.to_dict(name="CaffeNet")


# ImageNet's BGR channel means (the values train_val's mean_file holds on
# average), in place of the published imagenet_mean.binaryproto
IMAGENET_MEAN_BGR = (104, 117, 123)


def caffenet_train_val(source: str, root: str = "", batch=256, crop=227,
                       div=1, fc=4096, classes=1000, data="ImageData",
                       mean_file: str | None = None):
    """bvlc_reference_caffenet train_val (TRAIN phase) as a NetParameter
    dict: its published widths, fillers and loss, fed by ``data``:
    ImageData over the list ``source`` under ``root`` (crop, mirror, the
    BGR mean values, shuffled) in place of the LMDB ``Data`` layer; the
    published ``Data`` layer over the record shards, LMDB or LevelDB
    ``source`` (crop, mirror, ``mean_file``); or WindowData over the
    window file ``source`` under ``root``, as R-CNN fine-tunes CaffeNet
    (fg / bg thresholds 0.5, fg_fraction 0.25, context_pad 16, mirror, the
    BGR mean values)."""
    from nct_tpu_torch.nn import L, NetSpec

    n = NetSpec()
    transform = dict(crop_size=crop, mirror=True)
    if data == "Data":
        n.data, n.label = L.Data(
            ntop=2, data_param=dict(source=source, batch_size=batch),
            transform_param=dict(transform, mean_file=mean_file))
    elif data == "WindowData":
        n.data, n.label = L.WindowData(
            ntop=2, window_data_param=dict(
                source=source, root_folder=root, batch_size=batch,
                fg_threshold=0.5, bg_threshold=0.5, fg_fraction=0.25,
                context_pad=16),
            transform_param=dict(transform,
                                 mean_value=list(IMAGENET_MEAN_BGR)))
    else:
        n.data, n.label = L.ImageData(
            ntop=2, image_data_param=dict(source=source, root_folder=root,
                                          batch_size=batch, shuffle=True),
            transform_param=dict(transform,
                                 mean_value=list(IMAGENET_MEAN_BGR)))
    _caffenet_body(L, n, div)
    _fc_head(L, n, n.pool5, fc, classes, prob=False)
    n.loss = L.SoftmaxWithLoss(n.fc8, n.label)
    return n.to_dict(name="CaffeNet")


def _caffenet_body(L, n, div: int) -> None:
    """conv1 .. pool5 of bvlc_reference_caffenet on ``n.data``."""

    def conv(x, c, k, std, bias, **kw):
        return L.Convolution(x, num_output=c // div, kernel_size=k,
                             weight_filler=dict(type="gaussian", std=std),
                             bias_filler=dict(type="constant", value=bias),
                             **kw)

    def pool(x):
        return L.Pooling(x, pool="MAX", kernel_size=3, stride=2)

    n.conv1 = conv(n.data, 96, 11, 0.01, 0.0, stride=4)
    n.relu1 = L.ReLU(n.conv1, in_place=True)
    n.pool1 = pool(n.conv1)
    n.norm1 = L.LRN(n.pool1, local_size=5, alpha=1e-4, beta=0.75)
    n.conv2 = conv(n.norm1, 256, 5, 0.01, 1.0, pad=2, group=2)
    n.relu2 = L.ReLU(n.conv2, in_place=True)
    n.pool2 = pool(n.conv2)
    n.norm2 = L.LRN(n.pool2, local_size=5, alpha=1e-4, beta=0.75)
    n.conv3 = conv(n.norm2, 384, 3, 0.01, 0.0, pad=1)
    n.relu3 = L.ReLU(n.conv3, in_place=True)
    n.conv4 = conv(n.conv3, 384, 3, 0.01, 1.0, pad=1, group=2)
    n.relu4 = L.ReLU(n.conv4, in_place=True)
    n.conv5 = conv(n.conv4, 256, 3, 0.01, 1.0, pad=1, group=2)
    n.relu5 = L.ReLU(n.conv5, in_place=True)
    n.pool5 = pool(n.conv5)


def net_flops(net, input_shapes: dict) -> float:
    """2 x the multiply-adds of the Convolution, Deconvolution and
    InnerProduct layers of ``net`` at ``input_shapes``."""
    shapes, _ = net.blob_shapes(input_shapes)
    params = net.params
    total = 0.0
    for cfg in net.layers:
        ltype, name = str(cfg.get("type")), str(cfg.get("name"))
        if ltype not in ("Convolution", "Deconvolution", "InnerProduct"):
            continue
        w = params[name]["w"]
        top = shapes[str(cfg.get("top"))]
        bottom = shapes[str(cfg.get("bottom"))]
        if ltype == "InnerProduct":
            total += 2.0 * top[0] * w.numel()
        elif ltype == "Convolution":       # per output element: w[0] / O
            total += 2.0 * math.prod(top) * w[0].numel()
        else:                              # per input element
            total += 2.0 * math.prod(bottom) * w[0].numel()
    return total


def _rel_err(torch, got, want) -> float:
    want = want.float().cpu()
    return float((got.float().cpu() - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def _warm_ms(torch, fn, runs: int = 5) -> list[float]:
    """CUDA-event ms of ``runs`` calls after one warm call."""
    fn()
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _card_and_cpu(torch, spec, shapes, seed: int, params=None):
    """(card net, CPU net) of ``spec`` with the same weights: ``params``
    (on the card) where given, filler draws for the rest."""
    from nct_tpu_torch.nn import Net

    card = Net(spec, device="cuda")
    for name, entry in (params or {}).items():
        card.set_params(name, entry)
    card.init_params(shapes, seed)
    cpu = Net(spec, device="cpu")
    for name, entry in card.params.items():
        cpu.set_params(name, {k: v.cpu() for k, v in entry.items()})
    return card, cpu


def _compare_nets(torch, label, card, cpu, x, smi) -> None:
    """fc8 and prob of the card net against the CPU net on ``x``."""
    got = card.forward({"data": x}, ("fc8", "prob"))
    want = cpu.forward({"data": x}, ("fc8", "prob"))
    errs = {k: _rel_err(torch, got[k], want[k]) for k in ("fc8", "prob")}
    top_card = torch.topk(got["fc8"].cpu(), 5).indices
    top_cpu = torch.topk(want["fc8"], 5).indices
    log(f"[caffe] {label} card vs CPU on {tuple(x.shape)}: max rel err fc8 "
        f"{errs['fc8']:.3g} prob {errs['prob']:.3g} (<= {NET_CARD_CPU_RTOL})"
        f"; top-5 equal {torch.equal(top_card, top_cpu)} "
        f"(row 0 {top_cpu[0].tolist()})  [{smi}]")
    if max(errs.values()) > NET_CARD_CPU_RTOL or not torch.equal(
            top_card, top_cpu):
        raise AssertionError(f"phase 12 {label}: card and CPU disagree")


def _timed_net(torch, label, net, x, smi, peaks) -> dict:
    """Warm median ms of a forward of batch ``x`` (5 runs after 1)."""
    from nct_tpu_torch.utils import flops

    with torch.no_grad():
        ms = _warm_ms(torch, lambda: net.forward({"data": x}, ("prob",)))
    med = statistics.median(ms)
    f = net_flops(net, {"data": tuple(x.shape)})
    f32 = flops.F32_PEAKS.get(torch.cuda.get_device_name())
    log(f"[caffe] {label} batch {x.shape[0]}: warm median {med:.3f} ms "
        f"(runs {[round(v, 3) for v in ms]}), {x.shape[0] / med * 1e3:.1f} "
        f"images/s, {f / 1e9:.2f} GFLOP, {f / med / 1e9:.2f} TFLOP/s = "
        f"{f / med / 1e-3 / peaks[0]:.4f} of device_peaks' {peaks[0] / 1e12:.0f}"
        f" TFLOP/s (bf16)" + (f", {f / med / 1e-3 / f32:.4f} of the {f32 / 1e12:.0f}"
                              f" TFLOP/s float32 peak" if f32 else "")
        + f"  [{smi}]")
    return {"ms": med, "runs_ms": ms, "gflop": f / 1e9}


def check_caffe(torch, smi: str) -> dict:
    """Phase 12: the port's Caffe framework on the card (12a VGG-19, 12b
    CaffeNet, 12c the tools, 12d every other layer type)."""
    import os
    import tempfile

    import numpy as np

    from nct_tpu_torch.data import png
    from nct_tpu_torch.models import vgg19
    from nct_tpu_torch.nn import LAYER_REGISTRY, emit_prototxt
    from nct_tpu_torch.nn.apps import Classifier, load_image
    from nct_tpu_torch.nn.net import Net
    from nct_tpu_torch.tools import caffe_tool
    from nct_tpu_torch.utils import flops

    from nct_tpu_torch.ops import cuda_nn

    peaks = flops.device_peaks()
    gen = torch.Generator().manual_seed(12)
    reset_counts()
    result = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_caffe_")

    # 12a: VGG-19 deploy, convolutions from models.vgg19, fc from fillers
    t0 = time.perf_counter()
    spec = vgg19_deploy(*VGG_INPUT[:1], *VGG_INPUT[2:], **NET_WIDTHS)
    model = vgg19.init_params()
    convs = {name: {"w": conv.weight, "b": conv.bias}
             for name, conv in model.convs.items()}
    shapes = {"data": VGG_INPUT}
    vgg, vgg_cpu = _card_and_cpu(torch, spec, shapes, 0, convs)
    n_params = sum(v.numel() for e in vgg.params.values() for v in e.values())
    log(f"[caffe] 12a VGG-19: {len(vgg.layers)} layers, {n_params} "
        f"parameters, built in {time.perf_counter() - t0:.1f} s")
    img = torch.randint(0, 256, VGG_INPUT[2:] + (3,), generator=gen,
                        dtype=torch.uint8)
    mean = torch.tensor(vgg19.BGR_MEAN)
    x1 = (img.float() - mean).permute(2, 0, 1)[None]
    blobs = vgg.forward({"data": x1}, VGG_TAPS)
    taps = model.cuda()(img.cuda(), VGG_TAPS)
    errs = {t: _rel_err(torch, blobs[t][0].permute(1, 2, 0), taps[t])
            for t in VGG_TAPS}
    log(f"[caffe] 12a Net taps vs models.vgg19 (f32, TF32 off): max rel err "
        f"{ {t: float(f'{e:.3g}') for t, e in errs.items()} } "
        f"(<= {VGG_TAP_RTOL})  [{smi}]")
    if max(errs.values()) > VGG_TAP_RTOL:
        raise AssertionError("phase 12a: Net taps differ from models.vgg19")
    _compare_nets(torch, "12a VGG-19", vgg, vgg_cpu, x1, smi)
    del vgg_cpu
    # Classifier.predict, 10-crop oversampling of two PNGs
    paths = []
    side = VGG_INPUT[2] + 32
    for i, (h, w) in enumerate(((side, side + 64), (side + 44, side))):
        smooth = torch.nn.functional.interpolate(
            torch.rand(1, 3, h // 16, w // 16, generator=gen) * 255,
            size=(h, w), mode="bilinear", align_corners=False)
        path = os.path.join(tmp, f"img{i}.png")
        png.write(path, smooth[0].permute(1, 2, 0).round().byte().numpy())
        paths.append(path)
    clf = Classifier(spec, image_dims=(side, side), raw_scale=255.0,
                     channel_swap=(2, 1, 0), mean=np.asarray(vgg19.BGR_MEAN),
                     device="cuda")
    for name, entry in vgg.params.items():
        clf.net.set_params(name, entry)
    probs = clf.predict([load_image(p) for p in paths], oversample_crops=True)
    sums = probs.sum(axis=1)
    log(f"[caffe] 12a Classifier.predict, 2 PNGs x 10 crops: prob shape "
        f"{probs.shape}, row sums {sums.tolist()}, top-5 "
        f"{np.argsort(-probs, 1)[:, :5].tolist()}")
    if (probs.shape != (2, NET_WIDTHS["classes"])
            or np.abs(sums - 1).max() > PROB_SUM_TOL):
        raise AssertionError("phase 12a: Classifier rows do not sum to 1")
    del clf
    xb = torch.randn(VGG_INPUT, generator=gen).cuda() * 60
    result["vgg19"] = _timed_net(torch, "12a VGG-19", vgg, xb, smi, peaks)
    # the same batch with cuDNN's autotuned algorithms (the port's default
    # leaves cudnn.benchmark off: its heuristics pick per shape)
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        result["vgg19_autotuned"] = _timed_net(
            torch, "12a VGG-19 (cudnn.benchmark)", vgg, xb, smi, peaks)
    finally:
        torch.backends.cudnn.benchmark = prev

    # 12b: CaffeNet deploy, every weight from the train_val fillers
    shapes = {"data": CAFFENET_INPUT}
    cspec = caffenet_deploy(*CAFFENET_INPUT[:1], *CAFFENET_INPUT[2:],
                            **NET_WIDTHS)
    cnet, cnet_cpu = _card_and_cpu(torch, cspec, shapes, 1)
    xc = torch.randn(shapes["data"], generator=gen) * 60
    _compare_nets(torch, "12b CaffeNet", cnet, cnet_cpu, xc, smi)
    del cnet_cpu
    result["caffenet"] = _timed_net(torch, "12b CaffeNet", cnet, xc.cuda(),
                                    smi, peaks)

    # 12c: the tools in process
    path = os.path.join(tmp, "vgg19_deploy.prototxt")
    with open(path, "w") as f:
        f.write(emit_prototxt(spec))
    log(f"[caffe] 12c caffe_tool time on 12a's net  [{smi}]")
    rc = caffe_tool.main(["time", path, "--device", "cuda",
                          "--iterations", "5"])
    if rc:
        raise AssertionError(f"phase 12c: caffe_tool time exited {rc}")
    test_net = os.path.join(tmp, "dummy_test.prototxt")
    with open(test_net, "w") as f:
        f.write(DUMMY_TEST_NET)
    rc = caffe_tool.main(["test", "--model", test_net, "--iterations", "5",
                          "--device", "cuda"])
    net = caffe_tool.load_net(test_net, "cuda")
    net.init_params({}, seed=0)
    scores = caffe_tool.score_net(net, 5)
    log(f"[caffe] 12c caffe_tool test: exit {rc}, {scores}")
    if rc or not (np.isfinite(scores["loss"])
                  and 0.0 <= scores["accuracy"] <= 1.0):
        raise AssertionError("phase 12c: caffe_tool test failed")

    # 12d: every other layer type (and the extra pooling / LRN modes)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_caffe_cases import case_inputs, cases

    covered = {str(c.get("type")) for s in (spec, cspec)
               for c in s["layer"]}
    covered |= {str(c.get("type")) for c in net.layers}
    run, bad = set(), []
    for case in cases():
        if case.layer_type == "HDF5Output":
            continue
        inputs = case_inputs(case)
        proto = case.prototxt(inputs)
        cpu = Net(proto, device="cpu")
        for name, entry in (case.params or {}).items():
            cpu.set_params(name, entry)
        if case.init:
            cpu.init_params({k: v.shape for k, v in inputs.items()})
        card = Net(proto, device="cuda")
        for name, entry in cpu.params.items():
            card.set_params(name, entry)
        feed = {k: torch.from_numpy(v) for k, v in inputs.items()}
        want = cpu.forward(feed, case.outputs)
        got = card.forward(feed, case.outputs)
        for k in case.outputs:
            if not torch.allclose(got[k].cpu(), want[k], rtol=CASE_RTOL,
                                  atol=CASE_ATOL):
                bad.append(f"{case.name}:{k}")
        run.add(case.layer_type)
    log(f"[caffe] 12d {len(run)} layer types, card vs CPU (rtol {CASE_RTOL}, "
        f"atol {CASE_ATOL}): {sorted(run)}; not run on the card: "
        f"['HDF5Output'] (no h5py there); mismatches {bad}")
    missing = set(LAYER_REGISTRY) - run - covered - {"HDF5Output"}
    log(f"[caffe] NN kernel launches in phase 12: {dict(cuda_nn.LAUNCHES)} "
        f"(the Caffe framework runs none)")
    if bad or missing:
        raise AssertionError(f"phase 12d: mismatches {bad}, types never run "
                             f"{sorted(missing)}")
    return result


DUMMY_TEST_NET = """name: "dummy_test"
layer { name: "data" type: "DummyData" top: "data" top: "label"
  dummy_data_param { shape { dim: 64 dim: 32 } shape { dim: 64 }
    data_filler { type: "gaussian" std: 1.0 }
    data_filler { type: "uniform" min: 0 max: 9.999 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
layer { name: "accuracy" type: "Accuracy" bottom: "ip" bottom: "label"
  top: "accuracy" }
"""


def small_train_net(batch: int, dropout: bool = True,
                    memory_data: bool = True, image_list: str | None = None,
                    hw: int = 12, crop: bool = False, root: str = "",
                    records: str | None = None) -> str:
    """A small TRAIN net (conv, ReLU, max pool, InnerProduct, ReLU,
    Dropout, InnerProduct, SoftmaxWithLoss) fed by MemoryData, by Input
    layers, by ImageData over ``image_list`` under ``root`` (resized to
    hw x hw, or with ``crop`` random hw x hw crops and mirror), or by a
    ``Data`` layer over the record shards, LMDB or LevelDB ``records``
    (random hw x hw crops and mirror)."""
    if records:
        data = (f'layer {{ name: "data" type: "Data" top: "data" '
                f'top: "label" data_param {{ source: "{records}" '
                f'batch_size: {batch} }} transform_param {{ crop_size: {hw} '
                f'mirror: true scale: 0.0078125 mean_value: 128 }} }}\n')
    elif image_list:
        size = (f'crop_size: {hw} mirror: true ' if crop else '')
        resize = ('' if crop else f'new_height: {hw} new_width: {hw} ')
        data = (f'layer {{ name: "data" type: "ImageData" top: "data" '
                f'top: "label" image_data_param {{ source: "{image_list}" '
                f'root_folder: "{root}" batch_size: {batch} {resize}'
                f'shuffle: true }} transform_param {{ {size}'
                f'scale: 0.0078125 mean_value: 128 }} }}\n')
    elif memory_data:
        data = (f'layer {{ name: "data" type: "MemoryData" top: "data" '
                f'top: "label" memory_data_param {{ batch_size: {batch} '
                f'channels: 3 height: {hw} width: {hw} }} }}\n')
    else:
        data = (f'layer {{ name: "data" type: "Input" top: "data" '
                f'top: "label" input_param {{ shape {{ dim: {batch} dim: 3 '
                f'dim: {hw} dim: {hw} }} shape {{ dim: {batch} }} }} }}\n')
    drop = ('layer { name: "drop1" type: "Dropout" bottom: "ip1" top: "ip1" '
            'dropout_param { dropout_ratio: 0.5 } }\n') if dropout else ""
    return ('name: "small_train"\n' + data +
            'layer { name: "conv1" type: "Convolution" bottom: "data" '
            'top: "conv1" convolution_param { num_output: 6 kernel_size: 3 '
            'pad: 1 weight_filler { type: "gaussian" std: 0.1 } '
            'bias_filler { type: "constant" value: 0.1 } } }\n'
            'layer { name: "relu1" type: "ReLU" bottom: "conv1" '
            'top: "conv1" }\n'
            'layer { name: "pool1" type: "Pooling" bottom: "conv1" '
            'top: "pool1" pooling_param { pool: MAX kernel_size: 2 '
            'stride: 2 } }\n'
            'layer { name: "ip1" type: "InnerProduct" bottom: "pool1" '
            'top: "ip1" inner_product_param { num_output: 16 '
            'weight_filler { type: "xavier" } } }\n'
            'layer { name: "relu2" type: "ReLU" bottom: "ip1" top: "ip1" }\n'
            + drop +
            'layer { name: "ip2" type: "InnerProduct" bottom: "ip1" '
            'top: "ip2" inner_product_param { num_output: 4 '
            'weight_filler { type: "xavier" } } }\n'
            'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" '
            'bottom: "label" top: "loss" }\n')


def _small_solver(text: str, device, mesh=None):
    """A Solver over ``small_train_net`` text with seed-0 filler weights."""
    from nct_tpu_torch.nn import Net, parse_prototxt
    from nct_tpu_torch.train import (LrPolicy, OptimizerParams, Solver,
                                     SolverParams)

    net = Net(parse_prototxt(text), phase="TRAIN", device=device)
    net.init_params(net.input_shapes, seed=0)
    sp = SolverParams(lr=LrPolicy("fixed", base_lr=0.01),
                      opt=OptimizerParams("sgd", momentum=0.9,
                                          weight_decay=0.0005))
    return Solver(net.make_loss_fn(), net.params, sp, mesh=mesh)


def _solver_result(solver, loss) -> dict:
    return {"loss": loss, "params": {
        k: {b: v.detach().cpu().numpy() for b, v in e.items()}
        for k, e in solver.params.items()}}


MESH_NET_SOLVER_ITERS = 3


def _image_net_solver(image_list: str, root: str, iters: int, device,
                      mesh=None):
    """A NetSolver of ``small_train_net`` with Dropout over ImageData
    (random 12 x 12 crops and mirror of the listed images, batch 8)."""
    from nct_tpu_torch.nn import parse_prototxt
    from nct_tpu_torch.train.solver_proto import (NetSolver,
                                                  parse_solver_prototxt)

    proto = parse_solver_prototxt(
        f'base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
        f'lr_policy: "fixed"\nmax_iter: {iters}\nrandom_seed: 4\n')
    proto.net = parse_prototxt(small_train_net(
        8, image_list=image_list, crop=True, root=root))
    return NetSolver(proto, mesh=mesh, device=None if mesh else device)


def train_cases(batch: dict, image_list: str, root: str, device,
                mesh=None) -> dict:
    """Phase 13e's cases, in this process or as one rank of ``mesh``:
    one Solver step of ``small_train_net`` on ``batch`` without and with
    Dropout (a mesh rank gets the whole batch and takes its block), and
    MESH_NET_SOLVER_ITERS NetSolver iterations over ImageData with Dropout
    (a mesh rank reads its block of each batch), with the images decoded."""
    import torch

    out = {}
    for dropout in (False, True):
        batch_in = dict(batch)
        if dropout:
            batch_in["__generator__"] = torch.Generator(
                device=device).manual_seed(11)
        solver = _small_solver(small_train_net(
            8, dropout=dropout, memory_data=False), device, mesh)
        out["dropout" if dropout else "plain"] = _solver_result(
            solver, solver.step(batch_in))
    ns = _image_net_solver(image_list, root, MESH_NET_SOLVER_ITERS, device,
                           mesh)
    out["net_solver"] = dict(_solver_result(ns.solver, ns.solve()),
                             decoded=ns.data_source.decoded)
    return out


def train_mesh_rank(batch: dict, image_list: str, root: str, n_data: int,
                    device) -> dict:
    """One rank of ``train_cases`` over an n_data x 1 data mesh (run by
    ``parallel.mesh.launch``)."""
    from nct_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=n_data, device=device)
    return train_cases(batch, image_list, root, mesh.device, mesh)


# phase 13: the JPEG fixtures, CaffeNet training at its published widths
JPEG_FIXTURES = ("tests", "fixtures", "jpeg")
PAIR_JPEGS = (("pair_content.jpg", "pair_style.jpg"),
              ("pair_content_progressive.jpg", "pair_style_progressive.jpg"))
TRAIN_BATCH = 256
TRAIN_ITERS = 12
TRAIN_CARD_CPU_BATCH = 8
TRAIN_CARD_CPU_STEPS = 3
TRAIN_CARD_CPU_RTOL = 1e-4
MESH_STEP_RTOL, MESH_STEP_ATOL = 1e-6, 1e-7
RESUME_DEFAULT_RTOL, RESUME_DEFAULT_ATOL = 1e-4, 1e-6
# bvlc_reference_caffenet/solver.prototxt, max_iter cut to phase 13c's run
# and test_interval dropped (the train_val's TEST branch reads an LMDB)
CAFFENET_SOLVER = """base_lr: 0.01
lr_policy: "step"
gamma: 0.1
stepsize: 100000
display: 20
max_iter: {max_iter}
momentum: 0.9
weight_decay: 0.0005
snapshot: 0
random_seed: 0
"""
# the published widths (a CPU rehearsal shrinks them)
CAFFENET_TRAIN_WIDTHS = {"div": 1, "fc": 4096, "classes": 1000}


def _fixtures_dir() -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        *JPEG_FIXTURES)


def check_jpeg(torch, smi: str) -> dict:
    """13a: every JPEG fixture decoded by the port against the sha256 of
    Pillow's decode, and the host decode time of the 452x680 / 600x960
    pair (baseline and progressive)."""
    import hashlib
    import os

    from nct_tpu_torch.data import jpeg

    fix = _fixtures_dir()
    with open(os.path.join(fix, "digests.json")) as f:
        digests = json.load(f)
    bad = []
    for name, want in sorted(digests.items()):
        img = jpeg.read(os.path.join(fix, name))
        if (list(img.shape) != want["shape"] or hashlib.sha256(
                img.tobytes()).hexdigest() != want["sha256"]):
            bad.append(name)
    log(f"[jpeg] {len(digests) - len(bad)} / {len(digests)} fixtures bitwise "
        f"Pillow's decode (sha256)")
    if bad:
        raise AssertionError(f"phase 13a: decodes differ from Pillow's: {bad}")
    times = {}
    for name in (n for pair in PAIR_JPEGS for n in pair):
        with open(os.path.join(fix, name), "rb") as f:
            data = f.read()
        img = jpeg.decode(data)
        runs = []
        for _ in range(7):
            t0 = time.perf_counter()
            jpeg.decode(data)
            runs.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(runs)
        mp = img.shape[0] * img.shape[1] / 1e6
        times[name] = ms
        log(f"[jpeg] host decode {name} {img.shape[1]}x{img.shape[0]}: "
            f"median {ms:.3f} ms of 7 = {ms / mp:.3f} ms/MP (one host thread "
            f"of the card's machine)  [{smi}]")
    return times


def check_jpeg_cli(torch) -> None:
    """13b: the CLI on the card over the JPEG pair and its progressive twin
    and over the same pixels written as PNG: outputs bitwise equal."""
    import os
    import tempfile

    from nct_tpu_torch import io as tio
    from nct_tpu_torch.data import jpeg, png

    fix = _fixtures_dir()
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        lines, outs = [], []
        for cnt, stl in PAIR_JPEGS:
            for name in (cnt, stl):
                with open(os.path.join(fix, name), "rb") as f:
                    data = f.read()
                with open(os.path.join(src, name), "wb") as f:
                    f.write(data)
                png.write(os.path.join(src, "png_" + name[:-4] + ".png"),
                          jpeg.decode(data))
            stems = (cnt[:-4], stl[:-4])
            lines += [f"{cnt} {stl} 2.0",
                      f"png_{stems[0]}.png png_{stems[1]}.png 2.0"]
            outs.append((f"{stems[0]}_{stems[1]}_2.00.png",
                         f"png_{stems[0]}_png_{stems[1]}_2.00.png"))
        with open(os.path.join(src, "pairs.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nct_tpu_torch.cli", "-i", src, "-o", dst,
             "--device", "cuda"], capture_output=True, text=True, cwd=repo,
            env=dict(os.environ, PYTHONPATH=repo), timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"phase 13b: the CLI exited "
                                 f"{proc.returncode}:\n{proc.stdout}\n"
                                 f"{proc.stderr}")
        per_pair = [float(v.split()[2]) for v in proc.stdout.splitlines()
                    if v.startswith("**Finished Time:")]
        for from_jpeg, from_png in outs:
            a = tio.imread_bgr(os.path.join(dst, from_jpeg))
            b = tio.imread_bgr(os.path.join(dst, from_png))
            if a.shape != b.shape or not (a == b).all():
                raise AssertionError(f"phase 13b: {from_jpeg} differs from "
                                     f"{from_png}")
    log(f"[jpeg] CLI --device cuda on 2 JPEG pairs (baseline, progressive) "
        f"and their PNG twins: each output bitwise its PNG twin's; "
        f"{wall:.1f} s for the process, per pair (JPEG, PNG, JPEG, PNG) "
        f"{per_pair} s")


def _caffenet_solver(torch, batch: int, iters: int, device):
    """A NetSolver of CaffeNet's train_val over the ImageData fixtures and
    the published solver (max_iter cut to ``iters``)."""
    import os

    from nct_tpu_torch.train.solver_proto import (NetSolver,
                                                  parse_solver_prototxt)

    fix = os.path.join(_fixtures_dir(), "imagedata")
    proto = parse_solver_prototxt(CAFFENET_SOLVER.format(max_iter=iters))
    proto.net = caffenet_train_val(os.path.join(fix, "list.txt"), fix + "/",
                                   batch=batch, **CAFFENET_TRAIN_WIDTHS)
    return NetSolver(proto, device=device)


def _event_ms(torch, fn):
    """(CUDA-event ms of one call, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def check_caffenet_training(torch, smi: str) -> dict:
    """13c: CaffeNet train_val at its published widths and solver, batch
    256 from ImageData over the 16 fixture JPEGs: 12 NetSolver iterations
    (finite losses), 20 steps on one resident batch (falling loss), times,
    and the card against the CPU over 3 steps at batch 8."""
    import math as _math

    from nct_tpu_torch.utils import flops

    t0 = time.perf_counter()
    ns = _caffenet_solver(torch, TRAIN_BATCH, TRAIN_ITERS, "cuda")
    n_params = sum(v.numel() for e in ns.net.params.values()
                   for v in e.values())
    log(f"[train] CaffeNet train_val, batch {TRAIN_BATCH} "
        f"{ns.input_shapes['data']}, {n_params / 1e6:.1f}M parameters: "
        f"set up in {time.perf_counter() - t0:.1f} s")
    stream = ns.batches()
    losses, feed_ms = [], []
    for _ in range(TRAIN_ITERS):
        ms, loss = _event_ms(torch, lambda: ns.solver.step(next(stream)))
        feed_ms.append(ms)
        losses.append(loss)
    if not all(_math.isfinite(v) for v in losses):
        raise AssertionError(f"phase 13c: non-finite loss {losses}")
    log(f"[train] {TRAIN_ITERS} NetSolver iterations: losses "
        f"{[round(v, 4) for v in losses]}")
    fixed = {k: torch.as_tensor(v).cuda() for k, v in ns.next_batch().items()}
    fixed_losses, dev_ms = [], []
    for _ in range(TRAIN_ITERS):
        batch = dict(fixed, __generator__=ns.step_generator(ns.solver.iter))
        ms, loss = _event_ms(torch, lambda: ns.solver.step(batch))
        dev_ms.append(ms)
        fixed_losses.append(loss)
    log(f"[train] {TRAIN_ITERS} steps on one resident batch: losses "
        f"{[round(v, 4) for v in fixed_losses]}")
    if not (all(_math.isfinite(v) for v in fixed_losses)
            and fixed_losses[-1] < fixed_losses[0]):
        raise AssertionError("phase 13c: the loss on a fixed batch does not "
                             "fall")
    fwd = net_flops(ns.net, ns.input_shapes)
    f32 = flops.F32_PEAKS.get(torch.cuda.get_device_name())
    out = {}
    for label, runs in (("device only (resident batch)", dev_ms[2:]),
                        ("with the ImageData host feed", feed_ms[2:])):
        med = statistics.median(runs)
        tf = 3 * fwd / med / 1e9
        out[label] = med
        log(f"[train] warm ms per iteration, {label}: median {med:.3f} of "
            f"{len(runs)} (CUDA events; {min(runs):.3f}-{max(runs):.3f}), "
            f"{TRAIN_BATCH / med * 1e3:.1f} images/s, {tf:.2f} TFLOP/s at "
            f"3 x {fwd / 1e9:.1f} GFLOP forward" + (
                f" = {tf * 1e12 / f32:.4f} of the {f32 / 1e12:.0f} TFLOP/s "
                f"float32 peak" if f32 else "") + f"  [{smi}]")
    del ns, stream, fixed
    torch.cuda.empty_cache()

    # the card against the CPU, Dropout masks from CPU generators
    card = _caffenet_solver(torch, TRAIN_CARD_CPU_BATCH, 10, "cuda")
    cpu = _caffenet_solver(torch, TRAIN_CARD_CPU_BATCH, 10, "cpu")
    pairs = []
    for i in range(TRAIN_CARD_CPU_STEPS):
        got = card.solver.step(dict(card.next_batch(), __generator__=(
            torch.Generator().manual_seed(100 + i))))
        want = cpu.solver.step(dict(cpu.next_batch(), __generator__=(
            torch.Generator().manual_seed(100 + i))))
        pairs.append((got, want))
    rel = max(abs(g - w) / abs(w) for g, w in pairs)
    log(f"[train] card vs CPU, batch {TRAIN_CARD_CPU_BATCH}, "
        f"{TRAIN_CARD_CPU_STEPS} steps (TF32 off): losses "
        f"{[(round(g, 6), round(w, 6)) for g, w in pairs]}, max rel "
        f"{rel:.3g} (<= {TRAIN_CARD_CPU_RTOL})")
    if rel > TRAIN_CARD_CPU_RTOL:
        raise AssertionError("phase 13c: card and CPU losses disagree")
    return out


def check_train_resume(torch) -> None:
    """13d: ``caffe_tool train --deterministic`` in a new process, snapshot
    at iteration 4 of 8, then a second process restoring it: the final
    params and history bitwise the uninterrupted run's.  A third process
    restores it without ``--deterministic`` (cuDNN free to pick
    non-deterministic algorithms): within RESUME_DEFAULT_RTOL / ATOL."""
    import os
    import tempfile

    import numpy as np

    repo = os.path.dirname(os.path.abspath(__file__))
    fix = os.path.join(_fixtures_dir(), "imagedata")
    with tempfile.TemporaryDirectory() as tmp:
        net = os.path.join(tmp, "net.prototxt")
        with open(net, "w") as f:
            f.write(small_train_net(16, image_list=os.path.join(
                fix, "list.txt"), hw=32, root=fix + "/"))
        for prefix in ("whole", "resumed", "default"):
            with open(os.path.join(tmp, f"{prefix}.prototxt"), "w") as f:
                f.write(f'net: "{net}"\nbase_lr: 0.01\nmomentum: 0.9\n'
                        f'weight_decay: 0.0005\nlr_policy: "fixed"\n'
                        f'max_iter: 8\nsnapshot: 4\nsnapshot_prefix: '
                        f'"{os.path.join(tmp, prefix)}"\nrandom_seed: 1\n')
        t0 = time.perf_counter()
        resume = ["--snapshot", os.path.join(tmp, "whole_iter_4.npz")]

        def start(prefix: str, extra: list) -> subprocess.Popen:
            return subprocess.Popen(
                [sys.executable, "-m", "nct_tpu_torch.tools.caffe_tool",
                 "train", "--solver", os.path.join(tmp, f"{prefix}.prototxt"),
                 "--device", "cuda", *extra],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=repo, env=dict(os.environ, PYTHONPATH=repo))

        # the uninterrupted run first; both resumes of its snapshot then
        # run side by side (each process's work is its own)
        for wave in ((("whole", ["--deterministic"]),),
                     (("resumed", ["--deterministic", *resume]),
                      ("default", resume))):
            procs = [start(prefix, extra) for prefix, extra in wave]
            try:
                outs = [p.communicate(timeout=300) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for p, (stdout, stderr) in zip(procs, outs):
                if p.returncode != 0:
                    raise AssertionError(f"phase 13d: caffe_tool train "
                                         f"exited {p.returncode}:\n{stdout}"
                                         f"\n{stderr}")
        whole = np.load(os.path.join(tmp, "whole_iter_8.npz"))
        resumed = np.load(os.path.join(tmp, "resumed_iter_8.npz"))
        keys = sorted(k for k in whole.files
                      if k.startswith(("params/", "state/")))
        same = [k for k in keys if k in resumed.files
                and np.array_equal(whole[k], resumed[k])]
        default = np.load(os.path.join(tmp, "default_iter_8.npz"))
        close = [k for k in keys if k in default.files and np.allclose(
            default[k], whole[k], rtol=RESUME_DEFAULT_RTOL,
            atol=RESUME_DEFAULT_ATOL)]
        worst = max(float(np.max(np.abs(default[k] - whole[k])))
                    for k in keys if k in default.files)
    log(f"[train] caffe_tool train --deterministic, 8 iterations with a "
        f"snapshot at 4, then --snapshot resume: {len(same)} / {len(keys)} "
        f"params and history arrays bitwise the uninterrupted run; resumed "
        f"without --deterministic: {len(close)} / {len(keys)} within rtol "
        f"{RESUME_DEFAULT_RTOL} atol {RESUME_DEFAULT_ATOL}, max |diff| "
        f"{worst:.3g} ({time.perf_counter() - t0:.1f} s, 3 processes, "
        f"the two resumes side by side)")
    if not keys or len(same) != len(keys) or len(close) != len(keys):
        raise AssertionError("phase 13d: the resumed run differs")


def mesh_case_diff(single: dict, rank: dict) -> tuple[bool, float]:
    """(loss and params within MESH_STEP_RTOL / ATOL, params max |diff|)
    of one rank's ``train_cases`` entry against the single process's."""
    import numpy as np

    ok = math.isclose(rank["loss"], single["loss"], rel_tol=MESH_STEP_RTOL)
    worst = 0.0
    for name, entry in single["params"].items():
        for blob, want in entry.items():
            got = rank["params"][name][blob]
            ok &= bool(np.allclose(got, want, rtol=MESH_STEP_RTOL,
                                   atol=MESH_STEP_ATOL))
            worst = max(worst, float(np.max(np.abs(got - want))))
    return ok, worst


def mesh_batch() -> dict:
    import numpy as np

    rng = np.random.default_rng(2)
    return {"data": rng.standard_normal((8, 3, 12, 12)).astype(np.float32),
            "label": rng.integers(0, 4, 8).astype(np.float32)}


def check_train_mesh(torch) -> None:
    """13e: ``train_cases`` over a 2x1 data mesh (2 gloo ranks on the one
    card) against this process: a step without and with Dropout, and
    NetSolver iterations over ImageData in which each rank decodes half
    of every batch."""
    import os

    from nct_tpu_torch.parallel.mesh import launch

    fix = os.path.join(_fixtures_dir(), "imagedata")
    args = (mesh_batch(), os.path.join(fix, "list.txt"), fix + "/")
    single = train_cases(*args, "cuda")
    ranks = launch(train_mesh_rank, 2, *args, 2, None)
    ok = True
    for case, what in (("plain", "one step"),
                       ("dropout", "one step with Dropout"),
                       ("net_solver", f"{MESH_NET_SOLVER_ITERS} NetSolver "
                                      f"iterations over ImageData")):
        diffs = [mesh_case_diff(single[case], r[case]) for r in ranks]
        case_ok = all(d[0] for d in diffs)
        line = (f"[train] 2x1 data mesh (gloo, one card), {what}: loss "
                f"{ranks[0][case]['loss']:.7f} vs {single[case]['loss']:.7f}"
                f", params max |diff| {max(d[1] for d in diffs):.3g}; within "
                f"rtol {MESH_STEP_RTOL} atol {MESH_STEP_ATOL}: {case_ok}")
        if case == "net_solver":
            decoded = [r[case]["decoded"] for r in ranks]
            case_ok &= all(2 * d == single[case]["decoded"] for d in decoded)
            line += (f"; images decoded per rank {decoded} of "
                     f"{single[case]['decoded']}")
        log(line)
        ok &= case_ok
    if not ok:
        raise AssertionError("phase 13e: the data-mesh run differs")


def check_training(torch, smi: str) -> dict:
    """Phase 13: JPEG decoding and the Caffe training path on the card.
    13d's processes run beside 13b's CLI process: each is mostly process
    start-up, and neither reads what the other writes."""
    from concurrent.futures import ThreadPoolExecutor

    out = {"decode_ms": check_jpeg(torch, smi)}
    with ThreadPoolExecutor(max_workers=1) as pool:
        resume = pool.submit(check_train_resume, torch)
        check_jpeg_cli(torch)
        resume.result()
    out["caffenet"] = check_caffenet_training(torch, smi)
    check_train_mesh(torch)
    return out


# phase 14: Caffe's data sources and dataset tools, as Caffe's ImageNet
# recipe runs them: convert_imageset -> a DB of Datums -> compute_image_mean
# -> train_val's Data layer -> caffe train
DATASET_LINES = 3072        # TRAIN_ITERS iterations of 256 without a wrap
DATASET_SHARD = 2048        # two shards: the cursor crosses a boundary
DB_RECORDS = 64             # write_lmdb holds one leaf page
DB_BATCH = 32
DB_BATCHES = 4              # 128 rows over 64 records: the cursor wraps
FEED_BATCHES = 3            # host feed ms per batch, Data and ImageData
WINDOW_BATCH = 128          # R-CNN's fine-tuning batch
WINDOW_ITERS = 5
WINDOW_CLASSES = 21         # PASCAL VOC's 20 classes and background
WINDOW_CARD_CPU_STEPS = 2
DATA_MESH_BATCH = 8
RESUME_ITERS, RESUME_AT = 8, 4


def _image_list(path: str, n: int) -> str:
    """A list of n lines cycling through the 16 fixture JPEGs, label
    i % 1000."""
    with open(path, "w") as f:
        f.write("".join(f"img_{i % 16:02d}.jpg {i % 1000}\n"
                        for i in range(n)))
    return path


def check_dataset(torch, tmp: str, smi: str) -> dict:
    """14a: ``tools.convert_imageset --backend records`` over a 3,072-line
    list of the fixture JPEGs (two shards), then ``tools.compute_image_mean``
    over the same list."""
    import os

    import numpy as np

    from nct_tpu_torch.data.records import RecordFile
    from nct_tpu_torch.tools import compute_image_mean, convert_imageset

    fix = os.path.join(_fixtures_dir(), "imagedata") + "/"
    lst = _image_list(os.path.join(tmp, "train.txt"), DATASET_LINES)
    size = ["256", "256"]
    t0 = time.perf_counter()
    rc = convert_imageset.main([
        lst, os.path.join(tmp, "shards"), "--root-folder", fix,
        "--resize-height", size[0], "--resize-width", size[1], "--shuffle",
        "--shard-size", str(DATASET_SHARD), "--backend", "records"])
    convert_s = time.perf_counter() - t0
    source = os.path.join(tmp, "shards", "source.txt")
    with open(source) as f:
        shards = f.read().split()
    counts = [len(RecordFile(p)) for p in shards]
    nbytes = sum(os.path.getsize(p) for p in shards)
    log(f"[data] convert_imageset --backend records: {DATASET_LINES} JPEGs "
        f"(256x256) -> {len(shards)} shards of {counts} Datums, {nbytes} "
        f"bytes, in {convert_s:.2f} s = {DATASET_LINES / convert_s:.1f} "
        f"images/s (one host thread)  [{smi}]")
    if rc != 0 or counts != [DATASET_SHARD, DATASET_LINES - DATASET_SHARD]:
        raise AssertionError(f"phase 14a: convert_imageset gave {counts}")
    mean = os.path.join(tmp, "mean.npz")
    t0 = time.perf_counter()
    rc = compute_image_mean.main([lst, mean, "--root-folder", fix,
                                  "--new-height", size[0],
                                  "--new-width", size[1]])
    mean_s = time.perf_counter() - t0
    m = np.load(mean)["mean"]
    log(f"[data] compute_image_mean over the same list: {m.shape} in "
        f"{mean_s:.2f} s = {DATASET_LINES / mean_s:.1f} images/s")
    if rc != 0 or m.shape != (256, 256, 3) or not np.isfinite(m).all():
        raise AssertionError("phase 14a: compute_image_mean failed")
    return {"list": lst, "root": fix, "source": source, "shards": shards,
            "mean": mean, "convert_s": convert_s, "mean_s": mean_s,
            "bytes": nbytes}


def _caffenet_data_solver(torch, source: str, mean: str, batch: int,
                          iters: int, device):
    """A NetSolver of CaffeNet's train_val with its own ``Data`` layer over
    ``source`` and the published solver (max_iter cut to ``iters``), a
    log line every iteration."""
    from nct_tpu_torch.train.solver_proto import (NetSolver,
                                                  parse_solver_prototxt)

    proto = parse_solver_prototxt(CAFFENET_SOLVER.format(
        max_iter=iters).replace("display: 20", "display: 1"))
    proto.net = caffenet_train_val(source, batch=batch, data="Data",
                                   mean_file=mean, **CAFFENET_TRAIN_WIDTHS)
    return NetSolver(proto, device=device)


def check_data_training(torch, ds: dict, tmp: str, feed_13c: dict | None,
                        smi: str) -> dict:
    """14b: CaffeNet train_val from its own Data layer over 14a's shards
    and mean: 12 NetSolver iterations (logged), warm ms per iteration
    with the feed and device only, the host ms per batch of the Data and
    ImageData sources, and the card against the CPU."""
    import math as _math
    import os

    import numpy as np

    from nct_tpu_torch.data import make_data_source
    from nct_tpu_torch.data.records import decode_datum
    from nct_tpu_torch.tools import parse_log
    from nct_tpu_torch.utils import glog

    t0 = time.perf_counter()
    ns = _caffenet_data_solver(torch, ds["source"], ds["mean"], TRAIN_BATCH,
                               TRAIN_ITERS, "cuda")
    log(f"[data] CaffeNet train_val from its Data layer, batch {TRAIN_BATCH}"
        f" {ns.input_shapes['data']}: set up in "
        f"{time.perf_counter() - t0:.1f} s")
    events = []

    def tick(solver):       # after each step, whose loss the host has read
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    log_path = os.path.join(tmp, "train.log")
    with open(log_path, "w") as f:
        glog.set_stream(f)
        try:
            ns.solver.solve(ns.batches(), on_iter=tick)
        finally:
            glog.set_stream(None)
    torch.cuda.synchronize()
    feed_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    rows, _ = parse_log.parse_log(log_path)
    losses = [r["loss"] for r in rows]
    log(f"[data] {TRAIN_ITERS} NetSolver iterations: losses "
        f"{[round(v, 4) for v in losses]}; the cursor at "
        f"{ns.data_source.pos} of {ns.data_source.total} records")
    if len(losses) != TRAIN_ITERS or not all(_math.isfinite(v)
                                             for v in losses):
        raise AssertionError(f"phase 14b: losses {losses}")
    fixed = {k: torch.as_tensor(v).cuda() for k, v in ns.next_batch().items()}
    dev_ms = []
    for _ in range(TRAIN_ITERS):
        batch = dict(fixed, __generator__=ns.step_generator(ns.solver.iter))
        ms, loss = _event_ms(torch, lambda: ns.solver.step(batch))
        dev_ms.append(ms)
        if not _math.isfinite(loss):
            raise AssertionError("phase 14b: non-finite loss on a resident "
                                 "batch")
    out = {}
    for label, runs in (("device only (resident batch)", dev_ms[2:]),
                        ("with the Data host feed", feed_ms[2:])):
        med = statistics.median(runs)
        out[label] = med
        log(f"[data] warm ms per iteration, {label}: median {med:.3f} of "
            f"{len(runs)} ({min(runs):.3f}-{max(runs):.3f}), "
            f"{TRAIN_BATCH / med * 1e3:.1f} images/s  [{smi}]")
    if feed_13c:
        log(f"[data] 13c, the same net with the ImageData feed: "
            f"{feed_13c['with the ImageData host feed']:.3f} ms per "
            f"iteration, device only "
            f"{feed_13c['device only (resident batch)']:.3f} ms")
    del ns, fixed
    torch.cuda.empty_cache()

    # the host feed alone: one batch of 256 from each source, same crop,
    # mirror and seed (the Data layer subtracts the mean file, ImageData
    # the mean values)
    transform = {"crop_size": 227, "mirror": True}
    data = make_data_source({"type": "Data", "data_param": {
        "source": ds["source"], "batch_size": TRAIN_BATCH},
        "transform_param": dict(transform, mean_file=ds["mean"])})
    image = make_data_source({"type": "ImageData", "image_data_param": {
        "source": ds["list"], "root_folder": ds["root"],
        "batch_size": TRAIN_BATCH, "shuffle": True},
        "transform_param": dict(transform,
                                mean_value=list(IMAGENET_MEAN_BGR))})
    for label, src in (("Data (record shards)", data),
                       ("ImageData (JPEG decode)", image)):
        runs = []
        for _ in range(FEED_BATCHES):
            t0 = time.perf_counter()
            src.next_batch()
            runs.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(runs)
        out[f"host {label}"] = med
        log(f"[data] host feed, {label}: median {med:.3f} ms per batch of "
            f"{TRAIN_BATCH} ({[round(v, 1) for v in runs]}), "
            f"{TRAIN_BATCH / med * 1e3:.1f} images/s (one host thread)")
    # the Data feed's batch split into its steps, on the next 256 records
    rows = range(data.pos, data.pos + TRAIN_BATCH)
    t = [time.perf_counter()]
    payloads = [data._read(i % data.total) for i in rows]
    t.append(time.perf_counter())
    images = [decode_datum(p)[0] for p in payloads]
    t.append(time.perf_counter())
    crops = [data.transform(img) for img in images]
    t.append(time.perf_counter())
    np.stack(crops)
    t.append(time.perf_counter())
    split = [round((b - a) * 1e3, 1) for a, b in zip(t, t[1:])]
    log(f"[data] one Data batch split, ms: read {split[0]}, decode_datum "
        f"{split[1]}, transform (float, crop, mean file, mirror, CHW) "
        f"{split[2]}, stack {split[3]}")

    card = _caffenet_data_solver(torch, ds["source"], ds["mean"],
                                 TRAIN_CARD_CPU_BATCH, 10, "cuda")
    cpu = _caffenet_data_solver(torch, ds["source"], ds["mean"],
                                TRAIN_CARD_CPU_BATCH, 10, "cpu")
    rel = _card_cpu_steps(torch, card, cpu, TRAIN_CARD_CPU_STEPS)
    if rel > TRAIN_CARD_CPU_RTOL:
        raise AssertionError("phase 14b: card and CPU losses disagree")
    out["log"] = log_path
    return out


def _card_cpu_steps(torch, card, cpu, steps: int) -> float:
    """Max relative difference of the losses of ``steps`` steps of two
    NetSolvers, Dropout masks from CPU generators."""
    pairs = []
    for i in range(steps):
        got = card.solver.step(dict(card.next_batch(), __generator__=(
            torch.Generator().manual_seed(100 + i))))
        want = cpu.solver.step(dict(cpu.next_batch(), __generator__=(
            torch.Generator().manual_seed(100 + i))))
        pairs.append((got, want))
    rel = max(abs(g - w) / abs(w) for g, w in pairs)
    log(f"[data] card vs CPU, batch {card.data_source.batch_size}, {steps} "
        f"steps (TF32 off): losses "
        f"{[(round(g, 6), round(w, 6)) for g, w in pairs]}, max rel "
        f"{rel:.3g} (<= {TRAIN_CARD_CPU_RTOL})")
    return rel


def check_db_sources(torch, ds: dict, tmp: str) -> None:
    """14c: the first 64 records exported with ``tools.convert_db``
    (records2lmdb, records2leveldb) and with ``write_leveldb(...,
    as_table=True)``: a Data layer over each gives the shards' batches
    bitwise, at batch 32 for 4 batches."""
    import os

    import numpy as np

    from nct_tpu_torch.data import make_data_source
    from nct_tpu_torch.data.leveldb_reader import write_leveldb
    from nct_tpu_torch.data.records import RecordFile, RecordWriter
    from nct_tpu_torch.tools import convert_db

    first = RecordFile(ds["shards"][0])
    shard = os.path.join(tmp, "first64.ncr")
    with RecordWriter(shard) as w:
        for i in range(DB_RECORDS):
            w.write(first.read(i))
    envs = {"LMDB (records2lmdb)": os.path.join(tmp, "lmdb"),
            "LevelDB log (records2leveldb)": os.path.join(tmp, "leveldb"),
            "LevelDB table (write_leveldb as_table)":
                os.path.join(tmp, "leveldb_table")}
    t0 = time.perf_counter()
    rcs = [convert_db.main(["records2lmdb", shard,
                            envs["LMDB (records2lmdb)"]]),
           convert_db.main(["records2leveldb", shard,
                            envs["LevelDB log (records2leveldb)"]])]
    write_leveldb(envs["LevelDB table (write_leveldb as_table)"],
                  [(f"{i:08d}".encode(), first.read(i))
                   for i in range(DB_RECORDS)], as_table=True)
    log(f"[data] {DB_RECORDS} records exported to LMDB, LevelDB (log) and "
        f"LevelDB (table) in {time.perf_counter() - t0:.2f} s")

    def cfg(source):
        return {"type": "Data", "data_param": {"source": source,
                                               "batch_size": DB_BATCH},
                "transform_param": {"crop_size": 227, "mirror": True,
                                    "mean_file": ds["mean"]}}

    ref = make_data_source(cfg(shard))
    want = [ref.next_batch() for _ in range(DB_BATCHES)]
    bad = [rc for rc in rcs if rc != 0]
    for label, env in envs.items():
        t0 = time.perf_counter()
        src = make_data_source(cfg(env))
        got = [src.next_batch() for _ in range(DB_BATCHES)]
        same = all(np.array_equal(a, b) for g, w in zip(got, want)
                   for a, b in zip(g, w))
        size = sum(os.path.getsize(os.path.join(env, f))
                   for f in os.listdir(env))
        log(f"[data] Data layer over {label} ({size} bytes): {DB_BATCHES} "
            f"batches of {DB_BATCH} in {time.perf_counter() - t0:.2f} s, "
            f"bitwise the shard's: {same}")
        if not same:
            bad.append(label)
    if bad:
        raise AssertionError(f"phase 14c: {bad}")


def _window_file(path: str, seed: int = 14) -> str:
    """Three foreground and five background windows on each fixture JPEG
    (foreground labels 1-20)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lines = []
    for i in range(16):
        lines += [f"# {i}", f"img_{i:02d}.jpg", "3", "256", "256", "8"]
        for j in range(8):
            w, h = (int(v) for v in rng.integers(40, 200, 2))
            x1, y1 = int(rng.integers(0, 256 - w)), int(rng.integers(0, 256 - h))
            fg = j < 3
            overlap = 0.5 + 0.5 * rng.random() if fg else 0.5 * rng.random()
            label = 1 + (i + j) % (WINDOW_CLASSES - 1) if fg else 0
            lines.append(f"{label} {overlap:.4f} {x1} {y1} {x1 + w - 1} "
                         f"{y1 + h - 1}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _window_solver(torch, window_file: str, root: str, batch: int,
                   device):
    from nct_tpu_torch.train.solver_proto import (NetSolver,
                                                  parse_solver_prototxt)

    proto = parse_solver_prototxt(CAFFENET_SOLVER.format(max_iter=100))
    widths = dict(CAFFENET_TRAIN_WIDTHS, classes=WINDOW_CLASSES)
    proto.net = caffenet_train_val(window_file, root, batch=batch,
                                   data="WindowData", **widths)
    return NetSolver(proto, device=device)


def check_window_training(torch, ds: dict, tmp: str, smi: str) -> None:
    """14d: CaffeNet's body with a 21-class fc8 fed by WindowData over the
    fixture JPEGs (context_pad 16, crop 227), 5 iterations at batch 128 on
    the card, then the card against the CPU over 2 steps at batch 8."""
    import math as _math
    import os

    wf = _window_file(os.path.join(tmp, "windows.txt"))
    ns = _window_solver(torch, wf, ds["root"], WINDOW_BATCH, "cuda")
    stream = ns.batches()
    losses, runs = [], []
    for _ in range(WINDOW_ITERS):
        t0 = time.perf_counter()
        losses.append(ns.solver.step(next(stream)))
        runs.append((time.perf_counter() - t0) * 1e3)
    log(f"[data] WindowData CaffeNet ({WINDOW_CLASSES} classes), batch "
        f"{WINDOW_BATCH} {ns.input_shapes['data']}: {WINDOW_ITERS} "
        f"iterations, losses {[round(v, 4) for v in losses]}, ms per "
        f"iteration with the feed {[round(v, 1) for v in runs]}, "
        f"{ns.data_source.decoded} windows warped  [{smi}]")
    if not all(_math.isfinite(v) for v in losses):
        raise AssertionError(f"phase 14d: losses {losses}")
    del ns, stream
    torch.cuda.empty_cache()
    card = _window_solver(torch, wf, ds["root"], TRAIN_CARD_CPU_BATCH, "cuda")
    cpu = _window_solver(torch, wf, ds["root"], TRAIN_CARD_CPU_BATCH, "cpu")
    if _card_cpu_steps(torch, card, cpu, WINDOW_CARD_CPU_STEPS) \
            > TRAIN_CARD_CPU_RTOL:
        raise AssertionError("phase 14d: card and CPU losses disagree")


def data_net_solver(records: str, iters: int, device, mesh=None,
                    snapshot_prefix: str | None = None):
    """A NetSolver of ``small_train_net`` with Dropout over a Data layer on
    ``records`` (random 12 x 12 crops and mirror, batch 8), a snapshot
    every RESUME_AT iterations where ``snapshot_prefix`` is given."""
    from nct_tpu_torch.nn import parse_prototxt
    from nct_tpu_torch.train.solver_proto import (NetSolver,
                                                  parse_solver_prototxt)

    snap = (f'snapshot: {RESUME_AT}\nsnapshot_prefix: "{snapshot_prefix}"\n'
            if snapshot_prefix else "")
    proto = parse_solver_prototxt(
        f'base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
        f'lr_policy: "fixed"\nmax_iter: {iters}\nrandom_seed: 4\n' + snap)
    proto.net = parse_prototxt(small_train_net(DATA_MESH_BATCH,
                                               records=records))
    return NetSolver(proto, mesh=mesh, device=None if mesh else device)


def data_mesh_rank(records: str, n_data: int, device) -> dict:
    """One rank of MESH_NET_SOLVER_ITERS ``data_net_solver`` iterations
    over an n_data x 1 data mesh (run by ``parallel.mesh.launch``)."""
    from nct_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=n_data, device=device)
    ns = data_net_solver(records, MESH_NET_SOLVER_ITERS, mesh.device, mesh)
    return dict(_solver_result(ns.solver, ns.solve()),
                decoded=ns.data_source.decoded)


def check_data_mesh_and_resume(torch, ds: dict, tmp: str) -> None:
    """14e: MESH_NET_SOLVER_ITERS iterations over the Data source with
    Dropout on a 2x1 data mesh (2 gloo ranks on the card) against this
    process, each rank copying half of every batch; then a snapshot at
    iteration 4 of 8 and a resume from it, bitwise the uninterrupted run
    and reading none of its used batches again."""
    import os

    import numpy as np

    from nct_tpu_torch.parallel.mesh import launch

    records = ds["source"]
    ns = data_net_solver(records, MESH_NET_SOLVER_ITERS, "cuda")
    single = dict(_solver_result(ns.solver, ns.solve()),
                  decoded=ns.data_source.decoded)
    ranks = launch(data_mesh_rank, MESH_RANKS, records, MESH_RANKS, None)
    diffs = [mesh_case_diff(single, r) for r in ranks]
    decoded = [r["decoded"] for r in ranks]
    ok = all(d[0] for d in diffs) and all(
        MESH_RANKS * d == single["decoded"] for d in decoded)
    log(f"[data] 2x1 data mesh (gloo, one card), {MESH_NET_SOLVER_ITERS} "
        f"NetSolver iterations over the Data source with Dropout: loss "
        f"{ranks[0]['loss']:.7f} vs {single['loss']:.7f}, params max |diff| "
        f"{max(d[1] for d in diffs):.3g}; within rtol {MESH_STEP_RTOL} atol "
        f"{MESH_STEP_ATOL}; records copied per rank {decoded} of "
        f"{single['decoded']}: {ok}")
    if not ok:
        raise AssertionError("phase 14e: the data-mesh run differs")

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        whole = data_net_solver(records, RESUME_ITERS, "cuda",
                                snapshot_prefix=os.path.join(tmp, "whole"))
        whole.solve()
        resumed = data_net_solver(records, RESUME_ITERS, "cuda",
                                  snapshot_prefix=os.path.join(tmp, "resumed"))
        resumed.restore(os.path.join(tmp, f"whole_iter_{RESUME_AT}.npz"))
        before = resumed.data_source.decoded
        resumed.solve()
    finally:
        torch.backends.cudnn.deterministic = prev
    read = resumed.data_source.decoded - before
    want = _solver_result(whole.solver, 0.0)["params"]
    got = _solver_result(resumed.solver, 0.0)["params"]
    same = [f"{k}/{b}" for k, e in want.items() for b in e
            if np.array_equal(got[k][b], e[b])]
    n_blobs = sum(len(e) for e in want.values())
    state_same = all(np.array_equal(v, whole.data_source.state()[k])
                     for k, v in resumed.data_source.state().items())
    log(f"[data] snapshot at iteration {RESUME_AT} of {RESUME_ITERS} "
        f"(cudnn.deterministic), resumed in process: {len(same)} / "
        f"{n_blobs} params bitwise the uninterrupted run; the resume read "
        f"{read} records (= {RESUME_ITERS - RESUME_AT} batches of "
        f"{DATA_MESH_BATCH}) and ends at the same stream position: "
        f"{state_same}")
    if (len(same) != n_blobs or not state_same
            or read != (RESUME_ITERS - RESUME_AT) * DATA_MESH_BATCH):
        raise AssertionError("phase 14e: the resumed run differs")


def check_data_tools(torch, ds: dict, tmp: str, log_path: str) -> None:
    """14f: ``tools.parse_log`` over 14b's log, ``tools.upgrade_proto`` and
    ``tools.draw_net`` on 14b's train_val."""
    import csv
    import importlib.util
    import os

    from nct_tpu_torch.nn import emit_prototxt
    from nct_tpu_torch.tools import draw_net, parse_log, upgrade_proto

    out = os.path.join(tmp, "logs")
    os.makedirs(out)
    rc = parse_log.main([log_path, out])
    with open(os.path.join(out, "train.log.train")) as f:
        rows = list(csv.DictReader(f))
    log(f"[data] parse_log over 14b's log: {len(rows)} train rows, columns "
        f"{list(rows[0]) if rows else []}")
    if rc != 0 or len(rows) != TRAIN_ITERS:
        raise AssertionError("phase 14f: parse_log")
    text = emit_prototxt(caffenet_train_val(
        ds["source"], batch=TRAIN_BATCH, data="Data", mean_file=ds["mean"],
        **CAFFENET_TRAIN_WIDTHS))
    net = os.path.join(tmp, "train_val.prototxt")
    with open(net, "w") as f:
        f.write(text)
    upgraded = os.path.join(tmp, "upgraded.prototxt")
    rcs = [upgrade_proto.main(["net", net, upgraded])]
    for fmt in ("dot", "text"):
        rcs.append(draw_net.main([net, os.path.join(tmp, f"net.{fmt}"),
                                  "--format", fmt, "--phase", "TRAIN"]))
    with open(upgraded) as f:
        same = f.read() == text
    with open(os.path.join(tmp, "net.dot")) as f:
        boxes = f.read().count("shape=box")
    n_layers = text.count("\nlayer {")
    log(f"[data] upgrade_proto on the train_val: unchanged {same}; draw_net:"
        f" {boxes} layer nodes of {n_layers} layers, and the text table")
    if any(rcs) or not same or boxes != n_layers:
        raise AssertionError("phase 14f: upgrade_proto / draw_net")
    if importlib.util.find_spec("h5py") is None:
        log("[data] HDF5Data and convert_imageset --backend hdf5 not run: "
            "this machine has no h5py (tests/test_torch_window_hdf5.py and "
            "tests/test_torch_data_tools.py run them on the CPU)")
    else:
        log("[data] HDF5Data and convert_imageset --backend hdf5 are run by "
            "tests/test_torch_window_hdf5.py and "
            "tests/test_torch_data_tools.py on the CPU, not here")


def check_data_path(torch, smi: str, feed_13c: dict | None = None) -> dict:
    """Phase 14: the Caffe data sources and dataset tools on the card
    (``feed_13c``: phase 13c's ms per iteration, printed beside 14b's)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        t0 = time.perf_counter()
        ds = check_dataset(torch, tmp, smi)
        out = check_data_training(torch, ds, tmp, feed_13c, smi)
        check_db_sources(torch, ds, tmp)
        check_window_training(torch, ds, tmp, smi)
        check_data_mesh_and_resume(torch, ds, tmp)
        check_data_tools(torch, ds, tmp, out["log"])
        log(f"[data] phase 14 in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# phase 15: the benchmark tools (nct_tpu_torch/tools) at the real widths
BENCH_PROCESS_REPS = 1
BENCH_SIZES = (700, 1000)
BENCH_SIZE_REPS = 1
BENCH_BATCH = 4
BENCH_BATCH_REPS = 1
BENCH_SERVING_N = 2
BENCH_FRAMES = 2
ROOFLINE_REPS = 1


def level_shapes(hw_c, hw_s) -> list[tuple[int, ...]]:
    """(Ha, Wa, Hb, Wb, C) of the exact-NN levels for a content of ``hw_c``
    and a style of ``hw_s``, as the pipeline's VGG-19 taps give them."""
    from nct_tpu_torch import Config
    from nct_tpu_torch.models import vgg19

    cfg = Config()
    dims_a, dims_b = vgg19.feature_dims(*hw_c), vgg19.feature_dims(*hw_s)
    chans = vgg19.tap_channels()
    return [(*dims_a[tap], *dims_b[tap], chans[tap])
            for tap in cfg.vgg_layers()[:cfg.exact_nn_levels]]


def check_bench_nn_shapes(torch, rec: dict) -> None:
    """Phase 15's kernel check: ``nn_bidir`` against its plain version at
    the L0-L3 shapes of the 700 and 1000 px pairs (phase 3 holds it at the
    452 px pair's), random features to AGREE_MIN / DIST_TOL and integer
    ones bitwise; adds the shapes and errors to the record."""
    from nct_tpu_torch.ops import cuda_nn
    from nct_tpu_torch.ops.exact_nn import nn_bidir_tables_plain
    from nct_tpu_torch.tools import bench

    if level_shapes(CONTENT_HW, STYLE_HW) != list(NN_SHAPES):
        raise AssertionError("phase 15: level_shapes disagrees with "
                             "NN_SHAPES at the 452 px pair")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in full f32
    gen = torch.Generator().manual_seed(15)
    checked = {}
    for size in BENCH_SIZES:
        cnt, stl = bench.load_pair(size)
        shapes = level_shapes(cnt.shape[:2], stl.shape[:2])
        for lvl, shape in enumerate(shapes):
            na, nb = shape[0] * shape[1], shape[2] * shape[3]
            for integer in (False, True):
                tab = _tables(torch, gen, shape, integer)
                got = cuda_nn.nn_bidir_tables(*tab[:4])
                ref = nn_bidir_tables_plain(tab[0], tab[4], tab[2], tab[5])
                same, agree, slack, err = _bidir_vs_plain(torch, tab, got,
                                                          ref, na, nb)
                case = "integer" if integer else "random"
                log(f"[nn_bidir] {size} px L{lvl} {case} Na={na} Nb={nb} "
                    f"C={shape[4]}: bitwise equal={same}, agree "
                    f"{agree:.5f}, match slack {slack:.2e}, max |d err| "
                    f"{err:.2e}")
                if (not same if integer
                        else agree < AGREE_MIN or slack > DIST_TOL):
                    raise AssertionError(f"phase 15: nn_bidir disagrees with "
                                         f"plain at {size} px L{lvl} ({case})")
                if not integer:
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    checked[f"{size}px_L{lvl}"] = {
                        "shape": list(shape), "agree": agree,
                        "match_slack": slack, "max_abs_err": err}
    rec["bench_shapes_vs_plain"] = checked


def _tool_result(label: str, result: dict) -> dict:
    log(f"[{label}] " + json.dumps(result))
    return result


def check_bench_tools(torch, bidir: dict) -> None:
    """Phase 15: ``nn_bidir`` at the 700 and 1000 px shapes, then each
    benchmark tool of the port on the seeded pair at full VGG-19 width;
    adds to ``bidir`` the bench's launches per pair and per run (counted
    from 0) by geometry and every launch of 15b-15f."""
    import os

    from nct_tpu_torch import Config
    from nct_tpu_torch.ops import cuda_nn
    from nct_tpu_torch.tools import (bench, bench_batch, bench_sequence,
                                     bench_serving, roofline)

    t0 = time.perf_counter()
    check_bench_nn_shapes(torch, bidir)
    log(f"[bench] nn_bidir vs plain at the 700 and 1000 px shapes in "
        f"{time.perf_counter() - t0:.1f} s")
    levels = Config().exact_nn_levels
    repo = os.path.dirname(os.path.abspath(__file__))
    counts = {}

    def correct(label: str, res: dict, pairs: int, launches: int) -> None:
        """The tool's own checks held, ``levels`` launches in each pair and
        ``pairs`` pairs' worth in the run, counted from 0 here."""
        key = "{}x{}".format(*res["geometry"]["content"])
        counts[key] = {"per_pair": res["nn_bidir_launches_per_pair"],
                       "run": launches}
        if not (res["correct"] and res["nn_bidir_launches_per_pair"] == levels
                and res["nn_bidir_launches"] == launches == pairs * levels
                and res["device"]["name"] == torch.cuda.get_device_name(0)):
            raise AssertionError(f"phase 15 {label}: {launches} launches "
                                 f"counted, {res}")

    # (a) the bench in a new process, as a user runs it: its counts start
    # at 0 with the process; one cold pair and the warm reps (its scan
    # mode runs the scan batch of phase 8b, and is left out for time)
    proc = subprocess.run(
        [sys.executable, "-m", "nct_tpu_torch.tools.bench", "--reps",
         str(BENCH_PROCESS_REPS), "--no-scan"], capture_output=True,
        text=True, cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"phase 15a: the bench exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    res = _tool_result("bench 15a", json.loads(
        proc.stdout.strip().splitlines()[-1]))
    correct("15a", res, 1 + BENCH_PROCESS_REPS, res["nn_bidir_launches"])
    # (b) the upscaled and capped geometries, in this process
    for size in BENCH_SIZES:
        reset_counts()
        res = bench.run(size=size, reps=BENCH_SIZE_REPS, scan=False)
        launches = cuda_nn.LAUNCHES["nn_bidir"]
        _tool_result(f"bench 15b {size}", res)
        correct(f"15b {size}", res, 1 + BENCH_SIZE_REPS, launches)
    log(f"[bench] nn_bidir launches counted from 0: {json.dumps(counts)}")
    # (c)-(f)
    reset_counts()
    # the vmap mode (phase 8b times the scan batch)
    _tool_result("bench_batch 15c", bench_batch.run(
        batch=BENCH_BATCH, mode="vmap", reps=BENCH_BATCH_REPS))
    _tool_result("bench_serving 15d", bench_serving.run(
        n=BENCH_SERVING_N, mesh=True))
    for pm in (False, True):
        _tool_result("bench_sequence 15e", bench_sequence.run(
            n=BENCH_FRAMES, pm=pm))
    rc = roofline.main(["--reps", str(ROOFLINE_REPS)])
    launches = cuda_nn.LAUNCHES["nn_bidir"]
    log(f"[bench] nn_bidir launches in 15c-15f: {launches}; phase 15 in "
        f"{time.perf_counter() - t0:.1f} s")
    if rc != 0 or launches == 0:
        raise AssertionError("phase 15: the roofline, or no nn_bidir launch")
    bidir["bench_launches"] = counts
    bidir["bench_tools_launches"] = launches


# phase 16: the 1000 px pair (the JAX package's MAX_SIZE geometry) under a
# space mesh on row bands, 2 gloo ranks on the card (a 1x4 run of it too
# until the time limit took it out: 18b and 17's pm_jacobi keep 1x4)
SHARD_SIZE = 1000
SHARD_RANKS = (2,)
SHARD_PEAK_RATIO_MAX = 0.65


class StagePeaks:
    """Peak device bytes by pipeline stage in this process: each stage
    function of ``pipeline`` (both the band and the single-process ones)
    and the functions they call, wrapped while ``installed``; a stage's
    peak is ``max_memory_allocated`` over its call, and an outer stage's
    includes its inner stages' peaks (``reset_peak_memory_stats`` at each
    entry, the outer's running peak carried past it)."""

    def __init__(self, torch):
        from nct_tpu_torch import pipeline
        from nct_tpu_torch.models import vgg19

        self.torch = torch
        self.targets = (
            ("setup", pipeline, "_band_setup"), ("setup", pipeline, "_setup"),
            ("match", pipeline, "_band_level_match"),
            ("match", pipeline, "_level_match"),
            ("solve", pipeline, "_band_level_solve"),
            ("solve", pipeline, "_level_solve"),
            ("vgg", vgg19.VGG19, "forward"),
            ("nn", pipeline, "ring_band_nn"),
            ("patchmatch", pipeline, "patchmatch"),
            ("nn", pipeline.cuda_nn, "exact_nn_bidir"),
            ("window_refine", pipeline, "window_refine"),
            ("bds", pipeline.bds, "bds_vote_band"),
            ("bds", pipeline.bds, "bds_vote"),
            ("knn_graph", pipeline.knn, "knn_graph"),
            ("solve_nonlocal", pipeline, "solve_nonlocal"),
            ("solve_wls", pipeline, "solve_wls"))
        self.peaks, self.stack = {}, []

    def run(self, name: str, fn, *args, **kwargs):
        cuda = self.torch.cuda
        if self.stack:
            self.stack[-1] = max(self.stack[-1], cuda.max_memory_allocated())
        cuda.reset_peak_memory_stats()
        self.stack.append(0)
        try:
            return fn(*args, **kwargs)
        finally:
            peak = max(cuda.max_memory_allocated(), self.stack.pop())
            self.peaks[name] = max(self.peaks.get(name, 0), peak)
            if self.stack:
                self.stack[-1] = max(self.stack[-1], peak)

    def install(self) -> list:
        saved = []
        for name, owner, attr in self.targets:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))

            def wrapped(*a, _fn=fn, _name=name, **k):
                return self.run(_name, _fn, *a, **k)
            setattr(owner, attr, wrapped)
        return saved

    @staticmethod
    def uninstall(saved: list) -> None:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)

    def gib(self) -> dict:
        return {k: round(v / 2 ** 30, 3) for k, v in self.peaks.items()}


def _shard_pair(torch, peaks, model, cnt, stl, config) -> dict:
    """One synchronised, counted and staged ``transfer_pair``."""
    from nct_tpu_torch import pipeline
    from nct_tpu_torch.ops import conv3x3, cuda_nn
    from nct_tpu_torch.parallel import mesh as mesh_mod

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()
    for k in mesh_mod.COMM:
        mesh_mod.COMM[k] = 0
    peaks.peaks = {}
    saved = peaks.install()
    t0 = time.perf_counter()
    try:
        out, trace = peaks.run("total", pipeline.transfer_pair, model, cnt,
                               stl, 2.0, config, seed=7,
                               return_intermediates="stats")
        torch.cuda.synchronize()
    finally:
        StagePeaks.uninstall(saved)
    return {"s": time.perf_counter() - t0, "out": out.cpu(),
            "launches": {**cuda_nn.LAUNCHES, **conv3x3.LAUNCHES},
            "iters": _iters(trace),
            "comm": dict(mesh_mod.COMM), "peak_gib": peaks.gib()}


# phases 16-18 share their worlds: one of 2 ranks and one of 4, each rank
# building its mesh and the seeded VGG-19 once (a spawn costs ~12 s)
BAND_WORLDS = ((2, ("16", "17", "18a", "18c")), (4, ("17", "18b")))


def band_rank(n_space: int, parts) -> dict:
    """Phases 16-18 in one rank of an ``n_space``-rank gloo world on the
    one card: each of ``parts`` ("16", "17", "18a", "18b", "18c") in
    turn over one 1 x ``n_space`` mesh and one seeded VGG-19; returns each
    phase's results under its number ("16", "17", "18")."""
    import torch

    from nct_tpu_torch.models import vgg19
    from nct_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(n_data=1, n_space=n_space)
    model = vgg19.init_params(torch.Generator().manual_seed(19)).cuda()
    out = {}
    if "16" in parts:
        out["16"] = shard_rank(torch, mesh, model)
        torch.cuda.empty_cache()
    if "17" in parts:
        out["17"] = shard_pm_rank(torch, mesh, model)
        torch.cuda.empty_cache()
    multi = [p for p in parts if p.startswith("18")]
    if multi:
        out["18"] = shard_multi_rank(torch, mesh, model, multi)
    return out


def band_worlds(torch, plan=BAND_WORLDS) -> dict:
    """``band_rank`` in each world of ``plan`` ((ranks, parts), ...);
    returns each world's rank results by its rank count."""
    from nct_tpu_torch.parallel.mesh import launch

    worlds = {}
    for n, parts in plan:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        worlds[n] = launch(band_rank, n, n, tuple(parts))
        log(f"[bands] 1x{n} world ({', '.join(parts)}) done in "
            f"{time.perf_counter() - t0:.1f} s with the spawn")
    return worlds


def shard_rank(torch, mesh, model) -> dict:
    """Phase 16 in one rank of a band world: one cold row-sharded pair
    and, on rank 0 of the 2-rank world, the single-process pair after
    it."""
    import dataclasses

    import torch.distributed as dist

    from nct_tpu_torch import Config
    from nct_tpu_torch.tools import bench

    cnt, stl = bench.load_pair(SHARD_SIZE)
    f32 = Config(vgg_compute_dtype="float32")
    peaks = StagePeaks(torch)
    out = {"rank": mesh.index("space"),
           "geometry": (cnt.shape[:2], stl.shape[:2])}
    dist.barrier()
    out["run"] = _shard_pair(torch, peaks, model, cnt, stl,
                             dataclasses.replace(f32, space_mesh=mesh))
    dist.barrier()
    if mesh.shape["space"] == SHARD_RANKS[0] and mesh.index("space") == 0:
        out["single"] = _shard_pair(torch, peaks, model, cnt, stl, f32)
    return out


def check_shard(torch, smi: str, worlds: dict | None = None) -> None:
    """Phase 16: the 1000 px pair on row bands over 1x2 (one cold run,
    against a single-process run of the same call); ``worlds`` holds
    ``band_worlds``' results (the phase's own world is spawned when it is
    None)."""
    from nct_tpu_torch import Config

    worlds = worlds or band_worlds(torch, [(n, ("16",))
                                           for n in SHARD_RANKS])
    bad = []
    exact = Config().exact_nn_levels
    for n in SHARD_RANKS:
        ranks = [r["16"] for r in worlds[n]]
        want = {"nn_bidir": 0, "nn_directed": 2 * n * exact,
                "conv3x3": CONVS_PER_PAIR}
        (hc, wc), (hs, ws) = ranks[0]["geometry"]
        label = f"[shard] 1x{n} {hc}x{wc} / {hs}x{ws}"
        single = ranks[0].get("single")
        if single:
            log(f"{label} single process ({smi}): {single['s']:.3f} s, "
                f"launches {single['launches']}, (nl, wls) iterations "
                f"{single['iters']}, peak GiB by stage {single['peak_gib']}")
        for r in ranks:
            run = r["run"]
            c = run["comm"]
            log(f"{label} rank {r['rank']} (cold; {smi}): {run['s']:.3f} s, "
                f"launches {run['launches']}, (nl, wls) iterations "
                f"{run['iters']}, host ms "
                + ", ".join(f"{k} {c[k + '_s'] * 1e3:.1f} ({c[k + '_calls']}"
                            f" calls)" for k in ("halo", "reduce", "gather",
                                                 "exchange"))
                + f"; peak GiB by stage {run['peak_gib']}")
            if run["launches"] != want:
                bad.append(f"1x{n} rank {r['rank']} launches")
            if not torch.equal(run["out"], ranks[0]["run"]["out"]):
                bad.append(f"1x{n} rank {r['rank']} differs from rank 0")
            if single:
                held, n_diff, max_diff = bitwise(torch, run["out"],
                                                 single["out"])
                ratio = run["peak_gib"]["total"] / single["peak_gib"]["total"]
                log(f"{label} rank {r['rank']} bitwise the single process "
                    f"{held} ({n_diff} values differ, max |diff| "
                    f"{max_diff}); peak {ratio:.3f}x the single process's "
                    f"(at most {SHARD_PEAK_RATIO_MAX}; {smi})")
                if not held:
                    bad.append(f"1x{n} rank {r['rank']} against the single "
                               f"process")
                if ratio > SHARD_PEAK_RATIO_MAX:
                    bad.append(f"1x{n} rank {r['rank']} peak {ratio:.3f}x")
    if bad:
        raise AssertionError(f"phase 16 failed: {bad}")


# phase 17: the configurations that PatchMatch, block-Jacobi and Jacobi
# WLS bring onto row bands, on the bench's native pair over 1x2 (each beside
# the single process) and over 1x4; first (17a, 1x2) the band VGG taps at
# four geometries and the card test's pair
PM_SHARD_CONFIGS = ("parity", "pm_jacobi")
# (ranks, configurations): both over 1x2, pm_jacobi alone over 1x4 (a
# parity pair takes ~80 s a rank at 1x4: the time limit keeps it out)
PM_SHARD_WORLDS = ((2, PM_SHARD_CONFIGS), (4, ("pm_jacobi",)))
CARD_PAIR_HW = ((120, 160), (128, 176))
BAND_TAP_HW = ((120, 160), (128, 176), (452, 680), (600, 960))


def pm_shard_config(name: str):
    """``Config.reference_parity`` ("parity": PatchMatch at every level,
    block-Jacobi nonlocal, mg WLS) or ``Config(fine_strategy="patchmatch",
    wls_precond="jacobi")`` ("pm_jacobi": the ring at L0-L3, PatchMatch at
    L4, Jacobi WLS), float32 VGG as the space mesh runs it."""
    from nct_tpu_torch import Config

    if name == "parity":
        return Config.reference_parity(vgg_compute_dtype="float32")
    return Config(fine_strategy="patchmatch", wls_precond="jacobi",
                  vgg_compute_dtype="float32")


def _band_tap_diffs(torch, mesh, model, hw) -> dict:
    """Values of each float32 VGG tap over ``mesh``'s row bands that
    differ from the whole image's, for a seeded image of ``hw``."""
    from nct_tpu_torch.models import vgg19
    from nct_tpu_torch.parallel.mesh import RowBand, image_bands

    gen = torch.Generator().manual_seed(hw[0] * 7 + hw[1])
    img = torch.randint(0, 256, hw + (3,), dtype=torch.uint8,
                        generator=gen).cuda()
    bounds = image_bands(hw[0], mesh.shape["space"])
    full = RowBand.of_image(mesh, "space", bounds, 0, hw[0])
    whole = model(img, vgg19.PIPELINE_TAPS, torch.float32)
    band = model(full.take(img), vgg19.PIPELINE_TAPS, torch.float32,
                 band=full)
    dims = vgg19.feature_dims(*hw)
    return {t: int((RowBand.of_image(mesh, "space", bounds, int(t[4]) - 1,
                                     dims[t][0]).gather(band[t])
                    != whole[t]).sum()) for t in vgg19.PIPELINE_TAPS}


def shard_pm_rank(torch, mesh, model) -> dict:
    """Phase 17 in one rank of a band world: in the first world of
    ``PM_SHARD_WORLDS`` (17a) the band taps and the card test's pair,
    then one cold row-sharded pair of each of the world's configurations
    and, on rank 0 of the first world, its single-process pair."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from nct_tpu_torch import Config, pipeline
    from nct_tpu_torch.tools import bench

    n_space = mesh.shape["space"]
    names = dict(PM_SHARD_WORLDS)[n_space]
    first = n_space == PM_SHARD_WORLDS[0][0]
    lead = mesh.index("space") == 0
    out = {"rank": mesh.index("space")}
    if first:
        out["band_taps"] = {"{}x{}".format(*hw): _band_tap_diffs(
            torch, mesh, model, hw) for hw in BAND_TAP_HW}
        # tests/test_torch_cuda.py's pair: white noise from numpy's seed 5
        rng = np.random.default_rng(5)
        cnt, stl = (rng.integers(0, 256, hw + (3,)).astype(np.uint8)
                    for hw in CARD_PAIR_HW)
        f32 = Config(vgg_compute_dtype="float32")
        dist.barrier()
        out["card_pair"] = pipeline.transfer_pair(
            model, cnt, stl, 2.0, dataclasses.replace(f32, space_mesh=mesh)
        ).cpu()
        if lead:
            out["card_pair_single"] = pipeline.transfer_pair(
                model, cnt, stl, 2.0, f32).cpu()
        torch.cuda.empty_cache()
    cnt, stl = bench.load_pair()
    out["geometry"] = (cnt.shape[:2], stl.shape[:2])
    peaks = StagePeaks(torch)
    for name in names:
        config = pm_shard_config(name)
        dist.barrier()
        out[name] = _shard_pair(torch, peaks, model, cnt, stl,
                                dataclasses.replace(config, space_mesh=mesh))
        dist.barrier()
        if first and lead:
            out[f"{name}_single"] = _shard_pair(torch, peaks, model, cnt, stl,
                                                config)
        torch.cuda.empty_cache()
    return out


def check_shard_pm(torch, smi: str, worlds: dict | None = None) -> None:
    """Phase 17: ``shard_pm_rank`` over 1x2 (17a, then both configurations
    beside the single process) and over 1x4 (pm_jacobi, one cold run, for
    its per-rank peaks); every rank of both worlds is held bitwise to the
    1x2 world's single-process pair and its iterations.  ``worlds`` as
    ``check_shard``'s."""
    from nct_tpu_torch import Config

    worlds = worlds or band_worlds(torch, [(n, ("17",))
                                           for n, _ in PM_SHARD_WORLDS])
    bad = []
    singles = {}      # the 1x2 world's single-process pairs
    exact = Config().exact_nn_levels
    for n, names in PM_SHARD_WORLDS:
        first = n == PM_SHARD_WORLDS[0][0]
        ranks = [r["17"] for r in worlds[n]]
        if first:
            for r in ranks:
                log(f"[shard-pm] 17a rank {r['rank']} band VGG taps (float32, "
                    f"conv3x3) values differing from the whole image's: "
                    f"{r['band_taps']}")
                if any(v for taps in r["band_taps"].values()
                       for v in taps.values()):
                    bad.append(f"17a rank {r['rank']} band taps")
                held, n_diff, max_diff = bitwise(
                    torch, r["card_pair"], ranks[0]["card_pair_single"])
                log(f"[shard-pm] 17a rank {r['rank']} "
                    f"{CARD_PAIR_HW[0][0]}x{CARD_PAIR_HW[0][1]} / "
                    f"{CARD_PAIR_HW[1][0]}x{CARD_PAIR_HW[1][1]} pair on 1x{n} "
                    f"row bands bitwise the single process {held} ({n_diff} "
                    f"values differ, max |diff| {max_diff})")
                if not held:
                    bad.append(f"17a rank {r['rank']} card pair")
        (hc, wc), (hs, ws) = ranks[0]["geometry"]
        for name in names:
            label = f"[shard-pm] 1x{n} {name} {hc}x{wc} / {hs}x{ws}"
            ring = 0 if name == "parity" else 2 * n * exact
            want = {"nn_bidir": 0, "nn_directed": ring,
                    "conv3x3": CONVS_PER_PAIR}
            if first:
                single = singles[name] = ranks[0][f"{name}_single"]
                log(f"{label} single process ({smi}): {single['s']:.3f} s, "
                    f"launches {single['launches']}, (nl, wls) iterations "
                    f"{single['iters']}, peak GiB by stage "
                    f"{single['peak_gib']}")
            single = singles[name]
            for r in ranks:
                run = r[name]
                c = run["comm"]
                log(f"{label} rank {r['rank']} (cold; {smi}): {run['s']:.3f} "
                    f"s, launches {run['launches']}, (nl, wls) iterations "
                    f"{run['iters']}, host ms "
                    + ", ".join(f"{k} {c[k + '_s'] * 1e3:.1f} "
                                f"({c[k + '_calls']} calls)"
                                for k in ("halo", "reduce", "gather",
                                          "exchange"))
                    + f"; peak GiB by stage {run['peak_gib']}")
                if run["launches"] != want:
                    bad.append(f"1x{n} {name} rank {r['rank']} launches")
                if not torch.equal(run["out"], ranks[0][name]["out"]):
                    bad.append(f"1x{n} {name} rank {r['rank']} differs from "
                               f"rank 0")
                held, n_diff, max_diff = bitwise(torch, run["out"],
                                                 single["out"])
                ratio = run["peak_gib"]["total"] / single["peak_gib"]["total"]
                log(f"{label} rank {r['rank']} bitwise the single process "
                    f"{held} ({n_diff} values differ, max |diff| {max_diff});"
                    f" iterations equal {run['iters'] == single['iters']}; "
                    f"peak {ratio:.3f}x the single process's (at most "
                    f"{SHARD_PEAK_RATIO_MAX} at 1x2; {smi})")
                if not held or run["iters"] != single["iters"]:
                    bad.append(f"1x{n} {name} rank {r['rank']} against the "
                               f"single process")
                if first and ratio > SHARD_PEAK_RATIO_MAX:
                    bad.append(f"1x{n} {name} rank {r['rank']} peak "
                               f"{ratio:.3f}x")
    if bad:
        raise AssertionError(f"phase 17 failed: {bad}")


# phase 18: the P > 1 merge on the bench's pair over 1x2 (a), a pair of 3
# units (16 rows each) over 1x4, whose rank 3 holds empty bands (b), and
# the variants configuration (the scatter transpose) in (a)'s world (c)
MULTI_SHARD_MEMBERSHIPS = 3
SHARD_MULTI_PARTS = ("18a", "18b", "18c")
SHORT_PAIR_HW = ((40, 64), (48, 64))
SHORT_PAIR_RANKS = 4
# convolutions of a pair: a content band's (13 to conv5_1, 18 in the
# re-extractions) and a style band's (13)
CONTENT_CONVS, STYLE_CONVS = 31, 13


def band_launches(hw_c, hw_s, n: int, exact: int) -> list[dict]:
    """Each rank's kernel launches for a pair over 1 x ``n`` row bands of
    the default family: per exact level and direction one ring step with
    a launch for each visiting block that holds rows, where the rank's own
    A band holds rows; the VGG convolutions of the bands that hold rows."""
    from nct_tpu_torch.parallel.mesh import image_bands

    held = [[b1 > b0 for b0, b1 in zip(bounds, bounds[1:])]
            for bounds in (image_bands(hw_c[0], n), image_bands(hw_s[0], n))]
    return [{"nn_bidir": 0,
             "nn_directed": exact * (held[0][r] * sum(held[1])
                                     + held[1][r] * sum(held[0])),
             "conv3x3": CONTENT_CONVS * held[0][r] + STYLE_CONVS * held[1][r]}
            for r in range(n)]


def shard_multi_config(part: str):
    """The Config of a part of phase 18 (float32 VGG, as a space mesh runs
    it)."""
    from nct_tpu_torch import Config

    if part == "18a":
        return Config(knn_memberships=MULTI_SHARD_MEMBERSHIPS,
                      vgg_compute_dtype="float32")
    if part == "18c":
        return Config(knn_memberships=MULTI_SHARD_MEMBERSHIPS,
                      nl_transpose="scatter", wls_precond="jacobi",
                      vgg_compute_dtype="float32")
    return Config(vgg_compute_dtype="float32")


def shard_multi_rank(torch, mesh, model, parts) -> dict:
    """Phase 18 in one rank of a band world: over 2 ranks one cold
    row-sharded run of the bench's pair for each of ``parts`` 18a
    (``Config(knn_memberships=3)``) and 18c (the variants configuration),
    over 4 (18b) one of the short pair under the default Config; each
    beside, on rank 0, its single-process pair (float32 VGG
    throughout)."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from nct_tpu_torch.tools import bench

    if mesh.shape["space"] == 2:
        cnt, stl = bench.load_pair()
    else:
        # white noise from numpy's seed 18
        rng = np.random.default_rng(18)
        cnt, stl = (rng.integers(0, 256, hw + (3,)).astype(np.uint8)
                    for hw in SHORT_PAIR_HW)
    peaks = StagePeaks(torch)
    out = {"rank": mesh.index("space"),
           "geometry": (cnt.shape[:2], stl.shape[:2]), "parts": {}}
    for part in parts:
        config = shard_multi_config(part)
        got = out["parts"][part] = {}
        dist.barrier()
        got["run"] = _shard_pair(torch, peaks, model, cnt, stl,
                                 dataclasses.replace(config, space_mesh=mesh))
        dist.barrier()
        if mesh.index("space") == 0:
            got["single"] = _shard_pair(torch, peaks, model, cnt, stl, config)
    return out


def check_shard_multi(torch, smi: str, parts=SHARD_MULTI_PARTS,
                      worlds: dict | None = None) -> None:
    """Phase 18: ``shard_multi_rank`` over 1x2 (18a and 18c) and 1x4
    (18b), each part of ``parts``; every rank equal to rank 0, bitwise its
    single-process pair with its iterations and with its own bands'
    launches; at 1x2 each rank's peak at most 0.65x the single process's.
    ``worlds`` as ``check_shard``'s."""
    from nct_tpu_torch import Config

    bad = []
    exact = Config().exact_nn_levels
    plan = [(n, world_parts) for n, world_parts in (
        (2, [p for p in ("18a", "18c") if p in parts]),
        (SHORT_PAIR_RANKS, [p for p in ("18b",) if p in parts]))
        if world_parts]
    worlds = worlds or band_worlds(torch, plan)
    what = {"18a": f"P = {MULTI_SHARD_MEMBERSHIPS}",
            "18b": "default, 3 units",
            "18c": f"variants (P = {MULTI_SHARD_MEMBERSHIPS}, scatter, "
                   f"Jacobi WLS)"}
    for n, world_parts in plan:
        ranks = [r["18"] for r in worlds[n]]
        (hc, wc), (hs, ws) = ranks[0]["geometry"]
        want = band_launches((hc, wc), (hs, ws), n, exact)
        for part in world_parts:
            label = (f"[shard-multi] {part} 1x{n} {what[part]} {hc}x{wc} / "
                     f"{hs}x{ws}")
            bad += _check_shard_part(torch, smi, label, part, n, ranks,
                                     want)
    if bad:
        raise AssertionError(f"phase 18 failed: {bad}")


def _check_shard_part(torch, smi: str, label: str, part: str, n: int,
                      ranks: list, want: list) -> list:
    """One part of phase 18 against its single-process pair; returns what
    failed."""
    bad = []
    single = ranks[0]["parts"][part]["single"]
    log(f"{label} single process ({smi}): {single['s']:.3f} s, "
        f"launches {single['launches']}, (nl, wls) iterations "
        f"{single['iters']}, peak GiB by stage {single['peak_gib']}")
    first = ranks[0]["parts"][part]["run"]
    for r in ranks:
        run = r["parts"][part]["run"]
        c = run["comm"]
        log(f"{label} rank {r['rank']} (cold; {smi}): {run['s']:.3f} s, "
            f"launches {run['launches']} (want {want[r['rank']]}), "
            f"(nl, wls) iterations {run['iters']}, host ms "
            + ", ".join(f"{k} {c[k + '_s'] * 1e3:.1f} ({c[k + '_calls']}"
                        f" calls)" for k in ("halo", "reduce", "gather",
                                             "exchange"))
            + f"; peak GiB by stage {run['peak_gib']}")
        if run["launches"] != want[r["rank"]]:
            bad.append(f"{part} rank {r['rank']} launches")
        if not torch.equal(run["out"], first["out"]):
            bad.append(f"{part} rank {r['rank']} differs from rank 0")
        held, n_diff, max_diff = bitwise(torch, run["out"], single["out"])
        ratio = run["peak_gib"]["total"] / single["peak_gib"]["total"]
        log(f"{label} rank {r['rank']} bitwise the single process "
            f"{held} ({n_diff} values differ, max |diff| {max_diff}); "
            f"iterations equal {run['iters'] == single['iters']}; peak "
            f"{ratio:.3f}x the single process's"
            + (f" (at most {SHARD_PEAK_RATIO_MAX}; {smi})" if n == 2
               else f" ({smi})"))
        if not held or run["iters"] != single["iters"]:
            bad.append(f"{part} rank {r['rank']} against the single "
                       f"process")
        if n == 2 and ratio > SHARD_PEAK_RATIO_MAX:
            bad.append(f"{part} rank {r['rank']} peak {ratio:.3f}x")
    return bad


def main() -> int:
    import torch

    import nct_tpu_torch  # noqa: F401  (fails here when run outside the repo)

    kind, smi = device_info(torch)
    t0 = time.perf_counter()

    def phase_done(name: str) -> None:
        log(f"[time] {name} done at {time.perf_counter() - t0:.1f} s")

    build_kernels()
    phase_done("phase 2 (build)")
    bidir, directed = check_kernels(torch)
    conv = check_conv3x3(torch)
    phase_done("phase 3 (kernels)")
    slice_info = check_slice(torch)
    bidir["launches"] = slice_info["launches"]
    phase_done("phase 4 (slice)")
    check_patchmatch(torch)
    phase_done("phase 5 (PatchMatch)")
    directed["launches"] = check_profiler(torch)
    phase_done("phase 6 (profiler)")
    check_variants(torch)
    phase_done("phase 7 (solver variants)")
    scan = check_serving(torch, slice_info)
    phase_done("phase 8 (serving)")
    check_batched_kernels(torch, bidir, directed)
    bucket = check_vmap_bucket(torch, scan)
    bidir["vmap_bucket_launches"] = bucket["launches"]
    bidir["vmap_bucket_items"] = bucket["items"]
    check_batch_profiler(torch)
    phase_done("phase 9 (vmap batch)")
    buckets = check_vmap_configs(torch, scan)
    bidir["vmap_config_buckets"] = {
        label: {"launches": b["launches"], "items": b["items"]}
        for label, b in buckets.items()}
    phase_done("phase 10 (vmap of every single-card Config)")
    check_mesh(torch, scan, directed, conv)
    phase_done("phase 11 (mesh: ring, space and data meshes)")
    check_caffe(torch, smi)
    phase_done("phase 12 (Caffe framework: VGG-19, CaffeNet, tools, layers)")
    training = check_training(torch, smi)
    phase_done("phase 13 (JPEG, CaffeNet training, resume, data mesh)")
    check_data_path(torch, smi, training["caffenet"])
    phase_done("phase 14 (data sources and dataset tools)")
    check_bench_tools(torch, bidir)
    phase_done("phase 15 (benchmark tools)")
    worlds = band_worlds(torch)
    phase_done("phases 16-18 worlds (1x2, then 1x4)")
    check_shard(torch, smi, worlds)
    phase_done("phase 16 (1000 px pair on row bands, 1x2 mesh)")
    check_shard_pm(torch, smi, worlds)
    phase_done("phase 17 (PatchMatch, block-Jacobi and Jacobi WLS on row "
               "bands)")
    check_shard_multi(torch, smi, worlds=worlds)
    phase_done("phase 18 (P > 1 merge, a short pair and the scatter "
               "transpose on row bands)")
    log(f"[time] whole run {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": [bidir, directed, conv]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
