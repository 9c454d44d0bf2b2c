"""The port's benchmark tools (``nct_tpu_torch.tools``: bench, bench_batch,
bench_serving, bench_sequence, roofline) against the JAX package's
``bench.py`` and ``tools/`` scripts on the same numpy inputs: the seeded
pair and its 700 / 1000 px fits bitwise, the video frames bitwise, the
roofline rows' counts equal to ``nct_tpu/utils/flops.py``'s at 452x680.
Each tool's ``main`` runs in this process (one thread) with ``--device
cpu --small``: its last line is one JSON object with the tool's keys, and
``bench``'s output is bitwise ``transfer_pair`` on the CPU.  Without a
card every tool raises under its default ``--device cuda``.  The tools'
numbers on the card come from chip_smoke.py."""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nct_tpu.config import Config as JConfig
from nct_tpu.models import vgg19 as jvgg19
from nct_tpu.utils import flops as jflops
from nct_tpu_torch import pipeline
from nct_tpu_torch.config import Config
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.tools import (bench, bench_batch, bench_sequence,
                                 bench_serving, roofline)
from nct_tpu_torch.utils import flops

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke  # noqa: E402  (the kernel shapes of phase 15)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"bench": bench, "bench_batch": bench_batch,
         "bench_serving": bench_serving, "bench_sequence": bench_sequence,
         "roofline": roofline}
SMALL_HW = ((21, 32), (20, 32))
CPU = ["--device", "cpu", "--small"]


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX ``bench.py``, loaded as ``bench.py 1000`` would run it (it
    reads argv at import: a size argument turns its upscale on), with its
    demo directory pointed nowhere so that it takes its synthetic pair."""
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", ["bench.py", "1000"])
    mp.setenv("NCT_COMPILE_CACHE", "none")
    try:
        mod = _load("jax_bench_py", os.path.join(REPO, "bench.py"))
    finally:
        mp.undo()
    mod.DEMO = os.path.join(REPO, "no-such-demo-dir")
    return mod


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_synthetic_pair_is_bench_py_fallback(jax_bench):
    cnt, stl = jax_bench.load_pair()
    got = bench.synthetic_pair()
    assert cnt.shape == (452, 680, 3) and stl.shape == (600, 960, 3)
    assert np.array_equal(got[0], cnt) and np.array_equal(got[1], stl)
    for a, b in zip(bench.load_pair(), (cnt, stl)):
        assert a.dtype == np.uint8 and np.array_equal(a, b)


@pytest.mark.parametrize("size,which,shape", [
    (700, 0, (465, 700, 3)),       # content upscaled
    (700, 1, (437, 700, 3)),       # style capped
    (1000, 0, (665, 1000, 3)),
    (1000, 1, (625, 1000, 3)),
])
def test_fit_to_size_matches_jax(jax_bench, size, which, shape):
    """Exact: the same bilinear resize and the same uint8 conversion."""
    img = bench.synthetic_pair()[which]
    want = jax_bench._fit_to_size(img, size)
    got = bench._fit_to_size(img, size)
    assert got.shape == want.shape == shape
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    assert np.array_equal(bench.load_pair(size)[which], want)


def test_make_frames_matches_jax(monkeypatch):
    monkeypatch.setenv("NCT_COMPILE_CACHE", "none")
    jax_seq = _load("jax_bench_sequence",
                    os.path.join(REPO, "tools", "bench_sequence.py"))
    base = bench.synthetic_pair()[0]
    want = jax_seq.make_frames(base, 8)
    got = bench_sequence.make_frames(base, 8)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    assert not np.array_equal(got[1], got[0])


def _jax_roofline_rows(h, w, sh, sw):
    """(stage, GFLOP, GB) of each row of ``tools/roofline.py`` from the JAX
    package's counts, in its order."""
    cfg = JConfig()
    dims_a, dims_b = jvgg19.feature_dims(h, w), jvgg19.feature_dims(sh, sw)
    chans = jvgg19.tap_channels()
    taps = cfg.vgg_layers()
    rows = [("vgg_5taps(content)", jflops.vgg_forward_flops(h, w),
             h * w * 3 * 4)]
    for l, tap in enumerate(taps):
        (ah, aw), (bh, bw) = dims_a[tap], dims_b[tap]
        na, nb, c = ah * aw, bh * bw, chans[tap]
        exact = l < cfg.exact_nn_levels
        rows.append((f"L{l}_exact_nn_bidir" if exact
                     else f"L{l}_window_refine(x2 dirs)",
                     *jflops.match_counts(na, nb, c, exact, cfg)))
        if l == len(taps) - 1:
            rows.append((f"L{l}_bds_vote", *jflops.bds_counts(na, nb, c)))
            rows.append((f"L{l}_knn_graph", *jflops.knn_counts(na, cfg)))
            rows.append((f"L{l}_nonlocal_mg{cfg.cg_iters_final_mg}",
                         *jflops.nonlocal_counts(na, True, cfg)))
    rows.append((f"wls_mg{cfg.wls_cg_iters_mg}_fullres",
                 *jflops.wls_counts(h, w, cfg)))
    return rows


def test_roofline_counts_match_jax():
    """At the tool's default size (680: content 452x680, style 425x680)
    every row's GFLOP and GB are the JAX counts (rel 1e-12)."""
    cnt, stl = bench.load_pair(680)
    assert cnt.shape[:2] == (452, 680) and stl.shape[:2] == (425, 680)
    rows = roofline.plan(*cnt.shape[:2], *stl.shape[:2], Config())
    want = _jax_roofline_rows(*cnt.shape[:2], *stl.shape[:2])
    assert [r["stage"] for r in rows] == [s for s, _, _ in want]
    for r, (stage, f, b) in zip(rows, want):
        assert r["flops"] == pytest.approx(f, rel=1e-12), stage
        assert r["bytes"] == pytest.approx(b, rel=1e-12), stage
    # the pipeline's whole-pair counts agree as well
    jtot = jflops.pipeline_counts(452, 680, 600, 960, JConfig())["total"]
    tot = flops.pipeline_counts(452, 680, 600, 960, Config())["total"]
    assert tot["flops"] == pytest.approx(jtot["flops"], rel=1e-12)
    assert tot["bytes"] == pytest.approx(jtot["bytes"], rel=1e-12)


@pytest.mark.parametrize("size,l3,subset", [
    (None, (76_840, 144_000), (False, False)),   # 307,360 content px
    (700, (81_550, 76_650), (True, False)),       # 325,500 / 305,900
    (1000, (166_500, 156_500), (True, True)),
])
def test_stage1_subset_directions(size, l3, subset):
    """The window refine's stage-1 subset per direction at L4 (content ->
    style, style -> content) at each benchmark geometry, and the L3 NN
    search's Na x Nb."""
    cfg = Config()
    cnt, stl = bench.load_pair(size)
    (h, w), (sh, sw) = cnt.shape[:2], stl.shape[:2]
    tap3 = cfg.vgg_layers()[3]
    (ah, aw) = vgg19.feature_dims(h, w)[tap3]
    (bh, bw) = vgg19.feature_dims(sh, sw)[tap3]
    assert (ah * aw, bh * bw) == l3
    got = (pipeline.stage1_channels(cfg, h * w, h * w),
           pipeline.stage1_channels(cfg, h * w, sh * sw))
    assert got == tuple(cfg.window_stage1_channels_maxsize if s
                        else cfg.window_stage1_channels for s in subset)


@pytest.mark.parametrize("size", [None, 700, 1000])
def test_kernel_shapes_of_each_geometry_match_jax(size):
    """The L0-L3 shapes at which chip_smoke holds nn_bidir against its
    plain version are the JAX pipeline's exact-NN shapes at each benchmark
    geometry (phase 3's NN_SHAPES at the pair as it is)."""
    cfg = JConfig()
    cnt, stl = bench.load_pair(size)
    dims_a = jvgg19.feature_dims(*cnt.shape[:2])
    dims_b = jvgg19.feature_dims(*stl.shape[:2])
    want = [(*dims_a[t], *dims_b[t], jvgg19.tap_channels()[t])
            for t in cfg.vgg_layers()[:cfg.exact_nn_levels]]
    got = chip_smoke.level_shapes(cnt.shape[:2], stl.shape[:2])
    assert [tuple(x) for x in got] == want and len(want) == 4
    if size is None:
        assert want == list(chip_smoke.NN_SHAPES)


BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "median_s", "reps_s",
    "scan_mps", "analytic_gflops", "analytic_hbm_gb", "mfu", "hbm_frac",
    "p10_s", "p90_s", "n_reps", "cold_s", "peak_mem_gib", "geometry",
    "nn_bidir_launches_per_pair", "nn_bidir_launches", "device", "correct",
    "output_sha256"}


def test_bench_cpu_small(capsys, monkeypatch):
    monkeypatch.setattr(bench, "SCAN_ITEMS", 2)    # 4 on the card
    assert bench.main(CPU + ["--reps", "2"]) == 0
    res = _last_json(capsys.readouterr().out)
    assert set(res) == BENCH_KEYS
    assert res["metric"] == "e2e_megapixels_per_sec"
    assert res["vs_baseline"] is None and res["correct"] is True
    assert res["device"] == {"name": "cpu"}
    assert res["geometry"] == {"content": list(SMALL_HW[0]),
                               "style": list(SMALL_HW[1])}
    assert res["n_reps"] == len(res["reps_s"]) == 2
    assert res["p10_s"] <= res["median_s"] <= res["p90_s"]
    assert res["value"] > 0 and res["scan_mps"] > 0 and res["cold_s"] > 0
    assert res["mfu"] is None and res["hbm_frac"] is None
    assert res["nn_bidir_launches_per_pair"] == res["nn_bidir_launches"] == 0
    assert res["analytic_gflops"] > 0 and res["analytic_hbm_gb"] > 0
    # the benchmarked output is the CPU pipeline's on the same pair and seed
    cnt, stl = bench.load_pair(bench.SMALL_SIZE)
    want = pipeline.transfer_pair(bench.seeded_model(torch.device("cpu")),
                                  cnt, stl, 2.0, Config(), seed=7,
                                  device="cpu")
    assert res["output_sha256"] == hashlib.sha256(
        want.numpy().tobytes()).hexdigest()


def test_bench_batch_cpu_small(capsys):
    assert bench_batch.main(CPU + ["--batch", "2", "--mode", "both",
                                   "--reps", "1"]) == 0
    out = capsys.readouterr().out
    res = _last_json(out)
    assert res["batch"] == 2 and res["geometry"] == "32x21"
    for mode in ("vmap", "scan"):
        assert f"{mode}: batch=2 pair=32x21" in out
        r = res[mode]
        assert set(r) == {"s_total", "s_per_pair", "mps", "reps", "p10_s",
                          "p90_s", "nn_bidir_launches"}
        assert r["s_per_pair"] == pytest.approx(r["s_total"] / 2)
        assert len(r["reps"]) == 1 and r["nn_bidir_launches"] == 0


def test_bench_serving_cpu_small(capsys):
    assert bench_serving.main(CPU + ["--n", "2", "--mesh"]) == 0
    out = capsys.readouterr().out
    res = _last_json(out)
    for line in ("geometry 32x21, n=2", "sync     :", "pipeline :",
                 "pipeline speedup over interactive:", "mesh(d=1):"):
        assert line in out
    for key in ("sync", "pipeline", "mesh"):
        assert set(res[key]) == {"s_total", "s_per_pair", "mps"}
        assert res[key]["s_per_pair"] > 0
    assert res["pipeline_speedup"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("pm", [False, True])
def test_bench_sequence_cpu_small(capsys, pm):
    assert bench_sequence.main(CPU + ["--frames", "3"]
                               + (["--pm"] if pm else [])) == 0
    out = capsys.readouterr().out
    res = _last_json(out)
    assert res["config"] == ("pm" if pm else "default")
    assert "frame times: cold" in out
    assert len(res["frame_s"]) == 3
    assert res["s_per_frame"] == pytest.approx(np.mean(res["frame_s"][1:]))
    assert res["cold_s"] == res["frame_s"][0]
    assert res["nn_bidir_launches"] == 0


def test_roofline_cpu_small(capsys, tmp_path):
    path = tmp_path / "roofline.json"
    assert roofline.main(CPU + ["--reps", "1", "--out", str(path)]) == 0
    out = capsys.readouterr().out
    res = _last_json(out)
    cnt, stl = bench.load_pair(bench.SMALL_SIZE)
    stages = [r["stage"] for r in roofline.plan(*cnt.shape[:2],
                                                *stl.shape[:2], Config())]
    assert [r["stage"] for r in res["rows"]] == stages
    assert "| stage | ms | GF | GB | tensor-core % | HBM % | bound |" in out
    for r in res["rows"]:
        assert r["ms"] > 0 and r["compute_frac"] is None
        assert f"| {r['stage']} |" in out
    with open(path) as f:
        assert json.load(f)["rows"] == res["rows"]


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_raises_without_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TOOLS[name].main(["--small"])


def test_bench_module_exits_nonzero_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "nct_tpu_torch.tools.bench", "--small"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and proc.stdout.strip() == ""
