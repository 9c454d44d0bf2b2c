"""The port's diagnosis tools (``nct_tpu_torch.tools``: profile_cg,
wls_convergence, knn_recall, capture_nl, retune_caps, compare_strategies,
diagnose_pair, quality_table, sweep_nl_quality) and the V-cycle's
strength keywords.

Five seeded smooth pairs (numpy, 48x64 content / 52x60 style) are written
as PNG into a temporary demo directory.  The JAX tools are loaded from
``tools/`` by path, their ``EXAMPLE`` pointed at that directory, and run
through ``main(argv)`` in this process; their printed tables are parsed.

* JAX parity, on the same PNGs, JAX's VGG-19 weights carried across and
  JAX's key sequence fed through the draws interface:
  - ``knn_recall``: the rows of one membership (the P = 1 graph is
    bitwise JAX's) print equal; the P > 1 rows' id recall lies within
    ``MULTI_RECALL_TOL`` of JAX's and their weight recall within 1e-4
    (the merge ranks float32 distances that XLA and torch round
    differently, so a near-tie may pick another of two equidistant
    neighbours);
  - ``wls_convergence``: equal iteration counts; sqrt(||r||^2) within
    rel 1e-3 of JAX's printed value (the WLS parity bound of
    ``test_torch_solve.py``, which also covers the print's 4 digits);
  - ``retune_caps``'s WLS sweep: equal recommendations, reductions rel
    1e-2 (``test_torch_solve.py``'s curve bound);
  - the V-cycle at non-default ``omega`` / ``coarsest`` /
    ``coarse_sweeps`` / ``max_levels``: within 1e-5 of the output's
    largest magnitude (``test_torch_solve.py``'s operator and
    preconditioner bound).
* Each port parser has the JAX parser's options and defaults, apart from
  the documented deviations (``--staged`` dropped; ``--device`` and
  ``--example`` added), and each tool raises without a card under its
  default ``--device cuda``.
* The tools that drive the pipeline are held to the port's own
  ``transfer_pair`` (whose JAX parity other modules hold): profile_cg's
  rows are the ``"stats"`` trace; capture_nl writes the fixture layout
  and each level replays (``retune.nl_solve_at_cap`` at the level's trip
  count) to the pipeline's coefficients bit for bit; compare_strategies'
  SSIM is ``utils.ssim`` of the two outputs; the golden tools give ratio
  0 when the golden is the pipeline's own output, and sweep_nl_quality's
  V-cycle rebinding reaches the nonlocal solve and is undone.
"""

import dataclasses
import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nct_tpu.config import Config as JaxConfig
from nct_tpu.models import vgg19 as jvgg
from nct_tpu.solve import nonlocal_solve as jnl
from nct_tpu_torch import pipeline
from nct_tpu_torch.config import Config
from nct_tpu_torch.io import imread_bgr, imwrite_bgr
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.solve import nonlocal_solve as tnl
from nct_tpu_torch.solve import retune
from nct_tpu_torch.tools import (capture_nl, compare_strategies, demo,
                                 diagnose_pair, knn_recall, profile_cg,
                                 quality_table, retune_caps,
                                 sweep_nl_quality, wls_convergence)
from nct_tpu_torch.utils.ssim import ssim

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CONTENT_HW, STYLE_HW = (48, 64), (52, 60)
SIZE = 64           # the JAX parity tests
PIPE_SIZE = 32      # the pipeline-driving tools: 24x32 / 26x30
MULTI_RECALL_TOL = 0.01
TOOLS = {m.__name__.rsplit(".", 1)[1]: m for m in (
    profile_cg, wls_convergence, knn_recall, capture_nl, retune_caps,
    compare_strategies, diagnose_pair, quality_table, sweep_nl_quality)}
DROPPED = {"staged"}
ADDED = {"device", "example"}


def _smooth(rng, h, w):
    """A bilinear upsampling of 5x6 uniform noise, plus +-8 of noise."""
    coarse = rng.uniform(0, 255, (5, 6, 3))
    ys, xs = np.linspace(0, 4, h), np.linspace(0, 5, w)
    y0, x0 = np.minimum(ys.astype(int), 3), np.minimum(xs.astype(int), 4)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = (1 - fx) * coarse[y0][:, x0] + fx * coarse[y0][:, x0 + 1]
    bot = (1 - fx) * coarse[y0 + 1][:, x0] + fx * coarse[y0 + 1][:, x0 + 1]
    img = (1 - fy) * top + fy * bot + rng.uniform(-8, 8, (h, w, 3))
    return img.clip(0, 255).round().astype(np.uint8)


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    root = tmp_path_factory.mktemp("example")
    (root / "in").mkdir()
    (root / "res").mkdir()
    rng = np.random.default_rng(21)
    for i in range(5):
        imwrite_bgr(str(root / "in" / f"in{i}.png"), _smooth(rng, *CONTENT_HW))
        imwrite_bgr(str(root / "in" / f"tar{i}.png"), _smooth(rng, *STYLE_HW))
    return str(root)


@pytest.fixture(scope="module")
def jax_model():
    """The port's VGG-19 with the weights of JAX's ``init_params()``."""
    return vgg19.params_from_numpy(
        {k: {"w": np.asarray(v["w"]), "b": np.asarray(v["b"])}
         for k, v in jvgg.init_params().items()})


@pytest.fixture(scope="module")
def model():
    return vgg19.init_params()


def _jax_tool(name, example, monkeypatch):
    monkeypatch.setenv("NCT_COMPILE_CACHE", "none")
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.EXAMPLE = example
    return mod


def _run_jax(name, argv, example, monkeypatch, capsys) -> list[str]:
    """The JAX tool's printed lines."""
    capsys.readouterr()
    assert _jax_tool(name, example, monkeypatch).main(argv) == 0
    return capsys.readouterr().out.splitlines()


def _cells(line: str) -> list[str]:
    return [c.strip() for c in line.strip().strip("|").split("|")]


def _table(lines: list[str]) -> list[list[str]]:
    """The rows of the first markdown table in ``lines``, header and rule
    left out."""
    rows = [_cells(s) for s in lines if s.startswith("|")]
    return [r for r in rows[1:] if not set("".join(r)) <= set("-")]


class JaxKeyDraws:
    """JAX's key sequence through the port's draws interface: one split
    of ``PRNGKey(seed)`` per draw, k-means centres by ``jax.random.choice``
    and candidate scores by ``jax.random.uniform``, as the JAX tools draw
    them."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def _split(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def kmeans_init(self, n, k):
        return torch.tensor(np.asarray(jax.random.choice(
            self._split(), n, shape=(k,), replace=n < k)))

    def candidate_scores(self, level, k, n):
        return torch.tensor(np.asarray(jax.random.uniform(
            self._split(), (k, n), dtype=jnp.float32)))


# --- against the JAX tools ---------------------------------------------


def test_knn_recall_matches_jax(example, jax_model, monkeypatch, capsys):
    argv = ["--pair", "0", "--size", str(SIZE), "--level", "3"]
    want = _run_jax("knn_recall", argv, example, monkeypatch, capsys)
    lines = []
    rows = knn_recall.recall(jax_model, lambda: JaxKeyDraws(7), CPU, example,
                             0, SIZE, 3, out=lines.append)
    # the summary line, up to the exact build's seconds
    assert lines[0].split("; exact")[0] == want[0].split("; exact")[0]
    got_t, want_t = _table(lines), _table(want)
    assert [r[:2] for r in got_t] == [r[:2] for r in want_t]
    assert len(rows) == 6
    for row, g, w in zip(rows, got_t, want_t):
        if row["memberships"] == 1:
            assert g == w
        else:
            assert abs(row["id_recall"] - float(w[2])) <= MULTI_RECALL_TOL
            assert abs(row["weight_recall"] - float(w[3])) <= 1e-4


@pytest.mark.parametrize("level", [3, 4])
def test_wls_convergence_matches_jax(example, level, monkeypatch, capsys):
    argv = ["--pair", "1", "--size", str(SIZE), "--level", str(level),
            "--iters", "400"]
    want = _run_jax("wls_convergence", argv, example, monkeypatch, capsys)
    lines = []
    rows = wls_convergence.convergence(CPU, example, 1, SIZE, level, 400,
                                       out=lines.append)
    assert lines[0].rsplit(" backend=", 1)[0] == want[0].rsplit(
        " backend=", 1)[0]
    want_t = _table(want)
    assert len(rows) == len(want_t) == 6
    for row, w in zip(rows, want_t):
        assert [row["precond"], f"{row['tol']:g}"] == w[:2]
        assert row["iters"] == int(w[2])
        assert np.sqrt(row["r2"]) == pytest.approx(
            float(w[3].split()[0]), rel=1e-3)
    # the port's iterations do not fall as the tolerance tightens
    for pk in ("jacobi", "mg"):
        its = [r["iters"] for r in rows if r["precond"] == pk]
        assert its == sorted(its)


def test_retune_caps_wls_matches_jax(example, monkeypatch, capsys, tmp_path):
    caps = ["4", "16"]
    argv = ["--pair", "2", "--size", str(SIZE), "--caps", *caps,
            "--wls-levels", "3", "4", "--out", str(tmp_path / "jax.json")]
    _run_jax("retune_caps", argv, example, monkeypatch, capsys)
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    got = retune_caps.retune_caps(None, None, CPU, example, pair=2,
                                  size=SIZE, caps=[int(c) for c in caps],
                                  wls_levels=(3, 4), out=lambda s: None)
    assert got["recommended"] == want["recommended"]
    assert got["recommended"]["wls_cg_iters_mg"] is not None
    for level in (3, 4):
        g, w = got["wls"][level], want["wls"][str(level)]
        assert g["recommended"] == w["recommended"]
        conv_g, conv_w = g["curve"]["converged"], w["curve"]["converged"]
        assert conv_g["iters"] == conv_w["iters"]
        assert conv_g["r2_init"] == pytest.approx(conv_w["r2_init"],
                                                  rel=1e-5)
        for cap in caps:
            assert g["curve"]["caps"][int(cap)]["reduction"] == \
                pytest.approx(w["curve"]["caps"][cap]["reduction"],
                              rel=1e-2)


def test_vcycle_knobs_match_jax():
    """Non-default knobs change the V-cycle, and the port's follows
    JAX's; with no keyword the port's is its default cycle."""
    rng = np.random.default_rng(8)
    h, w = 21, 30                  # 3 levels by default, 5 at coarsest 2
    aa = rng.uniform(0.5, 2.0, (h, w, 3)).astype(np.float32)
    bb = rng.uniform(0.5, 2.0, (h, w, 3)).astype(np.float32)
    ab = (0.3 * rng.uniform(-1, 1, (h, w, 3))).astype(np.float32)
    wx = rng.uniform(0.0, 3.0, (h, w)).astype(np.float32)
    wy = rng.uniform(0.0, 3.0, (h, w)).astype(np.float32)
    fa, fb = (rng.standard_normal((h, w, 3)).astype(np.float32)
              for _ in range(2))
    ops = (aa, ab, bb, wx, wy)

    def port(**kw):
        pc = tnl.make_mg_preconditioner(*(torch.from_numpy(x) for x in ops),
                                        **kw)
        return [z.numpy() for z in pc((torch.from_numpy(fa),
                                       torch.from_numpy(fb)))]

    def jax_cycle(**kw):
        # one program builds and applies the cycle (eager, the hierarchy's
        # ops compile one by one)
        def cycle(o, f):
            return jnl.make_mg_preconditioner(*o, **kw)(f)
        return [np.asarray(z) for z in jax.jit(cycle)(
            [jnp.asarray(x) for x in ops], (jnp.asarray(fa), jnp.asarray(fb)))]

    default = port()
    for a, b in zip(default, port(omega=0.8, coarsest=8, coarse_sweeps=8,
                                  max_levels=8)):
        np.testing.assert_array_equal(a, b)
    for kw in (dict(omega=0.5, coarsest=2, coarse_sweeps=3, max_levels=6),
               dict(coarsest=16, coarse_sweeps=5, max_levels=2)):
        got, want = port(**kw), jax_cycle(**kw)
        assert any(not np.array_equal(g, d) for g, d in zip(got, default))
        for g, r in zip(got, want):
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-5 * np.abs(r).max())


def _parser(main, argv):
    """The ArgumentParser that ``main`` builds (stopped at parse_args)."""
    import argparse

    class Stop(Exception):
        pass

    seen = []

    def parse_args(self, args=None, namespace=None):
        seen.append(self)
        raise Stop

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse_args
    try:
        with pytest.raises(Stop):
            main(argv)
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen[0]


def _options(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     a.choices, a.required, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parsers_match_jax_and_need_a_card(example, monkeypatch, capsys):
    for name, tool in TOOLS.items():
        if name == "compare_strategies":
            continue
        want = _options(_parser(_jax_tool(name, example, monkeypatch).main,
                                []))
        got = _options(_parser(tool.main, []))
        for dest in DROPPED:
            want.pop(dest, None)
        assert set(got) - set(want) == ADDED, name
        assert {k: got[k] for k in want} == want, name
        assert got["device"][:2] == (("--device",), "cuda")
    # compare_strategies: JAX's positional [size] [names...] and presets
    jcs = _jax_tool("compare_strategies", example, monkeypatch)
    args = _parser(compare_strategies.main, []).parse_args(
        ["512", "bj", "knn2", "--device", "cpu"])
    assert (args.size, args.names, args.device) == (512, ["bj", "knn2"],
                                                    "cpu")
    defaults = _parser(compare_strategies.main, []).parse_args([])
    assert (defaults.size, defaults.names) == (700, [])
    assert list(compare_strategies.CONFIGS) == list(jcs.CONFIGS)
    fields = [f.name for f in dataclasses.fields(JaxConfig)]
    for name, cfg in compare_strategies.CONFIGS.items():
        assert {f: getattr(cfg, f) for f in fields} == {
            f: getattr(jcs.CONFIGS[name], f) for f in fields}, name
    if torch.cuda.is_available():
        return
    extra = {"capture_nl": ["--out", os.devnull], "compare_strategies": []}
    for name, tool in TOOLS.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["--example", example] + extra.get(name, []))


# --- against the port's own pipeline -----------------------------------


def _transfer(model, cnt, stl, config=Config(), bds=2.0, **kw):
    return pipeline.transfer_pair(model, cnt, stl, bds, config,
                                  device="cpu", **kw)


def test_profile_cg_rows_are_stats_trace(example, model, capsys):
    rows = profile_cg.profile(model, demo.seeded_draws(), CPU, example, PIPE_SIZE,
                              (0, 3), out=lambda s: None)
    want = []
    for i in (0, 3):
        cnt, stl = demo.read_pair(example, i, PIPE_SIZE)
        _, trace = _transfer(model, cnt, stl, return_intermediates="stats")
        want += [{"pair": i, "level": t["level"],
                  "nl_iters": int(t["nl_iters"]), "nl_r2": float(t["nl_r2"]),
                  "wls_iters": int(t["wls_iters"]),
                  "wls_r2": float(t["wls_r2"])} for t in trace]
    assert rows == want
    # the command prints the same rows in the JAX tool's format
    capsys.readouterr()
    assert profile_cg.main(["--device", "cpu", "--example", example,
                            "--size", str(PIPE_SIZE), "--pairs", "3"]) == 0
    printed = _table(capsys.readouterr().out.splitlines())
    assert printed == [[f"in{r['pair']}", f"L{r['level']}",
                        str(r["nl_iters"]), f"{np.sqrt(r['nl_r2']):.3e}",
                        str(r["wls_iters"]), f"{np.sqrt(r['wls_r2']):.3e}"]
                       for r in rows if r["pair"] == 3]


def test_capture_nl_format_and_replay(example, model, tmp_path):
    solve = pipeline.solve_nonlocal
    out_dir = str(tmp_path / "nl")
    calls = capture_nl.capture(model, demo.seeded_draws(), CPU, example,
                               out_dir, 1, PIPE_SIZE, out=lambda s: None)
    assert pipeline.solve_nonlocal is solve
    assert [c["level"] for c in calls] == list(range(5))
    fixture = np.load(os.path.join(REPO, "tests", "fixtures", "nl_L0.npz"))
    for c in calls:
        system = retune.load_nl_system(c["path"])
        assert sorted(system) == sorted(fixture.files)
        for k in fixture.files:
            assert system[k].dtype == fixture[k].dtype, k
            assert system[k].ndim == fixture[k].ndim, k
        h, w = system["src_lab"].shape[:2]
        assert system["nbr_ids"].shape == system["nbr_slots"].shape == (
            h * w, 8)
        a, b, _ = retune.nl_solve_at_cap(system, c["iters"], Config(), "cpu")
        np.testing.assert_array_equal(a, c["a"].numpy())
        np.testing.assert_array_equal(b, c["b"].numpy())


def test_compare_strategies_ssim(example, model):
    lines = []
    got = compare_strategies.compare(model, demo.seeded_draws(), CPU, example,
                                     PIPE_SIZE, ("default", "bj"),
                                     out=lines.append)
    cnt, stl = demo.read_pair(example, 0, PIPE_SIZE)
    outs = {n: _transfer(model, cnt, stl, compare_strategies.CONFIGS[n])
            for n in ("default", "bj")}
    for n, o in outs.items():
        assert torch.equal(got["outputs"][n], o)
    assert got["ssim"]["bj"] == ssim(outs["default"], outs["bj"])
    assert lines[-1] == f"SSIM(default, bj) = {got['ssim']['bj']:.4f}"
    assert re.fullmatch(r"default: \d+\.\d\d s", lines[0])


def test_golden_tools_ratio_zero(example, model, tmp_path, monkeypatch):
    """Each golden is the pipeline's own output at the tool's geometry."""
    gold = tmp_path / "example"
    for d in ("in", "res"):
        (gold / d).mkdir(parents=True)
    for i in (0, 2):
        for kind in ("in", "tar"):
            name = f"in/{kind}{i}.png"
            imwrite_bgr(str(gold / name), imread_bgr(f"{example}/{name}"))
    res = gold / "res"

    cnt, stl = demo.read_pair(example, 2, PIPE_SIZE)
    imwrite_bgr(str(res / "in2_tar2_2.00.png"),
                _transfer(model, cnt, stl).numpy())
    report = diagnose_pair.diagnose(model, demo.seeded_draws(), CPU,
                                    str(gold), 2, PIPE_SIZE,
                                    out=lambda s: None)
    assert report["final_ratio"] == 0.0
    assert report["levels"][-1]["refined_ratio"] == 0.0
    assert len(report["levels"]) == 5
    # (the parity column is left to the card's run: PatchMatch at every
    # level takes the CPU several seconds even here)
    rows = quality_table.table(model, demo.seeded_draws(), CPU, str(gold),
                               PIPE_SIZE, (2,), skip_parity=True,
                               out=lambda s: None)
    assert rows[0]["ratio"] == 0.0 and rows[0]["bds_move"] > 0
    assert np.isnan(rows[0]["ssim_parity"])

    # sweep_nl_quality under cg_iters_mg = 40 at a smaller fixed geometry,
    # and with a V-cycle rebinding that reaches the nonlocal solve
    monkeypatch.setattr(sweep_nl_quality, "HW", (24, 32))
    c0, s0 = (demo.resized(imread_bgr(f"{example}/in/{k}0.png"), 24, 32)
              for k in ("in", "tar"))
    want = _transfer(model, c0, s0,
                     dataclasses.replace(Config(), cg_iters_mg=40)).numpy()
    imwrite_bgr(str(res / "in0_tar0_2.00.png"), want)
    got = sweep_nl_quality.sweep(model, demo.seeded_draws(), CPU, str(gold),
                                 pairs=(0,), out=lambda s: None)
    assert got["closures"] == [0.0]
    orig = tnl.make_mg_preconditioner
    knobs = sweep_nl_quality.sweep(model, demo.seeded_draws(), CPU, str(gold),
                                   coarse_sweeps=1, coarsest=2, pairs=(0,),
                                   out=lambda s: None)
    assert tnl.make_mg_preconditioner is orig
    assert knobs["closures"][0] > 0.0
