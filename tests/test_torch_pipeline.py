"""The port's slice (nct_tpu_torch.pipeline.transfer_pair) against nct_tpu.

One JAX ``transfer_pair`` on the tiny noise pair of tests/test_pipeline.py
is compared level by level with the port fed the same weights and the same
random draws (JAX's key sequence replayed through the ``draws`` hook).
``cg_tol=0`` pins every CG trip count on both sides.

What cannot agree bitwise: the CG dot products reduce in another order
than XLA's, and XLA fuses the k-NN distance differently, which reorders
candidates tied on their bf16 keys.  At level 0 the nonlocal operator and
preconditioner agree bitwise, yet those two effects move the coefficients
by ~2e-3; later levels inherit that drift through the re-extracted
features, and near-degenerate matches on noise images flip.  The JAX
package itself drifts further between two of its own program
partitionings of this pair (fused vs staged: per-level NNF agreement
1.0, 1.0, 0.92, 0.80, 0.55; final output within 2 LSB at 0.906, mean
|diff| 1.14).  The port measured 1.0, 1.0, 0.97, 0.89, 0.68 and 0.981 /
0.67, so the bounds below sit between the two.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nct_tpu import pipeline as jpipe
from nct_tpu.config import Config as JaxConfig
from nct_tpu.models import vgg19 as jvgg
from nct_tpu.solve import knn as jknn
from nct_tpu_torch import Config
from nct_tpu_torch import cli as tcli
from nct_tpu_torch import io as tio
from nct_tpu_torch import pipeline as tpipe
from nct_tpu_torch.models import vgg19 as tvgg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NNF_AGREE_MIN = (0.99, 0.99, 0.9, 0.8, 0.6)      # per level, ann and bnn


class JaxDraws:
    """Replays the JAX pipeline's key sequence: PRNGKey(seed), the split
    for k-means (pipeline.py:642), then one split per level (:333)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def kmeans_init(self, n, k):
        self.key, sub = jax.random.split(self.key)
        idx = jax.random.choice(sub, n, shape=(k,), replace=n < k)
        return torch.tensor(np.asarray(idx))

    def candidates(self, level, member_pix, m):
        self.key, sub = jax.random.split(self.key)
        c = jknn.sample_cluster_candidates(
            jnp.asarray(member_pix.cpu().numpy()), sub, m)
        return torch.tensor(np.asarray(c))


@pytest.fixture(scope="module")
def slice_runs():
    rng = np.random.default_rng(3)
    cnt = rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (44, 52, 3)).astype(np.uint8)
    params = jvgg.init_params()
    overrides = dict(
        pm_iters=2, cg_iters=10, cg_iters_final=10, wls_cg_iters=10,
        cg_iters_mg=10, kmeans_iters=3, cg_tol=0.0, feature_dtype="float32",
    )
    config = Config(**overrides)
    jout, jtrace = jpipe.transfer_pair(
        params, cnt, stl, 2.0, JaxConfig(**overrides),
        key=jax.random.PRNGKey(0),
        return_intermediates=True)
    tout, ttrace = tpipe.transfer_pair(
        tvgg.params_from_numpy(params), cnt, stl, 2.0, config,
        draws=JaxDraws(0), return_intermediates=True)
    return cnt, config, (np.asarray(jout), jtrace), (tout.numpy(), ttrace)


def test_slice_level_by_level(slice_runs):
    cnt, config, (_, jtrace), (_, ttrace) = slice_runs
    assert len(ttrace) == len(jtrace) == 5
    dims = tvgg.feature_dims(*cnt.shape[:2])
    for lvl, (jt, tt) in enumerate(zip(jtrace, ttrace)):
        assert tt["level"] == lvl
        assert tt["ann"].shape[:2] == dims[config.vgg_layers()[lvl]]
        # pinned trip counts (tol=0) run the same iterations on both sides
        assert tt["nl_iters"] == int(jt["nl_iters"])
        assert tt["wls_iters"] == int(jt["wls_iters"])
        for key in ("ann", "bnn"):
            agree = (tt[key].numpy() == np.asarray(jt[key])).all(-1).mean()
            assert agree >= NNF_AGREE_MIN[lvl], (lvl, key, agree)
        for key in ("a", "b", "bds_err"):
            assert bool(torch.isfinite(tt[key]).all())
        assert tt["refined"].shape == cnt.shape


def test_slice_levels_0_1_match_exactly(slice_runs):
    """Before the drift reaches the search, the exact-NN fields, the BDS
    guidance and the voted-feature error agree exactly or to f32 rounding."""
    _, _, (_, jtrace), (_, ttrace) = slice_runs
    for lvl in (0, 1):
        jt, tt = jtrace[lvl], ttrace[lvl]
        np.testing.assert_array_equal(tt["ann"].numpy(), np.asarray(jt["ann"]))
        np.testing.assert_array_equal(tt["bnn"].numpy(), np.asarray(jt["bnn"]))
    np.testing.assert_array_equal(ttrace[0]["guide"].numpy(),
                                  np.asarray(jtrace[0]["guide"]))
    np.testing.assert_allclose(ttrace[0]["bds_err"].numpy(),
                               np.asarray(jtrace[0]["bds_err"]), atol=1e-5)


def test_slice_final_output(slice_runs):
    cnt, _, (jout, _), (tout, _) = slice_runs
    assert tout.shape == cnt.shape and tout.dtype == np.uint8
    diff = np.abs(tout.astype(int) - jout.astype(int))
    assert (diff <= 2).mean() >= 0.95, (diff <= 2).mean()
    assert diff.mean() <= 1.0, diff.mean()


def test_config_fields_match_jax_config():
    """The port's Config is a copy of nct_tpu.config.Config (so the port
    imports nothing of the JAX package): same fields, same defaults."""
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(Config) == fields(JaxConfig)
    for n in range(1, 7):
        assert Config(num_levels=n).vgg_layers() == \
            JaxConfig(num_levels=n).vgg_layers()


def test_generator_draws_are_seeded():
    rng = np.random.default_rng(1)
    cnt = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (28, 30, 3)).astype(np.uint8)
    model = tvgg.init_params()
    cfg = Config(cg_iters_mg=3, cg_iters_final_mg=2, wls_cg_iters_mg=2,
                 kmeans_iters=2)
    a, state = tpipe.transfer_pair(model, cnt, stl, 2.0, cfg, seed=5,
                                   return_state=True)
    b = tpipe.transfer_pair(model, cnt, stl, 2.0, cfg, seed=5,
                            warm_start=state)
    assert a.shape == cnt.shape and a.dtype == torch.uint8
    assert float(a.float().std()) > 0
    # level 0 runs the exact search, so the warm start cannot change it
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, stats = tpipe.transfer_pair(model, cnt, stl, 2.0, cfg, seed=5,
                                   return_intermediates="stats")
    assert set(stats[0]) == {"level", "nl_iters", "nl_r2", "wls_iters",
                             "wls_r2"}


@pytest.mark.parametrize("overrides", [
    {"fine_strategy": "patchmatch"}, {"exact_nn_levels": 0},
    {"knn_memberships": 2}, {"space_mesh": object()},
    {"nl_precond": "block_jacobi"}, {"nl_transpose": "scatter"},
])
def test_unported_config_values_raise(overrides):
    with pytest.raises(NotImplementedError, match="ROADMAP|ported"):
        tpipe.check_config(Config(**overrides))


def _pairs_dir(tmp_path):
    rng = np.random.default_rng(2)
    d = tmp_path / "in"
    d.mkdir()
    tio.imwrite_bgr(str(d / "c0.png"),
                    rng.integers(0, 256, (40, 56, 3)).astype(np.uint8))
    tio.imwrite_bgr(str(d / "s0.png"),
                    rng.integers(0, 256, (44, 50, 3)).astype(np.uint8))
    (d / "pairs.txt").write_text("c0.png s0.png 1.5\n")
    return d


def test_cli_cpu_run(tmp_path):
    d = _pairs_dir(tmp_path)
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "nct_tpu_torch.cli", "-i", str(d), "-o",
         str(out), "--device", "cpu", "--size", "48"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    img = tio.imread_bgr(str(out / "c0_s0_1.50.png"))
    assert img.shape == (34, 48, 3)            # capped to 48 on the long side


def test_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["-i", str(tmp_path), "-o", str(tmp_path / "o")])


def test_port_never_imports_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "import nct_tpu_torch, nct_tpu_torch.cli, nct_tpu_torch.io\n"
        "from nct_tpu_torch import pipeline\n"
        "from nct_tpu_torch.models import vgg19\n"
        "from nct_tpu_torch import Config\n"
        "rng = np.random.default_rng(0)\n"
        "c = rng.integers(0, 256, (24, 28, 3)).astype(np.uint8)\n"
        "s = rng.integers(0, 256, (26, 30, 3)).astype(np.uint8)\n"
        "cfg = Config(cg_iters_mg=2, cg_iters_final_mg=2, wls_cg_iters_mg=2,"
        " kmeans_iters=2)\n"
        "out = pipeline.transfer_pair(vgg19.init_params(), c, s, 2.0, cfg,"
        " device='cpu')\n"
        "assert tuple(out.shape) == (24, 28, 3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nct_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
