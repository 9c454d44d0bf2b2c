"""The port's transfer_pair under the solver variants against nct_tpu.

One JAX ``transfer_pair`` under ``Config.reference_parity`` (PatchMatch at
every level, the block-Jacobi nonlocal solve) with two k-NN memberships and
the Jacobi WLS solve, on the tiny noise pair of test_torch_pipeline.py, is
compared level by level with the port fed the same weights and draws (JAX's
key sequence replayed through the ``draws`` hook).  ``cg_tol=0`` and small
budgets pin every CG trip count on both sides.

Levels 0-1 agree exactly; from level 2 on, the CG solves' reduction
order reaches the re-extracted features (test_torch_pipeline.py says
why).  The bounds are the drift that test_torch_pipeline.py states.  Then
each Config value that selects a solver variant runs ``transfer_pair`` on
the port's CPU path alone.
"""

import numpy as np
import jax
import pytest
import torch

from nct_tpu import pipeline as jpipe
from nct_tpu.config import Config as JaxConfig
from nct_tpu.models import vgg19 as jvgg
from nct_tpu_torch import Config
from nct_tpu_torch import pipeline as tpipe
from nct_tpu_torch.models import vgg19 as tvgg
from test_torch_pipeline import NNF_AGREE_MIN, JaxDraws

torch.set_num_threads(1)

OVERRIDES = dict(
    pm_iters=2, pm_iters_fine=2, knn_memberships=2, wls_precond="jacobi",
    cg_iters=10, cg_iters_final=10, wls_cg_iters=10, kmeans_iters=3,
    cg_tol=0.0, feature_dtype="float32",
)
WITHIN2_MIN = 0.95              # as test_torch_pipeline.test_slice_final_output
MEAN_DIFF_MAX = 1.0


@pytest.fixture(scope="module")
def parity_run():
    rng = np.random.default_rng(3)
    cnt = rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (44, 52, 3)).astype(np.uint8)
    params = jvgg.init_params()
    jout, jtrace = jpipe.transfer_pair(
        params, cnt, stl, 2.0, JaxConfig.reference_parity(**OVERRIDES),
        key=jax.random.PRNGKey(0), return_intermediates=True)
    tout, ttrace = tpipe.transfer_pair(
        tvgg.params_from_numpy(params), cnt, stl, 2.0,
        Config.reference_parity(**OVERRIDES), draws=JaxDraws(0),
        device="cpu", return_intermediates=True)
    return cnt, np.asarray(jout), jtrace, tout.numpy(), ttrace


def test_parity_config_level_by_level(parity_run):
    cnt, _, jtrace, _, ttrace = parity_run
    assert len(ttrace) == len(jtrace) == 5
    for lvl, (jt, tt) in enumerate(zip(jtrace, ttrace)):
        # the non-mg budgets, pinned by tol=0, on both sides
        assert tt["nl_iters"] == int(jt["nl_iters"]) == 10
        assert tt["wls_iters"] == int(jt["wls_iters"]) == 10
        for key in ("ann", "bnn"):
            agree = (tt[key].numpy() == np.asarray(jt[key])).all(-1).mean()
            assert agree >= NNF_AGREE_MIN[lvl], (lvl, key, agree)
        for key in ("a", "b", "bds_err"):
            assert bool(torch.isfinite(tt[key]).all())
        assert tt["refined"].shape == cnt.shape


def test_parity_config_level0_solve(parity_run):
    """Level 0 shares fields, guide and graph: the block-Jacobi and Jacobi
    solves' coefficients agree to the CG reduction-order drift."""
    _, _, jtrace, _, ttrace = parity_run
    for lvl in (0, 1):
        for key in ("ann", "bnn"):
            np.testing.assert_array_equal(ttrace[lvl][key].numpy(),
                                          np.asarray(jtrace[lvl][key]))
    np.testing.assert_array_equal(ttrace[0]["guide"].numpy(),
                                  np.asarray(jtrace[0]["guide"]))
    for key in ("a", "b"):
        np.testing.assert_allclose(ttrace[0][key].numpy(),
                                   np.asarray(jtrace[0][key]), rtol=0,
                                   atol=1e-4)


def test_parity_config_final_output(parity_run):
    cnt, jout, _, tout, _ = parity_run
    assert tout.shape == cnt.shape and tout.dtype == np.uint8
    diff = np.abs(tout.astype(int) - jout.astype(int))
    assert (diff <= 2).mean() >= WITHIN2_MIN, (diff <= 2).mean()
    assert diff.mean() <= MEAN_DIFF_MAX, diff.mean()


SMALL = dict(cg_iters_mg=3, cg_iters_final_mg=2, wls_cg_iters_mg=2,
             cg_iters=3, cg_iters_final=2, wls_cg_iters=3, kmeans_iters=2)


@pytest.mark.parametrize("config", [
    Config.reference_parity(),
    Config(knn_memberships=2, **SMALL),
    Config(knn_memberships=3, **SMALL),
    Config(nl_transpose="scatter", **SMALL),
    Config(nl_precond="block_jacobi", **SMALL),
    Config(wls_precond="jacobi", **SMALL),
], ids=["reference_parity", "memberships2", "memberships3", "scatter",
        "block_jacobi", "wls_jacobi"])
def test_variant_configs_run_on_cpu(config):
    rng = np.random.default_rng(1)
    cnt = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (28, 30, 3)).astype(np.uint8)
    out, trace = tpipe.transfer_pair(tvgg.init_params(), cnt, stl, 2.0,
                                     config, seed=5, device="cpu",
                                     return_intermediates="stats")
    assert out.shape == cnt.shape and out.dtype == torch.uint8
    assert float(out.float().std()) > 0
    final = config.num_levels - 1
    for tr in trace:
        if config.nl_precond == "mg":
            cap = (config.cg_iters_final_mg if tr["level"] == final
                   else config.cg_iters_mg)
        else:
            cap = (config.cg_iters_final if tr["level"] == final
                   else config.cg_iters)
        wls_cap = (config.wls_cg_iters_mg if config.wls_precond == "mg"
                   else config.wls_cg_iters)
        assert 0 < tr["nl_iters"] <= cap
        assert 0 < tr["wls_iters"] <= wls_cap
        assert np.isfinite(float(tr["nl_r2"]))
