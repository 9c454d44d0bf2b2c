"""The port's transfer_pair under PatchMatch, and transfer_sequence.

One JAX ``transfer_pair`` on the tiny noise pair of test_torch_pipeline.py
under ``exact_nn_levels=0, fine_strategy="patchmatch"`` (PatchMatch at
every level, 2 iterations) is compared level by level with the port fed
the same weights and draws: JAX's key sequence, including the split in
three at each PatchMatch level, replayed through the ``draws`` hook.  The
pair runs twice, from the scaled-identity init and from a given level-0
warm start.

The level 0-1 fields and the level-0 guide agree exactly.  From level 2 on,
the features are re-extracted from images that the CG solves have moved by
~2e-3 (test_torch_pipeline.py says why), and PatchMatch spreads each
flipped near-tie to its neighbours, so agreement falls fast.  The JAX
package drifts as much between two of its own program partitionings of
this pair (fused vs staged, key 0):
per-level NNF agreement (the lower of ann and bnn) 1.0, 1.0, 0.85, 0.62,
0.39; final output within 2 LSB at 0.938, mean |diff| 1.01.  The port
measured 1.0, 1.0, 0.925, 0.704, 0.381 and 0.773 / 1.62.  The final output
is that chaotic on its own: over keys 0-3, fused vs staged JAX spans
0.868-0.955 within 2 LSB and the port vs fused JAX 0.773-0.942.  The bounds
below sit at or under both.
"""

import dataclasses

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
from test_torch_pipeline import JaxDraws

torch.set_num_threads(1)

OVERRIDES = dict(
    pm_iters=2, cg_iters=10, cg_iters_final=10, wls_cg_iters=10,
    cg_iters_mg=10, kmeans_iters=3, cg_tol=0.0, feature_dtype="float32",
    exact_nn_levels=0, fine_strategy="patchmatch",
)
NNF_AGREE_MIN = (0.99, 0.99, 0.85, 0.6, 0.35)     # per level, ann and bnn
WITHIN2_MIN = 0.75
MEAN_DIFF_MAX = 2.0


@pytest.fixture(scope="module")
def pm_runs():
    rng = np.random.default_rng(3)
    cnt = rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (44, 52, 3)).astype(np.uint8)
    params = jvgg.init_params()
    model = tvgg.params_from_numpy(params)
    dims = Config().vgg_layers()[0]
    (ah, aw), (bh, bw) = (tvgg.feature_dims(*cnt.shape[:2])[dims],
                          tvgg.feature_dims(*stl.shape[:2])[dims])
    # every pixel starts at the far corner of the other image
    warm = {"ann": np.broadcast_to(np.int32([bw - 1, bh - 1]),
                                   (ah, aw, 2)).copy(),
            "bnn": np.broadcast_to(np.int32([aw - 1, ah - 1]),
                                   (bh, bw, 2)).copy()}
    runs = {}
    for name, ws in (("cold", None), ("warm", warm)):
        jout, jtrace = jpipe.transfer_pair(
            params, cnt, stl, 2.0, JaxConfig(**OVERRIDES),
            key=jax.random.PRNGKey(0), return_intermediates=True,
            warm_start=ws)
        tws = None if ws is None else {
            k: torch.from_numpy(v) for k, v in ws.items()}
        tout, ttrace = tpipe.transfer_pair(
            model, cnt, stl, 2.0, Config(**OVERRIDES), draws=JaxDraws(0),
            device="cpu", return_intermediates=True, warm_start=tws)
        runs[name] = (np.asarray(jout), jtrace, tout.numpy(), ttrace)
    return cnt, runs


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_pm_slice_level_by_level(pm_runs, start):
    cnt, runs = pm_runs
    _, jtrace, _, ttrace = runs[start]
    assert len(ttrace) == len(jtrace) == 5
    for lvl, (jt, tt) in enumerate(zip(jtrace, ttrace)):
        assert tt["nl_iters"] == int(jt["nl_iters"])
        assert tt["wls_iters"] == int(jt["wls_iters"])
        for key in ("ann", "bnn"):
            agree = (tt[key].numpy() == np.asarray(jt[key])).all(-1).mean()
            assert agree >= NNF_AGREE_MIN[lvl], (lvl, key, agree)
        for key in ("a", "b", "bds_err"):
            assert bool(torch.isfinite(tt[key]).all())
        assert tt["refined"].shape == cnt.shape


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_pm_slice_levels_0_1_match_exactly(pm_runs, start):
    _, runs = pm_runs
    _, jtrace, _, ttrace = runs[start]
    for lvl in (0, 1):
        for key in ("ann", "bnn"):
            np.testing.assert_array_equal(ttrace[lvl][key].numpy(),
                                          np.asarray(jtrace[lvl][key]))
    np.testing.assert_array_equal(ttrace[0]["guide"].numpy(),
                                  np.asarray(jtrace[0]["guide"]))


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_pm_slice_final_output(pm_runs, start):
    cnt, runs = pm_runs
    jout, _, tout, _ = runs[start]
    assert tout.shape == cnt.shape and tout.dtype == np.uint8
    diff = np.abs(tout.astype(int) - jout.astype(int))
    assert (diff <= 2).mean() >= WITHIN2_MIN, (diff <= 2).mean()
    assert diff.mean() <= MEAN_DIFF_MAX, diff.mean()


def _small_pair(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (24, 28, 3)).astype(np.uint8),
            rng.integers(0, 256, (26, 30, 3)).astype(np.uint8))


SMALL = Config(exact_nn_levels=0, fine_strategy="patchmatch", pm_iters=2,
               cg_iters_mg=2, cg_iters_final_mg=2, wls_cg_iters_mg=2,
               kmeans_iters=2, num_levels=3)


def test_warm_start_is_level0_init():
    """With no PatchMatch iteration the level-0 fields are the init: the
    given warm start, or else the scaled identity."""
    cnt, stl = _small_pair(4)
    model = tvgg.init_params()
    cfg = dataclasses.replace(SMALL, pm_iters=0)
    _, trace, state = tpipe.transfer_pair(
        model, cnt, stl, 2.0, cfg, device="cpu", return_intermediates=True,
        return_state=True)
    warm = {k: torch.flip(v, dims=(0,)) for k, v in state.items()}
    _, trace_w = tpipe.transfer_pair(
        model, cnt, stl, 2.0, cfg, device="cpu", return_intermediates=True,
        warm_start=warm)
    for key in ("ann", "bnn"):
        torch.testing.assert_close(trace_w[0][key], warm[key], rtol=0,
                                   atol=0)
        assert not torch.equal(trace[0][key], warm[key])


def test_transfer_sequence_is_chain_of_warm_started_pairs():
    cnt, stl = _small_pair(5)
    frames = [cnt, np.roll(cnt, 2, axis=1), np.roll(cnt, 4, axis=1)]
    model = tvgg.init_params()
    seq = list(tpipe.transfer_sequence(model, frames, stl, 2.0, SMALL,
                                       seed=5, device="cpu"))
    draws = tpipe.GeneratorDraws(5)
    state = None
    assert len(seq) == 3
    for frame, got in zip(frames, seq):
        ref, state = tpipe.transfer_pair(
            model, frame, stl, 2.0, SMALL, draws=draws, device="cpu",
            warm_start=state, return_state=True)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_transfer_sequence_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cnt, stl = _small_pair(6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.transfer_sequence(tvgg.init_params(), [cnt], stl, 2.0, SMALL)
