"""The port's transfer_pair from a level-0 warm start under PatchMatch, and
transfer_sequence as a chain of warm-started pairs.

The level-by-level comparison of the PatchMatch pair with JAX's (cold and
warm) is in ``tests/test_torch_space_shard.py``, beside the other
whole-pipeline JAX references: one process compiles JAX's pipeline once
for them all.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nct_tpu_torch import Config
from nct_tpu_torch import pipeline as tpipe
from nct_tpu_torch.models import vgg19 as tvgg

torch.set_num_threads(1)


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
