"""The window refine's stage-1 channel subset in the port
(``nct_tpu_torch.pipeline.stage1_channels``).

The JAX package ranks stage 1 on ``window_stage1_channels_maxsize``
channels only on its staged sub-split path, which runs when the content
level exceeds FUSED_ENVELOPE_PIXELS (``nct_tpu/pipeline.py:748``), and then
only for a direction whose own level exceeds _STAGE1_SUBSET_PIXELS
(``:253-255``); the fused path passes ``window_stage1_channels`` through.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nct_tpu import pipeline as jpipe
from nct_tpu_torch import Config
from nct_tpu_torch import pipeline as tpipe
from nct_tpu_torch.models import vgg19 as tvgg

torch.set_num_threads(1)

T = 320_000
# (content level px, own level px, threshold, window_stage1_channels,
#  channels JAX ranks on); maxsize is 32
GATE_CASES = [
    (307_360, 307_360, T, 0, 0),       # the 452x680 pair, a->b: fused path
    (307_360, 576_000, T, 0, 0),       # its b->a direction: fused path too
    (576_000, 576_000, T, 0, 32),      # staged, both over
    (576_000, 307_360, T, 0, 0),       # staged, own level under
    (576_000, 576_000, T, 48, 48),     # an explicit value always wins
    (307_360, 576_000, T, 16, 16),
    (T, T + 1, T, 0, 0),               # "more than": equal is not over
    (T + 1, T + 1, T, 0, 32),
    (1, 1, 0, 0, 32),                  # threshold 0: every level
    (672, 1_020, 800, 0, 0),           # threshold between content and own
    (1_020, 672, 800, 0, 0),
]


@pytest.mark.parametrize("content,own,threshold,explicit,want", GATE_CASES)
def test_gate_table(content, own, threshold, explicit, want):
    cfg = Config(window_stage1_channels=explicit,
                 window_stage1_channels_maxsize=32)
    assert tpipe.stage1_channels(cfg, content, own, threshold) == want


def test_default_threshold_is_jax_constants(monkeypatch):
    assert tpipe.STAGE1_SUBSET_PIXELS == jpipe.FUSED_ENVELOPE_PIXELS
    assert tpipe.STAGE1_SUBSET_PIXELS == jpipe._STAGE1_SUBSET_PIXELS
    cfg = Config()
    assert tpipe.stage1_channels(cfg, T + 1, T + 1) == 32
    monkeypatch.setattr(tpipe, "STAGE1_SUBSET_PIXELS", 10 ** 9)
    assert tpipe.stage1_channels(cfg, T + 1, T + 1) == 0


# content 24x28 = 672 px, style 30x34 = 1,020 px at L4 (full resolution)
CNT_HW, STL_HW = (24, 28), (30, 34)
SMALL = Config(cg_iters_mg=3, cg_iters_final_mg=2, wls_cg_iters_mg=2,
               kmeans_iters=2, feature_dtype="float32",
               window_stage1_channels_maxsize=2)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    cnt = rng.integers(0, 256, CNT_HW + (3,)).astype(np.uint8)
    stl = rng.integers(0, 256, STL_HW + (3,)).astype(np.uint8)
    return tvgg.init_params(), cnt, stl


def _run(pair, config):
    model, cnt, stl = pair
    return tpipe.transfer_pair(model, cnt, stl, 2.0, config, seed=3,
                               device="cpu").numpy()


@pytest.fixture(scope="module")
def unsubset(pair):
    return _run(pair, dataclasses.replace(SMALL, window_stage1_channels=0))


def test_threshold_zero_equals_explicit_subset(pair, monkeypatch):
    explicit = _run(pair, dataclasses.replace(SMALL, window_stage1_channels=2))
    monkeypatch.setattr(tpipe, "STAGE1_SUBSET_PIXELS", 0)
    auto = _run(pair, SMALL)
    np.testing.assert_array_equal(auto, explicit)


def test_threshold_between_content_and_style_is_unsubset(pair, unsubset,
                                                         monkeypatch):
    """Content under, style over: JAX's fused path, no subset in either
    direction."""
    monkeypatch.setattr(tpipe, "STAGE1_SUBSET_PIXELS", 800)
    np.testing.assert_array_equal(_run(pair, SMALL), unsubset)


def test_subset_changes_the_result(pair, unsubset):
    """The two cases above are told apart: the subset moves the output."""
    subset = _run(pair, dataclasses.replace(SMALL, window_stage1_channels=2))
    assert not np.array_equal(subset, unsubset)
