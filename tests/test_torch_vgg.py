"""Parity of the port's VGG-19 (nct_tpu_torch.models.vgg19) with nct_tpu."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from nct_tpu.models import vgg19 as jv
from nct_tpu_torch.models import vgg19 as tv

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    params = jv.init_params()
    return params, tv.params_from_numpy(params)


@pytest.mark.parametrize("hw", [(37, 45), (32, 40)])
def test_all_taps_f32_match_jax(weights, hw):
    params, model = weights
    img = np.random.default_rng(5).integers(0, 256, hw + (3,)).astype(np.uint8)
    ref = jv.features(params, jnp.asarray(img), jv.PIPELINE_TAPS, jnp.float32)
    got = model(torch.from_numpy(img), tv.PIPELINE_TAPS, torch.float32)
    dims = tv.feature_dims(*hw)
    assert dims == jv.feature_dims(*hw)
    for tap in jv.PIPELINE_TAPS:
        r, g = np.asarray(ref[tap]), got[tap].numpy()
        assert g.shape == dims[tap] + (tv.tap_channels()[tap],)
        # f32 convolutions summed in another order: rtol 1e-4, with an
        # absolute floor at 1e-4 of the tap's scale for values near zero
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())


def test_single_tap_matches_full_forward(weights):
    _, model = weights
    img = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (20, 28, 3)).astype(np.uint8))
    full = model(img, tv.PIPELINE_TAPS)
    for tap in ("conv3_1", "conv1_1"):
        torch.testing.assert_close(model(img, (tap,))[tap], full[tap],
                                   rtol=0, atol=0)


def test_bf16_taps_close_to_jax(weights):
    """bf16 activations round where the JAX package rounds them; rounding
    flips at bf16 boundaries compound with depth, so the shallow taps are
    held tightly and the deep ones to a few bf16 ulps of the tap scale."""
    params, model = weights
    img = np.random.default_rng(7).integers(0, 256, (24, 30, 3)).astype(np.uint8)
    ref = jv.features(params, jnp.asarray(img), jv.PIPELINE_TAPS, jnp.bfloat16)
    got = model(torch.from_numpy(img), tv.PIPELINE_TAPS, torch.bfloat16)
    for tap, rel in (("conv1_1", 1e-5), ("conv2_1", 1e-3), ("conv5_1", 3e-2)):
        r, g = np.asarray(ref[tap]), got[tap].numpy()
        assert np.abs(g - r).max() <= rel * np.abs(r).max(), tap


@pytest.mark.parametrize("hw", [(7, 9), (8, 8), (5, 6)])
def test_ceil_mode_pool_matches_reduce_window(hw):
    x = np.random.default_rng(8).standard_normal((1,) + hw + (3,)).astype(
        np.float32)
    ref = np.asarray(jv._ceil_maxpool(jnp.asarray(x)))
    got = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 2, 2,
                       ceil_mode=True).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_init_params_seeded_he(weights):
    a = tv.init_params(torch.Generator().manual_seed(1))
    b = tv.init_params(torch.Generator().manual_seed(1))
    for name, conv in a.convs.items():
        torch.testing.assert_close(conv.weight, b.convs[name].weight)
        fan_in = 9 * conv.weight.shape[1]
        std = conv.weight.std().item()
        assert 0.8 < std / np.sqrt(2.0 / fan_in) < 1.2
    assert len(a.convs) == 16


def test_load_params_truncated(tmp_path, weights):
    params, model = weights
    path = tmp_path / "w.npz"
    keep = [n for n, _ in jv.VGG19_CONV_LAYERS][:13]       # up to conv5_1
    np.savez(path, **{f"{n}_{k}": params[n][k] for n in keep for k in "wb"})
    loaded = tv.load_params(str(path))
    assert list(loaded.convs) == keep
    torch.testing.assert_close(loaded.convs["conv5_1"].weight,
                               model.convs["conv5_1"].weight)
