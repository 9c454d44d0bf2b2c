"""The float32 3x3 convolution of the port (``nct_tpu_torch/ops/conv3x3.py``)
on the CPU: its chain oracle ``conv3x3_chain`` against the plain version
and the JAX package's convolution, the fused ReLU, and the tile rule.  The
kernel itself runs only on a card (``tests/test_torch_cuda.py``, where
every tile is held bitwise to ``conv3x3_chain``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nct_tpu.models import vgg19 as jv
from nct_tpu_torch.models import vgg19 as tv
from nct_tpu_torch.ops import conv3x3 as cv

torch.set_num_threads(1)

# (n, cin, cout, h, w): cin 3 (conv1_1), chunks of 8 channels filled and
# not, widths that are not a multiple of 4, a batch, a one-row band
SHAPES = [(1, 3, 8, 7, 9), (2, 16, 12, 5, 6), (1, 11, 6, 1, 13),
          (1, 64, 4, 4, 5)]


def _inputs(seed, n, cin, cout, h, w, integer=False):
    """x [n, cin, h + 2, w] with its pad rows zero, weight, bias."""
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-3, 4, (n, cin, h, w))
        wt = rng.integers(-2, 3, (cout, cin, 3, 3))
        b = rng.integers(-4, 5, cout)
    else:
        x = rng.standard_normal((n, cin, h, w))
        wt = rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))
        b = 0.1 * rng.standard_normal(cout)
    x, wt, b = (torch.from_numpy(np.asarray(v, np.float32)) for v in (x, wt, b))
    return F.pad(x, (0, 0, 1, 1)), wt, b


@pytest.mark.parametrize("shape", SHAPES)
def test_chain_matches_plain(shape):
    """The chain against ``F.conv2d``: both sum the same float32 products,
    in other orders, so rtol 1e-5 with an absolute floor at 1e-5 of the
    largest output (sums near zero cancel)."""
    xp, wt, b = _inputs(1, *shape)
    got = cv.conv3x3_chain(xp, wt, b)
    want = cv.conv3x3_plain(xp, wt, b)
    assert got.shape == want.shape == (shape[0], shape[2]) + shape[3:]
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_chain_bitwise_plain_on_small_integers(shape):
    """Small integers: every product and partial sum is exact in float32,
    so any order gives the same bits."""
    xp, wt, b = _inputs(2, *shape, integer=True)
    for relu in (False, True):
        assert torch.equal(cv.conv3x3_chain(xp, wt, b, relu),
                           cv.conv3x3_plain(xp, wt, b, relu))


def test_chain_band_rows_bitwise_whole_image():
    """A band of rows (its padded rows [r0, r1 + 2)) gives the whole
    image's rows [r0, r1) bit for bit, a one-row band included."""
    xp, wt, b = _inputs(3, 1, 13, 9, 11, 10)
    whole = cv.conv3x3_chain(xp, wt, b)
    for r0, r1 in ((0, 4), (4, 5), (5, 11), (10, 11)):
        band = cv.conv3x3_chain(xp[:, :, r0:r1 + 2], wt, b)
        assert torch.equal(band, whole[:, :, r0:r1]), (r0, r1)


def _jax_conv(x_nchw, wt, b):
    """``nct_tpu/models/vgg19.py``'s float32 convolution, bias and ReLU
    (its ``lax.conv_general_dilated`` call) on x [N, Cin, H, W]."""
    x = jnp.asarray(x_nchw.permute(0, 2, 3, 1).numpy())
    w = jnp.asarray(wt.permute(2, 3, 1, 0).numpy())        # HWIO
    y = jax.lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding=((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    y = jnp.maximum(y + jnp.asarray(b.numpy()), 0.0)
    return torch.from_numpy(np.array(y)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", SHAPES)
def test_chain_matches_jax_convolution(shape):
    """The chain with ReLU against XLA's float32 convolution as the JAX
    package calls it, on the CPU: rtol 1e-5, atol 1e-5 of the largest
    output (XLA sums the same products in its own order)."""
    xp, wt, b = _inputs(4, *shape)
    got = cv.conv3x3_chain(xp, wt, b, relu=True)
    want = _jax_conv(xp[:, :, 1:-1], wt, b)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_chain_matches_jax_vgg_conv1_1():
    """conv1_1 of the JAX package's own ``features`` (mean-subtracted BGR,
    the tap post-ReLU) against the chain on the port's preprocessed image:
    rtol 1e-5, atol 1e-5 of the largest tap value."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (9, 14, 3)).astype(np.uint8)
    wt = (rng.standard_normal((3, 3, 3, 8)) * 0.2).astype(np.float32)
    b = (0.1 * rng.standard_normal(8)).astype(np.float32)
    params = {"conv1_1": {"w": jnp.asarray(wt), "b": jnp.asarray(b)}}
    want = np.asarray(jv.features(params, jnp.asarray(img), ("conv1_1",),
                                  jnp.float32)["conv1_1"])
    x = (torch.from_numpy(img).float()
         - torch.tensor(tv.BGR_MEAN)).permute(2, 0, 1)[None]
    got = cv.conv3x3_chain(F.pad(x, (0, 0, 1, 1)),
                           torch.from_numpy(wt).permute(3, 2, 0, 1),
                           torch.from_numpy(b), relu=True)
    np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("fn", [cv.conv3x3, cv.conv3x3_plain,
                                cv.conv3x3_chain])
def test_relu_is_torch_relu_of_the_result(fn):
    """``relu=True`` gives ``torch.relu`` of the result, bit for bit, in
    the wrapper (the CPU runs the plain version), the plain version and
    the chain."""
    xp, wt, b = _inputs(6, 1, 5, 7, 6, 9)
    out = fn(xp, wt, b)
    assert bool((out < 0).any())
    assert torch.equal(fn(xp, wt, b, relu=True), torch.relu(out))


def test_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version, whatever tile is asked for."""
    xp, wt, b = _inputs(7, 2, 9, 6, 5, 7)
    want = cv.conv3x3_plain(xp, wt, b)
    assert torch.equal(cv.conv3x3(xp, wt, b), want)
    assert torch.equal(cv.conv3x3(xp, wt, b, cv.kernel_weight(wt),
                                  config=2), want)


def _vgg_layers(h, w):
    dims = tv.feature_dims(h, w)
    for name, cout in tv.VGG19_CONV_LAYERS:
        yield name, cout, dims[name]


@pytest.mark.parametrize("hw", [(452, 680), (600, 960), (665, 1000),
                                (625, 1000)])
def test_tile_rule_gives_every_sm_two_blocks(hw):
    """At every VGG-19 layer of the default pair's and the 1000 px pair's
    images the picked tile's grid has at least two blocks for each of the
    H100's 132 SMs."""
    for name, cout, (h, w) in _vgg_layers(*hw):
        pick = cv.pick_config(1, h, w, cout)
        blocks = cv.grid_blocks(pick, 1, h, w, cout)
        assert blocks >= 2 * cv.H100_SMS, (name, pick, blocks)


@pytest.mark.parametrize("hw, picks", [
    # conv1-2 and conv4 fill tile 0's 528 slots (4.75, 2.42, 0.73 waves);
    # conv3's 1.36 waves would leave its second wave a third full; conv5
    # gives tile 1 192 blocks
    ((452, 680), [0] * 4 + [1] * 4 + [0] * 4 + [2] * 4),
    # 10.2, 5.1 and 2.5 waves; conv4's 1.33; conv5's tile 1 grid is 384
    ((665, 1000), [0] * 8 + [1] * 8),
])
def test_tile_rule_picks(hw, picks):
    """The rule's tiles at the 16 layers of the two geometries phase 3c
    times every tile at (chip_smoke.py), and its edges: a large output
    takes the largest tile, a tiny one the smallest."""
    assert [cv.pick_config(1, h, w, cout)
            for _, cout, (h, w) in _vgg_layers(*hw)] == picks
    assert cv.pick_config(1, 1000, 1000, 64) == 0
    assert cv.pick_config(1, 1, 5, 8) == len(cv.CONFIGS) - 1


def test_grid_blocks():
    t = cv.CONFIGS[0]
    assert cv.grid_blocks(0, 2, t.rows + 1, t.cols, 3 * t.channels) == 12
