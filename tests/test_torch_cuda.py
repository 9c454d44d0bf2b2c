"""Tests of the port that need an NVIDIA card (marker ``cuda``).

They skip without one.  This file imports no JAX, so it runs on the card's
machine, which has none (tests/conftest.py does import JAX, hence
``--noconftest``):

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from nct_tpu_torch.ops import cuda_nn
from nct_tpu_torch.ops.exact_nn import exact_nn_bidir_plain, exact_nn_plain

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _integer(rng, h, w, c, device):
    """{-2..2} features from a 3-vector palette: exact sums, many ties."""
    palette = rng.integers(-2, 3, (3, c))
    x = palette[rng.integers(0, 3, (h, w))].astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("shape", [((20, 30), (25, 21), 32),
                                   ((7, 9), (130, 3), 64),
                                   ((29, 43), (38, 60), 512)])
def test_kernel_bitwise_vs_plain_integer(card, shape):
    (ha, wa), (hb, wb), c = shape
    rng = np.random.default_rng(ha)
    a = _integer(rng, ha, wa, c, card)
    b = _integer(rng, hb, wb, c, card)
    before = cuda_nn.LAUNCHES["nn_bidir"]
    got = cuda_nn.exact_nn_bidir(a, b, 3)
    assert cuda_nn.LAUNCHES["nn_bidir"] == before + 1
    ref = exact_nn_bidir_plain(a, b, 3)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_kernel_random_features_tie_robust(card):
    g = torch.Generator().manual_seed(1)
    a = torch.relu(torch.randn(40, 50, 128, generator=g)).to(card)
    b = torch.relu(torch.randn(45, 44, 128, generator=g)).to(card)
    a = a / a.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    b = b / b.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    got = cuda_nn.exact_nn_bidir(a, b, 3)
    ref = exact_nn_bidir_plain(a, b, 3)
    # tensor-core sums run in another order than the f32 matmul: indices
    # agree almost everywhere and distances to f32 rounding
    for i in (0, 2):
        assert (got[i] == ref[i]).all(-1).float().mean().item() >= 0.99
        torch.testing.assert_close(got[i + 1], ref[i + 1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [((20, 30), (25, 21), 32),
                                   ((7, 9), (130, 3), 64),
                                   ((29, 43), (38, 60), 512)])
def test_directed_kernel_bitwise_vs_plain_integer(card, shape):
    (ha, wa), (hb, wb), c = shape
    rng = np.random.default_rng(ha + 1)
    a = _integer(rng, ha, wa, c, card)
    b = _integer(rng, hb, wb, c, card)
    before = cuda_nn.LAUNCHES["nn_directed"]
    got = cuda_nn.exact_nn(a, b, 3)
    assert cuda_nn.LAUNCHES["nn_directed"] == before + 1
    ref = exact_nn_plain(a, b, 3)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("integer", [True, False])
def test_directed_kernel_is_bidir_row_half(card, integer):
    """Same tile arithmetic and accumulation order: the directed instance's
    keys equal the bidirectional instance's row keys bitwise."""
    rng = np.random.default_rng(7)
    if integer:
        a = _integer(rng, 40, 50, 128, card)
        b = _integer(rng, 45, 44, 128, card)
    else:
        a = torch.relu(torch.from_numpy(
            rng.standard_normal((40, 50, 128)).astype(np.float32))).to(card)
        b = torch.relu(torch.from_numpy(
            rng.standard_normal((45, 44, 128)).astype(np.float32))).to(card)
    fa, ma = cuda_nn.padded_tables(a, 3)
    fb, mb = cuda_nn.padded_tables(b, 3)
    d_ab, i_ab = cuda_nn.nn_directed_tables(fa, ma, fb, mb)
    bidir = cuda_nn.nn_bidir_tables(fa, ma, fb, mb)
    torch.testing.assert_close(d_ab, bidir[0], rtol=0, atol=0)
    torch.testing.assert_close(i_ab, bidir[1], rtol=0, atol=0)


def test_mixed_devices_raise(card):
    a = torch.zeros(5, 6, 32, device=card)
    with pytest.raises(ValueError, match="one device"):
        cuda_nn.exact_nn_bidir(a, a.cpu(), 3)
