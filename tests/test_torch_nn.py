"""Parity of the port's exact NN searches with nct_tpu.

``exact_nn_bidir_plain`` and the directed ``exact_nn_plain`` (the CPU paths
and the card-side oracles of the CUDA kernel's two instances) are held
against the Pallas kernels in interpret mode (``exact_nn_pallas_bidir``,
``exact_nn_pallas``) and against the XLA formulation (``exact_nn.exact_nn``):
bitwise where every f32 sum is exact, tie-robust otherwise.  The CUDA
wrappers' own checks (which raise rather than fall back) and the key
encoding the kernel reduces with are tested here too; the kernel itself
runs in chip_smoke.py and tests/test_torch_cuda.py on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nct_tpu.ops.exact_nn import exact_nn
from nct_tpu_torch.ops import cuda_nn
from nct_tpu_torch.ops.exact_nn import (
    exact_nn_bidir_plain, exact_nn_plain, nn_bidir_tables_plain,
    nn_tables_plain, prep_tables,
)

torch.set_num_threads(1)


def _norm(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _integer(rng, h, w, c):
    """Features in {-2..2} from a 3-vector palette: exact f32 sums and
    many exactly tied patches (first-match is exercised)."""
    palette = rng.integers(-2, 3, (3, c))
    return palette[rng.integers(0, 3, (h, w))].astype(np.float32)


def _jax_bidir(a, b):
    nab, dab = exact_nn(jnp.asarray(a), jnp.asarray(b), 3)
    nba, dba = exact_nn(jnp.asarray(b), jnp.asarray(a), 3)
    return [np.asarray(x) for x in (nab, dab, nba, dba)]


def _torch_bidir(a, b):
    return [x.numpy() for x in exact_nn_bidir_plain(
        torch.from_numpy(a), torch.from_numpy(b), 3)]


@pytest.mark.parametrize("shape", [((8, 9), (9, 11), 8), ((7, 13), (12, 6), 16)])
def test_plain_bitwise_integer_vs_exact_nn(rng, shape):
    (ha, wa), (hb, wb), c = shape
    a, b = _integer(rng, ha, wa, c), _integer(rng, hb, wb, c)
    for got, ref in zip(_torch_bidir(a, b), _jax_bidir(a, b)):
        np.testing.assert_array_equal(got, ref)


def test_plain_bitwise_integer_vs_pallas_interpret(rng):
    from jax.experimental.pallas import tpu as pltpu

    from nct_tpu.ops.pallas_nn import exact_nn_pallas_bidir

    a, b = _integer(rng, 8, 9, 8), _integer(rng, 9, 11, 8)
    with pltpu.force_tpu_interpret_mode():
        ref = exact_nn_pallas_bidir(jnp.asarray(a), jnp.asarray(b),
                                    a_tile=32, b_tile=32)
    for got, r in zip(_torch_bidir(a, b), ref):
        np.testing.assert_array_equal(got, np.asarray(r))


def test_plain_random_tie_robust(rng):
    from jax.experimental.pallas import tpu as pltpu

    from nct_tpu.ops.pallas_nn import exact_nn_pallas_bidir

    a = _norm(rng.standard_normal((10, 12, 16)))
    b = _norm(rng.standard_normal((11, 9, 16)))
    got = _torch_bidir(a, b)
    with pltpu.force_tpu_interpret_mode():
        pal = [np.asarray(x) for x in exact_nn_pallas_bidir(
            jnp.asarray(a), jnp.asarray(b), a_tile=32, b_tile=32)]
    for ref in (_jax_bidir(a, b), pal):
        # f32 sums in another order: near-tied matches may swap, so the
        # index agrees almost everywhere and the distance at the port's
        # match is never worse than the reference's minimum by > 1e-3
        for i in (0, 2):
            assert (got[i] == ref[i]).all(-1).mean() >= 0.99
            assert (got[i + 1] <= ref[i + 1] + 1e-3).all()
            np.testing.assert_allclose(got[i + 1], ref[i + 1], atol=1e-5)


def _pallas_directed(a, b):
    from jax.experimental.pallas import tpu as pltpu

    from nct_tpu.ops.pallas_nn import exact_nn_pallas

    with pltpu.force_tpu_interpret_mode():
        return [np.asarray(x) for x in exact_nn_pallas(
            jnp.asarray(a), jnp.asarray(b), 3, a_tile=32, b_tile=32)]


def _torch_directed(a, b):
    return [x.numpy() for x in exact_nn_plain(
        torch.from_numpy(a), torch.from_numpy(b), 3)]


@pytest.mark.parametrize("shape", [((8, 9), (9, 11), 8), ((7, 13), (12, 6), 16)])
def test_directed_plain_bitwise_integer(rng, shape):
    (ha, wa), (hb, wb), c = shape
    a, b = _integer(rng, ha, wa, c), _integer(rng, hb, wb, c)
    got = _torch_directed(a, b)
    xla = [np.asarray(x) for x in exact_nn(jnp.asarray(a), jnp.asarray(b), 3)]
    for ref in (xla, _pallas_directed(a, b)):
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(x, y)


def test_directed_plain_random_tie_robust(rng):
    a = _norm(rng.standard_normal((10, 12, 16)))
    b = _norm(rng.standard_normal((11, 9, 16)))
    got = _torch_directed(a, b)
    xla = [np.asarray(x) for x in exact_nn(jnp.asarray(a), jnp.asarray(b), 3)]
    for ref in (xla, _pallas_directed(a, b)):
        # f32 sums in another order: index agreement >= 0.99 and the
        # distance at the port's match no worse than the minimum by > 1e-3
        assert (got[0] == ref[0]).all(-1).mean() >= 0.99
        assert (got[1] <= ref[1] + 1e-3).all()
        np.testing.assert_allclose(got[1], ref[1], atol=1e-5)


@pytest.mark.parametrize("integer", [True, False])
def test_directed_plain_is_bidir_row_half(rng, integer):
    """The directed search is the bidirectional sweep without its column
    fold: its result is the row half, bitwise."""
    make = _integer if integer else (
        lambda r, h, w, c: _norm(r.standard_normal((h, w, c))))
    fa, ma = prep_tables(torch.from_numpy(make(rng, 9, 10, 8)), 3)
    fb, mb = prep_tables(torch.from_numpy(make(rng, 11, 7, 8)), 3)
    d_ab, i_ab = nn_tables_plain(fa, ma, fb, mb, a_chunk=16, b_tile=8)
    bidir = nn_bidir_tables_plain(fa, ma, fb, mb, a_chunk=16, b_tile=8)
    torch.testing.assert_close(d_ab, bidir[0], rtol=0, atol=0)
    torch.testing.assert_close(i_ab, bidir[1], rtol=0, atol=0)


def test_plain_tiles_do_not_change_result(rng):
    a = _integer(rng, 9, 10, 8)
    b = _integer(rng, 11, 7, 8)
    fa, ma = prep_tables(torch.from_numpy(a), 3)
    fb, mb = prep_tables(torch.from_numpy(b), 3)
    whole = nn_bidir_tables_plain(fa, ma, fb, mb)
    tiled = nn_bidir_tables_plain(fa, ma, fb, mb, a_chunk=16, b_tile=8)
    for x, y in zip(whole, tiled):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_cpu_dispatch_is_plain(rng):
    a = torch.from_numpy(_integer(rng, 5, 6, 8))
    b = torch.from_numpy(_integer(rng, 6, 5, 8))
    before = dict(cuda_nn.LAUNCHES)
    got = cuda_nn.exact_nn_bidir(a, b, 3)
    ref = exact_nn_bidir_plain(a, b, 3)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert cuda_nn.LAUNCHES == before


def test_directed_cpu_dispatch_is_plain(rng):
    a = torch.from_numpy(_integer(rng, 5, 6, 8))
    b = torch.from_numpy(_integer(rng, 6, 5, 8))
    before = dict(cuda_nn.LAUNCHES)
    got = cuda_nn.exact_nn(a, b, 3)
    ref = exact_nn_plain(a, b, 3)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert cuda_nn.LAUNCHES == before
    with pytest.raises(ValueError, match="one device"):
        cuda_nn.exact_nn(a, b.to("meta"), 3)


def test_key_encoding_roundtrip_and_order():
    d = torch.tensor([-0.0, 0.0, 1.5, -1.5, float("inf"), -3.4e38, 1e-38,
                      -1e-38, 2.0, 1.5])
    idx = torch.tensor([5, 3, 0, 2 ** 31 - 1, 0, 7, 9, 1, 4, 2])
    keys = cuda_nn.encode_keys(d, idx)
    dd, ii = cuda_nn.decode_keys(keys)
    torch.testing.assert_close(dd, torch.where(d == 0, 0.0, d), rtol=0, atol=0)
    assert not torch.signbit(dd[0])            # -0.0 canonicalised
    torch.testing.assert_close(ii, idx.long(), rtol=0, atol=0)
    # unsigned key order == (distance, index) order: the atomicMin picks
    # the smallest distance, then the lowest index (first match)
    unsigned = [k % 2 ** 64 for k in keys.tolist()]
    by_key = sorted(range(len(d)), key=lambda j: unsigned[j])
    by_pair = sorted(range(len(d)), key=lambda j: (float(d[j]), int(idx[j])))
    assert by_key == by_pair


def test_mask_bits():
    m = torch.tensor([[1, 0, 1, 0, 0, 0, 0, 0, 1], [1] * 9, [0] * 9])
    assert cuda_nn.mask_bits(m).tolist() == [261, 511, 0]


@pytest.mark.parametrize("c", [32, 64])
def test_padded_tables_pad_depth_without_changing_result(rng, c):
    """K*C is zero-padded to a multiple of the kernel's depth (9 * 32 = 288
    -> 320; 9 * 64 = 576 stays): the plain search on the padded tables is
    bitwise the search on the unpadded ones."""
    a = torch.from_numpy(_integer(rng, 9, 10, c))
    b = torch.from_numpy(_integer(rng, 11, 7, c))
    fa, ma = cuda_nn.padded_tables(a, 3)
    fb, mb = cuda_nn.padded_tables(b, 3)
    fa0, ma0 = prep_tables(a, 3)
    fb0, mb0 = prep_tables(b, 3)
    kc = 9 * c
    assert fa.shape == (128, -(-kc // cuda_nn.DEPTH) * cuda_nn.DEPTH)
    assert fa.shape[1] % cuda_nn.DEPTH == 0 and fb.shape[1] == fa.shape[1]
    assert not fa[:, kc:].any() and not fa[90:].any()
    torch.testing.assert_close(fa[:90, :kc], fa0, rtol=0, atol=0)
    assert torch.equal(ma[:90], cuda_nn.mask_bits(ma0)) and not ma[90:].any()
    bits = torch.arange(9)
    padded = nn_bidir_tables_plain(fa, ((ma[:, None] >> bits) & 1).float(),
                                   fb, ((mb[:, None] >> bits) & 1).float())
    ref = nn_bidir_tables_plain(fa0, ma0, fb0, mb0)
    for x, y, n in zip(padded, ref, (90, 90, 77, 77)):
        torch.testing.assert_close(x[:n], y, rtol=0, atol=0)


def _tables(n_a=128, n_b=128, kc=64):
    fa = torch.zeros(n_a, kc, dtype=torch.bfloat16)
    fb = torch.zeros(n_b, kc, dtype=torch.bfloat16)
    return fa, torch.zeros(n_a, dtype=torch.int32), fb, torch.zeros(
        n_b, dtype=torch.int32)


def test_kernel_wrapper_raises_instead_of_falling_back():
    fa, ma, fb, mb = _tables()
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_nn.nn_bidir_tables(fa.float(), ma, fb, mb)
    with pytest.raises(ValueError, match="int32"):
        cuda_nn.nn_bidir_tables(fa, ma.long(), fb, mb)
    wide = torch.zeros(128, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_nn.nn_bidir_tables(wide[:, ::2], ma, fb, mb)
    bad_kc = _tables(kc=72)
    with pytest.raises(ValueError, match="multiple of 64"):
        cuda_nn.nn_bidir_tables(*bad_kc)
    with pytest.raises(ValueError, match="padded"):
        cuda_nn.nn_bidir_tables(*_tables(n_a=100))
    # well-formed CPU tables are refused too: the kernel path never runs
    # the plain version
    with pytest.raises(ValueError, match="CUDA"):
        cuda_nn.nn_bidir_tables(fa, ma, fb, mb)


def test_directed_wrapper_raises_instead_of_falling_back():
    """The directed wrapper validates as the bidirectional one does."""
    fn = cuda_nn.nn_directed_tables
    fa, ma, fb, mb = _tables()
    with pytest.raises(ValueError, match="bfloat16"):
        fn(fa, ma, fb.float(), mb)
    with pytest.raises(ValueError, match="int32"):
        fn(fa, ma, fb, mb.long())
    wide = torch.zeros(128, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fn(fa, ma, wide[:, ::2], mb)
    with pytest.raises(ValueError, match="multiple of 64"):
        fn(*_tables(kc=40))
    with pytest.raises(ValueError, match="padded"):
        fn(*_tables(n_b=200))
    with pytest.raises(ValueError, match="CUDA"):
        fn(fa, ma, fb, mb)
