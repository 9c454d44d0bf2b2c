"""Parity of the port's exact bidirectional NN search with nct_tpu.

``exact_nn_bidir_plain`` (the CPU path and the card-side oracle of the CUDA
kernel) is held against the Pallas kernel in interpret mode
(``exact_nn_pallas_bidir``) and against the XLA formulation
(``exact_nn.exact_nn``, run once per direction): bitwise where every f32
sum is exact, tie-robust otherwise.  The CUDA wrapper's own checks (which
raise rather than fall back) and the key encoding the kernel reduces with
are tested here too; the kernel itself runs in chip_smoke.py on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nct_tpu.ops.exact_nn import exact_nn
from nct_tpu_torch.ops import cuda_nn
from nct_tpu_torch.ops.exact_nn import (
    exact_nn_bidir_plain, nn_bidir_tables_plain, prep_tables,
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
    before = cuda_nn.LAUNCHES
    got = cuda_nn.exact_nn_bidir(a, b, 3)
    ref = exact_nn_bidir_plain(a, b, 3)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert cuda_nn.LAUNCHES == before


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
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_nn.nn_bidir_tables(*bad_kc)
    with pytest.raises(ValueError, match="padded"):
        cuda_nn.nn_bidir_tables(*_tables(n_a=100))
    # well-formed CPU tables are refused too: the kernel path never runs
    # the plain version
    with pytest.raises(ValueError, match="CUDA"):
        cuda_nn.nn_bidir_tables(fa, ma, fb, mb)
