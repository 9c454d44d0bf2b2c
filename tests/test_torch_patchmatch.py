"""The port's PatchMatch (nct_tpu_torch.ops.patchmatch) against nct_tpu's.

Both sides get the same random-search uniforms: JAX's ``patchmatch`` draws
``jax.random.uniform(key, (iters, n_mags, Ha, Wa, 2))`` from the key it is
given, and the port receives exactly that array.  On integer-valued
features every patch sum is exact, so NNF and distance agree bitwise.  On
random features the sums run in another order; the measured NNF agreement
is 1.0 at the shapes below (float32 and bfloat16 features), and the bound
is 0.95 because one flipped near-tie propagates to its neighbours.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nct_tpu.ops import patchmatch as jpm
from nct_tpu_torch.ops import patchmatch as tpm

torch.set_num_threads(1)

AGREE_MIN = 0.95


def _integer(rng, h, w, c):
    """{-2..2} features from a 3-vector palette: exact sums, many ties."""
    palette = rng.integers(-2, 3, (3, c))
    return palette[rng.integers(0, 3, (h, w))].astype(np.float32)


def _norm(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _both(a, b, nnf0, iters, rs_max, seed, dtype=jnp.float32):
    """(JAX nnf, JAX annd), (port nnf, port annd) from the same draws."""
    key = jax.random.PRNGKey(seed)
    aj, bj = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    jn, jd = jpm.patchmatch(aj, bj, jnp.asarray(nnf0), key, iters=iters,
                            rs_max=rs_max)
    n_mags = max(len(jpm.random_search_mags(rs_max, *b.shape[:2])), 1)
    u = np.array(jax.random.uniform(
        key, (iters, n_mags, *a.shape[:2], 2), dtype=jnp.float32))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ta = torch.from_numpy(np.array(aj.astype(jnp.float32))).to(tdt)
    tb = torch.from_numpy(np.array(bj.astype(jnp.float32))).to(tdt)
    tn, td = tpm.patchmatch(ta, tb, torch.from_numpy(nnf0),
                            torch.from_numpy(u), iters=iters, rs_max=rs_max)
    return (np.asarray(jn), np.asarray(jd)), (tn.numpy(), td.numpy())


def _random_nnf(rng, ha, wa, hb, wb):
    return np.stack([rng.integers(0, wb, (ha, wa)),
                     rng.integers(0, hb, (ha, wa))], -1).astype(np.int32)


# (Ha, Wa, Hb, Wb, C, iters, rs_max); the second's rs_max is larger than
# the image, so the radius clamps to max(Hb, Wb)
@pytest.mark.parametrize("shape", [(9, 11, 10, 8, 8, 2, 4),
                                   (7, 13, 12, 6, 16, 3, 64),
                                   (12, 10, 9, 14, 8, 2, 1)])
def test_patchmatch_bitwise_integer(rng, shape):
    ha, wa, hb, wb, c, iters, rs = shape
    a, b = _integer(rng, ha, wa, c), _integer(rng, hb, wb, c)
    nnf0 = _random_nnf(rng, ha, wa, hb, wb)
    (jn, jd), (tn, td) = _both(a, b, nnf0, iters, rs, seed=ha)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(td, jd)


def test_patchmatch_zero_radius_skips_random_search(rng):
    """rs_max = 0: no radius, one placeholder row of uniforms, and only
    propagation moves the field (JAX's mag-0 step never improves)."""
    a, b = _integer(rng, 6, 7, 8), _integer(rng, 5, 8, 8)
    nnf0 = _random_nnf(rng, 6, 7, 5, 8)
    (jn, jd), (tn, td) = _both(a, b, nnf0, 2, 0, seed=1)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_patchmatch_random_features(rng, dtype):
    a = _norm(rng.standard_normal((20, 24, 16)))
    b = _norm(rng.standard_normal((22, 19, 16)))
    nnf0 = np.zeros((20, 24, 2), np.int32)
    (jn, jd), (tn, td) = _both(a, b, nnf0, 4, 32, seed=5, dtype=dtype)
    assert (tn == jn).all(-1).mean() >= AGREE_MIN
    same = (tn == jn).all(-1)
    np.testing.assert_allclose(td[same], jd[same], atol=1e-6)


def test_patchmatch_default_draws_and_checks(rng):
    a = torch.from_numpy(_integer(rng, 6, 7, 8))
    b = torch.from_numpy(_integer(rng, 5, 8, 8))
    nnf0 = torch.zeros(6, 7, 2, dtype=torch.int32)
    one = tpm.patchmatch(a, b, nnf0, iters=2, rs_max=4,
                         generator=torch.Generator().manual_seed(0))
    two = tpm.patchmatch(a, b, nnf0, iters=2, rs_max=4,
                         generator=torch.Generator().manual_seed(0))
    for x, y in zip(one, two):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert one[0].dtype == torch.int32 and one[1].shape == (6, 7)
    with pytest.raises(ValueError, match="uniforms"):
        tpm.patchmatch(a, b, nnf0, torch.rand(2, 1, 6, 7, 2), iters=2,
                       rs_max=4)


@pytest.mark.parametrize("rs,hb,wb", [(32, 10, 40), (5, 3, 3), (0, 4, 4)])
def test_random_search_mags(rs, hb, wb):
    assert tpm.random_search_mags(rs, hb, wb) == \
        jpm.random_search_mags(rs, hb, wb)
