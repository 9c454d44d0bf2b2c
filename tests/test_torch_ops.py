"""Parity of the PyTorch port's ops (nct_tpu_torch.ops) with nct_tpu.

The same seeded numpy inputs go through the JAX function and its port on
the CPU.  Integer-exact computations are compared bitwise; where float
summation order differs between XLA and torch, the tolerance and its
reason are stated at the assertion.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nct_tpu.ops import bds as jbds
from nct_tpu.ops import color as jcolor
from nct_tpu.ops import features as jfeat
from nct_tpu.ops import nnf as jnnf
from nct_tpu.ops import patchmatch as jpm
from nct_tpu.ops import resize as jresize
from nct_tpu.ops import window_refine as jwr
from nct_tpu_torch import io as tio
from nct_tpu_torch.ops import bds as tbds
from nct_tpu_torch.ops import color as tcolor
from nct_tpu_torch.ops import features as tfeat
from nct_tpu_torch.ops import nnf as tnnf
from nct_tpu_torch.ops import patchmatch as tpm
from nct_tpu_torch.ops import resize as tresize
from nct_tpu_torch.ops import window_refine as twr

torch.set_num_threads(1)


def T(x):
    return torch.tensor(np.asarray(x))


def _norm(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _random_nnf(rng, h, w, th, tw):
    return np.stack([rng.integers(0, tw, (h, w)), rng.integers(0, th, (h, w))],
                    axis=-1).astype(np.int32)


# --- colour: bitwise on a seeded 1M sample of the 2**24 uint8 triples -------

@pytest.fixture(scope="module")
def triples():
    return np.random.default_rng(11).integers(
        0, 256, (1 << 20, 3)).astype(np.uint8)


def test_bgr_to_lab_bitwise(triples):
    ref = np.asarray(jcolor.bgr_u8_to_lab_u8(jnp.asarray(triples)))
    got = tcolor.bgr_u8_to_lab_u8(T(triples)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_lab_to_bgr_bitwise(triples):
    ref = np.asarray(jcolor.lab_u8_to_bgr_u8(jnp.asarray(triples)))
    got = tcolor.lab_u8_to_bgr_u8(T(triples)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_unit_lab_to_bgr_bitwise(rng):
    lab = rng.random((64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tcolor.unit_lab_to_bgr_u8(T(lab)).numpy(),
        np.asarray(jcolor.unit_lab_to_bgr_u8(jnp.asarray(lab))))


def test_cbrt_sign_safe_matches_jnp(rng):
    x = np.concatenate([rng.standard_normal(4096), [0.0, -0.0, 1.0, -8.0]])
    x = x.astype(np.float32)
    got = tcolor._cbrt(T(x)).numpy()
    # bitwise on the colour domain is the 2**24-triple test above; off it
    # XLA's pow and float64 pow may differ by one ulp
    np.testing.assert_allclose(got, np.asarray(jnp.cbrt(jnp.asarray(x))),
                               rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(x))
    np.testing.assert_array_equal(tcolor._cbrt(T(-x)).numpy(), -got)


# --- resize: bitwise (the same f32 ops in the same order) -------------------

@pytest.mark.parametrize("src,dst", [((40, 48), (20, 24)), ((17, 23), (40, 9)),
                                     ((9, 12), (9, 5)), ((30, 31), (61, 62))])
def test_resize_bitwise(rng, src, dst):
    u8 = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    f32 = rng.standard_normal(src + (3,)).astype(np.float32)
    for img in (u8, f32, f32[..., 0]):
        np.testing.assert_array_equal(
            tresize.resize_bilinear(T(img), *dst).numpy(),
            np.asarray(jresize.resize_bilinear(jnp.asarray(img), *dst)))


def test_max_size_and_cap(rng):
    for h, w in ((1200, 800), (500, 1500), (999, 1000), (300, 200)):
        assert tresize.max_size_resize_dims(h, w, 1000) == \
            jresize.max_size_resize_dims(h, w, 1000)
    img = rng.integers(0, 256, (90, 60, 3)).astype(np.uint8)
    got = tio.cap_max_size(img, 50)
    assert got.shape == (50, 33, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, np.asarray(jresize.resize_bilinear(jnp.asarray(img), 50, 33)))
    assert tio.cap_max_size(img, 100) is img


def test_io_pairs_and_names(tmp_path):
    p = tmp_path / "pairs.txt"
    p.write_text("a.png b.png 1.5\n\nc.jpg d.jpg\n")
    pairs = tio.read_pairs(str(p), default_bds=2.0)
    assert [(q.content, q.style, q.bds_weight) for q in pairs] == [
        ("a.png", "b.png", 1.5), ("c.jpg", "d.jpg", 2.0)]
    with pytest.raises(ValueError):
        tio.read_pairs(str(p))
    assert tio.output_name("x/in0.png", "y/tar0.jpg", 2.0) == "in0_tar0_2.00.png"


def test_imread_imwrite_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    tio.imwrite_bgr(path, img)
    np.testing.assert_array_equal(tio.imread_bgr(path), img)


# --- features, patchify, NNF lifecycle --------------------------------------

def test_l2_normalize_and_cosine_error(rng):
    f = rng.standard_normal((6, 7, 16)).astype(np.float32)
    g = rng.standard_normal((6, 7, 16)).astype(np.float32)
    jn, jr = jfeat.l2_normalize(jnp.asarray(f))
    tn, tr = tfeat.l2_normalize(T(f))
    # 16-term f32 sums in another order: a few ulps
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tfeat.cosine_error(T(f), T(g)).numpy(),
        np.asarray(jfeat.cosine_error(jnp.asarray(f), jnp.asarray(g))),
        rtol=1e-5, atol=1e-5)
    bf = tfeat.l2_normalize(T(f).to(torch.bfloat16))[0]
    assert bf.dtype == torch.bfloat16


def test_patchify_bitwise(rng):
    f = rng.standard_normal((5, 6, 4)).astype(np.float32)
    assert tpm.patch_offsets(3) == jpm.patch_offsets(3)
    jp, jm = jpm.patchify(jnp.asarray(f), 3)
    tp, tm = tpm.patchify(T(f), 3)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("a,b", [((3, 3), (4, 5)), ((1, 7), (9, 1)),
                                 ((10, 12), (12, 13))])
def test_nnf_init_bitwise(a, b):
    np.testing.assert_array_equal(
        tnnf.init_scaled_identity(*a, *b).numpy(),
        np.asarray(jnnf.init_scaled_identity(*a, *b)))


@pytest.mark.parametrize("half,full,b", [((3, 3), (5, 6), (6, 7)),
                                         ((10, 12), (20, 23), (22, 26))])
def test_nnf_upsample_bitwise(rng, half, full, b):
    coarse = _random_nnf(rng, *half, (b[0] + 1) // 2, (b[1] + 1) // 2)
    np.testing.assert_array_equal(
        tnnf.upsample(T(coarse), *full, *b).numpy(),
        np.asarray(jnnf.upsample(jnp.asarray(coarse), *full, *b)))


# --- BDS vote ---------------------------------------------------------------

def test_bds_vote_and_guide(rng):
    ha, wa, hb, wb = 9, 11, 10, 8
    ann = _random_nnf(rng, ha, wa, hb, wb)
    bnn = _random_nnf(rng, hb, wb, ha, wa)
    feat = rng.standard_normal((hb, wb, 5)).astype(np.float32)
    jv, jw = jbds.bds_vote(jnp.asarray(feat), jnp.asarray(ann),
                           jnp.asarray(bnn), 1.0, 2.0, 3)
    tv, tw = tbds.bds_vote(T(feat), T(ann), T(bnn), 1.0, 2.0, 3)
    # same adds in the same order (sorted scatter): equal up to XLA fusion
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-9)
    img = rng.integers(0, 256, (hb, wb, 3)).astype(np.uint8)
    jg = np.asarray(jbds.bds_reconstruct_color(
        jnp.asarray(img), jnp.asarray(ann), jnp.asarray(bnn), 1.0, 2.0, 3))
    tg = tbds.bds_reconstruct_color(T(img), T(ann), T(bnn), 1.0, 2.0,
                                    3).numpy()
    # the guide FLOORS the weighted mean, so a last-bit difference in the
    # sum can flip one LSB: allow 1 LSB, and demand most values equal
    diff = np.abs(tg.astype(int) - jg.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


# --- window refine ----------------------------------------------------------

def _window_case(rng, integer):
    ha, wa, hb, wb, c = 12, 14, 13, 15, 8
    if integer:
        # {-2..2}: every bf16 product and f32 sum is exact, so the two
        # implementations must agree bitwise, ties and all
        a = rng.integers(-2, 3, (ha, wa, c)).astype(np.float32)
        b = rng.integers(-2, 3, (hb, wb, c)).astype(np.float32)
    else:
        a = _norm(rng.standard_normal((ha, wa, c)))
        b = _norm(rng.standard_normal((hb, wb, c)))
    return a, b, _random_nnf(rng, ha, wa, hb, wb)


@pytest.mark.parametrize("stage1", [0, 4])
def test_window_refine_bitwise_integer(rng, stage1):
    a, b, nnf0 = _window_case(rng, integer=True)
    jn, jd = jwr.window_refine(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(nnf0), 2, 3, 3, stage1, "shifts")
    tn, td = twr.window_refine(T(a), T(b), T(nnf0), 2, 3, 3, stage1)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_window_refine_random_tie_robust(rng):
    a, b, nnf0 = _window_case(rng, integer=False)
    jn, jd = jwr.window_refine(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(nnf0), 4, 2, 3, 0, "shifts")
    tn, td = twr.window_refine(T(a), T(b), T(nnf0), 4, 2, 3, 0)
    # summation order differs, so near-tied candidates may swap; the match
    # must be as good (to f32 rounding) and almost always the same one
    assert (tn.numpy() == np.asarray(jn)).all(-1).mean() >= 0.99
    assert (td.numpy() <= np.asarray(jd) + 1e-5).all()
