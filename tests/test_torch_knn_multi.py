"""Parity of the port's multi-membership k-NN merge with nct_tpu:
``cluster.multi_labels_for_pixels``, the P > 1 path of ``knn.knn_graph``
and the numpy exact oracle ``knn_exact``.

Tolerances: labels, ids and slots bitwise; weights rtol 1e-5 (torch's and
XLA's float32 ``exp`` differ by an ulp); the recall fence of
tests/test_stats_cluster_knn.py (id and weight recall 1.0 within 1e-6) on
the same inputs and the same candidate draw.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nct_tpu.solve import cluster as jcl
from nct_tpu.solve import knn as jknn
from nct_tpu.solve import knn_exact as jke
from nct_tpu_torch.solve import cluster as tcl
from nct_tpu_torch.solve import knn as tknn
from nct_tpu_torch.solve import knn_exact as tke

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def T(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("k,p", [(10, 2), (10, 3), (3, 5), (5, 1), (4, 4)])
def test_multi_labels_for_pixels_bitwise(rng, k, p):
    lm = rng.integers(0, k, (7, 9)).astype(np.int32)
    mem = jcl.cluster_membership(jnp.asarray(lm), k)
    for h, w, stride in ((7, 9, 1), (28, 36, 4), (30, 37, 4)):
        ref = np.asarray(jcl.multi_labels_for_pixels(
            jnp.asarray(lm), mem, h, w, stride, p))
        got = tcl.multi_labels_for_pixels(T(lm), T(mem), h, w, stride, p)
        assert got.shape == ref.shape == (h, w, min(p, k))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_multi_labels_ties_keep_lower_cluster_first():
    """A cell in three dilated memberships lists them in cluster order
    after its primary (lax.top_k's stable order); a cell in two repeats
    its primary in the third place."""
    lm = np.array([[2, 0], [1, 1]], np.int32)
    mem = tcl.cluster_membership(T(lm), 3)
    got = tcl.multi_labels_for_pixels(T(lm), mem, 2, 2, 1, 3).numpy()
    np.testing.assert_array_equal(got[0, 0], [2, 0, 1])
    np.testing.assert_array_equal(got[1, 1], [1, 0, 1])


def _graph_inputs(rng, p, quantised=True):
    d = dict(np.load(os.path.join(FIXTURES, "nl_L1.npz")))
    lab = d["src_lab"]
    if quantised:
        # multiples of 1/64: every product and sum is exact in float32
        lab = (np.round(lab * 64) / 64).astype(np.float32)
    h, w, _ = lab.shape
    lm = rng.integers(0, 10, (h // 8 + 1, w // 8 + 1)).astype(np.int32)
    mem = jcl.cluster_membership(jnp.asarray(lm), 10)
    labels = np.asarray(jcl.multi_labels_for_pixels(jnp.asarray(lm), mem, h,
                                                    w, 8, p))
    return lab, labels, d["candidates"]


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("quantised", [True, False])
def test_multi_graph_equal(rng, p, quantised):
    """Equal ids and slots: bitwise on quantised colours by construction,
    and on continuous ones too, since the port rounds the three 3-term
    sums of the distance as XLA does (ops/fmath.dot3_fma)."""
    lab, labels, cand = _graph_inputs(rng, p, quantised)
    ri, rw, rs = (np.asarray(x) for x in jknn.knn_graph(
        jnp.asarray(lab), jnp.asarray(labels), jnp.asarray(cand)))
    gi, gw, gs = (x.numpy() for x in tknn.knn_graph(T(lab), T(labels),
                                                    T(cand)))
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gs, rs)
    np.testing.assert_allclose(gw, rw, rtol=1e-5, atol=0)
    # slots point at the selected ids in the flat candidate table
    np.testing.assert_array_equal(cand.reshape(-1)[gs], gi)


def test_multi_graph_does_not_depend_on_chunk(rng):
    lab, labels, cand = _graph_inputs(rng, 3, quantised=False)
    a = tknn.knn_graph(T(lab), T(labels), T(cand))
    b = tknn.knn_graph(T(lab), T(labels), T(cand), chunk=777)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_single_membership_column_is_the_sorted_path(rng):
    """[H, W, 1] labels take the P == 1 path, bitwise the [H, W] call."""
    lab, labels, cand = _graph_inputs(rng, 1)
    a = tknn.knn_graph(T(lab), T(labels[..., 0]), T(cand))
    b = tknn.knn_graph(T(lab), T(labels), T(cand))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_multi_graph_union_bruteforce(rng):
    """P = 2 over two clusters that split the pixels: the k best of the
    union of both candidate tables (float64 brute force)."""
    h, w, k = 4, 6, 3
    n = h * w
    lab = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    cand = torch.stack([torch.arange(n // 2), torch.arange(n // 2, n)])
    multi = torch.tensor([0, 1]).repeat(h, w, 1)
    ids, _, slots = tknn.knn_graph(T(lab), multi, cand, k_num=k)
    torch.testing.assert_close(cand.reshape(-1)[slots], ids)
    flat = lab.reshape(n, 3).astype(np.float64)
    for i in range(n):
        d = ((flat - flat[i]) ** 2).sum(axis=1)
        d[i] = np.inf
        assert set(ids[i].tolist()) == set(np.argsort(d)[:k].tolist())


def _fence_case():
    """The inputs of the JAX package's exact-reference fence."""
    rng = np.random.default_rng(3)
    h, w, stride = 48, 64, 4
    lab = rng.uniform(0, 1, (h, w, 3))
    for _ in range(2):
        lab = (lab + np.roll(lab, 1, 0) + np.roll(lab, -1, 0)
               + np.roll(lab, 1, 1) + np.roll(lab, -1, 1)) / 5
    lab = lab.astype(np.float32)
    lm = rng.integers(0, 10, (h // stride, w // stride)).astype(np.int32)
    return lab, lm, h, w, stride


def test_knn_exact_copy_equals_jax_package():
    lab, lm, h, w, stride = _fence_case()
    memb = tcl.cluster_membership(T(lm), 10)
    member_pix = tcl.membership_for_pixels(memb, h, w, stride).numpy()
    got = tke.exact_knn_graph(lab, member_pix, 8)
    ref = jke.exact_knn_graph(lab, member_pix, 8)
    for g, r in zip(got, ref):
        assert len(g) == len(r) == h * w
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
    ids = np.stack([np.pad(x, (0, 8 - x.size)) for x in got[0]])
    wts = np.stack([np.pad(x, (0, 8 - x.size)) for x in got[1]])
    assert tke.graph_recall(ids, wts, *got) == jke.graph_recall(ids, wts,
                                                               *ref)


def test_multi_graph_recall_fence():
    """All members as candidates (the JAX package's draw) and every dilated
    membership queried: the port's graph is the exact graph (id and weight
    recall 1.0 against the port's knn_exact)."""
    lab, lm, h, w, stride = _fence_case()
    memb = tcl.cluster_membership(T(lm), 10)
    member_pix = tcl.membership_for_pixels(memb, h, w, stride)
    ex_ids, ex_w = tke.exact_knn_graph(lab, member_pix.numpy(), 8)
    cand = jknn.sample_cluster_candidates(
        jnp.asarray(member_pix.numpy()), jax.random.PRNGKey(0), h * w)
    labels = tcl.multi_labels_for_pixels(T(lm), memb, h, w, stride, 5)
    ids, ws, _ = tknn.knn_graph(T(lab), labels, T(cand), k_num=8)
    rid, rw = tke.graph_recall(ids.numpy(), ws.numpy(), ex_ids, ex_w)
    assert rid == pytest.approx(1.0, abs=1e-6)
    assert rw == pytest.approx(1.0, abs=1e-6)
