"""Numpy exact build of the reference's k-NN graph (port's copy of
``nct_tpu/solve/knn_exact.py``): the validation oracle of ``knn_graph``,
never on the pipeline's path.

  * every pixel queries EVERY cluster whose boundary-dilated member list
    contains it;
  * each per-cluster query returns the k nearest OTHER members by squared
    unit-Lab L2 (in float64);
  * per pixel, all per-cluster results are merged, deduplicated by id, and
    the first k by distance kept with weight exp(1 - d/3).
"""

from __future__ import annotations

import numpy as np


def exact_knn_graph(
    lab_unit: np.ndarray,
    member_pix: np.ndarray,
    k_num: int = 8,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Exact multi-membership k-NN graph.

    lab_unit: [H, W, 3] float unit-Lab; member_pix: bool [K, H, W] dilated
    per-cluster pixel membership (cluster.membership_for_pixels).  Returns
    (ids, weights): per-pixel variable-length arrays (<= k_num), ids into
    the flat H*W pixel axis, weights exp(1 - d/3).
    """
    h, w, _ = lab_unit.shape
    n = h * w
    colors = lab_unit.reshape(n, 3).astype(np.float64)
    kc = member_pix.shape[0]
    px_parts: list[np.ndarray] = []
    id_parts: list[np.ndarray] = []
    d_parts: list[np.ndarray] = []

    for c in range(kc):
        ids = np.nonzero(member_pix[c].reshape(-1))[0].astype(np.int64)
        if ids.size <= 1:
            continue
        cc = colors[ids]                                   # [m, 3]
        # full pairwise squared distances within the cluster list (chunked
        # over query rows to bound the [m, m] buffer at MAX_SIZE grids)
        sq = np.sum(cc * cc, axis=1)
        kk = min(k_num, ids.size - 1)
        for s in range(0, ids.size, 4096):
            e = min(s + 4096, ids.size)
            d = sq[s:e, None] - 2.0 * (cc[s:e] @ cc.T) + sq[None, :]
            d[np.arange(s, e) - s, np.arange(s, e)] = np.inf   # drop self
            np.maximum(d, 0.0, out=d)
            nn = np.argpartition(d, kk - 1, axis=1)[:, :kk]
            px_parts.append(np.repeat(ids[s:e], kk))
            id_parts.append(ids[nn].reshape(-1))
            d_parts.append(np.take_along_axis(d, nn, axis=1).reshape(-1))

    px = np.concatenate(px_parts) if px_parts else np.zeros(0, np.int64)
    nid = np.concatenate(id_parts) if id_parts else np.zeros(0, np.int64)
    dist = np.concatenate(d_parts) if d_parts else np.zeros(0)

    # dedup (pixel, id) keeping the smallest distance: sort by (px, id, d),
    # keep first of each (px, id) run; then rank by distance within each
    # pixel and keep the first k.
    o = np.lexsort((dist, nid, px))
    px, nid, dist = px[o], nid[o], dist[o]
    first = np.ones(px.size, bool)
    first[1:] = (px[1:] != px[:-1]) | (nid[1:] != nid[:-1])
    px, nid, dist = px[first], nid[first], dist[first]
    o = np.lexsort((dist, px))
    px, nid, dist = px[o], nid[o], dist[o]
    seg_start = np.ones(px.size, bool)
    seg_start[1:] = px[1:] != px[:-1]
    seg_first = np.maximum.accumulate(
        np.where(seg_start, np.arange(px.size), 0))
    rank = np.arange(px.size) - seg_first
    keep = rank < k_num
    px, nid, dist = px[keep], nid[keep], dist[keep]

    out_ids: list[np.ndarray] = [np.zeros(0, np.int32)] * n
    out_w: list[np.ndarray] = [np.zeros(0, np.float32)] * n
    wts = np.exp(1.0 - dist / 3.0)
    bounds = np.nonzero(
        np.concatenate([[True], px[1:] != px[:-1]]))[0] if px.size else []
    bounds = list(bounds) + [px.size]
    for bi in range(len(bounds) - 1):
        s, e = bounds[bi], bounds[bi + 1]
        out_ids[int(px[s])] = nid[s:e].astype(np.int32)
        out_w[int(px[s])] = wts[s:e].astype(np.float32)
    return out_ids, out_w


def graph_recall(
    got_ids: np.ndarray,
    got_w: np.ndarray,
    exact_ids: list[np.ndarray],
    exact_w: list[np.ndarray],
) -> tuple[float, float]:
    """(id recall, weight ratio) of a built graph vs the exact one.

    id recall    = mean over pixels of |got ∩ exact| / |exact|.  NOTE:
    unit-Lab colours are uint8-quantized, so exact-distance TIES are
    ubiquitous and any tie-break yields a weight-equivalent graph — id
    recall therefore UNDERSTATES fidelity and is reported for context
    only.
    weight ratio = sum of got weights / sum of exact weights per pixel,
    averaged.  The exact graph maximizes the weight sum (weights decay
    monotonically in distance and it keeps the k nearest), so this is in
    [0, 1] with 1.0 iff the built graph is distance-optimal — the
    tie-invariant fidelity metric the fence pins.
    """
    n = len(exact_ids)
    hit = 0.0
    cnt = 0
    ratio = 0.0
    for i in range(n):
        ex = exact_ids[i]
        if ex.size == 0:
            continue
        got = set(int(g) for g, wt in zip(got_ids[i], got_w[i]) if wt > 0)
        inset = np.asarray([int(e) in got for e in ex])
        hit += float(inset.mean())
        w_ex = float(exact_w[i].sum())
        w_got = float(np.asarray(got_w[i], np.float64).sum())
        ratio += min(w_got / max(w_ex, 1e-30), 1.0)
        cnt += 1
    return hit / max(cnt, 1), ratio / max(cnt, 1)
