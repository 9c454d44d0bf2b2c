"""k-NN graph over Lab colours within semantic clusters (port of
``nct_tpu/solve/knn.py``).

For every down-res pixel: the k=8 nearest *other* pixels among its
cluster's M sampled candidates in unit-Lab colour (squared L2), weighted
``exp(1 - d / 3)``.

Single membership ([H, W] labels): pixels are grouped by cluster (stable
sort), so each chunk scores one cluster's candidate table; results land
back in pixel order with one un-permute.  As in the JAX package, duplicate
candidate ids are masked to their first occurrence, the k extractions rank
on **bf16** keys (first minimum on ties), and the winners' exact f32
distances are recomputed for the weights.

Several memberships ([H, W, P] labels, P > 1): each pixel scores the union
of its P clusters' candidate tables and keeps the k best, ranked on the
**f32** distances (first minimum on ties); every slot holding a selected id
is masked before the next pick, which deduplicates ids across memberships
and repeats.

Both paths round every 3-term sum, the weights' distances and
``exp(1 - d / 3)`` as XLA's CPU backend does (``ops/fmath``), so the graph
is bitwise the JAX package's, and the card's is bitwise the CPU's.
"""

from __future__ import annotations

import torch

from nct_tpu_torch.ops.fmath import dot3_fma, knn_weight


def sample_cluster_candidates(membership_pix: torch.Tensor,
                              scores: torch.Tensor,
                              max_candidates: int) -> torch.Tensor:
    """Up to M member pixel ids per cluster: the top-M members by ``scores``.

    membership_pix: bool [K, H, W]; scores: [K, H*W] in [0, 1) (uniform
    draws).  Returns int64 [K, M] flat pixel ids; clusters with fewer than
    M members repeat their first member.  Leading batch axes pass through.
    """
    m = membership_pix.reshape(membership_pix.shape[:-2] + (-1,))
    score = torch.where(m, scores.to(m.device), -1.0)
    top, idx = torch.topk(score, max_candidates, dim=-1)
    return torch.where(top >= 0.0, idx, idx[..., :1])


def knn_graph(
    lab_unit: torch.Tensor,
    pixel_labels: torch.Tensor,
    candidates: torch.Tensor,
    k_num: int = 8,
    chunk: int = 8192,
    cand_colors: torch.Tensor | None = None,
    row0: int = 0,
    n_total: int | None = None,
):
    """Build the nonlocal k-NN graph.

    lab_unit [H, W, 3] unit-domain Lab; pixel_labels [H, W] primary cluster
    per pixel, or [H, W, P] memberships (``cluster.multi_labels_for_pixels``);
    candidates [K, M] flat pixel ids per cluster.  Returns (ids [N, k]
    int64, weights [N, k] f32, slots [N, k] int64), N = H*W; ``slots`` index
    the flattened [K*M] candidate table.  ``chunk`` query rows are scored at
    a time.

    Batched (lab_unit [B, H, W, 3], pixel_labels [B, H, W] or [B, H, W,
    P], candidates [B, K, M]): the bucket folds into the row axis as one
    graph whose clusters are disjoint across items (labels offset by i*K,
    candidate ids by i*N), so each item's rows, chunks and picks are its
    own and the result, [B, N, k] with item-local ids and slots, is
    bitwise each item's own graph; one host sync for the whole bucket.
    The P > 1 merge scores every row on its own, so its fold is bitwise by
    construction (the JAX package vmaps it plainly, with the same result).

    A band of rows (under a space mesh, either membership count):
    ``lab_unit`` and ``pixel_labels`` hold the band's rows, ``row0`` is the
    flat index of its first pixel in the whole level (ids stay global) and
    ``cand_colors`` [..., K, M, 3] the candidates' colours, gathered from
    the ranks that hold them, and ``n_total`` the level's pixels.  Every
    row is scored on its own (a pixel is never its own neighbour: the
    query ids are global), so the band's rows are the whole graph's rows
    bit for bit.
    """
    if lab_unit.dim() == 4:
        return _knn_graph_folded(lab_unit, pixel_labels, candidates, k_num,
                                 chunk, cand_colors, row0, n_total)
    h, w, _ = lab_unit.shape
    n = h * w
    colors = lab_unit.reshape(n, 3).float()
    candidates = candidates.long().to(lab_unit.device)
    gid = torch.arange(row0, row0 + n, device=colors.device)
    if pixel_labels.dim() == 3 and pixel_labels.shape[-1] > 1:
        labels = pixel_labels.reshape(n, pixel_labels.shape[-1]).long()
        return _knn_graph_multi(colors, labels, candidates, k_num, chunk,
                                gid, cand_colors)
    return _knn_graph_sorted(colors, pixel_labels.reshape(n).long(),
                             candidates, k_num, chunk, gid, cand_colors)


def _knn_graph_sorted(colors: torch.Tensor, labels: torch.Tensor,
                      candidates: torch.Tensor, k_num: int, chunk: int,
                      gid: torch.Tensor, cand_colors: torch.Tensor | None):
    """Single-membership graph: colors [N, 3], labels [N], candidates [K,
    M] int64 ids of the rows' ``gid`` numbering, ``cand_colors`` their
    colours (None: ``colors[candidates]``); pixels grouped by cluster, one
    chunk per cluster slice."""
    n = colors.shape[0]
    dev = colors.device
    kc, m = candidates.shape

    order = torch.argsort(labels, stable=True)        # groups clusters
    counts = torch.bincount(labels, minlength=kc).tolist()

    if cand_colors is None:
        cand_colors = colors[candidates]               # [K, M, 3]
    cand_sq = dot3_fma(cand_colors, cand_colors)

    # first occurrence of each candidate id within its cluster row
    cid_ord = torch.argsort(candidates, dim=1, stable=True)
    cid_sorted = torch.gather(candidates, 1, cid_ord)
    is_first_sorted = torch.cat(
        [torch.ones((kc, 1), dtype=torch.bool, device=dev),
         cid_sorted[:, 1:] != cid_sorted[:, :-1]], dim=1)
    first_mask = torch.zeros((kc, m), dtype=torch.bool, device=dev)
    first_mask.scatter_(1, cid_ord, is_first_sorted)

    ids_o = torch.empty((n, k_num), dtype=torch.int64, device=dev)
    w_o = torch.empty((n, k_num), dtype=torch.float32, device=dev)
    s_o = torch.empty((n, k_num), dtype=torch.int64, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    cols = torch.arange(m, device=dev)
    start = 0
    for c, cnt in enumerate(counts):
        cand_ids, cc, csq = candidates[c], cand_colors[c], cand_sq[c]
        for s0 in range(start, start + cnt, chunk):
            pid = order[s0:min(s0 + chunk, start + cnt)]
            qc = colors[pid]                                       # [B, 3]
            cross = dot3_fma(qc[:, None, :], cc[None, :, :])       # [B, M]
            d = torch.clamp(csq[None, :] - 2.0 * cross
                            + dot3_fma(qc, qc)[:, None], min=0.0)
            d = torch.where(cand_ids[None, :] == gid[pid][:, None], inf, d)
            d = torch.where(first_mask[c][None, :], d, inf)
            nfin = torch.sum(torch.isfinite(d), dim=1)
            work = d.to(torch.bfloat16)
            picks = []
            for _ in range(k_num):
                j = torch.argmin(work, dim=1)
                picks.append(j)
                work = torch.where(cols[None, :] == j[:, None],
                                   float("inf"), work)
            j = torch.stack(picks, dim=1)                          # [B, k]
            ids = cand_ids[j]
            diff = qc[:, None, :] - cc[j]                          # [B, k, 3]
            dists = torch.clamp(dot3_fma(diff, diff), min=0.0)
            alive = torch.arange(k_num, device=dev)[None, :] < nfin[:, None]
            ids_o[pid] = ids
            w_o[pid] = torch.where(alive, knn_weight(dists), 0.0)
            s_o[pid] = c * m + j
        start += cnt
    return ids_o, w_o, s_o


def _knn_graph_folded(lab_unit: torch.Tensor, pixel_labels: torch.Tensor,
                      candidates: torch.Tensor, k_num: int, chunk: int,
                      cand_colors: torch.Tensor | None = None,
                      row0: int = 0, n_total: int | None = None):
    """The batch folded into rows (counterpart of the JAX package's
    ``_knn_custom_vmap`` rule, ``nct_tpu/solve/knn.py:180-213``); a band's
    rows keep their global ids (see ``knn_graph``)."""
    b, h, w, _ = lab_unit.shape
    n = h * w
    dev = lab_unit.device
    n_ids = n if n_total is None else n_total
    kc, m = candidates.shape[-2], candidates.shape[-1]
    boff = torch.arange(b, device=dev)[:, None]
    multi = pixel_labels.dim() == 4 and pixel_labels.shape[-1] > 1
    p = pixel_labels.shape[-1] if multi else 1
    labels = (pixel_labels.reshape(b, n, p).long()
              + boff[..., None] * kc).reshape(b * n, p)
    cands = (candidates.long().to(dev)
             + boff[..., None] * n_ids).reshape(b * kc, m)
    colors = lab_unit.reshape(b * n, 3).float()
    gid = (boff * n_ids + row0
           + torch.arange(n, device=dev)[None, :]).reshape(-1)
    if cand_colors is not None:
        cand_colors = cand_colors.reshape(b * kc, m, 3)
    if multi:
        ids, wts, slots = _knn_graph_multi(colors, labels, cands, k_num,
                                           chunk, gid, cand_colors)
    else:
        ids, wts, slots = _knn_graph_sorted(colors, labels.reshape(-1),
                                            cands, k_num, chunk, gid,
                                            cand_colors)
    return (ids.reshape(b, n, k_num) - boff[..., None] * n_ids,
            wts.reshape(b, n, k_num),
            slots.reshape(b, n, k_num) - boff[..., None] * (kc * m))


def _knn_graph_multi(colors: torch.Tensor, labels: torch.Tensor,
                     candidates: torch.Tensor, k_num: int, chunk: int,
                     gid: torch.Tensor, cand_colors: torch.Tensor | None):
    """Multi-membership graph: colors [N, 3], labels [N, P], candidates
    [K, M] int64 ids of the rows' ``gid`` numbering, ``cand_colors`` their
    colours (None: ``colors[candidates]``).  Every row is scored on its
    own, so the result does not depend on ``chunk``."""
    n, p = labels.shape
    dev = colors.device
    m = candidates.shape[1]
    if cand_colors is None:
        cand_colors = colors[candidates]               # [K, M, 3]
    cand_sq = dot3_fma(cand_colors, cand_colors)
    ids_o = torch.empty((n, k_num), dtype=torch.int64, device=dev)
    w_o = torch.empty((n, k_num), dtype=torch.float32, device=dev)
    s_o = torch.empty((n, k_num), dtype=torch.int64, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for s0 in range(0, n, chunk):
        ql = labels[s0:s0 + chunk]                                 # [B, P]
        b = ql.shape[0]
        qi = gid[s0:s0 + b]
        qc = colors[s0:s0 + b]                                     # [B, 3]
        cand_ids = candidates[ql].reshape(b, p * m)
        cross = dot3_fma(qc[:, None, :],
                         cand_colors[ql].reshape(b, p * m, 3))     # [B, P*M]
        work = torch.clamp(cand_sq[ql].reshape(b, p * m) - 2.0 * cross
                           + dot3_fma(qc, qc)[:, None], min=0.0)
        work = torch.where(cand_ids == qi[:, None], inf, work)
        picks, dists, slots = [], [], []
        for _ in range(k_num):
            j = torch.argmin(work, dim=1, keepdim=True)            # first min
            cid = torch.gather(cand_ids, 1, j)
            picks.append(cid[:, 0])
            dists.append(torch.gather(work, 1, j)[:, 0])
            # slot: the owning membership's cluster * M + offset
            owner = torch.gather(ql, 1, j // m)[:, 0]
            slots.append(owner * m + j[:, 0] % m)
            work = torch.where(cand_ids == cid, inf, work)
        d = torch.stack(dists, dim=1)
        ids_o[s0:s0 + b] = torch.stack(picks, dim=1)
        w_o[s0:s0 + b] = torch.where(torch.isfinite(d), knn_weight(d), 0.0)
        s_o[s0:s0 + b] = torch.stack(slots, dim=1)
    return ids_o, w_o, s_o
