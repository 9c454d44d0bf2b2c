"""k-NN graph over Lab colours within semantic clusters (port of
``nct_tpu/solve/knn.py``, single-membership path).

For every down-res pixel: the k=8 nearest *other* pixels among its
cluster's M sampled candidates in unit-Lab colour (squared L2), weighted
``exp(1 - d / 3)``.  Pixels are grouped by cluster (stable sort), so each
chunk scores one cluster's candidate table; results land back in pixel
order with one un-permute.

As in the JAX package: duplicate candidate ids are masked to their first
occurrence, the k extractions rank on **bf16** keys (first minimum on
ties), and the winners' exact f32 distances are recomputed for the weights.
"""

from __future__ import annotations

import torch


def sample_cluster_candidates(membership_pix: torch.Tensor,
                              scores: torch.Tensor,
                              max_candidates: int) -> torch.Tensor:
    """Up to M member pixel ids per cluster: the top-M members by ``scores``.

    membership_pix: bool [K, H, W]; scores: [K, H*W] in [0, 1) (uniform
    draws).  Returns int64 [K, M] flat pixel ids; clusters with fewer than
    M members repeat their first member.
    """
    k = membership_pix.shape[0]
    m = membership_pix.reshape(k, -1)
    score = torch.where(m, scores.to(m.device), -1.0)
    top, idx = torch.topk(score, max_candidates, dim=1)
    return torch.where(top >= 0.0, idx, idx[:, :1])


def knn_graph(
    lab_unit: torch.Tensor,
    pixel_labels: torch.Tensor,
    candidates: torch.Tensor,
    k_num: int = 8,
    chunk: int = 8192,
):
    """Build the nonlocal k-NN graph.

    lab_unit [H, W, 3] unit-domain Lab; pixel_labels [H, W] primary cluster
    per pixel; candidates [K, M] flat pixel ids per cluster.  Returns
    (ids [N, k] int64, weights [N, k] f32, slots [N, k] int64), N = H*W;
    ``slots`` index the flattened [K*M] candidate table.
    """
    h, w, _ = lab_unit.shape
    n = h * w
    dev = lab_unit.device
    colors = lab_unit.reshape(n, 3).float()
    labels = pixel_labels.reshape(n).long()
    candidates = candidates.long().to(dev)
    kc, m = candidates.shape

    order = torch.argsort(labels, stable=True)        # groups clusters
    counts = torch.bincount(labels, minlength=kc).tolist()

    cand_colors = colors[candidates]                   # [K, M, 3]
    cand_sq = torch.sum(cand_colors * cand_colors, dim=-1)

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
            cross = (qc[:, 0:1] * cc[:, 0] + qc[:, 1:2] * cc[:, 1]
                     + qc[:, 2:3] * cc[:, 2])                      # [B, M]
            q_sq = torch.sum(qc * qc, dim=-1)
            d = torch.clamp(csq[None, :] - 2.0 * cross + q_sq[:, None],
                            min=0.0)
            d = torch.where(cand_ids[None, :] == pid[:, None], inf, d)
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
            ncol = colors[ids]                                     # [B, k, 3]
            dists = torch.clamp(
                torch.sum((qc[:, None, :] - ncol) ** 2, dim=-1), min=0.0)
            alive = torch.arange(k_num, device=dev)[None, :] < nfin[:, None]
            ids_o[pid] = ids
            w_o[pid] = torch.where(alive, torch.exp(1.0 - dists / 3.0), 0.0)
            s_o[pid] = c * m + j
        start += cnt
    return ids_o, w_o, s_o
