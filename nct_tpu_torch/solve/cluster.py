"""Semantic clustering of deep features (port of ``nct_tpu/solve/cluster.py``).

Lloyd k-means with a fixed iteration count (empty clusters keep their
centre), the 4-neighbour dilated cluster membership, and the expansion of
the conv5_1 label grid to pixel grids (primary cluster, dilated membership,
or a list of up to P memberships).  The initial centre indices are an
argument: the JAX package draws them with ``jax.random.choice``, which
torch cannot reproduce, so callers draw them (``draw_kmeans_init``) or
inject the JAX package's draw.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def draw_kmeans_init(n: int, num_clusters: int,
                     generator: torch.Generator) -> torch.Tensor:
    """Initial centre indices: without replacement unless n < num_clusters."""
    if n < num_clusters:
        return torch.randint(0, n, (num_clusters,), generator=generator)
    return torch.randperm(n, generator=generator)[:num_clusters]


def kmeans(points: torch.Tensor, init_idx: torch.Tensor,
           num_clusters: int = 10, iters: int = 11):
    """Lloyd k-means.  points [N, C]; init_idx [num_clusters] point indices.
    Returns (labels [N] int64, centers [K, C] float32).  Batched: points
    [B, N, C] and init_idx [B, K], each item clustered on its own through
    batched products."""
    pts = points.float()
    init_idx = init_idx.to(pts.device)
    if pts.dim() == 3:
        centers = torch.gather(
            pts, 1, init_idx[..., None].expand(-1, -1, pts.shape[-1]))
    else:
        centers = pts[init_idx]
    pts_sq = torch.sum(pts * pts, dim=-1)

    def assign(centers):
        d = (pts_sq[..., None] - 2.0 * (pts @ centers.transpose(-1, -2))
             + torch.sum(centers * centers, dim=-1)[..., None, :])
        return torch.argmin(d, dim=-1)

    for _ in range(iters):
        onehot = F.one_hot(assign(centers), num_clusters).float()
        sums = onehot.transpose(-1, -2) @ pts      # [K, C]
        counts = torch.sum(onehot, dim=-2)         # [K]
        centers = torch.where(
            counts[..., None] > 0,
            sums / torch.clamp(counts, min=1.0)[..., None], centers)
    return assign(centers), centers


def cluster_membership(label_map: torch.Tensor,
                       num_clusters: int) -> torch.Tensor:
    """Per-cluster cell membership with 4-neighbour boundary dilation.
    label_map [..., lh, lw] -> bool [..., K, lh, lw]."""
    ks = torch.arange(num_clusters, device=label_map.device)
    m = label_map[..., None, :, :] == ks[:, None, None]
    p = F.pad(m, (1, 1, 1, 1))
    return (m | p[..., :-2, 1:-1] | p[..., 2:, 1:-1]
            | p[..., 1:-1, :-2] | p[..., 1:-1, 2:])


def _cells(n: int, stride: int, cells: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(n, device=device) // stride, 0, cells - 1)


def labels_for_pixels(label_map: torch.Tensor, h: int, w: int,
                      stride: int, rows: tuple[int, int] | None = None
                      ) -> torch.Tensor:
    """Expand the conv5_1-resolution label grid [..., lh, lw] to an [...,
    h, w] label map: pixel (x, y) falls in cell (x // stride, y // stride),
    clipped.  ``rows`` = (y0, y1): only those rows (a band)."""
    lh, lw = label_map.shape[-2], label_map.shape[-1]
    ys = _cells(h, stride, lh, label_map.device)
    if rows is not None:
        ys = ys[rows[0]:rows[1]]
    xs = _cells(w, stride, lw, label_map.device)
    return label_map[..., ys[:, None], xs[None, :]]


def membership_for_pixels(membership: torch.Tensor, h: int, w: int,
                          stride: int) -> torch.Tensor:
    """Expand [..., K, lh, lw] cell membership to [..., K, h, w] pixel
    membership."""
    lh, lw = membership.shape[-2], membership.shape[-1]
    ys = _cells(h, stride, lh, membership.device)
    xs = _cells(w, stride, lw, membership.device)
    return membership[..., ys[:, None], xs[None, :]]


def multi_labels_for_pixels(label_map: torch.Tensor, membership: torch.Tensor,
                            h: int, w: int, stride: int,
                            num_memberships: int,
                            rows: tuple[int, int] | None = None
                            ) -> torch.Tensor:
    """Per-pixel list of up to P cluster memberships, primary first:
    int64 [h, w, min(P, K)] (label_map [lh, lw], membership [K, lh, lw]);
    with a leading batch axis on both, [B, h, w, min(P, K)], each item
    ranked on its own scores.  ``rows`` = (y0, y1): only those rows (a
    band), as ``labels_for_pixels`` takes them.

    Cell scores are 2 for the primary cluster, 1 for a dilated member and 0
    otherwise; the P best are taken stably (equal scores keep the lower
    cluster first, as ``lax.top_k`` does), and a non-member pick repeats
    the primary cluster (its duplicate candidates are deduplicated by
    ``knn_graph``).
    """
    k = membership.shape[-3]
    ks = torch.arange(k, device=label_map.device)
    primary = label_map[..., None, :, :] == ks[:, None, None]
    score = (membership.long() + primary.long()).movedim(-3, -1)
    order = torch.argsort(score, dim=-1, descending=True,
                          stable=True)[..., :min(num_memberships, k)]
    got = torch.gather(score, -1, order)
    cells = torch.where(got > 0, order, order[..., :1])
    lh, lw = label_map.shape[-2], label_map.shape[-1]
    ys = _cells(h, stride, lh, label_map.device)
    if rows is not None:
        ys = ys[rows[0]:rows[1]]
    xs = _cells(w, stride, lw, label_map.device)
    return cells[..., ys[:, None], xs[None, :], :]
