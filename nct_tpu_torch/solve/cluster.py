"""Semantic clustering of deep features (port of ``nct_tpu/solve/cluster.py``).

Lloyd k-means with a fixed iteration count (empty clusters keep their
centre), the 4-neighbour dilated cluster membership, and the expansion of
the conv5_1 label grid to pixel grids.  The initial centre indices are an
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
    Returns (labels [N] int64, centers [K, C] float32)."""
    pts = points.float()
    centers = pts[init_idx.to(pts.device)]
    pts_sq = torch.sum(pts * pts, dim=1)

    def assign(centers):
        d = (pts_sq[:, None] - 2.0 * (pts @ centers.T)
             + torch.sum(centers * centers, dim=1))
        return torch.argmin(d, dim=1)

    for _ in range(iters):
        onehot = F.one_hot(assign(centers), num_clusters).float()
        sums = onehot.T @ pts                      # [K, C]
        counts = torch.sum(onehot, dim=0)          # [K]
        centers = torch.where(
            counts[:, None] > 0,
            sums / torch.clamp(counts, min=1.0)[:, None], centers)
    return assign(centers), centers


def cluster_membership(label_map: torch.Tensor,
                       num_clusters: int) -> torch.Tensor:
    """Per-cluster cell membership with 4-neighbour boundary dilation.
    label_map [lh, lw] -> bool [K, lh, lw]."""
    ks = torch.arange(num_clusters, device=label_map.device)
    m = label_map[None, :, :] == ks[:, None, None]
    p = F.pad(m, (1, 1, 1, 1))
    return (m | p[:, :-2, 1:-1] | p[:, 2:, 1:-1]
            | p[:, 1:-1, :-2] | p[:, 1:-1, 2:])


def _cells(n: int, stride: int, cells: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(n, device=device) // stride, 0, cells - 1)


def labels_for_pixels(label_map: torch.Tensor, h: int, w: int,
                      stride: int) -> torch.Tensor:
    """Expand the conv5_1-resolution label grid to an [h, w] label map:
    pixel (x, y) falls in cell (x // stride, y // stride), clipped."""
    lh, lw = label_map.shape
    ys = _cells(h, stride, lh, label_map.device)
    xs = _cells(w, stride, lw, label_map.device)
    return label_map[ys[:, None], xs[None, :]]


def membership_for_pixels(membership: torch.Tensor, h: int, w: int,
                          stride: int) -> torch.Tensor:
    """Expand [K, lh, lw] cell membership to [K, h, w] pixel membership."""
    _, lh, lw = membership.shape
    ys = _cells(h, stride, lh, membership.device)
    xs = _cells(w, stride, lw, membership.device)
    return membership[:, ys[:, None], xs[None, :]]
