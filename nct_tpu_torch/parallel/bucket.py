"""Geometry bucketing for pairs.txt batches (a numpy-only copy of
``nct_tpu/parallel/bucket.py``).

Pairs are grouped into buckets whose members share a padded (H, W) /
(Hs, Ws) and a BDS weight, so a bucket stacks into one batch
(``parallel.batch``).  Padding uses edge replication so the pad region is
self-similar and the crop back to true size is exact.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np


def bucket_dims(h: int, w: int, quantum: int = 64) -> tuple[int, int]:
    """Round dims up to the bucket quantum (64 keeps pads <10% at 700 px)."""
    q = quantum
    return (-(-h // q) * q, -(-w // q) * q)


def pad_to(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Edge-replicate pad an [H, W, C] image to [h, w, C]."""
    ph, pw = h - img.shape[0], w - img.shape[1]
    assert ph >= 0 and pw >= 0
    return np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")


@dataclass(frozen=True)
class BucketKey:
    cnt_hw: tuple[int, int]
    stl_hw: tuple[int, int]
    bds_weight: float


def group_pairs(
    items: list[tuple[np.ndarray, np.ndarray, float]],
    quantum: int = 64,
):
    """Group (cnt, stl, bds) triples into geometry buckets.

    Returns {BucketKey: [(orig_index, cnt_padded, stl_padded,
    true_cnt_hw), ...]}; callers stack each bucket, run the batched
    transfer once per bucket, and crop outputs back to true_cnt_hw.
    """
    buckets: dict[BucketKey, list] = collections.defaultdict(list)
    for i, (cnt, stl, bds) in enumerate(items):
        ch, cw = bucket_dims(cnt.shape[0], cnt.shape[1], quantum)
        sh, sw = bucket_dims(stl.shape[0], stl.shape[1], quantum)
        key = BucketKey((ch, cw), (sh, sw), float(bds))
        buckets[key].append(
            (i, pad_to(cnt, ch, cw), pad_to(stl, sh, sw), cnt.shape[:2])
        )
    return dict(buckets)
