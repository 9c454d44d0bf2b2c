"""Batch transfer over a geometry bucket (counterpart of
``nct_tpu/parallel/batch.py``).

The reference processes pairs.txt serially on one GPU (main.cu:471).  A
bucket of pairs that share (H, W), (Hs, Ws) and a BDS weight
(``parallel.bucket.group_pairs``) runs here as one call:

  * ``mode="scan"`` is the JAX package's ``lax.map``: the single-pair
    pipeline over the bucket in turn, each pair with its own seed,
    intermediates freed between pairs.  It runs every Config.
  * ``mode="vmap"`` is its ``jax.vmap``: one batched pass of the pipeline
    (``pipeline.transfer_batch``), every stage over [B, ...] tensors, so
    the bucket pays about one pair's kernel launches and host syncs.  It
    runs every Config that ``pipeline.check_config`` accepts.

``mode="auto"`` is scan, as in the JAX package without a mesh.  A mesh (the
ring-scheduled matcher over several cards) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from nct_tpu_torch import pipeline
from nct_tpu_torch.config import Config


def make_batch_transfer(config: Config, mesh=None, mode: str = "auto",
                        device: torch.device | str | None = None):
    """Build a batched transfer fn.

    Returns fn(model, cnt_b [B,H,W,3] u8, stl_b [B,Hs,Ws,3] u8, seeds [B],
    bds_weight) -> [B,H,W,3] u8 on ``device`` (default ``cuda``; raises
    here without a card unless ``device="cpu"``).  Item i is
    ``pipeline.transfer_pair(model, cnt_b[i], stl_b[i], bds_weight, config,
    seed=seeds[i])``: bitwise in the scan mode, up to summation order (with
    the same solver iteration counts) in the vmap mode.

    ``mode``: ``"scan"`` (and ``"auto"``) runs the pairs in turn; ``"vmap"``
    runs them as one batched pass, for every Config the single pair runs
    (``space_mesh`` raises NotImplementedError here).  A mesh raises
    NotImplementedError.
    """
    if mesh is not None:
        raise NotImplementedError(
            "batch transfer over a mesh needs the ring-scheduled matcher, "
            "which is not ported yet (ROADMAP Queue 1: 'ring_nn / mesh / "
            "space_mesh')")
    if mode not in ("auto", "scan", "vmap"):
        raise ValueError(f"mode={mode!r}")
    if mode == "vmap":
        pipeline.check_config(config)
    device = pipeline._resolve_device(device)

    def scan(model, cnt_b, stl_b, seeds, bds_weight: float) -> torch.Tensor:
        seeds = np.asarray(seeds.cpu() if isinstance(seeds, torch.Tensor)
                           else seeds).reshape(-1)
        if not len(cnt_b) == len(stl_b) == len(seeds):
            raise ValueError(f"batch sizes differ: {len(cnt_b)} content, "
                             f"{len(stl_b)} style, {len(seeds)} seeds")
        return torch.stack([
            pipeline.transfer_pair(model, cnt_b[i], stl_b[i], bds_weight,
                                   config, seed=int(seeds[i]), device=device)
            for i in range(len(seeds))])

    def vmap(model, cnt_b, stl_b, seeds, bds_weight: float) -> torch.Tensor:
        return pipeline.transfer_batch(model, cnt_b, stl_b, bds_weight,
                                       config, seeds, device=device)

    return vmap if mode == "vmap" else scan
