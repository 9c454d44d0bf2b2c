"""Batch transfer over a geometry bucket (counterpart of
``nct_tpu/parallel/batch.py``).

The reference processes pairs.txt serially on one GPU (main.cu:471).  A
bucket of pairs that share (H, W), (Hs, Ws) and a BDS weight
(``parallel.bucket.group_pairs``) runs here as one call.  The scan mode is
the JAX package's ``lax.map``: the single-pair pipeline run over the
bucket in turn, each pair with its own seed, intermediates freed between
pairs.  The vmapped mode (batched stages) and the mesh (the ring-scheduled
matcher) are not ported yet.
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
    seed=seeds[i])``.

    ``mode``: ``"scan"`` (and ``"auto"`` without a mesh) runs the pairs in
    turn; ``"vmap"`` or a mesh raises NotImplementedError.
    """
    if mesh is not None or mode == "vmap":
        raise NotImplementedError(
            "batch transfer with mode='vmap' or a mesh needs the batched "
            "stages and the ring-scheduled matcher, which are not ported yet "
            "(ROADMAP Queue 1: 'Batched stages', then 'ring_nn / mesh / "
            "space_mesh')")
    if mode not in ("auto", "scan"):
        raise ValueError(f"mode={mode!r}")
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

    return scan
