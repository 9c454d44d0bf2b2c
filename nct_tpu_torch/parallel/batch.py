"""Batch transfer over a geometry bucket, on one card or over a mesh
(counterpart of ``nct_tpu/parallel/batch.py``).

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

Over a ``parallel.mesh.Mesh`` (SPMD: every rank calls the returned
function with the whole bucket) the bucket splits by items over the data
axis, each data row runs its items as one vmap pass, and the results are
gathered so that every rank returns the whole bucket, like JAX's global
array.  The space axis splits each pair by rows (``pipeline.row_sharded``:
every stage on row bands, any membership count, the exact levels through
the ring over the bands; a short image leaves the trailing ranks empty
bands); the scatter transpose keeps the replicated stages with the ring
at the exact levels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nct_tpu_torch import pipeline
from nct_tpu_torch.config import Config
from nct_tpu_torch.parallel.mesh import Mesh


def make_batch_transfer(config: Config, mesh: Mesh | None = None,
                        mode: str = "auto",
                        device: torch.device | str | None = None,
                        ring_nn: bool = True):
    """Build a batched transfer fn.

    Returns fn(model, cnt_b [B,H,W,3] u8, stl_b [B,Hs,Ws,3] u8, seeds [B],
    bds_weight) -> [B,H,W,3] u8 on ``device`` (default: the mesh's device,
    else ``cuda``; raises without a card unless ``device="cpu"``).  Item i
    is ``pipeline.transfer_pair(model, cnt_b[i], stl_b[i], bds_weight,
    config, seed=seeds[i])``: bitwise in the scan mode, up to summation
    order (with the same solver iteration counts) in the vmap mode.

    ``mode``: ``"scan"`` runs the pairs in turn; ``"vmap"`` runs them as
    one batched pass, for every Config the single pair runs; ``"auto"`` is
    scan without a mesh and vmap with one.  A mesh takes the vmap mode
    only.  Over a mesh, B must divide by the data axis's size
    (ValueError), and under space sharding the VGG forward runs in float32
    (the JAX package's rule, from an XLA partitioner fault with row-sharded
    bf16 convolutions; the port keeps it so its output is the JAX mesh
    path's).  ``ring_nn``: the exact levels search through the ring over the
    space axis; False has every space rank search the whole (gathered)
    levels itself with ``nn_bidir`` and keep its bands of the fields (the
    JAX auto-partitioned matcher's replication).
    """
    if mode not in ("auto", "scan", "vmap"):
        raise ValueError(f"mode={mode!r}")
    if mesh is not None and not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must be a parallel.mesh.Mesh, got "
                         f"{type(mesh).__name__}")
    if mode == "auto":
        mode = "scan" if mesh is None else "vmap"
    if mesh is not None and mode == "scan":
        raise ValueError("the scan mode runs on one card; a mesh takes "
                         "mode='vmap'")
    if mesh is not None and mesh.shape["space"] > 1:
        config = dataclasses.replace(config, vgg_compute_dtype="float32",
                                     space_mesh=mesh)
    if mode == "vmap":
        pipeline.check_config(config)
    if device is None and mesh is not None:
        device = mesh.device
    device = pipeline._resolve_device(device)

    def scan(model, cnt_b, stl_b, seeds, bds_weight: float) -> torch.Tensor:
        seeds = _seeds(seeds)
        _check_sizes(cnt_b, stl_b, seeds)
        return torch.stack([
            pipeline.transfer_pair(model, cnt_b[i], stl_b[i], bds_weight,
                                   config, seed=int(seeds[i]), device=device)
            for i in range(len(seeds))])

    def vmap(model, cnt_b, stl_b, seeds, bds_weight: float) -> torch.Tensor:
        if mesh is None:
            return pipeline.transfer_batch(model, cnt_b, stl_b, bds_weight,
                                           config, seeds, device=device)
        seeds = _seeds(seeds)
        n_data = mesh.shape["data"]
        _check_sizes(cnt_b, stl_b, seeds)
        if len(seeds) % n_data:
            raise ValueError(f"a bucket of {len(seeds)} pairs does not split "
                             f"over {n_data} data rows")
        per = len(seeds) // n_data
        rows = slice(mesh.index("data") * per, (mesh.index("data") + 1) * per)
        out = pipeline.transfer_batch(model, cnt_b[rows], stl_b[rows],
                                      bds_weight, config, seeds[rows],
                                      device=device, ring_nn=ring_nn)
        return mesh.gather(out, "data", 0)

    return vmap if mode == "vmap" else scan


def _seeds(seeds) -> np.ndarray:
    return np.asarray(seeds.cpu() if isinstance(seeds, torch.Tensor)
                      else seeds).reshape(-1)


def _check_sizes(cnt_b, stl_b, seeds) -> None:
    if not len(cnt_b) == len(stl_b) == len(seeds):
        raise ValueError(f"batch sizes differ: {len(cnt_b)} content, "
                         f"{len(stl_b)} style, {len(seeds)} seeds")
