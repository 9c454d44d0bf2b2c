"""Rank functions of ``tests/test_torch_space_shard_short.py``: row bands
of zero rows (images with fewer 16-row units than space ranks), run by
``parallel.mesh.launch`` in spawned gloo ranks on the CPU.

A spawned rank imports the module of its function, so this module imports
no JAX.  Each rank gets numpy inputs (the VGG weights as the path of an
npz file: spawn pickles every argument once per rank) and returns CPU or
numpy results; the parent holds them against the single process and JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nct_tpu_torch import pipeline
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.parallel.batch import make_batch_transfer
from nct_tpu_torch.parallel.mesh import RowBand, image_bands, make_mesh
from nct_tpu_torch.parallel.ring_nn import ring_exact_nn

from torch_mesh_workers import TINY, TINY_PM, plain_convolutions, tiny_pairs
from torch_shard_pm_workers import ReplayDraws

AXIS = "space"
# (above, below) halo counts: one row, a reach past a 4-row neighbour,
# and one side only
HALOS = ((1, 1), (6, 5), (0, 9))
# (h, unit) of the grids whose bands hold zero rows at the trailing ranks
BAND_GRIDS = {3: (5, 4), 8: (20, 4)}
# the ring's features: fewer rows than ranks on both sides at 8 ranks
RING_HW = {3: ((2, 11), (7, 5)), 8: ((5, 7), (3, 9))}
# the pairs: the JAX test's 64x48 over 8 ranks (4 units), 32 rows over 3
PAIR_HW = {8: (64, 48, 64, 48), 3: (32, 48, 36, 52)}


def band_primitives(mesh) -> dict:
    """``RowBand``'s exchanges on a grid whose trailing bands are empty:
    each halo of ``HALOS`` (extended rows, rows added), the gather, the
    rank-order sum, an exchange of variable-size parts and the coarsened
    bands; a rank's data is its rows of ``arange`` (its values known to
    every rank)."""
    n = mesh.shape[AXIS]
    h, unit = BAND_GRIDS[n]
    bounds = image_bands(h, n, unit)
    band = RowBand(mesh, AXIS, tuple(bounds[:-1]), h)
    whole = torch.arange(h * 3 * 2, dtype=torch.float32).reshape(h, 3, 2)
    mine = band.take(whole)
    out = {"bounds": bounds, "rows": band.rows, "halo": []}
    for above, below in HALOS:
        ext, top, bottom = band.halo(mine, above, below)
        out["halo"].append((ext, top, bottom))
    out["gather"] = band.gather(mine)
    out["gather_map"] = band.gather(mine[..., 0], -2)
    r = band.r
    out["sum"] = band.reduce_sum(torch.full((4,), 0.1 * (r + 1)))
    out["min"] = band.reduce(torch.tensor([float(band.rows) - r]), "min")
    # rank r sends r + j rows of value 100 r + j to rank j
    parts = [torch.full((r + j, 2), 100.0 * r + j) for j in range(n)]
    out["exchange"] = band.exchange(parts)
    out["coarsen"] = []
    b = band
    while b is not None and b.h > 1:
        b = b.coarsen()
        out["coarsen"].append(None if b is None else (b.starts, b.h))
    return out


def rings(mesh, inp: dict) -> dict:
    """``ring_exact_nn`` over the mesh for each case of ``inp["ring"]``
    (fewer image rows than ranks on one side or both)."""
    return {name: tuple(t.numpy() for t in ring_exact_nn(
        torch.from_numpy(a), torch.from_numpy(b), mesh))
        for name, (a, b) in inp["ring"].items()}


def _pair(model, mesh, config, cnt, stl, **kw):
    config = dataclasses.replace(config, space_mesh=mesh)
    out, trace = pipeline.transfer_pair(model, cnt, stl, 2.0, config,
                                        return_intermediates="stats", **kw)
    return out.numpy(), [(int(t["nl_iters"]), int(t["wls_iters"]))
                         for t in trace]


def pairs(mesh, inp: dict) -> dict:
    """The pairs of this world's geometry: over 8 ranks the TINY pair with
    JAX's draws replayed and the seeded bucket of one through
    ``make_batch_transfer``; over 3 ranks TINY and TINY_PM, seeded."""
    n = mesh.shape[AXIS]
    model = vgg19.load_params(inp["vgg"])
    cnt, stl, seeds = tiny_pairs(1, *PAIR_HW[n])
    out = {"row_sharded": pipeline.row_sharded(
        dataclasses.replace(TINY, space_mesh=mesh))}
    if n == 8:
        out["pair"] = _pair(model, mesh, TINY, cnt[0], stl[0],
                            draws=ReplayDraws([inp["draws"]]))
        out["bucket"] = make_batch_transfer(TINY, mesh)(
            model, cnt, stl, seeds, 2.0).numpy()
    else:
        out["pair"] = _pair(model, mesh, TINY, cnt[0], stl[0], seed=seeds[0])
        out["pair_pm"] = _pair(model, mesh, TINY_PM, cnt[0], stl[0],
                               seed=seeds[0])
    return out


def short_world(n: int, inp: dict) -> dict:
    """Every case of one world of ``n`` ranks over a 1 x n space mesh
    (oneDNN off, so the pairs are bitwise the single process's)."""
    plain_convolutions()
    mesh = make_mesh(n_data=1, n_space=n, device="cpu")
    return {"rank": mesh.index(AXIS), "bands": band_primitives(mesh),
            "ring": rings(mesh, inp), "pipeline": pairs(mesh, inp)}
