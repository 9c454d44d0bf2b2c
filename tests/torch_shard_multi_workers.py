"""Rank functions of ``tests/test_torch_space_shard.py``'s several-membership
part: the P > 1 k-NN merge on row bands, run in the spawned gloo ranks of
``torch_shard_world_workers.world`` on the CPU.

A spawned rank imports the module of its function, so this module imports
no JAX.  Each rank gets numpy inputs and the world's VGG models (read once
from npz files) and returns its results gathered whole, as numpy or CPU
tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nct_tpu_torch import pipeline
from nct_tpu_torch.parallel.batch import make_batch_transfer
from nct_tpu_torch.parallel.mesh import RowBand, image_bands
from nct_tpu_torch.solve import nonlocal_solve

from torch_mesh_workers import TINY_P2, tiny_pairs
from torch_shard_workers import ReplayDraws

AXIS = "space"
PAIR_HW = (40, 48, 44, 52)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def nonlocal_cases(mesh, inp: dict) -> dict:
    """The band operator of a P = 2 graph (slots of both memberships,
    ``in_cap`` low enough that the widest slots are capped across bands),
    applied once, and its solve at 6 fixed iterations; gathered whole."""
    src, ref, conf = (_t(inp[k]) for k in ("src", "ref", "conf"))
    ids, wts, slots = (_t(inp[k]) for k in ("ids", "wts", "slots"))
    h, w = src.shape[-3], src.shape[-2]
    band = RowBand(mesh, AXIS, tuple(image_bands(h, mesh.shape[AXIS], 4)
                                     [:-1]), h)
    rows = slice(band.start * w, band.stop * w)
    args = (band.take(src), band.take(ref), band.take(conf, -2),
            ids[..., rows, :], wts[..., rows, :], 3.0, 0.125, 1.2, 2.0)
    xa, xb = band.take(_t(inp["xa"])), band.take(_t(inp["xb"]))
    op, _, _ = nonlocal_solve.make_nonlocal_system_band(
        *args, _t(inp["cands"]), slots[..., rows, :], inp["in_cap"], band)
    oa, ob = op((xa, xb))
    a, b, it, _ = nonlocal_solve.solve_nonlocal(
        xa, xb, *args, iters=6, tol=0.0, candidates=_t(inp["cands"]),
        nbr_slots=slots[..., rows, :], in_cap=inp["in_cap"], band=band)
    return {"op": (band.gather(oa), band.gather(ob)),
            "solve": (band.gather(a), band.gather(b), int(it))}


def pipeline_cases(mesh, inp: dict, model) -> dict:
    """The TINY_P2 pair with JAX's draws replayed (``row_sharded``, its
    output and iterations) and, over 2 ranks, a seeded bucket of 2 through
    ``make_batch_transfer``; uint8 numpy."""
    cnt, stl, seeds = tiny_pairs(2, *PAIR_HW)
    config = dataclasses.replace(TINY_P2, space_mesh=mesh)
    out = {"row_sharded": pipeline.row_sharded(config)}
    res, trace = pipeline.transfer_pair(
        model, cnt[0], stl[0], 2.0, config,
        draws=ReplayDraws([inp["draws"]]), return_intermediates="stats")
    out["pair"] = res.numpy()
    out["pair_iters"] = [(int(t["nl_iters"]), int(t["wls_iters"]))
                         for t in trace]
    if mesh.shape[AXIS] == 2:
        out["bucket"] = make_batch_transfer(TINY_P2, mesh)(
            model, cnt, stl, seeds, 2.0).numpy()
    return out


def multi_world(mesh, models: dict, inp: dict) -> dict:
    """Every case of the several-membership part over the 1 x n space
    mesh, with the port's seeded VGG (``models["port"]``)."""
    return {"nonlocal": nonlocal_cases(mesh, inp["stages"]),
            "pipeline": pipeline_cases(mesh, inp, models["port"])}
