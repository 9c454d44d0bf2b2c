"""Rank functions of ``tests/test_torch_space_shard.py``'s scatter part:
the scatter transpose (``nl_transpose="scatter"``) on row bands, run in the
spawned gloo ranks of ``torch_shard_world_workers.world`` on the CPU.

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

from torch_mesh_workers import TINY_SCATTER, TINY_VARIANTS, tiny_pairs
from torch_shard_workers import ReplayDraws

AXIS = "space"
PAIR_HW = (40, 48, 44, 52)
# the band layouts of the operator cases: every band but the last of 1, 3
# or 5 rows (odd starts: the V-cycle gathers at once), or 4-row units
# (bands that coarsen before the gather)
LAYOUTS = (1, 3, 5, "units4")
LEADS = ((), (2,))
SOLVE_ITERS = 6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def layout_bounds(layout, h: int, n: int) -> list:
    """Row boundaries of an ``n``-band split of ``h`` rows."""
    if layout == "units4":
        return image_bands(h, n, 4)
    return [min(layout * j, h) for j in range(n)] + [h]


def operator_case(mesh, inp: dict, layout) -> dict:
    """The band scatter operator applied once, both preconditioners
    applied to the same vector, and a solve of each preconditioner at
    ``SOLVE_ITERS`` pinned iterations, at one band layout; every result
    gathered whole."""
    src, ref, conf = (_t(inp[k]) for k in ("src", "ref", "conf"))
    ids, wts, slots = (_t(inp[k]) for k in ("ids", "wts", "slots"))
    h, w = src.shape[-3], src.shape[-2]
    band = RowBand(mesh, AXIS, tuple(layout_bounds(
        layout, h, mesh.shape[AXIS])[:-1]), h)
    rows = slice(band.start * w, band.stop * w)
    args = (band.take(src), band.take(ref), band.take(conf, -2),
            ids[..., rows, :], wts[..., rows, :], 3.0, 0.125, 1.2, 2.0)
    cands, slots = _t(inp["cands"]), slots[..., rows, :]
    xa, xb = band.take(_t(inp["xa"])), band.take(_t(inp["xb"]))
    out = {}
    for kind in nonlocal_solve.PRECOND_KINDS:
        op, _, pre = nonlocal_solve.make_nonlocal_system_band(
            *args, cands, slots, 0, band, kind, "scatter")
        if kind == "mg":
            out["op"] = tuple(band.gather(t) for t in op((xa, xb)))
        out[f"pre_{kind}"] = tuple(band.gather(t) for t in pre((xa, xb)))
        a, b, it, _ = nonlocal_solve.solve_nonlocal(
            xa, xb, *args, iters=SOLVE_ITERS, tol=0.0, candidates=cands,
            nbr_slots=slots, precond_kind=kind, transpose="scatter",
            band=band)
        out[f"solve_{kind}"] = (band.gather(a), band.gather(b),
                                it.tolist() if torch.is_tensor(it)
                                else int(it))
    return out


def pipeline_cases(mesh, inp: dict, model) -> dict:
    """The TINY variants pair with JAX's draws replayed (``row_sharded``,
    its output and iterations) and, over 2 ranks, a seeded bucket of 2 of
    TINY with the scatter transpose through ``make_batch_transfer``;
    uint8 numpy."""
    cnt, stl, seeds = tiny_pairs(2, *PAIR_HW)
    config = dataclasses.replace(TINY_VARIANTS, space_mesh=mesh)
    out = {"row_sharded": pipeline.row_sharded(config)}
    res, trace = pipeline.transfer_pair(
        model, cnt[0], stl[0], 2.0, config,
        draws=ReplayDraws([inp["draws"]]), return_intermediates="stats")
    out["pair"] = res.numpy()
    out["pair_iters"] = [(int(t["nl_iters"]), int(t["wls_iters"]))
                         for t in trace]
    if mesh.shape[AXIS] == 2:
        out["bucket"] = make_batch_transfer(TINY_SCATTER, mesh)(
            model, cnt, stl, seeds, 2.0).numpy()
    return out


def scatter_world(mesh, models: dict, inp: dict) -> dict:
    """Every case of the scatter part over the 1 x n space mesh, with the
    port's seeded VGG (``models["port"]``)."""
    return {"operator": {(layout, len(lead)): operator_case(
                mesh, inp["stages"][lead], layout)
                for layout in LAYOUTS for lead in LEADS},
            "pipeline": pipeline_cases(mesh, inp, models["port"])}
