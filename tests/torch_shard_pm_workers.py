"""Rank functions of ``tests/test_torch_space_shard_pm.py``: band
PatchMatch, the band block-Jacobi and Jacobi WLS preconditioners, and the
PatchMatch / block-Jacobi / Jacobi-WLS configurations on row bands, run by
``parallel.mesh.launch`` in spawned gloo ranks on the CPU.

A spawned rank imports the module of its function, so this module imports
no JAX.  Each rank gets the whole numpy inputs, takes its band of rows,
runs the band stage and returns its result gathered to the whole grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nct_tpu_torch import Config, pipeline
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops import patchmatch as pm
from nct_tpu_torch.parallel.batch import make_batch_transfer
from nct_tpu_torch.parallel import mesh as mesh_mod
from nct_tpu_torch.parallel.mesh import RowBand, image_bands, make_mesh
from nct_tpu_torch.solve import nonlocal_solve, wls

from torch_mesh_workers import plain_convolutions, tiny_pairs
from torch_shard_workers import ReplayDraws as _ReplayDraws

AXIS = "space"

# The two configurations at the tiny pair's size: the reference-parity
# preset (PatchMatch at every level, block-Jacobi nonlocal, mg WLS) and
# exact levels under PatchMatch with Jacobi WLS; budgets small, trip
# counts pinned (tol 0), float32 features and VGG as the space mesh runs.
SMALL = dict(pm_iters=2, pm_iters_fine=2, cg_iters=6, cg_iters_final=6,
             cg_iters_mg=6, cg_iters_final_mg=4, wls_cg_iters=6,
             wls_cg_iters_mg=5, kmeans_iters=3, num_levels=2, cg_tol=0.0,
             feature_dtype="float32", vgg_compute_dtype="float32")
CONFIGS = {
    "parity": Config.reference_parity(**SMALL),
    "pm_jacobi": Config(fine_strategy="patchmatch", wls_precond="jacobi",
                        exact_nn_levels=1, **SMALL),
}
# (h, w) of the pairs: the content, then the style; the tall pair gives
# each rank of a 1 x 4 mesh a 16-row unit (no band of zero rows)
PAIR_HW = (40, 48, 44, 52)
TALL_HW = (64, 48, 68, 52)


class ReplayDraws(_ReplayDraws):
    """``torch_shard_workers.ReplayDraws`` plus each PatchMatch call's
    uniforms ("pm{level}{direction}")."""

    def patchmatch_uniforms(self, level, direction, shape):
        return self._stack(f"pm{level}{direction}")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def pm_operands(case: dict):
    """(a, b, nnf0, uniforms) tensors of a PatchMatch case; the features
    in the case's dtype."""
    dt = getattr(torch, case["dtype"])
    return (_t(case["a"]).to(dt), _t(case["b"]).to(dt), _t(case["f0"]),
            _t(case["u"]))


def band_of(mesh, h: int, bounds) -> RowBand:
    return RowBand(mesh, AXIS, tuple(bounds[:-1]), h)


def stage_cases(mesh, inp: dict) -> dict:
    """Band PatchMatch at each case's bounds (with the halo exchanges it
    made), the band block-Jacobi preconditioner and solve, and the Jacobi
    WLS solve; each result gathered whole."""
    n = mesh.shape[AXIS]
    out = {"pm": [], "pm_halos": []}
    for case in inp["pm"]:
        a, b, f0, u = pm_operands(case)
        band = band_of(mesh, a.shape[-3], case["bounds"][n])
        halos = mesh_mod.COMM["halo_calls"]
        nnf, d = pm.patchmatch(band.take(a), b, band.take(f0),
                               band.take(u, -3), case["iters"],
                               case["rs"], band=band)
        out["pm_halos"].append(mesh_mod.COMM["halo_calls"] - halos)
        out["pm"].append((band.gather(nnf), band.gather(d, -2)))

    src, ref, conf = (_t(inp[k]) for k in ("src", "ref", "conf"))
    ids, wts, slots = (_t(inp[k]) for k in ("ids", "wts", "slots"))
    bn = band_of(mesh, src.shape[-3], image_bands(src.shape[-3], n, 4))
    w = src.shape[-2]
    rows = slice(bn.start * w, bn.stop * w)
    args = (bn.take(src), bn.take(ref), bn.take(conf, -2), ids[..., rows, :],
            wts[..., rows, :], 3.0, 0.125, 1.2, 2.0)
    _, _, pre = nonlocal_solve.make_nonlocal_system_band(
        *args, _t(inp["cands"]), slots[..., rows, :], inp["in_cap"], bn,
        "block_jacobi")
    za, zb = pre((bn.take(_t(inp["xa"])), bn.take(_t(inp["xb"]))))
    a_s, b_s, it_nl, _ = nonlocal_solve.solve_nonlocal(
        bn.take(_t(inp["xa"])), bn.take(_t(inp["xb"])), *args, iters=6,
        tol=0.0, candidates=_t(inp["cands"]), nbr_slots=slots[..., rows, :],
        precond_kind="block_jacobi", in_cap=inp["in_cap"], band=bn)
    out["block_jacobi"] = (bn.gather(za), bn.gather(zb), bn.gather(a_s),
                           bn.gather(b_s), int(it_nl))
    a_w, b_w, it_w, _ = wls.solve_wls(
        bn.take(_t(inp["xa"])), bn.take(_t(inp["xb"])),
        bn.take(_t(inp["lab_unit"])), 0.3, iters=6, tol=0.0,
        precond_kind="jacobi", band=bn)
    out["wls_jacobi"] = (bn.gather(a_w), bn.gather(b_w), int(it_w))
    return out


def pipeline_cases(mesh, inp: dict) -> dict:
    """Each configuration's pair with the JAX draws replayed, a bucket of
    2 of the parity configuration (``make_batch_transfer``, seeded draws)
    and a 2-frame ``transfer_sequence`` of it (level 0 warm-started from
    the first frame), all under the 1 x n space mesh; uint8 numpy."""
    cnt, stl, seeds = tiny_pairs(2, *PAIR_HW)
    model = vgg19.params_from_numpy(inp["vgg"])
    out = {}
    for name, config in CONFIGS.items():
        config = dataclasses.replace(config, space_mesh=mesh)
        out[f"{name}_row_sharded"] = pipeline.row_sharded(config)
        res, trace = pipeline.transfer_pair(
            model, cnt[0], stl[0], 2.0, config,
            draws=ReplayDraws([inp["draws"][name]]),
            return_intermediates="stats")
        out[name] = res.numpy()
        out[f"{name}_iters"] = [(int(t["nl_iters"]), int(t["wls_iters"]))
                                for t in trace]
    parity = dataclasses.replace(CONFIGS["parity"], space_mesh=mesh)
    out["bucket"] = make_batch_transfer(CONFIGS["parity"], mesh)(
        model, cnt, stl, seeds, 2.0).numpy()
    out["sequence"] = [f.numpy() for f in pipeline.transfer_sequence(
        model, [cnt[0], cnt[1]], stl[0], 2.0, parity, seed=seeds[0])]
    return out


def shard_world(n: int, stage_inputs: dict, pipe_inputs: dict) -> dict:
    """Every case of one world of ``n`` ranks over a 1 x n space mesh
    (oneDNN off, so the pairs are bitwise the single process's)."""
    plain_convolutions()
    mesh = make_mesh(n_data=1, n_space=n, device="cpu")
    return {"rank": mesh.index(AXIS),
            "stages": stage_cases(mesh, stage_inputs),
            "pipeline": pipeline_cases(mesh, pipe_inputs)}


def four_rank_world(vgg: dict) -> dict:
    """Each configuration's tall pair (seeded draws) over a 1 x 4 space
    mesh, as uint8 numpy, with its row-sharding flag (oneDNN off)."""
    plain_convolutions()
    mesh = make_mesh(n_data=1, n_space=4, device="cpu")
    cnt, stl, seeds = tiny_pairs(1, *TALL_HW)
    model = vgg19.params_from_numpy(vgg)
    out = {}
    for name, config in CONFIGS.items():
        config = dataclasses.replace(config, space_mesh=mesh)
        out[f"{name}_row_sharded"] = pipeline.row_sharded(config)
        out[name] = pipeline.transfer_pair(model, cnt[0], stl[0], 2.0, config,
                                           seed=seeds[0]).numpy()
    return out
