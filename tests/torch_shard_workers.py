"""Rank functions of ``tests/test_torch_space_shard.py``'s default family:
every band stage of the row-sharded pipeline and the pair, run in the
spawned gloo ranks of ``torch_shard_world_workers.world`` on the CPU.

A spawned rank imports the module of its function, so this module imports
no JAX.  Each rank gets the whole numpy inputs, takes its band of rows
(``parallel.mesh.image_bands``), runs the band stage and returns its
result gathered to the whole grid (or as is, where the stage's result is
whole), so the parent compares it with the single-process stage.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nct_tpu_torch import pipeline
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops import bds, window_refine
from nct_tpu_torch.parallel.batch import make_batch_transfer
from nct_tpu_torch.parallel.mesh import RowBand, image_bands
from nct_tpu_torch.parallel.ring_nn import ring_band_nn
from nct_tpu_torch.solve import cg, knn, nonlocal_solve, stats, wls

from torch_mesh_workers import TINY, tiny_pairs

AXIS = "space"


class ReplayDraws:
    """Draws recorded from another run (k-means indices and each level's
    candidates), for one pair or, stacked, for a bucket."""

    def __init__(self, records: list):
        self.records = records

    def _stack(self, key):
        vals = [torch.as_tensor(r[key]) for r in self.records]
        return vals[0] if len(vals) == 1 else torch.stack(vals)

    def kmeans_init(self, n, k):
        return self._stack("kmeans")

    def candidates(self, level, member_pix, m):
        return self._stack(f"cand{level}")


def band(mesh, h: int, unit: int = 1, bounds=None) -> RowBand:
    """The band of an h-row grid split by ``image_bands`` (or ``bounds``)."""
    if bounds is None:
        bounds = image_bands(h, mesh.shape[AXIS], unit)
    return RowBand(mesh, AXIS, tuple(bounds[:-1]), h)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def stage_cases(mesh, inp: dict, model) -> dict:
    """Every band stage on the numpy inputs ``inp`` (see the test module's
    ``_shard_inputs``), VGG's taps through ``model``; each result whole."""
    out = {}

    # VGG taps of a band of the input (one-row halos per convolution)
    img = _t(inp["img"])
    bounds = image_bands(img.shape[0], mesh.shape[AXIS])
    dims = vgg19.feature_dims(*img.shape[:2])
    b0 = band(mesh, img.shape[0], bounds=bounds)
    levels = [RowBand.of_image(mesh, AXIS, bounds, pipeline._pools(t),
                               dims[t][0]) for t in vgg19.PIPELINE_TAPS]
    widths = [dims[t][1] for t in vgg19.PIPELINE_TAPS]
    taps = model(b0.take(img), vgg19.PIPELINE_TAPS, band=b0)
    out["vgg"] = {t: lv.gather(taps[t])
                  for t, lv in zip(vgg19.PIPELINE_TAPS, levels)}

    # the pyramid of the input and a float map resized to full resolution
    pyr = pipeline._band_pyramid(b0.take(img), b0, levels, widths)
    out["pyramid"] = [lv.gather(p) for lv, p in zip(levels, pyr)]
    coarse = _t(inp["coarse"])                        # on the L1 grid
    up = pipeline._band_resize(levels[1].take(coarse), levels[1], b0,
                               img.shape[1])
    out["resize"] = b0.gather(up)

    # NNF upsampling L2 -> L3 (the ratio is not 2 under ceil dims)
    field = _t(inp["field"])
    out["upsample"] = levels[3].gather(pipeline._band_upsample(
        levels[2].take(field), levels[2], levels[3], widths[3],
        *inp["field_b"]))

    # BDS vote (a bucket of 2) and the colour guide (one pair)
    ba, bb = band(mesh, inp["ann"].shape[-3]), band(mesh, inp["bnn"].shape[-3])
    ann, bnn = _t(inp["ann"]), _t(inp["bnn"])
    voted, wsum = bds.bds_vote_band(_t(inp["payload"]), ba.take(ann),
                                    bb.take(bnn), ba, bb, 1.0, 2.0, 3)
    out["bds"] = (ba.gather(voted), ba.gather(wsum, -2))
    out["guide"] = ba.gather(bds.bds_reconstruct_color(
        _t(inp["colors"]), ba.take(ann[0]), bb.take(bnn[0]), 1.0, 2.0, 3,
        bands=(ba, bb)))

    # window refine of a band against the whole other level
    a, f0 = _t(inp["wr_a"]), _t(inp["wr_nnf"])
    bw = band(mesh, a.shape[-3])
    x_ext, top, bottom = bw.halo(bw.take(a), 1, 1)
    f_ext = bw.halo(bw.take(f0), 1, 1)[0]
    got, d = window_refine.window_refine(x_ext, _t(inp["wr_b"]), f_ext, 2,
                                         3, 3, 8, halo=(top, bottom),
                                         gather_taps=True)
    out["window"] = (bw.gather(got), bw.gather(d, -2))

    # the k-NN graph of a band (candidates' colours from their ranks)
    lab, labels, cands = (_t(inp[k]) for k in ("lab", "labels", "cands"))
    bk = band(mesh, lab.shape[-3])
    g = knn.knn_graph(bk.take(lab), bk.take(labels, -2), cands, 8, chunk=64,
                      cand_colors=pipeline._band_points(bk, bk.take(lab),
                                                        cands),
                      row0=bk.start * lab.shape[-2],
                      n_total=lab.shape[-3] * lab.shape[-2])
    out["knn"] = tuple(bk.gather(t.reshape(t.shape[:-2] + (bk.rows, -1, 8)))
                       for t in g)

    # the error confidence (min and max over the bands)
    err = _t(inp["err"])
    bs = band(mesh, err.shape[-2])
    out["stats"] = bs.gather(stats.error_confidence(bs.take(err, -2),
                                                    band=bs), -2)

    # the grid terms and the V-cycle on a grid that coarsens twice on
    # bands, then gathers
    lum, u = _t(inp["lum"]), _t(inp["u"])
    bg = band(mesh, lum.shape[-2], 4)
    gx, gy = nonlocal_solve.gradient_weights(bg.take(lum, -2), 0.5, 1.2, bg)
    gy_ext = bg.halo(gy, 1, 0, dim=-2)[0]
    lap = nonlocal_solve.laplacian_apply(bg.take(u), gx, gy_ext, bg)
    deg = nonlocal_solve.laplacian_degree(gx, gy_ext, bg)
    blk = [bg.take(_t(inp[k])) for k in ("blk_aa", "blk_ab", "blk_bb")]
    pre = nonlocal_solve.make_mg_preconditioner(*blk, gx, gy, bg)
    za, zb = pre((bg.take(u), bg.take(_t(inp["u2"]))))
    out["grid"] = (bg.gather(gx, -2), bg.gather(gy, -2), bg.gather(lap),
                   bg.gather(deg, -2), bg.gather(za), bg.gather(zb))

    # the nonlocal system and both solves (fixed iterations, tol 0)
    src, ref, conf = (_t(inp[k]) for k in ("src", "ref", "conf"))
    ids, wts, slots = (_t(inp[k]) for k in ("ids", "wts", "slots"))
    bn = band(mesh, src.shape[-3], 4)
    w = src.shape[-2]
    rows = slice(bn.start * w, bn.stop * w)
    args = (bn.take(src), bn.take(ref), bn.take(conf, -2), ids[..., rows, :],
            wts[..., rows, :], 3.0, 0.125, 1.2, 2.0)
    op, rhs, _ = nonlocal_solve.make_nonlocal_system_band(
        *args, _t(inp["nl_cands"]), slots[..., rows, :], inp["in_cap"], bn)
    xa, xb = op((bn.take(_t(inp["xa"])), bn.take(_t(inp["xb"]))))
    a_s, b_s, it_nl, r2_nl = nonlocal_solve.solve_nonlocal(
        bn.take(_t(inp["xa"])), bn.take(_t(inp["xb"])), *args, iters=6,
        tol=0.0, candidates=_t(inp["nl_cands"]), nbr_slots=slots[..., rows, :],
        in_cap=inp["in_cap"], band=bn)
    lab_u = _t(inp["lab_unit"])
    a_w, b_w, it_w, r2_w = wls.solve_wls(
        bn.take(_t(inp["xa"])), bn.take(_t(inp["xb"])), bn.take(lab_u), 0.3,
        iters=6, tol=0.0, band=bn)
    dot = cg._band_dot(bn, False)((bn.take(_t(inp["xa"])),),
                                  (bn.take(_t(inp["xb"])),))
    out["nonlocal"] = (bn.gather(xa), bn.gather(xb), bn.gather(a_s),
                       bn.gather(b_s), int(it_nl), float(r2_nl))
    out["wls"] = (bn.gather(a_w), bn.gather(b_w), int(it_w), float(r2_w))
    out["dot"] = float(dot)

    # the ring on row bands, both directions
    out["ring"] = {}
    for name, (fa, fb) in inp["ring"].items():
        fa, fb = _t(fa), _t(fb)
        ra, rb = band(mesh, fa.shape[-3]), band(mesh, fb.shape[-3])
        got, d = ring_band_nn(ra.take(fa), rb.take(fb), ra, rb, 3)
        out["ring"][name] = (ra.gather(got), ra.gather(d, -2))
    return out


def pipeline_cases(mesh, inp: dict, model) -> dict:
    """The TINY pair through ``transfer_pair`` (the JAX draws replayed, run
    twice; and with ``exact_nn_levels=1``, so the window refine runs on
    bands), and the bucket of 2 through ``make_batch_transfer`` (the ring
    and ``ring_nn=False``) and through ``transfer_batch`` with the JAX
    draws replayed; every result uint8 numpy."""
    cnt, stl, seeds = tiny_pairs(2, 40, 48, 44, 52)
    out = {}
    for name, exact in (("pair", 4), ("pair_exact1", 1)):
        config = dataclasses.replace(TINY, space_mesh=mesh,
                                     exact_nn_levels=exact)
        runs = []
        for _ in range(2 if name == "pair" else 1):
            res, trace = pipeline.transfer_pair(
                model, cnt[0], stl[0], 2.0, config,
                draws=ReplayDraws([inp["draws"][name]]),
                return_intermediates="stats")
            runs.append(res.numpy())
        out[name] = runs
        out[f"{name}_iters"] = [(int(t["nl_iters"]), int(t["wls_iters"]))
                                for t in trace]
    out["bucket"] = make_batch_transfer(TINY, mesh)(
        model, cnt, stl, seeds, 2.0).numpy()
    out["bucket_replicated"] = make_batch_transfer(TINY, mesh, ring_nn=False)(
        model, cnt, stl, seeds, 2.0).numpy()
    config = dataclasses.replace(TINY, space_mesh=mesh,
                                 vgg_compute_dtype="float32")
    out["bucket_jax_draws"] = pipeline.transfer_batch(
        model, cnt, stl, 2.0, config, seeds,
        draws=ReplayDraws([inp["draws"]["pair"], inp["draws"]["item1"]])
    ).numpy()
    return out


def shard_world(mesh, models: dict, inp: dict) -> dict:
    """Every case of the default family over the 1 x n space mesh, with
    the JAX package's seeded VGG (``models["jax"]``)."""
    return {"stages": stage_cases(mesh, inp["stages"], models["jax"]),
            "pipeline": pipeline_cases(mesh, inp, models["jax"])}
