"""Progressive colour-transfer pipeline: the 5-level coarse-to-fine loop
(port of ``nct_tpu/pipeline.py::transfer_pair``).

Per level (conv5_1 -> conv1_1):

  1. correspondence search: exact bidirectional patch NN at levels
     [0, exact_nn_levels) (the CUDA kernel on the card); above them window
     refine of the upsampled fields (``fine_strategy="window"``) or
     PatchMatch, seeded at level 0 by the scaled identity or a video warm
     start;
  2. BDS colour guidance + BDS feature vote -> matching error;
  3. semantic k-NN graph on down-res Lab colours (primary cluster, or the
     merge of ``knn_memberships`` memberships);
  4. patch-moment (a, b) init + confidence;
  5. nonlocal PCG solve at down-res (``nl_precond``, ``nl_transpose``);
  6. bilinear coefficient upsample + roughness gate + WLS PCG
     (``wls_precond``);
  7. apply a*Lab+b at full res, Lab -> BGR;
  8. re-extract the next level's VGG tap from the refined image.

Randomness enters only through ``draws`` (k-means initial centres, each
PatchMatch level's random-search uniforms and each level's cluster
candidates); by default a ``torch.Generator`` seeded from ``seed`` supplies
them.  ``transfer_pair`` and ``transfer_sequence`` run on ``cuda`` unless
the caller passes ``device="cpu"``.

``transfer_batch`` runs a bucket of pairs of one geometry through the same
level loop with a leading batch axis on every tensor (the counterpart of
``jax.vmap`` over ``transfer_pair``): each stage runs once over the bucket,
so a bucket costs about one pair's launches.  Item i draws what
``transfer_pair(seed=seeds[i])`` draws, in the same order, and its solves
run their own iterations (``cg_solve_grouped``).

Under ``Config.space_mesh`` (a ``parallel.mesh.Mesh`` with more than one
rank on ``space_axis``) every rank of the space group calls the function
with the same pair or bucket, and every rank returns the whole result,
bitwise equal on every rank.  Every configuration (any membership count,
search, transpose, preconditioner and level count) runs there on row
bands (``row_sharded``): each rank holds and computes its band of rows of
the pair (``parallel.mesh.image_bands``; the JAX package's GSPMD row
sharding; an image with fewer 16-row units than ranks leaves the
trailing ranks bands of zero rows, which still join every exchange): the
VGG body, the pyramids, the colour and feature stages, the k-NN graph
(either membership count) and both solves (the in-edge tables or the
scatter transpose) run on bands with one-row halos; the exact levels
search through the ring over row bands
(``parallel.ring_nn``) or, with ``ring_nn=False``, through ``nn_bidir``
on the gathered levels;
window refine and PatchMatch search a band of one image against the
gathered other level (PatchMatch's propagation through a 15-row halo per
iteration); the BDS votes and the candidates read gathered style (and
candidate) operands; k-means runs on the gathered conv5_1 level and the
coarse multigrid levels are gathered; dot products add over the bands in
rank order.  The output rows are gathered at the end.  No stage runs the
whole pair on a rank.
"""

from __future__ import annotations

import numpy as np
import torch

from nct_tpu_torch.config import Config
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops import bds, cuda_nn, features, nnf, resize
from nct_tpu_torch.ops.color import bgr_u8_to_lab_u8, unit_lab_to_bgr_u8
from nct_tpu_torch.ops.patchmatch import patchmatch, random_search_mags
from nct_tpu_torch.ops.window_refine import window_refine
from nct_tpu_torch.parallel.mesh import Mesh, RowBand, image_bands
from nct_tpu_torch.parallel.ring_nn import ring_band_nn
from nct_tpu_torch.solve import cluster, knn, stats
from nct_tpu_torch.solve.nonlocal_solve import solve_nonlocal
from nct_tpu_torch.solve.wls import apply_transform, solve_wls

# Level-pixel count above which the window refine may rank stage 1 on
# Config.window_stage1_channels_maxsize channels (see stage1_channels).
STAGE1_SUBSET_PIXELS = 320_000


class GeneratorDraws:
    """Default draws: k-means initial indices, PatchMatch uniforms and
    per-level candidate scores from one CPU ``torch.Generator`` seeded with
    ``seed`` (so a run on the card draws what a run on the CPU draws)."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def kmeans_init(self, n: int, num_clusters: int) -> torch.Tensor:
        return cluster.draw_kmeans_init(n, num_clusters, self.generator)

    def patchmatch_uniforms(self, level: int, direction: str,
                            shape: tuple) -> torch.Tensor:
        """Random-search uniforms of one PatchMatch call; ``direction`` is
        "ab", then "ba", at each PatchMatch level.  On row bands every
        rank draws the whole field's and keeps its band's rows, so the
        draws are the single process's."""
        return torch.rand(shape, generator=self.generator)

    def candidate_scores(self, level: int, k: int, n: int) -> torch.Tensor:
        """Uniform scores [k, n] of one level's candidate draw."""
        return torch.rand((k, n), generator=self.generator)

    def candidates(self, level: int, membership_pix: torch.Tensor,
                   m: int) -> torch.Tensor:
        k = membership_pix.shape[0]
        n = membership_pix.shape[1] * membership_pix.shape[2]
        scores = self.candidate_scores(level, k, n)
        return knn.sample_cluster_candidates(membership_pix, scores, m)


class BatchDraws:
    """The draws of a bucket: item i draws from ``GeneratorDraws(seeds[i])``
    in the order ``transfer_pair`` draws (k-means, then per level the "ab"
    and "ba" PatchMatch uniforms where PatchMatch runs, then the
    candidates), results stacked on a leading batch axis."""

    def __init__(self, seeds):
        self.items = [GeneratorDraws(int(s)) for s in seeds]

    def kmeans_init(self, n: int, num_clusters: int) -> torch.Tensor:
        return torch.stack([d.kmeans_init(n, num_clusters)
                            for d in self.items])

    def patchmatch_uniforms(self, level: int, direction: str,
                            shape: tuple) -> torch.Tensor:
        """[B, *shape]: each item's uniforms of one PatchMatch call."""
        return torch.stack([d.patchmatch_uniforms(level, direction, shape)
                            for d in self.items])

    def candidates(self, level: int, membership_pix: torch.Tensor,
                   m: int) -> torch.Tensor:
        k = membership_pix.shape[-3]
        n = membership_pix.shape[-2] * membership_pix.shape[-1]
        scores = torch.stack([d.candidate_scores(level, k, n)
                              for d in self.items])
        return knn.sample_cluster_candidates(membership_pix, scores, m)


def check_config(config: Config) -> None:
    """Raise ValueError for Config values the port does not know; a
    ``space_mesh`` must be a ``parallel.mesh.Mesh``.  ``transfer_pair`` and
    ``transfer_batch`` run every Config this accepts."""
    if config.fine_strategy not in ("window", "patchmatch"):
        raise ValueError(f"fine_strategy={config.fine_strategy!r}")
    if config.space_mesh is not None and not isinstance(config.space_mesh,
                                                        Mesh):
        raise ValueError(f"space_mesh must be a parallel.mesh.Mesh, got "
                         f"{type(config.space_mesh).__name__}")
    if config.feature_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"feature_dtype={config.feature_dtype!r}")


def row_sharded(config: Config) -> bool:
    """True when ``config.space_mesh`` splits the pair by rows: more than
    one rank on ``space_axis``.  The band stages run every configuration
    that ``check_config`` accepts (any membership count, search,
    transpose and preconditioner of either solve)."""
    mesh = config.space_mesh
    return mesh is not None and mesh.shape[config.space_axis] > 1


def _resolve_device(device, config: Config | None = None) -> torch.device:
    """``device`` or, by default, the space mesh's device, else ``cuda``;
    raises when that is ``cuda`` and no card is present (never carries on
    on the CPU unasked)."""
    if device is None and config is not None and config.space_mesh is not None:
        device = config.space_mesh.device
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the pipeline runs on cuda unless device='cpu' is "
                           "passed, and no CUDA device is available")
    return device


def image_pyramid(img_u8: torch.Tensor,
                  dims: list[tuple[int, int]]) -> list[torch.Tensor]:
    """Cascaded INTER_LINEAR pyramid: each level resized from the next finer
    one; the finest level is the image itself when the dims match."""
    n = len(dims)
    out: list = [None] * n
    h, w = dims[n - 1]
    out[n - 1] = (img_u8 if tuple(img_u8.shape[-3:-1]) == (h, w)
                  else resize.resize_bilinear(img_u8, h, w))
    for l in range(n - 2, -1, -1):
        h, w = dims[l]
        out[l] = resize.resize_bilinear(out[l + 1], h, w)
    return out


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _setup(model, cnt, stl, draws, config: Config, taps):
    """Feature extraction, pyramids, content Lab and semantic clusters (of
    one pair, or of a bucket with a leading batch axis)."""
    h, w = cnt.shape[-3], cnt.shape[-2]
    hs, ws = stl.shape[-3], stl.shape[-2]
    lead = tuple(cnt.shape[:-3])
    cnt_dims = [vgg19.feature_dims(h, w)[t] for t in taps]
    stl_dims = [vgg19.feature_dims(hs, ws)[t] for t in taps]

    vgg_dtype = _dtype(config.vgg_compute_dtype or config.feature_dtype)
    cnt_feats = model(cnt, taps, vgg_dtype)
    stl_feats = model(stl, taps, vgg_dtype)
    cnt_pyr = image_pyramid(cnt, cnt_dims)
    stl_pyr = image_pyramid(stl, stl_dims)
    cnt_lab_unit = bgr_u8_to_lab_u8(cnt).float() / 255.0

    lh, lw = cnt_dims[0]
    f0n, _ = features.l2_normalize(cnt_feats[taps[0]].float())
    init_idx = draws.kmeans_init(lh * lw, config.cluster_num)
    label_map, _ = cluster.kmeans(
        f0n.reshape(lead + (lh * lw, -1)), init_idx,
        num_clusters=config.cluster_num, iters=config.kmeans_iters)
    label_map = label_map.reshape(lead + (lh, lw))
    membership = cluster.cluster_membership(label_map, config.cluster_num)
    return (cnt_feats, stl_feats, cnt_pyr, stl_pyr, cnt_lab_unit, label_map,
            membership)


def stage1_channels(config: Config, content_pixels: int, own_pixels: int,
                    threshold: int | None = None) -> int:
    """Stage-1 ranking channels of one window-refine direction.

    With ``config.window_stage1_channels == 0`` the subset
    ``window_stage1_channels_maxsize`` applies only when the content level
    has more than ``threshold`` pixels (default ``STAGE1_SUBSET_PIXELS``)
    and so has the direction's own query level; otherwise
    ``window_stage1_channels`` passes through.  The JAX package ranks on
    the subset only on its staged sub-split path, which the JAX CLI and
    ``bench.py`` take exactly when the content exceeds 320k pixels
    (``nct_tpu/pipeline.py:748``, then ``:253-255`` per direction), and
    its fused path passes the Config value through.  The port has no
    fused/staged split, but keeps this rule so each geometry ranks on the
    channels the JAX package ranks on there.
    """
    if threshold is None:
        threshold = STAGE1_SUBSET_PIXELS
    if (config.window_stage1_channels == 0 and content_pixels > threshold
            and own_pixels > threshold):
        return config.window_stage1_channels_maxsize
    return config.window_stage1_channels


def _level_match(config: Config, l: int, rs: int, draws, bds_weight: float,
                 ann_prev, bnn_prev, cnt_feat_l, stl_feat_l, down_stl):
    """Correspondence search + BDS guidance.  ``ann_prev``/``bnn_prev``:
    the previous level's fields, or at level 0 the warm start (or None).
    Returns (ann, bnn, guide_bgr, bds_err)."""
    ah, aw = cnt_feat_l.shape[-3], cnt_feat_l.shape[-2]
    bh, bw = down_stl.shape[-3], down_stl.shape[-2]
    fdt = _dtype(config.feature_dtype)
    ps = config.patch_size
    fs = stl_feat_l.float()
    fc_n = features.l2_normalize(cnt_feat_l.float())[0].to(fdt)
    fs_n = features.l2_normalize(fs)[0].to(fdt)
    if l < config.exact_nn_levels:
        ann, _, bnn, _ = cuda_nn.exact_nn_bidir(fc_n, fs_n, ps)
    elif config.fine_strategy == "window" and l > 0:
        ann0 = nnf.upsample(ann_prev, ah, aw, bh, bw)
        bnn0 = nnf.upsample(bnn_prev, bh, bw, ah, aw)
        ann, _ = window_refine(
            fc_n, fs_n, ann0, config.window_radius, config.window_shortlist,
            ps, stage1_channels(config, ah * aw, ah * aw))
        bnn, _ = window_refine(
            fs_n, fc_n, bnn0, config.window_radius, config.window_shortlist,
            ps, stage1_channels(config, ah * aw, bh * bw))
    else:
        dev = fc_n.device
        if l > 0:
            ann0 = nnf.upsample(ann_prev, ah, aw, bh, bw)
            bnn0 = nnf.upsample(bnn_prev, bh, bw, ah, aw)
        elif ann_prev is not None:      # video warm start
            ann0, bnn0 = ann_prev, bnn_prev
        else:
            # one field for every item of a bucket
            lead = tuple(fc_n.shape[:-3])
            ann0 = nnf.init_scaled_identity(ah, aw, bh, bw, dev).expand(
                lead + (ah, aw, 2))
            bnn0 = nnf.init_scaled_identity(bh, bw, ah, aw, dev).expand(
                lead + (bh, bw, 2))
        iters = (config.pm_iters_fine if config.exact_nn_levels > 0
                 else config.pm_iters)
        fields = []
        for direction, (fa, fb, f0) in (("ab", (fc_n, fs_n, ann0)),
                                        ("ba", (fs_n, fc_n, bnn0))):
            n_mags = max(len(random_search_mags(rs, fb.shape[-3],
                                                fb.shape[-2])), 1)
            u = draws.patchmatch_uniforms(
                l, direction, (iters, n_mags, fa.shape[-3], fa.shape[-2], 2))
            fields.append(patchmatch(fa, fb, f0, u, iters, rs, ps)[0])
        ann, bnn = fields

    guide_bgr = bds.bds_reconstruct_color(down_stl, ann, bnn, 1.0,
                                          bds_weight, ps)
    voted_feat, _ = bds.bds_vote(fs, ann, bnn, 1.0, bds_weight, ps)
    gf_n, _ = features.l2_normalize(voted_feat)
    return ann, bnn, guide_bgr, features.cosine_error(fc_n, gf_n)


def _level_solve(model, config: Config, l: int, numlayer: int, taps, draws,
                 guide_bgr, bds_err, prev_ab, down_cnt, cnt_lab_unit,
                 label_map, membership):
    """k-NN graph, patch moments, nonlocal + WLS solves, apply, and the next
    level's feature re-extraction.  Returns (refined, cnt_feat_next, a_d,
    b_d, a_f, b_f, (nl_iters, nl_r2), (wls_iters, wls_r2))."""
    h, w = cnt_lab_unit.shape[-3], cnt_lab_unit.shape[-2]
    ah, aw = down_cnt.shape[-3], down_cnt.shape[-2]
    ps = config.patch_size

    # k-NN graph on down-res Lab + patch-moment init + confidence
    cnt_lab_u8 = bgr_u8_to_lab_u8(down_cnt)
    cnt_lab_d = cnt_lab_u8.float() / 255.0
    stride = 2 ** l
    if config.knn_memberships > 1:
        pixel_labels = cluster.multi_labels_for_pixels(
            label_map, membership, ah, aw, stride, config.knn_memberships)
    else:
        pixel_labels = cluster.labels_for_pixels(label_map, ah, aw, stride)
    member_pix = cluster.membership_for_pixels(membership, ah, aw, stride)
    candidates = draws.candidates(l, member_pix, min(2048, ah * aw))
    nbr_ids, nbr_w, nbr_slots = knn.knn_graph(
        cnt_lab_d, pixel_labels, candidates, k_num=config.k_num)
    guide_lab_u8 = bgr_u8_to_lab_u8(guide_bgr)
    guide_lab_d = guide_lab_u8.float() / 255.0
    a0, b0 = stats.init_ab(cnt_lab_u8, guide_lab_u8, ps, config.var_epsilon)
    confidence = stats.error_confidence(bds_err)

    # nonlocal solve at down-res, warm-started from the previous level
    if prev_ab is not None:
        a0 = resize.resize_bilinear(prev_ab[0], ah, aw)
        b0 = resize.resize_bilinear(prev_ab[1], ah, aw)
    else:
        # level 0: clamp a to [0, 2] and recompute b so the init's predicted
        # colour a*s+b is unchanged (gamut-clipped) while the coefficient
        # spikes a = sigma_ref/(sigma_src+eps) of flat regions are removed
        tgt = torch.clamp(cnt_lab_d * a0 + b0, 0.0, 1.0)
        a0 = torch.clamp(a0, 0.0, 2.0)
        b0 = tgt - cnt_lab_d * a0
    final = l == numlayer - 1
    if config.nl_precond == "mg":
        nl_iters = config.cg_iters_final_mg if final else config.cg_iters_mg
    else:
        nl_iters = config.cg_iters_final if final else config.cg_iters
    a_d, b_d, nl_it, nl_r2 = solve_nonlocal(
        a0, b0, cnt_lab_d, guide_lab_d, confidence, nbr_ids, nbr_w,
        float(h * w) / float(ah * aw), config.local_weight, config.wls_alpha,
        config.nonlocal_weight, iters=nl_iters, tol=config.cg_tol,
        candidates=candidates, nbr_slots=nbr_slots,
        precond_kind=config.nl_precond, in_cap=config.nl_in_cap,
        transpose=config.nl_transpose)

    # full-res WLS, apply, convert, re-extract
    lam = config.wls_lambda_init * (float(h * w) / float(ah * aw))
    if (ah, aw) == (h, w):
        lam = lam * 4.0  # final-level boost (ref :1418-1424)
    a_f, b_f, wls_it, wls_r2 = solve_wls(
        resize.resize_bilinear(a_d, h, w), resize.resize_bilinear(b_d, h, w),
        cnt_lab_unit, lam, config.wls_alpha,
        iters=(config.wls_cg_iters_mg if config.wls_precond == "mg"
               else config.wls_cg_iters),
        tol=config.cg_tol, precond_kind=config.wls_precond)
    refined = unit_lab_to_bgr_u8(apply_transform(a_f, b_f, cnt_lab_unit))

    cnt_feat_next = None
    if l < numlayer - 1:
        vgg_dtype = _dtype(config.vgg_compute_dtype or config.feature_dtype)
        cnt_feat_next = model(refined, (taps[l + 1],), vgg_dtype)[taps[l + 1]]
    return (refined, cnt_feat_next, a_d, b_d, a_f, b_f, (nl_it, nl_r2),
            (wls_it, wls_r2))


def _as_image(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(device)


def _run_levels(model, config: Config, taps, draws, bds_weight: float, cnt,
                stl, ann, bnn, record, ring: bool = True):
    """The coarse-to-fine loop over one pair or a bucket (a leading batch
    axis on ``cnt`` and ``stl``).  ``ann``/``bnn``: the level-0 warm start
    or None.  Returns (refined, per-level trace if ``record``, level-0
    {"ann", "bnn"}).  Under a space mesh of more than one space rank
    (``row_sharded``) the loop runs on row bands (``_run_band_levels``);
    ``ring`` picks its exact-level search there."""
    if row_sharded(config):
        return _run_band_levels(model, config, taps, draws, bds_weight, cnt,
                                stl, ann, bnn, record, ring)
    numlayer = len(taps)
    ranges = config.pm_search_radii(max(*cnt.shape[-3:-1], *stl.shape[-3:-1]))
    (cnt_feats, stl_feats, cnt_pyr, stl_pyr, cnt_lab_unit, label_map,
     membership) = _setup(model, cnt, stl, draws, config, taps)

    refined = cnt
    cnt_feat_l = cnt_feats[taps[0]]
    trace: list[dict] = []
    prev_ab = None
    coarse_state = None
    for l in range(numlayer):
        ann, bnn, guide_bgr, bds_err = _level_match(
            config, l, max(int(ranges[l]), 1), draws, bds_weight, ann, bnn,
            cnt_feat_l, stl_feats[taps[l]], stl_pyr[l])
        (refined, cnt_feat_l, a_d, b_d, a_f, b_f, nl_info,
         wls_info) = _level_solve(
            model, config, l, numlayer, taps, draws, guide_bgr, bds_err,
            prev_ab, cnt_pyr[l], cnt_lab_unit, label_map, membership)
        prev_ab = (a_d, b_d)
        if l == 0:
            coarse_state = {"ann": ann, "bnn": bnn}
        if record:
            tr = {"level": l, "nl_iters": nl_info[0], "nl_r2": nl_info[1],
                  "wls_iters": wls_info[0], "wls_r2": wls_info[1]}
            if record != "stats":
                tr.update({"ann": ann, "bnn": bnn, "guide": guide_bgr,
                           "a": a_f, "b": b_f, "bds_err": bds_err,
                           "refined": refined})
            trace.append(tr)
    return refined, trace, coarse_state


class _PairBands:
    """The row bands of a pair under a space mesh: every grid of the
    content and of the style (the input, each VGG tap and pyramid level)
    split at the same input rows (``image_bands``)."""

    def __init__(self, config: Config, taps, cnt_hw, stl_hw):
        mesh, axis = config.space_mesh, config.space_axis
        n = mesh.shape[axis]
        self.grids = []
        for h, w in (cnt_hw, stl_hw):
            bounds = image_bands(h, n)
            dims = vgg19.feature_dims(h, w)
            levels = [RowBand.of_image(mesh, axis, bounds, _pools(t),
                                       dims[t][0]) for t in taps]
            full = RowBand.of_image(mesh, axis, bounds, 0, h)
            self.grids.append((full, levels, [dims[t][1] for t in taps]))

    def cnt(self, l: int) -> RowBand:
        return self.grids[0][1][l]

    def stl(self, l: int) -> RowBand:
        return self.grids[1][1][l]

    @property
    def cnt_full(self) -> RowBand:
        return self.grids[0][0]


def _pools(tap: str) -> int:
    """2x2 pools before a VGG tap ("conv3_1" -> 2): its grid is the input
    / 2**pools, ceil."""
    return int(tap[4]) - 1


def _halo_counts(src: RowBand, needs) -> tuple[int, int]:
    """The halo (rows above, rows below) that gives every band its source
    rows: ``needs`` [(first, last)] per band of ``src``'s axis (None for a
    band of zero rows, which needs none); every rank takes the largest, so
    all ranks call the halo alike."""
    above = below = 0
    for j, need in enumerate(needs):
        if need is None:
            continue
        lo, hi = need
        start, stop = src.span(j)
        above = max(above, start - lo)
        below = max(below, hi + 1 - stop)
    return above, below


def _band_resize(x, src: RowBand, dst: RowBand, out_w: int):
    """``resize.resize_bilinear`` of a band: ``x`` holds ``src``'s rows,
    the result ``dst``'s rows of the resize to (dst.h, out_w)."""
    needs = [resize.source_rows(dst.h, src.h, *dst.span(j))
             if dst.holds(j) else None for j in range(dst.n)]
    ext, top, _ = src.halo(x, *_halo_counts(src, needs))
    return resize.resize_bilinear(ext, dst.h, out_w,
                                  rows=(src.start - top, src.h, dst.start,
                                        dst.stop))


def _band_upsample(field, src: RowBand, dst: RowBand, aw: int, bh: int,
                   bw: int):
    """``nnf.upsample`` of a band of the previous level's field ``field``
    (``src``'s rows) to ``dst``'s rows of the (dst.h, aw) field."""
    ratio = dst.h / src.h
    needs = []
    for j in range(dst.n):
        if not dst.holds(j):
            needs.append(None)
            continue
        y0, y1 = dst.span(j)
        ys = ((torch.arange(y0, y1, dtype=torch.float32) + 0.5) / ratio).int()
        ys = torch.clamp(ys, 0, src.h - 1)
        needs.append((int(ys.min()), int(ys.max())))
    ext, top, _ = src.halo(field, *_halo_counts(src, needs))
    return nnf.upsample(ext, dst.h, aw, bh, bw,
                        rows=(src.start - top, src.h, dst.start, dst.stop))


def _band_pyramid(img_band, full: RowBand, levels: list, widths: list):
    """``image_pyramid`` of a band: each level's rows from the finer
    level's band and a halo."""
    n = len(levels)
    out: list = [None] * n
    last = levels[n - 1]
    out[n - 1] = (img_band if (last.h, widths[n - 1]) == (
        full.h, img_band.shape[-2]) else _band_resize(
            img_band, full, last, widths[n - 1]))
    for l in range(n - 2, -1, -1):
        out[l] = _band_resize(out[l + 1], levels[l + 1], levels[l],
                              widths[l])
    return out


def _band_points(band: RowBand, values, ids):
    """values[..., ids] of a band's rows ``values`` [..., rows, W, C] at
    global flat pixel ids [..., K, M]: each rank fills the ids it holds,
    and each id takes its holder's row."""
    w = values.shape[-2]
    flat = values.reshape(values.shape[:-3] + (-1, values.shape[-1]))
    ids = ids.to(values.device)
    owner = band.owner(ids // w)
    local = torch.where(owner == band.r, ids - band.start * w, 0)
    if not band.rows:                   # a band of zero rows fills none
        mine = values.new_zeros(ids.shape + (flat.shape[-1],))
    else:
        if flat.dim() == 3:
            mine = torch.gather(flat, 1, local.reshape(local.shape[0], -1, 1)
                                .expand(-1, -1, flat.shape[-1])).reshape(
                                    ids.shape + (flat.shape[-1],))
        else:
            mine = flat[local]
        mine = torch.where((owner == band.r)[..., None], mine, 0.0)
    parts = torch.stack(band.all_parts(mine))
    return torch.gather(parts, 0, owner[None, ..., None].expand(
        (1,) + mine.shape))[0]


def _band_setup(model, cnt, stl, draws, config: Config, taps,
                bands: _PairBands):
    """``_setup`` on this rank's bands: the VGG taps, pyramids and Lab of
    the band's rows; k-means on the gathered conv5_1 level."""
    lead = tuple(cnt.shape[:-3])
    c_full, c_levels, c_widths = bands.grids[0]
    s_full, s_levels, s_widths = bands.grids[1]
    cnt, stl = c_full.take(cnt), s_full.take(stl)
    vgg_dtype = _dtype(config.vgg_compute_dtype or config.feature_dtype)
    cnt_feats = model(cnt, taps, vgg_dtype, band=c_full)
    stl_feats = model(stl, taps, vgg_dtype, band=s_full)
    cnt_pyr = _band_pyramid(cnt, c_full, c_levels, c_widths)
    stl_pyr = _band_pyramid(stl, s_full, s_levels, s_widths)
    cnt_lab_unit = bgr_u8_to_lab_u8(cnt).float() / 255.0

    lh, lw = c_levels[0].h, c_widths[0]
    f0n, _ = features.l2_normalize(cnt_feats[taps[0]].float())
    f0n = c_levels[0].gather(f0n)
    init_idx = draws.kmeans_init(lh * lw, config.cluster_num)
    label_map, _ = cluster.kmeans(
        f0n.reshape(lead + (lh * lw, -1)), init_idx,
        num_clusters=config.cluster_num, iters=config.kmeans_iters)
    label_map = label_map.reshape(lead + (lh, lw))
    membership = cluster.cluster_membership(label_map, config.cluster_num)
    return (cnt_feats, stl_feats, cnt_pyr, stl_pyr, cnt_lab_unit, label_map,
            membership)


def _band_level_match(config: Config, l: int, rs: int, draws, bands:
                      _PairBands, bds_weight: float, ann_prev, bnn_prev,
                      cnt_feat_l, stl_feat_l, down_stl, ring: bool):
    """``_level_match`` on this rank's bands: (ann of the content band,
    bnn of the style band, guide and error of the content band).
    ``ann_prev``/``bnn_prev``: the previous level's band fields, or at
    level 0 the whole warm start (or None)."""
    bc, bs = bands.cnt(l), bands.stl(l)
    ah, aw = bc.h, cnt_feat_l.shape[-2]
    bh, bw = bs.h, stl_feat_l.shape[-2]
    fdt = _dtype(config.feature_dtype)
    ps = config.patch_size
    fs = stl_feat_l.float()
    fc_n = features.l2_normalize(cnt_feat_l.float())[0].to(fdt)
    fs_n = features.l2_normalize(fs)[0].to(fdt)
    if l < config.exact_nn_levels and ring:
        ann, _ = ring_band_nn(fc_n, fs_n, bc, bs, ps)
        bnn, _ = ring_band_nn(fs_n, fc_n, bs, bc, ps)
    elif l < config.exact_nn_levels:
        ann, _, bnn, _ = cuda_nn.exact_nn_bidir(bc.gather(fc_n),
                                                bs.gather(fs_n), ps)
        ann, bnn = bc.take(ann), bs.take(bnn)
    else:
        lead = tuple(fc_n.shape[:-3])
        if l > 0:
            ann0 = _band_upsample(ann_prev, bands.cnt(l - 1), bc, aw, bh, bw)
            bnn0 = _band_upsample(bnn_prev, bands.stl(l - 1), bs, bw, ah, aw)
        elif ann_prev is not None:      # video warm start
            ann0, bnn0 = bc.take(ann_prev), bs.take(bnn_prev)
        else:
            # the band's rows of the scaled identity
            ann0 = bc.take(nnf.init_scaled_identity(
                ah, aw, bh, bw, fc_n.device)).expand(lead + (bc.rows, aw, 2))
            bnn0 = bs.take(nnf.init_scaled_identity(
                bh, bw, ah, aw, fc_n.device)).expand(lead + (bs.rows, bw, 2))
        window = config.fine_strategy == "window" and l > 0
        iters = (config.pm_iters_fine if config.exact_nn_levels > 0
                 else config.pm_iters)
        half = ps // 2
        fields = []
        # each band searches the gathered other level
        for direction, own, other, x, y, f0, own_w in (
                ("ab", bc, bs, fc_n, fs_n, ann0, aw),
                ("ba", bs, bc, fs_n, fc_n, bnn0, bw)):
            whole = other.gather(y)
            if window:
                x_ext, top, bottom = own.halo(x, half, half)
                f0_ext = own.halo(f0, half, half)[0]
                fields.append(window_refine(
                    x_ext, whole, f0_ext, config.window_radius,
                    config.window_shortlist, ps,
                    stage1_channels(config, ah * aw, own.h * own_w),
                    halo=(top, bottom), gather_taps=True)[0])
                del x_ext
            else:
                n_mags = max(len(random_search_mags(rs, other.h,
                                                    whole.shape[-2])), 1)
                # the whole field's draws, as the single process draws
                # them (every rank alike), then the band's rows
                u = draws.patchmatch_uniforms(
                    l, direction, (iters, n_mags, own.h, own_w, 2)).narrow(
                        -3, own.start, own.rows)
                fields.append(patchmatch(x, whole, f0, u, iters, rs, ps,
                                         band=own)[0])
                del u
            del whole
        ann, bnn = fields
    guide_bgr = bds.bds_reconstruct_color(bs.gather(down_stl), ann, bnn, 1.0,
                                          bds_weight, ps, bands=(bc, bs))
    voted_feat, _ = bds.bds_vote_band(bs.gather(fs), ann, bnn, bc, bs, 1.0,
                                      bds_weight, ps)
    gf_n, _ = features.l2_normalize(voted_feat)
    return ann, bnn, guide_bgr, features.cosine_error(fc_n, gf_n)


def _band_level_solve(model, config: Config, l: int, numlayer: int, taps,
                      draws, bands: _PairBands, guide_bgr, bds_err, prev_ab,
                      down_cnt, cnt_lab_unit, label_map, membership):
    """``_level_solve`` on this rank's bands."""
    bl, bf = bands.cnt(l), bands.cnt_full
    h, w = bf.h, cnt_lab_unit.shape[-2]
    ah, aw = bl.h, down_cnt.shape[-2]
    ps = config.patch_size

    # k-NN graph on down-res Lab + patch-moment init + confidence
    cnt_lab_u8 = bgr_u8_to_lab_u8(down_cnt)
    cnt_lab_d = cnt_lab_u8.float() / 255.0
    stride = 2 ** l
    if config.knn_memberships > 1:
        pixel_labels = cluster.multi_labels_for_pixels(
            label_map, membership, ah, aw, stride, config.knn_memberships,
            rows=(bl.start, bl.stop))
    else:
        pixel_labels = cluster.labels_for_pixels(label_map, ah, aw, stride,
                                                 rows=(bl.start, bl.stop))
    member_pix = cluster.membership_for_pixels(membership, ah, aw, stride)
    candidates = draws.candidates(l, member_pix, min(2048, ah * aw))
    del member_pix
    nbr_ids, nbr_w, nbr_slots = knn.knn_graph(
        cnt_lab_d, pixel_labels, candidates, k_num=config.k_num,
        cand_colors=_band_points(bl, cnt_lab_d, candidates),
        row0=bl.start * aw, n_total=ah * aw)
    guide_lab_u8 = bgr_u8_to_lab_u8(guide_bgr)
    guide_lab_d = guide_lab_u8.float() / 255.0
    confidence = stats.error_confidence(bds_err, band=bl)

    # nonlocal solve at down-res, warm-started from the previous level
    if prev_ab is not None:
        a0 = _band_resize(prev_ab[0], bands.cnt(l - 1), bl, aw)
        b0 = _band_resize(prev_ab[1], bands.cnt(l - 1), bl, aw)
    else:
        # level 0 alone reads the patch moments, on the conv5_1 grid that
        # k-means gathers too: their integral images round with every row
        # above, so the whole grid gives the single process's bits
        a0, b0 = (bl.take(t) for t in stats.init_ab(
            bl.gather(cnt_lab_u8), bl.gather(guide_lab_u8), ps,
            config.var_epsilon))
        tgt = torch.clamp(cnt_lab_d * a0 + b0, 0.0, 1.0)
        a0 = torch.clamp(a0, 0.0, 2.0)
        b0 = tgt - cnt_lab_d * a0
    final = l == numlayer - 1
    if config.nl_precond == "mg":
        nl_iters = config.cg_iters_final_mg if final else config.cg_iters_mg
    else:
        nl_iters = config.cg_iters_final if final else config.cg_iters
    a_d, b_d, nl_it, nl_r2 = solve_nonlocal(
        a0, b0, cnt_lab_d, guide_lab_d, confidence, nbr_ids, nbr_w,
        float(h * w) / float(ah * aw), config.local_weight, config.wls_alpha,
        config.nonlocal_weight, iters=nl_iters, tol=config.cg_tol,
        candidates=candidates, nbr_slots=nbr_slots,
        precond_kind=config.nl_precond, in_cap=config.nl_in_cap,
        transpose=config.nl_transpose, band=bl)
    del nbr_ids, nbr_w, nbr_slots

    # full-res WLS, apply, convert, re-extract
    lam = config.wls_lambda_init * (float(h * w) / float(ah * aw))
    if (ah, aw) == (h, w):
        lam = lam * 4.0  # final-level boost (ref :1418-1424)
    a_f, b_f, wls_it, wls_r2 = solve_wls(
        _band_resize(a_d, bl, bf, w), _band_resize(b_d, bl, bf, w),
        cnt_lab_unit, lam, config.wls_alpha,
        iters=(config.wls_cg_iters_mg if config.wls_precond == "mg"
               else config.wls_cg_iters),
        tol=config.cg_tol, precond_kind=config.wls_precond, band=bf)
    refined = unit_lab_to_bgr_u8(apply_transform(a_f, b_f, cnt_lab_unit))

    cnt_feat_next = None
    if l < numlayer - 1:
        vgg_dtype = _dtype(config.vgg_compute_dtype or config.feature_dtype)
        cnt_feat_next = model(refined, (taps[l + 1],), vgg_dtype,
                              band=bf)[taps[l + 1]]
    return (refined, cnt_feat_next, a_d, b_d, a_f, b_f, (nl_it, nl_r2),
            (wls_it, wls_r2))


def _run_band_levels(model, config: Config, taps, draws, bds_weight: float,
                     cnt, stl, ann, bnn, record, ring: bool):
    """``_run_levels`` on this rank's row bands (``row_sharded``): every
    stage holds the band's rows, the output rows (and a trace's fields)
    are gathered, so every rank returns the whole result.  ``ann``/``bnn``:
    the whole level-0 warm start or None."""
    numlayer = len(taps)
    ranges = config.pm_search_radii(max(*cnt.shape[-3:-1], *stl.shape[-3:-1]))
    bands = _PairBands(config, taps, tuple(cnt.shape[-3:-1]),
                       tuple(stl.shape[-3:-1]))
    (cnt_feats, stl_feats, cnt_pyr, stl_pyr, cnt_lab_unit, label_map,
     membership) = _band_setup(model, cnt, stl, draws, config, taps, bands)
    del cnt, stl
    refined = None
    cnt_feat_l = cnt_feats[taps[0]]
    trace: list[dict] = []
    prev_ab = coarse_state = None
    for l in range(numlayer):
        ann, bnn, guide_bgr, bds_err = _band_level_match(
            config, l, max(int(ranges[l]), 1), draws, bands, bds_weight, ann,
            bnn, cnt_feat_l, stl_feats[taps[l]], stl_pyr[l], ring)
        (refined, cnt_feat_l, a_d, b_d, a_f, b_f, nl_info,
         wls_info) = _band_level_solve(
            model, config, l, numlayer, taps, draws, bands, guide_bgr,
            bds_err, prev_ab, cnt_pyr[l], cnt_lab_unit, label_map,
            membership)
        prev_ab = (a_d, b_d)
        bc, bs, bf = bands.cnt(l), bands.stl(l), bands.cnt_full
        if l == 0:
            coarse_state = {"ann": bc.gather(ann), "bnn": bs.gather(bnn)}
        if record:
            tr = {"level": l, "nl_iters": nl_info[0], "nl_r2": nl_info[1],
                  "wls_iters": wls_info[0], "wls_r2": wls_info[1]}
            if record != "stats":
                tr.update({"ann": bc.gather(ann), "bnn": bs.gather(bnn),
                           "guide": bc.gather(guide_bgr),
                           "a": bf.gather(a_f), "b": bf.gather(b_f),
                           "bds_err": bc.gather(bds_err, -2),
                           "refined": bf.gather(refined)})
            trace.append(tr)
    return bands.cnt_full.gather(refined), trace, coarse_state


def transfer_pair(
    model: vgg19.VGG19,
    cnt_bgr_u8,
    stl_bgr_u8,
    bds_weight: float,
    config: Config = Config(),
    seed: int = 7,
    draws=None,
    device: torch.device | str | None = None,
    return_intermediates: bool | str = False,
    warm_start: dict | None = None,
    return_state: bool = False,
):
    """Run the full progressive transfer for one image pair.

    model: ``vgg19.VGG19`` (moved to ``device``); cnt/stl: uint8 BGR
    [H, W, 3] arrays or tensors, already capped to max_size.  ``device``
    defaults to the space mesh's device under ``config.space_mesh`` (every
    rank of its space group then calls this with the same pair), else to
    ``cuda``, and raises RuntimeError when no card is present;
    ``device="cpu"`` runs the plain PyTorch path.  ``draws`` supplies the
    k-means initial indices, PatchMatch uniforms and per-level candidates
    (default ``GeneratorDraws(seed)``).

    Returns the uint8 BGR result [H, W, 3] on ``device``; with
    ``return_intermediates`` also a per-level trace list (``"stats"``:
    solver iteration counts and residuals only); with ``return_state`` also
    the level-0 {"ann", "bnn"} for the next frame's ``warm_start``, which
    replaces the scaled-identity init of a level-0 PatchMatch (an exact
    level 0 ignores it).
    """
    check_config(config)
    device = _resolve_device(device, config)
    model = model.to(device)
    if draws is None:
        draws = GeneratorDraws(seed)
    taps = tuple(config.vgg_layers())
    cnt = _as_image(cnt_bgr_u8, device)
    stl = _as_image(stl_bgr_u8, device)
    ann = bnn = None
    if warm_start is not None:
        ann = torch.as_tensor(warm_start["ann"], device=device)
        bnn = torch.as_tensor(warm_start["bnn"], device=device)
    refined, trace, coarse_state = _run_levels(
        model, config, taps, draws, bds_weight, cnt, stl, ann, bnn,
        return_intermediates)

    outs = [refined]
    if return_intermediates:
        outs.append(trace)
    if return_state:
        outs.append(coarse_state)
    return outs[0] if len(outs) == 1 else tuple(outs)


def transfer_batch(
    model: vgg19.VGG19,
    cnt_b,
    stl_b,
    bds_weight: float,
    config: Config,
    seeds,
    device: torch.device | str | None = None,
    return_intermediates: bool | str = False,
    ring_nn: bool = True,
    draws=None,
):
    """Run a bucket of pairs of one geometry as one batched pass.

    cnt_b [B, H, W, 3] / stl_b [B, Hs, Ws, 3]: uint8 BGR arrays or tensors;
    ``seeds`` [B]: item i draws what ``transfer_pair(..., seed=seeds[i])``
    draws.  Every stage runs once over the bucket with a leading batch axis
    (the NN kernel over its batch grid axis, the solves as grouped PCG), so
    item i matches its own ``transfer_pair`` up to summation order, with
    the same solver iteration counts.  It runs every Config that
    ``check_config`` accepts (PatchMatch levels with each item's own
    uniforms, every preconditioner, transpose and membership count, and a
    ``space_mesh``, under which each ring step is one batched launch).
    ``device`` defaults as in ``transfer_pair`` and raises without a card;
    ``device="cpu"`` runs the plain path.  ``ring_nn=False``: under a
    space mesh each rank searches the gathered exact levels itself with
    ``nn_bidir`` instead of through the ring.  ``draws``: the bucket's draws,
    with ``BatchDraws``' methods (default ``BatchDraws(seeds)``).

    Returns the uint8 BGR results [B, H, W, 3] on ``device``; with
    ``return_intermediates`` also one trace list per item, as
    ``transfer_pair`` gives it.
    """
    check_config(config)
    device = _resolve_device(device, config)
    model = model.to(device)
    cnt = _as_image(cnt_b, device)
    stl = _as_image(stl_b, device)
    seeds = [int(s) for s in np.asarray(
        seeds.cpu() if isinstance(seeds, torch.Tensor) else seeds).reshape(-1)]
    if cnt.dim() != 4 or stl.dim() != 4 or not (
            cnt.shape[0] == stl.shape[0] == len(seeds)):
        raise ValueError(f"expected [B, H, W, 3] content and style and B "
                         f"seeds, got {tuple(cnt.shape)}, {tuple(stl.shape)} "
                         f"and {len(seeds)} seeds")
    taps = tuple(config.vgg_layers())
    refined, trace, _ = _run_levels(
        model, config, taps, BatchDraws(seeds) if draws is None else draws,
        bds_weight, cnt, stl, None, None, return_intermediates, ring_nn)
    if not return_intermediates:
        return refined
    items = [[] for _ in seeds]
    for tr in trace:
        iters = {k: tr.pop(k).tolist() for k in ("nl_iters", "wls_iters")}
        level = tr.pop("level")
        for i, item in enumerate(items):
            item.append({"level": level, **{k: v[i] for k, v in tr.items()},
                         **{k: v[i] for k, v in iters.items()}})
    return refined, items


def transfer_sequence(
    model: vgg19.VGG19,
    frames,
    stl_bgr_u8,
    bds_weight: float,
    config: Config = Config(),
    seed: int = 7,
    draws=None,
    device: torch.device | str | None = None,
):
    """Transfer same-size content frames against one style, warm-starting
    each frame's level-0 fields from the previous frame's (the video path).
    One ``draws`` (default ``GeneratorDraws(seed)``) serves every frame in
    turn.  Returns an iterator of the uint8 BGR results on ``device``
    (default ``cuda``; raises here, before the first frame, without a
    card)."""
    device = _resolve_device(device, config)
    if draws is None:
        draws = GeneratorDraws(seed)

    def results():
        state = None
        for frame in frames:
            out, state = transfer_pair(
                model, frame, stl_bgr_u8, bds_weight, config, draws=draws,
                device=device, warm_start=state, return_state=True)
            yield out

    return results()
