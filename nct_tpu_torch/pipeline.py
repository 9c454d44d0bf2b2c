"""Progressive colour-transfer pipeline: the 5-level coarse-to-fine loop
(port of ``nct_tpu/pipeline.py::transfer_pair``).

Per level (conv5_1 -> conv1_1):

  1. correspondence search: exact bidirectional patch NN at levels
     [0, exact_nn_levels) (the CUDA kernel on the card), window refine of
     the upsampled fields above;
  2. BDS colour guidance + BDS feature vote -> matching error;
  3. semantic k-NN graph on down-res Lab colours;
  4. patch-moment (a, b) init + confidence;
  5. nonlocal multigrid-PCG solve at down-res;
  6. bilinear coefficient upsample + roughness gate + multigrid-PCG WLS;
  7. apply a*Lab+b at full res, Lab -> BGR;
  8. re-extract the next level's VGG tap from the refined image.

Randomness enters only through ``draws`` (k-means initial centres and each
level's cluster candidates); by default a ``torch.Generator`` seeded from
``seed`` supplies them.
"""

from __future__ import annotations

import numpy as np
import torch

from nct_tpu_torch.config import Config
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops import bds, cuda_nn, features, nnf, resize
from nct_tpu_torch.ops.color import bgr_u8_to_lab_u8, unit_lab_to_bgr_u8
from nct_tpu_torch.ops.window_refine import window_refine
from nct_tpu_torch.solve import cluster, knn, stats
from nct_tpu_torch.solve.nonlocal_solve import solve_nonlocal
from nct_tpu_torch.solve.wls import apply_transform, solve_wls

# Level-pixel count above which the window refine ranks stage 1 on
# Config.window_stage1_channels_maxsize channels when
# Config.window_stage1_channels is 0 (the JAX package's MAX_SIZE path).
STAGE1_SUBSET_PIXELS = 320_000


class GeneratorDraws:
    """Default draws: k-means initial indices and per-level candidate
    scores from one ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def kmeans_init(self, n: int, num_clusters: int) -> torch.Tensor:
        return cluster.draw_kmeans_init(n, num_clusters, self.generator)

    def candidates(self, level: int, membership_pix: torch.Tensor,
                   m: int) -> torch.Tensor:
        k = membership_pix.shape[0]
        n = membership_pix.shape[1] * membership_pix.shape[2]
        scores = torch.rand((k, n), generator=self.generator)
        return knn.sample_cluster_candidates(membership_pix, scores, m)


def check_config(config: Config) -> None:
    """Raise NotImplementedError for Config values the port does not run."""
    todo = "not ported yet (ROADMAP Queue 1 #13)"
    left_out = "not ported yet (ROADMAP Queue 1, left out of items 1-11)"
    for l in range(len(config.vgg_layers())):
        exact = l < config.exact_nn_levels
        window = config.fine_strategy == "window" and l > 0
        if not (exact or window):
            raise NotImplementedError(
                f"level {l} would run PatchMatch (fine_strategy="
                f"{config.fine_strategy!r}, exact_nn_levels="
                f"{config.exact_nn_levels}): PatchMatch is {todo}")
    if config.knn_memberships != 1:
        raise NotImplementedError(
            f"knn_memberships={config.knn_memberships}: the multi-membership "
            f"k-NN merge is {left_out}")
    if config.space_mesh is not None:
        raise NotImplementedError(
            f"space_mesh: the space-sharded ring search is {todo}")
    if config.nl_precond != "mg" or config.wls_precond != "mg":
        raise NotImplementedError(
            f"nl_precond={config.nl_precond!r} / wls_precond="
            f"{config.wls_precond!r}: only the multigrid preconditioner is "
            f"ported; the Jacobi variants are {left_out}")
    if config.nl_transpose == "scatter":
        raise NotImplementedError(
            f"nl_transpose='scatter' is {left_out}")
    if config.feature_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"feature_dtype={config.feature_dtype!r}")


def image_pyramid(img_u8: torch.Tensor,
                  dims: list[tuple[int, int]]) -> list[torch.Tensor]:
    """Cascaded INTER_LINEAR pyramid: each level resized from the next finer
    one; the finest level is the image itself when the dims match."""
    n = len(dims)
    out: list = [None] * n
    h, w = dims[n - 1]
    out[n - 1] = (img_u8 if tuple(img_u8.shape[:2]) == (h, w)
                  else resize.resize_bilinear(img_u8, h, w))
    for l in range(n - 2, -1, -1):
        h, w = dims[l]
        out[l] = resize.resize_bilinear(out[l + 1], h, w)
    return out


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _setup(model, cnt, stl, draws, config: Config, taps):
    """Feature extraction, pyramids, content Lab and semantic clusters."""
    h, w = cnt.shape[0], cnt.shape[1]
    hs, ws = stl.shape[0], stl.shape[1]
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
        f0n.reshape(lh * lw, -1), init_idx,
        num_clusters=config.cluster_num, iters=config.kmeans_iters)
    label_map = label_map.reshape(lh, lw)
    membership = cluster.cluster_membership(label_map, config.cluster_num)
    return (cnt_feats, stl_feats, cnt_pyr, stl_pyr, cnt_lab_unit, label_map,
            membership)


def _stage1_channels(config: Config, pixels: int) -> int:
    if config.window_stage1_channels == 0 and pixels > STAGE1_SUBSET_PIXELS:
        return config.window_stage1_channels_maxsize
    return config.window_stage1_channels


def _level_match(config: Config, l: int, bds_weight: float, ann_prev,
                 bnn_prev, cnt_feat_l, stl_feat_l, down_stl):
    """Correspondence search + BDS guidance.  Returns (ann, bnn, guide_bgr,
    bds_err)."""
    ah, aw = cnt_feat_l.shape[0], cnt_feat_l.shape[1]
    bh, bw = down_stl.shape[0], down_stl.shape[1]
    fdt = _dtype(config.feature_dtype)
    ps = config.patch_size
    fs = stl_feat_l.float()
    fc_n = features.l2_normalize(cnt_feat_l.float())[0].to(fdt)
    fs_n = features.l2_normalize(fs)[0].to(fdt)
    if l < config.exact_nn_levels:
        ann, _, bnn, _ = cuda_nn.exact_nn_bidir(fc_n, fs_n, ps)
    else:
        ann0 = nnf.upsample(ann_prev, ah, aw, bh, bw)
        bnn0 = nnf.upsample(bnn_prev, bh, bw, ah, aw)
        ann, _ = window_refine(
            fc_n, fs_n, ann0, config.window_radius, config.window_shortlist,
            ps, _stage1_channels(config, ah * aw))
        bnn, _ = window_refine(
            fs_n, fc_n, bnn0, config.window_radius, config.window_shortlist,
            ps, _stage1_channels(config, bh * bw))

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
    h, w = cnt_lab_unit.shape[0], cnt_lab_unit.shape[1]
    ah, aw = down_cnt.shape[0], down_cnt.shape[1]
    ps = config.patch_size

    # k-NN graph on down-res Lab + patch-moment init + confidence
    cnt_lab_u8 = bgr_u8_to_lab_u8(down_cnt)
    cnt_lab_d = cnt_lab_u8.float() / 255.0
    stride = 2 ** l
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
    a_d, b_d, nl_it, nl_r2 = solve_nonlocal(
        a0, b0, cnt_lab_d, guide_lab_d, confidence, nbr_ids, nbr_w,
        float(h * w) / float(ah * aw), config.local_weight, config.wls_alpha,
        config.nonlocal_weight,
        iters=config.cg_iters_final_mg if final else config.cg_iters_mg,
        tol=config.cg_tol, candidates=candidates, nbr_slots=nbr_slots,
        in_cap=config.nl_in_cap)

    # full-res WLS, apply, convert, re-extract
    lam = config.wls_lambda_init * float(h * w) / float(ah * aw)
    if (ah, aw) == (h, w):
        lam = lam * 4.0  # final-level boost (ref :1418-1424)
    a_f, b_f, wls_it, wls_r2 = solve_wls(
        resize.resize_bilinear(a_d, h, w), resize.resize_bilinear(b_d, h, w),
        cnt_lab_unit, lam, config.wls_alpha, iters=config.wls_cg_iters_mg,
        tol=config.cg_tol)
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
    defaults to the model's.  ``draws`` supplies k-means initial indices
    and per-level candidates (default ``GeneratorDraws(seed)``).

    Returns the uint8 BGR result [H, W, 3] on ``device``; with
    ``return_intermediates`` also a per-level trace list (``"stats"``:
    solver iteration counts and residuals only); with ``return_state`` also
    the level-0 {"ann", "bnn"} for the next frame's ``warm_start``.
    """
    check_config(config)
    if device is None:
        device = next(model.parameters()).device
    device = torch.device(device)
    model = model.to(device)
    if draws is None:
        draws = GeneratorDraws(seed)
    taps = tuple(config.vgg_layers())
    numlayer = len(taps)
    cnt = _as_image(cnt_bgr_u8, device)
    stl = _as_image(stl_bgr_u8, device)

    (cnt_feats, stl_feats, cnt_pyr, stl_pyr, cnt_lab_unit, label_map,
     membership) = _setup(model, cnt, stl, draws, config, taps)

    ann = bnn = None
    if warm_start is not None:
        ann = torch.as_tensor(warm_start["ann"], device=device)
        bnn = torch.as_tensor(warm_start["bnn"], device=device)
    refined = cnt
    cnt_feat_l = cnt_feats[taps[0]]
    trace: list[dict] = []
    prev_ab = None
    coarse_state = None
    for l in range(numlayer):
        ann, bnn, guide_bgr, bds_err = _level_match(
            config, l, bds_weight, ann, bnn, cnt_feat_l, stl_feats[taps[l]],
            stl_pyr[l])
        (refined, cnt_feat_l, a_d, b_d, a_f, b_f, nl_info,
         wls_info) = _level_solve(
            model, config, l, numlayer, taps, draws, guide_bgr, bds_err,
            prev_ab, cnt_pyr[l], cnt_lab_unit, label_map, membership)
        prev_ab = (a_d, b_d)
        if l == 0:
            coarse_state = {"ann": ann, "bnn": bnn}
        if return_intermediates:
            tr = {"level": l, "nl_iters": nl_info[0], "nl_r2": nl_info[1],
                  "wls_iters": wls_info[0], "wls_r2": wls_info[1]}
            if return_intermediates != "stats":
                tr.update({"ann": ann, "bnn": bnn, "guide": guide_bgr,
                           "a": a_f, "b": b_f, "bds_err": bds_err,
                           "refined": refined})
            trace.append(tr)

    outs = [refined]
    if return_intermediates:
        outs.append(trace)
    if return_state:
        outs.append(coarse_state)
    return outs[0] if len(outs) == 1 else tuple(outs)
