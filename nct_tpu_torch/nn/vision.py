"""R-FCN / detection vision ops: ROIPooling, PSROIPooling, BoxAnnotatorOHEM
(port of ``nct_tpu/nn/vision.py``).

Rebuilds the Microsoft-fork detection layers (reference:
src/caffe/layers/roi_pooling_layer.cpp — Fast R-CNN max ROI pooling —
psroi_pooling_layer.cu — R-FCN position-sensitive average pooling — and
box_annotator_ohem_layer.cu — online hard example mining).

Each ROI's bins are evaluated as separable masked reductions over the
whole feature map, as in the JAX package: a [ph, H] row-membership mask
and a [pw, W] column mask turn every bin max/mean into two reductions,
batched over the ROIs.  The bin arithmetic is the reference's (floor/ceil,
clipping, empty bins 0), in float32 as the JAX package computes it.
"""

from __future__ import annotations

import torch

from nct_tpu_torch.nn.layers import register_layer


def _bin_masks(size_f, n_bins: int, lo_off, limit: int,
               add_before_floor: bool) -> torch.Tensor:
    """[R, n_bins, limit] membership masks for the reference's bin rule:
    start_i = floor(i * bin + off), end_i = ceil((i+1) * bin + off),
    clipped to [0, limit].  ``add_before_floor`` matches the two kernels'
    differing order (ROI pooling floors the product then adds the int
    start; PSROI adds the float start before flooring).  ``size_f`` and
    ``lo_off`` are [R] tensors."""
    i = torch.arange(n_bins, dtype=torch.float32, device=size_f.device)
    size_f, lo_off = size_f[:, None], lo_off[:, None]
    if add_before_floor:
        s = torch.floor(i * size_f + lo_off)
        e = torch.ceil((i + 1.0) * size_f + lo_off)
    else:
        s = torch.floor(i * size_f) + lo_off
        e = torch.ceil((i + 1.0) * size_f) + lo_off
    s = torch.clamp(s, 0, limit)
    e = torch.clamp(e, 0, limit)
    pos = torch.arange(limit, dtype=torch.float32, device=size_f.device)
    return (pos >= s[..., None]) & (pos < e[..., None])


@register_layer("ROIPooling")
def roi_pooling_layer(params, cfg, x, rois):
    """Fast R-CNN ROI max pooling (roi_pooling_layer.cpp:41-120):
    x [N, C, H, W], rois [R, 5] rows (batch_idx, x1, y1, x2, y2) in
    original-image coordinates scaled by spatial_scale.  Output
    [R, C, ph, pw]; empty bins are 0."""
    p = cfg.get("roi_pooling_param", {}) or {}
    ph = int(p.get("pooled_h"))
    pw = int(p.get("pooled_w"))
    ss = float(p.get("spatial_scale", 1.0))
    h, w = x.shape[2], x.shape[3]
    r = rois.reshape(-1, 5).float()
    xs, ys = torch.round(r[:, 1] * ss), torch.round(r[:, 2] * ss)
    xe, ye = torch.round(r[:, 3] * ss), torch.round(r[:, 4] * ss)
    rh = torch.clamp(ye - ys + 1.0, min=1.0)
    rw = torch.clamp(xe - xs + 1.0, min=1.0)
    mh = _bin_masks(rh / ph, ph, ys, h, add_before_floor=False)  # [R, ph, H]
    mw = _bin_masks(rw / pw, pw, xs, w, add_before_floor=False)  # [R, pw, W]
    feat = x.index_select(0, r[:, 0].long())                     # [R, C, H, W]
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    # separable masked max: columns first, then rows
    col = torch.where(mw[:, :, None, None, :], feat[:, None], neg
                      ).amax(dim=-1)                              # [R, pw, C, H]
    out = torch.where(mh[:, :, None, None, :], col[:, None], neg
                      ).amax(dim=-1)                              # [R, ph, pw, C]
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out.permute(0, 3, 1, 2)


@register_layer("PSROIPooling")
def psroi_pooling_layer(params, cfg, x, rois):
    """R-FCN position-sensitive average ROI pooling
    (psroi_pooling_layer.cu PSROIPoolingForward): x [N, output_dim *
    group_size^2, H, W], rois [R, 5].  Output bin (i, j) of output channel
    k averages input channel (k*gs + i)*gs + j over the bin.  ROI edges:
    start = round(coord) * scale, end = round(coord + 1) * scale; too-small
    ROIs forced to 0.1 extent; empty bins 0.  Output [R, output_dim, gs,
    gs]."""
    p = cfg.get("psroi_pooling_param", {}) or {}
    out_dim = int(p.get("output_dim"))
    gs = int(p.get("group_size"))
    ss = float(p.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    if c != out_dim * gs * gs:
        raise ValueError(f"PSROIPooling: {c} channels, expected "
                         f"output_dim * group_size^2 = {out_dim * gs * gs}")
    r = rois.reshape(-1, 5).float()
    xs = torch.round(r[:, 1]) * ss
    ys = torch.round(r[:, 2]) * ss
    xe = torch.round(r[:, 3] + 1.0) * ss
    ye = torch.round(r[:, 4] + 1.0) * ss
    rh = torch.clamp(ye - ys, min=0.1)
    rw = torch.clamp(xe - xs, min=0.1)
    mh = _bin_masks(rh / gs, gs, ys, h, add_before_floor=True).float()
    mw = _bin_masks(rw / gs, gs, xs, w, add_before_floor=True).float()
    feat = x.index_select(0, r[:, 0].long()).float().reshape(
        -1, out_dim, gs, gs, h, w)
    # output cell (i, j) reads input channel block [:, i, j]: the column
    # sum bins w for kernel column j, the row sum bins h for kernel row i
    col = torch.einsum("rjw,rkijhw->rkijh", mw, feat)
    out = torch.einsum("rih,rkijh->rkij", mh, col)
    area = mh.sum(dim=2)[:, :, None] * mw.sum(dim=2)[:, None, :]  # [R, gs, gs]
    area = area[:, None]
    return torch.where(area > 0, out / torch.clamp(area, min=1.0),
                       torch.zeros_like(out))


@register_layer("BoxAnnotatorOHEM")
def box_annotator_ohem_layer(params, cfg, rois, per_roi_loss, labels,
                             bbox_loss_weights):
    """R-FCN online hard example mining (box_annotator_ohem_layer.cu:16-75):
    keep the ``roi_per_img`` highest-loss ROIs of each image; everything
    else gets label = ignore_label and zero bbox loss weights.

    Bottoms, ROIs along axis 0 and then the trailing spatial axes: rois
    [N, 5, ...] (channel 0 = image batch index), per-ROI loss [N, 1, ...],
    labels [N, 1, ...], bbox loss weights [N, C, ...].  Tops: (hard-example
    labels, gated bbox weights).

    The per-image rank has static shapes, as in the JAX package: sort ROIs
    by loss (descending), then stably by image id, so each image's ROIs
    are contiguous in loss order; the rank within the group is ``arange -
    cummax(group start)``, and rank < roi_per_img keeps the ROI."""
    p = cfg.get("box_annotator_ohem_param", {}) or {}
    roi_per_img = int(p.get("roi_per_img"))
    ignore_label = float(p.get("ignore_label", -1))

    r = rois.numel() // rois.shape[1]
    batch_ind = rois[:, 0].reshape(r).long()
    loss = per_roi_loss.reshape(r).float()

    order = torch.argsort(-loss, stable=True)             # loss desc
    b_ord = batch_ind[order]
    order2 = torch.argsort(b_ord, stable=True)            # group by image,
    b_sorted = b_ord[order2]                              # loss order kept
    idx = torch.arange(r, device=rois.device)
    change = torch.ones(r, dtype=torch.bool, device=rois.device)
    change[1:] = b_sorted[1:] != b_sorted[:-1]
    group_start = torch.cummax(torch.where(change, idx, 0), dim=0).values
    keep = torch.zeros(r, dtype=torch.bool, device=rois.device)
    keep[order[order2]] = (idx - group_start) < roi_per_img

    top_labels = torch.where(keep.reshape(labels.shape), labels,
                             torch.full_like(labels, ignore_label))
    w = bbox_loss_weights
    keep_w = keep.reshape((w.shape[0], 1) + tuple(w.shape[2:]))
    return top_labels, torch.where(keep_w, w, torch.zeros_like(w))
