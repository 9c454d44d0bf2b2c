"""Loss, metric and synthetic-data layers: the forward passes (port of
``nct_tpu/nn/losses.py``).

  * SoftmaxWithLoss  — softmax_loss_layer.cpp (fused log-softmax + NLL,
    ignore_label, the four NormalizationMode rules with the
    max(1, normalizer) NaN guard)
  * EuclideanLoss    — euclidean_loss_layer.cpp (sum of squares / 2N)
  * SigmoidCrossEntropyLoss — sigmoid_cross_entropy_loss_layer.cpp (the
    numerically-stable form, normalized by batch size)
  * HingeLoss        — hinge_loss_layer.cpp (L1/L2 norms)
  * MultinomialLogisticLoss, InfogainLoss, ContrastiveLoss, Accuracy
  * SmoothL1Loss and the R-FCN OHEM losses
  * DummyData        — dummy_data_layer.cpp (filler-driven synthetic tops)

Blobs are NCHW, so the class axis is axis 1 as written in the prototxt;
labels arrive as any blob with outer*inner elements, flattened in
(n, h, w) order as Caffe's (outer_num_, inner_num_) loop walks them.
Losses return 0-d float32 tensors.  Backward passes wait for the training
slice of the port.
"""

from __future__ import annotations

import zlib

import torch
import torch.nn.functional as F

from nct_tpu_torch.nn.fillers import fill
from nct_tpu_torch.nn.layers import _axis, register_layer

# Types whose top[0] receives an implicit loss_weight of 1: every type
# containing "Loss" (loss_layer.cpp set_loss(0, 1); the R-FCN OHEM losses
# end in "LossOHEM"; BoxAnnotatorOHEM is not a loss layer).
LOSS_SUFFIX = "Loss"


def is_loss_type(ltype: str) -> bool:
    return LOSS_SUFFIX in ltype


def _norm_mode(lp: dict) -> str:
    norm = lp.get("normalization")
    if norm is None and "normalize" in lp:
        # deprecated bool: true -> VALID, false -> BATCH_SIZE (caffe.proto)
        norm = "VALID" if lp.get("normalize") else "BATCH_SIZE"
    return str(norm or "VALID").upper()


def _loss_param(cfg):
    lp = cfg.get("loss_param", {}) or {}
    ignore = lp.get("ignore_label")
    return (None if ignore is None else int(ignore)), _norm_mode(lp)


def _flat_scores_labels(cfg, scores, labels, param_key):
    """[outer*inner, C] scores and int64 [outer*inner] labels."""
    axis = cfg.get(param_key, {}).get("axis", 1)
    c = torch.movedim(scores, _axis(axis, scores.dim()), -1)
    return c.reshape(-1, c.shape[-1]), labels.reshape(-1).long()


def _normalizer(norm: str, valid_count, outer: int, inner: int):
    if norm == "FULL":
        n = float(outer * inner)
    elif norm == "BATCH_SIZE":
        n = float(outer)
    elif norm == "NONE":
        n = 1.0
    else:  # VALID
        return torch.clamp(valid_count, min=1.0)
    return max(n, 1.0)  # the reference's NaN guard


def _softmax_nll(cfg, scores, labels):
    """(log-probs [M, C], nll [M], mask [M]) of the SoftmaxWithLoss math."""
    ignore, _ = _loss_param(cfg)
    flat, lab = _flat_scores_labels(cfg, scores, labels, "softmax_param")
    logp = F.log_softmax(flat.float(), dim=-1)
    safe = torch.clamp(lab, 0, flat.shape[-1] - 1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    mask = (torch.ones_like(nll) if ignore is None
            else (lab != ignore).float())
    return logp, nll, mask


@register_layer("SoftmaxWithLoss")
def softmax_with_loss_layer(params, cfg, scores, labels):
    _, norm = _loss_param(cfg)
    _, nll, mask = _softmax_nll(cfg, scores, labels)
    outer = scores.shape[0]
    inner = nll.shape[0] // outer
    return (nll * mask).sum() / _normalizer(norm, mask.sum(), outer, inner)


@register_layer("MultinomialLogisticLoss")
def multinomial_logistic_loss_layer(params, cfg, probs, labels):
    """-log(p[label]) averaged over the batch; the input is already a
    probability distribution (kLOG_THRESHOLD = 1e-20)."""
    flat, lab = _flat_scores_labels(cfg, probs, labels, "softmax_param")
    p = flat.gather(1, lab[:, None])[:, 0].float()
    return -torch.log(torch.clamp(p, min=1e-20)).sum() / float(probs.shape[0])


@register_layer("EuclideanLoss")
def euclidean_loss_layer(params, cfg, a, b):
    diff = a.float() - b.float()
    return (diff * diff).sum() / (2.0 * a.shape[0])


@register_layer("SigmoidCrossEntropyLoss")
def sigmoid_cross_entropy_loss_layer(params, cfg, x, t):
    x = x.float()
    t = t.float()
    # stable form: x*(t - (x>=0)) - log(1 + exp(x - 2x*(x>=0)))
    pos = (x >= 0).float()
    per = x * (t - pos) - torch.log1p(torch.exp(x - 2.0 * x * pos))
    return -per.sum() / float(x.shape[0])


@register_layer("HingeLoss")
def hinge_loss_layer(params, cfg, scores, labels):
    norm = str(cfg.get("hinge_loss_param", {}).get("norm", "L1")).upper()
    num = scores.shape[0]
    flat = scores.reshape(num, -1).float()
    lab = labels.reshape(-1).long()
    sign = 1.0 - 2.0 * F.one_hot(lab, flat.shape[1]).float()
    h = torch.clamp(1.0 + sign * flat, min=0.0)
    if norm == "L2":
        return (h * h).sum() / float(num)
    return h.sum() / float(num)


@register_layer("Accuracy")
def accuracy_layer(params, cfg, scores, labels):
    ap = cfg.get("accuracy_param", {}) or {}
    top_k = int(ap.get("top_k", 1))
    ignore = ap.get("ignore_label")
    flat, lab = _flat_scores_labels(cfg, scores, labels, "accuracy_param")
    idx = torch.topk(flat, top_k, dim=-1).indices
    hit = (idx == lab[:, None]).any(dim=-1).float()
    mask = (torch.ones_like(hit) if ignore is None
            else (lab != int(ignore)).float())
    return (hit * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@register_layer("ContrastiveLoss")
def contrastive_loss_layer(params, cfg, a, b, y):
    """Siamese-pair margin loss (contrastive_loss_layer.cpp:30-62):
    d2 = ||a_i - b_i||^2; similar pairs (y=1) contribute d2, dissimilar
    pairs max(margin - d, 0)^2 — or max(margin - d2, 0) with
    legacy_version — summed over the batch and divided by 2N."""
    cp = cfg.get("contrastive_loss_param", {}) or {}
    margin = float(cp.get("margin", 1.0))
    legacy = cp.get("legacy_version") in (True, "true")
    num = a.shape[0]
    diff = a.reshape(num, -1).float() - b.reshape(num, -1).float()
    d2 = (diff * diff).sum(dim=1)
    sim = y.reshape(-1).long() != 0
    if legacy:
        dis = torch.clamp(margin - d2, min=0.0)
    else:
        dis = torch.clamp(margin - torch.sqrt(d2), min=0.0) ** 2
    return torch.where(sim, d2, dis).sum() / (2.0 * num)


@register_layer("InfogainLoss")
def infogain_loss_layer(params, cfg, probs, labels, *rest):
    """Infogain-weighted multinomial loss (infogain_loss_layer.cpp
    Forward_cpu): loss = -sum_i sum_j H[label_i, j] * log(max(p_ij, 1e-20))
    / N.  H comes from the optional third bottom, from params["H"], or
    defaults to identity (= MultinomialLogisticLoss)."""
    flat = probs.reshape(probs.shape[0], -1).float()
    lab = labels.reshape(-1).long()
    dim = flat.shape[1]
    if rest:
        h = rest[0].reshape(dim, dim).float()
    elif "H" in params:
        h = params["H"].reshape(dim, dim).float()
    else:
        h = torch.eye(dim, device=flat.device)
    rows = h[lab]                                       # [N, dim]
    logp = torch.log(torch.clamp(flat, min=1e-20))
    return -(rows * logp).sum() / float(flat.shape[0])


def _smooth_l1(pred, target, weights, sigma2: float):
    d = pred.float() - target.float()
    if weights:
        d = d * weights[0].float()
    ad = torch.abs(d)
    return torch.where(ad < 1.0 / sigma2, 0.5 * d * d * sigma2,
                       ad - 0.5 / sigma2)


@register_layer("SmoothL1Loss")
def smooth_l1_loss_layer(params, cfg, pred, target, *weights):
    """Fast R-CNN bounding-box loss (smooth_l1_loss_layer.cu:10-57):
    d = w_in * (pred - target);
    f(d) = 0.5 (sigma d)^2 if |d| < 1/sigma^2 else |d| - 0.5/sigma^2;
    loss = sum(w_out * f(d)) / num.  Optional bottoms 3/4 are the
    inside/outside weights."""
    p = cfg.get("smooth_l1_loss_param", {}) or {}
    sigma = float(p.get("sigma", 1.0))
    err = _smooth_l1(pred, target, weights, sigma * sigma)
    if len(weights) > 1:
        err = err * weights[1].float()
    return err.sum() / float(pred.shape[0])


@register_layer("SmoothL1LossOHEM")
def smooth_l1_loss_ohem_layer(params, cfg, pred, target, *weights):
    """R-FCN OHEM variant (smooth_L1_loss_ohem_layer.cu:47-85): fixed
    sigma=1 smooth-L1 with an optional single weights bottom multiplied
    into the diff, LossParameter normalization modes (incl. PRE_FIXED),
    and a second top carrying the per-position channel-summed loss
    [N, 1, H, W] that BoxAnnotatorOHEM ranks."""
    lp = cfg.get("loss_param", {}) or {}
    norm = _norm_mode(lp)
    err = _smooth_l1(pred, target, weights[:1], 1.0)
    outer = pred.shape[0]
    inner = pred.numel() // (outer * pred.shape[1])    # H*W
    if norm == "BATCH_SIZE":
        n = float(outer)
    elif norm == "PRE_FIXED":
        n = float(lp.get("pre_fixed_normalizer", 1.0))
    elif norm == "NONE":
        n = 1.0
    else:  # FULL and VALID both normalize by outer*inner (ref :67-72)
        n = float(outer * inner)
    return err.sum() / max(n, 1.0), err.sum(dim=1, keepdim=True)


@register_layer("SoftmaxWithLossOHEM")
def softmax_with_loss_ohem_layer(params, cfg, scores, labels):
    """R-FCN OHEM softmax loss (softmax_loss_ohem_layer.cu:30-68): the
    SoftmaxWithLoss math plus two extra tops — the softmax probabilities
    (top[1]) and the per-position unnormalized NLL map (top[2]; zero at
    ignored labels) that BoxAnnotatorOHEM ranks."""
    _, norm = _loss_param(cfg)
    logp, nll, mask = _softmax_nll(cfg, scores, labels)
    outer = scores.shape[0]
    inner = nll.shape[0] // outer
    loss = (nll * mask).sum() / _normalizer(norm, mask.sum(), outer, inner)
    axis = _axis(cfg.get("softmax_param", {}).get("axis", 1), scores.dim())
    moved = torch.movedim(scores, axis, -1).shape
    prob = torch.movedim(torch.exp(logp).reshape(moved), -1, axis)
    return loss, prob, (nll * mask).reshape(labels.shape)


def _dims(v) -> list[int]:
    return [int(x) for x in (v if isinstance(v, list) else [v])]


@register_layer("DummyData")
def dummy_data_layer(params, cfg, *unused):
    """Filler-driven synthetic tops (dummy_data_layer.cpp), shaped as the
    prototxt writes them.  Non-constant fillers draw from a CPU generator
    seeded by the layer name: the same values on every forward and every
    device (the reference refills from a global RNG each forward; Caffe's
    own solver tests only rely on the values being fixed once seeded).
    The Net moves the tops to its device."""
    ddp = cfg.get("dummy_data_param", {}) or {}
    shapes = ddp.get("shape", [])
    if not isinstance(shapes, list):
        shapes = [shapes]
    if shapes:
        dims = [_dims(s.get("dim", [])) for s in shapes]
    else:  # legacy num/channels/height/width fields
        fields = [_dims(ddp.get(k, 1))
                  for k in ("num", "channels", "height", "width")]
        k = max(map(len, fields))
        dims = [[f[i] if i < len(f) else f[-1] for f in fields]
                for i in range(k)]
    fillers = ddp.get("data_filler", [])
    if not isinstance(fillers, list):
        fillers = [fillers]
    name = str(cfg.get("name", "dummy"))
    outs = []
    for i, dim in enumerate(dims):
        spec = fillers[i] if i < len(fillers) else (
            fillers[0] if fillers else None)
        gen = torch.Generator().manual_seed(zlib.crc32(f"{name}/{i}".encode()))
        outs.append(fill(gen, spec, tuple(dim)))
    return outs if len(outs) > 1 else outs[0]
