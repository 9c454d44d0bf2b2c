"""The six Caffe solver update rules over parameter trees (port of
``nct_tpu/train/optimizers.py``).

Reference: src/caffe/solvers/{sgd,nesterov,adagrad,rmsprop,adadelta,adam}_
solver.cpp.  A tree is a tensor or a dict of trees ({layer: {blob:
tensor}} for a Net); each optimizer is (init, update) over trees, and
update returns (new_params, new_state), new tensors under
``torch.no_grad()``.  Gradient clipping (ClipGradients), iter_size
normalisation (Normalize) and L2 weight decay (Regularize) come first, in
that order.  Caffe's conventions hold: SGD's history is the step it
applied, and Adam folds both bias corrections into one rate.  The state
has the JAX state's tree shape ({"h": tree}, {"m": tree, "v": tree}, ...),
so snapshots carry across.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptimizerParams:
    solver_type: str = "sgd"   # sgd|nesterov|adagrad|rmsprop|adadelta|adam
    momentum: float = 0.9      # also Adam beta1, AdaDelta decay
    momentum2: float = 0.999   # Adam beta2
    delta: float = 1e-8        # adagrad/rmsprop/adadelta/adam epsilon
    rms_decay: float = 0.99
    weight_decay: float = 0.0
    clip_gradients: float = -1.0
    iter_size: int = 1


def tree_map(f, *trees):
    """``f`` over the leaves of trees of one structure (dicts by key)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in trees[0]}
    return f(*trees)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order, as ``jax.tree_util.tree_leaves``."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _global_norm(grads) -> torch.Tensor:
    total = None
    for g in tree_leaves(grads):
        s = torch.sum(g.float() ** 2)
        total = s if total is None else total + s
    return torch.sqrt(total)


def preprocess_grads(p: OptimizerParams, params, grads):
    """clip (ClipGradients) -> normalize (iter_size) -> L2 decay
    (Regularize)."""
    if p.clip_gradients > 0:
        norm = _global_norm(grads)
        scale = torch.where(norm > p.clip_gradients, p.clip_gradients / norm,
                            torch.ones_like(norm))
        grads = tree_map(lambda g: g * scale, grads)
    if p.iter_size != 1:
        grads = tree_map(lambda g: g / p.iter_size, grads)
    if p.weight_decay:
        grads = tree_map(lambda g, w: g + p.weight_decay * w, grads, params)
    return grads


def make_optimizer(p: OptimizerParams):
    """(init_fn(params) -> state, update_fn(params, grads, state, lr, it)
    -> (params, state)); ``lr`` a scalar (0-d float32 tensor or float),
    ``it`` the 0-based iteration."""
    def zeros(params):
        return tree_map(lambda w: torch.zeros_like(w).detach(), params)

    if p.solver_type not in ("sgd", "nesterov", "adagrad", "rmsprop",
                             "adadelta", "adam"):
        raise ValueError(f"unknown solver_type {p.solver_type!r}")

    def init(params):
        if p.solver_type == "adadelta":
            return {"h": zeros(params), "h2": zeros(params)}
        if p.solver_type == "adam":
            return {"m": zeros(params), "v": zeros(params)}
        return {"h": zeros(params)}

    @torch.no_grad()
    def update(params, grads, state, lr, it):
        grads = preprocess_grads(p, params, grads)
        kind = p.solver_type
        if kind == "sgd":
            h = tree_map(lambda hi, g: p.momentum * hi + lr * g,
                         state["h"], grads)
            return tree_map(lambda w, hi: w - hi, params, h), {"h": h}
        if kind == "nesterov":
            h = tree_map(lambda hi, g: p.momentum * hi + lr * g,
                         state["h"], grads)
            step = tree_map(lambda hn, ho: (1.0 + p.momentum) * hn
                            - p.momentum * ho, h, state["h"])
            return tree_map(lambda w, s: w - s, params, step), {"h": h}
        if kind in ("adagrad", "rmsprop"):
            if kind == "adagrad":
                h = tree_map(lambda hi, g: hi + g * g, state["h"], grads)
            else:
                h = tree_map(lambda hi, g: p.rms_decay * hi
                             + (1 - p.rms_decay) * g * g, state["h"], grads)
            params = tree_map(
                lambda w, g, hi: w - lr * g / (torch.sqrt(hi) + p.delta),
                params, grads, h)
            return params, {"h": h}
        if kind == "adadelta":
            mu = p.momentum
            h = tree_map(lambda hi, g: mu * hi + (1 - mu) * g * g,
                         state["h"], grads)
            step = tree_map(lambda g, hi, h2i: g * torch.sqrt(
                (h2i + p.delta) / (hi + p.delta)), grads, h, state["h2"])
            h2 = tree_map(lambda h2i, s: mu * h2i + (1 - mu) * s * s,
                          state["h2"], step)
            return (tree_map(lambda w, s: w - lr * s, params, step),
                    {"h": h, "h2": h2})
        b1, b2 = p.momentum, p.momentum2                       # adam
        t = torch.tensor(float(it), dtype=torch.float32) + 1.0
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda vi, g: b2 * vi + (1 - b2) * g * g,
                     state["v"], grads)
        f32 = torch.float32
        correction = (torch.sqrt(1.0 - torch.pow(torch.tensor(b2, dtype=f32),
                                                 t))
                      / (1.0 - torch.pow(torch.tensor(b1, dtype=f32), t)))
        params = tree_map(lambda w, mi, vi: w - lr * correction * mi
                          / (torch.sqrt(vi) + p.delta), params, m, v)
        return params, {"m": m, "v": v}

    return init, update
