"""Solver: training loop, snapshot/restore, data-parallel step (port of
``nct_tpu/train/solver.py``).

Reference: src/caffe/solver.cpp (Solve/Step/Snapshot/Restore) and
src/caffe/parallel.cpp (P2PSync).  Here:

  * a step is the loss forward, autograd's backward and the Caffe update
    rule of ``train.optimizers`` (functional: new tensors each step); the
    forward and the backward run with TF32 off, so float32 is float32 on
    the card;
  * data parallelism is explicit, over ``parallel.mesh``: every rank of
    the mesh's ``data`` axis takes its shard of the batch along the first
    axis (a batch that carries ``"__shard__"`` is that shard already), and
    the gradients are averaged over the data group with one all-reduce --
    the role of P2PSync's reduction, which sums and divides by the solver
    count.  With losses that average over the batch (Caffe's), equal
    shards and Dropout masks drawn per shard of the whole batch's mask
    (``nn.Net.forward``'s ``shard``), the step is the single-process
    step.  The JAX package gets the same from a sharding annotation;
  * snapshot/restore write and read a flat npz with the JAX package's
    keys (``__iter__``, ``params/<layer>/<blob>``, ``state/...``) plus
    ``__layout__`` and the entries of ``extra_state()`` (``NetSolver``'s
    data stream); only the mesh's first rank writes.  A snapshot without
    ``__layout__`` was written by the JAX package's ``Solver``: its params
    and optimizer state go through ``from_jax`` (``NetSolver`` sets the
    layout rules of ``nn.net.params_from_jax``; a plain tree is taken as
    it is).  HDF5 needs h5py, which only the CPU host has.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

from nct_tpu_torch.models.vgg19 import no_tf32
from nct_tpu_torch.train.lr_policies import LrPolicy, learning_rate
from nct_tpu_torch.train.optimizers import (OptimizerParams, make_optimizer,
                                            tree_leaves, tree_map)
from nct_tpu_torch.utils import glog

LAYOUT = "nct_tpu_torch"


@dataclass(frozen=True)
class SolverParams:
    lr: LrPolicy = field(default_factory=LrPolicy)
    opt: OptimizerParams = field(default_factory=OptimizerParams)
    max_iter: int = 1000
    display: int = 0               # print loss every N iters (0 = never)
    snapshot: int = 0              # snapshot every N iters (0 = never)
    snapshot_prefix: str = "snapshot"
    snapshot_format: str = "npz"   # or "hdf5" (SolverParameter HDF5)


def _flatten_tree(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten_tree(tree[k], f"{prefix}{k}/"))
    else:
        t = tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree
        out[prefix.rstrip("/")] = np.asarray(t)
    return out


def _unflatten(template, flat, prefix=""):
    """numpy arrays in ``template``'s tree shape."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], flat, f"{prefix}{k}/")
                for k in template}
    return np.asarray(flat[prefix.rstrip("/")])


def _trainable(params):
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


def _shard(batch, mesh):
    """This rank's share of every batch tensor along its first axis, and
    ``"__shard__"``: (its index, the data ranks) where there was a tensor
    to split (a self-feeding net computes the whole batch on each
    rank)."""
    n, i = mesh.shape["data"], mesh.index("data")

    def take(v):
        if not isinstance(v, (torch.Tensor, np.ndarray)) or not v.ndim:
            return v
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} does not split over "
                             f"{n} data ranks")
        k = v.shape[0] // n
        return v[i * k:(i + 1) * k]

    out = {k: take(v) for k, v in batch.items()}
    if any(isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim
           for v in batch.values()):
        out["__shard__"] = (i, n)
    return out


def _all_mean(tensors: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """The mean of each tensor over the data group, by one all-reduce of
    their concatenation (through host memory for a card's tensors under
    gloo)."""
    n = mesh.shape["data"]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    host = mesh.backend == "gloo" and flat.device.type == "cuda"
    buf = flat.cpu() if host else flat
    dist.all_reduce(buf, group=mesh.group("data"))
    buf = (buf / n).to(flat.device)
    out, pos = [], 0
    for t in tensors:
        out.append(buf[pos:pos + t.numel()].view_as(t))
        pos += t.numel()
    return out


class Solver:
    """Training driver.

    ``loss_fn(params, batch) -> scalar tensor``; ``params`` a tree of
    tensors (dicts by key); ``batch`` a dict whose tensors have a leading
    batch axis (split over the mesh's ``data`` axis when a mesh is given).
    """

    def __init__(self, loss_fn: Callable, params,
                 solver_params: SolverParams = SolverParams(), mesh=None,
                 from_jax: Callable | None = None):
        self.param = solver_params
        self.loss_fn = loss_fn
        self.iter = 0
        self._init, self._update = make_optimizer(solver_params.opt)
        self.set_params(params)
        self._mesh = mesh
        # JAX-layout params tree (numpy) -> this loss_fn's layouts
        self.from_jax = from_jax or (lambda tree: tree)
        # more snapshot entries ({key: array}); restore returns them
        self.extra_state: Callable[[], dict] = dict

    def set_params(self, params) -> None:
        """New parameters (tensors), with a fresh optimizer state."""
        self.params = _trainable(params)
        self.state = self._init(self.params)

    def step(self, batch) -> float:
        """One iteration (forward, all-reduced backward, update); returns
        the loss (averaged over the data ranks)."""
        if self._mesh is not None and "__shard__" not in batch:
            batch = _shard(batch, self._mesh)
        leaves = tree_leaves(self.params)
        with no_tf32():     # the backward's products in float32 too
            loss = self.loss_fn(self.params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(leaves, grads)]
        loss = loss.detach()
        if self._mesh is not None and self._mesh.shape["data"] > 1:
            *grads, loss = _all_mean([*grads, loss.reshape(1)], self._mesh)
            loss = loss[0]
        grad_tree = _rebuild(self.params, iter(grads))
        rate = learning_rate(self.param.lr, self.iter)
        params, self.state = self._update(self.params, grad_tree, self.state,
                                          rate, self.iter)
        self.params = _trainable(params)
        self.iter += 1
        return float(loss)

    def solve(self, batches: Iterable, on_iter: Callable | None = None
              ) -> float:
        """Run up to max_iter (ref Solver::Solve), snapshotting on
        schedule.  ``on_iter(solver)`` runs once before the loop (the
        reference's test_initialization) and after every step.  SIGINT /
        SIGHUP during the loop snapshot and stop at the end of the
        iteration, before the next batch is drawn (the reference's
        SignalHandler)."""
        import signal

        stop_requested = []

        def _on_signal(signum, frame):
            stop_requested.append(signum)

        old_handlers = {}
        for sig in (signal.SIGINT, signal.SIGHUP):
            try:
                old_handlers[sig] = signal.signal(sig, _on_signal)
            except ValueError:   # not the main thread
                pass

        loss = float("nan")
        try:
            if on_iter is not None:
                on_iter(self)
            # no batch is drawn past max_iter or a signal, so a snapshot's
            # data stream stands where its iteration left it
            done = self.iter >= self.param.max_iter
            for batch in () if done else batches:
                loss = self.step(batch)
                if self.param.display and self.iter % self.param.display == 0:
                    glog.info(f"Iteration {self.iter}, loss = {loss}")
                    rate = learning_rate(self.param.lr, self.iter)
                    glog.info(f"Iteration {self.iter}, lr = {float(rate)}")
                if self.param.snapshot and self.iter % self.param.snapshot == 0:
                    self.snapshot()
                if on_iter is not None:
                    on_iter(self)
                if stop_requested:
                    path = self.snapshot()
                    glog.warning(f"signal received; snapshotted to {path}")
                    break
                if self.iter >= self.param.max_iter:
                    break
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        return loss

    # --- checkpointing -----------------------------------------------------
    def snapshot(self, path: str | None = None) -> str:
        """Write the solver state (on the mesh's first rank only; every
        rank holds the same) and return the path."""
        if path is None:
            ext = "h5" if self.param.snapshot_format == "hdf5" else "npz"
            path = f"{self.param.snapshot_prefix}_iter_{self.iter}.{ext}"
        if self._mesh is not None and any(self._mesh.coords):
            return path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        blob = {"__iter__": np.asarray(self.iter),
                "__layout__": np.asarray(LAYOUT)}
        blob.update(_flatten_tree(self.params, "params/"))
        blob.update(_flatten_tree(self.state, "state/"))
        blob.update(self.extra_state())
        if path.endswith((".h5", ".hdf5")):
            h5py = _h5py()
            with h5py.File(path, "w") as f:
                for k, v in blob.items():
                    f.create_dataset(k, data=v)
        else:
            np.savez(path, **blob)
        return path

    def restore(self, path: str) -> dict:
        """Read a snapshot of this port or of the JAX package's Solver;
        returns its entries other than the iteration, layout, params and
        state (those ``extra_state`` wrote)."""
        if path.endswith((".h5", ".hdf5")):
            h5py = _h5py()
            with h5py.File(path, "r") as f:
                data = {k: np.asarray(f[k]) for k in _h5_keys(f)}
        else:
            with np.load(path) as f:
                data = {k: f[k] for k in f.files}
        layout = data.get("__layout__")
        convert = (self.from_jax if layout is None or str(layout) != LAYOUT
                   else (lambda tree: tree))
        self.iter = int(data["__iter__"])
        params = convert(_unflatten(self.params, data, "params/"))
        state = {k: convert(_unflatten(v, data, f"state/{k}/"))
                 for k, v in self.state.items()}

        def to_like(ref, arr):
            return torch.as_tensor(np.ascontiguousarray(arr)).to(
                device=ref.device, dtype=ref.dtype)

        self.params = _trainable(tree_map(to_like, self.params, params))
        self.state = tree_map(to_like, self.state, state)
        return {k: v for k, v in data.items()
                if k not in ("__iter__", "__layout__")
                and not k.startswith(("params/", "state/"))}


def _rebuild(template, leaves_iter):
    """A tree of ``template``'s shape whose leaves come from the iterator in
    sorted-key order (``tree_leaves``'s order)."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves_iter)
                for k in sorted(template)}
    return next(leaves_iter)


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("HDF5 snapshots need h5py, which is not "
                           "installed; use the npz format") from e
    return h5py


def _h5_keys(group, prefix: str = "") -> list[str]:
    import h5py

    out: list[str] = []
    for k, v in group.items():
        p = f"{prefix}{k}"
        if isinstance(v, h5py.Group):
            out.extend(_h5_keys(v, p + "/"))
        else:
            out.append(p)
    return out
