"""SolverParameter prototxt front end: the ``caffe train -solver`` surface
(port of ``nct_tpu/train/solver_proto.py``).

Reference: src/caffe/proto/caffe.proto SolverParameter, solver.cpp Init
and tools/caffe.cpp:train:156-229.  A solver prototxt names the net, the
LR policy, the optimizer and its knobs; ``parse_solver_prototxt`` reads it
into ``SolverParams``, and ``NetSolver`` wires a prototxt-defined net (its
loss layers and fillers) into ``train.Solver``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from nct_tpu_torch.data import DATA_LAYER_TYPES, make_data_source
from nct_tpu_torch.nn.losses import is_loss_type
from nct_tpu_torch.nn.net import Net, _tops, params_from_jax
from nct_tpu_torch.nn.prototxt import load_prototxt, parse_prototxt
from nct_tpu_torch.nn.upgrade import upgrade_solver
from nct_tpu_torch.train.lr_policies import LrPolicy
from nct_tpu_torch.train.optimizers import OptimizerParams
from nct_tpu_torch.train.solver import Solver, SolverParams
from nct_tpu_torch.utils import glog

# SolverParameter.solver_type enum and its modern string `type` field
_SOLVER_TYPES = {
    "SGD": "sgd", "NESTEROV": "nesterov", "ADAGRAD": "adagrad",
    "RMSPROP": "rmsprop", "ADADELTA": "adadelta", "ADAM": "adam",
}


@dataclass
class SolverProto:
    """Parsed solver prototxt: everything tools/caffe.cpp train() reads."""
    solver_params: SolverParams
    net: str | dict | None          # path or inline NetParameter
    test_iter: int = 0
    test_interval: int = 0
    random_seed: int = -1


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def parse_solver_prototxt(text_or_path: str) -> SolverProto:
    if "\n" in text_or_path or ":" in os.path.basename(text_or_path):
        msg = parse_prototxt(text_or_path)
        base = "."
    else:
        msg = load_prototxt(text_or_path)
        base = os.path.dirname(os.path.abspath(text_or_path))

    lr = LrPolicy(
        policy=str(msg.get("lr_policy", "fixed")),
        base_lr=float(msg.get("base_lr", 0.01)),
        gamma=float(msg.get("gamma", 0.1)),
        power=float(msg.get("power", 0.75)),
        stepsize=int(msg.get("stepsize", 100000)),
        stepvalues=tuple(int(v) for v in _as_list(msg.get("stepvalue"))),
        max_iter=int(msg.get("max_iter", 100000)),
    )
    # legacy solver_type enum (numeric too) -> the modern type string
    # (upgrade_proto.cpp UpgradeSolverType)
    msg = upgrade_solver(msg)
    type_field = str(msg.get("type", "SGD"))
    opt = OptimizerParams(
        solver_type=_SOLVER_TYPES.get(type_field.upper(), "sgd"),
        momentum=float(msg.get("momentum", 0.9)),
        momentum2=float(msg.get("momentum2", 0.999)),
        delta=float(msg.get("delta", 1e-8)),
        rms_decay=float(msg.get("rms_decay", 0.99)),
        weight_decay=float(msg.get("weight_decay", 0.0)),
        clip_gradients=float(msg.get("clip_gradients", -1.0)),
        iter_size=int(msg.get("iter_size", 1)),
    )
    sp = SolverParams(
        lr=lr, opt=opt,
        max_iter=int(msg.get("max_iter", 1000)),
        display=int(msg.get("display", 0)),
        snapshot=int(msg.get("snapshot", 0)),
        snapshot_prefix=str(msg.get("snapshot_prefix", "snapshot")),
        snapshot_format=(
            "hdf5" if str(msg.get("snapshot_format", "")).upper() == "HDF5"
            else "npz"),
    )
    net = msg.get("net") or msg.get("train_net")
    if isinstance(net, str) and not os.path.isabs(net):
        net = os.path.join(base, net)
    if net is None and "net_param" in msg:
        net = msg["net_param"]
    return SolverProto(
        solver_params=sp, net=net,
        test_iter=int(_as_list(msg.get("test_iter"))[0]
                      if msg.get("test_iter") is not None else 0),
        test_interval=int(msg.get("test_interval", 0)),
        random_seed=int(msg.get("random_seed", -1)),
    )


def _strip_data_layers(net: Net, phase: str, seed: int):
    """Remove the net's data layers; returns (source, its top names) of the
    last one, or (None, [])."""
    source, tops, kept = None, [], []
    for cfg in net.layers:
        if str(cfg.get("type")) in DATA_LAYER_TYPES:
            source = make_data_source(cfg, phase=phase, seed=seed)
            tops = _tops(cfg)
        else:
            kept.append(cfg)
    net.layers = kept
    return source, tops


class NetSolver:
    """``caffe train`` in one object: solver prototxt -> trained net.

    The net feeds itself (DummyData tops), streams the tops of its data
    layers (MemoryData, ImageData, Data, WindowData, HDF5Data) as per-step
    batches, or is fed batches whose keys are its input blob names.
    Mirrors tools/caffe.cpp train() -> Solver::Solve.  Runs on ``cuda``
    unless given ``device="cpu"``.  Over a mesh with n data ranks, each
    rank's stream reads (and decodes) only its block of every batch.  A
    snapshot carries the stream's position (``stream/`` entries), so a
    restore resumes it without reading the batches already used; a
    snapshot without them (the JAX package's) restarts the stream, as the
    JAX package's NetSolver does.
    """

    def __init__(self, solver: SolverProto | str, mesh=None,
                 input_shapes: dict | None = None, device=None):
        if isinstance(solver, str):
            solver = parse_solver_prototxt(solver)
        self.proto = solver
        self.seed = solver.random_seed if solver.random_seed >= 0 else 0
        if mesh is not None and device is None:
            device = mesh.device
        self.net = Net(solver.net, phase="TRAIN", device=device)
        self.device = self.net.device

        # Data layers are host IO, not graph ops: strip them and stream
        # their tops (the reference's BasePrefetchingDataLayer thread vs
        # the net forward).
        self.data_source, self._data_tops = _strip_data_layers(
            self.net, "TRAIN", self.seed)
        self.input_shapes = dict(input_shapes or {})
        self._part = None       # (data rank, data ranks) of a mesh
        if mesh is not None and mesh.shape["data"] > 1:
            self._part = (mesh.index("data"), mesh.shape["data"])
        self._first_batch = None
        if self.data_source is not None:
            self._stream_start = self.data_source.state()
            self._first_batch = self.next_batch()
            for t, arr in self._first_batch.items():
                # the whole batch's shape, as the JAX package's
                self.input_shapes[t] = (self.data_source.batch_size,
                                        *arr.shape[1:])
        self.net.init_params(self.input_shapes, seed=self.seed)
        self.solver = Solver(self.net.make_loss_fn(), self.net.params,
                             solver.solver_params, mesh=mesh,
                             from_jax=self._from_jax)
        self.solver.extra_state = self._stream_state

        # TEST-phase evaluation every test_interval iterations (ref
        # solver.cpp TestAll), with the training parameters
        self.test_net = None
        self._test_source = None
        if solver.test_interval > 0:
            self.test_net = Net(solver.net, phase="TEST", device=self.device)
            self._test_source, self._test_tops = _strip_data_layers(
                self.test_net, "TEST", self.seed)

    def _from_jax(self, tree):
        return params_from_jax(self.net, tree, self.input_shapes)

    def set_params(self, params: dict) -> None:
        """Replace the parameters ({layer: {blob: array}}, this port's
        layouts; layers not named keep theirs) and reset the optimizer
        state."""
        for name, entry in params.items():
            self.net.set_params(name, entry)
        self.solver.set_params(self.net.params)

    def load_weights(self, path: str) -> list[str]:
        """``caffe train --weights``: a .caffemodel (by layer name) or an
        npz snapshot's ``params/`` entries of this port or of the JAX
        package.  Returns the layers loaded."""
        if path.endswith(".npz"):
            with np.load(path) as f:
                data = {k: f[k] for k in f.files}
            tree: dict = {}
            for key, arr in data.items():
                if key.startswith("params/"):
                    _, lname, pname = key.split("/", 2)
                    tree.setdefault(lname, {})[pname] = arr
            if str(data.get("__layout__", "")) != "nct_tpu_torch":
                tree = self._from_jax(tree)
            self.set_params(tree)
            return sorted(tree)
        loaded = self.net.copy_trained_layers_from(path)
        self.solver.set_params(self.net.params)
        return loaded

    def _stream_state(self) -> dict:
        """The data stream's position before its next batch, as snapshot
        entries."""
        if self.data_source is None:
            return {}
        state = (self._stream_start if self._first_batch is not None
                 else self.data_source.state())
        return {f"stream/{k}": v for k, v in state.items()}

    def restore(self, path: str) -> None:
        """``Solver.restore``, and the data stream set to the snapshot's
        position (restarted where the snapshot has none)."""
        extra = self.solver.restore(path)
        if self.data_source is None:
            return
        state = {k[len("stream/"):]: v for k, v in extra.items()
                 if k.startswith("stream/")}
        self.data_source.set_state(state or self._stream_start)
        self._first_batch = None

    def step_generator(self, it: int) -> torch.Generator:
        """The Dropout generator of iteration ``it``: seeded by the solver's
        seed and the iteration, so a restored run draws the masks an
        uninterrupted one does."""
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(self.seed * 1_000_003 + it)

    def next_batch(self) -> dict:
        """The data layers' next tops, this rank's block of them over a
        mesh (the first is the one drawn at construction)."""
        if self.data_source is None:
            return {}
        if self._first_batch is not None:
            batch, self._first_batch = self._first_batch, None
            return batch
        return dict(zip(self._data_tops,
                        self.data_source.next_batch(self._part)))

    def test(self) -> dict[str, float]:
        """One test pass: test_iter forwards, outputs averaged (ref
        solver.cpp Test: the loss / accuracy tops of the TEST net)."""
        if self.test_net is None:
            return {}
        names = tuple(t for cfg in self.test_net.layers for t in _tops(cfg)
                      if is_loss_type(str(cfg.get("type")))
                      or str(cfg.get("type")) == "Accuracy")
        if not names:
            return {}
        iters = max(self.proto.test_iter, 1)
        sums = {t: 0.0 for t in names}
        with torch.no_grad():
            for _ in range(iters):
                batch = {}
                if self._test_source is not None:
                    arrays = tuple(self._test_source.next_batch())
                    batch = dict(zip(self._test_tops, arrays))
                out = self.test_net.forward(batch, names,
                                            params=self.solver.params)
                for t in names:
                    sums[t] += float(out[t])
        scores = {t: sums[t] / iters for t in names}
        glog.info(f"Iteration {self.solver.iter}, Testing net (#0)")
        for i, t in enumerate(names):
            glog.info(f"    Test net output #{i}: {t} = {scores[t]:.6f}")
        return scores

    def batches(self):
        """The self-fed batch stream: the data layers' tops (this rank's
        block of them over a mesh) and the step's Dropout generator."""
        while True:
            batch = self.next_batch()
            batch["__generator__"] = self.step_generator(self.solver.iter)
            if self._part is not None and self.data_source is not None:
                batch["__shard__"] = self._part
            yield batch

    def solve(self, batches=None) -> float:
        """Train to max_iter (on ``batches`` or the self-fed stream); the
        trained parameters end in ``self.net``."""
        on_iter = None
        if self.test_net is not None:
            interval = self.proto.test_interval

            def on_iter(solver):
                if solver.iter % interval == 0:
                    self.test()

        loss = self.solver.solve(self.batches() if batches is None
                                 else batches, on_iter=on_iter)
        for name, entry in self.solver.params.items():
            self.net.set_params(name, {k: v.detach()
                                       for k, v in entry.items()})
        return loss
