"""Net: prototxt-driven DAG execution, the Caffe ``Net<Dtype>`` analogue
(port of ``nct_tpu/nn/net.py``).

Reference: src/caffe/net.cpp — Init (:49, proto parse -> layer creation ->
setup), ForwardFromTo (:553-565, topological layer loop), blob_by_name
(:977), CopyTrainedLayersFrom (:760-824).

  * blobs are NCHW tensors in a dict threaded through the layer loop; an
    in-place layer (Caffe ReLU writing its bottom) is a rebind of the dict
    entry, so a requested activation is post-ReLU as in the reference;
  * TEST/TRAIN filtering drops the layers of the other phase (FilterNet,
    net.cpp);
  * parameters live per layer name in an ``nn.ModuleDict`` of
    ``nn.ParameterDict``s, in Caffe's blob layouts, so
    ``copy_trained_layers_from`` reads caffemodel blobs as they are;
  * the net runs on ``cuda`` unless given ``device="cpu"``, and raises
    where there is no card; float32 means float32 on the card (TF32 off
    for every convolution and product of the forward);
  * training: ``make_loss_fn`` is the weighted sum of the loss tops,
    differentiated by autograd with respect to the ``params`` it is given
    (``train.Solver`` makes them require gradients; the stored ones never
    do).

``params_from_jax`` carries the JAX package's ``Net.params`` (NHWC / HWIO
layouts) over to this net's layouts, so both compute the same function.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from nct_tpu_torch.models.vgg19 import no_tf32
from nct_tpu_torch.nn.fillers import fill
from nct_tpu_torch.nn.layers import LAYER_REGISTRY
from nct_tpu_torch.nn.losses import is_loss_type
from nct_tpu_torch.nn.prototxt import load_prototxt, parse_prototxt
from nct_tpu_torch.nn.upgrade import upgrade_net
from nct_tpu_torch.pipeline import _resolve_device


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _tops(cfg) -> list[str]:
    return [str(t) for t in _as_list(cfg.get("top"))]


def _bottoms(cfg) -> list[str]:
    return [str(b) for b in _as_list(cfg.get("bottom"))]


def _key(name: str) -> str:
    """A layer name as a module key (a module name holds no '.')."""
    return name.replace(".", "\x00")


class Net(nn.Module):
    """Inference net over NCHW blobs."""

    def __init__(self, prototxt: str | dict, phase: str = "TEST",
                 device=None):
        super().__init__()
        self.phase = phase
        self.device = _resolve_device(device)
        if isinstance(prototxt, str):
            if "\n" in prototxt or "{" in prototxt:
                net_param = parse_prototxt(prototxt)
            else:
                net_param = load_prototxt(prototxt)
        else:
            net_param = prototxt
        # legacy definitions (V0 / V1 / in-data transform fields) upgrade
        # transparently (upgrade_proto.cpp UpgradeNetAsNeeded)
        net_param = upgrade_net(net_param)
        self.name = net_param.get("name", "net")
        self.inputs = [str(i) for i in _as_list(net_param.get("input"))]
        # declared input dims: `input_shape { dim: ... }` per input, or the
        # legacy flat `input_dim` (4 ints per input) — caffe.proto
        # NetParameter fields 8 and 4 — or an Input layer's input_param
        self.input_shapes: dict[str, tuple] = {}
        shapes = _as_list(net_param.get("input_shape"))
        if shapes:
            for name, entry in zip(self.inputs, shapes):
                if isinstance(entry, dict):
                    self.input_shapes[name] = tuple(
                        int(d) for d in _as_list(entry.get("dim")))
        else:
            dims = [int(d) for d in _as_list(net_param.get("input_dim"))]
            for i, name in enumerate(self.inputs):
                if dims[4 * i: 4 * i + 4]:
                    self.input_shapes[name] = tuple(dims[4 * i: 4 * i + 4])
        layers = _as_list(net_param.get("layer"))
        # FilterNet: keep layers whose include/phase matches (net.cpp:282+)
        self.layers = []
        for cfg in layers:
            phases = {str(e.get("phase")) for e in _as_list(cfg.get("include"))
                      if isinstance(e, dict) and "phase" in e}
            if phases and phase not in phases:
                continue
            self.layers.append(cfg)
            if str(cfg.get("type")) == "Input":
                ip = cfg.get("input_param", {}) or {}
                for top, s in zip(_tops(cfg), _as_list(ip.get("shape"))):
                    if top not in self.inputs:
                        self.inputs.append(top)
                    self.input_shapes[top] = tuple(
                        int(d) for d in _as_list(s.get("dim")))
        self.layer_params = nn.ModuleDict()

    # --- weights ---------------------------------------------------------
    @property
    def params(self) -> dict[str, dict[str, torch.Tensor]]:
        """{layer name: {blob name: tensor}} (the tensors are the net's)."""
        return {k.replace("\x00", "."): dict(pd.items())
                for k, pd in self.layer_params.items()}

    def set_params(self, name: str, entry: dict) -> None:
        """Set a layer's parameters (tensors or arrays, Caffe layouts);
        float arrays become float32 on the net's device."""
        pd = nn.ParameterDict()
        for k, v in entry.items():
            t = v if isinstance(v, torch.Tensor) else torch.tensor(
                np.asarray(v))
            if not t.is_floating_point() or t.dtype == torch.float64:
                t = t.float()
            pd[k] = nn.Parameter(t.detach().to(self.device),
                                 requires_grad=False)
        self.layer_params[_key(name)] = pd

    def copy_trained_layers_from(self, caffemodel_path: str) -> list[str]:
        """Load weights by layer name (ref net.cpp:760-824), each blob in
        the layout the caffemodel holds it: Convolution OIHW, Deconvolution
        (C_in, C_out/g, kh, kw), InnerProduct (out, in)."""
        from nct_tpu_torch.models.caffe_io import read_caffemodel

        blobs_by_name = read_caffemodel(caffemodel_path)
        loaded = []
        for cfg in self.layers:
            name = str(cfg.get("name"))
            blobs = blobs_by_name.get(name)
            if not blobs:
                continue
            ltype = str(cfg.get("type"))
            if ltype in ("Convolution", "Deconvolution", "Embed"):
                entry = {"w": blobs[0]}
            elif ltype == "InnerProduct":
                entry = {"w": blobs[0].reshape(-1, blobs[0].shape[-1])}
            elif ltype == "PReLU":
                entry = {"w": blobs[0].reshape(-1)}
            elif ltype == "BatchNorm" and len(blobs) >= 2:
                entry = {"mean": blobs[0].reshape(-1),
                         "var": blobs[1].reshape(-1)}
                if len(blobs) > 2:
                    entry["scale_factor"] = blobs[2].reshape(())
            elif ltype == "Scale":
                entry = {"w": blobs[0].reshape(-1)}
            else:
                entry = {str(i): b for i, b in enumerate(blobs)}
            if ltype in ("Convolution", "Deconvolution", "Embed",
                         "InnerProduct", "Scale") and len(blobs) > 1:
                entry["b"] = blobs[1].reshape(-1)
            self.set_params(name, entry)
            loaded.append(name)
        return loaded

    def blob_shapes(self, input_shapes: dict[str, tuple], seed: int = 0
                    ) -> tuple[dict[str, tuple], dict[str, dict]]:
        """(every blob's shape, the parameters made) for the given NCHW
        input shapes, by running the layers on meta tensors (Caffe's
        Reshape pass).  A param-bearing layer with no parameters yet gets
        them from ``make_layer_params``, layer i drawing from a CPU
        generator seeded by (seed, i)."""
        store = self.params
        made: dict[str, dict] = {}
        blobs = {n: torch.empty(tuple(s), device="meta")
                 for n, s in input_shapes.items()}
        for i, cfg in enumerate(self.layers):
            ltype = str(cfg.get("type"))
            name = str(cfg.get("name"))
            if ltype == "Input" or not _tops(cfg):
                continue
            bottoms = [blobs[b] for b in _bottoms(cfg)]
            lparams = store.get(name)
            if lparams is None:
                gen = torch.Generator().manual_seed((seed << 20) + i)
                lparams = made[name] = self.make_layer_params(cfg, bottoms,
                                                              gen)
            meta = {k: v.to("meta") for k, v in lparams.items()}
            out = LAYER_REGISTRY[ltype](meta, cfg, *bottoms)
            outs = out if isinstance(out, (tuple, list)) else [out]
            for t, o in zip(_tops(cfg), outs):
                blobs[t] = o.to("meta")
        return {n: tuple(b.shape) for n, b in blobs.items()}, made

    def init_params(self, input_shapes: dict[str, tuple], seed: int = 0):
        """Create the parameters of every param-bearing layer that has
        none yet from its weight_filler / bias_filler specs (Layer::SetUp
        + filler.hpp), shapes inferred through the DAG.

        ``input_shapes`` maps input blob names to NCHW shapes.  The draws
        come from CPU generators seeded by ``seed``, so a seed gives the
        same weights on every device.  Returns ``self.params``."""
        _, made = self.blob_shapes(input_shapes, seed)
        for name, entry in made.items():
            if entry:
                self.set_params(name, entry)
        return self.params

    def make_layer_params(self, cfg, bottoms, gen: torch.Generator) -> dict:
        """Filler-driven parameters of one layer in Caffe's blob layouts
        (filler.hpp fan conventions: fan_in = count/num, fan_out =
        count/channels)."""
        ltype = str(cfg.get("type"))
        x = bottoms[0] if bottoms else None

        def with_bias(p, w_shape, n_out, fan_in, fan_out):
            entry = {"w": fill(gen, p.get("weight_filler"), w_shape,
                               fan_in, fan_out)}
            if p.get("bias_term", True) not in (False, "false"):
                entry["b"] = fill(gen, p.get("bias_filler"), (n_out,))
            return entry

        if ltype in ("Convolution", "Deconvolution"):
            cp = cfg.get("convolution_param", {})
            o = int(cp.get("num_output"))
            k = int(_as_list(cp.get("kernel_size", 1))[0])
            g = int(cp.get("group", 1))
            cin = x.shape[1]
            if ltype == "Convolution":
                return with_bias(cp, (o, cin // g, k, k), o,
                                 (cin // g) * k * k, o * k * k)
            return with_bias(cp, (cin, o // g, k, k), o,
                             (o // g) * k * k, cin * k * k)
        if ltype == "InnerProduct":
            ipp = cfg.get("inner_product_param", {})
            o = int(ipp.get("num_output"))
            cin = int(np.prod(x.shape[1:]))
            return with_bias(ipp, (o, cin), o, cin, o)
        if ltype == "Embed":
            ep = cfg.get("embed_param", {})
            k_dim = int(ep.get("input_dim"))
            o = int(ep.get("num_output"))
            return with_bias(ep, (k_dim, o), o, k_dim, o)
        if ltype == "PReLU":
            pp = cfg.get("prelu_param", {})
            c = 1 if pp.get("channel_shared") in (True, "true") else x.shape[1]
            spec = pp.get("filler") or {"type": "constant", "value": 0.25}
            return {"w": fill(gen, spec, (c,))}
        if ltype == "Scale":
            sp = cfg.get("scale_param", {})
            c = x.shape[1]
            spec = sp.get("filler") or {"type": "constant", "value": 1.0}
            entry = {"w": fill(gen, spec, (c,))}
            if sp.get("bias_term") in (True, "true"):
                entry["b"] = fill(gen, sp.get("bias_filler"), (c,))
            return entry
        if ltype == "Bias":
            spec = cfg.get("bias_param", {}).get("filler")
            return {"b": fill(gen, spec, (x.shape[1],))}
        if ltype == "BatchNorm":
            c = x.shape[1]
            return {"mean": torch.zeros(c), "var": torch.ones(c),
                    "scale_factor": torch.ones(())}
        if ltype == "Parameter":
            pp = cfg.get("parameter_param", {}) or {}
            shape = pp.get("shape", {})
            dims = shape.get("dim", []) if isinstance(shape, dict) else []
            dims = tuple(int(d) for d in _as_list(dims)) or (1,)
            return {"w": fill(gen, pp.get("filler"), dims)}
        if ltype in ("RNN", "LSTM"):
            rp = cfg.get("recurrent_param", {})
            h = int(rp.get("num_output"))
            gates = 4 * h if ltype == "LSTM" else h
            d = int(np.prod(x.shape[2:]))
            wf, bf = rp.get("weight_filler"), rp.get("bias_filler")
            entry = {"w_x": fill(gen, wf, (d, gates), d, gates),
                     "w_h": fill(gen, wf, (h, gates), h, gates),
                     "b": fill(gen, bf, (gates,))}
            n_state = 2 if ltype == "LSTM" else 1
            expose = rp.get("expose_hidden") in (True, "true")
            if len(bottoms) - 2 - (n_state if expose else 0) > 0:
                e = int(np.prod(bottoms[2].shape[1:]))   # x_static
                entry["w_static"] = fill(gen, wf, (e, gates), e, gates)
            if ltype == "RNN":
                entry["w_o"] = fill(gen, wf, (h, h), h, h)
                entry["b_o"] = fill(gen, bf, (h,))
            return entry
        return {}

    # --- execution --------------------------------------------------------
    def forward(self, inputs: dict, output_blobs: Sequence[str] | None = None,
                params: dict | None = None,
                generator: torch.Generator | None = None,
                shard: tuple[int, int] | None = None
                ) -> dict[str, torch.Tensor]:
        """Run the DAG; returns the requested blobs (default: all).

        Inputs (tensors or arrays) move to the net's device.  ``params``
        overrides the net's stored parameters; ``generator`` (on any
        device) drives the TRAIN-phase Dropout masks.  ``shard = (i, n)``
        says the inputs are part i of n equal row blocks of a batch: each
        mask is drawn for the whole batch and its block i taken, so n data
        ranks together draw the one process's masks.  The loop stops after
        the last layer that produces a requested blob (ForwardFromTo)."""
        store = self.params if params is None else params
        blobs = {k: torch.as_tensor(v).to(self.device)
                 for k, v in inputs.items()}
        wanted = set(output_blobs) if output_blobs else None
        last = len(self.layers) - 1
        if wanted is not None:
            last = max((i for i, cfg in enumerate(self.layers)
                        if wanted & set(_tops(cfg))), default=-1)
        with no_tf32():
            for cfg in self.layers[:last + 1]:
                ltype = str(cfg.get("type"))
                if ltype == "Input":
                    continue
                fn = LAYER_REGISTRY.get(ltype)
                if fn is None:
                    raise NotImplementedError(
                        f"layer type {ltype!r} not registered")
                lparams = store.get(str(cfg.get("name")), {})
                if (generator is not None and ltype == "Dropout"
                        and self.phase == "TRAIN"):
                    lparams = dict(lparams, __generator__=generator,
                                   __shard__=shard)
                bottoms = [blobs[b] for b in _bottoms(cfg)]
                out = fn(lparams, cfg, *bottoms)
                outs = out if isinstance(out, (tuple, list)) else [out]
                for t, o in zip(_tops(cfg), outs):
                    # a source layer (DummyData) makes its tops on the CPU
                    blobs[t] = o if bottoms else o.to(self.device)
        if wanted is None:
            return blobs
        return {k: blobs[k] for k in wanted}

    def loss_tops(self) -> list[tuple[str, float]]:
        """(top blob, weight) for every loss-contributing layer: layers of
        *Loss type get an implicit weight of 1, any layer can opt in via
        ``loss_weight`` (net.cpp:AppendTop)."""
        out = []
        for cfg in self.layers:
            ltype = str(cfg.get("type"))
            weights = _as_list(cfg.get("loss_weight"))
            for j, t in enumerate(_tops(cfg)):
                if j < len(weights):
                    w = float(weights[j])
                else:
                    w = 1.0 if is_loss_type(ltype) and j == 0 else 0.0
                if w:
                    out.append((t, w))
        return out

    def make_loss_fn(self):
        """loss_fn(params, batch) for ``train.Solver``: runs the DAG with
        the given params, feeding ``batch`` (a dict) as input blobs, and
        sums the weighted loss tops -- the role of Net::ForwardBackward
        (the backward is autograd's).  A ``"__generator__"`` entry of the
        batch (a ``torch.Generator``, the JAX package's ``"__rng__"``)
        drives the step's Dropout masks, and a ``"__shard__"`` entry is
        ``forward``'s ``shard``."""
        tops = self.loss_tops()
        if not tops:
            raise ValueError("net has no loss layers")
        names = tuple(t for t, _ in tops)

        def loss_fn(params, batch):
            batch = dict(batch)
            gen = batch.pop("__generator__", None)
            part = batch.pop("__shard__", None)
            blobs = self.forward(batch, names, params=params, generator=gen,
                                 shard=part)
            total = 0.0
            for t, w in tops:
                total = total + w * torch.sum(blobs[t])
            return total

        return loss_fn

    def blob_names(self) -> list[str]:
        names = set(self.inputs)
        for cfg in self.layers:
            names.update(_tops(cfg))
        return sorted(names)


def params_from_jax(net: Net, jax_params: dict,
                    input_shapes: dict[str, tuple]) -> dict[str, dict]:
    """The JAX package's ``Net.params`` ({layer: {blob: array}}, NHWC-era
    layouts) as this net's parameters, numpy arrays in Caffe's layouts:

      * Convolution HWIO -> OIHW;
      * Deconvolution: the JAX package's spatially flipped HWIO (I = C_in,
        O = C_out/g) -> (C_in, C_out/g, kh, kw), unflipped;
      * InnerProduct (in, out) -> (out, in); where the bottom is 4-D, or a
        Flatten of a 4-D blob, the JAX ``in`` index runs over (h, w, c) and
        is permuted to Caffe's (c, h, w);
      * every other blob (PReLU, BatchNorm, Scale, Bias, Embed, the
        recurrent weights, Parameter) as it is.

    ``input_shapes`` maps the inputs to NCHW shapes (for the InnerProduct
    bottoms); pass the result to ``Net.set_params`` per layer."""
    shapes, _ = net.blob_shapes(input_shapes)
    flat_of: dict[str, tuple] = {}       # 2-D blob -> (C, H, W) it flattens
    out: dict[str, dict] = {}
    for cfg in net.layers:
        name, ltype = str(cfg.get("name")), str(cfg.get("type"))
        bottoms = _bottoms(cfg)
        if ltype == "Flatten" and len(shapes[bottoms[0]]) == 4:
            flat_of[_tops(cfg)[0]] = shapes[bottoms[0]][1:]
        if name not in jax_params:
            continue
        entry = {k: np.asarray(v, np.float32)
                 for k, v in jax_params[name].items()}
        if ltype == "Convolution":
            entry["w"] = np.ascontiguousarray(entry["w"].transpose(3, 2, 0, 1))
        elif ltype == "Deconvolution":
            entry["w"] = np.ascontiguousarray(
                entry["w"][::-1, ::-1].transpose(2, 3, 0, 1))
        elif ltype == "InnerProduct":
            w = entry["w"].T                      # (out, in)
            bshape = shapes[bottoms[0]]
            chw = bshape[1:] if len(bshape) == 4 else flat_of.get(bottoms[0])
            if chw is not None:
                c, h, wd = chw
                w = w.reshape(-1, h, wd, c).transpose(0, 3, 1, 2).reshape(
                    w.shape[0], -1)
            entry["w"] = np.ascontiguousarray(w)
        out[name] = entry
    return out
