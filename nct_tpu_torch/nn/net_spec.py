"""Programmatic net construction — the pycaffe ``net_spec`` analogue (a
pure-Python copy of ``nct_tpu/nn/net_spec.py``).

Rebuilds the reference's Python net-specification surface (reference:
code/python/caffe/net_spec.py — ``Layers``/``Top``/``Function``/``NetSpec``
and ``to_proto``) without protobuf: layers are built by calling attributes
of the ``L`` pseudo-module, wired by passing Tops as inputs, named by
assigning to ``NetSpec`` attributes, and serialized either to the plain
prototxt *dict* our ``Net`` consumes directly or to prototxt *text*
(round-trips through nn.prototxt.parse_prototxt and is Caffe-TextFormat
compatible for the vocabulary in nn/layers.py).

    from nct_tpu_torch.nn.net_spec import L, NetSpec

    n = NetSpec()
    n.data, n.label = L.DummyData(
        dummy_data_param=dict(shape=[dict(dim=[4, 1, 8, 8]),
                                     dict(dim=[4])]), ntop=2)
    n.conv1 = L.Convolution(n.data, num_output=4, kernel_size=3, pad=1)
    n.relu1 = L.ReLU(n.conv1, in_place=True)
    n.fc = L.InnerProduct(n.relu1, num_output=10)
    n.loss = L.SoftmaxWithLoss(n.fc, n.label)
    net = Net(n.to_dict(), phase="TRAIN", device="cpu")

Like the reference, type-specific kwargs are folded into the layer's
``<type>_param`` message automatically (``num_output=4`` becomes
``convolution_param { num_output: 4 }``), while generic LayerParameter
fields (``name``, ``loss_weight``, ``include``, ``param``, ``phase``,
``propagate_down``, ``transform_param``, explicit ``*_param`` dicts) stay
top-level.
"""

from __future__ import annotations

import re
from collections import Counter, OrderedDict

__all__ = ["L", "NetSpec", "Top", "to_dict", "emit_prototxt"]


# Layer type -> its type-specific param field.  The reference derives this
# mapping by protobuf introspection (net_spec.py param_name_dict); here it
# is the static table for the caffe.proto vocabulary (irregular names
# spelled out, the rest via CamelCase -> snake_case).
_PARAM_FIELD_SPECIAL = {
    "Deconvolution": "convolution_param",
    "SoftmaxWithLoss": "softmax_param",
    "SigmoidCrossEntropyLoss": "loss_param",
    "MultinomialLogisticLoss": "loss_param",
    "EuclideanLoss": "loss_param",
    "Data": "data_param",
    "LRN": "lrn_param",
    "MVN": "mvn_param",
    "ELU": "elu_param",
    "PReLU": "prelu_param",
    "ReLU": "relu_param",
    "TanH": "tanh_param",
    "AbsVal": None,
    "BNLL": None,
    "Sigmoid": "sigmoid_param",
    "Split": None,
    "Silence": None,
    "HDF5Data": "hdf5_data_param",
    "HDF5Output": "hdf5_output_param",
}

# Generic LayerParameter fields that must stay top-level (caffe.proto
# LayerParameter; everything else a caller passes is a type-specific knob).
_GENERIC_FIELDS = {
    "name", "type", "bottom", "top", "phase", "loss_weight", "param",
    "blobs", "propagate_down", "include", "exclude", "transform_param",
    "loss_param",
}


def _camel_to_snake(name: str) -> str:
    s = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    s = re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s)
    return s.lower()


def param_field(layer_type: str) -> str | None:
    """The ``*_param`` message field for a layer type (None: no params)."""
    if layer_type in _PARAM_FIELD_SPECIAL:
        return _PARAM_FIELD_SPECIAL[layer_type]
    return _camel_to_snake(layer_type) + "_param"


class Top:
    """A named output of a Function (ref net_spec.py:82-97)."""

    def __init__(self, fn: "Function", n: int):
        self.fn = fn
        self.n = n

    def to_dict(self):
        """NetParameter dict containing every layer this Top depends on."""
        return to_dict(self)

    def to_prototxt(self) -> str:
        return emit_prototxt(self.to_dict())


class Function:
    """One layer invocation: type, input Tops, and parameters
    (ref net_spec.py:100-161)."""

    def __init__(self, type_name: str, inputs, params: dict):
        self.type_name = type_name
        for i in inputs:
            if not isinstance(i, Top):
                raise TypeError(
                    f"layer inputs must be Tops, got {type(i).__name__}"
                )
        self.inputs = tuple(inputs)
        self.params = dict(params)
        self.ntop = int(self.params.pop("ntop", 1))
        self.in_place = bool(self.params.pop("in_place", False))
        if self.in_place and self.ntop != 1:
            raise ValueError("in_place layers must have exactly one top")
        self.tops = tuple(Top(self, i) for i in range(self.ntop))

    def _get_name(self, names, autonames):
        if self in names:
            return names[self]
        if self.tops and self.tops[0] in names:
            name = names[self.tops[0]]      # C++ convention: layer named
        else:                               # after its first top
            autonames[self.type_name] += 1
            name = (
                _camel_to_snake(self.type_name)
                + str(autonames[self.type_name])
            )
        names[self] = name
        return name

    def _top_name(self, top, names, autonames):
        if top not in names:
            autonames[top.fn.type_name] += 1
            names[top] = (
                _camel_to_snake(top.fn.type_name)
                + str(autonames[top.fn.type_name])
                + (f"_{top.n}" if top.n else "")
            )
        return names[top]

    def _to_dict(self, layers: OrderedDict, names, autonames):
        if self in layers:
            return
        bottoms = []
        for inp in self.inputs:
            inp.fn._to_dict(layers, names, autonames)
            bottoms.append(self._top_name(inp, names, autonames))
        cfg: dict = {"name": self._get_name(names, autonames),
                     "type": self.type_name}
        if bottoms:
            cfg["bottom"] = bottoms if len(bottoms) > 1 else bottoms[0]
        if self.in_place:
            tops = [bottoms[0]]
            names[self.tops[0]] = bottoms[0]
        else:
            tops = [
                self._top_name(t, names, autonames) for t in self.tops
            ]
        if tops:
            cfg["top"] = tops if len(tops) > 1 else tops[0]

        pfield = param_field(self.type_name)
        type_params = {}
        for k, v in self.params.items():
            if k in _GENERIC_FIELDS or k.endswith("_param"):
                cfg[k] = v
            elif pfield is None:
                raise ValueError(
                    f"{self.type_name} takes no type-specific params "
                    f"(got {k!r})"
                )
            else:
                type_params[k] = v
        if type_params:
            merged = dict(cfg.get(pfield, {}))
            merged.update(type_params)
            cfg[pfield] = merged
        layers[self] = cfg


class Layers:
    """The ``L`` pseudo-module: ``L.Convolution(bottom, num_output=8)``
    builds a Function and returns its Top(s) (ref net_spec.py:195-209)."""

    def __getattr__(self, name: str):
        def layer_fn(*args, **kwargs):
            fn = Function(name, args, kwargs)
            if fn.ntop == 0:
                return fn
            if fn.ntop == 1:
                return fn.tops[0]
            return fn.tops

        return layer_fn


L = Layers()


def to_dict(*tops, name: str | None = None) -> dict:
    """NetParameter dict computing all ``tops`` (ref net_spec.py:43-54)."""
    layers: OrderedDict = OrderedDict()
    names: dict = {}
    autonames: Counter = Counter()
    for top in tops:
        top.fn._to_dict(layers, names, autonames)
    msg: dict = {}
    if name is not None:
        msg["name"] = name
    msg["layer"] = list(layers.values())
    return msg


class NetSpec:
    """Ordered namespace of named Tops; assignment names the blob
    (ref net_spec.py:163-192)."""

    def __init__(self):
        super().__setattr__("tops", OrderedDict())

    def __setattr__(self, name, value):
        self.tops[name] = value

    def __getattr__(self, name):
        try:
            return self.tops[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setitem__(self, key, value):
        self.tops[key] = value

    def __getitem__(self, key):
        return self.tops[key]

    def __delitem__(self, key):
        del self.tops[key]

    def to_dict(self, name: str | None = None) -> dict:
        layers: OrderedDict = OrderedDict()
        names = {v: k for k, v in self.tops.items()}
        autonames: Counter = Counter()
        for top in self.tops.values():
            top.fn._to_dict(layers, names, autonames)
        msg: dict = {}
        if name is not None:
            msg["name"] = name
        msg["layer"] = list(layers.values())
        return msg

    def to_prototxt(self, name: str | None = None) -> str:
        return emit_prototxt(self.to_dict(name))


# --- text serialization ----------------------------------------------------

# Fields whose string values are free-form (always quoted); other all-caps
# identifier strings are protobuf enum tokens and must stay bare.
_ALWAYS_QUOTED = {
    "name", "type", "top", "bottom", "source", "mean_file", "root_folder",
    "snapshot_prefix", "net", "train_net", "test_net", "layer", "module",
    "file_name",
}
_ENUM_TOKEN = re.compile(r"[A-Z][A-Z0-9_]*$")


def _emit_value(field: str, v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    if field not in _ALWAYS_QUOTED and _ENUM_TOKEN.fullmatch(s):
        return s  # enum token (MAX, TRAIN, SUM, ...)
    escaped = s.replace("\\", "\\\\").replace('"', '\\"')
    return f'"{escaped}"'


def _emit_fields(msg: dict, indent: int, out: list) -> None:
    pad = "  " * indent
    for field, value in msg.items():
        values = value if isinstance(value, list) else [value]
        for v in values:
            if isinstance(v, dict):
                out.append(f"{pad}{field} {{")
                _emit_fields(v, indent + 1, out)
                out.append(f"{pad}}}")
            else:
                out.append(f"{pad}{field}: {_emit_value(field, v)}")


def emit_prototxt(msg: dict) -> str:
    """Serialize a NetParameter dict to prototxt text (the inverse of
    nn.prototxt.parse_prototxt; Caffe-TextFormat-compatible)."""
    out: list = []
    _emit_fields(msg, 0, out)
    return "\n".join(out) + "\n"
