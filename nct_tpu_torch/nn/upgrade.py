"""Proto upgrade shims: V0/V1 NetParameter and legacy solver upgrades (a
pure-Python copy of ``nct_tpu/nn/upgrade.py``).

Rebuilds src/caffe/util/upgrade_proto.cpp over the framework's parsed
prototxt dicts: old network definitions load transparently the way the
reference's ReadNetParamsFromTextFile upgrade chain makes them
(upgrade_proto.cpp: UpgradeNetAsNeeded — V0 padding/flat-field layers ->
V1 `layers` with enum types -> V2 `layer` with string types, the data
transform-param split, and the input-field -> Input-layer conversion;
UpgradeSolverAsNeeded for solver_type enums).

All functions take and return plain dicts (nn.prototxt.parse_prototxt
output) and are idempotent on already-modern messages.
"""

from __future__ import annotations

import copy


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


# V1LayerParameter_LayerType enum -> modern type string
# (upgrade_proto.cpp UpgradeV1LayerType:865-952)
V1_TYPE_NAMES = {
    "NONE": "",
    "ABSVAL": "AbsVal", "ACCURACY": "Accuracy", "ARGMAX": "ArgMax",
    "BNLL": "BNLL", "CONCAT": "Concat",
    "CONTRASTIVE_LOSS": "ContrastiveLoss", "CONVOLUTION": "Convolution",
    "DECONVOLUTION": "Deconvolution", "DATA": "Data", "DROPOUT": "Dropout",
    "DUMMY_DATA": "DummyData", "EUCLIDEAN_LOSS": "EuclideanLoss",
    "ELTWISE": "Eltwise", "EXP": "Exp", "FLATTEN": "Flatten",
    "HDF5_DATA": "HDF5Data", "HDF5_OUTPUT": "HDF5Output",
    "HINGE_LOSS": "HingeLoss", "IM2COL": "Im2col",
    "IMAGE_DATA": "ImageData", "INFOGAIN_LOSS": "InfogainLoss",
    "INNER_PRODUCT": "InnerProduct", "LRN": "LRN",
    "MEMORY_DATA": "MemoryData",
    "MULTINOMIAL_LOGISTIC_LOSS": "MultinomialLogisticLoss", "MVN": "MVN",
    "POOLING": "Pooling", "POWER": "Power", "RELU": "ReLU",
    "SIGMOID": "Sigmoid",
    "SIGMOID_CROSS_ENTROPY_LOSS": "SigmoidCrossEntropyLoss",
    "SILENCE": "Silence", "SOFTMAX": "Softmax",
    "SOFTMAX_LOSS": "SoftmaxWithLoss", "SPLIT": "Split", "SLICE": "Slice",
    "TANH": "TanH", "WINDOW_DATA": "WindowData", "THRESHOLD": "Threshold",
}

# V0 string type -> V1 enum name (upgrade_proto.cpp UpgradeV0LayerType
# :542-596); V1 -> V2 then finishes the name mapping.
V0_TYPE_NAMES = {
    "accuracy": "ACCURACY", "bnll": "BNLL", "concat": "CONCAT",
    "conv": "CONVOLUTION", "data": "DATA", "dropout": "DROPOUT",
    "euclidean_loss": "EUCLIDEAN_LOSS", "flatten": "FLATTEN",
    "hdf5_data": "HDF5_DATA", "hdf5_output": "HDF5_OUTPUT",
    "im2col": "IM2COL", "images": "IMAGE_DATA",
    "infogain_loss": "INFOGAIN_LOSS", "innerproduct": "INNER_PRODUCT",
    "lrn": "LRN", "multinomial_logistic_loss": "MULTINOMIAL_LOGISTIC_LOSS",
    "pool": "POOLING", "relu": "RELU", "sigmoid": "SIGMOID",
    "softmax": "SOFTMAX", "softmax_loss": "SOFTMAX_LOSS", "split": "SPLIT",
    "tanh": "TANH", "window_data": "WINDOW_DATA",
}

# V0 pool enum values (caffe.proto V0LayerParameter.PoolMethod)
_V0_POOL = {0: "MAX", 1: "AVE", 2: "STOCHASTIC"}

# solver_type enum -> type string (upgrade_proto.cpp UpgradeSolverType)
SOLVER_TYPE_NAMES = {
    "SGD": "SGD", "NESTEROV": "Nesterov", "ADAGRAD": "AdaGrad",
    "RMSPROP": "RMSProp", "ADADELTA": "AdaDelta", "ADAM": "Adam",
    0: "SGD", 1: "Nesterov", 2: "AdaGrad", 3: "RMSProp", 4: "AdaDelta",
    5: "Adam",
}


# --- V0 -> V1 ---------------------------------------------------------------

def net_needs_v0_upgrade(net: dict) -> bool:
    """V0 layers nest their connection-less params in an inner ``layer``
    message (NetParameterPrettyPrinted; upgrade_proto.cpp:14-22)."""
    return any(isinstance(e, dict) and "layer" in e
               for e in _as_list(net.get("layers")))


def _upgrade_v0_layer(entry: dict) -> dict:
    """One V0 connection -> a V1-shaped dict (string enum type, typed
    param messages; upgrade_proto.cpp UpgradeV0LayerParameter:152-540)."""
    v0 = entry.get("layer", {})
    typ = str(v0.get("type", ""))
    out: dict = {}
    if "name" in v0:
        out["name"] = v0["name"]
    out["type"] = V0_TYPE_NAMES.get(typ, typ.upper())
    for k in ("bottom", "top"):
        if k in entry:
            out[k] = entry[k]
    # learning-rate / decay multipliers ride through like V1's
    for k in ("blobs_lr", "weight_decay"):
        if k in v0:
            out[k] = v0[k]

    def param(msg_key):
        return out.setdefault(msg_key, {})

    t = out["type"]
    if "num_output" in v0:
        if t == "CONVOLUTION":
            param("convolution_param")["num_output"] = v0["num_output"]
        elif t == "INNER_PRODUCT":
            param("inner_product_param")["num_output"] = v0["num_output"]
    if "biasterm" in v0:
        key = ("convolution_param" if t == "CONVOLUTION"
               else "inner_product_param")
        param(key)["bias_term"] = v0["biasterm"]
    for filler in ("weight_filler", "bias_filler"):
        if filler in v0:
            key = ("convolution_param" if t == "CONVOLUTION"
                   else "inner_product_param")
            param(key)[filler] = v0[filler]
    if "kernelsize" in v0:
        key = "convolution_param" if t == "CONVOLUTION" else "pooling_param"
        param(key)["kernel_size"] = v0["kernelsize"]
    if "stride" in v0:
        key = "convolution_param" if t == "CONVOLUTION" else "pooling_param"
        param(key)["stride"] = v0["stride"]
    if "pad" in v0:
        key = "convolution_param" if t == "CONVOLUTION" else "pooling_param"
        param(key)["pad"] = v0["pad"]
    if "group" in v0 and t == "CONVOLUTION":
        param("convolution_param")["group"] = v0["group"]
    if "pool" in v0 and t == "POOLING":
        p = v0["pool"]
        param("pooling_param")["pool"] = (
            _V0_POOL.get(int(p)) if str(p).isdigit() else p)
    if "dropout_ratio" in v0:
        param("dropout_param")["dropout_ratio"] = v0["dropout_ratio"]
    for k, msg in (("local_size", "lrn_param"), ("alpha", "lrn_param"),
                   ("beta", "lrn_param")):
        if k in v0 and t == "LRN":
            param(msg)[k] = v0[k]
    # data-source fields (source/batchsize/scale/cropsize/mirror...)
    if t in ("DATA", "IMAGE_DATA", "WINDOW_DATA", "HDF5_DATA"):
        msg = {"DATA": "data_param", "IMAGE_DATA": "image_data_param",
               "WINDOW_DATA": "window_data_param",
               "HDF5_DATA": "hdf5_data_param"}[t]
        renames = {"batchsize": "batch_size", "meanfile": "mean_file",
                   "cropsize": "crop_size"}
        for k in ("source", "batchsize", "scale", "meanfile", "cropsize",
                  "mirror", "rand_skip", "shuffle_images", "new_height",
                  "new_width"):
            if k in v0:
                param(msg)[renames.get(k, k)] = v0[k]
    return out


def upgrade_v0_net(net: dict) -> dict:
    net = copy.deepcopy(net)
    net["layers"] = [
        _upgrade_v0_layer(e) if isinstance(e, dict) and "layer" in e else e
        for e in _as_list(net.get("layers"))
    ]
    return net


# --- V1 -> V2 ---------------------------------------------------------------

def net_needs_v1_upgrade(net: dict) -> bool:
    """V1 nets use the ``layers`` field (caffe.proto NetParameter field 2;
    upgrade_proto.cpp NetNeedsV1ToV2Upgrade)."""
    return bool(_as_list(net.get("layers")))


def upgrade_v1_net(net: dict) -> dict:
    """``layers`` + enum types + blobs_lr/weight_decay -> ``layer`` +
    string types + param {lr_mult, decay_mult}
    (UpgradeV1LayerParameter:668-863)."""
    net = copy.deepcopy(net)
    out_layers = []
    for cfg in _as_list(net.pop("layers", None)):
        cfg = dict(cfg)
        t = str(cfg.get("type", ""))
        if t in V1_TYPE_NAMES:
            cfg["type"] = V1_TYPE_NAMES[t]
        lrs = [float(v) for v in _as_list(cfg.pop("blobs_lr", None))]
        decays = [float(v) for v in _as_list(cfg.pop("weight_decay", None))]
        if lrs or decays:
            n = max(len(lrs), len(decays))
            params = []
            for i in range(n):
                p = {}
                if i < len(lrs):
                    p["lr_mult"] = lrs[i]
                if i < len(decays):
                    p["decay_mult"] = decays[i]
                params.append(p)
            cfg["param"] = params
        out_layers.append(cfg)
    net["layer"] = out_layers
    return net


# --- data transform split ---------------------------------------------------

_DATA_PARAM_KEYS = ("data_param", "image_data_param", "window_data_param")
_TRANSFORM_FIELDS = ("scale", "mean_file", "crop_size", "mirror")


def net_needs_data_upgrade(net: dict) -> bool:
    """Transform fields living inside data params
    (NetNeedsDataUpgrade:598-627)."""
    for cfg in _as_list(net.get("layer")) + _as_list(net.get("layers")):
        for key in _DATA_PARAM_KEYS:
            dp = cfg.get(key)
            if isinstance(dp, dict) and any(
                    f in dp for f in _TRANSFORM_FIELDS):
                return True
    return False


def upgrade_data_net(net: dict) -> dict:
    """Move scale/mean_file/crop_size/mirror out of data params into
    transform_param (UpgradeNetDataTransformation:629-652)."""
    net = copy.deepcopy(net)
    for cfg in _as_list(net.get("layer")) + _as_list(net.get("layers")):
        for key in _DATA_PARAM_KEYS:
            dp = cfg.get(key)
            if not isinstance(dp, dict):
                continue
            moved = {f: dp.pop(f) for f in _TRANSFORM_FIELDS if f in dp}
            if moved:
                tp = cfg.setdefault("transform_param", {})
                for f, v in moved.items():
                    tp.setdefault(f, v)
    return net


# --- input fields -> Input layer ---------------------------------------------

def upgrade_net_input(net: dict) -> dict:
    """``input:`` (+ input_shape/input_dim) -> a leading Input layer
    (UpgradeNetInput:958-993).  The framework's Net accepts raw input
    fields natively, so this shim exists for tool-level normalization."""
    net = copy.deepcopy(net)
    inputs = [str(i) for i in _as_list(net.pop("input", None))]
    if not inputs:
        return net
    shapes = _as_list(net.pop("input_shape", None))
    dims = [int(d) for d in _as_list(net.pop("input_dim", None))]
    if not shapes and dims:
        shapes = [{"dim": dims[4 * i: 4 * i + 4]}
                  for i in range(len(inputs))]
    layer = {"name": "input", "type": "Input", "top": inputs}
    if shapes:
        layer["input_param"] = {"shape": shapes}
    net["layer"] = [layer] + _as_list(net.get("layer"))
    return net


# --- whole-net + solver entry points -----------------------------------------

def upgrade_net(net: dict, convert_inputs: bool = False) -> dict:
    """UpgradeNetAsNeeded: V0 -> V1 -> data split -> V2 (+ optional
    input-layer conversion).  Idempotent on modern nets."""
    if net_needs_v0_upgrade(net):
        net = upgrade_v0_net(net)
    if net_needs_data_upgrade(net):
        net = upgrade_data_net(net)
    if net_needs_v1_upgrade(net):
        net = upgrade_v1_net(net)
    if convert_inputs and net.get("input"):
        net = upgrade_net_input(net)
    return net


def solver_needs_type_upgrade(solver: dict) -> bool:
    return "solver_type" in solver


def upgrade_solver(solver: dict) -> dict:
    """solver_type enum -> type string (UpgradeSolverType); idempotent."""
    if not solver_needs_type_upgrade(solver):
        return solver
    solver = copy.deepcopy(solver)
    st = solver.pop("solver_type")
    key = int(st) if str(st).lstrip("-").isdigit() else str(st).upper()
    if key not in SOLVER_TYPE_NAMES:
        raise ValueError(f"unknown solver_type {st!r}")
    solver.setdefault("type", SOLVER_TYPE_NAMES[key])
    return solver
