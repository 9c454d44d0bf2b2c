"""One small net per layer type of the Caffe framework, with seeded inputs.

``tests/test_torch_caffe_layers.py`` runs each case through the JAX
package's ``Net`` and the port's (parameters carried over by
``params_from_jax``); ``chip_smoke.py`` phase 12d runs each through the
port's ``Net`` on the card and on the CPU.  This module imports no JAX:
the card's machine has none.

Inputs are NCHW numpy arrays (4-D ones go to the JAX package as NHWC).
A case's ``params`` holds blobs whose layout both packages share
(BatchNorm statistics); ``init`` asks for filler weights
(``Net.init_params``).  ``kind`` picks the tolerance: ``elementwise``
layers at 1e-5 relative, ``product`` layers (reductions, products,
transcendental chains) at 1e-4 relative.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

# (rtol, atol) of float32 results, by kind
TOL = {"elementwise": (1e-5, 1e-6), "product": (1e-4, 1e-5)}


@dataclasses.dataclass(frozen=True)
class Case:
    name: str                  # registry key, or key-variant
    proto: str                 # the layers (inputs are declared from arrays)
    inputs: Callable[[np.random.Generator], dict[str, np.ndarray]]
    outputs: tuple[str, ...]
    kind: str = "elementwise"
    init: bool = False
    params: dict | None = None

    @property
    def layer_type(self) -> str:
        return self.name.split("-")[0]

    def prototxt(self, inputs: dict[str, np.ndarray], h5: str = "") -> str:
        """The net: an input declaration per array, then the layers
        (``h5`` is the HDF5Output case's file)."""
        decl = "".join(
            f'input: "{k}"\ninput_shape {{ '
            + " ".join(f"dim: {d}" for d in v.shape) + " }\n"
            for k, v in inputs.items())
        return decl + self.proto.replace("{h5}", h5)


def _n(rng, *shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _labels(rng, n_classes, *shape):
    return rng.integers(0, n_classes, shape).astype(np.float32)


def _x(shape=(2, 3, 9, 11), **kw):
    return lambda rng: {"x": _n(rng, *shape, **kw)}


def _layer(ltype, bottoms="x", tops="y", body="", name="l"):
    bs = "".join(f' bottom: "{b}"' for b in bottoms.split())
    ts = "".join(f' top: "{t}"' for t in tops.split())
    return f'layer {{ name: "{name}" type: "{ltype}"{bs}{ts} {body} }}\n'


def _one(name, body="", kind="elementwise", inputs=None, **kw):
    """A case of one layer of type name.split('-')[0] from x to y."""
    ltype = name.split("-")[0]
    return Case(name, _layer(ltype, body=body), inputs or _x(), ("y",),
                kind, **kw)


G = 'weight_filler { type: "gaussian" std: 0.3 } bias_filler { type: "gaussian" std: 0.1 }'


def _rois(rng, n, r, h, w):
    b = rng.integers(0, n, r)
    x1 = rng.uniform(0, w * 0.6, r)
    y1 = rng.uniform(0, h * 0.6, r)
    x2 = x1 + rng.uniform(1, w * 0.8, r)
    y2 = y1 + rng.uniform(1, h * 0.8, r)
    return np.stack([b, x1, y1, x2, y2], 1).astype(np.float32)


def _recurrent_inputs(rng, static=False, states=0):
    d = {"x": _n(rng, 4, 3, 5),
         "cont": np.array([[0, 0, 0], [1, 1, 0], [1, 0, 1], [1, 1, 1]],
                          np.float32)}
    if static:
        d["xs"] = _n(rng, 3, 2)
    for s in ("h0", "c0")[:states]:
        d[s] = _n(rng, 1, 3, 6)
    return d


def cases() -> list[Case]:
    prob = lambda rng: {  # noqa: E731  (probabilities and labels)
        "p": (lambda e: e / e.sum(1, keepdims=True))(
            np.exp(_n(rng, 4, 5))).astype(np.float32),
        "t": _labels(rng, 5, 4)}
    out = [
        # --- vision / products ------------------------------------------
        _one("Convolution", "convolution_param { num_output: 4 "
             f"kernel_size: 3 pad: 1 stride: 2 {G} }}", "product", init=True),
        _one("Convolution-group-dilation", "convolution_param { "
             f"num_output: 6 kernel_size: 3 pad: 2 dilation: 2 group: 2 {G} }}",
             "product", _x((2, 4, 9, 11)), init=True),
        _one("Deconvolution", "convolution_param { num_output: 4 "
             f"kernel_size: 4 stride: 2 pad: 1 {G} }}", "product",
             _x((2, 3, 4, 5)), init=True),
        _one("InnerProduct", f"inner_product_param {{ num_output: 7 {G} }}",
             "product", _x((2, 3, 4, 5)), init=True),
        Case("InnerProduct-after-Flatten",
             _layer("Flatten", tops="f", name="flat")
             + _layer("InnerProduct", "f", body="inner_product_param "
                      f"{{ num_output: 7 {G} }}"),
             _x((2, 3, 4, 5)), ("y",), "product", init=True),
        _one("Embed", "embed_param { input_dim: 7 num_output: 5 "
             f"{G} }}", inputs=lambda rng: {"x": _labels(rng, 7, 3, 4)},
             init=True),
        _one("Im2col", "convolution_param { kernel_size: 3 stride: 2 pad: 1 }"),
        _one("SPP", "spp_param { pyramid_height: 3 pool: MAX }"),
        _one("SPP-ave", "spp_param { pyramid_height: 3 pool: AVE }",
             "product"),
        Case("ROIPooling", _layer("ROIPooling", "x rois", body=(
            "roi_pooling_param { pooled_h: 3 pooled_w: 2 "
            "spatial_scale: 0.5 }")),
            lambda rng: {"x": _n(rng, 2, 3, 8, 10),
                         "rois": _rois(rng, 2, 5, 16, 20)}, ("y",)),
        Case("PSROIPooling", _layer("PSROIPooling", "x rois", body=(
            "psroi_pooling_param { output_dim: 2 group_size: 3 "
            "spatial_scale: 0.5 }")),
            lambda rng: {"x": _n(rng, 2, 18, 8, 9),
                         "rois": _rois(rng, 2, 4, 16, 18)}, ("y",),
            "product"),
        Case("BoxAnnotatorOHEM", _layer(
            "BoxAnnotatorOHEM", "rois loss labels w", "lab wt",
            "box_annotator_ohem_param { roi_per_img: 5 ignore_label: -1 }"),
            lambda rng: {
                "rois": np.concatenate([
                    np.broadcast_to(np.arange(2.0)[:, None, None, None],
                                    (2, 1, 3, 4)),
                    _n(rng, 2, 4, 3, 4)], 1).astype(np.float32),
                "loss": _n(rng, 2, 1, 3, 4),
                "labels": _labels(rng, 6, 2, 1, 3, 4),
                "w": _n(rng, 2, 8, 3, 4)}, ("lab", "wt")),
        # --- pooling and normalisation -------------------------------------
        _one("Pooling", "pooling_param { pool: MAX kernel_size: 3 stride: 2 }"),
        _one("Pooling-max-pad-clip",
             "pooling_param { pool: MAX kernel_size: 3 stride: 2 pad: 1 }",
             inputs=_x((2, 3, 8, 10))),
        _one("Pooling-ave-pad-overhang",
             "pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 }",
             "product"),
        _one("Pooling-ave-overhang",
             "pooling_param { pool: AVE kernel_size: 2 stride: 2 }",
             "product"),
        _one("Pooling-ave-global",
             "pooling_param { pool: AVE global_pooling: true }", "product"),
        _one("Pooling-max-global",
             "pooling_param { pool: MAX global_pooling: true }"),
        _one("Pooling-max-rect", "pooling_param { pool: MAX kernel_h: 3 "
             "kernel_w: 2 stride_h: 2 stride_w: 3 pad_h: 1 pad_w: 1 }"),
        _one("LRN", "lrn_param { local_size: 5 alpha: 0.01 beta: 0.75 }",
             "product", _x(lo=-4.0, hi=4.0)),
        _one("LRN-even", "lrn_param { local_size: 4 alpha: 0.02 beta: 0.6 }",
             "product", _x(lo=-4.0, hi=4.0)),
        _one("LRN-within", "lrn_param { local_size: 3 alpha: 0.05 "
             "beta: 0.75 norm_region: WITHIN_CHANNEL }", "product",
             _x(lo=-4.0, hi=4.0)),
        _one("BatchNorm", "batch_norm_param { eps: 0.001 }",
             params={"l": {"mean": np.array([0.5, -1.0, 2.0], np.float32),
                           "var": np.array([1.5, 0.5, 4.0], np.float32),
                           "scale_factor": np.array(2.0, np.float32)}}),
        _one("MVN", "", "product"),
        _one("MVN-across", "mvn_param { across_channels: true }", "product"),
        _one("Scale", 'scale_param { bias_term: true filler { type: '
             '"gaussian" std: 0.5 } bias_filler { type: "gaussian" '
             'std: 0.5 } }', init=True),
        _one("Bias", 'bias_param { filler { type: "gaussian" std: 0.5 } }',
             init=True),
        Case("Bias-bottom", _layer("Bias", "x b"),
             lambda rng: {"x": _n(rng, 2, 3, 4, 5), "b": _n(rng, 3)},
             ("y",)),
        _one("PReLU", 'prelu_param { filler { type: "gaussian" std: 0.5 } }',
             init=True),
        _one("Softmax", "softmax_param { axis: 1 }", "product"),
        # --- elementwise ---------------------------------------------------
        _one("ReLU", "relu_param { negative_slope: 0.1 }"),
        _one("Sigmoid"), _one("TanH"), _one("AbsVal"),
        _one("BNLL", kind="product"),
        _one("ELU", "elu_param { alpha: 0.7 }", "product"),
        _one("Power", "power_param { power: 2 scale: 0.5 shift: 1 }"),
        _one("Exp", "exp_param { base: 2 scale: 0.3 shift: 0.1 }", "product"),
        _one("Log", "log_param { base: 10 scale: 2 shift: 1 }", "product",
             _x(lo=0.1, hi=2.0)),
        _one("Threshold", "threshold_param { threshold: 0.2 }"),
        _one("Dropout", "dropout_param { dropout_ratio: 0.3 }"),
        Case("Input", 'layer { name: "in" type: "Input" top: "d" '
             "input_param { shape { dim: 2 dim: 3 dim: 4 dim: 5 } } }\n"
             + _layer("ReLU", "d"), lambda rng: {"d": _n(rng, 2, 3, 4, 5)},
             ("d", "y")),
        # --- routing and shapes -------------------------------------------
        Case("Concat", _layer("Concat", "x z"),
             lambda rng: {"x": _n(rng, 2, 3, 4, 5), "z": _n(rng, 2, 2, 4, 5)},
             ("y",)),
        Case("Eltwise", _layer("Eltwise", "x z", body=(
            "eltwise_param { operation: MAX }")),
            lambda rng: {"x": _n(rng, 2, 3, 4, 5), "z": _n(rng, 2, 3, 4, 5)},
            ("y",)),
        Case("Eltwise-prod", _layer("Eltwise", "x z", body=(
            "eltwise_param { operation: PROD }")),
            lambda rng: {"x": _n(rng, 2, 3, 4, 5), "z": _n(rng, 2, 3, 4, 5)},
            ("y",)),
        Case("Split", _layer("Split", tops="a b"), _x(), ("a", "b")),
        Case("Slice", _layer("Slice", tops="a b c", body=(
            "slice_param { axis: 1 slice_point: 1 slice_point: 3 }")),
            _x((2, 5, 4, 4)), ("a", "b", "c")),
        Case("Crop", _layer("Crop", "x ref", body=(
            "crop_param { axis: 2 offset: 1 offset: 2 }")),
            lambda rng: {"x": _n(rng, 2, 3, 9, 10),
                         "ref": _n(rng, 2, 3, 5, 6)}, ("y",)),
        _one("Reshape", "reshape_param { shape { dim: 0 dim: 3 dim: 2 "
             "dim: -1 } }", inputs=_x((2, 6, 3, 4))),
        _one("Reshape-3d", "reshape_param { shape { dim: 0 dim: -1 "
             "dim: 4 } }", inputs=_x((2, 6, 3, 4))),
        _one("Flatten", inputs=_x((2, 3, 4, 5))),
        _one("Reduction", "reduction_param { operation: MEAN axis: 1 "
             "coeff: 2 }", "product"),
        _one("Reduction-sumsq", "reduction_param { operation: SUMSQ "
             "axis: 2 }", "product"),
        _one("ArgMax", "argmax_param { top_k: 3 out_max_val: true }",
             inputs=_x((4, 10))),
        _one("ArgMax-axis", "argmax_param { axis: 1 }"),
        _one("Tile", "tile_param { axis: 1 tiles: 3 }",
             inputs=_x((2, 3, 4, 5))),
        Case("BatchReindex", _layer("BatchReindex", "x idx"),
             lambda rng: {"x": _n(rng, 4, 3, 2, 2),
                          "idx": np.array([3, 0, 0, 2, 1], np.float32)},
             ("y",)),
        Case("Filter", _layer("Filter", "x sel"),
             lambda rng: {"x": _n(rng, 4, 3, 2, 2),
                          "sel": np.array([1, 0, 1, 1], np.float32)},
             ("y",)),
        Case("Silence", _layer("ReLU") + _layer("Silence", "y", "",
                                                name="s"), _x(), ("y",)),
        Case("Parameter", 'layer { name: "l" type: "Parameter" top: "y" '
             "parameter_param { shape { dim: 2 dim: 3 } "
             'filler { type: "gaussian" std: 1.0 } } }\n'
             + _layer("ReLU", "y", "z", name="r"), _x(), ("y", "z"),
             init=True),
        Case("DummyData", 'layer { name: "dd" type: "DummyData" top: "a" '
             'top: "b" dummy_data_param { shape { dim: 2 dim: 3 dim: 4 '
             'dim: 5 } shape { dim: 2 dim: 3 } data_filler { type: '
             '"constant" value: 1.5 } data_filler { type: "constant" '
             "value: -2 } } }\n", _x(), ("a", "b")),
        Case("HDF5Output", _layer("HDF5Output", "x lab", "", body=(
            'hdf5_output_param { file_name: "{h5}" }')),
            lambda rng: {"x": _n(rng, 2, 3, 4, 5), "lab": _n(rng, 2, 1)},
            ()),
        # --- recurrent ------------------------------------------------------
        Case("RNN", _layer("RNN", "x cont h0", "y hT", body=(
            f"recurrent_param {{ num_output: 6 expose_hidden: true {G} }}")),
            lambda rng: _recurrent_inputs(rng, states=1), ("y", "hT"),
            "product", init=True),
        Case("LSTM", _layer("LSTM", "x cont xs h0 c0", "y hT cT", body=(
            f"recurrent_param {{ num_output: 6 expose_hidden: true {G} }}")),
            lambda rng: _recurrent_inputs(rng, static=True, states=2),
            ("y", "hT", "cT"), "product", init=True),
        Case("LSTMUnit", _layer("LSTMUnit", "c g cont", "c1 h1"),
             lambda rng: {"c": _n(rng, 1, 3, 4), "g": _n(rng, 1, 3, 16),
                          "cont": np.array([[1, 0, 1]], np.float32)},
             ("c1", "h1"), "product"),
        # --- losses and metrics ------------------------------------------
        Case("SoftmaxWithLoss", _layer("SoftmaxWithLoss", "x t", body=(
            "loss_param { ignore_label: 1 normalization: VALID }")),
            lambda rng: {"x": _n(rng, 2, 4, 3, 3),
                         "t": _labels(rng, 4, 2, 1, 3, 3)}, ("y",),
            "product"),
        Case("SoftmaxWithLossOHEM", _layer(
            "SoftmaxWithLossOHEM", "x t", "y prob per"),
            lambda rng: {"x": _n(rng, 2, 4, 3, 3),
                         "t": _labels(rng, 4, 2, 1, 3, 3)},
            ("y", "prob", "per"), "product"),
        Case("MultinomialLogisticLoss",
             _layer("MultinomialLogisticLoss", "p t"), prob, ("y",),
             "product"),
        Case("InfogainLoss", _layer("InfogainLoss", "p t H"),
             lambda rng: dict(prob(rng), H=_n(rng, 5, 5, lo=0.0, hi=1.0)),
             ("y",), "product"),
        Case("EuclideanLoss", _layer("EuclideanLoss", "x z"),
             lambda rng: {"x": _n(rng, 3, 4, 2, 2), "z": _n(rng, 3, 4, 2, 2)},
             ("y",), "product"),
        Case("SigmoidCrossEntropyLoss",
             _layer("SigmoidCrossEntropyLoss", "x t"),
             lambda rng: {"x": _n(rng, 3, 4) * 3, "t": _labels(rng, 2, 3, 4)},
             ("y",), "product"),
        Case("HingeLoss", _layer("HingeLoss", "x t", body=(
            "hinge_loss_param { norm: L2 }")),
            lambda rng: {"x": _n(rng, 4, 5), "t": _labels(rng, 5, 4)},
            ("y",), "product"),
        Case("ContrastiveLoss", _layer("ContrastiveLoss", "a b s", body=(
            "contrastive_loss_param { margin: 3.0 }")),
            lambda rng: {"a": _n(rng, 4, 6), "b": _n(rng, 4, 6),
                         "s": np.array([1, 0, 0, 1], np.float32)}, ("y",),
            "product"),
        Case("Accuracy", _layer("Accuracy", "x t", body=(
            "accuracy_param { top_k: 2 ignore_label: 3 }")),
            lambda rng: {"x": _n(rng, 6, 5), "t": _labels(rng, 5, 6)},
            ("y",), "product"),
        Case("SmoothL1Loss", _layer("SmoothL1Loss", "x z wi wo", body=(
            "smooth_l1_loss_param { sigma: 2.0 }")),
            lambda rng: {k: _n(rng, 2, 4, 3, 3)
                         for k in ("x", "z", "wi", "wo")}, ("y",), "product"),
        Case("SmoothL1LossOHEM", _layer("SmoothL1LossOHEM", "x z w",
                                        "y per"),
             lambda rng: {k: _n(rng, 2, 4, 3, 3) for k in ("x", "z", "w")},
             ("y", "per"), "product"),
    ]
    return out


def case_inputs(case: Case, seed: int = 0) -> dict[str, np.ndarray]:
    return case.inputs(np.random.default_rng(seed))
