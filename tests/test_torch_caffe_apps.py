"""The port's pycaffe-style apps and Caffe tools against the JAX package's:
``Transformer``, ``oversample``, ``load_image`` / ``resize_image``,
``Classifier.predict`` (with and without oversampling) and
``Detector.detect_windows`` on PNG fixtures written with ``data/png.py``;
``caffe_tool test`` / ``time --device cpu`` and ``extract_features``
through their ``main`` in this process, on one thread."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nct_tpu.models import vgg19 as jax_vgg19
from nct_tpu.nn import apps as jax_apps
from nct_tpu_torch.data import png
from nct_tpu_torch.nn import apps
from nct_tpu_torch.nn.net import params_from_jax
from nct_tpu_torch.tools import caffe_tool, extract_features

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEPLOY = """
name: "toynet"
input: "data"
input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" } bias_filler { type: "gaussian" } } }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "pool" type: "Pooling" bottom: "conv" top: "pool"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "fc" type: "InnerProduct" bottom: "pool" top: "score"
  inner_product_param { num_output: 5
    weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "prob" type: "Softmax" bottom: "score" top: "prob" }
"""

APP_ARGS = dict(raw_scale=255.0, channel_swap=(2, 1, 0),
                mean=np.array([104.0, 117.0, 123.0], np.float32))


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Two seeded RGB PNGs (smooth, so resizes and crops differ)."""
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(((14, 17), (14, 17))):
        base = rng.uniform(0, 255, (4, 5, 3))
        ys = np.linspace(0, 3, h)[:, None]
        xs = np.linspace(0, 4, w)[None, :]
        img = base[ys.astype(int), xs.astype(int)] * 0.7 + rng.uniform(
            0, 76, (h, w, 3))
        path = str(d / f"im{i}.png")
        png.write(path, img.round().astype(np.uint8))
        paths.append(path)
    return paths


def test_load_image_and_resize_like_jax(pngs):
    for color in (True, False):
        got = apps.load_image(pngs[0], color=color)
        want = jax_apps.load_image(pngs[0], color=color)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    im = apps.load_image(pngs[0])
    np.testing.assert_allclose(apps.resize_image(im, (9, 23)),
                               jax_apps.resize_image(im, (9, 23)),
                               rtol=1e-6, atol=1e-6)


def test_oversample_and_transformer_like_jax(pngs):
    ims = [apps.load_image(p)[:12, :12] for p in pngs]
    np.testing.assert_array_equal(apps.oversample(ims, (8, 6)),
                                  jax_apps.oversample(ims, (8, 6)))
    shape = (1, 3, 12, 12)
    port, ref = apps.Transformer({"data": shape}), jax_apps.Transformer(
        {"data": shape})
    for tr in (port, ref):
        tr.set_transpose("data", (2, 0, 1))
        tr.set_raw_scale("data", 255.0)
        tr.set_channel_swap("data", (2, 1, 0))
        tr.set_mean("data", APP_ARGS["mean"])
        tr.set_input_scale("data", 0.5)
    pre = port.preprocess("data", ims[0])
    assert pre.shape == (3, 12, 12)
    np.testing.assert_allclose(pre, ref.preprocess("data", ims[0]).transpose(
        2, 0, 1), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(port.deprocess("data", pre), ims[0],
                               rtol=1e-5, atol=1e-6)
    # a full (K, H, W) mean image, and the resize to the input's dims
    port.set_mean("data", np.arange(3 * 12 * 12, dtype=np.float32).reshape(
        3, 12, 12))
    full = port.preprocess("data", apps.load_image(pngs[0]))
    assert full.shape == (3, 12, 12)


def _carry(port_app, jax_app):
    net = port_app.net
    for name, entry in params_from_jax(net, jax_app.net.params,
                                       net.input_shapes).items():
        net.set_params(name, entry)


@pytest.mark.parametrize("oversample", [True, False])
def test_classifier_predict_like_jax(pngs, oversample):
    ref = jax_apps.Classifier(DEPLOY, image_dims=(10, 12), **APP_ARGS)
    clf = apps.Classifier(DEPLOY, image_dims=(10, 12), device="cpu",
                          **APP_ARGS)
    _carry(clf, ref)
    ims = [apps.load_image(p) for p in pngs]
    got = clf.predict(ims, oversample_crops=oversample)
    want = ref.predict(ims, oversample_crops=oversample)
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


def test_detector_windows_like_jax(pngs):
    ref = jax_apps.Detector(DEPLOY, context_pad=1, **APP_ARGS)
    det = apps.Detector(DEPLOY, context_pad=1, device="cpu", **APP_ARGS)
    _carry(det, ref)
    arr = apps.load_image(pngs[1])
    windows = [(pngs[0], [(0, 0, 10, 10), (3, 4, 13, 16)]),
               (arr, [(2, 1, 9, 11)])]
    got = det.detect_windows(windows)
    want = ref.detect_windows(windows)
    assert [(g["filename"], g["window"]) for g in got] == [
        (w["filename"], w["window"]) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["prediction"], w["prediction"],
                                   rtol=1e-5, atol=1e-6)


# every value constant, so the JAX tool's filler draws equal the port's
CONSTANT_TEST_NET = """
layer { name: "data" type: "DummyData" top: "data" top: "label"
  dummy_data_param { shape { dim: 6 dim: 4 } shape { dim: 6 }
    data_filler { type: "constant" value: 0.5 }
    data_filler { type: "constant" value: 2 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 3
    weight_filler { type: "constant" value: 0.25 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
layer { name: "accuracy" type: "Accuracy" bottom: "ip" bottom: "label"
  top: "accuracy" }
"""


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scores(text):
    return {line.split(" = ")[0]: float(line.split(" = ")[1])
            for line in text.splitlines() if " = " in line}


def test_caffe_tool_test_like_jax(tmp_path, capsys):
    path = tmp_path / "test.prototxt"
    path.write_text(CONSTANT_TEST_NET)
    assert caffe_tool.main(["test", "--model", str(path), "--iterations",
                            "3", "--device", "cpu"]) == 0
    port = _scores(capsys.readouterr().out)
    assert _jax_tool("caffe_tool").main(["test", "--model", str(path),
                                         "--iterations", "3"]) == 0
    ref = _scores(capsys.readouterr().out)
    assert set(port) == {"loss", "accuracy"}
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert port["loss"] == pytest.approx(np.log(3.0), rel=1e-5)
    assert 0.0 <= port["accuracy"] <= 1.0


def test_caffe_tool_time_cpu(tmp_path, capsys):
    path = tmp_path / "deploy.prototxt"
    path.write_text(DEPLOY)
    assert caffe_tool.main(["time", str(path), "12", "14", "--device",
                            "cpu", "--iterations", "2"]) == 0
    out = capsys.readouterr().out
    assert "host clock on the CPU" in out
    for name in ("conv", "relu", "pool", "fc", "prob"):
        assert any(line.split()[0] == name and line.endswith(" ms")
                   for line in out.splitlines())
    assert "whole net forward:" in out
    net, per_layer, total = caffe_tool.time_net(str(path), "cpu", (12, 14), 1)
    assert net.params["fc"]["w"].shape == (5, 4 * 6 * 7)
    assert len(per_layer) == 5 and total > 0


def test_caffe_tool_train_and_device_query(capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    # train runs on cuda unless given --device cpu (tests/
    # test_torch_net_solver.py trains on the CPU)
    solver = tmp_path / "s.prototxt"
    solver.write_text('net: "net.prototxt"\nbase_lr: 0.01\n')
    with pytest.raises(RuntimeError, match="no CUDA device"):
        caffe_tool.main(["train", "--solver", str(solver)])
    assert caffe_tool.main(["device_query"]) == 1
    assert "no CUDA device" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        caffe_tool.main(["test", "--model", "x.prototxt"])


def test_extract_features_like_jax(pngs, tmp_path):
    rng = np.random.default_rng(4)
    weights, in_c = {}, 3
    for name, out_c in jax_vgg19.VGG19_CONV_LAYERS[:3]:
        weights[f"{name}_w"] = (rng.standard_normal((3, 3, in_c, out_c))
                                * np.sqrt(2 / (9 * in_c))).astype(np.float32)
        weights[f"{name}_b"] = rng.standard_normal(out_c).astype(np.float32)
        in_c = out_c
    npz = str(tmp_path / "vgg.npz")
    np.savez(npz, **weights)
    out = str(tmp_path / "feats.npz")
    assert extract_features.main([out, pngs[0], "--taps", "conv2_1,conv1_1",
                                  "--weights", npz, "--device", "cpu"]) == 0
    from nct_tpu.io import imread_bgr

    want = jax_vgg19.features(jax_vgg19.load_params(npz),
                              jnp.asarray(imread_bgr(pngs[0])),
                              ("conv2_1", "conv1_1"))
    with np.load(out) as got:
        assert sorted(got.files) == ["im0/conv1_1", "im0/conv2_1"]
        for t in ("conv1_1", "conv2_1"):
            np.testing.assert_allclose(got[f"im0/{t}"], np.asarray(want[t]),
                                       rtol=1e-4, atol=1e-4)
