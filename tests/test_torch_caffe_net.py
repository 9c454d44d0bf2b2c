"""The port's Caffe net framework (``nct_tpu_torch.nn``) against the JAX
package's: prototxt parsing, upgrades, NetSpec emission and coord_map on
the same texts; the ``Net``'s phase filter, in-place rebinds and early
stop; a VGG-style deploy net built with NetSpec (blobs against the JAX
``Net`` through ``params_from_jax``, conv taps against the port's
``models.vgg19``); weights from a caffemodel; and Caffe's (c, h, w)
order of an InnerProduct on a 4-D bottom, where the JAX package differs.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nct_tpu.nn import Net as JaxNet
from nct_tpu.nn import coord_map as jax_coord_map
from nct_tpu.nn import net_spec as jax_net_spec
from nct_tpu.nn import prototxt as jax_prototxt
from nct_tpu.nn import upgrade as jax_upgrade
from nct_tpu_torch.models import caffe_io, vgg19
from nct_tpu_torch.nn import Net, coord_map, net_spec, prototxt, upgrade
from nct_tpu_torch.nn.net import params_from_jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the deploy nets of phase 12)

torch.set_num_threads(1)

V0_NET = """
name: "v0net"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
layers {
  layer { name: "c1" type: "conv" num_output: 4 kernelsize: 3 pad: 1
          stride: 1 weight_filler { type: "gaussian" std: 0.1 }
          blobs_lr: 1 blobs_lr: 2 }
  bottom: "data" top: "c1"
}
layers { layer { name: "r1" type: "relu" } bottom: "c1" top: "c1" }
layers {
  layer { name: "p1" type: "pool" kernelsize: 2 stride: 2 pool: 1 }
  bottom: "c1" top: "p1"
}
layers {
  layer { name: "d" type: "data" source: "x.lmdb" batchsize: 4
          cropsize: 3 mirror: true }
  top: "dd"
}
"""

V1_NET = """
name: "v1net"  # a comment
input: "data"
layers { name: "c1" type: CONVOLUTION bottom: "data" top: "c1"
  blobs_lr: 1 blobs_lr: 2 weight_decay: 1 weight_decay: 0
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
layers { name: "r1" type: RELU bottom: "c1" top: "c1" }
layers { name: "s1" type: SOFTMAX_LOSS bottom: "c1" bottom: "label"
  top: "loss" include { phase: TRAIN } }
layers { name: "w" type: DATA top: "x" data_param { source: "a\\"b"
  scale: 0.5 crop_size: 7 } }
"""

PHASED = """
input: "data"
layer { name: "drop" type: "Dropout" bottom: "data" top: "data"
        include { phase: TRAIN } }
layer { name: "r" type: "ReLU" bottom: "data" top: "out" }
layer { name: "acc" type: "Accuracy" bottom: "out" bottom: "label"
        top: "acc" include { phase: TEST } }
layer { name: "l2" type: "EuclideanLoss" bottom: "out" bottom: "data"
        top: "l2" loss_weight: 0.5 }
layer { name: "sm" type: "SoftmaxWithLoss" bottom: "out" bottom: "label"
        top: "sm" }
"""

FCN = """
input: "data"
layer { name: "c" type: "Convolution" bottom: "data" top: "c"
  convolution_param { num_output: 2 kernel_size: 3 pad: 1 } }
layer { name: "p" type: "Pooling" bottom: "c" top: "p"
  pooling_param { kernel_size: 2 stride: 2 } }
layer { name: "u" type: "Deconvolution" bottom: "p" top: "u"
  convolution_param { num_output: 2 kernel_size: 4 stride: 2 pad: %d } }
layer { name: "cr" type: "Crop" bottom: "u" bottom: "data" top: "cr"
  crop_param { offset: 1 } }
"""


@pytest.mark.parametrize("text", [V0_NET, V1_NET, PHASED, FCN % 1])
def test_prototxt_and_upgrades_like_jax(text):
    msg = prototxt.parse_prototxt(text)
    assert msg == jax_prototxt.parse_prototxt(text)
    assert upgrade.upgrade_net(msg) == jax_upgrade.upgrade_net(msg)
    assert (upgrade.upgrade_net(msg, convert_inputs=True)
            == jax_upgrade.upgrade_net(msg, convert_inputs=True))
    for fn in ("net_needs_v0_upgrade", "net_needs_v1_upgrade",
               "net_needs_data_upgrade"):
        assert getattr(upgrade, fn)(msg) == getattr(jax_upgrade, fn)(msg)
    solver = {"solver_type": "ADAM", "base_lr": 0.1}
    assert upgrade.upgrade_solver(solver) == jax_upgrade.upgrade_solver(solver)
    # the upgraded net loads with the port's Net as with the JAX one
    assert ([c["type"] for c in Net(text, device="cpu").layers]
            == [c["type"] for c in JaxNet(text).layers])


def _spec(mod):
    n = mod.NetSpec()
    n.data, n.label = mod.L.DummyData(dummy_data_param=dict(
        shape=[dict(dim=[4, 2, 6, 6]), dict(dim=[4])],
        data_filler=dict(type="gaussian", std=0.5)), ntop=2)
    n.conv1 = mod.L.Convolution(n.data, num_output=4, kernel_size=3, pad=1,
                                weight_filler=dict(type="xavier"))
    n.relu1 = mod.L.ReLU(n.conv1, in_place=True)
    n.pool1 = mod.L.Pooling(n.relu1, pool="MAX", kernel_size=2, stride=2)
    n.fc = mod.L.InnerProduct(n.pool1, num_output=3,
                              weight_filler=dict(type="xavier"))
    n.loss = mod.L.SoftmaxWithLoss(n.fc, n.label, loss_weight=2.0)
    n.acc = mod.L.Accuracy(n.fc, n.label, include=dict(phase="TEST"))
    return n


def test_netspec_emits_like_jax():
    port, ref = _spec(net_spec), _spec(jax_net_spec)
    assert port.to_dict(name="mlp") == ref.to_dict(name="mlp")
    text = port.to_prototxt(name="mlp")
    assert text == ref.to_prototxt(name="mlp")
    assert prototxt.parse_prototxt(text)["layer"][1]["convolution_param"][
        "num_output"] == 4
    assert (net_spec.to_dict(port.loss, name="x")
            == jax_net_spec.to_dict(ref.loss, name="x"))
    # the VGG-19 deploy net of chip_smoke.py phase 12 round-trips through text
    spec = chip_smoke.vgg19_deploy()
    again = Net(net_spec.emit_prototxt(spec), device="cpu")
    assert [c["name"] for c in again.layers] == [
        c["name"] for c in spec["layer"]]
    assert again.input_shapes == {"data": (10, 3, 224, 224)}


@pytest.mark.parametrize("pad", [0, 1])
def test_coord_map_like_jax(pad):
    text = FCN % pad
    port, ref = Net(text, device="cpu"), JaxNet(text)
    for a, b in (("u", "data"), ("p", "data"), ("data", "p"), ("cr", "c")):
        assert (coord_map.coord_map_from_to(port, a, b)
                == jax_coord_map.coord_map_from_to(ref, a, b))
    assert (coord_map.crop_offsets(port, "u", "data")
            == jax_coord_map.crop_offsets(ref, "u", "data") == 1 - pad)
    with pytest.raises(ValueError, match="scale"):
        coord_map.crop_offsets(port, "p", "data")


@pytest.mark.parametrize("phase", ["TEST", "TRAIN"])
def test_phase_filter_loss_tops_and_blob_names(phase):
    port, ref = Net(PHASED, phase=phase, device="cpu"), JaxNet(PHASED, phase)
    assert [c["name"] for c in port.layers] == [c["name"] for c in ref.layers]
    assert port.loss_tops() == ref.loss_tops()
    assert port.blob_names() == ref.blob_names()
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    lab = np.array([0, 4, 2], np.float32)
    got = port.forward({"data": x, "label": lab})
    want = ref.forward({"data": jnp.asarray(x), "label": jnp.asarray(lab)})
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


def test_inplace_rebind_and_early_stop():
    text = """
    input: "data"
    layer { name: "c" type: "Convolution" bottom: "data" top: "c"
            convolution_param { num_output: 4 kernel_size: 1 } }
    layer { name: "r" type: "ReLU" bottom: "c" top: "c" }
    layer { name: "later" type: "NotARegisteredType" bottom: "c" top: "z" }
    """
    net = Net(text, device="cpu")
    w = np.random.default_rng(1).standard_normal((4, 3, 1, 1))
    net.set_params("c", {"w": w})
    x = torch.randn(1, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    out = net.forward({"data": x}, ["c"])       # stops before "later"
    assert list(out) == ["c"] and out["c"].dtype == torch.float32
    want = torch.relu(torch.nn.functional.conv2d(
        x, torch.tensor(w, dtype=torch.float32)))
    torch.testing.assert_close(out["c"], want)  # post-ReLU: the rebind
    with pytest.raises(NotImplementedError, match="NotARegisteredType"):
        net.forward({"data": x})


def test_net_runs_on_cuda_unless_asked_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Net(FCN % 1)
    assert Net(FCN % 1, device="cpu").device == torch.device("cpu")


def test_init_params_seeded_on_the_cpu_generator():
    text = chip_smoke.caffenet_deploy(2, 67, 67, div=16, fc=16, classes=5)
    a, b, c = (Net(text, device="cpu") for _ in range(3))
    shapes = {"data": (2, 3, 67, 67)}
    a.init_params(shapes, seed=3)
    b.init_params(shapes, seed=3)
    c.init_params(shapes, seed=4)
    assert a.params.keys() == b.params.keys()
    shapes_of = {k: {n: tuple(t.shape) for n, t in v.items()}
                 for k, v in a.params.items()}
    assert shapes_of["conv2"] == {"w": (16, 3, 5, 5), "b": (16,)}  # group 2
    assert shapes_of["fc6"]["w"] == (16, 16)        # 16 channels x 1 x 1
    for name, entry in a.params.items():
        for k, v in entry.items():
            assert torch.equal(v, b.params[name][k])
    assert not torch.equal(a.params["fc8"]["w"], c.params["fc8"]["w"])
    # a layer name with a '.' (not a module key) still holds its params
    a.set_params("conv.x", {"w": np.ones((2, 2), np.float32)})
    assert a.params["conv.x"]["w"].shape == (2, 2)


def test_vgg_style_deploy_net_matches_jax_and_vgg19():
    """A narrow VGG-19 deploy net (every 16th channel) at 36x40: each blob
    against the JAX ``Net`` through ``params_from_jax`` (1e-4 relative),
    and its conv taps against the port's ``models.vgg19`` (1e-5)."""
    spec = chip_smoke.vgg19_deploy(2, 36, 40, div=16, fc=32, classes=10)
    ref = JaxNet(spec)
    ref.init_params({"data": (2, 36, 40, 3)}, seed=5)
    net = Net(spec, device="cpu")
    for name, entry in params_from_jax(net, ref.params,
                                       {"data": (2, 3, 36, 40)}).items():
        net.set_params(name, entry)
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (2, 36, 40, 3)).astype(np.uint8)
    x = img.astype(np.float32) - np.float32(vgg19.BGR_MEAN)
    want = ref.forward({"data": jnp.asarray(x)})
    got = net.forward({"data": torch.from_numpy(x.transpose(0, 3, 1, 2))})
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        v = v.transpose(0, 3, 1, 2) if v.ndim == 4 else v
        scale = max(float(np.abs(v).max()), 1e-6)
        np.testing.assert_allclose(got[k].numpy() / scale, v / scale,
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    model = vgg19.VGG19({name: (net.params[name]["w"], net.params[name]["b"])
                         for name, _ in vgg19.VGG19_CONV_LAYERS})
    taps = model(torch.from_numpy(img[1]), vgg19.PIPELINE_TAPS)
    for t in vgg19.PIPELINE_TAPS:
        torch.testing.assert_close(got[t][1].permute(1, 2, 0), taps[t],
                                   rtol=1e-5, atol=1e-5)


CAFFEMODEL_NET = """
input: "data"
input_shape { dim: 2 dim: 3 dim: 6 dim: 7 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
layer { name: "bn" type: "BatchNorm" bottom: "conv" top: "conv" }
layer { name: "sc" type: "Scale" bottom: "conv" top: "conv"
  scale_param { bias_term: true } }
layer { name: "pr" type: "PReLU" bottom: "conv" top: "conv" }
layer { name: "up" type: "Deconvolution" bottom: "conv" top: "up"
  convolution_param { num_output: 5 kernel_size: 4 stride: 2 pad: 1 } }
layer { name: "pool" type: "Pooling" bottom: "up" top: "pool"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 } }
layer { name: "fc" type: "InnerProduct" bottom: "pool" top: "fc"
  inner_product_param { num_output: 3 } }
"""


def _caffemodel(path):
    """Blobs in Caffe's layouts, written by the port's caffe_io."""
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    blobs = {
        "conv": [f(4, 3, 3, 3), f(4)],
        "bn": [f(4), rng.uniform(0.5, 2, 4).astype(np.float32),
               np.array([2.0], np.float32)],
        "sc": [f(4), f(4)],
        "pr": [f(4) * 0.3],
        "up": [f(4, 5, 4, 4), f(5)],
        "fc": [f(3, 5 * 6 * 7), f(3)],           # (out, in): in is (c, h, w)
    }
    caffe_io.write_caffemodel(path, blobs)
    return blobs


def test_copy_trained_layers_from_caffemodel(tmp_path):
    path = str(tmp_path / "w.caffemodel")
    blobs = _caffemodel(path)
    net = Net(CAFFEMODEL_NET, device="cpu")
    assert net.copy_trained_layers_from(path) == list(blobs)
    np.testing.assert_array_equal(net.params["up"]["w"].numpy(),
                                  blobs["up"][0])
    ref = JaxNet(CAFFEMODEL_NET)
    ref.copy_trained_layers_from(path)
    x = np.random.default_rng(8).standard_normal((2, 3, 6, 7)).astype(
        np.float32)
    got = net.forward({"data": x})
    want = ref.forward({"data": jnp.asarray(x.transpose(0, 2, 3, 1))})
    for k in ("conv", "up", "pool"):
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(want[k]).transpose(0, 3, 1, 2),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_inner_product_follows_caffe_order_on_a_4d_bottom(tmp_path):
    """Caffe flattens a 4-D bottom in (c, h, w) order, so a caffemodel's
    (out, in) weight indexes ``in`` that way.  The port computes what a
    numpy Caffe reference computes; the JAX package, which flattens NHWC
    blobs in (h, w, c) order, applies the rows permuted."""
    path = str(tmp_path / "w.caffemodel")
    blobs = _caffemodel(path)
    net = Net(CAFFEMODEL_NET, device="cpu")
    net.copy_trained_layers_from(path)
    x = np.random.default_rng(9).standard_normal((2, 3, 6, 7)).astype(
        np.float32)
    out = net.forward({"data": x})
    pool = out["pool"].numpy()                     # [2, 5, 6, 7]
    w, b = blobs["fc"]
    caffe = pool.reshape(2, -1) @ w.T + b          # numpy Caffe reference
    np.testing.assert_allclose(out["fc"].numpy(), caffe, rtol=1e-5, atol=1e-5)
    ref = JaxNet(CAFFEMODEL_NET)
    ref.copy_trained_layers_from(path)
    jax_fc = np.asarray(ref.forward(
        {"data": jnp.asarray(x.transpose(0, 2, 3, 1))})["fc"])
    nhwc_order = pool.transpose(0, 2, 3, 1).reshape(2, -1) @ w.T + b
    np.testing.assert_allclose(jax_fc, nhwc_order, rtol=1e-4, atol=1e-4)
    assert np.abs(jax_fc - caffe).max() > 0.1      # the JAX-side finding


BF16_NET = """
input: "data"
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 group: 2
    weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "gaussian" std: 0.5 } } }
layer { name: "pool" type: "Pooling" bottom: "conv" top: "pool"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "fc" type: "InnerProduct" bottom: "pool" top: "fc"
  inner_product_param { num_output: 6
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "gaussian" std: 0.5 } } }
"""


def test_bfloat16_inputs_round_weights_and_accumulate_in_f32():
    ref = JaxNet(BF16_NET)
    ref.init_params({"data": (2, 9, 10, 4)}, seed=1)
    net = Net(BF16_NET, device="cpu")
    for name, entry in params_from_jax(net, ref.params,
                                       {"data": (2, 4, 9, 10)}).items():
        net.set_params(name, entry)
    x = np.random.default_rng(3).standard_normal((2, 4, 9, 10)) * 20
    xb = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    got = net.forward({"data": xb})
    want = ref.forward({"data": jnp.asarray(
        xb.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16)})
    for k in ("conv", "fc"):
        assert got[k].dtype == torch.bfloat16
        v = np.asarray(want[k].astype(jnp.float32))
        v = v.transpose(0, 3, 1, 2) if v.ndim == 4 else v
        scale = float(np.abs(v).max())
        # one bf16 rounding of the f32 result: 2^-8 relative
        np.testing.assert_allclose(got[k].float().numpy() / scale, v / scale,
                                   rtol=2 ** -7, atol=2 ** -7, err_msg=k)
