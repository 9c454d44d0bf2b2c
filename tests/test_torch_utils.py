"""The port's utilities against the JAX package's on the CPU: analytic FLOP
counts, SSIM / PSNR, the debug visualisations, the caffemodel converter
and glog."""

import io
import os
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nct_tpu.config import Config as JaxConfig
from nct_tpu.models import caffe_io as jcaffe
from nct_tpu.models import vgg19 as jvgg
from nct_tpu.utils import flops as jflops
from nct_tpu.utils import ssim as jssim
from nct_tpu.utils import vis as jvis
from nct_tpu_torch import Config
from nct_tpu_torch.models import caffe_io as tcaffe
from nct_tpu_torch.models import vgg19 as tvgg
from nct_tpu_torch.utils import flops as tflops
from nct_tpu_torch.utils import glog
from nct_tpu_torch.utils import ssim as tssim
from nct_tpu_torch.utils import vis as tvis

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [{}, {"exact_nn_levels": 2, "wls_precond": "jacobi"},
           {"num_levels": 3, "k_num": 4, "window_radius": 3,
            "nl_precond": "block_jacobi"}]


# --- flops ------------------------------------------------------------------

@pytest.mark.parametrize("geom", [(452, 680, 600, 960), (1000, 750, 700, 1000)])
@pytest.mark.parametrize("overrides", CONFIGS)
def test_pipeline_counts_equal_jax(geom, overrides):
    got = tflops.pipeline_counts(*geom, Config(**overrides))
    ref = jflops.pipeline_counts(*geom, JaxConfig(**overrides))
    assert got == ref
    assert tflops.vgg_forward_flops(*geom[:2], "conv3_1") == \
        jflops.vgg_forward_flops(*geom[:2], "conv3_1")


def test_device_peaks_and_ratios():
    peak_f, peak_b = tflops.device_peaks("NVIDIA H100 80GB HBM3")
    assert (peak_f, peak_b) == (989e12, 3.35e12)
    with pytest.raises(ValueError, match="no peak rates"):
        tflops.device_peaks("Some Other Card")
    with pytest.raises(ValueError, match="no peak rates"):
        tflops.mfu(1e12, 1.0, device_name="Some Other Card")
    assert tflops.mfu(989e12, 2.0, device_name="NVIDIA H100 80GB HBM3") == 0.5
    assert tflops.mfu(1e12, 1.0, peak_flops=4e12) == 0.25
    # the same arithmetic as the JAX package's, at the caller's peaks
    r = tflops.roofline_fraction(2e12, 1e9, 0.5, peak_flops=jflops.V5E_PEAK_BF16,
                                 peak_bytes=jflops.V5E_HBM_BW)
    assert r == jflops.roofline_fraction(2e12, 1e9, 0.5)
    assert tflops.roofline_fraction(
        1e9, 3.35e12, 1.0, device_name="NVIDIA H100 80GB HBM3")["bound"] == \
        "bandwidth"


# --- SSIM / PSNR ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(40, 56, 3), (33, 29, 1), (25, 31)])
def test_ssim_psnr_match_jax(rng, shape):
    a = rng.integers(0, 256, shape).astype(np.uint8)
    noise = rng.integers(-20, 21, shape)
    b = np.clip(a.astype(int) + noise, 0, 255).astype(np.uint8)
    for x, y in ((a, b), (a, a), (a, 255 - a)):
        assert abs(tssim.ssim(x, y) - jssim.ssim(x, y)) <= 1e-5
        assert abs(tssim.ssim(torch.from_numpy(x), torch.from_numpy(y))
                   - jssim.ssim(x, y)) <= 1e-5
        assert tssim.psnr(x, y) == jssim.psnr(x, y)
    assert tssim.ssim(a, a) == pytest.approx(1.0, abs=1e-6)


# --- vis --------------------------------------------------------------------

def test_vis_bitwise_vs_jax(rng):
    nnf = np.stack([rng.integers(0, 37, (9, 11)), rng.integers(0, 23, (9, 11))],
                   -1).astype(np.int32)
    np.testing.assert_array_equal(
        tvis.flow_image(torch.from_numpy(nnf), 23, 37).numpy(),
        np.asarray(jvis.flow_image(jnp.asarray(nnf), 23, 37)))
    err = np.concatenate([rng.uniform(-0.2, 1.2, 500),
                          [0.0, 0.1242, 0.3747, 0.6253, 0.8758, 1.0]]
                         ).astype(np.float32).reshape(2, -1)
    for lo, hi in ((0.0, 1.0), (-0.1, 0.7)):
        np.testing.assert_array_equal(
            tvis.heat_image(torch.from_numpy(err), lo, hi).numpy(),
            np.asarray(jvis.heat_image(jnp.asarray(err), lo, hi)))
    labels = rng.integers(-3, 80, (7, 8)).astype(np.int32)
    np.testing.assert_array_equal(
        tvis.cluster_image(torch.from_numpy(labels)).numpy(),
        np.asarray(jvis.cluster_image(jnp.asarray(labels))))
    a = rng.uniform(-1, 7, (6, 5)).astype(np.float32)
    b = rng.uniform(-1, 1, (6, 5)).astype(np.float32)
    for got, ref in zip(tvis.coefficient_images(torch.from_numpy(a),
                                                torch.from_numpy(b)),
                        jvis.coefficient_images(jnp.asarray(a),
                                                jnp.asarray(b))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --- caffemodel converter ---------------------------------------------------

def _varint(v):
    out = b""
    while True:
        b7, v = v & 0x7F, v >> 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(field, wire, payload):
    tag = _varint((field << 3) | wire)
    return tag + (_varint(len(payload)) + payload if wire == 2 else payload)


def _fake_caffemodel(rng, layer_field, name_field, blob_field, upto):
    """A NetParameter with the VGG-19 conv layers up to ``upto``, in the
    V1 (legacy 4-d blob dims) or the current (BlobShape) encoding, plus a
    layer the converter ignores."""
    out = b""
    in_c = 3
    for name, out_c in tvgg.VGG19_CONV_LAYERS:
        w = rng.standard_normal((out_c, in_c, 3, 3)).astype(np.float32)
        b = rng.standard_normal(out_c).astype(np.float32)

        def blob(arr):
            if layer_field == 2:
                dims = b"".join(_field(f, 0, _varint(d)) for f, d in
                                zip((1, 2, 3, 4), (1,) * (4 - arr.ndim)
                                    + arr.shape))
            else:
                shape = b"".join(_field(1, 0, _varint(d)) for d in arr.shape)
                dims = _field(7, 2, shape)
            return dims + _field(5, 2, arr.astype("<f4").tobytes())

        layer = _field(name_field, 2, name.encode())
        layer += _field(blob_field, 2, blob(w)) + _field(blob_field, 2, blob(b))
        out += _field(layer_field, 2, layer)
        in_c = out_c
        if name == upto:
            break
    fc = _field(name_field, 2, b"fc6") + _field(
        blob_field, 2, _field(5, 2, np.ones(4, "<f4").tobytes()))
    return out + _field(layer_field, 2, fc)


@pytest.mark.parametrize("layer_field,name_field,blob_field",
                         [(2, 4, 6), (100, 1, 7)], ids=["v1", "layer"])
def test_caffemodel_convert_and_load(tmp_path, rng, layer_field, name_field,
                                     blob_field):
    path = tmp_path / "vgg.caffemodel"
    path.write_bytes(_fake_caffemodel(rng, layer_field, name_field,
                                      blob_field, "conv3_1"))
    got = tcaffe.read_caffemodel(str(path))
    ref = jcaffe.read_caffemodel(str(path))
    assert list(got) == list(ref)
    for name in ref:
        for x, y in zip(got[name], ref[name]):
            np.testing.assert_array_equal(x, y)

    npz = tmp_path / "vgg.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "nct_tpu_torch.tools.convert_vgg19", str(path),
         str(npz)], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert "converted 5 layers" in proc.stdout
    model = tvgg.load_params(str(npz))
    params = jvgg.load_params(str(npz))
    assert list(model.convs) == list(params) == [
        "conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1"]
    want = tvgg.params_from_numpy(params)
    for name in params:
        for attr in ("weight", "bias"):
            torch.testing.assert_close(getattr(model.convs[name], attr),
                                       getattr(want.convs[name], attr),
                                       rtol=0, atol=0)
        # OIHW in the port is the caffemodel's own (out, in, kh, kw) layout
        np.testing.assert_array_equal(model.convs[name].weight.numpy(),
                                      got[name][0])


def test_write_caffemodel_round_trip(tmp_path, rng):
    layers = {"conv1_1": [rng.standard_normal((64, 3, 3, 3)).astype(np.float32),
                          rng.standard_normal(64).astype(np.float32)]}
    path = tmp_path / "w.caffemodel"
    tcaffe.write_caffemodel(str(path), layers)
    assert path.read_bytes() == _write_jax(tmp_path, layers)
    back = tcaffe.read_caffemodel(str(path))
    for x, y in zip(back["conv1_1"], layers["conv1_1"]):
        np.testing.assert_array_equal(x, y)
    (tmp_path / "e.caffemodel").write_bytes(b"")
    with pytest.raises(ValueError, match="no VGG-19 conv layers"):
        tcaffe.caffemodel_to_npz(str(tmp_path / "e.caffemodel"),
                                 str(tmp_path / "e.npz"))


def _write_jax(tmp_path, layers):
    path = tmp_path / "jax.caffemodel"
    jcaffe.write_caffemodel(str(path), layers)
    return path.read_bytes()


# --- glog -------------------------------------------------------------------

@pytest.fixture()
def stream():
    buf = io.StringIO()
    glog.set_stream(buf)
    old = glog._min_level
    glog.set_min_log_level(0)
    yield buf
    glog.set_stream(None)
    glog.set_min_log_level(old)


_LINE = re.compile(r"^([IWEF])(\d{4}) (\d{2}:\d{2}:\d{2}\.\d{6}) (\d+) "
                   r"([\w.]+\.py):(\d+)\] (.*)$")


def test_glog_levels_and_format(stream):
    glog.info("a")
    glog.warning("b")
    glog.error("c")
    lines = stream.getvalue().splitlines()
    assert [ln[0] for ln in lines] == ["I", "W", "E"]
    m = _LINE.match(lines[0])
    assert m and m.group(5) == "test_torch_utils.py" and m.group(7) == "a"
    glog.set_min_log_level(glog.ERROR)
    glog.info("dropped")
    glog.error("kept")
    assert "dropped" not in stream.getvalue()
    assert stream.getvalue().splitlines()[-1].endswith("kept")
    with pytest.raises(glog.CheckError):
        glog.log(glog.FATAL, "boom")
    assert "test_torch_utils.py" in stream.getvalue().splitlines()[-1]


def test_glog_checks(stream):
    glog.CHECK(True)
    glog.CHECK_EQ(3, 3)
    glog.CHECK_NE(3, 4)
    glog.CHECK_LT(1, 2)
    glog.CHECK_LE(2, 2)
    glog.CHECK_GT(3, 2)
    glog.CHECK_GE(2, 2)
    assert glog.CHECK_NOTNONE(5) == 5
    with pytest.raises(glog.CheckError) as e:
        glog.CHECK_EQ(3, 4, "shape mismatch")
    assert "Check failed: a == b (3 vs. 4) shape mismatch" in str(e.value)
    for bad in (lambda: glog.CHECK(False, "x"), lambda: glog.CHECK_GE(1, 2),
                lambda: glog.CHECK_NOTNONE(None), lambda: glog.fatal("f")):
        with pytest.raises(glog.CheckError):
            bad()
    assert all(ln.startswith("F") for ln in stream.getvalue().splitlines())
