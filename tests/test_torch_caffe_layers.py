"""Every layer type of the Caffe framework: the port's ``Net`` against the
JAX package's on the same seeded inputs and parameters.

Each case of ``tests/torch_caffe_cases.py`` is a one- or two-layer net.
The JAX package gets 4-D inputs as NHWC and its 4-D outputs come back to
NCHW for the comparison; its parameters (filler draws, or the case's own)
reach the port through ``params_from_jax``.  Tolerances (float32):
elementwise layers 1e-5 relative, products and reductions 1e-4 relative.
Also: the port's registry has the JAX registry's keys, Dropout's TRAIN
mask, and the fillers' statistics.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nct_tpu.nn import LAYER_REGISTRY as JAX_REGISTRY
from nct_tpu.nn import Net as JaxNet
from nct_tpu_torch.nn import LAYER_REGISTRY, Net
from nct_tpu_torch.nn.fillers import fill
from nct_tpu_torch.nn.net import params_from_jax

sys.path.insert(0, os.path.dirname(__file__))
from torch_caffe_cases import TOL, case_inputs, cases  # noqa: E402

torch.set_num_threads(1)

CASES = {c.name: c for c in cases()}


def _nhwc(a):
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def _nchw(a):
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def _run_both(case, tmp_path):
    inputs = case_inputs(case)
    h5_j, h5_t = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    jnet = JaxNet(case.prototxt(inputs, h5_j))
    for name, entry in (case.params or {}).items():
        jnet.set_params(name, {k: jnp.asarray(v) for k, v in entry.items()})
    if case.init:
        jnet.init_params({k: _nhwc(v).shape for k, v in inputs.items()})
    feed = {k: jnp.asarray(_nhwc(v)) for k, v in inputs.items()}
    # one XLA program per case (cheaper than compiling op by op); Filter's
    # output shape depends on the data, so it runs eagerly
    run = (jnet.forward if case.layer_type == "Filter"
           else jax.jit(jnet.forward, static_argnums=1))
    jout = run(feed, case.outputs or None)
    tnet = Net(case.prototxt(inputs, h5_t), device="cpu")
    if jnet.params:
        shapes = {k: v.shape for k, v in inputs.items()}
        for name, entry in params_from_jax(tnet, jnet.params, shapes).items():
            tnet.set_params(name, entry)
    tout = tnet.forward({k: torch.from_numpy(v) for k, v in inputs.items()},
                        case.outputs or None)
    return inputs, jout, tout, (h5_j, h5_t)


def test_registries_have_the_same_keys():
    assert sorted(LAYER_REGISTRY) == sorted(JAX_REGISTRY)
    assert len(LAYER_REGISTRY) == 59


def test_every_registry_key_has_a_case():
    assert {c.layer_type for c in CASES.values()} == set(JAX_REGISTRY)


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name, tmp_path):
    case = CASES[name]
    inputs, jout, tout, (h5_j, h5_t) = _run_both(case, tmp_path)
    rtol, atol = TOL[case.kind]
    if name == "HDF5Output":
        import h5py

        with h5py.File(h5_j) as fj, h5py.File(h5_t) as ft:
            np.testing.assert_array_equal(_nchw(fj["data_0"][()]),
                                          ft["data_0"][()])
            np.testing.assert_array_equal(fj["label_0"][()],
                                          ft["label_0"][()])
            np.testing.assert_array_equal(ft["data_0"][()], inputs["x"])
        return
    for k in case.outputs:
        want = np.asarray(jout[k])
        if case.layer_type == "Flatten":
            # the JAX package flattens NHWC in (h, w, c) order; Caffe and
            # the port in (c, h, w)
            n, c, h, w = inputs["x"].shape
            want = want.reshape(n, h, w, c).transpose(0, 3, 1, 2).reshape(
                n, -1)
        else:
            want = _nchw(want)
        got = tout[k].numpy()
        assert got.shape == want.shape, (k, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"{name}: blob {k}")


def test_hdf5_output_without_h5py_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    case = CASES["HDF5Output"]
    inputs = case_inputs(case)
    net = Net(case.prototxt(inputs, str(tmp_path / "o.h5")), device="cpu")
    with pytest.raises(ImportError, match="h5py"):
        net.forward({k: torch.from_numpy(v) for k, v in inputs.items()})


def test_dropout_train_phase_draws_from_the_generator():
    net = Net('input: "x"\nlayer { name: "d" type: "Dropout" bottom: "x" '
              'top: "y" dropout_param { dropout_ratio: 0.25 } }',
              phase="TRAIN", device="cpu")
    x = torch.ones(4, 8, 16, 16)
    assert torch.equal(net.forward({"x": x})["y"], x)   # no generator: identity
    a = net.forward({"x": x}, generator=torch.Generator().manual_seed(3))["y"]
    b = net.forward({"x": x}, generator=torch.Generator().manual_seed(3))["y"]
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.allclose(a[kept], torch.tensor(1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    test = Net('input: "x"\nlayer { name: "d" type: "Dropout" bottom: "x" '
               'top: "y" }', device="cpu")
    assert torch.equal(
        test.forward({"x": x}, generator=torch.Generator())["y"], x)


@pytest.mark.parametrize("spec,mean,std", [
    ({"type": "uniform", "min": -1.0, "max": 3.0}, 1.0, 4 / np.sqrt(12)),
    ({"type": "gaussian", "mean": 0.5, "std": 2.0}, 0.5, 2.0),
    ({"type": "xavier"}, 0.0, np.sqrt(1.0 / 72)),           # fan_in 72
    ({"type": "xavier", "variance_norm": "FAN_OUT"}, 0.0,
     np.sqrt(1.0 / 144)),                                   # fan_out 144
    ({"type": "msra"}, 0.0, np.sqrt(2.0 / 72)),
    ({"type": "msra", "variance_norm": "AVERAGE"}, 0.0, np.sqrt(2.0 / 108)),
])
def test_filler_statistics(spec, mean, std):
    # an OIHW conv blob (16, 8, 3, 3): fan_in = 8*9, fan_out = 16*9
    w = fill(torch.Generator().manual_seed(0), spec, (16, 8, 3, 3))
    big = torch.cat([w.reshape(-1)] + [
        fill(torch.Generator().manual_seed(s), spec, (16, 8, 3, 3)).reshape(-1)
        for s in range(1, 40)])
    assert w.shape == (16, 8, 3, 3)
    assert abs(big.mean().item() - mean) < 0.03 * std
    assert abs(big.std().item() - std) < 0.03 * std


def test_filler_constant_unitball_bilinear():
    g = torch.Generator().manual_seed(0)
    assert torch.equal(fill(g, None, (2, 3)), torch.zeros(2, 3))
    assert torch.equal(fill(g, {"type": "constant", "value": 0.5}, (4,)),
                       torch.full((4,), 0.5))
    ball = fill(g, {"type": "positive_unitball"}, (5, 3, 2, 2))
    assert (ball >= 0).all()
    torch.testing.assert_close(ball.reshape(5, -1).sum(1), torch.ones(5))
    bil = fill(g, {"type": "bilinear"}, (3, 1, 4, 4))
    want = np.outer(*[np.array([0.25, 0.75, 0.75, 0.25])] * 2)
    for c in range(3):
        np.testing.assert_allclose(bil[c, 0].numpy(), want, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown filler"):
        fill(g, {"type": "nope"}, (2,))
