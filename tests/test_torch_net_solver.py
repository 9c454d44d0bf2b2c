"""The port's ``NetSolver``, ImageData / MemoryData sources and
``caffe_tool train`` against the JAX package's on the same inputs.

The small net is ``chip_smoke.small_train_net`` (conv, ReLU, pool,
InnerProduct, ReLU, InnerProduct, SoftmaxWithLoss; no Dropout here), fed
by MemoryData (NCHW here, NHWC in JAX), with JAX's initial parameters
carried over by ``params_from_jax``: 20 iterations' losses within rtol
1e-4.  ImageData batches over the JPEG fixtures are bitwise JAX's
``ImageDataSource`` batches (transposed from NHWC).
"""

import io
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from nct_tpu.data.image_data import ImageDataSource as JaxImageData
from nct_tpu.nn.prototxt import parse_prototxt as jparse_net
from nct_tpu.train.solver_proto import NetSolver as JaxNetSolver
from nct_tpu.train.solver_proto import parse_solver_prototxt as jparse
from nct_tpu.utils import glog as jglog
from nct_tpu_torch.data import make_data_source
from nct_tpu_torch.data.image_data import ImageDataSource
from nct_tpu_torch.nn import parse_prototxt
from nct_tpu_torch.nn.net import params_from_jax
from nct_tpu_torch.tools import caffe_tool
from nct_tpu_torch.train.solver_proto import NetSolver, parse_solver_prototxt
from nct_tpu_torch.utils import glog

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke  # noqa: E402  (the small net of phase 13)

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "jpeg")
IMAGES = os.path.join(FIXTURES, "imagedata")

SOLVER = """base_lr: 0.05
lr_policy: "step"
stepsize: 8
gamma: 0.5
momentum: 0.9
weight_decay: 0.0005
type: "{kind}"
max_iter: 20
display: 1
random_seed: 5
test_iter: 2
test_interval: {interval}
"""

TEST_LAYERS = """
layer { name: "tdata" type: "MemoryData" top: "data" top: "label"
  include { phase: TEST } memory_data_param { batch_size: 8 channels: 3
  height: 12 width: 12 } }
layer { name: "accuracy" type: "Accuracy" bottom: "ip2" bottom: "label"
  top: "accuracy" include { phase: TEST } }
"""


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((32, 3, 12, 12)).astype(np.float32),
            rng.integers(0, 4, 32).astype(np.float32))


def _net_dict(parse, nhwc: bool, with_test: bool):
    text = chip_smoke.small_train_net(8, dropout=False)
    if with_test:
        text += TEST_LAYERS
    net = parse(text)
    layers = net["layer"]
    layers[0]["include"] = {"phase": "TRAIN"}
    for layer, seed in zip([layers[0]] + [c for c in layers
                                          if c["name"] == "tdata"], (0, 1)):
        data, labels = _arrays(seed)
        layer["__arrays__"] = (data.transpose(0, 2, 3, 1) if nhwc else data,
                               labels)
    return net


def _losses(text: str) -> list[float]:
    return [float(v) for v in re.findall(r"Iteration \d+, loss = (\S+)",
                                         text)]


@pytest.mark.parametrize("kind", ["SGD", "Adam"])
def test_net_solver_follows_jax_for_20_iterations(kind):
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jproto = jparse(SOLVER.format(kind=kind, interval=0))
    jproto.net = _net_dict(jparse_net, nhwc=True, with_test=False)
    proto = parse_solver_prototxt(SOLVER.format(kind=kind, interval=0))
    proto.net = _net_dict(parse_prototxt, nhwc=False, with_test=False)
    jglog.set_stream(jbuf)
    glog.set_stream(tbuf)
    try:
        jns = JaxNetSolver(jproto)
        ns = NetSolver(proto, device="cpu")
        ns.set_params(params_from_jax(
            ns.net, jax.tree_util.tree_map(np.asarray, jns.solver.params),
            ns.input_shapes))
        jns.solve()
        ns.solve()
    finally:
        jglog.set_stream(None)
        glog.set_stream(None)
    want, got = _losses(jbuf.getvalue()), _losses(tbuf.getvalue())
    assert len(want) == len(got) == 20
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_test_interval_prints_test_net_outputs_like_jax():
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jproto = jparse(SOLVER.format(kind="SGD", interval=10))
    jproto.net = _net_dict(jparse_net, nhwc=True, with_test=True)
    proto = parse_solver_prototxt(SOLVER.format(kind="SGD", interval=10))
    proto.net = _net_dict(parse_prototxt, nhwc=False, with_test=True)
    jglog.set_stream(jbuf)
    glog.set_stream(tbuf)
    try:
        jns = JaxNetSolver(jproto)
        ns = NetSolver(proto, device="cpu")
        ns.set_params(params_from_jax(
            ns.net, jax.tree_util.tree_map(np.asarray, jns.solver.params),
            ns.input_shapes))
        jns.solve()
        ns.solve()
    finally:
        jglog.set_stream(None)
        glog.set_stream(None)
    pattern = r"Test net output #(\d): (\w+) = (\S+)"
    want = re.findall(pattern, jbuf.getvalue())
    got = re.findall(pattern, tbuf.getvalue())
    # before step 1, after steps 10 and 20: loss and accuracy each time
    assert [g[:2] for g in got] == [w[:2] for w in want] and len(got) == 6
    assert re.findall(r"Iteration (\d+), Testing net", tbuf.getvalue()) == \
        ["0", "10", "20"]
    np.testing.assert_allclose([float(g[2]) for g in got],
                               [float(w[2]) for w in want], rtol=1e-4,
                               atol=1e-6)


def _image_list(tmp_path) -> str:
    path = tmp_path / "list.txt"
    path.write_text("".join(f"img_{i:02d}.jpg {i % 4}\n" for i in range(16)))
    return str(path)


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("resize", [False, True], ids=["256", "resized"])
def test_image_data_batches_bitwise_jax(tmp_path, phase, resize):
    """Crop (random at TRAIN, centre at TEST), mirror, shuffle, rand_skip,
    mean values and scale, with the same seed; ``resized`` goes through
    new_height / new_width (the native loader's resize)."""
    idp = {"source": _image_list(tmp_path), "root_folder": IMAGES + "/",
           "batch_size": 6, "shuffle": True, "rand_skip": 5}
    if resize:
        idp.update(new_height=61, new_width=75)
    cfg = {"type": "ImageData", "top": ["data", "label"],
           "image_data_param": idp,
           "transform_param": {"crop_size": 48, "mirror": True,
                               "mean_value": [104, 117, 123],
                               "scale": 0.017}}
    mine = make_data_source(cfg, phase=phase, seed=9)
    assert isinstance(mine, ImageDataSource)
    ref = JaxImageData(cfg, phase=phase, seed=9)
    for _ in range(4):          # 24 images: the list wraps around
        x, y = mine.next_batch()
        jx, jy = ref.next_batch()
        assert x.shape == (6, 3, 48, 48) and x.dtype == np.float32
        np.testing.assert_array_equal(x, jx.transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("resize", [False, True], ids=["256", "resized"])
def test_image_data_part_is_its_block_of_the_batch(tmp_path, phase, resize):
    """``next_batch((i, n))`` is rows [i k, (i + 1) k) of the whole batch,
    decodes only those, and leaves the stream (position and generator)
    where the whole batch leaves it."""
    idp = {"source": _image_list(tmp_path), "root_folder": IMAGES + "/",
           "batch_size": 6, "shuffle": True}
    if resize:
        idp.update(new_height=61, new_width=75)
    cfg = {"type": "ImageData", "top": ["data", "label"],
           "image_data_param": idp,
           "transform_param": {"crop_size": 48, "mirror": True}}
    whole = make_data_source(cfg, phase=phase, seed=4)
    parts = {(i, n): make_data_source(cfg, phase=phase, seed=4)
             for n in (2, 3) for i in range(n)}
    for _ in range(3):          # 18 images: the list wraps around
        x, y = whole.next_batch()
        for (i, n), src in parts.items():
            k = 6 // n
            px, py = src.next_batch((i, n))
            np.testing.assert_array_equal(px, x[i * k:(i + 1) * k])
            np.testing.assert_array_equal(py, y[i * k:(i + 1) * k])
    for (i, n), src in parts.items():
        assert src.decoded * n == whole.decoded == 18
        assert src.state()["pos"] == whole.state()["pos"]
        assert src.state()["rng"] == whole.state()["rng"]


def test_image_hw_reads_the_header(tmp_path):
    """``image_hw`` gives each JPEG fixture's and a PNG's decoded size."""
    from nct_tpu_torch.data import png
    from nct_tpu_torch.data.image_data import image_hw
    from nct_tpu_torch.io import imread_bgr

    names = [os.path.join(FIXTURES, n) for n in sorted(os.listdir(FIXTURES))
             if n.endswith(".jpg")]
    png.write(str(tmp_path / "a.png"), np.zeros((5, 9, 3), np.uint8))
    for path in names + [str(tmp_path / "a.png")]:
        assert image_hw(path) == imread_bgr(path).shape[:2], path


@pytest.mark.parametrize("ltype", ["Data", "WindowData", "HDF5Data"])
def test_unported_data_sources_name_their_roadmap_item(tmp_path, ltype):
    """The three sources ROADMAP Queue 1 #3b.2 listed as still to port are
    built by ``make_data_source`` now, and each gives its first batch."""
    import h5py

    from nct_tpu_torch.data.records import RecordWriter, RecordShardSource
    from nct_tpu_torch.data.hdf5_data import HDF5DataSource
    from nct_tpu_torch.data.window_data import WindowDataSource

    img = np.zeros((16, 16, 3), np.uint8)
    if ltype == "Data":
        with RecordWriter(str(tmp_path / "s.ncr")) as wr:
            wr.write_image(img, 1)
        cfg = {"data_param": {"source": str(tmp_path / "s.ncr"),
                              "batch_size": 2}}
        want = RecordShardSource
    elif ltype == "WindowData":
        (tmp_path / "w.txt").write_text(
            "# 0\nimg_00.jpg\n3\n256\n256\n2\n1 0.9 0 0 50 50\n"
            "2 0.1 10 10 90 90\n")
        cfg = {"window_data_param": {"source": str(tmp_path / "w.txt"),
                                     "root_folder": IMAGES + "/",
                                     "batch_size": 2},
               "transform_param": {"crop_size": 8}}
        want = WindowDataSource
    else:
        with h5py.File(tmp_path / "a.h5", "w") as f:
            f.create_dataset("data", data=np.zeros((3, 3, 4, 4), np.float32))
            f.create_dataset("label", data=np.ones(3, np.float32))
        (tmp_path / "list.txt").write_text("a.h5\n")
        cfg = {"hdf5_data_param": {"source": str(tmp_path / "list.txt"),
                                   "batch_size": 2}}
        want = HDF5DataSource
    src = make_data_source(dict(cfg, type=ltype, top=["data", "label"]))
    assert isinstance(src, want)
    x, y = src.next_batch()
    assert x.shape[:2] == (2, 3) and y.shape == (2,)


def test_caffe_tool_train_in_process(tmp_path, capsys):
    """``caffe_tool train`` from a solver file whose net reads ImageData
    over the fixture JPEGs; then a resume from its iteration-4 snapshot
    (bitwise the uninterrupted run), and --weights from an npz."""
    net = tmp_path / "net.prototxt"
    net.write_text(chip_smoke.small_train_net(
        16, image_list=_image_list(tmp_path), hw=16, root=IMAGES + "/"))
    solver = tmp_path / "solver.prototxt"

    def write(prefix, max_iter):
        solver.write_text(f'net: "{net}"\nbase_lr: 0.01\nmomentum: 0.9\n'
                          f'lr_policy: "fixed"\nmax_iter: {max_iter}\n'
                          f'snapshot: 4\nsnapshot_prefix: '
                          f'"{tmp_path / prefix}"\nrandom_seed: 2\n')

    write("whole", 8)
    assert caffe_tool.main(["train", "--solver", str(solver),
                            "--device", "cpu"]) == 0
    assert "Optimization Done." in capsys.readouterr().out
    write("resumed", 8)
    assert caffe_tool.main(["train", "--solver", str(solver), "--device",
                            "cpu", "--snapshot",
                            str(tmp_path / "whole_iter_4.npz")]) == 0
    assert "restored iter 4" in capsys.readouterr().out
    whole = np.load(tmp_path / "whole_iter_8.npz")
    resumed = np.load(tmp_path / "resumed_iter_8.npz")
    keys = [k for k in whole.files if k.startswith(("params/", "state/"))]
    assert keys and sorted(keys) == sorted(
        k for k in resumed.files if k.startswith(("params/", "state/")))
    for k in keys:
        np.testing.assert_array_equal(resumed[k], whole[k])
    write("warm", 1)
    assert caffe_tool.main(["train", "--solver", str(solver), "--device",
                            "cpu", "--weights",
                            str(tmp_path / "whole_iter_8.npz")]) == 0
    assert "Optimization Done." in capsys.readouterr().out
