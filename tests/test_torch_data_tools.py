"""The port's dataset tools (``nct_tpu_torch.tools``: convert_imageset,
compute_image_mean, convert_db, upgrade_proto, draw_net, parse_log)
against the JAX package's ``tools/`` scripts on the same inputs, each run
in process through ``main(argv)``: records, LMDB, LevelDB, the upgraded
prototxt, DOT and text byte-equal; HDF5 shards and the mean array-equal;
the parse_log CSVs row-equal over a log the port's ``NetSolver``
prints."""

import csv
import importlib.util
import io
import os

import h5py
import numpy as np
import pytest

from nct_tpu_torch.nn import emit_prototxt
from nct_tpu_torch.tools import (compute_image_mean, convert_db,
                                 convert_imageset, draw_net, parse_log,
                                 upgrade_proto)
from nct_tpu_torch.train.solver_proto import NetSolver, parse_solver_prototxt
from nct_tpu_torch.utils import glog

from torch_net_solver_parity import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(REPO, "tests", "fixtures", "jpeg", "imagedata")


def _jax_tool(name: str):
    """The JAX package's ``tools/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _list(tmp_path, n=7) -> str:
    path = tmp_path / "list.txt"
    path.write_text("".join(f"img_{i % 16:02d}.jpg {i % 5}\n"
                            for i in range(n)))
    return str(path)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _tree(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            p = os.path.join(d, name)
            out[os.path.relpath(p, root)] = _read(p)
    return out


RESIZE = ["--resize-height", "20", "--resize-width", "26"]


def test_convert_imageset_records_byte_equal(tmp_path, capsys):
    lst = _list(tmp_path)
    args = [lst, "--root-folder", IMAGES + "/", *RESIZE, "--shuffle",
            "--shard-size", "3", "--seed", "4", "--backend", "records"]
    assert convert_imageset.main([args[0], str(tmp_path / "mine"),
                                  *args[1:]]) == 0
    assert _jax_tool("convert_imageset").main(
        [args[0], str(tmp_path / "ref"), *args[1:]]) == 0
    mine, ref = _tree(tmp_path / "mine"), _tree(tmp_path / "ref")
    assert sorted(mine) == sorted(ref) and len(mine) == 3 * 2 + 1
    for name in mine:
        if name == "source.txt":        # each names its own shards
            assert mine[name] == ref[name].replace(b"/ref/", b"/mine/")
        else:
            assert mine[name] == ref[name], name
    assert "wrote records source list" in capsys.readouterr().out


def test_convert_imageset_hdf5_array_equal(tmp_path):
    lst = _list(tmp_path)
    args = ["--root-folder", IMAGES + "/", *RESIZE, "--shard-size", "4"]
    assert convert_imageset.main([lst, str(tmp_path / "mine"), *args]) == 0
    assert _jax_tool("convert_imageset").main(
        [lst, str(tmp_path / "ref"), *args]) == 0
    assert _read(tmp_path / "mine" / "source.txt") == \
        _read(tmp_path / "ref" / "source.txt")
    for shard in ("shard_00000.h5", "shard_00001.h5"):
        with h5py.File(tmp_path / "mine" / shard) as a, \
                h5py.File(tmp_path / "ref" / shard) as b:
            assert a["data"].shape[1:] == (3, 20, 26)
            for key in ("data", "label"):
                np.testing.assert_array_equal(a[key][()], b[key][()])


@pytest.mark.parametrize("source", ["list", "hdf5"])
def test_compute_image_mean_array_equal(tmp_path, source):
    lst = _list(tmp_path)
    if source == "list":
        args = [lst, "--root-folder", IMAGES + "/", "--new-height", "20",
                "--new-width", "26"]
    else:
        convert_imageset.main([lst, str(tmp_path / "h5"), "--root-folder",
                               IMAGES + "/", *RESIZE, "--shard-size", "4"])
        args = [str(tmp_path / "h5" / "source.txt"), "--hdf5", "data"]
    mine, ref = tmp_path / "mine.npz", tmp_path / "ref.npz"
    assert compute_image_mean.main([args[0], str(mine), *args[1:]]) == 0
    assert _jax_tool("compute_image_mean").main(
        [args[0], str(ref), *args[1:]]) == 0
    a, b = np.load(mine)["mean"], np.load(ref)["mean"]
    assert a.shape == (20, 26, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def _shard(tmp_path) -> str:
    convert_imageset.main([_list(tmp_path, 5), str(tmp_path / "shards"),
                           "--root-folder", IMAGES + "/", *RESIZE,
                           "--backend", "records"])
    return str(tmp_path / "shards" / "shard_00000.ncr")


@pytest.mark.parametrize("db", ["lmdb", "leveldb"])
def test_convert_db_byte_equal_both_ways(tmp_path, db):
    shard = _shard(tmp_path)
    jax_main = _jax_tool("convert_db").main
    for main, name in ((convert_db.main, "mine"), (jax_main, "ref")):
        assert main([f"records2{db}", shard, str(tmp_path / name)]) == 0
        assert main([f"{db}2records", str(tmp_path / name),
                     str(tmp_path / f"{name}.ncr")]) == 0
    assert _tree(tmp_path / "mine") == _tree(tmp_path / "ref")
    for ext in ("", ".idx"):            # the Datum bytes transcribed
        assert _read(str(tmp_path / "mine.ncr") + ext) == \
            _read(str(tmp_path / "ref.ncr") + ext) == _read(shard + ext)


V1_NET = """name: "legacy"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 16 input_dim: 16
layers { name: "conv" type: CONVOLUTION bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
layers { name: "relu" type: RELU bottom: "conv" top: "conv" }
layers { name: "pool" type: POOLING bottom: "conv" top: "pool"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layers { name: "ip" type: INNER_PRODUCT bottom: "pool" top: "ip"
  inner_product_param { num_output: 5 } }
layers { name: "prob" type: SOFTMAX bottom: "ip" top: "prob" }
"""
V1_SOLVER = """net: "net.prototxt"
base_lr: 0.01
solver_type: ADAM
momentum: 0.9
lr_policy: "fixed"
"""


@pytest.mark.parametrize("case", ["net", "net_inputs", "solver"])
def test_upgrade_proto_byte_equal(tmp_path, case):
    src = tmp_path / "in.prototxt"
    src.write_text(V1_SOLVER if case == "solver" else V1_NET)
    args = ["net" if case.startswith("net") else "solver", str(src)]
    extra = ["--convert-inputs"] if case == "net_inputs" else []
    assert upgrade_proto.main([*args, str(tmp_path / "mine"), *extra]) == 0
    assert _jax_tool("upgrade_proto").main(
        [*args, str(tmp_path / "ref"), *extra]) == 0
    mine = _read(tmp_path / "mine")
    assert mine == _read(tmp_path / "ref")
    assert (b"layers" not in mine) if case != "solver" else (b"Adam" in mine)


@pytest.mark.parametrize("fmt", ["dot", "text"])
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_draw_net_byte_equal(tmp_path, fmt, phase):
    """CaffeNet's train_val (grouped convolutions, in-place ReLU and
    Dropout, a data layer) and the V1 net (an ``input:`` field)."""
    spec = chip_smoke.caffenet_train_val("list.txt", "", batch=4)
    for name, text in (("caffenet", emit_prototxt(spec)), ("v1", V1_NET)):
        src = tmp_path / f"{name}.prototxt"
        src.write_text(text)
        args = ["--format", fmt, "--phase", phase, "--rankdir", "TB"]
        assert draw_net.main([str(src), str(tmp_path / f"{name}.mine"),
                              *args]) == 0
        _jax_tool("draw_net").main([str(src), str(tmp_path / f"{name}.ref"),
                                    *args])
        mine = _read(tmp_path / f"{name}.mine")
        assert mine == _read(tmp_path / f"{name}.ref")
        assert mine.startswith(b"digraph" if fmt == "dot" else b"LAYER")


SOLVER = """base_lr: 0.1
lr_policy: "step"
stepsize: 4
gamma: 0.5
momentum: 0.9
max_iter: 8
display: 2
test_interval: 4
test_iter: 2
random_seed: 3
"""
TEST_DATA = """layer { name: "tdata" type: "DummyData" top: "data" top: "label"
  include { phase: TEST } dummy_data_param { shape { dim: 4 dim: 3 dim: 12
  dim: 12 } shape { dim: 4 } data_filler { type: "gaussian" std: 1.0 }
  data_filler { type: "uniform" min: 0 max: 3.999 } } }"""
ACCURACY = """layer { name: "accuracy" type: "Accuracy" bottom: "ip2"
  bottom: "label" top: "accuracy" include { phase: TEST } }
"""


def test_parse_log_rows_equal_over_a_net_solver_log(tmp_path, capsys):
    """A log of the port's NetSolver (loss and lr every 2 iterations, a
    test pass every 4 over Data shards): both tools write the same
    CSVs."""
    text = chip_smoke.small_train_net(4, dropout=False,
                                      records=_shard(tmp_path))
    proto = parse_solver_prototxt(SOLVER)
    lines = text.split("\n")
    lines[1] = lines[1].replace(' top: "data"', ' include { phase: TRAIN } '
                                'top: "data"', 1) + "\n" + TEST_DATA
    proto.net = "\n".join(lines) + ACCURACY
    buf = io.StringIO()
    glog.set_stream(buf)
    try:
        NetSolver(proto, device="cpu").solve()
    finally:
        glog.set_stream(None)
    log = tmp_path / "train.log"
    log.write_text(buf.getvalue())
    for main, out in ((parse_log.main, "mine"),
                      (_jax_tool("parse_log").main, "ref")):
        (tmp_path / out).mkdir()
        assert main([str(log), str(tmp_path / out)]) == 0
    tables = {}
    for out in ("mine", "ref"):
        for kind in ("train", "test"):
            with open(tmp_path / out / f"train.log.{kind}") as f:
                tables[out, kind] = list(csv.DictReader(f))
    assert tables["mine", "train"] == tables["ref", "train"]
    assert tables["mine", "test"] == tables["ref", "test"]
    assert [r["NumIters"] for r in tables["mine", "train"]] == \
        ["2", "4", "6", "8"]
    assert [r["NumIters"] for r in tables["mine", "test"]] == \
        ["0", "4", "8"]
    assert set(tables["mine", "test"][0]) == {"NumIters", "loss",
                                              "accuracy"}
    capsys.readouterr()
