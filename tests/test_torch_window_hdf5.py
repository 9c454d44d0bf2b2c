"""The port's WindowData and HDF5Data sources
(``nct_tpu_torch.data.window_data`` / ``hdf5_data``) against the JAX
package's on the same inputs: window files parsed alike, batches bitwise
JAX's after NHWC -> NCHW (with and without ``context_pad``; HDF5 over
several files, shuffled), the row blocks of a data rank, a resumed
stream, and a short ``NetSolver`` run from each whose losses follow JAX's
within rtol 1e-4."""

import os

import h5py
import numpy as np
import pytest
import torch

from nct_tpu.data.hdf5_data import HDF5DataSource as JaxHDF5
from nct_tpu.data.window_data import WindowDataSource as JaxWindow
from nct_tpu.data.window_data import parse_window_file as jparse_windows
from nct_tpu.nn.prototxt import parse_prototxt as jparse_net
from nct_tpu_torch.data import make_data_source
from nct_tpu_torch.data.hdf5_data import HDF5DataSource
from nct_tpu_torch.data.window_data import (WindowDataSource,
                                            parse_window_file)
from nct_tpu_torch.nn import parse_prototxt

from torch_net_solver_parity import chip_smoke, net_solver_losses

torch.set_num_threads(1)

IMAGES = os.path.join(os.path.dirname(__file__), "fixtures", "jpeg",
                      "imagedata")


def _window_file(tmp_path, n_images=3, labels=4):
    """fg and bg windows over fixture JPEGs, some reaching past the
    image."""
    rng = np.random.default_rng(1)
    out = []
    for i in range(n_images):
        out += [f"# {i}", f"img_{i:02d}.jpg", "3", "256", "256", "5"]
        for j in range(5):
            x1, y1 = (int(v) for v in rng.integers(-10, 200, 2))
            w, h = (int(v) for v in rng.integers(20, 90, 2))
            overlap = (0.9, 0.7, 0.55, 0.3, 0.1)[j]
            out.append(f"{(i + j) % labels} {overlap} {x1} {y1} {x1 + w} "
                       f"{y1 + h}")
    path = tmp_path / "windows.txt"
    path.write_text("\n".join(out) + "\n")
    return str(path)


def _window_cfg(source, batch=8, crop=24, pad=0, mirror=True):
    wp = {"source": source, "root_folder": IMAGES + "/",
          "batch_size": batch, "fg_fraction": 0.25, "context_pad": pad}
    return {"type": "WindowData", "top": ["data", "label"],
            "window_data_param": wp,
            "transform_param": {"crop_size": crop, "mirror": mirror,
                                "mean_value": [104, 117, 123],
                                "scale": 0.017}}


def test_parse_window_file_like_jax(tmp_path):
    path = _window_file(tmp_path)
    images, windows = parse_window_file(path, IMAGES)
    assert (images, windows) == jparse_windows(path, IMAGES)
    assert len(images) == 3 and len(windows) == 15
    bad = tmp_path / "bad.txt"
    bad.write_text("0\nimg_00.jpg\n")
    for parse in (parse_window_file, jparse_windows):
        with pytest.raises(ValueError, match="expected '#'"):
            parse(str(bad))


@pytest.mark.parametrize("pad", [0, 8], ids=["no_pad", "context_pad"])
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_window_batches_bitwise_jax(tmp_path, pad, phase):
    cfg = _window_cfg(_window_file(tmp_path), pad=pad)
    mine = make_data_source(cfg, phase=phase, seed=6)
    assert isinstance(mine, WindowDataSource)
    ref = JaxWindow(cfg, phase=phase, seed=6)
    for _ in range(3):
        x, y = mine.next_batch()
        jx, jy = ref.next_batch()
        assert x.shape == (8, 3, 24, 24) and x.dtype == np.float32
        np.testing.assert_array_equal(x, jx.transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(y, jy)
    assert (y[:6] == 0).all()           # bg rows first, label 0


def test_window_data_requires_crop_size(tmp_path):
    cfg = _window_cfg(_window_file(tmp_path), crop=0)
    for build in (WindowDataSource, JaxWindow):
        with pytest.raises(ValueError, match="crop_size"):
            build(cfg)


@pytest.mark.parametrize("n", [2, 4])
def test_window_part_and_state(tmp_path, n):
    """Each block is its rows of the whole batch, only its windows are
    warped, every skipped row still draws; a stream resumes from its
    state."""
    cfg = _window_cfg(_window_file(tmp_path), pad=8)
    whole = make_data_source(cfg, seed=2)
    parts = [make_data_source(cfg, seed=2) for _ in range(n)]
    k = 8 // n
    for it in range(3):
        if it == 2:
            state = whole.state()
        x, y = whole.next_batch()
        for i, src in enumerate(parts):
            px, py = src.next_batch((i, n))
            np.testing.assert_array_equal(px, x[i * k:(i + 1) * k])
            np.testing.assert_array_equal(py, y[i * k:(i + 1) * k])
    for src in parts:
        assert src.decoded * n == whole.decoded == 24
        assert src.state()["rng"] == whole.state()["rng"]
    fresh = make_data_source(cfg, seed=2)
    fresh.set_state(state)
    np.testing.assert_array_equal(fresh.next_batch()[0], x)


def _write_h5(path, n, seed, h=12, w=12, c=3):
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:         # Caffe's N x C x H x W
        f.create_dataset("data", data=rng.standard_normal(
            (n, c, h, w)).astype(np.float32))
        f.create_dataset("label", data=rng.integers(0, 4, n).astype(
            np.float32))
    return str(path)


def _h5_cfg(tmp_path, sizes, batch, shuffle):
    files = [_write_h5(tmp_path / f"f{i}.h5", n, i)
             for i, n in enumerate(sizes)]
    lst = tmp_path / "h5list.txt"
    lst.write_text("\n".join(os.path.basename(f) for f in files) + "\n")
    return {"type": "HDF5Data", "top": ["data", "label"],
            "hdf5_data_param": {"source": str(lst), "batch_size": batch,
                                "shuffle": shuffle}}, files


@pytest.mark.parametrize("shuffle", [False, True])
def test_hdf5_batches_bitwise_jax(tmp_path, shuffle):
    """NCHW as stored (JAX's are NHWC), three files of 5, 3 and 7 rows
    crossed and wrapped, the row and file orders JAX draws."""
    cfg, _ = _h5_cfg(tmp_path, (5, 3, 7), 4, shuffle)
    mine = make_data_source(cfg, seed=3)
    assert isinstance(mine, HDF5DataSource)
    ref = JaxHDF5(cfg, seed=3)
    for _ in range(12):                 # 48 rows: 3 passes over 15
        x, y = mine.next_batch()
        jx, jy = ref.next_batch()
        assert x.shape == (4, 3, 12, 12)
        np.testing.assert_array_equal(x, jx.transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(y, jy)


def test_hdf5_files_cover_all_rows(tmp_path):
    cfg, files = _h5_cfg(tmp_path, (4, 6), 5, shuffle=True)
    src = make_data_source(cfg, seed=1)
    labels = np.concatenate([src.next_batch()[1] for _ in range(2)])
    want = []
    for f in files:
        with h5py.File(f, "r") as h5:
            want += list(np.asarray(h5["label"]))
    assert sorted(labels.tolist()) == sorted(want)


def test_hdf5_row_count_mismatch_raises(tmp_path):
    path = tmp_path / "bad.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=np.zeros((3, 1, 2, 2), np.float32))
        f.create_dataset("label", data=np.zeros((2,), np.float32))
    lst = tmp_path / "list.txt"
    lst.write_text(f"{path}\n")
    cfg = {"type": "HDF5Data", "top": ["data", "label"],
           "hdf5_data_param": {"source": str(lst), "batch_size": 1}}
    for build in (HDF5DataSource, JaxHDF5):
        with pytest.raises(ValueError, match="rows"):
            build(cfg)


@pytest.mark.parametrize("n", [2, 4])
def test_hdf5_part_and_state(tmp_path, n):
    """A block loads and advances every file the batch crosses, so its
    rows are the whole batch's and its stream (files, rows, both orders,
    the generator) stays the whole batch's; a stream resumes from its
    state."""
    cfg, _ = _h5_cfg(tmp_path, (5, 3, 7), 8, shuffle=True)
    whole = make_data_source(cfg, seed=4)
    parts = [make_data_source(cfg, seed=4) for _ in range(n)]
    k = 8 // n
    seen = []
    for it in range(5):
        if it == 3:
            state = whole.state()
        x, y = whole.next_batch()
        seen.append(x)
        for i, src in enumerate(parts):
            px, py = src.next_batch((i, n))
            np.testing.assert_array_equal(px, x[i * k:(i + 1) * k])
            np.testing.assert_array_equal(py, y[i * k:(i + 1) * k])
    for src in parts:
        assert src.decoded * n == whole.decoded == 40
        for key, val in whole.state().items():
            np.testing.assert_array_equal(src.state()[key], val)
    fresh = make_data_source(cfg, seed=4)
    fresh.set_state(state)
    for want in seen[3:]:
        np.testing.assert_array_equal(fresh.next_batch()[0], want)


def _net_with(data_layer: str) -> str:
    """``small_train_net`` (no Dropout) with its data layer replaced."""
    lines = chip_smoke.small_train_net(8, dropout=False,
                                       memory_data=False).split("\n")
    assert lines[1].startswith('layer { name: "data" type: "Input"')
    lines[1] = data_layer
    return "\n".join(lines)


def test_net_solver_from_window_data_follows_jax(tmp_path):
    wf = _window_file(tmp_path)
    text = _net_with(
        f'layer {{ name: "data" type: "WindowData" top: "data" top: "label" '
        f'window_data_param {{ source: "{wf}" root_folder: "{IMAGES}/" '
        f'batch_size: 8 fg_fraction: 0.5 context_pad: 4 }} transform_param '
        f'{{ crop_size: 12 mirror: true mean_value: 128 scale: 0.0078125 }} }}')
    got, want = net_solver_losses(parse_prototxt(text), jparse_net(text))
    assert len(got) == len(want) == 12
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_net_solver_from_hdf5_data_follows_jax(tmp_path):
    cfg, _ = _h5_cfg(tmp_path, (10, 6), 8, shuffle=True)
    src = cfg["hdf5_data_param"]["source"]
    text = _net_with(
        f'layer {{ name: "data" type: "HDF5Data" top: "data" top: "label" '
        f'hdf5_data_param {{ source: "{src}" batch_size: 8 shuffle: true }} }}')
    got, want = net_solver_losses(parse_prototxt(text), jparse_net(text))
    assert len(got) == len(want) == 12
    np.testing.assert_allclose(got, want, rtol=1e-4)
