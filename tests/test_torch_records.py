"""The port's Datum codec, record shards and ``Data`` source
(``nct_tpu_torch.data.records``) against the JAX package's on the same
inputs: Datum bytes and shard files bitwise, each package reading the
other's, batches bitwise JAX's after NHWC -> NCHW, the row blocks of a
data rank, a resumed stream, and a short ``NetSolver`` run from shards
whose losses follow JAX's within rtol 1e-4."""

import os
import struct

import numpy as np
import pytest
import torch

from nct_tpu.data import records as jrec
from nct_tpu.nn.prototxt import parse_prototxt as jparse_net
from nct_tpu_torch.data import make_data_source
from nct_tpu_torch.data import records as rec
from nct_tpu_torch.nn import parse_prototxt
from torch_net_solver_parity import chip_smoke, net_solver_losses

torch.set_num_threads(1)


def _images(seed, n, h=20, w=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h + i % 3, w - i % 2, 3)).astype(np.uint8)
            for i in range(n)]


def _shard(path, imgs, writer=rec.RecordWriter):
    with writer(str(path)) as wr:
        for i, img in enumerate(imgs):
            wr.write_image(img, i % 4)
    return str(path)


def _float_datum(vals, c, h, w, packed: bool) -> bytes:
    out = b"\x08" + rec._varint(c) + b"\x10" + rec._varint(h) \
        + b"\x18" + rec._varint(w) + b"\x28" + rec._varint(3)
    if packed:
        body = np.asarray(vals, "<f4").tobytes()
        return out + b"\x32" + rec._varint(len(body)) + body
    return out + b"".join(b"\x35" + struct.pack("<f", v) for v in vals)


@pytest.mark.parametrize("label", [0, 7, 300])
def test_datum_bytes_bitwise_both_ways(label):
    img = _images(1, 1)[0]
    mine, ref = rec.encode_datum(img, label), jrec.encode_datum(img, label)
    assert mine == ref
    for payload in (mine, ref):
        got, want = rec.decode_datum(payload), jrec.decode_datum(payload)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0], img)
        assert got[1] == want[1] == label
    assert rec.datum_hw(mine[:rec._HEADER_BYTES]) == img.shape[:2]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_float_data_datums_decode_like_jax(packed):
    rng = np.random.default_rng(2)
    vals = (rng.standard_normal(2 * 3 * 4) * 200).astype(np.float32)
    payload = _float_datum(vals.tolist(), 2, 3, 4, packed)
    got, want = rec.decode_datum(payload), jrec.decode_datum(payload)
    assert got[0].shape == (3, 4, 2) and got[1] == want[1] == 3
    np.testing.assert_array_equal(got[0], want[0])


def test_shard_files_byte_identical_and_read_by_both(tmp_path):
    imgs = _images(3, 7)
    mine = _shard(tmp_path / "mine.ncr", imgs)
    ref = _shard(tmp_path / "ref.ncr", imgs, jrec.RecordWriter)
    for ext in ("", ".idx"):
        with open(mine + ext, "rb") as a, open(ref + ext, "rb") as b:
            assert a.read() == b.read()
    for path in (mine, ref):
        a, b = rec.RecordFile(path), jrec.RecordFile(path)
        assert len(a) == len(b) == 7 and a.offsets == b.offsets
        for i in range(7):
            assert a.read(i) == b.read(i)
            np.testing.assert_array_equal(rec.decode_datum(a.read(i))[0],
                                          imgs[i])


def test_lost_index_is_rebuilt_by_scanning(tmp_path):
    path = _shard(tmp_path / "s.ncr", _images(4, 5))
    want = rec.RecordFile(path).offsets
    os.unlink(path + ".idx")
    assert rec.RecordFile(path).offsets == want \
        == jrec.RecordFile(path).offsets


def _mean_file(tmp_path, h, w):
    path = tmp_path / "mean.npz"
    rng = np.random.default_rng(6)
    np.savez(path, mean=(rng.random((h, w, 3)) * 255).astype(np.float32))
    return str(path)


TRANSFORMS = {
    "plain": {},
    "crop_mirror": {"crop_size": 12, "mirror": True},
    "mean_value": {"crop_size": 12, "mirror": True,
                   "mean_value": [104, 117, 123], "scale": 0.017},
    "mean_file": {"crop_size": 12, "mirror": True, "mean_file": None},
}


def _cfg(source, batch, transform, rand_skip=0):
    dp = {"source": source, "batch_size": batch}
    if rand_skip:
        dp["rand_skip"] = rand_skip
    return {"type": "Data", "top": ["data", "label"], "data_param": dp,
            "transform_param": dict(transform)}


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("transform", sorted(TRANSFORMS))
def test_batches_bitwise_jax(tmp_path, phase, transform):
    """Wrap-around over two shards (a list file), rand_skip, crop, mirror,
    mean_value / scale and mean_file, with one seed."""
    imgs = [img[:20, :22] for img in _images(5, 9)]      # one size
    a = _shard(tmp_path / "a.ncr", imgs[:5])
    b = _shard(tmp_path / "b.ncr", imgs[5:])
    lst = tmp_path / "shards.txt"
    lst.write_text(f"{a}\n{b}\n")
    tp = dict(TRANSFORMS[transform])
    if "mean_file" in tp:
        tp["mean_file"] = _mean_file(tmp_path, 20, 22)
    cfg = _cfg(str(lst), 4, tp, rand_skip=6)
    mine = make_data_source(cfg, phase=phase, seed=11)
    assert isinstance(mine, rec.RecordShardSource)
    ref = jrec.RecordShardSource(cfg, phase=phase, seed=11)
    assert mine.pos == ref.pos
    for _ in range(5):                  # 20 rows over 9 records: wraps
        x, y = mine.next_batch()
        jx, jy = ref.next_batch()
        assert x.dtype == np.float32 and x.shape[1] == 3
        np.testing.assert_array_equal(x, jx.transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("n", [2, 4])
def test_part_rows_are_the_whole_batch_rows(tmp_path, n):
    """``next_batch((i, n))`` is rows [i k, (i + 1) k) of the whole batch,
    decodes only those Datums, and leaves the stream where the whole
    batch leaves it; records of several sizes draw their crops from their
    headers."""
    path = _shard(tmp_path / "s.ncr", _images(7, 11))
    cfg = _cfg(path, 8, {"crop_size": 12, "mirror": True})
    whole = make_data_source(cfg, seed=3)
    parts = [make_data_source(cfg, seed=3) for _ in range(n)]
    k = 8 // n
    for _ in range(3):
        x, y = whole.next_batch()
        for i, src in enumerate(parts):
            px, py = src.next_batch((i, n))
            np.testing.assert_array_equal(px, x[i * k:(i + 1) * k])
            np.testing.assert_array_equal(py, y[i * k:(i + 1) * k])
    for src in parts:
        assert src.decoded * n == whole.decoded == 24
        assert src.state()["pos"] == whole.state()["pos"]
        assert src.state()["rng"] == whole.state()["rng"]


def test_state_resumes_the_stream(tmp_path):
    path = _shard(tmp_path / "s.ncr", _images(8, 6))
    cfg = _cfg(path, 4, {"crop_size": 12, "mirror": True}, rand_skip=3)
    src = make_data_source(cfg, seed=2)
    src.next_batch()
    state = src.state()
    want = [src.next_batch() for _ in range(2)]
    fresh = make_data_source(cfg, seed=2)
    fresh.set_state(state)
    for wx, wy in want:
        x, y = fresh.next_batch()
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
    assert fresh.decoded == 8


def test_net_solver_from_record_shards_follows_jax(tmp_path):
    path = _shard(tmp_path / "s.ncr", _images(9, 10))
    text = chip_smoke.small_train_net(4, dropout=False, records=path)
    got, want = net_solver_losses(parse_prototxt(text), jparse_net(text))
    assert len(got) == len(want) == 12
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_caffe_tool_train_from_shards_resumes_bitwise(tmp_path, capsys):
    """``caffe_tool train`` on a solver whose net reads a ``Data`` layer:
    a resume from the iteration-4 snapshot ends bitwise the uninterrupted
    run, its stream where that run's stands."""
    from nct_tpu_torch.tools import caffe_tool

    net = tmp_path / "net.prototxt"
    net.write_text(chip_smoke.small_train_net(
        4, records=_shard(tmp_path / "s.ncr", _images(10, 7))))
    solver = tmp_path / "solver.prototxt"
    runs = {}
    for prefix, extra in (("whole", []), ("resumed", [
            "--snapshot", str(tmp_path / "whole_iter_4.npz")])):
        solver.write_text(f'net: "{net}"\nbase_lr: 0.01\nmomentum: 0.9\n'
                          f'lr_policy: "fixed"\nmax_iter: 8\nsnapshot: 4\n'
                          f'snapshot_prefix: "{tmp_path / prefix}"\n'
                          f'random_seed: 2\n')
        assert caffe_tool.main(["train", "--solver", str(solver),
                                "--device", "cpu", *extra]) == 0
        runs[prefix] = np.load(tmp_path / f"{prefix}_iter_8.npz")
    assert "restored iter 4" in capsys.readouterr().out
    keys = [k for k in runs["whole"].files
            if k.startswith(("params/", "state/", "stream/"))]
    assert any(k.startswith("stream/") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(runs["resumed"][k], runs["whole"][k])
