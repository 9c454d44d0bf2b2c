"""DB-backed data path: Datum record shards, LMDB and LevelDB (port of
``nct_tpu/data/records.py``).

Rebuilds the reference's database-backed training input (reference:
src/caffe/layers/data_layer.cpp + util/db_lmdb.cpp / db_leveldb.cpp +
data_reader.cpp): images are pre-serialized as Caffe **Datum** messages
(caffe.proto: 1=channels, 2=height, 3=width, 4=data CHW uint8 bytes,
5=label, 6=float_data, 7=encoded) and streamed at train time by a cursor
that wraps around at the end, with no image decode in the loop.

A record shard is a flat file of length-prefixed Datum messages plus a
sidecar ``.idx`` of u64 offsets for random access (the role LMDB's keys
play for seek / rand_skip).  The payload is protobuf wire format, parsed
by ``models.caffe_io.iter_fields``, so a shard holds byte-level Caffe
Datums; shards written here are byte-identical to the JAX package's.

Layout:  [8-byte magic "NCTREC00"] then per record:
         [u32 LE payload length][payload bytes]
Sidecar: <path>.idx -- u64 LE offsets of every record's length prefix.

``RecordShardSource`` reads a shard, a directory of ``*.ncr`` shards, a
list file of shards, an LMDB environment or a LevelDB directory, and
emits (images [B, C, H, W] float32, labels [B] float32) batches.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from nct_tpu_torch.data.image_data import DataTransformer
from nct_tpu_torch.models.caffe_io import iter_fields

MAGIC = b"NCTREC00"
# bytes of a Datum that hold its header (channels, height, width come
# before the data field, each a tag byte and a varint of at most 5 bytes)
_HEADER_BYTES = 32


# --- Datum protobuf wire-format codec --------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_datum(img_bgr_u8: np.ndarray, label: int = 0) -> bytes:
    """uint8 HWC BGR -> Caffe Datum bytes (data stored CHW, as
    CVMatToDatum in io.cpp)."""
    img = np.asarray(img_bgr_u8, np.uint8)
    h, w, c = img.shape
    data = np.ascontiguousarray(img.transpose(2, 0, 1)).tobytes()
    return (b"\x08" + _varint(c) + b"\x10" + _varint(h)
            + b"\x18" + _varint(w)
            + b"\x22" + _varint(len(data)) + data
            + b"\x28" + _varint(int(label)))


def decode_datum(payload: bytes) -> tuple[np.ndarray, int]:
    """Datum bytes -> (uint8 HWC BGR image, label).  float_data Datums
    (field 6, packed or not) decode too, clipped to uint8 (the transformer
    works in float anyway)."""
    c = h = w = label = 0
    data = b""
    floats: list[float] = []
    for field, wire, val in iter_fields(memoryview(payload)):
        if field == 1:
            c = int(val)
        elif field == 2:
            h = int(val)
        elif field == 3:
            w = int(val)
        elif field == 4:
            data = val
        elif field == 5:
            label = int(val)
        elif field == 6:
            if wire == 2:                       # packed floats
                floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
            else:
                floats.append(struct.unpack("<f", struct.pack("<I", val))[0])
    if len(data):
        img = np.frombuffer(data, np.uint8).reshape(c, h, w)
    else:
        img = np.clip(np.asarray(floats, np.float32).reshape(c, h, w),
                      0, 255).astype(np.uint8)
    return np.ascontiguousarray(img.transpose(1, 2, 0)), label


def datum_hw(payload: bytes) -> tuple[int, int] | None:
    """(height, width) of a Datum from its header fields, which precede
    the data; the whole Datum is parsed only where they do not."""
    h = w = None
    for field, _wire, val in iter_fields(memoryview(payload)):
        if field == 2:
            h = int(val)
        elif field == 3:
            w = int(val)
        if h is not None and w is not None:
            return h, w
        if field >= 4:
            break
    return None


# --- record shard file ------------------------------------------------------

class RecordWriter:
    """Sequential shard writer (the convert_imageset.cpp ingest role)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._offsets: list[int] = []

    def write(self, payload: bytes) -> None:
        self._offsets.append(self._f.tell())
        self._f.write(struct.pack("<I", len(payload)))
        self._f.write(payload)

    def write_image(self, img_bgr_u8: np.ndarray, label: int = 0) -> None:
        self.write(encode_datum(img_bgr_u8, label))

    def close(self) -> None:
        self._f.close()
        with open(self.path + ".idx", "wb") as idx:
            idx.write(np.asarray(self._offsets, "<u8").tobytes())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordFile:
    """Random-access shard reader, rebuilding a lost ``.idx`` sidecar by
    scanning the shard."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path}: not a record shard")
        idx_path = path + ".idx"
        if os.path.exists(idx_path):
            with open(idx_path, "rb") as f:
                self.offsets = np.frombuffer(f.read(), "<u8").tolist()
        else:
            self.offsets = []
            with open(path, "rb") as f:
                f.seek(len(MAGIC))
                while True:
                    pos = f.tell()
                    hdr = f.read(4)
                    if len(hdr) < 4:
                        break
                    self.offsets.append(pos)
                    f.seek(struct.unpack("<I", hdr)[0], 1)
        self._f = open(path, "rb")

    def __len__(self) -> int:
        return len(self.offsets)

    def read(self, i: int, limit: int | None = None) -> bytes:
        """Record ``i``'s payload, or its first ``limit`` bytes."""
        self._f.seek(self.offsets[i])
        (n,) = struct.unpack("<I", self._f.read(4))
        return self._f.read(n if limit is None else min(n, limit))


class DbValues:
    """A RecordFile-shaped view over the values of an LMDB or LevelDB
    environment, in key order (the reference's cursor over db_lmdb.cpp /
    db_leveldb.cpp).  Holds one location per entry; values are read per
    call."""

    def __init__(self, path: str, is_lmdb: bool):
        if is_lmdb:
            from nct_tpu_torch.data.lmdb_reader import LmdbReader as Reader
        else:
            from nct_tpu_torch.data.leveldb_reader import \
                LevelDbReader as Reader
        self._reader = Reader(path)
        self._lmdb = is_lmdb
        self._locs = [loc for _k, loc in self._reader.item_locs()]

    def __len__(self) -> int:
        return len(self._locs)

    def read(self, i: int, limit: int | None = None) -> bytes:
        loc = self._locs[i]
        if limit is not None and self._lmdb:        # (start, length)
            return self._reader.value_at((loc[0], min(loc[1], limit)))
        value = self._reader.value_at(loc)
        return value if limit is None else value[:limit]


def open_records(source: str) -> list:
    """The record files of a ``data_param.source``: an LMDB environment
    (a directory holding ``data.mdb``, or the file), a LevelDB directory,
    a directory of ``*.ncr`` shards, one shard, or a list file of
    shards."""
    if source.endswith(".mdb") or os.path.exists(
            os.path.join(source, "data.mdb")):
        return [DbValues(source, is_lmdb=True)]
    if os.path.exists(os.path.join(source, "CURRENT")):
        return [DbValues(source, is_lmdb=False)]
    if os.path.isdir(source):
        paths = sorted(os.path.join(source, p) for p in os.listdir(source)
                       if p.endswith(".ncr"))
    elif source.endswith(".ncr"):
        paths = [source]
    else:
        with open(source) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
    if not paths:
        raise ValueError(f"no record shards under {source}")
    return [RecordFile(p) for p in paths]


class RecordShardSource:
    """``type: "Data"`` layer analogue (data_layer.cpp): (images [B, C, H,
    W] float32, labels [B] float32) batches from record shards, LMDB or
    LevelDB, with a wrap-around cursor, rand_skip and the DataTransformer's
    crop / mirror / mean.

    ``data_param { source, batch_size, rand_skip }``.  rand_skip draws from
    its own ``default_rng(seed)``; the transformer has another generator
    of the same seed, as in the JAX package."""

    def __init__(self, layer_cfg: dict, phase: str = "TRAIN",
                 seed: int = 0):
        dp = layer_cfg.get("data_param", {}) or {}
        self.batch_size = int(dp.get("batch_size", 1))
        self.files = open_records(str(dp.get("source")))
        self.sizes = [len(f) for f in self.files]
        self.total = sum(self.sizes)
        self.pos = 0
        self.decoded = 0            # Datums decoded (copied) so far
        if dp.get("rand_skip"):
            rng = np.random.default_rng(seed)
            self.pos = int(rng.integers(0, int(dp["rand_skip"])))
        self.transform = DataTransformer(
            layer_cfg.get("transform_param"), phase=phase, seed=seed)

    def _read(self, i: int, limit: int | None = None) -> bytes:
        for f, n in zip(self.files, self.sizes):
            if i < n:
                return f.read(i, limit)
            i -= n
        raise IndexError(i)

    def _hw(self, i: int) -> tuple[int, int]:
        """(height, width) of record ``i`` from its header bytes."""
        hw = datum_hw(self._read(i, _HEADER_BYTES))
        if hw is None:
            hw = decode_datum(self._read(i))[0].shape[:2]
        return hw

    def next_batch(self, part: tuple[int, int] | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """The next batch, or with ``part = (i, n)`` its i-th of n equal
        row blocks: only those Datums are decoded and transformed, and the
        draws of the other rows are made from their headers' sizes, so the
        stream stays the whole batch's."""
        i, n = part or (0, 1)
        if self.batch_size % n:
            raise ValueError(f"batch of {self.batch_size} does not split "
                             f"into {n} parts")
        k = self.batch_size // n
        imgs, labels = [], []
        for j in range(self.batch_size):
            rec = self.pos % self.total
            self.pos += 1
            if i * k <= j < (i + 1) * k:
                img, label = decode_datum(self._read(rec))
                self.decoded += 1
                imgs.append(self.transform(img))
                labels.append(float(label))
            elif self.transform.crop_size:
                self.transform.draw(*self._hw(rec))
            else:                       # the mirror bit alone
                self.transform.draw(0, 0)
        return np.stack(imgs), np.asarray(labels, np.float32)

    def state(self) -> dict[str, np.ndarray]:
        """The stream's position: the cursor and the transform's
        generator."""
        return {"pos": np.asarray(self.pos), "rng": np.asarray(json.dumps(
            self.transform._rng.bit_generator.state))}

    def set_state(self, state: dict) -> None:
        self.pos = int(state["pos"])
        self.transform._rng.bit_generator.state = json.loads(
            str(state["rng"]))

    def __iter__(self):
        while True:
            yield self.next_batch()
