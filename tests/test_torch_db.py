"""The port's LMDB and LevelDB readers and writers
(``nct_tpu_torch.data.lmdb_reader`` / ``leveldb_reader``) against the JAX
package's: the files written byte-identical, every environment walked in
the same order with the same values (a two-level LMDB tree built from raw
pages included), snappy and crc32c, newest-wins and deletes, log
fragmentation, and a ``Data`` source over LMDB and over LevelDB giving the
record shards' batches."""

import os
import struct

import numpy as np
import pytest

from nct_tpu.data import leveldb_reader as jldb
from nct_tpu.data import lmdb_reader as jlmdb
from nct_tpu_torch.data import leveldb_reader as ldb
from nct_tpu_torch.data import lmdb_reader as lmdb
from nct_tpu_torch.data import make_data_source
from nct_tpu_torch.data.records import RecordWriter, encode_datum


def _items(seed, n, big=(40, 48)):
    """n small Datums and one that spills to LMDB overflow pages / spans
    several SSTable blocks."""
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
            for _ in range(n)]
    imgs.append(rng.integers(0, 256, (*big, 3)).astype(np.uint8))
    return [(f"{i:08d}".encode(), encode_datum(img, i % 4))
            for i, img in enumerate(imgs)]


def _dir_bytes(path) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_lmdb_files_byte_identical_and_walked_alike(tmp_path):
    items = _items(1, 6)
    lmdb.write_lmdb(str(tmp_path / "mine"), items)
    jlmdb.write_lmdb(str(tmp_path / "ref"), items)
    assert _dir_bytes(tmp_path / "mine") == _dir_bytes(tmp_path / "ref")
    for env in ("mine", "ref"):
        a = lmdb.LmdbReader(str(tmp_path / env))
        b = jlmdb.LmdbReader(str(tmp_path / env))
        assert len(a) == len(b) == len(items)
        assert list(a.item_locs()) == list(b.item_locs())
        assert list(a.items()) == list(b.items()) == sorted(items)


def test_lmdb_writer_raises_past_one_leaf_page(tmp_path):
    items = [(f"{i:08d}".encode(), bytes(900)) for i in range(8)]
    for write in (lmdb.write_lmdb, jlmdb.write_lmdb):
        with pytest.raises(ValueError, match="one leaf page"):
            write(str(tmp_path / write.__module__), items)


def test_dupsort_lmdb_is_refused(tmp_path):
    """A dup-sorted LMDB is not a key -> Datum store: the port raises
    ValueError naming it (the JAX reader raises NotImplementedError)."""
    env = tmp_path / "dup"
    lmdb.write_lmdb(str(env), [(b"a", b"1"), (b"b", b"2")])
    raw = bytearray((env / "data.mdb").read_bytes())
    leaf = 2 * 4096
    node = leaf + struct.unpack_from("<H", raw, leaf + 16)[0]
    struct.pack_into("<H", raw, node + 4, lmdb._F_DUPDATA)
    (env / "data.mdb").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="MDB_DUPSORT"):
        list(lmdb.LmdbReader(str(env)).items())
    with pytest.raises(NotImplementedError):
        list(jlmdb.LmdbReader(str(env)).items())


PSIZE = 4096


def _page(pgno: int, flags: int, nodes: list[bytes]) -> bytes:
    """One branch or leaf page holding ``nodes`` in order."""
    page = bytearray(PSIZE)
    upper = PSIZE
    ptrs = []
    for node in nodes:
        node = node + b"\0" * (len(node) % 2)
        upper -= len(node)
        page[upper:upper + len(node)] = node
        ptrs.append(upper)
    lower = 16 + 2 * len(nodes)
    struct.pack_into("<QHHHH", page, 0, pgno, 0, flags, lower, upper)
    for i, p in enumerate(ptrs):
        struct.pack_into("<H", page, 16 + 2 * i, p)
    return bytes(page)


def _leaf_node(key: bytes, val: bytes) -> bytes:
    return struct.pack("<HHHH", len(val) & 0xFFFF, len(val) >> 16, 0,
                       len(key)) + key + val


def _branch_node(key: bytes, child: int) -> bytes:
    return struct.pack("<HHHH", child & 0xFFFF, (child >> 16) & 0xFFFF,
                       child >> 32, len(key)) + key


def _meta(txnid: int, root: int, last_pg: int, entries: int) -> bytes:
    m = bytearray(PSIZE)
    struct.pack_into("<QHHHH", m, 0, txnid & 1, 0, 0x08, 0, 0)
    struct.pack_into("<II", m, 16, lmdb.MDB_MAGIC, lmdb.MDB_VERSION)
    struct.pack_into("<QQ", m, 24, 0, PSIZE * (last_pg + 1))
    lmdb._DB_STRUCT.pack_into(m, 40, PSIZE, 0, 0, 0, 0, 0, 0,
                              lmdb._P_INVALID)
    lmdb._DB_STRUCT.pack_into(m, 40 + 48, 0, 0, 2, 1, 3, 1, entries, root)
    struct.pack_into("<QQ", m, 40 + 96, last_pg, txnid)
    return bytes(m)


def test_two_level_lmdb_tree_walked_alike(tmp_path):
    """A branch root over three leaves (one value on an overflow page),
    with the newer of the two meta pages naming it: both readers walk it
    in key order and give the same values."""
    rng = np.random.default_rng(3)
    vals = {f"k{i:03d}".encode(): rng.bytes(40 + i) for i in range(30)}
    keys = sorted(vals)
    big_key, big = b"k025", rng.bytes(3 * PSIZE)
    vals[big_key] = big
    overflow = 6
    leaves = []
    for lo, hi in ((0, 10), (10, 20), (20, 30)):
        nodes = []
        for k in keys[lo:hi]:
            if k == big_key:
                nodes.append(struct.pack(
                    "<HHHH", len(big) & 0xFFFF, len(big) >> 16,
                    lmdb._F_BIGDATA, len(k)) + k
                    + struct.pack("<Q", overflow))
            else:
                nodes.append(_leaf_node(k, vals[k]))
        leaves.append(nodes)
    pages = [_page(2 + i, lmdb._P_LEAF, nodes)
             for i, nodes in enumerate(leaves)]
    branch = _page(5, lmdb._P_BRANCH, [
        _branch_node(b"", 2), _branch_node(keys[10], 3),
        _branch_node(keys[20], 4)])
    n_over = -(-(16 + len(big)) // PSIZE)
    over = struct.pack("<QHHI", overflow, 0, lmdb._P_OVERFLOW, n_over) + big
    over += b"\0" * (n_over * PSIZE - len(over))
    last_pg = overflow + n_over - 1
    env = tmp_path / "two_level"
    env.mkdir()
    (env / "data.mdb").write_bytes(
        _meta(4, 0, 0, 0) + _meta(5, 5, last_pg, 30)
        + b"".join(pages) + branch + over)
    a, b = lmdb.LmdbReader(str(env)), jlmdb.LmdbReader(str(env))
    assert a.depth == b.depth == 2 and a.root == b.root == 5
    got = list(a.items())
    assert got == list(b.items())
    assert got == [(k, vals[k]) for k in keys]


@pytest.mark.parametrize("as_table", [False, True], ids=["log", "table"])
def test_leveldb_files_byte_identical_and_walked_alike(tmp_path, as_table):
    items = _items(2, 6, big=(60, 64))
    ldb.write_leveldb(str(tmp_path / "mine"), items, as_table=as_table)
    jldb.write_leveldb(str(tmp_path / "ref"), items, as_table=as_table)
    assert _dir_bytes(tmp_path / "mine") == _dir_bytes(tmp_path / "ref")
    for env in ("mine", "ref"):
        a = ldb.LevelDbReader(str(tmp_path / env))
        b = jldb.LevelDbReader(str(tmp_path / env))
        assert len(a) == len(b) == len(items)
        assert list(a.items()) == list(b.items()) == sorted(items)


def test_crc32c_bitwise_jax_and_the_check_value():
    rng = np.random.default_rng(4)
    assert ldb.crc32c(b"123456789") == 0xE3069283
    for n in (0, 1, 255, 4095, 4096, 4097, 70001, 1 << 18):
        data = rng.bytes(n)
        for crc in (0, 0x9E3779B9):
            assert ldb.crc32c(data, crc) == jldb.crc32c(data, crc), n
    for v in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
        assert ldb.crc_mask(v) == jldb.crc_mask(v)
        assert ldb.crc_unmask(ldb.crc_mask(v)) == v


def _literal(data: bytes) -> bytes:
    n = len(data) - 1
    if n < 60:
        return bytes([n << 2]) + data
    return bytes([61 << 2]) + n.to_bytes(2, "little") + data


SNAPPY_VECTORS = {
    "literal": (bytes([5]) + _literal(b"hello"), b"hello"),
    "long_literal": (ldb._put_varint(300)
                     + _literal((bytes(range(256)) * 2)[:300]),
                     (bytes(range(256)) * 2)[:300]),
    "copy1_overlap": (bytes([6]) + _literal(b"ab") + bytes([0 << 2 | 1, 2]),
                      b"ababab"),
    "copy2": (bytes([13]) + _literal(b"abcdefgh") + bytes([(5 - 1) << 2 | 2,
                                                           8, 0]),
              b"abcdefghabcde"),
    "copy4": (bytes([11]) + _literal(b"xyz") + bytes([(8 - 1) << 2 | 3,
                                                      3, 0, 0, 0]),
              b"xyzxyzxyzxy"),
}


@pytest.mark.parametrize("name", sorted(SNAPPY_VECTORS))
def test_snappy_vectors(name):
    data, want = SNAPPY_VECTORS[name]
    assert ldb.snappy_decompress(data) == jldb.snappy_decompress(data) == want


def test_snappy_table_blocks_read_alike(tmp_path):
    """A table whose data blocks are snappy-compressed (as real stores
    are when snappy is linked) reads the same through both readers."""
    env = str(tmp_path / "db")
    items = [(f"{i:04d}".encode(), bytes([i]) * 50) for i in range(40)]
    ldb.write_leveldb(env, items, as_table=True)
    sst_path = os.path.join(env, "000005.ldb")
    sst = ldb.SstReader(sst_path)
    out = bytearray()

    def block(body: bytes, kind: int) -> tuple[int, int]:
        off = len(out)
        out.extend(body + bytes([kind]))
        out.extend(struct.pack("<I", ldb.crc_mask(ldb.crc32c(
            body + bytes([kind])))))
        return off, len(body)

    index = []
    for handle in sst._handles:
        body = sst._read_block(*handle)
        comp = ldb._put_varint(len(body)) + b"".join(
            _literal(body[i:i + 60]) for i in range(0, len(body), 60))
        off, size = block(comp, 1)
        index.append((sst._block_entries(handle)[-1][0],
                      ldb._put_varint(off) + ldb._put_varint(size)))
    mi = block(ldb._encode_block([]), 0)
    ix = block(ldb._encode_block(index), 0)
    footer = b"".join(ldb._put_varint(v) for v in (*mi, *ix))
    out += footer + b"\0" * (40 - len(footer)) + struct.pack(
        "<Q", ldb._TABLE_MAGIC)
    with open(sst_path, "wb") as f:
        f.write(bytes(out))
    got = list(ldb.LevelDbReader(env).items())
    assert got == list(jldb.LevelDbReader(env).items()) == items


def test_newest_sequence_wins_and_deletes(tmp_path):
    env = str(tmp_path / "db")
    ldb.write_leveldb(env, [(b"a", b"old"), (b"b", b"keep"), (b"c", b"dead")])
    log = os.path.join(env, "000003.log")
    with open(log, "rb") as f:
        buf = bytearray(f.read())
    ldb._append_log_record(buf, ldb.encode_write_batch(
        10, [(b"a", b"new"), (b"c", None)]))
    with open(log, "wb") as f:
        f.write(bytes(buf))
    want = {b"a": b"new", b"b": b"keep"}
    assert dict(ldb.LevelDbReader(env).items()) == want
    assert dict(jldb.LevelDbReader(env).items()) == want


def test_log_fragments_like_jax(tmp_path):
    """Records past one 32 KiB block split into FIRST / MIDDLE / LAST
    fragments, byte-identical to the JAX writer's, and reassemble."""
    payloads = [b"x" * 100, bytes(range(256)) * 300, b"z" * 40]
    mine, ref = bytearray(), bytearray()
    for p in payloads:
        ldb._append_log_record(mine, p)
        jldb._append_log_record(ref, p)
    assert mine == ref
    path = tmp_path / "frag.log"
    path.write_bytes(bytes(mine))
    assert list(ldb.read_log_records(str(path))) == payloads
    assert list(jldb.read_log_records(str(path))) == payloads
    mine[40] ^= 1                           # a damaged fragment
    path.write_bytes(bytes(mine))
    with pytest.raises(ValueError, match="crc"):
        list(ldb.read_log_records(str(path)))


@pytest.mark.parametrize("backend", ["lmdb", "leveldb", "leveldb_table"])
def test_data_source_over_a_db_gives_the_shard_batches(tmp_path, backend):
    rng = np.random.default_rng(5)
    items = [(f"{i:08d}".encode(), encode_datum(
        rng.integers(0, 256, (18, 20, 3)).astype(np.uint8), i % 4))
        for i in range(10)]
    shard = str(tmp_path / "s.ncr")
    with RecordWriter(shard) as wr:
        for _k, v in items:
            wr.write(v)
    env = str(tmp_path / backend)
    if backend == "lmdb":
        lmdb.write_lmdb(env, items)
    else:
        ldb.write_leveldb(env, items, as_table=backend == "leveldb_table")
    tp = {"crop_size": 12, "mirror": True, "mean_value": [100, 110, 120]}

    def cfg(source):
        return {"type": "Data", "top": ["data", "label"], "transform_param": tp,
                "data_param": {"source": source, "batch_size": 4}}

    a = make_data_source(cfg(env), seed=7)
    b = make_data_source(cfg(shard), seed=7)
    parts = [make_data_source(cfg(env), seed=7) for _ in range(2)]
    for _ in range(4):                  # 16 rows over 10 records: wraps
        x, y = a.next_batch()
        sx, sy = b.next_batch()
        np.testing.assert_array_equal(x, sx)
        np.testing.assert_array_equal(y, sy)
        for i, src in enumerate(parts):
            px, _ = src.next_batch((i, 2))
            np.testing.assert_array_equal(px, x[2 * i:2 * i + 2])
