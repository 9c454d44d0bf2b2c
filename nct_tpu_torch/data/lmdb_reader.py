"""Read-only LMDB support and a minimal fixture writer (port of
``nct_tpu/data/lmdb_reader.py``; the files are byte-identical).

The reference ingests its training datasets through LMDB / LevelDB
(reference: code/src/caffe/util/db_lmdb.cpp ``LMDBCursor`` -- an
mdb_cursor walk over Datum values; db.cpp:19-27 selects the backend).  No
``lmdb`` binding is needed: an LMDB file is a copy-on-write B+tree in one
memory-mapped file with a stable, documented layout (lmdb/mdb.c), so the
cursor walk is struct unpacking.  This module holds

  * :class:`LmdbReader` -- open ``data.mdb`` (or the environment directory
    holding it) and iterate ``(key, value)`` in key order like the
    reference's ``MDB_FIRST`` / ``MDB_NEXT`` cursor, through branch pages
    and values spilled to overflow pages (``F_BIGDATA``), locating values
    lazily;
  * :func:`write_lmdb` -- a single-leaf-page writer (with overflow pages)
    for fixtures and small exports back to LMDB.

Layout notes (64-bit little-endian files, the format Caffe writes):
page header = pgno u64, pad u16, flags u16, lower u16, upper u16 (16
bytes); meta page carries MDB_meta {magic 0xBEEFC0DE, version 1, address,
mapsize, dbs[2], last_pg, txnid} where the page size lives in
``dbs[0].md_pad`` and the application's tree is ``dbs[1]``; branch/leaf
nodes are {lo u16, hi u16, flags u16, ksize u16, key..., data...} with a
branch child pgno = lo | hi<<16 | flags<<32 and a leaf F_BIGDATA value
replaced by the u64 pgno of a contiguous overflow-page run.
"""

from __future__ import annotations

import mmap
import os
import struct

MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1

_P_BRANCH = 0x01
_P_LEAF = 0x02
_P_OVERFLOW = 0x04
_P_META = 0x08
_P_LEAF2 = 0x20

_F_BIGDATA = 0x01
_F_DUPDATA = 0x04

_PAGEHDRSZ = 16
_P_INVALID = 0xFFFFFFFFFFFFFFFF

# MDB_db: pad u32, flags u16, depth u16, branch/leaf/overflow/entries/root
_DB_STRUCT = struct.Struct("<IHHQQQQQ")
_DB_SIZE = _DB_STRUCT.size            # 48


def _resolve_path(path: str) -> str:
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


class LmdbReader:
    """Read-only iterator over an LMDB database's (key, value) pairs."""

    def __init__(self, path: str):
        self.path = _resolve_path(path)
        # Memory-map rather than slurp: real Caffe LMDBs are tens of GB
        # and the reference's cursor walk is itself over an mmap
        # (db_lmdb.cpp / mdb_env_open).  Slices of an mmap copy only the
        # sliced bytes, so per-value reads stay O(value).
        self._f = open(self.path, "rb")
        try:
            self._buf = mmap.mmap(self._f.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        except (ValueError, OSError):
            # zero-length or unmappable file: fall back to bytes
            self._f.seek(0)
            self._buf = self._f.read()
        meta = self._pick_meta()
        (self._psize_pad, _flags, self.depth, _b, _l, _o,
         self.entries, self.root) = _DB_STRUCT.unpack_from(
            self._buf, meta + 16 + 24 + _DB_SIZE)  # dbs[1] (MAIN)
        # page size rides in dbs[0].md_pad
        self.psize = _DB_STRUCT.unpack_from(self._buf, meta + 16 + 24)[0]

    def _meta_at(self, off: int):
        """Parse (magic, version, txnid) of a candidate meta page."""
        if off + 16 + 24 + 2 * _DB_SIZE + 16 > len(self._buf):
            return None
        flags = struct.unpack_from("<H", self._buf, off + 10)[0]
        if not flags & _P_META:
            return None
        magic, version = struct.unpack_from("<II", self._buf, off + 16)
        if magic != MDB_MAGIC or version != MDB_VERSION:
            return None
        txnid = struct.unpack_from(
            "<Q", self._buf, off + 16 + 24 + 2 * _DB_SIZE + 8)[0]
        return txnid

    def _pick_meta(self) -> int:
        """Return the byte offset of the newer valid meta page."""
        # page size isn't known before reading a meta; meta 0 is at offset
        # 0, meta 1 at psize from dbs[0].md_pad of meta 0 (fall back to
        # probing common sizes if meta 0 is torn).
        candidates = []
        t0 = self._meta_at(0)
        psizes = []
        if t0 is not None:
            candidates.append((t0, 0))
            psizes.append(
                _DB_STRUCT.unpack_from(self._buf, 0 + 16 + 24)[0])
        for ps in psizes or (4096, 8192, 16384, 32768, 65536):
            t1 = self._meta_at(ps)
            if t1 is not None:
                candidates.append((t1, ps))
        if not candidates:
            raise ValueError(f"{self.path}: no valid LMDB meta page")
        return max(candidates)[1]

    # -- page walk --------------------------------------------------------

    def _page(self, pgno: int) -> int:
        off = pgno * self.psize
        if off + _PAGEHDRSZ > len(self._buf):
            raise ValueError(f"{self.path}: page {pgno} out of range")
        return off

    def _iter_page(self, pgno: int):
        """Yield (key bytes, (value start, value length)) in key order."""
        off = self._page(pgno)
        flags, lower = struct.unpack_from("<HH", self._buf, off + 10)
        if flags & _P_LEAF2:
            raise ValueError(f"{self.path}: an MDB_DUPFIXED database, "
                             "not a key -> Datum store")
        nkeys = (lower - _PAGEHDRSZ) >> 1
        for i in range(nkeys):
            nptr = struct.unpack_from(
                "<H", self._buf, off + _PAGEHDRSZ + 2 * i)[0]
            node = off + nptr
            lo, hi, nflags, ksize = struct.unpack_from(
                "<HHHH", self._buf, node)
            key = bytes(self._buf[node + 8: node + 8 + ksize])
            if flags & _P_BRANCH:
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._iter_page(child)
                continue
            if nflags & _F_DUPDATA:
                raise ValueError(f"{self.path}: an MDB_DUPSORT database, "
                                 "not a key -> Datum store")
            dsize = lo | (hi << 16)
            dpos = node + 8 + ksize
            if nflags & _F_BIGDATA:
                opgno = struct.unpack_from("<Q", self._buf, dpos)[0]
                yield key, (self._page(opgno) + _PAGEHDRSZ, dsize)
            else:
                yield key, (dpos, dsize)

    def value_at(self, loc: tuple[int, int]) -> bytes:
        """Materialize one value from a location yielded by item_locs()."""
        start, length = loc
        return bytes(self._buf[start: start + length])

    def item_locs(self):
        """Yield (key, (start, length)) without copying any value —
        the lazy index a cursor over a multi-GB mapped file needs."""
        if self.root == _P_INVALID:
            return
        yield from self._iter_page(self.root)

    def items(self):
        """Yield (key bytes, value bytes) in key order (MDB_FIRST/NEXT)."""
        for key, loc in self.item_locs():
            yield key, self.value_at(loc)

    def values(self):
        for _k, v in self.items():
            yield v

    def close(self) -> None:
        if isinstance(self._buf, mmap.mmap):
            self._buf.close()
        self._f.close()

    def __len__(self) -> int:
        return int(self.entries)


def write_lmdb(path: str, items: list[tuple[bytes, bytes]],
               psize: int = 4096) -> None:
    """Write a minimal valid LMDB file: two metas + ONE leaf page (+
    overflow pages for large values).

    Enough for fixtures and small exports; raises when the entries don't
    fit one leaf page (use record shards for real datasets — this writer
    intentionally does not build multi-level trees).
    """
    os.makedirs(path, exist_ok=True) if not path.endswith(".mdb") else None
    out = _resolve_path(path)
    items = sorted(items)                     # memcmp key order
    inline_max = psize // 4

    leaf_nodes = []
    overflow_pages = []
    next_opgno = 3                            # 0,1 metas; 2 leaf
    for key, val in items:
        if len(val) > inline_max:
            npages = -(-(_PAGEHDRSZ + len(val)) // psize)
            hdr = struct.pack("<QHHI", next_opgno, 0, _P_OVERFLOW, npages)
            blob = hdr + val
            blob += b"\0" * (npages * psize - len(blob))
            overflow_pages.append(blob)
            node = struct.pack(
                "<HHHH", len(val) & 0xFFFF, len(val) >> 16,
                _F_BIGDATA, len(key)) + key + struct.pack("<Q", next_opgno)
            next_opgno += npages
        else:
            node = struct.pack(
                "<HHHH", len(val) & 0xFFFF, len(val) >> 16, 0,
                len(key)) + key + val
        if len(node) % 2:
            node += b"\0"
        leaf_nodes.append(node)

    ptrs_end = _PAGEHDRSZ + 2 * len(leaf_nodes)
    total = sum(len(n) for n in leaf_nodes)
    if ptrs_end + total > psize:
        raise ValueError(
            "write_lmdb fixture writer: entries exceed one leaf page "
            f"({ptrs_end + total} > {psize}); use record shards")

    # pack nodes from the page top downward, ptrs in key order
    leaf = bytearray(psize)
    upper = psize
    ptrs = []
    for node in leaf_nodes:
        upper -= len(node)
        leaf[upper: upper + len(node)] = node
        ptrs.append(upper)
    struct.pack_into("<QHHHH", leaf, 0, 2, 0, _P_LEAF, ptrs_end, upper)
    for i, p in enumerate(ptrs):
        struct.pack_into("<H", leaf, _PAGEHDRSZ + 2 * i, p)

    root = 2 if items else _P_INVALID
    last_pg = next_opgno - 1

    def meta(txnid: int) -> bytes:
        m = bytearray(psize)
        struct.pack_into("<QHHHH", m, 0, txnid & 1, 0, _P_META, 0, 0)
        struct.pack_into("<II", m, 16, MDB_MAGIC, MDB_VERSION)
        struct.pack_into("<QQ", m, 24, 0, psize * (last_pg + 1))  # addr, mapsize
        # dbs[0] (FREE): md_pad carries the page size; empty tree
        _DB_STRUCT.pack_into(m, 16 + 24, psize, 0, 0, 0, 0, 0, 0,
                             _P_INVALID)
        # dbs[1] (MAIN)
        _DB_STRUCT.pack_into(m, 16 + 24 + _DB_SIZE, 0, 0,
                             1 if items else 0, 0, 1 if items else 0,
                             len(overflow_pages), len(items), root)
        struct.pack_into("<QQ", m, 16 + 24 + 2 * _DB_SIZE, last_pg, txnid)
        return bytes(m)

    with open(out, "wb") as f:
        f.write(meta(0))
        f.write(meta(1))
        f.write(bytes(leaf))
        for blob in overflow_pages:
            f.write(blob)
