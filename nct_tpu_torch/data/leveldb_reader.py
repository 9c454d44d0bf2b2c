"""Read-only LevelDB support and a minimal fixture writer (port of
``nct_tpu/data/leveldb_reader.py``; the files are byte-identical).

The reference ingests training datasets through either DB flavor
(reference: code/src/caffe/util/db.cpp:9-27 selects LEVELDB or LMDB;
db_leveldb.cpp:8-19 opens the store with block_size 64k / write_buffer
256M and walks it with a leveldb iterator).  No leveldb binding is
needed: the on-disk format is small and stable (leveldb
doc/log_format.md + doc/table_format.md), so the reader is struct
walking:

  * write-ahead **log files** (``NNNNNN.log``) — 32 KiB blocks of
    crc32c-checked FULL/FIRST/MIDDLE/LAST fragments carrying WriteBatch
    payloads (the memtable contents of a DB that was not compacted —
    e.g. any small dataset written and closed once);
  * the **MANIFEST** (a log-format file of VersionEdit records) — live
    SSTable list, current log number, last sequence;
  * **SSTables** (``NNNNNN.ldb`` / ``.sst``) — block-based tables:
    footer -> index block -> prefix-compressed data blocks, each block
    optionally snappy-compressed (pure-Python decoder below; leveldb
    stores uncompressed when snappy is absent or saves <12.5%);
  * merged iteration in user-key order with newest-sequence-wins and
    deletion tombstones honored — the same view a ``leveldb::Iterator``
    gives the reference's ``LevelDBCursor``.

Like LmdbReader, values are located lazily: ``item_locs()`` yields
(key, loc) without materializing SST values, and ``value_at(loc)``
decodes one block on demand (single-block LRU), so a multi-GB store
costs O(entries) index memory.

The fixture writer emits a log-only DB (CURRENT + MANIFEST + .log) —
exactly what leveldb itself leaves behind for a small dataset — plus an
optional SSTable so tests exercise the table path; both are round-trip
tested against this reader.
"""

from __future__ import annotations

import os
import struct

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli) -- leveldb checks every log record and table block
# with the masked variant.  Table-driven; a long input runs as numpy lanes
# of _LANE bytes each, whose registers are then joined by the linear map
# of a run of zero bytes (the zlib crc32_combine identity), bit for bit
# the byte-at-a-time result.
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78                            # reflected 0x1EDC6F41
_LANE = 256                                   # bytes per numpy lane
_NUMPY_MIN = 4096                             # shorter inputs: byte loop


def _make_table() -> np.ndarray:
    c = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        c = np.where(c & 1, (c >> 1) ^ np.uint32(_POLY), c >> 1)
    return c.astype(np.uint32)


_TABLE = _make_table()
_TABLE_LIST = _TABLE.tolist()


def _apply(cols: np.ndarray, regs: np.ndarray) -> np.ndarray:
    """The GF(2) linear map with columns ``cols`` [32] applied to each
    register of ``regs``."""
    out = np.zeros_like(regs)
    for bit in range(32):
        out ^= np.where((regs >> np.uint32(bit)) & np.uint32(1), cols[bit],
                        np.uint32(0))
    return out


_ZERO_MAPS: list[np.ndarray] = []             # _ZERO_MAPS[k]: LANE * 2^k


def _zero_map(level: int) -> np.ndarray:
    """Columns of the map a run of ``_LANE * 2**level`` zero bytes applies
    to the register."""
    if not _ZERO_MAPS:
        unit = np.uint32(1) << np.arange(32, dtype=np.uint32)
        cols = _TABLE[unit & np.uint32(0xFF)] ^ (unit >> np.uint32(8))
        for _ in range(_LANE.bit_length() - 1):          # 1 byte -> LANE
            cols = _apply(cols, cols)
        _ZERO_MAPS.append(cols)
    while len(_ZERO_MAPS) <= level:
        cols = _ZERO_MAPS[-1]
        _ZERO_MAPS.append(_apply(cols, cols))
    return _ZERO_MAPS[level]


def _bytes_update(reg: int, data) -> int:
    table = _TABLE_LIST
    for b in data:
        reg = table[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def crc32c(data: bytes, crc: int = 0) -> int:
    reg = crc ^ 0xFFFFFFFF
    n_lanes = len(data) // _LANE
    if len(data) < _NUMPY_MIN:
        return _bytes_update(reg, data) ^ 0xFFFFFFFF
    # lanes padded in front to a power of two: a zero lane with a zero
    # register stays zero, so it adds nothing to the join
    width = 1 << (n_lanes - 1).bit_length()
    lanes = np.zeros((_LANE, width), np.uint8)
    lanes[:, width - n_lanes:] = np.frombuffer(
        data, np.uint8, n_lanes * _LANE).reshape(n_lanes, _LANE).T
    regs = np.zeros(width, np.uint32)
    regs[width - n_lanes] = reg
    for row in lanes:
        regs = _TABLE[(regs ^ row) & np.uint32(0xFF)] ^ (regs >> np.uint32(8))
    level = 0
    while regs.size > 1:                      # join neighbours in pairs
        regs = _apply(_zero_map(level), regs[0::2]) ^ regs[1::2]
        level += 1
    reg = _bytes_update(int(regs[0]), data[n_lanes * _LANE:])
    return reg ^ 0xFFFFFFFF


_MASK_DELTA = 0xA282EAD8


def crc_mask(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def crc_unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------


def _get_varint(buf, pos: int):
    shift = 0
    out = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _put_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        if x < 0x80:
            out.append(x)
            return bytes(out)
        out.append((x & 0x7F) | 0x80)
        x >>= 7


def _get_length_prefixed(buf, pos: int):
    n, pos = _get_varint(buf, pos)
    return bytes(buf[pos: pos + n]), pos + n


# ---------------------------------------------------------------------------
# snappy (decompression only — enough to read compressed table blocks)
# ---------------------------------------------------------------------------


def snappy_decompress(data: bytes) -> bytes:
    """Decode the raw snappy format (format_description.txt): a varint
    uncompressed length, then literal / copy tagged elements."""
    n, pos = _get_varint(data, 0)
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                          # literal
            ln = tag >> 2
            if ln >= 60:                       # 60..63: length in next bytes
                nbytes = ln - 59
                ln = int.from_bytes(data[pos: pos + nbytes], "little")
                pos += nbytes
            ln += 1
            out += data[pos: pos + ln]
            pos += ln
            continue
        if kind == 1:                          # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:                        # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos: pos + 2], "little")
            pos += 2
        else:                                  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos: pos + 4], "little")
            pos += 4
        if off == 0:
            raise ValueError("snappy: zero copy offset")
        start = len(out) - off
        if start < 0:
            raise ValueError("snappy: copy before output start")
        for i in range(ln):                    # copies may overlap
            out.append(out[start + i])
    if len(out) != n:
        raise ValueError(f"snappy: expected {n} bytes, got {len(out)}")
    return bytes(out)


# ---------------------------------------------------------------------------
# log format (doc/log_format.md) — shared by .log files and the MANIFEST
# ---------------------------------------------------------------------------

_LOG_BLOCK = 32768
_FULL, _FIRST, _MIDDLE, _LAST = 1, 2, 3, 4


def read_log_records(path: str, verify_crc: bool = True):
    """Yield the payload of each record in a leveldb log-format file."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    pending = None
    while pos + 7 <= len(data):
        block_left = _LOG_BLOCK - (pos % _LOG_BLOCK)
        if block_left < 7:                     # zero-padded block trailer
            pos += block_left
            continue
        masked, length, rtype = struct.unpack_from("<IHB", data, pos)
        if rtype == 0 and length == 0 and masked == 0:
            # preallocated / zeroed region: skip to next block
            pos += block_left
            continue
        payload = data[pos + 7: pos + 7 + length]
        pos += 7 + length
        if verify_crc:
            expect = crc_unmask(masked)
            got = crc32c(bytes([rtype]) + payload)
            if expect != got:
                raise ValueError(f"{path}: log record crc mismatch")
        if rtype == _FULL:
            yield payload
        elif rtype == _FIRST:
            pending = bytearray(payload)
        elif rtype in (_MIDDLE, _LAST):
            if pending is None:
                continue                       # tail of a rewritten file
            pending += payload
            if rtype == _LAST:
                yield bytes(pending)
                pending = None
        else:
            raise ValueError(f"{path}: bad log record type {rtype}")


def _append_log_record(out: bytearray, payload: bytes) -> None:
    """Append one record, fragmenting across 32 KiB block boundaries."""
    first = True
    while True:
        block_left = _LOG_BLOCK - (len(out) % _LOG_BLOCK)
        if block_left < 7:
            out += b"\0" * block_left
            continue
        frag = payload[: block_left - 7]
        payload = payload[len(frag):]
        end = not payload
        rtype = (_FULL if end else _FIRST) if first else (
            _LAST if end else _MIDDLE)
        crc = crc_mask(crc32c(bytes([rtype]) + frag))
        out += struct.pack("<IHB", crc, len(frag), rtype) + frag
        first = False
        if end:
            return


# ---------------------------------------------------------------------------
# WriteBatch (db/write_batch.cc): seq u64 | count u32 | count x entries
# ---------------------------------------------------------------------------

_T_DELETION, _T_VALUE = 0, 1


def decode_write_batch(payload: bytes):
    """Yield (seq, type, key, value) for each entry of a WriteBatch."""
    seq, count = struct.unpack_from("<QI", payload, 0)
    pos = 12
    for i in range(count):
        t = payload[pos]
        pos += 1
        key, pos = _get_length_prefixed(payload, pos)
        val = b""
        if t == _T_VALUE:
            val, pos = _get_length_prefixed(payload, pos)
        yield seq + i, t, key, val


def encode_write_batch(seq: int, items) -> bytes:
    """items: iterable of (key, value_or_None) — None marks a deletion."""
    body = bytearray()
    count = 0
    for key, val in items:
        if val is None:
            body += bytes([_T_DELETION]) + _put_varint(len(key)) + key
        else:
            body += (bytes([_T_VALUE]) + _put_varint(len(key)) + key
                     + _put_varint(len(val)) + val)
        count += 1
    return struct.pack("<QI", seq, count) + bytes(body)


# ---------------------------------------------------------------------------
# MANIFEST / VersionEdit (db/version_edit.cc tags)
# ---------------------------------------------------------------------------

_TAG_COMPARATOR = 1
_TAG_LOG_NUMBER = 2
_TAG_NEXT_FILE = 3
_TAG_LAST_SEQ = 4
_TAG_COMPACT_POINTER = 5
_TAG_DELETED_FILE = 6
_TAG_NEW_FILE = 7
_TAG_PREV_LOG = 9


def read_manifest(path: str):
    """Apply every VersionEdit; return (live_files, log_number, last_seq).

    live_files: list of (level, file_number) still referenced by the
    current version, in the order added.
    """
    added: dict[tuple[int, int], bool] = {}
    log_number = 0
    last_seq = 0
    for payload in read_log_records(path):
        pos = 0
        while pos < len(payload):
            tag, pos = _get_varint(payload, pos)
            if tag == _TAG_COMPARATOR:
                _name, pos = _get_length_prefixed(payload, pos)
            elif tag in (_TAG_LOG_NUMBER, _TAG_NEXT_FILE, _TAG_LAST_SEQ,
                         _TAG_PREV_LOG):
                v, pos = _get_varint(payload, pos)
                if tag == _TAG_LOG_NUMBER:
                    log_number = v
                elif tag == _TAG_LAST_SEQ:
                    last_seq = v
            elif tag == _TAG_COMPACT_POINTER:
                _level, pos = _get_varint(payload, pos)
                _ikey, pos = _get_length_prefixed(payload, pos)
            elif tag == _TAG_DELETED_FILE:
                level, pos = _get_varint(payload, pos)
                fno, pos = _get_varint(payload, pos)
                added.pop((level, fno), None)
            elif tag == _TAG_NEW_FILE:
                level, pos = _get_varint(payload, pos)
                fno, pos = _get_varint(payload, pos)
                _size, pos = _get_varint(payload, pos)
                _small, pos = _get_length_prefixed(payload, pos)
                _large, pos = _get_length_prefixed(payload, pos)
                added[(level, fno)] = True
            else:
                raise ValueError(f"{path}: unknown VersionEdit tag {tag}")
    return list(added), log_number, last_seq


# ---------------------------------------------------------------------------
# SSTable (doc/table_format.md)
# ---------------------------------------------------------------------------

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_SIZE = 48
_NO_COMPRESSION, _SNAPPY = 0, 1


def _decode_block(raw: bytes, path: str, verify_crc: bool = True) -> bytes:
    """raw = block contents + 1-byte type + 4-byte masked crc."""
    body, btype = raw[:-5], raw[-5]
    if verify_crc:
        expect = crc_unmask(struct.unpack_from("<I", raw, len(raw) - 4)[0])
        if expect != crc32c(raw[:-4]):
            raise ValueError(f"{path}: table block crc mismatch")
    if btype == _NO_COMPRESSION:
        return body
    if btype == _SNAPPY:
        return snappy_decompress(body)
    raise ValueError(f"{path}: unknown block compression {btype}")


def _iter_block_entries(block: bytes):
    """Yield (key, value) from a prefix-compressed leveldb block."""
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    limit = len(block) - 4 * (n_restarts + 1)
    pos = 0
    key = b""
    while pos < limit:
        shared, pos = _get_varint(block, pos)
        non_shared, pos = _get_varint(block, pos)
        vlen, pos = _get_varint(block, pos)
        key = key[:shared] + block[pos: pos + non_shared]
        pos += non_shared
        yield key, block[pos: pos + vlen]
        pos += vlen


def _encode_block(items) -> bytes:
    """Build a block with a single restart point (valid; readers only
    need restarts for seeks, and this reader scans)."""
    out = bytearray()
    prev = b""
    for key, val in items:
        shared = 0
        while (shared < len(prev) and shared < len(key)
               and prev[shared] == key[shared]):
            shared += 1
        out += (_put_varint(shared) + _put_varint(len(key) - shared)
                + _put_varint(len(val)))
        out += key[shared:] + val
        prev = key
    out += struct.pack("<II", 0, 1)            # restarts[0]=0, count=1
    return bytes(out)


class SstReader:
    """Scan one .ldb/.sst table in key order (internal keys)."""

    def __init__(self, path: str, verify_crc: bool = True):
        self.path = path
        self.verify_crc = verify_crc
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(size - _FOOTER_SIZE)
            footer = f.read(_FOOTER_SIZE)
        magic = struct.unpack_from("<Q", footer, _FOOTER_SIZE - 8)[0]
        if magic != _TABLE_MAGIC:
            raise ValueError(f"{path}: bad sstable magic")
        pos = 0
        _mi_off, pos = _get_varint(footer, pos)
        _mi_size, pos = _get_varint(footer, pos)
        idx_off, pos = _get_varint(footer, pos)
        idx_size, pos = _get_varint(footer, pos)
        self._handles = []                     # data block (offset, size)
        idx_block = self._read_block(idx_off, idx_size)
        for _key, val in _iter_block_entries(idx_block):
            off, p = _get_varint(val, 0)
            sz, _ = _get_varint(val, p)
            self._handles.append((off, sz))
        self._cache: tuple[tuple[int, int], list] | None = None

    def _read_block(self, offset: int, size: int) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(offset)
            raw = f.read(size + 5)
        return _decode_block(raw, self.path, self.verify_crc)

    def _block_entries(self, handle) -> list:
        if self._cache is not None and self._cache[0] == handle:
            return self._cache[1]
        entries = list(_iter_block_entries(self._read_block(*handle)))
        self._cache = (handle, entries)
        return entries

    def entry_locs(self):
        """Yield (internal_key, (block_idx, entry_idx, value_len))."""
        for bi, handle in enumerate(self._handles):
            for ei, (ikey, val) in enumerate(self._block_entries(handle)):
                yield ikey, (bi, ei, len(val))

    def value_at(self, loc) -> bytes:
        bi, ei, _ = loc
        return self._block_entries(self._handles[bi])[ei][1]


def write_sst(path: str, items, block_size: int = 4096) -> None:
    """Write a minimal valid SSTable of (internal_key, value) items
    (sorted by the caller), uncompressed blocks, no filter block."""
    out = bytearray()
    handles = []                               # (last_key, offset, size)

    def flush(block_items):
        body = _encode_block(block_items)
        off = len(out)
        out.extend(body)
        out.append(_NO_COMPRESSION)
        out.extend(struct.pack(
            "<I", crc_mask(crc32c(body + bytes([_NO_COMPRESSION])))))
        handles.append((block_items[-1][0], off, len(body)))

    cur: list = []
    cur_bytes = 0
    for key, val in items:
        cur.append((key, val))
        cur_bytes += len(key) + len(val) + 8
        if cur_bytes >= block_size:
            flush(cur)
            cur, cur_bytes = [], 0
    if cur:
        flush(cur)

    # metaindex (empty) + index blocks
    def raw_block(body: bytes) -> tuple[int, int]:
        off = len(out)
        out.extend(body)
        out.append(_NO_COMPRESSION)
        out.extend(struct.pack(
            "<I", crc_mask(crc32c(body + bytes([_NO_COMPRESSION])))))
        return off, len(body)

    mi_off, mi_size = raw_block(_encode_block([]))
    idx_items = [
        (last_key, _put_varint(off) + _put_varint(size))
        for last_key, off, size in handles
    ]
    idx_off, idx_size = raw_block(_encode_block(idx_items))

    footer = (_put_varint(mi_off) + _put_varint(mi_size)
              + _put_varint(idx_off) + _put_varint(idx_size))
    footer += b"\0" * (_FOOTER_SIZE - 8 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    out += footer
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# the DB view
# ---------------------------------------------------------------------------


def _internal_key(user_key: bytes, seq: int, t: int) -> bytes:
    return user_key + struct.pack("<Q", (seq << 8) | t)


def _split_internal(ikey: bytes):
    trailer = struct.unpack_from("<Q", ikey, len(ikey) - 8)[0]
    return ikey[:-8], trailer >> 8, trailer & 0xFF


class LevelDbReader:
    """Read-only merged iterator over a LevelDB environment directory.

    Yields the same (key, value) sequence a ``leveldb::Iterator`` walk
    gives the reference's cursor: user-key order, newest sequence wins,
    deletion tombstones drop the key.
    """

    def __init__(self, path: str, verify_crc: bool = True):
        self.path = path
        current = os.path.join(path, "CURRENT")
        with open(current, "r", encoding="utf-8") as f:
            manifest = f.read().strip()
        live, log_number, self.last_seq = read_manifest(
            os.path.join(path, manifest))

        # memtable: every log file >= the manifest's log number
        self._mem: dict[bytes, tuple[int, int, bytes]] = {}
        for fname in sorted(os.listdir(path)):
            if not fname.endswith(".log"):
                continue
            fno = int(fname.split(".")[0])
            if fno < log_number:
                continue                        # already flushed to tables
            for payload in read_log_records(
                    os.path.join(path, fname), verify_crc):
                for seq, t, key, val in decode_write_batch(payload):
                    prev = self._mem.get(key)
                    if prev is None or seq >= prev[0]:
                        self._mem[key] = (seq, t, val)

        self._ssts = []
        for _level, fno in live:
            for ext in (".ldb", ".sst"):
                p = os.path.join(path, f"{fno:06d}{ext}")
                if os.path.exists(p):
                    self._ssts.append(SstReader(p, verify_crc))
                    break
            else:
                raise FileNotFoundError(
                    f"{path}: live table {fno:06d} missing")

    def item_locs(self):
        """Yield (user_key, loc) in key order without copying SST values."""
        import heapq

        def mem_stream():
            for key in sorted(self._mem):
                seq, t, _val = self._mem[key]
                yield key, seq, t, ("mem", key)

        def sst_stream(si, sst):
            for ikey, loc in sst.entry_locs():
                ukey, seq, t = _split_internal(ikey)
                yield ukey, seq, t, ("sst", si, loc)

        streams = [mem_stream()] + [
            sst_stream(i, s) for i, s in enumerate(self._ssts)
        ]
        merged = heapq.merge(
            *streams, key=lambda e: (e[0], -e[1])
        )
        last_key = None
        for ukey, _seq, t, loc in merged:
            if ukey == last_key:
                continue                        # older version of the key
            last_key = ukey
            if t == _T_DELETION:
                continue
            yield ukey, loc

    def value_at(self, loc) -> bytes:
        kind = loc[0]
        if kind == "mem":
            return self._mem[loc[1]][2]
        _tag, si, sloc = loc
        return self._ssts[si].value_at(sloc)

    def items(self):
        for key, loc in self.item_locs():
            yield key, self.value_at(loc)

    def values(self):
        for _k, v in self.items():
            yield v

    def __len__(self) -> int:
        return sum(1 for _ in self.item_locs())


# ---------------------------------------------------------------------------
# fixture writer
# ---------------------------------------------------------------------------


def write_leveldb(path: str, items: list[tuple[bytes, bytes]],
                  as_table: bool = False) -> None:
    """Write a minimal valid LevelDB directory.

    as_table=False (default): CURRENT + MANIFEST + one .log holding a
    single WriteBatch — byte-for-byte the state leveldb itself leaves
    after writing a small dataset and closing (memtable never flushed).
    as_table=True: the entries live in one level-0 SSTable referenced by
    the MANIFEST instead (exercises the table read path).
    """
    os.makedirs(path, exist_ok=True)
    log_no, table_no, manifest_no = 3, 5, 1
    last_seq = len(items)

    edit = bytearray()
    edit += _put_varint(_TAG_COMPARATOR)
    name = b"leveldb.BytewiseComparator"
    edit += _put_varint(len(name)) + name
    edit += _put_varint(_TAG_LOG_NUMBER) + _put_varint(log_no)
    edit += _put_varint(_TAG_NEXT_FILE) + _put_varint(6)
    edit += _put_varint(_TAG_LAST_SEQ) + _put_varint(last_seq)

    if as_table:
        internal = sorted(
            (_internal_key(k, i + 1, _T_VALUE), v)
            for i, (k, v) in enumerate(items)
        )
        write_sst(os.path.join(path, f"{table_no:06d}.ldb"), internal)
        edit += _put_varint(_TAG_NEW_FILE) + _put_varint(0)
        edit += _put_varint(table_no) + _put_varint(
            os.path.getsize(os.path.join(path, f"{table_no:06d}.ldb")))
        for ik in (internal[0][0], internal[-1][0]):
            edit += _put_varint(len(ik)) + ik
        log_payloads: list[bytes] = []
    else:
        log_payloads = [encode_write_batch(1, [(k, v) for k, v in items])]

    manifest = bytearray()
    _append_log_record(manifest, bytes(edit))
    with open(os.path.join(path, f"MANIFEST-{manifest_no:06d}"),
              "wb") as f:
        f.write(bytes(manifest))
    with open(os.path.join(path, "CURRENT"), "w", encoding="utf-8") as f:
        f.write(f"MANIFEST-{manifest_no:06d}\n")
    log = bytearray()
    for payload in log_payloads:
        _append_log_record(log, payload)
    with open(os.path.join(path, f"{log_no:06d}.log"), "wb") as f:
        f.write(bytes(log))
