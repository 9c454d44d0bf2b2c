"""Convert between LMDB / LevelDB databases and Datum record shards (port
of ``tools/convert_db.py``).

The Caffe tools write training datasets as LMDB or LevelDB of serialized
Datums (tools/convert_imageset.cpp + util/db_lmdb.cpp / db_leveldb.cpp);
record shards (``data.records``) hold the same Datum bytes, so a
conversion transcribes them and never re-encodes.

    python -m nct_tpu_torch.tools.convert_db lmdb2records    ENV   out.ncr
    python -m nct_tpu_torch.tools.convert_db leveldb2records ENV   out.ncr
    python -m nct_tpu_torch.tools.convert_db records2lmdb    shard.ncr ENV
    python -m nct_tpu_torch.tools.convert_db records2leveldb shard.ncr ENV

``records2lmdb`` writes one leaf page (``write_lmdb``) and
``records2leveldb`` a log-only environment (``write_leveldb``): small
exports.  A ``type: "Data"`` layer also reads LMDB and LevelDB directly.
The files are byte-identical to the JAX tool's.  A host tool: nothing
goes to a device.
"""

from __future__ import annotations

import argparse

from nct_tpu_torch.data.records import RecordFile, RecordWriter


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=("lmdb2records", "records2lmdb",
                                     "leveldb2records", "records2leveldb"))
    ap.add_argument("src")
    ap.add_argument("dst")
    args = ap.parse_args(argv)

    if args.mode.endswith("2records"):
        if args.mode.startswith("lmdb"):
            from nct_tpu_torch.data.lmdb_reader import LmdbReader
            reader = LmdbReader(args.src)
        else:
            from nct_tpu_torch.data.leveldb_reader import LevelDbReader
            reader = LevelDbReader(args.src)
        n = 0
        with RecordWriter(args.dst) as w:
            for _key, val in reader.items():
                w.write(val)
                n += 1
        print(f"wrote {n} records ({len(reader)} DB entries) -> {args.dst}")
    else:
        shard = RecordFile(args.src)
        items = [(f"{i:08d}".encode(), shard.read(i))
                 for i in range(len(shard))]
        if args.mode.endswith("2lmdb"):
            from nct_tpu_torch.data.lmdb_reader import write_lmdb
            write_lmdb(args.dst, items)
        else:
            from nct_tpu_torch.data.leveldb_reader import write_leveldb
            write_leveldb(args.dst, items)
        print(f"wrote DB with {len(items)} entries -> {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
