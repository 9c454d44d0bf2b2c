"""Convert a Caffe image list into Datum record shards or HDF5 shards
(port of ``tools/convert_imageset.py``; reference:
tools/convert_imageset.cpp, which reads ``path label`` lines, optionally
shuffles and resizes, and writes each image as a Datum into a DB).

    python -m nct_tpu_torch.tools.convert_imageset LISTFILE OUTDIR \\
        [--root-folder DIR] [--resize-height H] [--resize-width W] \\
        [--shuffle] [--shard-size N] [--seed S] [--backend hdf5|records]

``records`` writes ``shard_NNNNN.ncr`` Datum shards for ``type: "Data"``
layers; ``hdf5`` writes ``shard_NNNNN.h5`` (``data`` NCHW float32 and
``label``) for HDF5Data, and needs h5py.  Both write ``OUTDIR/source.txt``,
the list the layer's ``source`` names.  Images decode and resize through
``data.image_data.read_image``; the files are byte-identical (records) or
array-equal (hdf5) to the JAX tool's.  A host tool: nothing goes to a
device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nct_tpu_torch.data.image_data import read_image
from nct_tpu_torch.data.records import RecordWriter


def _lines(listfile: str, shuffle: bool, seed: int) -> list[list[str]]:
    with open(listfile) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    if shuffle:
        np.random.default_rng(seed).shuffle(lines)
    if not lines:
        raise ValueError(f"no entries in {listfile}")
    return lines


def _write_source(outdir: str, shard_paths: list[str]) -> str:
    source = os.path.join(outdir, "source.txt")
    with open(source, "w") as f:
        f.write("\n".join(shard_paths) + "\n")
    return source


def convert(listfile: str, outdir: str, root: str = "",
            new_h: int = 0, new_w: int = 0, shuffle: bool = False,
            shard_size: int = 4096, seed: int = 0) -> str:
    """HDF5 shards (``data`` N x C x H x W float32, ``label``); returns the
    source list, which names the shards relative to it."""
    import h5py

    lines = _lines(listfile, shuffle, seed)
    os.makedirs(outdir, exist_ok=True)
    shard_paths = []
    for s0 in range(0, len(lines), shard_size):
        chunk = lines[s0:s0 + shard_size]
        data = np.stack([read_image(os.path.join(root, e[0]), new_h, new_w)
                         for e in chunk]).astype(np.float32)
        labels = [float(e[1]) if len(e) > 1 else 0.0 for e in chunk]
        name = f"shard_{s0 // shard_size:05d}.h5"
        with h5py.File(os.path.join(outdir, name), "w") as h5:
            h5.create_dataset("data", data=data.transpose(0, 3, 1, 2))
            h5.create_dataset("label", data=np.asarray(labels, np.float32))
        shard_paths.append(name)
    return _write_source(outdir, shard_paths)


def convert_records(listfile: str, outdir: str, root: str = "",
                    new_h: int = 0, new_w: int = 0, shuffle: bool = False,
                    shard_size: int = 4096, seed: int = 0) -> str:
    """Datum record shards; returns the source list, which names each
    shard by its path."""
    lines = _lines(listfile, shuffle, seed)
    os.makedirs(outdir, exist_ok=True)
    shard_paths = []
    for s0 in range(0, len(lines), shard_size):
        path = os.path.join(outdir, f"shard_{s0 // shard_size:05d}.ncr")
        with RecordWriter(path) as wr:
            for entry in lines[s0:s0 + shard_size]:
                label = int(float(entry[1])) if len(entry) > 1 else 0
                wr.write_image(read_image(os.path.join(root, entry[0]),
                                          new_h, new_w), label)
        shard_paths.append(path)
    return _write_source(outdir, shard_paths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("listfile")
    ap.add_argument("outdir")
    ap.add_argument("--root-folder", default="")
    ap.add_argument("--resize-height", type=int, default=0)
    ap.add_argument("--resize-width", type=int, default=0)
    ap.add_argument("--shuffle", action="store_true")
    ap.add_argument("--shard-size", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=("hdf5", "records"), default="hdf5",
                    help="hdf5 -> HDF5Data shards; records -> Datum record "
                         "shards for `type: \"Data\"` layers")
    args = ap.parse_args(argv)
    fn = convert_records if args.backend == "records" else convert
    source = fn(args.listfile, args.outdir, args.root_folder,
                args.resize_height, args.resize_width, args.shuffle,
                args.shard_size, args.seed)
    print(f"wrote {args.backend} source list {source}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
