"""Compute the per-pixel mean image of a dataset (port of
``tools/compute_image_mean.py``; reference: tools/compute_image_mean.cpp,
which sums every Datum of a DB per pixel, writes ``mean.binaryproto`` and
prints the per-channel means).

    python -m nct_tpu_torch.tools.compute_image_mean LISTFILE MEAN.npz \\
        [--root-folder DIR] [--new-height H] [--new-width W] [--hdf5 TOP]

LISTFILE is a Caffe image list (``path label`` lines, decoded and resized
through ``data.image_data.read_image``) or, with ``--hdf5 TOP``, an HDF5
source list (needs h5py).  The mean is saved as an ``.npz`` holding
``mean`` ([H, W, C] float32 BGR), the file ``transform_param { mean_file
}`` reads; it is array-equal to the JAX tool's.  A host tool: nothing
goes to a device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nct_tpu_torch.data.image_data import read_image


def mean_from_image_list(listfile: str, root: str = "",
                         new_h: int = 0, new_w: int = 0) -> np.ndarray:
    total = None
    count = 0
    with open(listfile) as f:
        for ln in f:
            if not ln.strip():
                continue
            path = ln.split()[0]
            img = read_image(os.path.join(root, path), new_h, new_w)
            if total is None:
                total = np.zeros(img.shape, np.float64)
            if img.shape != total.shape:
                raise ValueError(
                    f"{path}: shape {img.shape} != {total.shape}; pass "
                    "--new-height/--new-width to resize (the reference "
                    "requires equally sized Datums the same way)")
            total += img
            count += 1
    if not count:
        raise ValueError(f"no images listed in {listfile}")
    return (total / count).astype(np.float32)


def mean_from_hdf5(listfile: str, top: str) -> np.ndarray:
    import h5py

    base = os.path.dirname(os.path.abspath(listfile))
    total = None
    count = 0
    with open(listfile) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            p = ln if os.path.isabs(ln) else os.path.join(base, ln)
            with h5py.File(p, "r") as h5:
                arr = np.asarray(h5[top], np.float64)
            if arr.ndim == 4 and arr.shape[1] in (1, 3) \
                    and arr.shape[-1] not in (1, 3):
                arr = arr.transpose(0, 2, 3, 1)     # NCHW -> HWC mean
            s = arr.sum(axis=0)
            total = s if total is None else total + s
            count += arr.shape[0]
    if not count:
        raise ValueError(f"no rows in HDF5 files listed in {listfile}")
    return (total / count).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("listfile")
    ap.add_argument("output")
    ap.add_argument("--root-folder", default="")
    ap.add_argument("--new-height", type=int, default=0)
    ap.add_argument("--new-width", type=int, default=0)
    ap.add_argument("--hdf5", metavar="TOP", default=None,
                    help="treat LISTFILE as an HDF5 source list; TOP is the "
                         "image dataset name")
    args = ap.parse_args(argv)
    if args.hdf5:
        mean = mean_from_hdf5(args.listfile, args.hdf5)
    else:
        mean = mean_from_image_list(args.listfile, args.root_folder,
                                    args.new_height, args.new_width)
    np.savez(args.output, mean=mean)
    # per-channel means, as the reference prints them
    for c in range(mean.shape[-1]):
        print(f"mean_value channel [{c}]: {float(mean[..., c].mean()):.6f}")
    print(f"wrote {mean.shape} mean to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
