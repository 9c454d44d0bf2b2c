"""Image and pairs-list IO (port of ``nct_tpu/io.py``).

Images are uint8 BGR numpy arrays [H, W, 3], capped to MAX_SIZE on the
longer side; results are written as ``<src>_<ref>_<bds%.2f>.png``.
PNG files are read and written by ``data.png`` (zlib and numpy) and JPEG
files are read by ``data.jpeg`` (the repo's own decoder), so the CLI needs
no imaging library.  Other formats go through Pillow, imported inside the
two functions; without it they raise ``OSError`` naming the format.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from nct_tpu_torch.data import jpeg, png
from nct_tpu_torch.ops.resize import max_size_resize_dims, resize_bilinear


def _pillow(path: str, fmt: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise OSError(f"{path}: {fmt} files need Pillow, which is not "
                      f"installed (PNG needs nothing)") from e
    return Image


def imread_bgr(path: str) -> np.ndarray:
    """Read an image file as uint8 BGR [H, W, 3]: PNG and JPEG (told by
    their signatures) through ``data.png`` and ``data.jpeg``, anything
    else through Pillow."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(png.SIGNATURE):
        return png.decode(data, path)
    if data.startswith(jpeg.SOI):
        return jpeg.decode(data, path)
    fmt = os.path.splitext(path)[1].lstrip(".").upper() or "unknown-format"
    image = _pillow(path, fmt)
    with image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
    return rgb[..., ::-1].copy()


def imwrite_bgr(path: str, bgr: np.ndarray) -> None:
    """Write a uint8 BGR [H, W, 3] array: ``.png`` through ``data.png``,
    other extensions through Pillow."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        png.write(path, np.asarray(bgr, dtype=np.uint8))
        return
    image = _pillow(path, ext.lstrip(".").upper() or "extensionless")
    rgb = np.asarray(bgr, dtype=np.uint8)[..., ::-1]
    image.fromarray(rgb).save(path)


def cap_max_size(img: np.ndarray, max_size: int) -> np.ndarray:
    """Downscale so the longer side is <= max_size (ref main.cu:499-522)."""
    h, w = img.shape[:2]
    nh, nw = max_size_resize_dims(h, w, max_size)
    if (nh, nw) == (h, w):
        return img
    return resize_bilinear(torch.from_numpy(np.ascontiguousarray(img)),
                           nh, nw).numpy()


@dataclass(frozen=True)
class Pair:
    """One line of pairs.txt: content path, style path, BDS weight."""

    content: str
    style: str
    bds_weight: float


def read_pairs(pairs_path: str, default_bds: float | None = None) -> list[Pair]:
    """Parse pairs.txt: whitespace-separated ``src ref bds`` per line.  A
    2-field line takes ``default_bds`` when one is given."""
    pairs: list[Pair] = []
    with open(pairs_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 3:
                bds = float(parts[2])
            elif len(parts) == 2 and default_bds is not None:
                bds = float(default_bds)
            else:
                raise ValueError(f"malformed pairs.txt line: {line!r}")
            pairs.append(Pair(parts[0], parts[1], bds))
    return pairs


def output_name(cnt_path: str, stl_path: str, bds_weight: float) -> str:
    """``<cntStem>_<stlStem>_<bds%2.2f>.png`` (ref main.cu:524-538)."""
    cnt_pre = os.path.splitext(os.path.basename(cnt_path))[0]
    stl_pre = os.path.splitext(os.path.basename(stl_path))[0]
    return f"{cnt_pre}_{stl_pre}_{bds_weight:2.2f}.png"
