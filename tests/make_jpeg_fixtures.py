"""Write the JPEG fixtures of ``tests/test_torch_jpeg.py`` and
``chip_smoke.py`` phase 13 into ``tests/fixtures/jpeg/``.

    python tests/make_jpeg_fixtures.py

Needs Pillow, OpenCV (``cv2``) and torch on the CPU.  Every file is
written by libjpeg through Pillow or OpenCV, with no EXIF block (OpenCV's
reader would rotate by it, Pillow's does not).  ``digests.json`` holds
each file's decoded shape and the sha256 of Pillow's decode as uint8 BGR
[H, W, 3] bytes, the reference the card's machine (which has neither
Pillow nor OpenCV) checks the port's decoder against.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import cv2
import numpy as np
import torch
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "fixtures", "jpeg")
sys.path.insert(0, os.path.dirname(HERE))

# ImageData fixtures: 16 images of 256 x 256, labels i % 4
IMAGEDATA_N = 16
IMAGEDATA_HW = (256, 256)


def photo_like(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth, photo-like uint8 BGR [h, w, 3]: low-frequency colour fields,
    a few soft edges and light grain."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    y, x = y / max(h, 1), x / max(w, 1)
    img = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(3):
            fy, fx = rng.uniform(0.5, 4, 2)
            img[..., c] += rng.uniform(20, 50) * np.sin(
                2 * np.pi * (fy * y + fx * x) + rng.uniform(0, 2 * np.pi))
    cy, cx, r = rng.uniform(0.2, 0.8, 3)
    disc = ((y - cy) ** 2 + (x - cx) ** 2) < (0.4 * r) ** 2
    img[disc] += rng.uniform(-60, 60, 3)
    img += 128 + rng.normal(0, 3, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _cv2(bgr, **params) -> bytes:
    flags = []
    for k, v in params.items():
        flags += [getattr(cv2, "IMWRITE_JPEG_" + k.upper()), int(v)]
    ok, enc = cv2.imencode(".jpg", bgr, flags)
    assert ok
    return enc.tobytes()


def _pil(bgr, **kw) -> bytes:
    buf = io.BytesIO()
    arr = bgr if bgr.ndim == 2 else bgr[..., ::-1]
    Image.fromarray(np.ascontiguousarray(arr)).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pillow_bgr(data: bytes) -> np.ndarray:
    """Pillow's decode (``nct_tpu.io.imread_bgr``'s rule) as BGR."""
    with Image.open(io.BytesIO(data)) as im:
        return np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])


def fixtures() -> dict[str, bytes]:
    """name -> JPEG bytes."""
    from chip_smoke import CONTENT_HW, STYLE_HW, _pair

    img = photo_like(96, 128, 0)
    sf = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
          "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
          "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
          "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
          "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
    out = {f"s{k}.jpg": _cv2(img, quality=90, sampling_factor=v)
           for k, v in sf.items()}
    out["grey.jpg"] = _cv2(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), quality=90)
    out["progressive.jpg"] = _pil(img, quality=90, progressive=True)
    out["grey_progressive.jpg"] = _pil(
        cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), quality=90, progressive=True)
    out["rst1.jpg"] = _cv2(img, quality=90, rst_interval=1)
    out["rst7.jpg"] = _cv2(img, quality=90, rst_interval=7,
                           sampling_factor=sf["422"])
    out["optimized.jpg"] = _pil(img, quality=90, optimize=True)
    for h, w in ((1, 1), (17, 23), (8, 1000)):
        out[f"odd_{h}x{w}.jpg"] = _pil(photo_like(h, w, h * w),
                                       quality=90, subsampling="4:2:0")
    cnt, stl = _pair(torch, torch.Generator().manual_seed(8), CONTENT_HW,
                     STYLE_HW, smooth=True)
    for name, bgr in (("pair_content", cnt), ("pair_style", stl)):
        out[f"{name}.jpg"] = _pil(bgr, quality=90, subsampling="4:2:0")
        out[f"{name}_progressive.jpg"] = _pil(bgr, quality=90,
                                              subsampling="4:2:0",
                                              progressive=True)
    for i in range(IMAGEDATA_N):
        out[f"imagedata/img_{i:02d}.jpg"] = _pil(
            photo_like(*IMAGEDATA_HW, 100 + i), quality=85)
    return out


def main() -> int:
    os.makedirs(os.path.join(OUT, "imagedata"), exist_ok=True)
    digests = {}
    for name, data in sorted(fixtures().items()):
        if b"Exif" in data[:64]:
            raise AssertionError(f"{name} carries an EXIF block")
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        bgr = pillow_bgr(data)
        digests[name] = {"shape": list(bgr.shape),
                         "sha256": hashlib.sha256(bgr.tobytes()).hexdigest()}
    with open(os.path.join(OUT, "imagedata", "list.txt"), "w") as f:
        for i in range(IMAGEDATA_N):
            f.write(f"img_{i:02d}.jpg {i % 4}\n")
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(dp, fn))
                for dp, _, fns in os.walk(OUT) for fn in fns)
    print(f"{len(digests)} JPEG files, {total} bytes in {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
