"""ImageData source + DataTransformer: the list-file training input path
(port of ``nct_tpu/data/image_data.py``).

Rebuilds the reference's ImageDataLayer (src/caffe/layers/
image_data_layer.cpp: a ``source`` list file of "path label" lines under
``root_folder``, optional new_height / new_width resize, shuffle and
rand_skip, a fixed batch_size with wrap-around) and DataTransformer
(src/caffe/data_transformer.cpp: crop_size -- random at TRAIN, centre at
TEST -- random horizontal mirror, mean_value / mean_file, scale).

Images decode through ``io.imread_bgr`` (PNG and JPEG without Pillow).
The resize copies the arithmetic of the JAX package's native loader
(``native/dataloader.cpp`` ``resize_bilinear``, which the JAX source uses
wherever the native library builds): float32 taps, horizontal then
vertical, rounded half away from zero.  That differs from
``ops.resize.resize_bilinear`` (vertical first, half to even) in the last
bit of some pixels.  The random draws are numpy ``default_rng(seed)``'s,
in the JAX source's order, so both give the same batches.  Batches are
NCHW float32 (the JAX source's are NHWC).
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from nct_tpu_torch.data import jpeg, png
from nct_tpu_torch.io import imread_bgr


def _axis_taps(dst: int, src: int):
    """(lo, hi, frac) of one axis, in the native loader's float32 math."""
    scale = np.float32(src) / np.float32(dst)
    c = (np.arange(dst, dtype=np.float32) + np.float32(0.5)) * scale \
        - np.float32(0.5)
    lo = np.floor(c)
    frac = c - lo
    lo_i = np.clip(lo.astype(np.int64), 0, src - 1)
    hi_i = np.minimum(lo_i + 1, src - 1)
    frac = np.where((c < 0) | (c > np.float32(src - 1)), np.float32(0), frac)
    return lo_i, hi_i, frac.astype(np.float32)


def resize_like_native(img: np.ndarray, new_h: int, new_w: int
                       ) -> np.ndarray:
    """uint8 HWC bilinear resize, bitwise ``NativeLib.resize_bilinear``."""
    xl, xh, xf = _axis_taps(new_w, img.shape[1])
    yl, yh, yf = _axis_taps(new_h, img.shape[0])
    src = img.astype(np.float32)
    one = np.float32(1)
    xf3 = xf[None, :, None]

    def rows(r):
        return src[r][:, xl] * (one - xf3) + src[r][:, xh] * xf3

    a0, a1 = rows(yl), rows(yh)
    yf3 = yf[:, None, None]
    v = a0 * (one - yf3) + a1 * yf3
    out = np.floor(v.astype(np.float64) + 0.5)      # v >= 0: half away
    return np.clip(out, 0, 255).astype(np.uint8)


def image_hw(path: str) -> tuple[int, int]:
    """(height, width) of an image file from its header (PNG's IHDR, a
    JPEG's SOF), decoding only other formats."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(png.SIGNATURE) and len(data) >= 24:
        w, h = struct.unpack(">II", data[16:24])
        return h, w
    if data.startswith(jpeg.SOI):
        pos = 2
        while pos + 9 <= len(data):
            if data[pos] != 0xFF:
                break
            marker = data[pos + 1]
            if marker == 0xFF:              # fill byte
                pos += 1
                continue
            if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                h, w = struct.unpack(">HH", data[pos + 5:pos + 9])
                return h, w
            pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return imread_bgr(path).shape[:2]


def read_image(path: str, new_h: int = 0, new_w: int = 0) -> np.ndarray:
    """uint8 BGR HWC, resized to (new_h, new_w) when both are given
    (ReadImageToCVMat)."""
    img = imread_bgr(path)
    if new_h and new_w and img.shape[:2] != (new_h, new_w):
        img = resize_like_native(img, new_h, new_w)
    return img


class DataTransformer:
    """(pixel - mean) * scale with crop / mirror (data_transformer.cpp);
    uint8 HWC BGR in, float32 CHW out."""

    def __init__(self, transform_param: dict | None, phase: str = "TRAIN",
                 seed: int = 0):
        tp = transform_param or {}
        self.scale = float(tp.get("scale", 1.0))
        self.mirror = tp.get("mirror", False) in (True, "true")
        self.crop_size = int(tp.get("crop_size", 0))
        mv = tp.get("mean_value", [])
        self.mean_values = [float(v) for v in
                            (mv if isinstance(mv, list) else [mv])]
        # mean_file: a per-pixel HWC mean image (npz "mean" or npy)
        self.mean_image = None
        mf = tp.get("mean_file")
        if mf:
            if self.mean_values:
                raise ValueError(
                    "mean_file and mean_value are exclusive "
                    "(data_transformer.cpp enforces the same)")
            data = np.load(str(mf))
            self.mean_image = np.asarray(
                data["mean"] if hasattr(data, "files") else data, np.float32)
        self.phase = phase
        self._rng = np.random.default_rng(seed)

    def draw(self, h: int, w: int) -> tuple[int, int, bool]:
        """The random choices for an h x w image, in the JAX source's
        order: crop offsets (centred at TEST), then the mirror bit."""
        h_off = w_off = 0
        cs = self.crop_size
        if cs:
            if self.phase == "TRAIN":
                h_off = int(self._rng.integers(0, h - cs + 1))
                w_off = int(self._rng.integers(0, w - cs + 1))
            else:
                h_off, w_off = (h - cs) // 2, (w - cs) // 2
        flip = bool(self.mirror and self.phase == "TRAIN"
                    and self._rng.integers(2))
        return h_off, w_off, flip

    def __call__(self, img_bgr_u8: np.ndarray) -> np.ndarray:
        return self.apply(img_bgr_u8, self.draw(*img_bgr_u8.shape[:2]))

    def apply(self, img_bgr_u8: np.ndarray, draws) -> np.ndarray:
        """The transform with the choices ``draw`` made."""
        h_off, w_off, flip = draws
        x = img_bgr_u8.astype(np.float32)
        cs = self.crop_size
        mean_img = self.mean_image
        if cs:
            x = x[h_off:h_off + cs, w_off:w_off + cs]
            if mean_img is not None:
                # the mean image at the same crop offsets
                mean_img = mean_img[h_off:h_off + cs, w_off:w_off + cs]
        if mean_img is not None:
            x = x - mean_img          # before mirror, in source coordinates
        if flip:
            x = x[:, ::-1]
        if self.mean_values:
            mv = self.mean_values
            if len(mv) == 1:
                mv = mv * x.shape[-1]
            x = x - np.asarray(mv, np.float32)
        if self.scale != 1.0:
            x = x * np.float32(self.scale)
        return np.ascontiguousarray(x.transpose(2, 0, 1))


class ImageDataSource:
    """(images [B, C, H, W] float32, labels [B] float32) batches from a
    Caffe image list file, wrapping around forever (image_data_layer.cpp
    load_batch)."""

    def __init__(self, layer_cfg: dict, phase: str = "TRAIN",
                 seed: int = 0):
        idp = layer_cfg.get("image_data_param", {}) or {}
        source = str(idp.get("source"))
        root = str(idp.get("root_folder", ""))
        self.batch_size = int(idp.get("batch_size", 1))
        self.new_h = int(idp.get("new_height", 0))
        self.new_w = int(idp.get("new_width", 0))
        self.lines: list[tuple[str, float]] = []
        with open(source) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                label = float(parts[1]) if len(parts) > 1 else 0.0
                self.lines.append((os.path.join(root, parts[0]), label))
        if not self.lines:
            raise ValueError(f"empty image list {source}")
        self._rng = np.random.default_rng(seed)
        if idp.get("shuffle") in (True, "true"):
            self._rng.shuffle(self.lines)
        self.pos = 0
        self.decoded = 0            # images decoded so far
        if idp.get("rand_skip"):
            self.pos = int(self._rng.integers(0, int(idp["rand_skip"])))
        self.transform = DataTransformer(
            layer_cfg.get("transform_param"), phase=phase, seed=seed)

    def next_batch(self, part: tuple[int, int] | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """The next batch, or with ``part = (i, n)`` its i-th of n equal
        row blocks: only those rows are decoded, and the random draws of
        the others are made from their sizes, so the stream stays the
        whole batch's."""
        i, n = part or (0, 1)
        if self.batch_size % n:
            raise ValueError(f"batch of {self.batch_size} does not split "
                             f"into {n} parts")
        k = self.batch_size // n
        imgs, labels = [], []
        for j in range(self.batch_size):
            path, label = self.lines[self.pos % len(self.lines)]
            self.pos += 1
            if i * k <= j < (i + 1) * k:
                img = read_image(path, self.new_h, self.new_w)
                self.decoded += 1
                imgs.append(self.transform(img))
                labels.append(label)
            elif self.new_h and self.new_w:
                self.transform.draw(self.new_h, self.new_w)
            else:
                self.transform.draw(*image_hw(path))
        return np.stack(imgs), np.asarray(labels, np.float32)

    def state(self) -> dict[str, np.ndarray]:
        """The stream's position: the list position and the transform's
        generator (the list order follows from the seed)."""
        return {"pos": np.asarray(self.pos), "rng": np.asarray(json.dumps(
            self.transform._rng.bit_generator.state))}

    def set_state(self, state: dict) -> None:
        self.pos = int(state["pos"])
        self.transform._rng.bit_generator.state = json.loads(
            str(state["rng"]))

    def __iter__(self):
        while True:
            yield self.next_batch()
