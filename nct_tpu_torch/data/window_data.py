"""WindowData source: fg/bg-sampled crops from annotated detection windows
(port of ``nct_tpu/data/window_data.py``).

Rebuilds the reference's WindowDataLayer (reference:
src/caffe/layers/window_data_layer.cpp, the R-CNN training input):

  * ``window_data_param.source`` names a window file (format at
    window_data_layer.cpp:43-51)::

        # <image_index>
        <img_path>
        <channels>
        <height>
        <width>
        <num_windows>
        <class_index> <overlap> <x1> <y1> <x2> <y2>     (repeated)

  * windows split into foreground (overlap >= fg_threshold) and
    background (overlap < bg_threshold; label and overlap forced to 0,
    :132-141);
  * each batch draws ``round(batch_size * fg_fraction)`` foreground and
    the rest background windows uniformly with replacement (:240-277),
    background rows first;
  * every sampled window is cropped (context-padded by ``context_pad``
    pixels at crop scale and clipped to the image, :311-380), warped to
    crop_size x crop_size through ``ops.resize.resize_bilinear`` (bitwise
    the JAX package's), mean-subtracted and scaled, and mirrored at random
    at TRAIN.

Images decode through ``io.imread_bgr``.  Tops: (data [B, C, crop, crop]
float32, label [B] float32); the JAX source's data is NHWC.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nct_tpu_torch.io import imread_bgr
from nct_tpu_torch.ops.resize import resize_bilinear


def parse_window_file(path: str, root: str = ""):
    """-> (images [(path, (c, h, w))], windows); windows are
    (image_idx, label, overlap, x1, y1, x2, y2)."""
    images: list[tuple[str, tuple[int, int, int]]] = []
    windows: list[tuple] = []
    with open(path) as f:
        tok = f.read().split()
    i = 0
    while i < len(tok):
        if tok[i] != "#":
            raise ValueError(f"window file {path}: expected '#', got "
                             f"{tok[i]!r}")
        img_path = os.path.join(root, tok[i + 2])
        c, h, w, num = (int(t) for t in tok[i + 3:i + 7])
        i += 7
        img_idx = len(images)
        images.append((img_path, (c, h, w)))
        for _ in range(num):
            label, overlap = int(tok[i]), float(tok[i + 1])
            x1, y1, x2, y2 = (int(t) for t in tok[i + 2:i + 6])
            i += 6
            windows.append((img_idx, label, overlap, x1, y1, x2, y2))
    return images, windows


def _warp(img: np.ndarray, size: int) -> np.ndarray:
    """float32 HWC bilinear warp of a crop to size x size (cv::resize in
    the reference)."""
    x = img.astype(np.float32)
    if img.shape[:2] == (size, size):
        return x
    return resize_bilinear(torch.from_numpy(x), size, size).numpy()


class WindowDataSource:
    """``type: "WindowData"`` layer analogue: ``next_batch(part=None)``
    streams (data, label) like the other sources."""

    def __init__(self, layer_cfg: dict, phase: str = "TRAIN",
                 seed: int = 0):
        wp = layer_cfg.get("window_data_param", {}) or {}
        tp = layer_cfg.get("transform_param", {}) or {}
        self.batch_size = int(wp.get("batch_size", 1))
        self.fg_fraction = float(wp.get("fg_fraction", 0.25))
        fg_thr = float(wp.get("fg_threshold", 0.5))
        bg_thr = float(wp.get("bg_threshold", 0.5))
        self.context_pad = int(wp.get("context_pad", 0))
        self.crop_size = int(tp.get("crop_size", 0))
        if self.crop_size <= 0:
            raise ValueError("WindowData requires transform_param.crop_size"
                             " (window_data_layer.cpp:162)")
        self.scale = float(tp.get("scale", 1.0))
        self.mirror = bool(tp.get("mirror", False))
        mv = tp.get("mean_value", [])
        self.mean_values = [float(v) for v in
                            (mv if isinstance(mv, list) else [mv])]
        self.phase = phase
        root = str(wp.get("root_folder", ""))
        self.images, windows = parse_window_file(str(wp.get("source")), root)
        self.fg = [w for w in windows if w[2] >= fg_thr]
        # background windows get label / overlap zeroed (:132-141)
        self.bg = [(w[0], 0, 0.0) + w[3:] for w in windows if w[2] < bg_thr]
        if not self.fg or not self.bg:
            raise ValueError("window file needs both fg and bg windows")
        self._rng = np.random.default_rng(seed)
        self._cache: dict[int, np.ndarray] = {}
        self.decoded = 0            # windows cropped and warped so far

    def _image(self, idx: int) -> np.ndarray:
        if idx not in self._cache:
            self._cache[idx] = imread_bgr(self.images[idx][0])
        return self._cache[idx]

    def _draw(self, is_fg: bool) -> tuple[tuple, bool]:
        """A row's draws, in the JAX source's order: the pool index, then
        the mirror bit."""
        pool = self.fg if is_fg else self.bg
        window = pool[int(self._rng.integers(0, len(pool)))]
        flip = bool(self.mirror and self.phase == "TRAIN"
                    and self._rng.integers(2))
        return window, flip

    def _crop(self, window: tuple, flip: bool) -> tuple[np.ndarray, float]:
        img_idx, label, _, x1, y1, x2, y2 = window
        img = self._image(img_idx)
        h, w = img.shape[:2]
        if self.context_pad > 0:
            # pad so the warped crop has context_pad pixels of context on
            # each side: scale the box by crop_size / (crop_size - 2 pad)
            # and clip to the image (:311-345, the clip path)
            cs = self.crop_size
            scale = cs / float(cs - 2 * self.context_pad)
            cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
            half_w = (x2 - x1 + 1) * scale / 2.0
            half_h = (y2 - y1 + 1) * scale / 2.0
            x1, x2 = int(round(cx - half_w)), int(round(cx + half_w))
            y1, y2 = int(round(cy - half_h)), int(round(cy + half_h))
        x1 = max(0, min(x1, w - 1))
        x2 = max(x1 + 1, min(x2, w - 1))
        y1 = max(0, min(y1, h - 1))
        y2 = max(y1 + 1, min(y2, h - 1))
        out = _warp(img[y1:y2 + 1, x1:x2 + 1], self.crop_size)
        if self.mean_values:
            mv = self.mean_values
            if len(mv) == 1:
                mv = mv * out.shape[-1]
            out = out - np.asarray(mv, np.float32)
        if self.scale != 1.0:
            out = out * self.scale
        if flip:
            out = out[:, ::-1]
        return np.ascontiguousarray(out.transpose(2, 0, 1)), float(label)

    def next_batch(self, part: tuple[int, int] | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """The next batch, or with ``part = (i, n)`` its i-th of n equal
        row blocks: only those windows are cropped, and every other row
        still makes both of its draws."""
        i, n = part or (0, 1)
        if self.batch_size % n:
            raise ValueError(f"batch of {self.batch_size} does not split "
                             f"into {n} parts")
        k = self.batch_size // n
        num_fg = int(round(self.batch_size * self.fg_fraction))
        rows = [False] * (self.batch_size - num_fg) + [True] * num_fg
        imgs, labels = [], []
        # bg first, then fg: the reference's is_fg in {0, 1} loop order
        for j, is_fg in enumerate(rows):
            window, flip = self._draw(is_fg)
            if i * k <= j < (i + 1) * k:
                img, label = self._crop(window, flip)
                self.decoded += 1
                imgs.append(img)
                labels.append(label)
        return np.stack(imgs), np.asarray(labels, np.float32)

    def state(self) -> dict[str, np.ndarray]:
        """The stream's position: the generator (windows are drawn with
        replacement, so there is no cursor)."""
        return {"rng": np.asarray(json.dumps(self._rng.bit_generator.state))}

    def set_state(self, state: dict) -> None:
        self._rng.bit_generator.state = json.loads(str(state["rng"]))

    def __iter__(self):
        while True:
            yield self.next_batch()
