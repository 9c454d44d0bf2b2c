"""pycaffe convenience layer: Transformer, Classifier, Detector + io helpers
(port of ``nct_tpu/nn/apps.py``).

Rebuilds the reference's Python application wrappers (reference:
code/python/caffe/classifier.py, detector.py, io.py) over the port's Net.
Blobs are NCHW, so the Transformer works as pycaffe's does: HWC images in,
``set_transpose`` (the apps set (2, 0, 1)) to CHW, the channel swap and
the mean along the channel axis.  PNG and JPEG images load through the
port's own decoders and resize through its OpenCV-rule bilinear resize: no
Pillow, no cv2.
"""

from __future__ import annotations

import numpy as np
import torch

from nct_tpu_torch.io import imread_bgr
from nct_tpu_torch.ops.resize import resize_bilinear


def load_image(filename: str, color: bool = True) -> np.ndarray:
    """An image file (PNG and JPEG without Pillow) as float32 [0, 1] HWC:
    RGB, or with ``color=False`` one channel of ITU-R 601-2 luma in
    Pillow's fixed-point rounding (io.py:279-305 load_image)."""
    bgr = imread_bgr(filename)
    if color:
        return bgr[:, :, ::-1].astype(np.float32) / 255.0
    b, g, r = (bgr[:, :, i].astype(np.int64) for i in range(3))
    grey = (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16
    return (grey.astype(np.float32) / 255.0)[:, :, None]


def resize_image(im: np.ndarray, new_dims, interp_order: int = 1
                 ) -> np.ndarray:
    """Bilinear resize (OpenCV INTER_LINEAR rules) preserving the value
    range (io.py:306-340)."""
    h, w = int(new_dims[0]), int(new_dims[1])
    if im.shape[:2] == (h, w):
        return im.astype(np.float32)
    return resize_bilinear(torch.from_numpy(np.ascontiguousarray(
        im, np.float32)), h, w).numpy()


def oversample(images, crop_dims) -> np.ndarray:
    """4 corners + center, plus mirrors: (10*N, ch, cw, K)
    (io.py:341-384)."""
    im_shape = np.array(images[0].shape)
    crop_dims = np.array(crop_dims, dtype=int)
    im_center = im_shape[:2] / 2.0
    h_ix = (0, im_shape[0] - crop_dims[0])
    w_ix = (0, im_shape[1] - crop_dims[1])
    crops_ix = [(i, j, i + crop_dims[0], j + crop_dims[1])
                for i in h_ix for j in w_ix]
    center = np.tile(im_center, 2) + np.concatenate(
        [-crop_dims / 2.0, crop_dims / 2.0])
    crops_ix.append(tuple(center.astype(int)))
    crops_ix = crops_ix * 2                     # second pass mirrored
    out = np.empty((10 * len(images), crop_dims[0], crop_dims[1],
                    im_shape[-1]), dtype=np.float32)
    ix = 0
    for im in images:
        for n, (y0, x0, y1, x1) in enumerate(crops_ix):
            crop = im[y0:y1, x0:x1]
            out[ix] = crop[:, ::-1] if n >= 5 else crop
            ix += 1
    return out


class Transformer:
    """Deploy-time preprocessing (io.py Transformer): resize to the input's
    dims -> transpose -> channel_swap -> raw_scale -> mean subtraction ->
    input_scale; ``deprocess`` undoes it."""

    def __init__(self, inputs: dict[str, tuple]):
        self.inputs = dict(inputs)
        self.transpose: dict[str, tuple] = {}
        self.channel_swap: dict[str, tuple] = {}
        self.raw_scale: dict[str, float] = {}
        self.mean: dict[str, np.ndarray] = {}
        self.input_scale: dict[str, float] = {}

    def set_transpose(self, in_, order):
        """The axis order taking an image to the input's layout (pycaffe
        sets (2, 0, 1): HWC -> CHW)."""
        self.transpose[in_] = tuple(order)

    def set_channel_swap(self, in_, order):
        """The channel order, applied along axis 0 (after the transpose)."""
        self.channel_swap[in_] = tuple(order)

    def set_raw_scale(self, in_, scale):
        self.raw_scale[in_] = float(scale)

    def set_mean(self, in_, mean):
        """A per-channel mean (K,) or a full (K, H, W) mean image."""
        mean = np.asarray(mean, np.float32)
        self.mean[in_] = mean[:, None, None] if mean.ndim == 1 else mean

    def set_input_scale(self, in_, scale):
        self.input_scale[in_] = float(scale)

    def preprocess(self, in_, data: np.ndarray) -> np.ndarray:
        x = np.asarray(data, np.float32)
        shape = self.inputs.get(in_)
        if shape is not None and x.shape[:2] != tuple(shape[2:4]):
            x = resize_image(x, shape[2:4])
        if in_ in self.transpose:
            x = x.transpose(self.transpose[in_])
        if in_ in self.channel_swap:
            x = x[list(self.channel_swap[in_])]
        if in_ in self.raw_scale:
            x = x * self.raw_scale[in_]
        if in_ in self.mean:
            x = x - self.mean[in_]
        if in_ in self.input_scale:
            x = x * self.input_scale[in_]
        return np.ascontiguousarray(x, np.float32)

    def deprocess(self, in_, data: np.ndarray) -> np.ndarray:
        x = np.asarray(data, np.float32).squeeze()
        if in_ in self.input_scale:
            x = x / self.input_scale[in_]
        if in_ in self.mean:
            x = x + self.mean[in_]
        if in_ in self.raw_scale:
            x = x / self.raw_scale[in_]
        if in_ in self.channel_swap:
            x = x[list(np.argsort(self.channel_swap[in_]))]
        if in_ in self.transpose:
            x = x.transpose(np.argsort(self.transpose[in_]))
        return x


class _NetApp:
    """Shared Net + Transformer setup (classifier.py:26-45 /
    detector.py:38-55)."""

    def __init__(self, model_file, pretrained_file=None, mean=None,
                 input_scale=None, raw_scale=None, channel_swap=None,
                 device=None):
        from nct_tpu_torch.nn.net import Net

        self.net = Net(model_file, phase="TEST", device=device)
        if pretrained_file:
            self.net.copy_trained_layers_from(pretrained_file)
        elif self.net.input_shapes:
            # filler-initialized weights (the reference requires a
            # caffemodel; random filters keep the API drivable in tests)
            self.net.init_params(self.net.input_shapes)
        in_ = self.net.inputs[0]
        self.input_name = in_
        shape = self.net.input_shapes.get(in_)
        self.crop_dims = np.array(shape[2:4]) if shape else None
        self.transformer = Transformer({in_: shape})
        self.transformer.set_transpose(in_, (2, 0, 1))
        if mean is not None:
            self.transformer.set_mean(in_, mean)
        if input_scale is not None:
            self.transformer.set_input_scale(in_, input_scale)
        if raw_scale is not None:
            self.transformer.set_raw_scale(in_, raw_scale)
        if channel_swap is not None:
            self.transformer.set_channel_swap(in_, channel_swap)
        self._out_blob = None
        for cfg in self.net.layers:
            tops = cfg.get("top")
            tops = tops if isinstance(tops, list) else [tops]
            if tops:
                self._out_blob = str(tops[-1])

    def _forward_batch(self, batch: np.ndarray) -> np.ndarray:
        out = self.net.forward({self.input_name: torch.from_numpy(batch)},
                               (self._out_blob,))
        return out[self._out_blob].float().cpu().numpy()


class Classifier(_NetApp):
    """Image classifier: scale, center-crop or 10-crop oversample, forward,
    average (classifier.py)."""

    def __init__(self, model_file, pretrained_file=None, image_dims=None,
                 **kw):
        super().__init__(model_file, pretrained_file, **kw)
        if self.crop_dims is None:
            raise ValueError("deploy prototxt must declare input dims")
        self.image_dims = np.array(
            image_dims if image_dims is not None else self.crop_dims)

    def predict(self, inputs, oversample_crops: bool = True) -> np.ndarray:
        scaled = [resize_image(im, self.image_dims) for im in inputs]
        if oversample_crops:
            batch = oversample(scaled, self.crop_dims)
        else:
            center = self.image_dims / 2.0
            y0, x0 = (center - self.crop_dims / 2.0).astype(int)
            y1, x1 = (center + self.crop_dims / 2.0).astype(int)
            batch = np.stack(
                [im[y0:y1, x0:x1] for im in scaled]).astype(np.float32)
        batch = np.stack([
            self.transformer.preprocess(self.input_name, im)
            for im in batch
        ])
        preds = self._forward_batch(batch)
        preds = preds.reshape(preds.shape[0], -1)
        if oversample_crops:
            preds = preds.reshape(len(preds) // 10, 10, -1).mean(1)
        return preds


class Detector(_NetApp):
    """R-CNN-style windowed detection: crop (with optional context pad),
    warp to input dims, forward, package per window (detector.py)."""

    def __init__(self, model_file, pretrained_file=None, context_pad=0,
                 **kw):
        super().__init__(model_file, pretrained_file, **kw)
        if self.crop_dims is None:
            raise ValueError("deploy prototxt must declare input dims")
        self.context_pad = int(context_pad)

    def crop(self, im: np.ndarray, window) -> np.ndarray:
        """Crop a (ymin, xmin, ymax, xmax) window, context-padded the
        R-CNN way: box scaled so the warped crop keeps context_pad pixels
        of surround at crop scale, clipped to the image (detector.py
        crop:140-180 simplified to the clip path, as in the JAX package)."""
        y0, x0, y1, x1 = [int(round(v)) for v in window]
        if self.context_pad:
            cs = int(self.crop_dims[0])
            scale = cs / float(cs - 2 * self.context_pad)
            half_h = (y1 - y0) * scale / 2.0
            half_w = (x1 - x0) * scale / 2.0
            cy, cx = (y0 + y1) / 2.0, (x0 + x1) / 2.0
            y0, y1 = int(round(cy - half_h)), int(round(cy + half_h))
            x0, x1 = int(round(cx - half_w)), int(round(cx + half_w))
        h, w = im.shape[:2]
        y0 = max(0, y0)
        x0 = max(0, x0)
        y1 = min(h, max(y1, y0 + 1))
        x1 = min(w, max(x1, x0 + 1))
        return resize_image(im[y0:y1, x0:x1], self.crop_dims)

    def detect_windows(self, images_windows):
        """images_windows: iterable of (filename-or-HWC-array, windows).
        Returns [{filename, window, prediction}] (detector.py:56-99)."""
        crops, meta = [], []
        for image, windows in images_windows:
            if isinstance(image, str):
                im = load_image(image)
                fname = image
            else:
                im = np.asarray(image, np.float32)
                fname = None
            for window in windows:
                crops.append(self.transformer.preprocess(
                    self.input_name, self.crop(im, window)))
                meta.append((fname, window))
        preds = self._forward_batch(np.stack(crops))
        preds = preds.reshape(preds.shape[0], -1)
        return [
            {"filename": f, "window": w, "prediction": p}
            for (f, w), p in zip(meta, preds)
        ]
