"""JPEG decoder without Pillow or libjpeg: ``csrc/jpeg_decode.cpp``, a host
C++ library built from the repo at first use and called through ctypes.

Its pixels are bitwise libjpeg's default decode, which is what Pillow,
OpenCV and the JAX package's native loader return (islow IDCT, fancy
upsampling, libjpeg's YCbCr tables); see the source for the coverage.
Output is uint8 BGR [H, W, 3], grey replicated to three channels, with no
EXIF rotation (the JAX package's Pillow path applies none).  A file the
decoder cannot read raises ``OSError`` naming why; a decoder that does not
build or load raises ``RuntimeError``, so a caller that skips unreadable
files does not skip every JPEG.
"""

from __future__ import annotations

import ctypes

import numpy as np

from nct_tpu_torch import _build

SOI = b"\xff\xd8"


def _lib() -> ctypes.CDLL:
    lib = _build.load("jpeg_decode")
    if not getattr(lib, "_nct_typed", False):
        lib.nct_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_char_p,
            ctypes.c_size_t]
        lib.nct_jpeg_decode.restype = ctypes.c_int
        lib.nct_jpeg_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.nct_jpeg_free.restype = None
        lib._nct_typed = True
    return lib


def decode(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """JPEG file bytes -> uint8 BGR [H, W, 3]."""
    lib = _lib()
    h, w = ctypes.c_int(), ctypes.c_int()
    out = ctypes.POINTER(ctypes.c_uint8)()
    err = ctypes.create_string_buffer(256)
    if lib.nct_jpeg_decode(data, len(data), ctypes.byref(h), ctypes.byref(w),
                           ctypes.byref(out), err, len(err)):
        raise OSError(f"{path}: JPEG: {err.value.decode()}")
    try:
        n = h.value * w.value * 3
        img = np.ctypeslib.as_array(out, (n,)).copy()
    finally:
        lib.nct_jpeg_free(out)
    return img.reshape(h.value, w.value, 3)


def read(path: str) -> np.ndarray:
    """Decode a JPEG file."""
    with open(path, "rb") as f:
        return decode(f.read(), path)
