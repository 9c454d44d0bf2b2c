"""The port's JPEG decoder (``nct_tpu_torch.data.jpeg``, built from
``csrc/jpeg_decode.cpp``) bitwise against Pillow (the rule of
``nct_tpu.io.imread_bgr``), the JAX package's native libjpeg loader,
``cv2.imread`` and the digests of ``tests/fixtures/jpeg/digests.json``.

The fixtures come from ``tests/make_jpeg_fixtures.py``.  Should Pillow and
another reader ever differ, Pillow's decode is the one the port must give.
"""

import hashlib
import io
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from nct_tpu.data.loader import NativeLib, native_available
from nct_tpu_torch import _build
from nct_tpu_torch import cli as tcli
from nct_tpu_torch import io as tio
from nct_tpu_torch.data import PairLoader, jpeg
from nct_tpu_torch.nn import apps

# one thread each, as the other port tests hold torch: the test workers
# share the cores
torch.set_num_threads(1)
cv2.setNumThreads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "jpeg")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)


def pillow_bgr(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))[..., ::-1]


def _all_readers(path):
    """(port, Pillow, native, cv2) decodes of one file."""
    with open(path, "rb") as f:
        data = f.read()
    native = (NativeLib.imread_bgr(str(path)) if native_available()
              else None)
    return (tio.imread_bgr(str(path)), pillow_bgr(data), native,
            cv2.imread(str(path), cv2.IMREAD_COLOR))


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_bitwise_vs_pillow_native_cv2_and_digest(name):
    port, pil, native, cv = _all_readers(os.path.join(FIXTURES, name))
    assert port.dtype == np.uint8
    assert list(port.shape) == DIGESTS[name]["shape"]
    np.testing.assert_array_equal(port, pil)
    if native is not None:
        np.testing.assert_array_equal(port, native)
    np.testing.assert_array_equal(port, cv)
    assert hashlib.sha256(port.tobytes()).hexdigest() == \
        DIGESTS[name]["sha256"]


SAMPLING = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]


@pytest.mark.parametrize("case", range(16))
def test_random_encodings_bitwise(tmp_path, case):
    """Freshly encoded random files: white or blurred noise (the IDCT's
    range limit and every upsampling rule at odd sizes), any quality,
    progressive, restarts, optimised tables, grey."""
    rng = np.random.default_rng(case)
    h, w = (int(v) for v in rng.integers(1, 80, 2))
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if case % 2:
        img = cv2.GaussianBlur(img, (5, 5), 2)
    params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(5, 101)),
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, int(SAMPLING[case % 5]),
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(case % 3 == 0),
              cv2.IMWRITE_JPEG_RST_INTERVAL, int(case % 4),
              cv2.IMWRITE_JPEG_OPTIMIZE, int(case % 5 == 1)]
    if case % 7 == 6:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    path = tmp_path / "r.jpg"
    ok, enc = cv2.imencode(".jpg", img, params)
    path.write_bytes(enc.tobytes())
    port, pil, native, cv = _all_readers(path)
    np.testing.assert_array_equal(port, pil)
    if native is not None:
        np.testing.assert_array_equal(port, native)
    np.testing.assert_array_equal(port, cv)


@pytest.mark.parametrize("kw", [dict(keep_rgb=True),
                                dict(keep_rgb=True, progressive=True),
                                dict(subsampling="4:2:0", quality=100)],
                         ids=["adobe-rgb", "adobe-rgb-progressive", "q100"])
def test_pillow_encodings_bitwise(kw):
    """Adobe APP14 transform 0 (RGB, no JFIF) and quality 100."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (21, 19, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    np.testing.assert_array_equal(jpeg.decode(buf.getvalue()),
                                  pillow_bgr(buf.getvalue()))


def _restart_file(progressive: int) -> tuple[bytes, list[int]]:
    rng = np.random.default_rng(0)
    img = cv2.GaussianBlur(rng.integers(0, 256, (64, 96, 3)).astype(
        np.uint8), (5, 5), 2)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                                         cv2.IMWRITE_JPEG_PROGRESSIVE,
                                         progressive])
    b = enc.tobytes()
    rst = [i for i in range(len(b) - 1)
           if b[i] == 0xFF and 0xD0 <= b[i + 1] <= 0xD7]
    return b, rst


@pytest.mark.parametrize("progressive", [0, 1], ids=["baseline",
                                                     "progressive"])
@pytest.mark.parametrize("damage", ["missing", "skip3", "previous", "next",
                                    "garbage"])
def test_damaged_restart_markers_as_pillow(progressive, damage):
    """libjpeg resynchronises after a lost or renumbered RSTn; the port's
    decode follows it pixel for pixel."""
    b, rst = _restart_file(progressive)
    for i in (rst[1], rst[len(rst) // 2]):
        num = b[i + 1] - 0xD0
        bad = {"missing": b[:i] + b[i + 2:],
               "skip3": b[:i + 1] + bytes([0xD0 + (num + 3) % 8]) + b[i + 2:],
               "previous": b[:i + 1] + bytes([0xD0 + (num - 1) % 8])
               + b[i + 2:],
               "next": b[:i + 1] + bytes([0xD0 + (num + 1) % 8]) + b[i + 2:],
               "garbage": b[:i] + b"\x12\x34" + b[i:]}[damage]
        np.testing.assert_array_equal(jpeg.decode(bad), pillow_bgr(bad))


def _sof_offset(b: bytes, markers=(0xC0, 0xC1, 0xC2)) -> int:
    i = 2
    while True:
        assert b[i] == 0xFF
        if b[i + 1] in markers:
            return i
        i += 2 + struct.unpack(">H", b[i + 2:i + 4])[0]


def _baseline() -> bytes:
    img = np.random.default_rng(1).integers(0, 256, (16, 16, 3))
    ok, enc = cv2.imencode(".jpg", img.astype(np.uint8))
    return enc.tobytes()


def _with_sof(b: bytes, marker: int) -> bytes:
    i = _sof_offset(b)
    return b[:i + 1] + bytes([marker]) + b[i + 2:]


def _cmyk() -> bytes:
    buf = io.BytesIO()
    Image.new("CMYK", (8, 8), (10, 20, 30, 40)).save(buf, "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("make,match", [
    (_cmyk, "CMYK"),
    (lambda: _with_sof(_baseline(), 0xC9), "arithmetic"),
    (lambda: _with_sof(_baseline(), 0xCA), "arithmetic"),
    (lambda: _with_sof(_baseline(), 0xC3), "lossless"),
    (lambda: (lambda b, i: b[:i + 4] + bytes([12]) + b[i + 5:])(
        _baseline(), _sof_offset(_baseline())), "12-bit"),
], ids=["cmyk", "arith-sof9", "arith-sof10", "lossless-sof3", "12-bit"])
def test_unsupported_features_raise_oserror_naming_them(tmp_path, make,
                                                        match):
    path = tmp_path / "u.jpg"
    path.write_bytes(make())
    with pytest.raises(OSError, match=match):
        tio.imread_bgr(str(path))


@pytest.mark.parametrize("progressive", [0, 1], ids=["baseline",
                                                     "progressive"])
def test_truncated_files_raise_as_pillow(progressive):
    """Cut inside the headers or the scans: OSError, as Pillow's
    truncated-image error; a cut at the very end: whatever Pillow does."""
    rng = np.random.default_rng(2)
    img = cv2.GaussianBlur(rng.integers(0, 256, (40, 56, 3)).astype(
        np.uint8), (5, 5), 2)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                         progressive])
    b = enc.tobytes()
    for cut in (10, 100, 300, len(b) // 2, len(b) - 12):
        with pytest.raises(OSError, match="truncated"):
            jpeg.decode(b[:cut])
        with pytest.raises(OSError):
            pillow_bgr(b[:cut])
    for cut in (len(b) - 2, len(b) - 1):
        try:
            want = pillow_bgr(b[:cut])
        except OSError:
            with pytest.raises(OSError, match="truncated"):
                jpeg.decode(b[:cut])
        else:
            np.testing.assert_array_equal(jpeg.decode(b[:cut]), want)


@pytest.fixture()
def no_pillow(monkeypatch):
    """``import PIL`` raises ImportError while the test runs."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


def test_io_and_load_image_read_jpeg_without_pillow(no_pillow):
    path = os.path.join(FIXTURES, "s420.jpg")
    got = tio.imread_bgr(path)
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        DIGESTS["s420.jpg"]["sha256"]
    rgb = apps.load_image(path)
    np.testing.assert_array_equal(rgb, got[..., ::-1].astype(np.float32)
                                  / 255.0)


def test_cli_reads_a_jpeg_pair_without_pillow(tmp_path, no_pillow):
    """The CLI on a JPEG pair (one baseline, one progressive) writes what
    it writes for the same pixels given as PNG."""
    rng = np.random.default_rng(5)
    src_jpg, src_png = tmp_path / "jpg_in", tmp_path / "png_in"
    src_jpg.mkdir()
    src_png.mkdir()
    for name, (h, w), prog in (("c0", (36, 44), 0), ("s0", (40, 46), 1)):
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3)).astype(
            np.uint8), (5, 5), 2)
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                             prog])
        (src_jpg / f"{name}.jpg").write_bytes(enc.tobytes())
        tio.imwrite_bgr(str(src_png / f"{name}.png"),
                        jpeg.decode(enc.tobytes()))
    (src_jpg / "pairs.txt").write_text("c0.jpg s0.jpg 2.0\n")
    (src_png / "pairs.txt").write_text("c0.png s0.png 2.0\n")
    for src, out in ((src_jpg, "jpg_out"), (src_png, "png_out")):
        assert tcli.main(["-i", str(src), "-o", str(tmp_path / out),
                          "--device", "cpu", "--seed", "4"]) == 0
    np.testing.assert_array_equal(
        tio.imread_bgr(str(tmp_path / "jpg_out" / "c0_s0_2.00.png")),
        tio.imread_bgr(str(tmp_path / "png_out" / "c0_s0_2.00.png")))


def test_failed_build_raises_runtime_error_not_a_skipped_pair(
        tmp_path, monkeypatch):
    """A decoder that cannot be built is an error of the program, not an
    unreadable pair: PairLoader passes the RuntimeError on."""
    def no_compiler():
        raise RuntimeError("no host C++ compiler")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_host_cxx", no_compiler)
    _build.load.cache_clear()
    try:
        path = os.path.join(FIXTURES, "s444.jpg")
        with pytest.raises(RuntimeError, match="compiler"):
            tio.imread_bgr(path)
        loader = PairLoader([(path, path)], 64, threads=1)
        try:
            with pytest.raises(RuntimeError):
                list(loader)
        finally:
            loader.close()
    finally:
        _build.load.cache_clear()
