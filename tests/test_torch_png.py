"""The port's PNG codec (nct_tpu_torch.data.png) against the JAX package's
native libpng decoder, against Pillow, and against the normalisation rules
computed here from the samples each test file is written from.

Every test PNG is written here with zlib, at every colour type and bit
depth, with chosen row filters, so each filter's decoding is exercised.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from nct_tpu.data.loader import NativeLib, native_available
from nct_tpu_torch import io as tio
from nct_tpu_torch.data import png

H, W = 13, 17
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _filter_row(kind, cur, prev, bpp):
    """The PNG encoder's filter of one row of bytes (int arrays)."""
    out = np.empty_like(cur)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (cur[i] - pred) % 256
    return out


def _pack(samples, depth):
    """[H, W*ch] samples -> [H, rowbytes] bytes, big-endian / MSB first."""
    if depth == 16:
        return np.stack([samples >> 8, samples & 0xFF], -1).reshape(
            samples.shape[0], -1)
    if depth == 8:
        return samples
    per = 8 // depth
    h, n = samples.shape
    padded = np.zeros((h, -(-n // per) * per), np.int64)
    padded[:, :n] = samples
    g = padded.reshape(h, -1, per)
    shifts = depth * np.arange(per - 1, -1, -1)
    return (g << shifts).sum(-1)


def _chunk(ctype, payload):
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def write_png(path, samples, color, depth, filters, palette=None, trns=None,
              interlace=0):
    """samples [H, W, ch] ints; filters: one filter type per row."""
    h, w, ch = samples.shape
    raw = _pack(samples.reshape(h, w * ch).astype(np.int64), depth)
    bpp = max(1, ch * depth // 8)
    prev = np.zeros(raw.shape[1], np.int64)
    body = bytearray()
    for y in range(h):
        body.append(filters[y])
        body += bytes(_filter_row(filters[y], raw[y], prev, bpp)
                      .astype(np.uint8))
        prev = raw[y]
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", bytes(palette.astype(np.uint8).reshape(-1)))
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    # two IDAT chunks: the stream may be split anywhere
    z = zlib.compress(bytes(body))
    out += _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    out += _chunk(b"IEND", b"")
    path.write_bytes(out)


def expected_bgr(samples, color, depth, palette=None):
    """The normalisation rules, from the samples."""
    s = samples.astype(np.int64)
    if depth == 16:
        s = s >> 8
    if color == 3:
        rgb = palette[s[..., 0]]
    else:
        if color in (0, 4):
            if depth < 8:
                s = s * (255 // ((1 << depth) - 1))
            s = np.repeat(s[..., :1], 3, -1)
        rgb = s[..., :3]
    return rgb[..., ::-1].astype(np.uint8)


# (colour type, bit depth, palette entries or None, with tRNS)
CASES = [
    (0, 1, None, False), (0, 2, None, False), (0, 4, None, False),
    (0, 8, None, False), (0, 16, None, False), (0, 8, None, True),
    (4, 8, None, False), (4, 16, None, False),
    (2, 8, None, False), (2, 16, None, False), (2, 8, None, True),
    (6, 8, None, False), (6, 16, None, False),
    (3, 8, 200, False), (3, 8, 200, True), (3, 4, 16, True), (3, 2, 4, False),
    (3, 1, 2, True),
]
# cases Pillow normalises the same way (it keeps 16-bit samples otherwise)
PILLOW_AGREES = {c for c in CASES if c[1] <= 8}


def _case_file(tmp_path, rng, case, filters):
    color, depth, n_pal, trns = case
    ch = CHANNELS[color]
    top = n_pal if color == 3 else 1 << depth
    samples = rng.integers(0, top, (H, W, ch))
    palette = (rng.integers(0, 256, (n_pal, 3)) if color == 3 else None)
    trns_bytes = None
    if trns:
        trns_bytes = (bytes(rng.integers(0, 256, n_pal).astype(np.uint8))
                      if color == 3 else
                      struct.pack(">H", 1) if color == 0 else
                      struct.pack(">HHH", 1, 2, 3))
    path = tmp_path / f"c{color}_d{depth}_{n_pal}_{int(trns)}.png"
    write_png(path, samples, color, depth, filters, palette, trns_bytes)
    return path, expected_bgr(samples, color, depth, palette)


def _mixed_filters(rng):
    return list(rng.integers(0, 5, H))


@pytest.fixture()
def native():
    """The JAX package's libpng decoder (built from native/ on first use)."""
    if not native_available():
        pytest.skip("the native libpng loader does not build here")
    return NativeLib


@pytest.mark.parametrize("case", CASES, ids=lambda c: "c{}-d{}-p{}-t{}".format(
    *c))
def test_decoder_bitwise_vs_native_and_rules(tmp_path, native, case):
    rng = np.random.default_rng(CASES.index(case))
    path, want = _case_file(tmp_path, rng, case, _mixed_filters(rng))
    got = tio.imread_bgr(str(path))
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, native.imread_bgr(str(path)))
    np.testing.assert_array_equal(got, want)
    if case in PILLOW_AGREES:
        with Image.open(path) as im:
            pil = np.asarray(im.convert("RGB"))[..., ::-1]
        np.testing.assert_array_equal(got, pil)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("case", [(2, 8, None, False), (0, 4, None, False),
                                  (6, 16, None, False)],
                         ids=["rgb8", "gray4", "rgba16"])
def test_each_filter_type(tmp_path, native, kind, case):
    rng = np.random.default_rng(kind)
    path, want = _case_file(tmp_path, rng, case, [kind] * H)
    got = tio.imread_bgr(str(path))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, native.imread_bgr(str(path)))


@pytest.mark.parametrize("hw", [(1, 1), (13, 17), (64, 3)])
def test_encoder_round_trip_and_pillow_reads_it(tmp_path, native, hw):
    rng = np.random.default_rng(hw[0])
    img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    path = tmp_path / "out.png"
    tio.imwrite_bgr(str(path), img)
    np.testing.assert_array_equal(tio.imread_bgr(str(path)), img)
    np.testing.assert_array_equal(png.decode(png.encode(img)), img)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im)[..., ::-1], img)
    np.testing.assert_array_equal(native.imread_bgr(str(path)), img)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def write_adam7(path, samples, color, depth, rng, palette=None):
    """An interlaced PNG: each non-empty Adam7 pass filtered on its own
    (random filter types, a zero row above its first row)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    body = bytearray()
    for x0, y0, dx, dy in ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        ph, pw = sub.shape[:2]
        raw = _pack(sub.reshape(ph, pw * ch).astype(np.int64), depth)
        prev = np.zeros(raw.shape[1], np.int64)
        for y in range(ph):
            kind = int(rng.integers(0, 5))
            body.append(kind)
            body += bytes(_filter_row(kind, raw[y], prev, bpp)
                          .astype(np.uint8))
            prev = raw[y]
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, 1))
    if palette is not None:
        out += _chunk(b"PLTE", bytes(palette.astype(np.uint8).reshape(-1)))
    out += _chunk(b"IDAT", zlib.compress(bytes(body))) + _chunk(b"IEND", b"")
    path.write_bytes(out)


ADAM7_CASES = [(0, 1), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 8),
               (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (8, 8), (20, 30)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("case", ADAM7_CASES,
                         ids=lambda c: "c{}-d{}".format(*c))
def test_adam7_bitwise_vs_pillow(tmp_path, case, hw):
    """Interlaced files decode as Pillow decodes them (1x1 and 3x5 leave
    passes empty).  Pillow keeps 16-bit gray as 16-bit samples, so that
    case is held to the rules and to the same samples written without
    interlacing instead."""
    color, depth = case
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    ch = CHANNELS[color]
    n_pal = 1 << depth if color == 3 else None
    samples = rng.integers(0, n_pal or 1 << depth, hw + (ch,))
    palette = rng.integers(0, 256, (n_pal, 3)) if color == 3 else None
    path = tmp_path / "adam7.png"
    write_adam7(path, samples, color, depth, rng, palette)
    got = tio.imread_bgr(str(path))
    assert got.dtype == np.uint8 and got.shape == hw + (3,)
    np.testing.assert_array_equal(got, expected_bgr(samples, color, depth,
                                                    palette))
    if (color, depth) == (0, 16):
        flat = tmp_path / "flat.png"
        write_png(flat, samples, color, depth, [0] * hw[0])
        np.testing.assert_array_equal(got, tio.imread_bgr(str(flat)))
        return
    with Image.open(path) as im:
        pil = np.asarray(im.convert("RGB"))[..., ::-1]
    np.testing.assert_array_equal(got, pil)


@pytest.mark.parametrize("mutate,match", [
    (lambda b: b[:19] + bytes([b[19] ^ 1]) + b[20:], "CRC"),
    (lambda b: b[:-12], "IEND"),
    (lambda b: b"GIF89a" + b[6:], None),
], ids=["crc", "truncated", "not-png"])
def test_bad_files_raise_oserror(tmp_path, mutate, match):
    img = np.zeros((4, 5, 3), np.uint8)
    data = mutate(png.encode(img))
    with pytest.raises(OSError, match=match):
        png.decode(data)


def test_non_png_without_pillow_names_the_format(tmp_path, monkeypatch):
    path = tmp_path / "x.gif"
    path.write_bytes(b"GIF89a" + b"\0" * 16)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(OSError, match="GIF files need Pillow"):
        tio.imread_bgr(str(path))
    # JPEG goes to the port's own decoder, which names what is wrong
    path = tmp_path / "x.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 16)
    with pytest.raises(OSError, match="JPEG: "):
        tio.imread_bgr(str(path))
    with pytest.raises(OSError, match="BMP files need Pillow"):
        tio.imwrite_bgr(str(tmp_path / "y.bmp"), np.zeros((2, 2, 3), np.uint8))
    # PNG needs nothing
    tio.imwrite_bgr(str(tmp_path / "z.png"), np.zeros((2, 2, 3), np.uint8))
    assert tio.imread_bgr(str(tmp_path / "z.png")).shape == (2, 2, 3)


def test_large_paeth_file_decodes_quickly(tmp_path):
    """One Paeth row sends the whole file down the anti-diagonal path; a
    600x960 RGB file still decodes in seconds, not minutes."""
    import time

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (600, 960, 3)).astype(np.uint8)
    rgb = img[..., ::-1].reshape(600, -1).astype(np.int64)
    body = np.empty((600, 1 + rgb.shape[1]), np.uint8)
    body[0, 0], body[0, 1:] = 0, rgb[0]                     # None
    body[1:, 0] = 2                                          # Up
    body[1:, 1:] = (rgb[1:] - rgb[:-1]) % 256
    body[-1, 0], body[-1, 1:] = 4, _filter_row(4, rgb[-1], rgb[-2], 3)
    data = (png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 960, 600, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(body.tobytes()))
        + _chunk(b"IEND", b""))
    t0 = time.perf_counter()
    got = png.decode(data)
    seconds = time.perf_counter() - t0
    np.testing.assert_array_equal(got, img)
    assert seconds < 5.0, seconds
