"""PNG decoder and encoder on ``zlib`` and numpy (no Pillow, no libpng).

Decoding normalises every PNG to uint8 BGR [H, W, 3] the
way the JAX package's native loader does (``native/dataloader.cpp``
``decode_png``): palette to RGB; gray at 1, 2 and 4 bits scaled to 8;
tRNS and alpha dropped, not composited; 16-bit samples reduced to their
high byte; gray replicated to RGB; channels reversed to BGR.  All five
row filters are undone: rows whose filters depend only on their own row
or the row above (None, Sub, Up) one row at a time, and files with
Average or Paeth rows along anti-diagonals of pixels, each of which
depends only on the diagonal before it.  An interlaced (Adam7) file is
seven such filtered sub-images, one per pass, each with its own filter
bytes and its own packed rows; each pass is decoded alone and scattered
into the full image.  Anything that is not a valid PNG raises ``OSError``
naming what it is.

Encoding writes 8-bit RGB with the Sub filter on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type -> (samples per pixel, allowed bit depths)
_COLOR_TYPES = {
    0: (1, (1, 2, 4, 8, 16)),     # gray
    2: (3, (8, 16)),              # RGB
    3: (1, (1, 2, 4, 8)),         # palette
    4: (2, (8, 16)),              # gray + alpha
    6: (4, (8, 16)),              # RGBA
}


def _chunks(data: bytes, path: str):
    """Yield (type, payload) of each chunk, checking lengths and CRCs."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise OSError(f"{path}: PNG chunk {ctype!r} runs past the end "
                          f"of the file")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise OSError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4
    raise OSError(f"{path}: PNG file ends without an IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, bpp: int, path: str) -> np.ndarray:
    """Undo the row filters: rows [H, 1 + rowbytes] uint8 (filter byte
    first) -> [H, rowbytes] uint8."""
    ftype = rows[:, 0]
    filt = rows[:, 1:]
    if int(ftype.max(initial=0)) > 4:
        raise OSError(f"{path}: PNG row filter type {int(ftype.max())} "
                      f"is not one of the five")
    h, rowbytes = filt.shape
    out = np.empty_like(filt)
    if not np.isin(ftype, (3, 4)).any():
        prev = np.zeros(rowbytes, np.uint8)
        for y in range(h):
            f, cur = ftype[y], filt[y]
            if f == 1:
                cur = np.cumsum(cur.reshape(-1, bpp), axis=0,
                                dtype=np.uint8).reshape(-1)
            elif f == 2:
                cur = cur + prev
            out[y] = cur
            prev = out[y]
        return out
    # Average / Paeth: pixel (y, x) needs (y, x-1), (y-1, x) and
    # (y-1, x-1), so every anti-diagonal y + x = t depends only on the
    # diagonals before it.  A zero row and column pad the borders.
    ncol = rowbytes // bpp
    f3 = filt.reshape(h, ncol, bpp).astype(np.int16)
    rec = np.zeros((h + 1, ncol + 1, bpp), np.int16)
    kind = ftype.astype(np.int16)
    for t in range(h + ncol - 1):
        ys = np.arange(max(0, t - ncol + 1), min(h, t + 1))
        xs = t - ys
        a = rec[ys + 1, xs]
        b = rec[ys, xs + 1]
        c = rec[ys, xs]
        k = kind[ys][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, _paeth(a, b, c), 0))))
        rec[ys + 1, xs + 1] = (f3[ys, xs] + pred) & 0xFF
    out[:] = rec[1:, 1:].reshape(h, rowbytes)
    return out


def _unpack(raw: np.ndarray, width: int, depth: int) -> np.ndarray:
    """[H, rowbytes] packed samples of ``depth`` < 8 bits -> [H, width]."""
    bits = np.unpackbits(raw, axis=1)
    per = bits.shape[1] // depth
    bits = bits[:, :per * depth].reshape(raw.shape[0], per, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[:, :width]


# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _sub_image(raw: bytes, pos: int, width: int, height: int, channels: int,
               depth: int, path: str) -> tuple[np.ndarray, int]:
    """Unfilter one filtered (sub-)image of ``height`` rows starting at
    byte ``pos`` of the inflated data -> ([height, width * channels] uint8
    samples, 16-bit ones reduced to their high byte and packed ones
    unpacked but not scaled; the byte after its last row)."""
    rowbytes = (width * channels * depth + 7) // 8
    end = pos + height * (rowbytes + 1)
    if len(raw) < end:
        raise OSError(f"{path}: PNG image data is short: {len(raw)} bytes "
                      f"where {end} are needed")
    rows = np.frombuffer(raw, np.uint8, height * (rowbytes + 1), pos)
    bpp = max(1, channels * depth // 8)
    px = _unfilter(rows.reshape(height, rowbytes + 1), bpp, path)
    if depth == 16:
        px = px.reshape(height, width * channels, 2)[..., 0]   # high byte
    elif depth < 8:
        px = _unpack(px, width * channels, depth)
    return px, end


def decode(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG file bytes -> uint8 BGR [H, W, 3] (see the module docstring)."""
    if not data.startswith(SIGNATURE):
        raise OSError(f"{path}: not a PNG file (bad signature)")
    header = palette = None
    idat = []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            if len(payload) != 13:
                raise OSError(f"{path}: PNG IHDR of {len(payload)} bytes")
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            if len(payload) % 3:
                raise OSError(f"{path}: PNG PLTE of {len(payload)} bytes")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise OSError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, color, compression, filtering, interlace = header
    if color not in _COLOR_TYPES or depth not in _COLOR_TYPES[color][1]:
        raise OSError(f"{path}: PNG colour type {color} at bit depth {depth} "
                      f"is not a valid combination")
    if interlace not in (0, 1):
        raise OSError(f"{path}: PNG interlace method {interlace}; only 0 "
                      f"(none) and 1 (Adam7) exist")
    if compression or filtering:
        raise OSError(f"{path}: PNG compression method {compression} / filter "
                      f"method {filtering}; only method 0 of each exists")
    if width == 0 or height == 0:
        raise OSError(f"{path}: PNG of size {width}x{height}")
    if color == 3 and palette is None:
        raise OSError(f"{path}: palette PNG without a PLTE chunk")
    channels = _COLOR_TYPES[color][0]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise OSError(f"{path}: PNG image data does not inflate ({e})") from e
    if not interlace:
        px, _ = _sub_image(raw, 0, width, height, channels, depth, path)
    else:
        px = np.empty((height, width * channels), np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw = -(-(width - x0) // dx) if width > x0 else 0
            ph = -(-(height - y0) // dy) if height > y0 else 0
            if pw == 0 or ph == 0:
                continue        # an empty pass has no bytes, not even filters
            sub, pos = _sub_image(raw, pos, pw, ph, channels, depth, path)
            px.reshape(height, width, channels)[y0::dy, x0::dx] = \
                sub.reshape(ph, pw, channels)
    if color == 0 and depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    px = px.reshape(height, width, channels)
    if color == 3:
        table = np.zeros((256, 3), np.uint8)    # indices past PLTE: black
        table[:len(palette)] = palette[:256]
        rgb = table[px[..., 0]]
    elif color in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=-1)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def encode(bgr: np.ndarray) -> bytes:
    """uint8 BGR [H, W, 3] -> PNG bytes (8-bit RGB, Sub filter)."""
    img = np.asarray(bgr)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode wants uint8 [H, W, 3], got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    rgb = np.ascontiguousarray(img[..., ::-1]).reshape(h, w * 3)
    rows = np.empty((h, 1 + w * 3), np.uint8)
    rows[:, 0] = 1                                  # Sub
    rows[:, 1:] = rgb
    rows[:, 4:] -= rgb[:, :-3]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write(path: str, bgr: np.ndarray) -> None:
    """Write uint8 BGR [H, W, 3] as an 8-bit RGB PNG file."""
    data = encode(bgr)
    with open(path, "wb") as f:
        f.write(data)
