"""Coordinate mapping between blobs of a net (FCN-style crop alignment; a
pure-Python copy of ``nct_tpu/nn/coord_map.py`` that reads the port's
``Net``).

Rebuilds code/python/caffe/coord_map.py: every spatially-resampling layer
induces an affine map from its TOP's spatial coordinates to its BOTTOM's,
``bottom_x = a * top_x + b`` with

  * Convolution / Pooling / Im2col:   a = stride,   b = (k - 1)/2 - pad
    (conv_params, coord_map.py:18-38)
  * Deconvolution:                    a = 1/stride, b = (pad - (k-1)/2)/s
    (the inverse map, coord_map.py:57-70)
  * Crop:                             a = 1,        b = -offset
  * elementwise / activation types:   identity     (coord_map.py:72-86)

``coord_map_from_to(net, from_blob, to_blob)`` composes the chain between
two blobs (here via each blob's absolute map from the net inputs — the
DAG walk of coord_map.py:115-170); ``crop_offsets`` turns it into the
integer offsets a Crop layer needs (crop(), coord_map.py:172-185)."""

from __future__ import annotations

from fractions import Fraction


# layers that pass coordinates through unchanged (coord_map.py PASS_THROUGH)
_PASS_THROUGH = {
    "ReLU", "PReLU", "ELU", "Sigmoid", "TanH", "AbsVal", "BNLL", "Power",
    "Exp", "Log", "Threshold", "Dropout", "LRN", "BatchNorm", "Scale",
    "Bias", "Eltwise", "Concat", "Split", "Softmax", "MVN", "Input",
}


def _first(v, default=None):
    if isinstance(v, list):
        return v[0] if v else default
    return v if v is not None else default


def layer_coord_map(cfg: dict) -> tuple[Fraction, Fraction] | None:
    """(a, b) mapping top coords -> bottom coords for one layer, identity
    (1, 0) for pass-through types, None for un-mappable types."""
    ltype = str(cfg.get("type"))
    if ltype in _PASS_THROUGH:
        return Fraction(1), Fraction(0)
    if ltype in ("Convolution", "Pooling", "Im2col", "Deconvolution"):
        key = ("pooling_param" if ltype == "Pooling"
               else "convolution_param")
        p = cfg.get(key, {}) or {}
        k = int(_first(p.get("kernel_size"), _first(p.get("kernel_h"), 1)))
        s = int(_first(p.get("stride"), _first(p.get("stride_h"), 1)))
        pad = int(_first(p.get("pad"), _first(p.get("pad_h"), 0)))
        a = Fraction(s)
        b = Fraction(k - 1, 2) - pad
        if ltype == "Deconvolution":
            return 1 / a, -b / a
        return a, b
    if ltype == "Crop":
        offset = int(_first(cfg.get("crop_param", {}).get("offset"), 0))
        return Fraction(1), Fraction(-offset)
    return None


def _compose(base, nxt):
    """bottom = a1*(mid) + b1, mid = a2*top + b2  =>  a1*a2, a1*b2 + b1."""
    (a1, b1), (a2, b2) = base, nxt
    return a1 * a2, a1 * b2 + b1


def absolute_maps(net) -> dict[str, tuple[Fraction, Fraction]]:
    """Map every blob to its (a, b) relative to the net inputs' coordinate
    frame (inputs are the identity)."""
    maps: dict[str, tuple[Fraction, Fraction]] = {
        str(i): (Fraction(1), Fraction(0)) for i in net.inputs
    }
    for cfg in net.layers:
        m = layer_coord_map(cfg)
        bottoms = cfg.get("bottom")
        bottoms = bottoms if isinstance(bottoms, list) else (
            [bottoms] if bottoms is not None else [])
        tops = cfg.get("top")
        tops = tops if isinstance(tops, list) else (
            [tops] if tops is not None else [])
        if m is None:
            continue
        base = None
        for b in map(str, bottoms):
            if b in maps:
                base = maps[b]
                break
        if base is None:
            base = (Fraction(1), Fraction(0))
        for t in map(str, tops):
            maps[t] = _compose(base, m)
    return maps


def coord_map_from_to(net, from_blob: str, to_blob: str):
    """(a, b) such that to_coord = a * from_coord + b
    (coord_map.py coord_map_from_to)."""
    maps = absolute_maps(net)
    if from_blob not in maps or to_blob not in maps:
        raise ValueError(
            f"no coord map for {from_blob!r} -> {to_blob!r}")
    af, bf = maps[from_blob]       # input = af * from + bf
    at, bt = maps[to_blob]         # input = at * to + bt
    # to = (af * from + bf - bt) / at
    return af / at, (bf - bt) / at


def crop_offsets(net, from_blob: str, to_blob: str) -> int:
    """Integer offset for a Crop layer aligning from_blob onto to_blob
    (coord_map.py crop:172-185: requires unit scale, integer,
    non-negative offset)."""
    a, b = coord_map_from_to(net, from_blob, to_blob)
    if a != 1:
        raise ValueError(f"scale mismatch ({a}) — cannot crop-align")
    if b.denominator != 1:
        raise ValueError(f"non-integer offset {b}")
    offset = -int(b)
    if offset < 0:
        raise ValueError(f"negative offset {offset}")
    return offset
