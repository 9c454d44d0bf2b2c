"""Offline caffemodel -> npz weight conversion, no protobuf dependency (a
numpy-only copy of ``nct_tpu/models/caffe_io.py``).

The reference loads VGG_ILSVRC_19_layers.caffemodel through Caffe's protobuf
machinery (net.cpp:760-824 CopyTrainedLayersFromBinaryProto).  This is a
protobuf *wire format* reader that understands just enough of caffe.proto's
NetParameter to pull conv weights/biases out of both the V1 (``layers``
field 2, used by the original VGG release) and modern (``layer`` field 100)
encodings, then lays them out HWIO: the npz format both packages'
``vgg19.load_params`` read.

Run once offline:
    python -m nct_tpu_torch.tools.convert_vgg19 model.caffemodel out.npz
"""

from __future__ import annotations

import struct

import numpy as np

# protobuf wire types
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over one serialized message.

    LEN fields yield memoryview payloads; VARINT/I32/I64 yield ints.
    """
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _I64:
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wire == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == _I32:
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_blob(buf: memoryview) -> np.ndarray:
    """BlobProto: num=1, channels=2, height=3, width=4, data=5 (packed float),
    shape=7 (BlobShape{dim=1 repeated int64}), double_data=9."""
    dims_old = {}
    shape_dims: list[int] = []
    chunks: list[np.ndarray] = []
    for field, wire, val in iter_fields(buf):
        if field in (1, 2, 3, 4) and wire == _VARINT:
            dims_old[field] = val
        elif field == 5:
            if wire == _LEN:
                chunks.append(np.frombuffer(bytes(val), dtype="<f4"))
            elif wire == _I32:
                chunks.append(np.asarray(
                    [struct.unpack("<f", val.to_bytes(4, "little"))[0]],
                    dtype=np.float32))
        elif field == 9:
            if wire == _LEN:
                chunks.append(
                    np.frombuffer(bytes(val), dtype="<f8").astype(np.float32))
        elif field == 7 and wire == _LEN:
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1:
                    if w2 == _VARINT:
                        shape_dims.append(v2)
                    elif w2 == _LEN:  # packed
                        p = 0
                        while p < len(v2):
                            d, p = _read_varint(v2, p)
                            shape_dims.append(d)
    data = np.concatenate(chunks) if chunks else np.empty((0,), np.float32)
    if shape_dims:
        return data.reshape(shape_dims)
    if dims_old:
        shape = [dims_old.get(i, 1) for i in (1, 2, 3, 4)]
        return data.reshape(shape)
    return data


def _parse_layer(buf: memoryview, v1: bool):
    """Extract (name, blobs) from a V1LayerParameter (name=4, blobs=6) or
    LayerParameter (name=1, blobs=7)."""
    name_field = 4 if v1 else 1
    blob_field = 6 if v1 else 7
    name = None
    blobs: list[np.ndarray] = []
    for field, wire, val in iter_fields(buf):
        if field == name_field and wire == _LEN:
            name = bytes(val).decode("utf-8", "replace")
        elif field == blob_field and wire == _LEN:
            blobs.append(_parse_blob(val))
    return name, blobs


def read_caffemodel(path: str) -> dict[str, list[np.ndarray]]:
    """Parse a .caffemodel into {layer_name: [blob arrays]}."""
    with open(path, "rb") as f:
        raw = memoryview(f.read())
    layers: dict[str, list[np.ndarray]] = {}
    for field, wire, val in iter_fields(raw):
        if wire != _LEN:
            continue
        if field == 2:       # repeated V1LayerParameter layers
            name, blobs = _parse_layer(val, v1=True)
        elif field == 100:   # repeated LayerParameter layer
            name, blobs = _parse_layer(val, v1=False)
        else:
            continue
        if name and blobs:
            layers[name] = blobs
    return layers


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def array_to_blobproto(arr: np.ndarray, diff: np.ndarray | None = None
                       ) -> bytes:
    """Serialize an ndarray as BlobProto wire bytes (the pycaffe
    io.array_to_blobproto analogue: shape field 7 + packed float data 5,
    optional diff 6)."""
    arr = np.asarray(arr, np.float32)
    shape_payload = b"".join(
        b"\x08" + _encode_varint(int(d)) for d in arr.shape)
    out = bytearray()
    out += b"\x3a" + _encode_varint(len(shape_payload)) + shape_payload
    data = arr.reshape(-1).astype("<f4").tobytes()
    out += b"\x2a" + _encode_varint(len(data)) + data     # field 5 packed
    if diff is not None:
        d = np.asarray(diff, np.float32).reshape(-1).astype("<f4").tobytes()
        out += b"\x32" + _encode_varint(len(d)) + d       # field 6 packed
    return bytes(out)


def write_caffemodel(path: str,
                     layers: dict[str, list[np.ndarray]]) -> None:
    """Serialize {layer_name: [blob arrays]} as a .caffemodel
    (NetParameter with ``layer`` LayerParameter messages: name=1,
    blobs=7 — the wire format net.cpp:760-824 loads and read_caffemodel
    parses).  Used to export nets for Caffe interop and to rehearse the
    weight path end to end without the pretrained download."""
    out = bytearray()
    for name, blobs in layers.items():
        body = bytearray()
        nb = name.encode("utf-8")
        body += b"\x0a" + _encode_varint(len(nb)) + nb          # name=1
        for arr in blobs:
            bp = array_to_blobproto(arr)
            body += b"\x3a" + _encode_varint(len(bp)) + bp      # blobs=7
        # NetParameter.layer = field 100, wire type LEN
        out += _encode_varint((100 << 3) | 2)
        out += _encode_varint(len(body)) + bytes(body)
    with open(path, "wb") as f:
        f.write(bytes(out))


def blobproto_to_array(payload: bytes, return_diff: bool = False
                       ) -> np.ndarray:
    """BlobProto wire bytes -> ndarray (pycaffe io.blobproto_to_array);
    handles both the shape field and legacy num/channels/height/width."""
    if not return_diff:
        return _parse_blob(memoryview(payload))
    shape = _parse_blob(memoryview(payload)).shape
    chunks = []
    for field, wire, val in iter_fields(memoryview(payload)):
        if field == 6 and wire == _LEN:
            chunks.append(np.frombuffer(bytes(val), dtype="<f4"))
    diff = (np.concatenate(chunks) if chunks
            else np.zeros(int(np.prod(shape)), np.float32))
    return diff.reshape(shape)


def caffemodel_to_npz(caffemodel_path: str, npz_path: str) -> list[str]:
    """Convert conv weights to the HWIO npz that ``vgg19.load_params``
    reads.

    Caffe stores conv filters (out, in, kh, kw) cross-correlation; the npz
    holds (kh, kw, in, out): transpose(2, 3, 1, 0), no kernel flip.
    Returns the list of converted layer names.
    """
    from nct_tpu_torch.models.vgg19 import VGG19_CONV_LAYERS

    layers = read_caffemodel(caffemodel_path)
    out: dict[str, np.ndarray] = {}
    converted = []
    for name, out_c in VGG19_CONV_LAYERS:
        if name not in layers:
            continue
        blobs = layers[name]
        w = blobs[0]
        if w.ndim != 4:
            raise ValueError(f"{name}: unexpected weight rank {w.shape}")
        if w.shape[0] != out_c:
            raise ValueError(f"{name}: expected {out_c} filters, got {w.shape}")
        out[f"{name}_w"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        out[f"{name}_b"] = (
            blobs[1].reshape(-1).astype(np.float32)
            if len(blobs) > 1 else np.zeros((out_c,), np.float32)
        )
        converted.append(name)
    if not converted:
        raise ValueError("no VGG-19 conv layers found in caffemodel")
    np.savez(npz_path, **out)
    return converted
