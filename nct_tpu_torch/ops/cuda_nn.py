"""Exact bidirectional patch NN search on the card (counterpart of
``nct_tpu/ops/pallas_nn.py::exact_nn_pallas_bidir``).

``exact_nn_bidir`` launches the hand-written CUDA kernel
``csrc/nn_bidir.cu`` for CUDA tensors and runs the plain PyTorch version
(``exact_nn.exact_nn_bidir_plain``) for CPU tensors.  There is no switch
and no fallback: on a CUDA tensor a failed build or launch raises.

The kernel returns, per row and per column, a 64-bit key
``ordered_bits(d) << 32 | index`` reduced with atomicMin (see the source
note in ``nn_bidir.cu``); ``decode_keys`` turns keys back into
(distance, index).  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nct_tpu_torch import _build
from nct_tpu_torch.ops.exact_nn import (
    exact_nn_bidir_plain, prep_tables, unpack_nnf,
)

LAUNCHES = 0

TILE = 128   # rows of A per block and columns of B per tile (nn_bidir.cu TA/TB)
DEPTH = 32   # K*C must be a multiple of the shared-memory stage depth (TK)
_BLOCKS_PER_SM = 8   # B sweep split so the grid holds ~8 blocks per SM


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("nn_bidir")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nn_bidir_launch.argtypes = [p, p, p, p, i, i, i, i, p, p, p]
    lib.nn_bidir_launch.restype = i
    lib.nn_bidir_error_string.argtypes = [i]
    lib.nn_bidir_error_string.restype = ctypes.c_char_p
    lib.nn_bidir_tile_rows.restype = i
    lib.nn_bidir_tile_depth.restype = i
    if (lib.nn_bidir_tile_rows(), lib.nn_bidir_tile_depth()) != (TILE, DEPTH):
        raise RuntimeError("nn_bidir.cu tile geometry differs from cuda_nn.py")
    return lib


def encode_keys(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(f32 distance, index) -> int64 holding the kernel's uint64 key."""
    d = torch.where(d == 0, torch.zeros_like(d), d)          # -0.0 -> +0.0
    u = d.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(u >= 2 ** 31, ~u & 0xFFFFFFFF, u | 0x80000000)
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)            # as signed hi word
    return u * 2 ** 32 + idx.long()


def decode_keys(keys: torch.Tensor):
    """int64 keys -> (distance f32, index int64)."""
    u = (keys >> 32) & 0xFFFFFFFF
    bits = torch.where(u >= 2 ** 31, u - 2 ** 31, ~u & 0xFFFFFFFF)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32), keys & 0xFFFFFFFF


def mask_bits(m: torch.Tensor) -> torch.Tensor:
    """[N, K] 0/1 validity -> [N] int32 bit masks (bit k = tap k)."""
    w = torch.pow(2, torch.arange(m.shape[1], device=m.device))
    return (m.long() * w).sum(dim=1).to(torch.int32)


def nn_bidir_tables(fa: torch.Tensor, ma: torch.Tensor, fb: torch.Tensor,
                    mb: torch.Tensor):
    """Launch the kernel on padded patch tables.

    fa/fb: bf16 [Na_pad, KC] / [Nb_pad, KC], rows a multiple of TILE, KC a
    multiple of DEPTH; ma/mb: int32 [Na_pad] / [Nb_pad] bit masks (0 on
    padded rows).  Returns (d_ab, i_ab, d_ba, i_ba) over the padded rows.
    """
    global LAUNCHES
    for name, t in (("fa", fa), ("fb", fb)):
        if t.dtype != torch.bfloat16 or t.dim() != 2:
            raise ValueError(f"{name}: expected a 2-D bfloat16 table, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("ma", ma), ("mb", mb)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name}: expected 1-D int32 bit masks, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("fa", fa), ("ma", ma), ("fb", fb), ("mb", mb)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    kc = fa.shape[1]
    if fb.shape[1] != kc or kc % DEPTH:
        raise ValueError(f"K*C must agree and be a multiple of {DEPTH}: "
                         f"{kc}, {fb.shape[1]}")
    na_pad, nb_pad = fa.shape[0], fb.shape[0]
    if (na_pad % TILE or nb_pad % TILE or ma.shape[0] != na_pad
            or mb.shape[0] != nb_pad):
        raise ValueError(f"rows must be padded to a multiple of {TILE}")
    dev = fa.device
    if dev.type != "cuda" or any(t.device != dev for t in (ma, fb, mb)):
        raise ValueError("nn_bidir_tables needs all tables on one CUDA device")

    lib = _lib()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ni, nb_tiles = na_pad // TILE, nb_pad // TILE
    n_split = min(nb_tiles, -(-_BLOCKS_PER_SM * n_sm // ni))
    tiles_per_split = -(-nb_tiles // n_split)
    inf_key = encode_keys(torch.tensor([float("inf")], device=dev),
                          torch.zeros(1, dtype=torch.int64, device=dev))
    row_keys = inf_key.expand(na_pad).contiguous()
    col_keys = inf_key.expand(nb_pad).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nn_bidir_launch(
        fa.data_ptr(), ma.data_ptr(), fb.data_ptr(), mb.data_ptr(),
        na_pad, nb_pad, kc, tiles_per_split, row_keys.data_ptr(),
        col_keys.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("nn_bidir kernel launch failed: "
                           + lib.nn_bidir_error_string(err).decode())
    LAUNCHES += 1
    d_ab, i_ab = decode_keys(row_keys)
    d_ba, i_ba = decode_keys(col_keys)
    return d_ab, i_ab, d_ba, i_ba


def padded_tables(x_norm: torch.Tensor, patch_size: int):
    """[H, W, C] -> the kernel's operands: bf16 patch rows and int32 bit
    masks, zero-padded to a multiple of TILE rows."""
    f, m = prep_tables(x_norm, patch_size)
    pad = (-f.shape[0]) % TILE
    f = torch.nn.functional.pad(f, (0, 0, 0, pad))
    bits = torch.nn.functional.pad(mask_bits(m), (0, pad))
    return f.contiguous(), bits.contiguous()


def exact_nn_bidir(a_norm: torch.Tensor, b_norm: torch.Tensor,
                   patch_size: int = 3):
    """Exhaustive NN in both directions from one sweep.

    Returns (nnf_ab [Ha,Wa,2] int32, annd_ab [Ha,Wa] f32, nnf_ba [Hb,Wb,2]
    int32, annd_ba [Hb,Wb] f32), first match on ties.  CUDA tensors go
    through the kernel; CPU tensors through the plain version.
    """
    if a_norm.device != b_norm.device:
        raise ValueError("a_norm and b_norm must be on one device")
    if a_norm.device.type == "cpu":
        return exact_nn_bidir_plain(a_norm, b_norm, patch_size)
    ha, wa, _ = a_norm.shape
    hb, wb, _ = b_norm.shape
    na, nb = ha * wa, hb * wb
    fa, ma = padded_tables(a_norm, patch_size)
    fb, mb = padded_tables(b_norm, patch_size)
    d_ab, i_ab, d_ba, i_ba = nn_bidir_tables(fa, ma, fb, mb)
    return (unpack_nnf(i_ab[:na], nb, ha, wa, wb), d_ab[:na].reshape(ha, wa),
            unpack_nnf(i_ba[:nb], na, hb, wb, wa), d_ba[:nb].reshape(hb, wb))
