"""Exact patch NN search on the card: bidirectional (counterpart of
``nct_tpu/ops/pallas_nn.py::exact_nn_pallas_bidir``) and directed
(counterpart of ``exact_nn_pallas``).

``exact_nn_bidir`` and ``exact_nn`` launch the hand-written CUDA kernel
``csrc/nn_bidir.cu`` (its bidirectional and directed instances) for CUDA
tensors and run the plain PyTorch versions (``exact_nn.exact_nn_bidir_plain``
and ``exact_nn.exact_nn_plain``) for CPU tensors.  There is no switch and no
fallback: on a CUDA tensor a failed build or launch raises.

The kernel returns, per row (and per column), a 64-bit key
``ordered_bits(d) << 32 | index`` reduced with atomicMin (see the source
note in ``nn_bidir.cu``); ``decode_keys`` turns keys back into
(distance, index).  A batch ([B, H, W, C] operands, items of one geometry)
is one launch over a batch grid axis, each item's indices its own.
``LAUNCHES`` counts kernel launches per instance, ``LAUNCH_ITEMS`` the
items (pairs) they searched.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nct_tpu_torch import _build
from nct_tpu_torch.ops.exact_nn import (
    exact_nn_bidir_plain, exact_nn_plain, prep_tables, unpack_nnf,
)

LAUNCHES = {"nn_bidir": 0, "nn_directed": 0}
LAUNCH_ITEMS = {"nn_bidir": 0, "nn_directed": 0}

TILE = 128   # rows of A per block and columns of B per tile (nn_bidir.cu TA/TB)
DEPTH = 64   # K*C is zero-padded to a multiple of the stage depth (TK)
# B sweep split so the grid holds ~64 blocks per SM: with 2 resident per SM
# that is ~32 waves, so the last wave's tail costs little at L1-L3
_BLOCKS_PER_SM = 64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("nn_bidir")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nn_bidir_launch.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p]
    lib.nn_bidir_launch.restype = i
    lib.nn_directed_launch.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
    lib.nn_directed_launch.restype = i
    lib.nn_kernel_occupancy.argtypes = [i, p, p]
    lib.nn_kernel_occupancy.restype = i
    lib.nn_bidir_error_string.argtypes = [i]
    lib.nn_bidir_error_string.restype = ctypes.c_char_p
    lib.nn_bidir_tile_rows.restype = i
    lib.nn_bidir_tile_depth.restype = i
    if (lib.nn_bidir_tile_rows(), lib.nn_bidir_tile_depth()) != (TILE, DEPTH):
        raise RuntimeError("nn_bidir.cu tile geometry differs from cuda_nn.py")
    return lib


def occupancy(kind: str) -> tuple[int, int]:
    """(resident blocks per SM, dynamic shared-memory bytes per block) of
    one instance on the current card, from the CUDA occupancy API."""
    lib = _lib()
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.nn_kernel_occupancy(int(kind == "nn_bidir"), ctypes.byref(blocks),
                                  ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"{kind} occupancy query failed: "
                           + lib.nn_bidir_error_string(err).decode())
    return blocks.value, smem.value


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


def _check_tables(fa, ma, fb, mb) -> None:
    """Raise on operands the kernel does not take: 2-D tables and 1-D masks
    (one pair), or all four with one leading batch axis of equal size."""
    lead = fa.dim() - 2
    for name, t in (("fa", fa), ("fb", fb)):
        if t.dtype != torch.bfloat16 or t.dim() != lead + 2 or lead > 1:
            raise ValueError(f"{name}: expected a bfloat16 table [N, KC] or "
                             f"[B, N, KC], got {t.dtype} {tuple(t.shape)}")
    for name, t in (("ma", ma), ("mb", mb)):
        if t.dtype != torch.int32 or t.dim() != lead + 1:
            raise ValueError(f"{name}: expected int32 bit masks [N] or [B, "
                             f"N], got {t.dtype} {tuple(t.shape)}")
    if lead and not fa.shape[0] == ma.shape[0] == fb.shape[0] == mb.shape[0]:
        raise ValueError("the batch sizes of the tables and masks differ")
    for name, t in (("fa", fa), ("ma", ma), ("fb", fb), ("mb", mb)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             f"(the kernel copies 16-byte chunks)")
    kc = fa.shape[-1]
    if fb.shape[-1] != kc or kc % DEPTH:
        raise ValueError(f"K*C must agree and be a multiple of {DEPTH}: "
                         f"{kc}, {fb.shape[-1]}")
    na_pad, nb_pad = fa.shape[-2], fb.shape[-2]
    if (na_pad % TILE or nb_pad % TILE or ma.shape[-1] != na_pad
            or mb.shape[-1] != nb_pad):
        raise ValueError(f"rows must be padded to a multiple of {TILE}")
    dev = fa.device
    if dev.type != "cuda" or any(t.device != dev for t in (ma, fb, mb)):
        raise ValueError("the NN kernels need all tables on one CUDA device")


def _launch(kind: str, fa, ma, fb, mb):
    """Launch one instance on checked tables (one pair, or a batch over the
    grid's z axis); returns its key tensors, [B, ...] for a batch.  Tables
    of zero rows launch nothing (and count nothing): their rows and
    columns hold the "no match" key, distance inf and index 0."""
    dev = fa.device
    lead = tuple(fa.shape[:-2])
    batch = lead[0] if lead else 1
    na_pad, nb_pad, kc = fa.shape[-2], fb.shape[-2], fa.shape[-1]
    inf_key = encode_keys(torch.tensor([float("inf")], device=dev),
                          torch.zeros(1, dtype=torch.int64, device=dev))
    row_keys = inf_key.expand(lead + (na_pad,)).contiguous()
    if not (na_pad and nb_pad and batch):
        # an empty operand (a row band of zero rows): every row and column
        # keeps the key the kernel starts from, and nothing is launched
        # (CUDA refuses an empty grid)
        if kind == "nn_bidir":
            return row_keys, inf_key.expand(lead + (nb_pad,)).contiguous()
        return (row_keys,)
    lib = _lib()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ni, nb_tiles = na_pad // TILE, nb_pad // TILE
    # the batch's blocks count towards the ~64 per SM
    n_split = min(nb_tiles, -(-_BLOCKS_PER_SM * n_sm // (ni * batch)))
    tiles_per_split = -(-nb_tiles // n_split)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (fa.data_ptr(), ma.data_ptr(), fb.data_ptr(), mb.data_ptr(),
            na_pad, nb_pad, kc, tiles_per_split, batch, row_keys.data_ptr())
    if kind == "nn_bidir":
        col_keys = inf_key.expand(lead + (nb_pad,)).contiguous()
        err = lib.nn_bidir_launch(*args, col_keys.data_ptr(), stream)
        keys = (row_keys, col_keys)
    else:
        err = lib.nn_directed_launch(*args, stream)
        keys = (row_keys,)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: "
                           + lib.nn_bidir_error_string(err).decode())
    LAUNCHES[kind] += 1
    LAUNCH_ITEMS[kind] += batch
    return keys


def nn_bidir_tables(fa: torch.Tensor, ma: torch.Tensor, fb: torch.Tensor,
                    mb: torch.Tensor):
    """Launch the bidirectional kernel on padded patch tables.

    fa/fb: bf16 [Na_pad, KC] / [Nb_pad, KC], rows a multiple of TILE, KC a
    multiple of DEPTH; ma/mb: int32 [Na_pad] / [Nb_pad] bit masks (0 on
    padded rows).  Returns (d_ab, i_ab, d_ba, i_ba) over the padded rows.
    With a leading batch axis on all four, one launch searches every item
    and returns [B, ...] results.
    """
    _check_tables(fa, ma, fb, mb)
    row_keys, col_keys = _launch("nn_bidir", fa, ma, fb, mb)
    return (*decode_keys(row_keys), *decode_keys(col_keys))


def nn_directed_tables(fa: torch.Tensor, ma: torch.Tensor, fb: torch.Tensor,
                       mb: torch.Tensor):
    """Launch the directed kernel (a -> b only) on padded patch tables, as
    ``nn_bidir_tables``.  Returns (d_ab, i_ab) over the padded A rows."""
    _check_tables(fa, ma, fb, mb)
    (row_keys,) = _launch("nn_directed", fa, ma, fb, mb)
    return decode_keys(row_keys)


def padded_tables(x_norm: torch.Tensor, patch_size: int):
    """[H, W, C] -> the kernel's operands: bf16 patch rows and int32 bit
    masks, zero-padded to a multiple of TILE rows, the rows zero-padded to
    a multiple of DEPTH columns.  Zero columns add exact zeros to every dot
    product and the masks are separate, so the result does not change.  A
    batch [B, H, W, C] gives [B, N_pad, KC] tables and [B, N_pad] masks."""
    f, m = prep_tables(x_norm, patch_size)
    pad = (-f.shape[-2]) % TILE
    f = torch.nn.functional.pad(f, (0, (-f.shape[-1]) % DEPTH, 0, pad))
    bits = torch.nn.functional.pad(mask_bits(m), (0, pad))
    if f.dim() == 3:
        bits = bits.expand(f.shape[0], -1)
    return f.contiguous(), bits.contiguous()


def exact_nn_bidir(a_norm: torch.Tensor, b_norm: torch.Tensor,
                   patch_size: int = 3):
    """Exhaustive NN in both directions from one sweep.

    Returns (nnf_ab [Ha,Wa,2] int32, annd_ab [Ha,Wa] f32, nnf_ba [Hb,Wb,2]
    int32, annd_ba [Hb,Wb] f32), first match on ties.  CUDA tensors go
    through the kernel; CPU tensors through the plain version.  A batch
    [B, Ha, Wa, C] / [B, Hb, Wb, C] is one launch, with [B, ...] results.
    """
    if a_norm.device != b_norm.device:
        raise ValueError("a_norm and b_norm must be on one device")
    if a_norm.device.type == "cpu":
        return exact_nn_bidir_plain(a_norm, b_norm, patch_size)
    (ha, wa), (hb, wb) = a_norm.shape[-3:-1], b_norm.shape[-3:-1]
    lead = tuple(a_norm.shape[:-3])
    na, nb = ha * wa, hb * wb
    fa, ma = padded_tables(a_norm, patch_size)
    fb, mb = padded_tables(b_norm, patch_size)
    d_ab, i_ab, d_ba, i_ba = nn_bidir_tables(fa, ma, fb, mb)
    return (unpack_nnf(i_ab[..., :na], nb, ha, wa, wb),
            d_ab[..., :na].reshape(lead + (ha, wa)),
            unpack_nnf(i_ba[..., :nb], na, hb, wb, wa),
            d_ba[..., :nb].reshape(lead + (hb, wb)))


def exact_nn(a_norm: torch.Tensor, b_norm: torch.Tensor, patch_size: int = 3):
    """Exhaustive NN a -> b (counterpart of ``exact_nn_pallas``).

    Returns (nnf [Ha,Wa,2] int32, annd [Ha,Wa] f32), first match on ties.
    CUDA tensors go through the directed kernel; CPU tensors through the
    plain version.  A batch [B, ...] is one launch, with [B, ...] results.
    """
    if a_norm.device != b_norm.device:
        raise ValueError("a_norm and b_norm must be on one device")
    if a_norm.device.type == "cpu":
        return exact_nn_plain(a_norm, b_norm, patch_size)
    (ha, wa), (hb, wb) = a_norm.shape[-3:-1], b_norm.shape[-3:-1]
    lead = tuple(a_norm.shape[:-3])
    na = ha * wa
    fa, ma = padded_tables(a_norm, patch_size)
    fb, mb = padded_tables(b_norm, patch_size)
    d_ab, i_ab = nn_directed_tables(fa, ma, fb, mb)
    return (unpack_nnf(i_ab[..., :na], hb * wb, ha, wa, wb),
            d_ab[..., :na].reshape(lead + (ha, wa)))
