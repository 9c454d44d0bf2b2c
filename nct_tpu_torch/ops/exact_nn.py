"""Exact patch NN search, bidirectional and directed: the plain PyTorch
version.

The masked cosine patch distance between patch p of A and q of B is

    d(p, q) = -<Fa[p], Fb[q]> / max(Ma[p] . Mb[q], 1),  +inf where the count is 0

over patchified features rounded to bfloat16 (``prep_tables``).  One sweep
over A chunks x B tiles folds the row argmin (a -> b) and, for the
bidirectional search, the column argmin (b -> a), first match on ties, so
the [Na, Nb] matrix is never stored.  A batch (a leading axis on both
operands) runs item by item: this is the oracle of the kernel's batched
launch, which must give each item's own result.  The directed search is the same sweep
without the column fold (``nn_tables_plain``, ``exact_nn_plain``: the
counterparts of ``nct_tpu/ops/exact_nn.py::exact_nn`` and of the Pallas
``exact_nn_pallas``).  This is the CPU path and the card-side oracle of the
CUDA kernels in ``cuda_nn.py`` (the counterparts of
``nct_tpu/ops/pallas_nn.py``); on a CUDA tensor the port always goes
through the kernels.

The bfloat16 tables are cast to float32 before ``torch.matmul``: a bf16 x
bf16 matmul in torch returns bf16 and rounds every dot product, while a
bf16 x bf16 product is exact in float32, so the float32 matmul (TF32 off)
reproduces JAX's ``preferred_element_type=f32`` up to summation order.
"""

from __future__ import annotations

import torch

from nct_tpu_torch.ops.patchmatch import patchify


def prep_tables(x_norm: torch.Tensor, patch_size: int):
    """[..., H, W, C] -> (F [..., N, K*C] bf16 patch rows, M [N, K] 0/1
    validity, the same for every item of a batch)."""
    h, w = x_norm.shape[-3], x_norm.shape[-2]
    p, pm = patchify(x_norm.float(), patch_size)
    k, c = p.shape[-2], p.shape[-1]
    return (p.reshape(p.shape[:-4] + (h * w, k * c)).to(torch.bfloat16),
            pm.reshape(h * w, k))


def unpack_nnf(best_i: torch.Tensor, n_other: int, h: int, w: int,
               w_other: int) -> torch.Tensor:
    """Flat target indices [..., h*w] -> NNF [..., h, w, 2] int32 (x, y)."""
    best_i = torch.clamp(best_i.long(), max=n_other - 1)
    return torch.stack([best_i % w_other, best_i // w_other],
                       dim=-1).to(torch.int32).reshape(
                           best_i.shape[:-1] + (h, w, 2))


def _first_min(d: torch.Tensor, dim: int):
    """(min, first index of the min) along ``dim``, ties to the lowest."""
    dmin = d.amin(dim=dim, keepdim=True)
    ar = torch.arange(d.shape[dim], device=d.device, dtype=torch.int64)
    ar = ar[:, None] if dim == 0 else ar[None, :]
    idx = torch.where(d == dmin, ar, d.shape[dim]).amin(dim=dim)
    return dmin.squeeze(dim), idx


def _sweep(fa, ma, fb, mb, a_chunk: int, b_tile: int, columns: bool):
    """Row (and, with ``columns``, column) min and first argmin of the
    masked distance between patch tables."""
    na, nb = fa.shape[0], fb.shape[0]
    dev = fa.device
    fa32, ma32 = fa.float(), ma.float()
    fb32, mb32 = fb.float(), mb.float()
    inf = torch.tensor(float("inf"), device=dev)
    d_ab = torch.full((na,), float("inf"), device=dev)
    i_ab = torch.zeros((na,), dtype=torch.int64, device=dev)
    d_ba = torch.full((nb,), float("inf"), device=dev)
    i_ba = torch.zeros((nb,), dtype=torch.int64, device=dev)
    for a0 in range(0, na, a_chunk):
        a1 = min(a0 + a_chunk, na)
        for b0 in range(0, nb, b_tile):
            b1 = min(b0 + b_tile, nb)
            dots = fa32[a0:a1] @ fb32[b0:b1].T
            cnt = ma32[a0:a1] @ mb32[b0:b1].T
            d = torch.where(cnt > 0, -dots / torch.clamp(cnt, min=1.0), inf)
            # a -> b: strict < across ascending B tiles = first match
            rmin, rcol = _first_min(d, 1)
            better = rmin < d_ab[a0:a1]
            d_ab[a0:a1] = torch.where(better, rmin, d_ab[a0:a1])
            i_ab[a0:a1] = torch.where(better, rcol + b0, i_ab[a0:a1])
            if not columns:
                continue
            # b -> a: strict < across ascending A chunks = first match
            cmin, crow = _first_min(d, 0)
            better = cmin < d_ba[b0:b1]
            d_ba[b0:b1] = torch.where(better, cmin, d_ba[b0:b1])
            i_ba[b0:b1] = torch.where(better, crow + a0, i_ba[b0:b1])
    return d_ab, i_ab, d_ba, i_ba


def _per_item(fn, *args):
    """fn over the items of a batch (a leading axis on every argument),
    its outputs stacked."""
    return tuple(torch.stack(t) for t in zip(*(fn(*a) for a in zip(*args))))


def nn_bidir_tables_plain(fa, ma, fb, mb, a_chunk: int = 4096,
                          b_tile: int = 4096):
    """Row and column (min, first argmin) of the masked distance between
    patch tables.  Returns (d_ab [Na], i_ab [Na], d_ba [Nb], i_ba [Nb]);
    batched tables ([B, Na, KC], masks [B, Na, K]) give [B, ...]."""
    if fa.dim() == 3:
        return _per_item(lambda *t: nn_bidir_tables_plain(*t, a_chunk, b_tile),
                         fa, ma, fb, mb)
    return _sweep(fa, ma, fb, mb, a_chunk, b_tile, columns=True)


def nn_tables_plain(fa, ma, fb, mb, a_chunk: int = 4096, b_tile: int = 4096):
    """Row (min, first argmin) only: the directed a -> b search.  Returns
    (d_ab [Na], i_ab [Na]), or [B, Na] for batched tables."""
    if fa.dim() == 3:
        return _per_item(lambda *t: nn_tables_plain(*t, a_chunk, b_tile),
                         fa, ma, fb, mb)
    return _sweep(fa, ma, fb, mb, a_chunk, b_tile, columns=False)[:2]


def exact_nn_bidir_plain(a_norm: torch.Tensor, b_norm: torch.Tensor,
                         patch_size: int = 3):
    """Exhaustive NN in both directions.  a_norm [Ha,Wa,C], b_norm
    [Hb,Wb,C] L2-normalized.  Returns (nnf_ab [Ha,Wa,2] int32, annd_ab
    [Ha,Wa] f32, nnf_ba [Hb,Wb,2] int32, annd_ba [Hb,Wb] f32); a batch
    [B, ...] of both gives [B, ...] results."""
    if a_norm.dim() == 4:
        return _per_item(lambda a, b: exact_nn_bidir_plain(a, b, patch_size),
                         a_norm, b_norm)
    ha, wa, _ = a_norm.shape
    hb, wb, _ = b_norm.shape
    fa, ma = prep_tables(a_norm, patch_size)
    fb, mb = prep_tables(b_norm, patch_size)
    d_ab, i_ab, d_ba, i_ba = nn_bidir_tables_plain(fa, ma, fb, mb)
    return (unpack_nnf(i_ab, hb * wb, ha, wa, wb), d_ab.reshape(ha, wa),
            unpack_nnf(i_ba, ha * wa, hb, wb, wa), d_ba.reshape(hb, wb))


def exact_nn_plain(a_norm: torch.Tensor, b_norm: torch.Tensor,
                   patch_size: int = 3):
    """Exhaustive NN a -> b.  a_norm [Ha,Wa,C], b_norm [Hb,Wb,C]
    L2-normalized.  Returns (nnf [Ha,Wa,2] int32, annd [Ha,Wa] f32); a
    batch [B, ...] of both gives [B, ...] results."""
    if a_norm.dim() == 4:
        return _per_item(lambda a, b: exact_nn_plain(a, b, patch_size),
                         a_norm, b_norm)
    ha, wa, _ = a_norm.shape
    hb, wb, _ = b_norm.shape
    fa, ma = prep_tables(a_norm, patch_size)
    fb, mb = prep_tables(b_norm, patch_size)
    d_ab, i_ab = nn_tables_plain(fa, ma, fb, mb)
    return unpack_nnf(i_ab, hb * wb, ha, wa, wb), d_ab.reshape(ha, wa)
