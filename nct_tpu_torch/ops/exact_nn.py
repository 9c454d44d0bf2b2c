"""Exact bidirectional patch NN search: the plain PyTorch version.

The masked cosine patch distance between patch p of A and q of B is

    d(p, q) = -<Fa[p], Fb[q]> / max(Ma[p] . Mb[q], 1),  +inf where the count is 0

over patchified features rounded to bfloat16 (``prep_tables``).  One sweep
over A chunks x B tiles folds both the row argmin (a -> b) and the column
argmin (b -> a), first match on ties, so the [Na, Nb] matrix is never
stored.  This is the CPU path and the card-side oracle of the CUDA kernel
in ``cuda_nn.py`` (the counterpart of ``nct_tpu/ops/pallas_nn.py``); on a
CUDA tensor the pipeline always goes through the kernel.

The bfloat16 tables are cast to float32 before ``torch.matmul``: a bf16 x
bf16 matmul in torch returns bf16 and rounds every dot product, while a
bf16 x bf16 product is exact in float32, so the float32 matmul (TF32 off)
reproduces JAX's ``preferred_element_type=f32`` up to summation order.
"""

from __future__ import annotations

import torch

from nct_tpu_torch.ops.patchmatch import patchify


def prep_tables(x_norm: torch.Tensor, patch_size: int):
    """[H, W, C] -> (F [N, K*C] bf16 patch rows, M [N, K] 0/1 validity)."""
    h, w, _ = x_norm.shape
    p, pm = patchify(x_norm.float(), patch_size)
    k, c = p.shape[2], p.shape[3]
    return (p.reshape(h * w, k * c).to(torch.bfloat16),
            pm.reshape(h * w, k))


def unpack_nnf(best_i: torch.Tensor, n_other: int, h: int, w: int,
               w_other: int) -> torch.Tensor:
    """Flat target indices [h*w] -> NNF [h, w, 2] int32 (x, y)."""
    best_i = torch.clamp(best_i.long(), max=n_other - 1)
    return torch.stack([best_i % w_other, best_i // w_other],
                       dim=-1).to(torch.int32).reshape(h, w, 2)


def _first_min(d: torch.Tensor, dim: int):
    """(min, first index of the min) along ``dim``, ties to the lowest."""
    dmin = d.amin(dim=dim, keepdim=True)
    ar = torch.arange(d.shape[dim], device=d.device, dtype=torch.int64)
    ar = ar[:, None] if dim == 0 else ar[None, :]
    idx = torch.where(d == dmin, ar, d.shape[dim]).amin(dim=dim)
    return dmin.squeeze(dim), idx


def nn_bidir_tables_plain(fa, ma, fb, mb, a_chunk: int = 4096,
                          b_tile: int = 4096):
    """Row and column (min, first argmin) of the masked distance between
    patch tables.  Returns (d_ab [Na], i_ab [Na], d_ba [Nb], i_ba [Nb])."""
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
            # b -> a: strict < across ascending A chunks = first match
            cmin, crow = _first_min(d, 0)
            better = cmin < d_ba[b0:b1]
            d_ba[b0:b1] = torch.where(better, cmin, d_ba[b0:b1])
            i_ba[b0:b1] = torch.where(better, crow + a0, i_ba[b0:b1])
    return d_ab, i_ab, d_ba, i_ba


def exact_nn_bidir_plain(a_norm: torch.Tensor, b_norm: torch.Tensor,
                         patch_size: int = 3):
    """Exhaustive NN in both directions.  a_norm [Ha,Wa,C], b_norm
    [Hb,Wb,C] L2-normalized.  Returns (nnf_ab [Ha,Wa,2] int32, annd_ab
    [Ha,Wa] f32, nnf_ba [Hb,Wb,2] int32, annd_ba [Hb,Wb] f32)."""
    ha, wa, _ = a_norm.shape
    hb, wb, _ = b_norm.shape
    fa, ma = prep_tables(a_norm, patch_size)
    fb, mb = prep_tables(b_norm, patch_size)
    d_ab, i_ab, d_ba, i_ba = nn_bidir_tables_plain(fa, ma, fb, mb)
    return (unpack_nnf(i_ab, hb * wb, ha, wa, wb), d_ab.reshape(ha, wa),
            unpack_nnf(i_ba, ha * wa, hb, wb, wa), d_ba.reshape(hb, wb))
