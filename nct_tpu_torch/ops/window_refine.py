"""Three-stage local window refinement of an upsampled NNF (port of
``nct_tpu/ops/window_refine.py::_window_refine_impl``).

  1. centre stage: -<A[p], B[nnf0(p)+w]> for every shift w of the dense
     +-radius window plus sparse far rings, through one x-rolled "strip
     table" of B so each window row is a single gather;
  2. patch-approximate stage: the zero-padded patch_size x patch_size box
     sum of the centre distances over a-space scores every shift with patch
     context; the ``shortlist`` best shifts are kept;
  3. rescore: the shortlisted candidates get the exact masked-cosine patch
     distance, and the incumbent nnf0(p) competes too.

The arithmetic follows the JAX package as written: stage 1 multiplies bf16
by bf16 IN bf16 and sums the products in f32, while the stage-3 rescore
takes f32 products of the bf16 values (``preferred_element_type``).
A batch (a leading axis on every operand) folds into the rows of the strip
and patch tables, as the JAX package's ``_window_refine_folded`` does:
each item's gathers read its own rows through a per-item offset.  With
``gather_taps`` the same rows are gathered tap by tap from B itself, so
that no table of B's size is built (a row band refined against a whole
style level); the values, and so the result, are the same.  The
JAX package's box-sum lowering switch is a TPU lowering of the same box
sum and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nct_tpu_torch.ops.fmath import sum_last
from nct_tpu_torch.ops.patchmatch import gather_patch_rows, patchify


def _box_sum(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Zero-padded patch_size x patch_size box sum over the last two axes."""
    half = patch_size // 2
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (0, 0, half, half))
    rows = xp[..., 0:h, :]
    for o in range(1, patch_size):
        rows = rows + xp[..., o:o + h, :]
    xp = F.pad(rows, (half, half))
    out = xp[..., 0:w]
    for o in range(1, patch_size):
        out = out + xp[..., o:o + w]
    return out


def _shift_set(radius: int):
    """Dense +-radius window plus 8 compass points at 2r and 4r."""
    dxs = list(range(-radius, radius + 1))
    dense = [(dx, dy) for dy in dxs for dx in dxs]
    rings = [
        (r * sx, r * sy)
        for r in (2 * radius, 4 * radius)
        for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1),
                       (1, 1), (1, -1), (-1, 1), (-1, -1))
    ]
    return dxs, dense, rings


def _gather_rolled(b: torch.Tensor, idx: torch.Tensor, dxs, wb: int,
                   boff) -> torch.Tensor:
    """Rows of the "strip table" of b [-1, C] (its x-rolled copies, one per
    dx, concatenated) at flat indices ``idx``, gathered tap by tap so that
    no table of B's size is built: [..., len(dxs), C]."""
    y, x = idx // wb, idx % wb
    return torch.stack([b[boff + y * wb + (x + dx) % wb] for dx in dxs],
                       dim=-2)


def window_refine(
    a_norm: torch.Tensor,
    b_norm: torch.Tensor,
    nnf0: torch.Tensor,
    radius: int = 4,
    shortlist: int = 8,
    patch_size: int = 3,
    stage1_channels: int = 0,
    halo: tuple[int, int] = (0, 0),
    gather_taps: bool = False,
):
    """Refine nnf0 (a->b) within a +-radius window.

    a_norm [Ha,Wa,C], b_norm [Hb,Wb,C]; nnf0 [Ha,Wa,2] int32 (x, y), or
    each with a leading batch axis.  ``stage1_channels`` > 0 ranks stage 1
    on the first that many channels.  Returns (nnf [Ha,Wa,2] int32, annd
    [Ha,Wa] f32 full patch metric).  ``halo`` = (top, bottom): a_norm and
    nnf0 hold a band of A's rows with that many of its neighbours' rows
    above and below (none at the image's edges; the box sum and the
    patches read them), and the result covers the band's rows only, bit
    for bit those rows of the whole refine; b_norm is whole.
    ``gather_taps``: gather B's strip rows and patches tap by tap instead
    of through B-sized strip and patch tables (less memory, slower).
    """
    ha, wa, c = a_norm.shape[-3:]
    hb, wb = b_norm.shape[-3], b_norm.shape[-2]
    lead = tuple(a_norm.shape[:-3])
    nb = hb * wb
    dev = a_norm.device
    top, bottom = halo
    boff = (torch.arange(lead[0], device=dev)[:, None, None] * nb if lead
            else 0)

    a16 = a_norm.to(torch.bfloat16)
    b16 = b_norm.to(torch.bfloat16)

    dxs, dense, rings = _shift_set(radius)
    shift_list = dense + rings
    shifts = torch.tensor(shift_list, dtype=torch.int32, device=dev)
    n_shifts = len(shift_list)
    nd = len(dxs)

    bx0 = nnf0[..., 0].long()
    by0 = nnf0[..., 1].long()

    # ---- stage 1: centre-feature distances for every shift
    cs = c if stage1_channels <= 0 else min(stage1_channels, c)
    a1 = a16[..., :cs]
    b1 = b16[..., :cs]
    if not gather_taps:
        strip = torch.cat([torch.roll(b1, shifts=-dx, dims=-2) for dx in dxs],
                          dim=-1).reshape(-1, nd * cs)
    b1 = b1.reshape(-1, cs)
    idx0 = by0 * wb + bx0
    d_rows = []
    for dy in dxs:
        idx = torch.clamp(idx0 + dy * wb, 0, nb - 1)
        if gather_taps:
            g = _gather_rolled(b1, idx, dxs, wb, boff)
        else:
            g = strip[(idx + boff).reshape(-1)].reshape(
                lead + (ha, wa, nd, cs))                    # [Ha, Wa, nd, Cs]
        d = -sum_last(a1[..., None, :] * g, dtype=torch.float32)
        d_rows.append(d.movedim(-1, 0))                     # [nd, Ha, Wa]
    ring_idx = torch.stack(
        [boff + torch.clamp(idx0 + dy * wb + dx, 0, nb - 1)
         for dx, dy in rings])
    gr = b1[ring_idx]                                       # [R, Ha, Wa, Cs]
    d_rows.append(-sum_last(a1[None] * gr, dtype=torch.float32))
    d_center = torch.cat(d_rows, dim=0)                     # [S2, Ha, Wa]
    grid = (1,) * bx0.dim()
    sdx = shifts[:, 0].reshape((-1,) + grid)
    sdy = shifts[:, 1].reshape((-1,) + grid)
    valid = ((bx0[None] + sdx >= 0) & (bx0[None] + sdx < wb)
             & (by0[None] + sdy >= 0) & (by0[None] + sdy < hb))
    inf = torch.tensor(float("inf"), device=dev)
    d_center = torch.where(valid, d_center, inf)

    # ---- patch-approximate scores: box sum of the centre distances (a
    # band's halo rows feed its edge rows, then leave)
    finite = torch.isfinite(d_center)
    num = _box_sum(torch.where(finite, d_center, 0.0), patch_size)
    cnt = _box_sum(finite.float(), patch_size)
    d_patch = torch.where(cnt > 0, num / cnt, inf)
    rows = ha - top - bottom
    d_patch = d_patch[..., top:top + rows, :]
    bx0, by0 = bx0[..., top:top + rows, :], by0[..., top:top + rows, :]

    # ---- shortlist: S best shifts per pixel (first minimum on ties)
    work = d_patch
    picks = []
    shift_ids = torch.arange(n_shifts, device=dev).reshape((-1,) + grid)
    for _ in range(min(shortlist, n_shifts)):
        j = torch.argmin(work, dim=0)                       # [Ha, Wa]
        picks.append(j)
        work = torch.where(shift_ids == j[None], inf, work)

    # ---- stage 3: full patch metric on the shortlist (+ incumbent)
    pa, pam = patchify(a16, patch_size)
    k = pa.shape[-2]
    pa_f = pa[..., top:top + rows, :, :, :].reshape(
        lead + (rows, wa, k * c)).float()
    pam_f = pam[top:top + rows].float()
    if gather_taps:
        half = patch_size // 2
        b_pad = F.pad(b16, (0, 0, half, half, half, half)).reshape(-1, c)
        pboff = boff // nb * ((hb + 2 * half) * (wb + 2 * half))

        def patch_rows(cand_x, cand_y):
            return gather_patch_rows(b_pad, cand_x, cand_y, hb, wb,
                                     patch_size, pboff)
    else:
        pb, pbm = patchify(b16, patch_size)
        pb_flat = pb.reshape(-1, k * c)
        pbm_flat = pbm.reshape(nb, k)

        def patch_rows(cand_x, cand_y):
            flat = torch.clamp(cand_y * wb + cand_x, 0, nb - 1)
            return pb_flat[flat + boff], pbm_flat[flat].float()

    def full_eval(cand_x, cand_y):
        g, gm = patch_rows(cand_x, cand_y)          # [Ha, Wa, K*C], [.., K]
        num = -sum_last(pa_f * g.float())
        cnt = torch.sum(pam_f * gm, dim=-1)
        return torch.where(cnt > 0, num / torch.clamp(cnt, min=1.0), 1.0)

    best_x, best_y = bx0, by0
    best_d = full_eval(bx0, by0)                            # incumbent
    for j in picks:
        cx = torch.clamp(bx0 + shifts[:, 0][j], 0, wb - 1)
        cy = torch.clamp(by0 + shifts[:, 1][j], 0, hb - 1)
        d = full_eval(cx, cy)
        better = d < best_d
        best_x = torch.where(better, cx, best_x)
        best_y = torch.where(better, cy, best_y)
        best_d = torch.where(better, d, best_d)

    return torch.stack([best_x, best_y], dim=-1).to(torch.int32), best_d
