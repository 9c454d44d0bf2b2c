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
The JAX package's batch fold and its box-sum lowering switch are TPU
lowerings of the same box sum and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nct_tpu_torch.ops.patchmatch import patchify


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


def window_refine(
    a_norm: torch.Tensor,
    b_norm: torch.Tensor,
    nnf0: torch.Tensor,
    radius: int = 4,
    shortlist: int = 8,
    patch_size: int = 3,
    stage1_channels: int = 0,
):
    """Refine nnf0 (a->b) within a +-radius window.

    a_norm [Ha,Wa,C], b_norm [Hb,Wb,C]; nnf0 [Ha,Wa,2] int32 (x, y).
    ``stage1_channels`` > 0 ranks stage 1 on the first that many channels.
    Returns (nnf [Ha,Wa,2] int32, annd [Ha,Wa] f32 full patch metric).
    """
    ha, wa, c = a_norm.shape
    hb, wb, _ = b_norm.shape
    nb = hb * wb
    dev = a_norm.device

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
    idx0 = by0 * wb + bx0
    strip = torch.cat([torch.roll(b1, shifts=-dx, dims=1) for dx in dxs],
                      dim=-1).reshape(nb, nd * cs)
    d_rows = []
    for dy in dxs:
        idx = torch.clamp(idx0 + dy * wb, 0, nb - 1)
        g = strip[idx.reshape(-1)].reshape(ha, wa, nd, cs)
        d = -torch.sum(a1[:, :, None, :] * g, dim=-1, dtype=torch.float32)
        d_rows.append(d.permute(2, 0, 1))                   # [nd, Ha, Wa]
    ring_idx = torch.stack(
        [torch.clamp(idx0 + dy * wb + dx, 0, nb - 1) for dx, dy in rings])
    gr = b1.reshape(nb, cs)[ring_idx]                       # [R, Ha, Wa, Cs]
    d_rows.append(-torch.sum(a1[None] * gr, dim=-1, dtype=torch.float32))
    d_center = torch.cat(d_rows, dim=0)                     # [S2, Ha, Wa]
    sdx = shifts[:, 0][:, None, None]
    sdy = shifts[:, 1][:, None, None]
    valid = ((bx0[None] + sdx >= 0) & (bx0[None] + sdx < wb)
             & (by0[None] + sdy >= 0) & (by0[None] + sdy < hb))
    inf = torch.tensor(float("inf"), device=dev)
    d_center = torch.where(valid, d_center, inf)

    # ---- patch-approximate scores: box sum of the centre distances
    finite = torch.isfinite(d_center)
    num = _box_sum(torch.where(finite, d_center, 0.0), patch_size)
    cnt = _box_sum(finite.float(), patch_size)
    d_patch = torch.where(cnt > 0, num / cnt, inf)

    # ---- shortlist: S best shifts per pixel (first minimum on ties)
    work = d_patch
    picks = []
    shift_ids = torch.arange(n_shifts, device=dev)[:, None, None]
    for _ in range(min(shortlist, n_shifts)):
        j = torch.argmin(work, dim=0)                       # [Ha, Wa]
        picks.append(j)
        work = torch.where(shift_ids == j[None], inf, work)

    # ---- stage 3: full patch metric on the shortlist (+ incumbent)
    pa, pam = patchify(a16, patch_size)
    pb, pbm = patchify(b16, patch_size)
    k = pa.shape[2]
    pa_f = pa.reshape(ha, wa, k * c).float()
    pb_flat = pb.reshape(nb, k * c)
    pam_f = pam.float()
    pbm_flat = pbm.reshape(nb, k)

    def full_eval(cand_x, cand_y):
        flat = torch.clamp(cand_y * wb + cand_x, 0, nb - 1)
        g = pb_flat[flat].float()                           # [Ha, Wa, K*C]
        gm = pbm_flat[flat].float()                         # [Ha, Wa, K]
        num = -torch.sum(pa_f * g, dim=-1)
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
