"""Bidirectional-similarity (BDS) patch voting (port of
``nct_tpu/ops/bds.py``).

Direction A ("coherence") gathers payload samples through the forward NNF
with weight w_cohere/(Ha*Wa); direction B ("completeness") scatter-adds
them through the reverse NNF with weight w_complete/(Hb*Wb).  The voted
value is the weighted mean over all contributing samples.  As in the JAX
package, the 9 patch offsets ride in the channel axis: one gather against
the pre-rolled payload, and one scatter sorted by the reverse NNF.

The scatter is ``index_put_(accumulate=True)`` on indices sorted by a
stable argsort, which adds each target's contributions in ascending
source order on the CPU and, deterministically (sort-based), on the card.
"""

from __future__ import annotations

import torch

from nct_tpu_torch.ops.patchmatch import patch_offsets


def _coord_grids(h: int, w: int, device):
    xs = torch.arange(w, device=device)[None, :].expand(h, w)
    ys = torch.arange(h, device=device)[:, None].expand(h, w)
    return xs, ys


def bds_vote(
    payload_b: torch.Tensor,
    ann: torch.Tensor,
    bnn: torch.Tensor,
    w_cohere: float = 1.0,
    w_complete: float = 2.0,
    patch_size: int = 3,
):
    """Vote payload values from B into A's geometry.

    payload_b: [Hb, Wb, P] values on B's grid; ann [Ha, Wa, 2] (a->b);
    bnn [Hb, Wb, 2] (b->a).  Returns (voted [Ha, Wa, P] f32, total weight
    [Ha, Wa] f32).
    """
    hb, wb, p = payload_b.shape
    ha, wa = ann.shape[0], ann.shape[1]
    dev = payload_b.device
    offsets = patch_offsets(patch_size)
    k = len(offsets)

    payload = payload_b.float()
    wa_w = torch.tensor(w_cohere, dtype=torch.float32) / float(ha * wa)
    wb_w = torch.tensor(w_complete, dtype=torch.float32) / float(hb * wb)
    wa_w, wb_w = wa_w.to(dev), wb_w.to(dev)

    axs, ays = _coord_grids(ha, wa, dev)
    bxs, bys = _coord_grids(hb, wb, dev)
    annx, anny = ann[..., 0].long(), ann[..., 1].long()
    bnnx, bnny = bnn[..., 0].long(), bnn[..., 1].long()

    # --- direction A: pixel p collects payload_b[ann[p+o] - o] for every o
    cat_a = torch.cat(
        [torch.roll(payload, shifts=(dy, dx), dims=(0, 1))
         for dx, dy in offsets], dim=-1,
    ).reshape(hb * wb, k * p)
    g_cat = cat_a[anny * wb + annx]                        # [Ha, Wa, K*P]

    acc = torch.zeros((ha, wa, p), dtype=torch.float32, device=dev)
    wacc = torch.zeros((ha, wa), dtype=torch.float32, device=dev)
    for j, (dx, dy) in enumerate(offsets):
        m_b = ((annx - dx >= 0) & (annx - dx < wb)
               & (anny - dy >= 0) & (anny - dy < hb))
        valid_a = ((axs + dx >= 0) & (axs + dx < wa)
                   & (ays + dy >= 0) & (ays + dy < ha))
        valid = valid_a & torch.roll(m_b, shifts=(-dy, -dx), dims=(0, 1))
        g = torch.roll(g_cat[..., j * p:(j + 1) * p], shifts=(-dy, -dx),
                       dims=(0, 1))
        vw = valid.float() * wa_w
        acc = acc + g * vw[..., None]
        wacc = wacc + vw

    # --- direction B: pixel b pushes payload_b[b+o] onto a-target bnn[b]+o
    vals = []
    for dx, dy in offsets:
        src = torch.roll(payload, shifts=(-dy, -dx), dims=(0, 1))
        valid_b = ((bxs + dx >= 0) & (bxs + dx < wb)
                   & (bys + dy >= 0) & (bys + dy < hb))
        tx = bnnx + dx
        ty = bnny + dy
        valid = valid_b & (tx >= 0) & (tx < wa) & (ty >= 0) & (ty < ha)
        vw = valid.float() * wb_w                           # [Hb, Wb]
        vals.append(torch.cat([src * vw[..., None], vw[..., None]], dim=-1))
    val_cat = torch.cat(vals, dim=-1).reshape(hb * wb, k * (p + 1))

    bnn_flat = (bnny * wa + bnnx).reshape(-1)
    order = torch.argsort(bnn_flat, stable=True)
    tab = torch.zeros((ha * wa, k * (p + 1)), dtype=torch.float32, device=dev)
    tab.index_put_((bnn_flat[order],), val_cat[order], accumulate=True)
    tab = tab.reshape(ha, wa, k, p + 1)
    for j, (dx, dy) in enumerate(offsets):
        blk = torch.roll(tab[..., j, :], shifts=(dy, dx), dims=(0, 1))
        acc = acc + blk[..., :p]
        wacc = wacc + blk[..., p]

    voted = torch.where(wacc[..., None] > 0,
                        acc / torch.clamp(wacc, min=1e-20)[..., None], 0.0)
    return voted, wacc


def bds_reconstruct_color(
    b_img_u8: torch.Tensor,
    ann: torch.Tensor,
    bnn: torch.Tensor,
    w_cohere: float = 1.0,
    w_complete: float = 2.0,
    patch_size: int = 3,
) -> torch.Tensor:
    """Guidance image on A's grid from B's colours: uint8 [Ha, Wa, 3],
    floored (the reference truncates the weighted mean into uchar)."""
    voted, _ = bds_vote(b_img_u8.float(), ann, bnn, w_cohere, w_complete,
                        patch_size)
    return torch.clamp(torch.floor(voted), 0, 255).to(torch.uint8)
