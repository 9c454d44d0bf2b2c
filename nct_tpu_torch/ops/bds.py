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

``bds_vote_band`` is the vote over row bands (``parallel.mesh.RowBand``):
each rank gathers its A band's samples from the whole payload (the style
operand, gathered), and its B band's completeness samples go to the rank
that holds each target row (an exchange by owner), which adds them in
ascending global source order as the whole vote does; a one-row halo of
the forward field and of the deposit table carries the patch offsets
across band edges.  On the CPU the band's result is the whole vote's rows
bit for bit.
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
    [Ha, Wa] f32).  Batched (a leading axis B on all three): the gather
    and the scatter run once over the bucket through per-item offsets
    into one table, the scatter still sorted, so each item's sums add in
    the order of its own vote.
    """
    hb, wb, p = payload_b.shape[-3:]
    ha, wa = ann.shape[-3], ann.shape[-2]
    lead = tuple(payload_b.shape[:-3])
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
    if lead:
        boff = torch.arange(lead[0], device=dev)[:, None, None]

    # --- direction A: pixel p collects payload_b[ann[p+o] - o] for every o
    cat_a = torch.cat(
        [torch.roll(payload, shifts=(dy, dx), dims=(-3, -2))
         for dx, dy in offsets], dim=-1,
    ).reshape(-1, k * p)
    flat_a = anny * wb + annx
    if lead:
        flat_a = flat_a + boff * (hb * wb)
    g_cat = cat_a[flat_a]                                  # [Ha, Wa, K*P]

    acc = torch.zeros(lead + (ha, wa, p), dtype=torch.float32, device=dev)
    wacc = torch.zeros(lead + (ha, wa), dtype=torch.float32, device=dev)
    for j, (dx, dy) in enumerate(offsets):
        m_b = ((annx - dx >= 0) & (annx - dx < wb)
               & (anny - dy >= 0) & (anny - dy < hb))
        valid_a = ((axs + dx >= 0) & (axs + dx < wa)
                   & (ays + dy >= 0) & (ays + dy < ha))
        valid = valid_a & torch.roll(m_b, shifts=(-dy, -dx), dims=(-2, -1))
        g = torch.roll(g_cat[..., j * p:(j + 1) * p], shifts=(-dy, -dx),
                       dims=(-3, -2))
        vw = valid.float() * wa_w
        acc = acc + g * vw[..., None]
        wacc = wacc + vw

    # --- direction B: pixel b pushes payload_b[b+o] onto a-target bnn[b]+o
    vals = []
    for dx, dy in offsets:
        src = torch.roll(payload, shifts=(-dy, -dx), dims=(-3, -2))
        valid_b = ((bxs + dx >= 0) & (bxs + dx < wb)
                   & (bys + dy >= 0) & (bys + dy < hb))
        tx = bnnx + dx
        ty = bnny + dy
        valid = valid_b & (tx >= 0) & (tx < wa) & (ty >= 0) & (ty < ha)
        vw = valid.float() * wb_w                           # [Hb, Wb]
        vals.append(torch.cat([src * vw[..., None], vw[..., None]], dim=-1))
    val_cat = torch.cat(vals, dim=-1).reshape(-1, k * (p + 1))

    bnn_flat = bnny * wa + bnnx
    if lead:
        bnn_flat = bnn_flat + boff * (ha * wa)
    bnn_flat = bnn_flat.reshape(-1)
    order = torch.argsort(bnn_flat, stable=True)
    n_items = lead[0] if lead else 1
    tab = torch.zeros((n_items * ha * wa, k * (p + 1)), dtype=torch.float32,
                      device=dev)
    tab.index_put_((bnn_flat[order],), val_cat[order], accumulate=True)
    tab = tab.reshape(lead + (ha, wa, k, p + 1))
    for j, (dx, dy) in enumerate(offsets):
        blk = torch.roll(tab[..., j, :], shifts=(dy, dx), dims=(-3, -2))
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
    bands: tuple | None = None,
) -> torch.Tensor:
    """Guidance image on A's grid from B's colours: uint8 [Ha, Wa, 3] (or
    a batch), floored (the reference truncates the weighted mean into
    uchar).  ``bands`` = (band_a, band_b): the vote over row bands
    (``bds_vote_band``; ``b_img_u8`` whole, the fields and the result one
    band's rows)."""
    if bands is not None:
        voted, _ = bds_vote_band(b_img_u8.float(), ann, bnn, *bands,
                                 w_cohere, w_complete, patch_size)
    else:
        voted, _ = bds_vote(b_img_u8.float(), ann, bnn, w_cohere,
                            w_complete, patch_size)
    return torch.clamp(torch.floor(voted), 0, 255).to(torch.uint8)


def bds_vote_band(
    payload_b: torch.Tensor,
    ann: torch.Tensor,
    bnn: torch.Tensor,
    band_a,
    band_b,
    w_cohere: float = 1.0,
    w_complete: float = 2.0,
    patch_size: int = 3,
):
    """``bds_vote`` over row bands: every rank of the bands' axis passes
    the whole payload [..., Hb, Wb, P], its A band of ``ann`` [...,
    rows_a, Wa, 2] and its B band of ``bnn`` [..., rows_b, Wb, 2]
    (``band_a`` / ``band_b`` their ``RowBand``s), and gets its A band's
    rows of (voted, total weight)."""
    hb, wb, p = payload_b.shape[-3:]
    ha, wa = band_a.h, ann.shape[-2]
    rows_a, rows_b = band_a.rows, band_b.rows
    lead = tuple(payload_b.shape[:-3])
    dev = payload_b.device
    offsets = patch_offsets(patch_size)
    k = len(offsets)
    half = patch_size // 2

    payload = payload_b.float()
    flat_payload = payload.reshape(-1, p)
    wa_w = torch.tensor(w_cohere, dtype=torch.float32) / float(ha * wa)
    wb_w = torch.tensor(w_complete, dtype=torch.float32) / float(hb * wb)
    wa_w, wb_w = wa_w.to(dev), wb_w.to(dev)
    boff = (torch.arange(lead[0], device=dev)[:, None, None] if lead
            else torch.zeros((), dtype=torch.int64, device=dev))

    axs = torch.arange(wa, device=dev)[None, :].expand(rows_a, wa)
    ays = torch.arange(band_a.start, band_a.stop, device=dev)[:, None].expand(
        rows_a, wa)
    bxs = torch.arange(wb, device=dev)[None, :].expand(rows_b, wb)
    bys = torch.arange(band_b.start, band_b.stop, device=dev)[:, None].expand(
        rows_b, wb)

    # --- direction A: pixel p collects payload_b[ann[p+o] - o] for every
    # o; ann's rows p+o come from a halo (an invalid tap adds an exact 0)
    ann_ext, top, _ = band_a.halo(ann, half, half)
    acc = torch.zeros(lead + (rows_a, wa, p), dtype=torch.float32, device=dev)
    wacc = torch.zeros(lead + (rows_a, wa), dtype=torch.float32, device=dev)
    for dx, dy in offsets:
        qy = torch.clamp(ays + dy - band_a.start + top, 0,
                         ann_ext.shape[-3] - 1)
        qx = torch.clamp(axs + dx, 0, wa - 1)
        q = ann_ext[..., qy, qx, :].long()
        bx, by = q[..., 0] - dx, q[..., 1] - dy
        m_b = (bx >= 0) & (bx < wb) & (by >= 0) & (by < hb)
        valid_a = ((axs + dx >= 0) & (axs + dx < wa)
                   & (ays + dy >= 0) & (ays + dy < ha))
        valid = valid_a & m_b
        g = flat_payload[boff * (hb * wb) + torch.clamp(by, 0, hb - 1) * wb
                         + torch.clamp(bx, 0, wb - 1)]
        vw = valid.float() * wa_w
        acc = acc + g * vw[..., None]
        wacc = wacc + vw

    # --- direction B: pixel b pushes payload_b[b+o] onto a-target bnn[b]+o,
    # deposited at bnn[b] on the rank that holds that row
    bnnx, bnny = bnn[..., 0].long(), bnn[..., 1].long()
    vals = []
    for dx, dy in offsets:
        sy, sx = bys + dy, bxs + dx
        src = flat_payload[boff * (hb * wb) + torch.clamp(sy, 0, hb - 1) * wb
                           + torch.clamp(sx, 0, wb - 1)]
        valid_b = (sx >= 0) & (sx < wb) & (sy >= 0) & (sy < hb)
        tx = bnnx + dx
        ty = bnny + dy
        valid = valid_b & (tx >= 0) & (tx < wa) & (ty >= 0) & (ty < ha)
        vw = valid.float() * wb_w
        vals.append(torch.cat([src * vw[..., None], vw[..., None]], dim=-1))
    val_cat = torch.cat(vals, dim=-1).reshape(-1, k * (p + 1))
    keys = (bnny * wa + bnnx + boff * (ha * wa)).reshape(-1)
    owner = band_a.owner(bnny.expand(lead + (rows_b, wb)).reshape(-1))
    sel = [owner == j for j in range(band_a.n)]
    got_keys = band_a.exchange([keys[m] for m in sel])
    got_vals = band_a.exchange([val_cat[m] for m in sel])
    del val_cat, vals
    keys, val_cat = torch.cat(got_keys), torch.cat(got_vals)
    item, pix = keys // (ha * wa), keys % (ha * wa)
    local = item * (rows_a * wa) + pix - band_a.start * wa
    order = torch.argsort(local, stable=True)
    n_items = lead[0] if lead else 1
    tab = torch.zeros((n_items * rows_a * wa, k * (p + 1)),
                      dtype=torch.float32, device=dev)
    tab.index_put_((local[order],), val_cat[order], accumulate=True)
    del val_cat
    tab = tab.reshape(lead + (rows_a, wa, k, p + 1))
    tab, top, bottom = band_a.halo(tab, half, half, dim=-4)
    tab = torch.nn.functional.pad(
        tab, (0, 0, 0, 0, 0, 0, half - top, half - bottom))
    for j, (dx, dy) in enumerate(offsets):
        blk = torch.roll(tab[..., half - dy:half - dy + rows_a, :, j, :],
                         shifts=dx, dims=-2)
        acc = acc + blk[..., :p]
        wacc = wacc + blk[..., p]

    voted = torch.where(wacc[..., None] > 0,
                        acc / torch.clamp(wacc, min=1e-20)[..., None], 0.0)
    return voted, wacc
