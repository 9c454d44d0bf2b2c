"""PatchMatch dense correspondence search, and the patch helpers shared by
the NN search, window refine and BDS vote (port of
``nct_tpu/ops/patchmatch.py``).

The search refines an NNF a -> b by fixed-count iterations of jump-flooding
propagation (jumps 8, 4, 2, 1 in the directions left, right, up, down) and
exponentially shrinking random search.  Each candidate set is a synchronous
sweep over the whole field, improved with a strict ``<`` in that order, so
the result is deterministic given the random-search uniforms, which are an
input (``uniforms=``) so that a test can feed JAX's draws.  It runs plain
PyTorch ops on any device: the JAX version is XLA, not a Pallas kernel.

The distance is the masked cosine patch distance on L2-normalized features,
``-<A patch, B patch> / #valid taps`` (1.0 where no tap is valid), with the
products of the (bf16-rounded, when the features are bf16) operands taken
and summed in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def patch_offsets(patch_size: int) -> list[tuple[int, int]]:
    """(dx, dy) taps, dy-major over [-ps/2, ps/2]."""
    half = patch_size // 2
    return [
        (dx, dy)
        for dy in range(-half, patch_size - half)
        for dx in range(-half, patch_size - half)
    ]


# Propagation: dir (dx, dy) means cand[p] = nnf[p - d*j] + d*j.
_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))
_JUMPS = (8, 4, 2, 1)


def patchify(feat: torch.Tensor, patch_size: int):
    """[..., H,W,C] -> ([..., H,W,K,C] zero-padded patch stack, [H,W,K]
    validity); leading axes are a batch."""
    h, w = feat.shape[-3], feat.shape[-2]
    half = patch_size // 2
    padded = F.pad(feat, (0, 0, half, half, half, half))
    mask = F.pad(torch.ones((h, w), dtype=feat.dtype, device=feat.device),
                 (half, half, half, half))
    stack, mstack = [], []
    for dx, dy in patch_offsets(patch_size):
        stack.append(padded[..., half + dy:half + dy + h,
                            half + dx:half + dx + w, :])
        mstack.append(mask[half + dy:half + dy + h, half + dx:half + dx + w])
    return torch.stack(stack, dim=-2), torch.stack(mstack, dim=2)


def random_search_mags(rs_max: int, bh: int, bw: int) -> list[int]:
    """Exponentially decreasing search radii, from min(rs_max, max(bh, bw))
    halving down to 1."""
    mags = []
    m = min(rs_max, max(bh, bw))
    while m >= 1:
        mags.append(m)
        m //= 2
    return mags


def _eval_candidates(pa, pam, pb_flat, pbm_flat, cand, valid, wb: int):
    """Masked cosine patch distance for a candidate field.

    pa/pam: patchified A [..., Ha,Wa,K*C] f32 / [Ha,Wa,K]; pb_flat/pbm_flat:
    patchified B [B*Hb*Wb,K*C] (the bucket's tables folded into rows) /
    [Hb*Wb,K]; cand [..., Ha,Wa,2] int32 (x, y); valid [..., Ha,Wa] bool
    (+inf where False).  With a leading batch axis, item i's candidates
    index rows i*Hb*Wb on, and each item's row sums run as one call of its
    own: a sum's order on the card follows the number of rows it covers,
    so a batched sum would give other bits than the item's single call.
    """
    nb = pbm_flat.shape[0]
    local = torch.clamp(cand[..., 1].long() * wb + cand[..., 0].long(), 0,
                        nb - 1)
    flat = local
    if cand.dim() == 4:
        flat = local + torch.arange(cand.shape[0], device=cand.device)[
            :, None, None] * nb
    prod = pa * pb_flat[flat].float()
    if cand.dim() == 4:
        num = -torch.stack([p.sum(-1) for p in prod])
    else:
        num = -prod.sum(-1)
    cnt = (pam * pbm_flat[local]).sum(-1)
    d = torch.where(cnt > 0, num / torch.clamp(cnt, min=1.0), 1.0)
    return torch.where(valid, d, float("inf"))


def patchmatch(a_norm: torch.Tensor, b_norm: torch.Tensor,
               nnf0: torch.Tensor, uniforms: torch.Tensor | None = None,
               iters: int = 10, rs_max: int = 32, patch_size: int = 3,
               generator: torch.Generator | None = None):
    """Refine the NNF a -> b.  Returns (nnf [Ha,Wa,2] int32, annd [Ha,Wa]
    f32).

    a_norm/b_norm: L2-normalized features [H,W,C] (float32 or bfloat16);
    nnf0 [Ha,Wa,2] int32 (x, y).  ``uniforms``: the random-search draws
    [iters, n_mags, Ha, Wa, 2] in [0, 1), n_mags =
    max(len(random_search_mags(rs_max, Hb, Wb)), 1); by default drawn on
    the CPU from ``generator`` (or the global generator).

    Batched (the counterpart of ``jax.vmap``): a_norm [B,Ha,Wa,C], b_norm
    [B,Hb,Wb,C], nnf0 [B,Ha,Wa,2] and uniforms [B, iters, n_mags, Ha, Wa,
    2]; every sweep runs once over the bucket, propagation rolls each
    item's own (H, W) axes, and item i's result is bitwise its own call.
    """
    ha, wa = a_norm.shape[-3], a_norm.shape[-2]
    hb, wb = b_norm.shape[-3], b_norm.shape[-2]
    lead = tuple(a_norm.shape[:-3])
    dev = a_norm.device

    pa, pam = patchify(a_norm, patch_size)
    pb, pbm = patchify(b_norm, patch_size)
    k, c = pb.shape[-2], pb.shape[-1]
    pa = pa.reshape(lead + (ha, wa, k * c)).float()
    pam = pam.float()
    pb_flat = pb.reshape(-1, k * c)
    pbm_flat = pbm.reshape(hb * wb, k).float()

    ys = torch.arange(ha, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(wa, dtype=torch.int32, device=dev)[None, :]
    mags = random_search_mags(rs_max, hb, wb)
    shape = lead + (iters, max(len(mags), 1), ha, wa, 2)
    if uniforms is None:
        uniforms = torch.rand(shape, generator=generator)
    if tuple(uniforms.shape) != shape:
        raise ValueError(f"uniforms: expected {shape}, got "
                         f"{tuple(uniforms.shape)}")
    uniforms = uniforms.to(device=dev, dtype=torch.float32)

    def evaluate(cand, valid):
        return _eval_candidates(pa, pam, pb_flat, pbm_flat, cand, valid, wb)

    nnf = nnf0.to(device=dev, dtype=torch.int32).expand(lead + (ha, wa, 2))
    dbest = evaluate(nnf, torch.ones((ha, wa), dtype=torch.bool, device=dev))

    def improve(cand, valid):
        nonlocal nnf, dbest
        d = evaluate(cand, valid)
        better = d < dbest
        nnf = torch.where(better[..., None], cand, nnf)
        dbest = torch.where(better, d, dbest)

    for it in range(iters):
        for j in _JUMPS:
            for dx, dy in _DIRS:
                jx, jy = dx * j, dy * j
                src = torch.roll(nnf, shifts=(jy, jx), dims=(-3, -2))
                cand_x = src[..., 0] + jx
                cand_y = src[..., 1] + jy
                valid = ((xs - jx >= 0) & (xs - jx < wa)
                         & (ys - jy >= 0) & (ys - jy < ha)
                         & (cand_x >= 0) & (cand_x < wb)
                         & (cand_y >= 0) & (cand_y < hb))
                improve(torch.stack([cand_x, cand_y], dim=-1), valid)
        # with no radius (rs_max < 1) the search is skipped, as JAX's mag-0
        # placeholder never improves; its uniforms go unused
        for mi, mag in enumerate(mags):
            u = uniforms[..., it, mi, :, :, :]
            xb, yb = nnf[..., 0], nnf[..., 1]
            xmin = torch.clamp(xb - mag, min=0)
            xmax = torch.clamp(xb + mag + 1, max=wb)
            ymin = torch.clamp(yb - mag, min=0)
            ymax = torch.clamp(yb + mag + 1, max=hb)
            cx = xmin + (u[..., 0] * (xmax - xmin).float()).to(torch.int32)
            cy = ymin + (u[..., 1] * (ymax - ymin).float()).to(torch.int32)
            cand = torch.stack([torch.clamp(cx, 0, wb - 1),
                                torch.clamp(cy, 0, hb - 1)], dim=-1)
            improve(cand, torch.ones_like(dbest, dtype=torch.bool))
    return nnf, dbest
