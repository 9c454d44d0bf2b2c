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

from nct_tpu_torch.ops.fmath import sum_last


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


def gather_patch_rows(b_pad: torch.Tensor, cx: torch.Tensor,
                      cy: torch.Tensor, hb: int, wb: int, patch_size: int,
                      boff):
    """``patchify(b)`` rows at (cx, cy), gathered tap by tap from b
    zero-padded by patch_size // 2 (b_pad [-1, C]; item i of a batch at
    row offset ``boff``): ([..., K*C] values, [..., K] 0/1 validity).  No
    table of B's size is built."""
    half = patch_size // 2
    wp = wb + 2 * half
    vals, masks = [], []
    for dx, dy in patch_offsets(patch_size):
        ty, tx = cy + dy, cx + dx
        vals.append(b_pad[boff + (ty + half) * wp + tx + half])
        masks.append((ty >= 0) & (ty < hb) & (tx >= 0) & (tx < wb))
    v = torch.stack(vals, dim=-2)
    return (v.flatten(-2),
            torch.stack(masks, dim=-1).float())


def random_search_mags(rs_max: int, bh: int, bw: int) -> list[int]:
    """Exponentially decreasing search radii, from min(rs_max, max(bh, bw))
    halving down to 1."""
    mags = []
    m = min(rs_max, max(bh, bw))
    while m >= 1:
        mags.append(m)
        m //= 2
    return mags


def _eval_candidates(pa, pam, fetch, cand, valid):
    """Masked cosine patch distance for a candidate field.

    pa/pam: patchified A [..., Ha,Wa,K*C] f32 / [Ha,Wa,K]; ``fetch(cand)``
    gives B's patches at the candidates, ([..., Ha,Wa,K*C], [..., Ha,Wa,K]
    0/1 float); cand [..., Ha,Wa,2] int32 (x, y); valid [..., Ha,Wa] bool
    (+inf where False).  With a leading batch axis each item's row sums
    run as one call of its own: a sum's order on the card follows the
    number of rows it covers, so a batched sum would give other bits than
    the item's single call.  The whole call and a band share this body and
    differ only in ``fetch``.
    """
    pb, pbm = fetch(cand)
    prod = pa * pb.float()
    if cand.dim() == 4:
        num = -torch.stack([sum_last(p) for p in prod])
    else:
        num = -sum_last(prod)
    cnt = (pam * pbm).sum(-1)
    d = torch.where(cnt > 0, num / torch.clamp(cnt, min=1.0), 1.0)
    return torch.where(valid, d, float("inf"))


def _improve(nnf, dbest, evaluate, cand, valid):
    """Take each candidate that is strictly nearer than the incumbent."""
    d = evaluate(cand, valid)
    better = d < dbest
    return torch.where(better[..., None], cand, nnf), torch.where(better, d,
                                                                  dbest)


def _propagate(nnf, dbest, evaluate, ys, xs, ha: int, wa: int, hb: int,
               wb: int):
    """One iteration's jump-flood propagation over the rows held: ``ys``
    their global rows [rows, 1], ``ha`` the field's whole height (a
    candidate whose source row lies outside [0, ha) is masked, as the
    whole field's roll wraps it)."""
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
            nnf, dbest = _improve(nnf, dbest, evaluate,
                                  torch.stack([cand_x, cand_y], dim=-1),
                                  valid)
    return nnf, dbest


def _random_search(nnf, dbest, evaluate, u, mags, hb: int, wb: int):
    """One iteration's random search; ``u`` [..., n_mags, rows, W, 2].
    With no radius (rs_max < 1) the search is skipped, as JAX's mag-0
    placeholder never improves; its uniforms go unused."""
    for mi, mag in enumerate(mags):
        ui = u[..., mi, :, :, :]
        xb, yb = nnf[..., 0], nnf[..., 1]
        xmin = torch.clamp(xb - mag, min=0)
        xmax = torch.clamp(xb + mag + 1, max=wb)
        ymin = torch.clamp(yb - mag, min=0)
        ymax = torch.clamp(yb + mag + 1, max=hb)
        cx = xmin + (ui[..., 0] * (xmax - xmin).float()).to(torch.int32)
        cy = ymin + (ui[..., 1] * (ymax - ymin).float()).to(torch.int32)
        cand = torch.stack([torch.clamp(cx, 0, wb - 1),
                            torch.clamp(cy, 0, hb - 1)], dim=-1)
        nnf, dbest = _improve(nnf, dbest, evaluate, cand,
                              torch.ones_like(dbest, dtype=torch.bool))
    return nnf, dbest


def _uniforms(uniforms, shape, generator, dev):
    if uniforms is None:
        uniforms = torch.rand(shape, generator=generator)
    if tuple(uniforms.shape) != shape:
        raise ValueError(f"uniforms: expected {shape}, got "
                         f"{tuple(uniforms.shape)}")
    return uniforms.to(device=dev, dtype=torch.float32)


def patchmatch(a_norm: torch.Tensor, b_norm: torch.Tensor,
               nnf0: torch.Tensor, uniforms: torch.Tensor | None = None,
               iters: int = 10, rs_max: int = 32, patch_size: int = 3,
               generator: torch.Generator | None = None, band=None):
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

    With ``band`` (a ``parallel.mesh.RowBand`` of A's grid) a_norm, nnf0,
    the uniforms (given: the band's rows of the whole field's draws) and
    the result hold the band's rows, b_norm the whole other level; the
    result is those rows of the whole call bit for bit
    (``_patchmatch_band``).
    """
    if band is not None:
        if uniforms is None:
            raise ValueError("a band takes its rows of the whole field's "
                             "uniforms")
        return _patchmatch_band(a_norm, b_norm, nnf0, uniforms, iters,
                                rs_max, patch_size, band)
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
    uniforms = _uniforms(uniforms, lead + (iters, max(len(mags), 1), ha, wa,
                                           2), generator, dev)

    def fetch(cand):
        """Rows of B's tables (the bucket's folded into rows, item i's
        from i*Hb*Wb on)."""
        local = torch.clamp(cand[..., 1].long() * wb + cand[..., 0].long(),
                            0, hb * wb - 1)
        flat = local
        if lead:
            flat = local + torch.arange(lead[0], device=dev)[
                :, None, None] * (hb * wb)
        return pb_flat[flat], pbm_flat[local]

    def evaluate(cand, valid):
        return _eval_candidates(pa, pam, fetch, cand, valid)

    nnf = nnf0.to(device=dev, dtype=torch.int32).expand(lead + (ha, wa, 2))
    dbest = evaluate(nnf, torch.ones((ha, wa), dtype=torch.bool, device=dev))
    for it in range(iters):
        nnf, dbest = _propagate(nnf, dbest, evaluate, ys, xs, ha, wa, hb, wb)
        nnf, dbest = _random_search(nnf, dbest, evaluate,
                                    uniforms[..., it, :, :, :, :], mags, hb,
                                    wb)
    return nnf, dbest


# Rows one iteration's propagation reaches: the sum of the jumps.
_REACH = sum(_JUMPS)


def _patchmatch_band(a_norm, b_norm, nnf0, uniforms, iters: int,
                     rs_max: int, patch_size: int, band):
    """``patchmatch`` of one band of A's rows against the whole B.

    One iteration's propagation reads the field up to ``_REACH`` (15) rows
    away, its vertical steps one after another.  So each iteration starts
    from one halo of 15 rows each way of the current field and distances
    (one exchange instead of eight), sweeps the window of band and halo
    rows (a row whose source lies outside the window only ever spoils rows
    that many steps from the window's edge: 15 rows, the halo), keeps the
    band's rows, and searches them at random.  ``valid`` takes global
    rows, so a candidate the whole field's roll would wrap past the
    image's edge is masked here too.  A's patches of the window come from
    one 16-row halo per call; B's are gathered tap by tap from B
    (``gather_patch_rows``), with no B-sized table.  A leading batch axis
    runs as in ``patchmatch``."""
    rows, wa = a_norm.shape[-3], a_norm.shape[-2]
    ha = band.h
    hb, wb, c = b_norm.shape[-3:]
    lead = tuple(a_norm.shape[:-3])
    dev = a_norm.device
    half = patch_size // 2

    a_ext, a_top, a_bottom = band.halo(a_norm, _REACH + half,
                                       _REACH + half)
    # the field's halo rows (none for a band of zero rows)
    top = min(_REACH, a_top)
    n_win = top + rows + min(_REACH, a_bottom)
    pa, pam = patchify(a_ext, patch_size)
    k = pa.shape[-2]
    pa = pa.narrow(-4, a_top - top, n_win).reshape(
        lead + (n_win, wa, k * c)).float()
    pam = pam.narrow(0, a_top - top, n_win).float()
    del a_ext
    b_pad = F.pad(b_norm, (0, 0, half, half, half, half)).reshape(-1, c)
    pboff = (torch.arange(lead[0], device=dev)[:, None, None]
             * ((hb + 2 * half) * (wb + 2 * half)) if lead else 0)

    def fetch(cand):
        """B's patches gathered tap by tap."""
        return gather_patch_rows(
            b_pad, torch.clamp(cand[..., 0], 0, wb - 1),
            torch.clamp(cand[..., 1], 0, hb - 1), hb, wb, patch_size, pboff)

    def evaluator(pa_r, pam_r):
        return lambda cand, valid: _eval_candidates(pa_r, pam_r, fetch, cand,
                                                    valid)

    eval_window = evaluator(pa, pam)
    eval_band = evaluator(pa.narrow(-3, top, rows), pam.narrow(0, top, rows))
    ys = torch.arange(band.start - top, band.start - top + n_win,
                      dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(wa, dtype=torch.int32, device=dev)[None, :]
    mags = random_search_mags(rs_max, hb, wb)
    uniforms = _uniforms(uniforms, lead + (iters, max(len(mags), 1), rows,
                                           wa, 2), None, dev)

    nnf = nnf0.to(device=dev, dtype=torch.int32).expand(lead + (rows, wa, 2))
    dbest = eval_band(nnf, torch.ones((rows, wa), dtype=torch.bool,
                                      device=dev))
    for it in range(iters):
        state = torch.cat([nnf, dbest.view(torch.int32)[..., None]], dim=-1)
        ext, _, _ = band.halo(state, _REACH, _REACH)
        wnnf, wd = _propagate(ext[..., :2],
                              ext[..., 2].contiguous().view(torch.float32),
                              eval_window, ys, xs, ha, wa, hb, wb)
        nnf, dbest = wnnf.narrow(-3, top, rows), wd.narrow(-2, top, rows)
        nnf, dbest = _random_search(nnf, dbest, eval_band,
                                    uniforms[..., it, :, :, :, :], mags, hb,
                                    wb)
    return nnf, dbest
