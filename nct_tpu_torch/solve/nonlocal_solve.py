"""Non-local + local regularized least squares on the (a, b) coefficient
maps (port of ``nct_tpu/solve/nonlocal_solve.py``).

The normal equations A^T A x = A^T b of the reference's rows

  * data:      sqrt(w_i * normFactor) * (a_i * s_i + b_i  =  r_i)
  * local:     g_e * (u_j - u_i) = 0 per 4-neighbour edge, twice per edge
  * nonlocal:  sqrt(w_ij * w_nl / k) * (u_i - u_j) = 0 per directed k-NN pair

are applied matrix-free and solved by PCG with the geometric-multigrid
V-cycle or the 2x2 block-Jacobi preconditioner.  By default the transpose
half of the graph term uses in-edge tables built once per solve.  Slot-keyed
tables (graphs from ``knn_graph``, which gives candidate slots) list each
candidate slot's strongest incoming pairs up to a width of 1.5x the mean
in-degree (raised above ``in_cap`` when needed, so the cap never drops most
of the graph); pixel-keyed tables (graphs without slots) list each pixel's
first 2k.  Overflow is zeroed on both sides so the operator stays
symmetric.  ``transpose="scatter"`` applies the exact uncapped transpose by
a scatter-add instead: each pair deposits at its target slot, every slot's
deposits add in float64 and round once, and the slot sums land on their
candidate pixels as the tables' do (graphs without slots deposit at target
pixels in float32).  Scatter-adds are ``index_put_(accumulate=True)``,
sorted and deterministic on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nct_tpu_torch.ops.fmath import pow32, sqrt32
from nct_tpu_torch.solve.cg import cg_solve, cg_solve_grouped


def gradient_weights(lab_unit_l: torch.Tensor, lam: float, alpha: float,
                     band=None):
    """Edge weights g = sqrt(lam / (|dL|^alpha + 1e-4)).

    lab_unit_l [..., H, W] luminance in [0, 1].  Returns (gx, gy) [..., H,
    W]: gx weighs edge (x,y)-(x+1,y) (zero on the last column), gy edge
    (x,y)-(x,y+1) (zero on the last row).  With ``band`` (a
    ``parallel.mesh.RowBand``) the rows are one band's and gy's last row
    reads the band below through a one-row halo.
    """
    l = lab_unit_l.float()
    dx = torch.abs(l[..., :, 1:] - l[..., :, :-1])
    bottom = 0
    if band is not None:
        ext, _, bottom = band.halo(l, 0, 1, dim=-2)
        dy = torch.abs(ext[..., 1:, :] - ext[..., :-1, :])
    else:
        dy = torch.abs(l[..., 1:, :] - l[..., :-1, :])
    gx = sqrt32(lam / (pow32(dx, alpha) + 1e-4))
    gy = sqrt32(lam / (pow32(dy, alpha) + 1e-4))
    return F.pad(gx, (0, 1)), F.pad(gy, (0, 0, 0, 1 - bottom))


def laplacian_apply(u: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
                    band=None):
    """sum_j w_ij (u_i - u_j) on the 4-neighbour grid; u [..., H, W, C],
    wx/wy [..., H, W] edge weights (to x+1 / y+1).

    With ``band``: u and wx hold one band's rows, ``wy`` the band's rows
    below the row above it (``band.halo(wy, 1, 0, dim=-2)``), and u's
    edge rows come from a one-row halo; every element adds its terms in
    the whole grid's order, so the band is those rows bit for bit."""
    wx3, wy3 = wx[..., None], wy[..., None]
    out = torch.zeros_like(u)
    dxe = (u[..., :, :-1, :] - u[..., :, 1:, :]) * wx3[..., :, :-1, :]
    out[..., :, :-1, :] += dxe
    out[..., :, 1:, :] += -dxe
    if band is None:
        dye = (u[..., :-1, :, :] - u[..., 1:, :, :]) * wy3[..., :-1, :, :]
        out[..., :-1, :, :] += dye
        out[..., 1:, :, :] += -dye
        return out
    rows = u.shape[-3]
    ext, top, bottom = band.halo(u, 1, 1)
    dye = ((ext[..., :-1, :, :] - ext[..., 1:, :, :])
           * wy3[..., :ext.shape[-3] - 1, :, :])
    down = rows - 1 + bottom
    out[..., :down, :, :] += dye[..., top:top + down, :, :]
    out[..., 1 - top:, :, :] += -dye[..., :rows - 1 + top, :, :]
    return out


def laplacian_degree(wx: torch.Tensor, wy: torch.Tensor, band=None):
    """Diagonal of the grid Laplacian: sum of incident edge weights (with
    ``band``, wy as ``laplacian_apply`` takes it)."""
    deg = torch.zeros_like(wx)
    deg[..., :, :-1] += wx[..., :, :-1]
    deg[..., :, 1:] += wx[..., :, :-1]
    if band is None:
        deg[..., :-1, :] += wy[..., :-1, :]
        deg[..., 1:, :] += wy[..., :-1, :]
        return deg
    rows = wx.shape[-2]
    # the rows ``band.halo`` adds: none for a band of zero rows
    top = 1 if rows and band.start > 0 else 0
    down = rows - 1 + (1 if rows and band.stop < band.h else 0)
    deg[..., :down, :] += wy[..., top:top + down, :]
    deg[..., 1 - top:, :] += wy[..., :rows - 1 + top, :]
    return deg


def _coarsen_cellsum(x: torch.Tensor) -> torch.Tensor:
    """2x2 cell sum of x [..., H, W, C] with zero padding to even dims."""
    h, w = x.shape[-3], x.shape[-2]
    ph, pw = (-h) % 2, (-w) % 2
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    h2, w2 = (h + ph) // 2, (w + pw) // 2
    return x.reshape(x.shape[:-3] + (h2, 2, w2, 2, x.shape[-1])).sum(
        dim=(-4, -2))


def _prolong_const(xc: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Piecewise-constant prolongation (adjoint of _coarsen_cellsum)."""
    x = torch.repeat_interleave(torch.repeat_interleave(xc, 2, dim=-3), 2,
                                dim=-2)
    return x[..., :h, :w, :]


# V-cycle shape: coarsen until the grid's short side is <= _COARSEST or
# _MAX_LEVELS levels exist; _COARSE_SWEEPS symmetric sweeps at the bottom.
_COARSEST = 8
_COARSE_SWEEPS = 8
_MAX_LEVELS = 8


def _prolong_rows(xc: torch.Tensor, y0: int, rows: int,
                  w: int) -> torch.Tensor:
    """Rows [y0, y0 + rows) of ``_prolong_const`` of a whole coarse grid."""
    x = xc[..., y0 // 2:(y0 + rows - 1) // 2 + 1, :, :]
    x = torch.repeat_interleave(torch.repeat_interleave(x, 2, dim=-3), 2,
                                dim=-2)
    return x[..., y0 % 2:y0 % 2 + rows, :w, :]


def make_mg_preconditioner(blk_aa, blk_ab, blk_bb, wx2, wy2, band=None):
    """Geometric-multigrid V-cycle approximating the inverse of
    [[blk_aa, blk_ab], [blk_ab, blk_bb]] ([..., H, W, 3] per-pixel blocks)
    plus the grid Laplacian with edge weights wx2/wy2 [..., H, W] on a and
    b.  Leading axes are independent systems (a batch).

    Piecewise-constant prolongation P, restriction P^T / 4, Galerkin coarse
    coefficients, red-black block Gauss-Seidel smoothing, symmetric pre- and
    post-smoothing: a fixed SPD operator, so PCG stays valid.

    With ``band`` (a ``parallel.mesh.RowBand``; the operands one band's
    rows) the fine levels coarsen band by band while every band starts on
    an even row (``RowBand.coarsen``), each colour of a sweep and each
    residual taking a one-row halo; the first level that cannot is
    gathered whole, and it and every coarser level run on every rank.
    Every element is computed as on the whole grid, so the V-cycle is the
    whole one's rows bit for bit.
    """
    levels, bands = [], []
    caa, cab, cbb = blk_aa, blk_ab, blk_bb
    cwx, cwy = wx2, wy2
    b = band
    while True:
        h, w = caa.shape[-3], caa.shape[-2]
        wy_ext = cwy if b is None else b.halo(cwy, 1, 0, dim=-2)[0]
        deg = laplacian_degree(cwx, wy_ext, b)[..., None]
        daa = caa + deg
        dbb = cbb + deg
        inv_det = 1.0 / (daa * dbb - cab * cab)
        levels.append((caa, cab, cbb, cwx, wy_ext, daa, dbb, inv_det))
        bands.append(b)
        h_all = h if b is None else b.h
        if min(h_all, w) <= _COARSEST or len(levels) >= _MAX_LEVELS:
            break
        if b is not None:
            b = b.coarsen()
            if b is None:
                band_fine = bands[-1]
                caa, cab, cbb = (band_fine.gather(t) for t in (caa, cab, cbb))
                cwx, cwy = (band_fine.gather(t, -2) for t in (cwx, cwy))
                h = h_all
        caa = 0.25 * _coarsen_cellsum(caa)
        cab = 0.25 * _coarsen_cellsum(cab)
        cbb = 0.25 * _coarsen_cellsum(cbb)
        # fine x-edges crossing a coarse column boundary sit at odd x; the
        # two fine rows feeding one coarse row pair-sum along y (and vice
        # versa for y-edges)
        ph, pw = (-h) % 2, (-w) % 2
        fx = F.pad(cwx, (0, pw, 0, ph))[..., :, 1::2]
        cwx = 0.25 * fx.reshape(
            fx.shape[:-2] + ((h + ph) // 2, 2, fx.shape[-1])).sum(dim=-2)
        fy = F.pad(cwy, (0, pw, 0, ph))[..., 1::2, :]
        cwy = 0.25 * fy.reshape(
            fy.shape[:-1] + ((w + pw) // 2, 2)).sum(dim=-1)

    masks = []
    for lev, bl in zip(levels, bands):
        h, w = lev[0].shape[-3], lev[0].shape[-2]
        y0 = 0 if bl is None else bl.start
        yy = torch.arange(y0, y0 + h, device=lev[0].device)[:, None]
        xx = torch.arange(w, device=lev[0].device)[None, :]
        masks.append((((yy + xx) % 2 == 0).float())[..., None])

    def level_apply(lev, xa, xb):
        caa, cab, cbb, cwx, cwy, _, _, _ = levels[lev]
        if bands[lev] is None:
            return (caa * xa + cab * xb + laplacian_apply(xa, cwx, cwy),
                    cab * xa + cbb * xb + laplacian_apply(xb, cwx, cwy))
        # one halo for both: the Laplacian is elementwise over channels
        lap = laplacian_apply(torch.cat([xa, xb], dim=-1), cwx, cwy,
                              bands[lev])
        c = xa.shape[-1]
        return (caa * xa + cab * xb + lap[..., :c],
                cab * xa + cbb * xb + lap[..., c:])

    def half_sweep(lev, xa, xb, fa, fb, mask):
        """Exact block-GS update of one checkerboard colour."""
        _, cab, _, _, _, daa, dbb, inv_det = levels[lev]
        ma, mb = level_apply(lev, xa, xb)
        ra, rb = fa - ma, fb - mb
        return (xa + mask * inv_det * (dbb * ra - cab * rb),
                xb + mask * inv_det * (daa * rb - cab * ra))

    def smooth(lev, xa, xb, fa, fb, reverse):
        m = masks[lev]
        first, second = (1.0 - m, m) if reverse else (m, 1.0 - m)
        xa, xb = half_sweep(lev, xa, xb, fa, fb, first)
        return half_sweep(lev, xa, xb, fa, fb, second)

    def vcycle(lev, fa, fb):
        _, cab, _, _, _, daa, dbb, inv_det = levels[lev]
        if lev == len(levels) - 1:
            xa, xb = torch.zeros_like(fa), torch.zeros_like(fb)
            for i in range(_COARSE_SWEEPS):
                xa, xb = smooth(lev, xa, xb, fa, fb, reverse=bool(i % 2))
            return xa, xb
        # pre-smooth from zero: the first half-sweep is a masked block solve
        m = masks[lev]
        xa = m * inv_det * (dbb * fa - cab * fb)
        xb = m * inv_det * (daa * fb - cab * fa)
        xa, xb = half_sweep(lev, xa, xb, fa, fb, 1.0 - m)
        ma, mb = level_apply(lev, xa, xb)
        ra, rb = fa - ma, fb - mb
        here, below = bands[lev], bands[lev + 1]
        if here is not None and below is None:
            c = ra.shape[-1]
            both = here.gather(torch.cat([ra, rb], dim=-1))
            ra, rb = both[..., :c], both[..., c:]
        ea, eb = vcycle(lev + 1, 0.25 * _coarsen_cellsum(ra),
                        0.25 * _coarsen_cellsum(rb))
        h, w = fa.shape[-3], fa.shape[-2]
        if here is not None and below is None:
            xa = xa + _prolong_rows(ea, here.start, h, w)
            xb = xb + _prolong_rows(eb, here.start, h, w)
        else:
            xa = xa + _prolong_const(ea, h, w)
            xb = xb + _prolong_const(eb, h, w)
        return smooth(lev, xa, xb, fa, fb, reverse=True)

    def precond(res):
        return vcycle(0, res[0], res[1])

    return precond


def in_edge_width(n_pairs: int, n_slots: int, in_cap: int) -> int:
    """In-edge table width: 1.5x the mean in-degree per slot, never clamped
    below that by ``in_cap``; ``in_cap >= n_pairs`` asks for the exact
    (uncapped) operator."""
    if in_cap >= n_pairs:
        return n_pairs
    mean_in = -(-n_pairs // n_slots)
    headroom = (3 * mean_in + 1) // 2
    return min(max(8, headroom), max(in_cap, headroom), n_pairs)


# Pair count above which ``transpose="auto"`` picks the scatter transpose:
# never, as in the JAX package (tables at every real size).
_TABLES_MAX_PAIRS = 1 << 62

PRECOND_KINDS = ("mg", "block_jacobi")
TRANSPOSES = ("auto", "tables", "scatter")


def nonlocal_apply(u: torch.Tensor, nbr_ids: torch.Tensor,
                   nbr_w: torch.Tensor) -> torch.Tensor:
    """k-NN graph Laplacian over directed pairs: u [N, C]; nbr_ids [N, k];
    nbr_w [N, k] per-pair weight.  Each pair (i -> j) adds w (u_i - u_j) at
    i and w (u_j - u_i) at j."""
    n, c = u.shape
    k = nbr_ids.shape[1]
    ids = nbr_ids.long()
    diff = (u[:, None, :] - u[ids]) * nbr_w[..., None]
    out = torch.sum(diff, dim=1)
    out.index_put_((ids.reshape(-1),), -diff.reshape(n * k, c),
                   accumulate=True)
    return out


def nonlocal_degree(nbr_ids: torch.Tensor, nbr_w: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Diagonal of the directed-pair k-NN Laplacian, [N]."""
    deg = torch.sum(nbr_w, dim=1)
    deg.index_put_((nbr_ids.reshape(-1).long(),), nbr_w.reshape(-1),
                   accumulate=True)
    return deg


def _slot_sums(slots: torch.Tensor, vals: torch.Tensor,
               n_slots: int) -> torch.Tensor:
    """Every slot's deposits in float64: slots [L] (folded slot of each
    pair), vals [L] or [L, C] float32, added in pair order.  A float64 sum
    of m float32 terms is exact while their exponents span under 29 -
    log2(m) bits, and then any split of the pairs (row bands) adds to the
    same bits; beyond that a split may round a sum differently, which
    shows after the one rounding to float32 only near a halfway point."""
    out = vals.new_zeros((n_slots,) + tuple(vals.shape[1:]),
                         dtype=torch.float64)
    out.index_put_((slots,), vals.double(), accumulate=True)
    return out


def _rank_in_targets(flat_t: torch.Tensor, sort_key: torch.Tensor):
    """Sort each row's pairs by ``sort_key`` (stable) and rank them among
    the pairs of the same target.  flat_t, sort_key [G, L]: G independent
    graphs (the batch) of L pairs.  Returns (order, sorted targets, rank),
    each [G, L], row-local."""
    g, l = flat_t.shape
    dev = flat_t.device
    order = torch.argsort(sort_key, dim=1, stable=True)
    sorted_t = torch.gather(flat_t, 1, order)
    pos = torch.arange(l, device=dev).expand(g, l)
    is_start = torch.cat([torch.ones((g, 1), dtype=torch.bool, device=dev),
                          sorted_t[:, 1:] != sorted_t[:, :-1]], dim=1)
    seg_first = torch.cummax(torch.where(is_start, pos, 0), dim=1).values
    return order, sorted_t, pos - seg_first


def make_nonlocal_system(src_lab, ref_lab, confidence, nbr_ids, nbr_w,
                         norm_factor: float, local_weight: float = 0.125,
                         alpha: float = 1.2, nonlocal_weight: float = 2.0,
                         candidates=None, nbr_slots=None,
                         precond_kind: str = "mg", in_cap: int = 128,
                         transpose: str = "auto"):
    """Build (operator, rhs, preconditioner) of the normal equations for
    the k-NN graph (ids [N, k], weights [N, k]).

    precond_kind: "mg" (the multigrid V-cycle) or "block_jacobi" (the exact
    per-pixel 2x2 inverse of the diagonal blocks).  transpose: "tables"
    (in-edge tables built once: slot-keyed when ``candidates`` [K, M] and
    ``nbr_slots`` [N, k] are given, else pixel-keyed with width 2k), or
    "scatter" (the exact uncapped W^T by a scatter-add every apply), or
    "auto" ("tables" below ``_TABLES_MAX_PAIRS`` pairs).

    Batched: every operand gains a leading batch axis (src_lab [B, H, W,
    3], ids [B, N, k], candidates [B, K, M], ...) and the B systems are
    solved as one, under every option.  The grid terms, the V-cycle and the
    block-Jacobi inverse take the batch as a leading axis; the graph folds
    into the row axis (ids offset by i*N, slots by i*K*M), each item's
    in-edges ranked on its own keys (slots or pixels) and capped at its own
    width, so the table keeps each item's own pairs (the table is as wide
    as the widest item's, and each item's in-degree sums over its own
    width).  The scatter transpose deposits each pair at its folded target
    slot (or pixel): a target only ever receives its own item's pairs, in
    their order.
    """
    if precond_kind not in PRECOND_KINDS:
        raise ValueError(f"precond_kind={precond_kind!r}")
    if transpose not in TRANSPOSES:
        raise ValueError(f"transpose={transpose!r}")
    h, w = src_lab.shape[-3], src_lab.shape[-2]
    batched = src_lab.dim() == 4
    g = src_lab.shape[0] if batched else 1
    n = h * w                          # pixels per item
    dev = src_lab.device
    s = src_lab.float()
    r = ref_lab.float()
    d2 = (confidence.float() * torch.tensor(norm_factor, dtype=torch.float32)
          .to(dev))[..., None]

    gx, gy = gradient_weights(s[..., 0], local_weight, alpha)
    gx2, gy2 = gx * gx, gy * gy

    k = nbr_ids.shape[-1]
    use_slots = candidates is not None and nbr_slots is not None
    if transpose == "auto":
        transpose = "scatter" if n * k > _TABLES_MAX_PAIRS else "tables"
    # every item's graph folded into rows: pixel p of item i is row i*N + p
    goff = torch.arange(g, device=dev)[:, None]
    pair_w = (nbr_w.float() * (nonlocal_weight / k)).reshape(g * n, k)
    nbr_ids = nbr_ids.long()
    ids_local = nbr_ids.reshape(g, n * k)
    if batched:
        nbr_ids = nbr_ids + goff[..., None] * n
    nbr_ids = nbr_ids.reshape(g * n, k)
    ids_flat = nbr_ids.reshape(-1)
    if use_slots:
        n_slots = candidates.shape[-2] * candidates.shape[-1]   # per item
        slots_local = nbr_slots.long().reshape(g, n * k)
        cand_flat = candidates.long().to(dev)
        if batched:
            nbr_slots = slots_local + goff * n_slots
            cand_flat = cand_flat + goff[..., None] * n
        nbr_slots = nbr_slots.long().reshape(g * n, k)
        cand_flat = cand_flat.reshape(-1)
    n, n_pairs = g * n, g * n * k      # folded rows and pairs

    def out_gather(u):
        """u_j of every pair, [N, k, C] (through the small candidate table
        when the graph has slots)."""
        return u[cand_flat][nbr_slots] if use_slots else u[nbr_ids]

    if use_slots:
        # slot sums land on their pixels through one sorted scatter
        cs_order = torch.argsort(cand_flat, stable=True)
        cs_ids = cand_flat[cs_order]

        def land(slot_sums):
            """Slot sums [slots, ...] (float32) added onto their candidate
            pixels, each pixel's slots in slot order: [N, ...]."""
            out = slot_sums.new_zeros((n,) + tuple(slot_sums.shape[1:]))
            out.index_put_((cs_ids,), slot_sums[cs_order], accumulate=True)
            return out

    if transpose == "scatter" and use_slots:
        slots_flat = nbr_slots.reshape(-1)
        n_all_slots = g * n_slots
        in_deg = land(_slot_sums(slots_flat, pair_w.reshape(-1),
                                 n_all_slots).float())
        both_deg = (torch.sum(pair_w, dim=1) + in_deg)[:, None]

        def nl_apply(u):
            """u [N, C] -> sum_j w_ij (u_i - u_j) over both edge directions;
            each pair deposits w u_source at its target slot."""
            out_sum = torch.sum(pair_w[..., None] * out_gather(u), dim=1)
            deposits = (pair_w[..., None] * u[:, None, :]).reshape(
                n * k, u.shape[-1])
            in_sum = land(_slot_sums(slots_flat, deposits,
                                     n_all_slots).float())
            return both_deg * u - out_sum - in_sum
    elif transpose == "scatter":
        in_deg = torch.zeros(n, dtype=torch.float32, device=dev)
        in_deg.index_put_((ids_flat,), pair_w.reshape(-1), accumulate=True)
        both_deg = (torch.sum(pair_w, dim=1) + in_deg)[:, None]

        def nl_apply(u):
            """u [N, C] -> sum_j w_ij (u_i - u_j) over both edge directions;
            each pair deposits w u_source at its target pixel."""
            out_sum = torch.sum(pair_w[..., None] * out_gather(u), dim=1)
            in_sum = torch.zeros_like(u)
            in_sum.index_put_(
                (ids_flat,), (pair_w[..., None] * u[:, None, :]).reshape(
                    n * k, -1), accumulate=True)
            return both_deg * u - out_sum - in_sum
    else:
        if use_slots:
            # slot-keyed: each slot keeps its strongest in-edges first
            n_targets = n_slots
            in_max = in_edge_width(n_pairs // g, n_targets, in_cap)
            flat_t = slots_local
            sort_key = flat_t.float() * 16.0 - torch.clamp(
                pair_w.reshape(g, -1), 0.0, 15.0)
        else:
            # pixel-keyed: each target pixel keeps its first 2k in-edges
            n_targets = n // g
            in_max = min(2 * k, n_pairs // g)
            flat_t = ids_local
            sort_key = flat_t
        # rank of each pair among its item's in-edges of the same target
        order, sorted_t, rank = _rank_in_targets(flat_t, sort_key)
        # no wider than the largest in-degree: the same pairs are kept, and
        # an ample in_cap (width n*k) does not allocate [targets, n*k]; one
        # host read gives every item's own width
        widths = [min(in_max, r + 1) for r in rank.amax(dim=1).tolist()]
        in_max = max(widths)
        keep = rank < in_max
        # back to folded target and pair numbers
        per, item_targets = flat_t.shape[1], n_targets
        sorted_t = (sorted_t + goff * n_targets).reshape(-1)
        order = (order + goff * per).reshape(-1)
        keep, rank = keep.reshape(-1), rank.reshape(-1)
        n_targets = g * n_targets
        # in_tab[t, r] = flat pair index or the sentinel n*k
        in_tab = torch.full((n_targets, in_max), n * k, dtype=torch.int64,
                            device=dev)
        in_tab.view(-1).scatter_reduce_(
            0, torch.where(keep, sorted_t, n_targets - 1) * in_max
            + torch.where(keep, rank, in_max - 1),
            torch.where(keep, order, n * k), reduce="amin")
        # zero overflowed pairs on the out side too (symmetry)
        keep_by_pair = torch.zeros(n * k, dtype=torch.bool, device=dev)
        keep_by_pair[order] = keep
        pair_w = torch.where(keep_by_pair.reshape(n, k), pair_w, 0.0)
        pair_w_flat = pair_w.reshape(n * k)

        valid = in_tab < n * k
        in_tab_c = torch.clamp(in_tab, max=n * k - 1)
        in_src = torch.where(valid, in_tab_c // k, 0)
        in_w = torch.where(valid, pair_w_flat[in_tab_c], 0.0)
        # each item's target sums over a table of its own width, as its own
        # solve sums them (the card's row sum peels rows by their
        # alignment)
        target_sums = torch.cat([
            torch.sum(in_w[i * item_targets:(i + 1) * item_targets,
                           :wi].double(), dim=1)
            for i, wi in enumerate(widths)]).float()
        in_deg = land(target_sums) if use_slots else target_sums
        both_deg = (torch.sum(pair_w, dim=1) + in_deg)[:, None]

        def nl_apply(u):
            """u [N, C] -> sum_j w_ij (u_i - u_j) over both edge directions."""
            out_sum = torch.sum(pair_w[..., None] * out_gather(u), dim=1)
            in_prod = in_w[..., None] * u[in_src]
            if g == 1:
                in_sum = torch.sum(in_prod.double(), dim=1).float()
            else:
                # each item sums its targets over its own width
                in_sum = torch.cat([
                    torch.sum(in_prod[i * item_targets:(i + 1)
                                      * item_targets, :wi].double(), dim=1)
                    for i, wi in enumerate(widths)]).float()
            if use_slots:
                in_sum = land(in_sum)
            return both_deg * u - out_sum - in_sum

    def operator(x):
        a, b = x
        lin = s * a + b
        data_a = d2 * s * lin
        data_b = d2 * lin
        # local rows appear twice per edge -> factor 2
        loc_a = 2.0 * laplacian_apply(a, gx2, gy2)
        loc_b = 2.0 * laplacian_apply(b, gx2, gy2)
        nl = nl_apply(torch.cat([a.reshape(n, 3), b.reshape(n, 3)], dim=1))
        return (data_a + loc_a + nl[:, :3].reshape(a.shape),
                data_b + loc_b + nl[:, 3:].reshape(b.shape))

    rhs = (d2 * s * r, d2 * r)

    # k-NN degree of the operator's (capped, on the tables path) weights
    if use_slots:
        deg_nl = both_deg.reshape(s.shape[:-1])[..., None]
    else:
        deg_nl = nonlocal_degree(nbr_ids, pair_w, n).reshape(
            s.shape[:-1])[..., None]
    if precond_kind == "mg":
        # data blocks + k-NN degree on the diagonal, the doubled local
        # Laplacian as explicit edge weights
        precond = make_mg_preconditioner(d2 * s * s + deg_nl, d2 * s,
                                         d2 + deg_nl, 2.0 * gx2, 2.0 * gy2)
        return operator, rhs, precond

    deg = 2.0 * laplacian_degree(gx2, gy2)[..., None] + deg_nl
    return operator, rhs, _block_jacobi(d2, s, deg)


def _block_jacobi(d2, s, deg):
    """The exact per-pixel 2x2 inverse of the diagonal blocks: the data
    rows couple (a_i, b_i) as d2 [[s^2, s], [s, 1]], and both Laplacians
    (``deg``, their degree) add only to the diagonal."""
    blk_aa = d2 * s * s + deg
    blk_bb = d2 + deg
    blk_ab = d2 * s
    inv_det = 1.0 / (blk_aa * blk_bb - blk_ab * blk_ab)

    def block_jacobi(res):
        ra, rb = res
        return (inv_det * (blk_bb * ra - blk_ab * rb),
                inv_det * (blk_aa * rb - blk_ab * ra))

    return block_jacobi


def _band_keep(band, slots, key, gidx, deg, in_max: int):
    """Which of this band's pairs survive their slot's in-edge cap, ranked
    over every band: ``slots`` [L] folded slot of each pair, ``key`` its
    sort key, ``gidx`` its global pair number, ``deg`` [slots] every
    slot's in-degree over all bands.  Only pairs into slots over the cap
    travel: to rank (slot % n), which ranks them by (key, pair number) as
    the whole table does and sends the verdicts back."""
    keep = torch.ones_like(slots, dtype=torch.bool)
    if not bool((deg > in_max).any()):
        return keep
    n = band.n
    mine = torch.nonzero(deg[slots] > in_max).reshape(-1)
    dest = slots[mine] % n
    sel = [mine[dest == j] for j in range(n)]
    meta = band.exchange([torch.stack([slots[i], gidx[i]], dim=-1)
                          for i in sel])
    keys = band.exchange([key[i] for i in sel])
    counts = [m.shape[0] for m in meta]
    meta, keys = torch.cat(meta), torch.cat(keys)
    # (slot, key, pair number) order: the whole table's stable ranking
    order = torch.argsort(meta[:, 1], stable=True)
    order = order[torch.argsort(keys[order], stable=True)]
    order = order[torch.argsort(meta[order, 0], stable=True)]
    st = meta[order, 0]
    pos = torch.arange(st.shape[0], device=st.device)
    is_start = torch.ones_like(st, dtype=torch.bool)
    is_start[1:] = st[1:] != st[:-1]
    rank = pos - torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    verdict = torch.empty_like(is_start)
    verdict[order] = rank < in_max
    back = band.exchange(list(torch.split(verdict, counts)))
    for i, v in zip(sel, back):
        keep[i] = v
    return keep


def make_nonlocal_system_band(src_lab, ref_lab, confidence, nbr_ids, nbr_w,
                              norm_factor: float, local_weight: float,
                              alpha: float, nonlocal_weight: float,
                              candidates, nbr_slots, in_cap: int, band,
                              precond_kind: str = "mg",
                              transpose: str = "auto"):
    """``make_nonlocal_system`` over row bands, for a graph with candidate
    slots, either transpose and either preconditioner: src_lab, ref_lab,
    confidence and the graph (nbr_ids [..., n, k] global pixel ids,
    nbr_slots, nbr_w) hold one band's rows (``band``, a
    ``parallel.mesh.RowBand``); every rank passes the same candidates
    [..., K, M].

    With the in-edge tables ("auto", "tables") each slot keeps its
    strongest in-edges up to the whole graph's width, ranked across bands
    (``_band_keep``), so the operator is the whole one.  The scatter
    transpose keeps every pair: each band sums its own pairs' deposits per
    slot in float64.  A matvec reads the candidates' values from the ranks
    that hold them and adds the slots' in-edge sums over the bands in rank
    order (one gather of [K*M] rows per matvec); the grid terms and the
    V-cycle take one-row halos.  The block-Jacobi inverse is per pixel
    once its diagonal holds the in-edge degree summed over the bands and
    the grid degree over a halo: the whole one's rows bit for bit.  A
    leading batch axis folds into the rows as in ``make_nonlocal_system``.
    """
    if precond_kind not in PRECOND_KINDS:
        raise ValueError(f"precond_kind={precond_kind!r}")
    if transpose not in TRANSPOSES:
        raise ValueError(f"transpose={transpose!r}")
    hl, w = src_lab.shape[-3], src_lab.shape[-2]
    g = src_lab.shape[0] if src_lab.dim() == 4 else 1
    n = hl * w                         # band pixels per item
    n_all = band.h * w                 # level pixels per item
    p0 = band.start * w                # global id of the band's first pixel
    dev = src_lab.device
    s = src_lab.float()
    r = ref_lab.float()
    d2 = (confidence.float() * torch.tensor(norm_factor, dtype=torch.float32)
          .to(dev))[..., None]

    gx, gy = gradient_weights(s[..., 0], local_weight, alpha, band)
    gx2, gy2 = gx * gx, gy * gy
    gy2_ext = band.halo(gy2, 1, 0, dim=-2)[0]

    k = nbr_ids.shape[-1]
    if transpose == "auto":
        transpose = ("scatter" if n_all * k > _TABLES_MAX_PAIRS
                     else "tables")
    n_slots = candidates.shape[-2] * candidates.shape[-1]    # per item
    goff = torch.arange(g, device=dev)[:, None]
    pair_w = (nbr_w.float() * (nonlocal_weight / k)).reshape(g * n, k)
    slots_local = nbr_slots.long().reshape(g, n * k)
    slots = (slots_local + goff * n_slots).reshape(g * n, k)
    cand = candidates.long().to(dev).reshape(g, n_slots)
    cand_flat = (cand + goff * n_all).reshape(-1)            # folded ids
    cand_owner = band.owner(cand // w).reshape(-1)
    cand_local = (cand - p0 + goff * n).reshape(-1)          # where owned
    owned = cand_owner == band.r

    if transpose == "scatter":
        # the exact transpose: every pair deposits at its slot, and this
        # band's deposits add per slot in float64, in pair order
        slots_flat = slots.reshape(-1)
        slot_part = _slot_sums(slots_flat, pair_w.reshape(-1), g * n_slots)

        def in_part(u):
            # (a band of zero rows deposits nothing)
            deposits = (pair_w[..., None] * u[:, None, :]).reshape(
                g * n * k, u.shape[-1])
            return _slot_sums(slots_flat, deposits, g * n_slots)
    else:
        # the cap: the whole graph's width, every slot's in-degree over the
        # bands, and each slot's strongest in-edges kept
        in_max = in_edge_width(n_all * k, n_slots, in_cap)
        deg_in = band.reduce_sum(torch.bincount(slots.reshape(-1),
                                                minlength=g * n_slots))
        key = slots_local.float() * 16.0 - torch.clamp(
            pair_w.reshape(g, -1), 0.0, 15.0)
        gidx = (goff * (n_all * k) + p0 * k
                + torch.arange(n * k, device=dev)[None, :])
        keep = _band_keep(band, slots.reshape(-1), key.reshape(-1),
                          gidx.reshape(-1), deg_in, in_max).reshape(g, n * k)
        pair_w = torch.where(keep.reshape(g * n, k), pair_w, 0.0)
        pair_w_flat = pair_w.reshape(-1)

        # this band's in-edge table: its kept pairs ranked within each slot
        flat_t = torch.where(keep, slots_local, n_slots)
        sort_key = torch.where(keep, key, float(n_slots * 16))
        order, sorted_t, rank = _rank_in_targets(flat_t, sort_key)
        real = sorted_t < n_slots
        # (a band of zero rows holds no pairs: a table of width 1, all
        # empty)
        width = max(int(torch.where(real, rank + 1, 0).amax())
                    if rank.numel() else 0, 1)
        sentinel = g * n * k
        in_tab = torch.full((g * n_slots + 1, width), sentinel,
                            dtype=torch.int64, device=dev)
        tgt = torch.where(real, sorted_t + goff * n_slots, g * n_slots)
        in_tab[tgt.reshape(-1), torch.where(real, rank, 0).reshape(-1)] = (
            torch.where(real, order + goff * (n * k), sentinel).reshape(-1))
        in_tab = in_tab[:-1]
        valid = in_tab < sentinel
        in_src = torch.where(valid, in_tab // k, 0)
        # the sentinel reads an appended zero (a band of zero rows has no
        # pairs)
        in_w = torch.where(valid, F.pad(pair_w_flat, (0, 1))[in_tab], 0.0)
        slot_part = torch.sum(in_w.double(), dim=1)

        def in_part(u):
            # a band of zero rows reads one zero row (all masked)
            src = u if u.shape[0] else u.new_zeros((1, u.shape[-1]))
            return torch.sum((in_w[..., None] * src[in_src]).double(), dim=1)

    # slot sums over every band (rank order) land on the owned candidates
    cs_order = torch.argsort(cand_flat, stable=True)
    cs_order = cs_order[owned[cs_order]]
    cs_ids = cand_local[cs_order]
    slot_in = band.reduce_sum(slot_part).float()
    in_deg = torch.zeros(g * n, dtype=torch.float32, device=dev)
    in_deg.index_put_((cs_ids,), slot_in[cs_order], accumulate=True)
    both_deg = (torch.sum(pair_w, dim=1) + in_deg)[:, None]
    take = torch.where(owned, cand_local, 0)
    slot_ids = torch.arange(g * n_slots, device=dev)

    def nl_apply(u):
        """u [N, C] -> sum_j w_ij (u_i - u_j) over both edge directions;
        the candidates' values and the slots' in-sums from every band."""
        c = u.shape[-1]
        # a band of zero rows reads one zero row (its reads are all masked)
        src = u if u.shape[0] else u.new_zeros((1, c))
        mine = torch.where(owned[:, None], src[take], 0.0)
        parts = band.all_parts(torch.cat([mine.double(), in_part(u)],
                                         dim=-1))
        cand_u = torch.stack([p[:, :c] for p in parts])[
            cand_owner, slot_ids].float()
        in_sum_c = parts[0][:, c:]
        for p in parts[1:]:
            in_sum_c = in_sum_c + p[:, c:]
        in_sum_c = in_sum_c.float()
        out_sum = torch.sum(pair_w[..., None] * cand_u[slots], dim=1)
        in_sum = torch.zeros_like(u)
        in_sum.index_put_((cs_ids,), in_sum_c[cs_order], accumulate=True)
        return both_deg * u - out_sum - in_sum

    def operator(x):
        a, b = x
        lin = s * a + b
        data_a = d2 * s * lin
        data_b = d2 * lin
        # local rows appear twice per edge -> factor 2; one halo for both
        lap = laplacian_apply(torch.cat([a, b], dim=-1), gx2, gy2_ext, band)
        loc_a = 2.0 * lap[..., :3]
        loc_b = 2.0 * lap[..., 3:]
        nl = nl_apply(torch.cat([a.reshape(g * n, 3), b.reshape(g * n, 3)],
                                dim=1))
        return (data_a + loc_a + nl[:, :3].reshape(a.shape),
                data_b + loc_b + nl[:, 3:].reshape(b.shape))

    rhs = (d2 * s * r, d2 * r)
    # out- and in-degree of the kept pairs on the diagonal
    deg_nl = both_deg.reshape(s.shape[:-1])[..., None]
    if precond_kind == "mg":
        precond = make_mg_preconditioner(d2 * s * s + deg_nl, d2 * s,
                                         d2 + deg_nl, 2.0 * gx2, 2.0 * gy2,
                                         band)
        return operator, rhs, precond
    deg = 2.0 * laplacian_degree(gx2, gy2_ext, band)[..., None] + deg_nl
    return operator, rhs, _block_jacobi(d2, s, deg)


def solve_nonlocal(a0, b0, src_lab, ref_lab, confidence, nbr_ids, nbr_w,
                   norm_factor: float, local_weight: float = 0.125,
                   alpha: float = 1.2, nonlocal_weight: float = 2.0,
                   iters: int = 100, tol: float = 1e-6, candidates=None,
                   nbr_slots=None, precond_kind: str = "mg",
                   in_cap: int = 128, transpose: str = "auto", band=None):
    """Solve for regularized (a, b) [H, W, 3] at down-res (see
    ``make_nonlocal_system`` for the options).  Returns (a, b, iterations
    run, final ||r||^2).  With a leading batch axis on every operand the
    B systems run as one through ``cg_solve_grouped``: iterations and
    ||r||^2 are then [B] tensors, each item's own.  With ``band`` (a
    ``parallel.mesh.RowBand``; a graph with candidate slots, either
    transpose and preconditioner) every operand is one band's rows
    (``make_nonlocal_system_band``) and the dot products add over the
    bands in rank order."""
    if band is not None:
        if candidates is None or nbr_slots is None:
            raise ValueError("row bands solve graphs with candidate slots "
                             "only")
        operator, rhs, precond = make_nonlocal_system_band(
            src_lab, ref_lab, confidence, nbr_ids, nbr_w, norm_factor,
            local_weight, alpha, nonlocal_weight, candidates, nbr_slots,
            in_cap, band, precond_kind, transpose)
    else:
        operator, rhs, precond = make_nonlocal_system(
            src_lab, ref_lab, confidence, nbr_ids, nbr_w, norm_factor,
            local_weight, alpha, nonlocal_weight, candidates, nbr_slots,
            precond_kind, in_cap, transpose)
    solve = cg_solve_grouped if src_lab.dim() == 4 else cg_solve
    (a, b), r2, n_it = solve(operator, rhs, (a0.float(), b0.float()),
                             iters=iters, tol=tol, preconditioner=precond,
                             band=band)
    return a, b, n_it, r2
