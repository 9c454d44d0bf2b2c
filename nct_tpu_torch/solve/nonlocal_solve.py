"""Non-local + local regularized least squares on the (a, b) coefficient
maps (port of ``nct_tpu/solve/nonlocal_solve.py``).

The normal equations A^T A x = A^T b of the reference's rows

  * data:      sqrt(w_i * normFactor) * (a_i * s_i + b_i  =  r_i)
  * local:     g_e * (u_j - u_i) = 0 per 4-neighbour edge, twice per edge
  * nonlocal:  sqrt(w_ij * w_nl / k) * (u_i - u_j) = 0 per directed k-NN pair

are applied matrix-free and solved by PCG with the geometric-multigrid
V-cycle preconditioner.  The transpose half of the graph term uses
slot-keyed in-edge tables built once per solve: each candidate slot lists
its strongest incoming pairs up to a width of 1.5x the mean in-degree
(raised above ``in_cap`` when needed, so the cap never drops most of the
graph), and overflow is zeroed on both sides so the operator stays
symmetric.  Scatter-adds are ``index_put_(accumulate=True)``, deterministic
on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nct_tpu_torch.ops.fmath import pow32, sqrt32
from nct_tpu_torch.solve.cg import cg_solve


def gradient_weights(lab_unit_l: torch.Tensor, lam: float, alpha: float):
    """Edge weights g = sqrt(lam / (|dL|^alpha + 1e-4)).

    lab_unit_l [H, W] luminance in [0, 1].  Returns (gx, gy) [H, W]: gx
    weighs edge (x,y)-(x+1,y) (zero on the last column), gy edge
    (x,y)-(x,y+1) (zero on the last row).
    """
    l = lab_unit_l.float()
    dx = torch.abs(l[:, 1:] - l[:, :-1])
    dy = torch.abs(l[1:, :] - l[:-1, :])
    gx = sqrt32(lam / (pow32(dx, alpha) + 1e-4))
    gy = sqrt32(lam / (pow32(dy, alpha) + 1e-4))
    return F.pad(gx, (0, 1)), F.pad(gy, (0, 0, 0, 1))


def laplacian_apply(u: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor):
    """sum_j w_ij (u_i - u_j) on the 4-neighbour grid; u [H, W, C], wx/wy
    [H, W] edge weights (to x+1 / y+1)."""
    wx3, wy3 = wx[:, :, None], wy[:, :, None]
    out = torch.zeros_like(u)
    dxe = (u[:, :-1] - u[:, 1:]) * wx3[:, :-1]
    out[:, :-1] += dxe
    out[:, 1:] += -dxe
    dye = (u[:-1, :] - u[1:, :]) * wy3[:-1, :]
    out[:-1, :] += dye
    out[1:, :] += -dye
    return out


def laplacian_degree(wx: torch.Tensor, wy: torch.Tensor):
    """Diagonal of the grid Laplacian: sum of incident edge weights."""
    deg = torch.zeros_like(wx)
    deg[:, :-1] += wx[:, :-1]
    deg[:, 1:] += wx[:, :-1]
    deg[:-1, :] += wy[:-1, :]
    deg[1:, :] += wy[:-1, :]
    return deg


def _coarsen_cellsum(x: torch.Tensor) -> torch.Tensor:
    """2x2 cell sum with zero padding to even dims."""
    h, w = x.shape[0], x.shape[1]
    ph, pw = (-h) % 2, (-w) % 2
    x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pw, 0, ph))
    h2, w2 = (h + ph) // 2, (w + pw) // 2
    return x.reshape((h2, 2, w2, 2) + x.shape[2:]).sum(dim=(1, 3))


def _prolong_const(xc: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Piecewise-constant prolongation (adjoint of _coarsen_cellsum)."""
    x = torch.repeat_interleave(torch.repeat_interleave(xc, 2, dim=0), 2,
                                dim=1)
    return x[:h, :w]


# V-cycle shape: coarsen until the grid's short side is <= _COARSEST or
# _MAX_LEVELS levels exist; _COARSE_SWEEPS symmetric sweeps at the bottom.
_COARSEST = 8
_COARSE_SWEEPS = 8
_MAX_LEVELS = 8


def make_mg_preconditioner(blk_aa, blk_ab, blk_bb, wx2, wy2):
    """Geometric-multigrid V-cycle approximating the inverse of
    [[blk_aa, blk_ab], [blk_ab, blk_bb]] ([H, W, 3] per-pixel blocks) plus
    the grid Laplacian with edge weights wx2/wy2 on a and b.

    Piecewise-constant prolongation P, restriction P^T / 4, Galerkin coarse
    coefficients, red-black block Gauss-Seidel smoothing, symmetric pre- and
    post-smoothing: a fixed SPD operator, so PCG stays valid.
    """
    levels = []
    caa, cab, cbb = blk_aa, blk_ab, blk_bb
    cwx, cwy = wx2, wy2
    while True:
        h, w = caa.shape[0], caa.shape[1]
        deg = laplacian_degree(cwx, cwy)[:, :, None]
        daa = caa + deg
        dbb = cbb + deg
        inv_det = 1.0 / (daa * dbb - cab * cab)
        levels.append((caa, cab, cbb, cwx, cwy, daa, dbb, inv_det))
        if min(h, w) <= _COARSEST or len(levels) >= _MAX_LEVELS:
            break
        caa = 0.25 * _coarsen_cellsum(caa)
        cab = 0.25 * _coarsen_cellsum(cab)
        cbb = 0.25 * _coarsen_cellsum(cbb)
        # fine x-edges crossing a coarse column boundary sit at odd x; the
        # two fine rows feeding one coarse row pair-sum along y (and vice
        # versa for y-edges)
        ph, pw = (-h) % 2, (-w) % 2
        fx = F.pad(cwx, (0, pw, 0, ph))[:, 1::2]
        cwx = 0.25 * fx.reshape(((h + ph) // 2, 2) + fx.shape[1:]).sum(dim=1)
        fy = F.pad(cwy, (0, pw, 0, ph))[1::2, :]
        cwy = 0.25 * fy.reshape(
            (fy.shape[0], (w + pw) // 2, 2) + fy.shape[2:]).sum(dim=2)

    masks = []
    for lev in levels:
        h, w = lev[0].shape[0], lev[0].shape[1]
        yy = torch.arange(h, device=lev[0].device)[:, None]
        xx = torch.arange(w, device=lev[0].device)[None, :]
        masks.append((((yy + xx) % 2 == 0).float())[..., None])

    def level_apply(lev, xa, xb):
        caa, cab, cbb, cwx, cwy, _, _, _ = levels[lev]
        return (caa * xa + cab * xb + laplacian_apply(xa, cwx, cwy),
                cab * xa + cbb * xb + laplacian_apply(xb, cwx, cwy))

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
        ea, eb = vcycle(lev + 1, 0.25 * _coarsen_cellsum(fa - ma),
                        0.25 * _coarsen_cellsum(fb - mb))
        h, w = fa.shape[0], fa.shape[1]
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


def make_nonlocal_system(src_lab, ref_lab, confidence, nbr_ids, nbr_w,
                         norm_factor: float, local_weight: float = 0.125,
                         alpha: float = 1.2, nonlocal_weight: float = 2.0,
                         *, candidates, nbr_slots, in_cap: int = 128):
    """Build (operator, rhs, preconditioner) of the normal equations for
    the k-NN graph from ``knn_graph`` (candidates [K, M], slots [N, k])."""
    h, w, _ = src_lab.shape
    n = h * w
    dev = src_lab.device
    s = src_lab.float()
    r = ref_lab.float()
    d2 = (confidence.float() * torch.tensor(norm_factor, dtype=torch.float32)
          .to(dev))[..., None]

    gx, gy = gradient_weights(s[..., 0], local_weight, alpha)
    gx2, gy2 = gx * gx, gy * gy

    k = nbr_ids.shape[1]
    pair_w = nbr_w.float() * (nonlocal_weight / k)
    nbr_ids = nbr_ids.long()
    nbr_slots = nbr_slots.long()
    cand_flat = candidates.reshape(-1).long().to(dev)
    n_slots = cand_flat.shape[0]
    in_max = in_edge_width(n * k, n_slots, in_cap)

    # rank of each pair among its slot's in-edges, strongest first
    flat_t = nbr_slots.reshape(-1)
    sort_key = flat_t.float() * 16.0 - torch.clamp(pair_w.reshape(-1), 0.0,
                                                   15.0)
    order = torch.argsort(sort_key, stable=True)
    sorted_t = flat_t[order]
    pos = torch.arange(n * k, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sorted_t[1:] != sorted_t[:-1]])
    seg_first = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = pos - seg_first
    keep = rank < in_max
    # in_tab[t, r] = flat pair index or the sentinel n*k
    in_tab = torch.full((n_slots, in_max), n * k, dtype=torch.int64,
                        device=dev)
    in_tab.view(-1).scatter_reduce_(
        0, torch.where(keep, sorted_t, n_slots - 1) * in_max
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
    out_deg = torch.sum(pair_w, dim=1)
    cs_order = torch.argsort(cand_flat, stable=True)
    cs_ids = cand_flat[cs_order]
    in_deg = torch.zeros(n, dtype=torch.float32, device=dev)
    in_deg.index_put_((cs_ids,), torch.sum(in_w, dim=1)[cs_order],
                      accumulate=True)
    both_deg = (out_deg + in_deg)[:, None]

    def nl_apply(u):
        """u [N, C] -> sum_j w_ij (u_i - u_j) over both edge directions."""
        uj = u[cand_flat][nbr_slots]                       # [N, k, C]
        out_sum = torch.sum(pair_w[..., None] * uj, dim=1)
        in_sum_c = torch.sum(in_w[..., None] * u[in_src], dim=1)
        in_sum = torch.zeros_like(u)
        in_sum.index_put_((cs_ids,), in_sum_c[cs_order], accumulate=True)
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
        return (data_a + loc_a + nl[:, :3].reshape(h, w, 3),
                data_b + loc_b + nl[:, 3:].reshape(h, w, 3))

    rhs = (d2 * s * r, d2 * r)

    # multigrid preconditioner: data blocks + k-NN degree on the diagonal,
    # the doubled local Laplacian as explicit edge weights
    deg_nl = torch.sum(pair_w, dim=1)
    deg_nl.index_put_((nbr_ids.reshape(-1),), pair_w.reshape(-1),
                      accumulate=True)
    deg_nl = deg_nl.reshape(h, w)[..., None]
    precond = make_mg_preconditioner(d2 * s * s + deg_nl, d2 * s,
                                     d2 + deg_nl, 2.0 * gx2, 2.0 * gy2)
    return operator, rhs, precond


def solve_nonlocal(a0, b0, src_lab, ref_lab, confidence, nbr_ids, nbr_w,
                   norm_factor: float, local_weight: float = 0.125,
                   alpha: float = 1.2, nonlocal_weight: float = 2.0,
                   *, candidates, nbr_slots, iters: int = 100,
                   tol: float = 1e-6, in_cap: int = 128):
    """Solve for regularized (a, b) [H, W, 3] at down-res.  Returns
    (a, b, iterations run, final ||r||^2)."""
    operator, rhs, precond = make_nonlocal_system(
        src_lab, ref_lab, confidence, nbr_ids, nbr_w, norm_factor,
        local_weight, alpha, nonlocal_weight, candidates=candidates,
        nbr_slots=nbr_slots, in_cap=in_cap)
    (a, b), r2, n_it = cg_solve(operator, rhs, (a0.float(), b0.float()),
                                iters=iters, tol=tol, preconditioner=precond)
    return a, b, n_it, r2
