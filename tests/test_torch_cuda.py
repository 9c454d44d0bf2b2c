"""Tests of the port that need an NVIDIA card (marker ``cuda``).

They skip without one.  This file imports no JAX, so it runs on the card's
machine, which has none (tests/conftest.py does import JAX, hence
``--noconftest``):

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops import cuda_nn
from nct_tpu_torch.ops.exact_nn import (
    exact_nn_bidir_plain, exact_nn_plain, nn_bidir_tables_plain, prep_tables,
)

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _integer(rng, h, w, c, device):
    """{-2..2} features from a 3-vector palette: exact sums, many ties."""
    palette = rng.integers(-2, 3, (3, c))
    x = palette[rng.integers(0, 3, (h, w))].astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("shape", [((20, 30), (25, 21), 32),
                                   ((7, 9), (130, 3), 64),
                                   ((29, 43), (38, 60), 512)])
def test_kernel_bitwise_vs_plain_integer(card, shape):
    (ha, wa), (hb, wb), c = shape
    rng = np.random.default_rng(ha)
    a = _integer(rng, ha, wa, c, card)
    b = _integer(rng, hb, wb, c, card)
    before = cuda_nn.LAUNCHES["nn_bidir"]
    got = cuda_nn.exact_nn_bidir(a, b, 3)
    assert cuda_nn.LAUNCHES["nn_bidir"] == before + 1
    ref = exact_nn_bidir_plain(a, b, 3)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_kernel_random_features_tie_robust(card):
    g = torch.Generator().manual_seed(1)
    a = torch.relu(torch.randn(40, 50, 128, generator=g)).to(card)
    b = torch.relu(torch.randn(45, 44, 128, generator=g)).to(card)
    a = a / a.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    b = b / b.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    got = cuda_nn.exact_nn_bidir(a, b, 3)
    ref = exact_nn_bidir_plain(a, b, 3)
    # tensor-core sums run in another order than the f32 matmul: indices
    # agree almost everywhere and distances to f32 rounding
    for i in (0, 2):
        assert (got[i] == ref[i]).all(-1).float().mean().item() >= 0.99
        torch.testing.assert_close(got[i + 1], ref[i + 1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [((20, 30), (25, 21), 32),
                                   ((7, 9), (130, 3), 64),
                                   ((29, 43), (38, 60), 512)])
def test_directed_kernel_bitwise_vs_plain_integer(card, shape):
    (ha, wa), (hb, wb), c = shape
    rng = np.random.default_rng(ha + 1)
    a = _integer(rng, ha, wa, c, card)
    b = _integer(rng, hb, wb, c, card)
    before = cuda_nn.LAUNCHES["nn_directed"]
    got = cuda_nn.exact_nn(a, b, 3)
    assert cuda_nn.LAUNCHES["nn_directed"] == before + 1
    ref = exact_nn_plain(a, b, 3)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("integer", [True, False])
def test_directed_kernel_is_bidir_row_half(card, integer):
    """Same tile arithmetic and accumulation order: the directed instance's
    keys equal the bidirectional instance's row keys bitwise."""
    rng = np.random.default_rng(7)
    if integer:
        a = _integer(rng, 40, 50, 128, card)
        b = _integer(rng, 45, 44, 128, card)
    else:
        a = torch.relu(torch.from_numpy(
            rng.standard_normal((40, 50, 128)).astype(np.float32))).to(card)
        b = torch.relu(torch.from_numpy(
            rng.standard_normal((45, 44, 128)).astype(np.float32))).to(card)
    fa, ma = cuda_nn.padded_tables(a, 3)
    fb, mb = cuda_nn.padded_tables(b, 3)
    d_ab, i_ab = cuda_nn.nn_directed_tables(fa, ma, fb, mb)
    bidir = cuda_nn.nn_bidir_tables(fa, ma, fb, mb)
    torch.testing.assert_close(d_ab, bidir[0], rtol=0, atol=0)
    torch.testing.assert_close(i_ab, bidir[1], rtol=0, atol=0)


def _mask01(bits):
    """int32 bit masks -> the plain version's [N, 9] 0/1 columns."""
    return ((bits[:, None] >> torch.arange(9, device=bits.device)) & 1).float()


def _tables_vs_plain(fa, ma, fb, mb):
    """Both instances and the plain version on the same padded tables."""
    got = cuda_nn.nn_bidir_tables(fa, ma, fb, mb)
    got_dir = cuda_nn.nn_directed_tables(fa, ma, fb, mb)
    ref = nn_bidir_tables_plain(fa, _mask01(ma), fb, _mask01(mb))
    return got, got_dir, ref


def test_single_tile_bitwise_vs_plain(card):
    """One 128-row A tile against one 128-column B tile, integer features
    with (mostly) distinct products: every row's and column's (d, idx)
    bitwise.  A swizzle, descriptor or fragment-mapping error shows here."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.integers(-6, 7, (8, 16, 64)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-6, 7, (8, 16, 64)).astype(np.float32))
    fa, ma = cuda_nn.padded_tables(a.to(card), 3)
    fb, mb = cuda_nn.padded_tables(b.to(card), 3)
    assert fa.shape == fb.shape == (128, 576)
    got, got_dir, ref = _tables_vs_plain(fa, ma, fb, mb)
    assert ref[0].unique().numel() > 32      # products mostly distinct
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y.to(x.dtype), rtol=0, atol=0)
    for x, y in zip(got_dir, got[:2]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("c, kc_pad", [(32, 320), (7, 64)])
def test_depth_padding_bitwise(card, c, kc_pad):
    """C = 32 gives K*C = 288, zero-padded to 320 columns (C = 7: 63 -> 64,
    one depth step per tile): bitwise equal to the plain version on the
    unpadded tables."""
    rng = np.random.default_rng(c)
    a = _integer(rng, 17, 19, c, card)
    b = _integer(rng, 15, 23, c, card)
    fa, ma = cuda_nn.padded_tables(a, 3)
    fb, mb = cuda_nn.padded_tables(b, 3)
    assert fa.shape[1] == fb.shape[1] == kc_pad
    got, got_dir, _ = _tables_vs_plain(fa, ma, fb, mb)
    fa0, ma0 = prep_tables(a, 3)
    fb0, mb0 = prep_tables(b, 3)
    na, nb = fa0.shape[0], fb0.shape[0]
    ref = nn_bidir_tables_plain(fa0, ma0, fb0, mb0)
    for x, y, n in zip(got, ref, (na, na, nb, nb)):
        torch.testing.assert_close(x[:n], y.to(x.dtype), rtol=0, atol=0)
    for x, y in zip(got_dir, ref[:2]):
        torch.testing.assert_close(x[:na], y.to(x.dtype), rtol=0, atol=0)


def test_all_zero_masks_give_inf_first_index(card):
    """Rows whose masks are all 0 see +inf everywhere: key (+inf, 0), as
    JAX's first match gives; so does every column then."""
    rng = np.random.default_rng(5)
    fa, ma = cuda_nn.padded_tables(_integer(rng, 12, 20, 64, card), 3)
    fb, mb = cuda_nn.padded_tables(_integer(rng, 10, 30, 64, card), 3)
    ma = torch.zeros_like(ma)
    got, got_dir, ref = _tables_vs_plain(fa, ma, fb, mb)
    for d, i in (got[:2], got[2:], got_dir):
        assert torch.isinf(d).all() and (d > 0).all()
        assert (i == 0).all()
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y.to(x.dtype), rtol=0, atol=0)


def test_zero_patch_distance_is_positive_zero(card):
    """An all-zero patch has dots = 0 and d = -0.0 wherever cnt > 0; the
    kernel returns +0.0 (JAX compares the two equal, and the keys order
    them as one) at the plain version's first match."""
    rng = np.random.default_rng(6)
    a = torch.zeros(9, 14, 64, device=card)
    b = _integer(rng, 11, 12, 64, card)
    fa, ma = cuda_nn.padded_tables(a, 3)
    fb, mb = cuda_nn.padded_tables(b, 3)
    got, got_dir, ref = _tables_vs_plain(fa, ma, fb, mb)
    na = 9 * 14
    for d, i, rd, ri in ((got[0], got[1], ref[0], ref[1]),
                         (got_dir[0], got_dir[1], ref[0], ref[1])):
        assert (d[:na] == 0).all() and not torch.signbit(d[:na]).any()
        torch.testing.assert_close(i[:na], ri[:na].to(i.dtype), rtol=0, atol=0)
    assert not torch.signbit(got[2][got[2] == 0]).any()
    torch.testing.assert_close(got[3], ref[3].to(got[3].dtype), rtol=0, atol=0)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["pair", "batch"])
def test_zero_row_operands_launch_nothing(card, lead):
    """A row band of zero rows: both NN instances on an empty A or B table
    and ``conv3x3`` on zero output rows return results of the right
    shapes (rows of an empty B keep the key (+inf, 0)) and launch
    nothing."""
    from nct_tpu_torch.ops import conv3x3

    rng = np.random.default_rng(8)
    f, m = cuda_nn.padded_tables(_integer(rng, 6, 7, 16, card), 3)
    if lead:
        f, m = f.expand(lead + f.shape).contiguous(), m.expand(
            lead + m.shape).contiguous()
    ef, em = f[..., :0, :], m[..., :0]
    before = dict(cuda_nn.LAUNCHES)
    n = f.shape[-2]
    for fa, ma, fb, mb in ((ef, em, f, m), (f, m, ef, em), (ef, em, ef, em)):
        na, nb = fa.shape[-2], fb.shape[-2]
        d_ab, i_ab, d_ba, i_ba = cuda_nn.nn_bidir_tables(fa, ma, fb, mb)
        d_dir, i_dir = cuda_nn.nn_directed_tables(fa, ma, fb, mb)
        for d, i, rows in ((d_ab, i_ab, na), (d_ba, i_ba, nb),
                           (d_dir, i_dir, na)):
            assert tuple(d.shape) == tuple(i.shape) == lead + (rows,)
            assert torch.isinf(d).all() and (d > 0).all() and not i.any()
    assert cuda_nn.LAUNCHES == before and n > 0
    x = torch.zeros((1, 8, 2, 9), device=card)
    w = torch.ones((4, 8, 3, 3), device=card)
    conv_before = conv3x3.LAUNCHES["conv3x3"]
    y = conv3x3.conv3x3(x, w, torch.zeros(4, device=card), relu=True)
    assert tuple(y.shape) == (1, 4, 0, 9) and y.device == x.device
    assert conv3x3.LAUNCHES["conv3x3"] == conv_before


@pytest.mark.parametrize("depth,dtype", [(64, torch.float32),
                                         (576, torch.float32),
                                         (4608, torch.float32),
                                         (512, torch.bfloat16)])
def test_sum_last_does_not_depend_on_rows(card, depth, dtype):
    """``fmath.sum_last`` of the first rows of a tensor is those rows of
    its whole sum, bit for bit, for every row count: the per-pixel sums
    of a row band of a few pixels are the whole grid's."""
    from nct_tpu_torch.ops.fmath import sum_last

    g = torch.Generator().manual_seed(depth)
    x = torch.randn(40, depth, generator=g).to(card, dtype)
    want = sum_last(x, dtype=torch.float32)
    for rows in (1, 3, 4, 5, 8, 12, 15, 16, 17, 40):
        got = sum_last(x[:rows].clone(), dtype=torch.float32)
        assert torch.equal(got, want[:rows]), rows


@pytest.mark.parametrize("integer", [True, False])
def test_batched_launch_bitwise_per_item(card, integer):
    """One launch over the batch grid axis gives every item the keys of its
    own single launch, both instances, including items whose masks zero
    different rows."""
    rng = np.random.default_rng(12)
    if integer:
        a = _integer(rng, 3 * 20, 30, 32, card).reshape(3, 20, 30, 32)
        b = _integer(rng, 3 * 25, 21, 32, card).reshape(3, 25, 21, 32)
    else:
        a = torch.relu(torch.from_numpy(rng.standard_normal(
            (3, 20, 30, 32)).astype(np.float32))).to(card)
        b = torch.relu(torch.from_numpy(rng.standard_normal(
            (3, 25, 21, 32)).astype(np.float32))).to(card)
    fa, ma = cuda_nn.padded_tables(a, 3)
    fb, mb = cuda_nn.padded_tables(b, 3)
    ma[1, :150] = 0
    mb[2, 100:300] = 0
    before = dict(cuda_nn.LAUNCHES), dict(cuda_nn.LAUNCH_ITEMS)
    got = cuda_nn.nn_bidir_tables(fa, ma, fb, mb)
    got_dir = cuda_nn.nn_directed_tables(fa, ma, fb, mb)
    for name in ("nn_bidir", "nn_directed"):
        assert cuda_nn.LAUNCHES[name] == before[0][name] + 1
        assert cuda_nn.LAUNCH_ITEMS[name] == before[1][name] + 3
    for i in range(3):
        one = cuda_nn.nn_bidir_tables(fa[i], ma[i], fb[i], mb[i])
        one_dir = cuda_nn.nn_directed_tables(fa[i], ma[i], fb[i], mb[i])
        for x, y in zip(got, one):
            torch.testing.assert_close(x[i], y, rtol=0, atol=0)
        for x, y in zip(got_dir, one_dir):
            torch.testing.assert_close(x[i], y, rtol=0, atol=0)
    # the masked rows see +inf everywhere: key (+inf, 0)
    assert torch.isinf(got[0][1, :150]).all() and (got[1][1, :150] == 0).all()
    if integer:     # and the plain batched version agrees bitwise
        ref = nn_bidir_tables_plain(fa, _mask01(ma.reshape(-1)).reshape(
            3, -1, 9), fb, _mask01(mb.reshape(-1)).reshape(3, -1, 9))
        for x, y in zip(got, ref):
            torch.testing.assert_close(x, y.to(x.dtype), rtol=0, atol=0)


def test_batched_wrappers_match_single_calls(card):
    rng = np.random.default_rng(13)
    a = _integer(rng, 2 * 9, 14, 64, card).reshape(2, 9, 14, 64)
    b = _integer(rng, 2 * 11, 12, 64, card).reshape(2, 11, 12, 64)
    got = cuda_nn.exact_nn_bidir(a, b, 3)
    got_dir = cuda_nn.exact_nn(a, b, 3)
    for i in range(2):
        for x, y in zip(got, cuda_nn.exact_nn_bidir(a[i], b[i], 3)):
            torch.testing.assert_close(x[i], y, rtol=0, atol=0)
        for x, y in zip(got_dir, cuda_nn.exact_nn(a[i], b[i], 3)):
            torch.testing.assert_close(x[i], y, rtol=0, atol=0)


def test_vmap_bucket_matches_scan(card):
    """The vmap mode on the card: 2 small pairs, one nn_bidir launch of 2
    items per exact level, each item within the JAX package's batch
    contract of its scan item and with its iteration counts."""
    from nct_tpu_torch import Config, pipeline
    from nct_tpu_torch.models import vgg19
    from nct_tpu_torch.parallel.batch import make_batch_transfer

    rng = np.random.default_rng(8)
    cnt = rng.integers(0, 256, (2, 64, 80, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (2, 72, 88, 3)).astype(np.uint8)
    model = vgg19.init_params().to(card)
    config = Config()
    before = dict(cuda_nn.LAUNCHES), dict(cuda_nn.LAUNCH_ITEMS)
    got = make_batch_transfer(config, mode="vmap")(model, cnt, stl, [3, 4],
                                                   2.0)
    assert cuda_nn.LAUNCHES["nn_bidir"] == before[0]["nn_bidir"] + 4
    assert cuda_nn.LAUNCH_ITEMS["nn_bidir"] == before[1]["nn_bidir"] + 8
    _, traces = pipeline.transfer_batch(model, cnt, stl, 2.0, config,
                                        seeds=[3, 4],
                                        return_intermediates="stats")
    for i, seed in enumerate([3, 4]):
        ref, trace = pipeline.transfer_pair(model, cnt[i], stl[i], 2.0,
                                            config, seed=seed,
                                            return_intermediates="stats")
        diff = (got[i].int() - ref.int()).abs().cpu().numpy()
        assert (diff <= 2).mean() >= 0.95 and diff.mean() <= 0.5
        for key in ("nl_iters", "wls_iters"):
            assert [t[key] for t in traces[i]] == [int(t[key]) for t in trace]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batched_patchmatch_bitwise_per_item(card, dtype):
    """One PatchMatch over a batch of 3 against 3 single calls on the card:
    each item's row sums run as a call of their own, so the bits agree."""
    from nct_tpu_torch.ops.patchmatch import patchmatch, random_search_mags

    g = torch.Generator().manual_seed(5)
    a = torch.relu(torch.randn(3, 38, 57, 64, generator=g))
    b = torch.relu(torch.randn(3, 50, 80, 64, generator=g))
    a = (a / a.norm(dim=-1, keepdim=True).clamp(min=1e-12)).to(card, dtype)
    b = (b / b.norm(dim=-1, keepdim=True).clamp(min=1e-12)).to(card, dtype)
    nnf0 = torch.zeros(3, 38, 57, 2, dtype=torch.int32, device=card)
    n_mags = len(random_search_mags(32, 50, 80))
    u = torch.rand((3, 4, n_mags, 38, 57, 2), generator=g)
    nnf, d = patchmatch(a, b, nnf0, u, 4, 32)
    for i in range(3):
        one = patchmatch(a[i], b[i], nnf0[i], u[i], 4, 32)
        torch.testing.assert_close(nnf[i], one[0], rtol=0, atol=0)
        torch.testing.assert_close(d[i], one[1], rtol=0, atol=0)


def _nl_items_card(device):
    """nl_L0 and a copy with another seeded graph, stacked on the card."""
    from nct_tpu_torch.solve import knn

    d = np.load(f"{FIXTURES}/nl_L0.npz")
    rng = np.random.default_rng(6)
    h, w, _ = d["src_lab"].shape
    lab = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(np.float32))
    cands = torch.from_numpy(rng.integers(0, h * w, d["candidates"].shape))
    ids, wts, slots = knn.knn_graph(
        lab, torch.from_numpy(rng.integers(0, 10, (h, w))), cands)
    e = {"src_lab": lab, "ref_lab": torch.from_numpy(d["ref_lab"][::-1].copy()),
         "confidence": torch.from_numpy(d["confidence"]),
         "nbr_ids": ids, "nbr_w": wts}
    keys = ("src_lab", "ref_lab", "confidence", "nbr_ids", "nbr_w")
    one = [{k: torch.from_numpy(np.asarray(d[k])).to(device) for k in keys},
           {k: e[k].to(device) for k in keys}]
    return one, float(d["norm_factor"]), keys


@pytest.mark.parametrize("kw", [
    {"transpose": "scatter"},
    {"transpose": "scatter", "precond_kind": "block_jacobi"},
    {"precond_kind": "block_jacobi"},
], ids=["scatter", "bj-scatter", "bj-pixel-keyed"])
def test_folded_nonlocal_operator_bitwise_per_item(card, kw):
    """The graph folded into rows on the card: the scatter transpose (each
    target takes its own item's pairs in their order) and pixel-keyed
    tables give each item's A x and preconditioner bits."""
    from nct_tpu_torch.solve.nonlocal_solve import make_nonlocal_system

    items, nf, keys = _nl_items_card(card)
    stacked = [torch.stack([it[k] for it in items]) for k in keys]
    g = torch.Generator().manual_seed(2)
    x = tuple(torch.randn((2,) + tuple(items[0]["src_lab"].shape),
                          generator=g).to(card) for _ in range(2))
    op, _, pc = make_nonlocal_system(*stacked, nf, **kw)
    got = op(x) + pc(x)
    for i, it in enumerate(items):
        op_i, _, pc_i = make_nonlocal_system(*(it[k] for k in keys), nf,
                                             **kw)
        xi = (x[0][i], x[1][i])
        for a, b in zip(got, op_i(xi) + pc_i(xi)):
            torch.testing.assert_close(a[i], b, rtol=0, atol=0)


def test_vmap_bucket_parity_matches_scan(card):
    """The reference-parity Config in the vmap mode on the card: 2 small
    pairs, PatchMatch at every level and block-Jacobi at tol 1e-6 with no
    NN launch; each item within the batch contract of its scan item and
    with its iteration counts."""
    from nct_tpu_torch import Config, pipeline
    from nct_tpu_torch.models import vgg19

    rng = np.random.default_rng(9)
    cnt = rng.integers(0, 256, (2, 64, 80, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (2, 72, 88, 3)).astype(np.uint8)
    model = vgg19.init_params().to(card)
    config = Config.reference_parity()
    before = dict(cuda_nn.LAUNCHES)
    got, traces = pipeline.transfer_batch(model, cnt, stl, 2.0, config,
                                          seeds=[3, 4],
                                          return_intermediates="stats")
    assert cuda_nn.LAUNCHES == before
    for i, seed in enumerate([3, 4]):
        ref, trace = pipeline.transfer_pair(model, cnt[i], stl[i], 2.0,
                                            config, seed=seed,
                                            return_intermediates="stats")
        diff = (got[i].int() - ref.int()).abs().cpu().numpy()
        assert (diff <= 2).mean() >= 0.95 and diff.mean() <= 0.5
        for key in ("nl_iters", "wls_iters"):
            assert [t[key] for t in traces[i]] == [int(t[key]) for t in trace]


def test_mixed_devices_raise(card):
    a = torch.zeros(5, 6, 32, device=card)
    with pytest.raises(ValueError, match="one device"):
        cuda_nn.exact_nn_bidir(a, a.cpu(), 3)


# --- solver variants and the multi-membership graph: card against CPU -------

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
NL_ARGS = ("a0", "b0", "src_lab", "ref_lab", "confidence", "nbr_ids", "nbr_w")


def _nl_l0(device):
    d = np.load(f"{FIXTURES}/nl_L0.npz")
    return {k: torch.from_numpy(d[k]).to(device) for k in d.files}


@pytest.mark.parametrize("kw", [
    {"precond_kind": "block_jacobi"},
    {"precond_kind": "block_jacobi", "transpose": "scatter"},
    {"precond_kind": "mg", "transpose": "scatter"},
], ids=["block_jacobi", "bj-scatter", "mg-scatter"])
def test_nonlocal_solve_variants_card_vs_cpu(card, kw):
    """Same iterations (tol=0); reductions run in another order on the
    card: coefficients within 5e-5, as the CPU parity tests allow."""
    from nct_tpu_torch.solve.nonlocal_solve import solve_nonlocal

    out = []
    for dev in (card, torch.device("cpu")):
        d = _nl_l0(dev)
        a, b, it, _ = solve_nonlocal(
            *(d[k] for k in NL_ARGS), float(d["norm_factor"]), iters=10,
            tol=0.0, candidates=d["candidates"], nbr_slots=d["nbr_slots"],
            **kw)
        assert it == 10
        out.append((a.cpu(), b.cpu()))
    for x, y in zip(*out):
        torch.testing.assert_close(x, y, rtol=0, atol=5e-5)


@pytest.mark.parametrize("name", ["nl_L0", "nl_L1"])
def test_slot_scatter_operator_bitwise_across_runs_and_near_cpu(card, name):
    """The scatter transpose of a graph with slots on the card (deposits
    summed per slot in float64, landed by a sorted scatter): two builds
    and applies give the same bits, A x and both preconditioners within
    1e-5 of the CPU's (relative to the output's max magnitude)."""
    from nct_tpu_torch.solve.nonlocal_solve import make_nonlocal_system

    d = np.load(f"{FIXTURES}/{name}.npz")
    g = torch.Generator().manual_seed(5)
    x = tuple(torch.randn(d["a0"].shape, generator=g) for _ in range(2))

    def apply(dev, kind):
        args = [torch.from_numpy(d[k]).to(dev) for k in (
            "src_lab", "ref_lab", "confidence", "nbr_ids", "nbr_w",
            "candidates", "nbr_slots")]
        op, _, pre = make_nonlocal_system(
            *args[:5], float(d["norm_factor"]), candidates=args[5],
            nbr_slots=args[6], precond_kind=kind, transpose="scatter")
        xd = tuple(t.to(dev) for t in x)
        return [t.cpu() for t in op(xd) + pre(xd)]

    for kind in ("mg", "block_jacobi"):
        first, second = apply(card, kind), apply(card, kind)
        for a, b in zip(first, second):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for a, b in zip(first, apply(torch.device("cpu"), kind)):
            torch.testing.assert_close(
                a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def test_wls_jacobi_card_vs_cpu(card):
    from nct_tpu_torch.solve.wls import solve_wls

    out = []
    for dev in (card, torch.device("cpu")):
        d = _nl_l0(dev)
        a, b, it, _ = solve_wls(d["a0"], d["b0"], d["src_lab"], 0.5, 1.2,
                                iters=20, tol=0.0, precond_kind="jacobi")
        assert it == 20
        out.append((a.cpu(), b.cpu()))
    for x, y in zip(*out):
        torch.testing.assert_close(x, y, rtol=0, atol=5e-5)


def test_multi_membership_graph_card_vs_cpu(card):
    """P = 2: ids, weights and slots bitwise (float64 steps, the same exp
    polynomial and first-minimum argmins on both)."""
    from nct_tpu_torch.solve import cluster, knn

    d = np.load(f"{FIXTURES}/nl_L1.npz")
    rng = np.random.default_rng(2)
    lab = torch.from_numpy(d["src_lab"])
    h, w, _ = lab.shape
    lm = torch.from_numpy(rng.integers(0, 10, (h // 8 + 1, w // 8 + 1)))
    labels = cluster.multi_labels_for_pixels(
        lm, cluster.cluster_membership(lm, 10), h, w, 8, 2)
    cand = torch.from_numpy(d["candidates"])
    ref = knn.knn_graph(lab, labels, cand)
    got = knn.knn_graph(lab.to(card), labels.to(card), cand.to(card))
    for x, y in zip(got, ref):
        torch.testing.assert_close(x.cpu(), y, rtol=0, atol=0)


def test_single_membership_graph_card_vs_cpu(card):
    """P = 1 with unquantised colours: bitwise, ids, weights and slots."""
    from nct_tpu_torch.solve import knn

    d = np.load(f"{FIXTURES}/nl_L1.npz")
    rng = np.random.default_rng(3)
    lab = torch.from_numpy(d["src_lab"])
    labels = torch.from_numpy(rng.integers(0, 10, lab.shape[:2]))
    cand = torch.from_numpy(d["candidates"])
    ref = knn.knn_graph(lab, labels, cand)
    got = knn.knn_graph(lab.to(card), labels.to(card), cand.to(card))
    for x, y in zip(got, ref):
        torch.testing.assert_close(x.cpu(), y, rtol=0, atol=0)


# --- determinism, the PNG codec and SSIM on the card ------------------------

def test_transfer_pair_warm_runs_bitwise(card):
    """Two warm runs of the same pair give the same bits (sorted scatters,
    no atomics on floats)."""
    from nct_tpu_torch import Config, pipeline
    from nct_tpu_torch.models import vgg19

    rng = np.random.default_rng(7)
    cnt = rng.integers(0, 256, (64, 80, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (72, 88, 3)).astype(np.uint8)
    model = vgg19.init_params().to(card)
    outs = [pipeline.transfer_pair(model, cnt, stl, 2.0, Config(), seed=3)
            for _ in range(3)]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[1], rtol=0, atol=0)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_png_round_trip_needs_no_pillow(tmp_path, monkeypatch):
    """Runs on any machine: PNG through the port's codec, with ``PIL``
    unimportable."""
    import sys

    from nct_tpu_torch import io as tio

    monkeypatch.setitem(sys.modules, "PIL", None)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    tio.imwrite_bgr(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(tio.imread_bgr(str(tmp_path / "x.png")), img)


def test_ssim_card_vs_cpu(card):
    from nct_tpu_torch.utils.ssim import ssim

    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (60, 70, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-25, 26, a.shape), 0,
                255).astype(np.uint8)
    on_card = ssim(torch.from_numpy(a).to(card), torch.from_numpy(b).to(card))
    assert abs(on_card - ssim(a, b)) <= 1e-5


def _unit(rng, h, w, c):
    x = np.maximum(rng.standard_normal((h, w, c)), 0).astype(np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def test_ring_two_ranks_on_card_bitwise_nn_bidir(card, tmp_path):
    """2 gloo ranks sharing the card: the ring a -> b and b -> a at the L2
    shapes of the 452x680 / 600x960 pair are ``nn_bidir``'s two results
    bit for bit, on both ranks, with 2 directed launches per direction."""
    import torch_mesh_workers as workers
    from nct_tpu_torch.parallel.mesh import launch

    rng = np.random.default_rng(4)
    a, b = _unit(rng, 113, 170, 256), _unit(rng, 150, 240, 256)
    ranks = launch(workers.ring_cases, 2, 2, {"ab": (a, b), "ba": (b, a)},
                   None, store_dir=str(tmp_path))
    ab, d_ab, ba, d_ba = (t.cpu() for t in cuda_nn.exact_nn_bidir(
        torch.from_numpy(a).to(card), torch.from_numpy(b).to(card), 3))
    for rank in ranks:
        assert rank["launches"] == 4
        for got, want in ((rank["ab"], (ab, d_ab)), (rank["ba"], (ba, d_ba))):
            np.testing.assert_array_equal(got[0], want[0].numpy())
            np.testing.assert_array_equal(got[1], want[1].numpy())


def test_space_mesh_pair_on_card_within_vmap_rule(card, tmp_path):
    """A 1x2 space mesh on one card (row bands): both ranks'
    ``transfer_pair`` are equal and bitwise the single-process pair
    (float32 VGG through ``conv3x3``, whose sums do not depend on a band's
    height), so within the JAX package's batch contract (2 LSB at >= 95%
    of values, mean <= 0.5) too, with 16 directed launches and no
    bidirectional one per rank, and 44 ``conv3x3`` launches per pair."""
    import torch_mesh_workers as workers
    from nct_tpu_torch.parallel.mesh import launch

    rng = np.random.default_rng(5)
    cnt = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (128, 176, 3)).astype(np.uint8)
    ranks = launch(workers.card_pair, 2, cnt, stl, store_dir=str(tmp_path))
    assert ranks[0]["single_launches"] == {"nn_bidir": 4, "nn_directed": 0,
                                           "conv3x3": 44}
    for rank in ranks:
        assert rank["row_sharded"]
        assert rank["launches"] == {"nn_bidir": 0, "nn_directed": 16,
                                    "conv3x3": 44}
        np.testing.assert_array_equal(rank["pair"], ranks[0]["pair"])
        np.testing.assert_array_equal(rank["pair"], ranks[0]["single"])
        diff = np.abs(rank["pair"].astype(int)
                      - ranks[0]["single"].astype(int))
        within, mean = float((diff <= 2).mean()), float(diff.mean())
        assert within >= 0.95 and mean <= 0.5, (within, mean)


def test_reference_parity_space_mesh_pair_on_card_bitwise(card, tmp_path):
    """``Config.reference_parity`` (PatchMatch at every level, block-Jacobi
    nonlocal) under a 1x2 space mesh on row bands: both ranks equal and
    bitwise the single-process pair, with no NN kernel launch."""
    import torch_mesh_workers as workers
    from nct_tpu_torch.parallel.mesh import launch

    rng = np.random.default_rng(6)
    cnt = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (128, 176, 3)).astype(np.uint8)
    ranks = launch(workers.card_pair, 2, cnt, stl, True,
                   store_dir=str(tmp_path))
    for rank in ranks:
        assert rank["row_sharded"]
        assert rank["launches"] == {"nn_bidir": 0, "nn_directed": 0,
                                    "conv3x3": 44}
        np.testing.assert_array_equal(rank["pair"], ranks[0]["single"])


def test_band_vgg_taps_on_card_within_float32_rounding(card, tmp_path):
    """The VGG taps over a 1x2 space mesh's row bands (float32, through
    ``conv3x3``) against the whole image's, at the card test's pair and the
    default pair: bitwise (no value differs), hence within float32
    rounding (rtol 1e-5, atol 1e-5 of the largest tap value, as
    ``test_torch_space_shard.py`` holds them on the CPU with oneDNN on)."""
    from nct_tpu_torch.parallel.mesh import launch
    import torch_mesh_workers as workers

    rng = np.random.default_rng(5)
    hws = ((120, 160), (128, 176), (452, 680), (600, 960))
    images = [rng.integers(0, 256, hw + (3,)).astype(np.uint8) for hw in hws]
    ranks = launch(workers.card_band_taps, 2, images, store_dir=str(tmp_path))
    for hw, rec in zip(hws, ranks[0]):
        print(f"band VGG taps {hw[0]}x{hw[1]} ({torch.cuda.get_device_name()}"
              f"): values differing / max |diff| / max |tap| "
              f"{ {t: (n, f'{d:.3g}', f'{m:.4g}') for t, (n, d, m, _) in rec.items()} }")
        for tap, (n, d, m, close) in rec.items():
            assert n == 0 and close, (hw, tap, n, d, m)


# VGG-19's convolutions (Cin, Cout) and their grids for a 452x680 image
def _vgg_layer_shapes(h: int, w: int):
    dims = vgg19.feature_dims(h, w)
    cin = 3
    for name, cout in vgg19.VGG19_CONV_LAYERS:
        yield name, cin, cout, dims[name]
        cin = cout


@pytest.mark.parametrize("layer", [name for name, _ in
                                   vgg19.VGG19_CONV_LAYERS])
def test_conv3x3_matches_cudnn_at_vgg_shapes(card, layer):
    """The kernel against ``F.conv2d`` with TF32 off (its plain version) at
    each VGG-19 layer's shape of the 452x680 image: rtol 1e-5, atol 1e-5 of
    the largest output (both sum float32 products, in other orders); one
    launch per call; a band of rows (the rows above and below it padded
    in) gives the whole call's rows bit for bit, and so does a call given
    the weight in the kernel's layout."""
    from nct_tpu_torch.ops import conv3x3

    name, cin, cout, (h, w) = next(t for t in _vgg_layer_shapes(452, 680)
                                   if t[0] == layer)
    g = torch.Generator().manual_seed(cin * 1000 + cout)
    x = torch.relu(torch.randn(1, cin, h, w, generator=g)).to(card)
    wt = (torch.randn(cout, cin, 3, 3, generator=g)
          * np.sqrt(2.0 / (9 * cin))).to(card)
    b = (0.1 * torch.randn(cout, generator=g)).to(card)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1))
    before = conv3x3.LAUNCHES["conv3x3"]
    got = conv3x3.conv3x3(xp, wt, b)
    assert conv3x3.LAUNCHES["conv3x3"] == before + 1
    want = conv3x3.conv3x3_plain(xp, wt, b)
    torch.cuda.synchronize()
    top = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * top)
    # rows [r0, r1) from the padded rows [r0, r1 + 2)
    r0, r1 = h // 3, h // 3 + max(1, h // 5)
    band = conv3x3.conv3x3(xp[:, :, r0:r1 + 2], wt, b)
    assert torch.equal(band, got[:, :, r0:r1])
    # the weight in the kernel's layout made once, as VGG19 keeps it
    kept = conv3x3.conv3x3(xp, wt, b, conv3x3.kernel_weight(wt))
    assert torch.equal(kept, got)


def _chip_smoke():
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("label", [c[0] for c in
                                   _chip_smoke().conv_chain_cases()])
def test_conv3x3_every_tile_bitwise_chain(card, label):
    """Every tile of the kernel (the C entry's config index, which the
    wrapper's rule otherwise picks), with and without the fused ReLU, bit
    for bit ``conv3x3_chain`` (one correctly rounded fma per (ci, ky, kx)
    step, ascending) and each other, at chip_smoke.py phase 3c's cases:
    every VGG-19 layer of a ragged 61x93 content, a batch of 2, a one-row
    band, channel counts that fill no chunk or tile, and conv1_2 and
    conv5_1 of 452x680."""
    cs = _chip_smoke()
    cases = cs.conv_chain_cases()
    i = [c[0] for c in cases].index(label)
    held = cs.conv_chain_check(torch, cases[i], 100 + i)
    assert all(held.values()), [k for k, ok in held.items() if not ok]


def test_vgg19_deploy_net_matches_models_vgg19_on_card(card):
    """The VGG-19 deploy net of chip_smoke.py phase 12 through the port's
    ``Net`` on the card: conv1_1..conv5_1 against ``models.vgg19``'s taps
    (float32, TF32 off; max relative error <= 2e-3)."""
    from nct_tpu_torch.models import vgg19
    from nct_tpu_torch.nn import Net

    smoke = _chip_smoke()
    net = Net(smoke.vgg19_deploy(1, 96, 112), device="cuda")
    model = vgg19.init_params()
    for name, conv in model.convs.items():
        net.set_params(name, {"w": conv.weight, "b": conv.bias})
    net.init_params({"data": (1, 3, 96, 112)})
    img = torch.randint(0, 256, (96, 112, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(0))
    x = (img.float() - torch.tensor(vgg19.BGR_MEAN)).permute(2, 0, 1)[None]
    blobs = net.forward({"data": x}, smoke.VGG_TAPS)
    taps = model.to(card)(img.to(card), smoke.VGG_TAPS)
    for t in smoke.VGG_TAPS:
        got, want = blobs[t][0].permute(1, 2, 0), taps[t]
        assert float((got - want).abs().max() / want.abs().max()) <= 2e-3


def test_caffenet_forward_card_vs_cpu(card):
    """One CaffeNet deploy forward (grouped convolutions, LRN, an
    InnerProduct on a 4-D bottom): the card against the CPU."""
    from nct_tpu_torch.nn import Net

    spec = _chip_smoke().caffenet_deploy(2, 227, 227)
    gpu = Net(spec, device="cuda")
    gpu.init_params({"data": (2, 3, 227, 227)}, seed=1)
    cpu = Net(spec, device="cpu")
    for name, entry in gpu.params.items():
        cpu.set_params(name, {k: v.cpu() for k, v in entry.items()})
    x = torch.randn(2, 3, 227, 227,
                    generator=torch.Generator().manual_seed(1)) * 60
    got = gpu.forward({"data": x}, ["fc8", "prob"])
    want = cpu.forward({"data": x}, ["fc8", "prob"])
    for k in ("fc8", "prob"):
        err = (got[k].cpu() - want[k]).abs().max() / want[k].abs().max()
        assert float(err) <= 2e-3, (k, float(err))
    assert torch.equal(torch.topk(got["fc8"].cpu(), 5).indices,
                       torch.topk(want["fc8"], 5).indices)
