"""The port's mesh (``parallel.mesh``), ring-scheduled matcher
(``parallel.ring_nn``) and mesh pipeline on the CPU, over ``gloo`` ranks in
spawned processes.

The ranks run once per world size (2 and 4) in module-scoped fixtures that
compute every case; each test reads its case from them.  The rank
functions live in ``tests/torch_mesh_workers.py``, which imports no JAX;
the JAX references (``ring_exact_nn_jit`` on the conftest's virtual CPU
devices, ``exact_nn``) are computed here from the same seeded numpy inputs.

The ring is held against JAX's ring with the bounds of JAX's own test
(``tests/test_ring_nn.py``: distances within rtol 1e-5 / atol 1e-6, >= 99%
of indices equal; ties may fall on another block there), and on
integer-valued features bitwise against JAX's and the port's exact search.
The mesh pipeline is held bitwise against the port's single-process path,
which the pipeline tests hold against JAX: the row-sharded space meshes
(their dot products add over the bands in rank order; PatchMatch too), the
replicated stages a space mesh keeps for the scatter transpose, and the
data mesh.  The ranks and the single-process
references run with oneDNN off (``torch_mesh_workers.plain_convolutions``):
oneDNN's convolutions may round a band's rows otherwise than the whole
image's (``tests/test_torch_space_shard.py`` holds band VGG taps to rtol
1e-5 with it on).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from nct_tpu.ops.exact_nn import exact_nn as jax_exact_nn
from nct_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nct_tpu.parallel.ring_nn import ring_exact_nn_jit
from nct_tpu_torch import pipeline
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops.exact_nn import exact_nn_plain
from nct_tpu_torch.parallel import batch as tbatch
from nct_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

# tests/test_ring_nn.py's shapes, C = 16
SHAPES = {"s0": ((24, 20), (28, 18)), "s1": ((17, 9), (13, 23))}
C = 16


@pytest.fixture(autouse=True)
def _no_persistent_cache_writes():
    """As tests/test_ring_nn.py: no cache writes of SPMD CPU programs."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 10 ** 9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def _random(h, w, seed):
    f = np.random.default_rng(seed).standard_normal((h, w, C)).astype(
        np.float32)
    return f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-12)


def _integer(h, w, seed):
    """{-2..2} features from a 3-vector palette: exact sums, many ties."""
    rng = np.random.default_rng(seed)
    return rng.integers(-2, 3, (3, C))[rng.integers(0, 3, (h, w))].astype(
        np.float32)


def _tie_case():
    """B is one integer pattern stacked twice, A is B: a patch of the lower
    copy matches its own pixel in the ring's block 1 and its twin in block
    0 at the same distance."""
    rng = np.random.default_rng(7)
    pattern = rng.integers(-2, 3, (8, C))[rng.integers(0, 8, (8, 12))]
    b = np.concatenate([pattern, pattern]).astype(np.float32)
    return b.copy(), b


def _cases():
    cases = {}
    for name, ((ha, wa), (hb, wb)) in SHAPES.items():
        cases[f"{name}-random"] = (_random(ha, wa, 0), _random(hb, wb, 1))
        cases[f"{name}-integer"] = (_integer(ha, wa, 2), _integer(hb, wb, 3))
    cases["tie"] = _tie_case()
    return cases


CASES = _cases()


def _launch(tmp_path_factory, n):
    """Run every case of an n-rank world once; each rank's results, with
    the ring's and the other cases' results split out per rank."""
    store = str(tmp_path_factory.mktemp(f"mesh{n}"))
    ranks = tmesh.launch(getattr(workers, f"world{n}"), n, CASES,
                         store_dir=store, device="cpu")
    return {key: [r[key] for r in ranks] for key in ranks[0]}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _launch(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _launch(tmp_path_factory, 4)


def _world(request, n):
    return request.getfixturevalue(f"world{n}")


@pytest.fixture(scope="module")
def tiny_refs():
    """The port's single-process results the mesh runs must equal (oneDNN
    off, as in the ranks): one pair, a vmap bucket of 2, the PatchMatch
    pair and the pair with the scatter transpose."""
    cnt, stl, seeds = workers.tiny_pairs(2, 40, 48, 44, 52)
    model = vgg19.init_params()
    with torch.backends.mkldnn.flags(enabled=False):
        pair = pipeline.transfer_pair(model, cnt[0], stl[0], 2.0,
                                      workers.TINY, seed=seeds[0],
                                      device="cpu").numpy()
        bucket = tbatch.make_batch_transfer(workers.TINY, mode="vmap",
                                            device="cpu")(
            model, cnt, stl, seeds, 2.0).numpy()
        pm = pipeline.transfer_pair(model, cnt[0], stl[0], 2.0,
                                    workers.TINY_PM, seed=seeds[0],
                                    device="cpu").numpy()
        scatter = pipeline.transfer_pair(model, cnt[0], stl[0], 2.0,
                                         workers.TINY_SCATTER, seed=seeds[0],
                                         device="cpu").numpy()
    return {"pair": pair, "bucket": bucket, "pair_pm": pm,
            "pair_scatter": scatter}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_ring_matches_jax_ring(request, n, shape):
    """Random features: JAX's ring over n virtual devices, bf16 tables (the
    pipeline's), within the bounds of JAX's own ring test, on every rank."""
    a, b = CASES[f"{shape}-random"]
    mesh = jax_make_mesh(n_data=1, n_space=n)
    with mesh:
        nnf_ref, d_ref = ring_exact_nn_jit(jnp.asarray(a), jnp.asarray(b),
                                           mesh, bf16=True)
    for rank in _world(request, n)["ring"]:
        nnf, d = rank[f"{shape}-random"]
        np.testing.assert_allclose(d, np.asarray(d_ref), rtol=1e-5,
                                   atol=1e-6)
        agree = (nnf == np.asarray(nnf_ref)).all(axis=-1).mean()
        assert agree >= 0.99, f"only {agree:.2%} of NNF entries agree"


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", [f"{s}-{k}" for s in sorted(SHAPES)
                                  for k in ("random", "integer")] + ["tie"])
def test_ring_bitwise_port_exact_nn(request, n, case):
    """Every rank's ring result is the port's exact search, bit for bit."""
    a, b = CASES[case]
    nnf_ref, d_ref = exact_nn_plain(torch.from_numpy(a), torch.from_numpy(b),
                                    3)
    for rank in _world(request, n)["ring"]:
        nnf, d = rank[case]
        np.testing.assert_array_equal(nnf, nnf_ref.numpy())
        np.testing.assert_array_equal(d, d_ref.numpy())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", [f"{s}-integer" for s in sorted(SHAPES)]
                         + ["tie"])
def test_ring_bitwise_jax_exact_nn_integer(request, n, case):
    """Integer-valued features: exact sums, so the ring equals JAX's exact
    search (bf16 tables) in every distance and index."""
    a, b = CASES[case]
    nnf_ref, d_ref = jax_exact_nn(jnp.asarray(a), jnp.asarray(b), 3,
                                  bf16=True)
    for rank in _world(request, n)["ring"]:
        nnf, d = rank[case]
        np.testing.assert_array_equal(nnf, np.asarray(nnf_ref))
        np.testing.assert_array_equal(d, np.asarray(d_ref))


@pytest.mark.parametrize("n", [2, 4])
def test_ring_cross_block_tie_takes_earliest_index(request, n):
    """Rows of a later rank's band whose minimum is met in its own block
    (visited first) and in block 0: the ring takes the earliest global
    index, which lies in block 0.  Blocks are the row bands of
    ``image_bands`` with one-row units."""
    a, b = CASES["tie"]
    na, nb = a.shape[0] * a.shape[1], b.shape[0] * b.shape[1]
    bounds_a = tmesh.image_bands(a.shape[0], n, 1)
    bounds_b = tmesh.image_bands(b.shape[0], n, 1)
    _, d_ref = exact_nn_plain(torch.from_numpy(a), torch.from_numpy(b), 3)
    # brute force: which B indices meet each row's minimum
    from nct_tpu_torch.ops.exact_nn import prep_tables
    fa, ma = prep_tables(torch.from_numpy(a), 3)
    fb, mb = prep_tables(torch.from_numpy(b), 3)
    dots, cnt = fa.float() @ fb.float().T, ma @ mb.T
    d = torch.where(cnt > 0, -dots / cnt.clamp(min=1), torch.inf)
    ties = d == d_ref.reshape(-1, 1)
    owner = torch.bucketize(torch.arange(na) // a.shape[1],
                            torch.tensor(bounds_a[1:-1]), right=True)
    block = torch.bucketize(torch.arange(nb) // b.shape[1],
                            torch.tensor(bounds_b[1:-1]), right=True)
    crossed = [p for p in range(na) if owner[p] > 0
               and ties[p, block == owner[p]].any()
               and ties[p, block == 0].any()]
    assert crossed, "the case has no cross-block tie"
    for rank in _world(request, n)["ring"]:
        nnf, _ = rank["tie"]
        idx = nnf[..., 1].reshape(-1) * b.shape[1] + nnf[..., 0].reshape(-1)
        for p in crossed:
            assert idx[p] == int(torch.nonzero(ties[p])[0]) < (
                bounds_b[1] * b.shape[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("start,rows", [(0, 23), (17, 23), (100, 40),
                                        (130, 8)])
def test_band_tables_are_rows_of_prep_tables(dtype, start, rows):
    """A band built from its own feature rows (a batch of 2, bands that
    start mid image-row and run past the last pixel) is those rows of the
    whole table, bit for bit; rows past the end are zero with mask 0."""
    from nct_tpu_torch.ops.exact_nn import prep_tables
    from nct_tpu_torch.parallel.ring_nn import band_tables

    x = torch.from_numpy(np.stack([_random(9, 13, s) for s in (5, 6)]))
    x = x.to(dtype)
    f, m = prep_tables(x, 3)
    bf, bm = band_tables(x, start, rows, 3)
    end = min(start + rows, 9 * 13)
    n = max(end - start, 0)
    assert torch.equal(bf[..., :n, :].view(torch.int16),
                       f[..., start:end, :].view(torch.int16))
    assert torch.equal(bm[:n], m[start:end])
    assert not bf[..., n:, :].any() and not bm[n:].any()


def test_ring_has_no_launches_on_cpu(world2):
    """On the CPU the ring runs the plain search, never the kernel."""
    assert [r["launches"] for r in world2["ring"]] == [0, 0]


def test_space_mesh_pair_bitwise_single_process(world2, tiny_refs):
    """transfer_pair under a 1x2 space mesh runs on row bands: both ranks
    return the single-process pair (float32 VGG, as TINY has it)."""
    for rank in world2["pipeline"]:
        np.testing.assert_array_equal(rank["pair_space"], tiny_refs["pair"])


def test_space_mesh_patchmatch_pair_bitwise_single_process(world2,
                                                           tiny_refs):
    """A PatchMatch level runs on row bands under a 1x2 space mesh too
    (``pipeline.row_sharded`` is True): both ranks return the
    single-process pair bit for bit."""
    from nct_tpu_torch import Config
    assert pipeline.row_sharded(Config(fine_strategy="patchmatch",
                                       space_mesh=_FakeMesh()))
    for rank in world2["pipeline"]:
        np.testing.assert_array_equal(rank["pair_space_pm"],
                                      tiny_refs["pair_pm"])


def test_space_mesh_replicated_pair_bitwise_single_process(world2,
                                                           tiny_refs):
    """The scatter transpose keeps a 1x2 space mesh on the replicated
    stages (``pipeline.row_sharded`` is False: the ring at the exact
    levels, every other stage whole on each rank): both ranks return the
    single-process pair bit for bit."""
    assert not pipeline.row_sharded(dataclasses.replace(
        workers.TINY_SCATTER, space_mesh=_FakeMesh()))
    for rank in world2["pipeline"]:
        np.testing.assert_array_equal(rank["pair_space_replicated"],
                                      tiny_refs["pair_scatter"])


class _FakeMesh:
    shape = {"data": 1, "space": 2}


@pytest.mark.parametrize("mesh", ["bucket_space", "bucket_space_replicated",
                                  "bucket_data"])
def test_mesh_bucket_bitwise_vmap(world2, tiny_refs, mesh):
    """make_batch_transfer over a 1x2 mesh (row bands, through the ring and
    with ``ring_nn=False``) and a 2x1 mesh: every rank returns the whole
    bucket, bitwise the single-process vmap bucket."""
    for rank in world2["pipeline"]:
        np.testing.assert_array_equal(rank[mesh], tiny_refs["bucket"])


def test_replicated_matcher_bitwise_ring(world2):
    """``ring_nn=False`` under the 1x2 mesh (each space rank searches the
    gathered levels with ``nn_bidir``) is the ring's in-pipeline reference:
    both matchers are exact and the rest of the path is the same, so the
    two buckets are equal bit for bit on every rank."""
    for rank in world2["pipeline"]:
        np.testing.assert_array_equal(rank["bucket_space_replicated"],
                                      rank["bucket_space"])


def test_grid_mesh_bucket_bitwise_vmap(world4, tiny_refs):
    """A 2x2 mesh: items split over the data rows, each pair row-sharded
    over the space columns; all 4 ranks return the single-process vmap
    bucket."""
    for out in world4["grid"]:
        np.testing.assert_array_equal(out, tiny_refs["bucket"])


@pytest.mark.parametrize("key,match", [("scan_error", "scan mode"),
                                       ("split_error", "does not split")])
def test_mesh_batch_errors(world2, key, match):
    for rank in world2["pipeline"]:
        assert match in rank[key]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(n_space=2, device="cpu")


def test_launch_without_a_card_needs_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.launch(workers.grid_bucket, 2)


def test_launch_raises_when_a_rank_fails(tmp_path):
    """A rank that raises fails the launch instead of hanging the others
    (a 3-rank mesh cannot hold a 2x2 grid)."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="does not hold"):
        tmesh.launch(workers.grid_bucket, 3, store_dir=str(tmp_path),
                     device="cpu")
