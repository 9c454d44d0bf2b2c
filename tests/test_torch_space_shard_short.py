"""Row bands of zero rows: images with fewer 16-row units than space
ranks (``parallel.mesh.image_bands``), on the CPU over gloo ranks.

Such an image gives each of its first ``units`` ranks one unit and the
trailing ranks empty bands, at every grid of the pair; an empty band asks
for no halo, launches nothing and joins every exchange.  One world of 8
ranks and one of 3 (``tests/torch_shard_short_workers.py``, which imports
no JAX) run every case once, in a thread, while this process runs JAX's
plain batch.  The rules:

  * ``image_bands`` keeps its split wherever the image has a unit per
    rank, and the ring's one-row split follows the same rule;
  * ``RowBand``'s halo, gather, rank-order sum, exchange and coarsening
    with empty bands give the whole grid's rows;
  * the ring over fewer rows than ranks is the port's exact search bit
    for bit;
  * the TINY pair at 64x48 over 8 space ranks (the geometry of JAX's
    ``tests/test_parallel_batch.py::test_space_only_sharding_single_pair``,
    4 ranks empty) and a seeded bucket of it through
    ``make_batch_transfer``, TINY and TINY_PM at 32 rows over 3 ranks:
    identical on every rank and bitwise the single process (oneDNN off on
    both sides) with its iteration counts; the 8-rank pair, fed JAX's
    draws, within the JAX package's batch contract (2 LSB at >= 95%,
    mean <= 0.5) of JAX's plain ``make_batch_transfer``, as JAX's own test
    holds its 8-device run.
"""

import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as mesh_workers
import torch_shard_short_workers as workers
from nct_tpu.config import Config as JaxConfig
from nct_tpu.parallel.batch import make_batch_transfer as jax_batch
from nct_tpu_torch import pipeline
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops.exact_nn import exact_nn_plain
from nct_tpu_torch.parallel import batch as tbatch
from nct_tpu_torch.parallel import mesh as tmesh
from test_torch_space_shard import TINY_JAX, _integer, _unit
from test_torch_space_shard_pm import RecordingJaxDraws

torch.set_num_threads(1)

WORLDS = (8, 3)
# the JAX package's batch contract (nct_tpu/parallel/batch.py)
JAX_LSB, JAX_WITHIN_MIN, JAX_MEAN_MAX = 2, 0.95, 0.5


def _old_rule(h, n, unit):
    """``image_bands`` as it was before empty bands (units >= n only)."""
    units = -(-h // unit)
    bounds = [0]
    for k in range(1, n):
        b = math.floor(k * h / (n * unit) + 0.5)
        bounds.append(max(bounds[-1] + 1, min(b, units - (n - k))))
    return [b * unit for b in bounds] + [h]


def test_image_bands_unchanged_where_units_suffice():
    """Every height with at least one unit per rank (16-row and one-row
    units, 1 to 8 ranks) keeps the split it had."""
    for unit in (16, 1):
        for n in range(1, 9):
            for h in range(unit * (n - 1) + 1, 40 * unit, max(unit // 4, 1)):
                assert tmesh.image_bands(h, n, unit) == _old_rule(h, n, unit)


@pytest.mark.parametrize("h,n,bounds", [
    (3, 5, [0, 1, 2, 3, 3, 3]), (4, 8, [0, 1, 2, 3, 4, 4, 4, 4, 4]),
    (1, 3, [0, 1, 1, 1])])
def test_ring_one_row_split_fewer_rows_than_ranks(h, n, bounds):
    """The ring's one-row units: a row for each of the first ranks, none
    for the rest (the 16-row cases are in test_torch_space_shard.py)."""
    assert tmesh.image_bands(h, n, 1) == bounds


@pytest.mark.parametrize("h,n", [(40, 4), (68, 8), (33, 5)])
def test_empty_bands_start_at_h_on_every_grid(h, n):
    """``of_image`` puts an empty band at each grid's own height (ceil
    dims), and ``coarsen`` from one VGG grid gives the next one's bands."""
    bounds = tmesh.image_bands(h, n)
    grids = [tmesh.RowBand.of_image(None, "space", bounds, shift,
                                    -(-h // 2 ** shift)) for shift in range(5)]
    for band in grids:
        spans = [band.span(j) for j in range(n)]
        assert spans[0][0] == 0 and spans[-1][1] == band.h
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        for j, (y0, y1) in enumerate(spans):
            if bounds[j] == bounds[j + 1]:
                assert y0 == y1 == band.h
            else:
                assert y1 > y0
    for fine, coarse in zip(grids, grids[1:]):
        got = fine.coarsen()
        assert (got.starts, got.h) == (coarse.starts, coarse.h)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's plain batch of the 64x48 pair in a thread from the start;
    meanwhile the port's single-process references (oneDNN off, as in the
    ranks), whose JAX draws the 8-rank world replays, then both worlds at
    once, a thread each."""
    params = mesh_workers.seeded_vgg_params()
    model = vgg19.params_from_numpy(params)
    jax_out = {}

    def jax_run():
        cnt, stl, _ = mesh_workers.tiny_pairs(1, *workers.PAIR_HW[8])
        keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(1, dtype=jnp.uint32))
        config = dataclasses.replace(JaxConfig(**TINY_JAX),
                                     vgg_compute_dtype="float32")
        jax_out["pair"] = np.asarray(jax_batch(config)(
            params, jnp.asarray(cnt), jnp.asarray(stl), keys, 2.0))[0]

    jax_thread = threading.Thread(target=jax_run)
    jax_thread.start()
    single, worlds = {}, {}
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            for n in WORLDS:
                cnt, stl, seeds = mesh_workers.tiny_pairs(
                    1, *workers.PAIR_HW[n])
                if n == 8:
                    rec = RecordingJaxDraws(seeds[0])
                    kw = {"draws": rec}
                else:
                    kw = {"seed": seeds[0]}
                configs = {"pair": mesh_workers.TINY}
                if n == 3:
                    configs["pair_pm"] = mesh_workers.TINY_PM
                for name, config in configs.items():
                    out, trace = pipeline.transfer_pair(
                        model, cnt[0], stl[0], 2.0, config, device="cpu",
                        return_intermediates="stats", **kw)
                    single[n, name] = (out.numpy(), [
                        (int(t["nl_iters"]), int(t["wls_iters"]))
                        for t in trace])
                if n == 8:
                    draws = rec.record
                    single[n, "bucket"] = tbatch.make_batch_transfer(
                        mesh_workers.TINY, mode="vmap", device="cpu")(
                            model, cnt, stl, seeds, 2.0).numpy()
        rng = np.random.default_rng(18)
        weights = str(tmp_path_factory.mktemp("vgg") / "vgg.npz")
        mesh_workers.save_taps_weights(weights, params)
        inputs = {n: {"vgg": weights, "draws": draws, "ring": {
            "integer": tuple(_integer(rng, *hw) for hw in workers.RING_HW[n]),
            "random": tuple(_unit(rng, hw + (16,))
                            for hw in workers.RING_HW[n])}} for n in WORLDS}
        stores = {n: str(tmp_path_factory.mktemp(f"shard_short{n}"))
                  for n in WORLDS}

        def spawn(n):
            worlds[n] = tmesh.launch(workers.short_world, n, n, inputs[n],
                                     store_dir=stores[n], device="cpu")

        threads = [threading.Thread(target=spawn, args=(n,)) for n in WORLDS]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        jax_thread.join()
    assert set(worlds) == set(WORLDS), "a world failed"
    assert "pair" in jax_out, "the JAX batch failed"
    return {"worlds": worlds, "single": single, "jax": jax_out,
            "inputs": inputs}


def _ranks(runs, n, key):
    return [r[key] for r in runs["worlds"][n]]


@pytest.mark.parametrize("n", WORLDS)
def test_band_halo_with_empty_bands(runs, n):
    """Each rank's halo is the whole grid's rows around its band (as far
    as the image has them); an empty band gets no rows."""
    h, _ = workers.BAND_GRIDS[n]
    whole = torch.arange(h * 3 * 2, dtype=torch.float32).reshape(h, 3, 2)
    for r, st in enumerate(_ranks(runs, n, "bands")):
        start, stop = st["bounds"][r], st["bounds"][r + 1]
        assert st["rows"] == stop - start
        for (above, below), (ext, top, bottom) in zip(workers.HALOS,
                                                      st["halo"]):
            if start == stop:
                assert (top, bottom) == (0, 0) and ext.shape[0] == 0
                continue
            assert (top, bottom) == (min(above, start), min(below, h - stop))
            assert torch.equal(ext, whole[start - top:stop + bottom])
    assert [st["bounds"][-2] for st in _ranks(runs, n, "bands")] == [h] * n


@pytest.mark.parametrize("n", WORLDS)
def test_band_gather_reduce_exchange_with_empty_bands(runs, n):
    """The gather is the whole grid, the sum adds in rank order, the min
    is exact and an exchange delivers every part, empty ones too."""
    h, _ = workers.BAND_GRIDS[n]
    whole = torch.arange(h * 3 * 2, dtype=torch.float32).reshape(h, 3, 2)
    want_sum = torch.full((4,), 0.1)
    for r in range(1, n):
        want_sum = want_sum + torch.full((4,), 0.1 * (r + 1))
    ranks = _ranks(runs, n, "bands")
    bounds = ranks[0]["bounds"]
    want_min = min(float(bounds[r + 1] - bounds[r]) - r for r in range(n))
    for r, st in enumerate(ranks):
        assert torch.equal(st["gather"], whole)
        assert torch.equal(st["gather_map"], whole[..., 0])
        assert torch.equal(st["sum"], want_sum)
        assert float(st["min"]) == want_min
        for j, part in enumerate(st["exchange"]):
            assert torch.equal(part, torch.full((j + r, 2), 100.0 * j + r))


@pytest.mark.parametrize("n", WORLDS)
def test_band_coarsen_with_empty_bands(runs, n):
    """A grid whose trailing bands are empty coarsens while every band
    holding rows starts on an even row, the empty ones at each new h."""
    for st in _ranks(runs, n, "bands"):
        bounds = st["bounds"]
        h, starts = bounds[-1], tuple(bounds[:-1])
        for got in st["coarsen"]:
            if any(s % 2 for s in starts if s < h):
                assert got is None
                break
            h2 = -(-h // 2)
            starts = tuple(s // 2 if s < h else h2 for s in starts)
            h = h2
            assert got == (starts, h)


@pytest.mark.parametrize("n", WORLDS)
def test_ring_fewer_rows_than_ranks_bitwise_exact_nn(runs, n):
    """The ring with one-row bands over fewer rows than ranks (random and
    integer features, many ties): the port's exact search bit for bit."""
    for name, (a, b) in runs["inputs"][n]["ring"].items():
        nnf_ref, d_ref = exact_nn_plain(torch.from_numpy(a),
                                        torch.from_numpy(b), 3)
        for st in _ranks(runs, n, "ring"):
            nnf, d = st[name]
            np.testing.assert_array_equal(nnf, nnf_ref.numpy())
            np.testing.assert_array_equal(d, d_ref.numpy())


@pytest.mark.parametrize("n", WORLDS)
def test_pair_bitwise_single_process(runs, n):
    """Every rank returns the single-process pair (and over 8 ranks the
    bucket) bit for bit, with the same (nl, wls) iterations per level."""
    single = runs["single"]
    for p in _ranks(runs, n, "pipeline"):
        assert p["row_sharded"]
        for name in ("pair", "pair_pm") if n == 3 else ("pair",):
            out, iters = single[n, name]
            np.testing.assert_array_equal(p[name][0], out)
            assert p[name][1] == iters
        if n == 8:
            np.testing.assert_array_equal(p["bucket"], single[8, "bucket"])


def test_pair_over_eight_ranks_within_jax_batch_contract(runs):
    """JAX's plain ``make_batch_transfer`` of the 64x48 pair (float32
    VGG), its draws replayed on every rank."""
    want = runs["jax"]["pair"].astype(int)
    for p in _ranks(runs, 8, "pipeline"):
        diff = np.abs(p["pair"][0].astype(int) - want)
        within, mean = (diff <= JAX_LSB).mean(), diff.mean()
        assert within >= JAX_WITHIN_MIN and mean <= JAX_MEAN_MAX, (within,
                                                                   mean)
