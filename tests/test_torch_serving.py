"""The port's pairs.txt serving path: geometry buckets, the prefetching
PairLoader, the scan-mode batch transfer and the CLI, none of which needs
Pillow for PNG."""

import sys

import numpy as np
import pytest
import torch

from nct_tpu.parallel import bucket as jbucket
from nct_tpu_torch import Config
from nct_tpu_torch import cli as tcli
from nct_tpu_torch import io as tio
from nct_tpu_torch import pipeline as tpipe
from nct_tpu_torch.data import PairLoader
from nct_tpu_torch.models import vgg19 as tvgg
from nct_tpu_torch.parallel import batch as tbatch
from nct_tpu_torch.parallel import bucket as tbucket

torch.set_num_threads(1)

SMALL = Config(cg_iters_mg=3, cg_iters_final_mg=2, wls_cg_iters_mg=2,
               kmeans_iters=2)


@pytest.fixture()
def no_pillow(monkeypatch):
    """``import PIL`` raises ImportError while the test runs."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


def _img(rng, h, w):
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


# --- buckets ----------------------------------------------------------------

@pytest.mark.parametrize("quantum", [64, 16])
def test_group_pairs_bitwise_vs_jax(rng, quantum):
    items = [(_img(rng, h, w), _img(rng, hs, ws), bds)
             for h, w, hs, ws, bds in ((40, 50, 60, 70, 2.0),
                                       (33, 64, 60, 70, 2.0),
                                       (40, 50, 60, 70, 1.5),
                                       (65, 20, 7, 129, 2.0),
                                       (64, 64, 64, 64, 2.0))]
    got = tbucket.group_pairs(items, quantum)
    ref = jbucket.group_pairs(items, quantum)
    assert [(k.cnt_hw, k.stl_hw, k.bds_weight) for k in got] == \
        [(k.cnt_hw, k.stl_hw, k.bds_weight) for k in ref]
    for gb, rb in zip(got.values(), ref.values()):
        assert len(gb) == len(rb)
        for (gi, gc, gs, ghw), (ri, rc, rs, rhw) in zip(gb, rb):
            assert gi == ri and tuple(ghw) == tuple(rhw)
            np.testing.assert_array_equal(gc, rc)
            np.testing.assert_array_equal(gs, rs)
    for h, w in ((1, 1), (64, 64), (65, 127)):
        assert tbucket.bucket_dims(h, w, quantum) == \
            jbucket.bucket_dims(h, w, quantum)


# --- PairLoader -------------------------------------------------------------

def test_pair_loader_order_failure_and_cap(tmp_path, rng, no_pillow):
    imgs = [_img(rng, 120, 90), _img(rng, 60, 150), _img(rng, 50, 40)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"i{i}.png"))
        tio.imwrite_bgr(paths[-1], img)
    bad = str(tmp_path / "missing.png")
    loader = PairLoader([(paths[0], paths[1]), (paths[0], bad),
                         (paths[2], paths[1]), (bad, paths[2])],
                        max_size=100, threads=2)
    assert len(loader) == 4
    items = list(loader)
    loader.close()
    assert items[1] is None and items[3] is None
    for item, (ci, si) in zip((items[0], items[2]), ((0, 1), (2, 1))):
        cnt, stl = item
        np.testing.assert_array_equal(cnt, tio.cap_max_size(imgs[ci], 100))
        np.testing.assert_array_equal(stl, tio.cap_max_size(imgs[si], 100))
    assert items[0][0].shape == (100, 75, 3)   # capped on the long side
    assert items[2][0].shape == (50, 40, 3)    # under the cap: unchanged


# --- scan-mode batch --------------------------------------------------------

@pytest.fixture(scope="module")
def batch_pairs():
    rng = np.random.default_rng(4)
    cnt = np.stack([_img(rng, 40, 48) for _ in range(2)])
    stl = np.stack([_img(rng, 44, 52) for _ in range(2)])
    return tvgg.init_params(), cnt, stl


def test_scan_batch_bitwise_equals_per_pair_loop(batch_pairs):
    model, cnt, stl = batch_pairs
    seeds = [5, 9]
    fn = tbatch.make_batch_transfer(SMALL, mode="scan", device="cpu")
    out = fn(model, cnt, stl, seeds, 1.5)
    assert out.shape == (2, 40, 48, 3) and out.dtype == torch.uint8
    for i, seed in enumerate(seeds):
        ref = tpipe.transfer_pair(model, cnt[i], stl[i], 1.5, SMALL,
                                  seed=seed, device="cpu")
        torch.testing.assert_close(out[i], ref, rtol=0, atol=0)
    # "auto" without a mesh is the scan, on tensors too
    auto = tbatch.make_batch_transfer(SMALL, device="cpu")(
        model, torch.from_numpy(cnt), torch.from_numpy(stl),
        torch.tensor(seeds), 1.5)
    torch.testing.assert_close(auto, out, rtol=0, atol=0)


@pytest.mark.parametrize("kwargs", [
    {"mode": "vmap", "config": Config(space_mesh=object())},
    {"mesh": object()}, {"mesh": object(), "mode": "scan"}])
def test_vmap_and_mesh_not_ported(kwargs):
    """The mesh paths take a parallel.mesh.Mesh (tests/test_torch_mesh.py):
    anything else raises, in the vmap mode, with "auto" and with "scan"."""
    kwargs = dict(kwargs)
    config = kwargs.pop("config", SMALL)
    with pytest.raises(ValueError, match="parallel.mesh.Mesh"):
        tbatch.make_batch_transfer(config, device="cpu", **kwargs)


def test_batch_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.make_batch_transfer(SMALL)


# --- CLI --------------------------------------------------------------------

def test_cli_cpu_pairs_with_missing_file(tmp_path, capsys, no_pillow):
    rng = np.random.default_rng(6)
    src = tmp_path / "in"
    src.mkdir()
    cnt, stl = _img(rng, 36, 44), _img(rng, 40, 46)
    tio.imwrite_bgr(str(src / "c0.png"), cnt)
    tio.imwrite_bgr(str(src / "s0.png"), stl)
    (src / "pairs.txt").write_text("c0.png s0.png 1.5\n"
                                   "c0.png gone.png 2.0\n"
                                   "c0.png s0.png\n")
    out = tmp_path / "out"
    rc = tcli.main(["-i", str(src), "-o", str(out), "--device", "cpu",
                    "-bds", "3.0", "--seed", "4"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "error: failed reading pair c0.png/gone.png; skipping" in printed
    assert sorted(p.name for p in out.iterdir()) == ["c0_s0_1.50.png",
                                                      "c0_s0_3.00.png"]
    model = tvgg.init_params()
    for name, bds in (("c0_s0_1.50.png", 1.5), ("c0_s0_3.00.png", 3.0)):
        ref = tpipe.transfer_pair(model, cnt, stl, bds, Config(), seed=4,
                                  device="cpu").numpy()
        np.testing.assert_array_equal(tio.imread_bgr(str(out / name)), ref)
