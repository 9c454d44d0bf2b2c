"""Rank functions of the mesh tests, run by ``parallel.mesh.launch`` in
spawned processes (on the CPU in the worlds of
``torch_shard_world_workers.world``, which ``tests/test_torch_space_shard.py``
spawns; on a card from ``tests/test_torch_cuda.py``).

A spawned rank imports the module of its function, so this module imports
no JAX: every rank gets numpy inputs and returns numpy or CPU results, and
the tests compute the JAX references in the parent.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nct_tpu_torch import Config, pipeline
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops import cuda_nn
from nct_tpu_torch.parallel.batch import make_batch_transfer
from nct_tpu_torch.parallel.mesh import make_mesh
from nct_tpu_torch.parallel.ring_nn import ring_exact_nn

# tests/test_parallel_batch.py's TINY Config of the JAX package
TINY = Config(
    pm_iters=2, cg_iters=8, cg_iters_final=8, cg_iters_mg=6,
    cg_iters_final_mg=4, wls_cg_iters=8, kmeans_iters=3, num_levels=2,
    feature_dtype="float32", vgg_compute_dtype="float32",
)


# TINY with PatchMatch at level 1 (on row bands under a space mesh)
TINY_PM = dataclasses.replace(TINY, exact_nn_levels=1,
                              fine_strategy="patchmatch")

# TINY with two k-means memberships (the P > 1 merge; on row bands under
# a space mesh)
TINY_P2 = dataclasses.replace(TINY, knn_memberships=2)

# TINY with the scatter transpose (on row bands under a space mesh)
TINY_SCATTER = dataclasses.replace(TINY, nl_transpose="scatter")

# TINY as the variants configuration: the P = 3 merge, the scatter
# transpose and Jacobi WLS
TINY_VARIANTS = dataclasses.replace(TINY_SCATTER, knn_memberships=3,
                                    wls_precond="jacobi")


def tiny_pairs(b: int, h: int, w: int, hs: int, ws: int, seed: int = 0):
    """Seeded uint8 content and style buckets and their seeds."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (b, hs, ws, 3)).astype(np.uint8)
    return cnt, stl, list(range(b))


def seeded_vgg_params() -> dict:
    """The port's seeded VGG weights (``vgg19.init_params``) in the JAX
    package's {name: {"w": HWIO, "b": [out]}} layout, for both sides of a
    test (drawing them with JAX costs its first compiles)."""
    return {name: {"w": conv.weight.permute(2, 3, 1, 0).numpy(),
                   "b": conv.bias.numpy()}
            for name, conv in vgg19.init_params().convs.items()}


def save_taps_weights(path: str, params: dict) -> None:
    """The JAX package's VGG parameters through conv5_1 (the pipeline's
    deepest tap) as an npz file that ``vgg19.load_params`` reads: ranks
    load it, where weights passed to ``launch`` are pickled once per
    rank (~3 s a rank)."""
    arrays = {}
    for name, _ in vgg19.VGG19_CONV_LAYERS:
        arrays[f"{name}_w"] = np.asarray(params[name]["w"])
        arrays[f"{name}_b"] = np.asarray(params[name]["b"])
        if name == "conv5_1":
            break
    np.savez(path, **arrays)


def ring_cases(n_space: int, cases: dict, device: str = "cpu",
               mesh=None) -> dict:
    """``ring_exact_nn`` a -> b over a 1 x ``n_space`` mesh (``mesh``, or
    one made here) for each case name -> (a, b) numpy features; returns
    name -> (nnf, annd) and the directed launches of the rank."""
    if mesh is None:
        mesh = make_mesh(n_data=1, n_space=n_space, device=device)
    out = {}
    before = cuda_nn.LAUNCHES["nn_directed"]
    for name, (a, b) in cases.items():
        nnf, d = ring_exact_nn(torch.from_numpy(a).to(mesh.device),
                               torch.from_numpy(b).to(mesh.device), mesh)
        out[name] = (nnf.cpu().numpy(), d.cpu().numpy())
    out["launches"] = cuda_nn.LAUNCHES["nn_directed"] - before
    return out


def _errors(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def pipeline_cases(model, space, device: str = "cpu") -> dict:
    """Over 2 ranks: ``transfer_pair`` and a vmap bucket of 2 under the 1x2
    space mesh ``space`` (row-sharded; the bucket through the ring and,
    with ``ring_nn=False``, through each rank's ``nn_bidir`` on the
    gathered levels), a bucket of 2 under a 2x1 data mesh, a PatchMatch
    pair and a pair with the scatter transpose under the 1x2 mesh (row
    bands too) and the error paths, with the port's seeded VGG ``model``;
    every result as uint8 numpy."""
    cnt, stl, seeds = tiny_pairs(2, 40, 48, 44, 52)
    data = make_mesh(n_data=2, n_space=1, device=device)
    out = {}
    out["pair_space"] = pipeline.transfer_pair(
        model, cnt[0], stl[0], 2.0,
        dataclasses.replace(TINY, space_mesh=space), seed=seeds[0]
    ).cpu().numpy()
    out["bucket_space"] = make_batch_transfer(TINY, space)(
        model, cnt, stl, seeds, 2.0).cpu().numpy()
    out["bucket_space_replicated"] = make_batch_transfer(
        TINY, space, ring_nn=False)(model, cnt, stl, seeds, 2.0).cpu().numpy()
    out["bucket_data"] = make_batch_transfer(TINY, data)(
        model, cnt, stl, seeds, 2.0).cpu().numpy()
    out["pair_space_pm"] = pipeline.transfer_pair(
        model, cnt[0], stl[0], 2.0,
        dataclasses.replace(TINY_PM, space_mesh=space), seed=seeds[0]
    ).cpu().numpy()
    out["pair_space_scatter"] = pipeline.transfer_pair(
        model, cnt[0], stl[0], 2.0,
        dataclasses.replace(TINY_SCATTER, space_mesh=space), seed=seeds[0]
    ).cpu().numpy()
    out["scan_error"] = _errors(
        lambda: make_batch_transfer(TINY, data, mode="scan"))
    out["split_error"] = _errors(lambda: make_batch_transfer(TINY, data)(
        model, cnt[:1], stl[:1], seeds[:1], 2.0))
    return out


def grid_bucket(model=None, device: str = "cpu") -> np.ndarray:
    """Over 4 ranks: a vmap bucket of 2 under a 2x2 mesh (each data row one
    item, its exact levels on a ring of 2), with ``model`` or the port's
    seeded VGG."""
    cnt, stl, seeds = tiny_pairs(2, 40, 48, 44, 52)
    mesh = make_mesh(n_data=2, n_space=2, device=device)
    if model is None:
        model = vgg19.init_params()
    return make_batch_transfer(TINY, mesh)(
        model, cnt, stl, seeds, 2.0).cpu().numpy()


def card_pair(cnt: np.ndarray, stl: np.ndarray,
              parity: bool = False) -> dict:
    """On a card, 2 ranks: ``transfer_pair`` under a 1x2 space mesh with
    float32 VGG (row-sharded), and (rank 0) the single-process pair it
    must equal, under the default Config or (``parity``)
    ``Config.reference_parity``; with each run's kernel launches."""
    from nct_tpu_torch.ops import conv3x3

    model = vgg19.init_params()
    mesh = make_mesh(n_data=1, n_space=2)
    config = (Config.reference_parity if parity else Config)(
        vgg_compute_dtype="float32")

    def counted(cfg):
        cuda_nn.LAUNCHES.update(nn_bidir=0, nn_directed=0)
        conv3x3.LAUNCHES["conv3x3"] = 0
        got = pipeline.transfer_pair(model, cnt, stl, 2.0, cfg).cpu().numpy()
        return got, {**cuda_nn.LAUNCHES, **conv3x3.LAUNCHES}

    sharded = dataclasses.replace(config, space_mesh=mesh)
    out = {"row_sharded": pipeline.row_sharded(sharded)}
    out["pair"], out["launches"] = counted(sharded)
    if mesh.index("space") == 0:
        out["single"], out["single_launches"] = counted(config)
    return out


def card_band_taps(images: list) -> list:
    """On a card, 2 ranks: each image's VGG taps (float32, the ``conv3x3``
    kernel) over the 1x2 space mesh's row bands, gathered, beside the whole
    image's: per image {tap: (values that differ, max |diff|, max |whole|,
    within rtol 1e-5 and atol 1e-5 x max |whole|)}."""
    from nct_tpu_torch.parallel.mesh import RowBand, image_bands

    model = vgg19.init_params().cuda()
    mesh = make_mesh(n_data=1, n_space=2)
    out = []
    for img in images:
        x = torch.from_numpy(img).cuda()
        h, w = x.shape[:2]
        bounds = image_bands(h, 2)
        full = RowBand.of_image(mesh, "space", bounds, 0, h)
        whole = model(x, vgg19.PIPELINE_TAPS, torch.float32)
        band = model(full.take(x), vgg19.PIPELINE_TAPS, torch.float32,
                     band=full)
        rec = {}
        for tap in vgg19.PIPELINE_TAPS:
            rows = vgg19.feature_dims(h, w)[tap][0]
            got = RowBand.of_image(mesh, "space", bounds, int(tap[4]) - 1,
                                   rows).gather(band[tap])
            top = float(whole[tap].abs().max())
            rec[tap] = (int((got != whole[tap]).sum()),
                        float((got - whole[tap]).abs().max()), top,
                        torch.allclose(got, whole[tap], rtol=1e-5,
                                       atol=1e-5 * top))
        out.append(rec)
    return out


def plain_convolutions() -> None:
    """Turn oneDNN off for this process: its CPU convolutions may round a
    row band's output rows otherwise than the whole image's, while the
    plain convolution gives a row the same bits either way, so a space
    mesh's pair is bitwise the single process's (as on the card)."""
    torch.backends.mkldnn.enabled = False


def mesh_world(mesh, models: dict, cases: dict) -> dict:
    """The mesh cases of a world over its 1 x n space mesh ``mesh``: the
    rings of ``cases``, then over 2 ranks the pipeline cases and over 4
    the 2x2 bucket, with the port's seeded VGG (``models["port"]``)."""
    n = mesh.shape["space"]
    out = {"ring": ring_cases(n, cases, mesh=mesh)}
    if n == 2:
        out["pipeline"] = pipeline_cases(models["port"], mesh)
    else:
        out["grid"] = grid_bucket(models["port"])
    return out
