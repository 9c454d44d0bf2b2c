"""The one gloo world of each size that ``tests/test_torch_space_shard.py``
spawns on the CPU: every rank builds its 1 x n space mesh and reads the
VGG weights once, then runs each part's cases in turn.

The parts are the rank functions of the row-band and mesh cases:

  * ``mesh``: the ring and the mesh pipeline (``torch_mesh_workers``);
  * ``shard``: the default family's band stages and pairs
    (``torch_shard_workers``);
  * ``pm`` and ``pm_tall``: PatchMatch, block-Jacobi and Jacobi WLS on
    bands, and the tall pair over 4 ranks (``torch_shard_pm_workers``);
  * ``multi``: several memberships (``torch_shard_multi_workers``);
  * ``scatter``: the scatter transpose (``torch_shard_scatter_workers``);
  * ``short``: bands of zero rows (``torch_shard_short_workers``).

A spawned rank imports the module of its function, so this module and
every part's module import no JAX.
"""

from __future__ import annotations

from nct_tpu_torch.models import vgg19
from nct_tpu_torch.parallel.mesh import make_mesh

import torch_mesh_workers
import torch_shard_multi_workers
import torch_shard_pm_workers
import torch_shard_scatter_workers
import torch_shard_short_workers
import torch_shard_workers

PARTS = {
    "mesh": torch_mesh_workers.mesh_world,
    "shard": torch_shard_workers.shard_world,
    "pm": torch_shard_pm_workers.shard_world,
    "pm_tall": torch_shard_pm_workers.four_rank_world,
    "multi": torch_shard_multi_workers.multi_world,
    "scatter": torch_shard_scatter_workers.scatter_world,
    "short": torch_shard_short_workers.short_world,
}


def world(n: int, vgg: dict, parts: dict) -> dict:
    """Every part of ``parts`` (name -> its inputs), in that order, over
    one 1 x ``n`` space mesh, with oneDNN off so the pairs are bitwise the
    single process's.  ``vgg`` maps a model name ("jax": the JAX package's
    seeded weights, "port": the port's) to an npz path
    (``torch_mesh_workers.save_taps_weights``)."""
    torch_mesh_workers.plain_convolutions()
    mesh = make_mesh(n_data=1, n_space=n, device="cpu")
    models = {name: vgg19.load_params(path) for name, path in vgg.items()}
    out = {"rank": mesh.index("space")}
    for name, inp in parts.items():
        out[name] = PARTS[name](mesh, models, inp)
    return out
