"""Device mesh over ``torch.distributed`` (counterpart of
``nct_tpu/parallel/mesh.py``).

The JAX package runs one program over a 2-D ``jax.sharding.Mesh`` of chips
with the axes

  * ``data``  -- independent image pairs (the pairs.txt batch axis);
  * ``space`` -- the rows of one pair, for images larger than one chip.

PyTorch has no single-controller mesh.  Here the mesh is SPMD: one process
per rank, every rank calls the same function with the same bucket, and
``make_mesh`` lays the ranks out as the JAX grid, ``reshape(n_data,
n_space)`` of the ranks in order, with one process group per space row
(the ranks that share a pair) and one per data column (the ranks that hold
the same rows of different pairs).  What JAX's ``NamedSharding`` helpers
(``batch_sharding``, ``batch_row_sharding``, ``replicated``) annotated is
explicit code here: the data axis splits a bucket by items
(``parallel.batch``), and the space axis splits the matcher's patch tables
by rows (``parallel.ring_nn``); every other stage runs replicated on each
space rank.

Backend rule: ``"nccl"`` when every rank of the host has a card of its
own, ``"gloo"`` otherwise (ranks that share a card, or ranks on the CPU);
an explicit ``backend=`` wins.  ``launch`` starts a world of ranks in
spawned processes, for tests and single-host runs; ``torchrun
--nproc-per-node N`` works as well, with ``make_mesh`` called after
``init_process_group``.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "space")
# a collective that waits this long has lost a rank: fail instead of hanging
INIT_TIMEOUT = datetime.timedelta(minutes=3)


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ("data", "space") grid of ranks, seen from one rank.

    ``grid[i, j]`` is the global rank at data row i, space column j;
    ``coords`` this rank's (i, j); ``groups[axis]`` the process group of
    this rank along ``axis`` (its space row for "space", its data column
    for "data"); ``device`` the rank's device and ``backend`` the groups'.
    """

    grid: np.ndarray
    coords: tuple[int, int]
    groups: dict
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        """{"data": n_data, "space": n_space}, as JAX's ``Mesh.shape``."""
        return dict(zip(AXES, self.grid.shape))

    def index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]

    def gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated along ``dim`` in
        the axis's order (through host memory for a card's tensor under
        gloo)."""
        if self.shape[axis] == 1:
            return t
        host = self.backend == "gloo" and t.device.type == "cuda"
        src = t.cpu() if host else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(parts, src, group=self.group(axis))
        return torch.cat(parts, dim=dim).to(t.device)

    def ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's group along ``axis``, in order."""
        i, j = self.coords
        return (self.grid[i] if axis == "space" else self.grid[:, j]).tolist()


def backend_for(device_type: str, local_world_size: int) -> str:
    """The backend rule: nccl when each of the host's ranks has a card of
    its own, gloo otherwise."""
    if (device_type == "cuda"
            and local_world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def _local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def make_mesh(n_data: int | None = None, n_space: int = 1,
              device: torch.device | str | None = None,
              backend: str | None = None) -> Mesh:
    """Build the ("data", "space") mesh over the initialised default
    process group.  Every rank must call it, with the same arguments.

    ``n_data`` defaults to world size // ``n_space``; the grid must hold
    every rank.  ``device`` defaults to ``cuda:(local rank % cards)`` and
    raises without a card; pass ``"cpu"`` for a CPU mesh.  ``backend``
    defaults to the rule of ``backend_for``.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's default "
                           "process group (init_process_group or launch)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_space
    if n_data * n_space != world:
        raise ValueError(f"mesh {n_data}x{n_space} does not hold the "
                         f"{world} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the mesh runs on cuda unless device='cpu' is "
                               "passed, and no CUDA device is available")
        device = f"cuda:{_local_rank() % torch.cuda.device_count()}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = backend_for(device.type, _local_world_size())
    grid = np.arange(world).reshape(n_data, n_space)
    rank = dist.get_rank()
    coords = tuple(int(v) for v in np.argwhere(grid == rank)[0])
    # every rank creates every group, in one order, or new_group hangs
    groups = {}
    for i in range(n_data):
        g = dist.new_group(grid[i].tolist(), backend=backend)
        if i == coords[0]:
            groups["space"] = g
    for j in range(n_space):
        g = dist.new_group(grid[:, j].tolist(), backend=backend)
        if j == coords[1]:
            groups["data"] = g
    return Mesh(grid, coords, groups, device, backend)


def pad_to_multiple(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple)


def _run_rank(rank, fn, world_size, args, store_dir, backend, cpu):
    if cpu:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{store_dir}/store",
                            rank=rank, world_size=world_size,
                            timeout=INIT_TIMEOUT)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(store_dir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, world_size: int, *args, store_dir: str | None = None,
           device: str | None = None) -> list:
    """Run ``fn(*args)`` in ``world_size`` spawned ranks and return each
    rank's result, in rank order.

    The ranks meet through a ``file://`` store under ``store_dir`` (a new
    temporary directory by default), so concurrent launches never share a
    port.  ``fn`` must be importable (a module-level function) and build
    its own mesh.  The ranks run on the cards (raising without one) unless
    ``device="cpu"``, which runs each rank on one thread with the gloo
    backend; the default group's backend follows ``backend_for``, as
    ``make_mesh``'s groups do.  Raises when any rank fails (the others are
    then stopped).
    """
    cpu = device == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("launch runs the ranks on cuda unless device='cpu' "
                           "is passed, and no CUDA device is available")
    backend = backend_for("cpu" if cpu else "cuda", world_size)
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        torch.multiprocessing.spawn(
            _run_rank, args=(fn, world_size, args, tmp, backend, cpu),
            nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]
