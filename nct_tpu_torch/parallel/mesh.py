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
(``parallel.batch``), and the space axis splits a pair by rows.

Row bands (the counterpart of GSPMD's row sharding over ``space``):
``image_bands`` splits an input image's rows into one band per space rank,
with boundaries on multiples of ``UNIT_ROWS`` (16 = 2**4, one factor of
two per ceil-mode pool before ``conv5_1``), so that every VGG grid, pyramid
level and solver grid of the pair starts each band on a whole row (an
image of fewer units than ranks gives the trailing ranks bands of zero
rows, at every grid);
``RowBand`` is one grid's split seen from one rank, with the exchanges the
band stages need: ``halo`` (edge rows swapped with the bands above and
below), ``reduce_sum`` (partials gathered and added in rank order, so every
rank gets the same bits), ``gather`` (the bands' rows concatenated) and
``exchange`` (variable-size messages to each rank).  ``COMM`` counts their
calls and host seconds.

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
import time

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "space")
# a collective that waits this long has lost a rank: fail instead of hanging
INIT_TIMEOUT = datetime.timedelta(minutes=3)
# band boundaries of an input image fall on multiples of this many rows
UNIT_ROWS = 16
# calls and host seconds of the band exchanges, by kind (set to 0 freely)
COMM = {f"{kind}_{what}": 0 if what == "calls" else 0.0
        for kind in ("halo", "reduce", "gather", "exchange")
        for what in ("calls", "s")}


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


def _staged(mesh: "Mesh", t: torch.Tensor) -> bool:
    """gloo moves host memory only: a card's tensor goes through the host."""
    return mesh.backend == "gloo" and t.device.type == "cuda"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _p2p(mesh: "Mesh", axis: str, sends: dict, recvs: dict) -> None:
    """Point-to-point sends and receives along ``axis``: {axis index:
    tensor}; one message each way per peer (a card's tensors staged
    through pinned host buffers under gloo)."""
    ranks = mesh.ranks(axis)
    group = mesh.group(axis)
    staged = {}
    ops = []
    for j, t in sends.items():
        src = _to_host(t) if _staged(mesh, t) else t.contiguous()
        ops.append(dist.P2POp(dist.isend, src, ranks[j], group))
    for j, t in recvs.items():
        dst = t
        if _staged(mesh, t):
            dst = staged[j] = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True)
        ops.append(dist.P2POp(dist.irecv, dst, ranks[j], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for j, host in staged.items():
        recvs[j].copy_(host)


def _all_gather(mesh: "Mesh", axis: str, t: torch.Tensor) -> list:
    """Every rank's ``t`` (equal shapes) along ``axis``, in axis order, on
    ``t``'s device."""
    src = t.cpu() if _staged(mesh, t) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, src, group=mesh.group(axis))
    return [p.to(t.device) for p in parts]


def image_bands(h: int, n: int, unit: int = UNIT_ROWS) -> list[int]:
    """Row boundaries [0, b_1, .., b_{n-1}, h] of ``n`` bands of an image
    of ``h`` rows: each inner boundary a multiple of ``unit`` (or ``h``),
    as near the even split as that allows, every band at least one unit
    (the last takes the ceil-mode overhang).

    An image of fewer units than ``n`` gives each of its first ``units``
    ranks one unit and the trailing ranks a band of zero rows (boundaries
    at ``h``): such a rank holds nothing, yet joins every exchange of the
    band stages, which take zero-row bands as they come."""
    units = -(-h // unit)
    if n > units:
        return [min(k * unit, h) for k in range(n)] + [h]
    bounds = [0]
    for k in range(1, n):
        b = math.floor(k * h / (n * unit) + 0.5)
        bounds.append(max(bounds[-1] + 1, min(b, units - (n - k))))
    return [b * unit for b in bounds] + [h]


@dataclasses.dataclass(frozen=True, eq=False)
class RowBand:
    """One grid's row split over ``mesh``'s ``axis``, seen from one rank:
    band j holds rows [starts[j], starts[j+1]) of ``h`` (the last to ``h``).
    A band may hold no rows (``image_bands`` of a short image gives the
    trailing ranks such bands, each starting at ``h``): it asks for no
    halo and sends none, and joins every exchange all the same.

    ``of_image(bounds, shift, h)`` is the band of the grid at input /
    2**shift (a VGG tap or pyramid level with ceil dims ``h``; an empty
    band starts at ``h`` on every grid).  Tensors of
    a band hold its rows on dimension ``dim`` (an image [..., rows, W, C]
    on -3, a map [..., rows, W] on -2); leading axes are a batch.
    """

    mesh: Mesh
    axis: str
    starts: tuple
    h: int

    @classmethod
    def of_image(cls, mesh: Mesh, axis: str, bounds: list, shift: int,
                 h: int) -> "RowBand":
        return cls(mesh, axis, tuple(b >> shift if b < bounds[-1] else h
                                     for b in bounds[:-1]), h)

    @property
    def n(self) -> int:
        return len(self.starts)

    @property
    def r(self) -> int:
        return self.mesh.index(self.axis)

    def span(self, j: int) -> tuple[int, int]:
        """Rows [start, stop) of band j."""
        stop = self.starts[j + 1] if j + 1 < self.n else self.h
        return self.starts[j], stop

    def holds(self, j: int) -> bool:
        """Whether band j holds any rows."""
        start, stop = self.span(j)
        return stop > start

    @property
    def start(self) -> int:
        return self.starts[self.r]

    @property
    def stop(self) -> int:
        return self.span(self.r)[1]

    @property
    def rows(self) -> int:
        return self.stop - self.start

    def take(self, t: torch.Tensor, dim: int = -3) -> torch.Tensor:
        """This rank's rows of a whole-grid tensor."""
        return t.narrow(dim, self.start, self.rows)

    def owner(self, rows: torch.Tensor) -> torch.Tensor:
        """The band (rank index) holding each global row of ``rows``."""
        bounds = torch.tensor(self.starts[1:], device=rows.device,
                              dtype=rows.dtype)
        return torch.bucketize(rows, bounds, right=True)

    def coarsen(self) -> "RowBand | None":
        """The band of the grid at half resolution (ceil dims), or None
        when a band holding rows would start on an odd row.  Empty bands
        (at ``h``) stay empty at the new ``h``."""
        if any(s % 2 for s in self.starts if s < self.h):
            return None
        h = -(-self.h // 2)
        return RowBand(self.mesh, self.axis,
                       tuple(s // 2 if s < self.h else h
                             for s in self.starts), h)

    def halo(self, t: torch.Tensor, above: int, below: int,
             dim: int = -3) -> tuple[torch.Tensor, int, int]:
        """``t`` (this band's rows on ``dim``) with the ``above`` rows
        above the band and the ``below`` rows below it concatenated on,
        as far as the image has them (none past its top or bottom edge).
        Rows come from whichever bands hold them: a halo may reach past a
        neighbour shorter than it.  Returns (extended tensor, rows added
        above, rows added below).  Every rank of the axis calls it with
        the same counts."""
        t0 = time.perf_counter()
        r = self.r
        start, stop = self.start, self.stop

        def wanted(j):
            """The rows band j asks for: above it, then below it (none
            for an empty band)."""
            js, je = self.span(j)
            if not self.holds(j):
                return (js, js), (je, je)
            return ((js - min(above, js), js),
                    (je, je + min(below, self.h - je)))

        def overlap(rows, j):
            js, je = self.span(j)
            return [(max(lo, js), min(hi, je)) for lo, hi in rows
                    if max(lo, js) < min(hi, je)]

        sends, recvs = {}, {}
        shape = list(t.shape)
        for j in range(self.n):
            if j == r:
                continue
            # a band lies wholly above or below band j: one range each way
            for lo, hi in overlap(wanted(j), r):
                sends[j] = t.narrow(dim, lo - start, hi - lo)
            for lo, hi in overlap(wanted(r), j):
                shape[dim] = hi - lo
                recvs[j] = t.new_empty(shape)
        _p2p(self.mesh, self.axis, sends, recvs)
        (lo_top, _), (_, hi_bottom) = wanted(r)
        parts = ([recvs[j] for j in sorted(recvs) if j < r] + [t]
                 + [recvs[j] for j in sorted(recvs) if j > r])
        out = torch.cat(parts, dim=dim) if len(parts) > 1 else t
        top, bottom = start - lo_top, hi_bottom - stop
        COMM["halo_calls"] += 1
        COMM["halo_s"] += time.perf_counter() - t0
        return out, top, bottom

    def gather(self, t: torch.Tensor, dim: int = -3) -> torch.Tensor:
        """Every band's rows of ``t`` concatenated on ``dim``: the whole
        grid, on every rank."""
        t0 = time.perf_counter()
        most = max(self.span(j)[1] - self.span(j)[0] for j in range(self.n))
        pad = list(t.shape)
        pad[dim] = most - t.shape[dim]
        src = torch.cat([t, t.new_zeros(pad)], dim=dim) if pad[dim] else t
        parts = _all_gather(self.mesh, self.axis, src)
        out = torch.cat([p.narrow(dim, 0, self.span(j)[1] - self.span(j)[0])
                         for j, p in enumerate(parts)], dim=dim)
        COMM["gather_calls"] += 1
        COMM["gather_s"] += time.perf_counter() - t0
        return out

    def reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (equal shapes), added in rank
        order: the same bits on every rank and in every run."""
        t0 = time.perf_counter()
        parts = _all_gather(self.mesh, self.axis, t)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        COMM["reduce_calls"] += 1
        COMM["reduce_s"] += time.perf_counter() - t0
        return total

    def all_parts(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (equal shapes), in rank order."""
        t0 = time.perf_counter()
        parts = _all_gather(self.mesh, self.axis, t)
        COMM["reduce_calls"] += 1
        COMM["reduce_s"] += time.perf_counter() - t0
        return parts

    def reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """Elementwise ``op`` ("min" or "max") over every rank's ``t``:
        exact, so in any order."""
        t0 = time.perf_counter()
        parts = torch.stack(_all_gather(self.mesh, self.axis, t))
        out = parts.amin(0) if op == "min" else parts.amax(0)
        COMM["reduce_calls"] += 1
        COMM["reduce_s"] += time.perf_counter() - t0
        return out

    def exchange(self, parts: list) -> list:
        """Send ``parts[j]`` to band j (every part of one dtype, equal
        beyond dim 0); returns the part each band sent here, in band order
        (this rank's own part passes through)."""
        t0 = time.perf_counter()
        r = self.r
        dev = parts[0].device
        counts = torch.tensor([p.shape[0] for p in parts], dtype=torch.int64)
        table = torch.stack(_all_gather(self.mesh, self.axis, counts.to(dev)))
        got = table[:, r].tolist()
        tail = tuple(parts[0].shape[1:])
        recvs = {j: parts[0].new_empty((got[j],) + tail)
                 for j in range(self.n) if j != r and got[j]}
        sends = {j: p for j, p in enumerate(parts) if j != r and p.shape[0]}
        _p2p(self.mesh, self.axis, sends, recvs)
        out = [parts[r] if j == r else recvs.get(
            j, parts[0].new_empty((0,) + tail)) for j in range(self.n)]
        COMM["exchange_calls"] += 1
        COMM["exchange_s"] += time.perf_counter() - t0
        return out


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
