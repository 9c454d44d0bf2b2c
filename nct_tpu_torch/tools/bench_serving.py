"""Serving throughput of the port on one card: n requests of one geometry
(port of ``tools/bench_serving.py``).

    python -m nct_tpu_torch.tools.bench_serving [--n N] [--size N] [--mesh]
        [--device cuda|cpu] [--small]

The benchmark pair (``bench.load_pair``) served n times (default 4; the
JAX tool's 8) with seeds 0..n-1, after one warm-up request:

  1. ``sync``: one ``transfer_pair`` at a time, each followed by
     ``torch.cuda.synchronize()`` (the interactive loop);
  2. ``pipeline``: every request enqueued, one ``synchronize()`` at the
     end.  The PCG solves read their stop test on the host every
     iteration, so the host cannot run ahead of the card and this
     measures about what ``sync`` does;
  3. ``mesh`` (``--mesh``): ``make_batch_transfer(Config(), mesh)`` on a
     1x1 mesh (a one-rank process group opened here and closed after),
     the data-parallel program of one card: one warm and one timed call
     of the n-pair bucket.  A bucket holds ~9 GiB of the card per pair at
     452x680, so 8 exceed an 80 GB card (out of memory at 61 GiB
     allocated on an H100).

Every ``pipeline`` output must be bitwise its ``sync`` output.  Prints the
JAX tool's lines, then one JSON object.  ``--size`` defaults to the pair
as it is (the JAX tool's 452 caps its demo pair to 300x452); ``--device``
defaults to ``cuda`` and fails without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile

import torch
import torch.distributed as dist

from nct_tpu_torch.config import Config
from nct_tpu_torch.parallel.batch import make_batch_transfer
from nct_tpu_torch.parallel.mesh import INIT_TIMEOUT, make_mesh
from nct_tpu_torch.pipeline import transfer_pair
from nct_tpu_torch.tools import bench


@contextlib.contextmanager
def one_rank_group():
    """A world of one process (gloo, a ``file://`` store in a temporary
    directory), destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, timeout=INIT_TIMEOUT)
        try:
            yield
        finally:
            dist.destroy_process_group()


def run(n: int = 4, size: int | None = None, mesh: bool = False,
        device: torch.device | str = "cuda", small: bool = False) -> dict:
    device = bench.resolve_device(device)
    cnt, stl = bench.load_pair(bench.SMALL_SIZE if small else size)
    h, w = cnt.shape[:2]
    config = Config()
    model = bench.seeded_model(device)
    cnt_d = torch.from_numpy(cnt).to(device)
    stl_d = torch.from_numpy(stl).to(device)

    def one(i):
        return transfer_pair(model, cnt_d, stl_d, bench.BDS_WEIGHT, config,
                             seed=i, device=device)

    bench.check_image(bench.timed(lambda: one(0), device)[0], (h, w))
    mp = n * h * w / 1e6

    # 1. interactive: sync each request
    def serve_sync():
        outs = []
        for i in range(n):
            outs.append(one(i))
            bench.sync(device)
        return outs
    outs_sync, t_sync = bench.timed(serve_sync, device)

    # 2. pipelined: enqueue all, one synchronize
    outs_pipe, t_pipe = bench.timed(lambda: [one(i) for i in range(n)],
                                    device)
    if not all(torch.equal(a, b) for a, b in zip(outs_sync, outs_pipe)):
        raise AssertionError("a pipelined output differs from its sync one")

    print(f"geometry {w}x{h}, n={n}")
    print(f"sync     : {t_sync:.2f}s  {mp / t_sync:.4f} MP/s/card "
          f"({t_sync / n:.2f} s/pair)")
    print(f"pipeline : {t_pipe:.2f}s  {mp / t_pipe:.4f} MP/s/card "
          f"({t_pipe / n:.2f} s/pair)")
    print(f"pipeline speedup over interactive: {t_sync / t_pipe:.2f}x",
          flush=True)
    result = {"n": n, "geometry": f"{w}x{h}",
              "style": f"{stl.shape[1]}x{stl.shape[0]}",
              "sync": {"s_total": t_sync, "s_per_pair": t_sync / n,
                       "mps": mp / t_sync},
              "pipeline": {"s_total": t_pipe, "s_per_pair": t_pipe / n,
                           "mps": mp / t_pipe},
              "pipeline_speedup": t_sync / t_pipe, "mesh": None}

    # 3. the data-parallel program on a 1x1 mesh
    if mesh:
        cnt_b = cnt_d.expand((n,) + cnt_d.shape)
        stl_b = stl_d.expand((n,) + stl_d.shape)
        seeds = list(range(n))
        with one_rank_group():
            # one rank never communicates: gloo needs no NCCL set-up
            step = make_batch_transfer(config, make_mesh(
                n_data=1, n_space=1, device=device, backend="gloo"))
            first, _ = bench.timed(lambda: step(
                model, cnt_b, stl_b, seeds, bench.BDS_WEIGHT), device)
            out, t_mesh = bench.timed(lambda: step(
                model, cnt_b, stl_b, seeds, bench.BDS_WEIGHT), device)
        bench.check_image(out, (h, w))
        if not torch.equal(out, first):
            raise AssertionError("mesh: the timed bucket differs from the "
                                 "warm-up")
        print(f"mesh(d=1): {t_mesh:.2f}s  {mp / t_mesh:.4f} MP/s/card "
              f"({t_mesh / n:.2f} s/pair) - per-card rate of the "
              f"data-parallel program", flush=True)
        result["mesh"] = {"s_total": t_mesh, "s_per_pair": t_mesh / n,
                          "mps": mp / t_mesh}
    result["device"] = bench.device_record(device)
    return result


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=4, help="requests")
    p.add_argument("--size", type=int, default=None,
                   help="fit both images to this long side (default: the "
                        "pair as it is)")
    p.add_argument("--mesh", action="store_true",
                   help="also time the bucket on a 1x1 mesh")
    bench.add_device_args(p)
    args = p.parse_args(argv)
    result = run(args.n, args.size, args.mesh, args.device, args.small)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
