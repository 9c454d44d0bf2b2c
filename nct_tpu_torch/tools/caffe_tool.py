"""The ``caffe`` command-line equivalent on the port: train / test / time
/ device_query (port of ``tools/caffe_tool.py`` and ``tools/layer_time.py``).

Reference: tools/caffe.cpp — train:156-229 builds a solver from --solver
and optionally restores --snapshot; test:231-283 runs forward
``iterations`` times and averages every loss and accuracy output; time()
times each layer's forward; device_query lists the devices.

    python -m nct_tpu_torch.tools.caffe_tool train --solver solver.prototxt \\
        [--snapshot s.npz] [--weights w.caffemodel|w.npz] [--mesh data=N] \\
        [--device cuda|cpu] [--deterministic]
    python -m nct_tpu_torch.tools.caffe_tool test --model net.prototxt \\
        [--weights w.caffemodel] [--iterations N] [--device cuda|cpu]
    python -m nct_tpu_torch.tools.caffe_tool time net.prototxt [H W] \\
        [--iterations N] [--device cuda|cpu]
    python -m nct_tpu_torch.tools.caffe_tool device_query

Every command runs on ``cuda`` unless given ``--device cpu``, and raises
without a card.  ``time`` times each layer alone on the blobs of one whole
forward, then the whole forward, with CUDA events on the card (the host
clock on the CPU).  ``train --mesh data=N`` runs N data-parallel ranks
(``parallel.mesh.launch``) on the host's cards (or CPU processes with
``--device cpu``); rank 0 prints and writes the final snapshot.
``--deterministic`` asks cuDNN for its deterministic algorithms, so two
runs of one solver give the same bits.
"""

from __future__ import annotations

import argparse
import time

import torch

from nct_tpu_torch.nn.layers import LAYER_REGISTRY
from nct_tpu_torch.nn.losses import is_loss_type
from nct_tpu_torch.models.vgg19 import no_tf32
from nct_tpu_torch.nn.net import Net, _bottoms, _tops


def load_net(model: str, device, weights: str | None = None) -> Net:
    """A TEST-phase net, with weights from a .caffemodel if given."""
    net = Net(model, phase="TEST", device=device)
    if weights is not None:
        net.copy_trained_layers_from(weights)
    return net


def _ms_per_call(fn, device: torch.device, iterations: int) -> float:
    """Warm once, then the mean ms of ``iterations`` calls: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iterations):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iterations
    t0 = time.perf_counter()
    for _ in range(iterations):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iterations


def time_layers(net: Net, inputs: dict, iterations: int = 5):
    """([(layer name, type, ms)], whole-forward ms): each layer alone on
    the blobs of one whole forward, then the whole forward."""
    blobs = net.forward(inputs)
    params = net.params
    per_layer = []
    with torch.no_grad(), no_tf32():
        for cfg in net.layers:
            ltype = str(cfg.get("type"))
            if ltype == "Input":
                continue
            fn = LAYER_REGISTRY[ltype]
            lparams = params.get(str(cfg.get("name")), {})
            ins = [blobs[b] for b in _bottoms(cfg)]
            per_layer.append((str(cfg.get("name")), ltype, _ms_per_call(
                lambda: fn(lparams, cfg, *ins), net.device, iterations)))
    with torch.no_grad():
        total = _ms_per_call(lambda: net.forward(inputs), net.device,
                             iterations)
    return per_layer, total


def time_net(model: str, device, dims=(), iterations: int = 5,
             weights: str | None = None, seed: int = 0):
    """``time`` on a prototxt: declared input shapes (their H, W replaced
    by ``dims``), seeded filler weights where ``weights`` has none, seeded
    normal inputs.  Returns (net, per-layer list, whole-forward ms)."""
    net = load_net(model, device, weights)
    shapes = {}
    for name, s in net.input_shapes.items():
        s = tuple(s)
        if dims and len(s) == 4:
            s = s[:2] + (int(dims[0]), int(dims[1]))
        shapes[name] = s
    net.init_params(shapes, seed)
    gen = torch.Generator().manual_seed(seed)
    inputs = {n: torch.randn(s, generator=gen).to(net.device)
              for n, s in shapes.items()}
    per_layer, total = time_layers(net, inputs, iterations)
    return net, per_layer, total


def score_tops(net: Net) -> list[str]:
    return [t for cfg in net.layers for t in _tops(cfg)
            if is_loss_type(str(cfg.get("type")))
            or str(cfg.get("type")) == "Accuracy"]


def score_net(net: Net, iterations: int) -> dict[str, float]:
    """Forward ``iterations`` times and average every loss and accuracy
    output (the tools/caffe.cpp test() loop)."""
    tops = score_tops(net)
    sums = {t: 0.0 for t in tops}
    with torch.no_grad():
        for _ in range(iterations):
            out = net.forward({}, tops)
            for t in tops:
                sums[t] += float(out[t])
    return {t: s / iterations for t, s in sums.items()}


def _train(solver: str, snapshot, weights, device, mesh_n: int,
           deterministic: bool):
    """One rank of ``train`` (or the whole of it without a mesh); returns
    (final loss, final snapshot path, restored iteration or None)."""
    from nct_tpu_torch.train.solver_proto import NetSolver

    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    mesh = None
    if mesh_n > 1:
        from nct_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(n_data=mesh_n, device=device)
    ns = NetSolver(solver, mesh=mesh, device=None if mesh else device)
    if weights:
        ns.load_weights(weights)
    restored = None
    if snapshot:
        ns.restore(snapshot)
        restored = ns.solver.iter
    loss = ns.solve()
    return loss, ns.solver.snapshot(), restored


def cmd_train(args) -> int:
    mesh_n = int(args.mesh.split("=")[-1]) if args.mesh else 1
    if mesh_n > 1:
        from nct_tpu_torch.parallel.mesh import launch

        # each rank takes its card (the mesh's rule) or the CPU
        cpu = args.device == "cpu"
        loss, path, restored = launch(
            _train, mesh_n, args.solver, args.snapshot, args.weights,
            "cpu" if cpu else None, mesh_n, args.deterministic,
            device="cpu" if cpu else None)[0]
    else:
        loss, path, restored = _train(args.solver, args.snapshot,
                                      args.weights, args.device, 1,
                                      args.deterministic)
    if restored is not None:
        print(f"restored iter {restored} from {args.snapshot}")
    print(f"Optimization Done. loss={loss:.6f} snapshot={path}")
    return 0


def cmd_test(args) -> int:
    net = load_net(args.model, args.device, args.weights)
    net.init_params({}, seed=0)  # fill anything the weights didn't cover
    if not score_tops(net):
        print("net has no loss/accuracy outputs to test")
        return 1
    for t, v in score_net(net, args.iterations).items():
        print(f"{t} = {v:.6f}")
    return 0


def cmd_time(args) -> int:
    net, per_layer, total = time_net(args.model, args.device, args.dims,
                                     args.iterations, args.weights)
    clock = ("CUDA events on " + torch.cuda.get_device_name(net.device)
             if net.device.type == "cuda" else "the host clock on the CPU")
    print(f"timing {net.name}: mean of {args.iterations} runs after one, "
          f"{clock}")
    for name, ltype, ms in per_layer:
        print(f"{name:<16} {ltype:<14} {ms:8.3f} ms")
    print(f"whole net forward: {total:.3f} ms")
    return 0


def cmd_device_query(args) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        free, total = torch.cuda.mem_get_info(i)
        print(f"id {i}: {p.name} sm_{p.major}{p.minor} "
              f"{p.multi_processor_count} SMs, memory "
              f"{(total - free) / 2**30:.2f}/{total / 2**30:.2f} GiB in use")
    print(f"devices: {torch.cuda.device_count()}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="action", required=True)
    tr = sub.add_parser("train")
    tr.add_argument("--solver", required=True)
    tr.add_argument("--snapshot", default=None,
                    help="resume from an npz solver state (this port's or "
                         "the JAX package's)")
    tr.add_argument("--weights", default=None,
                    help="initial weights: .caffemodel or an npz snapshot")
    tr.add_argument("--mesh", default=None,
                    help="data=N: split each batch over N ranks (P2PSync)")
    tr.add_argument("--device", default="cuda")
    tr.add_argument("--deterministic", action="store_true",
                    help="cuDNN's deterministic algorithms, without which "
                         "two runs (and a resumed run) differ in the last "
                         "bits on the card")
    te = sub.add_parser("test")
    te.add_argument("--model", required=True)
    te.add_argument("--weights", default=None)
    te.add_argument("--iterations", type=int, default=50)
    te.add_argument("--device", default="cuda")
    ti = sub.add_parser("time")
    ti.add_argument("model")
    ti.add_argument("dims", nargs="*", default=[])
    ti.add_argument("--weights", default=None)
    ti.add_argument("--iterations", type=int, default=5)
    ti.add_argument("--device", default="cuda")
    sub.add_parser("device_query")
    args = ap.parse_args(argv)

    if args.action == "train":
        return cmd_train(args)
    if args.action == "test":
        return cmd_test(args)
    if args.action == "time":
        if len(args.dims) not in (0, 2):
            ap.error("time takes the input's H and W, or neither")
        return cmd_time(args)
    return cmd_device_query(args)


if __name__ == "__main__":
    raise SystemExit(main())
