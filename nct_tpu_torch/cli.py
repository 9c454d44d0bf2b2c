"""Command-line entry point (port of ``nct_tpu/cli.py``).

    python -m nct_tpu_torch.cli -i <dir with pairs.txt> -o <out dir> [--device cuda|cpu]

Reads ``pairs.txt`` (each line ``cntPath stlPath [bdsWeight]``, paths
relative to the input directory) and writes
``<out>/<cntStem>_<stlStem>_<bds%2.2f>.png`` at the content resolution.
Images are decoded and capped ahead of the card by ``data.PairLoader``;
PNG needs no imaging library.  ``--device`` defaults to ``cuda`` and fails
when no card is present; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from nct_tpu_torch.config import Config
from nct_tpu_torch import io
from nct_tpu_torch.data import PairLoader
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.pipeline import transfer_pair


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nct-torch",
        description="Progressive colour transfer with dense semantic "
        "correspondences (PyTorch / CUDA).",
    )
    p.add_argument("-m", "--model", default=None,
                   help="VGG-19 weights npz (converted caffemodel); "
                   "omit for the seeded random backbone.")
    p.add_argument("-i", "--input", required=True,
                   help="Input directory containing images and pairs.txt.")
    p.add_argument("-o", "--output", required=True,
                   help="Output directory for result images.")
    p.add_argument("-bds", type=float, default=2.0,
                   help="Reverse (completeness) BDS vote weight "
                   "(default 2.0; per-pair value in pairs.txt wins).")
    p.add_argument("-eps", type=float, default=0.6,
                   help="Variance epsilon in the 0-255 domain (default 0.6).")
    p.add_argument("-nl", type=float, default=2.0,
                   help="Nonlocal constraint weight (default 2.0).")
    p.add_argument("-l", type=float, default=0.125,
                   help="Local smoothness weight (default 0.125).")
    p.add_argument("-w", type=float, default=0.024,
                   help="Initial WLS lambda (default 0.024).")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                   help="Feature compute dtype (default: Config's "
                        f"{Config.feature_dtype}).")
    p.add_argument("--seed", type=int, default=7, help="Random seed.")
    p.add_argument("--size", type=int, default=None,
                   help="Override MAX_SIZE (longer-side cap, default 1000).")
    p.add_argument("--pairs-limit", type=int, default=None,
                   help="Process only the first N pairs.txt lines.")
    p.add_argument("--device", default="cuda",
                   help="Torch device (default cuda; 'cpu' runs the plain "
                   "PyTorch path).")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but no CUDA device is "
                           "available (pass --device cpu to run on the CPU)")
    os.makedirs(args.output, exist_ok=True)

    config = Config(
        var_epsilon=args.eps,
        nonlocal_weight=args.nl, local_weight=args.l,
        wls_lambda_init=args.w,
        feature_dtype=args.dtype or Config.feature_dtype,
        max_size=args.size if args.size else Config.max_size,
    )
    if args.model:
        model = vgg19.load_params(args.model)
    else:
        print("warning: no --model given; using seeded random VGG-19 "
              "filters (correspondence quality is reduced)")
        model = vgg19.init_params()
    model = model.to(device)

    pairs = io.read_pairs(os.path.join(args.input, "pairs.txt"),
                          default_bds=args.bds)
    if args.pairs_limit is not None:
        pairs = pairs[: args.pairs_limit]
    loader = PairLoader(
        [(os.path.join(args.input, p.content),
          os.path.join(args.input, p.style)) for p in pairs],
        max_size=config.max_size)
    try:
        for pair, item in zip(pairs, loader):
            if item is None:  # the reference continues past unreadable images
                print(f"error: failed reading pair {pair.content}/"
                      f"{pair.style}; skipping")
                continue
            cnt, stl = item
            print(f"content: {pair.content} {cnt.shape[1]}x{cnt.shape[0]}, "
                  f"style: {pair.style} {stl.shape[1]}x{stl.shape[0]}, "
                  f"bds: {pair.bds_weight}")
            start = time.perf_counter()
            result = transfer_pair(model, cnt, stl, pair.bds_weight, config,
                                   seed=args.seed, device=device)
            result = result.cpu().numpy()
            print(f"**Finished Time: {time.perf_counter() - start:.3f} sec.")
            out_path = os.path.join(args.output, io.output_name(
                pair.content, pair.style, pair.bds_weight))
            io.imwrite_bgr(out_path, result)
            print(f"final output file: {out_path}\n")
    finally:
        loader.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
