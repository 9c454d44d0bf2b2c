"""Dump VGG-19 feature maps for images — the ``extract_features`` tool
equivalent (port of ``tools/extract_features.py``; reference:
tools/extract_features.cpp).

    python -m nct_tpu_torch.tools.extract_features out.npz img1.png \\
        [img2.png ...] [--taps conv5_1,conv4_1] [--weights vgg19.npz] \\
        [--device cuda|cpu]

Each tap is saved as ``<image stem>/<tap>``, [H', W', C] float32 (the
port's ``models.vgg19`` taps, post-ReLU).  Runs on ``cuda`` unless given
``--device cpu``, and raises without a card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from nct_tpu_torch.io import imread_bgr
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.pipeline import _resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out")
    p.add_argument("images", nargs="+")
    p.add_argument("--taps", default="conv5_1,conv4_1,conv3_1,conv2_1,conv1_1")
    p.add_argument("--weights", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = _resolve_device(args.device)
    taps = tuple(args.taps.split(","))
    model = (vgg19.load_params(args.weights) if args.weights
             else vgg19.init_params()).to(device)
    blob = {}
    for path in args.images:
        img = torch.from_numpy(imread_bgr(path)).to(device)
        feats = model(img, taps)
        stem = path.rsplit("/", 1)[-1].rsplit(".", 1)[0]
        for t in taps:
            blob[f"{stem}/{t}"] = feats[t].cpu().numpy()
            print(f"{stem}/{t}: {tuple(feats[t].shape)}")
    np.savez(args.out, **blob)
    print(f"wrote {args.out} ({len(blob)} arrays)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
