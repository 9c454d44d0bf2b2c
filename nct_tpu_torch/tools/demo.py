"""The demo directory and the options shared by the diagnosis tools
(``profile_cg``, ``wls_convergence``, ``knn_recall``, ``capture_nl``,
``retune_caps``, ``compare_strategies``, ``diagnose_pair``,
``quality_table``, ``sweep_nl_quality``).

A demo directory holds the pairs ``in/in{i}.png`` / ``in/tar{i}.png`` and,
for the golden tools, ``res/in{i}_tar{i}_{bds:.2f}.png``.  The JAX tools
read one fixed demo directory; the port's tools take it from ``--example``
(default ``$NCT_EXAMPLE``).  Each tool also takes ``--device cuda|cpu``
(default ``cuda``, which raises without a card, as ``tools/bench.py``
does) and drops the JAX tools' ``--staged`` (the fused/staged program split
is a TPU workaround the port does not have).

Every pipeline call of a tool draws from a fresh ``draws()``: the JAX tools
pass the same ``PRNGKey(7)`` to every call, and a draws object is
consumed as it draws.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from nct_tpu_torch import pipeline
from nct_tpu_torch.io import cap_max_size, imread_bgr
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops.resize import resize_bilinear

SEED = 7            # PRNGKey(7) of the JAX tools


def say(line: str) -> None:
    """Print one line of a tool's output at once."""
    print(line, flush=True)


def add_options(ap: argparse.ArgumentParser) -> None:
    """``--device`` and ``--example``, the port's two added options."""
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="torch device (default cuda; fails without a card)")
    ap.add_argument("--example", default=os.environ.get("NCT_EXAMPLE"),
                    help="the demo directory (default $NCT_EXAMPLE)")


def example_dir(example: str | None) -> str:
    if not example:
        raise SystemExit("no demo directory: pass --example DIR or set "
                         "NCT_EXAMPLE")
    return example


def seeded_draws(seed: int = SEED):
    """The default draws factory: ``GeneratorDraws(seed)`` per call."""
    return lambda: pipeline.GeneratorDraws(seed)


def load_model(weights: str | None, device: torch.device) -> vgg19.VGG19:
    """Converted weights (``vgg19.load_params``) or the seeded VGG-19."""
    model = (vgg19.load_params(weights) if weights
             else vgg19.init_params())
    return model.to(device)


def read(example: str, name: str) -> np.ndarray:
    return imread_bgr(os.path.join(example, name))


def read_pair(example: str, i: int, size: int) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """Pair i of the demo directory, each image capped to ``size``."""
    return (np.asarray(cap_max_size(read(example, f"in/in{i}.png"), size)),
            np.asarray(cap_max_size(read(example, f"in/tar{i}.png"), size)))


def golden(example: str, i: int, bds: float = 2.0) -> np.ndarray:
    return read(example, f"res/in{i}_tar{i}_{bds:.2f}.png")


def resized(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``resize_bilinear`` of a numpy image (uint8 in, uint8 out)."""
    return resize_bilinear(torch.from_numpy(np.ascontiguousarray(img)),
                           h, w).numpy()

