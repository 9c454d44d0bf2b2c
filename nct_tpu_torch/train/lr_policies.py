"""Learning-rate schedules: Caffe's seven policies (port of
``nct_tpu/train/lr_policies.py``).

Reference: src/caffe/solvers/sgd_solver.cpp:27-62 (GetLearningRate).  The
arithmetic is float32, as the JAX package's is (the iteration is cast to
float32), and the rate is a 0-d float32 CPU tensor, which the updates use
as a scalar on any device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class LrPolicy:
    policy: str = "fixed"          # fixed|step|exp|inv|multistep|poly|sigmoid
    base_lr: float = 0.01
    gamma: float = 0.1
    power: float = 0.75
    stepsize: int = 100000
    stepvalues: tuple[int, ...] = field(default_factory=tuple)
    max_iter: int = 100000


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def learning_rate(p: LrPolicy, it) -> torch.Tensor:
    """Rate at iteration ``it``; ref :27-62."""
    it = _f32(float(it))
    base, gamma = _f32(p.base_lr), _f32(p.gamma)
    if p.policy == "fixed":
        return base
    if p.policy == "step":
        return base * torch.pow(gamma, torch.floor(it / p.stepsize))
    if p.policy == "exp":
        return base * torch.pow(gamma, it)
    if p.policy == "inv":
        return base * torch.pow(1.0 + gamma * it, -_f32(p.power))
    if p.policy == "multistep":
        current = sum(float(it >= s) for s in p.stepvalues)
        return base * torch.pow(gamma, _f32(current))
    if p.policy == "poly":
        return base * torch.pow(1.0 - it / p.max_iter, _f32(p.power))
    if p.policy == "sigmoid":
        return base / (1.0 + torch.exp(-gamma * (it - p.stepsize)))
    raise ValueError(f"unknown lr_policy {p.policy!r}")
