"""Training stack: LR policies, optimizers, the solver loop with
checkpointing, and the solver-prototxt front end (port of
``nct_tpu/train``).

The training path runs no kernel of its own: its convolutions and
products are ``F.conv2d`` / ``F.linear`` and their gradients autograd's,
as the JAX package's are XLA ops.
"""

from nct_tpu_torch.train.lr_policies import LrPolicy, learning_rate  # noqa: F401
from nct_tpu_torch.train.optimizers import (  # noqa: F401
    OptimizerParams, make_optimizer)
from nct_tpu_torch.train.solver import Solver, SolverParams  # noqa: F401
