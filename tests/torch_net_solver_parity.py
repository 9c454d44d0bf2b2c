"""``NetSolver`` losses of the port and of the JAX package on one net,
the port starting from JAX's initial parameters: the parity check the
data-source tests (``test_torch_records.py``,
``test_torch_window_hdf5.py``) share."""

import io
import os
import re
import sys

import jax
import numpy as np

from nct_tpu.train.solver_proto import NetSolver as JaxNetSolver
from nct_tpu.train.solver_proto import parse_solver_prototxt as jparse
from nct_tpu.utils import glog as jglog
from nct_tpu_torch.nn.net import params_from_jax
from nct_tpu_torch.train.solver_proto import NetSolver, parse_solver_prototxt
from nct_tpu_torch.utils import glog

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke  # noqa: E402,F401  (the small net of phases 13-14)

SOLVER = """base_lr: 0.05
lr_policy: "fixed"
momentum: 0.9
weight_decay: 0.0005
max_iter: 12
display: 1
random_seed: 5
"""


def _losses(text: str) -> list[float]:
    return [float(v) for v in re.findall(r"Iteration \d+, loss = (\S+)",
                                         text)]


def net_solver_losses(mine_net: dict, jax_net: dict):
    """(port's, JAX's) logged losses of SOLVER on the two nets, the port
    starting from JAX's initial parameters."""
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jproto = jparse(SOLVER)
    jproto.net = jax_net
    proto = parse_solver_prototxt(SOLVER)
    proto.net = mine_net
    jglog.set_stream(jbuf)
    glog.set_stream(tbuf)
    try:
        jns = JaxNetSolver(jproto)
        ns = NetSolver(proto, device="cpu")
        ns.set_params(params_from_jax(
            ns.net, jax.tree_util.tree_map(np.asarray, jns.solver.params),
            ns.input_shapes))
        jns.solve()
        ns.solve()
    finally:
        jglog.set_stream(None)
        glog.set_stream(None)
    return _losses(tbuf.getvalue()), _losses(jbuf.getvalue())
