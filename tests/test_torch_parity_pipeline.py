"""The port's transfer_pair under each solver variant on its CPU path.

Each Config value that selects a solver variant runs ``transfer_pair`` on
the port's CPU path alone, within its iteration caps.  The level-by-level
comparison of ``Config.reference_parity`` with JAX's ``transfer_pair`` is
in ``tests/test_torch_space_shard.py``, beside the other whole-pipeline
JAX references: one process compiles JAX's pipeline once for them all.
"""

import numpy as np
import pytest
import torch

from nct_tpu_torch import Config
from nct_tpu_torch import pipeline as tpipe
from nct_tpu_torch.models import vgg19 as tvgg

torch.set_num_threads(1)


SMALL = dict(cg_iters_mg=3, cg_iters_final_mg=2, wls_cg_iters_mg=2,
             cg_iters=3, cg_iters_final=2, wls_cg_iters=3, kmeans_iters=2)


@pytest.mark.parametrize("config", [
    Config.reference_parity(),
    Config(knn_memberships=2, **SMALL),
    Config(knn_memberships=3, **SMALL),
    Config(nl_transpose="scatter", **SMALL),
    Config(nl_precond="block_jacobi", **SMALL),
    Config(wls_precond="jacobi", **SMALL),
], ids=["reference_parity", "memberships2", "memberships3", "scatter",
        "block_jacobi", "wls_jacobi"])
def test_variant_configs_run_on_cpu(config):
    rng = np.random.default_rng(1)
    cnt = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (28, 30, 3)).astype(np.uint8)
    out, trace = tpipe.transfer_pair(tvgg.init_params(), cnt, stl, 2.0,
                                     config, seed=5, device="cpu",
                                     return_intermediates="stats")
    assert out.shape == cnt.shape and out.dtype == torch.uint8
    assert float(out.float().std()) > 0
    final = config.num_levels - 1
    for tr in trace:
        if config.nl_precond == "mg":
            cap = (config.cg_iters_final_mg if tr["level"] == final
                   else config.cg_iters_mg)
        else:
            cap = (config.cg_iters_final if tr["level"] == final
                   else config.cg_iters)
        wls_cap = (config.wls_cg_iters_mg if config.wls_precond == "mg"
                   else config.wls_cg_iters)
        assert 0 < tr["nl_iters"] <= cap
        assert 0 < tr["wls_iters"] <= wls_cap
        assert np.isfinite(float(tr["nl_r2"]))
