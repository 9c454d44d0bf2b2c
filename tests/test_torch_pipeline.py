"""The port's ``Config``, its entry points' checks and its CLI against
nct_tpu, and a run of the port that must import no JAX.

The level-by-level comparison of the port's slice with JAX's
``transfer_pair`` is in ``tests/test_torch_space_shard.py``.
"""


import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nct_tpu.config import Config as JaxConfig
from nct_tpu_torch import Config
from nct_tpu_torch import cli as tcli
from nct_tpu_torch import io as tio
from nct_tpu_torch import pipeline as tpipe
from nct_tpu_torch.models import vgg19 as tvgg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_fields_match_jax_config():
    """The port's Config is a copy of nct_tpu.config.Config (so the port
    imports nothing of the JAX package): same fields, same defaults."""
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(Config) == fields(JaxConfig)
    for n in range(1, 7):
        assert Config(num_levels=n).vgg_layers() == \
            JaxConfig(num_levels=n).vgg_layers()


def test_config_methods_match_jax_config():
    for max_len in (1, 63, 680, 960, 1000):
        assert Config().pm_search_radii(max_len) == \
            JaxConfig().pm_search_radii(max_len)
    assert dataclasses.asdict(Config.reference_parity()) == \
        dataclasses.asdict(JaxConfig.reference_parity())
    assert dataclasses.asdict(Config.reference_parity(pm_iters=3)) == \
        dataclasses.asdict(JaxConfig.reference_parity(pm_iters=3))


def test_transfer_pair_without_device_needs_a_card():
    """The default device is cuda; without a card the call raises instead
    of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cnt = np.zeros((24, 28, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.transfer_pair(tvgg.init_params(), cnt, cnt, 2.0)


@pytest.mark.parametrize("overrides", [
    {"fine_strategy": "patchmatch"}, {"exact_nn_levels": 0},
    {"exact_nn_levels": 0, "fine_strategy": "patchmatch"},
])
def test_patchmatch_config_values_run(overrides):
    tpipe.check_config(Config(**overrides))


def test_generator_draws_are_seeded():
    rng = np.random.default_rng(1)
    cnt = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    stl = rng.integers(0, 256, (28, 30, 3)).astype(np.uint8)
    model = tvgg.init_params()
    cfg = Config(cg_iters_mg=3, cg_iters_final_mg=2, wls_cg_iters_mg=2,
                 kmeans_iters=2)
    a, state = tpipe.transfer_pair(model, cnt, stl, 2.0, cfg, seed=5,
                                   device="cpu", return_state=True)
    b = tpipe.transfer_pair(model, cnt, stl, 2.0, cfg, seed=5,
                            device="cpu", warm_start=state)
    assert a.shape == cnt.shape and a.dtype == torch.uint8
    assert float(a.float().std()) > 0
    # level 0 runs the exact search, so the warm start cannot change it
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, stats = tpipe.transfer_pair(model, cnt, stl, 2.0, cfg, seed=5,
                                   device="cpu", return_intermediates="stats")
    assert set(stats[0]) == {"level", "nl_iters", "nl_r2", "wls_iters",
                             "wls_r2"}


@pytest.mark.parametrize("overrides", [{"space_mesh": object()}])
def test_unported_config_values_raise(overrides):
    """space_mesh runs (tests/test_torch_mesh.py), but only as a
    parallel.mesh.Mesh."""
    with pytest.raises(ValueError, match="space_mesh must be"):
        tpipe.check_config(Config(**overrides))


@pytest.mark.parametrize("overrides", [
    {"wls_precond": "jacobi"}, {"knn_memberships": 3},
    {"knn_memberships": 2}, {"nl_precond": "block_jacobi"},
    {"nl_transpose": "scatter"},
])
def test_solver_variant_config_values_accepted(overrides):
    tpipe.check_config(Config(**overrides))


def _pairs_dir(tmp_path):
    rng = np.random.default_rng(2)
    d = tmp_path / "in"
    d.mkdir()
    tio.imwrite_bgr(str(d / "c0.png"),
                    rng.integers(0, 256, (40, 56, 3)).astype(np.uint8))
    tio.imwrite_bgr(str(d / "s0.png"),
                    rng.integers(0, 256, (44, 50, 3)).astype(np.uint8))
    (d / "pairs.txt").write_text("c0.png s0.png 1.5\n")
    return d


def test_cli_cpu_run(tmp_path):
    d = _pairs_dir(tmp_path)
    out = tmp_path / "out"
    # one thread, as in this process: the other test workers share the cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "nct_tpu_torch.cli", "-i", str(d), "-o",
         str(out), "--device", "cpu", "--size", "48"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    img = tio.imread_bgr(str(out / "c0_s0_1.50.png"))
    assert img.shape == (34, 48, 3)            # capped to 48 on the long side


def test_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["-i", str(tmp_path), "-o", str(tmp_path / "o")])


def test_port_never_imports_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import nct_tpu_torch, nct_tpu_torch.cli, nct_tpu_torch.io\n"
        "import nct_tpu_torch.utils.profiling\n"
        "import nct_tpu_torch.tools.profile_stages\n"
        "import nct_tpu_torch.solve.retune, nct_tpu_torch.solve.knn_exact\n"
        "import nct_tpu_torch.data, nct_tpu_torch.parallel.batch\n"
        "import nct_tpu_torch.parallel.mesh, nct_tpu_torch.parallel.ring_nn\n"
        "import nct_tpu_torch.parallel.bucket, nct_tpu_torch.utils.flops\n"
        "import nct_tpu_torch.utils.ssim, nct_tpu_torch.utils.vis\n"
        "import nct_tpu_torch.utils.glog, nct_tpu_torch.models.caffe_io\n"
        "import nct_tpu_torch.tools.convert_vgg19\n"
        "import nct_tpu_torch.nn, nct_tpu_torch.nn.apps\n"
        "import nct_tpu_torch.nn.coord_map, nct_tpu_torch.nn.upgrade\n"
        "import nct_tpu_torch.tools.caffe_tool\n"
        "import nct_tpu_torch.tools.extract_features\n"
        # every module the mesh tests' gloo ranks load
        "import torch_mesh_workers, torch_shard_workers\n"
        "import torch_shard_pm_workers, torch_shard_multi_workers\n"
        "import torch_shard_scatter_workers, torch_shard_short_workers\n"
        "import torch_shard_world_workers\n"
        "from nct_tpu_torch import pipeline\n"
        "from nct_tpu_torch.models import vgg19\n"
        "from nct_tpu_torch import Config\n"
        "rng = np.random.default_rng(0)\n"
        "c = rng.integers(0, 256, (24, 28, 3)).astype(np.uint8)\n"
        "s = rng.integers(0, 256, (26, 30, 3)).astype(np.uint8)\n"
        "cfg = Config(cg_iters_mg=2, cg_iters_final_mg=2, wls_cg_iters_mg=2,"
        " kmeans_iters=2)\n"
        "out = pipeline.transfer_pair(vgg19.init_params(), c, s, 2.0, cfg,"
        " device='cpu')\n"
        "assert tuple(out.shape) == (24, 28, 3)\n"
        "pm = Config(exact_nn_levels=0, fine_strategy='patchmatch', pm_iters=1,"
        " cg_iters_mg=2, cg_iters_final_mg=2, wls_cg_iters_mg=2,"
        " kmeans_iters=2, num_levels=2)\n"
        "outs = list(pipeline.transfer_sequence(vgg19.init_params(), [c, c],"
        " s, 2.0, pm, device='cpu'))\n"
        "assert len(outs) == 2\n"
        "net = nct_tpu_torch.nn.Net('input: \"x\"\\nlayer { name: \"c\" "
        "type: \"Convolution\" bottom: \"x\" top: \"c\" convolution_param "
        "{ num_output: 2 kernel_size: 3 weight_filler { type: \"xavier\" } "
        "} }', device='cpu')\n"
        "net.init_params({'x': (1, 3, 5, 5)})\n"
        "assert tuple(net.forward({'x': torch.ones(1, 3, 5, 5)})['c'].shape)"
        " == (1, 2, 3, 3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nct_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
