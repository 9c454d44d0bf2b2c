"""The port's training stack (``nct_tpu_torch.train``, ``Net.make_loss_fn``)
against the JAX package's ``nct_tpu.train`` on the same seeded inputs.

Tolerances (float32): the lr policies and the optimizers' updates rtol
1e-6; autograd against ``jax.grad`` rtol 1e-5; a run restored from a JAX
snapshot against JAX's own continuation rtol 1e-5; the 2-rank data mesh
against the single-process step rtol 1e-6 (with and without Dropout, and
NetSolver over ImageData, each rank decoding its half of each batch).
Snapshot / restore within the port is bitwise, and restores the data
stream without decoding the batches already used.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nct_tpu.nn import LAYER_REGISTRY as JAX_REGISTRY
from nct_tpu.nn.prototxt import parse_prototxt as jparse_net
from nct_tpu.train import lr_policies as jlr
from nct_tpu.train import optimizers as jopt
from nct_tpu.train.solver_proto import NetSolver as JaxNetSolver
from nct_tpu.train.solver_proto import parse_solver_prototxt as jparse
from nct_tpu_torch.nn import LAYER_REGISTRY, parse_prototxt
from nct_tpu_torch.parallel.mesh import launch
from nct_tpu_torch.train import lr_policies, optimizers
from nct_tpu_torch.train.solver_proto import NetSolver, parse_solver_prototxt

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke  # noqa: E402  (the nets and the mesh rank of phase 13)

torch.set_num_threads(1)

IMAGES = os.path.join(os.path.dirname(__file__), "fixtures", "jpeg",
                      "imagedata")

POLICIES = [dict(policy="fixed"), dict(policy="step", stepsize=100),
            dict(policy="exp", gamma=0.999),
            dict(policy="inv", gamma=1e-3, power=0.75),
            dict(policy="multistep", stepvalues=(100, 400, 800)),
            dict(policy="poly", max_iter=1000, power=2.0),
            dict(policy="sigmoid", gamma=-0.01, stepsize=500)]


@pytest.mark.parametrize("kw", POLICIES, ids=[p["policy"] for p in POLICIES])
def test_lr_policy_like_jax(kw):
    its = range(0, 1001)
    want = np.array([float(jlr.learning_rate(jlr.LrPolicy(base_lr=0.01, **kw),
                                             i)) for i in its], np.float32)
    got = np.array([float(lr_policies.learning_rate(
        lr_policies.LrPolicy(base_lr=0.01, **kw), i)) for i in its],
        np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _tree(rng):
    return {"conv": {"w": rng.standard_normal((4, 3, 2, 2)).astype(np.float32),
                     "b": rng.standard_normal(4).astype(np.float32)},
            "ip": {"w": rng.standard_normal((5, 7)).astype(np.float32)}}


SOLVER_TYPES = ["sgd", "nesterov", "adagrad", "rmsprop", "adadelta", "adam"]


def _run_optimizers(solver_type, **extra):
    """5 steps of the JAX and the port optimizer on the same trees; returns
    the leaves of both (params, state)."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    kw = dict(solver_type=solver_type, weight_decay=5e-4, iter_size=2,
              momentum=0.95 if solver_type == "adadelta" else 0.9,
              delta=1e-6 if solver_type == "adadelta" else 1e-8, **extra)
    j_init, j_update = jopt.make_optimizer(jopt.OptimizerParams(**kw))
    t_init, t_update = optimizers.make_optimizer(
        optimizers.OptimizerParams(**kw))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(torch.from_numpy, params)
    js, ts = j_init(jp), t_init(tp)
    assert jax.tree_util.tree_structure(js) == \
        jax.tree_util.tree_structure(ts)
    for it in range(5):
        jp, js = j_update(jp, jax.tree_util.tree_map(jnp.asarray, grads[it]),
                          js, jnp.float32(0.01), it)
        tp, ts = t_update(tp, jax.tree_util.tree_map(torch.from_numpy,
                                                     grads[it]),
                          ts, torch.tensor(0.01), it)
    return (jax.tree_util.tree_leaves((jp, js)),
            [t.numpy() for t in jax.tree_util.tree_leaves((tp, ts))])


@pytest.mark.parametrize("solver_type", SOLVER_TYPES)
def test_optimizer_like_jax(solver_type):
    """5 steps with iter_size and weight decay: rtol 1e-6, and atol 1e-9
    for history entries that cancel to ~1e-6 (XLA fuses momentum * h + lr
    * g, the port rounds each product)."""
    for want, got in zip(*_run_optimizers(solver_type)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("solver_type", SOLVER_TYPES)
def test_optimizer_with_clipping_like_jax(solver_type):
    """The same 5 steps with ClipGradients at a norm every step exceeds.
    The global norm is a float32 sum whose order differs between XLA and
    ATen (one ulp here), and the RMSProp / Adam steps divide by small
    histories, so the bound is rtol 1e-5."""
    for want, got in zip(*_run_optimizers(solver_type, clip_gradients=2.0)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-9)


# --- gradient checks (tests/test_train_net.py:52-98), through autograd ----

def check_gradient(fn, x, step=1e-3, threshold=1e-2):
    """Autograd of ``fn`` (tensor -> scalar) at ``x`` against central
    differences, with the reference checker's rule |analytic - numeric| <=
    threshold * max(|analytic|, |numeric|, 1); returns the analytic
    gradient."""
    x = torch.tensor(np.asarray(x, np.float32), requires_grad=True)
    analytic, = torch.autograd.grad(fn(x), x)
    flat = x.detach().clone().reshape(-1)
    numeric = torch.zeros_like(flat)
    with torch.no_grad():
        for i in range(flat.numel()):
            orig = float(flat[i])
            flat[i] = orig + step
            fp = float(fn(flat.view_as(x)))
            flat[i] = orig - step
            fm = float(fn(flat.view_as(x)))
            flat[i] = orig
            numeric[i] = (fp - fm) / (2 * step)
    a = analytic.reshape(-1)
    scale = torch.clamp(torch.maximum(a.abs(), numeric.abs()), min=1.0)
    err = ((a - numeric).abs() / scale).max()
    assert float(err) <= threshold, float(err)
    return analytic.numpy()


def _jax_grad(fn, x):
    return np.asarray(jax.grad(fn)(jnp.asarray(x)))


def test_gradient_checker_conv_and_jax_grad():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 2, 5, 5)).astype(np.float32)      # NCHW
    w = (rng.standard_normal((4, 2, 3, 3)) * 0.5).astype(np.float32)  # OIHW
    cfg = {"convolution_param": {"num_output": 4, "kernel_size": 3,
                                 "pad": 1}}
    conv, jconv = LAYER_REGISTRY["Convolution"], JAX_REGISTRY["Convolution"]
    gx = check_gradient(lambda v: torch.sum(
        conv({"w": torch.from_numpy(w)}, cfg, v) ** 2), x, step=1e-2)
    gw = check_gradient(lambda v: torch.sum(
        conv({"w": v}, cfg, torch.from_numpy(x)) ** 2), w, step=1e-2)
    x_nhwc, w_hwio = x.transpose(0, 2, 3, 1), w.transpose(2, 3, 1, 0)
    jx = _jax_grad(lambda v: jnp.sum(jconv({"w": jnp.asarray(w_hwio)}, cfg,
                                           v) ** 2), x_nhwc)
    jw = _jax_grad(lambda v: jnp.sum(jconv({"w": v}, cfg,
                                           jnp.asarray(x_nhwc)) ** 2), w_hwio)
    np.testing.assert_allclose(gx, jx.transpose(0, 3, 1, 2), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gw, jw.transpose(3, 2, 0, 1), rtol=1e-5,
                               atol=1e-5)


def _loss_cases(rng):
    scores = rng.standard_normal((4, 5)).astype(np.float32)
    a = rng.standard_normal((3, 7)).astype(np.float32)
    b = rng.standard_normal((3, 7)).astype(np.float32)
    t = (rng.uniform(size=(3, 7)) > 0.5).astype(np.float32)
    return [
        ("SoftmaxWithLoss", {}, scores, np.array([0, 2, 4, 1])),
        ("EuclideanLoss", {}, a, b),
        ("SigmoidCrossEntropyLoss", {}, a, t),
        ("HingeLoss", {"hinge_loss_param": {"norm": "L2"}}, a,
         np.array([1, 3, 0])),
    ]


@pytest.mark.parametrize("index", range(4), ids=[
    "softmax", "euclidean", "sigmoid-xent", "hinge-l2"])
def test_gradient_checker_losses_and_jax_grad(index):
    ltype, cfg, x, other = _loss_cases(np.random.default_rng(1))[index]
    fn, jfn = LAYER_REGISTRY[ltype], JAX_REGISTRY[ltype]
    g = check_gradient(lambda v: fn({}, cfg, v, torch.from_numpy(other)), x)
    jg = _jax_grad(lambda v: jfn({}, cfg, v, jnp.asarray(other)), x)
    np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-6)


# --- NetSolver runs: snapshot / restore ------------------------------------

def _solver_text(max_iter, snapshot=0, prefix="snap", solver_type="SGD"):
    return (f'base_lr: 0.05\nlr_policy: "step"\nstepsize: 4\ngamma: 0.5\n'
            f'momentum: 0.9\nweight_decay: 0.0005\nmax_iter: {max_iter}\n'
            f'snapshot: {snapshot}\nsnapshot_prefix: "{prefix}"\n'
            f'type: "{solver_type}"\nrandom_seed: 3\n')


def _net_solver(tmp_path, max_iter, snapshot=0, prefix="snap", jax=False,
                solver_type="SGD", dropout=True):
    """(NetSolver, the NCHW batch arrays) over chip_smoke.small_train_net
    with a MemoryData layer of 16 seeded items."""
    text = chip_smoke.small_train_net(8, dropout=dropout)
    rng = np.random.default_rng(7)
    data = rng.standard_normal((16, 3, 12, 12)).astype(np.float32)
    labels = rng.integers(0, 4, 16).astype(np.float32)
    solver_text = _solver_text(max_iter, snapshot, str(tmp_path / prefix),
                               solver_type)
    if jax:
        proto = jparse(solver_text)
        net = jparse_net(text)
        net["layer"][0]["__arrays__"] = (data.transpose(0, 2, 3, 1), labels)
        proto.net = net
        return JaxNetSolver(proto), data
    proto = parse_solver_prototxt(solver_text)
    net = parse_prototxt(text)
    net["layer"][0]["__arrays__"] = (data, labels)
    proto.net = net
    return NetSolver(proto, device="cpu"), data


def _params_np(params):
    return {k: {b: v.detach().numpy().copy() for b, v in e.items()}
            for k, e in params.items()}


def test_snapshot_restore_bitwise_an_uninterrupted_run(tmp_path):
    whole, _ = _net_solver(tmp_path, 6)
    whole.solve()
    first, _ = _net_solver(tmp_path, 3, prefix="part")
    first.solve()
    path = first.solver.snapshot()
    assert path.endswith("part_iter_3.npz")
    rest, _ = _net_solver(tmp_path, 6)
    rest.restore(path)
    assert rest.solver.iter == 3
    rest.solve()
    want, got = _params_np(whole.net.params), _params_np(rest.net.params)
    for name in want:
        for blob in want[name]:
            np.testing.assert_array_equal(got[name][blob], want[name][blob])


def test_jax_snapshot_restored_continues_like_jax(tmp_path):
    """JAX trains 3 steps and snapshots; the port restores that snapshot
    (layouts through params_from_jax's rules, the momentum history too) and
    both continue 3 steps on the same batches."""
    jns, data = _net_solver(tmp_path, 6, jax=True, dropout=False)
    labels = jns.data_source.labels
    for it in range(3):
        idx = [(8 * it + i) % 16 for i in range(8)]
        jns.solver.step({"data": data[idx].transpose(0, 2, 3, 1),
                         "label": labels[idx]})
    path = jns.solver.snapshot(str(tmp_path / "jax_iter_3.npz"))
    tns, _ = _net_solver(tmp_path, 6, dropout=False)
    tns.solver.restore(path)
    assert tns.solver.iter == 3
    for it in range(3, 6):
        idx = [(8 * it + i) % 16 for i in range(8)]
        jl = jns.solver.step({"data": data[idx].transpose(0, 2, 3, 1),
                              "label": labels[idx]})
        tl = tns.solver.step({"data": data[idx], "label": labels[idx]})
        assert tl == pytest.approx(jl, rel=1e-5)
    want = tns._from_jax(jax.tree_util.tree_map(np.asarray,
                                                jns.solver.params))
    got = _params_np(tns.solver.params)
    for name in want:
        for blob in want[name]:
            np.testing.assert_allclose(got[name][blob], want[name][blob],
                                       rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Phase 13e's cases (``chip_smoke.train_cases``) in this process and
    on 2 CPU ranks of a 2x1 data mesh (one spawn for every case)."""
    args = (chip_smoke.mesh_batch(), os.path.join(IMAGES, "list.txt"),
            IMAGES + "/")
    ranks = launch(chip_smoke.train_mesh_rank, 2, *args, 2, "cpu",
                   store_dir=str(tmp_path_factory.mktemp("mesh")),
                   device="cpu")
    return chip_smoke.train_cases(*args, "cpu"), ranks


def _assert_mesh_case(mesh_runs, case):
    single, ranks = mesh_runs
    for out in ranks:
        assert out[case]["loss"] == pytest.approx(single[case]["loss"],
                                                  rel=1e-6)
        for name in single[case]["params"]:
            for blob, want in single[case]["params"][name].items():
                np.testing.assert_allclose(out[case]["params"][name][blob],
                                           want, rtol=1e-6, atol=1e-7)


def test_data_mesh_step_equals_the_single_process_step(mesh_runs):
    """2 CPU ranks over a 2x1 data mesh, each on half of a batch of 8, one
    all-reduce of the gradients: the single-process step (rtol 1e-6)."""
    _assert_mesh_case(mesh_runs, "plain")


def test_data_mesh_step_with_dropout_equals_the_single_process_step(
        mesh_runs):
    """Each rank draws its block of the whole batch's Dropout mask, so the
    two ranks together apply the single process's mask."""
    _assert_mesh_case(mesh_runs, "dropout")


def test_net_solver_over_a_data_mesh_decodes_its_half(mesh_runs):
    """NetSolver over ImageData (random crops, mirror, Dropout) on the
    mesh: each rank decodes half of every batch and the run equals the
    single-process run (rtol 1e-6)."""
    _assert_mesh_case(mesh_runs, "net_solver")
    single, ranks = mesh_runs
    assert single["net_solver"]["decoded"] == \
        8 * chip_smoke.MESH_NET_SOLVER_ITERS
    for out in ranks:
        assert 2 * out["net_solver"]["decoded"] == \
            single["net_solver"]["decoded"]


def _image_net_solver(max_iter, snapshot=0, prefix=None):
    """A NetSolver of small_train_net with Dropout over ImageData (random
    crops and mirror of the fixture JPEGs)."""
    text = (f'base_lr: 0.01\nmomentum: 0.9\nlr_policy: "fixed"\n'
            f'max_iter: {max_iter}\nsnapshot: {snapshot}\n'
            f'snapshot_prefix: "{prefix}"\nrandom_seed: 6\n')
    proto = parse_solver_prototxt(text)
    proto.net = parse_prototxt(chip_smoke.small_train_net(
        8, image_list=os.path.join(IMAGES, "list.txt"), crop=True,
        root=IMAGES + "/"))
    return NetSolver(proto, device="cpu")


def test_image_data_resume_decodes_only_new_batches(tmp_path):
    """A snapshot of a NetSolver over ImageData carries the stream's
    position: the restore decodes no image, and the resumed run is
    bitwise the uninterrupted one."""
    whole = _image_net_solver(5)
    whole.solve()
    first = _image_net_solver(2, snapshot=2, prefix=tmp_path / "part")
    first.solve()
    path = str(tmp_path / "part_iter_2.npz")
    with np.load(path) as f:
        assert int(f["stream/pos"]) == 16
    rest = _image_net_solver(5)
    decoded = rest.data_source.decoded       # the first batch's 8
    rest.restore(path)
    assert rest.data_source.decoded == decoded == 8
    rest.solve()
    assert rest.data_source.decoded == 8 + 3 * 8
    want, got = _params_np(whole.net.params), _params_np(rest.net.params)
    for name in want:
        for blob in want[name]:
            np.testing.assert_array_equal(got[name][blob], want[name][blob])


def test_jax_snapshot_restored_by_net_solver_restarts_like_jax(tmp_path):
    """A JAX NetSolver snapshot (no stream entries) restored through
    ``NetSolver.restore``: the port restarts the MemoryData stream as
    JAX's NetSolver does, and both continue to within rtol 1e-5."""
    jfirst, _ = _net_solver(tmp_path, 3, snapshot=3, prefix="jsnap",
                            jax=True, dropout=False)
    jfirst.solve()
    path = str(tmp_path / "jsnap_iter_3.npz")
    jrest, _ = _net_solver(tmp_path, 6, jax=True, dropout=False)
    jrest.solver.restore(path)
    jrest.solve()
    trest, _ = _net_solver(tmp_path, 6, dropout=False)
    trest.restore(path)
    assert trest.solver.iter == 3
    trest.solve()
    want = trest._from_jax(jax.tree_util.tree_map(np.asarray,
                                                  jrest.solver.params))
    got = _params_np(trest.net.params)
    for name in want:
        for blob in want[name]:
            np.testing.assert_allclose(got[name][blob], want[name][blob],
                                       rtol=1e-5, atol=1e-6)
