"""The port's profiling helpers and per-stage profiler.

``nct_tpu_torch.tools.profile_stages`` is driven at its small shapes on the
CPU: it must time every stage of the JAX tool that has a counterpart and
end in one JSON line.  Its times on the card come from chip_smoke.py.
"""

import json

import pytest
import torch

from nct_tpu_torch.utils import profiling

torch.set_num_threads(1)

STAGES = [
    "vgg_5taps",
    "exact_nn_L2", "nn_directed_L2", "nn_bidir_L2", "bds_vote_L2",
    "knn_graph_L2", "nonlocal_mg10_tol0.0001_L2",
    "exact_nn_L3", "nn_directed_L3", "nn_bidir_L3", "window_refine_L3",
    "bds_vote_L3", "knn_graph_L3", "nonlocal_mg10_tol0.0001_L3",
    "window_refine_L4", "patchmatch4_ab_L4", "bds_vote_L4", "knn_graph_L4",
    "nonlocal_mg6_tol0.0001_L4",
    "wls_cg200_fullres",
]


def test_profile_stages_cpu_small(capsys):
    """The tool's main in this process, on the file's one thread (a new
    process would take every core while the other test workers run)."""
    from nct_tpu_torch.tools import profile_stages

    assert profile_stages.main(["--device", "cpu", "--small", "--reps",
                                "1"]) == 0
    out = capsys.readouterr().out
    result = json.loads(out.strip().splitlines()[-1])
    assert result["device"] == "cpu" and result["shapes"] == "small"
    assert list(result["stages_ms"]) == STAGES
    for name in STAGES:
        assert f"{name}: " in out
        assert result["stages_ms"][name] > 0.0


def test_profile_stages_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from nct_tpu_torch.tools import profile_stages

    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_stages.main(["--small"])


def test_stage_timer_report_format(capsys):
    timer = profiling.StageTimer(verbose=True)
    x = torch.ones(3)
    with timer.stage("Patch Match", x):
        x = x * 2
    out = timer.timed("WLS Solve", lambda t: (t + 1, {"k": [t]}), x)
    with timer.stage("Patch Match"):
        pass
    assert float(out[0].sum()) == 9.0
    assert list(timer.spans) == ["Patch Match", "WLS Solve"]
    printed = capsys.readouterr().out.splitlines()
    assert [p.split(" Time:")[0] for p in printed] == \
        ["Patch Match", "WLS Solve", "Patch Match"]
    report = timer.report().splitlines()
    assert report[0].startswith("Patch Match Time: ")
    assert report[1].startswith("WLS Solve Time: ")
    assert report[2].startswith("**Finished Time: ")
    assert report[2].endswith(" sec.")


def test_time_call_cpu():
    calls = []
    out, ms = profiling.time_call(lambda: calls.append(1) or len(calls), 3,
                                  "cpu")
    assert out == 1 and len(calls) == 4 and ms >= 0.0
    profiling.device_sync({"a": [torch.zeros(2)], "b": (torch.ones(1),)})


def test_device_trace_writes_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
