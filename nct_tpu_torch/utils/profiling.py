"""Per-stage timing and profiler hooks (port of ``nct_tpu/utils/profiling.py``).

The card runs asynchronously, so a host-clock span first waits for the
device (``device_sync``); ``time_call`` times a stage on the card with CUDA
events instead, which measure device time without the host in the way.
Deeper traces use ``torch.profiler`` (``device_trace``).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


def _tensors(x):
    """The tensors in a (nested) tuple, list or dict."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def device_sync(x) -> None:
    """Completion barrier: ``torch.cuda.synchronize`` on the device of every
    CUDA tensor in ``x``; nothing to wait for on the CPU."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def time_call(fn, reps: int, device: torch.device | str):
    """Run ``fn()`` once to warm up, then time ``reps`` more calls: CUDA
    events on a CUDA device, the host clock on the CPU.  Returns (the
    warm-up call's output, mean milliseconds per call)."""
    device = torch.device(device)
    out = fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return out, (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end) / reps


@dataclass
class StageTimer:
    """Accumulates named stage timings (host clock, device-synchronised);
    prints in the reference's ``<name> Time:`` format."""

    spans: dict[str, float] = field(default_factory=dict)
    verbose: bool = False

    def _record(self, name: str, dt: float) -> None:
        self.spans[name] = self.spans.get(name, 0.0) + dt
        if self.verbose:
            print(f"{name} Time: {dt:.6f}")

    @contextlib.contextmanager
    def stage(self, name: str, *sync_results):
        start = time.perf_counter()
        try:
            yield
        finally:
            device_sync(sync_results)
            self._record(name, time.perf_counter() - start)

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for its output, and record the span."""
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        device_sync(out)
        self._record(name, time.perf_counter() - start)
        return out

    def report(self) -> str:
        lines = [f"{k} Time: {v:.6f}" for k, v in self.spans.items()]
        total = sum(self.spans.values())
        lines.append(f"**Finished Time: {total:.6f} sec.")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the block (CPU, and CUDA when a card is
    present), written to ``<log_dir>/trace.json`` (chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
