"""Step timing and device traces (port of the TPU package's
utils/profiling.py).

- `StepTimer`: wall time per step with a p50/p95/mean summary. Each step
  ends in a device synchronize, so a timer is only passed when profiling
  (`Config.profile_dir`): otherwise steps queue back to back;
- `trace(log_dir)`: `torch.profiler` over the block (host and CUDA
  activity), written as a Chrome trace into `log_dir`; no-op without one;
- `annotate(name)`: a labelled host span in such a trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


class StepTimer:
    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    @staticmethod
    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> dict:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "total_s": float(t.sum()),
        }


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace of the block into `log_dir` (trace.json);
    no-op when `log_dir` is empty."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Context manager that labels the block `name` in a `torch.profiler`
    trace (the TPU package's profiler trace annotation)."""
    return torch.profiler.record_function(name)
