"""Step timing, device traces and the program's own spans (port of the
TPU package's utils/profiling.py).

- `StepTimer`: wall time per step with a p50/p95/mean summary. Each step
  ends in a device synchronize, so a timer is only passed when profiling
  (`Config.profile_dir`): otherwise steps queue back to back;
- `trace(log_dir)`: `torch.profiler` over the block (host and CUDA
  activity), written as a Chrome trace into `log_dir`; no-op without one;
- `annotate(name)`: a labelled host span. While a `torch.profiler`
  session records, it is a `record_function` on the profiler's own
  timeline (the clock of the CUDA activity, nested under the caller's
  span), and its host-clock duration and a count of one are added to the
  process's totals under `name`; `count(name, n)` adds `n` to a counter
  under the same gate. Without a profiler recording, a span costs one flag
  test and records nothing. `totals()` returns a copy of what was recorded
  since the process started or the last `reset()`.

A span around an asynchronous launch times its enqueue on the host, not
the device's work; a span around a fetch to the host times the wait for
the device. The totals live in the module because what reads them (a
benchmark's per-layer reader) is handed nothing but the trace.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


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


# name -> [count, seconds] of the recorded spans, name -> value of the
# counters; the lock guards them against callers on several threads
_spans: dict[str, list] = {}
_counters: dict[str, int] = {}
_lock = threading.Lock()
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def _span(name: str):
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        yield
        seconds = time.perf_counter() - t0
    with _lock:
        total = _spans.setdefault(name, [0, 0.0])
        total[0] += 1
        total[1] += seconds


def annotate(name: str):
    """Context manager that labels the block `name` in a `torch.profiler`
    trace (the TPU package's profiler trace annotation) and adds its
    host-clock seconds to the totals; a no-op unless a profiler records."""
    # torch.autograd.profiler's module flag, which a torch.profiler (or
    # autograd profiler) session sets while it records: a Python attribute
    # read, where torch._C._autograd._profiler_enabled() is a call into C++
    return _span(name) if _autograd_profiler._is_profiler_enabled else _OFF


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def totals() -> dict:
    """{"spans": {name: (count, seconds)}, "counters": {name: value}}, a
    copy of what was recorded since the process started or `reset()`."""
    with _lock:
        return {"spans": {k: (c, s) for k, (c, s) in _spans.items()},
                "counters": dict(_counters)}


def reset() -> None:
    """Clear the recorded spans and counters."""
    with _lock:
        _spans.clear()
        _counters.clear()
