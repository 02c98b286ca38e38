"""Port parity on the CPU: utils/profiling.py against the JAX package's
(`StepTimer`'s summary, `trace`, `annotate`). `annotate` labels a span
of a `torch.profiler` trace, as the JAX package's labels one of
`jax.profiler`'s."""

import json
import os

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_ad_tpu.utils import profiling as jprof
from multimodal_ad_tpu_torch.utils import profiling as tprof
from test_torch_port_support import cap_torch_threads

cap_torch_threads()


def test_step_timer_summary_matches_jax():
    times = [0.25, 0.5, 0.125, 1.0]
    jt, tt = jprof.StepTimer(), tprof.StepTimer()
    jt.times, tt.times = list(times), list(times)
    assert tt.summary() == jt.summary()
    assert tprof.StepTimer().summary() == jprof.StepTimer().summary() == {}
    with tt:
        pass
    assert len(tt.times) == 5 and tt.times[-1] >= 0


def test_annotate_labels_a_profiler_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tprof.annotate("mad_annotated_span"):
            torch.ones(8).sum()
    assert "mad_annotated_span" in {e.key for e in prof.key_averages()}


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with tprof.trace(None) as prof:
        assert prof is None
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("mad_traced_span"):
            torch.from_numpy(np.arange(6.0)).sum()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "mad_traced_span" in names
