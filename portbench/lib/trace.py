"""Reduction of a torch.profiler trace, held in memory, to what the
per-layer readers take: device time by kernel name, the union of the
device's busy intervals, and the breakdown (the device operations that took
most time, the idle gaps by what the host was doing). Nothing is written to
disk."""

from __future__ import annotations

import bisect
from collections import defaultdict

SPAN_PREFIX = "portbench."  # the harness's own host spans (record_function)
REQUEST_SPAN = "portbench.request"  # one served request, from its call to its answer
GAPS_LABELLED = 400  # longest idle gaps whose host activity is looked up
NAME_CHARS = 160


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def reduce(prof, window_s: float) -> dict:
    """{'kernel_s': {name: seconds}, 'kernel_n': {name: launches}, 'busy_s',
    'window_s', 'request_s' (the served requests' time from call to
    answer), 'request_busy_s' (the device's busy time inside it),
    'breakdown'} of a finished `torch.profiler.profile`."""
    dev, host, spans = [], [], []
    for e in prof.events():
        tr = e.time_range
        if _is_device(e):
            # a host span's device-side mirror (record_function) is no operation
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)):
                dev.append((tr.start, tr.end, e.name))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((tr.start, tr.end, e.name))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    kernel_s, kernel_n = defaultdict(float), defaultdict(int)
    for s, t, name in dev:
        kernel_s[name] += (t - s) * 1e-6
        kernel_n[name] += 1
    dev.sort()
    merged, gaps = [], []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            if merged:
                gaps.append((s - merged[-1][1], merged[-1][1], s))
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    requests = sorted((s, t) for s, t, name in spans if name == REQUEST_SPAN)
    gaps.sort(reverse=True)
    idle = defaultdict(float)
    host.sort()
    starts = [h[0] for h in host]
    for dur, a, b in gaps[:GAPS_LABELLED]:
        idle[_host_label(spans, host, starts, (a + b) / 2)] += dur * 1e-6
    top_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {
        "kernel_s": dict(kernel_s), "kernel_n": dict(kernel_n),
        "busy_s": busy * 1e-6, "window_s": window_s,
        "request_s": sum(t - s for s, t in requests) * 1e-6,
        "request_busy_s": _overlap(merged, requests) * 1e-6,
        "breakdown": {
            "device_ops": [[n[:NAME_CHARS], s] for n, s in top_ops],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


def _overlap(merged, spans) -> float:
    """Length of the busy intervals `merged` (sorted, disjoint) inside the
    sorted, disjoint `spans`."""
    total, i = 0.0, 0
    for s, t in spans:
        while i < len(merged) and merged[i][1] <= s:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < t:
            total += min(t, merged[j][1]) - max(s, merged[j][0])
            j += 1
    return total


def _host_label(spans, host, starts, t) -> str:
    """The harness's span open at time `t` and the innermost host event of
    the program open then."""
    span = next((s[2] for s in spans if s[0] <= t <= s[1]), "outside the harness's spans")
    i = bisect.bisect_right(starts, t)
    open_ = [h for h in host[max(0, i - 2000):i] if h[1] >= t]
    if not open_:
        return span
    return f"{span} > {max(open_, key=lambda h: h[0])[2]}"


def kernel_time(summary: dict, needle: str) -> tuple[float, int]:
    """(seconds, launches) of the device kernels whose name holds `needle`."""
    s = sum(v for k, v in summary["kernel_s"].items() if needle in k)
    n = sum(v for k, v in summary["kernel_n"].items() if needle in k)
    return s, n
