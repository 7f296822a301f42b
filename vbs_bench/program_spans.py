"""The program's own spans in a traced run: ``record_function`` spans that
``vision_basedsensor_tpu_torch`` opens at its layer boundaries
(``utils/profiling.py:SPANS``), read on the main thread (the thread of the
``vbs.window`` span). A span's device time and launches follow the launch
calls' correlation, as ``Trace.device_s_inside`` does for the benchmark's
wrappers. Each function returns None where the trace has no such span (a
program that does not open it)."""
from __future__ import annotations

import bisect

from vbs_bench.trace import _union


def intervals(trace, name: str) -> list:
    """The merged ``[start, end]`` (microseconds) of the main thread's
    ``name`` spans."""
    return _union((a, b) for a, b, n, tid in trace.annotations
                  if n == name and tid == trace.main_tid)


def _launched(trace, spans):
    """The device activities whose launch call lies inside ``spans``."""
    starts = [a for a, _ in spans]
    for act in trace.device:
        ts = trace.launch_ts.get(act[3])
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= spans[i][1]:
            yield act


def host_s(trace, name: str) -> float | None:
    """Seconds the main thread spent inside ``name``."""
    spans = intervals(trace, name)
    return sum(b - a for a, b in spans) * 1e-6 if spans else None


def device_s(trace, name: str) -> float | None:
    """Seconds of the device activities launched inside ``name``."""
    spans = intervals(trace, name)
    if not spans:
        return None
    return sum(b - a for a, b, _, _ in _launched(trace, spans)) * 1e-6


def launches(trace, name: str) -> int | None:
    """The number of device activities (kernels, copies, fills) launched
    inside ``name``."""
    spans = intervals(trace, name)
    return sum(1 for _ in _launched(trace, spans)) if spans else None


def idle_s(trace, name: str) -> float | None:
    """Seconds in which the device was idle (``Trace.gaps``) while the main
    thread was inside ``name``."""
    spans = intervals(trace, name)
    if not spans:
        return None
    total, j = 0.0, 0
    for a, b in trace.gaps():                 # sorted, disjoint
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            total += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return total * 1e-6
