"""The traced run: layer spans from the benchmark's own wrappers, and the
profiler's trace read into device busy time, idle gaps, kernels by name or
by the span that launched them, and host operators.

A span is a ``torch.profiler.record_function`` named ``vbs.<layer>`` around
a call into a layer, and that call's host-clock seconds. The trace is the
profiler's Chrome trace (``export_chrome_trace``): device activities
(``kernel``, ``gpu_memcpy``, ``gpu_memset``), host operators (``cpu_op``),
CUDA runtime calls (``cuda_runtime``) and the spans (``user_annotation``),
all in microseconds on one clock. Everything is read inside the window,
the span ``vbs.window``.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
WINDOW = "vbs.window"
TOP = 10


class Spans:
    """Host-clock seconds of each call of each wrapped layer."""

    def __init__(self):
        self.seconds = defaultdict(list)

    def total(self, name: str) -> float:
        return sum(self.seconds.get(name, ()))

    def count(self, name: str) -> int:
        return len(self.seconds.get(name, ()))


@contextlib.contextmanager
def instrument(targets, spans: Spans, record_function):
    """Wrap each ``(module, attribute, layer)`` of ``targets`` in a span
    named ``vbs.<layer>`` with its host-clock seconds. A span never waits
    for the device, so the traced run queues work as the timed run does.
    The originals are put back on exit."""
    saved = []

    def wrap(fn, layer):
        def wrapped(*args, **kwargs):
            with record_function(f"vbs.{layer}"):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                spans.seconds[layer].append(time.perf_counter() - t0)
            return out
        return wrapped

    try:
        for module, attr, layer in targets:
            fn = getattr(module, attr)
            saved.append((module, attr, fn))
            setattr(module, attr, wrap(fn, layer))
        yield spans
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


def export_events(prof) -> list[dict]:
    """The profiler's Chrome trace events, read back from a file under
    ``$TMPDIR`` that is removed at once."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals):
    """Sorted, merged ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _innermost(intervals, points):
    """For each of ``points`` (sorted), the innermost of the properly nested
    ``(start, end, name)`` ``intervals`` that holds it, or None."""
    ev = sorted(intervals, key=lambda e: (e[0], -e[1]))
    stack, j, out = [], 0, []
    for p in points:
        while j < len(ev) and ev[j][0] <= p:
            while stack and stack[-1][1] < ev[j][0]:
                stack.pop()
            stack.append(ev[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


class Trace:
    """The traced window's events (microseconds)."""

    def __init__(self, events: list[dict]):
        wins = [e for e in events if e.get("name") == WINDOW
                and e.get("cat") == "user_annotation"]
        if len(wins) != 1:
            raise ValueError(f"expected one {WINDOW} span, found {len(wins)}")
        w = wins[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main_tid = w.get("tid")
        self.device, self.cpu_ops, self.annotations = [], [], []
        self.launch_ts = {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, ts = e.get("cat"), float(e["ts"])
            end = ts + float(e["dur"])
            if cat in DEVICE_CATS:
                a, b = max(ts, self.t0), min(end, self.t1)
                if b > a:
                    corr = (e.get("args") or {}).get("correlation")
                    self.device.append((a, b, e.get("name", ""), corr))
            elif self.t0 <= ts <= self.t1:
                if cat == "cpu_op":
                    self.cpu_ops.append((ts, end, e.get("name", ""),
                                         e.get("tid")))
                elif cat == "user_annotation" and e["name"] != WINDOW:
                    self.annotations.append((ts, end, e["name"],
                                             e.get("tid")))
                elif cat.startswith("cuda_"):        # CUDA API calls
                    corr = (e.get("args") or {}).get("correlation")
                    if corr is not None:
                        self.launch_ts[corr] = ts

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in _union((a, b) for a, b, _, _
                                            in self.device)) * 1e-6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def gaps(self) -> list[tuple[float, float]]:
        """The device's idle intervals inside the window."""
        out, t = [], self.t0
        for a, b in _union((a, b) for a, b, _, _ in self.device):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def device_s(self, pred=lambda name: True) -> float:
        """Summed seconds of the device activities whose name passes
        ``pred``."""
        return sum(b - a for a, b, n, _ in self.device if pred(n)) * 1e-6

    def durations_s(self, pred) -> list[float]:
        return [(b - a) * 1e-6 for a, b, n, _ in self.device if pred(n)]

    def device_s_inside(self, layer: str) -> float:
        """Seconds of the device activities launched from inside a
        ``vbs.<layer>`` span (by the launch call's correlation)."""
        spans = _union((a, b) for a, b, n, _ in self.annotations
                       if n == f"vbs.{layer}")
        starts = [a for a, _ in spans]
        total = 0.0
        for a, b, _, corr in self.device:
            ts = self.launch_ts.get(corr)
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                total += b - a
        return total * 1e-6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps'
        seconds by what the main thread was doing at their middle: the
        innermost layer span and host operator, top ``TOP`` of each."""
        ops = defaultdict(float)
        for a, b, n, _ in self.device:
            ops[n[:120]] += (b - a) * 1e-6
        gaps = self.gaps()
        mids = [(a + b) / 2 for a, b in gaps]
        order = sorted(range(len(gaps)), key=lambda i: mids[i])
        pts = [mids[i] for i in order]
        main = lambda evs: [(a, b, n) for a, b, n, t in evs
                            if t == self.main_tid]
        layer = _innermost(main(self.annotations), pts)
        op = _innermost(main(self.cpu_ops), pts)
        idle = defaultdict(float)
        for k, i in enumerate(order):
            a, b = gaps[i]
            name = layer[k] or "outside layer spans"
            if op[k]:
                name = f"{name} / {op[k][:80]}"
            idle[name] += (b - a) * 1e-6
        top = lambda d: [[n, s] for n, s in sorted(d.items(),
                                                  key=lambda x: -x[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}
