"""Per-stage timing and profiler hooks.

Port of ``vision_basedsensor_tpu/utils/profiling.py``: a ``StageTimer`` that
accounts wall time per stage (waiting for the stage's device results so the
numbers mean something), ``trace_annotation`` (a named span in a
``torch.profiler`` trace, the counterpart of
``jax.profiler.TraceAnnotation``) and ``profile_to``, which writes a Chrome
trace of the block it wraps (the counterpart of an XProf capture).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

from vision_basedsensor_tpu_torch.core.device import CUDA, resolve


def _cuda_devices(x, found: set) -> set:
    """The CUDA devices of every tensor in ``x`` (tensors, tuples, lists,
    dicts, nested)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, found)
    return found


class StageTimer:
    """Accumulates wall time per named stage; waits for CUDA outputs."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time the block; with ``block_on`` (tensors, possibly nested in
        tuples, lists or dicts) synchronize each distinct CUDA device they
        live on before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                for dev in _cuda_devices(block_on, set()):
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:28s} {total * 1e3:9.1f} ms total"
                         f"  ({n}x, {total / n * 1e3:8.2f} ms avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named span in an active ``torch.profiler`` trace (free when none
    is recording)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_to(logdir: str, device=CUDA):
    """Profile the block with ``torch.profiler`` (CPU activity, plus CUDA
    activity when ``device`` is a card) and write its Chrome trace to
    ``logdir/trace.json``. Yields the profiler."""
    dev = resolve(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
