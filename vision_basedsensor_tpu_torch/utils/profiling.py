"""Program spans and the profiler hook.

Port of ``vision_basedsensor_tpu/utils/profiling.py``: ``trace_annotation``
(a named span in a ``torch.profiler`` trace, the counterpart of
``jax.profiler.TraceAnnotation``) and ``profile_to``, which writes a Chrome
trace of the block it wraps (the counterpart of an XProf capture).

A span's start and end are the profiler's own, on the clock of the device
activities it records, so a trace puts each idle stretch of the card down
to the innermost span the host was in. A span never touches a tensor and
never waits for the device. With no profiler running it is one shared null
context. Every span name is in ``SPANS``; the layer each belongs to is in
``PERF.md`` §3.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.autograd.profiler as _autograd_profiler

from vision_basedsensor_tpu_torch.core.device import CUDA, resolve

SPANS = (
    # pipeline
    "vbs.pipeline.process_frames",      # pipeline.py:process_frames
    "vbs.pipeline.chunk",               # StreamingPipeline.process
    "vbs.pipeline.preprocess",          # pipeline.py:_preprocess
    "vbs.pipeline.initialize",          # pipeline.py:initialize
    # undistortion (pipeline.py)
    "vbs.undistort.prepare",            # prepare_undistortion
    "vbs.undistort.remap",              # _preprocess: grayscale and remap
    # detect (detect/detector.py:detect_markers_and_scale)
    "vbs.detect",
    "vbs.detect.filters",               # grayscale, DoG area mask, NCC
    "vbs.detect.fields",                # fused fields kernel (K1/K2)
    "vbs.detect.band_opening",          # unfused branch: band and opening
    "vbs.detect.peaks",                 # peak selection and cut geometry
    "vbs.detect.peak_field",            # unfused branch: windowed max field
    "vbs.detect.gather",                # window gather kernel (K3/K4)
    "vbs.detect.moments",               # moment sums of the gathered windows
    "vbs.detect.window_sums",           # unfused branch: window sums (K5)
    "vbs.detect.finalize",              # candidate geometry and gates
    # track, reconstruct, contact state
    "vbs.track.associate",              # pipeline.py:_associate
    "vbs.reconstruct.positions",        # reconstruct/depth.py
    "vbs.reconstruct.scan",             # reconstruct/displacement.py
    "vbs.contact",                      # analysis/force.py
    "vbs.contact.layout",               # the dome layout's start points
    "vbs.contact.fit",                  # plane fit and means
    # ingest (io/video.py) and the replay command (cli/main.py)
    "vbs.feed.open",                    # MjpegAviCudaSource set-up
    "vbs.feed.wait",                    # device_feed waits for the prefetch
    "vbs.feed.device_decode",           # device_feed's copy and device decode
    "vbs.stream.readback",              # a chunk's outputs to the host
    "vbs.io.table",                     # io/table.py:write_tracking_csv
)

_OFF = contextlib.nullcontext()


def trace_annotation(name: str):
    """A named span (one of ``SPANS``) in the running ``torch.profiler``
    trace; with no profiler running, a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


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
