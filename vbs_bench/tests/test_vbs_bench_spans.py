"""The readers of the program's own spans on a hand-built trace: device time
and launches inside a span, device idle time inside a span, a span's share
of the window, and nothing to read where the program opens no such span."""
from types import SimpleNamespace

import pytest

from vbs_bench import manifest, program_spans
from vbs_bench.trace import Trace

SIX = ("filters_device_ms.batch", "moments_device_ms.batch",
       "contact_idle_ms.batch", "launches.batch", "feed_wait_pct.replay",
       "readback_pct.replay")


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 2, corr=corr)


def kernel(name, ts, dur, corr):
    return ev("kernel", name, ts, dur, tid=7, corr=corr)


def synthetic():
    """A 1,000 us window on the main thread (tid 1). process_frames 0-900
    holds detect 0-500 (filters 10-200 launching a GEMM 50-250 and an add
    250-270; moments 300-400 launching a kernel 420-450) and contact
    600-800, whose layout copy waits 600-700 while the device is idle, then
    launches a fit kernel 760-780. The replay spans: a feed wait 850-900
    and a readback 900-980. Another thread's filters span launches a kernel
    that must not count, and so does the prefetch thread's wait."""
    return [
        ev("user_annotation", "vbs.window", 0, 1000),
        ev("user_annotation", "vbs.pipeline.process_frames", 0, 900),
        ev("user_annotation", "vbs.detect", 0, 500),
        ev("user_annotation", "vbs.detect.filters", 10, 190),
        launch(20, 1), kernel("sm90_xmma_gemm", 50, 200, 1),
        launch(30, 2), kernel("vectorized_elementwise_kernel", 250, 20, 2),
        ev("user_annotation", "vbs.detect.moments", 300, 100),
        launch(310, 3), kernel("elementwise_kernel", 420, 30, 3),
        ev("user_annotation", "vbs.contact", 600, 200),
        ev("user_annotation", "vbs.contact.layout", 600, 100),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 690, 5,
           tid=7, corr=4),
        launch(600, 4),
        ev("user_annotation", "vbs.contact.fit", 700, 100),
        launch(750, 5), kernel("fit_kernel", 760, 20, 5),
        ev("user_annotation", "vbs.feed.wait", 850, 50),
        ev("user_annotation", "vbs.stream.readback", 900, 80),
        ev("user_annotation", "vbs.detect.filters", 910, 20, tid=2),
        launch(915, 6), kernel("other_thread_kernel", 940, 10, 6),
        ev("user_annotation", "vbs.feed.wait", 100, 600, tid=3),
    ]


def ctx(events, units=2):
    return SimpleNamespace(trace=Trace(events), units=units)


def test_device_time_and_launches_inside_a_main_thread_span():
    t = Trace(synthetic())
    assert program_spans.device_s(t, "vbs.detect.filters") == pytest.approx(
        220e-6)
    assert program_spans.device_s(t, "vbs.detect.moments") == pytest.approx(
        30e-6)
    # The GEMM, the add, the moments kernel, the layout copy, the fit.
    assert program_spans.launches(t, "vbs.pipeline.process_frames") == 5


def test_idle_time_inside_a_span():
    t = Trace(synthetic())
    # Device busy 50-270, 420-450, 690-695, 760-780, 940-950: inside contact
    # (600-800) idle 600-690, 695-760 and 780-800.
    assert program_spans.idle_s(t, "vbs.contact") == pytest.approx(175e-6)
    assert program_spans.idle_s(t, "vbs.contact.layout") == pytest.approx(
        95e-6)
    assert program_spans.host_s(t, "vbs.feed.wait") == pytest.approx(50e-6)


def test_the_six_readers():
    c = ctx(synthetic())
    read = {name: manifest.reader(name)(c) for name in SIX}
    assert read == pytest.approx({
        "filters_device_ms.batch": 0.110, "moments_device_ms.batch": 0.015,
        "contact_idle_ms.batch": 0.0875, "launches.batch": 2.5,
        "feed_wait_pct.replay": 5.0, "readback_pct.replay": 8.0})


def test_no_span_reads_nothing():
    """A program without the spans (the benchmark's wrappers only): every
    reader returns None and none raises."""
    events = [e for e in synthetic()
              if not (e["cat"] == "user_annotation"
                      and e["name"] != "vbs.window")]
    events.append(ev("user_annotation", "vbs.detect_markers", 0, 500))
    c = ctx(events)
    assert {name: manifest.reader(name)(c) for name in SIX} == dict.fromkeys(
        SIX)
    assert program_spans.intervals(c.trace, "vbs.contact") == []


def test_a_span_with_no_idle_reads_zero():
    events = [ev("user_annotation", "vbs.window", 0, 100),
              ev("user_annotation", "vbs.contact", 10, 20),
              launch(10, 1), kernel("k", 0, 100, 1)]
    assert manifest.reader("contact_idle_ms.batch")(ctx(events, 1)) == 0.0
