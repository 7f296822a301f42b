"""Reading a profiler trace: the idle share, the idle gaps by what the host
was doing, device time inside a layer span, the layer spans."""
import contextlib
from types import SimpleNamespace

import pytest

from vbs_bench import manifest
from vbs_bench.trace import Spans, Trace, instrument


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """A 1,000 us window: kernels busy 100-300 and 250-400 (overlapping)
    and 700-800; a copy 900-950; before the window a kernel that must not
    count. The host runs a detect span 50-450 that launches the first two,
    and a writer span 500-880 with a synchronise inside."""
    return [
        ev("user_annotation", "vbs.window", 0, 1000),
        ev("kernel", "early", -500, 100, tid=7, corr=1),
        ev("user_annotation", "vbs.detect_markers", 50, 400),
        ev("cpu_op", "aten::mm", 60, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 70, 5, corr=2),
        ev("cpu_op", "aten::add", 200, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 205, 3, corr=3),
        ev("kernel", "void gemm_kernel<float>", 100, 200, tid=7, corr=2),
        ev("kernel", "fused_fields_kernel", 250, 150, tid=7, corr=3),
        ev("user_annotation", "vbs.write_tracking_csv", 500, 380),
        ev("cpu_op", "aten::copy_", 510, 100),
        ev("cuda_runtime", "cudaStreamSynchronize", 520, 80),
        ev("cuda_runtime", "cudaLaunchKernel", 690, 4, corr=4),
        ev("kernel", "other_kernel", 700, 100, tid=7, corr=4),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 900, 50,
           tid=7, corr=5),
        ev("cuda_runtime", "cudaMemcpyAsync", 890, 5, corr=5),
    ]


def test_idle_share_is_the_union_of_device_spans():
    t = Trace(synthetic())
    assert t.window_s == pytest.approx(1e-3)
    # busy 100-400 (union), 700-800, 900-950: 450 us of 1,000.
    assert t.busy_s() == pytest.approx(450e-6)
    assert t.idle_pct() == pytest.approx(55.0)
    assert t.gaps() == [(0.0, 100.0), (400.0, 700.0), (800.0, 900.0),
                        (950.0, 1000.0)]


def test_device_time_inside_a_span_follows_the_launch():
    t = Trace(synthetic())
    assert t.device_s_inside("detect_markers") == pytest.approx(350e-6)
    assert t.device_s_inside("write_tracking_csv") == pytest.approx(100e-6)
    assert t.device_s(lambda n: "gemm" in n) == pytest.approx(200e-6)
    assert t.durations_s(lambda n: "fused_fields" in n) == pytest.approx(
        [150e-6])


def test_a_layer_reader_reads_device_time_a_unit():
    ctx = SimpleNamespace(trace=Trace(synthetic()), units=2)
    assert manifest.reader("detect_device_ms.batch")(ctx) == pytest.approx(
        0.175)
    # No activity launched inside the span: nothing to read.
    assert manifest.reader("contact_state_ms.batch")(ctx) is None


def test_instrument_spans_a_layer_without_waiting_and_restores_it():
    calls, mod = [], SimpleNamespace(layer=lambda x: x + 1)
    original = mod.layer

    @contextlib.contextmanager
    def record(name):
        calls.append(name)
        yield

    spans = Spans()
    with instrument([(mod, "layer", "detect_markers")], spans, record):
        assert mod.layer(1) == 2
        assert mod.layer(2) == 3
    assert mod.layer is original
    assert calls == ["vbs.detect_markers"] * 2
    assert spans.count("detect_markers") == 2
    assert spans.total("detect_markers") >= 0.0


def test_breakdown_names_the_gaps_by_host_activity():
    b = Trace(synthetic()).breakdown()
    ops = dict(b["device_ops"])
    assert ops["void gemm_kernel<float>"] == pytest.approx(200e-6)
    gaps = dict(b["idle_gaps"])
    # 400-700 has its middle (550) in the writer's aten::copy_.
    assert gaps["vbs.write_tracking_csv / aten::copy_"] == pytest.approx(
        300e-6)
    # 0-100 (middle 50) in the detect span, between its operators.
    assert gaps["vbs.detect_markers"] == pytest.approx(100e-6)
    assert gaps["vbs.write_tracking_csv"] == pytest.approx(100e-6)
    assert gaps["outside layer spans"] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx(550e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_a_trace_needs_one_window():
    with pytest.raises(ValueError):
        Trace([ev("kernel", "k", 0, 1)])
