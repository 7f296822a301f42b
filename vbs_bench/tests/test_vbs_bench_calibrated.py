"""The calibrated cell ``vga_calibrated_indent_chunk256`` on the CPU, at a
size the CPU holds (9 frames in chunks of 3, sunk 1.2 mm a frame so that
the outer ring passes the 20 px gate by the third chunk): sound, it is
correct; with the remap skipped, frame-0 association in place of the
sequential one, the association carry dropped at every chunk, or the lens
left out of the recording or of the check, it is not; the reference in the
program's place reads 0; the new readers read a hand-built trace and
nothing where the program opens no such span."""
from types import SimpleNamespace

import pytest
import torch

import vision_basedsensor_tpu_torch.pipeline as pipeline
from test_vbs_bench_spans import ev, kernel, launch
from vbs_bench import calibrated_bound, manifest, roofline
from vbs_bench.control_calibrated import readings
from vbs_bench.gen.scene import render_uint8
from vbs_bench.loads import stream_calibrated
from vbs_bench.program import Program
from vbs_bench.run import run_cell
from vbs_bench.trace import Trace

CPU = torch.device("cpu")
CELL = "vga_calibrated_indent_chunk256"
SEED = 2**31 + 99
SMALL = {"frames": 9, "chunk": 3,
         "motion": {"drift_z_mm_per_frame": 1.2, "tilt_deg": [0.5, 3.0]}}
M = manifest.load()


def run(program=None):
    """A traced run: ``trace_units`` whole sessions, so every chunk
    boundary lies inside what is checked."""
    return run_cell(CELL, SEED, 0.3, True, CPU, program=program,
                    traffic_overrides=SMALL)


class _BrokenSession:
    """A session of the port with one fault planted."""

    def __init__(self, sp, fault):
        self.sp, self.fault = sp, fault

    def process(self, frames):
        if self.fault == "carry_dropped":
            # Each chunk associates against the frame-0 table again.
            self.sp.assoc_xy = None
        return self.sp.process(frames)


class Broken(Program):
    def __init__(self, fault):
        super().__init__(CPU)
        self.fault = fault

    def config(self, overrides):
        if self.fault == "frame0":
            overrides = {**overrides, "track": {"association_mode": "frame0"}}
        return super().config(overrides)

    def stream(self, cam, cfg, ref):
        return _BrokenSession(super().stream(cam, cfg, ref), self.fault)


def test_the_cell_is_in_the_manifest_on_the_calibrated_sensor():
    cell = manifest.cell(M, CELL)
    assert cell["chips"] == 1 and cell["config"] == "vga640x480_calibrated"
    conf = manifest.config(M, cell)
    assert conf["pipeline"]["undistort_frames"] is True
    assert conf["pipeline"]["track"]["association_mode"] == "sequential"
    assert len(conf["dist"]) == 5 and any(conf["dist"])
    traffic = manifest.traffic(cell)
    assert traffic["kind"] == "stream_calibrated"
    assert traffic["frames"] % traffic["chunk"] == 0
    assert "scene_px" in traffic["limits"]


def test_a_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] == 2 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    numbers = {k: t["value"] for k, t in r["checks"].items()}
    assert numbers.pop("scene_px") < 0.5
    assert numbers == dict.fromkeys(numbers, 0.0)


@pytest.mark.parametrize("fault", ["frame0", "carry_dropped"])
def test_an_association_fault_is_not_correct(fault):
    r = run(Broken(fault))
    assert not r["correct"], r["checks"]
    assert r["checks"]["tracked_px"]["value"] > 1.0


def test_a_skipped_remap_is_not_correct(monkeypatch):
    monkeypatch.setattr(pipeline, "remap_bilinear", lambda frames, m: frames)
    r = run()
    assert not r["correct"], r["checks"]


def test_a_recording_filmed_without_the_lens_is_not_correct(monkeypatch):
    def lens_free(conf, frames, seed, params, device):
        return render_uint8(conf["height"], conf["width"], frames, seed,
                            params, device)
    monkeypatch.setattr(stream_calibrated, "render_through_lens", lens_free)
    r = run()
    assert not r["correct"], r["checks"]
    assert r["checks"]["scene_px"]["value"] > r["checks"]["scene_px"]["limit"]


def test_a_check_without_the_lens_is_not_correct(monkeypatch):
    check = stream_calibrated.Load.check

    def lens_free(self):
        self.conf = {**self.conf, "dist": [0.0] * 5}
        return check(self)
    monkeypatch.setattr(stream_calibrated.Load, "check", lens_free)
    r = run()
    assert not r["correct"], r["checks"]


def test_the_reference_in_the_programs_place_reads_zero():
    for _, r in readings(CELL, [SEED], 0.3, CPU, tf32=False,
                         traffic_overrides=SMALL):
        assert r["correct"], r["checks"]
        assert all(t["value"] == 0.0 for k, t in r["checks"].items()
                   if k != "scene_px")


def _trace():
    """A 1,000 us window of one session in two chunks (0-400, 500-900).
    The first chunk holds the session's prepare (10-60) and initialize
    (60-200, its one-frame remap 70-90 launching a 10 us kernel), then the
    chunk's remap (210-260, two kernels of 20 and 30 us) and association
    (300-350, one 40 us kernel); the second chunk its remap (510-560, 50
    us) and association (600-650, 60 us)."""
    return Trace([
        ev("user_annotation", "vbs.window", 0, 1000),
        ev("user_annotation", "vbs.pipeline.chunk", 0, 400),
        ev("user_annotation", "vbs.undistort.prepare", 10, 50),
        ev("user_annotation", "vbs.pipeline.initialize", 60, 140),
        ev("user_annotation", "vbs.undistort.remap", 70, 20),
        launch(75, 1), kernel("gather", 100, 10, 1),
        ev("user_annotation", "vbs.undistort.remap", 210, 50),
        launch(215, 2), kernel("gather", 220, 20, 2),
        launch(225, 3), kernel("mul", 240, 30, 3),
        ev("user_annotation", "vbs.track.associate", 300, 50),
        launch(305, 4), kernel("void associate_kernel<8>(float*)", 310, 40, 4),
        ev("user_annotation", "vbs.pipeline.chunk", 500, 400),
        ev("user_annotation", "vbs.undistort.remap", 510, 50),
        launch(515, 5), kernel("gather", 520, 50, 5),
        ev("user_annotation", "vbs.track.associate", 600, 50),
        launch(605, 6), kernel("void associate_kernel<8>(float*)", 610, 60, 6),
    ])


def _ctx(trace):
    return SimpleNamespace(trace=trace, units=1,
                           traffic={"frames": 4, "chunk": 2},
                           conf={"height": 4, "width": 8})


def test_the_calibrated_readers():
    read = lambda name: manifest.reader(name)(_ctx(_trace()))
    # Remap device time 10 + 20 + 30 + 50 us over two chunks.
    assert read("remap_device_ms.stream") == pytest.approx(0.055)
    assert read("associate_device_ms.stream") == pytest.approx(0.050)
    # Host time in prepare (50 us) and initialize (140 us), one session.
    assert read("session_setup_ms.stream") == pytest.approx(0.190)
    # Five frames of 4 x 8 (the chunks' four and frame 0 once more) at
    # 5 B, three maps of 8 B a pixel, over 110 us.
    bound = (5 * 32 * 5 + 3 * 32 * 8) / roofline.HBM_BYTES_PER_S
    assert read("remap_roofline") == pytest.approx(100 * bound / 110e-6)
    # Two frames' chain over the mean of 40 and 60 us.
    chain = 2 * 61 * 4 / 1.98e9
    assert read("associate_roofline") == pytest.approx(100 * chain / 50e-6)


@pytest.mark.parametrize("name", [
    "remap_device_ms.stream", "associate_device_ms.stream",
    "session_setup_ms.stream", "remap_roofline", "associate_roofline"])
def test_no_such_span_or_kernel_reads_nothing(name):
    trace = Trace([ev("user_annotation", "vbs.window", 0, 10),
                   ev("user_annotation", "vbs.pipeline.chunk", 0, 10),
                   launch(1, 1), kernel("stencil_kernel", 2, 5, 1)])
    assert manifest.reader(name)(_ctx(trace)) is None


def test_the_bounds():
    # 256 frames of 640 x 480 and five maps: 0.118 ms; the chain of 256
    # frames: 31.5 us.
    assert calibrated_bound.remap_bound_s(256, 5, 480, 640) == pytest.approx(
        (256 * 307200 * 5 + 5 * 307200 * 8) / 3.35e12)
    assert calibrated_bound.associate_bound_s(256) == pytest.approx(
        256 * 244 / 1.98e9)
