"""The streaming cell ``vga_stream_chunk64`` on the CPU, at a size the CPU
holds (6 frames in chunks of 3): sound, it is correct; with a fault planted
in the session, at a chunk boundary or in what a chunk returns, it is not;
the reference in the program's place reads 0; a session's chunks give what
one batch gives; the stream's readers read a hand-built trace."""
from types import SimpleNamespace

import pytest
import torch

from test_vbs_bench_spans import ev, kernel, launch
from vbs_bench import check, manifest
from vbs_bench.control import readings
from vbs_bench.gen.scene import camera_numbers, render_uint8
from vbs_bench.loads.common import keep
from vbs_bench.loads.stream import _cat
from vbs_bench.program import Program
from vbs_bench.run import run_cell
from vbs_bench.trace import Trace

CPU = torch.device("cpu")
CELL = "vga_stream_chunk64"
SEED = 2**31 + 99
SMALL = {"frames": 6, "chunk": 3}
M = manifest.load()


def run(program=None, trace=False):
    """A run; traced, it runs ``trace_units`` whole sessions, so every chunk
    boundary lies inside what is checked (a short window on a slow CPU may
    end at the first chunk)."""
    return run_cell(CELL, SEED, 0.3, trace, CPU, program=program,
                    traffic_overrides=SMALL)


class _BrokenSession:
    """A session of the port with one fault planted."""

    def __init__(self, sp, fault):
        self.sp, self.fault = sp, fault

    def process(self, frames):
        if self.fault == "carry_restart":
            # The displacement scan's carry dropped at every chunk boundary:
            # each chunk measured from its own first sighting.
            self.sp.carry = None
            return self.sp.process(frames)
        if self.fault == "half_chunk":
            # Half of the chunk left out: the first half's results stand in
            # for the rest.
            half = max(frames.shape[0] // 2, 1)
            out = self.sp.process(frames[:half])
            idx = torch.arange(frames.shape[0]) % half
            pick = lambda x: x[idx] if x.ndim and x.shape[0] == half else x
            return type(out)(*(type(p)(*(pick(x) if isinstance(
                x, torch.Tensor) else x for x in p)) for p in out))
        if self.fault == "answer":
            # One position altered where it is produced.
            out = self.sp.process(frames)
            xy = out.tracked.xy.clone()
            xy[-1, 0, 0] += 0.5
            return out._replace(tracked=out.tracked._replace(xy=xy))
        raise ValueError(self.fault)


class BrokenStream(Program):
    def __init__(self, fault):
        super().__init__(CPU)
        self.fault = fault

    def stream(self, cam, cfg, ref):
        return _BrokenSession(super().stream(cam, cfg, ref), self.fault)


def test_the_cell_is_in_the_manifest_on_the_shipped_sensor():
    cell = manifest.cell(M, CELL)
    assert cell["chips"] == 1 and cell["config"] == "vga640x480"
    traffic = manifest.traffic(cell)
    assert traffic["kind"] == "stream"
    assert traffic["frames"] % traffic["chunk"] == 0


def test_a_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert all(t["value"] == 0.0 for t in r["checks"].values())


@pytest.mark.parametrize("fault", ["carry_restart", "half_chunk", "answer"])
def test_a_fault_is_not_correct(fault):
    r = run(BrokenStream(fault), trace=True)
    assert not r["correct"], r["checks"]


def test_a_restarted_carry_shows_in_the_displacement():
    checks = run(BrokenStream("carry_restart"), trace=True)["checks"]
    assert checks["from_first_mm"]["value"] > checks["from_first_mm"]["limit"]
    assert checks["world_mm"]["value"] == 0.0


def test_the_reference_in_the_programs_place_reads_zero():
    for _, r in readings(CELL, [SEED], 0.3, CPU, tf32=False,
                         traffic_overrides=SMALL):
        assert r["correct"], r["checks"]
        assert all(t["value"] == 0.0 for t in r["checks"].values())


def test_a_sessions_chunks_give_what_one_batch_gives():
    conf = manifest.config(M, manifest.cell(M, CELL))
    h, w = conf["height"], conf["width"]
    frames = render_uint8(h, w, 6, SEED, manifest.traffic(
        manifest.cell(M, CELL))["motion"], CPU)
    p = Program(CPU)
    cfg = p.config(conf["pipeline"])
    cam = p.camera(camera_numbers(h, w))
    ref = p.initialize(frames[0], cfg)
    sp = p.stream(cam, cfg, ref)
    got = _cat([keep(sp.process(frames[s:s + 3])) for s in (0, 3)])
    want = keep(p.process_frames(frames, ref, cam, cfg))
    # The frame-0 table comes once a chunk.
    want.tracked.ref_xy = want.tracked.ref_xy.repeat(2, 1)
    want.tracked.ring = want.tracked.ring.repeat(2)
    numbers = check.pipeline_numbers(got, want)
    assert numbers == dict.fromkeys(numbers, 0.0)


def _trace():
    """A 1,000 us window: two chunk spans (0-300, 500-800), the first
    launching two kernels (100-200, 250-300), the second one (600-700); a
    launch between them that must not count."""
    return Trace([
        ev("user_annotation", "vbs.window", 0, 1000),
        ev("user_annotation", "vbs.pipeline.chunk", 0, 300),
        launch(10, 1), kernel("k1", 100, 100, 1),
        launch(20, 2), kernel("k2", 250, 50, 2),
        launch(400, 3), kernel("readback", 410, 20, 3),
        ev("user_annotation", "vbs.pipeline.chunk", 500, 300),
        launch(510, 4), kernel("k3", 600, 100, 4),
    ])


def test_the_streams_readers():
    ctx = SimpleNamespace(trace=_trace(), units=1,
                          traffic={"frames": 4, "chunk": 2})
    read = lambda name: manifest.reader(name)(ctx)
    assert read("chunk_launches.stream") == pytest.approx(1.5)
    # Idle inside the chunks: 0-100, 200-250 and 500-600, 700-800.
    assert read("chunk_idle_ms.stream") == pytest.approx(0.175)
    # Busy 100-200, 250-300, 410-430, 600-700: 270 us of 1,000.
    assert read("device_idle_pct.stream") == pytest.approx(73.0)


def test_no_chunk_span_reads_nothing():
    ctx = SimpleNamespace(trace=Trace([ev("user_annotation", "vbs.window",
                                          0, 10)]),
                          units=1, traffic={"frames": 4, "chunk": 2})
    assert manifest.reader("chunk_launches.stream")(ctx) is None
    assert manifest.reader("chunk_idle_ms.stream")(ctx) is None
