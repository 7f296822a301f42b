"""The calibrated sensor streamed as ``indent`` and ``track --undistort``
stream it, on the CPU: a 240x320 recording of 64 frames filmed through a
barrel lens and sunk far enough that the outer ring passes the 20 px
association gate, fed to ``StreamingPipeline`` sessions in 16-frame chunks
with ``undistort_frames`` and sequential association. The port's chunks
equal the benchmark's plain reference (``vbs_bench/reference/
pipeline_calibrated.py``) over the whole recording; frame-0 association
loses markers that sequential association keeps; a session opens the
undistortion and initialize spans and counts one map and its frames."""
import pytest
import torch

from vbs_bench import check
from vbs_bench.loads.common import keep
from vbs_bench.loads.stream import _cat
from vbs_bench.loads.stream_calibrated import lens_numbers, render_through_lens
from vbs_bench.reference import camera as ref_camera
from vbs_bench.reference import config as ref_config
from vbs_bench.reference import pipeline_calibrated as ref
from vbs_bench.reference.associate import associate
from vbs_bench.reference.unfused import detect_markers
from vision_basedsensor_tpu_torch import config, pipeline
from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.core.undistort import (
    reset_undistort_counts, undistort_counts)

CPU = torch.device("cpu")
H, W, N, CHUNK = 240, 320, 64, 16
CONF = {"height": H, "width": W, "dist": [-0.25, 0.08, 0.001, -0.001, 0.0]}
PIPELINE = {"undistort_frames": True,
            "track": {"association_mode": "sequential"},
            "reconstruct": {"warmup_frames": 0}}
# 5.0 mm at frame 63: the outer ring moves up to ~29 px in the rectified frame.
MOTION = {"drift_z_mm_per_frame": 0.08, "tilt_deg": [0.5, 3.0]}


@pytest.fixture(scope="module")
def rec():
    frames = render_through_lens(CONF, N, 2**31 + 28, MOTION, CPU)
    cfg = ref_config._from_jsonable(ref_config.PipelineConfig, PIPELINE)
    cam = ref_camera.CameraModel.create(**lens_numbers(CONF), device=CPU)
    src_map, rect_cam = ref.prepare(cam, H, W)
    table = ref.initialize(frames[0], cfg, src_map)
    out = ref.process_frames(frames, table, rect_cam, cfg, src_map)
    det = detect_markers(ref.rectify(frames, cfg, src_map), cfg.detect,
                         axis_scale=table.axis_scale)
    frame0 = associate(table, det, cfg.track.min_marker_distance_px)
    return dict(frames=frames, out=out, frame0=frame0,
                cfg=config._from_jsonable(config.PipelineConfig, PIPELINE),
                cam=CameraModel.create(**lens_numbers(CONF), device=CPU))


def _session(rec):
    return pipeline.StreamingPipeline(rec["cam"], rec["cfg"], device=CPU)


def _chunks(sp, frames):
    return [sp.process(frames[s:s + CHUNK]) for s in range(0, N, CHUNK)]


def test_the_chunked_session_equals_the_calibrated_reference(rec):
    got = _cat([keep(o) for o in _chunks(_session(rec), rec["frames"])])
    want = keep(rec["out"])
    # The frame-0 table comes once a chunk.
    want.tracked.ref_xy = want.tracked.ref_xy.repeat(N // CHUNK, 1)
    want.tracked.ring = want.tracked.ring.repeat(N // CHUNK)
    numbers = check.pipeline_numbers(got, want)
    assert numbers == dict.fromkeys(numbers, 0.0)


def test_frame0_association_loses_markers_that_sequential_keeps(rec):
    seq, frame0 = rec["out"].tracked, rec["frame0"]
    assert torch.equal(seq.valid[0], frame0.valid[0])
    # Sequential association follows each marker in steps inside half the
    # gate, out past the gate from its frame-0 place ...
    ok = seq.valid[1:] & seq.valid[:-1]
    step = torch.linalg.vector_norm(seq.xy[1:] - seq.xy[:-1], dim=-1)[ok]
    assert float(step.max()) < 10.0
    far = seq.valid[-1] & (torch.linalg.vector_norm(
        seq.xy[-1] - seq.ref_xy, dim=-1) > 20.0)
    assert int(far.sum()) >= 10
    # ... where frame-0 association has lost it: no detection, or another
    # marker's, at least a marker spacing away.
    gap = torch.linalg.vector_norm(frame0.xy[-1] - seq.xy[-1], dim=-1)
    assert bool((~frame0.valid[-1] | (gap > 15.0))[far].all())


def test_a_session_opens_the_undistortion_and_initialize_spans(rec):
    sp = _session(rec)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        sp.process(rec["frames"][:2])
        sp.process(rec["frames"][2:4])
    counts = {}
    for e in prof.events():
        if e.name.startswith("vbs."):
            counts[e.name] = counts.get(e.name, 0) + 1
    assert counts["vbs.undistort.prepare"] == 1
    assert counts["vbs.pipeline.initialize"] == 1
    # Frame 0 in initialize, then each chunk.
    assert counts["vbs.undistort.remap"] == 3


@pytest.mark.parametrize("sessions", [1, 2])
def test_the_counts_read_one_map_a_session_and_every_frame(rec, sessions):
    reset_undistort_counts()
    for _ in range(sessions):
        _chunks(_session(rec), rec["frames"])
    # Each session's frame 0 is remapped for its table, then in its chunk.
    assert undistort_counts() == {"maps": sessions,
                                  "frames": sessions * (N + 1)}
    reset_undistort_counts()
    assert undistort_counts() == {"maps": 0, "frames": 0}


def test_a_session_given_its_table_builds_its_map_but_no_table(rec):
    table = pipeline.initialize(
        rec["frames"][0], rec["cfg"],
        rectify_map=pipeline.prepare_undistortion(rec["cam"], H, W,
                                                  rec["cfg"])[0])
    reset_undistort_counts()
    sp = pipeline.StreamingPipeline(rec["cam"], rec["cfg"], ref=table,
                                    device=CPU)
    out = sp.process(rec["frames"][:CHUNK])
    assert undistort_counts() == {"maps": 1, "frames": CHUNK}
    want = rec["out"].tracked
    assert torch.equal(out.tracked.valid, want.valid[:CHUNK])
    assert torch.equal(out.tracked.xy, want.xy[:CHUNK])
