"""The program's spans (``vision_basedsensor_tpu_torch/utils/profiling.py``):
free with no profiler running, every name of ``SPANS`` and no other, each
nested in its layer's parent span, exceptions passing through, and the
replay command's trace under ``vbs-torch --profile-dir``.

Inputs are two 240x384 frames of the port's own synthetic dome on the CPU
(the fused detector branch, and with ``backend="xla"`` the unfused one).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from vision_basedsensor_tpu_torch import pipeline
from vision_basedsensor_tpu_torch.cli import main as cli
from vision_basedsensor_tpu_torch.config import PipelineConfig
from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg
from vision_basedsensor_tpu_torch.io.video import MjpegAviWriter
from vision_basedsensor_tpu_torch.synth.render import (default_scene,
                                                       render_frames)
from vision_basedsensor_tpu_torch.utils.profiling import (SPANS, profile_to,
                                                          trace_annotation)

H, W, B = 240, 384, 2
# The spans of the ingest and the replay command; every other name is
# emitted by process_frames (both detector branches), a stream chunk and a
# rectifying session's first chunk (its map, initialize and remap).
INGEST = {"vbs.feed.open", "vbs.feed.wait", "vbs.feed.device_decode",
          "vbs.stream.readback", "vbs.io.table"}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def run():
    scene = default_scene(H, W, device=CPU)
    d = torch.zeros(B, 65, 3)
    d[1, :, 2] = -0.3
    frames = render_frames(scene, d).to(torch.uint8)
    cfg = PipelineConfig()
    ref = pipeline.initialize(frames[0], cfg)
    unfused = dataclasses.replace(
        cfg, detect=dataclasses.replace(cfg.detect, backend="xla"))
    rectified = dataclasses.replace(cfg, undistort_frames=True)

    def call():
        pipeline.process_frames(frames, ref, scene.cam, cfg)
        pipeline.process_frames(frames, ref, scene.cam, unfused)
        pipeline.StreamingPipeline(scene.cam, cfg, ref=ref,
                                   device=CPU).process(frames)
        pipeline.StreamingPipeline(scene.cam, rectified,
                                   device=CPU).process(frames)
    return dict(call=call, frames=frames, scene=scene, ref=ref,
                cfgs={"fused": cfg, "unfused": unfused})


def _spans(path):
    """The ``vbs.*`` spans of a Chrome trace: ``(start, end, name, tid)``."""
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"], e["name"], e["tid"]) for e in events
            if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("vbs.")]


def _inside(span, spans, parents):
    a, b, _, tid = span
    return any(p[2] in parents and p[3] == tid and p[0] <= a and b <= p[1]
               for p in spans)


def test_no_record_function_without_a_profiler(run, monkeypatch):
    made = []

    class Counting(torch.profiler.record_function):
        def __init__(self, name, *args):
            made.append(name)
            super().__init__(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    run["call"]()
    assert made == []
    # The same calls under a profiler construct one for each span.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        run["call"]()
    assert set(made) == set(SPANS) - INGEST


def test_spans_are_named_and_nested(run, tmp_path):
    with profile_to(str(tmp_path), device="cpu"):
        run["call"]()
    spans = _spans(tmp_path / "trace.json")
    assert {s[2] for s in spans} == set(SPANS) - INGEST
    top = {"vbs.pipeline.process_frames", "vbs.pipeline.chunk"}
    for s in spans:
        name = s[2]
        if name.startswith("vbs.detect."):
            assert _inside(s, spans, {"vbs.detect"}), name
        elif name.startswith("vbs.contact."):
            assert _inside(s, spans, {"vbs.contact"}), name
        elif name not in top:
            assert _inside(s, spans, top), name
    assert len(SPANS) == len(set(SPANS))


def test_the_peak_field_span_is_the_unfused_branchs(run, tmp_path):
    # One call a branch: the fused branch's cell maxima come from the
    # fields kernel, so only the unfused one opens vbs.detect.peak_field,
    # inside its vbs.detect.peaks.
    found = {}
    for name, cfg in run["cfgs"].items():
        with profile_to(str(tmp_path / name), device="cpu"):
            pipeline.process_frames(run["frames"], run["ref"],
                                    run["scene"].cam, cfg)
        found[name] = _spans(tmp_path / name / "trace.json")
    assert not any(s[2] == "vbs.detect.peak_field" for s in found["fused"])
    fields = [s for s in found["unfused"] if s[2] == "vbs.detect.peak_field"]
    assert len(fields) == 1
    assert _inside(fields[0], found["unfused"], {"vbs.detect.peaks"})


@pytest.mark.parametrize("profiled", [False, True])
def test_an_exception_inside_a_span_propagates(tmp_path, profiled):
    with pytest.raises(ValueError, match="inside"):
        if profiled:
            with profile_to(str(tmp_path), device="cpu"):
                with trace_annotation("vbs.contact.fit"):
                    raise ValueError("raised inside the span")
        else:
            with trace_annotation("vbs.contact.fit"):
                raise ValueError("raised inside the span")


def test_profile_dir_traces_the_replay_command(run, tmp_path):
    avi = tmp_path / "clip.avi"
    wr = MjpegAviWriter(str(avi), 12.0, (W, H))
    for f in run["frames"].numpy().astype(np.uint8):
        wr.write_jpeg(encode_jpeg(f, 70))
    wr.close()
    prof = tmp_path / "prof"
    cli.main(["--device", "cpu", "--profile-dir", str(prof), "track",
              str(avi), "--tpu-decode", "--chunk", "1", "--output-dir",
              str(tmp_path / "out")])
    assert (tmp_path / "out" / "markers.csv").stat().st_size > 0
    names = {s[2] for s in _spans(prof / "trace.json")}
    assert {"vbs.feed.open", "vbs.feed.wait", "vbs.feed.device_decode",
            "vbs.stream.readback", "vbs.io.table", "vbs.pipeline.chunk",
            "vbs.detect"} <= names
    assert names <= set(SPANS)


@pytest.mark.cuda_only
def test_process_frames_trace_on_the_card(tmp_path):
    """``profile_to``'s trace of one ``process_frames`` batch on the card
    holds the program's span and device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    scene = default_scene(H, W, device=dev)
    frames = render_frames(scene, torch.zeros((B, 65, 3), device=dev))
    cfg = PipelineConfig()
    ref = pipeline.initialize(frames[0], cfg)
    pipeline.process_frames(frames, ref, scene.cam, cfg)
    with profile_to(str(tmp_path)) as prof:
        pipeline.process_frames(frames, ref, scene.cam, cfg)
        torch.cuda.synchronize()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert "vbs.pipeline.process_frames" in {e.get("name") for e in events}
    assert sum(e.device_time_total for e in prof.key_averages()) > 0
