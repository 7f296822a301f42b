"""The port's acquisition server (capture/server.py, ``vbs-torch serve``)
against the JAX package's, on the CPU.

The server binds an ephemeral localhost port (``CaptureConfig(port=0)``);
nothing outside the machine is reached. Protocol tests serve 160x120 frames
(tests/test_capture.py's size); the end-to-end test serves the rendered
dome at 240x320 to ``vbs-torch --device cpu run-live --tpu-decode``, which
must track at least 60 markers in every frame (tests/test_parallel.py:31-35's
bar at this size).
"""
import contextlib
import io
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu.capture import server as jserver
from vision_basedsensor_tpu.synth import default_scene as jscene

from vision_basedsensor_tpu_torch import capture
from vision_basedsensor_tpu_torch.capture import server as tserver
from vision_basedsensor_tpu_torch.cli import main as tcli
from vision_basedsensor_tpu_torch.config import CaptureConfig
from vision_basedsensor_tpu_torch.io import video as tvideo
from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg
from vision_basedsensor_tpu_torch.io.mjpeg import iter_mjpeg_bytes
from vision_basedsensor_tpu_torch.ops.jpeg import MjpegBatchDecoder
from vision_basedsensor_tpu_torch.pipeline import StreamingPipeline
from vision_basedsensor_tpu_torch.synth import default_scene


@pytest.fixture
def cfg():
    return CaptureConfig(port=0, width=160, height=120, fps=30)


@contextlib.contextmanager
def serving(server):
    server.start()
    try:
        yield f"http://127.0.0.1:{server.port}"
    finally:
        server.stop()


def test_synthetic_camera_matches_jax(cfg):
    """The first frames of the rendered dome (z = -0.5 (1 + sin(t / 20)))
    equal the JAX camera's within one gray level, tests/test_torch_synth.py's
    bound for rendered frames (the renderers round float32 sums to integers:
    observed 4 of 19,200 pixels differ), gray repeated over three
    channels."""
    jc = jcfg.CaptureConfig(width=160, height=120)
    jcam = jserver.SyntheticCamera(jc, jscene(120, 160))
    tcam = tserver.SyntheticCamera(cfg, default_scene(120, 160, device="cpu"))
    for _ in range(3):
        want, got = jcam.read(), tcam.read()
        assert got.shape == (120, 160, 3) and got.dtype == np.uint8
        np.testing.assert_allclose(got, want, rtol=0, atol=1)
        assert (got != want).mean() < 1e-3
        assert (got == got[..., :1]).all()
    assert tcam._t == 3


def test_no_camera_pattern_and_led_ring(cfg):
    """Without a scene the camera draws the reference's "NO CAMERA" banner;
    without the LED library the ring is simulated."""
    f = tserver.SyntheticCamera(cfg).read()
    assert f.shape == (120, 160, 3)
    assert (f[60, 60] > 0).all() and (f[0, 0] == 0).all()
    leds = capture.LedRing(cfg)
    assert leds.simulated
    leds.all_white()
    assert leds._pixels == [(255, 255, 255)] * cfg.led_count
    leds.off()
    assert leds._pixels == [(0, 0, 0)] * cfg.led_count


def test_encode_jpeg_without_cv2(cfg, monkeypatch):
    """Where cv2 is missing the numpy encoder writes gray frames (three equal
    channels) and refuses a colour frame, naming cv2."""
    frame = tserver.SyntheticCamera(
        cfg, default_scene(120, 160, device="cpu")).read()
    with_cv2 = tserver._encode_jpeg(frame, 70)
    assert with_cv2[:2] == b"\xff\xd8"
    monkeypatch.setattr(tvideo, "_cv2", lambda: None)
    got = tserver._encode_jpeg(frame, 70)
    assert got == encode_jpeg(frame[..., 0], 70)
    dec = MjpegBatchDecoder(device="cpu")
    x = dec.dense_to_device(dec.entropy_decode_dense([got]))[0]
    assert float((x - torch.from_numpy(frame[..., 0]).float()).abs().mean()) < 4
    colour = frame.copy()
    colour[..., 2] = 0
    with pytest.raises(RuntimeError, match="cv2"):
        tserver._encode_jpeg(colour, 70)


def test_server_serves_index_snapshot_and_stream(cfg):
    camera = capture.CameraHandler(cfg, capture.LedRing(cfg),
                                   synthetic=tserver.SyntheticCamera(cfg))
    server = capture.StreamingServer(cfg, camera)
    assert server.port > 0
    with serving(server) as base:
        html = urllib.request.urlopen(f"{base}/", timeout=10).read()
        assert b"/stream" in html and b"160x120" in html
        snap = urllib.request.urlopen(f"{base}/snapshot", timeout=10).read()
        assert snap[:2] == b"\xff\xd8" and snap[-2:] == b"\xff\xd9"
        frames = list(iter_mjpeg_bytes(f"{base}/stream", max_frames=3))
        assert len(frames) == 3
        assert all(f[:2] == b"\xff\xd8" and f[-2:] == b"\xff\xd9"
                   for f in frames)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nothing", timeout=10)
    assert not any(t.is_alive() for t in server._threads)


def test_mailbox_and_close_joins_the_capture_thread(cfg):
    """The capture thread publishes every (skip_frames + 1)-th frame into
    the latest-frame mailbox; close() stops the loop and joins it."""
    cam = tserver.SyntheticCamera(cfg, default_scene(120, 160, device="cpu"))
    camera = capture.CameraHandler(cfg, None, synthetic=cam)
    assert camera.frame is None
    t = threading.Thread(target=camera.capture_loop, daemon=True)
    t.start()
    t0 = time.time()
    while camera.frame is None and time.time() - t0 < 10:
        time.sleep(0.01)
    assert camera.frame is not None and camera.get_frame() == camera.frame
    camera.close(t)
    assert not t.is_alive() and not camera.running
    assert cam._t % (cfg.skip_frames + 1) in (0, 1)


def test_serve_command_arguments(monkeypatch):
    calls = []
    monkeypatch.setattr(capture, "run_server",
                        lambda *a, **kw: calls.append((a, kw)))
    tcli.main(["--device", "cpu", "serve", "--port", "0", "--synthetic"])
    tcli.main(["--device", "cpu", "serve"])
    (a1, kw1), (a2, kw2) = calls
    assert a1[0].port == 0 and kw1["synthetic"] and kw1["block"]
    assert kw1["device"] == torch.device("cpu")
    assert a2[0] == CaptureConfig() and not kw2["synthetic"]


def test_run_live_tracks_the_served_stream(tmp_path, monkeypatch):
    """``vbs-torch --device cpu run-live URL --tpu-decode`` on the synthetic
    server's stream (240x320, q70): at least 60 markers in every frame."""
    from vision_basedsensor_tpu_torch.config import PipelineConfig, to_json
    cap = CaptureConfig(port=0, width=320, height=240, fps=30)
    (tmp_path / "cfg.json").write_text(to_json(PipelineConfig(capture=cap)))
    server = capture.run_server(cap, synthetic=True, block=False,
                                device="cpu")
    outs = []
    process = StreamingPipeline.process

    def spy(self, frames):
        out = process(self, frames)
        outs.append(out)
        return out

    monkeypatch.setattr(StreamingPipeline, "process", spy)
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            tcli.main(["--device", "cpu", "--config",
                       str(tmp_path / "cfg.json"), "run-live",
                       f"http://127.0.0.1:{server.port}/stream",
                       "--tpu-decode", "--max-frames", "8"])
    finally:
        server.stop()
    assert not any(t.is_alive() for t in server._threads)
    tracked = torch.cat([o.tracked.valid for o in outs]).sum(-1)
    assert tracked.shape == (8,)
    assert int(tracked.min()) >= 60, text.getvalue()
    assert "frames 8: tracked" in text.getvalue()
    assert "skipped" not in text.getvalue()
