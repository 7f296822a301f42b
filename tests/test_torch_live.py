"""The port's live path against the JAX package's: the MJPEG client
(``io/mjpeg.py``), the state publisher (``io/publish.py``) and the commands
``record`` and ``run-live`` (run with ``--device cpu``).

A localhost server (``torch_parity.MjpegServer``) serves
``multipart/x-mixed-replace`` parts: six 240x384 staircase frames rendered by the JAX synth and encoded at
q70 with the port's encoder (``/stream?start=K&n=N`` serves frames K..K+N-1,
then ends the response). Nothing outside the machine is reached. Every
``run-live`` reads at most as many frames as its reader holds
(``max(2 * batch, 8)``), so no frame is dropped and both packages see the
same frames in the same chunks.

Both CLIs get a ``--config`` with ``backend="pallas"`` (interpret mode in
the JAX package) and the capture size of the frames (``run-live``'s
nominal camera). Tolerances: the printed lines equal, except that a
chunk's mean displacement (printed to 1e-3 mm) may differ by one unit in its
last digit: on q70 JPEG noise one marker's NCC peak has two near-equal
pixels, and the last-bit difference of the NCC field moves that marker
~0.07 px (``tests/test_torch_video.py``), which moves a chunk's mean
displacement by a few 1e-4 mm. The published states and the saved
sessions carry the same marker: their tests give its bounds.
"""
import contextlib
import importlib.util
import io
import json
import os
import re
import threading
import urllib.request

import numpy as np
import pytest
import torch

from torch_parity import (MjpegServer, np_, render_jax, run_jax_cli,
                          run_port_cli, staircase)

from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu import native as jnative
from vision_basedsensor_tpu.analysis.force import \
    contact_state_sequence as j_contact
from vision_basedsensor_tpu.io import mjpeg as jmjpeg
from vision_basedsensor_tpu.io import publish as jpublish
from vision_basedsensor_tpu.io.session import load_session as j_load_session
from vision_basedsensor_tpu.reconstruct import displacement_scan as j_scan
from vision_basedsensor_tpu.synth import tilt_deviation_field

from vision_basedsensor_tpu_torch.analysis.force import \
    contact_state_sequence as t_contact
from vision_basedsensor_tpu_torch.cli import main as tcli
from vision_basedsensor_tpu_torch.config import (AnalysisConfig,
                                                 ReconstructConfig)
from vision_basedsensor_tpu_torch.io import mjpeg as tmjpeg
from vision_basedsensor_tpu_torch.io import publish as tpublish
from vision_basedsensor_tpu_torch.io import video as tvideo
from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg
from vision_basedsensor_tpu_torch.io.session import load_session
from vision_basedsensor_tpu_torch.io.video import _iter_avi_video_chunks
from vision_basedsensor_tpu_torch.ops import jpeg as tjpeg
from vision_basedsensor_tpu_torch.reconstruct import displacement_scan

H, W, N = 240, 384, 6
HAS_HOST_DECODE = any(importlib.util.find_spec(m) is not None
                      for m in ("cv2", "PIL"))


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    d = tmp_path_factory.mktemp("live")
    frames, _ = render_jax(H, W, staircase(N, 0.3))
    jpegs = [encode_jpeg(f, 70) for f in frames.astype(np.uint8)]
    cfg = jcfg.PipelineConfig(
        detect=jcfg.DetectConfig(backend="pallas"),
        capture=jcfg.CaptureConfig(width=W, height=H))
    (d / "cfg.json").write_text(jcfg.to_json(cfg))
    srv = MjpegServer(jpegs)
    yield dict(frames=frames, jpegs=jpegs, url=srv.url,
               cfg=str(d / "cfg.json"),
               cache=tmp_path_factory.mktemp("jax_cache"))
    srv.close()


@pytest.mark.parametrize("boundary", ["frame", "--frame", "xyz"])
@pytest.mark.parametrize("length", [True, False])
def test_iter_mjpeg_bytes_matches_jax(stream, boundary, length):
    """The boundary from the header (also with nonconforming leading
    dashes), parts with and without Content-Length: every payload
    byte-equal to what was served, as the JAX client reads them."""
    srv = MjpegServer(stream["jpegs"], boundary=boundary, length=length)
    try:
        got = list(tmjpeg.iter_mjpeg_bytes(srv.url))
        want = list(jmjpeg.iter_mjpeg_bytes(srv.url))
    finally:
        srv.close()
    assert got == want == stream["jpegs"]


def test_iter_mjpeg_bytes_max_frames(stream):
    got = list(tmjpeg.iter_mjpeg_bytes(stream["url"], max_frames=2))
    assert got == stream["jpegs"][:2]
    got = list(tmjpeg.iter_mjpeg_bytes(stream["url"] + "?start=3&n=2",
                                       max_frames=5))
    assert got == stream["jpegs"][3:5]


@pytest.mark.skipif(not HAS_HOST_DECODE, reason="host decode needs cv2 or PIL")
def test_mjpeg_video_source_matches_jax(stream):
    """Host decode of the live stream: the same BGR batches as the JAX
    package's ``MjpegVideoSource``, no frame dropped."""
    src = tmjpeg.MjpegVideoSource(stream["url"], max_frames=5)
    got = list(src.batches(2))
    want = list(jmjpeg.MjpegVideoSource(stream["url"], max_frames=5)
                .batches(2))
    assert [g.shape for g in got] == [(2, H, W, 3), (2, H, W, 3), (1, H, W, 3)]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    assert src.last_dropped == 0
    np.testing.assert_array_equal(
        np.concatenate(got), np.stack(list(tmjpeg.iter_mjpeg(
            stream["url"], max_frames=5))))


@pytest.mark.skipif(importlib.util.find_spec("PIL") is None,
                    reason="the fallback decoder is PIL")
def test_mjpeg_video_source_pil_fallback(stream, monkeypatch):
    """Without cv2 the port decodes the gray stream through PIL to three
    equal channels near the encoded frames (q70: a mean error of ~2.7 gray
    levels, as tests/test_torch_cli.py bounds it). The JAX package's
    fallback gives the same pixels with each row reversed (it flips the
    last axis of a 2-D gray image): a departure, not a parity."""
    monkeypatch.setattr(tvideo, "_cv2", lambda: None)
    monkeypatch.setattr(jmjpeg, "_cv2", None)
    got = np.concatenate(list(tmjpeg.MjpegVideoSource(
        stream["url"], max_frames=4).batches(2)))
    want = np.concatenate(list(jmjpeg.MjpegVideoSource(
        stream["url"], max_frames=4).batches(2)))
    assert got.shape == (4, H, W, 3) and want.shape == (4, H, W)
    assert (got == got[..., :1]).all()
    err = np.abs(got[..., 0].astype(np.float32) - stream["frames"][:4])
    assert err.mean() < 4.0
    np.testing.assert_array_equal(got[..., 0], want[:, :, ::-1])


@pytest.mark.parametrize("transport", ["tdelta", "split", "packed"])
def test_mjpeg_cuda_video_source_matches_jax(stream, transport):
    """``MjpegCudaVideoSource`` (on the CPU here) yields the frames of
    ``MjpegBatchDecoder`` on the same chunks, equal to the JAX package's
    ``MjpegTpuVideoSource``, and sums its byte accounting over the session
    as the JAX source does."""
    src = tmjpeg.MjpegCudaVideoSource(stream["url"], transport=transport,
                                      device="cpu")
    got = [np_(b) for b in src.batches(4)]
    jsrc = jmjpeg.MjpegTpuVideoSource(stream["url"], transport=transport)
    want = [np.asarray(b) for b in jsrc.batches(4)]
    assert [g.shape for g in got] == [(4, H, W), (2, H, W)]
    dec = tjpeg.MjpegBatchDecoder(device="cpu")
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_array_equal(g, w)
        chunk = stream["jpegs"][4 * i:4 * i + 4]
        hp = getattr(dec, f"entropy_decode_{transport}")(chunk)
        np.testing.assert_array_equal(
            g, np_(getattr(dec, f"{transport}_to_device")(hp)))
    assert src.last_stats == jsrc.last_stats
    assert src.last_stats["frames"] == N
    assert src.last_dropped == 0


def test_mjpeg_cuda_video_source_rejects_bad_arguments(stream):
    with pytest.raises(ValueError, match="transport"):
        tmjpeg.MjpegCudaVideoSource(stream["url"], transport="dense",
                                    device="cpu")


def test_stream_reader_drops_oldest_and_raises_in_consumer(monkeypatch):
    """A slow consumer sees the newest ``maxlen`` frames with the rest
    counted as dropped; a mid-stream gap reconnects up to the budget and
    then raises in the consumer; a stream that never produced fails at
    once."""
    frames = [bytes([i]) * 4 for i in range(30)]

    def fake_iter(url, max_frames=None):
        for i, fb in enumerate(frames):
            if url == "err" and i == 5:
                raise ConnectionError("stream died")
            yield fb

    monkeypatch.setattr(tmjpeg, "iter_mjpeg_bytes", fake_iter)
    monkeypatch.setattr(tmjpeg.time, "sleep", lambda s: None)
    reader = tmjpeg._StreamReader("ok", None, maxlen=8)
    reader._thread.join(5.0)
    assert not reader._thread.is_alive()
    assert list(reader.frames()) == frames[-8:]
    assert reader.dropped == 30 - 8

    reader = tmjpeg._StreamReader("err", None, maxlen=64, reconnects=2)
    with pytest.raises(ConnectionError, match="stream died"):
        list(reader.frames())
    assert reader.reconnects == 2

    def dead_iter(url, max_frames=None):
        raise ConnectionError("refused")
        yield  # pragma: no cover

    monkeypatch.setattr(tmjpeg, "iter_mjpeg_bytes", dead_iter)
    reader = tmjpeg._StreamReader("x", None, maxlen=8)
    with pytest.raises(ConnectionError, match="refused"):
        list(reader.frames())
    assert reader.reconnects == 0


def test_record_matches_jax(stream, tmp_path):
    """``record``: the ``.avi`` holds the served JPEGs byte for byte, and
    equals the file the JAX CLI records from the same server."""
    paths = {pkg: tmp_path / f"{pkg}.avi" for pkg in ("jax", "port")}
    argv = lambda p: ["record", stream["url"], str(p), "--max-frames", "5"]
    want_out = run_jax_cli(argv(paths["jax"]), stream["cache"])
    got_out = run_port_cli(argv(paths["port"]))
    assert got_out.replace("port.avi", "jax.avi") == want_out
    assert f"recording {W}x{H} @ 12.0 fps" in got_out
    data = paths["port"].read_bytes()
    assert data == paths["jax"].read_bytes()
    assert list(_iter_avi_video_chunks(data)) == stream["jpegs"][:5]


def test_record_without_frames_returns_1(stream, tmp_path, capsys):
    url = stream["url"] + "?n=0"
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(["--device", "cpu", "record", url,
                          str(tmp_path / "x.avi")]) == 1
    assert "no frames received" in capsys.readouterr().err
    assert not (tmp_path / "x.avi").exists()


def _run_live(stream, pkg, *extra, query=""):
    argv = ["--config", stream["cfg"], "run-live", stream["url"] + query,
            "--batch", "2", *extra]
    if pkg == "jax":
        return run_jax_cli(argv, stream["cache"])
    return run_port_cli(argv)


_TRACKED = re.compile(r"frames (\d+): tracked (\d+)/65 markers, "
                      r"mean displacement (-?[\d.]+) mm")


def _assert_same_lines(got, want):
    """Printed lines equal; a chunk's mean displacement within one unit of
    its printed last digit (the module docstring says why)."""
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        mg, mw = _TRACKED.fullmatch(g), _TRACKED.fullmatch(w)
        if mg is None or mw is None:
            assert g == w
            continue
        assert mg.group(1, 2) == mw.group(1, 2), (g, w)
        assert abs(float(mg.group(3)) - float(mw.group(3))) <= 1.0001e-3, \
            (g, w)


def test_run_live_tpu_decode_matches_jax(stream):
    """``run-live --tpu-decode`` over five frames in chunks of two: every
    printed line (tracking, and the transport's bytes a frame) equal to
    the JAX CLI's."""
    got = _run_live(stream, "port", "--max-frames", "5", "--tpu-decode")
    want = _run_live(stream, "jax", "--max-frames", "5", "--tpu-decode")
    _assert_same_lines(got, want)
    assert got.count("/65 markers") == 3 and "frames 5: tracked" in got
    assert "tpu-decode transport:" in got and "skipped" not in got


@pytest.mark.skipif(not HAS_HOST_DECODE, reason="host decode needs cv2 or PIL")
def test_run_live_host_decode_matches_jax(stream):
    got = _run_live(stream, "port", "--max-frames", "4")
    want = _run_live(stream, "jax", "--max-frames", "4")
    _assert_same_lines(got, want)
    assert got.count("/65 markers") == 2 and "transport" not in got


def test_run_live_tpu_decode_raises_where_jax_falls_back(stream, monkeypatch,
                                                         capsys):
    """Where the native decoder cannot be built the JAX CLI falls back to
    host decode; the port's ``--tpu-decode`` raises."""
    monkeypatch.setattr(jnative, "load_jpeg_lib", lambda: None)

    def no_compiler():
        raise RuntimeError("no C++ compiler ($CXX or g++) on PATH")

    monkeypatch.setattr(tjpeg, "load_jpeg_lib", no_compiler)
    if HAS_HOST_DECODE:
        out = _run_live(stream, "jax", "--max-frames", "2", "--tpu-decode")
        assert "falling back to host decode" in capsys.readouterr().err
        assert "frames 2: tracked" in out
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _run_live(stream, "port", "--max-frames", "2", "--tpu-decode")


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def test_run_live_publishes_the_state_of_jax(stream, monkeypatch):
    """``run-live --publish``: after each chunk the port's ``/state`` serves
    that chunk's last frame (read over HTTP while the session runs), and
    each payload agrees with the one the JAX CLI publishes: the tilt within
    0.01 deg, plane and means within 2e-3 (the near-tied marker of the
    module docstring moves them by 0.005 deg and 6e-4; on equal inputs the
    payloads agree within 1e-4, ``test_contact_state_payload_matches_jax``)."""
    published = {"jax": [], "port": []}
    served = []
    port = _free_port()
    t_update = tpublish.StatePublisher.update
    j_update = jpublish.StatePublisher.update

    def port_update(self, state):
        t_update(self, state)
        published["port"].append(state)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/state",
                                    timeout=10) as r:
            served.append(json.loads(r.read()))

    def jax_update(self, state):
        j_update(self, state)
        published["jax"].append(state)

    monkeypatch.setattr(tpublish.StatePublisher, "update", port_update)
    monkeypatch.setattr(jpublish.StatePublisher, "update", jax_update)
    out = _run_live(stream, "port", "--max-frames", "4", "--tpu-decode",
                    "--publish", str(port))
    _run_live(stream, "jax", "--max-frames", "4", "--tpu-decode",
              "--publish", "0")
    assert f"contact state served on 127.0.0.1:{port}" in out
    assert [s["seq"] for s in served] == [1, 2]
    for got, state in zip(served, published["port"]):
        assert got == dict(state, seq=got["seq"])
    assert len(published["jax"]) == 2
    for got, want in zip(published["port"], published["jax"]):
        _assert_payload_close(got, want, atol=2e-3, tilt_atol=1e-2)
    assert [p["frames_seen"] for p in published["port"]] == [2, 4]


def _assert_payload_close(got, want, atol=1e-4, tilt_atol=1e-4):
    assert got.keys() == want.keys()
    assert got["frames_seen"] == want["frames_seen"]
    assert got["valid"] is want["valid"]
    np.testing.assert_allclose(got["tilt_deg"], want["tilt_deg"],
                               atol=tilt_atol)
    for k in ("plane", "mean_vector_mm", "mean_magnitude_mm"):
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


def _assert_close_but_ties(got, want, what, atol=1e-4):
    """Per-marker arrays (markers on axis 0) within ``atol``, except that up
    to two markers may differ by up to 0.1: the near-tied NCC peaks of the
    module docstring (``tests/test_torch_video.py``'s bound)."""
    d = np.abs(np_(got).astype(np.float64) - np_(want))
    d = d.reshape(d.shape[0] if d.ndim else 1, -1).max(-1)
    assert (d > atol).sum() <= 2 and d.max() <= 0.1, (what, d)


def test_contact_state_payload_matches_jax():
    """The payload of a 15 deg tilted frame, from the port's and the JAX
    package's contact state on the same positions."""
    world = np.zeros((3, 65, 3), np.float32)
    world[1] = np.asarray(tilt_deviation_field(7.0, compression_mm=0.3))
    world[2] = np.asarray(tilt_deviation_field(15.0, compression_mm=0.0))
    seen = np.ones((3, 65), bool)
    seen[1, ::7] = False
    rcfg = ReconstructConfig(warmup_frames=0)
    tstate = t_contact(displacement_scan(torch.from_numpy(world),
                                         torch.from_numpy(seen), rcfg),
                       AnalysisConfig())
    jstate = j_contact(j_scan(world, seen, jcfg.ReconstructConfig(
        warmup_frames=0)), jcfg.AnalysisConfig())
    for i in (1, -1):
        got = tpublish.contact_state_payload(tstate, i, 3)
        want = jpublish.contact_state_payload(jstate, i, 3)
        _assert_payload_close(got, want)
        assert json.loads(json.dumps(got)) == got
    assert abs(got["tilt_deg"] - 15.0) < 1e-2 and got["valid"] is True


def test_state_publisher_poll_events_and_close():
    """``/healthz``, ``/state`` (404 before the first state, long-poll with
    ``?seq=N``, the current state when the poll times out, 400 for a bad
    seq), ``/events`` (the latest state first), and ``close()`` ending an
    open event stream."""
    pub = tpublish.StatePublisher(port=0, poll_timeout_s=0.3)
    base = f"http://127.0.0.1:{pub.port}"
    get = lambda path: urllib.request.urlopen(base + path, timeout=5)
    try:
        assert get("/healthz").read() == b"ok"
        for path, code in (("/state", 404), ("/nothing", 404),
                           ("/state?seq=abc", 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                get(path)
            assert e.value.code == code
        pub.update({"tilt_deg": 14.9, "valid": True})
        assert json.loads(get("/state").read()) == {
            "tilt_deg": 14.9, "valid": True, "seq": 1}
        t = threading.Timer(0.1, pub.update, ({"tilt_deg": 15.2},))
        t.start()
        assert json.loads(get("/state?seq=1").read())["seq"] == 2
        t.join()
        assert json.loads(get("/state?seq=2").read())["seq"] == 2  # timeout
        events = get("/events")
        line = events.readline()
        assert json.loads(line[len(b"data: "):]) == {"tilt_deg": 15.2,
                                                     "seq": 2}
    finally:
        pub.close()
    assert events.read() in (b"", b"\n")   # the stream ends after close()


def test_run_live_resume_matches_jax(stream, tmp_path):
    """``run-live --resume``: frames 0-3 saved to a session, then frames 4-5
    resumed from it. The saved sessions agree (frame count and config
    equal; reference table and association positions within 1e-4, the scan
    carry within 5e-4, but for the near-tied marker), each package loads
    the other's, and the resumed runs print the same lines."""
    out = {}
    for pkg in ("jax", "port"):
        sess = str(tmp_path / pkg)
        first = _run_live(stream, pkg, "--max-frames", "4", "--tpu-decode",
                          "--resume", sess)
        assert f"session saved to {sess}" in first
        out[pkg] = _run_live(stream, pkg, "--tpu-decode", "--resume", sess,
                             query="?start=4").replace(sess, "SESSION")
    _assert_same_lines(out["port"], out["jax"])
    assert "resumed session from SESSION" in out["port"]
    assert "frames 6: tracked" in out["port"]
    got = load_session(str(tmp_path / "jax"), device="cpu")
    want = j_load_session(str(tmp_path / "jax"))
    mine = load_session(str(tmp_path / "port"), device="cpu")
    theirs = j_load_session(str(tmp_path / "port"))
    assert got.frames_seen == want.frames_seen == mine.frames_seen == 6
    assert theirs.frames_seen == 6
    assert mine.config == got.config
    for a, b in ((mine.ref, got.ref), (theirs.ref, want.ref)):
        for f in a._fields:
            if f != "angle":
                _assert_close_but_ties(getattr(a, f), getattr(b, f), f)
        # Orientation is ill-conditioned where the two axes are nearly equal
        # (tests/test_torch_cli.py), and the near-tied marker's window moves:
        # compare it modulo 180 deg within 1e-2 deg on the valid, elongated
        # markers whose positions agree.
        axes = np_(b.axes)
        keep = (np_(b.valid) & (axes[:, 0] - axes[:, 1] > 0.1)
                & (np.abs(np_(a.xy) - np_(b.xy)).max(-1) <= 1e-3))
        assert keep.sum() >= 40
        d_angle = (np_(a.angle) - np_(b.angle) + 90.0) % 180.0 - 90.0
        np.testing.assert_allclose(d_angle[keep], 0.0, atol=1e-2)
    assert mine.scan_carry.keys() == got.scan_carry.keys()
    for k in got.scan_carry:    # cum_path's bound in tests/test_torch_video.py
        _assert_close_but_ties(mine.scan_carry[k], got.scan_carry[k], k,
                               atol=5e-4)
    _assert_close_but_ties(mine.assoc_xy, got.assoc_xy, "assoc_xy")


def test_live_commands_need_the_card_unless_device_cpu(stream, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["record", stream["url"], str(tmp_path / "x.avi")],
                 ["run-live", stream["url"], "--tpu-decode"],
                 ["run-live", stream["url"]]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(argv)
    assert not os.path.exists(tmp_path / "x.avi")
