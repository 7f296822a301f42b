"""Shared harness of the PyTorch-port parity tests (tests/test_torch_*.py).

Not collected (no ``test_`` prefix), like ``tests/oracle.py``. The same
numpy inputs go through a JAX function and its counterpart in
``vision_basedsensor_tpu_torch``; arrays cross as float32 numpy, because
``tests/conftest.py`` turns on JAX x64. JAX is imported by the helpers
that use it, so ``tests/test_torch_cuda.py`` also runs where JAX is not
installed.

The card tests (``cuda_only``) share the fixture :func:`cuda` and the
helpers after it; their files import no JAX, so they run with
``pytest --noconftest -m cuda_only`` where JAX is absent.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest
import torch

# The suite runs under xdist (-n 6); one intra-op thread per worker.
torch.set_num_threads(1)


def f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def to_jax(x):
    import jax.numpy as jnp

    return jnp.asarray(f32(x))


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(f32(x)))


def np_(x) -> np.ndarray:
    """A JAX array or a torch tensor as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def staircase(batch: int, step_mm: float = 0.3) -> np.ndarray:
    """``(batch, 65, 3)`` rigid -Z indentation steps (frame 0 at rest)."""
    d = np.zeros((batch, 65, 3), np.float32)
    d[:, :, 2] = -step_mm * np.arange(batch, dtype=np.float32)[:, None]
    return d


def render_jax(height: int, width: int, displacements: np.ndarray):
    """Frames from the JAX synth (``default_scene(height, width)``) as
    float32 numpy, plus the scene."""
    from vision_basedsensor_tpu.synth import default_scene, render_frames

    scene = default_scene(height, width)
    frames = render_frames(scene, to_jax(displacements))
    return f32(frames), scene


def peaks_pair(rng: np.random.Generator, batch: int, k: int, h: int, w: int,
               border: bool = True):
    """Random integer peak positions ``(batch, k, 2)`` with some pushed onto
    every border, plus a validity mask; returned for both frameworks as
    (jax Peaks, torch Peaks)."""
    import jax.numpy as jnp

    from vision_basedsensor_tpu.ops.peaks import Peaks as JPeaks

    from vision_basedsensor_tpu_torch.ops.peaks import Peaks as TPeaks

    xs = rng.integers(0, w, (batch, k)).astype(np.float32)
    ys = rng.integers(0, h, (batch, k)).astype(np.float32)
    if border:
        xs[:, 0], ys[:, 1] = 0, 0
        xs[:, 2], ys[:, 3] = w - 1, h - 1
        xs[:, 4], ys[:, 4] = w - 1, h - 1
    xy = np.stack([xs, ys], -1)
    valid = rng.random((batch, k)) > 0.2
    score = rng.random((batch, k)).astype(np.float32)
    jp = JPeaks(xy=jnp.asarray(xy), score=jnp.asarray(score),
                valid=jnp.asarray(valid))
    tp = TPeaks(xy=torch.from_numpy(xy), score=torch.from_numpy(score),
                valid=torch.from_numpy(valid))
    return jp, tp


_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


def run_jax_cli(argv, cache_dir) -> str:
    """``vbs argv`` of the JAX package; returns its standard output. Its
    persistent compile cache goes to ``cache_dir`` (``VBS_COMPILE_CACHE``)
    and the cache settings are restored after the call."""
    import jax

    from vision_basedsensor_tpu.cli import main as jcli

    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    out = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("VBS_COMPILE_CACHE", str(cache_dir))
            with contextlib.redirect_stdout(out):
                jcli.main(argv)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return out.getvalue()


def run_port_cli(argv) -> str:
    """``vbs-torch --device cpu argv``; returns its standard output."""
    from vision_basedsensor_tpu_torch.cli import main as tcli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tcli.main(["--device", "cpu", *argv])
    return out.getvalue()


class MjpegServer:
    """Serves ``jpegs`` as an MJPEG stream on localhost. ``/stream?start=K
    &n=M`` sends frames K..K+M-1 (all of them by default) and ends the
    response; the part headers carry Content-Length unless ``length`` is
    False, and the Content-Type names ``boundary`` (the parts are delimited
    by ``--`` + the boundary without its leading dashes, as RFC 2046 has
    it). ``close`` stops it."""

    def __init__(self, jpegs, boundary="frame", length=True):
        delim = b"--" + boundary.lstrip("-").encode()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                q = parse_qs(urlparse(self.path).query)
                start = int(q.get("start", ["0"])[0])
                n = int(q.get("n", [str(len(jpegs))])[0])
                self.send_response(200)
                self.send_header("Content-Type", "multipart/x-mixed-replace; "
                                 f"boundary={boundary}")
                self.end_headers()
                try:
                    for jb in jpegs[start:start + n]:
                        head = delim + b"\r\nContent-Type: image/jpeg\r\n"
                        if length:
                            head += f"Content-Length: {len(jb)}\r\n".encode()
                        self.wfile.write(head + b"\r\n" + jb + b"\r\n")
                    self.wfile.write(delim + b"--\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass        # the client took the frames it wanted

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._srv.server_address[1]}/stream"

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(5.0)


# -- the card tests ----------------------------------------------------------

@pytest.fixture(scope="session")
def cuda():
    """The first card; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def render_drift(dev, height: int, width: int, batch: int,
                 dz_mm: float = -0.002, dist=None):
    """``(scene, frames)``: ``batch`` frames of the port's synthetic dome on
    ``dev`` (camera distortion ``dist``), every marker moved ``dz_mm`` a
    frame along z from frame 0 at rest."""
    from vision_basedsensor_tpu_torch.synth import default_scene, render_frames

    scene = default_scene(height, width, dist=dist, device=dev)
    d = torch.zeros((batch, 65, 3), device=dev)
    d[:, :, 2] = dz_mm * torch.arange(batch, device=dev)[:, None]
    return scene, render_frames(scene, d, chunk=64)


def counted(fn, devices=()):
    """``(fn(), launches)``: every kernel's launch counter set to 0 just
    before the call, and the kernels that launched after it, by name, with
    the card and each of ``devices`` synchronized."""
    from vision_basedsensor_tpu_torch.ops.cuda import (launch_counts,
                                                       reset_launch_counts)

    def sync():
        for d in {torch.device("cuda", torch.cuda.current_device()),
                  *map(torch.device, devices)}:
            torch.cuda.synchronize(d)

    sync()
    reset_launch_counts()
    out = fn()
    sync()
    return out, {k: v for k, v in launch_counts().items() if v}


def run_card_cli(argv):
    """``(stdout, stderr, launches)`` of ``vbs-torch argv`` run in-process
    on the card, with its kernel launches counted alone (:func:`counted`)."""
    from vision_basedsensor_tpu_torch.cli import main as tcli

    out, err = io.StringIO(), io.StringIO()

    def run():
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            tcli.main(argv)

    _, launches = counted(run)
    return out.getvalue(), err.getvalue(), launches


def leaves(x, name="out"):
    """``(name, tensor)`` of every tensor in nested named tuples."""
    if isinstance(x, torch.Tensor):
        yield name, x
    elif isinstance(x, tuple):
        for k, v in zip(x._fields, x):
            yield from leaves(v, f"{name}.{k}")


def assert_same_outputs(got, want):
    """Every tensor of two pipeline outputs equal, bit for bit."""
    for (name, a), (_, b) in zip(leaves(got), leaves(want), strict=True):
        assert torch.equal(a, b), name


def assert_detections_as_sets(a, b, tol_px):
    """Each frame's valid detections of ``a`` and ``b`` as sets: equal
    counts, and each of ``b``'s within ``tol_px`` of one of ``a``'s (equal
    scores may order the slots differently)."""
    assert torch.equal(a.valid.sum(-1), b.valid.sum(-1))
    # The exact distances: cdist's matmul form loses ~0.1 px to
    # cancellation at coordinates of a few hundred.
    d = torch.cdist(b.xy, a.xy, compute_mode="donot_use_mm_for_euclid_dist")
    d = torch.where(a.valid[:, None, :], d, torch.full_like(d, 1e9))
    near = d.min(-1).values[b.valid]
    assert near.numel() == 0 or float(near.max()) <= tol_px


def assert_recon_close(out, base):
    """The reference's sharded-vs-single tolerances
    (``tests/test_parallel.py``): ``seen`` equal, ``world`` and
    ``cum_path`` within 1e-4."""
    assert torch.equal(out.recon.seen, base.recon.seen)
    for name in ("world", "cum_path"):
        a, b = getattr(out.recon, name), getattr(base.recon, name)
        assert float((a - b).abs().max()) <= 1e-4, name


def render_jpegs(dev, batch: int, dz_mm: float = -0.002, quality: int = 70):
    """``(scene, jpegs)``: :func:`render_drift`'s 640x480 frames as uint8
    (truncated, as ``bench.py`` does) encoded by the port's JPEG encoder at
    ``quality`` (the sensor's q70)."""
    from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg

    scene, frames = render_drift(dev, 480, 640, batch, dz_mm)
    u8 = frames.to(torch.uint8).cpu().numpy()
    return scene, [encode_jpeg(f, quality) for f in u8]


def write_avi(path, jpegs, fps: float = 12.0, size=(640, 480)) -> str:
    """``jpegs`` muxed into an MJPEG ``.avi`` at ``path``."""
    from vision_basedsensor_tpu_torch.io.video import MjpegAviWriter

    wr = MjpegAviWriter(str(path), fps, size)
    for j in jpegs:
        wr.write_jpeg(j)
    wr.close()
    return str(path)


def spy_on_run_live(mp):
    """Record every chunk ``StreamingPipeline.process`` returns, every state
    ``StatePublisher.update`` publishes and the ``/state`` served right after
    it: ``(chunks, payloads, served)``."""
    import json
    import urllib.request

    from vision_basedsensor_tpu_torch.io import publish
    from vision_basedsensor_tpu_torch.pipeline import StreamingPipeline

    chunks, payloads, served = [], [], []
    process = StreamingPipeline.process
    update = publish.StatePublisher.update

    def process_spy(self, frames):
        out = process(self, frames)
        chunks.append(out)
        return out

    def update_spy(self, state):
        update(self, state)
        payloads.append(state)
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/state",
                                    timeout=30) as r:
            served.append(json.loads(r.read()))

    mp.setattr(StreamingPipeline, "process", process_spy)
    mp.setattr(publish.StatePublisher, "update", update_spy)
    return chunks, payloads, served


# -- the main path on the card -----------------------------------------------

# The smallest batch at which cuBLAS sums the filter GEMMs unsplit, as the
# stencil kernels do (measured on the H100): frames of up to 480 rows, and
# taller. Below it the GEMM path's NCC differs in its last bits (up to
# 5.9e-6 at 4 x 480x640), so the GEMM path runs on the frames repeated.
UNSPLIT_BATCH = (512, 2)


def _unsplit(fn, low_res_max_rows):
    """``fn``, a filter function's plain version, on its frames repeated to
    UNSPLIT_BATCH: the first B outputs, the bits the stencil kernels
    give."""
    def run(x, *args):
        b = x.shape[0]
        reps = -(-UNSPLIT_BATCH[int(x.shape[1] > low_res_max_rows)] // b)
        out = fn(x.repeat(reps, *(1,) * (x.ndim - 1)), *args)
        return tuple(t[:b] for t in out)
    return run


@contextlib.contextmanager
def plain_kernels(cfg):
    """Route the detector's filters, fields, gathers and window sums and the
    two scans through the kernels' plain versions."""
    from vision_basedsensor_tpu_torch.config import ReconstructConfig
    from vision_basedsensor_tpu_torch.detect import detector
    from vision_basedsensor_tpu_torch.ops import moments as tm
    from vision_basedsensor_tpu_torch.ops.cuda import fields as kf
    from vision_basedsensor_tpu_torch.ops.cuda import filters as kfil
    from vision_basedsensor_tpu_torch.ops.cuda import moments as kg
    from vision_basedsensor_tpu_torch.ops.cuda import scan as kscan
    from vision_basedsensor_tpu_torch.reconstruct.displacement import \
        displacement_scan_reference
    from vision_basedsensor_tpu_torch.track.associate import \
        associate_sequential_reference

    def gather(pack):
        def run(packed, peaks, geom, prof):
            start = kg._prep(packed.shape[1], packed.shape[2], peaks, prof)
            return (kg.gather_windows_reference(packed, start,
                                                prof.patch_size, pack), start)
        return run

    def scan(world, seen, max_step, carry):
        rcfg = ReconstructConfig(max_step_displacement_mm=max_step)
        recon, final = displacement_scan_reference(world, seen, rcfg, carry,
                                                   True)
        return tuple(recon)[2:], final

    def assoc(ref, det, gate, carry_xy):
        t, last = associate_sequential_reference(ref, det, gate, carry_xy,
                                                 True)
        return (t.xy, t.axes, t.angle, t.valid), last

    hooks = {(detector, "filter_fields"): _unsplit(
                 kfil.filter_fields_reference, cfg.detect.low_res_max_rows),
             (detector, "fused_fields"): kf.fused_fields_reference,
             (detector, "gather_windows_paired"): gather(2),
             (detector, "gather_windows"): gather(1),
             (detector, "window_sums"): tm.window_sums_xla,
             (kscan, "displacement_scan"): scan,
             (kscan, "associate_sequential"): assoc}
    with pytest.MonkeyPatch.context() as mp:
        for (module, name), fn in hooks.items():
            mp.setattr(module, name, fn)
        yield


def assert_dets_close(a, b):
    """The reference's xla-vs-pallas detection tolerances
    (tests/test_pallas_moments.py:104-114)."""
    assert torch.equal(a.valid, b.valid)
    v = a.valid
    assert float((a.xy - b.xy)[v].abs().max()) <= 1e-3
    assert float((a.axes - b.axes)[v].abs().max()) <= 1e-2


def _main_config(k, backend="auto"):
    from vision_basedsensor_tpu_torch.config import (PipelineConfig,
                                                     ReconstructConfig)

    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))
    return dataclasses.replace(cfg, detect=dataclasses.replace(
        cfg.detect, max_candidates=k, backend=backend))


def check_main_path(dev, height: int, width: int, batch: int, k: int = 96,
                    backend: str = "auto", dz_mm: float = -0.002) -> dict:
    """``process_frames`` on ``batch`` frames of :func:`render_drift` (a
    drift of ``dz_mm`` a frame along z) with ``k`` candidates on the
    detector branch ``backend`` ("xla" the unfused one), held to what the
    main path owes: exactly its branch's kernels, once each (the two filter
    stencils and one scan), counted from zero just before the call; 65 of
    65 markers in every frame; finite tilt and positions; the drift
    recovered (at up to ``low_res_max_rows`` rows within 0.05 mm + 10%;
    taller, the reference recovers about a third of it, so only its sign);
    the kernels' plain versions (:func:`plain_kernels`) give the same
    detections and tilt (the fused branch), or the reference's
    xla-vs-pallas tolerances (the unfused one, which is also held to them
    against the fused branch on the same frames). Returns the launches."""
    from vision_basedsensor_tpu_torch.pipeline import (initialize,
                                                       process_frames)

    cfg = _main_config(k, backend)
    scene, frames = render_drift(dev, height, width, batch, dz_mm)
    ref = initialize(frames[0], cfg)
    out, launches = counted(lambda: process_frames(frames, ref, scene.cam,
                                                   cfg))
    fused = backend != "xla"
    assert launches == ({"fields": 1, "gather": 1} if fused
                        else {"window_sums": 1}) | {"filters": 2, "scan": 1}, \
        launches
    assert int(ref.valid.sum()) == 65
    assert int(out.tracked.valid.sum(-1).min()) == 65
    for x in (out.contact.tilt_deg, out.recon.world, out.recon.from_first):
        assert bool(torch.isfinite(x).all())
    dz = float(out.recon.from_first[-1, :, 2].mean())
    want = dz_mm * (batch - 1)
    if height <= cfg.detect.low_res_max_rows:
        assert abs(dz - want) <= 0.05 + 0.1 * abs(want), dz
    else:
        assert dz < 0.0, dz

    with plain_kernels(cfg):
        plain = process_frames(frames, initialize(frames[0], cfg), scene.cam,
                               cfg)
    if fused:
        assert_same_outputs(out.detections, plain.detections)
        assert torch.equal(out.contact.tilt_deg, plain.contact.tilt_deg)
    else:
        assert_dets_close(out.detections, plain.detections)
        fcfg = _main_config(k)
        fused_out = process_frames(frames, initialize(frames[0], fcfg),
                                   scene.cam, fcfg)
        assert_dets_close(out.detections, fused_out.detections)
    return launches
