"""Shared harness of the PyTorch-port parity tests (tests/test_torch_*.py).

Not collected (no ``test_`` prefix), like ``tests/oracle.py``. The same
numpy inputs go through a JAX function and its counterpart in
``vision_basedsensor_tpu_torch``; arrays cross as float32 numpy, because
``tests/conftest.py`` turns on JAX x64. JAX is imported by the helpers
that use it, so ``tests/test_torch_cuda.py`` also runs where JAX is not
installed.
"""
from __future__ import annotations

import contextlib
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
