"""Closed loop of streaming sessions, as a caller of the port's streaming
API processes a recording too long for one batch: one seeded recording of
``frames`` frames, rendered once on the device, fed to a session of the
program (``Program.stream``: the port's ``StreamingPipeline``) in
``chunk``-frame chunks in order (``StreamingPipeline.run``'s default chunk
is 64), then to a new session, back to back. After each chunk the host reads
back each frame's ``seen`` markers and ``from_first_norm``, the contact tilt
and whether it is valid: that read-back is the chunk's device wait. A unit
is one session; the window ends at a chunk's end. ``frames`` is a whole
number of chunks."""
from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from vbs_bench import check
from vbs_bench.loads.common import Phases, keep, reference_setup
from vbs_bench.gen.scene import camera_numbers, render_uint8
from vbs_bench.reference import pipeline as ref
from vbs_bench.stats import window_rate

# The frame-0 table's fields of ``common.keep``: one a session, not a frame.
TABLE = ("ref_xy", "ring")


def _map(parts: list, fn) -> SimpleNamespace:
    """A ``common.keep`` tree whose every field is ``fn(name, values)``,
    ``values`` that field of each of ``parts``."""
    return SimpleNamespace(**{
        g: SimpleNamespace(**{
            f: fn(f, [getattr(getattr(p, g), f) for p in parts])
            for f in vars(getattr(parts[0], g))})
        for g in vars(parts[0])})


def _cat(parts: list) -> SimpleNamespace:
    """Kept chunks as one batch: every field concatenated along its first
    axis (the frame-0 table once a chunk)."""
    return _map(parts, lambda _, xs: torch.cat(xs))


class Load:
    metric = "stream_fps"

    def __init__(self, program, conf: dict, traffic: dict, seed: int, device):
        self.program, self.conf, self.device = program, conf, device
        h, w = conf["height"], conf["width"]
        n, self.chunk = traffic["frames"], traffic["chunk"]
        if n % self.chunk:
            raise ValueError(f"{n} frames are not a whole number of "
                             f"{self.chunk}-frame chunks")
        self.starts = range(0, n, self.chunk)
        clock = Phases(device)
        self.frames = render_uint8(h, w, n, seed, traffic["motion"], device)
        clock.lap("render")
        self.cfg = program.config(conf["pipeline"])
        self.cam = program.camera(camera_numbers(h, w))
        self.ref = program.initialize(self.frames[0], self.cfg)
        clock.lap("initialize")
        # The program captures a shape's graphs on its second call: one
        # session of equal chunks makes it before the window.
        self.sessions, self.stats = [], []
        self.run(1)
        self.sessions.clear()
        clock.lap("warm session")
        self.phases = clock.laps

    def session(self):
        """One session, chunk by chunk: yields each chunk's frame count once
        its read-back is on the host."""
        sp = self.program.stream(self.cam, self.cfg, self.ref)
        kept = []
        self.sessions.append(kept)
        for s in self.starts:
            out = sp.process(self.frames[s:s + self.chunk])
            for x in (out.recon.seen, out.recon.from_first_norm,
                      out.contact.tilt_deg, out.contact.valid):
                x.cpu()
            kept.append(keep(out))
            yield out.recon.seen.shape[0]

    def run(self, units: int) -> None:
        for _ in range(units):
            for _ in self.session():
                pass

    def window(self, seconds: float) -> dict:
        done, t0 = 0, time.perf_counter()
        while True:
            for n in self.session():
                done += n
                t1 = time.perf_counter()
                if t1 - t0 >= seconds:
                    return {self.metric: window_rate(done, t0, t1)}

    @property
    def attempted(self) -> int:
        return len(self.sessions)

    def release(self) -> None:
        self.ref = self.cam = None

    def check(self) -> dict:
        """Every session's chunks, joined along frames, against one
        reference run over the whole recording (a session cut by the
        window's end against as many of its chunks)."""
        cfg, cam = reference_setup(self.conf, self.device)
        with ref.precision(tf32=False):
            r = ref.initialize(self.frames[0], cfg)
            want = keep(ref.process_frames(self.frames, r, cam, cfg,
                                           self.stats))
        chunks = [_map([want], lambda f, xs, s=s: xs[0] if f in TABLE
                       else xs[0][s:s + self.chunk]) for s in self.starts]
        return check.worst(
            check.pipeline_numbers(_cat(kept), _cat(chunks[:len(kept)]))
            for kept in self.sessions)
