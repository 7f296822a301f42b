"""The replay user's command, back to back: ``vbs-torch track <avi>
--tpu-decode --chunk <chunk>`` on a recorded MJPEG ``.avi``, to
``markers.csv``. The recording is ``periods`` repeats of a seeded
``period``-frame sequence, each frame a gray JPEG at the configuration's
quality, muxed as the sensor's recorder stores its stream (the reference's
decode-fed benchmark, ``bench.py:122-159,250-261``); the benchmark's
frozen encoder and muxer write it during set-up."""
from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from vbs_bench import check
from vbs_bench.loads.common import Phases, reference_setup
from vbs_bench.gen import jpeg
from vbs_bench.gen.scene import render_uint8
from vbs_bench.reference import jpeg as ref_jpeg
from vbs_bench.reference import layout
from vbs_bench.reference import pipeline as ref
from vbs_bench.stats import window_rate

COLUMNS = 11   # frame, marker_id, ring, col, ref_x, ref_y, x, y, major, minor, angle


def encode_period(conf: dict, traffic: dict, seed: int, device):
    """The seeded period's JPEG payloads and quantized coefficients
    ``(period, blocks, 64)`` int16."""
    frames = render_uint8(conf["height"], conf["width"], traffic["period"],
                          seed, traffic["motion"], device).cpu().numpy()
    pairs = [jpeg.encode_jpeg(f, conf["jpeg_quality"]) for f in frames]
    return [p for p, _ in pairs], np.stack([c for _, c in pairs])


def write_avi(path: str, payloads: list, conf: dict, periods: int) -> None:
    writer = jpeg.MjpegAviWriter(path, float(conf["fps"]),
                                 (conf["width"], conf["height"]))
    for _ in range(periods):
        for p in payloads:
            writer.write_jpeg(p)
    writer.close()


def reference_rows(coeffs: np.ndarray, conf: dict, traffic: dict, device,
                   tf32: bool = False) -> np.ndarray:
    """The rows of ``markers.csv`` that the reference gives for the
    recording: decoded from the coefficients and tracked in the command's
    chunks, each value as the table writer formats it."""
    cfg, _ = reference_setup(conf, device)
    h, w = conf["height"], conf["width"]
    period, chunk = traffic["period"], traffic["chunk"]
    total = period * traffic["periods"]
    q = jpeg.quant_table(conf["jpeg_quality"])
    bases = layout._ring_base_ids()
    memo, rows, r = {}, [], None
    with ref.precision(tf32):
        for start in range(0, total, chunk):
            n = min(chunk, total - start)
            key = (start % period, n)
            if key not in memo:
                idx = (start + np.arange(n)) % period
                frames = ref_jpeg.decode(
                    torch.as_tensor(coeffs[idx], device=device), q, h, w)
                if r is None:
                    r = ref.initialize(frames[0], cfg)
                memo[key] = ref.track(frames, r, cfg)[1]
            t = memo[key]
            valid = t.valid.cpu().numpy()
            fr, m = np.nonzero(valid)
            ring = t.ring.cpu().numpy()[m]
            vals = np.column_stack([
                t.ref_xy.cpu().numpy()[m], t.xy.cpu().numpy()[fr, m],
                t.axes.cpu().numpy()[fr, m], t.angle.cpu().numpy()[fr, m]])
            text = np.char.mod("%.4f", vals).astype(np.float64)
            rows.append(np.column_stack([start + fr, m + 1, ring,
                                         m + 1 - bases[ring], text]))
    return np.concatenate(rows)


def csv_numbers(path: str, want: np.ndarray) -> dict:
    """A ``markers.csv`` against the reference's rows: the largest gap of
    the positions (x, y and the frame-0 ref_x, ref_y), of the axes and of
    the angle (modulo 180 degrees); every number reads ``MISMATCH`` where
    the rows (frame, marker, ring, column) differ."""
    got = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    if got.shape != want.shape or not np.array_equal(got[:, :4], want[:, :4]):
        return dict.fromkeys(("csv_xy_px", "csv_axes_px", "csv_angle_deg"),
                             check.MISMATCH)
    gap = lambda d: float(d.max(initial=0.0))
    d = np.abs(got[:, 4:] - want[:, 4:])
    # An ellipse's angle lies in [0, 180): 0.01 and 179.99 are 0.02 apart.
    angle = np.minimum(d[:, 6], 180.0 - d[:, 6])
    return {"csv_xy_px": gap(d[:, :4]), "csv_axes_px": gap(d[:, 4:6]),
            "csv_angle_deg": gap(angle)}


class Load:
    metric = "replay_fps"

    def __init__(self, program, conf: dict, traffic: dict, seed: int, device):
        self.program, self.conf, self.traffic = program, conf, traffic
        self.device = device
        clock = Phases(device)
        self.payloads, self.coeffs = encode_period(conf, traffic, seed,
                                                   device)
        clock.lap("render and encode")
        self.dir = tempfile.mkdtemp(prefix="vbs_bench_replay_")
        self.avi = os.path.join(self.dir, "recording.avi")
        write_avi(self.avi, self.payloads, conf, traffic["periods"])
        clock.lap("mux")
        self.frames = traffic["period"] * traffic["periods"]
        self.kept, self.stats = [], []
        self.command(os.path.join(self.dir, "warm"))     # every chunk shape
        self.kept.clear()
        clock.lap("warm command")
        self.phases = clock.laps

    def command(self, out_dir: str) -> None:
        self.program.track_video(self.avi, self.traffic["chunk"], out_dir)
        self.kept.append(os.path.join(out_dir, "markers.csv"))

    def run(self, units: int) -> None:
        for _ in range(units):
            self.command(os.path.join(self.dir, f"cmd{len(self.kept)}"))

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while True:
            self.command(os.path.join(self.dir, f"cmd{len(self.kept)}"))
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                break
        return {self.metric: window_rate(len(self.kept) * self.frames, t0,
                                         t1)}

    @property
    def attempted(self) -> int:
        return len(self.kept)

    def release(self) -> None:
        pass

    def check(self) -> dict:
        """Every command's table against the reference's rows (tables with
        the same bytes are read once)."""
        want = reference_rows(self.coeffs, self.conf, self.traffic,
                              self.device)
        readings, seen = [], set()
        for path in self.kept:
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest not in seen:
                seen.add(digest)
                readings.append(csv_numbers(path, want))
        return check.worst(readings)

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
