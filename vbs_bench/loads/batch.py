"""Closed loop of batches: one seeded recording of ``batch`` frames,
rendered once on the device, through ``process_frames`` back to back, as
an engineer processes recorded frames offline. Each batch ends with the
device's wait, and the window ends at a batch's end."""
from __future__ import annotations

import time

from vbs_bench import check
from vbs_bench.loads.common import Phases, keep, reference_setup, sync
from vbs_bench.gen.scene import camera_numbers, render_uint8
from vbs_bench.reference import pipeline as ref
from vbs_bench.stats import window_rate


class Load:
    metric = "batch_fps"

    def __init__(self, program, conf: dict, traffic: dict, seed: int, device):
        self.program, self.conf, self.device = program, conf, device
        h, w = conf["height"], conf["width"]
        clock = Phases(device)
        self.frames = render_uint8(h, w, traffic["batch"], seed,
                                   traffic["motion"], device)
        clock.lap("render")
        self.cfg = program.config(conf["pipeline"])
        self.cam = program.camera(camera_numbers(h, w))
        self.ref = program.initialize(self.frames[0], self.cfg)
        clock.lap("initialize")
        # The cell's one shape, warmed up.
        program.process_frames(self.frames, self.ref, self.cam, self.cfg)
        clock.lap("warm batch")
        self.phases = clock.laps
        self.kept, self.stats = [], []

    def step(self) -> None:
        out = self.program.process_frames(self.frames, self.ref, self.cam,
                                          self.cfg)
        sync(self.device)
        self.kept.append(keep(out))

    def run(self, units: int) -> None:
        for _ in range(units):
            self.step()

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while True:
            self.step()
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                break
        done = len(self.kept) * self.frames.shape[0]
        return {self.metric: window_rate(done, t0, t1)}

    @property
    def attempted(self) -> int:
        return len(self.kept)

    def release(self) -> None:
        self.ref = self.cam = None

    def check(self) -> dict:
        """Every batch's outputs against one reference run over the same
        frames (every batch is the same recording)."""
        cfg, cam = reference_setup(self.conf, self.device)
        with ref.precision(tf32=False):
            r = ref.initialize(self.frames[0], cfg)
            want = ref.process_frames(self.frames, r, cam, cfg, self.stats)
        return check.worst(check.pipeline_numbers(got, want)
                           for got in self.kept)
