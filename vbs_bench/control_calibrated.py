"""The control (``control.py``) of a calibrated-camera streaming cell: the
reference pipeline that rectifies every frame and associates sequentially
(``reference/pipeline_calibrated.py``) in the program's place, in TF32.

    python3 -m vbs_bench.control_calibrated --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

prints each run's compared numbers, one JSON line a seed, as
``vbs_bench.control`` does.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from vbs_bench import control
from vbs_bench.reference import pipeline_calibrated as ref


class ReferenceProgram(control.ReferenceProgram):
    """``control.ReferenceProgram`` whose sessions rectify and associate
    sequentially."""

    def stream(self, cam, cfg, r):
        return _Session(self, cam, cfg, r)


class _Session:
    """A session that, on its first chunk, builds its rectify map and
    initializes on the rectified frame 0 (unless given a table), and whose
    ``process(frames)`` returns the chunk's frames of the reference run
    over every frame of the session so far."""

    def __init__(self, program, cam, cfg, r):
        self.program, self.cam, self.cfg, self.ref = program, cam, cfg, r
        self.frames = self.src_map = self.rect_cam = None

    def process(self, frames):
        tf32 = self.program.tf32
        with ref.precision(tf32):
            if self.src_map is None:
                h, w = frames.shape[-2:]
                self.src_map, self.rect_cam = ref.prepare(self.cam, h, w)
            if self.ref is None:
                self.ref = ref.initialize(frames[0], self.cfg, self.src_map)
            self.frames = frames if self.frames is None else torch.cat(
                [self.frames, frames])
            out = ref.process_frames(self.frames, self.ref, self.rect_cam,
                                     self.cfg, self.src_map)
        cut = control._last(out, frames.shape[0])
        return cut._replace(tracked=cut.tracked._replace(
            ref_xy=out.tracked.ref_xy, ring=out.tracked.ring))


def readings(workload: str, seeds, seconds: float, device,
             tf32: bool = True, traffic_overrides: dict | None = None):
    """Each seed's compared numbers with the reference in the program's
    place."""
    from vbs_bench import manifest
    from vbs_bench.run import run_cell
    m = manifest.load()
    cell = manifest.cell(m, workload)
    conf = manifest.config(m, cell)
    traffic = {**manifest.traffic(cell), **(traffic_overrides or {})}
    for seed in seeds:
        prog = ReferenceProgram(device, conf, traffic, seed, tf32)
        yield seed, run_cell(workload, seed, seconds, False, device,
                             program=prog,
                             traffic_overrides=traffic_overrides)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m vbs_bench.control_calibrated")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("vbs_bench.control_calibrated: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed, res in readings(args.workload, args.seeds, args.seconds,
                              device):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
