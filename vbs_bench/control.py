"""The control: the plain reference put in the program's place and run in
TF32, the precision below the configuration's float32 with TF32 off. A
sound comparison has to find it not correct.

    python3 -m vbs_bench.control --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

runs the cell once a seed with the control in the program's place (a short
window at the cell's own load) and prints each run's compared numbers, one
JSON line a seed. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from vbs_bench.loads import replay
from vbs_bench.reference import camera, config
from vbs_bench.reference import pipeline as ref


class ReferenceProgram:
    """The reference with the program's entry points, in TF32 (``tf32``)
    or float32."""

    def __init__(self, device, conf: dict, traffic: dict, seed: int,
                 tf32: bool = True):
        self.device, self.tf32 = device, tf32
        self._video = (conf, traffic, seed)
        self._coeffs = None

    def build(self, ingest: bool) -> None:
        pass

    def config(self, overrides: dict):
        return config._from_jsonable(config.PipelineConfig, overrides)

    def camera(self, numbers: dict):
        return camera.CameraModel.create(**numbers, device=self.device)

    def initialize(self, frame, cfg):
        with ref.precision(self.tf32):
            return ref.initialize(frame, cfg)

    def process_frames(self, frames, r, cam, cfg):
        with ref.precision(self.tf32):
            return ref.process_frames(frames, r, cam, cfg)

    def stream(self, cam, cfg, r):
        """A session whose ``process(frames)`` returns the chunk's frames of
        the reference run over every frame of the session so far."""
        return _Session(self, cam, cfg, r)

    def track_video(self, path: str, chunk: int, out_dir: str) -> None:
        """``markers.csv`` of the recording, from the coefficients that the
        benchmark's encoder wrote for the same seed."""
        conf, traffic, seed = self._video
        if self._coeffs is None:
            self._coeffs = replay.encode_period(conf, traffic, seed,
                                                self.device)[1]
        rows = replay.reference_rows(self._coeffs, conf,
                                     {**traffic, "chunk": chunk},
                                     self.device, tf32=self.tf32)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "markers.csv"), "w") as f:
            f.write("frame,marker_id,ring,col,ref_x,ref_y,x,y,major_axis,"
                    "minor_axis,angle\n")
            for r in rows:
                f.write("%d,%d,%d,%d," % tuple(int(v) for v in r[:4])
                        + ",".join("%.4f" % v for v in r[4:]) + "\n")

    def layer_targets(self) -> list:
        return []


class _Session:
    """``ReferenceProgram.stream``'s session."""

    def __init__(self, program, cam, cfg, r):
        self.program, self.cam, self.cfg, self.ref = program, cam, cfg, r
        self.frames = None

    def process(self, frames):
        self.frames = frames if self.frames is None else torch.cat(
            [self.frames, frames])
        out = self.program.process_frames(self.frames, self.ref, self.cam,
                                          self.cfg)
        cut = _last(out, frames.shape[0])
        return cut._replace(tracked=cut.tracked._replace(
            ref_xy=out.tracked.ref_xy, ring=out.tracked.ring))


def _last(x, n: int):
    """``x`` with every tensor cut to its last ``n`` rows (frames), named
    tuples walked."""
    if isinstance(x, torch.Tensor):
        return x[-n:]
    if isinstance(x, tuple):
        return type(x)(*(_last(v, n) for v in x))
    return x


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
        res = run_cell(workload, seed, seconds, False, device, program=prog,
                       traffic_overrides=traffic_overrides)
        yield seed, res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m vbs_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("vbs_bench.control: no CUDA device", file=sys.stderr)
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
