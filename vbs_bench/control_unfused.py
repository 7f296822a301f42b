"""The control (``control.py``) of a cell whose detection takes the unfused
branch: the reference pipeline that holds that branch
(``reference/pipeline_unfused.py``) in the program's place, in TF32.

    python3 -m vbs_bench.control_unfused --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

prints each run's compared numbers, one JSON line a seed, as
``vbs_bench.control`` does.
"""
from __future__ import annotations

import argparse
import json
import sys

from vbs_bench import control
from vbs_bench.reference import pipeline_unfused as ref


class ReferenceProgram(control.ReferenceProgram):
    """``control.ReferenceProgram`` with detection on either branch."""

    def initialize(self, frame, cfg):
        with ref.precision(self.tf32):
            return ref.initialize(frame, cfg)

    def process_frames(self, frames, r, cam, cfg):
        with ref.precision(self.tf32):
            return ref.process_frames(frames, r, cam, cfg)


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
    p = argparse.ArgumentParser(prog="python3 -m vbs_bench.control_unfused")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("vbs_bench.control_unfused: no CUDA device", file=sys.stderr)
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
