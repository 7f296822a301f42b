"""What the loads share: the device's wait, the outputs kept for the
check, and the reference's configuration and camera."""
from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from vbs_bench.gen.scene import default_scene
from vbs_bench.reference import config as ref_config


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Phases:
    """Seconds of each set-up phase (the device's work included)."""

    def __init__(self, device):
        self.device, self.laps = device, {}
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


def keep(out) -> SimpleNamespace:
    """The fields of a ``process_frames`` result that the check compares,
    and no more (each is its own tensor, so the rest is freed)."""
    d, t, r, c = out.detections, out.tracked, out.recon, out.contact
    ns = SimpleNamespace
    return ns(detections=ns(xy=d.xy, valid=d.valid),
              tracked=ns(xy=t.xy, ref_xy=t.ref_xy, axes=t.axes, ring=t.ring,
                         valid=t.valid),
              recon=ns(world=r.world, seen=r.seen, from_first=r.from_first),
              contact=ns(tilt_deg=c.tilt_deg, valid=c.valid))


def reference_setup(conf: dict, device):
    """The reference's configuration and camera for configuration ``conf``
    (the same numbers the program is given)."""
    cfg = ref_config._from_jsonable(ref_config.PipelineConfig,
                                    conf["pipeline"])
    return cfg, default_scene(conf["height"], conf["width"], device).cam
