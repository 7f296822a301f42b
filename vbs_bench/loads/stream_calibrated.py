"""Closed loop of streaming sessions of a calibrated camera, as the port's
``indent`` and ``track --undistort`` commands stream a recording: one
seeded recording of ``frames`` frames, filmed through the configuration's
lens (``dist``) and rendered once on the device, fed to a new session of
the program (``Program.stream`` with no frame-0 table) in ``chunk``-frame
chunks, each read back, then to a new session, back to back. Each session
is a new recording: on its first chunk it builds its rectify map and
rectified pinhole, and initializes its frame-0 table on the rectified frame
0; every frame is rectified before detection, and association follows each
marker's last sighting across chunks (the configuration's ``pipeline``).
The check joins each session's chunks against one run of
``reference/pipeline_calibrated.py`` over the whole recording, and holds
that run's frame-0 table to the scene (``scene_px``), so that a recording
not filmed through the lens, or a reference that rectifies through another
lens, is found too."""
from __future__ import annotations

import numpy as np
import torch

from vbs_bench import check
from vbs_bench.gen.scene import (camera_numbers, default_scene, motion,
                                 render_frames)
from vbs_bench.loads import stream
from vbs_bench.loads.common import Phases, keep
from vbs_bench.reference import camera as ref_camera
from vbs_bench.reference.camera import project_points
from vbs_bench.reference import config as ref_config
from vbs_bench.reference import pipeline_calibrated as ref


def lens_numbers(conf: dict) -> dict:
    """The scene camera's numbers with the configuration's lens."""
    return {**camera_numbers(conf["height"], conf["width"]),
            "dist": np.asarray(conf["dist"], np.float64)}


def render_through_lens(conf: dict, frames: int, seed: int, params: dict,
                        device) -> torch.Tensor:
    """The seeded sequence ``(frames, H, W)`` as uint8, each marker
    projected through the lens camera."""
    h, w = conf["height"], conf["width"]
    cam = ref_camera.CameraModel.create(**lens_numbers(conf), device=device)
    scene = default_scene(h, w, device)._replace(cam=cam)
    img = render_frames(scene, motion(frames, seed, params, device))
    return img.to(torch.uint8)


def scene_gap(table, cam, world: torch.Tensor) -> float:
    """The largest distance from a marker of the frame-0 ``table`` to the
    nearest of the scene's rest markers ``world`` projected through the
    rectified pinhole ``cam`` (``check.MISMATCH`` for an empty table)."""
    xy = table.xy[table.valid]
    if xy.shape[0] == 0:
        return check.MISMATCH
    d = torch.cdist(xy.double(), project_points(cam, world).double())
    return float(d.amin(1).max())


class Load(stream.Load):

    def __init__(self, program, conf: dict, traffic: dict, seed: int, device):
        self.program, self.conf, self.device = program, conf, device
        n, self.chunk = traffic["frames"], traffic["chunk"]
        if n % self.chunk:
            raise ValueError(f"{n} frames are not a whole number of "
                             f"{self.chunk}-frame chunks")
        self.starts = range(0, n, self.chunk)
        clock = Phases(device)
        self.frames = render_through_lens(conf, n, seed, traffic["motion"],
                                          device)
        clock.lap("render")
        self.cfg = program.config(conf["pipeline"])
        self.cam = program.camera(lens_numbers(conf))
        # No table: each session initializes itself on its first chunk.
        self.ref = None
        # A signature captures its graphs on its second call, and a
        # session's one-frame initialize runs once a session: two whole
        # sessions before the window.
        self.sessions, self.stats = [], []
        self.run(2)
        self.sessions.clear()
        clock.lap("warm sessions")
        self.phases = clock.laps

    def check(self) -> dict:
        """Every session's chunks, joined along frames, against one
        reference run over the whole recording (a session cut by the
        window's end against as many of its chunks)."""
        h, w = self.conf["height"], self.conf["width"]
        cfg = ref_config._from_jsonable(ref_config.PipelineConfig,
                                        self.conf["pipeline"])
        cam = ref_camera.CameraModel.create(**lens_numbers(self.conf),
                                            device=self.device)
        with ref.precision(tf32=False):
            src_map, rect_cam = ref.prepare(cam, h, w)
            r = ref.initialize(self.frames[0], cfg, src_map)
            want = keep(ref.process_frames(self.frames, r, rect_cam, cfg,
                                           src_map, self.stats))
        chunks = [stream._map([want], lambda f, xs, s=s: xs[0]
                              if f in stream.TABLE
                              else xs[0][s:s + self.chunk])
                  for s in self.starts]
        numbers = check.worst(
            check.pipeline_numbers(stream._cat(kept),
                                   stream._cat(chunks[:len(kept)]))
            for kept in self.sessions)
        world = default_scene(h, w, self.device).marker_world
        return {**numbers, "scene_px": scene_gap(r, rect_cam, world)}
