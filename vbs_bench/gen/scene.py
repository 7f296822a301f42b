"""The synthetic 65-marker dome, rendered on the device, and the seeded
motion that the benchmark's cells film.

``default_scene`` and ``render_frames`` are a frozen copy of the port's
``synth/render.py``: each marker ball is projected through the pinhole
camera, becomes an image-plane ellipse from the projection Jacobian and is
rasterized with ~1 px anti-aliased edges. ``motion`` draws a sequence's
displacement field from a seed: the z drift of the reference's flagship
benchmark (``bench.py:94``, -0.002 mm a frame) plus a contact-plane tilt
that grows linearly to a seeded angle about a seeded axis.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vbs_bench.reference import camera as cam_mod
from vbs_bench.reference import layout


class DomeScene(NamedTuple):
    cam: cam_mod.CameraModel
    marker_world: torch.Tensor  # (65, 3) rest positions, mm
    marker_radius_mm: float
    background: float           # gray level of the bonnet surface
    marker_level: float         # gray level inside markers
    height: int
    width: int


def camera_numbers(height: int, width: int) -> dict:
    """The scene camera's intrinsics and extrinsics, plain numbers: under
    the dome apex looking up (+Z); the distance scales with the width up
    to 640 px so markers stay ~20 px across at 640x480."""
    f = 0.625 * width
    camera_z_mm = -40.0 * min(width / 640.0, 1.0)
    return dict(fx=f, fy=f, cx=width / 2, cy=height / 2, dist=np.zeros(5),
                R_wc=np.eye(3), T_wc=np.array([0.0, 0.0, -camera_z_mm]))


def default_scene(height: int, width: int, device) -> DomeScene:
    cam = cam_mod.CameraModel.create(**camera_numbers(height, width),
                                     device=device)
    table = layout.dome_layout()
    return DomeScene(
        cam=cam,
        marker_world=torch.as_tensor(table[:, 1:], dtype=torch.float32,
                                     device=device),
        marker_radius_mm=layout.MARKER_DIAMETER_MM / 2,
        background=190.0, marker_level=40.0, height=height, width=width)


def render_frames(scene: DomeScene, displacements: torch.Tensor,
                  chunk: int = 64) -> torch.Tensor:
    """Float frames ``(B, H, W)`` in 0..255 for per-marker world
    displacements ``(B, 65, 3)`` (mm), ``chunk`` frames at a time."""
    dev = displacements.device
    n = scene.marker_world.shape[0]
    cam = scene.cam
    pos = scene.marker_world[None] + displacements              # (B, 65, 3)
    uv = cam_mod.project_points(cam, pos)                       # (B, 65, 2)
    J = cam_mod.projection_jacobian(cam, pos)                   # (B, 65, 2, 3)
    # Image of the marker ball: ellipse with shape matrix M = (r^2 J J^T)^-1.
    JJt = torch.einsum("...ij,...kj->...ik", J, J) * scene.marker_radius_mm ** 2
    eye = torch.eye(2, dtype=JJt.dtype, device=dev)
    Minv = torch.linalg.inv(JJt + 1e-9 * eye)                   # (B, 65, 2, 2)
    r_px = torch.sqrt(torch.sqrt(torch.linalg.det(JJt)))        # (B, 65)

    ys = torch.arange(scene.height, dtype=torch.float32, device=dev)
    xs = torch.arange(scene.width, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")              # (H, W)
    out = []
    for s in range(0, pos.shape[0], chunk):
        u, M, r = uv[s:s + chunk], Minv[s:s + chunk], r_px[s:s + chunk]
        cover = torch.zeros((u.shape[0],) + gx.shape, device=dev)
        for i in range(n):       # one (chunk, H, W) buffer, not (65, H, W)
            d0 = gx - u[:, i, 0, None, None]
            d1 = gy - u[:, i, 1, None, None]
            m = (M[:, i, 0, 0, None, None] * d0 * d0
                 + 2.0 * M[:, i, 0, 1, None, None] * d0 * d1
                 + M[:, i, 1, 1, None, None] * d1 * d1)
            sd = (torch.sqrt(torch.clamp(m, min=1e-12)) - 1.0) * r[:, i, None, None]
            cover = cover + torch.clamp(0.5 - sd, 0.0, 1.0)
        cover = torch.clamp(cover, 0.0, 1.0)
        img = scene.background + cover * (scene.marker_level - scene.background)
        out.append(torch.clamp(torch.floor(img + 0.5), 0.0, 255.0))
    return torch.cat(out)


def motion(frames: int, seed: int, params: dict, device) -> torch.Tensor:
    """World displacements ``(frames, 65, 3)`` mm: every marker sinks by
    ``drift_z_mm_per_frame`` a frame, and the contact plane tilts linearly
    from 0 to a tilt drawn from ``tilt_deg`` ([low, high]) about an axis at
    a uniform angle, both drawn from ``seed``. Every seed gives the same
    sizes; only the angles differ."""
    rng = np.random.default_rng(seed)
    lo, hi = params["tilt_deg"]
    tilt = math.radians(rng.uniform(lo, hi))
    axis = rng.uniform(0.0, 2.0 * math.pi)
    table = layout.dome_layout()
    lever = table[:, 1] * math.cos(axis) + table[:, 2] * math.sin(axis)
    t = np.arange(frames, dtype=np.float64)
    grow = t / max(frames - 1, 1)
    dz = (-params["drift_z_mm_per_frame"] * t[:, None]
          - np.tan(tilt * grow)[:, None] * lever[None, :])
    d = np.zeros((frames, layout.NUM_MARKERS, 3), np.float32)
    d[:, :, 2] = dz
    return torch.from_numpy(d).to(device)


def render_uint8(height: int, width: int, frames: int, seed: int,
                 params: dict, device) -> torch.Tensor:
    """The seeded sequence ``(frames, H, W)`` as uint8 on ``device``, as
    every real source yields frames."""
    scene = default_scene(height, width, device)
    img = render_frames(scene, motion(frames, seed, params, device))
    return img.to(torch.uint8)
