"""Synthetic dome renderer.

Port of ``vision_basedsensor_tpu/synth/render.py`` (``default_scene``,
``render_frames``): the 65-marker dome is projected through the pinhole +
distortion camera, each marker ball becomes an image-plane ellipse from the
projection Jacobian (analytic here, ``jacfwd`` there) and is rasterized
with ~1 px anti-aliased edges. The machine that runs the port may have no
JAX, so the port renders its own test frames.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vision_basedsensor_tpu_torch import layout
from vision_basedsensor_tpu_torch.core import camera as cam_mod
from vision_basedsensor_tpu_torch.core.camera import CameraModel


class DomeScene(NamedTuple):
    cam: CameraModel
    marker_world: torch.Tensor  # (65, 3) rest positions, mm
    marker_radius_mm: float
    background: float           # gray level of the bonnet surface
    marker_level: float         # gray level inside markers
    height: int
    width: int


def default_scene(height: int = 480, width: int = 640,
                  camera_z_mm: float | None = None,
                  dist: np.ndarray | None = None,
                  device=None) -> DomeScene:
    """Camera under the dome apex looking up (+Z), dome at the origin; the
    camera distance scales with resolution up to 640 px so markers stay
    ~20 px across."""
    if camera_z_mm is None:
        camera_z_mm = -40.0 * min(width / 640.0, 1.0)
    f = 0.625 * width
    cam = CameraModel.create(
        fx=f, fy=f, cx=width / 2, cy=height / 2,
        dist=np.zeros(5) if dist is None else dist,
        R_wc=np.eye(3), T_wc=np.array([0.0, 0.0, -camera_z_mm]),
        device=device)
    table = layout.dome_layout()
    return DomeScene(
        cam=cam,
        marker_world=torch.as_tensor(table[:, 1:], dtype=torch.float32,
                                     device=device),
        marker_radius_mm=layout.MARKER_DIAMETER_MM / 2,
        background=190.0, marker_level=40.0, height=height, width=width)


def render_frames(scene: DomeScene, displacements: torch.Tensor,
                  marker_mask: torch.Tensor | None = None,
                  chunk: int = 8) -> torch.Tensor:
    """Render float frames ``(B, H, W)`` in 0..255 for per-marker world
    displacements ``(B, 65, 3)`` (mm), ``chunk`` frames at a time."""
    if displacements.ndim == 2:
        displacements = displacements[None]
    dev = displacements.device
    n = scene.marker_world.shape[0]
    if marker_mask is None:
        marker_mask = torch.ones(n, dtype=torch.bool, device=dev)
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
            if not bool(marker_mask[i]):
                continue
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
