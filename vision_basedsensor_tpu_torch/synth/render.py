"""Synthetic dome renderer.

Port of ``vision_basedsensor_tpu/synth/render.py`` (``default_scene``,
``render_frames``, and the displacement fields ``indentation_staircase``,
``probe_indentation_field``, ``membrane_indentation_field`` and
``tilt_deviation_field``): the 65-marker dome is projected through the pinhole +
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
from vision_basedsensor_tpu_torch.core.device import CUDA, resolve


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
                  device=CUDA) -> DomeScene:
    """Camera under the dome apex looking up (+Z), dome at the origin; the
    camera distance scales with resolution up to 640 px so markers stay
    ~20 px across. Tensors are built on ``device`` (the card by default)."""
    device = resolve(device)
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


def indentation_staircase(num_steps: int = 12, step_mm: float = 0.7,
                          frames_per_step: int = 1,
                          device=CUDA) -> torch.Tensor:
    """World displacements of the probe-indentation experiment
    (README.md:103-121): every marker translates by ``k * step_mm`` along -Z
    at step k. Returns ``(num_steps * frames_per_step + 1, 65, 3)``, the rest
    frame included, on ``device`` (the card by default)."""
    device = resolve(device)
    steps = torch.arange(num_steps + 1, dtype=torch.float32) * step_mm
    reps = torch.full((num_steps + 1,), frames_per_step)
    reps[0] = 1
    steps = torch.repeat_interleave(steps, reps)
    d = torch.zeros((steps.shape[0], layout.NUM_MARKERS, 3))
    d[:, :, 2] = -steps[:, None]
    return d.to(device)


def probe_indentation_field(depth_mm: float, contact_xy=(0.0, 0.0),
                            probe_radius_mm: float = 5.0,
                            device=CUDA) -> torch.Tensor:
    """Local deformation of a spherical probe pressed into the dome.

    Physical analog of the reference's indentation rig (README.md:103-121):
    markers inside the contact footprint follow the probe surface; outside it
    the displacement decays smoothly (exponential skirt), instead of the
    rigid -Z translation of :func:`indentation_staircase`. Returns ``(65, 3)``
    -Z displacements (membrane tangential motion neglected), on ``device``
    (the card by default).
    """
    table = layout.dome_layout()
    r = np.hypot(table[:, 1] - contact_xy[0], table[:, 2] - contact_xy[1])
    # Spherical probe cap: depth profile d(r) = depth - (R - sqrt(R^2 - r^2)).
    inside = r < probe_radius_mm
    sag = probe_radius_mm - np.sqrt(np.maximum(probe_radius_mm**2 - r**2, 0.0))
    d_in = np.maximum(depth_mm - sag, 0.0)
    # Footprint edge: radius where the probe meets the surface.
    a = probe_radius_mm * np.sqrt(max(0.0, 1 - (1 - depth_mm / probe_radius_mm)**2)) \
        if depth_mm < probe_radius_mm else probe_radius_mm
    edge = np.maximum(depth_mm - (probe_radius_mm - np.sqrt(max(probe_radius_mm**2 - a**2, 0.0))), 0.0)
    skirt = edge * np.exp(-(r - a) / max(probe_radius_mm, 1e-6))
    dz = np.where(inside, d_in, skirt)
    out = np.zeros((layout.NUM_MARKERS, 3), np.float32)
    out[:, 2] = -dz
    return torch.from_numpy(out).to(resolve(device))


def membrane_indentation_field(depth_mm: float, contact_xy=(0.0, 0.0),
                               probe_radius_mm: float = 5.0,
                               tangential_frac: float = 0.3,
                               device=CUDA) -> torch.Tensor:
    """Probe indentation with membrane kinematics: normal sag PLUS radial
    tangential flow.

    :func:`probe_indentation_field` models the rig's -Z sag only
    (README.md:103-121); a real elastomer membrane also stretches — material
    under the probe is pushed radially outward, so markers translate in X/Y
    too. Modeled as an axisymmetric outward flow that vanishes at the
    contact centre, peaks at the contact edge ``r = a``, and decays outside:

        u_r(r) = tangential_frac * depth * (r/a) * exp((1 - (r/a)^2) / 2)

    (peak value ``tangential_frac * depth`` at ``r = a``; the Gaussian-decay
    shape is the standard far-field of a point indentation on a stretched
    membrane). This stresses full 3D displacement recovery — the reference
    only ever validates Z (its rig prescribes pure -Z steps) while its
    output schema carries dX/dY/dZ (``3d_reconstruction.py:296-307``).
    Returns ``(65, 3)`` world displacements (mm) on ``device`` (the card
    by default).
    """
    dz = probe_indentation_field(depth_mm, contact_xy, probe_radius_mm,
                                 device="cpu").numpy()
    table = layout.dome_layout()
    rx = table[:, 1] - contact_xy[0]
    ry = table[:, 2] - contact_xy[1]
    r = np.hypot(rx, ry)
    a = max(probe_radius_mm * np.sqrt(
        max(0.0, 1 - (1 - depth_mm / probe_radius_mm) ** 2)), 1e-6) \
        if depth_mm < probe_radius_mm else probe_radius_mm
    u_r = tangential_frac * depth_mm * (r / a) * np.exp(0.5 * (1 - (r / a) ** 2))
    safe_r = np.maximum(r, 1e-9)
    out = np.stack([u_r * rx / safe_r, u_r * ry / safe_r, dz[:, 2]], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(resolve(device))


def tilt_deviation_field(tilt_deg: float, axis: str = "y",
                         compression_mm: float = 1.0,
                         device=CUDA) -> torch.Tensor:
    """Displacement field ``(65, 3)`` of a tilted compression: each marker
    moves along -Z by ``compression + tan(tilt) * coordinate``, so the
    deviation field's fitted contact plane has exactly ``tilt_deg`` tilt
    (``ForceDistribution.py:138-162``). On ``device`` (the card by
    default)."""
    device = resolve(device)
    table = layout.dome_layout()
    coord = table[:, 1] if axis == "y" else table[:, 2]
    d = np.zeros((layout.NUM_MARKERS, 3), np.float32)
    d[:, 2] = -(compression_mm + np.tan(np.deg2rad(tilt_deg)) * coord)
    return torch.from_numpy(d).to(device)
