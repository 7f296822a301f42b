"""Batched monocular 3D reconstruction (reference C12 hot loop).

Port of ``vision_basedsensor_tpu/reconstruct/depth.py``: undistort the
``(B, 65, 2)`` centers, correct each diameter by the local magnification of
the distortion map (analytic Jacobian in place of ``jax.jacfwd``), then
depth-from-diameter back-projection, with the reference's gates.
"""
from __future__ import annotations

import torch

from vision_basedsensor_tpu_torch.config import ReconstructConfig
from vision_basedsensor_tpu_torch.core import camera as cam_mod
from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.utils.graphs import replay
from vision_basedsensor_tpu_torch.utils.profiling import trace_annotation


def reconstruct_positions(cam: CameraModel, uv: torch.Tensor,
                          axes_px: torch.Tensor, valid: torch.Tensor,
                          cfg: ReconstructConfig
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel observations ``(..., 2)`` with (major, minor) axes -> world
    positions ``(..., 3)`` and updated validity (size gate, axis-ratio gate,
    finite positions); a CUDA graph on the card (``utils/graphs.py``)."""
    with trace_annotation("vbs.reconstruct.positions"):
        return replay("reconstruct.positions", _positions, cam, uv, axes_px,
                      valid, cfg)


def _positions(cam: CameraModel, uv: torch.Tensor, axes_px: torch.Tensor,
               valid: torch.Tensor, cfg: ReconstructConfig
               ) -> tuple[torch.Tensor, torch.Tensor]:
    diameter_px = axes_px[..., 0]
    xy_n = cam_mod.undistort_points(cam, uv, iters=cfg.undistort_iters,
                                    to_pixels=False)
    uv_u = cam_mod.normalized_to_pixel(cam, xy_n)
    ok = valid & (diameter_px >= cfg.min_marker_size_px)
    if cfg.max_axis_ratio is not None:
        ratio = diameter_px / torch.clamp(axes_px[..., 1], min=1e-6)
        ok = ok & (ratio <= cfg.max_axis_ratio)

    if cfg.distortion_corrected_diameter:
        # Divide by the local isotropic magnification sqrt|det J| of the
        # distortion map at the undistorted point.
        jac = cam_mod.distortion_jacobian(cam, xy_n)
        det = torch.abs(jac[..., 0, 0] * jac[..., 1, 1]
                        - jac[..., 0, 1] * jac[..., 1, 0])
        diameter_px = diameter_px / torch.sqrt(torch.clamp(det, min=1e-12))

    world = cam_mod.backproject_depth_from_diameter(
        cam, uv_u, diameter_px, cfg.marker_diameter_mm)
    ok = ok & torch.all(torch.isfinite(world), dim=-1)
    return torch.where(ok[..., None], world, torch.zeros_like(world)), ok
