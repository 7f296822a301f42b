"""Pinhole camera model with Brown-Conrady distortion.

Port of ``vision_basedsensor_tpu/core/camera.py``: the camera model,
projection, the fixed-point ``undistort_points`` (``cv2.undistortPoints``
semantics) and depth-from-diameter back-projection, plus the analytic
Jacobian of the distortion map that the reference takes with ``jacfwd``.
Distortion coefficients follow OpenCV's ``[k1, k2, p1, p2, k3]``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CameraModel(NamedTuple):
    """Intrinsics (+ optional extrinsics) of a pinhole camera; every field
    is a float32 tensor (scalars 0-d, ``dist`` (5,), ``R_wc`` (3, 3),
    ``T_wc`` (3,), mm)."""
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    skew: torch.Tensor
    dist: torch.Tensor
    R_wc: torch.Tensor
    T_wc: torch.Tensor

    @classmethod
    def create(cls, fx, fy, cx, cy, skew=0.0, dist=None, R_wc=None, T_wc=None,
               dtype=torch.float32, device=None) -> "CameraModel":
        def t(v):
            return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                                   device=device)
        dist = np.zeros(5) if dist is None else np.asarray(dist, np.float64)
        dist = np.concatenate([dist, np.zeros(5 - dist.shape[0])])[:5]
        R_wc = np.eye(3) if R_wc is None else R_wc
        T_wc = np.zeros(3) if T_wc is None else np.reshape(np.asarray(T_wc), (3,))
        return cls(t(fx), t(fy), t(cx), t(cy), t(skew), t(dist), t(R_wc),
                   t(T_wc))

    @property
    def f_avg(self) -> torch.Tensor:
        """Mean focal length used by depth-from-diameter."""
        return (self.fx + self.fy) / 2.0


def distort_normalized(cam: CameraModel, xy: torch.Tensor) -> torch.Tensor:
    """Apply Brown-Conrady distortion to normalized coords ``(..., 2)``."""
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def distortion_jacobian(cam: CameraModel, xy: torch.Tensor) -> torch.Tensor:
    """``d distort_normalized / d xy`` ``(..., 2, 2)``, analytic."""
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dradial = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)       # d radial / d r2
    j00 = radial + 2.0 * x * x * dradial + 2.0 * p1 * y + 6.0 * p2 * x
    j01 = 2.0 * x * y * dradial + 2.0 * p1 * x + 2.0 * p2 * y   # symmetric
    j11 = radial + 2.0 * y * y * dradial + 6.0 * p1 * y + 2.0 * p2 * x
    return torch.stack([torch.stack([j00, j01], -1),
                        torch.stack([j01, j11], -1)], -2)


def normalized_to_pixel(cam: CameraModel, xy: torch.Tensor) -> torch.Tensor:
    u = cam.fx * xy[..., 0] + cam.skew * xy[..., 1] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def pixel_to_normalized(cam: CameraModel, uv: torch.Tensor) -> torch.Tensor:
    y = (uv[..., 1] - cam.cy) / cam.fy
    x = (uv[..., 0] - cam.cx - cam.skew * y) / cam.fx
    return torch.stack([x, y], dim=-1)


def project_points(cam: CameraModel, p_world: torch.Tensor) -> torch.Tensor:
    """World points ``(..., 3)`` -> distorted pixel coords ``(..., 2)``."""
    p_cam = p_world @ cam.R_wc.T + cam.T_wc
    xy = p_cam[..., :2] / p_cam[..., 2:3]
    return normalized_to_pixel(cam, distort_normalized(cam, xy))


def projection_jacobian(cam: CameraModel, p_world: torch.Tensor) -> torch.Tensor:
    """``d project_points / d p_world`` ``(..., 2, 3)``, analytic (chain of
    rotation, perspective division, distortion and intrinsics)."""
    p_cam = p_world @ cam.R_wc.T + cam.T_wc
    z = p_cam[..., 2]
    xy = p_cam[..., :2] / p_cam[..., 2:3]
    zero = torch.zeros_like(z)
    inv_z = 1.0 / z
    d_div = torch.stack([
        torch.stack([inv_z, zero, -xy[..., 0] * inv_z], -1),
        torch.stack([zero, inv_z, -xy[..., 1] * inv_z], -1)], -2)   # (..., 2, 3)
    k = torch.stack([torch.stack([cam.fx, cam.skew]),
                     torch.stack([torch.zeros_like(cam.fy), cam.fy])])
    return k @ distortion_jacobian(cam, xy) @ d_div @ cam.R_wc


def undistort_points(cam: CameraModel, uv: torch.Tensor, iters: int = 5,
                     to_pixels: bool = True) -> torch.Tensor:
    """Invert the distortion for pixel points ``(..., 2)`` with OpenCV's
    fixed-point iteration (``iters`` rounds); re-projected through K when
    ``to_pixels``, else normalized coordinates."""
    xd = pixel_to_normalized(cam, uv)
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x = xd
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * xx * yy + p2 * (r2 + 2.0 * xx * xx)
        dy = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * xx * yy
        x = torch.stack([(xd[..., 0] - dx) / radial,
                         (xd[..., 1] - dy) / radial], dim=-1)
    return normalized_to_pixel(cam, x) if to_pixels else x


def backproject_depth_from_diameter(cam: CameraModel, uv_undist: torch.Tensor,
                                    diameter_px: torch.Tensor,
                                    marker_diameter_mm: float) -> torch.Tensor:
    """Monocular depth-from-diameter back-projection
    (``3d_reconstruction.py:195-228``); world coordinates ``(..., 3)``."""
    f_avg = cam.f_avg
    du = uv_undist[..., 0] - cam.cx
    dv = uv_undist[..., 1] - cam.cy
    R = torch.sqrt(du * du + dv * dv)
    d_eff = (marker_diameter_mm / f_avg) * torch.sqrt(R * R + f_avg * f_avg)
    h = f_avg * d_eff / torch.clamp(diameter_px, min=1e-6)
    p_cam = torch.stack([h * du / cam.fx, h * dv / cam.fy, h], dim=-1)
    return (p_cam - cam.T_wc) @ cam.R_wc
