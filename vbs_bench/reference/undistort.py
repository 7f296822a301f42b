"""Full-frame undistortion (a frozen copy of the port's
``core/undistort.py``): the new pinhole camera that covers the undistorted
image (OpenCV's ``getOptimalNewCameraMatrix``), the ``(H, W, 2)``
source-coordinate map (``initUndistortRectifyMap``) and the bilinear remap
batched over frames (``remap``)."""
from __future__ import annotations

import numpy as np
import torch

from vbs_bench.reference import camera as cam_mod
from vbs_bench.reference.camera import CameraModel


def optimal_new_camera(cam: CameraModel, h: int, w: int,
                       alpha: float = 0.0) -> CameraModel:
    """Scaled pinhole (no distortion) covering the undistorted image, on the
    camera's device. ``alpha=0`` crops to all-valid pixels; ``alpha=1``
    keeps every source pixel. The border grid is undistorted in float64,
    the box is found in numpy."""
    xs = np.linspace(0, w - 1, 32)
    ys = np.linspace(0, h - 1, 32)
    border = np.concatenate([
        np.stack([xs, np.zeros_like(xs)], -1),
        np.stack([xs, np.full_like(xs, h - 1)], -1),
        np.stack([np.zeros_like(ys), ys], -1),
        np.stack([np.full_like(ys, w - 1), ys], -1),
    ])
    dev = cam.fx.device
    und = cam_mod.undistort_points(
        cam, torch.as_tensor(border, device=dev), iters=10,
        to_pixels=False).cpu().numpy()
    x0o, y0o = und.min(0)
    x1o, y1o = und.max(0)
    top, bot, lef, rig = und[:32], und[32:64], und[64:96], und[96:]
    x0i, x1i = lef[:, 0].max(), rig[:, 0].min()
    y0i, y1i = top[:, 1].max(), bot[:, 1].min()
    x0 = x0i + (x0o - x0i) * alpha
    x1 = x1i + (x1o - x1i) * alpha
    y0 = y0i + (y0o - y0i) * alpha
    y1 = y1i + (y1o - y1i) * alpha
    fx_new = (w - 1) / max(x1 - x0, 1e-9)
    fy_new = (h - 1) / max(y1 - y0, 1e-9)
    return CameraModel.create(fx_new, fy_new, -x0 * fx_new, -y0 * fy_new,
                              device=dev)


def build_rectify_map(cam: CameraModel, h: int, w: int,
                      new_cam: CameraModel) -> torch.Tensor:
    """Source pixel coordinates ``(H, W, 2)`` for each destination pixel:
    the new camera's rays forward-distorted through ``cam``."""
    dev = cam.fx.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    xyn = cam_mod.pixel_to_normalized(new_cam, torch.stack([gx, gy], dim=-1))
    return cam_mod.normalized_to_pixel(cam, cam_mod.distort_normalized(cam, xyn))


def remap_bilinear(frames: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """Bilinear remap of frames ``(..., H, W)`` through ``src_map``
    ``(H, W, 2)``; samples outside the frame read the clamped border."""
    h, w = frames.shape[-2:]
    x = torch.clamp(src_map[..., 0], 0.0, w - 1.000001)
    y = torch.clamp(src_map[..., 1], 0.0, h - 1.000001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0, y0 = x0.long(), y0.long()
    flat = frames.reshape(*frames.shape[:-2], h * w)
    out_shape = frames.shape[:-2] + src_map.shape[:-1]

    def gather(yy, xx):
        # w - 1.000001 rounds to w - 1 in float32 for w >= 64, so x0 + 1
        # can leave the frame: the indices are clamped.
        idx = torch.clamp(yy, max=h - 1) * w + torch.clamp(xx, max=w - 1)
        return flat[..., idx.reshape(-1)].reshape(out_shape)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))
