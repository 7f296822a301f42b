"""Image-to-intrinsics calibration: the reference C10 flow end to end.

Port of ``vision_basedsensor_tpu/calibrate/images.py``: the reference's
``calibrate_camera`` (``intrinsic_calibration.py:53-109``) crops each
image, finds the chessboard corners, refines them and calibrates; here the
same crop convention, the chessboard detector (``calibrate/chessboard.py``)
and the Zhang solver (``calibrate/zhang.py``), on ``device``.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from vision_basedsensor_tpu_torch.calibrate.artifact import CalibrationArtifact
from vision_basedsensor_tpu_torch.calibrate.chessboard import find_chessboard
from vision_basedsensor_tpu_torch.calibrate.zhang import (ZhangResult,
                                                          calibrate_intrinsics)
from vision_basedsensor_tpu_torch.core.device import CUDA, resolve
from vision_basedsensor_tpu_torch.core.imaging import crop_frames, to_grayscale


def board_object_points(pattern_size: tuple[int, int],
                        square_mm: float) -> np.ndarray:
    """Planar board coordinates in the reference's ordering
    (``intrinsic_calibration.py:58-59``: x varies fastest)."""
    cols, rows = pattern_size
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    return np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], -1) * square_mm


class ImageCalibration(NamedTuple):
    result: ZhangResult
    artifact: CalibrationArtifact
    used_images: list[int]


def calibrate_from_images(images: Iterable[np.ndarray],
                          pattern_size: tuple[int, int] = (6, 6),
                          square_mm: float = 3.0,
                          crop_ratios: tuple | None = None,
                          min_images: int = 3,
                          refine_iters: int = 30,
                          device=CUDA) -> ImageCalibration | None:
    """Detect the board in every image and solve the intrinsics on
    ``device`` (the card by default). None when fewer than ``min_images``
    boards are found (the reference's >= 3 valid images,
    ``intrinsic_calibration.py:92``)."""
    device = resolve(device)
    objp = board_object_points(pattern_size, square_mm)
    objs, imgs, used = [], [], []
    for i, img in enumerate(images):
        gray = to_grayscale(torch.as_tensor(img, device=device))
        if crop_ratios is not None:
            gray = crop_frames(gray, crop_ratios=tuple(crop_ratios))
        res = find_chessboard(gray, pattern_size, device=device)
        if not res.found:
            continue
        objs.append(objp)
        imgs.append(res.corners)
        used.append(i)
    if len(objs) < min_images:
        return None
    # order_grid gives each image a consistent (if arbitrary) direction;
    # the planar solve and the per-view poses absorb it.
    z = calibrate_intrinsics(np.stack(objs), np.stack(imgs),
                             refine_iters=refine_iters, device=device)
    art = CalibrationArtifact(
        fx=float(z.cam.fx), fy=float(z.cam.fy), cx=float(z.cam.cx),
        cy=float(z.cam.cy), skew=0.0, dist=z.cam.dist.cpu().numpy(),
        intrinsic_reproj_error=float(z.mean_reproj_error))
    return ImageCalibration(result=z, artifact=art, used_images=used)
