"""Marker-diameter precision validation (reference C19).

Port of ``vision_basedsensor_tpu/analysis/diameter.py``, the rebuild of
``DiameterValidation.py``: a px/mm scale from a chessboard in the image
(mean adjacent-corner spacing, :45-74), Otsu's threshold in place of the
interactive trackbar (:76-111), and each dark disk measured by fixed-shape
moments of the connected component that holds its blob peak (a
morphological reconstruction inside a window): area, boundary-pixel
perimeter, circularity ``4 pi A / P^2`` (gated at 0.75x the reference's cv2
scale) and the enclosing-circle diameter ``2 (max centroid distance +
0.5)``. A component that touches its window's border is rejected, not
mismeasured. The reference's ``fori_loop`` of 3x3 dilations is a loop over
the max filter, whose padding (-inf for a max, +inf for a min) is
``lax.reduce_window``'s "SAME".
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vision_basedsensor_tpu_torch.core.device import CUDA, resolve
from vision_basedsensor_tpu_torch.core.imaging import (gaussian_blur,
                                                       max_filter, min_filter,
                                                       to_grayscale)
from vision_basedsensor_tpu_torch.ops.patches import (extract_patches,
                                                      patch_coords)
from vision_basedsensor_tpu_torch.ops.peaks import find_peaks


def otsu_threshold(gray: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Otsu's threshold of a grayscale image: a histogram of ``bins`` over
    [0, 256) on the image's device, then the reference's arithmetic (the
    middle of the between-class variance's argmax plateau)."""
    x = gray.reshape(-1).float()
    # jnp.histogram's bins: [k, k + 1) for k < bins - 1, the last closed.
    idx = torch.clamp(torch.floor(x * (bins / 256.0)).long(), 0, bins - 1)
    inside = ((x >= 0.0) & (x <= 256.0)).to(torch.float64)
    hist = torch.bincount(idx, weights=inside, minlength=bins)
    p = hist.float() / torch.clamp(hist.sum(), min=1).float()
    centers = (torch.arange(bins, device=x.device) + 0.5) * (256.0 / bins)
    w0 = torch.cumsum(p, 0)
    m0 = torch.cumsum(p * centers, 0)
    mt = m0[-1]
    w1 = 1.0 - w0
    between = torch.where((w0 > 0) & (w1 > 0),
                          (mt * w0 - m0) ** 2
                          / torch.clamp(w0 * w1, min=1e-12),
                          torch.zeros_like(w0))
    # The between-class variance is flat across empty histogram gaps: take
    # the middle of the argmax plateau (its left edge would clip the blobs'
    # anti-aliased skirts).
    on_plateau = between >= torch.max(between) * (1.0 - 1e-6)
    picked = torch.where(on_plateau, centers, torch.zeros_like(centers))
    return torch.sum(picked) / torch.clamp(on_plateau.sum(), min=1)


def chessboard_scale(corners: np.ndarray, pattern_size: tuple[int, int],
                     square_mm: float) -> float:
    """px/mm from the mean adjacent-corner spacing
    (``DiameterValidation.py:54-71``) of grid-ordered row-major corners
    ``(rows * cols, 2)``."""
    cols, rows = pattern_size
    grid = np.asarray(corners, float).reshape(rows, cols, 2)
    dists = [np.linalg.norm(grid[:, 1:] - grid[:, :-1], axis=-1).ravel(),
             np.linalg.norm(grid[1:, :] - grid[:-1, :], axis=-1).ravel()]
    return float(np.concatenate(dists).mean() / square_mm)


class DiameterMeasurement(NamedTuple):
    centers: torch.Tensor       # (K, 2)
    diameters_mm: torch.Tensor  # (K,)
    circularity: torch.Tensor   # (K,)
    area_px: torch.Tensor       # (K,)
    valid: torch.Tensor         # (K,)


def measure_diameters(image, scale_px_per_mm: float,
                      threshold: float | None = None,
                      min_area_px: float = 100.0,
                      min_circularity: float = 0.85,
                      diameter_offset_mm: float = 0.0,
                      max_markers: int = 96,
                      patch: int = 64, device=CUDA) -> DiameterMeasurement:
    """Measure dark circular markers on a light background in one image
    ``(H, W[, 3])`` (numpy or a tensor) on ``device`` (the card by
    default), with the reference's gates: ``MIN_AREA=100`` px,
    ``MIN_CIRCULARITY=0.85`` and ``DIAMETER_OFFSET_MM``
    (``DiameterValidation.py:34-38,121-141``)."""
    gray = to_grayscale(torch.as_tensor(image, device=resolve(device)))
    blur = gaussian_blur(gray, 5, 1.1)  # cv2 (5,5), sigma=0 picks ~1.1
    thr = (otsu_threshold(blur) if threshold is None
           else torch.tensor(threshold, dtype=torch.float32,
                             device=blur.device))
    mask = (blur < thr).float()         # THRESH_BINARY_INV

    # Blob centres: peaks of the smoothed mask, one per blob after the
    # distance suppression.
    soft = gaussian_blur(mask, 15, 4.0)
    peaks = find_peaks(soft, 0.5, 15, max_markers, float(patch) / 2.0)

    m_patch, start = extract_patches(mask, peaks.xy, patch)
    gx, gy = patch_coords(start, patch)

    # The connected component of each peak: dilate the seed inside the mask
    # patch // 2 times (enough to reach any pixel of the window), so other
    # dark objects in the window (a neighbour, a chessboard square) stay
    # out of the sums.
    px = torch.clamp(torch.round(peaks.xy[:, 0]).int() - start[:, 0].int(),
                     0, patch - 1)
    py = torch.clamp(torch.round(peaks.xy[:, 1]).int() - start[:, 1].int(),
                     0, patch - 1)
    k = m_patch.shape[0]
    seed = torch.zeros_like(m_patch)
    seed[torch.arange(k, device=seed.device), py.long(), px.long()] = 1.0
    comp = seed * m_patch
    for _ in range(patch // 2):
        comp = max_filter(comp, 3) * m_patch

    flat = lambda v: v.reshape(-1, patch * patch)
    w = flat(comp)
    area = w.sum(-1)
    tot = torch.clamp(area, min=1e-9)
    cx = (w * flat(gx)).sum(-1) / tot
    cy = (w * flat(gy)).sum(-1) / tot

    # Enclosing circle: the farthest component pixel from the centroid,
    # +0.5 px for the pixel corners minEnclosingCircle circumscribes.
    d2 = (flat(gx) - cx[:, None]) ** 2 + (flat(gy) - cy[:, None]) ** 2
    r_enc = torch.sqrt(torch.amax(torch.where(w > 0, d2, torch.zeros_like(d2)),
                                  dim=-1))
    diameter_px = 2.0 * (r_enc + 0.5)

    # Circularity with the perimeter as the component's boundary-pixel count
    # (the component minus its 3x3 erosion): ~0.75x cv2's contour metric on
    # the same shape, hence the gate's 0.75 factor.
    boundary = flat(comp - min_filter(comp, 3)).sum(-1)
    circ = 4.0 * math.pi * area / torch.clamp(boundary, min=1.0) ** 2

    # A component touching the window border is truncated: rejected.
    edge = torch.zeros((patch, patch), dtype=comp.dtype, device=comp.device)
    edge[0, :] = edge[-1, :] = edge[:, 0] = edge[:, -1] = 1.0
    touches = flat(comp * edge).sum(-1) > 0

    diameters_mm = diameter_px / scale_px_per_mm + diameter_offset_mm
    valid = (peaks.valid & (area >= min_area_px) & ~touches
             & (circ >= 0.75 * min_circularity))
    return DiameterMeasurement(
        centers=torch.stack([cx, cy], -1), diameters_mm=diameters_mm,
        circularity=circ, area_px=area, valid=valid)
