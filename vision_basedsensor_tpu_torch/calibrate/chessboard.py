"""Chessboard corner detection + sub-pixel refinement.

Port of ``vision_basedsensor_tpu/calibrate/chessboard.py``, in place of
``cv2.findChessboardCorners`` + ``cv2.cornerSubPix``
(``intrinsic_calibration.py:76-81``; also the scale step of
``DiameterValidation.py:45-74``):

1. inner corners are intensity saddle points: the response ``-det(H)`` of
   Gaussian-derivative filters (the banded-matmul separable filters of
   ``core/imaging.py``) is positive there;
2. local maxima of the response (``ops/peaks.py:find_peaks``, 4 px cells);
3. sub-pixel refinement by the gradient-orthogonality iteration that
   ``cornerSubPix`` solves, a fixed number of steps (the reference's
   ``lax.scan`` is a loop);
4. lattice ordering on the host (:func:`order_grid`, a copy).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vision_basedsensor_tpu_torch.core.device import CUDA, resolve
from vision_basedsensor_tpu_torch.core.imaging import _sep_filter
from vision_basedsensor_tpu_torch.ops.patches import (extract_patches,
                                                      patch_coords)
from vision_basedsensor_tpu_torch.ops.peaks import find_peaks


def _gauss_deriv_taps(sigma: float, order: int) -> np.ndarray:
    """Gaussian (order 0/1/2) derivative taps."""
    radius = int(np.ceil(3 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    if order == 0:
        return g
    if order == 1:
        return -x / sigma**2 * g
    return (x**2 - sigma**2) / sigma**4 * g


def saddle_response(gray: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """``-det(Hessian)`` of the smoothed image: positive at checkerboard
    corners (saddles), negative at blobs and ridges."""
    g0 = _gauss_deriv_taps(sigma, 0)
    g1 = _gauss_deriv_taps(sigma, 1)
    g2 = _gauss_deriv_taps(sigma, 2)
    ixx = _sep_filter(gray, g0, g2, "reflect101")
    iyy = _sep_filter(gray, g2, g0, "reflect101")
    ixy = _sep_filter(gray, g1, g1, "reflect101")
    return ixy * ixy - ixx * iyy


def refine_subpixel(gray: torch.Tensor, corners_xy: torch.Tensor,
                    window: int = 11, iters: int = 10) -> torch.Tensor:
    """cornerSubPix-style refinement of corners ``(K, 2)`` on one image:
    ``sum_w G(p) (p - q) = 0`` with ``G = grad I grad I^T`` over a
    tent-weighted ``window`` (total width; cv2's winSize=(11, 11) means
    23 x 23), ``iters`` steps from the given positions, each step held
    within 2 px of the last."""
    g0 = _gauss_deriv_taps(1.5, 0)
    g1 = _gauss_deriv_taps(1.5, 1)
    ix = _sep_filter(gray, g0, g1, "reflect101")
    iy = _sep_filter(gray, g1, g0, "reflect101")

    p = window + 4  # patch with margin for sub-pixel drift
    gxx_p, start = extract_patches(ix * ix, corners_xy, p)
    gxy_p, _ = extract_patches(ix * iy, corners_xy, p)
    gyy_p, _ = extract_patches(iy * iy, corners_xy, p)
    px, py = patch_coords(start, p)

    half = (window - 1) / 2.0
    q = corners_xy
    for _ in range(iters):
        wx = torch.clamp(1.0 - torch.abs(px - q[:, 0, None, None]) / (half + 1),
                         0, 1)
        wy = torch.clamp(1.0 - torch.abs(py - q[:, 1, None, None]) / (half + 1),
                         0, 1)
        w = wx * wy
        a = (w * gxx_p).sum((-2, -1))
        b = (w * gxy_p).sum((-2, -1))
        c = (w * gyy_p).sum((-2, -1))
        bx = (w * (gxx_p * px + gxy_p * py)).sum((-2, -1))
        by = (w * (gxy_p * px + gyy_p * py)).sum((-2, -1))
        det = torch.clamp(a * c - b * b, min=1e-12)
        qx = (c * bx - b * by) / det
        qy = (a * by - b * bx) / det
        # Don't run away from the window on degenerate patches.
        q = torch.clamp(torch.stack([qx, qy], dim=-1), q - 2.0, q + 2.0)
    return q


def order_grid(corners: np.ndarray, pattern_size: tuple[int, int],
               scores: np.ndarray | None = None) -> np.ndarray | None:
    """Order scattered corners into row-major (cols-fast) grid order.

    Host-side (runs once per calibration image): estimates the two lattice
    directions from nearest-neighbor displacement vectors, assigns integer
    lattice coordinates by projection, and normalizes orientation.
    Returns ``(rows*cols, 2)`` or None if the set is not a clean grid.
    """
    cols, rows = pattern_size
    n = rows * cols
    if corners.shape[0] < n:
        return None
    c = corners

    # Nearest-neighbor vectors.
    d = c[:, None, :] - c[None, :, :]
    dist = np.linalg.norm(d, axis=-1)
    np.fill_diagonal(dist, np.inf)
    nn = np.argsort(dist, axis=1)[:, :4]
    vecs = np.concatenate([c[nn[:, k]] - c for k in range(4)])
    vecs = vecs[np.linalg.norm(vecs, axis=1) < 1.5 * np.median(dist.min(1))]
    ang = np.mod(np.arctan2(vecs[:, 1], vecs[:, 0]), np.pi)
    # Dominant direction via angle histogram.
    hist, edges = np.histogram(ang, bins=36, range=(0, np.pi))
    a0 = edges[np.argmax(hist)] + np.pi / 72
    dir0 = np.array([np.cos(a0), np.sin(a0)])
    dir1 = np.array([-np.sin(a0), np.cos(a0)])
    sel0 = np.abs(np.mod(ang - a0 + np.pi / 2, np.pi) - np.pi / 2) < np.pi / 8
    sel1 = np.abs(np.mod(ang - a0, np.pi) - np.pi / 2) < np.pi / 8
    if sel0.sum() < 2 or sel1.sum() < 2:
        return None
    # Flip each sample onto the +direction before taking the median (the
    # mod-pi angle loses the vector's sign).
    u = np.median(vecs[sel0] * np.sign(vecs[sel0] @ dir0)[:, None], axis=0)
    v = np.median(vecs[sel1] * np.sign(vecs[sel1] @ dir1)[:, None], axis=0)

    B = np.stack([u, v], axis=1)  # lattice basis (2, 2) columns
    try:
        coords = np.linalg.solve(B, (c - c.mean(0)).T).T
    except np.linalg.LinAlgError:
        return None
    ij = np.round(coords - coords.min(0)).astype(int)
    ij -= ij.min(0)
    span = ij.max(0) + 1

    # The candidate set may include spurious saddles (board outline); among
    # all completely-filled (cols x rows) lattice windows pick the one with
    # the highest total corner score (true inner corners respond strongest).
    sc = np.ones(len(c)) if scores is None else np.asarray(scores)

    def fill(window_cols, window_rows, transpose):
        a = ij[:, ::-1] if transpose else ij
        sp = a.max(0) + 1
        best = None
        best_score = -np.inf
        for oy in range(sp[1] - window_rows + 1):
            for ox in range(sp[0] - window_cols + 1):
                grid = np.full((window_rows, window_cols, 2), np.nan)
                gscore = np.full((window_rows, window_cols), -np.inf)
                for (i, j), pt, s in zip(a, c, sc):
                    gi, gj = i - ox, j - oy
                    if 0 <= gi < window_cols and 0 <= gj < window_rows \
                            and s > gscore[gj, gi]:
                        grid[gj, gi] = pt
                        gscore[gj, gi] = s
                if not np.isnan(grid).any() and gscore.sum() > best_score:
                    best = grid
                    best_score = gscore.sum()
        return best

    grid = fill(cols, rows, False)
    if grid is None:
        grid = fill(cols, rows, True)
    if grid is None:
        return None
    # Canonical orientation: first corner is the lattice origin; OpenCV's
    # ordering convention (which end is first) is resolved by the caller via
    # the board pose, so normalize deterministically: top-left first.
    flat = grid.reshape(-1, 2)
    if flat[0, 1] > flat[-1, 1] or (flat[0, 1] == flat[-1, 1] and flat[0, 0] > flat[-1, 0]):
        flat = flat[::-1]
    return flat


class ChessboardResult(NamedTuple):
    corners: np.ndarray | None  # (rows*cols, 2) ordered, sub-pixel
    found: bool


def find_chessboard(gray, pattern_size: tuple[int, int], sigma: float = 2.0,
                    device=CUDA) -> ChessboardResult:
    """Response -> peaks -> sub-pixel -> grid ordering, for one gray image
    ``(H, W)`` (numpy or a tensor), computed on ``device`` (the card by
    default); the ordering runs on the host."""
    gray = torch.as_tensor(gray, dtype=torch.float32, device=resolve(device))
    n = pattern_size[0] * pattern_size[1]
    resp = saddle_response(gray, sigma)
    thresh = 0.15 * float(torch.max(resp))
    # A generous budget: board-outline junctions saddle too, and
    # order_grid's lattice-window search crops them away. 4 px cells: 8 px
    # cells merge the saddles of a small, distant board.
    peaks = find_peaks(resp, thresh, 9, n + 64, 6.0, cell=4)
    valid = peaks.valid.cpu().numpy()
    xy = peaks.xy.cpu().numpy()[valid]
    score = peaks.score.cpu().numpy()[valid]
    if xy.shape[0] < n:
        return ChessboardResult(None, False)
    # In a cluttered scene (the diameter-validation photo: a board beside
    # 65 markers) spurious saddles swamp the lattice estimate. True inner
    # corners respond strongest: score-ranked prefixes first, widening to
    # the full candidate set only as needed.
    order = np.argsort(-score)
    tried = set()
    for m in (n, n + 8, n + 24, xy.shape[0]):
        m = min(m, xy.shape[0])
        if m in tried:
            continue
        tried.add(m)
        sel = order[:m]
        refined = refine_subpixel(
            gray, torch.as_tensor(xy[sel], device=gray.device)).cpu().numpy()
        ordered = order_grid(refined, pattern_size, scores=score[sel])
        if ordered is not None:
            return ChessboardResult(ordered.astype(np.float64), True)
    return ChessboardResult(None, False)
