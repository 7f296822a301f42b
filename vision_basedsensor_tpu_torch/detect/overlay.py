"""Tracking-overlay rendering on frames (reference C9), host-side.

A verbatim copy of ``vision_basedsensor_tpu/detect/overlay.py``: numpy
inputs (or CPU tensors), so both packages draw the same pixels.

Draws what the reference's annotated output video shows
(``marker_detection.py:251-273, 398-427``): fitted ellipse (green), marker
center dot (red), displacement arrow frame-0 -> current (red), major axis
(yellow), minor axis (blue). Uses cv2 when present; otherwise a dependency-
free numpy rasterizer (lines/circles only) so annotated output works in
minimal environments.
"""
from __future__ import annotations

import math

import numpy as np

try:
    import cv2 as _cv2
except Exception:  # pragma: no cover
    _cv2 = None

_RED = (0, 0, 255)
_GREEN = (0, 255, 0)
_YELLOW = (0, 255, 255)
_BLUE = (255, 0, 0)


def _np_line(img, p1, p2, color, thickness=2):
    n = int(max(abs(p2[0] - p1[0]), abs(p2[1] - p1[1])) + 1)
    xs = np.linspace(p1[0], p2[0], n).round().astype(int)
    ys = np.linspace(p1[1], p2[1], n).round().astype(int)
    h, w = img.shape[:2]
    t = thickness // 2
    for dx in range(-t, t + 1):
        for dy in range(-t, t + 1):
            xi = np.clip(xs + dx, 0, w - 1)
            yi = np.clip(ys + dy, 0, h - 1)
            img[yi, xi] = color


def _np_circle(img, center, radius, color):
    h, w = img.shape[:2]
    y0, x0 = int(center[1]), int(center[0])
    rr = int(radius) + 1
    ys, xs = np.mgrid[max(0, y0 - rr):min(h, y0 + rr + 1),
                      max(0, x0 - rr):min(w, x0 + rr + 1)]
    mask = (ys - center[1]) ** 2 + (xs - center[0]) ** 2 <= radius**2
    img[ys[mask], xs[mask]] = color


def draw_tracking(frame: np.ndarray, tracked, t: int) -> np.ndarray:
    """Annotate one frame with the tracked marker state at frame index t."""
    img = frame.copy()
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    img = img.astype(np.uint8)

    xy = np.asarray(tracked.xy)[t]
    ref_xy = np.asarray(tracked.ref_xy)
    axes = np.asarray(tracked.axes)[t]
    angle = np.asarray(tracked.angle)[t]
    valid = np.asarray(tracked.valid)[t]

    for m in np.where(valid)[0]:
        cx, cy = xy[m]
        ox, oy = ref_xy[m]
        major, minor = axes[m]
        a = math.radians(angle[m])
        ca, sa = math.cos(a), math.sin(a)
        maj1 = (cx - major / 2 * ca, cy - major / 2 * sa)
        maj2 = (cx + major / 2 * ca, cy + major / 2 * sa)
        min1 = (cx + minor / 2 * sa, cy - minor / 2 * ca)
        min2 = (cx - minor / 2 * sa, cy + minor / 2 * ca)

        if _cv2 is not None:
            _cv2.ellipse(img, ((cx, cy), (major, minor), angle[m]), _GREEN, 2)
            _cv2.circle(img, (int(cx), int(cy)), 4, _RED, -1)
            _cv2.arrowedLine(img, (int(ox), int(oy)), (int(cx), int(cy)),
                             _RED, 2, tipLength=0.25)
            _cv2.line(img, tuple(map(int, maj1)), tuple(map(int, maj2)), _YELLOW, 2)
            _cv2.line(img, tuple(map(int, min1)), tuple(map(int, min2)), _BLUE, 2)
        else:
            _np_circle(img, (cx, cy), 4, _RED)
            _np_line(img, (ox, oy), (cx, cy), _RED)
            _np_line(img, maj1, maj2, _YELLOW)
            _np_line(img, min1, min2, _BLUE)
    return img
