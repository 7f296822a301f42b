"""Canonical 65-marker dome layout.

A frozen copy of the port's module of the same name, plain PyTorch only."""
from __future__ import annotations

import numpy as np

# Number of markers per ring, center first. Rings 1..4 are full circles; ring 5
# is the 4 cardinal markers (reference ids 62-65).
RING_COUNTS = (1, 6, 12, 18, 24, 4)
NUM_MARKERS = sum(RING_COUNTS)  # 65
NUM_RINGS = len(RING_COUNTS) - 1  # rings excluding the center marker

# Planar (XY) radius of each ring in mm (ring 0 = center marker).
RING_RADII_MM = (0.0, 3.49, 6.92, 10.23, 13.37, 16.29)

# Height of each ring above the apex plane in mm (ring 0 = center marker).
RING_HEIGHTS_MM = (0.0, 0.23, 0.90, 2.01, 3.55, 5.47)

# Spherical dome radius consistent with the ring radii/heights; used by the
# synthetic renderer and deformation models, not by the id bijection.
DOME_RADIUS_MM = 27.0

# First-listed marker angle (deg, CCW from +X) and signed angular step for
# each ring, recovered from the reference table ordering (ids increase
# clockwise, i.e. with decreasing angle).
RING_START_DEG = (0.0, 150.0, 120.0, 130.0, 135.0, 90.0)
RING_STEP_DEG = (0.0, -60.0, -30.0, -20.0, -15.0, -90.0)

MARKER_DIAMETER_MM = 2.0  # physical marker diameter (extrinsic_calibration.py:42)


def ring_heights_mm() -> np.ndarray:
    """Height of each ring above the dome apex plane (mm)."""
    return np.asarray(RING_HEIGHTS_MM)


def _ring_base_ids() -> np.ndarray:
    """First marker_id (1-based) of each ring."""
    return np.concatenate([[1], 1 + np.cumsum(RING_COUNTS)[:-1]])


def dome_layout() -> np.ndarray:
    """Return the (65, 4) table ``[marker_id, X, Y, Z]`` in mm."""
    rows = []
    bases = _ring_base_ids()
    heights = ring_heights_mm()
    for ring, (count, radius) in enumerate(zip(RING_COUNTS, RING_RADII_MM)):
        for j in range(count):
            theta = np.deg2rad(RING_START_DEG[ring] + j * RING_STEP_DEG[ring])
            x = radius * np.cos(theta)
            y = radius * np.sin(theta)
            rows.append([bases[ring] + j, x, y, heights[ring]])
    out = np.asarray(rows, dtype=np.float64)
    # Normalize -0.0 from cos(90 deg) etc.
    out[:, 1:] += 0.0
    return out


