"""Canonical 65-marker dome layout and (ring, angle) <-> marker_id bijection.

A verbatim copy of ``vision_basedsensor_tpu/layout.py`` (pure numpy), kept
so that the port never imports the JAX package.

The reference embeds the marker table as literal data
(``code/ForceDistribution/ForceDistribution.py:29-95``): 65 markers arranged as
a center dot plus concentric rings of 6/12/18/24 markers and 4 cardinal
markers, at heights Z = 0 / 0.23 / 0.90 / 2.01 / 3.55 / 5.47 mm.

Here the layout is *generated* from the underlying geometry instead of being
embedded: markers sit at planar ring radii ``RING_RADII_MM`` and ring heights
``RING_HEIGHTS_MM``, with per-ring start angles and angular steps recovered
from the table's ordering. The rings are consistent with a spherical cap of
radius ~``DOME_RADIUS_MM = 27`` (z ~= R - sqrt(R^2 - r^2) holds for every ring
to ~0.01 mm), which the synthetic renderer uses as the bonnet surface model.
``dome_layout()`` matches the reference table to within its own 0.01 mm
quantization (max deviation 0.005 mm on round-half cases).

This module also owns the canonical identity bijection that the reference
leaves implicit (SURVEY.md §2.2 quirk 5): the 2D tracker keys markers by
``(ring, angle_index)`` while every downstream stage expects ``marker_id``
(1..65, the ForceDistribution numbering). ``ring_angle_to_id`` /
``id_to_ring_angle`` make that mapping explicit and testable.
"""
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


def dome_layout(round_to_reference: bool = False) -> np.ndarray:
    """Return the (65, 4) table ``[marker_id, X, Y, Z]`` in mm.

    With ``round_to_reference=True`` coordinates are rounded to 0.01 mm (the
    reference table's quantization); the result agrees with the reference's
    embedded table to <= 0.005 mm everywhere.
    """
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
    if round_to_reference:
        out[:, 1:] = np.round(out[:, 1:], 2) + 0.0
    return out


def marker_angles_deg() -> np.ndarray:
    """Nominal CCW angle (deg in (-180, 180]) of each marker; 0 for center."""
    table = dome_layout()
    ang = np.degrees(np.arctan2(table[:, 2], table[:, 1]))
    ang[0] = 0.0
    return ang


def marker_rings() -> np.ndarray:
    """Ring index (0 = center, 1..5) for each marker_id - 1."""
    return np.repeat(np.arange(len(RING_COUNTS)), RING_COUNTS)


def ring_angle_to_id(ring: np.ndarray, angle_deg: np.ndarray) -> np.ndarray:
    """Map (ring index, measured CCW angle in deg) -> canonical marker_id.

    ``ring`` is 0 for the center marker (angle ignored). For other rings the
    nearest nominal slot is selected, so moderately deformed first-frame
    angles still land on the correct id. Vectorized over leading dims.
    """
    ring = np.asarray(ring)
    angle_deg = np.asarray(angle_deg, dtype=np.float64)
    bases = _ring_base_ids()
    counts = np.asarray(RING_COUNTS)
    starts = np.asarray(RING_START_DEG)
    steps = np.asarray(RING_STEP_DEG)

    r = np.clip(ring, 0, NUM_RINGS)
    n = counts[r]
    step = np.where(r == 0, 1.0, steps[r])
    # Slot index along the ring's (clockwise) enumeration.
    j = np.round((angle_deg - starts[r]) / step).astype(np.int64)
    j = np.mod(j, n)
    out = np.where(r == 0, 1, bases[r] + j)
    return out.astype(np.int64)


def id_to_ring_angle(marker_id: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`ring_angle_to_id` on nominal positions."""
    marker_id = np.asarray(marker_id, dtype=np.int64)
    rings = marker_rings()[marker_id - 1]
    return rings, marker_angles_deg()[marker_id - 1]
