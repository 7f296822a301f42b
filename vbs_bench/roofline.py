"""Peaks of the card and the least time of a kernel's work, frozen with the
benchmark (the arithmetic of ``chip_smoke.py:_bound`` and of its fields and
gather bounds).

A kernel's roofline share is its least time over its measured time. The
least time is the larger of its bytes over the memory bandwidth and its
float32 operations over the float32 peak, each input byte counted read
once and each output byte written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
CELL = 8                      # the fields kernel's peak cell, px


def bound_s(nbytes: float, nops: float) -> float:
    """Least seconds for ``nbytes`` of memory traffic and ``nops`` float32
    operations."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S)


def fields_bound_s(b: int, h: int, w: int, band_window: int,
                   peak_window: int, open_ksize: int) -> float:
    """The fields kernel (K1/K2) on ``b`` frames of ``h`` x ``w``: ncc, area
    and gray read and the packed field written (16 B a pixel), each 8 x 8
    cell's peak value and index written (8 B); operations, the windowed
    min/max passes: 2 x (band + peak window) + 4 x open window + 8 a
    pixel."""
    hc, wc = -(-h // CELL), -(-w // CELL)
    ops_px = 2 * (band_window + peak_window) + 4 * open_ksize + 8
    return bound_s(b * h * w * 16 + b * hc * wc * 8, b * h * w * ops_px)


def gather_bound_s(b: int, k: int, patch: int, pack: int,
                   window_pixels: int) -> float:
    """The window gather (K3 with ``pack=2``, K4 with 1): the output
    ``(b, k / pack, patch, 128)`` float32 written and the ``window_pixels``
    distinct in-image pixels of the windows read (4 B each); a copy does no
    arithmetic."""
    return bound_s(b * (k // pack) * patch * 128 * 4 + 4 * window_pixels, 0.0)


def share_pct(bound: float, measured: float) -> float | None:
    """The roofline share in percent, or None where nothing was measured."""
    if measured <= 0.0:
        return None
    return 100.0 * bound / measured
