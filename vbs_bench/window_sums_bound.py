"""The least time of the window-sums kernel (K5, ``csrc/window_sums.cu``,
reading the three fields), frozen with the benchmark: the arithmetic of
``chip_smoke.py:sums_bound`` for its three-field mode, on the peaks, gated
pixel visits and distinct gated pixels that the reference counts
(``reference/unfused.py:window_stats``)."""
from __future__ import annotations

from vbs_bench import roofline

# A peak's bytes: its xy (8 B) and geometry (36 B) read, its 28 sums
# written (112 B).
PEAK_BYTES = 8 + 36 + 4 * 28
# A distinct gated pixel's bytes: read once from each of the three fields.
PIXEL_BYTES = 12
# Operations a patch row: the row's gated run of columns.
ROW_OPS = 51


def pixel_ops(soft_floor: float) -> int:
    """Operations a gated pixel visit: dx 1, lo/hi 2, weight 4 (sub, div,
    clamp), soft remap 4 (when ``soft_floor`` > 0), half level 1, 21
    products (band 2, area 5, w 9, half level 5), 26 sums."""
    return 1 + 2 + 4 + (4 if soft_floor > 0.0 else 0) + 1 + 21 + 26


def window_sums_bound_s(peaks: int, patch: int, soft_floor: float,
                        gated_visits: int, gated_pixels: int) -> float:
    """Least seconds of the window sums on ``peaks`` peaks (every slot of
    the batch, valid or not) with ``patch`` x ``patch`` windows, whose gated
    pixel visits and distinct gated pixels are given.

    Bytes: the distinct gated pixels read once (12 B from the three
    fields), each peak's xy (8 B) and geometry (36 B) read and its 28 sums
    written (112 B).
    Float32 operations, each shared product counted once:
      per patch row, 51 to find the row's gated run of columns (the cut
        is convex, so it meets a row in one run): 3 for the disk's ends,
        4 per halfplane, and the exact 18-op gate (dx, dy 2; d2 3; its
        test 1; 4 per halfplane) at both ends, so no other patch pixel
        needs a test;
      per gated pixel, 59 with a soft floor, 55 without (:func:`pixel_ops`).
    A few operations per peak (contrast, rhs slack) are left out."""
    nbytes = PIXEL_BYTES * gated_pixels + PEAK_BYTES * peaks
    nops = ROW_OPS * peaks * patch + pixel_ops(soft_floor) * gated_visits
    return roofline.bound_s(nbytes, nops)
