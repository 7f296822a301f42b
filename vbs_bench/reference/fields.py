"""The fields kernel's plain PyTorch version: NCC/area masks -> packed
band/opened/gray field and per-cell peaks (a frozen copy of the port's
``ops/cuda/fields.py:fused_fields_reference``).
"""
from __future__ import annotations

import torch

from vbs_bench.reference.config import DetectProfile
from vbs_bench.reference.imaging import (band_and_opening,
                                                       max_filter)
from vbs_bench.reference.peaks import cell_maxima

CELL = 8  # peak-cell size


def fused_fields_reference(ncc: torch.Tensor, area: torch.Tensor,
                           gray: torch.Tensor, threshold: float,
                           open_ksize: int, profile: DetectProfile):
    """Plain PyTorch version of the kernel (same outputs bit for bit)."""
    band, opened = band_and_opening(ncc, area, threshold,
                                    profile.band_window, open_ksize)
    packed = gray + 256.0 * band + 512.0 * opened
    lmax = max_filter(ncc, profile.peak_window)
    is_peak = (ncc >= lmax) & (ncc > threshold)
    sp = torch.where(is_peak, ncc, torch.full_like(ncc, -float("inf")))
    cval, cidx = cell_maxima(sp, CELL)
    return packed, cval, cidx
