"""2D marker detection: batched frames -> fixed-size candidate sets.

Port of ``vision_basedsensor_tpu/detect/detector.py``. Every frame shape
takes the reference's fused branch (``detector.py:174-221``): DoG area mask
-> binary NCC -> fused field kernel (``ops/cuda/fields.py``) -> top-k over
cells -> Voronoi cut geometry -> window gather kernel
(``ops/cuda/moments.py``, paired when K is even and the patch is <= 64 px)
-> batched moment sums -> ``finalize`` and occlusion completion -> gates.
The CUDA kernels need no TPU alignment, so there is no XLA fallback branch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch.config import DetectConfig, DetectProfile
from vision_basedsensor_tpu_torch.core.imaging import to_grayscale
from vision_basedsensor_tpu_torch.ops.cuda.fields import fused_fields
from vision_basedsensor_tpu_torch.ops.cuda.moments import (gather_windows,
                                                           gather_windows_paired)
from vision_basedsensor_tpu_torch.ops.dog import dog_area_mask
from vision_basedsensor_tpu_torch.ops.moments import (
    complete_occluded,
    cut_geometry,
    finalize,
    moments_from_patches,
    moments_from_patches_paired,
    moments_from_patches_paired_mxu,
)
from vision_basedsensor_tpu_torch.ops.ncc import normxcorr_gaussian
from vision_basedsensor_tpu_torch.ops.peaks import select_peaks_from_cells


class Detections(NamedTuple):
    """Fixed-size per-frame candidate set (slots beyond ``valid`` are zero)."""
    xy: torch.Tensor      # (..., K, 2) sub-pixel centers (x, y)
    axes: torch.Tensor    # (..., K, 2) (major, minor) full axis lengths, px
    angle: torch.Tensor   # (..., K) major-axis angle, degrees in [0, 180)
    score: torch.Tensor   # (..., K) NCC peak score
    valid: torch.Tensor   # (..., K) bool
    occluded: torch.Tensor | None = None  # (..., K) bool: recovered by
    #                                       occlusion completion


def _finalize_candidates(sums: torch.Tensor, peaks, cfg: DetectConfig,
                         axis_scale: torch.Tensor | None = None
                         ) -> tuple[Detections, torch.Tensor]:
    """Candidate geometry + validity gates from the per-peak window sums."""
    fin = finalize(sums, peaks.xy, peaks.valid, axis_scale=axis_scale)
    center = fin.band_center if cfg.centroid_mode == "band" else fin.photo_center
    if cfg.diameter_mode == "mask":
        axes, angle = fin.area_axes, fin.area_angle
    else:
        axes, angle = fin.photo_axes, fin.photo_angle

    if cfg.occlusion_completion:
        o_center, o_axes, occluded = complete_occluded(
            fin, cfg.occlusion_min_ratio, cfg.occlusion_max_ratio,
            cfg.occlusion_min_skew)
        center = torch.where(occluded[..., None], o_center, center)
        axes = torch.where(occluded[..., None], o_axes, axes)
        angle = torch.where(occluded, torch.zeros_like(angle), angle)
    else:
        occluded = torch.zeros_like(peaks.valid)

    # Gates of the reference's per-contour checks: minor >= 5 px (:219),
    # centroid within minor/10 of the ellipse center (:225-234), non-empty
    # area region; occlusion-completed candidates skip the center match.
    ell_minor = fin.area_axes[..., 1]
    match_d2 = torch.sum((center - fin.area_center) ** 2, dim=-1)
    gate = (ell_minor / cfg.center_match_frac) ** 2
    size_ok = torch.where(occluded, axes[..., 1] >= cfg.min_minor_axis_px,
                          ell_minor >= cfg.min_minor_axis_px)
    valid = (peaks.valid & size_ok & (fin.area_m0 > 0.0)
             & ((match_d2 < gate) | occluded))

    def z(v):
        keep = valid[..., None] if v.ndim > valid.ndim else valid
        return torch.where(keep, v, torch.zeros_like(v))

    det = Detections(xy=z(center), axes=z(axes), angle=z(angle),
                     score=z(peaks.score), valid=valid,
                     occluded=valid & occluded)
    return det, fin.axis_scale


def detect_markers_and_scale(frames: torch.Tensor, cfg: DetectConfig,
                             profile: DetectProfile | None = None,
                             axis_scale: torch.Tensor | None = None
                             ) -> tuple[Detections, torch.Tensor]:
    """Like :func:`detect_markers` but also returns the photometric axis
    calibration scalar used (measured from this batch when ``axis_scale``
    is None)."""
    if cfg.fast_filters:
        raise NotImplementedError(
            "DetectConfig.fast_filters=True (bf16 filter matmuls) is not "
            "ported; use the default float32 filters")
    gray = to_grayscale(frames, cfg.channel_order)
    if profile is None:
        profile = (cfg.low_res if gray.shape[-2] <= cfg.low_res_max_rows
                   else cfg.high_res)
    squeeze = gray.ndim == 2
    if squeeze:
        gray = gray[None]

    area = dog_area_mask(gray, profile, cfg.dog_offset).float()
    ncc = normxcorr_gaussian(area, profile.template_size,
                             profile.template_sigma, binary_input=True)
    w = gray.shape[-1]
    packed, cval, cidx = fused_fields(ncc, area, gray.contiguous(),
                                      cfg.ncc_threshold, cfg.open_ksize,
                                      profile)
    peaks = select_peaks_from_cells(cval, cidx, w, cfg.max_candidates,
                                    float(profile.peak_window))
    geom = cut_geometry(peaks)
    # Paired windows (two peaks per 128-lane row) need an even K and a
    # patch that fits the 64-lane slot (detector.py:207).
    if cfg.max_candidates % 2 == 0 and profile.patch_size <= 64:
        patches, pstart = gather_windows_paired(packed, peaks, geom, profile)
        paired_fn = (moments_from_patches_paired_mxu if cfg.moment_mxu_basis
                     else moments_from_patches_paired)
        sums = paired_fn(patches, pstart, peaks, geom, profile, w)
    else:
        patches, pstart = gather_windows(packed, peaks, geom, profile)
        sums = moments_from_patches(patches, pstart, peaks, geom, profile, w)

    det, scale = _finalize_candidates(sums, peaks, cfg, axis_scale=axis_scale)
    if squeeze:
        det = Detections(*(x[0] for x in det))
    return det, scale


def detect_markers(frames: torch.Tensor, cfg: DetectConfig,
                   profile: DetectProfile | None = None,
                   axis_scale: torch.Tensor | None = None) -> Detections:
    """Detect markers in frames ``(B, H, W[, 3])`` (uint8 or float 0..255).
    The profile follows the frame height (``marker_detection.py:117``)."""
    return detect_markers_and_scale(frames, cfg, profile, axis_scale)[0]
