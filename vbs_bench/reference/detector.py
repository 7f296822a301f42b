"""2D marker detection, the fused branch, in plain PyTorch (a frozen copy of
the port's ``detect/detector.py`` with the kernels' plain versions in their
place): DoG area mask -> binary NCC -> packed fields and cell peaks ->
top-k over cells -> Voronoi cut geometry -> window gather (paired when K is
even and the patch is <= 64 px) -> batched moment sums -> ``finalize``,
occlusion completion and the gates.

The benchmark's frames take the fused branch at both of its sizes
(:func:`takes_fused_branch`); another shape raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vbs_bench.reference.config import DetectConfig, DetectProfile
from vbs_bench.reference.fields import fused_fields_reference
from vbs_bench.reference.gather import (_prep, distinct_window_pixels,
                                        gather_windows_reference)
from vbs_bench.reference.imaging import to_grayscale
from vbs_bench.reference.dog import dog_area_mask
from vbs_bench.reference.moments import (
    complete_occluded,
    cut_geometry,
    finalize,
    moments_from_patches,
    moments_from_patches_paired,
    moments_from_patches_paired_mxu,
)
from vbs_bench.reference.ncc import normxcorr_gaussian
from vbs_bench.reference.peaks import select_peaks_from_cells

# The row-tiled field kernel's halo (vision_basedsensor_tpu's
# ops/pallas/fields.py:164), which the branch rule reads.
HALO = 8


def resolve_backend(cfg: DetectConfig, h: int, w: int,
                    profile: DetectProfile) -> str:
    """The reference's ``_resolve_backend`` (``detector.py:52-68``), except
    that ``"auto"`` means ``"pallas"`` on every device, so that the CPU and
    the card take the same branch."""
    backend = "pallas" if cfg.backend == "auto" else cfg.backend
    if backend == "pallas" and (w % 128 != 0 or w < 256 or h % 8 != 0
                                or h < profile.patch_size + 8):
        backend = "xla"
    return backend


def fits_fused(cfg: DetectConfig, h: int, w: int,
               profile: DetectProfile) -> bool:
    """The reference's ``fits_fused`` (``detector.py:170-173``): whole frames
    up to 960x1280, larger ones only when every window fits the halo."""
    return (h * w <= 960 * 1280
            or (profile.band_window // 2 <= HALO
                and profile.peak_window // 2 <= HALO
                and 2 * (cfg.open_ksize // 2) <= HALO))


def takes_fused_branch(cfg: DetectConfig, h: int, w: int,
                       profile: DetectProfile) -> bool:
    """Whether ``(h, w)`` frames take the fused branch."""
    return (resolve_backend(cfg, h, w, profile) == "pallas"
            and fits_fused(cfg, h, w, profile))


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
                             axis_scale: torch.Tensor | None = None,
                             stats: list | None = None
                             ) -> tuple[Detections, torch.Tensor]:
    """Like :func:`detect_markers` but also returns the photometric axis
    calibration scalar used (measured from this batch when ``axis_scale``
    is None). With ``stats``, appends the window gather's shape and its
    distinct in-image window pixels."""
    gray = to_grayscale(frames, cfg.channel_order)
    if profile is None:
        profile = (cfg.low_res if gray.shape[-2] <= cfg.low_res_max_rows
                   else cfg.high_res)
    squeeze = gray.ndim == 2
    if squeeze:
        gray = gray[None]

    # fast_filters: the filter GEMMs in bfloat16 with float32 accumulation
    # (detector.py:157-161 of the reference).
    fdt = torch.bfloat16 if cfg.fast_filters else None
    area = dog_area_mask(gray, profile, cfg.dog_offset, fdt).float()
    ncc = normxcorr_gaussian(area, profile.template_size,
                             profile.template_sigma, binary_input=True,
                             compute_dtype=fdt)
    gray = gray.contiguous()
    h, w = gray.shape[-2:]
    if not takes_fused_branch(cfg, h, w, profile):
        raise ValueError(f"{h}x{w} frames take the unfused branch, which this "
                         "reference does not hold")
    packed, cval, cidx = fused_fields_reference(ncc, area, gray,
                                                cfg.ncc_threshold,
                                                cfg.open_ksize, profile)
    peaks = select_peaks_from_cells(cval, cidx, w, cfg.max_candidates,
                                    float(profile.peak_window))
    geom = cut_geometry(peaks)
    # Paired windows (two peaks per 128-lane row) need an even K and a
    # patch that fits the 64-lane slot (detector.py:207).
    pack = 2 if cfg.max_candidates % 2 == 0 and profile.patch_size <= 64 else 1
    pstart = _prep(h, w, peaks, profile)
    patches = gather_windows_reference(packed, pstart, profile.patch_size, pack)
    if stats is not None:
        stats.append(dict(frames=int(gray.shape[0]), height=int(h),
                          width=int(w), pack=pack,
                          patch=profile.patch_size,
                          peaks=int(cfg.max_candidates),
                          window_pixels=distinct_window_pixels(
                              pstart, h, w, profile.patch_size, pack)))
    if pack == 2:
        paired_fn = (moments_from_patches_paired_mxu if cfg.moment_mxu_basis
                     else moments_from_patches_paired)
        sums = paired_fn(patches, pstart, peaks, geom, profile, w)
    else:
        sums = moments_from_patches(patches, pstart, peaks, geom, profile, w)

    det, scale = _finalize_candidates(sums, peaks, cfg, axis_scale=axis_scale)
    if squeeze:
        det = Detections(*(x[0] for x in det))
    return det, scale


def detect_markers(frames: torch.Tensor, cfg: DetectConfig,
                   profile: DetectProfile | None = None,
                   axis_scale: torch.Tensor | None = None,
                   stats: list | None = None) -> Detections:
    """Detect markers in frames ``(B, H, W[, 3])`` (uint8 or float 0..255).
    The profile follows the frame height (``marker_detection.py:117``)."""
    return detect_markers_and_scale(frames, cfg, profile, axis_scale,
                                    stats)[0]
