"""2D marker detection: batched frames -> fixed-size candidate sets.

Port of ``vision_basedsensor_tpu/detect/detector.py``: DoG area mask ->
binary NCC (``ops/cuda/filters.py``: two stencil kernels on the card), then
one of the reference's two branches, chosen by its rule
(:func:`takes_fused_branch`):

* fused (``detector.py:174-221``): fused field kernel
  (``ops/cuda/fields.py``) -> top-k over cells -> Voronoi cut geometry ->
  window gather kernel (``ops/cuda/moments.py``, paired when K is even and
  the patch is <= 64 px) -> batched moment sums;
* unfused (``:222-239``): band and opening by windowed min/max filters ->
  ``find_peaks`` (its peak field, cell maxima and ranking) -> cut geometry
  -> the window-sums kernel (``ops/cuda/window_sums.py``);

then ``finalize``, occlusion completion and the gates.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch.config import DetectConfig, DetectProfile
from vision_basedsensor_tpu_torch.core.imaging import (band_and_opening,
                                                       is_color)
from vision_basedsensor_tpu_torch.ops.cuda.fields import fused_fields
from vision_basedsensor_tpu_torch.ops.cuda.filters import filter_fields
from vision_basedsensor_tpu_torch.ops.cuda.moments import (gather_windows,
                                                           gather_windows_paired)
from vision_basedsensor_tpu_torch.ops.cuda.window_sums import window_sums
from vision_basedsensor_tpu_torch.ops.moments import (
    complete_occluded,
    cut_geometry,
    finalize,
    moments_from_patches,
    moments_from_patches_paired,
    moments_from_patches_paired_mxu,
)
from vision_basedsensor_tpu_torch.ops.peaks import (cell_maxima, peak_field,
                                                    select_peaks_from_cells)
from vision_basedsensor_tpu_torch.utils.graphs import replay
from vision_basedsensor_tpu_torch.utils.profiling import trace_annotation

# The reference's row-tiled field kernel halo (ops/pallas/fields.py:164).
# The port's fields kernel has no halo limit and its window kernels no
# alignment rule; the reference's dispatch is mirrored only so that every
# configuration and frame shape takes the branch the reference takes.
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
    """Candidate geometry + validity gates from the per-peak window sums
    (a CUDA graph on the card: ``utils/graphs.py``)."""
    return replay("detect.finalize", _finalize, sums, peaks, cfg, axis_scale)


def _finalize(sums: torch.Tensor, peaks, cfg: DetectConfig,
              axis_scale: torch.Tensor | None
              ) -> tuple[Detections, torch.Tensor]:
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
    with trace_annotation("vbs.detect"):
        return _detect(frames, cfg, profile, axis_scale)


def _detect(frames: torch.Tensor, cfg: DetectConfig,
            profile: DetectProfile | None,
            axis_scale: torch.Tensor | None
            ) -> tuple[Detections, torch.Tensor]:
    with trace_annotation("vbs.detect.filters"):
        color = is_color(frames)
        if profile is None:
            rows = frames.shape[-3] if color else frames.shape[-2]
            profile = (cfg.low_res if rows <= cfg.low_res_max_rows
                       else cfg.high_res)
        squeeze = frames.ndim == (3 if color else 2)
        if squeeze:
            frames = frames[None]

        # fast_filters: the filter GEMMs in bfloat16 with float32
        # accumulation (detector.py:157-161 of the reference).
        fdt = torch.bfloat16 if cfg.fast_filters else None
        gray, area, ncc = filter_fields(frames, profile, cfg.dog_offset,
                                        cfg.channel_order, fdt)
    h, w = gray.shape[-2:]
    if takes_fused_branch(cfg, h, w, profile):
        with trace_annotation("vbs.detect.fields"):
            packed, cval, cidx = fused_fields(ncc, area, gray,
                                              cfg.ncc_threshold,
                                              cfg.open_ksize, profile)
        with trace_annotation("vbs.detect.peaks"):
            peaks = select_peaks_from_cells(cval, cidx, w, cfg.max_candidates,
                                            float(profile.peak_window))
            geom = cut_geometry(peaks)
        # Paired windows (two peaks per 128-lane row) need an even K and a
        # patch that fits the 64-lane slot (detector.py:207).
        if cfg.max_candidates % 2 == 0 and profile.patch_size <= 64:
            with trace_annotation("vbs.detect.gather"):
                patches, pstart = gather_windows_paired(packed, peaks, geom,
                                                        profile)
            paired_fn = (moments_from_patches_paired_mxu
                         if cfg.moment_mxu_basis
                         else moments_from_patches_paired)
            with trace_annotation("vbs.detect.moments"):
                sums = paired_fn(patches, pstart, peaks, geom, profile, w)
        else:
            with trace_annotation("vbs.detect.gather"):
                patches, pstart = gather_windows(packed, peaks, geom, profile)
            with trace_annotation("vbs.detect.moments"):
                sums = moments_from_patches(patches, pstart, peaks, geom,
                                            profile, w)
    else:
        # detector.py:222-239. Both backends sum with the window-sums kernel
        # on the card (the reference's "pallas" would run K5 here, its
        # "xla" the same function unfused).
        with trace_annotation("vbs.detect.band_opening"):
            band, area_open = band_and_opening(ncc, area, cfg.ncc_threshold,
                                               profile.band_window,
                                               cfg.open_ksize)
        with trace_annotation("vbs.detect.peaks"):
            # find_peaks in its three steps, so that the windowed max field
            # has a span of its own.
            with trace_annotation("vbs.detect.peak_field"):
                field = peak_field(ncc, cfg.ncc_threshold, profile.peak_window)
            cmax, cflat = cell_maxima(field)
            peaks = select_peaks_from_cells(cmax, cflat, w, cfg.max_candidates,
                                            float(profile.peak_window))
            geom = cut_geometry(peaks)
        with trace_annotation("vbs.detect.window_sums"):
            sums = window_sums(band, area_open, gray, peaks, geom, profile)

    with trace_annotation("vbs.detect.finalize"):
        det, scale = _finalize_candidates(sums, peaks, cfg,
                                          axis_scale=axis_scale)
        if squeeze:
            det = Detections(*(x[0] for x in det))
    return det, scale


def detect_markers(frames: torch.Tensor, cfg: DetectConfig,
                   profile: DetectProfile | None = None,
                   axis_scale: torch.Tensor | None = None) -> Detections:
    """Detect markers in frames ``(B, H, W[, 3])`` (uint8 or float 0..255).
    The profile follows the frame height (``marker_detection.py:117``)."""
    return detect_markers_and_scale(frames, cfg, profile, axis_scale)[0]
