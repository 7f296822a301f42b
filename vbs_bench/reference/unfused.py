"""2D marker detection, the unfused branch, in plain PyTorch: a frozen copy of
the port's plain path where its frames do not take the fused branch
(``backend="xla"``, a width not a multiple of 128, a height not a multiple
of 8): DoG area mask -> binary NCC -> band and opening by windowed min/max
filters -> ``find_peaks`` (the windowed max field, cell maxima, top-k and
distance suppression) -> Voronoi cut geometry -> the window sums of the
three fields -> ``finalize``, occlusion completion and the gates.

Copied from the port's ``detect/detector.py`` (its unfused branch),
``ops/peaks.py`` (``peak_field``, ``find_peaks``), ``ops/patches.py``
(``extract_patches``) and ``ops/moments.py`` (``patch_cut``,
``window_sums_xla``, the plain version of the window-sums kernel); the
filters, ``band_and_opening``, the cell maxima, the cut geometry and
``finalize`` are the other reference modules'. No departure from the
port's plain path.

:func:`detect_markers_and_scale` routes frames that take the fused branch
to the fused reference (``detector.py``), so one entry serves both.
"""
from __future__ import annotations

import torch

from vbs_bench.reference import detector as fused
from vbs_bench.reference.config import DetectConfig, DetectProfile
from vbs_bench.reference.detector import (Detections, _finalize_candidates,
                                          takes_fused_branch)
from vbs_bench.reference.dog import dog_area_mask
from vbs_bench.reference.imaging import (band_and_opening, max_filter,
                                         to_grayscale)
from vbs_bench.reference.moments import (_INF, CutGeometry, cut_geometry,
                                         soft_weight_remap)
from vbs_bench.reference.ncc import normxcorr_gaussian
from vbs_bench.reference.patches import patch_coords, patch_origins
from vbs_bench.reference.peaks import (Peaks, cell_maxima,
                                       select_peaks_from_cells)


def peak_field(score: torch.Tensor, threshold: float,
               window: int) -> torch.Tensor:
    """``score`` where it equals its ``window`` local maximum and exceeds
    ``threshold``, else -inf: the field whose cell maxima are the peaks."""
    local_max = max_filter(score, window)
    is_peak = (score >= local_max) & (score > threshold)
    return torch.where(is_peak, score, torch.full_like(score, -float("inf")))


def find_peaks(score: torch.Tensor, threshold: float, window: int,
               max_peaks: int, min_distance: float, cell: int = 8) -> Peaks:
    """Up to ``max_peaks`` local maxima of ``score`` ``(..., H, W)``: pixels
    equal to their ``window`` local maximum and above ``threshold``, the
    best of each ``cell x cell`` tile, ranked and distance-suppressed."""
    cmax, cflat = cell_maxima(peak_field(score, threshold, window), cell)
    return select_peaks_from_cells(cmax, cflat, score.shape[-1], max_peaks,
                                   min_distance)


def extract_patches(img: torch.Tensor, centers_xy: torch.Tensor, patch: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``patch x patch`` windows of ``img`` ``(..., H, W)`` centred on
    ``centers_xy`` ``(..., K, 2)`` (x, y), clamped inside the frame. Returns
    ``(patches (..., K, P, P), start_xy (..., K, 2) float32)``."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    start = patch_origins(h, w, centers_xy, patch).long()
    r = torch.arange(patch, device=img.device)
    ys = start[..., 1, None, None] + r[:, None]                 # (..., K, P, 1)
    xs = start[..., 0, None, None] + r[None, :]                 # (..., K, 1, P)
    flat = (ys * w + xs).flatten(len(lead))                     # (..., K*P*P)
    vals = torch.gather(img.reshape(*lead, h * w), -1, flat)
    return vals.reshape(start.shape[:-1] + (patch, patch)), start.float()


def patch_cut(start: torch.Tensor, peaks: Peaks, geom: CutGeometry,
              profile: DetectProfile):
    """Global coordinates ``(gx, gy)``, peak-relative ``(dx, dy)`` and the
    cut (radial cutoff and three halfplanes) of every pixel of the
    ``patch_size`` patches at ``start`` ``(..., K, 2)``, each
    ``(..., K, P, P)``."""
    gx, gy = patch_coords(start, profile.patch_size)
    dx = gx - peaks.xy[..., 0, None, None]
    dy = gy - peaks.xy[..., 1, None, None]
    d2 = dx * dx + dy * dy
    keep = d2 <= profile.radial_cutoff_px ** 2
    for j in range(3):
        lhs = (dx * geom.ex[..., j, None, None]
               + dy * geom.ey[..., j, None, None])
        keep = keep & (lhs <= geom.rhs[..., j, None, None] + 1e-3)
    return gx, gy, dx, dy, keep


def window_sums_xla(band: torch.Tensor, area: torch.Tensor,
                    gray: torch.Tensor, peaks: Peaks, geom: CutGeometry,
                    profile: DetectProfile) -> torch.Tensor:
    """Window sums from ``patch_size`` patches of the three fields
    ``(..., H, W)`` around the peaks ``(..., K)``. Returns
    ``(..., K, NUM_SUMS)``.

    Every per-pixel value is the float32 formula; the sums are taken in
    float64 and rounded to float32 once (summing the same float32 terms in
    float32 moves the 1080x1920 third moments by up to 0.25)."""
    p = profile.patch_size
    b_patch, start = extract_patches(band, peaks.xy, p)
    a_patch, _ = extract_patches(area, peaks.xy, p)
    g_patch, _ = extract_patches(gray, peaks.xy, p)
    _, _, dx, dy, keep = patch_cut(start, peaks, geom, profile)
    cut = keep.float()

    def flat(v):
        return v.reshape(*v.shape[:-2], p * p)

    fx, fy, c = flat(dx), flat(dy), flat(cut)
    fb, fa, fg = flat(b_patch) * c, flat(a_patch) * c, flat(g_patch)

    inside = c > 0
    lo = torch.amin(torch.where(inside, fg, torch.full_like(fg, _INF)), dim=-1)
    hi = torch.amax(torch.where(inside, fg, torch.full_like(fg, -_INF)), dim=-1)
    contrast = torch.clamp(hi - lo, min=1e-3)
    w = torch.clamp((hi[..., None] - fg) / contrast[..., None], 0.0, 1.0)
    w = soft_weight_remap(w, profile.soft_floor) * c
    wh = (w >= 0.5).float()

    def red(v):
        return v.double().sum(-1)

    def m(v):
        return [red(v), red(v * fx), red(v * fy)]

    def m2(v):
        return [red(v * fx * fx), red(v * fy * fy), red(v * fx * fy)]

    def m3(v):
        return [red(v * fx * fx * fx), red(v * fx * fx * fy),
                red(v * fx * fy * fy), red(v * fy * fy * fy)]

    return torch.stack(
        m(fb) + m(fa) + m2(fa) + m(w) + m2(w) + m(wh) + m2(wh)
        + [lo.double(), hi.double(), red(c)] + m3(w), dim=-1).float()


def window_stats(peaks: Peaks, geom: CutGeometry, profile: DetectProfile,
                 h: int, w: int) -> tuple[int, int]:
    """The window sums' gated pixel visits (a pixel once for each window
    whose cut keeps it) and distinct gated pixels (once a frame), over the
    ``(B, K)`` peaks of ``(h, w)`` frames: what the window-sums kernel's
    bound counts (``vbs_bench/window_sums_bound.py``)."""
    start = patch_origins(h, w, peaks.xy, profile.patch_size)
    gx, gy, _, _, keep = patch_cut(start.float(), peaks, geom, profile)
    b = peaks.xy.shape[0]
    flat = torch.where(keep, gy.long() * w + gx.long(),
                       torch.full_like(keep, h * w, dtype=torch.long))
    mask = torch.zeros((b, h * w + 1), dtype=torch.bool, device=keep.device)
    mask.scatter_(1, flat.reshape(b, -1), True)
    return int(keep.sum()), int(mask[:, :h * w].sum())


def detect_markers_and_scale(frames: torch.Tensor, cfg: DetectConfig,
                             profile: DetectProfile | None = None,
                             axis_scale: torch.Tensor | None = None,
                             stats: list | None = None
                             ) -> tuple[Detections, torch.Tensor]:
    """Detections of frames ``(B, H, W[, 3])`` and the photometric axis
    calibration scalar used (measured from this batch when ``axis_scale``
    is None), on the branch the frames take. With ``stats``, the unfused
    branch appends the window sums' shape, gated pixel visits and distinct
    gated pixels (:func:`window_stats`); the fused one its window gather's
    (``detector.py``)."""
    gray = to_grayscale(frames, cfg.channel_order)
    if profile is None:
        profile = (cfg.low_res if gray.shape[-2] <= cfg.low_res_max_rows
                   else cfg.high_res)
    h, w = gray.shape[-2:]
    if takes_fused_branch(cfg, h, w, profile):
        return fused.detect_markers_and_scale(frames, cfg, profile,
                                              axis_scale, stats)
    squeeze = gray.ndim == 2
    if squeeze:
        gray = gray[None]

    fdt = torch.bfloat16 if cfg.fast_filters else None
    area = dog_area_mask(gray, profile, cfg.dog_offset, fdt).float()
    ncc = normxcorr_gaussian(area, profile.template_size,
                             profile.template_sigma, binary_input=True,
                             compute_dtype=fdt)
    gray = gray.contiguous()
    band, area_open = band_and_opening(ncc, area, cfg.ncc_threshold,
                                       profile.band_window, cfg.open_ksize)
    peaks = find_peaks(ncc, cfg.ncc_threshold, profile.peak_window,
                       cfg.max_candidates, float(profile.peak_window))
    geom = cut_geometry(peaks)
    sums = window_sums_xla(band, area_open, gray, peaks, geom, profile)
    if stats is not None:
        visits, distinct = window_stats(peaks, geom, profile, h, w)
        stats.append(dict(frames=int(gray.shape[0]), height=int(h),
                          width=int(w), patch=profile.patch_size,
                          peaks=int(cfg.max_candidates),
                          soft_floor=float(profile.soft_floor),
                          gated_visits=visits, gated_pixels=distinct))

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
