"""Per-peak window moment sums + finalization into marker candidates.

Port of ``vision_basedsensor_tpu/ops/moments.py``: the Voronoi cut geometry,
``window_sums_xla`` (the unfused branch's sums from patches of the three
fields, and the plain version of the window-sums kernel
``ops/cuda/window_sums.py``), the three batched moment backends over
gathered packed-field windows (``moments_from_patches`` for one window per
row, ``moments_from_patches_paired`` and the default
``moments_from_patches_paired_mxu`` for two windows per 128-lane row),
``finalize`` and the occlusion completion. The windows come from the CUDA
gather kernel (``ops/cuda/moments.py``).

Coordinates in the sums are relative to the peak; the 28-sum layout is the
reference's (see its module docstring):
  0-2 band [1, dx, dy]; 3-8 area [1, dx, dy, dx^2, dy^2, dxdy];
  9-14 soft weight w, same six; 15-20 half-level w >= 0.5, same six;
  21 min gray, 22 max gray, 23 count(cut); 24-27 w [dx^3, dx^2dy, dxdy^2, dy^3].
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from vision_basedsensor_tpu_torch.config import DetectProfile
from vision_basedsensor_tpu_torch.ops.patches import (extract_patches,
                                                      patch_coords)
from vision_basedsensor_tpu_torch.ops.peaks import Peaks

NUM_SUMS = 28
_INF = float("inf")


def soft_weight_remap(w: torch.Tensor, floor: float) -> torch.Tensor:
    """Symmetric floor/saturation remap ``[floor, 1-floor] -> [0, 1]`` of
    the soft weights; identity for ``floor <= 0``."""
    if floor <= 0.0:
        return w
    return torch.clamp((w - floor) * (1.0 / (1.0 - 2.0 * floor)), 0.0, 1.0)


class CutGeometry(NamedTuple):
    """Per-peak isolation geometry: radial cutoff + 3 halfplanes."""
    ex: torch.Tensor   # (..., K, 3) neighbor direction x
    ey: torch.Tensor   # (..., K, 3)
    rhs: torch.Tensor  # (..., K, 3) halfplane offsets (inf disables)


def cut_geometry(peaks: Peaks) -> CutGeometry:
    """Nearest-3-neighbor halfplane parameters for each peak, batched over
    leading axes. ``lax.top_k`` ties go to the lower index, hence the stable
    sort; missing halfplanes (fewer than 4 slots) are disabled."""
    xy = peaks.xy
    k = xy.shape[-2]
    lead = xy.shape[:-2]
    n_hp = min(3, max(k - 1, 0))
    if n_hp == 0:
        z = xy.new_zeros(lead + (k, 3))
        return CutGeometry(ex=z, ey=z, rhs=torch.full_like(z, _INF))
    pd2 = torch.sum((xy[..., :, None, :] - xy[..., None, :, :]) ** 2, dim=-1)
    eye = torch.eye(k, dtype=torch.bool, device=xy.device)
    pd2 = torch.where(eye | ~peaks.valid[..., None, :],
                      torch.full_like(pd2, _INF), pd2)
    nbr = torch.sort(-pd2, dim=-1, descending=True, stable=True)[1][..., :n_hp]
    expand = lead + (k, k)
    nx = torch.gather(xy[..., None, :, 0].expand(expand), -1, nbr)
    ny = torch.gather(xy[..., None, :, 1].expand(expand), -1, nbr)
    nok = torch.isfinite(torch.gather(pd2, -1, nbr))
    ex = nx - xy[..., :, None, 0]
    ey = ny - xy[..., :, None, 1]
    rhs = torch.where(nok, 0.5 * (ex * ex + ey * ey), torch.full_like(ex, _INF))
    pad = 3 - n_hp
    if pad:
        ex = torch.nn.functional.pad(ex, (0, pad))
        ey = torch.nn.functional.pad(ey, (0, pad))
        rhs = torch.nn.functional.pad(rhs, (0, pad), value=_INF)
        nok = torch.nn.functional.pad(nok, (0, pad))
    zero = torch.zeros((), dtype=ex.dtype, device=ex.device)
    return CutGeometry(ex=torch.where(nok, ex, zero),
                       ey=torch.where(nok, ey, zero), rhs=rhs)


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
    ``(..., H, W)`` around the peaks ``(..., K)``: the reference's
    ``window_sums_xla`` batched over frames, and the plain version of the
    window-sums kernel (``ops/cuda/window_sums.py``). Returns
    ``(..., K, NUM_SUMS)``.

    Every per-pixel value is the reference's float32 formula; the sums are
    taken in float64 and rounded to float32 once. At 1080x1920 the third
    moments reach ~4e6, and summing the same float32 terms in float32
    moves them by up to 0.25 against float64 (a rendered frame on the CPU),
    far above the 2e-2 the backends are held to; in float64 the kernel and
    this version agree to float32 rounding whatever their orders."""
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


def unpack_packed_field(packed: torch.Tensor):
    """Inverse of the fused field kernel's packing
    ``gray + 256*band + 512*area_open``. Returns ``(band, area, gray)``."""
    area = torch.floor(packed * (1.0 / 512.0))
    r = packed - 512.0 * area
    band = torch.floor(r * (1.0 / 256.0))
    return band, area, r - 256.0 * band


def _channels(patches, keep, profile: DetectProfile, *, vmin, vmax, expand):
    """Gated band/area masks, soft photometric weights, their half-level
    threshold and the cut, plus the per-window lo/hi scalars."""
    cut = keep.float()
    band, area, gray = unpack_packed_field(patches)
    b = band * cut
    a = area * cut
    lo = vmin(torch.where(keep, gray, torch.full_like(gray, _INF)))
    hi = vmax(torch.where(keep, gray, torch.full_like(gray, -_INF)))
    hi_e, lo_e = expand(hi), expand(lo)
    contrast = torch.clamp(hi_e - lo_e, min=1e-3)
    w = torch.clamp((hi_e - gray) / contrast, 0.0, 1.0)
    w = soft_weight_remap(w, profile.soft_floor) * cut
    wh = (w >= 0.5).float()
    return b, a, w, wh, cut, lo, hi


def _moment_stack(patches, dx, dy, keep, profile: DetectProfile, *,
                  red, vmin, vmax, expand) -> torch.Tensor:
    """The 28-sum construction shared by the plain and paired layouts."""
    b, a, w, wh, cut, lo, hi = _channels(patches, keep, profile, vmin=vmin,
                                         vmax=vmax, expand=expand)

    def m(v):
        return [red(v), red(v * dx), red(v * dy)]

    def m2(v):
        return [red(v * dx * dx), red(v * dy * dy), red(v * dx * dy)]

    def m3(v):
        return [red(v * dx * dx * dx), red(v * dx * dx * dy),
                red(v * dx * dy * dy), red(v * dy * dy * dy)]

    return torch.stack(m(b) + m(a) + m2(a) + m(w) + m2(w) + m(wh) + m2(wh)
                       + [lo, hi, red(cut)] + m3(w), dim=-1)


def moments_from_patches(patches: torch.Tensor, start: torch.Tensor,
                         peaks: Peaks, geom: CutGeometry,
                         profile: DetectProfile, width: int) -> torch.Tensor:
    """Moment sums from one-window-per-row patches ``(..., K, R, C)``
    (``ops/cuda/moments.py:gather_windows`` with ``pack=1``) with origins
    ``start`` ``(..., K, 2)``. Columns past ``width`` are gated out by
    coordinate. Output ``(..., K, NUM_SUMS)``."""
    r_, c_ = patches.shape[-2:]
    dev = patches.device
    cols = torch.arange(c_, dtype=torch.float32, device=dev)
    rows = torch.arange(r_, dtype=torch.float32, device=dev)
    sx = start[..., 0, None].float()
    dx = (sx - peaks.xy[..., 0, None] + cols)[..., None, :]           # (..., K, 1, C)
    dy = (start[..., 1, None].float() - peaks.xy[..., 1, None]
          + rows)[..., :, None]                                       # (..., K, R, 1)
    in_image = (sx + cols) < float(width)                             # (..., K, C)
    keep = ((dx * dx + dy * dy) <= profile.radial_cutoff_px ** 2) \
        & in_image[..., None, :]
    rhs = torch.clamp(geom.rhs, max=3e38)
    for j in range(3):
        keep = keep & ((dx * geom.ex[..., j, None, None]
                        + dy * geom.ey[..., j, None, None])
                       <= rhs[..., j, None, None] + 1e-3)
    return _moment_stack(
        patches, dx, dy, keep, profile,
        red=lambda v: torch.sum(v, dim=(-2, -1)),
        vmin=lambda v: torch.amin(v, dim=(-2, -1)),
        vmax=lambda v: torch.amax(v, dim=(-2, -1)),
        expand=lambda s: s[..., None, None])


def _paired_plumbing(patches, start, peaks, geom, profile: DetectProfile,
                     width: int):
    """Geometry, cut mask and slot-masked reductions of the paired layout:
    window ``2*k2 + j`` lives in lanes ``[64*j, 64*j + 64)`` of row ``k2``."""
    r_, c_ = patches.shape[-2:]
    if c_ != 128:
        raise ValueError(f"paired patches must have 128 lanes, got {c_}")
    k2 = patches.shape[-3]
    dev = patches.device
    lanes = torch.arange(c_, device=dev)
    local = (lanes % 64).float()                                      # lane-local col

    def lane_expand(q):      # (..., K) -> (..., K2, 128)
        return torch.repeat_interleave(
            q.reshape(*q.shape[:-1], k2, 2).float(), 64, dim=-1)

    sx_l = lane_expand(start[..., 0])
    offx = lane_expand(start[..., 0].float() - peaks.xy[..., 0])
    offy = lane_expand(start[..., 1].float() - peaks.xy[..., 1])
    dx = offx[..., None, :] + local                                   # (..., K2, 1, C)
    dy = offy[..., None, :] + torch.arange(
        r_, dtype=torch.float32, device=dev)[:, None]                 # (..., K2, R, C)

    in_image = (sx_l + local) < float(width)                          # (..., K2, C)
    keep = ((dx * dx + dy * dy) <= profile.radial_cutoff_px ** 2) \
        & in_image[..., None, :]
    rhs = torch.clamp(geom.rhs, max=3e38)
    for j in range(3):
        keep = keep & ((dx * lane_expand(geom.ex[..., j])[..., None, :]
                        + dy * lane_expand(geom.ey[..., j])[..., None, :])
                       <= lane_expand(rhs[..., j])[..., None, :] + 1e-3)
    slot0 = lanes < 64
    m0 = slot0.float()
    # Python scalars, not a tensor made here: a host-to-device copy makes
    # the host wait for the stream, so detect could not run ahead of its card.
    inf = _INF

    def interleave(s0, s1):  # (..., K2) x2 -> (..., K), window 2*k2+j
        return torch.stack([s0, s1], dim=-1).reshape(*s0.shape[:-1], 2 * k2)

    def red(v):
        return interleave(torch.sum(v * m0, dim=(-2, -1)),
                          torch.sum(v - v * m0, dim=(-2, -1)))

    def vmin(v):
        return interleave(torch.amin(torch.where(slot0, v, inf), dim=(-2, -1)),
                          torch.amin(torch.where(slot0, inf, v), dim=(-2, -1)))

    def vmax(v):
        return interleave(torch.amax(torch.where(slot0, v, -inf), dim=(-2, -1)),
                          torch.amax(torch.where(slot0, -inf, v), dim=(-2, -1)))

    def expand(s):
        return lane_expand(s)[..., None, :]

    return dx, dy, keep, red, vmin, vmax, expand


def moments_from_patches_paired(patches: torch.Tensor, start: torch.Tensor,
                                peaks: Peaks, geom: CutGeometry,
                                profile: DetectProfile,
                                width: int) -> torch.Tensor:
    """Paired-window sums ``(..., K, NUM_SUMS)`` from patches
    ``(..., K//2, R, 128)`` by masked elementwise reductions."""
    dx, dy, keep, red, vmin, vmax, expand = _paired_plumbing(
        patches, start, peaks, geom, profile, width)
    return _moment_stack(patches, dx, dy, keep, profile,
                         red=red, vmin=vmin, vmax=vmax, expand=expand)


def moments_from_patches_paired_mxu(patches: torch.Tensor,
                                    start: torch.Tensor, peaks: Peaks,
                                    geom: CutGeometry,
                                    profile: DetectProfile,
                                    width: int) -> torch.Tensor:
    """Raw-moment basis variant of :func:`moments_from_patches_paired` (the
    default, ``DetectConfig.moment_mxu_basis``): each channel's moments are
    two float32 matmuls against fixed polynomial bases over window-centred
    coordinates, then a per-window binomial shift to peak-relative
    moments. The third-moment basis spans ~3e4, so the matmuls must stay in
    full float32 (no TF32)."""
    _, _, keep, _, vmin, vmax, expand = _paired_plumbing(
        patches, start, peaks, geom, profile, width)
    b, a, w, wh, cut, lo, hi = _channels(patches, keep, profile, vmin=vmin,
                                         vmax=vmax, expand=expand)
    r_, c_ = patches.shape[-2:]
    k2 = patches.shape[-3]
    dev = patches.device

    rc = torch.arange(r_, dtype=torch.float32, device=dev) - (r_ - 1) / 2.0
    lanes = torch.arange(c_, device=dev)
    lc = (lanes % 64).float() - 31.5
    drow = torch.stack([torch.ones_like(rc), rc, rc * rc, rc * rc * rc])  # (4,R)
    cpow = torch.stack([torch.ones_like(lc), lc, lc * lc, lc * lc * lc],
                       dim=-1)                                            # (128,4)
    s0 = (lanes < 64).float()[:, None]
    dcol = torch.cat([cpow * s0, cpow * (1.0 - s0)], dim=-1)              # (128,8)

    def raw(v):
        """(..., K2, R, 128) -> (..., K, 4, 4) raw moments R[q][p] =
        sum v * rc^q * lc^p per 64-lane slot (window = 2*k2 + slot)."""
        m = torch.matmul(torch.matmul(drow, v), dcol)   # (..., K2, 4q, 8)
        m = m.reshape(*m.shape[:-1], 2, 4)              # (..., K2, 4q, 2s, 4p)
        m = torch.movedim(m, -2, -3)                    # (..., K2, 2s, 4q, 4p)
        return m.reshape(*m.shape[:-4], 2 * k2, 4, 4)

    ox = start[..., 0].float() - peaks.xy[..., 0] + 31.5
    oy = start[..., 1].float() - peaks.xy[..., 1] + (r_ - 1) / 2.0

    def shifted(R, orders):
        """Binomial shift of raw moments to peak-relative (dx, dy) moments
        for the requested ``(q, p)`` = (dy power, dx power) orders."""
        def r(q, p):
            return R[..., q, p]
        table = {
            (0, 0): lambda: r(0, 0),
            (0, 1): lambda: r(0, 1) + ox * r(0, 0),
            (1, 0): lambda: r(1, 0) + oy * r(0, 0),
            (0, 2): lambda: r(0, 2) + 2 * ox * r(0, 1) + ox * ox * r(0, 0),
            (2, 0): lambda: r(2, 0) + 2 * oy * r(1, 0) + oy * oy * r(0, 0),
            (1, 1): lambda: (r(1, 1) + ox * r(1, 0) + oy * r(0, 1)
                             + ox * oy * r(0, 0)),
            (0, 3): lambda: (r(0, 3) + 3 * ox * r(0, 2)
                             + 3 * ox * ox * r(0, 1) + ox ** 3 * r(0, 0)),
            (1, 2): lambda: (r(1, 2) + oy * r(0, 2) + 2 * ox * r(1, 1)
                             + 2 * ox * oy * r(0, 1) + ox * ox * r(1, 0)
                             + ox * ox * oy * r(0, 0)),
            (2, 1): lambda: (r(2, 1) + ox * r(2, 0) + 2 * oy * r(1, 1)
                             + 2 * ox * oy * r(1, 0) + oy * oy * r(0, 1)
                             + oy * oy * ox * r(0, 0)),
            (3, 0): lambda: (r(3, 0) + 3 * oy * r(2, 0)
                             + 3 * oy * oy * r(1, 0) + oy ** 3 * r(0, 0)),
        }
        return [table[qp]() for qp in orders]

    deg1 = [(0, 0), (0, 1), (1, 0)]                 # [sum, *dx, *dy]
    deg2 = [(0, 2), (2, 0), (1, 1)]                 # [*dx^2, *dy^2, *dx*dy]
    deg3 = [(0, 3), (1, 2), (2, 1), (3, 0)]         # [x^3, x^2 y, x y^2, y^3]
    rb, ra, rw, rwh, rcut = raw(b), raw(a), raw(w), raw(wh), raw(cut)
    return torch.stack(
        shifted(rb, deg1) + shifted(ra, deg1) + shifted(ra, deg2)
        + shifted(rw, deg1) + shifted(rw, deg2)
        + shifted(rwh, deg1) + shifted(rwh, deg2)
        + [lo, hi, shifted(rcut, [(0, 0)])[0]] + shifted(rw, deg3),
        dim=-1)


class Finalized(NamedTuple):
    band_center: torch.Tensor   # (..., K, 2)
    photo_center: torch.Tensor  # (..., K, 2)
    area_center: torch.Tensor   # (..., K, 2)
    area_axes: torch.Tensor     # (..., K, 2) major, minor
    area_angle: torch.Tensor    # (..., K)
    photo_axes: torch.Tensor    # (..., K, 2)
    photo_angle: torch.Tensor   # (..., K)
    area_m0: torch.Tensor       # (..., K)
    axis_scale: torch.Tensor    # () half/soft calibration scalar applied
    minor_dir: torch.Tensor     # (..., K, 2) minor-axis unit vector toward
    #                             positive skew
    skew: torch.Tensor          # (..., K) |standardized third moment|


def _degrees(x: torch.Tensor) -> torch.Tensor:
    return x * (180.0 / math.pi)


def _ellipse(m0, mx, my, mxx, myy, mxy):
    tot = torch.clamp(m0, min=1e-12)
    cx = mx / tot
    cy = my / tot
    vxx = mxx / tot - cx * cx
    vyy = myy / tot - cy * cy
    vxy = mxy / tot - cx * cy
    tr = vxx + vyy
    diff = vxx - vyy
    disc = torch.sqrt(torch.clamp(diff * diff + 4.0 * vxy * vxy, min=0.0))
    major = 4.0 * torch.sqrt(torch.clamp(0.5 * (tr + disc), min=0.0))
    minor = 4.0 * torch.sqrt(torch.clamp(0.5 * (tr - disc), min=0.0))
    angle = torch.remainder(_degrees(0.5 * torch.atan2(2.0 * vxy, diff)), 180.0)
    return torch.stack([cx, cy], -1), major, minor, angle


def nanmedian(x: torch.Tensor, dim: int | None = None,
              keepdim: bool = False) -> torch.Tensor:
    """``jnp.nanmedian``: the mean of the two middle values for an even
    count (``torch.nanmedian`` returns the lower one); NaN when every entry
    is NaN."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    srt = torch.sort(x, dim=dim).values            # NaN sorts last
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    lo = torch.gather(srt, dim, torch.clamp((n - 1) // 2, min=0))
    hi = torch.gather(srt, dim, torch.clamp(n // 2, max=x.shape[dim] - 1))
    med = torch.where(n > 0, 0.5 * lo + 0.5 * hi,
                      torch.full_like(lo, float("nan")))
    return med if keepdim else med.squeeze(dim)


def finalize(sums: torch.Tensor, peak_xy: torch.Tensor,
             valid: torch.Tensor | None = None,
             axis_scale: torch.Tensor | float | None = None) -> Finalized:
    """Closed-form candidate geometry from the window sums. ``axis_scale``
    pins the photometric axis calibration; with ``None`` it is the median
    half/soft major-axis ratio over ``valid`` candidates of this batch."""
    s = sums
    bc = torch.stack([s[..., 1], s[..., 2]], -1) / torch.clamp(s[..., 0:1], min=1e-12)
    ac, a_major, a_minor, a_angle = _ellipse(s[..., 3], s[..., 4], s[..., 5],
                                             s[..., 6], s[..., 7], s[..., 8])
    pc, p_major, p_minor, p_angle = _ellipse(s[..., 9], s[..., 10], s[..., 11],
                                             s[..., 12], s[..., 13], s[..., 14])
    _, h_major, _, _ = _ellipse(s[..., 15], s[..., 16], s[..., 17],
                                s[..., 18], s[..., 19], s[..., 20])

    if axis_scale is None:
        ok = (p_major > 1.0) & (h_major > 1.0)
        if valid is not None:
            ok = ok & valid
        ratio = torch.where(ok, h_major / torch.clamp(p_major, min=1e-9),
                            torch.full_like(p_major, float("nan")))
        scale = nanmedian(ratio)  # one scalar across the whole batch
        scale = torch.where(torch.isfinite(scale), torch.clamp(scale, 0.9, 1.05),
                            torch.ones_like(scale))
    elif isinstance(axis_scale, torch.Tensor):
        scale = axis_scale.to(p_major.device, p_major.dtype)
    else:
        # Filled on the device: a number sent from the host would wait for
        # the card (and cannot be captured in a CUDA graph).
        scale = torch.full((), float(axis_scale), dtype=p_major.dtype,
                           device=p_major.device)
    p_major = p_major * scale
    p_minor = p_minor * scale

    tot = torch.clamp(s[..., 9], min=1e-12)
    cx = s[..., 10] / tot
    cy = s[..., 11] / tot
    vxx = s[..., 12] / tot - cx * cx
    vyy = s[..., 13] / tot - cy * cy
    vxy = s[..., 14] / tot - cx * cy
    mu30 = s[..., 24] / tot - 3 * cx * (s[..., 12] / tot) + 2 * cx ** 3
    mu21 = (s[..., 25] / tot - 2 * cx * (s[..., 14] / tot)
            - cy * (s[..., 12] / tot) + 2 * cx * cx * cy)
    mu12 = (s[..., 26] / tot - 2 * cy * (s[..., 14] / tot)
            - cx * (s[..., 13] / tot) + 2 * cx * cy * cy)
    mu03 = s[..., 27] / tot - 3 * cy * (s[..., 13] / tot) + 2 * cy ** 3
    phi = 0.5 * torch.atan2(2.0 * vxy, vxx - vyy)   # major-axis angle
    ux = -torch.sin(phi)                             # minor-axis direction
    uy = torch.cos(phi)
    lam_u = torch.clamp((p_minor / (4.0 * scale)) ** 2, min=1e-12)
    mu3_u = (mu30 * ux ** 3 + 3 * mu21 * ux * ux * uy
             + 3 * mu12 * ux * uy * uy + mu03 * uy ** 3)
    flip = torch.sign(torch.where(mu3_u == 0, torch.ones_like(mu3_u), mu3_u))
    minor_dir = torch.stack([ux * flip, uy * flip], -1)
    skew = torch.abs(mu3_u) / lam_u ** 1.5

    return Finalized(
        band_center=bc + peak_xy, photo_center=pc + peak_xy,
        area_center=ac + peak_xy,
        area_axes=torch.stack([a_major, a_minor], -1), area_angle=a_angle,
        photo_axes=torch.stack([p_major, p_minor], -1), photo_angle=p_angle,
        area_m0=s[..., 3], axis_scale=scale, minor_dir=minor_dir, skew=skew)


@functools.lru_cache(maxsize=1)
def _occlusion_polys():
    """Censored-disk inversion as degree-7 polynomials in ``log(axis
    ratio)`` (host numpy, identical to the reference): returns float tuples
    (shift_coeffs, sqlv_coeffs), highest degree first, valid for ratio in
    [1.003, 8.43]."""
    trapz = getattr(np, "trapezoid", None) or np.trapz
    u = np.linspace(-1.0, 1.0, 4001)
    f = 2.0 * np.sqrt(np.clip(1.0 - u * u, 0.0, None))
    ss = np.linspace(-0.98, 0.92, 96)
    ratio, shift, sqrt_lv = [], [], []
    for s in ss:
        m = u >= s
        a = trapz(f[m], u[m])
        mu = trapz(u[m] * f[m], u[m]) / a
        lu = trapz((u[m] - mu) ** 2 * f[m], u[m]) / a
        lv = trapz((1.0 - u[m] ** 2) / 3.0 * f[m], u[m]) / a
        ratio.append(np.sqrt(lv / lu))
        shift.append(mu)
        sqrt_lv.append(np.sqrt(lv))
    x = np.log(np.asarray(ratio))
    return (tuple(float(c) for c in np.polyfit(x, shift, 7)),
            tuple(float(c) for c in np.polyfit(x, sqrt_lv, 7)))


def _horner(coeffs, x):
    acc = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def complete_occluded(fin: Finalized, min_ratio: float, max_ratio: float,
                      min_skew: float):
    """Recover center + diameter of partially occluded markers (censored
    disk: axis ratio in the window AND skew along the minor axis). Returns
    ``(center, axes, occluded)``; values where ``occluded`` is False are
    the uncorrected inputs."""
    c_shift, c_sqlv = _occlusion_polys()
    major = fin.photo_axes[..., 0]
    minor = torch.clamp(fin.photo_axes[..., 1], min=1e-6)
    ratio = major / minor
    occluded = ((ratio >= min_ratio) & (ratio <= max_ratio)
                & (fin.skew >= min_skew))

    x = torch.log(torch.clamp(ratio, 1.003, 8.43))
    sqrt_lv_meas = major / 4.0
    r_est = sqrt_lv_meas / _horner(c_sqlv, x)
    # photo_center is in raw pixels; r_est carries axis_scale.
    r_px = r_est / torch.clamp(fin.axis_scale, min=1e-6)
    shift = _horner(c_shift, x) * r_px
    center = fin.photo_center - fin.minor_dir * shift[..., None]
    d_est = 2.0 * r_est
    axes = torch.stack([d_est, d_est], -1)
    return (torch.where(occluded[..., None], center, fin.photo_center),
            torch.where(occluded[..., None], axes, fin.photo_axes),
            occluded)
