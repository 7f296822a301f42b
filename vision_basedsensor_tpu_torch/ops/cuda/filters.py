"""The detector's float32 filter front end on the card: gray, the DoG area
mask and the binary NCC as separable stencils.

``csrc/filters.cu`` computes ``core/imaging.py:to_grayscale`` ->
``ops/dog.py:dog_area_mask`` -> ``ops/ncc.py:normxcorr_gaussian``
(``binary_input=True``) in two launches, with only the nonzero taps of the
band matrices that the plain version multiplies (``core/imaging.py:
_band_matrix_np``), each output summed in ascending source index from 0 as
the plain version's float32 GEMMs sum it: the same bits. The plain version
is those three functions (:func:`dog_fields_reference`,
:func:`binary_ncc_reference`, :func:`filter_fields_reference`).

Dispatch: a CUDA tensor with no ``compute_dtype`` launches the kernels or
raises; a CPU tensor, or ``fast_filters``' bfloat16 (whose rounding is the
bfloat16 GEMMs'), takes the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vision_basedsensor_tpu_torch.config import DetectProfile
from vision_basedsensor_tpu_torch.core.imaging import (_band_matrix_np,
                                                       gaussian_taps, is_color,
                                                       to_grayscale)
from vision_basedsensor_tpu_torch.ops.cuda import build
from vision_basedsensor_tpu_torch.ops.dog import dog_area_mask
from vision_basedsensor_tpu_torch.ops.ncc import normxcorr_gaussian

MIN_VARIANCE = 0.5   # ops/ncc.py:normxcorr_gaussian's default
TINY = 1e-12         # its clamp of the denominator

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
filters_launches = 0


class _Pass(ctypes.Structure):
    """``VbsPass`` of ``csrc/filters.cu``: one pass's table on the card."""
    _fields_ = [("j0", ctypes.c_void_p), ("dense", ctypes.c_void_p),
                ("n", ctypes.c_int), ("L", ctypes.c_int),
                ("in_lo", ctypes.c_int), ("in_hi", ctypes.c_int)]


def _interior(T: np.ndarray, k: int):
    """``(taps, in_lo, in_hi)``: the entries of the rows of band matrix ``T``
    whose nonzero span is the whole window at ``i - (k - 1) // 2``, and the
    range ``[in_lo, in_hi)`` of exactly those rows (empty: zeros, 0, 0)."""
    n, lo = T.shape[0], (k - 1) // 2
    nz = T != 0
    first = nz.argmax(1)
    last = n - 1 - nz[:, ::-1].argmax(1)
    rows = np.flatnonzero((first == np.arange(n) - lo)
                          & (last - first == k - 1))
    if rows.size == 0:
        return np.zeros(k, np.float32), 0, 0
    taps = T[rows[rows.size // 2], rows[rows.size // 2] - lo:][:k]
    same = [i for i in rows if np.array_equal(T[i, i - lo:i - lo + k], taps)]
    if same != list(range(same[0], same[-1] + 1)):
        raise ValueError(f"pass_table: the interior rows of a {k}-tap band "
                         f"matrix over {n} samples are not contiguous")
    return np.ascontiguousarray(taps, np.float32), same[0], same[-1] + 1


@functools.lru_cache(maxsize=64)
def pass_table(taps_a: tuple, taps_b: tuple, n: int, mode: str):
    """One pass of two filters over ``n`` samples as the kernels read it:
    the band matrices ``_band_matrix_np(taps, n, mode)`` in groups of 4
    outputs (rows).

    Returns ``(j0, dense, interior_a, interior_b, (in_lo, in_hi))``: group
    ``g`` (rows ``4g..4g+3``) reads sources ``j0[g] .. j0[g] + L - 1``, and
    ``dense[g, j]`` holds filter a's entries of its 4 rows at source
    ``j0[g] + j``, then filter b's (float32 ``(G, L, 8)``; rows past ``n``
    are zero). ``L`` is the widest group's span of both matrices' nonzero
    entries, and ``j0[g] <= n - L``. Rows ``[in_lo, in_hi)`` of both
    matrices are their interior rows, whose entries are ``interior_a`` and
    ``interior_b`` from ``i - (k - 1) // 2``."""
    Ts = [_band_matrix_np(t, n, mode) for t in (taps_a, taps_b)]
    g = -(-n // 4)
    rows = np.arange(4 * g).reshape(g, 4)
    nz = np.zeros((4 * g, n), bool)
    nz[:n] = (Ts[0] != 0) | (Ts[1] != 0)
    any_g = nz.reshape(g, 4, n).any(1)
    first = any_g.argmax(1)
    last = n - 1 - any_g[:, ::-1].argmax(1)
    L = int((last - first).max()) + 1
    j0 = np.minimum(first, n - L)
    cols = j0[:, None] + np.arange(L)                        # (G, L)
    dense = np.zeros((g, L, 8), np.float32)
    for f, T in enumerate(Ts):
        pad = np.zeros((4 * g, n), np.float32)
        pad[:n] = T
        dense[:, :, 4 * f:4 * f + 4] = pad[rows[:, None, :], cols[:, :, None]]
    (ta, lo_a, hi_a), (tb, lo_b, hi_b) = (
        _interior(T, len(t)) for T, t in zip(Ts, (taps_a, taps_b)))
    lo, hi = max(lo_a, lo_b), min(hi_a, hi_b)
    return (j0.astype(np.int32), dense, ta, tb,
            (lo, hi) if lo < hi else (0, 0))


@functools.lru_cache(maxsize=64)
def _device_table(taps_a: tuple, taps_b: tuple, n: int, mode: str,
                  device: torch.device):
    """:func:`pass_table` with ``j0`` and ``dense`` on ``device``, cached per
    device like ``core/imaging.py:_band_matrix``, so that detect never
    waits for the card once they are there."""
    j0, dense, ta, tb, (lo, hi) = pass_table(taps_a, taps_b, n, mode)
    return (torch.from_numpy(j0).to(device),
            torch.from_numpy(dense).to(device), dense.shape[1], ta, tb, lo,
            hi)


def _passes(device, h: int, w: int, taps_a, taps_b, mode: str):
    """The ``VbsPass`` pair (H pass, W pass) of two filters and their
    interior taps (the cached tables outlive the launch)."""
    key = (tuple(float(t) for t in taps_a), tuple(float(t) for t in taps_b))
    tables = [_device_table(*key, n, mode, device) for n in (h, w)]
    arr = (_Pass * 2)(*(_Pass(j0.data_ptr(), dense.data_ptr(), n, L, lo, hi)
                        for n, (j0, dense, L, _, _, lo, hi)
                        in zip((h, w), tables)))
    return arr, tables[0][3], tables[0][4]


def _launch(fn, what: str, device: torch.device, *args) -> None:
    global filters_launches
    with torch.cuda.device(device):   # build.py: launches go to it
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    build.check(err, f"{what} kernel launch")
    filters_launches += 1


def dog_fields_reference(frames: torch.Tensor, profile: DetectProfile,
                         offset: int = 15, channel_order: str = "bgr",
                         compute_dtype: torch.dtype | None = None):
    """The plain version of :func:`dog_fields` on any device:
    ``to_grayscale`` -> ``dog_area_mask`` (the banded GEMMs on the card);
    ``(gray, area, None)``."""
    gray = to_grayscale(frames, channel_order).contiguous()
    return gray, dog_area_mask(gray, profile, offset,
                               compute_dtype).float(), None


def binary_ncc_reference(area: torch.Tensor, profile: DetectProfile,
                         compute_dtype: torch.dtype | None = None,
                         mean: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of :func:`binary_ncc` on any device, which counts
    the mask itself where ``mean`` is not given."""
    return normxcorr_gaussian(area, profile.template_size,
                              profile.template_sigma, binary_input=True,
                              compute_dtype=compute_dtype, mean=mean)


def filter_fields_reference(frames: torch.Tensor, profile: DetectProfile,
                            offset: int = 15, channel_order: str = "bgr",
                            compute_dtype: torch.dtype | None = None):
    """The plain version of :func:`filter_fields` on any device."""
    gray, area, _ = dog_fields_reference(frames, profile, offset,
                                         channel_order, compute_dtype)
    return gray, area, binary_ncc_reference(area, profile, compute_dtype)


def dog_fields(frames: torch.Tensor, profile: DetectProfile, offset: int = 15,
               channel_order: str = "bgr",
               compute_dtype: torch.dtype | None = None):
    """Gray frames and the DoG area mask of frames ``(B, H, W)`` or, in
    color, ``(B, H, W, 3)``: ``(gray, area, count)``, ``gray`` and ``area``
    float32 ``(B, H, W)`` contiguous (``area`` 0/1) and ``count`` each
    frame's mask count, int32 ``(B,)`` from the kernel (None from the plain
    version, whose NCC counts for itself).

    On the card the frames are uint8 or float32 with unit column stride
    (rows may be strided, as a crop's are); color frames go through
    ``to_grayscale`` first. ``B`` is at most 65,535."""
    if frames.device.type != "cuda" or compute_dtype is not None:
        return dog_fields_reference(frames, profile, offset, channel_order,
                                    compute_dtype)
    if is_color(frames):
        frames = to_grayscale(frames, channel_order)
    if frames.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"dog_fields: frames must be uint8 or float32, got "
                        f"{frames.dtype}")
    if frames.ndim != 3:
        raise ValueError(f"dog_fields: expected (B, H, W), got "
                         f"{tuple(frames.shape)}")
    if frames.stride(-1) != 1:
        raise ValueError("dog_fields: frames must have unit column stride")
    b, h, w = frames.shape
    dev = frames.device
    gray = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    area = torch.empty_like(gray)
    count = torch.zeros(b, dtype=torch.int32, device=dev)
    if b == 0:
        return gray, area, count
    small = gaussian_taps(profile.blur_small_ksize, profile.blur_small_sigma)
    large = gaussian_taps(profile.blur_large_ksize, profile.blur_large_sigma)
    if len(small) > len(large):
        raise ValueError("dog_fields: the small blur is wider than the large")
    passes, ts, tl = _passes(dev, h, w, small, large, "reflect101")
    _launch(build.library().vbs_dog_fields, "dog_fields", dev,
            frames.data_ptr(), int(frames.dtype == torch.uint8),
            frames.stride(0), frames.stride(1), gray.data_ptr(),
            area.data_ptr(), count.data_ptr(), b, h, w,
            ctypes.addressof(passes), len(small), ts.ctypes.data, len(large),
            tl.ctypes.data, int(offset), float(profile.dog_threshold),
            float(profile.dog_high))
    return gray, area, count


def _check(name: str, x: torch.Tensor, dtype, device, numel=None) -> None:
    if x.dtype != dtype:
        raise TypeError(f"binary_ncc: {name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"binary_ncc: {name} is on {x.device}, area on "
                         f"{device}")
    if not x.is_contiguous():
        raise ValueError(f"binary_ncc: {name} must be contiguous")
    if numel is not None and x.numel() != numel:
        raise ValueError(f"binary_ncc: {name} has {x.numel()} entries, "
                         f"expected {numel}")


def binary_ncc(area: torch.Tensor, profile: DetectProfile,
               compute_dtype: torch.dtype | None = None,
               count: torch.Tensor | None = None,
               mean: torch.Tensor | None = None) -> torch.Tensor:
    """``normxcorr_gaussian(area, template_size, template_sigma,
    binary_input=True, mean=mean)`` of a 0/1 mask ``(B, H, W)``.

    On the card ``area`` is float32 and contiguous, and exactly one of
    ``count`` and ``mean`` gives the frame's mean: ``count``
    (:func:`dog_fields`' int32 mask counts) over ``H * W``, or ``mean``
    (``B`` float32 values, a row shard's whole-frame mean)."""
    if area.device.type != "cuda" or compute_dtype is not None:
        return binary_ncc_reference(area, profile, compute_dtype, mean=mean)
    dev = area.device
    _check("area", area, torch.float32, dev)
    if area.ndim != 3:
        raise ValueError(f"binary_ncc: expected (B, H, W), got "
                         f"{tuple(area.shape)}")
    b, h, w = area.shape
    if (count is None) == (mean is None):
        raise ValueError("binary_ncc: give exactly one of count and mean")
    if mean is not None:
        _check("mean", mean, torch.float32, dev, b)
    else:
        _check("count", count, torch.int32, dev, b)
    ncc = torch.empty_like(area)
    if b == 0:
        return ncc
    k = profile.template_size
    g = gaussian_taps(k, profile.template_sigma)
    passes, tg, tbox = _passes(dev, h, w, g, np.ones(k), "zero")
    g2d = np.outer(g, g)
    t0_energy = float(np.sum((g2d - np.mean(g2d)) ** 2))   # as ops/ncc.py
    one = np.float32(1.0)
    _launch(build.library().vbs_binary_ncc, "binary_ncc", dev,
            area.data_ptr(), ncc.data_ptr(),
            None if count is None else count.data_ptr(),
            None if mean is None else mean.data_ptr(), b, h, w,
            ctypes.addressof(passes), k, tg.ctypes.data, tbox.ctypes.data,
            float(one / np.float32(h * w)), float(one / np.float32(k * k)),
            t0_energy, MIN_VARIANCE, TINY)
    return ncc


def filter_fields(frames: torch.Tensor, profile: DetectProfile,
                  offset: int = 15, channel_order: str = "bgr",
                  compute_dtype: torch.dtype | None = None):
    """The detector's filter front end of frames ``(B, H, W[, 3])``:
    ``(gray, area, ncc)``, float32 ``(B, H, W)``."""
    gray, area, count = dog_fields(frames, profile, offset, channel_order,
                                   compute_dtype)
    return gray, area, binary_ncc(area, profile, compute_dtype, count=count)
