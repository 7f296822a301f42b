"""Fused global field kernel: NCC/area masks -> band, opened area, cell peaks.

Port of ``vision_basedsensor_tpu/ops/pallas/fields.py``: ``fused_fields``
(whole frame, K1) and ``_fused_fields_tiled`` (row-tiled above 960x1280,
K2) become one hand-written CUDA kernel, ``csrc/fields.cu``, that serves
any H and W (no TPU alignment rules). :func:`fused_fields_reference` is its
plain PyTorch version.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from vision_basedsensor_tpu_torch.config import DetectProfile
from vision_basedsensor_tpu_torch.core.imaging import (band_and_opening,
                                                       max_filter)
from vision_basedsensor_tpu_torch.ops.cuda import build
from vision_basedsensor_tpu_torch.ops.peaks import cell_maxima

CELL = 8  # peak-cell size
MAX_HALO = 24  # widest window reach the kernel takes (csrc/fields.cu)

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
fields_launches = 0


def halo(profile: DetectProfile, open_ksize: int) -> int:
    """Halo the kernel's tiles need: the widest window reach, where the
    opening reaches twice (erosion, then dilation)."""
    return max(profile.band_window // 2, profile.peak_window // 2,
               2 * (int(open_ksize) // 2))


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


def _check(name: str, x: torch.Tensor, shape) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"fused_fields: {name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"fused_fields: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"fused_fields: {name} must be contiguous")


def fused_fields(ncc: torch.Tensor, area: torch.Tensor, gray: torch.Tensor,
                 threshold: float, open_ksize: int, profile: DetectProfile):
    """Fused band/open/peak-cell fields for frames ``(B, H, W)``.

    Returns ``(packed, cell_vals, cell_idx)``: ``packed`` is
    ``gray + 256*band + 512*area_open``, and ``cell_vals``/``cell_idx`` of
    shape ``(B, ceil(H/8), ceil(W/8))`` are the masked peak field's per-cell
    max and row-major argmax (flat ``y*W + x``), float32 and int32.

    ``area`` is a 0/1 mask (the detector's DoG mask is); the kernel keeps it
    as bits (nonzero is 1) and does not check it. On the card the windows
    may reach at most ``MAX_HALO`` pixels (:func:`halo`).
    """
    global fields_launches
    if ncc.device.type == "cpu":
        return fused_fields_reference(ncc, area, gray, threshold, open_ksize,
                                      profile)
    if ncc.device.type != "cuda":
        raise ValueError(f"fused_fields: unsupported device {ncc.device}")
    if ncc.ndim != 3:
        raise ValueError(f"fused_fields: expected (B, H, W), got {tuple(ncc.shape)}")
    b, h, w = ncc.shape
    for name, x in (("ncc", ncc), ("area", area), ("gray", gray)):
        _check(name, x, (b, h, w))
        if x.device != ncc.device:
            raise ValueError(f"fused_fields: {name} is on {x.device}, ncc on "
                             f"{ncc.device}")
    r = halo(profile, open_ksize)
    if r > MAX_HALO:
        raise ValueError(f"fused_fields: the windows reach {r} px, the kernel "
                         f"at most {MAX_HALO}")
    hc, wc = -(-h // CELL), -(-w // CELL)
    packed = torch.empty_like(ncc)
    cval = torch.empty((b, hc, wc), dtype=torch.float32, device=ncc.device)
    cidx = torch.empty((b, hc, wc), dtype=torch.int32, device=ncc.device)
    if b == 0:
        return packed, cval, cidx
    lib = build.library()
    with torch.cuda.device(ncc.device):   # build.py: launches go to it
        err = lib.vbs_fused_fields(
            ncc.data_ptr(), area.data_ptr(), gray.data_ptr(),
            packed.data_ptr(), cval.data_ptr(), cidx.data_ptr(), b, h, w,
            float(threshold), profile.band_window, profile.peak_window,
            int(open_ksize), r,
            torch.cuda.current_stream(ncc.device).cuda_stream)
    build.check(err, "fused_fields kernel launch")
    fields_launches += 1
    return packed, cval, cidx
