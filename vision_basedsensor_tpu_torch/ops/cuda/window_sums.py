"""Per-peak window moment sums.

Port of three Pallas kernels as one hand-written CUDA kernel,
``csrc/window_sums.cu``, with two input modes:

* :func:`window_sums` reads the three fields band, area and gray:
  ``vision_basedsensor_tpu/ops/pallas/moments.py:window_sums_pallas``, the
  detector's unfused branch;
* :func:`window_sums_packed` reads the packed field
  ``gray + 256*band + 512*area``: ``ops/pallas/moments.py:window_sums_packed``;
  :func:`gather_moments` is the same entry under the name of
  ``benchmarks/gather_moments_kernel.py:gather_moments``, the fused
  gather + moments kernel.

The plain version of all three is ``ops/moments.py:window_sums_xla``.
Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from vision_basedsensor_tpu_torch.config import DetectProfile
from vision_basedsensor_tpu_torch.ops.cuda import build
from vision_basedsensor_tpu_torch.ops.moments import (NUM_SUMS, CutGeometry,
                                                      unpack_packed_field,
                                                      window_sums_xla)
from vision_basedsensor_tpu_torch.ops.patches import patch_origins
from vision_basedsensor_tpu_torch.ops.peaks import Peaks

# Kernel launches since the last reset, by input mode (chip_smoke.py reads
# and resets them).
fields_launches = 0   # window_sums: three fields
packed_launches = 0   # window_sums_packed / gather_moments

# The kernel packs a patch pixel's row and column into 16 bits.
MAX_PATCH = 256


def window_sums_packed_reference(packed: torch.Tensor, peaks: Peaks,
                                 geom: CutGeometry,
                                 profile: DetectProfile) -> torch.Tensor:
    """Plain version of the packed mode: unpack, then ``window_sums_xla``."""
    return window_sums_xla(*unpack_packed_field(packed), peaks, geom, profile)


def _prepare(fields, peaks: Peaks, geom: CutGeometry,
             profile: DetectProfile, what: str):
    """Check the inputs and prepare the C entry's call: ``(out, args,
    temps)``, ``args`` being ``vbs_window_sums``'s arguments up to the stream
    (``None`` when there is nothing to launch), ``out`` the ``(B, K,
    NUM_SUMS)`` output they write and ``temps`` the tensors they point into
    besides the inputs: keep both alive while ``args`` is used."""
    ref = fields[0]
    if ref.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ref.device}")
    if ref.ndim != 3:
        raise ValueError(f"{what}: expected (B, H, W) fields, got "
                         f"{tuple(ref.shape)}")
    b, h, w = ref.shape
    for x in fields:
        if (x.dtype != torch.float32 or tuple(x.shape) != (b, h, w)
                or not x.is_contiguous() or x.device != ref.device):
            raise ValueError(f"{what}: every field must be a contiguous "
                             f"float32 {(b, h, w)} tensor on {ref.device}")
    k = peaks.xy.shape[-2]
    if tuple(peaks.xy.shape) != (b, k, 2) or peaks.xy.device != ref.device:
        raise ValueError(f"{what}: peaks must be (B, K, 2) on {ref.device}, "
                         f"got {tuple(peaks.xy.shape)} on {peaks.xy.device}")
    for name, x in zip(CutGeometry._fields, geom):
        if tuple(x.shape) != (b, k, 3) or x.device != ref.device:
            raise ValueError(f"{what}: geom.{name} must be (B, K, 3) on "
                             f"{ref.device}, got {tuple(x.shape)} on "
                             f"{x.device}")
    p = profile.patch_size
    if p > MAX_PATCH:
        raise ValueError(f"{what}: patch_size {p} > {MAX_PATCH}")
    start = patch_origins(h, w, peaks.xy, p)
    xy = peaks.xy.float().contiguous()
    g = torch.stack([geom.ex, geom.ey, geom.rhs], dim=-1)     # (B, K, 3, 3)
    g = g.float().reshape(b, k, 9).contiguous()
    out = torch.empty((b, k, NUM_SUMS), dtype=torch.float32, device=ref.device)
    if b == 0 or k == 0:
        return out, None, ()
    floor = float(profile.soft_floor)
    scale = 1.0 / (1.0 - 2.0 * floor) if floor > 0.0 else 1.0
    packed = len(fields) == 1
    f0, f1, f2 = fields * 3 if packed else fields
    args = (f0.data_ptr(), f1.data_ptr(), f2.data_ptr(), xy.data_ptr(),
            g.data_ptr(), start.data_ptr(), out.data_ptr(), b, h, w, k, p,
            float(profile.radial_cutoff_px) ** 2, floor, scale, int(packed))
    return out, args, (start, xy, g)


def _launch(fields, peaks: Peaks, geom: CutGeometry,
            profile: DetectProfile, what: str) -> torch.Tensor:
    global fields_launches, packed_launches
    out, args, _temps = _prepare(fields, peaks, geom, profile, what)
    if args is not None:
        lib = build.library()
        with torch.cuda.device(out.device):   # build.py: launches go to it
            err = lib.vbs_window_sums(
                *args, torch.cuda.current_stream(out.device).cuda_stream)
        build.check(err, f"{what} kernel launch")
        if len(fields) == 1:
            packed_launches += 1
        else:
            fields_launches += 1
    return out


def window_sums(band: torch.Tensor, area: torch.Tensor, gray: torch.Tensor,
                peaks: Peaks, geom: CutGeometry,
                profile: DetectProfile) -> torch.Tensor:
    """The 28 window sums ``(B, K, NUM_SUMS)`` per peak from the three fields
    ``(B, H, W)`` (the detector's unfused branch). ``band`` and ``area`` are
    0/1 masks, as the detector makes them: the kernel sums them as
    integers."""
    if gray.device.type == "cpu":
        return window_sums_xla(band, area, gray, peaks, geom, profile)
    return _launch((band, area, gray), peaks, geom, profile, "window_sums")


def window_sums_packed(packed: torch.Tensor, peaks: Peaks, geom: CutGeometry,
                       profile: DetectProfile) -> torch.Tensor:
    """:func:`window_sums` reading the packed field
    ``gray + 256*band + 512*area`` ``(B, H, W)``, unpacked exactly."""
    if packed.device.type == "cpu":
        return window_sums_packed_reference(packed, peaks, geom, profile)
    return _launch((packed,), peaks, geom, profile, "window_sums_packed")


def gather_moments(packed: torch.Tensor, peaks: Peaks, geom: CutGeometry,
                   profile: DetectProfile) -> torch.Tensor:
    """The fused gather + moments entry of the reference's benchmark: the
    same function and kernel as :func:`window_sums_packed`."""
    return window_sums_packed(packed, peaks, geom, profile)
