"""Per-peak window gather from the packed field.

Port of ``vision_basedsensor_tpu/ops/pallas/moments.py``: ``gather_windows``
(pack=1, K4) and ``gather_windows_paired`` (pack=2, K3, the detector's
default) become one hand-written CUDA kernel, ``csrc/gather.cu``, with a
``pack`` argument. :func:`gather_windows_reference` is its plain PyTorch
version. The moment sums over the windows are batched PyTorch
(``ops/moments.py``).

The TPU kernels' ``H % 8`` / ``W % 128`` checks are tiling rules of the TPU
and are dropped; lanes outside the image are written as 0 by both versions.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from vision_basedsensor_tpu_torch.config import DetectProfile
from vision_basedsensor_tpu_torch.ops.cuda import build
from vision_basedsensor_tpu_torch.ops.moments import CutGeometry
from vision_basedsensor_tpu_torch.ops.patches import patch_origins
from vision_basedsensor_tpu_torch.ops.peaks import Peaks

LANES = 128

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
gather_launches = 0


def _prep(h: int, w: int, peaks: Peaks, profile: DetectProfile) -> torch.Tensor:
    """Clipped patch origins ``(B, K, 2)`` int32 ``(cx, cy)``, as the
    reference's ``_prep`` computes them (``:216-217``), after its radial
    cutoff check."""
    p = profile.patch_size
    # The cutoff disk must lie strictly inside the clipped p x p patch (the
    # round-to-int start puts the peak within +-0.5 px of its centre).
    if profile.radial_cutoff_px > p / 2 - 1:
        raise ValueError(
            f"radial_cutoff_px ({profile.radial_cutoff_px}) must be <= "
            f"patch_size/2 - 1 ({p / 2 - 1}) for backend equivalence")
    return patch_origins(h, w, peaks.xy, p)


def gather_index(start: torch.Tensor, w: int, patch: int, pack: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each output element's pixel in its frame, ``y * w + x`` with ``x``
    clamped to the last column, and whether ``x < w``; both
    ``(B, K // pack, patch, 128)``."""
    k = start.shape[-2]
    dev = start.device
    lanes = torch.arange(LANES, device=dev)
    j = lanes // 64 if pack == 2 else torch.zeros_like(lanes)
    off = lanes - 64 * j
    kk = pack * torch.arange(k // pack, device=dev)[:, None] + j   # (KO, 128)
    sx = start[..., 0].long()[:, kk]                                # (B, KO, 128)
    sy = start[..., 1].long()[:, kk]
    x = sx + off
    y = sy[:, :, None, :] + torch.arange(patch, device=dev)[:, None]
    inside = (x < w)[:, :, None, :].expand_as(y)
    return y * w + torch.clamp(x, max=w - 1)[:, :, None, :], inside


def gather_windows_reference(packed: torch.Tensor, start: torch.Tensor,
                             patch: int, pack: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``(B, K // pack, patch, 128)``;
    empty when B or K is 0, as the kernel's wrapper returns it."""
    b, h, w = packed.shape
    flat, inside = gather_index(start, w, patch, pack)
    vals = torch.gather(packed.reshape(b, h * w), 1,
                        flat.flatten(1)).reshape(flat.shape)
    return torch.where(inside, vals, torch.zeros((), device=packed.device))


def gather_windows(packed: torch.Tensor, peaks: Peaks, geom: CutGeometry,
                   profile: DetectProfile, pack: int = 1):
    """Gather each peak's packed-field window into a dense
    ``(B, K // pack, patch_size, 128)`` tensor; with ``pack=2`` window
    ``2i + j`` occupies lanes ``[64j, 64j + 64)`` of row ``i``. Returns
    ``(patches, start)`` with ``start`` ``(B, K, 2)`` the exact clipped
    patch origins. ``pack=2`` needs an even peak count and
    ``patch_size <= 64``. ``geom`` is unused (kept for the reference's
    signature)."""
    global gather_launches
    del geom
    if packed.ndim != 3:
        raise ValueError(f"gather_windows: expected packed (B, H, W), got "
                         f"{tuple(packed.shape)}")
    b, h, w = packed.shape
    k = peaks.xy.shape[-2]
    p = profile.patch_size
    if pack not in (1, 2):
        raise ValueError(f"gather_windows: pack must be 1 or 2, got {pack}")
    if k % pack != 0:
        raise ValueError(f"pack={pack} gather needs an even peak count, "
                         f"got {k}")
    if pack > 1 and p > 64:
        raise ValueError(f"paired gather needs patch_size <= 64, got {p} "
                         "(64-lane slot per window)")
    if p > LANES:
        raise ValueError(f"gather_windows: patch_size {p} exceeds {LANES} lanes")
    start = _prep(h, w, peaks, profile)
    if packed.device.type == "cpu":
        return gather_windows_reference(packed, start, p, pack), start
    if packed.device.type != "cuda":
        raise ValueError(f"gather_windows: unsupported device {packed.device}")
    if packed.dtype != torch.float32 or not packed.is_contiguous():
        raise ValueError("gather_windows: packed must be contiguous float32")
    if start.device != packed.device:
        raise ValueError(f"gather_windows: peaks on {start.device}, packed on "
                         f"{packed.device}")
    out = torch.empty((b, k // pack, p, LANES), dtype=torch.float32,
                      device=packed.device)
    if b == 0 or k == 0:
        return out, start
    lib = build.library()
    with torch.cuda.device(packed.device):   # build.py: launches go to it
        err = lib.vbs_gather_windows(
            packed.data_ptr(), start.data_ptr(), out.data_ptr(), b, h, w, k,
            p, pack, torch.cuda.current_stream(packed.device).cuda_stream)
    build.check(err, "gather_windows kernel launch")
    gather_launches += 1
    return out, start


def gather_windows_paired(packed: torch.Tensor, peaks: Peaks,
                          geom: CutGeometry, profile: DetectProfile):
    """:func:`gather_windows` with ``pack=2``: two windows per 128-lane
    row, consumed by ``ops.moments.moments_from_patches_paired[_mxu]``."""
    return gather_windows(packed, peaks, geom, profile, pack=2)
