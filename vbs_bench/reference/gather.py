"""The window gather's plain PyTorch version: each peak's packed-field window
into a dense tensor (a frozen copy of the port's
``ops/cuda/moments.py:gather_windows_reference`` and the origins it is
given), plus the count of distinct window pixels that the benchmark's
bytes bound reads.
"""
from __future__ import annotations

import torch

from vbs_bench.reference.config import DetectProfile
from vbs_bench.reference.patches import patch_origins
from vbs_bench.reference.peaks import Peaks

LANES = 128


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


def distinct_window_pixels(start: torch.Tensor, h: int, w: int, patch: int,
                           pack: int, block: int = 32) -> int:
    """Distinct in-image pixels that the ``(B, K, 2)`` window origins
    ``start`` cover: a ``patch`` x 64 window a peak with ``pack=2``, a
    ``patch`` x 128 one with ``pack=1`` (lanes past the frame's right edge
    read nothing); ``block`` frames at a time."""
    cols = 64 if pack == 2 else 128
    r = torch.arange(patch, device=start.device)
    c = torch.arange(cols, device=start.device)
    total = 0
    for s0 in range(0, start.shape[0], block):
        st = start[s0:s0 + block]
        b = st.shape[0]
        ys = st[..., 1, None, None].long() + r[:, None]
        xs = st[..., 0, None, None].long() + c[None, :]
        keep = (xs < w) & (ys < h)
        flat = torch.where(keep, ys * w + xs,
                           torch.full_like(xs, h * w)).reshape(b, -1)
        mask = torch.zeros((b, h * w + 1), dtype=torch.bool,
                           device=start.device)
        mask.scatter_(1, flat, True)
        total += int(mask[:, :h * w].sum())
    return total
