"""Displacement fields over the frame axis.

Port of ``vision_basedsensor_tpu/reconstruct/displacement.py``: the
last-sighting recurrence (``lax.scan`` there) is a Python loop over frames
carrying (last position, first position, cumulative path) per marker, with
the reference's warm-up skip and step gate.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch.config import ReconstructConfig
from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.reconstruct.depth import reconstruct_positions
from vision_basedsensor_tpu_torch.track.associate import TrackedFrames


class Reconstruction(NamedTuple):
    """Per-frame, per-marker 3D state. Leading axis = frames."""
    world: torch.Tensor            # (B, 65, 3) world positions (valid obs only)
    seen: torch.Tensor             # (B, 65) observation valid this frame
    step: torch.Tensor             # (B, 65, 3) delta vs previous sighting
    step_norm: torch.Tensor        # (B, 65)
    step_valid: torch.Tensor       # (B, 65) had previous sighting & passed gate
    cum_path: torch.Tensor         # (B, 65) cumulative sum of step_norm
    from_first: torch.Tensor       # (B, 65, 3) delta vs first sighting
    from_first_norm: torch.Tensor  # (B, 65)


def initial_carry(n: int, dtype=torch.float32, device=None) -> dict:
    """Fresh scan state."""
    return dict(
        last=torch.zeros((n, 3), dtype=dtype, device=device),
        last_ok=torch.zeros(n, dtype=torch.bool, device=device),
        first=torch.zeros((n, 3), dtype=dtype, device=device),
        first_ok=torch.zeros(n, dtype=torch.bool, device=device),
        cum=torch.zeros(n, dtype=dtype, device=device),
    )


def displacement_scan(world: torch.Tensor, seen: torch.Tensor,
                      cfg: ReconstructConfig) -> Reconstruction:
    """Run the last-sighting recurrence over frames ``world (B, 65, 3)``,
    ``seen (B, 65)``."""
    c = initial_carry(world.shape[1], world.dtype, world.device)
    outs = []
    for pos, ok in zip(world, seen):
        had_prev = c["last_ok"] & ok
        d = pos - c["last"]
        dn = torch.linalg.vector_norm(d, dim=-1)
        emit = had_prev & (dn <= cfg.max_step_displacement_mm)
        dz = torch.where(emit[:, None], d, torch.zeros_like(d))
        dnz = torch.where(emit, dn, torch.zeros_like(dn))
        cum = c["cum"] + dnz
        first = torch.where((~c["first_ok"] & ok)[:, None], pos, c["first"])
        ff = torch.where(ok[:, None], pos - first, torch.zeros_like(pos))
        c = dict(last=torch.where(ok[:, None], pos, c["last"]),
                 last_ok=c["last_ok"] | ok,
                 first=first, first_ok=c["first_ok"] | ok, cum=cum)
        outs.append((dz, dnz, emit, cum, ff, torch.linalg.vector_norm(ff, dim=-1)))
    step, step_norm, step_valid, cum, ff, ffn = (torch.stack(v)
                                                 for v in zip(*outs))
    return Reconstruction(world=world, seen=seen, step=step,
                          step_norm=step_norm, step_valid=step_valid,
                          cum_path=cum, from_first=ff, from_first_norm=ffn)


def warmup_mask(world: torch.Tensor, ok: torch.Tensor, warmup_frames: int):
    """Mask the first ``warmup_frames`` frames of the batch
    (``3d_reconstruction.py:255-256``)."""
    if warmup_frames <= 0:
        return world, ok
    keep = torch.arange(world.shape[0], device=world.device) >= warmup_frames
    ok = ok & keep[:, None]
    return torch.where(ok[..., None], world, torch.zeros_like(world)), ok


def reconstruct_sequence(cam: CameraModel, tracked: TrackedFrames,
                         cfg: ReconstructConfig,
                         apply_warmup: bool = True) -> Reconstruction:
    """Full 3D stage: tracked 2D markers -> displacement fields."""
    world, ok = reconstruct_positions(cam, tracked.xy, tracked.axes,
                                      tracked.valid, cfg)
    if apply_warmup:
        world, ok = warmup_mask(world, ok, cfg.warmup_frames)
    return displacement_scan(world, ok, cfg)
