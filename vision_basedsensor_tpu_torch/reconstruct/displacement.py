"""Displacement fields over the frame axis.

Port of ``vision_basedsensor_tpu/reconstruct/displacement.py``: the
last-sighting recurrence (one ``lax.scan`` there), carrying (last position,
first position, cumulative path) per marker, with the reference's warm-up
skip and step gate. On the card it is one launch of
``csrc/displacement_scan.cu``; its plain version is a Python loop over
frames.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch.config import ReconstructConfig
from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.core.device import CUDA, resolve
from vision_basedsensor_tpu_torch.ops.cuda import scan as kscan
from vision_basedsensor_tpu_torch.reconstruct.depth import reconstruct_positions
from vision_basedsensor_tpu_torch.track.associate import TrackedFrames
from vision_basedsensor_tpu_torch.utils.profiling import trace_annotation


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


def initial_carry(n: int, dtype=torch.float32, device=CUDA) -> dict:
    """Fresh scan state (also the session checkpoint's schema,
    ``io/session.py``)."""
    device = resolve(device)
    return dict(
        last=torch.zeros((n, 3), dtype=dtype, device=device),
        last_ok=torch.zeros(n, dtype=torch.bool, device=device),
        first=torch.zeros((n, 3), dtype=dtype, device=device),
        first_ok=torch.zeros(n, dtype=torch.bool, device=device),
        cum=torch.zeros(n, dtype=dtype, device=device),
    )


def _norm3(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 3 as ``sqrt((x*x + y*y) +
    z*z)``, the order the kernel (``csrc/displacement_scan.cu``) keeps."""
    x, y, z = d.unbind(-1)
    return torch.sqrt(x * x + y * y + z * z)


def displacement_scan_reference(world: torch.Tensor, seen: torch.Tensor,
                                cfg: ReconstructConfig,
                                carry: dict | None = None,
                                return_carry: bool = False):
    """Plain version of :func:`displacement_scan`: a Python loop over the
    frames. ``B = 0`` gives empty outputs and the carry unchanged, as
    ``lax.scan`` does."""
    b, n = world.shape[:2]
    c = initial_carry(n, world.dtype, world.device) if carry is None else carry
    step = torch.empty_like(world)
    step_norm = torch.empty((b, n), dtype=world.dtype, device=world.device)
    step_valid = torch.empty((b, n), dtype=torch.bool, device=world.device)
    cum_path, ff, ffn = (torch.empty_like(step_norm), torch.empty_like(world),
                         torch.empty_like(step_norm))
    for t in range(b):
        pos, ok = world[t], seen[t]
        had_prev = c["last_ok"] & ok
        d = pos - c["last"]
        dn = _norm3(d)
        emit = had_prev & (dn <= cfg.max_step_displacement_mm)
        dnz = torch.where(emit, dn, torch.zeros_like(dn))
        cum = c["cum"] + dnz
        first = torch.where((~c["first_ok"] & ok)[:, None], pos, c["first"])
        ff[t] = torch.where(ok[:, None], pos - first, torch.zeros_like(pos))
        step[t] = torch.where(emit[:, None], d, torch.zeros_like(d))
        step_norm[t], step_valid[t], cum_path[t] = dnz, emit, cum
        ffn[t] = _norm3(ff[t])
        c = dict(last=torch.where(ok[:, None], pos, c["last"]),
                 last_ok=c["last_ok"] | ok,
                 first=first, first_ok=c["first_ok"] | ok, cum=cum)
    recon = Reconstruction(world=world, seen=seen, step=step,
                           step_norm=step_norm, step_valid=step_valid,
                           cum_path=cum_path, from_first=ff,
                           from_first_norm=ffn)
    return (recon, c) if return_carry else recon


def displacement_scan(world: torch.Tensor, seen: torch.Tensor,
                      cfg: ReconstructConfig, carry: dict | None = None,
                      return_carry: bool = False):
    """Run the last-sighting recurrence over frames ``world (B, 65, 3)``,
    ``seen (B, 65)``. ``carry`` resumes from a previous chunk's (or a
    session checkpoint's) state; with ``return_carry`` the final state is
    returned beside the result (the given carry is never changed in
    place). CPU tensors take :func:`displacement_scan_reference`; CUDA
    tensors one launch of the scan kernel (``ops/cuda/scan.py``)."""
    with trace_annotation("vbs.reconstruct.scan"):
        if world.device.type == "cpu":
            return displacement_scan_reference(world, seen, cfg, carry,
                                               return_carry)
        world, seen = world.contiguous(), seen.contiguous()
        fields, final = kscan.displacement_scan(
            world, seen, cfg.max_step_displacement_mm, carry)
        recon = Reconstruction(world, seen, *fields)
        return (recon, final) if return_carry else recon


def warmup_mask(world: torch.Tensor, ok: torch.Tensor, warmup_frames: int,
                offset: int = 0):
    """Mask the first ``warmup_frames`` global frames of a stream
    (``3d_reconstruction.py:255-256``); ``offset`` is the global index of
    this batch's first frame."""
    if warmup_frames <= 0:
        return world, ok
    keep = (offset + torch.arange(world.shape[0], device=world.device)
            >= warmup_frames)
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
