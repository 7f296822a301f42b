"""The last-sighting recurrence over frames as a Python loop over frames
(a frozen copy of the port's ``displacement_scan_reference``), with the
depth stage before it."""
from __future__ import annotations

from typing import NamedTuple

import torch

from vbs_bench.reference.config import ReconstructConfig
from vbs_bench.reference.camera import CameraModel
from vbs_bench.reference.depth import reconstruct_positions
from vbs_bench.reference.associate import TrackedFrames


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


def _initial_carry(n: int, dtype, device) -> dict:
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
    """The recurrence over frames ``world (B, 65, 3)``, ``seen (B, 65)``
    from a fresh carry, or from ``carry``."""
    b, n = world.shape[:2]
    c = _initial_carry(n, world.dtype, world.device) if carry is None else carry
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


def reconstruct_sequence(cam: CameraModel, tracked: TrackedFrames,
                         cfg: ReconstructConfig) -> Reconstruction:
    """Tracked 2D markers -> displacement fields (no warm-up mask: the
    benchmark's configurations set ``warmup_frames`` to 0)."""
    world, ok = reconstruct_positions(cam, tracked.xy, tracked.axes,
                                      tracked.valid, cfg)
    return displacement_scan_reference(world, ok, cfg)
