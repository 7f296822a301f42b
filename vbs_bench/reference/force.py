"""Per-frame contact state: contact-plane tilt and mean displacement.

A frozen copy of the port's module of the same name, plain PyTorch only."""
from __future__ import annotations

from typing import NamedTuple

import torch

from vbs_bench.reference import layout
from vbs_bench.reference.config import AnalysisConfig
from vbs_bench.reference.fit import (PlaneFit, fit_plane,
                                                   fit_plane_robust, masked_mean)
from vbs_bench.reference.displacement import Reconstruction


class ContactState(NamedTuple):
    """Per-frame contact state — the production-serving pose output."""
    tilt_deg: torch.Tensor        # (B,) contact-plane tilt per frame
    plane: PlaneFit               # per-frame plane coefficients (each (B,))
    mean_vector: torch.Tensor     # (B, 3) mean displacement vector
    mean_magnitude: torch.Tensor  # (B,) mean |displacement|
    valid: torch.Tensor           # (B,) enough markers to fit a plane


def _start_points(like: torch.Tensor, initial_mode: str) -> torch.Tensor:
    """The 65 markers' start points ``(65, 3)``: the dome layout's X, Y and,
    for ``initial_mode='shell'``, its heights, else Z = 0 (the reference's
    default, ``ForceDistribution.py:15,222``)."""
    table = torch.as_tensor(layout.dome_layout()[:, 1:], dtype=like.dtype,
                            device=like.device)
    z0 = table[:, 2] if initial_mode == "shell" else torch.zeros_like(table[:, 2])
    return torch.stack([table[:, 0], table[:, 1], z0], dim=-1)


def contact_state_sequence(recon: Reconstruction, cfg: AnalysisConfig,
                           initial_mode: str = "plane") -> ContactState:
    """Contact-plane fit over each frame's cumulative displacement field."""
    start = _start_points(recon.world, initial_mode)              # (65, 3)
    disp = cfg.deviation_scale * recon.from_first                 # (B, 65, 3)
    end = start[None] + disp
    valid = recon.seen
    plane = (fit_plane_robust(end, valid) if cfg.robust_plane_fit
             else fit_plane(end, valid))
    mean_vec = masked_mean(disp, valid[..., None], axis=-2)
    mean_mag = masked_mean(recon.from_first_norm, valid, axis=-1)
    return ContactState(tilt_deg=plane.tilt_deg, plane=plane,
                        mean_vector=mean_vec, mean_magnitude=mean_mag,
                        valid=valid.sum(-1) >= 3)


