"""Per-frame contact state: contact-plane tilt and mean displacement.

Port of ``vision_basedsensor_tpu/analysis/force.py``: ``contact_state_sequence``
(C14/C15 in the hot path), a batched masked plane fit over each frame's
from-first-sighting displacement field, and ``start_end_displacement``
(C17), the frame-range-averaged start/end displacement.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch import layout
from vision_basedsensor_tpu_torch.config import AnalysisConfig
from vision_basedsensor_tpu_torch.core.fit import (PlaneFit, fit_plane,
                                                   fit_plane_robust, masked_mean)
from vision_basedsensor_tpu_torch.reconstruct.displacement import Reconstruction


class ContactState(NamedTuple):
    """Per-frame contact state — the production-serving pose output."""
    tilt_deg: torch.Tensor        # (B,) contact-plane tilt per frame
    plane: PlaneFit               # per-frame plane coefficients (each (B,))
    mean_vector: torch.Tensor     # (B, 3) mean displacement vector
    mean_magnitude: torch.Tensor  # (B,) mean |displacement|
    valid: torch.Tensor           # (B,) enough markers to fit a plane


def contact_state_sequence(recon: Reconstruction, cfg: AnalysisConfig,
                           initial_mode: str = "plane") -> ContactState:
    """Contact-plane fit over each frame's cumulative displacement field."""
    table = torch.as_tensor(layout.dome_layout()[:, 1:],
                            dtype=recon.world.dtype, device=recon.world.device)
    z0 = table[:, 2] if initial_mode == "shell" else torch.zeros_like(table[:, 2])
    start = torch.stack([table[:, 0], table[:, 1], z0], dim=-1)   # (65, 3)
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


def start_end_displacement(recon: Reconstruction,
                           start_range: tuple[int, int],
                           end_range: tuple[int, int]
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Displacement between frame-range-averaged positions
    (``LocalAnalysis.calculate_average_coordinates``, :53-60): positions are
    averaged over ``frameno in [start, end]`` (inclusive), and the
    displacement is end-average minus start-average. Returns
    ``((65, 3) displacement, (65,) valid)``."""
    frames = torch.arange(recon.world.shape[0], device=recon.world.device)

    def avg(rng):
        in_rng = (frames >= rng[0]) & (frames <= rng[1])
        m = recon.seen & in_rng[:, None]
        return masked_mean(recon.world, m[..., None], axis=0), m.any(dim=0)

    start, s_ok = avg(start_range)
    end, e_ok = avg(end_range)
    ok = s_ok & e_ok
    return torch.where(ok[:, None], end - start, torch.zeros_like(end)), ok
