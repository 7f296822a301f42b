"""Per-frame contact state: contact-plane tilt and mean displacement.

Port of ``vision_basedsensor_tpu/analysis/force.py``: ``contact_state_sequence``
(C14/C15 in the hot path), a batched masked plane fit over each frame's
from-first-sighting displacement field; ``start_end_displacement`` (C17),
the frame-range-averaged start/end displacement; and the offline pair
analysis, ``deviation_field`` (``d_tilt - d_vert`` over the common markers,
``ForceDistribution.py:168-208``) and ``analyze_deviation`` (the contact
plane over the deviated end points and its tilt ``atan(sqrt(a^2+b^2))``,
``ForceDistribution.py:138-162``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch import layout
from vision_basedsensor_tpu_torch.config import AnalysisConfig
from vision_basedsensor_tpu_torch.core.fit import (PlaneFit, fit_plane,
                                                   fit_plane_robust, masked_mean)
from vision_basedsensor_tpu_torch.reconstruct.displacement import Reconstruction
from vision_basedsensor_tpu_torch.utils.graphs import replay
from vision_basedsensor_tpu_torch.utils.profiling import trace_annotation


class DeviationAnalysis(NamedTuple):
    deviation: torch.Tensor       # (65, 3) d_tilt - d_vert
    valid: torch.Tensor           # (65,)
    plane: PlaneFit               # contact plane over deviated end points
    tilt_deg: torch.Tensor        # scalar pose-misalignment angle
    mean_vector: torch.Tensor     # (3,) mean deviation vector
    mean_magnitude: torch.Tensor  # scalar mean |deviation|


class ContactState(NamedTuple):
    """Per-frame contact state — the production-serving pose output."""
    tilt_deg: torch.Tensor        # (B,) contact-plane tilt per frame
    plane: PlaneFit               # per-frame plane coefficients (each (B,))
    mean_vector: torch.Tensor     # (B, 3) mean displacement vector
    mean_magnitude: torch.Tensor  # (B,) mean |displacement|
    valid: torch.Tensor           # (B,) enough markers to fit a plane


# (device, dtype, initial_mode) -> the start points on that device.
_START: dict = {}


def _start_points(like: torch.Tensor, initial_mode: str) -> torch.Tensor:
    """The 65 markers' start points ``(65, 3)``: the dome layout's X, Y and,
    for ``initial_mode='shell'``, its heights, else Z = 0 (the reference's
    default, ``ForceDistribution.py:15,222``). Sent to ``like``'s device
    once (a copy from the host waits for the card) and shared: callers
    must not write to it."""
    key = (like.device, like.dtype, initial_mode)
    start = _START.get(key)
    if start is None:
        table = torch.as_tensor(layout.dome_layout()[:, 1:], dtype=like.dtype,
                                device=like.device)
        z0 = (table[:, 2] if initial_mode == "shell"
              else torch.zeros_like(table[:, 2]))
        start = _START[key] = torch.stack([table[:, 0], table[:, 1], z0],
                                          dim=-1)
    return start


def contact_state_sequence(recon: Reconstruction, cfg: AnalysisConfig,
                           initial_mode: str = "plane") -> ContactState:
    """Contact-plane fit over each frame's cumulative displacement field
    (the fit a CUDA graph on the card: ``utils/graphs.py``)."""
    with trace_annotation("vbs.contact"):
        with trace_annotation("vbs.contact.layout"):
            start = _start_points(recon.world, initial_mode)      # (65, 3)
        with trace_annotation("vbs.contact.fit"):
            return replay("contact", _contact_fit, start, recon.from_first,
                          recon.from_first_norm, recon.seen, cfg)


def _contact_fit(start: torch.Tensor, from_first: torch.Tensor,
                 from_first_norm: torch.Tensor, valid: torch.Tensor,
                 cfg: AnalysisConfig) -> ContactState:
    disp = cfg.deviation_scale * from_first                       # (B, 65, 3)
    end = start[None] + disp
    plane = (fit_plane_robust(end, valid) if cfg.robust_plane_fit
             else fit_plane(end, valid))
    mean_vec = masked_mean(disp, valid[..., None], axis=-2)
    mean_mag = masked_mean(from_first_norm, valid, axis=-1)
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


def deviation_field(d_vert: torch.Tensor, vert_ok: torch.Tensor,
                    d_tilt: torch.Tensor, tilt_ok: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-marker deviation ``d_tilt - d_vert`` over the common-id set
    (``ForceDistribution.py:184,197-204``)."""
    ok = vert_ok & tilt_ok
    return torch.where(ok[:, None], d_tilt - d_vert,
                       torch.zeros_like(d_tilt)), ok


def analyze_deviation(deviation: torch.Tensor, valid: torch.Tensor,
                      cfg: AnalysisConfig,
                      initial_mode: str = "plane") -> DeviationAnalysis:
    """Contact-plane fit and summary over a deviation field: the plane is
    fitted to start + scaled deviation end points
    (``ForceDistribution.py:229-243``), the tilt is in degrees."""
    end = _start_points(deviation, initial_mode) + cfg.deviation_scale * deviation
    plane = (fit_plane_robust(end, valid) if cfg.robust_plane_fit
             else fit_plane(end, valid))
    mean_vec = masked_mean(cfg.deviation_scale * deviation, valid[:, None],
                           axis=0)
    mean_mag = masked_mean(torch.linalg.norm(deviation, dim=-1), valid)
    return DeviationAnalysis(
        deviation=deviation, valid=valid, plane=plane,
        tilt_deg=plane.tilt_deg, mean_vector=mean_vec, mean_magnitude=mean_mag)
