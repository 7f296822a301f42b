"""Per-marker displacement statistics (reference C18 + stats CSV).

Port of ``vision_basedsensor_tpu/analysis/series.py``: mask-aware summaries
matching ``3d_reconstruction.analyze_displacement``'s aggregation (:397-400:
mean/std/max of per-step displacement + final cumulative).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch.core.fit import masked_mean
from vision_basedsensor_tpu_torch.reconstruct.displacement import Reconstruction


class DisplacementStats(NamedTuple):
    mean: torch.Tensor   # (65,) mean per-step displacement
    std: torch.Tensor    # (65,)
    max: torch.Tensor    # (65,)
    final_cumulative: torch.Tensor  # (65,) last cumulative path length
    count: torch.Tensor  # (65,) number of valid steps


def displacement_statistics(recon: Reconstruction) -> DisplacementStats:
    m = recon.step_valid
    mean = masked_mean(recon.step_norm, m, axis=0)
    var = masked_mean((recon.step_norm - mean[None, :]) ** 2, m, axis=0)
    # Bessel correction to match pandas' default std (ddof=1), with its NaN
    # for a single observation.
    n = m.sum(dim=0)
    var = torch.where(n >= 2, var * n / torch.clamp(n - 1, min=1),
                      torch.full_like(var, float("nan")))
    mx = torch.amax(torch.where(m, recon.step_norm,
                                torch.full_like(recon.step_norm,
                                                -float("inf"))), dim=0)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    return DisplacementStats(
        mean=mean, std=torch.sqrt(var), max=mx,
        final_cumulative=recon.cum_path[-1], count=n)
