"""Candidate selection from per-cell peak reductions with distance suppression.

Port of ``vision_basedsensor_tpu/ops/peaks.py`` (``Peaks``,
``select_peaks_from_cells``, ``_suppress``). The per-cell max/argmax comes
from the fused field kernel (``ops/cuda/fields.py``).

``lax.top_k`` orders equal values by lower index and ``_suppress`` relies on
that rank order; ``torch.topk`` promises no tie order, so the selection is a
stable descending sort.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Peaks(NamedTuple):
    xy: torch.Tensor     # (..., K, 2) integer pixel coords (x, y) as float32
    score: torch.Tensor  # (..., K)
    valid: torch.Tensor  # (..., K) bool


def _suppress(xy: torch.Tensor, score: torch.Tensor, valid: torch.Tensor,
              min_distance: float) -> torch.Tensor:
    """Drop peaks within ``min_distance`` of a stronger (earlier-ranked)
    peak; batched over leading axes."""
    d2 = torch.sum((xy[..., :, None, :] - xy[..., None, :, :]) ** 2, dim=-1)
    k = score.shape[-1]
    rank = torch.arange(k, device=xy.device)
    # Sorted descending with ties by index, so earlier == stronger.
    stronger = rank[None, :] < rank[:, None]
    near = d2 < min_distance ** 2
    killed = torch.any(stronger & near & valid[..., None, :], dim=-1)
    return valid & ~killed


def select_peaks_from_cells(cmax: torch.Tensor, cflat: torch.Tensor,
                            width: int, max_peaks: int,
                            min_distance: float) -> Peaks:
    """Top ``max_peaks`` cell maxima ``cmax`` ``(..., HC, WC)`` with their
    row-major flat pixel indices ``cflat`` (``y * width + x``), then
    distance suppression."""
    batch = cmax.shape[:-2]
    n = cmax.shape[-2] * cmax.shape[-1]
    vals, cidx = torch.sort(cmax.reshape(batch + (n,)), dim=-1,
                            descending=True, stable=True)
    vals, cidx = vals[..., :max_peaks], cidx[..., :max_peaks]
    flat = torch.gather(cflat.reshape(batch + (n,)).long(), -1, cidx)
    ys = torch.div(flat, width, rounding_mode="floor").float()
    xs = torch.remainder(flat, width).float()
    xy = torch.stack([xs, ys], dim=-1)
    valid = torch.isfinite(vals)
    valid = _suppress(xy, vals, valid, min_distance)
    return Peaks(xy=xy, score=torch.where(valid, vals, torch.zeros_like(vals)),
                 valid=valid)
