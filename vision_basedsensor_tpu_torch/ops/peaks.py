"""Candidate selection from per-cell peak reductions with distance suppression.

Port of ``vision_basedsensor_tpu/ops/peaks.py`` (``Peaks``,
``select_peaks_from_cells``, ``_suppress``, ``find_peaks``). On the fused
branch the per-cell max/argmax comes from the fused field kernel
(``ops/cuda/fields.py``); :func:`peak_field` and :func:`cell_maxima`
compute it for the unfused branch (:func:`find_peaks` chains them).

``lax.top_k`` orders equal values by lower index and ``_suppress`` relies on
that rank order; ``torch.topk`` promises no tie order, so the selection is a
stable descending sort.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from vision_basedsensor_tpu_torch.core.imaging import max_filter


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


def top_cells(vals: torch.Tensor, flat: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of ``vals`` ``(..., n)`` and their flat pixel
    indices ``flat``, sorted descending, equal values in their order in
    ``vals`` (``lax.top_k``'s). Shards' lists concatenated in row order
    merge into the whole frame's (``parallel/spatial.py``)."""
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    vals, order = vals[..., :k], order[..., :k]
    return vals, torch.gather(flat.long(), -1, order)


def peaks_from_top(vals: torch.Tensor, flat: torch.Tensor, width: int,
                   min_distance: float) -> Peaks:
    """:class:`Peaks` from :func:`top_cells`' ranked values and flat indices
    (``y * width + x``): the finite ones valid, then distance
    suppression."""
    ys = torch.div(flat, width, rounding_mode="floor").float()
    xs = torch.remainder(flat, width).float()
    xy = torch.stack([xs, ys], dim=-1)
    valid = torch.isfinite(vals)
    valid = _suppress(xy, vals, valid, min_distance)
    return Peaks(xy=xy, score=torch.where(valid, vals, torch.zeros_like(vals)),
                 valid=valid)


def select_peaks_from_cells(cmax: torch.Tensor, cflat: torch.Tensor,
                            width: int, max_peaks: int,
                            min_distance: float) -> Peaks:
    """Top ``max_peaks`` cell maxima ``cmax`` ``(..., HC, WC)`` with their
    row-major flat pixel indices ``cflat`` (``y * width + x``), then
    distance suppression."""
    batch = cmax.shape[:-2]
    n = cmax.shape[-2] * cmax.shape[-1]
    return peaks_from_top(*top_cells(cmax.reshape(batch + (n,)),
                                     cflat.reshape(batch + (n,)), max_peaks),
                          width, min_distance)


def cell_maxima(sp: torch.Tensor, cell: int = 8):
    """Per-``cell x cell`` max and row-major flat argmax ``y * W + x`` (ties
    to the smallest index) of ``sp`` ``(..., H, W)``; ragged cells pad with
    -inf, and the flat index uses the unpadded width."""
    h, w = sp.shape[-2:]
    batch = sp.shape[:-2]
    hc, wc = -(-h // cell), -(-w // cell)
    sp = F.pad(sp, (0, wc * cell - w, 0, hc * cell - h), value=-float("inf"))
    tiles = sp.reshape(batch + (hc, cell, wc, cell)).transpose(-3, -2)
    tiles = tiles.reshape(batch + (hc, wc, cell * cell))
    cval = torch.amax(tiles, dim=-1)
    coff = torch.argmax(tiles, dim=-1)   # first maximal index
    cyg = torch.arange(hc, device=sp.device)[:, None]
    cxg = torch.arange(wc, device=sp.device)[None, :]
    cidx = ((cyg * cell + torch.div(coff, cell, rounding_mode="floor")) * w
            + (cxg * cell + coff % cell))
    return cval, cidx.int()


def peak_field(score: torch.Tensor, threshold: float,
               window: int) -> torch.Tensor:
    """``score`` where it equals its ``window`` local maximum and exceeds
    ``threshold``, else -inf: the field whose cell maxima are the peaks."""
    local_max = max_filter(score, window)
    is_peak = (score >= local_max) & (score > threshold)
    return torch.where(is_peak, score, torch.full_like(score, -float("inf")))


def find_peaks(score: torch.Tensor, threshold: float, window: int,
               max_peaks: int, min_distance: float, cell: int = 8) -> Peaks:
    """Up to ``max_peaks`` local maxima of ``score`` ``(..., H, W)``: pixels
    equal to their ``window`` local maximum and above ``threshold``, the
    best of each ``cell x cell`` tile, ranked and distance-suppressed."""
    cmax, cflat = cell_maxima(peak_field(score, threshold, window), cell)
    return select_peaks_from_cells(cmax, cflat, score.shape[-1], max_peaks,
                                   min_distance)
