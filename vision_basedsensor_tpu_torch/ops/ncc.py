"""Normalized cross-correlation against a Gaussian template, fully separable.

Port of ``vision_basedsensor_tpu/ops/ncc.py`` for the detector's case, a
binary input (``binary_input=True``): four separable 'same' filter passes
plus the closed-form box count of the zero-padded window
(``marker_detection.py:145-164`` semantics).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from vision_basedsensor_tpu_torch.core.imaging import conv_same_zero, gaussian_taps


@functools.lru_cache(maxsize=16)
def _box_count(h: int, w: int, ksize: int,
               device: torch.device) -> torch.Tensor:
    """In-image pixel count of each zero-padded 'same' box window, cached
    per device and size (a 1080x1920 count is 8 MB to copy per call)."""
    lo, hi = (ksize - 1) // 2, ksize // 2

    def axis_count(n):
        i = np.arange(n)
        return (np.minimum(i + hi, n - 1) - np.maximum(i - lo, 0) + 1.0)

    count = np.outer(axis_count(h), axis_count(w)).astype(np.float32)
    return torch.from_numpy(count).to(device)


def normxcorr_gaussian(image: torch.Tensor, ksize: int, sigma: float,
                       min_variance: float = 0.5,
                       binary_input: bool = False) -> torch.Tensor:
    """NCC of a 0/1 ``image`` ``(..., H, W)`` with a unit-sum Gaussian
    template. Only ``binary_input=True`` is ported (the detector's call)."""
    if not binary_input:
        raise NotImplementedError(
            "normxcorr_gaussian(binary_input=False) is not ported; the "
            "detector only correlates its 0/1 area mask")
    raw = image.float()
    # The reference subtracts the global image mean (:152-153); it changes
    # what the zero-padded borders mean, so it is kept.
    mu = torch.mean(raw, dim=(-2, -1), keepdim=True)
    image = raw - mu
    g = gaussian_taps(ksize, sigma)
    n = float(ksize * ksize)
    ones = np.ones(ksize)

    corr_g = conv_same_zero(image, g, g)
    box1 = conv_same_zero(image, ones, ones)
    # For 0/1 inputs raw^2 == raw: box(m^2) = (1 - 2 mu) box(raw) + mu^2 count
    # with box(raw) = box(m) + mu count.
    count = _box_count(image.shape[-2], image.shape[-1], ksize, image.device)
    box_raw = box1 + mu * count
    box2 = (1.0 - 2.0 * mu) * box_raw + mu * mu * count

    num = corr_g - box1 / n
    var_n = torch.clamp(box2 - box1 * box1 / n, min=0.0)

    g2d = np.outer(g, g)
    t0_energy = float(np.sum((g2d - np.mean(g2d)) ** 2))

    den = torch.sqrt(var_n * t0_energy)
    return torch.where(var_n >= min_variance,
                       num / torch.clamp(den, min=1e-12),
                       torch.zeros((), dtype=num.dtype, device=num.device))
