"""Normalized cross-correlation against a Gaussian template, fully separable.

A frozen copy of the port's module of the same name, plain PyTorch only."""
from __future__ import annotations

import functools

import numpy as np
import torch

from vbs_bench.reference.imaging import conv_same_zero, gaussian_taps


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
                       binary_input: bool = False,
                       compute_dtype: torch.dtype | None = None,
                       mean: torch.Tensor | None = None) -> torch.Tensor:
    """NCC of ``image`` ``(..., H, W)`` with a unit-sum Gaussian template
    (scale-invariant: a 0/255 and a 0/1 mask score alike). With
    ``binary_input`` the image must be 0/1 and ``box(image^2)`` is closed
    form. ``compute_dtype`` as in ``core/imaging.py:_sep_filter``: in
    bfloat16 the filters' inputs are rounded too, as in the reference.
    Pass a smaller ``min_variance`` for continuous-valued images.

    ``mean`` ``(..., 1, 1)``: the mean of the whole frame when ``image``
    holds only some of its rows (a row shard, ``parallel/spatial.py``);
    by default the mean of ``image``, its sum over its pixel count (as
    ``jnp.mean``: for a 0/1 mask below 2^24 pixels the sum is exact, so a
    sum of the shards' sums over the frame's count gives the same bits)."""
    raw = image.float()
    # The reference subtracts the global image mean (:152-153); it changes
    # what the zero-padded borders mean, so it is kept.
    h, w = raw.shape[-2:]
    mu = (raw.sum(dim=(-2, -1), keepdim=True) / (h * w) if mean is None
          else mean)
    image = raw - mu
    g = gaussian_taps(ksize, sigma)
    n = float(ksize * ksize)
    ones = np.ones(ksize)

    corr_g = conv_same_zero(image, g, g, compute_dtype)
    box1 = conv_same_zero(image, ones, ones, compute_dtype)
    if binary_input:
        # For 0/1 inputs raw^2 == raw: box(m^2) = (1 - 2 mu) box(raw)
        # + mu^2 count with box(raw) = box(m) + mu count.
        count = _box_count(image.shape[-2], image.shape[-1], ksize,
                           image.device)
        box_raw = box1 + mu * count
        box2 = (1.0 - 2.0 * mu) * box_raw + mu * mu * count
    else:
        box2 = conv_same_zero(image * image, ones, ones, compute_dtype)

    num = corr_g - box1 / n
    var_n = torch.clamp(box2 - box1 * box1 / n, min=0.0)

    g2d = np.outer(g, g)
    t0_energy = float(np.sum((g2d - np.mean(g2d)) ** 2))

    den = torch.sqrt(var_n * t0_energy)
    return torch.where(var_n >= min_variance,
                       num / torch.clamp(den, min=1e-12),
                       torch.zeros((), dtype=num.dtype, device=num.device))
