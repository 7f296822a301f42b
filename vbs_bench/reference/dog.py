"""Difference-of-Gaussians band-pass + area mask with explicit uint8 semantics.

A frozen copy of the port's module of the same name, plain PyTorch only."""
from __future__ import annotations

import torch

from vbs_bench.reference.config import DetectProfile
from vbs_bench.reference.imaging import gaussian_blur


def dog_area_mask(gray: torch.Tensor, profile: DetectProfile,
                  offset: int = 15,
                  compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Gray frames ``(..., H, W)`` (0..255 floats) -> boolean area mask;
    ``compute_dtype`` as in ``core/imaging.py:_sep_filter``."""
    b_small = gaussian_blur(gray, profile.blur_small_ksize,
                            profile.blur_small_sigma, quantize=True,
                            compute_dtype=compute_dtype)
    b_large = gaussian_blur(gray, profile.blur_large_ksize,
                            profile.blur_large_sigma, quantize=True,
                            compute_dtype=compute_dtype)
    d = b_large - b_small + float(offset)
    # jnp.mod on floats takes the divisor's sign: torch.remainder, not fmod.
    wrapped = torch.remainder(d, 256.0)
    return (wrapped >= profile.dog_threshold) & (wrapped <= profile.dog_high)
