"""Difference-of-Gaussians band-pass + area mask with explicit uint8 semantics.

Port of ``vision_basedsensor_tpu/ops/dog.py``: ``im_blur_8 - im_blur_3 + 15``
in uint8 (wrapping modulo 256) followed by ``cv2.inRange(., lo, hi)``, on
integer-quantized float blurs (``marker_detection.py:117-129``).
"""
from __future__ import annotations

import torch

from vision_basedsensor_tpu_torch.config import DetectProfile
from vision_basedsensor_tpu_torch.core.imaging import gaussian_blur


def dog_area_mask(gray: torch.Tensor, profile: DetectProfile,
                  offset: int = 15) -> torch.Tensor:
    """Gray frames ``(..., H, W)`` (0..255 floats) -> boolean area mask."""
    b_small = gaussian_blur(gray, profile.blur_small_ksize,
                            profile.blur_small_sigma, quantize=True)
    b_large = gaussian_blur(gray, profile.blur_large_ksize,
                            profile.blur_large_sigma, quantize=True)
    d = b_large - b_small + float(offset)
    # jnp.mod on floats takes the divisor's sign: torch.remainder, not fmod.
    wrapped = torch.remainder(d, 256.0)
    return (wrapped >= profile.dog_threshold) & (wrapped <= profile.dog_high)
