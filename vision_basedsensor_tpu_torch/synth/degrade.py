"""Optical degradations for robustness evaluation of the detector.

Port of ``vision_basedsensor_tpu/synth/degrade.py``: uneven illumination,
vignetting, defocus and motion blur (deterministic, as the reference's) and
sensor read noise, over ``(B, H, W)`` float frames in 0..255 on any device.
``sensor_noise`` draws from a ``torch.Generator`` on the frames' device
seeded by ``seed``: its numbers differ from ``jax.random.normal``'s, its
distribution does not.
"""
from __future__ import annotations

import numpy as np
import torch

from vision_basedsensor_tpu_torch.core.imaging import gaussian_blur


def illumination_gradient(frames: torch.Tensor, strength: float = 0.4,
                          axis: str = "x") -> torch.Tensor:
    """Linear illumination falloff: the gain ramps from ``1 - strength`` at
    one edge to 1.0 at the other (an unevenly ageing LED ring,
    ``collecting.py:34-36``)."""
    h, w = frames.shape[-2:]
    n = w if axis == "x" else h
    ramp = ((1.0 - strength) + strength
            * torch.arange(n, dtype=torch.float32, device=frames.device)
            / (n - 1))
    gain = ramp[None, None, :] if axis == "x" else ramp[None, :, None]
    return torch.clamp(frames * gain, 0.0, 255.0)


def vignette(frames: torch.Tensor, strength: float = 0.4) -> torch.Tensor:
    """Radial falloff: gain 1 at the centre, ``1 - strength`` at the
    corners (the endoscopic lens and the in-bonnet LEDs)."""
    h, w = frames.shape[-2:]
    dev = frames.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2) / (h / 2)
    xs = (torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2) / (w / 2)
    r2 = (ys[:, None] ** 2 + xs[None, :] ** 2) / 2.0  # 1.0 at the corners
    gain = 1.0 - strength * r2
    return torch.clamp(frames * gain[None], 0.0, 255.0)


def defocus(frames: torch.Tensor, sigma_px: float) -> torch.Tensor:
    """Defocus blur as an isotropic Gaussian PSF of ``sigma_px``."""
    if sigma_px <= 0:
        return frames
    k = int(2 * np.ceil(3 * sigma_px) + 1)
    return gaussian_blur(frames, k, float(sigma_px))


def motion_blur(frames: torch.Tensor, length_px: float,
                angle_deg: float = 0.0) -> torch.Tensor:
    """Linear motion blur: the mean of the frame translated to N = ceil(len)
    + 1 points of a ``length_px`` segment at ``angle_deg`` (bilinear,
    edge-clamped), as the spinning bonnet streaks the markers."""
    n = max(int(np.ceil(length_px)) + 1, 2)
    if length_px <= 0:
        return frames
    ts = np.linspace(-0.5, 0.5, n) * length_px
    dx = ts * np.cos(np.deg2rad(angle_deg))
    dy = ts * np.sin(np.deg2rad(angle_deg))
    acc = torch.zeros_like(frames)
    for sx, sy in zip(dx, dy):
        acc = acc + _shift_bilinear(frames, float(sx), float(sy))
    return acc / n


def _shift_bilinear(frames: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """Translate by a sub-pixel offset with bilinear sampling (edge clamp)."""
    ix, fx = int(np.floor(dx)), dx - np.floor(dx)
    iy, fy = int(np.floor(dy)), dy - np.floor(dy)
    h, w = frames.shape[-2:]
    dev = frames.device

    def sh(ox, oy):
        ys = torch.clamp(torch.arange(h, device=dev) - oy, 0, h - 1)
        xs = torch.clamp(torch.arange(w, device=dev) - ox, 0, w - 1)
        return frames[..., ys[:, None], xs[None, :]]

    return ((1 - fx) * (1 - fy) * sh(ix, iy)
            + fx * (1 - fy) * sh(ix + 1, iy)
            + (1 - fx) * fy * sh(ix, iy + 1)
            + fx * fy * sh(ix + 1, iy + 1))


def sensor_noise(frames: torch.Tensor, sigma: float,
                 seed: int = 0) -> torch.Tensor:
    """Additive Gaussian read noise of ``sigma`` gray levels, clipped to
    0..255 (the camera's q70 stream carries ~1-2 levels)."""
    gen = torch.Generator(device=frames.device).manual_seed(seed)
    noise = sigma * torch.randn(frames.shape, generator=gen,
                                dtype=frames.dtype, device=frames.device)
    return torch.clamp(frames + noise, 0.0, 255.0)
