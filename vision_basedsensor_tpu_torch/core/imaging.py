"""Imaging primitives: grayscale, separable Gaussian/box filters, morphology.

Port of ``vision_basedsensor_tpu/core/imaging.py``. Images are ``(..., H, W)``
float32 tensors (values 0..255 for 8-bit sources). Separable filters stay
dense banded matmuls with the border handling folded into the band matrix,
so the port rounds exactly where the reference rounds; the matmuls run in
full float32 (the package turns TF32 off).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# BT.601 luma weights used by cv2.COLOR_BGR2GRAY.
_BGR_WEIGHTS = (0.114, 0.587, 0.299)


def to_grayscale(frames: torch.Tensor, channel_order: str = "bgr",
                 quantize: bool = True) -> torch.Tensor:
    """``(..., H, W, 3)`` color (or ``(..., H, W)`` gray) -> float32 gray,
    rounded to the nearest integer when ``quantize`` is set."""
    if frames.ndim >= 1 and frames.shape[-1] == 3:
        w = _BGR_WEIGHTS if channel_order == "bgr" else _BGR_WEIGHTS[::-1]
        w = torch.tensor(w, dtype=torch.float32, device=frames.device)
        gray = torch.tensordot(frames.float(), w, dims=([-1], [0]))
    else:
        gray = frames.float()
    if quantize:
        gray = torch.floor(gray + 0.5)
    return gray


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """Normalized 1D Gaussian taps (host numpy), identical to
    ``cv2.getGaussianKernel``."""
    ax = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (ax / sigma) ** 2)
    return k / k.sum()


@functools.lru_cache(maxsize=64)
def _band_matrix_np(taps: tuple, n: int, mode: str) -> np.ndarray:
    """Dense banded correlation matrix T with ``y[i] = sum_j T[i, j] x[j]``;
    'reflect101' folds OpenCV's BORDER_REFLECT_101 into the matrix, 'zero'
    clips (fftconvolve 'same')."""
    k = len(taps)
    lo = (k - 1) // 2  # taps cover offsets [-lo, k-1-lo]
    T = np.zeros((n, n), np.float32)
    for i in range(n):
        for t, w in enumerate(taps):
            j = i - lo + t
            if mode == "reflect101":
                period = 2 * (n - 1) if n > 1 else 1
                j = abs(j) % period
                if j >= n:
                    j = period - j
            elif not (0 <= j < n):
                continue
            T[i, j] += w
    return T


@functools.lru_cache(maxsize=64)
def _band_matrix(taps: tuple, n: int, mode: str,
                 device: torch.device) -> torch.Tensor:
    """The band matrix as a float32 tensor, cached per device and size."""
    return torch.from_numpy(_band_matrix_np(taps, n, mode)).to(device)


def _sep_filter(x: torch.Tensor, taps_h, taps_w, mode: str) -> torch.Tensor:
    """Separable filter along (H, W) as two float32 matmuls."""
    h, w = x.shape[-2:]
    y = x.float()
    if taps_h is not None:
        Th = _band_matrix(tuple(float(t) for t in taps_h), h, mode, y.device)
        y = torch.matmul(Th, y)
    if taps_w is not None:
        Tw = _band_matrix(tuple(float(t) for t in taps_w), w, mode, y.device)
        y = torch.matmul(y, Tw.T)
    return y


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float,
                  quantize: bool = False) -> torch.Tensor:
    """Separable Gaussian blur with BORDER_REFLECT_101, matching
    ``cv2.GaussianBlur(src, (k, k), sigma)``; ``quantize`` rounds like the
    reference's uint8 outputs."""
    k = gaussian_taps(ksize, sigma)
    y = _sep_filter(x, k, k, "reflect101")
    if quantize:
        y = torch.floor(y + 0.5)
    return y


def conv_same_zero(x: torch.Tensor, kh, kw) -> torch.Tensor:
    """Separable 'same' convolution with zero padding along (H, W)."""
    return _sep_filter(x, np.asarray(kh), np.asarray(kw), "zero")


def _reduce_window_2d(x: torch.Tensor, ksize: int, fill: float) -> torch.Tensor:
    """Sliding max over a ``ksize`` square with offsets
    ``[-(k//2), (k-1)//2]`` and ``fill`` outside the frame (identity
    padding, as ``lax.reduce_window`` pads)."""
    lo, hi = ksize // 2, (ksize - 1) // 2
    shape = x.shape
    x4 = x.reshape(-1, 1, *shape[-2:])
    x4 = F.pad(x4, (lo, hi, lo, hi), value=fill)
    return F.max_pool2d(x4, ksize, stride=1).reshape(shape)


def max_filter(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Sliding-window maximum (grey dilation), -inf outside the frame."""
    return _reduce_window_2d(x, ksize, -float("inf"))


def min_filter(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Sliding-window minimum (grey erosion), +inf outside the frame."""
    return -_reduce_window_2d(-x, ksize, -float("inf"))


def morph_open(mask: torch.Tensor, ksize: int) -> torch.Tensor:
    """Binary opening (erode then dilate); each stage pads with its own
    identity, so the dilation sees -inf, not an erosion, past the border."""
    return max_filter(min_filter(mask, ksize), ksize)


def frame_hw(frames) -> tuple[int, int]:
    """(H, W) of a frame array, channel-last aware (trailing dim <= 4)."""
    if frames.ndim >= 3 and frames.shape[-1] <= 4:
        return frames.shape[-3], frames.shape[-2]
    return frames.shape[-2], frames.shape[-1]


def crop_frames(frames: torch.Tensor,
                crop_ratios: tuple[float, float, float, float] = (0, 0, 0, 0)
                ) -> torch.Tensor:
    """Ratio crop (left, right, top, bottom), matching
    ``marker_detection.py:81-85`` integer arithmetic."""
    h, w = frame_hw(frames)
    left = int(w * crop_ratios[0])
    right = w - int(w * crop_ratios[1])
    top = int(h * crop_ratios[2])
    bottom = h - int(h * crop_ratios[3])
    if frames.ndim >= 3 and frames.shape[-1] <= 4:
        return frames[..., top:bottom, left:right, :]
    return frames[..., top:bottom, left:right]
