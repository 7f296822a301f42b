"""Baseline JPEG decoding from the quantized coefficients: dequantization,
the 8x8 inverse DCT as one float32 matmul, level shift, rounding and
clamping (a frozen copy of the port's ``ops/jpeg.py:_dequant_idct``). The
entropy-coded stage is lossless, so the coefficients that the benchmark's
encoder wrote are what any decoder's entropy stage recovers."""
from __future__ import annotations

import functools

import numpy as np
import torch

# Natural index of each zigzag scan position (T.81 figure A.6).
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


@functools.cache
def _idct64_zigzag() -> np.ndarray:
    """``M[z, (i, j)] = A[i, k] A[j, l]`` for the zigzag position ``z`` of
    ``(k, l)``, with ``A[i, k] = alpha(k) cos((2i+1) k pi / 16)``."""
    k = np.arange(8)
    i = np.arange(8)[:, None]
    a = np.cos((2 * i + 1) * k * np.pi / 16.0)
    a *= np.where(k == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    a = a.astype(np.float32)
    m = np.einsum("ik,jl->klij", a, a).reshape(64, 64).astype(np.float32)
    return m[ZIGZAG]


def decode(coeffs: torch.Tensor, qtable: np.ndarray, height: int,
           width: int) -> torch.Tensor:
    """Quantized zigzag coefficients ``(B, bh * bw, 64)`` and the natural-
    order quantization table ``(64,)`` -> float32 frames ``(B, H, W)`` in
    0..255."""
    dev = coeffs.device
    b = coeffs.shape[0]
    bh, bw = -(-height // 8), -(-width // 8)
    m = torch.as_tensor(_idct64_zigzag(), device=dev)
    q = torch.as_tensor(np.asarray(qtable)[ZIGZAG], dtype=torch.float32,
                        device=dev)
    px = torch.matmul((coeffs.to(torch.float32) * q).reshape(b, bh * bw, 64),
                      m) + 128.0
    img = (px.reshape(b, bh, bw, 8, 8).permute(0, 1, 3, 2, 4)
           .reshape(b, bh * 8, bw * 8))
    img = torch.clamp(torch.floor(img + 0.5), 0.0, 255.0)
    return img[:, :height, :width]
