"""Normalized DLT homography estimation, batched.

Port of ``vision_basedsensor_tpu/calibrate/homography.py``: Hartley
normalization, one batched ``torch.linalg.svd`` of the 2N x 9 DLT systems,
then the denormalization solve.
"""
from __future__ import annotations

import math

import torch


def _normalize(pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalization: translate to the centroid, scale to a mean
    distance of sqrt(2). Returns the points and the ``(..., 3, 3)`` map."""
    c = pts.mean(dim=-2, keepdim=True)
    d = torch.linalg.vector_norm(pts - c, dim=-1).mean(dim=-1)
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-12)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * c[..., 0, 0]], dim=-1),
        torch.stack([zero, s, -s * c[..., 0, 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return (pts - c) * s[..., None, None], T


def fit_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Homography H with ``dst ~ H @ src`` for point sets ``(..., N, 2)``."""
    sn, Ts = _normalize(src)
    dn, Td = _normalize(dst)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    # The null vector is the last right singular vector (full_matrices
    # keeps it when 2N < 9).
    vt = torch.linalg.svd(A, full_matrices=True)[2]
    h = vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    H = torch.linalg.solve(Td, h @ Ts)
    return H / H[..., 2:3, 2:3]
