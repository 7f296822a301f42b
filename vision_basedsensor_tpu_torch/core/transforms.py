"""Rigid-body transforms.

Port of ``vision_basedsensor_tpu/core/transforms.py``: Rodrigues' formula
both ways and the world <-> camera maps, batched over leading axes. Every
branch is a ``torch.where`` over both regimes (no Python ``if`` on values),
so the functions run under ``torch.func.jacfwd`` / ``vmap`` as the
reference's run under ``jax.jacfwd``.
"""
from __future__ import annotations

import torch


def _skew(k: torch.Tensor) -> torch.Tensor:
    """Cross-product matrices ``(..., 3, 3)`` of vectors ``(..., 3)``."""
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zeros = torch.zeros_like(kx)
    return torch.stack([
        torch.stack([zeros, -kz, ky], dim=-1),
        torch.stack([kz, zeros, -kx], dim=-1),
        torch.stack([-ky, kx, zeros], dim=-1),
    ], dim=-2)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector(s) ``(..., 3)`` -> rotation matrix(es) ``(..., 3, 3)``,
    with the second-order Taylor form below theta = 1e-8."""
    theta = torch.linalg.vector_norm(rvec, dim=-1)[..., None, None]
    safe = torch.clamp(theta, min=1e-12)
    K = _skew(rvec / safe[..., 0])
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    Kraw = K * safe
    R_small = eye + Kraw + 0.5 * (Kraw @ Kraw)
    return torch.where(theta < 1e-8, R_small, R)


def inverse_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix(es) ``(..., 3, 3)`` -> rotation vector(s) ``(..., 3)``.

    The reference's three regimes, both sides of each computed: generic
    (axis from the antisymmetric part), theta -> 0 (w / 2), and theta -> pi,
    where the axis comes from ``k k^T = (R + I) / 2`` through its largest
    diagonal, signed by the residual antisymmetric part.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    # sin from |w| = 2 sin(theta) and theta = atan2(sin, cos): well
    # conditioned up to pi, unlike arccos(cos_t).
    sin_t = 0.5 * torch.linalg.vector_norm(w, dim=-1)
    theta = torch.atan2(sin_t, cos_t)
    small = (sin_t < 1e-7)[..., None]
    scale = torch.where(small, torch.full_like(small, 0.5, dtype=R.dtype),
                        theta[..., None]
                        / torch.clamp(2.0 * sin_t[..., None], min=1e-30))
    rv_generic = w * scale

    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    S = (R + eye) * 0.5
    diag = torch.diagonal(S, dim1=-2, dim2=-1)                 # (..., 3)
    i = torch.argmax(diag, dim=-1, keepdim=True)               # (..., 1)
    col = torch.gather(S, -1, i[..., None].expand(S.shape[:-1] + (1,)))[..., 0]
    kii = torch.gather(diag, -1, i)                            # (..., 1)
    k = col / torch.sqrt(torch.clamp(kii, min=1e-12))
    flip = torch.sum(k * w, dim=-1, keepdim=True) < 0.0        # 0 keeps k
    k = torch.where(flip, -k, k)
    rv_pi = theta[..., None] * k

    near_pi = small & (cos_t[..., None] < 0.0)
    return torch.where(near_pi, rv_pi, rv_generic)


def world_to_cam(p_world: torch.Tensor, R_wc: torch.Tensor,
                 T_wc: torch.Tensor) -> torch.Tensor:
    """``P_cam = R @ P_world + T`` for points ``(..., 3)``."""
    return p_world @ R_wc.T + T_wc.reshape(3)


def cam_to_world(p_cam: torch.Tensor, R_wc: torch.Tensor,
                 T_wc: torch.Tensor) -> torch.Tensor:
    """``P_world = R^T (P_cam - T)``, the inverse map of
    ``3d_reconstruction.py:228``."""
    return (p_cam - T_wc.reshape(3)) @ R_wc
