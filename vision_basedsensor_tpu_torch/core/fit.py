"""Masked least-squares plane fits.

Port of ``vision_basedsensor_tpu/core/fit.py`` (``masked_mean``,
``masked_lstsq``, ``fit_plane``, ``fit_plane_robust``). The robust fit's
scale is a NaN-ignoring median that averages the two middle values, like
``jnp.nanmedian`` (``torch.nanmedian`` returns the lower one).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch.ops.moments import nanmedian


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None,
                keepdims: bool = False) -> torch.Tensor:
    m = mask.to(x.dtype)
    num = torch.sum(x * m, dim=axis, keepdim=keepdims)
    den = torch.clamp(torch.sum(m, dim=axis, keepdim=keepdims), min=1e-12)
    return num / den


def masked_lstsq(A: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``min ||A x - b||`` over rows where ``mask`` is set (normal equations
    with a tiny Tikhonov term). ``A (..., N, P)``, ``b``/``mask (..., N)``."""
    m = mask.to(A.dtype)[..., None]
    Am = A * m
    AtA = torch.einsum("...np,...nq->...pq", Am, A)
    Atb = torch.einsum("...np,...n->...p", Am, b)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(AtA + 1e-9 * eye, Atb[..., None])[..., 0]


class PlaneFit(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    tilt_deg: torch.Tensor


def _tilt(a, b):
    return torch.atan(torch.sqrt(a * a + b * b)) * (180.0 / math.pi)


def fit_plane(xyz: torch.Tensor, mask: torch.Tensor | None = None) -> PlaneFit:
    """Least-squares plane ``Z = aX + bY + c`` and its tilt angle
    (``ForceDistribution.py:138-162``)."""
    if mask is None:
        mask = torch.ones(xyz.shape[:-1], dtype=torch.bool, device=xyz.device)
    ones = torch.ones_like(xyz[..., 0])
    A = torch.stack([xyz[..., 0], xyz[..., 1], ones], dim=-1)
    coeff = masked_lstsq(A, xyz[..., 2], mask)
    a, b, c = coeff[..., 0], coeff[..., 1], coeff[..., 2]
    return PlaneFit(a, b, c, _tilt(a, b))


def fit_plane_robust(xyz: torch.Tensor, mask: torch.Tensor | None = None,
                     iters: int = 3, tukey_c: float = 4.685) -> PlaneFit:
    """IRLS plane fit with Tukey biweight; the scale is 1.4826 x the masked
    median absolute residual."""
    if mask is None:
        mask = torch.ones(xyz.shape[:-1], dtype=torch.bool, device=xyz.device)
    ones = torch.ones_like(xyz[..., 0])
    A = torch.stack([xyz[..., 0], xyz[..., 1], ones], dim=-1)
    z = xyz[..., 2]
    w = mask.to(z.dtype)
    coeff = masked_lstsq(A, z, w)
    for _ in range(iters):
        r = torch.einsum("...np,...p->...n", A, coeff) - z
        absr = torch.where(mask, torch.abs(r), torch.full_like(r, float("nan")))
        med = nanmedian(absr, dim=-1, keepdim=True)
        # An all-False mask gives a NaN median; keep the weights finite.
        scale = torch.clamp(1.4826 * torch.nan_to_num(med, nan=1.0), min=1e-6)
        u = torch.clamp(r / (tukey_c * scale), -1.0, 1.0)
        w = mask.to(z.dtype) * (1.0 - u * u) ** 2
        coeff = masked_lstsq(A, z, w)
    a, b, c = coeff[..., 0], coeff[..., 1], coeff[..., 2]
    return PlaneFit(a, b, c, _tilt(a, b))
