"""Masked least-squares plane fits.

Port of ``vision_basedsensor_tpu/core/fit.py`` (``masked_mean``,
``masked_lstsq``, ``fit_plane``, ``fit_plane_robust``,
``ellipse_from_moments``). The robust fit's
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
    # ``solve``'s LU without its error check, which waits for the card; the
    # Tikhonov term keeps the system regular (``jnp.linalg.solve`` does not
    # raise either).
    x, _ = torch.linalg.solve_ex(AtA + 1e-9 * eye, Atb[..., None],
                                 check_errors=False)
    return x[..., 0]


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


class EllipseMoments(NamedTuple):
    """Ellipse parameters recovered from second-order region moments."""
    center: torch.Tensor     # (..., 2) (x, y)
    major: torch.Tensor      # full major axis length
    minor: torch.Tensor      # full minor axis length
    angle_deg: torch.Tensor  # major-axis angle, degrees in [0, 180)
    area: torch.Tensor       # zeroth moment (pixel count for binary weights)


def ellipse_from_moments(weights: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> EllipseMoments:
    """Fit an ellipse to a weighted pixel region via central moments
    (``marker_detection.py:196-217``'s ``cv2.fitEllipse`` role): for a
    filled ellipse of semi-axes (p, q) the covariance eigenvalues are
    p^2/4 and q^2/4, so the full axes are ``4 sqrt(eig)``. ``weights``,
    ``x`` and ``y`` broadcast over ``(..., N)`` pixels."""
    w = weights
    total = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    mx = torch.sum(w * x, dim=-1) / total
    my = torch.sum(w * y, dim=-1) / total
    dx = x - mx[..., None]
    dy = y - my[..., None]
    mxx = torch.sum(w * dx * dx, dim=-1) / total
    myy = torch.sum(w * dy * dy, dim=-1) / total
    mxy = torch.sum(w * dx * dy, dim=-1) / total
    # Closed-form 2x2 symmetric eigendecomposition.
    tr = mxx + myy
    diff = mxx - myy
    disc = torch.sqrt(torch.clamp(diff * diff + 4.0 * mxy * mxy, min=0.0))
    lam1 = 0.5 * (tr + disc)  # major
    lam2 = 0.5 * (tr - disc)  # minor
    angle = 0.5 * torch.atan2(2.0 * mxy, diff)  # radians, major-axis direction
    # torch.remainder takes the divisor's sign, as jnp.mod does: [0, 180).
    angle_deg = torch.remainder(torch.rad2deg(angle), 180.0)
    return EllipseMoments(
        center=torch.stack([mx, my], dim=-1),
        major=4.0 * torch.sqrt(torch.clamp(lam1, min=0.0)),
        minor=4.0 * torch.sqrt(torch.clamp(lam2, min=0.0)),
        angle_deg=angle_deg,
        area=total,
    )
