"""Intrinsic calibration: Zhang's method (reference C10).

Port of ``vision_basedsensor_tpu/calibrate/zhang.py``, in float64 tensors
(the reference scopes ``jax.enable_x64`` around it): batched DLT
homographies per view, the closed-form K from the absolute conic, per-view
extrinsics, then ``refine_iters`` Levenberg-Marquardt steps on
``[fx, fy, cx, cy, k1, k2, p1, p2, k3] + 6 per view`` against the
reprojection residuals (skew fixed at 0, OpenCV's default). The reference's
``lax.scan`` is a plain loop; ``jax.jacfwd`` is ``torch.func.jacfwd``; its
``jnp.linalg.lstsq`` is the same SVD solve (:func:`lstsq_svd`), so the
iterates agree (``torch.linalg.lstsq`` on CUDA solves by QR only).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch.calibrate.homography import fit_homography
from vision_basedsensor_tpu_torch.core.camera import (CameraModel,
                                                      distort_normalized,
                                                      normalized_to_pixel)
from vision_basedsensor_tpu_torch.core.device import CUDA, resolve
from vision_basedsensor_tpu_torch.core.transforms import (inverse_rodrigues,
                                                          rodrigues)


class ZhangResult(NamedTuple):
    cam: CameraModel                  # intrinsics (+ zero extrinsics)
    rvecs: torch.Tensor               # (V, 3) per-view rotations
    tvecs: torch.Tensor               # (V, 3) per-view translations
    mean_reproj_error: torch.Tensor   # RMS over all points (cv2-style)


def lstsq_svd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.lstsq(A, b, rcond=None)[0]`` for a vector ``b``: the
    SVD solve with singular values below ``eps * max(M, N) * s_max``
    treated as zero."""
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(A.dtype).eps * max(A.shape[-2:])
    mask = s >= rcond * s[..., :1]
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vt.mT @ (s_inv * (u.mT @ b))


def project_posed(cam: CameraModel, R: torch.Tensor, t: torch.Tensor,
                  p: torch.Tensor) -> torch.Tensor:
    """``project_points`` with the pose ``R`` ``(..., 3, 3)``, ``t``
    ``(..., 3)`` in place of the camera's: points ``(..., N, 3)`` -> pixels
    ``(..., N, 2)``, batched over the poses' leading axes."""
    p_cam = p @ R.mT + t[..., None, :]
    xy = p_cam[..., :2] / p_cam[..., 2:3]
    return normalized_to_pixel(cam, distort_normalized(cam, xy))


def intrinsic_camera(fx, fy, cx, cy, dist) -> CameraModel:
    """A zero-pose, zero-skew camera of scalar tensors (differentiable:
    no host round trip, unlike ``CameraModel.create``)."""
    zero = torch.zeros_like(fx)
    return CameraModel(fx, fy, cx, cy, zero, dist,
                       torch.eye(3, dtype=fx.dtype, device=fx.device),
                       torch.zeros(3, dtype=fx.dtype, device=fx.device))


def _vij(H: torch.Tensor, i: int, j: int) -> torch.Tensor:
    h = H  # (V, 3, 3), columns h[:, :, i]
    return torch.stack([
        h[:, 0, i] * h[:, 0, j],
        h[:, 0, i] * h[:, 1, j] + h[:, 1, i] * h[:, 0, j],
        h[:, 1, i] * h[:, 1, j],
        h[:, 2, i] * h[:, 0, j] + h[:, 0, i] * h[:, 2, j],
        h[:, 2, i] * h[:, 1, j] + h[:, 1, i] * h[:, 2, j],
        h[:, 2, i] * h[:, 2, j],
    ], dim=-1)


def _intrinsics_from_homographies(H: torch.Tensor) -> tuple:
    V = torch.cat([_vij(H, 0, 1), _vij(H, 0, 0) - _vij(H, 1, 1)], dim=0)
    vt = torch.linalg.svd(V, full_matrices=False)[2]
    b11, b12, b22, b13, b23, b33 = vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = torch.sqrt(torch.abs(lam / b11))
    fy = torch.sqrt(torch.abs(lam * b11 / (b11 * b22 - b12 * b12)))
    skew = -b12 * fx * fx * fy / lam
    # u0 = gamma v0 / beta - B13 alpha^2 / lambda: the reference's correction
    # of the typo in Zhang's paper (skew term divided by fy, not fx).
    cx = skew * cy / fy - b13 * fx * fx / lam
    return fx, fy, cx, cy


def extrinsics_from_homography(K_inv: torch.Tensor, H: torch.Tensor):
    """Board poses ``(R (..., 3, 3), t (..., 3))`` from homographies
    ``(..., 3, 3)``: the board in front of the camera (the sign fixed by
    ``t_z > 0`` before ``r3 = r1 x r2``), R orthonormalized by SVD."""
    KH = K_inv @ H
    h1, h2, h3 = KH[..., :, 0], KH[..., :, 1], KH[..., :, 2]
    lam = 1.0 / torch.linalg.vector_norm(h1, dim=-1, keepdim=True)
    lam = lam * torch.sign(h3[..., 2:3])
    r1 = lam * h1
    r2 = lam * h2
    r3 = torch.linalg.cross(r1, r2)
    t = lam * h3
    R = torch.stack([r1, r2, r3], dim=-1)
    u, _, vt = torch.linalg.svd(R)
    return u @ vt, t


def _pack(fx, fy, cx, cy, dist, rvecs, tvecs):
    return torch.cat([torch.stack([fx, fy, cx, cy]), dist,
                      rvecs.reshape(-1), tvecs.reshape(-1)])


def _unpack(p, n_views):
    dist = p[4:9]
    r = p[9:9 + 3 * n_views].reshape(n_views, 3)
    t = p[9 + 3 * n_views:].reshape(n_views, 3)
    return p[0], p[1], p[2], p[3], dist, r, t


def calibrate_intrinsics(object_points, image_points, refine_iters: int = 30,
                         device=CUDA) -> ZhangResult:
    """Full Zhang calibration of ``object_points`` ``(V, N, 3)`` (planar
    board, Z = 0) seen at ``image_points`` ``(V, N, 2)``, in float64 on
    ``device`` (the card by default)."""
    device = resolve(device)
    obj = torch.as_tensor(object_points, dtype=torch.float64, device=device)
    img = torch.as_tensor(image_points, dtype=torch.float64, device=device)
    n_views = obj.shape[0]
    # The closed-form init needs >= 3 views (intrinsic_calibration.py:92);
    # with fewer, svd(V)'s last row is no null vector.
    if n_views < 3:
        raise ValueError(f"Zhang calibration needs >= 3 views, got "
                         f"{n_views}")

    H = fit_homography(obj[..., :2], img)
    fx, fy, cx, cy = _intrinsics_from_homographies(H)
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]),
                     torch.stack([zero, zero, one])])
    Rs, ts = extrinsics_from_homography(torch.linalg.inv(K), H)
    rvecs = inverse_rodrigues(Rs)
    dist0 = torch.zeros(5, dtype=torch.float64, device=device)

    def residuals(p):
        fx, fy, cx, cy, dist, r, t = _unpack(p, n_views)
        cam = intrinsic_camera(fx, fy, cx, cy, dist)
        return (project_posed(cam, rodrigues(r), t, obj) - img).reshape(-1)

    jac = torch.func.jacfwd(residuals)
    p = _pack(fx, fy, cx, cy, dist0, rvecs, ts)
    lam = torch.tensor(1e-3, dtype=p.dtype, device=device)
    cost = torch.sum(residuals(p) ** 2)
    for _ in range(refine_iters):
        # Levenberg-Marquardt on the augmented system [J; sqrt(lam) *
        # diag(col norms)] dp = [r; 0], solved on J by SVD (the normal
        # equations would square the conditioning); a rejected step raises
        # the damping, so no iteration increases the cost.
        rsd = residuals(p)
        J = jac(p)
        col = torch.clamp(torch.sqrt(torch.sum(J * J, dim=0)), min=1e-12)
        A = torch.cat([J, torch.sqrt(lam) * torch.diag(col)], dim=0)
        b = torch.cat([rsd, torch.zeros_like(p)])
        p_new = p - lstsq_svd(A, b)
        new_cost = torch.sum(residuals(p_new) ** 2)
        accept = new_cost < cost
        p = torch.where(accept, p_new, p)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 10.0),
                          1e-12, 1e10)
        cost = torch.where(accept, new_cost, cost)

    fx, fy, cx, cy, dist, rvecs, tvecs = _unpack(p, n_views)
    cam = intrinsic_camera(fx, fy, cx, cy, dist)
    # cv2.calibrateCamera's returned error is the RMS over all residuals.
    rsd = residuals(p).reshape(-1, 2)
    rms = torch.sqrt(torch.mean(torch.sum(rsd ** 2, dim=-1)))
    return ZhangResult(cam=cam, rvecs=rvecs, tvecs=tvecs,
                       mean_reproj_error=rms)
