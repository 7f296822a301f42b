"""Extrinsic calibration: batched-hypothesis RANSAC PnP (reference C11).

Port of ``vision_basedsensor_tpu/calibrate/pnp.py`` in float64 tensors, in
place of ``cv2.solvePnPRansac(SOLVEPNP_ITERATIVE, conf=0.99, err=8px,
iters=1000)`` (``extrinsic_calibration.py:97-106``): all RANSAC hypotheses
are one batch axis (minimal 6-point DLT solves as one batched SVD, or
4-point homographies for a planar target), inliers counted for all of them
at once, then ``pnp_refine_iters`` Gauss-Newton steps on the best
hypothesis's inliers.

The hypotheses' indices are drawn from a ``torch.Generator`` on the
camera's device seeded by ``key``: ``jax.random.choice`` per key cannot be
reproduced in PyTorch, so the samples differ from the reference's. Their
scoring (:func:`score_hypotheses`) and everything after it
(:func:`solve_from_hypotheses`) take any indices, and on the reference's
own indices agree with it.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch.calibrate.homography import fit_homography
from vision_basedsensor_tpu_torch.calibrate.zhang import (
    extrinsics_from_homography, lstsq_svd, project_posed)
from vision_basedsensor_tpu_torch.config import CalibrateConfig
from vision_basedsensor_tpu_torch.core import camera as cam_mod
from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.core.transforms import (inverse_rodrigues,
                                                          rodrigues)


class PnPResult(NamedTuple):
    R_wc: torch.Tensor              # (3, 3)
    T_wc: torch.Tensor              # (3,)
    inliers: torch.Tensor           # (N,) bool
    num_inliers: torch.Tensor
    mean_reproj_error: torch.Tensor  # over ALL points (extrinsic_calibration.py:117-118)
    # 1 - (1 - w^m)^n_hyp for the final inlier ratio w: the chance that the
    # fixed hypothesis batch held an all-inlier sample. cv2 adapts its
    # iteration count to cfg.ransac_confidence; here the batch is fixed and
    # the confidence is verified instead (a warning when it falls short).
    achieved_confidence: torch.Tensor


class PnPProblem(NamedTuple):
    """A PnP problem in float64 on the camera's device: world points, pixel
    points, their undistorted normalized coordinates, the camera, the
    sample size (4 planar, 6 general) and, for a planar target, the
    plane's centroid ``(3,)``, in-plane basis ``(3, 2)`` and right-handed
    frame ``(3, 3)``."""
    obj: torch.Tensor
    img: torch.Tensor
    img_norm: torch.Tensor
    cam: CameraModel
    m_min: int
    plane: tuple | None


def prepare(object_points, image_points, cam: CameraModel) -> PnPProblem:
    """The problem of ``object_points`` ``(N, 3)`` (e.g. CMM-measured
    markers, ``extrinsic_calibration.py:276-288``) seen at distorted pixels
    ``image_points`` ``(N, 2)``; raises when N is below the sample size."""
    dev = cam.fx.device
    cam = CameraModel(*(torch.as_tensor(v, dtype=torch.float64, device=dev)
                        for v in cam))
    obj = torch.as_tensor(object_points, dtype=torch.float64, device=dev)
    img = torch.as_tensor(image_points, dtype=torch.float64, device=dev)
    n = obj.shape[0]
    img_norm = cam_mod.undistort_points(cam, img, iters=10, to_pixels=False)
    # Coplanar world points make every 6-point DLT rank-deficient: they take
    # 4-point homography hypotheses and Zhang's homography -> pose
    # decomposition composed with the plane basis (a host-side branch, as
    # in the reference).
    centroid = obj.mean(dim=0)
    _, s_sv, vt_sv = torch.linalg.svd(obj - centroid, full_matrices=False)
    s_sv = s_sv.tolist()
    planar = s_sv[2] < 1e-4 * max(s_sv[0], 1e-12)
    m_min = 4 if planar else 6
    if n < m_min:
        raise ValueError(
            f"PnP needs at least {m_min} matched world/pixel marker "
            f"correspondences ({'planar' if planar else 'general'} target), "
            f"got {n}")
    plane = None
    if planar:
        basis = vt_sv[:2].T                                   # (3, 2)
        b3 = torch.cat([basis, torch.linalg.cross(basis[:, 0],
                                                  basis[:, 1])[:, None]], 1)
        plane = (centroid, basis, b3)
    return PnPProblem(obj, img, img_norm, cam, m_min, plane)


def _dlt_pnp(obj: torch.Tensor, img_norm: torch.Tensor):
    """Minimal DLT solves for P = [R|t], batched: ``obj`` ``(H, m, 3)``,
    ``img_norm`` ``(H, m, 2)`` with m >= 6."""
    X, Y, Z = obj[..., 0], obj[..., 1], obj[..., 2]
    u, v = img_norm[..., 0], img_norm[..., 1]
    one, zero = torch.ones_like(X), torch.zeros_like(X)
    r1 = torch.stack([X, Y, Z, one, zero, zero, zero, zero,
                      -u * X, -u * Y, -u * Z, -u], -1)
    r2 = torch.stack([zero, zero, zero, zero, X, Y, Z, one,
                      -v * X, -v * Y, -v * Z, -v], -1)
    A = torch.cat([r1, r2], dim=-2)
    vt = torch.linalg.svd(A, full_matrices=True)[2]
    P = vt[..., -1, :].reshape(A.shape[:-2] + (3, 4))
    # Fix scale and sign: unit-determinant rotation part, points in front.
    Rraw = P[..., :3]
    scale = torch.abs(torch.linalg.det(Rraw)) ** (1.0 / 3.0)
    depth = (obj @ Rraw[..., 2, :, None])[..., 0] + P[..., 2, 3, None]
    sgn = torch.sign(depth.mean(-1))
    P = P * sgn[..., None, None] / torch.clamp(scale, min=1e-12)[..., None, None]
    u_, _, vt_ = torch.linalg.svd(P[..., :3])
    return u_ @ vt_, P[..., :, 3]


def _reproj_error(cam, R, t, obj, img_px):
    return torch.linalg.vector_norm(project_posed(cam, R, t, obj) - img_px,
                                    dim=-1)


def score_hypotheses(prob: PnPProblem, idx: torch.Tensor, threshold: float):
    """Poses of the hypotheses ``idx`` ``(H, m_min)`` (sample indices) and
    their inlier counts among all points at ``threshold`` px:
    ``(scores (H,), R (H, 3, 3), t (H, 3))``."""
    obj, img_norm = prob.obj, prob.img_norm
    if prob.plane is None:
        R, t = _dlt_pnp(obj[idx], img_norm[idx])
    else:
        centroid, basis, b3 = prob.plane
        q = (obj - centroid) @ basis                          # (N, 2)
        H = fit_homography(q[idx], img_norm[idx])
        eye3 = torch.eye(3, dtype=obj.dtype, device=obj.device)
        R_p, t_p = extrinsics_from_homography(eye3, H)
        # x_cam = R_wc (C + B q) + T_wc, so R_wc = [r1 r2 r3] B^T.
        R = R_p @ b3.T
        t = t_p - (R @ centroid[:, None])[..., 0]
    err = _reproj_error(prob.cam, R, t, obj, prob.img)        # (H, N)
    return (err < threshold).sum(-1), R, t


def _gauss_newton(cam, R0, t0, obj, img_px, weights, iters: int):
    def residuals(p):
        r = (project_posed(cam, rodrigues(p[:3]), p[3:], obj) - img_px)
        return (r * weights[:, None]).reshape(-1)

    jac = torch.func.jacfwd(residuals)
    p = torch.cat([inverse_rodrigues(R0), t0])
    for _ in range(iters):
        p = p - lstsq_svd(jac(p), residuals(p))
    return rodrigues(p[:3]), p[3:]


def solve_from_hypotheses(prob: PnPProblem, idx: torch.Tensor,
                          cfg: CalibrateConfig) -> PnPResult:
    """RANSAC over the hypotheses ``idx`` then the iterative refinement:
    the best-scoring pose (the first of equal scores), Gauss-Newton on its
    inliers, the result's inliers over all points."""
    thr = cfg.ransac_reproj_threshold_px
    scores, Rs, ts = score_hypotheses(prob, idx, thr)
    best = torch.argmax(scores)
    R_b, t_b = Rs[best], ts[best]
    obj, img, cam = prob.obj, prob.img, prob.cam
    inl = _reproj_error(cam, R_b, t_b, obj, img) < thr
    R, t = _gauss_newton(cam, R_b, t_b, obj, img, inl.to(obj.dtype),
                         cfg.pnp_refine_iters)
    err_all = _reproj_error(cam, R, t, obj, img)
    inliers = err_all < thr
    n_hyp = idx.shape[0]
    w = inliers.sum() / obj.shape[0]
    achieved = 1.0 - (1.0 - torch.clamp(w, 0.0, 1.0) ** prob.m_min) ** n_hyp
    if float(achieved) < cfg.ransac_confidence:
        warnings.warn(
            f"RANSAC achieved confidence {float(achieved):.4f} < requested "
            f"{cfg.ransac_confidence} (inlier ratio {float(w):.2f}, "
            f"{n_hyp} hypotheses); raise CalibrateConfig.ransac_iterations.",
            stacklevel=3)
    return PnPResult(R_wc=R, T_wc=t, inliers=inliers,
                     num_inliers=inliers.sum(),
                     mean_reproj_error=torch.mean(err_all),
                     achieved_confidence=achieved)


def draw_hypotheses(n: int, m_min: int, n_hyp: int, key: int,
                    device) -> torch.Tensor:
    """``(n_hyp, m_min)`` distinct sample indices of ``n`` points each,
    from a generator on ``device`` seeded by ``key``."""
    gen = torch.Generator(device=device).manual_seed(key)
    keys = torch.rand((n_hyp, n), generator=gen, device=device)
    return keys.argsort(dim=-1)[:, :m_min]


def solve_pnp_ransac(object_points, image_points, cam: CameraModel,
                     cfg: CalibrateConfig, key: int = 0) -> PnPResult:
    """RANSAC + iterative refinement PnP of ``object_points`` ``(N, 3)``
    seen at distorted pixels ``image_points`` ``(N, 2)`` through ``cam``
    (intrinsics and distortion), in float64 on the camera's device.
    Deterministic given ``key``."""
    prob = prepare(object_points, image_points, cam)
    idx = draw_hypotheses(prob.obj.shape[0], prob.m_min,
                          cfg.ransac_iterations, key, prob.obj.device)
    return solve_from_hypotheses(prob, idx, cfg)
