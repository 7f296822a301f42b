"""Calibration visualizations (reference C10/C11 figure content).

Port of ``vision_basedsensor_tpu/calibrate/plots.py`` (matplotlib is
imported when a figure is drawn; the arrays come to the host first):

* original-vs-undistorted comparison with horizontal rulers
  (``intrinsic_calibration.plot_comparison``, :111-137);
* 3D board poses with a camera glyph (``plot_3d_poses``, :139-185);
* extrinsic result: control points + camera frustum + world origin
  (``extrinsic_calibration.plot_3d_calibration_result``, :166-241).
"""
from __future__ import annotations

import numpy as np

import torch

from vision_basedsensor_tpu_torch.analysis.plots import set_axes_equal


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_undistort_comparison(image: np.ndarray, cam, path: str) -> None:
    """Side-by-side original vs undistorted frame with row rulers; the
    remap runs on the camera's device."""
    from vision_basedsensor_tpu_torch.core.undistort import (
        build_rectify_map, optimal_new_camera, remap_bilinear)
    plt = _mpl()
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    gray = img if img.ndim == 2 else img.mean(-1)
    new_cam = optimal_new_camera(cam, h, w, alpha=1.0)
    m = build_rectify_map(cam, h, w, new_cam)
    und = remap_bilinear(torch.as_tensor(gray, device=m.device),
                         m).cpu().numpy()

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    for ax, im, title, color in ((ax1, gray, "(a) Original", "r"),
                                 (ax2, und, "(b) Undistorted", "g")):
        ax.imshow(im, cmap="gray")
        ax.set_title(title)
        ax.axis("off")
        for y in range(h // 10, h, h // 10):
            ax.axhline(y, color=color, ls="--", lw=1, alpha=0.6)
    fig.suptitle("Calibration Results")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def plot_board_poses(rvecs, tvecs, pattern_size, square_mm, path: str) -> None:
    """3D scene of every calibration board pose plus a camera glyph."""
    from vision_basedsensor_tpu_torch.calibrate.images import \
        board_object_points
    from vision_basedsensor_tpu_torch.core.transforms import rodrigues
    plt = _mpl()
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")

    scale = square_mm * 2
    cam_pts = np.array([[0, 0, 0], [-scale, -scale, scale * 1.5],
                        [scale, -scale, scale * 1.5],
                        [scale, scale, scale * 1.5],
                        [-scale, scale, scale * 1.5]])
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    faces = [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 2, 3, 4]]
    ax.add_collection3d(Poly3DCollection(
        [cam_pts[f] for f in faces], facecolors="crimson", edgecolors="k",
        alpha=0.4, linewidths=0.8))

    objp = board_object_points(pattern_size, square_mm)
    for i, (rv, tv) in enumerate(zip(np.asarray(rvecs), np.asarray(tvecs))):
        R = rodrigues(torch.as_tensor(rv)).numpy()
        pts = objp @ R.T + tv
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c="steelblue", s=2, alpha=0.6)
        n0 = pattern_size[0]
        outline = pts[[0, n0 - 1, -1, -n0, 0]]
        ax.plot(outline[:, 0], outline[:, 1], outline[:, 2], c="navy",
                lw=0.8, alpha=0.7)
        cen = pts.mean(0)
        ax.text(cen[0], cen[1], cen[2], str(i + 1), fontsize=9)

    ax.set(xlabel="X (mm)", ylabel="Y (mm)", zlabel="Z (mm)",
           title="3D Camera Poses Visualization")
    set_axes_equal(ax)
    ax.view_init(elev=-60, azim=-90)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def plot_extrinsic_result(world_points: np.ndarray, R_wc: np.ndarray,
                          T_wc: np.ndarray, path: str,
                          title: str = "Extrinsic Calibration Result") -> None:
    """Control points, camera frustum at its world pose, world origin."""
    plt = _mpl()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    wp = np.asarray(world_points)
    fig = plt.figure(figsize=(12, 9))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(wp[:, 0], wp[:, 1], wp[:, 2], c="steelblue", marker="o", s=40,
               alpha=0.8, label="Control Points")

    R_cw = np.asarray(R_wc).T
    cam_pos = (-R_cw @ np.asarray(T_wc).reshape(3, 1)).ravel()
    scale = np.ptp(wp) * 0.2
    frustum = np.array([[0, 0, 0], [-1, -1, 2], [1, -1, 2],
                        [1, 1, 2], [-1, 1, 2]]) * scale
    fw = frustum @ R_cw.T + cam_pos
    faces = [[fw[0], fw[1], fw[2]], [fw[0], fw[2], fw[3]],
             [fw[0], fw[3], fw[4]], [fw[0], fw[4], fw[1]], fw[1:]]
    ax.add_collection3d(Poly3DCollection(faces, facecolors="crimson",
                                         edgecolors="darkred", alpha=0.25,
                                         linewidths=1))
    ax.scatter(*cam_pos, c="red", marker="s", s=100, label="Camera Position")
    ax.scatter(0, 0, 0, c="black", marker="x", s=100, label="World Origin")
    ax.set_xlabel("X (mm)")
    ax.set_ylabel("Y (mm)")
    ax.set_zlabel("Z (mm)")
    ax.set_title(title)
    set_axes_equal(ax)
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
