"""The port's calibration (``core/transforms.py``, ``calibrate/``) against the
JAX package's on the same float64 inputs, on the CPU.

Tolerances, from the observed agreement: transforms within 1e-12 (observed
0); homographies within 1e-9 (observed ~1e-13); Zhang's intrinsics within
1e-6 relative and its RMS within 1e-9 (observed ~1e-14 and ~1e-15: the same
SVD solve, the same iterates); PnP's inlier counts equal on the reference's
own hypothesis indices and its pose within 1e-6 (observed ~1e-16). The
chessboard detector is compared by ``found`` and its corners within 1e-3 px:
its peak threshold (``0.15 * max(response)``) depends on the last bits of
the float32 filters, so the raw peak lists are not compared.
"""
import csv
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import run_jax_cli, run_port_cli

from vision_basedsensor_tpu.calibrate import calibrate_intrinsics as jzhang
from vision_basedsensor_tpu.calibrate import fit_homography as jhomog
from vision_basedsensor_tpu.calibrate import solve_pnp_ransac as jpnp
from vision_basedsensor_tpu.calibrate.chessboard import \
    find_chessboard as jfind
from vision_basedsensor_tpu.calibrate.images import \
    calibrate_from_images as jfrom_images
from vision_basedsensor_tpu.calibrate.pnp import _dlt_pnp, _reproj_error
from vision_basedsensor_tpu.calibrate.zhang import \
    _extrinsics_from_homography
from vision_basedsensor_tpu.config import CalibrateConfig as JCal
from vision_basedsensor_tpu.core import camera as jcam
from vision_basedsensor_tpu.core import transforms as jt

from vision_basedsensor_tpu_torch import layout
from vision_basedsensor_tpu_torch.calibrate import calibrate_intrinsics
from vision_basedsensor_tpu_torch.calibrate import fit_homography
from vision_basedsensor_tpu_torch.calibrate import pnp as tpnp
from vision_basedsensor_tpu_torch.calibrate.chessboard import find_chessboard
from vision_basedsensor_tpu_torch.calibrate.images import (
    board_object_points, calibrate_from_images)
from vision_basedsensor_tpu_torch.config import CalibrateConfig
from vision_basedsensor_tpu_torch.core import transforms as tt
from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.io import xlsx

K_TRUE = np.array([[620.0, 0, 310.0], [0, 600.0, 245.0], [0, 0, 1]])
DIST = np.array([-0.15, 0.07, 0.0008, -0.0006, 0.02])


def _jcam():
    return jcam.CameraModel.create(K_TRUE[0, 0], K_TRUE[1, 1], K_TRUE[0, 2],
                                   K_TRUE[1, 2], 0.0, DIST,
                                   dtype=jnp.float64)


def _tcam():
    return CameraModel.create(K_TRUE[0, 0], K_TRUE[1, 1], K_TRUE[0, 2],
                              K_TRUE[1, 2], 0.0, DIST, dtype=torch.float64,
                              device="cpu")


def _project(rvec, tvec, pts):
    c = _jcam()._replace(R_wc=jt.rodrigues(jnp.asarray(rvec)),
                         T_wc=jnp.asarray(tvec))
    return np.asarray(jcam.project_points(c, jnp.asarray(pts)))


def _views(n_views, noise, seed):
    """8 views of a 6x6 board (3 mm squares) through the reference test's
    camera (tests/test_calibrate.py:_views)."""
    rng = np.random.default_rng(seed)
    obj = board_object_points((6, 6), 3.0)
    objs, imgs = [], []
    for _ in range(n_views):
        rvec = rng.uniform(-0.35, 0.35, 3)
        tvec = np.array([rng.uniform(-8, 2), rng.uniform(-8, 2),
                         rng.uniform(45, 75)])
        objs.append(obj)
        imgs.append(_project(rvec, tvec, obj)
                    + rng.normal(0, noise, (obj.shape[0], 2)))
    return np.stack(objs), np.stack(imgs)


def _unit_axis():
    ax = np.array([0.3, -0.5, 0.8])
    return ax / np.linalg.norm(ax)


@pytest.mark.parametrize("theta", [0.0, 1e-8, 1.0, math.pi - 1e-3, math.pi])
def test_transforms_at_the_branch_points(theta):
    rvec = _unit_axis() * theta
    R_j = np.asarray(jt.rodrigues(jnp.asarray(rvec)))
    R_t = tt.rodrigues(torch.tensor(rvec)).numpy()
    np.testing.assert_allclose(R_t, R_j, rtol=0, atol=1e-12)
    v_j = np.asarray(jt.inverse_rodrigues(jnp.asarray(R_j)))
    v_t = tt.inverse_rodrigues(torch.tensor(R_j)).numpy()
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(v_t, rvec, rtol=0, atol=1e-6)
    # Branch-free: forward-mode derivatives exist at every point.
    J = torch.func.jacfwd(tt.rodrigues)(torch.tensor(rvec))
    assert J.shape == (3, 3, 3)


def test_transforms_batched_and_world_maps(rng):
    rvecs = rng.uniform(-2.5, 2.5, (7, 3))
    R_j = np.asarray(jt.rodrigues(jnp.asarray(rvecs)))
    R_t = tt.rodrigues(torch.tensor(rvecs))
    np.testing.assert_allclose(R_t.numpy(), R_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tt.inverse_rodrigues(R_t).numpy(),
                               np.asarray(jt.inverse_rodrigues(R_j)),
                               rtol=0, atol=1e-12)
    p = rng.normal(size=(11, 3))
    T = np.array([1.0, -2.0, 40.0])
    cam_p = tt.world_to_cam(torch.tensor(p), R_t[0], torch.tensor(T))
    np.testing.assert_allclose(
        cam_p.numpy(), np.asarray(jt.world_to_cam(jnp.asarray(p),
                                                  jnp.asarray(R_j[0]),
                                                  jnp.asarray(T))), atol=1e-12)
    back = tt.cam_to_world(cam_p, R_t[0], torch.tensor(T))
    np.testing.assert_allclose(back.numpy(), p, atol=1e-12)


def test_fit_homography_batched(rng):
    H_true = np.array([[1.2, 0.1, 30.0], [-0.05, 0.9, -12.0],
                       [1e-4, -2e-4, 1.0]])
    src = rng.uniform(0, 100, (3, 40, 2))
    dst_h = np.concatenate([src, np.ones((3, 40, 1))], -1) @ H_true.T
    dst = dst_h[..., :2] / dst_h[..., 2:] + rng.normal(0, 0.05, src.shape)
    H_j = np.asarray(jhomog(jnp.asarray(src), jnp.asarray(dst)))
    H_t = fit_homography(torch.tensor(src), torch.tensor(dst)).numpy()
    np.testing.assert_allclose(H_t, H_j, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("noise", [0.0, 0.2])
def test_zhang_matches_jax(noise):
    objs, imgs = _views(8, noise, seed=3)
    rj = jzhang(objs, imgs)
    rt = calibrate_intrinsics(objs, imgs, device="cpu")
    for name in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(float(getattr(rt.cam, name)),
                                   float(getattr(rj.cam, name)), rtol=1e-6)
    np.testing.assert_allclose(rt.cam.dist.numpy(), np.asarray(rj.cam.dist),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(rt.mean_reproj_error),
                               float(rj.mean_reproj_error), rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.rvecs.numpy(), np.asarray(rj.rvecs),
                               atol=1e-6)
    np.testing.assert_allclose(rt.tvecs.numpy(), np.asarray(rj.tvecs),
                               atol=1e-6)
    if noise == 0.0:
        assert abs(float(rt.cam.fx) - K_TRUE[0, 0]) < 0.1
        assert float(rt.mean_reproj_error) < 1e-3


def test_zhang_needs_three_views():
    objs, imgs = _views(2, 0.0, seed=0)
    with pytest.raises(ValueError, match=">= 3 views"):
        calibrate_intrinsics(objs, imgs, device="cpu")


def _pnp_problem(planar, rng):
    """The 65 markers' world points (flattened onto Z = 0 for a planar
    target) seen through a known pose, 0.3 px noise and 7 outliers moved
    by 20-40 px."""
    world = layout.dome_layout()[:, 1:].astype(np.float64)
    if planar:
        world[:, 2] = 0.0
    rvec, tvec = np.array([0.1, -0.2, 0.05]), np.array([1.0, -2.0, 45.0])
    img = _project(rvec, tvec, world) + rng.normal(0, 0.3, (65, 2))
    out = rng.choice(65, 7, replace=False)
    img[out] += rng.uniform(20, 40, (7, 2)) * rng.choice([-1, 1], (7, 2))
    return world, img, out


def _jax_hypotheses(world, img, planar, key=0, n_hyp=1000):
    """The reference's hypothesis indices (pnp.py:125-127) and scores."""
    cam = _jcam()
    obj, im = jnp.asarray(world), jnp.asarray(img)
    img_norm = jcam.undistort_points(cam, im, iters=10, to_pixels=False)
    m = 4 if planar else 6
    keys = jax.random.split(jax.random.PRNGKey(key), n_hyp)
    idx = jax.vmap(lambda k: jax.random.choice(k, 65, (m,),
                                               replace=False))(keys)
    if planar:
        c = obj.mean(axis=0)
        basis = jnp.linalg.svd(obj - c, full_matrices=False)[2][:2].T
        b3 = jnp.concatenate([basis, jnp.cross(basis[:, 0],
                                               basis[:, 1])[:, None]], 1)
        q = (obj - c) @ basis

        def pose(i):
            H = jhomog(q[i][None], img_norm[i][None])[0]
            R_p, t_p = _extrinsics_from_homography(jnp.eye(3), H)
            R = R_p @ b3.T
            return R, t_p - R @ c
    else:
        def pose(i):
            return _dlt_pnp(obj[i], img_norm[i])

    def score(i):
        R, t = pose(i)
        return (_reproj_error(cam, R, t, obj, im) < 8.0).sum(), R

    scores, Rs = jax.vmap(score)(idx)
    return np.array(idx), np.asarray(scores), np.asarray(Rs)


@pytest.mark.parametrize("planar", [False, True])
def test_pnp_matches_jax_on_its_hypotheses(planar):
    rng = np.random.default_rng(7)
    world, img, out = _pnp_problem(planar, rng)
    idx, scores_j, Rs_j = _jax_hypotheses(world, img, planar)
    prob = tpnp.prepare(world, img, _tcam())
    assert prob.m_min == (4 if planar else 6)
    scores_t, Rs_t, _ = tpnp.score_hypotheses(prob, torch.from_numpy(idx),
                                              8.0)
    # A near-degenerate sample's pose is ill-conditioned: the general
    # target's counts are all equal; the planar target's (4-point
    # homographies) differ on 3 of 1,000 samples by one point at the 8 px
    # threshold (observed). Samples that explain most points agree exactly,
    # and so do their poses.
    diff = scores_t.numpy() - scores_j
    assert (diff != 0).sum() <= (0 if not planar else 5)
    assert np.abs(diff).max() <= 1
    good = scores_j >= 33
    assert good.sum() >= 100
    np.testing.assert_array_equal(scores_t.numpy()[good], scores_j[good])
    np.testing.assert_allclose(Rs_t.numpy()[good], Rs_j[good], atol=1e-6)

    rj = jpnp(world, img, _jcam(), JCal(), key=0)
    rt = tpnp.solve_from_hypotheses(prob, torch.from_numpy(idx),
                                    CalibrateConfig())
    np.testing.assert_allclose(rt.R_wc.numpy(), np.asarray(rj.R_wc),
                               atol=1e-6)
    np.testing.assert_allclose(rt.T_wc.numpy(), np.asarray(rj.T_wc),
                               atol=1e-6)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(float(rt.mean_reproj_error),
                               float(rj.mean_reproj_error), atol=1e-6)

    # The port's own draw (a torch.Generator): the same pose and inliers.
    own = tpnp.solve_pnp_ransac(world, img, _tcam(), CalibrateConfig())
    assert sorted(np.where(~own.inliers.numpy())[0]) == sorted(out)
    np.testing.assert_allclose(own.R_wc.numpy(), np.asarray(rj.R_wc),
                               atol=1e-6)
    np.testing.assert_allclose(own.T_wc.numpy(), np.asarray(rj.T_wc),
                               atol=1e-6)


def test_pnp_hypotheses_draw_distinct_indices_and_too_few_points_raise():
    idx = tpnp.draw_hypotheses(65, 6, 1000, 3, torch.device("cpu"))
    assert idx.shape == (1000, 6)
    assert all(len(set(r)) == 6 for r in idx.tolist())
    assert torch.equal(idx, tpnp.draw_hypotheses(65, 6, 1000, 3,
                                                 torch.device("cpu")))
    world = layout.dome_layout()[:5, 1:].astype(np.float64)
    with pytest.raises(ValueError, match="at least 6"):
        tpnp.solve_pnp_ransac(world, np.zeros((5, 2)), _tcam(),
                              CalibrateConfig())


def render_chessboard(h=300, w=400, square=28.0, origin=(60.5, 55.3),
                      angle_deg=7.0, n=8, supersample=4):
    """tests/test_chessboard.py:render_chessboard, the image alone."""
    ss = supersample
    yy, xx = (np.mgrid[:h * ss, :w * ss] + 0.5) / ss - 0.5
    t = np.deg2rad(angle_deg)
    u = (xx - origin[0]) * np.cos(t) + (yy - origin[1]) * np.sin(t)
    v = -(xx - origin[0]) * np.sin(t) + (yy - origin[1]) * np.cos(t)
    iu = np.floor(u / square).astype(int)
    iv = np.floor(v / square).astype(int)
    inside = (iu >= 0) & (iu < n) & (iv >= 0) & (iv < n)
    img = np.where(inside & (((iu + iv) % 2) == 0), 30.0, 220.0)
    return img.reshape(h, ss, w, ss).mean((1, 3)).astype(np.float32)


@pytest.mark.parametrize("pattern", [(7, 7), (6, 6)])
def test_find_chessboard_matches_jax(pattern):
    """A 7x7-inner-corner board: found, corners within 1e-3 px; asked for
    6x6, both packages answer the same way."""
    img = render_chessboard()
    rj = jfind(img, pattern)
    rt = find_chessboard(img, pattern, device="cpu")
    assert rt.found == rj.found
    if rj.found:
        np.testing.assert_allclose(rt.corners, rj.corners, rtol=0, atol=1e-3)


def render_board(K, rvec, tvec, square_mm, n, h, w, ss=3):
    """tests/test_undistort.py:_render_board_through_camera: an n x n
    checkerboard imaged through a pinhole camera pose."""
    yy, xx = (np.mgrid[:h * ss, :w * ss] + 0.5) / ss - 0.5
    R = np.asarray(jt.rodrigues(jnp.asarray(rvec)))
    H = K @ np.stack([R[:, 0], R[:, 1], tvec], axis=1)
    uvw = np.linalg.inv(H) @ np.stack([xx.ravel(), yy.ravel(),
                                       np.ones(xx.size)])
    u = (uvw[0] / uvw[2]).reshape(xx.shape)
    v = (uvw[1] / uvw[2]).reshape(xx.shape)
    iu = np.floor(u / square_mm).astype(int)
    iv = np.floor(v / square_mm).astype(int)
    inside = (iu >= 0) & (iu < n) & (iv >= 0) & (iv < n)
    img = np.where(inside & (((iu + iv) % 2) == 0), 30.0, 215.0)
    return img.reshape(h, ss, w, ss).mean((1, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def boards(tmp_path_factory):
    """Five 300x400 boards of 7x7 inner corners (6 mm squares) through a
    known K (tests/test_undistort.py:148-166), saved as .npy too."""
    K = np.array([[420.0, 0.0, 200.0], [0.0, 410.0, 150.0], [0.0, 0.0, 1.0]])
    d = tmp_path_factory.mktemp("boards")
    images = []
    for k in range(5):
        rvec = np.array([0.25 * np.sin(k * 1.3), 0.25 * np.cos(k * 0.9),
                         0.3 * np.sin(k * 2.1)])
        tvec = np.array([-22.0 + 2 * k, -18.0 + 1.5 * k, 95.0 + 6 * k])
        images.append(render_board(K, rvec, tvec, 6.0, 8, 300, 400))
        np.save(d / f"board_{k}.npy", images[-1])
    return dict(K=K, images=images, dir=d,
                cache=tmp_path_factory.mktemp("jax_cache"))


def test_calibrate_from_images_matches_jax(boards):
    """The C10 flow on rendered boards. The corners differ by up to 1.5e-4
    px (the float32 filters' last bits through the sub-pixel iteration), so
    the intrinsics agree within 2e-5 relative (observed 2.5e-6), the
    ill-conditioned distortion within 5e-3 (observed 1e-3 in k3) and the
    RMS within 1e-5 (observed 5e-7)."""
    kw = dict(pattern_size=(7, 7), square_mm=6.0, refine_iters=20)
    oj = jfrom_images(boards["images"], **kw)
    ot = calibrate_from_images(boards["images"], device="cpu", **kw)
    assert ot.used_images == oj.used_images and len(ot.used_images) >= 4
    K = boards["K"]
    truth = dict(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2])
    for name, want in truth.items():
        np.testing.assert_allclose(getattr(ot.artifact, name),
                                   getattr(oj.artifact, name), rtol=2e-5)
        assert abs(getattr(ot.artifact, name) - want) < 6.0
    np.testing.assert_allclose(ot.artifact.dist, oj.artifact.dist, atol=5e-3)
    np.testing.assert_allclose(ot.artifact.intrinsic_reproj_error,
                               oj.artifact.intrinsic_reproj_error, atol=1e-5)
    assert ot.artifact.intrinsic_reproj_error < 0.3


def _xlsx_values(path):
    return {r[0]: r[1] for r in xlsx.read_xlsx(path)[1:]
            if isinstance(r[0], str) and isinstance(r[1], (int, float))}


def _close_values(got, want, what):
    """XLSX values within the image flow's tolerances (see above): the
    distortion coefficients within 5e-3, the rest within 2e-5 relative."""
    assert got.keys() == want.keys(), what
    for k in want:
        if k in ("k1", "k2", "p1", "p2", "k3"):
            np.testing.assert_allclose(got[k], want[k], atol=5e-3,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-5,
                                       err_msg=f"{what} {k}")


def test_calibrate_commands_match_jax_cli(boards, tmp_path):
    """calibrate-intrinsics on the boards' directory (a config with the
    7x7 pattern and 6 mm squares); calibrate-extrinsics with the markers'
    CSVs on an intrinsics file of the camera that imaged them: the XLSX
    values of both CLIs agree."""
    from vision_basedsensor_tpu_torch.calibrate import CalibrationArtifact
    from vision_basedsensor_tpu_torch.config import (PipelineConfig,
                                                     to_json)
    cfg = tmp_path / "cfg.json"
    to_json(PipelineConfig(calibrate=CalibrateConfig(
        pattern_size=(7, 7), square_size_mm=6.0, refine_iters=20)), str(cfg))
    files = {}
    for pkg, run in (("jax", lambda a: run_jax_cli(a, boards["cache"])),
                     ("port", run_port_cli)):
        out = tmp_path / f"{pkg}_intr.xlsx"
        text = run(["--config", str(cfg), "calibrate-intrinsics",
                    str(boards["dir"]), "--output", str(out)])
        assert "used 5/5 images" in text
        files[pkg] = out
    _close_values(_xlsx_values(files["port"]), _xlsx_values(files["jax"]),
                  "calibrate-intrinsics")

    rng = np.random.default_rng(11)
    world, img, out = _pnp_problem(False, rng)
    wcsv, pcsv = tmp_path / "world.csv", tmp_path / "pix.csv"
    with open(wcsv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["marker_id", "Xw", "Yw", "Zw"])
        w.writerows([[i + 1, *p] for i, p in enumerate(world)])
    with open(pcsv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["marker_id", "u", "v"])
        w.writerows([[i + 1, *p] for i, p in enumerate(img)])
    intr = tmp_path / "camera.xlsx"
    CalibrationArtifact(fx=K_TRUE[0, 0], fy=K_TRUE[1, 1], cx=K_TRUE[0, 2],
                        cy=K_TRUE[1, 2], dist=DIST).save_intrinsics_xlsx(
                            str(intr))
    texts, ext = {}, {}
    for pkg, run in (("jax", lambda a: run_jax_cli(a, boards["cache"])),
                     ("port", run_port_cli)):
        ext[pkg] = tmp_path / f"{pkg}_ext.xlsx"
        texts[pkg] = run(["calibrate-extrinsics", str(intr),
                          str(wcsv), str(pcsv), "--output", str(ext[pkg])])
    # Different RANSAC draws, the same inliers and refined pose.
    assert texts["port"].splitlines()[:2] == texts["jax"].splitlines()[:2]
    assert "PnP solved with 58 inliers" in texts["port"]
    want, got = _xlsx_values(ext["jax"]), _xlsx_values(ext["port"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_calibrate_intrinsics_from_corners_and_plots(boards, tmp_path):
    """The npz form of calibrate-intrinsics (objs, imgs) through both CLIs:
    the same corners, so the XLSX values agree as Zhang's do (1e-6); with
    --plots-dir the port writes the board poses (matplotlib), and the
    calibration figures draw."""
    from vision_basedsensor_tpu_torch.calibrate import plots

    objs, imgs = _views(8, 0.2, seed=3)
    npz = tmp_path / "corners.npz"
    np.savez(npz, objs=objs, imgs=imgs)
    out = {}
    for pkg, run in (("jax", lambda a: run_jax_cli(a, boards["cache"])),
                     ("port", run_port_cli)):
        out[pkg] = tmp_path / f"{pkg}.xlsx"
        extra = ["--plots-dir", str(tmp_path / "plots")] if pkg == "port" \
            else []
        text = run(["calibrate-intrinsics", str(npz), "--output",
                    str(out[pkg]), *extra])
        assert text.startswith("calibration RMS ")
    want, got = _xlsx_values(out["jax"]), _xlsx_values(out["port"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    assert (tmp_path / "plots" / "board_poses.png").stat().st_size > 0

    cam = _tcam()
    plots.plot_undistort_comparison(boards["images"][0], cam,
                                    str(tmp_path / "undistort.png"))
    world = layout.dome_layout()[:, 1:]
    plots.plot_extrinsic_result(world, np.eye(3), np.array([0, 0, 40.0]),
                                str(tmp_path / "extrinsic.png"))
    for name in ("undistort.png", "extrinsic.png"):
        assert (tmp_path / name).stat().st_size > 0


@pytest.mark.parametrize("call", ["calibrate_intrinsics", "find_chessboard",
                                  "calibrate_from_images",
                                  "measure_diameters", "cli"])
def test_calibration_defaults_to_the_card(call, monkeypatch, tmp_path):
    """Without a card and without device='cpu' (--device cpu) the new
    entry points raise; none falls back to the CPU."""
    from vision_basedsensor_tpu_torch.analysis.diameter import \
        measure_diameters
    from vision_basedsensor_tpu_torch.cli import main as tcli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    objs, imgs = _views(3, 0.0, seed=0)
    img = render_chessboard()
    np.save(tmp_path / "board.npy", img)
    calls = {
        "calibrate_intrinsics": lambda: calibrate_intrinsics(objs, imgs),
        "find_chessboard": lambda: find_chessboard(img, (7, 7)),
        "calibrate_from_images": lambda: calibrate_from_images([img] * 3),
        "measure_diameters": lambda: measure_diameters(img, 5.0),
        "cli": lambda: tcli.main(["diameter", str(tmp_path / "board.npy")]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[call]()
