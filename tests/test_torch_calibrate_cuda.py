"""Camera calibration on the card through the command line
(``calibrate-intrinsics`` on rendered chessboards, ``calibrate-extrinsics``
on the 65 markers with outliers), each held to the library calls it stands
for and to the rendered truth.

Every test is ``cuda_only`` and skips without a GPU. The file imports no
JAX (``tests/torch_parity.py``).
"""
import contextlib
import math
import time

import numpy as np
import pytest
import torch

from torch_parity import cuda, run_card_cli  # noqa: F401

pytestmark = pytest.mark.cuda_only

# 20 chessboards of 6x6 inner corners and 3 mm squares
# (intrinsic_calibration.py:190-191) imaged at 640x480 through CAL_K.
VIEWS, SQUARE_MM = 20, 3.0
CAL_K = ((600.0, 0.0, 322.0), (0.0, 590.0, 238.0), (0.0, 0.0, 1.0))
# The extrinsic solve's pose (rvec, T in mm).
PNP_POSE = ((0.12, -0.2, 0.05), (1.5, -2.0, 42.0))


@contextlib.contextmanager
def fixed_zip_clock():
    """Every zip member written inside is stamped 2024-01-02 03:04:05 (an
    XLSX file is a zip whose members carry their write time)."""
    import types
    import zipfile

    stamp = time.mktime((2024, 1, 2, 3, 4, 5, 0, 0, -1))
    saved = zipfile.time
    zipfile.time = types.SimpleNamespace(time=lambda: stamp,
                                         localtime=time.localtime)
    try:
        yield
    finally:
        zipfile.time = saved


def render_board(K, rvec, tvec, square_mm, n, h, w, device, ss=3):
    """A checkerboard of n x n squares (its inner corners (n-1) x (n-1))
    imaged through the pinhole camera K at pose (rvec, tvec), supersampled
    ss x ss: tests/test_undistort.py:129-144 in torch, as uint8 numpy."""
    from vision_basedsensor_tpu_torch.core.transforms import rodrigues

    f64 = dict(dtype=torch.float64, device=device)
    R = rodrigues(torch.tensor(rvec, **f64))
    H = torch.tensor(K, **f64) @ torch.stack(
        [R[:, 0], R[:, 1], torch.tensor(tvec, **f64)], dim=1)
    ys = (torch.arange(h * ss, **f64) + 0.5) / ss - 0.5
    xs = (torch.arange(w * ss, **f64) + 0.5) / ss - 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    uvw = torch.linalg.inv(H) @ torch.stack([xx.ravel(), yy.ravel(),
                                             torch.ones_like(xx.ravel())])
    iu = torch.floor(uvw[0] / uvw[2] / square_mm).long().reshape(xx.shape)
    iv = torch.floor(uvw[1] / uvw[2] / square_mm).long().reshape(xx.shape)
    inside = (iu >= 0) & (iu < n) & (iv >= 0) & (iv < n)
    img = torch.where(inside & ((iu + iv) % 2 == 0), 30.0, 215.0)
    img = img.reshape(h, ss, w, ss).mean((1, 3))
    return torch.round(img).to(torch.uint8).cpu().numpy()


@pytest.fixture(scope="module")
def intrinsics(cuda, tmp_path_factory):
    """``calibrate-intrinsics`` on VIEWS rendered boards and
    ``calibrate_from_images`` + ``save_intrinsics_xlsx`` on the same
    images, under one zip clock: ``(cli XLSX, library XLSX, stdout,
    launches)``."""
    from vision_basedsensor_tpu_torch.calibrate.images import \
        calibrate_from_images

    d = tmp_path_factory.mktemp("calibrate")
    boards = d / "boards"
    boards.mkdir()
    images = []
    for k in range(VIEWS):
        rvec = (0.3 * math.sin(k * 1.3), 0.3 * math.cos(k * 0.9),
                0.4 * math.sin(k * 2.1))
        tvec = (-10.5 + 4 * math.sin(k * 0.7), -10.5 + 3 * math.cos(k * 1.1),
                55.0 + 8 * math.sin(k * 0.5))
        images.append(render_board(CAL_K, rvec, tvec, SQUARE_MM, 7, 480, 640,
                                   cuda))
        np.save(boards / f"board_{k:02d}.npy", images[-1])
    cli, lib = d / "IntrinsicParameters.xlsx", d / "direct.xlsx"
    with fixed_zip_clock():
        text, _, launches = run_card_cli(["calibrate-intrinsics", str(boards),
                                          "--output", str(cli)])
        calibrate_from_images(images, device=cuda).artifact \
            .save_intrinsics_xlsx(str(lib))
    return cli, lib, text, launches


def test_calibrate_intrinsics_command_on_the_card(intrinsics):
    """Every board used, the intrinsics within 6 px of the rendering camera,
    an RMS under 0.3 px, no kernel launched, and the XLSX byte-equal to the
    library calls'."""
    from vision_basedsensor_tpu_torch.calibrate import CalibrationArtifact

    cli, lib, text, launches = intrinsics
    assert launches == {}
    assert cli.read_bytes() == lib.read_bytes()
    assert f"used {VIEWS}/{VIEWS}" in text
    art = CalibrationArtifact.load_intrinsics_xlsx(str(cli))
    K = np.array(CAL_K)
    assert max(abs(art.fx - K[0, 0]), abs(art.fy - K[1, 1]),
               abs(art.cx - K[0, 2]), abs(art.cy - K[1, 2])) < 6.0
    assert art.intrinsic_reproj_error < 0.3


def test_calibrate_extrinsics_command_on_the_card(cuda, intrinsics,
                                                  tmp_path):
    """The 65 markers projected through those intrinsics at PNP_POSE with
    0.3 px of noise and 7 markers moved by 20-40 px: the XLSX pose equals
    ``solve_pnp_ransac``'s, the 7 are rejected, the rotation is within 0.1
    deg and T within 0.1 mm, and no kernel launched."""
    from vision_basedsensor_tpu_torch import layout
    from vision_basedsensor_tpu_torch.calibrate import (CalibrationArtifact,
                                                        solve_pnp_ransac)
    from vision_basedsensor_tpu_torch.calibrate.zhang import project_posed
    from vision_basedsensor_tpu_torch.config import PipelineConfig
    from vision_basedsensor_tpu_torch.core.transforms import rodrigues

    intr = intrinsics[0]
    art = CalibrationArtifact.load_intrinsics_xlsx(str(intr))
    cam64 = art.to_camera(torch.float64, device=cuda)
    world = layout.dome_layout()[:, 1:].astype(np.float64)
    f64 = dict(dtype=torch.float64, device=cuda)
    R_true = rodrigues(torch.tensor(PNP_POSE[0], **f64))
    T_true = torch.tensor(PNP_POSE[1], **f64)
    pix = project_posed(cam64, R_true, T_true,
                        torch.as_tensor(world, device=cuda)).cpu().numpy()
    rng = np.random.default_rng(10)
    pix += rng.normal(0.0, 0.3, pix.shape)
    outl = np.sort(rng.choice(65, 7, replace=False))
    pix[outl] += rng.uniform(20, 40, (7, 2)) * rng.choice([-1.0, 1.0], (7, 2))
    wcsv, pcsv = tmp_path / "world_points.csv", tmp_path / "pixel_points.csv"
    wcsv.write_text("marker_id,Xw,Yw,Zw\n" + "".join(
        f"{i + 1}," + ",".join(repr(float(v)) for v in world[i]) + "\n"
        for i in range(65)))
    pcsv.write_text("marker_id,u,v\n" + "".join(
        f"{i + 1}," + ",".join(repr(float(v)) for v in pix[i]) + "\n"
        for i in range(65)))
    ext = tmp_path / "ExtrinsicParameters.xlsx"
    _, _, launches = run_card_cli(["calibrate-extrinsics", str(intr),
                                   str(wcsv), str(pcsv), "--output",
                                   str(ext)])
    assert launches == {}
    pnp = solve_pnp_ransac(world, pix, cam64, PipelineConfig().calibrate)
    got = art.load_extrinsics_xlsx(str(ext))
    assert np.array_equal(got.R_wc, pnp.R_wc.cpu().numpy())
    assert np.array_equal(got.T_wc, pnp.T_wc.cpu().numpy())
    assert np.where(~pnp.inliers.cpu().numpy())[0].tolist() == outl.tolist()
    cos = (float(torch.trace(R_true.T @ pnp.R_wc)) - 1.0) / 2.0
    assert math.degrees(math.acos(max(-1.0, min(1.0, cos)))) < 0.1
    assert float(torch.linalg.vector_norm(pnp.T_wc - T_true)) < 0.1
