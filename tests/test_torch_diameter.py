"""The port's marker-diameter validation (``analysis/diameter.py`` and the
``diameter`` command) against the JAX package's, on the CPU, on the images
of ``tests/test_chessboard.py:87-140``.

Tolerances, from the observed agreement: Otsu's threshold equal (the
histogram's arithmetic is the reference's; the image is integer-valued);
valid sets equal, centres within 1e-3 px, diameters within 1e-4 mm and
circularities within 1e-4 (observed ~1e-6: float32 blurs in another
summation order); the CLI's printed rows equal (3 decimals).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import run_jax_cli, run_port_cli
from test_torch_calibrate import render_chessboard

from vision_basedsensor_tpu.analysis import diameter as jd
from vision_basedsensor_tpu.calibrate.chessboard import \
    find_chessboard as jfind

from vision_basedsensor_tpu_torch.analysis import diameter as td
from vision_basedsensor_tpu_torch.calibrate.chessboard import find_chessboard


def _disk_image(h=240, w=320, centers=((60, 80), (120, 200), (180, 120)),
                r_px=14.0, bg=210, fg=35):
    """tests/test_chessboard.py:_disk_image."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.full((h, w), float(bg))
    for cy, cx in centers:
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        img = np.where(d <= r_px, float(fg), img)
    return img.astype(np.float32)


def _images():
    three = _disk_image()
    elongated = _disk_image(centers=((60, 80),))
    elongated[150:160, 60:220] = 35
    near_dark = _disk_image(r_px=14.0, centers=((120, 160),))
    near_dark[96:144, 186:250] = 35.0
    return {"three disks": three, "elongated blob": elongated,
            "dark rectangle": near_dark}


@pytest.mark.parametrize("name", list(_images()))
def test_otsu_threshold_matches_jax(name):
    img = _images()[name]
    want = float(jd.otsu_threshold(jnp.asarray(img)))
    got = float(td.otsu_threshold(torch.from_numpy(img)))
    assert got == want
    assert 40 < got < 205


@pytest.mark.parametrize("name", list(_images()))
@pytest.mark.parametrize("threshold", [None, 120.0])
def test_measure_diameters_matches_jax(name, threshold):
    img = _images()[name]
    rj = jd.measure_diameters(jnp.asarray(img), 5.0, threshold=threshold)
    rt = td.measure_diameters(img, 5.0, threshold=threshold, device="cpu")
    vj, vt = np.asarray(rj.valid), rt.valid.numpy()
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(rt.centers.numpy()[vt],
                               np.asarray(rj.centers)[vj], atol=1e-3)
    np.testing.assert_allclose(rt.diameters_mm.numpy()[vt],
                               np.asarray(rj.diameters_mm)[vj], atol=1e-4)
    np.testing.assert_allclose(rt.circularity.numpy()[vt],
                               np.asarray(rj.circularity)[vj], atol=1e-4)
    np.testing.assert_array_equal(rt.area_px.numpy()[vt],
                                  np.asarray(rj.area_px)[vj])
    want_valid = {"three disks": 3, "elongated blob": 1,
                  "dark rectangle": 1}[name]
    assert vt.sum() == want_valid
    # The reference's accuracy: 2 r / scale within 4%.
    np.testing.assert_allclose(rt.diameters_mm.numpy()[vt], 2 * 14.0 / 5.0,
                               rtol=0.1)


def test_chessboard_scale_matches_jax():
    img = render_chessboard(angle_deg=0.0, origin=(60.0, 55.0))
    bj = jfind(img, (7, 7))
    bt = find_chessboard(img, (7, 7), device="cpu")
    assert bj.found and bt.found
    sj = jd.chessboard_scale(bj.corners, (7, 7), 3.0)
    st = td.chessboard_scale(bt.corners, (7, 7), 3.0)
    np.testing.assert_allclose(st, sj, rtol=1e-6)
    np.testing.assert_allclose(st, 28.0 / 3.0, rtol=0.01)


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    """Three 14 px-radius dark disks beside a 6x6-inner-corner board (20 px
    squares, so 6.67 px/mm at 3 mm) on one 240x340 photo, as .npy."""
    board = render_chessboard(h=240, w=220, square=20.0, n=7, angle_deg=0.0,
                              origin=(30.0, 50.0))
    disks = _disk_image(h=240, w=120, centers=((50, 60), (120, 60),
                                               (190, 60)), bg=220)
    img = np.concatenate([disks, board], axis=1)
    d = tmp_path_factory.mktemp("diameter")
    np.save(d / "photo.npy", img.astype(np.uint8))
    return dict(path=str(d / "photo.npy"),
                cache=tmp_path_factory.mktemp("jax_cache"))


@pytest.mark.parametrize("args", [["--scale", "5.0"],
                                  ["--pattern", "6", "6", "--square-mm", "3"],
                                  ["--scale", "5.0", "--threshold", "100",
                                   "--offset", "0.1"]])
def test_diameter_command_matches_jax_cli(photo, args):
    """Both CLIs print the same rows. With the board's scale the three
    disks are measured at 28.86 px / 6.67 px/mm; at a fixed threshold of
    100 the board's first row of squares passes the gates too, in both."""
    argv = ["diameter", photo["path"], *args]
    want = run_jax_cli(argv, photo["cache"])
    got = run_port_cli(argv)
    assert got == want
    rows = got.strip().splitlines()
    head = rows.index("x,y,diameter_mm,circularity")
    assert len(rows) - head - 1 >= 3
    if "--pattern" in args:
        assert rows[0] == "[INFO] Scale: 6.67 px/mm from chessboard"
        assert [r.split(",")[2] for r in rows[head + 1:]] == ["4.329"] * 3


def test_diameter_without_board_or_scale_fails(tmp_path):
    path = tmp_path / "disks.npy"
    np.save(path, _disk_image().astype(np.uint8))
    assert "Chessboard not found" in run_port_cli(["diameter", str(path)])


def test_diameter_plot(photo, tmp_path):
    path = tmp_path / "diameters.png"
    text = run_port_cli(["diameter", photo["path"], "--plot", str(path)])
    assert text.strip().endswith(f"wrote {path}")
    assert path.stat().st_size > 0
