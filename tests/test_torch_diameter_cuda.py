"""Marker-diameter validation on the card through the command line
(``diameter``) on a rendered 1080x1920 photo of the calibration board
beside 65 dark 2.0 mm disks, held to ``measure_diameters`` and to the
rendered truth.

Every test is ``cuda_only`` and skips without a GPU. The file imports no
JAX (``tests/torch_parity.py``).
"""
import numpy as np
import pytest
import torch

from torch_parity import cuda, run_card_cli  # noqa: F401

pytestmark = pytest.mark.cuda_only

# DiameterValidation.py's scene: a 7 x 7-square board (6x6 inner corners)
# of 3 mm squares beside 65 disks of 2.0 mm in a 13 x 5 grid, at 15 px/mm.
PX_PER_MM, SQUARE_MM, DISK_MM = 15.0, 3.0, 2.0


def render_diameter_photo(device, h=1080, w=1920, ss=4, seed=0):
    """The diameter photo, supersampled ``ss`` x ``ss``: uint8 numpy and the
    disks' centres (x, y) in pixels."""
    s = PX_PER_MM
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=device)
    ys = (torch.arange(h * ss, **f64) + 0.5) / ss - 0.5
    xs = (torch.arange(w * ss, **f64) + 0.5) / ss - 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    sq = SQUARE_MM * s
    iu = torch.floor((xx - 120.0) / sq).long()
    iv = torch.floor((yy - 380.0) / sq).long()
    inside = (iu >= 0) & (iu < 7) & (iv >= 0) & (iv < 7)
    img = torch.where(inside & ((iu + iv) % 2 == 0), 30.0, 215.0)
    centres = np.stack([620.0 + (np.arange(65) % 13) * 95.0,
                        180.0 + (np.arange(65) // 13) * 150.0], -1)
    centres += rng.uniform(-0.5, 0.5, centres.shape)
    r = DISK_MM / 2 * s
    for cx, cy in centres:
        x0, x1 = int((cx - r - 2) * ss), int((cx + r + 2) * ss)
        y0, y1 = int((cy - r - 2) * ss), int((cy + r + 2) * ss)
        d = torch.hypot(xx[y0:y1, x0:x1] - cx, yy[y0:y1, x0:x1] - cy)
        img[y0:y1, x0:x1] = torch.where(d <= r, 40.0, img[y0:y1, x0:x1])
    img = img.reshape(h, ss, w, ss).mean((1, 3))
    return torch.round(img).to(torch.uint8).cpu().numpy(), centres


def test_diameter_command_on_the_card(cuda, tmp_path):
    """The board's scale within 1%; the printed rows equal to
    ``measure_diameters``; at least 10 valid markers (and 60 with a
    1024-candidate budget: the default 96 are spent on tied plateau cells
    before the distance suppression), each a rendered disk (centre within 1
    px) with a diameter within the method's bound (1.95 mm to 2.0 mm + 2
    px: the enclosing circle of the mask's pixel centres + 0.5 px a side
    reads a disk of D px as D to D + 2 px); no kernel launched."""
    from vision_basedsensor_tpu_torch.analysis.diameter import \
        measure_diameters

    img, centres = render_diameter_photo(cuda)
    photo = tmp_path / "diameter_photo.npy"
    np.save(photo, img)
    text, _, launches = run_card_cli(["diameter", str(photo)])
    assert launches == {}
    scale = float(text.split("Scale: ")[1].split()[0])
    assert abs(scale - PX_PER_MM) <= 0.01 * PX_PER_MM
    res = measure_diameters(img, scale, device=cuda)
    valid = res.valid.cpu().numpy()
    d = res.diameters_mm.cpu().numpy()[valid]
    c = res.centers.cpu().numpy()[valid]
    rows = ["x,y,diameter_mm,circularity"] + [
        f"{x:.1f},{y:.1f},{dd:.3f},{cc:.3f}" for (x, y), dd, cc in zip(
            c, d, res.circularity.cpu().numpy()[valid])]
    assert text.strip().splitlines()[1:] == rows
    assert valid.sum() >= 10
    assert np.linalg.norm(c[:, None] - centres[None], axis=-1).min(1).max() \
        <= 1.0
    hi = DISK_MM + 2.0 / PX_PER_MM
    wide = measure_diameters(img, scale, max_markers=1024, device=cuda)
    d_wide = wide.diameters_mm[wide.valid].cpu().numpy()
    assert int(wide.valid.sum()) >= 60
    for dd in (d, d_wide):
        assert dd.min() >= 1.95 and dd.max() <= hi
