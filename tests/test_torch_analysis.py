"""The port's replay analysis (``analysis/series.py:displacement_statistics``,
``analysis/force.py:start_end_displacement``) and tracking overlay
(``detect/overlay.py:draw_tracking``) against the JAX package's, on a seeded
reconstruction with occlusions and on seeded tracking outputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import np_

from vision_basedsensor_tpu.analysis import displacement_statistics as jstats
from vision_basedsensor_tpu.analysis import start_end_displacement as jse
from vision_basedsensor_tpu.detect import overlay as joverlay
from vision_basedsensor_tpu.reconstruct.displacement import \
    Reconstruction as JRecon
from vision_basedsensor_tpu.track.associate import TrackedFrames as JTracked

from vision_basedsensor_tpu_torch.analysis import displacement_statistics as tstats
from vision_basedsensor_tpu_torch.analysis import start_end_displacement as tse
from vision_basedsensor_tpu_torch.detect import overlay as toverlay
from vision_basedsensor_tpu_torch.reconstruct.displacement import \
    Reconstruction as TRecon

T = 40


def _recon(seed=0):
    """Float32 fields over T frames x 65 markers with ~30% occlusions;
    marker 3 is never seen and marker 4 has a single valid step, so the
    empty-mask and single-sample (NaN std) cases are covered."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 2).astype(np.float32)
    seen = rng.random((T, 65)) > 0.3
    seen[:, 2] = False
    step_valid = seen & (rng.random((T, 65)) > 0.2)
    step_valid[:, 3] = False
    step_valid[5, 3] = True
    return dict(world=f(T, 65, 3), seen=seen, step=f(T, 65, 3),
                step_norm=np.abs(f(T, 65)), step_valid=step_valid,
                cum_path=np.abs(f(T, 65)).cumsum(0), from_first=f(T, 65, 3),
                from_first_norm=np.abs(f(T, 65)))


def _both(fields):
    return (JRecon(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TRecon(**{k: torch.from_numpy(v) for k, v in fields.items()}))


@pytest.mark.parametrize("seed", [0, 1])
def test_displacement_statistics_matches_jax(seed):
    jr, tr = _both(_recon(seed))
    want, got = jstats(jr), tstats(tr)
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), np_(getattr(got, name))
        # float32 sums of <= 40 terms; observed agreement ~1e-7.
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   equal_nan=True, err_msg=name)
    assert np.isnan(np_(got.std)[3]) and np_(got.count)[3] == 1
    assert np_(got.count)[2] == 0 and np_(got.max)[2] == 0.0


@pytest.mark.parametrize("ranges", [((1, 30), (120, 150)), ((0, 9), (30, 39)),
                                    ((5, 5), (39, 39)), ((50, 60), (0, 3))])
def test_start_end_displacement_matches_jax(ranges):
    """The reference's default windows clipped by a short video, ordinary
    windows, one-frame windows and a window past the end (no marker ok)."""
    jr, tr = _both(_recon(2))
    (wd, wok), (gd, gok) = jse(jr, *ranges), tse(tr, *ranges)
    np.testing.assert_array_equal(np_(gok), np.asarray(wok))
    np.testing.assert_allclose(np_(gd), np.asarray(wd), rtol=1e-5, atol=1e-5)
    if ranges[0][0] >= T:
        assert not np_(gok).any()


@pytest.mark.parametrize("drawer", ["cv2", "numpy"])
def test_draw_tracking_pixel_equal(drawer, monkeypatch):
    """Seeded markers drawn on a seeded frame by both packages, with cv2
    and with the dependency-free rasterizer."""
    if drawer == "numpy":
        monkeypatch.setattr(joverlay, "_cv2", None)
        monkeypatch.setattr(toverlay, "_cv2", None)
    rng = np.random.default_rng(7)
    h, w = 120, 160
    tracked = JTracked(
        xy=(rng.random((3, 65, 2)) * [w, h]).astype(np.float32),
        ref_xy=(rng.random((65, 2)) * [w, h]).astype(np.float32),
        axes=(rng.random((3, 65, 2)) * 12 + 4).astype(np.float32),
        angle=(rng.random((3, 65)) * 180).astype(np.float32),
        ring=np.zeros(65, np.int32), valid=rng.random((3, 65)) > 0.4)
    for frame in (rng.integers(0, 256, (h, w), dtype=np.uint8),
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8)):
        for t in range(3):
            want = joverlay.draw_tracking(frame, tracked, t)
            got = toverlay.draw_tracking(frame, tracked, t)
            assert got.dtype == np.uint8 and got.shape == (h, w, 3)
            np.testing.assert_array_equal(got, want)
            assert (got != np.atleast_3d(frame)).any()
