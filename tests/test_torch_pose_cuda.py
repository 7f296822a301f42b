"""The pose-compensation commands on the card (``cli/main.py``: ``tilt``,
``analyze``, ``indent``) at 640x480, each with its kernel launches counted
alone.

Every test is ``cuda_only`` and skips without a GPU. The file imports no
JAX (``tests/torch_parity.py``).
"""
import numpy as np
import pytest
import torch

from torch_parity import cuda, run_card_cli  # noqa: F401

from vision_basedsensor_tpu_torch.config import (PipelineConfig,
                                                 ReconstructConfig, to_json)
from vision_basedsensor_tpu_torch.synth import (default_scene,
                                                indentation_staircase,
                                                render_frames,
                                                tilt_deviation_field)

pytestmark = pytest.mark.cuda_only

# The tilted compression's angle (deg) and depth (mm) of the reference's
# end-to-end tilt test (tests/test_cli.py:188-216) and the bound it is held
# to (README.md:217-219).
TILT = (15.0, 1.0, 0.5)
# The staircase's steps and depth (mm, README.md:103-121).
STAIRS = (12, 0.7)
FUSED = {"fields", "gather", "filters", "scan"}


def _save(dev, path, disp):
    scene = default_scene(480, 640, device=dev)
    np.save(path, render_frames(scene, disp).to(torch.uint8).cpu().numpy())
    return str(path)


def _number(text, key):
    line = next(ln for ln in text.splitlines() if key in ln)
    return float(line.split(key)[1].split()[0])


def test_tilt_and_analyze_on_the_card(cuda, tmp_path):
    """``tilt`` on a vertical and a tilted compression (two frames each)
    reads the tilt within the bound with 65 common markers; ``analyze`` on
    the TXTs it wrote prints the same tilt line and launches no kernel."""
    angle, depth, bound = TILT
    zero = torch.zeros((65, 3), device=cuda)
    press = zero.clone()
    press[:, 2] = -depth
    vert = _save(cuda, tmp_path / "vertical.npy", torch.stack([zero, press]))
    tilted = _save(cuda, tmp_path / "tilted.npy", torch.stack([
        zero, tilt_deviation_field(angle, compression_mm=depth,
                                   device=cuda)]))
    cfg = tmp_path / "cfg.json"
    to_json(PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0)),
            str(cfg))
    exp = tmp_path / "exp"
    text, _, launches = run_card_cli([
        "--config", str(cfg), "tilt", vert, tilted, "--no-warmup",
        "--start-range", "0", "0", "--end-range", "1", "1", "--output-dir",
        str(exp)])
    assert set(launches) == FUSED
    assert abs(_number(text, "Tilt Angle = ") - angle) < bound
    assert int(_number(text, "common markers: ")) == 65

    text2, _, launches = run_card_cli(["analyze", str(exp / "vertical.txt"),
                                       str(exp / "tilted.txt")])
    assert launches == {}

    def tilt_line(t):
        return next(ln for ln in t.splitlines() if "Tilt Angle" in ln)

    assert tilt_line(text2) == tilt_line(text)


def test_indent_on_the_card(cuda, tmp_path):
    """``indent`` on a staircase with sequential association: a row of 65
    markers for every step, and the association kernel beside the fused
    branch's."""
    steps, step_mm = STAIRS
    stairs = _save(cuda, tmp_path / "stairs.npy",
                   indentation_staircase(steps, step_mm, device=cuda))
    text, err, launches = run_card_cli([
        "indent", stairs, "--steps", str(steps), "--step-mm", str(step_mm),
        "--association", "sequential"])
    assert set(launches) == FUSED | {"associate"}
    rows = [ln.split(",") for ln in text.splitlines()[1:]]
    assert [int(r[5]) for r in rows] == [65] * steps
    assert np.isfinite(_number(err, "worst single-step error: "))
