"""The synthetic data on the card through the command line (``synth``):
each motion's frames equal to ``render_frames`` of the same displacements.

Every test is ``cuda_only`` and skips without a GPU. The file imports no
JAX (``tests/torch_parity.py``).
"""
import numpy as np
import pytest
import torch

from torch_parity import cuda, run_card_cli  # noqa: F401

pytestmark = pytest.mark.cuda_only


@pytest.mark.parametrize("motion", ["staircase", "wave"])
def test_synth_matches_render_frames_on_the_card(cuda, tmp_path, motion):
    """``synth --motion staircase`` and ``--motion wave --frames 60`` at
    640x480 write ``render_frames`` of the same displacements, byte for
    byte, and launch no kernel."""
    from vision_basedsensor_tpu_torch.synth import (default_scene,
                                                    indentation_staircase,
                                                    render_frames)

    if motion == "staircase":
        disp, extra = indentation_staircase(device=cuda), []
    else:
        t = np.arange(60, dtype=np.float32)
        wave = np.zeros((60, 65, 3), np.float32)
        wave[:, :, 2] = -(1 - np.cos(t / 10.0))[:, None]
        disp, extra = torch.from_numpy(wave).to(cuda), ["--frames", "60"]
    path = tmp_path / f"synth_{motion}.npy"
    _, _, launches = run_card_cli(["synth", "--output", str(path), "--motion",
                                   motion, "--height", "480", "--width",
                                   "640", *extra])
    assert launches == {}
    want = render_frames(default_scene(480, 640, device=cuda), disp)
    got = np.load(path)
    assert got.shape == tuple(want.shape)
    assert np.array_equal(got, want.to(torch.uint8).cpu().numpy())
