"""Shared harness of the PyTorch-port parity tests (tests/test_torch_*.py).

Not collected (no ``test_`` prefix), like ``tests/oracle.py``. The same
numpy inputs go through a JAX function and its counterpart in
``vision_basedsensor_tpu_torch``; arrays cross as float32 numpy, because
``tests/conftest.py`` turns on JAX x64.
"""
from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp

# The suite runs under xdist (-n 6); one intra-op thread per worker.
torch.set_num_threads(1)


def f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def to_jax(x) -> jnp.ndarray:
    return jnp.asarray(f32(x))


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(f32(x)))


def np_(x) -> np.ndarray:
    """A JAX array or a torch tensor as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def staircase(batch: int, step_mm: float = 0.3) -> np.ndarray:
    """``(batch, 65, 3)`` rigid -Z indentation steps (frame 0 at rest)."""
    d = np.zeros((batch, 65, 3), np.float32)
    d[:, :, 2] = -step_mm * np.arange(batch, dtype=np.float32)[:, None]
    return d


def render_jax(height: int, width: int, displacements: np.ndarray):
    """Frames from the JAX synth (``default_scene(height, width)``) as
    float32 numpy, plus the scene."""
    from vision_basedsensor_tpu.synth import default_scene, render_frames

    scene = default_scene(height, width)
    frames = render_frames(scene, to_jax(displacements))
    return f32(frames), scene


def peaks_pair(rng: np.random.Generator, batch: int, k: int, h: int, w: int,
               border: bool = True):
    """Random integer peak positions ``(batch, k, 2)`` with some pushed onto
    every border, plus a validity mask; returned for both frameworks as
    (jax Peaks, torch Peaks)."""
    from vision_basedsensor_tpu.ops.peaks import Peaks as JPeaks

    from vision_basedsensor_tpu_torch.ops.peaks import Peaks as TPeaks

    xs = rng.integers(0, w, (batch, k)).astype(np.float32)
    ys = rng.integers(0, h, (batch, k)).astype(np.float32)
    if border:
        xs[:, 0], ys[:, 1] = 0, 0
        xs[:, 2], ys[:, 3] = w - 1, h - 1
        xs[:, 4], ys[:, 4] = w - 1, h - 1
    xy = np.stack([xs, ys], -1)
    valid = rng.random((batch, k)) > 0.2
    score = rng.random((batch, k)).astype(np.float32)
    jp = JPeaks(xy=jnp.asarray(xy), score=jnp.asarray(score),
                valid=jnp.asarray(valid))
    tp = TPeaks(xy=torch.from_numpy(xy), score=torch.from_numpy(score),
                valid=torch.from_numpy(valid))
    return jp, tp
