"""The port's synthetic-data extras (``synth/render.py``'s indentation
fields, ``synth/degrade.py``) and the ``synth`` command against the JAX
package's, on the CPU.

Tolerances: the displacement fields within 1e-6 mm (the same numpy
arithmetic; observed 0); the deterministic degradations within 1e-4 gray
levels (float32 in another operation order; observed <= 3e-5); the
``synth`` frames within one gray level (the renderers round float32 sums
to integers; observed: equal). ``sensor_noise`` draws from a
``torch.Generator``, not ``jax.random``: its statistics are tested, and
sigma = 0 is the clip alone.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import run_jax_cli, run_port_cli

from vision_basedsensor_tpu import synth as js

from vision_basedsensor_tpu_torch import synth as ts


@pytest.mark.parametrize("kind,args", [
    ("probe", (1.0,)),
    ("probe", (2.5, (3.0, -1.0), 4.0)),
    ("probe", (6.0, (0.0, 0.0), 5.0)),       # deeper than the probe radius
    ("membrane", (1.5, (2.0, -1.0), 5.0, 0.3)),
    ("membrane", (0.5,)),
    ("membrane", (6.0, (-4.0, 2.0), 5.0, 0.5)),
])
def test_indentation_fields_match_jax(kind, args):
    jfn = getattr(js, f"{kind}_indentation_field")
    tfn = getattr(ts, f"{kind}_indentation_field")
    want = np.asarray(jfn(*args))
    got = tfn(*args, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (65, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_indentation_fields_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (ts.probe_indentation_field, ts.membrane_indentation_field):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(1.0)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    f = rng.uniform(0, 255, (2, 40, 56)).astype(np.float32)
    f[:, 10:20, 12:30] = 40.0          # a dark block with sharp edges
    return f


@pytest.mark.parametrize("name,kwargs", [
    ("illumination_gradient", dict(strength=0.4)),
    ("illumination_gradient", dict(strength=0.7, axis="y")),
    ("vignette", dict(strength=0.4)),
    ("defocus", dict(sigma_px=1.3)),
    ("defocus", dict(sigma_px=0.0)),
    ("motion_blur", dict(length_px=5.5, angle_deg=30.0)),
    ("motion_blur", dict(length_px=3.0)),
    ("motion_blur", dict(length_px=0.0)),
])
def test_degradations_match_jax(frames, name, kwargs):
    want = np.asarray(getattr(js, name)(jnp.asarray(frames), **kwargs))
    got = getattr(ts, name)(torch.from_numpy(frames), **kwargs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_sensor_noise_statistics():
    flat = torch.full((4, 64, 96), 128.0)
    noisy = ts.sensor_noise(flat, 5.0, seed=3)
    d = (noisy - flat).double()
    assert abs(float(d.mean())) < 0.05
    assert abs(float(d.std()) - 5.0) < 0.1
    assert torch.equal(noisy, ts.sensor_noise(flat, 5.0, seed=3))
    assert not torch.equal(noisy, ts.sensor_noise(flat, 5.0, seed=4))
    # sigma = 0 is the clip alone.
    wide = torch.linspace(-20.0, 280.0, 4 * 64 * 96).reshape(4, 64, 96)
    assert torch.equal(ts.sensor_noise(wide, 0.0), wide.clamp(0.0, 255.0))
    # The JAX package's noise has the same distribution.
    jd = np.asarray(js.sensor_noise(jnp.asarray(flat.numpy()), 5.0, 3)) - 128.0
    assert abs(float(jd.std()) - float(d.std())) < 0.15


@pytest.mark.parametrize("args", [
    ["--motion", "staircase", "--height", "96", "--width", "128"],
    ["--motion", "staircase", "--frames-per-step", "2", "--height", "80",
     "--width", "112"],
    ["--motion", "wave", "--frames", "5", "--height", "96", "--width",
     "128"],
])
def test_synth_command_matches_jax_cli(args, tmp_path):
    paths = {pkg: tmp_path / f"{pkg}.npy" for pkg in ("jax", "port")}
    run_jax_cli(["synth", "--output", str(paths["jax"]), *args],
                tmp_path / "cache")
    text = run_port_cli(["synth", "--output", str(paths["port"]), *args])
    want, got = np.load(paths["jax"]), np.load(paths["port"])
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert text.strip() == f"wrote {paths['port']} {got.shape}"
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
