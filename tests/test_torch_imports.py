"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
and a configuration crosses between the two packages as JSON."""
import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import vision_basedsensor_tpu_torch
from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu_torch import config as tcfg
from vision_basedsensor_tpu_torch import convert

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
import vision_basedsensor_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "vision_basedsensor_tpu"
             or m.startswith("vision_basedsensor_tpu."))
bad = [m for m in bad if sys.modules[m] is not None]
print(len(names), bad)
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    names = [m.name for m in pkgutil.walk_packages(
        vision_basedsensor_tpu_torch.__path__, "vision_basedsensor_tpu_torch.")]
    assert int(n) == len(names) >= 20
    # The session module reads calibration artifacts through the port's
    # calibrate package, never the JAX one; the CLI and its table, plot and
    # overlay modules stand alone too.
    for mod in ("io.session", "calibrate", "calibrate.artifact", "cli.main",
                "io.table", "io.xlsx", "io.schemas", "analysis.series",
                "analysis.plots", "detect.overlay"):
        assert f"vision_basedsensor_tpu_torch.{mod}" in names, mod
    # The ingest, native decoder loader included, stands alone too.
    for mod in ("native", "io.video", "io.mjpeg", "io.jpeg_encode", "ops.jpeg",
                "ops.expand", "ops.cuda.expand"):
        assert f"vision_basedsensor_tpu_torch.{mod}" in names, mod
    # So do the live path's publisher and logger.
    for mod in ("io.publish", "utils", "utils.log"):
        assert f"vision_basedsensor_tpu_torch.{mod}" in names, mod
    # So do the calibration, diameter and synth modules.
    for mod in ("core.transforms", "calibrate.homography", "calibrate.zhang",
                "calibrate.pnp", "calibrate.chessboard", "calibrate.images",
                "calibrate.plots", "analysis.diameter", "synth.degrade"):
        assert f"vision_basedsensor_tpu_torch.{mod}" in names, mod
    # So do the acquisition server, the multi-device path and the extras.
    for mod in ("capture", "capture.server", "parallel", "parallel.mesh",
                "parallel.ingest", "analysis.dynamics", "utils.profiling"):
        assert f"vision_basedsensor_tpu_torch.{mod}" in names, mod
    assert bad == "[]"


def test_config_json_round_trip_across_packages():
    cfg = jcfg.PipelineConfig(
        detect=dataclasses.replace(jcfg.DetectConfig(), max_candidates=95,
                                   high_res=dataclasses.replace(
                                       jcfg.HIGH_RES_PROFILE, patch_size=48)),
        crop_ratios=(0.1, 0.1, 0.0, 0.0))
    text = jcfg.to_json(cfg)
    port = tcfg.from_json(text)
    assert port.detect.max_candidates == 95
    assert port.detect.high_res.patch_size == 48
    assert port.detect.high_res.peak_window == 15
    assert tcfg.to_json(port) == text
    assert jcfg.from_json(tcfg.to_json(port)) == cfg
    assert convert.config_from_jax(cfg) == port
