"""The port's table, XLSX, calibration-artifact and session writers against
the JAX package's, byte for byte, on seeded numpy inputs; and each package's
readers on the other's files.

An XLSX file is a zip whose members carry the time they were written, so the
XLSX cases write both files under one fixed clock (``fixed_zip_clock``).
"""
import time
import types
import zipfile

import numpy as np
import pytest
import torch

from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu.calibrate import CalibrationArtifact as JArtifact
from vision_basedsensor_tpu.io import session as jsession
from vision_basedsensor_tpu.io import table as jtable
from vision_basedsensor_tpu.io import xlsx as jxlsx
from vision_basedsensor_tpu.reconstruct.displacement import \
    Reconstruction as JRecon
from vision_basedsensor_tpu.track.associate import TrackedFrames as JTracked
from vision_basedsensor_tpu.track.rings import ReferenceMarkers as JRef

from vision_basedsensor_tpu_torch import convert, native
from vision_basedsensor_tpu_torch.calibrate import \
    CalibrationArtifact as TArtifact
from vision_basedsensor_tpu_torch.io import session as tsession
from vision_basedsensor_tpu_torch.io import table as ttable
from vision_basedsensor_tpu_torch.io import xlsx as txlsx

T = 7


@pytest.fixture
def fixed_zip_clock(monkeypatch):
    """Every zip member written in the test is stamped 2024-01-02 03:04:05."""
    stamp = time.mktime((2024, 1, 2, 3, 4, 5, 0, 0, -1))
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: stamp, localtime=time.localtime))


def _tracked(seed=0, t=T):
    """Seeded tracking outputs (float32, with occlusions) as JAX
    ``TrackedFrames`` of numpy arrays; the writers of both packages read
    them with ``np.asarray``."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.random(s) * 400).astype(np.float32)
    return JTracked(xy=f(t, 65, 2), ref_xy=f(65, 2), axes=f(t, 65, 2),
                    angle=(rng.random((t, 65)) * 180).astype(np.float32),
                    ring=np.repeat(np.arange(6), (1, 6, 12, 18, 24, 4))
                    .astype(np.int32),
                    valid=rng.random((t, 65)) > 0.15)


def _with_values(tr, values, dtype=np.float32):
    """``tr`` with its float fields drawn from ``values`` (seeded), so that
    every column of the table meets them."""
    rng = np.random.default_rng(6)
    pick = lambda shape: rng.choice(np.asarray(values, dtype), shape)
    return tr._replace(xy=pick(tr.xy.shape), ref_xy=pick(tr.ref_xy.shape),
                       axes=pick(tr.axes.shape), angle=pick(tr.angle.shape))


TRACKING_CASES = {
    "seeded": lambda: _tracked(),
    "seeded_2048x65": lambda: _tracked(8, 2048),
    # Exact ties at the fourth decimal round half to even.
    "ties_k_over_32": lambda: _with_values(
        _tracked(9), [k / 32 for k in range(-64, 65)]),
    "negative_zero": lambda: _with_values(
        _tracked(10), [-0.0, -1e-5, -4.9999e-5, -5e-5, -5.0001e-5, 1e-5,
                       -0.00015, -0.00025, -3e-9]),
    "denormals": lambda: _with_values(
        _tracked(11), [1e-45, -1e-45, 1e-40, -3e-39, 1.1754942e-38, 0.0, 2.5]),
    "nonfinite": lambda: _with_values(
        _tracked(12), [np.nan, -np.nan, np.inf, -np.inf, 1.5, -2.25]),
    "float32_above_1e7": lambda: _with_values(
        _tracked(13), [1.0000001e7, -3.3554432e7, 16777217.0, 2.5e9,
                       9.007199e15, 1e20, -1e30, 3.4028235e38]),
    "float64": lambda: _with_values(
        _tracked(14), [1e300, -1e300, 1.7976931348623157e308, 2.0 ** 53,
                       2.0 ** 53 - 1, -(2.0 ** 53 + 2), 0.1, 2.675, 1.00005,
                       -123456.78905, 5e-324, 2.2250738585072014e-308],
        np.float64),
    "all_invalid": lambda: _tracked(15)._replace(
        valid=np.zeros((T, 65), bool)),
    # Rings in reverse order give negative columns; ring -1 a negative row.
    "negative_int_column": lambda: _tracked(16)._replace(
        ring=np.r_[np.repeat(np.arange(6), (1, 6, 12, 18, 24, 3))[::-1], -1]
        .astype(np.int32)),
}


def _recon(seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 10).astype(np.float32)
    seen = rng.random((T, 65)) > 0.2
    return JRecon(world=f(T, 65, 3), seen=seen, step=f(T, 65, 3),
                  step_norm=np.abs(f(T, 65)), step_valid=seen,
                  cum_path=np.abs(f(T, 65)), from_first=f(T, 65, 3),
                  from_first_norm=np.abs(f(T, 65)))


def _artifact(cls, extrinsics: bool):
    rng = np.random.default_rng(2)
    kw = dict(fx=612.25, fy=610.125, cx=319.5, cy=241.75, skew=0.001,
              dist=rng.standard_normal(5) * 0.1, intrinsic_reproj_error=0.31)
    if extrinsics:
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        kw.update(R_wc=q, T_wc=rng.standard_normal(3) * 40,
                  extrinsic_reproj_error=0.52)
    return cls(**kw)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_tracking_csv_bytes_and_readers(tmp_path):
    tr = _tracked()
    jp, tp = tmp_path / "j.csv", tmp_path / "t.csv"
    jtable.write_tracking_csv(str(jp), tr)
    ttable.write_tracking_csv(str(tp), tr)
    assert _bytes(jp) == _bytes(tp)
    assert len(_bytes(tp).splitlines()) == 1 + int(tr.valid.sum())
    got = ttable.read_tracking_csv(str(jp))
    _assert_same(got, jtable.read_tracking_csv(str(tp)))
    np.testing.assert_array_equal(got["valid"], tr.valid)


@pytest.mark.parametrize("case", list(TRACKING_CASES))
def test_tracking_csv_bytes_match_jax(tmp_path, case):
    """The port's native formatter writes the JAX package's row-by-row
    bytes: seeded tables, half-even ties, negative zeros, denormals, nan
    and infinities, huge float32 and float64 values, no valid marker, and
    negative integer columns."""
    tr = TRACKING_CASES[case]()
    jp, tp = tmp_path / "j.csv", tmp_path / "t.csv"
    jtable.write_tracking_csv(str(jp), tr)
    ttable.write_tracking_csv(str(tp), tr)
    assert _bytes(jp) == _bytes(tp)
    assert len(_bytes(tp).splitlines()) == 1 + int(tr.valid.sum())


@pytest.mark.parametrize("case", ["seeded", "nonfinite", "float64",
                                  "all_invalid"])
def test_table_format_counts(tmp_path, case):
    """``rows`` counts the rows written; ``wide_values`` the values that
    are not finite or lie at or above 2**53 in magnitude."""
    tr = TRACKING_CASES[case]()
    t, m = np.nonzero(tr.valid)
    vals = np.concatenate([tr.ref_xy[m], tr.xy[t, m], tr.axes[t, m],
                           tr.angle[t, m, None]], axis=1).astype(np.float64)
    before = native.table_format_counts()
    ttable.write_tracking_csv(str(tmp_path / "t.csv"), tr)
    after = native.table_format_counts()
    assert after["rows"] - before["rows"] == len(t)
    assert (after["wide_values"] - before["wide_values"]
            == int(np.count_nonzero(~(np.abs(vals) < 2.0 ** 53))))


def test_tracking_csv_takes_cpu_tensors(tmp_path):
    """The port's outputs on the CPU are tensors: the writer reads them as
    numpy and prints the same digits."""
    tr = _tracked(3)
    jp, tp = tmp_path / "j.csv", tmp_path / "t.csv"
    jtable.write_tracking_csv(str(jp), tr)
    ttable.write_tracking_csv(str(tp), type(tr)(*map(torch.from_numpy, tr)))
    assert _bytes(jp) == _bytes(tp)


@pytest.mark.parametrize("ext", ["csv", "xlsx"])
def test_coords_table_bytes_and_readers(tmp_path, ext, fixed_zip_clock):
    rc = _recon()
    jp, tp = tmp_path / f"j.{ext}", tmp_path / f"t.{ext}"
    jtable.write_coords_table(str(jp), rc)
    ttable.write_coords_table(str(tp), rc)
    assert _bytes(jp) == _bytes(tp)
    got = ttable.read_coords_table(str(jp))
    _assert_same(got, jtable.read_coords_table(str(tp)))
    np.testing.assert_array_equal(got["seen"], rc.seen)


def test_xlsx_bytes_and_readers(tmp_path, fixed_zip_clock):
    rows = [["Parameter", "Value", "Description"],
            ["fx", 612.25, "Focal <length> & x"],
            ["n", 3, None],
            ["nan", float("nan"), ""],
            ["inf", float("-inf"), " padded "],
            [None, 1e-12, "ünïcode"]] + [[f"r{i}", i * 0.1, str(i)]
                                          for i in range(30)]
    jp, tp = tmp_path / "j.xlsx", tmp_path / "t.xlsx"
    jxlsx.write_xlsx(str(jp), rows)
    txlsx.write_xlsx(str(tp), rows)
    assert _bytes(jp) == _bytes(tp)
    got, want = txlsx.read_xlsx(str(jp)), jxlsx.read_xlsx(str(tp))
    assert repr(got) == repr(want)          # NaN cells compare by repr
    assert got[1] == ["fx", 612.25, "Focal <length> & x"]


def test_experiment_txt_bytes_and_readers(tmp_path):
    rng = np.random.default_rng(4)
    start, end = rng.standard_normal((65, 3)), rng.standard_normal((65, 3))
    valid = rng.random(65) > 0.3
    jp, tp = tmp_path / "j.txt", tmp_path / "t.txt"
    jtable.write_experiment_txt(str(jp), start, end, valid)
    ttable.write_experiment_txt(str(tp), start, end, valid)
    assert _bytes(jp) == _bytes(tp)
    got = ttable.read_experiment_txt(str(jp))
    _assert_same(got, jtable.read_experiment_txt(str(tp)))
    np.testing.assert_array_equal(got[1], valid)


@pytest.mark.parametrize("extrinsics", [False, True])
def test_artifact_json_bytes_and_load_across(tmp_path, extrinsics):
    jp, tp = tmp_path / "j.json", tmp_path / "t.json"
    _artifact(JArtifact, extrinsics).save_json(str(jp))
    _artifact(TArtifact, extrinsics).save_json(str(tp))
    assert _bytes(jp) == _bytes(tp)
    got, want = TArtifact.load_json(str(jp)), JArtifact.load_json(str(tp))
    assert type(got) is TArtifact
    for name in ("fx", "fy", "cx", "cy", "skew", "dist", "R_wc", "T_wc",
                 "intrinsic_reproj_error", "extrinsic_reproj_error"):
        _assert_same(getattr(got, name), getattr(want, name))


def test_artifact_xlsx_bytes_and_load_across(tmp_path, fixed_zip_clock):
    j, t = _artifact(JArtifact, True), _artifact(TArtifact, True)
    for kind in ("intrinsics", "extrinsics"):
        jp, tp = tmp_path / f"j_{kind}.xlsx", tmp_path / f"t_{kind}.xlsx"
        getattr(j, f"save_{kind}_xlsx")(str(jp))
        getattr(t, f"save_{kind}_xlsx")(str(tp))
        assert _bytes(jp) == _bytes(tp), kind
    got = TArtifact.load_intrinsics_xlsx(str(tmp_path / "j_intrinsics.xlsx"))
    got = got.load_extrinsics_xlsx(str(tmp_path / "j_extrinsics.xlsx"))
    want = JArtifact.load_intrinsics_xlsx(str(tmp_path / "t_intrinsics.xlsx"))
    want = want.load_extrinsics_xlsx(str(tmp_path / "t_extrinsics.xlsx"))
    for name in ("fx", "fy", "cx", "cy", "skew", "dist", "R_wc", "T_wc",
                 "intrinsic_reproj_error", "extrinsic_reproj_error"):
        _assert_same(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("extrinsics", [False, True])
def test_artifact_to_camera_matches_jax(extrinsics):
    jcam = _artifact(JArtifact, extrinsics).to_camera()
    tcam = _artifact(TArtifact, extrinsics).to_camera(device="cpu")
    for name in jcam._fields:
        got = getattr(tcam, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jcam, name)), name)


def test_artifact_to_camera_defaults_to_the_card():
    art = _artifact(TArtifact, False)
    if torch.cuda.is_available():
        assert art.to_camera().fx.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            art.to_camera()


def _ref(seed=5):
    rng = np.random.default_rng(seed)
    return JRef(xy=(rng.random((65, 2)) * 300).astype(np.float32),
                axes=(rng.random((65, 2)) * 20).astype(np.float32),
                angle=(rng.random(65) * 180).astype(np.float32),
                ring=np.repeat(np.arange(6), (1, 6, 12, 18, 24, 4))
                .astype(np.int32),
                valid=rng.random(65) > 0.1,
                axis_scale=np.float32(1.0625))


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_session_with_calibration_across_packages(tmp_path, saver):
    """A session that holds a calibration artifact, saved by one package
    and resumed by the other: the same files, the same artifact."""
    jref, cfg = _ref(), jcfg.PipelineConfig()
    d = {}
    for pkg in ("jax", "port"):
        d[pkg] = tmp_path / pkg
        if pkg == "jax":
            jsession.save_session(str(d[pkg]), jref, cfg,
                                  calibration=_artifact(JArtifact, True),
                                  frames_seen=12)
        else:
            tsession.save_session(str(d[pkg]),
                                  convert.reference_from_numpy(jref, "cpu"),
                                  convert.config_from_jax(cfg),
                                  calibration=_artifact(TArtifact, True),
                                  frames_seen=12)
    for name in ("calibration.json", "config.json"):
        assert _bytes(d["jax"] / name) == _bytes(d["port"] / name), name
    if saver == "jax":
        sess = tsession.load_session(str(d["jax"]), device="cpu")
        assert type(sess.calibration) is TArtifact
        ref_xy = sess.ref.xy.numpy()
    else:
        sess = jsession.load_session(str(d["port"]))
        assert type(sess.calibration) is JArtifact
        ref_xy = np.asarray(sess.ref.xy)
    want = _artifact(JArtifact, True)
    for name in ("fx", "dist", "R_wc", "T_wc", "extrinsic_reproj_error"):
        _assert_same(getattr(sess.calibration, name), getattr(want, name))
    np.testing.assert_array_equal(ref_xy, jref.xy)
    assert sess.frames_seen == 12
