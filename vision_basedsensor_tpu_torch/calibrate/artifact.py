"""Typed calibration artifact with reference-compatible serialization.

A copy of ``vision_basedsensor_tpu/calibrate/artifact.py``: the same JSON
and XLSX bytes, so an artifact saved by either package loads in the other.
``to_camera`` builds the port's ``CameraModel`` on ``device``.

Fixes SURVEY.md §2.2 quirks 6/7: the reference saves intrinsics under column
``Param`` but loads ``Parameter``, saves translations as ``T_wc_X`` but loads
``Tx_wc``, and assembles distortion coefficients in two different orders. One
typed artifact here owns the canonical state (OpenCV dist order
``[k1,k2,p1,p2,k3]``); the Excel writers emit the union of both naming
conventions so both the reference's writers and readers round-trip, and the
readers accept either.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

import numpy as np

import torch

from vision_basedsensor_tpu_torch.core.camera import CameraModel
from vision_basedsensor_tpu_torch.core.device import CUDA
from vision_basedsensor_tpu_torch.io import xlsx

DIST_KEYS = ("k1", "k2", "p1", "p2", "k3")


@dataclass
class CalibrationArtifact:
    fx: float
    fy: float
    cx: float
    cy: float
    skew: float = 0.0
    dist: np.ndarray = field(default_factory=lambda: np.zeros(5))
    intrinsic_reproj_error: float | None = None
    R_wc: np.ndarray | None = None
    T_wc: np.ndarray | None = None
    extrinsic_reproj_error: float | None = None

    def to_camera(self, dtype=torch.float32, device=CUDA) -> CameraModel:
        """The port's camera on ``device`` (the card by default)."""
        return CameraModel.create(
            self.fx, self.fy, self.cx, self.cy, self.skew, self.dist,
            R_wc=self.R_wc, T_wc=self.T_wc, dtype=dtype, device=device)

    # ---------------- intrinsics (IntrinsicParameters.xlsx) ----------------

    def save_intrinsics_xlsx(self, path: str) -> None:
        """Schema of ``intrinsic_calibration.save_calib_results`` (:33-51),
        with header ``Parameter`` (the name every loader expects)."""
        rows = [["Parameter", "Value", "Description"],
                ["fx", float(self.fx), "Focal length x"],
                ["fy", float(self.fy), "Focal length y"],
                ["cx", float(self.cx), "Principal point x"],
                ["cy", float(self.cy), "Principal point y"],
                ["skew", float(self.skew), "Skew coefficient"]]
        descs = ["Radial dist coeff 1", "Radial dist coeff 2",
                 "Tangential dist coeff 1", "Tangential dist coeff 2",
                 "Radial dist coeff 3"]
        for k, v, d in zip(DIST_KEYS, np.asarray(self.dist, float), descs):
            rows.append([k, float(v), d])
        if self.intrinsic_reproj_error is not None:
            rows.append(["Reproj Error", float(self.intrinsic_reproj_error),
                         "Mean error (px)"])
        xlsx.write_xlsx(path, rows)

    @classmethod
    def load_intrinsics_xlsx(cls, path: str) -> "CalibrationArtifact":
        rows = xlsx.read_xlsx(path)
        header = [str(h) if h is not None else "" for h in rows[0]]
        # Accept both 'Param' (reference writer) and 'Parameter' (loaders).
        key_col = 0
        for cand in ("Parameter", "Param"):
            if cand in header:
                key_col = header.index(cand)
                break
        val_col = header.index("Value") if "Value" in header else 1
        params: dict[str, float] = {}
        for r in rows[1:]:
            k = r[key_col]
            v = r[val_col]
            if isinstance(k, str) and isinstance(v, (int, float)):
                params[k.strip()] = float(v)
        dist = np.array([params.get(k, 0.0) for k in DIST_KEYS])
        return cls(fx=params["fx"], fy=params["fy"], cx=params["cx"],
                   cy=params["cy"], skew=params.get("skew", 0.0), dist=dist,
                   intrinsic_reproj_error=params.get("Reproj Error"))

    # ---------------- extrinsics (ExtrinsicParameters.xlsx) ----------------

    def save_extrinsics_xlsx(self, path: str) -> None:
        """Schema of ``extrinsic_calibration.save_extrinsics_to_excel``
        (:125-161), emitting translations under BOTH naming conventions
        (``T_wc_X`` as written there and ``Tx_wc`` as read by
        ``3d_reconstruction.py:120-124``)."""
        assert self.R_wc is not None and self.T_wc is not None
        rows = [["Parameter", "Value", "Description"],
                ["--- Camera Extrinsic Parameters ---", "", ""]]
        if self.extrinsic_reproj_error is not None:
            rows.append(["Reprojection Error (px)",
                         float(self.extrinsic_reproj_error), ""])
        rows.append(["--- World to Camera Transformation ---", "", ""])
        R = np.asarray(self.R_wc, float)
        for i in range(3):
            for j in range(3):
                rows.append([f"R_wc_{i + 1}{j + 1}", float(R[i, j]),
                             f"Rotation matrix element ({i + 1},{j + 1})"])
        T = np.asarray(self.T_wc, float).reshape(3)
        for i, axis in enumerate("XYZ"):
            rows.append([f"T_wc_{axis}", float(T[i]),
                         f"Translation in {axis}-axis (mm)"])
            rows.append([f"T{axis.lower()}_wc", float(T[i]),
                         f"Translation in {axis}-axis (mm) [alias]"])
        xlsx.write_xlsx(path, rows)

    def load_extrinsics_xlsx(self, path: str) -> "CalibrationArtifact":
        rows = xlsx.read_xlsx(path)
        params: dict[str, float] = {}
        for r in rows:
            if len(r) >= 2 and isinstance(r[0], str) and isinstance(r[1], (int, float)):
                params[r[0].strip()] = float(r[1])
        R = np.array([[params[f"R_wc_{i}{j}"] for j in (1, 2, 3)] for i in (1, 2, 3)])
        def _t(a):
            # Both reference naming conventions accepted (quirk 6); a file
            # with NEITHER fails loudly like the rotation path — a silent
            # 0.0 default placed the camera at the world origin with no
            # warning (round-3 review).
            for key in (f"T_wc_{a}", f"T{a.lower()}_wc"):
                if key in params:
                    return params[key]
            raise KeyError(f"extrinsics xlsx missing translation {a} "
                           f"(tried T_wc_{a} / T{a.lower()}_wc)")
        T = np.array([_t(a) for a in "XYZ"])
        return dataclasses.replace(
            self, R_wc=R, T_wc=T,
            extrinsic_reproj_error=params.get("Reprojection Error (px)"))

    # ---------------- native JSON ----------------

    def save_json(self, path: str) -> None:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, np.ndarray):
                d[k] = v.tolist()
        with open(path, "w") as f:
            json.dump(d, f, indent=2)

    @classmethod
    def load_json(cls, path: str) -> "CalibrationArtifact":
        with open(path) as f:
            d = json.load(f)
        for k in ("dist", "R_wc", "T_wc"):
            if d.get(k) is not None:
                d[k] = np.asarray(d[k])
        return cls(**d)
