"""Tabular artifact I/O: tracking CSV, 3D-coordinate tables, experiment TXT.

The port of ``vision_basedsensor_tpu/io/table.py`` on the port's ``layout``
and ``io/xlsx``; both packages write the same bytes. The tracking writer
gathers the valid marker-frames with numpy and formats the whole table in
one call to the native formatter (``native/table_format.cpp``); the other
functions are copies of the JAX package's. The writers read their inputs
with ``np.asarray``, so they take numpy arrays (or CPU tensors): move a
card's outputs to the host first, one ``.cpu()`` per field.

Stdlib CSV + the local xlsx shim; reads both this framework's canonical
schemas and the reference's variants (encoding sniff + multi-delimiter like
``3d_reconstruction.load_marker_data``, :149-160, minus the chardet
dependency — UTF-8/Latin-1 fallback covers the same files).
"""
from __future__ import annotations

import csv
import io as _stdio
import re

import numpy as np

from vision_basedsensor_tpu_torch import layout, native
from vision_basedsensor_tpu_torch.io import xlsx
from vision_basedsensor_tpu_torch.io.schemas import COORDS_3D_COLUMNS, TRACKING_COLUMNS
from vision_basedsensor_tpu_torch.utils.profiling import trace_annotation


def _read_text(path: str) -> str:
    with open(path, "rb") as f:
        raw = f.read()
    for enc in ("utf-8", "latin-1"):
        try:
            return raw.decode(enc)
        except UnicodeDecodeError:
            continue
    return raw.decode("utf-8", errors="replace")


def _id_from_row_col(row: np.ndarray, col: np.ndarray) -> np.ndarray:
    """Stable marker_id from a (ring, within-ring index) pair.

    Used when reading reference-produced CSVs that lack marker_id; the
    resulting ids are stable per marker but may be rotated within a ring
    relative to the canonical numbering (the reference's angle-index origin
    differs — marker_detection.py:339-344).
    """
    bases = layout._ring_base_ids()
    counts = np.asarray(layout.RING_COUNTS)
    r = np.clip(row.astype(int), 0, layout.NUM_RINGS)
    return np.where(r == 0, 1, bases[r] + np.mod(col.astype(int), counts[r]))


def write_tracking_csv(path: str, tracked) -> None:
    """Write a TrackedFrames batch to the canonical tracking CSV."""
    with trace_annotation("vbs.io.table"):
        _write_tracking_csv(path, tracked)


def _write_tracking_csv(path: str, tracked) -> None:
    xy = np.asarray(tracked.xy)
    axes = np.asarray(tracked.axes)
    angle = np.asarray(tracked.angle)
    valid = np.asarray(tracked.valid)
    ref_xy = np.asarray(tracked.ref_xy)
    rings = np.asarray(tracked.ring)
    bases = layout._ring_base_ids()

    # Rows frame-major, then marker, as the reference's row loop visits them.
    t, m = np.nonzero(valid)
    ring = rings[m].astype(np.int64)
    ints = np.stack([t, m + 1, ring, m + 1 - bases[ring]], axis=1,
                    dtype=np.int64)
    vals = np.concatenate([ref_xy[m], xy[t, m], axes[t, m], angle[t, m, None]],
                          axis=1, dtype=np.float64)    # widening is exact
    body = native.format_table_rows(ints, vals)

    head = _stdio.StringIO()
    csv.writer(head).writerow(TRACKING_COLUMNS)
    with open(path, "wb") as f:
        f.write(head.getvalue().encode())
        f.write(body)


def read_tracking_csv(path: str) -> dict[str, np.ndarray]:
    """Read a tracking CSV (canonical or reference schema) into dense arrays.

    Returns dict with ``xy (T, 65, 2)``, ``axes (T, 65, 2)``, ``angle``,
    ``ref_xy (65, 2)``, ``valid (T, 65)`` and ``frames (T,)`` — frames are the
    sorted unique frameno values.
    """
    text = _read_text(path)
    # Reference CSVs may be comma-, tab- or whitespace-separated.
    sample = text.splitlines()[0]
    if "," in sample:
        rows = list(csv.reader(_stdio.StringIO(text)))
    else:
        rows = [re.split(r"[\s\t]+", ln.strip()) for ln in text.splitlines() if ln.strip()]
    header = [h.strip() for h in rows[0]]
    idx = {h: i for i, h in enumerate(header)}
    data = [r for r in rows[1:] if len(r) >= len(header) and r[0] != ""]

    fr = np.array([float(r[idx["frameno"]]) for r in data])
    row_c = np.array([float(r[idx["row"]]) for r in data])
    col_c = np.array([float(r[idx["col"]]) for r in data])
    if "marker_id" in idx:
        mid = np.array([int(float(r[idx["marker_id"]])) for r in data])
    else:
        mid = _id_from_row_col(row_c, col_c)

    frames = np.unique(fr)
    fmap = {f: i for i, f in enumerate(frames)}
    T = len(frames)
    out = {
        "xy": np.zeros((T, layout.NUM_MARKERS, 2)),
        "axes": np.zeros((T, layout.NUM_MARKERS, 2)),
        "angle": np.zeros((T, layout.NUM_MARKERS)),
        "valid": np.zeros((T, layout.NUM_MARKERS), bool),
        "ref_xy": np.zeros((layout.NUM_MARKERS, 2)),
        "frames": frames,
    }
    for k, r in enumerate(data):
        t = fmap[fr[k]]
        m = int(mid[k]) - 1
        if not 0 <= m < layout.NUM_MARKERS:
            continue
        out["xy"][t, m] = [float(r[idx["Cx"]]), float(r[idx["Cy"]])]
        out["axes"][t, m] = [float(r[idx["major_axis"]]), float(r[idx["minor_axis"]])]
        out["angle"][t, m] = float(r[idx["angle"]])
        out["valid"][t, m] = True
        out["ref_xy"][m] = [float(r[idx["Ox"]]), float(r[idx["Oy"]])]
    return out


def write_coords_table(path: str, recon, fmt: str | None = None) -> None:
    """Write a Reconstruction to the 3D-coordinates table
    (``marker_3d_coordinates.xlsx`` analog, Stage-4-consumable)."""
    import numpy as _np
    fmt = fmt or ("xlsx" if path.endswith(".xlsx") else "csv")
    world = _np.asarray(recon.world)
    seen = _np.asarray(recon.seen)
    step = _np.asarray(recon.step)
    sn = _np.asarray(recon.step_norm)
    cum = _np.asarray(recon.cum_path)
    ffn = _np.asarray(recon.from_first_norm)

    rows = [list(COORDS_3D_COLUMNS)]
    bases = layout._ring_base_ids()
    rings_tab = layout.marker_rings()
    for t in range(world.shape[0]):
        for m in range(world.shape[1]):
            if not seen[t, m]:
                continue
            ring = int(rings_tab[m])
            rows.append([t, m + 1, ring, m + 1 - int(bases[ring]),
                         float(world[t, m, 0]), float(world[t, m, 1]),
                         float(world[t, m, 2]), float(step[t, m, 0]),
                         float(step[t, m, 1]), float(step[t, m, 2]),
                         float(sn[t, m]), float(cum[t, m]), float(ffn[t, m])])
    if fmt == "xlsx":
        xlsx.write_xlsx(path, rows)
    else:
        with open(path, "w", newline="") as f:
            csv.writer(f).writerows(rows)


def read_coords_table(path: str) -> dict[str, np.ndarray]:
    """Read a 3D-coordinates table (ours, or any table exposing
    frameno/marker_id/Xw/Yw/Zw like Stage 4 expects)."""
    if path.endswith(".xlsx"):
        rows = xlsx.read_xlsx(path)
        header = [str(h) for h in rows[0]]
        data = [r for r in rows[1:] if r and r[0] is not None]
    else:
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        header = rows[0]
        data = [r for r in rows[1:] if r]
    idx = {h: i for i, h in enumerate(header)}
    get = lambda r, k: float(r[idx[k]])
    fr = np.array([get(r, "frameno") for r in data])
    mid = np.array([int(get(r, "marker_id")) for r in data])
    xyz = np.array([[get(r, "Xw"), get(r, "Yw"), get(r, "Zw")] for r in data])

    frames = np.unique(fr)
    fmap = {f: i for i, f in enumerate(frames)}
    T = len(frames)
    world = np.zeros((T, layout.NUM_MARKERS, 3))
    seen = np.zeros((T, layout.NUM_MARKERS), bool)
    for k in range(len(data)):
        m = mid[k] - 1
        if 0 <= m < layout.NUM_MARKERS:
            world[fmap[fr[k]], m] = xyz[k]
            seen[fmap[fr[k]], m] = True
    return {"world": world, "seen": seen, "frames": frames}


def read_experiment_txt(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a start/end experiment export (``initial4.txt`` / ``40.txt``
    format: header junk, then MarkerID X_start .. Z_end —
    ``ForceDistribution.py:110-136``).

    Returns ``(displacement (65, 3) end-start, valid (65,))``.
    """
    text = _read_text(path)
    pos = -1
    for kw in ("MarkerID", "marker_id"):
        pos = text.find(kw)
        if pos != -1:
            break
    if pos == -1:
        raise ValueError(f"Header not found in {path}")
    lines = [ln for ln in text[pos:].splitlines() if ln.strip()]
    header = re.split(r"\s+", lines[0].strip())
    idx = {h: i for i, h in enumerate(header)}
    if "marker_id" in idx:
        idx["MarkerID"] = idx.pop("marker_id")

    disp = np.zeros((layout.NUM_MARKERS, 3))
    valid = np.zeros(layout.NUM_MARKERS, bool)
    for ln in lines[1:]:
        parts = re.split(r"\s+", ln.strip())
        if len(parts) < 7:
            continue
        mid = int(float(parts[idx["MarkerID"]]))
        if not 1 <= mid <= layout.NUM_MARKERS:
            continue
        start = [float(parts[idx[f"{a}_start"]]) for a in "XYZ"]
        end = [float(parts[idx[f"{a}_end"]]) for a in "XYZ"]
        disp[mid - 1] = np.subtract(end, start)
        valid[mid - 1] = True
    return disp, valid


def write_experiment_txt(path: str, start: np.ndarray, end: np.ndarray,
                         valid: np.ndarray) -> None:
    """Write the experiment export format Stage 4 consumes."""
    with open(path, "w") as f:
        f.write("MarkerID X_start Y_start Z_start X_end Y_end Z_end\n")
        for m in range(len(valid)):
            if not valid[m]:
                continue
            s, e = start[m], end[m]
            f.write(f"{m + 1} {s[0]:.6f} {s[1]:.6f} {s[2]:.6f} "
                    f"{e[0]:.6f} {e[1]:.6f} {e[2]:.6f}\n")
