"""Canonical artifact schemas + reference-format compatibility notes.

A verbatim copy of ``vision_basedsensor_tpu/io/schemas.py``, kept so
that the port never imports the JAX package.

The reference's stages exchange data through files with drifting schemas
(SURVEY.md §2.2 quirk 5): the tracker emits ``frameno,row,col,Ox,Oy,Cx,Cy,
major_axis,minor_axis,angle`` (``tracking.py:13-26``); the 3D stage emits
``X,Y,Z,...`` keyed by (row, col) (``3d_reconstruction.py:296-307``); Stage-4
consumers expect ``marker_id,Xw,Yw,Zw`` (``LocalAnalysis.py:47,58``,
``MarkerDisplacement.py:72,135``). The canonical schemas here carry
``marker_id`` end to end while keeping every reference column.
"""

# Stage-1 output (2D tracking). Superset of the reference tracker's columns.
TRACKING_COLUMNS = (
    "frameno", "marker_id", "row", "col",
    "Ox", "Oy", "Cx", "Cy", "major_axis", "minor_axis", "angle",
)

# Stage-3 output (3D coordinates). Union of the reference writer's columns
# (X/Y/Z/dX/dY/dZ/displacement) and the Stage-4 consumers' expectations
# (marker_id/Xw/Yw/Zw), plus cumulative displacement (quirk 9 resolution:
# both per-step and cumulative are emitted).
COORDS_3D_COLUMNS = (
    "frameno", "marker_id", "row", "col",
    "Xw", "Yw", "Zw", "dX", "dY", "dZ",
    "displacement", "cumulative_displacement", "displacement_from_start",
)

# Experiment export (ForceDistribution.load_experimental_data, :110-136).
EXPERIMENT_COLUMNS = (
    "MarkerID", "X_start", "Y_start", "Z_start", "X_end", "Y_end", "Z_end",
)
