"""Host-side matplotlib visualizations (reference C16-C18 + stats plots).

A verbatim copy of ``vision_basedsensor_tpu/analysis/plots.py`` on the
port's ``layout``: the plots take numpy arrays (or CPU tensors).

All plotting is optional host work (gated on matplotlib), decoupled from the
jitted compute path. Figure content matches the reference's outputs:

* deviation-field 3D quiver with fitted contact plane, mean-deviation vector
  and per-marker labels (``ForceDistribution.visualize_deviations``,
  :214-288);
* ring-averaged start/end displacement plot (``LocalAnalysis.py:96-143``);
* labeled frame-0 3D scatter (``MarkerDisplacement.plot_frame_zero_...``);
* per-marker XYZ / scalar displacement series
  (``MarkerDisplacement.plot_marker_displacement``, :119-199);
* per-marker 3-panel analysis — 3D trajectory, per-step displacement,
  cumulative displacement — with the broken 2x2/3x1 subplot mix of
  ``3d_reconstruction.py:338-342`` fixed (quirk 10).
"""
from __future__ import annotations

import numpy as np

from vision_basedsensor_tpu_torch import layout


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def set_axes_equal(ax) -> None:
    """Equal 3D aspect (the helper the reference copy-pastes 4x, SURVEY §1)."""
    limits = np.array([ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()])
    origin = limits.mean(axis=1)
    radius = 0.5 * np.max(np.abs(limits[:, 1] - limits[:, 0]))
    ax.set_xlim3d([origin[0] - radius, origin[0] + radius])
    ax.set_ylim3d([origin[1] - radius, origin[1] + radius])
    ax.set_zlim3d([origin[2] - radius, origin[2] + radius])


def plot_deviation_field(result, path: str, initial_mode: str = "plane",
                         scale: float = 1.0, elev: float = 20,
                         azim: float = 45) -> None:
    """3D deviation quiver + fitted plane + mean vector (C16)."""
    plt = _mpl()
    dev = np.asarray(result.deviation)
    ok = np.asarray(result.valid)
    if not ok.any():
        # No common markers (e.g. disjoint vert/tilt id sets): emit an
        # explanatory figure instead of crashing on empty reductions after
        # all the compute already succeeded.
        fig = plt.figure(figsize=(6, 4))
        fig.text(0.5, 0.5, "no valid deviation vectors", ha="center",
                 va="center")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        return
    table = layout.dome_layout()
    x0, y0 = table[:, 1], table[:, 2]
    z0 = table[:, 3] if initial_mode == "shell" else np.zeros_like(x0)

    fig = plt.figure(figsize=(12, 10))
    ax = fig.add_subplot(111, projection="3d")

    xe = x0 + scale * dev[:, 0]
    ye = y0 + scale * dev[:, 1]
    ze = z0 + scale * dev[:, 2]

    a, b, c = float(result.plane.a), float(result.plane.b), float(result.plane.c)
    gx = np.linspace(xe[ok].min(), xe[ok].max(), 10)
    gy = np.linspace(ye[ok].min(), ye[ok].max(), 10)
    GX, GY = np.meshgrid(gx, gy)
    ax.plot_surface(GX, GY, a * GX + b * GY + c, color="orange", alpha=0.3,
                    linewidth=0)

    ax.scatter(x0[ok], y0[ok], z0[ok], c="blue", s=50, alpha=0.8, edgecolors="k",
               label="Initial Position")
    ax.quiver(x0[ok], y0[ok], z0[ok], scale * dev[ok, 0], scale * dev[ok, 1],
              scale * dev[ok, 2], color="red", arrow_length_ratio=0.2,
              linewidth=1.5, alpha=0.8)
    ax.scatter(xe[ok], ye[ok], ze[ok], c="red", marker="s", s=30, alpha=0.6)

    mv = np.asarray(result.mean_vector)
    ax.quiver(x0[ok].mean(), y0[ok].mean(), z0[ok].mean(), mv[0], mv[1], mv[2],
              color="green", linewidth=4, arrow_length_ratio=0.2)
    for mid in np.where(ok)[0]:
        ax.text(x0[mid], y0[mid], z0[mid] + 0.5, str(mid + 1), color="purple",
                fontsize=8, weight="bold")

    ax.set_xlabel("X (mm)")
    ax.set_ylabel("Y (mm)")
    ax.set_zlabel("Z (mm)")
    ax.set_title(f"3D Deviation Analysis ({initial_mode} view)\n"
                 f"Tilt: {float(result.tilt_deg):.2f} deg, "
                 f"Mean Magnitude: {float(result.mean_magnitude):.4f} mm")
    set_axes_equal(ax)
    ax.view_init(elev=elev, azim=azim)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def plot_ring_displacement(displacement, valid, marker_ids, path: str) -> None:
    """Start/end averaged displacement vectors for a marker subset (C17)."""
    plt = _mpl()
    d = np.asarray(displacement)
    ok = np.asarray(valid)
    table = layout.dome_layout()
    sel = np.asarray(marker_ids) - 1
    sel = sel[ok[sel]]

    start = table[sel, 1:]
    end = start + d[sel]
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(*start.T, c="blue", marker="o", s=80, edgecolors="k", alpha=0.6,
               label="Start Position (Avg)")
    ax.scatter(*end.T, c="red", marker="P", s=100, alpha=0.8,
               label="End Position (Avg)")
    ax.quiver(start[:, 0], start[:, 1], start[:, 2], d[sel, 0], d[sel, 1],
              d[sel, 2], color="green", arrow_length_ratio=0.1, linewidth=2.0,
              alpha=0.8, label="Displacement Vector")
    for m, (x, y, z) in zip(sel, start):
        ax.text(x, y, z + 1, f"M{m + 1}", color="purple", fontsize=9, weight="bold")
    ax.set_xlabel("World X (mm)")
    ax.set_ylabel("World Y (mm)")
    ax.set_zlabel("World Z (mm)")
    ax.set_title("Averaged 3D Marker Displacement")
    ax.legend(loc="best")
    set_axes_equal(ax)
    fig.tight_layout()
    fig.savefig(path, dpi=400, bbox_inches="tight")
    plt.close(fig)


def plot_frame_positions(recon, frame: int, path: str) -> None:
    """Labeled 3D scatter of all markers at one frame (C18a)."""
    plt = _mpl()
    world = np.asarray(recon.world)[frame]
    seen = np.asarray(recon.seen)[frame]
    fig = plt.figure(figsize=(12, 10))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(world[seen, 0], world[seen, 1], world[seen, 2], c="k",
               marker="o", s=50, alpha=0.8,
               label=f"Marker Position (Frame {frame})")
    for m in np.where(seen)[0]:
        ax.text(world[m, 0] + 0.5, world[m, 1] + 0.5, world[m, 2], str(m + 1),
                color="red", fontsize=10, weight="bold")
    ax.set_xlabel("World X (mm)")
    ax.set_ylabel("World Y (mm)")
    ax.set_zlabel("World Z (mm)")
    ax.set_title(f"3D Marker Coordinates in Frame {frame} (Labeled)")
    ax.legend(loc="best")
    set_axes_equal(ax)
    fig.tight_layout()
    fig.savefig(path, dpi=400, bbox_inches="tight")
    plt.close(fig)


def plot_marker_series(recon, marker_id: int, path: str,
                       mode: str = "SCALAR") -> None:
    """Per-marker time series, 'XYZ' or 'SCALAR' mode (C18b)."""
    plt = _mpl()
    m = marker_id - 1
    world = np.asarray(recon.world)[:, m]
    seen = np.asarray(recon.seen)[:, m]
    frames = np.arange(world.shape[0])[seen]
    fig, ax = plt.subplots(figsize=(10, 6))
    if mode == "XYZ":
        for i, lbl in enumerate(["X Position (mm)", "Y Position (mm)",
                                 "Z Position (mm)"]):
            ax.plot(frames, world[seen, i], label=lbl, linewidth=2)
        ax.set_ylabel("Position (mm)")
        title = f"Position of Marker {marker_id} Over Time (X, Y, Z)"
    else:
        ffn = np.asarray(recon.from_first_norm)[:, m]
        ax.plot(frames, ffn[seen], color="purple", linewidth=3,
                label="Total Displacement from Start (mm)")
        ax.set_ylabel("Displacement Magnitude (mm)")
        title = f"Scalar Displacement of Marker {marker_id} from Start Point"
    ax.set_xlabel("Frame Number")
    ax.set_title(title)
    ax.legend(loc="best")
    ax.grid(True, linestyle="--", alpha=0.7)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def plot_marker_analysis(recon, marker_id: int, path: str) -> None:
    """3-panel per-marker analysis: 3D trajectory + per-step + cumulative
    (3d_reconstruction.analyze_displacement content, fixed layout)."""
    plt = _mpl()
    m = marker_id - 1
    world = np.asarray(recon.world)[:, m]
    seen = np.asarray(recon.seen)[:, m]
    sv = np.asarray(recon.step_valid)[:, m]
    sn = np.asarray(recon.step_norm)[:, m]
    cum = np.asarray(recon.cum_path)[:, m]
    frames = np.arange(world.shape[0])

    fig = plt.figure(figsize=(12, 12))
    ax = fig.add_subplot(3, 1, 1, projection="3d")
    ax.plot(world[seen, 0], world[seen, 1], world[seen, 2], "b.-",
            linewidth=0.5, markersize=3)
    ax.set_title(f"3D Trajectory - Marker {marker_id}")
    ax.set_xlabel("X (mm)")
    ax.set_ylabel("Y (mm)")
    ax.set_zlabel("Z (mm)")

    ax2 = fig.add_subplot(3, 1, 2)
    ax2.plot(frames[sv], sn[sv], "r.-", markersize=3)
    ax2.set(title="Frame-to-Frame Displacement", xlabel="Frame Number",
            ylabel="Displacement (mm)", ylim=(0, None))
    ax2.grid(True)

    ax3 = fig.add_subplot(3, 1, 3)
    ax3.plot(frames[seen], cum[seen], "g.-", markersize=3)
    ax3.set(title="Cumulative Displacement", xlabel="Frame Number",
            ylabel="Total Displacement (mm)", ylim=(0, None))
    ax3.grid(True)

    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
