"""The command line of the PyTorch port (``vbs-torch``).

Port of ``vision_basedsensor_tpu/cli/main.py`` for the offline replay and
the pose-compensation loop:

  detect       single image -> marker centroids + ids
  track        video -> tracking CSV (+ annotated video)
  reconstruct  tracking CSV + calibration -> 3D coordinates
  analyze      vertical + tilted experiment TXTs -> deviation + tilt
  tilt         vertical + tilted compression videos -> pose tilt
  indent       staircase (probe indentation) evaluation on a video
  record       MJPEG stream -> .avi, the JPEG payloads muxed verbatim
  run-live     live MJPEG stream -> pipeline (+ --publish, --resume)
  calibrate-intrinsics  chessboard images or corners -> IntrinsicParameters.xlsx
  calibrate-extrinsics  world + pixel marker points -> ExtrinsicParameters.xlsx
  synth        render a synthetic dome video (test data)
  diameter     marker diameter validation (C19)
  serve        MJPEG acquisition server (--synthetic: rendered dome frames)

The arguments are the reference's, spelled the same, so a user's scripts run
unchanged. Two options are new, both before the subcommand: ``--device
{cuda,cpu}`` (default ``cuda``), passed to every constructor; without a card
and without ``--device cpu`` every command raises (``core/device.py``).
``--profile-dir DIR`` runs the subcommand under ``torch.profiler`` and
writes its Chrome trace, with the program's spans
(``utils/profiling.py:SPANS``), to ``DIR/trace.json``. The reference's
``bench`` is not registered here, so argparse refuses it.
``--plots-dir`` and ``--plot`` need matplotlib.

``track --tpu-decode`` reads the video with ``MjpegAviCudaSource`` and
``run-live --tpu-decode`` the stream with ``MjpegCudaVideoSource`` (host
entropy decode, dequant-IDCT on the device) fed by ``device_feed``. Unlike
the reference, which falls back to host decode when that source cannot be
built, both raise: a user who asks for the device decode gets it or an
error.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _load_cfg(args):
    from vision_basedsensor_tpu_torch.config import PipelineConfig, from_json
    if getattr(args, "config", None):
        return from_json(args.config)
    return PipelineConfig()


def _make_source(path: str):
    from vision_basedsensor_tpu_torch.io.video import (
        ArrayVideoSource, FileVideoSource, MjpegAviSource)
    if path.endswith((".npy", ".npz")):
        return ArrayVideoSource(path)
    try:
        # MJPG AVIs (what the acquisition stack records) decode on all
        # host cores; other codecs fall back to sequential cv2.
        return MjpegAviSource(path)
    except ValueError:          # not an MJPEG AVI
        return FileVideoSource(path)


def _host(outputs):
    """A named tuple of tensors (nested ones too) as numpy arrays: one copy
    per field."""
    return type(outputs)(*(_host(x) if isinstance(x, tuple)
                           else x.cpu().numpy() for x in outputs))


def _stream_video(path, args, cfg, apply_warmup: bool, chunk: int):
    """Run the full pipeline over a video in bounded host memory.

    Chunks stream through ``StreamingPipeline`` (carried state makes the
    result identical to one batch), and only the small per-frame marker
    outputs accumulate, on the host. Returns ``(tracked, recon, cam,
    pipeline)`` with numpy leaves spanning all frames.
    """
    from vision_basedsensor_tpu_torch.pipeline import StreamingPipeline
    from vision_basedsensor_tpu_torch.utils.profiling import trace_annotation
    if getattr(args, "tpu_decode", False):
        from vision_basedsensor_tpu_torch.io.video import (MjpegAviCudaSource,
                                                           device_feed)
        # Host entropy decode on a prefetch thread, the device decode on
        # this one, one batch of device lookahead (io/video.py:device_feed).
        batches = device_feed(MjpegAviCudaSource(path, device=args.device),
                              chunk, args.device)
    else:
        batches = _make_source(path).batches(chunk)
    sp, cam = None, None
    tr, rc = [], []
    for batch in batches:
        if sp is None:
            cam = _camera_from_args(args, batch.shape)
            sp = StreamingPipeline(cam, cfg,
                                   crop=getattr(args, "crop", False),
                                   apply_warmup=apply_warmup,
                                   device=args.device)
        out = sp.process(batch)
        with trace_annotation("vbs.stream.readback"):
            tr.append(_host(out.tracked))
            rc.append(_host(out.recon))
    if sp is None:
        raise SystemExit(f"no frames in {path}")
    cat = lambda f, cs: np.concatenate([getattr(c, f) for c in cs])
    tracked = tr[0]._replace(xy=cat("xy", tr), axes=cat("axes", tr),
                             angle=cat("angle", tr), valid=cat("valid", tr))
    recon = type(rc[0])(*[cat(f, rc) for f in rc[0]._fields])
    return tracked, recon, cam, sp


def cmd_detect(args):
    import torch

    from vision_basedsensor_tpu_torch.detect import detect_markers
    from vision_basedsensor_tpu_torch.track import assign_identities
    cfg = _load_cfg(args)
    if args.image.endswith(".npy"):
        img = np.load(args.image)
    else:
        import cv2
        img = cv2.imread(args.image)
    det = detect_markers(torch.as_tensor(img, device=args.device), cfg.detect)
    ref = assign_identities(det, cfg.track)
    valid, xy, axes, ring = (x.cpu().numpy() for x in (ref.valid, ref.xy,
                                                        ref.axes, ref.ring))
    print("marker_id,ring,x,y,major_axis,minor_axis")
    for m in np.where(valid)[0]:
        print(f"{m + 1},{int(ring[m])},{xy[m, 0]:.3f},"
              f"{xy[m, 1]:.3f},{axes[m, 0]:.3f},{axes[m, 1]:.3f}")
    print(f"# detected {valid.sum()} markers", file=sys.stderr)


def cmd_track(args):
    import dataclasses

    from vision_basedsensor_tpu_torch.io.table import write_tracking_csv
    cfg = _load_cfg(args)
    if args.undistort:
        cfg = dataclasses.replace(cfg, undistort_frames=True)
    tracked, _, cam, _ = _stream_video(args.video, args, cfg,
                                       apply_warmup=False, chunk=args.chunk)
    os.makedirs(args.output_dir, exist_ok=True)
    csv_path = os.path.join(args.output_dir, "markers.csv")
    write_tracking_csv(csv_path, tracked)
    print(f"wrote {csv_path}")
    if args.annotate:
        import torch

        from vision_basedsensor_tpu_torch.detect.overlay import draw_tracking
        from vision_basedsensor_tpu_torch.io.video import VideoWriter
        from vision_basedsensor_tpu_torch.pipeline import (_preprocess,
                                                           prepare_undistortion)
        # Tracked coordinates live in the preprocessed (cropped/rectified)
        # frame space, so draw on those frames (the reference annotates the
        # preprocessed frames too, marker_detection.py:434-453). Second
        # streaming pass: frames are decoded again per chunk.
        vw = None
        t = 0
        rectify_map = None
        rectify_hw = None
        for batch in _make_source(args.video).batches(args.chunk):
            draw_frames = batch
            if args.crop or cfg.undistort_frames:
                if cfg.undistort_frames:
                    fh, fw = (int(batch.shape[1]), int(batch.shape[2]))
                    # The rectify map depends only on the frame shape.
                    if rectify_hw != (fh, fw):
                        rectify_map, _ = prepare_undistortion(
                            cam, fh, fw, cfg, args.crop)
                        rectify_hw = (fh, fw)
                draw_frames = _preprocess(
                    torch.as_tensor(batch, device=args.device), cfg,
                    args.crop, rectify_map).cpu().numpy()
            if vw is None:
                h, w = draw_frames.shape[1:3]
                vw = VideoWriter(os.path.join(args.output_dir, "tracked.avi"),
                                 12.0, (w, h))
            for f in draw_frames:
                vw.write(draw_tracking(f, tracked, t))
                t += 1
        vw.close()
        print(f"wrote {os.path.join(args.output_dir, 'tracked.avi')}")


def _load_artifact(args):
    """The json/xlsx calibration-artifact loader of every subcommand."""
    from vision_basedsensor_tpu_torch.calibrate import CalibrationArtifact
    if not getattr(args, "calibration", None):
        return None
    art = CalibrationArtifact.load_json(args.calibration) \
        if args.calibration.endswith(".json") \
        else CalibrationArtifact.load_intrinsics_xlsx(args.calibration)
    if getattr(args, "extrinsics", None):
        art = art.load_extrinsics_xlsx(args.extrinsics)
    return art


def _camera_from_args(args, frame_shape):
    art = _load_artifact(args)
    if art is not None:
        return art.to_camera(device=args.device)
    # Default: nominal synthetic-scene camera for the frame size.
    from vision_basedsensor_tpu_torch.synth import default_scene
    h, w = frame_shape[1:3]
    return default_scene(height=h, width=w, device=args.device).cam


def cmd_reconstruct(args):
    import torch

    from vision_basedsensor_tpu_torch.analysis import displacement_statistics
    from vision_basedsensor_tpu_torch.io.table import (read_tracking_csv,
                                                       write_coords_table)
    from vision_basedsensor_tpu_torch.reconstruct import reconstruct_sequence
    from vision_basedsensor_tpu_torch.track.associate import TrackedFrames
    cfg = _load_cfg(args)
    cam = _camera_from_args(args, (0, 480, 640))
    data = read_tracking_csv(args.tracking_csv)
    f32 = lambda k: torch.as_tensor(data[k], dtype=torch.float32,
                                    device=args.device)
    tracked = TrackedFrames(
        xy=f32("xy"), ref_xy=f32("ref_xy"), axes=f32("axes"),
        angle=f32("angle"),
        ring=torch.zeros(65, dtype=torch.int32, device=args.device),
        valid=torch.as_tensor(data["valid"], device=args.device))
    dev_recon = reconstruct_sequence(cam, tracked, cfg.reconstruct,
                                     apply_warmup=not args.no_warmup)
    recon = _host(dev_recon)
    write_coords_table(args.output, recon)
    stats = _host(displacement_statistics(dev_recon))
    print(f"wrote {args.output}")
    print(f"{int(recon.seen.sum())} marker observations reconstructed")
    if args.plots_dir:
        from vision_basedsensor_tpu_torch.analysis.plots import \
            plot_marker_analysis
        os.makedirs(args.plots_dir, exist_ok=True)
        for m in np.where(stats.count > 0)[0]:
            plot_marker_analysis(recon, m + 1,
                                 os.path.join(args.plots_dir,
                                              f"marker_{m + 1}_analysis.png"))
    if args.ring is not None:
        # Ring-local averaged start/end displacement (the reference's
        # LocalAnalysis.py, C17): positions averaged over two frame windows,
        # by default the reference's (LocalAnalysis.py:14-15, carried in
        # AnalysisConfig) clipped into the video's frame range.
        from vision_basedsensor_tpu_torch import layout
        from vision_basedsensor_tpu_torch.analysis import start_end_displacement
        from vision_basedsensor_tpu_torch.analysis.plots import \
            plot_ring_displacement
        n = recon.world.shape[0]
        acfg = cfg.analysis
        clip = lambda rng: (min(rng[0], n - 1), min(rng[1], n - 1))
        sr = args.start_range or clip(acfg.start_frame_range)
        er = args.end_range or clip(acfg.end_frame_range)
        disp, ok = (x.cpu().numpy() for x in start_end_displacement(
            dev_recon, tuple(sr), tuple(er)))
        first = 1 + sum(layout.RING_COUNTS[:args.ring])
        ids = np.arange(first, first + layout.RING_COUNTS[args.ring])
        mags = np.linalg.norm(disp[ids - 1], axis=-1)
        okr = ok[ids - 1]
        mean_mag = float(mags[okr].mean()) if okr.any() else float("nan")
        print(f"ring {args.ring} (markers {ids[0]}-{ids[-1]}): mean "
              f"displacement {mean_mag:.4f} mm over frames {sr}->{er}")
        out = os.path.join(args.plots_dir or ".",
                           f"ring_{args.ring}_displacement.png")
        if args.plots_dir:
            os.makedirs(args.plots_dir, exist_ok=True)
        plot_ring_displacement(disp, ok, ids, out)
        print(f"wrote {out}")


def cmd_analyze(args):
    import torch

    from vision_basedsensor_tpu_torch.analysis import (analyze_deviation,
                                                       deviation_field)
    from vision_basedsensor_tpu_torch.io.table import read_experiment_txt
    cfg = _load_cfg(args)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=args.device)
    ok = lambda x: torch.as_tensor(x, device=args.device)
    d_vert, ok_v = read_experiment_txt(args.vertical)
    d_tilt, ok_t = read_experiment_txt(args.tilted)
    dev, valid = deviation_field(f32(d_vert), ok(ok_v), f32(d_tilt), ok(ok_t))
    res = analyze_deviation(dev, valid, cfg.analysis, initial_mode=args.mode)
    _print_tilt(res)
    if args.plot:
        _plot_deviation(res, args, cfg)


def _print_tilt(res):
    tilt, mag = res.tilt_deg.item(), res.mean_magnitude.item()
    print(f"-> Plane Fit: Tilt Angle = {tilt:.2f} degrees")
    print(f"-> Mean deviation magnitude: {mag:.4f} mm")


def _plot_deviation(res, args, cfg):
    from vision_basedsensor_tpu_torch.analysis.plots import plot_deviation_field
    plot_deviation_field(_host(res), args.plot, initial_mode=args.mode,
                         scale=cfg.analysis.deviation_scale)
    print(f"wrote {args.plot}")


def cmd_tilt(args):
    """Vertical and tilted compression videos -> the contact-plane tilt.

    Runs the full pipeline on both videos, averages positions over the
    configured start/end frame ranges (LocalAnalysis semantics), writes the
    reference-format experiment TXTs, computes the deviation field and the
    contact-plane tilt angle.
    """
    import torch

    from vision_basedsensor_tpu_torch import layout
    from vision_basedsensor_tpu_torch.analysis import (analyze_deviation,
                                                       deviation_field,
                                                       start_end_displacement)
    from vision_basedsensor_tpu_torch.io.table import write_experiment_txt
    cfg = _load_cfg(args)

    def process(path, tag):
        _, recon, _, _ = _stream_video(path, args, cfg,
                                       apply_warmup=not args.no_warmup,
                                       chunk=args.chunk)
        recon = type(recon)(*(torch.as_tensor(v, device=args.device)
                              for v in recon))
        rng_start = tuple(args.start_range or cfg.analysis.start_frame_range)
        rng_end = tuple(args.end_range or cfg.analysis.end_frame_range)
        d, ok = start_end_displacement(recon, rng_start, rng_end)
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            table = layout.dome_layout()[:, 1:]
            write_experiment_txt(os.path.join(args.output_dir, f"{tag}.txt"),
                                 table, table + d.cpu().numpy(),
                                 ok.cpu().numpy())
        return d, ok

    d_vert, ok_v = process(args.vertical_video, "vertical")
    d_tilt, ok_t = process(args.tilted_video, "tilted")
    dev, ok = deviation_field(d_vert, ok_v, d_tilt, ok_t)
    res = analyze_deviation(dev, ok, cfg.analysis, initial_mode=args.mode)
    print(f"common markers: {int(ok.sum())}")
    _print_tilt(res)
    if args.plot:
        _plot_deviation(res, args, cfg)


def cmd_indent(args):
    """Staircase (probe-indentation) evaluation on a video.

    A probe indents the bonnet in ``--steps`` prescribed ``--step-mm``
    increments (README.md:103-121); the command runs the full pipeline and
    reports the measured mean marker displacement at each step against the
    prescribed depth: cumulative and single-step errors (the reference
    reports 0.04-0.18 mm single-step).
    """
    import dataclasses
    cfg = _load_cfg(args)
    # Short staircase videos have no 100-frame warm-up to skip, and the
    # rest-to-full-depth drift exceeds the frame-0 association gate;
    # sequential association follows it.
    cfg = dataclasses.replace(
        cfg, track=dataclasses.replace(cfg.track,
                                       association_mode=args.association))
    _, recon, _, _ = _stream_video(args.video, args, cfg,
                                   apply_warmup=False, chunk=args.chunk)
    ffn, seen = recon.from_first_norm, recon.seen
    n_frames = ffn.shape[0]
    fps_step = args.frames_per_step
    steps = min(args.steps, (n_frames - 1) // fps_step)
    if steps < args.steps:
        print(f"# only {n_frames} frames: evaluating {steps} steps",
              file=sys.stderr)
    if steps < 1:
        print(f"error: {n_frames} frame(s) is fewer than one full step "
              f"({fps_step + 1} frames needed at --frames-per-step "
              f"{fps_step}); nothing to evaluate", file=sys.stderr)
        sys.exit(2)
    rows = []
    prev = 0.0
    for k in range(1, steps + 1):
        t = k * fps_step  # last frame of step k (settled)
        m = seen[t]
        measured = float(ffn[t][m].mean()) if m.any() else float("nan")
        rows.append((k, k * args.step_mm, measured, measured - k * args.step_mm,
                     measured - prev - args.step_mm, int(m.sum())))
        prev = measured
    header = ("step,prescribed_mm,measured_mm,cumulative_error_mm,"
              "step_error_mm,markers")
    print(header)
    for r in rows:
        print(f"{r[0]},{r[1]:.3f},{r[2]:.4f},{r[3]:+.4f},{r[4]:+.4f},{r[5]}")
    errs = np.array([abs(r[4]) for r in rows])
    print(f"# worst single-step error: {errs.max():.4f} mm "
          f"(reference: 0.04-0.18 mm)", file=sys.stderr)
    print(f"# cumulative error at step {steps}: {rows[-1][3]:+.4f} mm",
          file=sys.stderr)
    if args.output:
        with open(args.output, "w") as f:
            f.write(header + "\n")
            for r in rows:
                f.write(f"{r[0]},{r[1]:.3f},{r[2]:.4f},{r[3]:.4f},"
                        f"{r[4]:.4f},{r[5]}\n")
        print(f"wrote {args.output}", file=sys.stderr)
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
        ks = [r[0] for r in rows]
        ax1.bar(ks, [r[2] for r in rows], color="skyblue",
                edgecolor="black", label="Measured")
        ax1.plot(ks, [r[1] for r in rows], "r--", label="Prescribed")
        ax1.set(title="Cumulative Displacement", xlabel="Step",
                ylabel="Displacement (mm)")
        ax1.legend()
        ax2.plot(ks, [abs(r[4]) for r in rows], "o-", color="crimson")
        ax2.set(title="Single-step Absolute Error", xlabel="Step",
                ylabel="Error (mm)")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=150)
        plt.close(fig)
        print(f"wrote {args.plot}", file=sys.stderr)
    return 0


def cmd_record(args):
    """Record an MJPEG stream to a playable ``.avi`` without transcoding:
    the received JPEG payloads are muxed verbatim
    (``io/video.py:MjpegAviWriter``), so recording costs no decode and
    loses no quality. Ctrl-C finalizes the file cleanly."""
    from vision_basedsensor_tpu_torch.io.mjpeg import iter_mjpeg_bytes, sof_dims
    from vision_basedsensor_tpu_torch.io.video import MjpegAviWriter
    w = None
    try:
        for jb in iter_mjpeg_bytes(args.url, max_frames=args.max_frames):
            if w is None:
                dims = sof_dims(jb)
                if dims is None:
                    raise ValueError("no SOF marker found")
                w = MjpegAviWriter(args.output, args.fps, dims)
                print(f"recording {dims[0]}x{dims[1]} @ {args.fps} fps -> "
                      f"{args.output}", flush=True)
            w.write_jpeg(jb)
            if w.frames_written % 100 == 0:
                print(f"recorded {w.frames_written} frames", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        if w is not None:
            w.close()
            print(f"wrote {args.output} ({w.frames_written} frames)")
    if w is None:
        print("no frames received", file=sys.stderr)
        return 1
    return 0


def _read_image(path: str):
    """A still image as numpy: ``.npy`` loaded, anything else decoded by
    ``io/video.py:decode_jpeg`` (cv2, else PIL); None where it does not
    decode."""
    if path.lower().endswith(".npy"):
        return np.load(path)
    from vision_basedsensor_tpu_torch.io.video import decode_jpeg
    with open(path, "rb") as f:
        return decode_jpeg(f.read())


def cmd_calibrate_intrinsics(args):
    """Intrinsics from a directory of chessboard images (the reference's
    C10 flow: crop, corners, Zhang; ``intrinsic_calibration.py:53-109``) or
    from an npz of corners (``objs`` (V, N, 3), ``imgs`` (V, N, 2))."""
    from vision_basedsensor_tpu_torch.calibrate import (CalibrationArtifact,
                                                        calibrate_intrinsics)
    cfg = _load_cfg(args)
    if os.path.isdir(args.corners):
        from vision_basedsensor_tpu_torch.calibrate.images import \
            calibrate_from_images
        images = []
        for f in sorted(os.listdir(args.corners)):
            if f.lower().endswith((".npy", ".png", ".jpg", ".jpeg", ".bmp")):
                img = _read_image(os.path.join(args.corners, f))
                if img is not None:
                    images.append(img)
        out = calibrate_from_images(
            images, pattern_size=cfg.calibrate.pattern_size,
            square_mm=cfg.calibrate.square_size_mm,
            crop_ratios=cfg.crop_ratios if args.crop else None,
            min_images=cfg.calibrate.min_images,
            refine_iters=cfg.calibrate.refine_iters, device=args.device)
        if out is None:
            print("Insufficient valid images")
            return 1
        res, art = out.result, out.artifact
        print(f"used {len(out.used_images)}/{len(images)} images")
    else:
        data = np.load(args.corners)
        res = calibrate_intrinsics(data["objs"], data["imgs"],
                                   refine_iters=cfg.calibrate.refine_iters,
                                   device=args.device)
        art = CalibrationArtifact(
            fx=float(res.cam.fx), fy=float(res.cam.fy), cx=float(res.cam.cx),
            cy=float(res.cam.cy), skew=0.0, dist=res.cam.dist.cpu().numpy(),
            intrinsic_reproj_error=float(res.mean_reproj_error))
    art.save_intrinsics_xlsx(args.output)
    print(f"calibration RMS {float(res.mean_reproj_error):.4f} px -> "
          f"{args.output}")
    if args.plots_dir:
        from vision_basedsensor_tpu_torch.calibrate.plots import \
            plot_board_poses
        os.makedirs(args.plots_dir, exist_ok=True)
        path = os.path.join(args.plots_dir, "board_poses.png")
        plot_board_poses(res.rvecs.cpu().numpy(), res.tvecs.cpu().numpy(),
                         cfg.calibrate.pattern_size,
                         cfg.calibrate.square_size_mm, path)
        print(f"wrote {path}")


def cmd_calibrate_extrinsics(args):
    """Camera pose from the markers' world points (CSV marker_id,Xw,Yw,Zw)
    and their pixels (CSV marker_id,u,v) by RANSAC PnP (reference C11)."""
    import csv as _csv

    import torch

    from vision_basedsensor_tpu_torch.calibrate import (CalibrationArtifact,
                                                        solve_pnp_ransac)
    cfg = _load_cfg(args)
    art = CalibrationArtifact.load_intrinsics_xlsx(args.intrinsics)

    def read_pts(path, cols):
        with open(path) as f:
            rows = list(_csv.DictReader(f))
        ids = [int(float(r["marker_id"])) for r in rows]
        return ids, np.array([[float(r[c]) for c in cols] for r in rows])

    wid, world = read_pts(args.world_points, ("Xw", "Yw", "Zw"))
    pid, pix = read_pts(args.pixel_points, ("u", "v"))
    common = sorted(set(wid) & set(pid))
    obj = np.stack([world[wid.index(i)] for i in common])
    img = np.stack([pix[pid.index(i)] for i in common])

    res = solve_pnp_ransac(obj, img,
                           art.to_camera(torch.float64, device=args.device),
                           cfg.calibrate)
    art.R_wc = res.R_wc.cpu().numpy()
    art.T_wc = res.T_wc.cpu().numpy()
    art.extrinsic_reproj_error = float(res.mean_reproj_error)
    art.save_extrinsics_xlsx(args.output)
    print(f"PnP solved with {int(res.num_inliers)} inliers")
    print(f"Mean reprojection error: {float(res.mean_reproj_error):.3f} "
          "pixels")
    print(f"-> {args.output}")


def cmd_synth(args):
    """Render a synthetic dome video: the probe staircase or a cosine
    wave of -Z displacement, saved as uint8 ``.npy``."""
    import torch

    from vision_basedsensor_tpu_torch.synth import (default_scene,
                                                    indentation_staircase,
                                                    render_frames)
    scene = default_scene(args.height, args.width, device=args.device)
    if args.motion == "staircase":
        disp = indentation_staircase(frames_per_step=args.frames_per_step,
                                     device=args.device)
    else:
        t = np.arange(args.frames, dtype=np.float32)
        d = np.zeros((args.frames, 65, 3), np.float32)
        d[:, :, 2] = -(1 - np.cos(t / 10.0))[:, None]
        disp = torch.from_numpy(d).to(args.device)
    frames = render_frames(scene, disp).to(torch.uint8).cpu().numpy()
    np.save(args.output, frames)
    print(f"wrote {args.output} {frames.shape}")


def select_threshold_interactive(gray: "np.ndarray",
                                 initial: int = 127) -> float:  # pragma: no cover
    """cv2 trackbar picker for the binarization threshold — the reference's
    interactive flow (DiameterValidation.py:76-111). Requires a display;
    shows the inverted-binary preview live, ENTER/ESC accepts.
    """
    import cv2
    win = "Threshold Selection (ENTER to accept)"
    cv2.namedWindow(win, cv2.WINDOW_NORMAL)
    state = {"thr": initial}

    def on_change(v):
        state["thr"] = v
        _, binary = cv2.threshold(gray.astype(np.uint8), v, 255,
                                  cv2.THRESH_BINARY_INV)
        cv2.imshow(win, binary)

    cv2.createTrackbar("Threshold", win, initial, 255, on_change)
    on_change(initial)
    while True:
        key = cv2.waitKey(50) & 0xFF
        if key in (13, 27):  # ENTER / ESC
            break
        if cv2.getWindowProperty(win, cv2.WND_PROP_VISIBLE) < 1:
            break
    cv2.destroyWindow(win)
    return float(state["thr"])


def cmd_diameter(args):
    """Marker-diameter precision validation (reference C19): the scale
    from a chessboard in the image (or ``--scale``), each marker's
    diameter in mm."""
    import torch

    from vision_basedsensor_tpu_torch.analysis.diameter import (
        chessboard_scale, measure_diameters)
    from vision_basedsensor_tpu_torch.calibrate.chessboard import \
        find_chessboard
    from vision_basedsensor_tpu_torch.core.imaging import to_grayscale
    img = _read_image(args.image)
    if img is None:
        raise ValueError(f"cannot decode {args.image}")
    gray = to_grayscale(torch.as_tensor(img, device=args.device))
    if args.interactive and args.threshold is None:  # pragma: no cover
        args.threshold = select_threshold_interactive(gray.cpu().numpy())
        print(f"[INFO] Selected threshold: {args.threshold:.0f}")

    if args.scale:
        scale = args.scale
    else:
        board = find_chessboard(gray, tuple(args.pattern), device=args.device)
        if not board.found:
            print("[ERROR] Chessboard not found; pass --scale px/mm instead")
            return 1
        scale = chessboard_scale(board.corners, tuple(args.pattern),
                                 args.square_mm)
        print(f"[INFO] Scale: {scale:.2f} px/mm from chessboard")

    res = measure_diameters(gray, scale, threshold=args.threshold,
                            diameter_offset_mm=args.offset,
                            device=args.device)
    valid = res.valid.cpu().numpy()
    d = res.diameters_mm.cpu().numpy()[valid]
    c = res.centers.cpu().numpy()[valid]
    print("x,y,diameter_mm,circularity")
    for (x, y), dd, cc in zip(c, d, res.circularity.cpu().numpy()[valid]):
        print(f"{x:.1f},{y:.1f},{dd:.3f},{cc:.3f}")
    print(f"# Mean Diameter: {d.mean():.3f} mm", file=sys.stderr)
    print(f"# Std Deviation: {d.std():.3f} mm", file=sys.stderr)
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(10, 6))
        ids = np.arange(1, len(d) + 1)
        ax.bar(ids, d, color="skyblue", edgecolor="black", label="Measured")
        ax.axhline(2.0, color="red", linestyle="--", label="Spec (2 mm)")
        ax.set(title="Marker Diameter Analysis", xlabel="Marker ID",
               ylabel="Diameter (mm)")
        ax.text(0.98, 0.98, f"Count: {len(d)}\nMean: {d.mean():.2f} mm\n"
                f"Std Dev: {d.std():.2f} mm", transform=ax.transAxes,
                va="top", ha="right",
                bbox=dict(facecolor="white", alpha=0.8))
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.plot, dpi=150)
        plt.close(fig)
        print(f"wrote {args.plot}")


def cmd_run_live(args):
    """Consume a live MJPEG stream through the pipeline, printing each
    chunk's tracking and, with ``--publish``, serving the last frame's
    contact state. ``--tpu-decode`` decodes on the device
    (``MjpegCudaVideoSource``) and raises where it cannot be built; the
    session (``--resume``) is saved on every exit path, Ctrl-C included."""
    from vision_basedsensor_tpu_torch.io.mjpeg import (MjpegCudaVideoSource,
                                                       MjpegVideoSource)
    from vision_basedsensor_tpu_torch.io.session import (load_session,
                                                         save_session)
    from vision_basedsensor_tpu_torch.pipeline import StreamingPipeline
    cfg = _load_cfg(args)
    calibration = _load_artifact(args)
    if calibration is not None:
        cam = calibration.to_camera(device=args.device)
    else:
        cam = _camera_from_args(args, (0, cfg.capture.height,
                                       cfg.capture.width))
    ref = carry = assoc_xy = None
    fseen = 0
    if args.resume and os.path.exists(args.resume):
        sess = load_session(args.resume, device=args.device)
        ref, cfg, assoc_xy = sess.ref, sess.config, sess.assoc_xy
        carry = sess.scan_carry or None
        fseen = sess.frames_seen
        if sess.calibration is not None:
            calibration = sess.calibration
            cam = sess.calibration.to_camera(device=args.device)
        print(f"resumed session from {args.resume}")
    sp = StreamingPipeline(cam, cfg, ref=ref, carry=carry, assoc_xy=assoc_xy,
                           frames_seen=fseen, device=args.device)
    if args.tpu_decode:
        src = MjpegCudaVideoSource(args.url, max_frames=args.max_frames,
                                   device=args.device)
    else:
        src = MjpegVideoSource(args.url, max_frames=args.max_frames)
    pub = None
    if args.publish is not None:
        from vision_basedsensor_tpu_torch.io.publish import (
            StatePublisher, contact_state_payload)
        pub = StatePublisher(port=args.publish, host=args.publish_host)
        print(f"contact state served on {args.publish_host}:{pub.port} "
              "(/state, /events, /healthz)", flush=True)
    try:
        for out in sp.run(src, batch_size=args.batch):
            seen = out.recon.seen.cpu().numpy()
            ffn = out.recon.from_first_norm.cpu().numpy()
            mean_disp = float(ffn[seen].mean()) if seen.any() else 0.0
            print(f"frames {sp.frames_seen}: tracked "
                  f"{int(seen[-1].sum())}/65 markers, "
                  f"mean displacement {mean_disp:.3f} mm", flush=True)
            if pub is not None and out.contact is not None:
                pub.update(contact_state_payload(out.contact, -1,
                                                 sp.frames_seen))
    finally:
        # Ctrl-C is the normal end of a live session: the checkpoint (with
        # the calibration, so a resume keeps the camera) is written on
        # every exit path.
        if pub is not None:
            pub.close()
        if src.last_dropped:
            print(f"note: {src.last_dropped} stream frame(s) skipped to "
                  "stay current (pipeline slower than stream)", flush=True)
        st = getattr(src, "last_stats", None)
        if st and st.get("transport") in ("tdelta", "split", "packed"):
            per = st["bytes_shipped"] / max(1, st["frames"])
            dense = st["bytes_dense"] / max(1, st["frames"])
            print(f"tpu-decode transport: {per / 1024:.1f} KB/frame over "
                  f"the link ({dense / 1024:.0f} KB dense equivalent)",
                  flush=True)
        if args.resume and sp.ref is not None:
            save_session(args.resume, sp.ref, cfg, calibration=calibration,
                         scan_carry=sp.carry, assoc_xy=sp.assoc_xy,
                         frames_seen=sp.frames_seen)
            print(f"session saved to {args.resume}")


def cmd_serve(args):
    from vision_basedsensor_tpu_torch.capture import run_server
    cfg = _load_cfg(args)
    cap = cfg.capture
    if args.port is not None:
        import dataclasses
        cap = dataclasses.replace(cap, port=args.port)
    run_server(cap, synthetic=args.synthetic, block=True, device=args.device)


def main(argv=None):
    from vision_basedsensor_tpu_torch.core.device import resolve

    p = argparse.ArgumentParser(
        prog="vbs-torch",
        description="vision-based tactile sensor on the GPU")
    p.add_argument("--config", help="PipelineConfig JSON file")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where every tensor is built (default: the card)")
    p.add_argument("--profile-dir", metavar="DIR",
                   help="run the command under torch.profiler and write its "
                        "Chrome trace, with the program's spans (vbs.*), "
                        "to DIR/trace.json")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("detect", help="detect markers in a single image")
    d.add_argument("image")
    d.set_defaults(fn=cmd_detect)

    t = sub.add_parser("track", help="track markers through a video")
    t.add_argument("video")
    t.add_argument("--output-dir", default="results")
    t.add_argument("--crop", action="store_true")
    t.add_argument("--undistort", action="store_true",
                   help="undistort frames before detection "
                        "(marker_detection.py:88-109; needs --calibration)")
    t.add_argument("--annotate", action="store_true")
    t.add_argument("--chunk", type=int, default=256,
                   help="streaming chunk size (bounds host RAM)")
    t.add_argument("--tpu-decode", action="store_true",
                   help="MJPG AVIs: native entropy decode on the host, "
                        "dequantization and IDCT on the device via the "
                        "temporal-delta sparse transport; raises for other "
                        "inputs (no fallback to host decode)")
    t.add_argument("--calibration")
    t.add_argument("--extrinsics")
    t.set_defaults(fn=cmd_track)

    ci = sub.add_parser("calibrate-intrinsics")
    ci.add_argument("corners",
                    help="npz with objs (V,N,3) + imgs (V,N,2), OR a "
                         "directory of chessboard images (png/jpg/npy)")
    ci.add_argument("--output", default="IntrinsicParameters.xlsx")
    ci.add_argument("--crop", action="store_true",
                    help="apply the pipeline crop ratios before detection")
    ci.add_argument("--plots-dir")
    ci.set_defaults(fn=cmd_calibrate_intrinsics)

    ce = sub.add_parser("calibrate-extrinsics")
    ce.add_argument("intrinsics")
    ce.add_argument("world_points", help="CSV marker_id,Xw,Yw,Zw")
    ce.add_argument("pixel_points", help="CSV marker_id,u,v")
    ce.add_argument("--output", default="ExtrinsicParameters.xlsx")
    ce.set_defaults(fn=cmd_calibrate_extrinsics)

    r = sub.add_parser("reconstruct")
    r.add_argument("tracking_csv")
    r.add_argument("--output", default="marker_3d_coordinates.csv")
    r.add_argument("--calibration")
    r.add_argument("--extrinsics")
    r.add_argument("--plots-dir")
    r.add_argument("--no-warmup", action="store_true")
    r.add_argument("--ring", type=int, choices=range(1, 6),
                   help="ring-local averaged displacement analysis "
                        "(LocalAnalysis.py semantics; ring 2 = markers "
                        "8-19); writes ring_<N>_displacement.png")
    r.add_argument("--start-range", type=int, nargs=2,
                   help="frame window averaged as the START position "
                        "(default 1-30, reference LocalAnalysis.py:14, "
                        "clipped to the video)")
    r.add_argument("--end-range", type=int, nargs=2,
                   help="frame window averaged as the END position "
                        "(default 120-150, reference LocalAnalysis.py:15, "
                        "clipped to the video)")
    r.set_defaults(fn=cmd_reconstruct)

    a = sub.add_parser("analyze")
    a.add_argument("vertical", help="vertical-compression experiment TXT")
    a.add_argument("tilted", help="tilted-compression experiment TXT")
    a.add_argument("--mode", default="plane", choices=["plane", "shell"])
    a.add_argument("--plot")
    a.set_defaults(fn=cmd_analyze)

    ti = sub.add_parser("tilt", help="vertical+tilted videos -> pose tilt")
    ti.add_argument("vertical_video")
    ti.add_argument("tilted_video")
    ti.add_argument("--mode", default="plane", choices=["plane", "shell"])
    ti.add_argument("--output-dir", help="write reference-format TXT exports")
    ti.add_argument("--start-range", type=int, nargs=2)
    ti.add_argument("--end-range", type=int, nargs=2)
    ti.add_argument("--no-warmup", action="store_true")
    ti.add_argument("--chunk", type=int, default=256,
                    help="streaming chunk size (bounds host RAM)")
    ti.add_argument("--calibration")
    ti.add_argument("--extrinsics")
    ti.add_argument("--plot")
    ti.set_defaults(fn=cmd_tilt)

    ind = sub.add_parser("indent",
                         help="staircase (probe indentation) evaluation on "
                              "a video (README.md:103-121)")
    ind.add_argument("video")
    ind.add_argument("--steps", type=int, default=12)
    ind.add_argument("--step-mm", type=float, default=0.7)
    ind.add_argument("--frames-per-step", type=int, default=1,
                     help="frames recorded at each indentation depth "
                          "(the last frame of each step is evaluated)")
    ind.add_argument("--association", default="sequential",
                     choices=["sequential", "frame0"])
    ind.add_argument("--chunk", type=int, default=256)
    ind.add_argument("--output", help="write the per-step table as CSV")
    ind.add_argument("--plot", help="write the error-analysis figure "
                                    "(img/Sensor_Error_Analysis.png analog)")
    ind.add_argument("--calibration")
    ind.add_argument("--extrinsics")
    ind.set_defaults(fn=cmd_indent)

    rec = sub.add_parser("record",
                         help="record an MJPEG stream to .avi without "
                              "transcoding (collecting.py:177-191)")
    rec.add_argument("url")
    rec.add_argument("output")
    rec.add_argument("--fps", type=float, default=12.0)
    rec.add_argument("--max-frames", type=int)
    rec.set_defaults(fn=cmd_record)

    s = sub.add_parser("synth")
    s.add_argument("--output", default="synthetic.npy")
    s.add_argument("--motion", default="staircase",
                   choices=["staircase", "wave"])
    s.add_argument("--frames", type=int, default=60)
    s.add_argument("--frames-per-step", type=int, default=1)
    s.add_argument("--height", type=int, default=480)
    s.add_argument("--width", type=int, default=640)
    s.set_defaults(fn=cmd_synth)

    dm = sub.add_parser("diameter", help="marker diameter validation (C19)")
    dm.add_argument("image")
    dm.add_argument("--pattern", type=int, nargs=2, default=[6, 6])
    dm.add_argument("--square-mm", type=float, default=3.0)
    dm.add_argument("--scale", type=float, help="px/mm (skip chessboard)")
    dm.add_argument("--threshold", type=float,
                    help="binary threshold (default Otsu)")
    dm.add_argument("--interactive", action="store_true",
                    help="pick the threshold with a cv2 trackbar (needs a "
                         "display)")
    dm.add_argument("--offset", type=float, default=0.0)
    dm.add_argument("--plot")
    dm.set_defaults(fn=cmd_diameter)

    rl = sub.add_parser("run-live", help="process a live MJPEG stream")
    rl.add_argument("url")
    rl.add_argument("--batch", type=int, default=32)
    rl.add_argument("--max-frames", type=int)
    rl.add_argument("--calibration")
    rl.add_argument("--extrinsics")
    rl.add_argument("--resume", help="session checkpoint directory")
    rl.add_argument("--publish", type=int, metavar="PORT",
                    help="serve the latest contact state as JSON on this "
                         "port (/state, /events; 0 = ephemeral) for the "
                         "robot-side pose compensation (README.md:124)")
    rl.add_argument("--publish-host", default="127.0.0.1",
                    help="bind address for --publish (default loopback; "
                         "the endpoint has no auth — use 0.0.0.0 only on "
                         "an isolated robot LAN)")
    rl.add_argument("--tpu-decode", action="store_true",
                    help="decode the stream's JPEGs on the device: native "
                         "entropy decode on the host, dequantization and "
                         "IDCT on the device via the temporal-delta sparse "
                         "transport; raises where that decoder cannot be "
                         "built (no fallback to host decode)")
    rl.set_defaults(fn=cmd_run_live)

    sv = sub.add_parser("serve", help="MJPEG acquisition server")
    sv.add_argument("--port", type=int)
    sv.add_argument("--synthetic", action="store_true")
    sv.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    args.device = resolve(args.device)
    if args.profile_dir is None:
        return args.fn(args)
    from vision_basedsensor_tpu_torch.utils.profiling import profile_to
    with profile_to(args.profile_dir, args.device):
        return args.fn(args)


if __name__ == "__main__":
    main()
