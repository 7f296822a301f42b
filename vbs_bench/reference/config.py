"""Typed configuration tree shared by every pipeline stage.

A frozen copy of the port's module of the same name, plain PyTorch only."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class DetectProfile:
    """Resolution-dependent detector constants.

    Mirrors the two branches of ``marker_detection.py:117-126`` (<=480 rows vs
    larger frames).
    """
    blur_small_ksize: int = 21
    blur_small_sigma: float = 4.56
    blur_large_ksize: int = 35
    blur_large_sigma: float = 11.4
    template_size: int = 33
    template_sigma: float = 7.4
    dog_threshold: int = 35          # inRange low (marker_detection.py:129)
    dog_high: int = 180              # inRange high
    peak_window: int = 9             # local-max suppression window (odd; ref. neighborhood 8)
    band_window: int = 8             # boundary-band neighborhood (marker_detection.py:170)
    patch_size: int = 40             # centroid/moment window around each peak
    radial_cutoff_px: float = 18.0   # restrict moments to this radius inside patch
    # (the Voronoi gate handles closer neighbors; the cutoff only needs to
    # bound the region inside the patch, with headroom for blobs growing as
    # the bonnet compresses toward the camera)
    soft_floor: float = 0.08         # symmetric floor/saturation remap of the
    # photometric soft weights: w -> clip((w - f) / (1 - 2f), 0, 1). Sensor
    # noise only ADDS soft mass outside the blob (background pixels sit at
    # w ~ 0 and the clip at 0 truncates the negative half of the noise), so
    # unfloored soft second moments inflate additively under noise —
    # measured: sigma=2 gray noise attenuated a 15 deg tilt recovery to
    # ~9 deg via diameter-biased depths; with f=0.08 it recovers 15.0 deg.
    # The remap zeroes the noise tail (w < f), saturates the interior
    # symmetrically (w > 1-f), and leaves the half-level point fixed
    # (remap(0.5) = 0.5, so the wh moments and the axis-scale calibration
    # are unchanged). f=0.08 kills a ~1.6-sigma noise tail at the weakest
    # DoG contrast while preserving ring identification on the reference's
    # cluttered annotated figure (f=0.15 was measured to shift photometric
    # centers enough to break it). 0 disables.


# marker_detection.py:123-126,129,170: the >480-row profile.
HIGH_RES_PROFILE = DetectProfile(
    blur_small_ksize=39, blur_small_sigma=8.0,
    blur_large_ksize=101, blur_large_sigma=20.0,
    template_size=81, template_sigma=13.0,  # ref uses l=80; odd size keeps the kernel centered
    dog_threshold=20, dog_high=200,
    peak_window=15, band_window=14, patch_size=64, radial_cutoff_px=30.0,
)


@dataclass(frozen=True)
class DetectConfig:
    """2D marker detection (reference C4+C5)."""
    low_res: DetectProfile = field(default_factory=DetectProfile)
    high_res: DetectProfile = field(default_factory=lambda: HIGH_RES_PROFILE)
    low_res_max_rows: int = 480      # profile switch (marker_detection.py:117)
    dog_offset: int = 15             # "+15" bias (marker_detection.py:128)
    ncc_threshold: float = 0.1       # NCC superlevel mask (marker_detection.py:133)
    max_candidates: int = 96         # fixed K slots (>= 65 markers + clutter)
    open_ksize: int = 5              # morphological open on area mask (:194-195)
    min_minor_axis_px: float = 5.0   # minimum ellipse minor axis (:219)
    center_match_frac: float = 10.0  # centroid-vs-ellipse gate = minor/frac (:225)
    channel_order: str = "bgr"       # input color order when frames are 3-channel
    # "mask": axes from the opened DoG area mask (reference behavior — the
    #   band-pass dilates the blob, so axes overestimate the true image
    #   diameter exactly like the reference's fitEllipse-on-area-mask does).
    # "photometric": axes from intensity-weighted moments of the raw gray
    #   patch — unbiased estimate of the true projected marker diameter,
    #   giving absolute (not just differential) depth accuracy.
    # Defaults favor accuracy ("photometric"); switch both to the reference-
    # parity modes ("mask"/"band") to reproduce the reference's numerics,
    # including its biases (see tests/test_detect.py).
    diameter_mode: str = "photometric"
    centroid_mode: str = "photometric"  # "band" (reference parity) | "photometric"
    # Partial-occlusion completion (beats the reference's drop-the-marker
    # semantics, 3d_reconstruction.py:309-311): a marker half-hidden by the
    # probe presents as a censored disk — high axis ratio with a skewed
    # intensity distribution. When the photometric moments match that
    # signature (ratio within the window AND third-moment skew along the
    # minor axis above the floor), the true center/diameter are recovered
    # from the visible part (ops/moments.py:complete_occluded) and the
    # candidate is flagged ``Detections.occluded`` (lower confidence)
    # instead of being dropped by the reconstruct-stage axis-ratio gate.
    occlusion_completion: bool = True
    occlusion_min_ratio: float = 1.45   # censored-disk s ~ -0.42
    occlusion_max_ratio: float = 6.0    # past ~s=0.8 too little remains
    occlusion_min_skew: float = 0.08    # uncensored blobs sit near 0
    # Window-sum backend: "pallas" (fused kernel with per-window HBM->VMEM
    # DMA, ops/pallas/moments.py — 3.4x faster detect on TPU, measured
    # 593 -> 176 us/frame), "xla" (gather + reduce), or "auto" (pallas on
    # TPU, xla elsewhere).
    backend: str = "auto"
    # Run the DoG/NCC filter matmuls with bf16 operands (f32 accumulation).
    # 8-bit pixel values are exact in bf16; band-matrix weights lose ~0.4%,
    # shifting filtered values by ~0.2 gray levels — borderline threshold
    # pixels can flip, moving centroids by ~0.01 px. Off by default for
    # bit-level parity with the f32 path.
    fast_filters: bool = False
    # Compute the paired-window moment sums via the MXU raw-moment basis
    # (two fixed-basis matmuls per integrand channel + per-window binomial
    # shift, ops/moments.py:moments_from_patches_paired_mxu) instead of the
    # fused VPU reductions. Measured e2e at B=1024 on the v5e: full detect
    # 91.6 -> 83.8 us/frame (benchmarks/README.md round 5) — the moment
    # reductions were vector-issue-bound and the MXU runs them beside the
    # VPU pipeline. False restores the fused-reduction backend (bit-level
    # parity is pinned between the two either way).
    moment_mxu_basis: bool = True


@dataclass(frozen=True)
class TrackConfig:
    """Identity assignment + frame-to-frame association (reference C6+C7)."""
    num_rings: int = 5               # KMeans clusters (marker_detection.py:308)
    kmeans_iters: int = 32           # fixed-iteration device KMeans
    min_marker_distance_px: float = 20.0  # association gate (:359,372,483)
    # Mapping from measured image angles to dome-layout angles for the id
    # bijection: world_angle = angle_sign * image_angle + angle_offset_deg.
    # With the canonical mounting (camera under the apex, R_wc ~ I) image and
    # layout angles coincide; a mirrored view needs angle_sign = -1 and a
    # camera roll needs a nonzero offset.
    angle_sign: float = 1.0
    angle_offset_deg: float = 0.0
    # Estimate each ring's angular phase from the detections before slot
    # assignment (circular mean of the residuals modulo the ring step).
    # Handles real hardware whose printed rings are rotated relative to the
    # nominal table — e.g. the reference prototype's outermost markers sit
    # ~45 deg off the published cardinal positions in img/raw_markers.png.
    per_ring_phase: bool = True
    # Ring assignment method:
    #   "layout_prior" (default): consensus-scale match against the known
    #     dome ring radii — robust to clutter detections and unbalanced ring
    #     populations; rejects detections off the dome entirely.
    #   "kmeans": radius clustering like the reference (marker_detection.py:308)
    #     — no layout knowledge, fragile to clutter.
    # Association target: "frame0" replicates the reference (gate against
    # frame-0 positions, marker_detection.py:363); "sequential" gates against
    # each marker's last sighting via lax.scan — robust to cumulative drift
    # beyond the gate (e.g. deep indentation), detection stays batched.
    association_mode: str = "frame0"
    ring_method: str = "layout_prior"
    # Residual gate as a fraction of the outer radius; 0.09 sits just under
    # the smallest half-gap between expected rings (~0.088) and accommodates
    # real-hardware depth deviation from the nominal geometry (the reference
    # prototype's cardinals sit ~8% off the hinted radius in raw_markers.png).
    ring_tolerance: float = 0.09
    camera_distance_hint_mm: float = 40.0  # nominal camera-to-apex distance for
    # perspective-corrected expected ring radii (exact value uncritical).


@dataclass(frozen=True)
class ReconstructConfig:
    """Monocular depth-from-diameter 3D reconstruction (reference C12)."""
    marker_diameter_mm: float = 2.0      # 3d_reconstruction.py:21
    warmup_frames: int = 100             # :22 (frames skipped after the first seen)
    min_marker_size_px: float = 5.0      # :23 major-axis filter
    max_step_displacement_mm: float = 50.0  # :24 gate; ref names it *_px (quirk 8), value kept
    undistort_iters: int = 5             # cv2.undistortPoints default iteration count
    # Divide measured diameters by the local distortion magnification
    # (sqrt|det J|) before depth-from-diameter. The reference skips this
    # (it undistorts centers only), biasing off-center depths under barrel
    # distortion; disable for strict reference parity.
    distortion_corrected_diameter: bool = True
    # Drop observations whose ellipse major/minor exceeds this (None
    # disables). Partial occlusion leaves a well-formed but badly biased
    # moment ellipse that passes every reference gate (a half-disk measures
    # ratio ~1.9 and fabricated a 13.9 mm phantom displacement in testing);
    # legitimate dome markers stay below ~1.4 under compression + tilt.
    max_axis_ratio: float | None = 1.6


@dataclass(frozen=True)
class CalibrateConfig:
    """Intrinsic (Zhang) + extrinsic (PnP) calibration (reference C10+C11)."""
    pattern_size: Tuple[int, int] = (6, 6)   # inner corners (intrinsic_calibration.py:190)
    square_size_mm: float = 3.0              # :191
    min_images: int = 3                      # :92
    refine_iters: int = 30                   # LM refinement iterations
    ransac_iterations: int = 1000            # extrinsic_calibration.py:105
    ransac_reproj_threshold_px: float = 8.0  # :104
    # Requested probability of at least one all-inlier RANSAC sample (:103).
    # The TPU solver runs a fixed hypothesis batch (no adaptive early exit),
    # so this is enforced post-hoc: solve_pnp_ransac reports the achieved
    # confidence and warns when it falls below this value.
    ransac_confidence: float = 0.99
    pnp_refine_iters: int = 20               # iterative PnP Gauss-Newton steps


@dataclass(frozen=True)
class AnalysisConfig:
    """Force-distribution / pose-misalignment analysis (reference C14-C18)."""
    deviation_scale: float = 1.0             # ForceDistribution.py:14
    ring2_marker_ids: Tuple[int, ...] = tuple(range(8, 20))  # LocalAnalysis.py:11
    start_frame_range: Tuple[int, int] = (1, 30)    # LocalAnalysis.py:14
    end_frame_range: Tuple[int, int] = (120, 150)   # LocalAnalysis.py:15
    # IRLS (Tukey) contact-plane fit: outlier markers (merged blobs,
    # occlusion-completed detections) are downweighted instead of levering
    # the tilt. False reproduces the reference's plain lstsq
    # (ForceDistribution.py:144) exactly.
    robust_plane_fit: bool = True


@dataclass(frozen=True)
class CaptureConfig:
    """Acquisition server (reference C1-C3, collecting.py:27-37)."""
    camera_index: int = 0
    width: int = 640
    height: int = 480
    fps: int = 12
    port: int = 8081
    skip_frames: int = 1
    jpeg_quality: int = 70
    led_count: int = 12
    led_pin: int = 18
    led_brightness: int = 20


@dataclass(frozen=True)
class PipelineConfig:
    """Whole-pipeline configuration."""
    detect: DetectConfig = field(default_factory=DetectConfig)
    track: TrackConfig = field(default_factory=TrackConfig)
    reconstruct: ReconstructConfig = field(default_factory=ReconstructConfig)
    calibrate: CalibrateConfig = field(default_factory=CalibrateConfig)
    analysis: AnalysisConfig = field(default_factory=AnalysisConfig)
    capture: CaptureConfig = field(default_factory=CaptureConfig)
    crop_ratios: Tuple[float, float, float, float] = (1 / 8, 1 / 8, 1 / 16, 0.0)
    # Undistort frames (after crop, before detection) when a calibrated
    # camera is available — the reference's optional preprocess
    # (marker_detection.py:88-109). The pipeline then detects on rectified
    # frames and reconstructs with the matching zero-distortion pinhole
    # camera (pipeline.prepare_undistortion).
    undistort_frames: bool = False
    max_markers: int = 65
    dtype: str = "float32"

    def detect_profile(self, height: int) -> DetectProfile:
        if height <= self.detect.low_res_max_rows:
            return self.detect.low_res
        return self.detect.high_res


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def _from_jsonable(cls: type, data: Any) -> Any:
    if dataclasses.is_dataclass(cls) and isinstance(data, dict):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in data:
                continue
            val = data[f.name]
            # Recurse into nested dataclasses based on the default INSTANCE,
            # overlaying only the present keys: rebuilding from the class
            # would silently reset e.g. a partially-overridden
            # detect.high_res to DetectProfile's low-res class defaults.
            proto = getattr(cls(), f.name)
            if dataclasses.is_dataclass(proto):
                sub = _from_jsonable(type(proto), val)
                present = set(val.keys()) if isinstance(val, dict) else None
                if present is not None:
                    sub = dataclasses.replace(
                        proto, **{g.name: getattr(sub, g.name)
                                  for g in dataclasses.fields(type(proto))
                                  if g.name in present})
                kwargs[f.name] = sub
            elif isinstance(proto, tuple):
                kwargs[f.name] = tuple(val)
            else:
                kwargs[f.name] = val
        return cls(**kwargs)
    return data


