#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vision_basedsensor_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py [--out FILE] [--profile]
    python3 chip_smoke.py --only fields [--baseline FIELDS_CU ...] [--out FILE]
    python3 chip_smoke.py --only expand [--baseline EXPAND_CU ...] [--out FILE]
    python3 chip_smoke.py --only window_sums [--baseline WS_CU ...] [--out FILE]
    python3 chip_smoke.py --only gather [--baseline GATHER_CU ...]
                          [--probe CUT_CU ...] [--out FILE]
    python3 chip_smoke.py --only scans [--baseline SCAN_OR_ASSOCIATE_CU ...]
                          [--probe CUT_CU ...] [--out FILE]
    python3 chip_smoke.py --only multi [--out FILE]

``--only fields`` runs phases 1-2 and then the fields kernel alone: it
checks the kernel against ``fused_fields_reference`` (exact equality) at
4x437x467 and on the ncc/area/gray of rendered frames at each shape of
ONLY_FIELDS (1024x480x640, 64x480x640, 48x1080x1920) without running the
pipeline, and times each shape with CUDA events beside its bound. Each
``--baseline`` (repeatable) is another version of ``csrc/fields.cu`` with the
same C entry (e.g. the output of
``git show <rev>:vision_basedsensor_tpu_torch/csrc/fields.cu``), built into a
library of its own, checked the same way and timed in turns with the
current kernel on the same inputs (the baselines, the current kernel twice,
the baselines in reverse order). It ends with the same two JSON lines as
the full run; no main path runs, so each record's "launches" is 0.

``--only expand`` does the same for the sorted-expand kernel (K8,
``csrc/expand_sorted.cu``) on the ingest's first TDELTA batch (INGEST's
batch of 640x480 q70 frames, rendered and encoded as phase 7 does): each
version int16-equal to ``expand_sorted_reference``, timed in turns, beside
the plain version, ``index_put_`` and two probes of the first design's
halves (``csrc/expand_probes.cu``: its stores alone, its searches and adds
alone), PyTorch's ``zero_`` of the same output (the write rate the card
reaches for it), and the entries' spread over the output tiles.

``--only window_sums`` does the same for the window-sums kernel (K5, and
K6/K7 in its packed mode, ``csrc/window_sums.cu``): each version checked
against the plain version (slots 21-23 bit-equal, the rest within rtol 1e-5,
atol 2e-2, the max error of each slot printed) at 4x437x467 on the unfused
branch's inputs, then checked and timed at each shape of ONLY_WS on rendered
frames: the unfused branch's band, opened area, gray and peaks at 48x1080x1920
K=96, and the packed field and cell peaks of the fused branch at 1024x480x640
K=96. Every version is timed on its C entry with the wrapper's prepared
arguments, beside the plain version, the wrapper, the bound and the gated
pixel visits against the distinct gated pixels; at the unfused shape also
three probes of the first design (``csrc/window_sums_probes.cu``: its gated
loads alone, its float32-accumulator twin, and it without the end
reduction).

``--only gather`` does the same for the window-gather kernel (K3 pack=2, K4
pack=1, ``csrc/gather.cu``): each version equal (``torch.equal``, on an
output filled with NaN first) to ``gather_windows_reference`` for both packs
at 4x437x467 (W % 4 != 0), then checked and timed at each shape of
ONLY_GATHER on the main path's own inputs (rendered frames through the DoG,
NCC, the fields kernel and ``select_peaks_from_cells``). Every version is
timed on its C entry with the wrapper's prepared origins, in GATHER_ROUNDS
rounds of turns (min/median/max), beside the bound, the plain version, the
wrapper, ``torch.gather`` on the plain version's precomputed index (the
library yardstick: equal to the kernel on in-image lanes, clamped to the
last column elsewhere), PyTorch's ``zero_`` of the same output (the write
rate the card reaches for these bytes) and two probes of the first design
(``csrc/gather_probes.cu``: its stores alone, its loads alone; timed, not
checked); ``--probe`` adds other sources with the ``vbs_gather_windows``
entry, timed but not checked.

``--only scans`` does the same for the two scan kernels (the displacement
scan, ``csrc/displacement_scan.cu``, and the sequential association,
``csrc/associate.cu``) on the main path's own inputs: 1024 rendered
640x480 frames through ``process_frames`` give the positions and the
detections (K=96; the first 64 frames again at K=97). Each version (a
``--baseline`` goes to the scan or the association by the C entry it
defines) is checked against its plain version at every shape of ONLY_SCAN
(frames x 65 markers) and ONLY_ASSOC (frames x 65 slots x K), and at 1024
frames resumed from the plain first half's carry: the association
bit-equal, the scan's flags and copies bit-equal, norms within 1e-6 and
cum within 1e-5. Then every version and each ``--probe`` (a source with
either C entry, e.g. a design with a part cut out; timed, not checked) are
timed on the C entry with the wrapper's prepared arguments, each call's
return code checked, queued behind a sleeping kernel so the host's enqueue
does not pace the card, in SCAN_ROUNDS rounds of turns (min/median/max),
each beside its ns a frame, its dependency-chain floor, the bound and the
plain version; and at each shape the host time a call of every version's
``scan_args``/``assoc_args`` plus its C entry, and of the wrapper.

``--only multi`` runs phases 1-2 and then phases 11c and 11d alone (the
ingest's first MULTI_FEED JPEGs rendered and encoded as phase 7 does): on
a machine with several cards, the data-parallel step and the row-sharded
(spatial) meshes over all of them.

Phases of the full run (any failure raises, so the script exits non-zero
and prints no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc for sm_90a (one nvcc per
     source, started together);
  3. check each kernel against its plain PyTorch version on the card at the
     reference sensor's unaligned 437x467: fields, gather pack=1 and 2
     (exact equality), window sums (lo, hi and the count bit-equal, the
     rest within rtol 1e-5, atol 2e-2);
  4. drive the main path (initialize + process_frames) on rendered frames
     with a z drift, in the runs of RUNS: 640x480 B=1024 and 1080x1920 B=48
     on the fused branch, the same 1080x1920 frames on the unfused branch
     (backend "xla", the window-sums kernel), and 640x480 B=64 with an odd
     K=97 (the pack=1 gather). Each run: 65/65 markers in every frame,
     finite tilt, the drift's direction, exactly its branch's kernels
     launched (counts set to 0 just before, read just after); the same run
     with the kernels' plain versions (identical detections on the fused
     branch; the reference's xla-vs-pallas tolerances on the unfused one,
     which is also held against the fused run's detections); each of the
     run's kernels against its plain version on the run's own inputs, timed
     with CUDA events; pipeline fps, kernel path and plain path in turns
     (the plain path also takes the two scans' plain Python loops); every
     run launches the displacement-scan kernel once. The 640x480 B=1024
     run also profiles one batch (kernel launches per batch) and holds the
     scan kernel against its plain version on the run's own positions: all
     frames, the second half resumed from the first half's carry, and zero
     frames with a carry; timed beside its bound, with its dependency-chain
     floor printed as text (steps x dependent instructions a step, counted
     from the source, x DEP_CYCLES at the card's top SM clock; the
     association kernel's too, in phase 6). Its frames then run again with
     DetectConfig(fast_filters=True) (the DoG and NCC filter GEMMs in
     bfloat16 with float32 accumulation): exactly the fused branch's
     kernels, 65/65 markers in every frame, the drift's direction, each
     float32 detection's nearest bf16 detection (largest and 99th
     percentile printed; the rest frame within the reference's 0.01 px),
     the DoG mask pixels that differ from the float32 mask, the H pass
     rounded to bfloat16 and the W pass's float32 output; fps both ways in
     turns (median of four), the filter stage's device time both ways and,
     under --profile, its GEMMs' device time;
  5. the packed-field window sums (the reference's window_sums_packed and
     fused gather_moments) on the 640x480 B=1024 run's packed field and
     peaks: against the plain version, and timed against the split path the
     detector runs (paired gather + raw-moment basis sums);
  6. the streaming run: 1024 rendered 640x480 frames through a distorted
     camera with undistort_frames=True and sequential association, as
     StreamingPipeline chunks of 64 against one batch (prepare_undistortion
     + initialize + process_frames): equal validity, axes and displacement
     paths within 1e-4, >= 50 markers in every frame; chunked and batch fps;
     one scan and one association launch per chunk; the association kernel
     against its plain version on the batch's own detections (all frames,
     resumed from a carry, zero frames), timed beside its bound;
  7. the production MJPEG ingest (bench.py:122-159,250-261), as INGEST says:
     640x480 frames rendered with the -0.002 mm/frame drift restarting
     every 256 frames, encoded at q70 with the port's own JPEG encoder and
     muxed into an .avi. Checks: the sorted-expand kernel against its plain
     version on a TDELTA batch's own streams (int16 equal); every transport's
     frames bitwise equal to the dense transport's; TDELTA frames within one
     gray level of the CPU decode of the same payload; each payload's bytes
     equal to its stats; StreamingPipeline.run over MjpegAviCudaSource equal
     to StreamingPipeline.process over the same decoded frames in the same
     chunks, with exactly the ingest's kernels launched and 65/65 markers in
     every frame. Numbers: decode-only fps per transport, decode-fed fps of
     run against process on the decoded frames (median of three passes in
     turns), the host entropy decode's ms per frame and the device decode's
     stages;
  8. the replay CLI (cli/main.py, called in-process) on phase 7's .avi at
     CLI_CHUNK: track --tpu-decode byte-equal to write_tracking_csv of
     StreamingPipeline.run over MjpegAviCudaSource on the same file, 65/65
     markers in every frame; track on the decoded frames saved as .npy
     byte-equal to StreamingPipeline.process over them in the same chunks;
     reconstruct --no-warmup byte-equal to write_coords_table of
     reconstruct_sequence on read_tracking_csv's arrays; detect on the
     first frame, 65 markers. Each command runs with the counts set to 0
     just before and read just after, and launches exactly its kernels
     (track --tpu-decode: fields, gather, expand, scan; track .npy: fields,
     gather, scan; reconstruct: scan; detect: fields, gather). Numbers:
     track --tpu-decode's frames/s beside run's on the same file (two each,
     in turns) and the seconds of writing markers.csv.
  9. the pose-compensation commands (cli/main.py, in-process, each with
     its launches counted alone) at 640x480: tilt on a vertical and a
     POSE_TILT tilted compression (two rendered frames each, as .npy),
     within POSE_TILT's bound of the angle with 65 common markers (fields,
     gather, scan); analyze on the TXTs tilt wrote, the same tilt line, no
     kernel; indent on a POSE_STAIRS staircase with sequential association,
     65 markers at every step and the worst single-step error beside the
     reference's 0.04-0.18 mm (fields, gather, scan, associate); a localhost
     MJPEG server of the ingest's first LIVE[0] JPEGs: record byte-equal to
     them (no kernel), run-live --tpu-decode --publish 0 --resume at
     --batch LIVE[1] with each chunk's outputs equal to
     StreamingPipeline.process over MjpegBatchDecoder's TDELTA frames of
     the same chunk, its printed lines equal to process()'s, /state read
     over HTTP after each update equal to that chunk's payload, no frame
     dropped, and the saved session reloading with the frame count (expand,
     fields, gather, scan). Then the cost of one request (bench.py:280-333):
     host uint8 frames -> the card -> process_frames -> the last frame's
     tilt on the host, at each batch of REQUEST, a distinct window of
     frames each request, p50/p99 (nearest rank) and the slowest; B = 1
     through the live transport (JPEG bytes -> entropy_decode_tdelta ->
     tdelta_to_device -> process_frames -> the tilt); one B = 1 request of
     each under torch.profiler (kernels on the device, busy share) and its
     launches. This is not run-live's frame-to-tilt latency, which adds
     the wait for a chunk's frames and device_feed's lookahead of one
     chunk.
 10. "calibrate" (cli/main.py in-process, each command's launches counted
     alone): synth --motion staircase and --motion wave --frames 60 at
     640x480, each .npy byte-equal to render_frames of the same
     displacements (no kernel); membrane_indentation_field(1.5) at 640x480
     through run_video (fields, gather, scan), held to
     tests/test_reconstruct.py:97-131's bounds; calibrate-intrinsics on
     CAL_VIEWS rendered 640x480 boards (6x6 inner corners, 3 mm) through
     CAL_K: used every image, K within 6 px, RMS < 0.3 px, the XLSX
     byte-equal to calibrate_from_images + save_intrinsics_xlsx under a
     fixed zip clock; calibrate-extrinsics on those intrinsics with the 65
     markers projected through PNP_POSE, 0.3 px noise and 7 outliers: the
     XLSX pose equal to solve_pnp_ransac's, the outliers rejected, rotation
     within 0.1 deg, T within 0.1 mm; diameter on a 1080x1920 photo of the
     board beside 65 2.0 mm disks at DIAMETER_PX_PER_MM: the scale within
     1%, the printed rows equal to measure_diameters, at least 10 valid
     markers, each a rendered disk (centre within 1 px) with a diameter
     within the method's bound (1.95 mm to 2.0 mm + 2 px), and at least 60
     valid with a 1024-candidate budget (the default budget of 96 is spent
     on tied plateau cells before the distance suppression).
 11. "serve, extras, multi-device": (a) the acquisition server
     (capture/server.py run_server, synthetic, the CLI's 640x480 at 12 fps,
     q70, port 0) consumed in-process: record SERVE[0] frames, each a
     640x480 JPEG that the native decoder reads (no kernel); run-live
     --tpu-decode --publish 0 over SERVE[1] frames at --batch SERVE[2],
     65/65 markers in every frame, a finite tilt, /state equal to the last
     chunk's payload, launches of exactly expand, fields, gather and scan;
     the capture thread's render and encode ms per frame and the interval
     between published frames beside the camera's 83 ms; the server's
     threads ended after stop(). (b) ellipse_from_moments, box_sum and
     normxcorr_gaussian(binary_input=False) on an EXTRAS_BATCH 640x480
     batch and contact_signal on phase 4's reconstruction, each on the card
     against the same call on the CPU within its stated tolerance, with no
     kernel launched; profile_to's trace of one batch holding the program's
     spans. (c) the data-parallel step
     (parallel/) over every visible card, or two shards in turn on one
     card: the MULTI_BATCH 640x480 frames against single-device
     process_frames (seen equal, world and cum_path within 1e-4,
     detections as sets), fields and gather once a shard and one scan, only
     the marker tables copied between shard and gather device (bytes
     printed); with_carry in two chunks; sequential association on phase
     6's undistorted stream; ShardedPackedFeed over the ingest's first
     MULTI_FEED JPEGs for tdelta, split and packed, bitwise equal to the
     single-device decode with the expand kernel launched once a decode
     call a shard; sharded fps beside single-device fps (median of four, in
     turns). (d) "spatial": the row-sharded meshes (parallel/spatial.py;
     on one card [cuda:0] * 2 at spatial=2 and [cuda:0] * 4 as 2 x 2, on
     several every card at spatial=2 and, with four, spatial=4): rendered
     1080x1920 B=48 frames on each mesh, 640x480 B=64 and ShardedPackedFeed
     (tdelta, split, packed) over 64 of the ingest's JPEGs on a mesh with a data axis of 2
     or more, each against process_frames with backend="xla" on the same
     card (seen equal, world and cum_path within 1e-4, detections as sets
     within 1e-2 px, 65/65 markers), the window-sums kernel once a row
     shard and the scan once, the feed bitwise equal to the one-card decode
     with the expand kernel as often a data group as one decode call; no synchronizing call in the row
     shards' detect; printed: the DoG-mask pixels that differ from the
     single-device mask, the halo bytes a shard against its own rows',
     fps both ways in turns, and the latency of one 1080x1920 frame (B=1,
     p50/p99 of 50 requests a variant, in turns) for process_frames, the
     step at spatial=1 and at spatial=s.
The line before the last is the kernels' JSON record (each kernel's bound:
the larger of its bytes over 3.35 TB/s and its float32 operations over 67
TFLOP/s, NVIDIA's H100 SXM data sheet); the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

# The main path's runs: (label, rows, cols, batch, max_candidates, backend).
# The first two are the reference's bench sizes (bench.py:99-119,476 and
# benchmarks/bench_highres.py); "xla" takes the detector's unfused branch on
# the frames of the run before it; the odd K takes the pack=1 gather.
RUNS = (("640x480", 480, 640, 1024, 96, "auto"),
        ("1080x1920", 1080, 1920, 48, 96, "auto"),
        ("1080x1920 unfused", 1080, 1920, 48, 96, "xla"),
        ("640x480 K=97", 480, 640, 64, 97, "auto"))
# The streaming run: frames, chunk size, lens distortion
# (tests/test_undistort.py:88).
STREAM = (1024, 64, (-0.18, 0.05, 0.0, 0.0, 0.0))
# The ingest run (bench.py:122-159): frames, batch, JPEG quality, and the
# period after which the rendered drift restarts (bench.py:153-154).
INGEST = (2048, 256, 70, 256)
# The CLI phase's --chunk: the CLI's default (cli/main.py), given explicitly.
CLI_CHUNK = 256
# The pose phase: the tilted compression's angle (deg) and depth (mm) of the
# reference's end-to-end tilt test (tests/test_cli.py:188-216) and the bound
# it is held to (README.md:217-219); the staircase's steps and depth (mm,
# README.md:103-121); the live loop's frames and --batch (frames at most the
# stream reader's max(2 * batch, 8), so none can be dropped); the cost of a
# request: batch sizes and requests each (bench.py:280-333; 200, so that the
# nearest-rank p99 is the 198th of 200 and not the slowest).
POSE_TILT = (15.0, 1.0, 0.5)
POSE_STAIRS = (12, 0.7)
LIVE = (64, 32)
REQUEST = ((1, 8, 32), 200)
# Phase 10, the calibration commands at their users' sizes: 20 chessboards
# of 6x6 inner corners and 3 mm squares (intrinsic_calibration.py:190-191)
# imaged at 640x480 through CAL_K; the extrinsic solve's 65 markers with
# 0.3 px of noise and 7 of them (10%) moved by 20-40 px; the diameter photo:
# 1080x1920, the same board beside 65 dark 2.0 mm disks at 15 px/mm.
CAL_VIEWS, CAL_SQUARE_MM = 20, 3.0
CAL_K = ((600.0, 0.0, 322.0), (0.0, 590.0, 238.0), (0.0, 0.0, 1.0))
PNP_POSE = ((0.12, -0.2, 0.05), (1.5, -2.0, 42.0))
DIAMETER_PX_PER_MM = 15.0
# Phase 11, serve, extras and multi-device: the frames record takes and
# run-live reads from the acquisition server, and run-live's --batch; the
# extras' batch (640x480); the data-parallel run's batch (phase 4's 640x480
# B=1024) and the JPEGs ShardedPackedFeed decodes (one drift period of the
# ingest).
SERVE = (32, 64, 32)
EXTRAS_BATCH = 64
MULTI_BATCH = 1024
MULTI_FEED = 256
# Phase 11d (spatial): the 1080x1920 and 640x480 batches, the feed's JPEGs
# and the B=1 requests a variant (twice, in turns).
SPATIAL_HIGH = 48
SPATIAL_LOW = 64
SPATIAL_FEED = 64
SPATIAL_REQUESTS = 25
# --only fields: (rows, cols, batches), each batch the first frames of one
# render, so the 64-frame inputs are the first 64 of the 1024.
ONLY_FIELDS = ((480, 640, (1024, 64)), (1080, 1920, (48,)))
# --only window_sums: (rows, cols, batch, max_candidates, packed field). The
# first is the unfused 1080x1920 run's K5 call; the second the packed mode
# (K6/K7) on the 640x480 B=1024 run's packed field and peaks.
ONLY_WS = ((1080, 1920, 48, 96, False), (480, 640, 1024, 96, True))
# --only gather: (rows, cols, batch, max_candidates, pack), the main path's
# gather calls: K4 in the odd-K run, K3 in the 1080x1920 and 640x480 B=1024
# runs. GATHER_ROUNDS rounds of turns time each version.
ONLY_GATHER = ((480, 640, 64, 97, 1), (1080, 1920, 48, 96, 2),
               (480, 640, 1024, 96, 2))
GATHER_ROUNDS = 3
# --only scans: the displacement scan's batches (x 65 markers): the flagship
# batch, the stream's chunk, the 1080x1920 batch, run-live's --batch, 16,
# indent's 13 frames, 8 and 4, tilt's 2, one request; the association's
# (batch, max_candidates): the batch, the stream's chunk, run-live's
# --batch, the odd K. SCAN_ROUNDS rounds of turns.
ONLY_SCAN = (1024, 64, 48, 32, 16, 13, 8, 4, 2, 1)
ONLY_ASSOC = ((1024, 96), (64, 96), (32, 96), (64, 97))
SCAN_ROUNDS = 3
# The full run's short scan cases, resumed from a carry: one frame, and the
# two sides of csrc/displacement_scan.cu's SMALL_B (the walking kernel up
# to it, the tiled one above).
SCAN_SHORT = (1, 8, 9)
# Window-sum slots that kernel and plain version give bit-equal: lo, hi and
# the count of gated pixels.
WS_EXACT_SLOTS = (21, 22, 23)

# cuBLAS's and CUTLASS's GEMM kernels by name (the profiler's kernel names).
GEMM_KERNEL = re.compile(r"gemm|nvjet|xmma|cutlass", re.IGNORECASE)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet, 700 W
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores, same source
SRC = {
    "fields": ("vision_basedsensor_tpu_torch/csrc/fields.cu",
               "vision_basedsensor_tpu/ops/pallas/fields.py:225",
               "vision_basedsensor_tpu/ops/pallas/fields.py:292"),
    "gather": ("vision_basedsensor_tpu_torch/csrc/gather.cu",
               "vision_basedsensor_tpu/ops/pallas/moments.py:429",
               "vision_basedsensor_tpu/ops/pallas/moments.py:358"),
    "window_sums": ("vision_basedsensor_tpu_torch/csrc/window_sums.cu",
                    "vision_basedsensor_tpu/ops/pallas/moments.py:439",
                    "vision_basedsensor_tpu/ops/pallas/moments.py:232",
                    "benchmarks/gather_moments_kernel.py:152"),
    "expand": ("vision_basedsensor_tpu_torch/csrc/expand_sorted.cu",
               "benchmarks/scatter_onehot_kernel.py:93"),
    "scan": ("vision_basedsensor_tpu_torch/csrc/displacement_scan.cu",
             "vision_basedsensor_tpu/reconstruct/displacement.py:82"),
    "associate": ("vision_basedsensor_tpu_torch/csrc/associate.cu",
                  "vision_basedsensor_tpu/track/associate.py:111"),
    "filters": ("vision_basedsensor_tpu_torch/csrc/filters.cu",
                "vision_basedsensor_tpu/core/imaging.py:104"),
}
# The smallest batch at which cuBLAS sums the filter GEMMs unsplit, as the
# stencil kernels do (measured on the H100): frames of up to 480 rows, and
# taller. Below it the GEMM path's NCC differs in its last bits (up to
# 5.9e-6 at 4 x 480x640), so the plain path runs on the frames repeated.
UNSPLIT_BATCH = (512, 2)
EXPAND_PROBES = "vision_basedsensor_tpu_torch/csrc/expand_probes.cu"
WS_PROBES = "vision_basedsensor_tpu_torch/csrc/window_sums_probes.cu"
GATHER_PROBES = "vision_basedsensor_tpu_torch/csrc/gather_probes.cu"
# The two scans' dependency chains: the dependent instructions of one step
# on the path from its carry to the next step's carry, counted by reading
# the sources (not checked against SASS: recount them when a source
# changes), so the floor is printed, never recorded. Each is charged
# DEP_CYCLES, the latency between dependent instructions on the SM's FP32
# and integer pipes; sqrt's MUFU, shared loads, shuffles and the barrier
# take longer, so steps x chain x DEP_CYCLES at the card's top SM clock is
# a floor (PERF.md §6).
DEP_CYCLES = 4
# csrc/displacement_scan.cu: one instruction stands between a frame's carry
# and the next frame's, the walk's add `cum = cum + dnz` (the dnz loads are
# off the chain, the next 16 issued while 16 are added). `last` and `first`
# are no carry there: each frame finds its sightings in the tile's mask
# words, in parallel over frames; the tile's staging and mask words come
# before the walk, once a tile (1024 frames), and the per-frame work runs
# beside it, a chunk of 128 frames ahead.
SCAN_CHAIN = 1
# csrc/associate.cu's LANES: lanes a slot, whatever the slot count.
ASSOC_LANES = 4


def _assoc_chain(valid_counts) -> float:
    """csrc/associate.cu (its fast path), a frame's dependent instructions,
    the mean over frames with ``valid_counts`` valid detections each (the
    walk reads only those): the first candidate's squared distance from
    the carry (a subtraction, a product, the sum) 3; the lane's compare
    chain over ceil(count / ASSOC_LANES) candidates, 2 each (the compare,
    the select of the least square); log2(ASSOC_LANES) shuffle rounds of
    (shuffle, 64-bit compare in 2, select) 4 each; the tie test (a product, a
    compare, a vote) 3; the pick's staged position, the root of the least
    square (4) and the key's pack (2) 7; the atomicMin's load and CAS, the
    barrier, the owner's load and compare 5; the carry's select 1."""
    lanes = ASSOC_LANES
    per = [19 + 4 * int(math.log2(lanes)) + 2 * -(-int(c) // lanes)
           for c in valid_counts]
    return sum(per) / max(len(per), 1)


def scan_bound(b: int, n: int) -> tuple[float, str]:
    """The displacement scan's bound: world and seen read (13 B a
    marker-frame), the six outputs written (37 B), the carry written (30 B
    a marker); 3 subtractions and a 6-op norm twice, a compare and an add
    (20 operations) a marker-frame."""
    return _bound(b * n * (13 + 37) + 30 * n, 20 * b * n)


def assoc_bound(b: int, n: int, k: int) -> tuple[float, str]:
    """The association's bound: the detections read (xy 8, axes 8, angle 4,
    valid 1 B), the table (9 B a slot), the outputs written (21 B a
    slot-frame) and the carry (8 B a slot); 7 operations a (slot,
    detection) for the distance and its compare, 1 a slot pair for the
    owner test, a frame."""
    return _bound(b * k * 21 + n * 9 + b * n * 21 + 8 * n,
                  b * (7 * n * k + n * n))


# The 640x480 B=1024 batch before the scans ran on the card (PERF.md §5,
# NVIDIA H100 80GB HBM3, 700.00 W): displacement_scan's stage time in two
# calls, and kernel launches per batch.
BEFORE_SCAN_KERNEL = {"displacement_scan_ms": "219-307", "launches": 21682}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _chain_note(steps: int, chain: int) -> str:
    """The printed dependency-chain floor of a scan: steps x chain x
    DEP_CYCLES at the card's top SM clock (nvidia-smi clocks.max.sm). Text
    only, never a record: the chain is counted from the source, not
    measured. Where nvidia-smi gives no clock, says so."""
    out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    try:
        mhz = float(out.stdout.strip())
    except ValueError:
        return f"dependency chain not computed (clocks.max.sm {out.stdout!r})"
    ms = 1e-3 * steps * chain * DEP_CYCLES / mhz
    return (f"dependency chain {steps} steps x {chain:g} x {DEP_CYCLES} "
            f"cycles at {mhz:.0f} MHz = {ms:.5f} ms")


def _event_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls queued behind a
    sleeping kernel (100 us of SM cycles a call), so the host's enqueue
    does not pace the card: for kernels shorter than their launch's host
    cost. After one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _wall_s(fn, reps: int) -> list[float]:
    """Host-clock seconds of each of ``reps`` calls of ``fn()``, each ending
    in a synchronize."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _bound(nbytes: float, nops: float) -> tuple[float, str]:
    """Least time in ms for ``nbytes`` of memory traffic and ``nops`` float32
    operations, and which of the two bounds it."""
    t_b = 1e3 * nbytes / HBM_BYTES_PER_S
    t_o = 1e3 * nops / F32_OPS_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _distinct(b: int, h: int, w: int, ys, xs, keep) -> int:
    """Distinct in-image pixels ``(ys, xs)`` (broadcast to ``keep``'s
    shape, a leading frame axis) where ``keep`` holds."""
    import torch
    keep = keep & (xs < w) & (ys < h)
    flat = torch.where(keep, ys * w + xs, torch.full_like(keep, h * w,
                                                          dtype=torch.long))
    mask = torch.zeros((b, h * w + 1), dtype=torch.bool, device=keep.device)
    mask.scatter_(1, flat.reshape(b, -1), True)
    return int(mask[:, :h * w].sum())


def leaves(x, name):
    """(name, tensor) of every tensor in nested named tuples."""
    import torch
    if isinstance(x, torch.Tensor):
        yield name, x
    elif isinstance(x, tuple):
        for k, v in zip(x._fields, x):
            yield from leaves(v, f"{name}.{k}")


def _build_alt(src: str, entry: str, argtypes=None):
    """Build one CUDA source with a plain C interface (another version of a
    kernel, same C entry, or the K8 probes) into a library of its own;
    returns its function ``entry`` (argtypes: the library's signature of
    that name unless given)."""
    from vision_basedsensor_tpu_torch.ops.cuda import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = build.BUILD_DIR / f"alt_{tag}.{os.getpid()}.so"
    if not out.exists():
        log = build._run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                          str(out), os.path.abspath(src)])
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas ({os.path.basename(src)}): {line.strip()}")
    fn = getattr(ctypes.CDLL(str(out)), entry)
    fn.argtypes = list(argtypes or build._SIGNATURES[entry])
    fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def fixed_zip_clock():
    """Every zip member written inside is stamped 2024-01-02 03:04:05 (an
    XLSX file is a zip whose members carry their write time)."""
    import types
    import zipfile
    stamp = time.mktime((2024, 1, 2, 3, 4, 5, 0, 0, -1))
    saved = zipfile.time
    zipfile.time = types.SimpleNamespace(time=lambda: stamp,
                                         localtime=time.localtime)
    try:
        yield
    finally:
        zipfile.time = saved


def render_board(K, rvec, tvec, square_mm, n, h, w, device, ss=3):
    """A checkerboard of n x n squares (its inner corners (n-1) x (n-1))
    imaged through the pinhole camera K at pose (rvec, tvec), supersampled
    ss x ss: tests/test_undistort.py:129-144 in torch, as uint8 numpy."""
    import torch
    from vision_basedsensor_tpu_torch.core.transforms import rodrigues
    f64 = dict(dtype=torch.float64, device=device)
    R = rodrigues(torch.tensor(rvec, **f64))
    H = torch.tensor(K, **f64) @ torch.stack(
        [R[:, 0], R[:, 1], torch.tensor(tvec, **f64)], dim=1)
    ys = (torch.arange(h * ss, **f64) + 0.5) / ss - 0.5
    xs = (torch.arange(w * ss, **f64) + 0.5) / ss - 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    uvw = torch.linalg.inv(H) @ torch.stack([xx.ravel(), yy.ravel(),
                                             torch.ones_like(xx.ravel())])
    iu = torch.floor(uvw[0] / uvw[2] / square_mm).long().reshape(xx.shape)
    iv = torch.floor(uvw[1] / uvw[2] / square_mm).long().reshape(xx.shape)
    inside = (iu >= 0) & (iu < n) & (iv >= 0) & (iv < n)
    img = torch.where(inside & ((iu + iv) % 2 == 0), 30.0, 215.0)
    img = img.reshape(h, ss, w, ss).mean((1, 3))
    return torch.round(img).to(torch.uint8).cpu().numpy()


def render_diameter_photo(device, h=1080, w=1920, ss=4, seed=0):
    """The diameter-validation photo (DiameterValidation.py's scene): a 7 x 7
    -square board (6x6 inner corners) of CAL_SQUARE_MM squares beside 65 dark
    disks of 2.0 mm in a 13 x 5 grid, at DIAMETER_PX_PER_MM, supersampled;
    uint8 numpy and the disks' centres (x, y) in pixels."""
    import numpy as np
    import torch
    s = DIAMETER_PX_PER_MM
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=device)
    ys = (torch.arange(h * ss, **f64) + 0.5) / ss - 0.5
    xs = (torch.arange(w * ss, **f64) + 0.5) / ss - 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    sq = CAL_SQUARE_MM * s
    iu = torch.floor((xx - 120.0) / sq).long()
    iv = torch.floor((yy - 380.0) / sq).long()
    inside = (iu >= 0) & (iu < 7) & (iv >= 0) & (iv < 7)
    img = torch.where(inside & ((iu + iv) % 2 == 0), 30.0, 215.0)
    centres = np.stack([620.0 + (np.arange(65) % 13) * 95.0,
                        180.0 + (np.arange(65) // 13) * 150.0], -1)
    centres += rng.uniform(-0.5, 0.5, centres.shape)
    r = 1.0 * s
    for cx, cy in centres:
        x0, x1 = int((cx - r - 2) * ss), int((cx + r + 2) * ss)
        y0, y1 = int((cy - r - 2) * ss), int((cy + r + 2) * ss)
        d = torch.hypot(xx[y0:y1, x0:x1] - cx, yy[y0:y1, x0:x1] - cy)
        img[y0:y1, x0:x1] = torch.where(d <= r, 40.0, img[y0:y1, x0:x1])
    img = img.reshape(h, ss, w, ss).mean((1, 3))
    return torch.round(img).to(torch.uint8).cpu().numpy(), centres


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the records here")
    ap.add_argument("--profile", action="store_true",
                    help="profile one kernel-path batch per run and one "
                         "StreamingPipeline.run pass over the ingest's AVI "
                         "(torch.profiler): device time by kernel and the "
                         "device's busy share")
    ap.add_argument("--only", choices=("fields", "expand", "window_sums",
                                       "gather", "scans", "multi"),
                    default=None,
                    help="check and time only the fields kernel, the "
                         "sorted-expand kernel, the window-sums kernel, the "
                         "window-gather kernel or the two scan kernels, or "
                         "run only the data-parallel step and the spatial "
                         "meshes (phases 11c-d)")
    ap.add_argument("--baseline", action="append", default=None,
                    help="with --only: another version of that kernel's "
                         "source to check and time in turns with the current "
                         "kernel (repeatable)")
    ap.add_argument("--probe", action="append", default=None,
                    help="with --only window_sums, gather or scans: a "
                         "source with that kernel's C entry that computes "
                         "something else (a cut of a design), timed in "
                         "turns but not checked (repeatable)")
    args = ap.parse_args(argv)
    if args.baseline and args.only in (None, "multi"):
        ap.error("--baseline needs --only fields, expand, window_sums, "
                 "gather or scans")
    if args.probe and args.only not in ("window_sums", "gather", "scans"):
        ap.error("--probe needs --only window_sums, gather or scans")

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vision_basedsensor_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from vision_basedsensor_tpu_torch.config import (PipelineConfig,
                                                     ReconstructConfig,
                                                     TrackConfig)
    from vision_basedsensor_tpu_torch.core.imaging import band_and_opening
    from vision_basedsensor_tpu_torch.detect import detector
    from vision_basedsensor_tpu_torch.ops import moments as tm
    from vision_basedsensor_tpu_torch.ops.cuda import (build, launch_counts,
                                                       reset_launch_counts)
    from vision_basedsensor_tpu_torch.ops.cuda import expand as kx
    from vision_basedsensor_tpu_torch.ops.cuda import fields as kf
    from vision_basedsensor_tpu_torch.ops.cuda import filters as kfil
    from vision_basedsensor_tpu_torch.ops.cuda import moments as kg
    from vision_basedsensor_tpu_torch.ops.cuda import scan as kscan
    from vision_basedsensor_tpu_torch.ops.cuda import window_sums as kw
    from vision_basedsensor_tpu_torch.ops import jpeg as tj
    from vision_basedsensor_tpu_torch.ops.dog import dog_area_mask
    from vision_basedsensor_tpu_torch.ops.expand import expand_sorted_reference
    from vision_basedsensor_tpu_torch.ops.ncc import normxcorr_gaussian
    from vision_basedsensor_tpu_torch.ops.patches import patch_origins
    from vision_basedsensor_tpu_torch.ops.peaks import (find_peaks,
                                                        select_peaks_from_cells)
    from vision_basedsensor_tpu_torch.parallel import spatial
    from vision_basedsensor_tpu_torch.pipeline import (StreamingPipeline,
                                                       initialize,
                                                       prepare_undistortion,
                                                       process_frames)
    from vision_basedsensor_tpu_torch.reconstruct.displacement import \
        displacement_scan_reference
    from vision_basedsensor_tpu_torch.synth import default_scene, render_frames
    from vision_basedsensor_tpu_torch.track.associate import \
        associate_sequential_reference

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = _card()
    print(card, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    records: dict = {"card": card, "phases": {}}

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s (nvcc {build.build_seconds}) -> "
          f"{build.library_path().name} [{card}]", flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    records["build_s"] = build_s

    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))
    dcfg = cfg.detect

    def profile_of(h):
        return dcfg.low_res if h <= dcfg.low_res_max_rows else dcfg.high_res

    def fields_inputs(frames, prof):
        gray = frames.float().contiguous()
        area = dog_area_mask(gray, prof, dcfg.dog_offset).float()
        ncc = normxcorr_gaussian(area, prof.template_size,
                                 prof.template_sigma, binary_input=True)
        return ncc, area, gray

    def unfused_inputs(ncc, area, prof, k):
        """The unfused branch's band, opened area and peaks
        (detect/detector.py)."""
        band, area_open = band_and_opening(ncc, area, dcfg.ncc_threshold,
                                           prof.band_window, dcfg.open_ksize)
        peaks = find_peaks(ncc, dcfg.ncc_threshold, prof.peak_window, k,
                           float(prof.peak_window))
        return band, area_open, peaks

    def fields_plain(ncc, area, gray, prof):
        return kf.fused_fields_reference(ncc, area, gray, dcfg.ncc_threshold,
                                         dcfg.open_ksize, prof)

    def fields_kernel(ncc, area, gray, prof):
        return kf.fused_fields(ncc, area, gray, dcfg.ncc_threshold,
                               dcfg.open_ksize, prof)

    def gather_plain(packed, peaks, prof, pack):
        start = kg._prep(packed.shape[1], packed.shape[2], peaks, prof)
        return (kg.gather_windows_reference(packed, start, prof.patch_size,
                                            pack), start)

    def max_err(got, want) -> float:
        err = 0.0
        for a, b in zip(got, want):
            if a.numel() == 0:
                continue
            a, b = a.double(), b.double()
            same = (a == b)  # equal infinities count as exact
            d = torch.where(same, torch.zeros_like(a), (a - b).abs())
            err = max(err, float(torch.nan_to_num(d, nan=float("inf")).max()))
        return err

    def check_fields(ncc, area, gray, prof, what):
        got = fields_kernel(ncc, area, gray, prof)
        want = fields_plain(ncc, area, gray, prof)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"fields kernel != plain at {what}: "
                                 f"max abs err {err}")
        print(f"check fields {what}: exact (max_abs_err {err})", flush=True)
        return got, err

    def check_gather(packed, peaks, prof, pack, what):
        got = kg.gather_windows(packed, peaks, None, prof, pack=pack)
        want = gather_plain(packed, peaks, prof, pack)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"gather pack={pack} kernel != plain at "
                                 f"{what}: max abs err {err}")
        print(f"check gather pack={pack} {what}: exact (max_abs_err {err})",
              flush=True)
        return err

    def sums_close(got, want, valid, what):
        """Window sums against the plain version on valid peaks: lo (slot
        21), hi (22) and the count of gated pixels (23) bit-equal, every
        other slot within the JAX tests' rtol 1e-5, atol 2e-2, with equal
        finite patterns. Prints the max abs error of each slot; returns the
        largest."""
        a, b = got[valid].double(), want[valid].double()
        for s in WS_EXACT_SLOTS:
            if not torch.equal(a[:, s], b[:, s]):
                raise AssertionError(
                    f"{what}: slot {s} not bit-equal to the plain version "
                    f"({int((a[:, s] != b[:, s]).sum())} peaks differ)")
        fin = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), fin):
            raise AssertionError(f"{what}: finite patterns differ")
        d = torch.where(fin, (a - b).abs(), torch.zeros_like(a))
        per_slot = (d.amax(0) if len(d) else torch.zeros(a.shape[1])).tolist()
        err = max(per_slot)
        if bool((d > 2e-2 + 1e-5 * torch.where(fin, b, 0.0).abs()).any()):
            raise AssertionError(f"{what}: kernel vs plain beyond rtol 1e-5 "
                                 f"atol 2e-2 (max abs err {err}; by slot "
                                 f"{per_slot})")
        big = float(torch.where(fin, b, 0.0).abs().max()) if len(b) else 0.0
        print(f"check {what}: slots 21-23 bit-equal, the rest within rtol "
              f"1e-5 atol 2e-2 on {len(b)} valid peaks (max abs err {err}, "
              f"largest |sum| {big}); max abs err by slot: "
              + " ".join(f"{s}:{e:.3g}" for s, e in enumerate(per_slot)),
              flush=True)
        return err

    def dets_close(a, b, what):
        """The reference's xla-vs-pallas detection tolerances
        (tests/test_pallas_moments.py:104-114)."""
        if not torch.equal(a.valid, b.valid):
            raise AssertionError(f"{what}: valid differs "
                                 f"({int((a.valid != b.valid).sum())} slots)")
        v = a.valid
        dxy = float((a.xy - b.xy)[v].abs().max())
        dax = float((a.axes - b.axes)[v].abs().max())
        print(f"{what}: valid equal, max |dxy| {dxy} px, max |daxes| {dax} "
              "px", flush=True)
        if dxy > 1e-3 or dax > 1e-2:
            raise AssertionError(f"{what}: xy {dxy} > 1e-3 or axes {dax} > "
                                 "1e-2 px")
        return dxy, dax

    def window_stats(peaks, geom, prof, h, w):
        """(gated pixel visits, distinct gated pixels) of the window sums."""
        start = patch_origins(h, w, peaks.xy, prof.patch_size)
        gx, gy, _, _, keep = tm.patch_cut(start.float(), peaks, geom, prof)
        n = _distinct(peaks.xy.shape[0], h, w, gy.long(), gx.long(), keep)
        return int(keep.sum()), n

    def sums_bound(stats, bk, prof, packed):
        """Least time of the window sums on a run's ``bk`` peaks, whose
        gated pixel visits and distinct gated pixels are ``stats``
        (``window_stats``).

        Bytes: the distinct gated pixels read once (12 B from the three
        fields, 4 B packed), each peak's xy (8 B) and geometry (36 B) read
        and its 28 sums written (112 B).
        Float32 operations, each shared product counted once:
          per patch row, 51 to find the row's gated run of columns (the cut
            is convex, so it meets a row in one run): 3 for the disk's ends,
            4 per halfplane, and the exact 18-op gate (dx, dy 2; d2 3; its
            test 1; 4 per halfplane) at both ends, so no other patch pixel
            needs a test;
          per gated pixel, 59: dx 1, lo/hi 2, weight 4 (sub, div, clamp),
            soft remap 4 (when soft_floor > 0), half level 1, 21 products
            (band 2, area 5, w 9, half level 5), 26 sums; plus 8 for the
            exact unpack in packed mode.
        A few operations per peak (contrast, rhs slack) are left out."""
        visits, distinct = stats
        nbytes = (4 if packed else 12) * distinct + bk * (8 + 36 + 4 * 28)
        per_px = (1 + 2 + 4 + (4 if prof.soft_floor > 0.0 else 0) + 1 + 21
                  + 26 + (8 if packed else 0))
        nops = 51 * bk * prof.patch_size + per_px * visits
        return _bound(nbytes, nops)

    def ws_entry(fields, peaks, geom, prof, what):
        """``call(fn, out)`` running one version ``fn`` of the window-sums C
        entry (same signature as ``vbs_window_sums``) on the wrapper's own
        prepared arguments into ``out``, and a fresh output. Timing the
        entry alone leaves out the wrapper's patch-origin ops."""
        out, cargs, temps = kw._prepare(fields, peaks, geom, prof, what)
        stream = torch.cuda.current_stream(dev).cuda_stream

        # The default argument keeps the tensors cargs points into alive.
        def call(fn, o=out, _alive=(fields, temps)):
            build.check(fn(*cargs[:6], o.data_ptr(), *cargs[7:], stream),
                        f"{what} launch")
            return o

        return call, out

    def gather_bound(start, prof, pack, h, w):
        """Bytes: the output tensor written and the distinct in-image
        window pixels read; a copy does no arithmetic."""
        b, k = start.shape[:2]
        p = prof.patch_size
        cols = 64 if pack == 2 else 128
        r = torch.arange(p, device=start.device)
        c = torch.arange(cols, device=start.device)
        ys = start[..., 1, None, None].long() + r[:, None]
        xs = start[..., 0, None, None].long() + c[None, :]
        keep = torch.ones((b, k, p, cols), dtype=torch.bool,
                          device=start.device)
        distinct = _distinct(b, h, w, ys, xs, keep)
        return _bound(b * (k // pack) * p * 128 * 4 + 4 * distinct, 0.0)

    def gather_entry(packed, peaks, prof, pack, what):
        """``(call, start, out)``: ``call(fn, out)`` runs one version ``fn``
        of the gather C entry (``vbs_gather_windows``'s signature) on the
        wrapper's prepared origins ``start`` into ``out``; ``out`` is a fresh
        output. Timing the entry alone leaves out the wrapper's patch-origin
        ops."""
        b, h, w = packed.shape
        k, p = peaks.xy.shape[-2], prof.patch_size
        start = kg._prep(h, w, peaks, prof)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(fn, out):
            build.check(fn(packed.data_ptr(), start.data_ptr(), out.data_ptr(),
                           b, h, w, k, p, pack, stream),
                        f"gather {what} pack={pack} launch")
            return out

        out = torch.empty((b, k // pack, p, 128), device=dev)
        return call, start, out

    def gather_library(packed, start, patch, pack):
        """``fn()`` running ``torch.gather`` on the plain version's
        precomputed index (the library yardstick): the kernel's values on
        in-image lanes, the last column's elsewhere; the same bytes
        written."""
        b, h, w = packed.shape
        flat = packed.reshape(b, h * w)
        idx = kg.gather_index(start, w, patch, pack)[0].flatten(1)
        return lambda: torch.gather(flat, 1, idx)

    def fields_bound(b, h, w, prof):
        """Bytes: ncc, area, gray read, packed written (16 B/px), the cells
        (8 B each); operations: the windowed min/max passes, counted as
        2 x (band + peak window) + 4 x open window + 8 per pixel."""
        hc, wc = -(-h // 8), -(-w // 8)
        ops_px = (2 * (prof.band_window + prof.peak_window)
                  + 4 * dcfg.open_ksize + 8)
        return _bound(b * h * w * 16 + b * hc * wc * 8, b * h * w * ops_px)

    def filters_bound(b, h, w, prof):
        """Operations: 2 a tap's multiply-add over the eight passes (both
        blurs, the NCC's Gaussian and box, each along H and W); bytes: 13 a
        pixel (the uint8 frame read; gray, area and ncc written, float32)."""
        taps = 2 * (prof.blur_small_ksize + prof.blur_large_ksize
                    + 2 * prof.template_size)
        return _bound(13 * b * h * w, 2 * taps * b * h * w)

    def unsplit(fn):
        """``fn``, a filter function's plain version, on its frames (and
        ``mean``) repeated to UNSPLIT_BATCH: the first B outputs, the bits
        the stencil kernels give."""
        def run(x, *args, **kw):
            b = x.shape[0]
            reps = -(-UNSPLIT_BATCH[int(x.shape[1] > dcfg.low_res_max_rows)]
                     // b)
            if reps > 1:
                def more(t):
                    return t.repeat(reps, *(1,) * (t.ndim - 1))
                x = more(x)
                kw = {k: None if v is None else more(v) for k, v in kw.items()}
            out = fn(x, *args, **kw)
            if isinstance(out, torch.Tensor):
                return out[:b]
            return tuple(None if t is None else t[:b] for t in out)
        return run

    @contextlib.contextmanager
    def plain_kernels():
        """Route the detector, the row shards' filters and the two scans
        through the kernels' plain versions (for the plain-path comparison
        on the card; the filters' at UNSPLIT_BATCH, so its times at a
        smaller batch include the repeated frames)."""
        saved = (detector.fused_fields, detector.gather_windows_paired,
                 detector.gather_windows, detector.window_sums,
                 detector.filter_fields, spatial.dog_fields,
                 spatial.binary_ncc, kscan.displacement_scan,
                 kscan.associate_sequential)

        def scan(world, seen, max_step, carry):
            rcfg = ReconstructConfig(max_step_displacement_mm=max_step)
            recon, final = displacement_scan_reference(world, seen, rcfg,
                                                       carry, True)
            return tuple(recon)[2:], final

        def assoc(ref, det, gate, carry_xy):
            t, last = associate_sequential_reference(ref, det, gate, carry_xy,
                                                     True)
            return (t.xy, t.axes, t.angle, t.valid), last

        def ff(ncc, area, gray, thr, open_k, prof):
            return kf.fused_fields_reference(ncc, area, gray, thr, open_k, prof)

        detector.fused_fields = ff
        detector.gather_windows_paired = (
            lambda packed, peaks, geom, prof: gather_plain(packed, peaks, prof, 2))
        detector.gather_windows = (
            lambda packed, peaks, geom, prof: gather_plain(packed, peaks, prof, 1))
        detector.window_sums = tm.window_sums_xla
        detector.filter_fields = unsplit(kfil.filter_fields_reference)
        spatial.dog_fields = unsplit(kfil.dog_fields_reference)
        spatial.binary_ncc = unsplit(kfil.binary_ncc_reference)
        kscan.displacement_scan = scan
        kscan.associate_sequential = assoc
        try:
            yield
        finally:
            (detector.fused_fields, detector.gather_windows_paired,
             detector.gather_windows, detector.window_sums,
             detector.filter_fields, spatial.dog_fields, spatial.binary_ncc,
             kscan.displacement_scan, kscan.associate_sequential) = saved

    def filters_phase(frames, prof, what):
        """The stencil kernels (``filter_fields``) on a run's own frames:
        two launches; gray, area and ncc bit for bit the GEMM path's (at
        UNSPLIT_BATCH); both timed behind a sleeping kernel and recorded,
        the GEMM path as the plain version and the library."""
        b, h, w = frames.shape
        before = kfil.filters_launches
        got = kfil.filter_fields(frames, prof, dcfg.dog_offset)
        launches = kfil.filters_launches - before
        want = unsplit(kfil.filter_fields_reference)(frames, prof,
                                                     dcfg.dog_offset)
        for name, g, r in zip(("gray", "area", "ncc"), got, want):
            if not torch.equal(g, r):
                raise AssertionError(
                    f"filters {what}: {name} differs from the GEMM path in "
                    f"{int((g != r).sum())} pixels")
        if launches != 2:
            raise AssertionError(f"filters {what}: {launches} launches, "
                                 "expected 2")
        del got, want
        n_it = 10 if b * h * w <= 2 ** 29 else 5
        ms = _device_ms(lambda: kfil.filter_fields(frames, prof,
                                                   dcfg.dog_offset), n_it)
        gemm_ms = _device_ms(lambda: kfil.filter_fields_reference(
            frames, prof, dcfg.dog_offset), n_it)
        bound = filters_bound(b, h, w, prof)
        torch.cuda.empty_cache()
        print(f"filters {what}: stencil kernels == GEMM path (gray, area, "
              f"ncc); {ms:.3f} ms vs GEMM path {gemm_ms:.3f} ms, bound "
              f"{bound[0]:.3f} ms ({bound[1]}), {100 * bound[0] / ms:.1f}% "
              f"of bound [{card}]", flush=True)
        record(f"stencil_kernel {what}", "filters", SRC["filters"][1],
               launches, 0.0, ms, gemm_ms, bound, gemm_ms)
        return {"ms": ms, "gemm_ms": gemm_ms, "bound": bound,
                "launches": launches}

    def render(h, w, batch, dist=None):
        scene = default_scene(h, w, dist=dist, device=dev)
        d = torch.zeros((batch, 65, 3), device=dev)
        d[:, :, 2] = -0.002 * torch.arange(batch, device=dev)[:, None]
        t = time.perf_counter()
        frames = render_frames(scene, d, chunk=64)
        torch.cuda.synchronize()
        print(f"render {batch}x{h}x{w}: {time.perf_counter() - t:.2f} s "
              f"[{card}]", flush=True)
        return scene, frames

    kernels = []

    def main_path(scene, frames, label, run_cfg, expect):
        """Counted run of the main path, checks, plain-path comparison and
        timings. ``expect`` names the kernels this branch launches. Returns
        the phase record and the run's outputs."""
        batch, h, w = frames.shape
        cam = scene.cam
        rec: dict = {"shape": [batch, h, w], "backend": run_cfg.detect.backend}
        # Warm-up (cuBLAS handles, allocator), not counted.
        ref = initialize(frames[0], run_cfg)
        process_frames(frames[:2], ref, cam, run_cfg)
        torch.cuda.synchronize()

        reset_launch_counts()
        t = time.perf_counter()
        ref = initialize(frames[0], run_cfg)
        out = process_frames(frames, ref, cam, run_cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        launches = launch_counts()
        rec["launches"] = launches
        print(f"{label}: main path ran in {first_s:.3f} s (first counted "
              f"run); launches {launches} [{card}]", flush=True)
        if (any((n > 0) != (k in expect) for k, n in launches.items())
                or launches["scan"] != 1):
            raise AssertionError(f"{label}: expected launches of exactly "
                                 f"{sorted(expect)} (one scan), got "
                                 f"{launches}")

        n_ref = int(ref.valid.sum())
        tracked = out.tracked.valid.sum(-1)
        tilt = out.contact.tilt_deg
        rec.update(ref_markers=n_ref, tracked_min=int(tracked.min()),
                   tracked_max=int(tracked.max()),
                   tilt_deg_last=float(tilt[-1]),
                   from_first_z_last_mm=float(
                       out.recon.from_first[-1, :, 2].mean()))
        print(f"{label}: reference markers {n_ref}; tracked per frame "
              f"min {int(tracked.min())} max {int(tracked.max())}; tilt "
              f"[{float(tilt.min()):.4f}, {float(tilt.max()):.4f}] deg; "
              f"mean dz at last frame {rec['from_first_z_last_mm']:.4f} mm",
              flush=True)
        if n_ref != 65 or int(tracked.min()) != 65:
            raise AssertionError(f"{label}: expected 65/65 markers in every "
                                 f"frame, got ref {n_ref}, tracked min "
                                 f"{int(tracked.min())}")
        if not bool(torch.isfinite(tilt).all()):
            raise AssertionError(f"{label}: non-finite tilt")
        for name in ("world", "from_first"):
            if not bool(torch.isfinite(getattr(out.recon, name)).all()):
                raise AssertionError(f"{label}: non-finite {name}")
        # The rendered drift is -0.002 mm/frame along z. At 640x480 the
        # depth-from-diameter reconstruction recovers it to ~1%; with the
        # high-res profile the JAX reference itself recovers only about a
        # third of a 0.094 mm step (-0.0342 mm on the same 1080x1920 frames,
        # as does the port), so there only the direction is checked.
        want_dz = -0.002 * (batch - 1)
        got_dz = rec["from_first_z_last_mm"]
        if h <= dcfg.low_res_max_rows:
            drift_ok = abs(got_dz - want_dz) <= 0.05 + 0.1 * abs(want_dz)
        else:
            drift_ok = got_dz < 0.0 or want_dz == 0.0
        if not drift_ok:
            raise AssertionError(f"{label}: last-frame mean dz {got_dz} mm "
                                 f"for a rendered {want_dz} mm")

        with plain_kernels():
            ref_p = initialize(frames[0], run_cfg)
            out_p = process_frames(frames, ref_p, cam, run_cfg)
            torch.cuda.synchronize()
        if "window_sums" in expect:
            # Sums in another order: not bit for bit.
            rec["kernel_vs_plain"] = dets_close(
                out.detections, out_p.detections,
                f"{label}: kernel path vs plain path")
        else:
            for name in out.detections._fields:
                a, b = getattr(out.detections, name), getattr(out_p.detections,
                                                              name)
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: detections.{name} differ "
                                         "between the kernel and plain paths")
            if not torch.equal(out.contact.tilt_deg, out_p.contact.tilt_deg):
                raise AssertionError(f"{label}: tilt differs kernel vs plain")
            print(f"{label}: kernel path == plain path (detections, tilt)",
                  flush=True)

        # Pipeline throughput: two batches per turn in the turns kernel,
        # plain, plain, kernel; fps is the batch over the median of a path's
        # four batch times.
        def run():
            process_frames(frames, ref, cam, run_cfg)

        def run_plain():
            with plain_kernels():
                process_frames(frames, ref, cam, run_cfg)

        s_k = _wall_s(run, 2)
        s_p = _wall_s(run_plain, 2)
        s_p += _wall_s(run_plain, 2)
        s_k += _wall_s(run, 2)
        fps_k = batch / statistics.median(s_k)
        fps_p = batch / statistics.median(s_p)
        rec.update(fps_kernel=fps_k, fps_plain=fps_p, s_kernel=s_k,
                   s_plain=s_p)
        print(f"{label}: pipeline fps kernel path {fps_k:.1f} (s "
              + ", ".join(f"{t:.4f}" for t in s_k) + f"), plain path "
              f"{fps_p:.1f} (s " + ", ".join(f"{t:.4f}" for t in s_p)
              + f") [{card}]", flush=True)

        # Stage breakdown of one kernel-path batch (host clock + sync).
        from vision_basedsensor_tpu_torch.analysis.force import \
            contact_state_sequence
        from vision_basedsensor_tpu_torch.reconstruct.depth import \
            reconstruct_positions
        from vision_basedsensor_tpu_torch.reconstruct.displacement import \
            displacement_scan
        from vision_basedsensor_tpu_torch.track.associate import associate
        det = out.detections
        stages = {
            "detect": lambda: detector.detect_markers(
                frames, run_cfg.detect, axis_scale=ref.axis_scale),
            "associate": lambda: associate(
                ref, det, run_cfg.track.min_marker_distance_px),
            "reconstruct_positions": lambda: reconstruct_positions(
                cam, out.tracked.xy, out.tracked.axes, out.tracked.valid,
                run_cfg.reconstruct),
            "displacement_scan": lambda: displacement_scan(
                out.recon.world, out.recon.seen, run_cfg.reconstruct),
            "contact_state": lambda: contact_state_sequence(
                out.recon, run_cfg.analysis),
        }
        rec["stages_ms"] = {k: 1e3 * statistics.median(_wall_s(fn, 2))
                            for k, fn in stages.items()}
        print(f"{label}: stages ms " + ", ".join(
            f"{k} {v:.2f}" for k, v in rec["stages_ms"].items())
            + f" [{card}]", flush=True)
        first = label == RUNS[0][0]
        if args.profile or first:
            rec["profile"] = profile_batch(run, label,
                                           statistics.median(s_k))
        if first:
            print(f"{label}: displacement_scan stage "
                  f"{rec['stages_ms']['displacement_scan']:.3f} ms and "
                  f"{rec['profile']['kernels']} kernel launches per batch; "
                  f"before the scan kernel (PERF.md §5, NVIDIA H100 80GB HBM3,"
                  f" 700.00 W): {BEFORE_SCAN_KERNEL['displacement_scan_ms']} "
                  f"ms and {BEFORE_SCAN_KERNEL['launches']:,} [{card}]",
                  flush=True)
        return rec, out

    def profile_batch(run, label, batch_s, host_top=0):
        """Device kernel time of one kernel-path batch by kernel name, and
        the device's busy share of the unprofiled batch time ``batch_s``;
        with ``host_top``, also that many host operators by their own
        (self) CPU time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
        busy, cur_end = 0.0, float("-inf")
        for a, b in sorted(spans):          # union of kernel intervals
            if b > cur_end:
                busy += b - max(a, cur_end)
                cur_end = b
        rows = sorted(((t, n, k) for k, (t, n) in by_name.items()),
                      reverse=True)
        print(f"{label}: profile: {len(spans)} kernels, device busy "
              f"{busy / 1e3:.2f} ms = {100 * busy / 1e6 / batch_s:.1f}% of the "
              f"unprofiled batch time {1e3 * batch_s:.2f} ms [{card}]",
              flush=True)
        for t, n, k in rows[:12]:
            print(f"  {t / 1e3:9.3f} ms {n:6d}x  {k[:90]}")
        gemm = sum(t for t, _, k in rows if GEMM_KERNEL.search(k))
        out = {"kernels": len(spans), "busy_ms": busy / 1e3,
               "batch_ms": 1e3 * batch_s, "gemm_ms": gemm / 1e3,
               "top": [[k, n, t / 1e3] for t, n, k in rows[:40]]}
        if host_top:
            ops = sorted(((e.self_cpu_time_total, e.count, e.key)
                          for e in prof.key_averages()), reverse=True)
            total = sum(t for t, _, _ in ops)
            print(f"{label}: host operators' own CPU time {total / 1e3:.2f} "
                  f"ms in {sum(n for _, n, _ in ops)} calls; the top "
                  f"{host_top}:")
            for t, n, k in ops[:host_top]:
                print(f"  {t / 1e3:9.3f} ms {n:6d}x  {k[:90]}")
            out["host_self_ms"] = total / 1e3
            out["host_top"] = [[k, n, t / 1e3] for t, n, k in ops[:host_top]]
        return out

    def fast_filters_phase(scene, frames, label, run_cfg, out32):
        """The batch of a fused run again with DetectConfig(fast_filters=True)
        (bfloat16 filter GEMMs, float32 accumulation): its launches, 65/65
        markers, the drift's direction, its detections against the float32
        run's (the rest frame within the reference's 0.01 px), the DoG mask
        pixels that differ from the float32 mask, the W pass's output dtype;
        fps both ways in turns and the filter stage's device time, the
        stencil kernels against the bfloat16 GEMMs (its GEMMs under
        --profile)."""
        from vision_basedsensor_tpu_torch.core.imaging import (_sep_filter,
                                                               gaussian_taps)
        batch, h, w = frames.shape
        cam = scene.cam
        bf16 = torch.bfloat16
        cfg16 = dataclasses.replace(run_cfg, detect=dataclasses.replace(
            run_cfg.detect, fast_filters=True))
        what = f"{label} fast_filters"
        rec: dict = {"shape": [batch, h, w]}
        ref16 = initialize(frames[0], cfg16)          # warm-up, not counted
        process_frames(frames[:2], ref16, cam, cfg16)
        torch.cuda.synchronize()
        reset_launch_counts()
        ref16 = initialize(frames[0], cfg16)
        out16 = process_frames(frames, ref16, cam, cfg16)
        torch.cuda.synchronize()
        launches = rec["launches"] = launch_counts()
        expect = {"fields", "gather", "scan"}
        if (any((n > 0) != (k in expect) for k, n in launches.items())
                or launches["scan"] != 1):
            raise AssertionError(f"{what}: expected launches of exactly "
                                 f"{sorted(expect)} (one scan), got "
                                 f"{launches}")
        n_ref = int(ref16.valid.sum())
        tracked = out16.tracked.valid.sum(-1)
        dz = float(out16.recon.from_first[-1, :, 2].mean())
        rec.update(ref_markers=n_ref, tracked_min=int(tracked.min()),
                   from_first_z_last_mm=dz)
        if n_ref != 65 or int(tracked.min()) != 65:
            raise AssertionError(f"{what}: expected 65/65 markers in every "
                                 f"frame, got ref {n_ref}, tracked min "
                                 f"{int(tracked.min())}")
        if not dz < 0.0:
            raise AssertionError(f"{what}: last-frame mean dz {dz} mm for a "
                                 "drift along -z")

        # Matched detections: each float32 detection to its nearest bf16
        # detection of the same frame.
        a, b = out32.detections, out16.detections
        d = torch.cdist(a.xy.double(), b.xy.double())
        d = torch.where(b.valid[:, None, :], d, torch.full_like(d, math.inf))
        nearest = d.amin(-1)
        per_det = nearest[a.valid]
        same_count = bool(torch.equal(a.valid.sum(-1), b.valid.sum(-1)))
        rest = float(nearest[0][a.valid[0]].max())
        rec.update(same_counts=same_count, max_px=float(per_det.max()),
                   p99_px=float(torch.quantile(per_det, 0.99)),
                   rest_frame_max_px=rest)
        print(f"{what}: launches {launches}; 65/65 markers in every frame, "
              f"mean dz at last frame {dz:.4f} mm; detections vs float32: "
              f"equal counts {same_count}, nearest distance max "
              f"{rec['max_px']:.6f} px, p99 {rec['p99_px']:.6f} px, rest frame "
              f"max {rest:.6f} px [{card}]", flush=True)
        if rest >= 0.01:
            raise AssertionError(f"{what}: rest frame {rest} px from the "
                                 "float32 detections (reference: < 0.01)")

        prof = profile_of(h)
        gray = frames.float()
        m32 = dog_area_mask(gray, prof, dcfg.dog_offset)
        m16 = dog_area_mask(gray, prof, dcfg.dog_offset, bf16)
        flips = int((m32 != m16).sum())
        rec.update(dog_flips=flips, dog_flip_share=flips / m32.numel())
        del m32, m16
        taps = gaussian_taps(prof.template_size, prof.template_sigma)
        w_dtype = _sep_filter(gray[:2], None, taps, "zero", bf16).dtype
        h_out = _sep_filter(gray[:2], taps, None, "zero", bf16)
        if w_dtype != torch.float32 or not torch.equal(
                h_out, h_out.bfloat16().float()):
            raise AssertionError(f"{what}: W pass gives {w_dtype}, H pass "
                                 "not bfloat16-rounded")
        print(f"{what}: DoG mask pixels differing from the float32 mask "
              f"{flips} of {gray.numel()} ({100 * flips / gray.numel():.5f}%);"
              f" H pass rounded to bfloat16, W pass output {w_dtype} "
              f"[{card}]", flush=True)

        ref32 = initialize(frames[0], run_cfg)

        def run32():
            process_frames(frames, ref32, cam, run_cfg)

        def run16():
            process_frames(frames, ref16, cam, cfg16)

        s32 = _wall_s(run32, 2)
        s16 = _wall_s(run16, 2)
        s16 += _wall_s(run16, 2)
        s32 += _wall_s(run32, 2)
        rec.update(fps_float32=batch / statistics.median(s32),
                   fps_fast=batch / statistics.median(s16), s_float32=s32,
                   s_fast=s16)

        def filters(fdt):
            return kfil.filter_fields(frames, prof, dcfg.dog_offset,
                                      compute_dtype=fdt)

        rec["filter_stage_ms"] = {"float32": _event_ms(lambda: filters(None),
                                                       3),
                                  "fast": _event_ms(lambda: filters(bf16), 3)}
        f_ms = rec["filter_stage_ms"]
        print(f"{what}: pipeline fps float32 filters "
              f"{rec['fps_float32']:.1f} (s " + ", ".join(
                  f"{t:.4f}" for t in s32) + f"), fast_filters "
              f"{rec['fps_fast']:.1f} (s " + ", ".join(f"{t:.4f}" for t in s16)
              + f"); filter stage (DoG + NCC) {f_ms['float32']:.2f} ms vs "
              f"{f_ms['fast']:.2f} ms [{card}]", flush=True)
        if args.profile:
            rec["filter_gemm_ms"] = {}
            for name, fdt in (("float32", None), ("fast", bf16)):
                p = profile_batch(lambda: filters(fdt),
                                  f"{what}: filter stage {name}",
                                  rec["filter_stage_ms"][name] / 1e3)
                rec["filter_gemm_ms"][name] = p["gemm_ms"]
            print(f"{what}: filter GEMMs' device time float32 "
                  f"{rec['filter_gemm_ms']['float32']:.3f} ms, bfloat16 "
                  f"{rec['filter_gemm_ms']['fast']:.3f} ms [{card}]",
                  flush=True)
        return rec

    def scan_check(got, gfin, want, wfin, what) -> float:
        """A scan version's outputs and final carry against the plain
        version's: flags and copied values bit-equal, norms within 1e-6,
        cum_path and cum within 1e-5. Returns the max abs error."""
        tol = {"step_norm": 1e-6, "from_first_norm": 1e-6, "cum_path": 1e-5,
               "cum": 1e-5}
        e = 0.0
        for k, a, w in [*zip(want._fields[2:], got, want[2:]),
                        *((k, gfin[k], wfin[k]) for k in gfin)]:
            d = max_err([a], [w]) if k in tol else 0.0
            if a.shape != w.shape or (d > tol[k] if k in tol
                                      else not torch.equal(a, w)):
                raise AssertionError(f"displacement_scan {what}: {k} differs "
                                     "from the plain version")
            e = max(e, d)
        return e

    def assoc_check(got, glast, want, wlast, what) -> None:
        """An association version's outputs and carry bit-equal to the plain
        version's."""
        for name, a, w in zip(("xy", "axes", "angle", "valid", "last"),
                              (*got, glast),
                              (want.xy, want.axes, want.angle, want.valid,
                               wlast)):
            if a.shape != w.shape or not torch.equal(a, w):
                raise AssertionError(f"associate_sequential {what}: {name} "
                                     "differs from the plain version")

    def scan_phase(world, seen, what, launches):
        """The displacement-scan kernel against its plain version on a
        run's own positions (all frames; the second half resumed from the
        plain first half's carry; zero frames with a carry; the first frame
        alone, and the short batches of SCAN_SHORT resumed, which take the
        walking kernel or the tiled one's smallest tile), then timed on its
        C entry (device time, the host's enqueue hidden)."""
        rcfg = cfg.reconstruct
        max_step = rcfg.max_step_displacement_mm
        b, n = seen.shape
        h = b // 2
        _, carry = displacement_scan_reference(world[:h], seen[:h], rcfg,
                                               None, True)
        cases = {"all frames": (world, seen, None),
                 "resumed": (world[h:], seen[h:], carry),
                 "zero frames": (world[:0], seen[:0], carry),
                 "first frame": (world[:1], seen[:1], None)}
        for m in SCAN_SHORT:
            cases[f"{m} frames resumed"] = (world[h:h + m], seen[h:h + m],
                                            carry)
        err = 0.0
        for case, (wx, sx, c) in cases.items():
            got, gfin = kscan.displacement_scan(wx.contiguous(),
                                                sx.contiguous(), max_step, c)
            want, wfin = displacement_scan_reference(wx, sx, rcfg, c, True)
            torch.cuda.synchronize()
            e = scan_check(got, gfin, want, wfin, f"{what} {case}")
            if c is not None and len(wx) == 0 and not all(
                    torch.equal(gfin[k], c[k]) for k in c):
                raise AssertionError(f"displacement_scan {what}: zero frames "
                                     "changed the carry")
            err = max(err, e)
            print(f"check displacement_scan {what} {case}: flags and copies "
                  f"equal, norms and cum_path within 1e-6/1e-5 (max abs err "
                  f"{e})", flush=True)
        prep = kscan.scan_args(world, seen, max_step, None)
        entry = build.library().vbs_displacement_scan
        stream = torch.cuda.current_stream().cuda_stream
        ms = _device_ms(lambda: build.check(entry(*prep[0], stream),
                                            "displacement_scan launch"), 50)
        plain_ms = _event_ms(lambda: displacement_scan_reference(
            world, seen, rcfg), 1)
        bound = scan_bound(b, n)
        print(f"displacement_scan {what}: kernel {ms:.4f} ms "
              f"({1e6 * ms / b:.1f} ns a frame), plain {plain_ms:.3f} ms, "
              f"bound {bound[0]:.5f} ms ({bound[1]}); "
              f"{_chain_note(b, SCAN_CHAIN)} [{card}]", flush=True)
        record(f"displacement_scan {what}", "scan", SRC["scan"][1], launches,
               err, ms, plain_ms, bound)
        return {"ms": ms, "plain_ms": plain_ms, "bound": bound,
                "max_abs_err": err}

    def assoc_phase(ref, det, gate, what, launches):
        """The association kernel against its plain version on a run's own
        detections (all frames; the second half resumed from the plain
        first half's carry; zero frames with a carry), then timed on its C
        entry (device time, the host's enqueue hidden)."""
        b, k = det.valid.shape
        n = ref.xy.shape[0]
        half = type(det)(*(x[:b // 2] for x in det[:5]))
        rest = type(det)(*(x[b // 2:].contiguous() for x in det[:5]))
        none = type(det)(*(x[:0] for x in det[:5]))
        _, carry = associate_sequential_reference(ref, half, gate, None, True)
        for case, d, c in (("all frames", det, None), ("resumed", rest, carry),
                           ("zero frames", none, carry)):
            got, glast = kscan.associate_sequential(ref, d, gate, c)
            want, wlast = associate_sequential_reference(ref, d, gate, c, True)
            torch.cuda.synchronize()
            assoc_check(got, glast, want, wlast, f"{what} {case}")
            print(f"check associate_sequential {what} {case}: equal to the "
                  f"plain version ({int(got[3].sum())} of {got[3].numel()} "
                  f"slots valid)", flush=True)
        if not torch.equal(glast, carry):
            raise AssertionError("associate_sequential: zero frames changed "
                                 "the carry")
        prep = kscan.assoc_args(ref, det, gate, None)
        entry = build.library().vbs_associate_sequential
        stream = torch.cuda.current_stream().cuda_stream
        ms = _device_ms(lambda: build.check(entry(*prep[0], stream),
                                            "associate_sequential launch"), 10)
        plain_ms = _event_ms(lambda: associate_sequential_reference(
            ref, det, gate), 1)
        bound = assoc_bound(b, n, k)
        chain = _assoc_chain(det.valid.sum(1).tolist())
        print(f"associate_sequential {what}: kernel {ms:.4f} ms "
              f"({1e6 * ms / b:.1f} ns a frame), plain {plain_ms:.3f} ms, "
              f"bound {bound[0]:.5f} ms ({bound[1]}); "
              f"{_chain_note(b, chain)} [{card}]", flush=True)
        record(f"associate_sequential {what}", "associate",
               SRC["associate"][1], launches, 0.0, ms, plain_ms, bound)
        return {"ms": ms, "plain_ms": plain_ms, "bound": bound}

    def record(name, kind, replaces, launches, err, ms, plain_ms, bound,
               library_ms=None, **extra):
        kernels.append(dict(
            name=name, route="cuda", source=SRC[kind][0], replaces=replaces,
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms,
            **extra))

    def packed_phase(packed, peaks, geom, prof, what, launches):
        """The packed-field window sums (K6 window_sums_packed, K7
        gather_moments: one kernel) on a fused run's own packed field and
        peaks: against the plain version, then timed in turns against the
        split path the detector runs on the same inputs."""
        w = packed.shape[2]
        want = kw.window_sums_packed_reference(packed, peaks, geom, prof)
        err6 = sums_close(kw.window_sums_packed(packed, peaks, geom, prof),
                          want, peaks.valid, f"window_sums_packed {what}")
        err7 = sums_close(kw.gather_moments(packed, peaks, geom, prof),
                          want, peaks.valid, f"gather_moments {what}")
        del want
        torch.cuda.empty_cache()

        def fused6():
            kw.window_sums_packed(packed, peaks, geom, prof)

        def fused7():
            kw.gather_moments(packed, peaks, geom, prof)

        def split():
            patches, pstart = kg.gather_windows_paired(packed, peaks, geom,
                                                       prof)
            tm.moments_from_patches_paired_mxu(patches, pstart, peaks, geom,
                                               prof, w)

        def plain():
            kw.window_sums_packed_reference(packed, peaks, geom, prof)

        call, _ = ws_entry((packed,), peaks, geom, prof, "window_sums_packed")
        lib = build.library()
        n_it = 10
        ms = {"packed": [_event_ms(fused6, n_it)], "split": []}
        ms["split"] += [_event_ms(split, n_it), _event_ms(split, n_it)]
        ms["packed"].append(_event_ms(fused6, n_it))
        gm_ms = _event_ms(fused7, n_it)
        kernel_ms = _event_ms(lambda: call(lib.vbs_window_sums), n_it)
        plain_ms = _event_ms(plain, 3)
        stats = window_stats(peaks, geom, prof, packed.shape[1], w)
        bound = sums_bound(stats, peaks.valid.numel(), prof, True)
        fused_ms = statistics.mean(ms["packed"])
        split_ms = statistics.mean(ms["split"])
        print(f"window sums from the packed field ({what}): packed-field "
              f"entry {fused_ms:.3f} ms (turns {ms['packed']}), its kernel "
              f"alone {kernel_ms:.4f} ms, gather_moments entry {gm_ms:.3f} "
              f"ms, split path (paired gather + raw-moment basis) "
              f"{split_ms:.3f} ms (turns {ms['split']}), plain {plain_ms:.3f} "
              f"ms, bound {bound[0]:.4f} ms ({bound[1]}), gated visits "
              f"{stats[0]}, distinct {stats[1]} [{card}]", flush=True)
        n = launches["window_sums_packed"]
        ratio = stats[0] / max(stats[1], 1)
        record(f"window_sums_packed {what}", "window_sums",
               SRC["window_sums"][2], n, err6, kernel_ms, plain_ms, bound,
               visits_per_distinct=ratio)
        record(f"gather_moments {what}", "window_sums", SRC["window_sums"][3],
               n, err7, gm_ms, plain_ms, bound, visits_per_distinct=ratio)
        return {"packed_ms": ms["packed"], "split_ms": ms["split"],
                "kernel_ms": kernel_ms, "gather_moments_ms": gm_ms,
                "plain_ms": plain_ms, "bound": bound,
                "max_abs_err": [err6, err7]}

    def stream_phase():
        """StreamingPipeline chunks against one batch on distorted frames,
        with the undistort preprocess and sequential association."""
        n, chunk, dist = STREAM
        scene, frames = render(480, 640, n, dist=np.asarray(dist))
        h, w = frames.shape[1:]
        scfg = PipelineConfig(
            undistort_frames=True,
            track=TrackConfig(association_mode="sequential"),
            reconstruct=ReconstructConfig(warmup_frames=0))

        def batch_run():
            src_map, new_cam = prepare_undistortion(scene.cam, h, w, scfg)
            ref = initialize(frames[0], scfg, rectify_map=src_map)
            return ref, process_frames(frames, ref, new_cam, scfg,
                                       rectify_map=src_map)

        def chunked_run():
            sp = StreamingPipeline(scene.cam, scfg, device=dev)
            return [sp.process(frames[i:i + chunk])
                    for i in range(0, n, chunk)]

        StreamingPipeline(scene.cam, scfg, device=dev).process(frames[:chunk])
        torch.cuda.synchronize()                             # warm-up
        rec: dict = {"frames": n, "chunk": chunk, "dist": list(dist)}
        reset_launch_counts()
        outs = chunked_run()
        torch.cuda.synchronize()
        rec["launches_chunked"] = launch_counts()
        reset_launch_counts()
        bref, bout = batch_run()
        torch.cuda.synchronize()
        rec["launches_batch"] = launch_counts()
        print(f"stream: launches chunked {rec['launches_chunked']}, batch "
              f"{rec['launches_batch']} [{card}]", flush=True)
        expect = ("fields", "gather", "scan", "associate", "filters")
        for which, calls in (("launches_chunked", len(outs)),
                             ("launches_batch", 1)):
            got = rec[which]
            if (any((v > 0) != (k in expect) for k, v in got.items())
                    or got["scan"] != calls or got["associate"] != calls):
                raise AssertionError(
                    f"stream: {which} {got}: expected the fused branch's "
                    f"kernels and {calls} scan and association launches")

        def cat(get):
            return torch.cat([get(o) for o in outs])

        valid = cat(lambda o: o.tracked.valid)
        diffs = {name: float((cat(get) - get(bout)).abs().max())
                 for name, get in (
                     ("axes", lambda o: o.tracked.axes),
                     ("cum_path", lambda o: o.recon.cum_path),
                     ("from_first_norm", lambda o: o.recon.from_first_norm))}
        n_diff = int((valid != bout.tracked.valid).sum())
        tracked = valid.sum(-1)
        rec.update(max_abs_diff=diffs, valid_slots_differing=n_diff,
                   tracked_min=int(tracked.min()),
                   tracked_max=int(tracked.max()),
                   from_first_z_last_mm=float(
                       bout.recon.from_first[-1, :, 2].mean()))
        print(f"stream: chunks of {chunk} vs one batch of {n}: valid slots "
              f"differing {n_diff}; max |diff| {diffs}; tracked per frame min "
              f"{int(tracked.min())} max {int(tracked.max())}; mean dz at "
              f"last frame {rec['from_first_z_last_mm']:.4f} mm", flush=True)
        if n_diff:
            raise AssertionError("stream: tracked.valid differs between "
                                 "chunks and one batch")
        if max(diffs.values()) > 1e-4:
            raise AssertionError(f"stream: chunks vs batch beyond 1e-4: "
                                 f"{diffs}")
        if int(tracked.min()) < 50:
            raise AssertionError(f"stream: fewer than 50 markers tracked in "
                                 f"a frame ({int(tracked.min())})")
        if not bool(torch.isfinite(bout.contact.tilt_deg).all()):
            raise AssertionError("stream: non-finite tilt")

        rec["associate"] = assoc_phase(
            bref, bout.detections, scfg.track.min_marker_distance_px,
            f"{n}x65 K={dcfg.max_candidates}",
            rec["launches_batch"]["associate"])

        s_c = _wall_s(chunked_run, 1)
        s_b = _wall_s(batch_run, 1)
        s_b += _wall_s(batch_run, 1)
        s_c += _wall_s(chunked_run, 1)
        rec.update(fps_chunked=n / statistics.median(s_c),
                   fps_batch=n / statistics.median(s_b), s_chunked=s_c,
                   s_batch=s_b)
        print(f"stream: fps chunked {rec['fps_chunked']:.1f} (s "
              + ", ".join(f"{t:.4f}" for t in s_c) + f"), batch "
              f"{rec['fps_batch']:.1f} (s " + ", ".join(f"{t:.4f}" for t in s_b)
              + f") [{card}]", flush=True)
        return rec

    def encode_period(period, quality):
        """The ingest's drift period rendered at 640x480 and encoded at
        ``quality`` with the port's encoder: (scene, JPEGs, ms a frame)."""
        from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg
        scene, frames = render(480, 640, period)
        u8 = frames.to(torch.uint8).cpu().numpy()   # truncation, as bench.py
        del frames
        t = time.perf_counter()
        jpegs = [encode_jpeg(f, quality) for f in u8]
        return scene, jpegs, 1e3 * (time.perf_counter() - t) / period

    def tdelta_streams(ht, batch):
        """K8's inputs for a TDELTA payload of ``batch`` frames, as
        ``tdelta_to_device`` builds them: (pos, val, spos, sval, total)."""
        total = batch * ht.grid[0] * ht.grid[1] * ht.zmax
        pos, val = tj.tdelta_entries(torch.from_numpy(ht.ac).to(dev), ht.zmax)
        spos = tj.gap_positions(torch.from_numpy(ht.sgaps).to(dev))
        sval = torch.from_numpy(ht.sdeltas).to(dev)
        return pos, val, spos, sval, total

    def expand_measure(streams, bases=None, probes=None):
        """K8 and each baseline version (``{name: C entry}``) int16-equal to
        the plain version on ``streams``, then timed in turns (the baselines
        and probes, the kernel twice, the same in reverse), beside the plain
        version and ``index_put_``. Probes (``{name: fn()}``) are timed
        only."""
        pos, val, spos, sval, total = streams
        stream = torch.cuda.current_stream(dev).cuda_stream
        want = expand_sorted_reference(pos, val, total, spos, sval)

        def version(fn):
            def run():
                out = torch.empty(total, dtype=torch.int16, device=dev)
                build.check(fn(pos.data_ptr(), val.data_ptr(), pos.numel(),
                               spos.data_ptr(), sval.data_ptr(), spos.numel(),
                               out.data_ptr(), total, stream),
                            "baseline expand_sorted launch")
                return out
            return run

        versions = {"kernel": lambda: kx.expand_sorted(pos, val, total, spos,
                                                       sval)}
        versions.update({k: version(fn) for k, fn in (bases or {}).items()})
        err = 0.0
        for name, fn in versions.items():
            got = fn()
            torch.cuda.synchronize()
            e = float((got.int() - want.int()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"expand_sorted {name} != plain (max abs "
                                     f"err {e})")
            err = e if name == "kernel" else err
        del got, want
        keep = (pos >= 0) & (pos < total)
        skeep = (spos >= 0) & (spos < total)
        lib_idx = (torch.cat([pos[keep], spos[skeep]]).long(),)
        lib_val = torch.cat([val[keep], sval[skeep]])

        def library():
            torch.zeros(total, dtype=torch.int16, device=dev).index_put_(
                lib_idx, lib_val, accumulate=True)

        others = [k for k in versions if k != "kernel"] + list(probes or ())
        order = [*others, "kernel", "kernel", *reversed(others)]
        fns = {**versions, **(probes or {})}
        turns: dict = {who: [] for who in order}
        for who in order:
            turns[who].append(_event_ms(fns[who], 20))
        ms = statistics.mean(turns["kernel"])
        plain_ms = _event_ms(lambda: expand_sorted_reference(
            pos, val, total, spos, sval), 20)
        lib_ms = _event_ms(library, 20)
        entries = pos.numel() + spos.numel()
        # Bytes: the dense int16 output written once, every entry's int32
        # position and int16 value read once; one integer add per entry.
        bound = _bound(2 * total + 6 * entries, entries)
        print(f"expand_sorted == plain on the TDELTA batch ({entries} entries "
              f"-> {total} int16; {', '.join(k for k in versions)} checked): "
              f"kernel {ms:.4f} ms, " + ", ".join(
                  f"{who} {statistics.mean(t):.4f} ms (turns {t})"
                  for who, t in turns.items())
              + f"; plain {plain_ms:.4f} ms, index_put_ {lib_ms:.4f} ms, "
              f"bound {bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.1f}"
              f"% of bound [{card}]", flush=True)
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound": bound, "entries": entries, "total": total,
                "max_abs_err": err, "turns_ms": turns}

    def expand_only_phase():
        """--only expand: K8 (and each --baseline version) on the ingest's
        first TDELTA batch, the first design's probes and PyTorch's zero
        fill of the same output, the entries' spread over the output tiles;
        no pipeline."""
        _, batch, quality, period = INGEST
        _, jpegs, _ = encode_period(period, quality)
        ht = tj.MjpegBatchDecoder(device=dev).entropy_decode_tdelta(
            jpegs[:batch])
        streams = tdelta_streams(ht, batch)
        pos, val, spos, sval, total = streams
        stream = torch.cuda.current_stream(dev).cuda_stream
        bases = {os.path.basename(src): _build_alt(src, "vbs_expand_sorted")
                 for src in args.baseline or ()}
        _P, _I = ctypes.c_void_p, ctypes.c_int
        stores = _build_alt(EXPAND_PROBES, "vbs_expand_probe_stores",
                            (_P, _I, _P))
        search = _build_alt(EXPAND_PROBES, "vbs_expand_probe_search",
                            (_P, _P, _I, _P, _P, _I, _P, _I, _P))
        out = torch.empty(total, dtype=torch.int16, device=dev)
        sink = torch.empty(-(-total // 4096), dtype=torch.int32, device=dev)
        probes = {
            "probe stores only": lambda: build.check(stores(
                out.data_ptr(), total, stream), "probe launch"),
            "probe search and adds only": lambda: build.check(search(
                pos.data_ptr(), val.data_ptr(), pos.numel(), spos.data_ptr(),
                sval.data_ptr(), spos.numel(), sink.data_ptr(), total, stream),
                "probe launch"),
            # The rate PyTorch's own fill writes the same output at.
            "torch zero_ of the output": lambda: out.zero_()}
        rec = expand_measure(streams, bases, probes)
        # The entries' spread: over 4,096-slot tiles, in the first frame, and
        # in the heaviest block's run of tiles when G = 6 blocks an SM (the
        # kernel's occupancy at its 33 KB of shared memory) split the tiles
        # by length or, as csrc/expand_sorted.cu does, by weight (a tile =
        # 256 entries).
        tile, weight_of_tile = 4096, 256
        tiles = -(-total // tile)
        keep = (pos >= 0) & (pos < total)
        per_tile = torch.bincount(pos[keep].long() // tile, minlength=tiles)
        first = int(((pos >= 0) & (pos < total // batch)).sum())
        g = 6 * torch.cuda.get_device_properties(dev).multi_processor_count
        q = torch.arange(tiles + 1, device=dev, dtype=torch.long)
        lb = torch.searchsorted(pos.long(), q * tile)
        weight = tiles * weight_of_tile + pos.numel()
        d = weight * torch.arange(g + 1, device=dev) // g
        splits = {"length": torch.arange(g + 1, device=dev) * tiles // g,
                  "weight": torch.searchsorted(q * weight_of_tile + lb,
                                               d).clamp(max=tiles)}
        heaviest = {k: int((lb[v[1:]] - lb[v[:-1]]).max())
                    for k, v in splits.items()}
        rec["spread"] = {"entries": int(keep.sum()), "tiles": tiles,
                         "first_frame": first,
                         "max_per_tile": int(per_tile.max()),
                         "empty_tiles": int((per_tile == 0).sum()),
                         "blocks": g, "mean_per_block": int(keep.sum()) / g,
                         "heaviest_block": heaviest}
        print(f"expand_sorted entries: {rec['spread']}", flush=True)
        record(f"expand_sorted tdelta {batch}x480x640", "expand",
               SRC["expand"][1], 0, rec["max_abs_err"], rec["ms"],
               rec["plain_ms"], rec["bound"], rec["library_ms"])
        return rec

    live_jpegs: list = []     # the ingest's first JPEGs, for phases 9, 11

    def ingest_phase():
        """The production MJPEG ingest: host entropy decode, the four device
        transports over the sorted-expand kernel, device_feed and
        StreamingPipeline.run (bench.py:122-159,250-261). The CLI phase
        runs on the same AVI inside it; returns both phases' records."""
        import tempfile

        from vision_basedsensor_tpu_torch.io.video import (MjpegAviCudaSource,
                                                           MjpegAviWriter)

        n, batch, quality, period = INGEST
        transports = ("dense", "packed", "split", "tdelta")
        rec: dict = {"frames": n, "batch": batch, "quality": quality,
                     "host_cpu_count": os.cpu_count()}
        # bench.py renders the drift in runs of `period` frames that restart
        # from rest, so every run is the same sequence: render and encode it
        # once, mux its JPEGs n / period times.
        scene, jpegs, rec["encode_ms_per_frame"] = encode_period(period,
                                                                 quality)
        live_jpegs[:] = jpegs[:max(LIVE[0], REQUEST[1], MULTI_FEED)]
        h, w = 480, 640
        rec["jpeg_bytes_per_frame"] = sum(map(len, jpegs)) / period
        print(f"ingest: encoded {period} {w}x{h} frames at q{quality} with the "
              f"port's encoder in {rec['encode_ms_per_frame']:.2f} ms/frame "
              f"(setup, host CPU), {rec['jpeg_bytes_per_frame']:.0f} B/frame",
              flush=True)
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "ingest.avi")
            wr = MjpegAviWriter(path, 12.0, (w, h))
            for i in range(n):
                wr.write_jpeg(jpegs[i % period])
            wr.close()
            first = jpegs[:batch]

            # -- every transport on the first batch -------------------------
            dec = tj.MjpegBatchDecoder(device=dev)
            host, out = {}, {}
            for tr in transports:
                hp = getattr(dec, f"entropy_decode_{tr}")(first)
                nbytes = sum(a.nbytes for a in hp if isinstance(a, np.ndarray))
                if nbytes != hp.stats["bytes_shipped"]:
                    raise AssertionError(f"ingest {tr}: payload {nbytes} B != "
                                         f"stats {hp.stats['bytes_shipped']}")
                host[tr] = hp
                out[tr] = getattr(dec, f"{tr}_to_device")(hp)
            torch.cuda.synchronize()
            rec["bytes_per_frame"] = {
                tr: host[tr].stats["bytes_shipped"] / batch for tr in transports}
            for tr in transports:
                if not torch.equal(out[tr], out["dense"]):
                    raise AssertionError(f"ingest: {tr} frames != dense frames")
            ht = host["tdelta"]
            want = tj.MjpegBatchDecoder(device="cpu").tdelta_to_device(ht)
            diff = (out["tdelta"].cpu() - want).abs()
            rec["tdelta_vs_cpu"] = {"max_abs": float(diff.max()),
                                    "pixels_differing": int((diff > 0).sum()),
                                    "pixels": diff.numel()}
            del want, diff
            print(f"ingest: the four transports give bitwise-equal frames; "
                  f"TDELTA vs the CPU decode {rec['tdelta_vs_cpu']}; bytes/frame "
                  f"{rec['bytes_per_frame']}", flush=True)
            if rec["tdelta_vs_cpu"]["max_abs"] > 1.0:
                raise AssertionError("ingest: TDELTA on the card differs from "
                                     "the CPU decode by more than 1 gray level")

            # -- K8 on the TDELTA batch's own streams ------------------------
            streams = tdelta_streams(ht, batch)
            pos, val, spos, sval, total = streams
            rec["expand"] = xm = expand_measure(streams)
            got = kx.expand_sorted(pos, val, total, spos, sval)

            # -- where the TDELTA decode's time goes (one batch) -------------
            arrays = [ht.ac, ht.sgaps, ht.sdeltas, ht.qtables]
            ac_dev = torch.from_numpy(ht.ac).to(dev)
            sg_dev = torch.from_numpy(ht.sgaps).to(dev)
            flat = got.reshape(batch, -1)
            coeffs = torch.cumsum(flat, 0, dtype=torch.int32)
            cf = coeffs.reshape(batch, *ht.grid, ht.zmax).float()
            qt = torch.from_numpy(ht.qtables).to(dev)
            stages = {
                "host_entropy_decode": 1e3 * statistics.median(
                    _wall_s(lambda: dec.entropy_decode_tdelta(first), 3)),
                "copy_to_device": _event_ms(
                    lambda: [torch.from_numpy(a).to(dev) for a in arrays], 10),
                "vlc_scan": _event_ms(lambda: (
                    tj.tdelta_entries(ac_dev, ht.zmax),
                    tj.gap_positions(sg_dev)), 10),
                "expand_sorted": xm["ms"],
                "temporal_cumsum": _event_ms(
                    lambda: torch.cumsum(flat, 0, dtype=torch.int32), 10),
                "dequant_idct": _event_ms(
                    lambda: tj._dequant_idct(cf, qt, h, w, zigzag=True), 10),
                "device_decode_total": _event_ms(
                    lambda: dec.tdelta_to_device(ht), 10),
            }
            del flat, coeffs, cf, got
            rec["tdelta_stages_ms_per_batch"] = stages
            rec["host_decode_ms_per_frame"] = stages["host_entropy_decode"] / batch
            print(f"ingest: TDELTA per batch of {batch}, ms: " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages.items())
                + f"; host entropy decode {rec['host_decode_ms_per_frame']:.4f} "
                f"ms/frame on {os.cpu_count()} host CPUs [{card}]", flush=True)
            del out, host
            torch.cuda.empty_cache()

            # -- decode-only fps per transport -------------------------------
            rec["decode_only_fps"] = {}
            for tr in transports:
                it = MjpegAviCudaSource(path, transport=tr, device=dev).batches(
                    batch)
                next(it)                       # warm-up batch, not timed
                torch.cuda.synchronize()
                t = time.perf_counter()
                got_n = sum(b.shape[0] for b in it)
                torch.cuda.synchronize()
                rec["decode_only_fps"][tr] = got_n / (time.perf_counter() - t)
            print(f"ingest: decode-only fps (host entropy decode + device "
                  f"decode, serial) {rec['decode_only_fps']} [{card}]",
                  flush=True)

            # -- the main path: StreamingPipeline.run over the AVI -----------
            def run_pass():
                sp = StreamingPipeline(scene.cam, cfg, device=dev)
                return list(sp.run(MjpegAviCudaSource(path, device=dev),
                                   batch))

            decoded = list(MjpegAviCudaSource(path, device=dev).batches(batch))

            def process_pass():
                sp = StreamingPipeline(scene.cam, cfg, device=dev)
                return [sp.process(f) for f in decoded]

            StreamingPipeline(scene.cam, cfg, device=dev).process(
                decoded[0][:2])
            torch.cuda.synchronize()                         # warm-up
            reset_launch_counts()
            t = time.perf_counter()
            outs = run_pass()
            torch.cuda.synchronize()
            rec["run_first_s"] = time.perf_counter() - t
            rec["launches"] = launches = launch_counts()
            print(f"ingest: StreamingPipeline.run over {n} frames in "
                  f"{rec['run_first_s']:.3f} s (first counted run); launches "
                  f"{launches} [{card}]", flush=True)
            expect = {"fields", "gather", "expand_sorted", "scan", "filters"}
            if (any((v > 0) != (k in expect) for k, v in launches.items())
                    or launches["scan"] != -(-n // batch)):
                raise AssertionError(f"ingest: expected launches of exactly "
                                     f"{sorted(expect)}, one scan a chunk, "
                                     f"got {launches}")
            pouts = process_pass()
            torch.cuda.synchronize()
            if len(outs) != len(pouts) or len(outs) != -(-n // batch):
                raise AssertionError(f"ingest: {len(outs)} run chunks, "
                                     f"{len(pouts)} process chunks")
            for i, (a, b) in enumerate(zip(outs, pouts)):
                for (name, x), (_, y) in zip(leaves(a, "out"),
                                             leaves(b, "out")):
                    if not torch.equal(x, y):
                        raise AssertionError(f"ingest: chunk {i} {name} "
                                             "differs between run and process")
            tracked = torch.cat([o.tracked.valid for o in outs]).sum(-1)
            rec.update(tracked_min=int(tracked.min()),
                       tracked_max=int(tracked.max()),
                       frames_out=int(tracked.numel()))
            print(f"ingest: run == process on the decoded frames (every "
                  f"output, {len(outs)} chunks); tracked per frame min "
                  f"{rec['tracked_min']} max {rec['tracked_max']} over "
                  f"{rec['frames_out']} frames", flush=True)
            if rec["frames_out"] != n or rec["tracked_min"] != 65:
                raise AssertionError("ingest: expected 65/65 markers in every "
                                     f"one of {n} frames")
            del outs, pouts

            # -- decode-fed fps: run against process, in turns ---------------
            s_r = _wall_s(run_pass, 1)
            s_p = _wall_s(process_pass, 2)
            s_r += _wall_s(run_pass, 2)
            s_p += _wall_s(process_pass, 1)
            rec.update(fps_run=n / statistics.median(s_r),
                       fps_process=n / statistics.median(s_p), s_run=s_r,
                       s_process=s_p)
            print(f"ingest: decode-fed fps StreamingPipeline.run "
                  f"{rec['fps_run']:.1f} (s " + ", ".join(
                      f"{t:.4f}" for t in s_r) + "), process on the decoded "
                  f"frames {rec['fps_process']:.1f} (s " + ", ".join(
                      f"{t:.4f}" for t in s_p) + f") [{card}]", flush=True)
            if args.profile:
                rec["profile"] = profile_batch(
                    run_pass, f"ingest run over {n} frames",
                    statistics.median(s_r))
            del decoded
            torch.cuda.empty_cache()
            cli = cli_phase(path, td)
        record(f"expand_sorted tdelta {batch}x{h}x{w}", "expand",
               SRC["expand"][1], launches["expand_sorted"], xm["max_abs_err"],
               xm["ms"], xm["plain_ms"], xm["bound"], xm["library_ms"])
        return rec, cli

    def run_command(phase, name, argv, expect, launches_of):
        """``vbs-torch argv`` in-process with the counts set to 0 just before
        and read just after (into ``launches_of[name]``); raises unless it
        launched exactly the kernels ``expect``. Returns its stdout, wall
        seconds and stderr."""
        from vision_basedsensor_tpu_torch.cli import main as cli
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli.main(argv)
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        launches = launches_of[name] = launch_counts()
        if any((v > 0) != (k in expect) for k, v in launches.items()):
            raise AssertionError(f"{phase} {name}: expected launches of "
                                 f"exactly {sorted(expect)}, got {launches}")
        print(f"{phase}: {name} in {s:.3f} s; launches {launches} [{card}]",
              flush=True)
        return out.getvalue(), s, err.getvalue()

    def cli_phase(path, workdir):
        """The replay CLI in-process on the ingest's AVI at its default
        --chunk: track --tpu-decode, track on the decoded frames as .npy,
        reconstruct, and detect on one frame, each held to the library
        calls it stands for (byte-equal files) with its launches counted."""
        from vision_basedsensor_tpu_torch.cli import main as cli
        from vision_basedsensor_tpu_torch.io.table import (read_tracking_csv,
                                                           write_coords_table,
                                                           write_tracking_csv)
        from vision_basedsensor_tpu_torch.io.video import MjpegAviCudaSource
        from vision_basedsensor_tpu_torch.reconstruct import \
            reconstruct_sequence
        from vision_basedsensor_tpu_torch.track.associate import TrackedFrames

        n, chunk = INGEST[0], CLI_CHUNK
        ccfg = PipelineConfig()                  # the CLI's own default
        cam = default_scene(480, 640, device=dev).cam
        rec: dict = {"frames": n, "chunk": chunk, "launches": {}}

        def run_cli(name, argv, expect):
            return run_command("cli", name, argv, expect, rec["launches"])[:2]

        def write_tracked(outs, csv_path):
            """markers.csv of pipeline outputs, as cmd_track writes it."""
            tr = [cli._host(o.tracked) for o in outs]
            cat = lambda k: np.concatenate([getattr(x, k) for x in tr])
            write_tracking_csv(csv_path, tr[0]._replace(
                xy=cat("xy"), axes=cat("axes"), angle=cat("angle"),
                valid=cat("valid")))
            return cat("valid")

        def same_bytes(a, b, what):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if fa.read() != fb.read():
                    raise AssertionError(f"cli: {what}: {a} != {b}")

        def run_pass():
            sp = StreamingPipeline(cam, ccfg, device=dev)
            return list(sp.run(MjpegAviCudaSource(path, device=dev), chunk))

        # 1. track --tpu-decode against StreamingPipeline.run, in turns.
        tpu_dir = os.path.join(workdir, "cli_tpu")
        tpu_argv = ["track", path, "--tpu-decode", "--chunk", str(chunk),
                    "--output-dir", tpu_dir]
        s_cli = [run_cli("track --tpu-decode", tpu_argv,
                         {"fields", "gather", "expand_sorted", "scan",
                          "filters"})[1]]
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = run_pass()
        torch.cuda.synchronize()
        s_run = [time.perf_counter() - t]
        want = os.path.join(workdir, "run_markers.csv")
        t = time.perf_counter()
        valid = write_tracked(outs, want)
        rec["write_csv_s"] = time.perf_counter() - t
        del outs
        same_bytes(os.path.join(tpu_dir, "markers.csv"), want,
                   "track --tpu-decode vs StreamingPipeline.run")
        per_frame = valid.sum(-1)
        if valid.shape[0] != n or per_frame.min() != 65:
            raise AssertionError(f"cli: expected 65/65 markers in all {n} "
                                 f"frames, got min {per_frame.min()} over "
                                 f"{valid.shape[0]}")
        s_run += _wall_s(run_pass, 1)
        s_cli.append(run_cli("track --tpu-decode (timed)", tpu_argv,
                             {"fields", "gather", "expand_sorted", "scan",
                              "filters"})[1])
        same_bytes(os.path.join(tpu_dir, "markers.csv"), want,
                   "track --tpu-decode (second run) vs StreamingPipeline.run")
        rec.update(s_cli=s_cli, s_run=s_run,
                   fps_cli=n / statistics.median(s_cli),
                   fps_run=n / statistics.median(s_run))
        print(f"cli: track --tpu-decode {rec['fps_cli']:.1f} frames/s (s "
              + ", ".join(f"{x:.4f}" for x in s_cli) + ") beside "
              f"StreamingPipeline.run {rec['fps_run']:.1f} frames/s (s "
              + ", ".join(f"{x:.4f}" for x in s_run) + f") on {n} 640x480 "
              f"frames, chunk {chunk}; writing markers.csv "
              f"{rec['write_csv_s']:.3f} s; byte-equal, 65/65 markers in "
              f"every frame [{card}]", flush=True)

        # 2. track on the same decoded frames as .npy against process().
        decoded = torch.cat(list(MjpegAviCudaSource(path, device=dev)
                                 .batches(chunk))).to(torch.uint8).cpu()
        npy = os.path.join(workdir, "decoded.npy")
        np.save(npy, decoded.numpy())
        npy_dir = os.path.join(workdir, "cli_npy")
        run_cli("track .npy", ["track", npy, "--chunk", str(chunk),
                               "--output-dir", npy_dir],
                {"fields", "gather", "scan", "filters"})
        sp = StreamingPipeline(cam, ccfg, device=dev)
        want = os.path.join(workdir, "process_markers.csv")
        write_tracked([sp.process(decoded[i:i + chunk])
                       for i in range(0, n, chunk)], want)
        del decoded, sp
        same_bytes(os.path.join(npy_dir, "markers.csv"), want,
                   "track .npy vs StreamingPipeline.process")

        # 3. reconstruct against reconstruct_sequence on the CSV's arrays.
        csv_path = os.path.join(tpu_dir, "markers.csv")
        coords = os.path.join(workdir, "cli_3d.csv")
        run_cli("reconstruct", ["reconstruct", csv_path, "--no-warmup",
                                "--output", coords], {"scan"})
        data = read_tracking_csv(csv_path)
        f32 = lambda k: torch.as_tensor(data[k], dtype=torch.float32,
                                        device=dev)
        recon = reconstruct_sequence(cam, TrackedFrames(
            xy=f32("xy"), ref_xy=f32("ref_xy"), axes=f32("axes"),
            angle=f32("angle"), ring=torch.zeros(65, dtype=torch.int32,
                                                 device=dev),
            valid=torch.as_tensor(data["valid"], device=dev)),
            ccfg.reconstruct, apply_warmup=False)
        want = os.path.join(workdir, "sequence_3d.csv")
        write_coords_table(want, cli._host(recon))
        same_bytes(coords, want, "reconstruct vs reconstruct_sequence")
        rec["observations"] = int(recon.seen.sum())
        del recon

        # 4. detect on the first decoded frame.
        frame0 = os.path.join(workdir, "frame0.npy")
        np.save(frame0, np.load(npy, mmap_mode="r")[0])
        text, _ = run_cli("detect", ["detect", frame0], {"fields", "gather",
                                                         "filters"})
        rows = text.strip().splitlines()[1:]
        rec["detected"] = len(rows)
        if len(rows) != 65:
            raise AssertionError(f"cli: detect found {len(rows)} markers")
        print(f"cli: the four commands' outputs equal the library calls "
              f"(track --tpu-decode, track .npy, reconstruct: byte-equal "
              f"files, {rec['observations']} observations); detect 65 "
              f"markers [{card}]", flush=True)
        return rec

    def pose_phase(workdir):
        """The pose-compensation commands in-process at 640x480: tilt on a
        vertical and a tilted compression, analyze on tilt's TXTs, indent on
        a staircase, record and run-live --tpu-decode --publish --resume on
        a localhost MJPEG server of the ingest's JPEGs, each with its
        launches counted and held to the library calls it stands for; then
        the cost of one request."""
        from vision_basedsensor_tpu_torch.config import to_json
        from vision_basedsensor_tpu_torch.synth import (indentation_staircase,
                                                        tilt_deviation_field)
        rec: dict = {"launches": {}}

        def run_pose(name, argv, expect):
            return run_command("pose", name, argv, expect, rec["launches"])

        def number(text, key):
            line = next(ln for ln in text.splitlines() if key in ln)
            return float(line.split(key)[1].split()[0])

        scene = default_scene(480, 640, device=dev)

        def save(name, disp):
            path = os.path.join(workdir, f"{name}.npy")
            np.save(path, render_frames(scene, disp).to(torch.uint8).cpu()
                    .numpy())
            return path

        # 1. tilt: a vertical and a tilted compression, two frames each.
        angle, depth, bound = POSE_TILT
        zero = torch.zeros((65, 3), device=dev)
        press = zero.clone()
        press[:, 2] = -depth
        vert = save("vertical", torch.stack([zero, press]))
        tilted = save("tilted", torch.stack([zero, tilt_deviation_field(
            angle, compression_mm=depth, device=dev)]))
        cfg_path = os.path.join(workdir, "pose_cfg.json")
        to_json(cfg, cfg_path)
        exp = os.path.join(workdir, "exp")
        text, rec["tilt_s"], _ = run_pose(
            "tilt", ["--config", cfg_path, "tilt", vert, tilted,
                     "--no-warmup", "--start-range", "0", "0", "--end-range",
                     "1", "1", "--output-dir", exp],
            {"fields", "gather", "scan", "filters"})
        rec.update(tilt_deg=number(text, "Tilt Angle = "),
                   common_markers=int(number(text, "common markers: ")))
        print(f"pose: tilt of a {angle} deg compression at 640x480: "
              f"{rec['tilt_deg']:.2f} deg, {rec['common_markers']} common "
              f"markers [{card}]", flush=True)
        if abs(rec["tilt_deg"] - angle) >= bound:
            raise AssertionError(f"pose: tilt {rec['tilt_deg']} not within "
                                 f"{bound} deg of {angle}")
        if rec["common_markers"] != 65:
            raise AssertionError(f"pose: {rec['common_markers']} common "
                                 "markers, expected 65")

        # 2. analyze on the TXTs tilt wrote: the same tilt, no kernel.
        text2, _, _ = run_pose(
            "analyze", ["analyze", os.path.join(exp, "vertical.txt"),
                        os.path.join(exp, "tilted.txt")], set())
        tilt_line = lambda t: next(ln for ln in t.splitlines()
                                   if "Tilt Angle" in ln)
        if tilt_line(text2) != tilt_line(text):
            raise AssertionError(f"pose: analyze printed {tilt_line(text2)!r}"
                                 f", tilt {tilt_line(text)!r}")

        # 3. indent on the staircase, sequential association.
        steps, step_mm = POSE_STAIRS
        stairs = save("stairs", indentation_staircase(steps, step_mm,
                                                      device=dev))
        text, _, err = run_pose(
            "indent", ["indent", stairs, "--steps", str(steps), "--step-mm",
                       str(step_mm), "--association", "sequential"],
            {"fields", "gather", "scan", "associate", "filters"})
        rows = [ln.split(",") for ln in text.splitlines()[1:]]
        rec["indent_markers"] = [int(r[5]) for r in rows]
        rec["indent_worst_step_mm"] = number(err, "worst single-step error: ")
        rec["indent_cumulative_mm"] = float(rows[-1][3])
        print(f"pose: indent {steps} x {step_mm} mm at 640x480: worst "
              f"single-step error {rec['indent_worst_step_mm']:.4f} mm "
              f"(reference: 0.04-0.18 mm), cumulative at step {steps} "
              f"{rec['indent_cumulative_mm']:+.4f} mm, markers per step "
              f"{rec['indent_markers']} [{card}]", flush=True)
        if len(rows) != steps or set(rec["indent_markers"]) != {65}:
            raise AssertionError(f"pose: indent rows {rows}: expected "
                                 f"{steps} steps of 65 markers")

        rec["live"] = live_loop(workdir, run_pose)
        rec["request"] = request_phase()
        return rec

    def calibrate_phase(workdir):
        """Phase 10: synth, a probe indentation through run_video, then
        calibrate-intrinsics, calibrate-extrinsics and diameter in-process,
        each with its launches counted alone and held to the library calls
        it stands for and to the rendered truth."""
        from vision_basedsensor_tpu_torch import layout
        from vision_basedsensor_tpu_torch.analysis.diameter import \
            measure_diameters
        from vision_basedsensor_tpu_torch.calibrate import (
            CalibrationArtifact, solve_pnp_ransac)
        from vision_basedsensor_tpu_torch.calibrate.images import \
            calibrate_from_images
        from vision_basedsensor_tpu_torch.calibrate.zhang import project_posed
        from vision_basedsensor_tpu_torch.core.transforms import rodrigues
        from vision_basedsensor_tpu_torch.pipeline import run_video
        from vision_basedsensor_tpu_torch.synth import (
            indentation_staircase, membrane_indentation_field)
        rec: dict = {"launches": {}}
        t_phase = time.perf_counter()

        def run_cal(name, argv, expect=frozenset()):
            return run_command("calibrate", name, argv, expect,
                               rec["launches"])

        scene = default_scene(480, 640, device=dev)

        # 1. synth: the staircase and the wave, each equal to render_frames.
        t = np.arange(60, dtype=np.float32)
        wave = np.zeros((60, 65, 3), np.float32)
        wave[:, :, 2] = -(1 - np.cos(t / 10.0))[:, None]
        for motion, disp, extra in (
                ("staircase", indentation_staircase(device=dev), []),
                ("wave", torch.from_numpy(wave).to(dev), ["--frames", "60"])):
            path = os.path.join(workdir, f"synth_{motion}.npy")
            _, rec[f"synth_{motion}_s"], _ = run_cal(
                f"synth {motion}", ["synth", "--output", path, "--motion",
                                    motion, "--height", "480", "--width",
                                    "640", *extra])
            got = np.load(path)
            want = render_frames(scene, disp).to(torch.uint8).cpu().numpy()
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"calibrate: synth {motion} {got.shape}"
                                     " differs from render_frames")
            print(f"calibrate: synth {motion} {got.shape} byte-equal to "
                  f"render_frames [{card}]", flush=True)

        # 2. A probe indentation with membrane flow through run_video
        # (tests/test_reconstruct.py:97-131's bounds).
        field = membrane_indentation_field(1.5, contact_xy=(2.0, -1.0),
                                           probe_radius_mm=5.0,
                                           tangential_frac=0.3, device=dev)
        frames = render_frames(scene, torch.stack([torch.zeros_like(field),
                                                   field]))
        mcfg = PipelineConfig(
            reconstruct=ReconstructConfig(warmup_frames=0),
            track=TrackConfig(association_mode="frame0"))
        torch.cuda.synchronize()
        reset_launch_counts()
        out = run_video(frames, scene.cam, mcfg, apply_warmup=False)
        torch.cuda.synchronize()
        launches = rec["launches"]["membrane run_video"] = launch_counts()
        expect = {"fields", "gather", "scan", "filters"}
        if any((n > 0) != (k in expect) for k, n in launches.items()):
            raise AssertionError(f"calibrate: membrane run_video launched "
                                 f"{launches}, expected {sorted(expect)}")
        seen = out.recon.seen
        both = seen[0] & seen[1]
        f = field.double()
        got = out.recon.from_first[1].double()
        err = (got - f)[both].abs()
        med = [float(v) for v in err.median(0).values]
        mag = torch.hypot(f[:, 0], f[:, 1])
        m = both & (mag > 0.1)
        cos = ((got[m, 0] * f[m, 0] + got[m, 1] * f[m, 1])
               / torch.clamp(torch.hypot(got[m, 0], got[m, 1]) * mag[m],
                             min=1e-9))
        rec["membrane"] = dict(both=int(both.sum()), median_abs_err_mm=med,
                               median_cos=float(cos.median()),
                               launches=launches)
        print(f"calibrate: membrane indentation 1.5 mm at 640x480: "
              f"{int(both.sum())} markers in both frames, median |error| "
              f"x {med[0]:.4f} y {med[1]:.4f} z {med[2]:.4f} mm, median "
              f"direction cosine {rec['membrane']['median_cos']:.4f}; "
              f"launches {launches} [{card}]", flush=True)
        if not (int(both.sum()) >= 60 and med[0] < 0.05 and med[1] < 0.05
                and med[2] < 0.10 and rec["membrane"]["median_cos"] > 0.95):
            raise AssertionError(f"calibrate: membrane bounds missed: "
                                 f"{rec['membrane']}")
        del frames, out

        # 3. calibrate-intrinsics on 20 rendered boards.
        K = np.array(CAL_K)
        boards = os.path.join(workdir, "boards")
        os.makedirs(boards)
        for k in range(CAL_VIEWS):
            rvec = (0.3 * math.sin(k * 1.3), 0.3 * math.cos(k * 0.9),
                    0.4 * math.sin(k * 2.1))
            tvec = (-10.5 + 4 * math.sin(k * 0.7), -10.5 + 3 * math.cos(k * 1.1),
                    55.0 + 8 * math.sin(k * 0.5))
            np.save(os.path.join(boards, f"board_{k:02d}.npy"),
                    render_board(K, rvec, tvec, CAL_SQUARE_MM, 7, 480, 640,
                                 dev))
        intr = os.path.join(workdir, "IntrinsicParameters.xlsx")
        direct = os.path.join(workdir, "direct_intrinsics.xlsx")
        with fixed_zip_clock():
            text, rec["intrinsics_s"], _ = run_cal(
                "calibrate-intrinsics", ["calibrate-intrinsics", boards,
                                         "--output", intr])
            images = [np.load(os.path.join(boards, n))
                      for n in sorted(os.listdir(boards))]
            lib = calibrate_from_images(images, device=dev)
            lib.artifact.save_intrinsics_xlsx(direct)
        with open(intr, "rb") as fa, open(direct, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError("calibrate: calibrate-intrinsics XLSX "
                                     "!= calibrate_from_images")
        art = CalibrationArtifact.load_intrinsics_xlsx(intr)
        k_err = max(abs(art.fx - K[0, 0]), abs(art.fy - K[1, 1]),
                    abs(art.cx - K[0, 2]), abs(art.cy - K[1, 2]))
        rec["intrinsics"] = dict(fx=art.fx, fy=art.fy, cx=art.cx, cy=art.cy,
                                 rms_px=art.intrinsic_reproj_error,
                                 max_k_err_px=k_err, text=text.strip())
        print(f"calibrate: calibrate-intrinsics on {CAL_VIEWS} 640x480 boards"
              f": {text.strip().splitlines()[0]}; fx {art.fx:.3f} fy "
              f"{art.fy:.3f} cx {art.cx:.3f} cy {art.cy:.3f} (largest error "
              f"{k_err:.3f} px), RMS {art.intrinsic_reproj_error:.4f} px, "
              f"XLSX byte-equal to the library calls [{card}]", flush=True)
        if (f"used {CAL_VIEWS}/{CAL_VIEWS}" not in text or k_err >= 6.0
                or art.intrinsic_reproj_error >= 0.3):
            raise AssertionError(f"calibrate: intrinsics {rec['intrinsics']}")

        # 4. calibrate-extrinsics: the markers through those intrinsics.
        cam64 = art.to_camera(torch.float64, device=dev)
        world = layout.dome_layout()[:, 1:].astype(np.float64)
        R_true = rodrigues(torch.tensor(PNP_POSE[0], dtype=torch.float64,
                                        device=dev))
        T_true = torch.tensor(PNP_POSE[1], dtype=torch.float64, device=dev)
        pix = project_posed(cam64, R_true, T_true,
                            torch.as_tensor(world, device=dev)).cpu().numpy()
        rng = np.random.default_rng(10)
        pix += rng.normal(0.0, 0.3, pix.shape)
        outl = np.sort(rng.choice(65, 7, replace=False))
        pix[outl] += (rng.uniform(20, 40, (7, 2))
                      * rng.choice([-1.0, 1.0], (7, 2)))
        wcsv = os.path.join(workdir, "world_points.csv")
        pcsv = os.path.join(workdir, "pixel_points.csv")
        with open(wcsv, "w") as fw, open(pcsv, "w") as fp:
            fw.write("marker_id,Xw,Yw,Zw\n")
            fp.write("marker_id,u,v\n")
            for i in range(65):
                fw.write(f"{i + 1}," + ",".join(repr(float(v))
                                                for v in world[i]) + "\n")
                fp.write(f"{i + 1}," + ",".join(repr(float(v))
                                                for v in pix[i]) + "\n")
        ext = os.path.join(workdir, "ExtrinsicParameters.xlsx")
        text, rec["extrinsics_s"], _ = run_cal(
            "calibrate-extrinsics", ["calibrate-extrinsics", intr, wcsv, pcsv,
                                     "--output", ext])
        pnp = solve_pnp_ransac(world, pix, cam64, PipelineConfig().calibrate)
        got_art = art.load_extrinsics_xlsx(ext)
        if not (np.array_equal(got_art.R_wc, pnp.R_wc.cpu().numpy())
                and np.array_equal(got_art.T_wc, pnp.T_wc.cpu().numpy())):
            raise AssertionError("calibrate: calibrate-extrinsics XLSX pose "
                                 "!= solve_pnp_ransac")
        rejected = np.where(~pnp.inliers.cpu().numpy())[0]
        R_err = R_true.T @ pnp.R_wc
        ang = math.degrees(math.acos(max(-1.0, min(1.0, (float(
            torch.trace(R_err)) - 1.0) / 2.0))))
        t_err = float(torch.linalg.vector_norm(pnp.T_wc - T_true))
        rec["extrinsics"] = dict(
            inliers=int(pnp.num_inliers), rejected=rejected.tolist(),
            outliers=outl.tolist(), rotation_err_deg=ang, t_err_mm=t_err,
            mean_reproj_px=float(pnp.mean_reproj_error),
            confidence=float(pnp.achieved_confidence), text=text.strip())
        print(f"calibrate: calibrate-extrinsics, 65 markers, 7 outliers: "
              f"{int(pnp.num_inliers)} inliers, outliers rejected "
              f"{rejected.tolist() == outl.tolist()}, rotation error "
              f"{ang:.5f} deg, T error {t_err:.5f} mm, mean reprojection "
              f"error {float(pnp.mean_reproj_error):.3f} px over all points "
              f"(1000 hypotheses, 8 px) [{card}]", flush=True)
        if (rejected.tolist() != outl.tolist() or ang >= 0.1
                or t_err >= 0.1):
            raise AssertionError(f"calibrate: extrinsics {rec['extrinsics']}")

        # 5. diameter on a 1080x1920 photo: board beside 65 disks.
        img, centres = render_diameter_photo(dev)
        photo = os.path.join(workdir, "diameter_photo.npy")
        np.save(photo, img)
        text, rec["diameter_s"], err = run_cal("diameter",
                                               ["diameter", photo])
        scale = float(text.split("Scale: ")[1].split()[0])
        res = measure_diameters(img, scale, device=dev)
        valid = res.valid.cpu().numpy()
        d = res.diameters_mm.cpu().numpy()[valid]
        c = res.centers.cpu().numpy()[valid]
        rows = ["x,y,diameter_mm,circularity"] + [
            f"{x:.1f},{y:.1f},{dd:.3f},{cc:.3f}" for (x, y), dd, cc in zip(
                c, d, res.circularity.cpu().numpy()[valid])]
        printed = text.strip().splitlines()
        if printed[1:] != rows:
            raise AssertionError("calibrate: diameter rows != "
                                 "measure_diameters")
        off = np.linalg.norm(c[:, None] - centres[None], axis=-1).min(1)
        wide = measure_diameters(img, scale, max_markers=1024, device=dev)
        n_wide = int(wide.valid.sum())
        d_wide = wide.diameters_mm[wide.valid].cpu().numpy()
        rec["diameter"] = dict(
            scale_px_per_mm=scale, valid=int(valid.sum()),
            mean_mm=float(d.mean()), std_mm=float(d.std()),
            max_centre_err_px=float(off.max()), valid_budget_1024=n_wide,
            mean_mm_budget_1024=float(d_wide.mean()))
        print(f"calibrate: diameter on a 1080x1920 photo (board beside 65 "
              f"2.0 mm disks at {DIAMETER_PX_PER_MM} px/mm): scale "
              f"{scale:.2f} px/mm, {int(valid.sum())} valid markers, mean "
              f"{d.mean():.3f} mm, std {d.std():.3f} mm (reference: 2.01 +- "
              f"0.04), centres within {off.max():.3f} px of the disks; rows "
              f"equal to measure_diameters; with a 1024-candidate budget "
              f"{n_wide} valid, mean {d_wide.mean():.3f} mm [{card}]",
              flush=True)
        # The reference's measurement (analysis/diameter.py): the enclosing
        # circle of the mask's pixel centres + 0.5 px a side reads a disk of
        # D px as D to D + 2 px; its 96-candidate budget is spent before
        # the distance suppression, on the plateau cells of the first disks
        # and squares in row order (PERF.md §6).
        hi = 2.0 + 2.0 / DIAMETER_PX_PER_MM
        if (abs(scale - DIAMETER_PX_PER_MM) > 0.01 * DIAMETER_PX_PER_MM
                or valid.sum() < 10 or off.max() > 1.0
                or d.min() < 1.95 or d.max() > hi or n_wide < 60
                or d_wide.min() < 1.95 or d_wide.max() > hi):
            raise AssertionError(f"calibrate: diameter {rec['diameter']}")
        rec["phase_s"] = time.perf_counter() - t_phase
        print(f"calibrate: phase {rec['phase_s']:.1f} s [{card}]",
              flush=True)
        return rec

    def serve_phase(workdir):
        """Phase 11a: the acquisition server (run_server, synthetic, the
        CLI's 640x480 at 12 fps, q70) consumed in-process by record and
        run-live --tpu-decode --publish 0; the capture thread's render and
        encode ms per frame and the interval between published frames."""
        import urllib.request

        from vision_basedsensor_tpu_torch.capture import run_server
        from vision_basedsensor_tpu_torch.capture import server as cserver
        from vision_basedsensor_tpu_torch.config import CaptureConfig
        from vision_basedsensor_tpu_torch.io import publish
        from vision_basedsensor_tpu_torch.io.mjpeg import sof_dims
        from vision_basedsensor_tpu_torch.io.video import \
            _iter_avi_video_chunks

        n_rec, n_live, batch = SERVE
        cap = CaptureConfig(port=0)
        rec: dict = {"launches": {}, "width": cap.width, "height": cap.height,
                     "fps": cap.fps, "quality": cap.jpeg_quality,
                     "frame_budget_ms": 1e3 / cap.fps}
        renders, encodes, published = [], [], []
        read, encode = cserver.SyntheticCamera.read, cserver._encode_jpeg

        def read_spy(self):
            t = time.perf_counter()
            f = read(self)
            renders.append(1e3 * (time.perf_counter() - t))
            return f

        def encode_spy(frame, quality):
            t = time.perf_counter()
            jb = encode(frame, quality)
            encodes.append(1e3 * (time.perf_counter() - t))
            published.append(time.perf_counter())
            return jb

        cserver.SyntheticCamera.read = read_spy
        cserver._encode_jpeg = encode_spy
        captured, served, payloads = [], [], []
        process = StreamingPipeline.process
        update = publish.StatePublisher.update

        def process_spy(self, frames):
            out = process(self, frames)
            captured.append(out)
            return out

        def update_spy(self, state):
            update(self, state)
            payloads.append(state)
            with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/state",
                                        timeout=30) as r:
                served.append(json.loads(r.read()))

        srv = run_server(cap, synthetic=True, block=False, device=dev)
        try:
            url = f"http://127.0.0.1:{srv.port}/stream"
            t0 = time.perf_counter()
            while srv.camera.frame is None and time.perf_counter() - t0 < 60:
                time.sleep(0.01)
            avi = os.path.join(workdir, "served.avi")
            _, rec["record_s"], _ = run_command(
                "serve", "record", ["record", url, avi, "--max-frames",
                                    str(n_rec)], set(), rec["launches"])
            StreamingPipeline.process = process_spy
            publish.StatePublisher.update = update_spy
            try:
                text, rec["run_live_s"], _ = run_command(
                    "serve", "run-live --tpu-decode",
                    ["run-live", url, "--tpu-decode", "--publish", "0",
                     "--batch", str(batch), "--max-frames", str(n_live)],
                    {"expand_sorted", "fields", "gather", "scan", "filters"},
                    rec["launches"])
            finally:
                StreamingPipeline.process = process
                publish.StatePublisher.update = update
        finally:
            srv.stop()
            cserver.SyntheticCamera.read = read
            cserver._encode_jpeg = encode
        alive = [t.name for t in srv._threads if t.is_alive()]
        if alive:
            raise AssertionError(f"serve: threads still running after "
                                 f"stop(): {alive}")

        # The recording: valid 640x480 JPEGs that the native decoder reads.
        with open(avi, "rb") as f:
            got = list(_iter_avi_video_chunks(f.read()))
        if len(got) != n_rec or any(sof_dims(j) != (cap.width, cap.height)
                                    for j in got):
            raise AssertionError(f"serve: recorded {len(got)} frames of "
                                 f"{ {sof_dims(j) for j in got} }")
        dec = tj.MjpegBatchDecoder(device=dev)
        x = dec.tdelta_to_device(dec.entropy_decode_tdelta(got))
        if (tuple(x.shape) != (n_rec, cap.height, cap.width)
                or not bool(torch.isfinite(x).all())):
            raise AssertionError(f"serve: decoded {tuple(x.shape)}")
        rec["recorded_distinct"] = len(set(got))

        # run-live: 65/65 markers every frame, finite tilt, /state.
        tracked = torch.cat([o.tracked.valid for o in captured]).sum(-1)
        tilt = torch.cat([o.contact.tilt_deg for o in captured])
        if (len(captured) != -(-n_live // batch) or int(tracked.numel())
                != n_live or "skipped" in text):
            raise AssertionError(f"serve: run-live ran {len(captured)} "
                                 f"chunks, {tracked.numel()} frames:\n{text}")
        if int(tracked.min()) != 65 or not bool(torch.isfinite(tilt).all()):
            raise AssertionError(f"serve: tracked min {int(tracked.min())}, "
                                 f"tilt finite {bool(torch.isfinite(tilt).all())}")
        last = publish.contact_state_payload(captured[-1].contact, -1, n_live)
        if payloads[-1] != last or served[-1] != dict(last,
                                                      seq=len(captured)):
            raise AssertionError(f"serve: /state served {served[-1]}, the "
                                 f"last chunk's payload is {last}")
        # The port's numpy encoder on the served frames (the server takes
        # cv2 where this host has it).
        from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg
        cam = cserver.SyntheticCamera(cap, default_scene(cap.height,
                                                         cap.width,
                                                         device=dev))
        grays = [cam.read()[..., 0] for _ in range(8)]
        t = time.perf_counter()
        for g in grays:
            encode_jpeg(g, cap.jpeg_quality)
        rec["numpy_encode_ms"] = 1e3 * (time.perf_counter() - t) / len(grays)
        gaps = [1e3 * (b - a) for a, b in zip(published, published[1:])]
        rec.update(tracked_min=int(tracked.min()),
                   tilt_deg=[float(tilt.min()), float(tilt.max())],
                   state=served[-1],
                   render_ms=statistics.median(renders),
                   encode_ms=statistics.median(encodes),
                   published_interval_ms=statistics.median(gaps),
                   renders=len(renders), published=len(published),
                   jpeg_bytes=sum(map(len, got)) / len(got))
        print(f"serve: record {n_rec} frames, {rec['recorded_distinct']} "
              f"distinct, each a {cap.width}x{cap.height} JPEG the native "
              f"decoder reads; run-live --tpu-decode --publish over {n_live} "
              f"frames in chunks of {batch}: tracked per frame min "
              f"{rec['tracked_min']}, tilt {rec['tilt_deg']} deg, /state "
              f"{served[-1]}; server threads ended [{card}]", flush=True)
        print(f"serve: capture thread per frame (median): render "
              f"{rec['render_ms']:.2f} ms on the card, encode "
              f"{rec['encode_ms']:.2f} ms ("
              f"{'cv2' if cserver._video._cv2() else 'the numpy encoder'} "
              f"on this host, {rec['jpeg_bytes']:.0f} B; the port's numpy "
              f"encoder {rec['numpy_encode_ms']:.2f} ms), published every "
              f"{rec['published_interval_ms']:.1f} ms with skip_frames "
              f"{cap.skip_frames}, beside the camera's "
              f"{rec['frame_budget_ms']:.1f} ms at {cap.fps} fps "
              f"({len(published)} published, {len(renders)} renders) "
              f"[{card}]", flush=True)
        return rec

    def extras_phase(workdir, recon4):
        """Phase 11b: the library extras on the card against the same calls
        on the CPU, with no kernel launched; profile_to's trace of one
        batch holding the program's spans."""
        from vision_basedsensor_tpu_torch.analysis.dynamics import \
            contact_signal
        from vision_basedsensor_tpu_torch.core.fit import ellipse_from_moments
        from vision_basedsensor_tpu_torch.core.imaging import box_sum
        from vision_basedsensor_tpu_torch.pipeline import _to
        from vision_basedsensor_tpu_torch.utils.profiling import profile_to

        b = EXTRAS_BATCH
        scene, frames = render(480, 640, b)
        # A second input for the continuous NCC: the stream's distorted
        # camera (phase 6).
        _, frames_dist = render(480, 640, b, dist=np.asarray(STREAM[2]))
        cpu = torch.device("cpu")
        ys, xs = torch.meshgrid(torch.arange(480.0, device=dev),
                                torch.arange(640.0, device=dev),
                                indexing="ij")
        # Dark marker pixels as weights over each frame's pixels.
        wts = ((frames < 115).float().reshape(b, -1), xs.reshape(-1),
               ys.reshape(-1))
        prof = dcfg.low_res
        calls = {
            # name: (function of a device, tolerance as (rtol, atol))
            "ellipse_from_moments": (lambda d: ellipse_from_moments(
                *(t.to(d) for t in wts)), (1e-4, 1e-3)),
            "box_sum": (lambda d: box_sum(frames.to(d), 9), (1e-5, 1e-2)),
            # The local variance box(m^2) - box(m)^2 / n cancels: box(m^2)
            # reaches ~1e6 on 0..255 frames, so float32 filter sums in
            # another order (cuBLAS, the CPU's GEMM) move var_n by ~0.1 and
            # a score by up to ~0.1 / (2 var_n) above the 0.5 floor. The
            # reference holds this path to its FFT oracle within 2e-3 on
            # 0/1 masks (tests/test_ops.py:29-39).
            "normxcorr_gaussian(binary_input=False)": (
                lambda d: normxcorr_gaussian(
                    frames.to(d), prof.template_size, prof.template_sigma,
                    binary_input=False), (0.0, 1e-2)),
            "normxcorr_gaussian(binary_input=False), distorted camera": (
                lambda d: normxcorr_gaussian(
                    frames_dist.to(d), prof.template_size,
                    prof.template_sigma, binary_input=False), (0.0, 1e-2)),
            "contact_signal": (lambda d: contact_signal(_to(recon4, d)),
                               (1e-5, 1e-5)),
        }
        rec: dict = {"batch": b, "checks": {}}
        for name, (fn, (rtol, atol)) in calls.items():
            torch.cuda.synchronize()
            reset_launch_counts()
            got = fn(dev)
            torch.cuda.synchronize()
            launches = launch_counts()
            want = fn(cpu)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err, worst = 0.0, 0.0
            for a, w in zip(got, want):
                a, w = a.cpu().double(), w.double()
                d = (a - w).abs()
                err = max(err, float(d.max()))
                worst = max(worst, float((d - atol - rtol * w.abs()).max()))
            rec["checks"][name] = {"max_abs_err": err, "rtol": rtol,
                                   "atol": atol, "launches": launches}
            print(f"extras: {name} on the card vs the CPU: max abs err {err} "
                  f"(rtol {rtol}, atol {atol}); launches {launches} "
                  f"[{card}]", flush=True)
            if worst > 0 or any(launches.values()):
                raise AssertionError(f"extras: {name} beyond its tolerance "
                                     f"or launched a kernel")
        ref = initialize(frames[0], cfg)
        process_frames(frames, ref, scene.cam, cfg)           # warm-up
        logdir = os.path.join(workdir, "trace")
        with profile_to(logdir) as prof_:
            process_frames(frames, ref, scene.cam, cfg)
            torch.cuda.synchronize()
        with open(os.path.join(logdir, "trace.json")) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        dev_ms = sum(e.device_time_total for e in prof_.key_averages()) / 1e3
        span = "vbs.pipeline.process_frames"
        rec.update(trace_has_annotation=span in names,
                   trace_device_ms=dev_ms)
        print(f"extras: one {b}-frame batch under the profiler: profile_to "
              f"wrote {os.path.getsize(os.path.join(logdir, 'trace.json'))} "
              f"B with the span {span in names}, device time "
              f"{dev_ms:.2f} ms [{card}]", flush=True)
        if span not in names or dev_ms <= 0:
            raise AssertionError("extras: the trace lacks the annotation or "
                                 "device time")
        return rec

    def detections_as_sets(a, b, what, tol=1e-3):
        """Each frame's valid detections of ``a`` and ``b`` as sets: equal
        counts, and each of ``b``'s within ``tol`` px of one of ``a``'s
        (equal scores may order slots differently)."""
        if not torch.equal(a.valid.sum(-1), b.valid.sum(-1)):
            raise AssertionError(f"{what}: valid counts differ")
        # The exact distances: cdist's matmul form loses ~0.1 px to
        # cancellation at coordinates of a few hundred.
        d = torch.cdist(b.xy, a.xy,
                        compute_mode="donot_use_mm_for_euclid_dist")
        d = torch.where(a.valid[:, None, :], d, torch.full_like(d, 1e9))
        near = d.min(-1).values[b.valid]
        dmax = float(near.max()) if near.numel() else 0.0
        if dmax > tol:
            raise AssertionError(f"{what}: a detection {dmax} px from its "
                                 "nearest")
        return dmax

    def multi_phase():
        """Phase 11c: the data-parallel step (parallel/) over every visible
        card, or two shards on one card, against single-device
        process_frames; with_carry in two chunks; sequential association on
        the undistorted stream; ShardedPackedFeed per transport; fps in
        turns."""
        from vision_basedsensor_tpu_torch.detect.detector import Detections
        from vision_basedsensor_tpu_torch.parallel import (
            ShardedPackedFeed, make_mesh, make_sharded_pipeline, shard_frames)
        from vision_basedsensor_tpu_torch.reconstruct.displacement import \
            initial_carry

        n_dev = torch.cuda.device_count()
        mesh = make_mesh() if n_dev >= 2 else make_mesh([dev, dev])
        n_sh = len(mesh.devices)
        rec: dict = {"device_count": n_dev,
                     "mesh": [str(d) for d in mesh.devices]}
        print(f"multi: torch.cuda.device_count() {n_dev}; mesh "
              f"{rec['mesh']} ({'every visible card' if n_dev >= 2 else 'two shards in turn on one card'}) "
              f"[{card}]", flush=True)
        det_names = {f"detections.{k}" for k in Detections._fields}

        def close(out, base, what):
            if not torch.equal(out.recon.seen, base.recon.seen):
                raise AssertionError(f"{what}: seen differs")
            errs = {k: float((getattr(out.recon, k)
                              - getattr(base.recon, k)).abs().max())
                    for k in ("world", "cum_path")}
            if max(errs.values()) > 1e-4:
                raise AssertionError(f"{what}: beyond 1e-4: {errs}")
            return errs

        def counted(fn):
            torch.cuda.synchronize()
            reset_launch_counts()
            r = fn()
            torch.cuda.synchronize()
            return r, launch_counts()

        def expect(counts, what, **want):
            bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
            if bad:
                raise AssertionError(f"{what}: launches {counts}, expected "
                                     f"{want}")

        # -- the main path's batch -------------------------------------------
        b = MULTI_BATCH
        scene, frames = render(480, 640, b)
        ref = initialize(frames[0], cfg)
        base = process_frames(frames, ref, scene.cam, cfg)
        step = make_sharded_pipeline(mesh, scene.cam, cfg)
        step(shard_frames(frames[:2 * n_sh], mesh), ref)    # warm-up
        out, counts = counted(lambda: step(shard_frames(frames, mesh), ref))
        expect(counts, "multi", fields=n_sh, gather=n_sh, scan=1,
               filters=2 * n_sh)
        per_shard = step.last_shard_launches
        if any((c["fields"], c["gather"], c["filters"]) != (1, 1, 2) or
               sum(c.values()) != 4 for c in per_shard):
            raise AssertionError(f"multi: per-shard launches {per_shard}")
        errs = close(out, base, "multi")
        dxy = detections_as_sets(out.detections, base.detections,
                                 "multi detections")
        names = {t["name"] for t in step.last_transfers}
        if not names <= det_names | {"ref.axis_scale"}:
            raise AssertionError(f"multi: transfers {names}")
        moved = {}
        for t in step.last_transfers:
            moved[t["name"]] = moved.get(t["name"], 0) + t["bytes"]
        tracked = out.tracked.valid.sum(-1)
        if int(tracked.min()) != 65:
            raise AssertionError(f"multi: tracked min {int(tracked.min())}")
        rec.update(batch=b, launches=counts, per_shard=per_shard,
                   max_abs_err=errs, detections_max_px=dxy,
                   transfer_bytes=moved,
                   transfer_total=sum(moved.values()),
                   frame_bytes=frames.numel() * frames.element_size())
        print(f"multi: {b}x480x640 over {n_sh} shards == process_frames "
              f"(seen equal, max |d| {errs}, detections as sets within "
              f"{dxy} px), 65/65 markers; launches {counts}, per shard "
              f"{per_shard}; the only copies between shard and gather "
              f"device: {moved} = {rec['transfer_total']} B "
              f"(the frames: {rec['frame_bytes']} B) [{card}]", flush=True)

        # -- with_carry, two chunks ------------------------------------------
        stepc = make_sharded_pipeline(mesh, scene.cam, cfg, with_carry=True)
        half = b // 2
        o1, carry = stepc(shard_frames(frames[:half], mesh), ref,
                          initial_carry(65, device=dev))
        o2, _ = stepc(shard_frames(frames[half:], mesh), ref, carry)
        cum = torch.cat([o1.recon.cum_path, o2.recon.cum_path])
        seen = torch.cat([o1.recon.seen, o2.recon.seen])
        cerr = float((cum - base.recon.cum_path).abs().max())
        if (not torch.equal(seen, base.recon.seen) or cerr > 1e-4
                or stepc.frames_seen != b):
            raise AssertionError(f"multi with_carry: cum_path {cerr}, "
                                 f"frames_seen {stepc.frames_seen}")
        rec["with_carry_cum_err"] = cerr
        print(f"multi: with_carry in two chunks of {half} == one batch "
              f"(cum_path max |d| {cerr}, frames_seen {stepc.frames_seen})",
              flush=True)

        # -- fps in turns ------------------------------------------------------
        def single():
            process_frames(frames, ref, scene.cam, cfg)

        def sharded():
            step(shard_frames(frames, mesh), ref)

        s_1 = _wall_s(single, 2)
        s_n = _wall_s(sharded, 2)
        s_n += _wall_s(sharded, 2)
        s_1 += _wall_s(single, 2)
        rec.update(fps_single=b / statistics.median(s_1),
                   fps_sharded=b / statistics.median(s_n),
                   s_single=s_1, s_sharded=s_n)
        print(f"multi: fps sharded ({n_sh} shards) {rec['fps_sharded']:.1f} "
              f"(s " + ", ".join(f"{t:.4f}" for t in s_n) + f"), single "
              f"device {rec['fps_single']:.1f} (s "
              + ", ".join(f"{t:.4f}" for t in s_1) + f") [{card}]",
              flush=True)

        def issue_ms(fn):
            """Host ms until ``fn()`` returns (its work issued) and until
            every card of the mesh is done; medians of three."""
            ret, done = [], []
            for _ in range(3):
                for d in set(mesh.devices):
                    torch.cuda.synchronize(d)
                t = time.perf_counter()
                fn()
                ret.append(1e3 * (time.perf_counter() - t))
                for d in set(mesh.devices):
                    torch.cuda.synchronize(d)
                done.append(1e3 * (time.perf_counter() - t))
            return statistics.median(ret), statistics.median(done)

        block = shard_frames(frames, mesh).blocks[0]

        def detect_block():
            detector.detect_markers(block, cfg.detect,
                                    axis_scale=ref.axis_scale)

        rec["issue_ms"] = {
            "single": issue_ms(single), "sharded": issue_ms(sharded),
            "detect_one_shard": issue_ms(detect_block)}
        print(f"multi: host ms until the call returns / until the device "
              f"is done: single {rec['issue_ms']['single']}, sharded "
              f"{rec['issue_ms']['sharded']}, one shard's detect "
              f"({b // n_sh} frames) {rec['issue_ms']['detect_one_shard']} "
              f"[{card}]", flush=True)
        # The shards overlap only if detect never makes the host wait for
        # its card: every synchronizing call PyTorch knows of is reported.
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                detect_block()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [f"{w.filename}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]
        rec["detect_syncs"] = syncs
        print(f"multi: synchronizing calls in one shard's detect: "
              f"{len(syncs)} {syncs}", flush=True)
        if syncs:
            raise AssertionError(f"multi: detect waits for its card at "
                                 f"{syncs}")
        del block
        del frames, base, out, o1, o2
        torch.cuda.empty_cache()

        # -- sequential association on the undistorted stream ------------------
        n, _, dist = STREAM
        sscene, sframes = render(480, 640, n, dist=np.asarray(dist))
        scfg = PipelineConfig(
            undistort_frames=True,
            track=TrackConfig(association_mode="sequential"),
            reconstruct=ReconstructConfig(warmup_frames=0))
        src_map, new_cam = prepare_undistortion(sscene.cam, 480, 640, scfg)
        sref = initialize(sframes[0], scfg, rectify_map=src_map)
        sbase = process_frames(sframes, sref, new_cam, scfg,
                               rectify_map=src_map)
        sstep = make_sharded_pipeline(mesh, sscene.cam, scfg)
        sout, counts = counted(lambda: sstep(shard_frames(sframes, mesh),
                                             sref))
        expect(counts, "multi sequential", fields=n_sh, gather=n_sh, scan=1,
               filters=2 * n_sh,
               associate=1)
        rec["sequential"] = {"launches": counts,
                             "max_abs_err": close(sout, sbase,
                                                  "multi sequential")}
        if not torch.equal(sout.tracked.valid, sbase.tracked.valid):
            raise AssertionError("multi sequential: tracked.valid differs")
        print(f"multi: sequential association on the {n}-frame undistorted "
              f"stream == process_frames (max |d| "
              f"{rec['sequential']['max_abs_err']}); launches {counts}",
              flush=True)
        del sframes, sbase, sout
        torch.cuda.empty_cache()

        # -- ShardedPackedFeed ---------------------------------------------------
        jpegs = live_jpegs[:MULTI_FEED]
        rec["feed"] = {}
        dec = tj.MjpegBatchDecoder(device=dev)
        for tr in ("tdelta", "split", "packed"):
            single_x, k1 = counted(lambda: getattr(dec, f"{tr}_to_device")(
                getattr(dec, f"entropy_decode_{tr}")(jpegs)))
            feed = ShardedPackedFeed(mesh, transport=tr)
            sh, kn = counted(lambda: feed.decode_packed(jpegs))
            expect(kn, f"multi feed {tr}",
                   expand_sorted=n_sh * k1["expand_sorted"])
            if not torch.equal(torch.cat([x.to(dev) for x in sh.blocks]),
                               single_x):
                raise AssertionError(f"multi feed {tr}: frames differ from "
                                     "the single-device decode")
            rec["feed"][tr] = {"launches": kn,
                               "single_launches": k1["expand_sorted"]}
            print(f"multi: ShardedPackedFeed {tr} over {len(jpegs)} JPEGs "
                  f"bitwise equal to the single-device decode; expand "
                  f"launches {kn['expand_sorted']} ({k1['expand_sorted']} "
                  f"a decode call, {n_sh} shards)", flush=True)
        return rec

    def spatial_phase():
        """Phase 11d: the spatial (row-sharded) mesh axis (parallel/
        spatial.py). On one card the meshes [cuda:0] * 2 at spatial=2 and
        [cuda:0] * 4 as data 2 x spatial 2; on several cards every visible
        card at spatial=2 and, with four, at spatial=4. Each mesh takes
        the 1080x1920 frames at SPATIAL_HIGH's batch (high-res profile), a
        mesh with a data axis of 2 or more also the 640x480 frames at
        SPATIAL_LOW's batch and ShardedPackedFeed over SPATIAL_FEED of the
        ingest's JPEGs. Checks against process_frames of the same frames on
        the same card with backend="xla": seen equal, world and cum_path
        within 1e-4, detections as sets within 1e-2 px; the window-sums
        kernel once a row shard, the scan once; no synchronizing call in
        the row shards' detect. Prints the DoG-mask pixels that differ from
        the single-device mask, the halo bytes a shard against its frame
        rows' bytes, and the latency of one 1080x1920 frame (B=1, p50/p99
        of SPATIAL_REQUESTS) at spatial=1 and spatial=s."""
        from vision_basedsensor_tpu_torch.core.imaging import to_grayscale
        from vision_basedsensor_tpu_torch.parallel import (
            ShardedPackedFeed, make_mesh, make_sharded_pipeline, shard_frames)
        from vision_basedsensor_tpu_torch.parallel import spatial as psp

        n_dev = torch.cuda.device_count()
        if n_dev >= 2:
            devs = [torch.device("cuda", i) for i in range(n_dev)]
            meshes = [make_mesh(devs, spatial=2)]
            if n_dev == 4:
                meshes.append(make_mesh(devs, spatial=4))
        else:
            meshes = [make_mesh([dev] * 2, spatial=2),
                      make_mesh([dev] * 4, spatial=2)]
        xcfg = dataclasses.replace(cfg, detect=dataclasses.replace(
            dcfg, backend="xla"))
        rec: dict = {"device_count": n_dev, "runs": {}}

        def shape_of(mesh):
            return f"{len(mesh.grid)}x{mesh.spatial}"

        def devices_of(mesh):
            return sorted({d for row in mesh.grid for d in row}, key=str)

        def sync_all(mesh):
            for d in devices_of(mesh):
                torch.cuda.synchronize(d)

        def counted(fn, mesh):
            sync_all(mesh)
            reset_launch_counts()
            r = fn()
            sync_all(mesh)
            return r, launch_counts()

        def close(out, base, what):
            if not torch.equal(out.recon.seen, base.recon.seen):
                raise AssertionError(f"{what}: seen differs")
            errs = {k: float((getattr(out.recon, k)
                              - getattr(base.recon, k)).abs().max())
                    for k in ("world", "cum_path")}
            if max(errs.values()) > 1e-4:
                raise AssertionError(f"{what}: beyond 1e-4: {errs}")
            return errs

        def dog_flips(frames, mesh, plan, prof):
            """DoG-mask pixels of the row blocks' own rows (the shards'
            shapes: each data group's frames, each block's rows) that differ
            from the whole frame's mask."""
            per = -(-frames.shape[0] // len(mesh.grid))
            flips = 0
            for i in range(len(mesh.grid)):
                gray = to_grayscale(frames[i * per:(i + 1) * per],
                                    dcfg.channel_order)
                full = dog_area_mask(gray, prof, dcfg.dog_offset)
                for blk in plan.blocks:
                    (a, b), (o0, o1) = blk.block, blk.own
                    part = dog_area_mask(gray[:, a:b], prof, dcfg.dog_offset)
                    flips += int((part[:, o0 - a:o1 - a]
                                  != full[:, o0:o1]).sum())
            return flips

        def run(mesh, h, w, batch, what):
            scene, frames = render(h, w, batch)
            ref = initialize(frames[0], xcfg)
            base = process_frames(frames, ref, scene.cam, xcfg)
            step = make_sharded_pipeline(mesh, scene.cam, cfg)
            step(shard_frames(frames[:len(mesh.grid)], mesh), ref)  # warm-up
            out, counts = counted(
                lambda: step(shard_frames(frames, mesh), ref), mesh)
            n_sh = len(mesh.grid) * mesh.spatial
            expect = {"window_sums": n_sh, "scan": 1, "filters": 2 * n_sh}
            if {k: v for k, v in counts.items() if v} != expect:
                raise AssertionError(f"spatial {what}: launches {counts}, "
                                     f"expected {expect}")
            per_shard = step.last_shard_launches
            if any(c["window_sums"] != 1 or c["filters"] != 2
                   or sum(c.values()) != 3
                   for c in per_shard) or len(per_shard) != n_sh:
                raise AssertionError(f"spatial {what}: per-shard launches "
                                     f"{per_shard}")
            errs = close(out, base, f"spatial {what}")
            dxy = detections_as_sets(out.detections, base.detections,
                                     f"spatial {what} detections", tol=1e-2)
            plan = psp.row_plan(h, w, mesh.spatial, cfg, False)
            flips = dog_flips(frames, mesh, plan, plan.profile)
            halo = {}
            for t in step.last_transfers:
                if t["name"] == "halo":
                    key = str(tuple(t["shard"]))
                    halo[key] = halo.get(key, 0) + t["bytes"]
            per = -(-batch // len(mesh.grid))
            own_bytes = per * (h // mesh.spatial) * w * frames.element_size()
            tracked = int(out.tracked.valid.sum(-1).min())
            if tracked != 65:
                raise AssertionError(f"spatial {what}: tracked min {tracked}")

            def single():
                process_frames(frames, ref, scene.cam, xcfg)

            def sharded():
                step(shard_frames(frames, mesh), ref)

            s_1, s_n = _wall_s(single, 2), _wall_s(sharded, 2)
            s_n += _wall_s(sharded, 2)
            s_1 += _wall_s(single, 2)
            r = {"mesh": shape_of(mesh), "profile_patch": plan.profile.patch_size,
                 "halo_rows": plan.halo, "launches": counts,
                 "per_shard": per_shard, "max_abs_err": errs,
                 "detections_max_px": dxy, "dog_flips": flips,
                 "dog_pixels": batch * h * w, "halo_bytes": halo,
                 "own_rows_bytes": own_bytes,
                 "frame_bytes": frames.numel() * frames.element_size(),
                 "fps_single": batch / statistics.median(s_1),
                 "fps_spatial": batch / statistics.median(s_n),
                 "s_single": s_1, "s_spatial": s_n,
                 "blocks": [list(b.block) for b in plan.blocks]}
            print(f"spatial {what} on a {shape_of(mesh)} mesh "
                  f"({[str(d) for d in devices_of(mesh)]}): == process_frames "
                  f"backend=xla (seen equal, max |d| {errs}, detections as "
                  f"sets within {dxy} px), 65/65 markers; launches {counts}, "
                  f"per shard {per_shard[0]}; DoG pixels differing from the "
                  f"single-device mask: {flips} of {batch * h * w}; halo "
                  f"rows {plan.halo}, blocks {r['blocks']}; halo bytes a "
                  f"shard {halo} against its own rows' {own_bytes} B "
                  f"(frames {r['frame_bytes']} B); fps spatial "
                  f"{r['fps_spatial']:.1f} (s "
                  + ", ".join(f"{t:.4f}" for t in s_n) + f"), single device "
                  f"{r['fps_single']:.1f} (s "
                  + ", ".join(f"{t:.4f}" for t in s_1) + f") [{card}]",
                  flush=True)
            return r, scene, frames, ref

        def no_sync(mesh, frames, ref):
            """The row shards' detect under set_sync_debug_mode: every
            synchronizing call PyTorch knows of is reported."""
            sharded = shard_frames(frames, mesh)
            h, w = frames.shape[1:3]
            plan = psp.row_plan(h, w, mesh.spatial, cfg, False)
            s = mesh.spatial
            blocks = [sharded.blocks[i * s:(i + 1) * s]
                      for i in range(len(mesh.grid))]
            scales = [ref.axis_scale.to(row[0]) for row in mesh.grid]
            maps = [[None] * s for _ in mesh.grid]

            def go():
                psp.detect_row_shards(blocks, mesh.grid, h // s, plan, cfg,
                                      scales, maps,
                                      lambda x, d, *a: x.to(d))
            go()
            sync_all(mesh)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    go()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs = [f"{w.filename}:{w.lineno}" for w in caught
                     if "synchroniz" in str(w.message)]
            print(f"spatial: synchronizing calls in the row shards' detect "
                  f"({shape_of(mesh)}): {len(syncs)} {syncs}", flush=True)
            if syncs:
                raise AssertionError(f"spatial: detect waits at {syncs}")
            return syncs

        def latency(mesh, scene, frames, ref):
            """One 1080x1920 frame a request: host uint8 -> the card(s) ->
            the step (or process_frames) -> the last frame's tilt on the
            host; SPATIAL_REQUESTS requests, p50/p99 (nearest rank)."""
            u8 = frames.to(torch.uint8).cpu()
            one = make_mesh([mesh.home])
            steps = {"process_frames": None,
                     "spatial=1": make_sharded_pipeline(one, scene.cam, xcfg),
                     f"spatial={mesh.spatial}": make_sharded_pipeline(
                         mesh, scene.cam, cfg)}
            meshes = {"spatial=1": one, f"spatial={mesh.spatial}": mesh}

            def request(label, i):
                x = u8[i % u8.shape[0]:i % u8.shape[0] + 1]
                if steps[label] is None:
                    out = process_frames(x.to(dev).float(), ref, scene.cam,
                                         xcfg)
                else:
                    out = steps[label](shard_frames(x, meshes[label]), ref)
                return out.contact.tilt_deg[-1].item()

            res = {}
            for _ in range(2):              # in turns: a, b, c, c, b, a
                for label in (list(steps) if not res else
                              list(reversed(list(steps)))):
                    request(label, 0)       # warm-up, not timed
                    times = []
                    for i in range(SPATIAL_REQUESTS):
                        t = time.perf_counter()
                        tilt = request(label, i)
                        times.append(time.perf_counter() - t)
                        if not math.isfinite(tilt):
                            raise AssertionError(f"spatial {label}: tilt "
                                                 f"{tilt}")
                    res.setdefault(label, []).extend(times)
            out = {}
            for label, times in res.items():
                times.sort()

                def rank(q):
                    return 1e3 * times[math.ceil(q * len(times)) - 1]

                out[label] = {"p50_ms": rank(0.5), "p99_ms": rank(0.99),
                              "min_ms": 1e3 * times[0],
                              "max_ms": 1e3 * times[-1],
                              "requests": len(times)}
                print(f"spatial: one 1080x1920 frame a request, {label} "
                      f"({shape_of(mesh) if label != 'process_frames' else 'one card'}): "
                      f"p50 {out[label]['p50_ms']:.3f} ms, p99 "
                      f"{out[label]['p99_ms']:.3f} ms, min "
                      f"{out[label]['min_ms']:.3f}, max "
                      f"{out[label]['max_ms']:.3f} over {len(times)} "
                      f"requests [{card}]", flush=True)
            return out

        for mesh in meshes:
            key = shape_of(mesh)
            r, scene, frames, ref = run(mesh, 1080, 1920, SPATIAL_HIGH,
                                        f"{SPATIAL_HIGH}x1080x1920 {key}")
            rec["runs"][f"1080x1920 {key}"] = r
            if len(mesh.grid) == 1:
                r["detect_syncs"] = no_sync(mesh, frames[:4], ref)
                rec[f"latency {key}"] = latency(mesh, scene, frames, ref)
            del scene, frames, ref
            torch.cuda.empty_cache()
            if len(mesh.grid) < 2:
                continue
            r, scene, frames, ref = run(mesh, 480, 640, SPATIAL_LOW,
                                        f"{SPATIAL_LOW}x480x640 {key}")
            rec["runs"][f"480x640 {key}"] = r
            del scene, frames, ref
            # ShardedPackedFeed: each data group's payload decoded on its
            # first device (the expand kernel as often as one decode call
            # launches it), the rows copied out to the group's devices.
            jpegs = live_jpegs[:SPATIAL_FEED]
            dec = tj.MjpegBatchDecoder(device=dev)
            s = mesh.spatial
            for tr in ("tdelta", "split", "packed"):
                single_x, k1 = counted(lambda: getattr(
                    dec, f"{tr}_to_device")(getattr(
                        dec, f"entropy_decode_{tr}")(jpegs)), mesh)
                feed = ShardedPackedFeed(mesh, transport=tr)
                sh, kn = counted(lambda: feed.decode_packed(jpegs), mesh)
                want = len(mesh.grid) * k1["expand_sorted"]
                if {k: v for k, v in kn.items() if v} != {
                        "expand_sorted": want}:
                    raise AssertionError(f"spatial feed {tr} {key}: launches "
                                         f"{kn}, expected expand {want}")
                got = torch.cat([torch.cat([b.to(dev) for b in
                                            sh.blocks[i * s:(i + 1) * s]], 1)
                                 for i in range(len(mesh.grid))])
                if not torch.equal(got, single_x):
                    raise AssertionError(f"spatial feed {tr} {key}: frames "
                                         "differ from the single-device "
                                         "decode")
                rec["runs"][f"feed {tr} {key}"] = {
                    "launches": kn, "single_launches": k1}
                print(f"spatial: ShardedPackedFeed {tr} over {len(jpegs)} "
                      f"JPEGs on a {key} mesh bitwise equal to the "
                      f"single-device decode; expand launches "
                      f"{kn['expand_sorted']} ({k1['expand_sorted']} a "
                      f"decode call, {len(mesh.grid)} data groups)",
                      flush=True)
            # The step takes the last feed's blocks where they lie.
            fcam = default_scene(480, 640, device=dev).cam
            ref = initialize(single_x[0], xcfg)
            fstep = make_sharded_pipeline(mesh, fcam, cfg)
            fout, k_step = counted(lambda: fstep(sh, ref), mesh)
            if {k: v for k, v in k_step.items() if v} != {
                    "window_sums": len(mesh.grid) * s, "scan": 1,
                    "filters": 2 * len(mesh.grid) * s}:
                raise AssertionError(f"spatial feed {key}: step launches "
                                     f"{k_step}")
            ferr = close(fout, process_frames(single_x, ref, fcam, xcfg),
                         f"spatial feed {key}")
            rec["runs"][f"feed step {key}"] = {"launches": k_step,
                                               "max_abs_err": ferr}
            print(f"spatial: the step on the packed feed's blocks launched "
                  f"{k_step}, == process_frames (max |d| {ferr})",
                  flush=True)
            del single_x, sh, got, fout
            torch.cuda.empty_cache()
        return rec

    def serve_jpegs(jpegs):
        """A localhost MJPEG server (multipart/x-mixed-replace with
        Content-Length) that sends ``jpegs`` once a request; returns the
        server and its URL."""
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type",
                                 "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                try:
                    for jb in jpegs:
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(jb)}\r\n\r\n".encode()
                            + jb + b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass

        srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv, f"http://127.0.0.1:{srv.server_address[1]}/stream"

    def live_loop(workdir, run_pose):
        """record and run-live --tpu-decode --publish 0 --resume on the
        ingest's first JPEGs served on localhost: the recording byte-equal
        to the served JPEGs; each chunk's outputs equal to
        StreamingPipeline.process over MjpegBatchDecoder's TDELTA decode of
        the same chunk; /state, read over HTTP after each update while the
        session runs, equal to the chunk's payload; the session reloads
        with the frame count."""
        import urllib.request

        from vision_basedsensor_tpu_torch.io import publish
        from vision_basedsensor_tpu_torch.io.session import load_session
        from vision_basedsensor_tpu_torch.io.video import \
            _iter_avi_video_chunks

        n, batch = LIVE
        jpegs = live_jpegs[:n]
        rec: dict = {"frames": n, "batch": batch}
        srv, url = serve_jpegs(jpegs)
        captured, served, payloads = [], [], []
        process = StreamingPipeline.process
        update = publish.StatePublisher.update

        def process_spy(self, frames):
            out = process(self, frames)
            captured.append(out)
            return out

        def update_spy(self, state):
            update(self, state)
            payloads.append(state)
            with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/state",
                                        timeout=30) as r:
                served.append(json.loads(r.read()))

        try:
            avi = os.path.join(workdir, "live.avi")
            run_pose("record", ["record", url, avi, "--max-frames", str(n)],
                     set())
            with open(avi, "rb") as f:
                if list(_iter_avi_video_chunks(f.read())) != jpegs:
                    raise AssertionError("pose: the recording's payloads "
                                         "differ from the served JPEGs")
            sess = os.path.join(workdir, "live_session")
            StreamingPipeline.process = process_spy
            publish.StatePublisher.update = update_spy
            try:
                text, rec["run_live_s"], _ = run_pose(
                    "run-live --tpu-decode",
                    ["run-live", url, "--tpu-decode", "--publish", "0",
                     "--resume", sess, "--batch", str(batch), "--max-frames",
                     str(n)], {"expand_sorted", "fields", "gather", "scan",
                              "filters"})
            finally:
                StreamingPipeline.process = process
                publish.StatePublisher.update = update
        finally:
            srv.shutdown()
            srv.server_close()
        if "skipped" in text or len(captured) != -(-n // batch):
            raise AssertionError(f"pose: run-live ran {len(captured)} chunks "
                                 f"or dropped frames:\n{text}")

        # The same frames decoded by MjpegBatchDecoder through process().
        dec = tj.MjpegBatchDecoder(device=dev)
        sp = StreamingPipeline(default_scene(480, 640, device=dev).cam,
                               PipelineConfig(), device=dev)
        lines = []
        for i, got in enumerate(captured):
            chunk = jpegs[i * batch:(i + 1) * batch]
            want = sp.process(dec.tdelta_to_device(
                dec.entropy_decode_tdelta(chunk)))
            for (name, x), (_, y) in zip(leaves(got, "out"),
                                         leaves(want, "out")):
                if not torch.equal(x, y):
                    raise AssertionError(f"pose: run-live chunk {i} {name} "
                                         "differs from process()")
            seen = want.recon.seen.cpu().numpy()
            ffn = want.recon.from_first_norm.cpu().numpy()
            lines.append(f"frames {sp.frames_seen}: tracked "
                         f"{int(seen[-1].sum())}/65 markers, mean "
                         f"displacement {float(ffn[seen].mean()):.3f} mm")
            state = publish.contact_state_payload(want.contact, -1,
                                                  sp.frames_seen)
            if served[i] != dict(state, seq=i + 1) or payloads[i] != state:
                raise AssertionError(f"pose: /state after chunk {i} served "
                                     f"{served[i]}, expected {state}")
        printed = [ln for ln in text.splitlines() if ln.startswith("frames ")]
        if printed != lines:
            raise AssertionError(f"pose: run-live printed {printed}, "
                                 f"process() gives {lines}")
        tracked = torch.cat([o.tracked.valid for o in captured]).sum(-1)
        loaded = load_session(sess, device=dev)
        if loaded.frames_seen != n or not torch.equal(loaded.ref.xy,
                                                      sp.ref.xy):
            raise AssertionError(f"pose: the saved session has frames_seen "
                                 f"{loaded.frames_seen} (expected {n}) or "
                                 "another reference table")
        rec.update(tracked_min=int(tracked.min()), state=served[-1],
                   printed=printed + [ln for ln in text.splitlines()
                                      if "transport" in ln])
        print(f"pose: record byte-equal ({n} JPEGs); run-live --tpu-decode "
              f"--publish over {n} frames in chunks of {batch} equal to "
              f"process() on MjpegBatchDecoder's frames, no drop, tracked "
              f"per frame min {rec['tracked_min']}; /state served "
              f"{served[-1]}; the session reloads with frames_seen {n} "
              f"[{card}]", flush=True)
        for ln in rec["printed"]:
            print(f"  run-live: {ln}")
        return rec

    def request_phase():
        """The cost of one request (bench.py:280-333): host uint8 frames ->
        the card -> process_frames -> the last frame's tilt back on the
        host, a distinct window of rendered frames each request, at each
        batch of REQUEST; B = 1 through the live transport (JPEG bytes ->
        entropy_decode_tdelta -> tdelta_to_device -> process_frames -> the
        tilt); and one B = 1 request of each under torch.profiler."""
        (batches, iters) = REQUEST
        scene, frames = render(480, 640, max(batches) + iters - 1)
        u8 = frames.to(torch.uint8).cpu().numpy()
        ref = initialize(frames[0], cfg)
        del frames
        dec = tj.MjpegBatchDecoder(device=dev)
        jpegs = live_jpegs[:iters]
        ref_t = initialize(dec.tdelta_to_device(
            dec.entropy_decode_tdelta(jpegs[:1]))[0], cfg)

        def request(i, b):
            x = torch.from_numpy(u8[i:i + b]).to(dev)
            out = process_frames(x.float(), ref, scene.cam, cfg)
            return out.contact.tilt_deg[-1].item()

        def request_tdelta(i):
            x = dec.tdelta_to_device(dec.entropy_decode_tdelta([jpegs[i]]))
            out = process_frames(x, ref_t, scene.cam, cfg)
            return out.contact.tilt_deg[-1].item()

        def timed(fn, label):
            fn(0)                                 # warm-up, not timed
            times = []
            for i in range(iters):
                t = time.perf_counter()
                tilt = fn(i)
                times.append(time.perf_counter() - t)
                if not math.isfinite(tilt):
                    raise AssertionError(f"request {label}: tilt {tilt}")
            times.sort()

            def rank(q):                  # nearest rank
                return 1e3 * times[math.ceil(q * len(times)) - 1]

            p = {"p50_ms": rank(0.5), "p99_ms": rank(0.99),
                 "max_ms": 1e3 * times[-1], "min_ms": 1e3 * times[0]}
            print(f"request {label}: p50 {p['p50_ms']:.3f} ms, p99 "
                  f"{p['p99_ms']:.3f} ms, max {p['max_ms']:.3f} ms, min "
                  f"{p['min_ms']:.3f} ms over {iters} requests [{card}]",
                  flush=True)
            return p

        rec: dict = {}
        for b in batches:
            rec[f"b{b}"] = timed(lambda i, b=b: request(i, b),
                                 f"host uint8 B={b}")
        rec["b1_tdelta"] = timed(request_tdelta, "TDELTA B=1")
        for key, fn in (("b1", lambda: request(0, 1)),
                        ("b1_tdelta", lambda: request_tdelta(0))):
            reset_launch_counts()
            fn()
            rec[key]["launches"] = launch_counts()
            rec[key]["profile"] = profile_batch(
                fn, f"request {key} (one request)",
                rec[key]["p50_ms"] / 1e3, host_top=15)
        return rec

    def fields_phase():
        """--only fields: the fields kernel (and each --baseline version)
        against the plain version and timed, without the pipeline."""
        bases = {os.path.basename(src): _build_alt(src, "vbs_fused_fields")
                 for src in args.baseline or ()}

        def run_base(fn, ncc, area, gray, prof):
            b, h, w = ncc.shape
            packed = torch.empty_like(ncc)
            cval = torch.empty((b, -(-h // 8), -(-w // 8)), device=dev)
            cidx = torch.empty(cval.shape, dtype=torch.int32, device=dev)
            build.check(fn(
                ncc.data_ptr(), area.data_ptr(), gray.data_ptr(),
                packed.data_ptr(), cval.data_ptr(), cidx.data_ptr(), b, h, w,
                dcfg.ncc_threshold, prof.band_window, prof.peak_window,
                dcfg.open_ksize, kf.halo(prof, dcfg.open_ksize),
                torch.cuda.current_stream(dev).cuda_stream),
                "baseline fields launch")
            return packed, cval, cidx

        def check_bases(ncc, area, gray, prof, what):
            want = fields_plain(ncc, area, gray, prof)
            for name, fn in bases.items():
                got = run_base(fn, ncc, area, gray, prof)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(
                        f"baseline {name} != plain at {what}: max abs err "
                        f"{max_err(got, want)}")
                print(f"check baseline {name} {what}: exact", flush=True)

        lo = dcfg.low_res
        _, fr = render(437, 467, 4)
        check_fields(*fields_inputs(fr, lo), lo, "4x437x467")
        check_bases(*fields_inputs(fr, lo), lo, "4x437x467")
        del fr
        rec: dict = {}
        n_it = 20
        for h, w, batches in ONLY_FIELDS:
            prof = profile_of(h)
            _, frames = render(h, w, max(batches))
            for b in batches:
                what = f"{b}x{h}x{w}"
                ncc, area, gray = fields_inputs(frames[:b], prof)
                _, err = check_fields(ncc, area, gray, prof, what)
                check_bases(ncc, area, gray, prof, what)
                # Turns: the baselines, the kernel twice, the baselines back.
                order = [*bases, "kernel", "kernel", *reversed(list(bases))]
                turns: dict = {who: [] for who in order}
                for who in order:
                    if who == "kernel":
                        def fn():
                            fields_kernel(ncc, area, gray, prof)
                    else:
                        def fn(f=bases[who]):
                            run_base(f, ncc, area, gray, prof)
                    turns[who].append(_event_ms(fn, n_it))
                ms = statistics.mean(turns["kernel"])
                plain_ms = _event_ms(lambda: fields_plain(ncc, area, gray,
                                                          prof), 3)
                bound = fields_bound(b, h, w, prof)
                rec[what] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound": bound, "turns_ms": turns}
                print(f"fields {what}: kernel {ms:.4f} ms, " + ", ".join(
                    f"{who} {statistics.mean(t):.4f} ms (turns {t})"
                    for who, t in turns.items())
                      + f"; plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms "
                      f"({bound[1]}), {100 * bound[0] / ms:.1f}% of bound "
                      f"[{card}]", flush=True)
                tiled = h * w > 960 * 1280
                record(f"{'fused_fields_tiled' if tiled else 'fused_fields'} "
                       f"{what}", "fields", SRC["fields"][2 if tiled else 1],
                       0, err, ms, plain_ms, bound)
                del ncc, area, gray
                torch.cuda.empty_cache()
            del frames
        return rec

    def ws_measure(what, fields, peaks, prof, versions, probes=None,
                   timed=True):
        """Each version of the window-sums C entry (``{name: fn}``, the
        current kernel as "kernel") on ``fields`` (band, area, gray, or the
        packed field alone) against the plain version (``sums_close``); then,
        if ``timed``, the versions and ``probes`` (timed only) in turns
        beside the plain version, the wrapper, the bound and the gated
        pixels."""
        geom = tm.cut_geometry(peaks)
        packed = len(fields) == 1
        b, h, w = fields[0].shape
        if packed:
            want = kw.window_sums_packed_reference(fields[0], peaks, geom, prof)
        else:
            want = tm.window_sums_xla(*fields, peaks, geom, prof)
        call, out = ws_entry(fields, peaks, geom, prof, f"window_sums {what}")
        errs = {}
        for name, fn in versions.items():
            got = call(fn, torch.empty_like(out))
            torch.cuda.synchronize()
            errs[name] = sums_close(got, want, peaks.valid,
                                    f"window_sums {name} {what}")
        if packed:
            got = kw.window_sums_packed(fields[0], peaks, geom, prof)
        else:
            got = kw.window_sums(*fields, peaks, geom, prof)
        torch.cuda.synchronize()
        if not torch.equal(got, call(versions["kernel"],
                                     torch.empty_like(out))):
            raise AssertionError(f"window_sums {what}: the wrapper's output "
                                 "differs from its C entry's")
        del got, want
        if not timed:
            return {"max_abs_err": errs}
        stats = window_stats(peaks, geom, prof, h, w)
        bound = sums_bound(stats, peaks.valid.numel(), prof, packed)
        n_it = 20 if b * h * w <= 2 ** 28 else 10
        others = [k for k in versions if k != "kernel"] + list(probes or ())
        order = [*others, "kernel", "kernel", *reversed(others)]
        fns = {**versions, **(probes or {})}
        turns: dict = {who: [] for who in order}
        for who in order:
            turns[who].append(_event_ms(lambda f=fns[who]: call(f), n_it))
        ms = statistics.mean(turns["kernel"])
        if packed:
            entry_ms = _event_ms(lambda: kw.window_sums_packed(
                fields[0], peaks, geom, prof), n_it)
            plain_ms = _event_ms(lambda: kw.window_sums_packed_reference(
                fields[0], peaks, geom, prof), 3)
        else:
            entry_ms = _event_ms(lambda: kw.window_sums(
                *fields, peaks, geom, prof), n_it)
            plain_ms = _event_ms(lambda: tm.window_sums_xla(
                *fields, peaks, geom, prof), 3)
        print(f"window_sums {what}: kernel {ms:.4f} ms, " + ", ".join(
            f"{who} {statistics.mean(t):.4f} ms ("
            f"{100 * bound[0] / statistics.mean(t):.1f}% of bound; turns {t})"
            for who, t in turns.items())
            + f"; wrapper with its patch-origin ops {entry_ms:.4f} ms; plain "
            f"{plain_ms:.3f} ms; bound {bound[0]:.4f} ms ({bound[1]}), "
            f"{100 * bound[0] / ms:.1f}% of bound; gated visits {stats[0]}, "
            f"distinct gated pixels {stats[1]} ({stats[0] / max(stats[1], 1):.3f}"
            f" visits a pixel), {stats[0] / peaks.valid.numel():.1f} a peak "
            f"[{card}]", flush=True)
        return {"max_abs_err": errs, "ms": ms, "turns_ms": turns,
                "entry_ms": entry_ms, "plain_ms": plain_ms, "bound": bound,
                "visits": stats[0], "distinct": stats[1]}

    def window_sums_only_phase():
        """--only window_sums: the window-sums kernel (and each --baseline
        version) against the plain version at 4x437x467, and checked and
        timed at each shape of ONLY_WS, with the first design's probes at
        the unfused one; no pipeline."""
        bases = {os.path.basename(src): _build_alt(src, "vbs_window_sums")
                 for src in args.baseline or ()}
        sig = build._SIGNATURES["vbs_window_sums"]
        probes = {f"probe {name}": _build_alt(WS_PROBES, f"vbs_ws_probe_{name}",
                                              sig)
                  for name in ("loads", "f32", "noreduce")}
        probes.update({f"probe {os.path.basename(src)}":
                       _build_alt(src, "vbs_window_sums")
                       for src in args.probe or ()})
        versions = {"kernel": build.library().vbs_window_sums, **bases}
        lo = dcfg.low_res
        rec: dict = {}
        _, fr = render(437, 467, 4)
        ncc, area, gray = fields_inputs(fr, lo)
        band, area_open, peaks = unfused_inputs(ncc, area, lo,
                                                dcfg.max_candidates)
        rec["4x437x467"] = ws_measure("4x437x467", (band, area_open, gray),
                                      peaks, lo, versions, timed=False)
        del fr, ncc, area, gray, band, area_open, peaks
        for h, w, batch, k, packed in ONLY_WS:
            prof = profile_of(h)
            what = f"{batch}x{h}x{w} K={k}" + (" packed" if packed else "")
            _, frames = render(h, w, batch)
            ncc, area, gray = fields_inputs(frames, prof)
            del frames
            if packed:      # as the fused branch and packed_phase give them
                fields, cval, cidx = fields_kernel(ncc, area, gray, prof)
                fields = (fields,)
                peaks = select_peaks_from_cells(cval, cidx, w, k,
                                                float(prof.peak_window))
                del cval, cidx
            else:           # as the unfused branch gives them
                band, area_open, peaks = unfused_inputs(ncc, area, prof, k)
                fields = (band, area_open, gray)
                del band, area_open
            del ncc, area, gray
            torch.cuda.empty_cache()
            r = rec[what] = ws_measure(what, fields, peaks, prof, versions,
                                       None if packed else probes)
            ratio = r["visits"] / max(r["distinct"], 1)
            record(f"{'window_sums_packed' if packed else 'window_sums'} "
                   f"{what}", "window_sums",
                   SRC["window_sums"][2 if packed else 1], 0,
                   r["max_abs_err"]["kernel"], r["ms"], r["plain_ms"],
                   r["bound"], visits_per_distinct=ratio)
            del fields, peaks
            torch.cuda.empty_cache()
        return rec

    def gather_measure(what, packed, peaks, prof, pack, versions, probes=None,
                       timed=True):
        """Each version of the gather C entry (``{name: fn}``, the current
        kernel as "kernel") and the wrapper equal to the plain version on
        every lane; then, if ``timed``, the versions and ``probes`` (timed
        only) on the C entry in GATHER_ROUNDS rounds of turns, beside the
        bound, the plain version, the wrapper, ``torch.gather`` and
        ``zero_``."""
        h, w = packed.shape[1:]
        p = prof.patch_size
        call, start, out = gather_entry(packed, peaks, prof, pack, what)
        want = kg.gather_windows_reference(packed, start, p, pack)
        for name, fn in versions.items():
            got = call(fn, torch.full_like(want, float("nan")))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"gather {name} pack={pack} != plain at "
                                     f"{what}: max abs err "
                                     f"{max_err([got], [want])}")
        got, gstart = kg.gather_windows(packed, peaks, None, prof, pack=pack)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(gstart, start)):
            raise AssertionError(f"gather wrapper pack={pack} != plain at "
                                 f"{what}")
        err = max_err([got], [want])
        print(f"check gather pack={pack} {what}: {', '.join(versions)} and "
              f"the wrapper equal to the plain version on all {want.numel()} "
              f"lanes, {int((want == 0).sum())} of them 0 (max_abs_err {err})",
              flush=True)
        del got, gstart
        if not timed:
            return {"max_abs_err": err}
        fns = {name: (lambda f=fn: call(f, out))
               for name, fn in {**versions, **(probes or {})}.items()}
        others = [n for n in fns if n != "kernel"]
        order = [*others, "kernel", "kernel", *reversed(others)]
        n_it = 20
        turns: dict = {who: [] for who in order}
        for _ in range(GATHER_ROUNDS):
            for who in order:
                turns[who].append(_event_ms(fns[who], n_it))
        lib_ms = _event_ms(gather_library(packed, start, p, pack), n_it)
        zero_ms = _event_ms(out.zero_, n_it)
        entry_ms = _event_ms(lambda: kg.gather_windows(
            packed, peaks, None, prof, pack=pack), n_it)
        plain_ms = _event_ms(lambda: kg.gather_windows_reference(
            packed, start, p, pack), 3)
        bound = gather_bound(start, prof, pack, h, w)
        ms = statistics.median(turns["kernel"])
        written = want.numel() * 4
        print(f"gather pack={pack} {what}: kernel median {ms:.4f} ms ("
              f"{100 * bound[0] / ms:.1f}% of bound, {written / ms / 1e9:.3f} "
              "TB/s written); " + "; ".join(
                  f"{who} min/median/max {min(t):.4f}/{statistics.median(t):.4f}"
                  f"/{max(t):.4f} ms ({100 * bound[0] / statistics.median(t):.1f}"
                  f"% of bound)" for who, t in turns.items())
              + f"; wrapper with its patch-origin ops {entry_ms:.4f} ms; plain "
              f"{plain_ms:.3f} ms; torch.gather on the plain index (equal on "
              f"in-image lanes) {lib_ms:.4f} ms; torch zero_ of the output "
              f"{zero_ms:.4f} ms ({written / zero_ms / 1e9:.3f} TB/s); bound "
              f"{bound[0]:.4f} ms ({bound[1]}; {written} B written) [{card}]",
              flush=True)
        return {"max_abs_err": err, "ms": ms, "turns_ms": turns,
                "entry_ms": entry_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "zero_ms": zero_ms, "bound": bound,
                "written_bytes": written}

    def gather_only_phase():
        """--only gather: the gather kernel (and each --baseline version)
        against the plain version at 4x437x467 for both packs, and checked
        and timed at each shape of ONLY_GATHER, with the first design's
        probes; no pipeline."""
        sig = build._SIGNATURES["vbs_gather_windows"]
        bases = {os.path.basename(src): _build_alt(src, "vbs_gather_windows")
                 for src in args.baseline or ()}
        probes = {f"probe {name}": _build_alt(
            GATHER_PROBES, f"vbs_gather_probe_{name}", sig)
            for name in ("stores", "loads")}
        probes.update({f"probe {os.path.basename(src)}":
                       _build_alt(src, "vbs_gather_windows")
                       for src in args.probe or ()})
        versions = {"kernel": build.library().vbs_gather_windows, **bases}
        on = False
        for line in build.build_log.splitlines():   # the gather kernels' ptxas
            on = "gather_" in line if "Compiling entry" in line else on
            if on and ("registers" in line or "spill" in line):
                print(f"  ptxas (gather.cu): {line.strip()}")
        lo = dcfg.low_res
        rec: dict = {}
        _, fr = render(437, 467, 4)
        packed, cval, cidx = fields_kernel(*fields_inputs(fr, lo), lo)
        peaks = select_peaks_from_cells(cval, cidx, 467, dcfg.max_candidates,
                                        float(lo.peak_window))
        for pack in (1, 2):
            rec[f"4x437x467 pack={pack}"] = gather_measure(
                "4x437x467", packed, peaks, lo, pack, versions, timed=False)
        del fr, packed, cval, cidx, peaks
        for h, w, batch, k, pack in ONLY_GATHER:
            prof = profile_of(h)
            what = f"{batch}x{h}x{w} K={k}"
            _, frames = render(h, w, batch)
            ncc, area, gray = fields_inputs(frames, prof)
            del frames
            packed, cval, cidx = fields_kernel(ncc, area, gray, prof)
            del ncc, area, gray
            peaks = select_peaks_from_cells(cval, cidx, w, k,
                                            float(prof.peak_window))
            del cval, cidx
            torch.cuda.empty_cache()
            r = rec[f"{what} pack={pack}"] = gather_measure(
                what, packed, peaks, prof, pack, versions, probes)
            record(f"{'gather_windows_paired' if pack == 2 else 'gather_windows pack=1'} {what}",
                   "gather", SRC["gather"][1 if pack == 2 else 2], 0,
                   r["max_abs_err"], r["ms"], r["plain_ms"], r["bound"],
                   r["library_ms"], zero_ms=r["zero_ms"])
            del packed, peaks
            torch.cuda.empty_cache()
        return rec

    def host_us(fn, reps=200) -> float:
        """Host microseconds a call of ``fn`` (its enqueue), over ``reps``
        calls after a warm-up; the card catches up after."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return 1e6 * dt / reps

    def turns_ms(fns, iters):
        """Each of ``fns`` (``{name: fn}``, the current kernel "kernel")
        timed with _device_ms in SCAN_ROUNDS rounds of turns (the others,
        the kernel twice, the others back): ``{name: [ms, ...]}``."""
        others = [x for x in fns if x != "kernel"]
        order = [*others, "kernel", "kernel", *reversed(others)]
        out: dict = {who: [] for who in fns}
        for _ in range(SCAN_ROUNDS):
            for who in order:
                out[who].append(_device_ms(fns[who], iters))
        return out

    def turns_line(turns, frames, floor_ns) -> str:
        return "; ".join(
            f"{who} min/median/max {min(t):.5f}/{statistics.median(t):.5f}/"
            f"{max(t):.5f} ms ({1e6 * statistics.median(t) / frames:.1f} ns a "
            f"frame, {statistics.median(t) * 1e6 / frames / floor_ns:.1f}x "
            "the chain floor)" for who, t in turns.items())

    def chain_floor_ns(chain) -> float:
        """ns a frame of ``chain`` dependent instructions at DEP_CYCLES each
        at the card's top SM clock (nan where nvidia-smi gives none)."""
        out = subprocess.run(["nvidia-smi", "--id=0",
                              "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True)
        try:
            return 1e3 * chain * DEP_CYCLES / float(out.stdout.strip())
        except ValueError:
            return float("nan")

    def scans_only_phase():
        """--only scans: each version of the scan and association kernels
        (the current one and each --baseline) against its plain version at
        every shape of ONLY_SCAN and ONLY_ASSOC on the flagship batch's own
        positions and detections, then timed with each --probe; the host
        time a call of each version and of the wrapper. No main-path run
        counted."""
        lib = build.library()
        scan_v = {"kernel": lib.vbs_displacement_scan}
        assoc_v = {"kernel": lib.vbs_associate_sequential}
        scan_p, assoc_p = {}, {}
        alts = []   # (versions, name, source, entry), built together
        for flag, srcs, sv, av, pre in (
                ("--baseline", args.baseline, scan_v, assoc_v, ""),
                ("--probe", args.probe, scan_p, assoc_p, "probe ")):
            for src in srcs or ():
                with open(src) as f:
                    text = f.read()
                name = pre + os.path.basename(src)
                if "vbs_displacement_scan(" in text:
                    alts.append((sv, name, src, "vbs_displacement_scan"))
                elif "vbs_associate_sequential(" in text:
                    alts.append((av, name, src, "vbs_associate_sequential"))
                else:
                    raise SystemExit(f"chip_smoke: {flag} {src} defines "
                                     "neither scan entry")
        with ThreadPoolExecutor(max(len(alts), 1)) as pool:   # one nvcc each
            built = list(pool.map(lambda a: _build_alt(a[2], a[3]), alts))
        for (versions, name, _, _), fn in zip(alts, built):
            versions[name] = fn
        res = subprocess.run([os.path.join(os.path.dirname(build._nvcc()),
                                           "cuobjdump"), "-res-usage",
                              str(build.library_path())],
                             capture_output=True, text=True)
        on = False
        for line in res.stdout.splitlines():   # the two kernels' resources
            if "Function" in line:
                on = "displacement_scan" in line or "associate" in line
            if on and "REG" in line:
                print(f"  cuobjdump -res-usage: {line.strip()}")
        rcfg = cfg.reconstruct
        max_step = rcfg.max_step_displacement_mm
        gate = cfg.track.min_marker_distance_px
        stream = torch.cuda.current_stream().cuda_stream
        spin = 20_000_000
        spin_ms = _event_ms(lambda: torch.cuda._sleep(spin), 3)
        print(f"scans: SM clock {spin / spin_ms / 1e3:.0f} MHz (a spin of "
              f"{spin} cycles took {spin_ms:.3f} ms) [{card}]", flush=True)
        frames_n = max(*ONLY_SCAN, *(b for b, _ in ONLY_ASSOC))
        scene, frames = render(480, 640, frames_n)
        ref = initialize(frames[0], cfg)
        out = process_frames(frames, ref, scene.cam, cfg)
        world = out.recon.world.contiguous()
        seen = out.recon.seen.contiguous()
        dets = {dcfg.max_candidates: out.detections}
        for b, k in ONLY_ASSOC:
            if k not in dets:
                kcfg = dataclasses.replace(cfg, detect=dataclasses.replace(
                    dcfg, max_candidates=k))
                dets[k] = process_frames(frames[:b], ref, scene.cam,
                                         kcfg).detections
        del frames, out
        torch.cuda.empty_cache()
        n = world.shape[1]
        rec: dict = {"scan": {}, "associate": {}}
        names = " and ".join(
            [", ".join(scan_v), ", ".join(assoc_v)])
        print(f"scans: versions {names}; positions and detections of "
              f"{frames_n} rendered 640x480 frames [{card}]", flush=True)

        for b in ONLY_SCAN:
            w, sx = world[:b], seen[:b]
            cases = [("fresh", w, sx, None)]
            if b == max(ONLY_SCAN):
                _, c = displacement_scan_reference(w[:b // 2], sx[:b // 2],
                                                   rcfg, None, True)
                cases.append(("resumed", w[b // 2:], sx[b // 2:], c))
            err = 0.0
            for case, wx, sxx, c in cases:
                want, wfin = displacement_scan_reference(wx, sxx, rcfg, c,
                                                         True)
                for name, entry in scan_v.items():
                    a, got, gfin = kscan.scan_args(wx, sxx, max_step, c)
                    build.check(entry(*a, stream), f"scan {name} launch")
                    torch.cuda.synchronize()
                    e = scan_check(got, gfin, want, wfin,
                                   f"{name} {b}x{n} {case}")
                    err = max(err, e) if name == "kernel" else err
                print(f"check displacement_scan {b}x{n} {case}: "
                      f"{', '.join(scan_v)} flags and copies equal, norms "
                      f"and cum within 1e-6/1e-5 (kernel max abs err {err})",
                      flush=True)
            prep = kscan.scan_args(w, sx, max_step, None)
            fns = {who: (lambda e=e, who=who: build.check(
                e(*prep[0], stream), f"scan {who} launch"))
                for who, e in {**scan_v, **scan_p}.items()}
            turns = turns_ms(fns, 50)
            wrap_us = {who: host_us(lambda e=e, who=who: build.check(
                e(*kscan.scan_args(w, sx, max_step, None)[0], stream),
                f"scan {who} launch")) for who, e in scan_v.items()}
            wrap_us["wrapper"] = host_us(lambda: kscan.displacement_scan(
                w, sx, max_step, None))
            plain_ms = _event_ms(lambda: displacement_scan_reference(
                w, sx, rcfg), 1)
            bound = scan_bound(b, n)
            ms = statistics.median(turns["kernel"])
            print(f"displacement_scan {b}x{n}: {turns_line(turns, b, chain_floor_ns(SCAN_CHAIN))}; "
                  f"plain {plain_ms:.3f} ms; bound {bound[0]:.5f} ms "
                  f"({bound[1]}); {_chain_note(b, SCAN_CHAIN)}; host us "
                  f"a call (scan_args + C entry; the wrapper): " + ", ".join(
                      f"{who} {u:.1f}" for who, u in wrap_us.items())
                  + f" [{card}]", flush=True)
            rec["scan"][f"{b}x{n}"] = {"turns_ms": turns, "plain_ms": plain_ms,
                                      "bound": bound, "max_abs_err": err,
                                      "wrapper_host_us": wrap_us}
            record(f"displacement_scan {b}x{n}", "scan", SRC["scan"][1], 0,
                   err, ms, plain_ms, bound, baseline_ms={
                       who: statistics.median(t) for who, t in turns.items()
                       if who != "kernel"})
            del prep

        for b, k in ONLY_ASSOC:
            det = dets[k]
            det = type(det)(*(x[:b] for x in det[:5]))
            cases = [("fresh", det, None)]
            if b == max(x for x, _ in ONLY_ASSOC):
                half = type(det)(*(x[:b // 2] for x in det[:5]))
                _, c = associate_sequential_reference(ref, half, gate, None,
                                                      True)
                cases.append(("resumed", type(det)(*(x[b // 2:]
                                                     for x in det[:5])), c))
            for case, d, c in cases:
                want, wlast = associate_sequential_reference(ref, d, gate, c,
                                                             True)
                for name, entry in assoc_v.items():
                    a, got, glast = kscan.assoc_args(ref, d, gate, c)
                    build.check(entry(*a, stream), f"associate {name} launch")
                    torch.cuda.synchronize()
                    assoc_check(got, glast, want, wlast,
                                f"{name} {b}x{n} K={k} {case}")
                print(f"check associate_sequential {b}x{n} K={k} {case}: "
                      f"{', '.join(assoc_v)} equal to the plain version "
                      f"({int(want.valid.sum())} of {want.valid.numel()} "
                      "slots valid)", flush=True)
            prep = kscan.assoc_args(ref, det, gate, None)
            fns = {who: (lambda e=e, who=who: build.check(
                e(*prep[0], stream), f"associate {who} launch"))
                for who, e in {**assoc_v, **assoc_p}.items()}
            turns = turns_ms(fns, 10 if b > 64 else 30)
            wrap_us = {who: host_us(lambda e=e, who=who: build.check(
                e(*kscan.assoc_args(ref, det, gate, None)[0], stream),
                f"associate {who} launch")) for who, e in assoc_v.items()}
            wrap_us["wrapper"] = host_us(lambda: kscan.associate_sequential(
                ref, det, gate, None))
            plain_ms = _event_ms(lambda: associate_sequential_reference(
                ref, det, gate), 1)
            bound = assoc_bound(b, n, k)
            cnt = det.valid.sum(1).tolist()
            chain = _assoc_chain(cnt)
            ms = statistics.median(turns["kernel"])
            print(f"associate_sequential {b}x{n} K={k} ({sum(cnt) / b:.1f} "
                  f"valid detections a frame): "
                  f"{turns_line(turns, b, chain_floor_ns(chain))}; plain "
                  f"{plain_ms:.3f} ms; bound {bound[0]:.5f} ms ({bound[1]});"
                  f" {_chain_note(b, chain)}; host us a call (assoc_args +"
                  " C entry; the wrapper): " + ", ".join(
                      f"{who} {u:.1f}" for who, u in wrap_us.items())
                  + f" [{card}]", flush=True)
            rec["associate"][f"{b}x{n} K={k}"] = {
                "turns_ms": turns, "plain_ms": plain_ms, "bound": bound,
                "chain": chain, "wrapper_host_us": wrap_us}
            record(f"associate_sequential {b}x{n} K={k}", "associate",
                   SRC["associate"][1], 0, 0.0, ms, plain_ms, bound,
                   baseline_ms={who: statistics.median(t)
                                for who, t in turns.items()
                                if who != "kernel"})
            del prep
        return rec

    def finish():
        records["kernels"] = kernels
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)

    if args.only == "fields":
        records["phases"]["fields"] = fields_phase()
        finish()
        return
    if args.only == "expand":
        records["phases"]["expand"] = expand_only_phase()
        finish()
        return
    if args.only == "window_sums":
        records["phases"]["window_sums"] = window_sums_only_phase()
        finish()
        return
    if args.only == "gather":
        records["phases"]["gather"] = gather_only_phase()
        finish()
        return
    if args.only == "scans":
        records["phases"]["scans"] = scans_only_phase()
        finish()
        return
    if args.only == "multi":
        _, jpegs, _ = encode_period(MULTI_FEED, INGEST[2])
        live_jpegs[:] = jpegs
        records["phases"]["multi_device"] = multi_phase()
        records["phases"]["spatial"] = spatial_phase()
        finish()
        return

    # -- kernels vs plain at the reference sensor's unaligned shape -----------
    _, fr = render(437, 467, 4)
    lo = dcfg.low_res
    ncc, area, gray = fields_inputs(fr, lo)
    (packed, cval, cidx), _ = check_fields(ncc, area, gray, lo, "4x437x467")
    peaks = select_peaks_from_cells(cval, cidx, 467, dcfg.max_candidates,
                                    float(lo.peak_window))
    for pack in (1, 2):
        check_gather(packed, peaks, lo, pack, "4x437x467")
    band, area_open, upeaks = unfused_inputs(ncc, area, lo,
                                             dcfg.max_candidates)
    ugeom = tm.cut_geometry(upeaks)
    sums_close(kw.window_sums(band, area_open, gray, upeaks, ugeom, lo),
               tm.window_sums_xla(band, area_open, gray, upeaks, ugeom, lo),
               upeaks.valid, "window_sums 4x437x467")

    # -- main path: the two bench sizes, the unfused branch and an odd K ------
    frames_of: dict = {}
    fused_out: dict = {}
    for label, h, w, batch, k, backend in RUNS:
        run_cfg = dataclasses.replace(cfg, detect=dataclasses.replace(
            dcfg, max_candidates=k, backend=backend))
        prof = profile_of(h)
        fused = detector.takes_fused_branch(run_cfg.detect, h, w, prof)
        # The detector's rule (detect/detector.py): paired windows need an
        # even K and a patch that fits the 64-lane slot.
        path_pack = 2 if k % 2 == 0 and prof.patch_size <= 64 else 1
        key = (h, w, batch)
        if key not in frames_of:
            frames_of.clear()
            frames_of[key] = render(h, w, batch)
        scene, frames = frames_of[key]
        expect = ({"fields", "gather"} if fused else {"window_sums"}) | {
            "scan", "filters"}
        rec, out = main_path(scene, frames, label, run_cfg, expect)
        if fused:
            rec["filters"] = filters_phase(frames, prof, f"{batch}x{h}x{w}")
        if label == RUNS[0][0]:
            recon4 = out.recon         # for phase 11's contact_signal
            records["phases"]["displacement_scan"] = scan_phase(
                out.recon.world, out.recon.seen, f"{batch}x65",
                rec["launches"]["scan"])
            records["phases"]["fast_filters"] = fast_filters_phase(
                scene, frames, label, run_cfg, out)
        what = f"{batch}x{h}x{w} K={k}"
        n_it = 10 if batch * h * w <= 2 ** 29 else 5
        ncc, area, gray = fields_inputs(frames, prof)
        if not fused:
            fused_det = fused_out.pop(key)
            rec["vs_fused"] = dets_close(
                out.detections, fused_det,
                f"{label}: unfused vs fused branch detections")
            band, area_open, peaks = unfused_inputs(ncc, area, prof, k)
            geom = tm.cut_geometry(peaks)
            w_err = sums_close(
                kw.window_sums(band, area_open, gray, peaks, geom, prof),
                tm.window_sums_xla(band, area_open, gray, peaks, geom, prof),
                peaks.valid, f"window_sums {what}")
            call, _ = ws_entry((band, area_open, gray), peaks, geom, prof,
                               "window_sums")
            lib = build.library()
            w_ms = _event_ms(lambda: call(lib.vbs_window_sums), 20)
            w_entry = _event_ms(lambda: kw.window_sums(
                band, area_open, gray, peaks, geom, prof), n_it)
            w_plain = _event_ms(lambda: tm.window_sums_xla(
                band, area_open, gray, peaks, geom, prof), n_it)
            stats = window_stats(peaks, geom, prof, h, w)
            w_bound = sums_bound(stats, peaks.valid.numel(), prof, False)
            rec["kernel_ms"] = {"window_sums": [w_ms, w_plain],
                                "entry_ms": w_entry, "bound": w_bound,
                                "visits_distinct": stats}
            print(f"{label}: window_sums kernel {w_ms:.4f} ms (entry with "
                  f"its patch-origin ops {w_entry:.3f} ms) vs plain "
                  f"{w_plain:.3f} ms; bound {w_bound[0]:.4f} ms "
                  f"({w_bound[1]}), {100 * w_bound[0] / w_ms:.1f}% of bound; "
                  f"gated visits {stats[0]}, distinct {stats[1]} ({what}) "
                  f"[{card}]", flush=True)
            record(f"window_sums {what}", "window_sums", SRC["window_sums"][1],
                   rec["launches"]["window_sums"], w_err, w_ms, w_plain,
                   w_bound, visits_per_distinct=stats[0] / max(stats[1], 1))
            records["phases"][label] = rec
            del band, area_open, peaks, geom
            continue
        fused_out[key] = out.detections
        (packed, cval, cidx), f_err = check_fields(ncc, area, gray, prof, what)
        peaks = select_peaks_from_cells(cval, cidx, w, k,
                                        float(prof.peak_window))
        geom = tm.cut_geometry(peaks)
        packs = (1, 2) if k % 2 == 0 else (1,)
        g_err = {p: check_gather(packed, peaks, prof, p, what) for p in packs}
        f_ms = _event_ms(lambda: fields_kernel(ncc, area, gray, prof), n_it)
        f_plain = _event_ms(lambda: fields_plain(ncc, area, gray, prof), n_it)
        g_call, g_start, g_out = gather_entry(packed, peaks, prof, path_pack,
                                              what)
        g_ms = _event_ms(lambda: g_call(build.library().vbs_gather_windows,
                                        g_out), n_it)
        g_entry = _event_ms(lambda: kg.gather_windows(
            packed, peaks, geom, prof, pack=path_pack), n_it)
        g_plain = _event_ms(
            lambda: gather_plain(packed, peaks, prof, path_pack), n_it)
        f_bound = fields_bound(batch, h, w, prof)
        g_bound = gather_bound(g_start, prof, path_pack, h, w)
        g_lib = _event_ms(gather_library(packed, g_start, prof.patch_size,
                                         path_pack), n_it)
        del g_call, g_start, g_out
        rec["kernel_ms"] = {"fields": [f_ms, f_plain, f_bound],
                            f"gather_pack{path_pack}": [g_ms, g_plain,
                                                        g_bound, g_lib],
                            "gather_entry_ms": g_entry}
        print(f"{label}: fields kernel {f_ms:.3f} ms vs plain {f_plain:.3f} "
              f"ms, bound {f_bound[0]:.4f} ms; gather pack={path_pack} "
              f"kernel {g_ms:.4f} ms (wrapper with its patch-origin ops "
              f"{g_entry:.4f}) vs plain {g_plain:.3f} ms, torch.gather "
              f"{g_lib:.3f} ms, bound {g_bound[0]:.4f} ms ({what}) [{card}]",
              flush=True)
        tiled = h * w > 960 * 1280
        record(f"{'fused_fields_tiled' if tiled else 'fused_fields'} {what}",
               "fields", SRC["fields"][2 if tiled else 1],
               rec["launches"]["fields"], f_err, f_ms, f_plain, f_bound)
        record(f"{'gather_windows_paired' if path_pack == 2 else 'gather_windows pack=1'} {what}",
               "gather", SRC["gather"][1 if path_pack == 2 else 2],
               rec["launches"]["gather"], g_err[path_pack], g_ms, g_plain,
               g_bound, g_lib)
        if label == RUNS[0][0]:
            records["phases"]["window_sums_packed"] = packed_phase(
                packed, peaks, geom, prof, what, rec["launches"])
        records["phases"][label] = rec
        del ncc, area, gray, packed, cval, cidx, peaks, geom
        torch.cuda.empty_cache()
    frames_of.clear()
    fused_out.clear()
    torch.cuda.empty_cache()

    records["phases"]["stream"] = stream_phase()
    records["phases"]["ingest"], records["phases"]["cli"] = ingest_phase()
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        records["phases"]["pose"] = pose_phase(td)
    with tempfile.TemporaryDirectory() as td:
        records["phases"]["calibrate"] = calibrate_phase(td)
    with tempfile.TemporaryDirectory() as td:
        records["phases"]["serve"] = serve_phase(td)
        records["phases"]["extras"] = extras_phase(td, recon4)
    records["phases"]["multi_device"] = multi_phase()
    records["phases"]["spatial"] = spatial_phase()
    finish()


if __name__ == "__main__":
    main()
