"""Row-sharded detection: the ``spatial`` mesh axis.

Port of the reference's ``spatial`` axis (``vision_basedsensor_tpu/parallel/
mesh.py:48-58,86-89,125-132,180-185``): each frame's rows are split over
the ``s`` devices of a data group, and the detector's unfused branch runs
on each row block, as the reference forces ``backend="xla"`` there. GSPMD
exchanges the filters' halos in the reference; here the exchange is
written out, stage by stage:

1. *halo in*: each shard fetches the source rows its extended block reads,
   its own rows plus :func:`halo_rows` on each side (clipped at the
   frame's edges), from the shards of its group that hold them;
2. the DoG area mask on the block, and the mask's sum over the shard's own
   rows;
3. the group adds the sums: the NCC subtracts the whole frame's mean
   (``ops/ncc.py``), and every shard's NCC takes it;
4. NCC, band, opening and the peak field on the block; each shard ranks
   its own 8x8 cells (those starting in its own rows) and keeps its best
   ``max_candidates``, with global flat indices;
5. the group's first device merges the shards' ranked cells in row order
   (``ops/peaks.py:top_cells``: the whole frame's ranking), suppresses and
   cuts (``cut_geometry``): the single-device selection;
6. each shard runs the window-sums kernel on its block for every peak,
   those whose row it owns valid;
7. the owned sums go back to the group's first device, which finalizes.

Each stage is issued on every shard before the copies that follow it: a
copy between two cards waits for all work queued on both.

Equal to the single-device detector where every filter sums its nonzero
taps in the same order (the band matrices hold the same taps; a GEMM over
a shorter contraction may block it differently, which would show first as
a flipped DoG pixel). The block's own edges act as image edges (reflected
blurs, zero-padded NCC, the box count), which is wrong only within the
halo: :func:`halo_rows` covers every stage's reach from a shard's own rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vision_basedsensor_tpu_torch.config import (DetectConfig, DetectProfile,
                                                 PipelineConfig)
from vision_basedsensor_tpu_torch.core.imaging import (band_and_opening,
                                                       to_grayscale)
from vision_basedsensor_tpu_torch.core.undistort import remap_bilinear
from vision_basedsensor_tpu_torch.detect.detector import _finalize_candidates
from vision_basedsensor_tpu_torch.ops.cuda import launch_counts
from vision_basedsensor_tpu_torch.ops.cuda.filters import (binary_ncc,
                                                           dog_fields)
from vision_basedsensor_tpu_torch.ops.cuda.window_sums import window_sums
from vision_basedsensor_tpu_torch.ops.moments import CutGeometry, cut_geometry
from vision_basedsensor_tpu_torch.ops.peaks import (Peaks, cell_maxima,
                                                    peak_field, peaks_from_top,
                                                    top_cells)

CELL = 8   # the peak cells' side (ops/peaks.py:find_peaks)


def halo_rows(cfg: DetectConfig, profile: DetectProfile) -> int:
    """Rows a row shard's block reaches past its own rows on each side.

    A window's sums read band, opened area and gray up to half a patch
    from a peak in the shard's own rows; the band reads the NCC up to half
    its window, the NCC the area mask up to half its template, the opening
    the mask up to twice half its kernel; the peaks of a cell that starts
    in the shard's rows and crosses its last row reach 7 rows further and
    read the NCC up to half the peak window; the mask reads gray up to half
    the larger blur. The sum over those bounds every chain: 64 rows for the
    low-res profile, 136 for the high-res."""
    blur = max(profile.blur_large_ksize, profile.blur_small_ksize) // 2
    fields = max(profile.template_size // 2
                 + max(profile.band_window // 2, profile.peak_window // 2),
                 2 * (cfg.open_ksize // 2))
    return blur + fields + profile.patch_size // 2 + CELL - 1


class RowBlock(NamedTuple):
    """One row shard's rows, each a half-open ``(first, end)`` range: of
    the detect frame (after crop and rectification), ``own`` the rows it
    owns, ``block`` the rows it detects on (``own`` plus the halo; the
    first a multiple of 8, so the frame's cells are the block's), ``cells``
    the rows of the cells it ranks (those that start in ``own``); ``src``
    the raw frame's rows it reads."""
    own: tuple[int, int]
    block: tuple[int, int]
    cells: tuple[int, int]
    src: tuple[int, int]


class RowPlan(NamedTuple):
    """Where each row shard reads and detects, for one raw frame shape."""
    blocks: tuple[RowBlock, ...]
    profile: DetectProfile      # the whole frame's (detector.py:140-142)
    hw: tuple[int, int]         # the detect frame's (H, W)
    crop: tuple[int, int, int]  # (left, right, top) of the raw frame
    halo: int


def crop_box(h: int, w: int, cfg: PipelineConfig,
             crop: bool) -> tuple[int, int, int, int]:
    """``(left, right, top, bottom)`` of ``core/imaging.py:crop_frames``."""
    if not crop:
        return 0, w, 0, h
    left, right, top, bottom = cfg.crop_ratios
    return (int(w * left), w - int(w * right), int(h * top),
            h - int(h * bottom))


def row_plan(h: int, w: int, s: int, cfg: PipelineConfig, crop: bool,
             rectify_map: torch.Tensor | None = None) -> RowPlan:
    """The row blocks of ``s`` shards for raw ``(h, w)`` frames. The detect
    frame's rows are split evenly (``own``); with a rectify map a block's
    source rows are the map's clamped row span plus one (the remap is
    bilinear), read once here from the map."""
    left, right, top, bottom = crop_box(h, w, cfg, crop)
    hd, wd = bottom - top, right - left
    dcfg = cfg.detect
    profile = dcfg.low_res if hd <= dcfg.low_res_max_rows else dcfg.high_res
    r = halo_rows(dcfg, profile)
    span = None
    if rectify_map is not None:
        y = torch.floor(torch.clamp(rectify_map[..., 1], 0.0, hd - 1.000001))
        span = torch.stack([y.amin(-1), y.amax(-1)], -1).long().cpu()
    blocks = []
    for j in range(s):
        o0, o1 = j * hd // s, (j + 1) * hd // s
        a = max(0, o0 - r) // CELL * CELL
        b = min(hd, o1 + r)
        if b - a < profile.patch_size:
            raise ValueError(f"a row block of {b - a} rows is smaller than "
                             f"the {profile.patch_size}-px patch")
        c0 = -(-o0 // CELL) * CELL
        c1 = min(hd, -(-o1 // CELL) * CELL)
        if span is None:
            src = (a, b)
        else:
            src = (int(span[a:b, 0].min()),
                   min(hd, int(span[a:b, 1].max()) + 2))
        blocks.append(RowBlock((o0, o1), (a, b), (c0, c1),
                               (src[0] + top, src[1] + top)))
    return RowPlan(tuple(blocks), profile, (hd, wd), (left, right, top), r)


class _Shard:
    """One row shard's tensors between stages, and its kernel launches."""

    def __init__(self, key, dev, blk: RowBlock):
        self.key, self.dev, self.blk = key, dev, blk
        self.launches: dict = {}

    def counted(self, fn, *args):
        """``fn(*args)``, adding its kernel launches to this shard's."""
        before = launch_counts()
        out = fn(*args)
        after = launch_counts()
        for k in after:
            self.launches[k] = self.launches.get(k, 0) + after[k] - before[k]
        return out

    def own(self, y: torch.Tensor) -> torch.Tensor:
        """Whether rows ``y`` of the detect frame are this shard's own."""
        o0, o1 = self.blk.own
        return (y >= o0) & (y < o1)


def detect_row_shards(blocks, grid, hs: int, plan: RowPlan,
                      cfg: PipelineConfig, axis_scales, maps, copy
                      ) -> tuple[list, list]:
    """Detect on a ``(data, spatial)`` grid of row shards.

    ``blocks[i][j]``: group ``i``'s raw rows ``j * hs`` to ``(j + 1) * hs``
    on ``grid[i][j]``; ``axis_scales[i]``: the axis scale on ``grid[i][0]``
    (or None); ``maps[i][j]``: the rectify map's rows of
    ``plan.blocks[j].block`` on ``grid[i][j]`` (or None); ``copy(x, device,
    name, shard, peer)`` moves a tensor between two shards and records it.
    Returns each group's ``Detections`` on ``grid[i][0]`` and each shard's
    kernel launches, row-major. Every shard runs the detector's unfused
    branch, whatever ``cfg.detect.backend`` says (the reference forces
    ``backend="xla"`` on a spatial mesh, its ``mesh.py:126-132``)."""
    dcfg = cfg.detect
    prof = plan.profile
    hd, wd = plan.hw
    left, right, top = plan.crop
    fdt = torch.bfloat16 if dcfg.fast_filters else None
    s = len(plan.blocks)
    groups = [[_Shard((i, j), dev, plan.blocks[j])
               for j, dev in enumerate(row)] for i, row in enumerate(grid)]
    shards = [sh for row in groups for sh in row]

    # 1. Halo in: the source rows of each block, from the shards of its
    # group that hold them.
    for sh in shards:
        i, j = sh.key
        r0, r1 = sh.blk.src
        pieces = []
        for k in range(s):
            lo, hi = max(r0, k * hs), min(r1, (k + 1) * hs)
            if lo < hi:
                piece = blocks[i][k][:, lo - k * hs:hi - k * hs]
                pieces.append(piece if k == j else
                              copy(piece, sh.dev, "halo", sh.key, (i, k)))
        sh.raw = pieces[0] if len(pieces) == 1 else torch.cat(pieces, 1)

    # 2. The block's detect frame (crop, rectification), gray and DoG area
    # mask; the mask's sum over the shard's own rows.
    def dog(sh):
        x = sh.raw[:, :, left:right]
        smap = maps[sh.key[0]][sh.key[1]]
        if smap is not None:
            x = remap_bilinear(to_grayscale(x, dcfg.channel_order), smap,
                               row0=sh.blk.src[0] - top, height=hd)
        gray, area, _ = dog_fields(x, prof, dcfg.dog_offset,
                                   dcfg.channel_order, fdt)
        (o0, o1), a = sh.blk.own, sh.blk.block[0]
        return gray, area, area[:, o0 - a:o1 - a].sum(dim=(-2, -1))

    for sh in shards:
        sh.gray, sh.area, sh.area_sum = sh.counted(dog, sh)
        sh.raw = None

    # 3. The whole frame's mask mean, from the shards' exact integer sums.
    for row in groups:
        head = row[0]
        total = head.area_sum
        for sh in row[1:]:
            total = total + copy(sh.area_sum, head.dev, "area_sum", sh.key,
                                 head.key)
        head.mean = (total / (hd * wd))[:, None, None]
    for row in groups:
        head = row[0]
        for sh in row[1:]:
            sh.mean = copy(head.mean, sh.dev, "area_mean", sh.key, head.key)

    # 4. NCC, band, opening and the peak field on the block; the shard's own
    # cells ranked, their flat indices in the frame.
    def ncc_cells(sh):
        ncc = binary_ncc(sh.area, prof, fdt, mean=sh.mean)
        band, area_open = band_and_opening(ncc, sh.area, dcfg.ncc_threshold,
                                           prof.band_window, dcfg.open_ksize)
        sp = peak_field(ncc, dcfg.ncc_threshold, prof.peak_window)
        (c0, c1), a = sh.blk.cells, sh.blk.block[0]
        cmax, cflat = cell_maxima(sp[:, c0 - a:c1 - a], CELL)
        n = cmax.shape[-2] * cmax.shape[-1]
        vals, flat = top_cells(cmax.reshape(-1, n), cflat.reshape(-1, n),
                               dcfg.max_candidates)
        return band, area_open, vals, flat + c0 * wd

    for sh in shards:
        sh.band, sh.area_open, sh.vals, sh.flat = sh.counted(ncc_cells, sh)
        sh.area = sh.mean = None

    # 5. The group's first device merges the ranked cells in row order: the
    # whole frame's ranking, suppression and cut geometry.
    for row in groups:
        head = row[0]
        vals, flat = [head.vals], [head.flat]
        for sh in row[1:]:
            vals.append(copy(sh.vals, head.dev, "cells.score", sh.key,
                             head.key))
            flat.append(copy(sh.flat, head.dev, "cells.index", sh.key,
                             head.key))
        head.peaks = peaks_from_top(
            *top_cells(torch.cat(vals, -1), torch.cat(flat, -1),
                       dcfg.max_candidates),
            wd, float(prof.peak_window))
        head.geom = cut_geometry(head.peaks)
    for row in groups:
        head = row[0]
        for sh in row:
            if sh is head:
                sh.xy, sh.geom = head.peaks.xy, head.geom
                continue
            sh.xy = copy(head.peaks.xy, sh.dev, "peaks.xy", sh.key, head.key)
            sh.geom = CutGeometry(*(
                copy(v, sh.dev, f"geom.{k}", sh.key, head.key)
                for k, v in zip(CutGeometry._fields, head.geom)))

    # 6. The window sums of every peak on each block; those in the shard's
    # own rows valid (the others' sums are not used).
    def sums(sh):
        x, y = sh.xy[..., 0], sh.xy[..., 1]
        local = Peaks(xy=torch.stack([x, y - sh.blk.block[0]], -1),
                      score=torch.zeros_like(x), valid=sh.own(y))
        return window_sums(sh.band, sh.area_open, sh.gray, local, sh.geom,
                           prof)

    for sh in shards:
        sh.sums = sh.counted(sums, sh)
        sh.band = sh.area_open = sh.gray = None

    # 7. The owned sums back to the group's first device, which finalizes.
    dets = []
    for row, scale in zip(groups, axis_scales):
        head = row[0]
        y = head.peaks.xy[..., 1]
        total = head.sums
        for sh in row[1:]:
            part = copy(sh.sums, head.dev, "sums", sh.key, head.key)
            total = torch.where(sh.own(y)[..., None], part, total)
        det, _ = _finalize_candidates(total, head.peaks, dcfg,
                                      axis_scale=scale)
        dets.append(det)
    return dets, [sh.launches for sh in shards]
