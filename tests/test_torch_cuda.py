"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Every test here is ``cuda_only`` and skips without a GPU. The file imports
neither jax nor the JAX package, so it also runs where JAX is absent, with
the JAX-forcing ``tests/conftest.py`` left out:

    python -m pytest --noconftest -m cuda_only tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from torch_parity import assert_recon_close, cuda  # noqa: F401

from vision_basedsensor_tpu_torch.config import DetectConfig, PipelineConfig
from vision_basedsensor_tpu_torch.ops.cuda import fields as kf
from vision_basedsensor_tpu_torch.ops.cuda import moments as kg
from vision_basedsensor_tpu_torch.ops.peaks import Peaks

pytestmark = pytest.mark.cuda_only


def _random_fields(rng, b, h, w, dev):
    # Quantized scores: exact plateaus inside and across cells.
    ncc = np.round(rng.random((b, h, w)) * 8.0) / 8.0
    area = rng.random((b, h, w)) > 0.6
    gray = rng.integers(0, 256, (b, h, w))
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                 for x in (ncc, area, gray))


def _peaks(rng, b, k, h, w, dev):
    xs = rng.integers(0, w, (b, k)).astype(np.float32)
    ys = rng.integers(0, h, (b, k)).astype(np.float32)
    xs[:, 0], ys[:, 1], xs[:, 2], ys[:, 3] = 0, 0, w - 1, h - 1
    xy = torch.as_tensor(np.stack([xs, ys], -1), device=dev)
    return Peaks(xy=xy, score=torch.ones((b, k), device=dev),
                 valid=torch.ones((b, k), dtype=torch.bool, device=dev))


@pytest.mark.parametrize("shape,profile,threshold,area_fill", [
    ((2, 480, 640), "low_res", None, None),
    ((1, 1080, 1920), "high_res", None, None),
    ((2, 437, 467), "low_res", None, None),
    ((1, 61, 77), "high_res", None, None),
    ((3, 8, 33), "high_res", None, None),     # H < 2R + 1, W % 4 != 0
    ((1, 480, 644), "low_res", None, None),   # ragged last column strip
    ((1, 480, 636), "low_res", None, None),
    ((1, 8, 8), "low_res", None, None),
    ((2, 61, 77), "low_res", -1.0, None),     # m all ones
    ((2, 61, 77), "high_res", 2.0, None),     # m all zeros
    ((2, 64, 136), "high_res", None, 1.0),    # area all ones: the erosion's
    ((2, 64, 136), "low_res", None, 0.0),     # identity at the frame border
])
def test_fields_kernel_matches_plain(cuda, shape, profile, threshold,
                                     area_fill):
    cfg = DetectConfig()
    prof = getattr(cfg, profile)
    thr = cfg.ncc_threshold if threshold is None else threshold
    ncc, area, gray = _random_fields(np.random.default_rng(1), *shape, cuda)
    if area_fill is not None:
        area.fill_(area_fill)
    before = kf.fields_launches
    got = kf.fused_fields(ncc, area, gray, thr, cfg.open_ksize, prof)
    want = kf.fused_fields_reference(ncc, area, gray, thr, cfg.open_ksize,
                                     prof)
    torch.cuda.synchronize()
    assert kf.fields_launches == before + 1
    for a, b, name in zip(got, want, ("packed", "cval", "cidx")):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_fields_kernel_unaligned_and_wide_windows(cuda):
    """Rows that are not 16-byte aligned (W % 4 == 0, odd storage offset)
    take the scalar path; a window reach above 8 takes the wide-window
    instantiation; one beyond MAX_HALO is refused."""
    import dataclasses

    cfg = DetectConfig()
    rng = np.random.default_rng(7)
    b, h, w = 2, 96, 256
    fields = []
    for x in _random_fields(rng, b, h, w, cuda):
        flat = torch.empty(x.numel() + 1, device=cuda)
        flat[1:] = x.reshape(-1)
        fields.append(flat[1:].view(b, h, w))
    wide = dataclasses.replace(cfg.low_res, peak_window=33, band_window=20)
    for prof, fs in ((cfg.low_res, fields),
                     (wide, _random_fields(rng, b, h, w, cuda))):
        got = kf.fused_fields(*fs, cfg.ncc_threshold, cfg.open_ksize, prof)
        want = kf.fused_fields_reference(*fs, cfg.ncc_threshold,
                                         cfg.open_ksize, prof)
        torch.cuda.synchronize()
        for a, b_, name in zip(got, want, ("packed", "cval", "cidx")):
            assert torch.equal(a, b_), name
    too_wide = dataclasses.replace(cfg.low_res, peak_window=2 * kf.MAX_HALO + 3)
    with pytest.raises(ValueError):
        kf.fused_fields(*fields, cfg.ncc_threshold, cfg.open_ksize, too_wide)


@pytest.mark.parametrize("profile,hw", [("low_res", (480, 640)),
                                        ("high_res", (1080, 1920)),
                                        ("low_res", (437, 467))])
@pytest.mark.parametrize("pack,k", [(1, 96), (2, 96), (1, 97)])
def test_gather_kernel_matches_plain(cuda, profile, hw, pack, k):
    h, w = hw
    prof = getattr(DetectConfig(), profile)
    rng = np.random.default_rng(2)
    packed = torch.as_tensor(rng.integers(0, 1024, (3, h, w)),
                             dtype=torch.float32, device=cuda)
    peaks = _peaks(rng, 3, k, h, w, cuda)
    before = kg.gather_launches
    got, start = kg.gather_windows(packed, peaks, None, prof, pack=pack)
    want = kg.gather_windows_reference(packed, start, prof.patch_size, pack)
    torch.cuda.synchronize()
    assert kg.gather_launches == before + 1
    assert torch.equal(got, want)


# (rows, cols, batch, peaks, pack, profile, patch size or None, packed's
# offset in floats from a 16-byte boundary).
_GATHER_CASES = {
    "corners-640-pack1": (480, 640, 2, 97, 1, "low_res", None, 0),
    "corners-640-pack2": (480, 640, 2, 96, 2, "low_res", None, 0),
    "corners-1920-pack1": (1080, 1920, 1, 96, 1, "high_res", None, 0),
    "corners-1920-pack2": (1080, 1920, 1, 96, 2, "high_res", None, 0),
    "corners-467-pack1": (437, 467, 2, 97, 1, "low_res", None, 0),
    "corners-467-pack2": (437, 467, 2, 96, 2, "low_res", None, 0),
    "patch96": (480, 640, 2, 33, 1, "low_res", 96, 0),
    "patch128": (480, 640, 2, 33, 1, "low_res", 128, 0),
    "patch128-467": (437, 467, 2, 33, 1, "low_res", 128, 0),
    "patch36-pack2": (480, 640, 2, 96, 2, "low_res", 36, 0),
    "k1-pack1": (480, 640, 3, 1, 1, "low_res", None, 0),
    "k2-pack2": (480, 640, 3, 2, 2, "low_res", None, 0),
    "b0": (480, 640, 0, 96, 2, "low_res", None, 0),
    "k0": (480, 640, 2, 0, 1, "low_res", None, 0),
    "many-rows-pack2": (64, 256, 3000, 12, 2, "low_res", None, 0),
    "many-rows-pack1": (64, 256, 1500, 13, 1, "low_res", None, 0),
    "offset-640": (480, 640, 2, 96, 2, "low_res", None, 1),
    "narrow-128": (64, 128, 50, 12, 2, "low_res", None, 0),
}


@pytest.mark.parametrize("case", list(_GATHER_CASES))
def test_gather_kernel_edge_cases(cuda, case):
    """``torch.equal`` to the plain version, zeros included, on what a
    window copy can get wrong: peaks at the four corners and along the
    edges (origins at W - P, lanes past W, origins off a 16-byte boundary)
    at W = 640, 1920 and 467; pack=1 at P = 96 and 128, and P = 36; K = 1
    and 2; B = 0 and K = 0 (no launch); many output rows; a ``packed``
    that starts 4 bytes past a 16-byte boundary; a frame narrower than 132
    columns. The output is allocated over NaNs, so a lane left unwritten
    fails."""
    import dataclasses

    h, w, b, k, pack, profile, patch, offset = _GATHER_CASES[case]
    prof = getattr(DetectConfig(), profile)
    if patch is not None:
        prof = dataclasses.replace(prof, patch_size=patch,
                                   radial_cutoff_px=patch / 2 - 1)
    rng = np.random.default_rng(8)
    base = torch.empty(b * h * w + 4, device=cuda)
    packed = base[offset:offset + b * h * w].view(b, h, w)
    packed.copy_(torch.as_tensor(rng.integers(1, 2 ** 20, (b, h, w)),
                                 dtype=torch.float32))
    xy = np.stack([rng.integers(0, w, (b, k)), rng.integers(0, h, (b, k))],
                  -1).astype(np.float32)
    edges = [(w - 1, h - 1), (0, 0), (w - 1, 0), (0, h - 1), (w // 2, 0),
             (w - 1, h // 2), (0, h // 2), (w // 2, h - 1), (w - 2, 3)]
    n = min(k, len(edges))
    if n:
        xy[:, :n] = edges[:n]
    peaks = Peaks(xy=torch.as_tensor(xy, device=cuda),
                  score=torch.ones((b, k), device=cuda),
                  valid=torch.ones((b, k), dtype=torch.bool, device=cuda))
    numel = b * (k // pack) * prof.patch_size * 128
    torch.full((numel,), float("nan"), device=cuda)   # freed: reused below
    before = kg.gather_launches
    got, start = kg.gather_windows(packed, peaks, None, prof, pack=pack)
    want = kg.gather_windows_reference(packed, start, prof.patch_size, pack)
    torch.cuda.synchronize()
    assert kg.gather_launches == before + int(numel > 0)
    assert got.shape == want.shape == (b, k // pack, prof.patch_size, 128)
    assert torch.equal(got, want)
    if numel:
        assert bool((start[..., 0] == w - prof.patch_size).any())
        assert float(got.abs().sum()) > 0


def test_gather_wrapper_refuses_bad_inputs(cuda):
    prof = DetectConfig().low_res
    packed = torch.rand((2, 64, 96), device=cuda)
    peaks = _peaks(np.random.default_rng(9), 2, 6, 64, 96, cuda)
    for bad in (packed.double(), packed.transpose(1, 2).contiguous()
                .transpose(1, 2), packed[:, :, :48]):
        with pytest.raises(ValueError):
            kg.gather_windows(bad, peaks, None, prof, pack=2)
    with pytest.raises(ValueError):
        kg.gather_windows(packed, peaks._replace(xy=peaks.xy.cpu()), None,
                          prof)


def _sums_close(got, want, valid):
    """The JAX tests' window-sums tolerance (rtol 1e-5, atol 2e-2 on valid
    peaks, equal finite patterns)."""
    a, b = got[valid].cpu().numpy(), want[valid].cpu().numpy()
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5, atol=2e-2)


@pytest.mark.parametrize("case", ["random", "corners", "empty_cut",
                                  "soft_floor_0", "k1", "k7", "k97", "b0",
                                  "k0", "big_patch"])
@pytest.mark.parametrize("profile,hw", [("low_res", (480, 640)),
                                        ("high_res", (1080, 1920)),
                                        ("low_res", (437, 467))])
@pytest.mark.parametrize("packed", [False, True])
def test_window_sums_kernel_matches_plain(cuda, profile, hw, packed, case):
    """Count (slot 23), lo (21) and hi (22) bit-equal to the plain version,
    the rest within the JAX tests' tolerance, on fractional peaks and the
    cases a warp-per-peak kernel walking each row's gated run can get
    wrong: peaks on and beside the four corners (clipped patch origins),
    halfplanes that exclude every pixel, ``soft_floor = 0``, K not a
    multiple of the peaks a block takes, B = 0 and K = 0 (no launch), and a
    patch whose gated list outgrows the kernel's 4,096 shared keys."""
    import dataclasses

    from vision_basedsensor_tpu_torch.ops import moments as tm
    from vision_basedsensor_tpu_torch.ops.cuda import window_sums as kw

    h, w = hw
    prof = getattr(DetectConfig(), profile)
    if case == "soft_floor_0":
        prof = dataclasses.replace(prof, soft_floor=0.0)
    if case == "big_patch":
        prof = dataclasses.replace(prof, patch_size=96, radial_cutoff_px=46.0)
    rng = np.random.default_rng(4)
    b = 0 if case == "b0" else 2
    # Five peaks leave the big patch's 46-px disks whole: lists of ~6,600.
    k = {"k1": 1, "k7": 7, "k97": 97, "k0": 0, "big_patch": 5}.get(case, 96)
    band = torch.as_tensor(rng.random((b, h, w)) > 0.7, dtype=torch.float32,
                           device=cuda)
    area = torch.as_tensor(rng.random((b, h, w)) > 0.4, dtype=torch.float32,
                           device=cuda)
    # Fractional gray, as after undistortion.
    gray = torch.as_tensor(rng.random((b, h, w)) * 255.0, dtype=torch.float32,
                           device=cuda)
    xy = np.stack([rng.uniform(0, w - 1, (b, k)),
                   rng.uniform(0, h - 1, (b, k))], -1)
    if case == "corners":
        xy[:, :6] = [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1],
                     [0.49, 0.3], [w - 1.4, h - 1.45]]
    valid = rng.random((b, k)) > 0.2
    if case == "corners":
        valid[:, :6] = True
    peaks = Peaks(xy=torch.as_tensor(xy, dtype=torch.float32, device=cuda),
                  score=torch.ones((b, k), device=cuda),
                  valid=torch.as_tensor(valid, device=cuda))
    geom = tm.cut_geometry(peaks)
    if case == "empty_cut":     # dx <= -1000 for the first halfplane
        geom = tm.CutGeometry(ex=torch.ones_like(geom.ex),
                              ey=torch.zeros_like(geom.ey),
                              rhs=torch.full_like(geom.rhs, -1000.0))
    launched = int(b * k > 0)
    if packed:
        # Packing rounds the fractional gray: the reference is the plain
        # version of the packed mode, on the same packed field.
        field = gray + 256.0 * band + 512.0 * area
        want = kw.window_sums_packed_reference(field, peaks, geom, prof)
        before = kw.packed_launches
        got = kw.window_sums_packed(field, peaks, geom, prof)
        assert kw.packed_launches == before + launched
    else:
        want = tm.window_sums_xla(band, area, gray, peaks, geom, prof)
        before = kw.fields_launches
        got = kw.window_sums(band, area, gray, peaks, geom, prof)
        assert kw.fields_launches == before + launched
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, k, tm.NUM_SUMS)
    v = peaks.valid
    for slot in (21, 22, 23):
        assert torch.equal(got[v][:, slot], want[v][:, slot]), slot
    _sums_close(got, want, v)
    if case == "empty_cut":
        assert not got[..., 23].any()
        assert bool(torch.isposinf(got[..., 21]).all())
        assert bool(torch.isneginf(got[..., 22]).all())
    elif b * k:
        assert int(got[..., 23].sum()) > 0
    if case == "big_patch":         # the kernel's list ran in chunks
        assert float(got[..., 23].max()) > 4096


def test_detect_unfused_kernel_path_matches_plain_path(cuda):
    """The unfused branch (backend="xla") on rendered frames, with and
    without the window-sums kernel: the reference's xla-vs-pallas
    tolerances (valid equal, xy 1e-3 px, axes 1e-2 px)."""
    import dataclasses

    from vision_basedsensor_tpu_torch.detect import detector
    from vision_basedsensor_tpu_torch.ops import moments as tm
    from vision_basedsensor_tpu_torch.ops.cuda import window_sums as kw
    from vision_basedsensor_tpu_torch.synth import default_scene, render_frames

    scene = default_scene(480, 640, device=cuda)
    d = torch.zeros((4, 65, 3), device=cuda)
    d[:, :, 2] = -0.3 * torch.arange(4, device=cuda)[:, None]
    frames = render_frames(scene, d)
    cfg = dataclasses.replace(DetectConfig(), backend="xla")
    before = kw.fields_launches
    got = detector.detect_markers(frames, cfg)
    assert kw.fields_launches == before + 1
    saved = detector.window_sums
    detector.window_sums = tm.window_sums_xla
    try:
        want = detector.detect_markers(frames, cfg)
    finally:
        detector.window_sums = saved
    assert torch.equal(got.valid, want.valid)
    assert int(got.valid.sum(-1).min()) >= 65
    v = want.valid
    assert float((got.xy - want.xy)[v].abs().max()) <= 1e-3
    assert float((got.axes - want.axes)[v].abs().max()) <= 1e-2


def test_wrappers_refuse_bad_inputs(cuda):
    cfg = DetectConfig()
    ncc, area, gray = _random_fields(np.random.default_rng(3), 1, 64, 96, cuda)
    with pytest.raises(TypeError):
        kf.fused_fields(ncc.double(), area, gray, 0.1, 5, cfg.low_res)
    with pytest.raises(ValueError):
        kf.fused_fields(ncc.transpose(1, 2).contiguous().transpose(1, 2),
                        area, gray, 0.1, 5, cfg.low_res)
    with pytest.raises(ValueError):
        kf.fused_fields(ncc, area.cpu(), gray, 0.1, 5, cfg.low_res)

    from vision_basedsensor_tpu_torch.ops import moments as tm
    from vision_basedsensor_tpu_torch.ops.cuda import window_sums as kw

    peaks = _peaks(np.random.default_rng(5), 1, 8, 64, 96, cuda)
    geom = tm.cut_geometry(peaks)
    with pytest.raises(ValueError):
        kw.window_sums(area, area.double(), gray, peaks, geom, cfg.low_res)
    with pytest.raises(ValueError):
        kw.window_sums_packed(gray.transpose(1, 2).contiguous().transpose(1, 2),
                              peaks, geom, cfg.low_res)
    with pytest.raises(ValueError):
        kw.window_sums(area, area, gray, peaks._replace(xy=peaks.xy.cpu()),
                       geom, cfg.low_res)
    with pytest.raises(ValueError):
        kw.window_sums(area, area, gray, peaks,
                       geom._replace(rhs=geom.rhs.cpu()), cfg.low_res)
    with pytest.raises(ValueError):
        kw.window_sums_packed(gray, peaks, geom._replace(ex=geom.ex[..., :2]),
                              cfg.low_res)


@pytest.mark.parametrize("k", [96, 97])
def test_pipeline_kernel_path_matches_plain_path(cuda, k):
    """The main path on the card, with and without the kernels, on rendered
    frames: identical detections and tilt. An odd K takes the pack=1
    gather."""
    import dataclasses

    from vision_basedsensor_tpu_torch.detect import detector
    from vision_basedsensor_tpu_torch.pipeline import run_video
    from vision_basedsensor_tpu_torch.synth import default_scene, render_frames

    scene = default_scene(480, 640, device=cuda)
    d = torch.zeros((6, 65, 3), device=cuda)
    d[:, :, 2] = -0.3 * torch.arange(6, device=cuda)[:, None]
    frames = render_frames(scene, d)
    cfg = PipelineConfig()
    cfg = dataclasses.replace(cfg, detect=dataclasses.replace(
        cfg.detect, max_candidates=k))
    f0, g0 = kf.fields_launches, kg.gather_launches
    out = run_video(frames, scene.cam, cfg, apply_warmup=False)
    assert kf.fields_launches > f0 and kg.gather_launches > g0
    assert int(out.tracked.valid.sum(-1).min()) == 65

    def plain_gather(pack):
        def gather(packed, peaks, geom, prof):
            start = kg._prep(packed.shape[1], packed.shape[2], peaks, prof)
            return (kg.gather_windows_reference(packed, start,
                                                prof.patch_size, pack), start)
        return gather

    saved = (detector.fused_fields, detector.gather_windows_paired,
             detector.gather_windows)
    detector.fused_fields = kf.fused_fields_reference
    detector.gather_windows_paired = plain_gather(2)
    detector.gather_windows = plain_gather(1)
    try:
        plain = run_video(frames, scene.cam, cfg, apply_warmup=False)
    finally:
        (detector.fused_fields, detector.gather_windows_paired,
         detector.gather_windows) = saved
    for name in out.detections._fields:
        assert torch.equal(getattr(out.detections, name),
                           getattr(plain.detections, name)), name
    assert torch.equal(out.contact.tilt_deg, plain.contact.tilt_deg)


def _expand_positions(rng, layout, total, k):
    """``k`` positions (unsorted) laid out over ``total`` slots."""
    tile = 4096
    tiles = -(-total // tile)
    if layout == "uniform":     # out-of-range entries at both ends
        return rng.integers(-3, total + 50, k)
    if layout == "one_tile":    # every entry in one tile
        return (tiles // 3) * tile + rng.integers(0, tile, k)
    if layout == "skew":        # every entry in the first 5% of the tiles
        return rng.integers(0, max(tile, total // 20), k)
    if layout == "gaps":        # a few busy tiles between runs of empty ones
        busy = rng.choice(tiles - 1, 12, replace=False)
        return busy[rng.integers(0, 12, k)] * tile + rng.integers(0, tile, k)
    if layout == "edge_dups":   # the same slot repeated on both sides of edges
        edges = tile * rng.integers(1, tiles, k // 4 + 1)
        return np.repeat(edges, 4)[:k] + np.tile([-1, -1, 0, 0], k)[:k]
    raise ValueError(layout)


@pytest.mark.parametrize("layout,total,n,m", [
    ("uniform", 4096 * 3, 500, 0), ("uniform", 4096 * 3 + 1000, 700, 30),
    ("uniform", 4 * 4800 * 64, 80000, 500), ("uniform", 5, 3, 3),
    ("uniform", 100, 0, 0),
    ("uniform", 4096 * 60000, 100000, 1000),   # runs capped: blocks > resident
    ("one_tile", 4096 * 64, 5000, 40),
    ("skew", 4096 * 2000, 60000, 300),
    ("gaps", 4096 * 3000, 3000, 50),
    ("edge_dups", 4096 * 50 + 7, 2000, 20),
    ("uniform", 4096 * 10, 0, 300),            # no main entries, a spill
])
def test_expand_kernel_matches_plain(cuda, layout, total, n, m):
    """K8 on sorted streams with duplicates, a spill stream and ragged
    tiles, laid out evenly, all in one tile, skewed to the first tiles,
    around runs of empty tiles and across tile edges: int16 equal to the
    plain version."""
    from vision_basedsensor_tpu_torch.ops.cuda import expand as kx
    from vision_basedsensor_tpu_torch.ops.expand import expand_sorted_reference

    rng = np.random.default_rng(6)
    pos = np.sort(_expand_positions(rng, layout, total, n)).astype(np.int32)
    val = rng.integers(-2000, 2000, n).astype(np.int16)
    spos = np.sort(_expand_positions(rng, layout, total, m)).astype(np.int32)
    sval = rng.integers(-300, 300, m).astype(np.int16)
    t = [torch.from_numpy(a).to(cuda) for a in (pos, val, spos, sval)]
    before = kx.launches
    got = kx.expand_sorted(t[0], t[1], total, t[2], t[3])
    want = expand_sorted_reference(*t[:2], total, *t[2:])
    torch.cuda.synchronize()
    assert kx.launches == before + 1
    assert got.dtype == torch.int16 and torch.equal(got, want)
    assert torch.equal(kx.expand_sorted(t[0], t[1], total),
                       expand_sorted_reference(t[0], t[1], total))


def test_expand_wrapper_refuses_bad_inputs(cuda):
    from vision_basedsensor_tpu_torch.ops.cuda import expand as kx

    pos = torch.arange(10, dtype=torch.int32, device=cuda)
    val = torch.ones(10, dtype=torch.int16, device=cuda)
    for args in ((pos.long(), val, 20), (pos, val.int(), 20),
                 (pos[::2], val[::2], 20), (pos, val[:5], 20),
                 (pos, val, 2 ** 31), (pos, val, 20, pos.cpu(), val.cpu()),
                 (pos, val, 20, pos, None)):
        with pytest.raises(ValueError):
            kx.expand_sorted(*args)


def test_jpeg_transports_on_the_card(cuda):
    """Rendered frames through the port's encoder and every transport on the
    card: bitwise equal to the dense transport, within one gray level of
    the CPU decode, and the scatter runs on K8 (one launch per batch, two
    for SPLIT's AC and DC spill streams, none for DENSE)."""
    from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg
    from vision_basedsensor_tpu_torch.ops import jpeg as tj
    from vision_basedsensor_tpu_torch.ops.cuda import expand as kx
    from vision_basedsensor_tpu_torch.synth import default_scene, render_frames

    scene = default_scene(480, 640, device=cuda)
    d = torch.zeros((6, 65, 3), device=cuda)
    d[:, :, 2] = -0.002 * torch.arange(6, device=cuda)[:, None]
    frames = render_frames(scene, d).to(torch.uint8).cpu().numpy()
    jpegs = [encode_jpeg(f, 70) for f in frames]
    dec = tj.MjpegBatchDecoder(device=cuda)
    dense = dec.dense_to_device(dec.entropy_decode_dense(jpegs))
    for transport, n in (("packed", 1), ("split", 2), ("tdelta", 1)):
        host = getattr(dec, f"entropy_decode_{transport}")(jpegs)
        before = kx.launches
        got = getattr(dec, f"{transport}_to_device")(host)
        torch.cuda.synchronize()
        assert kx.launches == before + n, transport
        assert torch.equal(got, dense), transport
    cpu = tj.MjpegBatchDecoder(device="cpu")
    want = cpu.tdelta_to_device(cpu.entropy_decode_tdelta(jpegs))
    assert float((dense.cpu() - want).abs().max()) <= 1.0


def _scan_inputs(rng, b, n, dev, with_carry):
    """Positions walking 0.3 mm a frame with 60 mm misreads (over the 50 mm
    step gate), a random occlusion pattern, and optionally a carry."""
    start = np.concatenate([rng.uniform(-15, 15, (n, 2)),
                            rng.uniform(18, 22, (n, 1))], -1)
    walk = np.cumsum(rng.normal(0.0, 0.3, (b, n, 3)), axis=0)
    misread = (rng.random((b, n)) < 0.05)[..., None] * np.array([0, 60.0, 0])
    seen = rng.random((b, n)) < 0.7
    world = np.where(seen[..., None], start + walk + misread, 0.0)
    carry = None
    if with_carry:
        carry = dict(last=start + 0.5, last_ok=rng.random(n) < 0.7,
                     first=start - 0.5, first_ok=rng.random(n) < 0.7,
                     cum=rng.random(n) * 20.0)
        carry = {k: torch.as_tensor(v, dtype=torch.bool if v.dtype == bool
                                    else torch.float32, device=dev)
                 for k, v in carry.items()}
    return (torch.as_tensor(world, dtype=torch.float32, device=dev),
            torch.as_tensor(seen, device=dev), carry)


@pytest.mark.parametrize("b,n", [(0, 65), (1, 65), (7, 65), (1024, 65),
                                 (50, 300)])
@pytest.mark.parametrize("with_carry", [False, True])
def test_displacement_scan_kernel_matches_plain(cuda, b, n, with_carry):
    """One launch: flags and copied fields bit-equal to the plain loop,
    norms within 1e-6, cum_path within 1e-5; zero frames return empty
    outputs and the carry unchanged."""
    from vision_basedsensor_tpu_torch.config import ReconstructConfig
    from vision_basedsensor_tpu_torch.ops.cuda import scan as kscan
    from vision_basedsensor_tpu_torch.reconstruct.displacement import (
        displacement_scan, displacement_scan_reference)

    world, seen, carry = _scan_inputs(np.random.default_rng(12 + b), b, n,
                                      cuda, with_carry)
    cfg = ReconstructConfig()
    before = kscan.scan_launches
    got, gfin = displacement_scan(world, seen, cfg, carry, return_carry=True)
    want, wfin = displacement_scan_reference(world, seen, cfg, carry, True)
    torch.cuda.synchronize()
    assert kscan.scan_launches == before + 1
    for name in ("step", "step_valid", "from_first"):
        a, w = getattr(got, name), getattr(want, name)
        assert a.shape == w.shape and torch.equal(a, w), name
    for name, tol in (("step_norm", 1e-6), ("from_first_norm", 1e-6),
                      ("cum_path", 1e-5)):
        a, w = getattr(got, name), getattr(want, name)
        assert a.shape == w.shape, name
        torch.testing.assert_close(a, w, atol=tol, rtol=0, msg=name)
    for k in ("last", "last_ok", "first", "first_ok"):
        assert torch.equal(gfin[k], wfin[k]), k
    torch.testing.assert_close(gfin["cum"], wfin["cum"], atol=1e-5, rtol=0)
    if b == 0:
        assert got.step.shape == (0, n, 3)
        if carry is not None:
            assert all(torch.equal(gfin[k], carry[k]) for k in carry)


def _assoc_inputs(rng, b, k, dev, n=65):
    """A frame-0 table on a 30 px grid (slot 7 empty) and detections: the
    markers drifting 0.5 px a frame with jitter, shuffled among clutter, on
    a 0.5 px grid so that equal distances (ties) occur."""
    from vision_basedsensor_tpu_torch.detect.detector import Detections
    from vision_basedsensor_tpu_torch.track.rings import ReferenceMarkers

    g = np.stack(np.meshgrid(np.arange(12), np.arange(12)), -1).reshape(-1, 2)
    ref_xy = g[:n] * 30.0 + 40.0
    ref_valid = np.ones(n, bool)
    ref_valid[7 % n] = n <= 7
    xy = np.empty((b, k, 2))
    for t in range(b):
        pts = np.concatenate([ref_xy + [0.5 * t, 0.0]
                              + rng.normal(0, 1.5, (n, 2)),
                              rng.random((k - n, 2)) * 400.0])
        xy[t] = np.round(pts[rng.permutation(k)] * 2) / 2
    f = dict(dtype=torch.float32, device=dev)
    ref = ReferenceMarkers(xy=torch.as_tensor(ref_xy, **f),
                           axes=torch.ones((n, 2), **f),
                           angle=torch.zeros(n, **f),
                           ring=torch.zeros(n, dtype=torch.int32, device=dev),
                           valid=torch.as_tensor(ref_valid, device=dev))
    det = Detections(xy=torch.as_tensor(xy, **f),
                     axes=torch.as_tensor(rng.random((b, k, 2)) * 9 + 5, **f),
                     angle=torch.as_tensor(rng.random((b, k)) * 180, **f),
                     score=torch.ones((b, k), **f),
                     valid=torch.as_tensor(rng.random((b, k)) < 0.8,
                                           device=dev))
    return ref, det


@pytest.mark.parametrize("b,k", [(0, 96), (1, 97), (7, 96), (1024, 97)])
@pytest.mark.parametrize("with_carry", [False, True])
def test_associate_kernel_matches_plain(cuda, b, k, with_carry):
    """One launch: picks, flags and the copied xy/axes/angle bit-equal to
    the plain loop, with ties from a 0.5 px grid; zero frames return empty
    outputs and the carry unchanged."""
    from vision_basedsensor_tpu_torch.ops.cuda import scan as kscan
    from vision_basedsensor_tpu_torch.track.associate import (
        associate_sequential, associate_sequential_reference)

    rng = np.random.default_rng(40 + b)
    ref, det = _assoc_inputs(rng, b, k, cuda)
    carry = ref.xy + 2.0 if with_carry else None
    before = kscan.assoc_launches
    got, glast = associate_sequential(ref, det, 20.0, carry_xy=carry,
                                      return_carry=True)
    want, wlast = associate_sequential_reference(ref, det, 20.0, carry, True)
    torch.cuda.synchronize()
    assert kscan.assoc_launches == before + 1
    for name in ("xy", "axes", "angle", "valid"):
        a, w = getattr(got, name), getattr(want, name)
        assert a.shape == w.shape and torch.equal(a, w), name
    assert torch.equal(glast, wlast)
    if b == 0:
        assert got.xy.shape == (0, 65, 2)
        assert torch.equal(glast, ref.xy if carry is None else carry)
    else:
        assert int(got.valid[-1].sum()) >= 30


def test_scan_wrappers_refuse_bad_inputs(cuda):
    from vision_basedsensor_tpu_torch.ops.cuda import scan as kscan

    world, seen, carry = _scan_inputs(np.random.default_rng(3), 4, 65, cuda,
                                      True)
    bad = [(world.double(), seen, carry), (world.cpu(), seen.cpu(), None),
           (world, seen.cpu(), None), (world.transpose(0, 1), seen, None),
           (world, seen.float(), None),
           (world, seen, {**carry, "cum": carry["cum"].double()}),
           (world, seen, {**carry, "last_ok": carry["last_ok"].cpu()})]
    for w, s, c in bad:
        with pytest.raises(ValueError):
            kscan.displacement_scan(w, s, 50.0, c)
    ref, det = _assoc_inputs(np.random.default_rng(4), 3, 96, cuda)
    big_ref, big_det = _assoc_inputs(np.random.default_rng(5), 2,
                                     kscan.MAX_DETECTIONS + 1, cuda)
    for r, d, c in ((ref, det._replace(xy=det.xy.double()), None),
                    (ref, det._replace(valid=det.valid.cpu()), None),
                    (ref._replace(xy=ref.xy.cpu()), det, None),
                    (ref, det, ref.xy.double()),
                    (big_ref, big_det, None)):
        with pytest.raises(ValueError):
            kscan.associate_sequential(r, d, 20.0, c)
    many_ref, many_det = _assoc_inputs(np.random.default_rng(6), 2, 140, cuda,
                                       n=kscan.MAX_SLOTS + 1)
    with pytest.raises(ValueError):
        kscan.associate_sequential(many_ref, many_det, 20.0)


def _scan_against_plain(cuda, world, seen, carry):
    """One kernel launch against the plain loop: flags and copies
    bit-equal, norms within 1e-6, cum_path and cum within 1e-5."""
    from vision_basedsensor_tpu_torch.config import ReconstructConfig
    from vision_basedsensor_tpu_torch.reconstruct.displacement import (
        displacement_scan, displacement_scan_reference)

    cfg = ReconstructConfig()
    got, gfin = displacement_scan(world, seen, cfg, carry, return_carry=True)
    want, wfin = displacement_scan_reference(world, seen, cfg, carry, True)
    torch.cuda.synchronize()
    for name in ("step", "step_valid", "from_first"):
        a, w = getattr(got, name), getattr(want, name)
        assert a.shape == w.shape and torch.equal(a, w), name
    for name, tol in (("step_norm", 1e-6), ("from_first_norm", 1e-6),
                      ("cum_path", 1e-5)):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   atol=tol, rtol=0, msg=name)
    for k in ("last", "last_ok", "first", "first_ok"):
        assert torch.equal(gfin[k], wfin[k]), k
    torch.testing.assert_close(gfin["cum"], wfin["cum"], atol=1e-5, rtol=0)
    return got, gfin


@pytest.mark.parametrize("b", [8, 9, 1023, 1024, 1025, 2049])
@pytest.mark.parametrize("with_carry", [False, True])
def test_displacement_scan_kernel_across_tiles(cuda, b, with_carry):
    """Batches on either side of the walking kernel's 8 frames and of the
    tiled kernel's 1024-frame tile: the carry crosses tiles in shared
    memory, as the plain loop carries it."""
    world, seen, carry = _scan_inputs(np.random.default_rng(70 + b), b, 65,
                                      cuda, with_carry)
    _scan_against_plain(cuda, world, seen, carry)


@pytest.mark.parametrize("n", [1, 128])
def test_displacement_scan_kernel_marker_counts(cuda, n):
    """One marker (a block with 3 idle marker slots) and 128 markers."""
    world, seen, carry = _scan_inputs(np.random.default_rng(80 + n), 300, n,
                                      cuda, True)
    _scan_against_plain(cuda, world, seen, carry)


def test_displacement_scan_kernel_unseen_markers(cuda):
    """A marker never seen (fresh and with a carry that never saw it), one
    seen only in the carry, one seen only in the last frame of a tile and
    one only in the first frame of the next: their outputs and carries
    equal the plain loop's."""
    world, seen, carry = _scan_inputs(np.random.default_rng(90), 1100, 65,
                                      cuda, True)
    seen[:, :4] = False
    seen[1023, 2] = True
    seen[1024, 3] = True
    carry["last_ok"][0] = carry["first_ok"][0] = False
    carry["last_ok"][1] = carry["first_ok"][1] = True
    world = torch.where(seen[..., None], world, torch.zeros_like(world))
    got, gfin = _scan_against_plain(cuda, world, seen, carry)
    assert not bool(got.step_valid[:, :2].any())
    assert torch.equal(gfin["last"][1], carry["last"][1])
    _, fresh = _scan_against_plain(cuda, world, seen, None)
    assert not bool(fresh["last_ok"][0]) and not bool(fresh["first_ok"][1])


def _assoc_against_plain(ref, det, gate, carry=None):
    """One kernel launch bit-equal to the plain loop; returns its result."""
    from vision_basedsensor_tpu_torch.track.associate import (
        associate_sequential, associate_sequential_reference)

    got, glast = associate_sequential(ref, det, gate, carry_xy=carry,
                                      return_carry=True)
    want, wlast = associate_sequential_reference(ref, det, gate, carry, True)
    torch.cuda.synchronize()
    for name in ("xy", "axes", "angle", "valid"):
        a, w = getattr(got, name), getattr(want, name)
        assert a.shape == w.shape and torch.equal(a, w), name
    # A NaN in the given carry stays where no detection is taken.
    assert torch.equal(glast.isnan(), wlast.isnan())
    assert torch.equal(glast.nan_to_num(), wlast.nan_to_num())
    return got


@pytest.mark.parametrize("n,k", [(1, 96), (128, 96), (65, 1), (65, 1024)])
def test_associate_kernel_slot_and_detection_counts(cuda, n, k):
    """One slot, 128 slots (4 lanes a slot), one detection a frame and
    1024 (two frames a staged run)."""
    b = 40
    rng = np.random.default_rng(100 + n + k)
    ref, det = _assoc_inputs(rng, b, max(k, n), cuda, n=n)
    if k < n:
        det = det._replace(**{f: getattr(det, f)[:, :k].contiguous()
                              for f in ("xy", "axes", "angle", "score",
                                        "valid")})
    _assoc_against_plain(ref, det, 20.0, ref.xy + 1.0)


def test_associate_kernel_nan_detections(cuda):
    """Detections with a NaN coordinate marked valid: NaN counts as the
    least distance, so the slots near one pick it and are not valid, and
    the first of them (by index) keeps the pick from the others."""
    ref, det = _assoc_inputs(np.random.default_rng(110), 30, 96, cuda)
    xy = det.xy.clone()
    xy[::3, 5, 0] = float("nan")
    xy[1::3, 9, 1] = float("nan")
    xy[::2, 40] = float("nan")
    valid = det.valid.clone()
    valid[:, [5, 9, 40]] = True
    got = _assoc_against_plain(ref, det._replace(xy=xy, valid=valid), 20.0)
    assert not bool(got.valid[::2].any())


def test_associate_kernel_infinite_gate_and_nan_carry(cuda):
    """gate = +inf, with frames whose detections are all invalid (every
    distance inf: slot 0 owns index 0 and takes its unstaged values), and
    a carry with NaN and inf entries (those slots take the NaN-aware
    compare): bit-equal to the plain loop."""
    ref, det = _assoc_inputs(np.random.default_rng(130), 12, 96, cuda)
    valid = det.valid.clone()
    valid[3] = False
    valid[7, 1:] = False
    det = det._replace(valid=valid)
    _assoc_against_plain(ref, det, float("inf"))
    carry = ref.xy + 1.0
    carry[2, 0] = float("nan")
    carry[5, 1] = float("inf")
    _assoc_against_plain(ref, det, 20.0, carry)
    _assoc_against_plain(ref, det, float("inf"), carry)


def test_associate_kernel_ties(cuda):
    """Equal squared distances (a candidate mirrored about the slot), and
    squared distances that differ by one ulp but give the same sqrtf: in
    both, the lower index wins, in the same lane and across lanes."""
    n, k, b = 65, 96, 6
    rng = np.random.default_rng(120)
    ref, det = _assoc_inputs(rng, b, k, cuda)
    last = np.round(ref.xy.cpu().numpy() + 2.0).astype(np.float32)
    xy = np.asarray(rng.random((b, k, 2)) * 4000.0 + 6000.0, np.float32)
    valid = np.ones((b, k), bool)
    e = np.float32(np.sqrt(np.spacing(np.float32(100.0))))
    cur = last.copy()   # the carry each frame starts from
    for t in range(b):
        for s in range(0, 60, 6):
            lo, hi = s + t % 3, s + t % 3 + (8 if t % 2 else 1)
            if t < 3:   # mirrored: equal squares, the higher index first
                xy[t, hi] = cur[s] + [3.0, 4.0]
                xy[t, lo] = cur[s] - [3.0, 4.0]
            else:       # one ulp apart: the lower index the larger square
                xy[t, hi] = cur[s] + [10.0, 0.0]
                xy[t, lo] = cur[s] + [10.0, e]
            d = cur[s] - xy[t, [lo, hi]]
            sq = (d[:, 0] * d[:, 0]) + (d[:, 1] * d[:, 1])
            assert np.sqrt(sq[0]) == np.sqrt(sq[1])
            assert sq[0] == sq[1] if t < 3 else sq[0] > sq[1]
            cur[s] = xy[t, lo]
    f = dict(dtype=torch.float32, device=cuda)
    det = det._replace(xy=torch.as_tensor(xy, **f),
                       valid=torch.as_tensor(valid, device=cuda))
    got = _assoc_against_plain(ref, det, 20.0, torch.as_tensor(last, **f))
    for t in range(b):
        for s in range(0, 60, 6):
            assert torch.equal(got.xy[t, s], det.xy[t, s + t % 3]), (t, s)


@pytest.mark.parametrize("transport", ["tdelta", "split", "packed"])
def test_mjpeg_cuda_video_source_on_the_card(cuda, transport):
    """The live stream decoded on the card (``StreamingPipeline.run``'s feed
    included): within one gray level of ``MjpegBatchDecoder`` on the CPU
    on the same chunks, K8 launched for every chunk, nothing dropped, and
    the session's byte accounting summed over the chunks."""
    from torch_parity import MjpegServer

    from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg
    from vision_basedsensor_tpu_torch.io.mjpeg import MjpegCudaVideoSource
    from vision_basedsensor_tpu_torch.io.video import device_feed
    from vision_basedsensor_tpu_torch.ops import jpeg as tj
    from vision_basedsensor_tpu_torch.ops.cuda import expand as kx
    from vision_basedsensor_tpu_torch.synth import default_scene, render_frames

    scene = default_scene(480, 640, device=cuda)
    d = torch.zeros((7, 65, 3), device=cuda)
    d[:, :, 2] = -0.05 * torch.arange(7, device=cuda)[:, None]
    frames = render_frames(scene, d).to(torch.uint8).cpu().numpy()
    jpegs = [encode_jpeg(f, 70) for f in frames]
    srv = MjpegServer(jpegs)
    try:
        src = MjpegCudaVideoSource(srv.url, transport=transport, device=cuda)
        before = kx.launches
        got = list(device_feed(src, 3, cuda))
        torch.cuda.synchronize()
    finally:
        srv.close()
    assert [g.shape for g in got] == [(3, 480, 640), (3, 480, 640),
                                      (1, 480, 640)]
    assert all(g.device.type == "cuda" for g in got)
    assert kx.launches - before >= len(got)
    cpu = tj.MjpegBatchDecoder(device="cpu")
    for i, g in enumerate(got):
        host = getattr(cpu, f"entropy_decode_{transport}")(jpegs[3 * i:3 * i + 3])
        want = getattr(cpu, f"{transport}_to_device")(host)
        assert float((g.cpu() - want).abs().max()) <= 1.0, i
    assert src.last_dropped == 0 and src.last_stats["frames"] == 7


def test_contact_state_payload_from_the_card(cuda):
    """The ``/state`` payload of a contact state on the card equals the one
    of the same state on the CPU, and is plain JSON."""
    import json

    from vision_basedsensor_tpu_torch.analysis import contact_state_sequence
    from vision_basedsensor_tpu_torch.config import (AnalysisConfig,
                                                     ReconstructConfig)
    from vision_basedsensor_tpu_torch.io.publish import contact_state_payload
    from vision_basedsensor_tpu_torch.reconstruct import displacement_scan
    from vision_basedsensor_tpu_torch.synth import tilt_deviation_field

    world = torch.zeros((3, 65, 3))
    world[1] = tilt_deviation_field(7.0, compression_mm=0.3, device="cpu")
    world[2] = tilt_deviation_field(15.0, compression_mm=0.0, device="cpu")
    seen = torch.ones((3, 65), dtype=torch.bool)
    seen[1, ::7] = False
    rcfg, acfg = ReconstructConfig(warmup_frames=0), AnalysisConfig()
    states = {dev: contact_state_sequence(displacement_scan(
        world.to(dev), seen.to(dev), rcfg), acfg) for dev in ("cpu", cuda)}
    for i in (1, -1):
        got = contact_state_payload(states[cuda], i, 3)
        want = contact_state_payload(states["cpu"], i, 3)
        assert json.loads(json.dumps(got)) == got
        assert got.keys() == want.keys() and got["valid"] == want["valid"]
        for k in ("tilt_deg", "plane", "mean_vector_mm", "mean_magnitude_mm"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert abs(got["tilt_deg"] - 15.0) < 1e-2 and got["valid"] is True


@pytest.mark.parametrize("shape", [(4, 480, 640), (2, 437, 467)])
def test_sep_filter_bf16_on_the_card(cuda, shape):
    """The fast_filters GEMMs on the card against their CPU plain version
    on the same input: the H pass's output is bfloat16 (float32 sums in
    another order: at most one bfloat16 step apart), the W pass gives
    float32 (not rounded to bfloat16) within float32 sum-order error, and
    the two passes together within one H-pass step through the W taps."""
    from vision_basedsensor_tpu_torch.core.imaging import (_sep_filter,
                                                           gaussian_taps)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.integers(0, 256, shape), dtype=torch.float32)
    taps = gaussian_taps(17, 8.0)
    bf = torch.bfloat16
    h_gpu = _sep_filter(x.to(cuda), taps, None, "reflect101", bf).cpu()
    h_cpu = _sep_filter(x, taps, None, "reflect101", bf)
    assert h_gpu.dtype == torch.float32
    assert torch.equal(h_gpu, h_gpu.bfloat16().float())
    step = torch.abs(h_cpu) * 2.0 ** -7
    assert bool((torch.abs(h_gpu - h_cpu) <= step).all())

    w_gpu = _sep_filter(x.to(cuda), None, taps, "zero", bf)
    assert w_gpu.dtype == torch.float32
    w_gpu = w_gpu.cpu()
    w_cpu = _sep_filter(x, None, taps, "zero", bf)
    np.testing.assert_allclose(w_gpu.numpy(), w_cpu.numpy(), rtol=1e-5,
                               atol=1e-3)
    assert not torch.equal(w_gpu, w_gpu.bfloat16().float())

    both_gpu = _sep_filter(x.to(cuda), taps, taps, "reflect101", bf).cpu()
    both_cpu = _sep_filter(x, taps, taps, "reflect101", bf)
    assert float((both_gpu - both_cpu).abs().max()) <= 255.0 * 2.0 ** -7


def _calibration_views(n_views=8, noise=0.2, seed=3):
    """Corners of a 6x6 board seen through a known camera, on the CPU."""
    from vision_basedsensor_tpu_torch.calibrate.images import \
        board_object_points
    from vision_basedsensor_tpu_torch.calibrate.zhang import (
        intrinsic_camera, project_posed)
    from vision_basedsensor_tpu_torch.core.transforms import rodrigues
    rng = np.random.default_rng(seed)
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    cam = intrinsic_camera(f64(620.0), f64(600.0), f64(310.0), f64(245.0),
                           f64([-0.15, 0.07, 0.0008, -0.0006, 0.02]))
    obj = board_object_points((6, 6), 3.0)
    imgs = []
    for _ in range(n_views):
        rvec = f64(rng.uniform(-0.35, 0.35, 3))
        tvec = f64([rng.uniform(-8, 2), rng.uniform(-8, 2),
                    rng.uniform(45, 75)])
        uv = project_posed(cam, rodrigues(rvec), tvec, f64(obj)).numpy()
        imgs.append(uv + rng.normal(0, noise, uv.shape))
    return np.stack([obj] * n_views), np.stack(imgs), cam


def test_calibrate_intrinsics_on_the_card(cuda):
    """Zhang's solve in float64 on the card: the same result as on the CPU
    within 1e-8 relative for the intrinsics, 1e-7 for the distortion and
    1e-9 for the RMS. cuSOLVER's SVD and LAPACK's differ in the last bits,
    and a least-squares solution with nonzero residuals moves with the
    square of the Jacobian's condition number (6e4 here). Observed on the
    H100: 3e-9 relative in cx, 2e-8 in the distortion (k3, the worst
    conditioned), 1e-15 in the RMS."""
    from vision_basedsensor_tpu_torch.calibrate import calibrate_intrinsics
    objs, imgs, _ = _calibration_views()
    got = calibrate_intrinsics(objs, imgs, device=cuda)
    want = calibrate_intrinsics(objs, imgs, device="cpu")
    assert got.cam.fx.device.type == cuda.type
    for name in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(float(getattr(got.cam, name)),
                                   float(getattr(want.cam, name)), rtol=1e-8)
    np.testing.assert_allclose(got.cam.dist.cpu().numpy(),
                               want.cam.dist.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(float(got.mean_reproj_error),
                               float(want.mean_reproj_error), atol=1e-9)
    # 0.2 px of noise on 8 views moves fx by ~15 px (on the CPU too).
    assert abs(float(got.cam.fx) - 620.0) < 20.0
    assert float(got.mean_reproj_error) < 0.3


@pytest.mark.parametrize("planar", [False, True])
def test_solve_pnp_ransac_on_the_card(cuda, planar):
    """PnP in float64 on the card: on the same hypotheses the same pose as
    on the CPU within 1e-9; its own draw (a generator on the card) rejects
    the same outliers."""
    from vision_basedsensor_tpu_torch import layout
    from vision_basedsensor_tpu_torch.calibrate import pnp
    from vision_basedsensor_tpu_torch.calibrate.zhang import project_posed
    from vision_basedsensor_tpu_torch.config import CalibrateConfig
    from vision_basedsensor_tpu_torch.core.camera import CameraModel
    from vision_basedsensor_tpu_torch.core.transforms import rodrigues
    rng = np.random.default_rng(7)
    _, _, cam = _calibration_views(1)
    world = layout.dome_layout()[:, 1:].astype(np.float64)
    if planar:
        world[:, 2] = 0.0
    R = rodrigues(torch.tensor([0.1, -0.2, 0.05], dtype=torch.float64))
    t = torch.tensor([1.0, -2.0, 45.0], dtype=torch.float64)
    img = project_posed(cam, R, t, torch.tensor(world)).numpy()
    img += rng.normal(0, 0.3, img.shape)
    out = rng.choice(65, 7, replace=False)
    img[out] += rng.uniform(20, 40, (7, 2)) * rng.choice([-1, 1], (7, 2))
    cfg = CalibrateConfig()
    on = {d: CameraModel(*(v.to(d) for v in cam)) for d in ("cpu", cuda)}
    prob_cpu = pnp.prepare(world, img, on["cpu"])
    idx = pnp.draw_hypotheses(65, prob_cpu.m_min, 1000, 0,
                              torch.device("cpu"))
    want = pnp.solve_from_hypotheses(prob_cpu, idx, cfg)
    got = pnp.solve_from_hypotheses(pnp.prepare(world, img, on[cuda]),
                                    idx.to(cuda), cfg)
    np.testing.assert_allclose(got.R_wc.cpu().numpy(), want.R_wc.numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(got.T_wc.cpu().numpy(), want.T_wc.numpy(),
                               atol=1e-9)
    assert torch.equal(got.inliers.cpu(), want.inliers)
    own = pnp.solve_pnp_ransac(world, img, on[cuda], cfg)
    assert own.R_wc.device.type == cuda.type
    assert sorted(np.where(~own.inliers.cpu().numpy())[0]) == sorted(out)
    np.testing.assert_allclose(own.T_wc.cpu().numpy(), t.numpy(), atol=0.1)


def _mesh_inputs(dev, b=6):
    from vision_basedsensor_tpu_torch.synth import default_scene, render_frames
    scene = default_scene(480, 640, device=dev)
    d = torch.zeros((b, 65, 3), device=dev)
    d[:, :, 2] = -0.1 * torch.arange(b, device=dev)[:, None]
    return scene, render_frames(scene, d)


def test_mesh_on_one_card_matches_one_batch(cuda):
    """A [cuda:0, cuda:0] mesh (the shards in turn on one card) equals one
    process_frames batch; each shard launches the fields and gather kernels
    once, the step the scan once."""
    from vision_basedsensor_tpu_torch.ops.cuda import scan as kscan
    from vision_basedsensor_tpu_torch.parallel import (make_mesh,
                                                       make_sharded_pipeline,
                                                       shard_frames)
    from vision_basedsensor_tpu_torch.pipeline import (initialize,
                                                       process_frames)
    scene, frames = _mesh_inputs(cuda, b=5)
    cfg = PipelineConfig()
    ref = initialize(frames[0], cfg)
    base = process_frames(frames, ref, scene.cam, cfg)
    mesh = make_mesh([cuda, cuda])
    step = make_sharded_pipeline(mesh, scene.cam, cfg)
    s0 = kscan.scan_launches
    out = step(shard_frames(frames, mesh), ref)
    torch.cuda.synchronize()
    assert kscan.scan_launches == s0 + 1
    assert [(c["fields"], c["gather"]) for c in step.last_shard_launches] \
        == [(1, 1), (1, 1)]
    assert_recon_close(out, base)
    assert int(out.tracked.valid.sum(-1).min()) == 65
    assert {t["name"].split(".")[0] for t in step.last_transfers} \
        == {"ref", "detections"}


def test_shard_on_a_second_card(cuda):
    """A shard on cuda:1 while cuda:0 is the thread's device: its kernels
    launch on cuda:1 and its frames give cuda:0's results."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    from vision_basedsensor_tpu_torch.parallel import (make_mesh,
                                                       make_sharded_pipeline,
                                                       shard_frames)
    from vision_basedsensor_tpu_torch.pipeline import (initialize,
                                                       process_frames)
    dev1 = torch.device("cuda", 1)
    torch.cuda.set_device(cuda)
    ncc, area, gray = _random_fields(np.random.default_rng(2), 2, 96, 128,
                                     dev1)
    cfg = DetectConfig()
    got = kf.fused_fields(ncc, area, gray, cfg.ncc_threshold, cfg.open_ksize,
                          cfg.low_res)
    want = kf.fused_fields_reference(ncc, area, gray, cfg.ncc_threshold,
                                     cfg.open_ksize, cfg.low_res)
    torch.cuda.synchronize(dev1)
    assert got[0].device == dev1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    scene, frames = _mesh_inputs(cuda)
    pcfg = PipelineConfig()
    ref = initialize(frames[0], pcfg)
    base = process_frames(frames, ref, scene.cam, pcfg)
    mesh = make_mesh([cuda, dev1])
    sharded = shard_frames(frames, mesh)
    assert sharded.blocks[1].device == dev1
    step = make_sharded_pipeline(mesh, scene.cam, pcfg)
    out = step(sharded, ref)
    assert out.recon.world.device == cuda
    assert step.last_shard_launches[1]["fields"] == 1
    assert_recon_close(out, base)
    back = [t for t in step.last_transfers
            if t["src"] == str(dev1) and t["dst"] == str(cuda)]
    assert back and all(t["name"].startswith("detections.") for t in back)


def test_profile_to_on_the_card(cuda, tmp_path):
    import json

    from vision_basedsensor_tpu_torch.utils import trace_annotation
    from vision_basedsensor_tpu_torch.utils.profiling import profile_to
    x = torch.randn(256, 256, device=cuda)
    with profile_to(str(tmp_path)) as prof:
        with trace_annotation("vbs.detect.filters"):
            x @ x
        torch.cuda.synchronize()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    span = [e for e in events if e.get("name") == "vbs.detect.filters"
            and e.get("cat") == "user_annotation"]
    assert len(span) == 1
    # The span and the device activity it launched share one clock: the
    # matmul's launch call lies inside the span.
    a, b = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    launched = {e["args"]["correlation"] for e in events
                if str(e.get("cat")).startswith("cuda_")   # cudaLaunch*, cuLaunch*
                and a <= e["ts"] <= b and "correlation" in e.get("args", {})}
    assert any(e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launched
               for e in events)
    assert sum(e.device_time_total for e in prof.key_averages()) > 0


def test_encode_jpeg_without_cv2_on_the_card(cuda, monkeypatch):
    """The card's machine has no cv2: the served frames go through the
    numpy encoder and decode on the card to within JPEG's error."""
    from vision_basedsensor_tpu_torch.capture.server import (SyntheticCamera,
                                                             _encode_jpeg)
    from vision_basedsensor_tpu_torch.config import CaptureConfig
    from vision_basedsensor_tpu_torch.io import video
    from vision_basedsensor_tpu_torch.io.jpeg_encode import encode_jpeg
    from vision_basedsensor_tpu_torch.ops.jpeg import MjpegBatchDecoder
    from vision_basedsensor_tpu_torch.synth import default_scene
    monkeypatch.setattr(video, "_cv2", lambda: None)
    cam = SyntheticCamera(CaptureConfig(), default_scene(480, 640,
                                                         device=cuda))
    frame = cam.read()
    jpeg = _encode_jpeg(frame, 70)
    assert jpeg == encode_jpeg(frame[..., 0], 70)
    dec = MjpegBatchDecoder(device=cuda)
    x = dec.tdelta_to_device(dec.entropy_decode_tdelta([jpeg]))[0]
    err = (x - torch.from_numpy(frame[..., 0]).to(cuda).float()).abs()
    assert float(err.mean()) < 4


def _filter_frames(dev, b, h, w, seed, dtype=torch.uint8):
    """Rendered marker frames (cut to ``h x w``) plus seeded noise."""
    from vision_basedsensor_tpu_torch.synth import default_scene, render_frames
    scene = default_scene(max(h, 16), max(w, 16), device=dev)
    d = torch.zeros((b, 65, 3), device=dev)
    d[:, :, 2] = -0.3 * torch.arange(b, device=dev)[:, None]
    f = render_frames(scene, d).float()[:, :h, :w]
    g = torch.Generator(device=dev).manual_seed(seed)
    f = (f + 4.0 * torch.randn(f.shape, generator=g, device=dev)).clamp(0, 255)
    if dtype == torch.uint8:
        return f.round().to(torch.uint8).contiguous()
    return f.contiguous()


def _gemm_filters(frames, prof, mean=None, batch=512):
    """The plain path on the card: the banded cuBLAS GEMMs and their
    elementwise operations, on ``frames`` repeated to ``batch`` frames (the
    outputs of the first ``B``). Below that cuBLAS may split a GEMM's sum
    (a 480x640 batch of 4 does), and the NCC then differs from the
    unsplit sum in its last bits: up to 5.9e-6 on a 240x640 row shard."""
    from vision_basedsensor_tpu_torch.core.imaging import to_grayscale
    from vision_basedsensor_tpu_torch.ops.dog import dog_area_mask
    from vision_basedsensor_tpu_torch.ops.ncc import normxcorr_gaussian
    b = frames.shape[0]
    reps = -(-batch // b)
    frames = frames.repeat(reps, *(1,) * (frames.ndim - 1))
    if mean is not None:
        mean = mean.repeat(reps, 1, 1)
    gray = to_grayscale(frames).contiguous()
    area = dog_area_mask(gray, prof, DetectConfig().dog_offset).float()
    ncc = normxcorr_gaussian(area, prof.template_size, prof.template_sigma,
                             binary_input=True, mean=mean)
    return gray[:b], area[:b], ncc[:b]


@pytest.mark.parametrize("shape,profile,dtype", [
    ((4, 480, 640), "low_res", torch.uint8),
    ((2, 1080, 1920), "high_res", torch.uint8),
    ((2, 437, 467), "low_res", torch.uint8),    # W % 4 != 0
    ((2, 480, 640), "low_res", torch.float32),  # gray rounded in the kernel
    ((3, 61, 77), "high_res", torch.uint8),     # n < k: no interior span
    ((2, 7, 5), "low_res", torch.uint8),
])
def test_filters_kernel_matches_gemm_path(cuda, shape, profile, dtype):
    """gray, area and ncc of the stencil kernels bit for bit equal to the
    GEMM path on the same card (where cuBLAS does not split the sum), in
    two launches; gray and area also at the test's own batch."""
    from vision_basedsensor_tpu_torch.ops.cuda import filters as kfil
    prof = getattr(DetectConfig(), profile)
    frames = _filter_frames(cuda, *shape, seed=7, dtype=dtype)
    want = _gemm_filters(frames, prof, batch=2 if shape[1] == 1080 else 512)
    before = kfil.filters_launches
    got = kfil.filter_fields(frames, prof, DetectConfig().dog_offset)
    assert kfil.filters_launches == before + 2
    for name, g, w in zip(("gray", "area", "ncc"), got, want):
        assert torch.equal(g, w), name
    own = _gemm_filters(frames, prof, batch=1)
    assert torch.equal(got[0], own[0]) and torch.equal(got[1], own[1])
    if shape[1] >= 437:   # whole markers in the frame
        assert 0.0 < float(want[1].mean()) < 1.0
        assert float(want[2].max()) > 0.5


def test_filters_kernel_row_shard_and_strided_frames(cuda):
    """A row shard (rows 100-339 with the whole frame's mean, as
    parallel/spatial.py runs it), column-cropped frames (strided rows) and
    color frames: bit for bit the GEMM path."""
    from vision_basedsensor_tpu_torch.ops.cuda import filters as kfil
    prof = DetectConfig().low_res
    frames = _filter_frames(cuda, 2, 480, 640, seed=9)
    _, full, _ = _gemm_filters(frames, prof)
    mean = (full.sum((-2, -1)) / (480 * 640))[:, None, None]
    block = frames[:, 100:340]
    gray, area, _ = kfil.dog_fields(block, prof, DetectConfig().dog_offset)
    ncc = kfil.binary_ncc(area, prof, mean=mean)
    want = _gemm_filters(block, prof, mean=mean)
    for name, g, w in zip(("gray", "area", "ncc"), (gray, area, ncc), want):
        assert torch.equal(g, w), name

    crop = frames[:, :, 37:601]
    assert crop.stride(1) == 640
    for got, w in zip(kfil.filter_fields(crop, prof), _gemm_filters(crop, prof)):
        assert torch.equal(got, w)
    color = torch.stack([frames, frames.roll(1, -1), frames.flip(-1)], -1)
    for got, w in zip(kfil.filter_fields(color, prof),
                      _gemm_filters(color, prof)):
        assert torch.equal(got, w)


def test_detect_batch_runs_the_filter_kernels(cuda, tmp_path):
    """A detect batch launches the two filter kernels, and its traced
    ``vbs.detect.filters`` span launches no GEMM: both kernels, a fill."""
    import json
    import re

    from vision_basedsensor_tpu_torch.detect.detector import detect_markers
    from vision_basedsensor_tpu_torch.ops.cuda import filters as kfil
    from vision_basedsensor_tpu_torch.utils.profiling import profile_to
    _, frames = _mesh_inputs(cuda, b=4)
    cfg = DetectConfig()
    detect_markers(frames, cfg)
    torch.cuda.synchronize()
    before = kfil.filters_launches
    with profile_to(str(tmp_path)):
        detect_markers(frames, cfg)
        torch.cuda.synchronize()
    assert kfil.filters_launches == before + 2
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    span = [e for e in events if e.get("name") == "vbs.detect.filters"
            and e.get("cat") == "user_annotation"]
    assert len(span) == 1
    a, b = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    launched = {e["args"]["correlation"] for e in events
                if str(e.get("cat")).startswith("cuda_")
                and a <= e["ts"] <= b and "correlation" in e.get("args", {})}
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launched]
    assert sum("stencil_kernel" in k for k in kernels) == 2, kernels
    assert not [k for k in kernels
                if re.search(r"gemm|nvjet|xmma|cutlass", k, re.I)], kernels


def test_filters_wrappers_refuse_bad_inputs(cuda):
    from vision_basedsensor_tpu_torch.ops.cuda import filters as kfil
    prof = DetectConfig().low_res
    frames = _filter_frames(cuda, 1, 64, 96, seed=1)
    with pytest.raises(TypeError):
        kfil.dog_fields(frames.int(), prof)
    with pytest.raises(ValueError):
        kfil.dog_fields(frames.transpose(1, 2).contiguous().transpose(1, 2),
                        prof)
    with pytest.raises(ValueError):
        kfil.dog_fields(frames[0], prof)
    _, area, count = kfil.dog_fields(frames, prof)
    with pytest.raises(TypeError):
        kfil.binary_ncc(area.double(), prof)
    with pytest.raises(ValueError):
        kfil.binary_ncc(area.transpose(1, 2).contiguous().transpose(1, 2),
                        prof)
    with pytest.raises(ValueError):
        kfil.binary_ncc(area, prof, count=count.cpu())
    with pytest.raises(TypeError):
        kfil.binary_ncc(area, prof, count=count.float())
    with pytest.raises(ValueError):
        kfil.binary_ncc(area, prof, mean=torch.zeros(2, device=cuda))
    with pytest.raises(ValueError):     # neither count nor mean
        kfil.binary_ncc(area, prof)
    with pytest.raises(ValueError):     # both
        kfil.binary_ncc(area, prof, count=count,
                        mean=torch.zeros(1, device=cuda))


def test_detect_never_waits_for_the_card(cuda):
    """Once its cached filter matrices are on the card, detect makes no
    call that makes the host wait for the card: parallel/mesh.py issues the
    next shard while this one runs only then."""
    from vision_basedsensor_tpu_torch.detect.detector import detect_markers
    _, frames = _mesh_inputs(cuda, b=2)
    cfg = DetectConfig()
    scale = torch.ones((), device=cuda)
    detect_markers(frames, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        detect_markers(frames, cfg, axis_scale=scale)
        detect_markers(frames, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _spatial_inputs(cuda):
    """Rendered 480x640 frames, the reference table and process_frames of
    the unfused branch (a spatial mesh's detector) on one card."""
    import dataclasses
    from vision_basedsensor_tpu_torch.pipeline import (initialize,
                                                       process_frames)
    scene, frames = _mesh_inputs(cuda, b=4)
    cfg = PipelineConfig()
    xcfg = dataclasses.replace(cfg, detect=dataclasses.replace(
        cfg.detect, backend="xla"))
    ref = initialize(frames[0], xcfg)
    return scene, frames, cfg, ref, process_frames(frames, ref, scene.cam,
                                                   xcfg)


def test_spatial_mesh_on_one_card_matches_one_batch(cuda):
    """A [cuda:0, cuda:0] spatial mesh (two row shards in turn on one card)
    equals one process_frames batch of the unfused branch; each row shard
    launches the window-sums kernel once and the two filter kernels, the
    step the scan once."""
    from vision_basedsensor_tpu_torch.ops.cuda import scan as kscan
    from vision_basedsensor_tpu_torch.parallel import (make_mesh,
                                                       make_sharded_pipeline,
                                                       shard_frames)
    scene, frames, cfg, ref, base = _spatial_inputs(cuda)
    mesh = make_mesh([cuda, cuda], spatial=2)
    step = make_sharded_pipeline(mesh, scene.cam, cfg)
    s0 = kscan.scan_launches
    out = step(shard_frames(frames, mesh), ref)
    torch.cuda.synchronize()
    assert kscan.scan_launches == s0 + 1
    assert [(c["window_sums"], c["filters"], sum(c.values()))
            for c in step.last_shard_launches] == [(1, 2, 3), (1, 2, 3)]
    assert_recon_close(out, base)
    assert int(out.tracked.valid.sum(-1).min()) == 65


def test_spatial_mesh_on_two_cards(cuda):
    """Rows 0-239 on cuda:0 and 240-479 on cuda:1: the halo rows cross
    between the cards, the results come back to cuda:0 equal to one card's
    batch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    from vision_basedsensor_tpu_torch.parallel import (make_mesh,
                                                       make_sharded_pipeline,
                                                       shard_frames)
    dev1 = torch.device("cuda", 1)
    torch.cuda.set_device(cuda)
    scene, frames, cfg, ref, base = _spatial_inputs(cuda)
    mesh = make_mesh([cuda, dev1], spatial=2)
    sharded = shard_frames(frames, mesh)
    assert [b.device for b in sharded.blocks] == [cuda, dev1]
    step = make_sharded_pipeline(mesh, scene.cam, cfg)
    out = step(sharded, ref)
    assert out.recon.world.device == cuda
    assert [c["window_sums"] for c in step.last_shard_launches] == [1, 1]
    assert_recon_close(out, base)
    halo = {(t["src"], t["dst"]) for t in step.last_transfers
            if t["name"] == "halo"}
    assert halo == {(str(cuda), str(dev1)), (str(dev1), str(cuda))}


def test_row_shard_detect_never_waits_for_the_card(cuda):
    """Once its cached filter matrices are on the card, the row shards'
    detect (every stage, the copies between shards included) makes no call
    that makes the host wait for the card."""
    from vision_basedsensor_tpu_torch.parallel import make_mesh, shard_frames
    from vision_basedsensor_tpu_torch.parallel import spatial as psp
    scene, frames, cfg, ref, _ = _spatial_inputs(cuda)
    mesh = make_mesh([cuda, cuda], spatial=2)
    blocks = [shard_frames(frames, mesh).blocks]
    plan = psp.row_plan(480, 640, 2, cfg, False)

    def detect():
        return psp.detect_row_shards(blocks, mesh.grid, 240, plan, cfg,
                                     [ref.axis_scale], [[None, None]],
                                     lambda x, d, *a: x.to(d))
    detect()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dets, launches = detect()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [c["window_sums"] for c in launches] == [1, 1]
    assert int(dets[0].valid.sum(-1).min()) >= 65
