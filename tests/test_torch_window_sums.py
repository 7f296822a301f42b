"""The detector's unfused branch of the PyTorch port vs the JAX package.

The window-sums kernel's plain version (``ops/moments.py:window_sums_xla``,
what a CPU tensor takes) against the JAX ``window_sums_xla``, the Pallas
``window_sums_pallas`` and ``window_sums_packed`` and the benchmark's fused
``gather_moments`` (interpret mode), all at the JAX tests' own tolerance
(rtol 1e-5, atol 2e-2 on valid peaks, equal finite patterns: lo/hi are
+-inf on an empty cut); ``find_peaks`` and ``extract_patches`` exactly; the
detector's dispatch table against the reference's rule; and detection on
the unfused branch against JAX ``backend="xla"``. On a card the CUDA kernel
is checked in tests/test_torch_cuda.py.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import np_, render_jax, staircase, to_jax, to_torch

from vision_basedsensor_tpu import config as jcfg
from vision_basedsensor_tpu.core.imaging import min_filter as jmin_filter
from vision_basedsensor_tpu.core.imaging import morph_open as jmorph_open
from vision_basedsensor_tpu.detect import detector as jdet
from vision_basedsensor_tpu.ops import moments as jm
from vision_basedsensor_tpu.ops.dog import dog_area_mask as jdog
from vision_basedsensor_tpu.ops.ncc import normxcorr_gaussian as jncc
from vision_basedsensor_tpu.ops.pallas import moments as jpm
from vision_basedsensor_tpu.ops.pallas.fields import HALO as JHALO
from vision_basedsensor_tpu.ops.patches import extract_patches as jextract
from vision_basedsensor_tpu.ops.peaks import Peaks as JPeaks
from vision_basedsensor_tpu.ops.peaks import find_peaks as jfind

from vision_basedsensor_tpu_torch import convert
from vision_basedsensor_tpu_torch.detect import detector as tdet
from vision_basedsensor_tpu_torch.ops import moments as tm
from vision_basedsensor_tpu_torch.ops.cuda import window_sums as tws
from vision_basedsensor_tpu_torch.ops.patches import extract_patches as textract
from vision_basedsensor_tpu_torch.ops.peaks import Peaks as TPeaks
from vision_basedsensor_tpu_torch.ops.peaks import find_peaks as tfind

ROOT = Path(__file__).resolve().parents[1]
H, W = 240, 384           # lane-aligned: the Pallas kernels accept it


@pytest.fixture(scope="module")
def fields():
    """Rendered frames -> JAX band / opened area / gray / find_peaks (the
    unfused branch's inputs), and the same as torch tensors."""
    cfg = jcfg.DetectConfig()
    prof = cfg.low_res
    frames, _ = render_jax(H, W, staircase(2, 0.5))
    gray = jnp.asarray(frames)
    area = jdog(gray, prof, cfg.dog_offset).astype(jnp.float32)
    ncc = jncc(area, prof.template_size, prof.template_sigma, binary_input=True)
    m = (ncc > cfg.ncc_threshold).astype(jnp.float32)
    band = m * (jmin_filter(m, prof.band_window) < 0.5)
    area_open = jmorph_open(area, cfg.open_ksize)
    peaks = jfind(ncc, cfg.ncc_threshold, prof.peak_window, cfg.max_candidates,
                  float(prof.peak_window))
    peaks = JPeaks(*(jnp.asarray(np.asarray(x)) for x in peaks))
    jf = dict(band=band, area=area_open, gray=gray, ncc=ncc,
              peaks=peaks, geom=jax.vmap(jm.cut_geometry)(peaks))
    tf = {k: to_torch(np.asarray(v)) for k, v in jf.items()
          if k not in ("peaks", "geom")}
    tf["peaks"] = TPeaks(*(torch.from_numpy(np.array(np.asarray(x)))
                           for x in peaks))
    tf["geom"] = tm.cut_geometry(tf["peaks"])
    tprof = convert.config_from_jax(jcfg.PipelineConfig()).detect.low_res
    return cfg, prof, tprof, jf, tf


def _close(js, ts, valid):
    """The JAX tests' own comparison (tests/test_pallas_moments.py:47-53)."""
    a, b = np.asarray(js)[valid], np_(ts)[valid]
    fin = np.isfinite(a)
    np.testing.assert_array_equal(fin, np.isfinite(b))
    np.testing.assert_allclose(b[fin], a[fin], rtol=1e-5, atol=2e-2)


def _slice(jf, tf, k):
    """The first ``k`` peaks of frame 0, for the slow interpret-mode
    kernels."""
    jp = JPeaks(*(x[:1, :k] for x in jf["peaks"]))
    tp = TPeaks(*(x[:1, :k] for x in tf["peaks"]))
    jg = jax.vmap(jm.cut_geometry)(jp)
    return jp, tp, jg, tm.cut_geometry(tp)


def test_find_peaks_matches_jax_exact(fields):
    cfg, prof, tprof, jf, tf = fields
    tp = tfind(tf["ncc"], cfg.ncc_threshold, prof.peak_window,
               cfg.max_candidates, float(prof.peak_window))
    for name in ("xy", "score", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jf["peaks"], name)),
                                      np_(getattr(tp, name)), err_msg=name)
    assert int(tp.valid.sum()) >= 2 * 60


@pytest.mark.parametrize("shape,patch", [((2, 61, 77), 40), ((70, 64), 64),
                                         ((0, 61, 77), 40)])
def test_extract_patches_matches_jax_exact(shape, patch):
    """Border centres and .5 positions (round half to even), with and
    without a frame axis, and with no frames."""
    rng = np.random.default_rng(3)
    h, w = shape[-2:]
    img = rng.random(shape).astype(np.float32)
    lead = shape[:-2]
    xy = np.stack([rng.integers(-3, w + 3, lead + (9,)),
                   rng.integers(-3, h + 3, lead + (9,))], -1).astype(np.float32)
    xy[..., :3, :] += 0.5
    jfn = jextract
    for _ in lead:
        jfn = jax.vmap(jfn, in_axes=(0, 0, None))
    jpatch, jstart = jfn(jnp.asarray(img), jnp.asarray(xy), patch)
    tpatch, tstart = textract(torch.from_numpy(img), torch.from_numpy(xy), patch)
    np.testing.assert_array_equal(np.asarray(jstart), np_(tstart))
    np.testing.assert_array_equal(np.asarray(jpatch), np_(tpatch))


def test_plain_sums_match_jax_xla(fields):
    cfg, prof, tprof, jf, tf = fields
    js = jax.vmap(lambda b, a, g, p, gm: jm.window_sums_xla(b, a, g, p, gm, prof))(
        jf["band"], jf["area"], jf["gray"], jf["peaks"], jf["geom"])
    ts = tm.window_sums_xla(tf["band"], tf["area"], tf["gray"], tf["peaks"],
                            tf["geom"], tprof)
    _close(js, ts, np_(tf["peaks"].valid))


def test_plain_sums_match_pallas_kernel(fields):
    cfg, prof, tprof, jf, tf = fields
    jp, tp, jg, tg = _slice(jf, tf, 8)
    js = jpm.window_sums_pallas(jf["band"][:1], jf["area"][:1],
                                jf["gray"][:1], jp, jg, prof, interpret=True)
    ts = tws.window_sums(tf["band"][:1], tf["area"][:1], tf["gray"][:1], tp,
                         tg, tprof)
    _close(js, ts, np_(tp.valid))


def test_packed_mode_matches_pallas_packed_kernel(fields):
    cfg, prof, tprof, jf, tf = fields
    jp, tp, jg, tg = _slice(jf, tf, 8)
    jpacked = jf["gray"] + 256.0 * jf["band"] + 512.0 * jf["area"]
    js = jpm.window_sums_packed(jpacked[:1], jp, jg, prof, interpret=True)
    ts = tws.window_sums_packed(to_torch(np.asarray(jpacked[:1])), tp, tg,
                                tprof)
    _close(js, ts, np_(tp.valid))


def test_gather_moments_matches_fused_benchmark_kernel(fields):
    """K7: the reference's fused gather + moments kernel (a benchmark module,
    loaded by path) against the port's entry of the same name."""
    spec = importlib.util.spec_from_file_location(
        "gather_moments_kernel", ROOT / "benchmarks" / "gather_moments_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg, prof, tprof, jf, tf = fields
    jp, tp, jg, tg = _slice(jf, tf, 8)
    jpacked = jf["gray"] + 256.0 * jf["band"] + 512.0 * jf["area"]
    js = mod.gather_moments(jpacked[:1], jp, jg, prof, interpret=True)
    ts = tws.gather_moments(to_torch(np.asarray(jpacked[:1])), tp, tg, tprof)
    _close(js, ts, np_(tp.valid))


def test_border_peaks_match_xla_and_pallas(fields):
    """Peaks hugging every border, sub-pixel offsets included
    (tests/test_pallas_moments.py:56-81): the clamped patch and the kernel's
    window gate the same pixels."""
    cfg, prof, tprof, jf, tf = fields
    k = 10
    edge = np.asarray([[1.2, 1.7], [W - 2.1, 1.3], [1.4, H - 1.8],
                       [W - 1.6, H - 2.2], [W / 2, 0.6], [0.4, H / 2],
                       [W - 1.0, H / 2], [W / 2, H - 1.0]], np.float32)
    xy = np.concatenate([edge, np.zeros((k - len(edge), 2), np.float32)])[None]
    valid = (np.arange(k) < len(edge))[None]
    jp = JPeaks(xy=jnp.asarray(xy), score=jnp.ones((1, k)),
                valid=jnp.asarray(valid))
    tp = TPeaks(xy=torch.from_numpy(xy), score=torch.ones((1, k)),
                valid=torch.from_numpy(valid))
    jg, tg = jax.vmap(jm.cut_geometry)(jp), tm.cut_geometry(tp)
    ts = tws.window_sums(tf["band"][:1], tf["area"][:1], tf["gray"][:1], tp,
                         tg, tprof)
    jx = jm.window_sums_xla(jf["band"][0], jf["area"][0], jf["gray"][0],
                            JPeaks(*(x[0] for x in jp)),
                            jm.CutGeometry(*(x[0] for x in jg)), prof)
    _close(jx[None], ts, valid)
    jpal = jpm.window_sums_pallas(jf["band"][:1], jf["area"][:1],
                                  jf["gray"][:1], jp, jg, prof, interpret=True)
    _close(jpal, ts, valid)


@pytest.mark.parametrize("case", ["corners", "empty_cut", "k1", "k97",
                                  "soft_floor_0"])
def test_edge_cases_match_xla_and_pallas(case, fields):
    """Cases a kernel that walks each peak's gated rows can get wrong, on
    the plain version against JAX xla and Pallas (interpret mode): peaks on
    the four corner pixels and within half a pixel of two corners (clipped
    patch origins), halfplanes that exclude every pixel (count 0, lo +inf,
    hi -inf), a lone peak (no halfplanes), an odd K of 97 and
    ``soft_floor = 0``."""
    cfg, prof, tprof, jf, tf = fields
    k = {"k1": 1, "k97": 97}.get(case, 8)
    if case == "k97":           # the rendered frame's own 97 candidates
        peaks = jfind(jf["ncc"][:1], cfg.ncc_threshold, prof.peak_window, k,
                      float(prof.peak_window))
        xy, valid = np.array(peaks.xy), np.array(peaks.valid)
    else:                       # the frame's first k peaks
        xy = np.array(jf["peaks"].xy[:1, :k])
        valid = np.ones((1, k), bool)
    if case == "corners":
        xy[0, :6] = [[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1],
                     [0.49, 0.3], [W - 1.4, H - 1.45]]
    xy = xy.astype(np.float32)
    jp = JPeaks(xy=jnp.asarray(xy), score=jnp.ones((1, k)),
                valid=jnp.asarray(valid))
    tp = TPeaks(xy=torch.from_numpy(xy), score=torch.ones((1, k)),
                valid=torch.from_numpy(valid))
    jg, tg = jax.vmap(jm.cut_geometry)(jp), tm.cut_geometry(tp)
    if case == "empty_cut":     # dx <= -1000 for the first halfplane
        jg = jm.CutGeometry(ex=jnp.ones((1, k, 3)), ey=jnp.zeros((1, k, 3)),
                            rhs=jnp.full((1, k, 3), -1000.0))
        tg = tm.CutGeometry(*(torch.from_numpy(np.array(x)) for x in jg))
    if case == "soft_floor_0":
        prof = dataclasses.replace(prof, soft_floor=0.0)
        tprof = dataclasses.replace(tprof, soft_floor=0.0)
    ts = tws.window_sums(tf["band"][:1], tf["area"][:1], tf["gray"][:1], tp,
                         tg, tprof)
    jx = jm.window_sums_xla(jf["band"][0], jf["area"][0], jf["gray"][0],
                            JPeaks(*(x[0] for x in jp)),
                            jm.CutGeometry(*(x[0] for x in jg)), prof)
    _close(jx[None], ts, valid)
    jpal = jpm.window_sums_pallas(jf["band"][:1], jf["area"][:1],
                                  jf["gray"][:1], jp, jg, prof, interpret=True)
    _close(jpal, ts, valid)
    count = np_(ts)[..., 23]
    if case == "empty_cut":
        assert not count.any()
        assert np.isposinf(np_(ts)[..., 21]).all()
        assert np.isneginf(np_(ts)[..., 22]).all()
    else:
        assert (count[valid] > 0).all()


@pytest.mark.parametrize("b,k", [(0, 96), (2, 0)])
def test_empty_batches_match_jax(b, k):
    """No frames or no peaks: empty sums, as JAX's vmapped window_sums_xla
    gives them (the port's patch extraction raised on B = 0)."""
    prof = jcfg.DetectConfig().low_res
    tprof = convert.config_from_jax(jcfg.PipelineConfig()).detect.low_res
    z = np.zeros((b, 120, 160), np.float32)
    xy, valid = np.zeros((b, k, 2), np.float32), np.zeros((b, k), bool)
    jp = JPeaks(xy=jnp.asarray(xy), score=jnp.zeros((b, k)),
                valid=jnp.asarray(valid))
    jz = jnp.asarray(z)
    js = jax.vmap(lambda a, c, g, p, gm: jm.window_sums_xla(a, c, g, p, gm,
                                                            prof))(
        jz, jz, jz, jp, jax.vmap(jm.cut_geometry)(jp))
    tp = TPeaks(xy=torch.from_numpy(xy), score=torch.zeros((b, k)),
                valid=torch.from_numpy(valid))
    tz = torch.from_numpy(z)
    ts = tws.window_sums(tz, tz, tz, tp, tm.cut_geometry(tp), tprof)
    assert tuple(ts.shape) == tuple(js.shape) == (b, k, tm.NUM_SUMS)


def test_cpu_tensors_take_the_plain_version(fields):
    cfg, prof, tprof, jf, tf = fields
    before = (tws.fields_launches, tws.packed_launches)
    a = tws.window_sums(tf["band"], tf["area"], tf["gray"], tf["peaks"],
                        tf["geom"], tprof)
    packed = tf["gray"] + 256.0 * tf["band"] + 512.0 * tf["area"]
    b = tws.window_sums_packed(packed, tf["peaks"], tf["geom"], tprof)
    assert (tws.fields_launches, tws.packed_launches) == before
    assert torch.equal(a, tm.window_sums_xla(tf["band"], tf["area"], tf["gray"],
                                             tf["peaks"], tf["geom"], tprof))
    assert torch.equal(a, b)       # the unpack is exact


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
def test_dispatch_table_matches_reference(backend, monkeypatch):
    """The branch each (backend, frame shape, profile) takes, against the
    reference's ``_resolve_backend`` + ``fits_fused`` evaluated without
    frames. The port's "auto" is the reference's TPU choice ("pallas")."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    wide = dataclasses.replace(jcfg.HIGH_RES_PROFILE, band_window=20)
    shapes = [(480, 640), (437, 467), (44, 256), (480, 200), (960, 1280),
              (968, 1280), (1080, 1920), (961, 1280), (1080, 1900)]
    seen = set()
    for prof in (jcfg.DetectProfile(), jcfg.HIGH_RES_PROFILE, wide):
        for open_k in (5, 19):
            jc = jcfg.DetectConfig(backend=backend, open_ksize=open_k,
                                   high_res=prof)
            tc = convert.config_from_jax(jcfg.PipelineConfig(detect=jc)).detect
            tprof = tc.high_res
            for h, w in shapes:
                jb = jdet._resolve_backend(jc, _Shape(h, w), prof)
                jfused = jb == "pallas" and (
                    h * w <= 960 * 1280
                    or (prof.band_window // 2 <= JHALO
                        and prof.peak_window // 2 <= JHALO
                        and 2 * (open_k // 2) <= JHALO))
                assert tdet.resolve_backend(tc, h, w, tprof) == jb, (h, w, prof)
                assert tdet.takes_fused_branch(tc, h, w, tprof) == jfused, \
                    (h, w, prof, open_k)
                seen.add(jfused)
    assert seen == ({False} if backend == "xla" else {True, False})


class _Shape:
    """Stands in for a frame: the reference's rule reads only its shape."""

    def __init__(self, h, w):
        self.shape = (h, w)


def test_detect_unfused_branch_matches_jax_xla():
    """Detection on the unfused branch at 240x320 (unaligned width, so every
    backend takes it) against JAX ``backend="xla"``; the NCC field differs
    in the last float32 bits, so detections compare as sets."""
    frames, _ = render_jax(240, 320, staircase(2, 0.4))
    jc = jcfg.DetectConfig(backend="xla")
    tc = convert.config_from_jax(jcfg.PipelineConfig(detect=jc)).detect
    assert not tdet.takes_fused_branch(tc, 240, 320, tc.low_res)
    jd = jdet.detect_markers(to_jax(frames), jc)
    td = tdet.detect_markers(to_torch(frames), tc)
    for b in range(2):
        jv, tv = np.asarray(jd.valid[b]), np_(td.valid[b])
        assert jv.sum() == tv.sum() >= 55
        jxy, txy = np.asarray(jd.xy[b])[jv], np_(td.xy[b])[tv]
        d = np.linalg.norm(jxy[:, None] - txy[None], axis=-1)
        nearest = d.argmin(1)
        assert len(set(nearest.tolist())) == len(nearest)
        assert d.min(1).max() <= 1e-3
        np.testing.assert_allclose(np.asarray(jd.axes[b])[jv],
                                   np_(td.axes[b])[tv][nearest], atol=1e-2)
