"""The port's two scans over frames against the JAX package, on the CPU.

``displacement_scan`` (the last-sighting recurrence) and
``associate_sequential`` (last-sighting association) run one
``lax.scan`` each in JAX; the port runs one CUDA kernel each on the card
and a Python loop (``*_reference``) on the CPU. The same numpy inputs go
through both packages. Tolerances: booleans and picks equal, positions and
steps atol 1e-6, ``cum_path`` atol 1e-5 (sums over up to 40 frames). The
port computes a norm as ``sqrt((x*x + y*y) + z*z)`` with every operation
rounded (the kernel's order) and JAX's reduction may fuse a multiply-add,
so norms may differ in their last bit: norms also get rtol 2.4e-7 (2 ulp),
which matters only for the 60 mm misreads (1 ulp = 3.8e-6 there).
Cases that ``tests/test_torch_stream.py`` already covers on rendered
frames (a lateral drift, sessions across packages) are not repeated here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import np_, to_jax, to_torch

from vision_basedsensor_tpu.config import ReconstructConfig as JReconstructConfig
from vision_basedsensor_tpu.detect.detector import Detections as JDetections
from vision_basedsensor_tpu.reconstruct.displacement import \
    displacement_scan as jdisplacement_scan
from vision_basedsensor_tpu.track.associate import \
    associate_sequential as jassociate_sequential
from vision_basedsensor_tpu.track.rings import ReferenceMarkers as JReference

from vision_basedsensor_tpu_torch.config import ReconstructConfig
from vision_basedsensor_tpu_torch.detect.detector import Detections
from vision_basedsensor_tpu_torch.ops.cuda import scan as kscan
from vision_basedsensor_tpu_torch.reconstruct.displacement import (
    displacement_scan, displacement_scan_reference)
from vision_basedsensor_tpu_torch.track.associate import (
    associate_sequential, associate_sequential_reference)
from vision_basedsensor_tpu_torch.track.rings import ReferenceMarkers

N = 65
GATE = 20.0
CARRY_KEYS = ("last", "last_ok", "first", "first_ok", "cum")


# -- displacement scan --------------------------------------------------------

def _start(rng):
    """Marker positions on a dome-like patch, mm: x, y within 15, z ~ 20."""
    return np.concatenate([rng.uniform(-15.0, 15.0, (N, 2)),
                           rng.uniform(18.0, 22.0, (N, 1))], -1)


def _world(rng, b, p_seen, p_misread):
    """``b`` frames of N markers walking 0.3 mm a step, a random occlusion
    pattern, and misreads: with probability ``p_misread`` a sighting lies
    60 mm off, a step over the 50 mm step gate (and back)."""
    walk = np.cumsum(rng.normal(0.0, 0.3, (b, N, 3)), axis=0)
    misread = (rng.random((b, N)) < p_misread)[..., None] * np.array(
        [0.0, 60.0, 0.0])
    seen = rng.random((b, N)) < p_seen
    world = np.where(seen[..., None], _start(rng) + walk + misread, 0.0)
    return world.astype(np.float32), seen


def _carry(rng):
    return dict(last=_start(rng).astype(np.float32),
                last_ok=rng.random(N) < 0.7,
                first=_start(rng).astype(np.float32),
                first_ok=rng.random(N) < 0.7,
                cum=(rng.random(N) * 20.0).astype(np.float32))


def _jax_scan(world, seen, carry):
    jc = None if carry is None else {
        k: jnp.asarray(v) if v.dtype == bool else to_jax(v)
        for k, v in carry.items()}
    return jdisplacement_scan(to_jax(world), jnp.asarray(seen),
                              JReconstructConfig(), carry=jc,
                              return_carry=True)


def _port_scan(world, seen, carry, fn=displacement_scan):
    tc = None if carry is None else {k: torch.from_numpy(v.copy())
                                     for k, v in carry.items()}
    return fn(to_torch(world), torch.from_numpy(seen.copy()),
              ReconstructConfig(), carry=tc, return_carry=True)


def _assert_recon(got, want):
    for name in ("step_valid", "seen"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np_(getattr(want, name)), name)
    for name in ("world", "step", "from_first"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np_(getattr(want, name)), atol=1e-6,
                                   err_msg=name)
    for name in ("step_norm", "from_first_norm"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np_(getattr(want, name)), atol=1e-6,
                                   rtol=2.4e-7, err_msg=name)
    np.testing.assert_allclose(np_(got.cum_path), np_(want.cum_path),
                               atol=1e-5)
    for name in ("step", "step_norm", "step_valid", "cum_path", "from_first",
                 "from_first_norm"):
        assert getattr(got, name).shape == tuple(
            np.shape(getattr(want, name))), name


def _assert_carry(got, want):
    for key in ("last_ok", "first_ok"):
        np.testing.assert_array_equal(np_(got[key]), np_(want[key]), key)
    for key in ("last", "first"):
        np.testing.assert_allclose(np_(got[key]), np_(want[key]), atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(np_(got["cum"]), np_(want["cum"]), atol=1e-5)


@pytest.mark.parametrize("b,p_seen,p_misread,with_carry", [
    (40, 0.6, 0.0, False),     # random occlusion
    (40, 0.9, 0.1, False),     # steps over max_step_displacement_mm (50)
    (30, 0.5, 0.05, True),     # resumed from a carry
    (1, 0.5, 0.0, True),
    (0, 0.5, 0.0, False),      # no frames: empty outputs, fresh carry
    (0, 0.5, 0.0, True),       # no frames: the carry comes back unchanged
])
def test_displacement_scan_matches_jax(b, p_seen, p_misread, with_carry):
    rng = np.random.default_rng(11 + b)
    world, seen = _world(rng, b, p_seen, p_misread)
    carry = _carry(rng) if with_carry else None
    jrec, jfinal = _jax_scan(world, seen, carry)
    before = kscan.scan_launches
    trec, tfinal = _port_scan(world, seen, carry)
    assert kscan.scan_launches == before      # CPU tensors launch nothing
    _assert_recon(trec, jrec)
    _assert_carry(tfinal, jfinal)
    if p_misread:          # the gate really dropped steps
        valid_prev = np.asarray(jrec.seen)[1:] & np.asarray(jrec.seen)[:-1]
        assert (valid_prev & ~np.asarray(jrec.step_valid)[1:]).any()
    if b == 0 and carry is not None:
        for key in CARRY_KEYS:
            np.testing.assert_array_equal(np_(tfinal[key]), carry[key])


def test_displacement_scan_chunks_equal_one_batch():
    """Two chunks with the carried state equal one batch bit for bit, and
    agree with JAX's chunks; the given carry is not changed."""
    rng = np.random.default_rng(5)
    world, seen = _world(rng, 37, 0.7, 0.05)
    whole, wfinal = _port_scan(world, seen, None)
    first, carry = _port_scan(world[:15], seen[:15], None)
    kept = {k: v.clone() for k, v in carry.items()}
    second, final = displacement_scan(
        to_torch(world[15:]), torch.from_numpy(seen[15:].copy()),
        ReconstructConfig(), carry=carry, return_carry=True)
    for k in CARRY_KEYS:
        assert torch.equal(carry[k], kept[k]), k
        assert torch.equal(final[k], wfinal[k]), k
    for name in whole._fields:
        assert torch.equal(torch.cat([getattr(first, name),
                                      getattr(second, name)]),
                           getattr(whole, name)), name
    _, jcarry = _jax_scan(world[:15], seen[:15], None)
    jsecond, _ = jdisplacement_scan(to_jax(world[15:]),
                                    jnp.asarray(seen[15:]),
                                    JReconstructConfig(), carry=jcarry,
                                    return_carry=True)
    _assert_recon(second, jsecond)


def test_displacement_scan_dispatches_to_the_plain_version_on_cpu():
    rng = np.random.default_rng(8)
    world, seen = _world(rng, 9, 0.7, 0.05)
    got, gfinal = _port_scan(world, seen, None)
    want, wfinal = _port_scan(world, seen, None, displacement_scan_reference)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for k in CARRY_KEYS:
        assert torch.equal(gfinal[k], wfinal[k]), k


# -- sequential association ---------------------------------------------------

def _reference(rng):
    """A 65-slot frame-0 table on a jittered 30 px grid; slot 7 empty."""
    g = np.stack(np.meshgrid(np.arange(9), np.arange(8)), -1).reshape(-1, 2)
    xy = (g[:N] * 30.0 + 40.0 + rng.normal(0.0, 1.0, (N, 2))).astype(
        np.float32)
    valid = np.ones(N, bool)
    valid[7] = False
    return xy, valid


def _detections(rng, ref_xy, b, k, p_valid, drift=(0.0, 0.0)):
    """Each frame: the N markers moved by ``drift`` per frame plus jitter,
    shuffled among ``k`` slots with clutter; ``p_valid`` of them valid.
    Also returns ``slot (b, N)``: where each marker landed."""
    xy = np.empty((b, k, 2), np.float32)
    slot = np.empty((b, N), np.int64)
    for t in range(b):
        pts = np.concatenate([
            ref_xy + np.asarray(drift) * (t + 1) + rng.normal(0, 1.5, (N, 2)),
            rng.random((k - N, 2)) * 300.0])
        perm = rng.permutation(k)
        xy[t] = pts[perm]
        slot[t] = np.argsort(perm)[:N]
    axes = (rng.random((b, k, 2)) * 10.0 + 5.0).astype(np.float32)
    angle = (rng.random((b, k)) * 180.0).astype(np.float32)
    valid = rng.random((b, k)) < p_valid
    return (xy, axes, angle, valid), slot


def _pair(ref_xy, ref_valid, det):
    xy, axes, angle, valid = det
    b, k = valid.shape
    jref = JReference(xy=to_jax(ref_xy), axes=jnp.zeros((N, 2), jnp.float32),
                      angle=jnp.zeros(N, jnp.float32),
                      ring=jnp.zeros(N, jnp.int32),
                      valid=jnp.asarray(ref_valid))
    tref = ReferenceMarkers(xy=to_torch(ref_xy), axes=torch.zeros((N, 2)),
                            angle=torch.zeros(N),
                            ring=torch.zeros(N, dtype=torch.int32),
                            valid=torch.from_numpy(ref_valid.copy()))
    score = np.ones((b, k), np.float32)
    jdet = JDetections(to_jax(xy), to_jax(axes), to_jax(angle), to_jax(score),
                       jnp.asarray(valid))
    tdet = Detections(to_torch(xy), to_torch(axes), to_torch(angle),
                      to_torch(score), torch.from_numpy(valid.copy()))
    return jref, tref, jdet, tdet


def _assert_tracked(got, want):
    np.testing.assert_array_equal(np_(got.valid), np_(want.valid))
    for name in ("xy", "axes", "angle"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np_(getattr(want, name)), atol=1e-6,
                                   err_msg=name)
        assert getattr(got, name).shape == tuple(
            np.shape(getattr(want, name))), name


def _latch_case(rng, ref_xy):
    """Marker 10 is hidden in frames 2-9 while its neighbour 11 (30 px to
    its right) drifts left into 10's 20 px gate, then 10 reappears. The
    clutter is invalid, so only 11 can claim slot 10."""
    b, k = 14, 80
    (xy, axes, angle, valid), slot = _detections(rng, ref_xy, b, k, 1.0)
    valid[:] = False
    for t in range(b):
        valid[t, slot[t]] = True
        xy[t, slot[t, 10]] = ref_xy[10]
        xy[t, slot[t, 11]] = ref_xy[11] - [min(3.0 * t, 18.0), 0.0]
        if 2 <= t <= 9:
            valid[t, slot[t, 10]] = False
    return xy, axes, angle, valid


ASSOC_CASES = ("occlusion", "drift", "latch", "empty_frame", "carry",
               "zero_frames", "zero_frames_carry")


@pytest.mark.parametrize("case", ASSOC_CASES)
def test_associate_sequential_matches_jax(case):
    rng = np.random.default_rng(30 + ASSOC_CASES.index(case))
    ref_xy, ref_valid = _reference(rng)
    carry = None
    if case == "occlusion":
        det, _ = _detections(rng, ref_xy, 24, 96, 0.7)
    elif case == "drift":      # ~6 px a frame: steps only the carry follows
        det, _ = _detections(rng, ref_xy, 12, 97, 0.9, drift=(6.0, -2.0))
    elif case == "latch":
        det = _latch_case(rng, ref_xy)
    elif case == "empty_frame":
        det, _ = _detections(rng, ref_xy, 8, 96, 0.9)
        det[3][4] = False      # no valid detection in frame 4
    elif case == "carry":
        det, _ = _detections(rng, ref_xy, 10, 96, 0.8, drift=(4.0, 0.0))
        carry = (ref_xy + rng.normal(0.0, 3.0, (N, 2))).astype(np.float32)
    else:
        det, _ = _detections(rng, ref_xy, 0, 96, 0.8)
        if case == "zero_frames_carry":
            carry = (ref_xy + 5.0).astype(np.float32)
    jref, tref, jdet, tdet = _pair(ref_xy, ref_valid, det)
    jt, jlast = jassociate_sequential(
        jref, jdet, GATE, carry_xy=None if carry is None else to_jax(carry),
        return_carry=True)
    before = kscan.assoc_launches
    tt, tlast = associate_sequential(
        tref, tdet, GATE, carry_xy=None if carry is None else to_torch(carry),
        return_carry=True)
    assert kscan.assoc_launches == before     # CPU tensors launch nothing
    _assert_tracked(tt, jt)
    np.testing.assert_allclose(np_(tlast), np_(jlast), atol=1e-6)
    valid = np_(tt.valid)
    assert not valid[:, 7].any()              # the empty reference slot
    if case == "latch":
        # Slot 10 keeps its stale carry while hidden and re-associates; slot
        # 11 keeps its own detection.
        assert not valid[2:10, 10].any() and valid[10:, 10].all()
        assert valid[:, 11].all()
        np.testing.assert_allclose(np_(tt.xy)[10:, 10],
                                   np.repeat(ref_xy[10:11], 4, 0), atol=1e-6)
    if case == "empty_frame":
        assert not valid[4].any() and valid[5].sum() >= 50
    if case.startswith("zero_frames"):
        assert tt.xy.shape == (0, N, 2) and tt.valid.dtype == torch.bool
        want = ref_xy if carry is None else carry
        np.testing.assert_array_equal(np_(tlast), want)


def test_associate_sequential_chunks_equal_one_batch():
    """Chunks with the carried positions equal one batch bit for bit and
    the plain version; the given carry is not changed."""
    rng = np.random.default_rng(21)
    ref_xy, ref_valid = _reference(rng)
    det, _ = _detections(rng, ref_xy, 20, 96, 0.8, drift=(5.0, 1.0))
    _, tref, _, tdet = _pair(ref_xy, ref_valid, det)
    whole, wlast = associate_sequential(tref, tdet, GATE, return_carry=True)
    plain = associate_sequential_reference(tref, tdet, GATE)
    carry, parts = None, []
    bounds = (0, 7, 13, 20)
    for i, j in zip(bounds, bounds[1:]):
        chunk = Detections(*(x[i:j] for x in tdet[:5]))
        kept = None if carry is None else carry.clone()
        part, carry_new = associate_sequential(tref, chunk, GATE,
                                               carry_xy=carry,
                                               return_carry=True)
        if kept is not None:
            assert torch.equal(carry, kept)
        parts.append(part)
        carry = carry_new
    assert torch.equal(carry, wlast)
    for name in ("xy", "axes", "angle", "valid"):
        cat = torch.cat([getattr(p, name) for p in parts])
        assert torch.equal(cat, getattr(whole, name)), name
        assert torch.equal(getattr(plain, name), getattr(whole, name)), name
