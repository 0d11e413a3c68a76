"""The batch (throughput) frontend of the port against the JAX package,
and against the port's own single-frame path.

Sizes as tests/test_batch.py: 96x160 random frames, noctaves=2,
thresh=1.0, max_pts=256, candidates_per_octave=512.  The JAX batch runs
with detect_backend="xla" and wavelet_method "gather" or "interpret"; the
latter runs the real frame-stacked Pallas kernel (`_kernel_tiles`) under
the interpreter.

Tolerances: counts, validity, octave and Laplacian sign equal; x / y /
scale / strength at 1e-5 relative (the slice test's: XLA:CPU contracts
FMAs in the subpixel fit, the port does not); padding slots zero;
descriptors at atol 2e-6 + 2e-6: tests/test_batch.py's 2e-6 between two
JAX programs, plus as much again for the FMAs that XLA:CPU contracts in
the sample geometry and the port never does (ROADMAP Queue 3).  A
ring-edge keypoint (`torch_parity.ring_edge_keypoints`: a live sample whose
squared radius lies within 4 float32 ulps of an integer, where one such
rounding moves the whole sample to the next Gaussian ring, a ~12 % step of
its weight) is held at row cosine >= 0.9999 instead; there is one among
the 199 keypoints of these frames, off by 4.0e-4.  The port's batch equals its own single-frame path exactly: the same eager ops
on the same values, only gathered from other rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_surf_tpu as jst
from cuda_surf_tpu.frontend import (detect_and_compute_batch as
                                    jax_detect_and_compute_batch)
from cuda_surf_tpu.ops import extrema as jex
from cuda_surf_tpu.ops.hessian import response_pyramid as jax_pyramid
from cuda_surf_tpu.ops.integral import integral_image as jax_integral

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.ops import extrema as tex
from cuda_surf_tpu_torch.ops.descriptor import desc_geometry, describe_plain
from cuda_surf_tpu_torch.ops.fused_detect import fused_pyramid
from cuda_surf_tpu_torch.ops.integral import integral_image
from cuda_surf_tpu_torch.ops.patch_wavelets import descriptor_rows
from cuda_surf_tpu_torch.types import Keypoints, compact
from torch_parity import (assert_keypoints_match, ring_edge_keypoints,
                          row_cosines)

KW = dict(noctaves=2, thresh=1.0, upright=True, max_pts=256,
          candidates_per_octave=512)


def _frames(n, h=96, w=160, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([(rng.random((h, w)) * 255).astype(np.uint8)
                     for _ in range(n)])


def _frame_of(kb, i):
    """Frame i of a batched keypoint set of either package, as numpy."""
    return Keypoints(*[np.asarray(getattr(kb, f))[i]
                       for f in Keypoints._fields])


@pytest.fixture(scope="module")
def torch_batch():
    frames = _frames(3)
    surf = cst.Surf(cst.SurfConfig(**KW), device="cpu")
    return frames, surf, surf.detect_and_compute_batch(frames)


def test_detect_union_equals_jax_field_by_field():
    """`detect(..., nframes=B)` on stacked pyramids: the same candidates,
    in the same frame-major order, as the JAX function."""
    frames = _frames(3)
    B, h, w = frames.shape
    cj = jst.SurfConfig(**KW, detect_backend="xla", detect_fit="sparse")
    ct = cst.config_from_jax(cj)
    pj = [jax_pyramid(jax_integral(jnp.asarray(f)), cj, h, w) for f in frames]
    pj = [jnp.stack([p[o] for p in pj]) for o in range(cj.noctaves)]
    dj = jex.detect(pj, cj.hessian_schedule(h, w), cj, nframes=B)
    per = [fused_pyramid(integral_image(torch.as_tensor(f)), ct, h, w)
           for f in frames]
    pt, mt = ([torch.stack([fr[part][o] for fr in per])
               for o in range(ct.noctaves)] for part in (0, 1))
    dt = tex.detect(pt, ct.hessian_schedule(h, w), ct, cand_masks=mt,
                    nframes=B)
    assert int(dj["count"]) == int(dt["count"]) > 100
    v = np.asarray(dj["valid"])
    np.testing.assert_array_equal(v, dt["valid"].numpy())
    assert dt["valid"].shape == (B * ct.max_candidates,)
    for name in ("octave", "frame"):
        np.testing.assert_array_equal(np.asarray(dj[name])[v],
                                      dt[name].numpy()[v], err_msg=name)
    assert set(dt["frame"].numpy()[v]) == {0, 1, 2}
    for name in ("nx", "ny", "ns", "strength"):
        np.testing.assert_allclose(dt[name].numpy()[v], np.asarray(dj[name])[v],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_detect_one_frame_is_unchanged_by_the_frame_axis():
    """nframes=1: a leading axis of 1 gives exactly the plain call."""
    f = _frames(1)[0]
    cfg = cst.SurfConfig(**KW)
    h, w = f.shape
    pyr, masks = fused_pyramid(integral_image(torch.as_tensor(f)), cfg, h, w)
    a = tex.detect(pyr, cfg.hessian_schedule(h, w), cfg, cand_masks=masks)
    b = tex.detect([p[None] for p in pyr], cfg.hessian_schedule(h, w), cfg,
                   cand_masks=[m[None] for m in masks], nframes=1)
    assert a.keys() == b.keys() and int(a["valid"].sum()) > 30
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not a["frame"].any()


@pytest.mark.parametrize("wavelet_method,B", [("gather", 3), ("interpret", 2)])
def test_batch_equals_jax_batch(wavelet_method, B):
    frames = _frames(B)
    cj = jst.SurfConfig(**KW, detect_backend="xla",
                        wavelet_method=wavelet_method)
    kj, dj = jax.jit(lambda im: jax_detect_and_compute_batch(im, cj))(
        jnp.asarray(frames))
    surf = cst.Surf(cst.config_from_jax(cj), device="cpu")
    kt, dt = surf.detect_and_compute_batch(frames)
    n_edge = 0
    assert dt.shape == (B, 256, 64) and kt.count.shape == (B,)
    np.testing.assert_array_equal(np.asarray(kj.count), kt.count.numpy())
    for i in range(B):
        n = assert_keypoints_match(_frame_of(kj, i), _frame_of(kt, i))
        assert n > 30
        for fld in ("x", "y", "scale", "strength", "laplace", "octave", "ori"):
            assert not getattr(kt, fld)[i, n:].any(), fld      # zero padding
        edge = ring_edge_keypoints(
            surf.cfg, (frames.shape[1] + 1, frames.shape[2] + 1), kt.x[i],
            kt.y[i], kt.scale[i], kt.ori[i], kt.valid[i])
        n_edge += int(edge.sum())
        a, b = dt[i].numpy(), np.asarray(dj[i])
        np.testing.assert_allclose(a[~edge], b[~edge], atol=4e-6)
        assert row_cosines(a[edge], b[edge]).min(initial=1) >= 0.9999
        assert not dt[i, n:].any()
    assert n_edge <= 1          # the rule exempts few


def test_batch_equals_own_single_frame_path(torch_batch):
    frames, surf, (kb, db) = torch_batch
    for i, f in enumerate(frames):
        k1, d1 = surf.detect_and_compute(f)
        n = int(k1.count)
        assert n == int(kb.count[i]) > 30
        assert torch.equal(k1.valid, kb.valid[i])
        for fld in ("x", "y", "scale", "strength", "laplace", "octave"):
            assert torch.equal(getattr(k1, fld)[:n], getattr(kb, fld)[i, :n])
            assert not getattr(kb, fld)[i, n:].any(), fld
        assert torch.equal(d1, db[i])


def test_batch_of_one_frame(torch_batch):
    frames, surf, (kb, db) = torch_batch
    k1, d1 = surf.detect_and_compute_batch(frames[1:2])
    assert d1.shape == (1, 256, 64)
    assert torch.equal(d1[0], db[1]) and torch.equal(k1.x[0], kb.x[1])


def test_batch_without_descriptors(torch_batch):
    frames, surf, (kb, _) = torch_batch
    k, d = cst.detect_and_compute_batch(torch.as_tensor(frames), surf.cfg,
                                        compute_descriptors=False)
    assert d.shape == (3, 256, 64) and not d.any()
    assert torch.equal(k.x, kb.x) and torch.equal(k.count, kb.count)


def test_batch_doubled_equals_single_frame():
    frames = _frames(2)
    surf = cst.Surf(cst.SurfConfig(**KW, doubled=True), device="cpu")
    kb, db = surf.detect_and_compute_batch(frames)
    for i, f in enumerate(frames):
        k1, d1 = surf.detect_and_compute(f)
        n = int(k1.count)
        assert n == int(kb.count[i]) > 30
        assert torch.equal(k1.x[:n], kb.x[i, :n])
        assert torch.equal(d1, db[i])


def test_batch_rotated_maps_the_single_frame_path():
    frames = _frames(2)
    cj = jst.SurfConfig(**dict(KW, upright=False, max_pts=128),
                        detect_backend="xla", wavelet_method="gather")
    surf = cst.Surf(cst.config_from_jax(cj), device="cpu")
    kb, db = surf.detect_and_compute_batch(frames)
    assert db.shape == (2, 128, 64) and kb.count.shape == (2,)
    k1, d1 = surf.detect_and_compute(frames[1])
    assert torch.equal(d1, db[1]) and torch.equal(k1.ori, kb.ori[1])
    kj, _ = jax.jit(lambda im: jax_detect_and_compute_batch(im, cj))(
        jnp.asarray(frames))
    np.testing.assert_array_equal(np.asarray(kj.count), kb.count.numpy())
    assert kb.ori[1][kb.valid[1]].abs().max() > 1.0


def test_batchsurf_maps_frames_and_pairs():
    frames = _frames(3)
    cfg = cst.SurfConfig(**KW)
    bs = cst.BatchSurf(cfg, device="cpu")
    surf = cst.Surf(cfg, device="cpu")
    kb, db = bs.detect_and_compute(frames)
    assert kb.x.shape == (3, 256) and db.shape == (3, 256, 64)
    singles = [surf.detect_and_compute(f) for f in frames]
    for i, (k1, d1) in enumerate(singles):
        for a, b in zip(k1, _frame_of_t(kb, i)):
            assert torch.equal(a, b)
        assert torch.equal(d1, db[i])
    sub = lambda k, sl: Keypoints(*[f[sl] for f in k])
    mb = bs.match(sub(kb, slice(0, 2)), db[:2], sub(kb, slice(1, 3)), db[1:])
    assert mb.score.shape == (2, 256)
    for i in range(2):
        m1 = surf.match(*singles[i], *singles[i + 1])
        for a, b in zip(m1, mb):
            assert torch.equal(a, b[i])


def _frame_of_t(kb, i):
    return Keypoints(*[f[i] for f in kb])


def test_batchsurf_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cst.BatchSurf(cst.SurfConfig(), device="cuda")


@pytest.mark.parametrize("upright", [True, False], ids=["upright", "rotated"])
def test_frame_offset_twin_masks_frame_locally(upright):
    """Keypoints at the top and bottom edge of the middle frame of a stack:
    their windows would reach into the neighbouring frames' rows.  Every
    row must equal the row the same keypoint gets on its frame alone, and
    the rows must differ from an unmasked read across the seam."""
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (3, 120, 160), np.uint8)
    ii = torch.stack([integral_image(torch.as_tensor(f)) for f in imgs])
    ih = ii.shape[1]
    ys = [0.4, 3.2, 9.0, 60.5, 111.3, 117.6, 119.9]
    xs = [5.5, 80.2, 155.1]
    y, x = (a.ravel().astype(np.float32)
            for a in np.meshgrid(ys, xs, indexing="ij"))
    scale = np.resize(np.float32([2.0, 3.5, 6.0, 9.0]), y.shape)
    cfg = cst.SurfConfig(noctaves=4, upright=upright, max_pts=y.size)
    ori = torch.as_tensor(rng.uniform(-3, 3, y.shape).astype(np.float32))
    K = y.size
    t = torch.as_tensor
    geom = desc_geometry(cfg, t(x).repeat(3), t(y).repeat(3),
                         t(scale).repeat(3), ori.repeat(3))
    frame = torch.arange(3, dtype=torch.int32).repeat_interleave(K)
    valid = torch.ones(3 * K, dtype=torch.bool)
    valid[5] = False
    stacked = descriptor_rows(ii, cfg, *geom, valid, frame=frame)
    assert stacked.shape == (3 * K, 64) and not stacked[5].any()
    for f in range(3):
        sl = slice(f * K, (f + 1) * K)
        own = describe_plain(ii[f], cfg, *[g if g is None else g[sl]
                                           for g in geom], valid[sl])
        assert torch.equal(stacked[sl], own), f
    assert (stacked.abs().sum(1) > 0).sum() > 2 * K
    # a frame index outside the stack is masked, never read
    bad = frame.clone()
    bad[:K] = -1
    bad[K:2 * K] = 7
    rows = descriptor_rows(ii, cfg, *geom, valid, frame=bad)
    assert not rows[:2 * K].any() and torch.equal(rows[2 * K:], stacked[2 * K:])
    # the seam is real: reading the stack as one tall image changes the
    # rows of the keypoints whose windows cross it
    tall = describe_plain(ii.reshape(-1, ii.shape[2]), cfg,
                          geom[0], geom[1] + frame * ih, *geom[2:], valid)
    assert (tall[K:2 * K] != stacked[K:2 * K]).any(1).sum() >= 6


@pytest.mark.parametrize("n,B,cap", [(4000, 4, 64), (100000, 8, 4096)])
def test_compact_at_union_capacity(n, B, cap):
    """One compaction at B * cap slots over a B-frame union with a payload
    that identifies the source row: stable, valid-first, zero-filled."""
    rng = np.random.default_rng(n)
    mask = rng.random(B * n) < 0.3
    payload = np.arange(B * n, dtype=np.int32)
    count, valid, got = compact(torch.as_tensor(mask), B * cap,
                                torch.as_tensor(payload))
    want = payload[mask][:B * cap]
    assert int(count) == want.size == int(valid.sum())
    np.testing.assert_array_equal(got.numpy()[:want.size], want)
    assert not got.numpy()[want.size:].any()
