"""The visual-odometry slice as a whole: the port's `SlamPipeline` on the
CPU against the JAX package's over tests/test_slam_sequence.py's plane
sequence (`render_plane_sequence(n_frames=6, h=200, w=280, seed=3)`, its
config), with the JAX pipeline's key stream handed to the port: frame by
frame the `raw` that `jax.random.split` + `randint` give the JAX
pipeline's RANSAC (pipeline.py:138, epipolar.py:217).

Tolerances: each frame's world rotation within 0.1 degree of the JAX
pipeline's and its inlier count within 2 %, the monocular scale chain's
per-frame depths within 5 %; the JAX test's own bars on the
port (ATE < 0.08, inliers > 40 on every frame); windowed BA (window 4) with
an ATE below the plain run's x 1.15, and the two-view BA polish with an
ATE below 0.08, as tests/test_slam_sequence.py asks of the JAX pipeline.
The copied renderers, ATE and metrics logger equal the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_surf_tpu as jst
from cuda_surf_tpu.slam import SlamPipeline as JaxPipeline
from cuda_surf_tpu.slam import evaluate as jeval
from cuda_surf_tpu.slam import run_sequence as jax_run_sequence
from cuda_surf_tpu.slam import sequence as jseq
from cuda_surf_tpu.utils.metrics import MetricsLogger as JaxMetrics

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.config import VO_CONFIG
from cuda_surf_tpu_torch.io import synth
from cuda_surf_tpu_torch.slam import (SlamPipeline, evaluate, run_sequence)
from cuda_surf_tpu_torch.slam.loopclosure import (LoopDetector,
                                                  optimize_with_loops)
from cuda_surf_tpu_torch.slam.mapping import KeyframeMap
from cuda_surf_tpu_torch.types import keypoints_from_numpy
from cuda_surf_tpu_torch.utils.metrics import MetricsLogger

PLANE = dict(n_frames=6, h=200, w=280, seed=3)


@pytest.fixture(scope="module")
def plane_seq():
    return synth.render_plane_sequence(**PLANE)


def key_stream(seed, n_frames):
    """The `raw` of each frame after the first, as the JAX pipeline draws
    it from PRNGKey(seed)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_frames - 1):
        key, sub = jax.random.split(key)
        out.append(torch.as_tensor(np.array(jax.random.randint(
            sub, (128, 5), 0, jnp.iinfo(jnp.int32).max))))
    return out


def _pipe(**kw):
    return SlamPipeline(cst.SurfConfig(**VO_CONFIG), device="cpu", **kw)


def _port_run(frames, centres, intr, raws=None, **kw):
    pipe = _pipe(intrinsics=intr, **kw)
    for f, raw in zip(frames, [None] + (raws or [None] * len(frames))):
        pipe.process(f, raw=raw)
    inl = np.asarray([s.n_inliers for s in pipe.frames])
    return pipe, evaluate.ate_rmse(pipe.trajectory(), centres), inl


def _angle_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra) @ np.asarray(Rb).T) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def test_pipeline_matches_jax_key_stream(plane_seq):
    frames, centres, intr = plane_seq
    jpipe = JaxPipeline(jst.SurfConfig(**VO_CONFIG, wavelet_method="gather",
                                       detect_backend="xla"),
                        intrinsics=intr)
    res_j = jax_run_sequence(jpipe, frames, gt=centres)
    pipe, ate, inl = _port_run(frames, centres, intr,
                               raws=key_stream(0, len(frames)))
    assert (inl[1:] > 40).all(), inl
    assert ate < 0.08, ate
    np.testing.assert_allclose(inl, res_j.inliers, rtol=0.02)
    for ft, fj in zip(pipe.frames, jpipe.frames):
        assert _angle_deg(ft.R, fj.R) < 0.1, (ft.index, ft.R, fj.R)
        assert ft.is_keyframe == fj.is_keyframe
    # the scale chain multiplies per-pair medians of depth ratios: a last
    # bit can move which point is a median, so 5 %
    np.testing.assert_allclose(pipe.frame_depths, jpipe.frame_depths,
                               rtol=0.05)
    assert abs(ate - res_j.ate) < 0.01, (ate, res_j.ate)
    assert pipe.metrics.summary()["n_records"] == len(frames)


def test_windowed_ba_improves_or_matches(plane_seq):
    frames, centres, intr = plane_seq
    _, plain, _ = _port_run(frames, centres, intr)
    pipe, win, inl = _port_run(frames, centres, intr, window_ba=4)
    assert (inl[1:] > 40).all(), inl
    assert len(pipe.map.keyframes) == len(frames)
    assert win < plain * 1.15, (win, plain)


def test_two_view_ba_polish(plane_seq):
    frames, centres, intr = plane_seq
    res = run_sequence(_pipe(intrinsics=intr, ba_refine=True), frames,
                       gt=centres)
    assert (res.inliers[1:] > 40).all(), res.inliers
    assert res.ate < 0.08, res.ate


def test_unported_parts_raise():
    """Every entry point runs on the card unless asked for the CPU: without
    a card each raises.  (The loop-closure and checkpoint paths this test
    once expected to raise NotImplementedError are ported now.)"""
    pipe = _pipe(loop_detect=True)
    assert pipe.optimize_posegraph() == 0.0 and pipe.optimize_sim3() == 0.0
    if not torch.cuda.is_available():      # the default device is the card
        one = np.zeros((1, 1), np.float32)
        intr = synth.Intrinsics(1, 1, 0, 0)
        kp = dict(x=one[0], y=one[0], scale=one[0], strength=one[0],
                  laplace=one[0], ori=one[0], octave=one[0], valid=one[0],
                  count=np.int32(1))
        for make in (lambda: SlamPipeline(cst.SurfConfig(**VO_CONFIG)),
                     lambda: KeyframeMap(intr),
                     lambda: cst.ba.problem_from_numpy(one, one, one),
                     lambda: cst.ba.state_from_numpy(one, one, one),
                     lambda: LoopDetector(intr),
                     lambda: keypoints_from_numpy(kp),
                     lambda: optimize_with_loops([], [])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_copied_helpers_equal_jax():
    orbit = dict(n_frames=3, h=24, w=32, seed=1)
    for name, kw in (("render_plane_sequence", dict(n_frames=2, h=24, w=32,
                                                    seed=5)),
                     ("render_terrain_sequence", orbit),
                     ("render_forward_sequence", dict(n_frames=2, h=24,
                                                      w=32, seed=2))):
        ft, ct, it = getattr(synth, name)(**kw)
        fj, cj, ij = getattr(jseq, name)(**kw)
        np.testing.assert_array_equal(ft, fj, err_msg=name)
        np.testing.assert_array_equal(ct, cj, err_msg=name)
        assert tuple(it) == tuple(ij)
    # the first frames of an orbit alone equal the whole orbit's
    f2, c2, _ = synth.render_terrain_sequence(**orbit, first=2)
    fj, cj, _ = jseq.render_terrain_sequence(**orbit)
    np.testing.assert_array_equal(f2, fj[:2])
    np.testing.assert_array_equal(c2, cj[:2])
    rng = np.random.default_rng(9)
    est = rng.normal(size=(10, 3))
    ref = est @ np.linalg.qr(rng.normal(size=(3, 3)))[0] * 1.7 + 0.3
    ref += rng.normal(0, 0.01, ref.shape)
    for scale in (True, False):
        assert evaluate.ate_rmse(est, ref, scale) == \
            jeval.ate_rmse(est, ref, scale)
        for a, b in zip(evaluate.umeyama_align(est, ref, scale),
                        jeval.umeyama_align(est, ref, scale)):
            np.testing.assert_array_equal(a, b)
    mt, mj = MetricsLogger(), JaxMetrics()
    for m in (mt, mj):
        m.log(frame=0, keypoints=10, inliers=0)
        m.log(frame=1, keypoints=12, inliers=7, keyframe=True)
    assert mt.summary() == mj.summary()
    strip = lambda recs: [{k: v for k, v in r.items() if k != "t"}
                          for r in recs]
    assert strip(mt.records) == strip(mj.records)
