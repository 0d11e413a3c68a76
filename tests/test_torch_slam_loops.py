"""The SLAM backend as a whole on the CPU: the port's `SlamPipeline` with
loop detection against the JAX package's on the VO cell's 12-frame terrain
orbit (io.synth.TERRAIN_VO, the JAX tests' `terrain_run` config with
`loop_min_gap=6`) with windowed BA (window 4), on the JAX draws: the
pipeline's key stream (seed 0) and each loop verification's `fold_in`
draw; `loop_store=11`, so the ring evicts frame 0 at the last frame.  Then
checkpoint / resume, and the JAX run's final checkpoint loaded by the port.

Tolerances: the loop verifications are the same pairs in the same order,
each with inliers within 2 % of JAX's (or 2 points), and the same verdict
wherever JAX's inliers lie more than 10 % from `min_inliers` (60); the
trajectories themselves differ where RANSAC ties (ROADMAP Queue 3), so the
port's pose graphs are held to the JAX test's own bounds on its own VO run
(SE(3) ATE < max(1.5 x VO ATE, 0.08), Sim(3) < max(3 x VO ATE, 0.12));
`optimize_with_loops[_sim3]` on JAX's own frames, closures and depths
(the loops fixture's, seeds 0-3) at float32 rounding (R within 1e-4, t within 5e-5 x max |t|, s within 1e-5,
the cost within 1 % + 1e-9: these graphs end at the rounding floor).  A
resumed run equals a continuous one exactly, and a checkpoint the JAX
package wrote loads with every field but the random stream equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_surf_tpu as jst
from cuda_surf_tpu.slam import SlamPipeline as JaxPipeline
from cuda_surf_tpu.slam import save_pipeline as jax_save
from torch_parity import loop_raws_for, record_jax_verifications

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.config import VO_CONFIG
from cuda_surf_tpu_torch.io import synth
from cuda_surf_tpu_torch.slam import (LoopClosure, SlamPipeline, ate_rmse,
                                      load_pipeline, optimize_with_loops,
                                      optimize_with_loops_sim3,
                                      save_pipeline)
from torch_parity import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cuda_surf_tpu_torch", "data")

GAP, STORE, WINDOW = 6, 11, 4


def key_stream(seed, n_frames):
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_frames - 1):
        key, sub = jax.random.split(key)
        out.append(torch.as_tensor(np.array(jax.random.randint(
            sub, (128, 5), 0, jnp.iinfo(jnp.int32).max))))
    return out


def _pipe(**kw):
    return SlamPipeline(cst.SurfConfig(**VO_CONFIG), device="cpu", **kw)


@pytest.fixture(scope="module")
def terrain(tmp_path_factory):
    """The JAX run (its verifications logged, its final checkpoint
    written) and the port's on the same draws."""
    frames, centres, intr = synth.render_terrain_sequence(**synth.TERRAIN_VO)
    kw = dict(loop_detect=True, loop_min_gap=GAP, loop_store=STORE,
              window_ba=WINDOW)
    jpipe = JaxPipeline(jst.SurfConfig(**VO_CONFIG, wavelet_method="gather",
                                       detect_backend="xla"),
                        intrinsics=intr, **kw)
    jlog = []
    for k, f in enumerate(frames):
        jpipe.process(f)
        if k == 0:
            record_jax_verifications(jpipe._detector, jlog)
    ck = str(tmp_path_factory.mktemp("jax_ckpt") / "jax.npz")
    jax_save(ck, jpipe)
    raws = key_stream(0, len(frames))
    pipe = _pipe(intrinsics=intr, **kw)
    for k, f in enumerate(frames):
        _step(pipe, frames, raws, k)
    return dict(frames=frames, centres=centres, intr=intr, raws=raws,
                jpipe=jpipe, jlog=jlog, ck=ck, pipe=pipe, kw=kw,
                state=_state(pipe))


def _step(pipe, frames, raws, k):
    pipe.process(frames[k], raw=raws[k - 1] if k else None,
                 loop_raws=loop_raws_for(k, GAP))


def test_pipeline_loops_on_jax_draws(terrain):
    jpipe, pipe, jlog = terrain["jpipe"], terrain["pipe"], terrain["jlog"]
    assert [v[:2] for v in pipe._detector.verified] == [v[:2] for v in jlog]
    assert pipe._detector.n_verifications == \
        jpipe._detector.n_verifications > 0
    clear = lambda n: abs(n - 60) > 6
    for (i, j, nj), (_, _, nt) in zip(jlog, pipe._detector.verified):
        assert abs(nt - nj) <= max(0.02 * nj, 2), (i, j, nj, nt)
        if clear(nj):
            assert (nt >= 60) == (nj >= 60)
    jl = {(lc.i, lc.j) for lc in jpipe.loops if clear(lc.n_inliers)}
    assert jpipe.loops and pipe.loops
    assert jl <= {(lc.i, lc.j) for lc in pipe.loops}
    assert [f is None for f in pipe._detector._frames] == \
        [f is None for f in jpipe._detector._frames]
    centres = terrain["centres"]
    vo = ate_rmse(pipe.trajectory(), centres)
    frames0 = [dataclasses.replace(f) for f in pipe.frames]
    assert np.isfinite(pipe.optimize_posegraph())
    se3 = ate_rmse(pipe.trajectory(), centres)
    pipe.frames = [dataclasses.replace(f) for f in frames0]
    assert np.isfinite(pipe.optimize_sim3())
    sim3 = ate_rmse(pipe.trajectory(), centres)
    pipe.frames = frames0
    assert se3 < max(1.5 * vo, 0.08), (se3, vo)
    assert sim3 < max(3.0 * vo, 0.12), (sim3, vo)


def graph_inputs(g, seed):
    """JAX's frames, closures and frame depths of one seed of
    golden_terrain_loops.npz (the loops phase's fixture)."""
    k = list(g["seeds"]).index(seed)
    frames = [dataclasses.make_dataclass("F", ["R", "t"])(R, t)
              for R, t in zip(g["frame_R"][k], g["frame_t"][k])]
    sel = g["loop_meta"][:, 0] == seed
    loops = [LoopClosure(i=int(i), j=int(j), R=R, t=t, n_inliers=int(n),
                         med_depth=float(d), med_depth_j=float(dj))
             for (_, i, j, n), R, t, d, dj in zip(
                 g["loop_meta"][sel], g["loop_R"][sel], g["loop_t"][sel],
                 g["loop_depth"][sel], g["loop_depth_j"][sel])]
    return frames, loops, list(g["frame_depths"][k])


def test_graphs_on_jax_pipeline_state():
    """optimize_with_loops and optimize_with_loops_sim3 on the JAX
    pipeline's own frames, closures and depths (seeds 0-3 of the loops
    fixture, tests/make_torch_golden.py loops) against the JAX outputs
    stored beside them."""
    g = np.load(os.path.join(DATA, "golden_terrain_loops.npz"))
    for k, seed in enumerate(g["seeds"]):
        frames, loops, depths = graph_inputs(g, seed)
        Rp, tp, cp = optimize_with_loops(frames, loops, frame_depths=depths,
                                         device="cpu")
        Rj, tj, cj = g["se3_R"][k], g["se3_t"][k], g["se3_cost"][k]
        np.testing.assert_allclose(Rp, Rj, atol=1e-4, rtol=0)
        np.testing.assert_allclose(tp, tj, atol=5e-5 * np.abs(tj).max(),
                                   rtol=0)
        assert abs(cp - cj) <= 1e-2 * cj + 1e-9, (cp, cj)
        sp, R3p, t3p, _, k3p = optimize_with_loops_sim3(
            frames, loops, depths, min_gap=int(g["min_gap"]), device="cpu")
        np.testing.assert_allclose(sp, g["sim3_s"][k], atol=1e-5, rtol=0)
        np.testing.assert_allclose(R3p, g["sim3_R"][k], atol=1e-4, rtol=0)
        t3j = g["sim3_t"][k]
        np.testing.assert_allclose(t3p, t3j, atol=5e-5 * np.abs(t3j).max(),
                                   rtol=0)
        k3j = g["sim3_cost"][k]
        assert abs(k3p - k3j) <= 1e-2 * k3j + 1e-9, (k3p, k3j)


def _state(pipe):
    return (pipe.trajectory(), [f.n_inliers for f in pipe.frames],
            list(pipe.frame_depths),
            [(lc.i, lc.j, lc.n_inliers, lc.R.tobytes(), lc.t.tobytes(),
              lc.med_depth, lc.med_depth_j) for lc in pipe.loops])


@pytest.mark.parametrize("mode", ["plain", "window_ba", "loop_detect"])
def test_checkpoint_resume_matches_continuous(mode, terrain, tmp_path):
    """tests/test_slam_sequence.py's resume tests on the port: plain and
    window_ba (window 4) on its plane sequence, cut after 3 / 4 frames, on
    the port's own generator; loop_detect on the terrain run above (with
    windowed BA and the ring), cut after 6 frames, on the JAX draws.  Each
    saved, loaded into a fresh pipeline and run on: equal to the
    continuous run exactly."""
    if mode == "loop_detect":
        frames, raws, kw, cut = (terrain["frames"], terrain["raws"],
                                 dict(terrain["kw"],
                                      intrinsics=terrain["intr"]), 6)
        step = lambda p, k: _step(p, frames, raws, k)
        want = terrain["state"]
    else:
        frames, _, intr = synth.render_plane_sequence(n_frames=6, h=200,
                                                      w=280, seed=3)
        kw = dict(intrinsics=intr, **({} if mode == "plain"
                                      else dict(window_ba=4)))
        cut = 3 if mode == "plain" else 4
        step = lambda p, k: p.process(frames[k])
        full = _pipe(**kw)
        for k in range(len(frames)):
            step(full, k)
        want = _state(full)
    first = _pipe(**kw)
    for k in range(cut):
        step(first, k)
    ck = str(tmp_path / "slam.npz")
    save_pipeline(ck, first)
    resumed = load_pipeline(ck, _pipe(**kw))
    assert len(resumed.frames) == cut
    for k in range(cut, len(frames)):
        step(resumed, k)
    got = _state(resumed)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    if mode == "loop_detect":
        assert resumed.loops and resumed._detector.n_verifications > 0


def test_loads_jax_checkpoint(terrain):
    """The JAX package's checkpoint at the end of its run: frames, depths,
    loops, the previous frame's features, the keyframe map, the loop
    detector's store with its evicted frame; the port then runs on (one
    more frame, the orbit's frame 1 again) and verifies it against the
    stored frames."""
    jp = terrain["jpipe"]
    kw = dict(loop_detect=True, loop_min_gap=GAP, loop_store=STORE,
              window_ba=WINDOW)
    pipe = load_pipeline(terrain["ck"], _pipe(**kw))
    assert tuple(pipe.intr) == tuple(terrain["intr"])
    assert len(pipe.frames) == len(jp.frames)
    for a, b in zip(pipe.frames, jp.frames):
        assert (a.index, a.n_inliers, a.is_keyframe) == \
            (b.index, b.n_inliers, b.is_keyframe)
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)
    assert pipe.frame_depths == jp.frame_depths
    assert pipe._prev_depth == jp._prev_depth
    np.testing.assert_array_equal(pipe._prev_kp_depth, jp._prev_kp_depth)
    key = lambda lc: (lc.i, lc.j, lc.n_inliers, lc.med_depth, lc.med_depth_j)
    assert [key(lc) for lc in pipe.loops] == [key(lc) for lc in jp.loops]
    for a, b in zip(pipe.loops, jp.loops):
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)
    np.testing.assert_array_equal(pipe._prev[1].numpy(),
                                  np.asarray(jp._prev[1]))
    for name in ("x", "y", "scale", "laplace", "valid", "count"):
        np.testing.assert_array_equal(getattr(pipe._prev[0], name).numpy(),
                                      np.asarray(getattr(jp._prev[0], name)))
    assert pipe.map._next_track == jp.map._next_track
    assert len(pipe.map.keyframes) == len(jp.map.keyframes)
    for a, b in zip(pipe.map.keyframes, jp.map.keyframes):
        assert a.index == b.index
        for name in ("R", "t", "xy", "valid", "track_id"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    det, jdet = pipe._detector, jp._detector
    stored = [f is not None for f in det._frames]
    assert stored == [f is not None for f in jdet._frames]
    assert not stored[0] and all(stored[1:])
    assert det.seed == 1 and det.max_store == STORE
    for f in range(len(det._frames)):
        np.testing.assert_array_equal(det._sigs[f], jdet._sigs[f])
        if stored[f]:
            np.testing.assert_array_equal(det._frames[f][1],
                                          np.asarray(jdet._frames[f][1]))
    before = det.n_verifications
    pipe.process(terrain["frames"][1])
    assert len(pipe.frames) == len(jp.frames) + 1
    assert det.n_verifications > before
