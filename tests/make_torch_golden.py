"""Write the JAX golden fixtures that chip_smoke.py holds the port against.

Runs the JAX package on the CPU (XLA / gather paths, no Pallas) over the
main path's 1280x960 input pair (cuda_surf_tpu_torch.io.main_pair), once
at the main-path config and once at the rotated config (upright=False),
and writes the per-frame keypoint counts, the valid keypoints' x / y /
scale, and the mean best match score of the left -> right matching to
cuda_surf_tpu_torch/data/golden_plane_pair.npz and
golden_plane_pair_rotated.npz.  The rotated fixture also holds each valid
keypoint's orientation (`ori0`, `ori1`), its top-two orientation
window gap (`gap0`, `gap1`, relative) and the two top windows' angles
(`top0`, `top1`, (n, 2)), from the port's CPU window helper on the JAX
keypoints: below a gap of 1e-5 either of the two windows is a right
answer.  The doubled configs (doubled=True, upright and rotated) get the
same two fixtures, golden_plane_pair_doubled.npz and
golden_plane_pair_doubled_rotated.npz.  The batch fixture,
golden_plane_batch.npz, is the JAX `detect_and_compute_batch` on the
BATCH_FRAMES frames of `main_batch` at the main config: per-frame counts,
the valid slots' x / y / scale / laplace, the zero padding checked, and the
mean best score of each frame i -> i + 1 matching.  Before it writes them the script holds the JAX orientations to
those windows (torch_parity.check_orientations: 1e-4 rad to the port's
choice where the gap is >= 1e-5, to one of the two below it), so the
gaps are the JAX package's too.  The machine with the card has no JAX,
so the fixtures are made here and committed.

The visual-odometry slice's fixtures:

  - `track`, golden_terrain_track.npz: frames 0 and 1 of the 50-frame
    terrain orbit at 1280x960 (io.synth.TERRAIN_TRACK, stored: they take
    ~50 s to render), the JAX `Surf` keypoint counts at the main config,
    the JAX `track_pair` (5-point RANSAC, PRNGKey(0)) R, t, inlier count
    and inlier mask, the `raw` draw of that key, (128, 5), and the inside
    of that RANSAC (the JAX functions that ransac_essential calls, run
    apart): the winning hypothesis, its score and how many candidates tie
    at it.  On this pair every good match is an inlier of several
    candidates and the first of them wins; which one is first rests on
    float32 rounding (ROADMAP Queue 3, "RANSAC ties").  So the fixture
    also holds the draws of PRNGKey(0..63) (`raws`) with the JAX result of
    each (`keys_n`, `keys_R`, `keys_t`), its winning hypothesis, that
    hypothesis' index, sample x 20 + slot, and its score (`keys_E`,
    `keys_win`, `keys_best`), and prints and stores as `keys`
    the port's result on the CPU beside it: key, JAX inliers, port
    inliers, degrees between their rotations and between their t, ties at
    the best score;
  - `ba`, golden_ba_step.npz: bench.py's 8-camera x 512-point problem
    (io.synth.ba_problem): the state after one JAX `lm_step` at
    lambda = 1e-3, the cost before and after it, and `run_lm`'s final cost
    after 10 iterations;
  - `vo`, golden_terrain_vo.npz: the JAX `SlamPipeline` over the 12-frame
    terrain orbit at 200x280 (io.synth.TERRAIN_VO, the SLAM tests' config),
    plain, with ba_refine=True and with window_ba=4, each at seeds 0..7
    (VO_SEEDS): each run's ATE and per-frame inliers, the key stream of
    each seed (`raws`, (seeds, frames - 1, 128, 5): the `raw` of each
    frame's RANSAC), the port's runs on the CPU on those draws
    (`port_ate_*`, `port_inliers_*`) and a hash of the frames (the card
    renders them).  The seeds matter: one RANSAC draw in a few lets a
    degenerate five-point candidate win a pair, and the JAX pipeline's
    plain ATE ranges over 0.017-0.112 across these seeds.

The SLAM backend's fixtures:

  - `posegraph`, golden_posegraph.npz: four graphs, each with its inputs
    and the JAX `optimize` result (R, t, s for Sim(3), the cost of each
    step): the SE(3) circle graph of tests/test_posegraph.py at n = 64
    with 8 loops (`default_rng(3)`, dense path, 10 steps) and at n = 600
    with 30 loops (`default_rng(7)`, CG path, 5 steps: test_large_graph_cg's
    graph), and the Sim(3) circle (`_sim3_circle`) at the same sizes
    (`default_rng(3)` / `(7)`, every node but the gauge perturbed in scale,
    rotation and translation; dense 12 steps, CG 8 steps).  For the CG cases
    also the CG rounds of each step (`rounds_*`), counted by a re-run of the
    same steps outside the jitted scan with `lax.while_loop` wrapped;
  - `loops`, golden_terrain_loops.npz: the JAX `SlamPipeline(loop_detect=
    True, loop_min_gap=6)` over the VO cell's 12 frames at the VO cell's
    seeds 0-7 (LOOP_SEEDS) on golden_terrain_vo.npz's key stream, with the
    loop detector's draws of every pair (i, j >= i + 6) (`loop_pairs`,
    `loop_raws`: `randint(fold_in(PRNGKey(1), i * 100003 + j))`); per seed
    the verified pairs in order with their inliers (`ver`: seed, i, j,
    inliers), the closures, the frames, `frame_depths`, the outputs of
    `optimize_with_loops` and `optimize_with_loops_sim3` on them, and the
    ATE of the VO trajectory and after each graph; beside them the port's
    run on the CPU on the same draws (`port_*`).

    python tests/make_torch_golden.py [pair] [doubled] [batch] [track] [ba] [vo]
                                      [posegraph] [loops]

With no argument it writes all of them (several minutes on a CPU).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import torch  # noqa: E402

import hashlib  # noqa: E402

import cuda_surf_tpu as cst  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from cuda_surf_tpu.ba import core as jba  # noqa: E402
from cuda_surf_tpu.frontend import detect_and_compute_batch  # noqa: E402
from cuda_surf_tpu.ops.matcher import match_keypoints  # noqa: E402
from cuda_surf_tpu.slam import SlamPipeline, run_sequence  # noqa: E402
from cuda_surf_tpu.geometry import epipolar as jep  # noqa: E402
from cuda_surf_tpu.geometry import fivepoint as jfp  # noqa: E402
from cuda_surf_tpu.slam import track_pair  # noqa: E402
from cuda_surf_tpu_torch.config import (  # noqa: E402
    BATCH_FRAMES, DOUBLED_CONFIG, DOUBLED_ROTATED_CONFIG, MAIN_CONFIG,
    ROTATED_CONFIG, VO_CONFIG, VO_SEEDS, SurfConfig)
import cuda_surf_tpu_torch as tst  # noqa: E402
from cuda_surf_tpu_torch.io.synth import (  # noqa: E402
    MAIN_PAIR, TERRAIN_TRACK, TERRAIN_VO, ba_problem, main_batch, main_pair,
    render_terrain_sequence)
from cuda_surf_tpu_torch.ops.integral import integral_image  # noqa: E402
from cuda_surf_tpu_torch.ops.orientation import (  # noqa: E402
    assign_orientations_plain, orientation_windows, top2_windows)
from torch_parity import (check_orientations,  # noqa: E402
                          record_jax_verifications)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "cuda_surf_tpu_torch", "data")


def write(config: dict, name: str) -> None:
    frames = main_pair()
    cfg = cst.SurfConfig(**config, wavelet_method="gather",
                         detect_backend="xla")
    surf = cst.Surf(cfg)
    kps, descs = zip(*[surf.detect_and_compute(f) for f in frames])
    m = surf.match(kps[0], descs[0], kps[1], descs[1])
    mv = np.asarray(m.valid)
    out = dict(
        counts=np.array([int(k.count) for k in kps], np.int32),
        mean_best=np.float64(np.asarray(m.score)[mv].mean()),
        n_matches=np.int32(mv.sum()),
        config=np.array(repr(sorted(config.items()))),
        pair=np.array(repr(sorted(MAIN_PAIR.items()))),
    )
    for f, (k, frame) in enumerate(zip(kps, frames)):
        v = np.asarray(k.valid)
        names = ("x", "y", "scale") + (() if cfg.upright else ("ori",))
        for nm in names:
            out[f"{nm}{f}"] = np.asarray(getattr(k, nm))[v].astype(np.float32)
        if not cfg.upright:
            t = lambda a: torch.as_tensor(np.asarray(a))
            ii = integral_image(t(frame), cfg.doubled)
            args = (t(k.x), t(k.y), t(k.scale), t(k.valid))
            ws, wa = orientation_windows(ii, *args, doubled=cfg.doubled)
            port = assign_orientations_plain(ii, SurfConfig(**config), *args)
            near = check_orientations(np.asarray(k.ori), port, ws, wa, v)
            gap, top = top2_windows(ws, wa)
            out[f"gap{f}"] = gap.numpy()[v]
            out[f"top{f}"] = top.numpy()[v]
            print(f"frame {f}: {int(near.sum())} near ties of {int(v.sum())}")
    path = os.path.join(DATA, name)
    os.makedirs(DATA, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"wrote {path}: counts {out['counts'].tolist()}, "
          f"mean best {float(out['mean_best']):.6f}")


def write_batch(config: dict, n_frames: int, name: str) -> None:
    frames = main_batch(n_frames)
    cfg = cst.SurfConfig(**config, wavelet_method="gather",
                         detect_backend="xla", detect_fit="sparse")
    kb, db = jax.jit(lambda im: detect_and_compute_batch(im, cfg))(
        jnp.asarray(frames))
    frame_of = lambda i: jax.tree_util.tree_map(lambda a: a[i], kb)
    match = jax.jit(match_keypoints)
    mean_best = []
    for i in range(n_frames - 1):
        m = match(frame_of(i), db[i], frame_of(i + 1), db[i + 1])
        mean_best.append(np.asarray(m.score)[np.asarray(m.valid)].mean())
    out = dict(counts=np.asarray(kb.count, np.int32),
               mean_best=np.asarray(mean_best, np.float64),
               config=np.array(repr(sorted(config.items()))),
               pair=np.array(repr(sorted(MAIN_PAIR.items()))),
               n_frames=np.int32(n_frames))
    for f in range(n_frames):
        v = np.asarray(kb.valid[f])
        fields = {nm: np.asarray(getattr(kb, nm)[f])
                  for nm in ("x", "y", "scale", "laplace")}
        # the layout the fixture stands for: valid first, zero padding
        if v.sum() != out["counts"][f] or not v[:v.sum()].all() or \
                any(a[~v].any() for a in fields.values()) or \
                np.asarray(db[f])[~v].any():
            raise ValueError(f"frame {f}: the JAX batch is not valid-first "
                             "with zero padding")
        out.update({f"{nm}{f}": a[v] for nm, a in fields.items()})
    path = os.path.join(DATA, name)
    np.savez_compressed(path, **out)
    print(f"wrote {path}: counts {out['counts'].tolist()}, mean best "
          f"{[round(float(b), 6) for b in mean_best]}")


TRACK_THRESH = 2e-5    # track_pair's inlier threshold
TRACK_KEYS = 64        # the draws of PRNGKey(0..63), JAX beside the port


def ransac_inside(x1, x2, valid, raw):
    """ransac_essential's 5-point path (epipolar.py:207-270) from the JAX
    functions it calls, on the draw `raw`: -> (winning hypothesis, its
    index (sample x 20 + slot), its score, the number of candidates at
    that score, inliers, R, t)."""
    count = jnp.maximum(valid.sum(), 1)
    cdf = jnp.cumsum(valid.astype(jnp.int32))
    sample = jnp.searchsorted(cdf, (raw % count + 1).reshape(-1)).reshape(
        raw.shape)
    Es, ok = jfp.five_point(x1[sample], x2[sample], gn_iters=4)
    Es, ok = Es.reshape(-1, 3, 3), ok.reshape(-1)
    scores = jnp.where(ok, jep._sampson_inlier_counts(
        Es, x1, x2, valid, TRACK_THRESH), -1)
    best = jnp.argmax(scores)
    E = jep.project_essential(Es[best])
    inliers = (jep.sampson_error(E, x1, x2) < TRACK_THRESH) & valid
    n_best = inliers.sum()
    for _ in range(2):
        E_new = jep.project_essential(
            jep._eight_point(x1, x2, inliers.astype(x1.dtype)))
        inl_new = (jep.sampson_error(E_new, x1, x2) < TRACK_THRESH) & valid
        use = inl_new.sum() >= n_best
        E = jnp.where(use, E_new, E)
        inliers = jnp.where(use, inl_new, inliers)
        n_best = jnp.maximum(inl_new.sum(), n_best)
    R, t, _ = jep.recover_pose(E, x1, x2, inliers)
    return (Es[best], best, scores[best], (scores == scores[best]).sum(),
            inliers, R, t)


def pose_gap(n_a, R_a, t_a, n_b, R_b, t_b):
    """(relative inlier gap, rotation degrees, t-direction degrees)."""
    R_a, R_b, t_a, t_b = (np.asarray(a, np.float64)
                          for a in (R_a, R_b, t_a, t_b))
    c = (np.trace(R_a @ R_b.T) - 1) / 2
    ct = t_a @ t_b / (np.linalg.norm(t_a) * np.linalg.norm(t_b))
    return (abs(int(n_a) - int(n_b)) / max(int(n_b), 1),
            float(np.degrees(np.arccos(np.clip(c, -1, 1)))),
            float(np.degrees(np.arccos(np.clip(ct, -1, 1)))))


def write_track(name: str) -> None:
    frames, _, intr = render_terrain_sequence(**TERRAIN_TRACK)
    cfg = cst.SurfConfig(**MAIN_CONFIG, wavelet_method="gather",
                         detect_backend="xla")
    surf = cst.Surf(cfg)
    (k1, d1), (k2, d2) = [surf.detect_and_compute(f) for f in frames]
    res = jax.jit(track_pair)(k1, d1, k2, d2, intr, jax.random.PRNGKey(0))
    m = match_keypoints(k1, d1, k2, d2)
    good = m.valid & (m.ambiguity < 0.95) & (k1.laplace == k2.laplace[m.index])
    x1 = jep.normalize_with_intrinsics(jnp.stack([k1.x, k1.y], -1), *intr)
    x2 = jep.normalize_with_intrinsics(jnp.stack([m.match_x, m.match_y], -1),
                                       *intr)
    inside = jax.jit(ransac_inside)
    t = lambda a: torch.as_tensor(np.array(a))
    raws, jax_out, keys = [], [], []
    for k in range(TRACK_KEYS):
        raw = jax.random.randint(jax.random.PRNGKey(k), (128, 5), 0,
                                 jnp.iinfo(jnp.int32).max)
        E_win, win_idx, score, ties, inl, R, t_ = inside(x1, x2, good, raw)
        if k == 0:
            win = (E_win, score, ties)
            if int(inl.sum()) != int(res.n_inliers) or not np.allclose(
                    np.asarray(R), np.asarray(res.R), atol=1e-6):
                raise ValueError("the RANSAC run apart differs from "
                                 "track_pair's")
        port = tst.ransac_essential(t(x1), t(x2), t(good), n_hypotheses=128,
                                    inlier_thresh=TRACK_THRESH, solver="5pt",
                                    raw=t(raw))
        gap = pose_gap(port.n_inliers, port.R.numpy(), port.t.numpy(),
                       inl.sum(), R, t_)
        raws.append(np.asarray(raw, np.int32))
        jax_out.append((int(inl.sum()), np.asarray(R), np.asarray(t_),
                        np.asarray(E_win), int(win_idx), int(score)))
        keys.append((k, int(inl.sum()), int(port.n_inliers), gap[1], gap[2],
                     int(ties)))
        print(f"key {k}: JAX {keys[-1][1]} inliers, port {keys[-1][2]}; "
              f"rotations {gap[1]:.3f} deg apart, t {gap[2]:.3f} deg; "
              f"{int(ties)} candidates at the best score {int(score)}")
    E_win, score, ties = win
    out = dict(frames=frames, raw=raws[0], raws=np.stack(raws),
               counts=np.array([int(k1.count), int(k2.count)], np.int32),
               R=np.asarray(res.R), t=np.asarray(res.t),
               n_inliers=np.int32(res.n_inliers),
               inliers=np.asarray(res.inliers),
               n_good=np.int32(good.sum()), E_win=np.asarray(E_win),
               best_score=np.int32(score), ties=np.int32(ties),
               keys_n=np.array([o[0] for o in jax_out], np.int32),
               keys_R=np.stack([o[1] for o in jax_out]),
               keys_t=np.stack([o[2] for o in jax_out]),
               keys_E=np.stack([o[3] for o in jax_out]),
               keys_win=np.array([o[4] for o in jax_out], np.int32),
               keys_best=np.array([o[5] for o in jax_out], np.int32),
               keys=np.array(keys, np.float64),
               intrinsics=np.asarray(intr, np.float64),
               config=np.array(repr(sorted(MAIN_CONFIG.items()))),
               cell=np.array(repr(sorted(TERRAIN_TRACK.items()))))
    path = os.path.join(DATA, name)
    np.savez_compressed(path, **out)
    kt = out["keys"]
    agree = ((np.abs(kt[:, 1] - kt[:, 2]) <= 0.02 * kt[:, 1])
             & (kt[:, 3] <= 0.1) & (kt[:, 4] <= 1.0))
    print(f"of {TRACK_KEYS} draws the port on the CPU agrees with JAX (2 %, "
          f"0.1 deg, 1 deg) on {int(agree.sum())}; final inliers below 150 "
          f"of {int(out['n_good'])}: JAX {int((kt[:, 1] < 150).sum())}, port "
          f"{int((kt[:, 2] < 150).sum())}; median rotation gap "
          f"{np.median(kt[:, 3]):.3f} deg")
    print(f"wrote {path}: counts {out['counts'].tolist()}, good matches "
          f"{int(out['n_good'])}, inliers {int(out['n_inliers'])} at "
          f"PRNGKey(0), best score {int(score)} shared by {int(ties)} "
          f"candidates")


def write_ba(name: str) -> None:
    (ci, uv, mask), (R, t, X) = ba_problem()
    prob = jba.BAProblem(jnp.asarray(ci), jnp.asarray(uv), jnp.asarray(mask))
    state = jba.BAState(jnp.asarray(R), jnp.asarray(t), jnp.asarray(X))
    C = R.shape[0]
    step = jax.jit(lambda s, p: jba.lm_step(s, p, jnp.float32(1e-3), C))(
        state, prob)
    _, c10 = jax.jit(lambda s, p: jba.run_lm(s, p, n_iters=10))(state, prob)
    out = dict(R=np.asarray(step.R), t=np.asarray(step.t),
               points=np.asarray(step.points),
               cost0=np.float32(jba.cost(state, prob)),
               cost1=np.float32(jba.cost(step, prob)),
               cost_lm10=np.float32(c10), lam=np.float32(1e-3))
    path = os.path.join(DATA, name)
    np.savez_compressed(path, **out)
    print(f"wrote {path}: cost {out['cost0']} -> {out['cost1']}, run_lm "
          f"{out['cost_lm10']}")


def key_stream(seed: int, n_frames: int) -> np.ndarray:
    """(n_frames - 1, 128, 5) int32: the `raw` of each frame after the
    first, as the JAX pipeline draws it from PRNGKey(seed) (pipeline.py:90,
    :138, epipolar.py:217)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_frames - 1):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(
            sub, (128, 5), 0, jnp.iinfo(jnp.int32).max), np.int32))
    return np.stack(out)


def write_vo(name: str) -> None:
    frames, centres, intr = render_terrain_sequence(**TERRAIN_VO)
    cfg = cst.SurfConfig(**VO_CONFIG, wavelet_method="gather",
                         detect_backend="xla")
    raws = np.stack([key_stream(seed, len(frames)) for seed in VO_SEEDS])
    out = dict(frames_sha256=np.array(hashlib.sha256(
                   frames.tobytes()).hexdigest()),
               seeds=np.asarray(VO_SEEDS, np.int32), raws=raws,
               config=np.array(repr(sorted(VO_CONFIG.items()))),
               cell=np.array(repr(sorted(TERRAIN_VO.items()))))
    for run, kw in (("plain", {}), ("ba_refine", dict(ba_refine=True)),
                    ("window_ba", dict(window_ba=4))):
        ates, inliers, port_ates, port_inliers = [], [], [], []
        for seed, seed_raws in zip(VO_SEEDS, raws):
            res = run_sequence(SlamPipeline(cfg, intrinsics=intr, seed=seed,
                                            **kw), frames, gt=centres)
            ates.append(res.ate)
            inliers.append(res.inliers)
            # the port on the CPU, on the same draws
            pipe = tst.SlamPipeline(SurfConfig(**VO_CONFIG), intrinsics=intr,
                                    device="cpu", **kw)
            for f, raw in zip(frames, [None, *seed_raws]):
                pipe.process(f, raw=None if raw is None
                             else torch.as_tensor(raw))
            port_ates.append(tst.slam.evaluate.ate_rmse(pipe.trajectory(),
                                                        centres))
            port_inliers.append([fs.n_inliers for fs in pipe.frames])
            print(f"{run}, seed {seed}: ATE {res.ate:.5f}, inliers "
                  f"{res.inliers.tolist()}; the port on the CPU, same "
                  f"draws: ATE {port_ates[-1]:.5f}, inliers "
                  f"{port_inliers[-1]}", flush=True)
        out[f"ate_{run}"] = np.asarray(ates, np.float64)
        out[f"inliers_{run}"] = np.asarray(inliers, np.int32)
        out[f"port_ate_{run}"] = np.asarray(port_ates, np.float64)
        out[f"port_inliers_{run}"] = np.asarray(port_inliers, np.int32)
    path = os.path.join(DATA, name)
    np.savez_compressed(path, **out)
    print(f"wrote {path}")


POSEGRAPH_CASES = (("se3_64", 64, 8, 3, "dense", 10),
                   ("se3_600", 600, 30, 7, "cg", 5),
                   ("sim3_64", 64, 8, 3, "dense", 12),
                   ("sim3_600", 600, 30, 7, "cg", 8))


def sim3_perturbed(n, n_loops, seed):
    """tests/test_posegraph.py's exact Sim(3) circle, every node but the
    gauge perturbed: scale by exp(N(0, 0.1)), rotation by exp(N(0, 0.02)),
    translation by N(0, 0.1)."""
    from test_posegraph import _sim3_circle
    from cuda_surf_tpu.geometry.pose import exp_so3
    rng = np.random.default_rng(seed)
    g, Rs, ts, ss = _sim3_circle(n, n_loops, rng)
    ps = np.ones(n)
    ps[1:] = np.exp(rng.normal(0, 0.1, n - 1))
    dR = np.asarray(exp_so3(jnp.asarray(np.concatenate(
        [np.zeros((1, 3)), rng.normal(0, 0.02, (n - 1, 3))]), jnp.float32)))
    dt = np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.1, (n - 1, 3))])
    return g._replace(s=jnp.asarray(ss * ps, jnp.float32),
                      R=jnp.asarray(np.einsum("nij,njk->nik", dR, Rs),
                                    jnp.float32),
                      t=jnp.asarray(ts + dt, jnp.float32))


def cg_rounds(graph, n_iters, sim3):
    """The CG rounds of each Gauss-Newton step of the JAX `optimize` (CG
    path), from a re-run of its steps outside the jitted scan with
    lax.while_loop wrapped to read the round count it ends at."""
    from cuda_surf_tpu.slam import posegraph as jpg, sim3graph as js3
    rounds, orig = [], jax.lax.while_loop

    def counted(cond, body, init):
        out = orig(cond, body, init)
        rounds.append(int(out[0]))
        return out

    n = graph.R.shape[0]
    s, R, t = (graph.s if sim3 else None), graph.R, graph.t
    jax.lax.while_loop = counted
    try:
        for _ in range(n_iters):
            blk = (js3._edge_blocks(graph, s, R, t) if sim3
                   else jpg._edge_blocks(graph, R, t))[1:]
            dx = jpg._solve_cg(graph, n, 1e-6, *blk, max(8 * n, 200))
            R = jpg.exp_so3(dx[:, :3]) @ R
            t = t + dx[:, 3:6]
            if sim3:
                s = s * jnp.exp(dx[:, 6])
    finally:
        jax.lax.while_loop = orig
    return np.asarray(rounds, np.int32)


def write_posegraph(name: str) -> None:
    from test_posegraph import _circle_graph
    from cuda_surf_tpu.slam import posegraph as jpg, sim3graph as js3
    out = {}
    for case, n, n_loops, seed, solver, n_iters in POSEGRAPH_CASES:
        sim3 = case.startswith("sim3")
        g = (sim3_perturbed(n, n_loops, seed) if sim3 else
             _circle_graph(n, n_loops, np.random.default_rng(seed))[0])
        opt = js3.optimize if sim3 else jpg.optimize
        go, costs = jax.jit(lambda g: opt(g, n_iters=n_iters,
                                          solver=solver))(g)
        for k, v in g._asdict().items():
            out[f"{case}_in_{k}"] = np.asarray(v)
        for k in ("s", "R", "t") if sim3 else ("R", "t"):
            out[f"{case}_{k}"] = np.asarray(getattr(go, k))
        out[f"{case}_costs"] = np.asarray(costs)
        out[f"{case}_meta"] = np.array(repr(dict(solver=solver,
                                                  n_iters=n_iters)))
        if solver == "cg":
            out[f"rounds_{case}"] = cg_rounds(g, n_iters, sim3)
        print(f"{case}: costs {np.asarray(costs)}"
              + (f", CG rounds {out[f'rounds_{case}'].tolist()}"
                 if solver == "cg" else ""), flush=True)
    path = os.path.join(DATA, name)
    np.savez_compressed(path, **out)
    print(f"wrote {path}")


LOOP_SEEDS = VO_SEEDS
LOOP_MIN_GAP = 6


def loop_raws(n_frames: int, min_gap: int):
    """The JAX loop detector's draw of every pair (i, j >= i + min_gap):
    randint(fold_in(PRNGKey(1), i * 100003 + j), (128, 5))
    (loopclosure.py:83, :137; epipolar.py:217)."""
    key = jax.random.PRNGKey(1)
    pairs = [(i, j) for j in range(n_frames) for i in range(j - min_gap + 1)]
    raws = [np.asarray(jax.random.randint(
        jax.random.fold_in(key, i * 100003 + j), (128, 5), 0,
        jnp.iinfo(jnp.int32).max), np.int32) for i, j in pairs]
    return np.asarray(pairs, np.int32).reshape(-1, 2), np.stack(raws)


def _closures(seed, loops):
    return (np.asarray([[seed, lc.i, lc.j, lc.n_inliers] for lc in loops],
                       np.int64).reshape(-1, 4),
            [np.asarray(lc.R, np.float64) for lc in loops],
            [np.asarray(lc.t, np.float64) for lc in loops],
            [lc.med_depth for lc in loops], [lc.med_depth_j for lc in loops])


def write_loops(name: str) -> None:
    import dataclasses
    from cuda_surf_tpu.slam.loopclosure import optimize_with_loops
    from cuda_surf_tpu.slam.sim3graph import optimize_with_loops_sim3
    from cuda_surf_tpu.slam import ate_rmse
    frames, centres, intr = render_terrain_sequence(**TERRAIN_VO)
    vo = np.load(os.path.join(DATA, "golden_terrain_vo.npz"))
    if str(vo["frames_sha256"]) != hashlib.sha256(
            frames.tobytes()).hexdigest():
        raise AssertionError("golden_terrain_vo.npz is for other frames")
    pairs, lraws = loop_raws(len(frames), LOOP_MIN_GAP)
    cfg = cst.SurfConfig(**VO_CONFIG, wavelet_method="gather",
                         detect_backend="xla")
    rec = {k: [] for k in ("ver", "loop_meta", "loop_R", "loop_t",
                           "loop_depth", "loop_depth_j", "frame_R",
                           "frame_t", "frame_depths", "inliers", "ate_vo",
                           "se3_R", "se3_t", "se3_cost", "ate_se3",
                           "sim3_s", "sim3_R", "sim3_t", "sim3_cost",
                           "ate_sim3", "port_ver", "port_loops",
                           "port_ate_vo", "port_ate_se3", "port_ate_sim3")}
    for seed in LOOP_SEEDS:
        pipe = SlamPipeline(cfg, intrinsics=intr, seed=seed,
                            loop_detect=True, loop_min_gap=LOOP_MIN_GAP)
        pipe.process(frames[0])
        record_jax_verifications(pipe._detector, rec["ver"], (seed,))
        for f in frames[1:]:
            pipe.process(f)
        ate_vo = ate_rmse(pipe.trajectory(), centres)
        meta, Rl, tl, dl, djl = _closures(seed, pipe.loops)
        rec["loop_meta"].append(meta)
        rec["loop_R"] += Rl
        rec["loop_t"] += tl
        rec["loop_depth"] += dl
        rec["loop_depth_j"] += djl
        rec["frame_R"].append(np.stack([f.R for f in pipe.frames]))
        rec["frame_t"].append(np.stack([f.t for f in pipe.frames]))
        rec["frame_depths"].append(np.asarray(pipe.frame_depths))
        rec["inliers"].append([f.n_inliers for f in pipe.frames])
        rec["ate_vo"].append(ate_vo)
        Ro, to, cost = optimize_with_loops(pipe.frames, pipe.loops,
                                           frame_depths=pipe.frame_depths)
        rec["se3_R"].append(Ro)
        rec["se3_t"].append(to)
        rec["se3_cost"].append(cost)
        s3, R3, t3, _, c3 = optimize_with_loops_sim3(
            pipe.frames, pipe.loops, pipe.frame_depths,
            min_gap=LOOP_MIN_GAP)
        rec["sim3_s"].append(s3)
        rec["sim3_R"].append(R3)
        rec["sim3_t"].append(t3)
        rec["sim3_cost"].append(c3)
        vo_frames = [dataclasses.replace(f) for f in pipe.frames]
        pipe.optimize_posegraph()
        rec["ate_se3"].append(ate_rmse(pipe.trajectory(), centres))
        pipe.frames = [dataclasses.replace(f) for f in vo_frames]
        pipe.optimize_sim3()
        rec["ate_sim3"].append(ate_rmse(pipe.trajectory(), centres))
        # the port on the CPU, on the same draws
        port = tst.SlamPipeline(SurfConfig(**VO_CONFIG), intrinsics=intr,
                                loop_detect=True, loop_min_gap=LOOP_MIN_GAP,
                                device="cpu")
        seed_raws = vo["raws"][seed]
        for k, f in enumerate(frames):
            port.process(f, raw=None if k == 0 else torch.as_tensor(
                seed_raws[k - 1]), loop_raws={
                    int(i): torch.as_tensor(r)
                    for (i, j), r in zip(pairs, lraws) if j == k})
        rec["port_ver"] += [[seed, *v] for v in port._detector.verified]
        rec["port_loops"].append(len(port.loops))
        rec["port_ate_vo"].append(tst.slam.ate_rmse(port.trajectory(),
                                                    centres))
        port_vo = [dataclasses.replace(f) for f in port.frames]
        port.optimize_posegraph()
        rec["port_ate_se3"].append(tst.slam.ate_rmse(port.trajectory(),
                                                     centres))
        port.frames = port_vo
        port.optimize_sim3()
        rec["port_ate_sim3"].append(tst.slam.ate_rmse(port.trajectory(),
                                                      centres))
        print(f"seed {seed}: JAX verifications "
              f"{[v[1:] for v in rec['ver'] if v[0] == seed]}, loops "
              f"{len(pipe.loops)}, ATE VO {ate_vo:.5f} SE3 "
              f"{rec['ate_se3'][-1]:.5f} Sim3 {rec['ate_sim3'][-1]:.5f}; "
              f"the port on the CPU, same draws: verifications "
              f"{[v[1:] for v in rec['port_ver'] if v[0] == seed]}, loops "
              f"{len(port.loops)}, ATE VO {rec['port_ate_vo'][-1]:.5f} SE3 "
              f"{rec['port_ate_se3'][-1]:.5f} Sim3 "
              f"{rec['port_ate_sim3'][-1]:.5f}", flush=True)
    out = dict(frames_sha256=np.array(hashlib.sha256(
                   frames.tobytes()).hexdigest()),
               seeds=np.asarray(LOOP_SEEDS, np.int32),
               min_gap=np.int32(LOOP_MIN_GAP), loop_pairs=pairs,
               loop_raws=lraws,
               config=np.array(repr(sorted(VO_CONFIG.items()))),
               cell=np.array(repr(sorted(TERRAIN_VO.items()))))
    for k, v in rec.items():
        if k == "loop_meta":
            v = np.concatenate(v)
        out[k] = np.asarray(v)
    path = os.path.join(DATA, name)
    np.savez_compressed(path, **out)
    print(f"wrote {path}")


def main() -> None:
    what = set(sys.argv[1:]) or {"pair", "doubled", "batch", "track", "ba",
                                 "vo", "posegraph", "loops"}
    if "pair" in what:
        write(MAIN_CONFIG, "golden_plane_pair.npz")
        write(ROTATED_CONFIG, "golden_plane_pair_rotated.npz")
    if "doubled" in what:
        write(DOUBLED_CONFIG, "golden_plane_pair_doubled.npz")
        write(DOUBLED_ROTATED_CONFIG, "golden_plane_pair_doubled_rotated.npz")
    if "batch" in what:
        write_batch(MAIN_CONFIG, BATCH_FRAMES, "golden_plane_batch.npz")
    if "track" in what:
        write_track("golden_terrain_track.npz")
    if "ba" in what:
        write_ba("golden_ba_step.npz")
    if "vo" in what:
        write_vo("golden_terrain_vo.npz")
    if "posegraph" in what:
        write_posegraph("golden_posegraph.npz")
    if "loops" in what:
        write_loops("golden_terrain_loops.npz")


if __name__ == "__main__":
    main()
