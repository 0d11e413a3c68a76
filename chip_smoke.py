"""Check the PyTorch + CUDA port's paths once on one NVIDIA GPU.

This script checks; it measures nothing.  The benchmark (`python3 -m
portbench.run`) measures the cells, and `probe_stages.py` gives the
readings no cell takes (`--kernels`: each kernel's own time, occupancy and
bound share; `--track`: the VO stages and the pose-graph step).

The pair paths run the 1280x960 pair cuda_surf_tpu_torch.io.main_pair
through Surf(cfg, device="cuda"): detect + describe on each frame, then left
-> right matching.  The main path is the reference demo's workload, upright
64-d SURF at SurfConfig(noctaves=4, thresh=4.0, upright=True, max_pts=4096,
candidates_per_octave=4096); the rotated path is the same config with
upright=False (orientation, then rotated descriptors); the doubled paths add
doubled=True to each (the frame upsampled 2x: a 2560x1920 integral image);
the step-routed path is the main path with patch_wavelets.DEC_STEPS = (4, 5,
6, 7, 8), which sends the keypoints of those sampling steps through the
static-step kernel.  The batch path runs Surf.detect_and_compute_batch on
the 8 frames of io.main_batch (frames 0 and 1 are the main pair) at the main
config and matches frame i -> i + 1 with BatchSurf.match; the rotated batch
path runs it at the rotated config.  The script

  1. prints the card (nvidia-smi), CUDA, nvcc and Triton versions;
  2. builds the kernels from cuda_surf_tpu_torch/csrc with nvcc, one
     process per source, in parallel, and prints what ptxas reports;
  3. holds each kernel against its plain PyTorch twin on the card at the
     paths' shapes (A: layers bit-exact and masks equal, on each frame of
     the pair and, in one launch, on the stack of the 8 frames, where
     every frame must also equal the single-frame launch; B in all four
     modes, upright / rotated x 64 / 128-d: per-row cosine >= 0.99999 and
     invalid rows zero; B on 8 stacked frames, 32768 slots, upright and
     rotated 64-d: the same against the twin, and equal bit for bit to the
     single-frame kernel's rows of each frame; the static-step kernel at
     steps 4..8 with cap 512: the taken mask equal to the twin's, rows
     equal bit for bit to kernel B's, overflow beyond a small cap left
     untaken; C at D = 64 and 128 (its products are 3xTF32 on the tensor
     cores): |d score| <= 1e-5 and equal indices wherever best - second >=
     1e-5; C on the batch's 7 pairs of consecutive frames in one launch:
     the same against the twin, and equal bit for bit to seven launches of
     one pair; D: its in-kernel geometry's angles those of the twin on
     orient_geometry, within 1e-4 rad wherever the top-two window gap is
     >= 1e-5 relative, one of the two top windows below that; B, D and the
     step kernel bit-identical across two launches; A, D and B again at the
     doubled frame's size; E, the five-point solver, on the 64 JAX draws of
     golden_terrain_track.npz, 128 hypotheses a call as track_pair makes
     it: `valid` equal on every slot and every valid candidate within 1e-4
     of the twin's, the share equal bit for bit reported; F, the compaction
     and subpixel walk, on each frame of the main pair, on the batch's 8
     frames in one call and on a 640x480 terrain frame at the VO config:
     every output field and the counts bit for bit, one launch a call, and
     how many step-1 movers there were beside the walker set; G, the
     integral image, on the main frame, the batch's 8 frames in one call
     and the 640x480 terrain frame, and doubled (its own entry point) on
     the main frame and a stack of 32 1280x960 frames: bit for bit, one
     library call a call);
  4. for each path, snapshots `_build.launch_counts`, runs it, checks that
     every kernel of the path launched (kernels A and G once per frame on
     the pair paths, once per batch on the batch path) and no other did,
     and holds the keypoints and the mean best score against the path's JAX
     golden fixture (cuda_surf_tpu_torch/data/golden_plane_*.npz; the
     rotated ones also hold the orientations, to 1e-3 rad wherever the gap
     is >= 1e-5 and to one of the two top windows below it; the batch one
     also the Laplacian signs and the zero padding).  The batch must also
     equal the port's own single-frame path frame by frame, exactly, and the
     step-routed path the main path's descriptors.  The rotated batch path
     launches G, A, F, D and the stacked B once each; its orientations are
     held against the twin with the frame index on the stack as D's are,
     and every valid slot equals the single-frame rotated path bit for bit;
  5. drives the visual-odometry paths after the frontend's, each with its
     launches counted:
     - `track`: Surf + track_pair (5-point RANSAC) on frames 0 and 1 of the
       50-frame terrain orbit at 1280x960, stored in the fixture
       golden_terrain_track.npz with the JAX run's draw (`raw`) and result;
       launches A 2, B 2, C 1, E 1, F 2, D 0, keypoint counts equal, pose
       finite, the good matches equal.  On this pair several candidates tie
       at the best score (every good match an inlier) and the first wins,
       which rests on float32 rounding (ROADMAP Queue 5, "RANSAC ties"), and
       the five-point candidates of an ill-conditioned sample differ between
       the packages.  So each of the fixture's 64 JAX draws is held to the
       JAX run where the answer is defined: the port's best score lies
       within one point (a point at the threshold) of JAX's on every draw,
       and the refits and the pose from JAX's winning hypothesis give JAX's
       result (inliers within 2 %, rotation within 0.1 degree, t's direction
       within 1 degree) on at least WINNER_AGREE draws; the whole
       track_pair, which breaks the tie its own way, must have median
       inliers over the draws within 2 % of JAX's;
     - `ba`: bench.py's 8-camera x 512-point problem (io.synth.ba_problem):
       one lm_step at lambda = 1e-3 against golden_ba_step.npz at 1e-5 on
       the state and 1e-4 relative on the cost, run_lm for 10 iterations at
       1e-4;
     - `vo`: SlamPipeline over the 12-frame terrain orbit at 200x280 (the
       JAX package's own VO run), plain, with ba_refine=True and with
       window_ba=4, each at the seeds 0-7 of golden_terrain_vo.npz on the
       JAX pipeline's own draws (its key stream, stored there), beside the
       JAX runs.  About one draw in 30 lets a degenerate five-point
       candidate win a pair, in either package; on the same draws the two
       mostly track the same pairs.  Each run: at least VO_AGREE of the
       draws within 2 % of JAX's inliers, at most VO_FAIL_RATE of the frames
       at <= 60 inliers, a median ATE at most VO_ATE_FACTOR x JAX's; the
       plain median ATE < 0.06 and the windowed one below the plain x 1.15.
       Trajectories finite.  Launches G 1 a frame, A 1, B 1, F 1 on each of
       the first two (from the third the pipeline's Surf replays its CUDA
       graph of A to B) and C 1, E 1 a frame after the first;
       `frontend.graph_counts` reads that Surf's eager call at the first
       frame, its capture at the second and one replay at each later one;
  6. drives the SLAM backend, each phase with its launches counted:
     - `posegraph`: the SE(3) circle graph of tests/test_posegraph.py at
       n = 64 (8 loops, dense path) and n = 600 (30 loops, CG path) and
       their Sim(3) counterparts (golden_posegraph.npz): `optimize` held to
       the JAX result and cost curve (PG_TOL), a second run equal bit for
       bit, no kernel launched;
     - `cli`: `python -m cuda_surf_tpu_torch.demo --iters 3` and
       `python -m cuda_surf_tpu_torch.slam.demo --posegraph`, each a
       process of its own, must exit 0; the frame loader's path (native or
       Python) on PGM files;
     - `loops`: SlamPipeline(loop_detect=True, loop_min_gap=6) over the VO
       cell's 12 frames at seeds 0-7 on the JAX pipeline's key stream and
       the JAX detector's draw of every pair (golden_terrain_loops.npz):
       launches and Surf calls as `vo`'s, C and E 1 a tracked pair plus 1 a
       verification; the verified pairs JAX's; the verdicts JAX's wherever
       JAX's inliers lie more than 10 % from 60; optimize_with_loops[_sim3]
       on JAX's own frames, closures and depths at PG_TOL; per run the JAX
       test's ATE bounds (SE(3) < max(1.5 x VO, 0.08), Sim(3) < max(3 x VO,
       0.12)) and the median SE(3) ATE <= 1.5 x JAX's; a run stopped after
       6 frames through run_sequence's checkpoint_dir and resumed equals the
       continuous run bit for bit;
  7. drives the multi-device layer (`multidevice`, after `loops`): a world
     of one over NCCL in this process (initialize_from_env from the SURF_*
     contract, the group destroyed after), where the mesh BatchSurf of the
     batch path's 8 frames and its match equal the single-device BatchSurf
     and match_keypoints, the distributed LM (bench.py's 8 x 512, 10
     iterations) equals run_lm and optimize_distributed (the n = 600 SE(3)
     CG graph, 2 steps) equals optimize(solver="cg"), all bit for bit, with
     launches A 1, stacked B 1, C 1, F 1 (BatchSurf describes a rank's
     frames in one stacked call); then a world of two, this script started
     twice with `--multidevice-rank` on cuda:0 over gloo (NCCL refuses two
     ranks on one card), each rank with launches A 1, stacked B 1, C 1, F 1:
     the batch equal to the single-device one exactly, the BA and the graph
     within MD_TOL of the world of one, the replicated outputs bit-equal
     across the ranks, every rank done within MD_RANK_TIMEOUT or all are
     killed; and `dryrun_multichip(1, full_res=True)`;
  8. checks the reference stereo pair too, when the environment variable
     SURF_REFERENCE_DATA names the directory that holds it.

Every failure raises, and the exit code is then non-zero.  With no CUDA
device it exits with code 2 before printing any result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from cuda_surf_tpu_torch import (BatchSurf, Intrinsics, SlamPipeline, Surf,
                                 SurfConfig, _build, detect_and_compute,
                                 detect_and_compute_batch, frontend,
                                 match_keypoints, track_pair)
from cuda_surf_tpu_torch.ba import core as ba_core
from cuda_surf_tpu_torch.ba import distributed as ba_distributed
from cuda_surf_tpu_torch.config import (BATCH_FRAMES, DOUBLED_CONFIG,
                                        DOUBLED_ROTATED_CONFIG, MAIN_CONFIG,
                                        ROTATED_CONFIG, VO_CONFIG, VO_SEEDS)
from cuda_surf_tpu_torch.io import (MAIN_PAIR, TERRAIN_TRACK, TERRAIN_VO,
                                    main_batch, native, read_pgm,
                                    render_plane_sequence,
                                    render_terrain_sequence, write_pgm)
from cuda_surf_tpu_torch.io.synth import ba_problem
from cuda_surf_tpu_torch.geometry import epipolar
from cuda_surf_tpu_torch.geometry.fivepoint import (_five_point_plain,
                                                  five_point)
from cuda_surf_tpu_torch.slam import (LoopClosure, ate_rmse,
                                      optimize_with_loops,
                                      optimize_with_loops_sim3, posegraph,
                                      run_sequence, sim3graph)
from cuda_surf_tpu_torch.slam.tracking import track_inputs
from cuda_surf_tpu_torch.ops import patch_wavelets
from cuda_surf_tpu_torch.parallel import global_mesh, initialize_from_env
from cuda_surf_tpu_torch.parallel.mesh import all_gather_rows
from cuda_surf_tpu_torch.ops.descriptor import (desc_geometry, describe_plain,
                                                l2_normalize)
from cuda_surf_tpu_torch.ops.extrema import (_candidate_mask, _detect_plain,
                                             detect)
from cuda_surf_tpu_torch.ops.fused_detect import fused_pyramid
from cuda_surf_tpu_torch.ops.hessian import response_pyramid
from cuda_surf_tpu_torch.ops.integral import _integral_plain, integral_image
from cuda_surf_tpu_torch.ops.matcher_kernel import _best2_plain, fused_best2
from cuda_surf_tpu_torch.ops.orientation import (assign_orientations,
                                                 assign_orientations_plain,
                                                 orientation_windows,
                                                 top2_windows)
from cuda_surf_tpu_torch.ops.patch_wavelets import (descriptor_rows,
                                                    single_rows, stacked_rows,
                                                    step_rows,
                                                    step_rows_plain)
from cuda_surf_tpu_torch.types import Keypoints

# Directory of the reference demo's stereo pair (left.pgm, right.pgm); the
# pair is checked only when this names a directory that holds both.
REFERENCE_DATA = os.environ.get("SURF_REFERENCE_DATA", "")
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "cuda_surf_tpu_torch", "data")
GOLDEN = {"main": "golden_plane_pair.npz",
          "rotated": "golden_plane_pair_rotated.npz",
          "doubled": "golden_plane_pair_doubled.npz",
          "doubled_rotated": "golden_plane_pair_doubled_rotated.npz",
          "batch": "golden_plane_batch.npz",
          "track": "golden_terrain_track.npz",
          "ba": "golden_ba_step.npz",
          "vo": "golden_terrain_vo.npz"}
GAP = 1e-5       # top-two orientation window gap below which either wins
STEP_SDS = (4, 5, 6, 7, 8)
TRACK_THRESH = 2e-5   # track_pair's inlier threshold (squared Sampson)
# Over the track fixture's 64 JAX draws: the draws on which the refits and
# the pose from JAX's winner must give JAX's result (where the cheirality
# test ties, the first of the four poses wins, and their order is the SVD's
# sign convention), and the distance at unit norm within which a port
# candidate counts as JAX's winner (a reading, not a check).
WINNER_AGREE = 60
WINNER_DIST = 1e-3
# The VO cell against the JAX runs on the same draws: the least share of
# draws within 2 % of JAX's inliers; the most frames at <= 60 inliers, as
# 1.5 x the JAX package's rate a draw on the cell's pairs (11 of 352,
# tests/vo_draw_rates.py); and the most its median ATE may be over JAX's.
VO_AGREE = 0.85
VO_FAIL_RATE = 1.5 * 11 / 352
VO_ATE_FACTOR = 1.5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def environment() -> dict:
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    try:
        import triton
        tri = triton.__version__
    except ImportError as e:       # reported, not needed: no Triton kernel
        tri = f"not importable ({e})"
    env = dict(phase="environment", card=card_line(),
               torch=torch.__version__, torch_cuda=torch.version.cuda,
               nvcc=nvcc.stdout.strip().splitlines()[-1], triton=tri,
               python=sys.version.split()[0])
    emit(env)
    return env


def circ_diff(a, b):
    """|a - b| on the circle, in radians."""
    return (torch.remainder(a - b + math.pi, 2 * math.pi) - math.pi).abs()


def check_kernel_a(cfg, frames_dev, tag="main"):
    """Kernel A vs hessian.response_pyramid + extrema._candidate_mask."""
    h, w = frames_dev[0].shape
    scheds = cfg.hessian_schedule(h, w)
    n_cand, err = 0, 0.0
    for img in frames_dev:
        ii = integral_image(img, cfg.doubled)
        pyr_k, masks_k = fused_pyramid(ii, cfg, h, w)
        pyr_p = response_pyramid(ii, cfg, h, w)
        for o in range(cfg.noctaves):
            mask_p = _candidate_mask(pyr_p[o], scheds[o], cfg)
            err = max(err, (pyr_k[o] - pyr_p[o]).abs().max().item())
            if not torch.equal(pyr_k[o], pyr_p[o]):
                raise AssertionError(f"kernel A octave {o}: layers differ "
                                     f"from the twin (max |d| {err})")
            if not torch.equal(masks_k[o], mask_p):
                raise AssertionError(f"kernel A octave {o}: masks differ")
            n_cand += int(mask_p.sum())
    if n_cand == 0:
        raise AssertionError("kernel A: the frames produced no candidates")
    emit(dict(phase="kernel_check", kernel="A", config=tag,
              layers_bit_exact=True, masks_equal=True, max_abs_err=err,
              candidates=n_cand, octaves=cfg.noctaves))


def check_kernel_a_stack(cfg, frames_dev):
    """Kernel A on the (B, ih, iw) stack of the frames' integral images, one
    launch: every frame's layers bit-exact to the twin and to the per-frame
    call, masks equal to both."""
    h, w = frames_dev[0].shape
    scheds = cfg.hessian_schedule(h, w)
    ii = integral_image(torch.stack(frames_dev), cfg.doubled)
    before = _build.launch_counts["surf_pyramid"]
    pyr_b, masks_b = fused_pyramid(ii, cfg, h, w)
    if _build.launch_counts["surf_pyramid"] != before + 1:
        raise AssertionError("kernel A on a stack: not one launch")
    for f in range(len(frames_dev)):
        pyr_1, masks_1 = fused_pyramid(ii[f], cfg, h, w)
        pyr_p = response_pyramid(ii[f], cfg, h, w)
        for o in range(cfg.noctaves):
            mask_p = _candidate_mask(pyr_p[o], scheds[o], cfg)
            if not (torch.equal(pyr_b[o][f], pyr_p[o])
                    and torch.equal(pyr_b[o][f], pyr_1[o])):
                raise AssertionError(f"kernel A on a stack: frame {f} octave "
                                     f"{o}: layers differ")
            if not (torch.equal(masks_b[o][f], mask_p)
                    and torch.equal(masks_b[o][f], masks_1[o])):
                raise AssertionError(f"kernel A on a stack: frame {f} octave "
                                     f"{o}: masks differ")
    emit(dict(phase="kernel_check", kernel="A_stack", frames=len(frames_dev),
              layers_bit_exact=True, masks_equal=True,
              equals_per_frame_call=True, launches=1))


def path_keypoints(frames_dev, cfg):
    """Per frame: (integral image, keypoints, kernel D's orientations) at
    the rotated config `cfg`; detection is the same in every mode."""
    out = []
    for img in frames_dev:
        kp, _ = detect_and_compute(img, cfg, compute_descriptors=False)
        ii = integral_image(img, cfg.doubled)
        ori = assign_orientations(ii, cfg, kp.x, kp.y, kp.scale, kp.valid)
        out.append((ii, kp, ori))
    return out


def check_kernel_d(cfg, kps_dev, tag="main"):
    """Kernel D vs orientation.assign_orientations_plain on the frames'
    keypoints (the kernel takes the disc's geometry from x, y, scale itself,
    the twin from orient_geometry): 1e-4 rad where the gap is >= GAP, one of
    the two top windows below it, bit-identical across two launches."""
    worst, worst_near, n_near, n = 0.0, 0.0, 0, 0
    for ii, kp, ori in kps_dev:
        args = (kp.x, kp.y, kp.scale, kp.valid)
        bits = lambda a: a.view(torch.int32)
        if not torch.equal(bits(ori),
                           bits(assign_orientations(ii, cfg, *args))):
            raise AssertionError("kernel D: two launches differ")
        plain = assign_orientations_plain(ii, cfg, *args)
        if not torch.all(ori[~kp.valid] == 0):
            raise AssertionError("kernel D: an invalid slot is nonzero")
        # a keypoint with no sample inside the frame is 0/0 in both
        if not torch.equal(ori.isnan(), plain.isnan()):
            raise AssertionError("kernel D: nan where the twin has none")
        gap, cand = top2_windows(*orientation_windows(ii, *args,
                                                      doubled=cfg.doubled))
        near = kp.valid & (gap < GAP)
        clear = kp.valid & ~near & ~ori.isnan()
        worst = max(worst, circ_diff(ori, plain)[clear].max().item())
        alt = torch.minimum(circ_diff(ori, cand[:, 0]),
                            circ_diff(ori, cand[:, 1]))[near]
        worst_near = max(worst_near, alt.max().item() if alt.numel() else 0.0)
        n_near += int(near.sum())
        n += int(kp.valid.sum())
    if worst > 1e-4 or worst_near > 1e-4:
        raise AssertionError(f"kernel D: |d ori| {worst} (near ties "
                             f"{worst_near}) > 1e-4 rad")
    emit(dict(phase="kernel_check", kernel="D", config=tag, keypoints=n,
              max_abs_err=worst, near_ties=n_near,
              near_tie_max_err=worst_near, bit_identical=True))


B_MODES = {"upright64": dict(upright=True, extended=False),
           "rotated64": dict(upright=False, extended=False),
           "upright128": dict(upright=True, extended=True),
           "rotated128": dict(upright=False, extended=True)}


def rows_against_twin(name, rows_k, rows_p, valid):
    """-> (min row cosine, max |d|, live rows); raises below 0.99999 or on
    a nonzero invalid row."""
    if not torch.all(rows_k[~valid] == 0):
        raise AssertionError(f"{name}: an invalid slot has a nonzero row")
    nz = (rows_k.abs().sum(1) > 0) | (rows_p.abs().sum(1) > 0)
    if not nz.any():
        raise AssertionError(f"{name}: no keypoint to describe")
    cos = torch.nn.functional.cosine_similarity(
        rows_k[nz].double(), rows_p[nz].double(), dim=1, eps=1e-30)
    if cos.min().item() < 0.99999:
        raise AssertionError(f"{name}: row cosine {cos.min().item()} "
                             "< 0.99999")
    return (cos.min().item(), (rows_k - rows_p).abs().max().item(),
            int(nz.sum()))


def check_kernel_b(config, kps_dev, mode_names, tag="main"):
    """Kernel B vs descriptor.describe_plain in the given modes, on the
    frames' keypoints (rotated modes at kernel D's orientations).
    -> the last mode's normalised rows of every frame."""
    for mode in mode_names:
        cfg = SurfConfig(**dict(config, **B_MODES[mode]))
        worst_cos, worst_err, n_rows, normed = 1.0, 0.0, 0, []
        for ii, kp, ori in kps_dev:
            geom = desc_geometry(cfg, kp.x, kp.y, kp.scale, ori)
            rows_k = descriptor_rows(ii, cfg, *geom, kp.valid)
            rows_p = describe_plain(ii, cfg, *geom, kp.valid)
            if rows_k.shape != (kp.capacity, cfg.nfeatures):
                raise AssertionError(f"kernel B {mode}: rows {rows_k.shape}")
            if not torch.equal(rows_k, descriptor_rows(ii, cfg, *geom,
                                                       kp.valid)):
                raise AssertionError(f"kernel B {mode}: two launches differ")
            cos, err, n = rows_against_twin(f"kernel B {mode}", rows_k,
                                            rows_p, kp.valid)
            worst_cos, worst_err = min(worst_cos, cos), max(worst_err, err)
            n_rows += n
            normed.append(l2_normalize(rows_k))
        emit(dict(phase="kernel_check", kernel="B", config=tag, mode=mode,
                  rows=n_rows, min_cosine=worst_cos, max_abs_err=worst_err,
                  bit_identical=True))
    return normed


def check_kernel_b_stacked(frames_dev):
    """Kernel B on the 8 stacked frames' 32768 slots, upright and rotated
    64-d: against the twin with the frame offset, bit for bit against the
    single-frame kernel's rows of each frame, bit-identical across two
    launches, and zero rows for frames outside the stack."""
    B = len(frames_dev)
    cfg_rot = SurfConfig(**ROTATED_CONFIG)
    kb, _ = detect_and_compute_batch(torch.stack(frames_dev),
                                     SurfConfig(**MAIN_CONFIG),
                                     compute_descriptors=False)
    ii = integral_image(torch.stack(frames_dev))
    flat = lambda a: a.reshape(-1)
    valid = flat(kb.valid)
    P = kb.capacity
    frame = torch.arange(B, dtype=torch.int32,
                         device=ii.device).repeat_interleave(P)
    ori = assign_orientations(ii, cfg_rot, flat(kb.x), flat(kb.y),
                              flat(kb.scale), valid, frame=frame)
    for mode in ("upright64", "rotated64"):
        cfg = SurfConfig(**dict(MAIN_CONFIG, **B_MODES[mode]))
        geom = desc_geometry(cfg, flat(kb.x), flat(kb.y), flat(kb.scale),
                             ori)
        rows = stacked_rows(ii, cfg, *geom, valid, frame=frame)
        if rows.shape != (B * P, cfg.nfeatures):
            raise AssertionError(f"stacked B {mode}: rows {rows.shape}")
        if not torch.equal(rows, stacked_rows(ii, cfg, *geom, valid,
                                              frame=frame)):
            raise AssertionError(f"stacked B {mode}: two launches differ")
        twin = describe_plain(ii, cfg, *geom, valid, frame=frame)
        cos, err, n = rows_against_twin(f"stacked B {mode}", rows, twin,
                                        valid)
        for f in range(B):
            sl = slice(f * P, (f + 1) * P)
            own = single_rows(ii[f], cfg, *[g if g is None else g[sl]
                                            for g in geom], valid[sl])
            if not torch.equal(rows[sl], own):
                raise AssertionError(f"stacked B {mode}: frame {f}'s rows "
                                     "differ from the single-frame kernel's")
        # frames outside [0, B) are never read: zero rows, no fault
        bad = frame.clone()
        bad[:P], bad[P:2 * P] = -1, B
        out = stacked_rows(ii, cfg, *geom, valid, frame=bad)
        torch.cuda.synchronize()
        if out[:2 * P].any() or not torch.equal(out[2 * P:], rows[2 * P:]):
            raise AssertionError(f"stacked B {mode}: a frame index outside "
                                 "the stack was not masked")
        emit(dict(phase="kernel_check", kernel="B_stacked", mode=mode,
                  frames=B, slots=B * P, rows=n, min_cosine=cos,
                  max_abs_err=err, bit_identical=True,
                  equals_single_frame_rows=True))


def check_kernel_b_step(kps_dev):
    """The static-step kernel at steps 4..8, cap 512, upright and rotated
    64-d, on the pair's keypoints: taken equal to the twin's, rows against
    the twin and equal bit for bit to kernel B's, untaken rows zero,
    bit-identical across launches; a cap below the eligible count takes
    the first `cap` in order and leaves the rest; the whole route
    (DEC_STEPS set) returns kernel B's rows exactly."""
    worst_cos, worst_err, taken_by_step, overflowed = 1.0, 0.0, {}, 0
    for mode in ("upright64", "rotated64"):
        cfg = SurfConfig(**dict(MAIN_CONFIG, **B_MODES[mode]))
        for ii, kp, ori in kps_dev:
            geom = desc_geometry(cfg, kp.x, kp.y, kp.scale, ori)
            v = kp.valid
            ref = single_rows(ii, cfg, *geom, v)
            for sd in STEP_SDS:
                name = f"step kernel {mode} SD={sd}"
                rows, taken = step_rows(ii, cfg, *geom, v, elig=v, sd=sd)
                rows_p, taken_p = step_rows_plain(ii, cfg, *geom, v, elig=v,
                                                  sd=sd)
                if not torch.equal(taken, taken_p):
                    raise AssertionError(f"{name}: taken differs from the "
                                         "twin's")
                if not torch.equal(rows[taken], ref[taken]) or \
                        rows[~taken].any():
                    raise AssertionError(f"{name}: rows differ from kernel "
                                         "B's, or an untaken row is nonzero")
                if not torch.equal(rows, step_rows(ii, cfg, *geom, v, elig=v,
                                                   sd=sd)[0]):
                    raise AssertionError(f"{name}: two launches differ")
                if taken.any():
                    cos, err, _ = rows_against_twin(name, rows, rows_p, taken)
                    worst_cos = min(worst_cos, cos)
                    worst_err = max(worst_err, err)
                taken_by_step[sd] = taken_by_step.get(sd, 0) + int(taken.sum())
                want = v & (geom[2] == sd)
                if int(want.sum()) > 4:     # overflow: a cap below the count
                    cap = int(want.sum()) // 2
                    rows_c, taken_c = step_rows(ii, cfg, *geom, v, elig=v,
                                                sd=sd, cap=cap)
                    first = torch.nonzero(want)[:cap, 0]
                    if int(taken_c.sum()) != cap or \
                            not taken_c[first].all() or \
                            not torch.equal(rows_c[first], ref[first]) or \
                            rows_c[~taken_c].any():
                        raise AssertionError(f"{name}: cap {cap} did not "
                                             "take the first in order")
                    overflowed += 1
            patch_wavelets.DEC_STEPS = STEP_SDS
            try:
                routed = descriptor_rows(ii, cfg, *geom, v)
            finally:
                patch_wavelets.DEC_STEPS = ()
            if not torch.equal(routed, ref):
                raise AssertionError(f"step route {mode}: routed rows differ "
                                     "from kernel B's")
    if not taken_by_step or max(taken_by_step.values()) == 0 or \
            not overflowed:
        raise AssertionError("step kernel: the pair has no keypoint of "
                             f"steps {STEP_SDS}, or too few to overflow a cap")
    emit(dict(phase="kernel_check", kernel="B_step", steps=list(STEP_SDS),
              cap=patch_wavelets.STEP_CAP, taken_by_step=taken_by_step,
              min_cosine=worst_cos, max_abs_err=worst_err,
              equals_kernel_b_rows=True, bit_identical=True,
              overflow_left_untaken=True, overflow_cases=overflowed))


def f_inputs(cfg, frames):
    """Kernel A's layers and masks of a (H, W) frame or a (B, H, W) stack,
    the schedule and B: what `detect` takes."""
    h, w = frames.shape[-2:]
    pyr, masks = fused_pyramid(integral_image(frames, cfg.doubled), cfg, h, w)
    return (pyr, masks, cfg.hessian_schedule(h, w),
            frames.shape[0] if frames.ndim == 3 else 1)


def check_kernel_f(cases, card):
    """Kernel F vs the twin `_detect_plain` on the card, every output field
    and both counts bit for bit (floats as their bits), one launch a call;
    each case (name, config, frame or stack) with whether the step-1
    movers overflowed the max(cap // 8, 64) walker set."""
    rows = {}
    for name, cfg, frames in cases:
        pyr, masks, sched, B = f_inputs(cfg, frames)
        before = _build.launch_counts["surf_extrema"]
        got = detect(pyr, sched, cfg, masks, nframes=B)
        if _build.launch_counts["surf_extrema"] != before + 1:
            raise AssertionError(f"kernel F {name}: not one launch a call")
        twin = _detect_plain(pyr, sched, cfg, masks, nframes=B)
        for k, want in twin.items():
            a, b = got[k], want
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                raise AssertionError(f"kernel F {name}: {k} differs from the "
                                     "twin")
        walker_set = max(cfg.max_candidates * B // 8, 64)
        rows[name] = dict(frames=B, count=int(got["count"]),
                          walkers=int(got["walkers"]), walker_set=walker_set,
                          overflow=int(got["walkers"]) > walker_set)
    emit(dict(phase="kernel_check", kernel="F", bit_equal=True, cases=rows,
              card=card))


def check_kernel_g(cases, card):
    """Kernel G vs the twin `_integral_plain` on the card, bit for bit, one
    library call a call (`surf_integral`, doubled `surf_integral_doubled`)
    and no other; each case (name, frame or stack, doubled)."""
    rows = {}
    for name, frames, doubled in cases:
        before = _build.launch_counts.copy()
        got = integral_image(frames, doubled)
        entry = KERNELS["G_doubled" if doubled else "G"]
        if _build.launch_counts - before != {entry: 1}:
            raise AssertionError(f"kernel G {name}: not one {entry} call")
        if not torch.equal(got, _integral_plain(frames, doubled)):
            raise AssertionError(f"kernel G {name}: differs from the twin")
        rows[name] = dict(shape=list(frames.shape), doubled=doubled,
                          out=list(got.shape), last=int(got[..., -1, -1].max()))
    emit(dict(phase="kernel_check", kernel="G", bit_equal=True, cases=rows,
              card=card))


def c_against_twin(name, out, twin):
    """-> (max |d score|, rows whose index was held); raises above 1e-5 or
    on an index that differs where best - second >= 1e-5."""
    (bk, sk, ik), (bp, sp, ip) = out, twin
    err = max((bk - bp).abs().max().item(), (sk - sp).abs().max().item())
    if err > 1e-5:
        raise AssertionError(f"{name}: |d score| {err} > 1e-5")
    clear = (bp - sp) >= 1e-5
    if not torch.equal(ik[clear], ip[clear]):
        raise AssertionError(f"{name}: index differs where best - second "
                             ">= 1e-5")
    return err, int(clear.sum())


def check_kernel_e(card):
    """Kernel E vs the twin on the 64 JAX draws of the track fixture (128
    hypotheses a call, gn_iters=4, as track_pair calls it): the share of
    candidates equal bit for bit, `valid` equal, the largest distance up to
    sign."""
    g = np.load(os.path.join(DATA, GOLDEN["track"]))
    intr = Intrinsics(*(float(v) for v in g["intrinsics"]))
    surf = Surf(SurfConfig(**MAIN_CONFIG), device="cuda")
    (k1, d1), (k2, d2) = [surf.detect_and_compute(f) for f in g["frames"]]
    _, good, x1, x2 = track_inputs(k1, d1, k2, d2, intr)
    samples = [epipolar.sample_rows(good, torch.as_tensor(r).cuda())
               for r in g["raws"]]
    exact = valid_eq = n = 0
    err = 0.0
    for sample in samples:
        (Ek, vk), (Ep, vp) = (fn(x1[sample], x2[sample], gn_iters=4)
                              for fn in (five_point, _five_point_plain))
        both = vk & vp
        exact += int(((Ek == Ep).all(-1).all(-1) & both).sum())
        valid_eq += int((vk == vp).sum())
        n += int(both.sum())
        dist = torch.minimum((Ek - Ep).flatten(-2).norm(dim=-1),
                             (Ek + Ep).flatten(-2).norm(dim=-1))
        err = max(err, float(torch.where(both, dist, 0.0).max()))
    slots = len(samples) * samples[0].shape[0] * 20
    if valid_eq != slots or err > 1e-4:
        raise AssertionError(f"kernel E: valid equal on {valid_eq} of "
                             f"{slots} slots, distance up to {err}")
    emit(dict(phase="kernel_check", kernel="E", draws=len(samples),
              hypotheses=int(samples[0].shape[0]), valid_candidates=n,
              bit_equal=exact, valid_equal_slots=valid_eq, max_abs_err=err,
              card=card))


def check_kernel_c(d1, d2, valid2):
    """Kernel C vs matcher_kernel._best2_plain at 4096 x 4096 x D."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the twin's matmul must run in full float32")
    err, n_clear = c_against_twin("kernel C", fused_best2(d1, d2, valid2),
                                  _best2_plain(d1, d2, valid2))
    emit(dict(phase="kernel_check", kernel="C", max_abs_err=err,
              rows=int(d1.shape[0]), depth=int(d1.shape[1]),
              index_checked=n_clear))


def check_kernel_c_pairs(d1, d2, valid2):
    """Kernel C on P pairs in one launch, (P, 4096, 64) x (P, 4096, 64):
    against the twin, and equal bit for bit to P launches of one pair."""
    P = d1.shape[0]
    before = _build.launch_counts["surf_best2"]
    out = fused_best2(d1, d2, valid2)
    if _build.launch_counts["surf_best2"] != before + 1:
        raise AssertionError("kernel C on pairs: not one launch")
    err, _ = c_against_twin(f"kernel C, {P} pairs", out,
                            _best2_plain(d1, d2, valid2))
    for p in range(P):
        single = fused_best2(d1[p], d2[p], valid2[p])
        if not all(torch.equal(a[p], b) for a, b in zip(out, single)):
            raise AssertionError(f"kernel C: pair {p} of {P} in one launch "
                                 "differs from its own launch")
    emit(dict(phase="kernel_check", kernel="C_pairs", pairs=P,
              equals_single_launches=True, launches=1, max_abs_err=err))


def check_keypoints_against_golden(f, kp, golden):
    """One frame's valid keypoints against the fixture's frame f."""
    n = int(kp.count)
    if n != int(golden["counts"][f]):
        raise AssertionError(f"frame {f}: {n} keypoints, JAX golden "
                             f"{int(golden['counts'][f])}")
    if not 0 < n < kp.capacity:
        raise AssertionError(f"frame {f}: {n} keypoints fills or empties "
                             "the buffer")
    v = kp.valid
    for name in ("x", "y", "scale"):
        a = getattr(kp, name)[v].cpu().numpy()
        b = golden[f"{name}{f}"]
        # 1e-4, widened by a few float32 ulps: at x >= 1024 one ulp is
        # 1.2e-4, and the JAX CPU reference contracts FMAs in its fit
        if not np.allclose(a, b, rtol=2e-7, atol=1e-4):
            raise AssertionError(f"frame {f}: {name} differs from the JAX "
                                 f"golden by {np.abs(a - b).max()}")
    if f"laplace{f}" in golden and not np.array_equal(
            kp.laplace[v].cpu().numpy(), golden[f"laplace{f}"]):
        raise AssertionError(f"frame {f}: Laplacian signs differ from the "
                             "JAX golden")
    if f"ori{f}" in golden:
        # the test_reference_oracle.py bar; a near tie may take either
        # of its two top windows
        ori = kp.ori[v].cpu()
        d = circ_diff(ori, torch.as_tensor(golden[f"ori{f}"]))
        top = torch.as_tensor(golden[f"top{f}"])
        alt = torch.minimum(circ_diff(ori, top[:, 0]),
                            circ_diff(ori, top[:, 1]))
        d = torch.where(torch.as_tensor(golden[f"gap{f}"] >= GAP), d, alt)
        if d.max().item() > 1e-3:
            raise AssertionError(f"frame {f}: orientation differs from "
                                 f"the JAX golden by {d.max()}")


def check_mean_best(score, valid, want, what):
    mean_best = score[valid].mean().item()
    if abs(mean_best - float(want)) > 2e-4:
        raise AssertionError(f"{what}: mean best score {mean_best} vs JAX "
                             f"golden {float(want)}")
    return mean_best


def load_golden(name, config):
    path = os.path.join(DATA, GOLDEN[name])
    golden = np.load(path)
    if str(golden["config"]) != repr(sorted(config.items())) or \
            str(golden["pair"]) != repr(sorted(MAIN_PAIR.items())):
        raise AssertionError(f"{path} is for another config or pair; rerun "
                             "tests/make_torch_golden.py")
    return golden


# each kernel's entry point in `_build.launch_counts`
KERNELS = {"A": "surf_pyramid", "B": "surf_describe",
           "B_stacked": "surf_describe_stacked", "B_step": "surf_describe_step",
           "C": "surf_best2", "D": "surf_orient", "E": "surf_fivepoint",
           "F": "surf_extrema", "G": "surf_integral",
           "G_doubled": "surf_integral_doubled"}


def launches_since(snap) -> dict:
    """Each kernel's launches since `snap`, a `_build.launch_counts.copy()`."""
    return {k: _build.launch_counts[e] - snap[e] for k, e in KERNELS.items()}


def frame_launches(i, **more):
    """Frame i's launches in a SlamPipeline, beside `more`: its Surf runs
    the frontend eagerly at the first frame and captures it at the second
    (G, A, F, B each once), and from the third runs G and replays the
    graph of the rest, which launches nothing through `_build.launch`."""
    return dict(G=1, **(dict(A=1, B=1, F=1) if i < 2 else {}), **more)


def check_calls(name, calls, frames):
    """`calls`, a difference of `frontend.graph_counts` over the first
    `frames` frames of a SlamPipeline, must be its Surf's: the eager
    pipeline at frame 0, the capture at frame 1, a replay at each later
    one, so that frames 2 on ran the graph whose A, F and B launches were
    counted at the capture."""
    want = {("frame", what): n for what, n in
            (("eager", min(frames, 1)), ("capture", min(frames - 1, 1)),
             ("replay", frames - 2)) if n > 0}
    if dict(calls) != want:
        raise AssertionError(f"{name}: Surf calls {dict(calls)}, "
                             f"expected {want}")


def read_counts(name, expected, snap):
    """The launch counts since `snap`, held to `expected` by
    check_launches."""
    torch.cuda.synchronize()
    counts = launches_since(snap)
    check_launches(name, counts, expected)
    return counts


def check_launches(name, counts, expected):
    """Every kernel in `expected` must have launched (exactly that often
    where a number is given) and no other kernel at all."""
    for k, n in expected.items():
        if counts[k] == 0 or (n is not None and counts[k] != n):
            raise AssertionError(f"{name} path: kernel {k} launched "
                                 f"{counts[k]} times, expected "
                                 f"{'some' if n is None else n}")
    stray = [k for k in KERNELS if k not in expected and counts[k]]
    if stray:
        raise AssertionError(f"kernels {stray} launched on the {name} path, "
                             "which does not run them")


def check_descriptors(name, kp, d, cfg):
    if d.shape != (cfg.max_pts, cfg.nfeatures) or not torch.isfinite(d).all():
        raise AssertionError(f"{name}: descriptors malformed")
    norms = d[kp.valid].norm(dim=1)
    if not torch.allclose(norms, torch.ones_like(norms), atol=1e-5):
        raise AssertionError(f"{name}: valid descriptors are not unit length")
    if not torch.all(d[~kp.valid] == 0):
        raise AssertionError(f"{name}: invalid descriptor rows are not zero")
    if not torch.isfinite(kp.ori).all() or \
            not torch.all(kp.ori[~kp.valid] == 0):
        raise AssertionError(f"{name}: orientations malformed")


def run_path(name, cfg, frames, golden, expected):
    """Surf on the pair + match, counted; -> (kps, descs).  The path must
    launch each kernel of `expected` and no other."""
    snap = _build.launch_counts.copy()
    surf = Surf(cfg, device="cuda")
    kps, descs = zip(*[surf.detect_and_compute(f) for f in frames])
    m = surf.match(kps[0], descs[0], kps[1], descs[1])
    counts = read_counts(name, expected, snap)
    for f, (kp, d) in enumerate(zip(kps, descs)):
        check_descriptors(name, kp, d, cfg)
        check_keypoints_against_golden(f, kp, golden)
    mean_best = check_mean_best(m.score, m.valid, golden["mean_best"], name)
    emit(dict(phase=f"{name}_path", keypoints=[int(k.count) for k in kps],
              golden_keypoints=golden["counts"].tolist(),
              matches=int(m.valid.sum()), mean_best=mean_best,
              golden_mean_best=float(golden["mean_best"]), launches=counts))
    return kps, descs


def run_batch_path(cfg, frames, golden):
    """Surf.detect_and_compute_batch on the 8 frames + BatchSurf.match of
    frame i -> i + 1, counted: kernel A once and kernel B once for the whole
    batch on the stacked frames, C once per pair, and
    neither the single-frame B, the step kernel nor D.  Held against the
    JAX batch fixture, and frame by frame, exactly, against the port's
    single-frame path (Surf.detect_and_compute a frame) in the same run."""
    B = frames.shape[0]
    if int(golden["n_frames"]) != B:
        raise AssertionError("the batch fixture holds another frame count")
    snap = _build.launch_counts.copy()
    kb, db = Surf(cfg, device="cuda").detect_and_compute_batch(frames)
    bs = BatchSurf(cfg, device="cuda")
    frames_of = lambda k, sl: Keypoints(*[a[sl] for a in k])
    m = bs.match(frames_of(kb, slice(0, B - 1)), db[:-1],
                 frames_of(kb, slice(1, B)), db[1:])
    counts = read_counts("batch", {"A": 1, "B_stacked": 1, "C": 1, "F": 1,
                                   "G": 1}, snap)
    if db.shape != (B, cfg.max_pts, cfg.nfeatures) or \
            kb.count.shape != (B,) or kb.x.shape != (B, cfg.max_pts):
        raise AssertionError("batch: outputs malformed")
    mean_best = []
    for f in range(B):
        kp = frames_of(kb, f)
        check_descriptors(f"batch frame {f}", kp, db[f], cfg)
        check_keypoints_against_golden(f, kp, golden)
        for name in ("x", "y", "scale", "strength", "laplace", "octave"):
            if getattr(kp, name)[~kp.valid].any():
                raise AssertionError(f"batch frame {f}: padding of {name} "
                                     "is not zero")
        if f < B - 1:
            mean_best.append(check_mean_best(
                m.score[f], m.valid[f], golden["mean_best"][f],
                f"batch frames {f} -> {f + 1}"))
    surf = Surf(cfg, device="cuda")
    for f in range(B):
        ks, ds = surf.detect_and_compute(frames[f])
        n = int(ks.count)
        same = n == int(kb.count[f]) and torch.equal(ks.valid, kb.valid[f])
        for name in ("x", "y", "scale", "strength", "laplace", "octave"):
            same = same and torch.equal(getattr(ks, name)[:n],
                                        getattr(kb, name)[f, :n])
        if not same or not torch.equal(ds, db[f]):
            raise AssertionError(f"batch frame {f} differs from the "
                                 "single-frame path: max |d desc| "
                                 f"{(ds - db[f]).abs().max().item()}")
    emit(dict(phase="batch_path", frames=B, keypoints=kb.count.tolist(),
              golden_keypoints=golden["counts"].tolist(),
              mean_best=mean_best,
              golden_mean_best=golden["mean_best"].tolist(),
              equals_single_frame_path=True, launches=counts))
    return kb, db


def run_rotated_batch_path(cfg, frames):
    """Surf.detect_and_compute_batch on the 8 frames at the rotated config,
    counted: kernels G, A, F, D and the stacked B once each for the whole
    batch, and neither the single-frame B nor C.  Each frame's orientations
    held against the twin with the frame index on the stack (as
    check_kernel_d holds a frame's), and every valid slot's keypoint,
    orientation and descriptor equal bit for bit to the port's single-frame
    rotated path; padding slots zero."""
    B = frames.shape[0]
    frames_dev = torch.as_tensor(frames).cuda()
    snap = _build.launch_counts.copy()
    kb, db = Surf(cfg, device="cuda").detect_and_compute_batch(frames_dev)
    counts = read_counts("rotated batch", {"A": 1, "B_stacked": 1, "D": 1,
                                           "F": 1, "G": 1}, snap)
    ii = integral_image(frames_dev)
    flat = lambda a: a.reshape(-1)
    frame = torch.arange(B, dtype=torch.int32,
                         device=ii.device).repeat_interleave(cfg.max_pts)
    twin = assign_orientations_plain(ii, cfg, flat(kb.x), flat(kb.y),
                                     flat(kb.scale), flat(kb.valid), frame)
    gap, cand = top2_windows(*orientation_windows(
        ii, flat(kb.x), flat(kb.y), flat(kb.scale), flat(kb.valid),
        frame=frame))
    v = flat(kb.valid)
    near = v & (gap < GAP)
    ori = flat(kb.ori)
    worst = circ_diff(ori, twin)[v & ~near].max().item()
    alt = torch.minimum(circ_diff(ori, cand[:, 0]),
                        circ_diff(ori, cand[:, 1]))[near]
    worst_near = alt.max().item() if alt.numel() else 0.0
    if worst > 1e-4 or worst_near > 1e-4:
        raise AssertionError(f"rotated batch: |d ori| {worst} against the "
                             f"twin (near ties {worst_near}) > 1e-4 rad")
    surf = Surf(cfg, device="cuda")
    for f in range(B):
        kp = Keypoints(*[a[f] for a in kb])
        check_descriptors(f"rotated batch frame {f}", kp, db[f], cfg)
        ks, ds = surf.detect_and_compute(frames_dev[f])
        vf = kp.valid
        same = torch.equal(ks.valid, vf) and torch.equal(ds[vf], db[f][vf])
        for name in ("x", "y", "scale", "strength", "laplace", "ori",
                     "octave"):
            same = same and torch.equal(getattr(ks, name)[vf],
                                        getattr(kp, name)[vf])
            if getattr(kp, name)[~vf].any():
                raise AssertionError(f"rotated batch frame {f}: padding of "
                                     f"{name} is not zero")
        if not same:
            raise AssertionError(f"rotated batch frame {f} differs from the "
                                 "single-frame rotated path")
    emit(dict(phase="rotated_batch_path", frames=B,
              keypoints=kb.count.tolist(), max_abs_err=worst,
              near_ties=int(near.sum()), near_tie_max_err=worst_near,
              equals_single_frame_path=True, launches=counts))


def run_step_routed_path(cfg, frames, golden, descs_main):
    """The main path with the static-step route switched on, as the JAX
    package's own test switches it: same fixture, and descriptors equal
    to the main path's exactly."""
    patch_wavelets.DEC_STEPS = STEP_SDS
    try:
        _, descs = run_path(
            "step_routed", cfg, frames, golden,
            {"A": 2, "B": 2, "B_step": 2 * len(STEP_SDS), "C": 1, "F": 2,
             "G": 2})
    finally:
        patch_wavelets.DEC_STEPS = ()
    for a, b in zip(descs, descs_main):
        if not torch.equal(a, b):
            raise AssertionError("step-routed descriptors differ from the "
                                 "main path's")


def pose_gap(n, R, t, n_ref, R_ref, t_ref) -> dict:
    """A track result (inliers, R, t) beside a reference one: the angle of
    R R_ref^T and the one between t and t_ref, in degrees."""
    R, R_ref, t, t_ref = (np.asarray(a, np.float64)
                          for a in (R, R_ref, t, t_ref))
    cos_t = t @ t_ref / np.linalg.norm(t) / np.linalg.norm(t_ref)
    return dict(inliers=int(n), rotation_deg=float(np.degrees(np.arccos(
        np.clip((np.trace(R @ R_ref.T) - 1) / 2, -1, 1)))),
        t_direction_deg=float(np.degrees(np.arccos(np.clip(cos_t, -1, 1)))))


def same_track(gap, n_ref) -> bool:
    """Inliers within 2 %, rotation within 0.1 degree, t within 1 degree."""
    return (abs(gap["inliers"] - n_ref) <= 0.02 * n_ref
            and gap["rotation_deg"] <= 0.1 and gap["t_direction_deg"] <= 1.0)


def ransac_beside_jax(x1, x2, good, raw, E_j, win):
    """The port's 5-point RANSAC (ransac_essential's stages) on `raw`
    beside the JAX run's winner E_j, candidate `win` (sample x 20 + slot):
    -> (the port's best score and how many candidates tie at it; the
    distance of the nearest valid candidate of that sample to E_j, both at
    unit norm, up to sign; the inlier count, R and t of the port's refits
    and pose from its own winner, and from E_j)."""
    sample = epipolar.sample_rows(good, raw)
    Es, ok = epipolar.hypotheses(x1, x2, sample, "5pt")
    scores = torch.where(ok, epipolar._sampson_inlier_counts(
        Es, x1, x2, good, TRACK_THRESH), -1)
    slots = slice(win // 20 * 20, win // 20 * 20 + 20)
    unit = lambda E: E / torch.linalg.norm(E, dim=(-2, -1), keepdim=True)
    E_j = torch.as_tensor(E_j).to(Es.device)
    cand, ref = unit(Es[slots]), unit(E_j)
    dist = torch.minimum((cand - ref).flatten(1).norm(dim=1),
                         (cand + ref).flatten(1).norm(dim=1))
    poses = []
    for E0 in (Es[int(torch.argmax(scores))], E_j):
        E, inl = epipolar.refit(E0, x1, x2, good, TRACK_THRESH)
        R, t, _ = epipolar.recover_pose(E, x1, x2, inl)
        poses.append((int(inl.sum()), R.cpu(), t.cpu()))
    best = scores.max()
    return (int(best), int((scores == best).sum()),
            float(torch.where(ok[slots], dist, math.inf).min()), *poses)


def run_track_path():
    """Surf + track_pair on the terrain fixture's pair with the JAX run's
    draw, counted; the 64 JAX draws of the fixture (the first is that
    draw), each through JAX's winner and whole."""
    g = np.load(os.path.join(DATA, GOLDEN["track"]))
    if str(g["config"]) != repr(sorted(MAIN_CONFIG.items())) or \
            str(g["cell"]) != repr(sorted(TERRAIN_TRACK.items())):
        raise AssertionError("the track fixture is for another config or "
                             "cell; rerun tests/make_torch_golden.py track")
    intr = Intrinsics(*(float(v) for v in g["intrinsics"]))
    raw = torch.as_tensor(g["raw"]).cuda()
    surf = Surf(SurfConfig(**MAIN_CONFIG), device="cuda")
    snap = _build.launch_counts.copy()
    (k1, d1), (k2, d2) = [surf.detect_and_compute(f) for f in g["frames"]]
    res = track_pair(k1, d1, k2, d2, intr, raw=raw)
    counts = read_counts("track", {"A": 2, "B": 2, "C": 1, "E": 1, "F": 2,
                                   "G": 2}, snap)
    kp_counts = [int(k1.count), int(k2.count)]
    if kp_counts != g["counts"].tolist():
        raise AssertionError(f"track: keypoints {kp_counts}, JAX golden "
                             f"{g['counts'].tolist()}")
    if not (torch.isfinite(res.R).all() and torch.isfinite(res.t).all()
            and torch.isfinite(res.points3d).all()):
        raise AssertionError("track: non-finite pose or points")
    n_j = int(g["n_inliers"])
    against_jax = lambda n, R, t: pose_gap(n, R.cpu(), t.cpu(), n_j, g["R"],
                                           g["t"])
    whole = against_jax(res.n_inliers, res.R, res.t)
    _, good, x1, x2 = track_inputs(k1, d1, k2, d2, intr)
    n_good = int(good.sum())
    if n_good != int(g["n_good"]):
        raise AssertionError(f"track: {n_good} good matches, JAX "
                             f"{int(g['n_good'])}")
    # the 64 draws of the fixture.  7-20 candidates tie at the best score
    # and the first of them wins, which float32 rounding decides (ROADMAP
    # Queue 3, "RANSAC ties"), and the five-point candidates of an
    # ill-conditioned sample differ between the packages.  So each draw is
    # held to the JAX run where the answer is defined: the port's best
    # score within one point of JAX's (a point at the threshold), and the
    # refits and the pose from JAX's winner give JAX's result.  The port's
    # own result, which breaks the tie its own way, is held to the JAX
    # runs' median inliers.
    sweep, held = [], []
    for r, n, Rk, tk, Ek, wk, bk in zip(
            g["raws"], g["keys_n"], g["keys_R"], g["keys_t"], g["keys_E"],
            g["keys_win"], g["keys_best"]):
        best_k, ties_k, dist, own, from_jax = ransac_beside_jax(
            x1, x2, good, torch.as_tensor(r).cuda(), Ek, int(wk))
        gap, gap_j = pose_gap(*own, n, Rk, tk), pose_gap(*from_jax, n, Rk, tk)
        if not sweep:      # PRNGKey(0), the draw `raw` of the fixture
            best, ties, from_winner = best_k, ties_k, gap_j
            if not same_track(gap_j, n_j):
                raise AssertionError(f"track: the refits from the JAX "
                                     f"winner give {gap_j}, JAX {n_j}")
        sweep.append((same_track(gap, int(n)), gap["inliers"],
                      gap["rotation_deg"]))
        held.append((best_k - int(bk), dist <= WINNER_DIST,
                     same_track(gap_j, int(n))))
    agree = sum(s[0] for s in sweep)
    med_n, med_j = (float(np.median(a)) for a in (
        [s[1] for s in sweep], g["keys_n"]))
    kt = g["keys"]
    draws = dict(draws=len(sweep),
                 best_score_gaps=[h[0] for h in held if h[0]],
                 jax_winner_among_candidates=sum(h[1] for h in held),
                 refits_from_jax_winner_agree=sum(h[2] for h in held),
                 agree=agree, cpu_agree=int((
                     (np.abs(kt[:, 1] - kt[:, 2]) <= 0.02 * kt[:, 1])
                     & (kt[:, 3] <= 0.1) & (kt[:, 4] <= 1.0)).sum()),
                 median_inliers=med_n, jax_median_inliers=med_j,
                 below_150=sum(s[1] < 150 for s in sweep),
                 jax_below_150=int((g["keys_n"] < 150).sum()),
                 rotation_gap_deg_quartiles=np.percentile(
                     [s[2] for s in sweep], [25, 50, 75]).tolist())
    emit(dict(phase="track_path", keypoints=kp_counts, good_matches=n_good,
              golden_inliers=n_j, track_pair=whole, best_score=best,
              golden_best_score=int(g["best_score"]), ties_at_best=ties,
              golden_ties_at_best=int(g["ties"]),
              refits_from_jax_winner=from_winner, jax_draws=draws,
              launches=counts))
    if max(abs(h[0]) for h in held) > 1 or \
            draws["refits_from_jax_winner_agree"] < WINNER_AGREE or \
            abs(med_n - med_j) > 0.02 * med_j:
        raise AssertionError(f"track: over the JAX draws {draws}")


def run_ba_phase():
    """One lm_step and run_lm on bench.py's BA problem against the JAX
    fixture."""
    g = np.load(os.path.join(DATA, GOLDEN["ba"]))
    (ci, uv, mask), (R, t, X) = ba_problem()
    prob = ba_core.problem_from_numpy(ci, uv, mask, "cuda")
    state = ba_core.state_from_numpy(R, t, X, "cuda")
    C, lam = R.shape[0], float(g["lam"])
    step = ba_core.lm_step(state, prob, lam, C)
    worst = 0.0
    for name, a in zip(("R", "t", "points"), step):
        ref = g[name]
        err = float(np.abs(a.cpu().numpy() - ref).max())
        worst = max(worst, err / max(float(np.abs(ref).max()), 1e-30))
        if not np.allclose(a.cpu().numpy(), ref, rtol=1e-5,
                           atol=1e-5 * float(np.abs(ref).max())):
            raise AssertionError(f"ba: lm_step's {name} off the JAX golden "
                                 f"by {err}")
    costs = dict(cost0=float(ba_core.cost(state, prob)),
                 cost1=float(ba_core.cost(step, prob)),
                 cost_lm10=float(ba_core.run_lm(state, prob, n_iters=10)[1]))
    for k, v in costs.items():
        if abs(v - float(g[k])) > 1e-4 * abs(float(g[k])):
            raise AssertionError(f"ba: {k} {v}, JAX golden {float(g[k])}")
    emit(dict(phase="ba", cameras=C, points=int(X.shape[0]),
              max_rel_err_state=worst, **costs,
              golden={k: float(g[k]) for k in costs}))


def vo_summary(ates, inliers, jax_ates, jax_inliers):
    """One run's per-seed ATEs and (seeds, frames) inliers beside the JAX
    runs' on the same draws -> the share of the draws (frames after the
    first) whose inlier count lies within 2 % of JAX's, the frames at <= 60
    inliers (a pair tracked on a degenerate candidate) in both, and the
    median ATE over the seeds in both."""
    inl = np.asarray(inliers)[:, 1:]
    jax_inl = np.asarray(jax_inliers)[:, 1:]
    return dict(agree=float((np.abs(inl - jax_inl) <= 0.02 * jax_inl).mean()),
                failed_frames=int((inl <= 60).sum()),
                jax_failed_frames=int((jax_inl <= 60).sum()),
                frames=int(inl.size),
                median_ate=float(np.median(ates)),
                jax_median_ate=float(np.median(jax_ates)),
                ate=[float(a) for a in ates],
                jax_ate=[float(a) for a in jax_ates],
                min_inliers=inl.min(1).tolist())


def run_vo_path():
    """SlamPipeline over the 12-frame terrain orbit, plain, ba_refine and
    window_ba=4, each at the JAX fixture's seeds on the JAX pipeline's own
    draws (its key stream, `raws`) and each run counted, beside the JAX
    runs of golden_terrain_vo.npz."""
    g = np.load(os.path.join(DATA, GOLDEN["vo"]))
    frames, centres, intr = render_terrain_sequence(**TERRAIN_VO)
    if hashlib.sha256(frames.tobytes()).hexdigest() != \
            str(g["frames_sha256"]) or g["seeds"].tolist() != list(VO_SEEDS):
        raise AssertionError("vo: the fixture is for other frames or seeds; "
                             "rerun tests/make_torch_golden.py vo")
    raws = torch.as_tensor(g["raws"]).cuda()
    runs, counts = {}, None
    for run, kw in (("plain", {}), ("ba_refine", dict(ba_refine=True)),
                    ("window_ba", dict(window_ba=4))):
        ates, inliers = [], []
        for seed, seed_raws in zip(VO_SEEDS, raws):
            pipe = SlamPipeline(SurfConfig(**VO_CONFIG), intrinsics=intr,
                                seed=seed, device="cuda", **kw)
            snap = _build.launch_counts.copy()
            calls = frontend.graph_counts.copy()
            for i, f in enumerate(frames):
                before = _build.launch_counts.copy()
                pipe.process(f, raw=seed_raws[i - 1] if i else None)
                torch.cuda.synchronize()
                check_launches(f"vo {run} seed {seed} frame {i}",
                               launches_since(before),
                               frame_launches(i, **({"C": 1, "E": 1}
                                                    if i else {})))
                check_calls(f"vo {run} seed {seed} frame {i}",
                            frontend.graph_counts - calls, i + 1)
            total = read_counts(f"vo {run}", {"A": 2, "B": 2,
                                              "C": len(frames) - 1,
                                              "E": len(frames) - 1,
                                              "F": 2,
                                              "G": len(frames)}, snap)
            counts = counts or total
            traj = pipe.trajectory()
            if not np.isfinite(traj).all():
                raise AssertionError(f"vo {run} seed {seed}: non-finite "
                                     "trajectory")
            ates.append(ate_rmse(traj, centres))
            inliers.append([fs.n_inliers for fs in pipe.frames])
        r = runs[run] = vo_summary(ates, inliers, g[f"ate_{run}"],
                                   g[f"inliers_{run}"])
        if r["agree"] < VO_AGREE or \
                r["failed_frames"] > VO_FAIL_RATE * r["frames"] or \
                r["median_ate"] > VO_ATE_FACTOR * r["jax_median_ate"]:
            raise AssertionError(f"vo {run}: against the JAX runs on the same "
                                 f"draws {r}")
    plain = runs["plain"]["median_ate"]
    if plain >= 0.06:
        raise AssertionError(f"vo: median ATE {plain} (plain), limit 0.06")
    if runs["window_ba"]["median_ate"] >= 1.15 * plain:
        raise AssertionError("vo: windowed BA's median ATE "
                             f"{runs['window_ba']['median_ate']} >= "
                             "plain x 1.15")
    emit(dict(phase="vo_path", frames=len(frames), seeds=list(VO_SEEDS),
              runs=runs, launches_per_frame=dict(
                  first={"A": 1, "B": 1, "F": 1, "G": 1},
                  after={"A": 1, "B": 1, "C": 1, "E": 1, "F": 1, "G": 1}),
              launches=counts))


# The pose graphs against golden_posegraph.npz (the JAX optimize on the
# CPU): R within 1e-4, t within 5e-5 x max |t|, s within 1e-5, each step's
# cost within 1 % + 1e-6 x the first (the last steps sit at the rounding
# floor); the CG path's rounds differ by a few where float32 rounding moves
# the stop test.
PG_TOL = dict(R=1e-4, t=5e-5, s=1e-5, cost_rtol=1e-2, cost_floor=1e-6)
PG_CASES = ("se3_64", "se3_600", "sim3_64", "sim3_600")


def posegraph_case(g, case):
    """-> (module, graph on the card, solver, n_iters) of one fixture case."""
    meta = ast.literal_eval(str(g[f"{case}_meta"]))
    mod = sim3graph if case.startswith("sim3") else posegraph
    fields = mod.Sim3Graph._fields if mod is sim3graph \
        else mod.PoseGraph._fields
    src = SimpleNamespace(**{k: g[f"{case}_in_{k}"] for k in fields})
    return mod, mod.graph_from_numpy(src, "cuda"), meta["solver"], \
        meta["n_iters"]


def run_posegraph_phase():
    """The SE(3) and Sim(3) graphs of golden_posegraph.npz on the card:
    each optimised twice (the same bits: no float atomics) and held to the
    JAX result and cost curve.  No kernel runs here."""
    g = np.load(os.path.join(DATA, "golden_posegraph.npz"))
    snap = _build.launch_counts.copy()
    cases = {}
    for case in PG_CASES:
        mod, graph, solver, n_iters = posegraph_case(g, case)
        runs = []
        for _ in range(2):
            stats = {}
            out, costs = mod.optimize(graph, n_iters=n_iters, solver=solver,
                                      stats=stats)
            torch.cuda.synchronize()
            runs.append((out, costs, stats))
        (out, costs, stats), (out2, costs2, _) = runs
        same = all(torch.equal(a, b) for a, b in zip(out, out2)) and \
            torch.equal(costs, costs2)
        if not same:
            raise AssertionError(f"posegraph {case}: a second run on the "
                                 "card gave other bits")
        err = {}
        for k in ("s", "R", "t") if mod is sim3graph else ("R", "t"):
            want = g[f"{case}_{k}"]
            err[k] = float(np.abs(getattr(out, k).cpu().numpy() - want).max())
            tol = PG_TOL[k] * (float(np.abs(want).max()) if k == "t" else 1)
            if not err[k] <= tol:
                raise AssertionError(f"posegraph {case}: {k} off JAX's by "
                                     f"{err[k]} > {tol}")
        cj = g[f"{case}_costs"]
        cp = costs.cpu().numpy()
        if not np.all(np.abs(cp - cj) <= PG_TOL["cost_rtol"] * np.abs(cj)
                      + PG_TOL["cost_floor"] * cj[0]):
            raise AssertionError(f"posegraph {case}: costs {cp.tolist()}, "
                                 f"JAX {cj.tolist()}")
        cases[case] = dict(
            nodes=int(graph.R.shape[0]), edges=int(graph.edge_i.shape[0]),
            solver=solver, n_iters=n_iters, max_abs_err=err,
            costs=cp.tolist(), jax_costs=cj.tolist(), second_run_equal=same,
            cg_rounds=stats.get("cg_rounds"),
            jax_cg_rounds=(g[f"rounds_{case}"].tolist()
                           if solver == "cg" else None),
            host_reads=stats.get("host_reads"))
    counts = read_counts("posegraph", {}, snap)
    emit(dict(phase="posegraph", cases=cases, tolerances=PG_TOL,
              launches=counts))


LOOP_MIN_INLIERS = 60      # LoopDetector's default, as the pipeline uses it


def loop_graph_inputs(g, k):
    """JAX's frames, closures and frame depths of the fixture's k-th seed."""
    seed = int(g["seeds"][k])
    frames = [SimpleNamespace(R=R, t=t)
              for R, t in zip(g["frame_R"][k], g["frame_t"][k])]
    sel = g["loop_meta"][:, 0] == seed
    loops = [LoopClosure(i=int(i), j=int(j), R=R, t=t, n_inliers=int(n),
                         med_depth=float(d), med_depth_j=float(dj))
             for (_, i, j, n), R, t, d, dj in zip(
                 g["loop_meta"][sel], g["loop_R"][sel], g["loop_t"][sel],
                 g["loop_depth"][sel], g["loop_depth_j"][sel])]
    return frames, loops, list(g["frame_depths"][k])


def check_graphs_on_jax_inputs(g, k):
    """optimize_with_loops and optimize_with_loops_sim3 on the card, fed
    with the JAX run's own frames, closures and depths, against the JAX
    outputs (tolerances PG_TOL; the cost within 1 % + 1e-9)."""
    frames, loops, depths = loop_graph_inputs(g, k)
    R, t, c = optimize_with_loops(frames, loops, frame_depths=depths,
                                  device="cuda")
    s3, R3, t3, _, c3 = optimize_with_loops_sim3(
        frames, loops, depths, min_gap=int(g["min_gap"]), device="cuda")
    got = dict(se3_R=R, se3_t=t, se3_cost=c, sim3_s=s3, sim3_R=R3,
               sim3_t=t3, sim3_cost=c3)
    err = {}
    for name, a in got.items():
        want = g[name][k]
        err[name] = float(np.abs(np.asarray(a) - want).max())
        kind = name.split("_")[1]
        tol = (PG_TOL["cost_rtol"] * float(want) + 1e-9 if kind == "cost"
               else PG_TOL[kind] * (float(np.abs(want).max())
                                    if kind == "t" else 1))
        if not err[name] <= tol:
            raise AssertionError(f"loops seed {int(g['seeds'][k])}: {name} "
                                 f"on JAX's inputs off by {err[name]} > {tol}")
    return err


def run_loops_phase():
    """SlamPipeline(loop_detect=True, loop_min_gap=6) over the VO cell's
    12 frames at the loops fixture's seeds, on the JAX pipeline's key
    stream and the JAX detector's draw of every pair, counted frame by
    frame; the graphs on JAX's own inputs; the ATE bounds; then a run on
    the port's own generator stopped after 6 frames through run_sequence's
    checkpoint_dir and resumed, against the same run done in one go."""
    g = np.load(os.path.join(DATA, "golden_terrain_loops.npz"))
    vo = np.load(os.path.join(DATA, GOLDEN["vo"]))
    frames, centres, intr = render_terrain_sequence(**TERRAIN_VO)
    if hashlib.sha256(frames.tobytes()).hexdigest() != \
            str(g["frames_sha256"]) or str(g["config"]) != \
            repr(sorted(VO_CONFIG.items())):
        raise AssertionError("loops: the fixture is for other frames or "
                             "another config; rerun "
                             "tests/make_torch_golden.py loops")
    gap = int(g["min_gap"])
    pair_raws = {(int(i), int(j)): torch.as_tensor(r).cuda()
                 for (i, j), r in zip(g["loop_pairs"], g["loop_raws"])}
    loop_raws = [{i: r for (i, j), r in pair_raws.items() if j == k}
                 for k in range(len(frames))]
    seeds = [int(s) for s in g["seeds"]]
    vo_seeds = vo["seeds"].tolist()
    rows, counts = [], None
    for k, seed in enumerate(seeds):
        raws = torch.as_tensor(vo["raws"][vo_seeds.index(seed)]).cuda()
        pipe = SlamPipeline(SurfConfig(**VO_CONFIG), intrinsics=intr,
                            seed=seed, loop_detect=True, loop_min_gap=gap,
                            device="cuda")
        snap = _build.launch_counts.copy()
        calls = frontend.graph_counts.copy()
        for f, img in enumerate(frames):
            before = _build.launch_counts.copy()
            n_ver = pipe._detector.n_verifications if f else 0
            pipe.process(img, raw=raws[f - 1] if f else None,
                         loop_raws=loop_raws[f])
            torch.cuda.synchronize()
            n_ver = pipe._detector.n_verifications - n_ver
            pairs = 1 + n_ver      # the tracked pair and each verification
            check_launches(f"loops seed {seed} frame {f}",
                           launches_since(before),
                           frame_launches(f, **({"C": pairs, "E": pairs}
                                                if f else {})))
            check_calls(f"loops seed {seed} frame {f}",
                        frontend.graph_counts - calls, f + 1)
        det = pipe._detector
        total = read_counts(f"loops seed {seed}", {
            "A": 2, "B": 2, "F": 2, "G": len(frames),
            "C": len(frames) - 1 + det.n_verifications,
            "E": len(frames) - 1 + det.n_verifications}, snap)
        counts = counts or total
        jver = [tuple(int(x) for x in v[1:]) for v in g["ver"]
                if v[0] == seed]
        if [v[:2] for v in det.verified] != [v[:2] for v in jver]:
            raise AssertionError(f"loops seed {seed}: verified pairs "
                                 f"{det.verified}, JAX {jver}")
        clear = lambda n: abs(n - LOOP_MIN_INLIERS) > 0.1 * LOOP_MIN_INLIERS
        flips = [(v, w) for v, w in zip(det.verified, jver) if clear(w[2])
                 and (v[2] >= LOOP_MIN_INLIERS) != (w[2] >= LOOP_MIN_INLIERS)]
        if flips:
            raise AssertionError(f"loops seed {seed}: verdicts differ from "
                                 f"JAX's on {flips}")
        traj = pipe.trajectory()
        if not np.isfinite(traj).all():
            raise AssertionError(f"loops seed {seed}: non-finite trajectory")
        ate_vo = ate_rmse(traj, centres)
        vo_frames = [dataclasses.replace(fs) for fs in pipe.frames]
        c_se3 = pipe.optimize_posegraph()
        ate_se3 = ate_rmse(pipe.trajectory(), centres)
        pipe.frames = [dataclasses.replace(fs) for fs in vo_frames]
        c_sim3 = pipe.optimize_sim3()
        ate_sim3 = ate_rmse(pipe.trajectory(), centres)
        if not (np.isfinite(c_se3) and np.isfinite(c_sim3)):
            raise AssertionError(f"loops seed {seed}: non-finite graph cost")
        if not ate_se3 < max(1.5 * ate_vo, 0.08) or \
                not ate_sim3 < max(3.0 * ate_vo, 0.12):
            raise AssertionError(f"loops seed {seed}: ATE VO {ate_vo}, SE3 "
                                 f"{ate_se3}, Sim3 {ate_sim3}")
        rows.append(dict(
            seed=seed, verifications=len(det.verified),
            inliers=[v[2] for v in det.verified],
            jax_inliers=[v[2] for v in jver],
            loops=[(lc.i, lc.j, lc.n_inliers) for lc in pipe.loops],
            ate_vo=ate_vo, ate_se3=ate_se3, ate_sim3=ate_sim3,
            jax_ate_vo=float(g["ate_vo"][k]),
            jax_ate_se3=float(g["ate_se3"][k]),
            jax_ate_sim3=float(g["ate_sim3"][k]),
            graphs_on_jax_inputs_err=check_graphs_on_jax_inputs(g, k)))
    ates = ("ate_vo", "ate_se3", "ate_sim3")
    med = {m: float(np.median([r[m] for r in rows])) for m in ates}
    jmed = {m: float(np.median(g[m])) for m in ates}
    # seeds 0-3 alone, for the record: two of the four lose pair 4 -> 5 to
    # a match at the ratio test's threshold in one package and not the
    # other (ROADMAP Queue 3), so four seeds do not settle a median
    med4 = {m: float(np.median([r[m] for r in rows[:4]])) for m in ates}
    jmed4 = {m: float(np.median(g[m][:4])) for m in ates}
    if med["ate_se3"] > 1.5 * jmed["ate_se3"]:
        raise AssertionError(f"loops: median SE3 ATE {med['ate_se3']} > "
                             f"1.5 x JAX's {jmed['ate_se3']}")
    resume = run_loop_resume(frames, intr, gap)
    emit(dict(phase="loops", frames=len(frames), seeds=seeds, min_gap=gap,
              runs=rows, median=med, jax_median=jmed,
              median_seeds_0_3=med4, jax_median_seeds_0_3=jmed4,
              resume=resume,
              launches_per_frame=dict(
                  first={"A": 1, "B": 1, "F": 1, "G": 1},
                  after={"A": 1, "B": 1, "F": 1, "G": 1,
                         "C": "1 + the frame's verifications",
                         "E": "1 + the frame's verifications"}),
              launches=counts))


def _loop_state(pipe):
    return (pipe.trajectory().tobytes(), list(pipe.frame_depths),
            [(lc.i, lc.j, lc.n_inliers, lc.R.tobytes(), lc.t.tobytes(),
              lc.med_depth, lc.med_depth_j) for lc in pipe.loops])


def run_loop_resume(frames, intr, gap, cut=6):
    """The loop-detecting pipeline on the port's own generator (seed 0),
    once in one go and once stopped after `cut` frames through
    run_sequence's checkpoint_dir and resumed in a fresh pipeline: the
    trajectory, loops and frame depths must be equal bit for bit."""
    make = lambda: SlamPipeline(SurfConfig(**VO_CONFIG), intrinsics=intr,
                                loop_detect=True, loop_min_gap=gap,
                                device="cuda")
    whole = make()
    run_sequence(whole, frames)
    with tempfile.TemporaryDirectory() as d:
        run_sequence(make(), frames[:cut], checkpoint_dir=d,
                     checkpoint_every=3)
        resumed = make()
        run_sequence(resumed, frames, checkpoint_dir=d, checkpoint_every=3)
        saved = sorted(os.listdir(d))
    if _loop_state(resumed) != _loop_state(whole):
        raise AssertionError("loops: the resumed run differs from the "
                             "continuous one")
    return dict(cut=cut, checkpoints=saved, loops=len(whole.loops),
                verifications=whole._detector.n_verifications,
                equal_bit_for_bit=True)


def run_cli_phase(card):
    """The two demo CLIs as users start them, each a process of its own on
    the card; and the image loader's path (native or Python) on PGM files."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, cmd in (
                ("demo", ["-m", "cuda_surf_tpu_torch.demo", "--iters", "3",
                          "--out-dir", d]),
                ("slam_demo", ["-m", "cuda_surf_tpu_torch.slam.demo",
                               "--posegraph"])):
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, *cmd], cwd=root,
                               capture_output=True, text=True, timeout=300)
            out[name] = dict(rc=p.returncode, seconds=time.perf_counter() - t0,
                             tail=p.stdout.strip().splitlines()[-4:])
            if p.returncode != 0:
                raise AssertionError(f"cli {name}: exit {p.returncode}\n"
                                     f"{p.stdout[-2000:]}{p.stderr[-2000:]}")
        seq = render_plane_sequence(n_frames=3, h=96, w=128, seed=2)[0]
        paths = []
        for k, img in enumerate(seq):
            paths.append(os.path.join(d, f"f{k}.pgm"))
            write_pgm(paths[-1], img)
        with native.FrameLoader(paths, depth=2) as fl:
            loader = fl.path
            if any(not np.array_equal(a, b) for a, b in zip(fl, seq)):
                raise AssertionError(f"cli: the {loader} loader read other "
                                     "pixels")
    emit(dict(phase="cli", runs=out, loader=loader,
              native_library=native.available(), card=card))


# --------------------------------------------------------- multidevice phase
MD_RANKS = 2
MD_RANK_TIMEOUT = 300      # seconds for both ranks, start-up included
MD_BA_ITERS = 10
MD_PG_STEPS = 2
# the world of two against the world of one: sums over two ranks round in
# another order (tests/test_ba.py and tests/test_posegraph.py hold JAX's
# distributed paths at 1e-2 / 1e-3).  On the card the BA's t reads 7.9e-5
# and the graph's 5.5e-5 (the CPU: 2.3e-4 and 5.1e-4; the BA's gauge fixes
# camera 0 alone, so the scale of the camera line drifts with the rounding,
# and the graph's CG runs 353 and 1299 rounds), both within 1e-4; the
# graph's costs read 1.26e-4 relative (the second step's cost, 0.029: 3e-7
# of the first), so they are held at the JAX test's 1e-3
MD_TOL = dict(ba_cost_rtol=1e-4, ba_t=1e-4, pg_t=1e-4, pg_cost_rtol=1e-3)
MD_LAUNCHES = {"A": 1, "B_stacked": 1, "C": 1, "F": 1, "G": 1}  # a rank's


def md_inputs(frames):
    """The phase's inputs, the same in every process: the batch path's 8
    frames, bench.py's BA problem on the card, and the n = 600 SE(3) CG
    graph of the posegraph phase."""
    (ci, uv, mask), (R, t, X) = ba_problem()
    prob = ba_core.problem_from_numpy(ci, uv, mask, "cuda")
    state = ba_core.state_from_numpy(R, t, X, "cuda")
    g = np.load(os.path.join(DATA, "golden_posegraph.npz"))
    _, graph, solver, _ = posegraph_case(g, "se3_600")
    if solver != "cg":
        raise AssertionError("multidevice: se3_600 is not the CG case")
    return SimpleNamespace(frames=frames, prob=prob, state=state,
                           graph=graph, cfg=SurfConfig(**MAIN_CONFIG))


def md_run(mesh, inp):
    """The three workloads on `mesh`, each rank on its own share: the mesh
    BatchSurf of the 8 frames and its match of frame i -> i + 1, the
    distributed LM (MD_BA_ITERS iterations) and optimize_distributed
    (MD_PG_STEPS steps).  -> every output on the host (the rank's points
    all-gathered)."""
    bs = BatchSurf(inp.cfg, device="cuda", mesh=mesh)
    kps, descs = bs.detect_and_compute(inp.frames)
    sub = lambda sl: Keypoints(*[f[sl] for f in kps])
    m = bs.match(sub(slice(0, -1)), descs[:-1], sub(slice(1, None)),
                 descs[1:])
    sprob, sstate = ba_distributed.shard_problem(inp.prob, inp.state, mesh)
    ba, ba_cost = ba_distributed.make_distributed_lm(
        mesh, inp.state.R.shape[0], n_iters=MD_BA_ITERS)(sstate, sprob)
    stats = {}
    pg, pg_costs = posegraph.optimize_distributed(
        inp.graph, mesh, n_iters=MD_PG_STEPS, stats=stats)
    out = {f"kp_{k}": v for k, v in kps._asdict().items()}
    out.update(descs=descs, match_score=m.score, match_index=m.index,
               ba_R=ba.R, ba_t=ba.t,
               ba_points=all_gather_rows(ba.points, mesh), ba_cost=ba_cost,
               pg_R=pg.R, pg_t=pg.t, pg_costs=pg_costs)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["pg_rounds"] = np.asarray(stats["cg_rounds"])
    return out


def md_world(mesh, inp, name):
    """md_run counted (held to MD_LAUNCHES).  -> (outputs, counts)."""
    snap = _build.launch_counts.copy()
    out = md_run(mesh, inp)
    return out, read_counts(name, MD_LAUNCHES, snap)


def multidevice_rank(out_dir) -> int:
    """One rank of the phase's world of two, started by
    run_multidevice_phase with the SURF_* variables set: both ranks on
    cuda:0 over gloo (NCCL refuses two ranks on one card).  Writes its
    outputs to out_dir/rank<r>.npz and prints its launches as one JSON
    line."""
    initialize_from_env(timeout_s=MD_RANK_TIMEOUT, backend="gloo",
                        device="cuda:0")
    mesh = global_mesh()
    inp = md_inputs(np.load(os.path.join(out_dir, "frames.npy")))
    out, counts = md_world(mesh, inp, f"multidevice rank {mesh.rank}")
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    emit(dict(multidevice_rank=mesh.rank, backend=mesh.backend,
              device=str(mesh.device), launches=counts))
    torch.distributed.destroy_process_group()
    return 0


def md_compare(name, got, want, keys):
    for k in keys:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"multidevice {name}: {k} differs")


def run_multidevice_phase(card):
    """The multi-device layer on the one card.  World of one: NCCL in this
    process (initialize_from_env from the SURF_* contract, the group
    destroyed after); the mesh batch equal to the single-device BatchSurf,
    the distributed LM to run_lm and optimize_distributed to
    optimize(solver="cg"), all bit for bit; launches A 1, stacked B 1, C 1,
    F 1.
    World of two: two processes of this script on cuda:0 over gloo, each
    with its launches A 1, stacked B 1, C 1, F 1; the batch equal to the
    single-device one, the BA and graph within MD_TOL of the world of one,
    the replicated outputs bit-equal across the ranks."""
    from cuda_surf_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                     free_port, launch)
    frames = main_batch(BATCH_FRAMES)
    inp = md_inputs(frames)
    ks, ds = BatchSurf(inp.cfg, device="cuda").detect_and_compute(frames)
    sub = lambda sl: Keypoints(*[f[sl] for f in ks])
    ms = match_keypoints(sub(slice(0, -1)), ds[:-1], sub(slice(1, None)),
                         ds[1:])
    ba, ba_cost = ba_core.run_lm(inp.state, inp.prob, n_iters=MD_BA_ITERS)
    pg_stats = {}
    pg, pg_costs = posegraph.optimize(inp.graph, n_iters=MD_PG_STEPS,
                                      solver="cg", stats=pg_stats)
    single = {f"kp_{k}": v for k, v in ks._asdict().items()}
    single.update(descs=ds, match_score=ms.score, match_index=ms.index,
                  ba_R=ba.R, ba_t=ba.t, ba_points=ba.points, ba_cost=ba_cost,
                  pg_R=pg.R, pg_t=pg.t, pg_costs=pg_costs)
    single = {k: v.cpu().numpy() for k, v in single.items()}
    single["pg_rounds"] = np.asarray(pg_stats["cg_rounds"])
    batch_keys = [k for k in single if k.startswith(("kp_", "descs",
                                                     "match_"))]

    env = dict(SURF_COORDINATOR=f"127.0.0.1:{free_port()}",
               SURF_NUM_PROCESSES="1", SURF_PROCESS_ID="0")
    os.environ.update(env)
    try:
        initialize_from_env(backend="nccl", device="cuda:0")
        mesh = global_mesh()
        if (mesh.size, mesh.backend) != (1, "nccl"):
            raise AssertionError(f"multidevice: world of one is {mesh}")
        out1, counts = md_world(mesh, inp, "multidevice")
        full_res = dryrun_multichip(1, full_res=True)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k in env:
            del os.environ[k]
    md_compare("world of one", out1, single, list(single))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "frames.npy"), frames)
        logs = launch(MD_RANKS, [os.path.abspath(__file__),
                                 "--multidevice-rank", d], MD_RANK_TIMEOUT)
        ranks = [dict(np.load(os.path.join(d, f"rank{r}.npz")))
                 for r in range(MD_RANKS)]
    start_s = time.perf_counter() - t0
    lines = [json.loads(next(ln for ln in log.splitlines()
                             if ln.startswith('{"multidevice_rank"')))
             for log in logs]
    for r, res in enumerate(ranks):
        md_compare(f"rank {r} against the single-device batch", res, single,
                   batch_keys)
        md_compare(f"rank {r} against rank 0", res, ranks[0], list(res))
    got = ranks[0]
    err = dict(
        ba_cost_rel=abs(float(got["ba_cost"]) - float(single["ba_cost"]))
        / float(single["ba_cost"]),
        ba_t=float(np.abs(got["ba_t"] - single["ba_t"]).max()),
        pg_t=float(np.abs(got["pg_t"] - single["pg_t"]).max()),
        pg_cost_rel=float((np.abs(got["pg_costs"] - single["pg_costs"])
                           / single["pg_costs"]).max()))
    bad = [f"{k} {v} > {MD_TOL[k.replace('_rel', '_rtol')]}"
           for k, v in err.items()
           if not v <= MD_TOL[k.replace("_rel", "_rtol")]]
    emit(dict(phase="multidevice", world1=dict(
        backend="nccl", launches=counts, equal_bit_for_bit=True,
        ba_cost=float(single["ba_cost"]), pg_costs=single[
            "pg_costs"].tolist(), pg_rounds=single["pg_rounds"].tolist()),
        world2=dict(backend=lines[0]["backend"],
                    devices=[ln["device"] for ln in lines],
                    launches=[ln["launches"] for ln in lines],
                    batch_equal_single_device=True,
                    ranks_bit_equal=True, err=err, tolerances=MD_TOL,
                    pg_rounds=got["pg_rounds"].tolist(),
                    seconds=start_s), card=card))
    if bad:
        raise AssertionError("multidevice world of two: " + "; ".join(bad))
    if not full_res["ba_cost"] < full_res["ba_cost0"]:
        raise AssertionError(f"multidevice full-res dry run: {full_res}")
    emit(dict(phase="multidevice_dryrun_full_res", **full_res))


def reference_pair(cfg):
    left = os.path.join(REFERENCE_DATA, "left.pgm")
    right = os.path.join(REFERENCE_DATA, "right.pgm")
    if not (REFERENCE_DATA and os.path.exists(left)
            and os.path.exists(right)):
        emit(dict(phase="reference_pair", present=False,
                  note="SURF_REFERENCE_DATA does not name a directory "
                  "holding left.pgm and right.pgm"))
        return
    surf = Surf(cfg, device="cuda")
    (k1, d1), (k2, d2) = [surf.detect_and_compute(read_pgm(p))
                          for p in (left, right)]
    m = surf.match(k1, d1, k2, d2)
    counts = [int(k1.count), int(k2.count)]
    mean_best = m.score[m.valid].mean().item()
    if counts != [2739, 3443] or abs(mean_best - 0.96497) > 2e-4:
        raise AssertionError(f"reference pair: {counts}, mean best "
                             f"{mean_best}; expected [2739, 3443], 0.96497")
    emit(dict(phase="reference_pair", present=True, keypoints=counts,
              mean_best=mean_best))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    card = environment()["card"]

    t0 = time.perf_counter()
    kl = _build.kernels()
    ptxas = [ln.strip() for ln in kl.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=kl.build_seconds, ptxas=ptxas))
    configs = dict(main=MAIN_CONFIG, rotated=ROTATED_CONFIG,
                   doubled=DOUBLED_CONFIG,
                   doubled_rotated=DOUBLED_ROTATED_CONFIG)
    cfgs = {k: SurfConfig(**v) for k, v in configs.items()}
    golden = {k: load_golden(k, v) for k, v in configs.items()}
    golden["batch"] = load_golden("batch", MAIN_CONFIG)
    cfg = cfgs["main"]
    batch_frames = main_batch(BATCH_FRAMES)
    frames = batch_frames[:2]                  # the main pair
    batch_dev = [torch.as_tensor(f).cuda() for f in batch_frames]
    frames_dev = batch_dev[:2]

    check_kernel_a(cfg, frames_dev)
    check_kernel_a_stack(cfg, batch_dev)
    kps_dev = path_keypoints(frames_dev, cfgs["rotated"])
    check_kernel_d(cfgs["rotated"], kps_dev)
    rows128 = check_kernel_b(MAIN_CONFIG, kps_dev, list(B_MODES))
    check_kernel_b_step(kps_dev)
    check_kernel_b_stacked(batch_dev)
    # the same kernels at the doubled frame's size, one frame
    check_kernel_a(cfgs["doubled"], frames_dev[:1], "doubled")
    kps_dbl = path_keypoints(frames_dev[:1], cfgs["doubled_rotated"])
    check_kernel_d(cfgs["doubled_rotated"], kps_dbl, "doubled")
    check_kernel_b(DOUBLED_CONFIG, kps_dbl, ["upright64", "rotated64"],
                   "doubled")

    # A and F: one launch a frame
    pair_kernels = {"A": 2, "B": 2, "C": 1, "F": 2, "G": 2}
    kps, descs = run_path("main", cfg, frames, golden["main"], pair_kernels)
    for name in ("rotated", "doubled", "doubled_rotated"):
        expected = dict(pair_kernels, **({} if cfgs[name].upright
                                         else {"D": 2}))
        if cfgs[name].doubled:     # G's doubled passes, its own entry
            expected["G_doubled"] = expected.pop("G")
        run_path(name, cfgs[name], frames, golden[name], expected)
    run_step_routed_path(cfg, frames, golden["main"], descs)
    kb, db = run_batch_path(cfg, batch_frames, golden["batch"])
    run_rotated_batch_path(cfgs["rotated"], batch_frames)

    vo_frame = render_terrain_sequence(n_frames=1, h=480, w=640)[0][0]
    check_kernel_f([
        ("main_left", cfg, frames_dev[0]), ("main_right", cfg, frames_dev[1]),
        ("batch8", cfg, torch.stack(batch_dev)),
        ("vo_640x480", SurfConfig(**VO_CONFIG),
         torch.as_tensor(vo_frame).cuda())], card)
    check_kernel_g([
        ("main_left", frames_dev[0], False),
        ("batch8", torch.stack(batch_dev), False),
        ("vo_640x480", torch.as_tensor(vo_frame).cuda(), False),
        ("doubled", frames_dev[0], True),
        ("doubled_stack32", torch.as_tensor(main_batch(32)).cuda(), True)],
        card)
    check_kernel_c(descs[0], descs[1], kps[1].valid)
    check_kernel_c(rows128[0], rows128[1], kps_dev[1][1].valid)
    check_kernel_c_pairs(db[:-1].contiguous(), db[1:].contiguous(),
                         kb.valid[1:].contiguous())
    check_kernel_e(card)
    run_track_path()
    run_ba_phase()
    run_vo_path()
    run_posegraph_phase()
    run_cli_phase(card)
    run_loops_phase()
    run_multidevice_phase(card)
    reference_pair(cfg)
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multidevice-rank"]:
        sys.exit(multidevice_rank(sys.argv[2]))
    sys.exit(main())
