"""Drive the PyTorch + CUDA port's paths once on one NVIDIA GPU.

The pair paths run the 1280x960 pair cuda_surf_tpu_torch.io.main_pair
through Surf(cfg, device="cuda"): detect + describe on each frame, then left
-> right matching.  The main path is the reference demo's workload, upright
64-d SURF at SurfConfig(noctaves=4, thresh=4.0, upright=True, max_pts=4096,
candidates_per_octave=4096); the rotated path is the same config with
upright=False (orientation, then rotated descriptors), as bench.py times it
for `rotated_pair_ms`; the doubled paths add doubled=True to each (the frame
upsampled 2x: a 2560x1920 integral image); the step-routed path is the main
path with patch_wavelets.DEC_STEPS = (4, 5, 6, 7, 8), which sends the
keypoints of those sampling steps through the static-step kernel.  The batch
path runs Surf.detect_and_compute_batch on the 8 frames of io.main_batch
(frames 0 and 1 are the main pair) at the main config and matches frame i
-> i + 1 with BatchSurf.match.  The script

  1. prints the card (nvidia-smi), CUDA, nvcc and Triton versions;
  2. builds the kernels from cuda_surf_tpu_torch/csrc with nvcc, one
     process per source, in parallel, and prints what ptxas reports and how
     many blocks of kernel A and of the describe kernel fit one SM;
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
     1e-5; C on the batch's 7 pairs
     of consecutive frames in one launch: the same against the twin, and
     equal bit for bit to seven launches of one pair; D: its in-kernel
     geometry's angles those of the twin on orient_geometry, within 1e-4 rad
     wherever the top-two window gap is >= 1e-5 relative, one of the two
     top windows below that; B, D and the step kernel bit-identical across
     two launches; A, D and B again at the doubled frame's size; E, the
     five-point solver, on the 64 JAX draws of golden_terrain_track.npz,
     128 hypotheses a call as track_pair makes it: `valid` equal on every
     slot and every valid candidate within 1e-4 of the twin's, the share
     equal bit for bit reported); F, the compaction and subpixel walk, on
     each frame of the main pair, on the batch's 8 frames in one call and
     on a 640x480 terrain frame at the VO config: every output field and
     the counts bit for bit, one launch count a call, and how many step-1
     movers there were beside the walker set;
  4. for each path, resets the launch counters, runs it, checks that every
     kernel of the path launched (kernel A once per frame on the pair
     paths, once per batch on the batch path) and no other did, and holds
     the keypoints
     and the mean best score against the path's JAX golden fixture
     (cuda_surf_tpu_torch/data/golden_plane_*.npz; the rotated ones also
     hold the orientations, to 1e-3 rad wherever the gap is >= 1e-5 and to
     one of the two top windows below it; the batch one also the Laplacian
     signs and the zero padding).  The batch must also equal the port's own
     single-frame path frame by frame, exactly, and the step-routed path
     the main path's descriptors;
  5. times the pairs, the batch beside the same 8 frames through the
     single-frame path (in turns, on the host clock and with CUDA events,
     with the device operations per frame of both from torch.profiler), the
     match and each kernel beside its twin with CUDA events (10 warm-up
     runs, median of 50; fewer for the slow twins; the event time includes
     the wrapper's eager glue, so the kernel's own device time is taken
     beside it, with events around the library call alone), and computes
     each kernel's bound: the larger of its bytes (inputs read once, outputs
     written once) over the card's memory rate and its operations on this
     run's data over the card's float32 rate (kernel C's three TF32 products
     a score over the card's dense TF32 rate);
  6. drives the visual-odometry paths after the frontend's, each with its
     launch counts reset before and read after it:
     - `track`: Surf + track_pair (5-point RANSAC) on frames 0 and 1 of the
       50-frame terrain orbit at 1280x960, stored in the fixture
       golden_terrain_track.npz with the JAX run's draw (`raw`) and result;
       launches A 2, B 2, C 1, E 1, F 2, D 0, keypoint counts equal, pose
       finite,
       the good matches equal, the best score within 1 %, and the refits
       and the pose from the JAX run's winning hypothesis at inliers within
       2 %, rotation within 0.1 degree, t's direction within 1 degree.  On
       this pair several candidates tie at the best score (every good
       match an inlier) and the first wins, which rests on float32 rounding
       (ROADMAP Queue 3, "RANSAC ties"), and the five-point candidates of an
       ill-conditioned sample differ between the packages.  So each of the
       fixture's 64 JAX draws is held to the JAX run where the answer is
       defined: the port's best score lies within one point (a point at
       the threshold) of JAX's on every draw, and the refits and the pose
       from JAX's winning hypothesis give JAX's result at the tolerances
       above on at least WINNER_AGREE draws; the whole track_pair, which
       breaks the tie its own way, must have median inliers over the draws
       within 2 % of JAX's.
       Then `track_ms`: track_pair alone on the
       card-resident keypoints, drawing from the port's own generator,
       with its device operations and device us;
     - `ba`: bench.py's 8-camera x 512-point problem (io.synth.ba_problem):
       one lm_step at lambda = 1e-3 against golden_ba_step.npz at 1e-5 on
       the state and 1e-4 relative on the cost, run_lm for 10 iterations at
       1e-4; then `ba_step_ms`;
     - `vo`: SlamPipeline over the 12-frame terrain orbit at 200x280 (the
       JAX package's own VO run), plain, with ba_refine=True and with
       window_ba=4, each at the seeds 0-7 of golden_terrain_vo.npz on the
       JAX pipeline's own draws (its key stream, stored there), beside the
       JAX runs.  About one draw in 30 lets a degenerate five-point
       candidate win a pair, in either package; on the same draws the two
       mostly track the same pairs.  Each run: at least VO_AGREE of the
       draws within 2 % of JAX's inliers, at most VO_FAIL_RATE of the frames
       at <= 60 inliers, a median ATE at most VO_ATE_FACTOR x JAX's; the
       plain median ATE < 0.06 and the windowed one below the plain x 1.15.  Trajectories finite.  Launches A 1, B 1, F 1 a frame
       and C 1, E 1 a frame after the first; `vo_frame_ms` on the host
       clock;
  7. drives the SLAM backend, each phase with its launch counts reset
     before and read after it:
     - `posegraph`: the SE(3) circle graph of tests/test_posegraph.py at
       n = 64 (8 loops, dense path) and n = 600 (30 loops, CG path) and
       their Sim(3) counterparts (golden_posegraph.npz): `optimize` held to
       the JAX result and cost curve (PG_TOL), a second run equal bit for
       bit, no kernel launched; `posegraph_iter_ms` (one Gauss-Newton step,
       CUDA events) with its device operations, CG rounds and host reads;
     - `cli`: `python -m cuda_surf_tpu_torch.demo --iters 3` and
       `python -m cuda_surf_tpu_torch.slam.demo --posegraph`, each a
       process of its own, must exit 0; the frame loader's path (native or
       Python) on PGM files;
     - `loops`: SlamPipeline(loop_detect=True, loop_min_gap=6) over the VO
       cell's 12 frames at seeds 0-7 on the JAX pipeline's key stream and
       the JAX detector's draw of every pair (golden_terrain_loops.npz):
       launches A 1, B 1, F 1 a frame, C and E 1 a tracked pair plus 1 a
       verification;
       the verified pairs JAX's; the verdicts JAX's wherever JAX's inliers
       lie more than 10 % from 60; optimize_with_loops[_sim3] on JAX's own
       frames, closures and depths at PG_TOL; per run the JAX test's ATE
       bounds (SE(3) < max(1.5 x VO, 0.08), Sim(3) < max(3 x VO, 0.12)) and
       the median SE(3) ATE <= 1.5 x JAX's; a run stopped after 6 frames
       through run_sequence's checkpoint_dir and resumed equals the
       continuous run bit for bit; `slam_loop_frame_ms`, `loop_query_ms`;
  8. drives the multi-device layer (`multidevice`, after `loops`): a world
     of one over NCCL in this process (initialize_from_env from the SURF_*
     contract, the group destroyed after), where the mesh BatchSurf of the
     batch path's 8 frames and its match equal the single-device BatchSurf
     and match_keypoints, the distributed LM (bench.py's 8 x 512, 10
     iterations) equals run_lm and optimize_distributed (the n = 600 SE(3)
     CG graph, 2 steps) equals optimize(solver="cg"), all bit for bit, with
     launches A 1, stacked B 1, C 1, F 1 (`launches_by_path["multidevice"]`:
     BatchSurf describes a rank's frames in one stacked call); then a
     world of two, this script started twice with `--multidevice-rank` on
     cuda:0 over gloo (NCCL refuses two ranks on one card), each rank with
     launches A 1, stacked B 1, C 1, F 1: the batch equal to the single-device
     one exactly, the BA and the graph within MD_TOL of the world of one, the
     replicated outputs bit-equal across the ranks, every rank done within
     MD_RANK_TIMEOUT or all are killed; `mesh_batch8_ms`,
     `dist_ba_iter_ms` (with the all-reduce's bytes) and
     `dist_posegraph_iter_ms` (with CG rounds and host reads) at worlds 1
     and 2, the all-reduces of both counted in `psum`; at the world of one
     each workload beside its single-device path, like for like, in turns
     (`multidevice_world1_vs_single`), one graph step and one LM
     iteration traced (`multidevice_traces`: the all-reduces' host and
     device time) and
     `dryrun_multichip(1, full_res=True)`;
  9. checks the reference stereo pair too, when the environment variable
     SURF_REFERENCE_DATA names the directory that holds it.

Every failure raises, and the exit code is then non-zero.  With no CUDA
device it exits with code 2 before printing any result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import ast
import ctypes
import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from cuda_surf_tpu_torch import (BatchSurf, Intrinsics, SlamPipeline, Surf,
                                 SurfConfig, _build, detect_and_compute,
                                 detect_and_compute_batch, match_keypoints,
                                 track_pair)
from cuda_surf_tpu_torch.ba import core as ba_core
from cuda_surf_tpu_torch.ba import distributed as ba_distributed
from cuda_surf_tpu_torch.config import (BATCH_FRAMES, DOUBLED_CONFIG,
                                        DOUBLED_ROTATED_CONFIG, MAIN_CONFIG,
                                        ORADIUS, ORADIUS_SQ, ROTATED_CONFIG,
                                        VO_CONFIG, VO_SEEDS)
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
from cuda_surf_tpu_torch.parallel.mesh import (all_gather_rows,
                                                collective_counts, psum)
from cuda_surf_tpu_torch.ops.descriptor import (desc_geometry, describe_plain,
                                                l2_normalize, sample_frame)
from cuda_surf_tpu_torch.ops.extrema import (_candidate_mask, _detect_plain,
                                             detect)
from cuda_surf_tpu_torch.ops.fused_detect import fused_pyramid, pyramid_plan
from cuda_surf_tpu_torch.ops.hessian import response_pyramid
from cuda_surf_tpu_torch.ops.integral import integral_image
from cuda_surf_tpu_torch.ops import matcher_kernel
from cuda_surf_tpu_torch.ops.matcher_kernel import _best2_plain, fused_best2
from cuda_surf_tpu_torch.ops.orientation import (assign_orientations,
                                                 assign_orientations_plain,
                                                 orient_geometry,
                                                 orientation_windows,
                                                 top2_windows)
from cuda_surf_tpu_torch.ops.patch_wavelets import (descriptor_rows,
                                                    single_rows, stacked_rows,
                                                    step_rows,
                                                    step_rows_plain)
from cuda_surf_tpu_torch.types import Keypoints
from probe_stages import device_ops

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
WARMUP, RUNS = 10, 50
SLOW = (1, 3)    # warm-up and timed runs of a twin that takes > 0.1 s
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

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, the float32 rate outside the tensor cores, at which the integer
# and compare operations of these kernels are counted too, and the dense
# TF32 rate of the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# Operations the function needs, as counted from the twins' expressions:
# kernel A per output element (8 box sums of 3 adds, dxx / dyy / dxy 8, the
# determinant 5, the 27-neighbour test 27); kernel B per window sample (the
# geometry and window test) and on top per live sample (weight 5, two Haar
# wavelets 14, scaling 4, cell weights 4, 4 cells x values x 3), rotated 12
# more (the turn of the grid and of the responses); kernel D per live sample
# (wavelets 14, magnitude 8, atan2 20, bin and weight 6, the 5 histogram
# sums) and per keypoint for its 72 windows.
A_OPS = 64
B_OPS_WINDOW = {True: 8, False: 12}
B_OPS_LIVE = {"upright64": 51, "rotated64": 59, "upright128": 75,
              "rotated128": 83}
D_OPS_LIVE, D_OPS_WINDOWS = 53, 72 * 36
# kernel E per hypothesis, counted from the twin's expressions: 20 roots x
# 96 Durand-Kerner rounds of ~150 operations (ten complex differences and
# their product, a Horner chain of ten complex multiply-adds, a complex
# division, the step's clamp), 20 candidates x ~1,100 a Gauss-Newton step
# (80 monomial terms, 40 products of 20, the 3x3 normal equations) and
# ~10,000 for the constraint matrix, the 10x10 solve and det B(z)
E_OPS_DK, E_OPS_GN_STEP, E_OPS_MATRICES = 20 * 96 * 150, 20 * 1100, 10000
# kernel F, counted from the twin's expressions: per mask byte the
# candidate test and its share of the scans, 2; per fit the 19 stencil
# indices (4 each) and clamps (2), the gradient and Hessian (19), the
# pivoted solve (42) and the strength (6), ~140; per slot the fields, 20
F_OPS_BYTE, F_OPS_FIT, F_OPS_SLOT = 2, 140, 20


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


def bound(nbytes: float, ops: float, tf32_ops: float = 0) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate (plus `tf32_ops` over the tensor
    cores' TF32 rate), whichever is larger."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = (ops / FP32_OPS_PER_S + tf32_ops / TF32_OPS_PER_S) * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                bound_bytes=int(nbytes), bound_ops=int(ops + tf32_ops))


def own_time(fn, bnd: dict) -> dict:
    """The device time of the kernels alone in one call of the wrapper
    `fn` (CUDA events around the library call, without the wrapper's eager
    glue; median of 20 calls after 3), and the share of it that the bound
    explains."""
    us = []
    for i in range(23):
        with _build.record_launches() as rec:
            fn()
        torch.cuda.synchronize()
        if not rec:
            raise AssertionError("own_time: the wrapper launched no kernel")
        if i >= 3:
            us.append(sum(a.elapsed_time(b) for _, a, b in rec) * 1e3)
    us = statistics.median(us)
    return dict(bnd, kernel_us=us, bound_share=bnd["bound_ms"] * 1e3 / us)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_ms(fn, warmup=WARMUP, runs=RUNS) -> float:
    """Median per-call device time of `fn` over `runs` calls, each between
    two CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_wall_ms(fn, warmup=WARMUP, runs=RUNS) -> float:
    """Median host-clock time of `fn` plus a device synchronise: what a
    caller waits for one result, launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_pair(kernel_fn, plain_fn, plain_runs=(WARMUP, RUNS)):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain
    on the same card; each is the mean of its two turns' medians."""
    p1 = time_ms(plain_fn, *plain_runs)
    k1 = time_ms(kernel_fn)
    k2 = time_ms(kernel_fn)
    p2 = time_ms(plain_fn, *plain_runs)
    return (k1 + k2) / 2, (p1 + p2) / 2


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
    ii = integral_image(frames_dev[0], cfg.doubled)
    ms_k, ms_p = time_pair(
        lambda: fused_pyramid(ii, cfg, h, w),
        lambda: [_candidate_mask(p, s, cfg) for p, s in
                 zip(response_pyramid(ii, cfg, h, w), scheds)])
    n_out = sum(p.numel() for p in pyr_k)
    emit(dict(phase="kernel_check", kernel="A", config=tag,
              layers_bit_exact=True, masks_equal=True, max_abs_err=err,
              candidates=n_cand, octaves=cfg.noctaves))
    # in: the integral image; out: float32 layers and one-byte masks
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p,
                **own_time(lambda: fused_pyramid(ii, cfg, h, w),
                           bound(nbytes(ii) + 5 * n_out, A_OPS * n_out)))


def check_kernel_a_stack(cfg, frames_dev):
    """Kernel A on the (B, ih, iw) stack of the frames' integral images, one
    launch: every frame's layers bit-exact to the twin and to the per-frame
    call, masks equal to both."""
    h, w = frames_dev[0].shape
    scheds = cfg.hessian_schedule(h, w)
    ii = torch.stack([integral_image(f, cfg.doubled) for f in frames_dev])
    before = fused_pyramid.launches
    pyr_b, masks_b = fused_pyramid(ii, cfg, h, w)
    if fused_pyramid.launches != before + 1:
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
    twin = lambda: [[_candidate_mask(p, s, cfg) for p, s in
                     zip(response_pyramid(f, cfg, h, w), scheds)] for f in ii]
    ms_k, ms_p = time_pair(lambda: fused_pyramid(ii, cfg, h, w), twin, SLOW)
    n_out = sum(p.numel() for p in pyr_b)
    emit(dict(phase="kernel_check", kernel="A_stack", frames=len(frames_dev),
              layers_bit_exact=True, masks_equal=True,
              equals_per_frame_call=True, launches=1))
    return dict(frames=len(frames_dev), ms=ms_k, plain_ms=ms_p,
                **own_time(lambda: fused_pyramid(ii, cfg, h, w),
                           bound(nbytes(ii) + 5 * n_out, A_OPS * n_out)))


def occupancy(cfgs, h, w):
    """Blocks and warps of the redesigned kernels that fit one SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the built kernels):
    kernel A at each configuration's dynamic shared memory, the describe
    kernel in each mode, kernel C at D = 64 and 128 (entry
    surf_best2_occupancy), kernel D (surf_orient_occupancy)."""
    out = {}

    def ask(entry, *args):
        blocks = ctypes.c_int(0)
        _build.launch(entry, *args, ctypes.byref(blocks))
        return blocks.value

    for name in ("main", "doubled"):
        c = cfgs[name]
        ih, iw = (2 * h, 2 * w) if c.doubled else (h + 1, w + 1)
        smem = pyramid_plan(c, h, w, ih, iw, "cuda:0").smem_bytes
        blocks = ask("surf_pyramid_occupancy", smem)
        out[f"A_{name}"] = dict(blocks_per_sm=blocks, warps_per_sm=8 * blocks,
                                dynamic_smem_bytes=smem)
    for mode, kw in B_MODES.items():
        blocks = ask("surf_describe_occupancy", int(kw["upright"]),
                     8 if kw["extended"] else 4)
        out[f"describe_{mode}"] = dict(blocks_per_sm=blocks,
                                       warps_per_sm=4 * blocks)
    for depth in (64, 128):
        blocks, warps = matcher_kernel.occupancy(depth)
        out[f"C_d{depth}"] = dict(blocks_per_sm=blocks,
                                  warps_per_sm=warps * blocks)
    blocks, warps = ctypes.c_int(0), ctypes.c_int(0)
    _build.launch("surf_orient_occupancy", ctypes.byref(blocks),
                  ctypes.byref(warps))
    out["D"] = dict(blocks_per_sm=blocks.value,
                    warps_per_sm=warps.value * blocks.value)
    return out


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


def orient_live_samples(ii, cfg, kp) -> int:
    """Samples of the orientation discs that lie inside the frame."""
    cx, cy, step, s = (a[:, None] for a in orient_geometry(
        kp.x, kp.y, kp.scale, cfg.doubled))
    g = torch.arange(-ORADIUS, ORADIUS + 1, device=ii.device)
    y1, x1 = g.repeat_interleave(g.numel()), g.repeat(g.numel())
    xx, yy = cx + x1 * step, cy + y1 * step
    ih, iw = ii.shape
    ok = ((yy + s + 2 < ih) & (yy - s > -1) & (xx + s + 2 < iw) & (xx - s > -1)
          & (y1 * y1 + x1 * x1 < ORADIUS_SQ) & kp.valid[:, None])
    return int(ok.sum())


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
    ii, kp, _ = kps_dev[0]
    args = (kp.x, kp.y, kp.scale, kp.valid)
    ms_k, ms_p = time_pair(lambda: assign_orientations(ii, cfg, *args),
                           lambda: assign_orientations_plain(ii, cfg, *args))
    emit(dict(phase="kernel_check", kernel="D", config=tag, keypoints=n,
              max_abs_err=worst, near_ties=n_near,
              near_tie_max_err=worst_near, bit_identical=True))
    K = kp.capacity
    ops = (D_OPS_LIVE * orient_live_samples(ii, cfg, kp)
           + D_OPS_WINDOWS * int(kp.valid.sum()))
    # in: the integral image, x / y / scale / valid per slot, the tables;
    # out: the angles
    return dict(max_abs_err=worst, ms=ms_k, plain_ms=ms_p,
                **own_time(lambda: assign_orientations(ii, cfg, *args),
                           bound(nbytes(ii) + 17 * K + 4 * 299, ops)))


B_MODES = {"upright64": dict(upright=True, extended=False),
           "rotated64": dict(upright=False, extended=False),
           "upright128": dict(upright=True, extended=True),
           "rotated128": dict(upright=False, extended=True)}


def describe_bound(ii, cfg, mode, geom, valid, rows_out, frame=None):
    """Kernel B's bound on these keypoints: the window and live sample
    counts come from the twin's own sample frame."""
    ih, iw = ii.shape[-2:]
    irad = torch.clamp(geom[4], max=cfg.max_iradius)
    window = int(((2 * irad + 1) ** 2)[valid].sum())
    live = 0
    for k0 in range(0, valid.shape[0], 1024):
        part = [None if g is None else g[k0:k0 + 1024] for g in geom]
        live += int(sample_frame(cfg, ih, iw, *part,
                                 valid[k0:k0 + 1024])[2].sum())
    K = valid.shape[0]
    per_slot = 4 * (6 + (3 if cfg.upright else 5) + (frame is not None))
    return dict(window_samples=window, live_samples=live,
                **bound(nbytes(ii) + per_slot * K + 160 + 4 * rows_out,
                        B_OPS_WINDOW[cfg.upright] * window
                        + B_OPS_LIVE[mode] * live))


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
    -> (result, the last mode's normalised rows of every frame)."""
    modes = {}
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
        ii, kp, ori = kps_dev[0]
        geom = desc_geometry(cfg, kp.x, kp.y, kp.scale, ori)
        ms_k, ms_p = time_pair(
            lambda: descriptor_rows(ii, cfg, *geom, kp.valid),
            lambda: describe_plain(ii, cfg, *geom, kp.valid))
        modes[mode] = dict(
            ms=ms_k, plain_ms=ms_p, min_cosine=worst_cos,
            max_abs_err=worst_err,
            **own_time(lambda: descriptor_rows(ii, cfg, *geom, kp.valid),
                       describe_bound(ii, cfg, mode, geom, kp.valid,
                                      rows_k.numel())))
        emit(dict(phase="kernel_check", kernel="B", config=tag, mode=mode,
                  rows=n_rows, min_cosine=worst_cos, max_abs_err=worst_err,
                  bit_identical=True))
    main = modes[mode_names[0]]
    return dict(main, max_abs_err=max(m["max_abs_err"]
                                      for m in modes.values()),
                modes=modes), normed


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
    ii = torch.stack([integral_image(f) for f in frames_dev])
    ori = torch.stack([assign_orientations(ii[f], cfg_rot, kb.x[f], kb.y[f],
                                           kb.scale[f], kb.valid[f])
                       for f in range(B)])
    flat = lambda a: a.reshape(-1)
    valid = flat(kb.valid)
    P = kb.capacity
    frame = torch.arange(B, dtype=torch.int32,
                         device=ii.device).repeat_interleave(P)
    modes = {}
    for mode in ("upright64", "rotated64"):
        cfg = SurfConfig(**dict(MAIN_CONFIG, **B_MODES[mode]))
        geom = desc_geometry(cfg, flat(kb.x), flat(kb.y), flat(kb.scale),
                             flat(ori))
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
        ms_k, ms_p = time_pair(
            lambda: stacked_rows(ii, cfg, *geom, valid, frame=frame),
            lambda: describe_plain(ii, cfg, *geom, valid, frame=frame), SLOW)
        modes[mode] = dict(
            ms=ms_k, plain_ms=ms_p, min_cosine=cos, max_abs_err=err,
            **own_time(lambda: stacked_rows(ii, cfg, *geom, valid,
                                            frame=frame),
                       describe_bound(ii, cfg, mode, geom, valid,
                                      rows.numel(), frame=frame)))
        emit(dict(phase="kernel_check", kernel="B_stacked", mode=mode,
                  frames=B, slots=B * P, rows=n, min_cosine=cos,
                  max_abs_err=err, bit_identical=True,
                  equals_single_frame_rows=True))
    return dict(modes["upright64"], modes=modes,
                max_abs_err=max(m["max_abs_err"] for m in modes.values()))


def check_kernel_b_step(kps_dev):
    """The static-step kernel at steps 4..8, cap 512, upright and rotated
    64-d, on the pair's keypoints: taken equal to the twin's, rows against
    the twin and equal bit for bit to kernel B's, untaken rows zero,
    bit-identical across launches; a cap below the eligible count takes
    the first `cap` in order and leaves the rest; the whole route
    (DEC_STEPS set) returns kernel B's rows exactly."""
    worst_cos, worst_err, taken_by_step, timed = 1.0, 0.0, {}, None
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
                    if timed is None and mode == "upright64":
                        timed = (ii, cfg, geom, v, sd, int(taken.sum()))
            patch_wavelets.DEC_STEPS = STEP_SDS
            try:
                routed = descriptor_rows(ii, cfg, *geom, v)
            finally:
                patch_wavelets.DEC_STEPS = ()
            if not torch.equal(routed, ref):
                raise AssertionError(f"step route {mode}: routed rows differ "
                                     "from kernel B's")
    if not taken_by_step or max(taken_by_step.values()) == 0 or timed is None:
        raise AssertionError("step kernel: the pair has no keypoint of "
                             f"steps {STEP_SDS}")
    ii, cfg, geom, v, sd, n_taken = timed
    ms_k, ms_p = time_pair(
        lambda: step_rows(ii, cfg, *geom, v, elig=v, sd=sd),
        lambda: step_rows_plain(ii, cfg, *geom, v, elig=v, sd=sd))
    only = v & (geom[2] == sd)
    cap = min(patch_wavelets.STEP_CAP, v.shape[0])
    bnd = own_time(lambda: step_rows(ii, cfg, *geom, v, elig=v, sd=sd),
                   describe_bound(ii, cfg, "upright64", geom, only,
                                  (cap + 1) * cfg.nfeatures))
    emit(dict(phase="kernel_check", kernel="B_step", steps=list(STEP_SDS),
              cap=patch_wavelets.STEP_CAP, taken_by_step=taken_by_step,
              min_cosine=worst_cos, max_abs_err=worst_err,
              equals_kernel_b_rows=True, bit_identical=True,
              overflow_left_untaken=True, timed_step=sd,
              timed_taken=n_taken))
    return dict(max_abs_err=worst_err, min_cosine=worst_cos, ms=ms_k,
                plain_ms=ms_p, timed_step=sd, timed_taken=n_taken, **bnd)


def f_inputs(cfg, frames):
    """Kernel A's layers and masks of a (H, W) frame or a (B, H, W) stack,
    the schedule and B: what `detect` takes."""
    h, w = frames.shape[-2:]
    stack = frames if frames.ndim == 3 else frames[None]
    ii = torch.stack([integral_image(f, cfg.doubled) for f in stack])
    pyr, masks = fused_pyramid(ii if frames.ndim == 3 else ii[0], cfg, h, w)
    return pyr, masks, cfg.hessian_schedule(h, w), stack.shape[0]


def f_bound(masks, out, walker_set) -> dict:
    """Kernel F's bound on these inputs: the masks read once, each fit's 19
    stencil values, each slot's 25 bytes of fields written once, and the
    operations; every candidate fits once and each walker of the walker
    set at least once more."""
    fits = int(out["count"]) + min(int(out["walkers"]), walker_set)
    mask_bytes = sum(m.numel() for m in masks)
    slots = out["valid"].numel()
    return bound(mask_bytes + 19 * 4 * fits + 25 * slots,
                 F_OPS_BYTE * mask_bytes + F_OPS_FIT * fits
                 + F_OPS_SLOT * slots)


def check_kernel_f(cases, card):
    """Kernel F vs the twin `_detect_plain` on the card, every output field
    and both counts bit for bit (floats as their bits), one count on
    detect.launches a call; each case (name, config, frame or stack) timed
    beside the twin, with F's own time against its bound, and whether the
    step-1 movers overflowed the max(cap // 8, 64) walker set."""
    rows = {}
    for name, cfg, frames in cases:
        pyr, masks, sched, B = f_inputs(cfg, frames)
        run = lambda: detect(pyr, sched, cfg, masks, nframes=B)
        twin = lambda: _detect_plain(pyr, sched, cfg, masks, nframes=B)
        before = detect.launches
        got = run()
        if detect.launches != before + 1:
            raise AssertionError(f"kernel F {name}: not one launch a call")
        for k, want in twin().items():
            a, b = got[k], want
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                raise AssertionError(f"kernel F {name}: {k} differs from the "
                                     "twin")
        walker_set = max(cfg.max_candidates * B // 8, 64)
        ms_k, ms_p = time_pair(run, twin)
        rows[name] = dict(frames=B, count=int(got["count"]),
                          walkers=int(got["walkers"]), walker_set=walker_set,
                          overflow=int(got["walkers"]) > walker_set, ms=ms_k,
                          plain_ms=ms_p,
                          **own_time(run, f_bound(masks, got, walker_set)))
    emit(dict(phase="kernel_check", kernel="F", bit_equal=True, cases={
        n: {k: r[k] for k in ("frames", "count", "walkers", "walker_set",
                              "overflow")} for n, r in rows.items()},
        card=card))
    first = next(iter(rows.values()))
    return dict(first, max_abs_err=0.0, cases=rows)


def c_bound(d1, d2, valid2):
    """Kernel C's bound: a multiply and an add per score element and depth,
    three such products on the tensor cores as 3xTF32, counted at the dense
    TF32 rate, then the top-2 compares at the float32 rate."""
    rows = d1[..., 0].numel()
    scores = rows * d2.shape[-2]
    return bound(nbytes(d1, d2, valid2) + 12 * rows, 2 * scores,
                 3 * 2 * scores * d1.shape[-1])


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
    sign; then E beside the twin on the first draw, and E's own time."""
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
    s1, s2 = x1[samples[0]], x2[samples[0]]
    run = lambda: five_point(s1, s2, gn_iters=4)
    twin = lambda: _five_point_plain(s1, s2, gn_iters=4)
    ms_k, ms_p = time_pair(run, twin, SLOW)
    h = s1.shape[0]
    bnd = bound(nbytes(s1, s2, *run()),
                h * (E_OPS_DK + 4 * E_OPS_GN_STEP + E_OPS_MATRICES))
    emit(dict(phase="kernel_check", kernel="E", draws=len(samples),
              hypotheses=h, valid_candidates=n, bit_equal=exact,
              valid_equal_slots=valid_eq, max_abs_err=err, card=card))
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p, bit_equal=exact,
                valid_candidates=n, **own_time(run, bnd))


def check_kernel_c(d1, d2, valid2):
    """Kernel C vs matcher_kernel._best2_plain at 4096 x 4096 x D."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the twin's matmul must run in full float32")
    run = lambda: fused_best2(d1, d2, valid2)
    twin = lambda: _best2_plain(d1, d2, valid2)
    err, n_clear = c_against_twin("kernel C", run(), twin())
    ms_k, ms_p = time_pair(run, twin)
    # a part of the function, not the function: the product alone, which
    # writes the score matrix that kernel C never stores and takes no top-2
    product_ms = time_ms(lambda: torch.matmul(d1, d2.T))
    emit(dict(phase="kernel_check", kernel="C", max_abs_err=err,
              rows=int(d1.shape[0]), depth=int(d1.shape[1]),
              index_checked=n_clear))
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p,
                product_only_ms=product_ms,
                **own_time(run, c_bound(d1, d2, valid2)))


def check_kernel_c_pairs(d1, d2, valid2):
    """Kernel C on P pairs in one launch, (P, 4096, 64) x (P, 4096, 64):
    against the twin, and equal bit for bit to P launches of one pair; one
    launch timed beside the P."""
    P = d1.shape[0]
    one = lambda: fused_best2(d1, d2, valid2)
    each = lambda: [fused_best2(d1[p], d2[p], valid2[p]) for p in range(P)]
    before = fused_best2.launches
    out = one()
    if fused_best2.launches != before + 1:
        raise AssertionError("kernel C on pairs: not one launch")
    err, _ = c_against_twin(f"kernel C, {P} pairs", out,
                            _best2_plain(d1, d2, valid2))
    for p, single in enumerate(each()):
        if not all(torch.equal(a[p], b) for a, b in zip(out, single)):
            raise AssertionError(f"kernel C: pair {p} of {P} in one launch "
                                 "differs from its own launch")
    res = dict(max_abs_err=err, pairs=P,
               **own_time(one, c_bound(d1, d2, valid2)))
    res["each_kernel_us"] = own_time(each, res)["kernel_us"]
    emit(dict(phase="kernel_check", kernel="C_pairs", pairs=P,
              equals_single_launches=True, launches=1, max_abs_err=err))
    return res


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


KERNELS = {"A": fused_pyramid, "B": single_rows, "B_stacked": stacked_rows,
           "B_step": step_rows, "C": fused_best2, "D": assign_orientations,
           "E": five_point, "F": detect}


def reset_counts():
    for k in KERNELS.values():
        k.launches = 0


def read_counts(name, expected):
    """The launch counts since `reset_counts`, held to `expected` by
    check_launches."""
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in KERNELS.items()}
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
    """Surf on the pair + match, counted; -> (kps, descs, matches, counts)
    with every kernel's launch count over this run alone.  The path must
    launch each kernel of `expected` and no other."""
    reset_counts()
    surf = Surf(cfg, device="cuda")
    kps, descs = zip(*[surf.detect_and_compute(f) for f in frames])
    m = surf.match(kps[0], descs[0], kps[1], descs[1])
    counts = read_counts(name, expected)
    for f, (kp, d) in enumerate(zip(kps, descs)):
        check_descriptors(name, kp, d, cfg)
        check_keypoints_against_golden(f, kp, golden)
    mean_best = check_mean_best(m.score, m.valid, golden["mean_best"], name)
    emit(dict(phase=f"{name}_path", keypoints=[int(k.count) for k in kps],
              golden_keypoints=golden["counts"].tolist(),
              matches=int(m.valid.sum()), mean_best=mean_best,
              golden_mean_best=float(golden["mean_best"]), launches=counts))
    return kps, descs, m, counts


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
    reset_counts()
    kb, db = Surf(cfg, device="cuda").detect_and_compute_batch(frames)
    bs = BatchSurf(cfg, device="cuda")
    frames_of = lambda k, sl: Keypoints(*[a[sl] for a in k])
    m = bs.match(frames_of(kb, slice(0, B - 1)), db[:-1],
                 frames_of(kb, slice(1, B)), db[1:])
    counts = read_counts("batch", {"A": 1, "B_stacked": 1, "C": 1, "F": 1})
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
    return kb, db, counts


def run_step_routed_path(cfg, frames, golden, descs_main):
    """The main path with the static-step route switched on, as the JAX
    package's own test switches it: same fixture, and descriptors equal
    to the main path's exactly."""
    patch_wavelets.DEC_STEPS = STEP_SDS
    try:
        kps, descs, _, counts = run_path(
            "step_routed", cfg, frames, golden,
            {"A": 2, "B": 2, "B_step": 2 * len(STEP_SDS), "C": 1, "F": 2})
    finally:
        patch_wavelets.DEC_STEPS = ()
    for a, b in zip(descs, descs_main):
        if not torch.equal(a, b):
            raise AssertionError("step-routed descriptors differ from the "
                                 "main path's")
    return counts


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


def run_track_path(card):
    """Surf + track_pair on the terrain fixture's pair with the JAX run's
    draw, counted; the 64 JAX draws of the fixture (the first is that
    draw), each through JAX's winner and whole; then `track_ms` on the
    port's own draws."""
    g = np.load(os.path.join(DATA, GOLDEN["track"]))
    if str(g["config"]) != repr(sorted(MAIN_CONFIG.items())) or \
            str(g["cell"]) != repr(sorted(TERRAIN_TRACK.items())):
        raise AssertionError("the track fixture is for another config or "
                             "cell; rerun tests/make_torch_golden.py track")
    intr = Intrinsics(*(float(v) for v in g["intrinsics"]))
    raw = torch.as_tensor(g["raw"]).cuda()
    surf = Surf(SurfConfig(**MAIN_CONFIG), device="cuda")
    reset_counts()
    (k1, d1), (k2, d2) = [surf.detect_and_compute(f) for f in g["frames"]]
    res = track_pair(k1, d1, k2, d2, intr, raw=raw)
    counts = read_counts("track", {"A": 2, "B": 2, "C": 1, "E": 1, "F": 2})
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
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fn = lambda: track_pair(k1, d1, k2, d2, intr, gen)
    ms, wall = time_ms(fn), time_wall_ms(fn)
    ops, us = device_ops(fn)
    emit(dict(metric="track_ms", value=ms, wall_ms=wall, device_ops=ops,
              device_us=us, busy_share=None if us is None else us / 1e3 / ms,
              what="track_pair (match, filter, 5-point RANSAC over 4096 "
              "slots x 128 hypotheses, pose) on the terrain pair's "
              "card-resident keypoints, the port's own draws", card=card))
    return counts


def run_ba_phase(card):
    """One lm_step and run_lm on bench.py's BA problem against the JAX
    fixture; then `ba_step_ms`."""
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
    fn = lambda: ba_core.lm_step(state, prob, lam, C)
    ms, wall = time_ms(fn), time_wall_ms(fn)
    ops, us = device_ops(fn)
    emit(dict(metric="ba_step_ms", value=ms, wall_ms=wall, device_ops=ops,
              device_us=us, what=f"one lm_step, {C} cameras x "
              f"{int(X.shape[0])} points", card=card))


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


def run_vo_path(card):
    """SlamPipeline over the 12-frame terrain orbit, plain, ba_refine and
    window_ba=4, each at the JAX fixture's seeds on the JAX pipeline's own
    draws (its key stream, `raws`) and each run counted, beside the JAX
    runs of golden_terrain_vo.npz.  -> the first plain run's counts."""
    g = np.load(os.path.join(DATA, GOLDEN["vo"]))
    frames, centres, intr = render_terrain_sequence(**TERRAIN_VO)
    if hashlib.sha256(frames.tobytes()).hexdigest() != \
            str(g["frames_sha256"]) or g["seeds"].tolist() != list(VO_SEEDS):
        raise AssertionError("vo: the fixture is for other frames or seeds; "
                             "rerun tests/make_torch_golden.py vo")
    raws = torch.as_tensor(g["raws"]).cuda()
    runs, counts, frame_ms = {}, None, []
    for run, kw in (("plain", {}), ("ba_refine", dict(ba_refine=True)),
                    ("window_ba", dict(window_ba=4))):
        ates, inliers = [], []
        for seed, seed_raws in zip(VO_SEEDS, raws):
            pipe = SlamPipeline(SurfConfig(**VO_CONFIG), intrinsics=intr,
                                seed=seed, device="cuda", **kw)
            reset_counts()
            for i, f in enumerate(frames):
                before = {k: fn.launches for k, fn in KERNELS.items()}
                t0 = time.perf_counter()
                pipe.process(f, raw=seed_raws[i - 1] if i else None)
                torch.cuda.synchronize()
                if run == "plain" and i:
                    frame_ms.append((time.perf_counter() - t0) * 1e3)
                got = {k: fn.launches - before[k] for k, fn in KERNELS.items()}
                check_launches(f"vo {run} seed {seed} frame {i}", got,
                               dict(A=1, B=1, F=1, **({"C": 1, "E": 1} if i
                                                      else {})))
            total = read_counts(f"vo {run}", {"A": len(frames),
                                              "B": len(frames),
                                              "C": len(frames) - 1,
                                              "E": len(frames) - 1,
                                              "F": len(frames)})
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
                  first={"A": 1, "B": 1, "F": 1},
                  after={"A": 1, "B": 1, "C": 1, "E": 1, "F": 1}),
              launches=counts))
    emit(dict(metric="vo_frame_ms", value=statistics.median(frame_ms),
              what="SlamPipeline.process, plain, one 200x280 frame of the "
              "terrain orbit after the first, host clock, median over the "
              "plain runs' frames", card=card))
    return counts


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


def gn_step(mod, graph, solver, table, stats=None):
    """One Gauss-Newton step's increment at the graph's state."""
    n = graph.R.shape[0]
    blocks = (mod._edge_blocks(graph, graph.s, graph.R, graph.t)
              if mod is sim3graph else mod._edge_blocks(graph, graph.R,
                                                        graph.t))
    return posegraph.solve_step(graph, n, solver, 1e-6, max(8 * n, 200),
                                None, None, blocks, table, stats)


def run_posegraph_phase(card):
    """The SE(3) and Sim(3) graphs of golden_posegraph.npz on the card:
    each optimised twice (the same bits: no float atomics) and held to the
    JAX result and cost curve; then `posegraph_iter_ms`, one Gauss-Newton
    step at the input state, with its device operations, CG rounds and host
    reads.  No kernel runs here."""
    g = np.load(os.path.join(DATA, "golden_posegraph.npz"))
    reset_counts()
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
        table = posegraph.segment_table(graph, graph.R.shape[0]) \
            if solver == "cg" else None
        step_stats = {}
        gn_step(mod, graph, solver, table, step_stats)
        fn = lambda: gn_step(mod, graph, solver, table)
        runs_ms = (2, 5) if solver == "cg" else (WARMUP, RUNS)
        ms, wall = time_ms(fn, *runs_ms), time_wall_ms(fn, *runs_ms)
        ops, us = device_ops(fn)
        cases[case] = dict(
            nodes=int(graph.R.shape[0]), edges=int(graph.edge_i.shape[0]),
            solver=solver, n_iters=n_iters, max_abs_err=err,
            costs=cp.tolist(), jax_costs=cj.tolist(), second_run_equal=same,
            cg_rounds=stats.get("cg_rounds"),
            jax_cg_rounds=(g[f"rounds_{case}"].tolist()
                           if solver == "cg" else None),
            host_reads=stats.get("host_reads"))
        emit(dict(metric="posegraph_iter_ms", case=case, value=ms,
                  wall_ms=wall, device_ops=ops, device_us=us,
                  cg_rounds=step_stats.get("cg_rounds", [0])[0],
                  cg_chunk=posegraph.CG_CHUNK if solver == "cg" else None,
                  host_reads=step_stats.get("host_reads", [0])[0],
                  what=f"one Gauss-Newton step of {case} ({solver}) at its "
                  "input state: edge blocks + solve", card=card))
    counts = read_counts("posegraph", {})
    emit(dict(phase="posegraph", cases=cases, tolerances=PG_TOL,
              launches=counts))
    return counts


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


def run_loops_phase(card):
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
    rows, counts, frame_ms, query_ms = [], None, [], []
    for k, seed in enumerate(seeds):
        raws = torch.as_tensor(vo["raws"][vo_seeds.index(seed)]).cuda()
        pipe = SlamPipeline(SurfConfig(**VO_CONFIG), intrinsics=intr,
                            seed=seed, loop_detect=True, loop_min_gap=gap,
                            device="cuda")
        reset_counts()
        for f, img in enumerate(frames):
            before = {n: fn.launches for n, fn in KERNELS.items()}
            n_ver = pipe._detector.n_verifications if f else 0
            t0 = time.perf_counter()
            pipe.process(img, raw=raws[f - 1] if f else None,
                         loop_raws=loop_raws[f])
            torch.cuda.synchronize()
            if f:
                frame_ms.append((time.perf_counter() - t0) * 1e3)
            if f == 0:
                query = pipe._detector.query

                def timed(*a, query=query, det=pipe._detector, **kw):
                    n0 = det.n_verifications
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    out = query(*a, **kw)
                    torch.cuda.synchronize()
                    query_ms.append(((time.perf_counter() - t1) * 1e3,
                                     det.n_verifications - n0))
                    return out

                pipe._detector.query = timed
            n_ver = pipe._detector.n_verifications - n_ver
            got = {n: fn.launches - before[n] for n, fn in KERNELS.items()}
            pairs = 1 + n_ver      # the tracked pair and each verification
            check_launches(f"loops seed {seed} frame {f}", got,
                           dict(A=1, B=1, F=1, **({"C": pairs, "E": pairs}
                                                  if f else {})))
        det = pipe._detector
        total = read_counts(f"loops seed {seed}", {
            "A": len(frames), "B": len(frames), "F": len(frames),
            "C": len(frames) - 1 + det.n_verifications,
            "E": len(frames) - 1 + det.n_verifications})
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
    q = [ms for ms, _ in query_ms]
    q_ver = [ms for ms, n in query_ms if n]
    emit(dict(phase="loops", frames=len(frames), seeds=seeds, min_gap=gap,
              runs=rows, median=med, jax_median=jmed,
              median_seeds_0_3=med4, jax_median_seeds_0_3=jmed4,
              resume=resume,
              launches_per_frame=dict(first={"A": 1, "B": 1, "F": 1}, after={
                  "A": 1, "B": 1, "F": 1,
                  "C": "1 + the frame's verifications",
                  "E": "1 + the frame's verifications"}),
              launches=counts))
    emit(dict(metric="slam_loop_frame_ms", value=statistics.median(frame_ms),
              what="SlamPipeline.process with loop detection, one 200x280 "
              "terrain frame after the first, host clock up to a "
              "synchronise, median over the seeds' frames", card=card))
    emit(dict(metric="loop_query_ms", value=statistics.median(q_ver),
              all_queries_median=statistics.median(q),
              verifications_per_query=float(np.mean(
                  [len(r["inliers"]) for r in rows])) / (len(frames) - gap),
              what="LoopDetector.query of a frame that verified at least one "
              "candidate (upload, kernel C, RANSAC, one host read a "
              "verification), host clock, median", card=card))
    return counts


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
MD_LAUNCHES = {n: {"A": 1, "B_stacked": 1, "C": 1, "F": 1} for n in (1, 2)}


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


def md_times(mesh, inp) -> dict:
    """The workloads' times on `mesh`: the mesh batch on the host clock up
    to a synchronise (input on the host, all-gather included), one LM
    iteration and one Gauss-Newton step of the graph with CUDA events.
    Every rank makes the same calls, in the same order."""
    bs = BatchSurf(inp.cfg, device="cuda", mesh=mesh)
    sprob, sstate = ba_distributed.shard_problem(inp.prob, inp.state, mesh)
    C = inp.state.R.shape[0]
    lam = torch.full((), 1e-3, device=mesh.device)
    c0 = psum(ba_core.cost(sstate, sprob), mesh)
    ba_iter = lambda: ba_distributed.lm_iteration(mesh, C, sstate, sprob,
                                                  lam, c0)
    ba_calls = count_allreduces(ba_iter)
    stats = {}
    pg_calls = count_allreduces(lambda: posegraph.optimize_distributed(
        inp.graph, mesh, n_iters=1, stats=stats))
    n = inp.graph.R.shape[0]
    return dict(
        mesh_batch8_ms=dict(value=time_wall_ms(
            lambda: bs.detect_and_compute(inp.frames), 1, 5)),
        dist_ba_iter_ms=dict(
            value=time_ms(ba_iter), allreduces=ba_calls,
            # the camera system packed in one buffer, the candidate's cost
            allreduce_bytes=[ba_distributed.allreduce_bytes(C), 4]),
        dist_posegraph_iter_ms=dict(
            value=time_ms(lambda: posegraph.optimize_distributed(
                inp.graph, mesh, n_iters=1), 1, 3),
            cg_rounds=stats["cg_rounds"][0],
            host_reads=stats["host_reads"][0],
            # counted in psum: b, D and the cost once a step, one a CG
            # round (masked ones included)
            allreduces=pg_calls,
            allreduce_bytes=dict(b=4 * 6 * n, D=4 * 36 * n,
                                 matvec=4 * 6 * n)))


def count_allreduces(fn) -> int:
    """The all-reduces that one call of `fn` makes through psum (0 without
    a group)."""
    collective_counts["all_reduce"] = 0
    fn()
    return collective_counts["all_reduce"]


def md_single_pairs(mesh, inp) -> dict:
    """Each workload at the world of one beside its single-device path on
    the same inputs, like for like and timed in turns (single, mesh, mesh,
    single, ...): the batch of 8 (BatchSurf without and with the mesh,
    host clock), one LM iteration (lm_step + cost + select against
    lm_iteration, CUDA events) and one Gauss-Newton step of the graph
    (optimize(solver="cg") against optimize_distributed, each with its
    segment table, CUDA events and host clock).  -> {metric: {single,
    mesh, ratio}}, medians."""
    C = inp.state.R.shape[0]
    lam = torch.full((), 1e-3, device=mesh.device)
    c0 = ba_core.cost(inp.state, inp.prob)
    sprob, sstate = ba_distributed.shard_problem(inp.prob, inp.state, mesh)
    c0m = psum(ba_core.cost(sstate, sprob), mesh)

    def lm_single():
        cand = ba_core.lm_step(inp.state, inp.prob, lam, C)
        return ba_core.lm_select(inp.state, cand, lam, c0,
                                 ba_core.cost(cand, inp.prob))
    single_bs = BatchSurf(inp.cfg, device="cuda")
    mesh_bs = BatchSurf(inp.cfg, device="cuda", mesh=mesh)
    work = dict(
        batch8_ms=(lambda: single_bs.detect_and_compute(inp.frames),
                   lambda: mesh_bs.detect_and_compute(inp.frames), 4),
        ba_iter_ms=(lm_single, lambda: ba_distributed.lm_iteration(
            mesh, C, sstate, sprob, lam, c0m), 10),
        posegraph_iter_ms=(
            lambda: posegraph.optimize(inp.graph, n_iters=1, solver="cg"),
            lambda: posegraph.optimize_distributed(inp.graph, mesh,
                                                   n_iters=1), 3))
    out = {}
    for metric, (single, on_mesh, rounds) in work.items():
        single(), on_mesh()                              # warm-up
        ev = {"single": [], "mesh": []}
        wall = {"single": [], "mesh": []}
        for _ in range(rounds):
            for name in ("single", "mesh", "mesh", "single"):
                fn = single if name == "single" else on_mesh
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a.record()
                fn()
                b.record()
                b.synchronize()
                wall[name].append((time.perf_counter() - t0) * 1e3)
                ev[name].append(a.elapsed_time(b))
        med = {k: statistics.median(v) for k, v in ev.items()}
        wmed = {k: statistics.median(v) for k, v in wall.items()}
        out[metric] = dict(single=med["single"], mesh=med["mesh"],
                           ratio=med["mesh"] / med["single"],
                           wall_single=wmed["single"], wall_mesh=wmed["mesh"],
                           wall_ratio=wmed["mesh"] / wmed["single"],
                           runs=2 * rounds)
    return out


def md_trace(step) -> dict | None:
    """One call of `step` at the world of one, first plain with the host
    time inside each `torch.distributed.all_reduce` summed, then under
    torch.profiler: the all-reduces (counted in psum), their host time
    (the `c10d::allreduce_` operator with what it calls; its
    `record_param_comms` self time, the backend's collective body) and the
    device time of the backend's kernels (names with "nccl"), beside the
    call's device operations and their summed time, and the heaviest host
    operators and device kernels.  The profiled part is None when the
    profiler records no device activity in three sessions (a reading, not
    a check)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    spent, bare = [], torch.distributed.all_reduce

    def timed(*args, **kw):
        t = time.perf_counter()
        out = bare(*args, **kw)
        spent.append(time.perf_counter() - t)
        return out
    torch.distributed.all_reduce = timed
    try:
        step()
    finally:
        torch.distributed.all_reduce = bare
    torch.cuda.synchronize()
    out = dict(allreduce_host_us_plain=sum(spent) * 1e6,
               allreduce_host_us_plain_each=sum(spent) * 1e6 / len(spent))
    for _ in range(3):
        collective_counts["all_reduce"] = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            break
    else:
        return dict(out, profiled=None)
    kernels = {}
    for e in dev:
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us()
    cpu = [a for a in prof.key_averages() if a.device_type == DeviceType.CPU]
    ar = [a for a in cpu if a.key == "c10d::allreduce_"]
    nccl = [(n, c, us) for n, (c, us) in kernels.items()
            if "nccl" in n.lower()]
    top = lambda rows: [dict(name=n[:80], count=c, us=round(us, 1))
                        for n, c, us in sorted(rows, key=lambda r: -r[2])[:8]]
    return dict(
        out, allreduces=collective_counts["all_reduce"],
        allreduce_host_ops=sum(a.count for a in ar),
        allreduce_host_us=sum(a.cpu_time_total for a in ar),
        record_param_comms_self_us=sum(a.self_cpu_time_total for a in cpu
                                       if a.key == "record_param_comms"),
        allreduce_device_kernels=sum(c for _, c, _ in nccl),
        allreduce_device_us=sum(us for *_, us in nccl),
        clones=sum(a.count for a in cpu if a.key == "aten::clone"),
        device_ops=len(dev), device_us=sum(e.time_range.elapsed_us()
                                           for e in dev),
        top_host_ops=top([(a.key, a.count, a.self_cpu_time_total)
                          for a in cpu]),
        top_device_kernels=top([(n, c, us) for n, (c, us) in
                                kernels.items()]))


def md_traces(mesh, inp) -> dict:
    """md_trace of one optimize_distributed step of the n = 600 graph and
    of one distributed LM iteration."""
    C = inp.state.R.shape[0]
    sprob, sstate = ba_distributed.shard_problem(inp.prob, inp.state, mesh)
    lam = torch.full((), 1e-3, device=mesh.device)
    c0 = psum(ba_core.cost(sstate, sprob), mesh)
    return dict(
        posegraph_step=md_trace(lambda: posegraph.optimize_distributed(
            inp.graph, mesh, n_iters=1)),
        ba_iteration=md_trace(lambda: ba_distributed.lm_iteration(
            mesh, C, sstate, sprob, lam, c0)))


def md_world(mesh, inp, name):
    """md_run counted (the counts set to 0 just before and read just after,
    held to MD_LAUNCHES), then md_times.  -> (outputs, counts, times)."""
    reset_counts()
    out = md_run(mesh, inp)
    counts = read_counts(name, MD_LAUNCHES[mesh.size])
    return out, counts, md_times(mesh, inp)


def multidevice_rank(out_dir) -> int:
    """One rank of the phase's world of two, started by
    run_multidevice_phase with the SURF_* variables set: both ranks on
    cuda:0 over gloo (NCCL refuses two ranks on one card).  Writes its
    outputs to out_dir/rank<r>.npz and prints its launches and times as
    one JSON line."""
    initialize_from_env(timeout_s=MD_RANK_TIMEOUT, backend="gloo",
                        device="cuda:0")
    mesh = global_mesh()
    inp = md_inputs(np.load(os.path.join(out_dir, "frames.npy")))
    out, counts, times = md_world(mesh, inp, f"multidevice rank "
                                  f"{mesh.rank}")
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    emit(dict(multidevice_rank=mesh.rank, backend=mesh.backend,
              device=str(mesh.device), launches=counts, **times))
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
    the replicated outputs bit-equal across the ranks.  Then the times of
    both worlds."""
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
        out1, counts, times1 = md_world(mesh, inp, "multidevice")
        pairs = md_single_pairs(mesh, inp)
        traces = md_traces(mesh, inp)
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
    emit(dict(metric="multidevice_world1_vs_single", pairs=pairs,
              what="each workload at the world of one (NCCL) beside its "
              "single-device path, like for like, in turns; medians of "
              "CUDA events and of the host clock", card=card))
    emit(dict(metric="multidevice_traces", **traces,
              what="one optimize_distributed step of the n = 600 graph and "
              "one distributed LM iteration at the world of one (NCCL): "
              "host time inside the all-reduces, then torch.profiler",
              card=card))
    what = dict(mesh_batch8_ms="mesh BatchSurf of the 8 1280x960 frames, "
                "host input, all-gather included, host clock",
                dist_ba_iter_ms="one distributed LM iteration, 8 cameras x "
                "512 points, CUDA events",
                dist_posegraph_iter_ms="one optimize_distributed step of "
                "the n = 600 SE(3) graph (padding, table, blocks, CG), CUDA "
                "events")
    for metric, text in what.items():
        emit(dict(metric=metric, world1=times1[metric]["value"],
                  world2=[ln[metric]["value"] for ln in lines],
                  **{k: v for k, v in times1[metric].items() if k != "value"},
                  what=text, note="world 2: two processes on one card over "
                  "gloo: the communication path, not scaling",
                  nccl=".".join(map(str, torch.cuda.nccl.version())),
                  card=card))
    return counts


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


def profiled_ops(fn, frames):
    """Device operations and their summed us per frame in one call of `fn`,
    and the call's operations, from torch.profiler.  The profiler now and
    then records no device activity; after four such sessions the counts
    are reported as missing (None), since they are a reading, not a check."""
    for _ in range(4):
        ops, us = device_ops(fn)
        if ops:
            return ops / frames, us / frames, us
    return None, None, None


def time_batch(cfg, frames_dev, card):
    """The batch beside the same frames through the single-frame path, in
    turns batch, singles, singles, batch, on the host clock up to a
    synchronise and with CUDA events; device operations per frame of both
    from one profiled call each."""
    B = len(frames_dev)
    imgs = torch.stack(frames_dev)
    batch = lambda: detect_and_compute_batch(imgs, cfg)
    singles = lambda: [detect_and_compute(f, cfg) for f in frames_dev]
    turns = [(fn, time_wall_ms(fn, 2, 5), time_ms(fn, 1, 5))
             for fn in (batch, singles, singles, batch)]
    wall = lambda fn: statistics.mean(w for f, w, _ in turns if f is fn)
    dev = lambda fn: statistics.mean(e for f, _, e in turns if f is fn)
    share = lambda us, fn: None if us is None else us / 1e3 / wall(fn)
    ops_b, us_b, all_b = profiled_ops(batch, B)
    ops_s, us_s, all_s = profiled_ops(singles, B)
    emit(dict(metric="batch8_ms", value=dev(batch), wall_ms=wall(batch),
              batch8_frames_per_s=B / wall(batch) * 1e3,
              device_ops_per_frame=ops_b, device_us_per_frame=us_b,
              busy_share=share(all_b, batch),
              what=f"detect_and_compute_batch of {B} 1280x960 frames, "
              "device-resident input", card=card))
    emit(dict(metric="singles8_ms", value=dev(singles), wall_ms=wall(singles),
              singles8_frames_per_s=B / wall(singles) * 1e3,
              device_ops_per_frame=ops_s, device_us_per_frame=us_s,
              busy_share=share(all_s, singles),
              what=f"the same {B} frames, one detect_and_compute each",
              card=card))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    env = environment()
    card = env["card"]

    t0 = time.perf_counter()
    kl = _build.kernels()
    ptxas = [ln.strip() for ln in kl.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    configs = dict(main=MAIN_CONFIG, rotated=ROTATED_CONFIG,
                   doubled=DOUBLED_CONFIG,
                   doubled_rotated=DOUBLED_ROTATED_CONFIG)
    cfgs = {k: SurfConfig(**v) for k, v in configs.items()}
    occ = occupancy(cfgs, MAIN_PAIR["h"], MAIN_PAIR["w"])
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=kl.build_seconds, occupancy=occ, ptxas=ptxas))
    golden = {k: load_golden(k, v) for k, v in configs.items()}
    golden["batch"] = load_golden("batch", MAIN_CONFIG)
    cfg = cfgs["main"]
    batch_frames = main_batch(BATCH_FRAMES)
    frames = batch_frames[:2]                  # the main pair
    batch_dev = [torch.as_tensor(f).cuda() for f in batch_frames]
    frames_dev = batch_dev[:2]

    res = {"A": check_kernel_a(cfg, frames_dev)}
    res["A"]["stack"] = check_kernel_a_stack(cfg, batch_dev)
    kps_dev = path_keypoints(frames_dev, cfgs["rotated"])
    res["D"] = check_kernel_d(cfgs["rotated"], kps_dev)
    res["B"], rows128 = check_kernel_b(MAIN_CONFIG, kps_dev, list(B_MODES))
    res["B_step"] = check_kernel_b_step(kps_dev)
    res["B_stacked"] = check_kernel_b_stacked(batch_dev)
    # the same kernels at the doubled frame's size, one frame
    dbl = {"A": check_kernel_a(cfgs["doubled"], frames_dev[:1], "doubled")}
    kps_dbl = path_keypoints(frames_dev[:1], cfgs["doubled_rotated"])
    dbl["D"] = check_kernel_d(cfgs["doubled_rotated"], kps_dbl, "doubled")
    dbl["B"], _ = check_kernel_b(DOUBLED_CONFIG, kps_dbl,
                                 ["upright64", "rotated64"], "doubled")

    # A and F: one launch a frame
    pair_kernels = {"A": 2, "B": 2, "C": 1, "F": 2}
    counts = {}
    kps, descs, m, counts["main"] = run_path("main", cfg, frames,
                                             golden["main"], pair_kernels)
    for name in ("rotated", "doubled", "doubled_rotated"):
        expected = dict(pair_kernels, **({} if cfgs[name].upright
                                         else {"D": 2}))
        *_, counts[name] = run_path(name, cfgs[name], frames, golden[name],
                                    expected)
    counts["step_routed"] = run_step_routed_path(cfg, frames, golden["main"],
                                                 descs)
    kb, db, counts["batch"] = run_batch_path(cfg, batch_frames,
                                             golden["batch"])

    vo_frame = render_terrain_sequence(n_frames=1, h=480, w=640)[0][0]
    res["F"] = check_kernel_f([
        ("main_left", cfg, frames_dev[0]), ("main_right", cfg, frames_dev[1]),
        ("batch8", cfg, torch.stack(batch_dev)),
        ("vo_640x480", SurfConfig(**VO_CONFIG),
         torch.as_tensor(vo_frame).cuda())], card)
    res["C"] = check_kernel_c(descs[0], descs[1], kps[1].valid)
    c128 = check_kernel_c(rows128[0], rows128[1], kps_dev[1][1].valid)
    res["C"].update(d128=c128, pairs=check_kernel_c_pairs(
        db[:-1].contiguous(), db[1:].contiguous(), kb.valid[1:].contiguous()),
        max_abs_err=max(res["C"]["max_abs_err"], c128["max_abs_err"]))

    times = lambda r: {k: r[k] for k in ("kernel_us", "bound_ms", "bound_by",
                                         "bound_share")}
    what = {"main": "upright detect+describe",
            "rotated": "detect+orientation+rotated describe",
            "doubled": "doubled upright detect+describe",
            "doubled_rotated": "doubled detect+orientation+rotated describe"}
    for name, metric in (("main", "pair_ms"), ("rotated", "rotated_pair_ms"),
                         ("doubled", "doubled_pair_ms"),
                         ("doubled_rotated", "doubled_rotated_pair_ms")):
        pair = lambda c=cfgs[name]: [detect_and_compute(f, c)
                                     for f in frames_dev]
        runs = (WARMUP, RUNS) if name == "main" else (5, 20)
        ms, wall = time_ms(pair, *runs), time_wall_ms(pair, *runs)
        emit(dict(metric=metric, value=ms, wall_ms=wall,
                  frame_ms=ms / 2, what=f"{what[name]} of both 1280x960 "
                  "frames, device-resident input", card=card))
    time_batch(cfg, batch_dev, card)
    match = lambda: match_keypoints(kps[0], descs[0], kps[1], descs[1])
    emit(dict(metric="match_ms", value=time_ms(match),
              wall_ms=time_wall_ms(match), what="4096 x 4096 left->right "
              "match", card=card))
    res["E"] = check_kernel_e(card)
    counts["track"] = run_track_path(card)
    run_ba_phase(card)
    counts["vo"] = run_vo_path(card)
    counts["posegraph"] = run_posegraph_phase(card)
    run_cli_phase(card)
    counts["loops"] = run_loops_phase(card)
    counts["multidevice"] = run_multidevice_phase(card)
    for k, r in res.items():
        emit(dict(metric=f"kernel_{k}_ms", value=r["ms"],
                  plain_ms=r["plain_ms"], **times(r), card=card))
    stack = res["A"]["stack"]
    emit(dict(metric="kernel_A_stack_ms", value=stack["ms"],
              plain_ms=stack["plain_ms"], frames=stack["frames"],
              **times(stack), what="kernel A, one launch on the stack of "
              f"{stack['frames']} integral images", card=card))
    for k in ("B", "B_stacked"):
        for mode, r in res[k]["modes"].items():
            emit(dict(metric=f"kernel_{k}_{mode}_ms", value=r["ms"],
                      plain_ms=r["plain_ms"], **times(r), card=card))
    c128, cpairs = res["C"]["d128"], res["C"]["pairs"]
    emit(dict(metric="kernel_C_d128_ms", value=c128["ms"],
              plain_ms=c128["plain_ms"], **times(c128), card=card))
    emit(dict(metric="kernel_C_pairs_us", value=cpairs["kernel_us"],
              each_kernel_us=cpairs["each_kernel_us"], pairs=cpairs["pairs"],
              **times(cpairs), what="kernel C's own device time on the "
              "batch's pairs of consecutive frames, one launch beside one "
              "launch a pair", card=card))
    for depth, r in ((64, res["C"]), (128, c128)):
        emit(dict(metric=f"matmul_d{depth}_product_only_ms",
                  value=r["product_only_ms"], what="torch.matmul(d1, d2.T) "
                  "alone in float32, TF32 off: a part of kernel C's function "
                  "(it writes the 67 MB score matrix and takes no top-2)",
                  card=card))
    for k, r in dbl.items():
        for mode, rm in r.get("modes", {"": r}).items():
            emit(dict(metric=f"doubled_kernel_{k}{'_' + mode if mode else ''}"
                      "_ms", value=rm["ms"], plain_ms=rm["plain_ms"],
                      **times(rm), what="one 1280x960 frame doubled: a 2560x1920 "
                      "integral image", card=card))

    reference_pair(cfg)

    csrc = "cuda_surf_tpu_torch/csrc/"
    # name, source, the TPU kernel it replaces, further ones, and the path
    # whose run gives `launches`
    meta = {
        "A": ("octave_response_nms", "detect.cu",
              "cuda_surf_tpu/ops/fused_detect.py:148", None, "main"),
        "B": ("describe", "describe.cu",
              "cuda_surf_tpu/ops/patch_wavelets.py:369",
              ["cuda_surf_tpu/ops/patch_bucketed.py:70",
               "cuda_surf_tpu/ops/patch_common.py:147"], "main"),
        "B_stacked": ("describe_stacked", "describe.cu",
                      "cuda_surf_tpu/ops/patch_wavelets.py:129", None,
                      "batch"),
        "B_step": ("describe_step", "describe_step.cu",
                   "cuda_surf_tpu/ops/patch_bucketed.py:487", None,
                   "step_routed"),
        "C": ("fused_best2", "match.cu",
              "cuda_surf_tpu/ops/matcher_pallas.py:42", None, "main"),
        "D": ("orient", "orient.cu",
              "cuda_surf_tpu/ops/patch_bucketed.py:70", None, "rotated"),
        "E": ("five_point", "fivepoint.cu",
              "none: not a port (cuda_surf_tpu/geometry/fivepoint.py is "
              "XLA-compiled jnp)", None, "track"),
        "F": ("detect_glue", "extrema.cu",
              "none: not a port (cuda_surf_tpu/ops/extrema.py:detect is "
              "XLA-compiled jnp)", None, "main"),
    }
    rows = []
    for k, (name, src, repl, also, path) in meta.items():
        r = res[k]
        row = dict(name=name, route="cuda", source=csrc + src, replaces=repl,
                   launches=counts[path][k], launches_path=path,
                   launches_by_path={p: c[k] for p, c in counts.items()},
                   max_abs_err=r["max_abs_err"], ms=r["ms"],
                   plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                   bound_by=r["bound_by"], bound_bytes=r["bound_bytes"],
                   bound_ops=r["bound_ops"], kernel_us=r["kernel_us"],
                   bound_share=r["bound_share"],
                   # no single PyTorch call computes any of these functions
                   library_ms=None)
        if also:
            row["also_replaces"] = also
        if "modes" in r:
            row["modes"] = r["modes"]
        if k in ("B", "B_stacked", "B_step"):
            row["body"] = csrc + "describe_body.cuh"
        if k == "E":
            row.update(body=csrc + "fivepoint_body.cuh",
                       bit_equal=r["bit_equal"],
                       valid_candidates=r["valid_candidates"])
        if k in ("A", "B", "B_stacked", "B_step", "C", "D"):
            # what fits an SM, asked of the built kernels
            row["occupancy"] = {n: v for n, v in occ.items() if n.startswith(
                {"A": "A_", "C": "C_", "D": "D"}.get(k, "describe_"))}
        if k == "A":
            row["stack"] = r["stack"]
        if k == "B_step":
            row.update(timed_step=r["timed_step"],
                       timed_taken=r["timed_taken"])
        if k == "C":
            # the bound counts three TF32 products a score at the tensor
            # cores' dense rate
            row.update(product_only_ms=r["product_only_ms"], d128=r["d128"],
                       pairs=r["pairs"])
        if k == "D":
            row["replaces_mode"] = "grids"
        if k == "F":
            row["cases"] = r["cases"]
        if k in dbl:
            row["doubled"] = {kk: v for kk, v in dbl[k].items()}
        rows.append(row)
    emit({"kernels": rows})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multidevice-rank"]:
        sys.exit(multidevice_rank(sys.argv[2]))
    sys.exit(main())
