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
     two launches; A, D and B again at the doubled frame's size);
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
  6. checks the reference stereo pair too, when the environment variable
     SURF_REFERENCE_DATA names the directory that holds it.

Every failure raises, and the exit code is then non-zero.  With no CUDA
device it exits with code 2 before printing any result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cuda_surf_tpu_torch import (BatchSurf, Surf, SurfConfig, _build,
                                 detect_and_compute, detect_and_compute_batch,
                                 match_keypoints)
from cuda_surf_tpu_torch.config import (BATCH_FRAMES, DOUBLED_CONFIG,
                                        DOUBLED_ROTATED_CONFIG, MAIN_CONFIG,
                                        ORADIUS, ORADIUS_SQ, ROTATED_CONFIG)
from cuda_surf_tpu_torch.io import MAIN_PAIR, main_batch, read_pgm
from cuda_surf_tpu_torch.ops import patch_wavelets
from cuda_surf_tpu_torch.ops.descriptor import (desc_geometry, describe_plain,
                                                l2_normalize, sample_frame)
from cuda_surf_tpu_torch.ops.extrema import _candidate_mask
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
          "batch": "golden_plane_batch.npz"}
WARMUP, RUNS = 10, 50
SLOW = (1, 3)    # warm-up and timed runs of a twin that takes > 0.1 s
GAP = 1e-5       # top-two orientation window gap below which either wins
STEP_SDS = (4, 5, 6, 7, 8)

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
           "B_step": step_rows, "C": fused_best2, "D": assign_orientations}


def reset_counts():
    for k in KERNELS.values():
        k.launches = 0


def read_counts(name, expected):
    """The launch counts since `reset_counts`; every kernel in `expected`
    must have launched (exactly that often where a number is given) and no
    other kernel at all."""
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    for k, n in expected.items():
        if counts[k] == 0 or (n is not None and counts[k] != n):
            raise AssertionError(f"{name} path: kernel {k} launched "
                                 f"{counts[k]} times, expected "
                                 f"{'some' if n is None else n}")
    stray = [k for k in KERNELS if k not in expected and counts[k]]
    if stray:
        raise AssertionError(f"kernels {stray} launched on the {name} path, "
                             "which does not run them")
    return counts


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
    single-frame path (BatchSurf.detect_and_compute) in the same run."""
    B = frames.shape[0]
    if int(golden["n_frames"]) != B:
        raise AssertionError("the batch fixture holds another frame count")
    reset_counts()
    kb, db = Surf(cfg, device="cuda").detect_and_compute_batch(frames)
    bs = BatchSurf(cfg, device="cuda")
    frames_of = lambda k, sl: Keypoints(*[a[sl] for a in k])
    m = bs.match(frames_of(kb, slice(0, B - 1)), db[:-1],
                 frames_of(kb, slice(1, B)), db[1:])
    counts = read_counts("batch", {"A": 1, "B_stacked": 1, "C": 1})
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
    ks, ds = bs.detect_and_compute(frames)
    for f in range(B):
        n = int(ks.count[f])
        same = n == int(kb.count[f]) and torch.equal(ks.valid[f], kb.valid[f])
        for name in ("x", "y", "scale", "strength", "laplace", "octave"):
            same = same and torch.equal(getattr(ks, name)[f, :n],
                                        getattr(kb, name)[f, :n])
        if not same or not torch.equal(ds[f], db[f]):
            raise AssertionError(f"batch frame {f} differs from the "
                                 "single-frame path: max |d desc| "
                                 f"{(ds[f] - db[f]).abs().max().item()}")
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
            {"A": 2, "B": 2, "B_step": 2 * len(STEP_SDS), "C": 1})
    finally:
        patch_wavelets.DEC_STEPS = ()
    for a, b in zip(descs, descs_main):
        if not torch.equal(a, b):
            raise AssertionError("step-routed descriptors differ from the "
                                 "main path's")
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

    pair_kernels = {"A": 2, "B": 2, "C": 1}    # A: one launch a frame
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
    sys.exit(main())
