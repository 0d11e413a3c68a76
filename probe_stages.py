"""Per-stage cost of one frame of the port's pair paths, and of one batch
of frames, on one NVIDIA GPU.

Splits `frontend.detect_and_compute` on frame 0 of the 1280x960 main pair
(cuda_surf_tpu_torch.io.main_pair, on the card) into its stages, at the
main config (upright) and the rotated config (upright=False): integral
image, kernel A, detection (kernel F: compaction + subpixel walk),
makePoint + Laplacian sign, orientation (kernel D, rotated only),
descriptor geometry, kernel B's rows, normalisation, the whole frame, and
the match of frame 0 against frame 1 (kernel C and its glue).  Each
stage runs on the outputs of the stages before it.  For each it prints

  - `ms`: device time with CUDA events, median of --runs calls after 5
    warm-up calls (glue included: a launch-bound stage reads its host
    time here);
  - `device_ops` and `device_us`: the operations one call put on the
    device (kernels, memsets, copies) and their summed device time, from
    one call under torch.profiler;

and for the whole frame the device busy share, device_us over ms.  One
JSON object per stage, then a markdown table of both paths.

Then the batch path, `frontend.detect_and_compute_batch` on the
BATCH_FRAMES frames of cuda_surf_tpu_torch.io.main_batch at the main
config, split the same way (integral images, kernel A on the stack,
the stacked detection, makePoint + the spread to (B, max_pts), descriptor
geometry, kernel B on the stacked frames, normalisation, the whole batch,
BatchSurf.match of the pairs of consecutive frames),
with ms and device µs also per frame, and, with --doubled, the two
doubled pair paths like the first table.

With --kernels it times the kernels alone instead, at the main path's
shapes: A on one frame, on the stack of BATCH_FRAMES frames and on the
doubled frame (a 2560x1920 integral image); G, the integral image, on
frame 0 (G_frame), on a stack of 32 frames (G_stack32), on a 640x480
terrain frame (G_vo), and doubled on frame 0 (G_doubled) and the stack
(G_doubled_stack32; its twin on the card, G_doubled_stack32_twin); F, the
compaction and subpixel walk, on frame 0 (F_frame), on the stack (F_stack)
and on the 640x480 terrain frame at the VO config (F_vo); E, the
five-point solver, on the 128 hypotheses of the track fixture's first JAX
draw at gn_iters 4, as track_pair calls it; kernel B on frame 0's keypoints, upright / rotated x
64 / 128-d; B_stacked on every frame's slots in one launch, 64-d; B_step,
the static-step kernel at step 4; C on the descriptors of frames 0 -> 1
at 64-d (C_d64) and 128-d (C_d128), on the BATCH_FRAMES - 1 pairs of
consecutive frames in one launch (C_pairs) and in one launch a pair
(C_each); D on frame 0's keypoints (D_frame), on every frame's slots in
one launch (D_stack) and on the doubled frame's (D_doubled).  One JSON
object per kernel: `kernel_us`, the device time of the library call alone (CUDA events around it, `_build.record_launches`,
median of 20 calls after 3), `ms` as above, `device_ops` and `device_us`
from the profiler, `sha`, a hash of the output's bytes, so that two
builds of the kernels can be held against each other bit for bit, and
`occupancy` where the kernel has an occupancy entry point (blocks and
warps of the built kernel that fit one SM).  `bound_us` is the least time
the kernel's work takes on the card's published peaks
(portbench/rooflines/peaks.py), `bound_share` that over `kernel_us`, and
`bound_count` names where the work is counted: A, 64-d B and D by the
benchmark's own counts (portbench/rooflines/detect.py, describe.py,
describe_rotated.py, orient.py); C and E-G by this file's (`c_work`,
`E_OPS_*`, `f_work`, `g_work`).  A mode that no count covers (doubled A;
128-d or doubled B) prints `bound_count` as the reason and no share.

With --track it splits the visual-odometry path instead: `track_pair` on
the terrain fixture's 1280x960 pair (cuda_surf_tpu_torch/data/
golden_terrain_track.npz, card-resident keypoints at the main config) into
match (kernel C and its glue), filter + normalise, sampling, the five-point
solver (and its Durand-Kerner root step alone), the Sampson scoring of the
4096 slots x 2560 candidates, the two refits, recover_pose and the whole
call on the port's own draws; and one `lm_step` on bench.py's 8-camera x
512-point problem into the Schur build, the solve, the rest, and the whole
step, with `run_lm` for 10 iterations.  Then `posegraph_iter_ms`: one
Gauss-Newton step (edge blocks + solve) of each of golden_posegraph.npz's
four graphs (SE(3) / Sim(3) at n = 64 dense and n = 600 CG) at its input
state, CUDA events and the host clock up to a synchronise, with its device
operations, CG rounds and host reads.

    python3 probe_stages.py [--runs 30] [--doubled]
    python3 probe_stages.py --kernels [--only A,C_d] [--tag NAME]
    python3 probe_stages.py --track [--runs 30]
    python3 probe_stages.py --rates

--rates builds and runs probe_rates.cu (beside this script) instead: the
rates of the mma and FMA instructions that bound kernel C, in loops without
memory.

With no CUDA device it exits with code 2 before printing any result.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from cuda_surf_tpu_torch import BatchSurf, SurfConfig, _build, match_keypoints
from cuda_surf_tpu_torch.ba import core as ba_core
from cuda_surf_tpu_torch.geometry import epipolar, fivepoint
from cuda_surf_tpu_torch.io.synth import Intrinsics, ba_problem
from cuda_surf_tpu_torch.slam import posegraph, sim3graph
from cuda_surf_tpu_torch.slam.tracking import (filter_matches, track_inputs,
                                               track_pair)
from cuda_surf_tpu_torch.config import (BATCH_FRAMES, DOUBLED_CONFIG,
                                        DOUBLED_ROTATED_CONFIG, MAIN_CONFIG,
                                        ROTATED_CONFIG, VO_CONFIG)
from cuda_surf_tpu_torch.frontend import (_make_keypoints, _spread_frames,
                                          detect_and_compute,
                                          detect_and_compute_batch)
from cuda_surf_tpu_torch.io import main_batch, render_terrain_sequence
from cuda_surf_tpu_torch.ops import matcher_kernel
from cuda_surf_tpu_torch.ops.descriptor import desc_geometry, l2_normalize
from cuda_surf_tpu_torch.ops.extrema import detect
from cuda_surf_tpu_torch.ops.fused_detect import fused_pyramid, pyramid_plan
from cuda_surf_tpu_torch.ops.integral import (_integral_plain,
                                              integral_image)
from cuda_surf_tpu_torch.ops.matcher_kernel import fused_best2
from cuda_surf_tpu_torch.ops.orientation import assign_orientations
from cuda_surf_tpu_torch.ops.patch_wavelets import descriptor_rows, step_rows
from chip_smoke import B_MODES, DATA, PG_CASES, f_inputs, posegraph_case
from portbench.rooflines import describe as describe_count
from portbench.rooflines import describe_rotated as rotated_count
from portbench.rooflines import detect as detect_count
from portbench.rooflines import orient as orient_count
from portbench.rooflines import peaks


ORDER = ("integral image", "kernel A, all octaves", "detect: compaction + walk",
         "makePoint + Laplacian", "orientation (kernel D)",
         "descriptor geometry", "kernel B rows", "normalise",
         "one frame, whole", "match, frame 0 -> 1")


def event_ms(fn, runs: int, warmup: int = 5) -> float:
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


def wall_ms(fn, runs: int, warmup: int = 5) -> float:
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


def device_ops(fn):
    """-> (operations, summed device us) of one call of `fn`; (None,
    None) when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        return None, None
    return len(ev), sum(e.time_range.elapsed_us() for e in ev)


def stages(cfg: SurfConfig, img: torch.Tensor, nxt: torch.Tensor):
    """[(name, fn)] of one frame `img`, each fn on fixed earlier outputs;
    the match is against the frame `nxt`."""
    h, w = img.shape
    (k0, d0), (k1, d1) = (detect_and_compute(f, cfg) for f in (img, nxt))
    sched = cfg.hessian_schedule(h, w)
    ii = integral_image(img, cfg.doubled)
    pyr, masks = fused_pyramid(ii, cfg, h, w)
    cand = detect(pyr, sched, cfg, cand_masks=masks)
    _, valid, x, y, scale, *_ = _make_keypoints(ii, cand, cfg)
    orient = lambda: assign_orientations(ii, cfg, x, y, scale, valid)
    ori = torch.zeros_like(x) if cfg.upright else orient()
    geom = desc_geometry(cfg, x, y, scale, ori)
    rows = descriptor_rows(ii, cfg, *geom, valid)
    out = [("integral image", lambda: integral_image(img, cfg.doubled)),
           ("kernel A, all octaves", lambda: fused_pyramid(ii, cfg, h, w)),
           ("detect: compaction + walk",
            lambda: detect(pyr, sched, cfg, cand_masks=masks)),
           ("makePoint + Laplacian", lambda: _make_keypoints(ii, cand, cfg))]
    if not cfg.upright:
        out.append(("orientation (kernel D)", orient))
    out += [("descriptor geometry",
             lambda: desc_geometry(cfg, x, y, scale, ori)),
            ("kernel B rows", lambda: descriptor_rows(ii, cfg, *geom, valid)),
            ("normalise",
             lambda: torch.where(valid[:, None], l2_normalize(rows), 0.0)),
            ("one frame, whole", lambda: detect_and_compute(img, cfg)),
            ("match, frame 0 -> 1", lambda: match_keypoints(k0, d0, k1, d1))]
    return out


def batch_stages(cfg: SurfConfig, imgs: torch.Tensor):
    """[(name, fn)] of one batch, each fn on fixed earlier outputs."""
    B, h, w = imgs.shape
    sched = cfg.hessian_schedule(h, w)
    integrals = lambda: integral_image(imgs, cfg.doubled)
    ii = integrals()
    pyr, masks = fused_pyramid(ii, cfg, h, w)
    cand = detect(pyr, sched, cfg, cand_masks=masks, nframes=B)
    points = lambda: _make_keypoints(ii, cand, cfg)
    _, valid_u, *fields, fid = points()
    flat = lambda a: a.reshape(-1)
    _, valid, x, y, scale, *_ = (flat(a) for a in _spread_frames(
        valid_u, fid, fields, B, cfg.max_pts))
    ori = torch.zeros_like(x)
    frame = torch.arange(B, dtype=torch.int32,
                         device=imgs.device).repeat_interleave(cfg.max_pts)
    geom = desc_geometry(cfg, x, y, scale, ori)
    rows = descriptor_rows(ii, cfg, *geom, valid, frame=frame)

    def spread():
        _, v, *f, i = points()
        return _spread_frames(v, i, f, B, cfg.max_pts)

    return [("integral images", integrals),
            ("kernel A, all octaves and frames",
             lambda: fused_pyramid(ii, cfg, h, w)),
            ("detect: compaction + walk on the union",
             lambda: detect(pyr, sched, cfg, cand_masks=masks, nframes=B)),
            ("makePoint + Laplacian + spread", spread),
            ("descriptor geometry",
             lambda: desc_geometry(cfg, x, y, scale, ori)),
            ("kernel B rows, stacked",
             lambda: descriptor_rows(ii, cfg, *geom, valid, frame=frame)),
            ("normalise",
             lambda: torch.where(valid[:, None], l2_normalize(rows), 0.0)),
            ("one batch, whole", lambda: detect_and_compute_batch(imgs, cfg)),
            (f"match of {B - 1} pairs", match_pairs(cfg, imgs))]


def match_pairs(cfg: SurfConfig, imgs: torch.Tensor):
    """BatchSurf.match of frame i -> i + 1 over the batch, as a stage."""
    kb, db = detect_and_compute_batch(imgs, cfg)
    bs = BatchSurf(cfg, device="cuda")
    cut = lambda sl: type(kb)(*[a[sl] for a in kb])
    k1, k2 = cut(slice(0, -1)), cut(slice(1, None))
    return lambda: bs.match(k1, db[:-1], k2, db[1:])


def probe(path, name, fn, runs, card, whole, per=1):
    ms = event_ms(fn, runs)
    ops, us = device_ops(fn)
    row = dict(path=path, stage=name, ms=ms, device_ops=ops, device_us=us,
               card=card)
    if per > 1:
        row.update(frames=per, ms_per_frame=ms / per,
                   device_ops_per_frame=None if ops is None else ops / per,
                   device_us_per_frame=None if us is None else us / per)
    if name == whole and us is not None:
        row["busy_share"] = us / 1e3 / ms
    print(json.dumps(row), flush=True)
    return row


def pair_table(paths, imgs, runs, card):
    table = {}
    for path, config in paths:
        for name, fn in stages(SurfConfig(**config), imgs[0], imgs[1]):
            table.setdefault(name, {})[path] = probe(
                path, name, fn, runs, card, "one frame, whole")
    a, b = (p for p, _ in paths)
    print(f"\n{card}; CUDA events, median of {runs}; torch.profiler\n")
    print(f"| Stage | {a} ms | ops | device µs | {b} ms | ops | device µs |")
    print("|---|---|---|---|---|---|---|")
    cell = lambda r: ("— | — | —" if r is None else f"{r['ms']:.3f} | "
                      + ("— | —" if r["device_us"] is None else
                         f"{r['device_ops']} | {r['device_us']:.1f}"))
    for name in sorted(table, key=ORDER.index):
        r = table[name]
        print(f"| {name} | {cell(r.get(a))} | {cell(r.get(b))} |")
    print(flush=True)


# The work of kernels C, E and F, counted from their twins' expressions;
# integer and compare operations count at the float32 rate, as a multiply
# or an add does.  Kernel E per hypothesis: 20 roots x 96 Durand-Kerner
# rounds of ~150 operations (ten complex differences and their product, a
# Horner chain of ten complex multiply-adds, a complex division, the
# step's clamp), 20 candidates x ~1,100 a Gauss-Newton step (80 monomial
# terms, 40 products of 20, the 3x3 normal equations) and ~10,000 for the
# constraint matrix, the 10x10 solve and det B(z)
E_OPS_DK, E_OPS_GN_STEP, E_OPS_MATRICES = 20 * 96 * 150, 20 * 1100, 10000
# kernel F: per mask byte the candidate test and its share of the scans, 2;
# per fit the 19 stencil indices (4 each) and clamps (2), the gradient and
# Hessian (19), the pivoted solve (42) and the strength (6), ~140; per slot
# the fields, 20
F_OPS_BYTE, F_OPS_FIT, F_OPS_SLOT = 2, 140, 20
NO_COUNT = "the benchmark counts 64-d, undoubled frames only"
G_STACK = 32        # kernel G's stack: batch32's frames a request


def own_us(fn) -> float:
    """Device us of the library calls of `fn` alone, median of 20 after 3."""
    us = []
    for i in range(23):
        with _build.record_launches() as rec:
            fn()
        torch.cuda.synchronize()
        if i >= 3:
            us.append(sum(a.elapsed_time(b) for _, a, b in rec) * 1e3)
    return statistics.median(us)


def flatten(out):
    """Tensors of a wrapper's result, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for part in out for t in flatten(part)]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(count, kernel_us: float) -> dict:
    """`count`: (where the work is counted, (bytes, float32 operations[,
    TF32 operations])), or why there is no count."""
    if isinstance(count, str):
        return dict(bound_count=f"no count: {count}", bound_share=None)
    source, work = count
    us = peaks.least_seconds(*work) * 1e6
    by_bytes = work[0] / peaks.HBM_BYTES_PER_S * 1e6 >= us
    return dict(bound_us=us, bound_by="bytes" if by_bytes else "operations",
                bound_share=us / kernel_us, bound_count=source)


def c_work(d1, d2, valid2):
    """Kernel C: in the descriptors and the mask, out 12 bytes a row; a
    multiply and an add per score element and depth, three such products
    on the tensor cores as 3xTF32 (counted at the dense TF32 rate), then the
    top-2 compares."""
    rows = d1[..., 0].numel()
    scores = rows * d2.shape[-2]
    return (nbytes(d1, d2, valid2) + 12 * rows, 2 * scores,
            3 * 2 * scores * d1.shape[-1])


def f_work(masks, out, walker_set):
    """Kernel F: the masks read once, each fit's 19 stencil values, each
    slot's 25 bytes of fields written once; every candidate fits once and
    each walker of the walker set at least once more."""
    fits = int(out["count"]) + min(int(out["walkers"]), walker_set)
    mask_bytes = sum(m.numel() for m in masks)
    slots = out["valid"].numel()
    return (mask_bytes + 19 * 4 * fits + 25 * slots,
            F_OPS_BYTE * mask_bytes + F_OPS_FIT * fits + F_OPS_SLOT * slots)


def g_work(frames, doubled=False):
    """Kernel G in one pass: each source byte read once, each int32 of the
    (H+1, W+1) outputs, doubled (2H, 2W), written once; no floating-point
    operation."""
    h, w = frames.shape[-2:]
    n = frames.numel() // (h * w)
    oh, ow = (2 * h, 2 * w) if doubled else (h + 1, w + 1)
    return (frames.numel() + 4 * n * oh * ow, 0)


def occupancy(h: int, w: int) -> dict:
    """Blocks and warps of the built kernels that fit one SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor through each kernel's
    occupancy entry point): A at the main and the doubled frame's dynamic
    shared memory, the describe kernel in each mode, C at D = 64 and 128,
    D."""
    out = {}

    def ask(entry, *args):
        blocks = ctypes.c_int(0)
        _build.launch(entry, *args, ctypes.byref(blocks))
        return blocks.value

    for name, config in (("A_main", MAIN_CONFIG), ("A_doubled",
                                                    DOUBLED_CONFIG)):
        c = SurfConfig(**config)
        ih, iw = (2 * h, 2 * w) if c.doubled else (h + 1, w + 1)
        smem = pyramid_plan(c, h, w, ih, iw, "cuda:0").smem_bytes
        blocks = ask("surf_pyramid_occupancy", smem)
        out[name] = dict(blocks_per_sm=blocks, warps_per_sm=8 * blocks,
                         dynamic_smem_bytes=smem)
    for mode, kw in B_MODES.items():
        blocks = ask("surf_describe_occupancy", int(kw["upright"]),
                     8 if kw["extended"] else 4)
        out[f"B_{mode}"] = dict(blocks_per_sm=blocks, warps_per_sm=4 * blocks)
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


def kernel_table(imgs, runs, card, only, tag):
    """The kernels alone, one JSON object each; `only`: name prefixes."""
    wanted = lambda name: any(name.startswith(o) for o in only)
    B, h, w = imgs.shape
    occ = occupancy(h, w)

    def report(name, fn, count, occ_key=None):
        """`count`: a function -> bound()'s count, or why there is none."""
        if not wanted(name):
            return
        digest = hashlib.sha256()
        for t in flatten(fn()):
            digest.update(t.contiguous().cpu().numpy().tobytes())
        ops, us = device_ops(fn)
        k_us = own_us(fn)
        row = dict(tag=tag, kernel=name, kernel_us=k_us,
                   ms=event_ms(fn, runs), device_ops=ops, device_us=us,
                   sha=digest.hexdigest()[:16], card=card,
                   **bound(count if isinstance(count, str) else count(),
                           k_us))
        if occ_key:
            row["occupancy"] = occ[occ_key]
        print(json.dumps(row), flush=True)

    cfg = SurfConfig(**MAIN_CONFIG)
    a_count = lambda frames: ("portbench/rooflines/detect.py", tuple(
        frames * v for v in detect_count.work(MAIN_CONFIG, h, w)))
    ii = integral_image(imgs)
    report("A", lambda: fused_pyramid(ii[0], cfg, h, w),
           lambda: a_count(1), "A_main")
    report("A_stack", lambda: fused_pyramid(ii, cfg, h, w),
           lambda: a_count(B), "A_main")
    dcfg = SurfConfig(**DOUBLED_CONFIG)
    iid = integral_image(imgs[0], True)
    report("A_doubled", lambda: fused_pyramid(iid, dcfg, h, w), NO_COUNT,
           "A_doubled")
    group = lambda g: any(o.startswith(g) or g.startswith(o) for o in only)
    vo = torch.as_tensor(render_terrain_sequence(
        n_frames=1, h=480, w=640)[0][0]).cuda()
    if group("G_"):
        stack = torch.as_tensor(main_batch(G_STACK)).cuda()
        for name, frames, dbl in (("G_frame", imgs[0], False),
                                  ("G_stack32", stack, False),
                                  ("G_vo", vo, False),
                                  ("G_doubled", imgs[0], True),
                                  ("G_doubled_stack32", stack, True)):
            report(name, lambda: integral_image(frames, dbl),
                   lambda: ("probe_stages.g_work", g_work(frames, dbl)))
        # the twin on the card, for the bring-up table's "ms / twin ms"
        report("G_doubled_stack32_twin", lambda: _integral_plain(stack, True),
               "the twin: eager torch, no library call")
    if group("F_"):
        for name, c, frames in (("F_frame", cfg, imgs[0]),
                                ("F_stack", cfg, imgs),
                                ("F_vo", SurfConfig(**VO_CONFIG), vo)):
            pyr, masks, sched, n = f_inputs(c, frames)
            run = lambda: detect(pyr, sched, c, masks, nframes=n)
            walker_set = max(c.max_candidates * n // 8, 64)
            report(name, lambda: list(run().values()),
                   lambda: ("probe_stages.f_work",
                            f_work(masks, run(), walker_set)))
    if group("E"):
        s1, s2 = track_hypotheses()
        run = lambda: fivepoint.five_point(s1, s2, gn_iters=4)
        report("E", run, lambda: ("probe_stages.E_OPS_*", (
            nbytes(s1, s2, *run()), s1.shape[0] * (
                E_OPS_DK + 4 * E_OPS_GN_STEP + E_OPS_MATRICES))))
    if not any(group(g) for g in ("B_", "C_", "D_")):
        return

    kb, _ = detect_and_compute_batch(imgs, cfg, compute_descriptors=False)
    rcfg = SurfConfig(**ROTATED_CONFIG)
    flat = lambda a: a.reshape(-1)
    frame = torch.arange(B, dtype=torch.int32,
                         device=ii.device).repeat_interleave(kb.x.shape[1])
    ori = assign_orientations(ii, rcfg, flat(kb.x), flat(kb.y),
                              flat(kb.scale), flat(kb.valid),
                              frame=frame).reshape(B, -1)
    frame_kps = lambda f, valid=None: SimpleNamespace(
        x=kb.x[f], y=kb.y[f], scale=kb.scale[f], ori=ori[f],
        valid=kb.valid[f] if valid is None else valid)
    counts = {"upright64": ("portbench/rooflines/describe.py",
                            describe_count),
              "rotated64": ("portbench/rooflines/describe_rotated.py",
                            rotated_count)}
    b_count = lambda *kps, mode="upright64": (counts[mode][0], tuple(
        map(sum, zip(*(counts[mode][1].work(k, h, w) for k in kps)))))
    for mode, kw in B_MODES.items():
        c = SurfConfig(**dict(MAIN_CONFIG, **kw))
        counted = mode in counts
        g0 = desc_geometry(c, kb.x[0], kb.y[0], kb.scale[0], ori[0])
        report(f"B_{mode}",
               lambda: descriptor_rows(ii[0], c, *g0, kb.valid[0]),
               (lambda: b_count(frame_kps(0), mode=mode)) if counted
               else NO_COUNT, f"B_{mode}")
        if not c.extended:
            g = desc_geometry(c, flat(kb.x), flat(kb.y), flat(kb.scale),
                              flat(ori))
            report(f"B_stacked_{mode}",
                   lambda: descriptor_rows(ii, c, *g, flat(kb.valid),
                                           frame=frame),
                   (lambda: b_count(*map(frame_kps, range(B)), mode=mode))
                   if counted else NO_COUNT, f"B_{mode}")
    g0 = desc_geometry(cfg, kb.x[0], kb.y[0], kb.scale[0], ori[0])
    v = kb.valid[0]
    step = lambda: step_rows(ii[0], cfg, *g0, v, elig=v, sd=4)
    report("B_step", lambda: step()[0],
           lambda: b_count(frame_kps(0, step()[1])))

    d_count = lambda *kps, doubled=False: ("portbench/rooflines/orient.py",
                                           tuple(map(sum, zip(*(
                                               orient_count.work(k, h, w,
                                                                 doubled)
                                               for k in kps)))))
    report("D_frame", lambda: assign_orientations(
        ii[0], rcfg, kb.x[0], kb.y[0], kb.scale[0], kb.valid[0]),
        lambda: d_count(frame_kps(0)), "D")
    report("D_stack", lambda: assign_orientations(
        ii, rcfg, flat(kb.x), flat(kb.y), flat(kb.scale), flat(kb.valid),
        frame=frame), lambda: d_count(*map(frame_kps, range(B))), "D")
    if wanted("D_doubled"):
        drcfg = SurfConfig(**DOUBLED_ROTATED_CONFIG)
        kd, _ = detect_and_compute(imgs[0], drcfg, compute_descriptors=False)
        report("D_doubled", lambda: assign_orientations(
            iid, drcfg, kd.x, kd.y, kd.scale, kd.valid),
            lambda: d_count(kd, doubled=True), "D")
    if not group("C_"):
        return
    rows = {}
    for mode in ("upright64", "upright128"):
        c = SurfConfig(**dict(MAIN_CONFIG, **B_MODES[mode]))
        g = desc_geometry(c, flat(kb.x), flat(kb.y), flat(kb.scale), flat(ori))
        rows[mode] = l2_normalize(descriptor_rows(
            ii, c, *g, flat(kb.valid), frame=frame)).reshape(B, -1, c.nfeatures)
    d64, d128 = rows["upright64"], rows["upright128"]
    c_count = lambda *a: ("probe_stages.c_work", c_work(*a))
    report("C_d64", lambda: fused_best2(d64[0], d64[1], kb.valid[1]),
           lambda: c_count(d64[0], d64[1], kb.valid[1]), "C_d64")
    report("C_d128", lambda: fused_best2(d128[0], d128[1], kb.valid[1]),
           lambda: c_count(d128[0], d128[1], kb.valid[1]), "C_d128")
    d1, d2, v2 = d64[:-1].contiguous(), d64[1:].contiguous(), \
        kb.valid[1:].contiguous()
    report("C_each", lambda: [fused_best2(d1[p], d2[p], v2[p])
                              for p in range(B - 1)],
           lambda: c_count(d1, d2, v2), "C_d64")
    report("C_pairs", lambda: fused_best2(d1, d2, v2),
           lambda: c_count(d1, d2, v2), "C_d64")


def track_hypotheses():
    """x1, x2 of the 128 hypotheses that the track fixture's first JAX draw
    samples on its 1280x960 pair at the main config."""
    g = np.load(os.path.join(DATA, "golden_terrain_track.npz"))
    intr = Intrinsics(*(float(v) for v in g["intrinsics"]))
    cfg = SurfConfig(**MAIN_CONFIG)
    (k1, d1), (k2, d2) = [detect_and_compute(torch.as_tensor(f).cuda(), cfg)
                          for f in g["frames"]]
    _, good, x1, x2 = track_inputs(k1, d1, k2, d2, intr)
    sample = epipolar.sample_rows(good, torch.as_tensor(g["raws"][0]).cuda())
    return x1[sample], x2[sample]


def track_stages():
    """[(name, fn)] of track_pair on the terrain fixture's pair and of one
    lm_step on bench.py's BA problem, each fn on fixed earlier outputs."""
    g = np.load(os.path.join(DATA, "golden_terrain_track.npz"))
    intr = Intrinsics(*(float(v) for v in g["intrinsics"]))
    cfg = SurfConfig(**MAIN_CONFIG)
    (k1, d1), (k2, d2) = [detect_and_compute(torch.as_tensor(f).cuda(), cfg)
                          for f in g["frames"]]
    raw = torch.as_tensor(g["raw"]).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    m, good, x1, x2 = track_inputs(k1, d1, k2, d2, intr)
    sample = epipolar.sample_rows(good, raw)
    Es, ok = epipolar.hypotheses(x1, x2, sample, "5pt")
    scores = torch.where(ok, epipolar._sampson_inlier_counts(
        Es, x1, x2, good, 2e-5), -1)
    E_best = epipolar._take(Es, torch.argmax(scores))
    E, inl = epipolar.refit(E_best, x1, x2, good, 2e-5)
    det = torch.randn(128, 11, device="cuda")       # det B(z), 128 samples
    normalise = lambda: [epipolar.normalize_with_intrinsics(
        torch.stack(p, -1), *intr[:2], *intr[2:])
        for p in ((k1.x, k1.y), (m.match_x, m.match_y))]
    (ci, uv, mask), (R, t, X) = ba_problem()
    prob = ba_core.problem_from_numpy(ci, uv, mask, "cuda")
    state = ba_core.state_from_numpy(R, t, X, "cuda")
    C = R.shape[0]
    Sm, bv, *_ = ba_core._schur_system(state, prob, 1e-3, C)
    return [
        ("match (kernel C + glue)",
         lambda: match_keypoints(k1, d1, k2, d2)),
        ("filter + normalise",
         lambda: (filter_matches(k1, k2, m), normalise())),
        ("sampling", lambda: epipolar.sample_rows(good, raw)),
        ("draw + sampling", lambda: epipolar.sample_rows(
            good, epipolar.draw_raw(128, 5, "cuda", gen))),
        ("five-point, 128 samples",
         lambda: epipolar.hypotheses(x1, x2, sample, "5pt")),
        ("  of it: Durand-Kerner roots", lambda: fivepoint._roots_dk(det)),
        ("Sampson scoring, 4096 x 2560", lambda: epipolar._sampson_inlier_counts(
            Es, x1, x2, good, 2e-5)),
        ("winner + two refits",
         lambda: epipolar.refit(E_best, x1, x2, good, 2e-5)),
        ("recover_pose", lambda: epipolar.recover_pose(E, x1, x2, inl)),
        ("track_pair, whole",
         lambda: track_pair(k1, d1, k2, d2, intr, gen)),
        ("BA: Schur build, 8 x 512",
         lambda: ba_core._schur_system(state, prob, 1e-3, C)),
        ("BA: solve 48 x 48", lambda: torch.linalg.solve_ex(Sm, bv[:, None])),
        ("lm_step, whole", lambda: ba_core.lm_step(state, prob, 1e-3, C)),
        ("run_lm, 10 iterations",
         lambda: ba_core.run_lm(state, prob, n_iters=10)),
    ]


def gn_step(mod, graph, solver, table, stats=None):
    """One Gauss-Newton step's increment at the graph's state."""
    n = graph.R.shape[0]
    blocks = (mod._edge_blocks(graph, graph.s, graph.R, graph.t)
              if mod is sim3graph else mod._edge_blocks(graph, graph.R,
                                                        graph.t))
    return posegraph.solve_step(graph, n, solver, 1e-6, max(8 * n, 200),
                                None, None, blocks, table, stats)


def posegraph_steps(card, runs):
    """`posegraph_iter_ms` of each graph of golden_posegraph.npz: one
    Gauss-Newton step at its input state, with its CG rounds and host
    reads; the CG steps, ~0.2-0.4 s each, 5 runs after 2."""
    g = np.load(os.path.join(DATA, "golden_posegraph.npz"))
    for case in PG_CASES:
        mod, graph, solver, _ = posegraph_case(g, case)
        table = posegraph.segment_table(graph, graph.R.shape[0]) \
            if solver == "cg" else None
        stats = {}
        gn_step(mod, graph, solver, table, stats)
        fn = lambda: gn_step(mod, graph, solver, table)
        n, warmup = (5, 2) if solver == "cg" else (runs, 5)
        ms = event_ms(fn, n, warmup)
        ops, us = device_ops(fn)
        print(json.dumps(dict(
            metric="posegraph_iter_ms", case=case, value=ms,
            wall_ms=wall_ms(fn, n, warmup), device_ops=ops, device_us=us,
            cg_rounds=stats.get("cg_rounds", [0])[0],
            cg_chunk=posegraph.CG_CHUNK if solver == "cg" else None,
            host_reads=stats.get("host_reads", [0])[0],
            what=f"one Gauss-Newton step of {case} ({solver}) at its input "
            "state: edge blocks + solve", card=card)), flush=True)


def track_table(card, runs):
    rows = [probe("track", name, fn, runs, card, "track_pair, whole")
            for name, fn in track_stages()]
    print(f"\n{card}; CUDA events, median of {runs}; torch.profiler\n")
    print("| Stage | ms | device ops | device µs |")
    print("|---|---|---|---|")
    for r in rows:
        us = r["device_us"]
        print(f"| {r['stage']} | {r['ms']:.3f} | {r['device_ops']} | "
              + ("— |" if us is None else f"{us:.1f} |"))
    print(flush=True)
    posegraph_steps(card, runs)
    return 0


def instruction_rates(card) -> int:
    """Build probe_rates.cu with the kernel library's flags into a temporary
    directory, run it and print its lines, each with the card."""
    src = Path(__file__).resolve().parent / "probe_rates.cu"
    with tempfile.TemporaryDirectory() as tmp:
        exe = f"{tmp}/probe_rates"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", exe,
                        str(src)], check=True, stdout=sys.stderr)
        out = subprocess.run([exe], capture_output=True, text=True, check=True)
    for line in out.stdout.splitlines():
        print(json.dumps(dict(json.loads(line), card=card)), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--kernels", action="store_true",
                    help="time the kernels alone instead")
    ap.add_argument("--only", default="",
                    help="with --kernels: only the kernels whose name starts "
                         "with one of these, separated by commas")
    ap.add_argument("--tag", default="", help="with --kernels: copied to "
                    "every line")
    ap.add_argument("--rates", action="store_true",
                    help="run the instruction-rate loops instead")
    ap.add_argument("--doubled", action="store_true",
                    help="also the two doubled pair paths")
    ap.add_argument("--track", action="store_true",
                    help="the visual-odometry path's stages instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_stages: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if args.rates:
        return instruction_rates(card)
    if args.track:
        return track_table(card, args.runs)
    imgs = torch.as_tensor(main_batch(BATCH_FRAMES)).cuda()
    if args.kernels:
        kernel_table(imgs, args.runs, card, args.only.split(","), args.tag)
        return 0
    pair_table((("upright", MAIN_CONFIG), ("rotated", ROTATED_CONFIG)),
               imgs, args.runs, card)
    if args.doubled:
        pair_table((("doubled", DOUBLED_CONFIG),
                    ("doubled rotated", DOUBLED_ROTATED_CONFIG)),
                   imgs, args.runs, card)
    B = imgs.shape[0]
    runs = max(args.runs // 3, 5)
    rows = [probe("batch", name, fn, runs, card, "one batch, whole", per=B)
            for name, fn in batch_stages(SurfConfig(**MAIN_CONFIG), imgs)]
    print(f"\n{card}; batch of {B} frames; CUDA events, median of {runs}; "
          "torch.profiler\n")
    print("| Stage | batch ms | ops | device µs | ms / frame | ops / frame "
          "| device µs / frame |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        us = r["device_us"]
        print(f"| {r['stage']} | {r['ms']:.3f} | {r['device_ops']} | "
              + ("— | " if us is None else f"{us:.1f} | ")
              + f"{r['ms_per_frame']:.3f} | "
              + ("— | —" if us is None else
                 f"{r['device_ops_per_frame']:.1f} | "
                 f"{r['device_us_per_frame']:.1f}") + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
