"""Drive the PyTorch + CUDA port's two paths once on one NVIDIA GPU.

Both paths run the 1280x960 pair cuda_surf_tpu_torch.io.main_pair through
Surf(cfg, device="cuda"): detect + describe on each frame, then left ->
right matching.  The main path is the reference demo's workload, upright
64-d SURF at SurfConfig(noctaves=4, thresh=4.0, upright=True,
max_pts=4096, candidates_per_octave=4096); the rotated path is the same
config with upright=False (orientation, then rotated descriptors), as
bench.py times it for `rotated_pair_ms`.  The script

  1. prints the card (nvidia-smi), CUDA, nvcc and Triton versions;
  2. builds the kernels from cuda_surf_tpu_torch/csrc with nvcc, one
     process per source, in parallel;
  3. holds each kernel against its plain PyTorch twin on the card at the
     paths' shapes (A: layers bit-exact and masks equal; B in all four
     modes, upright / rotated x 64 / 128-d: per-row cosine >= 0.99999 and
     invalid rows zero; C at D = 64 and 128: |d score| <= 1e-5 and equal
     indices wherever best - second >= 1e-5; D: orientation within 1e-4
     rad wherever the top-two window gap is >= 1e-5 relative, one of the
     two top windows below that, and bit-identical across two launches);
  4. for each path, resets the launch counters, runs Surf on the pair and
     matches, checks that every kernel of the path launched and no other
     did, and holds the keypoints and the mean best score against the
     path's JAX golden fixture (cuda_surf_tpu_torch/data/
     golden_plane_pair.npz and golden_plane_pair_rotated.npz; the rotated
     one also holds the orientations, to 1e-3 rad wherever the gap is
     >= 1e-5 and to one of the two top windows below it);
  5. times both pairs, the match and each kernel beside its twin with CUDA
     events (10 warm-up runs, median of 50), and the pairs and the match
     on the host clock as well, up to a device synchronise;
  6. checks the reference stereo pair too, when the environment variable
     SURF_REFERENCE_DATA names the directory that holds it.

Every failure raises, and the exit code is then non-zero.  With no CUDA
device it exits with code 2 before printing any result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cuda_surf_tpu_torch import (Surf, SurfConfig, _build,
                                 detect_and_compute, match_keypoints)
from cuda_surf_tpu_torch.config import MAIN_CONFIG, ROTATED_CONFIG
from cuda_surf_tpu_torch.io import MAIN_PAIR, main_pair, read_pgm
from cuda_surf_tpu_torch.ops.descriptor import (desc_geometry, describe_plain,
                                                l2_normalize)
from cuda_surf_tpu_torch.ops.extrema import _candidate_mask
from cuda_surf_tpu_torch.ops.fused_detect import fused_octave, fused_pyramid
from cuda_surf_tpu_torch.ops.hessian import response_pyramid
from cuda_surf_tpu_torch.ops.integral import integral_image
from cuda_surf_tpu_torch.ops.matcher_kernel import _best2_plain, fused_best2
from cuda_surf_tpu_torch.ops.orientation import (assign_orientations,
                                                 assign_orientations_plain,
                                                 orientation_windows,
                                                 top2_windows)
from cuda_surf_tpu_torch.ops.patch_wavelets import descriptor_rows

# Directory of the reference demo's stereo pair (left.pgm, right.pgm); the
# pair is checked only when this names a directory that holds both.
REFERENCE_DATA = os.environ.get("SURF_REFERENCE_DATA", "")
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "cuda_surf_tpu_torch", "data")
GOLDEN = {"upright": os.path.join(DATA, "golden_plane_pair.npz"),
          "rotated": os.path.join(DATA, "golden_plane_pair_rotated.npz")}
WARMUP, RUNS = 10, 50
GAP = 1e-5       # top-two orientation window gap below which either wins


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


def time_pair(kernel_fn, plain_fn):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain
    on the same card; each is the mean of its two turns' medians."""
    p1 = time_ms(plain_fn)
    k1 = time_ms(kernel_fn)
    k2 = time_ms(kernel_fn)
    p2 = time_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def circ_diff(a, b):
    """|a - b| on the circle, in radians."""
    return (torch.remainder(a - b + math.pi, 2 * math.pi) - math.pi).abs()


def check_kernel_a(cfg, frames_dev):
    """Kernel A vs hessian.response_pyramid + extrema._candidate_mask."""
    h, w = frames_dev[0].shape
    scheds = cfg.hessian_schedule(h, w)
    n_cand, err = 0, 0.0
    for img in frames_dev:
        ii = integral_image(img)
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
        raise AssertionError("kernel A: the pair produced no candidates")
    ii = integral_image(frames_dev[0])
    ms_k, ms_p = time_pair(
        lambda: fused_pyramid(ii, cfg, h, w),
        lambda: [_candidate_mask(p, s, cfg) for p, s in
                 zip(response_pyramid(ii, cfg, h, w), scheds)])
    emit(dict(phase="kernel_check", kernel="A", layers_bit_exact=True,
              masks_equal=True, max_abs_err=err, candidates=n_cand,
              octaves=cfg.noctaves))
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p)


def path_keypoints(frames_dev):
    """Per frame: (integral image, keypoints, kernel D's orientations) at
    the rotated config; detection is the same in every mode."""
    cfg = SurfConfig(**ROTATED_CONFIG)
    out = []
    for img in frames_dev:
        kp, _ = detect_and_compute(img, cfg, compute_descriptors=False)
        ii = integral_image(img)
        ori = assign_orientations(ii, cfg, kp.x, kp.y, kp.scale, kp.valid)
        out.append((ii, kp, ori))
    return out


def check_kernel_d(kps_dev):
    """Kernel D vs orientation.assign_orientations_plain on the pair's
    keypoints: 1e-4 rad where the gap is >= GAP, one of the two top
    windows below it, bit-identical across two launches."""
    cfg = SurfConfig(**ROTATED_CONFIG)
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
        gap, cand = top2_windows(*orientation_windows(ii, *args))
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
    emit(dict(phase="kernel_check", kernel="D", keypoints=n,
              max_abs_err=worst, near_ties=n_near,
              near_tie_max_err=worst_near, bit_identical=True))
    return dict(max_abs_err=worst, ms=ms_k, plain_ms=ms_p)


B_MODES = {"upright64": dict(upright=True, extended=False),
           "rotated64": dict(upright=False, extended=False),
           "upright128": dict(upright=True, extended=True),
           "rotated128": dict(upright=False, extended=True)}


def check_kernel_b(kps_dev):
    """Kernel B vs descriptor.describe_plain in all four modes, on the
    pair's keypoints (rotated modes at kernel D's orientations).
    -> (result, the rotated 128-d normalised rows of both frames)."""
    modes, rows128 = {}, []
    for mode, kw in B_MODES.items():
        cfg = SurfConfig(**dict(MAIN_CONFIG, **kw))
        worst_cos, worst_err, n_rows = 1.0, 0.0, 0
        for ii, kp, ori in kps_dev:
            geom = desc_geometry(cfg, kp.x, kp.y, kp.scale, ori)
            rows_k = descriptor_rows(ii, cfg, *geom, kp.valid)
            rows_p = describe_plain(ii, cfg, *geom, kp.valid)
            if rows_k.shape != (kp.capacity, cfg.nfeatures):
                raise AssertionError(f"kernel B {mode}: rows {rows_k.shape}")
            if not torch.all(rows_k[~kp.valid] == 0):
                raise AssertionError(f"kernel B {mode}: an invalid slot has "
                                     "a nonzero row")
            if not torch.equal(rows_k, descriptor_rows(ii, cfg, *geom,
                                                       kp.valid)):
                raise AssertionError(f"kernel B {mode}: two launches differ")
            nz = (rows_k.abs().sum(1) > 0) | (rows_p.abs().sum(1) > 0)
            cos = torch.nn.functional.cosine_similarity(
                rows_k[nz].double(), rows_p[nz].double(), dim=1, eps=1e-30)
            worst_cos = min(worst_cos, cos.min().item())
            worst_err = max(worst_err, (rows_k - rows_p).abs().max().item())
            n_rows += int(nz.sum())
            if mode == "rotated128":
                rows128.append(l2_normalize(rows_k))
        if worst_cos < 0.99999:
            raise AssertionError(f"kernel B {mode}: row cosine {worst_cos} "
                                 "< 0.99999")
        if n_rows == 0:
            raise AssertionError(f"kernel B {mode}: no keypoint to describe")
        ii, kp, ori = kps_dev[0]
        geom = desc_geometry(cfg, kp.x, kp.y, kp.scale, ori)
        ms_k, ms_p = time_pair(
            lambda: descriptor_rows(ii, cfg, *geom, kp.valid),
            lambda: describe_plain(ii, cfg, *geom, kp.valid))
        modes[mode] = dict(ms=ms_k, plain_ms=ms_p, min_cosine=worst_cos,
                           max_abs_err=worst_err)
        emit(dict(phase="kernel_check", kernel="B", mode=mode, rows=n_rows,
                  min_cosine=worst_cos, max_abs_err=worst_err,
                  bit_identical=True))
    main = modes["upright64"]
    return dict(max_abs_err=max(m["max_abs_err"] for m in modes.values()),
                ms=main["ms"], plain_ms=main["plain_ms"],
                modes=modes), rows128


def check_kernel_c(d1, d2, valid2):
    """Kernel C vs matcher_kernel._best2_plain at 4096 x 4096 x D."""
    bk, sk, ik = fused_best2(d1, d2, valid2)
    bp, sp, ip = _best2_plain(d1, d2, valid2)
    err = max((bk - bp).abs().max().item(), (sk - sp).abs().max().item())
    if err > 1e-5:
        raise AssertionError(f"kernel C: |d score| {err} > 1e-5")
    clear = (bp - sp) >= 1e-5
    if not torch.equal(ik[clear], ip[clear]):
        raise AssertionError("kernel C: index differs where best - second "
                             ">= 1e-5")
    ms_k, ms_p = time_pair(lambda: fused_best2(d1, d2, valid2),
                           lambda: _best2_plain(d1, d2, valid2))
    emit(dict(phase="kernel_check", kernel="C", max_abs_err=err,
              rows=int(d1.shape[0]), depth=int(d1.shape[1]),
              index_checked=int(clear.sum())))
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p)


def check_against_golden(kps, m, golden):
    for f, kp in enumerate(kps):
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
    mean_best = m.score[m.valid].mean().item()
    if abs(mean_best - float(golden["mean_best"])) > 2e-4:
        raise AssertionError(f"mean best score {mean_best} vs JAX golden "
                             f"{float(golden['mean_best'])}")
    return mean_best


def load_golden(path, config):
    golden = np.load(path)
    if str(golden["config"]) != repr(sorted(config.items())) or \
            str(golden["pair"]) != repr(sorted(MAIN_PAIR.items())):
        raise AssertionError(f"{path} is for another config or pair; rerun "
                             "tests/make_torch_golden.py")
    return golden


KERNELS = {"A": fused_octave, "B": descriptor_rows, "C": fused_best2,
           "D": assign_orientations}


def run_path(name, cfg, frames, golden, kernels):
    """Surf on the pair + match, counted; -> (kps, descs, matches, counts)
    with every kernel's launch count over this run alone.  The path must
    launch each kernel of `kernels` and no other."""
    for k in KERNELS.values():
        k.launches = 0
    surf = Surf(cfg, device="cuda")
    kps, descs = zip(*[surf.detect_and_compute(f) for f in frames])
    m = surf.match(kps[0], descs[0], kps[1], descs[1])
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels {missing} never launched on the "
                             f"{name} path")
    stray = [k for k in KERNELS if k not in kernels and counts[k]]
    if stray:
        raise AssertionError(f"kernels {stray} launched on the {name} path, "
                             "which does not run them")
    for kp, d in zip(kps, descs):
        if d.shape != (cfg.max_pts, cfg.nfeatures) or \
                not torch.isfinite(d).all():
            raise AssertionError(f"{name}: descriptors malformed")
        norms = d[kp.valid].norm(dim=1)
        if not torch.allclose(norms, torch.ones_like(norms), atol=1e-5):
            raise AssertionError(f"{name}: valid descriptors are not unit "
                                 "length")
        if not torch.all(d[~kp.valid] == 0):
            raise AssertionError(f"{name}: invalid descriptor rows are not "
                                 "zero")
        if not torch.isfinite(kp.ori).all() or \
                not torch.all(kp.ori[~kp.valid] == 0):
            raise AssertionError(f"{name}: orientations malformed")
    mean_best = check_against_golden(kps, m, golden)
    emit(dict(phase=f"{name}_path", keypoints=[int(k.count) for k in kps],
              golden_keypoints=golden["counts"].tolist(),
              matches=int(m.valid.sum()), mean_best=mean_best,
              golden_mean_best=float(golden["mean_best"]), launches=counts))
    return kps, descs, m, counts


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
    env = environment()
    card = env["card"]

    t0 = time.perf_counter()
    kl = _build.kernels()
    ptxas = [ln.strip() for ln in kl.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=kl.build_seconds, ptxas=ptxas))

    cfg = SurfConfig(**MAIN_CONFIG)
    cfg_rot = SurfConfig(**ROTATED_CONFIG)
    golden = load_golden(GOLDEN["upright"], MAIN_CONFIG)
    golden_rot = load_golden(GOLDEN["rotated"], ROTATED_CONFIG)
    frames = main_pair()
    frames_dev = [torch.as_tensor(f).cuda() for f in frames]

    res = {"A": check_kernel_a(cfg, frames_dev)}
    kps_dev = path_keypoints(frames_dev)
    res["D"] = check_kernel_d(kps_dev)
    res["B"], rows128 = check_kernel_b(kps_dev)

    kps, descs, m, counts = run_path("main", cfg, frames, golden, "ABC")
    kps_r, descs_r, m_r, counts_r = run_path("rotated", cfg_rot, frames,
                                             golden_rot, "ABCD")
    res["C"] = check_kernel_c(descs[0], descs[1], kps[1].valid)
    c128 = check_kernel_c(rows128[0], rows128[1], kps_dev[1][1].valid)
    res["C"].update(d128_ms=c128["ms"], d128_plain_ms=c128["plain_ms"],
                    max_abs_err=max(res["C"]["max_abs_err"],
                                    c128["max_abs_err"]))

    pair = lambda: [detect_and_compute(f, cfg) for f in frames_dev]
    pair_r = lambda: [detect_and_compute(f, cfg_rot) for f in frames_dev]
    match = lambda: match_keypoints(kps[0], descs[0], kps[1], descs[1])
    emit(dict(metric="pair_ms", value=time_ms(pair),
              wall_ms=time_wall_ms(pair), what="detect+describe of both "
              "1280x960 frames, device-resident input", card=card))
    emit(dict(metric="rotated_pair_ms", value=time_ms(pair_r),
              wall_ms=time_wall_ms(pair_r), what="detect+orientation+"
              "rotated describe of both 1280x960 frames, device-resident "
              "input", card=card))
    emit(dict(metric="match_ms", value=time_ms(match),
              wall_ms=time_wall_ms(match), what="4096 x 4096 left->right "
              "match", card=card))
    for k, r in res.items():
        emit(dict(metric=f"kernel_{k}_ms", value=r["ms"],
                  plain_ms=r["plain_ms"], card=card))
    for mode, r in res["B"]["modes"].items():
        emit(dict(metric=f"kernel_B_{mode}_ms", value=r["ms"],
                  plain_ms=r["plain_ms"], card=card))
    emit(dict(metric="kernel_C_d128_ms", value=res["C"]["d128_ms"],
              plain_ms=res["C"]["d128_plain_ms"], card=card))

    reference_pair(cfg)

    meta = {
        "A": ("octave_response_nms", "cuda_surf_tpu_torch/csrc/detect.cu",
              "cuda_surf_tpu/ops/fused_detect.py:148", None),
        "B": ("describe", "cuda_surf_tpu_torch/csrc/describe.cu",
              "cuda_surf_tpu/ops/patch_wavelets.py:369",
              ["cuda_surf_tpu/ops/patch_bucketed.py:70",
               "cuda_surf_tpu/ops/patch_common.py:147"]),
        "C": ("fused_best2", "cuda_surf_tpu_torch/csrc/match.cu",
              "cuda_surf_tpu/ops/matcher_pallas.py:42", None),
        "D": ("orient", "cuda_surf_tpu_torch/csrc/orient.cu",
              "cuda_surf_tpu/ops/patch_bucketed.py:70", None),
    }
    rows = []
    for k, (name, src, repl, also) in meta.items():
        row = dict(name=name, route="cuda", source=src, replaces=repl,
                   launches=counts_r[k],
                   launches_by_path=dict(main=counts[k],
                                         rotated=counts_r[k]),
                   max_abs_err=res[k]["max_abs_err"],
                   ms=res[k]["ms"], plain_ms=res[k]["plain_ms"])
        if also:
            row["also_replaces"] = also
        if k == "B":
            row["modes"] = res["B"]["modes"]
        if k == "C":
            row.update(d128_ms=res["C"]["d128_ms"],
                       d128_plain_ms=res["C"]["d128_plain_ms"])
        if k == "D":
            row["replaces_mode"] = "grids"
        rows.append(row)
    emit({"kernels": rows})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
