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
doubled frame (a 2560x1920 integral image); kernel B on frame 0's
keypoints, upright / rotated x 64 / 128-d; B_stacked on every frame's
slots in one launch, 64-d; B_step, the static-step kernel at step 4; C on
the descriptors of frames 0 -> 1 at 64-d (C_d64) and 128-d (C_d128), on the
BATCH_FRAMES - 1 pairs of consecutive frames in one launch (C_pairs) and
in one launch a pair (C_each); D on frame 0's keypoints (D_frame) and on
the doubled frame's (D_doubled).  One JSON object per kernel: `kernel_us`, the device time of the
library call alone (CUDA events around it, `_build.record_launches`,
median of 20 calls after 3), `ms` as above, `device_ops` and `device_us`
from the profiler, and `sha`, a hash of the output's bytes, so that two
builds of the kernels can be held against each other bit for bit.

With --track it splits the visual-odometry path instead: `track_pair` on
the terrain fixture's 1280x960 pair (cuda_surf_tpu_torch/data/
golden_terrain_track.npz, card-resident keypoints at the main config) into
match (kernel C and its glue), filter + normalise, sampling, the five-point
solver (and its Durand-Kerner root step alone), the Sampson scoring of the
4096 slots x 2560 candidates, the two refits, recover_pose and the whole
call on the port's own draws; and one `lm_step` on bench.py's 8-camera x
512-point problem into the Schur build, the solve, the rest, and the whole
step, with `run_lm` for 10 iterations.

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
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from cuda_surf_tpu_torch import BatchSurf, SurfConfig, _build, match_keypoints
from cuda_surf_tpu_torch.ba import core as ba_core
from cuda_surf_tpu_torch.geometry import epipolar, fivepoint
from cuda_surf_tpu_torch.io.synth import Intrinsics, ba_problem
from cuda_surf_tpu_torch.slam.tracking import (filter_matches, track_inputs,
                                               track_pair)
from cuda_surf_tpu_torch.config import (BATCH_FRAMES, DOUBLED_CONFIG,
                                        DOUBLED_ROTATED_CONFIG, MAIN_CONFIG,
                                        ROTATED_CONFIG)
from cuda_surf_tpu_torch.frontend import (_make_keypoints, _spread_frames,
                                          detect_and_compute,
                                          detect_and_compute_batch)
from cuda_surf_tpu_torch.io import main_batch
from cuda_surf_tpu_torch.ops.descriptor import desc_geometry, l2_normalize
from cuda_surf_tpu_torch.ops.extrema import detect
from cuda_surf_tpu_torch.ops.fused_detect import fused_pyramid
from cuda_surf_tpu_torch.ops.integral import integral_image
from cuda_surf_tpu_torch.ops.matcher_kernel import fused_best2
from cuda_surf_tpu_torch.ops.orientation import assign_orientations
from cuda_surf_tpu_torch.ops.patch_wavelets import descriptor_rows, step_rows


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
    integrals = lambda: torch.stack([integral_image(im, cfg.doubled)
                                     for im in imgs])
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


KERNEL_MODES = {"upright64": dict(upright=True, extended=False),
                "rotated64": dict(upright=False, extended=False),
                "upright128": dict(upright=True, extended=True),
                "rotated128": dict(upright=False, extended=True)}


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


def kernel_table(imgs, runs, card, only, tag):
    """The kernels alone, one JSON object each; `only`: name prefixes."""
    wanted = lambda name: any(name.startswith(o) for o in only)

    def report(name, fn):
        if not wanted(name):
            return
        h = hashlib.sha256()
        for t in flatten(fn()):
            h.update(t.contiguous().cpu().numpy().tobytes())
        ops, us = device_ops(fn)
        print(json.dumps(dict(tag=tag, kernel=name, kernel_us=own_us(fn),
                              ms=event_ms(fn, runs), device_ops=ops,
                              device_us=us, sha=h.hexdigest()[:16],
                              card=card)), flush=True)

    cfg = SurfConfig(**MAIN_CONFIG)
    B, h, w = imgs.shape
    ii = torch.stack([integral_image(im) for im in imgs])
    report("A", lambda: fused_pyramid(ii[0], cfg, h, w))
    report("A_stack", lambda: fused_pyramid(ii, cfg, h, w))
    dcfg = SurfConfig(**DOUBLED_CONFIG)
    iid = integral_image(imgs[0], True)
    report("A_doubled", lambda: fused_pyramid(iid, dcfg, h, w))
    group = lambda g: any(o.startswith(g) or g.startswith(o) for o in only)
    if not any(group(g) for g in ("B_", "C_", "D_")):
        return

    kb, _ = detect_and_compute_batch(imgs, cfg, compute_descriptors=False)
    rcfg = SurfConfig(**ROTATED_CONFIG)
    ori = torch.stack([assign_orientations(ii[f], rcfg, kb.x[f], kb.y[f],
                                           kb.scale[f], kb.valid[f])
                       for f in range(B)])
    flat = lambda a: a.reshape(-1)
    frame = torch.arange(B, dtype=torch.int32,
                         device=ii.device).repeat_interleave(kb.x.shape[1])
    for mode, kw in KERNEL_MODES.items():
        c = SurfConfig(**dict(MAIN_CONFIG, **kw))
        g0 = desc_geometry(c, kb.x[0], kb.y[0], kb.scale[0], ori[0])
        report(f"B_{mode}",
               lambda: descriptor_rows(ii[0], c, *g0, kb.valid[0]))
        if not c.extended:
            g = desc_geometry(c, flat(kb.x), flat(kb.y), flat(kb.scale),
                              flat(ori))
            report(f"B_stacked_{mode}",
                   lambda: descriptor_rows(ii, c, *g, flat(kb.valid),
                                           frame=frame))
    g0 = desc_geometry(cfg, kb.x[0], kb.y[0], kb.scale[0], ori[0])
    v = kb.valid[0]
    report("B_step", lambda: step_rows(ii[0], cfg, *g0, v, elig=v, sd=4)[0])

    report("D_frame", lambda: assign_orientations(
        ii[0], rcfg, kb.x[0], kb.y[0], kb.scale[0], kb.valid[0]))
    if wanted("D_doubled"):
        drcfg = SurfConfig(**DOUBLED_ROTATED_CONFIG)
        kd, _ = detect_and_compute(imgs[0], drcfg, compute_descriptors=False)
        report("D_doubled", lambda: assign_orientations(
            iid, drcfg, kd.x, kd.y, kd.scale, kd.valid))
    if not group("C_"):
        return
    rows = {}
    for mode in ("upright64", "upright128"):
        c = SurfConfig(**dict(MAIN_CONFIG, **KERNEL_MODES[mode]))
        g = desc_geometry(c, flat(kb.x), flat(kb.y), flat(kb.scale), flat(ori))
        rows[mode] = l2_normalize(descriptor_rows(
            ii, c, *g, flat(kb.valid), frame=frame)).reshape(B, -1, c.nfeatures)
    d64, d128 = rows["upright64"], rows["upright128"]
    report("C_d64", lambda: fused_best2(d64[0], d64[1], kb.valid[1]))
    report("C_d128", lambda: fused_best2(d128[0], d128[1], kb.valid[1]))
    d1, d2, v2 = d64[:-1].contiguous(), d64[1:].contiguous(), \
        kb.valid[1:].contiguous()
    report("C_each", lambda: [fused_best2(d1[p], d2[p], v2[p])
                              for p in range(B - 1)])
    report("C_pairs", lambda: fused_best2(d1, d2, v2))


def track_stages():
    """[(name, fn)] of track_pair on the terrain fixture's pair and of one
    lm_step on bench.py's BA problem, each fn on fixed earlier outputs."""
    g = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "cuda_surf_tpu_torch", "data",
                             "golden_terrain_track.npz"))
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
