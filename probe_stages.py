"""Per-stage cost of one frame of the port's two paths on one NVIDIA GPU.

Splits `frontend.detect_and_compute` on frame 0 of the 1280x960 main pair
(cuda_surf_tpu_torch.io.main_pair, on the card) into its stages, at the
main config (upright) and the rotated config (upright=False): integral
image, kernel A, detection (compaction + subpixel walk), makePoint +
Laplacian sign, orientation (kernel D, rotated only), descriptor
geometry, kernel B's rows, normalisation, and the whole frame.  Each
stage runs on the outputs of the stages before it.  For each it prints

  - `ms`: device time with CUDA events, median of --runs calls after 5
    warm-up calls (glue included: a launch-bound stage reads its host
    time here);
  - `device_ops` and `device_us`: the operations one call put on the
    device (kernels, memsets, copies) and their summed device time, from
    one call under torch.profiler;

and for the whole frame the device busy share, device_us over ms.  One
JSON object per stage, then a markdown table of both paths.

    python3 probe_stages.py [--runs 30]

With no CUDA device it exits with code 2 before printing any result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from cuda_surf_tpu_torch import SurfConfig
from cuda_surf_tpu_torch.config import MAIN_CONFIG, ROTATED_CONFIG
from cuda_surf_tpu_torch.frontend import _make_keypoints, detect_and_compute
from cuda_surf_tpu_torch.io import main_pair
from cuda_surf_tpu_torch.ops.descriptor import desc_geometry, l2_normalize
from cuda_surf_tpu_torch.ops.extrema import detect
from cuda_surf_tpu_torch.ops.fused_detect import fused_pyramid
from cuda_surf_tpu_torch.ops.integral import integral_image
from cuda_surf_tpu_torch.ops.orientation import assign_orientations
from cuda_surf_tpu_torch.ops.patch_wavelets import descriptor_rows


ORDER = ("integral image", "kernel A, all octaves", "detect: compaction + walk",
         "makePoint + Laplacian", "orientation (kernel D + mask)",
         "descriptor geometry", "kernel B rows", "normalise",
         "one frame, whole")


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


def stages(cfg: SurfConfig, img: torch.Tensor):
    """[(name, fn)] of one frame, each fn on fixed earlier outputs."""
    h, w = img.shape
    sched = cfg.hessian_schedule(h, w)
    ii = integral_image(img)
    pyr, masks = fused_pyramid(ii, cfg, h, w)
    cand = detect(pyr, sched, cfg, cand_masks=masks)
    _, valid, x, y, scale, *_ = _make_keypoints(ii, cand, cfg)
    orient = lambda: torch.where(
        valid, assign_orientations(ii, cfg, x, y, scale, valid), 0.0)
    ori = torch.zeros_like(x) if cfg.upright else orient()
    geom = desc_geometry(cfg, x, y, scale, ori)
    rows = descriptor_rows(ii, cfg, *geom, valid)
    out = [("integral image", lambda: integral_image(img)),
           ("kernel A, all octaves", lambda: fused_pyramid(ii, cfg, h, w)),
           ("detect: compaction + walk",
            lambda: detect(pyr, sched, cfg, cand_masks=masks)),
           ("makePoint + Laplacian", lambda: _make_keypoints(ii, cand, cfg))]
    if not cfg.upright:
        out.append(("orientation (kernel D + mask)", orient))
    out += [("descriptor geometry",
             lambda: desc_geometry(cfg, x, y, scale, ori)),
            ("kernel B rows", lambda: descriptor_rows(ii, cfg, *geom, valid)),
            ("normalise",
             lambda: torch.where(valid[:, None], l2_normalize(rows), 0.0)),
            ("one frame, whole", lambda: detect_and_compute(img, cfg))]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_stages: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    img = torch.as_tensor(main_pair()[0]).cuda()
    table = {}
    for path, config in (("upright", MAIN_CONFIG), ("rotated", ROTATED_CONFIG)):
        for name, fn in stages(SurfConfig(**config), img):
            ms = event_ms(fn, args.runs)
            ops, us = device_ops(fn)
            row = dict(path=path, stage=name, ms=ms, device_ops=ops,
                       device_us=us, card=card)
            if name == "one frame, whole" and us is not None:
                row["busy_share"] = us / 1e3 / ms
            print(json.dumps(row), flush=True)
            table.setdefault(name, {})[path] = row
    print(f"\n{card}; CUDA events, median of {args.runs}; torch.profiler\n")
    print("| Stage | upright ms | ops | device µs | rotated ms | ops | device µs |")
    print("|---|---|---|---|---|---|---|")
    cell = lambda r: ("— | — | —" if r is None else
                      f"{r['ms']:.3f} | {r['device_ops']} | "
                      + ("—" if r["device_us"] is None
                         else f"{r['device_us']:.1f}"))
    for name in sorted(table, key=ORDER.index):
        r = table[name]
        print(f"| {name} | {cell(r.get('upright'))} | {cell(r.get('rotated'))} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
