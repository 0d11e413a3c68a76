"""Two-image detect + match demo CLI (port of cuda_surf_tpu/demo.py).

The counterpart of the reference demo executable (main.cpp:74-283,
cudaSurfDemo / cudaSurfDemo2): loads a grayscale pair, runs detect +
describe over `--iters` timed repeats and matching over as many, prints
per-stage averages (CUDA events on the card) and writes annotated keypoint
and match images.  With no image arguments it reads left.pgm / right.pgm
from the directory named by the environment variable SURF_REFERENCE_DATA,
and, where that is unset or lacks them, the rendered 1280x960 pair
io.main_pair().

    python -m cuda_surf_tpu_torch.demo [left.pgm right.pgm] --iters 100 \
        --out-dir . [--rotated] [--doubled] [--octaves 4] [--thresh 4.0] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import Surf, SurfConfig
from .io import imread_gray, main_pair, write_ppm
from .utils.timing import Timer, benchmark
from .viz import draw_keypoints, draw_matches, host

REFERENCE_DATA = os.environ.get("SURF_REFERENCE_DATA", "")


def _default_images(names):
    """The reference images under SURF_REFERENCE_DATA, or the rendered main
    pair; -> (labels, uint8 images)."""
    paths = [os.path.join(REFERENCE_DATA, n) for n in names]
    if REFERENCE_DATA and all(os.path.exists(p) for p in paths):
        return paths, [imread_gray(p) for p in paths]
    pair = main_pair()
    return ["rendered main pair, frame 0", "rendered main pair, frame 1"][
        :len(names)], list(pair[:len(names)])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("images", nargs="*", help="two grayscale images "
                    "(default: the reference pair, else the rendered pair)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--octaves", type=int, default=4)
    ap.add_argument("--thresh", type=float, default=4.0)
    ap.add_argument("--rotated", action="store_true",
                    help="rotation-invariant descriptors (the demo's "
                    "default is upright, main.cpp:196)")
    ap.add_argument("--doubled", action="store_true")
    ap.add_argument("--extended", action="store_true",
                    help="128-d descriptors")
    ap.add_argument("--max-pts", type=int, default=4096)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--no-images", action="store_true")
    ap.add_argument("--single", action="store_true",
                    help="single-image detect benchmark (the reference's "
                    "cudaSurfDemo, main.cpp:74-160; default iters 1000)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels; the default) or "
                    "cpu (their plain PyTorch versions)")
    args = ap.parse_args(argv)
    cfg = SurfConfig(noctaves=args.octaves, thresh=args.thresh,
                     upright=not args.rotated, doubled=args.doubled,
                     extended=args.extended, max_pts=args.max_pts,
                     candidates_per_octave=args.max_pts)
    surf = Surf(cfg, device=args.device)
    dev = surf.device

    if args.single:
        if args.images:
            labels, imgs = args.images[:1], [imread_gray(args.images[0])]
        else:
            labels, imgs = _default_images(["left.pgm"])
        img = torch.as_tensor(imgs[0], device=dev)
        kps, _ = surf.detect_and_compute(img)
        iters = args.iters if args.iters != 100 else 1000
        ms = benchmark(surf.detect_and_compute, img, iters=iters, warmup=1,
                       device=dev)
        print(f"{labels[0]}: {int(kps.count)} keypoints, "
              f"{ms:.3f} ms/frame over {iters} iterations")
        return

    if args.images:
        if len(args.images) != 2:
            ap.error("expected exactly two images")
        labels, imgs = args.images, [imread_gray(p) for p in args.images]
    else:
        labels, imgs = _default_images(["left.pgm", "right.pgm"])
    img1, img2 = imgs
    for k, (label, img) in enumerate(zip(labels, imgs), 1):
        print(f"image {k}: {label} {img.shape[1]}x{img.shape[0]}")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device:  {name}")
    d1 = torch.as_tensor(img1, device=dev)
    d2 = torch.as_tensor(img2, device=dev)

    # first call: builds the kernels on the card
    with Timer() as t:
        kp1, desc1 = surf.detect_and_compute(d1)
        kp2, desc2 = surf.detect_and_compute(d2)
    print(f"first call: {t.elapsed_ms / 1e3:.1f}s")
    print(f"keypoints: {int(kp1.count)} / {int(kp2.count)}")

    # the reference's timing protocol (main.cpp:239-259): both images an
    # iteration, matching timed on its own
    pair = lambda: (surf.detect_and_compute(d1), surf.detect_and_compute(d2))
    detect_ms = benchmark(pair, iters=args.iters, warmup=1, device=dev)
    match = lambda: surf.match(kp1, desc1, kp2, desc2)
    match_ms = benchmark(match, iters=args.iters, warmup=1, device=dev)
    m = match()

    score = m.score.cpu().numpy()
    valid = m.valid.cpu().numpy()
    good = valid & (m.ambiguity.cpu().numpy() < 0.95)
    print(f"detect+describe (pair): {detect_ms:.3f} ms "
          f"({detect_ms / 2:.3f} ms/frame)")
    print(f"match:                  {match_ms:.3f} ms")
    print(f"matches: {int(valid.sum())} "
          f"(ratio-test keep {int(good.sum())}, "
          f"mean score {float(score[valid].mean()):.4f})")

    if not args.no_images:
        kp1h, kp2h = host(kp1), host(kp2)
        os.makedirs(args.out_dir, exist_ok=True)
        p1 = os.path.join(args.out_dir, "surf_show1.ppm")
        p2 = os.path.join(args.out_dir, "surf_show2.ppm")
        pm = os.path.join(args.out_dir, "surf_show_matched.ppm")
        write_ppm(p1, draw_keypoints(np.asarray(img1), kp1h))
        write_ppm(p2, draw_keypoints(np.asarray(img2), kp2h))
        write_ppm(pm, draw_matches(np.asarray(img1), kp1h, np.asarray(img2),
                                   kp2h, host(m)))
        print(f"wrote {p1}, {p2}, {pm}")


if __name__ == "__main__":
    main()
