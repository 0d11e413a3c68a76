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

    python tests/make_torch_golden.py [pair] [doubled] [batch]

With no argument it writes all of them (a few minutes on a CPU).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import torch  # noqa: E402

import cuda_surf_tpu as cst  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from cuda_surf_tpu.frontend import detect_and_compute_batch  # noqa: E402
from cuda_surf_tpu.ops.matcher import match_keypoints  # noqa: E402
from cuda_surf_tpu_torch.config import (  # noqa: E402
    BATCH_FRAMES, DOUBLED_CONFIG, DOUBLED_ROTATED_CONFIG, MAIN_CONFIG,
    ROTATED_CONFIG, SurfConfig)
from cuda_surf_tpu_torch.io.synth import (  # noqa: E402
    MAIN_PAIR, main_batch, main_pair)
from cuda_surf_tpu_torch.ops.integral import integral_image  # noqa: E402
from cuda_surf_tpu_torch.ops.orientation import (  # noqa: E402
    assign_orientations_plain, orientation_windows, top2_windows)
from torch_parity import check_orientations  # noqa: E402

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


def main() -> None:
    what = set(sys.argv[1:]) or {"pair", "doubled", "batch"}
    if "pair" in what:
        write(MAIN_CONFIG, "golden_plane_pair.npz")
        write(ROTATED_CONFIG, "golden_plane_pair_rotated.npz")
    if "doubled" in what:
        write(DOUBLED_CONFIG, "golden_plane_pair_doubled.npz")
        write(DOUBLED_ROTATED_CONFIG, "golden_plane_pair_doubled_rotated.npz")
    if "batch" in what:
        write_batch(MAIN_CONFIG, BATCH_FRAMES, "golden_plane_batch.npz")


if __name__ == "__main__":
    main()
