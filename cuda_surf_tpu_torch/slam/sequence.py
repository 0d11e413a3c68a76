"""Sequence harness (port of cuda_surf_tpu/slam/sequence.py): the
synthetic ground-truthed sequences (re-exported from io.synth),
`run_sequence` with atomic checkpoints, resume, a heartbeat and image-path
lists streamed through the prefetching loader, and the TUM / KITTI loaders
(numpy only, copied).
"""

from __future__ import annotations

import glob
import os
from typing import NamedTuple

import numpy as np

from ..io.native import FrameLoader
from ..io.synth import (Intrinsics, render_forward_sequence,  # noqa: F401
                        render_plane_sequence, render_terrain_sequence)
from ..parallel.elastic import Heartbeat
from .checkpoint import load_pipeline, save_pipeline
from .evaluate import ate_rmse
from .pipeline import SlamPipeline


class SequenceResult(NamedTuple):
    trajectory: np.ndarray          # (N, 3) estimated camera centres
    gt: np.ndarray | None           # (N, 3) ground-truth centres
    ate: float | None
    inliers: np.ndarray             # (N,)


def _latest_pipeline_ckpt(directory: str):
    files = sorted(glob.glob(os.path.join(directory, "pipeline_*.npz")))
    return files[-1] if files else None


def _save_pipeline_atomic(directory: str, pipe: SlamPipeline, k: int,
                          keep: int = 3):
    """Torn-write-immune checkpoint: a kill mid-save leaves only a temp file
    that resume ignores.  Snapshots beyond the newest `keep` are pruned."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_{os.getpid()}.npz")
    save_pipeline(tmp, pipe)
    os.replace(tmp, os.path.join(directory, f"pipeline_{k:09d}.npz"))
    old = sorted(glob.glob(os.path.join(directory, "pipeline_*.npz")))
    for path in old[: max(0, len(old) - keep)]:
        try:
            os.remove(path)
        except OSError:
            pass


def run_sequence(pipe: SlamPipeline, frames, gt: np.ndarray | None = None,
                 prefetch_depth: int = 4,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 25,
                 heartbeat_path: str | None = None) -> SequenceResult:
    """Drive the pipeline over `frames` (an array of images, or a list of
    image paths streamed through the prefetching FrameLoader) and evaluate
    the trajectory's ATE against `gt` (Sim(3)-aligned).

    With `checkpoint_dir`, the pipeline's state is checkpointed atomically
    every `checkpoint_every` frames and at the end; running the same call
    again after a crash resumes after the newest complete checkpoint and
    gives the same trajectory.  With `heartbeat_path`, a liveness file is
    published for an external watchdog (parallel.elastic.Heartbeat)."""
    n_total = len(frames)
    start = 0
    if checkpoint_dir is not None:
        ck = _latest_pipeline_ckpt(checkpoint_dir)
        if ck is not None:
            load_pipeline(ck, pipe)
            start = min(len(pipe.frames), n_total)
    rest = frames[start:] if start else frames
    if len(rest) and isinstance(rest[0], str):
        it = FrameLoader(list(rest), depth=prefetch_depth)
    else:
        it = iter(rest)
    hb = None
    if heartbeat_path is not None:
        hb = Heartbeat(heartbeat_path).start()
    try:
        for k, f in enumerate(it, start=start):
            pipe.process(np.asarray(f))
            if hb is not None:
                hb.beat(k)
            if (checkpoint_dir is not None and (k + 1) % checkpoint_every
                    == 0 and k + 1 < n_total):
                _save_pipeline_atomic(checkpoint_dir, pipe, k + 1)
        if checkpoint_dir is not None and n_total > start:
            _save_pipeline_atomic(checkpoint_dir, pipe, n_total)
    finally:
        if hb is not None:
            hb.stop()
        if isinstance(it, FrameLoader):
            it.close()
    traj = pipe.trajectory()
    inl = np.asarray([s.n_inliers for s in pipe.frames])
    ate = None
    if gt is not None:
        ate = ate_rmse(traj, np.asarray(gt), with_scale=True)
    return SequenceResult(trajectory=traj, gt=gt, ate=ate, inliers=inl)


def load_image_dir(path: str, pattern: str = "*") -> list:
    """Sorted image paths from a directory (PGM/PPM/PNG), for streaming
    through run_sequence / the native FrameLoader."""
    exts = (".pgm", ".ppm", ".png")
    files = sorted(p for p in glob.glob(os.path.join(path, pattern))
                   if os.path.splitext(p)[1].lower() in exts)
    if not files:
        raise FileNotFoundError(f"no images under {path!r}")
    return files


def load_tum_trajectory(path: str) -> tuple:
    """Parse a TUM-format trajectory file (lines of `timestamp tx ty tz
    qx qy qz qw`, '#' comments) -> (timestamps (N,), centres (N, 3),
    quaternions (N, 4) in xyzw order) — the ground-truth format of the
    TUM RGB-D benchmark, consumed by evaluate.ate_rmse."""
    ts, cs, qs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) < 8:
                continue
            ts.append(vals[0])
            cs.append(vals[1:4])
            qs.append(vals[4:8])
    return (np.asarray(ts), np.asarray(cs), np.asarray(qs))


def load_kitti_poses(path: str) -> tuple:
    """Parse a KITTI odometry poses file (lines of 12 floats: the
    row-major 3x4 cam-to-world matrix [R|t]) -> (poses (N, 4, 4),
    centres (N, 3)).  Centres feed evaluate.ate_rmse directly."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) == 12:
                rows.append(vals)
    if not rows:
        raise ValueError(f"no 3x4 pose rows in {path!r}")
    P = np.asarray(rows).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (len(P), 1, 1))
    poses[:, :3, :] = P
    return poses, P[:, :, 3].copy()


def load_kitti_calib(path: str, camera: int = 0) -> "Intrinsics":
    """Parse a KITTI odometry calib.txt (`P0: <12 floats>` rows, one
    per camera) into the pinhole Intrinsics of the chosen camera."""
    key = f"P{camera}:"
    with open(path) as f:
        for line in f:
            if line.startswith(key):
                vals = [float(v) for v in line.split()[1:]]
                P = np.asarray(vals).reshape(3, 4)
                return Intrinsics(fx=float(P[0, 0]), fy=float(P[1, 1]),
                                  cx=float(P[0, 2]), cy=float(P[1, 2]))
    raise ValueError(f"no {key} row in {path!r}")


def load_kitti_times(path: str) -> np.ndarray:
    """Parse a KITTI odometry times.txt (one timestamp per line)."""
    with open(path) as f:
        return np.asarray([float(line) for line in f if line.strip()])


def associate_timestamps(t_a, t_b, max_dt: float = 0.02):
    """Nearest-neighbour association of two timestamp lists (the TUM
    benchmark's associate step): returns index pairs (i, j)."""
    t_a = np.asarray(t_a)
    t_b = np.asarray(t_b)
    j = np.searchsorted(t_b, t_a)
    j = np.clip(j, 1, len(t_b) - 1)
    j = np.where(np.abs(t_b[j] - t_a) < np.abs(t_b[j - 1] - t_a), j, j - 1)
    ok = np.abs(t_b[j] - t_a) <= max_dt
    return np.stack([np.nonzero(ok)[0], j[ok]], axis=1)
