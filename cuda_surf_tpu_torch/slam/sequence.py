"""Sequence harness (port of the parts of cuda_surf_tpu/slam/sequence.py
that the visual-odometry path needs): the synthetic ground-truthed
sequences, re-exported from io.synth, and `run_sequence` over frames in
memory.  Checkpointing, the heartbeat, image-path lists and the TUM /
KITTI loaders are not ported yet (ROADMAP item 14b) and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..io.synth import (Intrinsics, render_forward_sequence,  # noqa: F401
                        render_plane_sequence, render_terrain_sequence)
from .evaluate import ate_rmse
from .pipeline import SlamPipeline


class SequenceResult(NamedTuple):
    trajectory: np.ndarray          # (N, 3) estimated camera centres
    gt: np.ndarray | None           # (N, 3) ground-truth centres
    ate: float | None
    inliers: np.ndarray             # (N,)


def run_sequence(pipe: SlamPipeline, frames, gt: np.ndarray | None = None,
                 checkpoint_dir: str | None = None,
                 heartbeat_path: str | None = None) -> SequenceResult:
    """Drive the pipeline over `frames` (an array of images) and evaluate
    the trajectory's ATE against `gt` (Sim(3)-aligned)."""
    missing = [name for name, v in (("checkpoint_dir", checkpoint_dir),
                                     ("heartbeat_path", heartbeat_path))
               if v is not None]
    if len(frames) and isinstance(frames[0], str):
        missing.append("a list of image paths")
    if missing:
        raise NotImplementedError(
            f"run_sequence: {', '.join(missing)} is not ported to the "
            "PyTorch package yet (ROADMAP item 14b)")
    for f in frames:
        pipe.process(np.asarray(f))
    traj = pipe.trajectory()
    inl = np.asarray([s.n_inliers for s in pipe.frames])
    ate = None
    if gt is not None:
        ate = ate_rmse(traj, np.asarray(gt), with_scale=True)
    return SequenceResult(trajectory=traj, gt=gt, ate=ate, inliers=inl)
