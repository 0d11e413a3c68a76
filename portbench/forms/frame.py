"""A frame: one `SlamPipeline.process` on the frame and its seeded RANSAC
draw, whose pose comes back on the host.  One pipeline serves the whole
run; it keeps the outputs of the orbit's first `start_frames` frames
(`held`), which the check follows from frame 0."""

from __future__ import annotations

import importlib

import numpy as np

from ..reference import surfref
from ..reference.judge import (angle_deg, dir_deg, differing, frame_gaps,
                               match_gaps, worst)
from ..reference.surfref.slam.tracking import default_intrinsics, track_pair
from . import Outputs


class Requests:
    """The pipeline module's `track_pair` is wrapped to keep each frame's
    pair result for the check (a reference kept, no work added).  Where
    the pipeline reaches its pair tracking some other way, the result is
    missing and the check counts the frame as not compared."""

    def __init__(self, lib, cfg: dict, inputs, device):
        self.inputs = inputs
        self._mod = importlib.import_module(lib.__name__ + ".slam.pipeline")
        self._track = self._mod.track_pair
        self.last = None

        def track_pair(*a, **k):
            self.last = self._track(*a, **k)
            return self.last

        self._mod.track_pair = track_pair
        self.pipe = self._mod.SlamPipeline(lib.SurfConfig(**cfg["surf"]),
                                           device=device, **cfg["pipeline"])
        self.held = []             # the Outputs of the orbit's first frames

    def close(self):
        self._mod.track_pair = self._track

    def __call__(self, i: int) -> Outputs:
        self.last = None
        prev = self.pipe._prev
        st = self.pipe.process(self.inputs.frames_of(i),
                               raw=self.inputs.raw_of(i))
        kps, desc = self.pipe._prev
        out = Outputs([kps], [desc],
                      [] if self.last is None else [self.last.matches],
                      track=self.last, state=st,
                      prev_kps=None if prev is None else prev[0])
        if self.inputs.frame_index(i) < self.inputs.mix["start_frames"]:
            self.held.append(out)
        return out


def _ratio(j) -> float:
    return j.cfg["pipeline"].get("ratio", 0.95)


def _tied(j, acc, p, kp1_r, kp2_r, m_r) -> bool:
    """Whether the good correspondences of the program's pair output `p`
    differ from the reference's (keypoints kp1_r -> kp2_r, matches m_r);
    counts the pair in `tied_pairs` where near ties explain every
    difference, and the rest in `untied_slots`."""
    n, untied = differing(p.prev_kps, p.kps[0], p.track.matches,
                          kp1_r, kp2_r, m_r, _ratio(j), j.limits)
    worst(acc, "untied_slots", untied)
    acc["tied_pairs"] = acc.get("tied_pairs", 0) + int(n > 0 and not untied)
    return n > 0


def judge(j, acc, i, out):
    inp = j.inputs
    cur = j.ref(inp.key_of(i), inp.frames_of(i))
    prev = j.ref(inp.key_of(i - 1), inp.frames_of(i - 1))
    frame_gaps(acc, out.kps[0], out.descs[0], *cur)
    if out.track is None or out.prev_kps is None:   # every window frame
        acc["uncompared"] += 1                      # has a pair to track
        return
    match_gaps(acc, out.track.matches, *prev, *cur, 1 << 30)
    h, w = inp.frames.shape[-2:]
    res = track_pair(*prev, *cur, default_intrinsics(h, w),
                     raw=inp.raw_of(i), ratio=_ratio(j))
    if _tied(j, acc, out, prev[0], cur[0], res.matches):
        return
    n_r = int(res.n_inliers)
    worst(acc, "inlier_gap",
          abs(int(out.track.n_inliers) - n_r) / max(n_r, 1))
    worst(acc, "rot_gap_deg", angle_deg(out.track.R.cpu(), res.R.cpu()))
    worst(acc, "dir_gap_deg", dir_deg(out.track.t.cpu(), res.t.cpu()))


def judge_held(j, acc, held):
    """The orbit's first frames against the reference's pipeline, which
    follows them from frame 0 with the same draws (windowed BA included),
    up to the first pair whose good correspondences differ: the world
    rotations each `process` returned, and the camera centres in units of
    the first pair's baseline (the monocular gauge)."""
    acc.setdefault("tied_pairs", 0)
    ref = Requests(surfref, j.cfg, j.inputs, j.device)
    try:
        first = -j.inputs.mix["setup_frames"]
        outs = [ref(first + k) for k in range(len(held))]
    finally:
        ref.close()
    centre = lambda s: -np.asarray(s.R, np.float64).T @ np.asarray(s.t)
    compared = 0
    for k, (p, r) in enumerate(zip(held, outs)):
        if k > 0:
            if p.track is None:
                acc["uncompared"] += 1
                break
            if _tied(j, acc, p, r.prev_kps, r.kps[0], r.track.matches):
                break
        worst(acc, "start_rot_gap_deg", angle_deg(p.state.R, r.state.R))
        worst(acc, "start_centre_gap",
              float(np.linalg.norm(centre(p.state) - centre(r.state))))
        compared += 1
    acc["start_frames_compared"] = compared
