"""Keyframe map with landmark tracks + windowed bundle adjustment (port of
cuda_surf_tpu/slam/mapping.py).

Keyframes keep their SURF keypoints and pose; consecutive-keyframe
matches are chained into multi-view landmark tracks on the host (index
bookkeeping in numpy, as in the reference), and a sliding window of
keyframes is refined with the Schur-complement LM optimiser (`ba.run_lm`)
on the map's device, over a `BAProblem` of tracks padded to a capacity and
observations padded to the window size.  The window size changes as
keyframes arrive; in eager torch that costs nothing.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .._build import require_device
from ..ba import BAProblem, BAState, run_lm
from ..io.synth import Intrinsics


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass
class Keyframe:
    index: int                 # global frame index
    R: np.ndarray              # world->cam
    t: np.ndarray
    xy: np.ndarray             # (K, 2) keypoint pixel coords
    valid: np.ndarray          # (K,) bool
    track_id: np.ndarray       # (K,) int64, -1 = untracked


class KeyframeMap:
    """Sliding-window landmark map.

    add_keyframe() chains matches from the previous keyframe into landmark
    tracks; refine_window() runs windowed BA over the last `window`
    keyframes and updates their poses (the first window pose is
    gauge-fixed).
    """

    def __init__(self, intr: Intrinsics, window: int = 5,
                 max_tracks: int = 2048, ba_iters: int = 8,
                 device="cuda"):
        self.intr = intr
        self.window = window
        self.max_tracks = max_tracks
        self.ba_iters = ba_iters
        self.device = require_device(device, "KeyframeMap")
        self.keyframes: List[Keyframe] = []
        self._next_track = 0

    # -- host-side track bookkeeping ------------------------------------

    def add_keyframe(self, kps, pose_R, pose_t,
                     match_index=None, match_ok=None) -> Keyframe:
        """kps: Keypoints (on any device); match_index / match_ok: the
        previous -> this keyframe match assignment over PREVIOUS keypoint
        slots (from `Matches.index` and an inlier / ratio mask)."""
        xy = np.stack([_np(kps.x), _np(kps.y)], -1)
        valid = _np(kps.valid)
        tid = np.full(xy.shape[0], -1, np.int64)
        if self.keyframes and match_index is not None:
            prev = self.keyframes[-1]
            mi = _np(match_index)
            ok = _np(match_ok) & prev.valid
            for i in np.nonzero(ok)[0]:
                j = int(mi[i])
                if not valid[j] or tid[j] >= 0:
                    continue
                t = prev.track_id[i]
                if t < 0:
                    t = self._next_track
                    self._next_track += 1
                    prev.track_id[i] = t
                tid[j] = t
        kf = Keyframe(index=len(self.keyframes), R=np.asarray(pose_R),
                      t=np.asarray(pose_t), xy=xy, valid=valid,
                      track_id=tid)
        self.keyframes.append(kf)
        return kf

    # -- windowed BA ------------------------------------------------------

    def build_problem(self):
        """BAProblem over the current window.  Returns (prob, state,
        kf_window, track_ids) or None if the window has too little
        structure."""
        kfs = self.keyframes[-self.window:]
        M = len(kfs)
        if M < 2:
            return None
        # tracks with >= 2 observations in the window
        obs: dict[int, list] = {}
        for ci, kf in enumerate(kfs):
            for slot in np.nonzero(kf.track_id >= 0)[0]:
                obs.setdefault(int(kf.track_id[slot]), []).append(
                    (ci, kf.xy[slot]))
        tracks = [(t, o) for t, o in obs.items() if len(o) >= 2]
        if len(tracks) < 8:
            return None
        tracks = tracks[: self.max_tracks]
        P = self.max_tracks
        cam_idx = np.zeros((P, M), np.int32)
        uv = np.zeros((P, M, 2), np.float32)
        mask = np.zeros((P, M), bool)
        for p, (t, o) in enumerate(tracks):
            for ci, xy in o:
                cam_idx[p, ci] = ci
                uv[p, ci] = xy
                mask[p, ci] = True
        fx, fy, cx, cy = self.intr
        uvn = np.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)

        R = np.stack([kf.R for kf in kfs]).astype(np.float32)
        t = np.stack([kf.t for kf in kfs]).astype(np.float32)
        # points initialised by mid-point triangulation from the first and
        # last observations of each track (host, cheap)
        X = np.ones((P, 3), np.float32)
        for p, (tr, o) in enumerate(tracks):
            (c1, xy1), (c2, xy2) = o[0], o[-1]
            X[p] = _triangulate(R[c1], t[c1], R[c2], t[c2],
                                _norm(xy1, self.intr), _norm(xy2, self.intr))
        # drop tracks whose initial geometry is degenerate (behind a camera
        # or far off in reprojection), which would blow up the optimiser
        xc = np.einsum("cij,pj->pci", R, X) + t[None]          # (P, M, 3)
        z = xc[..., 2]
        uv_hat = xc[..., :2] / np.maximum(z[..., None], 1e-9)
        err = np.linalg.norm(uv_hat - uvn, axis=-1)
        good = ((z > 1e-3) & (err < 0.05)) | ~mask
        keep = good.all(axis=1) & mask.any(axis=1)
        mask &= keep[:, None]
        if int(mask.any(axis=1).sum()) < 8:
            return None
        dev = self.device
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        prob = BAProblem(torch.as_tensor(cam_idx, device=dev), f32(uvn),
                         torch.as_tensor(mask, device=dev))
        state = BAState(f32(R), f32(t), f32(X))
        return prob, state, kfs, [t for t, _ in tracks]

    def refine_window(self):
        """Run windowed BA and write refined poses back.  Returns the
        final cost, or None if the window was not optimisable."""
        built = self.build_problem()
        if built is None:
            return None
        prob, state, kfs, _ = built
        out, cost = run_lm(state, prob, n_iters=self.ba_iters)
        R = _np(out.R)
        t = _np(out.t)
        for ci, kf in enumerate(kfs):
            kf.R = R[ci]
            kf.t = t[ci]
        return float(cost)


def _norm(xy, intr: Intrinsics):
    return np.array([(xy[0] - intr.cx) / intr.fx,
                     (xy[1] - intr.cy) / intr.fy])


def _triangulate(R1, t1, R2, t2, x1, x2):
    """Linear midpoint triangulation of one correspondence (host)."""
    def ray(R, t, x):
        d = R.T @ np.array([x[0], x[1], 1.0])
        o = -R.T @ t
        return o, d / np.linalg.norm(d)

    o1, d1 = ray(R1, t1, x1)
    o2, d2 = ray(R2, t2, x2)
    b = o2 - o1
    d12 = d1 @ d2
    denom = 1.0 - d12 * d12
    if abs(denom) < 1e-9:
        return o1 + d1
    s = (b @ d1 - (b @ d2) * d12) / denom
    u = ((b @ d1) * d12 - b @ d2) / denom
    return 0.5 * ((o1 + s * d1) + (o2 + u * d2))
