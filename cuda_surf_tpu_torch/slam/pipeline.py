"""Monocular visual-odometry pipeline (port of
cuda_surf_tpu/slam/pipeline.py).

Per frame: SURF features (kernels A and B on the card), frame-to-frame
tracking (kernel C, then RANSAC on the essential matrix), optionally a
two-view BA polish and a windowed BA over a keyframe map, then the
median-depth-ratio scale chain and the pose accumulation on the host.
With `loop_detect=True` each frame is also registered with a loop
detector and verified against earlier frames (kernel C and RANSAC again);
`optimize_posegraph` and `optimize_sim3` close the loops with the SE(3) or
the Sim(3) pose graph.  The numerics run on the pipeline's device; the host
reads the inlier count and the pair's geometry once a frame, and once a
loop verification, where the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .._build import require_device
from ..ba import BAProblem, BAState, run_lm
from ..config import SurfConfig
from ..frontend import Surf
from ..geometry.epipolar import normalize_with_intrinsics
from ..io.synth import Intrinsics
from ..utils.metrics import MetricsLogger
from ..utils.timing import span
from .loopclosure import LoopDetector, optimize_with_loops
from .mapping import KeyframeMap
from .sim3graph import optimize_with_loops_sim3
from .tracking import default_intrinsics, track_pair


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _refine_pair(res, kp1, intr: Intrinsics, n_iters: int = 5):
    """Two-view bundle adjustment polish of a tracked pair: the RANSAC
    relative pose and triangulated points refined by masked LM over the
    inlier reprojections (camera 0 gauge-fixed at identity).  Returns
    (R, t) with t renormalised to unit length (monocular gauge)."""
    m = res.matches
    x1 = normalize_with_intrinsics(torch.stack([kp1.x, kp1.y], -1),
                                   intr.fx, intr.fy, intr.cx, intr.cy)
    x2 = normalize_with_intrinsics(torch.stack([m.match_x, m.match_y], -1),
                                   intr.fx, intr.fy, intr.cx, intr.cy)
    P = x1.shape[0]
    dev = x1.device
    cam_idx = torch.arange(2, dtype=torch.int32, device=dev).repeat(P, 1)
    uv = torch.stack([x1, x2], 1)                          # (P, 2, 2)
    mask = torch.stack([res.inliers, res.inliers], 1)
    prob = BAProblem(cam_idx=cam_idx, uv=uv, mask=mask)
    state = BAState(
        R=torch.stack([torch.eye(3, device=dev), res.R]),
        t=torch.stack([torch.zeros(3, device=dev), res.t]),
        points=torch.where(res.inliers[:, None], res.points3d, 1.0))
    out, _ = run_lm(state, prob, n_iters=n_iters)
    R = out.R[1]
    t = out.t[1]
    return R, t / torch.clamp(torch.linalg.norm(t), min=1e-9)


@dataclasses.dataclass
class FrameState:
    index: int
    R: np.ndarray          # world->cam
    t: np.ndarray
    n_inliers: int
    is_keyframe: bool


class SlamPipeline:
    """`device="cuda"` runs the frontend's kernels and the geometry on the
    card and raises if there is none; `device="cpu"` runs the plain
    PyTorch versions.  RANSAC draws from one torch.Generator on the
    device, seeded with `seed`; `process(image, raw=...)` replaces a
    frame's draw, and `process(image, loop_raws={i: raw})` the draws of the
    loop verifications of pairs (i, this frame)."""

    def __init__(self, cfg: SurfConfig | None = None,
                 intrinsics: Intrinsics | None = None,
                 ratio: float = 0.95, min_inliers: int = 30,
                 keyframe_min_inlier_frac: float = 0.5,
                 ba_refine: bool = False, ba_iters: int = 5,
                 window_ba: int = 0, loop_detect: bool = False,
                 loop_min_gap: int = 5, loop_store: int | None = None,
                 seed: int = 0, metrics: MetricsLogger | None = None,
                 device="cuda"):
        self.device = require_device(device, "SlamPipeline")
        self.seed = seed
        self.cfg = cfg if cfg is not None else SurfConfig(
            max_pts=2048, candidates_per_octave=2048)
        self.surf = Surf(self.cfg, device=self.device)
        self.intr = intrinsics
        self.ratio = ratio
        self.min_inliers = min_inliers
        self.kf_frac = keyframe_min_inlier_frac
        self.ba_refine = ba_refine
        self.ba_iters = ba_iters
        self.window_ba = window_ba
        self.map = None
        self.loop_detect = loop_detect
        self.loop_min_gap = loop_min_gap
        # bound on frames keeping full loop-verification features (host
        # memory and checkpoint size; see LoopDetector.max_store)
        self.loop_store = loop_store
        self.loops = []
        self.frame_depths = []
        self._detector = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.metrics = metrics or MetricsLogger()
        self.frames: List[FrameState] = []
        self._prev = None          # (kps, desc)
        self._prev_depth = None    # median depth of last pair's landmarks
        self._prev_kp_depth = None  # (slots,) global-unit depths on the
        #                             previous frame's keypoint slots

    def reset(self):
        self.frames.clear()
        self._prev = None
        self._prev_depth = None
        self._prev_kp_depth = None
        self.loops = []
        self.frame_depths = []
        self.map = None
        self._detector = None

    def process(self, image, raw: torch.Tensor | None = None,
                loop_raws: dict | None = None) -> FrameState:
        """One frame, uint8 (H, W).  `raw` replaces this frame's RANSAC
        draw (see geometry.epipolar.ransac_essential); the first frame
        draws nothing.  `loop_raws` maps an earlier frame i to the draw of
        the loop verification of (i, this frame)."""
        with span("vo.process"):
            return self._process(image, raw, loop_raws)

    def _process(self, image, raw, loop_raws) -> FrameState:
        h, w = image.shape
        if self.intr is None:
            self.intr = default_intrinsics(h, w)
        kps, desc = self.surf.detect_and_compute(image)
        if self._prev is None:
            st = FrameState(0, np.eye(3), np.zeros(3), 0, True)
            self.frames.append(st)
            self._prev = (kps, desc)
            if self.window_ba:
                with span("vo.window_ba"):
                    self.map = KeyframeMap(self.intr, window=self.window_ba,
                                           device=self.device)
                    self.map.add_keyframe(kps, st.R, st.t)
            if self.loop_detect:
                self._detector = LoopDetector(self.intr,
                                              min_gap=self.loop_min_gap,
                                              max_store=self.loop_store,
                                              device=self.device)
                self._detector.add(kps, desc)
            self.frame_depths.append(1.0)
            self.metrics.log(frame=0, keypoints=int(kps.count), inliers=0)
            return st

        kp1, d1 = self._prev
        # called through the module's global: a caller may wrap it
        with span("vo.track"):
            res = track_pair(kp1, d1, kps, desc, self.intr, self.generator,
                             ratio=self.ratio, raw=raw)
        with span("vo.scale"):
            n_inl = int(res.n_inliers)
            if self.ba_refine and n_inl >= self.min_inliers:
                R_ref, t_ref = _refine_pair(res, kp1, self.intr,
                                            n_iters=self.ba_iters)
                R_rel = _np(R_ref).astype(np.float64)
                t_rel = _np(t_ref).astype(np.float64)
            else:
                R_rel = _np(res.R).astype(np.float64)
                t_rel = _np(res.t).astype(np.float64)

            # Monocular scale propagation.  Preferred: per-point depth
            # ratio over the physical points shared by consecutive pairs
            # (pair (k-2, k-1) left global-unit depths on frame k-1's
            # keypoint slots; pair (k-1, k) re-triangulates the same slots
            # in its own unit).  Fallback (too few shared points): the
            # whole-pair median-depth ratio.  Cheirality-consistent inliers
            # only: one negative median would flip the propagated scale
            # sign for the rest of the sequence.
            inl = _np(res.inliers)
            X3 = _np(res.points3d)
            z1 = X3[:, 2]                   # depth in cam_{k-1}, pair units
            z2 = X3 @ _np(res.R).astype(np.float64)[2] + float(res.t[2])
            pos = inl & (z1 > 1e-9) & (z2 > 1e-9)
            med_loc = float(np.median(z1[pos])) if pos.any() else 1.0
            scale = 1.0
            d_prev = self._prev_kp_depth
            shared = ((pos & np.isfinite(d_prev)) if d_prev is not None
                      else None)
            if shared is not None and shared.sum() >= 6:
                scale = float(np.median(d_prev[shared] / z1[shared]))
            elif self._prev_depth is not None and med_loc > 1e-6:
                scale = self._prev_depth / med_loc
            # fd[k]: the median scene depth seen from camera k, in
            # chain-gauge units (what the Sim(3) loop edges divide by); the
            # first pair also backfills fd[0]
            med_depth = ((float(np.median(z2[pos])) if pos.any() else 1.0)
                         * scale)

            prev = self.frames[-1]
            if n_inl < self.min_inliers:
                # tracking failure: keep the previous pose (constant model)
                # and leave the scale chain at the last good pair's value
                self._prev_kp_depth = None
                R_w, t_w = prev.R, prev.t
            else:
                if len(self.frames) == 1 and pos.any():
                    self.frame_depths[0] = med_loc * scale
                self._prev_depth = med_depth
                # global-unit depths on the CURRENT frame's matched slots
                idx = _np(res.matches.index)
                d_cur = np.full(int(kps.x.shape[0]), np.nan)
                ok = pos & (idx >= 0) & (idx < d_cur.shape[0])
                d_cur[idx[ok]] = scale * z2[ok]
                self._prev_kp_depth = d_cur
                R_w = R_rel @ prev.R
                t_w = R_rel @ prev.t + scale * t_rel
            is_kf = n_inl < self.kf_frac * max(int(kp1.count), 1)
            st = FrameState(len(self.frames), R_w, t_w, n_inl, is_kf)
            self.frames.append(st)
        if self.map is not None:
            with span("vo.window_ba"):
                self.map.add_keyframe(kps, st.R, st.t,
                                      match_index=res.matches.index,
                                      match_ok=res.inliers)
                cost = self.map.refine_window()
                if cost is not None:
                    # write refined window poses back into the trajectory
                    for kf in self.map.keyframes[-self.map.window:]:
                        self.frames[kf.index] = dataclasses.replace(
                            self.frames[kf.index], R=kf.R, t=kf.t)
                    st = self.frames[-1]
        self.frame_depths.append(self._prev_depth or 1.0)
        if self._detector is not None:
            self._detector.add(kps, desc)
            self.loops.extend(self._detector.query(raws=loop_raws))
        self._prev = (kps, desc)
        self.metrics.log(frame=st.index, keypoints=int(kps.count),
                         inliers=n_inl, keyframe=is_kf,
                         loops=len(self.loops))
        return st

    def trajectory(self) -> np.ndarray:
        """Camera centres (N, 3): c = -R^T t."""
        return np.stack([-f.R.T @ f.t for f in self.frames])

    def optimize_posegraph(self, n_iters: int = 10) -> float:
        """Global pose-graph smoothing over the whole trajectory: one SE(3)
        node a frame, chain edges from the recorded consecutive relative
        poses plus the detected loop-closure edges.  Returns the final
        summed edge residual."""
        if len(self.frames) < 3:
            return 0.0
        Ro, to, cost = optimize_with_loops(self.frames, self.loops,
                                           n_iters=n_iters,
                                           frame_depths=self.frame_depths,
                                           device=self.device)
        for i, f in enumerate(self.frames):
            self.frames[i] = dataclasses.replace(f, R=Ro[i], t=to[i])
        return cost

    def optimize_sim3(self, n_iters: int = 12) -> float:
        """Scale-drift-aware Sim(3) pose graph over the trajectory: loop
        edges carry the measured relative scale, so accumulated scale drift
        is spread around the cycle.  The scale is baked into the
        translations (t <- t / s, keeping the camera centres in one global
        scale).  Returns the final summed residual."""
        if len(self.frames) < 3 or not self.loops:
            return 0.0
        s, Ro, to, _, cost = optimize_with_loops_sim3(
            self.frames, self.loops, self.frame_depths, n_iters=n_iters,
            min_gap=self.loop_min_gap, device=self.device)
        for i, f in enumerate(self.frames):
            self.frames[i] = dataclasses.replace(
                f, R=Ro[i], t=to[i] / max(float(s[i]), 1e-12))
        return cost
