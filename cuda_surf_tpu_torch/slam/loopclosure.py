"""Loop-closure detection and pose-graph integration (port of
cuda_surf_tpu/slam/loopclosure.py).

Candidate loop pairs are scored with the same matcher as tracking (kernel
C on the card) and verified with RANSAC on the essential matrix; accepted
closures become extra pose-graph edges.  Monocular: a loop's translation
is a direction, scaled from the per-frame depths (or the estimated
baseline) when it becomes an edge.

Each pair (i, j) draws from its own generator, seeded from the detector's
seed and i * 100003 + j on the detector's device, so the verdict on a pair
does not depend on how many verifications ran before it (the reference
folds the same number into its key).  `query(j, raws={i: raw})` replaces
a pair's draw, as `track_pair(..., raw=)` does.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .._build import require_device
from ..io.synth import Intrinsics
from ..types import keypoints_from_numpy, keypoints_to_numpy
from .posegraph import PoseGraph, edge_residuals, optimize
from .tracking import track_pair


class LoopClosure(NamedTuple):
    i: int                  # earlier frame index
    j: int                  # later frame index
    R: np.ndarray           # relative rotation cam_i -> cam_j
    t: np.ndarray           # unit-norm relative translation
    n_inliers: int
    med_depth: float        # median inlier depth in cam_i, in the pair's
                            # unit-baseline gauge (scale recovery)
    med_depth_j: float = 0.0  # the same points' median depth in cam_j;
                            # the i / j ratio cancels genuine scene-depth
                            # variation out of the Sim(3) scale measurement


def pair_seed(seed: int, i: int, j: int) -> int:
    """The seed of pair (i, j)'s generator."""
    return (seed << 32) + i * 100003 + j


class LoopDetector:
    """Verifies candidate loop pairs with matcher + RANSAC.

    Frames are registered with their keypoints and descriptors, which are
    kept on the host; `query(j)` checks frame j against frames i <= j -
    min_gap and returns the verified closures.  Only the query frame and
    its <= `prescreen_topk` candidates are uploaded to the device, a query
    at a time.

    Appearance prescreen: each frame keeps a pooled descriptor signature
    (the L2-normalised sum of its valid descriptors); a query scores all
    stored signatures with one host matmul and verifies only the
    `prescreen_topk` most similar candidates with cosine >=
    `prescreen_min_sim` (`prescreen_topk=None`: every candidate).
    `max_store` caps how many frames keep their full features (ring
    eviction, oldest first); signatures are kept for all frames, but loops
    to evicted frames can no longer be verified.  `verified` records
    (i, j, inliers) of every verification, in order.
    """

    def __init__(self, intr: Intrinsics, min_gap: int = 5,
                 min_inliers: int = 60, ratio: float = 0.9, seed: int = 1,
                 prescreen_topk: int | None = 3,
                 prescreen_min_sim: float = 0.5,
                 max_store: int | None = None, device="cuda"):
        if max_store is not None and max_store < 1:
            raise ValueError(f"max_store must be >= 1, got {max_store}")
        self.device = require_device(device, "LoopDetector")
        self.intr = intr
        self.min_gap = min_gap
        self.min_inliers = min_inliers
        self.ratio = ratio
        self.seed = seed
        self.prescreen_topk = prescreen_topk
        self.prescreen_min_sim = prescreen_min_sim
        self.max_store = max_store
        # host store: entry = (keypoint fields as numpy, descriptors), or
        # None after ring eviction
        self._frames: List[tuple | None] = []
        self._sigs: List[np.ndarray] = []
        self.n_verifications = 0
        self.verified: List[tuple] = []

    @staticmethod
    def _signature(kps: dict, desc) -> np.ndarray:
        d = np.asarray(desc, np.float32)
        v = np.asarray(kps["valid"], np.float32)
        s = (d * v[:, None]).sum(0)
        n = np.linalg.norm(s)
        return s / n if n > 1e-12 else s

    def add(self, kps, desc) -> int:
        """Register a frame's keypoints (Keypoints on any device, or a dict
        of numpy fields) and descriptors; -> its index."""
        host = (kps if isinstance(kps, dict) else keypoints_to_numpy(kps),
                desc.cpu().numpy() if isinstance(desc, torch.Tensor)
                else np.asarray(desc))
        self._frames.append(host)
        self._sigs.append(self._signature(*host))
        if self.max_store is not None:
            live = [f for f, v in enumerate(self._frames) if v is not None]
            for f in live[:max(0, len(live) - self.max_store)]:
                self._frames[f] = None
        return len(self._frames) - 1

    def _candidates(self, j: int) -> List[int]:
        hi = j - self.min_gap + 1
        if hi <= 0:
            return []
        stored = [i for i in range(hi) if self._frames[i] is not None]
        if self.prescreen_topk is None or len(stored) <= self.prescreen_topk:
            return stored
        sims = np.stack([self._sigs[i] for i in stored]) @ self._sigs[j]
        order = np.argsort(-sims)[: self.prescreen_topk]
        return sorted(stored[int(i)] for i in order
                      if sims[i] >= self.prescreen_min_sim)

    def _upload(self, f: int):
        kps, desc = self._frames[f]
        return (keypoints_from_numpy(kps, self.device),
                torch.as_tensor(desc, device=self.device))

    def query(self, j: int | None = None,
              raws: Dict[int, torch.Tensor] | None = None
              ) -> List[LoopClosure]:
        """Verify frame j (default: the newest) against its candidates.
        `raws` maps a candidate i to the RANSAC draw of pair (i, j), in place
        of the pair's generator."""
        if j is None:
            j = len(self._frames) - 1
        if self._frames[j] is None:
            raise ValueError(
                f"frame {j} was evicted by the max_store={self.max_store} "
                "ring cap; query frames before they age out")
        cands = self._candidates(j)
        if not cands:
            return []
        kpj, dj = self._upload(j)
        out = []
        for i in cands:
            kpi, di = self._upload(i)
            raw = None if raws is None else raws.get(i)
            gen = None
            if raw is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(pair_seed(self.seed, i, j))
            res = track_pair(kpi, di, kpj, dj, self.intr, gen,
                             ratio=self.ratio, raw=raw)
            self.n_verifications += 1
            n = int(res.n_inliers)
            self.verified.append((i, j, n))
            if n >= self.min_inliers:
                inl = res.inliers.cpu().numpy()
                X3 = res.points3d.cpu().numpy()
                R_l = res.R.cpu().numpy().astype(np.float64)
                t_l = res.t.cpu().numpy().astype(np.float64)
                z_i = X3[:, 2]
                z_j = X3 @ R_l[2] + float(res.t[2])
                pos = inl & (z_i > 0) & (z_j > 0)  # cheirality-consistent
                med = float(np.median(z_i[pos])) if pos.any() else 1.0
                med_j = float(np.median(z_j[pos])) if pos.any() else 1.0
                out.append(LoopClosure(i=i, j=j, R=R_l, t=t_l, n_inliers=n,
                                       med_depth=med, med_depth_j=med_j))
        return out


def optimize_with_loops(frames, closures: List[LoopClosure],
                        n_iters: int = 15, loop_weight: float = 2.0,
                        max_rot: float = 0.6, max_trans: float = 3.0,
                        frame_depths=None, robust_delta: float = 0.1,
                        reject_residual: float | None = 1.0,
                        device="cuda"):
    """SE(3) pose-graph optimisation of a frame chain plus loop edges, on
    `device` (the card unless "cpu").

    `frames`: objects with .R (world->cam) and .t (the pipeline's
    FrameState).  Each loop's unit translation is scaled by frame_depths[i]
    / med_depth (the closure's own triangulation) when `frame_depths` is
    given, else by the estimated baseline between its ends.  Only grossly
    inconsistent loops are gated a priori (`max_rot` radians, `max_trans` x
    baseline against the chain); Huber IRLS (`robust_delta`) handles the
    rest, and a loop whose residual stays above `reject_residual` after the
    robust pass is cut and the graph re-optimised.  If every loop is cut,
    the chain is returned untouched.  -> (R (N,3,3), t (N,3), final_cost).
    """
    device = require_device(device, "optimize_with_loops")
    n = len(frames)
    Ri = np.stack([f.R for f in frames])
    ti = np.stack([f.t for f in frames])
    edge_i = list(range(n - 1))
    edge_j = list(range(1, n))
    rel_R = list(np.einsum("nij,nik->njk", Ri[:-1], Ri[1:]))
    rel_t = list(np.einsum("nij,ni->nj", Ri[:-1], ti[1:] - ti[:-1]))
    weight = [1.0] * (n - 1)

    centres = np.stack([-Ri[k].T @ ti[k] for k in range(n)])
    for lc in closures:
        # the detector measures T_j = T_rel T_i; pose-graph edges are
        # T_i^-1 T_j, so map the measurement through the estimate of T_i
        base = np.linalg.norm(centres[lc.j] - centres[lc.i])
        scale = base
        if frame_depths is not None and lc.med_depth > 1e-9:
            scale = float(frame_depths[lc.i]) / lc.med_depth
        Riw = Ri[lc.i]
        tiw = ti[lc.i]
        e_R = Riw.T @ lc.R @ Riw
        e_t = Riw.T @ (lc.R @ tiw + scale * lc.t - tiw)
        # consistency gate against the current chain estimate
        est_R = Riw.T @ Ri[lc.j]
        est_t = Riw.T @ (ti[lc.j] - tiw)
        dR = e_R.T @ est_R
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        dt = np.linalg.norm(e_t - est_t)
        if ang > max_rot or dt > max_trans * (base + 1e-6):
            continue
        edge_i.append(lc.i)
        edge_j.append(lc.j)
        rel_R.append(e_R)
        rel_t.append(e_t)
        weight.append(loop_weight)

    def build(ei, ej, rR, rt, w):
        f = lambda a, dt=torch.float32: torch.as_tensor(
            np.asarray(a, dtype=np.float32 if dt is torch.float32
                       else np.int64), dtype=dt, device=device)
        return PoseGraph(R=f(Ri), t=f(ti), edge_i=f(ei, torch.int64),
                         edge_j=f(ej, torch.int64), rel_R=f(np.stack(rR)),
                         rel_t=f(np.stack(rt)), weight=f(w))

    graph = build(edge_i, edge_j, rel_R, rel_t, weight)
    is_loop = np.arange(len(edge_i)) >= (n - 1)
    out, costs = optimize(graph, n_iters=n_iters, robust_delta=robust_delta,
                          robust_mask=torch.as_tensor(is_loop, device=device))

    # a-posteriori chi-square edge rejection: Huber only bounds an
    # outlier's influence, and with one gauge anchor a bounded force still
    # bends a long chain; drop the loops whose residual stays large and
    # re-run (the two-stage robust pose-graph recipe)
    if reject_residual is not None and len(edge_i) > n - 1:
        rn = np.linalg.norm(edge_residuals(out).cpu().numpy(), axis=1)
        keep = ~is_loop | (rn < reject_residual)
        if not keep.all() and not keep[n - 1:].any():
            # every loop rejected: the odometry chain alone is exactly
            # satisfiable, so return it untouched
            return Ri.astype(np.float64), ti.astype(np.float64), 0.0
        if not keep.all():
            ki = np.flatnonzero(keep)
            graph = build([edge_i[i] for i in ki], [edge_j[i] for i in ki],
                          [rel_R[i] for i in ki], [rel_t[i] for i in ki],
                          [weight[i] for i in ki])
            out, costs = optimize(
                graph, n_iters=n_iters, robust_delta=robust_delta,
                robust_mask=torch.as_tensor(ki >= (n - 1), device=device))
    return out.R.cpu().numpy(), out.t.cpu().numpy(), float(costs[-1])
