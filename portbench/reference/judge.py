"""The comparison that decides `correct`.

The reference (`surfref`, plain PyTorch at float32 with TF32 off) works out
again, from the same inputs (frames and RANSAC draws), what a sample of the
window's requests produced, and each number below measures how far the
program's outputs lie from it.  Every number a cell is held to has its
limit in `limits/<cell>.json`: a number at most its limit, or a count at
least its limit (`{"at_least": n}`).  A run is correct when every one of
them was computed and keeps to its limit: a comparison that never ran
fails the run.

Per frame (the keypoints are compacted in scan order on both sides, so
slot k is the same keypoint when the sets agree):
- `count_gap`: |keypoint count - the reference's|;
- `kp_gap`: the largest |x|, |y| or |scale| difference, pixels;
- `laplace_flips`: keypoints whose Laplacian sign differs;
- `desc_gap`: the largest difference of a descriptor entry;
per matched pair:
- `match_gap`: the largest amount by which the score of the program's
  match lies below the reference's best for that keypoint, or its reported
  score off the reference's best (a near tie may pick either match);
- `ambiguity_gap`: the largest difference of the second-best over best
  ratio from the reference's (the same whichever of a tie is best);
per run:
- `uncompared`: sampled requests, or pairs due in them, that were not
  compared (too few requests in the window, an output missing, a
  comparison that raised).
The request form (`forms/<form>.py`) adds its own numbers: the orbit's
pair and start checks (`forms/frame.py`), with
- `untied_slots`: the most correspondences of a tracked pair that differ
  from the reference's (good or not, or matched elsewhere) where no near
  tie explains it: neither a second-best score within the `match_gap`
  limit of the best nor an ambiguity within the `ambiguity_gap` limit of
  the ratio;
- `tied_pairs`: pairs whose correspondences differ only where near ties
  explain it; RANSAC then samples other points and lands on another pose,
  which is not compared.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import surfref
from .precision import fp32
from .surfref.frontend import Surf

INF = float("inf")


def worst(acc: dict, name: str, value: float):
    v = float(value)
    if math.isnan(v):
        v = INF
    acc[name] = max(acc.get(name, 0.0), v)


def frame_gaps(acc, kp, desc, kp_r, desc_r):
    cp, cr = int(kp.count), int(kp_r.count)
    worst(acc, "count_gap", abs(cp - cr))
    n = min(cp, cr)
    if n == 0:
        return
    d = max(float((getattr(kp, f)[:n] - getattr(kp_r, f)[:n]).abs().max())
            for f in ("x", "y", "scale"))
    worst(acc, "kp_gap", d)
    worst(acc, "laplace_flips", int((kp.laplace[:n] != kp_r.laplace[:n]).sum()))
    worst(acc, "desc_gap", (desc[:n] - desc_r[:n]).abs().max())


def match_gaps(acc, m, kp1_r, d1_r, kp2_r, d2_r, n1: int):
    """The program's matches of set-1 slots < n1 against the reference's
    score matrix."""
    c1, c2 = int(kp1_r.count), int(kp2_r.count)
    n = min(n1, c1)
    if n == 0 or c2 == 0:
        return
    S = d1_r[:n] @ d2_r[:c2].T
    best = S.max(1).values
    ok = m.valid[:n]
    idx = m.index[:n].long()
    if bool(((idx >= c2) & ok).any()):
        worst(acc, "match_gap", INF)
        return
    got = S.gather(1, idx.clamp(max=c2 - 1)[:, None])[:, 0]
    gap = torch.maximum(best - got, (m.score[:n] - best).abs())
    worst(acc, "match_gap", torch.where(ok, gap, 0.0).max())
    if c2 > 1:
        top2 = S.topk(2, dim=1).values
        amb = top2[:, 1] / (top2[:, 0] + 1e-6)
        worst(acc, "ambiguity_gap",
              torch.where(ok, (m.ambiguity[:n] - amb).abs(), 0.0).max())


def good(kp1, kp2, m, ratio: float):
    """track_pair's filter: the correspondences RANSAC takes."""
    idx = torch.clamp(m.index.long(), 0, kp2.laplace.shape[0] - 1)
    return m.valid & (m.ambiguity < ratio) & (kp1.laplace == kp2.laplace[idx])


def differing(kp1, kp2, m, kp1_r, kp2_r, m_r, ratio: float, limits: dict):
    """-> (correspondences that differ from the reference's, those of them
    that no near tie of the reference's explains).  A correspondence
    differs where one side takes it and the other does not, or both take
    it to different keypoints."""
    g, g_r = good(kp1, kp2, m, ratio), good(kp1_r, kp2_r, m_r, ratio)
    diff = (g != g_r) | (g & g_r & (m.index != m_r.index))
    second = m_r.ambiguity * (m_r.score + 1e-6)
    near = (((m_r.score - second) <= limits.get("match_gap", 0.0))
            | ((m_r.ambiguity - ratio).abs()
               <= limits.get("ambiguity_gap", 0.0)))
    return int(diff.sum()), int((diff & ~near).sum())


def angle_deg(Ra, Rb) -> float:
    """The angle of Ra^T Rb, from its skew part and trace (atan2), which a
    float32 rotation's departure from orthonormality does not move."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = 0.5 * np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                              M[1, 0] - M[0, 1]])
    return math.degrees(math.atan2(s, 0.5 * (np.trace(M) - 1.0)))


def dir_deg(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return math.degrees(math.atan2(np.linalg.norm(np.cross(a, b)), a @ b))


class Judge:
    """Reference results, worked out once a distinct frame, and the
    numbers of the sampled requests, judged by the mix's request form."""

    def __init__(self, cfg: dict, inputs, device, form, limits: dict,
                 log=print):
        self.cfg, self.inputs, self.device = cfg, inputs, device
        self.form, self.limits, self.log = form, limits, log
        self.surf = Surf(surfref.SurfConfig(**cfg["surf"]), device=device)
        self._frames = {}

    def ref(self, key, image):
        if key not in self._frames:
            self._frames[key] = self.surf.detect_and_compute(image)
        return self._frames[key]

    def numbers(self, sample: dict, held=None) -> dict:
        """`sample`: request index -> Outputs; `held`: what the form's
        requests kept for the check beyond the sample."""
        acc = {"uncompared": max(0, self.inputs.mix["sample"] - len(sample))}
        with fp32(), torch.no_grad():
            for i, out in sorted(sample.items()):
                try:
                    self.form.judge(self, acc, i, out)
                except Exception as e:     # not compared, and said so
                    acc["uncompared"] += 1
                    self.log(f"request {i} not compared: {e!r}")
            if hasattr(self.form, "judge_held"):
                try:
                    self.form.judge_held(self, acc, held)
                except Exception as e:
                    acc["uncompared"] += 1
                    self.log(f"held outputs not compared: {e!r}")
        return acc
