"""A rotated batch: the batch form's request (`forms/batch.py`: detect,
orient and describe B frames in one call, match frames i -> i+1 in one
call, read the counts and matches back, here into pinned memory) on a
rotation-invariant configuration, judged against the rotated reference
(`reference/surfref/rotated.py`), worked out once a distinct frame.  The
control serves through the same rotated reference.

Beside the batch form's numbers, per frame:
- `ori_gap`: the largest wrapped |ori - the reference's| over the valid
  keypoints, rad; where the reference's two heaviest windows weigh within
  TIE of each other (relative), the distance to the nearer of their two
  angles, since another summation order may pick either;
- `ori_ties`: the most keypoints of one frame that are exempt from the
  descriptor comparison: near ties as above, and ring-edge keypoints, which
  have a live descriptor sample whose squared radius lies within RING_ULPS
  float32 ulps of an integer, or on the other side of one at the program's
  orientation than at the reference's: its Gaussian weight is picked by
  the truncated radius, a step of ~12 % from one ring to the next, so one
  rounding of the angle moves the whole sample.
An exempt keypoint's descriptor is not compared; in the matches the
program's own descriptor stands in for the reference's there, so a match
that touches one checks the matcher and not that descriptor.  Unlimited,
`keypoints_max`: the most keypoints of a sampled frame, against the
configuration's `max_pts`.
"""

from __future__ import annotations

import math

import torch

from ..reference import surfref
from ..reference.judge import frame_gaps, match_gaps, worst
from ..reference.surfref import rotated
from ..reference.surfref.ops.descriptor import desc_geometry, sample_frame
from . import Outputs, batch, one

TIE = 1e-5          # torch_parity.check_orientations' near-tie gap
RING_ULPS = 4       # torch_parity.ring_edge_keypoints' margin
CHUNK = 1024


class Requests(batch.Requests):
    """The batch form's request, its counts and matches read back into a
    pinned host buffer of its own: a pageable copy's host memcpy would add
    ~2 % to the request's time, at whatever speed the host has."""

    def __init__(self, lib, cfg: dict, inputs, device):
        super().__init__(rotated if lib is surfref else lib, cfg, inputs,
                         device)
        self.host = None

    def __call__(self, i: int) -> Outputs:
        kp, d = self.surf.detect_and_compute_batch(self.inputs.frames_of(i))
        first = type(kp)(*[f[:-1] for f in kp])
        rest = type(kp)(*[f[1:] for f in kp])
        m = self.surf.match(first, d[:-1], rest, d[1:])
        back = torch.cat([kp.count.float(), m.score.reshape(-1),
                          m.index.reshape(-1).float()])
        if back.is_cuda:
            if self.host is None:
                self.host = torch.empty(back.shape, dtype=back.dtype,
                                        pin_memory=True)
            self.host.copy_(back, non_blocking=True)
            torch.cuda.current_stream(back.device).synchronize()
        else:
            back.cpu()
        return Outputs([kp], [d], [m])


def circ_diff(a, b):
    """|a - b| on the circle, rad."""
    d = torch.remainder(a - b + math.pi, 2 * math.pi) - math.pi
    return d.abs()


def ring_edges(cfg, shape, x, y, scale, ori_ref, ori, valid):
    """(n,) keypoints -> (n,) bool: a live sample of the turned window
    within RING_ULPS of a Gaussian ring's edge at the reference's angle,
    or on another ring at the program's angle."""
    out = []
    for k0 in range(0, x.shape[0], CHUNK):
        part = lambda a: a[k0:k0 + CHUNK]
        frames = []
        for o in (ori_ref, ori):
            geom = desc_geometry(cfg, part(x), part(y), part(scale), part(o))
            rpos, cpos, ok, _, _ = sample_frame(cfg, *shape, *geom,
                                                part(valid))
            frames.append((rpos * rpos + cpos * cpos, ok))
        (r2, ok), (r2_p, ok_p) = frames
        ring = torch.round(r2)
        ulp = torch.nextafter(ring, torch.full_like(ring, math.inf)) - ring
        edge = ((r2 - ring).abs() <= RING_ULPS * ulp) & (ring >= 1) \
            & (ring <= 39) & ok
        trunc = lambda v: torch.clamp(torch.trunc(v), max=39)
        edge |= ok & ok_p & (trunc(r2) != trunc(r2_p))
        out.append(edge.any(1))
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.bool,
                                                  device=x.device)


def reference(j, key, image):
    """The rotated reference of one distinct frame, worked out once:
    (Keypoints, descriptors, window gap, top-two windows' angles)."""
    cache = j.__dict__.setdefault("rotated_refs", {})
    if key not in cache:
        cfg = surfref.SurfConfig(**j.cfg["surf"])
        cache[key] = rotated.detect_and_compute_windows(image, cfg)
    return cache[key]


def exempt_and_gaps(acc, cfg, shape, kp, ref):
    """Frame numbers `ori_gap`, `ori_ties` into acc -> (n,) exempt mask of
    the first n = min(counts) slots."""
    kp_r, _, gap, top2 = ref
    n = min(int(kp.count), int(kp_r.count))
    v = kp_r.valid[:n] & kp.valid[:n]
    ori, ori_r = kp.ori[:n], kp_r.ori[:n]
    tie = gap[:n] < TIE
    d = torch.where(tie, torch.minimum(circ_diff(ori, top2[:n, 0]),
                                       circ_diff(ori, top2[:n, 1])),
                    circ_diff(ori, ori_r))
    worst(acc, "ori_gap", torch.where(v, d, 0.0).max() if n else 0.0)
    exempt = v & (tie | ring_edges(cfg, shape, kp_r.x[:n], kp_r.y[:n],
                                   kp_r.scale[:n], ori_r, ori, v))
    worst(acc, "ori_ties", int(exempt.sum()))
    return exempt


def judge(j, acc, i, out):
    f, key = j.inputs.frames_of(i), j.inputs.key_of(i)
    kp, d, m = out.kps[0], out.descs[0], out.matches[0]
    B = f.shape[0]
    if kp.count.shape[0] != B or m.index.shape[0] != B - 1:
        raise ValueError("a batch's outputs are B frames and B - 1 matches")
    cfg = surfref.SurfConfig(**j.cfg["surf"])
    shape = (f.shape[1] + 1, f.shape[2] + 1)
    worst(acc, "keypoints_max", int(kp.count.max()))
    refs, mixed = [], []
    for b in range(B):
        ref = reference(j, (key, b), f[b])
        kp_r, d_r = ref[:2]
        kb = one(kp, b)
        ex = exempt_and_gaps(acc, cfg, shape, kb, ref)[:, None]
        n = ex.shape[0]
        d_p, d_m = d[b].clone(), d_r.clone()
        d_p[:n] = torch.where(ex, d_r[:n], d[b][:n])   # exempt: not compared
        d_m[:n] = torch.where(ex, d[b][:n], d_r[:n])   # program's stands in
        frame_gaps(acc, kb, d_p, kp_r, d_r)
        refs.append(kp_r)
        mixed.append(d_m)
    for b in range(B - 1):
        match_gaps(acc, one(m, b), refs[b], mixed[b], refs[b + 1],
                   mixed[b + 1], int(kp.count[b]))
