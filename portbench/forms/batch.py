"""A batch: detect and describe B frames in one call, match frames
i -> i+1 in one call, read the counts and matches back."""

from __future__ import annotations

import torch

from ..reference.judge import frame_gaps, match_gaps
from . import Outputs, one


class Requests:
    def __init__(self, lib, cfg: dict, inputs, device):
        self.surf = lib.Surf(lib.SurfConfig(**cfg["surf"]), device=device)
        self.inputs = inputs

    def __call__(self, i: int) -> Outputs:
        kp, d = self.surf.detect_and_compute_batch(self.inputs.frames_of(i))
        first = type(kp)(*[f[:-1] for f in kp])
        rest = type(kp)(*[f[1:] for f in kp])
        m = self.surf.match(first, d[:-1], rest, d[1:])
        torch.cat([kp.count.float(), m.score.reshape(-1),
                   m.index.reshape(-1).float()]).cpu()
        return Outputs([kp], [d], [m])


def judge(j, acc, i, out):
    f, key = j.inputs.frames_of(i), j.inputs.key_of(i)
    kp, d, m = out.kps[0], out.descs[0], out.matches[0]
    B = f.shape[0]
    if kp.count.shape[0] != B or m.index.shape[0] != B - 1:
        raise ValueError("a batch's outputs are B frames and B - 1 matches")
    refs = [j.ref((key, b), f[b]) for b in range(B)]
    for b, (kp_r, d_r) in enumerate(refs):
        frame_gaps(acc, one(kp, b), d[b], kp_r, d_r)
        if b + 1 < B:
            match_gaps(acc, one(m, b), kp_r, d_r, *refs[b + 1],
                       int(kp.count[b]))
