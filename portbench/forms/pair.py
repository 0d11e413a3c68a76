"""A pair: detect and describe both frames one by one, match left ->
right, read the counts and matches back (the reference CUDA SURF demo's
pair loop)."""

from __future__ import annotations

import torch

from ..reference.judge import frame_gaps, match_gaps
from . import Outputs


class Requests:
    def __init__(self, lib, cfg: dict, inputs, device):
        self.surf = lib.Surf(lib.SurfConfig(**cfg["surf"]), device=device)
        self.inputs = inputs

    def __call__(self, i: int) -> Outputs:
        f = self.inputs.frames_of(i)
        k1, d1 = self.surf.detect_and_compute(f[0])
        k2, d2 = self.surf.detect_and_compute(f[1])
        m = self.surf.match(k1, d1, k2, d2)
        torch.cat([k1.count[None].float(), k2.count[None].float(), m.score,
                   m.index.float()]).cpu()
        return Outputs([k1, k2], [d1, d2], [m])


def judge(j, acc, i, out):
    f, key = j.inputs.frames_of(i), j.inputs.key_of(i)
    refs = [j.ref((key, k), f[k]) for k in range(2)]
    if len(out.kps) != 2 or len(out.matches) != 1:
        raise ValueError("a pair's outputs are two frames and one match")
    for kp, d, (kp_r, d_r) in zip(out.kps, out.descs, refs):
        frame_gaps(acc, kp, d, kp_r, d_r)
    match_gaps(acc, out.matches[0], *refs[0], *refs[1],
               int(out.kps[0].count))
