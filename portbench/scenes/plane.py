"""`pool` scenes, each a textured plane under a camera that moves `motion`
a frame (io.synth's plane sequence), `frames` frames each.  Request i
sends scene i % pool."""

from __future__ import annotations

import dataclasses

import torch

from . import render


@dataclasses.dataclass
class PlaneInputs:
    mix: dict
    frames: torch.Tensor           # (pool, F, h, w) uint8

    def frames_of(self, i: int) -> torch.Tensor:
        """The (F, h, w) frames request i sends."""
        return self.frames[self.key_of(i)]

    def key_of(self, i: int) -> int:
        """Which distinct input request i sends (the reference's cache)."""
        return i % self.frames.shape[0]

    def frames_per_request(self) -> int:
        return self.mix["frames"]


def make_inputs(mix: dict, frame: dict, gen: torch.Generator,
                device) -> PlaneInputs:
    grids = render.draw_grids(gen, render.PLANE_CELLS, mix["pool"], device)
    tex = render.multiscale_texture(grids, render.PLANE_CELLS) * 255.0
    del grids
    return PlaneInputs(mix, render.render_plane(tex, frame["h"], frame["w"],
                                                mix["frames"], mix["motion"]))
