"""One height field and an orbit of `lap` frames around it, replayed lap
after lap, with `draws` seeded RANSAC draws (`raw`, the form of
`geometry.epipolar.draw_raw`) handed out in turn.  The set-up processes
frames 0 .. setup_frames - 1 as requests -setup_frames .. -1; request i
sends frame (setup_frames + i) % lap and its own draw."""

from __future__ import annotations

import dataclasses

import torch

from . import render

INT32_MAX = 2 ** 31 - 1
FIVE_POINT = (128, 5)     # track_pair's 5-point draw: hypotheses x points


@dataclasses.dataclass
class OrbitInputs:
    mix: dict
    frames: torch.Tensor           # (lap, h, w) uint8
    raws: torch.Tensor             # (draws, 128, 5) int32

    def frame_index(self, i: int) -> int:
        """The orbit's global frame number of request i."""
        return self.mix["setup_frames"] + i

    def key_of(self, i: int) -> int:
        return self.frame_index(i) % self.frames.shape[0]

    def frames_of(self, i: int) -> torch.Tensor:
        """The (h, w) frame request i sends."""
        return self.frames[self.key_of(i)]

    def raw_of(self, i: int) -> torch.Tensor:
        return self.raws[self.frame_index(i) % self.raws.shape[0]]

    def frames_per_request(self) -> int:
        return 1


def make_inputs(mix: dict, frame: dict, gen: torch.Generator,
                device) -> OrbitInputs:
    h, w = frame["h"], frame["w"]
    tex, elev = render.terrain_maps(
        render.draw_grids(gen, render.TERRAIN_CELLS, 1, device),
        render.draw_grids(gen, render.ELEV_CELLS, 1, device))
    poses = render.orbit_poses(mix["lap"])
    frames = torch.cat([render.render_terrain(tex, elev, h, w, poses[k:k + 8])
                        for k in range(0, len(poses), 8)])
    raws = torch.randint(0, INT32_MAX, (mix["draws"], *FIVE_POINT),
                         generator=gen, device=device, dtype=torch.int32)
    return OrbitInputs(mix, frames, raws)
