"""`pool` scenes, each a textured plane under a camera that moves `motion`
a frame (the `plane` scene's path) and turns `roll_deg` degrees a frame
more about its optical axis, `frames` frames each.  Request i sends scene
i % pool.  The frames are checked to stay on the texture whatever the roll:
a view that left it would show the clamped edge texels, smeared.

The texture is the `plane` scene's noise grids summed, exposed by their
own mean and standard deviation (`exposed_texture`) in place of their
extremes: the keypoints' count climbs steeply with contrast, and the
extremes of a million texels vary from one draw to the next, so the
min-max stretch moved a sequence's count by tens of per cent from seed
to seed, and the work of a run with it."""

from __future__ import annotations

import dataclasses
import math

import torch

from . import render
from .plane import PlaneInputs


EXPOSURE_SD = 5.2   # standard deviations to each end of [0, 1]: the
                    # min-max stretch's mean span, 10.5 sd


def exposed_texture(grids) -> torch.Tensor:
    """`render.draw_grids` of PLANE_CELLS -> (n, T, T) in [0, 1]: the
    summed grids at mean 0.5 and EXPOSURE_SD standard deviations to each
    end, clipped."""
    tex = render.multiscale_texture(grids, render.PLANE_CELLS)
    z = (tex - tex.mean((1, 2), keepdim=True)) \
        / tex.std(dim=(1, 2), keepdim=True)
    return torch.clamp(0.5 + z / (2 * EXPOSURE_SD), 0.0, 1.0)


def render_rolled(tex255, h: int, w: int, n_frames: int, motion: float,
                  roll_deg: float) -> torch.Tensor:
    """(S, T, T) textures scaled to [0, 255] -> uint8 (S, n_frames, h, w):
    `render.render_plane`'s camera path, frame i turned by
    i * (motion + roll) radians about the optical axis in place of its
    i * motion."""
    S = tex255.shape[0]
    dev = tex255.device
    d_cam = render._rays(h, w, dev)
    roll = math.radians(roll_deg)
    hi = render.T - 2
    out = torch.empty((S, n_frames, h, w), dtype=torch.uint8, device=dev)
    for i in range(n_frames):
        ang = (motion + roll) * i
        c = torch.tensor([motion * 2 * i, motion * math.sin(1.7 * i), -1.0],
                         dtype=torch.float64, device=dev)
        R = torch.tensor([[math.cos(ang), -math.sin(ang), 0],
                          [math.sin(ang), math.cos(ang), 0], [0, 0, 1.0]],
                         dtype=torch.float64, device=dev)
        d_world = d_cam @ R
        lam = -c[2] / d_world[..., 2]
        X = c + lam[..., None] * d_world
        u = (X[..., 0] * 0.35 + 0.5) * (render.T - 1)
        v = (X[..., 1] * 0.35 + 0.5) * (render.T - 1)
        lo = float(torch.minimum(u.amin(), v.amin()))
        top = float(torch.maximum(u.amax(), v.amax()))
        if lo < 0 or top > hi:
            raise ValueError(f"frame {i} leaves the texture: texels "
                             f"[{lo:.1f}, {top:.1f}] outside [0, {hi}]")
        out[:, i] = render._to_u8(render._bilinear(tex255, u.expand(S, h, w),
                                                   v.expand(S, h, w)))
    return out


@dataclasses.dataclass
class RolledInputs(PlaneInputs):
    """The `plane` scene's inputs, each sequence's (F, h, w) view made
    once: a request's frames are then at hand without an indexing
    operation on the host between one request's read-back and the next
    request's launch."""

    def __post_init__(self):
        self.views = self.frames.unbind(0)

    def frames_of(self, i: int) -> torch.Tensor:
        return self.views[i % len(self.views)]


def make_inputs(mix: dict, frame: dict, gen: torch.Generator,
                device) -> RolledInputs:
    grids = render.draw_grids(gen, render.PLANE_CELLS, mix["pool"], device)
    tex = exposed_texture(grids) * 255.0
    del grids
    return RolledInputs(mix, render_rolled(tex, frame["h"], frame["w"],
                                          mix["frames"], mix["motion"],
                                          mix["roll_deg"]))
