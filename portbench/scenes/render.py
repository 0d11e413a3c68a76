"""The renderers the scenes share, on the device from seeded noise grids.

A torch copy of the renderers of `cuda_surf_tpu_torch.io.synth`
(`render_plane_sequence`, `render_terrain_sequence`), which are numpy and
run on the host: a 60-frame terrain orbit at 640x480 takes minutes there
and a fraction of a second here.  The noise grids are arguments, so the
same grids give the same frames as the numpy renderers (tests hold the two
together); `draw_grids` makes them on the device from a `torch.Generator`.
All arithmetic is float64, as in numpy.
"""

from __future__ import annotations

import math

import torch

T = 1024                         # texture side, texels
PLANE_CELLS = (1, 2, 4, 8, 16)   # the main pair's texture (io.synth.MAIN_PAIR)
TERRAIN_CELLS = (8, 16, 32, 64)
ELEV_CELLS = (64, 128, 256)


def draw_grids(gen: torch.Generator, cells, n: int = 1, device="cuda"):
    """-> [(n, T // cell + 2, T // cell + 2) float64 standard normal], one
    tensor a cell size: n scenes' noise grids in one call a cell size."""
    return [torch.randn((n, T // c + 2, T // c + 2), generator=gen,
                        dtype=torch.float64, device=device) for c in cells]


def _bilinear(img, u, v):
    """img (n, H, W), u / v (n, ...) float64 in range -> (n, ...)."""
    n = img.shape[0]
    u0, v0 = u.long(), v.long()
    fu, fv = u - u0, v - v0
    flat = img.reshape(n, -1)
    W = img.shape[-1]
    g = lambda vv, uu: torch.gather(flat, 1, (vv * W + uu).reshape(n, -1)
                                    ).reshape(u.shape)
    return (g(v0, u0) * (1 - fu) * (1 - fv) + g(v0, u0 + 1) * fu * (1 - fv)
            + g(v0 + 1, u0) * (1 - fu) * fv + g(v0 + 1, u0 + 1) * fu * fv)


def multiscale_texture(grids, cells) -> torch.Tensor:
    """(n, T, T) in [0, 1]: the bilinearly upsampled grids summed and
    stretched, per scene (io.synth's texture)."""
    n = grids[0].shape[0]
    dev = grids[0].device
    gy, gx = torch.meshgrid(torch.arange(T, dtype=torch.float64, device=dev),
                            torch.arange(T, dtype=torch.float64, device=dev),
                            indexing="ij")
    tex = torch.zeros((n, T, T), dtype=torch.float64, device=dev)
    for g, cell in zip(grids, cells):
        u = (gx / cell).expand(n, T, T)
        v = (gy / cell).expand(n, T, T)
        tex = tex + _bilinear(g, u, v)
    lo = tex.amin((1, 2), keepdim=True)
    hi = tex.amax((1, 2), keepdim=True)
    return (tex - lo) / (hi - lo + 1e-9)


def _rays(h, w, dev):
    f, cx, cy = 0.9 * w, w / 2.0, h / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                            torch.arange(w, dtype=torch.float64, device=dev),
                            indexing="ij")
    dx, dy = (xx - cx) / f, (yy - cy) / f
    return torch.stack([dx, dy, torch.ones_like(dx)], -1)      # (h, w, 3)


def _to_u8(img):
    return torch.clamp(img, 0, 255).to(torch.uint8)


def render_plane(tex255, h: int, w: int, n_frames: int,
                 motion: float) -> torch.Tensor:
    """(S, T, T) textures scaled to [0, 255] -> uint8 (S, n_frames, h, w):
    io.synth.render_plane_sequence's camera path above each texture."""
    S = tex255.shape[0]
    dev = tex255.device
    d_cam = _rays(h, w, dev)
    out = torch.empty((S, n_frames, h, w), dtype=torch.uint8, device=dev)
    for i in range(n_frames):
        ang = motion * i
        c = torch.tensor([motion * 2 * i, motion * math.sin(1.7 * i), -1.0],
                         dtype=torch.float64, device=dev)
        R = torch.tensor([[math.cos(ang), -math.sin(ang), 0],
                          [math.sin(ang), math.cos(ang), 0], [0, 0, 1.0]],
                         dtype=torch.float64, device=dev)
        d_world = d_cam @ R
        lam = -c[2] / d_world[..., 2]
        X = c + lam[..., None] * d_world
        u = torch.clamp((X[..., 0] * 0.35 + 0.5) * (T - 1), 0, T - 2)
        v = torch.clamp((X[..., 1] * 0.35 + 0.5) * (T - 1), 0, T - 2)
        out[:, i] = _to_u8(_bilinear(tex255, u.expand(S, h, w),
                                     v.expand(S, h, w)))
    return out


def orbit_poses(n_frames: int):
    """io.synth._orbit_poses(loop=True): [(R world->cam, centre)] floats."""
    poses = []
    for i in range(n_frames):
        ph = 2 * math.pi * i / n_frames
        c = (0.28 * math.cos(ph), 0.28 * math.sin(ph),
             -1.0 + 0.04 * math.sin(2 * ph))
        yaw = 0.12 * math.sin(ph)
        R = ((math.cos(yaw), -math.sin(yaw), 0.0),
             (math.sin(yaw), math.cos(yaw), 0.0), (0.0, 0.0, 1.0))
        poses.append((R, c))
    return poses


def terrain_maps(tex_grids, elev_grids):
    """One scene's grids -> (texture in [0, 255], elevation in [0, 1]),
    each (T, T)."""
    tex = multiscale_texture(tex_grids, TERRAIN_CELLS)[0]
    tex = (0.5 + 0.5 * torch.tanh(2.2 * (2.0 * tex - 1.0))) * 255.0
    return tex, multiscale_texture(elev_grids, ELEV_CELLS)[0]


def render_terrain(tex, elev, h: int, w: int, poses,
                   relief: float = 0.45) -> torch.Tensor:
    """`terrain_maps` -> uint8 (N, h, w): io.synth's ray-marched height
    field (85 march steps, 18 bisections), the N poses at once."""
    dev = tex.device
    N = len(poses)
    R = torch.tensor([p[0] for p in poses], dtype=torch.float64, device=dev)
    c = torch.tensor([p[1] for p in poses], dtype=torch.float64, device=dev)
    d_world = torch.einsum("hwi,nij->nhwj", _rays(h, w, dev), R)
    cz = c[:, 2].view(N, 1, 1)

    def sample(img, x, y):
        u = torch.clamp((x * 0.35 + 0.5) * (T - 1), 0, T - 2)
        v = torch.clamp((y * 0.35 + 0.5) * (T - 1), 0, T - 2)
        return _bilinear(img[None], u.reshape(1, -1),
                         v.reshape(1, -1)).reshape(x.shape)

    def f_at(lam):
        X = c.view(N, 1, 1, 3) + lam[..., None] * d_world
        return X[..., 2] + relief * sample(elev, X[..., 0], X[..., 1])

    lam0 = -cz - relief - 0.03
    step = (-cz - lam0 + 0.06) / 85.0
    shape = (N, h, w)
    lo = lam0.expand(shape).clone()
    hi = (-cz + 0.06).expand(shape).clone()
    lam = lo.clone()
    prev = lam.clone()
    crossed = torch.zeros(shape, dtype=torch.bool, device=dev)
    for _ in range(85):
        newly = (f_at(lam) > 0) & ~crossed
        hi = torch.where(newly, lam, hi)
        lo = torch.where(newly, prev, lo)
        crossed |= newly
        prev = torch.where(crossed, prev, lam)
        lam = torch.where(crossed, lam, lam + step)
    for _ in range(18):
        mid = 0.5 * (lo + hi)
        pos = f_at(mid) > 0
        hi = torch.where(pos, mid, hi)
        lo = torch.where(pos, lo, mid)
    lam = 0.5 * (lo + hi)
    X = c.view(N, 1, 1, 3) + lam[..., None] * d_world
    return _to_u8(sample(tex, X[..., 0], X[..., 1]))
