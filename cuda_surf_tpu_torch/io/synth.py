"""Synthetic ground-truthed frames (copy of
cuda_surf_tpu/slam/sequence.py:render_plane_sequence).

Copied rather than imported, because importing the JAX package imports
jax.  NumPy only; for a given seed the frames are identical to the JAX
package's, so both packages can be run on the same input.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


# The in-repo stand-in for the reference demo's 1280x960 stereo pair: two
# frames 0.04 plane-units and 0.02 rad apart, textured finely enough for
# ~2800 upright SURF keypoints per frame at the main-path config.
MAIN_PAIR = dict(n_frames=2, h=960, w=1280, seed=0, motion=0.02,
                 cells=(1, 2, 4, 8, 16))


def main_pair() -> np.ndarray:
    """uint8 (2, 960, 1280): the main path's input pair."""
    return render_plane_sequence(**MAIN_PAIR)[0]


def main_batch(n_frames: int) -> np.ndarray:
    """uint8 (n_frames, 960, 1280): the batch path's input, the main pair's
    sequence continued (frames 0 and 1 are the main pair)."""
    return render_plane_sequence(**dict(MAIN_PAIR, n_frames=n_frames))[0]


class Intrinsics(NamedTuple):
    """Pinhole intrinsics (same fields as cuda_surf_tpu.slam.tracking)."""
    fx: float
    fy: float
    cx: float
    cy: float


def render_plane_sequence(n_frames: int = 8, h: int = 240, w: int = 320,
                          seed: int = 0, motion: float = 0.02,
                          cells=(8, 16, 32, 64)):
    """Camera translating/rotating above a textured plane at z=1.

    Returns (frames uint8 (N, h, w), centres (N, 3), Intrinsics).  The
    texture is smooth multi-scale noise so SURF finds stable blobs.
    `cells` are the noise cell sizes in texels; the default is the JAX
    package's texture, and finer cells give a megapixel frame the blob
    density of a real photograph.
    """
    rng = np.random.default_rng(seed)
    intr = Intrinsics(fx=0.9 * w, fy=0.9 * w, cx=w / 2.0, cy=h / 2.0)

    # multi-scale smooth texture over the plane patch [-1,1]^2:
    # bilinearly upsampled coarse noise at several cell sizes
    T = 1024
    tex = np.zeros((T, T))
    gy, gx = np.mgrid[0:T, 0:T].astype(np.float64)
    for cell in cells:
        g = rng.normal(0, 1, (T // cell + 2, T // cell + 2))
        u, v = gx / cell, gy / cell
        u0, v0 = u.astype(int), v.astype(int)
        fu, fv = u - u0, v - v0
        tex += (g[v0, u0] * (1 - fu) * (1 - fv) + g[v0, u0 + 1] * fu * (1 - fv)
                + g[v0 + 1, u0] * (1 - fu) * fv + g[v0 + 1, u0 + 1] * fu * fv)
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255.0

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    frames, centres = [], []
    for i in range(n_frames):
        # camera pose: world->cam; camera at c_i looking down +z
        ang = motion * i
        c = np.array([motion * 2 * i, motion * np.sin(1.7 * i), -1.0])
        R = np.array([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
        # ray through each pixel: X = R^T (z_c * K^-1 u) + c, plane z=0
        dx = (xx - intr.cx) / intr.fx
        dy = (yy - intr.cy) / intr.fy
        d_cam = np.stack([dx, dy, np.ones_like(dx)], -1)
        d_world = d_cam @ R  # R^T d
        lam = -c[2] / d_world[..., 2]
        X = c[None, None, :] + lam[..., None] * d_world
        u = (X[..., 0] * 0.35 + 0.5) * (T - 1)
        v = (X[..., 1] * 0.35 + 0.5) * (T - 1)
        u = np.clip(u, 0, T - 2)
        v = np.clip(v, 0, T - 2)
        u0, v0 = u.astype(int), v.astype(int)
        fu, fv = u - u0, v - v0
        img = (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u0 + 1] * fu * (1 - fv)
               + tex[v0 + 1, u0] * (1 - fu) * fv + tex[v0 + 1, u0 + 1] * fu * fv)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        centres.append(c)
    return np.stack(frames), np.stack(centres), intr
