"""Synthetic ground-truthed frames (copy of the renderers of
cuda_surf_tpu/slam/sequence.py: render_plane_sequence,
render_terrain_sequence, render_forward_sequence).

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
# The tracking cell: frames 0 and 1 of the 50-frame terrain orbit at the
# main path's frame size (well-posed for an essential matrix, where the
# plane pair is not).
TERRAIN_TRACK = dict(n_frames=50, h=960, w=1280, seed=0, first=2)
# The visual-odometry cell: the JAX package's own well-posed VO run
# (tests/test_slam_sequence.py, terrain_run).
TERRAIN_VO = dict(n_frames=12, h=200, w=280, seed=0)


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


def _multiscale_texture(rng, T: int, cells=(8, 16, 32, 64)) -> np.ndarray:
    tex = np.zeros((T, T))
    gy, gx = np.mgrid[0:T, 0:T].astype(np.float64)
    for cell in cells:
        g = rng.normal(0, 1, (T // cell + 2, T // cell + 2))
        u, v = gx / cell, gy / cell
        u0, v0 = u.astype(int), v.astype(int)
        fu, fv = u - u0, v - v0
        tex += (g[v0, u0] * (1 - fu) * (1 - fv) + g[v0, u0 + 1] * fu * (1 - fv)
                + g[v0 + 1, u0] * (1 - fu) * fv + g[v0 + 1, u0 + 1] * fu * fv)
    return (tex - tex.min()) / (np.ptp(tex) + 1e-9)


def _orbit_poses(n_frames: int, loop: bool = True):
    """The (R, centre) poses of render_terrain_sequence's orbit."""
    poses = []
    for i in range(n_frames):
        ph = 2 * np.pi * i / n_frames if loop else 0.4 * i / n_frames
        c = np.array([0.28 * np.cos(ph), 0.28 * np.sin(ph),
                      -1.0 + 0.04 * np.sin(2 * ph)])
        # gentle roll variation.  Amplitude is deliberately <= ~7 deg:
        # upright SURF stops matching beyond ~10 deg relative roll, and
        # revisit pairs must stay matchable for the loop detector
        # (oriented descriptors are rotation-invariant but markedly
        # less discriminative on this self-similar noise texture —
        # median Lowe ratio 0.96 vs 0.85 upright)
        yaw = 0.12 * np.sin(ph)
        Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                       [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        poses.append((Rz, c))
    return poses


def render_terrain_sequence(n_frames: int = 50, h: int = 200, w: int = 280,
                            seed: int = 0, relief: float = 0.45,
                            loop: bool = True, first: int | None = None):
    """Camera orbiting above a textured HEIGHT-FIELD (genuine 3D
    structure: parallax between near and far terrain), exact per-pixel
    ray-marched rendering with analytic ground truth.

    The all-plane scene of :func:`render_plane_sequence` is degenerate
    for essential-matrix VO (a plane admits a homography); this terrain
    makes two-view geometry well-posed.  With `loop`, the trajectory is
    a closed orbit so the final frames revisit the first poses.  With
    `first`, only the orbit's first `first` frames are rendered (the
    same frames, without paying for the rest).

    Returns (frames uint8 (N, h, w), centres (N, 3), Intrinsics).
    """
    poses = _orbit_poses(n_frames, loop)[:first]
    return _render_terrain(poses, h, w, seed, relief)


def render_forward_sequence(n_frames: int = 20, h: int = 200, w: int = 280,
                            seed: int = 0, relief: float = 0.45,
                            speed: float = 0.03):
    """Forward-motion variant (KITTI-like geometry): the camera
    advances mostly ALONG its optical axis toward the terrain with a
    small lateral drift.  The epipole sits near the image centre —
    the hard regime for monocular translation estimation (parallax
    vanishes toward the focus of expansion), complementing the
    lateral-motion orbit of :func:`render_terrain_sequence`."""
    poses = []
    I = np.eye(3)
    for i in range(n_frames):
        c = np.array([0.008 * i, 0.004 * i, -1.35 + speed * i])
        poses.append((I, c))
    return _render_terrain(poses, h, w, seed, relief)


def _render_terrain(poses, h, w, seed, relief):
    """Ray-march render of the procedural height-field for a list of
    (R world->cam with d_z == 1, centre) poses.  Returns
    (frames uint8 (N, h, w), centres (N, 3), Intrinsics)."""
    rng = np.random.default_rng(seed)
    intr = Intrinsics(fx=0.9 * w, fy=0.9 * w, cx=w / 2.0, cy=h / 2.0)
    T = 1024
    # S-curve contrast stretch: the raw multiscale noise is mid-heavy
    # (std ~25/255) and starves the Hessian detector; pushing mass
    # toward the extremes roughly doubles the detected keypoint count
    tex = _multiscale_texture(rng, T)
    tex = (0.5 + 0.5 * np.tanh(2.2 * (2.0 * tex - 1.0))) * 255.0
    elev = _multiscale_texture(np.random.default_rng(seed + 1), T,
                               cells=(64, 128, 256))

    def surface_z(x, y):
        """Terrain height (world z, camera looks toward +z) at plane
        coords; bilinear in the elevation map over [-1, 1]^2."""
        u = np.clip((x * 0.35 + 0.5) * (T - 1), 0, T - 2)
        v = np.clip((y * 0.35 + 0.5) * (T - 1), 0, T - 2)
        u0, v0 = u.astype(int), v.astype(int)
        fu, fv = u - u0, v - v0
        e = (elev[v0, u0] * (1 - fu) * (1 - fv) + elev[v0, u0 + 1] * fu * (1 - fv)
             + elev[v0 + 1, u0] * (1 - fu) * fv + elev[v0 + 1, u0 + 1] * fu * fv)
        return -relief * e          # terrain spans z in [-relief, 0]

    def sample_tex(x, y):
        u = np.clip((x * 0.35 + 0.5) * (T - 1), 0, T - 2)
        v = np.clip((y * 0.35 + 0.5) * (T - 1), 0, T - 2)
        u0, v0 = u.astype(int), v.astype(int)
        fu, fv = u - u0, v - v0
        return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u0 + 1] * fu * (1 - fv)
                + tex[v0 + 1, u0] * (1 - fu) * fv + tex[v0 + 1, u0 + 1] * fu * fv)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dx = (xx - intr.cx) / intr.fx
    dy = (yy - intr.cy) / intr.fy

    frames, centres = [], []
    for R, c in poses:
        d_cam = np.stack([dx, dy, np.ones_like(dx)], -1)
        d_world = d_cam @ R                       # R^T d
        # ray-march f(lam) = z(lam) - surface_z(x(lam), y(lam)): camera is
        # above the terrain (f<0), find the first crossing, then bisect.
        # Rays have d_z == 1 (roll-only rotation), so the crossing lies
        # at lam = z_surf - z_cam in [|z_cam| - relief - eps, |z_cam|].
        lam0 = -c[2] - relief - 0.03
        step = (-c[2] - lam0 + 0.06) / 85.0
        lo = np.full((h, w), lam0)
        hi = np.full((h, w), -c[2] + 0.06)
        lam = np.full((h, w), lam0)
        prev = lam.copy()
        crossed = np.zeros((h, w), bool)
        for _ in range(85):
            X = c[None, None, :] + lam[..., None] * d_world
            f = X[..., 2] - surface_z(X[..., 0], X[..., 1])
            newly = (f > 0) & ~crossed
            hi = np.where(newly, lam, hi)
            lo = np.where(newly, prev, lo)
            crossed |= newly
            prev = np.where(crossed, prev, lam)
            lam = np.where(crossed, lam, lam + step)
        # bisection refinement
        for _ in range(18):
            mid = 0.5 * (lo + hi)
            X = c[None, None, :] + mid[..., None] * d_world
            f = X[..., 2] - surface_z(X[..., 0], X[..., 1])
            hi = np.where(f > 0, mid, hi)
            lo = np.where(f > 0, lo, mid)
        lam = 0.5 * (lo + hi)
        X = c[None, None, :] + lam[..., None] * d_world
        img = sample_tex(X[..., 0], X[..., 1])
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        centres.append(np.asarray(c, np.float64))
    return np.stack(frames), np.stack(centres), intr


def ba_problem(n_cameras: int = 8, n_points: int = 512, seed: int = 0):
    """The bundle-adjustment cell, bench.py's `ba_step_ms` problem
    (bench.py:202-219): n_points points in front of n_cameras cameras on a
    line, every point seen by every camera, observations with 1e-3 noise.
    -> ((cam_idx (P, C) int32, uv (P, C, 2) float32, mask (P, C) bool),
        (R (C, 3, 3), t (C, 3), points (P, 3)) float32), numpy."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n_points, 3)) + [0, 0, 4]
    Rs = np.stack([np.eye(3)] * n_cameras)
    ts = np.stack([[0.1 * c, 0, 0] for c in range(n_cameras)])
    ci = np.tile(np.arange(n_cameras), (n_points, 1))
    xc = np.einsum("cij,pj->pci", Rs, X) + ts[None]
    uv = xc[..., :2] / xc[..., 2:] + rng.normal(0, 1e-3,
                                                (n_points, n_cameras, 2))
    return ((ci.astype(np.int32), uv.astype(np.float32),
             np.ones((n_points, n_cameras), bool)),
            tuple(a.astype(np.float32) for a in (Rs, ts, X)))
