"""Keypoint / match visualisation (copy of cuda_surf_tpu/viz.py; NumPy,
dependency-free).

A mirror of the reference demo's OpenCV drawing (drawKeypoints /
drawMatches, main.cpp:21-71): keypoints as small circles with radius
min(5, max(1, round(strength))) in per-point pseudo-random colours,
matches as coloured lines over a side-by-side concatenation.  Keypoints
and matches are read through numpy: pass the port's tensors through
`viz.host` first (or any object with numpy fields).
"""

from __future__ import annotations

import numpy as np
import torch


def host(obj):
    """A Keypoints / Matches of tensors -> the same NamedTuple of numpy
    arrays (the analogue of jax.device_get)."""
    return type(obj)(*[a.cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a) for a in obj])


def _colors(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, 3)).astype(np.uint8)


def to_rgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2).astype(np.uint8)
    return img.astype(np.uint8)


def _draw_circle(canvas: np.ndarray, cx: int, cy: int, r: int, color):
    h, w = canvas.shape[:2]
    # midpoint circle via angle sampling (enough for r <= 5)
    t = np.linspace(0, 2 * np.pi, max(8, 8 * r), endpoint=False)
    xs = np.rint(cx + r * np.cos(t)).astype(int)
    ys = np.rint(cy + r * np.sin(t)).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = color


def _draw_line(canvas: np.ndarray, x0: int, y0: int, x1: int, y1: int, color):
    h, w = canvas.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = color


def draw_keypoints(img: np.ndarray, kps) -> np.ndarray:
    """-> (H, W, 3) uint8 with one circle per valid keypoint
    (drawKeypoints, main.cpp:21-44)."""
    canvas = to_rgb(img).copy()
    x = np.asarray(kps.x)
    y = np.asarray(kps.y)
    strength = np.asarray(kps.strength)
    valid = np.asarray(kps.valid)
    idx = np.nonzero(valid)[0]
    cols = _colors(len(x))
    for i in idx:
        r = int(min(5, max(1, round(float(strength[i])))))
        _draw_circle(canvas, int(round(float(x[i]))),
                     int(round(float(y[i]))), r, cols[i])
    return canvas


def draw_matches(img1: np.ndarray, kps1, img2: np.ndarray, kps2, matches,
                 horizontal: bool = True, max_lines: int | None = None,
                 min_score: float = -1.0) -> np.ndarray:
    """-> uint8 RGB canvas with one line per valid match
    (drawMatches, main.cpp:47-71)."""
    a, b = to_rgb(img1), to_rgb(img2)
    h1, w1 = a.shape[:2]
    h2, w2 = b.shape[:2]
    if horizontal:
        canvas = np.zeros((max(h1, h2), w1 + w2, 3), np.uint8)
        canvas[:h1, :w1] = a
        canvas[:h2, w1:w1 + w2] = b
        ox, oy = w1, 0
    else:
        canvas = np.zeros((h1 + h2, max(w1, w2), 3), np.uint8)
        canvas[:h1, :w1] = a
        canvas[h1:h1 + h2, :w2] = b
        ox, oy = 0, h1
    x1 = np.asarray(kps1.x)
    y1 = np.asarray(kps1.y)
    mx = np.asarray(matches.match_x)
    my = np.asarray(matches.match_y)
    ok = np.asarray(matches.valid) & (np.asarray(matches.score) >= min_score)
    idx = np.nonzero(ok)[0]
    if max_lines is not None:
        idx = idx[:max_lines]
    cols = _colors(len(x1), seed=1)
    for i in idx:
        _draw_line(canvas, int(round(float(x1[i]))), int(round(float(y1[i]))),
                   int(round(float(mx[i])) + ox), int(round(float(my[i])) + oy),
                   cols[i])
    return canvas


def plot_trajectories(trajs: dict, size: int = 640,
                      plane=(0, 1)) -> np.ndarray:
    """Top-down trajectory plot (dependency-free rasterization).

    trajs: {label: (N, 3) camera centres}; the first entry sets the
    reference color (white) — pass ground truth first.  All
    trajectories share one scale/offset fit to their joint bounding
    box.  Start of each trajectory is marked with a small circle.
    Returns an RGB uint8 (size, size, 3) canvas; save with io.write_ppm
    or io.write_png.
    """
    canvas = np.zeros((size, size, 3), np.uint8)
    pts = np.concatenate([np.asarray(t)[:, list(plane)]
                          for t in trajs.values()])
    lo = pts.min(0)
    span = max(float((pts.max(0) - lo).max()), 1e-9)
    margin = 0.06 * size

    def to_px(p):
        q = (np.asarray(p)[:, list(plane)] - lo) / span
        x = margin + q[:, 0] * (size - 2 * margin)
        y = size - margin - q[:, 1] * (size - 2 * margin)  # y-up
        return np.rint(x).astype(int), np.rint(y).astype(int)

    palette = [np.array([255, 255, 255], np.uint8),   # reference: white
               np.array([255, 90, 60], np.uint8),
               np.array([70, 160, 255], np.uint8),
               np.array([90, 230, 120], np.uint8),
               np.array([240, 210, 60], np.uint8)]
    for idx, (label, t) in enumerate(trajs.items()):
        color = palette[idx % len(palette)]
        xs, ys = to_px(t)
        for k in range(len(xs) - 1):
            _draw_line(canvas, xs[k], ys[k], xs[k + 1], ys[k + 1], color)
        _draw_circle(canvas, int(xs[0]), int(ys[0]), 4, color)
    return canvas
