"""How often a RANSAC draw loses a pair of the visual-odometry cell, in the
JAX package and in the port, on the same draws.

The cell (12 frames of the terrain orbit at 200x280, the SLAM tests'
config) has 11 frame pairs.  For each pair and each of N keys
PRNGKey(1000 * pair + s), `track_pair` runs once with the JAX draw of that
key; a pair "fails" at <= 60 inliers.  Two steps, because the card's
machine has no jax:

    python tests/vo_draw_rates.py jax 32 draws.npz     # JAX, on the CPU
    python tests/vo_draw_rates.py port draws.npz cpu   # the port, the same
    python tests/vo_draw_rates.py port draws.npz cuda  #   draws, and its own

The first writes the draws, the JAX counts and the JAX rotations into the
.npz; the second prints, per pair, the failures of the JAX run (from the
file), of the port on the same draws and, on a device, of the port drawing
from its own generator (seeded 0), and the share of draws on which the
port's count is within 2 % of the JAX run's.  It also prints, per pair,
how many draws end on another pose than the pair's usual one: a rotation
more than 5 degrees from the JAX draw's rotation that lies closest to all
the other JAX draws' of that pair.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def frames_and_cell():
    from cuda_surf_tpu_torch.config import VO_CONFIG
    from cuda_surf_tpu_torch.io import TERRAIN_VO, render_terrain_sequence
    frames, _, intr = render_terrain_sequence(**TERRAIN_VO)
    return frames, intr, VO_CONFIG


def run_jax(n, path):
    import jax
    import jax.numpy as jnp
    import cuda_surf_tpu as jst
    from cuda_surf_tpu.slam import track_pair
    frames, intr, cfg = frames_and_cell()
    surf = jst.Surf(jst.SurfConfig(**cfg, wavelet_method="gather",
                                   detect_backend="xla"))
    kd = [surf.detect_and_compute(f) for f in frames]
    run = jax.jit(track_pair)
    raws = np.zeros((len(frames) - 1, n, 128, 5), np.int32)
    counts = np.zeros((len(frames) - 1, n), np.int32)
    rots = np.zeros((len(frames) - 1, n, 3, 3), np.float32)
    for i in range(1, len(frames)):
        for s in range(n):
            key = jax.random.PRNGKey(1000 * i + s)
            raws[i - 1, s] = np.asarray(jax.random.randint(
                key, (128, 5), 0, jnp.iinfo(jnp.int32).max))
            res = run(*kd[i - 1], *kd[i], intr, key)
            counts[i - 1, s] = int(res.n_inliers)
            rots[i - 1, s] = np.asarray(res.R)
    np.savez_compressed(path, raws=raws, jax=counts, jax_R=rots)
    print("jax failures per pair", (counts <= 60).sum(1).tolist())


def run_port(path, device):
    import torch
    import cuda_surf_tpu_torch as cst
    from cuda_surf_tpu_torch.slam import track_pair
    d = np.load(path)
    raws, jax_counts = d["raws"], d["jax"]
    frames, intr, cfg = frames_and_cell()
    surf = cst.Surf(cst.SurfConfig(**cfg), device=device)
    kd = [surf.detect_and_compute(f) for f in frames]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    same = np.zeros(jax_counts.shape, np.int32)
    own = np.zeros(jax_counts.shape, np.int32)
    same_R = np.zeros(jax_counts.shape + (3, 3), np.float32)
    own_R = np.zeros(jax_counts.shape + (3, 3), np.float32)
    for i in range(1, len(frames)):
        for s in range(raws.shape[1]):
            raw = torch.as_tensor(raws[i - 1, s]).to(device)
            res = track_pair(*kd[i - 1], *kd[i], intr, raw=raw)
            same[i - 1, s], same_R[i - 1, s] = int(res.n_inliers), \
                res.R.cpu().numpy()
            res = track_pair(*kd[i - 1], *kd[i], intr, gen)
            own[i - 1, s], own_R[i - 1, s] = int(res.n_inliers), \
                res.R.cpu().numpy()
    agree = np.abs(same - jax_counts) <= 0.02 * jax_counts
    # each pair's usual pose: the JAX draw's rotation closest to all the
    # others' (least summed angle)
    angle = lambda c: np.degrees(np.arccos(np.clip((c - 1) / 2, -1, 1)))
    jr = d["jax_R"].astype(np.float64)
    usual = jr[np.arange(len(jr)), angle(np.einsum(
        "psij,pqij->psq", jr, jr)).sum(2).argmin(1)]
    off = lambda R: (angle(np.einsum("psij,pij->ps", R, usual))
                     > 5.0).sum(1)
    for name, c, R in (("jax", jax_counts, d["jax_R"]),
                       ("port, same draws", same, same_R),
                       ("port, own generator", own, own_R)):
        print(f"{name}: failures per pair {(c <= 60).sum(1).tolist()}, "
              f"{int((c <= 60).sum())} of {c.size}; another pose per pair "
              f"{off(R).tolist()}, {int(off(R).sum())} of {c.size}")
    print(f"port within 2 % of jax on {agree.mean():.3f} of the draws")


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        run_jax(int(sys.argv[2]), sys.argv[3])
    else:
        run_port(sys.argv[2], sys.argv[3])
