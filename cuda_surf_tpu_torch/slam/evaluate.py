"""Trajectory evaluation: absolute trajectory error (ATE) with Umeyama
Sim(3) / SE(3) alignment (copy of cuda_surf_tpu/slam/evaluate.py, numpy
only, copied because importing the JAX package imports jax)."""

from __future__ import annotations

import numpy as np


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst (N, 3)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float((D * np.diag(S)).sum() / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(estimated: np.ndarray, reference: np.ndarray,
             with_scale: bool = True) -> float:
    """RMSE of aligned camera-centre trajectories (N, 3)."""
    s, R, t = umeyama_align(estimated, reference, with_scale)
    aligned = (s * (R @ estimated.T)).T + t
    return float(np.sqrt(((aligned - reference) ** 2).sum(-1).mean()))
