"""SO(3) / SE(3) utilities of the SfM / SLAM backend (port of
cuda_surf_tpu/geometry/pose.py).

Batched over any leading dimensions, float32.  The JAX package's
`@f32_matmuls` is covered by the TF32 switches of the package's
`__init__`: every matmul here runs in full float32.
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation (..., 3, 3)."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    theta = torch.clamp(theta, min=1e-12)
    K = hat(w / theta[..., 0])
    eye = _eye_like(K)
    s, c = torch.sin(theta), torch.cos(theta)
    R = eye + s * K + (1.0 - c) * (K @ K)
    small = theta[..., 0, 0][..., None, None] < 1e-7
    return torch.where(small, eye + hat(w), R)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.sin(theta)[..., None]
    factor = torch.where(
        torch.abs(s) < 1e-7, 0.5,
        theta[..., None] / (2 * torch.clamp(torch.abs(s), min=1e-12))
        * torch.sign(s))
    return v * factor


def exp_se3(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Twist (..., 6) [rho, phi] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)[..., None]
    theta = torch.clamp(theta, min=1e-12)
    K = hat(phi / theta[..., 0])
    eye = _eye_like(K)
    s, c = torch.sin(theta), torch.cos(theta)
    V = eye + ((1 - c) / theta) * K + ((theta - s) / theta) * (K @ K)
    small = theta[..., 0, 0][..., None, None] < 1e-7
    V = torch.where(small, eye, V)
    t = (V @ rho[..., None])[..., 0]
    return R, t


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): x -> Ra (Rb x + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def invert(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform(R, t, pts):
    """Apply (R, t) to (..., N, 3) points."""
    return pts @ R.transpose(-1, -2) + t[..., None, :]
