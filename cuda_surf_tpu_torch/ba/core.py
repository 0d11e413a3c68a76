"""Schur-complement bundle adjustment, Levenberg-Marquardt (port of
cuda_surf_tpu/ba/core.py).

The reference's static-shape formulation, kept as it is:

 - observations are stored per point, padded to M observations a point,
   so the point (V) blocks reduce with plain sums;
 - the Jacobians are closed form (projection chain rule);
 - the reduced camera system S = U - W V^-1 W^T is accumulated with
   one-hot contractions over the C cameras.  With C <= 8 they are cheap
   and sum in a fixed order, where `index_add_` and `scatter_add_` would
   sum in another order on every CUDA run;
 - the LM loop is a fixed number of iterations with accept / reject
   selects and no host sync.

The camera parameterisation is world -> cam (R, t); increments are
left-multiplied twists: R <- exp(dphi) R, t <- t + dt.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._build import require_device
from ..geometry.pose import exp_so3, hat


class BAProblem(NamedTuple):
    """Static-shape BA problem.

    cam_idx: (P, M) int32 camera index of each observation (0 if masked)
    uv:      (P, M, 2) observed normalised-camera coordinates
    mask:    (P, M) bool observation validity
    """
    cam_idx: torch.Tensor
    uv: torch.Tensor
    mask: torch.Tensor


class BAState(NamedTuple):
    R: torch.Tensor       # (C, 3, 3)
    t: torch.Tensor       # (C, 3)
    points: torch.Tensor  # (P, 3)


def problem_from_numpy(cam_idx, uv, mask, device="cuda") -> BAProblem:
    """A BAProblem from arrays (e.g. a JAX problem after `np.asarray`), on
    the card unless `device="cpu"`."""
    device = require_device(device, "problem_from_numpy")
    return BAProblem(
        torch.as_tensor(np.asarray(cam_idx), dtype=torch.int32, device=device),
        torch.as_tensor(np.asarray(uv), dtype=torch.float32, device=device),
        torch.as_tensor(np.asarray(mask), dtype=torch.bool, device=device))


def state_from_numpy(R, t, points, device="cuda") -> BAState:
    """A BAState from arrays (e.g. a JAX state after `np.asarray`), on the
    card unless `device="cpu"`."""
    device = require_device(device, "state_from_numpy")
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device)
    return BAState(f(R), f(t), f(points))


def _cameras(state: BAState, prob: BAProblem):
    """(R, t) of each observation's camera, (P, M, 3, 3) and (P, M, 3).
    The index is clamped to the cameras, as the reference's gather is."""
    idx = torch.clamp(prob.cam_idx, 0, state.R.shape[0] - 1).long()
    return state.R[idx], state.t[idx]


def _one_hot(cam_idx, n_cameras: int, dtype):
    """(P, M) -> (P*M, C); an index outside [0, C) selects no camera."""
    cams = torch.arange(n_cameras, device=cam_idx.device)
    return (cam_idx.reshape(-1, 1) == cams).to(dtype)


def project(R, t, X):
    """World point -> normalised image coords for cameras (.., 3, 3)/(.., 3)."""
    xc = (R @ X[..., None])[..., 0] + t
    return xc[..., :2] / torch.clamp(xc[..., 2:], min=1e-9), xc


def residuals(state: BAState, prob: BAProblem):
    """(P, M, 2) reprojection residuals + cam-frame points."""
    Rc, tc = _cameras(state, prob)
    uv_hat, xc = project(Rc, tc, state.points[:, None, :])
    r = (uv_hat - prob.uv) * prob.mask[..., None]
    return r, xc


def cost(state: BAState, prob: BAProblem,
         huber_delta: float | None = None) -> torch.Tensor:
    r, _ = residuals(state, prob)
    if huber_delta is None:
        return 0.5 * torch.sum(r * r)
    # Huber on the per-observation residual norm
    n = torch.sqrt(torch.sum(r * r, -1) + 1e-20)
    d = float(huber_delta)
    rho = torch.where(n <= d, 0.5 * n * n, d * (n - 0.5 * d))
    return torch.sum(rho * prob.mask)


def _jacobians(state: BAState, prob: BAProblem,
               huber_delta: float | None = None):
    """Closed-form Jc (P, M, 2, 6), Jp (P, M, 2, 3), residual (P, M, 2).
    With `huber_delta`, rows are IRLS-scaled by sqrt(min(1, delta/|r|))
    so the normal equations realise the Huber robust kernel."""
    Rc, tc = _cameras(state, prob)
    X = state.points[:, None, :]
    xc = (Rc @ X[..., None])[..., 0] + tc               # (P, M, 3)
    z = torch.clamp(xc[..., 2], min=1e-9)
    inv_z = 1.0 / z
    x, y = xc[..., 0], xc[..., 1]
    # d(projection)/d(cam point): (P, M, 2, 3)
    zero = torch.zeros_like(inv_z)
    Jpi = torch.stack([
        torch.stack([inv_z, zero, -x * inv_z * inv_z], -1),
        torch.stack([zero, inv_z, -y * inv_z * inv_z], -1),
    ], -2)
    # left increment on the rotated point: d x_cam / d dphi = -hat(R X),
    # d x_cam / d dt = I
    RX = xc - tc
    Jc = torch.cat([-Jpi @ hat(RX), Jpi], -1)           # (P, M, 2, 6)
    Jp = Jpi @ Rc                                       # (P, M, 2, 3)
    uv_hat = xc[..., :2] * inv_z[..., None]
    r = uv_hat - prob.uv
    m = prob.mask[..., None]
    if huber_delta is not None:
        n = torch.sqrt(torch.sum((r * m) ** 2, -1, keepdim=True) + 1e-20)
        sw = torch.sqrt(torch.clamp(float(huber_delta) / n, max=1.0))
        r = r * sw
        Jc = Jc * sw[..., None]
        Jp = Jp * sw[..., None]
    return Jc * m[..., None], Jp * m[..., None], r * m


def _schur_system(state: BAState, prob: BAProblem, lam, n_cameras: int,
                  huber_delta: float | None = None):
    """Build the damped reduced camera system (S, b) and the point-solve
    pieces (Vinv, W, g_p) for back-substitution."""
    Jc, Jp, r = _jacobians(state, prob, huber_delta)
    P, M = prob.mask.shape
    C = n_cameras
    dev, dt = Jc.device, Jc.dtype

    # camera diagonal blocks U and rhs g_c, per observation, summed over
    # the cameras' one-hot columns
    cam_oh = _one_hot(prob.cam_idx, C, dt)              # (P*M, C)
    U_obs = torch.einsum("pmia,pmib->pmab", Jc, Jc)     # (P, M, 6, 6)
    gc_obs = torch.einsum("pmia,pmi->pma", Jc, r)
    U = torch.einsum("nc,nz->cz", cam_oh,
                     U_obs.reshape(-1, 36)).reshape(C, 6, 6)
    g_c = cam_oh.T @ gc_obs.reshape(-1, 6)

    # point blocks (dense per point, static M)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    V = torch.einsum("pmia,pmib->pab", Jp, Jp)           # (P, 3, 3)
    g_p = torch.einsum("pmia,pmi->pa", Jp, r)            # (P, 3)
    V_d = V + lam * _diag_only(V) + 1e-9 * eye3
    Vinv = _sym3_inv(V_d)

    # W blocks and the Schur products, folded per point and camera first:
    #   A_p[c] = sum_{m: cam=c} Y_m,  B_p[c] = sum_{m: cam=c} W_m,
    #   S[c, d] = sum_p A_p[c] B_p[d]^T  (one (6C, 3P) @ (3P, 6C) product)
    W = torch.einsum("pmia,pmib->pmab", Jc, Jp)          # (P, M, 6, 3)
    Y = torch.einsum("pmab,pbc->pmac", W, Vinv)          # (P, M, 6, 3)
    cam_oh_m = cam_oh.reshape(P, M, C)
    A = torch.einsum("pmc,pmax->pcax", cam_oh_m, Y)      # (P, C, 6, 3)
    B = torch.einsum("pmc,pmax->pcax", cam_oh_m, W)      # (P, C, 6, 3)
    A2 = A.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    B2 = B.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    S = (A2 @ B2.T).reshape(C, 6, C, 6).permute(0, 2, 1, 3)
    eyeC = torch.eye(C, dtype=dt, device=dev)
    S = U[:, None] * eyeC[..., None, None] - S
    # rhs: b_c = -g_c + Y g_p  (we solve S dx = -grad)
    Yg = torch.einsum("pmac,pc->pma", Y, g_p)
    b = -(g_c - cam_oh.T @ Yg.reshape(-1, 6))

    # LM damping + gauge fixing (clamp camera 0)
    Sm = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    diag = torch.diagonal(Sm)
    Sm = Sm + torch.diag(lam * diag + 1e-9)
    ar = torch.arange(6 * C, device=dev)
    gauge = ar < 6
    Sm = torch.where(gauge[:, None] | gauge[None, :],
                     torch.where(gauge[:, None] & gauge[None, :]
                                 & (ar[:, None] == ar[None, :]), 1e9, 0.0)
                     .to(dt),
                     Sm)
    bv = b.reshape(-1) * (~gauge)
    return Sm, bv, Vinv, W, g_p


def _diag_only(A):
    return A * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def _sym3_inv(M):
    """Closed-form cofactor inverse of batched symmetric 3x3 blocks."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m11, m12, m22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    row0 = torch.stack([c00, c01, c02], -1)
    row1 = torch.stack([c01, c11, c12], -1)
    row2 = torch.stack([c02, c12, c22], -1)
    return torch.stack([row0, row1, row2], -2) * inv_det[..., None, None]


def lm_step(state: BAState, prob: BAProblem, lam, n_cameras: int,
            huber_delta: float | None = None) -> BAState:
    """One damped Gauss-Newton step: the reduced camera system solved
    (`solve_ex`: no host check), the points back-substituted."""
    Sm, bv, Vinv, W, g_p = _schur_system(state, prob, lam, n_cameras,
                                         huber_delta)
    return _solve_and_update(state, prob, n_cameras, Sm, bv, Vinv, W, g_p)


def _solve_and_update(state: BAState, prob: BAProblem, n_cameras: int, Sm,
                      bv, Vinv, W, g_p) -> BAState:
    """The camera increment from the reduced system (Sm, bv), the points
    back-substituted, both applied."""
    dc = torch.linalg.solve_ex(Sm, bv[:, None])[0][:, 0].reshape(
        n_cameras, 6)
    # back-substitute points: dp = -Vinv (g_p + W^T dc); one-hot select
    P, M = prob.mask.shape
    cam_oh = _one_hot(prob.cam_idx, n_cameras, dc.dtype)
    dc_obs = (cam_oh @ dc).reshape(P, M, 6)
    Wt_dc = torch.einsum("pmab,pma->pb", W, dc_obs)        # (P, 3)
    dp = -torch.einsum("pab,pb->pa", Vinv, g_p + Wt_dc)
    new_R = exp_so3(dc[:, :3]) @ state.R
    new_t = state.t + dc[:, 3:]
    new_points = state.points + dp
    return BAState(new_R, new_t, new_points)


def run_lm(state: BAState, prob: BAProblem, n_iters: int = 10,
           lam0: float = 1e-3, huber_delta: float | None = None):
    """Fixed-iteration LM with accept / reject damping, every decision a
    select on the device.  `huber_delta` enables the Huber robust kernel
    (IRLS).  -> (state, final cost)."""
    n_cameras = state.R.shape[0]
    c0 = cost(state, prob, huber_delta)
    lam = torch.full((), lam0, dtype=torch.float32, device=c0.device)
    for _ in range(n_iters):
        cand = lm_step(state, prob, lam, n_cameras, huber_delta)
        state, lam, c0 = lm_select(state, cand, lam, c0,
                                   cost(cand, prob, huber_delta))
    return state, c0


def lm_select(state: BAState, cand: BAState, lam, c0, c1):
    """LM's accept / reject of a candidate at cost c1 against c0, a select
    on the device.  -> (state, lam, cost)."""
    ok = (c1 < c0) & torch.isfinite(c1)
    state = BAState(*(torch.where(ok, b, a) for a, b in zip(state, cand)))
    lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-9),
                      torch.clamp(lam * 8.0, max=1e6))
    return state, lam, torch.where(ok, c1, c0)
