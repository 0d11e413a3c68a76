"""Batched five-point minimal solver for the essential matrix (port of
cuda_surf_tpu/geometry/fivepoint.py).

Nister's formulation: the 4-dim nullspace of the 5x9 epipolar system gives
E = x E1 + y E2 + z E3 + E4; det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0
yield 10 cubics in (x, y, z).  Gauss-Jordan elimination of the monomials of
(x, y)-degree >= 2 leaves B(z) [x, y, 1]^T = 0, whose determinant is a
degree-10 polynomial in z.  All 10 roots come at once from Durand-Kerner
simultaneous iteration in complex64 (elementwise, batched over the
hypotheses), on the polynomial and on its reversal; (x, y) from B(z0)'s
nullspace; then a Gauss-Newton polish on the original cubics.

The algorithm, its fixed iteration counts, clamps and non-finite guards are
the reference's, so its candidates agree with the JAX package's to float32
rounding.  `five_point` runs kernel E (csrc/fivepoint.cu, one launch a
call) on a CUDA tensor and the plain twin `_five_point_plain` on a CPU one.
The twin is a chain of small operations: on the card it would be bound by
its ~9,900 launches (96 sequential Durand-Kerner rounds), not by the
arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

# Monomial index tables (built once in numpy).
_LIN = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]          # x, y, z, 1
_QUAD = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
         (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
# Nister ordering: (x,y)-degree >= 2 monomials first (eliminated block),
# then the x / y / 1 groups in powers of z.
_E10 = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (2, 0, 0), (1, 2, 0),
        (1, 1, 1), (1, 1, 0), (0, 3, 0), (0, 2, 1), (0, 2, 0)]
_R10 = [(1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
        (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]
_MON20 = _E10 + _R10
_IDX20 = {m: i for i, m in enumerate(_MON20)}
_IDX10 = {m: i for i, m in enumerate(_QUAD)}
# reduced-row indices of the monomials used to build B(z)
_ROW_X2, _ROW_X2Z = _IDX20[(2, 0, 0)], _IDX20[(2, 0, 1)]
_ROW_XY, _ROW_XYZ = _IDX20[(1, 1, 0)], _IDX20[(1, 1, 1)]
_ROW_Y2, _ROW_Y2Z = _IDX20[(0, 2, 0)], _IDX20[(0, 2, 1)]

_ADD = lambda a, b: (a[0] + b[0], a[1] + b[1], a[2] + b[2])

# lin x lin -> quad: index of the monomial sum for each (a, b) pair
_LL = np.array([[_IDX10[_ADD(a, b)] for b in _LIN] for a in _LIN])
# quad x lin -> 20-monomial cubic
_QL = np.array([[_IDX20[_ADD(q, b)] for b in _LIN] for q in _QUAD])


def _accumulate(n_out, table, p, q):
    """out[table[a, b]] += p[..., a] * q[..., b], in the reference's
    order (a outer, b inner) -> (..., n_out)."""
    out = [0.0] * n_out
    for a in range(table.shape[0]):
        for b in range(table.shape[1]):
            out[table[a, b]] = out[table[a, b]] + p[..., a] * q[..., b]
    return torch.stack(out, -1)


def _lin_mul(p, q):
    """(..., 4) x (..., 4) -> (..., 10) quadratic coefficients."""
    return _accumulate(10, _LL, p, q)


def _quad_lin_mul(Q, p):
    """(..., 10) x (..., 4) -> (..., 20) cubic coefficients."""
    return _accumulate(20, _QL, Q, p)


def _constraint_matrix(basis):
    """basis: (..., 4, 3, 3) nullspace matrices E1..E4 (E4 = the
    inhomogeneous term).  -> (..., 10, 20) cubic coefficient matrix."""
    e = torch.movedim(basis, -3, -1)                # (..., 3, 3, 4)

    def lm(i, j, k, l):
        return _lin_mul(e[..., i, j, :], e[..., k, l, :])

    rows = []
    # det(E) = 0
    det = (_quad_lin_mul(lm(1, 1, 2, 2) - lm(1, 2, 2, 1), e[..., 0, 0, :])
           - _quad_lin_mul(lm(1, 0, 2, 2) - lm(1, 2, 2, 0), e[..., 0, 1, :])
           + _quad_lin_mul(lm(1, 0, 2, 1) - lm(1, 1, 2, 0), e[..., 0, 2, :]))
    rows.append(det)
    # 2 E E^T E - tr(E E^T) E = 0  (9 equations); G = E E^T
    G = [[sum(lm(i, j, k, j) for j in range(3)) for k in range(3)]
         for i in range(3)]
    trG = G[0][0] + G[1][1] + G[2][2]
    for i in range(3):
        for l in range(3):
            c = sum(_quad_lin_mul(G[i][k], e[..., k, l, :])
                    for k in range(3))
            rows.append(2.0 * c - _quad_lin_mul(trG, e[..., i, l, :]))
    return torch.stack(rows, -2)                    # (..., 10, 20)


def _bz_rows(M):
    """GJ-eliminate the (x,y)-degree>=2 block and build the 3x3
    z-polynomial matrix B(z) with B [x, y, 1]^T = 0.

    Returns (a, b, c): a, b (..., 3, 4) z^3..z^0 coefficients of the x
    and y columns; c (..., 3, 5) z^4..z^0 of the constant column."""
    G = torch.linalg.solve_ex(M[..., :10], M[..., 10:])[0]  # (..., 10, 10)
    # reduced row: monomial_i + G[i] . R10 = 0
    a_rows, b_rows, c_rows = [], [], []
    for rm, rmz in ((_ROW_X2, _ROW_X2Z), (_ROW_XY, _ROW_XYZ),
                    (_ROW_Y2, _ROW_Y2Z)):
        g = G[..., rm, :]
        h = G[..., rmz, :]
        # z*(m + g.R) - (mz + h.R) = 0 with z*m = mz, so z*(g.R) - h.R = 0.
        # R groups: x*(z^2,z,1) -> 0..2, y*(z^2,z,1) -> 3..5,
        # (z^3,z^2,z,1) -> 6..9.
        a_rows.append(torch.stack([g[..., 0], g[..., 1] - h[..., 0],
                                   g[..., 2] - h[..., 1], -h[..., 2]], -1))
        b_rows.append(torch.stack([g[..., 3], g[..., 4] - h[..., 3],
                                   g[..., 5] - h[..., 4], -h[..., 5]], -1))
        c_rows.append(torch.stack([g[..., 6], g[..., 7] - h[..., 6],
                                   g[..., 8] - h[..., 7],
                                   g[..., 9] - h[..., 8], -h[..., 9]], -1))
    return (torch.stack(a_rows, -2), torch.stack(b_rows, -2),
            torch.stack(c_rows, -2))


def _poly_mul(p, q):
    """(..., P) x (..., Q) -> (..., P+Q-1), coefficients high-to-low."""
    P, Q = p.shape[-1], q.shape[-1]
    out = [0.0] * (P + Q - 1)
    for i in range(P):
        for j in range(Q):
            out[i + j] = out[i + j] + p[..., i] * q[..., j]
    return torch.stack(out, -1)


def _det_bz(a, b, c):
    """Degree-10 coefficients (z^10..z^0) of det B(z)."""
    def minor(u, v, i, j):
        return (_poly_mul(u[..., i, :], v[..., j, :])
                - _poly_mul(u[..., j, :], v[..., i, :]))

    return (_poly_mul(a[..., 0, :], minor(b, c, 1, 2))
            - _poly_mul(b[..., 0, :], minor(a, c, 1, 2))
            + _poly_mul(c[..., 0, :], minor(a, b, 1, 2)))   # (..., 11)


def _nullspace4(Q):
    """Basis of the 4-dim nullspace of batched (..., 5, 9) full-rank
    systems via branch-free Gauss-Jordan with column pivoting (the first
    available maximum column on an exact tie).  The basis is not
    orthonormal; any basis serves the parametrisation.  -> (..., 9, 4)."""
    M = Q.to(torch.float32)
    batch = M.shape[:-2]
    avail = torch.ones(batch + (9,), dtype=torch.bool, device=M.device)
    pivs = []
    for i in range(5):
        row = M[..., i, :]                                  # (..., 9)
        a = torch.where(avail, torch.abs(row), -1.0)
        p = (a == torch.amax(a, -1, keepdim=True)).to(M.dtype)
        p = p * (torch.cumsum(p, -1) == 1.0)
        v = torch.sum(row * p, -1, keepdim=True)
        v = torch.where(torch.abs(v) < 1e-25, 1e-25, v)
        row = row / v
        coef = torch.sum(M * p[..., None, :], -1)           # (..., 5)
        ei = torch.eye(5, dtype=M.dtype, device=M.device)[i]
        coef = coef * (1.0 - ei)                            # skip row i
        M = M - coef[..., None] * row[..., None, :]
        M = torch.where(ei[:, None] > 0, row[..., None, :], M)
        pivs.append(p)
        avail = avail & (p < 0.5)
    P = torch.stack(pivs, -2)                               # (..., 5, 9)
    F = avail.to(M.dtype)                                   # (..., 9)
    eye = torch.eye(9, dtype=M.dtype, device=M.device)
    Nfull = (eye * F[..., None, :]
             - torch.einsum("...ic,...if->...cf", P, M) * F[..., None, :])
    # compress the 4 free columns to a static (..., 9, 4) block
    rank = torch.cumsum(F, -1) - 1.0
    k4 = torch.arange(4, dtype=M.dtype, device=M.device)
    Sel = (F[..., :, None] * (rank[..., :, None] == k4)).to(M.dtype)
    return torch.einsum("...cf,...fk->...ck", Nfull, Sel)


def _dk_pass(c, n, n_iters):
    """One Durand-Kerner run on a batch of monic complex polynomials
    (coefficients c (..., n+1) high-to-low, c[..., 0] == 1)."""
    radius = 1.0 + torch.amax(torch.abs(c[..., 1:]), -1)
    ctype = c.dtype

    def horner(z):
        acc = torch.ones_like(z)
        for k in range(1, n + 1):
            acc = acc * z + c[..., k:k + 1]
        return acc

    # every constant is made on the device: a host-made tensor is a copy
    # that waits for the device
    k = torch.arange(n, dtype=radius.dtype, device=c.device)
    unit = torch.polar(torch.ones_like(k), 2.0 * np.pi * (k + 0.37) / n)
    z = 0.7 * radius[..., None].to(ctype) * unit
    eye = torch.eye(n, dtype=ctype, device=c.device)
    lim = 0.5 * radius[..., None]
    for _ in range(n_iters):
        diff = z[..., :, None] - z[..., None, :] + eye   # kill the diagonal
        den = torch.prod(diff, -1)
        den = torch.where(torch.abs(den) < 1e-20, 1e-20, den)
        step = horner(z) / den
        mag = torch.abs(step)
        step = torch.where(mag > lim, step * (lim / mag), step)
        z = z - step
    return z


def _roots_dk(coeffs, n_iters: int = 96):
    """Real roots of batched degree-n polynomials by Durand-Kerner,
    run on both p(z) and its reversal w^n p(1/w) in one stacked batch.
    coeffs (..., n+1) high-to-low.  Returns (real parts (..., 2n),
    near_real (..., 2n)): the union of the two passes, Newton-polished.

    The reversal covers a tiny leading coefficient (the monic form's
    radius explodes); the forward pass covers roots near 0.  A candidate
    that is garbage in one pass is a converged root in the other, and
    RANSAC scoring discards the losers."""
    z, cs = _dk_complex_roots(coeffs, n_iters)
    n = coeffs.shape[-1] - 1
    re, im = z.real, z.imag
    near_real = torch.abs(im) < 1e-2 * (1.0 + torch.abs(re))

    # polish real parts with Newton on the max-normalised polynomial
    def horner_d(x):
        acc = cs[..., 0:1].expand(x.shape)
        dacc = torch.zeros_like(x)
        for j in range(1, n + 1):
            dacc = dacc * x + acc
            acc = acc * x + cs[..., j:j + 1]
        return acc, dacc

    x = re
    for _ in range(3):
        p, dp = horner_d(x)
        x = x - p / torch.where(torch.abs(dp) < 1e-20, 1e-20, dp)
    return x, near_real


def _dk_complex_roots(coeffs, n_iters: int = 96):
    """_roots_dk's two Durand-Kerner passes -> (the 2n complex roots, the
    max-normalised coefficients)."""
    n = coeffs.shape[-1] - 1
    ctype = torch.complex64 if coeffs.dtype == torch.float32 \
        else torch.complex128
    mag = torch.amax(torch.abs(coeffs), -1, keepdim=True)
    cs = coeffs / torch.clamp(mag, min=1e-30)

    def monic(c):
        lead = c[..., 0:1]
        lead = torch.where(torch.abs(lead) < 1e-20, 1e-20, lead)
        return (c / lead).to(ctype)

    both = torch.stack([monic(cs), monic(torch.flip(cs, [-1]))], 0)
    zb = _dk_pass(both, n, n_iters)
    zf, zw = zb[0], zb[1]
    zw_safe = torch.where(torch.abs(zw) < 1e-20, 1e-20, zw)
    return torch.cat([zf, 1.0 / zw_safe], -1), cs           # (..., 2n)


def _eval_poly(p, z):
    """p (..., P) high-to-low at z (...,) -> (...,)."""
    acc = p[..., 0]
    for k in range(1, p.shape[-1]):
        acc = acc * z + p[..., k]
    return acc


def _mono20_grad(x, y, z):
    """The 20 cubic monomials and their (x, y, z) partials at a batch of
    points -> four (..., 20) tensors."""
    vals, dxs, dys, dzs = [], [], [], []
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    for (i, j, k) in _MON20:
        xi = x ** i if i else 1.0
        yj = y ** j if j else 1.0
        zk = z ** k if k else 1.0
        vals.append(xi * yj * zk * one)
        dxs.append(i * (x ** (i - 1) if i > 1 else 1.0) * yj * zk * one
                   if i else zero)
        dys.append(j * xi * (y ** (j - 1) if j > 1 else 1.0) * zk * one
                   if j else zero)
        dzs.append(k * xi * yj * (z ** (k - 1) if k > 1 else 1.0) * one
                   if k else zero)
    return (torch.stack(vals, -1), torch.stack(dxs, -1),
            torch.stack(dys, -1), torch.stack(dzs, -1))


def _inv3(A):
    """Closed-form 3x3 inverse via cofactors, A (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)], -2)
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    return co / det[..., None, None]


def _gn_polish(M, x, y, z, iters: int = 8, lam: float = 1e-10):
    """Gauss-Newton polish of candidate (x, y, z) on the original 10 cubic
    constraints r = M mono20(x, y, z), which recovers the digits the
    expanded degree-10 det B(z) loses to float32 cancellation.  M (..., 10,
    20) row-normalised; x, y, z (..., C) candidates."""
    eye3 = lam * torch.eye(3, dtype=M.dtype, device=M.device)
    for _ in range(iters):
        v, dx, dy, dz = _mono20_grad(x, y, z)
        r = torch.einsum("...qe,...ce->...cq", M, v)
        Jx = torch.einsum("...qe,...ce->...cq", M, dx)
        Jy = torch.einsum("...qe,...ce->...cq", M, dy)
        Jz = torch.einsum("...qe,...ce->...cq", M, dz)
        J = torch.stack([Jx, Jy, Jz], -1)                  # (..., C, 10, 3)
        JtJ = torch.einsum("...qi,...qj->...ij", J, J) + eye3
        Jtr = torch.einsum("...qi,...q->...i", J, r)
        step = torch.einsum("...ij,...j->...i", _inv3(JtJ), Jtr)
        step = torch.clamp(step, -1.0, 1.0)
        x = x - step[..., 0]
        y = y - step[..., 1]
        z = z - step[..., 2]
    return x, y, z


def _nullspace_basis(x1, x2):
    """The orthonormalised basis E1..E4 of the 5x9 system's nullspace,
    (..., 4, 3, 3)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    Q = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                     u1, v1, one], -1)                   # (..., 5, 9)
    null = _nullspace4(Q)                                # (..., 9, 4)
    # modified Gram-Schmidt: the raw Gauss-Jordan basis can be wildly
    # skewed, which poisons the float32 constraint matrix downstream
    ortho = []
    for k in range(4):
        v = null[..., k]
        for u in ortho:
            v = v - torch.sum(v * u, -1, keepdim=True) * u
        n = torch.sqrt(torch.sum(v * v, -1, keepdim=True))
        ortho.append(v / torch.clamp(n, min=1e-20))
    null = torch.stack(ortho, -1)
    return null.transpose(-1, -2).reshape(*null.shape[:-2], 4, 3, 3)


def _five_point_plain(x1, x2, gn_iters: int = 8):
    """Kernel E's plain twin: `five_point` as a chain of torch operations."""
    basis = _nullspace_basis(x1, x2)
    M = _constraint_matrix(basis)                        # (..., 10, 20)
    rn = torch.amax(torch.abs(M), -1, keepdim=True)
    M = M / torch.clamp(rn, min=1e-30)                   # row equilibration
    a, b, c = _bz_rows(M)
    det = _det_bz(a, b, c)                               # (..., 11)
    z, valid = _roots_dk(det)                            # (..., 20)

    # (x, y) from the nullspace of B(z0): the cross product of the pair of
    # rows with the largest norm
    az = _eval_poly(a[..., None, :, :], z[..., None])    # (..., 20, 3)
    bz = _eval_poly(b[..., None, :, :], z[..., None])
    cz = _eval_poly(c[..., None, :, :], z[..., None])
    rows = torch.stack([az, bz, cz], -1)                 # (..., 20, 3r, 3c)

    def cross(i, j):
        return torch.linalg.cross(rows[..., i, :], rows[..., j, :])

    cands = torch.stack([cross(0, 1), cross(0, 2), cross(1, 2)], -2)
    nrm2 = torch.sum(cands * cands, -1)
    pick = torch.argmax(nrm2, -1)
    v = torch.take_along_dim(cands, pick[..., None, None], -2)[..., 0, :]
    w = torch.where(torch.abs(v[..., 2:]) > 1e-12, v[..., 2:], 1e-12)
    xy = v[..., :2] / w                                  # (..., 20, 2)

    # Garbage slots (invalid roots, near-zero w) can enter with huge
    # coordinates and overflow the cubic monomials: clamp the entry point
    # and keep the unpolished candidate wherever the polish went
    # non-finite; those slots lose at scoring either way.
    cx = torch.clamp(xy[..., 0], -1e4, 1e4)
    cy = torch.clamp(xy[..., 1], -1e4, 1e4)
    cz_ = torch.clamp(z, -1e4, 1e4)
    px, py, pz = _gn_polish(M, cx, cy, cz_, iters=gn_iters)
    fin = torch.isfinite(px) & torch.isfinite(py) & torch.isfinite(pz)
    px = torch.where(fin, px, xy[..., 0])
    py = torch.where(fin, py, xy[..., 1])
    pz = torch.where(fin, pz, z)

    E = (px[..., None, None] * basis[..., None, 0, :, :]
         + py[..., None, None] * basis[..., None, 1, :, :]
         + pz[..., None, None] * basis[..., None, 2, :, :]
         + basis[..., None, 3, :, :])
    nrm = torch.sqrt(torch.sum(E * E, (-1, -2), keepdim=True))
    E = E / torch.clamp(nrm, min=1e-12)
    # invalid root slots can carry inf / nan through the candidate math:
    # a unit-norm placeholder, marked invalid, keeps the scoring finite
    fin_E = torch.isfinite(E).all(-1).all(-1)
    eyeE = (torch.eye(3, dtype=E.dtype, device=E.device)
            / np.sqrt(3.0)).expand(E.shape)
    E = torch.where(fin_E[..., None, None], E, eyeE)
    return E, valid & fin_E


def check_kernel_inputs(x1: torch.Tensor, x2: torch.Tensor) -> None:
    """Raise ValueError unless x1 and x2 are what kernel E takes: float32,
    contiguous, the same shape (..., 5, 2), on one device."""
    for name, t in (("x1", x1), ("x2", x2)):
        if t.dtype != torch.float32:
            raise ValueError(f"five_point: {name} must be float32, got "
                             f"{t.dtype}")
        if t.dim() < 2 or tuple(t.shape[-2:]) != (5, 2):
            raise ValueError(f"five_point: {name} must be (..., 5, 2), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"five_point: {name} must be contiguous")
    if x1.shape != x2.shape or x1.device != x2.device:
        raise ValueError("five_point: x1 and x2 must have one shape and one "
                         "device")


def five_point(x1, x2, gn_iters: int = 8):
    """Essential matrices from 5 normalised correspondences.

    x1, x2: (..., 5, 2) -> (Es (..., 20, 3, 3), valid (..., 20)): up to 10
    real solutions in 20 candidate slots (forward and reversed root passes,
    see _roots_dk); invalid slots hold unit-norm placeholder matrices
    (score them anyway: they lose).  Kernel E on a CUDA tensor, one launch
    for every hypothesis of the call; the twin on a CPU one."""
    if x1.device.type == "cpu":
        return _five_point_plain(x1, x2, gn_iters)
    if x1.device.type != "cuda":
        raise ValueError(f"five_point: unsupported device {x1.device}")
    check_kernel_inputs(x1, x2)
    lead = tuple(x1.shape[:-2])
    n = x1.numel() // 10
    Es = torch.empty(lead + (20, 3, 3), dtype=torch.float32, device=x1.device)
    valid = torch.empty(lead + (20,), dtype=torch.bool, device=x1.device)
    if n:
        with torch.cuda.device(x1.device):
            _build.launch("surf_fivepoint", _build.ptr(x1), _build.ptr(x2), n,
                          int(gn_iters), _build.ptr(Es), _build.ptr(valid),
                          _build.stream(x1.device))
    return Es, valid
