"""Two-view geometry: batched 8-point essential matrix, RANSAC and pose
(port of cuda_surf_tpu/geometry/epipolar.py).

RANSAC keeps the JAX package's form: a static batch of H hypotheses is
sampled, solved and scored at once (the minimal solver batched over the
hypothesis axis, the scoring one dense Sampson-error pass), then the
winner is refitted twice on its inliers and decomposed by cheirality.
The only draw is `raw`, (H, n_pts) integers in [0, 2^31 - 1), from a
`torch.Generator` on the points' device; passing `raw` replaces the draw,
which is how a test feeds both packages the same samples.

Nothing here reads the device from the host.  Every linear solve is
`torch.linalg.solve_ex`, which neither checks its result on the host nor
raises on a singular system: the reference's solves return non-finite
values there, and the garbage five-point slots are exactly such systems
(they are masked later).  The reference's 3x3 SVDs (the projection onto
the essential manifold, the decomposition into poses) would synchronise
with the host on the card (`torch.linalg.svd` checks its result there),
so they are taken in closed form from the null vector instead: the same
matrices, as products U diag(1, 1, 0) Vt and as the four (R, t)
candidates, whatever signs and order an SVD would have given them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.timing import span

INT32_MAX = 2 ** 31 - 1


class TwoViewResult(NamedTuple):
    E: torch.Tensor          # (3, 3) essential matrix
    R: torch.Tensor          # (3, 3) rotation cam1 -> cam2
    t: torch.Tensor          # (3,) unit translation
    inliers: torch.Tensor    # (K,) bool
    n_inliers: torch.Tensor  # () int32
    points3d: torch.Tensor   # (K, 3) triangulated (in cam1 frame)


def _normalize_pts(p, mask):
    """Hartley normalisation over masked points, batched over leading
    dimensions: zero mean, mean distance sqrt(2).  p (..., K, 2)."""
    wsum = torch.clamp(mask.sum(-1), min=1.0)
    mean = (p * mask[..., None]).sum(-2) / wsum[..., None]
    d = torch.sqrt(((p - mean[..., None, :]) ** 2).sum(-1))
    scale = math.sqrt(2.0) / torch.clamp((d * mask).sum(-1) / wsum,
                                         min=1e-12)
    z, o = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([torch.stack([scale, z, -scale * mean[..., 0]], -1),
                     torch.stack([z, scale, -scale * mean[..., 1]], -1),
                     torch.stack([z, z, o], -1)], -2)
    return (p - mean[..., None, :]) * scale[..., None, None], T


def _smallest_eigvec9(M, iters: int = 4):
    """Eigenvector of the smallest eigenvalue of PSD (..., 9, 9) matrices
    by regularised inverse iteration from a fixed start, as the reference
    computes it (an eigh gives other last bits and other signs)."""
    eye = torch.eye(9, dtype=M.dtype, device=M.device)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    eps = 1e-9 * tr + 1e-20
    B = M + eps[..., None, None] * eye
    v = torch.linspace(1.0, 2.0, 9, dtype=M.dtype, device=M.device)
    v = (v / torch.linalg.norm(v)).expand(M.shape[:-1])
    for _ in range(iters):
        w = torch.linalg.solve_ex(B, v[..., None])[0][..., 0]
        v = w * torch.rsqrt(torch.clamp((w * w).sum(-1, keepdim=True),
                                        min=1e-30))
    return v


def _eight_point(x1, x2, mask):
    """Fundamental / essential system from >= 8 normalised-camera
    correspondences, batched over leading dimensions: the smallest
    eigenvector of the 9x9 normal matrix.  Returns the UNPROJECTED F;
    callers project the final winner once via `project_essential`."""
    p1, T1 = _normalize_pts(x1, mask)
    p2, T2 = _normalize_pts(x2, mask)
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], -1)
    A = A * mask[..., None]
    F = _smallest_eigvec9(A.transpose(-1, -2) @ A).reshape(
        *A.shape[:-2], 3, 3)
    return T2.transpose(-1, -2) @ F @ T1


def _unit(v):
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                       min=1e-30))


def _null_right(F, iters: int = 3):
    """The right singular vector of the smallest singular value of (..., 3,
    3) F: the cross product of the pair of rows with the largest norm (the
    null vector when F has rank 2), refined by regularised inverse
    iteration on F^T F, as _smallest_eigvec9 does for the 9x9 system, but
    in float64: in float32 the shift of 1e-9 of the trace lies below the
    rounding of F^T F, and the LU of a rank-2 F's system can meet a zero
    pivot and return NaN, while a shift above the rounding slows the
    iteration where F's second singular value is small (planar scenes)."""
    r = [F[..., i, :] for i in range(3)]
    cands = torch.stack([torch.linalg.cross(r[0], r[1]),
                         torch.linalg.cross(r[0], r[2]),
                         torch.linalg.cross(r[1], r[2])], -2)
    pick = torch.argmax((cands * cands).sum(-1), -1)
    v = _unit(torch.take_along_dim(cands, pick[..., None, None],
                                   -2)[..., 0, :]).double()
    F64 = F.double()
    A = F64.transpose(-1, -2) @ F64
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A + (1e-9 * tr + 1e-30)[..., None, None] * eye
    for _ in range(iters):
        v = _unit(torch.linalg.solve_ex(B, v[..., None])[0][..., 0])
    return v.to(F.dtype)


def _plane_basis(F, v3):
    """Orthonormal e1, e2 with e1 x e2 = v3: e1 is F's longest row with its
    v3 component removed."""
    pick = torch.argmax((F * F).sum(-1), -1)
    r = torch.take_along_dim(F, pick[..., None, None], -2)[..., 0, :]
    e1 = _unit(r - (r * v3).sum(-1, keepdim=True) * v3)
    return e1, torch.linalg.cross(v3, e1)


def project_essential(F):
    """Project onto the essential manifold (singular values 1, 1, 0): the
    SVD's U diag(1, 1, 0) Vt, computed as the polar factor of F on the
    plane orthogonal to its smallest right singular vector v3.  With B =
    [e1 e2] a basis of that plane, A = F B has the singular values of F
    but the smallest, and A (A^T A)^(-1/2) B^T = U diag(1, 1, 0) Vt.

    F is first scaled to a largest entry of 1 (the projection does not
    depend on the scale, and a refit from one inlier gives entries ~1e24,
    whose squares overflow).  F = 0 (the refit from no inlier) projects to
    diag(1, 1, 0), as the SVD's identity frames give it: a zero E would
    make every point an inlier (Sampson 0 / 0)."""
    zero = (F == 0).all(-1).all(-1)
    F = F / torch.clamp(torch.abs(F).amax((-2, -1), keepdim=True), min=1e-30)
    v3 = _null_right(F)
    e1, e2 = _plane_basis(F, v3)
    a1, a2 = F @ e1[..., None], F @ e2[..., None]          # (..., 3, 1)
    p = (a1 * a1).sum((-2, -1))
    q = (a1 * a2).sum((-2, -1))
    r = (a2 * a2).sum((-2, -1))
    # (A^T A)^(1/2) = (S + sqrt(det S) I) / sqrt(tr S + 2 sqrt(det S)) for
    # a 2x2 SPD S; its inverse in closed form
    sd = torch.sqrt(torch.clamp(p * r - q * q, min=0.0))
    k = torch.rsqrt(torch.clamp(p + r + 2 * sd, min=1e-30))
    h11, h12, h22 = (p + sd) * k, q * k, (r + sd) * k
    idet = 1.0 / torch.clamp(h11 * h22 - h12 * h12, min=1e-30)
    i11, i12, i22 = h22 * idet, -h12 * idet, h11 * idet
    c1 = a1 * i11[..., None, None] + a2 * i12[..., None, None]
    c2 = a1 * i12[..., None, None] + a2 * i22[..., None, None]
    E = c1 @ e1[..., None, :] + c2 @ e2[..., None, :]
    diag110 = torch.diag((torch.arange(3, device=F.device) < 2).to(F.dtype))
    return torch.where(zero[..., None, None], diag110, E)


def _svd_frames(E):
    """Proper rotations U, V with E = U diag(1, 1, 0) V^T for an essential
    E: V = [e1, e2, v3] from the null vector, U's first two columns E e1
    and E e2, orthonormalised (Gram-Schmidt), the third their cross
    product.  -> (U, V)."""
    v3 = _null_right(E)
    e1, e2 = _plane_basis(E, v3)
    u1 = _unit((E @ e1[..., None])[..., 0])
    u3 = _unit(torch.linalg.cross(u1, (E @ e2[..., None])[..., 0]))
    u2 = torch.linalg.cross(u3, u1)
    return (torch.stack([u1, u2, u3], -1), torch.stack([e1, e2, v3], -1))


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def sampson_error(E, x1, x2):
    """Squared Sampson distance in normalised coordinates."""
    h1, h2 = _homogeneous(x1), _homogeneous(x2)
    Ex1 = h1 @ E.transpose(-1, -2)
    Etx2 = h2 @ E
    num = torch.sum(h2 * Ex1, -1) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
           + Etx2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def _sampson_inlier_counts(Es, x1, x2, valid, thresh):
    """Inlier counts of a whole batch of E candidates at once: Es
    (M, 3, 3) -> (M,) int32, from two (K, 3) @ (3, 3M) products and the
    division-free test num < t * max(den, 1e-12)."""
    h1, h2 = _homogeneous(x1), _homogeneous(x2)
    M = Es.shape[0]
    # Ex1[k, m, c] = sum_j E[m, c, j] h1[k, j]
    Ex1 = (h1 @ Es.reshape(M * 3, 3).T).reshape(-1, M, 3)
    # Etx2[k, m, j] = sum_c E[m, c, j] h2[k, c]
    Etx2 = (h2 @ Es.transpose(-1, -2).reshape(M * 3, 3).T).reshape(-1, M, 3)
    num = torch.sum(h2[:, None, :] * Ex1, -1) ** 2            # (K, M)
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
           + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    inl = (num < thresh * torch.clamp(den, min=1e-12)) & valid[:, None]
    return inl.sum(0, dtype=torch.int32)


def triangulate(R, t, x1, x2):
    """DLT triangulation for cameras [I|0] and [R|t], batched over the
    leading dimensions of R (..., 3, 3) and t (..., 3): the 4 DLT rows with
    w = 1 give A[:, :3] X = -A[:, 3], solved in closed form via the 3x3
    normal equations (Cramer).  x1, x2 (K, 2) -> (..., K, 3) points in
    the cam1 frame."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    P1 = torch.cat([eye, torch.zeros((3, 1), dtype=R.dtype,
                                     device=R.device)], 1)
    P2 = torch.cat([R, t[..., :, None]], -1)

    def rows(P, x):
        P = P[..., None, :, :]                       # (..., 1, 3, 4)
        return torch.stack([x[..., 0, None] * P[..., 2, :] - P[..., 0, :],
                            x[..., 1, None] * P[..., 2, :] - P[..., 1, :]],
                           -2)                       # (..., K, 2, 4)

    r2 = rows(P2, x2)
    A = torch.cat([rows(P1, x1).expand(r2.shape), r2], -2)  # (..., K, 4, 4)
    M = torch.einsum("...kij,...kil->...kjl", A[..., :3], A[..., :3])
    b = -torch.einsum("...kij,...ki->...kj", A[..., :3], A[..., 3])

    # Cramer's rule on the symmetric 3x3 normal system
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m11, m12, m22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    # degenerate rays -> arbitrary finite point (rejected by cheirality)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    X = torch.stack([c00 * b0 + c01 * b1 + c02 * b2,
                     c01 * b0 + c11 * b1 + c12 * b2,
                     c02 * b0 + c12 * b1 + c22 * b2], -1)
    return X * inv_det[..., None]


def _take(a, i):
    """a[i] for a 0-d index tensor, as a gather (no host sync)."""
    return torch.index_select(a, 0, i.reshape(1))[0]


def recover_pose(E, x1, x2, mask):
    """Decompose E into its 4 (R, t) candidates and pick by cheirality;
    the 4 candidates' triangulations and depth tests run as one batch.
    -> (R, t, points (K, 3))."""
    U, V = _svd_frames(E)                           # proper rotations
    # U W and U W^T for W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]: column
    # permutations with signs, exact
    UW = torch.stack([U[:, 1], -U[:, 0], U[:, 2]], -1)
    UWt = torch.stack([-U[:, 1], U[:, 0], U[:, 2]], -1)
    Ra = UW @ V.T
    Rb = UWt @ V.T
    tu = U[:, 2]
    Rs = torch.stack([Ra, Ra, Rb, Rb])                   # (4, 3, 3)
    ts = torch.stack([tu, -tu, tu, -tu])                 # (4, 3)
    Xs = triangulate(Rs, ts, x1, x2)                     # (4, K, 3)
    z1 = Xs[..., 2]
    z2 = (torch.einsum("cki,cji->ckj", Xs, Rs) + ts[:, None, :])[..., 2]
    counts = ((z1 > 0) & (z2 > 0) & mask[None, :]).sum(-1)
    best = torch.argmax(counts)                          # the first maximum
    return _take(Rs, best), _take(ts, best), _take(Xs, best)


def draw_raw(n_hypotheses: int, n_pts: int, device,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """(H, n_pts) int32 in [0, 2^31 - 1), the range of the reference's
    `jax.random.randint(key, (H, n_pts), 0, int32 max)`."""
    return torch.randint(0, INT32_MAX, (n_hypotheses, n_pts),
                         generator=generator, device=device,
                         dtype=torch.int32)


def sample_rows(valid, raw):
    """The (raw % count)-th valid row of each draw, by binary search on the
    validity prefix sum: searchsorted(cdf, r + 1) is the index of the
    (r + 1)-th valid row.  Clamped to K - 1 (searchsorted returns K when no
    row is valid; the reference's gather clamps silently)."""
    k = valid.shape[0]
    cdf = torch.cumsum(valid, 0, dtype=torch.int32)
    count = torch.clamp(cdf[-1], min=1)
    tgt = torch.remainder(raw.to(torch.int32), count) + 1
    sample = torch.searchsorted(cdf, tgt.reshape(-1)).reshape(tgt.shape)
    return torch.clamp(sample, max=k - 1)


def hypotheses(x1, x2, sample, solver: str):
    """Minimal fits of the sampled rows -> (Es (M, 3, 3), cand_ok (M,))."""
    if solver == "8pt":
        m = torch.ones(sample.shape, dtype=x1.dtype, device=x1.device)
        Es = _eight_point(x1[sample], x2[sample], m)        # (H, 3, 3)
        return Es, torch.ones(Es.shape[0], dtype=torch.bool,
                              device=Es.device)
    from .fivepoint import five_point
    # gn_iters=4, as the reference passes (its comment says 2)
    with span("vo.fivepoint"):
        Es, cand_ok = five_point(x1[sample], x2[sample], gn_iters=4)
    return Es.reshape(-1, 3, 3), cand_ok.reshape(-1)


def refit(E_best, x1, x2, valid, inlier_thresh: float):
    """The winner, projected, then two rounds of least-squares refits on
    its inliers, each accepted only if its projected candidate keeps at
    least as many inliers.  -> (E, inliers)."""
    E = project_essential(E_best)
    inliers = (sampson_error(E, x1, x2) < inlier_thresh) & valid
    n_best = inliers.sum()
    for _ in range(2):
        E_new = project_essential(
            _eight_point(x1, x2, inliers.to(x1.dtype)))
        inl_new = (sampson_error(E_new, x1, x2) < inlier_thresh) & valid
        use = inl_new.sum() >= n_best
        E = torch.where(use, E_new, E)
        inliers = torch.where(use, inl_new, inliers)
        n_best = torch.maximum(inl_new.sum(), n_best)
    return E, inliers


def ransac_essential(x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor,
                     generator: torch.Generator | None = None,
                     n_hypotheses: int = 512, inlier_thresh: float = 1e-4,
                     solver: str = "8pt",
                     raw: torch.Tensor | None = None) -> TwoViewResult:
    """Parallel-hypothesis RANSAC for E from normalised correspondences.

    x1, x2: (K, 2) normalised camera coordinates; valid: (K,) mask.
    inlier_thresh: squared Sampson distance threshold.  solver: "8pt"
    (least-squares minimal fit) or "5pt" (Nister minimal solver, up to 10
    essential matrices a sample, all scored in the same pass).  `raw`
    (H, n_pts) replaces the draw from `generator`.
    """
    if solver not in ("8pt", "5pt"):
        raise ValueError(f"ransac_essential: unknown solver {solver!r}")
    n_pts = 8 if solver == "8pt" else 5
    if raw is None:
        raw = draw_raw(n_hypotheses, n_pts, x1.device, generator)
    elif raw.shape[-1] != n_pts:
        raise ValueError(f"ransac_essential: raw has {raw.shape[-1]} "
                         f"columns, the {solver} solver draws {n_pts}")
    sample = sample_rows(valid, raw.to(x1.device))
    Es, cand_ok = hypotheses(x1, x2, sample, solver)
    with span("vo.score"):
        counts = _sampson_inlier_counts(Es, x1, x2, valid, inlier_thresh)
    scores = torch.where(cand_ok, counts, -1)
    with span("vo.refit"):
        E, inliers = refit(_take(Es, torch.argmax(scores)), x1, x2, valid,
                           inlier_thresh)
        R, t, X = recover_pose(E, x1, x2, inliers)
    return TwoViewResult(E=E, R=R, t=t, inliers=inliers,
                         n_inliers=inliers.sum(dtype=torch.int32),
                         points3d=X)


def normalize_with_intrinsics(pts: torch.Tensor, fx, fy, cx, cy):
    """Pixel -> normalised camera coordinates."""
    return torch.stack([(pts[..., 0] - cx) / fx, (pts[..., 1] - cy) / fy],
                       -1)
