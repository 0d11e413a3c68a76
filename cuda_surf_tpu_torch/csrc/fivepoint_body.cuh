// The device arithmetic of kernel E (csrc/fivepoint.cu): Nister's
// five-point solver for one hypothesis, run by one warp.  The plain twin is
// cuda_surf_tpu_torch/geometry/fivepoint.py:_five_point_plain; every step
// below names the twin's function it repeats.
//
// Rounding.  The twin is a chain of torch operations, and each one rounds
// its result to float32.  Where the twin rounds once an operation, this code
// does too: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, which
// nvcc never contracts into an FMA.  Inside one torch operation the code
// repeats what that operation's kernel computes on the card (torch 2.11,
// cuBLAS of CUDA 12.8; each checked bit for bit against the card):
//   * a sum over the last axis of 9 (or 3) elements: torch's reduction
//     kernel gives each of 8 (2) lanes the elements lane, lane + 8 and then
//     folds the lanes with shuffles at offsets 4, 2, 1 (sum9, sum3);
//   * the product of Durand-Kerner's 10 differences: the same tree, in
//     torch's runtime-compiled reduction, whose complex products contract
//     nothing (prod10, cmul_rn);
//   * an elementwise complex product and quotient: c10::complex's formulas
//     (Smith's division) with the multiply-adds nvcc contracts as FMAs
//     (cmul, cdiv), and torch.linalg.cross the same way (cross3);
//   * the float32 matrix products of the Gauss-Newton polish (einsum ->
//     cuBLAS, TF32 off): a GEMM sums with one FMA a term in order (dot); a
//     GEMV over 10 terms keeps two FMA chains, over the even and the odd
//     terms, and adds them (dot10_gemv); over 3 terms, one chain over the
//     first two and the third's product added (dot3_gemv);
//   * a division of a tensor by a Python number: a product with the float32
//     reciprocal, as torch does on the card;
//   * the 10x10 solve's LU factorisation: cuBLAS's batched getrf, the
//     first largest pivot, multipliers as a product with the pivot's
//     reciprocal, FMA updates;
//   * the triangular solves after it: cuBLAS's batched getrs, in blocks of
//     8 rows (fp_solve).

#pragma once

#define FP_SLOTS 20        // candidate slots: 10 forward and 10 reversed roots
#define FP_DK_ROUNDS 96    // Durand-Kerner rounds a pass (_roots_dk)
#define FP_NEWTON 3        // Newton steps on each root's real part
#define FP_FULL 0xffffffffu

// _LL (lin x lin -> quad), _QL (quad x lin -> cubic) and _MON20 of
// geometry/fivepoint.py, as tables local to functions so that the unrolled
// loops index them with constants; tests/test_torch_fivepoint.py holds these
// literals to the Python tables.
__device__ __forceinline__ int fp_ll(int a, int b) {
  constexpr unsigned char LL[4][4] = {
      {0, 1, 2, 6}, {1, 3, 4, 7}, {2, 4, 5, 8}, {6, 7, 8, 9}};
  return LL[a][b];
}

__device__ __forceinline__ int fp_ql(int a, int b) {
  constexpr unsigned char QL[10][4] = {
      {0, 1, 2, 3}, {1, 4, 5, 6}, {2, 5, 10, 11}, {4, 7, 8, 9},
      {5, 8, 13, 14}, {10, 13, 16, 17}, {3, 6, 11, 12}, {6, 9, 14, 15},
      {11, 14, 17, 18}, {12, 15, 18, 19}};
  return QL[a][b];
}

__device__ __forceinline__ int fp_mon20(int e, int v) {
  constexpr unsigned char MON20[20][3] = {
      {3, 0, 0}, {2, 1, 0}, {2, 0, 1}, {2, 0, 0}, {1, 2, 0}, {1, 1, 1},
      {1, 1, 0}, {0, 3, 0}, {0, 2, 1}, {0, 2, 0}, {1, 0, 2}, {1, 0, 1},
      {1, 0, 0}, {0, 1, 2}, {0, 1, 1}, {0, 1, 0}, {0, 0, 3}, {0, 0, 2},
      {0, 0, 1}, {0, 0, 0}};
  return MON20[e][v];
}

// One warp's shared memory.
struct FpShared {
  float q[5][9];       // the 5x9 epipolar system under Gauss-Jordan
  float basis[4][9];   // the orthonormalised nullspace, E1..E4 row-major
  float g[9][10];      // G = E E^T as quadratics, entry (i, k) at 3 i + k
  float m[10][20];     // the row-equilibrated constraint matrix
  float lu[10][20];    // [M[:, :10] | M[:, 10:]] under elimination
  float gs[10][10];    // the solve's result
  float abc[3][13];    // B(z) row r: a (z^3..1), b (z^3..1), c (z^4..1)
};

struct Cf {
  float r, i;
};

__device__ __forceinline__ bool fp_isnan(float v) { return v != v; }

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return fp_isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_pm(float v, float lim) {
  return fp_isnan(v) ? v : fminf(fmaxf(v, -lim), lim);
}

// torch.amax: NaN wins
__device__ __forceinline__ float amax_nan(float m, float v) {
  return (v > m || fp_isnan(v)) ? v : m;
}

__device__ __forceinline__ float sum9(const float* e) {
  float l0 = __fadd_rn(__fadd_rn(e[0], e[8]), e[4]);
  float l1 = __fadd_rn(e[1], e[5]);
  float l2 = __fadd_rn(e[2], e[6]);
  float l3 = __fadd_rn(e[3], e[7]);
  return __fadd_rn(__fadd_rn(l0, l2), __fadd_rn(l1, l3));
}

__device__ __forceinline__ float sum3(float e0, float e1, float e2) {
  return __fadd_rn(__fadd_rn(e0, e2), e1);
}

__device__ __forceinline__ Cf cmul(Cf a, Cf b) {
  return {__fmaf_rn(a.r, b.r, -__fmul_rn(a.i, b.i)),
          __fmaf_rn(a.r, b.i, __fmul_rn(a.i, b.r))};
}

// a complex product with nothing contracted
__device__ __forceinline__ Cf cmul_rn(Cf a, Cf b) {
  return {__fsub_rn(__fmul_rn(a.r, b.r), __fmul_rn(a.i, b.i)),
          __fadd_rn(__fmul_rn(a.r, b.i), __fmul_rn(a.i, b.r))};
}

__device__ __forceinline__ Cf cdiv(Cf x, Cf y) {
  const float a = x.r, b = x.i, c = y.r, d = y.i;
  const float ac = fabsf(c), ad = fabsf(d);
  if (ac >= ad) {
    if (ac == 0.f && ad == 0.f) return {__fdiv_rn(a, ac), __fdiv_rn(b, ad)};
    const float rat = __fdiv_rn(d, c);
    const float scl = __fdiv_rn(1.f, __fmaf_rn(d, rat, c));
    return {__fmul_rn(__fmaf_rn(b, rat, a), scl),
            __fmul_rn(__fmaf_rn(-a, rat, b), scl)};
  }
  const float rat = __fdiv_rn(c, d);
  const float scl = __fdiv_rn(1.f, __fmaf_rn(c, rat, d));
  return {__fmul_rn(__fmaf_rn(a, rat, b), scl),
          __fmul_rn(__fmaf_rn(b, rat, -a), scl)};
}

__device__ __forceinline__ float cabs(Cf a) { return hypotf(a.r, a.i); }

__device__ __forceinline__ Cf prod10(const Cf* d) {
  const Cf l0 = cmul_rn(cmul_rn(d[0], d[8]), d[4]);
  const Cf l1 = cmul_rn(cmul_rn(d[1], d[9]), d[5]);
  return cmul_rn(cmul_rn(l0, cmul_rn(d[2], d[6])),
                 cmul_rn(l1, cmul_rn(d[3], d[7])));
}

// torch.linalg.cross(u, v)
__device__ __forceinline__ void cross3(const float* u, const float* v,
                                       float* out) {
  out[0] = __fmaf_rn(u[1], v[2], -__fmul_rn(u[2], v[1]));
  out[1] = __fmaf_rn(u[2], v[0], -__fmul_rn(u[0], v[2]));
  out[2] = __fmaf_rn(u[0], v[1], -__fmul_rn(u[1], v[0]));
}

// _lin_mul: (4) x (4) -> (10), a outer, b inner, from 0.0
__device__ __forceinline__ void lin_mul(const float* p, const float* q,
                                        float* out) {
#pragma unroll
  for (int t = 0; t < 10; ++t) out[t] = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[fp_ll(a, b)] = __fadd_rn(out[fp_ll(a, b)], __fmul_rn(p[a], q[b]));
}

// _quad_lin_mul: (10) x (4) -> (20)
__device__ __forceinline__ void quad_lin_mul(const float* Q, const float* p,
                                             float* out) {
#pragma unroll
  for (int t = 0; t < 20; ++t) out[t] = 0.f;
#pragma unroll
  for (int a = 0; a < 10; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[fp_ql(a, b)] = __fadd_rn(out[fp_ql(a, b)], __fmul_rn(Q[a], p[b]));
}

// _poly_mul: (P) x (Q) -> (P + Q - 1), high to low, i outer, j inner
template <int P, int Q>
__device__ __forceinline__ void poly_mul(const float* p, const float* q,
                                         float* out) {
#pragma unroll
  for (int t = 0; t < P + Q - 1; ++t) out[t] = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j)
      out[i + j] = __fadd_rn(out[i + j], __fmul_rn(p[i], q[j]));
}

// _poly_mul(u_i, v_j) - _poly_mul(u_j, v_i)
template <int P, int Q>
__device__ __forceinline__ void poly_minor(const float* ui, const float* vj,
                                           const float* uj, const float* vi,
                                           float* out) {
  float s[P + Q - 1], t[P + Q - 1];
  poly_mul<P, Q>(ui, vj, s);
  poly_mul<P, Q>(uj, vi, t);
#pragma unroll
  for (int k = 0; k < P + Q - 1; ++k) out[k] = __fsub_rn(s[k], t[k]);
}

// the basis matrices' (i, j) entries as a linear polynomial in x, y, z, 1
__device__ __forceinline__ void lin_entry(const FpShared& sm, int i, int j,
                                          float* e) {
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = sm.basis[k][3 * i + j];
}

__device__ __forceinline__ void lm(const FpShared& sm, int i, int j, int k,
                                   int l, float* out) {
  float p[4], q[4];
  lin_entry(sm, i, j, p);
  lin_entry(sm, k, l, q);
  lin_mul(p, q, out);
}

// the product of a chain of factors as torch evaluates `c * f1 * f2 * f3`
// left to right: the Python number c, then each tensor factor present
__device__ __forceinline__ float chain(float c, int n, float f1, float f2,
                                       float f3) {
  float acc = c;
  if (n > 0) acc = __fmul_rn(acc, f1);
  if (n > 1) acc = __fmul_rn(acc, f2);
  if (n > 2) acc = __fmul_rn(acc, f3);
  return acc;
}

// v ** e for e in 1..3 (torch: copy, v * v, v * v * v)
__device__ __forceinline__ float ipow(float v, float v2, int e) {
  return e == 1 ? v : (e == 2 ? v2 : __fmul_rn(v2, v));
}

// _mono20_grad for monomial (i, j, k) at (x, y, z): the value and the
// three partials, each as the twin's expression composes it
__device__ __forceinline__ void mono_grad(int i, int j, int k, float x,
                                          float y, float z, float x2,
                                          float y2, float z2, float* out) {
  float f[3] = {0.f, 0.f, 0.f};
  int n = 0;
  // value: xi * yj * zk
  if (i) f[n++] = ipow(x, x2, i);
  if (j) f[n++] = ipow(y, y2, j);
  if (k) f[n++] = ipow(z, z2, k);
  out[0] = chain(1.f, n, f[0], f[1], f[2]);
  // d/dx: i * x^(i-1) * yj * zk
  n = 0;
  if (i > 1) f[n++] = i == 2 ? x : x2;
  if (j) f[n++] = ipow(y, y2, j);
  if (k) f[n++] = ipow(z, z2, k);
  out[1] = i ? chain((float)i, n, f[0], f[1], f[2]) : 0.f;
  // d/dy: j * xi * y^(j-1) * zk
  n = 0;
  if (i) f[n++] = ipow(x, x2, i);
  if (j > 1) f[n++] = j == 2 ? y : y2;
  if (k) f[n++] = ipow(z, z2, k);
  out[2] = j ? chain((float)j, n, f[0], f[1], f[2]) : 0.f;
  // d/dz: k * xi * yj * z^(k-1)
  n = 0;
  if (i) f[n++] = ipow(x, x2, i);
  if (j) f[n++] = ipow(y, y2, j);
  if (k > 1) f[n++] = k == 2 ? z : z2;
  out[3] = k ? chain((float)k, n, f[0], f[1], f[2]) : 0.f;
}

// Q (5x9), _nullspace4's Gauss-Jordan and the modified Gram-Schmidt of
// five_point, on one lane -> sm.basis.
__device__ void fp_nullspace(const float* x1, const float* x2, FpShared& sm) {
  float(*Q)[9] = sm.q;
  for (int r = 0; r < 5; ++r) {
    const float u1 = x1[2 * r], v1 = x1[2 * r + 1];
    const float u2 = x2[2 * r], v2 = x2[2 * r + 1];
    Q[r][0] = __fmul_rn(u2, u1);
    Q[r][1] = __fmul_rn(u2, v1);
    Q[r][2] = u2;
    Q[r][3] = __fmul_rn(v2, u1);
    Q[r][4] = __fmul_rn(v2, v1);
    Q[r][5] = v2;
    Q[r][6] = u1;
    Q[r][7] = v1;
    Q[r][8] = 1.f;
  }
  unsigned avail = 0x1ffu;
  int pivrow[9];
  for (int c = 0; c < 9; ++c) pivrow[c] = -1;
  for (int i = 0; i < 5; ++i) {
    // the first largest |entry| among the available columns
    int piv = -1;
    float best = -1.f;
    for (int j = 0; j < 9; ++j) {
      const float a = (avail >> j & 1u) ? fabsf(Q[i][j]) : -1.f;
      if (a > best) {
        best = a;
        piv = j;
      }
    }
    if (piv < 0) piv = __ffs(avail) - 1;   // a NaN row: any free column
    float v = Q[i][piv];
    if (fabsf(v) < 1e-25f) v = 1e-25f;
    float coef[5];
    for (int r = 0; r < 5; ++r) coef[r] = Q[r][piv];
    for (int j = 0; j < 9; ++j) Q[i][j] = __fdiv_rn(Q[i][j], v);
    for (int r = 0; r < 5; ++r) {
      if (r == i) continue;
      for (int j = 0; j < 9; ++j)
        Q[r][j] = __fsub_rn(Q[r][j], __fmul_rn(coef[r], Q[i][j]));
    }
    pivrow[piv] = i;
    avail &= ~(1u << piv);
  }
  // the 4 free columns in increasing order, each a nullspace vector
  float o[4][9];
  int k = 0;
  for (int f = 0; f < 9 && k < 4; ++f) {
    if (!(avail >> f & 1u)) continue;
    for (int c = 0; c < 9; ++c)
      o[k][c] = c == f ? 1.f
                       : (pivrow[c] >= 0 ? __fsub_rn(0.f, Q[pivrow[c]][f])
                                         : 0.f);
    ++k;
  }
  // modified Gram-Schmidt
  for (int k2 = 0; k2 < 4; ++k2) {
    float v[9], p[9];
    for (int c = 0; c < 9; ++c) v[c] = o[k2][c];
    for (int u = 0; u < k2; ++u) {
      for (int c = 0; c < 9; ++c) p[c] = __fmul_rn(v[c], o[u][c]);
      const float s = sum9(p);
      for (int c = 0; c < 9; ++c)
        v[c] = __fsub_rn(v[c], __fmul_rn(s, o[u][c]));
    }
    for (int c = 0; c < 9; ++c) p[c] = __fmul_rn(v[c], v[c]);
    const float n = clamp_min(__fsqrt_rn(sum9(p)), 1e-20f);
    for (int c = 0; c < 9; ++c) o[k2][c] = __fdiv_rn(v[c], n);
    for (int c = 0; c < 9; ++c) sm.basis[k2][c] = o[k2][c];
  }
}

// lanes 0..8: G[i][k] = sum_j lm(i, j, k, j), from 0 (Python's sum)
__device__ void fp_gram(FpShared& sm, int lane) {
  const int i = lane / 3, k = lane % 3;
  float acc[10], t[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) acc[c] = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    lm(sm, i, j, k, j, t);
#pragma unroll
    for (int c = 0; c < 10; ++c) acc[c] = __fadd_rn(acc[c], t[c]);
  }
#pragma unroll
  for (int c = 0; c < 10; ++c) sm.g[lane][c] = acc[c];
}

// lanes 0..9: row `lane` of _constraint_matrix, row-equilibrated, into
// sm.m and sm.lu
__device__ void fp_constraint_row(FpShared& sm, int lane) {
  float row[20], t[20], e[4];
  if (lane == 0) {
    // det(E) = 0
    float u[10], w[10], s[10];
    const int pick[3][8] = {{1, 1, 2, 2, 1, 2, 2, 1},
                            {1, 0, 2, 2, 1, 2, 2, 0},
                            {1, 0, 2, 1, 1, 1, 2, 0}};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lm(sm, pick[c][0], pick[c][1], pick[c][2], pick[c][3], u);
      lm(sm, pick[c][4], pick[c][5], pick[c][6], pick[c][7], w);
#pragma unroll
      for (int q = 0; q < 10; ++q) s[q] = __fsub_rn(u[q], w[q]);
      lin_entry(sm, 0, c, e);
      quad_lin_mul(s, e, t);
#pragma unroll
      for (int q = 0; q < 20; ++q)
        row[q] = c == 0 ? t[q]
                        : (c == 1 ? __fsub_rn(row[q], t[q])
                                  : __fadd_rn(row[q], t[q]));
    }
  } else {
    // 2 E E^T E - tr(E E^T) E, entry (i, l)
    const int i = (lane - 1) / 3, l = (lane - 1) % 3;
    float acc[20], tr[10];
#pragma unroll
    for (int q = 0; q < 20; ++q) acc[q] = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lin_entry(sm, k, l, e);
      quad_lin_mul(sm.g[3 * i + k], e, t);
#pragma unroll
      for (int q = 0; q < 20; ++q) acc[q] = __fadd_rn(acc[q], t[q]);
    }
#pragma unroll
    for (int q = 0; q < 10; ++q)
      tr[q] = __fadd_rn(__fadd_rn(sm.g[0][q], sm.g[4][q]), sm.g[8][q]);
    lin_entry(sm, i, l, e);
    quad_lin_mul(tr, e, t);
#pragma unroll
    for (int q = 0; q < 20; ++q)
      row[q] = __fsub_rn(__fmul_rn(2.f, acc[q]), t[q]);
  }
  // row equilibration
  float rn = 0.f;
#pragma unroll
  for (int q = 0; q < 20; ++q) rn = amax_nan(rn, fabsf(row[q]));
  rn = clamp_min(rn, 1e-30f);
#pragma unroll
  for (int q = 0; q < 20; ++q) {
    const float v = __fdiv_rn(row[q], rn);
    sm.m[lane][q] = v;
    sm.lu[lane][q] = v;
  }
}

// all lanes: G = solve(M[:, :10], M[:, 10:]) as cuBLAS's batched getrf and
// getrs compute it (lane j < 20 owns column j of [A | B]):
//   * LU with partial pivoting, the first largest |pivot|; the multipliers
//     a product with the pivot's reciprocal, the updates FMAs; each row
//     swap applied to B too (getrs's laswp);
//   * forward substitution with L in blocks of 8 rows: inside a block each
//     row subtracts the block's earlier rows in increasing order, one FMA
//     each; a later block first subtracts the dot product (an FMA chain
//     from 0) over every row of the blocks before;
//   * back substitution with U, blocks of 8 from the top row down but
//     solved from the bottom: rows 8, 9 alone; rows 0..7 first subtract the
//     dot product over rows 8, 9, then rows 7 .. i + 1 in decreasing order,
//     one FMA each; each row then divided by its diagonal.
// -> sm.gs
__device__ void fp_solve(FpShared& sm, int lane) {
  float(*A)[20] = sm.lu;
#pragma unroll 1
  for (int k = 0; k < 10; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
    for (int i = k + 1; i < 10; ++i) {
      const float a = fabsf(A[i][k]);
      if (a > best) {
        best = a;
        p = i;
      }
    }
    __syncwarp();
    if (lane < 20 && p != k) {
      const float t = A[k][lane];
      A[k][lane] = A[p][lane];
      A[p][lane] = t;
    }
    __syncwarp();
    if (lane == k) {
      const float rcp = __fdiv_rn(1.f, A[k][k]);
      for (int i = k + 1; i < 10; ++i) A[i][k] = __fmul_rn(A[i][k], rcp);
    }
    __syncwarp();
    if (lane > k && lane < 10) {
      const float ukj = A[k][lane];
      for (int i = k + 1; i < 10; ++i)
        A[i][lane] = __fmaf_rn(-A[i][k], ukj, A[i][lane]);
    }
    __syncwarp();
  }
  if (lane >= 10 && lane < 20) {
    float x[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      float acc = A[i][lane];
      const int blk = i < 8 ? 0 : 8;
      if (blk) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) s = __fmaf_rn(A[i][k], x[k], s);
        acc = __fsub_rn(acc, s);
      }
#pragma unroll
      for (int k = blk; k < i; ++k) acc = __fmaf_rn(-A[i][k], x[k], acc);
      x[i] = acc;
    }
#pragma unroll
    for (int i = 9; i >= 0; --i) {
      float acc = x[i];
      const int top = i < 8 ? 8 : 10;
      if (i < 8)
        acc = __fsub_rn(acc,
                        __fmaf_rn(A[i][9], x[9], __fmul_rn(A[i][8], x[8])));
#pragma unroll
      for (int k = top - 1; k > i; --k) acc = __fmaf_rn(-A[i][k], x[k], acc);
      x[i] = __fdiv_rn(acc, A[i][i]);
    }
#pragma unroll
    for (int i = 0; i < 10; ++i) sm.gs[i][lane - 10] = x[i];
  }
  __syncwarp();
}

// lanes 0..2: row `lane` of B(z) (_bz_rows)
__device__ void fp_bz_row(FpShared& sm, int lane) {
  // _ROW_X2 / _ROW_X2Z, _ROW_XY / _ROW_XYZ, _ROW_Y2 / _ROW_Y2Z
  const float* g = sm.gs[3 * lane + 3];
  const float* h = sm.gs[3 * lane + 2];
  float* o = sm.abc[lane];
  o[0] = g[0];
  o[1] = __fsub_rn(g[1], h[0]);
  o[2] = __fsub_rn(g[2], h[1]);
  o[3] = -h[2];
  o[4] = g[3];
  o[5] = __fsub_rn(g[4], h[3]);
  o[6] = __fsub_rn(g[5], h[4]);
  o[7] = -h[5];
  o[8] = g[6];
  o[9] = __fsub_rn(g[7], h[6]);
  o[10] = __fsub_rn(g[8], h[7]);
  o[11] = __fsub_rn(g[9], h[8]);
  o[12] = -h[9];
}

// every lane: det B(z)'s 11 coefficients, z^10..z^0 (_det_bz)
__device__ void fp_det_bz(const FpShared& sm, float* det) {
  // row r of B(z): a at r0 + 0, b at r0 + 4, c at r0 + 8
  const float* r0 = sm.abc[0];
  const float* r1 = sm.abc[1];
  const float* r2 = sm.abc[2];
  float mbc[8], mac[8], mab[7], s[11], t[11], u[11];
  poly_minor<4, 5>(r1 + 4, r2 + 8, r2 + 4, r1 + 8, mbc);   // b1 c2 - b2 c1
  poly_minor<4, 5>(r1, r2 + 8, r2, r1 + 8, mac);           // a1 c2 - a2 c1
  poly_minor<4, 4>(r1, r2 + 4, r2, r1 + 4, mab);           // a1 b2 - a2 b1
  poly_mul<4, 8>(r0, mbc, s);
  poly_mul<4, 8>(r0 + 4, mac, t);
  poly_mul<5, 7>(r0 + 8, mab, u);
#pragma unroll
  for (int k = 0; k < 11; ++k) det[k] = __fadd_rn(__fsub_rn(s[k], t[k]), u[k]);
}

// every lane: slot `slot` of _roots_dk on det (0..9 the forward pass,
// 10..19 the reversed one) -> the Newton-polished real part and near_real.
// Each Durand-Kerner round reads the other roots of the lane's pass from
// the lanes 10 h .. 10 h + 9 with shuffles; every lane of the warp takes
// part in them.
__device__ void fp_root(const float* det, int slot, float* x_out,
                        bool* near_out) {
  const int h = slot / 10, k = slot % 10, base = 10 * h;
  float mag = 0.f;
#pragma unroll
  for (int t = 0; t < 11; ++t) mag = amax_nan(mag, fabsf(det[t]));
  mag = clamp_min(mag, 1e-30f);
  float cs[11], c[11];
#pragma unroll
  for (int t = 0; t < 11; ++t) cs[t] = __fdiv_rn(det[t], mag);
  float lead = h ? cs[10] : cs[0];
  if (fabsf(lead) < 1e-20f) lead = 1e-20f;
#pragma unroll
  for (int t = 0; t < 11; ++t) c[t] = __fdiv_rn(h ? cs[10 - t] : cs[t], lead);
  // _dk_pass
  float radius = 0.f;
#pragma unroll
  for (int t = 1; t < 11; ++t) radius = amax_nan(radius, fabsf(c[t]));
  radius = __fadd_rn(1.f, radius);
  const float ang = __fmul_rn(
      __fmul_rn(__fadd_rn((float)k, 0.37f), 6.2831855f), 0.1f);
  const float r0 = __fmul_rn(radius, 0.7f);
  Cf z = {__fmul_rn(r0, cosf(ang)), __fmul_rn(r0, sinf(ang))};
  const float lim = __fmul_rn(0.5f, radius);
#pragma unroll 1
  for (int it = 0; it < FP_DK_ROUNDS; ++it) {
    Cf d[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const float zr = __shfl_sync(FP_FULL, z.r, base + j);
      const float zi = __shfl_sync(FP_FULL, z.i, base + j);
      d[j].r = __fadd_rn(__fsub_rn(z.r, zr), j == k ? 1.f : 0.f);
      d[j].i = __fadd_rn(__fsub_rn(z.i, zi), 0.f);
    }
    Cf den = prod10(d);
    if (cabs(den) < 1e-20f) den = {1e-20f, 0.f};
    Cf acc = {1.f, 0.f};
#pragma unroll
    for (int t = 1; t < 11; ++t) {
      acc = cmul(acc, z);
      acc.r = __fadd_rn(acc.r, c[t]);
      acc.i = __fadd_rn(acc.i, 0.f);
    }
    Cf step = cdiv(acc, den);
    const float smag = cabs(step);
    if (smag > lim) step = cmul(step, Cf{__fdiv_rn(lim, smag), 0.f});
    z.r = __fsub_rn(z.r, step.r);
    z.i = __fsub_rn(z.i, step.i);
  }
  if (h) {
    // 1 / zw_safe: torch.reciprocal's complex kernel, then * 1.0
    if (cabs(z) < 1e-20f) z = {1e-20f, 0.f};
    const bool nan = fp_isnan(z.r) || fp_isnan(z.i);
    const bool inf_r = isinf(z.r), inf_i = isinf(z.i);
    if (nan || (inf_r && inf_i))
      z = {__int_as_float(0x7fffffff), __int_as_float(0x7fffffff)};
    else if (inf_r || inf_i)
      z = {0.f, 0.f};
    else
      z = cdiv(Cf{1.f, 0.f}, z);
    z = cmul(z, Cf{1.f, 0.f});
  }
  *near_out = fabsf(z.i) < __fmul_rn(0.01f, __fadd_rn(1.f, fabsf(z.r)));
  float x = z.r;
#pragma unroll 1
  for (int it = 0; it < FP_NEWTON; ++it) {
    float p = cs[0], dp = 0.f;
#pragma unroll
    for (int t = 1; t < 11; ++t) {
      dp = __fadd_rn(__fmul_rn(dp, x), p);
      p = __fadd_rn(__fmul_rn(p, x), cs[t]);
    }
    if (fabsf(dp) < 1e-20f) dp = 1e-20f;
    x = __fsub_rn(x, __fdiv_rn(p, dp));
  }
  *x_out = x;
}

// (x, y) from B(z0)'s nullspace: the cross product of the pair of rows
// with the largest norm (first maximum; NaN wins, as torch.argmax)
__device__ void fp_xy(const FpShared& sm, float z, float* xy) {
  float rows[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* o = sm.abc[r];
    float a = o[0], b = o[4], c = o[8];
#pragma unroll
    for (int t = 1; t < 4; ++t) {
      a = __fadd_rn(__fmul_rn(a, z), o[t]);
      b = __fadd_rn(__fmul_rn(b, z), o[4 + t]);
    }
#pragma unroll
    for (int t = 1; t < 5; ++t) c = __fadd_rn(__fmul_rn(c, z), o[8 + t]);
    rows[r][0] = a;
    rows[r][1] = b;
    rows[r][2] = c;
  }
  float cand[3][3];
  cross3(rows[0], rows[1], cand[0]);
  cross3(rows[0], rows[2], cand[1]);
  cross3(rows[1], rows[2], cand[2]);
  int pick = 0;
  float best = 0.f;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float n2 = sum3(__fmul_rn(cand[p][0], cand[p][0]),
                          __fmul_rn(cand[p][1], cand[p][1]),
                          __fmul_rn(cand[p][2], cand[p][2]));
    if (p == 0 || (!fp_isnan(best) && (n2 > best || fp_isnan(n2)))) {
      best = n2;
      pick = p;
    }
  }
  const float* v = cand[pick];
  const float w = fabsf(v[2]) > 1e-12f ? v[2] : 1e-12f;
  xy[0] = __fdiv_rn(v[0], w);
  xy[1] = __fdiv_rn(v[1], w);
}

// sum_e a[e] b[e], one FMA a term in order (a float32 GEMM's inner loop)
template <int K>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < K; ++e) acc = __fmaf_rn(a[e], b[e], acc);
  return acc;
}

// sum_q a[q * stride] b[q] over 10 terms as cuBLAS's GEMV: the even and the
// odd terms in two FMA chains, then their sum
__device__ __forceinline__ float dot10_gemv(const float* a, int stride,
                                            const float* b) {
  float even = 0.f, odd = 0.f;
#pragma unroll
  for (int q = 0; q < 10; q += 2) {
    even = __fmaf_rn(a[q * stride], b[q], even);
    odd = __fmaf_rn(a[(q + 1) * stride], b[q + 1], odd);
  }
  return __fadd_rn(even, odd);
}

// sum_j a[j] b[j] over 3 terms as cuBLAS's GEMV: an FMA chain over the
// first two, then the third's product added
__device__ __forceinline__ float dot3_gemv(const float* a, const float* b) {
  return __fadd_rn(__fmaf_rn(a[1], b[1], __fmul_rn(a[0], b[0])),
                   __fmul_rn(a[2], b[2]));
}

// _gn_polish on one candidate (x, y, z), M = sm.m
__device__ void fp_gn_polish(const FpShared& sm, int iters, float* px,
                             float* py, float* pz) {
  float x = *px, y = *py, z = *pz;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const float x2 = __fmul_rn(x, x), y2 = __fmul_rn(y, y),
                z2 = __fmul_rn(z, z);
    float v[20], dx[20], dy[20], dz[20];
#pragma unroll
    for (int e = 0; e < 20; ++e) {
      float o[4];
      mono_grad(fp_mon20(e, 0), fp_mon20(e, 1), fp_mon20(e, 2), x, y, z, x2,
                y2, z2, o);
      v[e] = o[0];
      dx[e] = o[1];
      dy[e] = o[2];
      dz[e] = o[3];
    }
    float r[10], J[10][3];
#pragma unroll
    for (int q = 0; q < 10; ++q) {
      r[q] = dot<20>(sm.m[q], v);
      J[q][0] = dot<20>(sm.m[q], dx);
      J[q][1] = dot<20>(sm.m[q], dy);
      J[q][2] = dot<20>(sm.m[q], dz);
    }
    float A[3][3], b[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      b[i] = dot10_gemv(&J[0][i], 3, r);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < 10; ++q) acc = __fmaf_rn(J[q][i], J[q][j], acc);
        A[i][j] = __fadd_rn(acc, i == j ? 1e-10f : 0.f);
      }
    }
    // _inv3: cofactors over the determinant
    const float a = A[0][0], bb = A[0][1], c = A[0][2];
    const float d = A[1][0], e = A[1][1], f = A[1][2];
    const float g = A[2][0], hh = A[2][1], ii = A[2][2];
    const float ei_fh = __fsub_rn(__fmul_rn(e, ii), __fmul_rn(f, hh));
    const float di_fg = __fsub_rn(__fmul_rn(d, ii), __fmul_rn(f, g));
    const float dh_eg = __fsub_rn(__fmul_rn(d, hh), __fmul_rn(e, g));
    const float co[3][3] = {
        {ei_fh, __fsub_rn(__fmul_rn(c, hh), __fmul_rn(bb, ii)),
         __fsub_rn(__fmul_rn(bb, f), __fmul_rn(c, e))},
        {__fsub_rn(__fmul_rn(f, g), __fmul_rn(d, ii)),
         __fsub_rn(__fmul_rn(a, ii), __fmul_rn(c, g)),
         __fsub_rn(__fmul_rn(c, d), __fmul_rn(a, f))},
        {dh_eg, __fsub_rn(__fmul_rn(bb, g), __fmul_rn(a, hh)),
         __fsub_rn(__fmul_rn(a, e), __fmul_rn(bb, d))}};
    float det = __fadd_rn(
        __fsub_rn(__fmul_rn(a, ei_fh), __fmul_rn(bb, di_fg)),
        __fmul_rn(c, dh_eg));
    if (fabsf(det) < 1e-30f) det = 1e-30f;
    float step[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float inv[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) inv[j] = __fdiv_rn(co[i][j], det);
      step[i] = clamp_pm(dot3_gemv(inv, b), 1.f);
    }
    x = __fsub_rn(x, step[0]);
    y = __fsub_rn(y, step[1]);
    z = __fsub_rn(z, step[2]);
  }
  *px = x;
  *py = y;
  *pz = z;
}

// One hypothesis: x1, x2 its 5 x 2 correspondences; Es (20, 3, 3) and
// valid (20,) its candidates.  Called by every lane of the warp.
__device__ void fp_solve_one(const float* x1, const float* x2, int gn_iters,
                             float* Es, unsigned char* valid, FpShared& sm,
                             int lane) {
  if (lane == 0) fp_nullspace(x1, x2, sm);
  __syncwarp();
  if (lane < 9) fp_gram(sm, lane);
  __syncwarp();
  if (lane < 10) fp_constraint_row(sm, lane);
  __syncwarp();
  fp_solve(sm, lane);
  if (lane < 3) fp_bz_row(sm, lane);
  __syncwarp();
  float det[11];
  fp_det_bz(sm, det);
  // lanes 20..31 shadow slot 19 so that every lane takes the shuffles
  const int slot = lane < FP_SLOTS ? lane : FP_SLOTS - 1;
  float zr;
  bool near_real;
  fp_root(det, slot, &zr, &near_real);
  if (lane >= FP_SLOTS) return;
  float xy[2];
  fp_xy(sm, zr, xy);
  float px = clamp_pm(xy[0], 1e4f), py = clamp_pm(xy[1], 1e4f),
        pz = clamp_pm(zr, 1e4f);
  fp_gn_polish(sm, gn_iters, &px, &py, &pz);
  if (!(isfinite(px) && isfinite(py) && isfinite(pz))) {
    px = xy[0];
    py = xy[1];
    pz = zr;
  }
  float E[9], p[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    E[t] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(px, sm.basis[0][t]),
                            __fmul_rn(py, sm.basis[1][t])),
                  __fmul_rn(pz, sm.basis[2][t])),
        sm.basis[3][t]);
    p[t] = __fmul_rn(E[t], E[t]);
  }
  const float n = clamp_min(__fsqrt_rn(sum9(p)), 1e-12f);
  bool fin = true;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    E[t] = __fdiv_rn(E[t], n);
    fin = fin && isfinite(E[t]);
  }
  if (!fin) {
    // the unit-norm placeholder: eye(3) / sqrt(3) (a product with the
    // float32 reciprocal of sqrt(3), as torch divides by a Python number)
    const float d = __fdiv_rn(1.f, 1.7320508f);
#pragma unroll
    for (int t = 0; t < 9; ++t) E[t] = t % 4 == 0 ? d : 0.f;
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) Es[lane * 9 + t] = E[t];
  valid[lane] = (near_real && fin) ? 1 : 0;
}
