// Shared device routines of the port's kernels (built for sm_90a).
//
// chol_inv_warp is the device form of piccolax.solver.kkt.chol_inv_factor:
// one warp turns one SPD m x m block (m <= 64) into the lower-triangular Xi
// with A^{-1} = Xi^T Xi. The K1 kernel (chol_inv.cu) runs it on the knot
// blocks; the cyclic-reduction routines below run it on every reduced
// diagonal block.
//
// cr_factor_block / cr_solve_block are the device form of
// piccolax.solver.kkt.cr_factor / cr_solve: block cyclic reduction of one
// SPD block-tridiagonal system by one thread block, the whole level loop
// inside it. K3 (condensed_cr.cu) runs them on the condensed dual system of
// a problem, K9 (knot.cu) on the interior of each knot partition and on the
// interface system.
//
// condense_knots / dual_rhs_knots / primal_knots are the condensed KKT's
// per-knot arithmetic over a range of knots: K3 runs them over all N knots
// of a problem, K9 over each partition's L knots.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace px {

// The largest block chol_inv_warp takes: each lane owns two rows.
constexpr int kMaxCholM = 64;

// Shared memory one thread block may use on the H100 (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

// The most warps, up to max_warps, whose per-warp shared memory fits in
// one block (at least 1; a block that still does not fit is refused at
// launch and the wrapper raises).
inline int warps_that_fit(size_t per_warp_bytes, int max_warps) {
  int w = per_warp_bytes ? (int)(kMaxSmemBytes / per_warp_bytes) : max_warps;
  return w < 1 ? 1 : (w > max_warps ? max_warps : w);
}

// sqrt(max(diag, tiny)) of the Jacobi equilibration: JAX writes 1e-300,
// which is 0 once rounded to float32.
template <typename T> __device__ __forceinline__ T diag_tiny();
template <> __device__ __forceinline__ float diag_tiny<float>() { return 0.0f; }
template <> __device__ __forceinline__ double diag_tiny<double>() { return 1e-300; }

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000ULL);
}

// max that propagates NaN, as jnp.maximum does (fmax drops it)
template <typename T> __device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// Shared scratch chol_inv_warp needs, in elements of T.
__host__ __device__ inline int chol_scratch_elems(int m) { return 2 * m * m + m; }

// Xi (row-major, leading dimension ldx) of the SPD block A (leading
// dimension lda), m <= 64. A and Xi may live in global or shared memory; S
// holds chol_scratch_elems(m) elements of shared memory private to this
// warp. Must be called by all 32 lanes of the warp. Lane l owns rows l and
// l + 32 of the Cholesky factor and columns l and l + 32 of its inverse. A
// block with a non-positive (or NaN) pivot gives an all-NaN Xi: the
// caller's PD test.
template <typename T>
__device__ void chol_inv_warp(const T* A, int lda, T* Xi, int ldx, T* S,
                              int m, int lane) {
  T* L = S;              // equilibrated matrix, then its Cholesky factor
  T* W = S + m * m;      // L^{-1}
  T* d = S + 2 * m * m;  // equilibration scales
  for (int i = lane; i < m; i += 32) d[i] = sqrt(nan_max(A[i * lda + i], diag_tiny<T>()));
  __syncwarp();
  for (int idx = lane; idx < m * m; idx += 32) {
    int i = idx / m, j = idx % m;
    L[idx] = A[i * lda + j] / d[i] / d[j];
  }
  __syncwarp();
  // left-looking Cholesky
  bool ok = true;
  for (int j = 0; j < m; ++j) {
    T v[2] = {T(0), T(0)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      if (i >= j && i < m) {
        T s = L[i * m + j];
        for (int k = 0; k < j; ++k) s -= L[i * m + k] * L[j * m + k];
        v[h] = s;
      }
    }
    // row j lives in lane j % 32, slot j / 32 (uniform across the warp)
    T piv = __shfl_sync(0xffffffffu, j < 32 ? v[0] : v[1], j & 31);
    ok = ok && (piv > T(0));
    T ljj = sqrt(piv);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      if (i == j) L[j * m + j] = ljj;
      else if (i > j && i < m) L[i * m + j] = v[h] / ljj;
    }
    __syncwarp();
  }
  // column j of L^{-1} by forward substitution, j = lane, lane + 32
  for (int j = lane; j < m; j += 32) {
    for (int i = 0; i < m; ++i) {
      T x = 0;
      if (i >= j) {
        T s = (i == j) ? T(1) : T(0);
        for (int k = j; k < i; ++k) s -= L[i * m + k] * W[k * m + j];
        x = s / L[i * m + i];
      }
      W[i * m + j] = x;
    }
  }
  __syncwarp();
  for (int idx = lane; idx < m * m; idx += 32) {
    int i = idx / m, j = idx % m;
    Xi[i * ldx + j] = ok ? W[idx] / d[j] : quiet_nan<T>();
  }
  __syncwarp();
}

// Cyclic-reduction factor of one SPD block-tridiagonal matrix of Np
// (a power of two) block rows: diagonal Dc [Np, m, m] (padded with
// identity blocks) and upper couplings Uc [Np, m, m] (zero-padded), both
// overwritten. Dn, Un [Np, m, m] and Gl, Gr [Np/2, m, m] are workspace; S is
// the calling warp's chol_inv_warp scratch. Writes the packed factor
// cr [3, Np, m, m]: level l (n = Np >> l rows, n/2 odd rows eliminated)
// stores Xi, Ul, Ur of its odd rows at slots off_l .. off_l + n/2 - 1,
// off_l = Np - (Np >> l); slot Np - 1 of the Xi plane holds the root
// factor. Called by every thread of the block after Dc and Uc are written
// and visible (__syncthreads); returns with cr written by this block.
template <typename T>
__device__ void cr_factor_block(T* Dc, T* Dn, T* Uc, T* Un, T* Gl, T* Gr,
                                T* cr, int Np, int m, T* S) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const int mm = m * m;
  T* Xcr = cr;
  T* Lcr = cr + (long long)Np * mm;
  T* Rcr = cr + 2LL * Np * mm;
  int off = 0;
  for (int n = Np; n > 1; n /= 2) {
    const int half = n / 2;
    for (int j = warp; j < half; j += nw)
      chol_inv_warp<T>(Dc + (2 * j + 1) * mm, m, Xcr + (long long)(off + j) * mm, m, S, m, lane);
    for (int idx = tid; idx < half * mm; idx += nt) {
      const int j = idx / mm, e = idx % mm;
      Lcr[(long long)(off + j) * mm + e] = Uc[(2 * j) * mm + e];
      Rcr[(long long)(off + j) * mm + e] = Uc[(2 * j + 1) * mm + e];
    }
    __syncthreads();
    const T* Xl = Xcr + (long long)off * mm;
    const T* Ul = Lcr + (long long)off * mm;
    const T* Ur = Rcr + (long long)off * mm;
    for (int idx = tid; idx < half * mm; idx += nt) {
      const int j = idx / mm, a = (idx / m) % m, c = idx % m;
      T gl = 0, gr = 0;
      for (int e = 0; e < m; ++e) {
        gl += Xl[j * mm + a * m + e] * Ul[j * mm + c * m + e];   // Xi Ul^T
        gr += Xl[j * mm + a * m + e] * Ur[j * mm + e * m + c];   // Xi Ur
      }
      Gl[idx] = gl;
      Gr[idx] = gr;
    }
    __syncthreads();
    for (int idx = tid; idx < half * mm; idx += nt) {
      const int j = idx / mm, a = (idx / m) % m, c = idx % m;
      T dv = Dc[(2 * j) * mm + a * m + c];
      if (j > 0) {
        T s1 = 0;
        for (int e = 0; e < m; ++e) s1 += Gr[(j - 1) * mm + e * m + a] * Gr[(j - 1) * mm + e * m + c];
        dv -= s1;
      }
      T s2 = 0, uv = 0;
      for (int e = 0; e < m; ++e) {
        s2 += Gl[j * mm + e * m + a] * Gl[j * mm + e * m + c];
        uv += Gl[j * mm + e * m + a] * Gr[j * mm + e * m + c];
      }
      Dn[idx] = dv - s2;
      Un[idx] = -uv;
    }
    __syncthreads();
    T* tmp = Dc; Dc = Dn; Dn = tmp;
    tmp = Uc; Uc = Un; Un = tmp;
    off += half;
  }
  if (warp == 0) chol_inv_warp<T>(Dc, m, Xcr + (long long)(Np - 1) * mm, m, S, m, lane);
  for (int idx = tid; idx < mm; idx += nt) {
    Lcr[(long long)(Np - 1) * mm + idx] = T(0);
    Rcr[(long long)(Np - 1) * mm + idx] = T(0);
  }
  __syncthreads();
}

// x = S^{-1} b with the packed factor cr [3, Np, m, m] of cr_factor_block:
// b [Np, m, r] in A0 (zero-padded past the system's rows), A1 and
// rodd [Np, m, r], tl and q2 [Np/2, m, r] workspace. Reduce, root,
// back-substitute (finest level last). Called by every thread of the block
// after A0 is written and visible; returns the buffer (A0 or A1) holding x.
template <typename T>
__device__ T* cr_solve_block(const T* cr, T* A0, T* A1, T* rodd, T* tl, T* q2,
                             int Np, int m, int r) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int mm = m * m, mr = m * r;
  const T* Xcr = cr;
  const T* Lcr = cr + (long long)Np * mm;
  const T* Rcr = cr + 2LL * Np * mm;
  T *cur = A0, *nxt = A1;
  int off = 0;
  for (int n = Np; n > 1; n /= 2) {
    const int half = n / 2;
    const T* Xl = Xcr + (long long)off * mm;
    const T* Ul = Lcr + (long long)off * mm;
    const T* Ur = Rcr + (long long)off * mm;
    for (int idx = tid; idx < half * mr; idx += nt) {
      const int j = idx / mr, a = (idx / r) % m, s = idx % r;
      rodd[off * mr + idx] = cur[(2 * j + 1) * mr + a * r + s];
      T acc = 0;
      for (int e = 0; e < m; ++e) acc += Xl[j * mm + a * m + e] * cur[(2 * j + 1) * mr + e * r + s];
      q2[idx] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < half * mr; idx += nt) {
      const int j = idx / mr, a = (idx / r) % m, s = idx % r;
      T acc = 0;
      for (int e = 0; e < m; ++e) acc += Xl[j * mm + e * m + a] * q2[j * mr + e * r + s];
      tl[idx] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < half * mr; idx += nt) {
      const int j = idx / mr, a = (idx / r) % m, s = idx % r;
      T v = cur[(2 * j) * mr + a * r + s];
      if (j > 0) {
        T a1 = 0;
        for (int e = 0; e < m; ++e) a1 += Ur[(j - 1) * mm + e * m + a] * tl[(j - 1) * mr + e * r + s];
        v -= a1;
      }
      T a2 = 0;
      for (int e = 0; e < m; ++e) a2 += Ul[j * mm + a * m + e] * tl[j * mr + e * r + s];
      nxt[idx] = v - a2;
    }
    __syncthreads();
    T* tmp = cur; cur = nxt; nxt = tmp;
    off += half;
  }
  // root
  const T* XR = Xcr + (long long)(Np - 1) * mm;
  for (int idx = tid; idx < mr; idx += nt) {
    const int a = idx / r, s = idx % r;
    T acc = 0;
    for (int e = 0; e < m; ++e) acc += XR[a * m + e] * cur[e * r + s];
    q2[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < mr; idx += nt) {
    const int a = idx / r, s = idx % r;
    T acc = 0;
    for (int e = 0; e < m; ++e) acc += XR[e * m + a] * q2[e * r + s];
    nxt[idx] = acc;
  }
  __syncthreads();
  T* x = nxt;
  T* y = cur;
  for (int half = 1; half < Np; half *= 2) {
    const int lo = Np - 2 * half;  // off of the level with `half` odd rows
    const T* Xl = Xcr + (long long)lo * mm;
    const T* Ul = Lcr + (long long)lo * mm;
    const T* Ur = Rcr + (long long)lo * mm;
    for (int idx = tid; idx < half * mr; idx += nt) {
      const int j = idx / mr, a = (idx / r) % m, s = idx % r;
      T a1 = 0, a2 = 0;
      for (int e = 0; e < m; ++e) {
        a1 += Ul[j * mm + e * m + a] * x[j * mr + e * r + s];
        if (j + 1 < half) a2 += Ur[j * mm + a * m + e] * x[(j + 1) * mr + e * r + s];
      }
      tl[idx] = (rodd[lo * mr + idx] - a1) - a2;
    }
    __syncthreads();
    for (int idx = tid; idx < half * mr; idx += nt) {
      const int j = idx / mr, a = (idx / r) % m, s = idx % r;
      T acc = 0;
      for (int e = 0; e < m; ++e) acc += Xl[j * mm + a * m + e] * tl[j * mr + e * r + s];
      q2[idx] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < half * mr; idx += nt) {
      const int j = idx / mr, a = (idx / r) % m, s = idx % r;
      T acc = 0;
      for (int e = 0; e < m; ++e) acc += Xl[j * mm + e * m + a] * q2[j * mr + e * r + s];
      y[(2 * j) * mr + a * r + s] = x[idx];
      y[(2 * j + 1) * mr + a * r + s] = acc;
    }
    __syncthreads();
    T* tmp = x; x = y; y = tmp;
  }
  return x;
}

// The condensed KKT of knots [j0, j0 + L) of one problem, the device form
// of piccolax.solver.kkt.condensed_factor's blocks. Xi [N, dz, dz] (K1's
// knot factors, Pinv = Xi^T Xi), C [N, m, dz], Rd [N, m] and Cn [N-1, m, dz]
// point at the problem's knot 0. Writes, with k local to the range,
// Y_k = C_k Xi_k^T [L+1, m, dz] (the last row the halo knot j0 + L, where
// it exists), Yn_k = Cn_k Xi_{k+1}^T [L, m, dz], D_k = Y_k Y_k^T +
// Yn_k Yn_k^T + diag(Rd_k) and U_k = Yn_k Y_{k+1}^T [L, m, m] (U_k zero
// at knot N - 1). Called by every thread of the block; returns with D and
// U written and visible.
template <typename T>
__device__ void condense_knots(const T* Xi, const T* C, const T* Rd, const T* Cn,
                               int N, int j0, int L, int m, int dz,
                               T* Y, T* Yn, T* D, T* U) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int mm = m * m, md = m * dz, dd = dz * dz;
  const int nY = (j0 + L < N) ? L + 1 : L;
  for (int idx = tid; idx < nY * md; idx += nt) {
    const int kk = idx / md, a = (idx / dz) % m, c = idx % dz;
    const long long j = j0 + kk;
    T acc = 0;
    for (int e = 0; e < dz; ++e) acc += C[j * md + a * dz + e] * Xi[j * dd + c * dz + e];
    Y[idx] = acc;
    if (kk < L && j < N - 1) {
      acc = 0;
      for (int e = 0; e < dz; ++e) acc += Cn[j * md + a * dz + e] * Xi[(j + 1) * dd + c * dz + e];
      Yn[idx] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < L * mm; idx += nt) {
    const int kk = idx / mm, a = (idx / m) % m, c = idx % m, j = j0 + kk;
    T dv = 0, uv = 0;
    for (int e = 0; e < dz; ++e) dv += Y[kk * md + a * dz + e] * Y[kk * md + c * dz + e];
    if (j < N - 1) {
      T t2 = 0;
      for (int e = 0; e < dz; ++e) t2 += Yn[kk * md + a * dz + e] * Yn[kk * md + c * dz + e];
      dv += t2;
      for (int e = 0; e < dz; ++e) uv += Yn[kk * md + a * dz + e] * Y[(kk + 1) * md + c * dz + e];
    }
    if (a == c) dv += Rd[(long long)j * m + a];
    D[idx] = dv;
    U[idx] = uv;
  }
  __syncthreads();
}

// The dual right-hand side of knots [j0, j0 + L): t = Pinv r_z =
// Xi^T (Xi r_z) over the range and its halo knot, then
// b_k = C_k t_k - rc_k + Cn_k t_{k+1}. rhs [N, dz + m, r] (r_z over rc)
// and the knot factors point at the problem's knot 0; q, t [L+1, dz, r]
// and b [L, m, r] are local to the range. Called by every thread of the
// block; returns with b written and visible.
template <typename T>
__device__ void dual_rhs_knots(const T* Xi, const T* C, const T* Cn, const T* rhs,
                               int N, int j0, int L, int m, int dz, int r,
                               T* q, T* t, T* b) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int md = m * dz, dd = dz * dz, mr = m * r, dr = dz * r, mb = dz + m;
  const int nT = (j0 + L < N) ? L + 1 : L;
  for (int idx = tid; idx < nT * dr; idx += nt) {
    const int kk = idx / dr, a = (idx / r) % dz, s = idx % r;
    const long long j = j0 + kk;
    T acc = 0;
    for (int e = 0; e < dz; ++e) acc += Xi[j * dd + a * dz + e] * rhs[(j * mb + e) * r + s];
    q[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < nT * dr; idx += nt) {
    const int kk = idx / dr, a = (idx / r) % dz, s = idx % r;
    const long long j = j0 + kk;
    T acc = 0;
    for (int e = 0; e < dz; ++e) acc += Xi[j * dd + e * dz + a] * q[(kk * dz + e) * r + s];
    t[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < L * mr; idx += nt) {
    const int kk = idx / mr, a = (idx / r) % m, s = idx % r;
    const long long j = j0 + kk;
    T acc = 0;
    for (int e = 0; e < dz; ++e) acc += C[j * md + a * dz + e] * t[(kk * dz + e) * r + s];
    T v = acc - rhs[(j * mb + dz + a) * r + s];
    if (j < N - 1) {
      T a2 = 0;
      for (int e = 0; e < dz; ++e) a2 += Cn[j * md + a * dz + e] * t[((kk + 1) * dz + e) * r + s];
      v += a2;
    }
    b[idx] = v;
  }
  __syncthreads();
}

// The primal recovery of knots [j0, j0 + L) from their multipliers
// lam [L, m, r]: w_k = r_z,k - C_k^T lam_k - Cn_{k-1}^T lam_{k-1} (lam_prev
// [m, r] is knot j0 - 1's, unused at j0 = 0), z_k = Xi_k^T Xi_k w_k; out
// [L, dz + m, r] (at knot j0) gets z over lam. The knot factors and rhs
// point at the problem's knot 0; w, q [L, dz, r] are workspace. Called by
// every thread of the block.
template <typename T>
__device__ void primal_knots(const T* Xi, const T* C, const T* Cn, const T* rhs,
                             const T* lam, const T* lam_prev, int j0, int L, int m,
                             int dz, int r, T* w, T* q, T* out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int md = m * dz, dd = dz * dz, mr = m * r, dr = dz * r, mb = dz + m;
  for (int idx = tid; idx < L * dr; idx += nt) {
    const int kk = idx / dr, a = (idx / r) % dz, s = idx % r;
    const long long j = j0 + kk;
    T a1 = 0;
    for (int e = 0; e < m; ++e) a1 += C[j * md + e * dz + a] * lam[(kk * m + e) * r + s];
    T v = rhs[(j * mb + a) * r + s] - a1;
    if (j > 0) {
      const T* lp = kk > 0 ? lam + (kk - 1) * mr : lam_prev;
      T a2 = 0;
      for (int e = 0; e < m; ++e) a2 += Cn[(j - 1) * md + e * dz + a] * lp[e * r + s];
      v -= a2;
    }
    w[idx] = v;
  }
  __syncthreads();
  for (int idx = tid; idx < L * dr; idx += nt) {
    const int kk = idx / dr, a = (idx / r) % dz, s = idx % r;
    const long long j = j0 + kk;
    T acc = 0;
    for (int e = 0; e < dz; ++e) acc += Xi[j * dd + a * dz + e] * w[(kk * dz + e) * r + s];
    q[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < L * mb * r; idx += nt) {
    const int kk = idx / (mb * r), row = (idx / r) % mb, s = idx % r;
    const long long j = j0 + kk;
    T v;
    if (row < dz) {
      T acc = 0;
      for (int e = 0; e < dz; ++e) acc += Xi[j * dd + e * dz + row] * q[(kk * dz + e) * r + s];
      v = acc;
    } else {
      v = lam[(kk * m + row - dz) * r + s];
    }
    out[idx] = v;
  }
}

// Workspace of the two routines above, in elements of T.
__host__ __device__ inline long long cr_factor_ws_elems(int Np, int m) {
  return 4LL * Np * m * m + 2LL * (Np / 2) * m * m;
}
__host__ __device__ inline long long cr_solve_ws_elems(int Np, int m, int r) {
  return 3LL * Np * m * r + 2LL * (Np / 2) * m * r;
}

}  // namespace px

#define PX_SMEM(T) \
  extern __shared__ __align__(16) unsigned char px_smem_raw[]; \
  T* smem = reinterpret_cast<T*>(px_smem_raw)
