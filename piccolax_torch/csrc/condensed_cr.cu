// K3: condensed dual Schur complement of the per-knot KKT, factored and
// solved by block cyclic reduction.
//
// Replaces piccolax/solver/kkt.py: condensed_factor / condensed_solve over
// cr_factor / cr_solve. On the TPU each CR level is a batched matmul over
// all knots; here one thread block owns one problem and runs the whole
// level loop itself (log2(Np) levels, Np = N padded to a power of two), so
// a factor is one launch and a solve is one launch instead of dozens of
// small ones. The blocks are 12 x 12: the work is a few MFLOP per problem
// and the bound is the bytes of P, C and the factor, far below what the
// block-serial loop takes. Reduced blocks and right-hand sides live in a
// device-memory workspace private to the block (L1/L2 resident); the
// Cholesky-inverse of every reduced diagonal block is the warp routine of
// K1 (common.cuh).
//
// Factor layout cr [B, 3, Np, m, m]: level l (n = Np >> l rows, n/2 odd
// rows eliminated) stores Xi, Ul, Ur of its odd rows at slots
// off_l .. off_l + n/2 - 1, off_l = Np - (Np >> l); slot Np - 1 of the Xi
// plane holds the root factor.
#include "common.cuh"

namespace {

// Y_k = C_k Xi_k^T and Yn_k = Cnext_k Xi_{k+1}^T, then D (padded with
// identity blocks) and U (padded with zeros), then the CR levels.
template <typename T>
__global__ void cr_factor_kernel(const T* __restrict__ Xi_g, const T* __restrict__ C_g,
                                 const T* __restrict__ R_g, const T* __restrict__ Cn_g,
                                 T* __restrict__ cr_g, T* __restrict__ ws_g,
                                 int N, int Np, int m, int dz, long long ws_stride) {
  PX_SMEM(T);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const int mm = m * m, md = m * dz, dd = dz * dz;
  const T* Xi = Xi_g + (long long)b * N * dd;
  const T* C = C_g + (long long)b * N * md;
  const T* Rd = R_g + (long long)b * N * m;
  const T* Cn = Cn_g + (long long)b * (N - 1) * md;
  T* cr = cr_g + (long long)b * 3 * Np * mm;
  T* Xcr = cr;
  T* Lcr = cr + (long long)Np * mm;
  T* Rcr = cr + 2LL * Np * mm;
  T* ws = ws_g + (long long)b * ws_stride;
  T* Y = ws;                       // [N, m, dz]
  T* Yn = Y + N * md;              // [N, m, dz] (last unused)
  T* D0 = Yn + N * md;             // [Np, m, m]
  T* D1 = D0 + Np * mm;
  T* U0 = D1 + Np * mm;
  T* U1 = U0 + Np * mm;
  T* Gl = U1 + Np * mm;            // [Np/2, m, m]
  T* Gr = Gl + (Np / 2) * mm;
  T* S = smem + warp * px::chol_scratch_elems(m);

  for (int idx = tid; idx < N * md; idx += nt) {
    const int k = idx / md, a = (idx / dz) % m, c = idx % dz;
    T acc = 0;
    for (int e = 0; e < dz; ++e) acc += C[k * md + a * dz + e] * Xi[k * dd + c * dz + e];
    Y[idx] = acc;
    if (k < N - 1) {
      acc = 0;
      for (int e = 0; e < dz; ++e) acc += Cn[k * md + a * dz + e] * Xi[(k + 1) * dd + c * dz + e];
      Yn[idx] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < Np * mm; idx += nt) {
    const int k = idx / mm, a = (idx / m) % m, c = idx % m;
    T dv, uv = 0;
    if (k < N) {
      dv = 0;
      for (int e = 0; e < dz; ++e) dv += Y[k * md + a * dz + e] * Y[k * md + c * dz + e];
      if (k < N - 1) {
        T t2 = 0;
        for (int e = 0; e < dz; ++e) t2 += Yn[k * md + a * dz + e] * Yn[k * md + c * dz + e];
        dv += t2;
        for (int e = 0; e < dz; ++e) uv += Yn[k * md + a * dz + e] * Y[(k + 1) * md + c * dz + e];
      }
      if (a == c) dv += Rd[k * m + a];
    } else {
      dv = (a == c) ? T(1) : T(0);
    }
    D0[idx] = dv;
    U0[idx] = uv;
  }
  __syncthreads();

  T *Dc = D0, *Dn = D1, *Uc = U0, *Un = U1;
  int off = 0;
  for (int n = Np; n > 1; n /= 2) {
    const int half = n / 2;
    for (int j = warp; j < half; j += nw)
      px::chol_inv_warp<T>(Dc + (2 * j + 1) * mm, m, Xcr + (long long)(off + j) * mm, m, S, m, lane);
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
  if (warp == 0) px::chol_inv_warp<T>(Dc, m, Xcr + (long long)(Np - 1) * mm, m, S, m, lane);
  for (int idx = tid; idx < mm; idx += nt) {
    Lcr[(long long)(Np - 1) * mm + idx] = T(0);
    Rcr[(long long)(Np - 1) * mm + idx] = T(0);
  }
}

// out = K^{-1} rhs for the condensed KKT: dual rhs, CR reduce, root,
// back-substitution, primal recovery. rhs/out [N, dz + m, r].
template <typename T>
__global__ void condensed_solve_kernel(const T* __restrict__ Xi_g, const T* __restrict__ C_g,
                                       const T* __restrict__ Cn_g, const T* __restrict__ cr_g,
                                       const T* __restrict__ rhs_g, T* __restrict__ out_g,
                                       T* __restrict__ ws_g, int N, int Np, int m, int dz,
                                       int r, long long ws_stride) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int mm = m * m, md = m * dz, dd = dz * dz, mb = dz + m;
  const int mr = m * r, dr = dz * r;
  const T* Xi = Xi_g + (long long)b * N * dd;
  const T* C = C_g + (long long)b * N * md;
  const T* Cn = Cn_g + (long long)b * (N - 1) * md;
  const T* cr = cr_g + (long long)b * 3 * Np * mm;
  const T* Xcr = cr;
  const T* Lcr = cr + (long long)Np * mm;
  const T* Rcr = cr + 2LL * Np * mm;
  const T* rhs = rhs_g + (long long)b * N * mb * r;
  T* out = out_g + (long long)b * N * mb * r;
  T* ws = ws_g + (long long)b * ws_stride;
  T* q = ws;                       // [N, dz, r]
  T* t = q + N * dr;               // [N, dz, r]
  T* A0 = t + N * dr;              // [Np, m, r]
  T* A1 = A0 + Np * mr;
  T* rodd = A1 + Np * mr;          // [Np, m, r] packed like cr
  T* tl = rodd + Np * mr;          // [Np/2, m, r]
  T* q2 = tl + (Np / 2) * mr;      // [Np/2, m, r]

  // t = Pinv rz = Xi^T (Xi rz)
  for (int idx = tid; idx < N * dr; idx += nt) {
    const int k = idx / dr, a = (idx / r) % dz, s = idx % r;
    T acc = 0;
    for (int e = 0; e < dz; ++e) acc += Xi[k * dd + a * dz + e] * rhs[(k * mb + e) * r + s];
    q[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < N * dr; idx += nt) {
    const int k = idx / dr, a = (idx / r) % dz, s = idx % r;
    T acc = 0;
    for (int e = 0; e < dz; ++e) acc += Xi[k * dd + e * dz + a] * q[(k * dz + e) * r + s];
    t[idx] = acc;
  }
  __syncthreads();
  // dual rhs b_k = C_k t_k - rc_k + Cnext_k t_{k+1}, zero-padded to Np
  for (int idx = tid; idx < Np * mr; idx += nt) {
    const int k = idx / mr, a = (idx / r) % m, s = idx % r;
    T v = 0;
    if (k < N) {
      T acc = 0;
      for (int e = 0; e < dz; ++e) acc += C[k * md + a * dz + e] * t[(k * dz + e) * r + s];
      v = acc - rhs[(k * mb + dz + a) * r + s];
      if (k < N - 1) {
        T a2 = 0;
        for (int e = 0; e < dz; ++e) a2 += Cn[k * md + a * dz + e] * t[((k + 1) * dz + e) * r + s];
        v += a2;
      }
    }
    A0[idx] = v;
  }
  __syncthreads();

  // reduce
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
  // back-substitute, finest level last
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
  // primal recovery: w_k = rz_k - C_k^T lam_k - Cnext_{k-1}^T lam_{k-1}
  for (int idx = tid; idx < N * dr; idx += nt) {
    const int k = idx / dr, a = (idx / r) % dz, s = idx % r;
    T a1 = 0;
    for (int e = 0; e < m; ++e) a1 += C[k * md + e * dz + a] * x[(k * m + e) * r + s];
    T w = rhs[(k * mb + a) * r + s] - a1;
    if (k > 0) {
      T a2 = 0;
      for (int e = 0; e < m; ++e) a2 += Cn[(k - 1) * md + e * dz + a] * x[((k - 1) * m + e) * r + s];
      w -= a2;
    }
    t[idx] = w;
  }
  __syncthreads();
  for (int idx = tid; idx < N * dr; idx += nt) {
    const int k = idx / dr, a = (idx / r) % dz, s = idx % r;
    T acc = 0;
    for (int e = 0; e < dz; ++e) acc += Xi[k * dd + a * dz + e] * t[(k * dz + e) * r + s];
    q[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < N * mb * r; idx += nt) {
    const int k = idx / (mb * r), row = (idx / r) % mb, s = idx % r;
    T v;
    if (row < dz) {
      T acc = 0;
      for (int e = 0; e < dz; ++e) acc += Xi[k * dd + e * dz + row] * q[(k * dz + e) * r + s];
      v = acc;
    } else {
      v = x[(k * m + row - dz) * r + s];
    }
    out[idx] = v;
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" long long px_cr_factor_ws(int N, int Np, int m, int dz) {
  return 2LL * N * m * dz + 4LL * Np * m * m + 2LL * (Np / 2) * m * m;
}

extern "C" long long px_condensed_solve_ws(int N, int Np, int m, int dz, int r) {
  return 2LL * N * dz * r + 3LL * Np * m * r + 2LL * (Np / 2) * m * r;
}

extern "C" int px_cr_factor(int is_f64, const void* Xi, const void* C,
                            const void* Rdiag, const void* Cnext, void* cr,
                            void* ws, int B, int N, int Np, int m, int dz,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long wss = px_cr_factor_ws(N, Np, m, dz);
  const int warps = kThreads / 32;
  if (B > 0) {
    if (is_f64) {
      const size_t smem = sizeof(double) * warps * px::chol_scratch_elems(m);
      cudaFuncSetAttribute(cr_factor_kernel<double>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      cr_factor_kernel<double><<<B, kThreads, smem, st>>>(
          (const double*)Xi, (const double*)C, (const double*)Rdiag,
          (const double*)Cnext, (double*)cr, (double*)ws, N, Np, m, dz, wss);
    } else {
      const size_t smem = sizeof(float) * warps * px::chol_scratch_elems(m);
      cudaFuncSetAttribute(cr_factor_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      cr_factor_kernel<float><<<B, kThreads, smem, st>>>(
          (const float*)Xi, (const float*)C, (const float*)Rdiag,
          (const float*)Cnext, (float*)cr, (float*)ws, N, Np, m, dz, wss);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int px_condensed_solve(int is_f64, const void* Xi, const void* C,
                                  const void* Cnext, const void* cr,
                                  const void* rhs, void* out, void* ws, int B,
                                  int N, int Np, int m, int dz, int r,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long wss = px_condensed_solve_ws(N, Np, m, dz, r);
  if (B > 0) {
    if (is_f64)
      condensed_solve_kernel<double><<<B, kThreads, 0, st>>>(
          (const double*)Xi, (const double*)C, (const double*)Cnext,
          (const double*)cr, (const double*)rhs, (double*)out, (double*)ws,
          N, Np, m, dz, r, wss);
    else
      condensed_solve_kernel<float><<<B, kThreads, 0, st>>>(
          (const float*)Xi, (const float*)C, (const float*)Cnext,
          (const float*)cr, (const float*)rhs, (float*)out, (float*)ws,
          N, Np, m, dz, r, wss);
  }
  return (int)cudaGetLastError();
}
