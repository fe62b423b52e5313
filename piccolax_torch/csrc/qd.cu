// K7: the quasidefinite block-tridiagonal KKT by the sequential recursion
// along the knots (kkt_backend "qd").
//
// Replaces piccolax/solver/kkt.py: qd_factor, qd_solve and _qd_block_apply.
// On the TPU the recursion is a lax.scan over the knots, each step a few
// batched matmuls over the problems of a vmap. Here the knot axis is a
// loop inside the kernel (a TPU's sequential grid becomes a loop within a
// block) and a factor or a solve is one launch. The depth, N knots, is the
// algorithm's and no batch hides it: at B = 1 a launch is latency, a chain
// of N small dependent steps; at B = 256 the bound of both is the bytes
// they move (the factor's ~6 block products a knot take less time at the
// card's float64 peak; the solve reads the factors twice).
//
// Factor: one thread block (four warps) per problem. For each knot, its
// inputs are staged in shared memory by all threads at once (one memory
// latency per knot, not one per multiply-add), then
// P_eff = P_k + W^T W with W = Zi_{k-1} Cn_{k-1}; Xi from K1's warp routine
// (Jacobi-equilibrated, NaN when not PD); Pinv = Xi^T Xi; Y = C_k Xi^T;
// S = Y Y^T + diag(R_k), symmetrised; Zi from the warp routine;
// Sinv = Zi^T Zi. The Schur complements stay Gram products, as piccolax
// forms them, so S and P_eff stay PSD in rounding when P is
// ill-conditioned. Zi stays in shared memory for the next knot; a NaN
// carries from its knot on, inside its own problem's block only.
//
// Solve: one warp per problem and right-hand-side column, lane i owning
// row i and reading its rows of each knot's Pinv, Sinv, C and Cn straight
// from device memory; only the vectors live in shared memory. The forward
// sweep y_k = r_k - U_{k-1}^T Dt_{k-1}^{-1} y_{k-1} stores y in the output; the backward sweep x_k = Dt_k^{-1} (y_k -
// U_k x_{k+1}) overwrites it. Dt^{-1} (a, b): t = Pinv a,
// y = Sinv (C t - b), x = t - Pinv C^T y.
#include "common.cuh"

namespace {

constexpr int kFactorThreads = 128;
constexpr int kSolveWarps = 2;

__host__ __device__ inline int factor_smem_elems(int m, int dz) {
  const int mx = m > dz ? m : dz;
  return 2 * dz * dz + 4 * m * dz + 3 * m * m + m + px::chol_scratch_elems(mx);
}

// Per-warp shared elements of the solve: seven vectors of 32.
constexpr int kSolveSmemElems = 7 * 32;

// Copy n elements from device memory into shared memory with the threads
// [t0, t0 + nt) side by side: every load of a knot is in flight at once.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int n,
                                      int t0, int nt) {
  for (int i = t0; i < n; i += nt) dst[i] = src[i];
}

template <typename T>
__global__ void qd_factor_kernel(const T* __restrict__ P_g, const T* __restrict__ C_g,
                                 const T* __restrict__ R_g, const T* __restrict__ Cn_g,
                                 T* __restrict__ Pinv_g, T* __restrict__ Sinv_g,
                                 int N, int m, int dz) {
  PX_SMEM(T);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int dd = dz * dz, md = m * dz, mm = m * m;
  const T* P = P_g + (long long)b * N * dd;
  const T* C = C_g + (long long)b * N * md;
  const T* Rd = R_g + (long long)b * N * m;
  const T* Cn = Cn_g + (long long)b * (N - 1) * md;
  T* Pinv = Pinv_g + (long long)b * N * dd;
  T* Sinv = Sinv_g + (long long)b * N * mm;
  T* Pe = smem;            // [dz, dz] P_k, then P_eff
  T* Xi = Pe + dd;         // [dz, dz]
  T* Y = Xi + dd;          // [m, dz]
  T* W = Y + md;           // [m, dz]
  T* Ck = W + md;          // [m, dz] C_k
  T* Cp = Ck + md;         // [m, dz] Cn_{k-1}
  T* S = Cp + md;          // [m, m] Y Y^T + diag(R)
  T* Ss = S + mm;          // [m, m] symmetrised
  T* Zi = Ss + mm;         // [m, m] carried to the next knot
  T* Rk = Zi + mm;         // [m]
  T* scratch = Rk + m;

  for (int k = 0; k < N; ++k) {
    stage(Pe, P + (long long)k * dd, dd, tid, nt);
    stage(Ck, C + (long long)k * md, md, tid, nt);
    stage(Rk, Rd + (long long)k * m, m, tid, nt);
    if (k > 0) stage(Cp, Cn + (long long)(k - 1) * md, md, tid, nt);
    __syncthreads();
    if (k > 0) {
      for (int idx = tid; idx < md; idx += nt) {
        const int a = idx / dz, c = idx % dz;
        T acc = 0;
        for (int e = 0; e < m; ++e) acc += Zi[a * m + e] * Cp[e * dz + c];
        W[idx] = acc;
      }
      __syncthreads();
      for (int idx = tid; idx < dd; idx += nt) {
        const int i = idx / dz, j = idx % dz;
        T acc = 0;
        for (int a = 0; a < m; ++a) acc += W[a * dz + i] * W[a * dz + j];
        Pe[idx] = Pe[idx] + acc;
      }
      __syncthreads();
    }
    if (warp == 0) px::chol_inv_warp<T>(Pe, dz, Xi, dz, scratch, dz, lane);
    __syncthreads();
    for (int idx = tid; idx < dd; idx += nt) {
      const int i = idx / dz, j = idx % dz;
      T acc = 0;
      for (int r = 0; r < dz; ++r) acc += Xi[r * dz + i] * Xi[r * dz + j];
      Pinv[(long long)k * dd + idx] = acc;
    }
    for (int idx = tid; idx < md; idx += nt) {
      const int a = idx / dz, c = idx % dz;
      T acc = 0;
      for (int e = 0; e < dz; ++e) acc += Ck[a * dz + e] * Xi[c * dz + e];
      Y[idx] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < mm; idx += nt) {
      const int a = idx / m, c = idx % m;
      T acc = 0;
      for (int e = 0; e < dz; ++e) acc += Y[a * dz + e] * Y[c * dz + e];
      S[idx] = (a == c) ? acc + Rk[a] : acc;
    }
    __syncthreads();
    for (int idx = tid; idx < mm; idx += nt) {
      const int a = idx / m, c = idx % m;
      Ss[idx] = T(0.5) * (S[idx] + S[c * m + a]);
    }
    __syncthreads();
    if (warp == 0) px::chol_inv_warp<T>(Ss, m, Zi, m, scratch, m, lane);
    __syncthreads();
    for (int idx = tid; idx < mm; idx += nt) {
      const int a = idx / m, c = idx % m;
      T acc = 0;
      for (int r = 0; r < m; ++r) acc += Zi[r * m + a] * Zi[r * m + c];
      Sinv[(long long)k * mm + idx] = acc;
    }
    // the next knot stages into Pe, Ck, Cp and Rk, which no thread reads
    // past the last barrier, and reads Zi
  }
}

// One knot's Dt^{-1} on the warp's vectors: t = Pinv a, w = Sinv (C t - b)
// and, with want_x, x = t - Pinv C^T w. a, t, x hold dz entries; b, u, w m.
template <typename T>
__device__ void block_apply(const T* Pinv, const T* Sinv, const T* C,
                            const T* a, const T* b, T* t, T* u, T* w, T* v, T* x,
                            int m, int dz, int lane, bool want_x) {
  if (lane < dz) {
    T acc = 0;
    for (int j = 0; j < dz; ++j) acc += Pinv[lane * dz + j] * a[j];
    t[lane] = acc;
  }
  __syncwarp();
  if (lane < m) {
    T acc = 0;
    for (int e = 0; e < dz; ++e) acc += C[lane * dz + e] * t[e];
    u[lane] = acc - b[lane];
  }
  __syncwarp();
  if (lane < m) {
    T acc = 0;
    for (int c = 0; c < m; ++c) acc += Sinv[lane * m + c] * u[c];
    w[lane] = acc;
  }
  __syncwarp();
  if (!want_x) return;
  if (lane < dz) {
    T acc = 0;
    for (int a2 = 0; a2 < m; ++a2) acc += C[a2 * dz + lane] * w[a2];
    v[lane] = acc;
  }
  __syncwarp();
  if (lane < dz) {
    T acc = 0;
    for (int j = 0; j < dz; ++j) acc += Pinv[lane * dz + j] * v[j];
    x[lane] = t[lane] - acc;
  }
  __syncwarp();
}

template <typename T>
__global__ void qd_solve_kernel(const T* __restrict__ Pinv_g, const T* __restrict__ Sinv_g,
                                const T* __restrict__ C_g, const T* __restrict__ Cn_g,
                                const T* __restrict__ rhs_g, T* __restrict__ out_g,
                                int B, int N, int m, int dz, int r) {
  PX_SMEM(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long g = (long long)blockIdx.x * kSolveWarps + warp;
  if (g >= (long long)B * r) return;       // uniform per warp
  const int b = (int)(g / r), col = (int)(g % r);
  const int dd = dz * dz, md = m * dz, mm = m * m, mb = dz + m;
  const T* Pinv = Pinv_g + (long long)b * N * dd;
  const T* Sinv = Sinv_g + (long long)b * N * mm;
  const T* C = C_g + (long long)b * N * md;
  const T* Cn = Cn_g + (long long)b * (N - 1) * md;
  const T* rhs = rhs_g + (long long)b * N * mb * r;
  T* out = out_g + (long long)b * N * mb * r;
  T* a = smem + warp * kSolveSmemElems;    // z part of the current vector
  T* bl = a + 32;                          // lam part
  T* t = bl + 32;
  T* u = t + 32;
  T* w = u + 32;
  T* v = w + 32;
  T* xz = v + 32;                          // z part of x_{k+1}

  // forward sweep; y_k is kept in the output
  if (lane < dz) a[lane] = rhs[lane * r + col];
  if (lane < m) bl[lane] = rhs[(dz + lane) * r + col];
  __syncwarp();
  if (lane < dz) out[lane * r + col] = a[lane];
  if (lane < m) out[(dz + lane) * r + col] = bl[lane];
  for (int k = 1; k < N; ++k) {
    const T* Cnk = Cn + (long long)(k - 1) * md;
    const T* rk = rhs + (long long)k * mb * r;
    T* ok = out + (long long)k * mb * r;
    const T rz = lane < dz ? rk[lane * r + col] : T(0);
    const T yl = lane < m ? rk[(dz + lane) * r + col] : T(0);
    block_apply(Pinv + (long long)(k - 1) * dd, Sinv + (long long)(k - 1) * mm,
                C + (long long)(k - 1) * md, a, bl, t, u, w, v, xz, m, dz, lane, false);
    T yz = 0;
    if (lane < dz) {
      T acc = 0;
      for (int e = 0; e < m; ++e) acc += Cnk[e * dz + lane] * w[e];
      yz = rz - acc;
    }
    __syncwarp();
    if (lane < dz) { a[lane] = yz; ok[lane * r + col] = yz; }
    if (lane < m) { bl[lane] = yl; ok[(dz + lane) * r + col] = yl; }
    __syncwarp();
  }
  // backward sweep; a and bl still hold y_{N-1}
  for (int k = N - 1; k >= 0; --k) {
    T* ok = out + (long long)k * mb * r;
    if (k < N - 1) {
      const T* Cnk = Cn + (long long)k * md;
      const T yz = lane < dz ? ok[lane * r + col] : T(0);
      const T y0 = lane < m ? ok[(dz + lane) * r + col] : T(0);
      T yl = 0;
      if (lane < m) {
        T acc = 0;
        for (int e = 0; e < dz; ++e) acc += Cnk[lane * dz + e] * xz[e];
        yl = y0 - acc;
      }
      __syncwarp();
      if (lane < dz) a[lane] = yz;
      if (lane < m) bl[lane] = yl;
    }
    __syncwarp();
    block_apply(Pinv + (long long)k * dd, Sinv + (long long)k * mm,
                C + (long long)k * md, a, bl, t, u, w, v, xz, m, dz, lane, true);
    if (lane < dz) ok[lane * r + col] = xz[lane];
    if (lane < m) ok[(dz + lane) * r + col] = w[lane];
    __syncwarp();
  }
}

template <typename T>
int launch_factor(const void* P, const void* C, const void* R, const void* Cn,
                  void* Pinv, void* Sinv, int B, int N, int m, int dz, cudaStream_t st) {
  const size_t smem = sizeof(T) * factor_smem_elems(m, dz);
  if (B > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        qd_factor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    qd_factor_kernel<T><<<B, kFactorThreads, smem, st>>>(
        static_cast<const T*>(P), static_cast<const T*>(C), static_cast<const T*>(R),
        static_cast<const T*>(Cn), static_cast<T*>(Pinv), static_cast<T*>(Sinv),
        N, m, dz);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(const void* Pinv, const void* Sinv, const void* C, const void* Cn,
                 const void* rhs, void* out, int B, int N, int m, int dz, int r,
                 cudaStream_t st) {
  const long long warps = (long long)B * r;
  const long long blocks = (warps + kSolveWarps - 1) / kSolveWarps;
  const size_t smem = sizeof(T) * kSolveWarps * kSolveSmemElems;
  if (blocks > 0) {
    qd_solve_kernel<T><<<(unsigned)blocks, kSolveWarps * 32, smem, st>>>(
        static_cast<const T*>(Pinv), static_cast<const T*>(Sinv),
        static_cast<const T*>(C), static_cast<const T*>(Cn),
        static_cast<const T*>(rhs), static_cast<T*>(out), B, N, m, dz, r);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Row-major, batch leading, double (is_f64) or float: P [B, N, dz, dz],
// C [B, N, m, dz], R [B, N, m], Cn [B, N-1, m, dz] -> Pinv [B, N, dz, dz],
// Sinv [B, N, m, m]; m, dz <= 32.
extern "C" int px_qd_factor(int is_f64, const void* P, const void* C, const void* R,
                            const void* Cn, void* Pinv, void* Sinv, int B, int N,
                            int m, int dz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || m < 1 || m > 32 || dz < 1 || dz > 32) return (int)cudaErrorInvalidValue;
  return is_f64 ? launch_factor<double>(P, C, R, Cn, Pinv, Sinv, B, N, m, dz, st)
                : launch_factor<float>(P, C, R, Cn, Pinv, Sinv, B, N, m, dz, st);
}

// rhs and out [B, N, dz + m, r] ordered (z, lam) per knot.
extern "C" int px_qd_solve(int is_f64, const void* Pinv, const void* Sinv, const void* C,
                           const void* Cn, const void* rhs, void* out, int B, int N,
                           int m, int dz, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || m < 1 || m > 32 || dz < 1 || dz > 32 || r < 1)
    return (int)cudaErrorInvalidValue;
  return is_f64 ? launch_solve<double>(Pinv, Sinv, C, Cn, rhs, out, B, N, m, dz, r, st)
                : launch_solve<float>(Pinv, Sinv, C, Cn, rhs, out, B, N, m, dz, r, st);
}
