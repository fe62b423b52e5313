// K3: condensed dual Schur complement of the per-knot KKT, factored and
// solved by block cyclic reduction.
//
// Replaces piccolax/solver/kkt.py: condensed_factor / condensed_solve over
// cr_factor / cr_solve. On the TPU each CR level is a batched matmul over
// all knots; here one thread block owns one problem and runs the whole
// level loop itself (log2(Np) levels, Np = N padded to a power of two), so
// a factor is one launch and a solve is one launch instead of dozens of
// small ones. The blocks are 12 x 12 on config 1 and 40 x 40 on config 3
// (CNOT): the work is a few MFLOP per problem on config 1 and the bound is
// the bytes of P, C and the factor, far below what the block-serial loop
// takes. Reduced blocks and right-hand sides live in a device-memory
// workspace private to the block (L1/L2 resident). The per-knot arithmetic
// (condense_knots, dual_rhs_knots, primal_knots), the level loop and the
// Cholesky-inverse of every reduced diagonal block (K1's warp routine) are
// common.cuh's, which K9 shares.
//
// Factor layout cr [B, 3, Np, m, m]: level l (n = Np >> l rows, n/2 odd
// rows eliminated) stores Xi, Ul, Ur of its odd rows at slots
// off_l .. off_l + n/2 - 1, off_l = Np - (Np >> l); slot Np - 1 of the Xi
// plane holds the root factor.
#include "common.cuh"

namespace {

// The condensation of all N knots (D padded with identity blocks, U with
// zeros), then the CR levels.
template <typename T>
__global__ void cr_factor_kernel(const T* __restrict__ Xi_g, const T* __restrict__ C_g,
                                 const T* __restrict__ R_g, const T* __restrict__ Cn_g,
                                 T* __restrict__ cr_g, T* __restrict__ ws_g,
                                 int N, int Np, int m, int dz, long long ws_stride) {
  PX_SMEM(T);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32;
  const int mm = m * m, md = m * dz, dd = dz * dz;
  const T* Xi = Xi_g + (long long)b * N * dd;
  const T* C = C_g + (long long)b * N * md;
  const T* Rd = R_g + (long long)b * N * m;
  const T* Cn = Cn_g + (long long)b * (N - 1) * md;
  T* cr = cr_g + (long long)b * 3 * Np * mm;
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

  px::condense_knots<T>(Xi, C, Rd, Cn, N, 0, N, m, dz, Y, Yn, D0, U0);
  for (int idx = N * mm + tid; idx < Np * mm; idx += nt) {
    const int e = idx % mm;
    D0[idx] = (e / m == e % m) ? T(1) : T(0);
    U0[idx] = T(0);
  }
  __syncthreads();

  px::cr_factor_block<T>(D0, D1, U0, U1, Gl, Gr, cr, Np, m, S);
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

  // dual rhs b_k = C_k t_k - rc_k + Cnext_k t_{k+1}, zero-padded to Np
  for (int idx = N * mr + tid; idx < Np * mr; idx += nt) A0[idx] = T(0);
  px::dual_rhs_knots<T>(Xi, C, Cn, rhs, N, 0, N, m, dz, r, q, t, A0);

  T* x = px::cr_solve_block<T>(cr, A0, A1, rodd, tl, q2, Np, m, r);
  // primal recovery: w_k = rz_k - C_k^T lam_k - Cnext_{k-1}^T lam_{k-1}
  px::primal_knots<T>(Xi, C, Cn, rhs, x, nullptr, 0, N, m, dz, r, t, q, out);
}

constexpr int kThreads = 256;

// The factor runs K1's warp routine on one diagonal block per warp, each
// warp with its own scratch: up to eight warps, fewer where m's scratch
// would pass the 227 KB a block may hold (m = 40 in float64 fits eight,
// m = 64 three).
template <typename T>
int launch_factor(const void* Xi, const void* C, const void* Rdiag, const void* Cnext,
                  void* cr, void* ws, int B, int N, int Np, int m, int dz,
                  long long wss, cudaStream_t st) {
  const size_t per_warp = sizeof(T) * px::chol_scratch_elems(m);
  const int warps = px::warps_that_fit(per_warp, kThreads / 32);
  const size_t smem = per_warp * warps;
  cudaFuncSetAttribute(cr_factor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cr_factor_kernel<T><<<B, warps * 32, smem, st>>>(
      (const T*)Xi, (const T*)C, (const T*)Rdiag, (const T*)Cnext, (T*)cr, (T*)ws,
      N, Np, m, dz, wss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long px_cr_factor_ws(int N, int Np, int m, int dz) {
  return 2LL * N * m * dz + px::cr_factor_ws_elems(Np, m);
}

extern "C" long long px_condensed_solve_ws(int N, int Np, int m, int dz, int r) {
  return 2LL * N * dz * r + px::cr_solve_ws_elems(Np, m, r);
}

// m <= 64 (K1's warp routine)
extern "C" int px_cr_factor(int is_f64, const void* Xi, const void* C,
                            const void* Rdiag, const void* Cnext, void* cr,
                            void* ws, int B, int N, int Np, int m, int dz,
                            void* stream) {
  if (m < 1 || m > px::kMaxCholM) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long wss = px_cr_factor_ws(N, Np, m, dz);
  return is_f64 ? launch_factor<double>(Xi, C, Rdiag, Cnext, cr, ws, B, N, Np, m, dz, wss, st)
                : launch_factor<float>(Xi, C, Rdiag, Cnext, cr, ws, B, N, Np, m, dz, wss, st);
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
