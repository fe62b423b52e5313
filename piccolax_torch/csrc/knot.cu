// K9: the knot-partitioned (SPIKE) condensed KKT and block-tridiagonal
// solve (kkt_backend "knot").
//
// Replaces piccolax/parallel/sharded_kkt.py: _knot_factor_body,
// _knot_solve_body and _local_partition_solve under shard_map, the knot
// axis sharded over a device mesh. Each device owns L = N / P contiguous
// knots [f, i_1 .. i_k, l] (k = L - 2): it factors its interior block T by
// cyclic reduction, forms the SPIKE columns T^{-1} [e_1 U_f^T | e_k U_l]
// and the reduced interface rows (Df, Dl, Ufl and the coupling U_x to the
// next device); one all_gather assembles the 2P-row interface system,
// which every device factors and solves redundantly; a ppermute brings the
// neighbour's first knot (the halo) and, in the solve, the previous
// device's last multiplier.
//
// On one H100 the mesh axis becomes P partitions, each a thread block: the
// all_gather is a write and a read of the interface rows in device memory,
// a ppermute a read across the partition edge, and the point is to spread
// one problem over P SMs where K3 runs it on one. One thread block per
// (partition, problem), and a launch where JAX has a collective:
//   factor (a) grid P x B: Y = C Xi^T and Yn = Cn Xi_next^T over the
//              partition and its halo knot, D and U, the interior CR
//              factor, the SPIKE columns, the interface rows;
//          (b) grid B: the interface system's CR factor (once per problem,
//              where JAX repeats it on every device);
//   solve  (c1) grid P x B: t = Pinv r_z over the partition and its halo,
//              the dual rhs b, the interior solve, the interface rhs;
//          (c2) grid B: the interface solve;
//          (c3) grid P x B: x_int, lambda and the primal back-substitution
//              w -> z, reading the previous partition's last multiplier.
// The standalone block-tridiagonal solve (given diag and upper) runs the
// same kernels without the condensation and the primal part.
//
// The interior and interface systems use K3's level loop and K1's warp
// Cholesky inverse (common.cuh). Every intermediate lives in a device-
// memory workspace private to its block (L1/L2 resident). At config 3
// (m = 40, dz = 44, N = 200, P = 8) a factor is ~0.7 GFLOP per problem,
// most of it the SPIKE columns' 2m right-hand sides, ~0.01 ms at the
// card's float64 peak; what a launch takes is latency, the level loop's
// dependent steps over that workspace, which P partitions shorten and
// spread over P SMs.
//
// Factor layout (shared with the plain version, parallel/sharded_kkt.py):
// fT [B, P, 3, Npk, m, m] the interior CR factors (Npk = k padded to a power
// of two), spike [B, P, k, m, 2m] = T^{-1} [e_1 U_f^T | e_k U_l],
// Ub [B, P, 2, m, m] = (U_f, U_l), f_if [B, 3, Npi, m, m] the interface CR
// factor (Npi = 2P padded).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Sizes shared by the host (workspace) and the kernels (offsets).
struct Dims {
  int B, N, P, L, k, Npk, Npi, m, dz;
  __host__ __device__ Dims(int B_, int N_, int P_, int m_, int dz_)
      : B(B_), N(N_), P(P_), L(N_ / P_), k(N_ / P_ - 2),
        Npk(pow2_at_least(N_ / P_ - 2)), Npi(pow2_at_least(2 * P_)), m(m_), dz(dz_) {}
  // Factor workspace: per partition Y [L+1, m, dz], Yn [L, m, dz],
  // D, U [L, m, m], the interior CR factor's and the SPIKE solve's; then
  // per problem the interface CR factor's, whose first blocks receive the
  // gathered interface rows.
  __host__ __device__ long long fpart() const {
    return (2LL * L + 1) * m * dz + 2LL * L * m * m + px::cr_factor_ws_elems(Npk, m) +
           px::cr_solve_ws_elems(Npk, m, 2 * m);
  }
  __host__ __device__ long long fif() const { return px::cr_factor_ws_elems(Npi, m); }
  __host__ __device__ long long fws() const { return (long long)B * (P * fpart() + fif()); }
  // Solve workspace: per partition t, q [L+1, dz, r], b [L, m, r], the
  // interior CR solve's, the interior solution [k, m, r], lambda [L, m, r]
  // and w [L, dz, r]; then per problem the interface CR solve's, whose
  // first rows receive the gathered interface rhs, and the interface
  // solution [2P, m, r].
  __host__ __device__ long long spart(int r) const {
    return 2LL * (L + 1) * dz * r + 2LL * L * m * r + px::cr_solve_ws_elems(Npk, m, r) +
           (long long)k * m * r + (long long)L * dz * r;
  }
  __host__ __device__ long long sif(int r) const {
    return px::cr_solve_ws_elems(Npi, m, r) + 2LL * P * m * r;
  }
  __host__ __device__ long long sws(int r) const {
    return (long long)B * (P * spart(r) + sif(r));
  }
};

// (a) partition factor. kCond: D and U from the knot factors Xi, C, R and
// Cn (the condensed KKT); otherwise read from diag [B, N, m, m] and
// upper [B, N-1, m, m].
template <typename T, bool kCond>
__global__ void knot_factor_kernel(const T* __restrict__ Xi_g, const T* __restrict__ C_g,
                                   const T* __restrict__ R_g, const T* __restrict__ Cn_g,
                                   const T* __restrict__ diag_g, const T* __restrict__ up_g,
                                   T* __restrict__ fT_g, T* __restrict__ spike_g,
                                   T* __restrict__ Ub_g, T* __restrict__ ws_g, Dims g) {
  PX_SMEM(T);
  const int p = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int N = g.N, P = g.P, L = g.L, k = g.k, Npk = g.Npk, m = g.m, dz = g.dz;
  const int mm = m * m, md = m * dz, dd = dz * dz, m2 = 2 * m;
  const int j0 = p * L;
  T* S = smem + (tid / 32) * px::chol_scratch_elems(m);
  T* ws = ws_g + ((long long)b * P + p) * g.fpart();
  T* Y = ws;                            // [L+1, m, dz]
  T* Yn = Y + (long long)(L + 1) * md;  // [L, m, dz]
  T* D = Yn + (long long)L * md;        // [L, m, m]
  T* U = D + (long long)L * mm;         // [L, m, m]; U[L-1] couples to p + 1
  T* F = U + (long long)L * mm;         // interior CR factor workspace
  T* D0 = F;
  T* D1 = D0 + (long long)Npk * mm;
  T* U0 = D1 + (long long)Npk * mm;
  T* U1 = U0 + (long long)Npk * mm;
  T* Gl = U1 + (long long)Npk * mm;
  T* Gr = Gl + (long long)(Npk / 2) * mm;
  T* A0 = F + px::cr_factor_ws_elems(Npk, m);  // SPIKE solve workspace
  T* A1 = A0 + (long long)Npk * m * m2;
  T* rodd = A1 + (long long)Npk * m * m2;
  T* tl = rodd + (long long)Npk * m * m2;
  T* q2 = tl + (long long)(Npk / 2) * m * m2;
  T* fT = fT_g + ((long long)b * P + p) * 3 * Npk * mm;
  T* spike = spike_g + ((long long)b * P + p) * k * m * m2;
  T* Ub = Ub_g + ((long long)b * P + p) * 2 * mm;
  // the gathered interface system of problem b: D rows and U rows
  T* Dif = ws_g + (long long)g.B * P * g.fpart() + (long long)b * g.fif();
  T* Uif = Dif + 2LL * g.Npi * mm;

  if (kCond) {
    px::condense_knots<T>(Xi_g + (long long)b * N * dd, C_g + (long long)b * N * md,
                          R_g + (long long)b * N * m, Cn_g + (long long)b * (N - 1) * md,
                          N, j0, L, m, dz, Y, Yn, D, U);
  } else {
    const T* dg = diag_g + (long long)b * N * mm;
    const T* up = up_g + (long long)b * (N - 1) * mm;
    for (int idx = tid; idx < L * mm; idx += nt) {
      const int j = j0 + idx / mm;
      D[idx] = dg[(long long)j0 * mm + idx];
      U[idx] = (j < N - 1) ? up[(long long)j0 * mm + idx] : T(0);
    }
  }
  __syncthreads();

  // interior T = rows 1 .. L-2, padded to Npk with identity / zero blocks
  for (int idx = tid; idx < Npk * mm; idx += nt) {
    const int kk = idx / mm, e = idx % mm, a = e / m, c = e % m;
    D0[idx] = kk < k ? D[(kk + 1) * mm + e] : (a == c ? T(1) : T(0));
    U0[idx] = kk < k - 1 ? U[(kk + 1) * mm + e] : T(0);
  }
  __syncthreads();
  px::cr_factor_block<T>(D0, D1, U0, U1, Gl, Gr, fT, Npk, m, S);

  // SPIKE columns [e_1 U_f^T | e_k U_l], U_f = U[0], U_l = U[L-2]
  const T* Uf = U;
  const T* Ul = U + (L - 2) * mm;
  for (int idx = tid; idx < Npk * m * m2; idx += nt) {
    const int kk = idx / (m * m2), a = (idx / m2) % m, s = idx % m2;
    T v = 0;
    if (kk == 0 && s < m) v = Uf[s * m + a];
    if (kk == k - 1 && s >= m) v = Ul[a * m + s - m];
    A0[idx] = v;
  }
  __syncthreads();
  const T* x = px::cr_solve_block<T>(fT, A0, A1, rodd, tl, q2, Npk, m, m2);
  for (int idx = tid; idx < k * m * m2; idx += nt) spike[idx] = x[idx];
  // reduced interface rows of this partition: rows 2p (f) and 2p + 1 (l)
  const T* x_last = x + (long long)(k - 1) * m * m2;
  for (int idx = tid; idx < mm; idx += nt) {
    const int a = idx / m, c = idx % m;
    T s1 = 0, s2 = 0, s3 = 0;
    for (int e = 0; e < m; ++e) {
      s1 += Uf[a * m + e] * x[e * m2 + c];           // U_f (T^-1 U_f^T)_1
      s2 += Ul[e * m + a] * x_last[e * m2 + m + c];  // U_l^T (T^-1 U_l)_k
      s3 += Uf[a * m + e] * x[e * m2 + m + c];       // U_f (T^-1 U_l)_1
    }
    Dif[(2LL * p) * mm + idx] = D[idx] - s1;
    Dif[(2LL * p + 1) * mm + idx] = D[(L - 1) * mm + idx] - s2;
    Uif[(2LL * p) * mm + idx] = -s3;
    Uif[(2LL * p + 1) * mm + idx] = U[(L - 1) * mm + idx];
    Ub[idx] = Uf[idx];
    Ub[mm + idx] = Ul[idx];
  }
}

// (b) the interface system's CR factor: rows past 2P padded.
template <typename T>
__global__ void knot_if_factor_kernel(T* __restrict__ fif_g, T* __restrict__ ws_g, Dims g) {
  PX_SMEM(T);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int m = g.m, mm = m * m, Npi = g.Npi, P = g.P;
  T* S = smem + (tid / 32) * px::chol_scratch_elems(m);
  T* D0 = ws_g + (long long)g.B * P * g.fpart() + (long long)b * g.fif();
  T* D1 = D0 + (long long)Npi * mm;
  T* U0 = D1 + (long long)Npi * mm;
  T* U1 = U0 + (long long)Npi * mm;
  T* Gl = U1 + (long long)Npi * mm;
  T* Gr = Gl + (long long)(Npi / 2) * mm;
  for (int idx = 2 * P * mm + tid; idx < Npi * mm; idx += nt) {
    const int e = idx % mm;
    D0[idx] = (e / m == e % m) ? T(1) : T(0);
    U0[idx] = T(0);
  }
  __syncthreads();
  px::cr_factor_block<T>(D0, D1, U0, U1, Gl, Gr, fif_g + (long long)b * 3 * Npi * mm, Npi, m, S);
}

// (c1) local rhs and interior solve. kCond: rhs [B, N, dz + m, r] of the
// condensed KKT; otherwise rhs [B, N, m, r] of the block-tridiagonal system.
template <typename T, bool kCond>
__global__ void knot_solve_local_kernel(const T* __restrict__ Xi_g, const T* __restrict__ C_g,
                                        const T* __restrict__ Cn_g, const T* __restrict__ fT_g,
                                        const T* __restrict__ Ub_g, const T* __restrict__ rhs_g,
                                        T* __restrict__ ws_g, Dims g, int r) {
  const int p = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int N = g.N, P = g.P, L = g.L, k = g.k, Npk = g.Npk, m = g.m, dz = g.dz;
  const int mm = m * m, md = m * dz, dd = dz * dz, mr = m * r, dr = dz * r;
  const int mb = kCond ? dz + m : m;
  const int j0 = p * L;
  T* ws = ws_g + ((long long)b * P + p) * g.spart(r);
  T* t = ws;                               // [L+1, dz, r]
  T* q = t + (long long)(L + 1) * dr;      // [L+1, dz, r]
  T* bv = q + (long long)(L + 1) * dr;     // [L, m, r]
  T* A0 = bv + (long long)L * mr;          // interior CR solve workspace
  T* A1 = A0 + (long long)Npk * mr;
  T* rodd = A1 + (long long)Npk * mr;
  T* tl = rodd + (long long)Npk * mr;
  T* q2 = tl + (long long)(Npk / 2) * mr;
  T* rs = A0 + px::cr_solve_ws_elems(Npk, m, r);  // [k, m, r]
  T* Aif = ws_g + (long long)g.B * P * g.spart(r) + (long long)b * g.sif(r);
  const T* fT = fT_g + ((long long)b * P + p) * 3 * Npk * mm;
  const T* Uf = Ub_g + ((long long)b * P + p) * 2 * mm;
  const T* Ul = Uf + mm;
  const T* rhs = rhs_g + (long long)b * N * mb * r;

  if (kCond) {
    px::dual_rhs_knots<T>(Xi_g + (long long)b * N * dd, C_g + (long long)b * N * md,
                          Cn_g + (long long)b * (N - 1) * md, rhs, N, j0, L, m, dz, r,
                          q, t, bv);
  } else {
    for (int idx = tid; idx < L * mr; idx += nt) bv[idx] = rhs[(long long)j0 * mr + idx];
  }
  __syncthreads();
  for (int idx = tid; idx < Npk * mr; idx += nt)
    A0[idx] = idx < k * mr ? bv[mr + idx] : T(0);
  __syncthreads();
  const T* x = px::cr_solve_block<T>(fT, A0, A1, rodd, tl, q2, Npk, m, r);
  for (int idx = tid; idx < k * mr; idx += nt) rs[idx] = x[idx];
  const T* x_last = x + (long long)(k - 1) * mr;
  for (int idx = tid; idx < mr; idx += nt) {
    const int a = idx / r, s = idx % r;
    T s1 = 0, s2 = 0;
    for (int e = 0; e < m; ++e) {
      s1 += Uf[a * m + e] * x[e * r + s];
      s2 += Ul[e * m + a] * x_last[e * r + s];
    }
    Aif[(2LL * p) * mr + idx] = bv[idx] - s1;
    Aif[(2LL * p + 1) * mr + idx] = bv[(L - 1) * mr + idx] - s2;
  }
}

// (c2) the interface solve: rows past 2P zero.
template <typename T>
__global__ void knot_if_solve_kernel(const T* __restrict__ fif_g, T* __restrict__ ws_g,
                                     Dims g, int r) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int m = g.m, mr = m * r, Npi = g.Npi, P = g.P;
  T* A0 = ws_g + (long long)g.B * P * g.spart(r) + (long long)b * g.sif(r);
  T* A1 = A0 + (long long)Npi * mr;
  T* rodd = A1 + (long long)Npi * mr;
  T* tl = rodd + (long long)Npi * mr;
  T* q2 = tl + (long long)(Npi / 2) * mr;
  T* xif = A0 + px::cr_solve_ws_elems(Npi, m, r);
  for (int idx = 2 * P * mr + tid; idx < Npi * mr; idx += nt) A0[idx] = T(0);
  __syncthreads();
  const T* x = px::cr_solve_block<T>(fif_g + (long long)b * 3 * Npi * m * m, A0, A1, rodd,
                                     tl, q2, Npi, m, r);
  for (int idx = tid; idx < 2 * P * mr; idx += nt) xif[idx] = x[idx];
}

// (c3) x_int and lambda; kCond: the primal back-substitution and out
// [B, N, dz + m, r], else out = lambda [B, N, m, r].
template <typename T, bool kCond>
__global__ void knot_solve_back_kernel(const T* __restrict__ Xi_g, const T* __restrict__ C_g,
                                       const T* __restrict__ Cn_g, const T* __restrict__ spike_g,
                                       const T* __restrict__ rhs_g, T* __restrict__ out_g,
                                       T* __restrict__ ws_g, Dims g, int r) {
  const int p = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int N = g.N, P = g.P, L = g.L, k = g.k, Npk = g.Npk, m = g.m, dz = g.dz;
  const int md = m * dz, dd = dz * dz, mr = m * r, dr = dz * r, m2 = 2 * m;
  const int mb = kCond ? dz + m : m;
  const int j0 = p * L;
  T* ws = ws_g + ((long long)b * P + p) * g.spart(r);
  T* q = ws + (long long)(L + 1) * dr;
  T* rs = ws + 2LL * (L + 1) * dr + (long long)L * mr + px::cr_solve_ws_elems(Npk, m, r);
  T* lam = rs + (long long)k * mr;         // [L, m, r]
  T* w = lam + (long long)L * mr;          // [L, dz, r]
  const T* xif = ws_g + (long long)g.B * P * g.spart(r) + (long long)b * g.sif(r) +
                 px::cr_solve_ws_elems(g.Npi, m, r);
  const T* x_f = xif + (2LL * p) * mr;
  const T* x_l = x_f + mr;
  const T* spike = spike_g + ((long long)b * P + p) * k * m * m2;
  T* out = out_g + (long long)b * N * mb * r;

  for (int idx = tid; idx < L * mr; idx += nt) {
    const int kk = idx / mr, a = (idx / r) % m, s = idx % r;
    T v;
    if (kk == 0) {
      v = x_f[a * r + s];
    } else if (kk == L - 1) {
      v = x_l[a * r + s];
    } else {
      const T* sp = spike + (long long)(kk - 1) * m * m2 + a * m2;
      T s1 = 0, s2 = 0;
      for (int e = 0; e < m; ++e) {
        s1 += sp[e] * x_f[e * r + s];
        s2 += sp[m + e] * x_l[e * r + s];
      }
      v = (rs[(kk - 1) * mr + a * r + s] - s1) - s2;
    }
    if (kCond) lam[idx] = v;
    else out[(long long)j0 * mr + idx] = v;
  }
  if (!kCond) return;
  __syncthreads();
  // lam_{j0-1} is the previous partition's x_l
  px::primal_knots<T>(Xi_g + (long long)b * N * dd, C_g + (long long)b * N * md,
                      Cn_g + (long long)b * (N - 1) * md, rhs_g + (long long)b * N * mb * r,
                      lam, x_f - mr, j0, L, m, dz, r, w, q, out + (long long)j0 * mb * r);
}

// Launches (a) and (b): the chol_inv_warp kernels take up to eight warps,
// as many as m's scratch lets fit in 227 KB.
template <typename T, bool kCond>
int launch_factor(const void* Xi, const void* C, const void* R, const void* Cn,
                  const void* diag, const void* up, void* fT, void* spike, void* Ub,
                  void* fif, void* ws, const Dims& g, cudaStream_t st) {
  const size_t per_warp = sizeof(T) * px::chol_scratch_elems(g.m);
  const int warps = px::warps_that_fit(per_warp, kThreads / 32);
  const size_t smem = per_warp * warps;
  cudaFuncSetAttribute(knot_factor_kernel<T, kCond>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  knot_factor_kernel<T, kCond><<<dim3(g.P, g.B), warps * 32, smem, st>>>(
      (const T*)Xi, (const T*)C, (const T*)R, (const T*)Cn, (const T*)diag, (const T*)up,
      (T*)fT, (T*)spike, (T*)Ub, (T*)ws, g);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  cudaFuncSetAttribute(knot_if_factor_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  knot_if_factor_kernel<T><<<g.B, warps * 32, smem, st>>>((T*)fif, (T*)ws, g);
  return (int)cudaGetLastError();
}

// Launches (c1), (c2), (c3).
template <typename T, bool kCond>
int launch_solve(const void* Xi, const void* C, const void* Cn, const void* fT,
                 const void* spike, const void* Ub, const void* fif, const void* rhs,
                 void* out, void* ws, const Dims& g, int r, cudaStream_t st) {
  knot_solve_local_kernel<T, kCond><<<dim3(g.P, g.B), kThreads, 0, st>>>(
      (const T*)Xi, (const T*)C, (const T*)Cn, (const T*)fT, (const T*)Ub, (const T*)rhs,
      (T*)ws, g, r);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  knot_if_solve_kernel<T><<<g.B, kThreads, 0, st>>>((const T*)fif, (T*)ws, g, r);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  knot_solve_back_kernel<T, kCond><<<dim3(g.P, g.B), kThreads, 0, st>>>(
      (const T*)Xi, (const T*)C, (const T*)Cn, (const T*)spike, (const T*)rhs, (T*)out,
      (T*)ws, g, r);
  return (int)cudaGetLastError();
}

bool valid(int B, int N, int P, int m, int dz) {
  return B >= 1 && P >= 1 && N % P == 0 && N / P >= 3 && m >= 1 && m <= px::kMaxCholM &&
         dz >= 0 && P <= 65535 && B <= 65535;
}

}  // namespace

// Workspace elements of a factor / a solve of B problems (dz = 0: the
// standalone block-tridiagonal system).
extern "C" long long px_knot_factor_ws(int B, int N, int P, int m, int dz) {
  return Dims(B, N, P, m, dz).fws();
}

extern "C" long long px_knot_solve_ws(int B, int N, int P, int m, int dz, int r) {
  return Dims(B, N, P, m, dz).sws(r);
}

// Factor of the condensed KKT from the knot factors Xi [B, N, dz, dz]
// (K1), C [B, N, m, dz], Rdiag [B, N, m], Cnext [B, N-1, m, dz].
extern "C" int px_knot_factor(int is_f64, const void* Xi, const void* C, const void* Rdiag,
                              const void* Cnext, void* fT, void* spike, void* Ub, void* fif,
                              void* ws, int B, int N, int P, int m, int dz, void* stream) {
  if (!valid(B, N, P, m, dz) || dz < 1) return (int)cudaErrorInvalidValue;
  const Dims g(B, N, P, m, dz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_factor<double, true>(Xi, C, Rdiag, Cnext, nullptr, nullptr, fT, spike,
                                              Ub, fif, ws, g, st)
                : launch_factor<float, true>(Xi, C, Rdiag, Cnext, nullptr, nullptr, fT, spike,
                                             Ub, fif, ws, g, st);
}

// Solve of the condensed KKT, rhs / out [B, N, dz + m, r].
extern "C" int px_knot_solve(int is_f64, const void* Xi, const void* C, const void* Cnext,
                             const void* fT, const void* spike, const void* Ub,
                             const void* fif, const void* rhs, void* out, void* ws, int B,
                             int N, int P, int m, int dz, int r, void* stream) {
  if (!valid(B, N, P, m, dz) || dz < 1 || r < 1) return (int)cudaErrorInvalidValue;
  const Dims g(B, N, P, m, dz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_solve<double, true>(Xi, C, Cnext, fT, spike, Ub, fif, rhs, out, ws,
                                             g, r, st)
                : launch_solve<float, true>(Xi, C, Cnext, fT, spike, Ub, fif, rhs, out, ws,
                                            g, r, st);
}

// The SPD block-tridiagonal system diag [B, N, m, m], upper
// [B, N-1, m, m]: factor into fT, spike, Ub, fif, then solve rhs / out
// [B, N, m, r] (fws holds the factor's workspace, sws the solve's).
extern "C" int px_knot_tridiag_solve(int is_f64, const void* diag, const void* upper,
                                     const void* rhs, void* out, void* fT, void* spike,
                                     void* Ub, void* fif, void* fws, void* sws, int B, int N,
                                     int P, int m, int r, void* stream) {
  if (!valid(B, N, P, m, 0) || r < 1) return (int)cudaErrorInvalidValue;
  const Dims g(B, N, P, m, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = is_f64 ? launch_factor<double, false>(nullptr, nullptr, nullptr, nullptr, diag, upper,
                                                 fT, spike, Ub, fif, fws, g, st)
                  : launch_factor<float, false>(nullptr, nullptr, nullptr, nullptr, diag, upper,
                                                fT, spike, Ub, fif, fws, g, st);
  if (rc) return rc;
  return is_f64 ? launch_solve<double, false>(nullptr, nullptr, nullptr, fT, spike, Ub, fif,
                                              rhs, out, sws, g, r, st)
                : launch_solve<float, false>(nullptr, nullptr, nullptr, fT, spike, Ub, fif,
                                             rhs, out, sws, g, r, st);
}
