// K3's solve: the condensed KKT solved by block cyclic reduction on the
// factor of csrc/condensed_cr.cu, one launch, a thread-block cluster a
// problem.
//
// Replaces piccolax/solver/kkt.py: condensed_solve (:464) over cr_solve
// (:381). out = K^{-1} rhs, a cluster of S thread blocks (S = 1, 2, 4, 8
// or 16, planned from B r so that B r S roughly fills the card's SMs, then
// halved while the card cannot hold all B r clusters at once) a problem
// and column of rhs, through solve_engine.cuh's phases: the dual rhs, the
// CR levels down, the root, the levels up and the primal recovery. Blocks
// up to 16 wide at one block a problem (config 1, the batched quickstart)
// take one_block_solve_kernel.
#include "solve_engine.cuh"

namespace {

using px::kSolveThreads;
using px::odd_ld;
using px::px_solve_smem;
using px::Vecs;

// Blocks up to 16 wide (config 1, the quickstart): see one_block_solve_kernel.
__host__ __device__ constexpr bool narrow_solve(int m, int dz) { return m <= 16 && dz <= 16; }

// Blocks up to 16 wide at one block a problem (S = 1: B fills the card;
// config 1, the batched quickstart): one thread block runs every phase
// through common.cuh's one-block routines (dual_rhs_knots, cr_solve_block,
// primal_knots; float32 summed in float64), 512 threads.
// Measured against the cluster kernel at those shapes, staging a 13 x 13
// block costs more than its mat-vec (scripts/cr_phase_timing.py --solve).
constexpr int kOneBlockThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kOneBlockThreads)
one_block_solve_kernel(const T* __restrict__ Xi_g, const T* __restrict__ C_g,
                       const T* __restrict__ Cn_g, const T* __restrict__ cr_g,
                       const T* __restrict__ rhs_g, T* __restrict__ out_g, T* __restrict__ ws_g,
                       int N, int Np, int m, int dz, int r, long long ws_stride) {
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
  for (int idx = N * mr + tid; idx < Np * mr; idx += nt) A0[idx] = T(0);
  px::dual_rhs_knots<T>(Xi, C, Cn, rhs, N, m, dz, r, q, t, A0);
  T* x = px::cr_solve_block<T>(cr, A0, A1, rodd, tl, q2, Np, m, r);
  px::primal_knots<T>(Xi, C, Cn, rhs, x, N, m, dz, r, t, q, out);
}

// Workspace elements a problem: the cluster kernel's level vectors V and Y
// [2 Np - 1, m] a column, or the one-block kernel's.
__host__ __device__ inline long long solve_ws(int N, int Np, int m, int dz, int r) {
  const long long cl = 2LL * (2 * Np - 1) * m * r;
  const long long one = 2LL * N * dz * r + px::cr_solve_ws_elems(Np, m, r);
  return cl > one ? cl : one;
}

#ifdef PX_CR_TIMING
// the last launch's shared memory a block, resident clusters and cluster size
inline long long g_solve_config[3] = {0, 0, 0};
#endif

template <typename T>
int plan(int B, int m, int dz, int r, int& S, long long& bytes, cudaLaunchConfig_t& cfg,
         cudaLaunchAttribute* attr) {
  return px::plan_solve<T, false>((long long)B * r, m, dz, narrow_solve(m, dz), S, bytes, cfg,
                                  attr);
}

template <typename T>
int launch_solve(const void* Xi, const void* C, const void* Cn, const void* cr, const void* rhs,
                 void* out, void* ws, int B, int N, int Np, int m, int dz, int r,
                 cudaStream_t st PX_CR_PARAM) {
  int S = 1;
  long long bytes = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (int e = plan<T>(B, m, dz, r, S, bytes, cfg, attr)) return e;
  if (S == 1 && narrow_solve(m, dz)) {
#ifdef PX_CR_TIMING
    g_solve_config[0] = 0;
    g_solve_config[1] = 1;
    g_solve_config[2] = 1;
#endif
    one_block_solve_kernel<T><<<B, kOneBlockThreads, 0, st>>>(
        static_cast<const T*>(Xi), static_cast<const T*>(C), static_cast<const T*>(Cn),
        static_cast<const T*>(cr), static_cast<const T*>(rhs), static_cast<T*>(out),
        static_cast<T*>(ws), N, Np, m, dz, r, solve_ws(N, Np, m, dz, r));
    return (int)cudaGetLastError();
  }
#ifdef PX_CR_TIMING
  int dev = 0;
  cudaGetDevice(&dev);
  g_solve_config[0] = bytes;
  g_solve_config[1] = px::resident_clusters(px::solve_kernel<T, false>, cfg, dev,
                                            (int)sizeof(T), S, bytes);
  g_solve_config[2] = S;
#endif
  px::SolveArgs<T> a{};
  a.Xi = static_cast<const T*>(Xi);
  a.C = static_cast<const T*>(C);
  a.Cn = static_cast<const T*>(Cn);
  a.rhs = static_cast<const T*>(rhs);
  a.out = static_cast<T*>(out);
  a.cr = static_cast<const T*>(cr);
  a.crs = 3LL * Np * m * m;
  a.ws = static_cast<T*>(ws);
  a.wss = 2LL * (2 * Np - 1) * m;
  a.N = N; a.Np = Np; a.m = m; a.dz = dz; a.r = r; a.S = S; a.P = 1; a.L = N;
  a.nrows = N;
  a.head = px::kDual;
  a.tail = px::kPrimal;
  return px::launch_planned<T, false>(cfg, r, a, bytes, st PX_CR_ARG(stamps));
}

}  // namespace

// Workspace of the solve, in elements of T per problem (solve_ws).
extern "C" long long px_condensed_solve_ws(int N, int Np, int m, int dz, int r) {
  return solve_ws(N, Np, m, dz, r);
}

// The cluster size a solve of B problems and r columns launches with on the
// current card (px::plan_solve), or -1 on an error.
extern "C" int px_condensed_solve_cluster(int is_f64, int B, int m, int dz, int r) {
  int cluster = 1;
  long long bytes = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int e = is_f64 ? plan<double>(B, m, dz, r, cluster, bytes, cfg, attr)
                       : plan<float>(B, m, dz, r, cluster, bytes, cfg, attr);
  return e ? -1 : cluster;
}

// Under PX_CR_TIMING the stamps buffer (see condensed_solve_kernel)
// follows the stream.
extern "C" int px_condensed_solve(int is_f64, const void* Xi, const void* C,
                                  const void* Cnext, const void* cr,
                                  const void* rhs, void* out, void* ws, int B,
                                  int N, int Np, int m, int dz, int r,
                                  void* stream PX_CR_PARAM) {
  if (m < 1 || m > px::kMaxCholM || dz < 1 || dz > px::kMaxCholM || N < 1 || Np < N ||
      (Np & (Np - 1)) || r < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_solve<double>(Xi, C, Cnext, cr, rhs, out, ws, B, N, Np, m, dz, r,
                                       st PX_CR_ARG(stamps))
                : launch_solve<float>(Xi, C, Cnext, cr, rhs, out, ws, B, N, Np, m, dz, r,
                                      st PX_CR_ARG(stamps));
}

#ifdef PX_CR_TIMING
// The last launch's shared memory a block (bytes), how many of its
// clusters the card holds at once and its cluster size, into out[0..2].
extern "C" void px_solve_config(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = g_solve_config[i];
}
#endif

#ifdef PX_CR_TIMING
// Cycles of the pieces of a phase step, for scripts/cr_phase_timing.py:
// out[0] reps of a block mat-vec (one m x m block, staged) each followed
// by a barrier, out[1] reps of the barrier alone, out[2] reps of an m-term
// dot product (G = 1) by every thread, out[3] by m threads, out[4] reps
// of the block mat-vec without barriers.
template <typename T>
__global__ void mv_probe_kernel(const T* M, int m, int reps, long long* out) {
  using A = px::acc_t<T>;
  T* Ms = reinterpret_cast<T*>(px_solve_smem);
  const int ld = odd_ld(m);
  A* x = reinterpret_cast<A*>(Ms + ((m * ld + 1) / 2) * 2);
  A* y = x + m;
  px::stage(Ms, ld, M, m, m);
  px::cp_async_commit();
  px::cp_async_wait_group<0>();
  for (int a = threadIdx.x; a < m; a += blockDim.x) x[a] = A(1) / (a + 1);
  __syncthreads();
  long long t0 = clock64();
  for (int i = 0; i < reps; ++i) {
    px::matvec<T, false>(1, m, m, Ms, 0, ld, Vecs<A>{x, 0}, [&](int, int a, A s) { y[a] = s; });
    __syncthreads();
  }
  long long t1 = clock64();
  for (int i = 0; i < reps; ++i) __syncthreads();
  long long t2 = clock64();
  A acc = 0;
  for (int i = 0; i < reps; ++i) acc += px::dot<T, false>(Ms, ld, threadIdx.x % m, 0, 1, m, x);
  long long t3 = clock64();
  for (int i = 0; i < reps; ++i)
    if (threadIdx.x < m) acc += px::dot<T, false>(Ms, ld, threadIdx.x, 0, 1, m, x);
  __syncthreads();
  long long t4 = clock64();
  for (int i = 0; i < reps; ++i)
    px::matvec<T, false>(1, m, m, Ms, 0, ld, Vecs<A>{x, 0}, [&](int, int a, A s) { y[a] += s; });
  __syncthreads();
  long long t5 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = t3 - t2;
    out[3] = t4 - t3;
    out[4] = t5 - t4;
    out[5] = (long long)(acc + y[0]);
  }
}

extern "C" int px_solve_mv_probe(int is_f64, const void* M, int m, int reps, long long* out) {
  if (is_f64)
    mv_probe_kernel<double><<<1, kSolveThreads, 32 * 1024>>>((const double*)M, m, reps, out);
  else
    mv_probe_kernel<float><<<1, kSolveThreads, 32 * 1024>>>((const float*)M, m, reps, out);
  return (int)cudaGetLastError();
}
#endif
