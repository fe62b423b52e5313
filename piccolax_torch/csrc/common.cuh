// Shared device routines of the port's kernels (built for sm_90a).
//
// chol_inv is the device form of piccolax.solver.kkt.chol_inv_factor: the
// lower-triangular Xi with A^{-1} = Xi^T Xi of one SPD block up to 64 wide,
// its rows in registers, one warp up to 32 wide and two past it. K7 (qd.cu)
// runs it along its recursion and the cyclic-reduction factor below on
// every reduced diagonal block; K1 (chol_inv.cu) runs the same arithmetic
// with two rows a lane on a segment of a warp.
//
// block_gemm is a thread block's product of two small operands staged in
// shared memory tiles, each entry's sum taken in the order of a plain loop.
//
// cr_factor (launch_cr_factor) is the device form of
// piccolax.solver.kkt.cr_factor: block cyclic reduction of S SPD
// block-tridiagonal systems at once, two launches a level, one thread block
// a row (module notes below); condense (launch_condense) forms the
// condensed dual system of the KKT knot by knot, one thread block a knot.
// K3 (condensed_cr.cu) runs them on a batch of problems, K9 (knot.cu) on
// the interiors of the knot partitions and on the interface systems.
//
// cr_solve_block is the device form of piccolax.solver.kkt.cr_solve: one
// system's whole solve in one thread block (K3's for blocks up to 16 wide
// at one block a problem; the cluster solves of K3 and K9 are
// solve_engine.cuh's), and dual_rhs_knots / primal_knots the condensed
// KKT's per-knot right-hand side and primal recovery of a problem.
//
// Under the compile-time switch PX_CR_TIMING (off by default) the factor's
// kernels write clock64() and %globaltimer stamps of their first thread
// block, and its entry points take one more argument, the stamps' buffer;
// scripts/cr_phase_timing.py builds and reads them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define PX_SMEM(T) \
  extern __shared__ __align__(16) unsigned char px_smem_raw[]; \
  T* smem = reinterpret_cast<T*>(px_smem_raw)

#ifdef PX_CR_TIMING
// Per launch q, 8 slots at stamps + 8 q of the launch's first row group:
// [1] %globaltimer at its start, [2] clock64() at its start, [3] and [4]
// after its first and second phases, [5] clock64() and [6] %globaltimer
// at its end. px::g_kinds[q] names the launch (kind + 256 level).
#define PX_CR_PARAM , long long* stamps
#define PX_CR_ARG(p) , (p)
#define PX_CR_NEXT(kind, level) , px::next_stamps(stamps, (kind), (level))
// (of group 0 of block 0, the group g in scope)
#define PX_CR_KSTAMP(i) do { if (stamps && blockIdx.x == 0 && g.index == 0) { g.sync(); \
  if (g.tid == 0) stamps[i] = clock64(); } } while (0)
#define PX_CR_BEGIN() do { if (stamps && blockIdx.x == 0 && g.index == 0 && g.tid == 0) { \
  stamps[1] = px::global_ns(); stamps[2] = clock64(); } } while (0)
#define PX_CR_END() do { if (stamps && blockIdx.x == 0 && g.index == 0) { g.sync(); \
  if (g.tid == 0) { stamps[5] = clock64(); stamps[6] = px::global_ns(); } } } while (0)
#else
#define PX_CR_PARAM
#define PX_CR_ARG(p)
#define PX_CR_NEXT(kind, level)
#define PX_CR_KSTAMP(i) do { } while (0)
#define PX_CR_BEGIN() do { } while (0)
#define PX_CR_END() do { } while (0)
#endif

namespace px {

// The widest block K1, K3 and K9 take.
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

// The sum of a float32 dot product is kept in float64 (rounded once at the
// end), so that a float32 result stays within twice the plain float32
// version's error against float64 (chip_smoke.py's rule).
template <typename T> using acc_t = typename std::conditional<sizeof(T) == 4, double, T>::type;

template <typename T> __device__ __forceinline__ T rsqrt_(T x);
template <> __device__ __forceinline__ float rsqrt_<float>(float x) { return rsqrtf(x); }
template <> __device__ __forceinline__ double rsqrt_<double>(double x) { return rsqrt(x); }

constexpr unsigned kFull = 0xffffffffu;
// shuffles in flight in chol_inv_rows
constexpr int kSlotBatch = 8;

// cp.async: one element global -> shared, in flight until waited for
// (commit_group closes a group; wait_group<N> waits until at most N of the
// committed groups are in flight).
__device__ __forceinline__ void cp_async(float* d, const float* s) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(d)), "l"(s) : "memory");
}
__device__ __forceinline__ void cp_async(double* d, const double* s) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(d)), "l"(s) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Named barriers (0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// Cholesky inverse
// ---------------------------------------------------------------------------

// One pivot j of chol_inv_rows on a lane's row v (W slots): sl holds
// slot j on entry and slot j + 1 on return.
template <typename T, int W>
__device__ __forceinline__ void chol_pivot(T (&v)[W], T& sl, bool& ok, const int j,
                                           int lane) {
  const T piv = __shfl_sync(kFull, sl, j);
  ok = ok && piv > T(0);
  const T rinv = rsqrt_(piv);
  const T ll = lane > j ? sl * rinv : T(0);    // L(i, j), 0 at or above j
  T nl = 0;
#pragma unroll
  for (int c0 = 0; c0 < W; c0 += kSlotBatch) {
    // what this lane offers for slot c: X(j, c) if it owns row j, L(c, j)
    // if it owns row c; kSlotBatch shuffles in flight
    T got[kSlotBatch];
#pragma unroll
    for (int u = 0; u < kSlotBatch; ++u) {
      const int c = c0 + u;
      const bool isx = c <= j;
      const T xjc = c < j ? v[c] * rinv : rinv;
      got[u] = __shfl_sync(kFull, isx ? xjc : ll, isx ? j : c);
    }
    // row j takes X(j, c) for c <= j; the rows below update (their L(i, j)
    // is 0 above j, so the others keep their slots). Selects, no branch:
    // only lane j owns row j, so a branch here would diverge per slot.
    T bl = 0;
#pragma unroll
    for (int u = 0; u < kSlotBatch; ++u) {
      const int c = c0 + u;
      const T upd = c == j ? -ll * got[u] : v[c] - ll * got[u];
      v[c] = (lane == j) & (c <= j) ? got[u] : upd;
      bl = c == j + 1 ? v[c] : bl;
    }
    const bool here = c0 <= j + 1 && j + 1 < c0 + kSlotBatch;
    nl = here ? bl : nl;
  }
  sl = nl;
}

// Pivots of the Cholesky inverse of an n-wide block: n rounded up to a
// multiple of 4 up to 32 (one warp), of 8 past it (two warps).
__host__ __device__ constexpr int chol_width(int n) {
  return n <= 32 ? (n + 3) / 4 * 4 : (n + 7) / 8 * 8;
}

// The Cholesky inverse for n <= NC = chol_width(n) <= 32: Xi (row-major,
// stride ldx, zero above the diagonal) with A^{-1} = Xi^T Xi for the SPD
// n x n block A (its lower triangle, stride lda; global or shared memory),
// Jacobi-equilibrated (A(i, c) d_i^-1/2 d_c^-1/2, d = max(diag, tiny)) and
// all NaN when a pivot is not positive (or NaN). One warp, lane l owning
// row l in registers. Right-looking and in place: before pivot j, slot c
// of row i holds the inverse's partial row R(i, c) for c < j and the
// Schur-updated A(i, c) for c >= j. At pivot j one rsqrt gives
// 1 / L(j, j); row j becomes X(j, c) = R(j, c) / L(j, j), and one shuffle
// per slot c broadcasts X(j, c) (c <= j, from lane j) or L(c, j) (c > j,
// from lane c), with which every row i below j updates slot c:
// R(i, c) -= L(i, j) X(j, c), A(i, c) -= L(i, j) L(c, j). No shared memory
// is written until Xi and no barrier is needed. The NC pivots are
// unrolled, so every select on j folds away and a slot is a shuffle and a
// multiply-add (2-4x fewer cycles than a loop over the pivots, measured);
// rows n..NC-1 are the identity's, whose pivots are 1 and whose L(i, j)
// are 0 for j < n, so the leading n x n block of Xi comes out as for n
// pivots.
template <typename T, int NC>
__device__ __noinline__ void chol_inv_rows(const T* A, int lda, T* X, int ldx, int n,
                                           int lane) {
  constexpr int W = (NC + kSlotBatch - 1) / kSlotBatch * kSlotBatch;  // slots
  const bool live = lane < n, pad = !live && lane < NC;
  T v[W];
  const T tiny = diag_tiny<T>();
  const T dl = live ? rsqrt_(nan_max(A[lane * lda + lane], tiny)) : T(pad);
#pragma unroll
  for (int c = 0; c < W; ++c)
    v[c] = live ? (c <= lane ? A[lane * lda + c] : T(0)) : T(pad && c == lane);
  // equilibrate: A(i, c) d_i^-1/2 d_c^-1/2
#pragma unroll
  for (int c = 0; c < W; ++c) v[c] *= dl * __shfl_sync(kFull, dl, c);
  bool ok = true;
  T sl = v[0];                                 // slot j of the lane's row
#pragma unroll
  for (int j = 0; j < NC; ++j) chol_pivot<T, W>(v, sl, ok, j, lane);
  // Xi(i, c) = X(i, c) d_c^-1/2
  const T nan = quiet_nan<T>();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const T dc = __shfl_sync(kFull, dl, c);
    if (c < n && live) X[lane * ldx + c] = ok ? (c <= lane ? v[c] * dc : T(0)) : nan;
  }
}

// One pivot j of chol_inv_rows2 on the row v of r (W slots): e is this
// pivot's exchange buffer [2W]; sl holds slot j on entry, j + 1 on return.
template <typename T, int W>
__device__ __forceinline__ void chol_pivot2(T (&v)[W], T& sl, bool& ok, T* e, const int j,
                                            int r, int bar) {
  // publish column j of the Schur complement (each row below j its slot)
  // and row j's partial inverse R(j, c < j) (its owner)
  if (r >= j && r < W) e[r] = sl;
  if (r == j) {
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (c < j) e[W + c] = v[c];
  }
  bar_sync(bar, 64);
  const T piv = e[j];
  ok = ok && piv > T(0);
  const T rinv = rsqrt_(piv);
  const T ll = r > j ? sl * rinv : T(0);       // L(r, j), 0 at or above j
  T nl = 0;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    // X(j, c) for c <= j, L(c, j) for c > j
    const T b = c < j ? e[W + c] * rinv : (c == j ? rinv : e[c] * rinv);
    const T upd = c == j ? -ll * b : v[c] - ll * b;
    v[c] = (r == j) & (c <= j) ? b : upd;
    nl = c == j + 1 ? v[c] : nl;
  }
  sl = nl;
}

// The Cholesky inverse for 32 < n <= NC = chol_width(n) <= 64, on two
// warps (named barrier bar, 64 threads): the same Xi as chol_inv_rows,
// lane l of warp w owning row 32 w + l (one row, NC slots, in registers:
// two rows a lane spill at 48 in float64; rows n..NC-1 the identity's).
// The warps cannot shuffle to each other, so each pivot publishes column j
// and row j's partial inverse in shared memory (two buffers of 2 NC in E,
// after the scales D [NC]) and meets at one barrier; every lane then forms
// L(c, j) and X(j, c) itself with the pivot's rsqrt. A may be E (shared
// memory, rows read before E is written).
template <typename T, int NC>
__device__ __noinline__ void chol_inv_rows2(const T* A, int lda, T* X, int ldx, int n,
                                            int warp, int lane, T* E, int bar) {
  const int r = 32 * warp + lane;
  const bool live = r < n, pad = !live && r < NC;
  T v[NC];
  const T tiny = diag_tiny<T>();
  const T dr = live ? rsqrt_(nan_max(A[r * lda + r], tiny)) : T(pad);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    v[c] = live ? (c <= r ? A[r * lda + c] : T(0)) : T(pad && c == r);
  bar_sync(bar, 64);                           // E may overwrite A from here
  T* D = E;                                    // d_c^-1/2
  E += NC;                                     // two exchange buffers
  if (r < NC) D[r] = dr;
  bar_sync(bar, 64);
#pragma unroll
  for (int c = 0; c < NC; ++c) v[c] *= dr * D[c];
  bool ok = true;
  T sl = v[0];
#pragma unroll
  for (int j = 0; j < NC; ++j) chol_pivot2<T, NC>(v, sl, ok, E + (j & 1) * 2 * NC, j, r, bar);
  const T nan = quiet_nan<T>();
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (c < n && live) X[r * ldx + c] = ok ? (c <= r ? v[c] * D[c] : T(0)) : nan;
}

// Xi of the n x n block A (n <= W), chol_width(n) pivots: warp 0 of the
// calling group up to 32 wide, warps 0 and 1 past it (meeting at named
// barrier bar; E holds 5 chol_width(n) elements of shared memory, and may
// be A itself when A is shared, as every n x n block past 32 wide is). Every warp of the
// group calls it; the others return at once.
template <typename T, int W, int NC = 4>
__device__ __forceinline__ void chol_inv(const T* A, int lda, T* X, int ldx, int n, int warp,
                                         int lane, T* E, int bar) {
  if constexpr (NC < W) {
    if (n > NC) {
      chol_inv<T, W, chol_width(NC + 1)>(A, lda, X, ldx, n, warp, lane, E, bar);
      return;
    }
  }
  if constexpr (NC > 32) {
    if (warp < 2) chol_inv_rows2<T, NC>(A, lda, X, ldx, n, warp, lane, E, bar);
  } else {
    if (warp == 0) chol_inv_rows<T, NC>(A, lda, X, ldx, n, lane);
  }
}

// The register class of an n-wide Cholesky inverse: the kernels that call
// chol_inv are built for W = 16, 32, 48 and 64, each reaching the pivot
// counts up to W, so that a launch holds the registers its widest block
// needs and no more.
__host__ __device__ constexpr int chol_class(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 48 ? 48 : 64;
}

// ---------------------------------------------------------------------------
// Small products by a group of threads
// ---------------------------------------------------------------------------

// The threads of a factor launch that work on one row (or knot, or
// partition): the thread block, or for blocks up to 16 wide one warp of
// it, four rows a block (a 13 x 13 product is a few thousand multiply-adds:
// a block a row leaves an SM waiting on loads at B = 256).
__host__ __device__ constexpr int rows_per_block(int m) { return m <= 16 ? 4 : 1; }

struct Group {
  int tid, nt, index;         // thread in the group, its threads, its row in the block
  __device__ explicit Group(int rows)
      : tid(threadIdx.x % (blockDim.x / rows)), nt(blockDim.x / rows),
        index(threadIdx.x / (blockDim.x / rows)) {}
  __device__ void sync() const {
    if (nt == 32) __syncwarp();
    else __syncthreads();
  }
};

constexpr int kTK = 64;          // deepest staged tile
constexpr int kRM = 5, kRN = 5;  // a thread's outputs: up to kRM rows by kRN columns
constexpr int kLoadBatch = 8;    // loads in flight a thread and operand while staging
constexpr int kCL = 16;          // lanes along a staged tile's contiguous index

__host__ __device__ constexpr int min_(int a, int b) { return a < b ? a : b; }

// Columns of threads across an output tile: 16, or 8 in a warp group.
__host__ __device__ constexpr int tile_tx(int nt) { return nt >= 64 ? 16 : 8; }

// Shared memory of block_gemm for M x K by K x N on nt threads (kWhole:
// gemm_smem_whole), in elements of T.
__host__ __device__ constexpr int gemm_smem(int M, int N, int K, int nt) {
  return min_(K, kTK) * (min_(M, nt / tile_tx(nt) * kRM) + 1 +
                         min_(N, tile_tx(nt) * kRN) + 1);
}
__host__ __device__ constexpr int gemm_smem_whole(int M, int N, int K) {
  return K * (M + 1 + N + 1);
}

// One operand tile being staged: F(r, e) for r in [r0, r0 + tr), e in
// [e0, e0 + tk) into S[e * ld + r]. kE: F's contiguous index is e. Lanes
// of 16 run along the contiguous index and the others step the other
// index, so that a thread walks its elements with no division.
template <typename T, bool kE, class F>
struct TileLoad {
  T* S;
  int ld;
  const F& f;
  int r0, e0, nc, no;          // extents along the contiguous and the other index
  int c, o;                    // this thread's next element
  int cl, ostep;
  __device__ TileLoad(T* S_, int ld_, const F& f_, int r0_, int tr, int e0_, int tk,
                      const Group& g)
      : S(S_), ld(ld_), f(f_), r0(r0_), e0(e0_), nc(kE ? tk : tr), no(kE ? tr : tk),
        c(g.tid % kCL), o(g.tid / kCL), cl(g.tid % kCL), ostep(g.nt / kCL) {
    if (cl >= nc) o = no;      // no element for this thread
  }
  __device__ bool more() const { return o < no; }
  __device__ void step(int& cc, int& oo) const {
    cc += kCL;
    if (cc >= nc) { cc = cl; oo += ostep; }
  }
  // load the next kLoadBatch elements into v
  __device__ void load(T (&v)[kLoadBatch]) const {
    int cc = c, oo = o;
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      v[u] = oo < no ? (kE ? f(r0 + oo, e0 + cc) : f(r0 + cc, e0 + oo)) : T(0);
      step(cc, oo);
    }
  }
  // store them and move on
  __device__ void store(const T (&v)[kLoadBatch]) {
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      if (o < no) S[kE ? c * ld + o : o * ld + c] = v[u];
      step(c, o);
    }
  }
};

// Stage both operand tiles, each thread's loads of both in flight before
// any store (one round trip to device memory a batch).
template <typename T, class LA, class LB>
__device__ __forceinline__ void stage_pair(LA& la, LB& lb) {
  while (la.more() || lb.more()) {
    T va[kLoadBatch], vb[kLoadBatch];
    la.load(va);
    lb.load(vb);
    la.store(va);
    lb.store(vb);
  }
}

// For every i < M, j < N: epi(i, j, sum_{e < K} A(i, e) B(e, j)), the sum
// taken in the order e = 0, 1, ..., K - 1, as a plain loop takes it (so
// the result equals such a loop's, rounding included). A and B are
// functors of (i, e) and (e, j) reading global or shared memory; kAe says
// that A's contiguous index is e (else i), kBj that B's is j (else e).
// Tiles of up to 64 deep of both are staged in shared memory sm
// (gemm_smem(M, N, K, g.nt) elements) with neighbouring threads on
// neighbouring addresses and both operands' loads in flight together.
// Thread (ty, tx) of the group's TX-wide grid (TX = tile_tx) sums the
// outputs (ty + TY p, tx + TX q), p, q < 5, of an output tile of
// 5 TY x 5 TX (a 40 x 80 product is one tile of a block of 128): per step
// of e, five loads of A and five of B feed 25 multiply-adds (in float64
// for float32 operands), and the
// lanes with one ty read one A entry and TX neighbouring B entries (no
// bank conflict). Called by every thread of the group; epi runs after the
// group's last barrier, on the thread that summed the entry (two products
// of the same M and N give an entry to the same thread).
//
// kWhole (M, N, K <= 64; the narrow kernels): both operands whole in shared
// memory (gemm_smem_whole elements), then each thread sums its outputs one
// at a time, which holds a few registers where the tiles hold 25 sums.
template <typename T, bool kAe, bool kBj, bool kWhole = false, class FA, class FB, class Epi>
__device__ void block_gemm(int M, int N, int K, const FA& A, const FB& B, const Epi& epi,
                           T* sm, const Group& g) {
  const auto Bt = [&](int j, int e) { return B(e, j); };
  if constexpr (kWhole) {
    const int lda = M + 1, ldb = N + 1;
    T* As = sm;
    T* Bs = sm + K * lda;
    TileLoad<T, kAe, FA> la(As, lda, A, 0, M, 0, K, g);
    TileLoad<T, !kBj, decltype(Bt)> lb(Bs, ldb, Bt, 0, N, 0, K, g);
    stage_pair<T>(la, lb);
    g.sync();
    for (int o = g.tid; o < M * N; o += g.nt) {
      const int i = o / N, j = o - i * N;
      T acc = 0;
      for (int e = 0; e < K; ++e) acc += As[e * lda + i] * Bs[e * ldb + j];
      epi(i, j, acc);
    }
    g.sync();
    return;
  }
  // float32 products are summed in float64 (each entry rounded once at
  // the end): with float32 sums the float32 factor at 24 wide read 2.2x
  // the plain float32 version's error against float64
  using Acc = acc_t<T>;
  const int TX = tile_tx(g.nt), TY = g.nt / TX;
  const int tx = g.tid % TX, ty = g.tid / TX;
  const int TN = min_(N, TX * kRN), TM = min_(M, TY * kRM), TK = min_(K, kTK);
  const int lda = TM + 1, ldb = TN + 1;
  T* As = sm;
  T* Bs = sm + TK * lda;
  for (int i0 = 0; i0 < M; i0 += TM) {
    const int tm = min_(TM, M - i0);
    const int rm = ty < tm ? (tm - ty + TY - 1) / TY : 0;      // rows of this thread
    for (int j0 = 0; j0 < N; j0 += TN) {
      const int tn = min_(TN, N - j0);
      const int rn = tx < tn ? (tn - tx + TX - 1) / TX : 0;    // columns of this thread
      Acc acc[kRM][kRN];
#pragma unroll
      for (int p = 0; p < kRM; ++p)
#pragma unroll
        for (int q = 0; q < kRN; ++q) acc[p][q] = Acc(0);
      for (int e0 = 0; e0 < K; e0 += TK) {
        const int tk = min_(TK, K - e0);
        TileLoad<T, kAe, FA> la(As, lda, A, i0, tm, e0, tk, g);
        TileLoad<T, !kBj, decltype(Bt)> lb(Bs, ldb, Bt, j0, tn, e0, tk, g);
        stage_pair<T>(la, lb);
        g.sync();
        // rows and columns past the thread's read 0 and are not stored, so
        // every multiply-add is unconditional
#pragma unroll 4
        for (int e = 0; e < tk; ++e) {
          const T* a = As + e * lda + ty;
          const T* b = Bs + e * ldb + tx;
          Acc av[kRM], bv[kRN];
#pragma unroll
          for (int p = 0; p < kRM; ++p) av[p] = p < rm ? Acc(a[p * TY]) : Acc(0);
#pragma unroll
          for (int q = 0; q < kRN; ++q) bv[q] = q < rn ? Acc(b[q * TX]) : Acc(0);
#pragma unroll
          for (int p = 0; p < kRM; ++p)
#pragma unroll
            for (int q = 0; q < kRN; ++q) acc[p][q] += av[p] * bv[q];
        }
        g.sync();
      }
#pragma unroll
      for (int p = 0; p < kRM; ++p)
#pragma unroll
        for (int q = 0; q < kRN; ++q)
          if (p < rm && q < rn) epi(i0 + ty + p * TY, j0 + tx + q * TX, T(acc[p][q]));
    }
  }
}

// A row-major rows x cols block (src, or eye times the identity where src
// is null) into dst with row stride ld.
template <typename T>
__device__ __forceinline__ void stage_block(T* dst, int ld, const T* src, int rows, int cols,
                                            const Group& g, T eye = T(1)) {
  const auto f = [&](int c, int i) { return src ? src[i * cols + c] : (i == c ? eye : T(0)); };
  TileLoad<T, false, decltype(f)> l(dst, ld, f, 0, cols, 0, rows, g);
  while (l.more()) {
    T v[kLoadBatch];
    l.load(v);
    l.store(v);
  }
}

#ifdef PX_CR_TIMING
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// The launches of the last timed call: their kinds (kind + 256 level) and
// how many there were.
inline int g_kinds[1024];
inline int g_nst = 0;
// The stamps of the next launch, or null.
inline long long* next_stamps(long long* stamps, int kind, int level) {
  if (!stamps || g_nst >= 1024) return nullptr;
  g_kinds[g_nst] = kind + 256 * level;
  return stamps + 8 * g_nst++;
}
#endif

// Let kernel take bytes of dynamic shared memory (past 48 KB only with the
// attribute set).
template <class K> inline int smem_for(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// Threads of the factor's kernels that do not call chol_inv, and the most
// registers a thread of them may hold (so that an SM holds four blocks).
constexpr int kGemmThreads = 128;
constexpr int kGemmMinBlocks = 4;

// Blocks of a launch of n rows, rows_per_block(m) a block.
inline unsigned row_blocks(long long n, int m) {
  return (unsigned)((n + rows_per_block(m) - 1) / rows_per_block(m));
}

// ---------------------------------------------------------------------------
// The condensed dual system, a group a knot
// ---------------------------------------------------------------------------

// The narrow kernels (blocks up to 16 wide, four rows a block, products
// with kWhole, more blocks an SM).
__host__ __device__ constexpr bool narrow(int m, int dz = 0) { return m <= 16 && dz <= 64; }
constexpr int kNarrowMinBlocks = 8;

// Shared memory of condense_kernel's group, in elements of T: a partial
// D [m, m] and the product tiles.
__host__ __device__ inline int condense_smem(int m, int dz, int nt, bool whole) {
  return m * m + (whole ? gemm_smem_whole(2 * m, m > dz ? m : dz, dz)
                        : gemm_smem(2 * m, m > dz ? m : dz, dz, nt));
}

// The condensed KKT of knot k of problem b, the device form of
// piccolax.solver.kkt.condensed_factor's blocks: from the knot factors Xi
// [B, N, dz, dz] of K1 (Pinv = Xi^T Xi), C [B, N, m, dz], Rd [B, N, m] and
// Cn [B, N-1, m, dz], Y_k = C_k Xi_k^T, Yn_k = Cn_k Xi_{k+1}^T and
// Y_{k+1} (into the knot's Yw [3, m, dz] of device memory), then
// D_k = Y_k Y_k^T + Yn_k Yn_k^T + diag(Rd_k) and U_k = Yn_k Y_{k+1}^T
// (zero at k = N - 1) into D, U [B, N, m, m]. Knot k + 1's Y is formed
// again by its own group: a third more products and no second launch.
// The inputs are of type Ti, read into T (K3 forms a float32 problem's
// system in float64).
template <typename T, bool kNarrow, typename Ti = T>
__global__ void __launch_bounds__(kGemmThreads, kNarrow ? kNarrowMinBlocks : kGemmMinBlocks)
condense_kernel(const Ti* __restrict__ Xi_g, const Ti* __restrict__ C_g,
                const Ti* __restrict__ R_g, const Ti* __restrict__ Cn_g, T* __restrict__ D_g,
                T* __restrict__ U_g, T* __restrict__ Y_g, int B, int N, int m,
                int dz PX_CR_PARAM) {
  PX_SMEM(T);
  const Group g(rows_per_block(m));
  const long long j = (long long)blockIdx.x * rows_per_block(m) + g.index;  // b N + k
  if (j >= (long long)B * N) return;           // uniform in the group (a warp)
  const int b = (int)(j / N), k = (int)(j % N);
  const int mm = m * m, md = m * dz, dd = dz * dz;
  T* Dp = smem + g.index * condense_smem(m, dz, g.nt, kNarrow);   // Y Y^T
  T* sm = Dp + mm;
  const Ti* Xi = Xi_g + j * dd;
  const Ti* C = C_g + j * md;
  const Ti* Rd = R_g + j * m;
  const Ti* Cn = Cn_g + ((long long)b * (N - 1) + k) * md;
  T* Y = Y_g + j * 3 * md;
  T* Yn = Y + md;
  T* Y1 = Yn + md;
  T* D = D_g + j * mm;
  T* U = U_g + j * mm;
  const bool next = k < N - 1;
  PX_CR_BEGIN();
  // Y(a, c) = sum_e C(a, e) Xi(c, e)
  block_gemm<T, true, false, kNarrow>(
      m, dz, dz, [&](int a, int e) { return T(C[a * dz + e]); },
      [&](int e, int c) { return T(Xi[c * dz + e]); },
      [&](int a, int c, T v) { Y[a * dz + c] = v; }, sm, g);
  if (next)                                      // [Yn; Y1] = [Cn_k; C_{k+1}] Xi_{k+1}^T
    block_gemm<T, true, false, kNarrow>(
        2 * m, dz, dz,
        [&](int a, int e) { return T(a < m ? Cn[a * dz + e] : C[md + (a - m) * dz + e]); },
        [&](int e, int c) { return T(Xi[dd + c * dz + e]); },
        [&](int a, int c, T v) { Yn[a * dz + c] = v; }, sm, g);   // Y1 follows Yn
  g.sync();                                      // Y, Yn, Y1 written
  PX_CR_KSTAMP(3);
  // D(a, c) = sum_e Y(a, e) Y(c, e) [+ sum_e Yn(a, e) Yn(c, e)] + Rd(a) [a == c]
  auto gram = [&](const T* P, const T* Q, auto epi) {
    block_gemm<T, true, false, kNarrow>(
        m, m, dz, [&](int a, int e) { return P[a * dz + e]; },
        [&](int e, int c) { return Q[c * dz + e]; }, epi, sm, g);
  };
  if (next) {
    gram(Y, Y, [&](int a, int c, T v) { Dp[a * m + c] = v; });
    gram(Yn, Yn, [&](int a, int c, T v) {
      const T dv = Dp[a * m + c] + v;
      D[a * m + c] = a == c ? dv + T(Rd[a]) : dv;
    });
    PX_CR_KSTAMP(4);
    gram(Yn, Y1, [&](int a, int c, T v) { U[a * m + c] = v; });
  } else {
    gram(Y, Y, [&](int a, int c, T v) { D[a * m + c] = a == c ? v + T(Rd[a]) : v; });
    for (int idx = g.tid; idx < mm; idx += g.nt) U[idx] = T(0);
    PX_CR_KSTAMP(4);
  }
  PX_CR_END();
}

// ---------------------------------------------------------------------------
// Cyclic-reduction factor of S systems, a launch per half level
// ---------------------------------------------------------------------------

// Knots of a batch of block-tridiagonal systems in device memory: knot j
// of problem b has its diagonal block at D + b sbD + j m^2 and its upper
// coupling at U + b sbU + j m^2 (none at j >= nU_knots).
template <typename T> struct Knots {
  const T* D;
  const T* U;
  long long sbD, sbU;
  int nU_knots;
  __device__ const T* d(int b, long long j, int mm) const { return D + b * sbD + j * mm; }
  // null for a zero block
  __device__ const T* u(int b, long long j, int mm) const {
    return j < nU_knots ? U + b * sbU + j * mm : nullptr;
  }
};

// The rows of one CR level of S systems: row i of system s = b P + p is
// knot p L + first + i of problem b, its diagonal block the identity's at
// i >= nD and its coupling zero at i >= nU (the padding of a system to a
// power of two rows).
template <typename T> struct Rows {
  Knots<T> k;
  int P, L, first, nD, nU;
  // row i's diagonal block, null for the identity
  __device__ const T* d(int s, int i, int m) const {
    if (i >= nD) return nullptr;
    const int b = s / P, p = s - b * P;
    return k.d(b, (long long)p * L + first + i, m * m);
  }
  // row i's coupling, null for a zero block
  __device__ const T* u(int s, int i, int m) const {
    if (i >= nU) return nullptr;
    const int b = s / P, p = s - b * P;
    return k.u(b, (long long)p * L + first + i, m * m);
  }
};

// Threads of the kernels that call chol_inv: four one-warp rows up to 16
// wide; one row past it, on two warps up to 32 wide (one factors while
// the other waits), four past it.
__host__ __device__ constexpr int chol_threads(int W) { return W == 32 ? 64 : 128; }
// Registers a thread of them may hold: 128 up to 16 wide, and what the
// rows of the wider classes take without spilling (ptxas -v: a float64
// row of 32 slots spills at 128, float32 rows past 32 at 128).
__host__ __device__ constexpr int chol_regs(int W, size_t es) {
  return W <= 16 ? 128 : W <= 32 ? (es == 8 ? 168 : 128) : 255;
}
// The blocks an SM must hold of threads threads each to that end (the
// __launch_bounds__ that caps the registers).
__host__ __device__ constexpr int chol_min_blocks(int W, size_t es, int threads) {
  return 65536 / (threads * chol_regs(W, es));
}

// Shared memory of cr_elim_kernel's group, in elements of T: the staged
// block (then the Cholesky scratch), Xi, Ul, Ur and the product tiles.
__host__ __device__ inline int elim_smem(int m, int nt) {
  return 2 * m * (m | 1) + 2 * m * m +
         (narrow(m) ? gemm_smem_whole(m, 2 * m, m) : gemm_smem(m, 2 * m, m, nt));
}

// Elimination of odd row 2j + 1 of level (a group a row and system,
// row s half + j): Xi = chol_inv(D_{2j+1}), Ul = U_{2j}, Ur = U_{2j+1}
// into slot off + j of the system's cr planes 0, 1, 2 (cr + s crs, of
// type To: K3 rounds a float32 problem's factor there once), then
// [Gl_j | Gr_j] = Xi [Ul^T | Ur] into [S, half, m, m] each. root: the last
// level's one row, chol_inv(D_0) into slot off with zero couplings. A
// non-PD block gives an all-NaN Xi.
template <typename T, int W, typename To = T>
__global__ void __launch_bounds__(chol_threads(W), chol_min_blocks(W, sizeof(T), chol_threads(W)))
cr_elim_kernel(Rows<T> in, To* __restrict__ cr, long long crs, int S, int Np, int off,
               int half, int m, int root, T* __restrict__ Gl, T* __restrict__ Gr PX_CR_PARAM) {
  PX_SMEM(T);
  const Group g(rows_per_block(m));
  const long long row = (long long)blockIdx.x * rows_per_block(m) + g.index;
  if (row >= (long long)S * half) return;      // uniform in the group (a warp)
  const int s = (int)(row / half), j = (int)(row % half);
  const int mm = m * m, ld = m | 1;
  T* A = smem + g.index * elim_smem(m, g.nt);  // the staged block, then chol scratch
  T* X = A + m * ld;                           // Xi
  T* Ul = X + m * ld;                          // U_{2j}, U_{2j+1}
  T* Ur = Ul + mm;
  T* tiles = Ur + mm;
  PX_CR_BEGIN();
  stage_block(A, ld, in.d(s, root ? 0 : 2 * j + 1, m), m, m, g);
  // zero blocks past the system's rows
  stage_block(Ul, m, root ? nullptr : in.u(s, 2 * j, m), m, m, g, T(0));
  stage_block(Ur, m, root ? nullptr : in.u(s, 2 * j + 1, m), m, m, g, T(0));
  g.sync();
  chol_inv<T, W>(A, ld, X, ld, m, g.tid / 32, g.tid % 32, A, 1);
  g.sync();
  PX_CR_KSTAMP(3);
  To* Xcr = cr + s * crs + (long long)(off + j) * mm;
  To* Lcr = Xcr + (long long)Np * mm;
  To* Rcr = Lcr + (long long)Np * mm;
  for (int idx = g.tid; idx < mm; idx += g.nt) {
    const int a = idx / m;
    Xcr[idx] = To(X[a * ld + idx - a * m]);
    Lcr[idx] = To(Ul[idx]);
    Rcr[idx] = To(Ur[idx]);
  }
  PX_CR_KSTAMP(4);
  if (!root) {
    T* gl = Gl + row * mm;
    T* gr = Gr + row * mm;
    // Gl(a, c) = sum_e Xi(a, e) Ul(c, e), Gr(a, c) = sum_e Xi(a, e) Ur(e, c)
    block_gemm<T, true, true, W == 16>(
        m, 2 * m, m, [&](int a, int e) { return X[a * ld + e]; },
        [&](int e, int c) { return c < m ? Ul[c * m + e] : Ur[e * m + c - m]; },
        [&](int a, int c, T v) {
          if (c < m) gl[a * m + c] = v;
          else gr[a * m + c - m] = v;
        }, tiles, g);
  }
  PX_CR_END();
}

// Shared memory of cr_update_kernel's group, in elements of T.
__host__ __device__ inline int update_smem(int m, int nt) {
  return m * m + (narrow(m) ? gemm_smem_whole(m, 2 * m, m) : gemm_smem(m, 2 * m, m, nt));
}

// The even rows' update of a level (a group a row and system):
// Dn_j = D_{2j} - Gr_{j-1}^T Gr_{j-1} - Gl_j^T Gl_j, Un_j = -Gl_j^T Gr_j
// into [S, half, m, m], the next level's rows.
template <typename T, bool kNarrow>
__global__ void __launch_bounds__(kGemmThreads, kNarrow ? kNarrowMinBlocks : kGemmMinBlocks)
cr_update_kernel(Rows<T> in, const T* __restrict__ Gl, const T* __restrict__ Gr,
                 T* __restrict__ Dn, T* __restrict__ Un, int S, int half, int m PX_CR_PARAM) {
  PX_SMEM(T);
  const Group g(rows_per_block(m));
  const long long row = (long long)blockIdx.x * rows_per_block(m) + g.index;
  if (row >= (long long)S * half) return;      // uniform in the group (a warp)
  const int s = (int)(row / half), j = (int)(row % half);
  const int mm = m * m;
  T* Dp = smem + g.index * update_smem(m, g.nt);   // D_{2j} - Gr^T Gr
  T* sm = Dp + mm;
  const T* gl = Gl + row * mm;
  const T* gr = Gr + row * mm;
  T* dn = Dn + row * mm;
  T* un = Un + row * mm;
  PX_CR_BEGIN();
  // G^T H: (a, c) = sum_e G(e, a) H(e, c)
  auto tprod = [&](const T* G, const T* H, auto epi) {
    block_gemm<T, false, true, kNarrow>(
        m, m, m, [&](int a, int e) { return G[e * m + a]; },
        [&](int e, int c) { return H[e * m + c]; }, epi, sm, g);
  };
  stage_block(Dp, m, in.d(s, 2 * j, m), m, m, g);
  g.sync();
  if (j > 0) tprod(gr - mm, gr - mm, [&](int a, int c, T v) { Dp[a * m + c] -= v; });
  PX_CR_KSTAMP(3);
  // Gl^T [Gl | Gr]: Dn = Dp - Gl^T Gl, Un = -Gl^T Gr
  block_gemm<T, false, true, kNarrow>(
      m, 2 * m, m, [&](int a, int e) { return gl[e * m + a]; },
      [&](int e, int c) { return c < m ? gl[e * m + c] : gr[e * m + c - m]; },
      [&](int a, int c, T v) {
        if (c < m) dn[a * m + c] = Dp[a * m + c] - v;
        else un[a * m + c - m] = -v;
      }, sm, g);
  PX_CR_KSTAMP(4);
  PX_CR_END();
}

template <typename T, int W, typename To>
int launch_elim(const Rows<T>& in, To* cr, long long crs, int S, int Np, int off, int half,
                int m, int root, T* Gl, T* Gr, cudaStream_t st PX_CR_PARAM) {
  const int rows = rows_per_block(m), nt = chol_threads(W);
  const size_t smem = sizeof(T) * rows * elim_smem(m, nt / rows);
  if (int e = smem_for(cr_elim_kernel<T, W, To>, smem)) return e;
  cr_elim_kernel<T, W, To><<<row_blocks((long long)S * half, m), nt, smem, st>>>(
      in, cr, crs, S, Np, off, half, m, root, Gl, Gr PX_CR_ARG(stamps));
  return (int)cudaGetLastError();
}

// Workspace of launch_cr_factor, in elements of T: Gl, Gr and two
// generations of (D, U), each [S, Np / 2, m, m].
__host__ __device__ inline long long cr_factor_ws(long long S, int Np, int m) {
  return 6LL * S * (Np > 1 ? Np / 2 : 1) * m * m;
}

// The packed factor cr [3, Np, m, m] of each of S systems (cr + s crs) whose
// level-0 rows are in0, Np a power of two: level l (n = Np >> l rows,
// n/2 odd rows eliminated) stores Xi, Ul, Ur of its odd rows at slots
// off_l .. off_l + n/2 - 1, off_l = Np - n; slot Np - 1 of the Xi plane
// holds the root factor. Per level one elimination launch and one update
// launch, each a group per row and system (the rows of a level are
// independent), then one root launch: 2 log2(Np) + 1 launches, which
// spread a single system's level over as many SMs as it has rows. The
// levels run in T and the factor is stored as To.
template <typename T, typename To = T>
int launch_cr_factor(const Rows<T>& in0, int S, int Np, int m, To* cr, long long crs, T* ws,
                     cudaStream_t st PX_CR_PARAM) {
  const long long blk = (long long)S * (Np > 1 ? Np / 2 : 1) * m * m;
  T* Gl = ws;
  T* Gr = Gl + blk;
  T* DU[2][2] = {{Gr + blk, Gr + 2 * blk}, {Gr + 3 * blk, Gr + 4 * blk}};
  const int W = chol_class(m);
  auto elim = [&](const Rows<T>& in, int off, int half, int root, int lvl) {
    switch (W) {
      case 16: return launch_elim<T, 16, To>(in, cr, crs, S, Np, off, half, m, root, Gl, Gr, st
                                         PX_CR_NEXT(root ? 3 : 1, lvl));
      case 32: return launch_elim<T, 32, To>(in, cr, crs, S, Np, off, half, m, root, Gl, Gr, st
                                         PX_CR_NEXT(root ? 3 : 1, lvl));
      case 48: return launch_elim<T, 48, To>(in, cr, crs, S, Np, off, half, m, root, Gl, Gr, st
                                         PX_CR_NEXT(root ? 3 : 1, lvl));
      default: return launch_elim<T, 64, To>(in, cr, crs, S, Np, off, half, m, root, Gl, Gr, st
                                         PX_CR_NEXT(root ? 3 : 1, lvl));
    }
  };
  const int rows = rows_per_block(m);
  const size_t gsmem = sizeof(T) * rows * update_smem(m, kGemmThreads / rows);
  auto update = narrow(m) ? cr_update_kernel<T, true> : cr_update_kernel<T, false>;
  if (int e = smem_for(update, gsmem)) return e;
  Rows<T> cur = in0;
  int off = 0, lvl = 0;
  for (int n = Np; n > 1; n /= 2, ++lvl) {
    const int half = n / 2;
    int rc = elim(cur, off, half, 0, lvl);
    if (rc) return rc;
    T* Dn = DU[lvl & 1][0];
    T* Un = DU[lvl & 1][1];
    update<<<row_blocks((long long)S * half, m), kGemmThreads, gsmem, st>>>(
        cur, Gl, Gr, Dn, Un, S, half, m PX_CR_NEXT(2, lvl));
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    cur = Rows<T>{Knots<T>{Dn, Un, (long long)half * m * m, (long long)half * m * m, 1 << 30},
                  1, 0, 0, half, half};
    off += half;
  }
  return elim(cur, Np - 1, 1, 1, lvl);
}

// D, U [B, N, m, m] of the condensed dual system (condense_kernel) from
// inputs of type Ti, with the workspace Y [B, N, 3, m, dz].
template <typename T, typename Ti = T>
int launch_condense(const Ti* Xi, const Ti* C, const Ti* R, const Ti* Cn, T* D, T* U, T* Y,
                    int B, int N, int m, int dz, cudaStream_t st PX_CR_PARAM) {
  const int rows = rows_per_block(m);
  const bool nw = narrow(m, dz);
  const size_t smem = sizeof(T) * rows * condense_smem(m, dz, kGemmThreads / rows, nw);
  auto kernel = nw ? condense_kernel<T, true, Ti> : condense_kernel<T, false, Ti>;
  if (int e = smem_for(kernel, smem)) return e;
  kernel<<<row_blocks((long long)B * N, m), kGemmThreads, smem, st>>>(
      Xi, C, R, Cn, D, U, Y, B, N, m, dz PX_CR_NEXT(0, 0));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// One system's CR solve in one thread block
// ---------------------------------------------------------------------------

// x = S^{-1} b with the packed factor cr [3, Np, m, m] of launch_cr_factor:
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
      acc_t<T> acc = 0;
      for (int e = 0; e < m; ++e) acc += acc_t<T>(Xl[j * mm + a * m + e]) * cur[(2 * j + 1) * mr + e * r + s];
      q2[idx] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < half * mr; idx += nt) {
      const int j = idx / mr, a = (idx / r) % m, s = idx % r;
      acc_t<T> acc = 0;
      for (int e = 0; e < m; ++e) acc += acc_t<T>(Xl[j * mm + e * m + a]) * q2[j * mr + e * r + s];
      tl[idx] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < half * mr; idx += nt) {
      const int j = idx / mr, a = (idx / r) % m, s = idx % r;
      T v = cur[(2 * j) * mr + a * r + s];
      if (j > 0) {
        acc_t<T> a1 = 0;
        for (int e = 0; e < m; ++e) a1 += acc_t<T>(Ur[(j - 1) * mm + e * m + a]) * tl[(j - 1) * mr + e * r + s];
        v -= a1;
      }
      acc_t<T> a2 = 0;
      for (int e = 0; e < m; ++e) a2 += acc_t<T>(Ul[j * mm + a * m + e]) * tl[j * mr + e * r + s];
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
    acc_t<T> acc = 0;
    for (int e = 0; e < m; ++e) acc += acc_t<T>(XR[a * m + e]) * cur[e * r + s];
    q2[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < mr; idx += nt) {
    const int a = idx / r, s = idx % r;
    acc_t<T> acc = 0;
    for (int e = 0; e < m; ++e) acc += acc_t<T>(XR[e * m + a]) * q2[e * r + s];
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
      acc_t<T> a1 = 0, a2 = 0;
      for (int e = 0; e < m; ++e) {
        a1 += acc_t<T>(Ul[j * mm + e * m + a]) * x[j * mr + e * r + s];
        if (j + 1 < half) a2 += acc_t<T>(Ur[j * mm + a * m + e]) * x[(j + 1) * mr + e * r + s];
      }
      tl[idx] = (rodd[lo * mr + idx] - a1) - a2;
    }
    __syncthreads();
    for (int idx = tid; idx < half * mr; idx += nt) {
      const int j = idx / mr, a = (idx / r) % m, s = idx % r;
      acc_t<T> acc = 0;
      for (int e = 0; e < m; ++e) acc += acc_t<T>(Xl[j * mm + a * m + e]) * tl[j * mr + e * r + s];
      q2[idx] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < half * mr; idx += nt) {
      const int j = idx / mr, a = (idx / r) % m, s = idx % r;
      acc_t<T> acc = 0;
      for (int e = 0; e < m; ++e) acc += acc_t<T>(Xl[j * mm + e * m + a]) * q2[j * mr + e * r + s];
      y[(2 * j) * mr + a * r + s] = x[idx];
      y[(2 * j + 1) * mr + a * r + s] = acc;
    }
    __syncthreads();
    T* tmp = x; x = y; y = tmp;
  }
  return x;
}

// The dual right-hand side of a problem's N knots: t = Pinv r_z =
// Xi^T (Xi r_z), then b_k = C_k t_k - rc_k + Cn_k t_{k+1}. rhs [N, dz + m, r]
// (r_z over rc); q, t [N, dz, r] and b [N, m, r]. Called by every thread of
// the block; returns with b written and visible.
template <typename T>
__device__ void dual_rhs_knots(const T* Xi, const T* C, const T* Cn, const T* rhs,
                               int N, int m, int dz, int r, T* q, T* t, T* b) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int md = m * dz, dd = dz * dz, mr = m * r, dr = dz * r, mb = dz + m;
  for (int idx = tid; idx < N * dr; idx += nt) {
    const int kk = idx / dr, a = (idx / r) % dz, s = idx % r;
    const long long j = kk;
    acc_t<T> acc = 0;
    for (int e = 0; e < dz; ++e) acc += acc_t<T>(Xi[j * dd + a * dz + e]) * rhs[(j * mb + e) * r + s];
    q[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < N * dr; idx += nt) {
    const int kk = idx / dr, a = (idx / r) % dz, s = idx % r;
    const long long j = kk;
    acc_t<T> acc = 0;
    for (int e = 0; e < dz; ++e) acc += acc_t<T>(Xi[j * dd + e * dz + a]) * q[(kk * dz + e) * r + s];
    t[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < N * mr; idx += nt) {
    const int kk = idx / mr, a = (idx / r) % m, s = idx % r;
    const long long j = kk;
    acc_t<T> acc = 0;
    for (int e = 0; e < dz; ++e) acc += acc_t<T>(C[j * md + a * dz + e]) * t[(kk * dz + e) * r + s];
    T v = acc - rhs[(j * mb + dz + a) * r + s];
    if (j < N - 1) {
      acc_t<T> a2 = 0;
      for (int e = 0; e < dz; ++e) a2 += acc_t<T>(Cn[j * md + a * dz + e]) * t[((kk + 1) * dz + e) * r + s];
      v += a2;
    }
    b[idx] = v;
  }
  __syncthreads();
}

// The primal recovery of a problem's N knots from their multipliers lam
// [N, m, r]: w_k = r_z,k - C_k^T lam_k - Cn_{k-1}^T lam_{k-1},
// z_k = Xi_k^T Xi_k w_k; out [N, dz + m, r] gets z over lam; w, q
// [N, dz, r] are workspace. Called by every thread of the block.
template <typename T>
__device__ void primal_knots(const T* Xi, const T* C, const T* Cn, const T* rhs,
                             const T* lam, int N, int m, int dz, int r, T* w, T* q, T* out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int md = m * dz, dd = dz * dz, mr = m * r, dr = dz * r, mb = dz + m;
  for (int idx = tid; idx < N * dr; idx += nt) {
    const int kk = idx / dr, a = (idx / r) % dz, s = idx % r;
    const long long j = kk;
    acc_t<T> a1 = 0;
    for (int e = 0; e < m; ++e) a1 += acc_t<T>(C[j * md + e * dz + a]) * lam[(kk * m + e) * r + s];
    T v = rhs[(j * mb + a) * r + s] - a1;
    if (j > 0) {
      const T* lp = lam + (kk - 1) * mr;
      acc_t<T> a2 = 0;
      for (int e = 0; e < m; ++e) a2 += acc_t<T>(Cn[(j - 1) * md + e * dz + a]) * lp[e * r + s];
      v -= a2;
    }
    w[idx] = v;
  }
  __syncthreads();
  for (int idx = tid; idx < N * dr; idx += nt) {
    const int kk = idx / dr, a = (idx / r) % dz, s = idx % r;
    const long long j = kk;
    acc_t<T> acc = 0;
    for (int e = 0; e < dz; ++e) acc += acc_t<T>(Xi[j * dd + a * dz + e]) * w[(kk * dz + e) * r + s];
    q[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < N * mb * r; idx += nt) {
    const int kk = idx / (mb * r), row = (idx / r) % mb, s = idx % r;
    const long long j = kk;
    T v;
    if (row < dz) {
      acc_t<T> acc = 0;
      for (int e = 0; e < dz; ++e) acc += acc_t<T>(Xi[j * dd + e * dz + row]) * q[(kk * dz + e) * r + s];
      v = acc;
    } else {
      v = lam[(kk * m + row - dz) * r + s];
    }
    out[idx] = v;
  }
}

// Workspace of cr_solve_block, in elements of T.
__host__ __device__ inline long long cr_solve_ws_elems(int Np, int m, int r) {
  return 3LL * Np * m * r + 2LL * (Np / 2) * m * r;
}

}  // namespace px
