// The cluster solve engine of K3's and K9's condensed solves: a CR solve of
// one system (and column of its right-hand side) on a thread-block cluster,
// with the condensed KKT's knot phases around it.
//
// A launch runs every cluster of its grid through one list of phases, each
// ended by a cluster barrier:
//   dual     b_k = C_k t_k - rc_k + Cn_k t_{k+1}, t_k = Xi_k^T Xi_k rz_k,
//            over the cluster's knots (K9: the standalone block-tridiagonal
//            system takes b_k = rhs_k);
//   down l   for each pair j of level l (rows 2j, 2j+1 of n_l = Np >> l):
//            tl_j = X_j^T X_j c_{2j+1},
//            c'_j = c_{2j} - Ur_{j-1}^T tl_{j-1} - Ul_j tl_j;
//   root     x = X^T X c;
//   up l     t_j = c_{2j+1} - Ul_j^T x_j - Ur_j x_{j+1},
//            y_{2j+1} = X_j^T X_j t_j, y_{2j} = x_j;
//   rf/rl    (K9) the partition's interface rows r_f = b_f - U_f x_1,
//            r_l = b_l - U_l^T x_k into the interface system's level 0;
//   x_int    (K9) the partition's multipliers: x_f, x_l of the interface
//            solution and x_int = r_sol - S_f x_f - S_l x_l between them
//            (r_sol the interior's CR solution, S the SPIKE columns);
//   primal   w_k = rz_k - C_k^T lam_k - Cn_{k-1}^T lam_{k-1},
//            z_k = Xi_k^T Xi_k w_k.
// K3 (cr_solve.cu) runs dual, the CR levels and primal on a cluster a
// problem. K9 (knot.cu) runs three launches: (c1) dual, the interior's CR
// levels and rf/rl on a cluster a partition; (c2) the interface system's
// CR levels on a cluster a problem; (c3) x_int and primal on a cluster a
// partition.
//
// Its least time is bytes': a solve reads every knot block and factor block
// twice (~37 MB at the CNOT in float64) for two multiply-adds a pair of
// entries; its phases depend on each other only through vectors of m
// entries. Measured on the earlier design (one thread block a system running
// every phase, each lane a row of strided global loads;
// scripts/cr_phase_timing.py --solve and --knot-solve): each level cost its
// work on one SM, ~15 bytes a cycle. So here:
// - a block of the cluster owns an even share of the knots in the dual and
//   primal phases, and a contiguous range of a level's pairs (or one pair
//   where the level has fewer pairs than blocks); the pair before the
//   range's first is recomputed (its tl) rather than waited for, and so is
//   the multiplier before a primal chunk's first knot;
// - the level vectors live in a workspace [2, 2 Np - 1, m] a column (V: the
//   reduction's levels, Y: the back-substitution's) in L2, read past L1
//   (__ldcg) after the cluster barrier's release and acquire, and kept in
//   shared memory in the sums' type (float64 for float32);
// - every factor and knot block a phase needs is staged into shared memory
//   by cp.async (8 or 4 bytes a copy, a chunk's copies all in flight) at an
//   odd row stride (m | 1, dz | 1, 2m | 1), so that the mat-vecs read rows
//   and columns without bank conflicts: G lanes an output entry (up to 8,
//   where a phase has fewer entries than the block has threads), four
//   partial sums a lane, float32 summed in float64 (acc_t);
// - a chunk's blocks are staged once the chunk before is computed, the next
//   phase's first before the cluster barrier (the blocks are inputs; only
//   the vectors wait for it); a phase whose blocks do not fit the shared
//   memory runs in chunks of items.
// What bounds it (stamps and a probe, scripts/cr_phase_timing.py --solve):
// each phase is three dependent mat-vec steps of ~1,300-1,800 cycles, each a
// chain of dependent float64 adds, plus the vectors' trip through L2 and the
// cluster barrier: ~10k cycles a level at the CNOT.
#pragma once

#include <mutex>

#include "common.cuh"

namespace px {

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// Every block of the cluster (or the thread block, S = 1): the writes
// before it, global ones included, are seen by the reads after it.
__device__ __forceinline__ void cluster_barrier(int S) {
  if (S > 1)
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  else
    __syncthreads();
}

// the dynamic shared memory, named here so that pointers into it keep the
// shared address space through the Solve members (ld.shared, not generic)
extern __shared__ __align__(16) unsigned char px_solve_smem[];

constexpr int kSolveThreads = 256;
constexpr int kMaxG = 8;       // lanes an output entry at most
// stamp slots of a launch (PX_CR_TIMING): [0] clock64() at block 0's
// start, [1 + q] after phase q's barrier, [62] and [63] %globaltimer at its
// start and end, [kSubStamps + 4 q + s] within phase q's first chunk
constexpr int kSubStamps = 64;

__host__ __device__ constexpr int odd_ld(int n) { return n | 1; }

// rows x cols elements, contiguous at src, into dst at row stride ld
template <typename T>
__device__ void stage(T* dst, int ld, const T* __restrict__ src, int rows, int cols) {
  const int nt = blockDim.x, dq = nt / cols, dr = nt - dq * cols;
  int i = threadIdx.x / cols, j = threadIdx.x - i * cols;
  for (long long idx = threadIdx.x; idx < (long long)rows * cols; idx += nt) {
    cp_async(dst + i * ld + j, src + idx);
    i += dq;
    j += dr;
    if (j >= cols) { j -= cols; ++i; }
  }
}

// count elements of src, written in this launch by blocks of the cluster
// (or by an earlier launch), into dst (the sums' type) past L1; four loads
// in flight a thread
template <typename D, typename T>
__device__ void load_cg(D* dst, const T* src, int count) {
  const int nt = blockDim.x;
  for (int base = threadIdx.x; base < count; base += 4 * nt) {
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = base + u * nt < count ? __ldcg(src + base + u * nt) : T(0);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (base + u * nt < count) dst[base + u * nt] = D(v[u]);
  }
}

// sum_{e = g, g + G, ... < E} op(M)[a][e] x[e], four partial sums (a
// dependent float64 add is a step's cost: a 40-term dot on one thread
// measured ~1,000 cycles; eight sums measured slower, by registers),
// walking pointers (op(M)[a][e] = M[a ld + e], or M[e ld + a] for kT)
template <typename T, bool kT>
__device__ __forceinline__ acc_t<T> dot(const T* M, int ld, int a, int g, int G, int E,
                                        const acc_t<T>* x) {
  using A = acc_t<T>;
  const T* p = kT ? M + g * ld + a : M + a * ld + g;
  const int dp = kT ? G * ld : G;
  const A* xp = x + g;
  A p0 = 0, p1 = 0, p2 = 0, p3 = 0;
  int e = g;
  for (; e + 3 * G < E; e += 4 * G) {
    p0 += A(p[0]) * xp[0];
    p1 += A(p[dp]) * xp[G];
    p2 += A(p[2 * dp]) * xp[2 * G];
    p3 += A(p[3 * dp]) * xp[3 * G];
    p += 4 * dp;
    xp += 4 * G;
  }
  for (; e < E; e += G) {
    p0 += A(*p) * *xp;
    p += dp;
    xp += G;
  }
  return (p0 + p1) + (p2 + p3);
}

// A vector of each item in shared memory: item i's at p + i * stride.
template <typename A> struct Vecs {
  const A* p;
  int stride;
  __device__ const A* operator()(int i) const { return p + (long long)i * stride; }
};

// For items i < K and entries a < R: epi(i, a, s1, s2) with
// s1 = sum_{e < E} op1(M1_i)[a][e] x1_i[e] and s2 likewise for M2 where
// has2(i) (else 0); op(M)[a][e] = M[a ld + e] (kT false) or M[e ld + a]
// (kT true), M_i = M + i mstride. G lanes an entry; all threads of the
// block take part (no barrier inside).
template <typename T, bool kT1, bool kT2, class H2, class Epi>
__device__ void matvec2(int K, int R, int E, const T* M1, const T* M2, int mstride, int ld,
                        Vecs<acc_t<T>> x1, Vecs<acc_t<T>> x2, const H2& has2, const Epi& epi) {
  using A = acc_t<T>;
  const int nt = blockDim.x, U = K * R;
  int lg = 0;                          // G = 2^lg lanes an entry
  while ((1 << lg) < kMaxG && (2 << lg) * U <= nt) ++lg;
  const int G = 1 << lg, g = threadIdx.x & (G - 1), per = nt >> lg;
  for (int u0 = 0; u0 < U; u0 += per) {
    const int u = u0 + (threadIdx.x >> lg);
    A s1 = 0, s2 = 0;
    int i = 0, a = 0;
    if (u < U) {
      i = u / R;
      a = u - i * R;
      s1 = dot<T, kT1>(M1 + (long long)i * mstride, ld, a, g, G, E, x1(i));
      if (M2 && has2(i)) s2 = dot<T, kT2>(M2 + (long long)i * mstride, ld, a, g, G, E, x2(i));
    }
    for (int o = G / 2; o > 0; o /= 2) {
      s1 += __shfl_xor_sync(kFull, s1, o);
      if (M2) s2 += __shfl_xor_sync(kFull, s2, o);
    }
    if (u < U && g == 0) epi(i, a, s1, s2);
  }
}

template <typename T, bool kT, class Epi>
__device__ void matvec(int K, int R, int E, const T* M, int mstride, int ld, Vecs<acc_t<T>> x,
                       const Epi& epi) {
  matvec2<T, kT, false>(K, R, E, M, (const T*)nullptr, mstride, ld, x, x,
                        [](int) { return false; },
                        [&](int i, int a, acc_t<T> s, acc_t<T>) { epi(i, a, s); });
}

// The pairs [j0, j1) of a level with h pairs that block rk of S owns.
__device__ __forceinline__ void owned_pairs(int h, int S, int rk, int& j0, int& j1) {
  if (h >= S) {
    j0 = rk * (h / S);
    j1 = j0 + h / S;
  } else {
    const int st = S / h;
    j0 = rk % st ? 0 : rk / st;
    j1 = rk % st ? 0 : j0 + 1;
  }
}

// Bytes a chunk of K items of each phase takes (blocks staged, es bytes
// each; vectors, ea bytes each; 16 bytes of alignment a region); the
// largest K within a buffer is a phase's chunk (at least 1: the launch's
// budget holds one of every phase). dz = 0: the standalone system (no knot
// blocks).
struct SolveChunks {
  int m, dz, ldm, ldz, ldw, es, ea;
  static constexpr int kSlack = 10 * 16;
  __host__ __device__ long long down(int K) const {
    return (3LL * K + 1) * m * ldm * es + 4LL * (K + 1) * m * ea + kSlack;
  }
  __host__ __device__ long long up(int K) const {
    return 3LL * K * m * ldm * es + (5LL * K + 1) * m * ea + kSlack;
  }
  __host__ __device__ long long dual(int K) const {
    if (dz == 0) return kSlack;
    return ((K + 1LL) * dz * ldz + 2LL * K * m * ldz) * es + 3LL * (K + 1) * dz * ea + kSlack;
  }
  __host__ __device__ long long primal(int K) const {
    return ((2LL * K + 1) * m * ldz + (long long)K * dz * ldz) * es +
           ((K + 1LL) * m + 3LL * K * dz) * ea + kSlack;
  }
  __host__ __device__ long long spike(int K) const {
    return (long long)K * m * ldw * es + (K + 3LL) * m * ea + kSlack;
  }
  __host__ __device__ long long root() const {
    return (long long)m * ldm * es + 3LL * m * ea + kSlack;
  }
  __host__ __device__ long long ifrhs() const {
    return 2LL * m * ldm * es + 4LL * m * ea + kSlack;
  }
  __host__ __device__ long long least() const {
    const long long v[7] = {down(1), up(1), dual(1), primal(1), root(), ifrhs(), spike(1)};
    long long a = 0;
    for (long long x : v) a = a > x ? a : x;
    return a;
  }
};

enum PhaseKind { kNone = -1, kDual, kDown, kRoot, kUp, kPrimal, kIfRhs, kSpike };

// What a launch solves, the same for every cluster: cluster c (blockIdx.x /
// S) is partition p = c % P of problem b = c / P, its knots [p L, p L + L)
// of the problem's N; column blockIdx.y of the right-hand side (r columns).
template <typename T> struct SolveArgs {
  // knot blocks of problem 0: Xi [N, dz, dz], C [N, m, dz], Cn [N-1, m, dz]
  // (dz = 0: none, the standalone system); rhs, out [N, mb, r], mb = dz + m
  const T *Xi, *C, *Cn, *rhs;
  T* out;
  // the CR factor [3, Np, m, m] of cluster 0, its stride; null: no CR phases
  const T* cr;
  long long crs;
  // the level vectors V, Y [2 Np - 1, m] of cluster 0 and column 0 (and K9's
  // b_f, b_l [2, m] after them), their stride a cluster and column
  T* ws;
  long long wss;
  int N, Np, m, dz, r, S, P, L;
  int nrows;          // level 0's rows that hold the system (the rest zero)
  int head, tail;     // kDual, kSpike or kNone; kPrimal, kIfRhs or kNone
  // K9: (U_f, U_l) [B P, 2, m, m] (rf/rl), the SPIKE columns [B P, k, m, 2m]
  // (x_int); the interface system's level vectors of problem 0 and column 0
  // and their stride (rf/rl writes level 0, x_int reads its solution), its
  // padded rows. K9's workspace a cluster and column holds, after V and Y,
  // b_f, b_l [2, m] and the partition's multipliers [L + 1, m] (row 0: the
  // previous partition's last)
  const T *Ub, *spike;
  T* ifws;
  long long ifwss;
  int Npi;
};

// A chunk: items [c0, c1) of phase q.
struct Item {
  int q, c0, c1;
};

// One cluster's operands and the block's place in it. A chunk's blocks
// are staged in shared memory while the block waits on the barrier before
// its phase (or after the chunk before). kKnot: K9's launches (any head and
// tail, the partition's edges, the standalone system); else K3's, whose
// phases are fixed (dual, the CR levels, primal), so that its kernel holds
// none of K9's code.
template <typename T, bool kKnot> struct Solve {
  using A = acc_t<T>;
  const T *Xi, *C, *Cn, *Xcr, *Lcr, *Rcr, *rhs, *Ub, *Sp, *IfY;
  T *out, *V, *Y, *E, *IfV, *Lam;   // lam of knot kk at Lam + kk m
  int N, Np, m, dz, r, S, rk, L, ldm, ldz, ldw, mm, md, dd, mb, k0, k1, nq;
  int j0, kn, p, head, tail, ncr;   // cluster's first knot and knot count; ncr CR phases
  long long region;                 // bytes of shared memory
  SolveChunks ch;

  __device__ __forceinline__ PhaseKind kind(int q, int& l) const {
    if constexpr (!kKnot) {
      if (q == 0) return kDual;
      if (q <= L) { l = q - 1; return kDown; }
      if (q == L + 1) return kRoot;
      if (q <= 2 * L + 1) { l = 2 * L + 1 - q; return kUp; }
      return kPrimal;
    }
    if (head != kNone) {
      if (q == 0) return (PhaseKind)head;
      --q;
    }
    if (q < ncr) {
      if (q < L) { l = q; return kDown; }
      if (q == L) return kRoot;
      l = 2 * L - q;
      return kUp;
    }
    return (PhaseKind)tail;
  }
  // V_l / Y_l: level l's n_l rows
  __device__ long long lvl(int l) const { return (2LL * Np - 2 * (Np >> l)) * m; }
  __device__ long long need(PhaseKind k, int K) const {
    return k == kDual ? ch.dual(K) : k == kDown ? ch.down(K) : k == kUp ? ch.up(K)
         : k == kPrimal ? ch.primal(K) : k == kIfRhs ? ch.ifrhs()
         : k == kSpike ? ch.spike(K) : ch.root();
  }
  // the block's items [i0, i1) of phase q and its chunk size K
  __device__ void items(int q, int& i0, int& i1, int& K) const {
    int l = 0;
    const PhaseKind k = kind(q, l);
    if (k == kDual || k == kPrimal || k == kSpike) {
      i0 = k0;
      i1 = k1;
    } else if (k == kRoot || k == kIfRhs) {
      i0 = 0;
      i1 = rk == 0 ? 1 : 0;
    } else {
      owned_pairs((Np >> l) / 2, S, rk, i0, i1);
    }
    K = 1;
    while (K < i1 - i0 && need(k, K + 1) <= region) ++K;
  }
  // the first chunk of the first phase from q on with items for this block
  __device__ bool first_item(int q, Item& it) const {
    for (; q < nq; ++q) {
      int i0, i1, K;
      items(q, i0, i1, K);
      if (i0 < i1) {
        it = Item{q, i0, min(i0 + K, i1)};
        return true;
      }
    }
    return false;
  }
  __device__ bool next_item(const Item& cur, Item& it) const {
    int i0, i1, K;
    items(cur.q, i0, i1, K);
    if (cur.c1 < i1) {
      it = Item{cur.q, cur.c1, min(cur.c1 + K, i1)};
      return true;
    }
    return first_item(cur.q + 1, it);
  }
  // where the dual rhs of knot kk goes: K3 level 0's row kk; K9 (rf/rl
  // after the CR) the interior's row kk - j0 - 1, b_f and b_l beside it
  __device__ __forceinline__ T* dual_dst(long long kk) const {
    if (!kKnot || tail != kIfRhs) return V + kk * m;
    if (kk == j0) return E;
    if (kk == j0 + kn - 1) return E + m;
    return V + (kk - j0 - 1) * m;
  }

  // -- a chunk's layout in shared memory -----------------------------------------
  // staged blocks (A, B, Cm at row stride ld, ms apart; Sw the SPIKE blocks),
  // then vectors v0-v4
  struct Lay {
    T *A, *B, *Cm, *Sw;
    acc_t<T> *v0, *v1, *v2, *v3, *v4;
    int n, hb, n1, ld, ms;
  };
  __device__ __forceinline__ Lay lay(const Item& it) const {
    unsigned char* cur = px_solve_smem;
    auto take = [&](long long elems, int size) {
      unsigned char* p = cur;
      cur += (elems * size + 15) / 16 * 16;
      return p;
    };
    int l = 0;
    const PhaseKind k = kind(it.q, l);
    const int c0 = it.c0, c1 = it.c1;
    Lay y;
    y.n = c1 - c0;
    y.hb = c0 > 0;
    // blocks of m rows (Xi: dz) of dz columns in the knot phases, m elsewhere
    y.ld = k == kDual || k == kPrimal ? ldz : ldm;
    const long long MS = (long long)m * y.ld, ZS = (long long)dz * y.ld;
    if (k == kDual) {             // Xi [n1], C [n], Cn [n]; rz, q, t [n1, dz]
      y.n1 = y.n + (c1 < N);
      y.ms = (int)MS;
      if (kKnot && dz == 0) return y;
      y.A = (T*)take(y.n1 * ZS, sizeof(T));
      y.B = (T*)take(y.n * MS, sizeof(T));
      y.Cm = (T*)take(y.n * MS, sizeof(T));
      y.v0 = (A*)take((long long)y.n1 * dz, sizeof(A));
      y.v1 = (A*)take((long long)y.n1 * dz, sizeof(A));
      y.v2 = (A*)take((long long)y.n1 * dz, sizeof(A));
    } else if (k == kDown) {      // X [n1], Ul [n], Ur [n]; cv [2 n1, m], q, tl [n1, m]
      y.n1 = y.n + y.hb;
      y.ms = (int)MS;
      y.A = (T*)take(y.n1 * MS, sizeof(T));
      y.B = (T*)take(y.n * MS, sizeof(T));
      y.Cm = (T*)take(y.n * MS, sizeof(T));
      y.v0 = (A*)take(2LL * y.n1 * m, sizeof(A));
      y.v1 = (A*)take((long long)y.n1 * m, sizeof(A));
      y.v2 = (A*)take((long long)y.n1 * m, sizeof(A));
    } else if (k == kRoot) {      // X; c, q
      y.n1 = 1;
      y.ms = 0;
      y.A = (T*)take(MS, sizeof(T));
      y.v0 = (A*)take(m, sizeof(A));
      y.v1 = (A*)take(m, sizeof(A));
    } else if (k == kUp) {        // Ul, Ur, X [n]; x [n + 1, m], cv [2n, m], t, q [n, m]
      y.n1 = y.n;
      y.ms = (int)MS;
      y.A = (T*)take(y.n * MS, sizeof(T));
      y.B = (T*)take(y.n * MS, sizeof(T));
      y.Cm = (T*)take(y.n * MS, sizeof(T));
      y.v0 = (A*)take((y.n + 1LL) * m, sizeof(A));
      y.v1 = (A*)take(2LL * y.n * m, sizeof(A));
      y.v2 = (A*)take((long long)y.n * m, sizeof(A));
      y.v3 = (A*)take((long long)y.n * m, sizeof(A));
    } else if (kKnot && k == kIfRhs) {     // U_f, U_l; x_1, x_k, b_f, b_l
      y.n1 = 1;
      y.ms = 0;
      y.A = (T*)take(MS, sizeof(T));
      y.B = (T*)take(MS, sizeof(T));
      y.v0 = (A*)take(4LL * m, sizeof(A));
    } else if (kKnot && k == kSpike) {     // SPIKE blocks [n] (m x 2m); r_sol [n, m], x_f, x_l,
      y.n1 = y.n;                 // the previous partition's x_l [3, m]
      y.ms = 0;
      y.Sw = (T*)take((long long)y.n * m * ldw, sizeof(T));
      y.v0 = (A*)take((long long)y.n * m, sizeof(A));
      y.v4 = (A*)take(3LL * m, sizeof(A));
    } else {                      // C [n], Cn [n + 1] (slot i = Cn_{c0-1+i}), Xi [n];
      y.n1 = y.n;                 // lam [n + 1, m], w, q, rz [n, dz]
      y.ms = (int)MS;
      y.A = (T*)take(y.n * MS, sizeof(T));
      y.B = (T*)take((y.n + 1LL) * MS, sizeof(T));
      y.Cm = (T*)take(y.n * ZS, sizeof(T));
      y.v0 = (A*)take((y.n + 1LL) * m, sizeof(A));
      y.v1 = (A*)take((long long)y.n * dz, sizeof(A));
      y.v2 = (A*)take((long long)y.n * dz, sizeof(A));
      y.v3 = (A*)take((long long)y.n * dz, sizeof(A));
    }
    return y;
  }

  // interior index of knot kk (K9), or -1 for the partition's f and l
  __device__ int interior(long long kk) const {
    const long long i = kk - j0 - 1;
    return i >= 0 && i < kn - 2 ? (int)i : -1;
  }

  // -- stage a chunk's blocks (cp.async, not waited for) ----------------------
  __device__ __forceinline__ void stage_blocks(const Item& it) const {
    int l = 0;
    const PhaseKind k = kind(it.q, l);
    const Lay y = lay(it);
    const int c0 = it.c0, c1 = it.c1, off = Np - (Np >> l);
    if (k == kDual) {
      if (kKnot && dz == 0) return;
      stage(y.A, ldz, Xi + (long long)c0 * dd, y.n1 * dz, dz);
      stage(y.B, ldz, C + (long long)c0 * md, y.n * m, dz);
      stage(y.Cm, ldz, Cn + (long long)c0 * md, (min(c1, N - 1) - c0) * m, dz);
    } else if (k == kDown) {
      stage(y.A, ldm, Xcr + (long long)(off + c0 - y.hb) * mm, y.n1 * m, m);
      stage(y.B, ldm, Lcr + (long long)(off + c0) * mm, y.n * m, m);
      stage(y.Cm + (y.hb ? 0 : (long long)m * ldm), ldm,
            Rcr + (long long)(off + c0 - y.hb) * mm, (y.n - !y.hb) * m, m);
    } else if (k == kRoot) {
      stage(y.A, ldm, Xcr + (long long)(Np - 1) * mm, m, m);
    } else if (k == kUp) {
      stage(y.A, ldm, Lcr + (long long)(off + c0) * mm, y.n * m, m);
      stage(y.B, ldm, Rcr + (long long)(off + c0) * mm, y.n * m, m);
      stage(y.Cm, ldm, Xcr + (long long)(off + c0) * mm, y.n * m, m);
    } else if (kKnot && k == kIfRhs) {
      stage(y.A, ldm, Ub, m, m);
      stage(y.B, ldm, Ub + mm, m, m);
    } else if (kKnot && k == kSpike) {     // the interior knots' blocks
      for (int i = 0; i < y.n; ++i) {
        const int ii = interior(c0 + i);
        if (ii >= 0) stage(y.Sw + (long long)i * m * ldw, ldw, Sp + (long long)ii * 2 * mm, m, 2 * m);
      }
    } else {
      stage(y.A, ldz, C + (long long)c0 * md, y.n * m, dz);
      stage(y.B + (y.hb ? 0 : (long long)m * ldz), ldz, Cn + (long long)(c0 - y.hb) * md,
            (y.n - !y.hb) * m, dz);
      stage(y.Cm, ldz, Xi + (long long)c0 * dd, y.n * dz, dz);
    }
  }

  // -- a chunk's vectors and mat-vecs; returns after a block barrier ----------
  __device__ __forceinline__ void compute(const Item& it, long long* sub) const {
    int l = 0;
    const PhaseKind k = kind(it.q, l);
    const Lay y = lay(it);
    const int c0 = it.c0, c1 = it.c1, n = y.n, hb = y.hb, n1 = y.n1, ld = y.ld, ms = y.ms;
    const int tid = threadIdx.x, nt = blockDim.x;
    auto mark = [&](int s) {
      if (sub && tid == 0) sub[s] = clock64();
    };
    auto arrive = [&]() {        // this chunk's blocks
      cp_async_wait_group<0>();
      __syncthreads();
      mark(0);
    };
    if (kKnot && k == kDual && dz == 0) {  // the standalone system: b = rhs
      for (int idx = tid; idx < n * m; idx += nt) {
        const int i = idx / m, a = idx - i * m;
        dual_dst(c0 + i)[a] = rhs[((long long)(c0 + i) * mb + a) * r];
      }
    } else if (k == kDual) {
      A *rz = y.v0, *qv = y.v1, *t = y.v2;
      for (int idx = tid; idx < n1 * dz; idx += nt) {
        const int i = idx / dz, a = idx - i * dz;
        rz[idx] = A(rhs[((long long)(c0 + i) * mb + a) * r]);
      }
      arrive();
      const int zs = dz * ld;
      matvec<T, false>(n1, dz, dz, y.A, zs, ld, Vecs<A>{rz, dz},
                       [&](int i, int a, A s) { qv[i * dz + a] = s; });
      __syncthreads();
      mark(1);
      matvec<T, true>(n1, dz, dz, y.A, zs, ld,
                      Vecs<A>{qv, dz},
                      [&](int i, int a, A s) { t[i * dz + a] = s; });
      __syncthreads();
      mark(2);
      matvec2<T, false, false>(
          n, m, dz, y.B, y.Cm, ms, ld, Vecs<A>{t, dz},
          Vecs<A>{t + dz, dz},
          [&](int i) { return c0 + i < N - 1; },
          [&](int i, int a, A s1, A s2) {
            const long long kk = c0 + i;
            T v = T(s1 - A(rhs[(kk * mb + dz + a) * r]));
            if (kk < N - 1) v = T(A(v) + s2);
            dual_dst(kk)[a] = v;
          });
    } else if (k == kDown) {
      A *cv = y.v0, *qv = y.v1, *tl = y.v2;
      load_cg(cv, V + lvl(l) + 2LL * (c0 - hb) * m, 2 * n1 * m);
      arrive();
      matvec<T, false>(n1, m, m, y.A, ms, ld, Vecs<A>{cv + m, 2 * m},
                       [&](int i, int a, A s) { qv[i * m + a] = s; });
      __syncthreads();
      mark(1);
      matvec<T, true>(n1, m, m, y.A, ms, ld, Vecs<A>{qv, m},
                      [&](int i, int a, A s) { tl[i * m + a] = s; });
      __syncthreads();
      mark(2);
      // pair j = c0 + i (item i + hb): Ul_j tl_j and, past j = 0,
      // Ur_{j-1}^T tl_{j-1} (Ur slot i)
      T* Vn = V + lvl(l + 1);
      matvec2<T, false, true>(
          n, m, m, y.B, y.Cm, ms, ld, Vecs<A>{tl + hb * m, m},
          Vecs<A>{tl + (hb - 1) * m, m},
          [&](int i) { return c0 + i > 0; },
          [&](int i, int a, A sl, A sr) {
            const int j = c0 + i;
            T v = T(cv[2 * (i + hb) * m + a]);
            if (j > 0) v = T(A(v) - sr);
            Vn[(long long)j * m + a] = T(A(v) - sl);
          });
    } else if (k == kRoot) {
      A *c = y.v0, *qv = y.v1;
      load_cg(c, V + lvl(L), m);
      arrive();
      matvec<T, false>(1, m, m, y.A, 0, ld, Vecs<A>{c, 0},
                       [&](int, int a, A s) { qv[a] = s; });
      __syncthreads();
      mark(1);
      T* YL = Y + lvl(L);
      matvec<T, true>(1, m, m, y.A, 0, ld, Vecs<A>{qv, 0},
                      [&](int, int a, A s) { YL[a] = T(s); });
    } else if (k == kUp) {
      const int h = (Np >> l) / 2, nx = min(c1 + 1, h) - c0;
      A *xv = y.v0, *cv = y.v1, *t = y.v2, *qv = y.v3;
      load_cg(xv, Y + lvl(l + 1) + (long long)c0 * m, nx * m);   // x: level l + 1
      load_cg(cv, V + lvl(l) + 2LL * c0 * m, 2 * n * m);
      arrive();
      matvec2<T, true, false>(
          n, m, m, y.A, y.B, ms, ld, Vecs<A>{xv, m},
          Vecs<A>{xv + m, m},
          [&](int i) { return c0 + i + 1 < h; },
          [&](int i, int a, A s1, A s2) { t[i * m + a] = (cv[(2 * i + 1) * m + a] - s1) - s2; });
      __syncthreads();
      mark(1);
      matvec<T, false>(n, m, m, y.Cm, ms, ld, Vecs<A>{t, m},
                       [&](int i, int a, A s) { qv[i * m + a] = s; });
      __syncthreads();
      mark(2);
      T* Yl = Y + lvl(l);
      matvec<T, true>(n, m, m, y.Cm, ms, ld, Vecs<A>{qv, m},
                      [&](int i, int a, A s) {
                        const long long j = c0 + i;
                        Yl[(2 * j + 1) * m + a] = T(s);
                        Yl[2 * j * m + a] = T(xv[i * m + a]);
                      });
    } else if (kKnot && k == kIfRhs) {
      // r_f = b_f - U_f x_1, r_l = b_l - U_l^T x_k (x of the interior,
      // b_f, b_l of the dual) into rows 2p, 2p + 1 of the interface system
      A* v = y.v0;                 // x_1, x_k, b_f, b_l
      load_cg(v, Y, m);
      load_cg(v + m, Y + (long long)(kn - 3) * m, m);
      load_cg(v + 2 * m, E, 2 * m);
      arrive();
      matvec2<T, false, true>(1, m, m, y.A, y.B, 0, ld, Vecs<A>{v, 0}, Vecs<A>{v + m, 0},
                              [](int) { return true; }, [&](int, int a, A s1, A s2) {
                                IfV[(2LL * p) * m + a] = T(T(v[2 * m + a]) - s1);
                                IfV[(2LL * p + 1) * m + a] = T(T(v[3 * m + a]) - s2);
                              });
    } else if (kKnot && k == kSpike) {
      // lam of knots c0 .. c1 - 1 of the partition: x_f, x_l of the
      // interface solution, x_int = r_sol - S_f x_f - S_l x_l between them;
      // into Lam (the standalone system: out), and the previous partition's
      // x_l before the partition's first
      A *rs = y.v0, *xs = y.v4;    // r_sol [n, m]; x_f, x_l, x_l of partition p - 1
      load_cg(xs, IfY + 2LL * p * m, 2 * m);
      if (p > 0 && c0 == j0) load_cg(xs + 2 * m, IfY + (2LL * p - 1) * m, m);
      for (int idx = tid; idx < n * m; idx += nt) {
        const int i = idx / m, ii = interior(c0 + i);
        if (ii >= 0) rs[idx] = A(__ldcg(Y + (long long)ii * m + idx - i * m));
      }
      arrive();
      matvec2<T, false, false>(
          n, m, m, y.Sw, y.Sw + m, m * ldw, ldw, Vecs<A>{xs, 0}, Vecs<A>{xs + m, 0},
          [](int) { return true; }, [&](int i, int a, A s1, A s2) {
            const long long kk = c0 + i;
            const T v = interior(kk) >= 0 ? T((rs[i * m + a] - s1) - s2)
                                          : T(xs[(kk == j0 ? 0 : m) + a]);
            if (dz == 0) out[(kk * mb + a) * r] = v;
            else Lam[kk * m + a] = v;
          });
      if (dz > 0 && p > 0 && c0 == j0)
        for (int a = tid; a < m; a += nt) Lam[(j0 - 1LL) * m + a] = T(xs[2 * m + a]);
    } else {
      A *lv = y.v0, *w = y.v1, *qv = y.v2, *rz = y.v3;
      const int zs = dz * ld;
      load_cg(lv + (hb ? 0 : m), Lam + (long long)(c0 - hb) * m, (n + hb) * m);
      for (int idx = tid; idx < n * dz; idx += nt) {
        const int i = idx / dz, a = idx - i * dz;
        rz[idx] = A(rhs[((long long)(c0 + i) * mb + a) * r]);
      }
      arrive();
      matvec2<T, true, true>(
          n, dz, m, y.A, y.B, ms, ld, Vecs<A>{lv + m, m},
          Vecs<A>{lv, m}, [&](int i) { return c0 + i > 0; },
          [&](int i, int a, A s1, A s2) {
            T v = T(rz[i * dz + a] - s1);
            if (c0 + i > 0) v = T(A(v) - s2);
            w[i * dz + a] = A(v);
          });
      __syncthreads();
      mark(1);
      matvec<T, false>(n, dz, dz, y.Cm, zs, ld, Vecs<A>{w, dz},
                       [&](int i, int a, A s) { qv[i * dz + a] = s; });
      __syncthreads();
      mark(2);
      matvec<T, true>(n, dz, dz, y.Cm, zs, ld, Vecs<A>{qv, dz},
                      [&](int i, int a, A s) {
                        out[((long long)(c0 + i) * mb + a) * r] = T(s);
                      });
      for (int idx = tid; idx < n * m; idx += nt) {
        const int i = idx / m, a = idx - i * m;
        out[((long long)(c0 + i) * mb + dz + a) * r] = T(lv[(i + 1) * m + a]);
      }
    }
    __syncthreads();
    mark(3);
  }
};

// Under PX_CR_TIMING, block 0 of the launch (column 0) writes stamps as
// kSubStamps's note says.
template <typename T, bool kKnot>
__global__ void __launch_bounds__(kSolveThreads, 1)
solve_kernel(const SolveArgs<T> a, long long budget PX_CR_PARAM) {
  Solve<T, kKnot> s;
  const int S = a.S;
  const long long c = blockIdx.x / S;
  const int col = blockIdx.y;
  const long long b = c / a.P;
  s.p = (int)(c % a.P);
  s.N = a.N; s.Np = a.Np; s.m = a.m; s.dz = a.dz; s.r = a.r; s.S = S;
  s.rk = S > 1 ? (int)cluster_rank() : 0;
  s.L = 0;
  while ((1 << s.L) < a.Np) ++s.L;
  s.ncr = a.cr ? 2 * s.L + 1 : 0;
  s.head = a.head;
  s.tail = a.tail;
  s.nq = (a.head != kNone) + s.ncr + (a.tail != kNone);
  s.ldm = odd_ld(a.m);
  s.ldz = odd_ld(a.dz);
  s.ldw = odd_ld(2 * a.m);
  s.mm = a.m * a.m; s.md = a.m * a.dz; s.dd = a.dz * a.dz; s.mb = a.dz + a.m;
  const int N = a.N, r = a.r;
  s.Xi = a.Xi ? a.Xi + b * N * s.dd : nullptr;
  s.C = a.C ? a.C + b * N * s.md : nullptr;
  s.Cn = a.Cn ? a.Cn + b * (N - 1) * s.md : nullptr;
  s.Xcr = a.cr ? a.cr + c * a.crs : nullptr;
  s.Lcr = a.cr ? s.Xcr + (long long)a.Np * s.mm : nullptr;
  s.Rcr = a.cr ? s.Lcr + (long long)a.Np * s.mm : nullptr;
  s.rhs = a.rhs ? a.rhs + b * N * s.mb * r + col : nullptr;
  s.out = a.out ? a.out + b * N * s.mb * r + col : nullptr;
  s.V = a.ws + (c * r + col) * a.wss;
  s.Y = s.V + (2LL * a.Np - 1) * a.m;
  s.E = s.Y + (2LL * a.Np - 1) * a.m;
  s.Ub = a.Ub ? a.Ub + c * 2 * s.mm : nullptr;
  s.Sp = a.spike ? a.spike + c * (long long)(a.L - 2) * 2 * s.mm : nullptr;
  s.IfV = a.ifws ? a.ifws + (b * r + col) * a.ifwss : nullptr;
  s.IfY = s.IfV ? s.IfV + (2LL * a.Npi - 1) * a.m : nullptr;
  // K3: lam is the CR solution; K9: the partition's multipliers after E
  s.Lam = a.spike ? s.E + 2LL * a.m - (s.p * (long long)a.L - 1) * a.m : s.Y;
  s.j0 = s.p * a.L;
  s.kn = a.L;
  s.region = budget;
  s.ch = SolveChunks{a.m, a.dz, s.ldm, s.ldz, s.ldw, (int)sizeof(T), (int)sizeof(acc_t<T>)};
  long long* st = nullptr;
#ifdef PX_CR_TIMING
  if (blockIdx.x == 0 && col == 0) st = stamps;
  if (st && threadIdx.x == 0) {
    st[0] = clock64();
    st[kSubStamps - 2] = global_ns();
  }
#endif
  // knots of the dual and primal phases: an even share of the cluster's
  // L; level 0's padding rows [nrows, Np) are zeroed by their level-0
  // owners
  s.k0 = s.j0 + (int)((long long)a.L * s.rk / S);
  s.k1 = s.j0 + (int)((long long)a.L * (s.rk + 1) / S);
  if (a.cr && s.L > 0) {
    int j0, j1;
    owned_pairs(a.Np / 2, S, s.rk, j0, j1);
    for (int idx = max(2 * j0, a.nrows) * a.m + threadIdx.x; idx < 2 * j1 * a.m;
         idx += blockDim.x)
      s.V[idx] = T(0);
  }
  // the chunks in order, each one's blocks staged once the one before is
  // computed (the next phase's first before the barrier)
  Item cur, nx;
  bool has = s.first_item(0, cur);
  if (has) s.stage_blocks(cur);
  cp_async_commit();
  for (int q = 0; q < s.nq; ++q) {
    bool first = true;
    while (has && cur.q == q) {
      // the next chunk's blocks are staged once this one's are read (the
      // next phase's first before the barrier, which it does not wait on)
      const bool hn = s.next_item(cur, nx);
      s.compute(cur, st && first ? st + kSubStamps + 4 * q : nullptr);
      if (hn) s.stage_blocks(nx);
      cp_async_commit();
      first = false;
      cur = nx;
      has = hn;
    }
    if (q + 1 < s.nq) cluster_barrier(S);
    if (st && threadIdx.x == 0) st[1 + q] = clock64();
  }
  cp_async_wait_group<0>();
#ifdef PX_CR_TIMING
  if (st && threadIdx.x == 0) st[kSubStamps - 1] = global_ns();
#endif
}

// Clusters of S blocks (smem bytes each) card dev holds at once, by
// cudaOccupancyMaxActiveClusters, remembered by (card, type, S, bytes)
// under a lock (host threads may plan solves at once).
template <class K>
int resident_clusters(K kernel, cudaLaunchConfig_t cfg, int dev, int es, int S,
                      long long bytes) {
  static std::mutex mu;
  static long long keys[64];
  static int vals[64], n = 0;
  const long long key = (((bytes << 12) | (S << 4) | es) << 8) | dev;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i)
    if (keys[i] == key) return vals[i];
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    clusters = 1 << 30;           // unknown: take the size as planned
  }
  if (n < 64) {
    keys[n] = key;
    vals[n++] = clusters;
  }
  return clusters;
}

// The launch of `clusters` clusters (problems, or partitions, times
// columns): cluster size S (the power of two up to 16 with clusters S at
// most the card's SMs, at least 1: 16 at up to 8 clusters, 8 at 16, 1 from
// 128 on the H100's 132; halved while the card cannot hold all the clusters
// at once: at config 3's B = 16 it holds 15 of 8, and the 16th would run
// after them) and shared memory (200 KB a block where the launch has at
// most a block an SM: the chunks of the CNOT's level 0 and knot phases;
// else 96 KB; never less than one item of every phase). one_block: S = 1
// returns at once (the caller runs another kernel; K3's narrow blocks).
// Returns a CUDA error, or 0 with S, bytes and cfg (and its attribute)
// filled in.
template <typename T, bool kKnot>
int plan_solve(long long clusters, int m, int dz, bool one_block, int& S, long long& bytes,
               cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  const SolveChunks ch{m, dz, odd_ld(m), odd_ld(dz), odd_ld(2 * m), (int)sizeof(T),
                       (int)sizeof(acc_t<T>)};
  const long long least = (ch.least() + 15) / 16 * 16;
  if (least > (long long)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e0 = cudaGetDevice(&dev);
  if (e0 == cudaSuccess) e0 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e0 != cudaSuccess) return (int)e0;
  S = 1;
  while (S < 16 && 2LL * S * clusters <= sms) S *= 2;
  auto kernel = solve_kernel<T, kKnot>;
  cfg = cudaLaunchConfig_t{};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.blockDim = dim3(kSolveThreads, 1, 1);
  for (;; S /= 2) {
    if (S == 1 && one_block) return 0;
    const long long want = clusters * S <= sms ? 200LL * 1024 : 96LL * 1024;
    bytes = want > least ? want : least;
    if (int e = smem_for(kernel, (size_t)bytes)) return e;
    if (S > 8)
      if (int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
        return e;
    cfg.gridDim = dim3((unsigned)(clusters * S), 1, 1);
    cfg.dynamicSmemBytes = (size_t)bytes;
    attr[0].val.clusterDim.x = (unsigned)S;
    if (S == 1 || resident_clusters(kernel, cfg, dev, (int)sizeof(T), S, bytes) >= clusters)
      return 0;
  }
}

// Launch args on cfg (from plan_solve: its grid's clusters are the args'
// clusters times r, so the grid is split into (clusters / r, r)).
template <typename T, bool kKnot>
int launch_planned(cudaLaunchConfig_t cfg, int r, const SolveArgs<T>& a, long long bytes,
                   cudaStream_t st PX_CR_PARAM) {
  cfg.gridDim = dim3(cfg.gridDim.x / r, (unsigned)r, 1);
  cfg.stream = st;
  cudaError_t e = cudaLaunchKernelEx(&cfg, solve_kernel<T, kKnot>, a, bytes PX_CR_ARG(stamps));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace px
