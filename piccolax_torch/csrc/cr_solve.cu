// K3's solve: the condensed KKT solved by block cyclic reduction on the
// factor of csrc/condensed_cr.cu, one launch, a thread-block cluster a
// problem.
//
// Replaces piccolax/solver/kkt.py: condensed_solve (:464) over cr_solve
// (:381). out = K^{-1} rhs, a cluster of S thread blocks (S = 1, 2, 4, 8
// or 16, planned from B r so that B r S roughly fills the card's SMs, then
// halved while the card cannot hold all B r clusters at once) a problem
// and column of rhs. Its phases, each ended by a cluster
// barrier:
//   dual     b_k = C_k t_k - rc_k + Cn_k t_{k+1}, t_k = Xi_k^T Xi_k rz_k;
//   down l   for each pair j of level l (rows 2j, 2j+1 of n_l = Np >> l):
//            tl_j = X_j^T X_j c_{2j+1},
//            c'_j = c_{2j} - Ur_{j-1}^T tl_{j-1} - Ul_j tl_j;
//   root     x = X^T X c;
//   up l     t_j = c_{2j+1} - Ul_j^T x_j - Ur_j x_{j+1},
//            y_{2j+1} = X_j^T X_j t_j, y_{2j} = x_j;
//   primal   w_k = rz_k - C_k^T lam_k - Cn_{k-1}^T lam_{k-1},
//            z_k = Xi_k^T Xi_k w_k.
// Its least time is bytes': a solve reads every knot block and factor block
// twice (~37 MB at the CNOT in float64) for two multiply-adds a pair of
// entries; its 2 log2(Np) + 3 phases depend on each other only through
// vectors of m entries.
//
// Measured on the earlier design (one thread block a problem running every
// phase, each lane a row of strided global loads; scripts/cr_phase_timing.py
// --solve): each level cost its work on one SM, ~15 bytes a cycle; the deep
// levels and the root were ~2% of the CNOT's solve. So here:
// - a block of the cluster owns an even share of the knots in the dual and
//   primal phases, and a contiguous range of a level's pairs (or one pair
//   where the level has fewer pairs than blocks); the pair before the
//   range's first is recomputed (its tl) rather than waited for;
// - the level vectors live in a workspace [2, 2 Np - 1, m] a column (V: the
//   reduction's levels, Y: the back-substitution's) in L2, read past L1
//   (__ldcg) after the cluster barrier's release and acquire, and kept in
//   shared memory in the sums' type (float64 for float32);
// - every factor and knot block a phase needs is staged into shared memory
//   by cp.async (8 or 4 bytes a copy, a chunk's copies all in flight) at an
//   odd row stride (m | 1, dz | 1), so that the mat-vecs read rows and
//   columns without bank conflicts: G lanes an output entry (up to 8,
//   where a phase has fewer entries than the block has threads), four
//   partial sums a lane, float32 summed in float64 (acc_t);
// - a chunk's blocks are staged once the chunk before is computed, the next
//   phase's first before the cluster barrier (the blocks are inputs; only
//   the vectors wait for it); a phase whose blocks do not fit the shared
//   memory runs in chunks of items.
// What bounds it now (stamps and a probe, scripts/cr_phase_timing.py
// --solve): each phase is three dependent mat-vec steps of ~1,300-1,800
// cycles, each a chain of dependent float64 adds, plus the vectors' trip
// through L2 and the cluster barrier: ~10k cycles a level at the CNOT.
// Blocks up to 16 wide at one block a problem (config 1, the batched
// quickstart) take one_block_solve_kernel.
#include <mutex>

#include "common.cuh"

namespace {

using px::cp_async;
using px::cp_async_commit;
using px::cp_async_wait_group;

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
constexpr int kSubStamps = 64; // first sub-phase stamp slot (PX_CR_TIMING)

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

// count elements of src, written in this launch by blocks of the cluster,
// into dst (the sums' type) past L1; four loads in flight a thread
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
__device__ __forceinline__ px::acc_t<T> dot(const T* M, int ld, int a, int g, int G, int E,
                                            const px::acc_t<T>* x) {
  using A = px::acc_t<T>;
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
                        Vecs<px::acc_t<T>> x1, Vecs<px::acc_t<T>> x2, const H2& has2,
                        const Epi& epi) {
  using A = px::acc_t<T>;
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
      s1 += __shfl_xor_sync(px::kFull, s1, o);
      if (M2) s2 += __shfl_xor_sync(px::kFull, s2, o);
    }
    if (u < U && g == 0) epi(i, a, s1, s2);
  }
}

template <typename T, bool kT, class Epi>
__device__ void matvec(int K, int R, int E, const T* M, int mstride, int ld,
                       Vecs<px::acc_t<T>> x, const Epi& epi) {
  matvec2<T, kT, false>(K, R, E, M, (const T*)nullptr, mstride, ld, x, x,
                        [](int) { return false; },
                        [&](int i, int a, px::acc_t<T> s, px::acc_t<T>) { epi(i, a, s); });
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

// Blocks up to 16 wide (config 1, the quickstart): see one_block_solve_kernel.
__host__ __device__ constexpr bool narrow_solve(int m, int dz) { return m <= 16 && dz <= 16; }

// Bytes a chunk of K items of each phase takes (blocks staged, es bytes
// each; vectors, ea bytes each; 16 bytes of alignment a region); the
// largest K within a buffer is a phase's chunk (at least 1: the launch's
// budget holds one of every phase).
struct SolveChunks {
  int m, dz, ldm, ldz, es, ea;
  static constexpr int kSlack = 8 * 16;
  __host__ __device__ long long down(int K) const {
    return (3LL * K + 1) * m * ldm * es + 4LL * (K + 1) * m * ea + kSlack;
  }
  __host__ __device__ long long up(int K) const {
    return 3LL * K * m * ldm * es + (5LL * K + 1) * m * ea + kSlack;
  }
  __host__ __device__ long long dual(int K) const {
    return ((K + 1LL) * dz * ldz + 2LL * K * m * ldz) * es + 3LL * (K + 1) * dz * ea + kSlack;
  }
  __host__ __device__ long long primal(int K) const {
    return ((2LL * K + 1) * m * ldz + (long long)K * dz * ldz) * es +
           ((K + 1LL) * m + 3LL * K * dz) * ea + kSlack;
  }
  __host__ __device__ long long root() const {
    return (long long)m * ldm * es + 3LL * m * ea + kSlack;
  }
  __host__ __device__ long long least() const {
    long long a = down(1), b = up(1), c = dual(1), d = primal(1), e = root();
    a = a > b ? a : b;
    a = a > c ? a : c;
    a = a > d ? a : d;
    return a > e ? a : e;
  }
};

enum PhaseKind { kDual, kDown, kRoot, kUp, kPrimal };

// A chunk: items [c0, c1) of phase q.
struct Item {
  int q, c0, c1;
};

// One problem's (and column's) operands and the block's place in its
// cluster. Phase q: 0 the dual rhs, 1 .. L reduction level q - 1, L + 1 the
// root, L + 2 .. 2L + 1 back-substitution level 2L + 1 - q, 2L + 2 the
// primal recovery. A chunk's blocks are staged in shared memory while the
// block waits on the barrier before its phase (or after the chunk before).
template <typename T> struct Solve {
  using A = px::acc_t<T>;
  const T *Xi, *C, *Cn, *Xcr, *Lcr, *Rcr, *rhs;
  T *out, *V, *Y;
  int N, Np, m, dz, r, S, rk, L, ldm, ldz, mm, md, dd, mb, k0, k1, nq;
  long long region;          // bytes of shared memory
  SolveChunks ch;

  __device__ PhaseKind kind(int q, int& l) const {
    if (q == 0) return kDual;
    if (q <= L) { l = q - 1; return kDown; }
    if (q == L + 1) return kRoot;
    if (q <= 2 * L + 1) { l = 2 * L + 1 - q; return kUp; }
    return kPrimal;
  }
  // V_l / Y_l: level l's n_l rows
  __device__ long long lvl(int l) const { return (2LL * Np - 2 * (Np >> l)) * m; }
  __device__ long long need(PhaseKind k, int K) const {
    return k == kDual ? ch.dual(K) : k == kDown ? ch.down(K) : k == kUp ? ch.up(K)
         : k == kPrimal ? ch.primal(K) : ch.root();
  }
  // the block's items [i0, i1) of phase q and its chunk size K
  __device__ void items(int q, int& i0, int& i1, int& K) const {
    int l = 0;
    const PhaseKind k = kind(q, l);
    if (k == kDual || k == kPrimal) {
      i0 = k0;
      i1 = k1;
    } else if (k == kRoot) {
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

  // -- a chunk's layout in shared memory -----------------------------------------
  // staged blocks (A, B, Cm at row stride ld, ms apart), then vectors v0-v3
  struct Lay {
    T *A, *B, *Cm;
    px::acc_t<T> *v0, *v1, *v2, *v3;
    int n, hb, n1, ld, ms;
  };
  __device__ Lay lay(const Item& it) const {
    unsigned char* cur = px_solve_smem;
    auto take = [&](long long elems, int size) {
      unsigned char* p = cur;
      cur += (elems * size + 15) / 16 * 16;
      return p;
    };
    int l = 0;
    const PhaseKind k = kind(it.q, l);
    const int c0 = it.c0, c1 = it.c1, off = Np - (Np >> l);
    Lay y;
    y.n = c1 - c0;
    y.hb = c0 > 0;
    // blocks of m rows (Xi: dz) of dz columns in the knot phases, m elsewhere
    y.ld = k == kDual || k == kPrimal ? ldz : ldm;
    const long long MS = (long long)m * y.ld, ZS = (long long)dz * y.ld;
    if (k == kDual) {             // Xi [n1], C [n], Cn [n]; rz, q, t [n1, dz]
      y.n1 = y.n + (c1 < N);
      y.ms = (int)MS;
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

  // -- stage a chunk's blocks (cp.async, not waited for) ----------------------
  __device__ void stage_blocks(const Item& it) const {
    int l = 0;
    const PhaseKind k = kind(it.q, l);
    const Lay y = lay(it);
    const int c0 = it.c0, c1 = it.c1, off = Np - (Np >> l);
    if (k == kDual) {
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
    } else {
      stage(y.A, ldz, C + (long long)c0 * md, y.n * m, dz);
      stage(y.B + (y.hb ? 0 : (long long)m * ldz), ldz, Cn + (long long)(c0 - y.hb) * md,
            (y.n - !y.hb) * m, dz);
      stage(y.Cm, ldz, Xi + (long long)c0 * dd, y.n * dz, dz);
    }
  }

  // -- a chunk's vectors and mat-vecs; returns after a block barrier ----------
  __device__ void compute(const Item& it, long long* sub) const {
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
    if (k == kDual) {
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
            V[kk * m + a] = v;
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
    } else {
      A *lv = y.v0, *w = y.v1, *qv = y.v2, *rz = y.v3;
      const int zs = dz * ld;
      load_cg(lv + (hb ? 0 : m), Y + (long long)(c0 - hb) * m, (n + hb) * m);
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

// Under PX_CR_TIMING, block 0 of the launch writes clock64() into stamps:
// [0] at its start, [1 + q] after phase q's cluster barrier (the primal's
// after its end), and [kSubStamps + 4 q + s] in phase q's first chunk
// after its operands arrived (s = 0), after each of its three mat-vec
// steps (1, 2) and at its end (3).
template <typename T>
__global__ void __launch_bounds__(kSolveThreads, 1)
condensed_solve_kernel(const T* __restrict__ Xi_g, const T* __restrict__ C_g,
                       const T* __restrict__ Cn_g, const T* __restrict__ cr_g,
                       const T* __restrict__ rhs_g, T* __restrict__ out_g, T* __restrict__ ws_g,
                       int N, int Np, int m, int dz, int r, int S,
                       long long budget PX_CR_PARAM) {
  Solve<T> s;
  const long long b = blockIdx.x / S;
  const int col = blockIdx.y;
  s.N = N; s.Np = Np; s.m = m; s.dz = dz; s.r = r; s.S = S;
  s.rk = S > 1 ? (int)cluster_rank() : 0;
  s.L = 0;
  while ((1 << s.L) < Np) ++s.L;
  s.nq = 2 * s.L + 3;
  s.ldm = odd_ld(m);
  s.ldz = odd_ld(dz);
  s.mm = m * m; s.md = m * dz; s.dd = dz * dz; s.mb = dz + m;
  s.Xi = Xi_g + b * N * s.dd;
  s.C = C_g + b * N * s.md;
  s.Cn = Cn_g + b * (N - 1) * s.md;
  s.Xcr = cr_g + b * 3 * Np * s.mm;
  s.Lcr = s.Xcr + (long long)Np * s.mm;
  s.Rcr = s.Lcr + (long long)Np * s.mm;
  s.rhs = rhs_g + b * N * s.mb * r + col;
  s.out = out_g + b * N * s.mb * r + col;
  s.V = ws_g + (b * r + col) * 2LL * (2 * Np - 1) * m;
  s.Y = s.V + (2LL * Np - 1) * m;
  s.region = budget;
  s.ch = SolveChunks{m, dz, s.ldm, s.ldz, (int)sizeof(T), (int)sizeof(px::acc_t<T>)};
  long long* st = nullptr;
#ifdef PX_CR_TIMING
  if (blockIdx.x == 0 && col == 0) st = stamps;
  if (st && threadIdx.x == 0) st[0] = clock64();
#endif
  // knots of the dual and primal phases: an even share of the N; V_0's
  // padding rows [N, Np) are zeroed by their level-0 owners
  s.k0 = (int)((long long)N * s.rk / S);
  s.k1 = (int)((long long)N * (s.rk + 1) / S);
  if (s.L > 0) {
    int j0, j1;
    owned_pairs(Np / 2, S, s.rk, j0, j1);
    for (int idx = max(2 * j0, N) * m + threadIdx.x; idx < 2 * j1 * m; idx += blockDim.x)
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
}

// Blocks up to 16 wide at one block a problem (S = 1: B fills the card;
// config 1, the batched quickstart): one thread block runs every phase
// through the routines K9's solve uses (common.cuh: dual_rhs_knots,
// cr_solve_block, primal_knots; float32 summed in float64), 512 threads.
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
  px::dual_rhs_knots<T>(Xi, C, Cn, rhs, N, 0, N, m, dz, r, q, t, A0);
  T* x = px::cr_solve_block<T>(cr, A0, A1, rodd, tl, q2, Np, m, r);
  px::primal_knots<T>(Xi, C, Cn, rhs, x, nullptr, 0, N, m, dz, r, t, q, out);
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

// The launch of the cluster kernel: cluster size S (the power of two up to
// 16 with B r S at most the card's SMs, at least 1: 16 at B r <= 8, 8 at
// 16, 1 from 128 on the H100's 132; halved while the card cannot hold all
// B r clusters at once: at config 3's B = 16 it holds 15 of 8, and the 16th
// would run after them) and shared memory (200 KB a block where the launch
// has at most a block an SM: the chunks of the CNOT's level 0 and knot
// phases; else 96 KB; never less than one item of every phase). S = 1 with
// blocks up to 16 wide means one_block_solve_kernel. Returns a CUDA error,
// or 0 with S, bytes and cfg (and its attribute) filled in.
template <typename T>
int plan_solve(int B, int m, int dz, int r, int& S, long long& bytes, cudaLaunchConfig_t& cfg,
               cudaLaunchAttribute* attr) {
  const SolveChunks ch{m, dz, odd_ld(m), odd_ld(dz), (int)sizeof(T), (int)sizeof(px::acc_t<T>)};
  const long long least = (ch.least() + 15) / 16 * 16;
  if (least > (long long)px::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e0 = cudaGetDevice(&dev);
  if (e0 == cudaSuccess) e0 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e0 != cudaSuccess) return (int)e0;
  const long long clusters = (long long)B * r;
  S = 1;
  while (S < 16 && 2LL * S * clusters <= sms) S *= 2;
  auto kernel = condensed_solve_kernel<T>;
  cfg = cudaLaunchConfig_t{};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.blockDim = dim3(kSolveThreads, 1, 1);
  for (;; S /= 2) {
    if (S == 1 && narrow_solve(m, dz)) return 0;
    const long long want = clusters * S <= sms ? 200LL * 1024 : 96LL * 1024;
    bytes = want > least ? want : least;
    if (int e = px::smem_for(kernel, (size_t)bytes)) return e;
    if (S > 8)
      if (int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
        return e;
    cfg.gridDim = dim3((unsigned)(B * S), (unsigned)r, 1);
    cfg.dynamicSmemBytes = (size_t)bytes;
    attr[0].val.clusterDim.x = (unsigned)S;
    if (S == 1 || resident_clusters(kernel, cfg, dev, (int)sizeof(T), S, bytes) >= clusters)
      return 0;
  }
}

template <typename T>
int launch_solve(const void* Xi, const void* C, const void* Cn, const void* cr, const void* rhs,
                 void* out, void* ws, int B, int N, int Np, int m, int dz, int r,
                 cudaStream_t st PX_CR_PARAM) {
  int S = 1;
  long long bytes = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (int e = plan_solve<T>(B, m, dz, r, S, bytes, cfg, attr)) return e;
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
  cfg.stream = st;
  auto kernel = condensed_solve_kernel<T>;
#ifdef PX_CR_TIMING
  int dev = 0;
  cudaGetDevice(&dev);
  g_solve_config[0] = bytes;
  g_solve_config[1] = resident_clusters(kernel, cfg, dev, (int)sizeof(T), S, bytes);
  g_solve_config[2] = S;
#endif
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(Xi),
                                     static_cast<const T*>(C), static_cast<const T*>(Cn),
                                     static_cast<const T*>(cr), static_cast<const T*>(rhs),
                                     static_cast<T*>(out), static_cast<T*>(ws), N, Np, m, dz, r,
                                     S, bytes PX_CR_ARG(stamps));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// Workspace of the solve, in elements of T per problem (solve_ws).
extern "C" long long px_condensed_solve_ws(int N, int Np, int m, int dz, int r) {
  return solve_ws(N, Np, m, dz, r);
}

// The cluster size a solve of B problems and r columns launches with on the
// current card (plan_solve), or -1 on an error.
extern "C" int px_condensed_solve_cluster(int is_f64, int B, int m, int dz, int r) {
  int cluster = 1;
  long long bytes = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int e = is_f64 ? plan_solve<double>(B, m, dz, r, cluster, bytes, cfg, attr)
                       : plan_solve<float>(B, m, dz, r, cluster, bytes, cfg, attr);
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
  stage(Ms, ld, M, m, m);
  cp_async_commit();
  cp_async_wait_group<0>();
  for (int a = threadIdx.x; a < m; a += blockDim.x) x[a] = A(1) / (a + 1);
  __syncthreads();
  long long t0 = clock64();
  for (int i = 0; i < reps; ++i) {
    matvec<T, false>(1, m, m, Ms, 0, ld, Vecs<A>{x, 0}, [&](int, int a, A s) { y[a] = s; });
    __syncthreads();
  }
  long long t1 = clock64();
  for (int i = 0; i < reps; ++i) __syncthreads();
  long long t2 = clock64();
  A acc = 0;
  for (int i = 0; i < reps; ++i) acc += dot<T, false>(Ms, ld, threadIdx.x % m, 0, 1, m, x);
  long long t3 = clock64();
  for (int i = 0; i < reps; ++i)
    if (threadIdx.x < m) acc += dot<T, false>(Ms, ld, threadIdx.x, 0, 1, m, x);
  __syncthreads();
  long long t4 = clock64();
  for (int i = 0; i < reps; ++i)
    matvec<T, false>(1, m, m, Ms, 0, ld, Vecs<A>{x, 0}, [&](int, int a, A s) { y[a] += s; });
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
