// K7: the quasidefinite block-tridiagonal KKT by the sequential recursion
// along the knots (kkt_backend "qd").
//
// Replaces piccolax/solver/kkt.py: qd_factor, qd_solve and _qd_block_apply.
// On the TPU the recursion is a lax.scan over the knots, each step a few
// batched matmuls over the problems of a vmap. Here the knot axis is a
// loop inside the kernel and a factor or a solve is one launch. The depth,
// N knots, is the algorithm's and no batch hides it: a launch is a chain of
// N dependent steps, so what bounds it on the H100 is the latency of one
// knot's step, not bytes or operations (both are far below a knot's time).
//
// Factor: one thread block per problem, four chain warps and four helper
// warps. Per knot the chain computes
//   W = Zi_{k-1} Cn_{k-1}, P_eff = P_k + W^T W, Xi = chol_inv(P_eff),
//   Y = C_k Xi^T, S = Y Y^T + diag(R_k), Zi = chol_inv(S)
// (the Schur complements stay Gram products, as piccolax forms them, so S
// and P_eff stay PSD in rounding when P is ill-conditioned). Measured on
// the earlier design (scripts/k7_phase_timing.py), K1's shared-memory warp
// Cholesky took 75-84% of a knot and staging the knot's inputs 4-7%, so:
// - the Cholesky inverse is common.cuh's chol_inv, written for K7: up to 32
//   wide one warp with its rows in registers and the pivot's column and
//   new inverse row broadcast by __shfl_sync, past 32 two warps, one row a
//   lane, that trade them through shared memory at one barrier a pivot;
//   one rsqrt per pivot, no division. The pivots are unrolled for every
//   width: a block of width n runs chol_width(n) pivots (n rounded up to 4
//   on one warp, to 8 on two), the rows past n being those of the
//   identity, which leave the leading n x n inverse as it is, so every
//   select on the pivot index folds away;
// - the products run on the four chain warps between named barriers of
//   the chain alone, P_eff and S as lower triangles;
// - the helper warps copy knot k + 1's P, C, R and Cn into the second
//   input buffer while the chain runs knot k, and form Pinv = Xi^T Xi and
//   Sinv = Zi^T Zi of knot k from a second Xi / Zi buffer and store them:
//   nothing of the next knot needs those, so they are off the chain. The
//   copies are plain loads (sixteen in flight a thread) and shared stores:
//   cp.async of 8-byte elements, tried first, cost ~250 cycles an
//   instruction on the issuing warp (stamps of this kernel). Named
//   barriers hand each buffer over ("in_full" / "in_empty" for the
//   inputs, "full" / "empty" for Xi and Zi).
// A non-PD P_eff gives an all-NaN Xi, and NaN from its knot on, in its own
// problem only. Shared memory: twelve padded blocks of max(m, dz)^2, so the
// widest block is 64 in float32 and 48 in float64 (221 KB at 48).
//
// Solve: one thread block per problem and up to four right-hand-side
// columns, a warp per column (lane l owning rows l and l + 32 of every
// vector) and two helper warps. Both sweeps walk 2N - 1 knot steps; the
// helpers copy the Pinv, Sinv, C and Cn of the next step into shared
// memory while a step runs, so the five dependent mat-vecs of a step read
// shared memory (row strides padded to odd, no bank conflicts). The
// forward sweep y_k = r_k - U_{k-1}^T Dt_{k-1}^{-1} y_{k-1} stores y in the
// output, the backward sweep x_k = Dt_k^{-1} (y_k - U_k x_{k+1}) overwrites
// it; each lane reads back only what it wrote itself, one step ahead.
// Dt^{-1} (a, b): t = Pinv a, w = Sinv (C t - b), x = t - Pinv C^T w.
//
// Under the compile-time switch PX_QD_TIMING (off by default) the kernels
// write clock64() stamps of each phase of a knot for problem 0 and the two
// entry points take one more argument, the stamps' buffer (int64, or null);
// scripts/k7_phase_timing.py builds and reads them.
#include "common.cuh"

namespace {

using px::bar_arrive;
using px::bar_sync;

constexpr int kChainWarps = 4, kHelpWarps = 4;
constexpr int kChainThreads = 32 * kChainWarps;
constexpr int kHelpThreads = 32 * kHelpWarps;
constexpr int kFactorThreads = kChainThreads + kHelpThreads;
// named barriers (0 is __syncthreads) of the factor: the chain's; Xi / Zi
// buffer b written ("full") and read ("empty"); input buffer b written
// ("in_full") and read ("in_empty"); the helpers' own (timing only)
constexpr int kBarChain = 1, kBarFull = 2, kBarEmpty = 4, kBarInFull = 6,
              kBarInEmpty = 8, kBarHelp = 10, kBarChol = 11;
constexpr int kSolveCols = 4, kSolveHelpWarps = 4;
// the widest block of each type (shared memory; see the header)
constexpr int kMaxWidthF32 = 64, kMaxWidthF64 = 48;
// loads in flight per helper thread
constexpr int kCopyBatch = 16;

// idx / d for 0 <= idx < 64 d, d <= 64, by a float reciprocal (the error,
// below 1e-5, is far inside the 1 / 128 margin of a whole quotient)
__device__ __forceinline__ int div_small(int idx, float inv_d) {
  return static_cast<int>((idx + 0.5f) * inv_d);
}

// Copy a row-major [rows, cols] block from device memory into shared
// memory of row stride ld, threads [t0, t0 + nt) side by side, kCopyBatch
// loads in flight per thread.
template <typename T>
__device__ __forceinline__ void copy_block(T* dst, int ld, const T* __restrict__ src,
                                           int rows, int cols, int t0, int nt) {
  const int n = rows * cols;
  const float inv = 1.0f / cols;
  for (int base = t0; base < n; base += kCopyBatch * nt) {
    T v[kCopyBatch];
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int idx = base + u * nt;
      v[u] = idx < n ? __ldg(src + idx) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int idx = base + u * nt;
      if (idx < n) {
        const int i = div_small(idx, inv);
        dst[i * ld + idx - i * cols] = v[u];
      }
    }
  }
}

// Row stride of a block of width n in shared memory: odd, so that the
// lanes of a warp reading a column of rows hit distinct banks.
__host__ __device__ inline int pad(int n) { return n | 1; }

// (i, j), j <= i, of entry t of a row-major lower triangle
__device__ __forceinline__ void tri_index(int t, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  if ((i + 1) * (i + 2) / 2 <= t) ++i;
  if (i * (i + 1) / 2 > t) --i;
  j = t - i * (i + 1) / 2;
}

// Shared-memory layout of the factor, in elements of T (strides padded).
struct FactorLayout {
  int ldd, lds, pd, ps, pc, a, in, in_p, in_c, in_cn, in_r, wy, xi, zi, total;
  __host__ __device__ FactorLayout(int m, int dz) {
    ldd = pad(dz);
    lds = pad(m);
    pd = dz * ldd;
    ps = m * lds;
    pc = m * ldd;
    in_p = 0;            // offsets inside one input buffer: P_k,
    in_c = pd;           // C_k,
    in_cn = in_c + pc;   // Cn_{k-1},
    in_r = in_cn + pc;   // R_k
    in = in_r + m;       // size of one input buffer
    a = 0;               // P_eff, then S
    const int pa = pd > ps ? pd : ps;
    wy = a + pa;         // W, then Y
    xi = wy + pc;        // Xi, two buffers
    zi = xi + 2 * pd;    // Zi, two buffers
    total = zi + 2 * ps + 2 * in;
  }
  __host__ __device__ int input(int b) const { return zi + 2 * ps + b * in; }
};

#ifdef PX_QD_TIMING
constexpr int kFactorStamps = 13;
constexpr int kSolveStamps = 14;
#define PX_STAMP(k, i, n) do { \
  if (stamps && blockIdx.x == 0 && blockIdx.y == 0) \
    stamps[(long long)(k) * (n) + (i)] = clock64(); } while (0)
#define PX_CSTAMP(i) do { if (tid == 0) PX_STAMP(k, i, kFactorStamps); } while (0)
#define PX_HSTAMP(i) do { bar_sync(kBarHelp, kHelpThreads); \
  if (htid == 0) PX_STAMP(k, i, kFactorStamps); } while (0)
#define PX_SSTAMP(k, i) do { __syncwarp(); \
  if (threadIdx.x == 0) PX_STAMP(k, i, kSolveStamps); } while (0)
#define PX_STAMPS_PARAM , long long* stamps
#define PX_STAMPS_ARG , stamps
#else
#define PX_STAMPS_PARAM
#define PX_STAMPS_ARG
#define PX_CSTAMP(i) do { } while (0)
#define PX_HSTAMP(i) do { } while (0)
#define PX_SSTAMP(k, i) do { } while (0)
#endif

// Up to 32 wide two blocks an SM (at most 128 registers; without the bound
// ptxas gives the calls of the Cholesky inverses 80, at 1.4x the cycles a
// pivot in float64, measured), wider one (shared memory allows no more).
template <typename T, int W>
__global__ void __launch_bounds__(kFactorThreads, W <= 32 ? 2 : 1)
qd_factor_kernel(const T* __restrict__ P_g, const T* __restrict__ C_g,
                 const T* __restrict__ R_g, const T* __restrict__ Cn_g,
                 T* __restrict__ Pinv_g, T* __restrict__ Sinv_g, int N, int m,
                 int dz PX_STAMPS_PARAM) {
  PX_SMEM(T);
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const FactorLayout L(m, dz);
  const int ldd = L.ldd, lds = L.lds;
  const int dd = dz * dz, md = m * dz, mm = m * m;
  const float inv_dz = 1.0f / dz, inv_m = 1.0f / m;
  const T* P = P_g + (long long)b * N * dd;
  const T* C = C_g + (long long)b * N * md;
  const T* Rd = R_g + (long long)b * N * m;
  const T* Cn = Cn_g + (long long)b * (N - 1) * md;
  T* Xb = smem + L.xi;
  T* Zb = smem + L.zi;

  if (warp >= kChainWarps) {
    // helper warps: knot k + 1's inputs into input buffer (k + 1) & 1, then
    // Pinv_k = Xi^T Xi and Sinv_k = Zi^T Zi from buffer k & 1, computed in
    // full (the sums run over r in the same order for (i, j) and (j, i),
    // so both come out exactly symmetric)
    const int htid = tid - kChainThreads;
    T* Pinv = Pinv_g + (long long)b * N * dd;
    T* Sinv = Sinv_g + (long long)b * N * mm;
    auto load_knot = [&](int k) {
      T* in = smem + L.input(k & 1);
      copy_block(in + L.in_p, ldd, P + (long long)k * dd, dz, dz, htid, kHelpThreads);
      copy_block(in + L.in_c, ldd, C + (long long)k * md, m, dz, htid, kHelpThreads);
      if (k > 0)
        copy_block(in + L.in_cn, ldd, Cn + (long long)(k - 1) * md, m, dz, htid,
                   kHelpThreads);
      if (htid < m) in[L.in_r + htid] = Rd[(long long)k * m + htid];
      __threadfence_block();
      bar_arrive(kBarInFull + (k & 1), kFactorThreads);
    };
    load_knot(0);
    for (int k = 0; k < N; ++k) {
      const int s = k & 1;
      PX_HSTAMP(9);
      if (k + 1 < N) {
        if (k + 1 >= 2) bar_sync(kBarInEmpty + (s ^ 1), kFactorThreads);
        load_knot(k + 1);
      }
      PX_HSTAMP(10);
      bar_sync(kBarFull + s, kFactorThreads);
      PX_HSTAMP(11);
      const T* X = Xb + s * L.pd;
      for (int idx = htid; idx < dd; idx += kHelpThreads) {
        const int i = div_small(idx, inv_dz), j = idx - i * dz;
        T acc = 0;
#pragma unroll 4
        for (int r = i > j ? i : j; r < dz; ++r) acc += X[r * ldd + i] * X[r * ldd + j];
        Pinv[(long long)k * dd + idx] = acc;
      }
      const T* Z = Zb + s * L.ps;
      for (int idx = htid; idx < mm; idx += kHelpThreads) {
        const int i = div_small(idx, inv_m), j = idx - i * m;
        T acc = 0;
#pragma unroll 4
        for (int r = i > j ? i : j; r < m; ++r) acc += Z[r * lds + i] * Z[r * lds + j];
        Sinv[(long long)k * mm + idx] = acc;
      }
      PX_HSTAMP(12);
      if (k + 2 < N) {           // the chain refills buffer s at knot k + 2
        __threadfence_block();
        bar_arrive(kBarEmpty + s, kFactorThreads);
      }
    }
    return;
  }

  // the chain
  T* A = smem + L.a;
  T* WY = smem + L.wy;
  for (int k = 0; k < N; ++k) {
    const int s = k & 1;
    const T* in = smem + L.input(s);
    const T* Pk = in + L.in_p;
    const T* Ck = in + L.in_c;
    const T* Cp = in + L.in_cn;                  // Cn_{k-1}
    const T* Rk = in + L.in_r;
    T* Xi = Xb + s * L.pd;
    T* Zi = Zb + s * L.ps;
    PX_CSTAMP(0);
    bar_sync(kBarInFull + s, kFactorThreads);    // knot k's inputs; Zi_{k-1}
    PX_CSTAMP(1);
    if (k > 0) {
      // W = Zi_{k-1} Cn_{k-1}: W(a, c) = sum_{e <= a} Zi(a, e) Cn(e, c)
      const T* Zp = Zb + (s ^ 1) * L.ps;
      for (int idx = tid; idx < md; idx += kChainThreads) {
        const int a = div_small(idx, inv_dz), c = idx - a * dz;
        T acc = 0;
#pragma unroll 4
        for (int e = 0; e <= a; ++e) acc += Zp[a * lds + e] * Cp[e * ldd + c];
        WY[a * ldd + c] = acc;
      }
      bar_sync(kBarChain, kChainThreads);
      PX_CSTAMP(2);
    }
    // P_eff = P_k + W^T W, lower triangle
    for (int t = tid; t < dz * (dz + 1) / 2; t += kChainThreads) {
      int i, j;
      tri_index(t, i, j);
      T acc = 0;
      if (k > 0) {
#pragma unroll 4
        for (int a = 0; a < m; ++a) acc += WY[a * ldd + i] * WY[a * ldd + j];
      }
      A[i * ldd + j] = Pk[i * ldd + j] + acc;
    }
    bar_sync(kBarChain, kChainThreads);
    PX_CSTAMP(3);
    if (k >= 2) bar_sync(kBarEmpty + s, kFactorThreads);   // Pinv_{k-2} formed
    PX_CSTAMP(4);
    px::chol_inv<T, W>(A, ldd, Xi, ldd, dz, warp, lane, A, kBarChol);
    bar_sync(kBarChain, kChainThreads);
    PX_CSTAMP(5);
    // Y = C_k Xi^T: Y(a, c) = sum_{e <= c} C(a, e) Xi(c, e)
    for (int idx = tid; idx < md; idx += kChainThreads) {
      const int a = div_small(idx, inv_dz), c = idx - a * dz;
      T acc = 0;
#pragma unroll 4
      for (int e = 0; e <= c; ++e) acc += Ck[a * ldd + e] * Xi[c * ldd + e];
      WY[a * ldd + c] = acc;
    }
    bar_sync(kBarChain, kChainThreads);
    PX_CSTAMP(6);
    // S = Y Y^T + diag(R_k), lower triangle (exactly symmetric, so
    // piccolax's 0.5 (S + S^T) changes nothing), into A
    for (int t = tid; t < m * (m + 1) / 2; t += kChainThreads) {
      int a, c;
      tri_index(t, a, c);
      T acc = 0;
#pragma unroll 4
      for (int e = 0; e < dz; ++e) acc += WY[a * ldd + e] * WY[c * ldd + e];
      A[a * lds + c] = a == c ? acc + Rk[a] : acc;
    }
    bar_sync(kBarChain, kChainThreads);
    PX_CSTAMP(7);
    if (k + 2 < N) bar_arrive(kBarInEmpty + s, kFactorThreads);   // inputs read
    px::chol_inv<T, W>(A, lds, Zi, lds, m, warp, lane, A, kBarChol);
    __threadfence_block();
    PX_CSTAMP(8);
    bar_arrive(kBarFull + s, kFactorThreads);              // Xi, Zi of knot k
  }
}

// Entries l and l + 32 (those below n_out) of M x, or of M^T x (trans);
// M in shared memory with row stride ld, x a shared vector of n terms.
// Two partial sums a row (half the dependent chain), accumulated in
// double: the float solve at the CNOT's blocks then stays inside its
// 1e-3 check with margin (chip_smoke.py).
template <typename T>
__device__ __forceinline__ void matvec(const T* M, int ld, const T* x, int n, int n_out,
                                       bool trans, int lane, T& y0, T& y1) {
  using Acc = double;
  const int i0 = lane, i1 = lane + 32;
  const int si = trans ? 1 : ld, se = trans ? ld : 1;
  const T* m0 = M + (i0 < n_out ? i0 : 0) * si;
  Acc a0 = 0, b0 = 0, a1 = 0, b1 = 0;
  const int n2 = n & ~1;
  if (n_out > 32) {
    const T* m1 = M + (i1 < n_out ? i1 : 0) * si;
#pragma unroll 4
    for (int e = 0; e < n2; e += 2) {
      const Acc x0 = x[e], x1 = x[e + 1];
      a0 += Acc(m0[e * se]) * x0;
      b0 += Acc(m0[(e + 1) * se]) * x1;
      a1 += Acc(m1[e * se]) * x0;
      b1 += Acc(m1[(e + 1) * se]) * x1;
    }
    if (n2 < n) {
      a0 += Acc(m0[n2 * se]) * Acc(x[n2]);
      a1 += Acc(m1[n2 * se]) * Acc(x[n2]);
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < n2; e += 2) {
      a0 += Acc(m0[e * se]) * Acc(x[e]);
      b0 += Acc(m0[(e + 1) * se]) * Acc(x[e + 1]);
    }
    if (n2 < n) a0 += Acc(m0[n2 * se]) * Acc(x[n2]);
  }
  y0 = i0 < n_out ? T(a0 + b0) : T(0);
  y1 = i1 < n_out ? T(a1 + b1) : T(0);
}

// Shared-memory layout of the solve: two stage buffers of (Pinv, Sinv, C,
// Cn), then six 64-vectors per column warp.
struct SolveLayout {
  int ldd, lds, pinv, sinv, c, cn, stage, vec, total;
  __host__ __device__ SolveLayout(int m, int dz, int cols) {
    ldd = pad(dz);
    lds = pad(m);
    pinv = 0;
    sinv = pinv + dz * ldd;
    c = sinv + m * lds;
    cn = c + m * ldd;
    stage = cn + m * ldd;
    vec = 2 * stage;
    total = vec + cols * 6 * 64;
  }
};

// solve barriers: stage buffer b written ("in_full") and read ("in_empty")
constexpr int kSBarInFull = 1, kSBarInEmpty = 3;

template <typename T>
__global__ void qd_solve_kernel(const T* __restrict__ Pinv_g, const T* __restrict__ Sinv_g,
                                const T* __restrict__ C_g, const T* __restrict__ Cn_g,
                                const T* __restrict__ rhs_g, T* __restrict__ out_g, int N,
                                int m, int dz, int r PX_STAMPS_PARAM) {
  PX_SMEM(T);
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nt = blockDim.x, ncol = nt / 32 - kSolveHelpWarps;
  const SolveLayout L(m, dz, ncol);
  const int ldd = L.ldd, lds = L.lds;
  const int dd = dz * dz, md = m * dz, mm = m * m, mb = dz + m;
  const int steps = 2 * N - 1;              // forward j = 0..N-2, backward N-1..0
  auto knot_of = [N](int q) { return q < N - 1 ? q : 2 * N - 2 - q; };

  if (warp >= ncol) {
    // helpers: the blocks of step q into stage buffer q & 1
    const int htid = threadIdx.x - 32 * ncol, nh = 32 * kSolveHelpWarps;
    const T* Pinv = Pinv_g + (long long)b * N * dd;
    const T* Sinv = Sinv_g + (long long)b * N * mm;
    const T* C = C_g + (long long)b * N * md;
    const T* Cn = Cn_g + (long long)b * (N - 1) * md;
    for (int q = 0; q < steps; ++q) {
      if (q >= 2) bar_sync(kSBarInEmpty + (q & 1), nt);
      const int j = knot_of(q);
      T* base = smem + (q & 1) * L.stage;
      copy_block(base + L.pinv, ldd, Pinv + (long long)j * dd, dz, dz, htid, nh);
      copy_block(base + L.sinv, lds, Sinv + (long long)j * mm, m, m, htid, nh);
      copy_block(base + L.c, ldd, C + (long long)j * md, m, dz, htid, nh);
      if (j < N - 1) copy_block(base + L.cn, ldd, Cn + (long long)j * md, m, dz, htid, nh);
      __threadfence_block();
      bar_arrive(kSBarInFull + (q & 1), nt);
    }
    return;
  }

  const int col = blockIdx.y * kSolveCols + warp;
  const bool mine = col < r;                 // uniform per warp
  const T* rhs = rhs_g + (long long)b * N * mb * r;
  T* out = out_g + (long long)b * N * mb * r;
  T* va = smem + L.vec + warp * 6 * 64;     // z part of the current vector
  T* vb = va + 64;                          // lam part
  T* vt = vb + 64;
  T* vu = vt + 64;
  T* vw = vu + 64;
  T* vv = vw + 64;                          // C^T w, then x_{k+1}'s z part
  // this lane's entries of a knot's vector: rows l, l + 32 of z and of lam
  auto at = [&](const T* v, int k, int i) { return v[((long long)k * mb + i) * r + col]; };
  const int z0 = lane, z1 = lane + 32;
  // what step q reads from device memory: rhs_{q+1} (forward), y_j (backward)
  T nz0 = 0, nz1 = 0, nl0 = 0, nl1 = 0;
  auto prefetch = [&](int q) {
    if (!mine || q >= steps) return;
    const bool fwd = q < N - 1;
    const int k = fwd ? q + 1 : knot_of(q);
    if (!fwd && k == N - 1) return;          // y_{N-1} is still in va, vb
    const T* v = fwd ? rhs : out;
    nz0 = z0 < dz ? at(v, k, z0) : T(0);
    nz1 = z1 < dz ? at(v, k, z1) : T(0);
    nl0 = z0 < m ? at(v, k, dz + z0) : T(0);
    nl1 = z1 < m ? at(v, k, dz + z1) : T(0);
  };

  if (mine) {                                // y_0 = r_0
    if (z0 < dz) { va[z0] = at(rhs, 0, z0); out[((long long)z0) * r + col] = va[z0]; }
    if (z1 < dz) { va[z1] = at(rhs, 0, z1); out[((long long)z1) * r + col] = va[z1]; }
    if (z0 < m) { vb[z0] = at(rhs, 0, dz + z0); out[((long long)dz + z0) * r + col] = vb[z0]; }
    if (z1 < m) { vb[z1] = at(rhs, 0, dz + z1); out[((long long)dz + z1) * r + col] = vb[z1]; }
  }
  prefetch(0);
  for (int q = 0; q < steps; ++q) {
    const bool fwd = q < N - 1;
    const int k = fwd ? q + 1 : knot_of(q);  // the knot this step writes
    const int s0 = fwd ? 0 : 6;              // its first stamp
    PX_SSTAMP(k, s0);
    bar_sync(kSBarInFull + (q & 1), nt);     // step q's blocks
    PX_SSTAMP(k, s0 + 1);
    if (mine) {
      const T* base = smem + (q & 1) * L.stage;
      const T* Pk = base + L.pinv;
      const T* Sk = base + L.sinv;
      const T* Ck = base + L.c;
      const T* Cnk = base + L.cn;
      const T cz0 = nz0, cz1 = nz1, cl0 = nl0, cl1 = nl1;
      prefetch(q + 1);
      T y0, y1;
      if (!fwd) {
        if (k < N - 1) {                     // b = y_k,lam - Cn_k x_{k+1},z
          matvec(Cnk, ldd, vv, dz, m, false, lane, y0, y1);
          __syncwarp();
          if (z0 < dz) va[z0] = cz0;
          if (z1 < dz) va[z1] = cz1;
          if (z0 < m) vb[z0] = cl0 - y0;
          if (z1 < m) vb[z1] = cl1 - y1;
          __syncwarp();
        }
        PX_SSTAMP(k, 8);
      }
      matvec(Pk, ldd, va, dz, dz, false, lane, y0, y1);    // t = Pinv a
      if (z0 < dz) vt[z0] = y0;
      if (z1 < dz) vt[z1] = y1;
      __syncwarp();
      PX_SSTAMP(k, fwd ? 2 : 9);
      matvec(Ck, ldd, vt, dz, m, false, lane, y0, y1);     // u = C t - b
      if (z0 < m) vu[z0] = y0 - vb[z0];
      if (z1 < m) vu[z1] = y1 - vb[z1];
      __syncwarp();
      PX_SSTAMP(k, fwd ? 3 : 10);
      matvec(Sk, lds, vu, m, m, false, lane, y0, y1);      // w = Sinv u
      if (z0 < m) vw[z0] = y0;
      if (z1 < m) vw[z1] = y1;
      __syncwarp();
      PX_SSTAMP(k, fwd ? 4 : 11);
      T* o = out + (long long)k * mb * r;
      if (fwd) {                             // y_k = (r_z - Cn^T w, r_lam)
        matvec(Cnk, ldd, vw, m, dz, true, lane, y0, y1);
        if (z0 < dz) { va[z0] = cz0 - y0; o[(long long)z0 * r + col] = va[z0]; }
        if (z1 < dz) { va[z1] = cz1 - y1; o[(long long)z1 * r + col] = va[z1]; }
        if (z0 < m) { vb[z0] = cl0; o[((long long)dz + z0) * r + col] = cl0; }
        if (z1 < m) { vb[z1] = cl1; o[((long long)dz + z1) * r + col] = cl1; }
        __syncwarp();
        PX_SSTAMP(k, 5);
      } else {
        matvec(Ck, ldd, vw, m, dz, true, lane, y0, y1);    // v = C^T w
        if (z0 < dz) vv[z0] = y0;
        if (z1 < dz) vv[z1] = y1;
        __syncwarp();
        PX_SSTAMP(k, 12);
        matvec(Pk, ldd, vv, dz, dz, false, lane, y0, y1);  // x = t - Pinv v
        __syncwarp();
        if (z0 < dz) { vv[z0] = vt[z0] - y0; o[(long long)z0 * r + col] = vv[z0]; }
        if (z1 < dz) { vv[z1] = vt[z1] - y1; o[(long long)z1 * r + col] = vv[z1]; }
        if (z0 < m) o[((long long)dz + z0) * r + col] = vw[z0];
        if (z1 < m) o[((long long)dz + z1) * r + col] = vw[z1];
        __syncwarp();
        PX_SSTAMP(k, 13);
      }
    }
    if (q + 2 < steps) bar_arrive(kSBarInEmpty + (q & 1), nt);  // buffer read
  }
}

inline int max_width(bool f64) { return f64 ? kMaxWidthF64 : kMaxWidthF32; }

bool widths_ok(int is_f64, int N, int m, int dz) {
  const int w = max_width(is_f64 != 0);
  return N >= 1 && m >= 1 && m <= w && dz >= 1 && dz <= w;
}

template <typename T, int W>
int launch_factor_w(const void* P, const void* C, const void* R, const void* Cn,
                    void* Pinv, void* Sinv, int B, int N, int m, int dz,
                    cudaStream_t st PX_STAMPS_PARAM) {
  const size_t smem = sizeof(T) * FactorLayout(m, dz).total;
  if (smem > px::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      qd_factor_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  qd_factor_kernel<T, W><<<B, kFactorThreads, smem, st>>>(
      static_cast<const T*>(P), static_cast<const T*>(C), static_cast<const T*>(R),
      static_cast<const T*>(Cn), static_cast<T*>(Pinv), static_cast<T*>(Sinv), N, m,
      dz PX_STAMPS_ARG);
  return (int)cudaGetLastError();
}

// W, the widest block's width rounded up to 16, bounds the Cholesky
// inverses (and so the registers) that a launch can reach.
template <typename T>
int launch_factor(const void* P, const void* C, const void* R, const void* Cn,
                  void* Pinv, void* Sinv, int B, int N, int m, int dz,
                  cudaStream_t st PX_STAMPS_PARAM) {
  if (B < 1) return (int)cudaGetLastError();
  const int w = m > dz ? m : dz;
  if (w <= 16)
    return launch_factor_w<T, 16>(P, C, R, Cn, Pinv, Sinv, B, N, m, dz, st PX_STAMPS_ARG);
  if (w <= 32)
    return launch_factor_w<T, 32>(P, C, R, Cn, Pinv, Sinv, B, N, m, dz, st PX_STAMPS_ARG);
  if (w <= 48)
    return launch_factor_w<T, 48>(P, C, R, Cn, Pinv, Sinv, B, N, m, dz, st PX_STAMPS_ARG);
  if constexpr (sizeof(T) == 4)
    return launch_factor_w<T, 64>(P, C, R, Cn, Pinv, Sinv, B, N, m, dz, st PX_STAMPS_ARG);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_solve(const void* Pinv, const void* Sinv, const void* C, const void* Cn,
                 const void* rhs, void* out, int B, int N, int m, int dz, int r,
                 cudaStream_t st PX_STAMPS_PARAM) {
  if (B < 1) return (int)cudaGetLastError();
  const int cols = r < kSolveCols ? r : kSolveCols;
  const size_t smem = sizeof(T) * SolveLayout(m, dz, cols).total;
  if (smem > px::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      qd_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B, (r + kSolveCols - 1) / kSolveCols);
  qd_solve_kernel<T><<<grid, 32 * (cols + kSolveHelpWarps), smem, st>>>(
      static_cast<const T*>(Pinv), static_cast<const T*>(Sinv), static_cast<const T*>(C),
      static_cast<const T*>(Cn), static_cast<const T*>(rhs), static_cast<T*>(out), N, m,
      dz, r PX_STAMPS_ARG);
  return (int)cudaGetLastError();
}

}  // namespace

// The widest block (m and dz) of each type: 64 in float32, 48 in float64.
extern "C" int px_qd_max_width(int is_f64) { return max_width(is_f64 != 0); }

// Row-major, batch leading, double (is_f64) or float: P [B, N, dz, dz],
// C [B, N, m, dz], R [B, N, m], Cn [B, N-1, m, dz] -> Pinv [B, N, dz, dz],
// Sinv [B, N, m, m]; m, dz <= px_qd_max_width. Under PX_QD_TIMING the
// stamps [N, 13] of problem 0 follow the stream.
extern "C" int px_qd_factor(int is_f64, const void* P, const void* C, const void* R,
                            const void* Cn, void* Pinv, void* Sinv, int B, int N,
                            int m, int dz, void* stream PX_STAMPS_PARAM) {
  if (!widths_ok(is_f64, N, m, dz)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64
      ? launch_factor<double>(P, C, R, Cn, Pinv, Sinv, B, N, m, dz, st PX_STAMPS_ARG)
      : launch_factor<float>(P, C, R, Cn, Pinv, Sinv, B, N, m, dz, st PX_STAMPS_ARG);
}

// rhs and out [B, N, dz + m, r] ordered (z, lam) per knot. Under
// PX_QD_TIMING the stamps [N, 14] of problem 0 and column 0 follow.
extern "C" int px_qd_solve(int is_f64, const void* Pinv, const void* Sinv, const void* C,
                           const void* Cn, const void* rhs, void* out, int B, int N,
                           int m, int dz, int r, void* stream PX_STAMPS_PARAM) {
  if (!widths_ok(is_f64, N, m, dz) || r < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64
      ? launch_solve<double>(Pinv, Sinv, C, Cn, rhs, out, B, N, m, dz, r, st PX_STAMPS_ARG)
      : launch_solve<float>(Pinv, Sinv, C, Cn, rhs, out, B, N, m, dz, r, st PX_STAMPS_ARG);
}

#ifdef PX_QD_TIMING
// Phase names of the stamps, in time order within a knot, by group: the
// chain ("c."), the helper warps ("h."), the solve's forward ("fwd.") and
// backward ("bwd.") steps.
extern "C" const char* px_qd_timing_phases(int solve) {
  return solve ? "fwd.start,fwd.wait,fwd.t=Pinv*a,fwd.u=C*t-b,fwd.w=Sinv*u,"
                 "fwd.y=r-Cn^T*w+store,bwd.start,bwd.wait,bwd.b=y-Cn*x,"
                 "bwd.t=Pinv*a,bwd.u=C*t-b,bwd.w=Sinv*u,bwd.v=C^T*w,bwd.x=t-Pinv*v+store"
               : "c.start,c.inputs,c.W=Zi*Cn,c.Peff=P+W^T*W,c.empty,c.chol(Peff),"
                 "c.Y=C*Xi^T,c.S=Y*Y^T+R,c.chol(S),"
                 "h.start,h.load(k+1),h.full,h.Pinv+Sinv+store";
}
#endif
