// K5: batched scaling-and-squaring Pade-13 matrix exponential of complex
// matrices, with a squaring count per matrix.
//
// Replaces piccolax/ops/expm.py:74 expm (with _pade13 :59 and _ns_solve :44), the
// propagator of every rollout (the trajectory's construction, the re-sync
// after a solve, the rollout-fidelity check). Each matrix takes its own
// s = clamp(ceil(log2(||A||_inf / 0.95)), 0, max_squarings) in the real
// type of its entries (the JAX function's expression, so s is its own), is
// scaled by 2^-s, goes through Pade-13's U and V, F = (V - U)^-1 (V + U),
// and is squared s times.
//
// The solve is direct. The JAX function inverts V - U by 8 Newton-Schulz
// steps (16 products) because the TPU's LU takes only f32/c64; here n = 2
// takes the closed form (adjugate over determinant) and the other n <= 16
// Gauss-Jordan elimination without pivoting. That is stable: after the
// scaling ||A||_inf <= 0.95, and V - U = b0 (I + E) with ||E||_inf < 1 (the
// Newton-Schulz contract of piccolax/ops/expm.py:44-50), so V - U is
// strictly diagonally dominant by rows, every elimination step keeps it so,
// and no pivot comes near zero. U and V are formed divided by b0 (the
// coefficients b_k / b0), so that the pivots are of order one in float32
// too.
//
// Bound on the H100: a matrix takes 6 + s complex products (X2, X4, X6; two
// for U, one for V; s squarings, five complex multiplies each at n = 2) and
// the solve (n = 2: ~1k flops at s = 8 against 128 bytes in and out, so
// bytes; n = 16: ~0.5 Mflop against 8 KB, so operations on the float64
// pipes, which a complex product this small cannot feed through DMMA). The
// design keeps every intermediate out of device memory:
// - n = 2: one thread a matrix in registers, loaded and stored as 16-byte
//   units (a squaring five complex products).
// - n = 1 and 2 < n <= 16: a segment of S lanes a matrix (8, 4 or 2
//   matrices a warp up to 4, 8 and 16 wide), its matrices in shared memory; lane q of
//   a segment owns a TR x TC register tile of every product (1 x 4, 2 x 4,
//   4 x 4, interleaved) and reads TR + TC shared entries a k-step for TR TC
//   multiply-adds. One __syncwarp a product and one a Gauss-Jordan step,
//   whose tiles of V - U and V + U stay in registers (the pivot row and
//   column pass through a double-buffered exchange).
//
// Under the compile-time switch PX_K5_TIMING (off in every other build) the
// entry point takes one more argument, a stamps buffer: one thread of
// block 0 (n = 2: thread 0; else lane 0, the first matrix's) writes
// clock64() at its start [0], after load and norm [1], the powers [2], U
// and V [3], the solve [4], the squarings [5] and the store [6],
// %globaltimer at its start [7] and end [8], and its matrix's s [9];
// scripts/k5_k8_timing.py builds and reads it.
#include "common.cuh"

#ifdef PX_K5_TIMING
#define PX_K5_PARAM , long long* stamps
#define PX_K5_ARG(p) , (p)
#define PX_K5_STAMP(i) do { if (stamps) t_[i] = clock64(); } while (0)
#else
#define PX_K5_PARAM
#define PX_K5_ARG(p)
#define PX_K5_STAMP(i) do { } while (0)
#endif

namespace {

// b_k / b0: U / b0 and V / b0 directly, so that V - U = I + E
#define PX_B13N(k) (kB13v[k] / kB13v[0])
constexpr double kB13v[14] = {
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0,  129060195264000.0,   10559470521600.0,
    670442572800.0,      33522128640.0,       1323241920.0,
    40840800.0,          960960.0,            16380.0,
    182.0,               1.0};
__constant__ double kB13n[14] = {
    PX_B13N(0), PX_B13N(1), PX_B13N(2),  PX_B13N(3),  PX_B13N(4),  PX_B13N(5),  PX_B13N(6),
    PX_B13N(7), PX_B13N(8), PX_B13N(9), PX_B13N(10), PX_B13N(11), PX_B13N(12), PX_B13N(13)};
#undef PX_B13N

constexpr int kThreads2 = 128;
constexpr int kWarpsSeg = 2;

template <typename T> struct C { T re, im; };

template <typename T> __device__ __forceinline__ C<T> cadd(C<T> a, C<T> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename T> __device__ __forceinline__ C<T> csub(C<T> a, C<T> b) {
  return {a.re - b.re, a.im - b.im};
}
template <typename T> __device__ __forceinline__ C<T> cmul(C<T> a, C<T> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
// acc + a b
template <typename T> __device__ __forceinline__ C<T> cfma(C<T> a, C<T> b, C<T> acc) {
  return {fma(a.re, b.re, fma(-a.im, b.im, acc.re)), fma(a.re, b.im, fma(a.im, b.re, acc.im))};
}
template <typename T> __device__ __forceinline__ C<T> rmul(T r, C<T> a) {
  return {r * a.re, r * a.im};
}
// 1 / p of a p of order one
template <typename T> __device__ __forceinline__ C<T> crecip(C<T> p) {
  const T r = T(1) / (p.re * p.re + p.im * p.im);
  return {p.re * r, -p.im * r};
}

template <typename T> __device__ __forceinline__ T modulus(C<T> a);
template <> __device__ __forceinline__ float modulus<float>(C<float> a) {
  return hypotf(a.re, a.im);
}
template <> __device__ __forceinline__ double modulus<double>(C<double> a) {
  return hypot(a.re, a.im);
}

// s = clamp(ceil(log(max(norm * (1 / 0.95), 1e-30)) * (1 / ln 2)), 0, max_s),
// in T as the plain version computes it: log2 as log times 1 / ln 2, the
// form the compiled JAX expression takes, which sets the count at norms an
// ulp from 0.95 * 2^k. A NaN norm gives 0, as the plain version's cast does.
template <typename T> __device__ __forceinline__ int squarings_of(T norm, int max_s);
template <> __device__ __forceinline__ int squarings_of<float>(float norm, int max_s) {
  const float x = px::nan_max(norm * (float)(1.0 / 0.95), 1e-30f);
  const float l = ceilf(logf(x) * (float)(1.0 / 0.69314718055994530942));
  return (int)fminf(fmaxf(l, 0.0f), (float)max_s);
}
template <> __device__ __forceinline__ int squarings_of<double>(double norm, int max_s) {
  const double x = px::nan_max(norm * (1.0 / 0.95), 1e-30);
  const double l = ceil(log(x) * (1.0 / 0.69314718055994530942));
  return (int)fmin(fmax(l, 0.0), (double)max_s);
}

// The same s from a norm of sqrt(re^2 + im^2) moduli (a few ulps from the
// hypot ones): its count is ceil(log2(norm / 0.95)) from the exponent
// alone, unless norm / 0.95 lies within 2^-40 (float32: 2^-14) of a power
// of two, or is not finite, where the count is taken from the exact norm
// as squarings_of takes it.
__device__ __forceinline__ float fast_modulus(C<float> a) {
  return sqrtf(fmaf(a.re, a.re, a.im * a.im));
}
__device__ __forceinline__ double fast_modulus(C<double> a) {
  return sqrt(fma(a.re, a.re, a.im * a.im));
}
__device__ __forceinline__ float frexp_(float x, int* e) { return frexpf(x, e); }
__device__ __forceinline__ double frexp_(double x, int* e) { return frexp(x, e); }
template <typename T, class Exact>
__device__ __forceinline__ int squarings_fast(T norm, int max_s, Exact exact_norm) {
  const T x = norm * (T)(1.0 / 0.95);
  int e;
  const T m = frexp_(x, &e);                      // x = m 2^e, m in [0.5, 1)
  const T tol = sizeof(T) == 8 ? T(0x1p-40) : T(0x1p-14);
  if (!(fabs(x) < T(INFINITY)) || m - T(0.5) < tol || T(1) - m < tol)
    return squarings_of<T>(exact_norm(), max_s);
  return e < 0 ? 0 : (e > max_s ? max_s : e);
}

#ifdef PX_K5_TIMING
__device__ __forceinline__ long long k5_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void k5_write(long long* stamps, long long* t_, int s) {
  t_[8] = k5_ns();
  for (int i = 0; i < 9; ++i) stamps[i] = t_[i];
  stamps[9] = s;
}
#endif

// ---- n = 2: one thread, registers ------------------------------------------

template <typename T> struct M2 { C<T> a, b, c, d; };   // [[a, b], [c, d]]

template <typename T> __device__ __forceinline__ M2<T> mm(const M2<T>& p, const M2<T>& q) {
  return {cfma(p.b, q.c, cmul(p.a, q.a)), cfma(p.b, q.d, cmul(p.a, q.b)),
          cfma(p.d, q.c, cmul(p.c, q.a)), cfma(p.d, q.d, cmul(p.c, q.b))};
}
// x p + y q + z r (+ w I)
template <typename T> __device__ __forceinline__ M2<T> lin(T x, const M2<T>& p, T y,
                                                          const M2<T>& q, T z,
                                                          const M2<T>& r, T w = T(0)) {
  auto e = [&](C<T> pe, C<T> qe, C<T> re, T d) {
    return C<T>{x * pe.re + y * qe.re + z * re.re + d, x * pe.im + y * qe.im + z * re.im};
  };
  return {e(p.a, q.a, r.a, w), e(p.b, q.b, r.b, T(0)), e(p.c, q.c, r.c, T(0)),
          e(p.d, q.d, r.d, w)};
}
// p^2: bc + a^2, b (a + d), c (a + d), bc + d^2 (five complex products, not eight)
template <typename T> __device__ __forceinline__ M2<T> sq(const M2<T>& p) {
  const C<T> bc = cmul(p.b, p.c), tr = cadd(p.a, p.d);
  return {cfma(p.a, p.a, bc), cmul(p.b, tr), cmul(p.c, tr), cfma(p.d, p.d, bc)};
}
template <typename T> __device__ __forceinline__ M2<T> add(const M2<T>& p, const M2<T>& q) {
  return {cadd(p.a, q.a), cadd(p.b, q.b), cadd(p.c, q.c), cadd(p.d, q.d)};
}

// One thread a matrix: four 16-byte loads at a 64-byte stride (c128; two
// at 32 bytes in c64), every byte of which the warp uses.
template <typename T>
__global__ void __launch_bounds__(kThreads2)
expm_pade13_n2(const T* __restrict__ A, T* __restrict__ out, int* __restrict__ s_out,
               long long batch, int max_s PX_K5_PARAM) {
  constexpr int U = (int)sizeof(C<T>) / 4;          // 16-byte units a matrix
  union Mat { uint4 u[U]; C<T> e[4]; };
  const long long b = (long long)blockIdx.x * kThreads2 + threadIdx.x;
  if (b >= batch) return;
#ifdef PX_K5_TIMING
  if (b != 0) stamps = nullptr;
  long long t_[9];
  if (stamps) { t_[7] = k5_ns(); t_[0] = clock64(); }
#endif
  const uint4* in = reinterpret_cast<const uint4*>(A) + b * U;
  Mat m;
#pragma unroll
  for (int k = 0; k < U; ++k) m.u[k] = __ldg(in + k);
  M2<T> X{m.e[0], m.e[1], m.e[2], m.e[3]};
  const int s = squarings_fast<T>(
      px::nan_max(fast_modulus(X.a) + fast_modulus(X.b), fast_modulus(X.c) + fast_modulus(X.d)),
      max_s,
      [&] { return px::nan_max(modulus(X.a) + modulus(X.b), modulus(X.c) + modulus(X.d)); });
  if (s_out) s_out[b] = s;
  const T sc = (T)ldexp(1.0, -s);
  X = {rmul(sc, X.a), rmul(sc, X.b), rmul(sc, X.c), rmul(sc, X.d)};
  PX_K5_STAMP(1);
  const M2<T> X2 = mm(X, X), X4 = mm(X2, X2), X6 = mm(X4, X2);
  PX_K5_STAMP(2);
  // U / b0 and V / b0: the denominator V - U is I + E, ||E|| < 1
  const M2<T> Uq = mm(X, add(mm(X6, lin((T)kB13n[13], X6, (T)kB13n[11], X4, (T)kB13n[9], X2)),
                             lin((T)kB13n[7], X6, (T)kB13n[5], X4, (T)kB13n[3], X2,
                                 (T)kB13n[1])));
  const M2<T> V = add(mm(X6, lin((T)kB13n[12], X6, (T)kB13n[10], X4, (T)kB13n[8], X2)),
                      lin((T)kB13n[6], X6, (T)kB13n[4], X4, (T)kB13n[2], X2, T(1)));
  const M2<T> D{csub(V.a, Uq.a), csub(V.b, Uq.b), csub(V.c, Uq.c), csub(V.d, Uq.d)};
  const M2<T> N = add(V, Uq);
  PX_K5_STAMP(3);
  const C<T> rdet = crecip(csub(cmul(D.a, D.d), cmul(D.b, D.c)));
  const M2<T> adj{cmul(rdet, D.d), cmul(rdet, C<T>{-D.b.re, -D.b.im}),
                  cmul(rdet, C<T>{-D.c.re, -D.c.im}), cmul(rdet, D.a)};
  M2<T> F = mm(adj, N);
  PX_K5_STAMP(4);
  for (int q = 0; q < s; ++q) F = sq(F);
  PX_K5_STAMP(5);
  m.e[0] = F.a; m.e[1] = F.b; m.e[2] = F.c; m.e[3] = F.d;
  uint4* o = reinterpret_cast<uint4*>(out) + b * U;
#pragma unroll
  for (int k = 0; k < U; ++k) o[k] = m.u[k];
#ifdef PX_K5_TIMING
  if (stamps) { t_[6] = clock64(); k5_write(stamps, t_, s); }
#endif
}

// ---- n = 1, 2 < n <= 16: a segment of lanes a matrix, shared memory ---------------

// A class of widths: matrices up to NP wide, S lanes each (32 / S a warp);
// lane q of a segment, at (rg, cg) = (q / CG, q % CG) on an RG x CG grid
// (RG = ceil(n / TR), CG = ceil(n / TC)), owns the TR x TC tile of rows
// rg + RG a and columns cg + CG c of every matrix it forms: interleaved,
// so that the lanes of a quarter warp read distinct 16-byte bank groups
// (with the row stride LD) when they load a k-step's entries or their
// tiles. Each matrix has five NP x LD buffers and the exchange of the
// Gauss-Jordan steps (MS complex entries, odd, so that neighbouring
// segments fall on other banks). Entries past n are zero and stay zero
// (products of block-diagonal matrices; the identity is added at i < n
// only), so the tiles never test for the edge.
template <int NP_, int S_, int TR_, int TC_, int LD_> struct Cls {
  static constexpr int NP = NP_, S = S_, TR = TR_, TC = TC_, LD = LD_;
  static constexpr int BUF = NP * LD;
  static constexpr int MS = (5 * BUF + 6 * NP) | 1;
};
using ClsA = Cls<4, 4, 1, 4, 6>;
using ClsB = Cls<8, 8, 2, 4, 10>;
using ClsC = Cls<16, 16, 4, 4, 20>;

// acc = P Q over k < n on the lane's tile
template <typename T, class K>
__device__ __forceinline__ void tile_mm(C<T> (&acc)[K::TR][K::TC], const C<T>* P,
                                        const C<T>* Q, int rg, int RG, int cg, int CG,
                                        int n) {
#pragma unroll
  for (int a = 0; a < K::TR; ++a)
#pragma unroll
    for (int c = 0; c < K::TC; ++c) acc[a][c] = C<T>{T(0), T(0)};
  for (int k = 0; k < n; ++k) {
    C<T> p[K::TR], q[K::TC];
#pragma unroll
    for (int a = 0; a < K::TR; ++a) p[a] = P[(rg + RG * a) * K::LD + k];
#pragma unroll
    for (int c = 0; c < K::TC; ++c) q[c] = Q[k * K::LD + cg + CG * c];
#pragma unroll
    for (int a = 0; a < K::TR; ++a)
#pragma unroll
      for (int c = 0; c < K::TC; ++c) acc[a][c] = cfma(p[a], q[c], acc[a][c]);
  }
}

template <typename T, class K>
__global__ void __launch_bounds__(32 * kWarpsSeg)
expm_pade13_seg(const T* __restrict__ A, T* __restrict__ out, int* __restrict__ s_out,
                long long batch, int n, int max_s PX_K5_PARAM) {
  PX_SMEM(T);
  constexpr int S = K::S, TR = K::TR, TC = K::TC, LD = K::LD, NP = K::NP, G = 32 / S;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int seg = lane / S, q = lane % S;
  const long long b = ((long long)blockIdx.x * kWarpsSeg + warp) * G + seg;
  const bool valid = b < batch;
  C<T>* X = reinterpret_cast<C<T>*>(smem) + (size_t)(warp * G + seg) * K::MS;
  C<T>* X2 = X + K::BUF;
  C<T>* X4 = X + 2 * K::BUF;
  C<T>* X6 = X + 3 * K::BUF;
  C<T>* W = X + 4 * K::BUF;
  C<T>* xr = X + 5 * K::BUF;       // [2][2 NP]: pivot row of Den, then of Num
  C<T>* xc = xr + 4 * NP;          // [2][NP]: pivot column of Den
  const int CG = (n + TC - 1) / TC, RG = (n + TR - 1) / TR;
  const bool act = q < RG * CG;     // lanes without a tile only keep step
  const int rg = act ? q / CG : 0, cg = act ? q % CG : 0;
  const C<T> zero{T(0), T(0)};
#ifdef PX_K5_TIMING
  if (b != 0 || q != 0) stamps = nullptr;
  long long t_[9];
  if (stamps) { t_[7] = k5_ns(); t_[0] = clock64(); }
#endif
  // every entry of the lane's tile: i, j, the offset in a buffer
#define PX_TILE(body)                                     \
  _Pragma("unroll") for (int a = 0; a < TR; ++a)          \
  _Pragma("unroll") for (int c = 0; c < TC; ++c) {        \
    const int i = rg + RG * a, j = cg + CG * c;           \
    const int o = i * LD + j;                             \
    (void)i; (void)j;                                     \
    body                                                  \
  }

  const C<T>* in = reinterpret_cast<const C<T>*>(A) + (valid ? b : 0) * n * n;
  if (act) PX_TILE(X[o] = (valid && i < n && j < n) ? in[i * n + j] : zero;)
  __syncwarp();
  T row = T(0);
  if (q < n)
    for (int j = 0; j < n; ++j) row += modulus(X[q * LD + j]);
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1)
    row = px::nan_max(row, __shfl_xor_sync(px::kFull, row, off));
  const int s = valid ? squarings_of<T>(row, max_s) : 0;
  if (s_out && valid && q == 0) s_out[b] = s;
  const T sc = (T)ldexp(1.0, -s);
  __syncwarp();
  if (act) PX_TILE(X[o] = rmul(sc, X[o]);)
  __syncwarp();
  PX_K5_STAMP(1);

  C<T> acc[TR][TC];
#define PX_MM(dst, P, Q)                                  \
  if (act) {                                              \
    tile_mm<T, K>(acc, P, Q, rg, RG, cg, CG, n);          \
    PX_TILE(dst[o] = acc[a][c];)                          \
  }                                                       \
  __syncwarp();
  PX_MM(X2, X, X)
  PX_MM(X4, X2, X2)
  PX_MM(X6, X4, X2)
  PX_K5_STAMP(2);
  // U / b0 and V / b0 (kB13n), so that V - U = I + E. Each tail is formed
  // in acc, then stored: the loads of a tile are all in flight before its
  // first store (the compiler cannot tell that the buffers do not alias).
  if (act) {
    PX_TILE(acc[a][c] = cadd(cadd(rmul((T)kB13n[13], X6[o]), rmul((T)kB13n[11], X4[o])),
                             rmul((T)kB13n[9], X2[o]));)
    PX_TILE(W[o] = acc[a][c];)
  }
  __syncwarp();
  if (act) tile_mm<T, K>(acc, X6, W, rg, RG, cg, CG, n);
  __syncwarp();                     // W is read: overwrite it with U's factor
  if (act) {
    PX_TILE(acc[a][c] = cadd(cadd(cadd(acc[a][c], rmul((T)kB13n[7], X6[o])),
                                  rmul((T)kB13n[5], X4[o])), rmul((T)kB13n[3], X2[o]));
            if (i == j && i < n) acc[a][c].re += (T)kB13n[1];)
    PX_TILE(W[o] = acc[a][c];)
  }
  __syncwarp();
  if (act) tile_mm<T, K>(acc, X, W, rg, RG, cg, CG, n);
  __syncwarp();                     // X and W are read: U into X, V's factor into W
  if (act) {
    PX_TILE(X[o] = acc[a][c];)
    PX_TILE(acc[a][c] = cadd(cadd(rmul((T)kB13n[12], X6[o]), rmul((T)kB13n[10], X4[o])),
                             rmul((T)kB13n[8], X2[o]));)
    PX_TILE(W[o] = acc[a][c];)
  }
  __syncwarp();
  // V -/+ U, the lane's tiles of Den and Num, stay in registers
  C<T> dR[TR][TC], nR[TR][TC];
  if (act) {
    tile_mm<T, K>(acc, X6, W, rg, RG, cg, CG, n);
    PX_TILE(C<T> v = cadd(cadd(cadd(acc[a][c], rmul((T)kB13n[6], X6[o])),
                               rmul((T)kB13n[4], X4[o])), rmul((T)kB13n[2], X2[o]));
            if (i == j && i < n) v.re += T(1);
            dR[a][c] = csub(v, X[o]);
            nR[a][c] = cadd(v, X[o]);)
  }
  PX_K5_STAMP(3);

  // Gauss-Jordan on [Den | Num]: step k divides row k by the pivot and
  // clears column k from the other rows; the pivot row and column pass
  // through the exchange, double-buffered, one __syncwarp a step.
  for (int k = 0; k < n; ++k) {
    C<T>* rk = xr + (k & 1) * 2 * NP;
    C<T>* ck = xc + (k & 1) * NP;
    if (act) {
#pragma unroll
      for (int a = 0; a < TR; ++a)
        if (rg + RG * a == k)
#pragma unroll
          for (int c = 0; c < TC; ++c) {
            rk[cg + CG * c] = dR[a][c];
            rk[NP + cg + CG * c] = nR[a][c];
          }
#pragma unroll
      for (int c = 0; c < TC; ++c)
        if (cg + CG * c == k)
#pragma unroll
          for (int a = 0; a < TR; ++a) ck[rg + RG * a] = dR[a][c];
    }
    __syncwarp();
    if (act) {
      C<T> dk[TC], nk[TC], l[TR];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        dk[c] = rk[cg + CG * c];
        nk[c] = rk[NP + cg + CG * c];
      }
#pragma unroll
      for (int a = 0; a < TR; ++a) l[a] = ck[rg + RG * a];
      const C<T> pinv = crecip(rk[k]);
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        if (rg + RG * a == k) {
#pragma unroll
          for (int c = 0; c < TC; ++c) {
            dR[a][c] = cmul(dk[c], pinv);
            nR[a][c] = cmul(nk[c], pinv);
          }
        } else {
          const C<T> ml = cmul(C<T>{-l[a].re, -l[a].im}, pinv);
#pragma unroll
          for (int c = 0; c < TC; ++c) {
            dR[a][c] = cfma(ml, dk[c], dR[a][c]);
            nR[a][c] = cfma(ml, nk[c], nR[a][c]);
          }
        }
      }
    }
  }
  if (act) PX_TILE(X4[o] = nR[a][c];)   // F
  __syncwarp();
  PX_K5_STAMP(4);

  // s squarings of F (X4), ping-pong with X6; the warp runs its largest s
  int smax = s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) smax = max(smax, __shfl_xor_sync(px::kFull, smax, off));
  C<T>* F = X4;
  C<T>* Fn = X6;
  for (int t = 0; t < smax; ++t) {
    if (act) {
      if (t < s) {
        tile_mm<T, K>(acc, F, F, rg, RG, cg, CG, n);
        PX_TILE(Fn[o] = acc[a][c];)
      } else {
        PX_TILE(Fn[o] = F[o];)
      }
    }
    __syncwarp();
    C<T>* tmp = F; F = Fn; Fn = tmp;
  }
  PX_K5_STAMP(5);
  C<T>* o_ = reinterpret_cast<C<T>*>(out) + (valid ? b : 0) * n * n;
  if (act && valid) PX_TILE(if (i < n && j < n) o_[i * n + j] = F[o];)
#undef PX_MM
#undef PX_TILE
#ifdef PX_K5_TIMING
  if (stamps) { t_[6] = clock64(); k5_write(stamps, t_, s); }
#endif
}

template <typename T, class K>
int launch_seg(const void* A, void* out, int* s_out, long long batch, int n, int max_s,
               cudaStream_t st PX_K5_PARAM) {
  constexpr int per_block = kWarpsSeg * (32 / K::S);
  const long long blocks = (batch + per_block - 1) / per_block;
  const size_t smem = sizeof(C<T>) * K::MS * per_block;
  cudaError_t e = cudaFuncSetAttribute(expm_pade13_seg<T, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  expm_pade13_seg<T, K><<<(unsigned)blocks, 32 * kWarpsSeg, smem, st>>>(
      static_cast<const T*>(A), static_cast<T*>(out), s_out, batch, n, max_s PX_K5_ARG(stamps));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* A, void* out, int* s_out, long long batch, int n, int max_s,
           cudaStream_t st PX_K5_PARAM) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (n == 2) {
    expm_pade13_n2<T><<<(unsigned)((batch + kThreads2 - 1) / kThreads2), kThreads2, 0, st>>>(
        static_cast<const T*>(A), static_cast<T*>(out), s_out, batch, max_s PX_K5_ARG(stamps));
    return (int)cudaGetLastError();
  }
  if (n <= ClsA::NP)
    return launch_seg<T, ClsA>(A, out, s_out, batch, n, max_s, st PX_K5_ARG(stamps));
  if (n <= ClsB::NP)
    return launch_seg<T, ClsB>(A, out, s_out, batch, n, max_s, st PX_K5_ARG(stamps));
  return launch_seg<T, ClsC>(A, out, s_out, batch, n, max_s, st PX_K5_ARG(stamps));
}

}  // namespace

// A and out hold batch complex n x n matrices, row-major, as interleaved
// (re, im) pairs of double (is_c128) or float; s_out, when not null,
// receives each matrix's squaring count.
extern "C" int px_expm_pade13(int is_c128, const void* A, void* out, void* s_out,
                              long long batch, int n, int max_s,
                              void* stream PX_K5_PARAM) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 16) return (int)cudaErrorInvalidValue;
  int* s = static_cast<int*>(s_out);
  return is_c128 ? launch<double>(A, out, s, batch, n, max_s, st PX_K5_ARG(stamps))
                 : launch<float>(A, out, s, batch, n, max_s, st PX_K5_ARG(stamps));
}
