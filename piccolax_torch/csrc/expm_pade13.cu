// K5: batched scaling-and-squaring Pade-13 matrix exponential of complex
// matrices, with a squaring count per matrix.
//
// Replaces piccolax/ops/expm.py:74 expm (with _pade13 :59 and _ns_solve :44), the
// propagator of every rollout (the trajectory's construction, the re-sync
// after a solve, the rollout-fidelity check). Each matrix takes its own
// s = clamp(ceil(log2(||A||_inf / 0.95)), 0, max_squarings) in the real
// type of its entries, is scaled by 2^-s, goes through Pade-13's U and V,
// F = (V - U)^-1 (V + U) with the inverse from 8 Newton-Schulz steps from
// I / b0 (the arithmetic of the JAX function, so s and the rounding path
// stay its own), and is squared s times.
//
// Bound on the H100: float64 arithmetic outside the tensor cores. A 2 x 2
// matrix takes 23 + s complex 2 x 2 products (56 flops each; 16 of them
// are the Newton-Schulz inverse) and ~300 flops elementwise, ~2k flops at
// s = 8, against 128 bytes in and out. The design keeps every intermediate out of device
// memory: at n = 2 one thread owns one matrix in registers; for
// 2 < n <= 16 one warp owns one matrix in shared memory, each lane a
// strided set of its entries. Device memory sees each input and result
// once, read and written as interleaved (re, im) pairs.
#include "common.cuh"

namespace {

__constant__ double kB13[14] = {
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0,  129060195264000.0,   10559470521600.0,
    670442572800.0,      33522128640.0,       1323241920.0,
    40840800.0,          960960.0,            16380.0,
    182.0,               1.0};

constexpr int kNsIters = 8;
constexpr int kWarpsPerBlock = 4;
constexpr int kThreads2 = 128;

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
template <typename T> __device__ __forceinline__ C<T> rmul(T r, C<T> a) {
  return {r * a.re, r * a.im};
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

// ---- n = 2: one thread, registers ------------------------------------------

template <typename T> struct M2 { C<T> a, b, c, d; };   // [[a, b], [c, d]]

template <typename T> __device__ __forceinline__ M2<T> mm(const M2<T>& p, const M2<T>& q) {
  return {cadd(cmul(p.a, q.a), cmul(p.b, q.c)), cadd(cmul(p.a, q.b), cmul(p.b, q.d)),
          cadd(cmul(p.c, q.a), cmul(p.d, q.c)), cadd(cmul(p.c, q.b), cmul(p.d, q.d))};
}
template <typename T> __device__ __forceinline__ M2<T> lin3(T x, const M2<T>& p, T y,
                                                           const M2<T>& q, T z,
                                                           const M2<T>& r) {
  return {cadd(cadd(rmul(x, p.a), rmul(y, q.a)), rmul(z, r.a)),
          cadd(cadd(rmul(x, p.b), rmul(y, q.b)), rmul(z, r.b)),
          cadd(cadd(rmul(x, p.c), rmul(y, q.c)), rmul(z, r.c)),
          cadd(cadd(rmul(x, p.d), rmul(y, q.d)), rmul(z, r.d))};
}
// p + x*q + y*r + z*s + w*I, added left to right
template <typename T> __device__ __forceinline__ M2<T> tail(const M2<T>& p, T x,
                                                           const M2<T>& q, T y,
                                                           const M2<T>& r, T z,
                                                           const M2<T>& s, T w) {
  M2<T> o;
  o.a = cadd(cadd(cadd(cadd(p.a, rmul(x, q.a)), rmul(y, r.a)), rmul(z, s.a)), C<T>{w, T(0)});
  o.b = cadd(cadd(cadd(p.b, rmul(x, q.b)), rmul(y, r.b)), rmul(z, s.b));
  o.c = cadd(cadd(cadd(p.c, rmul(x, q.c)), rmul(y, r.c)), rmul(z, s.c));
  o.d = cadd(cadd(cadd(cadd(p.d, rmul(x, q.d)), rmul(y, r.d)), rmul(z, s.d)), C<T>{w, T(0)});
  return o;
}

template <typename T>
__global__ void expm_pade13_n2(const T* __restrict__ A, T* __restrict__ out,
                               int* __restrict__ s_out, long long batch, int max_s) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const C<T>* in = reinterpret_cast<const C<T>*>(A) + b * 4;
  M2<T> X{in[0], in[1], in[2], in[3]};
  const T norm = px::nan_max(modulus(X.a) + modulus(X.b), modulus(X.c) + modulus(X.d));
  const int s = squarings_of<T>(norm, max_s);
  if (s_out) s_out[b] = s;
  const T sc = (T)ldexp(1.0, -s);
  X = {rmul(sc, X.a), rmul(sc, X.b), rmul(sc, X.c), rmul(sc, X.d)};
  const M2<T> X2 = mm(X, X), X4 = mm(X2, X2), X6 = mm(X4, X2);
  const T b0 = (T)kB13[0];
  M2<T> W = lin3((T)kB13[13], X6, (T)kB13[11], X4, (T)kB13[9], X2);
  const M2<T> U = mm(X, tail(mm(X6, W), (T)kB13[7], X6, (T)kB13[5], X4,
                             (T)kB13[3], X2, (T)kB13[1]));
  W = lin3((T)kB13[12], X6, (T)kB13[10], X4, (T)kB13[8], X2);
  const M2<T> V = tail(mm(X6, W), (T)kB13[6], X6, (T)kB13[4], X4, (T)kB13[2], X2, b0);
  const M2<T> Den{csub(V.a, U.a), csub(V.b, U.b), csub(V.c, U.c), csub(V.d, U.d)};
  const M2<T> Num{cadd(V.a, U.a), cadd(V.b, U.b), cadd(V.c, U.c), cadd(V.d, U.d)};
  const T inv_b0 = T(1) / b0;
  M2<T> Y{{inv_b0, T(0)}, {T(0), T(0)}, {T(0), T(0)}, {inv_b0, T(0)}};
  for (int it = 0; it < kNsIters; ++it) {
    M2<T> R = mm(Den, Y);
    R = {csub(C<T>{T(2), T(0)}, R.a), csub(C<T>{T(0), T(0)}, R.b),
         csub(C<T>{T(0), T(0)}, R.c), csub(C<T>{T(2), T(0)}, R.d)};
    Y = mm(Y, R);
  }
  M2<T> F = mm(Y, Num);
  for (int q = 0; q < s; ++q) F = mm(F, F);
  C<T>* o = reinterpret_cast<C<T>*>(out) + b * 4;
  o[0] = F.a; o[1] = F.b; o[2] = F.c; o[3] = F.d;
}

// ---- 2 < n <= 16: one warp, shared memory ----------------------------------

constexpr int kBuffers = 8;

// dst = P @ Q on the lane's entries (dst distinct from P and Q)
template <typename T>
__device__ __forceinline__ void wmm(C<T>* dst, const C<T>* P, const C<T>* Q, int n,
                                    int lane) {
  for (int idx = lane; idx < n * n; idx += 32) {
    const int i = idx / n, j = idx % n;
    C<T> acc{T(0), T(0)};
    for (int k = 0; k < n; ++k) acc = cadd(acc, cmul(P[i * n + k], Q[k * n + j]));
    dst[idx] = acc;
  }
  __syncwarp();
}

template <typename T>
__global__ void expm_pade13_warp(const T* __restrict__ A, T* __restrict__ out,
                                 int* __restrict__ s_out, long long batch, int n,
                                 int max_s) {
  PX_SMEM(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= batch) return;                    // whole warps leave together
  const int nn = n * n;
  C<T>* buf = reinterpret_cast<C<T>*>(smem) + (size_t)warp * kBuffers * nn;
  C<T>* X = buf;
  C<T>* X2 = buf + nn;
  C<T>* X4 = buf + 2 * nn;
  C<T>* X6 = buf + 3 * nn;
  C<T>* U = buf + 4 * nn;
  C<T>* V = buf + 5 * nn;
  C<T>* T1 = buf + 6 * nn;
  C<T>* T2 = buf + 7 * nn;
  const C<T>* in = reinterpret_cast<const C<T>*>(A) + b * nn;

  for (int idx = lane; idx < nn; idx += 32) X[idx] = in[idx];
  __syncwarp();
  T row = T(0);
  if (lane < n)
    for (int j = 0; j < n; ++j) row += modulus(X[lane * n + j]);
  for (int off = 16; off > 0; off >>= 1)
    row = px::nan_max(row, __shfl_xor_sync(0xffffffffu, row, off));
  const int s = squarings_of<T>(row, max_s);
  if (s_out && lane == 0) s_out[b] = s;
  const T sc = (T)ldexp(1.0, -s);
  for (int idx = lane; idx < nn; idx += 32) X[idx] = rmul(sc, X[idx]);
  __syncwarp();

  wmm(X2, X, X, n, lane);
  wmm(X4, X2, X2, n, lane);
  wmm(X6, X4, X2, n, lane);
  for (int idx = lane; idx < nn; idx += 32)
    T1[idx] = cadd(cadd(rmul((T)kB13[13], X6[idx]), rmul((T)kB13[11], X4[idx])),
                   rmul((T)kB13[9], X2[idx]));
  __syncwarp();
  wmm(T2, X6, T1, n, lane);
  for (int idx = lane; idx < nn; idx += 32) {
    C<T> v = cadd(cadd(cadd(T2[idx], rmul((T)kB13[7], X6[idx])), rmul((T)kB13[5], X4[idx])),
                  rmul((T)kB13[3], X2[idx]));
    if (idx / n == idx % n) v = cadd(v, C<T>{(T)kB13[1], T(0)});
    T2[idx] = v;
    T1[idx] = cadd(cadd(rmul((T)kB13[12], X6[idx]), rmul((T)kB13[10], X4[idx])),
                   rmul((T)kB13[8], X2[idx]));
  }
  __syncwarp();
  wmm(U, X, T2, n, lane);
  wmm(V, X6, T1, n, lane);
  const T b0 = (T)kB13[0], inv_b0 = T(1) / b0;
  C<T>* Den = X2;                           // the powers are no longer needed
  C<T>* Num = X4;
  C<T>* Y = X6;
  C<T>* Ynew = X;
  for (int idx = lane; idx < nn; idx += 32) {
    const bool diag = idx / n == idx % n;
    C<T> v = cadd(cadd(cadd(V[idx], rmul((T)kB13[6], X6[idx])), rmul((T)kB13[4], X4[idx])),
                  rmul((T)kB13[2], X2[idx]));
    if (diag) v = cadd(v, C<T>{b0, T(0)});
    V[idx] = v;
  }
  __syncwarp();
  for (int idx = lane; idx < nn; idx += 32) {
    Den[idx] = csub(V[idx], U[idx]);
    Num[idx] = cadd(V[idx], U[idx]);
    Y[idx] = C<T>{idx / n == idx % n ? inv_b0 : T(0), T(0)};
  }
  __syncwarp();
  for (int it = 0; it < kNsIters; ++it) {
    wmm(T1, Den, Y, n, lane);
    for (int idx = lane; idx < nn; idx += 32)
      T1[idx] = csub(C<T>{idx / n == idx % n ? T(2) : T(0), T(0)}, T1[idx]);
    __syncwarp();
    wmm(Ynew, Y, T1, n, lane);
    C<T>* t = Y; Y = Ynew; Ynew = t;
  }
  C<T>* F = T2;
  wmm(F, Y, Num, n, lane);
  C<T>* G = T1;
  for (int q = 0; q < s; ++q) {
    wmm(G, F, F, n, lane);
    C<T>* t = F; F = G; G = t;
  }
  C<T>* o = reinterpret_cast<C<T>*>(out) + b * nn;
  for (int idx = lane; idx < nn; idx += 32) o[idx] = F[idx];
}

template <typename T>
int launch(const void* A, void* out, int* s_out, long long batch, int n, int max_s,
           cudaStream_t st) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (n == 2) {
    const long long blocks = (batch + kThreads2 - 1) / kThreads2;
    expm_pade13_n2<T><<<(unsigned)blocks, kThreads2, 0, st>>>(
        static_cast<const T*>(A), static_cast<T*>(out), s_out, batch, max_s);
  } else {
    const long long blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const size_t smem = sizeof(C<T>) * kBuffers * n * n * kWarpsPerBlock;
    cudaFuncSetAttribute(expm_pade13_warp<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    expm_pade13_warp<T><<<(unsigned)blocks, 32 * kWarpsPerBlock, smem, st>>>(
        static_cast<const T*>(A), static_cast<T*>(out), s_out, batch, n, max_s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// A and out hold batch complex n x n matrices, row-major, as interleaved
// (re, im) pairs of double (is_c128) or float; s_out, when not null,
// receives each matrix's squaring count.
extern "C" int px_expm_pade13(int is_c128, const void* A, void* out, void* s_out,
                              long long batch, int n, int max_s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 16) return (int)cudaErrorInvalidValue;
  int* s = static_cast<int*>(s_out);
  return is_c128 ? launch<double>(A, out, s, batch, n, max_s, st)
                 : launch<float>(A, out, s, batch, n, max_s, st);
}
