// K2: batched Newton-Schulz PSD clamp of symmetric blocks.
//
// Replaces piccolax/solver/kkt.py: psd_clamp, the TPU's eigh-free
// convexification (sign iteration S <- 1.5 S - 0.5 S^3, |W| = sign(W) W).
// At [B*N, 14, 14] with 15 sweeps the work is ~2 * 15 * 2 n^3 flops per
// block on 784 bytes in and out: the bound is float32 arithmetic. Each
// block lives in shared memory, one thread per entry (a few entries per
// thread past 1024 of them: config 3's blocks are 44 x 44, the limit
// 64 x 64), and every sweep is two shared-memory products; nothing but the
// input and the result touches device memory.
#include "common.cuh"

namespace {

// Entries one thread owns at most: n <= 64 gives n^2 <= 4096 entries over
// at most 1024 threads.
constexpr int kMaxN = 64;
constexpr int kMaxThreads = 1024;
constexpr int kPer = kMaxN * kMaxN / kMaxThreads;

template <typename T>
__global__ void psd_clamp_kernel(const T* __restrict__ W, T* __restrict__ out,
                                 int n, int iters, int mode_abs, T floor_c) {
  PX_SMEM(T);
  const int nn = n * n, nt = blockDim.x, tid = threadIdx.x;
  T* Y = smem;
  T* S = Y + nn;
  T* P = S + nn;
  T* rows = P + nn;
  const long long b = blockIdx.x;
  const T* Wb = W + b * nn;
  for (int t = tid; t < n; t += nt) {
    T s = 0;
    for (int k = 0; k < n; ++k) s += fabs(Wb[t * n + k]);
    rows[t] = s;
  }
  __syncthreads();
  T s = rows[0];
  for (int k = 1; k < n; ++k) s = px::nan_max(rows[k], s);
  s = px::nan_max(s, T(1e-30));
  for (int t = tid; t < nn; t += nt) {
    Y[t] = Wb[t] / s;
    S[t] = Y[t];
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int t = tid; t < nn; t += nt) {
      const int i = t / n, j = t % n;
      T acc = 0;
      for (int k = 0; k < n; ++k) acc += (T(0.5) * S[i * n + k]) * S[k * n + j];
      P[t] = acc;
    }
    __syncthreads();
    T snew[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int t = tid + e * nt;
      if (t < nn) {
        const int i = t / n, j = t % n;
        T acc = 0;
        for (int k = 0; k < n; ++k) acc += P[i * n + k] * S[k * n + j];
        snew[e] = T(1.5) * S[t] - acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int t = tid + e * nt;
      if (t < nn) S[t] = snew[e];
    }
    __syncthreads();
  }
  for (int t = tid; t < nn; t += nt) {
    const int i = t / n, j = t % n;
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += S[i * n + k] * Y[k * n + j];
    P[t] = mode_abs ? acc : T(0.5) * (Y[t] + acc);
  }
  __syncthreads();
  for (int t = tid; t < nn; t += nt) {
    const int i = t / n, j = t % n;
    const T v = T(0.5) * (P[i * n + j] + P[j * n + i]) * s;
    out[b * nn + t] = (i == j) ? v + floor_c * px::nan_max(s, T(1)) : v;
  }
}

// One thread per entry up to 1024 threads (n <= 32), the entries t,
// t + 1024, ... of one thread above (n <= 64); 3 n^2 + n elements of shared
// memory, 46.8 KB at n = 44 in float64.
template <typename T>
int launch(const void* W, void* out, long long batch, int n, int iters,
           int mode_abs, double floor_c, cudaStream_t st) {
  const size_t smem = sizeof(T) * (3 * n * n + n);
  const int threads = n * n < kMaxThreads ? (n * n + 31) / 32 * 32 : kMaxThreads;
  if (batch > 0) {
    cudaFuncSetAttribute(psd_clamp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    psd_clamp_kernel<T><<<(unsigned)batch, threads, smem, st>>>(
        static_cast<const T*>(W), static_cast<T*>(out), n, iters, mode_abs,
        (T)floor_c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int px_psd_clamp(int is_f64, const void* W, void* out,
                            long long batch, int n, int iters, int mode_abs,
                            double floor_c, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(W, out, batch, n, iters, mode_abs, floor_c, st)
                : launch<float>(W, out, batch, n, iters, mode_abs, floor_c, st);
}
