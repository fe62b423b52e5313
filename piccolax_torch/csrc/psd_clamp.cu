// K2: batched Newton-Schulz PSD clamp of symmetric blocks.
//
// Replaces piccolax/solver/kkt.py: psd_clamp, the TPU's eigh-free
// convexification (sign iteration S <- 1.5 S - 0.5 S^3, |W| = sign(W) W).
// At [B*N, 14, 14] with 15 sweeps the work is ~2 * 15 * 2 n^3 flops per
// block on 784 bytes in and out: the bound is float32 arithmetic. Each
// block lives in shared memory, one thread per entry, and every sweep is
// two shared-memory products; nothing but the input and the result
// touches device memory.
#include "common.cuh"

namespace {

template <typename T>
__global__ void psd_clamp_kernel(const T* __restrict__ W, T* __restrict__ out,
                                 int n, int iters, int mode_abs, T floor_c) {
  PX_SMEM(T);
  const int nn = n * n;
  T* Y = smem;
  T* S = Y + nn;
  T* P = S + nn;
  T* rows = P + nn;
  const long long b = blockIdx.x;
  const int t = threadIdx.x, i = t / n, j = t % n;
  const T* Wb = W + b * nn;
  if (t < n) {
    T s = 0;
    for (int k = 0; k < n; ++k) s += fabs(Wb[t * n + k]);
    rows[t] = s;
  }
  __syncthreads();
  T s = rows[0];
  for (int k = 1; k < n; ++k) s = px::nan_max(rows[k], s);
  s = px::nan_max(s, T(1e-30));
  Y[t] = Wb[t] / s;
  S[t] = Y[t];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += (T(0.5) * S[i * n + k]) * S[k * n + j];
    P[t] = acc;
    __syncthreads();
    acc = 0;
    for (int k = 0; k < n; ++k) acc += P[i * n + k] * S[k * n + j];
    const T snew = T(1.5) * S[t] - acc;
    __syncthreads();
    S[t] = snew;
    __syncthreads();
  }
  T acc = 0;
  for (int k = 0; k < n; ++k) acc += S[i * n + k] * Y[k * n + j];
  P[t] = mode_abs ? acc : T(0.5) * (Y[t] + acc);
  __syncthreads();
  const T v = T(0.5) * (P[i * n + j] + P[j * n + i]) * s;
  out[b * nn + t] = (i == j) ? v + floor_c * px::nan_max(s, T(1)) : v;
}

template <typename T>
int launch(const void* W, void* out, long long batch, int n, int iters,
           int mode_abs, double floor_c, cudaStream_t st) {
  const size_t smem = sizeof(T) * (3 * n * n + n);
  if (batch > 0)
    psd_clamp_kernel<T><<<(unsigned)batch, n * n, smem, st>>>(
        static_cast<const T*>(W), static_cast<T*>(out), n, iters, mode_abs,
        (T)floor_c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int px_psd_clamp(int is_f64, const void* W, void* out,
                            long long batch, int n, int iters, int mode_abs,
                            double floor_c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(W, out, batch, n, iters, mode_abs, floor_c, st)
                : launch<float>(W, out, batch, n, iters, mode_abs, floor_c, st);
}
