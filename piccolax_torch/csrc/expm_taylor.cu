// K4: batched Paterson-Stockmeyer Taylor matrix exponential with a static
// squaring count.
//
// Replaces piccolax/ops/expm.py: expm_taylor_fixed (dispatched by
// expm_fixed), the collocation residual's propagator. On config 1 it runs
// on [B*K, N-1] real 4 x 4 generators (residual and line-search sweeps) and
// on the 12 x 12 block-triangular augmentations that carry the exact first
// and second derivatives. ~4 + squarings small products per matrix on
// n^2 values in and out: at 4 x 4 the bound is bytes, at 12 x 12 float32
// arithmetic. Several matrices share a thread block, one thread per entry,
// all powers kept in shared memory; device memory sees each input and each
// result once.
#include "common.cuh"

namespace {

__host__ __device__ inline double inv_fact(int i) {
  double f = 1.0;
  for (int k = 2; k <= i; ++k) f *= k;
  return 1.0 / f;
}

template <typename T>
__device__ __forceinline__ T cubic(int i0, const T* X, const T* X2, const T* X3,
                                   int t, bool diag) {
  T v = diag ? T(inv_fact(i0)) : T(0);
  return ((v + T(inv_fact(i0 + 1)) * X[t]) + T(inv_fact(i0 + 2)) * X2[t]) +
         T(inv_fact(i0 + 3)) * X3[t];
}

template <typename T>
__device__ __forceinline__ T matmul_entry(const T* P, const T* Q, int n, int i, int j) {
  T acc = 0;
  for (int k = 0; k < n; ++k) acc += P[i * n + k] * Q[k * n + j];
  return acc;
}

template <typename T>
__global__ void expm_taylor_kernel(const T* __restrict__ A, T* __restrict__ out,
                                   long long batch, int n, int order,
                                   int squarings, T scale) {
  PX_SMEM(T);
  const int nn = n * n;
  const int mpb = blockDim.x / nn;
  const int local = threadIdx.x / nn, t = threadIdx.x % nn;
  const int i = t / n, j = t % n;
  const bool diag = (i == j);
  const long long b = (long long)blockIdx.x * mpb + local;
  const bool active = b < batch;
  T* X = smem + (size_t)local * 6 * nn;
  T* X2 = X + nn;
  T* X3 = X2 + nn;
  T* X4 = X3 + nn;
  T* F = X4 + nn;
  T* R = F + nn;
  X[t] = active ? A[b * nn + t] * scale : T(0);
  __syncthreads();
  X2[t] = matmul_entry(X, X, n, i, j);
  __syncthreads();
  X3[t] = matmul_entry(X2, X, n, i, j);
  X4[t] = matmul_entry(X2, X2, n, i, j);
  __syncthreads();
  T* res;
  if (order == 8) {
    R[t] = cubic(4, X, X2, X3, t, diag) + T(inv_fact(8)) * X4[t];     // B1
    __syncthreads();
    F[t] = cubic(0, X, X2, X3, t, diag) + matmul_entry(X4, R, n, i, j);
    res = F;
  } else {
    R[t] = cubic(8, X, X2, X3, t, diag) + T(inv_fact(12)) * X4[t];    // B2
    __syncthreads();
    F[t] = cubic(4, X, X2, X3, t, diag) + matmul_entry(X4, R, n, i, j);  // B1 + A4 B2
    __syncthreads();
    R[t] = cubic(0, X, X2, X3, t, diag) + matmul_entry(X4, F, n, i, j);
    res = R;
  }
  __syncthreads();
  T* other = (res == F) ? R : F;
  for (int q = 0; q < squarings; ++q) {
    other[t] = matmul_entry(res, res, n, i, j);
    __syncthreads();
    T* tmp = res; res = other; other = tmp;
  }
  if (active) out[b * nn + t] = res[t];
}

template <typename T>
int launch(const void* A, void* out, long long batch, int n, int order,
           int squarings, cudaStream_t st) {
  const int nn = n * n;
  const int mpb = nn >= 256 ? 1 : 256 / nn;
  const long long blocks = (batch + mpb - 1) / mpb;
  const size_t smem = sizeof(T) * 6 * nn * mpb;
  if (blocks > 0) {
    cudaFuncSetAttribute(expm_taylor_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    expm_taylor_kernel<T><<<(unsigned)blocks, mpb * nn, smem, st>>>(
        static_cast<const T*>(A), static_cast<T*>(out), batch, n, order,
        squarings, (T)ldexp(1.0, -squarings));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int px_expm_taylor(int is_f64, const void* A, void* out,
                              long long batch, int n, int order, int squarings,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(A, out, batch, n, order, squarings, st)
                : launch<float>(A, out, batch, n, order, squarings, st);
}
