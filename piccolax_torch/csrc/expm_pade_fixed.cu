// K6: batched diagonal Pade [m/m] matrix exponential (m in 3, 5, 7, 9) with
// a static squaring count and the denominator inverted by Newton-Schulz.
//
// Replaces piccolax/ops/expm.py: expm_pade_fixed (with _ns_solve), the
// collocation residual's propagator of a problem built with an integer
// pade_order. On the quickstart it runs on [B, N-1] real 4 x 4 generators
// (residuals and the line-search merit sweep) and on the 12 x 12
// block-triangular augmentations that carry the exact first and second
// derivatives. Per matrix: (m-1)/2 products for the even powers, 1 for U,
// 12 for the 6 Newton-Schulz steps, 1 for the numerator and the
// squarings, on n^2 values in and out. At 4 x 4 the bound is bytes, at
// 12 x 12 float64 arithmetic. Several matrices share a thread block, one
// thread per entry, every intermediate in shared memory; device memory
// sees each input and each result once. The Newton-Schulz inverse is kept
// (no pivoted solve): every iterate is a polynomial in A, which the
// derivative path relies on, and it is the reference's rounding path.
#include "common.cuh"

namespace {

constexpr int kNsIters = 6;

__constant__ double kPadeB[4][10] = {
    {120.0, 60.0, 12.0, 1.0},
    {30240.0, 15120.0, 3360.0, 420.0, 30.0, 1.0},
    {17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0, 1.0},
    {17643225600.0, 8821612800.0, 2075673600.0, 302702400.0, 30270240.0,
     2162160.0, 110880.0, 3960.0, 90.0, 1.0},
};

// shared buffers per matrix: X, W, V and the even powers A^2 .. A^(m-1)
// (at least two: they hold U, the Newton-Schulz iterate and the squarings)
__host__ __device__ inline int n_buffers(int order) {
  const int ev = (order - 1) / 2;
  return 3 + (ev > 2 ? ev : 2);
}

template <typename T>
__device__ __forceinline__ T matmul_entry(const T* P, const T* Q, int n, int i, int j) {
  T acc = 0;
  for (int k = 0; k < n; ++k) acc += P[i * n + k] * Q[k * n + j];
  return acc;
}

template <typename T>
__global__ void expm_pade_fixed_kernel(const T* __restrict__ A, T* __restrict__ out,
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
  const int nb = n_buffers(order);
  const int ev = (order - 1) / 2;            // even powers past the identity
  const double* c = kPadeB[(order - 3) / 2];
  T* X = smem + (size_t)local * nb * nn;
  T* W = X + nn;
  T* V = W + nn;
  T* E = V + nn;                             // E + (q - 1) nn holds A^(2q)
  X[t] = active ? A[b * nn + t] * scale : T(0);
  __syncthreads();
  E[t] = matmul_entry(X, X, n, i, j);
  __syncthreads();
  for (int q = 2; q <= ev; ++q) {
    E[(q - 1) * nn + t] = matmul_entry(E + (q - 2) * nn, E, n, i, j);
    __syncthreads();
  }
  // U_inner and V as piccolax's sum() adds them: from 0, in power order
  T w = diag ? T(c[1]) : T(0);
  T v = diag ? T(c[0]) : T(0);
  for (int q = 1; q <= ev; ++q) {
    w += T(c[2 * q + 1]) * E[(q - 1) * nn + t];
    v += T(c[2 * q]) * E[(q - 1) * nn + t];
  }
  W[t] = w;
  V[t] = v;
  __syncthreads();
  T* U = E;                                  // the powers are no longer needed
  T* Ynew = E + nn;
  U[t] = matmul_entry(X, W, n, i, j);
  __syncthreads();
  T* Den = U;
  T* Num = V;
  {
    const T u = U[t], vv = V[t];
    Den[t] = vv - u;
    Num[t] = vv + u;
  }
  T* Y = X;
  Y[t] = diag ? T(1) / T(c[0]) : T(0);
  __syncthreads();
  T* R = W;
  for (int it = 0; it < kNsIters; ++it) {
    const T r = matmul_entry(Den, Y, n, i, j);
    R[t] = (diag ? T(2) : T(0)) - r;
    __syncthreads();
    Ynew[t] = matmul_entry(Y, R, n, i, j);
    __syncthreads();
    T* tmp = Y; Y = Ynew; Ynew = tmp;
  }
  T* F = R;
  F[t] = matmul_entry(Y, Num, n, i, j);
  __syncthreads();
  T* G = Ynew;
  for (int q = 0; q < squarings; ++q) {
    G[t] = matmul_entry(F, F, n, i, j);
    __syncthreads();
    T* tmp = F; F = G; G = tmp;
  }
  if (active) out[b * nn + t] = F[t];
}

template <typename T>
int launch(const void* A, void* out, long long batch, int n, int order,
           int squarings, cudaStream_t st) {
  const int nn = n * n;
  const int mpb = nn >= 512 ? 1 : 512 / nn;
  const long long blocks = (batch + mpb - 1) / mpb;
  const size_t smem = sizeof(T) * n_buffers(order) * nn * mpb;
  if (blocks > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        expm_pade_fixed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    expm_pade_fixed_kernel<T><<<(unsigned)blocks, mpb * nn, smem, st>>>(
        static_cast<const T*>(A), static_cast<T*>(out), batch, n, order,
        squarings, (T)ldexp(1.0, -squarings));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// A and out hold batch real n x n matrices (n <= 32), row-major, of double
// (is_f64) or float; order is 3, 5, 7 or 9.
extern "C" int px_expm_pade_fixed(int is_f64, const void* A, void* out,
                                  long long batch, int n, int order,
                                  int squarings, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 32 || order < 3 || order > 9 || order % 2 == 0 || squarings < 0)
    return (int)cudaErrorInvalidValue;
  return is_f64 ? launch<double>(A, out, batch, n, order, squarings, st)
                : launch<float>(A, out, batch, n, order, squarings, st);
}
