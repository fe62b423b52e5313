// Shared device routines of the port's kernels (built for sm_90a).
//
// chol_inv_warp is the device form of piccolax.solver.kkt.chol_inv_factor:
// one warp turns one SPD m x m block (m <= 32) into the lower-triangular Xi
// with A^{-1} = Xi^T Xi. The K1 kernel (chol_inv.cu) runs it on the knot
// blocks; the cyclic-reduction factor (condensed_cr.cu) runs it on every
// reduced diagonal block.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace px {

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

// Shared scratch chol_inv_warp needs, in elements of T.
__host__ __device__ inline int chol_scratch_elems(int m) { return 2 * m * m + m; }

// Xi (row-major, leading dimension ldx) of the SPD block A (leading
// dimension lda). A and Xi may live in global or shared memory; S holds
// chol_scratch_elems(m) elements of shared memory private to this warp.
// Must be called by all 32 lanes of the warp. A block with a non-positive
// (or NaN) pivot gives an all-NaN Xi: the caller's PD test.
template <typename T>
__device__ void chol_inv_warp(const T* A, int lda, T* Xi, int ldx, T* S,
                              int m, int lane) {
  T* L = S;              // equilibrated matrix, then its Cholesky factor
  T* W = S + m * m;      // L^{-1}
  T* d = S + 2 * m * m;  // equilibration scales
  for (int i = lane; i < m; i += 32) d[i] = sqrt(nan_max(A[i * lda + i], diag_tiny<T>()));
  __syncwarp();
  for (int idx = lane; idx < m * m; idx += 32) {
    int i = idx / m, j = idx % m;
    L[idx] = A[i * lda + j] / d[i] / d[j];
  }
  __syncwarp();
  // left-looking Cholesky, lane i owns row i
  bool ok = true;
  for (int j = 0; j < m; ++j) {
    T v = 0;
    if (lane >= j && lane < m) {
      v = L[lane * m + j];
      for (int k = 0; k < j; ++k) v -= L[lane * m + k] * L[j * m + k];
    }
    T piv = __shfl_sync(0xffffffffu, v, j);
    ok = ok && (piv > T(0));
    T ljj = sqrt(piv);
    __syncwarp();
    if (lane == j) L[j * m + j] = ljj;
    else if (lane > j && lane < m) L[lane * m + j] = v / ljj;
    __syncwarp();
  }
  // lane j: column j of L^{-1} by forward substitution
  if (lane < m) {
    const int j = lane;
    for (int i = 0; i < m; ++i) {
      T x = 0;
      if (i >= j) {
        T s = (i == j) ? T(1) : T(0);
        for (int k = j; k < i; ++k) s -= L[i * m + k] * W[k * m + j];
        x = s / L[i * m + i];
      }
      W[i * m + j] = x;
    }
  }
  __syncwarp();
  for (int idx = lane; idx < m * m; idx += 32) {
    int i = idx / m, j = idx % m;
    Xi[i * ldx + j] = ok ? W[idx] / d[j] : quiet_nan<T>();
  }
  __syncwarp();
}

}  // namespace px

#define PX_SMEM(T) \
  extern __shared__ __align__(16) unsigned char px_smem_raw[]; \
  T* smem = reinterpret_cast<T*>(px_smem_raw)
