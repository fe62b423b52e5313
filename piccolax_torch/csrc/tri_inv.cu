// K8: batched inverse of lower-triangular blocks.
//
// Replaces piccolax/solver/kkt.py: tri_lower_inv, the TPU's nilpotent
// doubling (I + N)^{-1} = prod_j (I + (-N)^(2^j)), ceil(log2 m) matmuls
// chosen because TPU float64 has no triangular solve. On the H100 an
// m x m block (m <= 64) is far too small for tensor cores and the
// substitution needs ~m^3/6 multiply-adds against 2 m^2 values in and out:
// the bound is bytes. The design is the second half of K1's warp routine:
// one warp per block, the block in shared memory, lane l computing columns
// l and l + 32 of L^{-1} by forward substitution, four warps per thread
// block (three at m = 64 in float64, what fits in 227 KB) so that loads of
// neighbouring blocks overlap. A zero on the diagonal gives inf / NaN, as
// the doubling does.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 4;

template <typename T>
__global__ void tri_lower_inv_kernel(const T* __restrict__ L_g, T* __restrict__ out,
                                     long long batch, int m) {
  PX_SMEM(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= batch) return;                  // uniform per warp
  const int mm = m * m;
  T* L = smem + (size_t)warp * 2 * mm;
  T* X = L + mm;
  const T* Lb = L_g + b * mm;
  for (int idx = lane; idx < mm; idx += 32) L[idx] = Lb[idx];
  __syncwarp();
  for (int j = lane; j < m; j += 32) {
    for (int i = 0; i < m; ++i) {
      T x = 0;
      if (i >= j) {
        T s = (i == j) ? T(1) : T(0);
        for (int k = j; k < i; ++k) s -= L[i * m + k] * X[k * m + j];
        x = s / L[i * m + i];
      }
      X[i * m + j] = x;
    }
  }
  __syncwarp();
  T* o = out + b * mm;
  for (int idx = lane; idx < mm; idx += 32) o[idx] = X[idx];
}

template <typename T>
int launch(const void* L, void* out, long long batch, int m, cudaStream_t st) {
  const int warps = px::warps_that_fit(sizeof(T) * 2 * m * m, kMaxWarps);
  const long long blocks = (batch + warps - 1) / warps;
  const size_t smem = sizeof(T) * warps * 2 * m * m;
  if (blocks > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        tri_lower_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    tri_lower_inv_kernel<T><<<(unsigned)blocks, warps * 32, smem, st>>>(
        static_cast<const T*>(L), static_cast<T*>(out), batch, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// L and out hold batch row-major m x m blocks (m <= 64) of double (is_f64)
// or float; only the lower triangle of L is read.
extern "C" int px_tri_lower_inv(int is_f64, const void* L, void* out,
                                long long batch, int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > px::kMaxCholM) return (int)cudaErrorInvalidValue;
  return is_f64 ? launch<double>(L, out, batch, m, st)
                : launch<float>(L, out, batch, m, st);
}
