// K1: batched Cholesky-inverse factor, Xi with A^{-1} = Xi^T Xi.
//
// Replaces piccolax/solver/kkt.py: chol_inv_factor (with _blocked_chol_inv),
// the TPU's matmul-only recursive 2x2-block Cholesky inverse. On the H100 a
// 14 x 14 block is far too small for tensor cores; the work is latency and
// bytes: each block is read once and Xi written once, so the bound is
// memory bandwidth. The design keeps each block in one warp's shared memory
// (equilibrate, unblocked Cholesky, triangular inverse; m <= 64, a lane
// owning two rows past 32) and packs several warps per thread block so that
// loads of neighbouring blocks overlap: four, or as many as fit in 227 KB
// (the scratch is 2 m^2 + m elements a warp: 31 KB at m = 44 in float64).
#include "common.cuh"

namespace {

template <typename T>
__global__ void chol_inv_factor_kernel(const T* __restrict__ A, T* __restrict__ Xi,
                                       long long batch, int m) {
  PX_SMEM(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= batch) return;  // uniform per warp; no block-wide barrier below
  T* S = smem + warp * px::chol_scratch_elems(m);
  const long long mm = (long long)m * m;
  px::chol_inv_warp<T>(A + b * mm, m, Xi + b * mm, m, S, m, lane);
}

template <typename T>
int launch(const void* A, void* Xi, long long batch, int m, cudaStream_t st) {
  const int warps = px::warps_that_fit(sizeof(T) * px::chol_scratch_elems(m), 4);
  const long long blocks = (batch + warps - 1) / warps;
  const size_t smem = sizeof(T) * warps * px::chol_scratch_elems(m);
  if (blocks > 0) {
    cudaFuncSetAttribute(chol_inv_factor_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    chol_inv_factor_kernel<T><<<(unsigned)blocks, warps * 32, smem, st>>>(
        static_cast<const T*>(A), static_cast<T*>(Xi), batch, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int px_chol_inv_factor(int is_f64, const void* A, void* Xi,
                                  long long batch, int m, void* stream) {
  if (m < 1 || m > px::kMaxCholM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(A, Xi, batch, m, st)
                : launch<float>(A, Xi, batch, m, st);
}
