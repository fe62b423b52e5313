// K1: batched Cholesky-inverse factor, Xi with A^{-1} = Xi^T Xi.
//
// Replaces piccolax/solver/kkt.py: chol_inv_factor (with _blocked_chol_inv),
// the TPU's matmul-only recursive 2x2-block Cholesky inverse. On the H100 a
// 14 x 14 block is far too small for tensor cores; the work is latency and
// bytes: each block is read once and Xi written once, so the bound is
// memory bandwidth. Each block is staged in shared memory by coalesced
// loads and factored by common.cuh's chol_inv (rows in registers, one
// rsqrt and one pass of shuffles a pivot): one warp a block up to 32 wide,
// two past it; four warps a thread block (four blocks, or two past 32), so
// that loads of neighbouring blocks overlap.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// Blocks of one thread block: one a warp up to 32 wide, one a warp pair
// past it.
__host__ __device__ constexpr int per_block(int m) { return m > 32 ? 2 : 4; }

// Registers as cr_elim_kernel's (common.cuh chol_regs).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, px::chol_min_blocks(W, sizeof(T), kThreads))
chol_inv_factor_kernel(const T* __restrict__ A, T* __restrict__ Xi, long long batch, int m) {
  PX_SMEM(T);
  const int g = 4 / per_block(m);               // warps a block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / g, w = warp % g;
  const long long b = (long long)blockIdx.x * per_block(m) + slot;
  if (b >= batch) return;                       // uniform per warp group
  const int ld = m | 1, mm = m * m;
  T* S = smem + (size_t)slot * 2 * m * ld;     // the block, then scratch
  T* X = S + m * ld;                            // Xi
  const T* Ab = A + b * mm;
  T* Xb = Xi + b * mm;
  auto group_sync = [&]() {
    if (g == 2) px::bar_sync(1 + slot, 64);
    else __syncwarp();
  };
  for (int idx = 32 * w + lane; idx < mm; idx += 32 * g) {
    const int i = idx / m;
    S[i * ld + idx - i * m] = Ab[idx];
  }
  group_sync();
  px::chol_inv<T, W>(S, ld, X, ld, m, w, lane, S, 1 + slot);
  group_sync();
  for (int idx = 32 * w + lane; idx < mm; idx += 32 * g) {
    const int i = idx / m;
    Xb[idx] = X[i * ld + idx - i * m];
  }
}

template <typename T, int W>
int launch_w(const void* A, void* Xi, long long batch, int m, cudaStream_t st) {
  const long long blocks = (batch + per_block(m) - 1) / per_block(m);
  const size_t smem = sizeof(T) * per_block(m) * 2 * m * (m | 1);
  if (blocks > 0) {
    cudaError_t e = cudaFuncSetAttribute(chol_inv_factor_kernel<T, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    chol_inv_factor_kernel<T, W><<<(unsigned)blocks, kThreads, smem, st>>>(
        static_cast<const T*>(A), static_cast<T*>(Xi), batch, m);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* A, void* Xi, long long batch, int m, cudaStream_t st) {
  switch (px::chol_class(m)) {
    case 16: return launch_w<T, 16>(A, Xi, batch, m, st);
    case 32: return launch_w<T, 32>(A, Xi, batch, m, st);
    case 48: return launch_w<T, 48>(A, Xi, batch, m, st);
    default: return launch_w<T, 64>(A, Xi, batch, m, st);
  }
}

}  // namespace

extern "C" int px_chol_inv_factor(int is_f64, const void* A, void* Xi,
                                  long long batch, int m, void* stream) {
  if (m < 1 || m > px::kMaxCholM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(A, Xi, batch, m, st)
                : launch<float>(A, Xi, batch, m, st);
}
