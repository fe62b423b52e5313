// K8: batched inverse of lower-triangular blocks.
//
// Replaces piccolax/solver/kkt.py:58 tri_lower_inv, the TPU's nilpotent
// doubling (I + N)^{-1} = prod_j (I + (-N)^(2^j)), ceil(log2 m) matmuls
// chosen because TPU float64 has no triangular solve. On the H100 the
// forward substitution needs ~m^3/6 multiply-adds (44k at m = 64) against
// L's lower triangle in and the m x m inverse out: the bound is bytes.
//
// Design: a thread owns column j of X = L^{-1}, in registers (x[k] =
// X(k, j), unrolled over a width class M = 8, 16, 32, 48 or 64), and forms
// it row by row, x[i] = (delta_ij - sum_{k<i} L(i, k) x[k]) / L(i, i), the
// sum in two chains. Every thread of a matrix runs the same rows, reading
// L(i, k..k+V-1) from shared memory at the same address (a broadcast, V =
// 2 entries a 16-byte load in float64, 4 in float32), and multiplies the
// zeros above its own column rather than branch: no lane waits on another
// lane's longer column, and a shared load feeds V multiply-adds (the
// earlier design gave lane j columns j and j + 32, two shared loads a
// multiply-add, lane 0 a chain of ~2,500 at m = 64). A warp skips the rows
// and the chunks above its first column. Threads a matrix: M up to 32
// (four matrices a warp at M = 8, two at 16), 64 at 48 and 64 (two warps);
// 128 threads a block. Only L's lower triangle is read (by cp.async into
// shared memory, M x (M + 4) a matrix: at most 34 KB in float64, so three
// blocks, twelve warps, fit an SM at m = 64); the whole m x m inverse is
// written, zeros above the diagonal, each row by consecutive threads.
// A zero on the diagonal makes the whole block NaN at m >= 3, as the
// doubling's products do; at m <= 2 the doubling takes no product, and the
// kernel writes its one-step form, so that the same entries stay finite.
//
// Under the compile-time switch PX_K8_TIMING (off in every other build) the
// entry point takes one more argument, a stamps buffer: thread 0 of block
// 0 writes clock64() at its start [0], after the load [1], the
// substitution [2] and the store [3], %globaltimer at its start [4] and end
// [5], and the most [6] and fewest [7] cycles a lane of its warp spent in
// the substitution; scripts/k5_k8_timing.py builds and reads it.
#include "common.cuh"

#ifdef PX_K8_TIMING
#define PX_K8_PARAM , long long* stamps
#define PX_K8_ARG(p) , (p)
#else
#define PX_K8_PARAM
#define PX_K8_ARG(p)
#endif

namespace {

constexpr int kThreads = 128;

template <int M_> struct Width {
  static constexpr int M = M_;
  static constexpr int PT = M_ <= 32 ? M_ : 64;      // threads a matrix
  static constexpr int LD = M_ + 4;                  // vector loads stay in the row
  static constexpr int PER_BLOCK = kThreads / PT;
  static constexpr int ELEMS = M_ * LD + M_;         // L, then 1 / L(i, i)
};

// s0 -= L(i, k) x[k], s1 -= L(i, k + 1) x[k + 1], ... over one 16-byte load
__device__ __forceinline__ void chunk(const double* row, const double* x, double& s0,
                                      double& s1) {
  const double2 v = *reinterpret_cast<const double2*>(row);
  s0 = fma(-v.x, x[0], s0);
  s1 = fma(-v.y, x[1], s1);
}
__device__ __forceinline__ void chunk(const float* row, const float* x, float& s0,
                                      float& s1) {
  const float4 v = *reinterpret_cast<const float4*>(row);
  s0 = fmaf(-v.x, x[0], s0);
  s1 = fmaf(-v.y, x[1], s1);
  s0 = fmaf(-v.z, x[2], s0);
  s1 = fmaf(-v.w, x[3], s1);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
tri_lower_inv_kernel(const T* __restrict__ L_g, T* __restrict__ out, long long batch,
                     int m PX_K8_PARAM) {
  using W = Width<M>;
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int LD = W::LD;
  PX_SMEM(T);
  __shared__ int bad[W::PER_BLOCK];
  const int slot = threadIdx.x / W::PT, j = threadIdx.x % W::PT;
  const long long b = (long long)blockIdx.x * W::PER_BLOCK + slot;
  const bool valid = b < batch;
  T* Ls = smem + (size_t)slot * W::ELEMS;
  T* invd = Ls + M * LD;
#ifdef PX_K8_TIMING
  if (blockIdx.x != 0) stamps = nullptr;
  long long t_[6];
  if (stamps && threadIdx.x == 0) {
    t_[0] = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_[4]));
  }
#endif
  if (j == 0) bad[slot] = 0;
  if (valid) {
    const T* Lb = L_g + b * m * m;
    for (int i = 0; i < m; ++i)
      for (int k = j; k <= i; k += W::PT) px::cp_async(Ls + i * LD + k, Lb + (long long)i * m + k);
    // a row's last vector load reaches V - 2 entries past the diagonal
    if (j < m)
      for (int k = j + 1; k < j + V - 1; ++k) Ls[j * LD + k] = T(0);
  }
  px::cp_async_commit();
  px::cp_async_wait_group<0>();
  __syncthreads();
  if (valid && j < m) {
    const T d = Ls[j * LD + j];
    invd[j] = T(1) / d;
    if (d == T(0)) bad[slot] = 1;
  }
  __syncthreads();
#ifdef PX_K8_TIMING
  if (stamps && threadIdx.x == 0) t_[1] = clock64();
  const long long c0 = clock64();
#endif
  T x[M + V];
#pragma unroll
  for (int k = 0; k < M + V; ++k) x[k] = T(0);
  const int lo = M > 32 ? (j / 32) * 32 : 0;          // the warp's first column
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i < m && i >= lo) {
      T s0 = i == j ? T(1) : T(0), s1 = T(0);
      const T* row = Ls + i * LD;
#pragma unroll
      for (int k = 0; k < i; k += V)
        if (k + V > lo) chunk(row + k, x + k, s0, s1);
      x[i] = (s0 + s1) * invd[i];
    }
  }
#ifdef PX_K8_TIMING
  long long busy = clock64() - c0;
  if (stamps && threadIdx.x == 0) t_[2] = clock64();
#endif
  if (valid && j < m) {
    T* o = out + b * m * m + j;
    if (m <= 2) {
      // the doubling takes no step: (2 delta_ij - L(i, j) / L(i, i)) / L(j, j)
      for (int i = 0; i < m; ++i)
        o[(long long)i * m] = ((i == j ? T(2) : T(0)) - (i >= j ? Ls[i * LD + j] : T(0))
                               / Ls[i * LD + i]) / Ls[j * LD + j];
    } else {
      const bool nan_block = bad[slot] != 0;
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (i < m) o[(long long)i * m] = nan_block ? T(NAN) : x[i];
    }
  }
#ifdef PX_K8_TIMING
  if (stamps && threadIdx.x < 32) {
    long long hi = busy, lo_ = busy;
    for (int off = 16; off > 0; off >>= 1) {
      hi = max(hi, __shfl_xor_sync(px::kFull, hi, off));
      lo_ = min(lo_, __shfl_xor_sync(px::kFull, lo_, off));
    }
    if (threadIdx.x == 0) {
      t_[3] = clock64();
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_[5]));
      for (int i = 0; i < 6; ++i) stamps[i] = t_[i];
      stamps[6] = hi;
      stamps[7] = lo_;
    }
  }
#endif
}

template <typename T, int M>
int launch_w(const void* L, void* out, long long batch, int m, cudaStream_t st PX_K8_PARAM) {
  using W = Width<M>;
  const long long blocks = (batch + W::PER_BLOCK - 1) / W::PER_BLOCK;
  const size_t smem = sizeof(T) * W::ELEMS * W::PER_BLOCK;
  if (blocks > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        tri_lower_inv_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    tri_lower_inv_kernel<T, M><<<(unsigned)blocks, kThreads, smem, st>>>(
        static_cast<const T*>(L), static_cast<T*>(out), batch, m PX_K8_ARG(stamps));
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* L, void* out, long long batch, int m, cudaStream_t st PX_K8_PARAM) {
  if (m <= 8) return launch_w<T, 8>(L, out, batch, m, st PX_K8_ARG(stamps));
  if (m <= 16) return launch_w<T, 16>(L, out, batch, m, st PX_K8_ARG(stamps));
  if (m <= 32) return launch_w<T, 32>(L, out, batch, m, st PX_K8_ARG(stamps));
  if (m <= 48) return launch_w<T, 48>(L, out, batch, m, st PX_K8_ARG(stamps));
  return launch_w<T, 64>(L, out, batch, m, st PX_K8_ARG(stamps));
}

}  // namespace

// L and out hold batch row-major m x m blocks (m <= 64) of double (is_f64)
// or float; only the lower triangle of L is read.
extern "C" int px_tri_lower_inv(int is_f64, const void* L, void* out,
                                long long batch, int m, void* stream PX_K8_PARAM) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > px::kMaxCholM) return (int)cudaErrorInvalidValue;
  return is_f64 ? launch<double>(L, out, batch, m, st PX_K8_ARG(stamps))
                : launch<float>(L, out, batch, m, st PX_K8_ARG(stamps));
}
