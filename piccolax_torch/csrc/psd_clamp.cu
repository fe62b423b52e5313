// K2: batched Newton-Schulz PSD clamp of symmetric blocks.
//
// Replaces piccolax/solver/kkt.py: psd_clamp, the TPU's eigh-free
// convexification (sign iteration S <- 1.5 S - 0.5 S^3, |W| = sign(W) W).
// A sweep is two n x n products of one block, both symmetric (S, P = 0.5 S S
// and P S are polynomials in W), so the function needs n^2 (n + 1)
// multiply-adds a sweep; with n up to 64 the data never leaves the SM: the
// bound is arithmetic, on a few KB.
//
// Measured on the earlier design (one thread an output entry; its inner
// loop issued two shared-memory loads a multiply-add: cuobjdump -sass,
// scripts/k2_timing.py), the shared-memory issue rate bounded it. Here:
// - widths are padded to a class NP = 16, 32, 48 or 64 with zeros, which
//   is exact (the padded rows and columns of S stay zero under the sweep),
//   and every product sums only to the width rounded up to 4;
// - float32 (FFMA, no TF32: K2's float32 results are held to 1e-4): S is
//   kept exactly symmetric, so a thread sums one 4 x 4 tile of the upper
//   triangle, reading a row of each operand (S^T = S, P^T = P: two float4
//   loads a k step for 16 multiply-adds), and stores it and its mirror;
//   each entry of P = 0.5 S S and its mirror sum the same products in the
//   same order (bit-equal), and the new S takes the upper triangle's
//   value on both sides. That halves the multiply-adds (W symmetric, see
//   below), and s reads every entry of W so that a NaN anywhere reaches
//   every entry as in the plain version. At NP = 16 three blocks a warp,
//   warp barriers only;
// - float64: the tensor cores' DMMA (mma.sync m8n8k4), 8 x 8 output tiles,
//   2 x 2 a warp at NP = 16 (a warp a block, four a thread block), NP/16 x
//   NP/16 a warp of four past it: one 8-byte load of each operand for 256
//   multiply-adds; S double-buffered, two barriers a sweep;
// - W is staged by cp.async, every load in flight at once.
//
// W must be exactly symmetric (the IPM's blocks are: 0.5 (H + H^T), masked
// by 0/1): both types test every pair W_ij, W_ji while they sum the rows
// for s, and a block that is not comes out all NaN, as a block holding a
// NaN does, rather than an answer that differs by type.
//
// Products sum over k in order and the 0.5 of 0.5 S S is applied to the
// sum (exact: a power of two), 1.5 S - P S rounded as the plain version
// rounds it; the last product |W| / s = S Y covers every entry, and the
// output is symmetrised as the plain version does.
#include "common.cuh"

namespace {

constexpr int kMaxN = 64;

__host__ __device__ constexpr int np_class(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 48 ? 48 : 64;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// The layout of one block's work: threads per block, threads and blocks
// (matrices) per thread block, and the row stride of its shared arrays.
template <typename T, int NP> struct Cfg;
// float32: a 4 x 4 tile a thread, the upper triangle's tiles only (S is
// kept exactly symmetric), T (T + 1) / 2 threads a matrix; at NP = 16
// three matrices a warp (lanes 30 and 31 idle), warp barriers only
template <int NP> struct Cfg<float, NP> {
  static constexpr int TM = 4, T = NP / TM;
  static constexpr int kPer = T * (T + 1) / 2;         // 10, 36, 78, 136
  static constexpr int kMats = NP == 16 ? 12 : NP == 32 ? 4 : NP == 48 ? 2 : 1;
  static constexpr int kThreads = NP == 16 ? 128 : kPer * kMats;
  static constexpr bool kWarp = NP == 16;
  static constexpr int LD = NP;
  static constexpr int kArrays = 3;                    // Y, S, P
};
// float64: four warps a matrix past 16, one at 16
template <int NP> struct Cfg<double, NP> {
  static constexpr int WT = NP == 16 ? 2 : NP / 16;   // 8 x 8 tiles a warp, per side
  static constexpr int kPer = NP == 16 ? 32 : 128;
  static constexpr int kMats = NP == 16 ? 4 : 1;
  static constexpr int kThreads = kPer * kMats;
  static constexpr bool kWarp = NP == 16;
  static constexpr int LD = NP + 4;                    // conflict-free fragment loads
  static constexpr int kArrays = 4;                    // Y, S x2, P
};

template <typename T, int NP>
constexpr size_t smem_bytes() {
  using C = Cfg<T, NP>;
  return (size_t)C::kMats * ((size_t)C::kArrays * NP * C::LD + NP + 4) * sizeof(T);
}

// The threads of one matrix: their warp where a warp holds whole matrices
// (NP = 16), else the thread block.
template <typename T, int NP>
__device__ __forceinline__ void msync() {
  if constexpr (Cfg<T, NP>::kWarp) __syncwarp();
  else __syncthreads();
}

// Load block b (n x n, row-major at Wb) zero-padded into Y, find s (the
// largest absolute row sum, NaN-propagating, floored at 1e-30; NaN where W
// is not exactly symmetric), scale Y = W / s and copy it into S0 (float64).
template <typename T, int NP>
__device__ T load_scale(const T* __restrict__ Wb, int n, T* Y, T* S0, T* rows, int t) {
  constexpr int LD = Cfg<T, NP>::LD, P = Cfg<T, NP>::kPer;
  for (int idx = t; idx < NP * NP; idx += P) {   // every load in flight at once
    const int i = idx / NP, j = idx % NP;
    if (i < n && j < n) px::cp_async(Y + i * LD + j, Wb + i * n + j);
    else Y[i * LD + j] = T(0);
  }
  px::cp_async_commit();
  px::cp_async_wait_group<0>();
  msync<T, NP>();
  for (int i = t; i < n; i += P) {
    T a = 0;
    bool sym = true;
    for (int k = 0; k < n; ++k) {
      a += fabs(Y[i * LD + k]);
      sym = sym && Y[i * LD + k] == Y[k * LD + i];
    }
    rows[i] = sym ? a : px::quiet_nan<T>();
  }
  msync<T, NP>();
  T s = rows[0];
  for (int k = 1; k < n; ++k) s = px::nan_max(rows[k], s);
  s = px::nan_max(s, T(1e-30));
  for (int idx = t; idx < NP * NP; idx += P) {
    const int i = idx / NP, j = idx % NP;
    const T y = Y[i * LD + j] / s;
    Y[i * LD + j] = y;
    S0[i * LD + j] = y;
  }
  msync<T, NP>();
  return s;
}

// out = 0.5 (Pd + Pd^T) s, plus floor_c max(s, 1) on the diagonal, from the
// row-major Pd in P.
template <typename T, int NP>
__device__ void write_out(const T* P, T* __restrict__ ob, int n, T s, T floor_c, int t) {
  constexpr int LD = Cfg<T, NP>::LD, Pn = Cfg<T, NP>::kPer;
  const T fl = floor_c * px::nan_max(s, T(1));
  for (int idx = t; idx < n * n; idx += Pn) {
    const int i = idx / n, j = idx % n;
    const T v = T(0.5) * (P[i * LD + j] + P[j * LD + i]) * s;
    ob[idx] = (i == j) ? v + fl : v;
  }
}

// ---------------------------------------------------------------------------
// float32: FFMA register tiles
// ---------------------------------------------------------------------------

// Four consecutive floats from / to shared memory as a float4.
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[p][q] = sum_k AT[k][i0 + p] B[k][j0 + q], k = 0, 1, ..., kn - 1 (kn:
// the width rounded up to 4; the rows past it are zero)
template <int NP>
__device__ __forceinline__ void ffma_tile(const float* AT, const float* B, int i0, int j0,
                                          int kn, float (&acc)[4][4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    float a[4], b[4];
    ld4(AT + k * NP + i0, a);
    ld4(B + k * NP + j0, b);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
  }
}

// f * acc into M's tile at (i0, j0) and, off the diagonal, its mirror at
// (j0, i0)
template <int NP>
__device__ __forceinline__ void store_sym(float* M, int i0, int j0, const float (&acc)[4][4],
                                          float f) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
    st4(M + (i0 + p) * NP + j0, f * acc[p][0], f * acc[p][1], f * acc[p][2], f * acc[p][3]);
  if (i0 != j0)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      st4(M + (j0 + q) * NP + i0, f * acc[0][q], f * acc[1][q], f * acc[2][q], f * acc[3][q]);
}

// s from every entry of W (so that a NaN anywhere reaches every entry, as
// in the plain version; NaN where W is not exactly symmetric) and Y = S =
// the upper triangle of W / s, mirrored (the result is then the plain
// version's to rounding). Each upper entry of Y is read by the thread that
// writes it and its mirror.
template <int NP>
__device__ float load_scale_sym(const float* __restrict__ Wb, int n, float* Y, float* S,
                                float* rows, int t) {
  constexpr int P = Cfg<float, NP>::kPer;
  for (int idx = t; idx < NP * NP; idx += P) {   // every load in flight at once
    const int i = idx / NP, j = idx % NP;
    if (i < n && j < n) px::cp_async(Y + idx, Wb + i * n + j);
    else Y[idx] = 0.f;
  }
  px::cp_async_commit();
  px::cp_async_wait_group<0>();
  msync<float, NP>();
  for (int i = t; i < n; i += P) {
    float a = 0;
    bool sym = true;
    for (int k = 0; k < n; ++k) {
      a += fabsf(Y[i * NP + k]);
      sym = sym && Y[i * NP + k] == Y[k * NP + i];
    }
    rows[i] = sym ? a : px::quiet_nan<float>();
  }
  msync<float, NP>();
  float s = rows[0];
  for (int k = 1; k < n; ++k) s = px::nan_max(rows[k], s);
  s = px::nan_max(s, 1e-30f);
  for (int idx = t; idx < NP * NP; idx += P) {
    const int i = idx / NP, j = idx % NP;
    if (i <= j) {
      const float y = Y[idx] / s;
      Y[idx] = y;
      Y[j * NP + i] = y;
      S[idx] = y;
      S[j * NP + i] = y;
    }
  }
  msync<float, NP>();
  return s;
}

template <int NP>
__global__ void __launch_bounds__(Cfg<float, NP>::kThreads)
psd_clamp_f32(const float* __restrict__ W, float* __restrict__ out, long long batch, int n,
              int iters, int mode_abs, float floor_c) {
  using C = Cfg<float, NP>;
  constexpr int NN = NP * NP;
  PX_SMEM(float);
  // matrix and thread in it; at NP = 16 lanes 30 and 31 of a warp hold no
  // tile (t past every loop's end) and only take part in its barriers
  const int lane = threadIdx.x & 31;
  const bool active = !C::kWarp || lane < 30;
  const int mat = C::kWarp ? 3 * (threadIdx.x >> 5) + min(lane / 10, 2) : threadIdx.x / C::kPer;
  const int t = C::kWarp ? (active ? lane % 10 : NN) : threadIdx.x % C::kPer;
  const long long b = (long long)blockIdx.x * C::kMats + mat;
  const long long bl = b < batch ? b : batch - 1;   // past the end: a copy, not stored
  // Y, S, P (pointers by arithmetic on the shared array, so that every
  // access is ld.shared / st.shared)
  float* Y = smem + (size_t)mat * (C::kArrays * NN + NP + 4);
  float* S = Y + NN;
  float* P = Y + 2 * NN;
  float* rows = Y + 3 * NN;
  const float s = load_scale_sym<NP>(W + bl * n * n, n, Y, S, rows, t);
  int u = t, ty = 0;                                // this thread's upper tile
  while (active && u >= C::T - ty) {
    u -= C::T - ty;
    ++ty;
  }
  const int i0 = 4 * ty, j0 = 4 * (ty + u), kn = (n + 3) & ~3;
  float acc[4][4];
  for (int it = 0; it < iters; ++it) {
    // P = 0.5 S S (exactly symmetric for a symmetric S: each entry and its
    // mirror sum the same products in the same order)
    if (active) {
      ffma_tile<NP>(S, S, i0, j0, kn, acc);
      store_sym<NP>(P, i0, j0, acc, 0.5f);
    }
    msync<float, NP>();
    // S <- 1.5 S - P S on the upper triangle, mirrored
    if (active) {
      ffma_tile<NP>(P, S, i0, j0, kn, acc);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float sv[4];
        ld4(S + (i0 + p) * NP + j0, sv);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = sub_rn(mul_rn(1.5f, sv[q]), acc[p][q]);
      }
      if (i0 == j0)
#pragma unroll
        for (int p = 1; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < p; ++q) acc[p][q] = acc[q][p];
    }
    msync<float, NP>();
    if (active) store_sym<NP>(S, i0, j0, acc, 1.f);
    msync<float, NP>();
  }
  // |W| / s = S Y at every entry (the upper tile, then its mirror's);
  // Pd row-major into P
  for (int half = 0; active && half < (i0 == j0 ? 1 : 2); ++half) {
    const int r0 = half ? j0 : i0, c0 = half ? i0 : j0;
    ffma_tile<NP>(S, Y, r0, c0, kn, acc);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float y[4];
      ld4(Y + (r0 + p) * NP + c0, y);
#pragma unroll
      for (int q = 0; q < 4; ++q) y[q] = mode_abs ? acc[p][q] : 0.5f * (y[q] + acc[p][q]);
      st4(P + (r0 + p) * NP + c0, y[0], y[1], y[2], y[3]);
    }
  }
  msync<float, NP>();
  if (b < batch) write_out<float, NP>(P, out + b * n * n, n, s, floor_c, t);
}

// ---------------------------------------------------------------------------
// float64: DMMA (mma.sync m8n8k4) 8 x 8 tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
      : "+d"(d0), "+d"(d1) : "d"(a), "d"(b));
}

// The warp's WT x WT tiles from tile (r0, c0): acc[p][q][e] = sum_k
// A[8 (r0 + p) + g][k] B[k][8 (c0 + q) + 2 t + e], g = lane / 4, t = lane % 4
// (the m8n8k4 fragments: A row g, column t; B row t, column g; C row g,
// columns 2 t and 2 t + 1).
template <int NP, int WT>
__device__ __forceinline__ void dmma_tiles(const double* A, const double* B, int r0, int c0,
                                           int lane, int kn, double (&acc)[WT][WT][2]) {
  constexpr int LD = Cfg<double, NP>::LD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < WT; ++p)
#pragma unroll
    for (int q = 0; q < WT; ++q) acc[p][q][0] = acc[p][q][1] = 0.0;
#pragma unroll 4
  for (int k0 = 0; k0 < kn; k0 += 4) {
    double a[WT], b[WT];
#pragma unroll
    for (int p = 0; p < WT; ++p) a[p] = A[(8 * (r0 + p) + g) * LD + k0 + t];
#pragma unroll
    for (int q = 0; q < WT; ++q) b[q] = B[(k0 + t) * LD + 8 * (c0 + q) + g];
#pragma unroll
    for (int p = 0; p < WT; ++p)
#pragma unroll
      for (int q = 0; q < WT; ++q) dmma(acc[p][q][0], acc[p][q][1], a[p], b[q]);
  }
}

template <int NP>
__global__ void __launch_bounds__(Cfg<double, NP>::kThreads)
psd_clamp_f64(const double* __restrict__ W, double* __restrict__ out, long long batch, int n,
              int iters, int mode_abs, double floor_c) {
  using C = Cfg<double, NP>;
  constexpr int WT = C::WT, LD = C::LD, NL = NP * LD;
  PX_SMEM(double);
  const int mat = threadIdx.x / C::kPer, t = threadIdx.x % C::kPer;
  const long long b = (long long)blockIdx.x * C::kMats + mat;
  if (C::kPer == 32 && b >= batch) return;
  const long long bl = b < batch ? b : batch - 1;
  // Y, S (two buffers: [1 + cur] NL on), P
  double* Y = smem + (size_t)mat * (C::kArrays * NL + NP + 4);
  double* P = Y + 3 * NL;
  double* rows = Y + 4 * NL;
  const double s = load_scale<double, NP>(W + bl * n * n, n, Y, Y + NL, rows, t);
  const int lane = t & 31, w = t >> 5;
  const int r0 = (w >> 1) * WT, c0 = (w & 1) * WT;   // the warp's first tile
  const int g = lane >> 2, tc = 2 * (lane & 3), kn = (n + 3) & ~3;
  double acc[WT][WT][2];
  int cur = 0;
  for (int it = 0; it < iters; ++it) {
    const double* Sc = Y + (1 + cur) * NL;
    double* Sn = Y + (2 - cur) * NL;
    dmma_tiles<NP, WT>(Sc, Sc, r0, c0, lane, kn, acc);
#pragma unroll
    for (int p = 0; p < WT; ++p)
#pragma unroll
      for (int q = 0; q < WT; ++q) {
        double* d = P + (8 * (r0 + p) + g) * LD + 8 * (c0 + q) + tc;
        *reinterpret_cast<double2*>(d) = make_double2(0.5 * acc[p][q][0], 0.5 * acc[p][q][1]);
      }
    msync<double, NP>();
    dmma_tiles<NP, WT>(P, Sc, r0, c0, lane, kn, acc);
#pragma unroll
    for (int p = 0; p < WT; ++p)
#pragma unroll
      for (int q = 0; q < WT; ++q) {
        const int o = (8 * (r0 + p) + g) * LD + 8 * (c0 + q) + tc;
        const double2 sv = *reinterpret_cast<const double2*>(Sc + o);
        *reinterpret_cast<double2*>(Sn + o) =
            make_double2(sub_rn(mul_rn(1.5, sv.x), acc[p][q][0]),
                         sub_rn(mul_rn(1.5, sv.y), acc[p][q][1]));
      }
    msync<double, NP>();
    cur ^= 1;
  }
  dmma_tiles<NP, WT>(Y + (1 + cur) * NL, Y, r0, c0, lane, kn, acc);
#pragma unroll
  for (int p = 0; p < WT; ++p)
#pragma unroll
    for (int q = 0; q < WT; ++q) {
      const int o = (8 * (r0 + p) + g) * LD + 8 * (c0 + q) + tc;
      const double2 y = *reinterpret_cast<const double2*>(Y + o);
      *reinterpret_cast<double2*>(P + o) =
          mode_abs ? make_double2(acc[p][q][0], acc[p][q][1])
                   : make_double2(0.5 * (y.x + acc[p][q][0]), 0.5 * (y.y + acc[p][q][1]));
    }
  msync<double, NP>();
  if (b < batch) write_out<double, NP>(P, out + b * n * n, n, s, floor_c, t);
}

template <typename T, int NP, class K>
int launch_np(K kernel, const T* W, T* out, long long batch, int n, int iters, int mode_abs,
              T floor_c, cudaStream_t st) {
  using C = Cfg<T, NP>;
  const size_t smem = smem_bytes<T, NP>();
  if (int e = px::smem_for(kernel, smem)) return e;
  const long long blocks = (batch + C::kMats - 1) / C::kMats;
  kernel<<<(unsigned)blocks, C::kThreads, smem, st>>>(W, out, batch, n, iters, mode_abs,
                                                      floor_c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* Wv, void* outv, long long batch, int n, int iters, int mode_abs,
           double floor_d, cudaStream_t st) {
  const T* W = static_cast<const T*>(Wv);
  T* out = static_cast<T*>(outv);
  const T fc = (T)floor_d;
  if (batch <= 0) return (int)cudaGetLastError();
  if constexpr (sizeof(T) == 4) {
    switch (np_class(n)) {
      case 16: return launch_np<T, 16>(psd_clamp_f32<16>, W, out, batch, n, iters, mode_abs, fc, st);
      case 32: return launch_np<T, 32>(psd_clamp_f32<32>, W, out, batch, n, iters, mode_abs, fc, st);
      case 48: return launch_np<T, 48>(psd_clamp_f32<48>, W, out, batch, n, iters, mode_abs, fc, st);
      default: return launch_np<T, 64>(psd_clamp_f32<64>, W, out, batch, n, iters, mode_abs, fc, st);
    }
  } else {
    switch (np_class(n)) {
      case 16: return launch_np<T, 16>(psd_clamp_f64<16>, W, out, batch, n, iters, mode_abs, fc, st);
      case 32: return launch_np<T, 32>(psd_clamp_f64<32>, W, out, batch, n, iters, mode_abs, fc, st);
      case 48: return launch_np<T, 48>(psd_clamp_f64<48>, W, out, batch, n, iters, mode_abs, fc, st);
      default: return launch_np<T, 64>(psd_clamp_f64<64>, W, out, batch, n, iters, mode_abs, fc, st);
    }
  }
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
