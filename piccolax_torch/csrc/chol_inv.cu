// K1: batched Cholesky-inverse factor, Xi with A^{-1} = Xi^T Xi.
//
// Replaces piccolax/solver/kkt.py: chol_inv_factor (with _blocked_chol_inv),
// the TPU's matmul-only recursive 2x2-block Cholesky inverse. On the H100 a
// 14 x 14 block is far too small for tensor cores; each block is read once
// and Xi written once, so the bound is memory bandwidth.
//
// Measured on the earlier design (common.cuh's chol_inv: one warp a block
// up to 32 wide, a lane a row, a shuffle a slot and pivot; two warps past
// it, exchanging each pivot's row and column through shared memory at a
// named barrier, a shared load a slot; scripts/k1_timing.py, PERF.md): a
// lane paid a shuffle (or a shared load) and its selects for each
// multiply-add, half the lanes idled up to 16 wide, and past 32 wide two
// thread blocks fit an SM (255 registers). Here:
// - a lane owns two rows of its block, l and l + H, in registers, on an
//   H-lane segment of a warp (H = 8 up to 16 wide: four blocks a warp; 16
//   up to 32; 32 past it: the CNOT's 44 on one warp); row l < H needs only
//   its first H slots (the inverse is lower triangular) and is finished
//   once the pivots pass H, so a lane holds H + NC values;
// - each pivot is one exchange in shared memory, not a shuffle a slot: the
//   pivot row's lane stores its partial inverse row (16-byte stores), every
//   row at or below the pivot its column entry, and every lane reads the NC
//   values back with 16-byte broadcast loads;
// - the pivot row is left unscaled (its scale 1 / L(J, J) is applied with
//   the equilibration's at the store), so that every other slot's update is
//   one multiply-add, A(i, c) -= (A(i, J) / A(J, J)) A(c, J) for the
//   Schur complement and R(i, c) -= (A(i, J) / A(J, J)) R(J, c) for the
//   inverse's rows, with no select but in the batch of slots around J;
// - one routine a width class (16, 32, 48, 64 pivots, the rows past n
//   the identity's, which leaves Xi as n pivots would: the paths' 14, 15
//   and 44 round up to the same pivots as before), and past 16 wide the
//   pivots are a loop: a kernel that held every pivot count's unrolled
//   routine was ~260 KB of instructions, more than the SM's instruction
//   cache, and its lone warps waited on fetches (k1_timing.py's stamps);
// - a warp stages its blocks, contiguous in device memory, into shared
//   memory with every copy in flight (cp.async), and stores Xi with
//   coalesced stores.
// The contract is chol_inv's (common.cuh): Jacobi equilibration with the
// tiny floor, rows n..NC-1 the identity's, and an all-NaN block for a
// non-positive or NaN pivot.
//
// Under the compile-time switch PX_K1_TIMING (off in every other build)
// the kernel takes one more argument, a stamps buffer, where lane 0 of the
// launch's first warp writes clock64() at its start [0], after staging [1],
// equilibration [2], the pivots [3], Xi in shared memory [4] and the store
// [5], and %globaltimer at its start [6] and end [7]; scripts/k1_timing.py
// builds and reads it.
#include "common.cuh"

#ifdef PX_K1_TIMING
#define PX_K1_PARAM , long long* stamps
#define PX_K1_ARG(p) , (p)
#define PX_K1_STAMP(i) do { if (stamps && threadIdx.x == 0) stamps[i] = clock64(); } while (0)
#else
#define PX_K1_PARAM
#define PX_K1_ARG(p)
#define PX_K1_STAMP(i) do { } while (0)
#endif

namespace {

using px::kSlotBatch;

constexpr int kThreads = 128;

// Lanes a block: a lane owns rows l and l + H of a block up to 2H wide.
__host__ __device__ constexpr int seg_lanes(int W) { return W <= 32 ? W / 2 : 32; }

// Thread blocks an SM must hold (__launch_bounds__): what the H + NC values
// a lane and a batch of exchanged values take without spilling, but at 48
// wide in float32, where 4 (128 registers, 8 bytes spilled) ran config 3's
// blocks 11% faster than 3 (scripts/k1_timing.py, -Xptxas -v; 5 or 6 up to
// 16 wide ran the quickstart's slower).
__host__ __device__ constexpr int min_blocks(int W, int es) {
  return W <= 16 ? 4 : W <= 32 ? (es == 8 ? 3 : 4) : W <= 48 ? (es == 8 ? 2 : 4)
                                                             : (es == 8 ? 2 : 3);
}

// Shared memory of a segment's exchange: the scales d_c and two buffers
// of NC (a pivot's exchange goes to the buffer of its parity, so that the
// next pivot's stores do not wait on this one's loads).
__host__ __device__ constexpr int exchange_elems(int W) { return 3 * W; }

// Four float32 or two float64 values, 16 bytes, from or into shared memory.
template <typename T> __device__ __forceinline__ void ld16(const T* p, T* r) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p);
    r[0] = q.x; r[1] = q.y;
  }
}
template <typename T> __device__ __forceinline__ void st16(T* p, const T* r) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  else
    *reinterpret_cast<double2*>(p) = make_double2(r[0], r[1]);
}

// Pivot J on a lane's rows (v[0, H) row l's first H slots, v[H, H + NC)
// row l + H's; kLow: J < H, the pivot row is row J of lane J, else row J of
// lane J - H and the rows l < H are finished). sa, sb hold slot J of the
// two rows on entry and slot J + 1 on return; X is this pivot's exchange
// buffer; s takes 1 / L(J, J) on the pivot row's lane.
template <typename T, int NC, int H, bool kLow>
__device__ __forceinline__ void pivot(int J, T (&v)[H + NC], T& sa, T& sb, T& s, bool& ok,
                                      int l, T* X) {
  constexpr int V = 16 / sizeof(T);
  const int pl = kLow ? J : J - H;
  // the pivot row's partial inverse R(J, c < J) (and past J its own
  // slots, which the column entries overwrite)
  if (l == pl) {
    const T* row = kLow ? v : v + H;
    constexpr int kLen = kLow && H < NC ? H : NC;
#pragma unroll
    for (int c = 0; c < kLen; c += V) st16(X + c, row + c);
  }
  __syncwarp();
  // column J of the Schur complement: slot J of each row at or below J
  if (kLow && l >= J && l < NC) X[l] = sa;
  if (l + H >= J && l + H < NC) X[l + H] = sb;
  __syncwarp();
  const T piv = X[J];
  ok = ok && piv > T(0);
  const T rinv = px::rsqrt_(piv), r2 = rinv * rinv;
  if (l == pl) s = rinv;
  const T fa = kLow && l > J ? sa * r2 : T(0);   // A(i, J) / A(J, J), 0 at or above J
  const T fb = l + H > J ? sb * r2 : T(0);
  const bool oa = kLow && l == pl, ob = !kLow && l == pl;
  T na = 0, nb = 0;
#pragma unroll
  for (int c0 = 0; c0 < NC; c0 += kSlotBatch) {
    T e[kSlotBatch];
#pragma unroll
    for (int u = 0; u < kSlotBatch; u += V)
      if (c0 + u < NC) ld16(X + c0 + u, e + u);
    if (c0 + kSlotBatch - 1 < J || c0 > J + 1) {   // no slot J or J + 1 here
#pragma unroll
      for (int u = 0; u < kSlotBatch; ++u) {
        const int c = c0 + u;
        if (c >= NC) break;
        if (kLow && c < H) v[c] -= fa * e[u];
        v[H + c] -= fb * e[u];
      }
    } else {
      // slot J: R(i, J) = -A(i, J) / A(J, J) below the pivot, 1 (times s)
      // on its row
#pragma unroll
      for (int u = 0; u < kSlotBatch; ++u) {
        const int c = c0 + u;
        if (c >= NC) break;
        if (kLow && c < H) {
          v[c] = c == J ? (oa ? T(1) : -fa) : v[c] - fa * e[u];
          na = c == J + 1 ? v[c] : na;
        }
        v[H + c] = c == J ? (ob ? T(1) : -fb) : v[H + c] - fb * e[u];
        nb = c == J + 1 ? v[H + c] : nb;
      }
    }
  }
  sa = na;
  sb = nb;
}

// Xi of the n x n block at S (stride ld, shared memory; n <= NC <= 2H)
// into the same place, on the H lanes of a segment (lane l of it owning
// rows l and l + H; every lane of the warp calls it). E: the segment's
// exchange (exchange_elems(NC), 16-byte aligned).
template <typename T, int NC, int H>
__device__ __noinline__ void chol_pair(T* S, int ld, int n, int l, T* E PX_K1_PARAM) {
  constexpr int V = 16 / sizeof(T);
  const int ra = l, rb = l + H;
  const bool la = ra < n, lb = rb < n;         // live rows; n..NC-1 the identity's
  const bool pa = !la && ra < NC, pb = !lb && rb < NC;
  const T tiny = px::diag_tiny<T>();
  const T da = la ? px::rsqrt_(px::nan_max(S[ra * ld + ra], tiny)) : T(pa);
  const T db = lb ? px::rsqrt_(px::nan_max(S[rb * ld + rb], tiny)) : T(pb);
  T v[H + NC];
#pragma unroll
  for (int c = 0; c < H; ++c)
    v[c] = la ? (c <= ra ? S[ra * ld + c] : T(0)) : T(pa && c == ra);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    v[H + c] = lb ? (c <= rb ? S[rb * ld + c] : T(0)) : T(pb && c == rb);
  // equilibrate: A(i, c) d_i^-1/2 d_c^-1/2, the scales through D
  T* D = E;
  if (ra < NC) D[ra] = da;
  if (rb < NC) D[rb] = db;
  __syncwarp();
#pragma unroll
  for (int c0 = 0; c0 < NC; c0 += V) {
    T d[V];
    ld16(D + c0, d);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (c0 + u < H) v[c0 + u] *= da * d[u];
      v[H + c0 + u] *= db * d[u];
    }
  }
  PX_K1_STAMP(2);
  bool ok = true;
  T sa = v[0], sb = v[H], s_a = 0, s_b = 0;
  T* X = E + NC;
  if constexpr (NC <= 16) {
#pragma unroll
    for (int J = 0; J < NC; ++J) {
      if (J < H) pivot<T, NC, H, true>(J, v, sa, sb, s_a, ok, l, X + (J & 1) * NC);
      else pivot<T, NC, H, false>(J, v, sa, sb, s_b, ok, l, X + (J & 1) * NC);
    }
  } else {
#pragma unroll 1
    for (int J = 0; J < H; ++J) pivot<T, NC, H, true>(J, v, sa, sb, s_a, ok, l, X + (J & 1) * NC);
#pragma unroll 1
    for (int J = H; J < NC; ++J) pivot<T, NC, H, false>(J, v, sa, sb, s_b, ok, l, X + (J & 1) * NC);
  }
  PX_K1_STAMP(3);
  // Xi(i, c) = R(i, c) / L(i, i) d_c^-1/2; the block was read before the
  // first exchange, so Xi overwrites it
  const T nan = px::quiet_nan<T>();
#pragma unroll
  for (int c0 = 0; c0 < NC; c0 += V) {
    T d[V];
    ld16(D + c0, d);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int c = c0 + u;
      if (c < n) {
        if (la) S[ra * ld + c] = ok ? (c < H && c <= ra ? v[c < H ? c : 0] * s_a * d[u] : T(0)) : nan;
        if (lb) S[rb * ld + c] = ok ? (c <= rb ? v[H + c] * s_b * d[u] : T(0)) : nan;
      }
    }
  }
  PX_K1_STAMP(4);
}

// A warp's 32 / H blocks, contiguous from block b0, staged into shared
// memory at row stride m | 1 by copies all in flight, factored one a
// segment, and stored back by coalesced stores; the segments' exchanges
// after the thread block's staged blocks. (A grid of the warps the card
// holds, each walking several groups with the next group's copies in
// flight, measured slower at every path shape: its loop state spilled,
// scripts/k1_timing.py.)
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, min_blocks(W, sizeof(T)))
chol_inv_factor_kernel(const T* __restrict__ A, T* __restrict__ Xi, long long batch,
                       int m PX_K1_PARAM) {
  PX_SMEM(T);
  constexpr int H = seg_lanes(W), bpw = 32 / H, per_block = kThreads / 32 * bpw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b0 = ((long long)blockIdx.x * (kThreads / 32) + warp) * bpw;
  if (b0 >= batch) return;                      // uniform in the warp
#ifdef PX_K1_TIMING
  if (blockIdx.x != 0 || warp != 0) stamps = nullptr;
  if (stamps && lane == 0) {
    stamps[0] = clock64();
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[6] = t;
  }
#endif
  const int ld = m | 1, mm = m * m, bs = m * ld;
  const int nb = (int)(batch - b0 < bpw ? batch - b0 : bpw);
  T* S = smem + (size_t)warp * bpw * bs;
  // (16-byte aligned: per_block bs rounded up to a multiple of 16 / sizeof(T))
  constexpr int V = 16 / sizeof(T);
  T* E = smem + ((size_t)per_block * bs + V - 1) / V * V +
         (size_t)(warp * bpw + lane / H) * exchange_elems(W);
  const T* Ab = A + b0 * mm;
  for (int idx = lane; idx < nb * mm; idx += 32) {   // every copy in flight
    const int s = idx / mm, e = idx - s * mm, i = e / m;
    px::cp_async(S + s * bs + i * ld + e - i * m, Ab + idx);
  }
  px::cp_async_commit();
  px::cp_async_wait_group<0>();
  __syncwarp();
  PX_K1_STAMP(1);
  // a segment past the batch factors whatever its buffer holds and stores
  // nothing (its lanes take part in the warp's exchanges)
  chol_pair<T, W, H>(S + (lane / H) * bs, ld, m, lane % H, E PX_K1_ARG(stamps));
  __syncwarp();
  T* Xb = Xi + b0 * mm;
  for (int idx = lane; idx < nb * mm; idx += 32) {
    const int s = idx / mm, e = idx - s * mm, i = e / m;
    Xb[idx] = S[s * bs + i * ld + e - i * m];
  }
#ifdef PX_K1_TIMING
  __syncwarp();
  PX_K1_STAMP(5);
  if (stamps && lane == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[7] = t;
  }
#endif
}

template <typename T, int W>
int launch_w(const void* A, void* Xi, long long batch, int m, cudaStream_t st PX_K1_PARAM) {
  constexpr int per_block = kThreads / 32 * (32 / seg_lanes(W)), V = 16 / sizeof(T);
  const long long blocks = (batch + per_block - 1) / per_block;
  const size_t smem = sizeof(T) * (((size_t)per_block * m * (m | 1) + V - 1) / V * V +
                                   (size_t)per_block * exchange_elems(W));
  if (blocks > 0) {
    if (int e = px::smem_for(chol_inv_factor_kernel<T, W>, smem)) return e;
    chol_inv_factor_kernel<T, W><<<(unsigned)blocks, kThreads, smem, st>>>(
        static_cast<const T*>(A), static_cast<T*>(Xi), batch, m PX_K1_ARG(stamps));
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* A, void* Xi, long long batch, int m, cudaStream_t st PX_K1_PARAM) {
  switch (px::chol_class(m)) {
    case 16: return launch_w<T, 16>(A, Xi, batch, m, st PX_K1_ARG(stamps));
    case 32: return launch_w<T, 32>(A, Xi, batch, m, st PX_K1_ARG(stamps));
    case 48: return launch_w<T, 48>(A, Xi, batch, m, st PX_K1_ARG(stamps));
    default: return launch_w<T, 64>(A, Xi, batch, m, st PX_K1_ARG(stamps));
  }
}

}  // namespace

extern "C" int px_chol_inv_factor(int is_f64, const void* A, void* Xi,
                                  long long batch, int m, void* stream PX_K1_PARAM) {
  if (m < 1 || m > px::kMaxCholM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(A, Xi, batch, m, st PX_K1_ARG(stamps))
                : launch<float>(A, Xi, batch, m, st PX_K1_ARG(stamps));
}
