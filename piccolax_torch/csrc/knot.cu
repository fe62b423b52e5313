// K9: the knot-partitioned (SPIKE) condensed KKT and block-tridiagonal
// solve (kkt_backend "knot").
//
// Replaces piccolax/parallel/sharded_kkt.py: _knot_factor_body,
// _knot_solve_body and _local_partition_solve under shard_map, the knot
// axis sharded over a device mesh. Each device owns L = N / P contiguous
// knots [f, i_1 .. i_k, l] (k = L - 2): it factors its interior block T by
// cyclic reduction, forms the SPIKE columns T^{-1} [e_1 U_f^T | e_k U_l]
// and the reduced interface rows (Df, Dl, Ufl and the coupling U_x to the
// next device); one all_gather assembles the 2P-row interface system,
// which every device factors and solves redundantly; a ppermute brings the
// neighbour's first knot (the halo) and, in the solve, the previous
// device's last multiplier.
//
// On one H100 the mesh axis becomes P partitions: the all_gather is a
// write and a read of the interface rows in device memory, a ppermute a
// read across the partition edge.
//   factor: the condensed blocks D_k, U_k, a row group a knot
//           (common.cuh's condense); the interiors' CR factors, all B P at
//           once (launch_cr_factor); the SPIKE columns, a CR solve of the
//           2m columns of each interior, launched level by level with a
//           row group a row (reduce, root, back-substitution); the
//           interface rows, a row group a partition; the interface
//           systems' CR factors (once per problem, where JAX repeats it on
//           every device);
//   solve  three launches of solve_engine.cuh's cluster kernel (the engine
//          of K3's solve), each planned from the card's SM count:
//          (c1) a cluster a partition and problem: t = Pinv r_z over the
//              partition and its halo, the dual rhs b, the interior's CR
//              solve, the interface rhs r_f, r_l;
//          (c2) a cluster a problem: the interface system's CR solve;
//          (c3) a cluster a partition and problem: lambda (x_f, x_l and
//              x_int = r_sol - S_f x_f - S_l x_l), then the primal
//              back-substitution w -> z, reading the previous partition's
//              last multiplier.
// The standalone block-tridiagonal solve (given diag and upper) runs the
// same kernels without the condensation and the primal part.
//
// At config 3 (m = 40, dz = 44, N = 200, P = 8) a factor is ~0.7 GFLOP
// per problem, most of it the SPIKE columns' 2m right-hand sides, ~0.01 ms
// at the card's float64 peak; what a factor takes is its chain of
// dependent steps. Measured on the earlier design, a thread block a
// partition that ran all of it (scripts/cr_phase_timing.py), the SPIKE
// solve took 43-49% of a partition's time, the condensation 21-31% and
// the level loop's products 17-19%, the interface factor on one block
// after it: every step here is a launch of a row group per row (or knot,
// or partition) of every system, its products staged in shared memory
// (block_gemm), each entry summed in the earlier order (float32 ones in
// float64). A factor is 5 log2 Npk + 2 log2 Npi + 6 launches in one call
// (39 at N = 200, P = 8).
//
// The solve: measured on the earlier design (one thread block of 256 a
// partition for c1 and c3, one a problem for c2, each through common.cuh's
// cr_solve_block; scripts/cr_phase_timing.py --knot-solve), a launch put
// P B (c1, c3) or B (c2) SMs to work, each CR level's work on one of them.
// Here each partition's interior solve and each interface solve run on a
// cluster of up to 16 SMs, the knot-range work (the dual rhs with its
// halo, x_int, the primal) spread over the cluster's blocks by knot, and
// every block stages its blocks by cp.async (solve_engine.cuh). The
// interface needs every partition's r_f and r_l, so it stays a launch
// boundary; the multipliers before the primal are a cluster barrier.
//
// Factor layout (shared with the plain version, parallel/sharded_kkt.py):
// fT [B, P, 3, Npk, m, m] the interior CR factors (Npk = k padded to a power
// of two), spike [B, P, k, m, 2m] = T^{-1} [e_1 U_f^T | e_k U_l],
// Ub [B, P, 2, m, m] = (U_f, U_l), f_if [B, 3, Npi, m, m] the interface CR
// factor (Npi = 2P padded).
#include "solve_engine.cuh"

namespace {

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Sizes shared by the host (workspace) and the kernels (offsets).
struct Dims {
  int B, N, P, L, k, Npk, Npi, m, dz;
  __host__ __device__ Dims(int B_, int N_, int P_, int m_, int dz_)
      : B(B_), N(N_), P(P_), L(N_ / P_), k(N_ / P_ - 2),
        Npk(pow2_at_least(N_ / P_ - 2)), Npi(pow2_at_least(2 * P_)), m(m_), dz(dz_) {}
  // Factor workspace: the condensed blocks D, U [B, N, m, m] and Y
  // [B, N, 3, m, dz] (none for the standalone system, dz = 0); the
  // interiors' CR factor's; the SPIKE solve's X0, X1 and rodd
  // [B P, Npk, m, 2m] and tl [B P, Npk / 2, m, 2m]; the interface rows
  // Dif, Uif [B, 2P, m, m]; the interface CR factor's.
  __host__ __device__ long long S() const { return (long long)B * P; }
  __host__ __device__ long long cond() const {
    return dz > 0 ? 2LL * B * N * m * m + 3LL * B * N * m * dz : 0;
  }
  __host__ __device__ long long spike_rows() const { return S() * Npk * m * 2 * m; }
  __host__ __device__ long long fws() const {
    return cond() + px::cr_factor_ws(S(), Npk, m) + 3 * spike_rows() +
           S() * (Npk > 1 ? Npk / 2 : 1) * m * 2 * m + 4LL * B * P * m * m +
           px::cr_factor_ws(B, Npi, m);
  }
  // Solve workspace (solve_engine.cuh's SolveArgs), a column: per
  // partition the interior's level vectors V, Y [2 Npk - 1, m], b_f, b_l
  // [2, m] and the multipliers [L + 1, m]; then per problem the interface
  // system's V, Y [2 Npi - 1, m], whose level 0 receives the interface rhs.
  __host__ __device__ long long spart() const {
    return 2LL * (2 * Npk - 1) * m + 2LL * m + (L + 1LL) * m;
  }
  __host__ __device__ long long sif() const { return 2LL * (2 * Npi - 1) * m; }
  __host__ __device__ long long sws(int r) const {
    return (long long)B * r * (P * spart() + sif());
  }
};

// SPIKE right-hand sides of interior s = b P + p, a thread block a row:
// E = [e_1 U_f^T | e_k U_l] [Npk, m, 2m] (U_f = U_{j0}, U_l = U_{j0+L-2}).
template <typename T>
__global__ void spike_init_kernel(px::Knots<T> kn, T* __restrict__ E, Dims g) {
  const int s = blockIdx.x / g.Npk, i = blockIdx.x % g.Npk;
  const int m = g.m, mm = m * m, r = 2 * m, b = s / g.P, j0 = (s % g.P) * g.L;
  const T* Uf = kn.u(b, j0, mm);
  const T* Ul = kn.u(b, j0 + g.L - 2, mm);
  T* e = E + ((long long)s * g.Npk + i) * m * r;
  for (int idx = threadIdx.x; idx < m * r; idx += blockDim.x) {
    const int a = idx / r, c = idx % r;
    T v = 0;
    if (i == 0 && c < m) v = Uf[c * m + a];
    if (i == g.k - 1 && c >= m) v = Ul[a * m + c - m];
    e[idx] = v;
  }
}

// The SPIKE solve's kernels: each a group (common.cuh) per row of a level
// of every interior (row s half + j), their m x m by m x 2m products
// staged by block_gemm, each entry summed as cr_solve_block sums it. cr
// holds the interiors' factors (fT), rows of a right-hand side are
// [m, r = 2m] and a buffer holds Npk rows an interior.
template <typename T>
struct Spike {
  const T* cr;
  int S, Npk, m;
  __device__ const T* plane(int s, int pl, int slot) const {
    return cr + (((long long)s * 3 + pl) * Npk + slot) * m * m;
  }
  __device__ long long row(int s, int i) const { return ((long long)s * Npk + i) * m * 2 * m; }
};

// Shared memory of a SPIKE kernel's group: `rows` right-hand-side rows
// [m, 2m] and the product tiles, in elements of T.
__host__ __device__ inline int spike_smem(int m, int rows, int nt) { return rows * 2 * m * m + px::gemm_smem(m, 2 * m, m, nt); }

// q(a, c) = sum_e M(a, e) b(e, c) (trans: M(e, a)), M m x m, b m x r
template <typename T, class Epi>
__device__ void spike_prod(const T* M, bool trans, const T* bm, int m, int r, const Epi& epi,
                           T* tiles, const px::Group& g) {
  if (trans)
    px::block_gemm<T, false, true>(
        m, r, m, [&](int a, int e) { return M[e * m + a]; },
        [&](int e, int c) { return bm[e * r + c]; }, epi, tiles, g);
  else
    px::block_gemm<T, true, true>(
        m, r, m, [&](int a, int e) { return M[a * m + e]; },
        [&](int e, int c) { return bm[e * r + c]; }, epi, tiles, g);
}

// The group's row of a launch of n rows (false: none, the group returns).
#define PX_SPIKE_ROW(n, smem_rows)                                                    \
  const px::Group g(px::rows_per_block(sp.m));                                      \
  const long long row = (long long)blockIdx.x * px::rows_per_block(sp.m) + g.index; \
  if (row >= (n)) return;                                                           \
  const int m = sp.m, r = 2 * m;                                                    \
  T* gsm = smem + g.index * spike_smem(m, smem_rows, g.nt)

// Reduction, odd row j of the level at slot off: rodd = b_{2j+1},
// tl_j = Xi^T (Xi b_{2j+1}).
template <typename T>
__global__ void spike_odd_kernel(Spike<T> sp, const T* __restrict__ cur, T* __restrict__ rodd,
                                 T* __restrict__ tl, int off, int half PX_CR_PARAM) {
  PX_SMEM(T);
  PX_SPIKE_ROW((long long)sp.S * half, 1);
  const int s = (int)(row / half), j = (int)(row % half);
  T* q = gsm;                                // [m, r]
  T* tiles = q + m * r;
  const T* Xl = sp.plane(s, 0, off + j);
  const T* bo = cur + sp.row(s, 2 * j + 1);
  T* ro = rodd + sp.row(s, off + j);
  T* t = tl + row * m * r;
  PX_CR_BEGIN();
  for (int idx = g.tid; idx < m * r; idx += g.nt) ro[idx] = bo[idx];
  spike_prod<T>(Xl, false, bo, m, r, [&](int a, int c, T v) { q[a * r + c] = v; }, tiles, g);
  g.sync();
  PX_CR_KSTAMP(3);
  spike_prod<T>(Xl, true, q, m, r, [&](int a, int c, T v) { t[a * r + c] = v; }, tiles, g);
  PX_CR_KSTAMP(4);
  PX_CR_END();
}

// Reduction, even row j: nxt_j = b_{2j} - Ur_{j-1}^T tl_{j-1} - Ul_j tl_j.
template <typename T>
__global__ void spike_even_kernel(Spike<T> sp, const T* __restrict__ cur,
                                  const T* __restrict__ tl, T* __restrict__ nxt, int off,
                                  int half PX_CR_PARAM) {
  PX_SMEM(T);
  PX_SPIKE_ROW((long long)sp.S * half, 1);
  const int s = (int)(row / half), j = (int)(row % half);
  T* w = gsm;                                // b_{2j} - Ur^T tl_{j-1}
  T* tiles = w + m * r;
  const T* t = tl + row * m * r;
  T* o = nxt + sp.row(s, j);
  PX_CR_BEGIN();
  px::stage_block(w, r, cur + sp.row(s, 2 * j), m, r, g);
  g.sync();
  if (j > 0)
    spike_prod<T>(sp.plane(s, 2, off + j - 1), true, t - m * r, m, r,
                  [&](int a, int c, T v) { w[a * r + c] -= v; }, tiles, g);
  PX_CR_KSTAMP(3);
  spike_prod<T>(sp.plane(s, 1, off + j), false, t, m, r,
                [&](int a, int c, T v) { o[a * r + c] = w[a * r + c] - v; }, tiles, g);
  PX_CR_KSTAMP(4);
  PX_CR_END();
}

// The root: x_0 = XR^T (XR b_0) into out + s osys.
template <typename T>
__global__ void spike_root_kernel(Spike<T> sp, const T* __restrict__ cur, T* __restrict__ out,
                                  long long osys PX_CR_PARAM) {
  PX_SMEM(T);
  PX_SPIKE_ROW((long long)sp.S, 1);
  const int s = (int)row;
  T* q = gsm;
  T* tiles = q + m * r;
  const T* XR = sp.plane(s, 0, sp.Npk - 1);
  T* o = out + s * osys;
  PX_CR_BEGIN();
  spike_prod<T>(XR, false, cur + sp.row(s, 0), m, r,
                [&](int a, int c, T v) { q[a * r + c] = v; }, tiles, g);
  g.sync();
  PX_CR_KSTAMP(3);
  spike_prod<T>(XR, true, q, m, r, [&](int a, int c, T v) { o[a * r + c] = v; }, tiles, g);
  PX_CR_KSTAMP(4);
  PX_CR_END();
}

// Back-substitution, odd row j of the level at slot lo from x (half rows):
// t = rodd - Ul^T x_j - Ur x_{j+1}, y_{2j+1} = Xi^T (Xi t), y_{2j} = x_j;
// y rows past nrows (the interior's k) are not written, y + s ysys.
template <typename T>
__global__ void spike_back_kernel(Spike<T> sp, const T* __restrict__ x,
                                  const T* __restrict__ rodd, T* __restrict__ y, long long ysys,
                                  int nrows, int lo, int half PX_CR_PARAM) {
  PX_SMEM(T);
  PX_SPIKE_ROW((long long)sp.S * half, 2);
  const int s = (int)(row / half), j = (int)(row % half);
  const int mr = m * r;
  T* t = gsm;
  T* q = t + mr;
  T* tiles = q + mr;
  const T* xj = x + sp.row(s, j);
  const T* ro = rodd + sp.row(s, lo + j);
  const T* Xl = sp.plane(s, 0, lo + j);
  T* ys = y + s * ysys;
  PX_CR_BEGIN();
  spike_prod<T>(sp.plane(s, 1, lo + j), true, xj, m, r,
                [&](int a, int c, T v) { t[a * r + c] = ro[a * r + c] - v; }, tiles, g);
  if (j + 1 < half)
    spike_prod<T>(sp.plane(s, 2, lo + j), false, xj + mr, m, r,
                  [&](int a, int c, T v) { t[a * r + c] = t[a * r + c] - v; }, tiles, g);
  g.sync();
  PX_CR_KSTAMP(3);
  spike_prod<T>(Xl, false, t, m, r, [&](int a, int c, T v) { q[a * r + c] = v; }, tiles, g);
  g.sync();
  if (2 * j + 1 < nrows)
    spike_prod<T>(Xl, true, q, m, r,
                  [&](int a, int c, T v) { ys[(2LL * j + 1) * mr + a * r + c] = v; }, tiles, g);
  PX_CR_KSTAMP(4);
  if (2 * j < nrows)
    for (int idx = g.tid; idx < mr; idx += g.nt) ys[2LL * j * mr + idx] = xj[idx];
  PX_CR_END();
}

// The interface rows of partition p of problem b (a group each): rows 2p
// (f) and 2p + 1 (l) of Dif, Uif [B, 2P, m, m] from the SPIKE columns, and
// Ub = (U_f, U_l).
template <typename T>
__global__ void iface_rows_kernel(px::Knots<T> kn, const T* __restrict__ spike,
                                  T* __restrict__ Dif, T* __restrict__ Uif, T* __restrict__ Ub,
                                  Dims dm PX_CR_PARAM) {
  PX_SMEM(T);
  const px::Group g(px::rows_per_block(dm.m));
  const long long s = (long long)blockIdx.x * px::rows_per_block(dm.m) + g.index;
  if (s >= dm.S()) return;
  const int b = (int)(s / dm.P), p = (int)(s % dm.P), m = dm.m, mm = m * m, r = 2 * m;
  T* sm = smem + g.index * px::gemm_smem(m, m, m, g.nt);
  const long long j0 = (long long)p * dm.L;
  const T* Uf = kn.u(b, j0, mm);
  const T* Ul = kn.u(b, j0 + dm.L - 2, mm);
  const T* Ux = kn.u(b, j0 + dm.L - 1, mm);    // to partition p + 1; none at the end
  const T* Df = kn.d(b, j0, mm);
  const T* Dl = kn.d(b, j0 + dm.L - 1, mm);
  const T* x0 = spike + s * dm.k * m * r;
  const T* xl = x0 + (long long)(dm.k - 1) * m * r;
  T* df = Dif + ((long long)b * 2 * dm.P + 2 * p) * mm;
  T* uf = Uif + ((long long)b * 2 * dm.P + 2 * p) * mm;
  PX_CR_BEGIN();
  // U_f (T^-1 U_f^T)_1, U_l^T (T^-1 U_l)_k, U_f (T^-1 U_l)_1
  px::block_gemm<T, true, true>(
      m, m, m, [&](int a, int e) { return Uf[a * m + e]; },
      [&](int e, int c) { return x0[e * r + c]; },
      [&](int a, int c, T v) { df[a * m + c] = Df[a * m + c] - v; }, sm, g);
  px::block_gemm<T, false, true>(
      m, m, m, [&](int a, int e) { return Ul[e * m + a]; },
      [&](int e, int c) { return xl[e * r + m + c]; },
      [&](int a, int c, T v) { df[mm + a * m + c] = Dl[a * m + c] - v; }, sm, g);
  PX_CR_KSTAMP(3);
  px::block_gemm<T, true, true>(
      m, m, m, [&](int a, int e) { return Uf[a * m + e]; },
      [&](int e, int c) { return x0[e * r + m + c]; },
      [&](int a, int c, T v) { uf[a * m + c] = -v; }, sm, g);
  PX_CR_KSTAMP(4);
  T* ub = Ub + s * 2 * mm;
  for (int idx = g.tid; idx < mm; idx += g.nt) {
    uf[mm + idx] = Ux ? Ux[idx] : T(0);
    ub[idx] = Uf[idx];
    ub[mm + idx] = Ul[idx];
  }
  PX_CR_END();
}

// The factor's launches. kCond: D and U condensed from the knot factors
// Xi, C, R and Cn; otherwise read from diag [B, N, m, m] and upper
// [B, N-1, m, m].
template <typename T, bool kCond>
int launch_factor(const void* Xi, const void* C, const void* R, const void* Cn,
                  const void* diag, const void* up, void* fT, void* spike, void* Ub,
                  void* fif, void* ws_, const Dims& g, cudaStream_t st PX_CR_PARAM) {
  const int m = g.m, mm = m * m, r = 2 * m, S = (int)g.S();
  T* ws = static_cast<T*>(ws_);
  px::Knots<T> kn;
  if (kCond) {
    T* D = ws;
    T* U = D + (long long)g.B * g.N * mm;
    T* Y = U + (long long)g.B * g.N * mm;
    int rc = px::launch_condense<T>((const T*)Xi, (const T*)C, (const T*)R, (const T*)Cn, D, U,
                                    Y, g.B, g.N, m, g.dz, st PX_CR_ARG(stamps));
    if (rc) return rc;
    kn = px::Knots<T>{D, U, (long long)g.N * mm, (long long)g.N * mm, g.N};
  } else {
    kn = px::Knots<T>{(const T*)diag, (const T*)up, (long long)g.N * mm,
                      (long long)(g.N - 1) * mm, g.N - 1};
  }
  T* wcr = ws + g.cond();
  T* X0 = wcr + px::cr_factor_ws(S, g.Npk, m);
  T* X1 = X0 + g.spike_rows();
  T* rodd = X1 + g.spike_rows();
  T* tl = rodd + g.spike_rows();
  T* Dif = tl + g.S() * (g.Npk > 1 ? g.Npk / 2 : 1) * m * r;
  T* Uif = Dif + 2LL * g.B * g.P * mm;
  T* wif = Uif + 2LL * g.B * g.P * mm;
  // the interiors: rows 1 .. L-2 of each partition
  int rc = px::launch_cr_factor<T>(px::Rows<T>{kn, g.P, g.L, 1, g.k, g.k - 1}, S, g.Npk, m,
                                   (T*)fT, 3LL * g.Npk * mm, wcr, st PX_CR_ARG(stamps));
  if (rc) return rc;
  // the SPIKE columns T^{-1} [e_1 U_f^T | e_k U_l]
  const Spike<T> sp{(const T*)fT, S, g.Npk, m};
  const int rows = px::rows_per_block(m), gt = px::kGemmThreads / rows;
  const unsigned nt = px::kGemmThreads;
  auto bytes = [&](int rhs_rows) { return sizeof(T) * rows * spike_smem(m, rhs_rows, gt); };
  if (int e = px::smem_for(spike_odd_kernel<T>, bytes(1))) return e;
  if (int e = px::smem_for(spike_even_kernel<T>, bytes(1))) return e;
  if (int e = px::smem_for(spike_root_kernel<T>, bytes(1))) return e;
  if (int e = px::smem_for(spike_back_kernel<T>, bytes(2))) return e;
  spike_init_kernel<T><<<(unsigned)(g.S() * g.Npk), nt, 0, st>>>(kn, X0, g);
  T *cur = X0, *nxt = X1;
  int off = 0, lvl = 0;
  for (int n = g.Npk; n > 1; n /= 2, ++lvl) {
    const int half = n / 2;
    const unsigned blocks = px::row_blocks(g.S() * half, m);
    spike_odd_kernel<T><<<blocks, nt, bytes(1), st>>>(sp, cur, rodd, tl, off, half
                                                      PX_CR_NEXT(5, lvl));
    spike_even_kernel<T><<<blocks, nt, bytes(1), st>>>(sp, cur, tl, nxt, off, half
                                                       PX_CR_NEXT(6, lvl));
    T* tmp = cur; cur = nxt; nxt = tmp;
    off += half;
  }
  const long long spk = (long long)g.k * m * r;     // spike's rows an interior
  const unsigned sblocks = px::row_blocks(g.S(), m);
  if (g.Npk == 1) {
    spike_root_kernel<T><<<sblocks, nt, bytes(1), st>>>(sp, cur, (T*)spike, spk
                                                        PX_CR_NEXT(7, lvl));
  } else {
    spike_root_kernel<T><<<sblocks, nt, bytes(1), st>>>(sp, cur, nxt, (long long)g.Npk * m * r
                                                        PX_CR_NEXT(7, lvl));
    T *x = nxt, *y = cur;
    for (int half = 1; half < g.Npk; half *= 2) {
      const bool last = 2 * half == g.Npk;
      spike_back_kernel<T><<<px::row_blocks(g.S() * half, m), nt, bytes(2), st>>>(
          sp, x, rodd, last ? (T*)spike : y, last ? spk : (long long)g.Npk * m * r,
          last ? g.k : g.Npk, g.Npk - 2 * half, half PX_CR_NEXT(8, --lvl));
      T* tmp = x; x = y; y = tmp;
    }
  }
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const size_t ibytes = sizeof(T) * rows * px::gemm_smem(m, m, m, gt);
  if (int e = px::smem_for(iface_rows_kernel<T>, ibytes)) return e;
  iface_rows_kernel<T><<<sblocks, nt, ibytes, st>>>(kn, (const T*)spike, Dif, Uif, (T*)Ub, g
                                                    PX_CR_NEXT(9, 0));
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  // the interface systems, 2P rows each
  return px::launch_cr_factor<T>(
      px::Rows<T>{px::Knots<T>{Dif, Uif, 2LL * g.P * mm, 2LL * g.P * mm, 2 * g.P}, 1, 0, 0,
                  2 * g.P, 2 * g.P},
      g.B, g.Npi, m, (T*)fif, 3LL * g.Npi * mm, wif, st PX_CR_ARG(stamps));
}

#ifdef PX_CR_TIMING
// the last solve's launches: thread blocks, cluster size, shared memory a block
inline long long g_knot_config[9] = {0};
#endif

// The three launches' plans (c1 and c3: B P r clusters; c2: B r), into S,
// bytes and cfg, with the kernel's shared memory set to the largest.
template <typename T>
int plan_knot(const Dims& g, int dz, int r, int (&S)[2], long long (&bytes)[2],
              cudaLaunchConfig_t (&cfg)[2], cudaLaunchAttribute (&attr)[2][1]) {
  for (int i = 0; i < 2; ++i)
    if (int e = px::plan_solve<T, true>((long long)(i == 0 ? g.B * g.P : g.B) * r, g.m, dz,
                                        false, S[i], bytes[i], cfg[i], attr[i]))
      return e;
  return px::smem_for(px::solve_kernel<T, true>,
                      (size_t)(bytes[0] > bytes[1] ? bytes[0] : bytes[1]));
}

// Launches (c1), (c2), (c3). kCond: the condensed KKT, rhs / out
// [B, N, dz + m, r]; else the block-tridiagonal system, rhs / out [B, N, m, r].
template <typename T, bool kCond>
int launch_solve(const void* Xi, const void* C, const void* Cn, const void* fT,
                 const void* spike, const void* Ub, const void* fif, const void* rhs,
                 void* out, void* ws, const Dims& g, int r, cudaStream_t st PX_CR_PARAM) {
  const int dz = kCond ? g.dz : 0, m = g.m;
  int S[2];
  long long bytes[2];
  cudaLaunchConfig_t cfg[2];
  cudaLaunchAttribute attr[2][1];
  if (int e = plan_knot<T>(g, dz, r, S, bytes, cfg, attr)) return e;
  T* part = static_cast<T*>(ws);
  T* iface = part + (long long)g.B * g.P * r * g.spart();
  px::SolveArgs<T> a{};
  a.Xi = static_cast<const T*>(Xi);
  a.C = static_cast<const T*>(C);
  a.Cn = static_cast<const T*>(Cn);
  a.rhs = static_cast<const T*>(rhs);
  a.out = static_cast<T*>(out);
  a.N = g.N; a.m = m; a.dz = dz; a.r = r; a.P = g.P; a.L = g.L;
  a.Ub = static_cast<const T*>(Ub);
  a.ifws = iface;
  a.ifwss = g.sif();
  a.Npi = g.Npi;
  // (c1) dual, the interior's CR (k rows, padded to Npk), rf/rl
  px::SolveArgs<T> a1 = a;
  a1.cr = static_cast<const T*>(fT);
  a1.crs = 3LL * g.Npk * m * m;
  a1.ws = part;
  a1.wss = g.spart();
  a1.Np = g.Npk;
  a1.S = S[0];
  a1.nrows = g.k;
  a1.head = px::kDual;
  a1.tail = px::kIfRhs;
  // (c2) the interface systems (2P rows, padded to Npi), a cluster a problem
  px::SolveArgs<T> a2 = a;
  a2.cr = static_cast<const T*>(fif);
  a2.crs = 3LL * g.Npi * m * m;
  a2.ws = iface;
  a2.wss = g.sif();
  a2.Np = g.Npi;
  a2.S = S[1];
  a2.P = 1;
  a2.L = 0;
  a2.nrows = 2 * g.P;
  a2.head = px::kNone;
  a2.tail = px::kNone;
  // (c3) x_int (the standalone system: out), the primal
  px::SolveArgs<T> a3 = a1;
  a3.cr = nullptr;
  a3.spike = static_cast<const T*>(spike);
  a3.head = px::kSpike;
  a3.tail = kCond ? px::kPrimal : px::kNone;
#ifdef PX_CR_TIMING
  for (int i = 0; i < 3; ++i) {
    const int q = i == 1;
    g_knot_config[3 * i] = (long long)cfg[q].gridDim.x;
    g_knot_config[3 * i + 1] = S[q];
    g_knot_config[3 * i + 2] = bytes[q];
  }
#endif
  int rc = px::launch_planned<T, true>(cfg[0], r, a1, bytes[0], st PX_CR_ARG(stamps));
  if (rc) return rc;
  rc = px::launch_planned<T, true>(cfg[1], r, a2, bytes[1], st
                             PX_CR_ARG(stamps ? stamps + 256 : nullptr));
  if (rc) return rc;
  return px::launch_planned<T, true>(cfg[0], r, a3, bytes[0], st
                               PX_CR_ARG(stamps ? stamps + 512 : nullptr));
}

bool valid(int B, int N, int P, int m, int dz) {
  return B >= 1 && P >= 1 && N % P == 0 && N / P >= 3 && m >= 1 && m <= px::kMaxCholM &&
         dz >= 0 && P <= 65535 && B <= 65535;
}

}  // namespace

// Workspace elements of a factor / a solve of B problems (dz = 0: the
// standalone block-tridiagonal system; the solve's workspace does not
// depend on dz).
extern "C" long long px_knot_factor_ws(int B, int N, int P, int m, int dz) {
  return Dims(B, N, P, m, dz).fws();
}

extern "C" long long px_knot_solve_ws(int B, int N, int P, int m, int dz, int r) {
  return Dims(B, N, P, m, dz).sws(r);
}

// Factor of the condensed KKT from the knot factors Xi [B, N, dz, dz]
// (K1), C [B, N, m, dz], Rdiag [B, N, m], Cnext [B, N-1, m, dz].
extern "C" int px_knot_factor(int is_f64, const void* Xi, const void* C, const void* Rdiag,
                              const void* Cnext, void* fT, void* spike, void* Ub, void* fif,
                              void* ws, int B, int N, int P, int m, int dz, void* stream PX_CR_PARAM) {
  if (!valid(B, N, P, m, dz) || dz < 1) return (int)cudaErrorInvalidValue;
  const Dims g(B, N, P, m, dz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef PX_CR_TIMING
  px::g_nst = 0;
#endif
  return is_f64 ? launch_factor<double, true>(Xi, C, Rdiag, Cnext, nullptr, nullptr, fT, spike,
                                              Ub, fif, ws, g, st PX_CR_ARG(stamps))
                : launch_factor<float, true>(Xi, C, Rdiag, Cnext, nullptr, nullptr, fT, spike,
                                             Ub, fif, ws, g, st PX_CR_ARG(stamps));
}

// Solve of the condensed KKT, rhs / out [B, N, dz + m, r].
// (Under PX_CR_TIMING the stamps buffer follows the stream: 256 slots a
// launch, as solve_engine.cuh's kSubStamps says.)
extern "C" int px_knot_solve(int is_f64, const void* Xi, const void* C, const void* Cnext,
                             const void* fT, const void* spike, const void* Ub,
                             const void* fif, const void* rhs, void* out, void* ws, int B,
                             int N, int P, int m, int dz, int r, void* stream PX_CR_PARAM) {
  if (!valid(B, N, P, m, dz) || dz < 1 || dz > px::kMaxCholM || r < 1)
    return (int)cudaErrorInvalidValue;
  const Dims g(B, N, P, m, dz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_solve<double, true>(Xi, C, Cnext, fT, spike, Ub, fif, rhs, out, ws,
                                             g, r, st PX_CR_ARG(stamps))
                : launch_solve<float, true>(Xi, C, Cnext, fT, spike, Ub, fif, rhs, out, ws,
                                            g, r, st PX_CR_ARG(stamps));
}

// The cluster sizes a solve of B problems, P partitions and r columns
// launches with on the current card: (c1) and (c3)'s, a partition, if
// which is 0, (c2)'s, a problem, if 1; -1 on an error.
extern "C" int px_knot_solve_cluster(int is_f64, int B, int N, int P, int m, int dz, int r,
                                     int which) {
  if (!valid(B, N, P, m, dz) || r < 1 || which < 0 || which > 1) return -1;
  const Dims g(B, N, P, m, dz);
  int S[2];
  long long bytes[2];
  cudaLaunchConfig_t cfg[2];
  cudaLaunchAttribute attr[2][1];
  const int e = is_f64 ? plan_knot<double>(g, dz, r, S, bytes, cfg, attr)
                       : plan_knot<float>(g, dz, r, S, bytes, cfg, attr);
  return e ? -1 : S[which];
}

// The SPD block-tridiagonal system diag [B, N, m, m], upper
// [B, N-1, m, m]: factor into fT, spike, Ub, fif, then solve rhs / out
// [B, N, m, r] (fws holds the factor's workspace, sws the solve's).
extern "C" int px_knot_tridiag_solve(int is_f64, const void* diag, const void* upper,
                                     const void* rhs, void* out, void* fT, void* spike,
                                     void* Ub, void* fif, void* fws, void* sws, int B, int N,
                                     int P, int m, int r, void* stream) {
  if (!valid(B, N, P, m, 0) || r < 1) return (int)cudaErrorInvalidValue;
  const Dims g(B, N, P, m, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = is_f64 ? launch_factor<double, false>(nullptr, nullptr, nullptr, nullptr, diag, upper,
                                                 fT, spike, Ub, fif, fws, g, st PX_CR_ARG(nullptr))
                  : launch_factor<float, false>(nullptr, nullptr, nullptr, nullptr, diag, upper,
                                                fT, spike, Ub, fif, fws, g, st PX_CR_ARG(nullptr));
  if (rc) return rc;
  return is_f64 ? launch_solve<double, false>(nullptr, nullptr, nullptr, fT, spike, Ub, fif,
                                              rhs, out, sws, g, r, st PX_CR_ARG(nullptr))
                : launch_solve<float, false>(nullptr, nullptr, nullptr, fT, spike, Ub, fif,
                                             rhs, out, sws, g, r, st PX_CR_ARG(nullptr));
}

#ifdef PX_CR_TIMING
// The last solve's launches (c1, c2, c3): thread blocks, cluster size and
// shared memory a block, into out[0..8].
extern "C" void px_knot_solve_config(long long* out) {
  for (int i = 0; i < 9; ++i) out[i] = g_knot_config[i];
}

// The kinds of the last timed factor's launches (kind + 256 level: 0 the
// condensation, 1-3 a CR elimination, update and root, 5-8 the SPIKE
// solve's odd and even reductions, root and back-substitution, 9 the
// interface rows) into out; returns their number.
extern "C" int px_cr_timing_kinds(int* out) {
  for (int q = 0; q < px::g_nst; ++q) out[q] = px::g_kinds[q];
  return px::g_nst;
}
#endif
