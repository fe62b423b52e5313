// K4 and K6: the fixed-order Taylor (Paterson-Stockmeyer, order 8 or 12)
// and diagonal Pade [m/m] (m in 3, 5, 7, 9, the denominator inverted by six
// Newton-Schulz steps) matrix exponentials with a static squaring count, in
// a value form and in a derivative form.
//
// Replaces piccolax/ops/expm.py:143 expm_taylor_fixed and :105
// expm_pade_fixed (with _ns_solve :44), the collocation residual's
// propagator, and the block-triangular augmentation through them by which
// the integrator takes exact first and second derivatives (piccolax
// differentiates the same approximants with jacfwd / hessian).
//
// Value form: r(A) of real n x n matrices, n <= 32 (the residuals and the
// line-search sweep: 4 x 4 and 8 x 8 on the paths). Derivative form: for
// A [w, w] and directions E_k [w, w] (k < d), r(A), Dr(A)[E_k] and the
// symmetrised D^2 r(A)[E_i, E_j], w <= 16 and any d. For
// M = [[A, E_i, 0], [0, A, E_j], [0, 0, A]] every intermediate of either
// approximant (the Newton-Schulz iterates included) is a polynomial in M,
// so it is block upper triangular with one block D on the diagonal, the
// same function F_i of (A, E_i) in block (1,2) and F_j in (2,3), and a
// corner C_ij. The derivative form carries D, every F_k once, and the
// symmetric sums S_ij = C_ij + C_ji (i <= j), which follow the closed rule
//   (D, F, S) (D', F', S') = (D D', D F'_k + F_k D',
//                             D S'_ij + F_i F'_j + F_j F'_i + S_ij D'),
// each entry summed in that order, block by block as a dense product of
// the augmentations sums it. Per step that is 1 + 2d + 2d(d+1) w x w
// products a knot where the dense 3w x 3w augmentations take 27 d^2, and
// neither M nor r(M) is ever written: Phi = D, dPhi_k = F_k and
// D2_ij = D2_ji = S_ij come out of the last step.
//
// One engine runs both forms on "elements": one block (the value form), or
// the blocks D, F and S of a tile of direction pairs. A thread owns one or
// two rows of one block (two where the width is even and at most 8: a row
// of the right operand, read once, serves both) and keeps their sums in
// registers; it streams the right operand's rows from shared memory, read
// at one address by the threads of a block (a broadcast), so a
// multiply-add costs a quarter (float32) or half (float64) of a 16-byte
// shared load or less. The value form up to 8 wide keeps a thread's rows of
// every intermediate in registers and puts in shared memory only what a
// product reads as its right operand (four buffers); a warp holds its
// matrices (16 at 4 x 4, 8 at 8 x 8 in float32) and a step ends with a
// warp barrier. The derivative form keeps six buffers of padded blocks (a
// block's stride an odd number of 16-byte units, so the blocks a warp
// reads fall in different banks), packs up to 256 threads of tiles into a
// thread block and ends a step with a block barrier. Each thread loads its
// own rows of the inputs (16-byte vectors where rows are 4 or 8 wide and
// aligned), every load sent before the first store, and writes its own
// rows of the outputs.
//
// Bound on the H100: bytes at 4 x 4 and 8 x 8 in the value form (n^2 in
// and out against ~5 + s products); in the derivative form bytes at 4 x 4
// (qs256: 25344 knots, d = 3, Taylor) and arithmetic at 8 x 8 or with the
// Pade schedule's 17 + s steps.
#include "common.cuh"

namespace {

constexpr int kNsIters = 6;
constexpr int kBuffers = 6;
constexpr int kMaxThreads = 256;        // a tile's threads (<= 255 registers each)
constexpr size_t kTileBytes = 64 * 1024;   // a tile's shared memory, preferred
constexpr size_t kBlockBytes = 112 * 1024;  // a thread block's, where it holds several

__constant__ double kPadeB[4][10] = {
    {120.0, 60.0, 12.0, 1.0},
    {30240.0, 15120.0, 3360.0, 420.0, 30.0, 1.0},
    {17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0, 1.0},
    {17643225600.0, 8821612800.0, 2075673600.0, 302702400.0, 30270240.0,
     2162160.0, 110880.0, 3960.0, 90.0, 1.0},
};

__host__ __device__ constexpr double inv_fact(int i) {
  double f = 1.0;
  for (int k = 2; k <= i; ++k) f *= k;
  return 1.0 / f;
}

// How a launch lays out its work (host-computed, passed by value).
struct Geometry {
  int w, d;      // block width, directions (0: the value form)
  int T, nt;     // directions a tile side, tile sides (ceil(d / T))
  int ntiles;    // tiles an element: nt (nt + 1) / 2 (the pairs i <= j), 1 when d = 0
  int nblk;      // blocks a tile's element holds, at most
  int units;     // threads a tile: nblk * w / (rows a thread)
  int bs;        // a block's stride in shared memory, elements
  int tstride;   // a tile's shared memory, elements (its buffers)
  int ppw;       // tiles a warp (the value form)
  int wpc;       // warps a thread block (the value form)
  int ppc;       // tiles a thread block (the derivative form)
};

// One tile: directions I = [I0, I0 + nI) and J = [J0, J0 + nJ), the pairs
// (i, j) in I x J with i <= j. Its blocks: D, F_I, F_J (unless J = I), the
// pairs' S, in that order.
struct Tile {
  int I0, nI, J0, nJ;
  bool same;
  int nF, nblk;

  __device__ void init(const Geometry& g, int t) {
    int ti = 0;
    while (t >= g.nt - ti) {
      t -= g.nt - ti;
      ++ti;
    }
    const int tj = ti + t;
    I0 = ti * g.T;
    J0 = tj * g.T;
    nI = min(g.T, g.d - I0);
    nJ = min(g.T, g.d - J0);
    same = ti == tj;
    nF = same ? nI : nI + nJ;
    const int np = same ? nI * (nI + 1) / 2 : nI * nJ;
    nblk = 1 + nF + np;
  }
  // The pair of S block p (0-based among the pairs): local indices a in I,
  // b in J.
  __device__ void pair(int p, int& a, int& b) const {
    if (same) {
      a = 0;
      while (p >= nI - a) {
        p -= nI - a;
        ++a;
      }
      b = a + p;
    } else {
      a = p / nJ;
      b = p % nJ;
    }
  }
  __device__ int fJ(int b) const { return same ? 1 + b : 1 + nI + b; }
  __device__ int dir(int f) const { return f <= nI ? I0 + f - 1 : J0 + f - 1 - nI; }
};

// A thread's rows of a block (RPT consecutive rows from row0) and the
// terms (left block, right block) of its rows of a product: D: D D';
// F_k: D F'_k, F_k D'; S_ij: D S'_ij, F_i F'_j, F_j F'_i, S_ij D'.
struct Unit {
  int blk, row0, nterm;
  int lb[4], rb[4];

  __device__ void init(const Tile& tl, int u, int tpb, int rpt) {
    blk = u / tpb;
    row0 = (u % tpb) * rpt;
    if (blk == 0) {
      nterm = 1;
      lb[0] = 0; rb[0] = 0;
    } else if (blk <= tl.nF) {
      nterm = 2;
      lb[0] = 0; rb[0] = blk;
      lb[1] = blk; rb[1] = 0;
    } else {
      int a, b;
      tl.pair(blk - 1 - tl.nF, a, b);
      const int fi = 1 + a, fj = tl.fJ(b);
      nterm = 4;
      lb[0] = 0; rb[0] = blk;
      lb[1] = fi; rb[1] = fj;
      lb[2] = fj; rb[2] = fi;
      lb[3] = blk; rb[3] = 0;
    }
  }
};

template <typename T, int WP>
__device__ __forceinline__ void ld_row(const T* s, T (&v)[WP]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < WP / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(s)[i];
      v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < WP / 2; ++i) {
      const double2 x = reinterpret_cast<const double2*>(s)[i];
      v[2 * i] = x.x; v[2 * i + 1] = x.y;
    }
  }
}

template <typename T, int WP>
__device__ __forceinline__ void st_row(T* s, const T (&v)[WP]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < WP / 4; ++i)
      reinterpret_cast<float4*>(s)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                    v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < WP / 2; ++i)
      reinterpret_cast<double2*>(s)[i] = make_double2(v[2 * i], v[2 * i + 1]);
  }
}

// The engine's per-thread state: the tile's buffers and the thread's unit
// of RPT rows. Elementwise steps go through a row in 16-byte chunks (V
// entries), so that no more than the product's sums stay live.
template <typename T, int WP, int RPT, bool DERIV>
struct Engine {
  static constexpr int V = 16 / sizeof(T);
  T* buf;        // the tile's buffers of nblk blocks
  int stride;    // elements a buffer
  int bs, w;
  Unit u;

  __device__ T* row(int b, int r) const {
    return buf + b * stride + u.blk * bs + (u.row0 + r) * WP;
  }
  __device__ void store(int b, const T (&v)[RPT][WP]) const {
#pragma unroll
    for (int r = 0; r < RPT; ++r) st_row<T, WP>(row(b, r), v[r]);
  }
  __device__ bool diag(int r, int j) const { return u.blk == 0 && j == u.row0 + r; }
  __device__ void ld(int b, int r, int c0, T (&v)[V]) const { ld_row<T, V>(row(b, r) + c0, v); }
  __device__ void st(int b, int r, int c0, const T (&v)[V]) const {
    st_row<T, V>(row(b, r) + c0, v);
  }

  // acc = this thread's rows of P Q (buffers p and q), each entry summed
  // over the terms in order and over k = 0 .. w-1 within a term; a row of
  // the right operand, read once, serves the thread's RPT rows.
  __device__ void prod(int p, int q, T (&acc)[RPT][WP]) const {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < WP; ++j) acc[r][j] = T(0);
    const T* P = buf + p * stride;
    const T* Q = buf + q * stride;
#pragma unroll
    for (int t = 0; t < (DERIV ? 4 : 1); ++t) {
      if (t < u.nterm) {
        T a[RPT][WP];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          ld_row<T, WP>(P + u.lb[t] * bs + (u.row0 + r) * WP, a[r]);
        const T* R = Q + u.rb[t] * bs;
#pragma unroll
        for (int k = 0; k < WP; ++k) {
          if (k < w) {
            T b[WP];
            ld_row<T, WP>(R + k * WP, b);
#pragma unroll
            for (int r = 0; r < RPT; ++r)
#pragma unroll
              for (int j = 0; j < WP; ++j) acc[r][j] = fma(a[r][k], b[j], acc[r][j]);
          }
        }
      }
    }
  }

  // The value form's product with the left rows in registers: acc = a Q
  // (buffer q), summed over k = 0 .. w-1.
  __device__ void prod_regs(const T (&a)[RPT][WP], int q, T (&acc)[RPT][WP]) const {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < WP; ++j) acc[r][j] = T(0);
    const T* R = buf + q * stride;
#pragma unroll
    for (int k = 0; k < WP; ++k) {
      if (k < w) {
        T b[WP];
        ld_row<T, WP>(R + k * WP, b);
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int j = 0; j < WP; ++j) acc[r][j] = fma(a[r][k], b[j], acc[r][j]);
      }
    }
  }

  // Into buffer o: cubic(I0) + coef acc (SCALED) or cubic(I0) + acc, where
  // cubic(I0) = ((c_I0 I + c_I0+1 X) + c_I0+2 X^2) + c_I0+3 X^3 of these
  // rows (buffers 0-2), the Taylor coefficients c_k = 1 / k!.
  template <int I0, bool SCALED>
  __device__ void cubic_plus(const T (&acc)[RPT][WP], T coef, int o) const {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c0 = 0; c0 < WP; c0 += V) {
        T x[V], x2[V], x3[V], v[V];
        ld(0, r, c0, x);
        ld(1, r, c0, x2);
        ld(2, r, c0, x3);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const T cub = ((T(diag(r, c0 + i) ? inv_fact(I0) : 0.0) +
                          T(inv_fact(I0 + 1)) * x[i]) + T(inv_fact(I0 + 2)) * x2[i]) +
                        T(inv_fact(I0 + 3)) * x3[i];
          v[i] = SCALED ? cub + coef * acc[r][c0 + i] : cub + acc[r][c0 + i];
        }
        st(o, r, c0, v);
      }
  }
};

template <bool WARP>
__device__ __forceinline__ void step_sync() {
  if constexpr (WARP) __syncwarp(); else __syncthreads();
}

// Taylor, as piccolax/ops/expm.py:143: X^2, X^3 = X^2 X, X^4 = X^2 X^2;
// order 8: F = cubic(0) + X^4 (cubic(4) + c8 X^4); order 12:
// F = cubic(0) + X^4 (cubic(4) + X^4 (cubic(8) + c12 X^4)); then the
// squarings. Buffers: 0 X, 1 X^2, 2 X^3, 3 X^4, 4 and 5 the steps after.
// Returns the buffer of the result.
template <typename T, int WP, int RPT, bool DERIV, bool WARP>
__device__ int taylor(const Engine<T, WP, RPT, DERIV>& e, bool on, int order, int squarings) {
  T acc[RPT][WP];
  if (on) {
    e.prod(0, 0, acc);
    e.store(1, acc);
  }
  step_sync<WARP>();
  if (on) {
    e.prod(1, 0, acc);
    e.store(2, acc);
    e.prod(1, 1, acc);
    e.store(3, acc);
    if (order == 8)
      e.template cubic_plus<4, true>(acc, T(inv_fact(8)), 4);
    else
      e.template cubic_plus<8, true>(acc, T(inv_fact(12)), 4);
  }
  step_sync<WARP>();
  if (on) {
    e.prod(3, 4, acc);
    if (order == 8)
      e.template cubic_plus<0, false>(acc, T(0), 5);
    else
      e.template cubic_plus<4, false>(acc, T(0), 5);
  }
  step_sync<WARP>();
  int f = 5;
  if (order == 12) {
    if (on) {
      e.prod(3, 5, acc);
      e.template cubic_plus<0, false>(acc, T(0), 4);
    }
    step_sync<WARP>();
    f = 4;
  }
  for (int q = 0; q < squarings; ++q) {
    const int g = f == 4 ? 5 : 4;
    if (on) {
      e.prod(f, f, acc);
      e.store(g, acc);
    }
    step_sync<WARP>();
    f = g;
  }
  return f;
}

// Pade, as piccolax/ops/expm.py:105: the even powers A^2 .. A^(m-1), U and
// V summed from 0 in power order, U = A (sum), the six Newton-Schulz steps
// Y <- Y (2I - (V - U) Y) from Y = I / b0, F = Y (V + U), the squarings.
// Buffers: 0 X then F, 1 A^2 then V + U, 2 and 3 the powers then V - U and
// Y, 4 W (U's sum) then 2I - (V - U) Y, 5 V then Y.
template <typename T, int WP, int RPT, bool DERIV, bool WARP>
__device__ int pade(const Engine<T, WP, RPT, DERIV>& e, bool on, int order, int squarings) {
  constexpr int V = Engine<T, WP, RPT, DERIV>::V;
  const double* c = kPadeB[(order - 3) / 2];
  const int ev = (order - 1) / 2;
  T acc[RPT][WP];
  if (on) {
    e.prod(0, 0, acc);
    e.store(1, acc);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c0 = 0; c0 < WP; c0 += V) {
        T wv[V], vv[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          wv[i] = (e.diag(r, c0 + i) ? T(c[1]) : T(0)) + T(c[3]) * acc[r][c0 + i];
          vv[i] = (e.diag(r, c0 + i) ? T(c[0]) : T(0)) + T(c[2]) * acc[r][c0 + i];
        }
        e.st(4, r, c0, wv);
        e.st(5, r, c0, vv);
      }
  }
  step_sync<WARP>();
  int prev = 1;
  for (int q = 2; q <= ev; ++q) {
    const int cur = prev == 2 ? 3 : 2;
    if (on) {
      e.prod(prev, 1, acc);
      e.store(cur, acc);
      const T cw = T(c[2 * q + 1]), cv = T(c[2 * q]);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c0 = 0; c0 < WP; c0 += V) {
          T wv[V], vv[V];
          e.ld(4, r, c0, wv);
          e.ld(5, r, c0, vv);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            wv[i] = wv[i] + cw * acc[r][c0 + i];
            vv[i] = vv[i] + cv * acc[r][c0 + i];
          }
          e.st(4, r, c0, wv);
          e.st(5, r, c0, vv);
        }
    }
    step_sync<WARP>();
    prev = cur;
  }
  if (on) {
    e.prod(0, 4, acc);                      // U = A (sum)
    const T y0 = T(1) / T(c[0]);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c0 = 0; c0 < WP; c0 += V) {
        T vv[V], den[V], num[V], y[V];
        e.ld(5, r, c0, vv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          den[i] = vv[i] - acc[r][c0 + i];
          num[i] = vv[i] + acc[r][c0 + i];
          y[i] = e.diag(r, c0 + i) ? y0 : T(0);
        }
        e.st(2, r, c0, den);                // V - U
        e.st(1, r, c0, num);                // V + U
        e.st(3, r, c0, y);                  // Y = I / b0
      }
  }
  step_sync<WARP>();
  int y = 3;
  for (int it = 0; it < kNsIters; ++it) {
    if (on) {
      e.prod(2, y, acc);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < WP; ++j) acc[r][j] = (e.diag(r, j) ? T(2) : T(0)) - acc[r][j];
      e.store(4, acc);
    }
    step_sync<WARP>();
    const int yn = y == 3 ? 5 : 3;
    if (on) {
      e.prod(y, 4, acc);
      e.store(yn, acc);
    }
    step_sync<WARP>();
    y = yn;
  }
  if (on) {
    e.prod(y, 1, acc);
    e.store(0, acc);
  }
  step_sync<WARP>();
  int f = 0;
  for (int q = 0; q < squarings; ++q) {
    const int g = f == 0 ? 2 : 0;
    if (on) {
      e.prod(f, f, acc);
      e.store(g, acc);
    }
    step_sync<WARP>();
    f = g;
  }
  return f;
}

// The value form up to 8 wide: a thread's rows of every matrix stay in
// registers (they are only ever the left operand of its own products) and
// shared memory holds only the right operands, four buffers. The
// arithmetic and its order are taylor()'s and pade()'s.
template <typename T, int WP, int RPT>
__device__ __forceinline__ void cubic_regs(const Engine<T, WP, RPT, false>& e, int i0,
                                           const T (&x)[RPT][WP], const T (&x2)[RPT][WP],
                                           const T (&x3)[RPT][WP], T (&v)[RPT][WP]) {
  const T c0 = T(inv_fact(i0)), c1 = T(inv_fact(i0 + 1)), c2 = T(inv_fact(i0 + 2)),
          c3 = T(inv_fact(i0 + 3));
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < WP; ++j)
      v[r][j] = ((e.diag(r, j) ? c0 : T(0)) + c1 * x[r][j] + c2 * x2[r][j]) + c3 * x3[r][j];
}

// Taylor: buffers 0 X, 1 X^2, 2 the Paterson-Stockmeyer step's right
// operand, 3 the next; the squarings alternate 0 and 1. f: the result.
template <typename T, int WP, int RPT>
__device__ void taylor_regs(const Engine<T, WP, RPT, false>& e, bool on, int order,
                            int squarings, const T (&x)[RPT][WP], T (&f)[RPT][WP]) {
  T x2[RPT][WP], x3[RPT][WP], x4[RPT][WP], v[RPT][WP];
  if (on) {
    e.prod_regs(x, 0, x2);
    e.store(1, x2);
  }
  __syncwarp();
  if (on) {
    e.prod_regs(x2, 0, x3);
    e.prod_regs(x2, 1, x4);
    cubic_regs(e, order == 8 ? 4 : 8, x, x2, x3, v);
    const T c = T(order == 8 ? inv_fact(8) : inv_fact(12));
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < WP; ++j) v[r][j] = v[r][j] + c * x4[r][j];
    e.store(2, v);
  }
  __syncwarp();
  if (on) {
    e.prod_regs(x4, 2, f);
    cubic_regs(e, order == 8 ? 0 : 4, x, x2, x3, v);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < WP; ++j) f[r][j] = v[r][j] + f[r][j];
  }
  if (order == 12) {
    if (on) e.store(3, f);
    __syncwarp();
    if (on) {
      e.prod_regs(x4, 3, v);
      cubic_regs(e, 0, x, x2, x3, f);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < WP; ++j) f[r][j] = f[r][j] + v[r][j];
    }
  }
  for (int q = 0; q < squarings; ++q) {
    const int o = q % 2;
    if (on) e.store(o, f);
    __syncwarp();
    if (on) {
      e.prod_regs(f, o, v);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < WP; ++j) f[r][j] = v[r][j];
    }
  }
}

// Pade: buffers 0 X then 2I - (V - U) Y, 1 A^2 then Y, 2 U's sum then F
// for the squarings, 3 V + U; the squarings alternate 2 and 0.
template <typename T, int WP, int RPT>
__device__ void pade_regs(const Engine<T, WP, RPT, false>& e, bool on, int order,
                          int squarings, const T (&x)[RPT][WP], T (&f)[RPT][WP]) {
  const double* c = kPadeB[(order - 3) / 2];
  const int ev = (order - 1) / 2;
  T p[RPT][WP], wv[RPT][WP], vv[RPT][WP], acc[RPT][WP];
  if (on) {
    e.prod_regs(x, 0, p);                   // A^2
    e.store(1, p);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < WP; ++j) {
        wv[r][j] = (e.diag(r, j) ? T(c[1]) : T(0)) + T(c[3]) * p[r][j];
        vv[r][j] = (e.diag(r, j) ? T(c[0]) : T(0)) + T(c[2]) * p[r][j];
      }
  }
  __syncwarp();
  if (on) {
    for (int q = 2; q <= ev; ++q) {         // A^(2q) = A^(2q-2) A^2
      e.prod_regs(p, 1, acc);
      const T cw = T(c[2 * q + 1]), cv = T(c[2 * q]);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < WP; ++j) {
          p[r][j] = acc[r][j];
          wv[r][j] = wv[r][j] + cw * acc[r][j];
          vv[r][j] = vv[r][j] + cv * acc[r][j];
        }
    }
    e.store(2, wv);
  }
  __syncwarp();
  if (on) {
    e.prod_regs(x, 2, acc);                 // U = A (sum)
    const T y0 = T(1) / T(c[0]);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < WP; ++j) {
        wv[r][j] = vv[r][j] - acc[r][j];    // V - U
        vv[r][j] = vv[r][j] + acc[r][j];    // V + U
        p[r][j] = e.diag(r, j) ? y0 : T(0); // Y = I / b0
      }
    e.store(3, vv);
    e.store(1, p);
  }
  __syncwarp();
  for (int it = 0; it < kNsIters; ++it) {
    if (on) {
      e.prod_regs(wv, 1, acc);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < WP; ++j) acc[r][j] = (e.diag(r, j) ? T(2) : T(0)) - acc[r][j];
      e.store(0, acc);
    }
    __syncwarp();
    if (on) {
      e.prod_regs(p, 0, acc);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < WP; ++j) p[r][j] = acc[r][j];
      e.store(1, p);
    }
    __syncwarp();
  }
  if (on) e.prod_regs(p, 3, f);             // F = Y (V + U)
  for (int q = 0; q < squarings; ++q) {
    const int o = q % 2 == 0 ? 2 : 0;
    if (on) e.store(o, f);
    __syncwarp();
    if (on) {
      e.prod_regs(f, o, acc);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < WP; ++j) f[r][j] = acc[r][j];
    }
  }
}

// The shared-memory path's schedule and this thread's rows of the result
// (written by this thread).
template <typename T, int WP, int RPT>
__device__ __forceinline__ void store_rows(const T (&v)[RPT][WP], T* dst, T* dst2, int row0,
                                           int w, bool vec) {
  if (vec) {
    T flat[RPT * WP];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < WP; ++c) flat[r * WP + c] = v[r][c];
    st_row<T, RPT * WP>(dst + row0 * WP, flat);
    if (dst2) st_row<T, RPT * WP>(dst2 + row0 * WP, flat);
    return;
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < WP; ++c)
      if (c < w) {
        dst[(row0 + r) * w + c] = v[r][c];
        if (dst2) dst2[(row0 + r) * w + c] = v[r][c];
      }
}

template <typename T, int WP, int RPT, bool DERIV, bool WARP, bool TAYLOR>
__device__ void expm_fixed_shared(const Engine<T, WP, RPT, DERIV>& e, bool on, int order,
                                  int squarings, int w, T* dst, T* dst2, bool vec) {
  int f;
  if constexpr (TAYLOR)
    f = taylor<T, WP, RPT, DERIV, WARP>(e, on, order, squarings);
  else
    f = pade<T, WP, RPT, DERIV, WARP>(e, on, order, squarings);
  if (on && dst) {
    T v[RPT][WP];
#pragma unroll
    for (int r = 0; r < RPT; ++r) ld_row<T, WP>(e.row(f, r), v[r]);
    store_rows<T, WP, RPT>(v, dst, dst2, e.u.row0, w, vec);
  }
}

// A [batch, w, w] (and E [e_batch, d, w, w]) in; Phi [batch, w, w] (and
// dPhi [batch, d, w, w], D2 [batch, d, d, w, w]) out. Tiles of g.units
// threads: several a warp (WARP, the value form) or several a thread block.
template <typename T, int WP, int RPT, bool DERIV, bool WARP, bool TAYLOR>
__global__ void __launch_bounds__(kMaxThreads)
expm_fixed_kernel(const T* __restrict__ A, const T* __restrict__ E, T* __restrict__ Phi,
                  T* __restrict__ dPhi, T* __restrict__ D2, long long batch,
                  long long e_batch, Geometry g, int order, int squarings, T scale) {
  PX_SMEM(T);
  const int w = g.w, d = g.d, ww = w * w;
  int slot, tid;
  long long tile;
  if constexpr (WARP) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int s = lane / g.units;
    slot = warp * g.ppw + s;
    tid = lane - s * g.units;
    tile = s < g.ppw ? (long long)blockIdx.x * g.wpc * g.ppw + slot : -1;
  } else {
    slot = threadIdx.x / g.units;
    tid = threadIdx.x - slot * g.units;
    tile = slot < g.ppc ? (long long)blockIdx.x * g.ppc + slot : -1;
  }
  const long long b = tile < 0 ? batch : tile / g.ntiles;
  const bool valid = b < batch;
  Tile tl;
  tl.init(g, valid ? (int)(tile % g.ntiles) : 0);
  Engine<T, WP, RPT, DERIV> e;
  e.buf = smem + (size_t)slot * g.tstride;
  e.stride = g.nblk * g.bs;
  e.bs = g.bs;
  e.w = w;
  const int tpb = w / RPT;                  // threads a block
  const bool on = valid && tid < tl.nblk * tpb;
  if (on) e.u.init(tl, tid, tpb, RPT);

  // Each thread stages its own rows of X = 2^-s (A, E_I, E_J, 0), padded
  // columns zero, every load sent before the first store; no thread
  // reads another's rows before the barrier.
  const T* src = nullptr;                   // this thread's block of A or E
  T* dst = nullptr;                         // and of the outputs
  T* dst2 = nullptr;
  if (on) {
    const int blk = e.u.blk;
    if (blk == 0) {
      src = A + b * ww;
      if (tl.I0 == 0 && tl.J0 == 0) dst = Phi + b * ww;
    } else if (DERIV && blk <= tl.nF) {
      src = E + ((b % e_batch) * d + tl.dir(blk)) * ww;
      if (tl.same) dst = dPhi + (b * d + tl.dir(blk)) * ww;
    } else if (DERIV) {
      int a, bb;
      tl.pair(blk - 1 - tl.nF, a, bb);
      const int i0 = tl.I0 + a, j0 = tl.J0 + bb;
      dst = D2 + ((b * d + i0) * d + j0) * ww;
      if (i0 != j0) dst2 = D2 + ((b * d + j0) * d + i0) * ww;
    }
  }
  // rows of exactly WP entries on 16-byte boundaries: vector loads and
  // stores of a thread's RPT rows, which lie next to each other
  const bool vec = w == WP && !(reinterpret_cast<uintptr_t>(A) & 15) &&
                   !(reinterpret_cast<uintptr_t>(Phi) & 15) &&
                   (!DERIV || !((reinterpret_cast<uintptr_t>(E) | reinterpret_cast<uintptr_t>(dPhi) |
                                 reinterpret_cast<uintptr_t>(D2)) & 15));
  T x[RPT][WP];
  if (on) {
    if (vec) {
      T v[RPT * WP];
      if (src) ld_row<T, RPT * WP>(src + e.u.row0 * WP, v);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < WP; ++c) x[r][c] = src ? v[r * WP + c] * scale : T(0);
    } else {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < WP; ++c)
          x[r][c] = (src && c < w) ? src[(e.u.row0 + r) * w + c] * scale : T(0);
    }
    e.store(0, x);
  }
  step_sync<WARP>();
  if constexpr (!DERIV && WP <= 8) {        // the register path: write f's rows
    T fr[RPT][WP];
    if constexpr (TAYLOR)
      taylor_regs<T, WP, RPT>(e, on, order, squarings, x, fr);
    else
      pade_regs<T, WP, RPT>(e, on, order, squarings, x, fr);
    if (on && dst) store_rows<T, WP, RPT>(fr, dst, nullptr, e.u.row0, w, vec);
  } else {
    expm_fixed_shared<T, WP, RPT, DERIV, WARP, TAYLOR>(e, on, order, squarings, w, dst, dst2,
                                                       vec);
  }
}

int padded_width(int w) { return w <= 4 ? 4 : w <= 8 ? 8 : w <= 16 ? 16 : 32; }

// Rows a thread: two (a row of the right operand read once serves both)
// where the width is even and at most 8 (the value form: and a row of two
// rows in registers at most 64 bytes), else one.
int rows_per_thread(int w, int es, bool deriv) {
  return (w % 2 == 0 && w <= 8 && (deriv || w * es <= 32)) ? 2 : 1;
}

// Shared-memory buffers a tile: four for the value form up to 8 wide (its
// rows live in registers), six otherwise.
int buffers(int w, int d) { return d == 0 && w <= 8 ? 4 : kBuffers; }

// The launch's layout: the widest tile side T (at most d) whose tile takes
// at most kMaxThreads threads and kTileBytes of shared memory (or, at
// T = 1, the card's limit); the value form a warp's tiles, the derivative
// form as many tiles as fit kMaxThreads threads (and kBlockBytes) a thread
// block. Returns false where nothing fits.
bool plan(int w, int d, int es, Geometry& g) {
  const int wp = padded_width(w);
  const int tpb = w / rows_per_thread(w, es, d > 0);
  const int nbuf = buffers(w, d);
  int units16 = (w * wp * es) / 16;
  if (units16 % 2 == 0) ++units16;          // an odd number of 16-byte units
  g.w = w;
  g.d = d;
  g.bs = units16 * 16 / es;
  auto blocks = [d](int T) {
    const int nt = (d + T - 1) / T;
    const int diag = 1 + T + T * (T + 1) / 2;
    return nt == 1 ? 1 + d + d * (d + 1) / 2 : (diag > 1 + 2 * T + T * T ? diag
                                                                         : 1 + 2 * T + T * T);
  };
  // a tile's buffers and one 16-byte unit: an odd number of units, so that
  // the tiles a warp holds fall in different banks too
  auto bytes = [&](int nblk) { return (size_t)nbuf * nblk * g.bs * es + 16; };
  if (d == 0) {
    g.T = 1;
    g.nt = 1;
    g.nblk = 1;
  } else {
    int T = d;
    while (T > 1 && (blocks(T) * tpb > kMaxThreads || bytes(blocks(T)) > kTileBytes)) --T;
    g.T = T;
    g.nt = (d + T - 1) / T;
    g.nblk = blocks(T);
  }
  g.ntiles = g.nt * (g.nt + 1) / 2;
  g.units = g.nblk * tpb;
  g.tstride = (int)(bytes(g.nblk) / es);
  if (g.units > kMaxThreads || bytes(g.nblk) > px::kMaxSmemBytes) return false;
  g.ppw = g.wpc = g.ppc = 0;
  if (d == 0) {                             // units = w / rpt <= 32
    g.ppw = 32 / g.units;
    g.wpc = px::warps_that_fit(g.ppw * bytes(g.nblk), 4);
  } else {
    int ppc = kMaxThreads / g.units;
    while (ppc > 1 && ppc * bytes(g.nblk) > kBlockBytes) --ppc;
    g.ppc = ppc;
  }
  return true;
}

template <typename T, int WP, int RPT, bool DERIV, bool TAYLOR>
int launch_one(const void* A, const void* E, void* Phi, void* dPhi, void* D2,
               long long batch, long long e_batch, const Geometry& g, int order,
               int squarings, cudaStream_t st) {
  const long long tiles = batch * g.ntiles;
  const size_t per = (size_t)g.tstride * sizeof(T);
  const long long per_block = DERIV ? g.ppc : (long long)g.wpc * g.ppw;
  const long long blocks = (tiles + per_block - 1) / per_block;
  const int threads = DERIV ? (g.ppc * g.units + 31) / 32 * 32 : 32 * g.wpc;
  const size_t smem = per * per_block;
  if (blocks <= 0) return 0;
  auto kern = expm_fixed_kernel<T, WP, RPT, DERIV, !DERIV, TAYLOR>;
  static int set_bytes = 48 * 1024;         // per instantiation
  if ((int)smem > set_bytes) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    set_bytes = (int)smem;
  }
  kern<<<(unsigned)blocks, threads, smem, st>>>(
      static_cast<const T*>(A), static_cast<const T*>(E), static_cast<T*>(Phi),
      static_cast<T*>(dPhi), static_cast<T*>(D2), batch, e_batch, g, order, squarings,
      (T)ldexp(1.0, -squarings));
  return (int)cudaGetLastError();
}

template <typename T, bool DERIV, bool TAYLOR>
int launch(const void* A, const void* E, void* Phi, void* dPhi, void* D2, long long batch,
           long long e_batch, int w, int d, int order, int squarings, cudaStream_t st) {
  Geometry g;
  if (!plan(w, d, sizeof(T), g)) return (int)cudaErrorInvalidValue;
  const bool two = rows_per_thread(w, sizeof(T), DERIV) == 2;
#define PX_LAUNCH(WP, RPT) \
  launch_one<T, WP, RPT, DERIV, TAYLOR>(A, E, Phi, dPhi, D2, batch, e_batch, g, order, \
                                        squarings, st)
  switch (padded_width(w)) {
    case 4: return two ? PX_LAUNCH(4, 2) : PX_LAUNCH(4, 1);
    case 8: return two ? PX_LAUNCH(8, 2) : PX_LAUNCH(8, 1);
    case 16: return PX_LAUNCH(16, 1);
    default:
      if constexpr (!DERIV) return PX_LAUNCH(32, 1);
      return (int)cudaErrorInvalidValue;
  }
#undef PX_LAUNCH
}

bool valid_order(int taylor, int order) {
  return taylor ? (order == 8 || order == 12) : (order >= 3 && order <= 9 && order % 2 == 1);
}

int value(int is_f64, int taylor, const void* A, void* out, long long batch, int n, int order,
          int squarings, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 32 || !valid_order(taylor, order) || squarings < 0 || squarings > 62)
    return (int)cudaErrorInvalidValue;
  if (taylor)
    return is_f64 ? launch<double, false, true>(A, nullptr, out, nullptr, nullptr, batch, 1, n,
                                                0, order, squarings, st)
                  : launch<float, false, true>(A, nullptr, out, nullptr, nullptr, batch, 1, n,
                                               0, order, squarings, st);
  return is_f64 ? launch<double, false, false>(A, nullptr, out, nullptr, nullptr, batch, 1, n,
                                               0, order, squarings, st)
                : launch<float, false, false>(A, nullptr, out, nullptr, nullptr, batch, 1, n,
                                              0, order, squarings, st);
}

}  // namespace

// Value form. A and out hold batch real n x n matrices (n <= 32), row-major,
// of double (is_f64) or float. Taylor order 8 or 12; Pade order 3, 5, 7, 9.
extern "C" int px_expm_taylor(int is_f64, const void* A, void* out, long long batch, int n,
                              int order, int squarings, void* stream) {
  return value(is_f64, 1, A, out, batch, n, order, squarings, stream);
}

extern "C" int px_expm_pade_fixed(int is_f64, const void* A, void* out, long long batch,
                                  int n, int order, int squarings, void* stream) {
  return value(is_f64, 0, A, out, batch, n, order, squarings, stream);
}

// Derivative form (Taylor when taylor is 1, else Pade) in one launch: A
// [batch, w, w] and E [e_batch, d, w, w] in (knot b reads directions
// b % e_batch: e_batch divides batch, a batch sharing them); Phi
// [batch, w, w], dPhi [batch, d, w, w] and D2 [batch, d, d, w, w] out;
// w <= 16, d >= 1.
extern "C" int px_expm_fixed_derivatives(int is_f64, int taylor, int order, int squarings,
                                         const void* A, const void* E, void* Phi, void* dPhi,
                                         void* D2, long long batch, long long e_batch, int w,
                                         int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w < 1 || w > 16 || d < 1 || !valid_order(taylor, order) || squarings < 0 ||
      squarings > 62 || e_batch < 1 || batch % e_batch != 0)
    return (int)cudaErrorInvalidValue;
  if (taylor)
    return is_f64 ? launch<double, true, true>(A, E, Phi, dPhi, D2, batch, e_batch, w, d,
                                               order, squarings, st)
                  : launch<float, true, true>(A, E, Phi, dPhi, D2, batch, e_batch, w, d,
                                              order, squarings, st);
  return is_f64 ? launch<double, true, false>(A, E, Phi, dPhi, D2, batch, e_batch, w, d,
                                              order, squarings, st)
                : launch<float, true, false>(A, E, Phi, dPhi, D2, batch, e_batch, w, d,
                                             order, squarings, st);
}
