// K3: condensed dual Schur complement of the per-knot KKT, factored and
// solved by block cyclic reduction.
//
// Replaces piccolax/solver/kkt.py: condensed_factor / condensed_solve over
// cr_factor / cr_solve. On the TPU each CR level is a batched matmul over
// all knots. The blocks are 12 x 12 on config 1 and 40 x 40 on config 3
// (CNOT): a factor is ~0.33 GFLOP a problem at the CNOT's blocks, 0.08 ms
// of the card at B = 16, so what bounds it is the dependent chain of
// log2(Np) levels, each a Cholesky inverse and a few products of m x m
// blocks.
//
// Factor (common.cuh): one launch forms the condensed blocks D_k, U_k, a
// row group a knot; then each CR level is two launches, the odd rows'
// elimination (chol_inv and the product Xi [Ul^T | Ur]) and the even rows'
// update (two products), a row group a row of every problem, and one root
// launch: 2 log2(Np) + 2 launches in one call. A level of one problem so
// spreads over as many SMs as it has rows, and a batch fills the card; a
// row group is a thread block, or a warp for blocks up to 16 wide (four
// rows a block, products on whole operands, more blocks an SM). Measured
// on the earlier design, one thread block a problem that ran every level
// (scripts/cr_phase_timing.py), the products and the condensation took
// 82-92% of a factor at the CNOT's blocks and the Cholesky inverses 8-9%:
// eight warps a problem read row-strided operands from a device-memory
// workspace. Every product here stages its operands in shared memory with
// coalesced loads (block_gemm), each entry summed in the earlier order.
//
// Every factor runs in float64. A float32 problem's inputs are read into
// float64 by the condensation and its factor rounded to float32 once, as
// the elimination stores it: each level's reduced blocks, rounded to
// float32, would carry an error of the dual system's condition number
// times float32's epsilon into the next level's Cholesky inverse, and a
// factor in float32 throughout is no more accurate than the plain
// version's (on config 4's blocks its end-to-end solve strayed more than
// 2x the plain version's from float64 on about one draw in 20:
// scripts/k3_f32_accuracy.py with --baseline).
//
// Solve: csrc/cr_solve.cu.
//
// Factor layout cr [B, 3, Np, m, m]: level l (n = Np >> l rows, n/2 odd
// rows eliminated) stores Xi, Ul, Ur of its odd rows at slots
// off_l .. off_l + n/2 - 1, off_l = Np - (Np >> l); slot Np - 1 of the Xi
// plane holds the root factor.
#include "common.cuh"

namespace {

// Workspace of the factor a problem, in float64 elements: D and U
// [N, m, m], Y [N, 3, m, dz], then launch_cr_factor's.
long long factor_ws(int N, int Np, int m, int dz) {
  return 2LL * N * m * m + 3LL * N * m * dz + px::cr_factor_ws(1, Np, m);
}

// Inputs and factor of type Ti, the levels in float64.
template <typename Ti>
int launch_factor(const void* Xi, const void* C, const void* Rdiag, const void* Cnext,
                  void* cr, void* ws, int B, int N, int Np, int m, int dz,
                  cudaStream_t st PX_CR_PARAM) {
  using T = double;
  T* D = static_cast<T*>(ws);
  T* U = D + (long long)B * N * m * m;
  T* Y = U + (long long)B * N * m * m;
  T* wcr = Y + 3LL * B * N * m * dz;
  int rc = px::launch_condense<T>(static_cast<const Ti*>(Xi), static_cast<const Ti*>(C),
                                  static_cast<const Ti*>(Rdiag), static_cast<const Ti*>(Cnext),
                                  D, U, Y, B, N, m, dz, st PX_CR_ARG(stamps));
  if (rc) return rc;
  const px::Rows<T> rows{px::Knots<T>{D, U, (long long)N * m * m, (long long)N * m * m, N},
                         1, N, 0, N, N - 1};
  return px::launch_cr_factor<T>(rows, B, Np, m, static_cast<Ti*>(cr), 3LL * Np * m * m, wcr,
                                 st PX_CR_ARG(stamps));
}

}  // namespace

// Workspace of the factor, in float64 elements per problem.
extern "C" long long px_cr_factor_ws(int N, int Np, int m, int dz) {
  return factor_ws(N, Np, m, dz);
}

// m <= 64 (chol_inv). Under PX_CR_TIMING the stamps (8 a launch) of the
// first thread block of each launch follow the stream; px_cr_timing_kinds
// then names the launches.
extern "C" int px_cr_factor(int is_f64, const void* Xi, const void* C,
                            const void* Rdiag, const void* Cnext, void* cr,
                            void* ws, int B, int N, int Np, int m, int dz,
                            void* stream PX_CR_PARAM) {
  if (m < 1 || m > px::kMaxCholM || N < 1 || Np < N) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef PX_CR_TIMING
  px::g_nst = 0;
#endif
  return is_f64 ? launch_factor<double>(Xi, C, Rdiag, Cnext, cr, ws, B, N, Np, m, dz, st PX_CR_ARG(stamps))
                : launch_factor<float>(Xi, C, Rdiag, Cnext, cr, ws, B, N, Np, m, dz, st PX_CR_ARG(stamps));
}

#ifdef PX_CR_TIMING
// The kinds of the last timed call's launches (kind + 256 level: 0 the
// condensation, 1 an elimination, 2 an update, 3 the root) into out;
// returns their number.
extern "C" int px_cr_timing_kinds(int* out) {
  for (int q = 0; q < px::g_nst; ++q) out[q] = px::g_kinds[q];
  return px::g_nst;
}
#endif
