"""Knot-partitioned block-tridiagonal KKT solves (kernel K9).

The port of `piccolax.parallel.sharded_kkt`: the SPIKE partition of the
knot axis behind `IPMOptions(kkt_backend="knot")`. Each of P partitions
owns L = N / P contiguous rows [f, i_1 .. i_k, l] (k = L - 2), factors its
interior block T by cyclic reduction, and reduces itself to two interface
rows:

    D_f  = D_f - U_f (T^{-1})_{1,1} U_f^T      r_f = r_f - U_f (T^{-1} r_int)_1
    D_l  = D_l - U_l^T (T^{-1})_{k,k} U_l      r_l = r_l - U_l^T (T^{-1} r_int)_k
    U_fl = -U_f (T^{-1})_{1,k} U_l             U_x = S[l_p, f_{p+1}]

The 2P interface rows form a block-tridiagonal system of their own, solved
by cyclic reduction; then x_int = T^{-1} r_int - (T^{-1} e_1 U_f^T) x_f
- (T^{-1} e_k U_l) x_l.

Where piccolax shards the knot axis over a `Mesh` axis, the port takes
`mesh`, the number of partitions P on the one card (the counterpart of
`mesh.shape[knot_axis]`). Each function takes a leading batch of problems
(piccolax's take one, except the 2D batched form). Every `*_plain`
function keeps the partition as a tensor axis [B, P, L, ...]: the
all_gather is a reshape to [B, 2P, ...], each ppermute a shift along P
with zero fill. The wrappers run the plain version for tensors on the CPU
and launch K9 (`csrc/knot.cu`) for tensors on the card: the factor a
launch per step and level, the solve three launches of thread-block
clusters (a cluster per partition and problem, then per problem).

Factor layout (shared by the plain versions and the kernel): a dict with
the knot factors Xi [B, N, dz, dz] (condensed form only), C and Cnext as
given, fT [B, P, 3, Npk, m, m] the interior CR factors (Npk = k padded to
a power of two), spike [B, P, k, m, 2m] = T^{-1} [e_1 U_f^T | e_k U_l],
Ub [B, P, 2, m, m] = (U_f, U_l) and f_if [B, 3, Npi, m, m] the interface
factor (Npi = 2P padded).
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..solver.kkt import (_MAX_M, _check_kkt_shapes, _cuda_or_cpu, _pow2_pad,
                          chol_inv_factor, chol_inv_factor_plain, cr_factor,
                          cr_solve)

__all__ = [
    "spd_tridiag_solve_ref",
    "sharded_spd_tridiag_solve", "sharded_spd_tridiag_solve_plain",
    "batched_sharded_spd_tridiag_solve", "batched_sharded_spd_tridiag_solve_plain",
    "knot_condense_factor", "knot_condense_factor_plain",
    "knot_condensed_factor", "knot_condensed_factor_plain",
    "knot_condensed_solve", "knot_condensed_solve_plain",
]


def check_partitions(N: int, mesh) -> int:
    """P = mesh after checking that P partitions of >= 3 knots tile N."""
    P = int(mesh)
    if P < 1 or N % P or N // P < 3:
        raise ValueError(f"N={N} must be divisible by n_dev={P} with chunks >= 3")
    return P


def spd_tridiag_solve_ref(diag, upper, rhs):
    """Single-partition reference: S x = rhs by cyclic reduction (plain)."""
    return cr_solve(cr_factor(diag, upper), rhs)


def _perm_up(x):
    """[B, P, ...]: partition p receives partition p + 1's entry; the last
    receives zeros (piccolax's _perm_up ppermute)."""
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)


def _perm_down(x):
    """[B, P, ...]: partition p receives partition p - 1's entry; the first
    receives zeros (piccolax's _perm_down ppermute)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _next_row(x):
    """[B, P, L, ...] -> row j holds row j + 1, across the partition edge."""
    return torch.cat([x[:, :, 1:], _perm_up(x[:, :, :1])], dim=2)


def _spike_factor_plain(D, U):
    """Partition factors of the system with diagonal D [B, P, L, m, m] and
    upper couplings U [B, P, L, m, m] (U[:, p, L-1] couples to partition
    p + 1's first row; zero on the last)."""
    B, P, L, m, _ = D.shape
    k = L - 2
    fT = cr_factor(D[:, :, 1:L - 1], U[:, :, 1:L - 2])
    U_f, U_l, U_x = U[:, :, 0], U[:, :, L - 2], U[:, :, L - 1]
    cols = D.new_zeros(B, P, k, m, 2 * m)
    cols[:, :, 0, :, :m] = U_f.mT
    cols[:, :, k - 1, :, m:] = U_l
    spike = cr_solve(fT, cols)
    Df = D[:, :, 0] - U_f @ spike[:, :, 0, :, :m]
    Dl = D[:, :, L - 1] - U_l.mT @ spike[:, :, k - 1, :, m:]
    Ufl = -U_f @ spike[:, :, 0, :, m:]
    d_all = torch.stack([Df, Dl], dim=2).reshape(B, 2 * P, m, m)
    u_all = torch.stack([Ufl, U_x], dim=2).reshape(B, 2 * P, m, m)
    return dict(fT=fT, spike=spike, Ub=torch.stack([U_f, U_l], dim=2),
                f_if=cr_factor(d_all, u_all[:, :-1]))


def _spike_solve_plain(f, b):
    """x of the partitioned system for b [B, P, L, m, r]; same shape."""
    B, P, L, m, r = b.shape
    k = L - 2
    U_f, U_l = f["Ub"][:, :, 0], f["Ub"][:, :, 1]
    r_sol = cr_solve(f["fT"], b[:, :, 1:L - 1])
    rf = b[:, :, 0] - U_f @ r_sol[:, :, 0]
    rl = b[:, :, L - 1] - U_l.mT @ r_sol[:, :, k - 1]
    x_if = cr_solve(f["f_if"], torch.stack([rf, rl], dim=2).reshape(B, 2 * P, m, r))
    x_f, x_l = x_if[:, 0::2, None], x_if[:, 1::2, None]
    spike = f["spike"]
    x_int = r_sol - spike[..., :m] @ x_f - spike[..., m:] @ x_l
    return torch.cat([x_f, x_int, x_l], dim=2)


def batched_sharded_spd_tridiag_solve_plain(diag, upper, rhs, mesh):
    """Plain version of the batched partitioned solve (arguments as
    `batched_sharded_spd_tridiag_solve`)."""
    squeeze = rhs.dim() == 3
    if squeeze:
        rhs = rhs[..., None]
    B, N, m, _ = diag.shape
    P = check_partitions(N, mesh)
    L = N // P
    upper_p = torch.cat([upper, upper.new_zeros(B, 1, m, m)], dim=1)
    f = _spike_factor_plain(diag.reshape(B, P, L, m, m), upper_p.reshape(B, P, L, m, m))
    x = _spike_solve_plain(f, rhs.reshape(B, P, L, m, -1)).reshape(rhs.shape)
    return x[..., 0] if squeeze else x


def batched_sharded_spd_tridiag_solve(diag, upper, rhs, mesh):
    """Many SPD block-tridiagonal systems S x = rhs at once, each with its
    knot axis cut into `mesh` = P partitions: diag [B, N, m, m],
    upper [B, N-1, m, m], rhs [B, N, m(, r)]; N divisible by P with
    N / P >= 3. piccolax's 2D (batch x knot) mesh form; on one card the
    batch axis is the kernel's grid and needs no divisibility.

    Replaces piccolax/parallel/sharded_kkt.py:277 (body
    _local_partition_solve :64). One K9 factor and one K9 solve
    (csrc/knot.cu), one C call counted as one launch.
    """
    if not _cuda_or_cpu(diag, "batched_sharded_spd_tridiag_solve"):
        return batched_sharded_spd_tridiag_solve_plain(diag, upper, rhs, mesh)
    squeeze = rhs.dim() == 3
    if squeeze:
        rhs = rhs[..., None]
    if diag.dim() != 4 or diag.shape[-1] != diag.shape[-2]:
        raise ValueError(f"diag [B, N, m, m] expected, got {tuple(diag.shape)}")
    B, N, m, _ = diag.shape
    r = rhs.shape[-1]
    P = check_partitions(N, mesh)
    if m > _MAX_M:
        raise ValueError(f"blocks up to {_MAX_M} expected, got m={m}")
    _kernels.require(diag, "knot_tridiag_solve diag")
    _kernels.require(upper, "knot_tridiag_solve upper", (B, N - 1, m, m), like=diag)
    _kernels.require(rhs, "knot_tridiag_solve rhs", (B, N, m, r), like=diag)
    f = _factor_buffers(diag, B, N, P, m)
    lib = _kernels.load("knot")
    fws = torch.empty(lib.px_knot_factor_ws(B, N, P, m, 0), dtype=diag.dtype,
                      device=diag.device)
    sws = torch.empty(lib.px_knot_solve_ws(B, N, P, m, 0, r), dtype=diag.dtype,
                      device=diag.device)
    out = torch.empty_like(rhs)
    rc = lib.px_knot_tridiag_solve(
        _kernels.is_f64(diag), diag.data_ptr(), upper.data_ptr(), rhs.data_ptr(),
        out.data_ptr(), f["fT"].data_ptr(), f["spike"].data_ptr(), f["Ub"].data_ptr(),
        f["f_if"].data_ptr(), fws.data_ptr(), sws.data_ptr(), B, N, P, m, r,
        _kernels.stream_handle(diag))
    _kernels.LAUNCHES["knot_tridiag_solve"] += 1
    _kernels.check(rc, "batched_sharded_spd_tridiag_solve")
    return out[..., 0] if squeeze else out


def sharded_spd_tridiag_solve_plain(diag, upper, rhs, mesh):
    """Plain version of `sharded_spd_tridiag_solve`."""
    return batched_sharded_spd_tridiag_solve_plain(diag[None], upper[None],
                                                   rhs[None], mesh)[0]


def sharded_spd_tridiag_solve(diag, upper, rhs, mesh):
    """Solve the SPD block-tridiagonal system S x = rhs with its knot axis
    cut into `mesh` = P partitions: diag [N, m, m], upper [N-1, m, m],
    rhs [N, m] or [N, m, r]; N divisible by P with N / P >= 3. Returns x
    shaped as rhs.

    Replaces piccolax/parallel/sharded_kkt.py:319 (body
    _local_partition_solve :64): the batched form at B = 1.
    """
    return batched_sharded_spd_tridiag_solve(diag[None], upper[None], rhs[None],
                                             mesh)[0]


def _factor_shapes(B, N, P, m):
    """Shapes of the partition factors (module docstring)."""
    k = N // P - 2
    return dict(fT=(B, P, 3, _pow2_pad(k), m, m), spike=(B, P, k, m, 2 * m),
                Ub=(B, P, 2, m, m), f_if=(B, 3, _pow2_pad(2 * P), m, m))


def _factor_buffers(like, B, N, P, m):
    return {key: torch.empty(shape, dtype=like.dtype, device=like.device)
            for key, shape in _factor_shapes(B, N, P, m).items()}


def knot_condense_factor_plain(Xi, C, Rdiag, Cnext, mesh):
    """Plain version of `knot_condense_factor`."""
    B, N, m, dz = C.shape
    P = check_partitions(N, mesh)
    L = N // P
    Cn_p = torch.cat([Cnext, Cnext.new_zeros(B, 1, m, dz)], dim=1)
    XiT = Xi.mT.reshape(B, P, L, dz, dz)
    Y = C.reshape(B, P, L, m, dz) @ XiT
    Yn = Cn_p.reshape(B, P, L, m, dz) @ _next_row(XiT)
    D = Y @ Y.mT + Yn @ Yn.mT + torch.diag_embed(Rdiag.reshape(B, P, L, m))
    U = Yn @ _next_row(Y).mT
    return dict(Xi=Xi, C=C, Cnext=Cnext, **_spike_factor_plain(D, U))


def knot_condense_factor(Xi, C, Rdiag, Cnext, mesh):
    """K9 factor from the knot factors Xi [B, N, dz, dz] of K1 (Pinv =
    Xi^T Xi): the condensation onto the dual system, every partition's
    interior factor, SPIKE columns and interface rows, then the interface
    factor, each step a launch (per level where it has levels) of a thread
    block or warp per row: 5 log2(Npk) + 2 log2(Npi) + 6 kernel launches
    in one call (csrc/knot.cu). Returns the factor dict."""
    if not _cuda_or_cpu(Xi, "knot_condense_factor"):
        return knot_condense_factor_plain(Xi, C, Rdiag, Cnext, mesh)
    B, N, m, dz = _check_kkt_shapes(C, Cnext, "knot_condense_factor")
    P = check_partitions(N, mesh)
    _kernels.require(Xi, "knot_condense_factor Xi", (B, N, dz, dz), like=C)
    _kernels.require(Rdiag, "knot_condense_factor Rdiag", (B, N, m), like=C)
    f = _factor_buffers(C, B, N, P, m)
    lib = _kernels.load("knot")
    ws = torch.empty(lib.px_knot_factor_ws(B, N, P, m, dz), dtype=C.dtype,
                     device=C.device)
    rc = lib.px_knot_factor(_kernels.is_f64(C), Xi.data_ptr(), C.data_ptr(),
                            Rdiag.data_ptr(), Cnext.data_ptr(), f["fT"].data_ptr(),
                            f["spike"].data_ptr(), f["Ub"].data_ptr(),
                            f["f_if"].data_ptr(), ws.data_ptr(), B, N, P, m, dz,
                            _kernels.stream_handle(C))
    _kernels.LAUNCHES["knot_factor"] += 1
    _kernels.check(rc, "knot_condense_factor")
    return dict(Xi=Xi, C=C, Cnext=Cnext, **f)


def knot_condensed_factor_plain(Pm, C, Rdiag, Cnext, mesh):
    """Plain version of `knot_condensed_factor`."""
    return knot_condense_factor_plain(chol_inv_factor_plain(Pm), C, Rdiag, Cnext, mesh)


def knot_condensed_factor(Pm, C, Rdiag, Cnext, mesh):
    """Factor the condensed KKT with the knot axis cut into `mesh` = P
    partitions: Pm [B, N, dz, dz] (PD), C [B, N, m, dz], Rdiag [B, N, m],
    Cnext [B, N-1, m, dz]; N divisible by P with N / P >= 3. Returns the
    factor dict (module docstring) for `knot_condensed_solve`, reusable
    across right-hand sides like `condensed_factor`'s. NaN where a block is
    not numerically PD, the IPM's direction test.

    Replaces piccolax/parallel/sharded_kkt.py:236 (body _knot_factor_body
    :149): K1 on the knot blocks, then the K9 factor.
    """
    if not _cuda_or_cpu(Pm, "knot_condensed_factor"):
        return knot_condensed_factor_plain(Pm, C, Rdiag, Cnext, mesh)
    check_partitions(C.shape[-3], mesh)
    return knot_condense_factor(chol_inv_factor(Pm), C, Rdiag, Cnext, mesh)


def _check_factor(factors, mesh):
    P = factors["fT"].shape[1]
    if int(mesh) != P:
        raise ValueError(f"factor of {P} partitions, mesh={mesh}")
    return P


def knot_condensed_solve_plain(factors, rhs, mesh, dz):
    """Plain version of `knot_condensed_solve`."""
    squeeze = rhs.dim() == 3
    if squeeze:
        rhs = rhs[..., None]
    P = _check_factor(factors, mesh)
    Xi, C, Cnext = factors["Xi"], factors["C"], factors["Cnext"]
    B, N, m, _ = C.shape
    L, r = N // P, rhs.shape[-1]
    Cq = C.reshape(B, P, L, m, dz)
    Cnq = torch.cat([Cnext, Cnext.new_zeros(B, 1, m, dz)], dim=1).reshape(B, P, L, m, dz)
    rz = rhs[..., :dz, :].reshape(B, P, L, dz, r)
    rc = rhs[..., dz:, :].reshape(B, P, L, m, r)
    Xq = Xi.reshape(B, P, L, dz, dz)
    t = Xq.mT @ (Xq @ rz)
    b = Cq @ t - rc + Cnq @ _next_row(t)
    lam = _spike_solve_plain(factors, b)
    w = rz - Cq.mT @ lam
    lam_prev = torch.cat([_perm_down(lam[:, :, -1:]), lam[:, :, :-1]], dim=2)
    Cn_prev = torch.cat([_perm_down(Cnq[:, :, -1:]), Cnq[:, :, :-1]], dim=2)
    w = w - Cn_prev.mT @ lam_prev
    z = Xq.mT @ (Xq @ w)
    x = torch.cat([z, lam], dim=-2).reshape(B, N, dz + m, r)
    return x[..., 0] if squeeze else x


def knot_condensed_solve(factors, rhs, mesh, dz):
    """Solve the condensed KKT given `knot_condensed_factor`'s factors:
    rhs [B, N, dz + m(, r)] ordered (z, lam) per knot; returns the same
    shape.

    Replaces piccolax/parallel/sharded_kkt.py:259 (body _knot_solve_body
    :194): one K9 solve, three launches of csrc/solve_engine.cuh's cluster
    kernel, counted as one: (c1) a thread-block cluster a partition and
    problem runs the dual rhs, the interior's CR solve and the interface
    rows; (c2) a cluster a problem, the interface solve; (c3) a cluster a
    partition and problem, x_int and the primal recovery. The cluster sizes
    are planned from the card's SM count (`px_knot_solve_cluster`).
    """
    if not _cuda_or_cpu(rhs, "knot_condensed_solve"):
        return knot_condensed_solve_plain(factors, rhs, mesh, dz)
    squeeze = rhs.dim() == 3
    if squeeze:
        rhs = rhs[..., None]
    P = _check_factor(factors, mesh)
    Xi, C, Cnext = factors["Xi"], factors["C"], factors["Cnext"]
    B, N, m, dz_c = _check_kkt_shapes(C, Cnext, "knot_condensed_solve")
    if dz_c != dz:
        raise ValueError("knot_condensed_solve: dz does not match C")
    r = rhs.shape[-1]
    _kernels.require(rhs, "knot_condensed_solve rhs", (B, N, dz + m, r), like=C)
    _kernels.require(Xi, "knot_condensed_solve Xi", (B, N, dz, dz), like=C)
    for key, shape in _factor_shapes(B, N, P, m).items():
        _kernels.require(factors[key], f"knot_condensed_solve {key}", shape, like=C)
    lib = _kernels.load("knot")
    ws = torch.empty(lib.px_knot_solve_ws(B, N, P, m, dz, r), dtype=rhs.dtype,
                     device=rhs.device)
    out = torch.empty_like(rhs)
    rc = lib.px_knot_solve(_kernels.is_f64(rhs), Xi.data_ptr(), C.data_ptr(),
                           Cnext.data_ptr(), factors["fT"].data_ptr(),
                           factors["spike"].data_ptr(), factors["Ub"].data_ptr(),
                           factors["f_if"].data_ptr(), rhs.data_ptr(), out.data_ptr(),
                           ws.data_ptr(), B, N, P, m, dz, r, _kernels.stream_handle(rhs))
    _kernels.count_solve("knot_solve", r)
    _kernels.check(rc, "knot_condensed_solve")
    return out[..., 0] if squeeze else out
