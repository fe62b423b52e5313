"""Block-tridiagonal KKT solves of the IPM (kernels K1, K2, K3, K7, K8).

The per-iteration KKT with per-knot blocks [[P_k, C_k^T], [C_k, -diag(R_k)]]
and coupling Cnext (constraint rows of knot k touch z_{k+1}) condenses,
when every P_k is PD, onto the SPD block-tridiagonal dual system

    S[k,k]   = C_k Pinv_k C_k^T + Cn_k Pinv_{k+1} Cn_k^T + diag(R_k)
    S[k,k+1] = Cn_k Pinv_{k+1} C_{k+1}^T

solved by block cyclic reduction over power-of-two-padded levels, as in
`piccolax.solver.kkt` (kkt_backend "cr"). The "qd" backend factors the
same quasidefinite system by the sequential block recursion along the
knots instead (`qd_factor` / `qd_solve`, K7). Every function takes a
leading batch of problems.

Each kernel wrapper runs its `*_plain` PyTorch version for tensors on the
CPU and launches its CUDA kernel (`csrc/`) for tensors on the card; NaNs
signal a block that is not numerically PD, the IPM's direction test.

Factor layout (shared by the plain versions and the kernels):
`condensed_factor` returns (Xi [B, N, dz, dz], cr [B, 3, Np, m, m]); cr
holds, per CR level l (n = Np >> l rows), the Cholesky-inverse factors Xi,
and the couplings Ul, Ur of its n/2 odd rows at slots off_l .. off_l+n/2-1
with off_l = Np - n; slot Np-1 of plane 0 is the root factor. `qd_factor` returns
(Pinv [B, N, dz, dz], Sinv [B, N, m, m]), the inverses of the Schur-updated
primal blocks and of the dual Schur complements, knot by knot.
"""

from __future__ import annotations

import math

import torch

from .. import _kernels

__all__ = [
    "chol_inv_factor", "chol_inv_factor_plain", "spd_inv",
    "psd_clamp", "psd_clamp_plain",
    "cr_factor", "cr_solve",
    "condense_cr_factor", "condense_cr_factor_plain",
    "condensed_factor", "condensed_factor_plain",
    "condensed_solve", "condensed_solve_plain",
    "qd_factor", "qd_factor_plain", "qd_solve", "qd_solve_plain",
    "tri_lower_inv", "tri_lower_inv_plain",
]

# Block limit of K1, K2, K3, K8 and K9: a lane owns two rows (or columns).
# K7's, 64 in float32 and 48 in float64, is its library's px_qd_max_width.
_MAX_M = 64


def _cuda_or_cpu(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{what}: unsupported device {t.device}")


# --------------------------------------------------------------------------- #
# K1: Cholesky-inverse factor
# --------------------------------------------------------------------------- #


def chol_inv_factor_plain(A):
    """Plain version of K1: Xi with A^{-1} = Xi^T Xi for SPD A [..., m, m].

    Jacobi-equilibrated Cholesky and triangular inverse; a block that is
    not positive definite comes back all NaN. The same lower-triangular Xi
    as piccolax's recursive blocked inverse (it is unique).
    """
    m = A.shape[-1]
    tiny = 1e-300 if A.dtype == torch.float64 else 0.0   # 1e-300 -> 0 in f32
    d = torch.sqrt(torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=tiny))
    L, info = torch.linalg.cholesky_ex(A / d[..., :, None] / d[..., None, :])
    eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(L.shape)
    Xi = torch.linalg.solve_triangular(L, eye, upper=False) / d[..., None, :]
    return torch.where((info == 0)[..., None, None], Xi, torch.full_like(Xi, math.nan))


def chol_inv_factor(A):
    """K1: Xi with A^{-1} = Xi^T Xi for SPD A [..., m, m], m <= 64.

    Replaces piccolax/solver/kkt.py: chol_inv_factor. Bound on the H100:
    bytes (one read of A, one write of Xi). A block on an H-lane segment of
    a warp (H = 8 up to 16 wide, 16 up to 32, 32 past it), a lane owning
    rows l and l + H in registers, one shared-memory exchange a pivot (the
    pivot row written once, read by every lane); see csrc/chol_inv.cu.
    """
    if not _cuda_or_cpu(A, "chol_inv_factor"):
        return chol_inv_factor_plain(A)
    m = A.shape[-1]
    _kernels.require(A, "chol_inv_factor")
    if A.dim() < 2 or A.shape[-2] != m or m > _MAX_M:
        raise ValueError(f"chol_inv_factor: square blocks up to {_MAX_M} "
                         f"expected, got {tuple(A.shape)}")
    Xi = torch.empty_like(A)
    lib = _kernels.load("chol_inv")
    rc = lib.px_chol_inv_factor(_kernels.is_f64(A), A.data_ptr(), Xi.data_ptr(),
                                A.numel() // (m * m), m,
                                _kernels.stream_handle(A))
    _kernels.LAUNCHES["chol_inv_factor"] += 1
    _kernels.check(rc, "chol_inv_factor")
    return Xi


def spd_inv(A):
    """Explicit inverse of SPD A via `chol_inv_factor` (NaN if not PD)."""
    Xi = chol_inv_factor(A)
    return Xi.mT @ Xi


# --------------------------------------------------------------------------- #
# K2: Newton-Schulz PSD clamp
# --------------------------------------------------------------------------- #


def _clamp_floor(floor_rel, iters):
    return max(floor_rel, 0.5 * 1.5 ** (-iters))


def psd_clamp_plain(W, floor_rel, iters: int = 32, mode: str = "pos"):
    """Plain version of K2 (the arithmetic of piccolax's psd_clamp)."""
    n = W.shape[-1]
    s = torch.amax(torch.sum(torch.abs(W), dim=-1), dim=-1)
    s = torch.clamp(s, min=1e-30)
    Y = W / s[..., None, None]
    S = Y
    for _ in range(iters):
        S = 1.5 * S - ((0.5 * S) @ S) @ S
    absW = S @ Y
    Wpd = absW if mode == "abs" else 0.5 * (Y + absW)
    Wpd = 0.5 * (Wpd + Wpd.mT) * s[..., None, None]
    floor = _clamp_floor(floor_rel, iters) * torch.clamp(s, min=1.0)
    eye = torch.eye(n, dtype=W.dtype, device=W.device)
    return Wpd + floor[..., None, None] * eye


def psd_clamp(W, floor_rel, iters: int = 32, mode: str = "pos"):
    """K2: PSD convexification of symmetric W [..., n, n], n <= 64.

    mode "pos": ~U max(lam, 0) U^T + floor I; mode "abs": ~U |lam| U^T +
    floor I, floor = max(floor_rel, 0.5 * 1.5^-iters) * max(1, s).
    W must be exactly symmetric (W_ij == W_ji bit for bit), as the IPM's
    blocks are. The plain version takes any W; on the card the float32
    kernel reads W's upper triangle, so both kernels test the symmetry and
    return an all-NaN block where it fails.

    Replaces piccolax/solver/kkt.py: psd_clamp. Bound on the H100:
    arithmetic (2 symmetric products, n^2 (n + 1) multiply-adds, per
    sweep). Register tiles padded to 16, 32, 48 or 64 wide; float32 keeps S
    exactly symmetric and sums the upper triangle, float64 runs on the
    tensor cores (DMMA); see csrc/psd_clamp.cu.
    """
    if mode not in ("pos", "abs"):
        raise ValueError(f"psd_clamp: unknown mode {mode!r}")
    if not _cuda_or_cpu(W, "psd_clamp"):
        return psd_clamp_plain(W, floor_rel, iters, mode)
    n = W.shape[-1]
    _kernels.require(W, "psd_clamp")
    if W.dim() < 2 or W.shape[-2] != n or n > _MAX_M:
        raise ValueError(f"psd_clamp: square blocks up to {_MAX_M} expected, "
                         f"got {tuple(W.shape)}")
    out = torch.empty_like(W)
    lib = _kernels.load("psd_clamp")
    rc = lib.px_psd_clamp(_kernels.is_f64(W), W.data_ptr(), out.data_ptr(),
                          W.numel() // (n * n), n, int(iters),
                          int(mode == "abs"), float(_clamp_floor(floor_rel, iters)),
                          _kernels.stream_handle(W))
    _kernels.LAUNCHES["psd_clamp"] += 1
    _kernels.check(rc, "psd_clamp")
    return out


# --------------------------------------------------------------------------- #
# K3: cyclic reduction and the condensed KKT
# --------------------------------------------------------------------------- #


def _pow2_pad(N: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(N, 1))))


def _shift_down(X):
    """[..., n, a, b] -> row j holds X[j-1], row 0 zero."""
    return torch.cat([torch.zeros_like(X[..., :1, :, :]), X[..., :-1, :, :]],
                     dim=-3)


def cr_factor(D, U):
    """Cyclic-reduction factor (plain) of the SPD block-tridiagonal matrix
    with diagonal D [..., N, m, m] and upper blocks U [..., N-1, m, m].
    Returns the packed cr [..., 3, Np, m, m] (module docstring)."""
    *lead, N, m, _ = D.shape
    Np = _pow2_pad(N)
    kw = dict(dtype=D.dtype, device=D.device)
    D = torch.cat([D, torch.eye(m, **kw).expand(*lead, Np - N, m, m)], dim=-3)
    U = torch.cat([U, torch.zeros(*lead, Np - U.shape[-3], m, m, **kw)], dim=-3)
    cr = torch.zeros(*lead, 3, Np, m, m, **kw)
    n, off = Np, 0
    while n > 1:
        h = n // 2
        Xi = chol_inv_factor_plain(D[..., 1::2, :, :])
        Ul = U[..., 0::2, :, :]
        Ur = U[..., 1::2, :, :]
        Gl = Xi @ Ul.mT
        Gr = Xi @ Ur
        Gr_s = _shift_down(Gr)
        D = D[..., 0::2, :, :] - Gr_s.mT @ Gr_s - Gl.mT @ Gl
        U = -Gl.mT @ Gr
        cr[..., 0, off:off + h, :, :] = Xi
        cr[..., 1, off:off + h, :, :] = Ul
        cr[..., 2, off:off + h, :, :] = Ur
        n, off = h, off + h
    cr[..., 0, Np - 1, :, :] = chol_inv_factor_plain(D[..., 0, :, :])
    return cr


def cr_solve(cr, rhs):
    """Solve with the packed factor of `cr_factor` (plain). rhs [..., N, m, r]."""
    Np = cr.shape[-3]
    *lead, N, m, r = rhs.shape
    rhs = torch.cat([rhs, rhs.new_zeros(*lead, Np - N, m, r)], dim=-3)
    reduced = []
    n, off = Np, 0
    while n > 1:
        h = n // 2
        Xi = cr[..., 0, off:off + h, :, :]
        Ul = cr[..., 1, off:off + h, :, :]
        Ur = cr[..., 2, off:off + h, :, :]
        r_odd = rhs[..., 1::2, :, :]
        reduced.append(r_odd)
        t = Xi.mT @ (Xi @ r_odd)
        rhs = rhs[..., 0::2, :, :] - _shift_down(Ur).mT @ _shift_down(t) - Ul @ t
        n, off = h, off + h
    XR = cr[..., 0, Np - 1, :, :]
    x = (XR.mT @ (XR @ rhs[..., 0, :, :]))[..., None, :, :]
    half = 1
    for r_odd in reversed(reduced):
        lo = Np - 2 * half
        Xi = cr[..., 0, lo:lo + half, :, :]
        Ul = cr[..., 1, lo:lo + half, :, :]
        Ur = cr[..., 2, lo:lo + half, :, :]
        x_right = torch.cat([x[..., 1:, :, :], torch.zeros_like(x[..., :1, :, :])],
                            dim=-3)
        b = r_odd - Ul.mT @ x - Ur @ x_right
        x_odd = Xi.mT @ (Xi @ b)
        x = torch.stack([x, x_odd], dim=-3).reshape(*lead, 2 * half, m, r)
        half *= 2
    return x[..., :N, :, :]


def condense_cr_factor_plain(Xi, C, Rdiag, Cnext):
    """Plain version of the K3 factor: from the knot factors Xi
    [..., N, dz, dz] (Pinv = Xi^T Xi), condense onto the dual system and
    factor it by cyclic reduction; returns the packed cr."""
    XiT = Xi.mT
    Y = C @ XiT
    Yn = Cnext @ XiT[..., 1:, :, :]
    D = Y @ Y.mT
    D = torch.cat([D[..., :-1, :, :] + Yn @ Yn.mT, D[..., -1:, :, :]], dim=-3)
    D = D + torch.diag_embed(Rdiag)
    U = Yn @ Y[..., 1:, :, :].mT
    return cr_factor(D, U)


def condensed_factor_plain(P, C, Rdiag, Cnext):
    """Plain version of the condensed factor: P [..., N, dz, dz] (PD),
    C [..., N, m, dz], Rdiag [..., N, m], Cnext [..., N-1, m, dz]."""
    Xi = chol_inv_factor_plain(P)
    return Xi, condense_cr_factor_plain(Xi, C, Rdiag, Cnext)


def condensed_solve_plain(factors, C, Cnext, rhs, dz):
    """Plain version of the condensed solve. rhs [..., N, dz + m, r]."""
    Xi, cr = factors
    rz, rc = rhs[..., :dz, :], rhs[..., dz:, :]
    XiT = Xi.mT
    t = XiT @ (Xi @ rz)
    b = C @ t - rc
    b = torch.cat([b[..., :-1, :, :] + Cnext @ t[..., 1:, :, :],
                   b[..., -1:, :, :]], dim=-3)
    lam = cr_solve(cr, b)
    w = rz - C.mT @ lam
    w = torch.cat([w[..., :1, :, :],
                   w[..., 1:, :, :] + (-(Cnext.mT @ lam[..., :-1, :, :]))],
                  dim=-3)
    z = XiT @ (Xi @ w)
    return torch.cat([z, lam], dim=-2)


def _check_kkt_shapes(C, Cnext, what, min_knots=2, max_dz=math.inf,
                      max_m=_MAX_M):
    """(B, N, m, dz) of the blocks a KKT kernel takes, after checking
    N >= min_knots, m <= max_m and dz <= max_dz."""
    if C.dim() != 4:
        raise ValueError(f"{what}: C [B, N, m, dz] expected, got {tuple(C.shape)}")
    B, N, m, dz = C.shape
    if N < min_knots or m > max_m or dz > max_dz:
        raise ValueError(f"{what}: N >= {min_knots}, m <= {max_m} and dz <= "
                         f"{max_dz} expected, got {tuple(C.shape)}")
    _kernels.require(C, f"{what} C")
    _kernels.require(Cnext, f"{what} Cnext", (B, N - 1, m, dz), like=C)
    return B, N, m, dz


# The workspaces below are freed when a wrapper returns, while its kernel
# may still run: safe because PyTorch's caching allocator hands memory out
# again in the order of the current stream, which the kernel is on.


def condense_cr_factor(Xi, C, Rdiag, Cnext):
    """K3 factor: condensation onto the dual system, then the CR levels, a
    launch per half level with a thread block (or warp) per row of every
    problem: 2 log2(Np) + 2 kernel launches in one call
    (csrc/condensed_cr.cu). Xi [B, N, dz, dz] are the knot factors of K1;
    returns cr in the dtype of Xi.

    The levels run in float64 for a float32 problem too, whose factor is
    rounded to float32 once (csrc/condensed_cr.cu says why)."""
    if not _cuda_or_cpu(Xi, "condense_cr_factor"):
        return condense_cr_factor_plain(Xi, C, Rdiag, Cnext)
    B, N, m, dz = _check_kkt_shapes(C, Cnext, "condense_cr_factor")
    _kernels.require(Xi, "condense_cr_factor Xi", (B, N, dz, dz), like=C)
    _kernels.require(Rdiag, "condense_cr_factor Rdiag", (B, N, m), like=C)
    Np = _pow2_pad(N)
    lib = _kernels.load("condensed_cr")
    cr = torch.empty(B, 3, Np, m, m, dtype=Xi.dtype, device=Xi.device)
    ws = torch.empty(B * lib.px_cr_factor_ws(N, Np, m, dz), dtype=torch.float64,
                     device=Xi.device)
    rc = lib.px_cr_factor(_kernels.is_f64(Xi), Xi.data_ptr(), C.data_ptr(),
                          Rdiag.data_ptr(), Cnext.data_ptr(), cr.data_ptr(),
                          ws.data_ptr(), B, N, Np, m, dz,
                          _kernels.stream_handle(Xi))
    _kernels.LAUNCHES["condensed_factor"] += 1
    _kernels.check(rc, "condense_cr_factor")
    return cr


def condensed_factor(P, C, Rdiag, Cnext):
    """Factor of the condensed KKT for a batch of problems:
    P [B, N, dz, dz], C [B, N, m, dz], Rdiag [B, N, m], Cnext [B, N-1, m, dz].
    Returns (Xi, cr).

    Replaces piccolax/solver/kkt.py: condensed_factor over cr_factor: K1 on
    the knot blocks, then the K3 factor (`condense_cr_factor`). The KKT
    blocks are 12 x 12 on config 1 and 40 x 40 on config 3 (m <= 64); what
    bounds a factor is its chain of log2(Np) dependent levels.
    """
    if not _cuda_or_cpu(P, "condensed_factor"):
        return condensed_factor_plain(P, C, Rdiag, Cnext)
    Xi = chol_inv_factor(P)
    return Xi, condense_cr_factor(Xi, C, Rdiag, Cnext)


def condensed_solve(factors, C, Cnext, rhs, dz):
    """K3 solve of the full KKT given `condensed_factor` output.
    rhs [B, N, dz + m, r] ordered (z, lam) per knot; returns the same shape.

    Replaces piccolax/solver/kkt.py: condensed_solve over cr_solve. One
    launch, a thread-block cluster per problem and column, its size planned
    by the launcher from B r and the card's SMs; see csrc/cr_solve.cu.
    """
    if not _cuda_or_cpu(rhs, "condensed_solve"):
        return condensed_solve_plain(factors, C, Cnext, rhs, dz)
    Xi, cr = factors
    B, N, m, dz_c = _check_kkt_shapes(C, Cnext, "condensed_solve")
    if dz_c != dz:
        raise ValueError("condensed_solve: dz does not match C")
    r = rhs.shape[-1]
    Np = _pow2_pad(N)
    _kernels.require(Xi, "condensed_solve Xi", (B, N, dz, dz), like=C)
    _kernels.require(cr, "condensed_solve cr", (B, 3, Np, m, m), like=C)
    _kernels.require(rhs, "condensed_solve rhs", (B, N, dz + m, r), like=C)
    lib = _kernels.load("cr_solve")
    out = torch.empty_like(rhs)
    ws = torch.empty(B * lib.px_condensed_solve_ws(N, Np, m, dz, r),
                     dtype=rhs.dtype, device=rhs.device)
    rc_ = lib.px_condensed_solve(_kernels.is_f64(rhs), Xi.data_ptr(),
                                 C.data_ptr(), Cnext.data_ptr(), cr.data_ptr(),
                                 rhs.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                 B, N, Np, m, dz, r,
                                 _kernels.stream_handle(rhs))
    _kernels.count_solve("condensed_solve", r)
    _kernels.check(rc_, "condensed_solve")
    return out


# --------------------------------------------------------------------------- #
# K7: sequential quasidefinite recursion (kkt_backend "qd")
# --------------------------------------------------------------------------- #


def qd_factor_plain(P, C, Rdiag, Cnext):
    """Plain version of K7's factor, a loop over the knots of piccolax's
    qd_factor with the batch leading: P [..., N, dz, dz], C [..., N, m, dz],
    Rdiag [..., N, m], Cnext [..., N-1, m, dz] -> (Pinv, Sinv).

    P_eff = P_k + W^T W with W = Zi_{k-1} Cn_{k-1} and S = Y Y^T + diag(R)
    with Y = C Xi^T are Gram products, as piccolax forms them: C Pinv C^T
    through the explicit inverse loses PD-ness when P is ill-conditioned.
    A non-PD P_eff gives NaN from its knot on.
    """
    N = C.shape[-3]
    Pinvs, Sinvs = [], []
    Zi = None
    for k in range(N):
        P_eff = P[..., k, :, :]
        if k > 0:
            W = Zi @ Cnext[..., k - 1, :, :]
            P_eff = P_eff + W.mT @ W
        Xi = chol_inv_factor_plain(P_eff)
        Y = C[..., k, :, :] @ Xi.mT
        S = Y @ Y.mT + torch.diag_embed(Rdiag[..., k, :])
        Zi = chol_inv_factor_plain(0.5 * (S + S.mT))
        Pinvs.append(Xi.mT @ Xi)
        Sinvs.append(Zi.mT @ Zi)
    return torch.stack(Pinvs, dim=-3), torch.stack(Sinvs, dim=-3)


def _qd_block_apply(Pinv, Sinv, C, a, b):
    """Dt^{-1} applied to (a [..., dz, r], b [..., m, r]) at one knot:
    t = Pinv a, y = Sinv (C t - b), x = t - Pinv C^T y."""
    t = Pinv @ a
    y = Sinv @ (C @ t - b)
    return t - Pinv @ (C.mT @ y), y


def qd_solve_plain(factors, C, Cnext, rhs, dz):
    """Plain version of K7's solve: the forward and backward sweeps of
    piccolax's qd_solve. rhs [..., N, dz + m, r] ordered (z, lam)."""
    Pinv, Sinv = factors
    N = rhs.shape[-3]
    ys = [rhs[..., 0, :, :]]
    for k in range(1, N):
        y = ys[-1]
        _, w_lam = _qd_block_apply(Pinv[..., k - 1, :, :], Sinv[..., k - 1, :, :],
                                   C[..., k - 1, :, :], y[..., :dz, :], y[..., dz:, :])
        r = rhs[..., k, :, :]
        ys.append(torch.cat([r[..., :dz, :] - Cnext[..., k - 1, :, :].mT @ w_lam,
                             r[..., dz:, :]], dim=-2))
    xs = [None] * N
    x_next = None
    for k in range(N - 1, -1, -1):
        y = ys[k]
        b = y[..., dz:, :]
        if x_next is not None:
            b = b - Cnext[..., k, :, :] @ x_next[..., :dz, :]
        xz, xl = _qd_block_apply(Pinv[..., k, :, :], Sinv[..., k, :, :],
                                 C[..., k, :, :], y[..., :dz, :], b)
        x_next = xs[k] = torch.cat([xz, xl], dim=-2)
    return torch.stack(xs, dim=-3)


def qd_factor(P, C, Rdiag, Cnext):
    """K7 factor of the quasidefinite block-tridiagonal KKT for a batch of
    problems: P [B, N, dz, dz], C [B, N, m, dz], Rdiag [B, N, m],
    Cnext [B, N-1, m, dz] (m, dz <= 64 in float32, 48 in float64).
    Returns (Pinv, Sinv).

    Replaces piccolax/solver/kkt.py:194 qd_factor. The recursion is N
    knots deep and no batch hides that depth: a launch is the latency of
    N knot steps. One thread block per problem: four warps run the chain
    (Gram products between named barriers, two Cholesky inverses with rows
    in registers), four load the next knot's blocks and form Pinv and Sinv
    off the chain; see csrc/qd.cu. NaN from the knot of a non-PD P_eff
    on, in that problem only.
    """
    if not _cuda_or_cpu(P, "qd_factor"):
        return qd_factor_plain(P, C, Rdiag, Cnext)
    lib = _kernels.load("qd")
    cap = lib.px_qd_max_width(_kernels.is_f64(C))
    B, N, m, dz = _check_kkt_shapes(C, Cnext, "qd_factor", 1, cap, cap)
    _kernels.require(P, "qd_factor P", (B, N, dz, dz), like=C)
    _kernels.require(Rdiag, "qd_factor Rdiag", (B, N, m), like=C)
    Pinv = torch.empty_like(P)
    Sinv = torch.empty(B, N, m, m, dtype=P.dtype, device=P.device)
    rc = lib.px_qd_factor(_kernels.is_f64(P), P.data_ptr(), C.data_ptr(),
                          Rdiag.data_ptr(), Cnext.data_ptr(), Pinv.data_ptr(),
                          Sinv.data_ptr(), B, N, m, dz, _kernels.stream_handle(P))
    _kernels.LAUNCHES["qd_factor"] += 1
    _kernels.check(rc, "qd_factor")
    return Pinv, Sinv


def qd_solve(factors, C, Cnext, rhs, dz):
    """K7 solve with the factors of `qd_factor`; rhs [B, N, dz + m, r]
    ordered (z, lam) per knot; returns the same shape.

    Replaces piccolax/solver/kkt.py:252 qd_solve (with _qd_block_apply
    :243). The two sweeps are 2N - 1 dependent knot steps: a launch is
    their latency. One thread block per problem and up to four columns, a
    warp per column (lane l owning rows l and l + 32), while helper warps
    stage the next step's blocks in shared memory; see csrc/qd.cu. Widths
    as qd_factor.
    """
    if not _cuda_or_cpu(rhs, "qd_solve"):
        return qd_solve_plain(factors, C, Cnext, rhs, dz)
    Pinv, Sinv = factors
    lib = _kernels.load("qd")
    cap = lib.px_qd_max_width(_kernels.is_f64(C))
    B, N, m, dz_c = _check_kkt_shapes(C, Cnext, "qd_solve", 1, cap, cap)
    if dz_c != dz:
        raise ValueError("qd_solve: dz does not match C")
    r = rhs.shape[-1]
    _kernels.require(Pinv, "qd_solve Pinv", (B, N, dz, dz), like=C)
    _kernels.require(Sinv, "qd_solve Sinv", (B, N, m, m), like=C)
    _kernels.require(rhs, "qd_solve rhs", (B, N, dz + m, r), like=C)
    out = torch.empty_like(rhs)
    rc = lib.px_qd_solve(_kernels.is_f64(rhs), Pinv.data_ptr(), Sinv.data_ptr(),
                         C.data_ptr(), Cnext.data_ptr(), rhs.data_ptr(),
                         out.data_ptr(), B, N, m, dz, r,
                         _kernels.stream_handle(rhs))
    _kernels.count_solve("qd_solve", r)
    _kernels.check(rc, "qd_solve")
    return out


# --------------------------------------------------------------------------- #
# K8: lower-triangular inverse
# --------------------------------------------------------------------------- #


def tri_lower_inv_plain(L):
    """Plain version of K8: piccolax's nilpotent doubling. L = D(I + N)
    with N strictly lower, (I + N)^{-1} = prod_j (I + (-N)^(2^j)); returns
    (I + N)^{-1} D^{-1} for L [..., m, m]."""
    m = L.shape[-1]
    eye = torch.eye(m, dtype=L.dtype, device=L.device)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    X = -(L / d[..., :, None] - eye)
    acc = eye + X
    p = X
    for _ in range(max(0, math.ceil(math.log2(max(m, 2))) - 1)):
        p = p @ p
        acc = acc + acc @ p
    return acc / d[..., None, :]


def tri_lower_inv(L):
    """K8: inverse of every lower-triangular [m, m] block of L [..., m, m]
    (m <= 64); a zero on the diagonal gives inf / NaN, as in piccolax.

    Replaces piccolax/solver/kkt.py:58 tri_lower_inv. Bound on the H100:
    bytes (one read of L's lower triangle, one write of the inverse). A
    thread a column of the inverse, in registers, every thread of a block
    running the same rows of the forward substitution on L's rows
    broadcast from shared memory (several blocks a warp up to 16 wide, two
    warps a block past 32); see csrc/tri_inv.cu. The substitution rounds
    otherwise than the doubling: they agree relative to ||L^{-1}||. A zero
    on the diagonal gives an all-NaN block at m >= 3, as the doubling does,
    and at m <= 2 the doubling's one-step form, finite where it is.
    """
    if not _cuda_or_cpu(L, "tri_lower_inv"):
        return tri_lower_inv_plain(L)
    m = L.shape[-1]
    _kernels.require(L, "tri_lower_inv")
    if L.dim() < 2 or L.shape[-2] != m or m > _MAX_M:
        raise ValueError(f"tri_lower_inv: square blocks up to {_MAX_M} "
                         f"expected, got {tuple(L.shape)}")
    out = torch.empty_like(L)
    lib = _kernels.load("tri_inv")
    rc = lib.px_tri_lower_inv(_kernels.is_f64(L), L.data_ptr(), out.data_ptr(),
                              L.numel() // (m * m), m, _kernels.stream_handle(L))
    _kernels.LAUNCHES["tri_lower_inv"] += 1
    _kernels.check(rc, "tri_lower_inv")
    return out
