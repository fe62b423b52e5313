"""Matrix exponentials (kernels K4, K5 and K6).

- `expm_taylor_fixed` (K4), the collocation hot path: the Paterson-
  Stockmeyer Taylor approximant with a static squaring count of
  `piccolax.ops.expm`, order 8 in float32 and 12 otherwise.
- `expm_pade_fixed` (K6), the collocation path of a problem built with an
  integer `pade_order`: diagonal Pade [m/m] (m in 3, 5, 7, 9) with a
  static squaring count and the denominator inverted by 6 Newton-Schulz
  steps.
- `expm_fixed_derivatives`: either approximant with its exact first and
  second directional derivatives, carried on the block-triangular
  structure of the augmentations that piccolax's jacfwd / hessian
  differentiate (K4's and K6's derivative form).
- `expm` (K5), the rollout: scaling-and-squaring Pade-13 with a squaring
  count per matrix and the denominator inverted by Newton-Schulz.

On a CUDA tensor each wrapper launches its hand-written kernel (K4 and K6
in both forms: `csrc/expm_fixed.cu`; K5: `csrc/expm_pade13.cu`); on a CPU
tensor it runs its `*_plain` version, the same arithmetic in PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _kernels
from .._device import resolve_device

__all__ = ["TAYLOR_THETA", "PADE_ORDERS", "pade_radius", "expm_taylor_fixed",
           "expm_taylor_fixed_plain", "expm_pade_fixed", "expm_pade_fixed_plain",
           "expm_action", "expm_fixed", "expm_fixed_plain", "derivative_augmentations",
           "expm_fixed_derivatives", "expm_fixed_derivatives_plain",
           "expm_fixed_derivatives_dense", "MAX_DERIVATIVE_WIDTH", "expm",
           "expm_plain", "pade13_squarings", "anti_hermitian_by_squarings"]

_FACT = [1.0]
for _i in range(1, 14):
    _FACT.append(_FACT[-1] * _i)

# ||A|| / 2^s <= theta keeps the truncation below the working precision
TAYLOR_THETA = 0.33

_MAX_N = 32
# the widest block of the derivative form (any number of directions)
MAX_DERIVATIVE_WIDTH = 16


class _Triple:
    """An intermediate of either approximant on the augmentations
    M_ij = [[A, E_i, 0], [0, A, E_j], [0, 0, A]] of `expm_fixed_derivatives`:
    D [..., w, w] (every diagonal block), F [..., d, w, w] (block (1,2) of
    M_ij is F_i, block (2,3) F_j) and S [..., P, w, w], the symmetric sums
    C_ij + C_ji of the corners for the pairs i <= j (`ii`, `jj`). The plain
    approximants run on it unchanged: sums, scalar products and the
    identity act block by block (the identity on D), and a product follows
    (D, F, S) (D', F', S') = (D D', D F'_k + F_k D',
    D S'_ij + F_i F'_j + F_j F'_i + S_ij D'), summed in that order as
    csrc/expm_fixed.cu sums it."""

    def __init__(self, D, F, S, ii, jj):
        self.D, self.F, self.S, self.ii, self.jj = D, F, S, ii, jj

    @classmethod
    def of(cls, A, E):
        """The augmentations' blocks: (A, E, 0)."""
        w, d = A.shape[-1], E.shape[-3]
        ii, jj = torch.triu_indices(d, d, device=A.device)
        return cls(A, E, A.new_zeros(*A.shape[:-2], len(ii), w, w), ii, jj)

    def outputs(self):
        """(Phi, dPhi, D2): D, F, and S written to both (i, j) and (j, i)."""
        d, w = self.F.shape[-3], self.D.shape[-1]
        D2 = self.D.new_empty(*self.D.shape[:-2], d, d, w, w)
        D2[..., self.ii, self.jj, :, :] = self.S
        D2[..., self.jj, self.ii, :, :] = self.S
        return self.D, self.F, D2

    @property
    def dtype(self):
        return self.D.dtype

    def _new(self, D, F, S):
        return _Triple(D, F, S, self.ii, self.jj)

    def eye(self):
        n = self.D.shape[-1]
        eye = torch.eye(n, dtype=self.D.dtype, device=self.D.device).expand(self.D.shape)
        return self._new(eye, torch.zeros_like(self.F), torch.zeros_like(self.S))

    def __add__(self, o):
        if isinstance(o, int) and o == 0:           # sum() starts from 0
            return self
        return self._new(self.D + o.D, self.F + o.F, self.S + o.S)

    __radd__ = __add__

    def __sub__(self, o):
        return self._new(self.D - o.D, self.F - o.F, self.S - o.S)

    def __mul__(self, c):
        return self._new(self.D * c, self.F * c, self.S * c)

    __rmul__ = __mul__

    def __truediv__(self, c):
        return self._new(self.D / c, self.F / c, self.S / c)

    def __matmul__(self, q):
        Dp, Dq = self.D[..., None, :, :], q.D[..., None, :, :]
        ii, jj = self.ii, self.jj
        F = Dp @ q.F + self.F @ Dq
        S = Dp @ q.S + self.F[..., ii, :, :] @ q.F[..., jj, :, :] \
            + self.F[..., jj, :, :] @ q.F[..., ii, :, :] + self.S @ Dq
        return self._new(self.D @ q.D, F, S)


def _eye_like(A):
    """The identity of A's algebra, broadcast to A's shape."""
    if isinstance(A, _Triple):
        return A.eye()
    n = A.shape[-1]
    return torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)


def _order(A, order):
    if order is None:
        order = 8 if A.dtype == torch.float32 else 12
    if order not in (8, 12):
        raise ValueError(f"unsupported Taylor order {order}")
    return order


def expm_taylor_fixed_plain(A, order: int | None = None, squarings: int = 2):
    """Plain PyTorch version of K4, batched over leading axes (also on the
    structured intermediates of `expm_fixed_derivatives_plain`)."""
    order = _order(A, order)
    c = [1.0 / _FACT[i] for i in range(order + 1)]
    A = A * (2.0 ** (-squarings))
    ident = _eye_like(A)
    A2 = A @ A
    A3 = A2 @ A
    A4 = A2 @ A2

    def cubic(i0):
        return (c[i0] * ident + c[i0 + 1] * A + c[i0 + 2] * A2
                + c[i0 + 3] * A3)

    if order == 8:
        F = cubic(0) + A4 @ (cubic(4) + c[8] * A4)
    else:
        B2 = cubic(8) + c[12] * A4
        F = cubic(0) + A4 @ (cubic(4) + A4 @ B2)
    for _ in range(squarings):
        F = F @ F
    return F


def expm_taylor_fixed(A, order: int | None = None, squarings: int = 2):
    """K4: Taylor expm of every [n, n] matrix of A [..., n, n] (n <= 32).

    Replaces piccolax/ops/expm.py:143 expm_taylor_fixed. Bound on the
    H100: bytes at 4 x 4 and 8 x 8 (the paths' residuals and line-search
    sweeps). The kernel (csrc/expm_fixed.cu) gives a warp its matrices and
    a thread one or two rows of a matrix, kept in registers up to 8 wide;
    only the products' right operands go through shared memory, with a
    warp barrier a product.
    """
    order = _order(A, order)
    if A.device.type == "cpu":
        return expm_taylor_fixed_plain(A, order, squarings)
    if A.device.type != "cuda":
        raise RuntimeError(f"expm_taylor_fixed: unsupported device {A.device}")
    n = A.shape[-1]
    _kernels.require(A, "expm_taylor_fixed")
    if A.dim() < 2 or A.shape[-2] != n or n > _MAX_N:
        raise ValueError(f"expm_taylor_fixed: square blocks up to {_MAX_N} "
                         f"expected, got {tuple(A.shape)}")
    out = torch.empty_like(A)
    batch = A.numel() // (n * n)
    lib = _kernels.load("expm_fixed")
    rc = lib.px_expm_taylor(_kernels.is_f64(A), A.data_ptr(), out.data_ptr(),
                            batch, n, order, squarings,
                            _kernels.stream_handle(A))
    _kernels.count_launch("expm_taylor_fixed", n)
    _kernels.check(rc, "expm_taylor_fixed")
    return out


def _ns_solve(Mden, Mnum, b0, iters):
    """Solve Mden @ F = Mnum by Newton-Schulz: X <- X(2I - Mden X) from
    X0 = I/b0 (Mden = b0 (I + E) with ||E|| < 1)."""
    ident = _eye_like(Mden)
    X = ident / b0
    for _ in range(iters):
        X = X @ (2.0 * ident - Mden @ X)
    return X @ Mnum


# --------------------------------------------------------------------------- #
# K6: fixed-order diagonal Pade with a static squaring count
# --------------------------------------------------------------------------- #

# Pade [m/m] by order: the accuracy radius of ||A|| / 2^s (piccolax's
# choose_squarings) and the numerator coefficients b_0..b_m; the
# denominator has the same ones with alternating signs (piccolax/ops/
# expm.py: _PADE_B). The one table of the orders the port takes.
PADE_ORDERS = {
    3: (0.02, (120.0, 60.0, 12.0, 1.0)),
    5: (0.25, (30240.0, 15120.0, 3360.0, 420.0, 30.0, 1.0)),
    7: (0.95, (17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0,
               56.0, 1.0)),
    9: (2.1, (17643225600.0, 8821612800.0, 2075673600.0, 302702400.0,
              30270240.0, 2162160.0, 110880.0, 3960.0, 90.0, 1.0)),
}
_PADE_NS_ITERS = 6


def pade_radius(order) -> float:
    """The accuracy radius of a Pade order; any other order raises."""
    if order not in PADE_ORDERS:
        raise ValueError(f"unsupported pade_order {order!r} "
                         f"(one of {sorted(PADE_ORDERS)})")
    return PADE_ORDERS[order][0]


def expm_pade_fixed_plain(A, order: int = 7, squarings: int = 2):
    """Plain PyTorch version of K6, batched over leading axes (also on the
    structured intermediates of `expm_fixed_derivatives_plain`)."""
    pade_radius(order)
    b = PADE_ORDERS[order][1]
    A = A * (2.0 ** (-squarings))
    ident = _eye_like(A)
    n_even = (order + 1) // 2
    evens = [ident]
    A2 = A @ A
    for j in range(1, n_even):
        evens.append(A2 if j == 1 else evens[-1] @ A2)
    # summed in the order of piccolax's Python sum(), from 0
    U_inner = sum(b[2 * j + 1] * evens[j] for j in range(n_even))
    V = sum(b[2 * j] * evens[j] for j in range(n_even))
    U = A @ U_inner
    F = _ns_solve(V - U, V + U, b[0], _PADE_NS_ITERS)
    for _ in range(squarings):
        F = F @ F
    return F


def expm_pade_fixed(A, order: int = 7, squarings: int = 2):
    """K6: Pade [order/order] expm of every [n, n] matrix of a real
    A [..., n, n] (n <= 32) with a static squaring count.

    Replaces piccolax/ops/expm.py:105 expm_pade_fixed (with _ns_solve).
    Bound on the H100: bytes at 4 x 4 (the paths' residuals and sweeps;
    3 to 5 products for the powers and U, 12 for the Newton-Schulz inverse,
    1 for the numerator, then the squarings). The kernel is K4's engine
    (csrc/expm_fixed.cu): a row a thread, a warp its matrices, device
    memory sees each input and each result once.
    """
    pade_radius(order)
    if A.device.type == "cpu":
        return expm_pade_fixed_plain(A, order, squarings)
    if A.device.type != "cuda":
        raise RuntimeError(f"expm_pade_fixed: unsupported device {A.device}")
    n = A.shape[-1]
    _kernels.require(A, "expm_pade_fixed")
    if A.dim() < 2 or A.shape[-2] != n or n > _MAX_N:
        raise ValueError(f"expm_pade_fixed: square blocks up to {_MAX_N} "
                         f"expected, got {tuple(A.shape)}")
    out = torch.empty_like(A)
    lib = _kernels.load("expm_fixed")
    rc = lib.px_expm_pade_fixed(_kernels.is_f64(A), A.data_ptr(), out.data_ptr(),
                                A.numel() // (n * n), n, order, squarings,
                                _kernels.stream_handle(A))
    _kernels.count_launch("expm_pade_fixed", n)
    _kernels.check(rc, "expm_pade_fixed")
    return out


def expm_action(A, x, order: int = 7, squarings: int = 2):
    """expm(A) @ x through K6 (piccolax/ops/expm.py:194 expm_action)."""
    return expm_pade_fixed(A, order, squarings) @ x


def expm_fixed(A, order, squarings: int):
    """Static-shape expm dispatcher of the collocation hot path: "taylor"
    (K4) or a Pade order in {3, 5, 7, 9} (K6)."""
    if order == "taylor":
        return expm_taylor_fixed(A, None, squarings)
    return expm_pade_fixed(A, order, squarings)


def expm_fixed_plain(A, order, squarings: int, taylor_order: int | None = None):
    """The plain version of `expm_fixed` (on tensors or on the structured
    intermediates of `expm_fixed_derivatives_plain`); taylor_order, the
    Taylor order when it is not the dtype's (8 in float32, 12 otherwise)."""
    if order == "taylor":
        return expm_taylor_fixed_plain(A, taylor_order, squarings)
    return expm_pade_fixed_plain(A, order, squarings)


def derivative_augmentations(A, E):
    """The block upper-triangular M_ij = [[A, E_i, 0], [0, A, E_j],
    [0, 0, A]] of `expm_fixed_derivatives`, [..., d * d, 3w, 3w] for
    A [..., w, w] and directions E [..., d, w, w]."""
    w = A.shape[-1]
    d = E.shape[-3]
    lead = A.shape[:-2]
    M = A.new_zeros(*lead, d, d, 3 * w, 3 * w)
    for b in range(3):
        M[..., b * w:(b + 1) * w, b * w:(b + 1) * w] = A[..., None, None, :, :]
    M[..., 0:w, w:2 * w] = E[..., :, None, :, :]
    M[..., w:2 * w, 2 * w:] = E[..., None, :, :, :]
    return M.reshape(*lead, d * d, 3 * w, 3 * w).contiguous()


def expm_fixed_derivatives_dense(A, E, order, squarings: int):
    """`expm_fixed_derivatives` by the dense route: the value form
    (`expm_fixed`, a kernel on a CUDA tensor, 3w <= 32) on every
    `derivative_augmentations` M_ij, then its blocks: r(A) on the diagonal,
    Dr(A)[E_i] in block (1,2) of M_ii, the ordered half of
    D^2 r(A)[E_i, E_j] in the corner of M_ij. The oracle of the structured
    form; no path calls it."""
    w = A.shape[-1]
    d = E.shape[-3]
    lead = A.shape[:-2]
    R = expm_fixed(derivative_augmentations(A, E), order,
                   squarings).reshape(*lead, d, d, 3 * w, 3 * w)
    idx = torch.arange(d, device=A.device)
    half = R[..., :w, 2 * w:]
    return (R[..., 0, 0, :w, :w], R[..., idx, idx, :w, w:2 * w],
            half + half.transpose(-3, -4))


def _check_derivative_shapes(A, E):
    """A [..., w, w] and E [..., d, w, w] whose leading axes broadcast to A's."""
    w = A.shape[-1] if A.dim() >= 2 else 0
    ok = A.dim() >= 2 and A.shape[-2] == w and E.dim() >= 3 \
        and tuple(E.shape[-2:]) == (w, w)
    if ok and E.shape[:-3] != A.shape[:-2]:
        try:
            ok = torch.broadcast_shapes(A.shape[:-2], E.shape[:-3]) == A.shape[:-2]
        except RuntimeError:
            ok = False
    if not ok:
        raise ValueError(f"expm_fixed_derivatives: A [..., w, w] and E [..., d, w, w] "
                         f"(leading axes broadcasting to A's) expected, got "
                         f"{tuple(A.shape)} and {tuple(E.shape)}")


def expm_fixed_derivatives_plain(A, E, order, squarings: int,
                                 taylor_order: int | None = None):
    """Plain PyTorch version of the derivative form: the approximant's
    plain version on the structured intermediates (D, F, S), each product
    a batched `@` on [..., w, w], [..., d, w, w] and [..., P, w, w]
    (taylor_order as `expm_fixed_plain` takes it)."""
    _check_derivative_shapes(A, E)
    return expm_fixed_plain(_Triple.of(A, E), order, squarings, taylor_order).outputs()


def expm_fixed_derivatives(A, E, order, squarings: int):
    """r(A) and its exact first and second directional derivatives along
    the directions E [..., d, w, w], for A [..., w, w], in ONE launch.

    Every product and sum of either approximant is a polynomial in A:
    Taylor's r(A) = p(A / 2^s)^(2^s), and Pade's r(A) = (X_6 (V + U))^(2^s)
    whose Newton-Schulz iterate X_{i+1} = X_i (2I - (V - U) X_i) from
    X_0 = I / b_0 is itself a polynomial in A. So for
    M_ij = [[A, E_i, 0], [0, A, E_j], [0, 0, A]] the blocks of r(M_ij) are
    r(A) on the diagonal, Dr(A)[E_i] and Dr(A)[E_j] above it, and the
    ordered half of D^2 r(A)[E_i, E_j] in the corner; the second
    derivative is the sum of both orders. These are the derivatives that
    autodiff of the same approximant gives, to rounding. The kernel
    (csrc/expm_fixed.cu, w <= 16, any d) and the plain version carry the
    blocks without forming M: r(A), each Dr(A)[E_k] once, and the
    symmetric sums for i <= j (`_Triple`).

    E's leading axes broadcast to A's: the kernel reads directions shared
    by a batch (a frozen timestep: E [N-1, d, w, w] beside A [B, N-1, w, w])
    where they are, and any other broadcast from a copy.

    Returns (Phi [..., w, w], dPhi [..., d, w, w], D2 [..., d, d, w, w]).
    """
    _check_derivative_shapes(A, E)
    taylor = order == "taylor"
    o = _order(A, None) if taylor else order
    if not taylor:
        pade_radius(order)
    if A.device.type == "cpu":
        return expm_fixed_derivatives_plain(A, E, order, squarings)
    if A.device.type != "cuda":
        raise RuntimeError(f"expm_fixed_derivatives: unsupported device {A.device}")
    name = "expm_taylor_fixed_derivatives" if taylor else "expm_pade_fixed_derivatives"
    w, d = A.shape[-1], E.shape[-3]
    lead = A.shape[:-2]
    # E's batch, read as knot b % e_batch: its leading axes equal A's
    # trailing ones (after any 1s), else a broadcast copy
    e_lead = list(E.shape[:-3])
    while e_lead and e_lead[0] == 1:
        e_lead.pop(0)
    if e_lead and tuple(e_lead) != tuple(lead[len(lead) - len(e_lead):]):
        E = E.expand(*lead, d, w, w)
        e_lead = list(lead)
    E = E.contiguous()
    _kernels.require(A, name)
    _kernels.require(E, name, like=A)
    if w > MAX_DERIVATIVE_WIDTH or d < 1:
        raise ValueError(f"{name}: blocks up to {MAX_DERIVATIVE_WIDTH} wide and at "
                         f"least one direction expected, got {tuple(E.shape)}")
    Phi = torch.empty_like(A)
    dPhi = A.new_empty(*lead, d, w, w)
    D2 = A.new_empty(*lead, d, d, w, w)
    lib = _kernels.load("expm_fixed")
    rc = lib.px_expm_fixed_derivatives(_kernels.is_f64(A), int(taylor), o, squarings,
                                       A.data_ptr(), E.data_ptr(), Phi.data_ptr(),
                                       dPhi.data_ptr(), D2.data_ptr(),
                                       A.numel() // (w * w), E.numel() // (d * w * w), w,
                                       d, _kernels.stream_handle(A))
    _kernels.count_launch(name, w)
    _kernels.check(rc, name)
    return Phi, dPhi, D2


# --------------------------------------------------------------------------- #
# K5: scaling-and-squaring Pade-13
# --------------------------------------------------------------------------- #

# Pade-13 coefficients (Higham 2005)
_B13 = (
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0, 129060195264000.0, 10559470521600.0, 670442572800.0,
    33522128640.0, 1323241920.0, 40840800.0, 960960.0, 16380.0, 182.0, 1.0,
)

# Scaling threshold: the Newton-Schulz inverse of the Pade denominator
# needs ||A|| <= ~0.95 after scaling (piccolax/ops/expm.py: _THETA13).
_THETA13 = 0.95
_INV_THETA13 = 1.0 / _THETA13
_INV_LN2 = 1.0 / math.log(2.0)
_NS_ITERS = 8
_MAX_N_PADE = 16


def _pade13(A):
    b = _B13
    n = A.shape[-1]
    ident = torch.eye(n, dtype=A.dtype, device=A.device)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A4 @ A2
    U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
             + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident)
    V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
         + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident)
    return _ns_solve(V - U, V + U, b[0], _NS_ITERS)


def pade13_squarings(A, max_squarings: int = 16):
    """Per-matrix squaring count of `expm`: clamp(ceil(log2(||A||_inf /
    0.95)), 0, max_squarings), the norm the largest row sum of moduli,
    all in the real type of A [..., n, n]."""
    norm = torch.amax(torch.sum(torch.abs(A), dim=-1), dim=-1)
    # Rounded as the compiled piccolax expression rounds it: the division
    # by 0.95 is a product with its reciprocal and log2 is log times
    # 1 / ln 2. torch.log2 takes another count at some norms one ulp from
    # 0.95 * 2^k; the kernel computes the same expression.
    x = torch.clamp(norm * _INV_THETA13, min=1e-30)
    s = torch.clamp(torch.ceil(torch.log(x) * _INV_LN2), min=0.0)
    return torch.clamp(s, max=float(max_squarings)).to(torch.int32)


def anti_hermitian_by_squarings(M: int, n: int, rng, dtype=np.complex128):
    """M matrices -iH [M, n, n] (numpy, `dtype`) whose inf-norms give
    `expm` every squaring count 0..16 and the edges between them.

    The first M - 85 are dense, in 18 equal blocks: norm 0.4 (s = 0),
    0.95 * 2^(s - 1/2) for s = 1..16 (mid-bucket), and 1.5x past the cap.
    The last 85 are diagonal with an exact norm of 0.95 * 2^k (k = 0..16,
    in the real type of `dtype`) and up to two ulps either side of it,
    where a count computed in another precision or with another log2
    would differ.
    """
    rt = np.float64 if np.dtype(dtype) == np.complex128 else np.float32
    ne = 17 * 5
    md = M - ne
    if md < 18:
        raise ValueError(f"anti_hermitian_by_squarings: M >= {ne + 18} expected")
    H = rng.standard_normal((md, n, n)) + 1j * rng.standard_normal((md, n, n))
    dense = -1j * (H + np.conj(np.swapaxes(H, -1, -2)))
    block = np.arange(md) * 18 // md
    target = np.where(block == 17, 1.5 * 0.95 * 2.0 ** 16, 0.95 * 2.0 ** (block - 0.5))
    target[block == 0] = 0.4
    dense *= (target / np.abs(dense).sum(-1).max(-1))[:, None, None]
    edge = []
    for k in range(17):
        x = rt(0.95) * rt(2.0 ** k)
        for _ in range(2):
            x = np.nextafter(x, rt(0))
        for _ in range(5):
            edge.append(x)
            x = np.nextafter(x, rt(np.inf))
    # moduli of purely imaginary entries and sums with zeros are exact, so
    # every implementation sees the same norm; the first entry is the largest
    diag = np.asarray(edge, rt)[:, None] * np.concatenate(
        [np.ones((ne, 1)), rng.uniform(-1, 1, (ne, n - 1))], 1).astype(rt)
    A = np.zeros((M, n, n), dtype)
    A[:md] = dense
    A[md:, np.arange(n), np.arange(n)] = -1j * diag
    return A


def expm_plain(A, max_squarings: int = 16):
    """Plain PyTorch version of K5, batched over leading axes."""
    s = pade13_squarings(A, max_squarings)
    scale = torch.pow(2.0, -s.to(torch.float64)).to(A.dtype)
    F = _pade13(A * scale[..., None, None])
    for i in range(int(s.max()) if s.numel() else 0):
        F = torch.where((i < s)[..., None, None], F @ F, F)
    return F


def expm(A, max_squarings: int = 16, device=None, *,
         return_squarings: bool = False):
    """K5: Pade-13 expm of every [n, n] matrix of a complex64/complex128
    A [..., n, n] (n <= 16), with its own squaring count per matrix
    (returned beside the result, int32 [...], with return_squarings).

    Replaces piccolax/ops/expm.py:74 expm (with _pade13 and _ns_solve). A
    tensor runs where it lies; anything else is moved to `device` (the
    card unless the caller passes "cpu"). Bound on the H100: float64
    arithmetic outside the tensor cores (23 + s complex n x n products per
    matrix, 16 of them the Newton-Schulz inverse, against 2 n^2 values in
    and out). The kernel keeps the
    matrix in registers, one thread per matrix, at n = 2 (every rollout of
    a qubit) and in shared memory, one warp per matrix, up to n = 16.
    """
    if not isinstance(A, torch.Tensor):
        A = torch.as_tensor(A).to(resolve_device(device))
    if A.dim() < 2 or A.shape[-1] != A.shape[-2] or A.shape[-1] > _MAX_N_PADE:
        raise ValueError(f"expm: square blocks up to {_MAX_N_PADE} expected, "
                         f"got {tuple(A.shape)}")
    if A.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"expm: complex64 or complex128 expected, got {A.dtype}")
    if not 0 <= max_squarings <= 62:
        raise ValueError(f"expm: max_squarings {max_squarings} out of range")
    if A.device.type == "cpu":
        F = expm_plain(A, max_squarings)
        return (F, pade13_squarings(A, max_squarings)) if return_squarings else F
    if A.device.type != "cuda":
        raise RuntimeError(f"expm: unsupported device {A.device}")
    if not A.is_contiguous():
        raise ValueError("expm: contiguous tensor expected")
    n = A.shape[-1]
    out = torch.empty_like(A)
    s = torch.empty(A.shape[:-2], dtype=torch.int32, device=A.device) \
        if return_squarings else None
    lib = _kernels.load("expm_pade13")
    # interleaved (re, im) pairs of the real type
    rc = lib.px_expm_pade13(int(A.dtype == torch.complex128),
                            torch.view_as_real(A).data_ptr(),
                            torch.view_as_real(out).data_ptr(),
                            s.data_ptr() if s is not None else None,
                            A.numel() // (n * n), n, max_squarings,
                            _kernels.stream_handle(A))
    _kernels.LAUNCHES["expm_pade13"] += 1
    _kernels.check(rc, "expm")
    return (out, s) if return_squarings else out
