"""Matrix exponential of the collocation hot path (kernel K4).

`expm_taylor_fixed` is the Paterson-Stockmeyer Taylor approximant with a
static squaring count of `piccolax.ops.expm`: order 8 in float32 and 12
otherwise. On a CUDA tensor it launches the hand-written kernel
`csrc/expm_taylor.cu`; on a CPU tensor it runs `expm_taylor_fixed_plain`,
the same arithmetic in PyTorch.
"""

from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["TAYLOR_THETA", "expm_taylor_fixed", "expm_taylor_fixed_plain",
           "expm_fixed", "expm_fixed_derivatives"]

_FACT = [1.0]
for _i in range(1, 14):
    _FACT.append(_FACT[-1] * _i)

# ||A|| / 2^s <= theta keeps the truncation below the working precision
TAYLOR_THETA = 0.33

_MAX_N = 32


def _order(A, order):
    if order is None:
        order = 8 if A.dtype == torch.float32 else 12
    if order not in (8, 12):
        raise ValueError(f"unsupported Taylor order {order}")
    return order


def expm_taylor_fixed_plain(A, order: int | None = None, squarings: int = 2):
    """Plain PyTorch version of K4, batched over leading axes."""
    order = _order(A, order)
    c = [1.0 / _FACT[i] for i in range(order + 1)]
    A = A * (2.0 ** (-squarings))
    n = A.shape[-1]
    ident = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
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

    Replaces piccolax/ops/expm.py: expm_taylor_fixed. Bound on the H100:
    bytes at 4 x 4, float32 arithmetic at 12 x 12; the kernel keeps all
    powers of a matrix in shared memory, one thread per entry, several
    matrices per thread block.
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
    lib = _kernels.load("expm_taylor")
    rc = lib.px_expm_taylor(_kernels.is_f64(A), A.data_ptr(), out.data_ptr(),
                            batch, n, order, squarings,
                            _kernels.stream_handle(A))
    _kernels.LAUNCHES["expm_taylor_fixed"] += 1
    _kernels.check(rc, "expm_taylor_fixed")
    return out


def expm_fixed(A, order, squarings: int):
    """Static-shape expm dispatcher of the collocation hot path."""
    if order == "taylor":
        return expm_taylor_fixed(A, None, squarings)
    raise NotImplementedError(f"Pade order {order!r} (only 'taylor' is ported)")


def expm_fixed_derivatives(A, E, order, squarings: int):
    """r(A) and its exact first and second directional derivatives along
    the directions E [..., d, w, w], for A [..., w, w], in ONE expm call.

    r(A) = p(A / 2^s)^(2^s) is a polynomial in A, so for
    M_ij = [[A, E_i, 0], [0, A, E_j], [0, 0, A]] the blocks of r(M_ij) are
    r(A) on the diagonal, Dr(A)[E_i] and Dr(A)[E_j] above it, and the
    ordered half of D^2 r(A)[E_i, E_j] in the corner; the second
    derivative is the sum of both orders. These are the derivatives that
    autodiff of the same approximant gives, to rounding.

    Returns (Phi [..., w, w], dPhi [..., d, w, w], D2 [..., d, d, w, w]).
    """
    w = A.shape[-1]
    d = E.shape[-3]
    lead = A.shape[:-2]
    M = A.new_zeros(*lead, d, d, 3 * w, 3 * w)
    for b in range(3):
        M[..., b * w:(b + 1) * w, b * w:(b + 1) * w] = A[..., None, None, :, :]
    M[..., 0:w, w:2 * w] = E[..., :, None, :, :]
    M[..., w:2 * w, 2 * w:] = E[..., None, :, :, :]
    R = expm_fixed(M.reshape(*lead, d * d, 3 * w, 3 * w).contiguous(),
                   order, squarings).reshape(M.shape)
    idx = torch.arange(d, device=A.device)
    Phi = R[..., 0, 0, :w, :w]
    dPhi = R[..., idx, idx, :w, w:2 * w]
    half = R[..., :w, 2 * w:]
    return Phi, dPhi, half + half.transpose(-3, -4)
