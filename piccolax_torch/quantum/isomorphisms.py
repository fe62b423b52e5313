"""Complex <-> real isomorphisms, the conventions of
`piccolax.quantum.isomorphisms`:

- operator iso-vec: column-major, per column ``[Re(col); Im(col)]`` (2n^2,)
- density iso-vec: ``[Re(vec(rho)); Im(vec(rho))]`` (column-major vec, 2n^2,)
- compact density iso: Re of the upper triangle (column-major, j <= k),
  then Im of the strict upper triangle (column-major, j < k) (n^2,)
- iso(H) = [[Re H, -Im H], [Im H, Re H]];  G(H) = iso(-iH)

The maps are host-side numpy, batched over leading axes; `iso` and
`ad_vec` also take complex tensors (the rollout's superoperators).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["operator_to_iso_vec", "iso", "G", "operator_subspace_iso_indices",
           "density_to_iso_vec", "iso_vec_to_density", "density_to_compact_iso",
           "compact_iso_to_density", "density_lift_matrix",
           "density_projection_matrix", "ad_vec", "dissipator", "iso_D",
           "apply_row_phase_iso"]


def operator_to_iso_vec(U):
    """U (…, n, n) complex -> (…, 2n^2) real, column-major [Re(col); Im(col)]."""
    U = np.asarray(U)
    cols = np.swapaxes(U, -1, -2)
    blocks = np.concatenate([cols.real, cols.imag], axis=-1)
    return blocks.reshape(*U.shape[:-2], -1)


def iso(Hm):
    """iso(H) = [[Re H, -Im H], [Im H, Re H]]  (…, n, n) -> (…, 2n, 2n), of
    an array or a complex tensor."""
    if isinstance(Hm, torch.Tensor):
        re, im = Hm.real, Hm.imag
        return torch.cat([torch.cat([re, -im], dim=-1), torch.cat([im, re], dim=-1)],
                         dim=-2)
    Hm = np.asarray(Hm)
    re, im = Hm.real, Hm.imag
    top = np.concatenate([re, -im], axis=-1)
    bot = np.concatenate([im, re], axis=-1)
    return np.concatenate([top, bot], axis=-2)


def G(Hm):
    """Iso generator of -iH: G(H) = iso(-iH) (real 2n x 2n)."""
    return iso(-1j * np.asarray(Hm))


@lru_cache(maxsize=None)
def _operator_subspace_iso_indices(n: int, subspace: tuple) -> np.ndarray:
    s = np.asarray(subspace)
    m = len(s)
    idx = np.empty(2 * m * m, dtype=np.int64)
    for jj, col in enumerate(s):
        for ii, row in enumerate(s):
            idx[2 * m * jj + ii] = 2 * n * col + row            # Re
            idx[2 * m * jj + m + ii] = 2 * n * col + n + row    # Im
    return idx


def operator_subspace_iso_indices(n: int, subspace) -> np.ndarray:
    """iso-vec indices such that x[idx] is the iso-vec of U[s, s]
    (an operator iso-vec of dimension len(s))."""
    return _operator_subspace_iso_indices(n, tuple(int(i) for i in subspace))


# --------------------------------------------------------------------------- #
# Density matrices
# --------------------------------------------------------------------------- #


def density_to_iso_vec(rho):
    """rho (…, n, n) -> (…, 2n^2): [Re(vec(rho)); Im(vec(rho))]
    (column-major vec)."""
    rho = np.asarray(rho)
    v = np.swapaxes(rho, -1, -2).reshape(*rho.shape[:-2], -1)
    return np.concatenate([v.real, v.imag], axis=-1)


def iso_vec_to_density(rho_iso):
    """(…, 2n^2) -> (…, n, n) complex: the inverse of `density_to_iso_vec`."""
    n2 = rho_iso.shape[-1] // 2
    n = int(round(np.sqrt(n2)))
    v = rho_iso[..., :n2] + 1j * rho_iso[..., n2:]
    return np.swapaxes(v.reshape(*v.shape[:-1], n, n), -1, -2)


@lru_cache(maxsize=None)
def _compact_indices(n: int):
    """Static index maps of the compact Hermitian iso (column-major):
    (re_j, re_k) of the upper triangle, (im_j, im_k) of the strict one."""
    re_j, re_k = [], []
    for k in range(n):
        for j in range(k + 1):
            re_j.append(j)
            re_k.append(k)
    im_j, im_k = [], []
    for k in range(1, n):
        for j in range(k):
            im_j.append(j)
            im_k.append(k)
    return np.array(re_j), np.array(re_k), np.array(im_j), np.array(im_k)


def density_to_compact_iso(rho):
    """Hermitian rho (…, n, n) -> (…, n^2) compact real vector."""
    n = rho.shape[-1]
    re_j, re_k, im_j, im_k = _compact_indices(n)
    rho = np.asarray(rho)
    return np.concatenate([np.real(rho[..., re_j, re_k]),
                           np.imag(rho[..., im_j, im_k])], axis=-1)


def compact_iso_to_density(x):
    """(…, n^2) compact real vector -> Hermitian (…, n, n) complex
    (complex128 for float64 x, else complex64)."""
    x = np.asarray(x)
    n = int(round(np.sqrt(x.shape[-1])))
    re_j, re_k, im_j, im_k = _compact_indices(n)
    off = re_j != re_k
    n_re = len(re_j)
    rho = np.zeros((*x.shape[:-1], n, n),
                   np.complex128 if x.dtype == np.float64 else np.complex64)
    re, im = x[..., :n_re], x[..., n_re:]
    rho[..., re_j, re_k] += re
    rho[..., re_k[off], re_j[off]] += re[..., off]
    rho[..., im_j, im_k] += 1j * im
    rho[..., im_k, im_j] += -1j * im
    return rho


@lru_cache(maxsize=None)
def _density_lift_np(n: int) -> np.ndarray:
    """Lift L (2n^2, n^2): compact iso -> full density iso-vec."""
    n2 = n * n
    L = np.zeros((2 * n2, n2))
    re_j, re_k, im_j, im_k = _compact_indices(n)
    col = 0
    for j, k in zip(re_j, re_k):
        L[k * n + j, col] = 1.0          # Re(rho[j,k]) at vec pos k*n+j
        if j != k:
            L[j * n + k, col] = 1.0      # Re(rho[k,j]) symmetric
        col += 1
    for j, k in zip(im_j, im_k):
        L[n2 + k * n + j, col] = 1.0     # Im(rho[j,k])
        L[n2 + j * n + k, col] = -1.0    # Im(rho[k,j]) = -Im(rho[j,k])
        col += 1
    return L


@lru_cache(maxsize=None)
def _density_projection_np(n: int) -> np.ndarray:
    """Projection P (n^2, 2n^2): full density iso-vec -> compact iso;
    P @ L = I."""
    n2 = n * n
    P = np.zeros((n2, 2 * n2))
    re_j, re_k, im_j, im_k = _compact_indices(n)
    row = 0
    for j, k in zip(re_j, re_k):
        if j == k:
            P[row, k * n + j] = 1.0
        else:
            P[row, k * n + j] = 0.5
            P[row, j * n + k] = 0.5
        row += 1
    for j, k in zip(im_j, im_k):
        P[row, n2 + k * n + j] = 0.5
        P[row, n2 + j * n + k] = -0.5
        row += 1
    return P


def density_lift_matrix(n: int) -> np.ndarray:
    return _density_lift_np(n).copy()


def density_projection_matrix(n: int) -> np.ndarray:
    return _density_projection_np(n).copy()


# --------------------------------------------------------------------------- #
# Superoperators
# --------------------------------------------------------------------------- #


def _kron(A, B):
    """Kronecker product of the last two axes, batched over the leading
    ones (arrays or tensors)."""
    (a, b), (c, d) = A.shape[-2:], B.shape[-2:]
    P = A[..., :, None, :, None] * B[..., None, :, None, :]
    return P.reshape(*P.shape[:-4], a * c, b * d)


def ad_vec(Hm, anti: bool = False):
    """Vectorized adjoint action: I (x) H -+ H^T (x) I (the commutator for
    anti=False, the anticommutator for anti=True), of an array or of a
    tensor batched over leading axes."""
    n = Hm.shape[-1]
    if isinstance(Hm, torch.Tensor):
        Id = torch.eye(n, dtype=Hm.dtype, device=Hm.device)
        HT = Hm.mT
    else:
        Hm = np.asarray(Hm)
        Id = np.eye(n, dtype=Hm.dtype)
        HT = np.swapaxes(Hm, -1, -2)
    sign = 1.0 if anti else -1.0
    return _kron(Id, Hm) + sign * _kron(HT, Id)


def dissipator(L):
    """The complex Lindblad dissipator superoperator of jump operators L
    [..., n, n]: conj(L) (x) L - (I (x) L'L + (L'L)^T (x) I) / 2 (numpy)."""
    L = np.asarray(L)
    LdL = np.swapaxes(L.conj(), -1, -2) @ L
    return _kron(L.conj(), L) - 0.5 * ad_vec(LdL, anti=True)


def iso_D(L):
    """Real iso of the Lindblad dissipator superoperator of jump operator L."""
    return iso(dissipator(L))


def apply_row_phase_iso(x, cos_t, sin_t):
    """Multiply row r of the underlying complex operator (or ket) by
    e^{i theta_r}, in iso coordinates: an operator iso-vec x [..., 2n^2]
    with cos_t, sin_t [..., n] gives operator_to_iso_vec(diag(e^{i theta})
    U); a ket iso [..., 2n] gives ket_to_iso(e^{i theta} psi)."""
    d = x.shape[-1]
    n = cos_t.shape[-1]
    b = x.reshape(*x.shape[:-1], d // (2 * n), 2, n)    # [col, (Re, Im), row]
    c, s = cos_t[..., None, :], sin_t[..., None, :]
    re = b[..., 0, :] * c - b[..., 1, :] * s
    im = b[..., 0, :] * s + b[..., 1, :] * c
    return torch.stack([re, im], dim=-2).reshape(*torch.broadcast_shapes(
        x.shape[:-1], cos_t.shape[:-1]), d)
