"""Complex <-> real isomorphisms (host-side numpy), the conventions of
`piccolax.quantum.isomorphisms`:

- operator iso-vec: column-major, per column ``[Re(col); Im(col)]`` (2n^2,)
- iso(H) = [[Re H, -Im H], [Im H, Re H]];  G(H) = iso(-iH)
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["operator_to_iso_vec", "iso", "G", "operator_subspace_iso_indices"]


def operator_to_iso_vec(U):
    """U (…, n, n) complex -> (…, 2n^2) real, column-major [Re(col); Im(col)]."""
    U = np.asarray(U)
    cols = np.swapaxes(U, -1, -2)
    blocks = np.concatenate([cols.real, cols.imag], axis=-1)
    return blocks.reshape(*U.shape[:-2], -1)


def iso(Hm):
    """iso(H) = [[Re H, -Im H], [Im H, Re H]]  (…, n, n) -> (…, 2n, 2n)."""
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
