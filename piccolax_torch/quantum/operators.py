"""Operator builders (numpy only): ladder operators and lifting into a
tensor-product space.

A copy of the functions of `piccolax.quantum.operators` that the port's
configurations use, with the same outputs; copied, not imported, because
importing any `piccolax` module imports jax. All indices are 0-based.
"""

from __future__ import annotations

import numpy as np

__all__ = ["annihilate", "create", "number_op", "quad_op", "lift_operator"]


def lift_operator(op: np.ndarray, index: int, subsystem_levels) -> np.ndarray:
    """Lift `op` acting on subsystem `index` to the full tensor-product space."""
    mats = [np.eye(l, dtype=np.complex128) for l in subsystem_levels]
    mats[index] = np.asarray(op, dtype=np.complex128)
    out = mats[0]
    for m in mats[1:]:
        out = np.kron(out, m)
    return out


def annihilate(levels: int) -> np.ndarray:
    """Bosonic annihilation operator truncated to `levels`."""
    return np.diag(np.sqrt(np.arange(1, levels, dtype=np.float64)), 1).astype(np.complex128)


def create(levels: int) -> np.ndarray:
    """Bosonic creation operator truncated to `levels`."""
    return annihilate(levels).conj().T


def number_op(levels: int) -> np.ndarray:
    """Number operator a† a."""
    return np.diag(np.arange(levels, dtype=np.float64)).astype(np.complex128)


def quad_op(levels: int) -> np.ndarray:
    """Quartic anharmonicity operator a† a† a a = n(n-1)."""
    n = np.arange(levels, dtype=np.float64)
    return np.diag(n * (n - 1)).astype(np.complex128)
