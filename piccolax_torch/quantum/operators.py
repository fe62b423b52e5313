"""Operator builders (numpy only): ladder operators, lifting into a
tensor-product space, and operators embedded in a subspace with the
index maps of their subspace and leakage entries.

A copy of the functions of `piccolax.quantum.operators` that the port's
configurations use, with the same outputs; copied, not imported, because
importing any `piccolax` module imports jax. All indices are 0-based.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

__all__ = ["embed", "unembed", "EmbeddedOperator", "basis_labels",
           "get_subspace_indices", "get_leakage_indices",
           "get_iso_vec_subspace_indices", "get_iso_vec_leakage_indices",
           "annihilate", "create", "number_op", "quad_op", "lift_operator"]


def embed(operator: np.ndarray, subspace, levels: int) -> np.ndarray:
    """Embed `operator` into a `levels`-dim space at the given subspace indices."""
    subspace = np.asarray(subspace)
    out = np.zeros((levels, levels), dtype=np.complex128)
    out[np.ix_(subspace, subspace)] = operator
    return out


def unembed(matrix: np.ndarray, subspace) -> np.ndarray:
    """Extract the subspace block of `matrix`."""
    subspace = np.asarray(subspace)
    return np.asarray(matrix)[np.ix_(subspace, subspace)]


def basis_labels(subsystem_levels) -> list[tuple[int, ...]]:
    """All composite basis labels (tuples of per-subsystem level indices)."""
    return list(itertools.product(*[range(l) for l in subsystem_levels]))


def get_subspace_indices(subspaces, subsystem_levels=None):
    """Indices of the composite subspace spanned by per-subsystem subspaces.

    - get_subspace_indices(subspace, levels:int): identity check, returns subspace
    - get_subspace_indices(list_of_subspaces, subsystem_levels): composite indices
    """
    if isinstance(subsystem_levels, int):
        levels = subsystem_levels
        subspace = list(subspaces)
        assert all(0 <= s < levels for s in subspace)
        return subspace
    subspaces = [list(s) for s in subspaces]
    assert len(subspaces) == len(subsystem_levels)
    labels = basis_labels(subsystem_levels)
    return [
        i for i, lbl in enumerate(labels)
        if all(l in subspaces[j] for j, l in enumerate(lbl))
    ]


def get_leakage_indices(subspace, levels: int):
    """Complement of the subspace."""
    sub = set(subspace)
    return [i for i in range(levels) if i not in sub]


def get_iso_vec_subspace_indices(subspace, levels: int):
    """Subspace indices in the 2*levels^2 operator iso-vec layout.

    Layout per column j: [Re(col j); Im(col j)] (see isomorphisms.py).
    """
    idx = []
    for sj in subspace:
        for si in subspace:
            idx.append(2 * levels * sj + si)
        for si in subspace:
            idx.append(2 * levels * sj + si + levels)
    return idx


def get_iso_vec_leakage_indices(subspace, levels: int):
    """Iso-vec indices of leakage entries in subspace *columns* (population
    that leaks out of the subspace under evolution of subspace initial
    states)."""
    leakage = get_leakage_indices(subspace, levels)
    idx = []
    for sj in subspace:
        for li in leakage:
            idx.append(2 * levels * sj + li)
        for li in leakage:
            idx.append(2 * levels * sj + li + levels)
    return idx


@dataclass(frozen=True)
class EmbeddedOperator:
    """An operator embedded in a subspace of a larger system: `operator`
    is the full-space embedded matrix, `subspace` the embedding indices,
    `subsystem_levels` the per-subsystem dimensions."""

    operator: np.ndarray
    subspace: tuple[int, ...]
    subsystem_levels: tuple[int, ...]

    def __init__(self, subspace_operator, subspace=None, subsystem_levels=None,
                 *, levels: int | None = None):
        subspace_operator = np.asarray(subspace_operator, dtype=np.complex128)
        if levels is not None and subsystem_levels is None:
            subsystem_levels = [levels]
        if subsystem_levels is None:
            raise ValueError("subsystem_levels or levels required")
        if isinstance(subsystem_levels, int):
            subsystem_levels = [subsystem_levels]
        total = int(np.prod(subsystem_levels))
        if subspace is None:
            if len(subsystem_levels) > 1:
                # composite default: a qubit-level gate on every
                # subsystem, each contributing a (0, 1) qubit subspace
                n = len(subsystem_levels)
                assert subspace_operator.shape[0] == 2 ** n, (
                    f"cannot infer subspace: operator dim "
                    f"{subspace_operator.shape[0]} != 2^{n}; pass "
                    f"subspace= explicitly")
                subspace = get_subspace_indices([[0, 1]] * n,
                                                subsystem_levels)
            else:
                subspace = range(subspace_operator.shape[0])
        subspace = tuple(int(s) for s in subspace)
        object.__setattr__(self, "operator",
                           embed(subspace_operator, subspace, total))
        object.__setattr__(self, "subspace", subspace)
        object.__setattr__(self, "subsystem_levels",
                           tuple(int(l) for l in subsystem_levels))

    @property
    def levels(self) -> int:
        return self.operator.shape[0]

    def unembed(self) -> np.ndarray:
        return unembed(self.operator, self.subspace)

    def leakage_indices(self):
        return get_leakage_indices(self.subspace, self.levels)

    def iso_vec_subspace_indices(self):
        return get_iso_vec_subspace_indices(self.subspace, self.levels)

    def iso_vec_leakage_indices(self):
        return get_iso_vec_leakage_indices(self.subspace, self.levels)

    def __matmul__(self, other: "EmbeddedOperator") -> "EmbeddedOperator":
        assert self.subspace == other.subspace
        assert self.subsystem_levels == other.subsystem_levels
        return EmbeddedOperator(
            unembed(self.operator @ other.operator, self.subspace),
            self.subspace, self.subsystem_levels)


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
