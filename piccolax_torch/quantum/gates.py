"""Constant gate & Pauli library.

TPU-native counterpart of the reference gate library
(reference: src/quantum/primitives/gates.jl:11,45). Gates are plain
numpy complex arrays (static constants — they participate in trace-time
constant folding, never as traced values).
"""

from __future__ import annotations

import numpy as np

__all__ = ["PAULIS", "GATES", "gate"]


def _c(rows) -> np.ndarray:
    return np.array(rows, dtype=np.complex128)


PAULIS: dict[str, np.ndarray] = {
    "I": _c([[1, 0], [0, 1]]),
    "X": _c([[0, 1], [1, 0]]),
    "Y": _c([[0, -1j], [1j, 0]]),
    "Z": _c([[1, 0], [0, -1]]),
}

_s2 = 1 / np.sqrt(2)

GATES: dict[str, np.ndarray] = {
    "I": PAULIS["I"],
    "X": PAULIS["X"],
    "Y": PAULIS["Y"],
    "Z": PAULIS["Z"],
    "H": _c([[_s2, _s2], [_s2, -_s2]]),
    "S": _c([[1, 0], [0, 1j]]),
    "T": _c([[1, 0], [0, np.exp(1j * np.pi / 4)]]),
    # sqrt(X) (SX) gate
    "SX": 0.5 * _c([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]]),
    "CX": _c([
        [1, 0, 0, 0],
        [0, 1, 0, 0],
        [0, 0, 0, 1],
        [0, 0, 1, 0],
    ]),
    "CZ": np.diag([1, 1, 1, -1]).astype(np.complex128),
    "XI": np.kron(_c([[0, 1], [1, 0]]), np.eye(2)).astype(np.complex128),
    "CCX": np.block([
        [np.eye(6), np.zeros((6, 2))],
        [np.zeros((2, 6)), _c([[0, 1], [1, 0]])],
    ]).astype(np.complex128),
    "CCZ": np.diag([1, 1, 1, 1, 1, 1, 1, -1]).astype(np.complex128),
    "sqrtiSWAP": _c([
        [1, 0, 0, 0],
        [0, _s2, 1j * _s2, 0],
        [0, 1j * _s2, _s2, 0],
        [0, 0, 0, 1],
    ]),
    "iSWAP": _c([
        [1, 0, 0, 0],
        [0, 0, 1j, 0],
        [0, 1j, 0, 0],
        [0, 0, 0, 1],
    ]),
    "SWAP": _c([
        [1, 0, 0, 0],
        [0, 0, 1, 0],
        [0, 1, 0, 0],
        [0, 0, 0, 1],
    ]),
}


def gate(name: str) -> np.ndarray:
    """Look up a gate by name; returns a fresh copy."""
    return GATES[name].copy()
