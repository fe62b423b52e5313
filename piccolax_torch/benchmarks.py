"""BASELINE configurations 1 and 3 of `piccolax.benchmarks`: the
single-qubit SX gate (2 drives, N = 50 knots over T = 10) and the
two-qubit CNOT on coupled transmons (4 drives, N = 200 over T = 50)."""

from __future__ import annotations

import numpy as np

from .control.templates import SmoothPulseProblem
from .quantum.gates import GATES, PAULIS
from .quantum.operators import annihilate, lift_operator
from .quantum.pulses import ZeroOrderPulse
from .quantum.systems import QuantumSystem
from .quantum.trajectories import UnitaryTrajectory

__all__ = ["sx_gate_problem", "cnot_problem"]


def _seed_pulse(N, T, n_drives, seed=0, scale=0.01):
    times = np.linspace(0, T, N)
    us = scale * np.random.default_rng(seed).standard_normal((N, n_drives))
    return ZeroOrderPulse(us, times), times


def sx_gate_problem(N: int = 50, T: float = 10.0, seed: int = 0, device=None,
                    **kw):
    """Config 1: SX gate on a driven qubit. The seed pulse is rolled out on
    `device` (the card unless the caller passes "cpu")."""
    sys = QuantumSystem(np.zeros((2, 2)),
                        [PAULIS["X"] / 2, PAULIS["Y"] / 2], 1.0)
    pulse, _ = _seed_pulse(N, T, 2, seed)
    qtraj = UnitaryTrajectory(sys, pulse, GATES["SX"], device=device)
    kw.setdefault("Q", 100.0)
    kw.setdefault("R", 1e-2)
    kw.setdefault("du_bound", 0.5)
    return SmoothPulseProblem(qtraj, N, **kw)


def cnot_problem(N: int = 200, T: float = 50.0, g: float = 0.1,
                 drive_bound: float = 0.1, seed: int = 0, device=None, **kw):
    """Config 3: CNOT on two coupled 2-level transmons, exchange coupling
    g, four drives (x and y on each qubit) bounded by drive_bound, no
    state box (CX has unitary entries at +-1). The seed pulse is rolled out
    on `device` (the card unless the caller passes "cpu")."""
    a = annihilate(2)
    a1 = lift_operator(a, 0, [2, 2])
    a2 = lift_operator(a, 1, [2, 2])
    H_drift = 2 * np.pi * g * (a1 @ a2.conj().T + a1.conj().T @ a2)
    H_drives = [2 * np.pi * H for H in (a1 + a1.conj().T, 1j * (a1 - a1.conj().T),
                                         a2 + a2.conj().T, 1j * (a2 - a2.conj().T))]
    sys = QuantumSystem(H_drift, H_drives, drive_bound)
    pulse, _ = _seed_pulse(N, T, 4, seed)
    qtraj = UnitaryTrajectory(sys, pulse, GATES["CX"], device=device)
    kw.setdefault("Q", 100.0)
    kw.setdefault("R", 1e-2)
    kw.setdefault("state_bound", None)
    return SmoothPulseProblem(qtraj, N, **kw)
