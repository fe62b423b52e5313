"""BASELINE configuration 1 of `piccolax.benchmarks`: the single-qubit SX
gate, 2 drives, N = 50 knots over T = 10."""

from __future__ import annotations

import numpy as np

from .control.templates import SmoothPulseProblem
from .quantum.gates import GATES, PAULIS
from .quantum.pulses import ZeroOrderPulse
from .quantum.systems import QuantumSystem
from .quantum.trajectories import UnitaryTrajectory

__all__ = ["sx_gate_problem"]


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
