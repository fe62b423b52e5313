"""The five BASELINE configurations of `piccolax.benchmarks`: the
single-qubit SX gate (2 drives, N = 50 knots over T = 10), the X gate on
the 0-1 subspace of a 3-level transmon with leakage suppression (N = 100
over T = 20), the two-qubit CNOT on coupled transmons (4 drives, N = 200
over T = 50), the robustness ensemble: SX problems that differ in a
detuning of their drift, solved as one batch, and the Lindblad density
transfer |0><0| -> |1><1| on a 3-level transmon with decay (N = 50 over
T = 10)."""

from __future__ import annotations

import numpy as np
import torch

from .control.templates import SmoothPulseProblem
from .quantum import isomorphisms as iso
from .quantum.gates import GATES, PAULIS
from .quantum.operators import (EmbeddedOperator, annihilate,
                                get_iso_vec_leakage_indices, lift_operator)
from .quantum.pulses import ZeroOrderPulse
from .quantum.systems import (LinearDissipator, OpenQuantumSystem, QuantumSystem,
                              RealGeneratorSystem)
from .quantum.templates import TransmonSystem
from .quantum.trajectories import DensityTrajectory, UnitaryTrajectory

__all__ = ["sx_gate_problem", "qutrit_x_problem", "cnot_problem",
           "robustness_ensemble", "lindblad_problem"]


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


def qutrit_x_problem(N: int = 100, T: float = 20.0, seed: int = 0,
                     leakage_cost: float = 1.0, device=None, **kw):
    """Config 2: X gate on the 0-1 subspace of a 3-level transmon with
    leakage suppression (embedded goal + leakage objective), no state box
    (the embedded X has unitary entries at +-1). The seed pulse is rolled
    out on `device` (the card unless the caller passes "cpu")."""
    sys = TransmonSystem(levels=3, omega=4.0, delta=0.2, drive_bounds=0.2)
    goal = EmbeddedOperator(GATES["X"], [0, 1], [3])
    pulse, _ = _seed_pulse(N, T, 2, seed)
    qtraj = UnitaryTrajectory(sys, pulse, goal, device=device)
    leak_idx = get_iso_vec_leakage_indices([0, 1], 3)
    kw.setdefault("Q", 100.0)
    kw.setdefault("R", 1e-2)
    kw.setdefault("state_bound", None)
    return SmoothPulseProblem(qtraj, N, leakage_indices=leak_idx,
                              leakage_cost=leakage_cost, **kw)


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


def robustness_ensemble(n_samples: int = 1024, N: int = 50, T: float = 10.0,
                        eps_scale: float = 0.02, seed: int = 0, device=None):
    """Config 4: n_samples SX problems whose drifts carry a detuning
    H_drift + eps * sigma_z / 2, eps = eps_scale * N(0, 1) drawn from
    `seed`, solved as one batch. The perturbation enters the params: the
    solver view's drift becomes [n_samples, 4, 4] (eps * G(sigma_z / 2),
    G linear in H); the goal, the frozen timesteps and the pins are
    broadcast to the batch, the drives are shared. Built on `device` (the
    card unless the caller passes "cpu") in float64.

    Returns (nlp, params_batch, Z0_batch, layout) for
    `parallel.mesh.batch_solve`.
    """
    prob = sx_gate_problem(N=N, T=T, seed=seed, device=device)
    nlp, params, Z0, _, layout = prob.build(device=device)
    rng = np.random.default_rng(seed)
    eps = eps_scale * rng.standard_normal(n_samples)
    Gz = iso.iso(-0.5j * np.asarray(PAULIS["Z"]))
    base = params["system"]
    dG = torch.as_tensor(eps[:, None, None] * Gz).to(Z0.device, Z0.dtype)
    params_batch = {
        "system": RealGeneratorSystem(base.G_drift + dG, base.G_drives,
                                      base.levels),
        "goal": {n: v.expand(n_samples, *v.shape)
                 for n, v in params["goal"].items()},
        "frozen": {n: v.expand(n_samples, *v.shape)
                   for n, v in params["frozen"].items()},
        "pin_val": params["pin_val"].expand(n_samples, *params["pin_val"].shape),
    }
    return nlp, params_batch, Z0.expand(n_samples, *Z0.shape), layout


def lindblad_problem(N: int = 50, T: float = 10.0, gamma: float = 0.01,
                     seed: int = 0, device=None, **kw):
    """Config 5: the density transfer |0><0| -> |1><1| on a 3-level
    transmon (config 2's Hamiltonian, drives bounded by 0.2) with decay
    sqrt(gamma) a, collocated on the compact density iso. The seed pulse is
    rolled out on `device` (the card unless the caller passes "cpu")."""
    base = TransmonSystem(levels=3, omega=4.0, delta=0.2, drive_bounds=0.2)
    sys = OpenQuantumSystem(base.H_drift, base.H_drives, 0.2,
                            dissipators=[LinearDissipator(annihilate(3), gamma)])
    rho0 = np.zeros((3, 3), dtype=complex)
    rho0[0, 0] = 1.0
    rho_goal = np.zeros((3, 3), dtype=complex)
    rho_goal[1, 1] = 1.0
    pulse, _ = _seed_pulse(N, T, 2, seed)
    qtraj = DensityTrajectory(sys, pulse, rho0, rho_goal, device=device)
    kw.setdefault("Q", 100.0)
    kw.setdefault("R", 1e-2)
    return SmoothPulseProblem(qtraj, N, **kw)
