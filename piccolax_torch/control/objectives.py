"""Objective terms of the separable stage cost, batched over leading axes.

`knot_cost(get, term, params, gview=, first=)` gives the cost of the
knots whose components `get(name)` returns ([..., d] -> [...]) and whose
globals `gview(name)` returns ([..., d], broadcast to every knot); `term`
is 1.0 at the final knot and 0.0 elsewhere and `first` 1.0 at the first,
where piccolax masks terminal and once-only terms with jnp.where. No
kernel is reached: derivatives come from `torch.func`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..quantum import dynamics as dyn
from ..quantum import isomorphisms as iso
from ..solver.nlp import batch_view

__all__ = ["UnitaryInfidelityObjective", "UnitaryFreePhaseInfidelityObjective",
           "DensityInfidelityObjective", "QuadraticRegularizer", "LeakageObjective",
           "GlobalRegularizer"]


class UnitaryInfidelityObjective:
    """Q * (1 - F(U_{N-1}, goal)) with the bounded iso fidelity; the
    bounded Pedersen fidelity of the subspace block when the goal is
    embedded (`subspace` its indices)."""

    def __init__(self, state_name: str, Q: float = 100.0, subspace=None):
        self.state_name = state_name
        self.Q = Q
        self.subspace = None if subspace is None else np.asarray(subspace)
        self._idx = {}                  # iso indices of the subspace block, by device

    def _sub_idx(self, x):
        idx = self._idx.get(x.device)
        if idx is None:
            n = int(round(np.sqrt(x.shape[-1] // 2)))
            idx = self._idx[x.device] = torch.as_tensor(
                iso.operator_subspace_iso_indices(n, self.subspace), device=x.device)
        return idx

    def fidelity(self, x, params):
        goal = batch_view(params["goal"][self.state_name], 1, x.dim() - 1)
        if self.subspace is not None:
            idx = self._sub_idx(x)
            return dyn.pedersen_fidelity_iso_bounded(x[..., idx], goal[..., idx], x)
        return dyn.unitary_fidelity_iso_bounded(x, goal)

    def knot_cost(self, get, term, params, gview=None, first=None):
        F = self.fidelity(get(self.state_name), params)
        return term * (self.Q * (1.0 - F))


class UnitaryFreePhaseInfidelityObjective(UnitaryInfidelityObjective):
    """The unitary infidelity against Z(theta) goal: free per-qubit Z
    phases theta, the global `phase_name`, rotate the goal's rows before
    the fidelity (free_phase_angles' convention)."""

    def __init__(self, state_name: str, phase_name: str, n_qubits: int,
                 Q: float = 100.0, subspace=None):
        super().__init__(state_name, Q, subspace)
        self.phase_name = phase_name
        self.n_qubits = n_qubits

    def knot_cost(self, get, term, params, gview=None, first=None):
        x = get(self.state_name)
        goal = batch_view(params["goal"][self.state_name], 1, x.dim() - 1)
        xs, goal_s = x, goal
        if self.subspace is not None:
            idx = self._sub_idx(x)
            xs, goal_s = x[..., idx], goal[..., idx]
        m = int(round(np.sqrt(xs.shape[-1] // 2)))
        ang = dyn.free_phase_angles(gview(self.phase_name), self.n_qubits, m)
        goal_rot = iso.apply_row_phase_iso(goal_s, torch.cos(ang), torch.sin(ang))
        if self.subspace is not None:
            F = dyn.pedersen_fidelity_iso_bounded(xs, goal_rot, x)
        else:
            F = dyn.unitary_fidelity_iso_bounded(x, goal_rot)
        return term * (self.Q * (1.0 - F))


class DensityInfidelityObjective:
    """Q * (1 - F(x_{N-1}, goal)) on the compact density iso, F the plain
    dot `dynamics.density_fidelity_iso` (tr(rho rho_goal) for a diagonal
    goal)."""

    def __init__(self, state_name: str, Q: float = 100.0):
        self.state_name = state_name
        self.Q = Q

    def knot_cost(self, get, term, params, gview=None, first=None):
        x = get(self.state_name)
        goal = batch_view(params["goal"][self.state_name], 1, x.dim() - 1)
        return term * (self.Q * (1.0 - dyn.density_fidelity_iso(x, goal)))


class QuadraticRegularizer:
    """(R/2) * sum_k ||v_k||^2."""

    def __init__(self, name: str, R):
        self.name = name
        self.R = R

    def knot_cost(self, get, term, params, gview=None, first=None):
        v = get(self.name)
        R = torch.as_tensor(self.R, dtype=v.dtype, device=v.device)
        return 0.5 * torch.sum(R * v ** 2, dim=-1)


class LeakageObjective:
    """Q * sum_k ||x_k[indices]||^2: the population outside the
    computational subspace, summed over the knots; `indices` are iso-vec
    component indices of leakage entries."""

    def __init__(self, state_name: str, indices, Q: float = 1.0):
        self.state_name = state_name
        self.indices = np.asarray(indices)
        self.Q = Q
        self._idx = {}                  # self.indices as a tensor, by device

    def knot_cost(self, get, term, params, gview=None, first=None):
        x = get(self.state_name)
        idx = self._idx.get(x.device)
        if idx is None:
            idx = self._idx[x.device] = torch.as_tensor(self.indices, device=x.device)
        return self.Q * torch.sum(x[..., idx] ** 2, dim=-1)


class GlobalRegularizer:
    """(R/2) ||g_name||^2 of the global `name`, counted once (at the first
    knot)."""

    def __init__(self, name: str, R):
        self.name = name
        self.R = R

    def knot_cost(self, get, term, params, gview=None, first=None):
        v = gview(self.name)
        R = torch.as_tensor(self.R, dtype=v.dtype, device=v.device)
        return first * (0.5 * torch.sum(R * v ** 2, dim=-1))
