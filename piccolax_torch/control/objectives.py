"""Objective terms of the separable stage cost, batched over leading axes.

`knot_cost(get, term, params)` gives the cost of the knots whose
components `get(name)` returns ([..., d] -> [...]); `term` is 1.0 at the
final knot and 0.0 elsewhere, where piccolax masks terminal terms with
jnp.where. No kernel is reached: derivatives come from `torch.func`.
"""

from __future__ import annotations

import torch

from ..quantum import dynamics as dyn

__all__ = ["UnitaryInfidelityObjective", "QuadraticRegularizer"]


class UnitaryInfidelityObjective:
    """Q * (1 - F(U_{N-1}, goal)) with the bounded iso fidelity."""

    def __init__(self, state_name: str, Q: float = 100.0, subspace=None):
        if subspace is not None:
            raise NotImplementedError("subspace (embedded-goal) fidelity")
        self.state_name = state_name
        self.Q = Q

    def knot_cost(self, get, term, params):
        F = dyn.unitary_fidelity_iso_bounded(get(self.state_name),
                                             params["goal"][self.state_name])
        return term * (self.Q * (1.0 - F))


class QuadraticRegularizer:
    """(R/2) * sum_k ||v_k||^2."""

    def __init__(self, name: str, R):
        self.name = name
        self.R = R

    def knot_cost(self, get, term, params):
        v = get(self.name)
        R = torch.as_tensor(self.R, dtype=v.dtype, device=v.device)
        return 0.5 * torch.sum(R * v ** 2, dim=-1)
