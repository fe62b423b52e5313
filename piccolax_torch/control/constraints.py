"""Nonlinear constraints of collocation problems, the interface of
`piccolax.control.constraints`: every inequality becomes an equality plus
a slack with a [0, inf) bound (a knot component or a global), which the
interior-point solver carries through its log barrier.

Protocol: `setup(traj)` may append slack components or globals (always
at the end, so earlier column slices never move) and `eq_rows(N)` gives
the constraint's `EqRowGroup`s, whose `fn(get, gview, params)` is batched
over leading axes like the objectives: `get(name)` returns a knot
component [..., d], `gview(name)` a global [..., d] broadcast to every
knot, and fn returns the group's rows [..., dim]. No kernel is reached:
the solver differentiates the rows with `torch.func`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..quantum import dynamics as dyn
from ..quantum import isomorphisms as iso
from ..solver.nlp import batch_view

__all__ = [
    "EqRowGroup",
    "FinalUnitaryFidelityConstraint",
    "FinalUnitaryFreePhaseFidelityConstraint",
    "FinalKetFidelityConstraint",
    "FinalCoherentKetFidelityConstraint",
    "FinalDensityFidelityConstraint",
    "LeakageConstraint",
    "L1SlackConstraint",
    "BoundStateL2Constraint",
    "ComplexModulusConstraint",
    "GlobalPinConstraint",
    "iso_entry_pairs",
]


class EqRowGroup:
    """One group of stage-equality rows: dim, activity mask [N, dim], and
    fn(get, gview, params) -> [..., dim]."""

    def __init__(self, dim, mask, fn):
        self.dim = dim
        self.mask = mask
        self.fn = fn


def _in_transform() -> bool:
    """True inside a torch.func transform (a tensor made there belongs to
    its level and must not be kept)."""
    peek = getattr(torch._C._functorch, "peek_interpreter_stack", None)
    return peek is None or peek() is not None


class _DeviceArrays:
    """Host arrays as tensors, kept once a (device, dtype) when made
    outside torch.func transforms (the solver evaluates every row once
    outside them before it differentiates)."""

    def __init__(self, **arrays):
        self._host = arrays
        self._cache = {}

    def on(self, like, name, dtype=None):
        key = (name, like.device, dtype)
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(self._host[name], dtype=dtype, device=like.device)
            if not _in_transform():
                self._cache[key] = t
        return t


def _add_global_slack(traj, name):
    return traj.with_global_data(**{name: [0.01]}).update_bound(
        name, np.asarray([[0.0, np.inf]]))


def _final_mask(N):
    mask = np.zeros((N, 1))
    mask[N - 1] = 1.0
    return mask


class _ConstraintBase:
    def setup(self, traj):
        return traj

    def eq_rows(self, N: int):
        return []


class FinalUnitaryFidelityConstraint(_ConstraintBase):
    """F(U_{N-1}) >= min_fidelity through a global slack s in [0, inf):
    F - F_min - s = 0 at the last knot; the Pedersen fidelity of the
    subspace block when `subspace` is given."""

    def __init__(self, state_name: str, min_fidelity: float, subspace=None,
                 slack_name: str | None = None):
        self.state_name = state_name
        self.min_fidelity = float(min_fidelity)
        self.subspace = None if subspace is None else np.asarray(subspace)
        self.slack_name = slack_name or f"_fid_slack_{state_name}"
        self._arr = None

    def _sub(self, x, goal):
        """(x, goal) restricted to the subspace block's iso entries."""
        if self.subspace is None:
            return x, goal
        if self._arr is None:
            n = int(round(np.sqrt(x.shape[-1] // 2)))
            self._arr = _DeviceArrays(idx=iso.operator_subspace_iso_indices(
                n, self.subspace))
        idx = self._arr.on(x, "idx")
        return x[..., idx], goal[..., idx]

    def _goal(self, x, params):
        return batch_view(params["goal"][self.state_name], 1, x.dim() - 1)

    def _F(self, x, params):
        xs, goal = self._sub(x, self._goal(x, params))
        if self.subspace is not None:
            return dyn.pedersen_fidelity_iso(xs, goal)
        return dyn.unitary_fidelity_iso(xs, goal)

    def setup(self, traj):
        return _add_global_slack(traj, self.slack_name)

    def eq_rows(self, N: int):
        def fn(get, gview, params):
            F = self._F(get(self.state_name), params)
            return (F - self.min_fidelity - gview(self.slack_name)[..., 0])[..., None]

        return [EqRowGroup(1, _final_mask(N), fn)]


class FinalUnitaryFreePhaseFidelityConstraint(FinalUnitaryFidelityConstraint):
    """F(U_{N-1}, Z(theta) goal) >= min_fidelity with the free phases
    theta read from the global `phase_name`."""

    def __init__(self, state_name: str, min_fidelity: float, phase_name: str,
                 n_qubits: int, subspace=None, slack_name=None):
        super().__init__(state_name, min_fidelity, subspace, slack_name)
        self.phase_name = phase_name
        self.n_qubits = n_qubits

    def eq_rows(self, N: int):
        def fn(get, gview, params):
            x = get(self.state_name)
            xs, goal = self._sub(x, self._goal(x, params))
            m = int(round(np.sqrt(xs.shape[-1] // 2)))
            ang = dyn.free_phase_angles(gview(self.phase_name), self.n_qubits, m)
            goal = iso.apply_row_phase_iso(goal, torch.cos(ang), torch.sin(ang))
            F = dyn.pedersen_fidelity_iso(xs, goal) if self.subspace is not None \
                else dyn.unitary_fidelity_iso(xs, goal)
            return (F - self.min_fidelity - gview(self.slack_name)[..., 0])[..., None]

        return [EqRowGroup(1, _final_mask(N), fn)]


class FinalKetFidelityConstraint(FinalUnitaryFidelityConstraint):
    """|<psi|goal>|^2 >= min_fidelity: waits for the ket trajectories."""

    def __init__(self, *args, **kw):
        raise NotImplementedError("FinalKetFidelityConstraint (ket trajectories)")


class FinalCoherentKetFidelityConstraint(_ConstraintBase):
    """Coherent multi-ket fidelity >= min_fidelity: waits for the ket
    trajectories."""

    def __init__(self, *args, **kw):
        raise NotImplementedError("FinalCoherentKetFidelityConstraint "
                                  "(ket trajectories)")


class FinalDensityFidelityConstraint(FinalUnitaryFidelityConstraint):
    """tr(rho rho_goal) >= min_fidelity on the compact density iso."""

    def _F(self, x, params):
        return dyn.density_fidelity_iso(x, self._goal(x, params))


class LeakageConstraint(_ConstraintBase):
    """Per-knot leakage population <= value through a per-knot slack
    component s_k in [0, inf): value - sum(x_leak^2) - s_k = 0 (on the
    knots of `times`, default all)."""

    def __init__(self, state_name: str, indices, value: float,
                 slack_name: str | None = None, times=None):
        self.state_name = state_name
        self.indices = np.asarray(indices)
        self.value = float(value)
        self.slack_name = slack_name or f"_leak_slack_{state_name}"
        self.times = times
        self._arr = _DeviceArrays(idx=self.indices)

    def setup(self, traj):
        x = traj[self.state_name]
        pop = np.sum(x[:, self.indices] ** 2, axis=1, keepdims=True)
        s0 = np.clip(self.value - pop, 1e-4, None)
        return traj.add_component(self.slack_name, s0,
                                  bound=np.array([[0.0, np.inf]]))

    def eq_rows(self, N: int):
        mask = np.ones((N, 1))
        if self.times is not None:
            mask = np.zeros((N, 1))
            mask[np.asarray(self.times)] = 1.0

        def fn(get, gview, params):
            x = get(self.state_name)
            pop = torch.sum(x[..., self._arr.on(x, "idx")] ** 2, dim=-1)
            return (self.value - pop - get(self.slack_name)[..., 0])[..., None]

        return [EqRowGroup(1, mask, fn)]


class L1SlackConstraint(_ConstraintBase):
    """The exact L1 split v = s+ - s-, s+- >= 0 (the template's objective
    penalizes R sum(s+ + s-))."""

    def __init__(self, name: str, dim: int):
        self.name = name
        self.dim = dim
        self.pos_name = f"_s_pos_{name}"
        self.neg_name = f"_s_neg_{name}"

    def setup(self, traj):
        v = traj[self.name]
        bound = np.stack([np.zeros(self.dim), np.full(self.dim, np.inf)], -1)
        traj = traj.add_component(self.pos_name, np.clip(v, 0.0, None) + 1e-4,
                                  bound=bound)
        return traj.add_component(self.neg_name, np.clip(-v, 0.0, None) + 1e-4,
                                  bound=bound)

    def eq_rows(self, N: int):
        def fn(get, gview, params):
            return get(self.name) - get(self.pos_name) + get(self.neg_name)

        return [EqRowGroup(self.dim, np.ones((N, self.dim)), fn)]


class GlobalPinConstraint(_ConstraintBase):
    """Pin a global to a calibration target by an equality row at the
    first knot."""

    def __init__(self, name: str, value):
        self.name = name
        self.value = np.atleast_1d(np.asarray(value, dtype=float))
        self._arr = _DeviceArrays(target=self.value)

    def eq_rows(self, N: int):
        d = self.value.shape[0]
        mask = np.zeros((N, d))
        mask[0] = 1.0

        def fn(get, gview, params):
            v = gview(self.name)
            return v - self._arr.on(v, "target", v.dtype)

        return [EqRowGroup(d, mask, fn)]


def iso_entry_pairs(dim: int, n: int):
    """(re, im) index pairs of every complex entry of an iso vector with
    [ncols, (Re, Im), n] layout: ket iso (ncols = 1) or operator iso-vec
    (ncols = n). `dim` is the iso vector length, `n` the Hilbert dim."""
    ncols = dim // (2 * n)
    pairs = []
    for c in range(ncols):
        base = c * 2 * n
        for r in range(n):
            pairs.append((base + r, base + n + r))
    return np.asarray(pairs)


class BoundStateL2Constraint(_ConstraintBase):
    """Per complex component Re^2 + Im^2 <= value with per-knot slacks;
    `pairs` are (re_idx, im_idx) of the state's iso entries."""

    def __init__(self, state_name: str, pairs, slack_name=None, value=1.0):
        self.state_name = state_name
        self.pairs = np.asarray(pairs)
        self.slack_name = slack_name or f"_l2_slack_{state_name}"
        self.value = float(value)
        self._arr = _DeviceArrays(re=self.pairs[:, 0], im=self.pairs[:, 1])

    def setup(self, traj):
        x = traj[self.state_name]
        re, im = x[:, self.pairs[:, 0]], x[:, self.pairs[:, 1]]
        s0 = np.clip(self.value - (re ** 2 + im ** 2), 1e-4, None)
        d = self.pairs.shape[0]
        bound = np.stack([np.zeros(d), np.full(d, np.inf)], -1)
        return traj.add_component(self.slack_name, s0, bound=bound)

    def eq_rows(self, N: int):
        d = self.pairs.shape[0]

        def fn(get, gview, params):
            x = get(self.state_name)
            re, im = x[..., self._arr.on(x, "re")], x[..., self._arr.on(x, "im")]
            return self.value - (re ** 2 + im ** 2) - get(self.slack_name)

        return [EqRowGroup(d, np.ones((N, d)), fn)]


class ComplexModulusConstraint(BoundStateL2Constraint):
    """|u_I + i u_Q| <= r per knot for I/Q drive pairs; `pairs` are (I, Q)
    column pairs within the named control component."""

    def __init__(self, name: str, pairs, r: float, slack_name=None):
        super().__init__(name, pairs, slack_name or f"_cnorm_slack_{name}",
                         value=float(r) ** 2)
