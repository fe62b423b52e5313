"""Unitary and density trajectories, their discretization into a knot
`Trajectory` and pulse extraction; the interface of
`piccolax.quantum.trajectories`.

A `UnitaryTrajectory` or a `DensityTrajectory` rolls its pulse out on
the device at construction (`dynamics.unitary_rollout` or
`dynamics.density_rollout`, kernel K5); the knot data and the geodesic
initial guess are host-side numpy and scipy."""

from __future__ import annotations

import numpy as np
import scipy.linalg

from .._device import resolve_device
from ..trajectory import Trajectory
from . import dynamics as dyn
from . import isomorphisms as iso
from .operators import EmbeddedOperator
from .pulses import ZeroOrderPulse

__all__ = ["UnitaryTrajectory", "DensityTrajectory", "discretize", "extract_pulse"]


class UnitaryTrajectory:
    """Gate synthesis trajectory: system, pulse, goal, and the rollout at
    the save times computed at construction on `device` (the card unless
    the caller passes "cpu"). An `EmbeddedOperator` goal keeps its
    full-space matrix in `goal` and its subspace in `subspace`; the
    fidelity is then the Pedersen fidelity of the subspace block."""

    state_name = "U"

    def __init__(self, system, pulse, goal, times=None, n_substeps: int = 1,
                 method=None, device=None):
        if not isinstance(pulse, ZeroOrderPulse):
            raise NotImplementedError("only ZeroOrderPulse is ported")
        self.device = resolve_device(device)
        self.system = system
        self.pulse = pulse
        if isinstance(goal, EmbeddedOperator):
            self.goal = goal.operator
            self.subspace = goal.subspace
            self.subsystem_levels = goal.subsystem_levels
        else:
            self.goal = np.asarray(goal, dtype=np.complex128)
            self.subspace = self.subsystem_levels = None
        self.times = np.asarray(pulse.knot_times() if times is None else times)
        self.Us = dyn.unitary_rollout(system, pulse, self.times, method=method,
                                      n_substeps=n_substeps, device=self.device)

    @property
    def drive_name(self) -> str:
        return self.pulse.drive_name

    @property
    def embedded_goal(self):
        if self.subspace is None:
            return None
        return EmbeddedOperator(
            self.goal[np.ix_(self.subspace, self.subspace)],
            self.subspace, self.subsystem_levels)

    def fidelity(self, phases=None, n_qubits=None):
        """Gate fidelity of the final propagator; with `phases`, against
        diag(e^{i free_phase_angles}) goal (on the subspace block for an
        embedded goal), n_qubits defaulting to len(phases)."""
        U_final = self.Us[-1]
        goal = self.goal
        if self.subspace is not None:
            sub = np.ix_(self.subspace, self.subspace)
            U_final, goal = U_final[sub], goal[sub]
        if phases is not None:
            phases = np.asarray(phases, dtype=float)
            goal = dyn.free_phase_diagonal(phases, n_qubits or len(phases),
                                           goal.shape[-1]).numpy()[:, None] * goal
        if self.subspace is not None:
            return dyn.pedersen_fidelity(U_final, goal)
        return dyn.unitary_fidelity(U_final, goal)

    def rollout(self, pulse=None, n_substeps: int = 1, method=None,
                device=None) -> "UnitaryTrajectory":
        """Re-integrate (optionally with a new pulse) -> fresh trajectory,
        on `device` (default: this trajectory's)."""
        pulse = pulse or self.pulse
        goal = self.embedded_goal if self.subspace is not None else self.goal
        return UnitaryTrajectory(self.system, pulse, goal,
                                 times=pulse.knot_times(), n_substeps=n_substeps,
                                 method=method, device=device or self.device)

    def state_iso(self, times):
        """Exact rollout states at the given times as iso-vecs [T, 2n^2]."""
        Us = dyn.unitary_rollout(self.system, self.pulse, np.asarray(times),
                                 device=self.device)
        return iso.operator_to_iso_vec(Us.cpu().numpy())

    def goal_iso(self):
        return iso.operator_to_iso_vec(self.goal)


class DensityTrajectory:
    """Open-system density-matrix trajectory: system (an
    `OpenQuantumSystem`), pulse, initial and goal density matrices, and
    the Lindblad rollout at the save times computed at construction on
    `device` (the card unless the caller passes "cpu"), n_substeps midpoint
    steps an interval."""

    state_name = "rho"
    subspace = None

    def __init__(self, system, pulse, initial, goal, times=None,
                 n_substeps: int = 4, device=None):
        if not isinstance(pulse, ZeroOrderPulse):
            raise NotImplementedError("only ZeroOrderPulse is ported")
        self.device = resolve_device(device)
        self.system = system
        self.pulse = pulse
        self.initial = np.asarray(initial, dtype=np.complex128)
        self.goal = np.asarray(goal, dtype=np.complex128)
        self.n_substeps = n_substeps
        self.times = np.asarray(pulse.knot_times() if times is None else times)
        self.rhos = dyn.density_rollout(system, pulse, self.times, self.initial,
                                        n_substeps, device=self.device)

    @property
    def drive_name(self) -> str:
        return self.pulse.drive_name

    def fidelity(self):
        """tr(rho_final rho_goal)."""
        return dyn.density_fidelity(self.rhos[-1], self.goal)

    def rollout(self, pulse=None, n_substeps=None, device=None) -> "DensityTrajectory":
        """Re-integrate (optionally with a new pulse) -> fresh trajectory,
        on `device` (default: this trajectory's)."""
        pulse = pulse or self.pulse
        return DensityTrajectory(self.system, pulse, self.initial, self.goal,
                                 times=pulse.knot_times(),
                                 n_substeps=n_substeps or self.n_substeps,
                                 device=device or self.device)

    def state_iso(self, times):
        """Rollout states at the given times as compact isos [T, n^2]."""
        rhos = dyn.density_rollout(self.system, self.pulse, np.asarray(times),
                                   self.initial, self.n_substeps, device=self.device)
        return iso.density_to_compact_iso(rhos.cpu().numpy())

    def goal_iso(self):
        return iso.density_to_compact_iso(self.goal)


def _unitary_geodesic(U_goal, s):
    """Geodesic I -> U_goal on U(n): U(s_k) = expm(s_k * log U_goal)."""
    H = scipy.linalg.logm(np.asarray(U_goal, dtype=complex))
    return np.stack([scipy.linalg.expm(sk * H) for sk in np.asarray(s)])


def _boundary_or_none(value):
    """NaN sentinel = free; None if all components are free."""
    v = np.asarray(value)
    if np.all(np.isnan(v)):
        return None
    return np.nan_to_num(v)


def discretize(qtraj, N_or_times=None, *, dt_bounds=None, state_bound=1.0,
               drive_name=None, geodesic: bool = False):
    """Convert a unitary or density trajectory into a knot `Trajectory`;
    with geodesic=True a unitary's state knots start on the geodesic from
    I to the goal (a density trajectory has no geodesic: its knots come
    from the rollout, as in piccolax). state_bound boxes every state iso
    component (the compact components of a density). With dt_bounds the
    timesteps are a bounded control; the accumulated time t stays frozen
    data (the system is autonomous). Its lower end must be positive: the
    (dt, u) Hessian entries of the bilinear integrator divide by dt."""
    if dt_bounds is not None and not float(dt_bounds[0]) > 0.0:
        raise ValueError(f"discretize: dt_bounds {tuple(dt_bounds)} must have "
                         "a positive lower end")
    pulse = qtraj.pulse
    duration = float(pulse.duration)
    if N_or_times is None:
        times = np.asarray(pulse.knot_times())
    elif np.isscalar(N_or_times):
        times = np.linspace(0.0, duration, int(N_or_times))
    else:
        times = np.asarray(N_or_times)
    N = len(times)
    dts = np.diff(times)
    dts = np.append(dts, dts[-1])
    dname = drive_name or pulse.drive_name
    us = pulse.sample(times)

    if geodesic and isinstance(qtraj, UnitaryTrajectory):
        span = max(float(times[-1] - times[0]), 1e-30)
        s = (times - times[0]) / span
        U_goal = qtraj.goal
        if qtraj.subspace is not None:
            # an embedded goal is singular on the leakage complement: the
            # geodesic of the subspace block, identity on the complement
            comp = np.setdiff1d(np.arange(U_goal.shape[0]),
                                np.asarray(qtraj.subspace))
            U_goal = U_goal.copy()
            U_goal[comp, comp] = 1.0
        siso = iso.operator_to_iso_vec(_unitary_geodesic(U_goal, s))
    else:
        siso = qtraj.state_iso(times)
    sname = qtraj.state_name
    data = {sname: siso}
    bounds = {}
    if state_bound is not None:
        bounds[sname] = state_bound
    initial = {sname: siso[0]}
    final = {}
    goal = {sname: qtraj.goal_iso()}

    data[dname] = us
    bounds[dname] = np.asarray(qtraj.system.drive_bounds)
    iv = _boundary_or_none(pulse.initial_value)
    fv = _boundary_or_none(pulse.final_value)
    if iv is not None:
        initial[dname] = iv
    if fv is not None:
        final[dname] = fv

    controls = (dname,)
    data["dt"] = dts[:, None]
    data["t"] = times[:, None]
    if dt_bounds is not None:
        bounds["dt"] = np.array([[float(dt_bounds[0]), float(dt_bounds[1])]])
        controls = controls + ("dt",)
        frozen = ("t",)
    else:
        frozen = ("dt", "t")
    return Trajectory(data, controls=controls, timestep="dt", bounds=bounds,
                      initial=initial, final=final, goal=goal, frozen=frozen)


def extract_pulse(qtraj, traj: Trajectory):
    """Rebuild the pulse of the original parameterization (ZOH) from an
    optimized knot trajectory, at its accumulated knot times."""
    pulse = qtraj.pulse
    if not isinstance(pulse, ZeroOrderPulse):
        raise NotImplementedError("only ZeroOrderPulse is ported")
    dname = pulse.drive_name
    return ZeroOrderPulse(traj[dname], traj.get_times(), drive_name=dname,
                          initial_value=pulse.initial_value,
                          final_value=pulse.final_value)
