"""Unitary trajectories and their discretization into a knot `Trajectory`
(host-side numpy and scipy; the interface of
`piccolax.quantum.trajectories`)."""

from __future__ import annotations

import numpy as np
import scipy.linalg

from ..trajectory import Trajectory
from . import dynamics as dyn
from . import isomorphisms as iso
from .pulses import ZeroOrderPulse

__all__ = ["UnitaryTrajectory", "discretize"]


def _zoh_rollout(system, pulse, times):
    """U at each knot time of a ZOH pulse: exact per-interval exponentials
    composed on the host in float64 (initialization only)."""
    Us = [np.eye(system.levels, dtype=np.complex128)]
    for k in range(len(times) - 1):
        h = times[k + 1] - times[k]
        Us.append(scipy.linalg.expm(-1j * h * system.H(pulse(times[k])))
                  @ Us[-1])
    return np.stack(Us)


class UnitaryTrajectory:
    """Gate synthesis trajectory: system, pulse, goal, and the rollout at
    the pulse's knot times computed at construction."""

    state_name = "U"

    def __init__(self, system, pulse, goal):
        if not isinstance(pulse, ZeroOrderPulse):
            raise NotImplementedError("only ZeroOrderPulse is ported")
        if not isinstance(goal, np.ndarray):
            raise NotImplementedError("embedded (subspace) goals")
        self.system = system
        self.pulse = pulse
        self.goal = np.asarray(goal, dtype=np.complex128)
        self.subspace = None
        self.times = np.asarray(pulse.knot_times())
        self.Us = _zoh_rollout(system, pulse, self.times)

    @property
    def drive_name(self) -> str:
        return self.pulse.drive_name

    def fidelity(self):
        return dyn.unitary_fidelity(self.Us[-1], self.goal)

    def state_iso(self, times):
        """Rollout states at the knot times as iso-vecs [T, 2n^2]."""
        assert np.allclose(np.asarray(times), self.times)
        return iso.operator_to_iso_vec(self.Us)

    def goal_iso(self):
        return iso.operator_to_iso_vec(self.goal)


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
    """Convert a unitary trajectory into a knot `Trajectory`; with
    geodesic=True the state knots start on the geodesic from I to the
    goal. Timesteps are frozen data (free timesteps are not ported)."""
    if dt_bounds is not None:
        raise NotImplementedError("free timesteps (dt_bounds)")
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

    if geodesic:
        span = max(float(times[-1] - times[0]), 1e-30)
        s = (times - times[0]) / span
        siso = iso.operator_to_iso_vec(_unitary_geodesic(qtraj.goal, s))
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

    data["dt"] = dts[:, None]
    data["t"] = times[:, None]
    return Trajectory(data, controls=(dname,), timestep="dt", bounds=bounds,
                      initial=initial, final=final, goal=goal,
                      frozen=("dt", "t"))
