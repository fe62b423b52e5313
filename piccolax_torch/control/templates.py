"""Problem templates: `SmoothPulseProblem`, on the unitary-gate and the
density (Lindblad) paths of `piccolax.control.templates` (ZOH pulse,
chained derivatives u -> du -> ddu, bilinear unitary or compact-density
dynamics, terminal infidelity, quadratic regularizers, optionally free
and equal timesteps, a leakage cost and a leakage constraint, free
per-qubit Z phases of a unitary goal as globals, bounds and calibration
pins of globals, extra objectives and constraints)."""

from __future__ import annotations

import numpy as np

from ..quantum.operators import get_iso_vec_leakage_indices
from ..quantum.trajectories import DensityTrajectory, UnitaryTrajectory, discretize
from . import constraints as cons
from . import integrators as intg
from . import objectives as obj
from .problem import QuantumControlProblem

__all__ = ["SmoothPulseProblem"]


def SmoothPulseProblem(qtraj, N=None, *, Q: float = 100.0, R: float = 1e-2,
                       R_u=None, R_du=None, R_ddu=None,
                       du_bound: float = 1.0, ddu_bound: float = 1.0,
                       dt_bounds=None, timesteps_all_equal=None,
                       zero_initial_and_final_derivative=None,
                       state_bound="box", pade_order="taylor",
                       leakage_indices=None, leakage_cost=None,
                       leakage_value=None, free_phase=False,
                       phase_name: str = "theta",
                       global_bounds=None, calibration_targets=None,
                       geodesic=None, options=None,
                       extra_objectives=(), extra_constraints=()):
    """Canonical ZOH-pulse collocation problem with smoothness via chained
    derivative variables du, ddu. With dt_bounds the timesteps are bounded
    decision variables, held equal unless timesteps_all_equal=False.
    pade_order is "taylor" (the Taylor approximant, K4) or a diagonal Pade
    order in {3, 5, 7, 9} (K6) for the collocation propagators; any other
    value raises ValueError. leakage_cost adds a `LeakageObjective` and
    leakage_value a `LeakageConstraint` (population <= value at every
    knot) on leakage_indices (iso-vec indices), derived from an embedded
    goal's subspace when none are given.

    free_phase: True (the qubit count from the goal's or subspace's
    dimension), an int qubit count, or a tuple of 2s: optimize per-qubit
    Z phases of the goal as the global `phase_name` (the geodesic initial
    guess is then off unless asked for). global_bounds: {global: (lo,
    hi)}; calibration_targets: {global: value}, pinned by equality rows.
    PiccoloOptions records (`options`) are not ported."""
    if options is not None:
        raise NotImplementedError("SmoothPulseProblem: options records")
    if not isinstance(qtraj, (UnitaryTrajectory, DensityTrajectory)):
        raise NotImplementedError("only UnitaryTrajectory and DensityTrajectory "
                                  "are ported")
    leakage_cost = leakage_cost or 0.0
    if leakage_indices is None and (leakage_cost or leakage_value is not None) \
            and qtraj.subspace is not None:
        leakage_indices = get_iso_vec_leakage_indices(qtraj.subspace,
                                                      qtraj.system.levels)
    zero_d = bool(zero_initial_and_final_derivative)
    if state_bound == "box":
        state_bound = 1.0
    geodesic = not free_phase if geodesic is None else geodesic
    timesteps_all_equal = True if timesteps_all_equal is None \
        else timesteps_all_equal
    traj = discretize(qtraj, N, dt_bounds=dt_bounds, state_bound=state_bound,
                      geodesic=geodesic)
    dname = qtraj.drive_name
    traj = traj.add_control_derivatives(
        2, name=dname, bounds=[du_bound, ddu_bound],
        zero_initial=zero_d, zero_final=zero_d)
    R_u = R if R_u is None else R_u
    R_du = R if R_du is None else R_du
    R_ddu = R if R_ddu is None else R_ddu

    norm_bound = intg._bound_dt_G_norm(qtraj.system, traj)
    if norm_bound > 1.5:
        import warnings
        warnings.warn(
            f"dt * ||H|| may reach {norm_bound:.2f} (> 1.5): the collocation "
            "constraints are strongly nonlinear per knot and the solver may "
            "crawl. Increase the knot count N (smaller dt) or rescale units.",
            stacklevel=2)
    squarings = intg.choose_squarings(norm_bound, pade_order)
    if isinstance(qtraj, DensityTrajectory):
        integrators = [intg.BilinearDensityIntegrator(
            (qtraj.state_name,), dname, qtraj.system.levels, order=pade_order,
            squarings=squarings)]
        objectives = [obj.DensityInfidelityObjective(qtraj.state_name, Q=Q)]
    else:
        integrators = [intg.BilinearUnitaryIntegrator(
            qtraj.state_name, dname, qtraj.system.levels, order=pade_order,
            squarings=squarings)]
        objectives = [obj.UnitaryInfidelityObjective(qtraj.state_name, Q=Q,
                                                     subspace=qtraj.subspace)]
    phase_info = None
    if free_phase:
        traj, objectives, phase_info = _apply_free_phase(qtraj, traj, objectives,
                                                         free_phase, phase_name)
    for nm, b in dict(global_bounds or {}).items():
        traj = traj.update_bound(nm, b)
    names = [dname, "d" + dname, "dd" + dname]
    d = traj.dims[dname]
    for a, b in zip(names[:-1], names[1:]):
        integrators.append(intg.DerivativeIntegrator(a, b, d))
    if dt_bounds is not None and timesteps_all_equal:
        integrators.append(intg.TimeStepsEqualIntegrator("dt"))
    for Ri, nm in zip((R_u, R_du, R_ddu), names):
        if Ri is not None and Ri != 0:
            objectives.append(obj.QuadraticRegularizer(nm, Ri))
    constraints = list(extra_constraints)
    for nm, val in dict(calibration_targets or {}).items():
        constraints.append(cons.GlobalPinConstraint(nm, val))
    if leakage_indices is not None:
        if leakage_cost:
            objectives.append(obj.LeakageObjective(qtraj.state_name,
                                                   leakage_indices, Q=leakage_cost))
        if leakage_value is not None:
            constraints.append(cons.LeakageConstraint(qtraj.state_name,
                                                      leakage_indices, leakage_value))
    objectives.extend(extra_objectives)
    prob = QuantumControlProblem(qtraj, traj, objectives, integrators, constraints)
    if phase_info is not None:
        prob._phase_global = phase_info
    return prob


def _global_slice(traj, name):
    """Column slice of global `name` in the global vector (constraint
    setup only appends globals, so it never moves)."""
    off = 0
    for n in traj.global_names:
        d = traj.global_data[n].shape[0]
        if n == name:
            return slice(off, off + d)
        off += d
    raise KeyError(name)


def _apply_free_phase(qtraj, traj, objectives, free_phase, phase_name):
    """Add the free-phase global and swap the unitary infidelity for its
    free-phase variant. Returns (traj, objectives, (phase_name, n_qubits))."""
    if isinstance(free_phase, (tuple, list)):
        if any(int(v) != 2 for v in free_phase):
            raise ValueError("subsystem-level free phases apply to ket goals; "
                             "unitary goals take per-qubit phases (free_phase=True "
                             "or an int qubit count)")
        n_phase = len(free_phase)
    elif free_phase is True:
        dim = len(qtraj.subspace) if getattr(qtraj, "subspace", None) is not None \
            else qtraj.system.levels
        n_phase = max(1, int(round(np.log2(dim))))
    else:
        n_phase = int(free_phase)
    traj = traj.with_global_data(**{phase_name: np.zeros(n_phase)})
    objectives = [obj.UnitaryFreePhaseInfidelityObjective(
        o.state_name, phase_name, n_phase, Q=o.Q, subspace=qtraj.subspace)
        if type(o) is obj.UnitaryInfidelityObjective else o for o in objectives]
    return traj, objectives, (phase_name, n_phase)
