"""Carry a built SmoothPulseProblem-type problem across as plain numpy
arrays.

The arrays take the place of weights: bounds, pins, frozen timesteps, the
real generator matrices, the goal iso-vec, the objective weights, the
layout and the static squaring count. `nlp_from_numpy` builds the port's
NLP from them (for instance from arrays taken out of a `piccolax` build).

Keys: Z0 [N, dz]; lo, hi, pin_mask, pin_val [N, dz]; t [N]; dt [N] when
the timesteps are frozen (a "dt" entry of slices makes them a decision
variable instead); G_drift [2n, 2n]; G_drives [nd, 2n, 2n]; goal [2n^2];
Q (float); R (R_u, R_du, R_ddu); slices {name: (start, stop)} over the
knot columns; state_name, drive_name (str); squarings (int); optional
timesteps_all_equal (bool, default True: free timesteps held equal).

A density problem (state_kind "density"; "unitary" is the default)
carries the compact goal [n^2] and the compact Lindbladian's parts:
lind_drift [n^2, n^2], lind_drives [nd, n^2, n^2], diss_mats
[nL, n^2, n^2] and diss_rates [nL]; the tuples of piccolax's
`solver_view()` (one entry a term) stack into these.

Globals, stage equalities and the terms that read them (all optional):
global_slices {name: (start, stop)} over the global vector, g0 [dg],
g_lo and g_hi [dg] (default unbounded); free_phase (phase_name,
n_qubits): the infidelity against the goal rotated by the phase global;
subspace: the embedded goal's subspace (the Pedersen fidelity of its
block); leakage_indices with leakage_cost (a `LeakageObjective`) and
leakage_value (a `LeakageConstraint`, its per-knot slack the component
leakage_slack of slices, default "_leak_slack_<state_name>");
calibration_targets {global: value} (a `GlobalPinConstraint` each). The
equality rows stack as piccolax's templates order them: the pins, then
the leakage rows.

A batch of problems that share their structure and differ in their data
(piccolax's `params_batch`, as `robustness_ensemble` builds it) gives
Z0, pin_val, t, dt, G_drift and goal a leading batch axis of B; they
become the port's batched params (solver/nlp.py). The drives and the
bounds stay shared.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .control.integrators import (BilinearDensityIntegrator, BilinearUnitaryIntegrator,
                                  DerivativeIntegrator, TimeStepsEqualIntegrator)
from .control.constraints import GlobalPinConstraint, LeakageConstraint
from .control.objectives import (DensityInfidelityObjective, LeakageObjective,
                                 QuadraticRegularizer,
                                 UnitaryFreePhaseInfidelityObjective,
                                 UnitaryInfidelityObjective)
from .quantum.systems import RealGeneratorSystem
from .solver.nlp import CollocationNLP, params_to
from .trajectory import KnotLayout

__all__ = ["nlp_from_numpy"]


def nlp_from_numpy(arrays, device=None, dtype=torch.float64):
    """(nlp, params, Z0, g0, layout) of the port from the arrays of a
    built problem (module docstring)."""
    device = resolve_device(device)
    a = arrays
    names = list(a["slices"])
    gsl = dict(a.get("global_slices", {}))
    layout = KnotLayout(names, [a["slices"][n][1] - a["slices"][n][0]
                                for n in names],
                        list(gsl), [gsl[n][1] - gsl[n][0] for n in gsl])
    U, u = a["state_name"], a["drive_name"]
    density = a.get("state_kind", "unitary") == "density"
    goal = np.asarray(a["goal"], float)
    levels = int(round(np.sqrt(goal.shape[-1] if density else goal.shape[-1] // 2)))
    N = np.asarray(a["lo"]).shape[0]
    nd = layout.slices[u].stop - layout.slices[u].start
    derivs = [u, "d" + u, "dd" + u]
    sq = int(a["squarings"])
    integrators = [BilinearDensityIntegrator((U,), u, levels, squarings=sq) if density
                   else BilinearUnitaryIntegrator(U, u, levels, squarings=sq)]
    integrators += [DerivativeIntegrator(x, y, nd)
                    for x, y in zip(derivs[:-1], derivs[1:])]
    dt_free = "dt" in layout.slices
    if dt_free and a.get("timesteps_all_equal", True):
        integrators.append(TimeStepsEqualIntegrator("dt"))
    sub = a.get("subspace")
    if density:
        objectives = [DensityInfidelityObjective(U, Q=float(a["Q"]))]
    elif a.get("free_phase") is not None:
        phase_name, n_qubits = a["free_phase"]
        objectives = [UnitaryFreePhaseInfidelityObjective(
            U, phase_name, int(n_qubits), Q=float(a["Q"]), subspace=sub)]
    else:
        objectives = [UnitaryInfidelityObjective(U, Q=float(a["Q"]), subspace=sub)]
    objectives += [QuadraticRegularizer(nm, float(R))
                   for nm, R in zip(derivs, a["R"])]
    constraints = [GlobalPinConstraint(nm, v)
                   for nm, v in dict(a.get("calibration_targets", {})).items()]
    leak = a.get("leakage_indices")
    if leak is not None and a.get("leakage_cost"):
        objectives.append(LeakageObjective(U, leak, Q=float(a["leakage_cost"])))
    if leak is not None and a.get("leakage_value") is not None:
        constraints.append(LeakageConstraint(U, leak, float(a["leakage_value"]),
                                             slack_name=a.get("leakage_slack")))
    nl_cols = [c for n in names if n in (u, "dt")
               for c in range(layout.slices[n].start, layout.slices[n].stop)]
    lin_cols = [c for c in range(layout.z_dim) if c not in nl_cols]
    frozen = {"t": np.asarray(a["t"], float)[..., None]}
    if not dt_free:
        frozen["dt"] = np.asarray(a["dt"], float)[..., None]
    nlp = CollocationNLP(
        N=N, dz=layout.z_dim, dg=layout.g_dim,
        md=sum(i.dim for i in integrators), objectives=objectives,
        integrators=integrators, layout=layout,
        lo=np.asarray(a["lo"], float), hi=np.asarray(a["hi"], float),
        g_lo=a.get("g_lo"), g_hi=a.get("g_hi"),
        eq_groups=[grp for con in constraints for grp in con.eq_rows(N)],
        pin_mask=np.asarray(a["pin_mask"], float),
        nl_cols=nl_cols, lin_cols=lin_cols).to(device, dtype)
    lind = {k: np.asarray(a[k], float) for k in
            ("lind_drift", "lind_drives", "diss_mats", "diss_rates")} if density else {}
    params = params_to({
        "system": RealGeneratorSystem(np.asarray(a["G_drift"], float),
                                      np.asarray(a["G_drives"], float), levels, **lind),
        "goal": {U: goal},
        "frozen": frozen,
        "pin_val": np.asarray(a["pin_val"], float),
    }, device, dtype)
    Z0 = torch.as_tensor(np.asarray(a["Z0"], float)).to(device, dtype)
    g0 = torch.as_tensor(np.asarray(a.get("g0", np.zeros(layout.g_dim)), float))
    return nlp, params, Z0, g0.to(device, dtype), layout

