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
from .control.objectives import (DensityInfidelityObjective, QuadraticRegularizer,
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
    layout = KnotLayout(names, [a["slices"][n][1] - a["slices"][n][0]
                                for n in names])
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
    objectives = [(DensityInfidelityObjective if density
                   else UnitaryInfidelityObjective)(U, Q=float(a["Q"]))]
    objectives += [QuadraticRegularizer(nm, float(R))
                   for nm, R in zip(derivs, a["R"])]
    nl_cols = [c for n in names if n in (u, "dt")
               for c in range(layout.slices[n].start, layout.slices[n].stop)]
    lin_cols = [c for c in range(layout.z_dim) if c not in nl_cols]
    frozen = {"t": np.asarray(a["t"], float)[..., None]}
    if not dt_free:
        frozen["dt"] = np.asarray(a["dt"], float)[..., None]
    nlp = CollocationNLP(
        N=N, dz=layout.z_dim,
        md=sum(i.dim for i in integrators), objectives=objectives,
        integrators=integrators, layout=layout,
        lo=np.asarray(a["lo"], float), hi=np.asarray(a["hi"], float),
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
    return nlp, params, Z0, torch.zeros(0, dtype=dtype, device=device), layout

