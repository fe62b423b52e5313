"""Problem assembly: trajectory + objectives + integrators -> NLP.

`build_nlp` follows `piccolax.control.problem.build_nlp`: box bounds from
the trajectory, boundary pins as fixed variables (Ipopt
fixed_variable_treatment = make_parameter: the IPM gives them no step and
no barrier, their values come from params["pin_val"]), and the split of
the knot columns into the ones that reach the matrix exponential (drives,
timestep) and the ones the residuals are linear in.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..quantum import isomorphisms as iso
from ..solver.nlp import CollocationNLP, params_to
from ..trajectory import KnotLayout, Trajectory

__all__ = ["QuantumControlProblem", "build_nlp"]


def _nlp_layout(traj: Trajectory) -> KnotLayout:
    """Layout over the NLP decision components (frozen excluded)."""
    names = [n for n in traj.names if n not in traj.frozen]
    return KnotLayout(names, [traj.dims[n] for n in names])


def build_nlp(traj: Trajectory, objectives, integrators, eq_groups=(),
              params=None, device=None, dtype=torch.float64):
    """Assemble a CollocationNLP from trajectory metadata + terms.

    Returns (nlp, params, Z0, g0, layout) with tensors on `device`.
    """
    if tuple(eq_groups):
        raise NotImplementedError("extra equality constraints")
    device = resolve_device(device)
    N = traj.N
    layout = _nlp_layout(traj)
    dz = layout.z_dim
    params = dict(params or {})
    params["frozen"] = {n: traj.data[n] for n in traj.frozen}

    lo = np.full((N, dz), -np.inf)
    hi = np.full((N, dz), np.inf)
    for name, sl in layout.slices.items():
        if name in traj.bounds:
            b = np.asarray(traj.bounds[name])
            lo[:, sl] = b[:, 0][None, :]
            hi[:, sl] = b[:, 1][None, :]

    pin_mask = np.zeros((N, dz))
    pin_val = np.zeros((N, dz))
    for kind, table in (("init", traj.initial), ("fin", traj.final)):
        for name, val in table.items():
            if name in traj.frozen:
                continue
            v = np.asarray(val, dtype=float)
            row = 0 if kind == "init" else N - 1
            fin = np.isfinite(v)
            if not fin.any():
                continue
            sl = layout.slices[name]
            cols = np.arange(sl.start, sl.stop)[fin]
            lo[row, cols] = -np.inf
            hi[row, cols] = np.inf
            pin_mask[row, cols] = 1.0
            pin_val[row, cols] = v[fin]
    params["pin_val"] = pin_val

    md = sum(intg.dim for intg in integrators)
    nl_names = set()
    for intg in integrators:
        if hasattr(intg, "drive_name"):          # expm-bearing integrators
            nl_names.add(intg.drive_name)
            nl_names.add(intg.time_name)
    nl_cols = [c for n in layout.names if n in nl_names
               for c in range(layout.slices[n].start, layout.slices[n].stop)]
    lin_cols = [c for n in layout.names if n not in nl_names
                for c in range(layout.slices[n].start, layout.slices[n].stop)]

    nlp = CollocationNLP(
        N=N, dz=dz, md=md, objectives=objectives, integrators=integrators,
        layout=layout, lo=lo, hi=hi, pin_mask=pin_mask,
        nl_cols=nl_cols, lin_cols=lin_cols).to(device, dtype)
    params = params_to(params, device, dtype)
    Z0 = torch.as_tensor(np.concatenate(
        [traj.data[n] for n in layout.names], axis=1)).to(device, dtype)
    g0 = torch.zeros(0, dtype=dtype, device=device)
    return nlp, params, Z0, g0, layout


class QuantumControlProblem:
    """A quantum trajectory + the terms of its NLP."""

    def __init__(self, qtraj, traj: Trajectory, objectives, integrators,
                 constraints=(), params=None):
        if tuple(constraints):
            raise NotImplementedError("extra constraints")
        self.qtraj = qtraj
        self.traj = traj
        self.objectives = list(objectives)
        self.integrators = list(integrators)
        self.extra_params = dict(params or {})

    def build(self, device=None, dtype=torch.float64):
        """Assemble (nlp, params, Z0, g0, layout) on `device`."""
        params = dict(self.extra_params)
        params.setdefault("system", self.qtraj.system)
        params.setdefault("goal", {self.qtraj.state_name: self.qtraj.goal})
        params["system"] = params["system"].solver_view()
        params["goal"] = {nm: iso.operator_to_iso_vec(
            np.asarray(v, dtype=np.complex128))
            for nm, v in params["goal"].items()}
        return build_nlp(self.traj, self.objectives, self.integrators,
                         params=params, device=device, dtype=dtype)
