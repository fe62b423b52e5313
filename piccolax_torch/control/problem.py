"""Problem assembly: trajectory + objectives + integrators -> NLP -> solve.

`build_nlp` follows `piccolax.control.problem.build_nlp`: box bounds from
the trajectory and its globals, boundary pins as fixed variables (Ipopt
fixed_variable_treatment = make_parameter: the IPM gives them no step and
no barrier, their values come from params["pin_val"]), the constraints'
equality row groups, and the split of the knot columns into the ones
that reach the matrix exponential (drives, timestep) and the ones the
residuals are linear in. `QuantumControlProblem.solve()` runs the batched
IPM on one problem, writes the solution (knots and globals) back into
the trajectory and re-syncs the quantum trajectory (extract the pulse,
roll it out again on the device).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..quantum import isomorphisms as iso
from ..quantum.trajectories import DensityTrajectory, extract_pulse
from ..solver.ipm import IPMOptions, solve_nlp
from ..solver.nlp import CollocationNLP, params_to
from ..trajectory import KnotLayout, Trajectory

__all__ = ["QuantumControlProblem", "build_nlp"]


def _nlp_layout(traj: Trajectory) -> KnotLayout:
    """Layout over the NLP decision components (frozen excluded)."""
    names = [n for n in traj.names if n not in traj.frozen]
    return KnotLayout(names, [traj.dims[n] for n in names], traj.global_names,
                      [traj.global_data[n].shape[0] for n in traj.global_names])


def build_nlp(traj: Trajectory, objectives, integrators, eq_groups=(),
              params=None, device=None, dtype=torch.float64):
    """Assemble a CollocationNLP from trajectory metadata + terms.

    Returns (nlp, params, Z0, g0, layout) with tensors on `device`.
    """
    device = resolve_device(device)
    N = traj.N
    layout = _nlp_layout(traj)
    dz, dg = layout.z_dim, layout.g_dim
    params = dict(params or {})
    params["frozen"] = {n: traj.data[n] for n in traj.frozen}

    lo = np.full((N, dz), -np.inf)
    hi = np.full((N, dz), np.inf)
    for name, sl in layout.slices.items():
        if name in traj.bounds:
            b = np.asarray(traj.bounds[name])
            lo[:, sl] = b[:, 0][None, :]
            hi[:, sl] = b[:, 1][None, :]
    g_lo = np.full(dg, -np.inf)
    g_hi = np.full(dg, np.inf)
    for name, sl in layout.global_slices.items():
        if name in traj.global_bounds:
            b = np.asarray(traj.global_bounds[name])
            g_lo[sl] = b[:, 0]
            g_hi[sl] = b[:, 1]

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
        N=N, dz=dz, dg=dg, md=md, objectives=objectives, integrators=integrators,
        layout=layout, lo=lo, hi=hi, g_lo=g_lo, g_hi=g_hi, eq_groups=eq_groups,
        pin_mask=pin_mask, nl_cols=nl_cols, lin_cols=lin_cols).to(device, dtype)
    params = params_to(params, device, dtype)
    Z0 = torch.as_tensor(np.concatenate(
        [traj.data[n] for n in layout.names], axis=1)).to(device, dtype)
    g0 = torch.as_tensor(np.concatenate(
        [traj.global_data[n] for n in layout.global_names]) if dg
        else np.zeros(0)).to(device, dtype)
    return nlp, params, Z0, g0, layout


def _writeback(traj: Trajectory, layout: KnotLayout, Z, g) -> Trajectory:
    """The trajectory with every NLP component taken from Z [N, dz] and
    every global from g [dg]."""
    Z = Z.detach().to("cpu", torch.float64).numpy()
    g = g.detach().to("cpu", torch.float64).numpy()
    data = dict(traj.data)
    for name, sl in layout.slices.items():
        data[name] = Z[:, sl]
    gd = dict(traj.global_data)
    for name, sl in layout.global_slices.items():
        gd[name] = g[sl]
    return traj._copy(data=data, global_data=gd)


class QuantumControlProblem:
    """A quantum trajectory + the terms of its NLP, with solve/sync
    semantics. Each constraint's setup() extends the trajectory (slack
    components and globals) and its eq_rows() give the NLP's stage
    equalities."""

    def __init__(self, qtraj, traj: Trajectory, objectives, integrators,
                 constraints=(), params=None):
        self.qtraj = qtraj
        self.objectives = list(objectives)
        self.integrators = list(integrators)
        self.constraints = list(constraints)
        for con in self.constraints:
            traj = con.setup(traj)
        self.traj = traj
        self.eq_groups = [grp for con in self.constraints
                          for grp in con.eq_rows(traj.N)]
        self.extra_params = dict(params or {})
        self.result = None

    def build(self, device=None, dtype=torch.float64):
        """Assemble (nlp, params, Z0, g0, layout) on `device`."""
        params = dict(self.extra_params)
        params.setdefault("system", self.qtraj.system)
        params.setdefault("goal", {self.qtraj.state_name: self.qtraj.goal})
        params["system"] = params["system"].solver_view()
        # the goal as the state is encoded: a compact density iso, or an
        # operator iso-vec
        to_iso = iso.density_to_compact_iso if isinstance(self.qtraj, DensityTrajectory) \
            else iso.operator_to_iso_vec
        params["goal"] = {nm: to_iso(np.asarray(v, dtype=np.complex128))
                          for nm, v in params["goal"].items()}
        return build_nlp(self.traj, self.objectives, self.integrators,
                         self.eq_groups, params=params, device=device, dtype=dtype)

    def solve(self, max_iter: int = 150, tol: float = 1e-7, sync: bool = True,
              verbose=True, options: IPMOptions | None = None,
              callback=None, callback_every: int = 1, device=None):
        """Solve the NLP on `device` (the card unless the caller passes
        "cpu") in float64, write the solution back into the trajectory and
        re-sync the quantum trajectory (pulse -> rollout).

        callback: a host function called every callback_every iterations
        with (it, kkt_err, mu, alpha, u [N, n_drives] as numpy, or None
        without a "u" component)."""
        if verbose == "detailed":
            raise NotImplementedError("verbose='detailed'")
        device = resolve_device(device)
        opts = options or IPMOptions(max_iter=max_iter, tol=tol,
                                     constr_viol_tol=tol)
        nlp, params, Z0, g0, layout = self.build(device=device)
        cb = None
        if callback is not None:
            u_sl = layout.slices.get("u")

            def cb(it, kkt, mu, alpha, Z):
                callback(int(it), float(kkt), float(mu), float(alpha),
                         Z[:, u_sl].detach().cpu().numpy() if u_sl else None)
        t0 = time.time()
        state = solve_nlp(nlp, params, Z0, g0, options=opts, callback=cb,
                          callback_every=callback_every, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.time()
        self.result = state
        self.traj = _writeback(self.traj, layout, state.Z, state.g)
        if sync:
            self.sync_trajectory(device=device)
        if verbose:
            status = "stalled-at-floor" if self.stalled \
                else f"converged={self.converged}"
            print(f"[piccolax_torch] IPM: {int(state.it)} iters, "
                  f"kkt={float(state.kkt_err):.2e}, {status}, "
                  f"wall={t1 - t0:.2f}s")
        return self

    def sync_trajectory(self, device=None):
        """Extract the optimized pulse and roll it out again (on `device`,
        default the trajectory's own)."""
        self.qtraj = self.qtraj.rollout(extract_pulse(self.qtraj, self.traj),
                                        device=device)
        return self

    @property
    def pulse(self):
        return self.qtraj.pulse

    def fidelity(self, **kw):
        """Rollout fidelity of the quantum trajectory; a free-phase problem
        evaluates it at its optimized phase globals."""
        pg = getattr(self, "_phase_global", None)
        if pg is not None and "phases" not in kw:
            name, n_qubits = pg
            kw["phases"] = np.asarray(self.traj.global_data[name])
            kw.setdefault("n_qubits", n_qubits)
        return self.qtraj.fidelity(**kw)

    @property
    def converged(self) -> bool:
        """True only if the KKT (or acceptable) test passed."""
        return bool(self.result.converged) if self.result is not None else False

    @property
    def stalled(self) -> bool:
        """True if the solve stopped at the dtype's accuracy floor without
        meeting the KKT tolerance."""
        return bool(self.result.stalled) if self.result is not None else False
