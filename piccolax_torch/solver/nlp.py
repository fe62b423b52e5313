"""Collocation NLP specification, batched over leading axes of Z.

    min_Z   sum_k stage_cost(k, z_k)
    s.t.    dynamics(k, z_k, z_{k+1}) = 0   k = 0..N-2
            lo <= Z <= hi   (elementwise, +-inf allowed; pinned entries
                             are parameters with values params["pin_val"])

Z is [..., N, dz]. `params` holds the solver view of the system, the goal
iso-vecs, the frozen components (dt) and the pin values. Any of them may
carry a leading batch axis of B for a batch Z [B, ..., N, dz] of problems
that differ in their data (piccolax vmaps over such params): a batched
leaf's first axis is Z's first and it broadcasts over Z's other leading
axes. The dynamics rows are affine in z_{k+1}. This slice has no stage
equalities (me = 0) and no globals (dg = 0).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, hessian, vmap

__all__ = ["CollocationNLP", "nlp_total_cost", "nlp_constraint_residuals",
           "params_to", "batch_view", "batched_leaves"]

# the rank of each params leaf of one problem; a batched leaf has one more
_RANKS = {"goal": 1, "frozen": 2, "pin_val": 2}


def batch_view(v, rank: int, n_lead: int):
    """A params leaf of `rank` dims as it is, or a batched one [B, ...]
    viewed to broadcast against n_lead leading axes, the first of which
    is the batch."""
    if v.dim() == rank:
        return v
    return v.reshape(v.shape[0], *([1] * (n_lead - 1)), *v.shape[1:])


def batched_leaves(params):
    """(name, leading size) of every params leaf that carries a batch axis."""
    out = []
    for key, rank in _RANKS.items():
        v = params.get(key)
        leaves = v.items() if isinstance(v, dict) else [(key, v)]
        out += [(f"{key}/{n}" if isinstance(v, dict) else n, a.shape[0])
                for n, a in leaves if a is not None and a.dim() > rank]
    system = params.get("system")
    for key in ("G_drift", "lind_drift"):
        v = getattr(system, key, None)
        if v is not None and v.dim() > 2:
            out.append((f"system/{key}", v.shape[0]))
    return out


class CollocationNLP:
    def __init__(self, *, N, dz, md, objectives, integrators, layout, lo, hi,
                 pin_mask, nl_cols=None, lin_cols=None, dg=0, me=0):
        if dg or me:
            raise NotImplementedError("globals (dg > 0) and stage equalities")
        self.N, self.dz, self.dg, self.md, self.me = int(N), int(dz), 0, int(md), 0
        self.objectives = list(objectives)
        self.integrators = list(integrators)
        self.layout = layout
        self.lo = torch.as_tensor(np.array(lo, dtype=float))
        self.hi = torch.as_tensor(np.array(hi, dtype=float))
        self.pin_mask = torch.as_tensor(np.array(pin_mask, dtype=float))
        self.nl_cols = tuple(nl_cols) if nl_cols is not None else None
        self.lin_cols = tuple(lin_cols) if lin_cols is not None else None

    @property
    def m(self) -> int:
        return self.me + self.md

    def replace(self, **changes) -> "CollocationNLP":
        new = object.__new__(CollocationNLP)
        new.__dict__.update(self.__dict__)
        new.__dict__.update(changes)
        return new

    def to(self, device=None, dtype=None) -> "CollocationNLP":
        return self.replace(lo=self.lo.to(device, dtype),
                            hi=self.hi.to(device, dtype),
                            pin_mask=self.pin_mask.to(device, dtype))

    # -- views ---------------------------------------------------------------

    def _getter(self, Zk, params, knots: slice):
        sl = self.layout.slices

        def get(name):
            if name in sl:
                return Zk[..., sl[name]]
            v = batch_view(params["frozen"][name], 2, Zk.dim() - 2)
            return v[..., knots, :]
        return get

    def _knot_cost(self, z, term, params, k):
        get = self._getter(z, params, k)
        total = 0.0
        for obj in self.objectives:
            total = total + obj.knot_cost(get, term, params)
        return total

    def _terminal(self, Z):
        term = torch.zeros(self.N, dtype=Z.dtype, device=Z.device)
        term[-1] = 1.0
        return term

    def stage_costs(self, Z, params):
        """[..., N] per-knot costs."""
        return self._knot_cost(Z, self._terminal(Z), params, slice(None))

    def dynamics(self, Z, params):
        """[..., N-1, md] dynamics rows."""
        N = self.N
        get = self._getter(Z[..., :-1, :], params, slice(0, N - 1))
        getp = self._getter(Z[..., 1:, :], params, slice(1, N))
        return torch.cat([intg.residual(get, getp, params)
                          for intg in self.integrators], dim=-1)

    def cost_derivatives(self, Z, params):
        """(gradient [..., N, dz], Hessian [..., N, dz, dz]) of the stage
        costs, by torch.func over the knots (objectives reach no kernel).
        Each of the flattened knots carries its own problem's goal."""
        lead = Z.shape[:-2]
        term = self._terminal(Z).expand(*lead, self.N).reshape(-1)
        Zf = Z.reshape(-1, self.dz)
        goal = {n: batch_view(v, 1, len(lead) + 1)
                .expand(*lead, self.N, v.shape[-1]).reshape(-1, v.shape[-1])
                for n, v in params["goal"].items()}

        def f(z, t, goal):
            return self._knot_cost(z, t, {**params, "goal": goal}, slice(None))

        g = vmap(grad(f))(Zf, term, goal).reshape(Z.shape)
        H = vmap(hessian(f))(Zf, term, goal).reshape(*Z.shape, self.dz)
        return g, H

    def dynamics_derivatives(self, Z, params, lam_d):
        """(A [..., N-1, md, dz], Bn [..., N-1, md, dz], H [..., N-1, dz, dz]):
        Jacobians in z_k and z_{k+1}, and the Hessian of lam_d . rows in z_k."""
        N = self.N
        get = self._getter(Z[..., :-1, :], params, slice(0, N - 1))
        getp = self._getter(Z[..., 1:, :], params, slice(1, N))
        A, Bn, H, off = [], [], 0, 0
        for intg in self.integrators:
            Js, Jn, Hi = intg.derivatives(get, getp, params,
                                          lam_d[..., off:off + intg.dim],
                                          self.layout)
            A.append(Js)
            Bn.append(Jn)
            H = H + Hi
            off += intg.dim
        return torch.cat(A, dim=-2), torch.cat(Bn, dim=-2), H


def nlp_total_cost(nlp: CollocationNLP, Z, g, params):
    return torch.sum(nlp.stage_costs(Z, params), dim=-1)


def nlp_constraint_residuals(nlp: CollocationNLP, Z, g, params):
    """[..., N, m] residuals; the dynamics rows of the last knot are zero."""
    d = nlp.dynamics(Z, params)
    return torch.cat([d, torch.zeros_like(d[..., :1, :])], dim=-2)


def params_to(params, device=None, dtype=None):
    """A copy of the solver params with every tensor on device/dtype."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = {n: torch.as_tensor(a).to(device, dtype)
                      for n, a in v.items()}
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            out[k] = torch.as_tensor(v).to(device, dtype)
        else:
            out[k] = v.to(device, dtype)
    return out
