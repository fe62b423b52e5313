"""Collocation NLP specification, batched over leading axes of Z.

    min_{Z, g}  sum_k stage_cost(k, z_k, g)
    s.t.        dynamics(k, z_k, z_{k+1}) = 0   k = 0..N-2
                stage_eq(k, z_k, g) * eq_mask_k = 0
                lo <= Z <= hi   (elementwise, +-inf allowed; pinned entries
                                 are parameters with values params["pin_val"])
                g_lo <= g <= g_hi

Z is [..., N, dz], g the [..., dg] global vector (free phases, slacks of
terminal inequalities). `params` holds the solver view of the system,
the goal iso-vecs, the frozen components (dt) and the pin values. Any of
them may carry a leading batch axis of B for a batch Z [B, ..., N, dz] of
problems that differ in their data (piccolax vmaps over such params): a
batched leaf's first axis is Z's first and it broadcasts over Z's other
leading axes. The dynamics rows are affine in z_{k+1} and read no global;
the stage equalities (`EqRowGroup`s of the constraints) read z_k and g.
The constraint rows of a knot stack as [stage_eq ; dynamics].
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

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
                 pin_mask, nl_cols=None, lin_cols=None, dg=0, g_lo=None,
                 g_hi=None, eq_groups=()):
        self.N, self.dz, self.dg, self.md = int(N), int(dz), int(dg), int(md)
        self.objectives = list(objectives)
        self.integrators = list(integrators)
        self.layout = layout
        self.eq_groups = list(eq_groups)
        self.me = sum(int(grp.dim) for grp in self.eq_groups)
        self.lo = torch.as_tensor(np.array(lo, dtype=float))
        self.hi = torch.as_tensor(np.array(hi, dtype=float))
        self.g_lo = torch.as_tensor(np.full(self.dg, -np.inf) if g_lo is None
                                    else np.array(g_lo, dtype=float).reshape(self.dg))
        self.g_hi = torch.as_tensor(np.full(self.dg, np.inf) if g_hi is None
                                    else np.array(g_hi, dtype=float).reshape(self.dg))
        self.eq_mask = torch.as_tensor(np.concatenate(
            [np.asarray(grp.mask, dtype=float).reshape(self.N, grp.dim)
             for grp in self.eq_groups], axis=1) if self.me else np.zeros((self.N, 0)))
        self.pin_mask = torch.as_tensor(np.array(pin_mask, dtype=float))
        self.nl_cols = tuple(nl_cols) if nl_cols is not None else None
        self.lin_cols = tuple(lin_cols) if lin_cols is not None else None
        self._marks_cache = {}

    @property
    def m(self) -> int:
        return self.me + self.md

    def replace(self, **changes) -> "CollocationNLP":
        new = object.__new__(CollocationNLP)
        new.__dict__.update(self.__dict__)
        new.__dict__.update(changes)
        return new

    def to(self, device=None, dtype=None) -> "CollocationNLP":
        return self.replace(**{k: getattr(self, k).to(device, dtype) for k in
                               ("lo", "hi", "g_lo", "g_hi", "eq_mask", "pin_mask")})

    # -- views ---------------------------------------------------------------

    def _getter(self, Zk, params, knots: slice):
        sl = self.layout.slices

        def get(name):
            if name in sl:
                return Zk[..., sl[name]]
            v = batch_view(params["frozen"][name], 2, Zk.dim() - 2)
            return v[..., knots, :]
        return get

    def _gview(self, G):
        """name -> the columns of global `name` in G [..., dg]."""
        return lambda name: self.layout.gview(G, name)

    def _knots_g(self, Z, g):
        """g [..., dg] broadcast to every knot of Z [..., N, dz] (None
        without globals: no objective reads them then)."""
        if g is None or not self.dg:
            return None
        return g[..., None, :].expand(*Z.shape[:-1], self.dg)

    def _knot_cost(self, z, G, term, first, params, k):
        get, gview = self._getter(z, params, k), self._gview(G)
        total = 0.0
        for obj in self.objectives:
            total = total + obj.knot_cost(get, term, params, gview=gview, first=first)
        return total

    def _knot_eq(self, z, G, mask, params, k):
        get, gview = self._getter(z, params, k), self._gview(G)
        e = torch.cat([grp.fn(get, gview, params) for grp in self.eq_groups], dim=-1)
        return e * mask

    def _marks(self, Z):
        """(term, first): 1.0 at the last knot and at the first, [N], made
        once a device and dtype."""
        key = (Z.device, Z.dtype)
        if key not in self._marks_cache:
            marks = torch.zeros(2, self.N, dtype=Z.dtype, device=Z.device)
            marks[0, -1] = 1.0
            marks[1, 0] = 1.0
            self._marks_cache[key] = (marks[0], marks[1])
        return self._marks_cache[key]

    def stage_costs(self, Z, params, g=None):
        """[..., N] per-knot costs."""
        term, first = self._marks(Z)
        return self._knot_cost(Z, self._knots_g(Z, g), term, first, params,
                               slice(None))

    def stage_eq(self, Z, g, params):
        """[..., N, me] stage-equality rows, masked by eq_mask."""
        if not self.me:
            return Z[..., :0]
        return self._knot_eq(Z, self._knots_g(Z, g), self.eq_mask, params,
                             slice(None))

    def dynamics(self, Z, params):
        """[..., N-1, md] dynamics rows."""
        N = self.N
        get = self._getter(Z[..., :-1, :], params, slice(0, N - 1))
        getp = self._getter(Z[..., 1:, :], params, slice(1, N))
        return torch.cat([intg.residual(get, getp, params)
                          for intg in self.integrators], dim=-1)

    def cost_derivatives(self, Z, params, g=None, lam_e=None):
        """Derivatives over w_k = (z_k, g) of the stage costs, by torch.func
        over the knots (objectives and equality rows reach no kernel):
        (gradient in z [..., N, dz], gradient in g summed over the knots
        [..., dg], Hessian of cost_k + lam_e_k . eq_k [..., N, dz+dg,
        dz+dg], Jacobians of the masked equality rows in z [..., N, me,
        dz] and in g [..., N, me, dg], None without rows). Each of the
        flattened knots carries its own problem's goal."""
        lead, N, dz, dg, me = Z.shape[:-2], self.N, self.dz, self.dg, self.me
        K = int(np.prod(lead, dtype=int)) * N
        term, first = (v.expand(*lead, N).reshape(-1) for v in self._marks(Z))
        W = torch.cat([Z, self._knots_g(Z, g)], dim=-1).reshape(K, dz + dg) if dg \
            else Z.reshape(K, dz)
        goal = {n: batch_view(v, 1, len(lead) + 1)
                .expand(*lead, N, v.shape[-1]).reshape(K, v.shape[-1])
                for n, v in params["goal"].items()}

        def split(w):                       # (z_k, g); w is z_k alone when dg = 0
            return (w[:dz], w[dz:]) if dg else (w, None)

        def cost(w, t, f0, goal):
            return self._knot_cost(*split(w), t, f0, {**params, "goal": goal},
                                   slice(None))

        def eq(w, msk, goal):
            return self._knot_eq(*split(w), msk, {**params, "goal": goal},
                                 slice(None))

        gw = vmap(grad(cost))(W, term, first, goal)
        if dg:
            gz = gw[:, :dz].reshape(Z.shape)
            gg = gw[:, dz:].reshape(*lead, N, dg).sum(dim=-2)
        else:
            gz, gg = gw.reshape(Z.shape), gw.new_zeros(*lead, 0)
        if me:
            le = lam_e.reshape(K, me)
            mask = self.eq_mask.expand(*lead, N, me).reshape(K, me)

            def lagr(w, t, f0, msk, le, goal):
                return cost(w, t, f0, goal) + torch.sum(le * eq(w, msk, goal))

            H = vmap(hessian(lagr))(W, term, first, mask, le, goal)
            J = vmap(jacfwd(eq))(W, mask, goal).reshape(*lead, N, me, dz + dg)
            E, F = J[..., :dz], J[..., dz:]
        else:
            H = vmap(hessian(cost))(W, term, first, goal)
            E = F = None
        return gz, gg, H.reshape(*lead, N, dz + dg, dz + dg), E, F

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
    return torch.sum(nlp.stage_costs(Z, params, g), dim=-1)


def nlp_constraint_residuals(nlp: CollocationNLP, Z, g, params):
    """[..., N, m] residuals [stage_eq * mask ; dynamics]; the dynamics
    rows of the last knot are zero."""
    d = nlp.dynamics(Z, params)
    d = torch.cat([d, torch.zeros_like(d[..., :1, :])], dim=-2)
    if not nlp.me:
        return d
    return torch.cat([nlp.stage_eq(Z, g, params), d], dim=-1)


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
