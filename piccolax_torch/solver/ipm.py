"""Batched primal-dual interior-point method for collocation NLPs.

The algorithm of `piccolax.solver.ipm` (Fiacco-McCormick barrier, exact
per-knot Lagrangian Hessians, condensed KKT by cyclic reduction, PSD-clamp
direction plus a second-order-corrected step, fraction-to-boundary and a
parallel Armijo search on an augmented-Lagrangian merit), with the
`vmap(while_loop)` of the reference written out as a batch dimension:

- every scalar of the state is a [B] tensor and every max/sum/all over a
  problem reduces over the non-batch dimensions only;
- a problem whose loop condition is false keeps its whole state frozen,
  as a vmapped while_loop selects it;
- the loop ends when every problem is done or max_iter is reached, with
  one host sync per iteration.

The port runs kkt_backend "cr" (condensed KKT by cyclic reduction), "qd"
(the sequential quasidefinite recursion along the knots) or "knot" (the
condensed KKT with its knot axis cut into `mesh` partitions, one problem
at a time) with hess_mode "clamp" or "abs", with the exact-Newton
candidate (newton_dir; on by default in float64) or without it, or
hess_mode "shift" (one factorization of W + delta_w I, delta_w adapted
across iterations, a null step when it fails). Globals (dg > 0) enter
through a bordered Schur complement of dg x dg per problem: dg more
columns through the backend's solve, then a symmetric eigendecomposition
whose |eigenvalues| are floored. kkt_backend "native" raises
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .._device import resolve_device
from ..parallel.sharded_kkt import (check_partitions, knot_condensed_factor,
                                    knot_condensed_solve)
from .kkt import (condensed_factor, condensed_solve, psd_clamp, qd_factor,
                  qd_solve)
from .nlp import (CollocationNLP, batched_leaves, nlp_constraint_residuals,
                  nlp_total_cost, params_to)

__all__ = ["IPMOptions", "IPMState", "solve_nlp", "solve_nlp_traced"]


@dataclasses.dataclass(frozen=True)
class IPMOptions:
    max_iter: int = 100
    tol: float = 1e-8
    constr_viol_tol: float = 1e-8
    mu_init: float = 1e-1
    kappa_eps: float = 10.0
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    tau_min: float = 0.99
    delta_c: float = 1e-8        # constraint-row regularization (f64)
    delta_c_f32: float = 1e-3    # constraint-row regularization (f32)
    hess_floor: float = 1e-6     # clamp eigenvalue floor (f64)
    hess_floor_f32: float = 3e-3  # clamp eigenvalue floor (f32)
    ls_iters: int = 8
    armijo_eta: float = 1e-4
    kappa_sigma: float = 1e10
    bound_push: float = 1e-2
    bound_frac: float = 1e-2
    bound_relax: float = 1e-7
    acceptable_tol: float = 1e-3
    acceptable_obj_change: float = 1e-5
    acceptable_iter: int = 10
    stall_iter: int = 12
    stall_ratio: float = 0.7
    prox_iter: int = 6
    prox_ratio: float = 0.7
    kkt_backend: str = "cr"
    newton_dir: bool | None = None
    hess_mode: str = "clamp"
    clamp_iters: int | None = None
    delta_w_init: float = 1e-3
    delta_w_inc: float = 30.0
    delta_w_dec: float = 0.5
    delta_w_min: float = 1e-8
    delta_w_max: float = 1e10


@dataclasses.dataclass
class IPMState:
    """Solver state; every field has a leading batch dimension [B]."""
    Z: torch.Tensor          # [B, N, dz]
    g: torch.Tensor          # [B, dg]
    lam: torch.Tensor        # [B, N, m]
    lam_ref: torch.Tensor    # [B, N, m]
    zL: torch.Tensor         # [B, N, dz]
    zU: torch.Tensor         # [B, N, dz]
    gL: torch.Tensor         # [B, dg]
    gU: torch.Tensor         # [B, dg]
    mu: torch.Tensor
    nu: torch.Tensor
    it: torch.Tensor
    converged: torch.Tensor
    kkt_err: torch.Tensor
    alpha: torch.Tensor
    delta_used: torch.Tensor
    f_prev: torch.Tensor
    stagnant: torch.Tensor
    kkt_best: torch.Tensor
    kkt_mark: torch.Tensor
    inner_best: torch.Tensor
    inner_mark: torch.Tensor
    inner_count: torch.Tensor
    stall_wins: torch.Tensor
    no_prog: torch.Tensor
    stalled: torch.Tensor
    err_prim: torch.Tensor
    err_dual: torch.Tensor
    delta_w: torch.Tensor    # adaptive inertia shift (hess_mode "shift")

    def select(self, mask, other: "IPMState") -> "IPMState":
        """Per problem: self where mask [B] is true, else other."""
        out = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            out[f.name] = torch.where(mask.view(-1, *([1] * (a.dim() - 1))), a, b)
        return IPMState(**out)

    def index(self, i) -> "IPMState":
        return IPMState(**{f.name: getattr(self, f.name)[i]
                           for f in dataclasses.fields(self)})


def _safe_gap(x, bound, mask):
    """x - bound where the bound is finite (interior-positive), else 1."""
    return torch.where(mask, x - bound, 1.0)


def _init_interior(x, lo, hi, push_abs, push_frac):
    """Push x strictly inside [lo, hi] (Ipopt-style bound_push)."""
    has_lo = torch.isfinite(lo)
    has_hi = torch.isfinite(hi)
    lo_f = torch.where(has_lo, lo, 0.0)
    hi_f = torch.where(has_hi, hi, 0.0)
    width = torch.where(has_lo & has_hi, hi_f - lo_f, math.inf)
    pl = torch.minimum(push_abs * torch.clamp(lo_f.abs(), min=1.0),
                       push_frac * width)
    pu = torch.minimum(push_abs * torch.clamp(hi_f.abs(), min=1.0),
                       push_frac * width)
    x = torch.where(has_lo, torch.maximum(x, lo_f + pl), x)
    x = torch.where(has_hi, torch.minimum(x, hi_f - pu), x)
    return x


def _amax(x, dims=(-2, -1)):
    return torch.amax(x.abs(), dim=dims)


def _derivatives(nlp: CollocationNLP, Z, params, lam, g=None):
    """(grad_z, Cself, Cnext, Hext) of `_kkt_pieces`: the z-only view of
    the KKT pieces that the tests hold against piccolax's `_derivatives`
    (the solver calls `_kkt_pieces`)."""
    gz, _, Cself, Cnext, _, H = _kkt_pieces(nlp, Z, g, params, lam)
    return gz, Cself, Cnext, H


def _kkt_pieces(nlp: CollocationNLP, Z, g, params, lam):
    """(grad_z, grad_g, Cself, Cnext, Jg, Hext) at Z [..., N, dz], g
    [..., dg] for multipliers lam: the cost gradients, the constraint
    Jacobian blocks (rows [eq; dynamics] of knot k vs z_k, vs z_{k+1}
    (zero rows at the last knot) and vs g) and the symmetrised per-knot
    Lagrangian Hessians over (z_k, g). One K4 launch carries every expm."""
    me, dg = nlp.me, nlp.dg
    gz, gg, Hc, E, Fg = nlp.cost_derivatives(Z, params, g, lam[..., :me])
    A, Bn, Hd = nlp.dynamics_derivatives(Z, params, lam[..., :-1, me:])
    zpad = torch.zeros_like(A[..., :1, :, :])
    A = torch.cat([A, zpad], dim=-3)
    Bn = torch.cat([Bn, zpad], dim=-3)
    Hd = torch.cat([Hd, torch.zeros_like(Hd[..., :1, :, :])], dim=-3)
    if dg:
        Hd = torch.nn.functional.pad(Hd, (0, dg, 0, dg))
    H = Hc + Hd
    Jg = A.new_zeros(*A.shape[:-1], dg)
    if me:
        A = torch.cat([E, A], dim=-2)
        Bn = torch.cat([torch.zeros_like(E), Bn], dim=-2)
        Jg = torch.cat([Fg, Jg], dim=-2)
    return gz, gg, A, Bn, Jg, 0.5 * (H + H.mT)


def _knot_backend(B, N, mesh):
    if mesh is None:
        raise ValueError("kkt_backend='knot' needs solve_nlp(..., mesh=...)")
    if B != 1:
        raise ValueError(f"kkt_backend='knot' solves one problem at a time, "
                         f"got a batch of {B}")
    check_partitions(N, mesh)
    return (lambda W, C, reg, Cn: knot_condensed_factor(W, C, reg, Cn, mesh),
            lambda f, C, Cn, r, dz: knot_condensed_solve(f, r, mesh, dz))


# each ported KKT backend: (B, N, mesh) -> (factor, solve), with
# factor(W, Cself, reg, Cn) and solve(factors, Cself, Cn, rhs, dz)
_KKT_BACKENDS = {"cr": lambda B, N, mesh: (condensed_factor, condensed_solve),
                 "qd": lambda B, N, mesh: (qd_factor, qd_solve),
                 "knot": _knot_backend}


def _check_options(o: IPMOptions):
    if o.kkt_backend not in _KKT_BACKENDS:
        raise NotImplementedError(f"kkt_backend={o.kkt_backend!r} (only "
                                  f"{', '.join(map(repr, _KKT_BACKENDS))})")
    if o.hess_mode not in ("clamp", "abs", "shift"):
        raise ValueError(f"hess_mode={o.hess_mode!r}")


def _batched_state(state: IPMState, B, dtype, device) -> IPMState:
    """A state (batched [B, ...] or of one problem) as a batched state on
    device, its floating fields in dtype."""
    out = {}
    for f in dataclasses.fields(IPMState):
        v = torch.as_tensor(getattr(state, f.name)).to(device)
        if v.dim() == _STATE_RANKS[f.name]:
            v = v[None]
        if v.is_floating_point():
            v = v.to(dtype)
        out[f.name] = v.expand(B, *v.shape[1:]).clone() if v.shape[0] != B else v
    return IPMState(**out)


# the rank of each IPMState field of one problem
_STATE_RANKS = {f.name: 0 for f in dataclasses.fields(IPMState)}
_STATE_RANKS.update(Z=2, lam=2, lam_ref=2, zL=2, zU=2, g=1, gL=1, gU=1)


def _eigh_or_nan(S):
    """Eigendecomposition of each symmetric S [B, n, n]; a problem whose
    S is not finite (a failed factorization) gets NaN eigenvalues and the
    others are computed as if it were absent."""
    bad = ~torch.isfinite(S).all(dim=-1).all(dim=-1)
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    ew, EV = torch.linalg.eigh(torch.where(bad[:, None, None], eye, S))
    return torch.where(bad[:, None], math.nan, ew), EV


def _setup(nlp: CollocationNLP, params, Z0, g0, options: IPMOptions,
           mesh=None, resume_from=None):
    """Build (initial state, iteration body) for a batch Z0 [B, N, dz] and
    g0 [B, dg]; mesh is the knot partition count of kkt_backend "knot". A
    params leaf with a leading batch axis (solver/nlp.py) must have B
    entries. resume_from restores a whole state (solver checkpoint) and
    resets only it, converged and stalled."""
    o = options
    B, N, dz = Z0.shape
    for name, b in batched_leaves(params):
        if b != B:
            raise ValueError(f"params leaf {name} has a batch of {b}, "
                             f"Z0 a batch of {B}")
    m, me, dg = nlp.m, nlp.me, nlp.dg
    dtype, dev = Z0.dtype, Z0.device
    kw = dict(dtype=dtype, device=dev)
    is_f32 = dtype == torch.float32
    _check_options(o)
    factor_fn, solve_fn = _KKT_BACKENDS[o.kkt_backend](B, N, mesh)
    shift = o.hess_mode == "shift"
    use_newton = o.newton_dir if o.newton_dir is not None else not is_f32
    delta_c = max(o.delta_c, o.delta_c_f32) if is_f32 else o.delta_c
    hess_floor = max(o.hess_floor, o.hess_floor_f32) if is_f32 else o.hess_floor
    bound_relax = max(o.bound_relax, 1e-4) if is_f32 else o.bound_relax
    clamp_iters = o.clamp_iters if o.clamp_iters is not None \
        else (20 if is_f32 else 32)
    clamp_mode = "abs" if o.hess_mode == "abs" else "pos"
    eps = torch.finfo(dtype).eps
    INF = math.inf

    pinf = nlp.pin_mask                                    # [N, dz] 1 = fixed
    free = 1.0 - pinf
    free_next = torch.cat([free[1:], torch.ones(1, dz, **kw)], dim=0)
    mflat = torch.cat([free, torch.ones(N, dg, **kw)], dim=1)
    hasL = torch.isfinite(nlp.lo) & (pinf < 0.5)
    hasU = torch.isfinite(nlp.hi) & (pinf < 0.5)
    ghasL = torch.isfinite(nlp.g_lo)
    ghasU = torch.isfinite(nlp.g_hi)
    row_act = torch.cat([nlp.eq_mask, torch.cat(
        [torch.ones(N - 1, m - me, **kw), torch.zeros(1, m - me, **kw)])], dim=1)

    def relaxed(lo, hi, hl, hu):
        return (torch.where(hl, lo - bound_relax * torch.clamp(lo.abs(), min=1.0), lo),
                torch.where(hu, hi + bound_relax * torch.clamp(hi.abs(), min=1.0), hi))

    lo, hi = relaxed(nlp.lo, nlp.hi, hasL, hasU)
    g_lo, g_hi = relaxed(nlp.g_lo, nlp.g_hi, ghasL, ghasU)
    nlp = nlp.replace(lo=lo, hi=hi, g_lo=g_lo, g_hi=g_hi)

    Z0 = torch.where(pinf > 0.5, params["pin_val"], Z0)
    Z0 = _init_interior(Z0, lo, hi, o.bound_push, o.bound_frac)
    if g0 is None:
        g0 = torch.zeros(B, dg, **kw)
    g0 = _init_interior(g0, g_lo, g_hi, o.bound_push, o.bound_frac)
    mu0 = torch.full((B,), o.mu_init, **kw)

    def full(v, dt=dtype):
        return torch.full((B,), v, dtype=dt, device=dev)

    state = IPMState(
        Z=Z0, g=g0,
        lam=torch.zeros(B, N, m, **kw), lam_ref=torch.zeros(B, N, m, **kw),
        zL=torch.where(hasL, mu0[:, None, None] / _safe_gap(Z0, lo, hasL), 0.0),
        zU=torch.where(hasU, mu0[:, None, None] / _safe_gap(hi, Z0, hasU), 0.0),
        gL=torch.where(ghasL, mu0[:, None] / _safe_gap(g0, g_lo, ghasL), 0.0),
        gU=torch.where(ghasU, mu0[:, None] / _safe_gap(g_hi, g0, ghasU), 0.0),
        mu=mu0, nu=full(1.0), it=full(0, torch.long),
        converged=full(False, torch.bool), kkt_err=full(INF),
        alpha=full(0.0), delta_used=full(0.0), f_prev=full(INF),
        stagnant=full(0, torch.long), kkt_best=full(INF), kkt_mark=full(INF),
        inner_best=full(INF), inner_mark=full(INF),
        inner_count=full(0, torch.long), stall_wins=full(0, torch.long),
        no_prog=full(0, torch.long), stalled=full(False, torch.bool),
        err_prim=full(INF), err_dual=full(INF), delta_w=full(o.delta_w_init))
    if resume_from is not None:
        state = _batched_state(resume_from, B, dtype, dev)
        state.it = full(0, torch.long)
        state.converged = full(False, torch.bool)
        state.stalled = full(False, torch.bool)

    reg_row = delta_c + (1.0 - row_act)                   # [N, m]
    no_g = torch.zeros(B, 0, **kw)                        # the step of dg = 0 globals
    reg_b = reg_row.expand(B, N, m).contiguous()

    def barrier(Z, g, mu):
        gapL = _safe_gap(Z, lo, hasL)
        gapU = _safe_gap(hi, Z, hasU)
        sL = torch.where(hasL, torch.log(torch.clamp(gapL, min=1e-300)), 0.0)
        sU = torch.where(hasU, torch.log(torch.clamp(gapU, min=1e-300)), 0.0)
        bar = -mu * (sL.sum(dim=(-2, -1)) + sU.sum(dim=(-2, -1)))
        if dg:
            ggL = _safe_gap(g, g_lo, ghasL)
            ggU = _safe_gap(g_hi, g, ghasU)
            bar = bar - mu * (
                torch.where(ghasL, torch.log(torch.clamp(ggL, min=1e-300)), 0.0).sum(-1)
                + torch.where(ghasU, torch.log(torch.clamp(ggU, min=1e-300)), 0.0).sum(-1))
        return bar

    def al_merit(Z, g, lam, lam_ref, mu):
        """Augmented-Lagrangian barrier merit and max |c| over the leading
        dims of Z [..., N, dz] (mu broadcasts against them)."""
        f = nlp_total_cost(nlp, Z, g, params)
        bar = barrier(Z, g, mu)
        c = nlp_constraint_residuals(nlp, Z, g, params)
        ch = c - reg_row * (lam - lam_ref)
        pen = torch.sum((c * c + ch * ch) / (2.0 * reg_row), dim=(-2, -1)) \
            + torch.sum(lam_ref * c, dim=(-2, -1))
        return f + bar + pen, _amax(c)

    c0_init = nlp_constraint_residuals(nlp, Z0, g0, params)
    theta_max = torch.clamp(10.0 * _amax(c0_init), min=1.0)

    def bsum(x):
        return x.sum(dim=(-2, -1))

    def gmax(x):
        """max |x| over the last dim of a [..., dg] tensor."""
        return x.abs().amax(dim=-1)

    def max_step(gap, d, mask, tau):
        """Fraction-to-boundary step per leading index (reduces the last
        two dims); tau broadcasts against the leading dims."""
        t = tau.view(*tau.shape, 1, 1)
        ratio = torch.where(mask & (d < 0),
                            -t * gap / torch.where(d < 0, d, -1.0), INF)
        return torch.clamp(torch.amin(ratio, dim=(-2, -1)), max=1.0)

    def gmax_step(gap, d, mask, tau):
        """max_step of the globals [..., dg]."""
        return max_step(gap[..., None, :], d[..., None, :], mask, tau)

    def shift_add(base, add):
        """base[:, 1:] += add (knot k+1 collects a term of knot k)."""
        return torch.cat([base[:, :1], base[:, 1:] + add], dim=1)

    def body(s: IPMState) -> IPMState:
        Z, g, lam, mu = s.Z, s.g, s.lam, s.mu
        gapL = _safe_gap(Z, lo, hasL)
        gapU = _safe_gap(hi, Z, hasU)
        if dg:
            ggapL = _safe_gap(g, g_lo, ghasL)
            ggapU = _safe_gap(g_hi, g, ghasU)

        grad_z, grad_g, Cself, Cnext, Jg, Hext = _kkt_pieces(nlp, Z, g, params, lam)
        c = nlp_constraint_residuals(nlp, Z, g, params)
        ch = c - reg_row * (lam - s.lam_ref)
        Cself = Cself * free[:, None, :]
        Cnext = Cnext * free_next[:, None, :]

        JTlam = shift_add(torch.einsum("bkmz,bkm->bkz", Cself, lam),
                          torch.einsum("bkmz,bkm->bkz", Cnext[:, :-1], lam[:, :-1]))

        # -- KKT errors / convergence ------------------------------------- #
        r_dual_z = (grad_z + JTlam - torch.where(hasL, s.zL, 0.0)
                    + torch.where(hasU, s.zU, 0.0)) * free
        compL = torch.where(hasL, gapL * s.zL, 0.0)
        compU = torch.where(hasU, gapU * s.zU, 0.0)
        err_dual = _amax(r_dual_z)
        err_prim = _amax(c)
        err_comp0 = torch.maximum(_amax(compL), _amax(compU))
        dual_mass = bsum(lam.abs()) + bsum(s.zL.abs()) + bsum(s.zU.abs())
        grad_max = _amax(grad_z)
        if dg:
            JgTlam = torch.einsum("bkmg,bkm->bg", Jg, lam)
            r_dual_g = grad_g + JgTlam - torch.where(ghasL, s.gL, 0.0) \
                + torch.where(ghasU, s.gU, 0.0)
            gcompL = torch.where(ghasL, ggapL * s.gL, 0.0)
            gcompU = torch.where(ghasU, ggapU * s.gU, 0.0)
            err_dual = torch.maximum(err_dual, gmax(r_dual_g))
            err_comp0 = torch.maximum(err_comp0,
                                      torch.maximum(gmax(gcompL), gmax(gcompU)))
            dual_mass = dual_mass + s.gL.abs().sum(-1) + s.gU.abs().sum(-1)
            grad_max = torch.maximum(grad_max, gmax(grad_g))
        kkt0 = torch.maximum(err_dual, torch.maximum(err_prim, err_comp0))
        n_duals = N * m + 2 * N * dz + 2 * max(dg, 1)
        s_d = torch.clamp(dual_mass / n_duals, min=100.0) / 100.0
        s_g = torch.clamp(grad_max, min=1.0)
        converged = (err_dual / (s_d * s_g) < o.tol) & \
            (err_prim < o.constr_viol_tol) & \
            (err_comp0 / (s_d * s_g) < o.tol)
        f_now = nlp_total_cost(nlp, Z, g, params)
        acc_now = (err_prim < o.constr_viol_tol) & \
            (err_dual / (s_d * s_g) < o.acceptable_tol) & \
            ((f_now - s.f_prev).abs()
             <= o.acceptable_obj_change * torch.clamp(f_now.abs(), min=1.0))
        stagnant = torch.where(acc_now, s.stagnant + 1, 0)
        converged = converged | (stagnant >= o.acceptable_iter)
        kkt_best = torch.minimum(kkt0, s.kkt_best)
        window_done = s.no_prog + 1 >= o.stall_iter
        win_stalled = window_done & (kkt_best > o.stall_ratio * s.kkt_mark)
        stall_wins = torch.where(
            window_done, torch.where(win_stalled, s.stall_wins + 1, 0),
            s.stall_wins)
        stall_now = (stall_wins >= 2) & (mu <= 1e-3) & (kkt0 <= 3.0 * kkt_best)
        kkt_mark = torch.where(window_done, kkt_best, s.kkt_mark)
        no_prog = torch.where(window_done, 0, s.no_prog + 1)
        stalled = s.stalled | (stall_now & ~converged)

        # -- barrier and proximal-reference update -------------------------- #
        mu3 = mu[:, None, None]
        err_comp_mu = torch.maximum(
            _amax(torch.where(hasL, compL - mu3, 0.0)),
            _amax(torch.where(hasU, compU - mu3, 0.0)))
        if dg:
            err_comp_mu = torch.maximum(err_comp_mu, torch.maximum(
                gmax(torch.where(ghasL, gcompL - mu[:, None], 0.0)),
                gmax(torch.where(ghasU, gcompU - mu[:, None], 0.0))))
        err_mu = torch.maximum(err_dual / s_d,
                               torch.maximum(_amax(ch), err_comp_mu / s_d))
        inner_done = err_mu <= o.kappa_eps * mu
        mu = torch.where(
            inner_done,
            torch.clamp(torch.minimum(o.kappa_mu * mu, mu ** o.theta_mu),
                        min=o.tol / 10.0),
            mu)
        mu3 = mu[:, None, None]
        mu2 = mu[:, None]
        inner_best = torch.minimum(err_mu, s.inner_best)
        iwin_done = s.inner_count + 1 >= o.prox_iter
        inner_stalled = iwin_done & (inner_best > o.prox_ratio * s.inner_mark)
        refresh = inner_done | inner_stalled
        lam_ref = torch.where(refresh[:, None, None], lam, s.lam_ref)
        ch = torch.where(refresh[:, None, None], c - reg_row * (lam - lam_ref), ch)
        inner_mark = torch.where(iwin_done, inner_best, s.inner_mark)
        inner_count = torch.where(iwin_done | inner_done, 0, s.inner_count + 1)
        inner_best = torch.where(refresh, INF, inner_best)
        inner_mark = torch.where(refresh, INF, inner_mark)

        # -- KKT matrix blocks --------------------------------------------- #
        Hext = Hext * mflat[:, :, None] * mflat[:, None, :]
        Hzz = Hext[..., :dz, :dz] + torch.diag_embed(pinf)
        SigL = torch.where(hasL, s.zL / gapL, 0.0)
        SigU = torch.where(hasU, s.zU / gapU, 0.0)
        a = (-grad_z - JTlam + torch.where(hasL, mu3 / gapL, 0.0)
             - torch.where(hasU, mu3 / gapU, 0.0)) * free
        b = None
        if dg:
            b = -grad_g - JgTlam + torch.where(ghasL, mu2 / ggapL, 0.0) \
                - torch.where(ghasU, mu2 / ggapU, 0.0)
            Cz = Hext[..., :dz, dz:]                    # [B, N, dz, dg]
            gSig = torch.where(ghasL, s.gL / ggapL, 0.0) + \
                torch.where(ghasU, s.gU / ggapU, 0.0)
            Wg = Hext[..., dz:, dz:].sum(dim=1) + torch.diag_embed(gSig)
            Pblk = torch.cat([Cz, Jg], dim=2).contiguous()   # [B, N, mb, dg]
        Cn = Cnext[:, :-1].contiguous()

        def K_matvec(Wmat, w):                          # w [B, N, mb, r]
            wz, wl = w[:, :, :dz], w[:, :, dz:]
            oz = shift_add(Wmat @ wz + Cself.mT @ wl, Cn.mT @ wl[:, :-1])
            ol = Cself @ wz - reg_row[..., None] * wl
            ol = torch.cat([ol[:, :-1] + Cn @ wz[:, 1:], ol[:, -1:]], dim=1)
            return torch.cat([oz, ol], dim=2)

        def kkt_apply(aux, r):
            """Solve the (z, lam) KKT block for r [B, N, mb, r] with the
            factors; one step of iterative refinement, as the reference
            takes."""
            w = solve_fn(aux["f"], Cself, Cn, r, dz)
            return w + solve_fn(aux["f"], Cself, Cn, r - K_matvec(aux["W"], w), dz)

        def factorize(Wmat):
            """Factors of the KKT with primal block Wmat (NaN where a
            problem's factorization fails); with globals, the bordered
            Schur complement's solved columns and its floored |eigh|."""
            aux = {"W": Wmat, "f": factor_fn(Wmat, Cself, reg_b, Cn)}
            if dg:
                Xcols = kkt_apply(aux, Pblk)            # [B, N, mb, dg]
                S = Wg - torch.einsum("bkpg,bkph->bgh", Pblk, Xcols)
                ew, EV = _eigh_or_nan(0.5 * (S + S.mT))
                scale = torch.clamp(ew.abs().amax(dim=-1), min=1.0)
                floor = math.sqrt(eps) * scale
                aux.update(Xcols=Xcols, EV=EV,
                           ew=torch.maximum(ew.abs(), floor[:, None]))
            return aux

        def kkt_solve(aux, rz, rc, bg):
            """(rz [B,N,dz], rc [B,N,m], bg [B,dg]) -> (dZ, dlam, dgs);
            globals through the bordered Schur complement (dgs the empty
            g0 when dg = 0)."""
            w = kkt_apply(aux, torch.cat([rz, rc], dim=2)[..., None])[..., 0]
            if not dg:
                return w[:, :, :dz], w[:, :, dz:], no_g
            rhs_g = bg - torch.einsum("bkpg,bkp->bg", Pblk, w)
            EV = aux["EV"]
            dgs = torch.einsum("bgh,bh->bg", EV,
                               torch.einsum("bhg,bh->bg", EV, rhs_g) / aux["ew"])
            w = w - torch.einsum("bkpg,bg->bkp", aux["Xcols"], dgs)
            return w[:, :, :dz], w[:, :, dz:], dgs

        def finite(*xs):
            ok = torch.ones(B, dtype=torch.bool, device=dev)
            for x in xs:
                if x.numel():
                    ok = ok & torch.isfinite(x).reshape(B, -1).all(dim=-1)
            return ok

        def keep(ok, *xs):
            return [torch.where(ok.view(-1, *([1] * (x.dim() - 1))), x, 0.0)
                    if x.numel() else x for x in xs]

        def curvature_ok(Wmat, dZ_, dlam_, dgs_):
            """Finite and d^T W d >= 1e-9 ||d||^2 over (dZ, dg), per problem."""
            curv = torch.einsum("bkz,bkzy,bky->b", dZ_, Wmat, dZ_)
            sq = bsum(dZ_ * dZ_)
            if dg:
                curv = curv + torch.einsum("bg,bgh,bh->b", dgs_, Wg, dgs_) \
                    + 2.0 * torch.einsum("bkz,bkzg,bg->b", dZ_, Cz, dgs_)
                sq = sq + (dgs_ * dgs_).sum(-1)
            return finite(dZ_, dlam_, dgs_) & (curv >= 1e-9 * sq)

        diag_sig = torch.diag_embed(SigL + SigU)
        okC = torch.zeros(B, dtype=torch.bool, device=dev)
        okN = okC
        if shift:
            # -- one factorization of W + delta_w I; a null step on failure -- #
            Wsh = Hzz + torch.diag_embed(SigL + SigU + s.delta_w[:, None, None])
            aux = factorize(Wsh.contiguous())
            dZN, dlamN, dgsN = kkt_solve(aux, a, -ch, b)
            okN = finite(dZN, dlamN, dgsN)
            dZN, dlamN, dgsN = keep(okN, dZN, dlamN, dgsN)
            dZb, dlamb, dgsb, okB = dZN, dlamN, dgsN, okN
        else:
            # -- clamp direction C ------------------------------------------- #
            HB = psd_clamp(Hzz.contiguous(), hess_floor, iters=clamp_iters,
                           mode=clamp_mode)
            auxC = factorize(HB + diag_sig)
            dZC, dlamC, dgsC = kkt_solve(auxC, a, -ch, b)
            okC = finite(dZC, dlamC, dgsC)
            dZC, dlamC, dgsC = keep(okC, dZC, dlamC, dgsC)

            # -- exact-Newton direction N on the unclamped Hessian ------------ #
            # kept where the factorization goes through (no NaN from K1 or
            # K7) and the curvature test passes; the SOC rides its factors
            if use_newton:
                Wzz = (Hzz + diag_sig).contiguous()
                aux = factorize(Wzz)
                dZN, dlamN, dgsN = kkt_solve(aux, a, -ch, b)
                okN = curvature_ok(Wzz, dZN, dlamN, dgsN)
                dZN, dlamN, dgsN = keep(okN, dZN, dlamN, dgsN)
                dZb, dlamb, dgsb, okB = dZN, dlamN, dgsN, okN
            else:
                aux, dZb, dlamb, dgsb, okB = auxC, dZC, dlamC, dgsC, okC

        # -- second-order corrected step S ---------------------------------- #
        dzL1 = torch.where(hasL, mu3 / gapL - s.zL - SigL * dZb, 0.0)
        dzU1 = torch.where(hasU, mu3 / gapU - s.zU + SigU * dZb, 0.0)
        a_corr = a - torch.where(hasL, dZb * dzL1 / gapL, 0.0) \
            - torch.where(hasU, dZb * dzU1 / gapU, 0.0)
        b_corr = b
        if dg:
            dgL1 = torch.where(ghasL, mu2 / ggapL - s.gL - (s.gL / ggapL) * dgsb, 0.0)
            dgU1 = torch.where(ghasU, mu2 / ggapU - s.gU + (s.gU / ggapU) * dgsb, 0.0)
            b_corr = b - torch.where(ghasL, dgsb * dgL1 / ggapL, 0.0) \
                - torch.where(ghasU, dgsb * dgU1 / ggapU, 0.0)
        c_soc = nlp_constraint_residuals(nlp, Z + dZb, g + dgsb if dg else g, params)
        ch_soc = c_soc - reg_row * (lam + dlamb - lam_ref)
        JdZ1 = torch.einsum("bkmz,bkz->bkm", Cself, dZb)
        JdZ1 = torch.cat([JdZ1[:, :-1] + torch.einsum(
            "bkmz,bkz->bkm", Cnext[:, :-1], dZb[:, 1:]), JdZ1[:, -1:]], dim=1)
        if dg:
            JdZ1 = JdZ1 + torch.einsum("bkmg,bg->bkm", Jg, dgsb)
        q2 = ch_soc - ch - (JdZ1 - reg_row * dlamb)
        dZS, dlamS, dgsS = kkt_solve(aux, a_corr, -ch - q2, b_corr)
        okS = okB & finite(dZS, dlamS, dgsS)
        dZS, dlamS, dgsS = keep(okS, dZS, dlamS, dgsS)

        # -- AL merit and the parallel Armijo search -------------------------- #
        tau = torch.clamp(1.0 - mu, min=o.tau_min)
        w_pen = lam_ref + (c + ch) / reg_row
        CTw = shift_add(torch.einsum("bkmz,bkm->bkz", Cself, w_pen),
                        torch.einsum("bkmz,bkm->bkz", Cnext[:, :-1], w_pen[:, :-1]))
        gradM_z = grad_z - torch.where(hasL, mu3 / gapL, 0.0) \
            + torch.where(hasU, mu3 / gapU, 0.0) + CTw
        phi0, _ = al_merit(Z, g, lam, lam_ref, mu)

        # candidates with codes 0 (S), 1 (N), 2 (C) or 3 (the null step of
        # "shift"); the last is the fallback when nothing passes
        dirs = [(dZS, dlamS, dgsS, okS, 0.0)]
        if shift or use_newton:
            dirs.append((dZN, dlamN, dgsN, okN, 1.0))
        if shift:
            dirs.append((torch.zeros_like(Z), torch.zeros_like(lam),
                         torch.zeros_like(dgsS), torch.ones_like(okS), 3.0))
        else:
            dirs.append((dZC, dlamC, dgsC, okC, 2.0))
        nd_ = len(dirs)
        codes = torch.tensor([d[4] for d in dirs], **kw)
        dZ2 = torch.stack([d[0] for d in dirs], dim=1)     # [B, nd, N, dz]
        dlam2 = torch.stack([d[1] for d in dirs], dim=1)
        ok_dir = torch.stack([d[3] for d in dirs], dim=1)
        tau2 = tau[:, None].expand(B, nd_)
        ap2 = torch.minimum(max_step(gapL[:, None], dZ2, hasL, tau2),
                            max_step(gapU[:, None], -dZ2, hasU, tau2))
        D2 = bsum(gradM_z[:, None] * dZ2) - bsum(ch[:, None] * dlam2)
        g2 = g
        if dg:
            gradM_g = grad_g - torch.where(ghasL, mu2 / ggapL, 0.0) \
                + torch.where(ghasU, mu2 / ggapU, 0.0) \
                + torch.einsum("bkmg,bkm->bg", Jg, w_pen)
            dgs2 = torch.stack([d[2] for d in dirs], dim=1)    # [B, nd, dg]
            ap2 = torch.minimum(ap2, torch.minimum(
                gmax_step(ggapL[:, None], dgs2, ghasL, tau2),
                gmax_step(ggapU[:, None], -dgs2, ghasU, tau2)))
            D2 = D2 + (gradM_g[:, None] * dgs2).sum(-1)
        D2 = torch.clamp(D2, max=0.0)
        alphas2 = ap2[:, :, None] * (0.5 ** torch.arange(o.ls_iters, **kw))
        al5 = alphas2[..., None, None]                  # [B, nd, L, 1, 1]
        if dg:
            g2 = g[:, None, None] + alphas2[..., None] * dgs2[:, :, None]
        phis2, thetas2 = al_merit(
            Z[:, None, None] + al5 * dZ2[:, :, None], g2,
            lam[:, None, None] + al5 * dlam2[:, :, None],
            lam_ref[:, None, None], mu[:, None, None])
        noise = 10.0 * eps * phi0.abs()
        ok2 = (phis2 <= phi0[:, None, None] + o.armijo_eta * alphas2 * D2[:, :, None]
               + noise[:, None, None]) \
            & torch.isfinite(phis2) & (thetas2 <= theta_max[:, None, None])
        # first accepted step (index 0 when none is)
        lead_rej = (torch.cumsum(ok2.to(torch.int32), dim=-1) == 0).sum(dim=-1)
        idx2 = torch.clamp(lead_rej, max=o.ls_iters - 1)
        any2 = ok2.any(dim=-1)
        idx2 = torch.where(any2, idx2, 0)
        alpha2 = torch.where(any2, alphas2.gather(-1, idx2[..., None])[..., 0],
                             alphas2[..., -1])
        phi2 = torch.where(any2, phis2.gather(-1, idx2[..., None])[..., 0],
                           phis2[..., -1])

        # lowest merit among valid candidates, first index on ties; the
        # fallback if none
        phi3 = torch.where(ok_dir & any2, phi2, INF)
        best = phi3.amin(dim=1, keepdim=True)
        pick = ((phi3 == best).to(torch.int32).cumsum(dim=1) == 0).sum(dim=1)
        pick = torch.where(torch.isinf(best[:, 0]), nd_ - 1, pick)
        rows = torch.arange(B, device=dev)
        delta_used = codes[pick]
        dZ = dZ2[rows, pick] * free
        dlam = dlam2[rows, pick]
        alpha = alpha2[rows, pick]

        # -- bound-dual steps and the dual fraction-to-boundary --------------- #
        dzL = torch.where(hasL, mu3 / gapL - s.zL - SigL * dZ, 0.0)
        dzU = torch.where(hasU, mu3 / gapU - s.zU + SigU * dZ, 0.0)
        alpha_d = torch.minimum(max_step(s.zL, dzL, hasL, tau),
                                max_step(s.zU, dzU, hasU, tau))
        if dg:
            dgs = dgs2[rows, pick]
            dgL = torch.where(ghasL, mu2 / ggapL - s.gL - (s.gL / ggapL) * dgs, 0.0)
            dgU = torch.where(ghasU, mu2 / ggapU - s.gU + (s.gU / ggapU) * dgs, 0.0)
            alpha_d = torch.minimum(alpha_d, torch.minimum(
                gmax_step(s.gL, dgL, ghasL, tau), gmax_step(s.gU, dgU, ghasU, tau)))

        # -- masked update ------------------------------------------------- #
        done = converged | stalled
        step = torch.where(done, 0.0, alpha)[:, None, None]
        dstep = torch.where(done, 0.0, alpha_d)[:, None, None]
        Z_new = Z + step * dZ
        lam_new = lam + step * dlam
        zL_new = s.zL + dstep * dzL
        zU_new = s.zU + dstep * dzU
        gapL_n = _safe_gap(Z_new, lo, hasL)
        gapU_n = _safe_gap(hi, Z_new, hasU)
        zL_new = torch.where(hasL, torch.clamp(
            zL_new, mu3 / (o.kappa_sigma * gapL_n), o.kappa_sigma * mu3 / gapL_n), 0.0)
        zU_new = torch.where(hasU, torch.clamp(
            zU_new, mu3 / (o.kappa_sigma * gapU_n), o.kappa_sigma * mu3 / gapU_n), 0.0)
        g_new, gL_new, gU_new = g, s.gL, s.gU
        if dg:
            g_new = g + step[:, 0] * dgs
            gL_new = s.gL + dstep[:, 0] * dgL
            gU_new = s.gU + dstep[:, 0] * dgU
            ggapL_n = _safe_gap(g_new, g_lo, ghasL)
            ggapU_n = _safe_gap(g_hi, g_new, ghasU)
            gL_new = torch.where(ghasL, torch.clamp(
                gL_new, mu2 / (o.kappa_sigma * ggapL_n), o.kappa_sigma * mu2 / ggapL_n),
                0.0)
            gU_new = torch.where(ghasU, torch.clamp(
                gU_new, mu2 / (o.kappa_sigma * ggapU_n), o.kappa_sigma * mu2 / ggapU_n),
                0.0)
        delta_w = s.delta_w
        if shift:
            delta_w = torch.where(done, s.delta_w, torch.where(
                okB, torch.clamp(s.delta_w * o.delta_w_dec, min=o.delta_w_min),
                torch.clamp(s.delta_w * o.delta_w_inc, max=o.delta_w_max)))

        return IPMState(
            Z=Z_new, g=g_new, lam=lam_new, lam_ref=lam_ref,
            zL=zL_new, zU=zU_new, gL=gL_new, gU=gU_new, mu=mu,
            nu=_amax(lam_ref), it=s.it + 1, converged=converged,
            kkt_err=kkt0, alpha=alpha,
            delta_used=delta_used + 10.0 * okN.to(dtype) + 100.0 * okC.to(dtype),
            f_prev=f_now, stagnant=stagnant,
            kkt_best=kkt_best, kkt_mark=kkt_mark,
            inner_best=inner_best, inner_mark=inner_mark,
            inner_count=inner_count, stall_wins=stall_wins,
            no_prog=no_prog, stalled=stalled,
            err_prim=err_prim, err_dual=err_dual / s_d, delta_w=delta_w)

    return state, body


def _prepare(nlp, params, Z0, g0, device):
    """(nlp, params, Z0 [B, N, dz], g0 [B, dg], single) on device in Z0's
    dtype."""
    device = resolve_device(device)
    Z0 = torch.as_tensor(Z0).to(device)
    dtype = Z0.dtype
    single = Z0.dim() == 2
    if single:
        Z0 = Z0[None]
    B = Z0.shape[0]
    g0 = torch.zeros(B, nlp.dg) if g0 is None else torch.as_tensor(g0)
    g0 = g0.to(device, dtype)
    if g0.shape[-1] != nlp.dg:
        raise ValueError(f"g0 has {g0.shape[-1]} globals, the NLP {nlp.dg}")
    g0 = g0.expand(B, nlp.dg).contiguous()
    return nlp.to(device, dtype), params_to(params, device, dtype), Z0, g0, single


def solve_nlp(nlp: CollocationNLP, params, Z0, g0=None,
              options: IPMOptions = IPMOptions(), callback=None,
              callback_every: int = 1, mesh=None,
              resume_from: IPMState | None = None, device=None) -> IPMState:
    """Solve the collocation NLP for a batch of starting points Z0
    [B, N, dz] (or one [N, dz]) and globals g0 [B, dg] (or [dg]; zeros by
    default) in the dtype of Z0, on `device` (the card unless the caller
    passes "cpu"). nlp and params are moved to that device and dtype;
    params shared by the batch, or with a leading axis of B on any leaf
    for problems that differ in their data (`parallel.mesh.batch_solve`).
    Returns the final IPMState.

    callback: a host function (it, kkt_err, mu, alpha, Z) called after
    every iteration in which a running problem reached a multiple of
    callback_every iterations: it, kkt_err, mu, alpha on the host ([B], or
    scalars for one Z0 [N, dz]), Z on the device. Its values travel with
    the loop's one host read an iteration.

    resume_from: a state (of one problem, or [B]) to continue from, e.g.
    a solver checkpoint (`utils.checkpoint`): every field is restored and
    only it, converged and stalled reset, so 15 + 25 iterations reproduce
    40 bit for bit when Z0 and g0 are the first call's.

    mesh: for kkt_backend "knot", the number P of partitions the knot axis
    is cut into on the one card (piccolax's mesh.shape[knot_axis]); N
    divisible by P with N / P >= 3, and one problem (Z0 [N, dz] or B = 1),
    as piccolax's knot path is not vmappable. Other backends ignore it."""
    nlp, params, Z0, g0, single = _prepare(nlp, params, Z0, g0, device)
    state, body = _setup(nlp, params, Z0, g0, options, mesh=mesh,
                         resume_from=resume_from)

    def running(s):
        return (s.it < options.max_iter) & ~(s.converged | s.stalled)

    active = running(state)
    go = bool(active.any())
    while go:
        state = body(state).select(active, state)
        nxt = running(state)
        if callback is None:
            go = bool(nxt.any())
        else:
            fire = (active & (state.it % callback_every == 0)).any()
            host = torch.cat([torch.stack([nxt.any(), fire]).to(state.mu.dtype),
                              state.it.to(state.mu.dtype), state.kkt_err,
                              state.mu, state.alpha]).cpu()
            go = bool(host[0])
            if bool(host[1]):
                it, kkt, mu, alpha = host[2:].view(4, -1)
                args = (it.long(), kkt, mu, alpha, state.Z)
                callback(*([v[0] for v in args] if single else args))
        active = nxt
    return state.index(0) if single else state


_HISTORY = {"kkt": "kkt_err", "mu": "mu", "alpha": "alpha", "nu": "nu",
            "delta": "delta_used", "f": "f_prev", "err_prim": "err_prim",
            "err_dual": "err_dual", "dw": "delta_w"}


def solve_nlp_traced(nlp: CollocationNLP, params, Z0, g0=None,
                     options: IPMOptions = IPMOptions(), mesh=None, device=None):
    """Like solve_nlp, but runs exactly max_iter iterations (a finished
    problem stays frozen) and returns (state, history): history maps kkt,
    mu, alpha, nu, delta, f, err_prim, err_dual and dw to [max_iter, B]
    tensors ([max_iter] for one Z0 [N, dz]), the state after each
    iteration. No host sync until the caller reads them."""
    nlp, params, Z0, g0, single = _prepare(nlp, params, Z0, g0, device)
    state, body = _setup(nlp, params, Z0, g0, options, mesh=mesh)
    rows = {k: [] for k in _HISTORY}
    for _ in range(options.max_iter):
        state = body(state).select(~(state.converged | state.stalled), state)
        for k, f in _HISTORY.items():
            rows[k].append(getattr(state, f))
    hist = {k: torch.stack(v) for k, v in rows.items()}
    if single:
        return state.index(0), {k: v[:, 0] for k, v in hist.items()}
    return state, hist
