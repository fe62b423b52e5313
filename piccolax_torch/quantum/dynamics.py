"""Fidelities, and the zero-order-hold unitary and density (Lindblad)
rollouts of `piccolax.quantum.dynamics`.

The rollouts run on the device: one Pade-13 expm (kernel K5) per fine
interval, all intervals of all pulses in one launch, then a log-depth
scan of small products. The density rollout takes the expm of the
complex n^2 x n^2 Lindblad superoperator (non-normal: dissipation makes
it so). Every rollout function takes pulses with leading batch axes
(values [..., K, d], times [..., K]): the port's written-out `vmap` over
pulses.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..ops.expm import expm
from . import isomorphisms as iso
from .operators import EmbeddedOperator
from .pulses import _SNAP_TOL, ZeroOrderPulse

__all__ = ["unitary_fidelity", "pedersen_fidelity", "density_fidelity",
           "iso_vec_inner", "unitary_fidelity_iso", "pedersen_fidelity_iso",
           "density_fidelity_iso", "unitary_fidelity_iso_bounded",
           "pedersen_fidelity_iso_bounded", "step_propagators", "unitary_rollout",
           "unitary_rollout_fidelity", "liouvillian", "lindblad_propagators",
           "density_rollout", "free_phase_angles", "free_phase_diagonal",
           "free_phase_angles_levels"]


def unitary_fidelity(U, U_goal, subspace=None):
    """|tr(U' U_goal)|^2 / n^2 (batched over leading axes) of complex
    tensors, optionally restricted to a subspace; U_goal may be an array,
    moved to U's device."""
    U = torch.as_tensor(U)
    U_goal = torch.as_tensor(U_goal).to(U.device, U.dtype)
    if subspace is not None:
        sub = torch.as_tensor(np.asarray(subspace), device=U.device)
        U = U[..., sub[:, None], sub[None, :]]
        U_goal = U_goal[..., sub[:, None], sub[None, :]]
    n = U.shape[-1]
    tr = torch.einsum("...ij,...ij->...", torch.conj(U), U_goal)
    return torch.abs(tr) ** 2 / n ** 2


def pedersen_fidelity(U_sub, U_goal_sub):
    """Pedersen average-gate fidelity on a subspace (handles leakage):

        F = (tr(M' M) + |tr M|^2) / (n (n + 1)),  M = U_goal' U_sub

    of complex tensors batched over leading axes; U_goal_sub may be an
    array, moved to U_sub's device."""
    U_sub = torch.as_tensor(U_sub)
    U_goal_sub = torch.as_tensor(U_goal_sub).to(U_sub.device, U_sub.dtype)
    n = U_sub.shape[-1]
    M = U_goal_sub.mH @ U_sub
    t1 = torch.abs(torch.einsum("...ij,...ij->...", torch.conj(M), M))
    t2 = torch.abs(torch.einsum("...ii->...", M)) ** 2
    return (t1 + t2) / (n * (n + 1))


def density_fidelity(rho, rho_goal):
    """Trace fidelity tr(rho @ rho_goal) (real, batched over leading axes)
    of a complex tensor rho; rho_goal may be an array, moved to rho's
    device."""
    rho = torch.as_tensor(rho)
    rho_goal = torch.as_tensor(rho_goal).to(rho.device, rho.dtype)
    return torch.einsum("...ij,...ji->...", rho, rho_goal).real


def density_fidelity_iso(x_compact, goal_compact):
    """The plain dot of two compact density isos, as piccolax computes it.
    The compact iso carries no sqrt(2) on its off-diagonal entries, so
    this is tr(rho rho_goal) only for a diagonal goal (piccolax's
    docstring says the iso is sqrt(2)-scaled; its code does not scale)."""
    return torch.sum(x_compact * goal_compact, dim=-1)


def free_phase_angles(phases, n_qubits: int, dim: int):
    """Per-entry total free phase [..., dim] of phases [..., n_qubits]:
    entry i sums the phases of the qubits in |1> in the binary
    decomposition of i (MSB = qubit 0)."""
    phases = torch.as_tensor(phases)
    i = torch.arange(dim, device=phases.device)
    total = torch.zeros(*phases.shape[:-1], dim, dtype=phases.dtype,
                        device=phases.device)
    for j in range(n_qubits):
        bit = ((i >> (n_qubits - 1 - j)) & 1).to(phases.dtype)
        total = total + bit * phases[..., j:j + 1]
    return total


def free_phase_diagonal(phases, n_qubits: int, dim: int):
    """exp(i free_phase_angles) [..., dim], complex."""
    ang = free_phase_angles(phases, n_qubits, dim)
    return torch.polar(torch.ones_like(ang), ang)


def free_phase_angles_levels(phases, subsystem_levels, dim: int):
    """Number-operator free phases over subsystem levels [..., dim]: basis
    index i decomposes row-major into per-subsystem level indices s_j and
    the total phase is sum_j s_j phases[j] (free_phase_angles when every
    level is 2)."""
    phases = torch.as_tensor(phases)
    i = torch.arange(dim, device=phases.device)
    total = torch.zeros(*phases.shape[:-1], dim, dtype=phases.dtype,
                        device=phases.device)
    rem = i
    levels = tuple(int(v) for v in subsystem_levels)
    for j, lv in enumerate(levels):
        stride = int(np.prod(levels[j + 1:], dtype=int))
        sj = torch.clamp(rem // stride, max=lv - 1).to(phases.dtype)
        rem = rem % stride
        total = total + sj * phases[..., j:j + 1]
    return total


def iso_vec_inner(x, y):
    """tr(X^dag Y) of two operator iso-vecs (..., 2n^2) -> (re, im)."""
    n = int(round(np.sqrt(x.shape[-1] // 2)))
    xc = x.reshape(*x.shape[:-1], n, 2 * n)
    yc = y.reshape(*y.shape[:-1], n, 2 * n)
    xR, xI = xc[..., :n], xc[..., n:]
    yR, yI = yc[..., :n], yc[..., n:]
    re = torch.sum(xR * yR + xI * yI, dim=-1)
    im = torch.sum(xR * yI - xI * yR, dim=-1)
    return torch.sum(re, dim=-1), torch.sum(im, dim=-1)


def unitary_fidelity_iso(x_iso, goal_iso):
    """|tr(U^dag U_goal)|^2 / n^2 from operator iso-vecs."""
    n = int(round(np.sqrt(x_iso.shape[-1] // 2)))
    re, im = iso_vec_inner(x_iso, goal_iso)
    return (re ** 2 + im ** 2) / n ** 2


def pedersen_fidelity_iso(x_sub_iso, goal_sub_iso):
    """Pedersen subspace fidelity from iso-vecs of the subspace blocks:
    (tr(M^dag M) + |tr M|^2) / (m (m + 1)), M = U_goal^dag U_sub, with
    tr(M^dag M) = ||U_sub||_F^2 (the goal's block is unitary)."""
    m = int(round(np.sqrt(x_sub_iso.shape[-1] // 2)))
    t1 = torch.sum(x_sub_iso ** 2, dim=-1)
    re, im = iso_vec_inner(goal_sub_iso, x_sub_iso)
    return (t1 + re ** 2 + im ** 2) / (m * (m + 1))


def pedersen_fidelity_iso_bounded(x_sub_iso, goal_sub_iso, x_full_iso):
    """`pedersen_fidelity_iso` scaled by n_full / ||U_full||_F^2: equal on
    the unitary manifold and bounded by n_full / n_sub off it (the NLP
    objective of an embedded goal)."""
    n_full = int(round(np.sqrt(x_full_iso.shape[-1] // 2)))
    nrm2 = torch.clamp(torch.sum(x_full_iso ** 2, dim=-1), min=1e-12)
    return pedersen_fidelity_iso(x_sub_iso, goal_sub_iso) * n_full / nrm2


def unitary_fidelity_iso_bounded(x_iso, goal_iso):
    """|tr(U^dag Ug)|^2 / (n ||U||_F^2): equals `unitary_fidelity_iso` on
    the unitary manifold and is bounded by 1 off it (the NLP objective)."""
    n = int(round(np.sqrt(x_iso.shape[-1] // 2)))
    re, im = iso_vec_inner(x_iso, goal_iso)
    nrm2 = torch.clamp(torch.sum(x_iso ** 2, dim=-1), min=1e-12)
    return (re ** 2 + im ** 2) / (n * nrm2)


# --------------------------------------------------------------------------- #
# Propagators and the rollout
# --------------------------------------------------------------------------- #


def _zoh_controls(values, ptimes, t):
    """ZOH pulse samples at times t [..., M]: values[k] with
    times[k] <= t < times[k+1] (knot-snapped, clipped to the knots), for
    values [..., K, d] and ptimes [..., K] broadcasting against t."""
    lead = t.shape[:-1]
    K, d = values.shape[-2:]
    ptimes = ptimes.expand(*lead, K).contiguous()
    idx = torch.searchsorted(ptimes, (t + _SNAP_TOL).contiguous(), right=True) - 1
    idx = torch.clamp(idx, 0, K - 1)
    return torch.gather(values.expand(*lead, K, d), -2,
                        idx[..., None].expand(*idx.shape, d))


def _zoh_propagator(system, u, h):
    """Exact step for piecewise-constant H: expm(-i H(u) h), one K5 launch
    for every u [..., d] and h [...]."""
    Hm = system.H(u)
    return expm(((-1j * h)[..., None, None] * Hm).contiguous())


def _substep_grid(times, n_substeps: int):
    """Refine knot times [..., K] into n_substeps per interval ->
    [..., (K-1) * S + 1]."""
    if n_substeps == 1:
        return times
    frac = torch.arange(n_substeps, dtype=times.dtype,
                        device=times.device) / n_substeps
    t0 = times[..., :-1]
    dt = times[..., 1:] - times[..., :-1]
    fine = (t0[..., None] + frac * dt[..., None]).reshape(*times.shape[:-1], -1)
    return torch.cat([fine, times[..., -1:]], dim=-1)


def _pulse_tensors(pulse, device):
    """(values [..., K, d], times [..., K]) of a ZOH pulse as float tensors."""
    if not isinstance(pulse, ZeroOrderPulse):
        raise NotImplementedError("only ZeroOrderPulse rollouts are ported")
    return (torch.as_tensor(pulse.values).to(device),
            torch.as_tensor(pulse.times).to(device))


def step_propagators(system, pulse, times, method: str = "zoh",
                     n_substeps: int = 1, device=None):
    """Per-interval propagators over a (refined) time grid.

    Returns (grid [..., M+1], propagators [..., M, n, n]).
    """
    if method != "zoh":
        raise NotImplementedError(f"rollout method {method!r} (only 'zoh')")
    device = resolve_device(device)
    values, ptimes = _pulse_tensors(pulse, device)
    grid = _substep_grid(torch.as_tensor(times, dtype=ptimes.dtype).to(device),
                         n_substeps)
    ta = grid[..., :-1]
    u = _zoh_controls(values, ptimes, ta)
    return grid, _zoh_propagator(system, u, grid[..., 1:] - ta)


def _cumulative_propagators(props):
    """P_k = U_k @ ... @ U_0 over axis -3 by a log-depth inclusive scan
    (later factors on the left, as associative_scan(lambda a, b: b @ a))."""
    P = props
    d = 1
    while d < P.shape[-3]:
        P = torch.cat([P[..., :d, :, :], P[..., d:, :, :] @ P[..., :-d, :, :]],
                      dim=-3)
        d *= 2
    return P


def unitary_rollout(system, pulse, times, method: str | None = None,
                    n_substeps: int = 1, device=None):
    """Propagate U(0) = I through the pulse; returns U at each knot time
    [..., N, n, n] (complex, on `device`: the card unless the caller
    passes "cpu")."""
    # a ZOH pulse on an autonomous system (the port's only kind) is "zoh"
    _, props = step_propagators(system, pulse, times, method or "zoh",
                                n_substeps, device)
    cum = _cumulative_propagators(props)
    n = system.levels
    U0 = torch.eye(n, dtype=props.dtype, device=props.device)
    Us = torch.cat([U0.expand(*cum.shape[:-3], 1, n, n), cum], dim=-3)
    return Us if n_substeps == 1 else Us[..., ::n_substeps, :, :]


def liouvillian(system, u=None):
    """Complex Lindblad superoperator S [..., n^2, n^2] with d vec(rho)/dt
    = S vec(rho) (column-major vec) at controls u [..., n_drives]: the
    commutator with H(u) and each dissipator of `system` (none for a
    closed system), on u's device."""
    Hm = system.H(u)
    S = -1j * iso.ad_vec(Hm)
    for d in getattr(system, "dissipators", ()):
        S = S + torch.as_tensor(iso.dissipator(d.operator(u))).to(S)
    return S


def _lindblad_generators(system, pulse, times, n_substeps: int, device):
    """(grid [..., M+1], h S(u(t_mid)) [..., M, n^2, n^2]): the inputs of
    `lindblad_propagators`' expm, the controls sampled at each substep's
    midpoint."""
    values, ptimes = _pulse_tensors(pulse, resolve_device(device))
    grid = _substep_grid(torch.as_tensor(times, dtype=ptimes.dtype).to(ptimes.device),
                         n_substeps)
    ta, tb = grid[..., :-1], grid[..., 1:]
    u = _zoh_controls(values, ptimes, 0.5 * (ta + tb))
    return grid, ((tb - ta)[..., None, None] * liouvillian(system, u)).contiguous()


def lindblad_propagators(system, pulse, times, n_substeps: int = 1, device=None):
    """Per-interval superoperator propagators expm(h S(u(t_mid))) on the
    refined grid, the controls sampled at each substep's midpoint (second
    order a substep), all in one K5 launch.

    Returns (grid [..., M+1], propagators [..., M, n^2, n^2])."""
    grid, hS = _lindblad_generators(system, pulse, times, n_substeps, device)
    return grid, expm(hS)


def density_rollout(system, pulse, times, initial, n_substeps: int = 4,
                    device=None):
    """Propagate the density matrix `initial` [n, n] through the Lindblad
    master equation; returns rho at each knot time [..., N, n, n]
    (complex, on `device`: the card unless the caller passes "cpu")."""
    _, props = lindblad_propagators(system, pulse, times, n_substeps, device)
    cum = _cumulative_propagators(props)
    n = system.levels
    rho0 = torch.as_tensor(np.asarray(initial)).to(props.device, props.dtype)
    v0 = rho0.mT.reshape(-1)                          # column-major vec
    vs = cum @ v0
    rhos = vs.reshape(*vs.shape[:-1], n, n).mT
    rhos = torch.cat([rho0.expand(*rhos.shape[:-3], 1, n, n), rhos], dim=-3)
    return rhos if n_substeps == 1 else rhos[..., ::n_substeps, :, :]


def unitary_rollout_fidelity(system, us, times, goal,
                             interpolation: str = "cubic", dus=None,
                             n_substeps: int = 10, phases=None,
                             n_qubits=None, device=None):
    """Re-integrate the dynamics under a ZOH interpolation of the knot
    controls us [..., N, d] at times [..., N] and return the gate fidelity
    of the final propagator [...] (the discretization-error check); the
    Pedersen subspace fidelity for an `EmbeddedOperator` goal, whose
    subspace goal `phases` [..., n_qubits] rotate (free_phase_diagonal).
    `dus` is not read by the "constant" interpolation."""
    if interpolation != "constant":
        raise NotImplementedError(
            f"interpolation={interpolation!r} (only 'constant' is ported)")
    if isinstance(us, torch.Tensor) and device is None:
        device = us.device
    device = resolve_device(device)
    us = torch.as_tensor(us).to(device)
    times = torch.as_tensor(times, dtype=us.dtype).to(device)
    Us = unitary_rollout(system, ZeroOrderPulse(us, times), times,
                         method="zoh", n_substeps=n_substeps, device=device)
    U_final = Us[..., -1, :, :]
    if isinstance(goal, EmbeddedOperator):
        sub = torch.as_tensor(np.asarray(goal.subspace), device=device)
        U_goal_sub = torch.as_tensor(goal.unembed()).to(device)
        if phases is not None:
            diag = free_phase_diagonal(torch.as_tensor(phases, dtype=torch.float64)
                                       .to(device), n_qubits, U_goal_sub.shape[-1])
            U_goal_sub = diag[..., :, None] * U_goal_sub
        return pedersen_fidelity(U_final[..., sub[:, None], sub[None, :]],
                                 U_goal_sub)
    return unitary_fidelity(U_final, goal)
