"""Truly-f64 independent quality gates (pure numpy + scipy).

A copy of `piccolax.verification`: the quality gates re-integrate solved
pulses with an integrator that (a) runs in genuine float64 and (b) shares
no code with the solver's Taylor-expm dynamics. This module is that
integrator: batched DOP853 (`scipy.integrate.solve_ivp`) over each ZOH
knot interval, plus numpy fidelity kernels and iso decoders.

Mirrors the reference's independent-rollout validation culture
(reference: docs/literate/two_qubit_gate_validation.jl:347-348 — the
|dF| <= 1e-4 agreement bar against a QuantumToolbox rollout; and
ext/PiccoloQuantumToolboxExt.jl:21).
"""

from __future__ import annotations

import numpy as np
from scipy.integrate import solve_ivp

__all__ = [
    "iso_vec_to_operator_np",
    "compact_iso_to_density_np",
    "unitary_fidelity_np",
    "pedersen_fidelity_np",
    "batched_unitary_dop853",
    "batched_density_dop853",
]


def iso_vec_to_operator_np(u_iso: np.ndarray) -> np.ndarray:
    """(…, 2n^2) real iso-vec -> (…, n, n) complex128 (column-major,
    per column [Re(col); Im(col)] — matches quantum/isomorphisms.py)."""
    u_iso = np.asarray(u_iso, np.float64)
    n = int(round(np.sqrt(u_iso.shape[-1] // 2)))
    blocks = u_iso.reshape(*u_iso.shape[:-1], n, 2 * n)
    cols = blocks[..., :n] + 1j * blocks[..., n:]
    return np.swapaxes(cols, -1, -2)


def compact_iso_to_density_np(x: np.ndarray) -> np.ndarray:
    """(…, n^2) compact Hermitian iso -> (…, n, n) complex128
    (column-major upper-triangle Re then strict-upper Im — matches
    quantum/isomorphisms.py:_compact_indices)."""
    x = np.asarray(x, np.float64)
    n = int(round(np.sqrt(x.shape[-1])))
    re_j, re_k, im_j, im_k = [], [], [], []
    for k in range(n):
        for j in range(k + 1):
            re_j.append(j)
            re_k.append(k)
    for k in range(1, n):
        for j in range(k):
            im_j.append(j)
            im_k.append(k)
    re_j, re_k = np.array(re_j), np.array(re_k)
    im_j, im_k = np.array(im_j), np.array(im_k)
    rho = np.zeros((*x.shape[:-1], n, n), np.complex128)
    rho[..., re_j, re_k] += x[..., :len(re_j)]
    off = re_j != re_k
    rho[..., re_k[off], re_j[off]] += x[..., :len(re_j)][..., off]
    rho[..., im_j, im_k] += 1j * x[..., len(re_j):]
    rho[..., im_k, im_j] += -1j * x[..., len(re_j):]
    return rho


def unitary_fidelity_np(U, goal, subspace=None):
    """|tr(U^dag G)|^2 / n^2 over leading batch axes (float64)."""
    U = np.asarray(U, np.complex128)
    goal = np.asarray(goal, np.complex128)
    if subspace is not None:
        sub = np.asarray(subspace)
        U = U[..., sub[:, None], sub[None, :]]
        goal = goal[..., sub[:, None], sub[None, :]]
    n = U.shape[-1]
    tr = np.einsum("...ij,...ij->...", np.conj(U), goal)
    return np.abs(tr) ** 2 / n ** 2


def pedersen_fidelity_np(U_sub, goal_sub):
    """Pedersen average-gate subspace fidelity (handles leakage):
    (tr(M^dag M) + |tr M|^2) / (m (m + 1)), M = G^dag U_sub."""
    U_sub = np.asarray(U_sub, np.complex128)
    goal_sub = np.asarray(goal_sub, np.complex128)
    m = U_sub.shape[-1]
    M = np.swapaxes(np.conj(goal_sub), -1, -2) @ U_sub
    t1 = np.einsum("...ij,...ij->...", np.conj(M), M).real
    t2 = np.abs(np.einsum("...ii->...", M)) ** 2
    return (t1 + t2) / (m * (m + 1))


def _as_batched_drift(H0, B):
    H0 = np.asarray(H0, np.complex128)
    if H0.ndim == 2:
        return np.broadcast_to(H0, (B, *H0.shape))
    assert H0.shape[0] == B
    return H0


def batched_unitary_dop853(H0, H_drives, us, times, *, rtol=1e-10,
                           atol=1e-10):
    """Integrate dU/dt = -i H(u_k) U for a batch of ZOH pulses.

    One DOP853 call per knot interval over the STACKED batch (the knot
    times are ZOH discontinuity points, so each call sees a smooth
    constant-H system; stacking amortizes scipy overhead ~B-fold).

    H0: [n, n] or per-sample [B, n, n] (robustness ensembles).
    H_drives: [d, n, n]. us: [B, N, d] ZOH knot samples (left sample
    drives interval k). times: [N]. Returns U_final [B, n, n] c128.
    """
    us = np.asarray(us, np.float64)
    B, N, d = us.shape
    Hds = np.asarray(H_drives, np.complex128)
    n = Hds.shape[-1]
    H0b = _as_batched_drift(H0, B)
    times = np.asarray(times, np.float64)
    y = np.broadcast_to(np.eye(n, dtype=np.complex128),
                        (B, n, n)).reshape(-1).copy()
    for k in range(N - 1):
        Hb = H0b + np.einsum("bd,dij->bij", us[:, k], Hds)

        def rhs(t, yv, Hb=Hb):
            U = yv.reshape(B, n, n)
            return (-1j * (Hb @ U)).reshape(-1)

        sol = solve_ivp(rhs, (times[k], times[k + 1]), y, method="DOP853",
                        rtol=rtol, atol=atol)
        if not sol.success:
            raise RuntimeError(f"DOP853 failed on interval {k}: "
                               f"{sol.message}")
        y = sol.y[:, -1]
    return y.reshape(B, n, n)


def batched_density_dop853(H0, H_drives, Ls, us, times, rho0, *,
                           rtol=1e-10, atol=1e-10):
    """Integrate the Lindblad master equation for a batch of ZOH pulses.

    Ls: list of (already gamma-scaled) jump operators sqrt(gamma) L.
    rho0: [n, n]. Returns rho_final [B, n, n] complex128.
    """
    us = np.asarray(us, np.float64)
    B, N, d = us.shape
    Hds = np.asarray(H_drives, np.complex128)
    n = Hds.shape[-1]
    H0b = _as_batched_drift(H0, B)
    Ls = [np.asarray(L, np.complex128) for L in Ls]
    LdLs = [L.conj().T @ L for L in Ls]
    times = np.asarray(times, np.float64)
    y = np.broadcast_to(np.asarray(rho0, np.complex128),
                        (B, n, n)).reshape(-1).copy()
    for k in range(N - 1):
        Hb = H0b + np.einsum("bd,dij->bij", us[:, k], Hds)

        def rhs(t, yv, Hb=Hb):
            rho = yv.reshape(B, n, n)
            drho = -1j * (Hb @ rho - rho @ Hb)
            for L, LdL in zip(Ls, LdLs):
                drho = drho + L @ rho @ L.conj().T \
                    - 0.5 * (LdL @ rho + rho @ LdL)
            return drho.reshape(-1)

        sol = solve_ivp(rhs, (times[k], times[k + 1]), y, method="DOP853",
                        rtol=rtol, atol=atol)
        if not sol.success:
            raise RuntimeError(f"DOP853 failed on interval {k}: "
                               f"{sol.message}")
        y = sol.y[:, -1]
    return y.reshape(B, n, n)
