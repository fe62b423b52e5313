"""Quantum systems with linear drives, open (Lindblad) systems with
constant-rate dissipators, and their real-generator solver view.

    H(u) = H_drift + sum_d u[d] * H_drive_d
    d rho / dt = -i [H(u), rho] + sum_j rate_j D[L_j](rho)

The port covers a constant drift and linear drive terms; time
modulations, nonlinear drive coefficients, control-dependent dissipation
rates and function-based systems raise NotImplementedError. `H(u)` builds
the complex Hamiltonian on the device of u for the rollout;
`solver_view()` is the real generator form the collocation solver works
in (with the compact-iso Lindbladian's parts for an open system).
"""

from __future__ import annotations

import numpy as np
import torch

from . import isomorphisms as iso_mod
from .dynamics import liouvillian

__all__ = ["QuantumSystem", "OpenQuantumSystem", "LinearDissipator",
           "NonlinearDissipator", "RealGeneratorSystem", "normalize_drive_bounds"]


def normalize_drive_bounds(bounds, n_drives: int):
    """Normalize drive bounds to an [n_drives, 2] (lo, hi) array."""
    if bounds is None:
        return np.stack([np.full(n_drives, -np.inf),
                         np.full(n_drives, np.inf)], axis=-1)
    if np.isscalar(bounds):
        b = float(bounds)
        return np.stack([np.full(n_drives, -b), np.full(n_drives, b)], axis=-1)
    out = []
    for b in bounds:
        if np.isscalar(b):
            out.append((-float(b), float(b)))
        else:
            lo, hi = b
            out.append((float(lo), float(hi)))
    assert len(out) == n_drives, f"expected {n_drives} drive bounds, got {len(out)}"
    return np.asarray(out)


def _check_hermitian(M, name: str):
    if not np.allclose(M, M.conj().T, atol=1e-10):
        raise ValueError(f"{name} must be Hermitian")


class QuantumSystem:
    """Closed quantum system with a constant drift and linear drives."""

    def __init__(self, H_drift, H_drives, drive_bounds=None):
        drives = []
        for d in H_drives or []:
            if isinstance(d, tuple) or not isinstance(
                    d, (np.ndarray, list)):
                raise NotImplementedError(
                    "only constant linear drive matrices are ported")
            drives.append(np.asarray(d, dtype=np.complex128))
        self.H_drift = np.asarray(H_drift, dtype=np.complex128)
        self.H_drives = drives
        _check_hermitian(self.H_drift, "H_drift")
        for d in drives:
            _check_hermitian(d, "H_drive")
        self.levels = int(self.H_drift.shape[-1])
        self.n_drives = len(drives)
        self.drive_bounds = normalize_drive_bounds(drive_bounds, self.n_drives)

    def H(self, u=None):
        """Complex Hamiltonian [..., n, n] at controls u [..., n_drives], a
        tensor on u's device (complex128 for float64 u, else complex64)."""
        u = torch.zeros(self.n_drives, dtype=torch.float64) if u is None \
            else torch.as_tensor(u)
        cdtype = torch.complex128 if u.dtype == torch.float64 else torch.complex64
        Hm = torch.as_tensor(self.H_drift).to(u.device, cdtype)
        Hm = Hm.expand(*u.shape[:-1], *Hm.shape)
        for i, d in enumerate(self.H_drives):
            Hm = Hm + u[..., i, None, None] * torch.as_tensor(d).to(u.device, cdtype)
        return Hm

    def get_drift(self):
        return self.H_drift

    def get_drives(self):
        return list(self.H_drives)

    def solver_view(self) -> "RealGeneratorSystem":
        """Real-arithmetic view for the collocation solver."""
        return RealGeneratorSystem(
            iso_mod.G(self.H_drift),
            np.stack([iso_mod.G(d) for d in self.H_drives]),
            self.levels)


class LinearDissipator:
    """Jump operator with a constant rate: effective operator L sqrt(rate)."""

    def __init__(self, L, rate=1.0):
        self.L = np.asarray(L, dtype=np.complex128)
        self.rate = float(rate)

    def operator(self, u=None):
        return self.L * np.sqrt(self.rate)


class NonlinearDissipator:
    """Jump operator with a control-dependent rate f(u): not ported."""

    def __init__(self, *args, **kw):
        raise NotImplementedError("control-dependent dissipation rates "
                                  "(NonlinearDissipator)")


class OpenQuantumSystem(QuantumSystem):
    """Lindblad open system: Hamiltonian terms and constant-rate
    dissipators (a bare matrix is a `LinearDissipator` of rate 1)."""

    def __init__(self, H_drift, H_drives, drive_bounds=None, *, dissipators=()):
        super().__init__(H_drift, H_drives, drive_bounds)
        self.dissipators = tuple(
            d if isinstance(d, LinearDissipator) else LinearDissipator(d) for d in dissipators)

    def liouvillian_iso(self, u=None):
        """Real iso superoperator on the full density iso-vec [..., 2n^2,
        2n^2]: d/dt iso_vec(rho) = L_iso @ iso_vec(rho)."""
        return iso_mod.iso(liouvillian(self, u))

    def compact_lindbladian(self, u=None):
        """Real generator on the compact density iso [..., n^2, n^2]:
        P @ L_iso @ Lift with the static compact <-> full maps."""
        L_iso = self.liouvillian_iso(u)
        P = torch.as_tensor(iso_mod.density_projection_matrix(self.levels)).to(L_iso)
        Lf = torch.as_tensor(iso_mod.density_lift_matrix(self.levels)).to(L_iso)
        return P @ L_iso @ Lf

    def lindblad_rhs(self, rho, u=None):
        """d rho / dt = -i [H, rho] + sum_j D[L_j](rho), complex matrices
        [..., n, n] (rho a tensor, or an array moved to H(u)'s device)."""
        Hm = self.H(u)
        rho = torch.as_tensor(rho).to(Hm)
        out = -1j * (Hm @ rho - rho @ Hm)
        for d in self.dissipators:
            Lop = torch.as_tensor(d.operator(u)).to(Hm)
            LdL = Lop.mH @ Lop
            out = out + Lop @ rho @ Lop.mH - 0.5 * (LdL @ rho + rho @ LdL)
        return out

    def solver_view(self) -> "RealGeneratorSystem":
        """The real view with the compact Lindbladian's parts: one constant
        n^2 x n^2 generator a Hamiltonian term (its coefficient enters
        linearly) and a unit-rate superoperator a dissipator, scaled by its
        rate."""
        n = self.levels
        P = iso_mod.density_projection_matrix(n)
        Lf = iso_mod.density_lift_matrix(n)

        def compact_h(X):
            return P @ iso_mod.iso(-1j * iso_mod.ad_vec(X)) @ Lf

        base = super().solver_view()
        diss_mats = np.stack([P @ iso_mod.iso_D(d.L) @ Lf for d in self.dissipators]) \
            if self.dissipators else np.zeros((0, n * n, n * n))
        return RealGeneratorSystem(
            base.G_drift, base.G_drives, n, lind_drift=compact_h(self.H_drift),
            lind_drives=np.stack([compact_h(d) for d in self.H_drives]), diss_mats=diss_mats,
            diss_rates=np.array([d.rate for d in self.dissipators], dtype=float))


class RealGeneratorSystem:
    """Solver-side system: the real iso generator of every term, and for
    an open system the compact-iso Lindbladian's parts.

    G(u) = G_drift + sum_d u[d] G_d over any leading batch axes of u.
    G_drift is [w, w], or [B, w, w] for a batch of problems that differ
    in their drift (a robustness ensemble): its leading axis is then the
    first axis of u, and it broadcasts over u's other leading axes (the
    knots, line-search candidates). The drives are shared.

    An open system also carries lind_drift [n^2, n^2] (or [B, n^2, n^2],
    batched as G_drift), lind_drives [nd, n^2, n^2], diss_mats
    [nL, n^2, n^2] (unit-rate dissipators) and diss_rates [nL] for
    `compact_lindbladian`; a closed one has lind_drift None.
    """

    def __init__(self, G_drift, G_drives, levels: int, *, lind_drift=None,
                 lind_drives=None, diss_mats=None, diss_rates=None):
        self.G_drift = torch.as_tensor(G_drift)
        self.G_drives = torch.as_tensor(G_drives)
        self.levels = int(levels)
        self.n_drives = int(self.G_drives.shape[0])
        lind = (lind_drift, lind_drives, diss_mats, diss_rates)
        if any(v is None for v in lind) and any(v is not None for v in lind):
            raise ValueError("RealGeneratorSystem: lind_drift, lind_drives, diss_mats "
                             "and diss_rates come together")
        self.lind_drift, self.lind_drives, self.diss_mats, self.diss_rates = (
            None if v is None else torch.as_tensor(v) for v in lind)

    def to(self, device=None, dtype=None) -> "RealGeneratorSystem":
        lind = {k: None if v is None else v.to(device, dtype)
                for k, v in (("lind_drift", self.lind_drift),
                             ("lind_drives", self.lind_drives),
                             ("diss_mats", self.diss_mats),
                             ("diss_rates", self.diss_rates))}
        return RealGeneratorSystem(self.G_drift.to(device, dtype),
                                   self.G_drives.to(device, dtype),
                                   self.levels, **lind)

    @staticmethod
    def _drift_view(drift, u):
        """A [B, w, w] drift viewed against u [B, ..., d]; a [w, w] one as it is."""
        if drift.dim() == 3:
            drift = drift.reshape(drift.shape[0], *([1] * (u.dim() - 2)),
                                  *drift.shape[1:])
        return drift

    def G(self, u):
        """u [..., n_drives] -> [..., 2n, 2n]; with a batched drift u is
        [B, ..., n_drives]."""
        return self._drift_view(self.G_drift, u) + \
            torch.einsum("...d,dij->...ij", u, self.G_drives)

    def compact_lindbladian(self, u):
        """u [..., n_drives] -> A(u) [..., n^2, n^2] = lind_drift + sum_d
        u[d] lind_drives[d] + sum_j diss_rates[j] diss_mats[j]: d/dt
        compact(rho) = A(u) compact(rho); batched as `G`."""
        if self.lind_drift is None:
            raise ValueError("compact_lindbladian: a closed system's view has no "
                             "Lindbladian")
        diss = torch.einsum("j,jab->ab", self.diss_rates, self.diss_mats)
        return self._drift_view(self.lind_drift + diss, u) + \
            torch.einsum("...d,dij->...ij", u, self.lind_drives)
