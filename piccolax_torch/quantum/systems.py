"""Closed quantum systems with linear drives, and their real-generator
solver view.

    H(u) = H_drift + sum_d u[d] * H_drive_d

The port covers a constant drift and linear drive terms; time
modulations, nonlinear drive coefficients and function-based systems
raise NotImplementedError. `H(u)` builds the complex Hamiltonian on the
device of u for the rollout; `solver_view()` is the real generator form
the collocation solver works in.
"""

from __future__ import annotations

import numpy as np
import torch

from . import isomorphisms as iso_mod

__all__ = ["QuantumSystem", "RealGeneratorSystem", "normalize_drive_bounds"]


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


class RealGeneratorSystem:
    """Solver-side system: the real iso generator of every term.

    G(u) = G_drift + sum_d u[d] G_d over any leading batch axes of u.
    G_drift is [w, w], or [B, w, w] for a batch of problems that differ
    in their drift (a robustness ensemble): its leading axis is then the
    first axis of u, and it broadcasts over u's other leading axes (the
    knots, line-search candidates). The drives are shared.
    """

    def __init__(self, G_drift, G_drives, levels: int):
        self.G_drift = torch.as_tensor(G_drift)
        self.G_drives = torch.as_tensor(G_drives)
        self.levels = int(levels)
        self.n_drives = int(self.G_drives.shape[0])

    def to(self, device=None, dtype=None) -> "RealGeneratorSystem":
        return RealGeneratorSystem(self.G_drift.to(device, dtype),
                                   self.G_drives.to(device, dtype),
                                   self.levels)

    def G(self, u):
        """u [..., n_drives] -> [..., 2n, 2n]; with a batched drift u is
        [B, ..., n_drives]."""
        drift = self.G_drift
        if drift.dim() == 3:
            drift = drift.reshape(drift.shape[0], *([1] * (u.dim() - 2)),
                                  *drift.shape[1:])
        return drift + torch.einsum("...d,dij->...ij", u, self.G_drives)
