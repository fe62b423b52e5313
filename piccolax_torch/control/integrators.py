"""Collocation dynamics integrators (residual rows and their exact
derivatives), batched over leading axes.

Rows are affine in z_{k+1}, as the condensed KKT requires:

- `BilinearUnitaryIntegrator`: U_{k+1} - expm(dt_k G(u_k)) U_k on operator
  iso-vecs; `BilinearDensityIntegrator`: x_{k+1} - expm(dt_k A(u_k)) x_k
  on compact density isos, A the compact Lindbladian. For both the
  propagator and its exact first and second derivatives in u (and in dt_k
  when the timestep is a decision variable) come from ONE call of the
  fixed expm kernel (K4 for order "taylor", K6 for a Pade order) on
  block-triangular augmentations (`ops.expm.expm_fixed_derivatives`):
  the derivatives of the same approximant that piccolax differentiates
  with jacfwd/hessian.
- `DerivativeIntegrator`: u_{k+1} - u_k - dt_k du_k (bilinear, no kernel).
- `TimeStepsEqualIntegrator`: dt_{k+1} - dt_k (linear, no kernel).

A timestep is a decision variable when its name is in the NLP layout,
and frozen data otherwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.expm import (TAYLOR_THETA, expm_fixed, expm_fixed_derivatives,
                        pade_radius)

__all__ = ["BilinearUnitaryIntegrator", "BilinearDensityIntegrator",
           "DerivativeIntegrator",
           "TimeStepsEqualIntegrator", "choose_squarings"]


def choose_squarings(max_norm: float, order="taylor") -> int:
    """Static squaring count so ||A||/2^s is inside the approximant's
    accuracy radius (Taylor: ops/expm.py TAYLOR_THETA; Pade: PADE_ORDERS).
    An order that is neither "taylor" nor a key of PADE_ORDERS raises."""
    radius = TAYLOR_THETA if order == "taylor" else pade_radius(order)
    if max_norm <= radius:
        return 0
    return max(0, math.ceil(math.log2(max_norm / radius)))


def _bound_dt_G_norm(system, traj) -> float:
    """Conservative bound on ||dt * H(u)|| over the feasible box."""
    H0 = np.asarray(system.get_drift())
    norm = np.linalg.norm(H0, 2) if H0.size else 0.0
    bounds = np.asarray(system.drive_bounds)
    for i, d in enumerate(system.get_drives()):
        b = max(abs(bounds[i, 0]), abs(bounds[i, 1])) if i < len(bounds) else 1.0
        if not np.isfinite(b):
            b = 1.0
        norm += b * np.linalg.norm(np.asarray(d), 2)
    dts = np.asarray(traj.get_timesteps())
    dt_max = float(np.max(dts))
    if "dt" in traj.bounds:
        dt_max = max(dt_max, float(np.max(np.asarray(traj.bounds["dt"])[:, 1])))
    return norm * dt_max


class _BilinearIntegrator:
    """Rows x_{k+1} - Phi_k x_k for every row x of the states (rows of
    width w), Phi_k = expm(dt_k A(u_k)) with A(u) affine in u. A subclass
    gives the generator A(u) (`generator`, [..., w, w]), its drive
    directions dA/du_i (`drive_generators`, [nd, w, w]), the states' rows
    and their columns in the layout; the Jacobian and Hessian assembly is
    shared."""

    def residual(self, get, getp, params):
        """[..., K, dim] for knots k with z_k from get, z_{k+1} from getp."""
        system = params["system"]
        dt = get(self.time_name)[..., 0]
        Phi = expm_fixed((dt[..., None, None] * self.generator(system, get(self.drive_name))
                          ).contiguous(), self.order, self.squarings)
        R = self._rows(getp) - self._rows(get) @ Phi.mT
        return R.reshape(*R.shape[:-2], self.dim)

    def derivatives(self, get, getp, params, lam, layout):
        """Jacobian blocks and the Hessian of lam . rows in z_k.

        Returns (Jself [..., K, dim, dz], Jnext [..., K, dim, dz],
        H [..., K, dz, dz]); lam [..., K, dim].

        dt A(u) is bilinear in (u, dt): the directions are
        E_{u_i} = dt A_i and, for a free timestep, E_dt = A(u), and the
        chain rule adds D Phi[d2(dt A) / ddt du_i] = D Phi[A_i] =
        D Phi[E_{u_i}] / dt to the (dt, u_i) second derivative.
        """
        system = params["system"]
        nd = system.n_drives
        dt_free = self.time_name in layout.slices
        dt = get(self.time_name)[..., 0][..., None, None]
        G = self.generator(system, get(self.drive_name))       # [..., K, w, w]
        A = dt * G
        E = dt[..., None, :, :] * self.drive_generators(system)  # [..., K, nd, w, w]
        if dt_free:
            E = torch.cat([E, G[..., None, :, :]], dim=-3)
        lead = A.shape[:-2]
        nv = E.shape[-3]
        Phi, dPhi, D2 = expm_fixed_derivatives(A, E, self.order, self.squarings)

        Xc = self._rows(get)                                    # [..., K, r, w]
        r = Xc.shape[-2]
        lam_c = lam.reshape(*lam.shape[:-1], r, -1)
        dz = layout.z_dim
        sX = self._state_cols(layout)
        su = layout.slices[self.drive_name]
        cols = list(range(su.start, su.stop))
        if dt_free:
            cols += list(range(layout.slices[self.time_name].start,
                               layout.slices[self.time_name].stop))
        cols = torch.tensor(cols, device=A.device)
        Jself = A.new_zeros(*lead, self.dim, dz)
        eye_r = torch.eye(r, dtype=A.dtype, device=A.device)
        kron = eye_r[:, None, :, None] * Phi[..., None, :, None, :]
        Jself[..., sX] = -kron.reshape(*lead, self.dim, self.dim)
        dX = Xc[..., None, :, :] @ dPhi.mT                      # [..., K, nv, r, w]
        Jself[..., cols] = -dX.reshape(*lead, nv, self.dim).mT
        Jnext = A.new_zeros(*lead, self.dim, dz)
        Jnext[..., sX] = torch.eye(self.dim, dtype=A.dtype, device=A.device)

        H = A.new_zeros(*lead, dz, dz)
        Hnl = -torch.einsum("...ca,...ijab,...cb->...ij", lam_c, D2, Xc)
        if dt_free:
            # (dt, u_i): lam . D Phi[A_i] X_k with D Phi[A_i] = dPhi[i] / dt,
            # dt > 0 as discretize requires of the lower bound
            cross = -torch.einsum("...ca,...iab,...cb->...i", lam_c,
                                  dPhi[..., :nd, :, :], Xc) / dt[..., 0]
            Hnl[..., :nd, nd] = Hnl[..., :nd, nd] + cross
            Hnl[..., nd, :nd] = Hnl[..., nd, :nd] + cross
        HnX = -(lam_c[..., None, :, :] @ dPhi).reshape(*lead, nv, self.dim)
        H[..., cols[:, None], cols[None, :]] = Hnl
        H[..., cols, sX] = HnX
        H[..., sX, cols] = HnX.mT
        return Jself, Jnext, H


class BilinearUnitaryIntegrator(_BilinearIntegrator):
    """Rows: U_{k+1} - expm(dt_k G(u_k)) U_k in operator iso-vec form: the
    n columns of U are rows of width 2n."""

    def __init__(self, state_name: str, drive_name: str, levels: int,
                 order="taylor", squarings: int = 2, time_name: str = "dt"):
        self.state_name = state_name
        self.drive_name = drive_name
        self.time_name = time_name
        self.order = order
        self.squarings = squarings
        self.levels = levels
        self.dim = 2 * levels * levels

    def generator(self, system, u):
        return system.G(u)

    def drive_generators(self, system):
        return system.G_drives

    def _rows(self, get):
        """operator iso-vec [..., 2n^2] -> its columns [..., n, 2n]."""
        x = get(self.state_name)
        return x.reshape(*x.shape[:-1], self.levels, 2 * self.levels)

    def _state_cols(self, layout):
        return layout.slices[self.state_name]


class BilinearDensityIntegrator(_BilinearIntegrator):
    """Rows: x_{k+1} - expm(dt_k A(u_k)) x_k for each compact density iso
    x [n^2] of `state_names` (one row each, sharing the propagator), A the
    real n^2 x n^2 compact Lindbladian (`compact_lindbladian`)."""

    def __init__(self, state_names, drive_name: str, levels: int,
                 order="taylor", squarings: int = 2, time_name: str = "dt"):
        self.state_names = (state_names,) if isinstance(state_names, str) \
            else tuple(state_names)
        self.drive_name = drive_name
        self.time_name = time_name
        self.order = order
        self.squarings = squarings
        self.levels = levels
        self.dim = levels * levels * len(self.state_names)

    def generator(self, system, u):
        return system.compact_lindbladian(u)

    def drive_generators(self, system):
        return system.lind_drives

    def _rows(self, get):
        return torch.stack([get(nm) for nm in self.state_names], dim=-2)

    def _state_cols(self, layout):
        """The states' columns, one slice: the states lie side by side in
        the layout, in the order of state_names."""
        sl = [layout.slices[nm] for nm in self.state_names]
        if any(a.stop != b.start for a, b in zip(sl[:-1], sl[1:])):
            raise ValueError(f"BilinearDensityIntegrator: states {self.state_names} "
                             "are not adjacent in the layout")
        return slice(sl[0].start, sl[-1].stop)


class DerivativeIntegrator:
    """u_{k+1} - u_k - dt_k * du_k."""

    def __init__(self, name: str, dname: str, dim: int,
                 time_name: str = "dt"):
        self.name = name
        self.dname = dname
        self.time_name = time_name
        self.dim = dim

    def residual(self, get, getp, params):
        dt = get(self.time_name)
        return getp(self.name) - get(self.name) - dt * get(self.dname)

    def derivatives(self, get, getp, params, lam, layout):
        """Jacobian blocks and the Hessian of lam . rows in z_k; with a free
        timestep the dt column is -du_k and the (dt, du_i) entries are
        -lam_i."""
        dt = get(self.time_name)[..., 0]
        lead = torch.broadcast_shapes(dt.shape, lam.shape[:-1])
        kw = dict(dtype=lam.dtype, device=lam.device)
        eye = torch.eye(self.dim, **kw)
        dz = layout.z_dim
        s, sd = layout.slices[self.name], layout.slices[self.dname]
        Jself = torch.zeros(*lead, self.dim, dz, **kw)
        Jself[..., s] = -eye
        Jself[..., sd] = -dt[..., None, None] * eye
        Jnext = torch.zeros(*lead, self.dim, dz, **kw)
        Jnext[..., s] = eye
        H = torch.zeros(*lead, dz, dz, **kw)
        if self.time_name in layout.slices:
            st = layout.slices[self.time_name]
            Jself[..., st] = -get(self.dname)[..., None]
            H[..., sd, st] = -lam[..., None]
            H[..., st, sd] = -lam[..., None, :]
        return Jself, Jnext, H


class TimeStepsEqualIntegrator:
    """dt_{k+1} - dt_k (the timesteps of a free-time problem stay equal)."""

    def __init__(self, time_name: str = "dt"):
        self.time_name = time_name
        self.dim = 1

    def residual(self, get, getp, params):
        return getp(self.time_name) - get(self.time_name)

    def derivatives(self, get, getp, params, lam, layout):
        kw = dict(dtype=lam.dtype, device=lam.device)
        lead = lam.shape[:-1]
        dz = layout.z_dim
        st = layout.slices[self.time_name]
        Jself = torch.zeros(*lead, 1, dz, **kw)
        Jself[..., st] = -1.0
        Jnext = torch.zeros(*lead, 1, dz, **kw)
        Jnext[..., st] = 1.0
        return Jself, Jnext, torch.zeros(*lead, dz, dz, **kw)
