"""Knot-point trajectory container (host-side numpy) and the name ->
column-slice layout the solver reads it through; the interface of
`piccolax.trajectory`."""

from __future__ import annotations

import numpy as np

__all__ = ["Trajectory", "KnotLayout"]


def _freeze_bound(b, dim: int):
    """Normalize a bound spec to a [dim, 2] (lo, hi) array."""
    if b is None:
        return np.stack([np.full(dim, -np.inf), np.full(dim, np.inf)], -1)
    if np.isscalar(b):
        return np.stack([np.full(dim, -float(b)), np.full(dim, float(b))], -1)
    b = np.asarray(b, dtype=float)
    if b.ndim == 1 and b.shape[0] == dim:          # symmetric per-component
        return np.stack([-b, b], axis=-1)
    if b.ndim == 1 and b.shape[0] == 2:            # shared (lo, hi)
        return np.broadcast_to(b[None, :], (dim, 2)).copy()
    assert b.shape == (dim, 2), f"bad bound shape {b.shape} for dim {dim}"
    return b


class Trajectory:
    """Named knot data over N knots: data name -> [N, dim] float64, with
    bounds, initial/final pins, goals, controls and frozen components;
    global_data name -> [dim] time-invariant variables (free phases,
    slacks) with their global_bounds."""

    def __init__(self, data, *, controls=(), timestep=None, bounds=None,
                 initial=None, final=None, goal=None, global_data=None,
                 global_bounds=None, frozen=()):
        data = {k: np.asarray(v, dtype=float) for k, v in data.items()}
        Ns = {v.shape[0] for v in data.values()}
        assert len(Ns) == 1, f"inconsistent knot counts: {Ns}"
        for k, v in data.items():
            assert v.ndim == 2, f"component {k} must be [N, dim]"
        global_data = {k: np.atleast_1d(np.asarray(v, dtype=float))
                       for k, v in (global_data or {}).items()}
        self.data = data
        self.global_data = global_data
        self.global_bounds = {k: _freeze_bound(b, global_data[k].shape[0])
                              for k, b in (global_bounds or {}).items()}
        self.bounds = {k: _freeze_bound(b, data[k].shape[1])
                       for k, b in (bounds or {}).items()}
        clean = lambda d: {k: np.asarray(v, dtype=float)  # noqa: E731
                           for k, v in (d or {}).items() if v is not None}
        self.initial = clean(initial)
        self.final = clean(final)
        self.goal = clean(goal)
        self.controls = tuple(controls)
        self.timestep = timestep
        self.frozen = tuple(frozen)

    def _copy(self, **changes) -> "Trajectory":
        new = object.__new__(Trajectory)
        new.__dict__.update(self.__dict__)
        new.__dict__.update(changes)
        return new

    @property
    def N(self) -> int:
        return next(iter(self.data.values())).shape[0]

    @property
    def names(self) -> tuple:
        return tuple(self.data.keys())

    @property
    def dims(self) -> dict:
        return {k: v.shape[1] for k, v in self.data.items()}

    @property
    def global_names(self) -> tuple:
        return tuple(self.global_data.keys())

    @property
    def global_dim(self) -> int:
        return sum(v.shape[0] for v in self.global_data.values())

    def get_timesteps(self):
        """Per-knot dt array [N] (last entry pads the final knot)."""
        if isinstance(self.timestep, str):
            return self.data[self.timestep][:, 0]
        return np.full(self.N, float(self.timestep))

    def __getitem__(self, name: str):
        if name in self.data:
            return self.data[name]
        return self.global_data[name]

    def get_times(self):
        """Accumulated knot times [N], t_0 = 0."""
        dts = self.get_timesteps()
        return np.concatenate([np.zeros(1, dts.dtype), np.cumsum(dts[:-1])])

    def add_component(self, name: str, values, *, control: bool = False,
                      bound=None, initial=None, final=None) -> "Trajectory":
        values = np.asarray(values, dtype=float)
        assert values.shape[0] == self.N
        data = dict(self.data)
        data[name] = values
        bounds = dict(self.bounds)
        if bound is not None:
            bounds[name] = _freeze_bound(bound, values.shape[1])
        init_d = dict(self.initial)
        if initial is not None:
            init_d[name] = np.asarray(initial, dtype=float)
        fin_d = dict(self.final)
        if final is not None:
            fin_d[name] = np.asarray(final, dtype=float)
        controls = self.controls + (name,) if control else self.controls
        return self._copy(data=data, bounds=bounds, initial=init_d,
                          final=fin_d, controls=controls)

    def with_global_data(self, **updates) -> "Trajectory":
        new = dict(self.global_data)
        for k, v in updates.items():
            new[k] = np.atleast_1d(np.asarray(v, dtype=float))
        return self._copy(global_data=new)

    def update_bound(self, name: str, bound) -> "Trajectory":
        """The trajectory with the bound of component or global `name`
        replaced."""
        if name in self.data:
            bounds = dict(self.bounds)
            bounds[name] = _freeze_bound(bound, self.data[name].shape[1])
            return self._copy(bounds=bounds)
        gbounds = dict(self.global_bounds)
        gbounds[name] = _freeze_bound(bound, self.global_data[name].shape[0])
        return self._copy(global_bounds=gbounds)

    def layout(self) -> "KnotLayout":
        return KnotLayout(self.names, [self.dims[k] for k in self.names],
                          self.global_names,
                          [self.global_data[k].shape[0] for k in self.global_names])

    def knot_matrix(self):
        """Dense [N, z_dim] view of all components."""
        return np.concatenate([self.data[k] for k in self.names], axis=1)

    def global_vector(self):
        if not self.global_data:
            return np.zeros(0)
        return np.concatenate([self.global_data[k] for k in self.global_names])

    def with_knot_matrix(self, Z, g=None) -> "Trajectory":
        """Inverse of knot_matrix/global_vector."""
        layout = self.layout()
        Z = np.asarray(Z, dtype=float)
        out = self._copy(data={k: Z[:, sl] for k, sl in layout.slices.items()})
        if g is not None and self.global_data:
            g = np.asarray(g, dtype=float)
            out = out._copy(global_data={k: g[sl] for k, sl
                                         in layout.global_slices.items()})
        return out

    def add_control_derivatives(self, order: int, name: str | None = None,
                                bounds=None, zero_initial: bool = False,
                                zero_final: bool = False) -> "Trajectory":
        """Append finite-difference derivative components (u -> du -> ddu)."""
        base = name or self.controls[0]
        traj = self
        dts = self.get_timesteps()
        src = self.data[base]
        for o in range(order):
            dname = "d" * (o + 1) + base
            dv = (src[1:] - src[:-1]) / dts[:-1, None]
            dv = np.concatenate([dv, dv[-1:]], axis=0)
            bound = None
            if bounds is not None and o < len(bounds) and bounds[o] is not None:
                bound = bounds[o]
            zero = np.zeros(src.shape[1])
            traj = traj.add_component(
                dname, dv, control=True, bound=bound,
                initial=zero if (zero_initial and o == 0) else None,
                final=zero if (zero_final and o == 0) else None)
            src = dv
        return traj


class KnotLayout:
    """Static (name -> column slice) map over the dense knot matrix and
    the global vector."""

    def __init__(self, names, dims, global_names=(), global_dims=()):
        self.names = tuple(names)
        self.dims = tuple(dims)
        self.slices = {}
        off = 0
        for n, d in zip(self.names, self.dims):
            self.slices[n] = slice(off, off + d)
            off += d
        self.z_dim = off
        self.global_names = tuple(global_names)
        self.global_slices = {}
        goff = 0
        for n, d in zip(self.global_names, global_dims):
            self.global_slices[n] = slice(goff, goff + d)
            goff += d
        self.g_dim = goff

    def gview(self, g, name: str):
        """Columns of global `name` from a [..., g_dim] vector."""
        return g[..., self.global_slices[name]]

    def __repr__(self):
        parts = ", ".join(f"{n}:{self.slices[n].start}-{self.slices[n].stop}"
                          for n in self.names)
        return f"KnotLayout({parts}; g_dim={self.g_dim})"
