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
    bounds, initial/final pins, goals, controls and frozen components."""

    def __init__(self, data, *, controls=(), timestep=None, bounds=None,
                 initial=None, final=None, goal=None, global_data=None,
                 global_bounds=None, frozen=()):
        data = {k: np.asarray(v, dtype=float) for k, v in data.items()}
        Ns = {v.shape[0] for v in data.values()}
        assert len(Ns) == 1, f"inconsistent knot counts: {Ns}"
        for k, v in data.items():
            assert v.ndim == 2, f"component {k} must be [N, dim]"
        if global_data or global_bounds:
            raise NotImplementedError("trajectory globals")
        self.data = data
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

    def get_timesteps(self):
        """Per-knot dt array [N] (last entry pads the final knot)."""
        if isinstance(self.timestep, str):
            return self.data[self.timestep][:, 0]
        return np.full(self.N, float(self.timestep))

    def __getitem__(self, name: str):
        return self.data[name]

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
    """Static (name -> column slice) map over the dense knot matrix."""

    def __init__(self, names, dims, global_names=(), global_dims=()):
        if tuple(global_names):
            raise NotImplementedError("trajectory globals")
        self.names = tuple(names)
        self.dims = tuple(dims)
        self.slices = {}
        off = 0
        for n, d in zip(self.names, self.dims):
            self.slices[n] = slice(off, off + d)
            off += d
        self.z_dim = off
        self.g_dim = 0

    def __repr__(self):
        parts = ", ".join(f"{n}:{self.slices[n].start}-{self.slices[n].stop}"
                          for n in self.names)
        return f"KnotLayout({parts}; g_dim={self.g_dim})"
