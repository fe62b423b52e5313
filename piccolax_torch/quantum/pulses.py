"""Control pulses (host-side numpy): the zero-order-hold pulse of the
SX-gate path, with the interface of `piccolax.quantum.pulses`."""

from __future__ import annotations

import numpy as np

__all__ = ["ZeroOrderPulse"]

_SNAP_TOL = 1e-9


class _PulseBase:
    """Shared pulse interface."""

    drive_name: str = "u"

    @property
    def duration(self):
        raise NotImplementedError

    @property
    def n_drives(self) -> int:
        raise NotImplementedError

    def __call__(self, t):
        raise NotImplementedError

    def sample(self, times):
        """Evaluate at an array of times -> [len(times), n_drives]."""
        return np.stack([self(t) for t in np.asarray(times, float)])

    def knot_times(self):
        raise TypeError(f"{type(self).__name__} has no knots")


def _boundary(value, n_drives: int):
    """None -> zeros (pinned at 0); "free" -> NaN."""
    if value is None:
        return np.zeros(n_drives)
    if isinstance(value, str):
        assert value == "free", f"unknown boundary spec {value!r}"
        return np.full(n_drives, np.nan)
    return np.asarray(value, dtype=float)


class ZeroOrderPulse(_PulseBase):
    """u(t) = values[k] for t in [times[k], times[k+1]) (knot-snapped)."""

    def __init__(self, values, times, drive_name="u",
                 initial_value=None, final_value=None):
        values = np.asarray(values, dtype=float)
        times = np.asarray(times, dtype=float)
        assert values.ndim == 2 and values.shape[0] == times.shape[0], (
            "values must be [K, n_drives] matching times [K]")
        d = values.shape[1]
        self.times = times
        self.values = values
        self.initial_value = _boundary(initial_value, d)
        self.final_value = _boundary(final_value, d)
        self.drive_name = drive_name

    @property
    def duration(self):
        return self.times[-1]

    @property
    def n_drives(self) -> int:
        return self.values.shape[-1]

    def __call__(self, t):
        k = np.searchsorted(self.times, t + _SNAP_TOL, side="right") - 1
        return self.values[int(np.clip(k, 0, self.times.shape[0] - 1))]

    def knot_times(self):
        return self.times
