"""Control pulses: the zero-order-hold pulse of the port's paths, with the
interface of `piccolax.quantum.pulses`. Values and times may carry
leading batch axes (a batch of pulses for one batched rollout); the
host-side evaluation `__call__` / `sample` is for a single pulse."""

from __future__ import annotations

import numpy as np
import torch

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


def _as_float(x):
    return x if isinstance(x, torch.Tensor) else np.asarray(x, dtype=float)


class ZeroOrderPulse(_PulseBase):
    """u(t) = values[k] for t in [times[k], times[k+1]) (knot-snapped).

    values [..., K, d] and times [..., K] are numpy arrays or tensors."""

    def __init__(self, values, times, drive_name="u",
                 initial_value=None, final_value=None):
        values = _as_float(values)
        times = _as_float(times)
        assert values.ndim >= 2 and values.shape[-2] == times.shape[-1], (
            "values must be [..., K, n_drives] matching times [..., K]")
        d = values.shape[-1]
        self.times = times
        self.values = values
        self.initial_value = _boundary(initial_value, d)
        self.final_value = _boundary(final_value, d)
        self.drive_name = drive_name

    @property
    def duration(self):
        return self.times[..., -1]

    @property
    def n_drives(self) -> int:
        return self.values.shape[-1]

    def __call__(self, t):
        k = np.searchsorted(self.times, t + _SNAP_TOL, side="right") - 1
        return self.values[int(np.clip(k, 0, self.times.shape[0] - 1))]

    def knot_times(self):
        return self.times
