"""The transmon system template of `piccolax.quantum.templates.transmons`
(numpy and scipy only), with the same Hamiltonians."""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

from ..operators import annihilate
from ..systems import QuantumSystem

__all__ = ["TransmonSystem"]


def TransmonSystem(*, omega: float = 4.0, delta: float = 0.2, levels: int = 3,
                   lab_frame: bool = False, frame_omega: float | None = None,
                   multiply_by_2pi: bool = True,
                   lab_frame_type: str = "duffing", drives: bool = True,
                   drive_bounds=None) -> QuantumSystem:
    """Anharmonic-oscillator transmon: H = w a'a - d/2 a'a'aa (rotating frame)
    with X/Y drives a+a', i(a-a')."""
    assert lab_frame_type in ("duffing", "quartic", "cosine")
    if frame_omega is None:
        frame_omega = 0.0 if lab_frame else omega
    if lab_frame:
        frame_omega = 0.0
    if abs(frame_omega) > 1e-12:
        lab_frame = False

    a = annihilate(levels)
    ad = a.conj().T
    if lab_frame:
        if lab_frame_type == "duffing":
            H_drift = omega * ad @ a - delta / 2 * ad @ ad @ a @ a
        elif lab_frame_type == "quartic":
            w0 = omega + delta
            x = a + ad
            H_drift = w0 * ad @ a - delta / 12 * np.linalg.matrix_power(x, 4)
        else:  # cosine
            w0 = omega + delta
            E_C = delta
            E_J = w0 ** 2 / (8 * E_C)
            n_hat = 1j / 2 * (E_J / (2 * E_C)) ** 0.25 * (a - ad)
            phi_hat = (2 * E_C / E_J) ** 0.25 * (a + ad)
            H_drift = 4 * E_C * n_hat @ n_hat - E_J * sla.cosm(phi_hat)
    else:
        H_drift = (omega - frame_omega) * ad @ a - delta / 2 * ad @ ad @ a @ a

    H_drives = [a + ad, 1j * (a - ad)] if drives else []
    if multiply_by_2pi:
        H_drift = 2 * np.pi * H_drift
        H_drives = [2 * np.pi * H for H in H_drives]
    if drive_bounds is None:
        drive_bounds = 1.0 if H_drives else None
    return QuantumSystem(H_drift, H_drives, drive_bounds)
