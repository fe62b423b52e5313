"""Fidelities: complex (host-side numpy) and on real operator iso-vecs
(torch, batched over leading axes, differentiable by `torch.func`)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["unitary_fidelity", "iso_vec_inner", "unitary_fidelity_iso",
           "unitary_fidelity_iso_bounded"]


def unitary_fidelity(U, U_goal):
    """|tr(U' U_goal)|^2 / n^2 (batched over leading axes)."""
    U = np.asarray(U)
    n = U.shape[-1]
    tr = np.einsum("...ij,...ij->...", np.conj(U), np.asarray(U_goal))
    return np.abs(tr) ** 2 / n ** 2


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


def unitary_fidelity_iso_bounded(x_iso, goal_iso):
    """|tr(U^dag Ug)|^2 / (n ||U||_F^2): equals `unitary_fidelity_iso` on
    the unitary manifold and is bounded by 1 off it (the NLP objective)."""
    n = int(round(np.sqrt(x_iso.shape[-1] // 2)))
    re, im = iso_vec_inner(x_iso, goal_iso)
    nrm2 = torch.clamp(torch.sum(x_iso ** 2, dim=-1), min=1e-12)
    return (re ** 2 + im ** 2) / (n * nrm2)
