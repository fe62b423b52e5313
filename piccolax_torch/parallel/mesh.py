"""Batched solves of problems that share their structure and differ in
their data (robustness ensembles, calibration sweeps): the counterpart of
`piccolax.parallel.mesh.batch_solve` on one card, where the batch is the
IPM's own batch dimension."""

from __future__ import annotations

# the module, not its names: solver.ipm imports this package (K9)
from ..solver import ipm

__all__ = ["batch_solve"]


def batch_solve(nlp, params_batch, Z0_batch, g0_batch=None,
                options=None, mesh=None, device=None):
    """Solve a batch of collocation NLPs (shared structure; params and
    initial guesses [B, N, dz] per problem) in one batched `solve_nlp` on
    `device` (the card unless the caller passes "cpu").

    params_batch: the solver params with a leading batch axis of B on any
    leaf (solver/nlp.py); leaves without one are shared. Returns the
    batched IPMState. A device mesh (`mesh`) is not ported: the batch
    runs on one card."""
    if mesh is not None:
        raise NotImplementedError("batch_solve over a device mesh")
    return ipm.solve_nlp(nlp, params_batch, Z0_batch, g0_batch,
                         options=options or ipm.IPMOptions(), device=device)
