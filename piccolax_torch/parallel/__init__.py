"""Batched solves of problems that differ in their data (`batch_solve`),
and knot-partitioned KKT solves: the port of `piccolax.parallel` on one
card (kernel K9)."""

from .mesh import batch_solve  # noqa: F401
from .sharded_kkt import (batched_sharded_spd_tridiag_solve,  # noqa: F401
                          knot_condensed_factor, knot_condensed_solve,
                          sharded_spd_tridiag_solve, spd_tridiag_solve_ref)

__all__ = ["batch_solve", "batched_sharded_spd_tridiag_solve", "knot_condensed_factor",
           "knot_condensed_solve", "sharded_spd_tridiag_solve",
           "spd_tridiag_solve_ref"]
