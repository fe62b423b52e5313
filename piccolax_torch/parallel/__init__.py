"""Knot-partitioned KKT solves: the port of `piccolax.parallel.sharded_kkt`
on one card (kernel K9)."""

from .sharded_kkt import (batched_sharded_spd_tridiag_solve,  # noqa: F401
                          knot_condensed_factor, knot_condensed_solve,
                          sharded_spd_tridiag_solve, spd_tridiag_solve_ref)

__all__ = ["batched_sharded_spd_tridiag_solve", "knot_condensed_factor",
           "knot_condensed_solve", "sharded_spd_tridiag_solve",
           "spd_tridiag_solve_ref"]
