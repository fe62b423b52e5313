"""Utilities: solver checkpoints."""

from .checkpoint import load_pytree, load_solver_state, save_pytree, save_solver_state

__all__ = ["save_solver_state", "load_solver_state", "save_pytree", "load_pytree"]
