"""Solver layer of the port: NLP, KKT kernels, batched IPM."""

from . import kkt
from .ipm import IPMOptions, IPMState, solve_nlp, solve_nlp_traced
from .nlp import CollocationNLP, nlp_constraint_residuals, nlp_total_cost

__all__ = ["CollocationNLP", "IPMOptions", "IPMState", "kkt",
           "nlp_constraint_residuals", "nlp_total_cost", "solve_nlp",
           "solve_nlp_traced"]
