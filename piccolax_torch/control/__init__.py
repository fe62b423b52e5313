"""Control layer of the port: integrators, objectives, problem assembly."""

from . import constraints, integrators, objectives
from .problem import QuantumControlProblem, build_nlp
from .templates import SmoothPulseProblem

__all__ = ["QuantumControlProblem", "SmoothPulseProblem", "build_nlp",
           "constraints", "integrators", "objectives"]
