"""Physics layer of the port: systems, pulses, trajectories, fidelities."""

from . import (dynamics, gates, isomorphisms, operators, pulses, systems,
               templates, trajectories)
from .operators import EmbeddedOperator
from .templates import TransmonSystem

__all__ = ["EmbeddedOperator", "TransmonSystem", "dynamics", "gates",
           "isomorphisms", "operators", "pulses", "systems", "templates",
           "trajectories"]
