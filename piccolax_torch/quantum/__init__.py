"""Physics layer of the port: systems, pulses, trajectories, fidelities."""

from . import (dynamics, gates, isomorphisms, operators, pulses, systems,
               trajectories)

__all__ = ["dynamics", "gates", "isomorphisms", "operators", "pulses",
           "systems", "trajectories"]
