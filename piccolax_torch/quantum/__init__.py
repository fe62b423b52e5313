"""Physics layer of the port: systems, pulses, trajectories, fidelities."""

from . import dynamics, gates, isomorphisms, pulses, systems, trajectories

__all__ = ["dynamics", "gates", "isomorphisms", "pulses", "systems",
           "trajectories"]
