"""System templates of the port: the transmon."""

from .transmons import TransmonSystem

__all__ = ["TransmonSystem"]
