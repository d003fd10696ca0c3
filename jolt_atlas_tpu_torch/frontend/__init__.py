from .graph import ComputationGraph, ComputationNode, Model, Trace
from .builder import ModelBuilder
from . import ops

__all__ = ["ComputationGraph", "ComputationNode", "Model", "Trace",
           "ModelBuilder", "ops"]
