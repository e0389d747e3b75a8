"""Dataflow layer: the monotone combinator graph as round sweeps, with the
fused propagate (port of ``lasp_tpu.dataflow``)."""

from .edges import BindToEdge, Edge, PairwiseEdge, ProductEdge, ProjectEdge
from .engine import Graph, PairUniverse

__all__ = [
    "BindToEdge",
    "Edge",
    "Graph",
    "PairUniverse",
    "PairwiseEdge",
    "ProductEdge",
    "ProjectEdge",
]
