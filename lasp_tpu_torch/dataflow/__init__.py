"""Dataflow layer: the monotone combinator graph as round sweeps (port of
``lasp_tpu.dataflow``; the fused propagate megakernel is a later slice)."""

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
