"""Lattice layer: dense CRDT codecs over torch tensors (port of
``lasp_tpu.lattice``): the six reference types plus the CRDT map."""

from .base import (
    CrdtType,
    Threshold,
    TypeRegistry,
    replicate,
    tree_all_equal,
    tree_map,
)
from .gcounter import GCounter, GCounterSpec, GCounterState
from .gset import GSet, GSetSpec, GSetState
from .ivar import IVar, IVarSpec, IVarState
from .map import CrdtMap, MapSpec, MapState
from .orset import ORSet, ORSetSpec, ORSetState
from .orswot import ORSWOT, ORSWOTSpec, ORSWOTState

#: ``lasp_orset_gbtree`` is semantically identical to ``lasp_orset``
ORSetGbtree = type("ORSetGbtree", (ORSet,), {"name": "lasp_orset_gbtree"})

REGISTRY = TypeRegistry(
    types=(IVar, GSet, ORSet, ORSetGbtree, GCounter, ORSWOT, CrdtMap)
)


def get_type(name: str):
    """Resolve a reference type name (e.g. ``"lasp_orset"``) to its codec."""
    return REGISTRY.get(name)


__all__ = [
    "CrdtType",
    "Threshold",
    "TypeRegistry",
    "replicate",
    "tree_all_equal",
    "tree_map",
    "CrdtMap",
    "MapSpec",
    "MapState",
    "IVar",
    "IVarSpec",
    "IVarState",
    "GSet",
    "GSetSpec",
    "GSetState",
    "ORSet",
    "ORSetGbtree",
    "ORSetSpec",
    "ORSetState",
    "GCounter",
    "GCounterSpec",
    "GCounterState",
    "ORSWOT",
    "ORSWOTSpec",
    "ORSWOTState",
    "REGISTRY",
    "get_type",
]
