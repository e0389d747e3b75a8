"""Lattice type contract: the port of ``lasp_tpu.lattice.base``.

Every CRDT type is a dense tensor codec, as in the JAX package: a static,
hashable ``Spec`` fixing the shapes, a ``State`` NamedTuple of
``torch.Tensor`` leaves, and functions ``new / merge / value / equal /
is_inflation / is_strict_inflation / threshold_met`` (reference
``src/lasp_orset.erl:32-36`` and ``src/lasp_lattice.erl``).

Where the JAX codecs are written for one replica and lifted with
``jax.vmap``, these are written batch-polymorphic: a state may carry any
number of leading replica (or group) dimensions, and every reduction runs
over the state's own trailing dimensions only. ``equal`` on two ``[R, ...]``
populations therefore returns ``bool[R]`` — the vmapped JAX call's
result — and on two single states a 0-d tensor.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, ClassVar, NamedTuple

import torch


class Threshold(NamedTuple):
    """A monotone read threshold: a lattice state plus a strictness flag
    (the reference's ``threshold() :: value() | {strict, value()}``)."""

    state: Any
    strict: bool = False


class CrdtType(abc.ABC):
    """Namespace-style contract every lattice type implements; subclasses
    are stateless collections of static functions over ``State`` tuples."""

    #: reference module this type is equivalent to (e.g. "lasp_orset")
    name: ClassVar[str] = ""

    #: "or" / "max" when ``merge`` is that same elementwise join on every
    #: leaf (the fused gossip fast paths and the CUDA kernels key on it);
    #: None when merge has structure
    leafwise_join: ClassVar["str | None"] = None

    @staticmethod
    @abc.abstractmethod
    def new(spec, device=None) -> Any:
        """Bottom element of the lattice for this spec (``Type:new/0``)."""

    @staticmethod
    @abc.abstractmethod
    def merge(spec, a, b) -> Any:
        """Join (least upper bound) of two states (``Type:merge/2``)."""

    @staticmethod
    @abc.abstractmethod
    def value(spec, state) -> Any:
        """Observable value of the state (``Type:value/1``)."""

    @staticmethod
    @abc.abstractmethod
    def equal(spec, a, b) -> torch.Tensor:
        """bool over the batch dims: state equality (``Type:equal/2``)."""

    @staticmethod
    @abc.abstractmethod
    def is_inflation(spec, prev, cur) -> torch.Tensor:
        """``cur`` >= ``prev`` in the lattice order."""

    @staticmethod
    @abc.abstractmethod
    def is_strict_inflation(spec, prev, cur) -> torch.Tensor:
        """``cur`` > ``prev`` strictly."""

    @classmethod
    def threshold_met(cls, spec, state, threshold: Threshold) -> torch.Tensor:
        """Default threshold semantics: (strict) inflation beyond the
        threshold state (``src/lasp_lattice.erl:62-85``)."""
        if threshold.strict:
            return cls.is_strict_inflation(spec, threshold.state, state)
        return cls.is_inflation(spec, threshold.state, state)

    @staticmethod
    def stats(spec, state) -> dict:
        return {}


def all_trailing(x: torch.Tensor, nd: int) -> torch.Tensor:
    """``all`` over the last ``nd`` dims (the state's own dims), keeping
    every leading batch dim."""
    if nd == 0:
        return x
    return x.reshape(x.shape[: x.dim() - nd] + (-1,)).all(dim=-1)


def any_trailing(x: torch.Tensor, nd: int) -> torch.Tensor:
    if nd == 0:
        return x
    return x.reshape(x.shape[: x.dim() - nd] + (-1,)).any(dim=-1)


def tree_map(fn, tree, *rest):
    """Leafwise map over one or more same-structure states. A state is a
    NamedTuple whose fields are tensors, ``None`` (passed through) or
    tuples of states (a map's embedded fields and tombstones, recursed
    into); a plain tuple keeps its type, a NamedTuple its class."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        children = [tree_map(fn, *parts) for parts in zip(tree, *rest)]
        if hasattr(tree, "_fields"):
            return type(tree)(*children)
        return tuple(children)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a state in field order, depth first, ``None``
    skipped."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in tree_leaves(part)]
    return [tree]


def tree_unflatten(template, leaves):
    """A state shaped like ``template`` whose leaves are ``leaves`` in
    :func:`tree_leaves` order (``None`` fields stay ``None``)."""
    leaves = list(leaves)
    if len(leaves) != len(tree_leaves(template)):
        raise ValueError(
            f"tree_unflatten: {len(leaves)} leaves for a "
            f"{type(template).__name__} of {len(tree_leaves(template))}"
        )
    it = iter(leaves)
    return tree_map(lambda _x: next(it), template)


def _structure(tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return (type(tree), tuple(_structure(t) for t in tree))
    return "leaf"


def tree_all_equal(a, b) -> torch.Tensor:
    """0-d bool: every leaf of two same-structure states is elementwise
    equal."""
    if _structure(a) != _structure(b):
        raise ValueError(
            f"tree_all_equal: mismatched state types {type(a).__name__} "
            f"vs {type(b).__name__}"
        )
    la, lb = tree_leaves(a), tree_leaves(b)
    acc = torch.ones((), dtype=torch.bool, device=la[0].device)
    for x, y in zip(la, lb):
        acc = acc & torch.all(x == y)
    return acc


def replicate(state, n_replicas: int):
    """Copy a single-replica state onto a leading replica axis. The copy
    owns its storage (not an expanded view): the runtime updates rows in
    place."""
    return tree_map(
        lambda leaf: leaf.unsqueeze(0).expand((n_replicas,) + tuple(leaf.shape))
        .contiguous(),
        state,
    )


@dataclasses.dataclass(frozen=True)
class TypeRegistry:
    """Maps reference type names to codec classes."""

    types: tuple = ()

    def get(self, name: str) -> type:
        for t in self.types:
            if t.name == name or t.__name__ == name:
                return t
        raise KeyError(f"unknown lattice type: {name}")
