"""Shared pieces of the dataflow round builders (port of the helpers of
``lasp_tpu.dataflow.plan``): the inflation-gated merge chain every round
folds its contributions through, and the dirty closure of a propagate.

The fused propagate megakernel of the JAX module (``level_groups``,
``guard_groups``, ``make_round_fn``, ``compile_fused``, ``PropagateCache``)
is a later slice of the port; ``Graph.propagate`` runs the per-edge loop,
which gives the same values and round counts.
"""

from __future__ import annotations

import torch

from ..lattice.base import tree_map


def tree_select(pred: torch.Tensor, a, b):
    """Per-leaf ``where`` over same-type states, ``pred`` over the leading
    (batch) dims broadcast onto each leaf's own dims: the inflation gate,
    the ``bind`` rule's accept / ignore select."""

    def sel(x, y):
        p = pred.reshape(tuple(pred.shape) + (1,) * (x.dim() - pred.dim()))
        return torch.where(p, x, y)

    return tree_map(sel, a, b)


def merge_into_dst(codec, spec, cur, contribs):
    """The one per-dst merge chain: fold the contributions into ``cur`` in
    the given order — join, then accept through the inflation gate (the
    ``bind`` rule, ``src/lasp_core.erl:301-311``)."""
    new = cur
    for c in contribs:
        merged = codec.merge(spec, new, c)
        new = tree_select(codec.is_inflation(spec, new, merged), merged, new)
    return new


def closure_edges(edges, edge_ran, dirty) -> tuple:
    """Indices of every edge that could become eligible during a
    propagate: the forward closure of the initially-dirty variables
    through the DAG, plus never-ran edges. Index-sorted."""
    dirty = set(dirty)
    src_sets = [set(e.srcs) for e in edges]
    sel: set = set()
    moved = True
    while moved:
        moved = False
        for i, e in enumerate(edges):
            if i in sel:
                continue
            if not edge_ran[i] or (dirty & src_sets[i]):
                sel.add(i)
                dirty.add(e.dst)
                moved = True
    return tuple(sorted(sel))


__all__ = ["closure_edges", "merge_into_dst", "tree_select"]
