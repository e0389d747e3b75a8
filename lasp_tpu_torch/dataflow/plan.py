"""The fused propagate compiler (port of ``lasp_tpu.dataflow.plan``).

A propagate's dirty closure (:func:`closure_edges`: the edges reachable
from the store's dirty set, plus never-ran edges) is leveled by
topological depth (:func:`level_groups`); within a level, edges of one
stacking signature (``Edge.signature()``) form a group whose tables and
source states stack into ``[G, ...]`` tensors (``mesh.plan.stack_group``)
and evaluate as ONE ``torch.func.vmap`` of the first member's
contribution. A group that cannot evaluate stacked is demoted to
singletons with a ``RuntimeWarning`` and its edges marked non-stackable
(:func:`guard_groups`). :func:`make_round_fn` is the Jacobi sweep over the
closure and ``ops.fused.fused_dataflow_rounds`` its fixed-point loop.

Bit-identity with the per-edge path holds by construction, as in JAX:
every contribution reads the pre-sweep states, contributions merge into
each dst in edge-index order through the one merge chain
(:func:`merge_into_dst`), change flags are ``~codec.equal``; an excluded
edge's contribution is already absorbed in its dst (idempotent join).

The built entries live in one FIFO-bounded :class:`PropagateCache` shared
with the per-edge path's subset rounds. Each compiled entry carries the
flight ring's depth (``telemetry.device.flight_rounds``) and sets the
``dataflow_plan_groups`` gauge, as JAX's.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from ..lattice.base import tree_leaves, tree_map
from ..telemetry.registry import counter

#: cache sentinel: this key failed to build or run; callers go straight to
#: the per-edge path instead of retrying the build every propagate
POISON = object()


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


class PropagateCache:
    """The one keyed, FIFO-bounded cache of a graph's built propagate
    entries: per-edge subset rounds (``("subset", idx)``) and fused
    entries (``("fused", idx)``; the round budget is an argument, never
    part of the key). Hits and builds export under
    ``dataflow_plan_cache_*`` by kind."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._entries: dict = {}

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key):
        ent = self._entries.get(key)
        if ent is not None and ent is not POISON:
            # a POISON lookup is not a hit: nothing built is reused
            counter(
                "dataflow_plan_cache_hits_total",
                help="propagate executable-cache hits (subset round fns "
                     "+ fused megakernels share one FIFO-bounded cache)",
                kind=key[0],
            ).inc()
        return ent

    def put(self, key, value) -> None:
        if len(self._entries) >= self.capacity:
            # FIFO eviction (dicts keep insertion order)
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = value
        counter(
            "dataflow_plan_cache_built_total",
            help="propagate executables built into the shared cache, "
                 "by kind (subset round fn / fused megakernel)",
            kind=key[0],
        ).inc()

    def poison(self, key) -> None:
        """Mark a fused key failed until the next graph rebuild, so later
        propagates go per-edge without re-raising the same error."""
        if len(self._entries) >= self.capacity and key not in self._entries:
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = POISON


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


def _stack_sig(edge):
    """The stacking signature of one edge, or None (never stack): its
    poison flag, its declared signature, the hashability rule; the class
    is part of the key so two edge kinds never share a group."""
    # imported here: the mesh package imports this module through its runtime
    from ..mesh.plan import hashable_signature

    if not edge.stackable:
        return None
    raw = edge.signature()
    if raw is None:
        return None
    return hashable_signature(type(edge), *raw)


def level_groups(edges, idx) -> list:
    """``[[edge_index, ...], ...]``: the closure's edges as same-signature
    groups within topological levels, ordered by (level, first edge
    index). Levels come from longest-path relaxation over the closure
    (sources at depth 0); a cyclic graph stops relaxing at the iteration
    bound, so levels stay finite and deterministic."""
    sel = [(i, edges[i]) for i in idx]
    depth: dict = {}
    for _ in range(len(sel) + 1):
        moved = False
        for _i, e in sel:
            d = 1 + max((depth.get(s, 0) for s in e.srcs), default=0)
            if depth.get(e.dst, 0) < d:
                depth[e.dst] = d
                moved = True
        if not moved:
            break
    levels: dict = {}
    for i, e in sel:
        lv = min(max((depth.get(s, 0) for s in e.srcs), default=0), len(sel))
        levels.setdefault(lv, []).append(i)
    groups: list = []
    for lv in sorted(levels):
        by_sig: dict = {}
        for i in levels[lv]:
            sig = _stack_sig(edges[i])
            by_sig.setdefault(("__solo__", i) if sig is None else sig, []).append(i)
        groups.extend(by_sig.values())
    return groups


def _stack_tables(tables, group):
    from ..mesh.plan import stack_group

    return stack_group([tables[i] for i in group])


def _stacked_contribution(edges, group, states, tabs):
    """One ``torch.func.vmap`` of the group's first member's contribution
    over the members' stacked tables ``tabs`` and source states; returns
    the ``[G, ...]`` contributions."""
    from ..mesh.plan import stack_group

    e0 = edges[group[0]]
    srcs = [
        stack_group([states[edges[i].srcs[p]] for i in group])
        for p in range(len(e0.srcs))
    ]
    return torch.func.vmap(lambda t, *s: e0.contribution(t, *s))(tabs, *srcs)


def guard_groups(edges, groups, states, tables) -> list:
    """The per-group guard: every multi-edge group must evaluate stacked.
    JAX checks shapes with ``eval_shape``; here one trial call on the
    group's real inputs (functional: it writes nothing). A group that
    fails is demoted to singletons loudly (counter + ``RuntimeWarning``)
    and its edges are marked non-stackable, so later compiles skip the
    attempt."""
    out: list = []
    for g in groups:
        if len(g) == 1:
            out.append(g)
            continue
        try:
            _stacked_contribution(edges, g, states, _stack_tables(tables, g))
            out.append(g)
        except Exception as exc:  # noqa: BLE001 — the loud-fallback contract
            for i in g:
                edges[i].stackable = False
            e0 = edges[g[0]]
            counter(
                "dataflow_plan_fallbacks_total",
                help="fused-propagate fallbacks, by reason: `stack` = a "
                     "same-signature group failed to trace stacked and "
                     "was demoted to per-edge evaluation; `dispatch` = "
                     "a fused megakernel failed to build or run and the "
                     "propagate fell back to the per-edge path",
                reason="stack",
            ).inc()
            warnings.warn(
                f"dataflow fusion: group {tuple(g)} "
                f"({type(e0).__name__}/{e0.kind}) cannot stack — demoted "
                f"to per-edge evaluation: {exc!r}",
                RuntimeWarning,
                stacklevel=2,
            )
            out.extend([i] for i in g)
    return out


def make_round_fn(edges, groups, meta, dst_order):
    """One Jacobi sweep over the closure: per group a stacked (vmapped)
    or a single contribution, all reading the PRE-sweep states, then per
    dst the merge chain in edge-index order. Returns ``round_fn(states,
    tables) -> (new_states, changed: bool[len(dst_order)])``, the per-edge
    subset round's contract.

    Where every member of a stacked group writes its own dst, which takes
    no other contribution in the closure, the group's merges run as one
    batched merge chain over the stacked dst states (the codecs are
    batch-polymorphic: the same elementwise computation), so a sweep
    issues work per group, not per edge. A group's tables are stacked once
    per ``tables`` object (once a propagate), not once a sweep."""
    from ..mesh.plan import stack_group, unstack_group

    n_in: dict = {}
    for g in groups:
        for i in g:
            n_in[edges[i].dst] = n_in.get(edges[i].dst, 0) + 1
    batched = [
        len(g) > 1
        and all(n_in[edges[i].dst] == 1 for i in g)
        and all(meta[edges[i].dst] == meta[edges[g[0]].dst] for i in g)
        for g in groups
    ]
    # changed flags come out batched groups first, then the other dsts in
    # dst_order; one gather puts them in dst_order
    order = [edges[i].dst for g, b in zip(groups, batched) if b for i in g]
    rest = [d for d in dst_order if d not in set(order)]
    order += rest
    perm = None if order == list(dst_order) else [order.index(d) for d in dst_order]
    memo: dict = {"tables": None, "stacked": None, "perm": {}}

    def stacked_tables(tables):
        if memo["tables"] is not tables:
            memo["tables"] = tables
            memo["stacked"] = [_stack_tables(tables, g) if len(g) > 1 else None
                               for g in groups]
        return memo["stacked"]

    def round_fn(states, tables):
        contribs: dict = {d: [] for d in rest}
        new_states = dict(states)
        flags = []
        for group, together, tabs in zip(groups, batched, stacked_tables(tables)):
            if len(group) == 1:
                i = group[0]
                e = edges[i]
                c = e.contribution(tables[i], *[states[s] for s in e.srcs])
                contribs[e.dst].append((i, c))
                continue
            out = _stacked_contribution(edges, group, states, tabs)
            if together:
                dsts = [edges[i].dst for i in group]
                codec, spec = meta[dsts[0]]
                cur = stack_group([states[d] for d in dsts])
                new = merge_into_dst(codec, spec, cur, [out])
                flags.append(~codec.equal(spec, cur, new))
                new_states.update(zip(dsts, unstack_group(new, len(dsts))))
                continue
            for j, i in enumerate(group):
                contribs[edges[i].dst].append(
                    (i, tree_map(lambda x, _j=j: x[_j], out))
                )
        singles = []
        for dst in rest:
            codec, spec = meta[dst]
            cur = states[dst]
            new = merge_into_dst(
                codec, spec, cur,
                [c for _i, c in sorted(contribs[dst], key=lambda t: t[0])],
            )
            singles.append(~codec.equal(spec, cur, new))
            new_states[dst] = new
        if singles:
            flags.append(torch.stack(singles))
        changed = torch.cat(flags)
        if perm is not None:
            dev = changed.device
            if dev not in memo["perm"]:
                memo["perm"][dev] = torch.tensor(perm, device=dev)
            changed = changed[memo["perm"][dev]]
        return new_states, changed

    return round_fn


@dataclasses.dataclass
class FusedPropagate:
    """One built fused entry: the fixed-point runner plus the host-side
    metadata its runs report against."""

    fn: object  # (states, tables, max_rounds) -> (states, counts, sweeps, pending)
    dst_order: tuple
    groups: tuple
    n_stacked: int  # edges served by multi-member stacked groups
    sweep_bytes: int  # bytes ONE sweep moves (analytic)


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def sweep_traffic_bytes(edges, idx, states, tables) -> int:
    """Bytes one Jacobi sweep moves: every closure edge reads its source
    states and tables; every distinct dst is read and written once."""
    total = 0
    dsts: set = set()
    for i in idx:
        e = edges[i]
        total += sum(_tree_bytes(states[s]) for s in e.srcs)
        total += _tree_bytes(tables[i])
        dsts.add(e.dst)
    total += sum(2 * _tree_bytes(states[d]) for d in dsts)
    return total


def compile_fused(graph, idx, states, tables) -> FusedPropagate:
    """Build the fused entry of one dirty closure: level and group it,
    guard the groups, close the sweep over the graph's edges and wrap it
    in ``ops.fused.fused_dataflow_rounds``. The budget is an argument of
    the entry, so one entry serves every ``max_rounds``."""
    from ..ops.fused import fused_dataflow_rounds

    edges = graph.edges
    groups = guard_groups(edges, level_groups(edges, idx), states, tables)
    dst_order: list = []
    for i in idx:
        if edges[i].dst not in dst_order:
            dst_order.append(edges[i].dst)
    meta = {d: graph._meta(d) for d in dst_order}
    round_fn = make_round_fn(edges, groups, meta, tuple(dst_order))
    n_dsts = len(dst_order)
    # per-sweep changed flags into a modulo-K flight ring, drained on the
    # syncs the propagate already performs
    from ..telemetry import gauge
    from ..telemetry.device import flight_rounds

    flight_k = flight_rounds()
    gauge(
        "dataflow_plan_groups",
        help="edge groups in the last compiled fused-propagate "
             "megakernel (same-signature edges stack into one vmapped "
             "contribution per group)",
    ).set(len(groups))
    return FusedPropagate(
        fn=lambda s, t, lim: fused_dataflow_rounds(
            round_fn, s, t, n_dsts, lim, flight_rounds=flight_k
        ),
        dst_order=tuple(dst_order),
        groups=tuple(tuple(g) for g in groups),
        n_stacked=sum(len(g) for g in groups if len(g) > 1),
        sweep_bytes=sweep_traffic_bytes(edges, idx, states, tables),
    )


__all__ = [
    "POISON",
    "FusedPropagate",
    "PropagateCache",
    "closure_edges",
    "compile_fused",
    "guard_groups",
    "level_groups",
    "make_round_fn",
    "merge_into_dst",
    "sweep_traffic_bytes",
    "tree_select",
]
