"""Dataflow graph engine: combinators as round sweeps to a fixed point (port
of ``lasp_tpu.dataflow.engine``).

The reference runs one Erlang process per dataflow edge per replica, each
blocking on a strict-threshold read and re-binding its output
(``src/lasp_process.erl:61-95``). Here the graph is swept synchronously:
one round evaluates every edge's contribution against the *current* states
(Jacobi iteration) and merges the contributions into each output through
the inflation gate (the ``bind`` rule, ``src/lasp_core.erl:291-312``).
Joins are associative, commutative and idempotent, so this reaches the
reference's fixed point; a depth-k pipeline converges in k rounds.

``propagate`` runs the dirty closure through the fused fixed point by
default (``"auto"`` / ``"fused"``: ``dataflow.plan``, stacked per-level
contributions with one host sync a block of sweeps) or the per-edge
frontier loop (``"per_edge"``); both give the same values and round
counts.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import torch

from ..lattice.gset import GSetSpec
from ..lattice.orset import ORSetSpec
from ..ops import fused as fused_ops
from ..utils.interning import Interner
from . import plan as dplan
from .edges import BindToEdge, Edge, PairwiseEdge, ProductEdge, ProjectEdge
from .plan import merge_into_dst


class PairUniverse:
    """Element universe of a product output: term (x, y) <-> index
    lx * ER + ry over the input interners — no separate allocation (a copy
    of ``lasp_tpu.dataflow.engine.PairUniverse``)."""

    def __init__(self, l_elems, r_elems, er_cap: int):
        self.l_elems = l_elems
        self.r_elems = r_elems
        self.er_cap = er_cap

    def __len__(self) -> int:
        return len(self.l_elems) * len(self.r_elems)

    def __contains__(self, term) -> bool:
        # a non-pair term is simply not a member (an intersection between a
        # product output and a plain set probes with plain terms)
        if not (isinstance(term, tuple) and len(term) == 2):
            return False
        x, y = term
        return x in self.l_elems and y in self.r_elems

    def index_of(self, term) -> int:
        x, y = term
        return self.l_elems.index_of(x) * self.er_cap + self.r_elems.index_of(y)

    def terms(self) -> list:
        return [(x, y) for x in self.l_elems.terms() for y in self.r_elems.terms()]

    def decode_mask(self, mask) -> frozenset:
        out = []
        nl, nr = len(self.l_elems.terms()), len(self.r_elems.terms())
        for i, hit in enumerate(mask):
            if not hit:
                continue
            lx, ry = divmod(i, self.er_cap)
            if lx < nl and ry < nr:
                out.append((self.l_elems.term_of(lx), self.r_elems.term_of(ry)))
        return frozenset(out)


class Graph:
    """Static combinator graph over a :class:`~lasp_tpu_torch.store.Store`.

    Mirrors the reference verb set ``map / filter / fold / union /
    intersection / product / bind_to`` (``src/lasp.erl:252-337``);
    ``propagate`` replaces the background processes with explicit rounds to
    the fixed point."""

    def __init__(self, store):
        self.store = store
        self.edges: list[Edge] = []
        #: the whole-graph round ``round_fn(states, tables) -> states``,
        #: built by :meth:`_build`; the replicated runtime sweeps it over
        #: its populations
        self._round_fn = None
        self._var_ids: tuple = ()
        self._clean_mark: "tuple | None" = None  # (store.mutations, n_edges)
        #: has edge i contributed at least once since the last _build?
        self._edge_ran: list = []
        #: default propagate scheduling (see :meth:`propagate`)
        self.fusion: str = "auto"
        #: built subset rounds and fused entries, keyed by edge indices
        self._cache = dplan.PropagateCache()
        #: the last propagate's path ("fused" / "per_edge"), the sweeps it
        #: executed and the host syncs they took (the bench's A/B reads it)
        self.last_propagate: dict = {}
        #: store.mutations value whose writes this graph has propagated
        self._dirty_cursor: int = 0

    # -- derived-output declaration -----------------------------------------
    @staticmethod
    def _derived_orset_spec(n_elems: int, token_space: int) -> ORSetSpec:
        return ORSetSpec(
            n_elems=n_elems, n_actors=1, tokens_per_actor=1, token_space=token_space
        )

    def _ensure_output(self, dst, type_name, spec, elems):
        """Declare (or re-layout) the output variable with the derived spec
        dictated by the edge's input spaces."""
        store = self.store
        if dst is None:
            return store.declare(type=type_name, spec=spec, elems=elems)
        if dst in store.ids():
            var = store.variable(dst)
            if var.spec == spec and var.type_name == type_name:
                # layout already matches: adopt universes, keep the state
                self._adopt_universe(var, elems)
                return dst
            if var.elems is not elems or var.spec != spec:
                # an edge wired to the old layout would keep stale tables
                for e in self.edges:
                    if dst in e.srcs or dst == e.dst:
                        raise RuntimeError(
                            f"cannot re-layout {dst}: already wired into a "
                            f"dataflow edge; declare a fresh output instead"
                        )
                store.redeclare_derived(dst, type_name, spec, elems)
            return dst
        return store.declare(id=dst, type=type_name, spec=spec, elems=elems)

    @staticmethod
    def _adopt_universe(var, elems) -> None:
        """Re-wiring an edge onto an existing same-layout output: a fresh
        empty Interner loses to the variable's existing one; a non-empty
        universe (a filter's or bind_to's source interner, a product's
        PairUniverse) is adopted after checking that indices agree."""
        if elems is None or var.elems is elems:
            return
        if isinstance(elems, Interner) and len(elems) == 0:
            return  # fresh mint: keep the existing one
        for term in var.elems.terms() if hasattr(var.elems, "terms") else ():
            if term not in elems or elems.index_of(term) != var.elems.index_of(term):
                raise RuntimeError(
                    f"cannot adopt universe for {var.id}: existing term "
                    f"{term!r} is missing or re-indexed in the source universe"
                )
        var.elems = elems

    def _add(self, edge: Edge) -> str:
        self.edges.append(edge)
        self._round_fn = None
        return edge.dst

    # -- combinator verbs ---------------------------------------------------
    def map(self, src: str, fn, dst: "str | None" = None,
            dst_elems: "int | None" = None):
        """``lasp:map/3`` (``src/lasp.erl:282-285``)."""
        return self._project("map", src, fn, dst, dst_elems)

    def fold(self, src: str, fn, dst: "str | None" = None,
             dst_elems: "int | None" = None):
        """``lasp:fold/3`` — flat-map (``src/lasp.erl:270-273``)."""
        return self._project("fold", src, fn, dst, dst_elems)

    def filter(self, src: str, fn, dst: "str | None" = None):
        """``lasp:filter/3`` (``src/lasp.erl:258-261``)."""
        return self._project("filter", src, fn, dst, None)

    def _project(self, kind, src, fn, dst, dst_elems):
        store = self.store
        src_var = store.variable(src)
        spec = src_var.spec
        if isinstance(spec, ORSetSpec):
            if kind == "filter":
                out_spec = dataclasses.replace(spec, token_space=spec.n_tokens)
            else:
                d_elems = dst_elems or spec.n_elems * (4 if kind == "fold" else 1)
                out_spec = self._derived_orset_spec(
                    d_elems, spec.n_elems * spec.n_tokens
                )
        elif isinstance(spec, GSetSpec):
            d_elems = (
                spec.n_elems
                if kind == "filter"
                else dst_elems or spec.n_elems * (4 if kind == "fold" else 1)
            )
            out_spec = GSetSpec(n_elems=d_elems)
        else:
            raise TypeError(f"{kind}: unsupported spec {spec!r}")
        if kind == "filter":
            elems = src_var.elems  # same universe, shared interner
        else:
            elems = Interner(out_spec.n_elems, kind="element")
        dst = self._ensure_output(dst, src_var.type_name, out_spec, elems)
        return self._add(ProjectEdge(kind, src, dst, fn, store))

    def union(self, left: str, right: str, dst: "str | None" = None):
        """``lasp:union/3`` (``src/lasp.erl:306-309``)."""
        return self._pairwise("union", left, right, dst)

    def intersection(self, left: str, right: str, dst: "str | None" = None):
        """``lasp:intersection/3`` (``src/lasp.erl:294-297``)."""
        return self._pairwise("intersection", left, right, dst)

    def _pairwise(self, kind, left, right, dst):
        store = self.store
        l_var, r_var = store.variable(left), store.variable(right)
        ls, rs = l_var.spec, r_var.spec
        if isinstance(ls, ORSetSpec):
            n = ls.n_elems + rs.n_elems if kind == "union" else ls.n_elems
            out_spec = self._derived_orset_spec(n, ls.n_tokens + rs.n_tokens)
        else:
            n = ls.n_elems + rs.n_elems if kind == "union" else ls.n_elems
            out_spec = GSetSpec(n_elems=n)
        elems = Interner(out_spec.n_elems, kind="element")
        dst = self._ensure_output(dst, l_var.type_name, out_spec, elems)
        return self._add(PairwiseEdge(kind, left, right, dst, store))

    def product(self, left: str, right: str, dst: "str | None" = None):
        """``lasp:product/3`` (``src/lasp.erl:318-321``)."""
        store = self.store
        l_var, r_var = store.variable(left), store.variable(right)
        ls, rs = l_var.spec, r_var.spec
        if isinstance(ls, ORSetSpec):
            out_spec = self._derived_orset_spec(
                ls.n_elems * rs.n_elems, ls.n_tokens * rs.n_tokens
            )
        else:
            out_spec = GSetSpec(n_elems=ls.n_elems * rs.n_elems)
        elems = PairUniverse(l_var.elems, r_var.elems, rs.n_elems)
        dst = self._ensure_output(dst, l_var.type_name, out_spec, elems)
        return self._add(ProductEdge(left, right, dst, store))

    def bind_to(self, dst: str, src: str):
        """``lasp:bind_to/2`` — dst follows src (``src/lasp.erl:201-207``).
        Argument order mirrors the reference (target first)."""
        store = self.store
        src_var = store.variable(src)
        dst = self._ensure_output(dst, src_var.type_name, src_var.spec, src_var.elems)
        dst_var = store.variable(dst)
        if dst_var.ivar_payloads is not None and (
            dst_var.ivar_payloads is not src_var.ivar_payloads
        ):
            # dst adopts src's payload interner so interned ids agree; only
            # sound while dst is still bottom
            bottom = dst_var.codec.new(dst_var.spec, device=store.device)
            if not bool(dst_var.codec.equal(dst_var.spec, dst_var.state, bottom)):
                raise RuntimeError(
                    f"bind_to: {dst} already holds a value minted against its "
                    "own payload universe; bind_to requires a bottom target"
                )
            dst_var.ivar_payloads = src_var.ivar_payloads
        return self._add(BindToEdge(src, dst, store))

    # -- provenance -----------------------------------------------------------
    def lineage(self, var_id: str) -> dict:
        """Transitive upstream provenance of ``var_id`` through the edges:
        ``{derived_var: {"kinds": [...], "srcs": [...]}}`` for every edge
        output on some path into ``var_id`` (itself included when
        derived)."""
        by_dst: dict = {}
        for e in self.edges:
            by_dst.setdefault(e.dst, []).append(e)
        out: dict = {}
        frontier, visited = [var_id], set()
        while frontier:
            v = frontier.pop()
            if v in visited:
                continue
            visited.add(v)
            for e in by_dst.get(v, ()):
                d = e.describe()
                ent = out.setdefault(v, {"kinds": [], "srcs": []})
                ent["kinds"].append(d["kind"])
                for s in d["srcs"]:
                    if s not in ent["srcs"]:
                        ent["srcs"].append(s)
                    frontier.append(s)
        return out

    # -- rounds ---------------------------------------------------------------
    def refresh(self) -> None:
        """Host pass: fold newly interned terms into edge tables, looping
        until universes stop growing (chained edges feed each other)."""
        for _ in range(len(self.edges) + 2):
            changed = [e.refresh(self.store) for e in self.edges]  # no short-circuit
            if not any(changed):
                return
        raise RuntimeError("edge table refresh did not reach a fixed point")

    def device_tables(self, device) -> tuple:
        """Every edge's tables on ``device``, in edge order."""
        return tuple(e.device_tables(device) for e in self.edges)

    def _meta(self, var_id):
        var = self.store.variable(var_id)
        return var.codec, var.spec

    def _build(self):
        """The whole-graph round over every edge. Its residual (the JAX
        round's count of changed outputs) has no reader, so the round
        returns the new states only."""
        edges = tuple(self.edges)
        ids = []
        for e in edges:
            for v in (*e.srcs, e.dst):
                if v not in ids:
                    ids.append(v)
        self._var_ids = tuple(ids)
        meta = {v: self._meta(v) for v in ids}

        def round_fn(states, tables):
            contribs: dict = {}
            for e, tab in zip(edges, tables):
                c = e.contribution(tab, *[states[s] for s in e.srcs])
                contribs.setdefault(e.dst, []).append(c)
            new_states = dict(states)
            for dst, cs in contribs.items():
                codec, spec = meta[dst]
                new_states[dst] = merge_into_dst(codec, spec, states[dst], cs)
            return new_states

        self._round_fn = round_fn
        # every edge owes one run against the rebuilt tables; the cache is
        # keyed by edge indices, which a rebuild may have re-meant
        self._edge_ran = [False] * len(edges)
        self._cache = dplan.PropagateCache()

    def _subset_round(self, idx: tuple):
        """The sweep over ONLY the edges named by ``idx`` (indices into
        ``self.edges``): the frontier-scheduled round. Skipped edges'
        contributions are unchanged since their last run and already merged
        into their dst (idempotent join). Returns ``(fn, dst_order)`` with
        ``fn(states, tables) -> (new_states, changed: list[bool])``, kept
        in the graph's :class:`~.plan.PropagateCache`."""
        key = ("subset", idx)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        sel = [(i, self.edges[i]) for i in idx]
        dst_order: list = []
        for _i, e in sel:
            if e.dst not in dst_order:
                dst_order.append(e.dst)
        meta = {v: self._meta(v) for v in dst_order}

        def round_fn(states, tables):
            contribs: dict = {}
            for i, e in sel:
                c = e.contribution(tables[i], *[states[s] for s in e.srcs])
                contribs.setdefault(e.dst, []).append(c)
            new_states = dict(states)
            changed = []
            for dst in dst_order:
                codec, spec = meta[dst]
                cur = states[dst]
                new = merge_into_dst(codec, spec, cur, contribs[dst])
                changed.append(~codec.equal(spec, cur, new))
                new_states[dst] = new
            return new_states, torch.stack(changed).tolist()  # one host sync

        out = (round_fn, tuple(dst_order))
        self._cache.put(key, out)
        return out

    def propagate(self, max_rounds: "int | None" = None,
                  mode: "str | None" = None) -> int:
        """Run rounds to the fixed point and ingest the results into the
        store (waking threshold watches). Returns the number of rounds that
        performed work.

        ``mode`` (default ``self.fusion`` = ``"auto"``):

        - ``"auto"`` / ``"fused"``: the dirty closure (the edges reachable
          from the store's dirty set, plus never-ran edges) runs as one
          fused fixed point (``dataflow.plan``): leveled, same-signature
          edges stacked into one vmapped contribution per group, sweeps in
          blocks with one host sync a block. ``"auto"`` falls back to the
          per-edge loop with a ``RuntimeWarning`` when the fused path
          fails (the key is then poisoned); ``"fused"`` raises.
        - ``"per_edge"``: each sweep evaluates only the edges whose
          sources moved, with one host sync a sweep.

        Both give the same values and round counts."""
        if not self.edges:
            return 0
        if self._clean_mark == (self.store.mutations, len(self.edges)):
            return 0  # nothing written since the last fixed point
        mode = self.fusion if mode is None else mode
        if mode not in ("auto", "fused", "per_edge"):
            raise ValueError(
                f"unknown propagate mode {mode!r} (expected auto/fused/per_edge)"
            )
        self.refresh()
        if self._round_fn is None:
            self._build()
        tables = self.device_tables(self.store.device)
        states = {v: self.store.state(v) for v in self._var_ids}
        limit = max_rounds if max_rounds is not None else len(self.edges) + 1
        dirty = self.store.dirty_since(self._dirty_cursor) & set(self._var_ids)
        #: sweeps each edge was evaluated in by this propagate
        self._runs = [0] * len(self.edges)
        rounds = None
        if mode != "per_edge":
            rounds = self._propagate_fused(
                states, tables, dirty, limit, strict=(mode == "fused")
            )
        if rounds is None:
            rounds = self._propagate_per_edge(states, tables, dirty, limit)
        pre_ingest = self.store.mutations
        writes = self.store.ingest(states)
        if self.store.mutations == pre_ingest + writes:
            # ingest's own writes ARE the fixed point: mark clean and move
            # this graph's dirty cursor past them
            self._clean_mark = (self.store.mutations, len(self.edges))
            self._dirty_cursor = self.store.mutations
        else:
            # a watch callback wrote during ingest; stay dirty
            self._clean_mark = None
        self._emit_deep_provenance()
        return rounds

    def _emit_deep_provenance(self) -> None:
        """The deep tier of JAX's propagate record
        (``lasp_tpu/dataflow/engine.py:733-739``): per edge, its sources,
        destination and the sweeps it ran, the trail the CLI's ``trace
        --var --deep`` reconstructs values from. (JAX's coarse
        ``propagate`` event and per-kind counters are not carried.)"""
        from ..telemetry import events as tel_events

        if not tel_events.deep_enabled():
            return
        for i, e in enumerate(self.edges):
            d = e.describe()
            tel_events.emit_deep(
                "edge_recompute", var=d["dst"], kind=d["kind"],
                srcs=d["srcs"], sweeps=self._runs[i],
            )

    def _propagate_fused(self, states, tables, dirty, limit, strict: bool):
        """The fused body: build (or fetch) the dirty closure's entry and
        run the whole fixed point. Updates ``states`` in place and returns
        the productive rounds, or None to fall back to the per-edge loop
        (only before any state was replaced: the entry is functional)."""
        idx = dplan.closure_edges(self.edges, self._edge_ran, dirty)
        if not idx:
            self.last_propagate = {"path": "fused", "sweeps": 0, "host_syncs": 0}
            return 0  # empty frontier: no edge can move
        key = ("fused", idx)
        ent = self._cache.get(key)
        if ent is dplan.POISON:
            if strict:
                raise RuntimeError(
                    "fused propagate for this dirty pattern previously "
                    "failed to build; mode='fused' refuses the fallback"
                )
            return None
        from ..telemetry import counter

        t0 = time.perf_counter()
        try:
            if ent is None:
                ent = dplan.compile_fused(self, idx, states, tables)
                self._cache.put(key, ent)
            out = ent.fn(states, tables, limit)
        except Exception as exc:  # noqa: BLE001 — the loud-fallback contract
            self._cache.poison(key)
            counter(
                "dataflow_plan_fallbacks_total",
                help="fused-propagate fallbacks, by reason: `stack` = a "
                     "same-signature group failed to trace stacked and "
                     "was demoted to per-edge evaluation; `dispatch` = "
                     "a fused megakernel failed to build or run and the "
                     "propagate fell back to the per-edge path",
                reason="dispatch",
            ).inc()
            if strict:
                raise
            warnings.warn(
                f"fused propagate fell back to the per-edge path "
                f"(dirty closure {idx}): {exc!r}",
                RuntimeWarning,
                stacklevel=3,
            )
            return None
        secs = time.perf_counter() - t0
        new_states, _counts, sweeps, pending = out[:4]
        self._drain_propagate(ent, idx, out[4] if len(out) > 4 else None,
                              sweeps, pending, secs)
        for i in idx:
            self._edge_ran[i] = True
            self._runs[i] = sweeps
        self.last_propagate = {
            "path": "fused", "sweeps": sweeps,
            "host_syncs": -(-sweeps // fused_ops.DATAFLOW_BLOCK),
        }
        states.update({v: new_states[v] for v in ent.dst_order})
        if pending:
            raise RuntimeError(
                f"dataflow did not converge within {limit} "
                "rounds (cyclic graph? raise max_rounds)"
            )
        # the loop stops right after its first unproductive sweep (the
        # convergence check), so rounds = sweeps - 1
        return max(sweeps - 1, 0)

    @staticmethod
    def _drain_propagate(ent, idx, ring, sweeps: int, pending: bool,
                         secs: float) -> None:
        """The fused propagate's flight drain and ledger row: the per-sweep
        changed-flag ring into the window log (``dataflow_fused``) and one
        ``dataflow_fused`` ledger record, its joins the exact (dst, sweep)
        inflations when the ring kept every sweep."""
        from ..telemetry import device as tel_flight
        from ..telemetry import registry as tel_registry
        from ..telemetry.roofline import get_ledger

        joins = len(idx) * sweeps
        if ring is not None and tel_registry.enabled():
            records, overwritten = tel_flight.decode_ring(ring, sweeps)
            if not overwritten:
                joins = sum(sum(r) for r in records)
            tel_flight.record_window(tel_flight.FlightWindow(
                family="dataflow_fused",
                columns=tuple(ent.dst_order),
                rounds=sweeps,
                overwritten=overwritten,
                records=records,
                seconds=secs,
                quiescent=not pending,
            ))
        get_ledger().record(
            "dataflow_fused", "Graph",
            n_replicas=1, fanout=len(idx), seconds=secs,
            row_bytes=ent.sweep_bytes, window=sweeps, rounds=sweeps,
            bytes_moved=ent.sweep_bytes * sweeps,
            joins=joins, n_vars=len(idx),
        )

    def _propagate_per_edge(self, states, tables, dirty, limit) -> int:
        """Each sweep runs ONLY the edges whose sources moved — seeded from
        the store's dirty set, then from the dsts the previous sweep
        changed. Updates ``states`` in place; returns the productive
        rounds."""
        cur = states
        rounds = sweeps = 0
        for _ in range(limit):
            eligible = tuple(
                i
                for i, e in enumerate(self.edges)
                if not self._edge_ran[i] or (dirty & set(e.srcs))
            )
            if not eligible:
                break  # empty frontier: no edge can move
            fn, dst_order = self._subset_round(eligible)
            cur, changed = fn(cur, tables)
            sweeps += 1
            for i in eligible:
                self._edge_ran[i] = True
                self._runs[i] += 1
            dirty = {d for d, c in zip(dst_order, changed) if c}
            if not dirty:
                break
            rounds += 1
        else:
            raise RuntimeError(
                f"dataflow did not converge within {limit} "
                "rounds (cyclic graph? raise max_rounds)"
            )
        self.last_propagate = {
            "path": "per_edge", "sweeps": sweeps, "host_syncs": sweeps,
        }
        states.update(cur)
        return rounds


__all__ = ["Graph", "PairUniverse"]
