"""Variable store: the single-replica runtime core (port of
``lasp_tpu.store.store``; reference ``lasp_core.erl``).

Ported: ``declare`` (``src/lasp_core.erl:209-218``), ``update`` — apply a
CRDT op, then bind (``:283-287``) — ``value`` and ``variable`` for
``lasp_ivar``, ``lasp_gset``, ``lasp_orset``, ``lasp_orset_gbtree``,
``riak_dt_gcounter`` and ``riak_dt_orswot``; the bind and watch layer:
``bind`` (merge + inflation gate + write, ``:291-312``), ``bind_raw``,
``ingest``, the dirty marks (``dirty_seq`` / ``dirty_since``),
``redeclare_derived`` for dataflow outputs, and the parked watches of
``read``, ``read_any`` and ``wait_needed`` (``:329-420``, ``:728-758``).

Not ported yet: ``riak_dt_map`` declarations raise ``NotImplementedError``.
Telemetry (counters, spans, events) is not carried.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional

import numpy as np

from ..device import resolve_device
from ..lattice import (
    GCounterSpec,
    GSetSpec,
    IVarSpec,
    ORSetSpec,
    ORSWOTSpec,
    Threshold,
    get_type,
)
from ..utils.interning import CapacityError, Interner

#: the JAX package's LaspConfig.n_actors default
DEFAULT_N_ACTORS = 16

DEFAULT_SPECS = {
    "lasp_ivar": lambda **kw: IVarSpec(),
    "lasp_gset": lambda n_elems=64, **kw: GSetSpec(n_elems=n_elems),
    "lasp_orset": lambda n_elems=64, n_actors=16, tokens_per_actor=4, **kw: ORSetSpec(
        n_elems=n_elems, n_actors=n_actors, tokens_per_actor=tokens_per_actor
    ),
    "lasp_orset_gbtree": lambda n_elems=64, n_actors=16, tokens_per_actor=4, **kw: ORSetSpec(
        n_elems=n_elems, n_actors=n_actors, tokens_per_actor=tokens_per_actor
    ),
    "riak_dt_gcounter": lambda n_actors=16, **kw: GCounterSpec(n_actors=n_actors),
    "riak_dt_orswot": lambda n_elems=64, n_actors=16, **kw: ORSWOTSpec(
        n_elems=n_elems, n_actors=n_actors
    ),
}

#: capacity kwargs each ported type's declare() accepts
ALLOWED_CAPS = {
    "lasp_ivar": set(),
    "lasp_gset": {"n_elems"},
    "lasp_orset": {"n_elems", "n_actors", "tokens_per_actor"},
    "lasp_orset_gbtree": {"n_elems", "n_actors", "tokens_per_actor"},
    "riak_dt_gcounter": {"n_actors"},
    "riak_dt_orswot": {"n_elems", "n_actors"},
}

#: types the JAX store has and this port does not (yet)
NOT_PORTED = ("riak_dt_map",)


class PreconditionError(RuntimeError):
    """Mirror of ``{error, {precondition, {not_present, Elem}}}``."""


class Watch:
    """A parked monotonic read / wait_needed, the declarative replacement for
    the reference's parked threads (``pending_threshold()`` in lasp.hrl)."""

    __slots__ = ("kind", "var_id", "threshold", "done", "result", "callback")

    def __init__(self, kind: str, var_id: str, threshold: Threshold, callback=None):
        self.kind = kind  # "read" | "wait"
        self.var_id = var_id
        self.threshold = threshold
        self.done = False
        self.result: Any = None
        self.callback: Optional[Callable] = callback

    def fire(self, result):
        self.done = True
        self.result = result
        if self.callback is not None:
            self.callback(result)

    def __repr__(self):
        state = "done" if self.done else "pending"
        return f"<Watch {self.kind} {self.var_id} {state}>"


@dataclasses.dataclass
class Variable:
    """The ``#dv{}`` record as a host object: value + type + waiting / lazy
    watches, plus the interners that bridge payload terms to dense
    indices."""

    id: str
    type_name: str
    codec: type
    spec: Any
    state: Any
    waiting: list = dataclasses.field(default_factory=list)
    lazy: list = dataclasses.field(default_factory=list)
    elems: Optional[Interner] = None
    ivar_payloads: Optional[Interner] = None
    actors: Optional[Interner] = None


class Store:
    """One local store of named lattice variables."""

    def __init__(self, n_actors: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self._vars: dict[str, Variable] = {}
        self.n_actors = n_actors if n_actors is not None else DEFAULT_N_ACTORS
        self._id_counter = itertools.count()
        #: bumped on every effective write; lets the dataflow engine skip
        #: propagation when nothing changed since its last fixed point
        self.mutations = 0
        #: per-variable write stamps (var -> ``mutations`` at its last
        #: write), stamped by every write path (:meth:`_write`) and by
        #: :meth:`redeclare_derived`; each graph keeps its own cursor
        #: (:meth:`dirty_since`)
        self.dirty_seq: dict = {}

    # -- declare ------------------------------------------------------------
    def declare(
        self,
        id: Optional[str] = None,
        type: str = "lasp_ivar",
        spec: Any = None,
        elems: Any = None,
        **caps,
    ) -> str:
        """Idempotent declare (``src/lasp_core.erl:209-218``)."""
        if type in NOT_PORTED:
            raise NotImplementedError(
                f"declare({type}): not ported to lasp_tpu_torch yet "
                "(this slice carries lasp_ivar, lasp_gset, lasp_orset, "
                "lasp_orset_gbtree, riak_dt_gcounter and riak_dt_orswot)"
            )
        if id is None:
            id = f"v{next(self._id_counter)}"
        if id in self._vars:
            return id
        codec = get_type(type)
        if spec is None:
            allowed = ALLOWED_CAPS[type]
            unknown = set(caps) - allowed
            if unknown:
                raise TypeError(
                    f"declare({type}): unknown capacity kwargs {sorted(unknown)} "
                    f"(allowed: {sorted(allowed)})"
                )
            if "n_actors" in allowed:
                caps.setdefault("n_actors", self.n_actors)
            spec = DEFAULT_SPECS[type](**caps)
        var = Variable(
            id=id, type_name=type, codec=codec, spec=spec,
            state=codec.new(spec, device=self.device),
        )
        if elems is not None:
            var.elems = elems
        elif hasattr(spec, "n_elems"):
            var.elems = Interner(spec.n_elems, kind="element")
        if hasattr(spec, "n_actors"):
            var.actors = Interner(spec.n_actors, kind="actor")
        if type == "lasp_ivar":
            var.ivar_payloads = Interner(2**31 - 1, kind="ivar payload")
        self._vars[id] = var
        return id

    def variable(self, id: str) -> Variable:
        return self._vars[id]

    def ids(self) -> list:
        return list(self._vars)

    def state(self, id: str):
        return self._vars[id].state

    def redeclare_derived(self, id: str, type: str, spec: Any, elems: Any) -> str:
        """Replace a (still-bottom) variable's codec layout with a derived
        spec / universe: the dataflow layer calls this when an edge is
        attached to an output declared with default capacities (the
        output's token space is dictated by its inputs' spaces). Refuses
        once the variable holds a non-bottom value or has watchers."""
        var = self._vars[id]
        if var.waiting or var.lazy:
            raise RuntimeError(f"cannot redeclare {id}: watchers attached")
        bottom = var.codec.new(var.spec, device=self.device)
        if not bool(var.codec.equal(var.spec, var.state, bottom)):
            raise RuntimeError(f"cannot redeclare {id}: already written")
        codec = get_type(type)
        var.type_name = type
        var.codec = codec
        var.spec = spec
        var.state = codec.new(spec, device=self.device)
        var.elems = elems
        # layout swap: downstream edges must re-run against it
        self.mutations += 1
        self.dirty_seq[id] = self.mutations
        var.ivar_payloads = (
            Interner(2**31 - 1, kind="ivar payload") if type == "lasp_ivar" else None
        )
        var.actors = (
            Interner(spec.n_actors, kind="actor") if hasattr(spec, "n_actors") else None
        )
        return id

    def dirty_since(self, cursor: int) -> set:
        """Variables written after ``cursor`` (a ``mutations`` value the
        caller saved): the consumer half of the dirty marks."""
        return {v for v, m in self.dirty_seq.items() if m > cursor}

    # -- update / bind --------------------------------------------------------
    def update(self, id: str, op: tuple, actor) -> Any:
        """``Type:update(Op, Actor, V0)`` then bind
        (``src/lasp_core.erl:283-287``). Ops mirror the reference op tuples:
        ``("add", E)``, ``("add_all", [E...])``, ``("add_by_token", Token,
        E)``, ``("remove", E)``, ``("remove_all", [E...])``,
        ``("increment",)``, ``("increment", N)``, ``("set", V)``."""
        var = self._vars[id]
        return self.bind(id, self._apply_op(var, var.state, op, actor))

    def bind(self, id: str, state) -> Any:
        """Merge + inflation gate + write (``src/lasp_core.erl:291-312``);
        a non-inflation is silently ignored (``:305-311``)."""
        var = self._vars[id]
        if bool(var.codec.equal(var.spec, var.state, state)):
            return var.state
        merged = var.codec.merge(var.spec, var.state, state)
        if bool(var.codec.is_inflation(var.spec, var.state, merged)):
            self._write(var, merged)
        return var.state

    def bind_raw(self, id: str, state) -> Any:
        """Write bypassing the inflation gate — read-repair, where the
        incoming state is already a join of replicas
        (``src/lasp_vnode.erl:241-244``)."""
        self._write(self._vars[id], state)
        return state

    def ingest(self, new_states: dict) -> int:
        """Write back a batch of post-round states from the dataflow engine
        through the watch-waking write path. Each write MERGES into the
        current state: a watch callback fired earlier in this loop may have
        advanced a later variable past the snapshot the round computed
        from, and an overwrite would roll that back. Returns the number of
        direct writes performed (watch callbacks may add more)."""
        writes = 0
        for id, state in new_states.items():
            var = self._vars[id]
            merged = var.codec.merge(var.spec, var.state, state)
            if not bool(var.codec.equal(var.spec, var.state, merged)):
                self._write(var, merged)
                writes += 1
        return writes

    def _write(self, var: Variable, state):
        """``write/4``: store, then wake the satisfied waiting readers
        (``src/lasp_core.erl:838-844`` + ``reply_to_all`` :774-794)."""
        var.state = state
        self.mutations += 1
        self.dirty_seq[var.id] = self.mutations
        # snapshot: watch callbacks may retire siblings (read_any) or park
        # new watches on this same variable while we iterate
        pending = var.waiting
        var.waiting = []
        still = []
        for watch in pending:
            if watch.done:
                continue  # retired by a sibling's callback mid-loop
            if bool(var.codec.threshold_met(var.spec, var.state, watch.threshold)):
                watch.fire((var.id, var.type_name, var.state))
            else:
                still.append(watch)
        # watches parked during callbacks come after the survivors
        var.waiting = still + var.waiting

    # -- read ---------------------------------------------------------------
    def read(self, id: str, threshold=None) -> Watch:
        """Monotonic threshold read (``src/lasp_core.erl:329-364``): a
        ``Watch``, already done when the threshold is met, parked
        otherwise. Every read also offers its threshold to lazy
        wait_needed watches (:348-349)."""
        var = self._vars[id]
        thr = self._resolve_threshold(var, threshold)
        self._offer_to_lazy(var, thr)
        watch = Watch("read", id, thr)
        if bool(var.codec.threshold_met(var.spec, var.state, thr)):
            watch.fire((id, var.type_name, var.state))
        else:
            var.waiting.append(watch)
        return watch

    def read_any(self, reads: list) -> Watch:
        """First-match-wins read over ``[(id, threshold), ...]``
        (``src/lasp_core.erl:369-420``): one shared watch parked on every
        unmet variable; the first write meeting any threshold fires it."""
        shared = Watch("read", None, None)
        # every read signals interest to lazy producers before any early
        # return (src/lasp_core.erl:348-349)
        resolved = []
        for id, threshold in reads:
            var = self._vars[id]
            thr = self._resolve_threshold(var, threshold)
            self._offer_to_lazy(var, thr)
            resolved.append((id, thr))
        for id, thr in resolved:
            var = self._vars[id]
            if bool(var.codec.threshold_met(var.spec, var.state, thr)):
                shared.fire((id, var.type_name, var.state))
                return shared
        proxies = []

        def _fire_shared(result):
            if shared.done:
                return
            shared.fire(result)
            # retire the sibling proxies; marked done so an in-flight
            # _write sweep skips them too
            for other_id, proxy in proxies:
                proxy.done = True
                other_var = self._vars[other_id]
                if proxy in other_var.waiting:
                    other_var.waiting.remove(proxy)

        for id, thr in resolved:
            proxy = Watch("read", id, thr, callback=_fire_shared)
            proxies.append((id, proxy))
            self._vars[id].waiting.append(proxy)
        return shared

    def _offer_to_lazy(self, var: Variable, read_thr: Threshold):
        """Wake lazy (wait_needed) watches whose threshold the incoming read
        covers (``reply_to_all`` wait clause, ``src/lasp_core.erl:795-813``)."""
        still = []
        for watch in var.lazy:
            if self._wait_covered(var, watch.threshold, read_thr):
                watch.fire(read_thr)
            else:
                still.append(watch)
        var.lazy = still

    def _wait_covered(self, var: Variable, wait_thr: Threshold,
                      read_thr: Threshold) -> bool:
        # the default wait threshold {strict, bottom} is covered by any read
        if var.type_name == "riak_dt_gcounter":
            # numeric thresholds, the wait threshold in value position
            # (src/lasp_core.erl:798)
            if wait_thr.strict and wait_thr.state == 0:
                return True
            r = read_thr.state
            w = wait_thr.state
            return r < w if read_thr.strict else r <= w
        bottom = var.codec.new(var.spec, device=self.device)
        if wait_thr.strict and bool(var.codec.equal(var.spec, wait_thr.state, bottom)):
            return True
        return bool(var.codec.threshold_met(var.spec, wait_thr.state, read_thr))

    def wait_needed(self, id: str, threshold=None) -> Watch:
        """Laziness (``src/lasp_core.erl:728-758``): fire if the threshold is
        already met by the value or a reader is already waiting; otherwise
        park in the lazy list."""
        var = self._vars[id]
        if threshold is None:
            thr = self._resolve_threshold(var, Threshold(None, strict=True))
        else:
            thr = self._resolve_threshold(var, threshold)
        watch = Watch("wait", id, thr)
        if bool(var.codec.threshold_met(var.spec, var.state, thr)):
            watch.fire(thr)
        elif var.waiting:
            watch.fire(thr)
        else:
            var.lazy.append(watch)
        return watch

    def _apply_op(self, var: Variable, state, op: tuple, actor):
        codec, spec = var.codec, var.spec
        verb = op[0]
        if var.type_name in ("lasp_orset", "lasp_orset_gbtree"):
            if verb == "add":
                a = var.actors.intern(actor)
                e = var.elems.intern(op[1])
                self._check_pool(var, state, e, a, op[1])
                return codec.add(spec, state, e, a)
            if verb == "add_all":
                a = var.actors.intern(actor)
                for term in op[1]:
                    e = var.elems.intern(term)
                    self._check_pool(var, state, e, a, term)
                    state = codec.add(spec, state, e, a)
                return state
            if verb == "add_by_token":
                return codec.add_by_token(
                    spec, state, var.elems.intern(op[2]), int(op[1])
                )
            if verb in ("remove", "remove_all"):
                elems = op[1] if verb == "remove_all" else [op[1]]
                member = codec.member_mask(spec, state)
                for e in elems:
                    if e not in var.elems or not bool(member[var.elems.index_of(e)]):
                        raise PreconditionError(f"not_present: {e!r}")
                    state = codec.remove(spec, state, var.elems.index_of(e))
                return state
        elif var.type_name == "lasp_gset":
            if verb == "add":
                return codec.add(spec, state, var.elems.intern(op[1]))
            if verb == "add_all":
                for e in op[1]:
                    state = codec.add(spec, state, var.elems.intern(e))
                return state
        elif var.type_name == "riak_dt_orswot":
            if verb == "add":
                return codec.add(
                    spec, state, var.elems.intern(op[1]), var.actors.intern(actor)
                )
            if verb == "add_all":
                a = var.actors.intern(actor)
                for e in op[1]:
                    state = codec.add(spec, state, var.elems.intern(e), a)
                return state
            if verb in ("remove", "remove_all"):
                elems = op[1] if verb == "remove_all" else [op[1]]
                for e in elems:
                    # against the EVOLVING state: a duplicate removal in one
                    # batch is a precondition error too
                    member = codec.member_mask(spec, state)
                    if e not in var.elems or not bool(member[var.elems.index_of(e)]):
                        raise PreconditionError(f"not_present: {e!r}")
                    state = codec.remove(spec, state, var.elems.index_of(e))
                return state
        elif var.type_name == "riak_dt_gcounter":
            if verb == "increment":
                by = op[1] if len(op) > 1 else 1
                return codec.increment(spec, state, var.actors.intern(actor), by)
        elif var.type_name == "lasp_ivar":
            if verb == "set":
                return codec.set(spec, state, var.ivar_payloads.intern(op[1]))
        raise ValueError(f"unsupported op {op!r} for type {var.type_name}")

    @staticmethod
    def _check_pool(var: Variable, state, elem_idx: int, actor_idx: int, term):
        """Loud token-pool exhaustion: the reference never drops adds."""
        if bool(var.codec.add_exhausted(var.spec, state, elem_idx, actor_idx)):
            raise CapacityError(
                f"{var.id}: token pool exhausted for element {term!r} "
                f"(tokens_per_actor={var.spec.tokens_per_actor}); "
                "raise tokens_per_actor"
            )

    # -- thresholds -----------------------------------------------------------
    def _resolve_threshold(self, var: Variable, threshold) -> Threshold:
        """Default thresholds per ``src/lasp_core.erl:339-346``: bottom /
        strict-bottom when unspecified; counter thresholds are numeric."""
        numeric = var.type_name == "riak_dt_gcounter"
        if threshold is None:
            return Threshold(
                0 if numeric else var.codec.new(var.spec, device=self.device),
                strict=False,
            )
        if isinstance(threshold, Threshold):
            if threshold.state is None:
                bottom = (
                    0 if numeric else var.codec.new(var.spec, device=self.device)
                )
                return Threshold(bottom, strict=threshold.strict)
            return threshold
        return Threshold(threshold, strict=False)

    # -- values -------------------------------------------------------------
    def value(self, id: str):
        """Decoded observable value (``Type:value/1``) as host Python data."""
        var = self._vars[id]
        return self._decode_value(var, var.state)

    def _decode_value(self, var: Variable, state):
        if var.type_name in ("lasp_orset", "lasp_orset_gbtree", "lasp_gset",
                             "riak_dt_orswot"):
            mask = var.codec.value(var.spec, state).cpu().numpy()
            return var.elems.decode_mask(np.asarray(mask))
        if var.type_name == "riak_dt_gcounter":
            return int(var.codec.value(var.spec, state))
        if var.type_name == "lasp_ivar":
            if not bool(state.defined):
                return None
            return var.ivar_payloads.term_of(int(state.value))
        raise ValueError(var.type_name)


__all__ = ["PreconditionError", "Store", "Variable", "Watch"]
