"""Variable store: the single-replica runtime core (port of
``lasp_tpu.store.store``; reference ``lasp_core.erl``).

Ported: ``declare`` (``src/lasp_core.erl:209-218``), ``update`` — apply a
CRDT op, then bind (``:283-287``) — ``value`` and ``variable`` for
``lasp_ivar``, ``lasp_gset``, ``lasp_orset``, ``lasp_orset_gbtree``,
``riak_dt_gcounter``, ``riak_dt_orswot`` and ``riak_dt_map``; the bind and
watch layer: ``bind`` (merge + inflation gate + write, ``:291-312``),
``bind_raw``, ``ingest``, the dirty marks (``dirty_seq`` /
``dirty_since``), ``redeclare_derived`` for dataflow outputs, and the
parked watches of ``read``, ``read_any`` and ``wait_needed``
(``:329-420``, ``:728-758``).

The map layer: declared schemas (:func:`build_map_spec`), per-field
variable shims that give each embedded field its own element universe
and share the map's actor universe, admission of unknown ``{Name, Type}``
keys on first update at any nesting depth (``scan_map_admissions`` /
``grow_map_plan``), and the map's decode. Tombstone compaction:
``compact_orset`` for OR-Set variables and ``compact_map_field`` for an
OR-Set field of a map, with the liveness plans the replicated runtime
shares. The store counts binds, inflations, ignored binds and reads in
``metrics`` (checkpoints carry them) and emits the registry counters and
``bind`` events JAX's store emits.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..config import get_config
from ..device import resolve_device
from ..lattice import (
    GCounterSpec,
    GSetSpec,
    IVarSpec,
    MapSpec,
    ORSetSpec,
    ORSWOTSpec,
    Threshold,
    get_type,
)
from ..lattice.map import CrdtMap, MapState, map_subs
from ..telemetry import events as tel_events
from ..telemetry.registry import CounterGroup, counter, histogram
from ..utils.interning import CapacityError, Interner
from ..utils.metrics import Timer

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

#: capacity kwargs each type's declare() accepts; anything else is a loud
#: TypeError
ALLOWED_CAPS = {
    "lasp_ivar": set(),
    "lasp_gset": {"n_elems"},
    "lasp_orset": {"n_elems", "n_actors", "tokens_per_actor"},
    "lasp_orset_gbtree": {"n_elems", "n_actors", "tokens_per_actor"},
    "riak_dt_gcounter": {"n_actors"},
    "riak_dt_orswot": {"n_elems", "n_actors"},
    "riak_dt_map": {"fields", "n_actors", "reset_on_readd"},
}


def resolve_map_field(
    key, type_name: str, caps, n_actors: int, reset_on_readd: bool = False
) -> tuple:
    """``(key, codec, espec)`` for one map field: the one validation path
    of declared schemas (:func:`build_map_spec`) and dynamic admission
    (:meth:`Store.resolve_dynamic_field`). ``reset_on_readd`` is the parent
    map's re-add mode, which nested maps inherit."""
    caps = dict(caps or {})
    if type_name == "riak_dt_map":
        if "reset_on_readd" in caps and bool(
            caps["reset_on_readd"]
        ) != bool(reset_on_readd):
            raise TypeError(
                f"map field {key!r}: nested reset_on_readd must match "
                f"the parent map's ({reset_on_readd}) — one reset "
                "behavior per tree"
            )
        if caps.get("n_actors", n_actors) != n_actors:
            raise TypeError(
                f"map field {key!r}: n_actors must match the map's "
                f"({n_actors}); per-field writer universes are not "
                "separable from the map clock"
            )
        unknown = set(caps) - {"fields", "n_actors", "reset_on_readd"}
        if unknown:
            raise TypeError(
                f"map field {key!r} (riak_dt_map): unknown capacity "
                f"kwargs {sorted(unknown)}"
            )
        espec = build_map_spec(
            caps.get("fields", ()), n_actors, reset_on_readd=reset_on_readd
        )
        return (key, get_type("riak_dt_map"), espec)
    if type_name not in ALLOWED_CAPS:
        raise TypeError(f"map field {key!r}: unknown type {type_name!r}")
    unknown = set(caps) - ALLOWED_CAPS[type_name]
    if unknown:
        raise TypeError(
            f"map field {key!r} ({type_name}): unknown capacity kwargs "
            f"{sorted(unknown)} (allowed: {sorted(ALLOWED_CAPS[type_name])})"
        )
    if "n_actors" in ALLOWED_CAPS[type_name]:
        # field shims share the map's actor interner, so an embedded writer
        # width must equal the map's
        if caps.get("n_actors", n_actors) != n_actors:
            raise TypeError(
                f"map field {key!r}: n_actors must match the map's "
                f"({n_actors}); per-field writer universes are not "
                "separable from the map clock"
            )
        caps["n_actors"] = n_actors
    return (key, get_type(type_name), DEFAULT_SPECS[type_name](**caps))


def map_key_type_name(key) -> "str | None":
    """The embedded type a map field key names, or None. The reference's
    keys are ``{Name, Type}`` pairs (``riak_test/lasp_kvs_replica_test.erl:57-58``),
    carried as ``(name, "type_name")`` or as the ETF bridge's tagged
    ``("tuple", <name_key>, ("atom", "type_name"))``. A bare tagged atom
    ``("atom", x)`` is not a pair and never admits."""
    if (
        isinstance(key, tuple)
        and len(key) == 2
        and isinstance(key[1], str)
        and key[0] != "atom"
    ):
        return key[1]
    if (
        isinstance(key, tuple)
        and len(key) == 3
        and key[0] == "tuple"
        and isinstance(key[2], tuple)
        and len(key[2]) == 2
        and key[2][0] == "atom"
    ):
        return str(key[2][1])
    return None


def build_map_spec(fields, n_actors: int, reset_on_readd: bool = False) -> MapSpec:
    """A map schema from ``[(key, type_name, caps_dict), ...]``. Declaring
    fields is pre-sizing, not a fence: unknown ``(name, type_name)`` keys
    admit on first update (:meth:`Store.admit_map_fields`)."""
    resolved = [
        resolve_map_field(key, type_name, caps, n_actors,
                          reset_on_readd=reset_on_readd)
        for key, type_name, caps in fields
    ]
    return MapSpec(
        fields=tuple(resolved), n_actors=n_actors, reset_on_readd=reset_on_readd
    )


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
    #: riak_dt_map only: per-field Variable shims (codec, spec and
    #: interners of each embedded lattice)
    map_aux: Optional[list] = None


class Store:
    """One local store of named lattice variables."""

    def __init__(self, n_actors: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self._vars: dict[str, Variable] = {}
        # default per-variable writer capacity (LASP_N_ACTORS overridable)
        self.n_actors = (
            n_actors if n_actors is not None else get_config().n_actors
        )
        self._id_counter = itertools.count()
        #: typed fixed-key counters (telemetry.CounterGroup), as JAX's store
        #: keeps them; checkpoints carry them
        self.metrics = CounterGroup(
            ("binds", "inflations", "ignored_binds", "reads")
        )
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
            if type == "riak_dt_map":
                spec = build_map_spec(
                    caps.get("fields", ()),
                    caps.get("n_actors", self.n_actors),
                    reset_on_readd=caps.get("reset_on_readd", False),
                )
            else:
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
        if type == "riak_dt_map":
            var.map_aux = [
                self._field_shim(id, key, fcodec, fspec, var)
                for key, fcodec, fspec in spec.fields
            ]
        self._vars[id] = var
        return id

    @staticmethod
    def _field_shim(map_id, key, fcodec, fspec, parent: Variable) -> Variable:
        """A Variable-shaped holder for one embedded map field: its own
        element / payload universes, the parent map's writer universe."""
        shim = Variable(
            id=f"{map_id}.{key!r}",
            type_name=fcodec.name,
            codec=fcodec,
            spec=fspec,
            state=None,  # the live state lives in the parent MapState
        )
        if hasattr(fspec, "n_elems"):
            shim.elems = Interner(fspec.n_elems, kind="element")
        shim.actors = parent.actors
        if fcodec.name == "lasp_ivar":
            shim.ivar_payloads = Interner(2**31 - 1, kind="ivar payload")
        if fcodec.name == "riak_dt_map":
            # a nested map carries its own sub-shims, sharing the one actor
            # universe all the way down
            shim.map_aux = [
                Store._field_shim(shim.id, k2, c2, s2, shim)
                for k2, c2, s2 in fspec.fields
            ]
        return shim

    # -- dynamic map fields ---------------------------------------------------
    @staticmethod
    def resolve_dynamic_field(spec: MapSpec, key):
        """``(key, codec, espec)`` for a key admitted on first touch: the
        key must name its type (:func:`map_key_type_name`); capacities are
        the declare-time defaults."""
        type_name = map_key_type_name(key)
        if type_name is None:
            raise KeyError(
                f"riak_dt_map: unknown field {key!r}; admission on first "
                "update requires (name, type_name) keys (riak_dt_map's "
                "{Name, Type}) — or pre-declare the field"
            )
        return resolve_map_field(
            key, type_name, None, spec.n_actors,
            reset_on_readd=spec.reset_on_readd,
        )

    @classmethod
    def scan_map_admissions(cls, var: Variable, ops) -> dict:
        """Validate-only pass over the update subs of ``ops`` (map client
        ops), recursive through nested map fields: an admission plan
        ``{"fresh": [(key, codec, espec), ...], "sub": {field_idx:
        subplan}}`` (either key absent when empty; ``{}`` = no growth).
        Raises on a non-admissible key with nothing mutated, so a bad op
        later in a batch never leaves the spec half grown. Removes never
        admit."""
        return cls._scan_level(var.spec, var.map_aux, ops)

    @classmethod
    def _scan_level(cls, spec: MapSpec, map_aux, ops) -> dict:
        known = {k: i for i, (k, _c, _s) in enumerate(spec.fields)}
        fresh: dict = {}  # key -> [codec, espec] (espec evolves for maps)
        sub_ops: dict = {}  # field_idx -> [inner ops]
        for op in ops:
            for sub in map_subs(op):
                if not (isinstance(sub, tuple) and len(sub) == 3
                        and sub[0] == "update"):
                    continue  # removes / malformed: the normal path rules
                key, inner = sub[1], sub[2]
                if key in known:
                    f = known[key]
                    if spec.fields[f][1].name == "riak_dt_map":
                        sub_ops.setdefault(f, []).append(inner)
                elif key in fresh:
                    codec, espec = fresh[key]
                    if codec.name == "riak_dt_map":
                        fresh[key][1] = cls._extend_fresh_subspec(espec, inner)
                else:
                    triple = cls.resolve_dynamic_field(spec, key)
                    entry = [triple[1], triple[2]]
                    if entry[0].name == "riak_dt_map":
                        entry[1] = cls._extend_fresh_subspec(entry[1], inner)
                    fresh[key] = entry
        plan: dict = {}
        subs: dict = {}
        for f, inners in sub_ops.items():
            # inner ops are map client ops of the submap
            shim = map_aux[f] if map_aux is not None else None
            subplan = cls._scan_level(
                spec.fields[f][2],
                shim.map_aux if shim is not None else None,
                inners,
            )
            if subplan:
                subs[f] = subplan
        if fresh:
            plan["fresh"] = [(k, c, e) for k, (c, e) in fresh.items()]
        if subs:
            plan["sub"] = subs
        return plan

    @classmethod
    def _extend_fresh_subspec(cls, espec: MapSpec, inner_op) -> MapSpec:
        """Fold a fresh nested map field's inner op into its staged spec
        (the submap has no shims yet)."""
        subplan = cls._scan_level(espec, None, [inner_op])
        return cls._apply_plan_to_spec(espec, subplan)

    @classmethod
    def _apply_plan_to_spec(cls, spec: MapSpec, plan: dict) -> MapSpec:
        for f, subplan in plan.get("sub", {}).items():
            spec = spec.replace_field_spec(
                f, cls._apply_plan_to_spec(spec.fields[f][2], subplan)
            )
        if plan.get("fresh"):
            spec = spec.with_fields(plan["fresh"])
        return spec

    def admit_map_fields(self, var: Variable, op: tuple) -> int:
        """Admit the unknown field keys ``op``'s updates name, at any
        depth (``riak_dt_map`` creates a field the first time ``{update,
        Key, Op}`` names it). Returns how many fields were admitted; 0 =
        layout unchanged. Admission is observably a no-op until the update
        lands (a fresh field has no presence dots)."""
        plan = self.scan_map_admissions(var, (op,))
        if not plan:
            return 0
        return self.grow_map_plan(var, plan)

    @classmethod
    def grow_map_plan(cls, var: Variable, plan: dict) -> int:
        """Apply an admission plan: the grown spec, the shim tree, the
        state's migration and the parked watches' thresholds (re-laid out
        so ``threshold_met`` compares same-shaped states). Returns the
        number of fields admitted across all levels."""
        var.spec = cls._apply_plan_to_spec(var.spec, plan)
        count = cls._sync_shims(var)
        if var.state is not None:
            var.state = CrdtMap.grow(var.spec, var.state)
        for watch in list(var.waiting) + list(var.lazy):
            thr = watch.threshold
            if thr is not None and isinstance(thr.state, MapState):
                watch.threshold = Threshold(
                    CrdtMap.grow(var.spec, thr.state), thr.strict
                )
        return count

    @classmethod
    def grow_map_fields(cls, var: Variable, fresh: list) -> None:
        """Level-local admission of ``fresh`` triples (a plan with only a
        ``fresh`` part)."""
        cls.grow_map_plan(var, {"fresh": list(fresh)})

    @classmethod
    def _sync_shims(cls, var: Variable) -> int:
        """Align the shim tree with ``var.spec`` after growth; returns how
        many shims were created (== fields admitted)."""
        created = 0
        for i, (key, fcodec, fspec) in enumerate(var.spec.fields):
            if i >= len(var.map_aux):
                var.map_aux.append(cls._field_shim(var.id, key, fcodec, fspec, var))
                created += 1 + cls._count_fields(fcodec, fspec)
            elif fcodec.name == "riak_dt_map":
                shim = var.map_aux[i]
                if shim.spec is not fspec:
                    shim.spec = fspec
                    created += cls._sync_shims(shim)
        return created

    @classmethod
    def _count_fields(cls, fcodec, fspec) -> int:
        if fcodec.name != "riak_dt_map":
            return 0
        return sum(1 + cls._count_fields(c, s) for _k, c, s in fspec.fields)

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
        if var.type_name == "riak_dt_map":
            # grow the field axis for keys this op names first, before
            # reading var.state (growth migrates it)
            self.admit_map_fields(var, op)
        state = self._apply_op(var, var.state, op, actor)
        tel_events.emit("update", var=id, op=str(op[0]))
        return self.bind(id, state)

    def bind(self, id: str, state) -> Any:
        """Merge + inflation gate + write (``src/lasp_core.erl:291-312``);
        a non-inflation is silently ignored (``:305-311``)."""
        var = self._vars[id]
        self.metrics["binds"] += 1
        counter("store_binds_total", help="bind verbs dispatched").inc()
        if bool(var.codec.equal(var.spec, var.state, state)):
            tel_events.emit("bind", var=id, outcome="noop")
            return var.state
        with Timer() as t:
            merged = var.codec.merge(var.spec, var.state, state)
        histogram(
            "merge_seconds",
            help="host-path CRDT merge wall time by type",
            type=var.type_name,
        ).observe(t.elapsed)
        tel_events.emit_deep(
            "merge", var=id, type=var.type_name, seconds=round(t.elapsed, 9),
        )
        if bool(var.codec.is_inflation(var.spec, var.state, merged)):
            self.metrics["inflations"] += 1
            counter("store_inflations_total", help="binds that inflated").inc()
            tel_events.emit("bind", var=id, outcome="inflated")
            self._write(var, merged)
        else:
            self.metrics["ignored_binds"] += 1
            counter(
                "store_ignored_binds_total",
                help="binds ignored by the inflation gate",
            ).inc()
            tel_events.emit("bind", var=id, outcome="ignored")
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
                tel_events.emit("threshold_fire", var=var.id, kind=watch.kind)
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
        self.metrics["reads"] += 1
        counter("store_reads_total", help="threshold reads issued").inc()
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
        elif var.type_name == "riak_dt_map":
            # ("update", [("update", Key, Op) | ("remove", Key), ...]); a
            # single field op is accepted too
            if verb == "update" and len(op) == 2:
                for sub in op[1]:
                    state = self._apply_map_field(var, state, sub, actor)
                return state
            if verb in ("update", "remove"):
                return self._apply_map_field(var, state, op, actor)
        elif var.type_name == "riak_dt_gcounter":
            if verb == "increment":
                by = op[1] if len(op) > 1 else 1
                return codec.increment(spec, state, var.actors.intern(actor), by)
        elif var.type_name == "lasp_ivar":
            if verb == "set":
                return codec.set(spec, state, var.ivar_payloads.intern(op[1]))
        raise ValueError(f"unsupported op {op!r} for type {var.type_name}")

    def _apply_map_field(self, var: Variable, state, sub: tuple, actor):
        """One ``{update, Key, Op}`` / ``{remove, Key}`` against a map field
        (``riak_test/lasp_kvs_replica_test.erl:120-133``)."""
        spec, codec = var.spec, var.codec
        if sub[0] == "remove":
            try:
                f = spec.field_index(sub[1])
            except KeyError:
                # a never-admitted field is absent: the remove precondition
                raise PreconditionError(f"not_present: {sub[1]!r}") from None
            if not bool(codec.value(spec, state)[f]):
                raise PreconditionError(f"not_present: {sub[1]!r}")
            return codec.remove(spec, state, f)
        _verb, key, inner = sub
        f = spec.field_index(key)
        state = codec.touch(spec, state, f, var.actors.intern(actor))
        shim = var.map_aux[f]
        new_field = self._apply_op(shim, state.fields[f], inner, actor)
        return codec.set_field(spec, state, f, new_field)

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
        if var.type_name == "riak_dt_map":
            present = var.codec.value(var.spec, state).cpu().numpy()
            # effective_field applies the reset-mode tombstone baselines
            return {
                key: self._decode_value(
                    var.map_aux[f], var.codec.effective_field(var.spec, state, f)
                )
                for f, (key, _c, _s) in enumerate(var.spec.fields)
                if present[f]
            }
        raise ValueError(var.type_name)

    # -- compaction ----------------------------------------------------------
    def compact_plan(self, id: str, state=None):
        """Liveness plan for OR-Set tombstone compaction: ``(order,
        fresh_interner)``, ``order`` the surviving old element indices in
        their new positions. ``state`` overrides the authoritative dense
        state (the runtime passes a converged replica row). Refuses
        non-OR-Set types and variables with parked watches (their
        thresholds index the old element order).

        Dropping a fully tombstoned element row forgets its tombstones,
        sound exactly when no other state can reintroduce those tokens:
        one store always, a replicated population only at divergence 0
        (the runtime checks). The reclamation the reference's
        ``waste_pct`` stat cues (``src/lasp_orset.erl:178-191``)."""
        var = self._vars[id]
        if var.type_name not in ("lasp_orset", "lasp_orset_gbtree"):
            raise TypeError(f"compact: {var.type_name} has no tombstones")
        if var.waiting or var.lazy:
            raise RuntimeError(
                f"cannot compact {id}: watches hold old-order thresholds"
            )
        return self._orset_live_plan(
            var.elems, var.state if state is None else state
        )

    @staticmethod
    def _orset_live_plan(elems, state):
        """``(order, fresh_interner)`` for one OR-Set state: the liveness
        rule shared by variables and embedded map fields."""
        exists = state.exists.cpu().numpy()
        removed = state.removed.cpu().numpy()
        live = (exists & ~removed).any(axis=-1)
        order = np.flatnonzero(live)
        fresh = Interner(elems.capacity, kind=elems.kind)
        terms = elems.terms()
        for i in order:
            fresh.intern(terms[int(i)])
        return order, fresh

    @staticmethod
    def _normalize_map_path(key) -> tuple:
        """A field reference is one ``{Name, Type}`` key or a path (tuple
        of keys) into nested submaps; a single key becomes a path of one."""
        if map_key_type_name(key) is not None:
            return (key,)
        if (
            isinstance(key, tuple)
            and key
            and all(map_key_type_name(k) is not None for k in key)
        ):
            return tuple(key)
        return (key,)

    @staticmethod
    def _nested_field(state, idxs):
        """The embedded state at a path of field indices."""
        for f in idxs:
            state = state.fields[f]
        return state

    def compact_map_plan(self, map_id: str, key, state=None) -> tuple:
        """Validation and liveness plan for compacting one OR-Set field of
        a map at ``key`` (a key or a path): ``(field_idxs, shim, order,
        fresh_interner)``, shared by the store and the runtime. ``state``
        overrides the authoritative map state."""
        path = self._normalize_map_path(key)
        var = self._vars[map_id]
        if var.type_name != "riak_dt_map":
            raise TypeError(f"compact_map_field: {var.type_name} is not a map")
        if var.waiting or var.lazy:
            raise RuntimeError(
                f"cannot compact {map_id}: watches hold old-order thresholds"
            )
        holder_spec, holder_aux = var.spec, var.map_aux
        idxs, shim = [], None
        for depth, k in enumerate(path):
            f = holder_spec.field_index(k)
            shim = holder_aux[f]
            idxs.append(f)
            if depth < len(path) - 1:
                if shim.type_name != "riak_dt_map":
                    raise TypeError(
                        f"compact_map_field: path element {k!r} is "
                        f"{shim.type_name}, not a submap"
                    )
                holder_spec, holder_aux = shim.spec, shim.map_aux
        if shim.codec.name not in ("lasp_orset", "lasp_orset_gbtree"):
            raise TypeError(
                f"compact_map_field: field {path[-1]!r} is "
                f"{shim.codec.name}, which has no token tombstones"
            )
        authority = var.state if state is None else state
        order, fresh = self._orset_live_plan(
            shim.elems, self._nested_field(authority, idxs)
        )
        return idxs, shim, order, fresh

    @staticmethod
    def _replace_nested_field(codec, spec, state, idxs, new_leaf):
        """``set_field`` through a path of field indices (leading batch
        dims ride along)."""
        f = idxs[0]
        if len(idxs) == 1:
            return codec.set_field(spec, state, f, new_leaf)
        new_sub = Store._replace_nested_field(
            codec, spec.fields[f][2], state.fields[f], idxs[1:], new_leaf
        )
        return codec.set_field(spec, state, f, new_sub)

    def compact_map_field(self, map_id: str, key) -> int:
        """Reclaim the element slots (and with them the tombstoned token
        slots) of one OR-Set field of a map: what keeps reset-mode remove
        / re-add churn inside a fixed token pool. Sound as
        :meth:`compact_orset` is. Returns slots reclaimed."""
        var = self._vars[map_id]
        idxs, shim, order, fresh = self.compact_map_plan(map_id, key)
        reclaimed = len(shim.elems) - len(fresh)
        if reclaimed:
            var.state = self._replace_nested_field(
                var.codec, var.spec, var.state, idxs,
                self.reindex_orset_state(self._nested_field(var.state, idxs), order),
            )
            shim.elems = fresh
            # the bit layout every edge projection reads changed
            self.mutations += 1
            self.dirty_seq[map_id] = self.mutations
        return reclaimed

    @staticmethod
    def reindex_orset_state(state, order):
        """OR-Set planes with the surviving element rows moved to the front
        (kept verbatim, tombstoned tokens included) and the freed rows
        zeroed. Works on any leading batch dims."""
        k = len(order)

        def rebuild(plane):
            fresh = torch.zeros_like(plane)
            if k:
                idx = torch.as_tensor(
                    np.asarray(order, dtype=np.int64), device=plane.device
                )
                fresh[..., :k, :] = plane.index_select(plane.dim() - 2, idx)
            return fresh

        return state._replace(
            exists=rebuild(state.exists), removed=rebuild(state.removed)
        )

    def compact_orset(self, id: str) -> int:
        """Reclaim the element slots of fully tombstoned OR-Set entries in
        this store. Returns slots reclaimed. A caller holding a dataflow
        graph must ``refresh()`` it afterwards (projection tables follow
        the element order)."""
        var = self._vars[id]
        order, fresh = self.compact_plan(id)
        reclaimed = len(var.elems) - len(fresh)
        if reclaimed:
            var.state = self.reindex_orset_state(var.state, order)
            var.elems = fresh
            self.mutations += 1
            self.dirty_seq[id] = self.mutations
        return reclaimed


__all__ = ["PreconditionError", "Store", "Variable", "Watch"]
