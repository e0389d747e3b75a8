"""Variable store: the single-replica runtime core (port of
``lasp_tpu.store.store``; reference ``lasp_core.erl``).

Ported: ``declare`` (``src/lasp_core.erl:209-218``), ``update`` — apply a
CRDT op, then merge + inflation gate + write (``:283-312``) — ``value`` and
``variable`` for ``lasp_ivar``, ``lasp_gset``, ``lasp_orset``,
``lasp_orset_gbtree``, ``riak_dt_gcounter`` and ``riak_dt_orswot``.

Not ported yet: ``riak_dt_map`` declarations and the threshold-watch layer
(``bind``, ``read``, ``read_any``, ``wait_needed``) raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

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


@dataclasses.dataclass
class Variable:
    """The ``#dv{}`` record as a host object: value + type + the interners
    that bridge payload terms to dense indices."""

    id: str
    type_name: str
    codec: type
    spec: Any
    state: Any
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
        #: bumped on every effective write
        self.mutations = 0

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

    # -- update -------------------------------------------------------------
    def update(self, id: str, op: tuple, actor) -> Any:
        """``Type:update(Op, Actor, V0)``, then merge + inflation gate +
        write (``src/lasp_core.erl:283-312``; non-inflations are silently
        ignored). Ops mirror the reference op tuples: ``("add", E)``,
        ``("add_all", [E...])``, ``("add_by_token", Token, E)``,
        ``("remove", E)``, ``("remove_all", [E...])``, ``("increment",)``,
        ``("increment", N)``, ``("set", V)``."""
        var = self._vars[id]
        candidate = self._apply_op(var, var.state, op, actor)
        if bool(var.codec.equal(var.spec, var.state, candidate)):
            return var.state
        merged = var.codec.merge(var.spec, var.state, candidate)
        if bool(var.codec.is_inflation(var.spec, var.state, merged)):
            var.state = merged
            self.mutations += 1
        return var.state

    def bind(self, id: str, state) -> Any:
        raise NotImplementedError(
            "Store.bind and the threshold-watch layer are not ported to "
            "lasp_tpu_torch yet; use update()"
        )

    def read(self, id: str, threshold=None):
        raise NotImplementedError(
            "Store.read (threshold watches) is not ported to lasp_tpu_torch "
            "yet; ReplicatedRuntime.read_at is the non-blocking read"
        )

    read_any = read
    wait_needed = read

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


__all__ = ["PreconditionError", "Store", "Variable"]
