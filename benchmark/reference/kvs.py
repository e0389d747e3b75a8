"""The replicated store of records, worked out plainly.

Each record is a ``lasp_orset``, written from its published Erlang
semantics (``lasp_orset.erl``: an add mints a token, a remove tombstones
every token it sees; the value is the elements with a live token).

A store applies ops in cycles. At the start of a cycle every replica holds
the converged state ``G``; an op at replica ``r`` sees ``G`` joined with
``r``'s own earlier ops of the cycle, in order; the cycle ends converged,
every replica holding the join of ``G`` and every replica's view. Each
actor writes from one replica (riak_dt's rule), so every acknowledged op
is in the converged value.
"""

from __future__ import annotations

import copy


class PreconditionError(ValueError):
    pass


class ORSet:
    def __init__(self, spec=None):
        self.tokens_per_actor = (spec or {}).get("tokens_per_actor")
        self.tokens = {}  # elem -> {(actor, k): removed}

    def apply(self, op, actor):
        if op[0] == "add":
            k = sum(1 for a, _k in self.tokens.get(op[1], {}) if a == actor)
            if self.tokens_per_actor is not None and k >= self.tokens_per_actor:
                raise OverflowError(f"lasp_orset: {actor}'s tokens of {op[1]!r} spent")
            self.tokens.setdefault(op[1], {})[(actor, k)] = False
        elif op[0] == "remove":
            toks = self.tokens.get(op[1], {})
            if all(toks.values()):
                raise PreconditionError(f"not_present: {op[1]!r}")
            for t in toks:
                toks[t] = True
        else:
            raise ValueError(f"lasp_orset: unknown op {op!r}")

    def join(self, other):
        for e, toks in other.tokens.items():
            mine = self.tokens.setdefault(e, {})
            for t, removed in toks.items():
                mine[t] = mine.get(t, False) or removed

    def value(self):
        return frozenset(e for e, toks in self.tokens.items()
                         if not all(toks.values()))


KINDS = {"lasp_orset": ORSet}


class Store:
    """The converged state of every variable, advanced a cycle at a time."""

    def __init__(self, kinds: dict, specs: dict):
        self.kinds = dict(kinds)
        self.specs = dict(specs)
        self.vars = {v: KINDS[k](specs.get(v)) for v, k in kinds.items()}

    def copy(self) -> "Store":
        return copy.deepcopy(self)

    def apply_cycle(self, cycle: dict) -> None:
        """``cycle``: ``{var: [(replica, op, actor), ...]}``, each
        variable's ops in the order they were sent."""
        for var, ops in cycle.items():
            base = self.vars[var]
            views = {}
            for replica, op, actor in ops:
                view = views.get(replica)
                if view is None:
                    view = views[replica] = copy.deepcopy(base)
                view.apply(op, actor)
            for view in views.values():
                base.join(view)

    def values(self) -> dict:
        return {v: s.value() for v, s in self.vars.items()}
