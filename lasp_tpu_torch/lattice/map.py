"""CRDT Map: composed field lattices under observe-remove key presence
(port of ``lasp_tpu.lattice.map``; reference ``riak_dt_map``, ordered by
``src/lasp_lattice.erl:166-167, 264-271`` and driven by the KVS-replica
workload ``riak_test/lasp_kvs_replica_test.erl:57-135``).

A ``MapSpec`` holds the ordered tuple of ``(key, embedded codec, embedded
spec)``. A state is ``clock: int32[A]``, ``dots: int32[F, A]`` (field
presence, the OR-SWOT dot matrix over field slots) and a tuple of embedded
states; maps nest (a ``{Name, riak_dt_map}`` field embeds a submap). The
schema grows the way the reference's does: the store admits an unknown
``{Name, Type}`` key on first update with :meth:`MapSpec.with_fields` and
:meth:`CrdtMap.grow`, which appends bottom slots to live states.

Two re-add modes, as in the JAX codec:

- ``reset_on_readd=False``: contents are join-monotone across remove /
  re-add; presence controls visibility only.
- ``reset_on_readd=True``: riak_dt's reset-remove. A remove erases what
  the remover observed, per embedded type and always as a join: OR-Set
  fields tombstone the observed tokens, OR-SWOT fields drop the observed
  dots, G-Counter fields carry a tombstone baseline (``tombs``, joined by
  max, subtracted by :meth:`CrdtMap.effective_field`), and G-Set / IVar
  fields reset to bottom behind a per-field epoch (``epochs: int32[F]``;
  merge joins their contents only between equal eras). Every remove bumps
  the field's epoch.

Batch-polymorphic like the rest of the port (``lattice/base.py``): every
leaf may carry leading replica dims, reductions run over the state's own
trailing dims, so ``equal`` on two ``[R, ...]`` populations returns
``bool[R]``. The merge is plain PyTorch: the JAX package leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import resolve_device
from .base import CrdtType, all_trailing, any_trailing, tree_map
from .dots import clock_inflation, merge_dots, mint_dot, strict_clock_inflation


@dataclasses.dataclass(frozen=True)
class MapSpec:
    #: ordered schema: ((key, codec_cls, embedded_spec), ...); grows via
    #: ``with_fields`` when the store admits a key on first update
    fields: tuple
    n_actors: int
    #: riak_dt re-add semantics (see the module docstring)
    reset_on_readd: bool = False

    @property
    def n_fields(self) -> int:
        return len(self.fields)

    def field_index(self, key) -> int:
        # the key -> slot dict is derived data cached in __dict__ (the
        # batch paths look keys up per sub-op); with_fields and
        # replace_field_spec build fresh instances, so it never goes stale
        idx = self.__dict__.get("_key_index")
        if idx is None:
            idx = {k: i for i, (k, _c, _s) in enumerate(self.fields)}
            object.__setattr__(self, "_key_index", idx)
        try:
            return idx[key]
        except (KeyError, TypeError):
            raise KeyError(
                f"riak_dt_map: unknown field {key!r} (dynamic admission "
                "requires (name, type_name) keys, riak_dt_map's {Name, Type})"
            ) from None

    def with_fields(self, new_fields) -> "MapSpec":
        """A grown spec with ``new_fields`` ((key, codec, espec) triples)
        appended in order; existing field indices are kept."""
        return dataclasses.replace(self, fields=self.fields + tuple(new_fields))

    def replace_field_spec(self, field_idx: int, espec) -> "MapSpec":
        """A spec with one field's embedded spec replaced (a nested map
        field's growth reaching its parent)."""
        fields = list(self.fields)
        k, codec, _old = fields[field_idx]
        fields[field_idx] = (k, codec, espec)
        return dataclasses.replace(self, fields=tuple(fields))


def _resets(spec: MapSpec) -> bool:
    return bool(spec.reset_on_readd)


def map_subs(op: tuple) -> list:
    """Flatten a map client op to its sub-ops: ``("update", [SubOps])``
    yields its list, a single field op yields itself."""
    return op[1] if op[0] == "update" and len(op) == 2 else [op]


class MapState(NamedTuple):
    clock: torch.Tensor  # int32[..., A]
    dots: torch.Tensor  # int32[..., F, A]: field-presence dots
    fields: tuple  # embedded states, schema order
    #: int32[..., F] reset eras (reset_on_readd mode), else None
    epochs: "torch.Tensor | None" = None
    #: reset-remove tombstone baselines (reset mode), schema order: a
    #: G-Counter field's observed counts, None for every other type
    tombs: "tuple | None" = None


#: embedded types whose reset rides the per-field epoch gate
_EPOCH_GATED = ("lasp_ivar", "lasp_gset")


def _device(state):
    return state.clock.device


def _bottom_like(codec, espec, fs):
    """The embedded bottom broadcast to ``fs``'s batch shape, with storage
    of its own (the runtime writes population rows in place)."""
    bottom = codec.new(espec, device=fs[0].device)
    return tree_map(lambda x, b: b.expand_as(x).clone(), fs, bottom)


def _lift(pred: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A batch predicate broadcast from the left against leaf ``x``."""
    return pred.reshape(tuple(pred.shape) + (1,) * (x.dim() - pred.dim()))


def _tomb_bottom(codec, espec, device):
    """The tombstone-baseline bottom for one embedded field, or None for
    types that need none."""
    if codec.name == "riak_dt_gcounter":
        return torch.zeros(
            (espec.n_actors,), dtype=getattr(torch, espec.dtype), device=device
        )
    return None


def _reset_field(codec, espec, fs, tomb):
    """The per-type reset-remove rule (module docstring), shared by one
    field's :meth:`CrdtMap.remove` and the whole-map
    :meth:`CrdtMap.reset_observed`: returns ``(new_field_state,
    new_tomb)``."""
    if codec.name == "riak_dt_map":
        # recursive: erase what was observed at every level of the subtree
        return CrdtMap.reset_observed(espec, fs), tomb
    if codec.name in ("lasp_orset", "lasp_orset_gbtree"):
        return fs._replace(removed=fs.removed | fs.exists), tomb
    if codec.name == "riak_dt_orswot":
        return fs._replace(dots=torch.zeros_like(fs.dots)), tomb
    if codec.name == "riak_dt_gcounter":
        return fs, torch.maximum(tomb, fs.counts)
    # epoch-gated types (gset / ivar): bottom-reset
    return _bottom_like(codec, espec, fs), tomb


class CrdtMap(CrdtType):
    name = "riak_dt_map"

    @staticmethod
    def new(spec: MapSpec, device=None) -> MapState:
        dev = resolve_device(device)
        resets = _resets(spec)
        return MapState(
            clock=torch.zeros((spec.n_actors,), dtype=torch.int32, device=dev),
            dots=torch.zeros(
                (spec.n_fields, spec.n_actors), dtype=torch.int32, device=dev
            ),
            fields=tuple(
                codec.new(espec, device=dev) for _k, codec, espec in spec.fields
            ),
            epochs=(
                torch.zeros((spec.n_fields,), dtype=torch.int32, device=dev)
                if resets else None
            ),
            tombs=(
                tuple(
                    _tomb_bottom(codec, espec, dev)
                    for _k, codec, espec in spec.fields
                )
                if resets else None
            ),
        )

    @staticmethod
    def grow(spec: MapSpec, state: MapState) -> MapState:
        """Migrate a state laid out for a field-prefix of ``spec`` by
        appending bottom slots for the new fields, recursing into nested
        map fields whose own schema grew. Works on any leading batch dims
        (the runtime grows whole populations); the new slots own their
        storage. Returns ``state`` itself when nothing grew."""
        f_old = state.dots.shape[-2]
        f_new = spec.n_fields
        batch = tuple(state.dots.shape[:-2])
        dev = _device(state)
        fields = list(state.fields)
        changed = f_new != f_old
        for f in range(f_old):
            _k, codec, espec = spec.fields[f]
            if codec.name == "riak_dt_map":
                grown_sub = CrdtMap.grow(espec, fields[f])
                changed = changed or grown_sub is not fields[f]
                fields[f] = grown_sub
        if not changed:
            return state
        dots = state.dots
        if f_new != f_old:
            dots = torch.cat(
                [dots, torch.zeros(batch + (f_new - f_old, spec.n_actors),
                                   dtype=dots.dtype, device=dev)],
                dim=-2,
            )

        def spread(x):
            return x.expand(batch + tuple(x.shape)).clone()

        for _k, codec, espec in spec.fields[f_old:]:
            fields.append(tree_map(spread, codec.new(espec, device=dev)))
        epochs = state.epochs
        if epochs is not None and f_new != f_old:
            epochs = torch.cat(
                [epochs, torch.zeros(batch + (f_new - f_old,),
                                     dtype=epochs.dtype, device=dev)],
                dim=-1,
            )
        tombs = state.tombs
        if tombs is not None:
            grown = list(tombs)
            for _k, codec, espec in spec.fields[f_old:]:
                bt = _tomb_bottom(codec, espec, dev)
                grown.append(None if bt is None else spread(bt))
            tombs = tuple(grown)
        return state._replace(
            dots=dots, fields=tuple(fields), epochs=epochs, tombs=tombs
        )

    # -- updates ------------------------------------------------------------
    @staticmethod
    def touch(spec: MapSpec, state: MapState, field_idx: int, actor_idx) -> MapState:
        """Mark a field present with a fresh dot (the presence half of
        ``{update, Key, Op}``); the caller applies the embedded op."""
        clock, dots = mint_dot(state.clock, state.dots, field_idx, actor_idx)
        return state._replace(clock=clock, dots=dots)

    @staticmethod
    def set_field(spec: MapSpec, state: MapState, field_idx: int, fstate) -> MapState:
        fields = list(state.fields)
        fields[field_idx] = fstate
        return state._replace(fields=tuple(fields))

    @staticmethod
    def remove(spec: MapSpec, state: MapState, field_idx: int) -> MapState:
        """``{remove, Key}``: drop the presence dots (the clock witnesses
        them). In reset mode the embedded contents are reset-removed and
        the field's epoch advances."""
        dots = state.dots.clone()
        dots[..., field_idx, :] = 0
        out = state._replace(dots=dots)
        if not _resets(spec):
            return out
        f = field_idx
        _k, codec, espec = spec.fields[f]
        fields = list(out.fields)
        tombs = list(out.tombs)
        fields[f], tombs[f] = _reset_field(codec, espec, fields[f], tombs[f])
        epochs = out.epochs.clone()
        epochs[..., f] += 1
        return out._replace(fields=tuple(fields), tombs=tuple(tombs), epochs=epochs)

    @staticmethod
    def reset_observed(spec: MapSpec, state: MapState) -> MapState:
        """The reset-remove of a whole map state (a parent map removing the
        field that holds it): drop every presence dot, bump every epoch,
        reset each field per its type, recursively."""
        fields = list(state.fields)
        tombs = (
            list(state.tombs) if state.tombs is not None else [None] * len(fields)
        )
        for f, (_k, codec, espec) in enumerate(spec.fields):
            fields[f], tombs[f] = _reset_field(codec, espec, fields[f], tombs[f])
        out = state._replace(dots=torch.zeros_like(state.dots), fields=tuple(fields))
        if state.epochs is not None:
            out = out._replace(epochs=state.epochs + 1, tombs=tuple(tombs))
        return out

    @staticmethod
    def effective_field(spec: MapSpec, state: MapState, field_idx: int):
        """The embedded state with its tombstone baseline applied (what
        value decoding reads); plain-mode maps and tomb-less types return
        the raw embedded state."""
        fs = state.fields[field_idx]
        if state.tombs is None or state.tombs[field_idx] is None:
            return fs
        tomb = state.tombs[field_idx]
        # a row that has not absorbed the counts its floor witnesses clips
        # at zero
        return fs._replace(counts=fs.counts - torch.minimum(fs.counts, tomb))

    # -- lattice ------------------------------------------------------------
    @staticmethod
    def merge(spec: MapSpec, a: MapState, b: MapState) -> MapState:
        clock, dots = merge_dots(a.clock, a.dots, b.clock, b.dots)
        if not _resets(spec):
            fields = tuple(
                codec.merge(espec, fa, fb)
                for (_k, codec, espec), fa, fb in zip(spec.fields, a.fields, b.fields)
            )
            return MapState(clock=clock, dots=dots, fields=fields)
        # reset mode: contents join plainly except the epoch-gated types,
        # which join between equal eras (the side behind contributes bottom)
        epochs = torch.maximum(a.epochs, b.epochs)
        fields = []
        tombs = []
        for f, ((_k, codec, espec), fa, fb, ta, tb) in enumerate(
            zip(spec.fields, a.fields, b.fields, a.tombs, b.tombs)
        ):
            if codec.name in _EPOCH_GATED:
                bottom = codec.new(espec, device=_device(a))
                a_now = a.epochs[..., f] == epochs[..., f]
                b_now = b.epochs[..., f] == epochs[..., f]
                fa = tree_map(lambda x, bot: torch.where(_lift(a_now, x), x, bot),
                              fa, bottom)
                fb = tree_map(lambda x, bot: torch.where(_lift(b_now, x), x, bot),
                              fb, bottom)
            fields.append(codec.merge(espec, fa, fb))
            tombs.append(None if ta is None else torch.maximum(ta, tb))
        return MapState(
            clock=clock, dots=dots, fields=tuple(fields), epochs=epochs,
            tombs=tuple(tombs),
        )

    @staticmethod
    def value(spec: MapSpec, state: MapState) -> torch.Tensor:
        """bool[..., F]: field presence (embedded values decode host-side)."""
        return torch.any(state.dots > 0, dim=-1)

    @staticmethod
    def equal(spec: MapSpec, a: MapState, b: MapState) -> torch.Tensor:
        acc = all_trailing(a.clock == b.clock, 1) & all_trailing(a.dots == b.dots, 2)
        if _resets(spec):
            acc = acc & all_trailing(a.epochs == b.epochs, 1)
            for ta, tb in zip(a.tombs, b.tombs):
                if ta is not None:
                    acc = acc & all_trailing(ta == tb, 1)
        for (_k, codec, espec), fa, fb in zip(spec.fields, a.fields, b.fields):
            acc = acc & codec.equal(espec, fa, fb)
        return acc

    @staticmethod
    def is_inflation(spec: MapSpec, prev: MapState, cur: MapState) -> torch.Tensor:
        # clock descends (src/lasp_lattice.erl:166-167); reset eras and
        # tombstone baselines only ever advance
        out = clock_inflation(prev.clock, cur.clock)
        if _resets(spec):
            out = out & all_trailing(prev.epochs <= cur.epochs, 1)
            for tp, tc in zip(prev.tombs, cur.tombs):
                if tp is not None:
                    out = out & all_trailing(tp <= tc, 1)
        return out

    @staticmethod
    def is_strict_inflation(spec: MapSpec, prev: MapState, cur: MapState) -> torch.Tensor:
        # src/lasp_lattice.erl:264-271 (the orswot rule); in reset mode an
        # epoch advance under an unchanged clock still counts as change
        out = strict_clock_inflation(prev.clock, prev.dots, cur.clock, cur.dots)
        if _resets(spec):
            grew = any_trailing(cur.epochs > prev.epochs, 1)
            out = out | (clock_inflation(prev.clock, cur.clock) & grew)
        return out
