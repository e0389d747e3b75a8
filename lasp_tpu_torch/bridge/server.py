"""Bridge server: the BEAM-facing face of the store (port of
``lasp_tpu.bridge.server``; states live on the server's device, CUDA by
default).

An Erlang Lasp node swaps its storage backend for this package by pointing
the ``lasp_backend`` behaviour (``src/lasp_backend.erl:26-28`` —
``start/1, put/3, get/2``) at this server. The BEAM-side adapter is
``lasp_tpu/bridge/erlang/lasp_tpu_backend.erl``; its entire job is
``gen_tcp`` with ``{packet, 4}`` framing plus ``term_to_binary`` /
``binary_to_term``, which is exactly what this server speaks (see
:mod:`.etf`), byte for byte as the JAX package's server does. The tests
drive it loopback from the Python :class:`BridgeClient`, which emits the
adapter's frames.

Protocol — one request term per frame, one response term per frame:

==================================================  =========================
request                                             response
==================================================  =========================
``{start, Name}``                                   ``{ok, Name}``
``{declare, Id, Type, CapsMap}``                    ``{ok, Id}``
``{put, Id, {Type, State, CapsMap}}``               ``ok``           (blind KV write: the reference backend contract, ets:insert semantics)
``{get, Id}``                                       ``{ok, {Type, State}}`` | ``{error, not_found}``
``{update, Id, Op, Actor}``                         ``{ok, Value}``
``{bind, Id, State}``                               ``{ok, Value}``  (merge + inflation gate, src/lasp_core.erl:291-312)
``{merge_batch, [{Id, State}, ...]}``               ``{ok, Count}``  (the batched anti-entropy RPC)
``{read, Id}``                                      ``{ok, Value}``
``{keys}``                                          ``{ok, [Id...]}``
``{metrics}``                                       ``{ok, PromTextBin}`` (telemetry scrape: Prometheus text exposition of the process registry; allowed before ``start``)
``{health}``                                        ``{ok, JsonBin}`` (ConvergenceMonitor state + alerts as a JSON object — residual/staleness per var, divergence top-K, quiescence ETA, replica/shard lag probe; allowed before ``start``, see docs/OBSERVABILITY.md)
``{idem, ReqIdBin, Request}``                       the inner request's response, AT-MOST-ONCE: a repeated ReqId within the dedup window returns the FIRST response without re-executing (how non-idempotent writes retry safely across reconnects — the client attaches a fresh random id per logical op and replays the same frame; durable stores persist the window, so the guarantee survives a server restart)
==================================================  =========================

Portable CRDT state encodings (id/elem/actor terms are arbitrary ETF
terms; tokens are integers into the declared token space):

- ``lasp_gset``: ``[Elem, ...]``
- ``lasp_orset`` / ``lasp_orset_gbtree``:
  ``[{Elem, [{Token, Deleted}, ...]}, ...]``  (the orddict-of-orddicts
  shape of ``src/lasp_orset.erl:42-45``, tokens dense)
- ``riak_dt_gcounter``: ``[{Actor, Count}, ...]``
- ``lasp_ivar``: ``undefined`` | ``{value, Term}``
- ``riak_dt_orswot``: ``{[{Actor, Count}, ...],
  [{Elem, [{Actor, Dot}, ...]}, ...]}``  (clock + per-element birth
  dots; no tombstones, no deferred ops)
- ``riak_dt_map``: ``{[{Actor, Count}, ...],
  [{Key, [{Actor, Dot}, ...], InnerState}, ...]}`` — one triple per
  schema field. The schema is DYNAMIC like the reference's: ``{Name,
  Type}`` keys admit on first update or on state import (declaring caps
  ``#{fields => [{Key, TypeAtom, Caps}, ...]}`` is pre-sizing only);
  presence dots follow OR-SWOT logic, ``InnerState`` is the field
  type's own portable shape.
  Values read back as proplists ``[{Key, Value}, ...]``
  (``riak_dt_map:value`` shape). Map update ops:
  ``{update, Key, InnerOp}``, ``{remove, Key}``, or the batched
  ``{update, [SubOp, ...]}``

Every connection owns an isolated :class:`~lasp_tpu_torch.store.Store`
(the per-vnode store of the reference; one vnode holds one connection) on
the server's device.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..store import Store
from ..telemetry import counter, get_monitor, histogram, render_prometheus, span
from ..utils.metrics import Timer
from . import etf
from .etf import Atom

_HDR = struct.Struct(">I")

#: label clamp for per-verb metrics: arbitrary client garbage must not
#: mint unbounded label cardinality in the registry
_METRIC_VERBS = frozenset({
    "start", "declare", "put", "get", "update", "bind", "merge_batch",
    "read", "keys", "metrics", "health", "idem",
})

#: bound on the per-store idem dedup window (FIFO): reply-loss retries
#: arrive within seconds, so a shallow window suffices — and an
#: unbounded one would grow with every write forever
_IDEM_WINDOW = 256

#: declare caps accepted over the wire, per type (mirrors store.ALLOWED_CAPS)
_CAP_KEYS = ("n_elems", "n_actors", "tokens_per_actor")


def _convert_op(op: tuple) -> tuple:
    """Wire op -> store op. Container positions that are op SYNTAX — the
    term collection of add_all/remove_all, and the nested field ops of
    the map's {update, Key, InnerOp} / {update, [SubOps]} — keep their
    shape; everything else is a TERM and goes through the key encoding."""
    verb_s = str(op[0])
    if verb_s in ("add_all", "remove_all"):
        return (verb_s, [_to_key(x) for x in op[1]])
    if verb_s == "update" and len(op) == 2 and isinstance(op[1], list):
        # riak_dt_map batched shape {update, [SubOps]}: every sub-op is
        # itself op syntax (store.py _apply_op accepts this shape)
        return (
            verb_s,
            [
                _convert_op(s if isinstance(s, tuple) else (s,))
                for s in op[1]
            ],
        )
    if verb_s == "update" and len(op) == 3:
        # riak_dt_map {update, Key, InnerOp}: Key is a term; InnerOp is
        # syntax and recurses (a bare atom like `increment` is an op too)
        inner = op[2] if isinstance(op[2], tuple) else (op[2],)
        return (verb_s, _to_key(op[1]), _convert_op(inner))
    return (verb_s,) + tuple(_to_key(x) for x in op[1:])


def _parse_caps(caps) -> dict:
    """Wire caps -> declare kwargs. Scalar capacities pass as ints; a
    ``fields`` entry (riak_dt_map pre-sized schema) is a list of
    ``{Key, TypeAtom, Caps}`` triples, recursively parsed."""
    kwargs = {}
    for k, v in (caps or {}).items():
        ks = str(k)
        if ks in _CAP_KEYS:
            kwargs[ks] = int(v)
        elif ks == "reset_on_readd":
            # ETF booleans arrive as the atoms true/false; anything else
            # is rejected — a silently-coerced typo would flip the map's
            # remove/re-add semantics with no error anywhere
            if v is True or str(v) == "true":
                kwargs[ks] = True
            elif v is False or str(v) == "false":
                kwargs[ks] = False
            else:
                raise ValueError(
                    f"reset_on_readd must be true or false, got {v!r}"
                )
        elif ks == "fields":
            kwargs["fields"] = [
                (
                    _to_key(fk),
                    str(ft),
                    {
                        str(ck): int(cv)
                        for ck, cv in (fc or {}).items()
                        if str(ck) in _CAP_KEYS
                    },
                )
                for fk, ft, fc in v
            ]
    return kwargs


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = _HDR.unpack(hdr)
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return buf


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _to_key(term: Any) -> Any:
    """ETF terms used as ids/elems/actors must be hashable, shape-faithful
    AND plain data: lists (unhashable), tuples, and atoms become
    value-tagged tuples of builtins, so ``[1,2]`` / ``{1,2}`` /
    ``'x'`` / ``<<"x">>`` all stay DISTINCT keys, round-trip via
    :func:`_from_key`, and — critically for durable stores — pickle into
    checkpoint manifests without referencing bridge classes (the
    restricted manifest unpickler admits no bridge module; an
    ``etf.Atom`` in an interner would make the log unloadable).

    Tag unambiguity: raw ETF decode never yields a plain tuple (tuples
    arrive only as containers, which this encoding always tags), so a
    tuple starting with "atom"/"list"/"tuple" is always ours."""
    if isinstance(term, Atom):  # BEFORE str/bytes checks: Atom is a str
        return ("atom", str(term))
    if isinstance(term, list):
        return ("list",) + tuple(_to_key(x) for x in term)
    if isinstance(term, tuple):
        return ("tuple",) + tuple(_to_key(x) for x in term)
    return term


def _from_key(term: Any) -> Any:
    if isinstance(term, tuple) and term:
        if term[0] == "atom" and len(term) == 2:
            return Atom(term[1])
        if term[0] == "list":
            return [_from_key(x) for x in term[1:]]
        if term[0] == "tuple":
            return tuple(_from_key(x) for x in term[1:])
    return term


# ---------------------------------------------------------------------------
# portable-state import/export
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _export_state(var, state=None) -> Any:
    tn = var.type_name
    state = var.state if state is None else state
    if tn == "lasp_gset":
        mask = _np(state.mask)
        return [_from_key(var.elems.terms()[i]) for i in np.flatnonzero(mask)]
    if tn in ("lasp_orset", "lasp_orset_gbtree"):
        exists = _np(state.exists)
        removed = _np(state.removed)
        out = []
        for e in np.flatnonzero(exists.any(axis=-1)):
            toks = [
                (int(t), bool(removed[e, t]))
                for t in np.flatnonzero(exists[e])
            ]
            out.append((_from_key(var.elems.terms()[int(e)]), toks))
        return out
    if tn == "riak_dt_gcounter":
        counts = _np(state.counts)
        return [
            (_from_key(a), int(counts[i]))
            for i, a in enumerate(var.actors.terms())
            if counts[i]
        ]
    if tn == "lasp_ivar":
        if not bool(state.defined):
            return None
        return (
            Atom("value"),
            _from_key(var.ivar_payloads.terms()[int(state.value)]),
        )
    if tn == "riak_dt_orswot":
        # {VClock, Entries} in portable form: the dense (clock, dot-matrix)
        # encoding round-trips as per-actor clock pairs + per-element dot
        # lists (riak_dt_orswot's own state shape, minus deferred ops,
        # which the synchronous bridge never accumulates)
        clock = _np(state.clock)
        dots = _np(state.dots)
        actors = var.actors.terms()
        clock_part = [
            (_from_key(actors[a]), int(clock[a])) for a in np.flatnonzero(clock)
        ]
        entries = []
        for e in np.flatnonzero(dots.any(axis=-1)):
            entries.append((
                _from_key(var.elems.terms()[int(e)]),
                [(_from_key(actors[a]), int(dots[e, a]))
                 for a in np.flatnonzero(dots[e])],
            ))
        return (clock_part, entries)
    if tn == "riak_dt_map":
        # {VClock, Fields}: per schema field a (key, presence-dots,
        # embedded-portable) triple. Embedded contents ride even for
        # absent fields: they are join-monotone across remove/re-add
        # here, so a faithful round-trip must carry them. reset_on_readd
        # maps append a third component of nonzero (key, epoch) pairs.
        clock = _np(state.clock)
        dots = _np(state.dots)
        actors = var.actors.terms()
        clock_part = [
            (_from_key(actors[a]), int(clock[a])) for a in np.flatnonzero(clock)
        ]
        fields_part = []
        for f, (key, _fcodec, _fspec) in enumerate(var.spec.fields):
            fdots = [
                (_from_key(actors[a]), int(dots[f, a]))
                for a in np.flatnonzero(dots[f])
            ]
            inner = _export_state(var.map_aux[f], state=state.fields[f])
            fields_part.append((_from_key(key), fdots, inner))
        if state.epochs is None:
            return (clock_part, fields_part)
        epochs = _np(state.epochs)
        epoch_part = [
            (_from_key(var.spec.fields[f][0]), int(epochs[f]))
            for f in np.flatnonzero(epochs)
        ]
        # reset-remove tombstone baselines (round 5): per counter field
        # with a nonempty baseline, (key, [(actor, floor), ...]) — the
        # one tomb-carrying type (OR-Set/ORSWOT resets ride in-state;
        # gset/ivar are epoch-gated). Losing floors on the wire would
        # resurrect reset counts at the receiver.
        tomb_part = []
        if state.tombs is not None:
            for f, (key, _fcodec, _fspec) in enumerate(var.spec.fields):
                tomb = state.tombs[f]
                if tomb is None:
                    continue
                t = _np(tomb)
                if not t.any():
                    continue
                payload = [
                    (_from_key(actors[a]), int(t[a]))
                    for a in np.flatnonzero(t)
                ]
                tomb_part.append((_from_key(key), payload))
        return (clock_part, fields_part, epoch_part, tomb_part)
    raise ValueError(f"bridge: unsupported type {tn!r}")


def _check_capacity(interner, terms, what: str) -> None:
    if interner is None:
        return
    new = {t for t in terms if t not in interner}
    free = interner.capacity - len(interner)
    if len(new) > free:
        raise ValueError(
            f"state names {len(new)} new {what}s but only {free} "
            f"slot(s) remain (capacity {interner.capacity}) — "
            "rejected before interning anything"
        )


def _validate_portable(var, portable: Any, _pending=None) -> None:
    """Full validation of a portable state WITHOUT touching any interner
    — structure (token ranges, dots vs the state's own clock, schema
    keys) AND interner capacity for every new elem/actor it names,
    recursing into map fields — so a rejected state consumes no capacity
    anywhere, including in embedded field universes.

    Dynamic map-field admission (schema growth) is NEVER applied
    mid-pass: every growth/resync lands as a closure on ``_pending`` and
    commits only after the WHOLE top-level state validated — a rejection
    at any depth leaves specs, shims, and states exactly as they were
    (the round-5 nested-map atomicity rule)."""
    top_level = _pending is None
    if top_level:
        _pending = []
    tn, spec = var.type_name, var.spec
    if tn == "lasp_gset":
        _check_capacity(var.elems, [_to_key(e) for e in portable or []], "elem")
    elif tn in ("lasp_orset", "lasp_orset_gbtree"):
        for _elem, toks in portable or []:
            for tok, _deleted in toks:
                if not 0 <= int(tok) < spec.n_tokens:
                    raise ValueError(
                        f"token {int(tok)} outside token space {spec.n_tokens}"
                    )
        _check_capacity(
            var.elems, [_to_key(e) for e, _t in portable or []], "elem"
        )
    elif tn == "riak_dt_gcounter":
        _check_capacity(
            var.actors, [_to_key(a) for a, _c in portable or []], "actor"
        )
    elif tn == "riak_dt_orswot":
        clock_part, entries = portable if portable else ([], [])
        pclock = {_to_key(a): int(c) for a, c in clock_part}
        for _elem, elem_dots in entries:
            for actor, count in elem_dots:
                seen = pclock.get(_to_key(actor), 0)
                if int(count) < 1 or int(count) > seen:
                    raise ValueError(
                        f"dot ({actor!r}, {int(count)}) outside the state's "
                        f"own clock ({seen}) — not a valid orswot state"
                    )
        _check_capacity(var.actors, pclock, "actor")
        _check_capacity(
            var.elems, [_to_key(e) for e, _d in entries], "elem"
        )
    elif tn == "riak_dt_map":
        from ..store.store import Store

        parts = _split_map_portable(var, portable)
        clock_part, fields_part, epoch_part, tomb_part = parts
        pclock = {_to_key(a): int(c) for a, c in clock_part}
        # dynamic schema: an incoming state may carry {Name, Type} fields
        # this node has never admitted (the reference merges fields it has
        # never seen). Resolve them FIRST and validate their contents
        # against detached temporary shims; the schema grows only at the
        # end, after the WHOLE state checks out — a rejected state must
        # not leave a half-grown schema (same no-capacity-consumed
        # contract as the interner rule above).
        known = {k for k, _c, _s in spec.fields}
        fresh, fresh_shims = [], {}
        for key in (
            [k for k, _fd, _i in fields_part]
            + [k for k, _e in epoch_part]
            + [k for k, _t in tomb_part]
        ):
            k = _to_key(key)
            if k not in known and k not in fresh_shims:
                triple = Store.resolve_dynamic_field(spec, k)
                fresh.append(triple)
                fresh_shims[k] = Store._field_shim(
                    var.id, k, triple[1], triple[2], var
                )
        for key, fdots, inner in fields_part:
            k = _to_key(key)
            for actor, count in fdots:
                seen = pclock.get(_to_key(actor), 0)
                if int(count) < 1 or int(count) > seen:
                    raise ValueError(
                        f"field dot ({actor!r}, {int(count)}) outside the "
                        f"state's own clock ({seen}) — not a valid map state"
                    )
            shim = fresh_shims.get(k)
            known_idx = None
            if shim is None:
                known_idx = spec.field_index(k)
                shim = var.map_aux[known_idx]
            _validate_portable(shim, inner, _pending)
            # NESTED maps: validating the inner portable may SCHEDULE
            # admissions inside the submap — the parent's field triple
            # must then track the shim's evolved spec at commit time, or
            # the import would build against the stale sub-schema
            if known_idx is not None and shim.type_name == "riak_dt_map":
                def _resync(var=var, f=known_idx, shim=shim):
                    if var.spec.fields[f][2] is not shim.spec:
                        var.spec = var.spec.replace_field_spec(f, shim.spec)

                _pending.append(_resync)
        for key, epoch in epoch_part:
            if int(epoch) < 0:
                raise ValueError(f"negative field epoch for {key!r}")
        tomb_actors: list = []
        for key, payload in tomb_part:
            k = _to_key(key)
            fcodec = (
                fresh_shims[k].codec
                if k in fresh_shims
                else spec.fields[spec.field_index(k)][1]
            )
            if fcodec.name != "riak_dt_gcounter":
                raise ValueError(
                    f"field {key!r} ({fcodec.name}) carries no tombstone "
                    "baseline on the wire (only counter floors do)"
                )
            for actor, floor in payload:
                if int(floor) < 1:
                    raise ValueError(
                        f"non-positive counter tomb floor for {key!r}"
                    )
                tomb_actors.append(_to_key(actor))
        _check_capacity(var.actors, list(pclock) + tomb_actors, "actor")
        if fresh:
            # this level validated: SCHEDULE the admission (bottom
            # fields, no observable change until the import lands).
            # Fresh NESTED map triples take their temp shim's spec at
            # commit time — the temp shims' own pending growth runs
            # first (appended during the inner frames), so nested
            # subfields are already folded in.
            # NOTE: this grows the STORE variable's spec directly — a
            # ReplicatedRuntime built over the same store still holds
            # population planes for the old field axis. That skew is
            # resolved lazily: the runtime's `_population` re-checks
            # spec/state field-axis agreement on every verb and
            # re-lays-out (bottom planes, observably a no-op) the next
            # time anything touches the variable.
            def _commit_fresh(
                var=var,
                keys=[k for (k, _c, _e) in fresh],
                shims=dict(fresh_shims),
            ):
                Store.grow_map_fields(
                    var,
                    [(k, shims[k].codec, shims[k].spec) for k in keys],
                )

            _pending.append(_commit_fresh)
    if top_level:
        # the WHOLE state validated: commit every scheduled admission in
        # recursion order (children before their parents' resyncs)
        for fn in _pending:
            fn()


def _import_state(var, portable: Any, device, *, _validated: bool = False):
    """The portable state as this variable's codec state, built on the host
    in JAX's dtypes and moved to ``device`` once a leaf."""

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    tn = var.type_name
    if not _validated:
        # may ADMIT dynamic map fields (growing var.spec) — read the spec
        # only afterwards so the imported state is laid out for the grown
        # schema, and migrate the variable's own live state (the bind /
        # merge_batch paths merge into it)
        _validate_portable(var, portable)
        if tn == "riak_dt_map" and var.state is not None:
            var.state = var.codec.grow(var.spec, var.state)
    spec = var.spec
    state = var.codec.new(spec, device=device)
    if tn == "lasp_gset":
        idx = [var.elems.intern(_to_key(e)) for e in (portable or [])]
        if idx:
            mask = np.zeros((spec.n_elems,), dtype=bool)
            mask[idx] = True
            state = state._replace(mask=dev(mask))
        return state
    if tn in ("lasp_orset", "lasp_orset_gbtree"):
        ex = np.zeros((spec.n_elems, spec.n_tokens), dtype=bool)
        rm = np.zeros_like(ex)
        for elem, toks in portable or []:
            e = var.elems.intern(_to_key(elem))
            for tok, deleted in toks:
                ex[e, int(tok)] = True
                rm[e, int(tok)] = bool(deleted)
        return state._replace(exists=dev(ex), removed=dev(rm))
    if tn == "riak_dt_gcounter":
        counts = np.zeros((spec.n_actors,), dtype=_np(state.counts).dtype)
        for actor, count in portable or []:
            counts[var.actors.intern(_to_key(actor))] = int(count)
        return state._replace(counts=dev(counts))
    if tn == "lasp_ivar":
        if portable is None:
            return state
        tag, value = portable
        return var.codec.set(
            spec, state, var.ivar_payloads.intern(_to_key(value))
        )
    if tn == "riak_dt_orswot":
        clock_part, entries = portable if portable else ([], [])
        clock = np.zeros((spec.n_actors,), dtype=np.int32)
        dots = np.zeros((spec.n_elems, spec.n_actors), dtype=np.int32)
        for actor, count in clock_part:
            clock[var.actors.intern(_to_key(actor))] = int(count)
        for elem, elem_dots in entries:
            e = var.elems.intern(_to_key(elem))
            for actor, count in elem_dots:
                dots[e, var.actors.intern(_to_key(actor))] = int(count)
        return state._replace(clock=dev(clock), dots=dev(dots))
    if tn == "riak_dt_map":
        clock_part, fields_part, epoch_part, tomb_part = (
            _split_map_portable(var, portable)
        )
        clock = np.zeros((spec.n_actors,), dtype=np.int32)
        dots = np.zeros((spec.n_fields, spec.n_actors), dtype=np.int32)
        for actor, count in clock_part:
            clock[var.actors.intern(_to_key(actor))] = int(count)
        fields = list(state.fields)
        for key, fdots, inner in fields_part:
            f = spec.field_index(_to_key(key))
            for actor, count in fdots:
                dots[f, var.actors.intern(_to_key(actor))] = int(count)
            fields[f] = _import_state(
                var.map_aux[f], inner, device, _validated=True
            )
        out = state._replace(
            clock=dev(clock), dots=dev(dots), fields=tuple(fields),
        )
        if state.epochs is not None:
            epochs = np.zeros((spec.n_fields,), dtype=np.int32)
            for key, epoch in epoch_part:
                epochs[spec.field_index(_to_key(key))] = int(epoch)
            tombs = list(out.tombs)
            for key, payload in tomb_part:  # counter floors only
                f = spec.field_index(_to_key(key))
                t = _np(tombs[f]).copy()
                for actor, floor in payload:
                    t[var.actors.intern(_to_key(actor))] = int(floor)
                tombs[f] = dev(t)
            out = out._replace(epochs=dev(epochs), tombs=tuple(tombs))
        return out
    raise ValueError(f"bridge: unsupported type {tn!r}")


def _split_map_portable(var, portable):
    """Normalize a portable map to (clock, fields, epochs, tombs). The
    epoch/tomb components exist only for reset_on_readd maps; their
    presence must match the variable's mode. A 3-tuple (an epoch-bearing
    state WITHOUT the tombs component, the pre-round-5 epoch-gate wire
    shape) is REJECTED: under round-5 merge rules (contents join plainly
    for non-epoch-gated types) importing it with empty baselines would
    let a remove the sender performed resurrect contents the RECEIVER
    still holds — the baselines are exactly the information that
    prevents that, and the sender never recorded them."""
    if not portable:
        return [], [], [], []
    resets = var.spec.reset_on_readd  # class-attr default on old pickles
    if len(portable) == 2:
        if resets:
            # reset-mode exports ALWAYS carry the epoch component (even
            # all-zero); a 2-tuple can only come from a plain-mode source,
            # whose era-0 contents this variable's epoch gate would treat
            # incoherently (silently resurrected or silently dropped)
            raise ValueError(
                "portable map state has no epoch component but "
                f"{var.id!r} was declared with reset_on_readd"
            )
        return portable[0], portable[1], [], []
    if len(portable) == 3:
        raise ValueError(
            "portable reset-map state carries no tombstone-baseline "
            "component (pre-round-5 wire shape); re-export it from a "
            "current node — importing it could resurrect reset contents"
        )
    if len(portable) == 4:
        if not resets:
            raise ValueError(
                "portable map state carries field epochs but "
                f"{var.id!r} was not declared with reset_on_readd"
            )
        return portable
    raise ValueError("portable map state must be a 2-, 3- or 4-tuple")


def _export_value(store: Store, var_id) -> Any:
    return _portable_value(store.value(var_id))


def _portable_value(v) -> Any:
    """Decoded value -> wire shape, recursively: sets sort into lists;
    map values become sorted proplists ``[{K, V}, ...]`` (the
    ``riak_dt_map:value`` shape — shape-faithful for any key term)."""
    if isinstance(v, (frozenset, set)):
        return sorted((_portable_value(t) for t in v), key=etf.encode)
    if isinstance(v, dict):
        # proplist [{K, V}], the reference's riak_dt_map:value shape —
        # shape-faithful for ANY key term (an ETF map would need hashable
        # python keys)
        return sorted(
            ((_from_key(k), _portable_value(val)) for k, val in v.items()),
            key=etf.encode,
        )
    return _from_key(v)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

#: mutating verbs -> write-through persistence after dispatch
_MUTATORS = frozenset({"declare", "put", "update", "bind", "merge_batch"})

#: compact the durable log every this many persisted mutations (superseded
#: records are pure waste until reclaimed — the bitcask merge role)
_COMPACT_EVERY = 256


class _Conn:
    """One connection = one vnode's store.

    With ``data_dir`` set, ``{start, Name}`` opens (or re-opens) a DURABLE
    store: the eleveldb/bitcask role of the reference backend
    (``src/lasp_eleveldb_backend.erl:38-53`` — one persistent store per
    partition, named by the start argument). Every mutating verb writes
    the variable's state through to the append-only host log (CRC'd
    records, per-put flush — per-op durability like the reference's
    backends), and a restarted connection that sends the same name gets
    its state back. One live connection per name at a time (the reference
    gives each partition exactly one owning vnode process)."""

    def __init__(self, n_actors: int, data_dir: Optional[str] = None,
                 locks: Optional[dict] = None,
                 idem: Optional[dict] = None,
                 admission=None, device=None):
        self.n_actors = n_actors
        self.data_dir = data_dir
        #: where every store of this connection keeps its states
        self.device = resolve_device(device)
        #: overload probe: callable(kind: "write"|"read") -> None
        #: (admitted) | retry_after_ms (shed). The serve layer's
        #: AdmissionController.probe fits directly — the socket layer
        #: then refuses with {busy, RetryAfterMs} BEFORE dispatching,
        #: so bridge clients and in-process submitters see one coherent
        #: overload picture (docs/SERVING.md)
        self._admission = admission
        self._locks = locks  # BridgeServer-owned {name: lock-holder}
        #: BridgeServer-owned {scope: OrderedDict[reqid -> etf bytes]}
        #: — the idem dedup windows (durable stores scope by NAME so a
        #: reconnect hits the same window; in-memory stores scope
        #: per-connection, because a reconnect gets a FRESH store and a
        #: cached response would claim a write the new store never saw)
        self._idem = idem
        self.store: Optional[Store] = None
        self._hs = None
        self._manifest: Optional[dict] = None
        self._name: Optional[str] = None
        self._writes = 0

    def _release(self) -> None:
        if self._hs is not None:
            try:
                self._hs.close()
            finally:
                self._hs = None
        if self._name is not None and self._locks is not None:
            self._locks.pop(self._name, None)
        self._name = None

    def _start_durable(self, name: str):
        import os
        import re

        if not re.fullmatch(r"[A-Za-z0-9._-]{1,128}", name):
            return (etf.ERROR, Atom("badarg"),
                    f"unusable store name {name!r}".encode())
        if self._locks is not None:
            # dict.setdefault is atomic under the GIL: exactly one of two
            # racing connections claims the name
            holder = self._locks.setdefault(name, self)
            if holder is not self:
                return (
                    etf.ERROR, Atom("locked"),
                    f"store {name!r} already open on another connection".encode(),
                )
        from ..store.checkpoint import load_store, save_store
        from ..store.host_store import HostStore

        # close the previous durable store (keeping the just-claimed name:
        # _release only drops self._name, which is still the OLD name here)
        old_name, self._name = self._name, None
        if self._hs is not None:
            try:
                self._hs.close()
            finally:
                self._hs = None
        if (
            old_name is not None
            and old_name != name
            and self._locks is not None
        ):
            self._locks.pop(old_name, None)
        os.makedirs(self.data_dir, exist_ok=True)
        path = os.path.join(self.data_dir, name)
        if os.path.exists(path):
            self.store = load_store(path, device=self.device)
        else:
            self.store = Store(n_actors=self.n_actors, device=self.device)
            save_store(self.store, path)  # manifest exists from first open
        if self._locks is not None:
            self._locks[name] = self
        self._name = name
        self._hs = HostStore(path)
        # open-time compaction on the bitcask waste_pct cue: the
        # periodic in-session compaction counter (_COMPACT_EVERY)
        # resets with every connection, so a restart-heavy workload
        # whose sessions each stay under the threshold would otherwise
        # grow the log WITHOUT BOUND — superseded varmeta/leaf records
        # plus evicted idem:<reqid> tombstones pile up while the live
        # key set stays constant. Folding them here keeps the file
        # proportional to live data across any restart cadence.
        try:
            _size = os.path.getsize(path)
        except OSError:
            _size = 0
        _stats = self._hs.stats()
        if (
            _stats["wasted_bytes"] > (1 << 16)
            and 2 * _stats["wasted_bytes"] > _size
        ):
            self._hs.compact()
        from ..store.checkpoint import loads_manifest

        self._manifest = loads_manifest(self._hs.get("manifest"))
        if self._idem is not None and name not in self._idem:
            # restore the persisted dedup window: an op acked before a
            # server restart must stay deduplicated after it. One
            # `idem:<reqid-hex>` record per cached response (pickled
            # (seq, etf-bytes) — plain data, no bridge classes), folded
            # back into insertion order by seq here; writes append one
            # small record each instead of re-pickling the window
            import collections

            recs = []
            for k in self._hs.keys():
                if isinstance(k, str) and k.startswith("idem:"):
                    raw = self._hs.get(k)
                    if raw is not None:
                        seq, resp = loads_manifest(raw)
                        recs.append((int(seq), bytes.fromhex(k[5:]), resp))
            recs.sort()
            self._idem[name] = collections.OrderedDict(
                (rid, (seq, resp)) for seq, rid, resp in recs
            )
        return (etf.OK, Atom(name))

    def _persist(self, var_ids) -> None:
        """Write-through the touched variables to the log — O(touched),
        not O(store): one ``varmeta`` + leaf records per touched var, a
        tiny counters record, and the header only when the var set grew.
        Ordering is crash-safe: varmeta (interner superset) lands BEFORE
        the state leaves, so a crash between the two restores a store
        whose interner merely lists an element the state doesn't carry
        yet — harmless — rather than state bits with no term to decode
        to."""
        if self._hs is None:
            return
        # records in the JAX package's file format (its class names, its
        # leaf dtypes), so either package's server reads this log back
        from ..store.checkpoint import (
            _leaf_key,
            _np_leaves,
            _var_manifest,
            _varmeta_key,
            dumps_manifest,
        )

        for var_id in var_ids:
            if var_id not in self.store.ids():
                continue
            var = self.store.variable(var_id)
            entry = _var_manifest(var)
            leaves = _np_leaves(var.state)
            entry["leaves"] = [(str(x.dtype), x.shape) for x in leaves]
            self._hs.put(_varmeta_key(var_id), dumps_manifest(entry))
            for i, x in enumerate(leaves):
                self._hs.put(_leaf_key(var_id, i), x.tobytes())
        ids = list(self.store.ids())
        if ids != self._manifest["var_ids"]:
            self._manifest["var_ids"] = ids
            self._hs.put("manifest", dumps_manifest(self._manifest))
        # counters-record schema (STABLE across PRs): {"schema": 1,
        # "metrics": <CounterGroup.snapshot(): binds / inflations /
        # ignored_binds / reads>, "mutations": int} — the typed registry
        # snapshot replaces the old untyped dict(store.metrics) payload;
        # readers (checkpoint.load_store) .get() the keys, so pre-schema
        # records load identically
        self._hs.put("counters", dumps_manifest(
            {"schema": 1, "metrics": self.store.metrics.snapshot(),
             "mutations": self.store.mutations}
        ))
        self._writes += 1
        if self._writes % _COMPACT_EVERY == 0:
            self._hs.compact()

    def close(self) -> None:
        if self._idem is not None:
            # connection-scoped windows die with the connection (their
            # store does too); name-scoped windows outlive it on purpose
            self._idem.pop(("conn", id(self)), None)
        self._release()

    def _idem_scope(self):
        """Dedup window key: the durable store NAME (a reconnect must
        hit the same window), else this connection (an in-memory
        reconnect gets a fresh store, so cross-connection dedup would
        claim writes the new store never saw)."""
        if self._hs is not None and self._name is not None:
            return self._name
        return ("conn", id(self))

    def _handle_idem(self, req: tuple) -> Any:
        """``{idem, ReqIdBin, Request}``: at-most-once execution of the
        inner request. A repeated id inside the window returns the
        CACHED response without re-dispatching — the mechanism that
        makes non-idempotent client writes (update/bind) safe to retry
        through the same reconnect/backoff path as reads. Only
        successful responses cache: a refused op may be legitimately
        re-attempted with the same id after the cause is fixed.

        Durability: the window piggybacks on the store's host log
        (written after the mutation's own persist). The commit point is
        the MUTATION record — a crash between the two records means the
        retry re-executes an op whose first execution is also the one
        the log replays, so CRDT-idempotent ops stay exact and the
        window of double-execution for non-idempotent ops is the
        microseconds between the two appends (the reference's backends
        make the same trade)."""
        if (
            len(req) != 3
            or not isinstance(req[1], (bytes, bytearray))
            or not isinstance(req[2], tuple)
            or not req[2]
        ):
            return (etf.ERROR, Atom("badarg"),
                    b"idem takes {idem, ReqIdBinary, RequestTuple}")
        reqid = bytes(req[1])
        inner = req[2]
        if str(inner[0]) == "idem":
            return (etf.ERROR, Atom("badarg"), b"idem does not nest")
        window = None
        if self._idem is not None:
            import collections

            window = self._idem.setdefault(
                self._idem_scope(), collections.OrderedDict()
            )
            hit = window.get(reqid)
            if hit is not None:
                counter(
                    "bridge_idem_hits_total",
                    help="idem-wrapped requests answered from the dedup "
                         "window without re-execution (retried writes)",
                ).inc()
                return etf.decode(hit[1])
        resp = self.handle(inner)
        is_err = isinstance(resp, tuple) and resp and resp[0] == etf.ERROR
        if window is not None and not is_err:
            last = next(reversed(window.values()))[0] + 1 if window else 0
            window[reqid] = (last, etf.encode(resp))
            if self._hs is not None:
                import pickle

                # ONE small append per write (the _persist discipline),
                # never a whole-window re-pickle; evictions delete their
                # record so compaction reclaims it
                self._hs.put(
                    f"idem:{reqid.hex()}",
                    pickle.dumps(window[reqid]),
                )
            while len(window) > _IDEM_WINDOW:
                old_rid, _ent = window.popitem(last=False)
                if self._hs is not None:
                    self._hs.delete(f"idem:{old_rid.hex()}")
        return resp

    def handle(self, req: Any) -> Any:
        if not isinstance(req, tuple) or not req:
            return (etf.ERROR, Atom("badarg"), b"request must be a tuple")
        verb = req[0]
        if (
            self._admission is not None
            and str(verb) not in ("start", "metrics", "health")
        ):
            # typed load shedding at the socket door: {busy, RetryAfterMs}
            # — never a silent drop, never a half-executed request.
            # Control verbs (start/metrics/health) always pass: an
            # operator must be able to scrape an overloaded server.
            kind = (
                "write"
                if str(verb) in _MUTATORS or str(verb) == "idem"
                else "read"
            )
            retry_ms = self._admission(kind)
            if retry_ms is not None:
                counter(
                    "bridge_busy_total",
                    help="bridge requests refused with {busy, "
                         "retry_after_ms} by admission control, by kind",
                    kind=kind,
                ).inc()
                return (Atom("busy"), int(retry_ms))
        if verb == "idem":
            return self._handle_idem(req)
        if verb == "start":
            raw_name = req[1] if len(req) > 1 else Atom("store")
            # binaries are the protocol's normal currency for names/ids
            name = (
                raw_name.decode("utf-8", "replace")
                if isinstance(raw_name, (bytes, bytearray))
                else str(raw_name)
            )
            if self.data_dir is not None:
                try:
                    return self._start_durable(name)
                except Exception as e:
                    # release a half-claimed name so a retry can succeed,
                    # and drop any previous store binding — verbs must not
                    # silently mutate an orphaned, no-longer-durable store
                    if (
                        self._locks is not None
                        and self._name != name
                        and self._locks.get(name) is self
                    ):
                        self._locks.pop(name, None)
                    # a failure after the HostStore opened (e.g. corrupt
                    # manifest) must not leak the log file handle; _release
                    # closes it (self._name is already None or the old
                    # name here, so the just-claimed `name` needs the
                    # explicit pop above either way)
                    self._release()
                    self.store = None
                    self._manifest = None
                    return (etf.ERROR, Atom(type(e).__name__), str(e).encode())
            self._release()
            self.store = Store(n_actors=self.n_actors, device=self.device)
            return (etf.OK, req[1] if len(req) > 1 else Atom("store"))
        if verb == "metrics":
            # scrape surface for the BEAM side (and any frame-speaking
            # client): the process-global registry as Prometheus text.
            # Deliberately allowed BEFORE {start, Name} — scraping must
            # never require claiming a store
            return (etf.OK, render_prometheus().encode())
        if verb == "health":
            # the convergence observatory: global ConvergenceMonitor
            # snapshot + alerts as JSON (the bridge speaks ETF, but the
            # payload is for dashboards/operators — JSON crosses every
            # boundary). Allowed before {start} like {metrics}.
            import json as _json

            return (
                etf.OK,
                _json.dumps(get_monitor().health(), default=repr).encode(),
            )
        if self.store is None:
            return (etf.ERROR, Atom("not_started"), b"send {start, Name} first")
        try:
            resp = self._dispatch(verb, req)
            if verb in _MUTATORS and self._hs is not None and resp and (
                not isinstance(resp, tuple) or resp[0] != etf.ERROR
            ):
                self._persist(self._touched(verb, req))
            return resp
        except KeyError as e:
            return (etf.ERROR, Atom("not_found"), repr(e).encode())
        except Exception as e:  # surface as an error term, keep serving
            return (etf.ERROR, Atom(type(e).__name__), str(e).encode())

    @staticmethod
    def _touched(verb: str, req: tuple) -> list:
        if verb == "merge_batch":
            return [_to_key(var_id) for var_id, _ in req[1]]
        return [_to_key(req[1])]

    def _dispatch(self, verb: str, req: tuple) -> Any:
        store = self.store
        if verb == "declare":
            _, raw_id, type_atom, caps = req
            var_id = _to_key(raw_id)
            kwargs = _parse_caps(caps)
            if var_id not in store.ids():
                store.declare(id=var_id, type=str(type_atom), **kwargs)
            return (etf.OK, raw_id)  # echo the id exactly as sent
        if verb == "put":
            _, var_id, payload = req
            var_id = _to_key(var_id)
            type_atom, portable, caps = payload
            kwargs = _parse_caps(caps)
            if var_id not in store.ids():
                store.declare(id=var_id, type=str(type_atom), **kwargs)
            var = store.variable(var_id)
            # the backend contract is a blind KV write (ets:insert role,
            # src/lasp_ets_backend.erl:49-51): the CALLER did the merge
            var.state = _import_state(var, portable, self.device)
            return etf.OK
        if verb == "get":
            _, var_id = req
            var_id = _to_key(var_id)
            if var_id not in store.ids():
                return (etf.ERROR, Atom("not_found"))
            var = store.variable(var_id)
            return (etf.OK, (Atom(var.type_name), _export_state(var)))
        if verb == "update":
            _, var_id, op, actor = req
            var_id = _to_key(var_id)
            if not isinstance(op, tuple):
                op = (op,)
            store.update(var_id, _convert_op(op), _to_key(actor))
            return (etf.OK, _export_value(store, var_id))
        if verb == "bind":
            _, var_id, portable = req
            var_id = _to_key(var_id)
            var = store.variable(var_id)
            # merge + inflation gate (src/lasp_core.erl:291-312)
            store.bind(var_id, _import_state(var, portable, self.device))
            return (etf.OK, _export_value(store, var_id))
        if verb == "merge_batch":
            _, items = req
            applied = []
            try:
                for var_id, portable in items:
                    var_id = _to_key(var_id)
                    var = store.variable(var_id)
                    store.bind(
                        var_id, _import_state(var, portable, self.device)
                    )
                    applied.append(var_id)
            except Exception:
                # a mid-batch failure leaves the applied prefix in memory
                # (bind is an idempotent join); the durable log must agree
                # with what a same-connection read now observes
                self._persist(applied)
                raise
            return (etf.OK, len(items))
        if verb == "read":
            _, var_id = req
            return (etf.OK, _export_value(store, _to_key(var_id)))
        if verb == "keys":
            return (etf.OK, [_from_key(k) for k in self.store.ids()])
        return (etf.ERROR, Atom("badarg"), f"unknown verb {verb}".encode())


class BridgeServer:
    """Loopback TCP server speaking the bridge protocol. ``port=0`` picks
    a free port (read it from :attr:`port` after :meth:`start`). Every
    connection's store keeps its states on ``device`` (default CUDA)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 n_actors: int = 16, data_dir: Optional[str] = None,
                 admission=None, device=None):
        self.device = resolve_device(device)
        self.host = host
        self.port = port
        self.n_actors = n_actors
        #: with a data_dir, {start, Name} opens a durable per-name store
        #: (the eleveldb per-partition persistence role)
        self.data_dir = data_dir
        #: overload probe shared by every connection (see _Conn)
        self.admission = admission
        self._store_locks: dict = {}
        self._idem_windows: dict = {}
        self._sock: Optional[socket.socket] = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._conns: set[socket.socket] = set()
        self._workers: set[threading.Thread] = set()
        self._conns_lock = threading.Lock()

    def start(self) -> int:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self.port

    def _accept_loop(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            # a connection's thread is kept only while it serves (a
            # long-lived server must not retain one per connection ever
            # made), so stop() can join the live ones
            worker = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            with self._conns_lock:
                self._conns.add(conn)
                self._workers.add(worker)
            worker.start()

    def _serve_conn(self, sock: socket.socket) -> None:
        state = _Conn(self.n_actors, self.data_dir, self._store_locks,
                      self._idem_windows, admission=self.admission,
                      device=self.device)
        try:
            with sock:
                while not self._stop.is_set():
                    try:
                        frame = _recv_frame(sock)
                    except OSError:
                        break
                    if frame is None:
                        break
                    try:
                        req = etf.decode(frame)
                        raw_verb = (
                            str(req[0])
                            if isinstance(req, tuple) and req
                            else "malformed"
                        )
                        verb = (
                            raw_verb if raw_verb in _METRIC_VERBS else "other"
                        )
                        with span(f"bridge.{verb}"):
                            with Timer() as t:
                                resp = state.handle(req)
                        counter(
                            "bridge_requests_total",
                            help="bridge protocol requests served, by verb",
                            verb=verb,
                        ).inc()
                        histogram(
                            "bridge_request_seconds",
                            help="bridge request handling wall time, by verb",
                            verb=verb,
                        ).observe(t.elapsed)
                        if (
                            isinstance(resp, tuple)
                            and resp
                            and resp[0] == etf.ERROR
                        ):
                            counter(
                                "bridge_errors_total",
                                help="bridge requests answered with an "
                                     "error term, by verb",
                                verb=verb,
                            ).inc()
                    except etf.ETFDecodeError as e:
                        counter(
                            "bridge_errors_total",
                            help="bridge requests answered with an error "
                                 "term, by verb",
                            verb="etf_decode",
                        ).inc()
                        resp = (etf.ERROR, Atom("etf_decode"), str(e).encode())
                    try:
                        _send_frame(sock, etf.encode(resp))
                    except OSError:
                        break
        finally:
            state.close()  # flush + release the durable store's name lock
            with self._conns_lock:
                self._conns.discard(sock)
                self._workers.discard(threading.current_thread())

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        # wake connection threads blocked in recv: a "stopped" server must
        # not keep answering existing clients
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        # join the accept loop and every connection still closing its store:
        # a thread left inside the device runtime or the host log while the
        # interpreter exits aborts the process
        with self._conns_lock:
            workers = list(self._workers)
        for t in self._threads + workers:
            if t is not threading.current_thread():
                t.join(timeout=30)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class BridgeClient:
    """Python reference client — emits byte-identical frames to the
    Erlang adapter (``lasp_tpu_backend.erl``). Used by the conformance
    tests; also handy as an ops tool against a live server.

    Resilience: IDEMPOTENT verbs (``get`` / ``read`` / ``metrics`` /
    ``health`` — pure reads whose double execution is harmless) retry
    transparently across connection failures with exponential backoff +
    jitter, reconnecting and replaying the session's ``{start, Name}``
    binding first, so a bridge server killed and restarted mid-session
    (a durable store picking its state back up) is invisible to read
    traffic. NON-idempotent verbs ``update`` / ``bind`` retry through
    the SAME path by attaching a client-generated request id
    (``{idem, ReqId, Request}``): the server's dedup window answers a
    replayed id from cache instead of re-executing, so a lost reply can
    no longer double-apply a counter increment — at-most-once, made
    retryable (pass ``idem_writes=False`` for the old fail-fast
    behavior). ``merge_batch`` / ``declare`` / ``put`` / ``start``
    still fail fast: their payloads are large or their replay semantics
    are the caller's business. ``retries`` bounds the extra attempts,
    ``backoff`` seeds the exponential delay (jittered ×[1, 2)), and
    ``timeout`` doubles as the per-call socket deadline (override per
    call via ``call(..., timeout=...)``).

    Overload: a server running admission control answers ``{busy,
    RetryAfterMs}`` instead of executing. Idempotent verbs (and
    idem-wrapped writes, which are at-most-once by the dedup window)
    honor the hint with CAPPED, JITTERED backoff — sleep
    ``min(RetryAfterMs/1000, busy_cap) × [1, 2)`` and retry within the
    same attempt budget. Verbs that cannot safely retry surface a typed
    :class:`~lasp_tpu_torch.serve.OverloadError` carrying the retry-after
    hint — the caller decides, nothing is silently dropped or blindly
    replayed.

    Thread safety: one request/response exchange owns the socket
    end-to-end under a per-connection lock — two threads sharing a
    client can no longer interleave their frames mid-verb and corrupt
    the wire stream."""

    #: verbs whose replay is observationally harmless (pure reads)
    IDEMPOTENT_VERBS = frozenset({"get", "read", "metrics", "health"})

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 retries: int = 2, backoff: float = 0.05,
                 idem_writes: bool = True, busy_cap: float = 1.0):
        self._host = host
        self._port = port
        self._timeout = timeout
        self._retries = max(0, int(retries))
        self._backoff = float(backoff)
        #: ceiling (seconds) on one busy-reply backoff sleep
        self._busy_cap = float(busy_cap)
        #: wrap update/bind in {idem, ReqId, _} so they retry safely
        self._idem_writes = bool(idem_writes)
        #: the session's {start, Name} frame, replayed on reconnect so a
        #: restarted durable server re-binds the same store
        self._session_frame: "bytes | None" = None
        #: one exchange (send + matching recv) at a time: the single ETF
        #: socket is a serial channel, and interleaved concurrent
        #: callers would corrupt the stream mid-verb
        self._io_lock = threading.Lock()
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def _reconnect(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout
        )
        if self._session_frame is not None:
            # re-bind the session's store; the replayed start's reply is
            # consumed here (an error reply surfaces on the retried verb)
            _send_frame(self._sock, self._session_frame)
            _recv_frame(self._sock)

    @staticmethod
    def _is_busy(resp: Any) -> bool:
        return (
            isinstance(resp, tuple)
            and len(resp) == 2
            and resp[0] == Atom("busy")
            and isinstance(resp[1], int)
        )

    def call(self, term: Any, *, idempotent: "bool | None" = None,
             timeout: "float | None" = None) -> Any:
        """One request/response exchange. ``idempotent=None`` (default)
        classifies by verb name against :data:`IDEMPOTENT_VERBS`; pass
        an explicit bool to override (e.g. a caller that KNOWS its
        ``update`` is an idempotent CRDT op and accepts replay)."""
        verb = str(term[0]) if isinstance(term, tuple) and term else "?"
        if idempotent is None:
            idempotent = verb in self.IDEMPOTENT_VERBS
        attempts = 1 + (self._retries if idempotent else 0)
        last_exc: "Exception | None" = None
        with self._io_lock:
            reconnect = False
            for attempt in range(attempts):
                try:
                    if reconnect:
                        self._reconnect()
                        reconnect = False
                    self._sock.settimeout(
                        self._timeout if timeout is None else timeout
                    )
                    _send_frame(self._sock, etf.encode(term))
                    frame = _recv_frame(self._sock)
                    if frame is None:
                        raise ConnectionError(
                            "bridge server closed the connection"
                        )
                    resp = etf.decode(frame)
                except (ConnectionError, OSError) as exc:
                    last_exc = exc
                    reconnect = True
                    if not idempotent:
                        raise ConnectionError(
                            f"bridge call {verb!r} failed ({exc}); "
                            "non-idempotent verbs are never retried — "
                            "the op's outcome is unknown, check server "
                            "state and re-issue explicitly"
                        ) from exc
                    if attempt + 1 < attempts:
                        import random
                        import time

                        delay = self._backoff * (2 ** attempt)
                        time.sleep(delay * (1.0 + random.random()))
                    continue
                if self._is_busy(resp):
                    retry_ms = int(resp[1])
                    if idempotent and attempt + 1 < attempts:
                        # capped jittered backoff honoring the server's
                        # hint; the connection itself is healthy — no
                        # reconnect, no session replay
                        import random
                        import time

                        delay = min(retry_ms / 1000.0, self._busy_cap)
                        time.sleep(
                            max(delay, self._backoff)
                            * (1.0 + random.random())
                        )
                        continue
                    from ..serve.requests import OverloadError

                    raise OverloadError(
                        f"bridge call {verb!r} shed by server admission "
                        f"control (retry after {retry_ms}ms)"
                        + ("" if idempotent else
                           " — non-idempotent verbs are never blindly "
                           "retried; honor retry_after_ms and re-issue"),
                        retry_after_ms=retry_ms,
                    )
                return resp
        raise ConnectionError(
            f"bridge call {verb!r} failed after {attempts} attempts "
            f"({last_exc})"
        ) from last_exc

    # convenience verbs mirroring lasp_tpu_backend.erl
    def start(self, name="store"):
        # bytes pass through as an ETF binary (BEAM nodes may name the
        # partition either way); strings ride as atoms
        term = (
            Atom("start"), name if isinstance(name, bytes) else Atom(name)
        )
        resp = self.call(term)
        # remember the binding for reconnect replay (only a successful
        # start: replaying a refused name would wedge every retry)
        if isinstance(resp, tuple) and resp and resp[0] == Atom("ok"):
            self._session_frame = etf.encode(term)
        return resp

    def declare(self, var_id, type_name: str, **caps):
        return self.call(
            (Atom("declare"), var_id, Atom(type_name),
             {Atom(k): v for k, v in caps.items()})
        )

    def put(self, var_id, type_name: str, state, **caps):
        return self.call(
            (Atom("put"), var_id,
             (Atom(type_name), state, {Atom(k): v for k, v in caps.items()}))
        )

    def get(self, var_id):
        return self.call((Atom("get"), var_id))

    def _write_call(self, term: tuple):
        """Non-idempotent write: attach a fresh request id and ride the
        idempotent retry path — the server's dedup window makes the
        replay at-most-once (see ``{idem, ...}`` in the protocol
        table). With ``idem_writes=False``: the legacy fail-fast."""
        if not self._idem_writes:
            return self.call(term)
        import os

        return self.call(
            (Atom("idem"), os.urandom(16), term), idempotent=True
        )

    def update(self, var_id, op: tuple, actor):
        return self._write_call((Atom("update"), var_id, tuple(op), actor))

    def bind(self, var_id, state):
        return self._write_call((Atom("bind"), var_id, state))

    def merge_batch(self, items):
        return self.call((Atom("merge_batch"), list(items)))

    def read(self, var_id):
        return self.call((Atom("read"), var_id))

    def metrics(self):
        """``{metrics}`` -> ``{ok, <Prometheus text binary>}`` — the
        scrape verb (works before ``start``)."""
        return self.call((Atom("metrics"),))

    def health(self):
        """``{health}`` -> ``{ok, <JSON binary>}`` — the ConvergenceMonitor
        snapshot + alerts (works before ``start``)."""
        return self.call((Atom("health"),))

    def close(self) -> None:
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
