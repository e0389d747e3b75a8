"""Typed, bounded causal event log — "what happened to this variable,
in what order, at which replica" (a copy of ``lasp_tpu.telemetry.events``).

The metric registry answers *how much* and *how fast*; this log answers
*why*: which client op, merge, gossip delivery, threshold firing, or
membership change produced the state an operator is staring at. It is
the TPU rebuild of the introspection the reference scatters across
lager log lines, the update FSM's read-repair trace
(``src/lasp_update_fsm.erl:189-216``) and ``lasp_process``
notifications — as one ordered, bounded, exportable record stream.

Design rules (the PR-1 hot-path contract):

- **typed**: every record's ``etype`` must be one of :data:`EVENT_TYPES`
  — an unknown type is a loud ``ValueError`` at the emission site, and
  the type set is linted against docs/OBSERVABILITY.md by
  ``tools/check_metrics_catalog.py`` (Makefile ``verify``);
- **bounded**: records land in a ring (default 4096, oldest dropped,
  drops counted) — a long-lived process never grows without bound;
- **ordered**: a process-wide monotone ``seq`` stamps every record
  under the ring lock, so interleaved emitters (bridge connection
  threads, mesh batch dispatch) totally order;
- **cheap**: one lock + one dict append per event; per-op granularity
  (individual batch ops, per-edge recomputes, host merges) is the
  DEEP tier — :func:`emit_deep` no-ops unless :func:`set_deep` (or the
  ``LASP_EVENTS_DEEP`` env var) turned it on, so the hot paths pay one
  coarse event per dispatch, not one per op;
- **off-switch**: :func:`registry.set_enabled(False)` silences the log
  together with the instruments (the overhead guard's off arm).

Sinks: the ring (:func:`events`), an optional JSONL file
(``LASP_EVENTS_JSONL`` or :func:`configure`), and
:func:`export_chrome_trace` — Perfetto / ``chrome://tracing`` JSON of
events (instant markers) interleaved with the span ring (duration
slices), the offline surface behind ``lasp_tpu trace --var``.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from . import registry as _registry
from .sink import JsonlSink

DEFAULT_RING_SIZE = 4096

#: the event taxonomy — every name here must have a row in the Event
#: catalog table of docs/OBSERVABILITY.md (linted both ways)
EVENT_TYPES = frozenset({
    "bind",            # store bind verb resolved (inflated / ignored)
    "update",          # client op(s) applied (store or mesh row)
    "merge",           # DEEP: one host-path CRDT merge
    "delivery",        # one gossip step/block dispatch delivered states
    "threshold_fire",  # a watch / blocking read / trigger threshold met
    "membership",      # resize / partition plan / checkpoint restore
    "propagate",       # one dataflow propagate-to-fixpoint run
    "propagate_sweep", # one fused sweep's per-dst changed flags (flight drain)
    "edge_recompute",  # DEEP: one edge's recompute provenance
    "frontier_skip",   # dirty-set scheduling skipped vars/edges outright
    "chaos",           # fault injected/healed, crash/restore, degraded read
    "quorum",          # quorum FSM round summary / hinted handoff replay
    "serve",           # one serving-cycle summary (writes/reads/fires/shed)
    "aae",             # anti-entropy scrub/detect/incident lifecycle
})

_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=DEFAULT_RING_SIZE)
_seq = 0
_dropped = 0
_round = 0
_deep = os.environ.get("LASP_EVENTS_DEEP", "") not in ("", "0", "false")
_sink = JsonlSink("LASP_EVENTS_JSONL")
#: cached per-etype counters, keyed on the registry generation (the
#: same detach-on-reset discipline as the runtime's instrument cache)
_counters: "tuple | None" = None
_dropped_counters: "tuple | None" = None


def configure(jsonl_path: "str | None" = None,
              ring_size: "int | None" = None) -> None:
    """(Re)configure the sinks — same contract as ``spans.configure``:
    ``jsonl_path=None`` keeps the current file, ``""`` disables it."""
    global _ring
    _sink.configure(jsonl_path)
    if ring_size is not None:
        with _lock:
            _ring = collections.deque(_ring, maxlen=int(ring_size))


def set_deep(flag: bool) -> None:
    """Deep tracing switch: per-op / per-merge / per-edge events. Off by
    default — at population scale the deep tier emits per CLIENT OP and
    would dominate the hot path the overhead guard protects."""
    global _deep
    _deep = bool(flag)


def deep_enabled() -> bool:
    return _deep


def set_round(n: int) -> None:
    """Advance the process-level logical round clock (the gossip round
    counter events are stamped with). The mesh runtime advances it once
    per executed round; emitters may also pass an explicit ``round=``."""
    global _round
    with _lock:
        _round = int(n)


def current_round() -> int:
    return _round


def _counter_for(etype: str):
    global _counters
    gen = _registry.generation()
    if _counters is None or _counters[0] != gen:
        _counters = (gen, {})
    cache = _counters[1]
    c = cache.get(etype)
    if c is None:
        c = cache[etype] = _registry.get_registry().counter(
            "events_emitted_total",
            help="causal event-log records emitted, by event type",
            etype=etype,
        )
    return c


def _dropped_counter():
    global _dropped_counters
    gen = _registry.generation()
    if _dropped_counters is None or _dropped_counters[0] != gen:
        _dropped_counters = (gen, _registry.get_registry().counter(
            "events_dropped_total",
            help="causal event-log records evicted from the bounded "
                 "ring (oldest-first) — a nonzero rate means forensics "
                 "are incomplete; raise the ring size or drain sooner",
        ))
    return _dropped_counters[1]


def emit(etype: str, *, var=None, replica=None, shard=None,
         round: "int | None" = None, **attrs) -> None:
    """Append one event record. ``var``/``replica``/``shard`` are the
    provenance columns every consumer filters on; anything else rides in
    ``attrs``. No-ops when telemetry is disabled."""
    if etype not in EVENT_TYPES:
        raise ValueError(
            f"unknown event type {etype!r} (known: {sorted(EVENT_TYPES)}) "
            "— add it to EVENT_TYPES and the docs/OBSERVABILITY.md catalog"
        )
    if not _registry.enabled():
        return
    global _seq, _dropped
    rec: dict = {"kind": "event", "etype": etype, "ts": round_ts()}
    if var is not None:
        rec["var"] = var
    if replica is not None:
        rec["replica"] = int(replica)
    if shard is not None:
        rec["shard"] = int(shard)
    if attrs:
        rec["attrs"] = attrs
    with _lock:
        rec["round"] = _round if round is None else int(round)
        rec["seq"] = _seq
        _seq += 1
        dropped = len(_ring) == _ring.maxlen
        if dropped:
            _dropped += 1
        _ring.append(rec)
    _counter_for(etype).inc()
    if dropped:
        _dropped_counter().inc()
    _sink.append(rec)


def emit_deep(etype: str, **kw) -> None:
    """The deep tier: per-op granularity, off unless :func:`set_deep`."""
    if _deep:
        emit(etype, **kw)


def round_ts() -> float:
    return round(time.time(), 6)


def events(etype: "str | None" = None, var=None) -> list:
    """Snapshot of the ring (oldest first), optionally filtered by event
    type and/or provenance variable."""
    with _lock:
        out = list(_ring)
    if etype is not None:
        out = [r for r in out if r["etype"] == etype]
    if var is not None:
        out = [r for r in out if r.get("var") == var]
    return out


def stats() -> dict:
    with _lock:
        return {
            "ring": len(_ring),
            "ring_size": _ring.maxlen,
            "seq": _seq,
            "dropped": _dropped,
            "deep": _deep,
            "jsonl_path": _sink.path,
        }


def clear() -> None:
    """Drop the ring and reset the clocks (tests)."""
    global _seq, _dropped, _round
    with _lock:
        _ring.clear()
        _seq = 0
        _dropped = 0
        _round = 0


# ---------------------------------------------------------------------------
# causal history + Perfetto / Chrome-trace export
# ---------------------------------------------------------------------------

def causal_history(var, lineage: "dict | None" = None) -> list:
    """Every ringed event relevant to ``var``'s value: the variable's own
    records, records of every UPSTREAM variable per ``lineage`` (the
    ``Graph.lineage`` map ``{var: {"srcs": [...], ...}}`` — so a derived
    output's history reaches back through its combinator edges to the
    source updates), and population-level context (membership changes,
    deliveries, ``propagate`` summaries, and ``propagate_sweep``
    records — a FUSED propagate's per-round work is carried off-device
    by the flight-recorder ring (``telemetry.device``), so fused
    windows contribute REAL per-round/per-sweep records here, not just
    the collapsed summary), ordered by ``seq``."""
    wanted = {var}
    if lineage:
        wanted |= set(lineage)
        for entry in lineage.values():
            wanted.update(entry.get("srcs", ()))
    out = [
        r
        for r in events()
        if r.get("var") in wanted
        or (
            r.get("var") is None
            and r["etype"] in (
                "membership", "delivery", "propagate", "propagate_sweep",
            )
        )
    ]
    out.sort(key=lambda r: r["seq"])
    return out


def export_chrome_trace(fp, event_records: "list | None" = None,
                        span_records: "list | None" = None) -> int:
    """Write a Chrome-trace/Perfetto JSON object to ``fp``: span records
    become duration slices (``ph: "X"``), event records become instant
    markers (``ph: "i"``) carrying their provenance columns in ``args``.
    Defaults to the full rings. Returns the number of traceEvents."""
    import json

    from . import spans as _spans

    if event_records is None:
        event_records = events()
    if span_records is None:
        span_records = _spans.events()
    trace = []
    for rec in span_records:
        if rec.get("kind") != "span":
            continue
        trace.append({
            "name": rec["name"],
            "cat": "span",
            "ph": "X",
            "ts": rec["ts"] * 1e6,
            "dur": max(rec.get("seconds", 0.0), 0.0) * 1e6,
            "pid": 0,
            "tid": 0,
            "args": {
                "path": rec.get("path", rec["name"]),
                **rec.get("attrs", {}),
            },
        })
    for rec in event_records:
        args = {
            k: rec[k]
            for k in ("var", "replica", "shard", "round", "seq")
            if k in rec
        }
        args.update(rec.get("attrs", {}))
        trace.append({
            "name": rec["etype"],
            "cat": "event",
            "ph": "i",
            "s": "g",  # global-scope instant: visible at any zoom
            "ts": rec["ts"] * 1e6,
            "pid": 0,
            "tid": 0,
            "args": args,
        })
    trace.sort(key=lambda t: t["ts"])
    json.dump(
        {"traceEvents": trace, "displayTimeUnit": "ms"},
        fp,
        default=repr,
    )
    fp.write("\n")
    return len(trace)
