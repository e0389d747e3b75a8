"""Hierarchical span tracing: bounded ring + append-only JSONL event log
(a copy of ``lasp_tpu.telemetry.spans``; its profiler annotation is
``torch.profiler.record_function`` here).

A span is a named, nestable timing region (``span("gossip.round")`` >
``span("merge.orswot")``); the nesting path is tracked per thread, so
the bridge's per-connection threads interleave without corrupting each
other's lineage. Finished spans land in

- a **bounded in-memory ring** (default 2048 events, oldest dropped) —
  the flight recorder the CLI dumps with ``lasp_tpu metrics --jsonl``;
- an optional **append-only JSONL file** (one JSON object per line) —
  configure with :func:`configure` or the ``LASP_TELEMETRY_JSONL`` env
  var; write failures disable the sink loudly once rather than breaking
  the traced operation.

While a ``torch.profiler`` records, every span also opens a
``torch.profiler.record_function`` range of its own name, so the spans sit
on the device trace's clock; an idle profiler costs one check a span.
A region that runs once a chunk of a sweep or once a codec call (tens of
thousands of times a converge at 10M replicas) is a :class:`ranged`
region instead: the profiler's range alone, no ring record, so it never
pushes the whole operations out of the ring.

Span taxonomy (documented in docs/OBSERVABILITY.md): ``gossip.round``,
``gossip.converge``, ``merge.<crdt_type>``, ``mesh.update_batch``,
``dataflow.propagate``, ``bridge.<verb>``, and the port's own
(:data:`PORT_ONLY`, lasp_tpu_torch/telemetry/PORT_ONLY.md).
"""

from __future__ import annotations

import collections
import threading
import time

import torch

from . import registry as _registry
from .sink import JsonlSink

DEFAULT_RING_SIZE = 2048

#: the port's :class:`ranged` regions: profiler ranges with no ring record
RANGES = frozenset({"dataflow.trigger", "packed.pack", "packed.unpack"})

#: the span, range and metric names the port emits and ``lasp_tpu`` does
#: not (ROADMAP C13): the converge step's and the frontier round's parts,
#: the whole operations around them, and the counters the benchmark reads
PORT_ONLY = RANGES | frozenset({
    "dataflow.sweep", "gossip.pull", "frontier.reach", "frontier.dispatch",
    "frontier.reseed", "gossip.frontier_converge", "telemetry.emit",
    "mesh.ingest_cycle", "mesh.replica_value",
    "gossip_rounds_run_total", "gossip_frontier_dense_rounds_total",
    "ingest_cycle_ops_total",
})

_local = threading.local()
_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=DEFAULT_RING_SIZE)
#: the shared locked writer (telemetry/sink.py): serialize-and-write is
#: ONE critical section per record, so concurrent emitters (bridge
#: connection threads, mesh batch dispatch) can never interleave
#: partial lines — the same discipline the causal event log uses
_sink = JsonlSink("LASP_TELEMETRY_JSONL")


def configure(jsonl_path: "str | None" = None,
              ring_size: "int | None" = None) -> None:
    """(Re)configure the sinks. ``jsonl_path=None`` keeps any current
    file; pass ``""`` to close and disable the JSONL sink."""
    global _ring
    _sink.configure(jsonl_path)
    if ring_size is not None:
        with _lock:
            _ring = collections.deque(_ring, maxlen=int(ring_size))


def events() -> list:
    """Snapshot of the ring (oldest first)."""
    with _lock:
        return list(_ring)


def clear() -> None:
    with _lock:
        _ring.clear()


def _emit(rec: dict) -> None:
    with _lock:
        _ring.append(rec)
    _sink.append(rec)


class span:
    """Time a region as one span event (``with span(name, **attrs):``).
    Nesting is tracked per thread (``path`` joins enclosing span names
    with ``>``); duration is recorded whether or not the body raises (a
    failed round's timing is exactly the one you want on a dashboard),
    with ``error`` set to the exception type when it does. While a
    profiler records, the region is also a ``record_function`` range of
    the same name. A class, not a generator: the frontier round's parts
    are spans, thousands a burst, so their cost with tracing off is kept
    to the bookkeeping."""

    __slots__ = ("name", "attrs", "_ann", "_stack", "_path", "_ts", "_t0")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> None:
        if not _registry.enabled():
            self._stack = None
            return
        name = self.name
        # only while a profiler records (an idle ``record_function`` costs
        # ~10 µs a span); the range holds the span's own bookkeeping too,
        # so the host time a span costs lies under its name on the trace
        self._ann = None
        if torch._C._autograd._profiler_enabled():
            self._ann = torch.profiler.record_function(name)
            self._ann.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(name)
        self._stack = stack
        self._path = ">".join(stack)
        self._ts = time.time()
        self._t0 = time.perf_counter()

    def __exit__(self, exc_type, exc, tb) -> bool:
        stack = self._stack
        if stack is None:
            return False
        dt = time.perf_counter() - self._t0
        stack.pop()
        rec = {
            "kind": "span",
            "name": self.name,
            "path": self._path,
            "ts": round(self._ts, 6),
            "seconds": dt,
        }
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec["attrs"] = self.attrs
        _emit(rec)
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
        return False


class ranged:
    """A ``record_function`` range of ``name`` while telemetry is on and a
    profiler records, and nothing else: no ring record, no JSONL line, no
    place on the nesting path (:data:`RANGES`). For the regions that run
    once a chunk of a sweep or once a codec call; otherwise two checks."""

    __slots__ = ("name", "_ann")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self._ann = None
        if _registry.enabled() and torch._C._autograd._profiler_enabled():
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
        return False


def current_path() -> str:
    """``>``-joined names of the spans currently open on this thread."""
    return ">".join(getattr(_local, "stack", []))
