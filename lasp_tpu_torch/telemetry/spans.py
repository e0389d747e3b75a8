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

``annotate=True`` additionally wraps the region in a
``torch.profiler.record_function`` while a profiler records, so spans show
up as named ranges in a ``torch.profiler`` trace.

Span taxonomy (documented in docs/OBSERVABILITY.md): ``gossip.round``,
``gossip.converge``, ``merge.<crdt_type>``, ``mesh.update_batch``,
``dataflow.propagate``, ``bridge.<verb>``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

from . import registry as _registry
from .sink import JsonlSink

DEFAULT_RING_SIZE = 2048

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


@contextlib.contextmanager
def span(name: str, annotate: bool = False, **attrs):
    """Time a region as one span event. Nesting is tracked per thread
    (``path`` joins enclosing span names with ``>``); duration is
    recorded whether or not the body raises (a failed round's timing is
    exactly the one you want on a dashboard), with ``error`` set to the
    exception type when it does."""
    if not _registry.enabled():
        yield
        return
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    path = ">".join(stack + [name])
    stack.append(name)
    ann = None
    if annotate:
        import torch

        # only while a profiler records (JAX's annotates only once jax is
        # imported): an idle ``record_function`` costs ~10 µs a span
        if torch._C._autograd._profiler_enabled():
            ann = torch.profiler.record_function(name)
            ann.__enter__()
    ts = time.time()
    t0 = time.perf_counter()
    err: "str | None" = None
    try:
        yield
    except BaseException as exc:
        err = type(exc).__name__
        raise
    finally:
        dt = time.perf_counter() - t0
        if ann is not None:
            ann.__exit__(None, None, None)
        stack.pop()
        rec = {
            "kind": "span",
            "name": name,
            "path": path,
            "ts": round(ts, 6),
            "seconds": dt,
        }
        if err is not None:
            rec["error"] = err
        if attrs:
            rec["attrs"] = attrs
        _emit(rec)


def current_path() -> str:
    """``>``-joined names of the spans currently open on this thread."""
    return ">".join(getattr(_local, "stack", []))
