"""Telemetry core (port of ``lasp_tpu.telemetry``): the metric registry,
span tracing, the causal event log, Prometheus / JSONL export and the
:class:`ConvergenceMonitor`.

- ``counter/gauge/histogram`` — typed instruments on the process-global
  registry (see :mod:`.registry`); ``set_enabled(False)`` flips them to
  no-ops.
- ``span`` — nested timing regions into a bounded ring + optional JSONL
  log (see :mod:`.spans`); ``annotate=True`` adds a
  ``torch.profiler.record_function`` range.
- ``events`` — the typed, bounded causal event log (see :mod:`.events`).
- ``get_monitor()`` — the process-global :class:`ConvergenceMonitor`
  (see :mod:`.convergence`).
- ``render_prometheus`` / ``dump_jsonl`` — the scrape / offline surfaces
  (see :mod:`.export`).

Registry, sink, spans, events and export are copies of the JAX package's
pure-Python modules; the same emissions render the same text and records
in both packages. The kernel cost ledger, the device flight ring and the
runtime's per-step emission are not ported yet.
"""

from __future__ import annotations

from . import convergence, events
from .convergence import ConvergenceMonitor, get_monitor
from .export import dump_jsonl, metric_events, render_prometheus
from .registry import (
    DEFAULT_BUCKETS,
    Counter,
    CounterGroup,
    Gauge,
    Histogram,
    MetricRegistry,
    counter,
    enabled,
    gauge,
    get_registry,
    histogram,
    reset,
    set_enabled,
)
from .spans import clear as clear_spans
from .spans import configure, current_path, span
from .spans import events as span_events

__all__ = [
    "ConvergenceMonitor",
    "Counter",
    "CounterGroup",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "clear_spans",
    "configure",
    "convergence",
    "counter",
    "current_path",
    "dump_jsonl",
    "enabled",
    "events",
    "gauge",
    "get_monitor",
    "get_registry",
    "histogram",
    "metric_events",
    "render_prometheus",
    "reset",
    "set_enabled",
    "span",
    "span_events",
]
