"""Telemetry (port of ``lasp_tpu.telemetry``): the metric registry, span
tracing, the causal event log, Prometheus / JSONL export, the
:class:`ConvergenceMonitor`, the kernel cost ledger, the capability row and
the device flight ring.

- ``counter/gauge/histogram`` — typed instruments on the process-global
  registry (see :mod:`.registry`); ``set_enabled(False)`` flips them to
  no-ops.
- ``span`` — nested timing regions into a bounded ring + optional JSONL
  log (see :mod:`.spans`), each a ``torch.profiler.record_function``
  range while a profiler records (``spans.ranged``: that range alone, for
  the regions that run once a chunk or a codec call); ``spans.PORT_ONLY``
  names the spans, ranges and metrics the port emits and ``lasp_tpu``
  does not.
- ``events`` — the typed, bounded causal event log (see :mod:`.events`).
- ``get_monitor()`` — the process-global :class:`ConvergenceMonitor`
  (see :mod:`.convergence`).
- ``render_prometheus`` / ``dump_jsonl`` — the scrape / offline surfaces
  (see :mod:`.export`).
- ``get_ledger()`` / ``kernel_traffic`` — the kernel cost ledger and its
  analytic traffic model (see :mod:`.roofline`); ``device_capability()``
  — the peak-bandwidth row of the attached card (see :mod:`.capability`).
- :mod:`.device` — the flight ring every fused path carries on the card
  and the host's log of drained windows.
- :mod:`.overhead` — what the always-on emission costs a step.
- ``profile`` / ``profile_capture`` / ``capture_scenario`` — the
  ``torch.profiler`` block tracer and the whole-scenario capture hook,
  each writing a Chrome trace into the directory it is given.

Registry, sink, spans, events and export are copies of the JAX package's
pure-Python modules; the same emissions render the same text and records
in both packages. The runtime's per-step emission feeds all of them.
"""

from __future__ import annotations

from . import convergence, device, events
from .capability import device_capability, peak_gbps_for_kind
from .convergence import ConvergenceMonitor, get_monitor
from .export import dump_jsonl, metric_events, render_prometheus
from .roofline import (
    KernelLedger,
    capture_scenario,
    get_ledger,
    kernel_traffic,
    profile_capture,
)
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
from ..utils.metrics import profile

__all__ = [
    "ConvergenceMonitor",
    "Counter",
    "CounterGroup",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "KernelLedger",
    "MetricRegistry",
    "clear_spans",
    "configure",
    "convergence",
    "counter",
    "current_path",
    "device",
    "capture_scenario",
    "device_capability",
    "dump_jsonl",
    "enabled",
    "events",
    "gauge",
    "get_ledger",
    "get_monitor",
    "get_registry",
    "histogram",
    "kernel_traffic",
    "peak_gbps_for_kind",
    "metric_events",
    "profile",
    "profile_capture",
    "render_prometheus",
    "reset",
    "set_enabled",
    "span",
    "span_events",
]
