"""Typed metric registry: counters, gauges, histograms (a copy of
``lasp_tpu.telemetry.registry``, which is pure Python; SURVEY.md §5).

The reference has only lager log lines and per-type ``stats/1``
introspection (``src/lasp_orset.erl:156-192``); production operation of
the TPU build needs first-class, always-on metrics. This registry is the
one sink every layer (store, mesh, dataflow, bridge, CLI) emits into:

- **typed**: a name is registered once with one instrument type; a second
  registration under a different type is a loud ``TypeError`` (the same
  policy as the config's unknown-knob rejection) — no stringly-typed
  drift between emitters;
- **labeled**: one family per name, one series per sorted label set
  (``histogram("merge_seconds", type="lasp_orset")``), the Prometheus
  data model;
- **cheap**: an emission is a dict lookup + a locked integer/float
  update — microseconds, safe to leave on in the hot host paths (the
  device-side kernels are never touched; see docs/OBSERVABILITY.md for
  the measured overhead guard);
- **isolated snapshots**: :meth:`MetricRegistry.snapshot` deep-copies,
  so a scrape observes one coherent point in time.

The process-global default registry is what the module-level
:func:`counter` / :func:`gauge` / :func:`histogram` helpers write to and
what the CLI / bridge export. :func:`set_enabled` flips every helper to
no-op null instruments — the telemetry-off arm of the bench overhead
guard (``bench.py`` / ``tests/telemetry/test_overhead.py``).

The port emits the JAX package's metric names (the catalog table of
``docs/OBSERVABILITY.md``), so one scrape reads the same keys from
either package.
"""

from __future__ import annotations

import bisect
import threading
from collections.abc import MutableMapping

#: default histogram boundaries, in seconds: spans five decades from
#: 10 µs host-path blips to 10 s convergence runs; +Inf is implicit
DEFAULT_BUCKETS = (
    1e-5, 1e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0, 10.0,
)


class Counter:
    """Monotonic counter. ``inc`` with a negative delta raises — a
    counter that can go down is a gauge, and a consumer computing rates
    from it would silently produce garbage."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def inc(self, by: "int | float" = 1) -> None:
        if by < 0:
            raise ValueError(f"counter increments must be >= 0, got {by!r}")
        with self._lock:
            self.value += by


class Gauge:
    """Point-in-time value (set/inc/dec)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def set(self, value: "int | float") -> None:
        with self._lock:
            self.value = value

    def inc(self, by: "int | float" = 1) -> None:
        with self._lock:
            self.value += by

    def dec(self, by: "int | float" = 1) -> None:
        with self._lock:
            self.value -= by


def _check_buckets(b: tuple) -> None:
    if not b or list(b) != sorted(b) or len(set(b)) != len(b):
        raise ValueError(
            f"histogram buckets must be non-empty, sorted and distinct, "
            f"got {b!r}"
        )


class Histogram:
    """Fixed-boundary histogram (cumulative rendering happens at export;
    storage is per-bucket so observes stay O(log buckets))."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, lock: threading.Lock, buckets=DEFAULT_BUCKETS):
        b = tuple(float(x) for x in buckets)
        _check_buckets(b)
        self._lock = lock
        self.buckets = b
        self.counts = [0] * (len(b) + 1)  # last slot = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: "int | float") -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def cumulative(self) -> list:
        """Per-boundary cumulative counts (the ``le`` series, +Inf last)."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class _NullCounter:
    __slots__ = ()

    def inc(self, by=1) -> None:
        pass


class _NullGauge:
    __slots__ = ()

    def set(self, value) -> None:
        pass

    def inc(self, by=1) -> None:
        pass

    def dec(self, by=1) -> None:
        pass


class _NullHistogram:
    __slots__ = ()

    def observe(self, value) -> None:
        pass


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()

_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricRegistry:
    """One process-wide family table: ``name -> (type, help, series)``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, dict] = {}

    # -- instrument accessors (create-on-first-use) --------------------------
    def counter(self, name: str, help: "str | None" = None, **labels) -> Counter:
        return self._get(name, "counter", help, labels)

    def gauge(self, name: str, help: "str | None" = None, **labels) -> Gauge:
        return self._get(name, "gauge", help, labels)

    def histogram(
        self, name: str, help: "str | None" = None, buckets=None, **labels
    ) -> Histogram:
        return self._get(name, "histogram", help, labels, buckets=buckets)

    def _get(self, name, mtype, help, labels, buckets=None):
        key = _label_key(labels)
        if mtype == "histogram" and buckets is not None:
            # validate BEFORE the family registers: a rejected bucket
            # spec must not leave a poisoned family behind
            _check_buckets(tuple(float(x) for x in buckets))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = {
                    "type": mtype,
                    "help": help or "",
                    # histogram boundaries are a FAMILY property: every
                    # series of one name buckets identically, or the
                    # rendered le-grid would be incoherent. None = the
                    # defaults; an explicit empty tuple is rejected by
                    # the Histogram constructor below
                    "buckets": (
                        tuple(buckets) if buckets is not None
                        else DEFAULT_BUCKETS
                    ),
                    "series": {},
                }
            elif fam["type"] != mtype:
                raise TypeError(
                    f"metric {name!r} is a {fam['type']}, not a {mtype} — "
                    "one instrument type per name"
                )
            inst = fam["series"].get(key)
            if inst is None:
                if mtype == "histogram":
                    inst = Histogram(self._lock, fam["buckets"])
                else:
                    inst = _TYPES[mtype](self._lock)
                fam["series"][key] = inst
        return inst

    # -- introspection -------------------------------------------------------
    def names(self) -> set:
        with self._lock:
            return set(self._families)

    def snapshot(self) -> dict:
        """Deep, point-in-time copy: ``{name: {"type", "help", "series":
        [{"labels": {...}, ...values...}]}}`` — mutating the registry
        after the call never changes a snapshot already taken."""
        out: dict = {}
        with self._lock:
            for name, fam in self._families.items():
                series = []
                for key, inst in fam["series"].items():
                    entry: dict = {"labels": dict(key)}
                    if fam["type"] == "histogram":
                        entry["buckets"] = list(fam["buckets"])
                        entry["counts"] = list(inst.counts)
                        entry["sum"] = inst.sum
                        entry["count"] = inst.count
                    else:
                        entry["value"] = inst.value
                    series.append(entry)
                out[name] = {
                    "type": fam["type"],
                    "help": fam["help"],
                    "series": series,
                }
        return out

    def reset(self) -> None:
        """Drop every family (tests; a long-lived process never calls
        this). Instruments handed out earlier detach — callers must
        re-fetch by name."""
        with self._lock:
            self._families.clear()


# ---------------------------------------------------------------------------
# process-global default registry + enable switch
# ---------------------------------------------------------------------------

_default = MetricRegistry()
_enabled = True
_generation = 0


def get_registry() -> MetricRegistry:
    return _default


def generation() -> int:
    """Bumped by :func:`reset` — hot emitters that CACHE instrument
    objects (the runtime's per-round path) key their cache on this, so
    a test-time reset detaches stale instruments instead of letting
    them increment into the void."""
    return _generation


def set_enabled(flag: bool) -> None:
    """Flip the module-level helpers between live and null instruments
    (the telemetry-off arm of the bench overhead guard). Per-registry
    instruments already held stay live; only helper lookups change."""
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


def counter(name: str, help: "str | None" = None, **labels):
    if not _enabled:
        return NULL_COUNTER
    return _default.counter(name, help, **labels)


def gauge(name: str, help: "str | None" = None, **labels):
    if not _enabled:
        return NULL_GAUGE
    return _default.gauge(name, help, **labels)


def histogram(name: str, help: "str | None" = None, buckets=None, **labels):
    if not _enabled:
        return NULL_HISTOGRAM
    return _default.histogram(name, help, buckets=buckets, **labels)


def reset() -> None:
    global _generation
    _generation += 1
    _default.reset()


import contextlib as _contextlib


@_contextlib.contextmanager
def scratch_registry():
    """Route the module-level helpers to a FRESH registry for the
    duration of the block, then restore the real one — measurement
    harnesses (telemetry.overhead) use this so thousands of synthetic
    emissions never pollute live metrics. The generation bumps on both
    edges, so hot-path instrument caches (ReplicatedRuntime._instruments,
    StepTrace) detach from the scratch registry on exit instead of
    leaking emissions into it."""
    global _default, _generation
    saved = _default
    _default = MetricRegistry()
    _generation += 1
    try:
        yield _default
    finally:
        _default = saved
        _generation += 1


# ---------------------------------------------------------------------------
# typed fixed-key counter groups (the store's per-instance counters)
# ---------------------------------------------------------------------------


class CounterGroup(MutableMapping):
    """A fixed-key mapping of monotone integer counters — the typed
    replacement for ad-hoc ``{"binds": 0, ...}`` dicts (``Store.metrics``,
    the bridge's persisted counters record). Unknown keys raise
    ``KeyError`` at the write site instead of silently forking the schema;
    values must be non-negative ints. ``update`` exists for checkpoint
    restore (absolute values, still type-checked). Compares equal to any
    mapping with the same items (``collections.abc.Mapping`` semantics),
    so persistence round-trip tests keep working."""

    __slots__ = ("_vals",)

    def __init__(self, keys):
        object.__setattr__(self, "_vals", {k: 0 for k in keys})

    def __getitem__(self, key):
        return self._vals[key]

    def __setitem__(self, key, value):
        if key not in self._vals:
            raise KeyError(
                f"unknown counter {key!r} (schema: {sorted(self._vals)})"
            )
        if not isinstance(value, int) or value < 0:
            raise ValueError(
                f"counter {key!r} must be a non-negative int, got {value!r}"
            )
        self._vals[key] = value

    def __delitem__(self, key):
        raise TypeError("CounterGroup keys are fixed")

    def __iter__(self):
        return iter(self._vals)

    def __len__(self):
        return len(self._vals)

    def snapshot(self) -> dict:
        """Plain-dict copy with the stable key schema — what persistence
        layers serialize (see the schema note in bridge/server.py)."""
        return dict(self._vals)

    def __repr__(self):
        return f"CounterGroup({self._vals!r})"
