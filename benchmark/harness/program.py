"""What the port's own spans and counters say, for the per-layer readers
that read them.

A reader's ``install`` asks :func:`require` for its names. The program
must emit each of them (``lasp_tpu_torch.telemetry.spans.PORT_ONLY``) with
telemetry on, or the run fails; a reader also raises when its counter
never moved or the traced window holds none of its span, so a metric
cannot fall silent. The benchmark's files may run over a checkout of the
program from before it named any span or counter of its own (no
``PORT_ONLY`` at all): there :func:`require` says so, the reader installs
nothing, and its metric is left out of the line.

Spans are read off the profiler's trace, where every span and range of
the port is a range of its own name while the profiler records
(``TraceData.spans``, µs on the trace's clock); only those that start
inside the window's timed ranges count."""

from __future__ import annotations

import bisect

from .trace import _merge


def require(metric: str, *own: str) -> bool:
    """Whether ``metric`` can be read: False on a program that names no
    span or counter of its own; raises when the program does not name
    each of ``own`` (the port's own names the metric reads) or telemetry
    is off."""
    from lasp_tpu_torch.telemetry import registry, spans

    named = getattr(spans, "PORT_ONLY", None)
    if named is None:
        return False
    gone = [n for n in own if n not in named]
    if gone:
        raise RuntimeError(f"{metric}: the program emits no {', '.join(gone)}; "
                           "the metric would fall silent")
    if not registry.enabled():
        raise RuntimeError(f"{metric}: telemetry is off, so {', '.join(own)} "
                           "records nothing; the metric would fall silent")
    return True


def counter_total(name: str) -> float:
    """The sum over every series of the counter ``name`` (0 before its
    first increment)."""
    from lasp_tpu_torch.telemetry import registry

    fam = registry.get_registry().snapshot().get(name)
    return sum(s["value"] for s in fam["series"]) if fam else 0.0


def counters_now(names) -> dict:
    return {n: counter_total(n) for n in names}


def moved(before: dict, name: str) -> float:
    """How far counter ``name`` moved since ``before``."""
    return counter_total(name) - before[name]


def timed_spans(trace, name: str) -> list:
    """``(start, end)`` in µs of every span ``name`` that starts inside a
    timed range of the window, in order."""
    starts = [a for a, _b in trace.ranges]
    out = []
    for a, b, n in trace.spans:
        if n != name:
            continue
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a <= trace.ranges[i][1]:
            out.append((a, b))
    return out


def spans_or_raise(metric: str, trace, name: str) -> list:
    found = timed_spans(trace, name)
    if not found:
        raise RuntimeError(f"{metric}: the traced window holds no {name} span; "
                           "the metric would fall silent")
    return found


def seconds(spans) -> float:
    return sum(b - a for a, b in spans) / 1e6


def inside(spans, within) -> float:
    """µs of ``spans`` (in order) that lie inside any of ``within`` (ranges
    on one thread nest: a span lies wholly inside one or outside)."""
    starts = [a for a, _b in spans]
    total = 0.0
    for lo, hi in within:
        i = bisect.bisect_left(starts, lo)
        while i < len(spans) and spans[i][0] < hi:
            a, b = spans[i]
            if b <= hi:
                total += b - a
            i += 1
    return total


def device_seconds_launched(trace, under, besides=()) -> float:
    """Device time of the kernels, copies and fills whose launching
    operator started inside a span named in ``under`` and outside every
    span named in ``besides`` (the prefix ``x.`` names every span of
    ``x``)."""

    def union(names):
        def hit(n):
            return any(n.startswith(w) if w.endswith(".") else n == w for w in names)
        return _merge((a, b) for a, b, n in trace.spans if hit(n))

    def within(ranges, starts, t) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ranges[i][1]

    yes = union(under)
    no = union(besides) if besides else []
    yes_at, no_at = [a for a, _b in yes], [a for a, _b in no]
    total = 0.0
    for a, b, _n, corr in trace.device:
        t = trace.launched_at.get(corr)
        if t is None or not within(yes, yes_at, t):
            continue
        if no and within(no, no_at, t):
            continue
        total += b - a
    return total / 1e6
