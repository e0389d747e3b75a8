"""The traced window: ``torch.profiler`` over the same window as an
untraced run, read into the device's busy time, kernel time by name and
the host's spans over the device's idle gaps.

The timed parts of a window run inside ``bench.iteration`` ranges; the
harness's own work between them (restoring a snapshot, a digest, making
the next burst) lies outside, and only the ranges count: ``window_s`` is
their length and ``busy_s`` the union of device activity (kernels,
copies, fills) inside them. Arithmetic after ``chip_smoke._device_busy``
and ``_device_kernels``: user annotations are left out of device time,
and the busy time is the union of the device's intervals."""

from __future__ import annotations

import bisect
import contextlib
import re

import torch

ITERATION = "bench.iteration"


def _is_operator(e, name: str) -> bool:
    """A host operator, not a CUDA runtime or driver call (those number
    their correlations apart)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind()) == "cpu_op"
    return not (name.startswith("cuda") or re.match(r"cu[A-Z]", name))


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Tracer:
    """Profiles a window when enabled; otherwise its ranges cost
    nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.data = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        self.prof = prof

    def iteration(self):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(ITERATION)

    def read(self) -> "TraceData | None":
        if self.prof is None:
            return None
        if self.data is None:
            self.data = TraceData(self.prof)
        return self.data


class TraceData:
    """What one traced window recorded, inside the timed ranges, read from
    the profiler's raw events (the event tree ``prof.events()`` builds
    takes minutes on a window of host-bound cycles). Times in µs from the
    trace's start."""

    def __init__(self, prof):
        cuda = torch.autograd.DeviceType.CUDA
        res = prof.profiler.kineto_results
        base = res.trace_start_ns()
        ranges, device, spans, ops = [], [], [], {}
        for e in res.events():
            a = (e.start_ns() - base) / 1e3
            b = (e.end_ns() - base) / 1e3
            name = e.name()
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    device.append((a, b, name, e.linked_correlation_id()))
            elif e.is_user_annotation():
                (ranges if name == ITERATION else spans).append((a, b, name))
            elif _is_operator(e, name):
                ops[e.correlation_id()] = a
        self.ranges = _merge((a, b) for a, b, _n in ranges)
        starts = [a for a, _b in self.ranges]
        self.launched_at = ops
        self.device = []  # (start, end, name, launching op) inside a range
        for a, b, name, corr in device:
            i = bisect.bisect_right(starts, a) - 1
            if i < 0:
                continue
            lo, hi = self.ranges[i]
            a, b = max(a, lo), min(b, hi)
            if b > a:
                self.device.append((a, b, name, corr))
        self.device.sort()
        self.spans = sorted(spans)

    @property
    def window_s(self) -> float:
        return sum(b - a for a, b in self.ranges) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in _merge((a, b) for a, b, _n, _c in self.device)) / 1e6

    def kernel_seconds(self, symbol: str) -> float:
        return sum(b - a for a, b, n, _c in self.device if symbol in n) / 1e6

    def annotated_device_seconds(self, name: str) -> float:
        """Device time of the kernels whose launching operator started
        inside a host range called ``name``."""
        inside = _merge((a, b) for a, b, n in self.spans if n == name)
        starts = [a for a, _b in inside]
        total = 0.0
        for a, b, _n, corr in self.device:
            t = self.launched_at.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= inside[i][1]:
                total += b - a
        return total / 1e6

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest sums of idle gaps by the innermost span the host was in
        at each gap's middle."""
        by_op: dict = {}
        for a, b, n, _c in self.device:
            by_op[n] = by_op.get(n, 0.0) + (b - a) / 1e6
        # idle gaps inside the ranges, in time order
        holes = []
        busy = _merge((a, b) for a, b, _n, _c in self.device)
        j = 0
        for lo, hi in self.ranges:
            at = lo
            while j < len(busy) and busy[j][1] <= hi:
                a, b = busy[j]
                if a > at:
                    holes.append((at, a))
                at = max(at, b)
                j += 1
            if hi > at:
                holes.append((at, hi))
        # the innermost span open at each gap's middle: a sweep with a
        # stack of open spans (ranges on one thread nest)
        gaps: dict = {}
        stack, k = [], 0
        for a, b in holes:
            mid = (a + b) / 2
            while k < len(self.spans) and self.spans[k][0] <= mid:
                stack.append(self.spans[k])
                k += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            name = stack[-1][2] if stack else "host outside the program's spans"
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}
