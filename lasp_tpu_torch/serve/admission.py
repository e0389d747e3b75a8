"""Admission control + backpressure: bounded per-class queues, typed
load shedding, and the degradation ladder (a copy of
``lasp_tpu.serve.admission``).

The robustness spine of the serving front-end (docs/SERVING.md): when
offered load exceeds capacity the layer must stay CORRECT and BOUNDED —
queues never grow without limit, refusals are typed ``{busy,
retry_after_ms}`` (never a silent drop), and degradation is an explicit
LADDER driven by queue-depth/latency signals rather than an emergent
collapse:

====  =======================  =========================================
rung  name                     effect
====  =======================  =========================================
0     normal                   everything admitted (within queue bounds)
1     shed_low_reads           low-priority reads refused at the door
2     widen_coalesce           write coalescing window widens (larger
                               megabatches per dispatch amortize the
                               fixed dispatch cost exactly when the
                               backlog is deepest)
3     reject_writes            writes refused; reads/watches still served
                               (a saturated store serves its readers —
                               the CAP-ish last resort)
====  =======================  =========================================

Transitions use hysteresis (enter above the rung's enter-fraction,
leave only after the pressure stays below its exit-fraction for
``hysteresis_cycles`` serving cycles) so the ladder cannot flap once
per cycle at a threshold boundary.

``retry_after_ms`` is an honest estimate, not a constant: backlog depth
divided by the EWMA drain rate of recent cycles, clamped to
``[min_retry_ms, max_retry_ms]`` — a client that honors it arrives
roughly when its queue has space again.
"""

from __future__ import annotations

import collections
import threading
from typing import Optional

from ..telemetry import counter, gauge
from . import requests as rq

#: default per-class queue capacities (requests)
DEFAULT_CAPACITY = {rq.WRITE: 8192, rq.READ: 8192, rq.WATCH: 8192}

#: ladder rung names, indexed by level
LADDER = ("normal", "shed_low_reads", "widen_coalesce", "reject_writes")


class BoundedQueue:
    """Thread-safe bounded FIFO with a high-water mark. ``offer`` never
    blocks: a full queue refuses (the caller turns that into a typed
    shed, never a silent drop)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self.high_water = 0
        #: high-water mark since the last take_window() — the ladder's
        #: pressure signal (post-drain depth hides a burst the cycle
        #: absorbed at full queues)
        self._window_high = 0

    def offer(self, item) -> bool:
        with self._lock:
            if len(self._q) >= self.capacity:
                self._window_high = max(self._window_high, self.capacity)
                return False
            self._q.append(item)
            n = len(self._q)
            if n > self.high_water:
                self.high_water = n
            if n > self._window_high:
                self._window_high = n
            return True

    def take_window(self) -> int:
        """The high-water mark since the previous call (and reset)."""
        with self._lock:
            hw = max(self._window_high, len(self._q))
            self._window_high = len(self._q)
            return hw

    def drain(self, limit: Optional[int] = None) -> list:
        """Pop up to ``limit`` items (all, when None) in FIFO order."""
        with self._lock:
            n = len(self._q) if limit is None else min(limit, len(self._q))
            return [self._q.popleft() for _ in range(n)]

    @property
    def depth(self) -> int:
        return len(self._q)


class AdmissionController:
    """Per-class bounded admission + the degradation ladder; see the
    module doc. One controller per serving front-end; the bridge server
    can share it via :meth:`probe` so socket-level and in-process
    clients see one coherent overload picture."""

    def __init__(self, *, capacity: "dict | None" = None,
                 enter=(0.5, 0.75, 0.92), exit=(0.3, 0.5, 0.7),
                 hysteresis_cycles: int = 2, widen_factor: int = 4,
                 min_retry_ms: int = 5, max_retry_ms: int = 2000):
        caps = dict(DEFAULT_CAPACITY)
        caps.update(capacity or {})
        unknown = set(caps) - set(rq.KINDS)
        if unknown:
            raise TypeError(
                f"unknown request classes {sorted(unknown)} "
                f"(known: {list(rq.KINDS)})"
            )
        if len(enter) != 3 or len(exit) != 3:
            raise ValueError("enter/exit need one fraction per rung 1..3")
        if any(x >= e for e, x in zip(enter, exit)):
            # exit must sit strictly below enter or hysteresis is void
            raise ValueError(
                f"exit fractions {exit} must be below enter {enter}"
            )
        self.queues = {k: BoundedQueue(caps[k]) for k in rq.KINDS}
        self.enter = tuple(float(e) for e in enter)
        self.exit = tuple(float(x) for x in exit)
        self.hysteresis_cycles = int(hysteresis_cycles)
        self.widen_factor = int(widen_factor)
        self.min_retry_ms = int(min_retry_ms)
        self.max_retry_ms = int(max_retry_ms)
        self.level = 0
        #: ladder transition log: (cycle, old_level, new_level, pressure)
        self.transitions: list = []
        self._lock = threading.Lock()
        self._cycle = 0
        self._calm_cycles = 0
        #: EWMA of requests drained per second (the retry_after model)
        self._drain_rate = 0.0
        self._pressure = 0.0

    # -- the admission decision ----------------------------------------------
    def admit(self, ticket: "rq.Ticket") -> "tuple | None":
        """``None`` = admitted (the ticket landed in its class queue);
        otherwise ``(reason, retry_after_ms)`` — the typed refusal the
        caller must surface. Admission is the ONLY door: the ladder's
        shed rungs act here, so a shed request costs queue space and
        cycle time for nobody."""
        kind = ticket.kind
        level = self.level
        if level >= 3 and kind == rq.WRITE:
            return ("writes_rejected", self.retry_after_ms(kind))
        if level >= 1 and kind == rq.READ and ticket.priority == rq.PRIO_LOW:
            return ("shed_low_priority", self.retry_after_ms(kind))
        if not self.queues[kind].offer(ticket):
            return ("queue_full", self.retry_after_ms(kind))
        return None

    def probe(self, kind: str = rq.WRITE) -> "int | None":
        """Overload probe WITHOUT enqueueing — ``None`` when a request
        of ``kind`` would currently be admitted, else ``retry_after_ms``.
        This is the hook the bridge server's ``admission=`` parameter
        takes: the socket layer refuses with ``{busy, RetryAfterMs}``
        before decoding/dispatching the request body."""
        if kind not in rq.KINDS:
            kind = rq.WRITE
        q = self.queues[kind]
        if self.level >= 3 and kind == rq.WRITE:
            return self.retry_after_ms(kind)
        if q.depth >= q.capacity:
            return self.retry_after_ms(kind)
        return None

    def retry_after_ms(self, kind: str) -> int:
        """Backlog / drain-rate estimate, clamped; see the module doc."""
        depth = self.queues[kind].depth
        rate = self._drain_rate
        if rate <= 0.0:
            est = self.max_retry_ms
        else:
            est = 1000.0 * (depth + 1) / rate
        return int(min(max(est, self.min_retry_ms), self.max_retry_ms))

    # -- the signal feed (one call per serving cycle) -------------------------
    def observe_cycle(self, cycle_seconds: float, drained: int) -> int:
        """Fold one serving cycle's signals in and resolve the ladder
        level. ``drained`` = requests the cycle resolved (feeds the
        drain-rate EWMA). Returns the level in force for the NEXT
        cycle."""
        with self._lock:
            self._cycle += 1
            if cycle_seconds > 0.0:
                inst = drained / cycle_seconds
                self._drain_rate = (
                    inst if self._drain_rate == 0.0
                    else 0.8 * self._drain_rate + 0.2 * inst
                )
            # pressure = worst WINDOW high-water fraction, not the
            # post-drain depth: a burst the cycle absorbed at a full
            # queue (shedding at the door the whole time) must climb
            # the ladder even though the drain emptied the queue
            pressure = max(
                (q.take_window() / q.capacity if q.capacity else 0.0)
                for q in self.queues.values()
            )
            self._pressure = pressure
            old = self.level
            # climb immediately: overload must not wait out hysteresis
            target = 0
            for rung, frac in enumerate(self.enter, start=1):
                if pressure >= frac:
                    target = rung
            if target > self.level:
                self._set_level(target, pressure)
                self._calm_cycles = 0
            elif self.level > 0 and pressure < self.exit[self.level - 1]:
                # descend one rung at a time, only after sustained calm
                self._calm_cycles += 1
                if self._calm_cycles >= self.hysteresis_cycles:
                    self._set_level(self.level - 1, pressure)
                    self._calm_cycles = 0
            else:
                self._calm_cycles = 0
            if self.level != old or self._cycle == 1:
                gauge(
                    "serve_degradation_level",
                    help="current degradation-ladder rung (0 normal, 1 "
                         "shed low reads, 2 widen coalesce, 3 reject "
                         "writes)",
                ).set(self.level)
            return self.level

    def _set_level(self, new: int, pressure: float) -> None:
        old = self.level
        self.level = int(new)
        self.transitions.append(
            (self._cycle, old, self.level, round(pressure, 4))
        )
        counter(
            "serve_ladder_transitions_total",
            help="degradation-ladder rung changes, by direction",
            direction="up" if new > old else "down",
        ).inc()

    # -- views ----------------------------------------------------------------
    def coalesce_multiplier(self) -> int:
        """How much wider the write-coalescing window runs at the
        current rung (1 below rung 2)."""
        return self.widen_factor if self.level >= 2 else 1

    def depths(self) -> dict:
        return {k: q.depth for k, q in self.queues.items()}

    def snapshot(self) -> dict:
        return {
            "level": self.level,
            "rung": LADDER[self.level],
            "pressure": round(self._pressure, 4),
            "drain_rate_per_s": round(self._drain_rate, 2),
            "depths": self.depths(),
            "high_water": {
                k: q.high_water for k, q in self.queues.items()
            },
            "capacity": {k: q.capacity for k, q in self.queues.items()},
            "transitions": list(self.transitions[-32:]),
        }
