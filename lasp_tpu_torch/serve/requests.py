"""Typed serving requests and their lifecycle objects (a copy of
``lasp_tpu.serve.requests``).

The serving front-end (``serve.engine``) admits client work as
:class:`Ticket` objects — the host-side twin of the reference's
per-request coordination FSM (``src/lasp.erl:384-392`` parks the caller
in ``wait_for_reqid``; here the ticket IS the parked caller, resolved by
the serving cycle instead of a process message). Every outcome is a
TYPED terminal status, never a silent drop:

- ``done`` — the request executed; ``result`` holds its payload;
- ``error`` — the request executed and failed; ``error`` holds why;
- ``shed`` — admission control refused it (``retry_after_ms`` tells the
  client when to come back — the ``{busy, RetryAfterMs}`` wire reply);
- ``expired`` — the client's deadline passed before execution, so the
  work was CANCELLED rather than executed (stale work amplifies
  overload: the client has already given up, executing it helps nobody).

:class:`OverloadError` is the typed client-side surface of a ``shed``
outcome for callers that cannot retry (non-idempotent bridge verbs —
see ``bridge.BridgeClient``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

#: request classes — each gets its own bounded admission queue
WRITE = "write"
READ = "read"
WATCH = "watch"
KINDS = (WRITE, READ, WATCH)

#: request priorities; the degradation ladder's first rung sheds
#: low-priority reads before anything else degrades
PRIO_LOW = "low"
PRIO_NORMAL = "normal"
PRIO_HIGH = "high"
PRIORITIES = (PRIO_LOW, PRIO_NORMAL, PRIO_HIGH)


class OverloadError(RuntimeError):
    """The server shed the request (admission control / backpressure).

    Carries ``retry_after_ms`` — the server's estimate of when capacity
    returns. Raised by surfaces that cannot transparently retry: the
    bridge client's non-idempotent verbs surface this instead of
    replaying a write whose first outcome is unknown."""

    def __init__(self, message: str, retry_after_ms: int = 0):
        super().__init__(message)
        self.retry_after_ms = int(retry_after_ms)


class Ticket:
    """One admitted (or refused) serving request, resolved by the
    serving cycle. Thread-safe: clients submit from any thread while the
    serve loop resolves from its own."""

    __slots__ = (
        "kind", "var_id", "priority", "deadline", "submitted_at",
        "completed_at", "status", "result", "error", "retry_after_ms",
        "callback", "_lock", "payload",
    )

    def __init__(self, kind: str, var_id: Optional[str], *,
                 priority: str = PRIO_NORMAL,
                 deadline: Optional[float] = None,
                 submitted_at: float = 0.0,
                 callback: Optional[Callable] = None,
                 payload: Any = None):
        self.kind = kind
        self.var_id = var_id
        self.priority = priority
        self.deadline = deadline
        self.submitted_at = submitted_at
        self.completed_at: Optional[float] = None
        self.status = "queued"
        self.result: Any = None
        self.error: Optional[str] = None
        self.retry_after_ms = 0
        self.callback = callback
        self.payload = payload
        self._lock = threading.Lock()

    # -- lifecycle (exactly-once: the first terminal transition wins) -------
    def _terminal(self, status: str, now: float, *, result: Any = None,
                  error: Optional[str] = None,
                  retry_after_ms: int = 0) -> bool:
        """The single terminal transition. Result/error land BEFORE the
        status flip (which publishes them): a client thread polling
        ``status`` must never observe ``done`` with the result still
        unset."""
        with self._lock:
            if self.status != "queued":
                return False
            self.result = result
            self.error = error
            self.retry_after_ms = int(retry_after_ms)
            self.completed_at = now
            self.status = status  # publishes: always last
        if self.callback is not None:
            self.callback(self)
        return True

    def complete(self, result: Any, now: float = 0.0) -> bool:
        return self._terminal("done", now, result=result)

    def fail(self, error: str, now: float = 0.0) -> bool:
        return self._terminal("error", now, error=error)

    def shed(self, reason: str, retry_after_ms: int,
             now: float = 0.0) -> bool:
        return self._terminal("shed", now, error=reason,
                              retry_after_ms=retry_after_ms)

    def expire(self, now: float = 0.0) -> bool:
        return self._terminal("expired", now,
                              error="deadline expired before execution")

    @property
    def done(self) -> bool:
        return self.status != "queued"

    def latency(self) -> Optional[float]:
        """Submit-to-terminal latency in clock units (None while
        queued) — the per-request number behind the p50/p99 report."""
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    def __repr__(self):
        return (
            f"<Ticket {self.kind} {self.var_id!r} {self.status}"
            + (f" retry_after={self.retry_after_ms}ms"
               if self.status == "shed" else "")
            + ">"
        )
