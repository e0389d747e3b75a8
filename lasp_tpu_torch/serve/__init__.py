"""Serving front-end (port of ``lasp_tpu.serve``): overload-hardened
ingestion for a replicated population.

- :mod:`.requests` — typed request tickets; every outcome is a typed
  terminal status (``done`` / ``error`` / ``shed`` / ``expired``);
  :class:`OverloadError`;
- :mod:`.admission` — bounded per-class queues, ``{busy, retry_after_ms}``
  load shedding and the degradation ladder;
- :mod:`.subscriptions` — threshold-reads / watches evaluated as ONE batched
  pass per variable on the card (fire-exactly-once);
- :mod:`.engine` — :class:`ServeFrontend` (coalescing ingest, deadline
  propagation, W=2 ack replication, the cycle overlapping fused gossip
  windows with host ingest) and :class:`ServeLoop`;
- :mod:`.harness` — the open-loop load harness behind the ``serve_load``
  scenario.
"""

from .admission import AdmissionController, BoundedQueue, LADDER
from .engine import ServeFrontend, ServeLoop
from .requests import (
    KINDS,
    OverloadError,
    PRIO_HIGH,
    PRIO_LOW,
    PRIO_NORMAL,
    Ticket,
    READ,
    WATCH,
    WRITE,
)
from .subscriptions import SubscriptionTable

__all__ = [
    "AdmissionController",
    "BoundedQueue",
    "KINDS",
    "LADDER",
    "OverloadError",
    "PRIO_HIGH",
    "PRIO_LOW",
    "PRIO_NORMAL",
    "READ",
    "ServeFrontend",
    "ServeLoop",
    "SubscriptionTable",
    "Ticket",
    "WATCH",
    "WRITE",
]
