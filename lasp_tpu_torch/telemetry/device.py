"""Device-resident telemetry plane: the flight ring and the window log
(port of ``lasp_tpu.telemetry.device``).

Every fused execution path — ``fused_steps`` blocks, ``converge_on_device``,
the dataflow propagate's fused sweeps, chaos windows — runs rounds whose
per-round residuals never reach the host one at a time. This module keeps
them without adding a host sync:

- **flight ring** — :func:`ring_init` / :func:`ring_write` keep a small
  ``int32[K, W]`` tensor on the runtime's device, one record a round at
  slot ``round % K`` (an ``index_copy_`` whose round index may itself be a
  device tensor, so no round reads anything back); a fixed-length window
  lands its rounds in one copy (:func:`ring_write_block`). The last ``K``
  rounds survive any window length.
- **host drain** — :func:`decode_ring` unwraps the ring on the sync the
  window already performs; ``ReplicatedRuntime._drain_flight`` feeds the
  decoded rounds into the metric registry, the ConvergenceMonitor (the
  same curve points an unfused run gives), per-round ``delivery`` events,
  the kernel ledger's exact join tallies, and this module's bounded window
  log.

The host cost a window is bounded by ``K`` (config ``flight_rounds``),
amortized over the window's rounds.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

from . import registry as _registry

#: fallback flight-ring depth when no config is resolvable (the config
#: knob ``flight_rounds`` / env ``LASP_FLIGHT_ROUNDS`` is the real one)
DEFAULT_FLIGHT_ROUNDS = 64

#: host-side window log bound (windows, not rounds — one entry per
#: drained fused dispatch)
DEFAULT_LOG_WINDOWS = 256


def flight_rounds() -> int:
    """The configured ring depth ``K`` — last K rounds of per-round
    records survive each fused window."""
    from ..config import get_config

    return int(get_config().flight_rounds)


# ---------------------------------------------------------------------------
# the ring on the device
# ---------------------------------------------------------------------------

def ring_init(n_rounds: int, width: int, device=None):
    """A fresh ``int32[K, W]`` flight ring on ``device`` (the runtime's)."""
    import torch

    return torch.zeros((int(n_rounds), int(width)), dtype=torch.int32,
                       device=device)


def ring_write(ring, round_index, record, when=None):
    """Write one round's record at slot ``round_index % K`` in place and
    return the ring (the modulo ring: the last K rounds survive any window
    length). ``round_index`` is an int or a 0-d integer tensor on the
    ring's device — kept there, the write needs no host sync; ``record`` is
    any integer vector of width W (the per-var residual vector, per-dst
    changed flags). ``when`` (a port extension: a 0-d bool tensor) keeps
    the slot's old record where it is False, so a loop that ran past its
    last round writes nothing for the rounds after it."""
    import torch

    k = ring.shape[0]
    if isinstance(round_index, torch.Tensor):
        slot = torch.remainder(round_index.reshape(1).long(), k)
    else:
        slot = torch.tensor([int(round_index) % k], device=ring.device)
    rec = torch.as_tensor(record, device=ring.device).to(torch.int32).reshape(1, -1)
    if when is not None:
        rec = torch.where(when, rec, ring.index_select(0, slot))
    return ring.index_copy_(0, slot, rec)


def ring_write_block(ring, first_round: int, records):
    """Write the records of consecutive rounds ``first_round ..
    first_round + n - 1`` (a list of ``int32[W]`` vectors, or an ``[n, W]``
    tensor) in place in one copy: the last ``min(n, K)`` of them, at their
    slots ``round % K`` (the earlier ones the ring would overwrite anyway).
    ``first_round`` is a host int; the slots are made on the ring's
    device. Returns the ring."""
    import torch

    k = ring.shape[0]
    n = len(records)
    m = min(n, k)
    if isinstance(records, (list, tuple)):
        records = torch.stack(list(records)[n - m:])
    else:
        records = records[n - m:]
    last = int(first_round) + n
    slots = torch.arange(last - m, last, device=ring.device)
    if last > k:  # the window wrapped the ring
        slots = torch.remainder(slots, k)
    return ring.index_copy_(0, slots, records.to(torch.int32))


def decode_ring(ring, rounds: int):
    """Host-side unwrap of a drained ring (a tensor or an array): ``(records, overwritten)``
    where ``records`` is the retained per-round rows in ROUND ORDER
    (oldest first — the last ``min(rounds, K)`` rounds) and
    ``overwritten`` counts the prefix rounds the modulo ring lost.
    Round ``j`` lives at slot ``j % K``, so the retained suffix starts
    at slot ``(rounds - n) % K``."""
    import numpy as np

    if hasattr(ring, "detach"):
        ring = ring.detach().cpu().numpy()
    arr = np.asarray(ring)
    k = int(arr.shape[0])
    rounds = int(rounds)
    n = max(min(rounds, k), 0)
    overwritten = max(rounds - k, 0)
    start = (rounds - n) % k if k else 0
    records = [
        [int(x) for x in arr[(start + i) % k]] for i in range(n)
    ]
    return records, overwritten


# ---------------------------------------------------------------------------
# the host-side window log (the forensics surface behind `lasp_tpu flight`)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlightWindow:
    """One drained fused window: the per-round records that survived
    the ring plus the window's provenance."""

    family: str               # fused_block / converge / chaos_window / ...
    columns: tuple            # per-record column ids (var ids, dst names)
    rounds: int               # rounds the window executed
    overwritten: int          # prefix rounds the modulo ring lost
    records: list             # [retained][len(columns)] ints, round order
    seconds: float            # window wall time
    quiescent: "bool | None"  # reached the fixed point? None = n/a
    first_round: int = 0      # monitor round of records[0] (0 = unclocked)
    meta: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "family": self.family,
            "columns": list(self.columns),
            "rounds": int(self.rounds),
            "overwritten": int(self.overwritten),
            "records": [list(r) for r in self.records],
            "seconds": round(float(self.seconds), 6),
            "quiescent": self.quiescent,
            "first_round": int(self.first_round),
            "meta": dict(self.meta),
        }

    def residual_curve(self) -> list:
        """``[(round, total), ...]`` over the retained records — the
        same shape as ``ConvergenceMonitor.residual_curve``."""
        base = int(self.first_round)
        return [
            (base + i, int(sum(rec))) for i, rec in enumerate(self.records)
        ]


_lock = threading.Lock()
#: (registry generation, deque-of-FlightWindow) — generation-keyed like
#: every other telemetry cache, so ``telemetry.reset()`` (or the overhead
#: guard's scratch registry) detaches accumulated windows
_log: "tuple | None" = None


def _windows_locked() -> collections.deque:
    global _log
    gen = _registry.generation()
    if _log is None or _log[0] != gen:
        _log = (gen, collections.deque(maxlen=DEFAULT_LOG_WINDOWS))
    return _log[1]


def record_window(window: FlightWindow) -> None:
    """Append one drained window and bump the flight counters. No-ops
    when telemetry is disabled (the off-switch contract)."""
    if not _registry.enabled():
        return
    with _lock:
        _windows_locked().append(window)
    reg = _registry.get_registry()
    reg.counter(
        "flight_windows_total",
        help="fused windows drained through the flight recorder, by "
             "kernel family",
        family=window.family,
    ).inc()
    reg.counter(
        "flight_rounds_recorded_total",
        help="per-round flight records decoded host-side (retained "
             "ring rows across all drained windows)",
    ).inc(len(window.records))
    if window.overwritten:
        reg.counter(
            "flight_rounds_overwritten_total",
            help="rounds whose flight records the modulo-K ring "
                 "overwrote before the drain (window longer than "
                 "flight_rounds)",
        ).inc(window.overwritten)


def windows(family: "str | None" = None) -> list:
    """Snapshot of the window log (oldest first), optionally filtered
    by kernel family."""
    with _lock:
        out = list(_windows_locked())
    if family is not None:
        out = [w for w in out if w.family == family]
    return out


def last_window(family: "str | None" = None) -> "FlightWindow | None":
    ws = windows(family)
    return ws[-1] if ws else None


def clear() -> None:
    """Drop the window log (tests / fresh forensics baseline)."""
    with _lock:
        _windows_locked().clear()


def stats() -> dict:
    with _lock:
        ws = list(_windows_locked())
    return {
        "windows": len(ws),
        "log_size": DEFAULT_LOG_WINDOWS,
        "rounds_recorded": sum(len(w.records) for w in ws),
        "rounds_overwritten": sum(w.overwritten for w in ws),
        "families": sorted({w.family for w in ws}),
    }


def snapshot() -> dict:
    """The full recorder as plain data (JAX's ``lasp_tpu flight --export``
    artifact)."""
    return {
        "flight_rounds": flight_rounds(),
        "stats": stats(),
        "windows": [w.to_dict() for w in windows()],
    }


def render(ws: "list | None" = None, max_columns: int = 8) -> str:
    """Human dump of the recorder: one block per window, one line per
    retained round (round clock, total residual, leading per-column
    counts) — JAX's `lasp_tpu flight` output."""
    if ws is None:
        ws = windows()
    if not ws:
        return "flight recorder: no fused windows drained yet"
    lines: list = []
    for i, w in enumerate(ws):
        q = {True: "quiescent", False: "unconverged", None: "-"}[w.quiescent]
        lines.append(
            f"window {i}: family={w.family} rounds={w.rounds} "
            f"retained={len(w.records)} overwritten={w.overwritten} "
            f"{q} {w.seconds * 1e3:.2f}ms"
        )
        cols = list(w.columns[:max_columns])
        if cols:
            more = len(w.columns) - len(cols)
            suffix = f" (+{more} more)" if more > 0 else ""
            lines.append("  round  total  " + "  ".join(cols) + suffix)
        for j, rec in enumerate(w.records):
            rnd = w.first_round + j if w.first_round else j
            head = "  ".join(str(x) for x in rec[:max_columns])
            lines.append(f"  {rnd:>5}  {sum(rec):>5}  {head}")
        if w.meta:
            meta = " ".join(f"{k}={v}" for k, v in sorted(w.meta.items()))
            lines.append(f"  meta: {meta}")
    return "\n".join(lines)
