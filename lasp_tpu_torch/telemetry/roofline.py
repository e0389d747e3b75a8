"""Roofline observatory: analytic per-kernel traffic model + cost ledger
(port of ``lasp_tpu.telemetry.roofline``).

- :func:`kernel_traffic` — the **analytic traffic model**: bytes moved and
  joins performed per dispatch for every gossip kernel family, from the
  ``(codec, spec, R, fanout, bucket, G_active)`` tuple
  ``mesh.plan.signature_of`` keys dispatches by. ``bytes_moved`` and
  ``joins`` equal JAX's for every family.
- :class:`KernelLedger` — the **cost ledger**: per kernel-signature
  dispatch counts, rounds, analytic bytes, joins and seconds, yielding
  achieved GB/s and roofline fraction against the capability registry
  (:mod:`.capability`).

The two Pallas families are the CUDA kernels here: ``cuda_dense`` (K1,
``ops/csrc/gossip_round_dense.cu``) and ``cuda_rows`` (K2 and K3,
``ops/csrc/gossip_round_rows.cu``), each with the bytes of its JAX
namesake: ``(K+2)·S``, the gather model of ``PERF.md`` §6. A dispatch that
ran a kernel's plain PyTorch version (a population on the CPU) is recorded
under the XLA arm's family name (``dense``, ``rows``, ``grouped_rows``),
as JAX records the arm that ran.

``xla_lo`` / ``xla_hi`` keep JAX's formulas so an estimate compares field
for field, but they bracket XLA's ``cost_analysis`` of a compiled
executable and have no meaning for eager PyTorch; ``cost_analysis_bytes``
and ``profile_capture`` read XLA's compilation and ``jax.profiler`` and
have no twin (``torch.profiler`` stands in for the latter).

Seconds: ``record`` takes the seconds its caller measured. On the card a
call returns before the kernels finish, so each dispatch site measures
across a sync the path already makes (the end of a fused block, a drain,
a host read of changed flags) and adds none for the ledger; with
``registry.enabled()`` false ``record`` is a no-op.

The ledger's lifetime follows the registry generation: ``telemetry.
reset()`` and ``registry.scratch_registry()`` detach it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

from . import registry as _registry
from .capability import device_capability
from .spans import span

#: neighbor/row index tables ride int32 on the wire
_IDX_BYTES = 4

#: every kernel family the model covers (tests pin the vocabulary).
#: ``cuda_dense`` / ``cuda_rows`` are the hand-written CUDA kernels
#: (``ops.cuda_gossip``; JAX's ``pallas_dense`` / ``pallas_rows``) —
#: separate families, so the ledger shows the kernels' achieved HBM
#: fraction next to the plain arms'
FAMILIES = (
    "dense",
    "shift",
    "rows",
    "grouped_dense",
    "grouped_rows",
    "cuda_dense",
    "cuda_rows",
    "step",
    "fused_block",
    "converge",
    "chaos_window",
    "boundary_exchange",
    "shard_exchange",
    "dataflow_fused",
    "quorum_step",
    "aae_hash",
    "ingest_apply",
    "handoff_transfer",
)


@dataclasses.dataclass(frozen=True)
class TrafficEstimate:
    """One dispatch's analytic traffic: see the module docstring for
    the two byte conventions."""

    bytes_moved: int
    xla_lo: int
    xla_hi: int
    joins: int


def state_row_bytes(states, n_replicas: int) -> int:
    """Per-replica-row state footprint of a live ``[R, ...]``
    population, from leaf shape/dtype metadata only (never reads device
    buffers — the ``rows_traffic_bytes`` discipline)."""
    import numpy as np

    from ..lattice.base import tree_leaves

    total = 0
    for leaf in tree_leaves(states):
        if hasattr(leaf, "element_size"):
            total += int(leaf.numel()) * int(leaf.element_size())
        else:
            arr = np.asarray(leaf)
            total += int(arr.size) * int(arr.dtype.itemsize)
    return total // max(int(n_replicas), 1)


def kernel_traffic(
    family: str,
    *,
    row_bytes: int,
    n_replicas: int,
    fanout: int,
    rows: "int | None" = None,
    g_active: int = 1,
    window: int = 1,
    leafwise: bool = True,
    exchange_rows: int = 0,
    n_vars: int = 1,
) -> TrafficEstimate:
    """Analytic traffic of ONE dispatch of ``family`` (see
    :data:`FAMILIES`). ``rows`` is the row-sparse bucket (pad slots
    move bytes too — they are real gather/scatter slots), ``g_active``
    the stacked group width, ``window`` the fused round count,
    ``exchange_rows`` the boundary-exchange row total for the
    partitioned family, ``n_vars`` the store width for the whole-store
    families (``step`` / ``fused_block`` / ``converge`` /
    ``chaos_window``, where ``row_bytes`` is the whole STORE's
    per-replica footprint)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r} "
                         f"(expected one of {FAMILIES})")
    R, K, G, T = int(n_replicas), int(fanout), int(g_active), int(window)
    S = int(row_bytes) * R  # one member's full-population footprint
    N = R * K * _IDX_BYTES  # the neighbor table
    pad = 4096  # small-constant fusion slack (scalars, predicates)

    if family in ("dense", "shift"):
        ntab = 0 if family == "shift" else N
        moved = (K + 2) * S
        lo = 2 * S + ntab
        hi = (
            round(1.15 * (2 * S + ntab)) + pad
            if leafwise
            else (2 + K) * S + ntab + pad
        )
        return TrafficEstimate(moved, lo, hi, R * K)

    if family == "cuda_dense":
        # K1, the hand-written streamed gather+join (JAX's pallas_dense):
        # K row reads + 1 own read + 1 write per replica per plane, never
        # a gathered HBM intermediate — ideal traffic IS the dense
        # convention (same numerator, so the two arms' achieved GB/s
        # compare directly)
        moved = (K + 2) * S
        lo = 2 * S + N
        hi = (2 + K) * S + N + pad
        return TrafficEstimate(moved, lo, hi, R * K)

    if family == "cuda_rows":
        # K2 / K3, the row-sparse gather–join–scatter kernels (JAX's
        # pallas_rows): per bucket slot, (K+1) row reads + the joined row
        # written, plus the slot's K+2 indices — same ideal numerator as
        # the ``rows`` family so the arms compare like for like
        F = int(rows or 0)
        moved = G * ((K + 2) * F * int(row_bytes) + F * (K + 2) * _IDX_BYTES)
        lo = G * (K + 2) * F * int(row_bytes)
        hi = (
            2 * G * S + G * (2 * K + 4) * F * int(row_bytes) + N + pad
        )
        return TrafficEstimate(moved, lo, hi, G * F * K)

    if family == "rows":
        F = int(rows or 0)
        moved = (K + 2) * F * int(row_bytes) + F * (K + 2) * _IDX_BYTES
        # measured shape (CPU cost_analysis): ~4S for the scatter's full
        # read+write on top of the base read, + per-row working buffers
        lo = 2 * S
        hi = 4 * S + N + (2 * K + 4) * F * int(row_bytes) + F * 64 + pad
        return TrafficEstimate(moved, lo, hi, F * K)

    if family == "grouped_dense":
        moved = G * (K + 2) * S
        lo = 2 * G * S + N
        hi = (
            round(1.15 * (2 * G * S + N)) + pad
            if leafwise
            else (2 + K) * G * S + N + pad
        )
        return TrafficEstimate(moved, lo, hi, G * R * K)

    if family == "grouped_rows":
        F = int(rows or 0)
        moved = G * ((K + 2) * F * int(row_bytes) + F * (K + 2) * _IDX_BYTES)
        lo = 2 * G * S
        # the vmapped rows kernel pays ~1.5x the single-var rows cost
        # per member (batched gathers materialize per-member full-state
        # intermediates — measured on the CPU backend)
        hi = (
            G * (6 * S + (2 * K + 6) * F * int(row_bytes) + F * 64)
            + N + 4 * pad
        )
        return TrafficEstimate(moved, lo, hi, G * F * K)

    if family in ("step", "fused_block", "converge", "chaos_window"):
        # whole-store families: row_bytes is the STORE's per-replica
        # footprint; the mask operand of a chaos window adds R*K bools
        # per round
        per_round = (K + 2) * S
        mask = R * K if family == "chaos_window" else 0
        moved = T * (per_round + mask)
        lo = T * (2 * S)
        hi = T * ((2 + K) * S + N + mask) + pad
        return TrafficEstimate(moved, lo, hi, T * R * K * int(n_vars))

    if family == "dataflow_fused":
        # the whole-graph propagate megakernel (dataflow.plan +
        # ops.fused.fused_dataflow_rounds): ``row_bytes`` is the
        # analytic traffic of ONE Jacobi sweep over the dirty closure
        # (every closure edge reads its source states + tables, every
        # distinct dst reads + writes once through the merge chain —
        # ``dataflow.plan.sweep_traffic_bytes``), ``window`` the sweeps
        # the on-device while_loop executed, ``n_vars`` the closure's
        # edge count. The xla bounds are nominal here: a while_loop's
        # ``cost_analysis`` is trip-count-blind, so no calibrated
        # cross-check exists for this family (unlike dense/rows/
        # grouped); the hi bound covers per-dst merge intermediates.
        moved = T * int(row_bytes)
        lo = T * int(row_bytes)
        hi = 3 * T * int(row_bytes) + pad
        return TrafficEstimate(moved, lo, hi, T * int(n_vars))

    if family == "quorum_step":
        # the quorum FSM transition kernel (quorum.fsm.transition_
        # batched): pure CONTROL-PLANE traffic — per request the
        # struct-of-arrays slices (state/coord/deadline/need ~16B) plus
        # the pick/ack/reach lanes (K slots × ~6B: int32 pick + bools),
        # plus the shared component labeling + liveness planes (R × 5B)
        # read once per dispatch. ``rows`` is the padded request bucket,
        # ``fanout`` the preflist width N. Deliberately tiny next to the
        # state-moving families — the point of the ledger row is showing
        # that coordination control costs ~nothing next to the joins it
        # schedules. No calibrated xla bounds (the kernel is a handful
        # of elementwise ops; cost_analysis noise dominates).
        F = int(rows or 0)
        moved = F * (16 + 6 * K) + R * 5
        lo = F * (8 + 4 * K)
        hi = 4 * moved + pad
        return TrafficEstimate(moved, lo, hi, F * K)

    if family == "aae_hash":
        # the AAE row-hash kernel (aae.hashtree): per hashed row one
        # full state-row read plus a 4-byte hash out, stacked G-wide
        # for plan-group dispatches; ``rows`` is the rows hashed
        # (bucket-padded subsets move their pad slots too). The hi
        # bound covers the uint32 word-view materialization the XLA
        # lowering may pay on bool planes. No joins — hashing reads,
        # never merges.
        F = int(rows or 0)
        moved = G * F * (int(row_bytes) + 4)
        lo = G * F * int(row_bytes)
        hi = 3 * G * F * (int(row_bytes) + 4) + pad
        return TrafficEstimate(moved, lo, hi, 0)

    if family == "ingest_apply":
        # the grouped client-op apply kernel (mesh.ingest): per table
        # slot the scatter indices/payload stream in (~4 int32-ish
        # columns) and the targeted state entries read+write — bounded
        # above by one full row per slot (an OR-Set tombstone rewrites
        # a [T] token row; a counter bump touches one lane), plus the
        # [G, R] changed-flag plane out. Coarse by design, like
        # ``quorum_step``: the ledger row exists to show ingest's
        # device cost next to the gossip rounds it feeds, not to chase
        # an HBM bound (the kernel is scatter-latency-, not
        # bandwidth-, limited). No calibrated xla bounds.
        F = int(rows or 0)
        moved = G * F * (4 * _IDX_BYTES + 2 * int(row_bytes)) + G * R
        lo = G * F * 4 * _IDX_BYTES
        hi = 4 * moved + 2 * G * S + pad
        return TrafficEstimate(moved, lo, hi, G * F)

    if family == "handoff_transfer":
        # the grouped ownership-transfer join (membership.handoff.
        # grouped_transfer): per bucket-padded transfer pair one
        # source-row gather, one target-row gather, and the merged
        # target-row scatter, stacked G-wide across the dispatch-plan
        # group (pad slots gather real bytes and DROP at the scatter —
        # the out-of-range pad contract). Coarse like quorum_step /
        # ingest_apply: the row exists to show rebalancing's device
        # cost next to the gossip it interleaves with, not to chase an
        # HBM bound. ``rows`` is the pair bucket.
        F = int(rows or 0)
        moved = G * F * 3 * int(row_bytes)
        lo = G * F * 2 * int(row_bytes)
        hi = 4 * moved + pad
        return TrafficEstimate(moved, lo, hi, G * F)

    if family == "shard_exchange":
        # the SPARSE partitioned frontier round (shard_gossip.
        # partitioned_frontier_round_fn): ``rows`` is the bucket-padded
        # cut-row payload the collective moves (crossing the wire twice,
        # send + receive; pad slots are real collective slots),
        # ``exchange_rows`` the frontier-reachable rows the overlapped
        # interior/boundary joins touch — (K+1) gathered rows + 1
        # written per touched row, stacked G-wide. The runtime's
        # dispatch site passes exact figures (bytes_moved/joins
        # overrides); this analytic branch seeds the family for
        # roofline_workload and prices ad-hoc calls.
        X = int(rows or 0)  # payload rows (bucket-padded)
        F = int(exchange_rows)  # joined (touched) rows
        moved = G * (2 * X + (K + 2) * F) * int(row_bytes)
        lo = G * 2 * X * int(row_bytes)
        hi = (
            G * (2 * X + (2 * K + 4) * F) * int(row_bytes)
            + 2 * G * S + N + pad
        )
        return TrafficEstimate(moved, lo, hi, G * F * K)

    # boundary_exchange: the partitioned round's wire+local traffic —
    # local read+write of the population plus the cut rows crossing the
    # collective twice (send + receive)
    moved = 2 * S + 2 * int(exchange_rows) * int(row_bytes) + N
    lo = 2 * S
    hi = (2 + K) * S + N + 2 * int(exchange_rows) * int(row_bytes) + pad
    return TrafficEstimate(moved, lo, hi, R * K)


# ---------------------------------------------------------------------------
# the kernel cost ledger
# ---------------------------------------------------------------------------


class KernelLedger:
    """Per-kernel-signature cost attribution: dispatches, rounds,
    analytic bytes, joins, seconds -> achieved GB/s and roofline
    fraction. ``record`` is the hot path (a dict update under one
    lock); every ``SAMPLE_EVERY``-th dispatch of a signature refreshes
    that signature's gauges under the ``gossip.ledger_sample`` span."""

    #: gauge refresh cadence per signature (the first dispatch always
    #: samples, so short runs still export)
    SAMPLE_EVERY = 16

    def __init__(self):
        self._lock = threading.Lock()
        self._kernels: dict = {}
        self._totals = {
            "dispatches": 0, "rounds": 0, "bytes": 0, "joins": 0,
            "seconds": 0.0, "compile_seconds": 0.0,
        }

    @staticmethod
    def _label(family, codec_name, n_replicas, fanout, rows, g_active):
        lab = f"{family}:{codec_name}:R{n_replicas}k{fanout}"
        if rows:
            lab += f":b{rows}"
        if g_active > 1:
            lab += f":G{g_active}"
        return lab

    def record(
        self,
        family: str,
        codec_name: str,
        *,
        n_replicas: int,
        fanout: int,
        seconds: float,
        row_bytes: int = 0,
        rows: "int | None" = None,
        g_active: int = 1,
        window: int = 1,
        leafwise: bool = True,
        bytes_moved: "int | None" = None,
        joins: "int | None" = None,
        rounds: "int | None" = None,
        n_vars: int = 1,
    ) -> None:
        """Attribute one dispatch. ``bytes_moved``/``joins`` override
        the analytic model where the caller already holds the exact
        figure (the whole-store step's ``round_traffic_bytes``)."""
        if not _registry.enabled():
            return
        if bytes_moved is None or joins is None:
            est = kernel_traffic(
                family, row_bytes=row_bytes, n_replicas=n_replicas,
                fanout=fanout, rows=rows, g_active=g_active, window=window,
                leafwise=leafwise, n_vars=n_vars,
            )
            if bytes_moved is None:
                bytes_moved = est.bytes_moved
            if joins is None:
                joins = est.joins
        rounds = int(window if rounds is None else rounds)
        label = self._label(
            family, codec_name, int(n_replicas), int(fanout),
            int(rows or 0), int(g_active),
        )
        with self._lock:
            ent = self._kernels.get(label)
            if ent is None:
                ent = self._kernels[label] = {
                    "kernel": label,
                    "family": family,
                    "codec": codec_name,
                    "n_replicas": int(n_replicas),
                    "fanout": int(fanout),
                    "bucket": int(rows or 0),
                    "g_active": int(g_active),
                    "dispatches": 0,
                    "rounds": 0,
                    "bytes": 0,
                    "joins": 0,
                    "seconds": 0.0,
                    "compile_dispatches": 0,
                    "compile_seconds": 0.0,
                }
            if ent["dispatches"] == 0 and ent["compile_dispatches"] == 0:
                # a signature's FIRST dispatch carries the one-off costs
                # (JAX: trace + compile; here: the kernel library's load
                # and the allocator's first blocks): bank it separately
                # so achieved GB/s reflects warm dispatches only
                ent["compile_dispatches"] += 1
                ent["compile_seconds"] += float(seconds)
                self._totals["compile_seconds"] = (
                    self._totals.get("compile_seconds", 0.0) + float(seconds)
                )
                return
            ent["dispatches"] += 1
            ent["rounds"] += rounds
            ent["bytes"] += int(bytes_moved)
            ent["joins"] += int(joins)
            ent["seconds"] += float(seconds)
            tot = self._totals
            tot["dispatches"] += 1
            tot["rounds"] += rounds
            tot["bytes"] += int(bytes_moved)
            tot["joins"] += int(joins)
            tot["seconds"] += float(seconds)
            do_sample = ent["dispatches"] % self.SAMPLE_EVERY == 1
            if do_sample:
                sample = dict(ent)
        if do_sample:
            self._sample(sample)

    @staticmethod
    def _rates(ent) -> "tuple[float | None, float | None]":
        secs = ent["seconds"]
        if secs <= 0:
            return None, None
        gbps = ent["bytes"] / secs / 1e9
        peak = device_capability().get("peak_GBps")
        frac = (gbps / peak) if peak else None
        return round(gbps, 3), (round(frac, 4) if frac is not None else None)

    def _sample(self, ent) -> None:
        """One sampled gauge refresh for a signature (the throttled
        export path — the per-record cost must never include a registry
        walk per dispatch). Uses the cached peak: resolving the record
        belongs to read surfaces (health, ``chip_smoke.py``), never a
        dispatch path."""
        from .capability import cached_peak_gbps

        with span("gossip.ledger_sample", kernel=ent["kernel"]):
            secs = ent["seconds"]
            if secs <= 0:
                return
            gbps = round(ent["bytes"] / secs / 1e9, 3)
            _registry.gauge(
                "roofline_achieved_GBps",
                help="achieved GB/s per kernel signature (analytic "
                     "bytes over ledger-attributed wall time)",
                kernel=ent["kernel"],
            ).set(gbps)
            peak = cached_peak_gbps()
            if peak:
                _registry.gauge(
                    "roofline_frac",
                    help="achieved GB/s over the capability registry's "
                         "roofline denominator, per kernel signature",
                    kernel=ent["kernel"],
                ).set(round(gbps / peak, 4))

    def totals(self) -> dict:
        """Whole-ledger accumulators (bench arms diff this around a
        measured region to attribute bytes to the region)."""
        with self._lock:
            return dict(self._totals)

    def snapshot(self) -> list:
        """Per-signature table (most wall time first), each row carrying
        achieved GB/s + roofline fraction against the current
        capability."""
        with self._lock:
            rows = [dict(e) for e in self._kernels.values()]
        for ent in rows:
            gbps, frac = self._rates(ent)
            ent["achieved_GBps"] = gbps
            ent["roofline_frac"] = frac
        rows.sort(key=lambda e: -e["seconds"])
        return rows

    def summary(self, top: int = 8) -> dict:
        """The health-view condensation (``ConvergenceMonitor.health()
        ["roofline"]``)."""
        rows = self.snapshot()
        tot = self.totals()
        gbps = (
            round(tot["bytes"] / tot["seconds"] / 1e9, 3)
            if tot["seconds"] > 0 else None
        )
        cap = device_capability() if rows else None
        peak = cap.get("peak_GBps") if cap else None
        return {
            "kernels": [
                {
                    k: ent[k]
                    for k in ("kernel", "family", "dispatches", "rounds",
                              "bytes", "seconds", "achieved_GBps",
                              "roofline_frac")
                }
                for ent in rows[:top]
            ],
            "totals": tot,
            "achieved_GBps": gbps,
            "peak_GBps": peak,
            "roofline_frac": (
                round(gbps / peak, 4) if gbps and peak else None
            ),
        }


_ledger: "KernelLedger | None" = None
_ledger_gen: "int | None" = None
_ledger_lock = threading.Lock()


def get_ledger() -> KernelLedger:
    """The process-global ledger. Its lifetime follows the registry
    generation: ``telemetry.reset()`` / ``scratch_registry()`` detach
    it (a fresh ledger appears), so measurement harnesses never bleed
    synthetic dispatches into live attribution. Creation is locked: a
    stepping thread and a health-scrape thread racing the first access
    after a generation bump must agree on ONE instance, or one side's
    records would silently vanish."""
    global _ledger, _ledger_gen
    gen = _registry.generation()
    led = _ledger
    if led is not None and _ledger_gen == gen:
        return led
    with _ledger_lock:
        if _ledger is None or _ledger_gen != gen:
            _ledger = KernelLedger()
            _ledger_gen = gen
        return _ledger


# ---------------------------------------------------------------------------
# profiler capture hook
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def profile_capture(log_dir: str = "./profile_capture"):
    """Wrap a region in a ``torch.profiler`` trace, the whole-scenario
    capture hook (``with profile_capture("/tmp/t"): scenario()``): a Chrome
    trace lands in the directory (open it in Perfetto). Yields the trace
    directory."""
    from ..utils.metrics import profile

    with profile(str(log_dir)):
        yield str(log_dir)


def capture_scenario(fn, log_dir: str = "./profile_capture", **kwargs):
    """Run ``fn(**kwargs)`` under :func:`profile_capture`; returns
    ``(result, trace_dir)``, the one-call form for scenario callables
    (``capture_scenario(frontier_sparse)``)."""
    t0 = time.perf_counter()
    with profile_capture(log_dir) as d:
        out = fn(**kwargs)
    _registry.histogram(
        "profile_capture_seconds",
        help="wall time of whole-scenario profiler captures",
    ).observe(time.perf_counter() - t0)
    return out, d
