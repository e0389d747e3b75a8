"""ServeFrontend: the overload-hardened ingestion front-end (port of
``lasp_tpu.serve.engine``).

The layer between "reproduction" and "heavy traffic from millions of
users" (ROADMAP open item 3): thousands of concurrent client requests
are admitted into bounded per-class queues (``serve.admission``),
COALESCED into the ``update_batch``/plan-group megabatches the mesh
layer already makes var-dense, and resolved through ONE vectorized
threshold pass over the subscription tensor (``serve.subscriptions``).
"Mapping the Join Calculus to Heterogeneous Hardware" (PAPERS.md)
grounds the execution model: client messages queue, and a serving CYCLE
drains them as batched joins.

One serving cycle:

1. **dispatch the gossip window** — ``rt.begin_fused_steps(block)``
   issues the device-resident fused rounds WITHOUT syncing (or, with a
   chaos nemesis attached, runs the round's masked chaos step);
2. **drain ingest** — dequeue up to the coalescing window of writes
   (wider when the degradation ladder says so), all reads and watch
   registrations, cancelling deadline-expired work instead of executing
   it; this host-side work (dequeue, op grouping, interning) OVERLAPS
   the in-flight device window — the async-runtime-loop claim,
   measured by ``serve_ingest_overlap_seconds``;
3. **sync the window**, then apply the write megabatches through ONE
   grouped ingest cycle (``ReplicatedRuntime.ingest_cycle`` /
   ``mesh.ingest``): the whole drained cycle's ops resolve into dense
   op tables and every same-signature variable lands in one vmapped
   dispatch per dispatch-plan group — O(plan groups), not O(vars),
   device dispatches per cycle — in submission order per variable,
   which is BIT-IDENTICAL to sequential per-request application (ops
   on one variable apply in order; ops on different variables commute
   because every op touches only its own variable's planes — the same
   two-phase argument as the quorum layer's batched rounds, asserted
   by tools/serve_smoke.py, tools/ingest_smoke.py and tests/serve/);
4. **resolve reads** (threshold-less reads answer from the post-write
   population; threshold reads park as subscriptions) and **register
   watches**;
5. **fire watches** — the vectorized verdict pass; fire-exactly-once.

Acked writes feed the ``acked_terms`` witness set, so any scenario can
assert the PR-9 no-acked-write-lost invariant
(``chaos.invariants.check_no_write_lost``) after a run.

On a runtime sharded across processes every process runs the same cycles
(SPMD): writes land through the runtime's owner window, reads and watch
verdicts read the whole population gathered from its owners, the caller
passes a ``clock`` that every process reads alike (a wall clock differs
between processes, and agreeing each reading would cost a collective a
request), and the admission ladder's measured cycle seconds are agreed
once a cycle (the largest reading), so every process's host queues stay
equal. ``ServeLoop`` refuses there: its cycles run at each thread's own
pace.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch

from ..lattice.base import tree_map
from ..mesh import comm
from ..telemetry import counter, events as tel_events, gauge, histogram, span
from ..telemetry.convergence import get_monitor
from ..utils.metrics import Timer
from . import requests as rq
from .admission import AdmissionController
from .subscriptions import SubscriptionTable

#: bound on per-kind latency samples retained for the percentile report
_LATENCY_RING = 1 << 16


def _agreed(x: float, rt) -> float:
    """The largest of every process's ``x`` (one ``all_reduce`` on the
    runtime's device): a value every process of a runtime sharded across
    them judges alike."""
    x = torch.tensor([x], dtype=torch.float64, device=rt.device)
    return float(comm.all_reduce(x, rt._dist["mesh"], "max")[0])


def _percentile(samples: list, q: float) -> "float | None":
    if not samples:
        return None
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


class ServeFrontend:
    """One serving front-end over a replicated population (optionally
    chaos-wrapped); see the module doc. Thread-safe submission; cycles
    run from one driver thread (call :meth:`cycle` yourself for
    deterministic harnesses, or :class:`ServeLoop` for a live loop)."""

    def __init__(self, runtime, *, admission: "AdmissionController | None" = None,
                 gossip_block: int = 4, coalesce_max: int = 2048,
                 clock=None, chaos_mode: str = "dense",
                 write_backup: bool = True,
                 aae=None, scrub_every: int = 16):
        from ..chaos import ChaosRuntime

        if isinstance(runtime, ChaosRuntime):
            self.chaos = runtime
            self.rt = runtime.rt
        else:
            self.chaos = None
            self.rt = runtime
        #: background anti-entropy (``lasp_tpu.aae.AAEScrubber``): every
        #: ``scrub_every``-th cycle runs one scrub AFTER the cycle's
        #: client work — but only while the degradation ladder sits
        #: below the shed-reads rung (level < 1): under pressure,
        #: client traffic outranks hygiene and the skipped scrub is
        #: counted, not silently dropped. A chaos-wrapped runtime whose
        #: scrubber auto-attached to the engine hooks scrubs in-round
        #: instead — pass ``auto_attach=False`` there to let the
        #: front-end own the cadence.
        self.aae = aae
        self.scrub_every = max(1, int(scrub_every))
        self.scrubs_run = 0
        self.scrubs_skipped = 0
        #: when set, the admission controller's drain-rate EWMA is fed
        #: THIS many seconds per cycle instead of measured wall time —
        #: simulated-clock harnesses set it to their tick length so
        #: retry_after hints become backlog/throughput in simulated
        #: time and two same-seed runs produce identical shed/retry
        #: traces (wall jitter would otherwise skew the retry
        #: schedule). Telemetry histograms still record real wall time.
        self.admission_cycle_seconds: "float | None" = None
        self.store = self.rt.store
        self.admission = admission or AdmissionController()
        self.subs = SubscriptionTable()
        self.gossip_block = int(gossip_block)
        self.coalesce_max = int(coalesce_max)
        self.chaos_mode = chaos_mode
        #: replicate each written row into its next LIVE neighbor row
        #: (one masked partial join per var per cycle) BEFORE acking —
        #: an ack then means "applied at 2 rows", so a single crash +
        #: bottom restore cannot lose an acknowledged write (the PR-9
        #: no-acked-write-lost contract at W=2; a fault burying both
        #: rows at once needs the quorum layer's hint log)
        self.write_backup = bool(write_backup)
        if clock is None:
            if self.rt._dist is not None:
                raise ValueError(
                    "ServeFrontend on a runtime sharded across processes needs "
                    "a clock that every process reads alike (clock=...): each "
                    "process's wall clock reads its own instants, and the "
                    "deadlines and sheds judged by it would part their queues"
                )
            import time

            clock = time.monotonic
        self.clock = clock
        #: {var_id: set(term)} — terms whose write was ACKED to a client
        #: (the no-acked-write-lost witness set, chaos.invariants)
        self.acked_terms: dict = {}
        self.cycles = 0
        self.offered = {k: 0 for k in rq.KINDS}
        self.admitted = {k: 0 for k in rq.KINDS}
        self.completed = {k: 0 for k in rq.KINDS}
        self.errors = {k: 0 for k in rq.KINDS}
        self.expired = {k: 0 for k in rq.KINDS}
        #: shed accounting by (kind, reason)
        self.sheds: dict = {}
        self.watch_fires = 0
        #: acks that found no reachable live backup row (W=1 — see
        #: ``write_backup``); nonzero only under extreme partitions
        self.unreplicated_acks = 0
        self._latency = {k: [] for k in rq.KINDS}
        self._lock = threading.Lock()
        self._overlap_seconds = 0.0
        self._gossip_rounds = 0
        #: grouped-ingest accounting (mesh.ingest via ingest_cycle):
        #: device dispatches and ops landed through the grouped arm
        self._ingest_dispatches = 0
        self._ingest_grouped_ops = 0

    # -- submission (any thread) ---------------------------------------------
    def submit_write(self, var_id: str, op: tuple, actor, *,
                     replica: int = 0, deadline: Optional[float] = None,
                     priority: str = rq.PRIO_NORMAL,
                     callback=None) -> rq.Ticket:
        t = rq.Ticket(rq.WRITE, var_id, priority=priority,
                      deadline=deadline, submitted_at=self.clock(),
                      callback=callback,
                      payload=(int(replica), tuple(op), actor))
        return self._admit(t)

    def submit_read(self, var_id: str, threshold=None, *,
                    replica: int = 0, deadline: Optional[float] = None,
                    priority: str = rq.PRIO_NORMAL,
                    callback=None) -> rq.Ticket:
        t = rq.Ticket(rq.READ, var_id, priority=priority,
                      deadline=deadline, submitted_at=self.clock(),
                      callback=callback, payload=(int(replica), threshold))
        return self._admit(t)

    def submit_watch(self, var_id: str, threshold=None, *,
                     replica: int = 0, deadline: Optional[float] = None,
                     priority: str = rq.PRIO_NORMAL,
                     callback=None) -> rq.Ticket:
        t = rq.Ticket(rq.WATCH, var_id, priority=priority,
                      deadline=deadline, submitted_at=self.clock(),
                      callback=callback, payload=(int(replica), threshold))
        return self._admit(t)

    def _admit(self, ticket: rq.Ticket) -> rq.Ticket:
        kind = ticket.kind
        with self._lock:
            self.offered[kind] += 1
        counter(
            "serve_requests_total",
            help="serving requests offered, by class",
            kind=kind,
        ).inc()
        refusal = self.admission.admit(ticket)
        if refusal is not None:
            reason, retry_ms = refusal
            ticket.shed(reason, retry_ms, self.clock())
            with self._lock:
                key = (kind, reason)
                self.sheds[key] = self.sheds.get(key, 0) + 1
            counter(
                "serve_shed_total",
                help="serving requests refused with a typed "
                     "{busy, retry_after_ms}, by class and reason",
                kind=kind, reason=reason,
            ).inc()
            histogram(
                "serve_retry_after_ms",
                help="retry-after hints attached to shed responses",
                buckets=(5, 20, 50, 100, 250, 500, 1000, 2000, 5000),
            ).observe(retry_ms)
            return ticket
        with self._lock:
            self.admitted[kind] += 1
        return ticket

    # -- the serving cycle ----------------------------------------------------
    def cycle(self) -> dict:
        """One serving cycle (see the module doc). Returns the cycle's
        stats dict."""
        now = self.clock()
        handle = None
        drained = 0
        with span("serve.cycle"):
            with Timer() as ct:
                gossip = False
                if self.chaos is not None:
                    # masked chaos round (crash/restore host surgery
                    # cannot overlap a device window)
                    self.chaos.step(mode=self.chaos_mode)
                    gossip = True
                elif self.gossip_block > 0 and self.rt.n_replicas > 1:
                    handle = self.rt.begin_fused_steps(self.gossip_block)
                    gossip = True
                try:
                    with Timer() as it:
                        writes, w_tickets = self._drain_writes(now)
                        reads = self._drain(rq.READ, now)
                        watches = self._drain(rq.WATCH, now)
                finally:
                    if handle is not None:
                        handle.finish()
                if gossip:
                    self._gossip_rounds += (
                        self.gossip_block if handle is not None else 1
                    )
                if handle is not None:
                    # host ingest ran while the device window was in
                    # flight — the measured overlap claim
                    self._overlap_seconds += it.elapsed
                    histogram(
                        "serve_ingest_overlap_seconds",
                        help="host-side ingest time overlapped with an "
                             "in-flight device gossip window",
                    ).observe(it.elapsed)
                applied = self._apply_writes(writes, w_tickets)
                resolved = self._resolve_reads(reads)
                parked = self._register_watches(watches)
                fired = self._fire_watches()
                expired = self._expire_subs()
                drained = (
                    applied + resolved + len(parked) + fired + expired
                )
                if (
                    self.aae is not None
                    and self.cycles % self.scrub_every
                    == self.scrub_every - 1
                ):
                    # scrubbing coexists with serving UNDER the
                    # admission ladder: any climb above normal defers
                    # the scrub to a calmer cycle (counted)
                    if self.admission.level < 1:
                        self.aae.scrub()
                        self.scrubs_run += 1
                        outcome = "run"
                    else:
                        self.scrubs_skipped += 1
                        outcome = "deferred"
                    counter(
                        "aae_background_scrubs_total",
                        help="serving-cycle background AAE scrubs, by "
                             "outcome (run, or deferred because the "
                             "degradation ladder was above normal)",
                        outcome=outcome,
                    ).inc()
        elapsed = self.admission_cycle_seconds
        if elapsed is None:
            elapsed = ct.elapsed
            if self.rt._dist is not None:
                elapsed = _agreed(elapsed, self.rt)
        level = self.admission.observe_cycle(elapsed, drained)
        self.cycles += 1
        histogram(
            "serve_cycle_seconds",
            help="serving-cycle wall time (gossip window + ingest "
                 "drain + megabatch apply + watch fan-out)",
        ).observe(ct.elapsed)
        for kind, q in self.admission.queues.items():
            gauge(
                "serve_queue_depth",
                help="admitted requests waiting in the class queue",
                kind=kind,
            ).set(q.depth)
        stats = {
            "cycle": self.cycles,
            "seconds": ct.elapsed,
            "level": level,
            "writes_applied": applied,
            "reads_resolved": resolved,
            "watches_parked": len(parked),
            "watch_fires": fired,
            "expired": expired,
            "depths": self.admission.depths(),
        }
        if applied or resolved or fired or expired:
            # one coarse causal record per cycle (the hot-path rule)
            tel_events.emit(
                "serve", cycle=self.cycles, level=level,
                writes=applied, reads=resolved, fires=fired,
                expired=expired,
            )
        return stats

    # -- drains ---------------------------------------------------------------
    def _coalesce_window(self) -> int:
        return self.coalesce_max * self.admission.coalesce_multiplier()

    def _drain_writes(self, now: float):
        """Dequeue up to the (ladder-widened) coalescing window of
        writes and group them per variable, preserving per-variable
        submission order — the bit-identity precondition."""
        groups: dict = {}
        tickets: dict = {}
        for t in self.admission.queues[rq.WRITE].drain(
            self._coalesce_window()
        ):
            if self._expire_if_due(t, now):
                continue
            replica, op, actor = t.payload
            groups.setdefault(t.var_id, []).append((replica, op, actor))
            tickets.setdefault(t.var_id, []).append(t)
        return groups, tickets

    def _drain(self, kind: str, now: float) -> list:
        out = []
        for t in self.admission.queues[kind].drain(None):
            if self._expire_if_due(t, now):
                continue
            out.append(t)
        return out

    def _expire_if_due(self, t: rq.Ticket, now: float) -> bool:
        if t.deadline is not None and now > t.deadline:
            t.expire(now)
            self._account(t)
            return True
        return False

    # -- write application ----------------------------------------------------
    def _route(self, replica: int, var_id: str, op: tuple) -> int:
        """Route a write targeting a crashed replica to the next live
        row (deterministic wrap) — the preflist's routing decision, made
        here instead of refusing the client. ONLY ops that mint no
        per-actor lane events reroute (G-Set adds, removes): a rerouted
        LANE-MINTING op (counter increment, OR-Set/OR-SWOT add) would
        mint the client's actor lane at a second row, and the max-merge
        silently discards one side — an acked-but-lost write. Those
        fail typed instead; the client re-issues at a live replica
        (the actor-discipline rule, mesh/runtime.py update_at)."""
        if self.chaos is None or not self.chaos.crashed[replica]:
            return replica
        from ..chaos.engine import ReplicaDownError

        var = self.store.variable(var_id)
        if self.rt._op_mints_lane(var, op):
            raise ReplicaDownError(
                f"replica {replica} is down and {op[0]!r} on "
                f"{var.type_name} mints actor lanes — rerouting would "
                "collide the lane at two rows (silent loss); re-issue "
                "at a live replica"
            )
        live = np.flatnonzero(~self.chaos.crashed)
        if live.size == 0:
            raise ReplicaDownError("every replica is down")
        pos = int(np.searchsorted(live, replica))
        return int(live[pos % live.size])

    def _apply_writes(self, groups: dict, tickets: dict) -> int:
        applied = 0
        now = self.clock()
        with span("serve.flush"):
            batches: dict = {}
            kept_by_var: dict = {}
            for var_id, ops in groups.items():
                # route per op: an unroutable op (crashed target, lane-
                # minting — see _route) fails ITS ticket only, never
                # its whole coalesced group
                batch, kept = [], []
                for (r, op, actor), t in zip(ops, tickets[var_id]):
                    try:
                        batch.append(
                            (self._route(r, var_id, op), op, actor)
                        )
                        kept.append(t)
                    except Exception as exc:
                        t.fail(f"{type(exc).__name__}: {exc}", now)
                        self._account(t)
                if batch:
                    batches[var_id] = batch
                    kept_by_var[var_id] = kept
            if not batches:
                return 0
            # the WHOLE drained cycle lands in one grouped ingest:
            # same-signature variables share one vmapped dispatch per
            # plan group (O(groups), not O(vars), device dispatches per
            # cycle — mesh.ingest), with per-variable error isolation:
            # a failing variable's tickets get a typed error (its
            # kernels' prefix semantics may have applied a leading
            # slice; the outcome is the caller's to re-issue), never a
            # hang, and never another variable's outcome
            report = self.rt.ingest_cycle(batches, isolate_errors=True)
            self._ingest_dispatches += report["dispatches"]
            self._ingest_grouped_ops += report["ops"]
            for var_id, batch in batches.items():
                kept = kept_by_var[var_id]
                exc = report["errors"].get(var_id)
                if exc is not None:
                    for t in kept:
                        t.fail(f"{type(exc).__name__}: {exc}", now)
                        self._account(t)
                    continue
                histogram(
                    "serve_coalesced_ops",
                    help="client ops coalesced into one update_batch "
                         "dispatch",
                    buckets=(1, 8, 64, 256, 1024, 4096, 16384),
                ).observe(len(batch))
                if self.write_backup:
                    self._push_backups(
                        var_id, sorted({r for r, _op, _a in batch})
                    )
                for (r, op, actor), t in zip(batch, kept):
                    # only set-family adds enter the witness set: the
                    # no-write-lost check compares TERMS against the
                    # coverage value (numeric types have no term-level
                    # membership to witness)
                    if op and op[0] == "add":
                        self.acked_terms.setdefault(
                            var_id, set()
                        ).add(op[1])
                    elif op and op[0] == "add_all":
                        self.acked_terms.setdefault(
                            var_id, set()
                        ).update(op[1])
                    t.complete({"replica": r, "var": var_id}, now)
                    self._account(t)
                    applied += 1
        return applied

    def _backup_of(self, replica: int) -> "int | None":
        """The next live row after ``replica`` (wrapping) that the
        writing row can actually REACH under the current chaos mask —
        the backup an acked write replicates into. Confinement matters:
        a push through a partition would be a host-side side channel
        healing the very cut the nemesis installed (the degraded-read
        discipline, docs/RESILIENCE.md). None when no reachable live
        backup exists (the ack is then W=1; counted in the report)."""
        n = self.rt.n_replicas
        if n <= 1:
            return None
        if self.chaos is None:
            return (replica + 1) % n
        # writes happen BETWEEN chaos rounds: judge reachability under
        # the last EXECUTED round's mask (the round counter has already
        # advanced past it), consistent with what `crashed` reports —
        # the upcoming round's mask would pre-isolate a replica whose
        # crash hasn't happened yet and silently skip its backup
        comp = self.chaos._reachable_live(
            int(replica), rnd=max(self.chaos.round - 1, 0)
        )
        for step in range(1, n):
            cand = (replica + step) % n
            if comp[cand]:
                return cand
        return None

    def _push_backups(self, var_id: str, src_rows: list) -> None:
        """Join each freshly-written row into its backup row (one
        ``join_rows`` partial join per variable per cycle) — the
        replication half of the ack; see ``write_backup``."""
        pairs: dict = {}
        for r in src_rows:
            dst = self._backup_of(r)
            if dst is not None and dst != r:
                pairs.setdefault(dst, r)
            else:
                self.unreplicated_acks += 1
        if not pairs:
            return
        dsts = np.fromiter(pairs.keys(), dtype=np.int64)
        srcs = self.rt._rows_of(var_id, list(pairs.values()))
        contribs = [tree_map(lambda x, i=i: x[i], srcs) for i in range(dsts.size)]
        changed = self.rt.join_rows(var_id, dsts, contribs)
        if changed:
            counter(
                "serve_replicated_rows_total",
                help="backup rows inflated by the pre-ack write "
                     "replication join",
            ).inc(changed)

    # -- reads / watches ------------------------------------------------------
    def _resolve_reads(self, reads: list) -> int:
        resolved = 0
        now = self.clock()
        value_cache: dict = {}
        for t in reads:
            # per-request isolation: an unknown variable or malformed
            # threshold fails ITS ticket with a typed error — it must
            # never unwind the cycle and strand every other drained
            # ticket in 'queued' forever (the no-silent-drop contract)
            try:
                replica, threshold = t.payload
                var = self.store.variable(t.var_id)
                thr = self.store._resolve_threshold(var, threshold)
                if threshold is None:
                    # "whatever is there": answer from the post-write
                    # population immediately
                    key = (t.var_id, replica)
                    if key not in value_cache:
                        value_cache[key] = self.rt.replica_value(
                            t.var_id,
                            min(replica, self.rt.n_replicas - 1),
                        )
                    t.complete(value_cache[key], now)
                    self._account(t)
                    resolved += 1
                else:
                    # threshold read: parks as a subscription; the fire
                    # pass (this same cycle, post-write) answers met ones
                    self.subs.register(
                        t.var_id, var.codec, var.spec, thr,
                        replica=replica, deadline=t.deadline, payload=t,
                    )
            except Exception as exc:
                t.fail(f"{type(exc).__name__}: {exc}", now)
                self._account(t)
        return resolved

    def _register_watches(self, watches: list) -> list:
        parked = []
        now = self.clock()
        for t in watches:
            try:
                replica, threshold = t.payload
                var = self.store.variable(t.var_id)
                thr = self.store._resolve_threshold(var, threshold)
                self.subs.register(
                    t.var_id, var.codec, var.spec, thr,
                    replica=replica, deadline=t.deadline, payload=t,
                )
                parked.append(t)
            except Exception as exc:  # same isolation rule as reads
                t.fail(f"{type(exc).__name__}: {exc}", now)
                self._account(t)
        return parked

    def _pop_dense(self, var_id: str):
        return self.rt._to_dense_row(var_id, self.rt._whole_population(var_id))

    def _meta(self, var_id: str):
        var = self.store.variable(var_id)
        return var.codec, var.spec

    def _fire_watches(self) -> int:
        now = self.clock()
        with span("serve.watch_eval"):
            fired = self.subs.evaluate(self._pop_dense, self._meta)
        n = 0
        value_cache: dict = {}
        for _sub_id, t in fired:
            if not isinstance(t, rq.Ticket):
                continue
            replica, _thr = t.payload
            if t.kind == rq.READ:
                key = (t.var_id, replica)
                if key not in value_cache:
                    value_cache[key] = self.rt.replica_value(
                        t.var_id, min(replica, self.rt.n_replicas - 1)
                    )
                result: Any = value_cache[key]
            else:
                result = {"var": t.var_id, "replica": replica,
                          "threshold_met": True}
            if t.complete(result, now):
                self._account(t)
                n += 1
        self.watch_fires += n
        return n

    def _expire_subs(self) -> int:
        now = self.clock()
        n = 0
        for _sub_id, t in self.subs.expire(now):
            if isinstance(t, rq.Ticket) and t.expire(now):
                self._account(t)
                n += 1
        return n

    def on_membership(self, claim_of=None, expire: bool = False) -> dict:
        """Membership-commit hook (called by
        ``membership.MembershipCoordinator`` at finalize, or directly
        after a ``resize``): re-home parked watches whose replica row
        departed to their claim successor (``claim_of``, default ring
        fold), or — ``expire=True``, the crash/down semantics — retire
        them typed: their tickets expire through the normal accounting
        (the client sees a deadline-style cancellation, never a stale
        fire). Returns ``{"rehomed", "expired"}`` counts."""
        res = self.subs.rehome(
            self.rt.n_replicas, claim_of, expire=expire
        )
        now = self.clock()
        # every claimed watch counts as expired (the claim is the
        # retirement); ticket expiry accounting is best-effort on top —
        # a non-Ticket payload or an already-terminal ticket still left
        # the table, and the metric must agree with the return value
        n_expired = len(res["expired"])
        for _sub_id, t in res["expired"]:
            if isinstance(t, rq.Ticket) and t.expire(now):
                self._account(t)
        if res["rehomed"]:
            counter(
                "membership_rehomed_watches_total",
                help="parked threshold watches moved off a departed "
                     "replica by a membership commit, by outcome "
                     "(rehomed = moved to the claim successor, "
                     "expired = retired typed under crash semantics)",
                outcome="rehomed",
            ).inc(res["rehomed"])
        if n_expired:
            counter(
                "membership_rehomed_watches_total",
                help="parked threshold watches moved off a departed "
                     "replica by a membership commit, by outcome "
                     "(rehomed = moved to the claim successor, "
                     "expired = retired typed under crash semantics)",
                outcome="expired",
            ).inc(n_expired)
        return {"rehomed": res["rehomed"], "expired": n_expired}

    def _account(self, t: rq.Ticket) -> None:
        with self._lock:
            if t.status == "done":
                self.completed[t.kind] += 1
                lat = t.latency()
                ring = self._latency[t.kind]
                if lat is not None:
                    if len(ring) >= _LATENCY_RING:
                        del ring[: _LATENCY_RING // 2]
                    ring.append(lat)
            elif t.status == "error":
                self.errors[t.kind] += 1
            elif t.status == "expired":
                self.expired[t.kind] += 1
        if t.status == "done":
            counter(
                "serve_completed_total",
                help="serving requests resolved successfully, by class",
                kind=t.kind,
            ).inc()
            lat = t.latency()
            if lat is not None and lat >= 0:
                histogram(
                    "serve_latency_seconds",
                    help="submit-to-resolution latency in clock units, "
                         "by class",
                    kind=t.kind,
                ).observe(lat)
        elif t.status == "expired":
            counter(
                "serve_deadline_expired_total",
                help="requests cancelled unexecuted because the "
                     "client deadline passed, by class",
                kind=t.kind,
            ).inc()

    # -- drivers --------------------------------------------------------------
    def drain(self, max_cycles: int = 256) -> int:
        """Run cycles until every queue is empty (parked watches may
        remain); returns cycles run. Never hangs: raises past
        ``max_cycles`` (the quorum drain discipline)."""
        for i in range(max_cycles):
            self.cycle()
            if not any(q.depth for q in self.admission.queues.values()):
                return i + 1
        raise RuntimeError(
            f"serve queues not drained after {max_cycles} cycles "
            f"(depths: {self.admission.depths()})"
        )

    def report(self) -> dict:
        """The serving accounting: offered vs admitted vs completed,
        shed/expired breakdowns, queue high-water marks, latency
        percentiles — also folded into ``health()['serve']``."""
        with self._lock:
            latency = {
                kind: {
                    "p50": _percentile(ring, 50),
                    "p99": _percentile(ring, 99),
                    "n": len(ring),
                }
                for kind, ring in self._latency.items()
            }
            rep = {
                "cycles": self.cycles,
                "offered": dict(self.offered),
                "admitted": dict(self.admitted),
                "completed": dict(self.completed),
                "errors": dict(self.errors),
                "expired": dict(self.expired),
                "shed": {
                    f"{kind}:{reason}": n
                    for (kind, reason), n in sorted(self.sheds.items())
                },
                "watch_fires": self.watch_fires,
                "watch_parked": len(self.subs),
                "unreplicated_acks": self.unreplicated_acks,
                "aae_scrubs": self.scrubs_run,
                "aae_scrubs_deferred": self.scrubs_skipped,
                "latency": latency,
                "overlap_seconds": round(self._overlap_seconds, 6),
                "gossip_rounds": self._gossip_rounds,
                "ingest_dispatches": self._ingest_dispatches,
                "ingest_grouped_ops": self._ingest_grouped_ops,
                "admission": self.admission.snapshot(),
            }
            # flight plane: the last fused gossip window's per-round
            # residual curve (drained by FusedBlockHandle.finish) — the
            # in-cycle forensic the collapsed gossip_rounds total hides
            from ..telemetry import device as tel_flight

            w = tel_flight.last_window("fused_block")
            rep["flight"] = None if w is None else {
                "rounds": w.rounds,
                "overwritten": w.overwritten,
                "quiescent": w.quiescent,
                "residual_curve": w.residual_curve(),
                "seconds": round(w.seconds, 6),
            }
        get_monitor().observe_serve(**{
            "cycles": rep["cycles"],
            "offered": sum(rep["offered"].values()),
            "completed": sum(rep["completed"].values()),
            "shed": sum(self.sheds.values()),
            "expired": sum(rep["expired"].values()),
            "watch_parked": rep["watch_parked"],
            "level": self.admission.level,
        })
        return rep


class ServeLoop:
    """Background driver: runs serving cycles on a daemon thread while
    clients submit concurrently — the live twin of calling
    :meth:`ServeFrontend.cycle` yourself. ``idle_sleep`` bounds the
    busy-wait when every queue is empty."""

    def __init__(self, frontend: ServeFrontend, idle_sleep: float = 0.002):
        self.frontend = frontend
        self.idle_sleep = float(idle_sleep)
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self.error: "str | None" = None

    def start(self) -> "ServeLoop":
        if self._thread is not None:
            raise RuntimeError("serve loop already started")
        if self.frontend.rt._dist is not None:
            raise RuntimeError(
                "ServeLoop runs cycles at its thread's own pace, which no two "
                "processes share: on a runtime sharded across processes call "
                "ServeFrontend.cycle() from the host program on every process"
            )
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        import time

        fe = self.frontend
        while not self._stop.is_set():
            try:
                fe.cycle()
            except Exception as exc:  # surface on stop(), never silent
                self.error = f"{type(exc).__name__}: {exc}"
                break
            if not any(
                q.depth for q in fe.admission.queues.values()
            ) and not len(fe.subs):
                time.sleep(self.idle_sleep)

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self.error is not None:
            raise RuntimeError(f"serve loop died: {self.error}")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
