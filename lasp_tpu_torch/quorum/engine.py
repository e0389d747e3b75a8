"""QuorumRuntime: thousands of in-flight quorum get/put requests as
batched tensor steps over a chaos-masked gossip population (port of
``lasp_tpu.quorum.engine``).

The execution model (one :meth:`QuorumRuntime.step` = one logical
round):

1. the wrapped :class:`~lasp_tpu_torch.chaos.engine.ChaosRuntime` runs one
   chaos round (crash/restore actions, mask compile, the runtime's own
   gossip step) — coordination RIDES the mesh, it never stalls it
   (Tascade's barrier-free discipline);
2. rows restored this round take HINTED HANDOFF first: every acked put
   whose preflist names them replays from the durable hint log
   (:mod:`.hints`) before they serve another quorum;
3. PREPARE requests pick their preflist (coordinator-first ring walk;
   a crashed coordinator routes to the next live replica) and puts
   apply their op at the coordinator row;
4. ONE tensor step on the device advances every waiting request against
   this round's reachability (``fsm.components`` over the chaos mask):
   replies accumulate, quorums fire, timeouts flag;
5. fired requests resolve host-side in request order — get values are
   masked partial joins over the acked rows (``gossip.join_all``),
   READ-REPAIR and put replication collect as join contributions; a
   timeout with retries left RE-PICKS the coordinator (next live
   replica, fresh preflist, reset acks), without retries it FAILS with
   the partial-quorum error surface;
6. collected contributions land as masked partial joins
   (``ReplicatedRuntime.join_rows``), two-phase: every value read this
   round sees the PRE-resolution population (the bulk-synchronous
   Jacobi discipline of the dataflow sweeps), then all writes join in —
   join commutativity/idempotence makes the batched scatter
   bit-identical to applying each request's writes one at a time.

Read semantics vs the reference: ``lasp_read_fsm`` merges the first R
REPLY PAYLOADS as they arrive; the tensor build re-reads each acked
row at the merge round (replies are "late-merged"). Every read is
still a join of a replica subset — a monotone lower bound of the
coverage value, at least as fresh as the reference's buffered replies
(CRDT reads have no freshness ceiling to violate).

``engine="sequential"`` runs the SAME protocol one request at a time
with scalar transitions (``fsm.transition_sequential``) and
per-request joins — the oracle the batched engine is held bit-identical
against: results, repair writes, ack sequences, final population states.
Each transition step lands in the kernel cost ledger as a
``quorum_step`` record; :attr:`QuorumRuntime.fsm_seconds` totals the host
time of the transition steps.

On a runtime sharded across processes every process runs the same
protocol: the coordinators' reads pull the acked rows from their owners,
and the replication, read-repair and hint replays are ``join_rows`` landed
by owner, so request ids, latencies and the trace are the same on every
process.
"""

from __future__ import annotations

import numpy as np

from ..lattice.base import tree_map
from ..mesh.gossip import join_all, rows_traffic_bytes
from ..membership.errors import StaleEpochError
from ..telemetry import counter, events as tel_events, gauge, histogram, span
from ..telemetry.convergence import get_monitor
from ..utils.metrics import Timer
from . import fsm
from .hints import HintLog


class PartialQuorumError(RuntimeError):
    """A request exhausted its retries without assembling its quorum —
    the reference FSM's ``{error, timeout}`` reply surface. Raised by
    :meth:`QuorumRuntime.result` for FAILED requests (the failure is
    also readable non-raising via ``result(rid, raise_on_error=False)``)."""


class _Request:
    """Host-side record of one request (the python fields that never
    enter the kernel: op payloads, results, latency stamps)."""

    __slots__ = (
        "rid", "kind", "var", "op", "actor", "n", "need", "timeout",
        "retries_left", "degraded", "repair", "put_row", "applied_row",
        "submit_round",
        "ack_round", "final_round", "status", "value", "error",
        "repaired_rows", "pushed_rows", "retries_used",
    )

    def __init__(self, rid, kind, var, op, actor, n, need, timeout,
                 retries, degraded, repair):
        self.rid = rid
        self.kind = kind
        self.var = var
        self.op = op
        self.actor = actor
        self.n = int(n)
        self.need = int(need)
        self.timeout = int(timeout)
        self.retries_left = int(retries)
        self.retries_used = 0
        self.degraded = bool(degraded)
        self.repair = bool(repair)
        self.put_row = None
        #: the replica row update_at applied the op at — the ONE row
        #: that holds the write before any push; a re-picked coordinator
        #: is NOT this row and must receive the delta like any pick
        self.applied_row = None
        self.submit_round = None
        self.ack_round = None
        self.final_round = None
        self.status = "pending"
        self.value = None
        self.error = None
        self.repaired_rows = 0
        self.pushed_rows = 0


class QuorumRuntime:
    """One population + one fault timeline + a batch of coordination
    FSMs; see the module doc.

    ``runtime`` is a :class:`~lasp_tpu_torch.chaos.engine.ChaosRuntime`, or a
    bare :class:`~lasp_tpu_torch.mesh.runtime.ReplicatedRuntime` (wrapped in a
    fault-free chaos timeline so the stepping/mask plumbing is uniform).
    ``n``/``r``/``w`` default to the reference's N=3, R=W=2;
    ``engine`` picks the batched step (default) or the sequential
    per-request reference; ``hints`` is a :class:`HintLog`, a path for a
    durable one, or None for in-memory."""

    def __init__(self, runtime, *, n: int = 3, r: int = 2, w: int = 2,
                 timeout: int = 4, retries: int = 1,
                 engine: str = "batched",
                 hints: "HintLog | str | None" = None,
                 mode: str = "dense"):
        from ..chaos.engine import ChaosRuntime
        from ..chaos.schedule import ChaosSchedule

        if not isinstance(runtime, ChaosRuntime):
            schedule = ChaosSchedule(
                runtime.n_replicas, runtime._host_neighbors, events=()
            )
            runtime = ChaosRuntime(runtime, schedule)
        self.ch = runtime
        self.rt = runtime.rt
        if engine not in ("batched", "sequential"):
            raise ValueError(
                f"unknown engine {engine!r} (batched | sequential)"
            )
        self.engine = engine
        self.mode = mode
        self.n_default = int(n)
        self.r_default = int(r)
        self.w_default = int(w)
        self.timeout_default = int(timeout)
        self.retries_default = int(retries)
        if isinstance(hints, str):
            hints = HintLog(hints)
        self.hints = hints if hints is not None else HintLog()
        R = self.rt.n_replicas
        if self.n_default > R:
            raise ValueError(f"n={n} exceeds the {R}-replica population")
        #: widest preflist any request may use (the kernel's pick axis)
        self.n_max = self.n_default
        self._reqs: dict = {}
        self._order: list = []  # rids in submit order (the batch axis)
        #: non-terminal rids in submit order — per-round work is
        #: O(inflight), never O(requests-ever) (long-lived serving runs
        #: retire requests every round; result/_reqs stay queryable)
        self._active: list = []
        self._next_rid = 0
        # struct-of-arrays control plane (grown on demand)
        self._cap = 0
        self._state = np.zeros(0, dtype=np.int32)
        self._coord = np.zeros(0, dtype=np.int32)
        self._picks = np.zeros((0, self.n_max), dtype=np.int32)
        self._pick_valid = np.zeros((0, self.n_max), dtype=bool)
        self._acks = np.zeros((0, self.n_max), dtype=bool)
        self._deadline = np.zeros(0, dtype=np.int32)
        self._need = np.zeros(0, dtype=np.int32)
        self._degraded = np.zeros(0, dtype=bool)
        #: (round, rid, event, payload) protocol trace — the ack-sequence
        #: record the bit-identity assertions compare across engines
        self.trace: list = []
        self._comp_cache: "tuple | None" = None
        #: the membership epoch the live picks/preflists were minted
        #: under — a runtime resize/staged commit advances the
        #: runtime's epoch and every in-flight request FENCES
        #: (:meth:`_epoch_fence`): re-prepare against the new ring with
        #: a retry budget, typed ``StaleEpochError`` without one.
        #: Without the fence a request would keep preflist indices whose
        #: meaning changed (runtime.py ``quorum_value``: a stale index
        #: after a resize silently reads the wrong quorum).
        self._fence_epoch = self.rt.membership_epoch
        # aggregate accounting (the report / bench surface)
        self.completed = 0
        self.failed = 0
        self.retries = 0
        self.repaired_rows = 0
        self.pushed_rows = 0
        self.wire_bytes = 0
        #: host seconds spent in the FSM transition steps
        self.fsm_seconds = 0.0
        #: terms acked to clients, by var — the no-acknowledged-write-
        #: lost invariant's witness set (chaos.invariants.check_no_write_lost)
        self.acked_terms: dict = {}

    # -- submission -----------------------------------------------------------
    def _grow(self, need: int) -> None:
        if need <= self._cap:
            return
        cap = max(16, self._cap)
        while cap < need:
            cap *= 2
        pad = cap - self._cap

        def ext(a, fill=0):
            return np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)]
            )

        self._state = ext(self._state, fsm.DONE)
        self._coord = ext(self._coord)
        self._picks = ext(self._picks)
        self._pick_valid = ext(self._pick_valid, False)
        self._acks = ext(self._acks, False)
        self._deadline = ext(self._deadline)
        self._need = ext(self._need)
        self._degraded = ext(self._degraded, False)
        self._cap = cap

    def _submit(self, kind, var, op, actor, coordinator, n, need, timeout,
                retries, degraded, repair) -> int:
        if var not in self.rt.store.ids():
            raise KeyError(var)
        self.rt._population(var)  # sync late declares before any quorum
        R = self.rt.n_replicas
        n = self.n_default if n is None else int(n)
        if not 1 <= n <= min(self.n_max, R):
            raise ValueError(
                f"n={n} outside [1, {min(self.n_max, R)}] (n_max is fixed "
                "at construction — the kernel's pick axis)"
            )
        if not 1 <= need <= n:
            raise ValueError(f"quorum {need} outside [1, n={n}]")
        coordinator = 0 if coordinator is None else int(coordinator)
        if not 0 <= coordinator < R:
            raise IndexError(
                f"coordinator {coordinator} out of range for {R} replicas"
            )
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, kind, var, op, actor, n, need, timeout,
                       retries, degraded, repair)
        req.submit_round = self.ch.round
        self._reqs[rid] = req
        self._order.append(rid)
        self._active.append(rid)
        self._grow(rid + 1)
        self._state[rid] = fsm.PREPARE
        self._coord[rid] = coordinator
        self._need[rid] = int(need)
        self._degraded[rid] = bool(degraded)
        counter(
            "quorum_requests_total",
            help="quorum coordination requests submitted, by kind",
            kind=kind,
        ).inc()
        return rid

    def submit_get(self, var_id: str, coordinator: "int | None" = None, *,
                   r: "int | None" = None, n: "int | None" = None,
                   timeout: "int | None" = None,
                   retries: "int | None" = None,
                   degraded: bool = False, repair: bool = True) -> int:
        """Enqueue one quorum GET (the read FSM): answered once R of the
        N preflist rows reply; the value is their join. ``degraded=True``
        applies the R-of-live rule (answer from whatever is reachable,
        the ``ChaosRuntime.degraded_read`` contract) instead of failing
        on a partial quorum. Returns the request id."""
        return self._submit(
            "get", var_id, None, None, coordinator, n,
            self.r_default if r is None else int(r),
            self.timeout_default if timeout is None else int(timeout),
            self.retries_default if retries is None else int(retries),
            degraded, repair,
        )

    def submit_put(self, var_id: str, op: tuple, actor,
                   coordinator: "int | None" = None, *,
                   w: "int | None" = None, n: "int | None" = None,
                   timeout: "int | None" = None,
                   retries: "int | None" = None) -> int:
        """Enqueue one quorum PUT (the update FSM): the op applies at
        the coordinator row, replicates to the N preflist rows as
        masked partial joins, and acks to the client at W replicas —
        at which point the write lands in the durable hint log (the
        no-acknowledged-write-lost contract). Returns the request id."""
        return self._submit(
            "put", var_id, tuple(op), actor, coordinator, n,
            self.w_default if w is None else int(w),
            self.timeout_default if timeout is None else int(timeout),
            self.retries_default if retries is None else int(retries),
            False, False,
        )

    # -- stepping -------------------------------------------------------------
    def active_rids(self) -> list:
        return [
            rid for rid in self._active
            if self._state[rid] not in (fsm.DONE, fsm.FAILED)
        ]

    @property
    def inflight(self) -> int:
        return len(self.active_rids())

    def _components(self, rnd: int) -> np.ndarray:
        mask = self.ch.schedule.mask_at(rnd)
        key = (id(mask), self.ch.crashed.tobytes())
        cached = self._comp_cache
        if cached is not None and cached[0] == key and cached[1] is mask:
            return cached[2]
        comp = fsm.components(
            self.rt._host_neighbors, mask, ~self.ch.crashed
        )
        self._comp_cache = (key, mask, comp)
        return comp

    def _prepare_batch(self, rnd: int) -> None:
        """PREPARE → WAITING_R for every pending request in ONE pass:
        preflists pick per request (a crashed coordinator routes to the
        next live replica first — the riak_core routing), then ALL
        puts' coordinator deltas mint through one grouped ingest cycle
        (``ReplicatedRuntime.ingest_cycle`` / ``mesh.ingest``: one
        vmapped dispatch per dispatch-plan group instead of one
        ``update_at`` per put) and their minted rows gather in one
        batched pull per variable.

        Puts hitting the SAME (var, coordinator row) in one round mint
        in sequential WAVES: each put's recorded delta row must reflect
        exactly the ops at or before it (the per-op gather contract —
        a later same-row put's delta must not widen an earlier put's
        pushes), so duplicate-row rounds degrade gracefully toward the
        sequential path; the common unique-row round is one wave.

        Mint failures keep their request in PREPARE (retried — and
        re-raised — next round) and re-raise after the round's other
        mints issue: an applied mint MUST transition, or its retry
        would double-apply. The only deviation from the historical
        per-request loop is that a mint error no longer blocks OTHER
        variables' puts submitted after it in the same round."""
        prep = [
            rid for rid in self._active
            if self._state[rid] == fsm.PREPARE
        ]
        staged: list = []  # (rid, coord, picks)
        for rid in prep:
            req = self._reqs[rid]
            coord = int(self._coord[rid])
            if self.ch.crashed[coord]:
                nxt = fsm.next_live_coordinator(coord, self.ch.crashed)
                if nxt is None:
                    self._fail(rid, rnd, "no live replica to coordinate")
                    continue
                coord = nxt
                self._coord[rid] = coord
            picks = fsm.preflist(coord, req.n, self.rt.n_replicas)
            self._picks[rid, : req.n] = picks
            self._picks[rid, req.n:] = 0
            self._pick_valid[rid] = False
            self._pick_valid[rid, : req.n] = True
            self._acks[rid] = False
            self._deadline[rid] = rnd + req.timeout
            staged.append((rid, coord, picks))
        # wave assignment: occurrence index of (var, coord-row) this round
        waves: list = []
        occurrence: dict = {}
        need_mint: set = set()
        for rid, coord, _picks in staged:
            req = self._reqs[rid]
            if req.kind == "put" and req.put_row is None:
                need_mint.add(rid)
                key = (req.var, coord)
                w = occurrence.get(key, 0)
                occurrence[key] = w + 1
                while len(waves) <= w:
                    waves.append({})
                waves[w].setdefault(req.var, []).append(rid)
        minted: set = set()
        mint_exc = None
        for wave in waves:
            if mint_exc is not None:
                break  # unminted requests stay PREPARE and retry
            batches = {
                var: [
                    (int(self._coord[rid]), self._reqs[rid].op,
                     self._reqs[rid].actor)
                    for rid in rids
                ]
                for var, rids in wave.items()
            }
            report = self.rt.ingest_cycle(batches, isolate_errors=True)

            for var, rids in wave.items():
                exc = report["errors"].get(var)
                applied = len(rids)
                if exc is not None:
                    # sequential prefix semantics: ops before the
                    # failure applied (batch_index marks the boundary;
                    # a batch-level error applied nothing)
                    applied = min(
                        int(getattr(exc, "batch_index", 0)), len(rids)
                    )
                    if mint_exc is None:
                        mint_exc = exc
                if not applied:
                    continue
                got = self.rt._rows_of(
                    var, [int(self._coord[rid]) for rid in rids[:applied]]
                )
                for i, rid in enumerate(rids[:applied]):
                    req = self._reqs[rid]
                    req.put_row = tree_map(lambda x, _i=i: x[_i], got)
                    req.applied_row = int(self._coord[rid])
                    minted.add(rid)
        for rid, coord, picks in staged:
            if rid in need_mint and rid not in minted:
                continue  # mint failed/aborted: stays PREPARE, retries
            self._state[rid] = fsm.WAITING_R
            self.trace.append((rnd, rid, "issue", (coord, picks.tolist())))
        if mint_exc is not None:
            raise mint_exc

    def _epoch_fence(self, rnd: int) -> None:
        """The membership epoch advanced under this batch's feet —
        riak_core's ``{error, ring_changed}`` surface, typed. A request
        fences only when the change actually INVALIDATED it: its
        coordinator or a valid pick no longer exists, or its preflist
        width no longer fits the population. Surviving rows keep their
        indices in this membership model, so a pure GROW (and a shrink
        that spares the whole preflist) leaves in-flight requests
        untouched — no spurious retry burn, no dropped phase-B pushes
        at still-valid replicas.

        For AFFECTED requests:

        - WAITING_N finalizes: the client already has its answer;
          chasing straggler acks at departed rows would push state at
          rows that no longer exist;
        - WAITING_R with retries left RE-PREPARES against the new ring
          (one retry consumed): a departed coordinator routes to its
          ring-fold claim successor, acks reset, and a put's
          already-minted delta rides to the fresh picks (a mint at a
          departed row was handed to the claim successor by the staged
          transfer/graceful merge, so nothing re-applies);
        - WAITING_R without retries (or a preflist width the population
          can no longer hold) FAILS with the typed ``stale_epoch``
          status — :meth:`result` raises
          :class:`~lasp_tpu_torch.membership.errors.StaleEpochError`."""
        cur = self.rt.membership_epoch
        prev = self._fence_epoch
        self._fence_epoch = cur
        R = self.rt.n_replicas
        refenced = failed = 0
        for rid in list(self._active):
            st = self._state[rid]
            req = self._reqs[rid]
            if st == fsm.PREPARE:
                # not yet issued: nothing stale in flight, but a staged
                # coordinator index may have departed — remap to its
                # claim successor before the preflist pick. A preflist
                # width the shrunken population can no longer hold must
                # fail typed HERE: _prepare_batch's pick would raise an
                # untyped ValueError and strand the whole step
                if req.n > R:
                    self._fence_fail(rid, req, rnd, prev, cur, R)
                    failed += 1
                    continue
                coord = int(self._coord[rid])
                if coord >= R:
                    self._coord[rid] = coord % R
                    self.trace.append(
                        (rnd, rid, "epoch_fence", ("remapped", cur))
                    )
                continue
            if st not in (fsm.WAITING_R, fsm.WAITING_N):
                continue
            affected = (
                req.n > R
                or int(self._coord[rid]) >= R
                or bool(
                    (self._picks[rid][self._pick_valid[rid]] >= R).any()
                )
            )
            if not affected:
                continue
            if st == fsm.WAITING_N:
                self._finalize(rid, rnd)
                self.trace.append(
                    (rnd, rid, "epoch_fence", ("finalized", cur))
                )
                continue
            if req.n <= R and req.retries_left > 0:
                req.retries_left -= 1
                req.retries_used += 1
                self.retries += 1
                coord = int(self._coord[rid])
                if coord >= R:
                    coord = coord % R  # the claim successor's row
                self._coord[rid] = coord
                self._acks[rid] = False
                self._state[rid] = fsm.PREPARE
                if req.applied_row is not None and req.applied_row >= R:
                    # the mint row departed: every fresh pick must
                    # receive the delta (the claim successor holds the
                    # handed-off tokens, and re-joining is idempotent)
                    req.applied_row = -1
                refenced += 1
                self.trace.append(
                    (rnd, rid, "epoch_fence", ("refenced", cur))
                )
            else:
                self._fence_fail(rid, req, rnd, prev, cur, R)
                failed += 1
        if refenced:
            counter(
                "quorum_epoch_fences_total",
                help="in-flight quorum requests fenced by a membership "
                     "epoch change, by outcome (refenced = re-prepared "
                     "on the new ring, failed = typed StaleEpochError)",
                outcome="refenced",
            ).inc(refenced)
        if failed:
            counter(
                "quorum_epoch_fences_total",
                help="in-flight quorum requests fenced by a membership "
                     "epoch change, by outcome (refenced = re-prepared "
                     "on the new ring, failed = typed StaleEpochError)",
                outcome="failed",
            ).inc(failed)
        self._active = [
            rid for rid in self._active
            if self._state[rid] not in (fsm.DONE, fsm.FAILED)
        ]

    def _fence_fail(self, rid, req, rnd: int, prev: int, cur: int,
                    R: int) -> None:
        """Resolve one fenced request as typed ``stale_epoch`` (the
        shared terminal arm of :meth:`_epoch_fence`)."""
        self._state[rid] = fsm.FAILED
        req.status = "stale_epoch"
        req.error = (
            f"membership epoch advanced {prev} -> {cur} mid-flight "
            f"(population now {R} replicas"
            + (f", below the request's preflist width n={req.n}"
               if req.n > R else "")
            + ") and no retry can fit it — re-submit against the "
            "current ring"
        )
        req.final_round = rnd
        self.failed += 1
        counter(
            "quorum_completions_total",
            help="quorum requests resolved, by kind and outcome",
            kind=req.kind, outcome="stale_epoch",
        ).inc()
        self.trace.append((rnd, rid, "epoch_fence", ("failed", cur)))

    def _fail(self, rid: int, rnd: int, why: str) -> None:
        req = self._reqs[rid]
        self._state[rid] = fsm.FAILED
        req.status = "failed"
        req.error = why
        req.final_round = rnd
        self.failed += 1
        counter(
            "quorum_completions_total",
            help="quorum requests resolved, by kind and outcome",
            kind=req.kind, outcome="failed",
        ).inc()
        self.trace.append((rnd, rid, "failed", why))

    def _repick(self, rid: int, rnd: int) -> None:
        """Timeout with retries left: coordinator re-pick — the next
        LIVE replica in ring order takes over with a fresh preflist and
        empty ack set (a put's row delta is already minted and joins at
        the new picks as they ack)."""
        req = self._reqs[rid]
        req.retries_left -= 1
        req.retries_used += 1
        self.retries += 1
        counter(
            "quorum_retries_total",
            help="quorum coordinator re-picks after a wait timeout",
        ).inc()
        nxt = fsm.next_live_coordinator(int(self._coord[rid]),
                                        self.ch.crashed)
        if nxt is None:
            self._fail(rid, rnd, "no live replica to coordinate")
            return
        self._coord[rid] = nxt
        picks = fsm.preflist(nxt, req.n, self.rt.n_replicas)
        self._picks[rid, : req.n] = picks
        self._acks[rid] = False
        self._deadline[rid] = rnd + req.timeout
        self._state[rid] = fsm.WAITING_R
        self.trace.append((rnd, rid, "repick", (nxt, picks.tolist())))

    def _record_ack_terms(self, req) -> None:
        """Witness terms for the no-acknowledged-write-lost invariant:
        the terms a client was told are durable (set-family adds; other
        op shapes are covered by the hint log + bit-equality checks,
        not by term membership)."""
        op = req.op
        terms = ()
        if op[0] == "add":
            terms = (op[1],)
        elif op[0] == "add_all":
            terms = tuple(op[1])
        elif op[0] == "add_by_token" and len(op) >= 3:
            terms = (op[2],)
        if terms:
            self.acked_terms.setdefault(req.var, set()).update(terms)

    def step(self) -> dict:
        """ONE logical round: chaos/gossip step, hinted handoff for
        restored rows, then the FSM batch advance (see the module doc).
        Returns ``{"round", "residual", "fired", "failed", "pushed",
        "repaired"}`` for the round."""
        rnd = self.ch.round
        self.ch.sync_membership()
        if self.rt.membership_epoch != self._fence_epoch:
            self._epoch_fence(rnd)
        residual = self.ch.step(mode=self.mode)
        for replica in self.ch.last_restored:
            handed = self.hints.replay(self.rt, replica)
            # post-replay reclaim: records this restore just re-acked
            # at FULL preflist strength stop accumulating across
            # repeat crashes (records still short of N live holders
            # stay load-bearing — the no-write-lost contract)
            pruned = self.hints.prune_replayed(
                self.rt, replica, live=~self.ch.crashed
            )
            self.trace.append(
                (rnd, -1, "handoff", (int(replica), handed, pruned))
            )
            tel_events.emit(
                "quorum", replica=int(replica), action="hinted_handoff",
                rows=handed, pruned=pruned, round=rnd,
            )
        with span("quorum.step", round=rnd):
            out = self._fsm_step(rnd)
        gauge(
            "quorum_inflight",
            help="quorum requests currently in flight (non-terminal FSMs)",
        ).set(self.inflight)
        return {"round": rnd, "residual": int(residual), **out}

    def _fsm_step(self, rnd: int) -> dict:
        # PREPARE processing first: a request submitted before this round
        # issues now, so this round's reachability already counts replies
        # (put mints ride one grouped ingest dispatch per plan group)
        self._prepare_batch(rnd)
        active = [
            rid for rid in self._active
            if self._state[rid] in (fsm.WAITING_R, fsm.WAITING_N)
        ]
        fired = failed = 0
        pushes: list = []   # (var, row, contrib_tree) put replication
        repairs: list = []  # (var, row, contrib_tree) read-repair
        if active:
            idx = np.asarray(active, dtype=np.int64)
            comp = self._components(rnd)
            live = ~self.ch.crashed
            args = (
                self._state[idx], self._coord[idx], self._picks[idx],
                self._pick_valid[idx], self._acks[idx],
                self._deadline[idx], self._need[idx], self._degraded[idx],
                comp, live, rnd,
            )
            with Timer() as t:
                if self.engine == "batched":
                    (new_state, new_acks, newly, quorum_now, timeout_now,
                     done_now) = fsm.transition_batched(
                        *args, device=self.rt.device)
                else:
                    (new_state, new_acks, newly, quorum_now, timeout_now,
                     done_now) = fsm.transition_sequential(*args)
            self.fsm_seconds += t.elapsed
            self._ledger_record(len(active), t.elapsed)
            self._state[idx] = new_state
            self._acks[idx] = new_acks
            # -- host resolution, rid order (both engines identical) ----
            # phase A reads all use the PRE-resolution population
            values: dict = {}
            for k, rid in enumerate(active):
                req = self._reqs[rid]
                ack_rows = self._picks[rid][
                    self._pick_valid[rid] & self._acks[rid]
                ]
                if newly[k].any():
                    new_rows = sorted(
                        int(r) for r in self._picks[rid][newly[k]]
                    )
                    self.trace.append((rnd, rid, "ack", new_rows))
                    if req.kind == "put":
                        for r in new_rows:
                            # exclude only the row the op APPLIED at: a
                            # RE-PICKED coordinator acks like any pick
                            # and must receive the delta, or it would
                            # count toward W while holding nothing
                            if r != req.applied_row:
                                pushes.append((req.var, r, req.put_row))
                                req.pushed_rows += 1
                if quorum_now[k]:
                    fired += 1
                    req.ack_round = rnd
                    if req.kind == "get":
                        values[rid] = self._get_value(req, ack_rows)
                        if req.repair:
                            reach = (
                                live[self._picks[rid]]
                                & (comp[self._picks[rid]]
                                   == comp[self._coord[rid]])
                                & self._pick_valid[rid]
                            )
                            top = values[rid][1]
                            for r in self._picks[rid][
                                self._acks[rid] & reach
                            ]:
                                repairs.append((req.var, int(r), top))
                    else:
                        self._record_ack_terms(req)
                        self.hints.append(
                            req.var,
                            self._picks[rid][self._pick_valid[rid]],
                            req.put_row, rid,
                        )
                    self.trace.append(
                        (rnd, rid, "quorum", sorted(map(int, ack_rows)))
                    )
                elif timeout_now[k]:
                    if req.retries_left > 0:
                        self._repick(rid, rnd)
                    else:
                        failed += 1
                        self._fail(
                            rid, rnd,
                            f"partial quorum: {int(self._acks[rid].sum())}"
                            f"/{req.need} replies before the deadline",
                        )
                elif done_now[k]:
                    self._finalize(rid, rnd)
            # REPAIR resolves within the round: client answered, then
            # finalize or keep waiting for the stragglers
            for k, rid in enumerate(active):
                if not quorum_now[k]:
                    continue
                req = self._reqs[rid]
                if req.kind == "get":
                    req.value = values[rid][0]
                ackn = int(self._acks[rid].sum())
                histogram(
                    "quorum_latency_rounds",
                    help="rounds from submit to client quorum, by kind",
                    kind=req.kind,
                    buckets=(1, 2, 4, 8, 16, 32, 64),
                ).observe(max(1, rnd - req.submit_round + 1))
                if ackn >= req.n:
                    self._finalize(rid, rnd)
                else:
                    self._state[rid] = fsm.WAITING_N
                    self._deadline[rid] = rnd + req.timeout
            # phase B: all writes join in (order-free by commutativity)
            pushed = self._apply_contribs(pushes, "push")
            repaired = self._apply_contribs(repairs, "repair")
            self.repaired_rows += repaired
        else:
            pushed = repaired = 0
        self._active = [
            rid for rid in self._active
            if self._state[rid] not in (fsm.DONE, fsm.FAILED)
        ]
        if fired or failed or pushed or repaired:
            tel_events.emit(
                "quorum", round=rnd, action="round",
                fired=fired, failed=failed, pushed=pushed,
                repaired=repaired, inflight=self.inflight,
            )
        return {
            "fired": fired, "failed": failed,
            "pushed": pushed, "repaired": repaired,
        }

    def _get_value(self, req, ack_rows) -> tuple:
        """(decoded value, wire top) of a get over its acked rows — a
        masked partial join of the acked rows, pulled from their owners
        across processes (phase A: reads the pre-resolution population)."""
        var = self.rt.store.variable(req.var)
        codec, spec = self.rt._mesh_meta(req.var)
        top = join_all(codec, spec, self.rt._rows_of(req.var, ack_rows))
        decoded = self.rt.store._decode_value(
            var, self.rt._to_dense_row(req.var, top)
        )
        return decoded, top

    def _finalize(self, rid: int, rnd: int) -> None:
        req = self._reqs[rid]
        self._state[rid] = fsm.DONE
        req.status = "done"
        req.final_round = rnd
        if req.ack_round is None:  # all-N quorum: ack == finalize
            req.ack_round = rnd
        self.completed += 1
        counter(
            "quorum_completions_total",
            help="quorum requests resolved, by kind and outcome",
            kind=req.kind, outcome="done",
        ).inc()
        self.trace.append(
            (rnd, rid, "done", int(self._acks[rid].sum()))
        )

    def _apply_contribs(self, contribs: list, what: str) -> int:
        """Phase-B scatter: fold same-row contributions (request order)
        and join once per (var, row) — ``ReplicatedRuntime.join_rows``.
        The sequential engine applies per request instead; joins
        commute, so both land bit-identical states. Returns — and
        accounts — FRAMES (one per contribution): the wire unit, and
        the one count that is engine-independent by construction
        (whether a frame's join changed its row depends on fold order
        when several requests push one row; the device-level change
        signal stays visible via the frontier/residual)."""
        if not contribs:
            return 0
        if self.engine == "sequential":
            for var, row, tree in contribs:
                self.rt.join_rows(
                    var, np.asarray([row], dtype=np.int64), [tree]
                )
        else:
            by_var: dict = {}
            for var, row, tree in contribs:
                by_var.setdefault(var, {}).setdefault(row, []).append(tree)
            for var, rows_map in by_var.items():
                codec, spec = self.rt._mesh_meta(var)
                rows, folded = [], []
                for row in sorted(rows_map):
                    trees = rows_map[row]
                    acc = trees[0]
                    for t2 in trees[1:]:
                        acc = codec.merge(spec, acc, t2)
                    rows.append(row)
                    folded.append(acc)
                self.rt.join_rows(
                    var, np.asarray(rows, dtype=np.int64), folded
                )
        # every contribution is one row frame on the wire regardless of
        # whether the join changed the row (the frame is still sent) —
        # same accounting in both engines; per-VAR row bytes computed
        # once and multiplied by that var's frame count
        frames_per_var: dict = {}
        for v, _r, _t in contribs:
            frames_per_var[v] = frames_per_var.get(v, 0) + 1
        frame_bytes = sum(
            rows_traffic_bytes(self.rt._population(v), n)
            for v, n in frames_per_var.items()
        )
        self.wire_bytes += frame_bytes
        if what == "push":
            self.pushed_rows += len(contribs)
        counter(
            "quorum_wire_bytes_total",
            help="bytes moved by quorum coordination partial joins, by "
                 "kind (put replication pushes vs read-repair)",
            kind=what,
        ).inc(frame_bytes)
        return len(contribs)

    def _ledger_record(self, b_active: int, seconds: float) -> None:
        """One FSM-step dispatch into the kernel cost ledger — the
        ``quorum_step`` family (control-plane traffic: the struct-of-
        arrays slices + the shared component labeling). The batched
        transition returns host arrays, so its seconds close on that
        read."""
        from ..telemetry import get_ledger
        from ..telemetry import registry as _reg

        if not _reg.enabled():
            return
        get_ledger().record(
            "quorum_step",
            "fsm" if self.engine == "batched" else "fsm_seq",
            n_replicas=self.rt.n_replicas,
            fanout=self.n_max,
            seconds=seconds,
            rows=fsm.bucket_of(b_active),
        )

    # -- driving / results ----------------------------------------------------
    def drain(self, max_rounds: int = 4096) -> dict:
        """Step until every submitted request resolved (and the fault
        timeline's horizon passed). Returns the :meth:`report`."""
        start = self.ch.round
        while self.inflight or self.ch.round <= self.ch.schedule.horizon:
            if self.ch.round - start >= max_rounds:
                raise RuntimeError(
                    f"quorum drain did not resolve {self.inflight} "
                    f"request(s) within {max_rounds} rounds"
                )
            self.step()
        return self.report()

    def result(self, rid: int, raise_on_error: bool = True) -> dict:
        """One request's outcome: ``{"status", "value", "rounds",
        "acks", "coordinator", "retries", "error"}``. ``rounds`` is the
        client-visible latency in logical rounds (submit → quorum).
        FAILED requests raise :class:`PartialQuorumError` unless
        ``raise_on_error=False``."""
        req = self._reqs[rid]
        if req.status == "stale_epoch" and raise_on_error:
            raise StaleEpochError(
                f"request {rid} ({req.kind} {req.var!r}): {req.error}",
                current_epoch=self.rt.membership_epoch,
            )
        if req.status == "failed" and raise_on_error:
            raise PartialQuorumError(
                f"request {rid} ({req.kind} {req.var!r}): {req.error}"
            )
        status = req.status
        if status == "pending" and req.ack_round is not None:
            # the client already has its answer; the FSM is in
            # waiting_n finalizing toward the full preflist
            status = "acked"
        return {
            "status": status,
            "kind": req.kind,
            "var": req.var,
            "value": req.value,
            "rounds": (
                None if req.ack_round is None
                else max(1, req.ack_round - req.submit_round + 1)
            ),
            "acks": sorted(
                int(r) for r in self._picks[rid][
                    self._pick_valid[rid] & self._acks[rid]
                ]
            ),
            "coordinator": int(self._coord[rid]),
            "retries": req.retries_used,
            "error": req.error,
        }

    def latencies(self, kind: "str | None" = None) -> list:
        """Client-quorum latencies (rounds) of resolved requests, submit
        order — the bench scenario's p50/p99 source."""
        out = []
        for rid in self._order:
            req = self._reqs[rid]
            if kind is not None and req.kind != kind:
                continue
            if req.status == "done" and req.ack_round is not None:
                out.append(max(1, req.ack_round - req.submit_round + 1))
        return out

    def report(self) -> dict:
        """The coordination-layer report (also folded into the health
        surface under ``quorum``): completion/failure counts, latency
        percentiles by kind, retries, repair/push traffic, hint-log
        state."""
        def pct(xs, q):
            if not xs:
                return None
            return float(np.percentile(np.asarray(xs, dtype=np.float64), q))

        gl, pl = self.latencies("get"), self.latencies("put")
        report = {
            "requests": len(self._order),
            "completed": self.completed,
            "failed": self.failed,
            "inflight": self.inflight,
            "retries": self.retries,
            "get_p50_rounds": pct(gl, 50),
            "get_p99_rounds": pct(gl, 99),
            "put_p50_rounds": pct(pl, 50),
            "put_p99_rounds": pct(pl, 99),
            "repaired_rows": self.repaired_rows,
            "pushed_rows": self.pushed_rows,
            "wire_bytes": self.wire_bytes,
            "hints_pending": len(self.hints),
            "hint_replays": self.hints.replays,
            "engine": self.engine,
        }
        get_monitor().observe_quorum(**report)
        return report
