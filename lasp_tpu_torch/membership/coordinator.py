"""MembershipCoordinator: stage → plan → commit → rebalance → finalize
(port of ``lasp_tpu.membership.coordinator``).

The top-level driver of a live membership change, mirroring the
riak_core console flow (``src/lasp_console.erl:31-94``) with the
vnode-handoff half the reference stubs (``src/lasp_vnode.erl:454-472``)
actually built:

- **stage/plan**: :class:`~.plan.MembershipStaging` commands collapse
  into an immutable :class:`~.plan.MembershipPlan` (claim table,
  transfer schedule, row-scoped frontier set, target epoch);
- **commit**: a JOIN grows the population immediately (bottom rows,
  row-scoped frontier degrade) and schedules SEED transfers (each new
  row one partial join from its claim predecessor); a LEAVE schedules
  the departing rows' transfers to their claim successors and keeps the
  population intact while they drain; DOWN drops the tail immediately
  (crash semantics, nothing to transfer). Every commit path advances
  the membership epoch exactly once — at the moment the extent changes;
- **rebalance**: :meth:`step` runs ONE interleaved cycle — a chaos/
  gossip round (traffic keeps flowing) plus one capped transfer cycle
  (:class:`~.handoff.HandoffEngine`); :meth:`cycle` is the
  transfer-only half for callers that own the stepping (a
  ``QuorumRuntime`` driving the same ``ChaosRuntime``);
- **finalize** (leave): once the schedule drains, a SWEEP re-joins
  every pair until a clean pass (catching writes landed on departers
  after their first transfer — idempotent joins make this exact), then
  the tail drops via ``membership_drop_tail``. A departer still CRASHED
  at finalize is declared ``lost_src``: its ungossiped state falls back
  to the hint log (acked quorum writes replay into the claim successor)
  + AAE, never a silent loss of acknowledged writes. Finalize DEFERS
  while any pair is partition-parked — transfers resume after heal (the
  AAE pending-rows pattern).

Serving integration: pass ``serve=ServeFrontend`` to re-home parked
threshold watches at finalize (a watch homed on a departed row moves to
the claim successor; ``down`` expires them typed instead).
"""

from __future__ import annotations

from ..telemetry import counter, events as tel_events
from .handoff import HandoffEngine
from .plan import MembershipPlan, MembershipStaging


class MembershipCoordinator:
    """One population + one staged membership flow; see the module doc.

    ``runtime`` is a ``ChaosRuntime`` or a bare ``ReplicatedRuntime``
    (wrapped in a fault-free timeline, the ``QuorumRuntime`` rule).
    ``hints`` is an optional ``quorum.HintLog`` backing the lost-src
    fallback; ``serve`` an optional ``ServeFrontend`` whose watches
    re-home at finalize. On a runtime sharded across processes every
    process drives the same coordinator: the staging plan, the transfer
    schedule and the parked pairs are host state, alike on every process,
    and the transfers read and land rows by owner."""

    def __init__(self, runtime, *, per_cycle: int = 8, hints=None,
                 serve=None, crash_patience: int = 4):
        from ..chaos.engine import ChaosRuntime
        from ..chaos.schedule import ChaosSchedule

        if not isinstance(runtime, ChaosRuntime):
            schedule = ChaosSchedule(
                runtime.n_replicas, runtime._host_neighbors, events=()
            )
            runtime = ChaosRuntime(runtime, schedule)
        self.ch = runtime
        self.rt = runtime.rt
        self.per_cycle = max(1, int(per_cycle))
        self.hints = hints
        self.serve = serve
        self.staging = MembershipStaging(self.rt)
        #: cycles to wait while EVERY remaining transfer is blocked
        #: solely on a crashed departer before declaring them lost_src
        #: (a partition-parked pair never trips this — it resumes on
        #: heal; a crash with a scheduled restore usually clears within
        #: the patience window). Deterministic in cycles, so replays
        #: reproduce the same lost set.
        self.crash_patience = max(1, int(crash_patience))
        self._crash_wait = 0
        self.engine: "HandoffEngine | None" = None
        self._plan: "MembershipPlan | None" = None
        self.commits = 0
        self.lost_sources: list = []
        self.hint_fallback_rows = 0
        # lifetime accounting (engines are per-plan; totals survive them)
        self.total_transferred = 0
        self.total_transfer_bytes = 0
        self.total_parked = 0
        self.max_cycle_batch = 0
        #: host seconds of the settled plans' transfer dispatches (device
        #: work included; the port's stand-in for JAX's ledger record)
        self.transfer_seconds = 0.0
        #: rounds from each commit to its plan settling (ownership
        #: transferred + tail dropped) — the bench's
        #: rounds-to-ownership-settled series
        self.settle_rounds: list = []
        self._commit_round: "int | None" = None

    # -- staging --------------------------------------------------------------
    def stage_join(self, new_n: int, new_neighbors=None) -> None:
        self.staging.stage_join(new_n, new_neighbors)

    def stage_leave(self, new_n: int, new_neighbors=None) -> None:
        self.staging.stage_leave(new_n, new_neighbors)

    def stage_down(self, new_n: int, new_neighbors=None) -> None:
        self.staging.stage_down(new_n, new_neighbors)

    def plan(self) -> MembershipPlan:
        return self.staging.plan()

    @property
    def rebalancing(self) -> bool:
        return self._plan is not None

    # -- commit ---------------------------------------------------------------
    def commit(self, plan: "MembershipPlan | None" = None) -> MembershipPlan:
        """Execute a plan's immediate half and schedule its transfers;
        see the module doc. Returns the committed plan."""
        if self._plan is not None:
            raise RuntimeError(
                "a committed plan is still rebalancing "
                f"({self.engine.outstanding} transfer(s) outstanding) — "
                "run it to settled before committing another"
            )
        if plan is None:
            plan = self.staging.plan()
        self.staging.clear()
        self.commits += 1
        counter(
            "membership_commits_total",
            help="staged membership plans committed, by kind",
            kind=plan.kind,
        ).inc()
        if plan.kind == "join":
            self.rt.membership_grow(
                plan.new_n, plan.new_neighbors, dirty_rows=plan.dirty_rows
            )
            self.ch.sync_membership()
            self.engine = HandoffEngine(
                self.ch, plan.transfers, per_cycle=self.per_cycle,
                old_n=plan.old_n, new_n=plan.new_n,
            )
            self._plan = plan
            self._commit_round = self.ch.round
        elif plan.kind == "down":
            # crash semantics: no transfers, immediate drop; watches on
            # the departed rows expire typed (their state is GONE)
            self.rt.membership_drop_tail(
                plan.new_n, plan.new_neighbors,
                dirty_rows=plan.dirty_rows, actor_targets=None,
                kind="down_staged",
            )
            self.ch.sync_membership()
            self._rehome_watches(plan, expire=True)
        else:  # leave: population intact while the transfers drain
            self.engine = HandoffEngine(
                self.ch, plan.transfers, per_cycle=self.per_cycle,
                old_n=plan.old_n, new_n=plan.new_n,
            )
            self._plan = plan
            self._commit_round = self.ch.round
        return plan

    # -- rebalancing ----------------------------------------------------------
    def step(self, mode: str = "dense") -> dict:
        """One interleaved cycle: a chaos/gossip round THEN one capped
        transfer cycle (traffic keeps flowing during rebalance — the
        no-stop-the-world contract). Returns the merged round report."""
        residual = self.ch.step(mode=mode)
        out = {"round": self.ch.round, "residual": int(residual)}
        out.update(self.cycle())
        return out

    def cycle(self) -> dict:
        """The transfer-only half of :meth:`step`, for callers that own
        the chaos stepping (e.g. a ``QuorumRuntime`` sharing this
        coordinator's ``ChaosRuntime``)."""
        out = {"transfers": 0, "parked": 0, "changed_rows": 0,
               "outstanding": 0}
        if self.engine is None:
            return out
        out.update(self.engine.cycle())
        if not self.engine.outstanding:
            out["finalized"] = self._try_finalize()
        elif all(
            self.ch.crashed[int(s)] for s, _d in self.engine.pending
        ):
            # every remaining pair is blocked ONLY on a crashed
            # departer — after the patience window, stop waiting for a
            # restore and take the lost_src path (hints + AAE recover
            # the acked writes; see _hint_fallback)
            self._crash_wait += 1
            if self._crash_wait >= self.crash_patience:
                self.engine.pending = []
                out["finalized"] = self._try_finalize()
        else:
            self._crash_wait = 0
        return out

    def _try_finalize(self) -> bool:
        plan = self._plan
        if plan is None:
            return False
        if plan.kind == "join":
            # seeds delivered: the plan is settled (gossip owns the rest)
            self._settle(plan)
            return True
        # leave: sweep every pair until a clean pass — idempotent joins
        # make the sweep exact for writes that landed on a departer
        # after its first transfer. Pairs whose endpoints are
        # partition-parked defer the finalize wholesale (resumed next
        # cycle, after heal); a CRASHED departer is lost_src.
        pairs = list(plan.transfers)
        lost = [
            (s, d) for s, d in pairs if self.ch.crashed[s]
        ]
        sweep = [p for p in pairs if p not in lost]
        for _ in range(8):
            dispatched, changed, parked = (
                self.engine.dispatch_pairs(sweep) if sweep else (0, 0, [])
            )
            if parked:
                return False  # partition-parked: retry next cycle
            if changed == 0:
                break
        if lost:
            self._hint_fallback(lost, plan)
        actor_targets = {int(s): int(d) for s, d in plan.transfers}
        for s, _d in lost:
            # a crashed departer's actor lanes retire (its tokens may
            # still circulate; the incarnation rule)
            actor_targets.pop(int(s), None)
        self.rt.membership_drop_tail(
            plan.new_n, plan.new_neighbors,
            dirty_rows=plan.dirty_rows, actor_targets=actor_targets,
        )
        self.ch.sync_membership()
        self._rehome_watches(plan, expire=False)
        self._settle(plan)
        return True

    def _settle(self, plan: MembershipPlan) -> None:
        if self.engine is not None:
            self.total_transferred += self.engine.transferred
            self.total_transfer_bytes += self.engine.transfer_bytes
            self.total_parked += self.engine.parked_events
            self.transfer_seconds += self.engine.transfer_seconds
            self.max_cycle_batch = max(
                self.max_cycle_batch, self.engine.max_batch
            )
        if self._commit_round is not None:
            self.settle_rounds.append(
                max(0, self.ch.round - self._commit_round)
            )
        tel_events.emit(
            "membership", kind="plan_settled",
            old_n=plan.old_n, new_n=plan.new_n, epoch=plan.epoch,
            transfers=len(plan.transfers),
            lost=len(self.lost_sources),
        )
        self._plan = None
        self.engine = None
        self._commit_round = None
        self._crash_wait = 0

    def _hint_fallback(self, lost, plan: MembershipPlan) -> None:
        """Crashed-departer recovery: replay every hint-log record
        naming a lost source into its claim successor — an acked quorum
        write held ONLY by the crashed departer survives the drop (the
        no-acknowledged-write-lost contract; anything never acked nor
        gossiped takes the crash semantics, honestly)."""
        for src, dst in lost:
            self.lost_sources.append(int(src))
            counter(
                "membership_transfers_total",
                help="staged ownership transfers, by outcome (done = "
                     "dispatched this cycle, parked = deferred "
                     "unreachable, lost_src = departer crashed at "
                     "finalize)",
                outcome="lost_src",
            ).inc()
            if self.hints is None:
                continue
            # the restore-path replay, re-targeted at the claim
            # successor — same records, same idempotence, same
            # quorum_hint_replays_total accounting
            self.hint_fallback_rows += self.hints.replay(
                self.rt, src, target=dst
            )

    def _rehome_watches(self, plan: MembershipPlan, expire: bool) -> None:
        from .plan import claim_row

        if self.serve is None:
            return
        new_n = plan.new_n
        self.serve.on_membership(
            claim_of=(lambda r, _n=new_n: claim_row(r, _n)),
            expire=expire,
        )

    # -- drivers / reporting --------------------------------------------------
    def run_to_settled(self, max_rounds: int = 512,
                       mode: str = "dense") -> dict:
        """Step until the committed plan settles AND the population
        quiesces past the fault horizon. Returns :meth:`report`."""
        start = self.ch.round
        while True:
            if self.ch.round - start >= max_rounds:
                raise RuntimeError(
                    f"membership did not settle within {max_rounds} "
                    f"rounds ({self.engine.outstanding if self.engine else 0}"
                    " transfer(s) outstanding)"
                )
            out = self.step(mode=mode)
            if (
                not self.rebalancing
                and out["residual"] == 0
                and self.ch.round > self.ch.schedule.horizon
            ):
                break
        return self.report()

    def report(self) -> dict:
        eng = self.engine
        return {
            "epoch": self.rt.membership_epoch,
            "n_replicas": self.rt.n_replicas,
            "commits": self.commits,
            "rebalancing": self.rebalancing,
            "outstanding": eng.outstanding if eng else 0,
            "transferred": (
                self.total_transferred + (eng.transferred if eng else 0)
            ),
            "transfer_bytes": (
                self.total_transfer_bytes
                + (eng.transfer_bytes if eng else 0)
            ),
            "parked_events": (
                self.total_parked + (eng.parked_events if eng else 0)
            ),
            "max_cycle_batch": max(
                self.max_cycle_batch, eng.max_batch if eng else 0
            ),
            "lost_sources": list(self.lost_sources),
            "hint_fallback_rows": self.hint_fallback_rows,
            "settle_rounds": list(self.settle_rounds),
        }
