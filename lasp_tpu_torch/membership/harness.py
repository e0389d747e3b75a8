"""The membership invariant harness — the acceptance contract of live
join/leave/rebalance (port of ``lasp_tpu.membership.harness``).

:func:`run_membership_harness` drives a workload through a sequence of
staged membership transitions under a nemesis schedule and asserts:

1. **no acknowledged write lost** (quorum workloads): every term a
   client was told is durable survives the full join/leave/rebalance
   sequence — across partition-during-handoff, crash-of-departing-
   replica (hint fallback), and every other preset
   (``chaos.invariants.check_no_write_lost``);
2. **static-twin bit-equality** (direct workloads): the settled
   population is BIT-IDENTICAL, leaf for leaf, to a twin runtime
   constructed statically at the TARGET membership with the same
   writes — membership churn changed the journey, never the
   destination. (The caller's contract for this check: direct writes
   land on rows that exist in every membership the run visits, so the
   twin can apply the identical ``(row, op, actor)`` schedule — the
   documented honesty condition, mirroring the chaos harness's
   deterministic-workload rule.)
3. **typed epoch fencing**: every quorum request resolves — done,
   failed, or ``stale_epoch`` — never leaked in flight across an epoch
   change;
4. **replay determinism**: a second identical run reproduces the final
   state fingerprint (and the quorum protocol trace) bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from ..chaos.invariants import (
    InvariantViolation,
    check_no_write_lost,
    fingerprint,
    snapshot_states,
    states_equal,
)


def run_membership_harness(
    build,
    plan_ops,
    *,
    build_twin=None,
    schedule=None,
    preset: "str | None" = None,
    seed: int = 0,
    nemesis_rounds: int = 10,
    writes=(),
    quorum_writes=(),
    per_cycle: int = 4,
    max_rounds: int = 512,
    replay: bool = True,
) -> dict:
    """Drive ``plan_ops`` (``[(round, kind, new_n), ...]``, kind in
    ``join | leave | down``; a fourth element, when given, is the target
    topology, else the staging's default ring) against a fresh runtime
    from ``build()``
    under ``schedule`` (or ``nemesis(preset, ...)`` compiled on the
    initial topology), interleaving ``writes`` (``[(round, row, var,
    op, actor)]`` direct client writes) and ``quorum_writes``
    (``[(round, var, op, actor, coordinator)]`` quorum puts), then
    assert the module-doc invariants. ``build_twin()`` (required for
    the bit-equality check; direct-writes workloads) constructs a fresh
    runtime at the FINAL membership. Returns the merged report."""
    from ..chaos.engine import ChaosRuntime
    from ..chaos.schedule import ChaosSchedule, nemesis
    from .coordinator import MembershipCoordinator

    plan_ops = sorted(plan_ops, key=lambda x: x[0])
    writes = sorted(writes, key=lambda x: x[0])
    quorum_writes = sorted(quorum_writes, key=lambda x: x[0])

    def one_run():
        rt = build()
        if schedule is not None:
            sched = schedule
        elif preset is not None:
            sched = nemesis(preset, rt.n_replicas, rt._host_neighbors,
                            seed=seed, rounds=nemesis_rounds)
        else:
            sched = ChaosSchedule(rt.n_replicas, rt._host_neighbors,
                                  events=())
        ch = ChaosRuntime(rt, sched)
        qr = None
        hints = None
        if quorum_writes:
            from ..quorum import HintLog, QuorumRuntime

            hints = HintLog()
            qr = QuorumRuntime(ch, timeout=4, retries=4, hints=hints)
        mc = MembershipCoordinator(ch, per_cycle=per_cycle, hints=hints)
        pend_plans = list(plan_ops)
        pend_writes = list(writes)
        pend_q = list(quorum_writes)
        rids = []
        #: the direct writes the run actually applied (a write whose
        #: target row happens to be crashed at its round is DROPPED,
        #: deterministically) — the twin must replay exactly these,
        #: or a crash coinciding with a write round would make the
        #: bit-equality check blame the handoff for a divergence the
        #: harness itself introduced
        applied = []
        while True:
            rnd = ch.round
            if rnd >= max_rounds:
                raise InvariantViolation(
                    f"membership harness did not settle within "
                    f"{max_rounds} rounds "
                    f"({'rebalancing' if mc.rebalancing else 'quiescing'})"
                )
            # one plan at a time (the console discipline): an op whose
            # round arrives while the previous plan still rebalances
            # defers to the first settled round — deterministically, so
            # the replay run stages at the same rounds
            while (pend_plans and pend_plans[0][0] <= rnd
                   and not mc.rebalancing):
                _r, kind, new_n, *nbrs = pend_plans.pop(0)
                getattr(mc, f"stage_{kind}")(new_n, *nbrs)
                mc.commit()
            while pend_writes and pend_writes[0][0] <= rnd:
                _r, row, var, op, actor = pend_writes.pop(0)
                if not ch.crashed[int(row)]:
                    rt.update_at(int(row), var, op, actor)
                    applied.append((int(row), var, op, actor))
            while pend_q and pend_q[0][0] <= rnd:
                _r, var, op, actor, coord = pend_q.pop(0)
                coord = int(coord) % rt.n_replicas
                rids.append(qr.submit_put(var, op, actor,
                                          coordinator=coord))
            if qr is not None:
                qr.step()
                mc.cycle()
            else:
                mc.step()
            done_inputs = not (pend_plans or pend_writes or pend_q)
            inflight = qr.inflight if qr is not None else 0
            if (
                done_inputs and not mc.rebalancing and not inflight
                and ch.round > ch.schedule.horizon
                and not ch.crashed.any()
            ):
                break
        rt.run_to_convergence(max_rounds=max_rounds)
        return rt, ch, mc, qr, rids, applied

    rt1, ch1, mc1, qr1, rids1, applied1 = one_run()
    report = {
        "rounds": ch1.round,
        "final_n": rt1.n_replicas,
        "epoch": rt1.membership_epoch,
        "membership": mc1.report(),
    }
    if qr1 is not None:
        statuses = [
            qr1.result(rid, raise_on_error=False)["status"]
            for rid in rids1
        ]
        leaked = [
            s for s in statuses
            if s not in ("done", "failed", "stale_epoch", "acked")
        ]
        if leaked:
            raise InvariantViolation(
                f"quorum requests leaked across the epoch change "
                f"unresolved: {leaked[:4]} — fencing must resolve every "
                "in-flight request as done/failed/stale_epoch"
            )
        check_no_write_lost(rt1, qr1.acked_terms)
        report.update({
            "puts": len(rids1),
            "acked_writes": sum(
                len(ts) for ts in qr1.acked_terms.values()
            ),
            "stale_epoch_failures": statuses.count("stale_epoch"),
            "no_write_lost": True,
        })
    if build_twin is not None:
        twin = build_twin()
        for row, var, op, actor in applied1:
            twin.update_at(row, var, op, actor)
        twin.run_to_convergence(max_rounds=max_rounds)
        if set(twin.var_ids) != set(rt1.var_ids):
            raise InvariantViolation(
                "twin variable census differs from the live run's"
            )
        if not states_equal(snapshot_states(rt1), snapshot_states(twin)):
            raise InvariantViolation(
                "settled population is NOT bit-identical to the "
                "static-membership twin: the staged handoff changed the "
                "destination, not just the journey"
            )
        report["bit_identical_to_twin"] = True
    if replay:
        rt2, _ch2, _mc2, qr2, _rids2, applied2 = one_run()
        if applied1 != applied2:
            raise InvariantViolation(
                "replay applied a different direct-write subset — the "
                "crash timeline must drop the same writes every run"
            )
        if fingerprint(snapshot_states(rt1)) != fingerprint(
            snapshot_states(rt2)
        ):
            raise InvariantViolation(
                "membership replay reached a different final state: the "
                "same (seed, schedule, plan ops, writes) must replay "
                "bit-identically"
            )
        if qr1 is not None and qr1.trace != qr2.trace:
            first = next(
                (i for i, (a, b) in enumerate(zip(qr1.trace, qr2.trace))
                 if a != b),
                min(len(qr1.trace), len(qr2.trace)),
            )
            raise InvariantViolation(
                f"quorum replay diverged at trace entry {first} under "
                "membership churn"
            )
        report["replay_identical"] = True
    return report
