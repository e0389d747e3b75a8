"""Convergence-under-failure invariants — the harness the acceptance
criteria run (port of ``lasp_tpu.chaos.invariants``).

Three properties must hold under EVERY schedule:

1. **per-replica monotone inflation** — every live replica row only
   moves UP the lattice, round over round (``merge(prev, new) == new``),
   crash-restore reseeds (``ChaosRuntime.last_restored``) excepted;
2. **post-heal convergence to the fault-free fixed point** — after the
   schedule's horizon, the population quiesces to a state BIT-IDENTICAL
   to a twin run that never saw a fault;
3. **replay determinism** — the same ``(seed, schedule)`` replays to
   identical per-round state fingerprints.

Snapshots are host numpy trees in the JAX package's dtypes and leaf order
(packed words as ``uint32``), so a fingerprint here equals the JAX
package's for the same states. With an AAE scrubber attached,
:func:`run_aae_harness` asserts :func:`check_corruption_detected_and_repaired`
over a corruption-carrying timeline.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..bridge_state import to_numpy
from ..lattice.base import tree_leaves, tree_map, tree_unflatten
from .engine import ChaosRuntime


class InvariantViolation(AssertionError):
    """A chaos invariant failed; the message names the property, the
    variable, and the offending rows/round."""


def snapshot_states(rt) -> dict:
    """Host copies of every variable's population state (numpy leaves in
    the JAX package's dtypes; never views of live CPU tensors): the whole
    population on every process of a runtime sharded across them."""
    return {v: tree_map(np.array, to_numpy(rt._whole_population(v)))
            for v in rt.var_ids}


def states_equal(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    for v in a:
        la, lb = tree_leaves(a[v]), tree_leaves(b[v])
        if len(la) != len(lb) or not all(
            np.array_equal(x, y) for x, y in zip(la, lb)
        ):
            return False
    return True


def fingerprint(states: dict) -> str:
    """Order-stable content hash of a population snapshot — the replay
    determinism unit (two runs match iff every leaf matches bit-wise);
    the JAX package's hash of the same states."""
    h = hashlib.sha256()
    for v in sorted(states, key=str):
        h.update(repr(v).encode())
        for leaf in tree_leaves(states[v]):
            arr = np.asarray(leaf)
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def _live(rt, pop, snap):
    """A host snapshot back as a population on the runtime's device, in the
    dtypes of ``pop``."""
    return tree_unflatten(pop, [
        rt._row_leaf(h, x) for h, x in zip(tree_leaves(snap), tree_leaves(pop))
    ])


def check_inflation(rt, prev: dict, exempt_rows=()) -> None:
    """Assert every replica row inflated (``merge(prev, new) == new``)
    since the ``prev`` snapshot, for every variable — rows in
    ``exempt_rows`` (a restore's reseed) excepted. Raises
    :class:`InvariantViolation`."""
    exempt = np.zeros(rt.n_replicas, dtype=bool)
    if len(exempt_rows):
        exempt[np.asarray(list(exempt_rows), dtype=np.int64)] = True
    for v in rt.var_ids:
        codec, spec = rt._mesh_meta(v)
        new = rt._whole_population(v)
        old = _live(rt, new, prev[v])
        ok = codec.equal(spec, codec.merge(spec, old, new), new).cpu().numpy()
        bad = np.flatnonzero(~ok & ~exempt)
        if bad.size:
            raise InvariantViolation(
                f"monotone-inflation violated for {v!r} at replica rows "
                f"{bad[:8].tolist()}: a round moved state DOWN the "
                "lattice outside a crash-restore reseed"
            )


def check_no_resurrection(rt, var_id: str, removed_terms) -> None:
    """Assert no removed element came back: the population's coverage
    value must be disjoint from ``removed_terms``."""
    value = rt.coverage_value(var_id)
    back = set(removed_terms) & set(value)
    if back:
        raise InvariantViolation(
            f"resurrection in {var_id!r}: removed element(s) "
            f"{sorted(map(repr, back))[:4]} reappeared after "
            "crash/restore"
        )


def check_no_write_lost(rt, acked_terms) -> None:
    """Assert no acknowledged write was lost: every term a client was
    told is durable (``acked_terms``: ``{var_id: terms}`` — the
    ``QuorumRuntime.acked_terms`` witness set) must appear in the
    variable's coverage value (the hinted-handoff contract)."""
    for v, terms in acked_terms.items():
        value = rt.coverage_value(v)
        lost = set(terms) - set(value)
        if lost:
            raise InvariantViolation(
                f"acknowledged write(s) lost in {v!r}: "
                f"{sorted(map(repr, lost))[:4]} were acked at the client "
                "quorum but are absent from the coverage value after "
                "heal — hinted handoff failed its contract"
            )


def run_quorum_harness(build, schedule, *, writes, reads=(),
                       n: int = 3, r: int = 2, w: int = 2,
                       timeout: int = 4, retries: int = 2,
                       engine: str = "batched", mode: str = "dense",
                       hints_path: "str | None" = None,
                       max_rounds: int = 512, replay: bool = True) -> dict:
    """The quorum-coordination invariant suite: drive a put/get workload
    through a fault timeline and assert NO ACKNOWLEDGED WRITE IS LOST.

    ``build()`` constructs a fresh, identically-seeded
    ``ReplicatedRuntime``. ``writes`` is a list of ``(round, var_id, op,
    actor, coordinator)`` — each put is submitted just before that round
    executes; ``reads`` likewise ``(round, var_id, coordinator)`` degraded
    gets. The harness drains past the schedule horizon, converges, then
    checks every fault healed and every put resolved,
    :func:`check_no_write_lost`, and with ``replay=True`` an identical
    protocol trace and final fingerprint on a second run. Returns the
    merged report."""
    from ..quorum import HintLog, QuorumRuntime

    def one_run():
        rt = build()
        ch = ChaosRuntime(rt, schedule)
        hints = HintLog(hints_path)
        # every run starts from an EMPTY log: the replay run must not
        # inherit the first run's records
        hints.prune()
        qr = QuorumRuntime(ch, n=n, r=r, w=w, timeout=timeout,
                           retries=retries, engine=engine, hints=hints,
                           mode=mode)
        pending = sorted(writes, key=lambda x: (x[0],))
        pending_reads = sorted(reads, key=lambda x: (x[0],))
        rids = []
        while (qr.inflight or pending or pending_reads
               or ch.round <= schedule.horizon):
            if ch.round >= max_rounds:
                raise InvariantViolation(
                    f"quorum harness did not drain within {max_rounds} "
                    f"rounds ({qr.inflight} in flight)"
                )
            while pending and pending[0][0] <= ch.round:
                _rnd, var, op, actor, coord = pending.pop(0)
                rids.append(qr.submit_put(var, op, actor, coord))
            while pending_reads and pending_reads[0][0] <= ch.round:
                _rnd, var, coord = pending_reads.pop(0)
                qr.submit_get(var, coord, degraded=True)
            qr.step()
        # post-drain anti-entropy to the fixed point (no faults remain)
        rt.run_to_convergence(max_rounds=max_rounds)
        return rt, ch, qr, rids

    rt, ch, qr, rids = one_run()
    if ch.crashed.any():
        raise InvariantViolation(
            "quorum harness ended with replicas still down — the "
            "schedule must heal within its horizon"
        )
    unresolved = [
        rid for rid in rids
        if qr.result(rid, raise_on_error=False)["status"]
        not in ("done", "failed")
    ]
    if unresolved:
        raise InvariantViolation(
            f"puts {unresolved[:4]} never resolved (done/failed) after "
            "the drain — the FSM leaked an in-flight request"
        )
    check_no_write_lost(rt, qr.acked_terms)
    report = qr.report()
    report.update({
        "acked_terms": {
            str(v): len(ts) for v, ts in qr.acked_terms.items()
        },
        "rounds": ch.round,
        "healed": True,
        "no_write_lost": True,
    })
    if replay:
        rt2, _ch2, qr2, _ = one_run()
        if qr.trace != qr2.trace:
            first = next(
                (i for i, (a, b) in enumerate(zip(qr.trace, qr2.trace))
                 if a != b),
                min(len(qr.trace), len(qr2.trace)),
            )
            raise InvariantViolation(
                f"quorum replay diverged at trace entry {first}: the "
                "same (seed, schedule, submits) must replay to an "
                "identical protocol trace"
            )
        if fingerprint(snapshot_states(rt)) != fingerprint(
            snapshot_states(rt2)
        ):
            raise InvariantViolation(
                "quorum replay reached a different final state"
            )
        report["replay_identical"] = True
    return report


def check_corruption_detected_and_repaired(rt, chaos, scrubber,
                                           free_states: dict,
                                           detect_within: int = 1) -> dict:
    """The active-anti-entropy invariant (docs/RESILIENCE.md "Active
    anti-entropy"): judged over a FINISHED corruption soak,

    1. **detected** — every injected corruption (the engine's
       ``injected_corruptions`` ground truth) has a detection in the
       scrubber's ledger within ``detect_within`` rounds of injection;
    2. **localized exactly** — every detection names an injected
       (var, row): zero false positives (a detector that cried wolf on
       healthy rows would make repair itself the corruption vector);
    3. **repaired** — no repair left pending, and every detected
       (var, row) has an incident record (the quorum overwrite ran);
    4. **bit-equal** — the healed population equals the fault-free
       twin's fixed point, leaf for leaf.

    Returns the per-injection detection latencies (rounds)."""
    injected = chaos.injected_corruptions
    detected = scrubber.detected
    latencies = []
    for rec in injected:
        hits = [
            d for d in detected
            if d["var"] == rec["var"] and d["row"] == rec["row"]
            and rec["round"] <= d["round"]
            <= rec["round"] + detect_within
        ]
        if not hits:
            raise InvariantViolation(
                f"corruption UNDETECTED: {rec['kind']} at "
                f"({rec['var']!r}, row {rec['row']}) round "
                f"{rec['round']} has no detection within "
                f"{detect_within} round(s) — if the scrub cadence is "
                "wider than 1, a legit change to the row between "
                "scrubs commits (launders) the corruption into the "
                "hash baseline; see docs/RESILIENCE.md 'Active "
                "anti-entropy'"
            )
        latencies.append(
            min(d["round"] for d in hits) - rec["round"]
        )
    injected_keys = {(r["var"], r["row"]) for r in injected}
    for d in detected:
        if (d["var"], d["row"]) in injected_keys:
            continue
        if (
            d["source"] == "join_fixed_point"
            and (d["var"], d.get("pair")) in injected_keys
        ):
            # a still-diverging-after-join PAIR flags both endpoints
            # (which one is broken is unknowable from hashes alone);
            # localization is exact at pair granularity when the
            # partner row was the injected one
            continue
        raise InvariantViolation(
            f"corruption detector FALSE POSITIVE: flagged "
            f"({d['var']!r}, row {d['row']}) at round "
            f"{d['round']} ({d['source']}) but nothing was "
            "injected there — localization must be exact"
        )
    if scrubber.pending:
        raise InvariantViolation(
            f"corruption repair left pending: {sorted(scrubber.pending)}"
        )
    incident_keys = {(i["var"], i["row"]) for i in scrubber.incidents}
    missing = {(d["var"], d["row"]) for d in detected} - incident_keys
    if missing:
        raise InvariantViolation(
            f"detections never repaired (no incident record): "
            f"{sorted(missing)[:4]}"
        )
    if not states_equal(snapshot_states(rt), free_states):
        raise InvariantViolation(
            "post-repair fixed point differs from the fault-free "
            "twin's: a corruption survived detection/repair (or the "
            "repair destroyed state only the corrupt row held — see "
            "the fault-model note on sole-copy writes)"
        )
    return {"detection_latency_rounds": latencies}


def run_aae_harness(build, schedule, *, scrub_every: int = 1,
                    detect_within: "int | None" = None,
                    seg_size: int = 8, quorum: int = 3,
                    mode: str = "dense", max_rounds: int = 512,
                    replay: bool = True) -> dict:
    """The corruption-drill harness: drive a workload through a
    corruption-carrying fault timeline with an
    :class:`~lasp_tpu_torch.aae.AAEScrubber` attached, then assert
    :func:`check_corruption_detected_and_repaired` (detection within
    ``detect_within`` rounds — default the scrub cadence — exact
    localization, full repair, twin bit-equality) and, with
    ``replay=True``, that a second identical run reproduces the
    detection ledger and final fingerprint bit-for-bit.

    ``build()`` is the usual fresh-identically-seeded-runtime builder
    (the ``run_harness`` contract). Returns the merged report:
    detection latencies, repair traffic vs a full-state resync, hash
    work by mode, incident count."""
    from ..aae import AAEScrubber

    if scrub_every > 1 and mode != "frontier":
        # dense stepping marks EVERY row dirty each active round (the
        # conservative degrade), so any between-scrub gossip commits a
        # corrupt row's hash as the new baseline — laundered before the
        # next verify could see it. The detection-within-cadence
        # guarantee this harness asserts therefore only exists at
        # cadence 1 under dense stepping; frontier's exact dirty
        # tracking extends it to rows untouched between scrubs
        # (docs/RESILIENCE.md "Active anti-entropy").
        raise ValueError(
            f"scrub_every={scrub_every} with mode={mode!r} cannot "
            "uphold the detection guarantee (dense all-dirty marks "
            "launder corruption between scrubs) — use scrub_every=1, "
            "or mode='frontier' for wider cadences"
        )
    if detect_within is None:
        detect_within = int(scrub_every)
    rt_free = build()
    free_rounds = rt_free.run_to_convergence(max_rounds=max_rounds)
    free_states = snapshot_states(rt_free)
    del rt_free

    def one_run():
        rt = build()
        ch = ChaosRuntime(rt, schedule)
        sc = AAEScrubber(ch, scrub_every=scrub_every,
                         seg_size=seg_size, quorum=quorum)
        while ch.round < max_rounds:
            residual = ch.step(mode=mode)
            if (
                residual == 0
                and ch.round > schedule.horizon
                and not sc.pending
            ):
                break
        else:
            raise InvariantViolation(
                f"AAE soak did not quiesce within {max_rounds} rounds "
                f"({len(sc.pending)} repairs pending)"
            )
        # closing scrub: verify the final population (a corruption
        # landing on the very last faulted round must still be caught)
        sc.scrub(ch.round)
        rt.run_to_convergence(max_rounds=max_rounds)
        return rt, ch, sc

    rt1, ch1, sc1 = one_run()
    checked = check_corruption_detected_and_repaired(
        rt1, ch1, sc1, free_states, detect_within=detect_within
    )
    report = sc1.report()
    report.update(checked)
    report.update({
        "injected": len(ch1.injected_corruptions),
        "injected_by_kind": {
            k: sum(1 for r in ch1.injected_corruptions
                   if r["kind"] == k)
            for k in {r["kind"] for r in ch1.injected_corruptions}
        },
        "rounds": ch1.round,
        "fault_free_rounds": free_rounds,
        "healed": not bool(ch1.crashed.any()),
        "bit_identical_to_fault_free": True,
        "detected_and_repaired": True,
        # the port's addition: the first run's scrub seconds by part
        "seconds": sc1.seconds(),
    })
    if replay:
        rt2, ch2, sc2 = one_run()
        if sc1.detected != sc2.detected or (
            ch1.injected_corruptions != ch2.injected_corruptions
        ):
            raise InvariantViolation(
                "AAE replay diverged: the same (seed, schedule) must "
                "reproduce the injection and detection ledgers exactly"
            )
        if fingerprint(snapshot_states(rt1)) != fingerprint(
            snapshot_states(rt2)
        ):
            raise InvariantViolation(
                "AAE replay reached a different final state"
            )
        report["replay_identical"] = True
    return report


def run_harness(build, schedule, mode: str = "dense",
                max_rounds: int = 512, replay: bool = True,
                removed_terms: "dict | None" = None,
                checkpoint: "str | None" = None) -> dict:
    """Execute the full invariant suite for one workload × schedule ×
    scheduler mode: a FAULT-FREE twin to its fixed point, the CHAOS run
    (monotone inflation every round, the healed fixed point bit-equal to
    the twin's), with ``replay=True`` a second chaos run with per-round
    fingerprint equality, and with ``removed_terms`` the direct
    no-resurrection assertion. Every round snapshots the whole population
    to the host: a test-size device, not a full-size one (``soak`` is).
    Returns a report dict; raises :class:`InvariantViolation` on any
    failure."""
    rt_free = build()
    free_rounds = rt_free.run_to_convergence(
        max_rounds=max_rounds, mode=mode if mode == "frontier" else "dense"
    )
    free_states = snapshot_states(rt_free)
    del rt_free

    def chaos_run():
        rt = build()
        ch = ChaosRuntime(rt, schedule, checkpoint=checkpoint)
        prev = snapshot_states(rt)
        fps = []
        while ch.round < max_rounds:
            residual = ch.step(mode=mode)
            check_inflation(rt, prev, exempt_rows=ch.last_restored)
            prev = snapshot_states(rt)
            fps.append(fingerprint(prev))
            if residual == 0 and ch.round > schedule.horizon:
                break
        else:
            raise InvariantViolation(
                f"chaos run did not quiesce within {max_rounds} rounds "
                f"(mode={mode!r})"
            )
        return rt, ch, fps

    rt1, ch1, fps1 = chaos_run()
    if not states_equal(snapshot_states(rt1), free_states):
        raise InvariantViolation(
            "post-heal fixed point differs from the fault-free run's "
            f"(mode={mode!r}): chaos changed the destination, not just "
            "the journey"
        )
    if removed_terms:
        for v, terms in removed_terms.items():
            check_no_resurrection(rt1, v, terms)
    from ..telemetry.convergence import get_monitor

    report = {
        "mode": mode,
        "fault_free_rounds": free_rounds,
        "chaos_rounds": ch1.round,
        "rounds_to_heal": max(0, ch1.round - schedule.horizon),
        "healed": not bool(ch1.crashed.any()),
        "crashes": ch1.crashes,
        "restores": ch1.restores,
        "final_fingerprint": fps1[-1],
        "bit_identical_to_fault_free": True,
    }
    if replay:
        _rt2, _ch2, fps2 = chaos_run()
        if fps1 != fps2:
            first = next(
                (i for i, (a, b) in enumerate(zip(fps1, fps2)) if a != b),
                min(len(fps1), len(fps2)),
            )
            raise InvariantViolation(
                f"replay diverged at round {first} (mode={mode!r}): the "
                "same (seed, schedule) must replay to identical "
                "per-round states"
            )
        report["replay_identical"] = True
    get_monitor().observe_chaos(
        rounds_to_heal=report["rounds_to_heal"], healed=report["healed"],
        crashes=report["crashes"], restores=report["restores"],
        invariants_ok=True,
    )
    return report
