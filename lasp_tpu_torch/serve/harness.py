"""Open-loop load harness: simulated client fleets against the serving
front-end (port of ``lasp_tpu.serve.harness``; ``run_load`` also takes the
``device`` its store and runtime are built on, or a ``runtime`` that
:func:`load_runtime` built, such as one sharded across processes).

OPEN-LOOP means arrivals are independent of completions — the canonical
way to expose overload behavior (a closed loop self-throttles and hides
it). The harness drives :class:`~lasp_tpu.serve.ServeFrontend` on a
simulated tick clock, one serving cycle per tick:

- ``n_clients`` simulated clients issue a sustained write+read+watch
  mix; keys draw from a ZIPF distribution (hot-key skew, the realistic
  shape for "millions of users" traffic);
- a client whose request is SHED honors its ``retry_after_ms`` hint on
  the simulated clock (capped retries, give-ups counted);
- reads/watches carry deadlines — expired work must be CANCELLED, not
  executed;
- gossip runs concurrently (the front-end's fused windows), optionally
  under a COMPOSITE chaos nemesis (partition + flaky links + staggered
  crash/restores);
- an optional ``burst_factor`` multiplies arrivals for a window
  mid-run — the 5x overload burst the acceptance gate sheds through;
- after the run the population heals and converges, and the harness
  asserts the PR-9 NO-ACKED-WRITE-LOST invariant over the front-end's
  acked-terms witness set, plus vectorized-vs-per-watch THRESHOLD
  PARITY at ``parity_thresholds`` registered thresholds.

Latency is reported in TICKS (the simulated clock the deadline /
retry-after semantics run on); wall-clock cost rides separately in the
cycle timings. ``tools/load_harness.py`` is the CLI wrapper; the
``serve_load`` bench scenario embeds the same run in the artifact.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .admission import AdmissionController
from .engine import ServeFrontend
from . import requests as rq
from .subscriptions import SubscriptionTable

#: simulated milliseconds per tick (converts retry_after_ms to ticks)
MS_PER_TICK = 10.0


def composite_nemesis(n_replicas: int, neighbors, *, seed: int = 0,
                      rounds: int = 12):
    """Partition + flaky links, then STAGGERED crash/restores of
    NON-ADJACENT victims in link-clean rounds. The shape is chosen so
    the front-end's W=2 ack replication (write row + next reachable
    live row) provably covers it: at most one replica is down at a
    time, a crash never lands while links are failing (so every ack's
    backup was next-live-by-index), and the two victims are never an
    adjacent (primary, backup) pair — an acked write's two holder rows
    can therefore never both reseed from the bottom
    (docs/SERVING.md "Durability of acks")."""
    from ..chaos import ChaosSchedule, Crash, FlakyLinks, Partition, Restore

    if n_replicas < 5:
        # every victim pair on a <5 ring is adjacent (or there is no
        # non-victim backup left) — the durability precondition cannot
        # hold, and the non-adjacent redraw below could never terminate
        raise ValueError(
            f"composite nemesis needs n_replicas >= 5, got {n_replicas}"
        )
    rng = np.random.RandomState(seed)
    link_stop = 2 + max(2, rounds // 3)
    events = [
        Partition(2, link_stop, 2),
        FlakyLinks(1, link_stop, 0.15),
    ]
    while True:
        victims = sorted(int(v) for v in
                         rng.choice(n_replicas, size=2, replace=False))
        gap = (victims[1] - victims[0]) % n_replicas
        if gap not in (1, n_replicas - 1):
            break
    at = link_stop + 2  # >= 2 clean rounds after the link faults heal
    down = max(2, rounds // 4)
    for v in victims:
        events.append(Crash(at, v))
        events.append(Restore(at + down, v))
        at += down + 1  # staggered: restore lands before the next crash
    return ChaosSchedule(n_replicas, neighbors, events, seed=seed)


def _zipf_cdf(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return np.cumsum(w / w.sum())


def client_seed(run_seed: int, client: int) -> int:
    """Each simulated client's RNG seed as a pure function of
    ``(run seed, client id)`` — counter-based (the chaos ``_mix``
    discipline), so a client's behavior replays identically on any
    host regardless of which OTHER clients ran or in what order. This
    is what makes two same-seed harness runs produce identical
    offered/shed/outcome traces (asserted by tests/serve/test_load.py
    ``test_same_seed_runs_are_replay_identical``)."""
    from ..chaos.schedule import _mix

    u = _mix(
        np.asarray([client + 1], dtype=np.uint64),
        int(run_seed) * 1_000_003 + 0x5EED,
    )[0]
    return int(u * (1 << 31))


def threshold_parity(rt, var_id: str, n: int, *, seed: int = 0) -> dict:
    """Vectorized-vs-per-watch parity at ``n`` registered thresholds:
    two identically-registered subscription tables over the live
    population — one evaluated by the tensorized pass, one by the
    per-watch reference — must agree watch-for-watch. Returns the
    parity record; raises on divergence."""
    from ..lattice import Threshold

    var = rt.store.variable(var_id)
    rng = np.random.RandomState(seed)

    def pop_of(v):
        return rt._to_dense_row(v, rt._whole_population(v))

    def meta_of(v):
        return var.codec, var.spec

    current = int(pop_of(var_id).counts.to(torch.int64).sum(dim=-1).max())
    tables = (SubscriptionTable(), SubscriptionTable())
    for i in range(n):
        # half met (below the hottest row total), half unmet
        thr = (
            rng.randint(0, max(current, 1))
            if i % 2 == 0
            else current + 1 + rng.randint(1000)
        )
        strict = bool(i % 3 == 0)
        replica = int(rng.randint(rt.n_replicas))
        for t in tables:
            t.register(var_id, var.codec, var.spec,
                       Threshold(thr, strict), replica=replica,
                       payload=i)
    vec = {s for s, _p in tables[0].evaluate(pop_of, meta_of)}
    ref = {s for s, _p in tables[1].evaluate_pervar(
        pop_of, meta_of, claim=False
    )}
    if vec != ref:
        raise AssertionError(
            f"threshold parity violated at {n} watches: vectorized "
            f"fired {len(vec)}, per-watch fired {len(ref)}, symmetric "
            f"difference {len(vec ^ ref)}"
        )
    return {"n_thresholds": n, "fired": len(vec), "parity": True}


def load_runtime(n_replicas: int = 64, fanout: int = 3, n_vars: int = 6,
                 n_clients: int = 10_000, key_space: int = 192, seed: int = 7,
                 device=None):
    """:func:`run_load`'s population for the same arguments: ``n_vars``
    G-Sets ``kv<i>`` of ``key_space`` elements and a 1,024-lane G-Counter
    ``ctr`` on ``random_regular(n_replicas, fanout, seed)``."""
    from ..dataflow import Graph
    from ..mesh import ReplicatedRuntime
    from ..mesh.topology import random_regular
    from ..store import Store

    nbrs = random_regular(n_replicas, fanout, seed=seed)
    store = Store(n_actors=max(64, n_clients.bit_length() * 8), device=device)
    for i in range(n_vars):
        store.declare(id=f"kv{i}", type="lasp_gset", n_elems=key_space)
    store.declare(id="ctr", type="riak_dt_gcounter", n_actors=1024)
    return ReplicatedRuntime(store, Graph(store), n_replicas, nbrs,
                             device=device)


def run_load(
    n_replicas: int = 64,
    fanout: int = 3,
    n_vars: int = 6,
    n_clients: int = 10_000,
    ticks: int = 40,
    arrivals_per_tick: int = 1500,
    mix=(0.5, 0.3, 0.2),  # write, read, watch fractions
    zipf_s: float = 1.1,
    key_space: int = 192,
    seed: int = 7,
    chaos: bool = False,
    burst_at: Optional[int] = None,
    burst_ticks: int = 6,
    burst_factor: int = 5,
    deadline_ticks: int = 30,
    max_client_retries: int = 4,
    capacity: "dict | None" = None,
    gossip_block: int = 4,
    parity_thresholds: int = 0,
    seed_watches: int = 0,
    record_trace: bool = False,
    device=None,
    runtime=None,
) -> dict:
    """One full open-loop run; see the module doc. Returns the load
    report (the ``serve_load`` artifact body). ``runtime``: the population
    :func:`load_runtime` builds for the same arguments, built by the caller
    (one sharded across processes, whose every process runs this same
    drive); None builds it here on ``device``."""
    from ..chaos import ChaosRuntime
    from ..chaos.invariants import check_no_write_lost
    from ..lattice import Threshold

    rng = np.random.RandomState(seed)
    rt = runtime if runtime is not None else load_runtime(
        n_replicas, fanout, n_vars, n_clients, key_space, seed, device)
    nbrs = rt._host_neighbors
    gset_vars = [f"kv{i}" for i in range(n_vars)]
    ctr = "ctr"
    target = rt
    schedule = None
    if chaos:
        schedule = composite_nemesis(n_replicas, nbrs, seed=seed,
                                     rounds=max(8, ticks // 3))
        target = ChaosRuntime(rt, schedule)

    tick = 0
    fe = ServeFrontend(
        target,
        admission=AdmissionController(capacity=capacity),
        gossip_block=gossip_block,
        clock=lambda: float(tick),
    )
    # the whole harness runs on the simulated tick clock — the
    # admission drain-rate EWMA must too, or retry_after hints (and so
    # the clients' retry schedule) would ride wall-clock jitter and
    # break same-seed replay determinism
    fe.admission_cycle_seconds = MS_PER_TICK / 1000.0

    var_cdf = _zipf_cdf(n_vars, zipf_s)
    key_cdf = _zipf_cdf(key_space, zipf_s)
    #: simulated retry queue: [(due_tick, kind, submit_args, attempts)]
    retry_q: list = []
    gave_up = 0
    client_retries = 0
    max_inflight = 0
    burst_window = (
        range(burst_at, burst_at + burst_ticks)
        if burst_at is not None else range(0)
    )

    # a standing watch population (clients holding long-lived
    # subscriptions — the ~concurrent-clients floor)
    for i in range(seed_watches):
        fe.submit_watch(
            ctr, Threshold(int(1 + rng.randint(1, 1_000_000))),
            replica=int(rng.randint(n_replicas)),
            deadline=float(ticks + 3),
        )

    def _submit(kind, args, attempts=0):
        nonlocal gave_up, client_retries
        if kind == rq.WRITE:
            t = fe.submit_write(*args[0], **args[1])
        elif kind == rq.READ:
            t = fe.submit_read(*args[0], **args[1])
        else:
            t = fe.submit_watch(*args[0], **args[1])
        if t.status == "shed":
            if attempts >= max_client_retries:
                gave_up += 1
            else:
                client_retries += 1
                due = tick + max(1, int(round(
                    t.retry_after_ms / MS_PER_TICK
                )))
                retry_q.append((due, kind, args, attempts + 1))
        return t

    #: per-client RNGs, lazily seeded from (run seed, client id): a
    #: client's request stream is ITS OWN pure function of the run seed
    #: (never of global draw order) — the replay-determinism contract
    client_rngs: dict = {}

    def _crng(c: int) -> np.random.RandomState:
        r = client_rngs.get(c)
        if r is None:
            r = client_rngs[c] = np.random.RandomState(
                client_seed(seed, c)
            )
        return r

    def _mk_request(c: int):
        crng = _crng(c)
        r = float(crng.random_sample())
        replica = int(crng.randint(n_replicas))
        deadline = float(tick + deadline_ticks)
        if r < mix[0]:
            v = gset_vars[int(np.searchsorted(var_cdf, crng.random_sample()))]
            if crng.random_sample() < 0.15:
                # one counter actor per target replica: gcounter lanes
                # are writer identities, and a lane minted at two rows
                # would max-merge away increments (the actor-discipline
                # rule, mesh/runtime.py update_at)
                return (rq.WRITE, ((ctr, ("increment",), f"a{replica}"),
                                   {"replica": replica}))
            key = int(np.searchsorted(key_cdf, crng.random_sample()))
            return (rq.WRITE, ((v, ("add", f"k{key}"), f"c{c}"),
                               {"replica": replica}))
        if r < mix[0] + mix[1]:
            v = gset_vars[int(np.searchsorted(var_cdf, crng.random_sample()))]
            prio = (
                rq.PRIO_LOW if crng.random_sample() < 0.5
                else rq.PRIO_NORMAL
            )
            return (rq.READ, ((v,), {"replica": replica,
                                     "deadline": deadline,
                                     "priority": prio}))
        # watch: a counter threshold slightly ahead of the current
        # acked total — fires as the workload advances
        ahead = int(crng.randint(1, 50))
        base = fe.completed[rq.WRITE] // 8
        return (rq.WATCH, ((ctr, Threshold(base + ahead)),
                           {"replica": replica, "deadline": deadline}))

    depth_curve = []
    trace: list = []
    for tick in range(ticks):
        factor = burst_factor if tick in burst_window else 1
        # due retries first (they were promised capacity "later")
        due = [e for e in retry_q if e[0] <= tick]
        retry_q = [e for e in retry_q if e[0] > tick]
        for _due, kind, args, attempts in due:
            _submit(kind, args, attempts)
        for i in range(arrivals_per_tick * factor):
            kind, args = _mk_request(int(rng.randint(n_clients)))
            _submit(kind, args)
        fe.cycle()
        offered = sum(fe.offered.values())
        terminal = (
            sum(fe.completed.values()) + sum(fe.errors.values())
            + sum(fe.expired.values()) + sum(fe.sheds.values())
        )
        max_inflight = max(max_inflight, offered - terminal)
        depth_curve.append(sum(fe.admission.depths().values()))
        if record_trace:
            # the replay-determinism witness: the full per-tick
            # offered/shed/outcome accounting (two same-seed runs must
            # produce EQUAL traces — tests/serve/test_load.py)
            trace.append({
                "tick": tick,
                "offered": dict(fe.offered),
                "completed": dict(fe.completed),
                "errors": dict(fe.errors),
                "expired": dict(fe.expired),
                "shed": {
                    f"{k}:{r}": n
                    for (k, r), n in sorted(fe.sheds.items())
                },
                "retries": client_retries,
                "gave_up": gave_up,
            })
    tick = ticks
    # drain the backlog, heal, converge — then the invariant gate
    fe.drain(max_cycles=512)
    if chaos:
        while target.round <= schedule.horizon or target.crashed.any():
            target.step(mode="dense")
            if target.round > 4096:
                raise RuntimeError("chaos timeline failed to heal")
    rt.run_to_convergence(max_rounds=2048, block=8)
    check_no_write_lost(rt, fe.acked_terms)

    parity = None
    if parity_thresholds:
        parity = threshold_parity(rt, ctr, parity_thresholds,
                                  seed=seed + 1)

    rep = fe.report()
    offered = sum(rep["offered"].values())
    admitted = sum(rep["admitted"].values())
    completed = sum(rep["completed"].values())
    report = {
        "config": {
            "n_replicas": n_replicas, "n_vars": n_vars,
            "n_clients": n_clients, "ticks": ticks,
            "arrivals_per_tick": arrivals_per_tick,
            "mix": list(mix), "zipf_s": zipf_s,
            "chaos": bool(chaos), "burst_at": burst_at,
            "burst_factor": burst_factor if burst_at is not None else 1,
            "deadline_ticks": deadline_ticks,
            "gossip_block": gossip_block,
        },
        "offered": rep["offered"],
        "admitted": rep["admitted"],
        "completed": rep["completed"],
        "errors": rep["errors"],
        "expired": rep["expired"],
        "shed": rep["shed"],
        "rates": {
            "offered_per_tick": round(offered / max(ticks, 1), 2),
            "admitted_per_tick": round(admitted / max(ticks, 1), 2),
            "completed_per_tick": round(completed / max(ticks, 1), 2),
            "admit_frac": round(admitted / max(offered, 1), 4),
            "complete_frac": round(completed / max(admitted, 1), 4),
        },
        "latency_ticks": rep["latency"],
        "queue_high_water": rep["admission"]["high_water"],
        "queue_depth_final": rep["admission"]["depths"],
        "queue_depth_max_total": int(max(depth_curve, default=0)),
        "ladder": {
            "max_level": max(
                (lv for _c, _o, lv, _p in rep["admission"]["transitions"]),
                default=0,
            ),
            "transitions": rep["admission"]["transitions"],
        },
        "client_retries": client_retries,
        "client_gave_up": gave_up,
        "max_inflight": int(max_inflight),
        "watch_fires": rep["watch_fires"],
        "watch_parked_final": rep["watch_parked"],
        "overlap_seconds": rep["overlap_seconds"],
        "gossip_rounds": rep["gossip_rounds"],
        "cycles": rep["cycles"],
        # the grouped-ingest rate line: how many client ops landed
        # through the plan-grouped arm and in how many device
        # dispatches (mesh.ingest — one per codec group per cycle)
        "ingest": {
            "grouped_ops": rep["ingest_grouped_ops"],
            "dispatches": rep["ingest_dispatches"],
            "ops_per_dispatch": round(
                rep["ingest_grouped_ops"]
                / max(rep["ingest_dispatches"], 1), 2
            ),
            "dispatches_per_cycle": round(
                rep["ingest_dispatches"] / max(rep["cycles"], 1), 3
            ),
        },
        "acked_writes": sum(len(ts) for ts in fe.acked_terms.values()),
        "no_write_lost": True,
        "threshold_parity": parity,
        "trace": trace if record_trace else None,
    }
    if chaos:
        report["chaos"] = {
            "horizon": schedule.horizon,
            "crashes": target.crashes,
            "restores": target.restores,
            "healed": not bool(target.crashed.any()),
        }
    return report
