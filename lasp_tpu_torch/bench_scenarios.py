"""Benchmark scenarios of the port (from ``lasp_tpu.bench_scenarios``):
``orset_anti_entropy``, the OR-Set anti-entropy headline that ``bench.py``
runs on the JAX side; the BASELINE configs ``gset_1k`` (G-Sets with union
and intersection edges), ``orset_100k`` and ``pipeline_1m`` (map -> filter
-> fold); ``adcounter_6``, the G-Counter ad counter through the engine;
``adcounter_10m``, the north star — the advertisement counter's union ->
product -> filter pipeline, G-Counter views and the server trigger over a
scale-free population, run to its fixed point by ``converge_on_device``;
``ingest_storm``, the grouped-ingest A/B; ``dataflow_chain``, the
per-edge against fused propagate A/B; ``chaos_heal``, recovery from a
composite nemesis against a fault-free twin; and ``quorum_kv``, quorum
puts and gets under every chaos preset; ``serve_load``, the open-loop
serving front-end under the composite nemesis; ``aae_scrub``, silent
corruption against the anti-entropy scrubber; and ``elastic_rebalance``,
staged membership grow and leave against the legacy resize."""

from __future__ import annotations

import time
import tracemalloc

import numpy as np
import torch

from .dataflow import Graph
from .device import resolve_device
from .lattice.base import replicate, tree_leaves, tree_map
from .mesh import ingest as ingest_mod
from .mesh.gossip import converged, diverged_rows
from .mesh.runtime import ReplicatedRuntime
from .mesh.topology import locality_order, random_regular, ring, scale_free
from .store import Store
from .telemetry.roofline import get_ledger
from .ops.fused import fused_gossip_rounds_count, gossip_rounds
from .ops.packed import PackedORSet, PackedORSetSpec


class _Clock:
    """Wall time of a region of device work: CUDA events on a CUDA device
    (the region ends with a synchronize), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def time(self, fn) -> float:
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0


def orset_anti_entropy(
    n_replicas: int,
    fanout: int = 3,
    block: int = 4,
    seed: int = 7,
    n_elems: int = 8,
    n_actors: int = 8,
    tokens_per_actor: int = 4,
    timing_reps: int = 3,
    device=None,
) -> dict:
    """OR-Set anti-entropy over random k-regular gossip on the packed codec
    — the headline workload, with the JAX scenario's seeding and its
    two-phase timing contract (``lasp_tpu/bench_scenarios.py:490-507``).

    Phase 1 (untimed) finds the exact rounds to convergence by stepping
    fused blocks that count their productive rounds. Phase 2 re-seeds and
    times exactly that many rounds, in blocks, with no equality
    reductions in the timed region; the result is the median of
    ``timing_reps`` warm replays (one more replay warms up and is
    discarded). ``bytes_moved`` models one round as reading the own row,
    ``fanout`` gathered rows and writing one row, over both planes:
    ``(fanout + 2) * R * row_bytes``. On CUDA every round runs through the
    kernel K1; on the CPU through its plain version."""
    dev = resolve_device(device)
    spec = PackedORSetSpec(
        n_elems=n_elems, n_actors=n_actors, tokens_per_actor=tokens_per_actor
    )

    def seed_states():
        states = replicate(PackedORSet.new(spec, device=dev), n_replicas)
        r = torch.arange(n_replicas, device=dev)
        return PackedORSet.add(spec, states, r % spec.n_elems, r % spec.n_actors)

    nbrs = torch.as_tensor(random_regular(n_replicas, fanout, seed=seed), device=dev)

    # phase 1 (untimed): exact rounds to convergence, one sync per block
    s = seed_states()
    diverged_at_seed = int(diverged_rows(PackedORSet, spec, s).sum())
    productive_per_block: list[int] = []
    rounds = 0
    while True:
        s, prod = fused_gossip_rounds_count(PackedORSet, spec, s, nbrs, block)
        prod = int(prod)
        productive_per_block.append(prod)
        rounds += prod
        if prod < block:
            break
    if not bool(converged(PackedORSet, spec, s)):
        raise RuntimeError("orset_anti_entropy: population did not converge")
    live = PackedORSet.value(spec, tree_map(lambda x: x[0], s))
    if not bool(live.all()):
        raise RuntimeError("orset_anti_entropy: an element failed to spread")
    conv_rounds = rounds
    del s, live

    # phase 2 (timed): exactly conv_rounds rounds, no residual work
    n_blocks, tail = divmod(conv_rounds, block)

    def replay(states):
        for _ in range(n_blocks):
            states = gossip_rounds(PackedORSet, spec, states, nbrs, block)
        if tail:
            states = gossip_rounds(PackedORSet, spec, states, nbrs, tail)
        return states

    clock = _Clock(dev)
    rep_secs: list[float] = []
    for rep in range(timing_reps + 1):
        states = seed_states()
        secs = clock.time(lambda: replay(states))
        del states
        if rep:  # rep 0 warms up
            rep_secs.append(secs)
    secs = float(np.median(rep_secs))

    bytes_per_replica = 2 * spec.n_elems * spec.n_words * 4  # both planes
    bytes_moved = (fanout + 2) * n_replicas * bytes_per_replica * conv_rounds
    return {
        "scenario": f"orset_{n_replicas}",
        "device": (
            torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        ),
        "gossip_impl": "cuda" if dev.type == "cuda" else "plain",
        "rounds": conv_rounds,
        "seconds": secs,
        "fanout": fanout,
        "n_elems": spec.n_elems,
        "n_tokens": spec.n_tokens,
        "state_bytes_per_replica": bytes_per_replica,
        "bytes_moved": bytes_moved,
        "merges_per_sec": n_replicas * fanout * conv_rounds / secs,
        "achieved_GBps": bytes_moved / secs / 1e9,
        "timing": {
            "policy": f"median of {timing_reps} warm replays "
                      "(1 warm-up discarded)",
            "seconds_each": rep_secs,
        },
        "convergence": {
            "rounds_to_quiescence": conv_rounds,
            "productive_rounds_per_block": productive_per_block,
            "block": block,
            "diverged_replicas_at_seed": diverged_at_seed,
        },
        "check": "converged+all-live",
    }


def _timed(device: torch.device, fn):
    """``(fn(), host seconds)``; on CUDA the window opens and closes on a
    synchronized device."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _engine_convergence_driver(rt):
    """Warm one round outside the clock (``converge_on_device`` with a
    one-round budget), then the timed remainder in one
    ``converge_on_device`` call. Returns ``(warm_rounds, run)``."""
    pre = rt.converge_on_device(max_rounds=1, strict=False)
    warm_rounds = abs(pre)

    def run():
        if pre > 0:
            return 0  # converged during the warm round (toy scales only)
        return rt.converge_on_device()

    return warm_rounds, run


def adcounter_6(device=None) -> dict:
    """6 replicas of the G-Counter ad counter through the engine (the
    ``lasp_adcounter_test`` shape: 5 ads x 6 clients x 100 views), client
    views landing as batched ops at the clients' home replicas."""
    dev = resolve_device(device)
    n, n_ads, views = 6, 5, 100
    store = Store(n_actors=n, device=dev)
    graph = Graph(store)
    ads = [
        store.declare(id=f"ad{a}", type="riak_dt_gcounter", n_actors=n)
        for a in range(n_ads)
    ]
    rt = ReplicatedRuntime(store, graph, n, ring(n, 2), device=dev)
    rng = np.random.RandomState(1)
    per_ad: dict = {a: [] for a in ads}
    for _ in range(views):
        ad, client = int(rng.randint(n_ads)), int(rng.randint(n))
        # client writes at its own replica under its own actor identity
        per_ad[ads[ad]].append((client, ("increment",), f"client{client}"))
    for var, ops in per_ad.items():
        if ops:
            rt.update_batch(var, ops)

    warm_rounds, run = _engine_convergence_driver(rt)
    rounds, secs = _timed(dev, run)
    totals = [int(rt.coverage_value(a)) for a in ads]
    if sum(totals) != views:
        raise RuntimeError(f"adcounter_6: views lost or duplicated: {totals}")
    if any(rt.divergence(a) for a in ads):
        raise RuntimeError("adcounter_6: a counter did not converge")
    return {
        "scenario": "adcounter_6",
        "rounds": warm_rounds + rounds,
        "seconds": round(secs, 4),
        "totals": totals,
        "engine": "Graph+ReplicatedRuntime",
        "check": "sum==views",
    }


#: the north star's shape: ads per publisher, contracts, view lanes
_AD_PUB, _AD_CONTRACTS, _AD_LANES = 5, 5, 8


def adcounter_topology(n_replicas: int) -> np.ndarray:
    """The north star's neighbour table: scale-free gossip (fanout 3, seed
    11), locality-ordered (an isomorphism: semantics unchanged)."""
    _, nbrs = locality_order(scale_free(n_replicas, 3, seed=11))
    return nbrs


def adcounter_setup(n_replicas: int, threshold: int, device=None):
    """The north star's population, written and with its server trigger
    registered, ready to converge (``adcounter_10m`` runs it; a profiler
    can run its convergence alone). Returns ``(runtime, view_ids,
    lanes_per_ad)``."""
    dev = resolve_device(device)
    n_pub, n_contracts, n_lanes = _AD_PUB, _AD_CONTRACTS, _AD_LANES
    n_ads = 2 * n_pub
    store = Store(n_actors=1, device=dev)
    graph = Graph(store)
    ads_a = store.declare(
        id="ads_a", type="lasp_orset", n_elems=n_pub, n_actors=1, tokens_per_actor=1
    )
    ads_b = store.declare(
        id="ads_b", type="lasp_orset", n_elems=n_pub, n_actors=1, tokens_per_actor=1
    )
    contracts = store.declare(
        id="contracts", type="lasp_orset", n_elems=n_contracts, n_actors=1,
        tokens_per_actor=1,
    )
    ads = graph.union(ads_a, ads_b, dst="ads")
    pairs = graph.product(ads, contracts, dst="pairs")
    # a contract covers the ads whose index hashes onto it
    graph.filter(
        pairs, lambda xy: int(xy[0][2:]) % n_contracts == int(xy[1][1:]), dst="active"
    )
    views = [
        store.declare(id=f"views_{a}", type="riak_dt_gcounter", n_actors=n_lanes)
        for a in range(n_ads)
    ]

    rt = ReplicatedRuntime(store, graph, n_replicas, adcounter_topology(n_replicas),
                           packed=True, device=dev)

    # publishers seed their ad sets at their server replicas
    rt.update_batch(ads_a, [(0, ("add_all", [f"ad{i}" for i in range(n_pub)]), "pub_a")])
    rt.update_batch(
        ads_b,
        [(1 % n_replicas, ("add_all", [f"ad{i + n_pub}" for i in range(n_pub)]), "pub_b")],
    )
    rt.update_batch(
        contracts,
        [(2 % n_replicas, ("add_all", [f"c{j}" for j in range(n_contracts)]), "srv")],
    )

    # client views: replica r views ad (r % n_ads) in lane (r // n_ads) %
    # n_lanes; ad a has L[a] = (a % n_lanes) + 1 active lanes, so its global
    # view total converges to L[a] (per-lane max-merge: one client, one
    # increment)
    lanes_per_ad = (np.arange(n_ads) % n_lanes) + 1
    r = np.arange(n_replicas)
    ad_of_r = r % n_ads
    lane_of_r = (r // n_ads) % n_lanes
    valid = lane_of_r < lanes_per_ad[ad_of_r]
    for a in range(n_ads):
        sel = valid & (ad_of_r == a)
        rt.seed_increments(views[a], r[sel], lane_of_r[sel])
    del r, ad_of_r, lane_of_r, valid

    # the server: a replica that observes an ad's view total at or over the
    # threshold removes the ad from its publisher's set; the tombstone then
    # flows through union -> product -> filter and gossips out. Written for
    # one replica (the runtime vmaps it): each publisher's mask is a gather
    # of the over-threshold flags through an element -> ad table, whose
    # last slot is a constant False for elements no ad maps to
    def make_server():
        a_idx = rt.intern_terms(ads_a, [f"ad{i}" for i in range(n_pub)])
        b_idx = rt.intern_terms(ads_b, [f"ad{i + n_pub}" for i in range(n_pub)])
        sides = []
        for vid, idx, sl in ((ads_a, a_idx, slice(0, n_pub)),
                             (ads_b, b_idx, slice(n_pub, n_ads))):
            table = np.full(n_pub, n_pub, dtype=np.int64)
            table[idx] = np.arange(n_pub)
            sides.append((vid, torch.as_tensor(table, device=dev), sl))
        never = torch.zeros((1,), dtype=torch.bool, device=dev)

        def server(dense):
            totals = torch.stack(
                [torch.sum(dense[v].counts, dtype=torch.int32) for v in views]
            )
            over = totals >= threshold
            out = {}
            for vid, table, sl in sides:
                st = dense[vid]
                mask = torch.cat([over[sl], never])[table]
                out[vid] = st._replace(
                    removed=st.removed | (st.exists & mask[:, None])
                )
            return out

        return server

    # declared touch set: the trigger reads the view counters and writes
    # the publishers' sets
    rt.register_trigger(builder=make_server, touches=[ads_a, ads_b, *views])
    return rt, views, lanes_per_ad


def adcounter_10m(n_replicas: int = 10 * (1 << 20), threshold: int = 5,
                  device=None) -> dict:
    """The north star: the OR-Set advertisement counter over scale-free
    gossip, end to end through the dataflow engine — two publishers' ad
    sets unioned, producted with contracts, filtered to matching pairs
    (``riak_test/lasp_advertisement_counter_test.erl:65-235``), per-ad
    G-Counter views, and the server's threshold-read -> remove loop as a
    reactive trigger. Replica states ride the flat bit-packed wire codec
    (``ReplicatedRuntime(packed=True)``); client views are seeded with
    ``seed_increments``. The final state must equal the single-store
    reference semantics: an ad is live iff its view count stayed under the
    threshold. One device holds the whole population (the JAX scenario
    shards it across the chips of a TPU host)."""
    dev = resolve_device(device)
    rt, views, lanes_per_ad = adcounter_setup(n_replicas, threshold, dev)
    warm_rounds, run = _engine_convergence_driver(rt)
    rounds, secs = _timed(dev, run)

    n_ads, n_contracts = 2 * _AD_PUB, _AD_CONTRACTS
    # reference semantics: ad a live iff total views L[a] < threshold
    ref_live = {f"ad{a}" for a in range(n_ads) if lanes_per_ad[a] < threshold}
    live = rt.coverage_value("ads")
    if live != ref_live:
        raise RuntimeError(f"adcounter: live ads {live} != {ref_live}")
    ref_active = {
        (f"ad{a}", f"c{a % n_contracts}")
        for a in range(n_ads)
        if lanes_per_ad[a] < threshold
    }
    active = rt.coverage_value("active")
    if active != ref_active:
        raise RuntimeError(f"adcounter: active pairs {active} != {ref_active}")
    totals = [int(rt.coverage_value(v)) for v in views]
    if totals != lanes_per_ad.tolist():
        raise RuntimeError(f"adcounter: view totals {totals} != {lanes_per_ad.tolist()}")
    if rt.divergence("ads") or rt.divergence("active"):
        raise RuntimeError("adcounter: ads or active did not converge")
    bytes_per_replica = sum(
        leaf.element_size() * leaf[0].numel()
        for state in rt.states.values()
        for leaf in state
    )
    return {
        "scenario": f"adcounter_{n_replicas}",
        "rounds": warm_rounds + rounds,
        "seconds": round(secs, 4),
        "driver": "converge_on_device(fused blocks of <= 8 rounds, one host "
                  "sync a block)",
        "ad_totals": totals,
        "live_ads": len(live),
        "active_pairs": len(active),
        "state_bytes_per_replica": bytes_per_replica,
        "engine": "Graph+ReplicatedRuntime(packed)+trigger",
        "sharding": None,
        "under_60s": secs < 60,
        "check": "live==(<threshold), active==matching-pairs",
    }


def gset_1k(device=None) -> dict:
    """BASELINE config 2: 1,024 replicas, two 64-element G-Sets with union
    and intersection edges, through the engine (the graph's sweep and a
    gossip round a step, converged by ``converge_on_device``), checked
    against the global reference values."""
    dev = resolve_device(device)
    n, e = 1024, 64
    store = Store(n_actors=4, device=dev)
    graph = Graph(store)
    left = store.declare(id="left", type="lasp_gset", n_elems=e)
    right = store.declare(id="right", type="lasp_gset", n_elems=e)
    graph.union(left, right, dst="u")
    graph.intersection(left, right, dst="i")
    rt = ReplicatedRuntime(store, graph, n, random_regular(n, 3, seed=3), device=dev)

    # population seed: random sparse element masks per replica, landed
    # directly on the replica axis
    rng = np.random.RandomState(2)
    lmask = rng.rand(n, e) < 0.05
    rmask = rng.rand(n, e) < 0.05
    for var, mask in ((left, lmask), (right, rmask)):
        # interned into each input's universe: the intersection edge pairs
        # the two interners term by term
        elems = rt.intern_terms(var, list(range(e)))
        idx = torch.as_tensor(elems, dtype=torch.int64, device=dev)
        rt.states[var].mask[:, idx] = torch.as_tensor(mask, device=dev)

    warm_rounds, run = _engine_convergence_driver(rt)
    rounds, secs = _timed(dev, run)
    gl = {int(i) for i in np.flatnonzero(lmask.any(axis=0))}
    gr = {int(i) for i in np.flatnonzero(rmask.any(axis=0))}
    u_val, i_val = rt.coverage_value("u"), rt.coverage_value("i")
    if u_val != (gl | gr):
        raise RuntimeError(f"gset_1k: union {sorted(u_val)} != reference")
    # the inputs gossip to their global unions, so the intersection
    # converges to the global intersection
    if i_val != (gl & gr):
        raise RuntimeError(f"gset_1k: intersection {sorted(i_val)} != reference")
    if rt.divergence("u") or rt.divergence("i"):
        raise RuntimeError("gset_1k: u or i did not converge")
    return {
        "scenario": "gset_1k",
        "rounds": warm_rounds + rounds,
        "seconds": round(secs, 4),
        "union_size": len(u_val),
        "intersection_size": len(i_val),
        "engine": "Graph+ReplicatedRuntime",
        "check": "matches-global-reference",
    }


def orset_100k(n_replicas: int = 100_000, device=None) -> dict:
    """BASELINE config 3: ``orset_anti_entropy`` at 100,000 replicas and its
    defaults."""
    return orset_anti_entropy(n_replicas, device=device)


def pipeline_1m(n_replicas: int = 1 << 20, device=None) -> dict:
    """BASELINE config 4: a 1,048,576-replica map -> filter -> fold pipeline
    through the engine: a G-Set source, ``Graph.map`` / ``filter`` /
    ``fold`` edges, swept and gossiped by ``ReplicatedRuntime`` to the
    global fixed point."""
    dev = resolve_device(device)
    e = 32
    store = Store(n_actors=4, device=dev)
    graph = Graph(store)
    src = store.declare(id="src", type="lasp_gset", n_elems=e)
    mapped = graph.map(src, lambda i: i // 2, dst="mapped", dst_elems=e)
    kept = graph.filter(mapped, lambda i: i % 2 == 0, dst="kept")
    graph.fold(kept, lambda i: [i, i + 100], dst="folded", dst_elems=2 * e + 100)

    rt = ReplicatedRuntime(
        store, graph, n_replicas, random_regular(n_replicas, 3, seed=5), device=dev
    )
    # population seed: replica r starts with element (r % e), interned on
    # the host once and scattered in one shot
    elems = rt.intern_terms(src, list(range(e)))
    r = np.arange(n_replicas)
    rt.states[src].mask[
        torch.as_tensor(r, device=dev),
        torch.as_tensor(elems[r % e], dtype=torch.int64, device=dev),
    ] = True
    del r
    warm_rounds, run = _engine_convergence_driver(rt)
    rounds, secs = _timed(dev, run)
    got = rt.coverage_value("folded")
    ref_kept = {i for i in {i // 2 for i in range(e)} if i % 2 == 0}
    ref_folded = {j for i in ref_kept for j in (i, i + 100)}
    if got != ref_folded:
        raise RuntimeError(f"pipeline: folded {sorted(got)} != {sorted(ref_folded)}")
    if rt.divergence("folded"):
        raise RuntimeError("pipeline: folded did not converge")
    return {
        "scenario": f"pipeline_{n_replicas}",
        "rounds": warm_rounds + rounds,
        "seconds": round(secs, 4),
        "folded_count": len(got),
        "engine": "Graph+ReplicatedRuntime",
        "check": "fold==reference",
    }


def _snapshot_runtime(rt):
    """States and frontier of a runtime, copied, for warm replays: restore
    from this and an identical schedule replays exactly."""
    return (
        {k: tree_map(torch.clone, st) for k, st in rt.states.items()},
        {k: m.copy() for k, m in rt._frontier.items()},
    )


def _restore_runtime(rt, snap) -> None:
    states, frontier = snap
    for k, st in states.items():
        rt.states[k] = tree_map(torch.clone, st)
    rt._frontier = {k: m.copy() for k, m in frontier.items()}


def _ingest_schedule(ids, kinds, n_replicas: int, cycles: int,
                     ops_per_cycle: int, seed: int) -> list:
    """The ingest_storm op schedule: ``cycles`` serving cycles of
    ``ops_per_cycle`` client ops each, Zipf-hot over variables, mixed
    verbs — adds/increments dominate, OR-Set/OR-SWOT removes target
    terms KNOWN live at their position (the precondition must hold so
    both arms replay the identical schedule), map field writes ride the
    per-var fallback. Pure function of the seed; returned as
    ``[{var: [(replica, op, actor), ...]}, ...]``."""
    rng = np.random.RandomState(seed)
    n_vars = len(ids)
    # Zipf-hot variable popularity (rank-1/r weights)
    w = 1.0 / np.arange(1, n_vars + 1)
    w /= w.sum()
    order = rng.permutation(n_vars)
    live: dict = {}  # (var, replica) -> [added-not-removed terms]
    mints: dict = {}  # (var, replica, term-slot) -> OR-Set adds issued
    schedule = []
    for _c in range(cycles):
        cycle: dict = {}
        vs = rng.choice(n_vars, size=ops_per_cycle, p=w)
        rows = rng.randint(0, n_replicas, size=ops_per_cycle)
        rolls = rng.rand(ops_per_cycle)
        for v_rank, r, roll in zip(vs, rows, rolls):
            v = int(order[v_rank])
            var, kind = ids[v], kinds[v % len(kinds)]
            r = int(r)
            actor = f"a{r % 4}"
            if kind == "riak_dt_gcounter":
                op = ("increment", 1 + int(roll * 3))
            elif kind == "riak_dt_map":
                op = (
                    ("update", "hits", ("increment",))
                    if roll < 0.5
                    else ("update", "tags", ("add", f"t{int(roll * 8)}"))
                )
            else:
                bag = live.setdefault((var, r), [])
                removable = kind in ("lasp_orset", "riak_dt_orswot")
                if removable and bag and roll < 0.15:
                    op = ("remove", bag.pop())
                else:
                    t0 = int(roll * 8)
                    if kind == "lasp_orset":
                        # OR-Set tokens never free: cap adds per (var,
                        # replica, term) at the actor pool width so the
                        # schedule can never exhaust a slot pool (both
                        # arms must replay it error-free)
                        t0 = next(
                            (t % 8 for t in range(t0, t0 + 8)
                             if mints.get((var, r, t % 8), 0) < 8),
                            None,
                        )
                        if t0 is None:
                            if bag:
                                op = ("remove", bag.pop())
                                cycle.setdefault(var, []).append(
                                    (r, op, actor)
                                )
                            continue
                        mints[(var, r, t0)] = mints.get((var, r, t0), 0) + 1
                    term = f"e{t0}"
                    op = ("add", term)
                    if removable and term not in bag:
                        bag.append(term)
            cycle.setdefault(var, []).append((r, op, actor))
        schedule.append(cycle)
    return schedule


#: ``ingest_storm``'s variable kinds, cycled, as in the JAX scenario
INGEST_KINDS = ("lasp_gset", "riak_dt_gcounter", "riak_dt_orswot", "lasp_orset",
                "riak_dt_map")


def ingest_storm_runtime(n_replicas: int, n_vars: int, plan: str = "auto",
                         packed: bool = False, fanout: int = 3, seed: int = 31,
                         device=None):
    """``ingest_storm``'s store over ``random_regular(n_replicas, fanout,
    seed)``: ``n_vars`` variables cycling :data:`INGEST_KINDS` at the JAX
    scenario's widths (the map: a ``tags`` G-Set of 8 elements and a
    ``hits`` G-Counter, 4 actors). Returns ``(runtime, ids)``."""
    dev = resolve_device(device)
    store = Store(n_actors=4, device=dev)
    caps = {
        "lasp_gset": {"n_elems": 16},
        "riak_dt_gcounter": {"n_actors": 4},
        "riak_dt_orswot": {"n_elems": 8, "n_actors": 4},
        "lasp_orset": {"n_elems": 8, "n_actors": 4, "tokens_per_actor": 8},
        "riak_dt_map": {
            "fields": [("tags", "lasp_gset", {"n_elems": 8}),
                       ("hits", "riak_dt_gcounter", {})],
            "n_actors": 4,
        },
    }
    ids = []
    for i in range(n_vars):
        kind = INGEST_KINDS[i % len(INGEST_KINDS)]
        ids.append(store.declare(id=f"v{i}", type=kind, **caps[kind]))
    rt = ReplicatedRuntime(
        store, Graph(store), n_replicas,
        random_regular(n_replicas, fanout, seed=seed), packed=packed, plan=plan,
        device=dev,
    )
    return rt, ids


def ingest_storm(
    n_replicas: int = 256,
    n_vars: int = 128,
    cycles: int = 6,
    ops_per_cycle: int = 2048,
    fanout: int = 3,
    seed: int = 31,
    reps: int = 3,
    gate: "float | None" = 3.0,
    device=None,
) -> dict:
    """The grouped-ingest A/B: a store of ``n_vars`` mixed-codec CRDTs
    (G-Set / G-Counter / OR-SWOT / OR-Set / map, cycled) absorbs
    ``cycles`` serving cycles of Zipf-hot client ops (adds, increments,
    live-targeted removes) under both ingest arms:

    - **per_var** (``plan="off"``): each variable's batch resolves and
      lands on its own;
    - **grouped** (``plan="auto"``): ops resolve into op tables and every
      same-signature variable lands in one group apply per dispatch-plan
      group per cycle (``mesh.ingest``); a map has no op table and takes
      the per-variable arm (``_map_batch``) in both.

    Both arms replay the identical schedule warm from snapshots (median of
    ``reps``, synchronized host clock). Asserted in the scenario: final
    states bit-identical across the arms, exactly one group apply per
    active plan group per cycle, and ``_normalize_ops`` returning its
    input list for 100,000 scalar ops with under 64 KiB allocated. With a
    ``gate`` the grouped arm must be at least that many times faster."""
    dev = resolve_device(device)
    probe_rt, probe_ids = ingest_storm_runtime(n_replicas, n_vars, fanout=fanout,
                                               seed=seed, device=dev)
    schedule = _ingest_schedule(
        probe_ids, INGEST_KINDS, n_replicas, cycles, ops_per_cycle, seed
    )
    # one group apply per active plan group per cycle (encodable variables
    # only: a map takes the per-variable arm)
    expected = sum(
        len({
            ingest_mod.group_key(probe_rt, v) for v in cycle
            if probe_rt.store.variable(v).type_name != "riak_dt_map"
        })
        for cycle in schedule
    )
    del probe_rt

    def drive(rt) -> None:
        for cycle in schedule:
            rt.ingest_cycle(cycle)

    results, finals = {}, {}
    dispatch_check = None
    for arm, plan in (("per_var", "off"), ("grouped", "auto")):
        rt, ids = ingest_storm_runtime(n_replicas, n_vars, plan=plan, fanout=fanout,
                                       seed=seed, device=dev)
        snap = _snapshot_runtime(rt)
        before = ingest_mod.GROUP_APPLIES
        _timed(dev, lambda: drive(rt))  # cold: first allocations, interning
        if plan == "auto":
            got = ingest_mod.GROUP_APPLIES - before
            dispatch_check = {"expected": expected, "got": got}
            if got != expected:
                raise RuntimeError(f"ingest_storm: group applies {dispatch_check}")
        rep_secs = []
        for _ in range(reps):
            _restore_runtime(rt, snap)
            _, secs = _timed(dev, lambda: drive(rt))
            rep_secs.append(secs)
        results[arm] = {
            "seconds": float(np.median(rep_secs)),
            "seconds_each": rep_secs,
            "noise_band": max(rep_secs) / max(min(rep_secs), 1e-9),
        }
        finals[arm] = {v: rt.states[v] for v in ids}
        del rt, snap
    for v, st in finals["per_var"].items():
        if not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(st), tree_leaves(finals["grouped"][v]))):
            raise RuntimeError(f"ingest_storm: arm states diverged on {v}")
    del finals

    # scalar-op normalize is copy-on-write: the input list comes back
    big = [(0, ("increment",), "a0")] * 100_000
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    out = ReplicatedRuntime._normalize_ops(big)
    alloc = tracemalloc.get_traced_memory()[0] - base
    tracemalloc.stop()
    if out is not big or alloc >= 65536:
        raise RuntimeError(f"ingest_storm: normalize allocated {alloc} B for scalar ops")

    pv_s = results["per_var"]["seconds"]
    gr_s = results["grouped"]["seconds"]
    speedup = pv_s / gr_s if gr_s > 0 else None
    if gate is not None and (speedup is None or speedup < gate):
        raise RuntimeError(f"grouped ingest speedup {speedup}x under the {gate}x gate")
    return {
        "scenario": f"ingest_storm_{n_vars}x{n_replicas}",
        "n_replicas": n_replicas,
        "n_vars": n_vars,
        "cycles": cycles,
        "ops_per_cycle": ops_per_cycle,
        "fanout": fanout,
        "kinds": list(INGEST_KINDS),
        "dispatches": dispatch_check,
        "impl_block_seconds": {"per_var": pv_s, "grouped": gr_s},
        "normalize_alloc_bytes": int(alloc),
        "timing": {
            "policy": f"median of {reps} warm snapshot replays per arm",
            "per_var": results["per_var"],
            "grouped": results["grouped"],
        },
        "ingest_impl": "grouped" if gr_s <= pv_s else "per_var",
        "ingest_speedup": speedup,
        "gate": gate,
        "engine": "ReplicatedRuntime.ingest_cycle (mesh.ingest op tables)",
        "check": "bit-identical final states across arms + one group apply "
                 "per active plan group per cycle",
    }


def _build_dataflow_chains(n_chains: int, depth: int, device=None):
    """The ``dataflow_chain`` graph (``lasp_tpu/bench_scenarios.py:1684``):
    ``n_chains`` parallel depth-``depth`` chains cycling G-Set ``map``,
    OR-Set ``filter`` and OR-SWOT ``bind_to``, plus a ``union`` cascade over
    the G-Set chain tails. Parallel same-kind chains put same-signature
    edges at every level, the shape the fused compiler stacks."""
    store = Store(n_actors=2, device=device)
    g = Graph(store)
    gset_tails = []
    for c in range(n_chains):
        kind = c % 3
        if kind == 0:
            cur = store.declare(id=f"g{c}_0", type="lasp_gset", n_elems=8)
            for d in range(depth):
                cur = g.map(
                    cur, (lambda k: (lambda x: x + k))(d + 1),
                    dst=f"g{c}_{d + 1}", dst_elems=8,
                )
            gset_tails.append(cur)
        elif kind == 1:
            cur = store.declare(
                id=f"s{c}_0", type="lasp_orset", n_elems=4, n_actors=2,
                tokens_per_actor=16,
            )
            for d in range(depth):
                cur = g.filter(cur, lambda t: True, dst=f"s{c}_{d + 1}")
        else:
            store.declare(id=f"o{c}_0", type="riak_dt_orswot", n_elems=4, n_actors=2)
            for d in range(depth):
                g.bind_to(f"o{c}_{d + 1}", f"o{c}_{d}")
    u = None
    for i in range(len(gset_tails) - 1):
        u = g.union(u or gset_tails[0], gset_tails[i + 1], dst=f"u{i}")
    return store, g


def dataflow_chain(n_chains: int = 9, depth: int = 8, reps: int = 3,
                   device=None) -> dict:
    """The fused propagate A/B (``lasp_tpu/bench_scenarios.py:1727``): one
    write wave (every chain head written once) propagated to its fixed
    point by ``Graph.propagate(mode="per_edge")`` and ``mode="fused"`` from
    identical snapshots. Each arm builds its entries in a cold pass outside
    the clock, then replays the same schedule ``reps`` times (states, dirty
    marks and edge-ran flags restored each time). Asserts the fusion
    contract: equal round counts and bit-identical final states.

    The JAX histogram clock has no counterpart here: each arm's seconds are
    the median of the replays' wall times (``_timed``: synchronized on
    CUDA), with the sweeps and host syncs of one propagate; the fused
    arm's ``plan`` gives its entry's groups, stacked edges and the bytes
    one sweep moves."""
    device = resolve_device(device)

    def seed(store):
        for c in range(n_chains):
            kind = c % 3
            if kind == 0:
                store.update(f"g{c}_0", ("add", c), "w")
            elif kind == 1:
                store.update(f"s{c}_0", ("add", f"e{c}"), "w")
            else:
                store.update(f"o{c}_0", ("add", f"x{c}"), "w")

    def snapshot(store, g):
        return (
            {v: tree_map(torch.clone, store.state(v)) for v in store.ids()},
            dict(store.dirty_seq), store.mutations, g._dirty_cursor,
        )

    def restore(store, g, snap):
        states, dirty_seq, mutations, cursor = snap
        for v, st in states.items():
            store.variable(v).state = tree_map(torch.clone, st)
        store.dirty_seq = dict(dirty_seq)
        store.mutations = mutations
        g._dirty_cursor = cursor
        # every edge owes its initial run again: the replay repeats the
        # cold pass's schedule and hits its built entries
        g._edge_ran = [False] * len(g.edges)
        g._clean_mark = None

    results: dict = {}
    finals: dict = {}
    n_edges = None
    plan_shape = None
    for arm in ("per_edge", "fused"):
        store, g = _build_dataflow_chains(n_chains, depth, device)
        n_edges = len(g.edges)
        seed(store)
        snap = snapshot(store, g)
        cold_rounds = g.propagate(mode=arm)  # builds outside the clock
        if arm == "fused":
            ents = [e for k, e in g._cache._entries.items() if k[0] == "fused"]
            plan_shape = {
                "groups": len(ents[0].groups),
                "edges_stacked": ents[0].n_stacked,
                "sweep_bytes": ents[0].sweep_bytes,
            }
        secs = []
        for _ in range(reps):
            restore(store, g, snap)
            r, wall = _timed(device, lambda: g.propagate(mode=arm))
            secs.append(wall)
            if r != cold_rounds:
                raise RuntimeError(f"dataflow_chain: {arm} replay took {r} rounds, "
                                   f"the cold pass {cold_rounds}")
        results[arm] = {
            "seconds": float(np.median(secs)),
            "seconds_each": secs,
            "rounds": cold_rounds,
            "sweeps": g.last_propagate["sweeps"],
            "host_syncs": g.last_propagate["host_syncs"],
        }
        finals[arm] = {
            v: [x.cpu().numpy() for x in tree_leaves(store.state(v))]
            for v in store.ids()
        }
        del store, g

    # the fusion contract at the bench shape
    if results["per_edge"]["rounds"] != results["fused"]["rounds"]:
        raise RuntimeError(f"dataflow_chain: rounds differ across arms: {results}")
    for v, leaves in finals["per_edge"].items():
        if not all(np.array_equal(a, b) for a, b in zip(leaves, finals["fused"][v])):
            raise RuntimeError(f"dataflow_chain: scheduler states diverged on {v}")
    pe_s = results["per_edge"]["seconds"]
    fu_s = results["fused"]["seconds"]
    return {
        "scenario": f"dataflow_chain_{n_edges}e",
        "n_edges": n_edges,
        "n_chains": n_chains,
        "depth": depth,
        "rounds": results["fused"]["rounds"],
        "plan": plan_shape,
        "impl_block_seconds": {"per_edge": pe_s, "fused": fu_s},
        "timing": {
            "policy": f"median of {reps} warm replays of the cold schedule "
                      "per arm, wall time of propagate",
            "per_edge": results["per_edge"],
            "fused": results["fused"],
        },
        "dataflow_impl": "fused" if fu_s <= pe_s else "per_edge",
        "fused_speedup": pe_s / fu_s if fu_s > 0 else None,
        "engine": "Graph.propagate(mode=per_edge|fused)",
        "check": "bit-identical states + round counts across schedulers",
        "device": str(device),
    }


def chaos_heal(
    n_replicas: int = 512,
    fanout: int = 3,
    seed: int = 17,
    fault_rounds: int = 10,
    block: int = 8,
    device=None,
) -> dict:
    """Chaos recovery benchmark (``lasp_tpu/bench_scenarios.py:2155``): a
    seeded G-Set population rides a COMPOSITE nemesis (a ring-cut partition
    overlapping a rolling crash/restore) with one degraded read and its
    read-repair each faulty round; the action-free windows run fused
    (stacked per-round masks, one host sync a window). Records rounds to
    heal after the last fault clears, the repair traffic and the soak's
    seconds beside the fault-free twin's. The healed states must be
    bit-identical to the fault-free twin's fixed point."""
    from .chaos import ChaosRuntime, ChaosSchedule, Crash, Partition, Restore
    from .chaos.invariants import snapshot_states, states_equal

    dev = resolve_device(device)
    nbrs = random_regular(n_replicas, fanout, seed=seed)

    def build():
        store = Store(n_actors=8, device=dev)
        v = store.declare(id="soak", type="lasp_gset", n_elems=128)
        rt = ReplicatedRuntime(store, Graph(store), n_replicas, nbrs, device=dev)
        rng = np.random.RandomState(seed)
        rows = rng.choice(n_replicas, size=max(4, n_replicas // 64),
                          replace=False)
        rt.update_batch(
            v,
            [(int(r), ("add", f"w{int(r) % 32}"), f"c{int(r)}")
             for r in rows],
        )
        return rt, v

    rt_free, v = build()
    free_rounds, free_secs = _timed(dev, lambda: rt_free.run_to_convergence(block=block))
    free_states = snapshot_states(rt_free)
    del rt_free

    rng = np.random.RandomState(seed + 1)
    victims = rng.choice(n_replicas, size=2, replace=False)
    down = max(2, fault_rounds // 2)
    events = [Partition(2, 2 + fault_rounds, 2)]
    for i, r in enumerate(victims):
        at = 3 + i * 2
        events.append(Crash(at, int(r)))
        events.append(Restore(at + down, int(r)))
    schedule = ChaosSchedule(n_replicas, nbrs, events, seed=seed)

    rt, v = build()
    chaos = ChaosRuntime(rt, schedule)
    report, secs = _timed(
        dev, lambda: chaos.soak(mode="dense", block=block, reads_per_round=1,
                                read_var=v)
    )
    if not states_equal(snapshot_states(rt), free_states):
        raise RuntimeError("chaos_heal: post-heal state differs from the "
                           "fault-free fixed point")
    stepped = report["rounds"] - chaos.fused_rounds
    return {
        "scenario": f"chaos_heal_{n_replicas}",
        "n_replicas": n_replicas,
        "fanout": fanout,
        "nemesis": "ring-cut + rolling-crash (composite)",
        "fault_rounds": fault_rounds,
        "rounds": report["rounds"],
        "rounds_to_heal": report["rounds_to_heal"],
        "healed": report["healed"],
        "crashes": report["crashes"],
        "restores": report["restores"],
        "degraded_reads": report["degraded_reads"],
        "repaired_rows": report["repaired_rows"],
        "repair_bytes": report["repair_bytes"],
        "seconds": secs,
        "fault_free_seconds": free_secs,
        "fault_free_rounds": free_rounds,
        "fused_windows": chaos.fused_windows,
        "fused_rounds": chaos.fused_rounds,
        "stepped_rounds": stepped,
        # one residual read a window and a stepped round (degraded reads
        # and their repairs read more)
        "residual_syncs": chaos.fused_windows + stepped,
        "engine": "ChaosRuntime(fused mask windows)+ReplicatedRuntime",
        "check": "post-heal state bit-identical to fault-free fixed point",
        "device": str(dev),
    }


def quorum_kv(
    n_replicas: int = 64,
    fanout: int = 3,
    seed: int = 23,
    client_rounds: int = 8,
    puts_per_round: int = 4,
    gets_per_round: int = 4,
    *,
    presets=None,
    engine: str = "batched",
    device=None,
) -> dict:
    """Dynamo-style KV serving under every chaos nemesis preset
    (``lasp_tpu/bench_scenarios.py:2252``): a quorum coordination batch
    (N=3, R=W=2, timeout 4, retries 4) drives an open put/get mix against
    the population while each preset tears the mesh apart. Records per
    preset the quorum p50/p99 latency in rounds (get and put), staleness
    against the acked writes (how many already-acked writes a completed
    read missed), the wire traffic, retries, failures and hint replays,
    plus the final state's and the protocol trace's fingerprints (so two
    engines can be held against each other). The no-acknowledged-write-lost
    invariant is ASSERTED per preset and every request resolves.
    ``presets`` (default every preset) and ``engine`` (``"batched"`` or
    ``"sequential"``) select the runs."""
    import hashlib

    from .chaos import PRESETS, ChaosRuntime, nemesis
    from .chaos.invariants import check_no_write_lost, fingerprint, snapshot_states
    from .quorum import QuorumRuntime

    dev = resolve_device(device)
    nbrs = random_regular(n_replicas, fanout, seed=seed)
    out: dict = {}
    for preset in (PRESETS if presets is None else presets):
        store = Store(n_actors=64, device=dev)
        kv = store.declare(id="kv", type="lasp_gset", n_elems=256)
        rt = ReplicatedRuntime(store, Graph(store), n_replicas, nbrs, device=dev)
        sched = nemesis(preset, n_replicas, nbrs, seed=seed, rounds=10)
        ch = ChaosRuntime(rt, sched)
        qr = QuorumRuntime(ch, timeout=4, retries=4, engine=engine)
        #: get rid -> terms acked BEFORE it was submitted
        target_at_submit: dict = {}
        rng = np.random.RandomState(seed)
        put_i = 0

        def tick(n_puts, n_gets):
            nonlocal put_i
            live = np.flatnonzero(~ch.crashed)
            for _ in range(n_puts):
                coord = int(live[rng.randint(live.size)])
                qr.submit_put(kv, ("add", f"k{put_i}"), f"c{put_i}",
                              coordinator=coord)
                put_i += 1
            acked_now = frozenset(qr.acked_terms.get(kv, ()))
            for _ in range(n_gets):
                coord = int(live[rng.randint(live.size)])
                rid = qr.submit_get(kv, coordinator=coord, degraded=True)
                target_at_submit[rid] = acked_now
            qr.step()

        def run():
            for _ in range(client_rounds):
                tick(puts_per_round, gets_per_round)
            while qr.inflight or ch.round <= sched.horizon:
                if ch.round >= 512:
                    raise RuntimeError(
                        f"quorum_kv[{preset}]: {qr.inflight} request(s) "
                        "unresolved after 512 rounds"
                    )
                tick(0, 0)
            return rt.run_to_convergence(max_rounds=512)

        converge_rounds, secs = _timed(dev, run)
        check_no_write_lost(rt, qr.acked_terms)
        staleness = []
        for rid, target in target_at_submit.items():
            res = qr.result(rid, raise_on_error=False)
            if res["status"] == "done" and res["value"] is not None:
                staleness.append(len(target - res["value"]))
        rep = qr.report()
        if rep["inflight"] or rep["completed"] + rep["failed"] != rep["requests"]:
            raise RuntimeError(f"quorum_kv[{preset}]: requests left unresolved: {rep}")
        out[preset] = {
            "rounds": ch.round,
            "seconds": secs,
            "requests": rep["requests"],
            "completed": rep["completed"],
            "failed": rep["failed"],
            "retries": rep["retries"],
            "get_p50_rounds": rep["get_p50_rounds"],
            "get_p99_rounds": rep["get_p99_rounds"],
            "put_p50_rounds": rep["put_p50_rounds"],
            "put_p99_rounds": rep["put_p99_rounds"],
            "staleness_mean": (
                round(float(np.mean(staleness)), 3) if staleness else None
            ),
            "staleness_max": int(np.max(staleness)) if staleness else None,
            "repair_wire_bytes": rep["wire_bytes"],
            "pushed_rows": rep["pushed_rows"],
            "repaired_rows": rep["repaired_rows"],
            "hint_replays": rep["hint_replays"],
            "no_write_lost": True,
            "acked_writes": sum(len(ts) for ts in qr.acked_terms.values()),
            "converge_rounds": converge_rounds,
            "fsm_seconds": qr.fsm_seconds,
            "state_fingerprint": fingerprint(snapshot_states(rt)),
            "trace_sha256": hashlib.sha256(repr(qr.trace).encode()).hexdigest(),
        }
    return {
        "scenario": f"quorum_kv_{n_replicas}",
        "n_replicas": n_replicas,
        "fanout": fanout,
        "n_r_w": [3, 2, 2],
        "presets": out,
        "engine": f"QuorumRuntime({engine})+ChaosRuntime",
        "check": "no acked write lost (hinted handoff) under every "
                 "preset; all requests resolved",
        "device": str(dev),
    }


def serve_load(
    n_replicas: int = 64,
    n_clients: int = 10_000,
    ticks: int = 40,
    arrivals_per_tick: int = 1200,
    burst_factor: int = 5,
    seed_watches: int = 10_000,
    parity_thresholds: int = 100_000,
    seed: int = 7,
    device=None,
) -> dict:
    """Open-loop serving benchmark (``lasp_tpu/bench_scenarios.py:2364``):
    ``n_clients`` simulated clients drive a Zipf-hot write + read + watch
    mix through ``ServeFrontend`` while gossip runs under the composite
    nemesis, with a mid-run ``burst_factor``x burst. Asserted in-scenario
    (``serve.harness.run_load``): no acked write lost after heal and
    convergence, vectorized-vs-per-watch threshold parity at
    ``parity_thresholds`` watches; sheds are typed."""
    from .serve.harness import run_load

    dev = resolve_device(device)
    report, secs = _timed(dev, lambda: run_load(
        n_replicas=n_replicas,
        n_clients=n_clients,
        ticks=ticks,
        arrivals_per_tick=arrivals_per_tick,
        chaos=True,
        burst_at=max(2, ticks // 2),
        burst_ticks=max(2, ticks // 8),
        burst_factor=burst_factor,
        seed_watches=seed_watches,
        parity_thresholds=parity_thresholds,
        seed=seed,
        device=dev,
    ))
    report.update({
        "scenario": f"serve_load_{n_replicas}",
        "seconds": secs,
        "engine": "ServeFrontend(coalescing+vectorized fan-out)"
                  "+ChaosRuntime",
        "check": "no acked write lost after heal; vectorized threshold "
                 f"fan-out parity at {parity_thresholds} watches; "
                 "typed sheds only (never silent drop)",
        "device": str(dev),
    })
    return report


def aae_scrub(
    n_replicas: int = 48,
    fanout: int = 3,
    rounds: int = 8,
    writers: int = 8,
    seed: int = 23,
    frontier_presets=(),
    device=None,
) -> dict:
    """Active anti-entropy benchmark (``lasp_tpu/bench_scenarios.py:2415``):
    silent corruption (the corruption presets, plus a CorruptRows overlay
    on every classic preset) against the hash-forest scrubber. Every
    preset's drill asserts ``check_corruption_detected_and_repaired``
    in-scenario (detected within the cadence, localized exactly, repaired,
    healed population bit-equal to a fault-free twin); records detection
    latency, repair bytes against a full-state resync, exchange work and
    the scrub seconds split into hash (device work included), exchange and
    repair; then times the incremental refresh of two hot rows against a
    full rehash of six 64-element G-Sets at ``max(n_replicas, 1024)`` rows,
    median of 3. The presets named
    in ``frontier_presets`` are drilled a second time with frontier
    rounds, under ``"<preset> (frontier)"``."""
    from .chaos import (
        CORRUPTION_PRESETS,
        PRESETS,
        ChaosSchedule,
        CorruptRows,
        Crash,
        Restore,
        nemesis,
    )
    from .chaos.invariants import run_aae_harness

    dev = resolve_device(device)
    nbrs = random_regular(n_replicas, fanout, seed=seed)

    def build():
        store = Store(n_actors=max(16, writers), device=dev)
        g = store.declare(id="g", type="lasp_gset", n_elems=64)
        o = store.declare(id="o", type="riak_dt_orswot", n_elems=32,
                          n_actors=16)
        rt = ReplicatedRuntime(store, Graph(store), n_replicas, nbrs, device=dev)
        rt.update_batch(
            g,
            [((w * n_replicas) // writers, ("add", f"item{w}"),
              f"writer{w}") for w in range(writers)],
        )
        rt.update_at(1, o, ("add", "x"), "a0")
        rt.update_at(3, o, ("add", "y"), "a1")
        return rt

    def with_corruption(preset: str):
        """The preset's schedule carrying corruption: the corruption
        presets natively, every classic preset through a CorruptRows
        overlay at action-free rounds."""
        base = nemesis(preset, n_replicas, nbrs, seed=seed, rounds=rounds)
        if preset in CORRUPTION_PRESETS:
            return base
        used = {ev.at for ev in base.events
                if isinstance(ev, (Crash, Restore))}
        free = ([r for r in range(2, base.horizon) if r not in used]
                or [base.horizon])[:2]
        overlay = [
            CorruptRows(free[0], kind="bitflip"),
        ] + ([CorruptRows(free[1], kind="rollback")]
             if len(free) > 1 else [])
        return ChaosSchedule(n_replicas, nbrs,
                             tuple(base.events) + tuple(overlay), seed=seed)

    presets: dict = {}
    drills = [(p, "dense") for p in PRESETS + CORRUPTION_PRESETS]
    drills += [(p, "frontier") for p in frontier_presets]
    for preset, mode in drills:
        sched = with_corruption(preset)
        report, secs = _timed(dev, lambda: run_aae_harness(
            build, sched, scrub_every=1, replay=False, mode=mode,
        ))
        if mode != "dense":
            preset = f"{preset} ({mode})"
        lat = report["detection_latency_rounds"]
        presets[preset] = {
            "injected": report["injected"],
            "detected": report["detected"],
            "detection_latency_rounds_max": max(lat, default=0),
            "repaired_overwrites": report["repaired_overwrites"],
            "repaired_joins": report["repaired_joins"],
            "repair_bytes": report["repair_bytes"],
            "full_resync_bytes": report["full_resync_bytes"],
            "repair_frac_of_resync": (
                report["repair_bytes"] / max(report["full_resync_bytes"], 1)
            ),
            "rows_hashed": report["rows_hashed"],
            "exchange_rounds": report["exchange_rounds"],
            "comparisons": report["comparisons"],
            "scrubs": report["scrubs"],
            "rounds": report["rounds"],
            "seconds": secs,
            "scrub_seconds": report["seconds"],
            "detected_and_repaired": report["detected_and_repaired"],
        }
        if max(lat, default=0) > 1:
            raise RuntimeError(f"{preset}: detection exceeded the scrub cadence")

    # incremental-vs-full rehash: the dirty-mask refresh of a FEW hot rows
    # against the whole forest's rehash (median of 3)
    rehash_replicas = max(int(n_replicas), 1024)
    forest, passes = rehash_drill(rehash_replicas, device=dev)
    passes["incremental"]()  # warm the subset gather outside the clock
    rehash = {}
    for arm, run in passes.items():
        runs = []
        for _ in range(3):
            h0 = forest.hash_seconds
            secs = _timed(dev, run)[1]
            runs.append((secs, forest.hash_seconds - h0))
        rehash[arm] = sorted(runs)[1]
    (inc_s, inc_hash), (full_s, full_hash) = rehash["incremental"], rehash["full"]
    return {
        "scenario": f"aae_scrub_{n_replicas}",
        "n_replicas": n_replicas,
        "fanout": fanout,
        "presets": presets,
        "rehash": {
            "n_replicas": rehash_replicas,
            "incremental_seconds": inc_s,
            "full_seconds": full_s,
            # the row hashes' share of each (device dispatches and the
            # host read of the hashes); the rest is host bookkeeping
            "incremental_hash_seconds": inc_hash,
            "full_hash_seconds": full_hash,
            "hot_rows": 2,
            "speedup": full_s / inc_s if inc_s > 0 else None,
        },
        "engine": "AAEScrubber(HashForest+exchange+quorum repair)"
                  "+ChaosRuntime",
        "check": "every injection detected within the scrub cadence, "
                 "localized exactly, repaired; healed population "
                 "bit-equal to the fault-free twin (asserted per preset)",
        "device": str(dev),
    }


def rehash_drill(n_replicas: int, hot_rows: int = 2, device=None) -> tuple:
    """The rehash comparison's forest: six 64-element G-Sets at
    ``n_replicas`` rows, committed once. Returns ``(forest, {"incremental":
    fn, "full": fn})``: each ``fn`` marks ``hot_rows`` rows (or every row)
    of every variable dirty and refreshes."""
    from .aae import HashForest

    dev = resolve_device(device)
    store = Store(n_actors=16, device=dev)
    for i in range(6):
        store.declare(id=f"g{i}", type="lasp_gset", n_elems=64)
    rt = ReplicatedRuntime(store, Graph(store), n_replicas,
                           ring(n_replicas, 2), device=dev)
    forest = HashForest(rt)
    forest.refresh()  # commit the baseline (and warm the hash)
    hot = [i * n_replicas // hot_rows for i in range(hot_rows)]

    def incremental_pass():
        for v in rt.var_ids:
            rt._aae_mark(v, hot)
        forest.refresh()

    def full_pass():
        for v in rt.var_ids:
            rt._aae_mark(v, None)
        forest.refresh()

    return forest, {"incremental": incremental_pass, "full": full_pass}


def elastic_rebalance(
    n_replicas: int = 64,
    grow_to: int = 96,
    seed: int = 31,
    waves_during: int = 6,
    waves_after: int = 5,
    per_cycle: int = 8,
    topology: str = "ring",
    device=None,
) -> dict:
    """Elastic membership under sustained serving
    (``lasp_tpu/bench_scenarios.py:2828``): grow ``n_replicas`` ->
    ``grow_to`` with the STAGED coordinator (seed transfers, row-scoped
    frontier, capped per-cycle work, serving interleaved), then leave back
    down, against the LEGACY ``resize`` baseline (blanket all-dirty
    resync). Asserted in-scenario: the two arms' grown populations are
    bit-identical, no cycle exceeds the cap, and the staged transfer wire
    stays at or below the bottom-restore full-resync wire (dense resync
    rounds x the runtime's per-round ``_traffic_estimate``).

    ``topology``: ``"ring"`` (JAX's ``ring(n, 2)``) or ``"random_regular"``
    (``random_regular(n, 3, seed)``): a ring's diameter is half the
    population, so a write reaches every row of a large ring only after
    that many rounds. ``staged_gossip_ledger_bytes`` is the kernel cost
    ledger's gossip bytes over the staged arm without waves, as JAX's."""
    from .membership import MembershipCoordinator
    from .bridge_state import to_numpy
    from .utils.metrics import Timer

    dev = resolve_device(device)
    if topology == "ring":
        def topo(n):
            return ring(n, 2)
    elif topology == "random_regular":
        def topo(n):
            return random_regular(n, 3, seed=seed)
    else:
        raise ValueError(f"unknown topology {topology!r}")
    nbrs_small = topo(n_replicas)
    nbrs_big = topo(grow_to)
    rng = np.random.RandomState(seed)
    # the deterministic serve mix: every wave writes 3 vars at rows that
    # exist in EVERY membership (< n_replicas); reads are 3-row quorum joins
    waves = []
    for i in range(waves_during + waves_after):
        rows = rng.choice(n_replicas, size=4, replace=False)
        waves.append([
            ("kv", [(int(r), ("add", f"k{i}_{j}"), f"c{int(r)}")
                    for j, r in enumerate(rows)]),
            ("tag", [(int(rows[0]), ("add", f"t{i}"), f"a{i % 16}")]),
            ("clk", [(int(rows[1]), ("add", f"e{i}"), f"b{i % 16}")]),
        ])
    read_rows = np.asarray([0, 1, 2], dtype=np.int64)

    def build():
        store = Store(n_actors=64, device=dev)
        store.declare(id="kv", type="lasp_gset", n_elems=256)
        store.declare(id="tag", type="lasp_orset", n_elems=64)
        store.declare(id="clk", type="riak_dt_orswot", n_elems=64)
        rt = ReplicatedRuntime(store, Graph(store), n_replicas, nbrs_small,
                               device=dev)
        rt.update_batch(
            "kv", [(r, ("add", f"seed{r % 8}"), f"s{r % 32}")
                   for r in range(0, n_replicas, 4)],
        )
        rt.run_to_convergence()
        return rt

    def gossip_bytes():
        # the ledger's gossip families (every family but the transfer
        # joins and the quorum control plane)
        return sum(
            r["bytes"] for r in get_ledger().snapshot()
            if r["family"] not in ("handoff_transfer", "quorum_step")
        )

    def run_arm(staged: bool, with_waves: bool = True):
        rt = build()
        led0 = gossip_bytes()
        mc = None
        if staged:
            mc = MembershipCoordinator(rt, per_cycle=per_cycle)
            mc.stage_join(grow_to, nbrs_big)
            mc.commit()
        else:
            rt.resize(grow_to, nbrs_big)
        during, after = [], []
        transfers_per_cycle: list = []
        pending_hw = 0
        n_waves = waves_during if with_waves else 0
        i = 0
        rounds = 0
        while True:
            if rounds >= 256:
                raise RuntimeError("elastic_rebalance: grow never settled")
            wave = waves[i] if i < n_waves else None
            with Timer() as t:
                if wave is not None:
                    for var, ops in wave:
                        rt.update_batch(var, ops)
                rt.quorum_value("kv", read_rows)
                if mc is not None:
                    out = mc.step(mode="frontier")
                    transfers_per_cycle.append(out["transfers"])
                    pending_hw = max(pending_hw, out["outstanding"])
                    residual = out["residual"]
                else:
                    residual = rt.frontier_step()
            during.append(t.elapsed)
            rounds += 1
            i += 1
            settled = mc is None or not mc.rebalancing
            if settled and i >= n_waves and residual == 0:
                break
        settle_rounds = (
            mc.settle_rounds[0] if mc and mc.settle_rounds else rounds
        )
        # after the transfer window: the same tick shape, no transfers
        for j in range(waves_during, waves_during + (
            waves_after if with_waves else 0
        )):
            with Timer() as t:
                for var, ops in waves[j]:
                    rt.update_batch(var, ops)
                rt.quorum_value("kv", read_rows)
                rt.frontier_step()
            after.append(t.elapsed)
        while rt.frontier_step() != 0:
            pass
        return {
            "rt": rt,
            "mc": mc,
            "during": during,
            "after": after,
            "gossip_bytes": int(gossip_bytes() - led0),
            "transfer_bytes": (
                int(mc.report()["transfer_bytes"]) if mc is not None else 0
            ),
            "transfer_seconds": (
                mc.transfer_seconds if mc is not None else None
            ),
            "transfers_per_cycle": transfers_per_cycle,
            "pending_high_water": pending_hw,
            "settle_rounds": int(settle_rounds),
            "rounds": rounds,
        }

    staged, staged_secs = _timed(dev, lambda: run_arm(True))
    baseline, base_secs = _timed(dev, lambda: run_arm(False))
    # the two arms reach the SAME grown fixed point, bit for bit
    for v in staged["rt"].var_ids:
        a = to_numpy(staged["rt"].states[v])
        b = to_numpy(baseline["rt"].states[v])
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError(
                "staged grow diverged from the legacy-resize fixed point"
            )
    del baseline
    # no stop-the-world: per-cycle transfer work is CAPPED
    if not all(t <= per_cycle for t in staged["transfers_per_cycle"]):
        raise RuntimeError("a transfer cycle exceeded the per-cycle cap")
    if staged["pending_high_water"] > grow_to - n_replicas:
        raise RuntimeError("pending transfers exceeded the joining rows")
    # the WIRE gate on the pure resync phase (no serve waves): TRANSFER
    # bytes against the bottom-restore full resync (dense resync rounds x
    # the runtime's per-round traffic estimate)
    resync_staged = run_arm(True, with_waves=False)
    del resync_staged["rt"], resync_staged["mc"]
    rt_base = build()
    rt_base.resize(grow_to, nbrs_big)
    base_rounds = 0
    while rt_base.step() != 0:
        base_rounds += 1
        if base_rounds >= 256:
            raise RuntimeError("baseline resync never quiesced")
    base_wire = int(base_rounds * rt_base._traffic_estimate())
    del rt_base
    staged_wire = resync_staged["transfer_bytes"]
    if staged_wire > base_wire:
        raise RuntimeError(
            f"staged transfer wire {staged_wire} exceeded the bottom-"
            f"restore full-resync baseline {base_wire} "
            f"({base_rounds} dense rounds)"
        )

    # shrink leg: staged leave back to n_replicas
    rt = staged["rt"]
    mc = staged["mc"]
    mc.stage_leave(n_replicas, nbrs_small)
    mc.commit()
    grow_transfer_seconds = mc.transfer_seconds
    leave_report, leave_secs = _timed(
        dev, lambda: mc.run_to_settled(mode="frontier")
    )
    if rt.n_replicas != n_replicas:
        raise RuntimeError("the staged leave did not drop the tail")

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q)) * 1e3 if xs else None

    return {
        "scenario": f"elastic_rebalance_{n_replicas}_{grow_to}",
        "n_replicas": n_replicas,
        "grow_to": grow_to,
        "per_cycle_cap": per_cycle,
        "topology": topology,
        "epoch": rt.membership_epoch,
        "grow": {
            "settle_rounds": staged["settle_rounds"],
            "rounds": staged["rounds"],
            "transfer_bytes": resync_staged["transfer_bytes"],
            "staged_gossip_ledger_bytes": resync_staged["gossip_bytes"],
            "full_resync_bytes": base_wire,
            "full_resync_rounds": base_rounds,
            "wire_vs_full_resync": base_wire / max(staged_wire, 1),
            "max_cycle_transfers": max(staged["transfers_per_cycle"] or [0]),
            "pending_high_water": staged["pending_high_water"],
            "transfer_seconds": resync_staged["transfer_seconds"],
            "seconds": staged_secs,
            "baseline_seconds": base_secs,
        },
        "leave": {
            "settle_rounds": (
                leave_report["settle_rounds"][-1]
                if leave_report["settle_rounds"] else None
            ),
            "transfer_bytes": leave_report["transfer_bytes"],
            "transfer_seconds": mc.transfer_seconds - grow_transfer_seconds,
            "seconds": leave_secs,
        },
        "serve_tick_ms": {
            # tick 0 follows the grow (new shapes everywhere): apart
            "first_tick_ms": pct(staged["during"][:1], 50),
            "during_p50": pct(staged["during"][1:], 50),
            "during_p99": pct(staged["during"][1:], 99),
            "after_p50": pct(staged["after"], 50),
            "after_p99": pct(staged["after"], 99),
        },
        "engine": "MembershipCoordinator(frontier)+HandoffEngine",
        "check": (
            "staged grow bit-identical to legacy resize; per-cycle "
            "transfers capped (no stop-the-world); staged transfer "
            "wire <= bottom-restore full-resync baseline"
        ),
        "device": str(dev),
    }


def riak_index_events(seed: int, n_events: int, n_keys: int,
                      index_names: int = 2, index_values: int = 8) -> list:
    """A Riak object-event stream made from ``seed`` with numpy:
    ``[((key, vclock, metadata, index_specs), reason), ...]``, 80% put, 10%
    delete, 10% handoff over ``n_keys`` keys, a vclock distinct per event,
    one or two ``("add", name, value)`` specs over ``index_names`` x
    ``index_values``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_events):
        key = f"key{int(rng.integers(n_keys))}"
        u = rng.random()
        reason = "put" if u < 0.8 else ("delete" if u < 0.9 else "handoff")
        specs = tuple(
            ("add", f"idx{int(rng.integers(index_names))}",
             f"v{int(rng.integers(index_values))}")
            for _ in range(int(rng.integers(1, 3)))
        )
        out.append(((key, ("vc", i), f"m{i}", specs), reason))
    return out


def riak_index_reference(events, keylist: str = "keylist") -> dict:
    """The plain reference of the 2i index programs over ``events``, a host
    dict model that never touches a runtime: ``{program name: keys}`` for
    the total index, every subset view it registered and the keylist. A put
    replaces a key's entries (a view keeps the key only when the put
    carries its spec), a delete removes them, a handoff re-indexes only a
    key the program holds no entry for; the total index registers one view
    per observed spec, which first sees the NEXT event."""
    from .programs.riak_index import BASE_NAME, view_name

    indexes: dict = {BASE_NAME: (None, set())}  # name -> (spec | None, keys)
    keys_seen: set = set()
    for (key, _vclock, _meta, specs), reason in events:
        keys_seen.add(key)
        adds = [(n, v) for op, n, v in specs if op == "add"]
        created = []
        for name, (spec, keys) in list(indexes.items()):
            if reason == "handoff" and key in keys:
                continue  # an indexed key keeps its entry
            keys.discard(key)
            if reason == "delete":
                continue
            if spec is None or spec in adds:
                keys.add(key)
            if spec is None:
                created += [s for s in adds if view_name(*s) not in indexes]
        for s in created:
            indexes.setdefault(view_name(*s), (s, set()))
    out = {name: keys for name, (_spec, keys) in indexes.items()}
    out[keylist] = keys_seen
    return out


def riak_index_2i(n_replicas: int = 64, n_events: int = 1024, n_keys: int = 48,
                  index_names: int = 2, index_values: int = 8, n_shards: int = 4,
                  seed: int = 29, device=None, keep_runtime: bool = False) -> dict:
    """Lasp's programs end to end: a total ``RiakIndexProgram`` with auto
    views (one 2i view per observed ``(name, value)`` spec) and an
    ``ExampleKeylistProgram`` registered over ``n_replicas`` replicas on
    ``random_regular(n, 3)``, every program at JAX's defaults (64 elements,
    64 tokens, one actor). Each event of :func:`riak_index_events` goes
    through ``process`` at row ``crc32(key) % n`` (a filled view compacts
    through ``CapacityError``, ``compact_orset`` and ``run_to_convergence``,
    as JAX's program does); the population converges under the runtime's
    normal scheduler (``run_to_convergence(mode="auto")``); then one
    ``ring_coverage_execute`` over ``n_shards`` shards answers every
    program. It must equal per-program ``execute``, a quorum execute over
    three rows and :func:`riak_index_reference`. With ``keep_runtime`` the
    runtime rides in the report under ``"runtime"``."""
    import zlib

    from .programs import ExampleKeylistProgram, RiakIndexProgram
    from .programs.riak_index import BASE_NAME
    from .quorum.coverage import ring_coverage_execute

    dev = resolve_device(device)
    store = Store(n_actors=16, device=dev)
    rt = ReplicatedRuntime(store, Graph(store), n_replicas,
                           random_regular(n_replicas, 3, seed=seed), device=dev)
    rt.register(BASE_NAME, RiakIndexProgram)
    rt.register("keylist", ExampleKeylistProgram)
    compactions = [0]
    inner = rt.compact_orset

    def counting(var_id):
        out = inner(var_id)
        compactions[0] += 1
        return out

    rt.compact_orset = counting
    events = riak_index_events(seed, n_events, n_keys, index_names, index_values)
    per_event = []
    t_all = time.perf_counter()
    for obj, reason in events:
        row = zlib.crc32(obj[0].encode()) % n_replicas
        t0 = time.perf_counter()
        rt.process(obj, reason, "idx", replica=row)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        per_event.append(time.perf_counter() - t0)
    process_s = time.perf_counter() - t_all
    rounds, converge_s = _timed(dev, lambda: rt.run_to_convergence(mode="auto"))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    swept, sweep_s = _timed(dev, lambda: ring_coverage_execute(rt, n_shards=n_shards))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    want = riak_index_reference(events)
    names = sorted(rt.programs)
    if sorted(want) != names:
        raise RuntimeError(f"riak_index_2i: programs {names} != reference {sorted(want)}")
    quorum_rows = np.random.default_rng(seed).choice(n_replicas, 3, replace=False)
    for name in names:
        got = swept[name]
        if got != rt.execute(name):
            raise RuntimeError(f"riak_index_2i: {name}: the sweep != execute")
        if got != rt.execute(name, replicas=quorum_rows.tolist()):
            raise RuntimeError(f"riak_index_2i: {name}: the sweep != quorum execute")
        if got != want[name]:
            raise RuntimeError(f"riak_index_2i: {name}: {sorted(got)} != "
                               f"reference {sorted(want[name])}")
    views = [n for n in names if n not in (BASE_NAME, "keylist")]
    row_bytes = {n: rt._row_bytes(rt.programs[n].id) for n in names}
    ms = np.asarray(per_event) * 1e3
    out = {
        "scenario": f"riak_index_2i_{n_replicas}",
        "n_replicas": n_replicas,
        "events": n_events,
        "keys": n_keys,
        "reasons": {r: sum(1 for _o, rr in events if rr == r)
                    for r in ("put", "delete", "handoff")},
        "programs": len(names),
        "views": len(views),
        "index_row_bytes": row_bytes[BASE_NAME],
        "resident_index_bytes": sum(row_bytes[n] for n in names
                                    if n != "keylist") * n_replicas,
        "events_per_s": n_events / process_s,
        "process_ms_p50": float(np.percentile(ms, 50)),
        "process_ms_p99": float(np.percentile(ms, 99)),
        "process_s": process_s,
        "compactions": compactions[0],
        "converge_rounds": rounds,
        "converge_s": converge_s,
        "sweep_s": sweep_s,
        "sweep_shards": n_shards,
        "sweep_peak_allocated_bytes": peak,
        "values": {n: len(swept[n]) for n in names},
        "check": "sweep == execute == quorum(3 rows) == host reference",
        "device": str(dev),
    }
    if keep_runtime:
        out["runtime"] = rt
    return out
