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
corruption against the anti-entropy scrubber; ``elastic_rebalance``,
staged membership grow and leave against the legacy resize; and the
sharded pair, ``partitioned_gossip`` (the boundary exchange's wire against
the population plane) and ``mesh_scale`` (the partitioned frontier path
and the hierarchical converge)."""

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


def _shard_mesh(dev: torch.device, n_shards: int):
    """The sharded scenarios' flat mesh of ``n_shards`` slots: of the
    device, or, when a process group is joined, every process's
    ``n_shards / P`` slots of its own device (as JAX's run over
    ``jax.devices()``). Returns ``(mesh, first, count)``: the mesh and this
    process's run of shards."""
    from .mesh import comm

    world = comm.process_count()
    if world == 1:
        return comm.Mesh([dev] * n_shards, ("replicas",)), 0, n_shards
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not split over {world} processes")
    mesh = comm.Mesh(comm.global_slots(n_shards // world, device=dev), ("replicas",))
    first, count = comm.local_shards(mesh, "replicas")
    return mesh, first, count


def _block_hashes(states, first: int, count: int, block: int) -> dict:
    """``{shard: sha256 hex}`` of each of this process's shards' rows of a
    population (every leaf's bytes, in leaf order): a process group's run
    and the one-process run hash the same blocks the same."""
    import hashlib

    from .lattice.base import tree_leaves

    out = {}
    for sl in range(count):
        h = hashlib.sha256()
        for x in tree_leaves(states):
            h.update(x[sl * block:(sl + 1) * block].cpu().contiguous().numpy().tobytes())
        out[first + sl] = h.hexdigest()
    return out


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

    ``impl_block_seconds`` carries each arm's round-loop seconds, JAX's
    clock: the engine's ``dataflow_propagate_seconds`` over the replay (the
    arm-identical refresh and ingest host work left out; wall time where
    telemetry is off). ``timing`` keeps beside it the median wall time of a
    whole propagate (``_timed``: synchronized on CUDA), with the sweeps and
    host syncs of one propagate; the fused arm's ``plan`` gives its
    entry's groups, stacked edges and the bytes one sweep moves."""
    from .telemetry import get_registry

    device = resolve_device(device)

    def hist_sum() -> float:
        fam = get_registry().snapshot().get("dataflow_propagate_seconds")
        if not fam:
            return 0.0
        return sum(x["sum"] for x in fam["series"])

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
        loop_secs, wall_secs = [], []
        for _ in range(reps):
            restore(store, g, snap)
            h0 = hist_sum()
            r, wall = _timed(device, lambda: g.propagate(mode=arm))
            loop = hist_sum() - h0
            loop_secs.append(loop if loop > 0.0 else wall)
            wall_secs.append(wall)
            if r != cold_rounds:
                raise RuntimeError(f"dataflow_chain: {arm} replay took {r} rounds, "
                                   f"the cold pass {cold_rounds}")
        results[arm] = {
            "roundloop_seconds": float(np.median(loop_secs)),
            "propagate_seconds": float(np.median(wall_secs)),
            "seconds_each": loop_secs,
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
    pe_s = results["per_edge"]["roundloop_seconds"]
    fu_s = results["fused"]["roundloop_seconds"]
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
                      "per arm; roundloop = the engine's "
                      "dataflow_propagate_seconds clock (excludes the "
                      "arm-identical refresh/ingest host work), propagate "
                      "= wall time of the whole call",
            "per_edge": results["per_edge"],
            "fused": results["fused"],
        },
        "dataflow_impl": "fused" if fu_s <= pe_s else "per_edge",
        "fused_speedup": pe_s / fu_s if fu_s > 0 else None,
        "engine": "Graph.propagate(mode=per_edge|fused)",
        "check": "bit-identical states + round counts across schedulers",
        "device": str(device),
    }


def chaos_heal_schedule(nbrs, seed: int = 17, fault_rounds: int = 10):
    """:func:`chaos_heal`'s composite nemesis on the topology ``nbrs``: a
    ring-cut partition of ``fault_rounds`` rounds from round 2, overlapping
    a rolling crash / restore of two seeded victims."""
    from .chaos import ChaosSchedule, Crash, Partition, Restore

    n_replicas = int(nbrs.shape[0])
    rng = np.random.RandomState(seed + 1)
    victims = rng.choice(n_replicas, size=2, replace=False)
    down = max(2, fault_rounds // 2)
    events = [Partition(2, 2 + fault_rounds, 2)]
    for i, r in enumerate(victims):
        at = 3 + i * 2
        events.append(Crash(at, int(r)))
        events.append(Restore(at + down, int(r)))
    return ChaosSchedule(n_replicas, nbrs, events, seed=seed)


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
    from .chaos import ChaosRuntime
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

    schedule = chaos_heal_schedule(nbrs, seed, fault_rounds)
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


def quorum_kv_runtime(nbrs, device=None):
    """:func:`quorum_kv`'s population on the topology ``nbrs``: one
    256-element G-Set ``kv``, 64 actors."""
    store = Store(n_actors=64, device=device)
    store.declare(id="kv", type="lasp_gset", n_elems=256)
    return ReplicatedRuntime(store, Graph(store), int(nbrs.shape[0]), nbrs,
                             device=device)


def quorum_kv_preset(
    rt,
    preset: str,
    seed: int = 23,
    client_rounds: int = 8,
    puts_per_round: int = 4,
    gets_per_round: int = 4,
    engine: str = "batched",
) -> dict:
    """One preset of :func:`quorum_kv` on a runtime :func:`quorum_kv_runtime`
    built (also one sharded across processes, where every process runs this
    same drive): the preset's record."""
    import hashlib

    from .chaos import ChaosRuntime, nemesis
    from .chaos.invariants import check_no_write_lost, fingerprint, snapshot_states
    from .quorum import QuorumRuntime

    kv, n_replicas = "kv", rt.n_replicas
    sched = nemesis(preset, n_replicas, rt._host_neighbors, seed=seed, rounds=10)
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

    converge_rounds, secs = _timed(rt.device, run)
    check_no_write_lost(rt, qr.acked_terms)
    staleness = []
    for rid, target in target_at_submit.items():
        res = qr.result(rid, raise_on_error=False)
        if res["status"] == "done" and res["value"] is not None:
            staleness.append(len(target - res["value"]))
    rep = qr.report()
    if rep["inflight"] or rep["completed"] + rep["failed"] != rep["requests"]:
        raise RuntimeError(f"quorum_kv[{preset}]: requests left unresolved: {rep}")
    return {
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
    ``"sequential"``) select the runs; each preset runs
    :func:`quorum_kv_preset` on a fresh :func:`quorum_kv_runtime`."""
    from .chaos import PRESETS

    dev = resolve_device(device)
    nbrs = random_regular(n_replicas, fanout, seed=seed)
    out = {
        preset: quorum_kv_preset(
            quorum_kv_runtime(nbrs, dev), preset, seed=seed,
            client_rounds=client_rounds, puts_per_round=puts_per_round,
            gets_per_round=gets_per_round, engine=engine,
        )
        for preset in (PRESETS if presets is None else presets)
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
                  seed: int = 29, device=None, keep_runtime: bool = False,
                  shard=None) -> dict:
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
    runtime rides in the report under ``"runtime"``. ``shard``: a function
    applied to the runtime once its programs are registered (``lambda rt:
    rt.shard(mesh)`` shards it across a process group)."""
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
    if shard is not None:
        shard(rt)
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


# -- the roofline workload, the engine A/Bs and the bridge's throughput ------


def _arm_roofline(arms: dict) -> dict:
    """Per-arm achieved GB/s and roofline fraction of an A/B scenario
    (``lasp_tpu/bench_scenarios.py:32``): ``arms`` maps arm name ->
    (ledger-attributed bytes, measured seconds). The denominator is the
    capability row's peak, None off the card (no CPU number stands in for
    a device metric); an arm whose byte delta is zero (telemetry disabled)
    reports nulls rather than a fake 0 GB/s."""
    from .telemetry.capability import device_capability

    peak = device_capability()["peak_GBps"]
    out = {}
    for arm, (bytes_moved, secs) in arms.items():
        if bytes_moved and secs > 0:
            g = bytes_moved / secs / 1e9
            out[arm] = {
                "achieved_GBps": round(g, 3),
                "roofline_frac": round(g / peak, 4) if peak else None,
            }
        else:
            out[arm] = {"achieved_GBps": None, "roofline_frac": None}
    return out


def roofline_entry(bytes_moved: int, secs: float,
                   peak: "float | None") -> dict:
    """Achieved GB/s and HBM roofline fraction for one timed region — the
    single formatting rule for per-arm entries
    (``lasp_tpu/bench_scenarios.py:58``). Three significant figures, not
    fixed decimals: a small probe's rate must stay visibly non-null, never
    round to 0.0."""
    gbps = bytes_moved / secs / 1e9 if secs > 0 else None
    return {
        "achieved_GBps": (
            float(f"{gbps:.3g}") if gbps is not None else None
        ),
        "roofline_frac": (
            float(f"{gbps / peak:.3g}")
            if gbps is not None and peak else None
        ),
    }


def _probe_mode(dev: torch.device) -> str:
    # the CPU runs the kernels' plain versions (JAX's interpret mode there)
    return "cuda" if dev.type == "cuda" else "plain-parity"


def _cuda_rows_probe(rt, ids, bucket: int = 16) -> "dict | None":
    """The row-sparse kernel's arm record (JAX's ``_pallas_rows_probe``,
    ``lasp_tpu/bench_scenarios.py:78``): one bucket-shaped call of K2 (or
    K3 for an OR-SWOT) on a copy of a live population, held against its
    plain PyTorch version (states and changed flags, max_abs_err 0), feeding
    the ``cuda_rows`` ledger family twice (the first record banks as the
    compile bucket, so the table shows a warm row). On the CPU the wrapper
    runs the plain version: a parity check only. Returns None when no
    variable has a rows plan."""
    from .ops import cuda_gossip as cg
    from .telemetry.capability import device_capability
    from .telemetry.roofline import kernel_traffic

    target = None
    for v in ids:
        codec, spec = rt._mesh_meta(v)
        plan = cg.rows_plan_of(codec, spec, rt.states[v])
        if plan is not None:
            target = (v, codec, plan)
            break
    if target is None:
        return None
    v, codec, plan = target
    dev = rt.device
    bucket = min(bucket, rt.n_replicas)
    rows = torch.arange(bucket, device=dev)[None]
    leaves = [x[None] for x in tree_map(torch.clone, rt.states[v])]
    if plan.kind == "vclock":
        want = cg.gossip_round_rows_vclock_plain(*leaves, rt.neighbors, rows)
        want = (list(want[0]), want[1])
    else:
        want = cg.gossip_round_rows_plain(plan.op, leaves, rt.neighbors, rows)
    row_bytes = rt._row_bytes(v)
    secs = []
    for _ in range(2):
        got, s = _timed(dev, lambda: cg.rows_round(plan, leaves, rt.neighbors, rows))
        secs.append(s)
        get_ledger().record(
            "cuda_rows", codec.__name__,
            n_replicas=rt.n_replicas, fanout=rt._ledger_fanout(),
            seconds=s, row_bytes=row_bytes, rows=bucket, rounds=1,
        )
    err = max(
        int((a.long() - b.long()).abs().max()) if a.numel() else 0
        for a, b in zip(list(got[0]) + [got[1]], list(want[0]) + [want[1]])
    )
    if err:
        raise AssertionError(
            f"row-sparse kernel diverged from its plain version (max_abs_err {err})"
        )
    est = kernel_traffic(
        "cuda_rows", row_bytes=row_bytes, n_replicas=rt.n_replicas,
        fanout=rt._ledger_fanout(), rows=bucket,
    )
    warm = min(secs)
    return {
        "seconds": round(warm, 6),
        "bytes_moved": est.bytes_moved,
        **roofline_entry(
            est.bytes_moved, warm, device_capability()["peak_GBps"]
        ),
        "mode": _probe_mode(dev),
        "kernel": "gossip_round_rows_vclock" if plan.kind == "vclock"
        else "gossip_round_rows",
        "codec": codec.__name__,
        "bucket": bucket,
        "max_abs_err": err,
        "check": "equal to the plain PyTorch version",
    }


def _cuda_dense_probe(n_replicas: int = 64, fanout: int = 3,
                      device=None) -> dict:
    """The dense kernel's twin of :func:`_cuda_rows_probe` (JAX's
    ``_pallas_dense_probe``, ``lasp_tpu/bench_scenarios.py:161``): a small
    packed OR-Set population runs one round of K1 against its plain
    version, held bit for bit, feeding the ``cuda_dense`` ledger family
    twice."""
    from .ops import cuda_gossip as cg
    from .telemetry.capability import device_capability
    from .telemetry.roofline import kernel_traffic

    dev = resolve_device(device)
    spec = PackedORSetSpec(n_elems=16, n_actors=8, tokens_per_actor=8)
    states = replicate(PackedORSet.new(spec, device=dev), n_replicas)
    i = torch.arange(n_replicas, device=dev)
    states = PackedORSet.add(spec, states, i % spec.n_elems, i % spec.n_actors)
    nbrs = torch.as_tensor(random_regular(n_replicas, fanout, seed=11),
                           dtype=torch.int32, device=dev)
    fe = states.exists.reshape(n_replicas, -1)
    fr = states.removed.reshape(n_replicas, -1)
    row_bytes = 2 * spec.n_elems * spec.n_words * 4
    secs = []
    for _ in range(2):
        (oe, orr), s = _timed(dev, lambda: cg.gossip_round_dense(fe, fr, nbrs))
        secs.append(s)
        get_ledger().record(
            "cuda_dense", PackedORSet.__name__,
            n_replicas=n_replicas, fanout=fanout, seconds=s,
            row_bytes=row_bytes, rounds=1,
        )
    we, wr = cg.gossip_round_dense_plain(fe, fr, nbrs)
    err = max(int((oe.long() - we.long()).abs().max()),
              int((orr.long() - wr.long()).abs().max()))
    if err:
        raise AssertionError(
            f"dense kernel diverged from its plain version (max_abs_err {err})"
        )
    est = kernel_traffic(
        "cuda_dense", row_bytes=row_bytes, n_replicas=n_replicas,
        fanout=fanout,
    )
    warm = min(secs)
    return {
        "seconds": round(warm, 6),
        **roofline_entry(
            est.bytes_moved, warm, device_capability()["peak_GBps"]
        ),
        "mode": _probe_mode(dev),
        "kernel": "gossip_round_dense",
        "max_abs_err": err,
        "check": "equal to the plain PyTorch version",
    }


def roofline_workload(n_replicas: int = 128, n_vars: int = 12,
                      rounds: int = 3, device=None):
    """Drive every kernel-cost-ledger family of the port on a mixed-codec
    store — the workload behind the CLI's ``roofline`` verb
    (``lasp_tpu/bench_scenarios.py:255``): ``rounds`` re-dirty /
    convergence cycles of frontier stepping (cycle 0 banks as compile time)
    over G-Set / G-Counter / OR-SWOT variables, then dense steps and fused
    blocks; the K2 / K3 and K1 probes (``cuda_rows``, ``cuda_dense``); two
    fused propagates over a small combinator chain (``dataflow_fused``).
    JAX's partitioned ``shard_exchange`` wave is not run: sharding is not
    ported (ROADMAP A5). Returns the runtime."""
    dev = resolve_device(device)
    kinds = ("lasp_gset", "riak_dt_gcounter", "riak_dt_orswot")
    store = Store(n_actors=4, device=dev)
    ids = []
    for i in range(n_vars):
        kind = kinds[i % len(kinds)]
        if kind == "lasp_gset":
            ids.append(store.declare(id=f"v{i}", type=kind, n_elems=16))
        elif kind == "riak_dt_gcounter":
            ids.append(store.declare(id=f"v{i}", type=kind, n_actors=4))
        else:
            ids.append(store.declare(id=f"v{i}", type=kind, n_elems=8,
                                     n_actors=4))
    rt = ReplicatedRuntime(
        store, Graph(store), n_replicas,
        random_regular(n_replicas, 3, seed=7), device=dev,
    )
    for rep in range(rounds + 1):
        for i, v in enumerate(ids):
            if i % 3 == 1:
                rt.update_batch(
                    v, [((i + rep) % n_replicas, ("increment",),
                         ("lane", i % 4))]
                )
            else:
                rt.update_batch(
                    v, [((i + rep) % n_replicas, ("add", f"x{rep}"),
                         f"a{i}")]
                )
        while rt.frontier_step():
            pass
    rt.step()
    rt.step()
    rt.fused_steps(4)
    rt.fused_steps(4)
    rt.cuda_rows_probe = _cuda_rows_probe(rt, ids)
    rt.cuda_dense_probe = _cuda_dense_probe(device=dev)
    df_store, df_g = _build_dataflow_chains(n_chains=3, depth=2, device=dev)
    for rep in range(2):
        for c in range(3):
            kind = c % 3
            if kind == 0:
                df_store.update(f"g{c}_0", ("add", rep), "w")
            elif kind == 1:
                df_store.update(f"s{c}_0", ("add", f"e{rep}"), "w")
            else:
                df_store.update(f"o{c}_0", ("add", f"x{rep}"), "w")
        df_g.propagate(mode="fused")
    return rt


def frontier_sparse(
    n_replicas: int = 1 << 13,
    fanout: int = 3,
    write_frac: float = 0.02,
    n_elems: int = 256,
    n_vars: int = 8,
    write_vars: int = 2,
    block: int = 4,
    seed: int = 13,
    device=None,
) -> dict:
    """Sparse-update convergence A/B (``lasp_tpu/bench_scenarios.py:1035``):
    ``n_vars`` G-Sets of which ``write_vars`` take client writes at
    ``write_frac`` of the replicas, re-converged from identical seeds by the
    dense scheduler (fused blocks, K1-free G-Set rounds) and by the frontier
    engine (``run_to_convergence(mode="frontier")``: untouched variables
    skipped, touched ones gather and join only reachable rows through K2,
    with the dense crossover). Both arms are timed warm, best of two
    replays from a snapshot; the frontier arm then autotunes its crossover
    (measured break-even density) and re-times. The arms' fixed points must
    be bit-identical for every variable. The ``cuda_rows`` probe holds K2
    against its plain version on the frontier arm's population."""
    dev = resolve_device(device)
    n_writes = max(1, int(write_frac * n_replicas))
    write_vars = min(write_vars, n_vars)
    nbrs = random_regular(n_replicas, fanout, seed=seed)

    def build():
        store = Store(n_actors=4, device=dev)
        ids = [
            store.declare(id=f"v{i}", type="lasp_gset", n_elems=n_elems)
            for i in range(n_vars)
        ]
        rt = ReplicatedRuntime(store, Graph(store), n_replicas, nbrs, device=dev)
        rng = np.random.RandomState(seed)
        for v in ids[:write_vars]:
            rows = rng.choice(n_replicas, size=n_writes, replace=False)
            rt.update_batch(
                v,
                [
                    (int(r), ("add", f"w{int(r) % 8}"), f"client{int(r)}")
                    for r in rows
                ],
            )
        return rt, ids

    def timed_rep(rt, run):
        """One measured replay from the snapshot (restored by the caller):
        seconds, rounds, rows touched and the ledger's byte delta."""
        rows_before = rt.frontier_rows_total
        bytes_before = get_ledger().totals()["bytes"]
        rounds, secs = _timed(dev, run)
        return secs, rounds, (
            rt.frontier_rows_total - rows_before
        ), get_ledger().totals()["bytes"] - bytes_before

    results = {}
    finals = {}
    autotuned = None
    cuda_arm = None
    for arm in ("dense", "frontier"):
        rt, ids = build()
        snap = _snapshot_runtime(rt)
        run = (
            (lambda: rt.run_to_convergence(block=block))
            if arm == "dense"
            else (lambda: rt.run_to_convergence(mode="frontier"))
        )
        cold_rounds = run()
        reps = []
        for _ in range(2):
            _restore_runtime(rt, snap)
            secs, rounds, rows, rep_bytes = timed_rep(rt, run)
            if rounds != cold_rounds:
                raise AssertionError(
                    f"{arm}: a replay took {rounds} rounds, the cold pass "
                    f"{cold_rounds}"
                )
            reps.append((secs, rounds, rows, rep_bytes))
        if arm == "frontier":
            secs, _r, rows, _b = min(reps)
            d_row = results["dense"]["seconds"] / max(
                cold_rounds * n_replicas * n_vars, 1
            )
            if rows:
                autotuned = round(min(1.0, d_row / (secs / rows)), 4)
                rt.frontier_crossover = autotuned
                _restore_runtime(rt, snap)
                run()  # untimed: the re-scheduled run's first pass
                _restore_runtime(rt, snap)
                reps.append(timed_rep(rt, run))
        secs, rounds, rows, arm_bytes = min(reps)
        results[arm] = {
            "seconds": secs, "rounds": rounds, "rows_touched": rows,
            "bytes_moved": arm_bytes,
        }
        if any(rt.divergence(v) for v in ids):
            raise AssertionError(f"{arm}: a variable did not converge")
        finals[arm] = (
            {v: [x.cpu() for x in tree_leaves(rt.states[v])] for v in ids},
            {v: rt.coverage_value(v) for v in ids},
        )
        if arm == "frontier":
            cuda_arm = _cuda_rows_probe(rt, ids)
        del rt

    if finals["dense"][1] != finals["frontier"][1] or not all(
        torch.equal(a, b)
        for v in finals["dense"][0]
        for a, b in zip(finals["dense"][0][v], finals["frontier"][0][v])
    ):
        raise AssertionError("frontier_sparse: the arms' states diverged")

    dense_s, frontier_s = (
        results["dense"]["seconds"], results["frontier"]["seconds"],
    )
    rows = results["frontier"]["rows_touched"]
    impl_roofline = _arm_roofline(
        {a: (results[a]["bytes_moved"], results[a]["seconds"])
         for a in results}
    )
    impl_block_seconds = {
        "dense": round(dense_s, 6),
        "frontier": round(frontier_s, 6),
    }
    if cuda_arm is not None:
        impl_block_seconds["cuda_rows"] = cuda_arm["seconds"]
        impl_roofline["cuda_rows"] = {
            "achieved_GBps": cuda_arm["achieved_GBps"],
            "roofline_frac": cuda_arm["roofline_frac"],
        }
    return {
        "scenario": f"frontier_sparse_{n_replicas}",
        "n_replicas": n_replicas,
        "n_vars": n_vars,
        "write_vars": write_vars,
        "write_density": round(n_writes / n_replicas, 4),
        "fanout": fanout,
        "rounds": results["frontier"]["rounds"],
        "dense_rounds": results["dense"]["rounds"],
        "frontier_rows_touched": rows,
        "dense_rows_touched": (
            results["dense"]["rounds"] * n_replicas * n_vars
        ),
        "impl_block_seconds": impl_block_seconds,
        "impl_roofline": impl_roofline,
        "cuda_rows": cuda_arm,
        "gossip_impl": "frontier" if frontier_s <= dense_s else "dense",
        "frontier_speedup": round(dense_s / frontier_s, 2),
        "autotuned_crossover": autotuned,
        "engine": "ReplicatedRuntime(frontier_step)",
        "check": "fixed points bit-identical across schedulers",
        "device": str(dev),
    }


_MANY_VARS_KINDS = ("lasp_gset", "riak_dt_gcounter", "riak_dt_orswot")


def many_vars_runtime(n_replicas: int, n_vars: int, hot_vars: int, fanout: int,
                      seed: int, plan: str, device=None):
    """The ``many_vars`` population (``lasp_tpu/bench_scenarios.py:1260``):
    ``n_vars`` small variables cycling G-Set / G-Counter / OR-SWOT on
    ``random_regular(n_replicas, fanout, seed)``, every one written once
    and the first ``hot_vars`` at an eighth of the replicas. Returns
    ``(runtime, ids)``."""
    dev = resolve_device(device)
    nbrs = random_regular(n_replicas, fanout, seed=seed)
    n_hot_rows = max(2, n_replicas // 8)
    store = Store(n_actors=4, device=dev)
    ids = []
    for i in range(n_vars):
        kind = _MANY_VARS_KINDS[i % 3]
        if kind == "lasp_gset":
            ids.append(store.declare(id=f"v{i}", type=kind, n_elems=16))
        elif kind == "riak_dt_gcounter":
            ids.append(store.declare(id=f"v{i}", type=kind, n_actors=4))
        else:
            ids.append(store.declare(id=f"v{i}", type=kind, n_elems=8,
                                     n_actors=4))
    rt = ReplicatedRuntime(store, Graph(store), n_replicas, nbrs, plan=plan,
                           device=dev)
    rng = np.random.RandomState(seed)
    for j, v in enumerate(ids):
        rows = rng.choice(
            n_replicas, n_hot_rows if j < hot_vars else 1, replace=False
        )
        kind = _MANY_VARS_KINDS[j % 3]
        if kind == "lasp_gset":
            ops = [(int(r), ("add", f"e{int(r) % 8}"), f"a{int(r)}")
                   for r in rows]
        elif kind == "riak_dt_gcounter":
            ops = [(int(r), ("increment",), ("lane", int(r) % 4))
                   for r in rows]
        else:
            ops = [(int(r), ("add", f"x{int(r) % 8}"), f"w{int(r) % 4}")
                   for r in rows]
        rt.update_batch(v, ops)
    return rt, ids


def many_vars(
    n_replicas: int = 256,
    n_vars: int = 128,
    hot_vars: int = 2,
    fanout: int = 3,
    seed: int = 23,
    reps: int = 3,
    device=None,
) -> dict:
    """Cross-variable dispatch A/B (``lasp_tpu/bench_scenarios.py:1228``):
    the :func:`many_vars_runtime` population re-converged from identical
    seeds by frontier rounds under ``plan="off"`` (one K2 / K3 launch per
    active variable a round) and ``plan="auto"`` (same-codec variables in
    one launch per active group). Both arms are timed warm, the median of
    ``reps`` snapshot replays; the scenario asserts bit-identical final
    states, identical per-round residual sequences and round counts, and
    holds K2 / K3 against their plain version on the planned population."""
    dev = resolve_device(device)

    def drive(rt) -> list:
        residuals = []
        for _ in range(4096):
            r = rt.frontier_step()
            residuals.append(r)
            if r == 0:
                return residuals
        raise RuntimeError("no convergence within 4096 rounds")

    results = {}
    finals = {}
    residual_seqs = {}
    plan_shape = None
    cuda_arm = None
    for arm, plan in (("per_var", "off"), ("planned", "auto")):
        rt, ids = many_vars_runtime(n_replicas, n_vars, hot_vars, fanout, seed,
                                    plan, device=dev)
        snap = _snapshot_runtime(rt)
        cold_residuals = drive(rt)
        if plan == "auto":
            plan_shape = rt._ensure_plan().describe()
        rep_secs = []
        arm_bytes0 = get_ledger().totals()["bytes"]
        for _ in range(reps):
            _restore_runtime(rt, snap)
            residuals, secs = _timed(dev, lambda: drive(rt))
            if residuals != cold_residuals:
                raise AssertionError(f"{arm}: a replay's residuals differ")
            rep_secs.append(secs)
        arm_bytes = get_ledger().totals()["bytes"] - arm_bytes0
        residual_seqs[arm] = cold_residuals
        results[arm] = {
            "seconds": float(np.median(rep_secs)),
            "seconds_each": [round(s, 6) for s in rep_secs],
            "noise_band": round(max(rep_secs) / max(min(rep_secs), 1e-9), 2),
            "rounds": len(cold_residuals),
            "bytes_moved": arm_bytes,
            "reps_seconds_total": round(sum(rep_secs), 6),
        }
        if any(rt.divergence(v) for v in ids):
            raise AssertionError(f"{arm}: a variable did not converge")
        finals[arm] = {v: [x.cpu() for x in tree_leaves(rt.states[v])]
                       for v in ids}
        if arm == "planned":
            cuda_arm = _cuda_rows_probe(rt, ids)
        del rt

    if residual_seqs["per_var"] != residual_seqs["planned"]:
        raise AssertionError("many_vars: the arms' residual sequences differ")
    if not all(torch.equal(a, b) for v in finals["per_var"]
               for a, b in zip(finals["per_var"][v], finals["planned"][v])):
        raise AssertionError("many_vars: the arms' states diverged")

    pv_s = results["per_var"]["seconds"]
    pl_s = results["planned"]["seconds"]
    impl_roofline = _arm_roofline(
        {a: (results[a]["bytes_moved"], results[a]["reps_seconds_total"])
         for a in results}
    )
    impl_block_seconds = {"per_var": round(pv_s, 6), "planned": round(pl_s, 6)}
    if cuda_arm is not None:
        impl_block_seconds["cuda_rows"] = cuda_arm["seconds"]
        impl_roofline["cuda_rows"] = {
            "achieved_GBps": cuda_arm["achieved_GBps"],
            "roofline_frac": cuda_arm["roofline_frac"],
        }
    return {
        "scenario": f"many_vars_{n_vars}x{n_replicas}",
        "n_replicas": n_replicas,
        "n_vars": n_vars,
        "hot_vars": hot_vars,
        "fanout": fanout,
        "rounds": results["planned"]["rounds"],
        "residuals": residual_seqs["planned"],
        "plan": plan_shape,
        "impl_block_seconds": impl_block_seconds,
        "impl_roofline": impl_roofline,
        "cuda_rows": cuda_arm,
        "timing": {
            "policy": f"median of {reps} warm snapshot replays per arm",
            "per_var": results["per_var"],
            "planned": results["planned"],
        },
        "gossip_impl": "planned" if pl_s <= pv_s else "per_var",
        "plan_speedup": round(pv_s / pl_s, 2),
        "engine": "ReplicatedRuntime(frontier_step, dispatch plan)",
        "check": "bit-identical states + residual sequences across arms",
        "device": str(dev),
    }


def packed_vs_dense_runtime(n_replicas: int, packed: bool, nbrs=None,
                            device=None) -> ReplicatedRuntime:
    """The ``packed_vs_dense`` population (``lasp_tpu/bench_scenarios.py:1905``):
    an OR-Set ``src`` (16 elements, 8 actors, 4 tokens an actor) with a
    ``map`` edge into ``out`` (16 elements), on ``random_regular(n_replicas,
    3, seed=9)`` (or ``nbrs``), one ``add_all`` of 8 elements at row 0."""
    dev = resolve_device(device)
    if nbrs is None:
        nbrs = random_regular(n_replicas, 3, seed=9)
    store = Store(n_actors=8, device=dev)
    graph = Graph(store)
    v = store.declare(
        id="src", type="lasp_orset", n_elems=16, n_actors=8,
        tokens_per_actor=4,
    )
    graph.map(v, lambda x: x + "!", dst="out", dst_elems=16)
    rt = ReplicatedRuntime(store, graph, n_replicas, nbrs, packed=packed,
                           device=dev)
    rt.update_batch(v, [(0, ("add_all", [f"e{i}" for i in range(8)]), "w")])
    return rt


def packed_vs_dense(n_replicas: int = 1 << 20, blocks: int = 4, block: int = 8,
                    device=None) -> dict:
    """The same engine workload (an OR-Set source, a map edge, random
    gossip) with dense codec state and with ``packed=True`` (K1)
    (``lasp_tpu/bench_scenarios.py:1887``), identical seeds: ``blocks``
    fused blocks timed after one warm block, per-round seconds for each
    mode, then both run to convergence and must give the same value. Every
    round of every block runs whether or not the population has converged,
    so this compares the modes' rounds, not a convergence time."""
    dev = resolve_device(device)
    nbrs = random_regular(n_replicas, 3, seed=9)
    per_round: dict = {}
    values: dict = {}
    rounds: dict = {}
    for mode in ("dense", "packed"):
        rt = packed_vs_dense_runtime(n_replicas, mode == "packed", nbrs, dev)
        rt.fused_steps(block)  # warm outside the clock

        def timed_blocks():
            for _ in range(blocks):
                rt.fused_steps(block)

        _none, secs = _timed(dev, timed_blocks)
        per_round[mode] = secs / (blocks * block)
        rounds[mode] = rt.run_to_convergence(block=block)
        values[mode] = rt.coverage_value("out")
        del rt
    if values["dense"] != values["packed"] or values["dense"] != frozenset(
            f"e{i}!" for i in range(8)):
        raise AssertionError(f"packed_vs_dense: values differ: {values}")
    return {
        "scenario": f"packed_vs_dense_{n_replicas}",
        "n_replicas": n_replicas,
        "rounds_timed": blocks * block,
        "rounds_after": rounds,
        "per_round_s": {k: round(v, 6) for k, v in per_round.items()},
        "packed_speedup": round(per_round["dense"] / per_round["packed"], 2),
        "engine": "Graph+ReplicatedRuntime",
        "check": "dense==packed value",
        "device": str(dev),
    }


def bridge_throughput(n_ops: int = 1500, device=None) -> dict:
    """ETF codec and loopback bridge throughput
    (``lasp_tpu/bench_scenarios.py:1944``): a BEAM node delegating its
    ``lasp_backend`` behaviour pays one ETF decode + dispatch + encode per
    op, and bulk anti-entropy pays it per ``merge_batch`` frame. Raw codec
    rates on two frames (a small client op; a 16-store OR-Set
    ``merge_batch``), end-to-end loopback round trips a second against a
    server whose store lives on ``device``, and which codec served them
    (``etf_impl``)."""
    from .bridge import BridgeClient, BridgeServer, etf
    from .bridge.etf import Atom

    op_frame = (Atom("update"), b"counter", (Atom("increment"), 5), b"w0")
    orset_state = [
        (f"elem{i}".encode(), [(t, t % 3 == 0) for t in range(8)])
        for i in range(32)
    ]
    caps = {Atom("n_elems"): 64, Atom("n_actors"): 4,
            Atom("tokens_per_actor"): 16}
    batch_frame = (
        Atom("merge_batch"),
        [(f"s{i}".encode(), (Atom("lasp_orset"), orset_state, caps))
         for i in range(16)],
    )

    codec = {}
    for name, frame in (("small_op", op_frame),
                        ("merge_batch_16x32elem", batch_frame)):
        raw = etf.encode(frame)
        reps = max(100, min(20_000, 4_000_000 // max(1, len(raw))))
        t0 = time.perf_counter()
        for _ in range(reps):
            etf.encode(frame)
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            etf.decode(raw)
        dec_s = time.perf_counter() - t0
        codec[name] = {
            "frame_bytes": len(raw),
            "encodes_per_s": round(reps / enc_s, 1),
            "decodes_per_s": round(reps / dec_s, 1),
            "decode_MBps": round(len(raw) * reps / dec_s / 1e6, 1),
        }

    with BridgeServer(device=device) as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("bench")
            c.declare(b"counter", "riak_dt_gcounter", n_actors=8)
            ok, _ = c.update(b"counter", (Atom("increment"),), b"w0")
            if ok != Atom("ok"):
                raise AssertionError(f"bridge_throughput: update refused: {ok}")
            t0 = time.perf_counter()
            for _ in range(n_ops):
                c.update(b"counter", (Atom("increment"),), b"w0")
            loop_s = time.perf_counter() - t0
            _ok, total = c.read(b"counter")
            if total != n_ops + 1:
                raise AssertionError(
                    f"bridge_throughput: counter {total}, sent {n_ops + 1}"
                )

    return {
        "scenario": f"bridge_throughput_{n_ops}",
        "etf_impl": etf.IMPL,
        "codec": codec,
        "loopback_roundtrips_per_s": round(n_ops / loop_s, 1),
        "check": "counter total == ops sent",
        "device": str(server.device),
    }


#: riak_core's default ring size (``ring_creation_size``, 64 partitions):
#: one durable bridge store (``{start, Name}``) per partition
BRIDGE_PARTITIONS = 64

#: the caps each of ``ingest_storm``'s five kinds is declared with over the
#: wire (the map's two fields as in ``ingest_storm``: ``tags`` and ``hits``);
#: an OR-Set add mints a token, and the zipfian's hottest variable takes up
#: to 14 adds of one element by one actor in the default stream, so its
#: pool holds 16 an actor
_BRIDGE_CAPS = {
    "lasp_gset": {"n_elems": 32},
    "riak_dt_gcounter": {"n_actors": 16},
    "riak_dt_orswot": {"n_elems": 32, "n_actors": 16},
    "lasp_orset": {"n_elems": 32, "n_actors": 16, "tokens_per_actor": 16},
    "riak_dt_map": {"n_actors": 16},
}


#: the request mix of the bridge stream outside its ``merge_batch`` frames:
#: YCSB core workload A (``workloads/workloada``: readproportion=0.5,
#: updateproportion=0.5, requestdistribution=zipfian) with YCSB's zipfian
#: constant (``ZipfianGenerator.ZIPFIAN_CONSTANT``)
YCSB_A = {"read": 0.5, "update": 0.5, "zipfian_constant": 0.99}


def bridge_stream(n_requests: int = 20_000, n_partitions: int = BRIDGE_PARTITIONS,
                  vars_per_partition: int = 16, merge_every: int = 10,
                  seed: int = 0) -> dict:
    """A seeded bridge workload: ``vars_per_partition`` variables in each of
    ``n_partitions`` stores, cycling :data:`INGEST_KINDS`, and
    ``n_requests`` requests over them. Every ``merge_every``-th is a
    ``merge_batch`` of one portable state for each variable of a partition
    drawn uniformly (the anti-entropy RPC; the states are seeded draws of
    each kind, not a peer's). The rest follow :data:`YCSB_A`: half value
    reads (``read``), half updates, each on a variable drawn from YCSB's
    zipfian over the 1,024 variables with the ranks scattered by a seeded
    permutation (as YCSB's scrambled zipfian scatters them by hash). An
    update changes one field as YCSB's does (``writeallfields=false``): an
    add of a seeded element to a set, an increment of a counter, one of the
    map's two fields; it is wrapped in ``{idem, ReqId, _}`` with a seeded
    id, as the client sends writes. Pure function of the seed: returns
    ``{"setup": [(partition, term)], "requests": [(partition, term)],
    "vars": [(partition, var_id)]}`` with ``partition`` a store name
    (``p<k>``) and terms of this package's ``Atom``."""
    from .bridge.etf import Atom

    rng = np.random.RandomState(seed)
    actors = [f"a{i}".encode() for i in range(8)]
    elems = [f"e{i}".encode() for i in range(24)]
    setup, variables, kinds = [], [], {}
    for p in range(n_partitions):
        name = f"p{p}"
        setup.append((name, (Atom("start"), Atom(name))))
        for i in range(vars_per_partition):
            kind = INGEST_KINDS[(p * vars_per_partition + i) % len(INGEST_KINDS)]
            vid = f"v{p}_{i}".encode()
            caps = {Atom(k): v for k, v in _BRIDGE_CAPS[kind].items()}
            if kind == "riak_dt_map":
                caps[Atom("fields")] = [
                    (b"tags", Atom("lasp_gset"), {Atom("n_elems"): 8}),
                    (b"hits", Atom("riak_dt_gcounter"), {}),
                ]
            setup.append((name, (Atom("declare"), vid, Atom(kind), caps)))
            variables.append((name, vid))
            kinds[vid] = kind
    zipf = 1.0 / np.arange(1, len(variables) + 1) ** YCSB_A["zipfian_constant"]
    zipf = zipf[rng.permutation(len(variables))]
    zipf /= zipf.sum()

    def update(vid):
        kind, actor = kinds[vid], actors[rng.randint(len(actors))]
        if kind == "riak_dt_gcounter":
            op = (Atom("increment"), int(rng.randint(1, 4)))
        elif kind == "riak_dt_map":
            op = ((Atom("update"), b"hits", (Atom("increment"),))
                  if rng.randint(2) else
                  (Atom("update"), b"tags",
                   (Atom("add"), elems[rng.randint(8)])))
        else:
            op = (Atom("add"), elems[rng.randint(len(elems))])
        return (Atom("idem"), rng.bytes(16), (Atom("update"), vid, op, actor))

    def portable(vid):
        kind = kinds[vid]
        a = [actors[i] for i in rng.choice(len(actors), 2, replace=False)]
        if kind == "lasp_gset":
            return [elems[i] for i in rng.choice(len(elems), 3, replace=False)]
        if kind == "riak_dt_gcounter":
            return [(x, int(rng.randint(1, 40))) for x in a]
        if kind == "lasp_orset":
            return [(elems[i], [(int(rng.randint(64)), False)])
                    for i in rng.choice(len(elems), 2, replace=False)]
        clock = [(x, int(rng.randint(1, 4))) for x in a]
        dots = [(a[0], int(rng.randint(1, clock[0][1] + 1)))]
        if kind == "riak_dt_orswot":
            return (clock, [(elems[rng.randint(len(elems))], dots)])
        return (clock, [(b"hits", dots, [(a[1], int(rng.randint(1, 9)))])])

    requests = []
    for n in range(n_requests):
        if merge_every and n % merge_every == merge_every - 1:
            name = f"p{rng.randint(n_partitions)}"
            items = [(v, portable(v)) for pn, v in variables if pn == name]
            requests.append((name, (Atom("merge_batch"), items)))
            continue
        name, vid = variables[rng.choice(len(variables), p=zipf)]
        if rng.rand() < YCSB_A["read"]:
            requests.append((name, (Atom("read"), vid)))
        else:
            requests.append((name, update(vid)))
    return {"setup": setup, "requests": requests, "vars": variables}


def bridge_clients(port: int, setup, host: str = "127.0.0.1") -> dict:
    """One client connection per partition of a :func:`bridge_stream`,
    with its ``setup`` frames sent: ``{partition: BridgeClient}``. The
    caller closes them."""
    from .bridge import Atom, BridgeClient, etf

    clients = {}
    try:
        for name, term in setup:
            if name not in clients:
                clients[name] = BridgeClient(host, port, retries=0)
            for _ in range(250):
                resp = clients[name].call(term)
                # a store name stays locked until the server has closed
                # the previous connection that held it
                if resp[:2] != (etf.ERROR, Atom("locked")):
                    break
                time.sleep(0.02)
            if resp[0] == etf.ERROR:
                raise RuntimeError(f"bridge setup {term!r} refused: {resp!r}")
    except BaseException:
        for c in clients.values():
            c.close()
        raise
    return clients


def bridge_requests(clients: dict, requests) -> dict:
    """Send ``[(partition, term)]`` in order over :func:`bridge_clients`'
    connections. Returns the responses as ETF bytes, in order, with each
    request's round-trip seconds and the wall seconds of them all."""
    from .bridge import etf

    out, lat = [], []
    t0 = time.perf_counter()
    for name, term in requests:
        t = time.perf_counter()
        resp = clients[name].call(term)
        lat.append(time.perf_counter() - t)
        out.append(etf.encode(resp))
    return {"responses": out, "latency_s": lat,
            "seconds": time.perf_counter() - t0}


def run_bridge_stream(port: int, stream: dict, host: str = "127.0.0.1") -> dict:
    """Drive :func:`bridge_stream`'s workload through a live bridge server:
    :func:`bridge_clients` with its setup, then :func:`bridge_requests`
    with its requests; the clients are closed."""
    clients = bridge_clients(port, stream["setup"], host)
    try:
        return bridge_requests(clients, stream["requests"])
    finally:
        for c in clients.values():
            c.close()


def partitioned_gossip(n_replicas: int = 1 << 20, n_shards: int = 8, k: int = 3,
                       rounds: int = 3, device=None) -> dict:
    """Wire-cost A/B for irregular gossip under sharding (JAX's
    ``lasp_tpu/bench_scenarios.py:2011``): the gather path (every shard
    reads the whole population plane) against the locality-aware boundary
    exchange (``topology.locality_order`` + ``shard_gossip``) in both
    modes, on one scale-free topology over ``n_shards`` shard slots of the
    device. JAX reads the bytes of each compiled round's collectives from
    its HLO; here each exchange counts the bytes it moves
    (``shard_gossip.EXCHANGED``), on the same per-shard convention: the
    union buffer every shard reads (gather), the slices one destination
    receives (alltoall), against the population plane. Times ``rounds``
    rounds of each after one untimed round and checks the three agree.

    When a process group is joined the shards are every process's slots
    (``n_shards`` in all): each process holds its shards' rows, the gather
    path all-gathers the population, and ``process_bytes_per_round`` says
    what the group carried a round of each mode. ``block_hashes`` hashes
    each of this process's shards' final rows."""
    from .lattice import GSet, GSetSpec
    from .mesh import comm
    from .mesh import shard_gossip as sg
    from .mesh.gossip import gossip_round, gossip_round_from

    dev = resolve_device(device)
    n_dev = n_shards
    n_replicas -= n_replicas % n_dev
    if n_replicas < 8 * n_dev:
        raise ValueError(
            f"partitioned_gossip needs >= {8 * n_dev} replicas on "
            f"{n_dev} shards (got {n_replicas} after rounding)"
        )
    _perm, nn = locality_order(scale_free(n_replicas, k, seed=1))
    plan = sg.partitioned_gossip_plan(nn, n_dev)
    spec = GSetSpec(n_elems=16)
    rng = np.random.RandomState(0)
    mask = rng.rand(n_replicas, spec.n_elems) < 0.01
    mesh, first, n_loc = _shard_mesh(dev, n_dev)
    block = n_replicas // n_dev
    lo, hi = first * block, (first + n_loc) * block
    states = replicate(GSet.new(spec, device=dev), hi - lo)._replace(
        mask=torch.as_tensor(mask[lo:hi], device=dev)
    )
    row_bytes = sg._row_nbytes(states)
    nbrs = torch.as_tensor(nn, dtype=torch.int32, device=dev)
    if mesh.cross_process:
        # the gather path: every process's rows, then its own joined

        def dense_round(x):
            whole = comm.all_gather(x.mask.unsqueeze(0), mesh).reshape(n_replicas, -1)
            return gossip_round_from(GSet, spec, x, x._replace(mask=whole),
                                     nbrs[lo:hi])
    else:

        def dense_round(x):
            return gossip_round(GSet, spec, x, nbrs)

    out_d = dense_round(states)  # untimed first round

    def dense_rounds():
        nonlocal out_d
        for _ in range(rounds):
            out_d = dense_round(out_d)

    _, dense_s = _timed(dev, dense_rounds)
    mode_out, part_s_of = {}, {}
    for mode in ("gather", "alltoall"):
        send_idx, idx = sg.partition_tables(plan, mesh, mode=mode)
        part_round = sg.partitioned_gossip_round_fn(GSet, spec, mesh, plan,
                                                    mode=mode)
        kind = "all_to_all" if mode == "alltoall" else "all_gather"
        before = dict(sg.EXCHANGED[kind])
        carried = comm.carried_bytes()
        out_p = part_round(states, send_idx, idx)  # untimed first round
        moved = sg.EXCHANGED[kind]["bytes"] - before["bytes"]
        carried = comm.carried_bytes() - carried

        def part_rounds():
            nonlocal out_p
            for _ in range(rounds):
                out_p = part_round(out_p, send_idx, idx)

        _, part_s = _timed(dev, part_rounds)
        part_s_of[mode] = part_s
        if not torch.equal(out_p.mask, out_d.mask):
            raise AssertionError(f"{mode} diverged from the gather path")
        mode_out[mode] = {
            "process_bytes": carried,
            # per shard: the union buffer every shard reads; each
            # destination's own slices of the per-destination buffer
            "bytes": moved if mode == "gather" else moved // n_dev,
            "buffer_bytes": moved,
            "seconds_per_round": round(part_s / rounds, 4),
        }
    st = plan["stats"]
    d_bytes = n_replicas * row_bytes
    g_bytes = mode_out["gather"]["bytes"]
    a_bytes = mode_out["alltoall"]["bytes"]
    return {
        "scenario": f"partitioned_gossip_{n_replicas}",
        "n_replicas": n_replicas,
        "n_shards": n_dev,
        "cut": {k_: st[k_] for k_ in (
            "cross_edges", "send_rows", "max_send", "m2",
            "exchange_rows_per_round", "alltoall_rows_per_round",
            "allgather_rows_per_round",
        )},
        "dense_allgather_bytes_per_round": d_bytes,
        "exchange_allgather_bytes_per_round": g_bytes,
        "alltoall_bytes_per_round": a_bytes,
        "alltoall_buffer_bytes_per_round": mode_out["alltoall"]["buffer_bytes"],
        "wire_reduction": round(d_bytes / g_bytes, 2) if g_bytes else None,
        "wire_reduction_alltoall": (
            round(d_bytes / a_bytes, 2) if a_bytes else None
        ),
        "dense_seconds_per_round": round(dense_s / rounds, 4),
        "exchange_seconds_per_round": mode_out["gather"]["seconds_per_round"],
        "alltoall_seconds_per_round": mode_out["alltoall"]["seconds_per_round"],
        # the same three times unrounded (host clock, device synchronized)
        "per_round_s": {"dense": dense_s / rounds, "gather": part_s_of["gather"] / rounds,
                        "alltoall": part_s_of["alltoall"] / rounds},
        "process_bytes_per_round": {m: o["process_bytes"] for m, o in mode_out.items()},
        "processes": comm.process_count(),
        "block_hashes": _block_hashes(out_d, first, n_loc, block),
        "check": "fixed rounds of all three paths produce identical states",
    }


def mesh_scale(n_replicas: int = 1 << 12, n_shards: int = 8, k: int = 3,
               write_frac: float = 0.002, cycles: int = 2, n_vars: int = 2,
               n_elems: int = 64, seed: int = 23, mode: str = "alltoall",
               sync_every: int = 8, wire_gate: "float | None" = None,
               device=None) -> dict:
    """The partitioned frontier path, measured (JAX's
    ``lasp_tpu/bench_scenarios.py:2573``): ``n_shards`` shards run the
    row-sparse frontier scheduler natively — each round's exchange moves
    only the dirty cut rows — and the hierarchical converge finds
    quiescence. Repeated small write waves (``write_frac`` of the
    replicas) each run to quiescence under ``frontier_step``, recording
    per round the dirty-cut fraction, the payload bytes moved and the
    dense cut plane's equivalent; then one more wave converges on the
    device (at up to 16,384 replicas against the host loop on a copy,
    asserted equal).

    Gate: at every measured sparse round with a dirty-cut fraction of at
    most 5%, the exchange moves at least ``wire_gate`` times fewer bytes
    than the dense cut plane (default 5x at >= 1,048,576 replicas, 2x
    below, where the pad bucket floor dominates).

    When a process group is joined the shards are every process's slots
    (``n_shards`` in all), as :func:`partitioned_gossip`'s; each process
    returns the same numbers, ``block_hashes`` of its own shards' rows
    of every variable."""
    from .mesh import comm
    from .mesh.shard_gossip import shard_cut_bytes
    from .telemetry.capability import device_capability
    from .telemetry.roofline import state_row_bytes

    dev = resolve_device(device)
    n_dev = n_shards
    n_replicas -= n_replicas % n_dev
    if wire_gate is None:
        wire_gate = 5.0 if n_replicas >= (1 << 20) else 2.0
    _, nn = locality_order(scale_free(n_replicas, k, seed=seed))
    store = Store(n_actors=8, device=dev)
    ids = [
        store.declare(id=f"v{i}", type="lasp_gset", n_elems=n_elems)
        for i in range(n_vars)
    ]
    rt = ReplicatedRuntime(store, Graph(store), n_replicas, nn, device=dev)
    mesh, first, n_loc = _shard_mesh(dev, n_dev)
    rt.shard(mesh, axis="replicas", partition=True, partition_mode=mode)
    pplan = rt._partition["plan"]
    cut = int(pplan["stats"]["send_rows"])
    rng = np.random.RandomState(seed)
    n_writes = max(2, int(write_frac * n_replicas))

    def write_wave(cycle: int) -> None:
        for i, v in enumerate(ids):
            rows = rng.choice(n_replicas, size=n_writes, replace=False)
            rt.update_batch(
                v,
                [(int(r), ("add", f"c{cycle}e{(int(r) + i) % 8}"),
                  f"w{int(r)}") for r in rows],
            )

    def dirty_cut_frac() -> float:
        union = np.zeros(n_replicas, dtype=bool)
        for v in ids:
            union |= rt._frontier[v]
        return float(union[pplan["cut_rows"]].sum()) / max(cut, 1)

    # cycle 0 warms every bucket the schedule needs (untimed)
    write_wave(0)
    while rt.frontier_step():
        pass

    rounds_per_cycle: list = []
    per_round: list = []
    sparse_s = 0.0
    led0 = get_ledger().totals()["bytes"]
    for cycle in range(1, cycles + 1):
        write_wave(cycle)
        rounds = 0
        while True:
            frac = dirty_cut_frac()
            xb0 = rt.part_exchange_bytes_total
            db0 = rt.part_dense_plane_bytes_total
            fresh = any(v not in rt._part_halo for v in ids)
            res, secs = _timed(dev, rt.frontier_step)
            sparse_s += secs
            rounds += 1
            per_round.append({
                "cycle": cycle,
                "dirty_cut_frac": round(frac, 5),
                "payload_bytes": rt.part_exchange_bytes_total - xb0,
                "dense_plane_bytes": rt.part_dense_plane_bytes_total - db0,
                "halo_resync": bool(fresh),
                "dense_arm": bool(rt.frontier_dense_falls_last),
            })
            if res == 0:
                break
        rounds_per_cycle.append(rounds)
    led_bytes = get_ledger().totals()["bytes"] - led0

    # the wire gate at <= 5% dirty, sparse rounds only: a halo resync and
    # the dense crossover arm ship the full plane by design
    gated = [
        r for r in per_round
        if r["dirty_cut_frac"] <= 0.05 and not r["halo_resync"]
        and not r["dense_arm"]
        and r["payload_bytes"] and r["dense_plane_bytes"]
    ]
    worst_cut = min(
        (r["dense_plane_bytes"] / r["payload_bytes"] for r in gated),
        default=None,
    )
    if n_dev >= 2 and cut > 0:
        assert gated, "no measured round at <= 5% dirty-cut fraction"
        assert worst_cut >= wire_gate, (
            f"sparse exchange moved only {worst_cut:.2f}x fewer bytes "
            f"than the dense cut plane at <= 5% dirty (gate "
            f"{wire_gate}x)"
        )
    else:
        worst_cut = None
        wire_gate = None

    # the hierarchical converge: at CI shapes held against the host loop
    # on the same states (a copy, restored between the two)
    write_wave(cycles + 1)
    host_rounds = None
    if n_replicas <= (1 << 14):
        snap = (
            {v: tree_map(torch.clone, rt.states[v]) for v in ids},
            {v: rt._frontier[v].copy() for v in ids},
        )
        hier_rounds, hier_s = _timed(
            dev, lambda: rt.converge_on_device(sync_every=sync_every)
        )
        for v, st in snap[0].items():
            rt.states[v] = st
        rt._frontier = dict(snap[1])
        rt._part_halo.clear()
        host_rounds = 0
        while True:
            host_rounds += 1
            if rt.step() == 0:
                break
        assert hier_rounds == host_rounds, (hier_rounds, host_rounds)
    else:
        hier_rounds, hier_s = _timed(
            dev, lambda: rt.converge_on_device(sync_every=sync_every)
        )

    row_bytes = sum(state_row_bytes(rt.states[v], rt._block_rows()) for v in ids)
    ledger_rows = [
        r for r in get_ledger().snapshot() if r["family"] == "shard_exchange"
    ]
    cap = device_capability()
    sparse_total = sum(r["payload_bytes"] for r in per_round)
    dense_total = sum(r["dense_plane_bytes"] for r in per_round)
    return {
        "scenario": f"mesh_scale_{n_replicas}",
        "n_replicas": n_replicas,
        "n_shards": n_dev,
        "n_vars": n_vars,
        "partition_mode": mode,
        "write_density": round(n_writes / n_replicas, 5),
        "cut_rows": cut,
        "per_shard": shard_cut_bytes(nn, n_dev, row_bytes),
        "rounds_to_quiescence": rounds_per_cycle,
        "cut_rows_sparse_bytes": int(sparse_total),
        "cut_rows_dense_bytes": int(dense_total),
        "wire_cut_total": (
            round(dense_total / sparse_total, 2) if sparse_total else None
        ),
        "wire_cut_at_5pct_dirty": (
            round(worst_cut, 2) if worst_cut else None
        ),
        "wire_gate": wire_gate,
        "per_round": per_round[-24:],
        "interior_overlap_frac": round(
            rt.part_interior_rows_total
            / max(rt.part_interior_rows_total + rt.part_boundary_rows_total, 1),
            4,
        ),
        "hier_converge": {
            "rounds": int(hier_rounds),
            "seconds": round(hier_s, 4),
            "sync_every": sync_every,
            "host_loop_rounds": host_rounds,
        },
        "sparse_round_seconds_total": round(sparse_s, 4),
        "ledger_bytes_moved": int(led_bytes),
        "impl_roofline": {
            "shard_exchange": {
                "achieved_GBps": (
                    ledger_rows[0]["achieved_GBps"] if ledger_rows else None
                ),
                "roofline_frac": (
                    ledger_rows[0]["roofline_frac"] if ledger_rows else None
                ),
            },
        },
        "capability": {
            "platform": cap.get("platform"),
            "device_kind": cap.get("device_kind"),
            "peak_GBps": cap.get("peak_GBps"),
        },
        "engine": "ReplicatedRuntime(frontier_step, partitioned)",
        "processes": comm.process_count(),
        "process_bytes_total": rt.part_process_bytes_total,
        "block_hashes": {
            v: _block_hashes(rt.states[v], first, n_loc, n_replicas // n_dev)
            for v in ids
        },
        "check": (
            "sparse-vs-dense wire gate at <=5% dirty; hierarchical "
            "converge round count equals the host-driven loop at CI "
            "shapes"
        ),
    }


#: every scenario by name — JAX's registry's keys
#: (``lasp_tpu/bench_scenarios.py:3084``), the CLI's ``scenario`` verb
SCENARIOS = {
    "adcounter_6": adcounter_6,
    "gset_1k": gset_1k,
    "orset_100k": orset_100k,
    "pipeline_1m": pipeline_1m,
    "adcounter_10m": adcounter_10m,
    "packed_vs_dense": packed_vs_dense,
    "bridge_throughput": bridge_throughput,
    "partitioned_gossip": partitioned_gossip,
    "mesh_scale": mesh_scale,
    "frontier_sparse": frontier_sparse,
    "many_vars": many_vars,
    "ingest_storm": ingest_storm,
    "dataflow_chain": dataflow_chain,
    "chaos_heal": chaos_heal,
    "quorum_kv": quorum_kv,
    "serve_load": serve_load,
    "aae_scrub": aae_scrub,
    "elastic_rebalance": elastic_rebalance,
}
