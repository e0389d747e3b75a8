#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``lasp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. build    — compile every CUDA kernel of the port from
               ``lasp_tpu_torch/ops/csrc`` (one ``nvcc`` per source, all at
               once) into ``build/lasp_tpu_torch``, and beside them the
               native host store (``make -C native liblaspstore.so``) and
               the bridge's native ETF codec (the port's own build of
               ``native/laspetf.cpp``, ``bridge.etf.build_native``), which
               must pass its conformance gate (``IMPL == "native"``);
2. parity   — hold each kernel (K1, K2, K3) bit-for-bit against its plain
               PyTorch version on the card (tolerance zero: every value is
               a bit or an integer), changed flags included, on every path
               of its schedule (K1 narrow rows in one slab and column
               slabs at 16-, 8- and 4-byte loads; K2 16-, 8-, 4- and 1-byte
               vectors in teams of 1 to 32 lanes, on stacked, view, clone
               and misaligned members, int64 and int32 rows; K3 bulk
               copies, 4-byte copies and column-chunked rows); then K2 on
               every path and K3 on its three under chaos-style masks (about
               a quarter of the edges dead, one row with every edge dead);
3. headline — ``bench_scenarios.orset_anti_entropy`` at 2**18 replicas of
               the 8 KiB packed OR-Set (128 elems x 64 actors x 4 tokens),
               random 3-regular gossip, fused blocks of 4;
4. engine   — ``Store`` + ``ReplicatedRuntime(packed=True)`` at 100,000
               replicas on ``random_regular(100_000, 3)``: an OR-Set and a
               G-Counter written with ``update_batch``, converged by a dense
               twin and a frontier twin that must agree bit for bit;
5. plan     — the grouped dispatch plan at 100,000 replicas on
               ``random_regular(100_000, 3, seed=23)``: 48 variables cycling
               G-Set / G-Counter / OR-SWOT (16 of each), 16 writers each and
               one hot G-Set, converged by ``plan="off"`` and ``plan="auto"``
               frontier twins and a dense twin that must agree bit for bit;
               K2 and K3 must launch with G > 1; a fourth ``plan="auto"``
               twin converges under ``torch.profiler`` for the card's busy
               share;
6. baseline — the BASELINE configs through ``bench_scenarios``:
               ``gset_1k()`` (1,024 replicas, two G-Sets with union and
               intersection edges), ``orset_100k()`` (100,000 replicas, K1) and
               ``pipeline_1m()`` (1,048,576 replicas, map -> filter -> fold),
               each failing on its own reference check;
7. ingest   — ``bench_scenarios.ingest_storm`` at 100,000 replicas x 128
               variables cycling JAX's five kinds (G-Set, G-Counter,
               OR-SWOT, OR-Set, map; 6 cycles of 2,048 ops, 3 warm replays
               an arm, ``gate=None``): the per-variable and grouped arms
               bit-identical, one group apply per plan group per cycle of
               the encodable variables; then the same schedule replayed
               into three ``plan="auto"`` twins (dense, frontier with its
               exact marks feeding K2 / K3, ``packed=True`` dense through
               K1) that must converge alike; the schedule's ops by kind;
8. reads    — on the engine's population: ``read_until`` parked on the card
               against ``on_device=False`` on a twin, ``read_any_until`` over
               both variables likewise, and ``begin_fused_steps(8)`` with an
               ``ingest_cycle`` before ``finish()`` against ``fused_steps(8)``
               and the same cycle on a twin;
9. map      — the KVS-replica map at BASELINE config 4's population,
               1,048,576 replicas on ``random_regular(1_048_576, 3,
               seed=4)``: a ``riak_dt_map`` (``reset_on_readd=True``, 8
               actors) declaring ``{X, lasp_gset}`` (16 elements) and ``{Y,
               riak_dt_gcounter}``, 8 writers at their home rows. 4,000 puts
               on X and Y through ``update_batch`` (the vectorized
               ``_map_batch``: no per-op warning may fire); adds then removes
               on ``{T, lasp_orset}``, admitted by its first batch (the
               per-op path, warned); ``{Z, riak_dt_map}`` holding a G-Set,
               admitted mid-run; ``converge_on_device``;
               ``compact_map_field(T)``, re-adds into the freed slots and a
               profiled convergence. ``coverage_value`` must equal the value
               computed in plain Python from the ops and ``divergence`` 0
               after each convergence;
10. compaction — the engine's population (100,000 replicas, packed OR-Set
               of 64 elements x 16 actors x 4 tokens, a G-Counter): 16
               writers add the 64 elements and remove 32 at their own rows,
               converge through K1, ``compact_orset`` must return 32, 32
               fresh adds land in the freed slots and converge through K1;
               then a ``compaction_window`` with a builder-backed trigger
               (the adcounter server's pattern: remove an element once the
               G-Counter passes a threshold) compacts inside the window, and
               the rebuilt trigger must fire after it. Values must equal the
               plain-Python expectation;
11. dataflow — ``bench_scenarios.dataflow_chain`` at JAX's defaults (9
               chains of depth 8) and at 48 chains: ``Graph.propagate`` per
               edge against fused (same-signature edges stacked under
               ``torch.func.vmap``, one host sync a block of 8 sweeps), equal
               rounds and bit-identical states; any ``RuntimeWarning`` fails;
12. membership — the engine's population (``random_regular(100_000, 3,
               seed=0)``, packed OR-Set 64 x 16 x 4, G-Counter, OR-SWOT 64
               elements x 16 actors, 16 writers) on a frontier runtime and a
               dense twin: ``reseed_row`` on 64 replicas; 16 fresh writes and
               ``join_rows`` of their ``quorum_read`` join into 4,096 rows of
               each variable (the twin skips the join; K2 and K3 must launch);
               ``resize`` to 150,000; writes at rows >= 100,000 and a graceful
               ``resize`` to 100,000 (they survive); tail writes and a crash
               leave to 96,000 (only they are lost); ``membership_grow`` to
               100,000 with ``changed_delivery_rows`` and
               ``membership_drop_tail`` to 96,000. After each convergence the
               values equal the plain-Python expectation, divergence 0; the
               twins' fixed points are bit-identical;
13. checkpoint — that population through the native host store (the
               Python log engine fails the run): ``save_runtime`` /
               ``load_runtime`` bit-equal, ``load_runtime_rows`` +
               ``reseed_row`` restores the saved row, an elastic
               ``load_runtime`` onto 150,000 replicas converges to the same
               values, and a reset-mode map store round-trips through
               ``save_store`` / ``load_store``; bytes on disk, seconds and the
               temporary directory's filesystem;
14. chaos   — (a) ``bench_scenarios.chaos_heal`` at 100,000 replicas (a
               10-round ring-cut with a rolling crash, fused mask windows of
               8, one degraded read with read-repair each faulty round), its
               healed states bit-equal to the fault-free twin's, with the host
               time of the reachability BFS and of each degraded read; (b)
               every preset of ``chaos.PRESETS`` over the membership phase's
               population, unconverged: ``soak`` frontier (masked K2 / K3)
               and dense twins with equal per-round residuals and final
               states bit-equal to one fault-free fixed point, launches and
               the dispatch plan's recompile time per preset;
15. quorum  — ``bench_scenarios.quorum_kv`` at 100,000 replicas (8 client
               rounds of 24 puts and 24 degraded gets, N=3, R=W=2, timeout 4,
               retries 4) under every preset: no acked write lost, every
               request resolved; ``rolling-crash`` again with the sequential
               engine, equal to the batched one in states, trace and results;
16. aae     — ``bench_scenarios.aae_scrub`` at 100,000 replicas (JAX's
               other defaults: fanout 3, 8 nemesis rounds, 8 writers, seed
               23; a 64-element G-Set and a 32 x 16 OR-SWOT) over every
               preset of ``PRESETS + CORRUPTION_PRESETS`` with dense rounds
               and ring-cut again with frontier rounds (K2 / K3): each drill
               asserts detection within the scrub cadence, exact
               localization, repair and healed states bit-equal to the
               fault-free twin; then the incremental rehash of two hot rows
               against a full rehash of six 64-element G-Sets at 100,000
               rows (median of 3). Per preset: detections, repairs, repair
               against full-resync bytes, exchange rounds and comparisons,
               scrub seconds split into hash, exchange and repair;
17. rebalance — ``bench_scenarios.elastic_rebalance`` at 100,000 ->
               150,000 -> 100,000 on ``random_regular(., 3)`` with 12,500
               transfers a cycle (staged and legacy grown populations
               bit-equal, no cycle over the cap, staged transfer wire <= the
               full-resync wire); then ``run_membership_harness`` with a
               join, a leave and a down under rolling-crash and ring-cut,
               with quorum writes (no acked write lost, replay identical)
               and with direct writes (bit-equal to the static twin), at 256
               replicas (the staging default topology is a ring);
18. serve   — ``bench_scenarios.serve_load`` at 100,000 replicas with JAX's
               scenario parameters (10,000 clients, 40 ticks, 1,200 arrivals
               a tick, a x5 burst, 10,000 seed watches, 100,000 parity
               thresholds, seed 7) under the composite nemesis: no acked
               write lost after heal, threshold parity at 100,000 watches,
               typed sheds only; the host time of ``_backup_of``; the card's
               busy share over 8 fault-free cycles of 1,200 requests
               (``torch.profiler``); a ``ServeLoop`` with two client threads,
               every ticket terminal;
19. programs — ``bench_scenarios.riak_index_2i`` at 100,000 replicas on
               ``random_regular(100_000, 3)``: a total ``RiakIndexProgram``
               with auto views, the 16 views it registers (index specs over
               2 names x 8 values) and an ``ExampleKeylistProgram``, JAX's
               program sizes (two ``bool[64, 64]`` planes a row, ~13.9 GB
               for the 17 index views); 1,024 seeded events over 48 keys
               (80% put, 10% delete, 10% handoff) through ``process`` at
               ``crc32(key) % n``, filled views compacting through
               ``CapacityError``; convergence under the normal scheduler
               (K2); ``ring_coverage_execute`` over 4 shards equal to
               per-program ``execute``, a quorum execute over 3 rows and the
               plain host model; the grouped sweep's device activities at
               G=17 equal to G=1 (``torch.profiler``); events/s, process ms
               p50 / p99, compactions, rounds, sweep bytes and GB/s against
               the capability row's peak, peak memory;
20. session — the engine cell's population through ``Session``: the
               packed OR-Set (64 x 16 x 4), a G-Counter and a ``map`` edge over
               a 16-element G-Set, ``replicate(100_000, topology="random",
               fanout=3, seed=0, packed=True)``, 16 writers through
               ``update_batch``, ``run_to_convergence`` (K1); states bit-equal
               to a runtime built by hand on ``locality_order(random_regular(
               100_000, 3, seed=0))``, values equal to a single-store session;
               then ``nemesis`` (ring-cut soak, healed), ``quorum`` (a put and
               a get resolved), ``aae`` (one scrub), ``serve`` (a write done
               in one cycle) and ``register`` / ``process`` / ``execute``;
21. bridge  — a loopback ``BridgeServer`` on the card: ``bridge_throughput()``
               at JAX's defaults under the native and the Python ETF arm; a
               seeded stream of 20,000 requests over 1,024 variables (16 in
               each of riak_core's 64 partitions, ``ingest_storm``'s five
               kinds, one request in ten a 16-variable ``merge_batch``, the
               rest YCSB workload A's zipfian reads and updates) in
               durable mode, every response equal byte for byte to a CPU
               server's in this process, every variable read back equal after
               a restart on the same ``data_dir``; requests/s, p50 / p99 ms
               and the card's busy share over 2,000 requests;
22. scenarios — run between phases 3 and 4, before the runtimes that
               the kernels phase replays (about 12 GiB) are resident:
               ``frontier_sparse(n_replicas=100_000)``, ``many_vars(
               n_replicas=100_000, n_vars=128)``, ``packed_vs_dense()`` at
               JAX's 1,048,576 replicas (its dense arm peaks near 68 GiB;
               the peak reported) and
               ``roofline_workload()``, each with its
               own check, their K1 / K2 / K3 probes held at max_abs_err 0;
               ``partitioned_gossip`` / ``mesh_scale`` must raise
               ``NotImplementedError`` (sharding is not ported);
23. cli     — ``python -m lasp_tpu_torch.cli`` in subprocesses on the card:
               ``status`` (names the card), ``simulate``, ``scenario
               gset_1k``, ``roofline --export`` (``roofline_frac`` not null)
               and ``inspect`` of the checkpoint phase's map store, each
               output parsed as JSON;
24. adcounter — the north star, ``bench_scenarios.adcounter_10m`` at
               10,485,760 replicas (threshold 5): ``Store``, ``Graph``
               (union -> product -> filter), ``ReplicatedRuntime(packed=True)``,
               ``seed_increments``, ``register_trigger(builder=...)`` and
               ``converge_on_device``, one round warmed outside the clock; the
               scenario fails unless the live ads, active pairs and view
               totals equal the reference semantics and ``ads`` / ``active``
               have converged. A second full-size build converges under
               ``torch.profiler`` for the card's busy share, at the end of
               the run; both carry the flight ring (``flight_rounds`` 64);
25. kernels — each kernel timed at every distinct launch shape phases 3-24
               gave it (``cuda_gossip.SHAPES``, counts zeroed before each
               phase, read after; the shapes of phases 16-23 on seeded
               members of their layout), beside its bound, for its loss
               ``sum(count * (ms - bound_ms))``; at its widest shape also
               beside its plain version, its gather model and the host time
               per wrapper call; K1 at the adcounter's shapes on the
               adcounter's own topology, beside its plain version; K2's loss
               split by launch class; K2's and K3's masked shapes (the chaos
               soaks') apart, their bound counting one mask byte an edge
               read; and K1's column-slab sweep (slab widths against whole
               rows) at each of its shapes and at two shapes whose planes fit
               the L2. Every K2 and K3 shape is replayed once under
               ``torch.profiler`` before phase 24, which must show exactly one
               device kernel per wrapper call;
26. telemetry — ``telemetry.device_capability()`` names the card and gives
               the peak every bound of the script reads; the kernel cost
               ledger's families and records after every earlier phase, its
               bytes for K1, K2 and K3 at their widest shapes equal to the
               kernels phase's gather model (row moves), its achieved share
               of peak beside the kernels phase's; the north star's flight
               ring: the timed run's windows 9 rounds, the profiled twin's
               window equal round for round to a third build's unfused
               ``step`` residuals, states bit-equal; ``measure_overhead``'s
               arms against JAX's 5% budget (reported, never failing).

Prints the card's name and power limit, one JSON line of kernels, and as
the last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when CUDA is unavailable or anything fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np


def _log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


#: the card's name and power limit, as ``nvidia-smi`` gives them (set by main)
_CARD = None


def _log_line(phase: str, fields: dict) -> None:
    """A phase's JSON line, with the card's name and power limit beside its
    numbers."""
    _log(phase, json.dumps({"card": _CARD, **fields}))


#: clock cycles the card spins before a timed window (~0.5 s at H100 clocks)
_QUEUE_AHEAD_CYCLES = 1_000_000_000


def _time_ms(torch, fn, reps: int, spin_cycles: int = _QUEUE_AHEAD_CYCLES) -> float:
    """Mean device milliseconds per call over ``reps`` calls, by CUDA
    events, after one warm call. The card first spins on a sleep kernel
    while the host enqueues the whole window, so the events time the
    device's work and not the wrappers' host overhead (a kernel shorter
    than its wrapper's Python would otherwise be timed at the host's
    launch rate). Fails if the host took longer to enqueue than the card
    slept."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin = torch.cuda.Event()
    torch.cuda._sleep(spin_cycles)
    spin.record()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if spin.query():
        raise RuntimeError("timing window: the host enqueued slower than the card slept")
    end.synchronize()
    return start.elapsed_time(end) / reps


def _call_ms(torch, fn, reps: int) -> float:
    """Mean host milliseconds per call, wrapper overhead included: what a
    caller that waits for each result pays (host clock, synchronized)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _max_abs_err(torch, got, want) -> int:
    """The largest absolute difference over the leaves (bool leaves: 0 or
    1), taken a slice of rows at a time: an int64 copy of a whole wide
    output would take gigabytes."""
    err = 0
    for g, w in zip(got, want):
        if not g.numel():
            continue
        if g.dtype == torch.bool:
            err = max(err, int((g != w).any()))
            continue
        step = max(1, (1 << 26) // max(1, g[0].numel()))
        for i in range(0, g.shape[0], step):
            err = max(err, int((g[i:i + step].to(torch.int64)
                                - w[i:i + step].to(torch.int64)).abs().max()))
    return err


def _parity_k1(torch, cg, words, gen) -> int:
    """K1 against its plain version on every path of its schedule: narrow
    rows in one slab (R not a multiple of any block size; K in {2, 3, 8};
    D in {2, 3, 6}), then column slabs with D in {1024, 1026, 1027} (16-,
    8- and 4-byte loads, a narrower last slab) at R = 1,003 and R = 65,536
    with K in {1, 3, 8}. Each shape runs into new buffers and into given
    ``out=`` buffers; both sides of the schedule must be taken."""
    widths = set()
    cases = [(1003, 2, 2), (1003, 8, 2), (517, 3, 3), (515, 3, 6),
             (1003, 3, 1024), (1003, 8, 1024),
             *((65_536, k, d) for d in (1024, 1026, 1027) for k in (1, 3, 8))]
    for r, k, d in cases:
        ex, rm = words(r, d), words(r, d)
        nb = torch.randint(0, r, (r, k), dtype=torch.int32, device="cuda",
                           generator=gen)
        out = (torch.empty_like(ex), torch.empty_like(rm))
        want = cg.gossip_round_dense_plain(ex, rm, nb)
        before = set(cg.SHAPES["gossip_round_dense"])
        got = cg.gossip_round_dense(ex, rm, nb)
        got2 = cg.gossip_round_dense(ex, rm, nb, out=out)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) and torch.equal(g2, w)
                   for g, g2, w in zip(got, got2, want)):
            raise RuntimeError(f"K1 disagrees with its plain version at R={r} K={k} D={d}")
        if got2[0].data_ptr() != out[0].data_ptr():
            raise RuntimeError("K1 out= buffers not honoured")
        widths |= {key[3] < d for key in set(cg.SHAPES["gossip_round_dense"]) - before}
    if widths != {False, True}:
        raise RuntimeError("K1 parity did not take both whole rows and column slabs")
    return len(cases)


def phase_parity(torch, cg) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def words(*shape):
        return torch.randint(
            -2**31, 2**31 - 1, shape, dtype=torch.int32, device="cuda",
            generator=gen,
        )

    _log("parity", f"K1 gossip_round_dense: {_parity_k1(torch, cg, words, gen)} "
                   "shapes bit-identical to plain (whole rows and column slabs)")

    _log("parity", f"K2 gossip_round_rows: {_parity_k2(torch, cg, gen)} cases "
                   "bit-identical to plain (rows and changed flags) on every "
                   "vector path, team width and member kind")
    _log("parity", f"K3 gossip_round_rows_vclock: {_parity_k3(torch, cg, gen)} "
                   "cases bit-identical to plain (clock, dots and changed flags); "
                   f"{_parity_k3_paths(torch, cg, gen)} more on the bulk, 4-byte "
                   "and column-chunked paths")
    k2, k3 = _parity_chaos_masks(torch, cg, gen)
    _log("parity", f"under chaos masks (~25% dead edges, one row with every edge "
                   f"dead): K2 {k2} cases on every path, K3 {k3} cases on the bulk, "
                   "4-byte and column-chunked paths, bit-identical to plain")


def _parity_k2(torch, cg, gen) -> int:
    """K2 against its plain version on every path of its schedule
    (``rows_paths.K2_PATHS``: 16-, 8-, 4- and 1-byte vectors, teams of 1 to
    32 lanes, rows walked by the team), at G in {1, 16, 70} (70: above the
    launcher's 64-member table), K in {1, 3, 5, 8} (5 and 8: above
    ``kFanoutChunk``), masked and unmasked, buckets of 5, 16 and 33 slots
    with a duplicate pad, int64 and int32 rows, and four kinds of member
    (stacked, unbind views, clones, misaligned copies). Each path's schedule
    is checked, and every vector width and every team width must be
    taken."""
    from lasp_tpu_torch.ops import rows_paths as rp

    r = 500
    cases = 0
    taken = set()
    fields = cg.SHAPE_FIELDS["gossip_round_rows"]
    for path, (_dtype, op, _row, _n, vec, team) in rp.K2_PATHS.items():
        sched = tuple(cg.rows_schedule(rp.row_bytes(path), 16))
        if sched != (vec, team):
            raise RuntimeError(f"K2 schedule at {path}: {sched}")
        for g in (1, 16, 70):
            leaves = rp.k2_leaves(path, g, r, gen)
            kinds = {kind: [rp.k2_members(x, kind) for x in leaves]
                     for kind in rp.MEMBER_KINDS}
            for k in (1, 3, 5, 8):
                nb = torch.randint(0, r, (r, k), dtype=torch.int32, device="cuda",
                                   generator=gen)
                for masked in (False, True):
                    mask = (torch.rand((r, k), device="cuda", generator=gen) > 0.4
                            if masked else None)
                    for bucket in (5, 16, 33):
                        rows = torch.randint(0, r, (g, bucket), device="cuda",
                                             generator=gen)
                        rows[:, -1] = rows[:, 0]  # a duplicate pad slot
                        want, ch_w = cg.gossip_round_rows_plain(op, leaves, nb, rows, mask)
                        for kind, members in kinds.items():
                            for rr in (rows, rows.int()):
                                before = set(cg.SHAPES["gossip_round_rows"])
                                got, ch = cg.gossip_round_rows(op, members, nb, rr, mask)
                                torch.cuda.synchronize()
                                if not (all(torch.equal(a, b) for a, b in zip(got, want))
                                        and ch.dtype == torch.bool
                                        and torch.equal(ch, ch_w)):
                                    raise RuntimeError(
                                        f"K2 disagrees with its plain version: {path} "
                                        f"G={g} K={k} masked={masked} bucket={bucket} "
                                        f"members={kind} rows={rr.dtype}")
                                for key in set(cg.SHAPES["gossip_round_rows"]) - before:
                                    taken.add((key[fields.index("vec_bytes")],
                                               key[fields.index("team_lanes")]))
                                cases += 1
            del leaves, kinds
    if ({v for v, _t in taken} != {16, 8, 4, 1}
            or {t for _v, t in taken} != {1, 2, 4, 8, 16, 32}):
        raise RuntimeError(f"K2 parity did not take every vector and team width: "
                           f"{sorted(taken)}")
    return cases


def _parity_chaos_masks(torch, cg, gen) -> tuple:
    """K2 on every path of ``rows_paths.K2_PATHS`` and K3 on each path of
    ``rows_paths.K3_PATHS`` under a chaos-style mask (``rows_paths.
    chaos_mask``: about a quarter of the edges dead, and row 1 with every
    edge dead, which each member's rows name), G in {1, 16}, K in {3, 5},
    stacked members and member lists, against the plain versions. The
    all-dead row must report no change."""
    from lasp_tpu_torch.ops import rows_paths as rp

    r, k2, k3 = 500, 0, 0
    for path, (_dtype, op, *_rest) in rp.K2_PATHS.items():
        for g in (1, 16):
            leaves = rp.k2_leaves(path, g, r, gen)
            for k in (3, 5):
                nb = torch.randint(0, r, (r, k), dtype=torch.int32, device="cuda",
                                   generator=gen)
                mask = rp.chaos_mask(r, k, gen)
                rows = torch.randint(0, r, (g, 33), device="cuda", generator=gen)
                rows[:, 1] = 1
                want, ch_w = cg.gossip_round_rows_plain(op, leaves, nb, rows, mask)
                for kind in ("stacked", "views"):
                    members = [rp.k2_members(x, kind) for x in leaves]
                    got, ch = cg.gossip_round_rows(op, members, nb, rows, mask)
                    torch.cuda.synchronize()
                    if not (all(torch.equal(a, b) for a, b in zip(got, want))
                            and torch.equal(ch, ch_w) and not ch[:, 1].any()):
                        raise RuntimeError(f"K2 disagrees with its plain version under "
                                           f"a chaos mask: {path} G={g} K={k} {kind}")
                    k2 += 1
    for path, (a, e, r3) in rp.K3_PATHS.items():
        for g in (1, 16):
            clock = torch.randint(0, 7, (g, r3, a), dtype=torch.int32, device="cuda",
                                  generator=gen)
            dots = torch.randint(0, 7, (g, r3, e, a), dtype=torch.int32, device="cuda",
                                 generator=gen)
            for k in (3, 5):
                nb = torch.randint(0, r3, (r3, k), dtype=torch.int32, device="cuda",
                                   generator=gen)
                mask = rp.chaos_mask(r3, k, gen)
                rows = torch.randint(0, r3, (g, 33), device="cuda", generator=gen)
                rows[:, 1] = 1
                want, ch_w = cg.gossip_round_rows_vclock_plain(clock, dots, nb, rows, mask)
                for c, d in ((clock, dots), (list(clock.unbind(0)), list(dots.unbind(0)))):
                    got, ch = cg.gossip_round_rows_vclock(c, d, nb, rows, mask)
                    torch.cuda.synchronize()
                    if not (all(torch.equal(x, y) for x, y in zip(got, want))
                            and torch.equal(ch, ch_w) and not ch[:, 1].any()):
                        raise RuntimeError(f"K3 disagrees with its plain version under "
                                           f"a chaos mask: {path} G={g} K={k}")
                    k3 += 1
            del clock, dots
    return k2, k3


def _vclock_case(torch, cg, gen, clock, dots, k, masked, bucket, label) -> None:
    """One K3 launch against its plain version on random data (both skip
    dead edges, so any data will do), with a duplicate row slot, on int64
    and int32 rows."""
    g, r = len(clock), clock[0].shape[0]
    nb = torch.randint(0, r, (r, k), dtype=torch.int32, device="cuda", generator=gen)
    mask = torch.rand((r, k), device="cuda", generator=gen) > 0.4 if masked else None
    rows = torch.randint(0, r, (g, bucket), device="cuda", generator=gen)
    rows[:, -1] = rows[:, 0]
    want, ch_w = cg.gossip_round_rows_vclock_plain(clock, dots, nb, rows, mask)
    for rr in (rows, rows.int()):
        got, ch = cg.gossip_round_rows_vclock(clock, dots, nb, rr, mask)
        torch.cuda.synchronize()
        if not (all(torch.equal(x, y) for x, y in zip(got, want))
                and ch.dtype == torch.bool and torch.equal(ch, ch_w)):
            raise RuntimeError(f"K3 disagrees with its plain version: {label} K={k} "
                               f"masked={masked} bucket={bucket} rows={rr.dtype}")


def _parity_k3(torch, cg, gen) -> int:
    """K3 against its plain version: A x E x K x mask x bucket x G, random
    clocks and dots (both versions skip dead edges, so any data will do),
    duplicate rows; then the grouped wrapper with ``valid`` on the card
    against itself on the CPU, with one quiescent member whose slots are
    all invalid."""
    from lasp_tpu_torch.lattice import ORSWOT, ORSWOTState

    r = 1000
    cases = 0
    for a in (4, 16):
        for e in (8, 64):
            for g in (1, 3, 16):
                clock = torch.randint(0, 7, (g, r, a), dtype=torch.int32,
                                      device="cuda", generator=gen)
                dots = torch.randint(0, 7, (g, r, e, a), dtype=torch.int32,
                                     device="cuda", generator=gen)
                dots = dots * (torch.rand((g, r, e, 1), device="cuda",
                                          generator=gen) < 0.5)
                if g > 1:  # a quiescent member: every replica holds one state
                    clock[-1] = clock[-1, :1]
                    dots[-1] = dots[-1, :1]
                for k in (2, 3, 8):
                    nb = torch.randint(0, r, (r, k), dtype=torch.int32,
                                       device="cuda", generator=gen)
                    for masked in (False, True):
                        mask = (torch.rand((r, k), device="cuda", generator=gen) > 0.4
                                if masked else None)
                        for bucket in (5, 16, 33):
                            rows = torch.randint(0, r, (g, bucket), device="cuda",
                                                 generator=gen)
                            rows[:, -1] = rows[:, 0]  # a duplicate pad slot
                            got, ch = cg.gossip_round_rows_vclock(
                                clock, dots, nb, rows, mask)
                            want, ch_w = cg.gossip_round_rows_vclock_plain(
                                clock, dots, nb, rows, mask)
                            torch.cuda.synchronize()
                            if not (all(torch.equal(x, y) for x, y in zip(got, want))
                                    and torch.equal(ch, ch_w)):
                                raise RuntimeError(
                                    f"K3 disagrees with its plain version: A={a} "
                                    f"E={e} K={k} G={g} masked={masked} "
                                    f"bucket={bucket}")
                            cases += 1
                if g > 1:
                    valid = torch.ones((g, 33), dtype=torch.bool, device="cuda")
                    valid[-1] = False
                    valid[0, 20:] = False
                    st = ORSWOTState(clock, dots)
                    got_s, got_c = cg.cuda_gossip_round_rows_grouped(
                        ORSWOT, None, st, nb, rows, valid, mask)
                    want_s, want_c = cg.cuda_gossip_round_rows_grouped(
                        ORSWOT, None, ORSWOTState(clock.cpu(), dots.cpu()),
                        nb.cpu(), rows.cpu(), valid.cpu(),
                        None if mask is None else mask.cpu())
                    if not (all(torch.equal(x.cpu(), y) for x, y in zip(got_s, want_s))
                            and torch.equal(got_c.cpu(), want_c)):
                        raise RuntimeError(f"K3 grouped round disagrees at G={g}")
                    if got_c[-1].any() or not (torch.equal(got_s.clock[-1], clock[-1])
                                               and torch.equal(got_s.dots[-1], dots[-1])):
                        raise RuntimeError("K3: the all-invalid quiescent member moved")
                    cases += 1
    return cases


def _parity_k3_paths(torch, cg, gen) -> int:
    """K3 on each path of its ring, against its plain version: A = 3 (the
    4-byte cp.async path), A = 16 (bulk copies) and E = 512, A = 64 (dots
    rows wider than a stage, staged in column chunks), each at G in {1, 16,
    70} (70: above the launcher's 64-member table), K in {1, 3, 8}, masked
    and unmasked, F in {1, 33}; then 16-byte-aligned actors on members that
    are not 16-byte aligned (the 4-byte path). The schedule each case takes
    is checked."""
    from lasp_tpu_torch.ops import rows_paths as rp

    cases = 0
    for a, e, r in rp.K3_PATHS.values():
        for g in (1, 16, 70):
            clock = torch.randint(0, 7, (g, r, a), dtype=torch.int32,
                                  device="cuda", generator=gen)
            dots = torch.randint(0, 7, (g, r, e, a), dtype=torch.int32,
                                 device="cuda", generator=gen)
            dots = dots * (torch.rand((g, r, e, 1), device="cuda", generator=gen) < 0.5)
            members = (list(clock.unbind(0)), list(dots.unbind(0)))
            for k in (1, 3, 8):
                sched = cg.vclock_launch_schedule(*members, k)
                if sched.bulk != (a % 4 == 0) or (e == 512 and sched.chunk_words >= e * a):
                    raise RuntimeError(f"K3 schedule {sched} at A={a} E={e} K={k}")
                for masked in (False, True):
                    for bucket in (1, 33):
                        _vclock_case(torch, cg, gen, *members, k, masked, bucket,
                                     f"A={a} E={e} G={g}")
                        cases += 1
            del clock, dots, members
    for g in (1, 3):  # members 4 bytes off a 16-byte boundary
        r, e, a = 1000, 64, 16
        cbuf = torch.randint(0, 7, (g * r * a + 1,), dtype=torch.int32, device="cuda",
                             generator=gen)
        dbuf = torch.randint(0, 7, (g * r * e * a + 1,), dtype=torch.int32,
                             device="cuda", generator=gen)
        clock = list(cbuf[1:].view(g, r, a).unbind(0))
        dots = list(dbuf[1:].view(g, r, e, a).unbind(0))
        if cg.vclock_launch_schedule(clock, dots, 3).bulk:
            raise RuntimeError("K3 took bulk copies from misaligned members")
        for masked in (False, True):
            _vclock_case(torch, cg, gen, clock, dots, 3, masked, 33,
                         f"misaligned G={g}")
            cases += 1
    return cases


def _engine(torch, n, nbrs):
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime
    from lasp_tpu_torch.store import Store

    store = Store(n_actors=16)
    ads = store.declare(id="ads", type="lasp_orset", n_elems=64, n_actors=16,
                        tokens_per_actor=4)
    views = store.declare(id="views", type="riak_dt_gcounter", n_actors=16)
    rt = ReplicatedRuntime(store, Graph(store), n, nbrs, packed=True)
    writers = np.random.RandomState(5).choice(n, 16, replace=False)
    expected = set()
    ops = []
    for a, r in enumerate(writers):
        mine = [f"ad{(a * 4 + j) % 64}" for j in range(4)]
        ops.append((int(r), ("add_all", mine), f"w{a}"))
        if a % 4 == 0:  # the writer withdraws its first ad again
            ops.append((int(r), ("remove", mine[0]), f"w{a}"))
            mine = mine[1:]
        expected.update(mine)
    rt.update_batch(ads, ops)
    rt.update_batch(views, [(int(r), ("increment", a + 1), f"w{a}")
                            for a, r in enumerate(writers)])
    return rt, (ads, views), expected, sum(range(1, 17))


#: the plan cell's variable kinds, cycled over v0..v47 (the JAX package's
#: ``bench_scenarios.many_vars`` schedule)
_PLAN_KINDS = ("lasp_gset", "riak_dt_gcounter", "riak_dt_orswot")


def _plan_twin(n, nbrs, plan):
    """A ``Store(n_actors=16)`` of 48 variables over ``n`` replicas, written
    with ``update_batch`` from ``RandomState(23)``: each variable at 16
    distinct rows, row i by actor ``w{i}``; ``v0`` also takes adds at
    ``n // 8`` hot rows. Returns ``(runtime, ids, expected coverage)``.

    The plan cell keeps this population beside ``bench_scenarios.
    many_vars_runtime``'s because it checks what that one has not: each
    variable's coverage value against a known answer (16 writers, OR-SWOT
    removes), and K2 / K3 at 64-element, 16-actor rows (``many_vars``
    writes 16- and 8-element rows over 4 actors, one row a variable), the
    launch shapes this phase has held since it was added."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime
    from lasp_tpu_torch.store import Store

    store = Store(n_actors=16)
    ids = []
    for i in range(48):
        kind = _PLAN_KINDS[i % 3]
        caps = ({"n_elems": 64} if kind == "lasp_gset" else
                {"n_actors": 16} if kind == "riak_dt_gcounter" else
                {"n_elems": 64, "n_actors": 16})
        ids.append(store.declare(id=f"v{i}", type=kind, **caps))
    rt = ReplicatedRuntime(store, Graph(store), n, nbrs, plan=plan)
    rng = np.random.RandomState(23)
    expected = {}
    for j, v in enumerate(ids):
        kind = _PLAN_KINDS[j % 3]
        rows = rng.choice(n, 16, replace=False)
        if kind == "lasp_gset":
            ops = [(int(r), ("add", f"g{i}"), f"w{i}") for i, r in enumerate(rows)]
            expected[v] = {f"g{i}" for i in range(16)}
            if j == 0:  # the hot variable
                hot = rng.choice(n, n // 8, replace=False)
                ops += [(int(r), ("add", f"h{r % 48}"), f"h{r}") for r in hot]
                expected[v] |= {f"h{r % 48}" for r in hot}
        elif kind == "riak_dt_gcounter":
            ops = [(int(r), ("increment", i + 1), f"w{i}") for i, r in enumerate(rows)]
            expected[v] = sum(range(1, 17))
        else:
            ops, expected[v] = [], set()
            for i, r in enumerate(rows):
                mine = [f"e{2 * i}", f"e{2 * i + 1}"]
                ops.append((int(r), ("add_all", mine), f"w{i}"))
                if i % 4 == 0:  # the writer removes its first element again
                    ops.append((int(r), ("remove", mine[0]), f"w{i}"))
                    mine = mine[1:]
                expected[v].update(mine)
        rt.update_batch(v, ops)
    return rt, ids, expected


def _capture_rows_inputs(cg, rt, source: str, captured: dict) -> None:
    """Wrap ``rt._rows_round`` so that the first launch of each new K2 / K3
    launch shape (a key of ``cg.SHAPES``) leaves its inputs in ``captured``:
    ``(kernel, key) -> {"source", "var_ids", "rows", "mask", "neighbors"}``.
    The kernels phase replays them on the states of the runtime named
    ``source`` (on stand-ins of the launch's size after a resize)."""
    inner = rt._rows_round
    names = ("gossip_round_rows", "gossip_round_rows_vclock")

    def recording(var_ids, row_idx, mask):
        before = {n: set(cg.SHAPES[n]) for n in names}
        changed = inner(var_ids, row_idx, mask)
        for n in names:
            for key in set(cg.SHAPES[n]) - before[n]:
                captured.setdefault((n, key), {
                    "source": source, "var_ids": tuple(var_ids),
                    "rows": row_idx.clone(), "mask": mask,
                    "neighbors": rt.neighbors,
                })
        return changed

    rt._rows_round = recording


def _device_busy(torch, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: wall seconds (host clock,
    synchronized), device seconds (the CUDA kernels' and copies' own time)
    and the five device activities that took longest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the runtime's spans annotate the trace (``record_function``): their
    # device-side ranges are not device work
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_s": wall, "device_s": busy, "device_share": busy / wall,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top]}


def _shape_counts(cg) -> dict:
    return {n: dict(c) for n, c in cg.SHAPES.items()}


def phase_plan(torch, cg, n: int, captured: dict) -> dict:
    """Three twins of the 48-variable store: frontier with ``plan="off"``,
    frontier with ``plan="auto"`` and dense; then a fourth, ``plan="auto"``
    frontier twin converged under the profiler for the device's busy share.
    Returns what the kernels phase needs: the auto twin, the launches and
    the launch shapes."""
    from lasp_tpu_torch.mesh import random_regular

    nbrs = random_regular(n, 3, seed=23)
    runs, max_g = {}, {}
    cg.reset_launches()
    for label, plan, mode in (("off", "off", "frontier"), ("auto", "auto", "frontier"),
                              ("dense", "auto", "dense")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt, ids, expected = _plan_twin(n, nbrs, plan)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _capture_rows_inputs(cg, rt, "plan", captured)
        rounds = rt.run_to_convergence(mode=mode)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        runs[label] = {"rt": rt, "rounds": rounds, "seconds": t2 - t0,
                       "setup_s": t1 - t0, "converge_s": t2 - t1}
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    for name, fields in (("gossip_round_rows", cg.SHAPE_FIELDS["gossip_round_rows"]),
                         ("gossip_round_rows_vclock",
                          cg.SHAPE_FIELDS["gossip_round_rows_vclock"])):
        max_g[name] = max((key[fields.index("G")] for key in shapes[name]), default=0)
    off, auto, dense = runs["off"]["rt"], runs["auto"]["rt"], runs["dense"]["rt"]
    if not runs["off"]["rounds"] == runs["auto"]["rounds"] == runs["dense"]["rounds"]:
        raise RuntimeError(f"plan: round counts differ: "
                           f"{ {k: v['rounds'] for k, v in runs.items()} }")
    if off.round_residuals != auto.round_residuals:
        raise RuntimeError("plan: per-round residuals differ between plan=off and auto")
    for v in ids:
        for other in (off, dense):
            if not all(torch.equal(a, b) for a, b in zip(auto.states[v], other.states[v])):
                raise RuntimeError(f"plan: states of {v} differ between twins")
        if auto.divergence(v) != 0:
            raise RuntimeError(f"plan: {v} did not converge")
        if auto.coverage_value(v) != expected[v]:
            raise RuntimeError(f"plan: coverage of {v} is {auto.coverage_value(v)!r}, "
                               f"expected {expected[v]!r}")
    describe = auto._ensure_plan().describe()
    del off, dense
    for label in ("off", "dense"):
        del runs[label]["rt"]
    probe, _ids, _expected = _plan_twin(n, nbrs, "auto")
    busy = _device_busy(torch, lambda: probe.run_to_convergence(mode="frontier"))
    del probe
    _log_line("plan", {
        "replicas": n, "vars": len(ids), "rounds": runs["auto"]["rounds"],
        "seconds": {k: v["seconds"] for k, v in runs.items()},
        "setup_s": {k: v["setup_s"] for k, v in runs.items()},
        "converge_s": {k: v["converge_s"] for k, v in runs.items()},
        "profiled_auto_converge": busy,
        "peak_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
        "residuals": auto.round_residuals, "describe": describe, "max_G": max_g,
    })
    if launches["gossip_round_rows_vclock"] == 0:
        raise RuntimeError("the plan phase never launched K3")
    for name, g in max_g.items():
        if g < 2:
            raise RuntimeError(f"the plan phase never launched {name} at G > 1")
    return {"rt": auto, "launches": launches, "shapes": shapes, "nbrs": nbrs}


def phase_baseline(torch, cg) -> dict:
    """BASELINE configs 2, 3 and 4 through their scenarios, each of which
    raises on its own reference check. Returns the phase's launches and
    launch shapes."""
    from lasp_tpu_torch.bench_scenarios import gset_1k, orset_100k, pipeline_1m

    cg.reset_launches()
    lines = {}
    for name, fn, keys in (
            ("gset_1k", gset_1k, ("union_size", "intersection_size")),
            ("orset_100k", orset_100k, ("merges_per_sec", "state_bytes_per_replica")),
            ("pipeline_1m", pipeline_1m, ("folded_count",))):
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        k1_before = cg.LAUNCHES["gossip_round_dense"]
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        lines[name] = {
            "scenario": out["scenario"], "rounds": out["rounds"],
            "seconds": out["seconds"], "scenario_wall_s": time.perf_counter() - t0,
            **{k: out[k] for k in keys},
            "peak_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
            "resident_before_GB": resident,
            "k1_launches": cg.LAUNCHES["gossip_round_dense"] - k1_before,
            "check": out["check"],
        }
    if lines["orset_100k"]["k1_launches"] == 0:
        raise RuntimeError("orset_100k never launched K1")
    _log_line("baseline", lines)
    return {"launches": dict(cg.LAUNCHES), "shapes": _shape_counts(cg)}


#: the ingest cell: BASELINE config 3's population under the JAX
#: ``ingest_storm`` defaults (which run it at 256 replicas)
_INGEST = {"n_replicas": 100_000, "n_vars": 128, "cycles": 6, "ops_per_cycle": 2048,
           "seed": 31}


def phase_ingest(torch, cg, captured: dict) -> dict:
    """``ingest_storm`` at 100,000 replicas, then its schedule replayed into
    a dense, a frontier and a packed ``plan="auto"`` twin, converged: the
    rounds, the dense and frontier states bit for bit, every variable's
    coverage value across the three and divergence 0 must agree. Returns
    the launches, the launch shapes and the frontier twin (its captured K2
    / K3 launches are replayed in the kernels phase)."""
    from lasp_tpu_torch.bench_scenarios import (
        INGEST_KINDS, _ingest_schedule, ingest_storm, ingest_storm_runtime,
    )
    from lasp_tpu_torch.lattice.base import tree_leaves
    from lasp_tpu_torch.mesh import ingest

    c = _INGEST
    cg.reset_launches()
    t0 = time.perf_counter()
    storm = ingest_storm(c["n_replicas"], c["n_vars"], c["cycles"], c["ops_per_cycle"],
                         seed=c["seed"], reps=3, gate=None)
    torch.cuda.synchronize()
    storm_wall = time.perf_counter() - t0
    split = {}
    for plan, fns in (("off", ("_batch_begin", "_dispatch_batch", "_batch_finalize")),
                      ("auto", ("_batch_begin", "encode_batch", "apply_group",
                                "_batch_finalize"))):
        rt, ids = ingest_storm_runtime(c["n_replicas"], c["n_vars"], plan=plan,
                                       seed=c["seed"])
        schedule = _ingest_schedule(ids, INGEST_KINDS, c["n_replicas"], c["cycles"],
                                    c["ops_per_cycle"], c["seed"])
        split[plan] = _host_split(torch, lambda: [rt.ingest_cycle(x) for x in schedule], fns)
        del rt
    twins = {}
    schedule = None
    for label, mode, packed in (("dense", "dense", False), ("frontier", "frontier", False),
                                ("packed", "dense", True)):
        rt, ids = ingest_storm_runtime(c["n_replicas"], c["n_vars"], packed=packed,
                                       seed=c["seed"])
        if schedule is None:
            schedule = _ingest_schedule(ids, INGEST_KINDS, c["n_replicas"], c["cycles"],
                                        c["ops_per_cycle"], c["seed"])
        if label == "frontier":
            _capture_rows_inputs(cg, rt, "ingest", captured)
        applies = ingest.GROUP_APPLIES
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reports = [rt.ingest_cycle(cycle) for cycle in schedule]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dirty = sum(rt.frontier_size(v) for v in ids)
        rounds = rt.run_to_convergence(mode=mode)
        torch.cuda.synchronize()
        twins[label] = {"rt": rt, "rounds": rounds, "ingest_s": t2 - t1,
                        "converge_s": time.perf_counter() - t2, "dirty_rows": dirty,
                        "group_applies": ingest.GROUP_APPLIES - applies,
                        "dispatches": sum(r["dispatches"] for r in reports)}
    dense, front, packed = (twins[k]["rt"] for k in ("dense", "frontier", "packed"))
    kinds = {v: dense.store.variable(v).type_name for v in ids}
    ops_by_kind = Counter()
    for cycle in schedule:
        for v, ops in cycle.items():
            ops_by_kind[kinds[v]] += len(ops)
    if not twins["dense"]["rounds"] == twins["frontier"]["rounds"] == twins["packed"]["rounds"]:
        raise RuntimeError(f"ingest: round counts differ: "
                           f"{ {k: v['rounds'] for k, v in twins.items()} }")
    for v in ids:
        if not all(torch.equal(a, b) for a, b in zip(tree_leaves(dense.states[v]),
                                                     tree_leaves(front.states[v]))):
            raise RuntimeError(f"ingest: dense and frontier states differ on {v}")
        want = dense.coverage_value(v)
        if front.coverage_value(v) != want or packed.coverage_value(v) != want:
            raise RuntimeError(f"ingest: coverage of {v} differs between twins")
        if dense.divergence(v) or front.divergence(v) or packed.divergence(v):
            raise RuntimeError(f"ingest: {v} did not converge")
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    _log_line("ingest", {
        "scenario": storm["scenario"], "storm_wall_s": storm_wall,
        "vars_by_kind": dict(Counter(kinds.values())), "ops_by_kind": dict(ops_by_kind),
        "per_var_median_s": storm["timing"]["per_var"]["seconds"],
        "grouped_median_s": storm["timing"]["grouped"]["seconds"],
        "per_var_seconds_each": storm["timing"]["per_var"]["seconds_each"],
        "grouped_seconds_each": storm["timing"]["grouped"]["seconds_each"],
        "ingest_speedup": storm["ingest_speedup"], "group_applies": storm["dispatches"],
        "normalize_alloc_bytes": storm["normalize_alloc_bytes"],
        "twins": {k: {f: v[f] for f in v if f != "rt"} for k, v in twins.items()},
        "host_split_s (one cold drive, cProfile cumulative)": split,
        "peak_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
    })
    if launches["gossip_round_rows"] == 0 or launches["gossip_round_rows_vclock"] == 0:
        raise RuntimeError(f"the ingest twins never launched K2 and K3: {launches}")
    if launches["gossip_round_dense"] == 0:
        raise RuntimeError("the packed ingest twin never launched K1")
    del dense, packed
    return {"launches": launches, "shapes": shapes, "rt": front}


def _host_split(torch, fn, names) -> dict:
    """Run ``fn`` once under ``cProfile`` (synchronized after): its wall
    seconds and the cumulative seconds of the functions ``names`` (host
    time, device waits included where they block)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    out = {"wall": time.perf_counter() - t0}
    for (_file, _line, name), row in pstats.Stats(prof).stats.items():
        if name in names:
            out[name] = out.get(name, 0.0) + row[3]
    return out


def _same_populations(torch, a, b, what: str) -> None:
    """Fail unless two runtimes hold bit-equal populations."""
    for v in a.var_ids:
        if not all(torch.equal(x, y) for x, y in zip(a.states[v], b.states[v])):
            raise RuntimeError(f"{what}: states of {v} differ")


def phase_reads(torch, cg, n, nbrs) -> dict:
    """The parked reads and the fused-block handle on the engine's
    population, each against a twin that takes the host path. Returns the
    launches and launch shapes."""
    from lasp_tpu_torch.lattice import Threshold

    cg.reset_launches()
    line = {}
    # read_until: the G-Counter's total at a replica no writer sits at
    dev, ids, _expected, total = _engine(torch, n, nbrs)
    host, _, _, _ = _engine(torch, n, nbrs)
    ads, views = ids
    reader = int(np.flatnonzero(~dev._frontier[views])[0])
    t0 = time.perf_counter()
    row_d = dev.read_until(reader, views, Threshold(total))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    row_h = host.read_until(reader, views, Threshold(total), on_device=False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rounds = len(host.round_residuals)
    if not torch.equal(row_d.counts, row_h.counts) or int(row_d.counts.sum()) != total:
        raise RuntimeError("reads: read_until rows differ")
    _same_populations(torch, dev, host, "reads: read_until")
    if dev.round_residuals != [0] or min(host.round_residuals) <= 0:
        raise RuntimeError(f"reads: residuals {dev.round_residuals} / {host.round_residuals}")
    line["read_until"] = {"replica": reader, "rounds": rounds, "device_s": t1 - t0,
                          "host_probed_s": t2 - t1, "device_ms_per_round": (t1 - t0) / rounds * 1e3,
                          "host_ms_per_round": (t2 - t1) / rounds * 1e3}
    # read_any_until: the first writer's ads row or the counter total,
    # whichever reaches the reader first
    del dev, host
    a, _, _, _ = _engine(torch, n, nbrs)
    b, _, _, _ = _engine(torch, n, nbrs)
    writer = int(np.flatnonzero(a._frontier[ads])[0])
    want = a.read_at(writer, ads)
    reads = [(ads, Threshold(want)), (views, Threshold(total))]
    reader = int(np.flatnonzero(~a._frontier[ads] & ~a._frontier[views])[-1])
    t0 = time.perf_counter()
    var_a, row_a = a.read_any_until(reader, reads)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    var_b, row_b = b.read_any_until(reader, reads, on_device=False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if var_a != var_b or not all(torch.equal(x, y) for x, y in zip(row_a, row_b)):
        raise RuntimeError(f"reads: read_any_until gave {var_a} and {var_b}")
    _same_populations(torch, a, b, "reads: read_any_until")
    line["read_any_until"] = {"replica": reader, "first": var_a,
                              "rounds": len(b.round_residuals), "device_s": t1 - t0,
                              "host_probed_s": t2 - t1}
    # the fused-block handle with a cycle issued before finish(): writer w1
    # (``_engine``'s second writer, at its own row) adds back ad0, which w0
    # withdrew, and counts 7 more views
    w1 = int(np.random.RandomState(5).choice(n, 16, replace=False)[1])
    cycle = {ads: [(w1, ("add", "ad0"), "w1")], views: [(w1, ("increment", 7), "w1")]}
    t0 = time.perf_counter()
    handle = a.begin_fused_steps(8)
    enqueue_s = time.perf_counter() - t0
    a.ingest_cycle(cycle)
    first_a = handle.finish()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    first_b = b.fused_steps(8)
    b.ingest_cycle(cycle)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if first_a != first_b or handle.finish() != first_a:
        raise RuntimeError(f"reads: fused block returned {first_a} and {first_b}")
    _same_populations(torch, a, b, "reads: begin_fused_steps")
    line["fused_handle"] = {"first_quiescent": first_a, "enqueue_s": enqueue_s,
                            "begin_to_finish_s": t1 - t0, "fused_then_cycle_s": t2 - t1}
    _log_line("reads", line)
    return {"launches": dict(cg.LAUNCHES), "shapes": _shape_counts(cg)}


#: the map cell: the KVS-replica map (``riak_test/lasp_kvs_replica_test.erl``,
#: ``tests/apps/test_kvs_replica.py:319-375``) at BASELINE config 4's
#: population
_MAP = {"n_replicas": 1 << 20, "seed": 4, "writers": 8, "puts": 4000}
_KX, _KY = ("X", "lasp_gset"), ("Y", "riak_dt_gcounter")
_KT, _KZ, _KQ = ("T", "lasp_orset"), ("Z", "riak_dt_map"), ("q", "lasp_gset")


def _timed_step(torch, fn):
    """``(result, seconds)``: host clock, synchronized on both sides (the
    card's queue, where there is a card)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _batch_warnings(rt, var_id, ops) -> list:
    """``rt.update_batch(var_id, ops)``; returns the per-op path's warnings."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rt.update_batch(var_id, ops)
    return [str(w.message) for w in caught if "no vectorized kernel" in str(w.message)]


def phase_map(torch, cg) -> dict:
    """The KVS-replica map at 1,048,576 replicas through ``update_batch``,
    field admission, ``converge_on_device`` and ``compact_map_field``, each
    convergence checked against the value computed in plain Python from the
    ops. Returns the launches and
    launch shapes (maps ride no kernel: their rounds are plain PyTorch)."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.lattice.base import tree_leaves
    from lasp_tpu_torch.mesh import ReplicatedRuntime, random_regular
    from lasp_tpu_torch.store import Store

    c = _MAP
    n, w = c["n_replicas"], c["writers"]
    cg.reset_launches()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    store = Store(n_actors=w)
    m = store.declare(id="kvs", type="riak_dt_map", n_actors=w, reset_on_readd=True,
                      fields=[(_KX, "lasp_gset", {"n_elems": 16}),
                              (_KY, "riak_dt_gcounter", {})])
    rt = ReplicatedRuntime(store, Graph(store), n, random_regular(n, 3, seed=c["seed"]))
    steps = {}
    rng = np.random.RandomState(c["seed"])
    homes = [int(r) for r in rng.choice(n, w, replace=False)]
    xs, n_incr, live_t, zs = set(), 0, set(), set()

    def check(step: str) -> None:
        want = {_KX: frozenset(xs), _KY: n_incr, _KT: frozenset(live_t),
                _KZ: {_KQ: frozenset(zs)}}
        got = rt.coverage_value(m)
        if got != want:
            raise RuntimeError(f"map: after {step} the coverage value is {got!r}, "
                               f"expected {want!r}")
        if rt.divergence(m):
            raise RuntimeError(f"map: {m} did not converge at {step}")

    # 1. puts on X and Y: the vectorized map batch, no per-op warning
    ops = []
    for i in range(c["puts"]):
        a = int(rng.randint(w))
        if i % 3 == 0:
            ops.append((homes[a], ("update", _KY, ("increment",)), f"w{a}"))
            n_incr += 1
        else:
            x = f"k{rng.randint(16)}"
            ops.append((homes[a], ("update", _KX, ("add", x)), f"w{a}"))
            xs.add(x)
    warned, steps["puts"] = _timed_step(torch, lambda: _batch_warnings(rt, m, ops))
    if warned:
        raise RuntimeError(f"map: the X / Y puts left the vectorized batch: {warned}")
    # 2. adds, then removes, on the OR-Set field T (admitted by its first
    # batch): each writer adds four elements at its home row and removes two
    # of them there (it observed every token of its own elements)
    adds = [(homes[a], ("update", _KT, ("add", f"t{a}_{j}")), f"w{a}")
            for a in range(w) for j in range(4)]
    removes = [(homes[a], ("update", _KT, ("remove", f"t{a}_{j}")), f"w{a}")
               for a in range(w) for j in range(2)]
    live_t = {f"t{a}_{j}" for a in range(w) for j in (2, 3)}
    warned, steps["T_adds_then_removes"] = _timed_step(
        torch, lambda: _batch_warnings(rt, m, adds) + _batch_warnings(rt, m, removes))
    if len(warned) != 2:
        raise RuntimeError(f"map: the T batches did not take the per-op path: {warned}")
    # 3. a submap Z holding a G-Set, admitted mid-run (a re-layout at n rows)
    sub = [(homes[a], ("update", _KZ, ("update", _KQ, ("add", f"z{a}"))), f"w{a}")
           for a in range(w)]
    zs = {f"z{a}" for a in range(w)}
    fields_before = rt.states[m].dots.shape[-2]
    _, steps["Z_admission"] = _timed_step(torch, lambda: _batch_warnings(rt, m, sub))
    if rt.states[m].dots.shape[-2] != fields_before + 1:
        raise RuntimeError("map: the Z admission did not re-lay out the population")
    # 4. converge
    rounds1, steps["converge"] = _timed_step(torch, rt.converge_on_device)
    check("the first convergence")
    # 5. compact T, re-add into the freed slots, converge under the profiler
    got, steps["compact_map_field"] = _timed_step(
        torch, lambda: rt.compact_map_field(m, _KT))
    if got != 2 * w:
        raise RuntimeError(f"map: compact_map_field reclaimed {got}, expected {2 * w}")
    readds = [(homes[a], ("update", _KT, ("add", f"r{a}")), f"w{a}") for a in range(w)]
    live_t |= {f"r{a}" for a in range(w)}
    _, steps["T_readds"] = _timed_step(torch, lambda: _batch_warnings(rt, m, readds))
    t_elems = store.variable(m).map_aux[store.variable(m).spec.field_index(_KT)].elems
    if len(t_elems) != 3 * w:
        raise RuntimeError(f"map: T holds {len(t_elems)} interned elements, expected {3 * w}")
    rounds2 = [None]
    busy = _device_busy(torch, lambda: rounds2.__setitem__(0, rt.converge_on_device()))
    check("the re-adds' convergence")
    state_bytes = sum(x[0].numel() * x.element_size() for x in tree_leaves(rt.states[m]))
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    _log_line("map", {
        "replicas": n, "writers": w, "fields": [
            list(k) for k, _c, _s in store.variable(m).spec.fields],
        "state_bytes_per_replica": state_bytes,
        "steps_s": steps, "rounds": {"converge": rounds1, "after_readds": rounds2[0]},
        "converge_s_per_round": steps["converge"] / rounds1,
        "profiled_converge_after_readds": busy,
        "peak_allocated_GB_over_resident": torch.cuda.max_memory_allocated() / 1e9
        - resident, "resident_before_GB": resident,
    })
    del rt, store
    return {"launches": launches, "shapes": shapes}


#: the compaction cell: the engine's population
_COMPACTION_REPLICAS = 100_000


def phase_compaction(torch, cg) -> dict:
    """``compact_orset`` and ``compaction_window`` on the engine's
    population (packed OR-Set of 64 elements x 16 actors x 4 tokens, a
    G-Counter), converging through K1; values against the plain-Python
    expectation. Returns the launches and launch shapes."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, random_regular
    from lasp_tpu_torch.store import Store

    n = _COMPACTION_REPLICAS
    cg.reset_launches()
    store = Store(n_actors=16)
    ads = store.declare(id="ads", type="lasp_orset", n_elems=64, n_actors=16,
                        tokens_per_actor=4)
    views = store.declare(id="views", type="riak_dt_gcounter", n_actors=16)
    rt = ReplicatedRuntime(store, Graph(store), n, random_regular(n, 3, seed=0),
                           packed=True)
    homes = [int(r) for r in np.random.RandomState(0).choice(n, 16, replace=False)]
    rounds, secs = {}, {}

    def check(step: str, want: set) -> None:
        got = rt.coverage_value(ads)
        if got != want or rt.divergence(ads) or rt.divergence(views):
            raise RuntimeError(f"compaction: after {step} ads are {sorted(got)}, "
                               f"expected {sorted(want)}")

    # 1. the 16 writers add the 64 elements (4 each) and remove 2 of their own
    rt.update_batch(ads, [(homes[a], ("add_all", [f"ad{4 * a + j}" for j in range(4)]),
                           f"w{a}") for a in range(16)])
    rt.update_batch(ads, [(homes[a], ("remove_all", [f"ad{4 * a}", f"ad{4 * a + 1}"]),
                           f"w{a}") for a in range(16)])
    live = {f"ad{4 * a + j}" for a in range(16) for j in (2, 3)}
    # 2. converge through K1
    rounds["first"], secs["first_converge"] = _timed_step(
        torch, lambda: rt.run_to_convergence(mode="dense"))
    check("the first convergence", live)
    # 3. compact
    got, secs["compact_orset"] = _timed_step(torch, lambda: rt.compact_orset(ads))
    if got != 32 or len(store.variable(ads).elems) != 32:
        raise RuntimeError(f"compaction: compact_orset reclaimed {got}, expected 32")
    check("compact_orset", live)
    # 4. 32 fresh elements into the reclaimed slots, converge through K1
    rt.update_batch(ads, [(homes[a], ("add_all", [f"fresh{2 * a}", f"fresh{2 * a + 1}"]),
                           f"w{a}") for a in range(16)])
    live |= {f"fresh{i}" for i in range(32)}
    rounds["fresh"], secs["fresh_converge"] = _timed_step(
        torch, lambda: rt.run_to_convergence(mode="dense"))
    check("the fresh adds", live)
    # 5. the window: a builder-backed trigger removes ``ad2`` once the
    # counter reaches 16 (the adcounter server's pattern)
    threshold, target = 16, "ad2"

    def builder():
        (idx,) = rt.intern_terms(ads, [target])
        pick = (torch.arange(64, device=rt.device) == int(idx))[:, None]

        def trig(dense):
            st = dense[ads]
            fire = dense[views].counts.sum() >= threshold
            return {ads: st._replace(removed=st.removed | (st.exists & pick & fire))}

        return trig

    rt.register_trigger(builder=builder, touches=[ads, views])
    rt.update_batch(ads, [(homes[a], ("remove", f"fresh{2 * a}"), f"w{a}")
                          for a in range(16)])
    live -= {f"fresh{2 * a}" for a in range(16)}
    t0 = time.perf_counter()
    with rt.compaction_window() as win:
        torch.cuda.synchronize()
        secs["window_converge"] = time.perf_counter() - t0
        got2, secs["window_compact_orset"] = _timed_step(torch, lambda: win.compact_orset(ads))
    if got2 != 16 or len(rt._triggers) != 1:
        raise RuntimeError(f"compaction: the window reclaimed {got2}, expected 16")
    check("the window", live)
    rt.update_batch(views, [(homes[a], ("increment",), f"w{a}") for a in range(16)])
    rounds["after_window"], secs["after_window_converge"] = _timed_step(
        torch, rt.converge_on_device)
    live.discard(target)
    check("the rebuilt trigger's convergence", live)
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    if launches["gossip_round_dense"] == 0:
        raise RuntimeError("the compaction phase never launched K1")
    _log_line("compaction", {
        "replicas": n, "rounds": rounds, "seconds": secs,
        "reclaimed": [got, got2], "live": len(live),
        "k1_launches": launches["gossip_round_dense"],
    })
    del rt, store
    return {"launches": launches, "shapes": shapes}


#: the dataflow phase's ``dataflow_chain`` shapes: JAX's defaults, then 48
#: chains (both at depth 8)
_DATAFLOW_SHAPES = ((9, 8, 3), (48, 8, 3))


def phase_dataflow(torch, cg) -> dict:
    """``bench_scenarios.dataflow_chain`` on the card at each of
    ``_DATAFLOW_SHAPES``: the per-edge and fused propagate arms, equal
    rounds and bit-identical states (the scenario asserts both). Any
    ``RuntimeWarning`` (a fused group demoted or a fallback) fails the run.
    Returns the launches and launch shapes (store-level states: no gossip
    kernel runs)."""
    from lasp_tpu_torch.bench_scenarios import dataflow_chain

    cg.reset_launches()
    for n_chains, depth, reps in _DATAFLOW_SHAPES:
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            out = dataflow_chain(n_chains, depth, reps)
        if not out["device"].startswith("cuda"):
            raise RuntimeError(f"dataflow: ran on {out['device']}")
        t = out["timing"]
        _log_line("dataflow", {
            "scenario": out["scenario"], "rounds": out["rounds"],
            "fused_speedup": out["fused_speedup"], **{
                arm: {k: t[arm][k] for k in ("seconds", "seconds_each", "sweeps",
                                             "host_syncs")}
                for arm in ("per_edge", "fused")},
            "groups": out["plan"]["groups"],
            "edges_stacked": out["plan"]["edges_stacked"],
            "sweep_bytes": out["plan"]["sweep_bytes"],
        })
    return {"launches": dict(cg.LAUNCHES), "shapes": _shape_counts(cg)}


#: the membership cell: the engine's population
_MEMBERSHIP_REPLICAS = 100_000


def _membership_runtime(torch, n, converge: bool = True):
    """The engine's population with an OR-SWOT beside the packed OR-Set and
    the G-Counter, 16 writers at their home rows (``update_batch``),
    converged dense unless ``converge=False``. Returns ``(rt, ids, homes,
    expected)``."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, random_regular
    from lasp_tpu_torch.store import Store

    store = Store(n_actors=16)
    ids = (store.declare(id="ads", type="lasp_orset", n_elems=64, n_actors=16,
                         tokens_per_actor=4),
           store.declare(id="views", type="riak_dt_gcounter", n_actors=16),
           store.declare(id="tags", type="riak_dt_orswot", n_elems=64, n_actors=16))
    rt = ReplicatedRuntime(store, Graph(store), n, random_regular(n, 3, seed=0),
                           packed=True)
    homes = [int(r) for r in np.random.RandomState(5).choice(n, 16, replace=False)]
    expected = {"ads": set(), "views": 0, "tags": set()}
    rt.update_batch("ads", [(homes[a], ("add_all", [f"ad{2 * a}", f"ad{2 * a + 1}"]),
                             f"w{a}") for a in range(16)])
    rt.update_batch("ads", [(homes[a], ("remove", f"ad{2 * a}"), f"w{a}")
                            for a in range(0, 16, 4)])
    expected["ads"] = {f"ad{2 * a + 1}" for a in range(16)} | {
        f"ad{2 * a}" for a in range(16) if a % 4}
    first = [(homes[a], a, f"t{a}", a + 1) for a in range(16)]
    _membership_writes(rt, first)
    _expect(expected, first)
    if converge:
        rt.run_to_convergence(mode="dense")
    return rt, ids, homes, expected


def _membership_writes(rt, writes) -> None:
    """One batch per variable of ``(row, actor, tag, increment)`` writes:
    the actor increments the G-Counter and adds the tag to the OR-SWOT at
    the row."""
    rt.update_batch("views", [(r, ("increment", by), f"w{a}") for r, a, _t, by in writes])
    rt.update_batch("tags", [(r, ("add", t), f"w{a}") for r, a, t, _by in writes])


def _expect(expected, writes) -> None:
    expected["views"] += sum(by for *_x, by in writes)
    expected["tags"] |= {t for _r, _a, t, _by in writes}


def phase_membership(torch, cg, captured: dict, n: int = _MEMBERSHIP_REPLICAS) -> dict:
    """The row and membership primitives at the engine's population, on a
    frontier runtime and a dense twin that skips step 2's ``join_rows``:
    (1) ``reseed_row`` on 64 replicas; (2) 16 fresh writes, then
    ``join_rows`` broadcasting their ``quorum_read`` join into 4,096 rows of
    each variable (frontier: K2 and K3); (3) ``resize`` to 150,000; (4)
    writes at rows >= 100,000, then a graceful ``resize`` to 100,000; (5)
    tail writes, then a crash leave to 96,000 (only they are lost); (6)
    ``membership_grow`` to 100,000 with ``changed_delivery_rows``, then
    ``membership_drop_tail`` to 96,000. Each step converges (the runtime
    frontier, the twin dense); ``coverage_value`` must equal the
    plain-Python expectation and ``divergence`` be 0 on both after each, and
    the two fixed points must be bit-identical at the end. Returns the
    launches, launch shapes and the frontier runtime."""
    from lasp_tpu_torch.membership import changed_delivery_rows
    from lasp_tpu_torch.mesh import random_regular
    from lasp_tpu_torch.mesh.gossip import quorum_read

    big, small = n * 3 // 2, n * 24 // 25  # 150,000 and 96,000
    cg.reset_launches()
    rt, ids, homes, expected = _membership_runtime(torch, n)
    twin, _, _, _ = _membership_runtime(torch, n)
    _capture_rows_inputs(cg, rt, "membership", captured)
    secs, rounds, epochs = {}, {}, {}
    rng = np.random.RandomState(11)

    def converge(step: str) -> None:
        rounds[step], secs[f"{step}_converge"] = _timed_step(
            torch, lambda: rt.run_to_convergence(mode="frontier"))
        rounds[f"{step}_dense_twin"], secs[f"{step}_converge_dense_twin"] = _timed_step(
            torch, lambda: twin.run_to_convergence(mode="dense"))
        epochs[step] = rt.membership_epoch
        if twin.membership_epoch != rt.membership_epoch:
            raise RuntimeError(f"membership: epochs differ after {step}")
        want = {"ads": frozenset(expected["ads"]), "views": expected["views"],
                "tags": frozenset(expected["tags"])}
        for r in (rt, twin):
            for v in ids:
                got = r.coverage_value(v)
                if got != want[v] or r.divergence(v):
                    raise RuntimeError(f"membership: after {step} {v} is {got!r} "
                                       f"(divergence {r.divergence(v)}), expected "
                                       f"{want[v]!r}")

    # 1. reseed 64 replicas to bottom
    rows64 = [int(r) for r in rng.choice(n, 64, replace=False)]
    _, secs["reseed_row_x64"] = _timed_step(
        torch, lambda: [rt.reseed_row(r) for r in rows64])
    for r in rows64:
        twin.reseed_row(r)
    converge("reseed")
    # 2. fresh writes, then the quorum join broadcast into 4,096 rows
    fresh = [(homes[a], a, f"f{a}", 2) for a in range(16)]
    for r in (rt, twin):
        _membership_writes(r, fresh)
        r.update_batch("ads", [(homes[a], ("add", f"ad{32 + a}"), f"w{a}")
                               for a in range(16)])
    _expect(expected, fresh)
    expected["ads"] |= {f"ad{32 + a}" for a in range(16)}
    targets = rng.choice(n, min(4096, n // 2), replace=False)
    changed = {}

    def broadcast():
        for v in ids:
            codec, spec = rt._mesh_meta(v)
            top = quorum_read(codec, spec, rt.states[v], homes)
            changed[v] = rt.join_rows(v, targets, top)

    _, secs["join_rows_x3"] = _timed_step(torch, broadcast)
    before = dict(cg.LAUNCHES)
    converge("join_rows")
    if (cg.LAUNCHES["gossip_round_rows"] == before["gossip_round_rows"]
            or cg.LAUNCHES["gossip_round_rows_vclock"]
            == before["gossip_round_rows_vclock"]):
        raise RuntimeError(f"membership: the join_rows convergence launched "
                           f"{cg.LAUNCHES} (before: {before}): K2 or K3 missing")
    # 3. grow to 150,000
    nb_big = random_regular(big, 3, seed=1)
    _, secs["resize_grow"] = _timed_step(torch, lambda: rt.resize(big, nb_big))
    twin.resize(big, nb_big)
    converge("grow")
    # 4. writes at rows >= 100,000, then a graceful leave back to 100,000
    high = [(n + (big - n) * a // 16 + 7, a, f"h{a}", 3) for a in range(16)]
    for r in (rt, twin):
        _membership_writes(r, high)
        r.update_batch("ads", [(row, ("add", f"ad{48 + a}"), f"w{a}")
                               for row, a, _t, _b in high])
    _expect(expected, high)
    expected["ads"] |= {f"ad{48 + a}" for a in range(16)}
    back = random_regular(n, 3, seed=2)
    _, secs["resize_graceful"] = _timed_step(torch, lambda: rt.resize(n, back))
    twin.resize(n, back)
    converge("graceful_leave")
    # 5. tail writes, then a crash leave to 96,000: only they are lost
    tail = [(n - n // 100 + a, a, f"lost{a}", 100 + a) for a in range(8)]
    for r in (rt, twin):
        _membership_writes(r, tail)  # never gossiped: not expected
    nb_small = random_regular(small, 3, seed=3)
    _, secs["resize_crash"] = _timed_step(
        torch, lambda: rt.resize(small, nb_small, graceful=False))
    twin.resize(small, nb_small, graceful=False)
    converge("crash_leave")
    # 6. the staged commits: grow to 100,000 row-scoped, drop the tail again
    grown = random_regular(n, 3, seed=4)
    dirty = changed_delivery_rows(nb_small, grown, small, n)
    _, secs["membership_grow"] = _timed_step(
        torch, lambda: rt.membership_grow(n, grown, dirty_rows=dirty))
    twin.membership_grow(n, grown, dirty_rows=dirty)
    converge("membership_grow")
    shrunk = random_regular(small, 3, seed=5)
    dirty = changed_delivery_rows(grown, shrunk, n, small)
    _, secs["membership_drop_tail"] = _timed_step(
        torch, lambda: rt.membership_drop_tail(small, shrunk, dirty_rows=dirty))
    twin.membership_drop_tail(small, shrunk, dirty_rows=dirty)
    converge("membership_drop_tail")
    _same_populations(torch, rt, twin, "membership: the dense twin's fixed point")
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    if any(c == 0 for c in launches.values()):
        raise RuntimeError(f"membership: a kernel never launched: {launches}")
    _log_line("membership", {
        "replicas": n, "seconds": secs, "rounds": rounds, "membership_epoch": epochs,
        "join_rows_changed": changed, "launches": launches,
        "final_replicas": rt.n_replicas,
    })
    del twin
    return {"launches": launches, "shapes": shapes, "rt": rt, "ids": ids,
            "expected": expected}


def phase_checkpoint(torch, cg, rt, ids, captured: dict, keep: str,
                     big: int = 150_000) -> dict:
    """Checkpoints of the membership phase's population through the native
    host store (a fall-back to the Python log engine fails the run):
    ``save_runtime`` / ``load_runtime`` bit-equal; ``load_runtime_rows`` +
    ``reseed_row`` restores the saved row; an elastic ``load_runtime`` onto
    150,000 replicas converges to the same values; ``save_store`` /
    ``load_store`` of a reset-mode map store, a copy of whose file is left
    at ``keep`` (the cli phase inspects it). Returns the launches and launch
    shapes."""
    import os
    import shutil

    from lasp_tpu_torch.lattice.base import tree_leaves
    from lasp_tpu_torch.mesh import random_regular
    from lasp_tpu_torch.store import Store
    from lasp_tpu_torch.store.checkpoint import (
        load_runtime, load_runtime_rows, load_store, save_runtime, save_store)
    from lasp_tpu_torch.store.host_store import HostStore

    cg.reset_launches()
    secs, sizes = {}, {}
    values = {v: rt.coverage_value(v) for v in ids}

    with tempfile.TemporaryDirectory() as tmp:
        fs = subprocess.run(["stat", "-f", "-c", "%T", tmp], capture_output=True,
                            text=True, check=True).stdout.strip()
        path = os.path.join(tmp, "runtime.lasp")
        with HostStore(os.path.join(tmp, "probe.lasp")) as hs:
            if hs.backend != "native":
                raise RuntimeError(f"checkpoint: the host store runs {hs.backend}, "
                                   "not the native engine")
        # 1. save, load: bit-equal
        _, secs["save_runtime"] = _timed_step(torch, lambda: save_runtime(rt, path))
        sizes["runtime"] = os.path.getsize(path)
        loaded, secs["load_runtime"] = _timed_step(torch, lambda: load_runtime(path))
        _same_populations(torch, rt, loaded, "checkpoint: the loaded runtime")
        # 2. one row back from the file into a row gossip has not refilled
        r = rt.n_replicas // 3
        rows, secs["load_runtime_rows"] = _timed_step(
            torch, lambda: load_runtime_rows(path, r))
        rt.reseed_row(r)
        _, secs["reseed_row_from_rows"] = _timed_step(
            torch, lambda: rt.reseed_row(r, rows))
        _same_populations(torch, rt, loaded,
                          f"checkpoint: the runtime after restoring row {r}")
        del loaded
        # 3. elastic restore onto 150,000 replicas, converged: same values
        nb = random_regular(big, 3, seed=6)
        grown, secs["load_runtime_elastic"] = _timed_step(
            torch, lambda: load_runtime(path, n_replicas=big, neighbors=nb))
        # its K2 / K3 launches replay on the membership runtime's variables
        # (the same ones), on stand-ins of this population's size
        _capture_rows_inputs(cg, grown, "membership", captured)
        rounds, secs["elastic_converge"] = _timed_step(
            torch, lambda: grown.run_to_convergence(mode="frontier"))
        for v in ids:
            if grown.coverage_value(v) != values[v] or grown.divergence(v):
                raise RuntimeError(f"checkpoint: the elastic restore changed {v}")
        del grown
        # 4. a reset-mode map store
        store = Store(n_actors=4)
        m = store.declare(id="kvs", type="riak_dt_map", n_actors=4, reset_on_readd=True,
                          fields=[(_KX, "lasp_gset", {"n_elems": 16}),
                                  (_KY, "riak_dt_gcounter", {})])
        for i in range(8):
            store.update(m, ("update", [("update", _KX, ("add", f"k{i}")),
                                        ("update", _KY, ("increment",))]), f"w{i % 4}")
        store.update(m, ("update", [("remove", _KX)]), "w0")
        store.update(m, ("update", [("update", _KX, ("add", "back"))]), "w1")
        spath = os.path.join(tmp, "store.lasp")
        _, secs["save_store"] = _timed_step(torch, lambda: save_store(store, spath))
        sizes["store"] = os.path.getsize(spath)
        shutil.copyfile(spath, keep)
        got, secs["load_store"] = _timed_step(torch, lambda: load_store(spath))
        if got.value(m) != store.value(m) or not all(
                torch.equal(x, y) for x, y in zip(tree_leaves(got.state(m)),
                                                  tree_leaves(store.state(m)))):
            raise RuntimeError("checkpoint: the map store did not round-trip")
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    _log_line("checkpoint", {
        "replicas": rt.n_replicas, "elastic_replicas": big,
        "bytes_on_disk": sizes, "seconds": secs,
        "filesystem": fs, "elastic_rounds": rounds, "launches": launches,
    })
    return {"launches": launches, "shapes": shapes}


class _HostTime:
    """Host seconds and calls of functions wrapped for one measurement
    (``wrap`` returns the undo)."""

    def __init__(self):
        self.seconds = Counter()
        self.calls = Counter()

    def wrap(self, owner, name: str, label: str):
        inner = getattr(owner, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return inner(*a, **kw)
            finally:
                self.seconds[label] += time.perf_counter() - t0
                self.calls[label] += 1

        setattr(owner, name, timed)
        return lambda: setattr(owner, name, inner)

    def per_call_ms(self) -> dict:
        return {k: self.seconds[k] / self.calls[k] * 1e3 for k in self.calls}


def _launch_delta(cg, before: dict) -> dict:
    return {k: cg.LAUNCHES[k] - before[k] for k in cg.LAUNCHES}


#: the chaos and quorum phases' population (the engine's)
_CHAOS_REPLICAS = 100_000


def phase_chaos(torch, cg, captured: dict, sources: dict, n: int = _CHAOS_REPLICAS) -> dict:
    """(a) ``bench_scenarios.chaos_heal`` at ``n`` replicas with JAX's other
    defaults (fanout 3, seed 17, a 10-round ring-cut with a rolling crash,
    fused windows of 8, one degraded read with read-repair each faulty
    round), its healed states bit-equal to the fault-free twin's (the
    scenario raises otherwise); the host time of ``_reachable_live`` and of
    each degraded read. (b) Every preset of ``chaos.PRESETS`` over the
    membership phase's population, unconverged: ``soak(mode="frontier")``
    and ``soak(mode="dense")`` on twins must give the same per-round
    residuals, and both final states must be bit-equal to one fault-free
    fixed point; K1 / K2 / K3 launches per preset, and the host time of the
    dispatch plan's recompiles (a new mask object each round under
    flaky links invalidates the plan). The frontier twins stay in
    ``sources`` for the kernels phase."""
    import lasp_tpu_torch.mesh.runtime as rtmod
    from lasp_tpu_torch.bench_scenarios import chaos_heal
    from lasp_tpu_torch.chaos import PRESETS, ChaosRuntime, nemesis
    from lasp_tpu_torch.chaos.invariants import snapshot_states, states_equal

    # the check's fault-free fixed point, built before the count starts
    free, ids, _homes, expected = _membership_runtime(torch, n)
    free_rounds = len(free.round_residuals)
    free_states = snapshot_states(free)
    del free
    cg.reset_launches()
    host = _HostTime()
    undo = [host.wrap(ChaosRuntime, "_reachable_live", "reachable_live"),
            host.wrap(ChaosRuntime, "degraded_read", "degraded_read")]
    try:
        heal = chaos_heal(n_replicas=n)
    finally:
        for u in undo:
            u()
    torch.cuda.synchronize()
    heal_launches = dict(cg.LAUNCHES)
    _log_line("chaos", {"part": "chaos_heal", **{k: heal[k] for k in (
        "scenario", "rounds", "rounds_to_heal", "healed", "crashes", "restores",
        "degraded_reads", "repaired_rows", "repair_bytes", "fused_windows",
        "fused_rounds", "stepped_rounds", "residual_syncs", "seconds",
        "fault_free_seconds", "fault_free_rounds", "check")},
        "host_ms_per_call": host.per_call_ms(), "launches": heal_launches})
    if not heal["healed"] or heal["degraded_reads"] == 0 or heal["fused_windows"] == 0:
        raise RuntimeError(f"chaos: chaos_heal did not exercise its path: {heal}")

    presets = {}
    for preset in PRESETS:
        before = dict(cg.LAUNCHES)
        runs = {}
        for mode in ("frontier", "dense"):
            rt, _ids, _h, _e = _membership_runtime(torch, n, converge=False)
            if mode == "frontier":
                source = f"chaos {preset}"
                _capture_rows_inputs(cg, rt, source, captured)
                sources[source] = rt
            ch = ChaosRuntime(rt, nemesis(preset, n, rt._host_neighbors, seed=9))
            rt.round_residuals.clear()
            plan_time = _HostTime()
            undo = plan_time.wrap(rtmod, "compile_plan", "compile_plan")
            mode_before = dict(cg.LAUNCHES)
            try:
                rep, secs = _timed_step(torch, lambda: ch.soak(mode=mode))
            finally:
                undo()
            runs[mode] = {
                "rounds": rep["rounds"], "rounds_to_heal": rep["rounds_to_heal"],
                "seconds": secs, "residuals": list(rt.round_residuals),
                "launches": _launch_delta(cg, mode_before),
                "plan_compiles": plan_time.calls["compile_plan"],
                "plan_compile_ms_per_round": (
                    plan_time.seconds["compile_plan"] / rep["rounds"] * 1e3),
                "duplicates_suppressed": rep["duplicates_suppressed"],
                "crashes": rep["crashes"],
            }
            if not rep["healed"] or not states_equal(snapshot_states(rt), free_states):
                raise RuntimeError(f"chaos: {preset} {mode} soak did not heal to the "
                                   "fault-free fixed point")
            for v in ids:
                if rt.coverage_value(v) != expected[v]:
                    raise RuntimeError(f"chaos: {preset} {mode}: {v} has the wrong value")
            if mode == "dense":
                del rt, ch
        if runs["frontier"]["residuals"] != runs["dense"]["residuals"]:
            raise RuntimeError(f"chaos: {preset}: frontier and dense residuals differ: "
                               f"{runs}")
        presets[preset] = {"launches": _launch_delta(cg, before), **runs}
        _log_line("chaos", {"part": "preset", "preset": preset, "replicas": n,
                            "fault_free_rounds": free_rounds, **presets[preset]})
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    masked = {name: sum(c for key, c in shapes[name].items()
                        if key[cg.SHAPE_FIELDS[name].index("masked")])
              for name in ("gossip_round_rows", "gossip_round_rows_vclock")}
    if any(c == 0 for c in masked.values()):
        raise RuntimeError(f"chaos: no masked K2 / K3 launch in the soaks: {masked}")
    _log("chaos", f"launches {launches}; masked K2 / K3 launches {masked}")
    return {"launches": launches, "shapes": shapes, "heal": heal, "presets": presets,
            "masked_launches": masked}


def phase_quorum(torch, cg, n: int = _CHAOS_REPLICAS) -> dict:
    """``bench_scenarios.quorum_kv`` at ``n`` replicas (8 client rounds of 24
    puts and 24 degraded gets) under every chaos preset at JAX's N=3, R=W=2,
    timeout 4, retries 4: no acked write lost and every request resolved
    (the scenario raises otherwise); then ``rolling-crash`` again with the
    sequential engine, whose final states, protocol trace and results must
    equal the batched run's."""
    from lasp_tpu_torch.bench_scenarios import quorum_kv

    cg.reset_launches()
    kw = dict(n_replicas=n, client_rounds=8, puts_per_round=24, gets_per_round=24)
    out, secs = _timed_step(torch, lambda: quorum_kv(**kw))
    batched = out["presets"]
    for preset, rec in batched.items():
        if rec["completed"] + rec["failed"] != rec["requests"] or not rec["no_write_lost"]:
            raise RuntimeError(f"quorum: {preset}: {rec}")
        _log_line("quorum", {"preset": preset, "replicas": n, "engine": "batched",
                             **rec})
    seq = quorum_kv(presets=("rolling-crash",), engine="sequential", **kw)
    s, b = seq["presets"]["rolling-crash"], batched["rolling-crash"]
    same = [k for k in b if k not in ("seconds", "fsm_seconds")]
    if any(s[k] != b[k] for k in same):
        raise RuntimeError(f"quorum: the sequential engine differs from the batched "
                           f"one: {s} against {b}")
    _log_line("quorum", {"preset": "rolling-crash", "engine": "sequential",
                         "seconds": s["seconds"], "fsm_seconds": s["fsm_seconds"],
                         "equal_to_batched": same})
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    _log("quorum", f"all presets in {secs:.3f} s; launches {launches}")
    return {"launches": launches, "shapes": shapes, "presets": batched,
            "sequential": s}


def _capture_rows_shapes(cg, captured: dict, phase: str):
    """For the phases whose runtimes live inside a scenario or a verb, and
    the scenarios' kernel probes (which call ``cg.rows_round`` themselves):
    wrap ``cg.rows_round`` so that the first launch of each new K2 / K3
    shape leaves in ``captured`` its rows, mask, neighbour table, kernel
    plan and member layout — not the members themselves (the rebalance
    phase's populations take gigabytes). The kernels phase replays such a
    shape on seeded members of that layout (``_synthetic_members``).
    Returns the undo."""
    import torch

    inner = cg.rows_round
    names = ("gossip_round_rows", "gossip_round_rows_vclock")

    def recording(plan, leaves, neighbors, rows, edge_mask=None):
        before = {n: set(cg.SHAPES[n]) for n in names}
        out = inner(plan, leaves, neighbors, rows, edge_mask)
        for n in names:
            for key in set(cg.SHAPES[n]) - before[n]:
                if (n, key) in captured:
                    continue
                # each leaf a [G, R, ...] tensor or its G member tensors
                g = (leaves[0].shape[0] if isinstance(leaves[0], torch.Tensor)
                     else len(leaves[0]))
                layout = tuple((tuple(leaf[0].shape), leaf[0].dtype) for leaf in leaves)
                captured[(n, key)] = {
                    "source": None, "phase": phase,
                    "rows": rows.clone(), "mask": edge_mask, "neighbors": neighbors,
                    "synthetic": {"plan": plan, "key": (g, layout)},
                }
        return out

    cg.rows_round = recording
    return lambda: setattr(cg, "rows_round", inner)


#: the seeded members of one synthetic layout: (key, members)
_SYNTH = [None, None]


def _synthetic_members(torch, syn) -> list:
    """``G`` members of the captured layout, made from a seed on the card
    (random bits, small random integers). One layout is kept at a time."""
    if _SYNTH[0] != syn["key"]:
        _SYNTH[:] = [None, None]
        g, layout = syn["key"]
        gen = torch.Generator(device="cuda").manual_seed(13)
        members = []
        for _ in range(g):
            members.append(tuple(
                torch.randint(0, 2, shape, device="cuda", generator=gen).bool()
                if dtype == torch.bool else
                torch.randint(0, 1 << 12, shape, dtype=dtype, device="cuda",
                              generator=gen)
                for shape, dtype in layout))
        _SYNTH[:] = [syn["key"], members]
    return _SYNTH[1]


def phase_aae(torch, cg, captured: dict, n: int = _CHAOS_REPLICAS) -> dict:
    """``bench_scenarios.aae_scrub`` at ``n`` replicas with JAX's other
    defaults (fanout 3, 8 nemesis rounds, 8 writers, seed 23; a 64-element
    G-Set and a 32 x 16 OR-SWOT) over every preset of ``PRESETS +
    CORRUPTION_PRESETS`` (dense rounds), and ring-cut again with frontier
    rounds (K2 / K3): each drill asserts detection within the cadence,
    exact localization, repair and the healed states bit-equal to the
    fault-free twin; then the rehash comparison at ``n`` (six 64-element
    G-Sets, two hot rows against all, median of 3, each arm's row-hash
    seconds apart and its device activities a pass counted under
    ``torch.profiler``). Per preset: detections, repairs, repair against
    full-resync bytes, exchange rounds and comparisons, scrub seconds split
    into hash, exchange and repair."""
    from lasp_tpu_torch.bench_scenarios import aae_scrub, rehash_drill

    cg.reset_launches()
    undo = _capture_rows_shapes(cg, captured, "aae")
    try:
        out, secs = _timed_step(torch, lambda: aae_scrub(
            n_replicas=n, frontier_presets=("ring-cut",)))
    finally:
        undo()
    for preset, rec in out["presets"].items():
        if not rec["detected_and_repaired"] or rec["injected"] < 1:
            raise RuntimeError(f"aae: {preset}: {rec}")
        _log_line("aae", {"preset": preset, "replicas": n, **rec})
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    # the device activities (kernels, copies, fills) of one pass of each arm
    # of the rehash comparison, under torch.profiler
    forest, passes = rehash_drill(n)
    passes["incremental"]()
    per_pass = {}
    for arm, run in passes.items():
        got = _device_kernels(torch, [run], [run])
        per_pass[arm] = None if got is None else sum(got.values())
    del forest, passes
    _log_line("aae", {"part": "rehash", **out["rehash"], "seconds": secs,
                      "device_activities_per_pass": per_pass, "launches": launches})
    return {"launches": launches, "shapes": shapes, "aae": out}


def _harness_build(n: int, device=None):
    """The membership harness's population (``tests/membership``'s): an
    OR-Set and a G-Set, here on ``random_regular(n, 3)``."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, random_regular
    from lasp_tpu_torch.store import Store

    def build():
        store = Store(n_actors=32, device=device)
        store.declare(id="kv", type="lasp_orset", n_elems=64, tokens_per_actor=8)
        store.declare(id="g", type="lasp_gset", n_elems=64)
        return ReplicatedRuntime(store, Graph(store), n,
                                 random_regular(n, 3, seed=n), device=device)

    return build


def _harness_runs(torch, cg, h: int, device=None) -> dict:
    """``run_membership_harness`` at ``h`` replicas with a join to ``3h/2``,
    a leave back to ``h`` and a down to ``7h/8``, each plan op carrying its
    ``random_regular(., 3)`` table, under ``rolling-crash`` and
    ``ring-cut``: once with quorum writes (no acked write lost, every
    request resolved, replay identical) and once with direct writes held
    bit for bit against the static twin. ``h / 4`` transfers a cycle (the
    JAX tests' ratio)."""
    from lasp_tpu_torch.membership import run_membership_harness
    from lasp_tpu_torch.mesh import random_regular

    plan_ops = [(r, kind, m, random_regular(m, 3, seed=m)) for r, kind, m in
                ((3, "join", h * 3 // 2), (9, "leave", h), (15, "down", h - h // 8))]
    out = {}
    for preset in ("rolling-crash", "ring-cut"):
        before = dict(cg.LAUNCHES)
        q, q_secs = _timed_step(torch, lambda: run_membership_harness(
            _harness_build(h, device), plan_ops, preset=preset, seed=7,
            nemesis_rounds=10, per_cycle=h // 4,
            quorum_writes=[(r, "kv", ("add", f"q{r}"), f"c{r}", (r * 37) % (h // 2))
                           for r in (1, 4, 8, 10, 13)]))
        d, d_secs = _timed_step(torch, lambda: run_membership_harness(
            _harness_build(h, device), plan_ops, preset=preset, seed=7,
            nemesis_rounds=10, per_cycle=h // 4,
            build_twin=_harness_build(h - h // 8, device),
            writes=[(r, (r * 29) % (h // 2), "g" if r % 2 else "kv",
                     ("add", f"w{r}"), f"a{r}") for r in (1, 5, 10, 14)]))
        if not (q["no_write_lost"] and q["replay_identical"]
                and d["bit_identical_to_twin"] and d["replay_identical"]):
            raise RuntimeError(f"rebalance: harness {preset}: {q} {d}")
        out[preset] = {"quorum": q, "direct": d, "quorum_seconds": q_secs,
                       "direct_seconds": d_secs, "launches": _launch_delta(cg, before)}
    return out


def phase_rebalance(torch, cg, captured: dict, n: int = _CHAOS_REPLICAS) -> dict:
    """(a) ``bench_scenarios.elastic_rebalance`` at ``n`` -> ``3n/2`` ->
    ``n`` (the membership phase's extents) on ``random_regular(., 3)``,
    ``per_cycle = n/8`` (JAX's 4 transfer cycles for the joining rows): it
    asserts the staged and legacy grown populations bit-equal, no cycle
    over the cap and the staged transfer wire <= the full-resync wire. (b)
    ``_harness_runs`` at ``n``."""
    from lasp_tpu_torch.bench_scenarios import elastic_rebalance

    cg.reset_launches()
    undo = _capture_rows_shapes(cg, captured, "rebalance")
    try:
        el, secs = _timed_step(torch, lambda: elastic_rebalance(
            n_replicas=n, grow_to=n * 3 // 2, per_cycle=n // 8,
            topology="random_regular"))
        el_launches = dict(cg.LAUNCHES)
        harness = _harness_runs(torch, cg, n)
        for preset, rec in harness.items():
            _log_line("rebalance", {"part": "harness", "preset": preset,
                                    "replicas": n, **rec})
    finally:
        undo()
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    _log_line("rebalance", {"part": "elastic_rebalance", **el, "seconds": secs,
                            "launches": el_launches})
    return {"launches": launches, "shapes": shapes, "elastic": el,
            "harness": harness}


#: shed reasons the admission controller may give (typed, never silent)
_SHED_REASONS = ("queue_full", "shed_low_priority", "writes_rejected")


def _serve_cycles(torch, n: int, cycles: int = 8, per_cycle: int = 1200) -> dict:
    """A fault-free ``ServeFrontend`` over ``run_load``'s population at ``n``
    replicas, fused gossip windows of 4: ``cycles`` cycles of ``per_cycle``
    writes, reads and watches each, under ``torch.profiler`` (the card's
    busy share over the cycles)."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.lattice import Threshold
    from lasp_tpu_torch.mesh import ReplicatedRuntime, random_regular
    from lasp_tpu_torch.serve import ServeFrontend
    from lasp_tpu_torch.store import Store

    store = Store(n_actors=112)
    for i in range(6):
        store.declare(id=f"kv{i}", type="lasp_gset", n_elems=192)
    store.declare(id="ctr", type="riak_dt_gcounter", n_actors=1024)
    rt = ReplicatedRuntime(store, Graph(store), n, random_regular(n, 3, seed=7))
    fe = ServeFrontend(rt, gossip_block=4)
    rng = np.random.RandomState(3)
    stats = []

    def run():
        for c in range(cycles):
            for i in range(per_cycle):
                r = int(rng.randint(n))
                kind = i % 10
                if kind < 5:
                    fe.submit_write(f"kv{i % 6}", ("add", f"k{int(rng.randint(192))}"),
                                    f"c{i}", replica=r)
                elif kind < 8:
                    fe.submit_read(f"kv{i % 6}", replica=r)
                else:
                    fe.submit_watch("ctr", Threshold(int(rng.randint(1, 50))), replica=r)
            stats.append(fe.cycle()["seconds"])

    busy = _device_busy(torch, run)
    rep = fe.report()
    return {"replicas": n, "cycles": cycles, "requests_per_cycle": per_cycle,
            "cycle_ms": [s * 1e3 for s in stats], **busy,
            "overlap_seconds": rep["overlap_seconds"],
            "gossip_rounds": rep["gossip_rounds"], "completed": rep["completed"]}


def _serve_loop(torch, n: int, clients: int = 2, per_client: int = 150) -> dict:
    """A ``ServeLoop`` on the card: ``clients`` threads submit writes and
    reads concurrently while the loop's thread runs cycles; every ticket
    must reach a terminal status."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, random_regular
    from lasp_tpu_torch.serve import ServeFrontend, ServeLoop
    from lasp_tpu_torch.store import Store

    store = Store(n_actors=64)
    store.declare(id="kv", type="lasp_gset", n_elems=2 * clients * per_client)
    rt = ReplicatedRuntime(store, Graph(store), n, random_regular(n, 3, seed=1))
    fe = ServeFrontend(rt, gossip_block=2)
    tickets, lock = [], threading.Lock()

    def client(c):
        for i in range(per_client):
            t = (fe.submit_write("kv", ("add", f"k{c}-{i}"), f"c{c}", replica=i % n)
                 if i % 3 else fe.submit_read("kv", replica=i % n))
            with lock:
                tickets.append(t)

    t0 = time.perf_counter()
    with ServeLoop(fe, idle_sleep=0.001):
        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        deadline = time.monotonic() + 60
        while any(t.status == "queued" for t in tickets) and time.monotonic() < deadline:
            time.sleep(0.005)
    secs = time.perf_counter() - t0
    status = Counter(t.status for t in tickets)
    writes = sum(1 for c in range(clients) for i in range(per_client) if i % 3)
    if status.get("queued") or len(rt.coverage_value("kv")) != writes:
        raise RuntimeError(f"serve: the loop left tickets {dict(status)}")
    return {"replicas": n, "tickets": len(tickets), "status": dict(status),
            "seconds": secs, "cycles": fe.cycles}


def phase_serve(torch, cg, captured: dict, n: int = _CHAOS_REPLICAS) -> dict:
    """``bench_scenarios.serve_load`` at ``n`` replicas with JAX's scenario
    parameters (10,000 clients, 40 ticks, 1,200 arrivals a tick, a x5 burst,
    10,000 seed watches, 100,000 parity thresholds, seed 7) under the
    composite nemesis: no acked write lost after heal, threshold parity at
    100,000 watches, typed sheds only; the host time of ``_backup_of``;
    then the card's busy share over 8 fault-free cycles and a short
    ``ServeLoop`` with two client threads, both on ``n`` replicas."""
    from lasp_tpu_torch.bench_scenarios import serve_load
    from lasp_tpu_torch.serve import ServeFrontend

    cg.reset_launches()
    undo = _capture_rows_shapes(cg, captured, "serve")
    host = _HostTime()
    undo_host = host.wrap(ServeFrontend, "_backup_of", "backup_of")
    try:
        rep, secs = _timed_step(torch, lambda: serve_load(n_replicas=n))
        load_launches = dict(cg.LAUNCHES)
        busy = _serve_cycles(torch, n)
        loop = _serve_loop(torch, n)
    finally:
        undo_host()
        undo()
    bad = [k for k in rep["shed"] if k.split(":")[-1] not in _SHED_REASONS]
    if (not rep["no_write_lost"] or not rep["threshold_parity"]["parity"] or bad
            or not rep["chaos"]["healed"]):
        raise RuntimeError(f"serve: serve_load failed its checks: {rep}")
    _log_line("serve", {"part": "serve_load", "replicas": n, "seconds": secs,
                        **{k: v for k, v in rep.items() if k != "trace"},
                        "backup_of_host_s": host.seconds["backup_of"],
                        "backup_of_calls": host.calls["backup_of"],
                        "launches": load_launches})
    _log_line("serve", {"part": "cycles", **busy})
    _log_line("serve", {"part": "serve_loop", **loop})
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    return {"launches": launches, "shapes": shapes, "load": rep, "busy": busy,
            "loop": loop}


#: the session phase: the engine cell's population through ``Session``
_SESSION_REPLICAS = 100_000


def _session_ops(n: int) -> dict:
    """The engine cell's 16 writers (``_engine``) at their rows: OR-Set and
    G-Counter ops, and one tag each into the G-Set the ``map`` edge reads."""
    writers = np.random.RandomState(5).choice(n, 16, replace=False)
    ops = {"ads": [], "views": [], "tags": []}
    for a, r in enumerate(writers):
        mine = [f"ad{(a * 4 + j) % 64}" for j in range(4)]
        ops["ads"].append((int(r), ("add_all", mine), f"w{a}"))
        if a % 4 == 0:
            ops["ads"].append((int(r), ("remove", mine[0]), f"w{a}"))
        ops["views"].append((int(r), ("increment", a + 1), f"w{a}"))
        ops["tags"].append((int(r), ("add", f"t{a % 8}"), f"w{a}"))
    return ops


def _session_declare(store, graph) -> None:
    """The session's variables and its ``map`` edge (through a ``Session``
    or a bare ``Store`` and ``Graph``). The edge reads a 16-element G-Set:
    a ``map`` of the 64 x 64-token OR-Set derives an OR-Set of 64 x 4,096
    tokens (JAX's rule, ``Graph._project``), 512 KiB a replica, 52 GB at
    100,000 replicas."""
    store.declare(type="lasp_orset", id="ads", n_elems=64, n_actors=16,
                  tokens_per_actor=4)
    store.declare(type="riak_dt_gcounter", id="views", n_actors=16)
    store.declare(type="lasp_gset", id="tags", n_elems=16)
    graph.map("tags", lambda x: x + "!", dst="seen")


def phase_session(torch, cg, captured: dict, n: int = _SESSION_REPLICAS) -> dict:
    """The engine cell's population through the ``Session`` verbs: a
    ``Session`` on the card declares the OR-Set (64 elements x 16 actors x 4
    tokens), a G-Counter and a ``map`` edge over a 16-element G-Set
    (``_session_declare``), ``replicate(n,
    topology="random", fanout=3, seed=0, packed=True)`` (K1), the 16
    writers through ``update_batch`` and ``run_to_convergence``. A runtime
    built by hand on ``locality_order(random_regular(n, 3, seed=0))``
    converges the same writes: the states must be bit-equal, the rounds
    equal and the values equal to a single-store ``Session`` given the same
    ops. Then ``nemesis`` (ring-cut soak), ``quorum`` (a put and a
    get), ``aae`` (one scrub), ``serve`` (a write and a cycle) and
    ``register`` / ``process`` / ``execute`` (a keylist program), each
    once with JAX's defaults, each checked."""
    from lasp_tpu_torch import Session
    from lasp_tpu_torch.bridge_state import to_numpy
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, locality_order, random_regular
    from lasp_tpu_torch.programs import ExampleKeylistProgram
    from lasp_tpu_torch.store import Store

    cg.reset_launches()
    undo = _capture_rows_shapes(cg, captured, "session")
    secs = {}
    try:
        s = Session(n_actors=16)
        _session_declare(s, s)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # the locality note
            rt, secs["replicate"] = _timed_step(torch, lambda: s.replicate(
                n, topology="random", fanout=3, seed=0, packed=True))
        ops = _session_ops(n)
        for v, vops in ops.items():
            rt.update_batch(v, vops)
        rounds, secs["converge"] = _timed_step(torch, rt.run_to_convergence)
        k1 = dict(cg.LAUNCHES)
        # the hand-built twin on the same table (dense rounds too: a
        # dataflow edge keeps the frontier scheduler off, as in JAX)
        perm, nbrs = locality_order(random_regular(n, 3, seed=0))
        store = Store(n_actors=16)
        graph = Graph(store)
        _session_declare(store, graph)
        twin = ReplicatedRuntime(store, graph, n, nbrs, packed=True)
        for v, vops in ops.items():
            twin.update_batch(v, vops)
        twin_rounds, secs["twin_converge"] = _timed_step(torch, twin.run_to_convergence)
        if not np.array_equal(rt.locality_perm, perm) or twin_rounds != rounds:
            raise RuntimeError(f"session: {rounds} rounds, the twin {twin_rounds}")
        names = ("ads", "views", "tags", "seen")
        for v in names:
            for a, b in zip(to_numpy(rt.states[v]), to_numpy(twin.states[v])):
                if not np.array_equal(a, b):
                    raise RuntimeError(f"session: {v} differs from the hand-built twin")
        del twin, store, graph
        single = Session(n_actors=16)
        _session_declare(single, single)
        for v, vops in ops.items():
            for _r, op, actor in vops:
                single.update(v, op, actor)
        values = {v: rt.coverage_value(v) for v in names}
        if (len(values["ads"]) != 60 or values["views"] != sum(range(1, 17))
                or values["seen"] != {f"t{i}!" for i in range(8)}
                or values != {v: single.value(v) for v in names}):
            raise RuntimeError(f"session: values {values} against the single store")
        # the wrapping verbs, once each
        chaos = s.nemesis(rt, "ring-cut", seed=0)
        soak, secs["nemesis_soak"] = _timed_step(torch, chaos.soak)
        if not soak["healed"] or any(rt.divergence(v) for v in values):
            raise RuntimeError(f"session: the nemesis soak did not heal: {soak}")
        kv = s.quorum(chaos)
        put = kv.submit_put("ads", ("add", "ad63"), "w0")  # a writer of the 16
        get = kv.submit_get("ads")

        def resolve():
            for _ in range(64):
                kv.step()
                if kv.result(put)["status"] != "pending" and \
                        kv.result(get)["status"] != "pending":
                    return
            raise RuntimeError("session: the quorum requests did not resolve")

        _, secs["quorum"] = _timed_step(torch, resolve)
        if kv.result(put)["status"] not in ("done", "acked"):
            raise RuntimeError(f"session: the quorum put: {kv.result(put)}")
        scrub = s.aae(rt)
        stats, secs["aae_scrub"] = _timed_step(torch, scrub.scrub)
        fe = s.serve(rt)
        ticket = fe.submit_write("views", ("increment",), "w1")
        _, secs["serve_cycle"] = _timed_step(torch, fe.cycle)
        if ticket.status != "done":
            raise RuntimeError(f"session: the served write ended {ticket.status}")
        s.register("keys", ExampleKeylistProgram, n_elems=16)
        s.process(("k1", 1), "put", "w0")
        if s.execute("keys") != {"k1"}:
            raise RuntimeError(f"session: execute gave {s.execute('keys')}")
    finally:
        undo()
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    if not k1["gossip_round_dense"]:
        raise RuntimeError(f"session: the packed convergence never launched K1: {k1}")
    _log_line("session", {
        "replicas": n, "rounds": rounds, "seconds": secs,
        "converge_launches": k1, "values": {"ads": len(values["ads"]),
                                            "views": values["views"],
                                            "seen": len(values["seen"])},
        "nemesis": {k: soak[k] for k in ("rounds_to_heal", "healed") if k in soak},
        "quorum": {"put": kv.result(put)["status"], "get": kv.result(get)["status"]},
        "aae": {k: stats[k] for k in ("divergent_rows", "corrupt_detected",
                                      "rows_hashed")},
        "launches": launches,
    })
    return {"launches": launches, "shapes": shapes, "rounds": rounds}


#: the bridge phase's request stream (``bench_scenarios.bridge_stream``)
_BRIDGE = {"n_requests": 20_000, "n_partitions": 64, "vars_per_partition": 16,
           "merge_every": 10, "seed": 0}


def _gets(stream: dict) -> dict:
    """A stream of one ``get`` per variable, partition by partition."""
    from lasp_tpu_torch.bridge import Atom

    return {"setup": [st for st in stream["setup"] if str(st[1][0]) == "start"],
            "requests": [(p, (Atom("get"), v)) for p, v in stream["vars"]]}


def phase_bridge(torch, cg) -> dict:
    """A loopback ``BridgeServer`` on the card: ``bridge_throughput()`` at
    JAX's defaults with the native arm serving, then again with the Python
    arm (``LaspConfig(etf="python")``); then
    the seeded stream of 20,000 requests over 1,024 variables (16 in each
    of riak_core's 64 partitions, ``ingest_storm``'s five kinds; one in ten
    a 16-variable ``merge_batch``, the rest YCSB workload A's reads and
    updates) in durable mode, every response equal
    byte for byte to a second server's on the CPU in this process; the
    server restarted on the same ``data_dir`` must read every variable back
    as it answered before (no acked write lost). Requests/s, p50 / p99 ms,
    and the card's busy share over 2,000 requests of an in-memory server."""
    import os
    import shutil

    from lasp_tpu_torch.bench_scenarios import (bridge_clients, bridge_requests,
                                                bridge_stream, bridge_throughput,
                                                run_bridge_stream)
    from lasp_tpu_torch.bridge import BridgeServer, etf

    from lasp_tpu_torch.config import LaspConfig, get_config, set_config

    cg.reset_launches()
    thr, thr_s = _timed_step(torch, bridge_throughput)
    if thr["etf_impl"] != "native" or thr["device"] != "cuda":
        raise RuntimeError(f"bridge: bridge_throughput served by {thr}")
    # the Python arm's rates on the same frames (JAX's fallback codec)
    config = get_config()
    set_config(LaspConfig(etf="python"))
    try:
        thr_py = bridge_throughput()
    finally:
        set_config(config)
    if thr_py["etf_impl"] != "python" or etf.IMPL != "native":
        raise RuntimeError(f"bridge: the codec did not switch arms: {thr_py}")
    stream = bridge_stream(**_BRIDGE)
    tmp = tempfile.mkdtemp()
    try:
        dirs = {d: os.path.join(tmp, d) for d in ("cuda", "cpu")}
        with BridgeServer(data_dir=dirs["cuda"]) as server:
            run = run_bridge_stream(server.port, stream)
            before = run_bridge_stream(server.port, _gets(stream))["responses"]
        with BridgeServer(data_dir=dirs["cpu"], device="cpu") as server:
            ref = run_bridge_stream(server.port, stream)
        diff = [i for i, (a, b) in enumerate(zip(run["responses"], ref["responses"]))
                if a != b]
        if diff or len(run["responses"]) != len(ref["responses"]):
            i = diff[0] if diff else None
            raise RuntimeError(f"bridge: {len(diff)} responses differ from the CPU "
                               f"server's, first at {i}: {stream['requests'][i]}")
        with BridgeServer(data_dir=dirs["cuda"]) as server:
            after, restart_s = _timed_step(
                torch, lambda: run_bridge_stream(server.port, _gets(stream)))
        if after["responses"] != before:
            raise RuntimeError("bridge: a variable read back changed after the restart")
        disk = sum(os.path.getsize(os.path.join(dirs["cuda"], f))
                   for f in os.listdir(dirs["cuda"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the busy share over 2,000 requests only: the stores are declared
    # before the profiler opens
    with BridgeServer() as server:
        clients = bridge_clients(server.port, stream["setup"])
        try:
            busy = _device_busy(torch, lambda: bridge_requests(
                clients, stream["requests"][:2000]))
        finally:
            for c in clients.values():
                c.close()
    ms = np.asarray(run["latency_s"]) * 1e3
    errors = sum(1 for r in run["responses"]
                 if etf.decode(r)[0] == etf.ERROR)
    if errors:
        raise RuntimeError(f"bridge: {errors} of the stream's requests were refused")
    kinds = Counter(str(t[0]) for _p, t in stream["requests"])
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    _log_line("bridge", {
        "throughput": thr, "throughput_s": thr_s, "throughput_python_arm": thr_py,
        "requests": len(stream["requests"]), "variables": len(stream["vars"]),
        "partitions": _BRIDGE["n_partitions"], "kinds": dict(kinds),
        "error_responses": errors, "durable_bytes_on_disk": disk,
        "requests_per_s": len(ms) / run["seconds"],
        "cpu_server_requests_per_s": len(ms) / ref["seconds"],
        "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
        "restart_readback_s": restart_s, "busy": busy, "launches": launches,
    })
    return {"launches": launches, "shapes": shapes}


def phase_scenarios(torch, cg, captured: dict) -> dict:
    """The scenarios this slice ports, each with its own check:
    ``frontier_sparse(n_replicas=100_000)`` (dense and frontier fixed points
    bit-identical, K2 held against its plain version), ``many_vars(
    n_replicas=100_000, n_vars=128)`` (``plan="off"`` and ``"auto"``:
    residuals and states identical), ``packed_vs_dense()`` at JAX's
    1,048,576 replicas (one value; the peak memory of the two arms),
    ``roofline_workload()`` (its K1 and K2 / K3
    probes held at max_abs_err 0, the ledger's ``cuda_*`` families), and
    ``partitioned_gossip`` / ``mesh_scale`` raising ``NotImplementedError``
    (sharding, ROADMAP A5)."""
    from lasp_tpu_torch.bench_scenarios import (frontier_sparse, many_vars,
                                                mesh_scale, packed_vs_dense,
                                                partitioned_gossip, roofline_workload)
    from lasp_tpu_torch.telemetry import get_ledger

    cg.reset_launches()
    undo = _capture_rows_shapes(cg, captured, "scenarios")
    out = {}
    try:
        for name, fn in (
                ("frontier_sparse", lambda: frontier_sparse(n_replicas=100_000)),
                ("many_vars", lambda: many_vars(n_replicas=100_000, n_vars=128)),
                ("packed_vs_dense", packed_vs_dense)):
            before = dict(cg.LAUNCHES)
            torch.cuda.reset_peak_memory_stats()
            rec, secs = _timed_step(torch, fn)
            rec["phase_s"], rec["launches"] = secs, _launch_delta(cg, before)
            rec["peak_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2**30
            out[name] = rec
            _log_line("scenarios", {"scenario": name, **rec})
        before = dict(cg.LAUNCHES)
        rt, secs = _timed_step(torch, roofline_workload)
        families = sorted({e["kernel"].split(":")[0] for e in get_ledger().snapshot()})
        out["roofline_workload"] = {
            "phase_s": secs, "launches": _launch_delta(cg, before),
            "cuda_rows": rt.cuda_rows_probe, "cuda_dense": rt.cuda_dense_probe,
            "families": families}
        del rt
    finally:
        undo()
    for name in ("frontier_sparse", "many_vars"):
        probe = out[name]["cuda_rows"]
        if probe is None or probe["max_abs_err"] or probe["mode"] != "cuda":
            raise RuntimeError(f"scenarios: {name}'s K2 probe: {probe}")
    rw = out["roofline_workload"]
    for k in ("cuda_rows", "cuda_dense"):
        if rw[k]["max_abs_err"] or rw[k]["mode"] != "cuda" or k not in rw["families"]:
            raise RuntimeError(f"scenarios: roofline_workload's {k}: {rw}")
    for fn in (partitioned_gossip, mesh_scale):
        try:
            fn()
        except NotImplementedError:
            continue
        raise RuntimeError(f"scenarios: {fn.__name__} did not raise")
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    _log_line("scenarios", {"scenario": "roofline_workload", **rw})
    return {"launches": launches, "shapes": shapes}


def phase_cli(torch, checkpoint: str, out_dir: str) -> dict:
    """``python -m lasp_tpu_torch.cli`` in subprocesses on the card, all
    started together: ``status`` (must name the card), ``simulate``,
    ``scenario gset_1k``, ``roofline --export`` (``roofline_frac`` not
    null) and ``inspect`` on the checkpoint phase's map store. Each output
    must parse as JSON."""
    import os

    root = Path(__file__).resolve().parent
    export = os.path.join(out_dir, "roofline.json")
    # the subprocesses allocate on the same card: hand back what this
    # process's allocator keeps cached (packed_vs_dense's arms left ~70 GiB)
    torch.cuda.empty_cache()
    verbs = {
        "status": ["status"],
        "simulate": ["simulate"],
        "scenario": ["scenario", "gset_1k"],
        "roofline": ["roofline", "--export", export],
        "inspect": ["inspect", checkpoint],
    }
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "lasp_tpu_torch.cli", *argv], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in verbs.items()}
    outs = {}
    try:
        for name, p in procs.items():
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise RuntimeError(f"cli {name}: rc={p.returncode}\n{err[-2000:]}")
            outs[name] = out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    parsed = {name: json.loads(outs[name]) for name in verbs if name != "roofline"}
    with open(export) as f:
        parsed["roofline"] = json.load(f)
    kind = torch.cuda.get_device_name(0)
    if kind not in parsed["status"]["devices"] or parsed["status"]["platform"] != "cuda":
        raise RuntimeError(f"cli status: {parsed['status']}")
    if parsed["roofline"]["summary"]["roofline_frac"] is None:
        raise RuntimeError("cli roofline: roofline_frac is null on the card")
    if parsed["inspect"]["vars"] != {"kvs": "riak_dt_map"}:
        raise RuntimeError(f"cli inspect: {parsed['inspect']}")
    if parsed["scenario"]["check"] != "matches-global-reference":
        raise RuntimeError(f"cli scenario: {parsed['scenario']}")
    _log_line("cli", {
        "wall_s": wall, "status": parsed["status"],
        "simulate": {k: parsed["simulate"][k] for k in
                     ("replicas", "rounds_to_convergence", "seconds", "device")},
        "scenario": parsed["scenario"],
        "roofline_summary": parsed["roofline"]["summary"],
        "inspect": {k: parsed["inspect"][k] for k in ("kind", "vars")},
    })
    return parsed


#: the north star's population (BASELINE config 5: 10 x 2**20 replicas)
_ADCOUNTER_REPLICAS = 10 * (1 << 20)


def phase_adcounter(torch, cg) -> dict:
    """The north star through the port's entry points. Returns the launches
    and launch shapes of the run, its neighbour table (the kernels phase
    times K1 on it) and the fields of the phase's line, with the run's
    flight windows."""
    from lasp_tpu_torch.bench_scenarios import adcounter_10m, adcounter_topology
    from lasp_tpu_torch.telemetry import device as tdev

    n = _ADCOUNTER_REPLICAS
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 1e9  # earlier phases' states
    torch.cuda.reset_peak_memory_stats()
    cg.reset_launches()
    n_windows = len(tdev.windows("converge"))
    t0 = time.perf_counter()
    out = adcounter_10m(n, threshold=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    # the flight ring's windows of the run: the warm round, then the rest
    windows = [{"rounds": w.rounds, "overwritten": w.overwritten,
                "quiescent": w.quiescent, "curve": w.residual_curve()}
               for w in tdev.windows("converge")[n_windows:]]
    peak = torch.cuda.max_memory_allocated() / 1e9
    if out["live_ads"] != 6 or out["active_pairs"] != 6:
        raise RuntimeError(f"adcounter: {out}")
    if launches["gossip_round_dense"] == 0:
        raise RuntimeError("the adcounter never launched K1")
    line = {
        "replicas": n, "rounds": out["rounds"], "warm_rounds": 1,
        "seconds": out["seconds"], "under_60s": out["under_60s"],
        "state_bytes_per_replica": out["state_bytes_per_replica"],
        "ad_totals": out["ad_totals"], "live_ads": out["live_ads"],
        "active_pairs": out["active_pairs"], "driver": out["driver"],
        "scenario_wall_s": wall,
        "peak_allocated_GB": peak, "resident_before_GB": resident,
        "k1_launches_by_shape": {
            str(dict(zip(cg.SHAPE_FIELDS["gossip_round_dense"], key))): c
            for key, c in shapes["gossip_round_dense"].items()},
        "flight_windows": windows,
    }
    # the kernels phase times K1 at the adcounter's shapes on its topology;
    # the profiled twin is built after that phase (phase 24's memory back)
    nbrs = torch.as_tensor(adcounter_topology(n), dtype=torch.int32, device="cuda")
    return {"launches": launches, "shapes": shapes, "neighbors": nbrs, "line": line}


#: the programs phase (a Riak 2i index over the chaos phases' population):
#: ``bench_scenarios.riak_index_2i``'s event stream and program sizes
_PROGRAMS = {"n_events": 1024, "n_keys": 48, "index_names": 2, "index_values": 8,
             "n_shards": 4, "seed": 29}


def phase_programs(torch, cg, captured: dict, peak_gbps: float,
                   n: int = _CHAOS_REPLICAS) -> dict:
    """``bench_scenarios.riak_index_2i`` at ``n`` replicas on
    ``random_regular(n, 3)``: a total ``RiakIndexProgram`` with auto views,
    the 16 views it registers from specs over 2 index names x 8 values and
    an ``ExampleKeylistProgram`` (JAX's defaults: 64 elements, 64 tokens,
    one actor: two ``bool[64, 64]`` planes a row), 1,024 seeded events over
    48 keys through ``process`` at ``crc32(key) % n`` (filled views compact
    through ``CapacityError`` -> ``compact_orset`` -> ``run_to_convergence``),
    the runtime's normal scheduler to convergence (K2 launches there), then
    ``ring_coverage_execute`` over 4 shards, which must equal per-program
    ``execute``, a quorum execute over 3 rows and the plain host model.
    Then the grouped sweep alone at G=17 and G=1 under ``torch.profiler``:
    its device activities must not grow with G."""
    from lasp_tpu_torch.bench_scenarios import riak_index_2i
    from lasp_tpu_torch.programs.riak_index import BASE_NAME
    from lasp_tpu_torch.quorum import coverage

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cg.reset_launches()
    undo = _capture_rows_shapes(cg, captured, "programs")
    try:
        out, secs = _timed_step(torch, lambda: riak_index_2i(
            n_replicas=n, keep_runtime=True, **_PROGRAMS))
    finally:
        undo()
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    peak = torch.cuda.max_memory_allocated()
    rt = out.pop("runtime")
    if out["programs"] != 18 or out["views"] != 16:
        raise RuntimeError(f"programs: {out['programs']} programs, {out['views']} views")
    if not sum(launches.values()):
        raise RuntimeError("programs: the views' convergence launched no K1 / K2 / K3")
    index_ids = [p.id for name, p in rt.programs.items() if name != "keylist"]
    all_ids = [p.id for p in rt.programs.values()]
    g, rb = len(index_ids), rt._row_bytes(index_ids[0])
    # the sweep's least bytes: every program's population read once
    read_bytes = sum(rt._row_bytes(v) for v in all_ids) * n
    stack_bytes = 2 * g * n * rb  # the group's copy: read and written once
    # the grouped sweep alone (the stacked group's plan), at G=17 and G=1
    codec, spec = rt._mesh_meta(index_ids[0])
    sweep_g = coverage._sweep_fn(codec, spec, g, n, _PROGRAMS["n_shards"])
    members = [rt._population(v) for v in index_ids]
    acts_g = _device_kernels(torch, [lambda: sweep_g(members)], [lambda: sweep_g(members)])
    sweep_ms = _time_ms(torch, lambda: sweep_g(members), 3,
                        spin_cycles=_QUEUE_AHEAD_CYCLES // 10)
    sweep_1 = coverage._sweep_fn(codec, spec, 1, n, _PROGRAMS["n_shards"])
    acts_1 = _device_kernels(torch, [lambda: sweep_1(members[:1])],
                             [lambda: sweep_1(members[:1])])
    if acts_g is None or acts_1 is None or sum(acts_g.values()) != sum(acts_1.values()):
        raise RuntimeError(f"programs: the sweep's device activities grew with G: "
                           f"G={g}: {acts_g}, G=1: {acts_1}")
    del members, rt
    _log_line("programs", {
        **{k: v for k, v in out.items() if k != "values"}, "values": out["values"],
        "index_program": BASE_NAME, "phase_s": secs,
        "sweep_read_bytes": read_bytes, "sweep_stack_copy_bytes": stack_bytes,
        "sweep_GBps_read_once": read_bytes / out["sweep_s"] / 1e9,
        "sweep_share_of_peak": read_bytes / out["sweep_s"] / 1e9 / peak_gbps,
        "sweep_fn_ms_G17": sweep_ms,
        "sweep_fn_GBps_G17": g * n * rb / (sweep_ms / 1e3) / 1e9,
        "sweep_fn_share_of_peak_G17": g * n * rb / (sweep_ms / 1e3) / 1e9 / peak_gbps,
        "peak_GBps": peak_gbps,
        "sweep_device_activities": {f"G={g}": sum(acts_g.values()),
                                    "G=1": sum(acts_1.values())},
        "peak_allocated_GB": peak / 1e9, "resident_before_GB": resident / 1e9,
        "launches": launches,
    })
    return {"launches": launches, "shapes": shapes, "line": out}


def north_star_flight(torch, ad: dict) -> dict:
    """The flight ring on the north star: the adcounter's windows (its
    timed run: one warm round, then the rest; its profiled twin: one window
    from scratch) against a third full-size build stepped one unfused round
    at a time: the twin's window must hold the same per-round residuals the
    runtime's ``step`` reports, in the same rounds, to bit-equal states."""
    from lasp_tpu_torch.bench_scenarios import adcounter_setup
    from lasp_tpu_torch.bridge_state import to_numpy
    from lasp_tpu_torch.telemetry import device as tdev

    twin_window, twin_states = ad.pop("twin_window"), ad.pop("twin_states")
    rt, _views, _lanes = adcounter_setup(_ADCOUNTER_REPLICAS, 5, None)
    per_round = []
    while True:
        per_round.append(rt.step())
        if per_round[-1] == 0 or len(per_round) > 64:
            break
    curve = [t for _r, t in twin_window.residual_curve()]
    same = all(
        all(np.array_equal(a, b) for a, b in zip(to_numpy(rt.states[v]), twin_states[v]))
        for v in rt.var_ids)
    del rt
    run_windows = ad["line"]["flight_windows"]
    line = {
        "replicas": _ADCOUNTER_REPLICAS,
        "flight_rounds": tdev.flight_rounds(),
        "timed_run_windows": run_windows,
        "timed_run_rounds": sum(w["rounds"] for w in run_windows),
        "twin_window": {"rounds": twin_window.rounds, "overwritten": twin_window.overwritten,
                        "quiescent": twin_window.quiescent, "curve": curve},
        "unfused_step_residuals": per_round,
        "states_bit_equal": same,
        "seconds_ring_on": ad["line"]["seconds"], "seconds_pr10_no_ring": 1.8445,
    }
    if (line["timed_run_rounds"] != 9 or twin_window.rounds != 9 or len(per_round) != 9
            or curve != per_round or twin_window.overwritten or not same):
        raise RuntimeError(f"telemetry: the north star's flight ring disagrees: {line}")
    return line


def phase_telemetry(torch, cg, kind: str, peak_gbps: float, widest: dict,
                    flight: dict) -> None:
    """The ledger, the capability row and the flight ring on the card: the
    capability record names the card; the kernel cost ledger's families and
    records after every earlier phase; its bytes for K1, K2 and K3 at their
    widest shapes beside the kernels phase's gather model; its achieved
    share of peak beside the kernels phase's; the north star's flight line;
    ``measure_overhead``'s arms against JAX's 5% budget (an arm over it is a
    finding, not a failure)."""
    from lasp_tpu_torch.telemetry import device_capability, get_ledger, kernel_traffic
    from lasp_tpu_torch.telemetry import device as tdev
    from lasp_tpu_torch.telemetry.overhead import measure_overhead

    cap = device_capability()
    if cap["device_kind"] != kind or cap["peak_GBps"] != peak_gbps or (
            kind == "NVIDIA H100 80GB HBM3" and cap["peak_GBps"] != 3350.0):
        raise RuntimeError(f"telemetry: capability {cap} for {kind!r}")
    rows = get_ledger().snapshot()
    families: dict = {}
    for r in rows:
        f = families.setdefault(r["family"], {"signatures": 0, "dispatches": 0,
                                              "compile_dispatches": 0, "rounds": 0,
                                              "bytes": 0, "seconds": 0.0})
        f["signatures"] += 1
        for k in ("dispatches", "compile_dispatches", "rounds", "bytes", "seconds"):
            f[k] += r[k]
    kernels_ledger = {}
    for name, fam in (("gossip_round_dense", "cuda_dense"), ("gossip_round_rows", "cuda_rows"),
                      ("gossip_round_rows_vclock", "cuda_rows")):
        w = widest[name]
        sh = w["shape"]
        g, f = (1, sh["R"]) if fam == "cuda_dense" else (sh["G"], sh["F"])
        est = kernel_traffic(fam, row_bytes=w["row_bytes"], n_replicas=sh["R"],
                             fanout=sh["K"], rows=None if fam == "cuda_dense" else f,
                             g_active=g)
        index_bytes = 0 if fam == "cuda_dense" else g * f * (sh["K"] + 2) * 4
        moves = est.bytes_moved - index_bytes
        if moves != w["gather_model_row_moves_bytes"]:
            raise RuntimeError(f"telemetry: the ledger's {fam} bytes {est.bytes_moved} "
                               f"disagree with {name}'s gather model {w}")
        # K3 is the OR-SWOT's (vclock) row round, K2 every other codec's
        vclock = name == "gossip_round_rows_vclock"
        kernels_ledger[name] = {
            "ledger_bytes_moved": est.bytes_moved, "ledger_index_bytes": index_bytes,
            "gather_model_bytes": w["gather_model_bytes"],
            "gather_model_row_moves_bytes": w["gather_model_row_moves_bytes"],
            "kernels_phase_share_of_peak_gather_model":
                w["gather_model_bound_ms"] / w["ms"],
            "ledger_signatures": [
                {k: r[k] for k in ("kernel", "dispatches", "bytes", "seconds",
                                   "achieved_GBps", "roofline_frac")}
                for r in rows if r["family"] == fam
                and (fam == "cuda_dense" or (r["codec"] == "ORSWOT") == vclock)
            ][:6],
        }
    summary, log = get_ledger().summary(), tdev.stats()
    # (the guard measures in a scratch registry: the live ledger and window
    # log are read before it)
    over = measure_overhead()
    arms = {"emission": over["overhead_frac"], "frontier": over["frontier"]["overhead_frac"],
            "ledger_dense": over["ledger"]["dense_overhead_frac"],
            "ledger_frontier": over["ledger"]["frontier_overhead_frac"],
            "dataflow": over["dataflow"]["overhead_frac"], "aae": over["aae"]["overhead_frac"],
            "flight": over["flight"]["overhead_frac"]}
    _log_line("telemetry", {"part": "capability", **cap})
    _log_line("telemetry", {"part": "ledger", "families": families,
                            "summary": summary, "kernels": kernels_ledger})
    _log_line("telemetry", {"part": "flight", **flight, "log": log})
    _log_line("telemetry", {"part": "overhead", "arms": arms,
                            "over_budget": sorted(a for a, x in arms.items() if x >= 0.05),
                            "report": over})


def adcounter_profile(torch, ad: dict) -> None:
    """The adcounter's second build, made now, converged under the profiler;
    keeps its flight window and states (on the host) for the telemetry
    phase; logs the phase's line."""
    from lasp_tpu_torch.bench_scenarios import adcounter_setup
    from lasp_tpu_torch.bridge_state import to_numpy
    from lasp_tpu_torch.telemetry import device as tdev

    line = ad["line"]
    t1 = time.perf_counter()
    twin, _views, _lanes = adcounter_setup(_ADCOUNTER_REPLICAS, 5, None)
    torch.cuda.synchronize()
    line["setup_s"] = time.perf_counter() - t1
    rounds = [None]
    busy = _device_busy(torch, lambda: rounds.__setitem__(0, twin.converge_on_device()))
    live = twin.coverage_value("ads")
    if rounds[0] != line["rounds"] or live != {
            f"ad{a}" for a in range(10) if a % 8 + 1 < 5}:
        raise RuntimeError(f"adcounter: the profiled twin took {rounds[0]} rounds "
                           f"and left ads {live}")
    # the twin's flight window and its states (on the host) for the
    # telemetry phase's unfused third build
    ad["twin_window"] = tdev.last_window("converge")
    ad["twin_states"] = {v: to_numpy(twin.states[v]) for v in twin.var_ids}
    del twin
    line["profiled_converge (a second full-size build)"] = busy
    # converge_on_device runs whole blocks of 8: the profiled run from
    # scratch includes the no-op rounds after the fixed point
    line["profiled_rounds_run"] = -(-rounds[0] // 8) * 8
    _log_line("adcounter", line)


def _rows_bound_bytes(rows_np, nbrs_np, row_bytes: int, k: int,
                      masked: bool = False) -> tuple:
    """The least bytes and the gather model of one K2 / K3 launch over
    ``rows_np [G, F]``, as the kernels are called: each distinct row a
    member's round reads (own and neighbours) once, the row indices in
    their own dtype (the runtime's int64), the distinct rows' int32
    neighbour indices (and, ``masked``, their K one-byte mask entries), the
    joined rows and the 1-byte changed flags; against the
    ``(K+2)``-rows-a-slot traffic the kernels issue (with a slot's row
    index, its K neighbour indices, its K mask bytes and its flag)."""
    g, f = rows_np.shape
    idx = rows_np.dtype.itemsize
    distinct = sum(np.unique(np.concatenate([r, nbrs_np[np.unique(r)].ravel()])).size
                   for r in rows_np)
    edge_bytes = 4 + (1 if masked else 0)
    bound = (distinct * row_bytes + g * f * idx
             + sum(np.unique(r).size for r in rows_np) * k * edge_bytes
             + g * f * row_bytes + g * f)
    gather = (k + 2) * g * f * row_bytes + g * f * (idx + edge_bytes * k + 1)
    return float(bound), float(gather)


def _rows_call(cg, rt, cap):
    """A replay of one captured K2 / K3 launch on ``rt``'s states, the row
    bytes of its members (over every leaf) and the launch's neighbour table.
    A launch from before a resize of ``rt`` replays on stand-in members of
    its own size, row ``i`` a copy of row ``i mod R``; a launch captured
    without its members (``_capture_rows_shapes``) on seeded members of its
    layout (``rt`` is then None)."""
    nb = cap["neighbors"]
    syn = cap.get("synthetic")
    if syn is not None:
        import torch

        members, plan = _synthetic_members(torch, syn), syn["plan"]
    else:
        var_ids = cap["var_ids"]
        codec, spec = rt._mesh_meta(var_ids[0])
        members = [rt.states[v] for v in var_ids]
        if nb.shape[0] != rt.n_replicas:
            import torch

            idx = torch.arange(nb.shape[0], device=nb.device) % rt.n_replicas
            members = [type(m)(*[x[idx] for x in m]) for m in members]
        plan = cg.rows_plan_of(codec, spec, members[0])
    leaves = [list(ls) for ls in zip(*members)]
    row_bytes = sum(ms[0][0].numel() * ms[0].element_size() for ms in leaves)
    rows, mask = cap["rows"], cap["mask"]

    def call():
        return cg.rows_round(plan, leaves, nb, rows, mask)

    return call, leaves, plan, row_bytes, nb


def _k1_inputs(torch, r, d, k, seed=7, nbrs=None):
    """Planes made from a seed, and ``nbrs`` (the path's own topology) or
    a random ``k``-regular table."""
    from lasp_tpu_torch.mesh import random_regular

    gen = torch.Generator(device="cuda").manual_seed(seed)
    ex = torch.randint(-2**31, 2**31 - 1, (r, d), dtype=torch.int32,
                       device="cuda", generator=gen)
    rm = ex & torch.randint(-2**31, 2**31 - 1, (r, d), dtype=torch.int32,
                            device="cuda", generator=gen)
    nb = (nbrs if nbrs is not None else
          torch.as_tensor(random_regular(r, k, seed=seed), device="cuda"))
    return ex, rm, nb


#: K1 shapes ``(R, D, K)`` off the main path whose two planes together
#: take 32 MiB, inside the 50 MB L2 (the engine's and the headline's row
#: widths at fewer replicas): the sweep holds slabs against whole rows there
_K1_SWEEP_IN_L2 = ((32_768, 128, 3), (4_096, 1_024, 3))


def _k1_sweep(torch, cg, ex, rm, nb, want) -> list:
    """K1 at one shape in column slabs of 8 to 256 words (48 and 96: slab
    segments that straddle 128-byte lines) and in whole rows. Each is
    checked against the plain result, then timed. Returns ``[[slab_words,
    ms], ...]``."""
    out = (torch.empty_like(ex), torch.empty_like(rm))
    d = ex.shape[1]
    table = []
    for w in sorted({min(w, d) for w in (8, 16, 32, 48, 64, 96, 128, 256)} | {d}):
        cg._dense_launch(ex, rm, nb, *out, w)
        torch.cuda.synchronize()
        if not all(torch.equal(o, x) for o, x in zip(out, want)):
            raise RuntimeError(f"K1 disagrees with its plain version in {w}-word slabs")
        ms = _time_ms(torch, lambda w=w: cg._dense_launch(ex, rm, nb, *out, w), 20,
                      spin_cycles=_QUEUE_AHEAD_CYCLES // 10)
        table.append([w, ms])
    return table


def phase_kernels(torch, cg, bw, shapes, captured, sources, widest_k2,
                  k1_nbrs) -> tuple:
    """Every kernel at every distinct launch shape of the main path (``ms``
    and ``bound_ms`` per shape, ``loss_ms = sum(count * (ms - bound_ms))``),
    at its widest shape the fields of the kernels line, every K2 / K3
    shape held against its plain version, and K1 at the
    adcounter's shapes against its plain version (``k1_nbrs``: the
    neighbour table of a path's population, by row count)."""
    fields = cg.SHAPE_FIELDS
    per_shape = {name: [] for name in cg.LAUNCHES}
    widest, sweeps, k1_adcounter = {}, {}, []
    # K1: planes made from a seed at each logged shape, in its slabs, and
    # the slab sweep at each of them
    for key, count in shapes["gossip_round_dense"].items():
        r, d, k, slab = key
        ex, rm, nb = _k1_inputs(torch, r, d, k, nbrs=k1_nbrs.get(r))
        out = (torch.empty_like(ex), torch.empty_like(rm))
        ms = _time_ms(torch, lambda: cg._dense_launch(ex, rm, nb, *out, slab), 10)
        row_bytes = 2 * d * 4
        bound = (2 * r * row_bytes + r * k * 4) / bw * 1e3  # planes in + out, indices
        per_shape["gossip_round_dense"].append((key, count, ms, bound, None))
        want = cg.gossip_round_dense_plain(ex, rm, nb)
        sweeps[f"R={r} D={d} K={k}"] = _k1_sweep(torch, cg, ex, rm, nb, want)
        if r in k1_nbrs:  # the adcounter's shapes, on its own topology
            got = cg.gossip_round_dense(ex, rm, nb)
            k1_adcounter.append({
                "shape": dict(zip(fields["gossip_round_dense"], key)),
                "launches": count, "ms": ms, "bound_ms": bound, "bound_by": "bytes",
                "loss_ms": count * (ms - bound),
                "max_abs_err": _max_abs_err(torch, got, want),
                "plain_ms": _time_ms(
                    torch, lambda: cg.gossip_round_dense_plain(ex, rm, nb), 3),
            })
            del got
        if r == 1 << 18 and d == 1024:  # the headline shape
            got = cg.gossip_round_dense(ex, rm, nb)
            err = _max_abs_err(torch, got, want)
            del got
            widest["gossip_round_dense"] = {
                "max_abs_err": err, "ms": ms,
                "call_ms": _call_ms(torch, lambda: cg.gossip_round_dense(
                    ex, rm, nb, out=out), 20),
                "plain_ms": _time_ms(
                    torch, lambda: cg.gossip_round_dense_plain(ex, rm, nb), 3),
                "bound_ms": bound, "bound_by": "bytes",
                "gather_model_bound_ms": (k + 2) * r * row_bytes / bw * 1e3,
                "row_bytes": row_bytes,
                "gather_model_bytes": (k + 2) * r * row_bytes,
                "gather_model_row_moves_bytes": (k + 2) * r * row_bytes,
                "shape": dict(zip(fields["gossip_round_dense"], key)),
            }
        del ex, rm, nb, out, want
    for r, d, k in _K1_SWEEP_IN_L2:
        ex, rm, nb = _k1_inputs(torch, r, d, k)
        want = cg.gossip_round_dense_plain(ex, rm, nb)
        sweeps[f"R={r} D={d} K={k} (off the main path)"] = _k1_sweep(
            torch, cg, ex, rm, nb, want)
        del ex, rm, nb, want
    # K2 / K3: the captured launches replayed on their runtime's states (or
    # on seeded members of their layout, one layout at a time)
    for name in ("gossip_round_rows", "gossip_round_rows_vclock"):
        for key, count in sorted(shapes[name].items(),
                                 key=lambda kc: _layout_order(captured[(name, kc[0])])):
            cap = captured[(name, key)]
            call, leaves, plan, row_bytes, nb = _rows_call(
                cg, sources.get(cap["source"]), cap)
            ms = _time_ms(torch, call, 10, spin_cycles=_QUEUE_AHEAD_CYCLES // 10)
            k = key[fields[name].index("K")]
            masked = bool(key[fields[name].index("masked")])
            bound, gather = _rows_bound_bytes(cap["rows"].cpu().numpy(),
                                              nb.cpu().numpy(), row_bytes, k, masked)
            is_widest = (key == widest_k2 if name == "gossip_round_rows" else
                         key == max(shapes[name], key=lambda x: x[0] * x[1]))
            # every shape held against its plain version on the same inputs
            stacked = [torch.stack(ms_) for ms_ in leaves]
            if plan.kind == "vclock":
                plain = lambda: cg.gossip_round_rows_vclock_plain(  # noqa: E731
                    *stacked, nb, cap["rows"], cap["mask"])
            else:
                plain = lambda: cg.gossip_round_rows_plain(  # noqa: E731
                    plan.op, stacked, nb, cap["rows"], cap["mask"])
            (got, ch), (want, ch_w) = call(), plain()
            err = max(_max_abs_err(torch, got, want),
                      int((ch.int() - ch_w.int()).abs().max()))
            del got, want, ch, ch_w
            per_shape[name].append((key, count, ms, bound / bw * 1e3, err))
            if is_widest:
                widest[name] = {
                    "max_abs_err": err, "ms": ms,
                    "call_ms": _call_ms(torch, call, 20),
                    "plain_ms": _time_ms(torch, plain, 3),
                    "bound_ms": bound / bw * 1e3, "bound_by": "bytes",
                    "gather_model_bound_ms": gather / bw * 1e3,
                    "row_bytes": row_bytes,
                    "gather_model_bytes": int(gather),
                    "gather_model_row_moves_bytes": (k + 2) * cap["rows"].numel() * row_bytes,
                    "shape": dict(zip(fields[name], key)),
                }
            del call, leaves, stacked, plain
    _SYNTH[:] = [None, None]
    return per_shape, widest, sweeps, k1_adcounter


def _layout_order(cap) -> str:
    """Sort key keeping the shapes of one seeded layout together (the
    replays of captured members first)."""
    syn = cap.get("synthetic")
    return "" if syn is None else repr(syn["key"])


#: warming calls that open each profiled window of the one-kernel check
_WARM_CALLS = 4


#: one-element fills that mark where a profiled window's count starts
_MARKERS = 3


def _device_kernels(torch, warm, calls) -> "dict | None":
    """Run each of ``warm`` and then each of ``calls`` once under
    ``torch.profiler``: the device activities (kernels, copies, fills) that
    ``calls`` put on the card, by name and count — those that start after
    the last of ``_MARKERS`` one-element float64 fills enqueued between the
    two (the markers, left out with the sleep kernels that open and close
    the window; no wrapper of the count fills a float64 tensor). In full
    runs the profiler drops the records of a few device activities of a
    window (PERF.md), so ``warm`` launches each kernel of the count first,
    outside it, and a lost marker record leaves the others to mark the
    start. None when every marker's record is missing (the window cannot
    be read)."""
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros((1,), dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for call in warm:
            call()
        torch.cuda.synchronize()
        for _ in range(_MARKERS):  # the count starts after these kernels
            marker.fill_(7.0)
        for call in calls:
            call()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    is_marker = [("FillFunctor<double>" in e.key) for e in device]
    marks = [e.time_range.start for e, m in zip(device, is_marker) if m]
    if not marks:
        return None
    start = max(marks)
    return dict(Counter(e.key for e, m in zip(device, is_marker)
                        if not m and "spin_kernel" not in e.key
                        and e.time_range.start > start))


#: profiled replays of the K2 / K3 shapes before the one-kernel check gives up
_PROFILE_WINDOWS = 5


#: wrapper calls replayed in one profiled window of the one-kernel check
_PROFILE_CHUNK = 16


def _one_kernel_per_call(torch, cg, shapes, captured, sources, widest) -> None:
    """Every K2 / K3 shape of the main path replayed once under the
    profiler: each wrapper call must put exactly one kernel, its own, on
    the card (no cast, no comparison, no fill). Each window first runs
    ``_WARM_CALLS`` calls of the other kernel of the library and the chunk
    itself, outside the count (``_device_kernels``). A dropped record can
    only lower a count, so a window fails at once on a kernel of another
    name or more kernels than calls. The calls go in windows of at most
    ``_PROFILE_CHUNK``; each chunk passes when one of ``_PROFILE_WINDOWS``
    windows shows one kernel a call."""
    names = ("gossip_round_rows", "gossip_round_rows_vclock")

    def call_of(name, key):
        cap = captured[(name, key)]
        return _rows_call(cg, sources.get(cap["source"]), cap)[0]

    # chunks of one seeded layout at most (its members are made before the
    # counted calls, by the window's warm calls)
    chunks = {}
    for name in names:
        keys = sorted(shapes[name], key=lambda k: _layout_order(captured[(name, k)]))
        chunks[name] = []
        for key in keys:
            layout = _layout_order(captured[(name, key)])
            last = chunks[name][-1] if chunks[name] else None
            if last is None or last[0] != layout or len(last[1]) == _PROFILE_CHUNK:
                chunks[name].append((layout, []))
            chunks[name][-1][1].append(key)
    # the other kernel's warm call: a shape replayed on captured members
    first = {name: next((k for k in shapes[name] if captured[(name, k)]["source"]),
                        next(iter(shapes[name]))) for name in names}
    warm = {name: call_of(name, first[name]) for name in names}
    for name, other in zip(names, reversed(names)):
        seen = []
        for _layout, keys in chunks[name]:
            chunk = [call_of(name, key) for key in keys]
            for attempt in range(_PROFILE_WINDOWS):
                kernels = _device_kernels(
                    torch, [warm[other]] * _WARM_CALLS + chunk, chunk)
                if kernels is None:
                    got = -1
                    continue
                got = sum(kernels.values())
                if got > len(chunk) or any(f"{name}_kernel" not in n for n in kernels):
                    raise RuntimeError(f"{name}: {len(chunk)} wrapper calls put "
                                       f"these on the card: {kernels}")
                if got == len(chunk):
                    seen.append([got, attempt + 1])
                    break
            else:
                raise RuntimeError(
                    f"{name}: {len(chunk)} wrapper calls at shapes "
                    f"{keys} showed only {got} kernels "
                    f"in each of {_PROFILE_WINDOWS} profiled windows: {kernels}")
            del chunk
        widest[name]["device_kernels_per_call"] = 1.0
        # [kernels seen, windows opened] a chunk
        widest[name]["profiled_windows_kernels"] = seen
    _SYNTH[:] = [None, None]


def _k2_loss_split(cg, rows) -> dict:
    """K2's ``loss_ms`` by launch class: narrow frontiers (F <= 512, at the
    card's launch floor), wide frontiers of one member, wide frontiers of
    a group."""
    f = cg.SHAPE_FIELDS["gossip_round_rows"]
    split = {"F<=512": 0.0, "G=1, F>512": 0.0, "G>1, F>512": 0.0}
    for key, c, ms, b, _err in rows:
        cls = ("F<=512" if key[f.index("F")] <= 512 else
               "G=1, F>512" if key[f.index("G")] == 1 else "G>1, F>512")
        split[cls] += c * (ms - b)
    return split


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from lasp_tpu_torch.bench_scenarios import orset_anti_entropy
    from lasp_tpu_torch.bridge import etf
    from lasp_tpu_torch.bridge_state import to_numpy
    from lasp_tpu_torch.mesh import random_regular
    from lasp_tpu_torch.ops import _build
    from lasp_tpu_torch.ops import cuda_gossip as cg
    from lasp_tpu_torch.telemetry import device_capability

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    global _CARD
    _CARD = smi
    kind = torch.cuda.get_device_name(0)
    # every bound below reads the peak from the port's one capability table
    cap = device_capability()
    peak_gbps = cap["peak_GBps"]
    if peak_gbps is None:
        raise RuntimeError(f"no published HBM bandwidth on record for {kind!r}")
    _log("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} "
                   f"| published HBM peak {peak_gbps} GB/s (device_capability: {cap})")

    # 1. build ------------------------------------------------------------------
    # the native host store (checkpoint phase) builds beside the kernels
    native = subprocess.Popen(
        ["make", "-B", "-C", str(Path(__file__).resolve().parent / "native"),
         "liblaspstore.so"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # and the bridge's native ETF arm: the port's own build of
    # native/laspetf.cpp (g++), beside the nvcc jobs
    etf_build: dict = {}

    def build_etf():
        try:
            etf_build["path"] = etf.build_native()
        except Exception as exc:  # noqa: BLE001 — raised below, in this thread
            etf_build["error"] = exc

    etf_thread = threading.Thread(target=build_etf)
    etf_thread.start()
    secs = _build.build_all()
    _log("build", f"{len(_build.SOURCES)} kernels built in {secs:.2f} s")
    make_out, _ = native.communicate(timeout=300)
    if native.returncode != 0:
        raise RuntimeError(f"make -C native liblaspstore.so failed:\n{make_out}")
    _log("build", "native/liblaspstore.so built (make -C native liblaspstore.so)")
    etf_thread.join(timeout=300)
    if "error" in etf_build:
        raise etf_build["error"]
    if etf.reselect() != "native":
        raise RuntimeError("the bridge's native ETF arm failed its conformance gate")
    _log("build", f"bridge ETF codec: native ({etf_build['path']})")
    for name in _build.SOURCES:
        report = Path(f"{_build.library_path(name)}.ptxas.txt").read_text()
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                _log("build", f"{name}: {line.strip()}")

    # 2. parity -----------------------------------------------------------------
    phase_parity(torch, cg)

    launches: dict = {}
    shapes: dict = {}
    captured: dict = {}
    # 3. headline ---------------------------------------------------------------
    cg.reset_launches()
    r_head, k_head = 1 << 18, 3
    head = orset_anti_entropy(r_head, fanout=k_head, block=4, n_elems=128,
                              n_actors=64, tokens_per_actor=4)
    torch.cuda.synchronize()
    launches["headline"], shapes["headline"] = dict(cg.LAUNCHES), _shape_counts(cg)
    if head["check"] != "converged+all-live":
        raise RuntimeError("headline did not converge with every element live")
    # the bytes a round must move: each replica's row of both planes read
    # once and written once, its K neighbour indices read once
    required = (2 * r_head * head["state_bytes_per_replica"] + r_head * k_head * 4
                ) * head["rounds"]
    required_gbps = required / head["seconds"] / 1e9
    _log_line("headline", {
        k: head[k] for k in ("scenario", "rounds", "seconds", "merges_per_sec",
                             "state_bytes_per_replica")
    } | {"required_GBps": required_gbps,
         "share_of_peak_hbm": required_gbps / peak_gbps,
         "issued_GBps_gather_model": head["achieved_GBps"],
         "productive_rounds_per_block":
             head["convergence"]["productive_rounds_per_block"],
         "seconds_each": head["timing"]["seconds_each"]})

    # 22. scenarios, before the runtimes the kernels phase replays are
    # resident: packed_vs_dense's dense arm needs about 68 GiB of the card
    sc = phase_scenarios(torch, cg, captured)
    launches["scenarios"], shapes["scenarios"] = sc["launches"], sc["shapes"]
    _log("launches", f"scenarios: {launches['scenarios']}")

    # 4. engine -----------------------------------------------------------------
    n = 100_000
    nbrs = random_regular(n, 3, seed=0)
    cg.reset_launches()
    t0 = time.perf_counter()
    rt_d, ids, expected, total = _engine(torch, n, nbrs)
    rounds_d = rt_d.run_to_convergence(mode="dense")
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    rt_f, _, _, _ = _engine(torch, n, nbrs)
    _capture_rows_inputs(cg, rt_f, "engine", captured)
    t0 = time.perf_counter()
    rounds_f = rt_f.run_to_convergence(mode="frontier")
    torch.cuda.synchronize()
    t_frontier = time.perf_counter() - t0
    launches["engine"], shapes["engine"] = dict(cg.LAUNCHES), _shape_counts(cg)
    if rounds_d != rounds_f:
        raise RuntimeError(f"engine: dense took {rounds_d} rounds, frontier {rounds_f}")
    for v in ids:
        for a, b in zip(to_numpy(rt_d.states[v]), to_numpy(rt_f.states[v])):
            if not np.array_equal(a, b):
                raise RuntimeError(f"engine: dense and frontier states differ on {v}")
        if rt_d.divergence(v) != 0 or rt_f.divergence(v) != 0:
            raise RuntimeError(f"engine: {v} did not converge")
    if rt_d.coverage_value(ids[0]) != expected or rt_f.coverage_value(ids[0]) != expected:
        raise RuntimeError("engine: OR-Set coverage value is wrong")
    if rt_d.coverage_value(ids[1]) != total or rt_f.coverage_value(ids[1]) != total:
        raise RuntimeError("engine: G-Counter coverage value is wrong")
    # K2's widest shape: the engine's widest sparse OR-Set round (two leaves)
    fields2 = cg.SHAPE_FIELDS["gossip_round_rows"]
    widest_k2 = max((key for key in shapes["engine"]["gossip_round_rows"]
                     if key[fields2.index("leaves")] == 2),
                    key=lambda x: x[fields2.index("F")])
    _log_line("engine", {
        "replicas": n, "rounds": rounds_d, "dense_seconds": t_dense,
        "frontier_seconds": t_frontier, "coverage_elems": len(expected),
        "counter": total, "widest_sparse_rows": widest_k2[fields2.index("F")],
    })
    for phase, counts in launches.items():
        _log("launches", f"{phase}: {counts}")
    if launches["headline"]["gossip_round_dense"] == 0:
        raise RuntimeError("the headline never launched K1")
    if launches["engine"]["gossip_round_dense"] == 0:
        raise RuntimeError("the engine path never launched K1")
    if launches["engine"]["gossip_round_rows"] == 0:
        raise RuntimeError("the engine path never launched K2")
    del rt_d

    # 5. plan ---------------------------------------------------------------------
    plan = phase_plan(torch, cg, n, captured)
    launches["plan"], shapes["plan"] = plan["launches"], plan["shapes"]
    _log("launches", f"plan: {launches['plan']}")
    # 6. baseline -----------------------------------------------------------------
    base = phase_baseline(torch, cg)
    launches["baseline"], shapes["baseline"] = base["launches"], base["shapes"]
    _log("launches", f"baseline: {launches['baseline']}")
    # 7. ingest -------------------------------------------------------------------
    ing = phase_ingest(torch, cg, captured)
    launches["ingest"], shapes["ingest"] = ing["launches"], ing["shapes"]
    _log("launches", f"ingest: {launches['ingest']}")
    # 8. reads --------------------------------------------------------------------
    rd = phase_reads(torch, cg, n, nbrs)
    launches["reads"], shapes["reads"] = rd["launches"], rd["shapes"]
    _log("launches", f"reads: {launches['reads']}")
    # 9. map ----------------------------------------------------------------------
    mp = phase_map(torch, cg)
    launches["map"], shapes["map"] = mp["launches"], mp["shapes"]
    _log("launches", f"map: {launches['map']}")
    # 10. compaction --------------------------------------------------------------
    cp = phase_compaction(torch, cg)
    launches["compaction"], shapes["compaction"] = cp["launches"], cp["shapes"]
    _log("launches", f"compaction: {launches['compaction']}")
    # 11. dataflow ----------------------------------------------------------------
    df = phase_dataflow(torch, cg)
    launches["dataflow"], shapes["dataflow"] = df["launches"], df["shapes"]
    _log("launches", f"dataflow: {launches['dataflow']}")
    # 12. membership --------------------------------------------------------------
    mb = phase_membership(torch, cg, captured)
    launches["membership"], shapes["membership"] = mb["launches"], mb["shapes"]
    _log("launches", f"membership: {launches['membership']}")
    # 13. checkpoint --------------------------------------------------------------
    run_dir = tempfile.TemporaryDirectory()
    kept_store = str(Path(run_dir.name) / "store.lasp")
    ck = phase_checkpoint(torch, cg, mb["rt"], mb["ids"], captured, kept_store)
    launches["checkpoint"], shapes["checkpoint"] = ck["launches"], ck["shapes"]
    _log("launches", f"checkpoint: {launches['checkpoint']}")
    sources = {"engine": rt_f, "plan": plan["rt"], "ingest": ing["rt"],
               "membership": mb["rt"]}
    # 14. chaos -------------------------------------------------------------------
    ch = phase_chaos(torch, cg, captured, sources)
    launches["chaos"], shapes["chaos"] = ch["launches"], ch["shapes"]
    _log("launches", f"chaos: {launches['chaos']}")
    # 15. quorum ------------------------------------------------------------------
    qm = phase_quorum(torch, cg)
    launches["quorum"], shapes["quorum"] = qm["launches"], qm["shapes"]
    _log("launches", f"quorum: {launches['quorum']}")
    # 16. aae ---------------------------------------------------------------------
    aa = phase_aae(torch, cg, captured)
    launches["aae"], shapes["aae"] = aa["launches"], aa["shapes"]
    _log("launches", f"aae: {launches['aae']}")
    # 17. rebalance ---------------------------------------------------------------
    rb = phase_rebalance(torch, cg, captured)
    launches["rebalance"], shapes["rebalance"] = rb["launches"], rb["shapes"]
    _log("launches", f"rebalance: {launches['rebalance']}")
    del rb
    # 18. serve -------------------------------------------------------------------
    sv = phase_serve(torch, cg, captured)
    launches["serve"], shapes["serve"] = sv["launches"], sv["shapes"]
    _log("launches", f"serve: {launches['serve']}")
    del sv
    # 19. programs ----------------------------------------------------------------
    pg = phase_programs(torch, cg, captured, peak_gbps)
    launches["programs"], shapes["programs"] = pg["launches"], pg["shapes"]
    _log("launches", f"programs: {launches['programs']}")
    del pg
    # 20. session -----------------------------------------------------------------
    se = phase_session(torch, cg, captured)
    launches["session"], shapes["session"] = se["launches"], se["shapes"]
    _log("launches", f"session: {launches['session']}")
    # 21. bridge ------------------------------------------------------------------
    br = phase_bridge(torch, cg)
    launches["bridge"], shapes["bridge"] = br["launches"], br["shapes"]
    _log("launches", f"bridge: {launches['bridge']}")
    # 23. cli (subprocesses: their launches are their own, not counted here) ----
    phase_cli(torch, kept_store, run_dir.name)
    # K2 and K3 replayed under the profiler before the adcounter: in windows
    # opened after the 10,485,760-replica phase the profiler lost some of
    # their kernel records (PERF.md)
    profiled = {name: {} for name in ("gossip_round_rows", "gossip_round_rows_vclock")}
    rows_shapes = {name: {} for name in profiled}
    for phase_shapes in shapes.values():
        for name in rows_shapes:
            for key, c in phase_shapes[name].items():
                rows_shapes[name][key] = rows_shapes[name].get(key, 0) + c
    _one_kernel_per_call(torch, cg, rows_shapes, captured, sources, profiled)
    _log("kernels", "one device kernel per K2 / K3 wrapper call (torch.profiler)")

    # 24. adcounter ---------------------------------------------------------------
    ad = phase_adcounter(torch, cg)
    launches["adcounter"], shapes["adcounter"] = ad["launches"], ad["shapes"]
    _log("launches", f"adcounter: {launches['adcounter']}")

    # 25. kernels at the main path's shapes ---------------------------------------
    bw = peak_gbps * 1e9
    main_shapes = {name: {} for name in cg.LAUNCHES}
    for phase_shapes in shapes.values():
        for name, counts in phase_shapes.items():
            for key, c in counts.items():
                main_shapes[name][key] = main_shapes[name].get(key, 0) + c
    head_keys = list(shapes["headline"]["gossip_round_dense"])
    if not head_keys or any(key[3] >= key[1] for key in head_keys):
        raise RuntimeError(f"the headline's K1 launches did not take column slabs: "
                           f"{head_keys}")
    per_shape, widest, sweeps, k1_adcounter = phase_kernels(
        torch, cg, bw, main_shapes, captured, sources, widest_k2,
        {_ADCOUNTER_REPLICAS: ad.pop("neighbors")})
    if len(k1_adcounter) != len(shapes["adcounter"]["gossip_round_dense"]):
        raise RuntimeError("K1 was not held at every adcounter shape")
    for shape, sweep in sweeps.items():
        _log("kernels", f"K1 slab sweep at {shape}: " + json.dumps(
            [[w, round(ms, 5)] for w, ms in sweep]) + " ([slab_words, ms])")
    _log("kernels", "shapes " + json.dumps({
        name: {"fields": cg.SHAPE_FIELDS[name],
               "rows [key, launches, ms, bound_ms]": [
                   [list(key), c, round(ms, 5), round(b, 5)] for key, c, ms, b, _e in rows]}
        for name, rows in per_shape.items()}))
    for name, fields in profiled.items():
        widest[name].update(fields)
    adcounter_profile(torch, ad)
    # 26. telemetry: the capability row, the ledger, the flight ring -----------
    flight = north_star_flight(torch, ad)
    phase_telemetry(torch, cg, kind, peak_gbps, widest, flight)

    def total_launches(name):
        return sum(c[name] for c in launches.values())

    meta = {
        "gossip_round_dense": ("lasp_tpu_torch/ops/csrc/gossip_round_dense.cu",
                               "lasp_tpu/ops/pallas_gossip.py:125"),
        "gossip_round_rows": ("lasp_tpu_torch/ops/csrc/gossip_round_rows.cu",
                              "lasp_tpu/ops/pallas_gossip.py:439"),
        "gossip_round_rows_vclock": ("lasp_tpu_torch/ops/csrc/gossip_round_rows.cu",
                                     "lasp_tpu/ops/pallas_gossip.py:439"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": total_launches(name),
            "launches_by_phase": {p: c[name] for p, c in launches.items()},
            **widest[name], "library_ms": None,
            "loss_ms": sum(c * (ms - b) for _key, c, ms, b, _e in per_shape[name]),
            "n_shapes": len(per_shape[name]),
        })
    kernels[0]["adcounter_shapes"] = k1_adcounter
    for k in kernels[1:]:
        # the masked launches (the chaos soaks'), one mask byte an edge read
        f = cg.SHAPE_FIELDS[k["name"]]
        rows = [row for row in per_shape[k["name"]] if row[0][f.index("masked")]]
        k["masked_shapes"] = [{"shape": dict(zip(f, key)), "launches": c, "ms": ms,
                               "bound_ms": b, "max_abs_err": err}
                              for key, c, ms, b, err in rows]
        k["masked_loss_ms"] = sum(c * (ms - b) for _key, c, ms, b, _e in rows)
        # every shape of the main path, each held against its plain version
        errs = [err for _key, _c, _ms, _b, err in per_shape[k["name"]]]
        k["held_shapes"] = len(errs)
        k["max_abs_err_all_shapes"] = max(errs)
        _log("kernels", f"{k['name']}: {len(errs)} main-path shapes held against "
                        f"the plain version, max_abs_err {max(errs)}")
    kernels[1]["loss_split_ms"] = _k2_loss_split(cg, per_shape["gossip_round_rows"])
    if any(k["max_abs_err"] for k in kernels) or any(
            s["max_abs_err"] for s in k1_adcounter) or any(
            k["max_abs_err_all_shapes"] for k in kernels[1:]):
        raise RuntimeError(f"kernel disagrees with plain at the main-path shape: {kernels}")
    run_dir.cleanup()
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1,  # the cards this run used
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
