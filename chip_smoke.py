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
               and with direct writes (bit-equal to the static twin), at
               25,000 replicas on ``random_regular(., 3)`` (cut from
               100,000 for the script's time);
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
               for the 17 index views); 128 seeded events over 48 keys
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
               seeded stream of 500 requests over 1,024 variables (16 in
               each of riak_core's 64 partitions, ``ingest_storm``'s five
               kinds, one request in ten a 16-variable ``merge_batch``, the
               rest YCSB workload A's zipfian reads and updates) in
               durable mode, every response equal byte for byte to a CPU
               server's in this process, every variable read back equal after
               a restart on the same ``data_dir``; requests/s, p50 / p99 ms
               and the card's busy share over those requests;
22. scenarios — run between phases 3 and 4, before the runtimes that
               the kernels phase replays (about 12 GiB) are resident:
               ``frontier_sparse(n_replicas=100_000)``, ``many_vars(
               n_replicas=100_000, n_vars=128, reps=1)``,
               ``packed_vs_dense(blocks=2)`` at JAX's 1,048,576 replicas
               (its dense arm peaks near 68 GiB; the peak reported) and
               ``roofline_workload()``, each with its
               own check, their K1 / K2 / K3 probes held at max_abs_err 0;
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
               arms against JAX's 5% budget (reported, never failing), PR
               17's figure beside each; then the parity drive
               (``telemetry_drive``: every telemetry site at 2,048 replicas
               of the engine's widths, the tests' drive) on the card and
               again with ``device="cpu"`` through the plain versions, the
               two transcripts (metric families, labels, counts, events,
               span order) equal, K1, K2 and K3 launched, each one's
               widest call held against its plain version;
27. shard   — run after the cli phase, before the adcounter: 8 virtual
               shards of the card, (a) ``partitioned_gossip()``, (b)
               ``mesh_scale(1 << 20)``, (c) the membership variables at
               100,000 replicas through ``_shard_drive`` in both exchange
               modes against an unsharded twin (``phase_shard``);
28. distributed — the shard phase's work on two processes sharing the
               card: the script spawns two copies of itself
               (``--distributed-worker``) joined by
               ``comm.init_distributed`` (gloo, host staging), 4 of the 8
               shards each; (a)-(c) held against the shard phase's runs
               (each shard's hash, rounds, every residual, coverage), K1, K2
               and K3 launched on each rank and each rank's widest launch
               held against its plain version; within 120 s
               (``phase_distributed``); then (d) the serving path at
               100,000 replicas on the gather path (``shard(mesh)``): the
               row verbs, parked reads and compaction on a packed runtime,
               ``chaos_heal``'s drive with a packed OR-Set, ``quorum_kv``'s
               drive under every preset and ``serve_load``'s drive (ticks
               cut), each held against a one-process run (states, rounds,
               fingerprints), K1 launched on each rank and its widest
               launch held against its plain version; within 150 s; then
               (e) membership, Lasp's programs, ``Session``, the map and
               the actor guard on the gather path: ``resize`` to 150,000,
               a graceful leave to 100,000, a ``MembershipCoordinator``'s
               staged grow to 150,000 in cycles of 12,500, a crash leave
               to 96,000 and the staged commits at the membership phase's
               population; ``riak_index_2i`` at 4,096 replicas and 96
               events, sharded once its programs registered; a
               ``Session`` at 100,000 replicas through ``nemesis``,
               ``quorum`` and ``serve`` (``aae`` refused for parity), a
               map write admitting fields and the guard's collision naming
               replica rows; each held against a one-process run (shard
               hashes, rounds, values, messages), K1 launched on each rank
               and its widest launch held against its plain version;
               within 150 s; then (f) the gather path's sparse frontier:
               the engine's population plus two OR-SWOTs (A=4, E=8 and
               A=E=64) at 100,000 replicas, 64 writes a variable,
               ``frontier_step`` while every reach stays under the
               crossover, the round past it refused for parity with every
               shard hash and frontier unchanged, ``run_to_convergence(
               mode="auto")``, then writes at 2% of the rows and ``auto``
               again; each held against a one-process run (shard hashes,
               every residual, rounds, rows touched, coverage), each arm's
               rounds, bytes carried and seconds recorded, K2 and K3
               launched on each rank and every kernel's widest launch of
               (d)-(f) held against its plain version; within 90 s.

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
#: the script's start, for the seconds each phase's launches line reports
_T0 = time.perf_counter()


def _log_launches(phase: str, counts: dict) -> None:
    """A phase's kernel launches, and the seconds since the script began."""
    _log("launches", f"{phase}: {counts} ({time.perf_counter() - _T0:.1f} s into the run)")


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


def _engine(torch, n, nbrs, orswots=()):
    """The engine population (packed OR-Set 64 x 16 x 4 and G-Counter, 16
    writers) on ``nbrs``, with an OR-SWOT ``(id, n_elems, n_actors)`` of
    ``orswots`` each declared beside them."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime
    from lasp_tpu_torch.store import Store

    store = Store(n_actors=16)
    ads = store.declare(id="ads", type="lasp_orset", n_elems=64, n_actors=16,
                        tokens_per_actor=4)
    views = store.declare(id="views", type="riak_dt_gcounter", n_actors=16)
    for vid, n_elems, n_actors in orswots:
        store.declare(id=vid, type="riak_dt_orswot", n_elems=n_elems, n_actors=n_actors)
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
            # on the engine's dataflow_propagate_seconds clock (JAX's), and
            # on the wall time of the whole propagate (earlier runs' clock)
            "fused_speedup": out["fused_speedup"],
            "fused_speedup_wall": t["per_edge"]["propagate_seconds"]
            / t["fused"]["propagate_seconds"], **{
                arm: {k: t[arm][k] for k in ("roundloop_seconds", "propagate_seconds",
                                             "seconds_each", "sweeps", "host_syncs")}
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
            rt.trace.rounds.clear()
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


#: the membership harness's replicas in the rebalance phase: cut from
#: 100,000, the phase's host-bound part, when the whole script took 1,134.9
#: and 1,162.5 s of its 1,200 s on slow hosts (PERF.md section 4)
_HARNESS_REPLICAS = 25_000


def phase_rebalance(torch, cg, captured: dict, n: int = _CHAOS_REPLICAS,
                    h: int = _HARNESS_REPLICAS) -> dict:
    """(a) ``bench_scenarios.elastic_rebalance`` at ``n`` -> ``3n/2`` ->
    ``n`` (the membership phase's extents) on ``random_regular(., 3)``,
    ``per_cycle = n/8`` (JAX's 4 transfer cycles for the joining rows): it
    asserts the staged and legacy grown populations bit-equal, no cycle
    over the cap and the staged transfer wire <= the full-resync wire. (b)
    ``_harness_runs`` at ``h``."""
    from lasp_tpu_torch.bench_scenarios import elastic_rebalance

    cg.reset_launches()
    undo = _capture_rows_shapes(cg, captured, "rebalance")
    try:
        el, secs = _timed_step(torch, lambda: elastic_rebalance(
            n_replicas=n, grow_to=n * 3 // 2, per_cycle=n // 8,
            topology="random_regular"))
        el_launches = dict(cg.LAUNCHES)
        harness = _harness_runs(torch, cg, h)
        for preset, rec in harness.items():
            _log_line("rebalance", {"part": "harness", "preset": preset,
                                    "replicas": h, **rec})
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
_BRIDGE = {"n_requests": 500, "n_partitions": 64, "vars_per_partition": 16,
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
    the seeded stream of 500 requests over 1,024 variables (16 in each
    of riak_core's 64 partitions, ``ingest_storm``'s five kinds; one in ten
    a 16-variable ``merge_batch``, the rest YCSB workload A's reads and
    updates) in durable mode, every response equal
    byte for byte to a second server's on the CPU in this process; the
    server restarted on the same ``data_dir`` must read every variable back
    as it answered before (no acked write lost). Requests/s, p50 / p99 ms,
    and the card's busy share over those requests of an in-memory server."""
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
    # the busy share over the requests only: the stores are declared
    # before the profiler opens
    with BridgeServer() as server:
        clients = bridge_clients(server.port, stream["setup"])
        try:
            busy = _device_busy(torch, lambda: bridge_requests(
                clients, stream["requests"]))
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
    n_replicas=100_000, n_vars=128, reps=1)`` (``plan="off"`` and
    ``"auto"``: residuals and states identical), ``packed_vs_dense(
    blocks=2)`` at JAX's 1,048,576 replicas (one value; the peak memory of
    the two arms),
    and ``roofline_workload()`` (its K1 and K2 / K3
    probes held at max_abs_err 0, the ledger's ``cuda_*`` families). The
    sharded scenarios run in the ``shard`` phase."""
    from lasp_tpu_torch.bench_scenarios import (frontier_sparse, many_vars,
                                                packed_vs_dense, roofline_workload)
    from lasp_tpu_torch.telemetry import get_ledger

    cg.reset_launches()
    undo = _capture_rows_shapes(cg, captured, "scenarios")
    out = {}
    try:
        for name, fn in (
                ("frontier_sparse", lambda: frontier_sparse(n_replicas=100_000)),
                # one timed replay an arm and 16 timed rounds (JAX: 3 and
                # 32): cuts of depth for the script's time
                ("many_vars", lambda: many_vars(n_replicas=100_000, n_vars=128, reps=1)),
                ("packed_vs_dense", lambda: packed_vs_dense(blocks=2))):
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
_SHARD = {"n_replicas": 100_000, "n_shards": 8}


def _shard_drive(torch, rt, n: int, expected: "dict | None" = None) -> list:
    """The shard phase's drive of one runtime of ``_membership_runtime``'s
    variables (unconverged): ``step()`` to the fixed point; 16 fresh writes
    and ``frontier_step()`` to the fixed point; 16 more and
    ``run_to_convergence(mode="auto")``; 16 more and ``converge_on_device()``.
    Returns, per segment, its rounds and a copy of every population at its
    end; ``rt.round_residuals`` holds the residual of every round. The
    writes are added to ``expected`` (``_membership_runtime``'s values) when
    it is given."""
    rows = np.random.RandomState(29).choice(n, 48, replace=False)
    out = []

    def segment(label, run):
        rounds = run()
        out.append((label, rounds, {v: tuple(x.clone() for x in rt.states[v])
                                    for v in rt.var_ids}))

    def writes(k):
        batch = [(int(rows[16 * k + a]), a, f"s{k}.{a}", a + 1) for a in range(16)]
        rt.update_batch("ads", [(r, ("add", f"ad{(a + 7 * k) % 64}"), f"w{a}")
                                for r, a, _t, _b in batch])
        _membership_writes(rt, batch)
        if expected is not None:
            expected["ads"] |= {f"ad{(a + 7 * k) % 64}" for a in range(16)}
            _expect(expected, batch)

    def loop(fn):
        rounds = 1
        while fn():
            rounds += 1
        return rounds

    segment("step", lambda: loop(rt.step))
    writes(0)
    segment("frontier_step", lambda: loop(rt.frontier_step))
    writes(1)
    segment("run_to_convergence_auto", lambda: rt.run_to_convergence(mode="auto"))
    writes(2)
    segment("converge_on_device", rt.converge_on_device)
    return out


def phase_shard(torch, cg, captured: dict, n: int = _SHARD["n_replicas"],
                pg_replicas: int = 1 << 20, ms_replicas: int = 1 << 20) -> dict:
    """Sharding on the card, 8 virtual shards of it: (a) ``partitioned_gossip()``
    at JAX's defaults (1,048,576 replicas of a 16-element G-Set on
    ``locality_order(scale_free(., 3, seed=1))``, k=3, 3 rounds): both
    exchange modes and the gather path equal (the scenario's check), the
    bytes each exchange moved a round against the population plane;
    (b) ``mesh_scale(n_replicas=1 << 20)`` with JAX's other defaults (k=3,
    ``write_frac=0.002``, 2 cycles, 2 variables x 64 elements,
    ``"alltoall"``, ``sync_every=8``): its 5x wire gate asserted, rounds per
    cycle, sparse against dense cut bytes, ``roofline_frac`` (must not be
    null); (c) the membership phase's variables (packed OR-Set 64 x 16 x 4,
    G-Counter, OR-SWOT 64 x 16) at 100,000 replicas on
    ``locality_order(scale_free(100_000, 3, seed=1))[1]``, sharded with
    ``partition=True`` in each mode and driven by ``_shard_drive`` against
    an unsharded twin: rounds, every round's residual and the states at the
    end of each segment bit-equal. Launches are counted from after the twin
    (the partitioned paths only); K1, K2 and K3 must each launch."""
    from lasp_tpu_torch.bench_scenarios import _block_hashes, mesh_scale, partitioned_gossip
    from lasp_tpu_torch.device import resolve_device
    from lasp_tpu_torch.mesh import locality_order, scale_free
    from lasp_tpu_torch.mesh import shard_gossip as sg
    from lasp_tpu_torch.mesh.comm import Mesh

    nbrs = locality_order(scale_free(n, 3, seed=1))[1]

    def build():
        rt, ids, _homes, expected = _membership_runtime(torch, n, converge=False)
        rt.resize(n, nbrs)  # the scale-free topology, same population
        return rt, ids, expected

    t0 = time.perf_counter()
    twin, ids, expected = build()
    want = _shard_drive(torch, twin, n, expected)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    twin_res = list(twin.round_residuals)
    del twin
    # the distributed phase's reference: per segment, each shard's hash
    block = n // _SHARD["n_shards"]
    reference = {"drive": {
        "rounds": [r for _l, r, _s in want], "residuals": twin_res,
        "hashes": [{v: _block_hashes(st, 0, _SHARD["n_shards"], block)
                    for v, st in states.items()} for _l, _r, states in want],
        "expected": {k: sorted(v) if isinstance(v, set) else v
                     for k, v in expected.items()},
    }}
    cg.reset_launches()
    sg.reset_exchange()
    undo = _capture_rows_shapes(cg, captured, "shard")
    rec = {}
    try:
        # (a)
        pg, secs = _timed_step(torch, lambda: partitioned_gossip(pg_replicas))
        rec["partitioned_gossip"] = {"phase_s": secs, **pg}
        reference["partitioned_gossip"] = pg
        _log_line("shard", {"case": "a", "phase_s": secs,
                            **{k: v for k, v in pg.items() if k != "block_hashes"}})
        # (b)
        ms, secs = _timed_step(torch, lambda: mesh_scale(n_replicas=ms_replicas))
        frac = ms["impl_roofline"]["shard_exchange"]["roofline_frac"]
        if frac is None:
            raise RuntimeError(f"shard: mesh_scale's roofline_frac is null: {ms}")
        if ms["wire_cut_at_5pct_dirty"] is None or (
                ms["wire_cut_at_5pct_dirty"] < ms["wire_gate"]):
            raise RuntimeError(f"shard: mesh_scale's wire gate: {ms}")
        rec["mesh_scale"] = {"phase_s": secs, **ms}
        reference["mesh_scale"] = ms
        _log_line("shard", {"case": "b", "phase_s": secs,
                            **{k: v for k, v in ms.items() if k != "block_hashes"}})
        # (c)
        mesh = Mesh([resolve_device(None)] * _SHARD["n_shards"], ("replicas",))
        for mode in ("gather", "alltoall"):
            t0 = time.perf_counter()
            rt, _ids, _exp = build()
            rt.shard(mesh, axis="replicas", partition=True, partition_mode=mode)
            got = _shard_drive(torch, rt, n)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            for (label, r_want, s_want), (_l, r_got, s_got) in zip(want, got):
                if r_want != r_got:
                    raise RuntimeError(f"shard {mode}: {label} took {r_got} rounds, "
                                       f"the unsharded twin {r_want}")
                for v in ids:
                    if not all(torch.equal(a, b) for a, b in zip(s_want[v], s_got[v])):
                        raise RuntimeError(f"shard {mode}: {label}: states of {v} "
                                           "differ from the unsharded twin")
            if list(rt.round_residuals) != twin_res:
                raise RuntimeError(f"shard {mode}: per-round residuals differ")
            for v in ids:
                if rt.divergence(v) != 0:
                    raise RuntimeError(f"shard {mode}: {v} did not converge")
            pplan = rt._partition["plan"]
            rec[f"membership_{mode}"] = {
                "seconds": secs, "rounds": [(lab, r) for lab, r, _s in got],
                "cut_rows": pplan["stats"]["send_rows"], "m": pplan["m"],
                "m2": pplan["m2"],
                "exchange_bytes_total": rt.part_exchange_bytes_total,
                "dense_plane_bytes_total": rt.part_dense_plane_bytes_total,
            }
            _log_line("shard", {"case": "c", "mode": mode, "twin_s": twin_s,
                                **rec[f"membership_{mode}"]})
            if mode == "alltoall":
                for v in ids:
                    if rt.coverage_value(v) != expected[v]:
                        raise RuntimeError(f"shard: coverage of {v} is "
                                           f"{rt.coverage_value(v)!r}, expected "
                                           f"{expected[v]!r}")
            del rt, got
    finally:
        undo()
    torch.cuda.synchronize()
    launches, shapes = dict(cg.LAUNCHES), _shape_counts(cg)
    _log_line("shard", {"launches": launches, "exchanged": sg.EXCHANGED,
                        "expected_coverage_elems": len(expected["ads"])})
    for name in cg.LAUNCHES:
        if not launches[name]:
            raise RuntimeError(f"shard: the partitioned path never launched {name}")
    return {"launches": launches, "shapes": shapes, "record": rec,
            "reference": reference}


#: the distributed phase: two ranks on the one card, 4 shard slots each, at
#: the shard phase's sizes
_DIST = {"world": 2, "pg_replicas": 1 << 20, "ms_replicas": 1 << 20,
         "timeout_s": 600, "limit_s": 120}

#: its segment (d), the serving path across the ranks: the chaos, quorum and
#: serve phases' population; ``serve_load``'s ticks cut from 40 (depth) so
#: that (d) stays inside ``limit_s``
_SERVING = {"n_replicas": _CHAOS_REPLICAS, "serve_ticks": 4, "limit_s": 150}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _serving_rows_runtime(n: int):
    """Segment (d)'s packed runtime: an OR-Set of 256 elements (8 actors x
    4 tokens), a G-Counter of 64 actors and a flag G-Set on
    ``random_regular(n, 3, seed=2)``."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, random_regular
    from lasp_tpu_torch.store import Store

    store = Store(n_actors=64)
    store.declare(id="ads", type="lasp_orset", n_elems=256, n_actors=8, tokens_per_actor=4)
    store.declare(id="views", type="riak_dt_gcounter", n_actors=64)
    store.declare(id="flag", type="lasp_gset", n_elems=2)
    return ReplicatedRuntime(store, Graph(store), n, random_regular(n, 3, seed=2),
                             packed=True)


def _serving_rows(torch, rt, hashes) -> dict:
    """Segment (d)'s row verbs, parked reads and compaction on ``rt``
    (:func:`_serving_rows_runtime`, sharded across processes or not):
    ``apply_batch`` seeds 56 G-Counter lanes at their writers' rows,
    ``update_batch`` adds all 256 elements, ``join_rows`` broadcast and per
    row, ``reseed_row`` to bottom and from a supplied row, ``read_until`` at
    the reseeded row, ``read_any_until``, removes then ``compact_orset``,
    then removes under a ``compaction_window`` with a builder-backed
    trigger. Returns every count, rounds, coverage, and ``hashes(rt)``."""
    from lasp_tpu_torch.lattice import Threshold

    homes = [int(r) for r in np.random.RandomState(31).choice(rt.n_replicas, 64,
                                                               replace=False)]
    lanes = rt.intern_actors("views", [f"w{a}" for a in range(56)])
    at = torch.as_tensor(homes[:56], device=rt.device)
    by = torch.as_tensor(lanes, dtype=torch.int64, device=rt.device)

    def seed(s):
        counts = s.counts.clone()
        counts[at, by] += (by + 1).to(counts.dtype)
        return s._replace(counts=counts)

    out = {"rounds": {}}
    rt.apply_batch("views", seed)
    total = int(sum(int(x) + 1 for x in lanes))
    rt.update_batch("ads", [(homes[a], ("add_all", [f"e{32 * a + k}" for k in range(32)]),
                             f"w{a}") for a in range(8)])
    out["joined"] = [
        rt.join_rows("ads", homes[56:59], rt._row_of("ads", homes[0])),
        rt.join_rows("views", homes[59:61], [rt._row_of("views", homes[1]),
                                             rt._row_of("views", homes[2])])]
    out["rounds"]["seeded"] = rt.run_to_convergence()
    saved = rt._row_of("views", homes[3])
    rt.reseed_row(homes[4])
    rt.reseed_row(homes[5], {"views": saved})
    row = rt.read_until(homes[4], "views", Threshold(total))
    out["read_until"] = int(row.counts.sum())
    rt.update_batch("views", [(homes[6], ("increment", 7), "w6")])
    var, row = rt.read_any_until(homes[61], [("views", Threshold(total + 1000)),
                                             ("views", Threshold(total + 7))])
    out["read_any_until"] = [var, int(row.counts.sum())]
    rt.update_batch("ads", [(homes[a], ("remove_all", [f"e{32 * a + k}" for k in
                                                        range(0, 32, 2)]), f"w{a}")
                            for a in range(8)])
    out["rounds"]["removed"] = rt.run_to_convergence()
    out["reclaimed"] = rt.compact_orset("ads")

    def make_trigger():
        (s_idx,) = rt.intern_terms("ads", ["sentinel"])
        (f_idx,) = rt.intern_terms("flag", ["raised"])
        onehot = torch.arange(2, device=rt.device) == int(f_idx)

        def trig(dense):
            st, fl = dense["ads"], dense["flag"]
            live = (st.exists[int(s_idx)] & ~st.removed[int(s_idx)]).any()
            return {"flag": fl._replace(mask=fl.mask | (onehot & live))}
        return trig

    rt.register_trigger(builder=make_trigger, touches=["ads", "flag"])
    rt.update_batch("ads", [(homes[a], ("remove_all", [f"e{32 * a + k}" for k in
                                                        range(1, 32, 4)]), f"w{a}")
                            for a in range(8)])
    with rt.compaction_window(block=1) as w:
        out["window_reclaimed"] = w.compact_orset("ads")
    rt.update_batch("ads", [(homes[0], ("add", "sentinel"), "w0")])
    out["rounds"]["window"] = rt.run_to_convergence()
    out["coverage"] = {"ads": len(rt.coverage_value("ads")),
                       "views": rt.coverage_value("views"),
                       "flag": sorted(rt.coverage_value("flag"))}
    out["divergence"] = {v: rt.divergence(v) for v in rt.var_ids}
    out["hashes"] = hashes(rt)
    return out


def _serving_chaos_runtime(n: int):
    """``chaos_heal``'s population at ``n`` replicas (its G-Set and writes,
    seed 17) with a packed OR-Set beside it, so that the fault-free
    windows run K1."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, random_regular
    from lasp_tpu_torch.store import Store

    store = Store(n_actors=8)
    store.declare(id="soak", type="lasp_gset", n_elems=128)
    store.declare(id="ads", type="lasp_orset", n_elems=32, n_actors=8, tokens_per_actor=4)
    rt = ReplicatedRuntime(store, Graph(store), n, random_regular(n, 3, seed=17),
                           packed=True)
    rows = np.random.RandomState(17).choice(n, size=max(4, n // 64), replace=False)
    rt.update_batch("soak", [(int(r), ("add", f"w{int(r) % 32}"), f"c{int(r)}")
                             for r in rows])
    rt.update_batch("ads", [(int(r), ("add", f"a{k % 32}"), f"w{k % 8}")
                            for k, r in enumerate(rows[:256])])
    return rt


def _serving_chaos(rt) -> dict:
    """``chaos_heal``'s soak on ``rt``: its composite nemesis (seed 17, 10
    fault rounds), fused windows of 8, a degraded read and its read-repair
    each faulty round. Returns the report's counts and the fingerprint of
    the healed states."""
    from lasp_tpu_torch.bench_scenarios import chaos_heal_schedule
    from lasp_tpu_torch.chaos import ChaosRuntime
    from lasp_tpu_torch.chaos.invariants import fingerprint, snapshot_states

    ch = ChaosRuntime(rt, chaos_heal_schedule(rt._host_neighbors, 17, 10))
    rep = ch.soak(mode="dense", block=8, reads_per_round=1, read_var="soak")
    return {**{k: rep[k] for k in ("rounds", "rounds_to_heal", "healed", "crashes",
                                   "restores", "degraded_reads", "repaired_rows")},
            "fused_windows": ch.fused_windows,
            "fingerprint": fingerprint(snapshot_states(rt))}


def _serving_load(rt) -> dict:
    """``serve_load``'s drive (10,000 clients, 1,200 arrivals a tick, a x5
    burst, 10,000 seed watches, 100,000 parity thresholds, the composite
    nemesis, seed 7) on ``rt`` (``serve.harness.load_runtime``), its ticks
    cut to ``_SERVING["serve_ticks"]``: the report and the fingerprint of
    the final states."""
    from lasp_tpu_torch.chaos.invariants import fingerprint, snapshot_states
    from lasp_tpu_torch.serve.harness import run_load

    ticks = _SERVING["serve_ticks"]
    rep = run_load(n_replicas=rt.n_replicas, n_clients=10_000, ticks=ticks,
                   arrivals_per_tick=1200, chaos=True, burst_at=max(2, ticks // 2),
                   burst_ticks=max(2, ticks // 8), burst_factor=5, seed_watches=10_000,
                   parity_thresholds=100_000, seed=7, runtime=rt)
    rep.pop("overlap_seconds")
    rep.pop("trace")
    return {"report": rep, "fingerprint": fingerprint(snapshot_states(rt))}


def _serving_twins(torch, n: int) -> dict:
    """Segment (d)'s one-process runs on this process's card: the rows
    drive (every shard's hash), the chaos drive (its healed states must
    equal its fault-free fixed point's) and the serve drive."""
    from lasp_tpu_torch.bench_scenarios import _block_hashes
    from lasp_tpu_torch.chaos.invariants import fingerprint, snapshot_states
    from lasp_tpu_torch.serve.harness import load_runtime

    shards = _SHARD["n_shards"]
    out = {"seconds": {}}
    t0 = time.perf_counter()
    out["rows"] = _serving_rows(torch, _serving_rows_runtime(n), lambda rt: {
        v: _block_hashes(rt.states[v], 0, shards, n // shards) for v in rt.var_ids})
    out["seconds"]["rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    free = _serving_chaos_runtime(n)
    free.run_to_convergence()
    free_print = fingerprint(snapshot_states(free))
    del free
    out["chaos"] = _serving_chaos(_serving_chaos_runtime(n))
    if out["chaos"]["fingerprint"] != free_print or not out["chaos"]["healed"]:
        raise RuntimeError("distributed (d): the one-process chaos drive did not heal "
                           "to its fault-free fixed point")
    out["seconds"]["chaos"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve"] = _serving_load(load_runtime(n, n_clients=10_000, seed=7))
    out["seconds"]["serve"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    return out


def _serving_worker(torch, cg, mesh, n: int) -> dict:
    """Segment (d) on one rank: each drive on a runtime sharded across the
    ranks on the gather path, its K1 launches counted and its widest K1
    launch held against ``gossip_round_dense_plain``."""
    from lasp_tpu_torch.bench_scenarios import (
        _block_hashes, quorum_kv_preset, quorum_kv_runtime, random_regular)
    from lasp_tpu_torch.chaos import PRESETS
    from lasp_tpu_torch.serve.harness import load_runtime

    def shard(rt):
        rt.shard(mesh)
        if rt._dist is None or rt._partition is not None:
            raise RuntimeError("distributed (d): the runtime is not on the gather path")
        return rt

    def hashes(rt):
        d = rt._dist
        return {v: _block_hashes(rt.states[v], d["first"], d["count"],
                                 n // _SHARD["n_shards"]) for v in rt.var_ids}

    import lasp_tpu_torch.mesh.gossip as gossip_mod

    out = {"seconds": {}}
    kept, undo = _widest_calls(torch, cg)
    # the gather path calls K1 by the name mesh.gossip imported
    inner = gossip_mod.gossip_round_dense
    gossip_mod.gossip_round_dense = cg.gossip_round_dense
    cg.reset_launches()
    try:
        t0 = time.perf_counter()
        out["rows"] = _serving_rows(torch, shard(_serving_rows_runtime(n)), hashes)
        out["seconds"]["rows"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["chaos"] = _serving_chaos(shard(_serving_chaos_runtime(n)))
        out["seconds"]["chaos"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        nbrs = random_regular(n, 3, seed=23)
        out["quorum"] = {}
        for preset in PRESETS:
            rec = quorum_kv_preset(shard(quorum_kv_runtime(nbrs)), preset,
                                   client_rounds=8, puts_per_round=24, gets_per_round=24)
            out["quorum"][preset] = {k: rec[k] for k in (
                "rounds", "requests", "completed", "failed", "no_write_lost",
                "acked_writes", "state_fingerprint", "trace_sha256")}
        out["seconds"]["quorum"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["serve"] = _serving_load(shard(load_runtime(n, n_clients=10_000, seed=7)))
        out["seconds"]["serve"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        out["launches"] = dict(cg.LAUNCHES)  # the drives', before the check
    finally:
        gossip_mod.gossip_round_dense = inner
        undo()
    out["kernel_checks"] = _check_widest(torch, cg, kept)
    return out


def _check_serving(r: int, got: dict, twins: dict, quorum: dict) -> None:
    """Hold rank ``r``'s segment (d) against the one-process runs; raise on
    any difference."""
    rows, want = got["rows"], twins["rows"]
    for key in ("rounds", "joined", "read_until", "read_any_until", "reclaimed",
                "window_reclaimed", "coverage", "divergence"):
        if rows[key] != want[key]:
            raise RuntimeError(f"distributed (d) rows: rank {r}'s {key} {rows[key]}, "
                               f"one process {want[key]}")
    for v, hashes in rows["hashes"].items():
        if any(want["hashes"][v][k] != h for k, h in hashes.items()):
            raise RuntimeError(f"distributed (d) rows: rank {r}'s shards of {v} differ "
                               "from the one-process run's")
    if got["chaos"] != twins["chaos"]:
        raise RuntimeError(f"distributed (d) chaos: rank {r} {got['chaos']}, one "
                           f"process {twins['chaos']}")
    for preset, rec in got["quorum"].items():
        one = quorum[preset]
        if not rec["no_write_lost"] or any(rec[k] != one[k] for k in (
                "state_fingerprint", "trace_sha256", "rounds", "requests", "completed",
                "failed", "acked_writes")):
            raise RuntimeError(f"distributed (d) quorum {preset}: rank {r} {rec}, the "
                               f"quorum phase {one}")
    if set(got["quorum"]) != set(quorum):
        raise RuntimeError(f"distributed (d) quorum: rank {r} ran {sorted(got['quorum'])}")
    serve, one = got["serve"], twins["serve"]
    bad = [k for k in serve["report"]["shed"] if k.split(":")[-1] not in _SHED_REASONS]
    if (serve != one or bad or not serve["report"]["no_write_lost"]
            or not serve["report"]["threshold_parity"]["parity"]):
        raise RuntimeError(f"distributed (d) serve: rank {r} {serve}, one process {one}")
    _check_segment_kernels("d", r, got, ("gossip_round_dense",))


#: its segment (e), membership, Lasp's programs, ``Session``, the map and the
#: actor guard across the ranks on the gather path: the membership and
#: session phases' populations at 100,000 replicas, the coordinator's staged
#: cycles of 12,500 (the rebalance phase's), and the 2i programs at 4,096
#: replicas with 96 events (cuts of scale and depth: a 2i gather round
#: carries ~139 KB a row, ~7 GB a rank at 100,000 replicas; the programs
#: phase runs 128 events, and this stream's first compaction comes at 80)
_MEMBERSHIP_E = {"n_replicas": _MEMBERSHIP_REPLICAS, "per_cycle": 12_500,
                 "programs_replicas": 4_096, "programs_events": 96, "limit_s": 150}


def _e_hashes(rt) -> dict:
    """Each shard's hash of every population (:func:`_block_hashes`): a
    rank's own shards, or all 8 of a one-process runtime."""
    from lasp_tpu_torch.bench_scenarios import _block_hashes

    d, shards = rt._dist, _SHARD["n_shards"]
    if d is None:
        return {v: _block_hashes(rt.states[v], 0, shards, -(-rt.n_replicas // shards))
                for v in rt.var_ids}
    return {v: _block_hashes(rt.states[v], d["first"], d["count"], d["block"])
            for v in rt.var_ids}


def _membership_e(torch, shard) -> dict:
    """Segment (e)'s membership part on the membership phase's population
    (``_membership_runtime`` at 100,000 replicas, converged, then
    ``shard``): (3) ``resize`` to 150,000; (4) writes at rows >= 100,000,
    then a graceful ``resize`` to 100,000; a ``MembershipCoordinator``
    grows 100,000 -> 150,000 in staged cycles of 12,500
    (``run_to_settled``, dense); (5) tail writes, then a crash leave to
    96,000; (6) ``membership_grow`` to 100,000 with
    ``changed_delivery_rows``, then ``membership_drop_tail`` to 96,000. Each
    step converges dense; ``coverage_value`` must equal the plain-Python
    expectation and ``divergence`` be 0. Returns the rounds, the shard
    hashes after each step, the coordinator's report and the seconds."""
    from lasp_tpu_torch.membership import MembershipCoordinator, changed_delivery_rows
    from lasp_tpu_torch.mesh import random_regular

    n = _MEMBERSHIP_E["n_replicas"]
    big, small = n * 3 // 2, n * 24 // 25  # 150,000 and 96,000
    rt, ids, _homes, expected = _membership_runtime(torch, n)
    rt = shard(rt)
    out = {"rounds": {}, "hashes": {}, "seconds": {}, "epochs": {}}

    def converge(step: str) -> None:
        out["rounds"][step], out["seconds"][step] = _timed_step(
            torch, lambda: rt.run_to_convergence(mode="dense"))
        want = {"ads": frozenset(expected["ads"]), "views": expected["views"],
                "tags": frozenset(expected["tags"])}
        for v in ids:
            got = rt.coverage_value(v)
            if got != want[v] or rt.divergence(v):
                raise RuntimeError(f"distributed (e) membership: after {step} {v} is "
                                   f"{got!r} (divergence {rt.divergence(v)}), expected "
                                   f"{want[v]!r}")
        out["hashes"][step] = _e_hashes(rt)
        out["epochs"][step] = [rt.n_replicas, rt.membership_epoch]

    rt.resize(big, random_regular(big, 3, seed=1))
    converge("grow")
    high = [(n + (big - n) * a // 16 + 7, a, f"h{a}", 3) for a in range(16)]
    _membership_writes(rt, high)
    rt.update_batch("ads", [(row, ("add", f"ad{48 + a}"), f"w{a}") for row, a, _t, _b in high])
    _expect(expected, high)
    expected["ads"] |= {f"ad{48 + a}" for a in range(16)}
    rt.resize(n, random_regular(n, 3, seed=2))
    converge("graceful_leave")
    mc = MembershipCoordinator(rt, per_cycle=_MEMBERSHIP_E["per_cycle"])
    mc.stage_join(big, random_regular(big, 3, seed=6))
    mc.commit()
    rep, out["seconds"]["coordinator"] = _timed_step(
        torch, lambda: mc.run_to_settled(mode="dense"))
    out["coordinator"] = {k: rep[k] for k in ("epoch", "n_replicas", "commits", "transferred",
                                              "transfer_bytes", "max_cycle_batch",
                                              "settle_rounds")}
    out["coordinator"]["rounds"] = mc.ch.round
    converge("coordinator")
    tail = [(small + a, a, f"lost{a}", 100 + a) for a in range(8)]
    _membership_writes(rt, tail)  # never gossiped: not expected
    nb_small = random_regular(small, 3, seed=3)
    rt.resize(small, nb_small, graceful=False)
    converge("crash_leave")
    grown = random_regular(n, 3, seed=4)
    rt.membership_grow(n, grown, dirty_rows=changed_delivery_rows(nb_small, grown, small, n))
    converge("membership_grow")
    shrunk = random_regular(small, 3, seed=5)
    rt.membership_drop_tail(small, shrunk,
                            dirty_rows=changed_delivery_rows(grown, shrunk, n, small))
    converge("membership_drop_tail")
    out["row_bytes"] = sum(rt._row_bytes(v) for v in ids)
    return out


def _programs_e(torch, shard) -> dict:
    """Segment (e)'s programs part: ``riak_index_2i`` at 4,096 replicas and
    96 events, the runtime sharded by ``shard`` once its programs are
    registered; the scenario raises unless its ring-coverage execute, each
    program's ``execute``, the quorum execute and ``riak_index_reference``
    agree. Returns its counts and the shard hashes of its populations."""
    from lasp_tpu_torch.bench_scenarios import riak_index_2i

    rep = riak_index_2i(n_replicas=_MEMBERSHIP_E["programs_replicas"],
                        n_events=_MEMBERSHIP_E["programs_events"], keep_runtime=True,
                        shard=shard)
    rt = rep.pop("runtime")
    if rep["compactions"] < 1:
        raise RuntimeError(f"distributed (e) programs: no compaction in {rep}")
    out = {k: rep[k] for k in ("compactions", "converge_rounds", "values", "programs",
                               "views", "events")}
    out["hashes"] = _e_hashes(rt)
    out["row_bytes"] = sum(rt._row_bytes(v) for v in rt.var_ids)
    out["seconds"] = {k: rep[k] for k in ("process_s", "converge_s", "sweep_s")}
    return out


def _session_e(torch, shard) -> dict:
    """Segment (e)'s session part at 100,000 replicas: a ``Session``'s
    variables (``_session_declare``) through ``replicate(n,
    topology="random", fanout=3, seed=0, packed=True)``, then ``shard``; the
    16 writers converged; ``nemesis("ring-cut")``'s dense soak; a
    ``quorum`` put and get; ``serve`` on a tick clock; across the ranks
    ``aae`` must refuse for parity (ROADMAP A5c.8); a ``riak_dt_map``
    declared late and written twice, admitting two fields, converged; on a
    ``debug_actors`` runtime a second write site of one actor must raise,
    naming the replica rows. Returns every count, value, message and the
    shard hashes."""
    from lasp_tpu_torch import Session
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ActorCollisionError, ReplicatedRuntime, random_regular
    from lasp_tpu_torch.store import Store

    n = _MEMBERSHIP_E["n_replicas"]
    out = {"seconds": {}}
    s = Session(n_actors=16)
    _session_declare(s, s)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the locality note
        rt = shard(s.replicate(n, topology="random", fanout=3, seed=0, packed=True))
    for v, vops in _session_ops(n).items():
        rt.update_batch(v, vops)
    out["rounds"], out["seconds"]["converge"] = _timed_step(torch, rt.run_to_convergence)
    chaos = s.nemesis(rt, "ring-cut", seed=0)
    soak, out["seconds"]["nemesis_soak"] = _timed_step(torch, chaos.soak)
    if not soak["healed"]:
        raise RuntimeError(f"distributed (e) session: the soak did not heal: {soak}")
    out["soak"] = {k: soak[k] for k in ("rounds", "rounds_to_heal", "healed")}
    kv = s.quorum(chaos)
    put = kv.submit_put("ads", ("add", "ad63"), "w0")
    get = kv.submit_get("ads")
    for _ in range(64):
        kv.step()
        if "pending" not in (kv.result(put)["status"], kv.result(get)["status"]):
            break
    out["quorum"] = [kv.result(put)["status"], kv.result(get)["status"]]
    if out["quorum"][0] not in ("done", "acked") or out["quorum"][1] != "done":
        raise RuntimeError(f"distributed (e) session: the quorum requests: {out['quorum']}")
    ticks = iter(range(1 << 20))
    fe = s.serve(rt, clock=lambda: float(next(ticks)))
    ticket = fe.submit_write("views", ("increment",), "w1")
    fe.cycle()
    out["serve"] = ticket.status
    if ticket.status != "done":
        raise RuntimeError(f"distributed (e) session: the served write ended {ticket.status}")
    if rt._dist is not None:
        try:
            s.aae(rt)
            raise RuntimeError("distributed (e) session: Session.aae ran across the ranks")
        except NotImplementedError as exc:
            if "A5c.8" not in str(exc) or "parity" not in str(exc):
                raise RuntimeError(f"distributed (e) session: aae refused with {exc}") from exc
    s.declare(type="riak_dt_map", id="m")
    rt.update_at(3, "m", ("update", ("k", "riak_dt_gcounter"), ("increment", 2)), "a")
    rt.update_at(n // 2 + 3, "m", ("update", ("s", "lasp_gset"), ("add", "x")), "b")
    out["map_rounds"], out["seconds"]["map_converge"] = _timed_step(torch, rt.run_to_convergence)
    out["values"] = {v: rt.coverage_value(v) for v in ("ads", "views", "tags", "seen", "m")}
    if out["values"]["m"] != {("k", "riak_dt_gcounter"): 2, ("s", "lasp_gset"): {"x"}}:
        raise RuntimeError(f"distributed (e) session: the map reads {out['values']['m']}")
    out["hashes"] = _e_hashes(rt)
    out["values"] = {v: sorted(x) if isinstance(x, (set, frozenset)) else x
                     for v, x in out["values"].items() if v != "m"}
    store = Store(n_actors=4)
    store.declare(id="c", type="riak_dt_gcounter")
    guarded = shard(ReplicatedRuntime(store, Graph(store), n,
                                      random_regular(n, 3, seed=0), debug_actors=True))
    guarded.update_at(3, "c", ("increment", 1), "zz")
    try:
        guarded.update_at(n // 2 + 3, "c", ("increment", 1), "zz")
        raise RuntimeError("distributed (e) session: the actor guard let a second site write")
    except ActorCollisionError as exc:
        out["guard"] = str(exc)
    if f"at replica 3; writing from replica {n // 2 + 3}" not in out["guard"]:
        raise RuntimeError(f"distributed (e) session: the guard said {out['guard']!r}")
    return out


def _membership_parts(torch, shard) -> dict:
    """Segment (e)'s three parts with ``shard`` applied to each runtime
    (a rank's) or not (the parent's one-process twins)."""
    out = {"seconds": {}}
    for name, part in (("membership", _membership_e), ("programs", _programs_e),
                       ("session", _session_e)):
        t0 = time.perf_counter()
        out[name] = part(torch, shard)
        out["seconds"][name] = time.perf_counter() - t0
    torch.cuda.synchronize()
    return out


def _membership_worker(torch, cg, mesh) -> dict:
    """Segment (e) on one rank: each part on runtimes sharded across the
    ranks on the gather path, its K1 launches counted and its widest K1
    launch held against ``gossip_round_dense_plain``."""
    import lasp_tpu_torch.mesh.gossip as gossip_mod

    def shard(rt):
        rt.shard(mesh)
        if rt._dist is None or rt._partition is not None:
            raise RuntimeError("distributed (e): the runtime is not on the gather path")
        return rt

    kept, undo = _widest_calls(torch, cg)
    # the gather path calls K1 by the name mesh.gossip imported
    inner = gossip_mod.gossip_round_dense
    gossip_mod.gossip_round_dense = cg.gossip_round_dense
    cg.reset_launches()
    try:
        out = _membership_parts(torch, shard)
        out["launches"] = dict(cg.LAUNCHES)  # the drives', before the check
    finally:
        gossip_mod.gossip_round_dense = inner
        undo()
    out["kernel_checks"] = _check_widest(torch, cg, kept)
    return out


def _check_membership_e(r: int, got: dict, twins: dict) -> None:
    """Hold rank ``r``'s segment (e) against the one-process twins; raise
    on any difference."""
    for part, keys in (("membership", ("rounds", "epochs", "coordinator", "row_bytes")),
                       ("programs", ("compactions", "converge_rounds", "values",
                                     "programs", "views", "row_bytes")),
                       ("session", ("rounds", "soak", "quorum", "serve", "map_rounds",
                                    "values", "guard"))):
        mine, want = got[part], twins[part]
        for key in keys:
            if mine[key] != want[key]:
                raise RuntimeError(f"distributed (e) {part}: rank {r}'s {key} {mine[key]}, "
                                   f"one process {want[key]}")
        hashes = mine["hashes"]
        for step, by_var in (hashes.items() if part == "membership" else [(None, hashes)]):
            theirs = want["hashes"][step] if step is not None else want["hashes"]
            for v, hs in by_var.items():
                if not hs or any(theirs[v][k] != h for k, h in hs.items()):
                    raise RuntimeError(f"distributed (e) {part} {step or ''}: rank {r}'s "
                                       f"shards of {v} differ from the one-process run's")
    _check_segment_kernels("e", r, got, ("gossip_round_dense",))


def _check_segment_kernels(seg: str, r: int, got: dict, needed) -> None:
    """Rank ``r``'s segment ``seg`` launched each kernel of ``needed``, and
    each kernel it launched was held at its widest launch against its plain
    version at max_abs_err 0."""
    for name in needed:
        if got["launches"][name] < 1:
            raise RuntimeError(f"distributed ({seg}): rank {r} never launched {name}")
    launched = {name for name, c in got["launches"].items() if c}
    if not launched <= set(got["kernel_checks"]):
        raise RuntimeError(f"distributed ({seg}): rank {r} launched {sorted(launched)}, "
                           f"held {sorted(got['kernel_checks'])}")
    for name, chk in got["kernel_checks"].items():
        if chk["max_abs_err"] != 0:
            raise RuntimeError(f"distributed ({seg}): rank {r}'s widest {name} launch "
                               f"disagrees with its plain version: {chk}")


#: its segment (f), the gather path's sparse frontier across the ranks: the
#: engine's population (``_engine`` on ``random_regular(100_000, 3,
#: seed=0)``) plus two OR-SWOTs, ``many_vars``' narrow rows (A=4, E=8) and
#: the rebalance phase's (A=E=64), so that K2 and K3 both launch; 64 writes
#: a variable, then writes at 2% of the rows a variable (``frontier_sparse``'s
#: share). No cut
_FRONTIER_F = {"n_replicas": 100_000, "writes": 64, "share": 0.02, "limit_s": 90}

#: each (f) variable's universe: (element prefix, or None for the counter,
#: elements, actors); the engine's writers fill ``ads``' 64 elements and
#: both its variables' 16 actors
_F_UNIVERSE = {"ads": ("ad", 64, 16), "views": (None, 0, 16), "narrow": ("x", 8, 4),
               "wide": ("y", 64, 64)}


def _frontier_writes(rt, rng, k: int) -> None:
    """Client writes at ``k`` rows of each variable drawn from ``rng``:
    row ``r`` adds element ``r % elements`` (increments the counter) as
    actor ``w{r % actors}``, so actors write at many rows, as in
    ``many_vars``."""
    for v in rt.var_ids:
        name, n_elems, n_actors = _F_UNIVERSE[v]
        rows = [int(r) for r in rng.choice(rt.n_replicas, k, replace=False)]
        op = (lambda r: ("increment", 1)) if name is None else (
            lambda r: ("add", f"{name}{r % n_elems}"))
        rt.update_batch(v, [(r, op(r), f"w{r % n_actors}") for r in rows])


def _frontier_f(torch, shard) -> dict:
    """Segment (f)'s drive with ``shard`` applied to its runtime (a rank's)
    or not (the parent's one-process twin): 64 writes a variable;
    ``frontier_step`` while no variable's reach passes the crossover (the
    sparse arm); across the ranks the round past it must refuse for parity
    (ROADMAP A5c.2, C9) and leave every shard hash and frontier as it was;
    ``run_to_convergence(mode="auto")`` to quiescence; writes at 2% of the
    rows a variable and ``auto`` again. Returns each stage's shard hashes,
    every round's residual, the explicit rounds' ``[residual,
    frontier_rows_last, dense falls]``, ``auto``'s rounds, the coverage
    values, the row bytes and each arm's rounds, bytes carried and
    seconds (the dense arm: the gather step ``auto`` takes across the
    ranks for a round past the crossover)."""
    from lasp_tpu_torch.mesh import ReplicatedRuntime, comm, random_regular

    n = _FRONTIER_F["n_replicas"]
    rt, _ids, _expected, _total = _engine(
        torch, n, random_regular(n, 3, seed=0), orswots=(("narrow", 8, 4), ("wide", 64, 64)))
    rt = shard(rt)
    arms = {arm: {"rounds": 0, "bytes": 0, "seconds": 0.0} for arm in ("sparse", "dense")}

    def timed(arm, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), comm.carried_bytes()
            out = fn(*args)
            torch.cuda.synchronize()
            arms[arm]["rounds"] += 1
            arms[arm]["seconds"] += time.perf_counter() - t0
            arms[arm]["bytes"] += comm.carried_bytes() - c0
            return out
        return run

    # every round of the drive by arm (instance attributes over the methods
    # that run_to_convergence calls)
    rt.frontier_step = timed("sparse", rt.frontier_step)
    rt._gather_step_exact = timed("dense", rt._gather_step_exact)
    rng = np.random.RandomState(31)
    out = {"hashes": {}, "residuals": {}, "rounds": {}, "seconds": {}, "sparse": []}
    _frontier_writes(rt, rng, _FRONTIER_F["writes"])
    n0, t0 = len(rt.round_residuals), time.perf_counter()
    while rt._frontier_dense_arm(None) is None:
        res = rt.frontier_step()
        out["sparse"].append([res, rt.frontier_rows_last, rt.frontier_dense_falls_last])
        if not res:
            break
    torch.cuda.synchronize()
    out["seconds"]["sparse"] = time.perf_counter() - t0
    out["residuals"]["sparse"] = rt.round_residuals[n0:]
    out["hashes"]["sparse"] = _e_hashes(rt)
    if rt._dist is not None:
        frontiers = {v: rt._frontier[v].copy() for v in rt.var_ids}
        try:
            ReplicatedRuntime.frontier_step(rt)
            refused = None
        except RuntimeError as exc:
            refused = str(exc)
        if refused is None or "past the crossover" not in refused or "A5c.2" not in refused:
            raise RuntimeError(f"distributed (f): the round past the crossover: {refused}")
        if _e_hashes(rt) != out["hashes"]["sparse"] or any(
                not np.array_equal(rt._frontier[v], f) for v, f in frontiers.items()):
            raise RuntimeError("distributed (f): the refused round moved a state or frontier")
        out["refused"] = refused
    for stage, k in (("auto", 0), ("auto_2pct", int(_FRONTIER_F["share"] * n))):
        if k:
            _frontier_writes(rt, rng, k)
        n0 = len(rt.round_residuals)
        out["rounds"][stage], out["seconds"][stage] = _timed_step(
            torch, lambda: rt.run_to_convergence(mode="auto"))
        out["residuals"][stage] = rt.round_residuals[n0:]
        out["hashes"][stage] = _e_hashes(rt)
    out["coverage"] = {v: sorted(x) if isinstance(x, (set, frozenset)) else x
                       for v, x in ((v, rt.coverage_value(v)) for v in rt.var_ids)}
    out["row_bytes"] = {v: rt._row_bytes(v) for v in rt.var_ids}
    out["arms"] = arms
    return out


def _frontier_worker(torch, cg, mesh) -> dict:
    """Segment (f) on one rank, on the gather path of the same mesh: its
    K1 / K2 / K3 launches counted and each one's widest launch held
    against its plain version."""
    import lasp_tpu_torch.mesh.gossip as gossip_mod

    def shard(rt):
        rt.shard(mesh)
        if rt._dist is None or rt._partition is not None:
            raise RuntimeError("distributed (f): the runtime is not on the gather path")
        return rt

    kept, undo = _widest_calls(torch, cg)
    # the gather path calls K1 by the name mesh.gossip imported
    inner = gossip_mod.gossip_round_dense
    gossip_mod.gossip_round_dense = cg.gossip_round_dense
    cg.reset_launches()
    try:
        out = _frontier_f(torch, shard)
        out["launches"] = dict(cg.LAUNCHES)  # the drive's, before the check
    finally:
        gossip_mod.gossip_round_dense = inner
        undo()
    out["kernel_checks"] = _check_widest(torch, cg, kept)
    return out


def _check_frontier_f(r: int, got: dict, twin: dict) -> None:
    """Hold rank ``r``'s segment (f) against the one-process twin; raise on
    any difference."""
    for key in ("sparse", "residuals", "rounds", "coverage", "row_bytes"):
        if got[key] != twin[key]:
            raise RuntimeError(f"distributed (f): rank {r}'s {key} {got[key]}, one "
                               f"process {twin[key]}")
    for stage, by_var in got["hashes"].items():
        for v, hs in by_var.items():
            if not hs or any(twin["hashes"][stage][v][k] != h for k, h in hs.items()):
                raise RuntimeError(f"distributed (f) {stage}: rank {r}'s shards of {v} "
                                   "differ from the one-process run's")
    if not got["sparse"] or any(falls for _res, _rows, falls in got["sparse"]):
        raise RuntimeError(f"distributed (f): rank {r}'s explicit rounds {got['sparse']}")
    _check_segment_kernels("f", r, got, ("gossip_round_rows", "gossip_round_rows_vclock"))


def phase_distributed(torch, reference: dict, quorum: dict) -> dict:
    """The shard phase's work across processes: this script spawns
    ``_DIST["world"]`` copies of itself (``--distributed-worker``) with
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` /
    ``LOCAL_RANK`` set, one card shared, so ``comm.init_distributed``
    joins them over gloo with host staging. Each worker
    (:func:`distributed_worker`) holds 4 of the 8 shards and runs (a)
    ``partitioned_gossip()`` at 1,048,576 replicas, (b) ``mesh_scale(1 <<
    20)``, (c) the membership variables at 100,000 replicas through
    ``_shard_drive`` in both modes, then holds its widest K1, K2 and K3
    launch against their plain versions. Here the workers' results are
    held against the shard phase's one-process runs (``reference``):
    (a) each shard's hash, (b) the rounds per cycle, the wire gate and a
    roofline share, (c) every segment's rounds, every round's residual,
    each shard's hash of every population at each segment's end and the
    coverage values. Then each worker runs segment (d), the serving path
    on the gather path (:func:`_serving_worker`), while this process runs
    its one-process twins (:func:`_serving_twins`); each rank's (d) is held
    against them and against the quorum phase's records (``quorum``, by
    preset) by :func:`_check_serving`, and must end within
    ``_SERVING["limit_s"]``. Then segment (e), membership, Lasp's programs,
    ``Session``, the map and the actor guard on the gather path
    (:func:`_membership_worker`), is held against this process's
    one-process twins by :func:`_check_membership_e` and must end within
    ``_MEMBERSHIP_E["limit_s"]``. Then segment (f), the gather path's
    sparse frontier (:func:`_frontier_worker`), is held against this
    process's one-process twin by :func:`_check_frontier_f` and must end
    within ``_FRONTIER_F["limit_s"]``. A worker that fails or overruns
    fails the phase, with the tail of its stderr."""
    import os

    out_dir = tempfile.mkdtemp(prefix="lasp-dist-")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(_DIST["world"]), LOCAL_WORLD_SIZE=str(_DIST["world"]))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--distributed-worker", out_dir],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(_DIST["world"])]
    outs, failed = [], []
    try:
        t_twins = time.perf_counter()
        twins = _serving_twins(torch, _SERVING["n_replicas"])
        twins["seconds"]["all"] = time.perf_counter() - t_twins
        t_twins = time.perf_counter()
        etwins = _membership_parts(torch, lambda rt: rt)
        etwins["seconds"]["all"] = time.perf_counter() - t_twins
        t_twins = time.perf_counter()
        ftwin = _frontier_f(torch, lambda rt: rt)
        ftwin["seconds"]["all"] = time.perf_counter() - t_twins
        # as the workers' files hold them (tuples as lists, keys as text)
        twins = json.loads(json.dumps(twins, default=str))
        etwins = json.loads(json.dumps(etwins, default=str))
        ftwin = json.loads(json.dumps(ftwin, default=str))
        for r, p in enumerate(procs):
            left = _DIST["timeout_s"] - (time.perf_counter() - t0)
            try:
                out, err = p.communicate(timeout=max(1.0, left))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                failed.append(f"rank {r} ran past {_DIST['timeout_s']} s")
            if p.returncode:
                failed.append(f"rank {r} exited {p.returncode}")
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    for r, (out, err) in enumerate(outs):
        for line in out.splitlines()[-4:]:
            _log("distributed", f"rank {r}: {line}")
        if failed:
            _log("distributed", f"rank {r} stderr tail:\n{err[-3000:]}")
    if failed:
        raise RuntimeError(f"distributed: {'; '.join(failed)}")
    ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
             for r in range(_DIST["world"])]
    drive = reference["drive"]
    for res in ranks:
        r = res["rank"]
        if res["backend"]["backend"] != "gloo" or res["world"] != _DIST["world"]:
            raise RuntimeError(f"distributed: rank {r} joined {res['backend']}")
        if not res["device"].startswith("cuda"):
            raise RuntimeError(f"distributed: rank {r} computed on {res['device']}")
        want = {str(k): h for k, h in
                reference["partitioned_gossip"]["block_hashes"].items()}
        got = res["partitioned_gossip"]["block_hashes"]
        if len(got) != 8 // _DIST["world"] or any(want[k] != h for k, h in got.items()):
            raise RuntimeError(f"distributed (a): rank {r}'s shards differ from the "
                               "one-process run")
        ms = res["mesh_scale"]
        if ms["rounds_to_quiescence"] != reference["mesh_scale"]["rounds_to_quiescence"]:
            raise RuntimeError(f"distributed (b): rank {r} took {ms['rounds_to_quiescence']} "
                               "rounds a cycle, one process "
                               f"{reference['mesh_scale']['rounds_to_quiescence']}")
        if ms["wire_cut_at_5pct_dirty"] is None or (
                ms["wire_cut_at_5pct_dirty"] < ms["wire_gate"]):
            raise RuntimeError(f"distributed (b): rank {r}'s wire gate failed")
        if ms["impl_roofline"]["shard_exchange"]["roofline_frac"] is None:
            raise RuntimeError(f"distributed (b): rank {r}'s roofline_frac is null")
        for mode, got in res["membership"].items():
            if got["rounds"] != drive["rounds"]:
                raise RuntimeError(f"distributed (c) {mode}: rank {r} took {got['rounds']} "
                                   f"rounds, the unsharded twin {drive['rounds']}")
            if got["residuals"] != drive["residuals"]:
                raise RuntimeError(f"distributed (c) {mode}: rank {r}'s residuals differ "
                                   "from the unsharded twin's")
            for seg, (mine, theirs) in enumerate(zip(got["hashes"], drive["hashes"])):
                for v, hashes in mine.items():
                    if any(theirs[v][int(k)] != h for k, h in hashes.items()):
                        raise RuntimeError(f"distributed (c) {mode}: segment {seg}: rank "
                                           f"{r}'s shards of {v} differ from the twin's")
            if got["coverage"] != drive["expected"]:
                raise RuntimeError(f"distributed (c) {mode}: coverage {got['coverage']}, "
                                   f"expected {drive['expected']}")
        for name, n in res["launches"].items():
            if n < 1:
                raise RuntimeError(f"distributed: rank {r} never launched {name}")
        for name, chk in res["kernel_checks"].items():
            if chk["max_abs_err"] != 0:
                raise RuntimeError(f"distributed: rank {r}'s {name} disagrees with "
                                   f"its plain version: {chk}")
        if set(res["kernel_checks"]) != set(res["launches"]):
            raise RuntimeError(f"distributed: rank {r} held {sorted(res['kernel_checks'])}")
        _check_serving(r, res["serving"], twins, quorum)
        _check_membership_e(r, res["membership_e"], etwins)
        _check_frontier_f(r, res["frontier_f"], ftwin)
    line = {"seconds": secs, "world": _DIST["world"], "backend": ranks[0]["backend"],
            "ranks": [{
                "rank": res["rank"], "device": res["device"],
                "launches": res["launches"], "kernel_checks": res["kernel_checks"],
                "seconds": res["seconds"],
                "partitioned_gossip": {k: res["partitioned_gossip"][k] for k in (
                    "per_round_s", "process_bytes_per_round",
                    "exchange_allgather_bytes_per_round", "alltoall_bytes_per_round",
                    "dense_allgather_bytes_per_round")},
                "mesh_scale": {k: res["mesh_scale"][k] for k in (
                    "rounds_to_quiescence", "wire_cut_at_5pct_dirty", "wire_gate",
                    "hier_converge", "process_bytes_total", "cut_rows_sparse_bytes",
                    "sparse_round_seconds_total", "impl_roofline")},
                "membership": {m: {k: v for k, v in got.items()
                                   if k not in ("hashes", "residuals", "coverage")}
                               for m, got in res["membership"].items()},
                "serving": {
                    "seconds": res["serving"]["seconds"],
                    "launches": res["serving"]["launches"],
                    "kernel_checks": res["serving"]["kernel_checks"],
                    "rows": {k: res["serving"]["rows"][k] for k in (
                        "rounds", "joined", "read_until", "read_any_until", "reclaimed",
                        "window_reclaimed", "coverage")},
                    "chaos": res["serving"]["chaos"],
                    "quorum_rounds": {p: q["rounds"]
                                      for p, q in res["serving"]["quorum"].items()},
                    "serve": {k: res["serving"]["serve"]["report"][k] for k in (
                        "completed", "shed", "watch_fires", "gossip_rounds", "cycles",
                        "acked_writes", "threshold_parity", "chaos")},
                    "stage_s": res["serving"]["stage_s"],
                    "carried_bytes": res["serving"]["carried_bytes"],
                },
                "membership_e": {
                    **{k: res["membership_e"][k] for k in (
                        "seconds", "launches", "kernel_checks", "stage_s", "carried_bytes")},
                    "membership": {k: res["membership_e"]["membership"][k] for k in (
                        "rounds", "epochs", "coordinator", "seconds", "row_bytes")},
                    "programs": {k: v for k, v in res["membership_e"]["programs"].items()
                                 if k != "hashes"},
                    "session": {k: v for k, v in res["membership_e"]["session"].items()
                                if k != "hashes"},
                },
                "frontier_f": {k: v for k, v in res["frontier_f"].items()
                               if k not in ("hashes", "residuals", "coverage")},
            } for res in ranks],
            "serving_twins_s": twins["seconds"], "membership_e_twins_s": etwins["seconds"],
            "frontier_f_twin": {k: ftwin[k] for k in ("seconds", "arms", "rounds")}}
    _log_line("distributed", line)
    limit = (_DIST["limit_s"] + _SERVING["limit_s"] + _MEMBERSHIP_E["limit_s"]
             + _FRONTIER_F["limit_s"])
    if secs > limit:
        raise RuntimeError(f"distributed: the phase took {secs:.1f} s, over {limit} s")
    for res in ranks:  # (a)-(c)'s own bound: the phase less this rank's (d)-(f)
        abc = secs - res["seconds"]["d"] - res["seconds"]["e"] - res["seconds"]["f"]
        if abc > _DIST["limit_s"]:
            raise RuntimeError(f"distributed (a)-(c): rank {res['rank']} took {abc:.1f} s, "
                               f"over {_DIST['limit_s']} s")
    for seg, lim in (("d", _SERVING["limit_s"]), ("e", _MEMBERSHIP_E["limit_s"]),
                     ("f", _FRONTIER_F["limit_s"])):
        took = max(res["seconds"][seg] for res in ranks)
        if took > lim:
            raise RuntimeError(f"distributed ({seg}): took {took:.1f} s, over {lim} s")
    return line


def _widest_calls(torch, cg) -> tuple:
    """Wrap K1's, K2's and K3's wrappers so that each keeps a copy of the
    inputs of its widest call (source rows x words, or slots x row
    words). Returns ``(kept, undo)``."""
    kept: dict = {}
    inner = {name: getattr(cg, name) for name in cg.LAUNCHES}

    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (list, tuple)):
            return [copy(y) for y in x]
        return x

    def keep(name, size, args):
        if size > kept.get(name, (0, None))[0]:
            kept[name] = (size, copy(args))

    def dense(exists, removed, neighbors, out=None):
        keep("gossip_round_dense", exists.numel(), (exists, removed, neighbors))
        return inner["gossip_round_dense"](exists, removed, neighbors, out=out)

    def rows(op, leaves, neighbors, rows_, edge_mask=None):
        members = [cg._members(leaf) for leaf in leaves]
        width = sum(ms[0][0].numel() for ms in members)
        keep("gossip_round_rows", rows_.numel() * width,
             (op, members, neighbors, rows_, edge_mask))
        return inner["gossip_round_rows"](op, leaves, neighbors, rows_, edge_mask)

    def vclock(clock, dots, neighbors, rows_, edge_mask=None):
        width = cg._members(dots)[0][0].numel()
        keep("gossip_round_rows_vclock", rows_.numel() * width,
             (cg._members(clock), cg._members(dots), neighbors, rows_, edge_mask))
        return inner["gossip_round_rows_vclock"](clock, dots, neighbors, rows_, edge_mask)

    cg.gossip_round_dense, cg.gossip_round_rows = dense, rows
    cg.gossip_round_rows_vclock = vclock

    def undo():
        for name, fn in inner.items():
            setattr(cg, name, fn)

    return kept, undo


def _check_widest(torch, cg, kept: dict) -> dict:
    """Each kept widest call through the kernel and its plain version on
    the card: ``{name: {"shape", "max_abs_err"}}``."""
    out = {}
    for name, (_size, args) in kept.items():
        if name == "gossip_round_dense":
            ex, rm, nb = args
            got = cg.gossip_round_dense(ex, rm, nb)
            want = cg.gossip_round_dense_plain(ex, rm, nb)
            shape = {"S": ex.shape[0], "D": ex.shape[1], "R": nb.shape[0], "K": nb.shape[1]}
        elif name == "gossip_round_rows":
            op, members, nb, rows, mask = args
            joined, ch = cg.gossip_round_rows(op, members, nb, rows, mask)
            joined_w, ch_w = cg.gossip_round_rows_plain(op, members, nb, rows, mask)
            got, want = [*joined, ch], [*joined_w, ch_w]
            shape = {"G": rows.shape[0], "F": rows.shape[1], "R": members[0][0].shape[0],
                     "row": list(members[0][0].shape[1:]), "leaves": len(members),
                     "op": op}
        else:
            clock, dots, nb, rows, mask = args
            (jc, jd), ch = cg.gossip_round_rows_vclock(clock, dots, nb, rows, mask)
            (wc, wd), ch_w = cg.gossip_round_rows_vclock_plain(clock, dots, nb, rows, mask)
            got, want = [jc, jd, ch], [wc, wd, ch_w]
            shape = {"G": rows.shape[0], "F": rows.shape[1], "R": dots[0].shape[0],
                     "E": dots[0].shape[1], "A": dots[0].shape[2]}
        torch.cuda.synchronize()
        out[name] = {"shape": shape, "max_abs_err": _max_abs_err(torch, got, want)}
    return out


def distributed_worker(out_dir: str) -> int:
    """One rank of the distributed phase (``python3 chip_smoke.py
    --distributed-worker DIR``, spawned by :func:`phase_distributed` with
    the process group's variables set); writes ``DIR/rank<r>.json``."""
    import torch

    from lasp_tpu_torch.bench_scenarios import _block_hashes, mesh_scale, partitioned_gossip
    from lasp_tpu_torch.device import resolve_device
    from lasp_tpu_torch.mesh import comm, locality_order, scale_free
    from lasp_tpu_torch.mesh import shard_gossip as sg
    from lasp_tpu_torch.ops import cuda_gossip as cg

    if not torch.cuda.is_available():
        raise RuntimeError("distributed worker: no card")
    if not comm.init_distributed():
        raise RuntimeError("distributed worker: no process group in the environment")
    rank, dev = comm.process_index(), resolve_device(None)
    res = {"rank": rank, "world": comm.process_count(), "backend": comm.backend(),
           "device": str(dev), "seconds": {}}
    kept, undo = _widest_calls(torch, cg)
    cg.reset_launches()
    try:
        t0 = time.perf_counter()
        res["partitioned_gossip"] = partitioned_gossip(_DIST["pg_replicas"])
        res["seconds"]["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["mesh_scale"] = mesh_scale(n_replicas=_DIST["ms_replicas"])
        res["seconds"]["b"] = time.perf_counter() - t0
        n, shards = _SHARD["n_replicas"], _SHARD["n_shards"]
        nbrs = locality_order(scale_free(n, 3, seed=1))[1]
        mesh = comm.build_mesh(
            devices=comm.global_slots(shards // comm.process_count(), device=dev),
            slice_of=lambda slot: slot.process_index)
        res["membership"] = {}
        for mode in ("gather", "alltoall"):
            t0 = time.perf_counter()
            rt, _ids, _homes, expected = _membership_runtime(torch, n, converge=False)
            rt.resize(n, nbrs)  # the scale-free topology, same population
            rt.shard(mesh, partition=True, partition_mode=mode)
            sg.reset_exchange()
            got = _shard_drive(torch, rt, n, expected)
            torch.cuda.synchronize()
            d = rt._dist
            rounds = [r for _l, r, _s in got]
            total = sum(rounds)
            res["membership"][mode] = {
                "seconds": time.perf_counter() - t0, "rounds": rounds,
                "residuals": list(rt.round_residuals),
                "hashes": [{v: _block_hashes(st, d["first"], d["count"], n // shards)
                            for v, st in states.items()} for _l, _r, states in got],
                "coverage": {v: sorted(x) if isinstance(x, (set, frozenset)) else x
                             for v, x in ((v, rt.coverage_value(v)) for v in rt.var_ids)},
                "divergence": {v: rt.divergence(v) for v in rt.var_ids},
                "rows_held": [d["lo"], d["hi"]],
                "exchanged_bytes_per_round": {
                    k: e["bytes"] / total for k, e in sg.EXCHANGED.items()},
                "carried_bytes_per_round": {
                    k: e["bytes"] / total for k, e in comm.CARRIED.items()},
                "stage_s_per_round": {k: v / total for k, v in comm.STAGE_S.items()},
                "process_bytes_total": rt.part_process_bytes_total,
            }
            if any(res["membership"][mode]["divergence"].values()):
                raise RuntimeError(f"distributed worker {rank}: {mode} did not converge")
            del rt, got
        res["launches"] = dict(cg.LAUNCHES)  # the main path's, before the checks
    finally:
        undo()
    res["kernel_checks"] = _check_widest(torch, cg, kept)
    def segment(fn):
        """``fn()``'s record with the bytes this rank carried and the
        seconds of each stage of the collectives while it ran."""
        carried0 = {k: dict(e) for k, e in comm.CARRIED.items()}
        stage0 = dict(comm.STAGE_S)
        out = fn()
        out["carried_bytes"] = {k: e["bytes"] - carried0.get(k, {}).get("bytes", 0)
                                for k, e in comm.CARRIED.items()}
        out["stage_s"] = {k: v - stage0.get(k, 0.0) for k, v in comm.STAGE_S.items()}
        return out

    # (d) the serving path, on the gather path of the same mesh
    t0 = time.perf_counter()
    res["serving"] = segment(lambda: _serving_worker(torch, cg, mesh, _SERVING["n_replicas"]))
    res["seconds"]["d"] = time.perf_counter() - t0
    # (e) membership, programs, Session, the map and the actor guard, there too
    t0 = time.perf_counter()
    res["membership_e"] = segment(lambda: _membership_worker(torch, cg, mesh))
    res["seconds"]["e"] = time.perf_counter() - t0
    # (f) the gather path's sparse frontier, there too
    t0 = time.perf_counter()
    res["frontier_f"] = segment(lambda: _frontier_worker(torch, cg, mesh))
    res["seconds"]["f"] = time.perf_counter() - t0
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res, default=str))
    print(json.dumps({"rank": rank, "launches": res["launches"],
                      "serving_launches": res["serving"]["launches"],
                      "membership_e_launches": res["membership_e"]["launches"],
                      "frontier_f_launches": res["frontier_f"]["launches"],
                      "seconds": res["seconds"],
                      "serving_seconds": res["serving"]["seconds"],
                      "membership_e_seconds": res["membership_e"]["seconds"],
                      "frontier_f_seconds": res["frontier_f"]["seconds"]}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


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
_PROGRAMS = {"n_events": 128, "n_keys": 48, "index_names": 2, "index_values": 8,
             "n_shards": 4, "seed": 29}


def phase_programs(torch, cg, captured: dict, peak_gbps: float,
                   n: int = _CHAOS_REPLICAS) -> dict:
    """``bench_scenarios.riak_index_2i`` at ``n`` replicas on
    ``random_regular(n, 3)``: a total ``RiakIndexProgram`` with auto views,
    the 16 views it registers from specs over 2 index names x 8 values and
    an ``ExampleKeylistProgram`` (JAX's defaults: 64 elements, 64 tokens,
    one actor: two ``bool[64, 64]`` planes a row), 128 seeded events over
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


#: the telemetry parity drive's replicas on the card: the CPU twin's cut,
#: the largest power of two at which its drive through the plain versions
#: takes at most 20 s on the card's host (PERF.md section 4)
_PARITY_REPLICAS = 2048


def telemetry_drive(m, n: int, deep: bool, dev: dict,
                    kernel_neutral: bool = False) -> dict:
    """One seeded drive of every telemetry site, through the package whose
    classes ``m`` carries (``Store``, ``Graph``, ``ReplicatedRuntime``,
    ``random_regular``, ``ActorCollisionError``, ``telemetry``), constructed
    with ``dev`` (``{"device": "cpu"}`` off the card). The engine
    population's widths (packed OR-Set 64 x 16 x 4, G-Counter, OR-SWOT with
    64 elements and 64 actors) and a map with an OR-Set field on
    ``random_regular(n, 3)``: grouped ``update_batch`` and the map's per-op
    fallback, ``update_at`` on every kind, an actor-guard refusal, dense
    steps, ``frontier_step``, ``converge_on_device`` with its flight ring,
    ``read_until`` / ``read_any_until`` host-probed and a parked read, a
    ``resize``, a frontier convergence, a ``replica_value`` and a dense
    round under a trigger; then a store-level map -> filter -> union -> product chain
    propagated fused, per edge and fused again from the cache, with a
    parked store read fired by a write. Returns :func:`telemetry_transcript`
    of the run (the registry reset and the event and span rings cleared
    first; ``deep`` sets the deep tier for the run) with the drive's own
    checks under ``"checks"``."""
    tel = m.telemetry
    tel.reset()
    tel.clear_spans()
    tel.events.clear()
    tel.events.set_deep(deep)
    try:
        store = m.Store(n_actors=16, **dev)
        ads = store.declare(id="ads", type="lasp_orset", n_elems=64, n_actors=16,
                            tokens_per_actor=4)
        views = store.declare(id="views", type="riak_dt_gcounter", n_actors=16)
        sw = store.declare(id="sw", type="riak_dt_orswot", n_elems=64, n_actors=64)
        kv = store.declare(id="kv", type="riak_dt_map", n_actors=16,
                           fields=[("o", "lasp_orset", {"n_elems": 4})])
        rt = m.ReplicatedRuntime(store, m.Graph(store), n, m.random_regular(n, 3, seed=0),
                                 packed=True, debug_actors=True, **dev)
        w = [int(r) for r in np.random.RandomState(5).choice(n, 16, replace=False)]
        rt.update_batch(ads, [(r, ("add_all", [f"ad{(a * 4 + j) % 64}" for j in range(4)]),
                               f"w{a}") for a, r in enumerate(w)])
        rt.update_batch(views, [(r, ("increment", a + 1), f"w{a}") for a, r in enumerate(w)])
        rt.update_batch(sw, [(r, ("add", f"e{a}"), f"s{a}") for a, r in enumerate(w)])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the per-op fallback's warning
            rt.update_batch(kv, [(w[a], ("update", "o", ("add", f"k{a}")), f"w{a}")
                                 for a in range(3)])
        rt.update_at(w[1], ads, ("remove", "ad4"), "w1")
        rt.update_at(w[2], views, ("increment", 3), "w2")
        rt.update_at(w[3], sw, ("add", "e40"), "s3")
        rt.update_at(w[4], kv, ("update", "o", ("add", "k9")), "w4")
        refused = 0
        try:
            rt.update_at(w[5], views, ("increment",), "w2")
        except m.ActorCollisionError:
            refused += 1
        # the writes' rows and their neighbours: row-sparse rounds (K2, K3)
        residuals = [rt.frontier_step() for _ in range(3)]
        residuals += [rt.step() for _ in range(2)]  # dense (K1)
        rt.update_at(w[6], ads, ("add", "ad50"), "w6")
        rt.update_at(w[7], sw, ("add", "e50"), "s7")
        residuals.append(rt.frontier_step())
        rounds = rt.converge_on_device(max_rounds=256)
        total = sum(range(1, 17)) + 3
        far = (w[0] + n // 2) % n
        rt.update_at(w[0], views, ("increment", 2), "w0")
        rt.read_until(far, views, total + 1, on_device=False)
        rt.update_at(w[8], views, ("increment", 2), "w8")
        rt.read_any_until(far, [(views, total + 10**6), (views, total + 3)], on_device=False)
        rt.update_at(w[9], views, ("increment", 2), "w9")
        rt.read_until(far, views, total + 5)  # parked on the device
        grown = n + n // 8
        rt.resize(grown, m.random_regular(grown, 3, seed=1))
        residuals.append(rt.step())
        rounds_after = rt.converge_on_device(max_rounds=256)
        # the frontier loop, a read, and a dense round with a trigger
        rounds_after = [rounds_after, rt.run_to_convergence(mode="auto")]
        read = rt.replica_value(views, far)
        rt.register_trigger(lambda dense: {}, touches=[views])
        residuals.append(rt.step())

        ds = m.Store(n_actors=2, **dev)
        g = m.Graph(ds)
        a = ds.declare(id="a", type="lasp_orset", n_elems=8, n_actors=2, tokens_per_actor=4)
        b = ds.declare(id="b", type="lasp_orset", n_elems=16, n_actors=2, tokens_per_actor=4)
        c = ds.declare(id="c", type="lasp_orset", n_elems=4, n_actors=2, tokens_per_actor=4)
        cnt = ds.declare(id="cnt", type="riak_dt_gcounter", n_actors=2)
        mapped = g.map(a, lambda x: x * 10, dst="m", dst_elems=16)
        kept = g.filter(mapped, lambda x: x % 20 == 0, dst="f")
        joined = g.union(kept, b, dst="u")
        g.product(joined, c, dst="p")
        watch = ds.read(cnt, 4)  # parked until the counter reaches 4
        prop = []
        for step, mode in enumerate(("fused", "per_edge", "auto")):
            ds.update(a, ("add", step + 1), "x")
            ds.update(b, ("add", 100 + step), "x")
            ds.update(c, ("add", f"c{step}"), "y")
            ds.update(cnt, ("increment", 2), "x")
            prop.append(g.propagate(mode=mode))
        ds.update(a, ("remove", 1), "x")
        prop.append(g.propagate())
    finally:
        tel.events.set_deep(False)
    out = telemetry_transcript(tel, kernel_neutral)
    out["checks"] = {"refused": refused, "residuals": residuals, "rounds": rounds,
                     "rounds_after": rounds_after, "propagate_rounds": prop,
                     "watch_fired": bool(watch.done), "p": sorted(ds.value("p")),
                     "views": rt.coverage_value(views), "read": read,
                     "n": rt.n_replicas}
    return out


def _plain(x):
    """A transcript value as plain, comparable data: tuples for lists,
    sorted item tuples for dicts."""
    if isinstance(x, dict):
        return tuple(sorted((k, _plain(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return x


#: a gauge set from measured seconds (achieved bandwidth): its series
#: count, its values do not
_RATE_GAUGES = ("roofline_achieved_GBps",)
#: achieved bandwidth over the capability row's peak, which JAX measures
#: on a CPU host once asked and the port has for a card only: left out
_PEAK_GAUGES = ("roofline_frac",)


def telemetry_transcript(tel, kernel_neutral: bool = False) -> dict:
    """What a drive emitted, without its seconds: every metric family with
    its type and each series' labels with its value (a counter or gauge)
    or its observation count (a histogram; a gauge of measured rates keeps
    only its labels, a share of a peak is left out); every causal event as
    ``(etype, var, replica, round, attrs)`` with ``seconds`` dropped from
    the attributes; every span name in order of completion; the events the
    ring dropped. ``kernel_neutral`` leaves out what names the kernel that
    ran (the ledger's signatures are ``cuda_*`` on the card and the plain
    arms' off it): the rate gauge and the ledger's sample spans."""
    metrics = []
    for name, fam in sorted(tel.get_registry().snapshot().items()):
        if name in _PEAK_GAUGES or (kernel_neutral and name in _RATE_GAUGES):
            continue
        series = sorted(
            (_plain(s["labels"]),
             s["count"] if fam["type"] == "histogram"
             else None if name in _RATE_GAUGES else s["value"])
            for s in fam["series"])
        metrics.append((name, fam["type"], tuple(series)))
    events = [
        (r["etype"], r.get("var"), r.get("replica"), r["round"],
         _plain({k: v for k, v in r.get("attrs", {}).items() if k != "seconds"}))
        for r in tel.events.events()]
    return {"metrics": metrics, "events": events,
            "spans": [r["name"] for r in tel.span_events()
                      if not (kernel_neutral and r["name"] == "gossip.ledger_sample")],
            "dropped": tel.events.stats()["dropped"]}


def _port_modules():
    """The port's classes for :func:`telemetry_drive`."""
    import types

    from lasp_tpu_torch import telemetry
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, random_regular
    from lasp_tpu_torch.mesh.runtime import ActorCollisionError
    from lasp_tpu_torch.store import Store

    return types.SimpleNamespace(
        Store=Store, Graph=Graph, ReplicatedRuntime=ReplicatedRuntime,
        random_regular=random_regular, ActorCollisionError=ActorCollisionError,
        telemetry=telemetry)


def _telemetry_parity(torch, cg) -> dict:
    """The telemetry parity drive (:func:`telemetry_drive`) at
    ``_PARITY_REPLICAS`` on the card, then its twin with ``device="cpu"``
    through the plain versions: their transcripts (the kernel-naming ledger
    gauges and sample spans left out) must be equal. K1, K2 and K3 must each
    launch in the card's drive, and each one's widest call is held against
    its plain version at max_abs_err 0. Returns the part's line, with the
    card drive's launches under ``"launches"``."""
    from lasp_tpu_torch.mesh import gossip as gmod

    m = _port_modules()
    cg.reset_launches()
    widest, undo = _widest_calls(torch, cg)
    # the dense round calls K1 by the name it imported: through the wrapper
    k1 = gmod.gossip_round_dense
    gmod.gossip_round_dense = lambda *a, **kw: cg.gossip_round_dense(*a, **kw)
    t0 = time.perf_counter()
    try:
        card = telemetry_drive(m, _PARITY_REPLICAS, False, {}, kernel_neutral=True)
        torch.cuda.synchronize()
    finally:
        undo()
        gmod.gossip_round_dense = k1
    t_card = time.perf_counter() - t0
    launches = dict(cg.LAUNCHES)
    t0 = time.perf_counter()
    twin = telemetry_drive(m, _PARITY_REPLICAS, False, {"device": "cpu"},
                           kernel_neutral=True)
    t_cpu = time.perf_counter() - t0
    m.telemetry.reset()
    held = _check_widest(torch, cg, widest)
    diffs = [k for k in ("checks", "metrics", "events", "spans", "dropped")
             if card[k] != twin[k]]
    line = {
        "part": "parity", "replicas": _PARITY_REPLICAS,
        "card_seconds": t_card, "cpu_twin_seconds": t_cpu,
        "launches": launches, "widest": held,
        "families": len(card["metrics"]), "events": len(card["events"]),
        "spans": len(card["spans"]), "dropped": card["dropped"],
        "checks": card["checks"], "differs": diffs,
    }
    if diffs:
        for k in diffs:
            if isinstance(card[k], list):
                first = next((i for i, (a, b) in enumerate(zip(card[k], twin[k])) if a != b),
                             min(len(card[k]), len(twin[k])))
                line[f"first_{k}_diff"] = [card[k][first:first + 3], twin[k][first:first + 3]]
        _log_line("telemetry", line)
        raise RuntimeError(f"telemetry: the card's transcript differs from the CPU twin's "
                           f"in {diffs}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        _log_line("telemetry", line)
        raise RuntimeError(f"telemetry: the parity drive never launched {missing}")
    if set(held) != set(launches) or any(h["max_abs_err"] for h in held.values()):
        _log_line("telemetry", line)
        raise RuntimeError(f"telemetry: a widest launch disagrees with plain: {held}")
    return line


#: ``measure_overhead``'s arms in this script's run before the port's
#: propagate emission became JAX's (NVIDIA H100 80GB HBM3, 700.00 W),
#: printed beside this run's
_OVERHEAD_BEFORE = {"emission": 0.0959, "frontier": 0.0174, "ledger_dense": 0.0262,
                  "ledger_frontier": 0.0034, "dataflow": 0.0049, "aae": 0.0545,
                  "flight": 0.0731}


def phase_telemetry(torch, cg, kind: str, peak_gbps: float, widest: dict,
                    flight: dict) -> dict:
    """The ledger, the capability row and the flight ring on the card: the
    capability record names the card; the kernel cost ledger's families and
    records after every earlier phase; its bytes for K1, K2 and K3 at their
    widest shapes beside the kernels phase's gather model; its achieved
    share of peak beside the kernels phase's; the north star's flight line;
    ``measure_overhead``'s arms against JAX's 5% budget (an arm over it is a
    finding, not a failure), the earlier run's figure beside each; last, the parity
    drive (:func:`_telemetry_parity`), which resets the registry and the
    ledger. Returns the parity drive's launches."""
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
    _log_line("telemetry", {"part": "overhead", "arms": arms, "arms_before": _OVERHEAD_BEFORE,
                            "over_budget": sorted(a for a, x in arms.items() if x >= 0.05),
                            "report": over})
    parity = _telemetry_parity(torch, cg)
    _log_line("telemetry", parity)
    return parity["launches"]


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


def _k1_shard_inputs(torch, r, src, d, k, seed=7):
    """A shard's K1 launch made from a seed: ``[src, d]`` source planes and
    an ``int32[r, k]`` table into ``[0, src)``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ex = torch.randint(-2**31, 2**31 - 1, (src, d), dtype=torch.int32,
                       device="cuda", generator=gen)
    rm = ex & torch.randint(-2**31, 2**31 - 1, (src, d), dtype=torch.int32,
                            device="cuda", generator=gen)
    nb = torch.randint(0, src, (r, k), dtype=torch.int32, device="cuda",
                       generator=gen)
    return ex, rm, nb


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
    widest, sweeps, k1_adcounter, k1_shard = {}, {}, [], []
    # K1: planes made from a seed at each logged shape, in its slabs, and
    # the slab sweep at each of them
    for key, count in shapes["gossip_round_dense"].items():
        r, d, k, slab, src = key
        if src != r:  # a shard's [block | received] source of src rows
            ex, rm, nb = _k1_shard_inputs(torch, r, src, d, k)
        else:
            ex, rm, nb = _k1_inputs(torch, r, d, k, nbrs=k1_nbrs.get(r))
        out = (ex.new_empty((r, d)), rm.new_empty((r, d)))
        ms = _time_ms(torch, lambda: cg._dense_launch(ex, rm, nb, *out, slab), 10)
        row_bytes = 2 * d * 4
        # the source rows the round reads (its own rows and the rows its
        # table names) once, the output planes written once, the indices
        read = (np.unique(np.concatenate([np.arange(r), nb.cpu().numpy().ravel()])).size
                if src != r else r)
        bound = ((read + r) * row_bytes + r * k * 4) / bw * 1e3
        want = cg.gossip_round_dense_plain(ex, rm, nb)
        if src != r:
            got = cg.gossip_round_dense(ex, rm, nb)
            err = _max_abs_err(torch, got, want)
            del got
            per_shape["gossip_round_dense"].append((key, count, ms, bound, err))
            k1_shard.append({
                "shape": dict(zip(fields["gossip_round_dense"], key)),
                "launches": count, "ms": ms, "bound_ms": bound, "bound_by": "bytes",
                "loss_ms": count * (ms - bound), "max_abs_err": err,
                "plain_ms": _time_ms(
                    torch, lambda: cg.gossip_round_dense_plain(ex, rm, nb), 3),
            })
            del ex, rm, nb, out, want
            continue
        per_shape["gossip_round_dense"].append((key, count, ms, bound, None))
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
    return per_shape, widest, sweeps, k1_adcounter, k1_shard


def _layout_order(cap) -> str:
    """Sort key keeping the shapes of one seeded layout together (the
    replays of captured members first)."""
    syn = cap.get("synthetic")
    return "" if syn is None else repr(syn["key"])


#: warming calls that open each profiled window of the one-kernel check
_WARM_CALLS = 4


#: one-element fills that mark where a profiled window's count starts
_MARKERS = 3


#: host seconds that open and close each window of ``_device_kernels``: the
#: profiler keeps no device record that falls outside its capture window,
#: and the card's records were stamped up to 20.6 ms before the host range
#: that enqueued them (PERF.md §6); the warm calls stand between the opening
#: pad and the markers
_PAD_S = 0.02


def _device_kernels(torch, warm, calls, diag=None) -> "dict | None":
    """Run each of ``warm`` and then each of ``calls`` once under
    ``torch.profiler``: the device activities (kernels, copies, fills) that
    ``calls`` put on the card, by name and count — those that start after
    the last of ``_MARKERS`` one-element float64 fills enqueued between the
    two (the markers, left out with the sleep kernels that open and close
    the window; no wrapper of the count fills a float64 tensor). In full
    runs the profiler drops the records of a few device activities of a
    window (PERF.md), so ``warm`` launches each kernel of the count first,
    outside it, and a lost marker record leaves the others to mark the
    start; the window opens and closes with ``_PAD_S`` of host sleep. None
    when every marker's record is missing (the window cannot be read).
    ``diag``, a dict, receives what the window recorded: its device
    records and their commonest names, its markers, its host records and
    the CUDA runtime calls among them, the first marker's start less the
    start of the host range that enqueued the markers (``marker_lag_us``),
    and the first and last device record against the host's span (µs)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    marker = torch.zeros((1,), dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(_PAD_S)
        torch.cuda._sleep(1000)
        for call in warm:
            call()
        torch.cuda.synchronize()
        with record_function("lasp_markers"):
            for _ in range(_MARKERS):  # the count starts after these kernels
                marker.fill_(7.0)
        for call in calls:
            call()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(_PAD_S)
    events = prof.events()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    is_marker = [("FillFunctor<double>" in e.key) for e in device]
    marks = [e.time_range.start for e, m in zip(device, is_marker) if m]
    if diag is not None:
        host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        enq = [e.time_range.start for e in host if e.key == "lasp_markers"]
        diag.update(
            device_records=len(device), markers=len(marks), host_records=len(host),
            runtime_records=sum(e.key.startswith("cuda") for e in host),
            device_names=Counter(e.key[:40] for e in device).most_common(4),
            marker_lag_us=(min(marks) - enq[0]) if marks and enq else None,
            device_us=([min(e.time_range.start for e in device),
                        max(e.time_range.end for e in device)] if device else None),
            host_us=([min(e.time_range.start for e in host),
                      max(e.time_range.end for e in host)] if host else None))
    if not marks:
        return None
    start = max(marks)
    return dict(Counter(e.key for e, m in zip(device, is_marker)
                        if not m and "spin_kernel" not in e.key
                        and e.time_range.start > start))


#: profiled replays of the K2 / K3 shapes before the one-kernel check gives up
_PROFILE_WINDOWS = 12


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
    lags, unread = [], []
    for name, other in zip(names, reversed(names)):
        seen, counts = [], []
        for _layout, keys in chunks[name]:
            chunk = [call_of(name, key) for key in keys]
            diags = []
            for attempt in range(_PROFILE_WINDOWS):
                diags.append({})
                kernels = _device_kernels(
                    torch, [warm[other]] * _WARM_CALLS + chunk, chunk, diags[-1])
                if diags[-1]["marker_lag_us"] is not None:
                    lags.append(diags[-1]["marker_lag_us"])
                if kernels is None:
                    got = -1
                    diags[-1]["got"] = got
                    unread.append(diags[-1])
                    continue
                got = sum(kernels.values())
                diags[-1]["got"] = got
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
                    f"in each of {_PROFILE_WINDOWS} profiled windows: {kernels}; "
                    f"what each window recorded: {diags}")
            counts.append([d["got"] for d in diags])
            del chunk
        widest[name]["device_kernels_per_call"] = 1.0
        # [kernels seen, windows opened] a chunk
        widest[name]["profiled_windows_kernels"] = seen
        # the kernels each window of a chunk showed (-1: no marker record)
        widest[name]["profiled_windows_counts"] = counts
    # the windows without a marker record (what each recorded, the first
    # 8), and the span of the markers' lag behind the host range that
    # enqueued them (µs), over both kernels
    for name in names:
        widest[name]["profiled_windows_unread"] = len(unread)
        widest[name]["profiled_unread_records"] = unread[:8]
        widest[name]["profiled_marker_lag_us"] = [min(lags), max(lags)] if lags else None
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
    _log_launches("scenarios", launches["scenarios"])

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
        _log_launches(phase, counts)
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
    _log_launches("plan", launches["plan"])
    # 6. baseline -----------------------------------------------------------------
    base = phase_baseline(torch, cg)
    launches["baseline"], shapes["baseline"] = base["launches"], base["shapes"]
    _log_launches("baseline", launches["baseline"])
    # 7. ingest -------------------------------------------------------------------
    ing = phase_ingest(torch, cg, captured)
    launches["ingest"], shapes["ingest"] = ing["launches"], ing["shapes"]
    _log_launches("ingest", launches["ingest"])
    # 8. reads --------------------------------------------------------------------
    rd = phase_reads(torch, cg, n, nbrs)
    launches["reads"], shapes["reads"] = rd["launches"], rd["shapes"]
    _log_launches("reads", launches["reads"])
    # 9. map ----------------------------------------------------------------------
    mp = phase_map(torch, cg)
    launches["map"], shapes["map"] = mp["launches"], mp["shapes"]
    _log_launches("map", launches["map"])
    # 10. compaction --------------------------------------------------------------
    cp = phase_compaction(torch, cg)
    launches["compaction"], shapes["compaction"] = cp["launches"], cp["shapes"]
    _log_launches("compaction", launches["compaction"])
    # 11. dataflow ----------------------------------------------------------------
    df = phase_dataflow(torch, cg)
    launches["dataflow"], shapes["dataflow"] = df["launches"], df["shapes"]
    _log_launches("dataflow", launches["dataflow"])
    # 12. membership --------------------------------------------------------------
    mb = phase_membership(torch, cg, captured)
    launches["membership"], shapes["membership"] = mb["launches"], mb["shapes"]
    _log_launches("membership", launches["membership"])
    # 13. checkpoint --------------------------------------------------------------
    run_dir = tempfile.TemporaryDirectory()
    kept_store = str(Path(run_dir.name) / "store.lasp")
    ck = phase_checkpoint(torch, cg, mb["rt"], mb["ids"], captured, kept_store)
    launches["checkpoint"], shapes["checkpoint"] = ck["launches"], ck["shapes"]
    _log_launches("checkpoint", launches["checkpoint"])
    sources = {"engine": rt_f, "plan": plan["rt"], "ingest": ing["rt"],
               "membership": mb["rt"]}
    # 14. chaos -------------------------------------------------------------------
    ch = phase_chaos(torch, cg, captured, sources)
    launches["chaos"], shapes["chaos"] = ch["launches"], ch["shapes"]
    _log_launches("chaos", launches["chaos"])
    # 15. quorum ------------------------------------------------------------------
    qm = phase_quorum(torch, cg)
    launches["quorum"], shapes["quorum"] = qm["launches"], qm["shapes"]
    _log_launches("quorum", launches["quorum"])
    # 16. aae ---------------------------------------------------------------------
    aa = phase_aae(torch, cg, captured)
    launches["aae"], shapes["aae"] = aa["launches"], aa["shapes"]
    _log_launches("aae", launches["aae"])
    # 17. rebalance ---------------------------------------------------------------
    rb = phase_rebalance(torch, cg, captured)
    launches["rebalance"], shapes["rebalance"] = rb["launches"], rb["shapes"]
    _log_launches("rebalance", launches["rebalance"])
    del rb
    # 18. serve -------------------------------------------------------------------
    sv = phase_serve(torch, cg, captured)
    launches["serve"], shapes["serve"] = sv["launches"], sv["shapes"]
    _log_launches("serve", launches["serve"])
    del sv
    # 19. programs ----------------------------------------------------------------
    pg = phase_programs(torch, cg, captured, peak_gbps)
    launches["programs"], shapes["programs"] = pg["launches"], pg["shapes"]
    _log_launches("programs", launches["programs"])
    del pg
    # 20. session -----------------------------------------------------------------
    se = phase_session(torch, cg, captured)
    launches["session"], shapes["session"] = se["launches"], se["shapes"]
    _log_launches("session", launches["session"])
    # 21. bridge ------------------------------------------------------------------
    br = phase_bridge(torch, cg)
    launches["bridge"], shapes["bridge"] = br["launches"], br["shapes"]
    _log_launches("bridge", launches["bridge"])
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

    # 27. shard -------------------------------------------------------------------
    sh = phase_shard(torch, cg, captured)
    launches["shard"], shapes["shard"] = sh["launches"], sh["shapes"]
    _log_launches("shard", launches["shard"])
    # 28. distributed: the shard phase's work on two processes ------------------
    dist_line = phase_distributed(torch, sh["reference"], qm["presets"])
    del sh

    # 24. adcounter ---------------------------------------------------------------
    ad = phase_adcounter(torch, cg)
    launches["adcounter"], shapes["adcounter"] = ad["launches"], ad["shapes"]
    _log_launches("adcounter", launches["adcounter"])

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
    per_shape, widest, sweeps, k1_adcounter, k1_shard = phase_kernels(
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
    launches["telemetry"] = phase_telemetry(torch, cg, kind, peak_gbps, widest, flight)
    _log_launches("telemetry", launches["telemetry"])

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
    for k in kernels:
        # each rank's launches in the distributed phase (its own processes)
        k["launches_distributed_by_rank"] = [
            r["launches"][k["name"]] for r in dist_line["ranks"]]
        # and in its segment (d), the serving path
        k["launches_distributed_serving_by_rank"] = [
            r["serving"]["launches"][k["name"]] for r in dist_line["ranks"]]
        k["distributed_max_abs_err"] = max(
            r["kernel_checks"][k["name"]]["max_abs_err"] for r in dist_line["ranks"])
        # and in its segment (e), membership, programs and Session
        k["launches_distributed_membership_by_rank"] = [
            r["membership_e"]["launches"][k["name"]] for r in dist_line["ranks"]]
        # and in its segment (f), the gather path's sparse frontier
        k["launches_distributed_frontier_by_rank"] = [
            r["frontier_f"]["launches"][k["name"]] for r in dist_line["ranks"]]
        # each rank's widest launch of (d)-(f) against the plain version
        # (None: the kernel did not launch in that segment)
        k["distributed_segment_max_abs_err"] = {
            seg: max((r[key]["kernel_checks"][k["name"]]["max_abs_err"]
                      for r in dist_line["ranks"]
                      if k["name"] in r[key]["kernel_checks"]), default=None)
            for seg, key in (("d", "serving"), ("e", "membership_e"), ("f", "frontier_f"))}
    kernels[0]["adcounter_shapes"] = k1_adcounter
    # the partitioned path's K1 shapes: a shard's [block | received] source
    kernels[0]["shard_shapes"] = k1_shard
    if not k1_shard:
        raise RuntimeError("K1 was not held at a shard shape")
    for k in kernels[1:]:
        # the masked launches (the chaos soaks'), one mask byte an edge read
        f = cg.SHAPE_FIELDS[k["name"]]
        rows = [row for row in per_shape[k["name"]] if row[0][f.index("masked")]]
        k["masked_shapes"] = [{"shape": dict(zip(f, key)), "launches": c, "ms": ms,
                               "bound_ms": b, "max_abs_err": err}
                              for key, c, ms, b, err in rows]
        k["masked_loss_ms"] = sum(c * (ms - b) for _key, c, ms, b, _e in rows)
        # the partitioned path's shapes: a shard's block or [block | halo]
        shard_keys = shapes["shard"][k["name"]]
        k["shard_shapes"] = [{"shape": dict(zip(f, key)), "launches": shard_keys[key],
                              "ms": ms, "bound_ms": b, "max_abs_err": err}
                             for key, _c, ms, b, err in per_shape[k["name"]]
                             if key in shard_keys]
        if not k["shard_shapes"]:
            raise RuntimeError(f"{k['name']} was not held at a shard shape")
        # every shape of the main path, each held against its plain version
        errs = [err for _key, _c, _ms, _b, err in per_shape[k["name"]]]
        k["held_shapes"] = len(errs)
        k["max_abs_err_all_shapes"] = max(errs)
        _log("kernels", f"{k['name']}: {len(errs)} main-path shapes held against "
                        f"the plain version, max_abs_err {max(errs)}")
    kernels[1]["loss_split_ms"] = _k2_loss_split(cg, per_shape["gossip_round_rows"])
    if any(k["max_abs_err"] for k in kernels) or any(
            s["max_abs_err"] for s in k1_adcounter + k1_shard) or any(
            k["max_abs_err_all_shapes"] for k in kernels[1:]):
        raise RuntimeError(f"kernel disagrees with plain at the main-path shape: {kernels}")
    run_dir.cleanup()
    _log("timing", f"whole script {time.perf_counter() - _T0:.1f} s "
                   "(963.4 s of command before the parity part); each phase's seconds: the "
                   "[launches] lines")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1,  # the cards this run used
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-worker"]:
        sys.exit(distributed_worker(sys.argv[2]))
    sys.exit(main())
