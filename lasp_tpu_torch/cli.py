"""Command-line console (port of ``lasp_tpu.cli``; reference L6:
``bin/lasp``/``lasp-admin`` + ``lasp_console``). Cluster-admin verbs map to
their simulation equivalents: ``status`` (ringready/member-status) reports
torch and its devices; ``simulate`` runs a gossip population to its fixed
point; ``bench`` runs the OR-Set anti-entropy headline; ``metrics`` prints
a telemetry snapshot (Prometheus text + optional JSONL; the riak-admin
``status``/``stat`` role); ``top`` is the live cluster-health view (per-var
residual/staleness/lag, shard lag, alerts); ``trace`` exports a variable's
causal event history as Perfetto/Chrome-trace JSON; ``inspect`` lists a
checkpoint's contents.

Every verb takes ``--device`` (default: CUDA, the card; ``--device cpu``
runs off it). Parsing the arguments, ``--help`` included, imports no torch
and touches no device.

Usage: ``python -m lasp_tpu_torch.cli <verb> [options] [--device DEV]``
"""

from __future__ import annotations

import argparse
import json
import sys


def _device(args):
    from lasp_tpu_torch.device import resolve_device

    return resolve_device(args.device)


def cmd_status(args) -> int:
    import torch

    import lasp_tpu_torch

    dev = _device(args)
    if dev.type == "cuda":
        devices = [torch.cuda.get_device_name(i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [str(dev)]
    info = {
        "version": lasp_tpu_torch.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": dev.type,
        "devices": devices,
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_simulate(args) -> int:
    from lasp_tpu_torch.bench_scenarios import _timed
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import (
        ReplicatedRuntime,
        random_regular,
        ring,
        scale_free,
    )
    from lasp_tpu_torch.store import Store

    dev = _device(args)
    topo = {"ring": ring, "random": random_regular, "scale_free": scale_free}[
        args.topology
    ]
    store = Store(n_actors=max(16, args.writers), device=dev)
    if args.type == "riak_dt_gcounter":
        var = store.declare(type=args.type)
        op = ("increment",)
    else:
        var = store.declare(type=args.type, n_elems=args.elems)
        op = None
    rt = ReplicatedRuntime(
        store, Graph(store), args.replicas, topo(args.replicas, args.fanout),
        device=dev,
    )
    # one batched dispatch for all client writes, not a per-op host loop
    rt.update_batch(
        var,
        [
            ((w * args.replicas) // args.writers,
             op or ("add", f"item{w}"), f"writer{w}")
            for w in range(args.writers)
        ],
    )
    from lasp_tpu_torch.config import get_config

    rounds, secs = _timed(dev, lambda: rt.run_to_convergence(
        max_rounds=args.max_rounds, block=get_config().fused_block
    ))
    out = {
        "replicas": args.replicas,
        "topology": args.topology,
        "rounds_to_convergence": rounds,
        "seconds": round(secs, 4),
        "residual_path": list(rt.round_residuals),
        "device": str(dev),
    }
    # set-like types report a cardinality; the G-Counter reports its
    # numeric value under its own key (consumers parsing value_size as a
    # cardinality must never misread a counter total)
    if args.type == "riak_dt_gcounter":
        out["value"] = rt.coverage_value(var)
    else:
        out["value_size"] = len(rt.coverage_value(var))
    print(json.dumps(out))
    return 0


def cmd_chaos(args) -> int:
    """Chaos soak (the nemesis verb): run a seeded gossip population
    through a preset fault timeline, measure recovery, and verify the
    convergence-under-failure invariants — healed fixed point
    bit-identical to a fault-free twin's, monotone inflation, replay
    determinism (docs/RESILIENCE.md)."""
    from lasp_tpu_torch.chaos import nemesis, run_harness
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import random_regular, ring, scale_free
    from lasp_tpu_torch.mesh.runtime import ReplicatedRuntime
    from lasp_tpu_torch.store import Store
    from lasp_tpu_torch.telemetry import get_monitor

    dev = _device(args)
    topo = {"ring": ring, "random": random_regular,
            "scale_free": scale_free}[args.topology]
    nbrs = topo(args.replicas, args.fanout)

    def build():
        store = Store(n_actors=max(16, args.writers), device=dev)
        var = store.declare(type=args.type, n_elems=args.elems, id="soak")
        rt = ReplicatedRuntime(store, Graph(store), args.replicas, nbrs,
                               device=dev)
        rt.update_batch(
            var,
            [
                ((w * args.replicas) // args.writers,
                 ("add", f"item{w}"), f"writer{w}")
                for w in range(args.writers)
            ],
        )
        return rt

    schedule = nemesis(
        args.preset, args.replicas, nbrs, seed=args.seed,
        rounds=args.rounds,
    )
    report = run_harness(
        build, schedule, mode=args.mode, max_rounds=args.max_rounds,
        replay=not args.no_replay,
    )
    report["preset"] = args.preset
    report["topology"] = args.topology
    report["replicas"] = args.replicas
    report["schedule"] = schedule.describe()
    report["chaos_health"] = get_monitor().health().get("chaos")
    print(json.dumps(report))
    return 0


def cmd_quorum(args) -> int:
    """Quorum coordination soak: drive a batched put/get quorum
    workload (N=3, R=W=2 by default) through a nemesis preset and
    verify the no-acknowledged-write-lost invariant (hinted handoff)
    plus replay determinism — the coordination-layer twin of the
    ``chaos`` verb (docs/RESILIENCE.md "Quorum coordination")."""
    from lasp_tpu_torch.chaos import nemesis
    from lasp_tpu_torch.chaos.invariants import run_quorum_harness
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import random_regular, ring, scale_free
    from lasp_tpu_torch.mesh.runtime import ReplicatedRuntime
    from lasp_tpu_torch.store import Store
    from lasp_tpu_torch.telemetry import get_monitor

    dev = _device(args)
    topo = {"ring": ring, "random": random_regular,
            "scale_free": scale_free}[args.topology]
    nbrs = topo(args.replicas, args.fanout)

    def build():
        store = Store(n_actors=max(64, args.writes), device=dev)
        store.declare(id="kv", type="lasp_gset",
                      n_elems=max(64, 2 * args.writes))
        return ReplicatedRuntime(store, Graph(store), args.replicas, nbrs,
                                 device=dev)

    schedule = nemesis(
        args.preset, args.replicas, nbrs, seed=args.seed,
        rounds=args.rounds,
    )
    writes = [
        (i % max(1, args.rounds), "kv", ("add", f"k{i}"), f"c{i}",
         (i * 7) % args.replicas)
        for i in range(args.writes)
    ]
    reads = [
        (1 + i % max(1, args.rounds), "kv", (i * 11) % args.replicas)
        for i in range(args.reads)
    ]
    if args.prune_hints and not args.hints:
        # the harness's in-memory log dies with this process: pruning
        # it would report 0 while inspecting nothing
        print("error: --prune-hints needs --hints PATH (only a "
              "durable hint log outlives the harness to be reclaimed)",
              file=sys.stderr)
        return 2
    report = run_quorum_harness(
        build, schedule, writes=writes, reads=reads,
        n=args.n, r=args.r, w=args.w, timeout=args.timeout,
        retries=args.retries, engine=args.engine,
        hints_path=args.hints,
        replay=not args.no_replay,
    )
    if args.prune_hints:
        # the harness's own convergence check just proved the
        # population absorbed every hinted write — the documented safe
        # point for a FULL reclaim (per-record reclaim already runs on
        # every restore via QuorumRuntime's prune_replayed wiring)
        from lasp_tpu_torch.quorum import HintLog

        report["hints_pruned"] = HintLog(args.hints).prune()
    report["preset"] = args.preset
    report["topology"] = args.topology
    report["replicas"] = args.replicas
    report["quorum_health"] = get_monitor().health().get("quorum")
    print(json.dumps(report))
    return 0


def cmd_aae(args) -> int:
    """Active anti-entropy drill (the scrub verb): inject silent
    corruption via a corruption-class nemesis preset, run the Merkle
    hash forest + exchange + quorum repair per round, and verify
    detection/localization/repair plus bit-equality with a fault-free
    twin (docs/RESILIENCE.md "Active anti-entropy")."""
    from lasp_tpu_torch.chaos import nemesis
    from lasp_tpu_torch.chaos.invariants import run_aae_harness
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import random_regular, ring, scale_free
    from lasp_tpu_torch.mesh.runtime import ReplicatedRuntime
    from lasp_tpu_torch.store import Store
    from lasp_tpu_torch.telemetry import get_monitor

    dev = _device(args)
    topo = {"ring": ring, "random": random_regular,
            "scale_free": scale_free}[args.topology]
    nbrs = topo(args.replicas, args.fanout)

    def build():
        store = Store(n_actors=max(16, args.writers), device=dev)
        var = store.declare(type=args.type, n_elems=args.elems,
                            id="scrub")
        rt = ReplicatedRuntime(store, Graph(store), args.replicas, nbrs,
                               device=dev)
        rt.update_batch(
            var,
            [
                ((w * args.replicas) // args.writers,
                 ("add", f"item{w}"), f"writer{w}")
                for w in range(args.writers)
            ],
        )
        return rt

    schedule = nemesis(
        args.preset, args.replicas, nbrs, seed=args.seed,
        rounds=args.rounds,
    )
    try:
        report = run_aae_harness(
            build, schedule, scrub_every=args.scrub_every,
            seg_size=args.seg_size, max_rounds=args.max_rounds,
            mode=args.mode, replay=not args.no_replay,
        )
    except ValueError as exc:  # e.g. dense + scrub_every > 1
        print(f"error: {exc}", file=sys.stderr)
        return 2
    report["preset"] = args.preset
    report["topology"] = args.topology
    report["replicas"] = args.replicas
    report["schedule"] = schedule.describe()
    report["aae_health"] = get_monitor().health().get("aae")
    print(json.dumps(report))
    return 0


def cmd_serve(args) -> int:
    """Serving-front-end soak: an open-loop simulated client fleet
    (write+read+watch mix, Zipf-hot keys, optional composite nemesis +
    overload burst) against the coalescing/vectorized front-end, with
    the no-acked-write-lost invariant and threshold fan-out parity
    asserted in-run (docs/SERVING.md)."""
    from lasp_tpu_torch.serve.harness import run_load
    from lasp_tpu_torch.telemetry import get_monitor

    report = run_load(
        device=_device(args),
        n_replicas=args.replicas,
        n_clients=args.clients,
        ticks=args.ticks,
        arrivals_per_tick=args.arrivals,
        chaos=not args.no_chaos,
        burst_at=args.ticks // 2 if args.burst > 1 else None,
        burst_factor=args.burst,
        seed=args.seed,
        seed_watches=args.watches,
        parity_thresholds=args.parity,
    )
    report["serve_health"] = get_monitor().health().get("serve")
    print(json.dumps(report))
    return 0


#: ``bench.py``'s headline parameters (``bench.py:379``): the packed
#: OR-Set of 128 elements x 64 actors x 4 tokens over random 3-regular
#: gossip in fused blocks of 4, at 2**18 replicas unless ``--replicas``
_BENCH = {"n_replicas": 1 << 18, "fanout": 3, "block": 4, "n_elems": 128,
          "n_actors": 64, "tokens_per_actor": 4}


def cmd_bench(args) -> int:
    """The headline, ``bench_scenarios.orset_anti_entropy`` at
    ``bench.py``'s parameters (that script drives the JAX package, so it is
    not run here); prints one JSON line."""
    from lasp_tpu_torch.bench_scenarios import orset_anti_entropy

    dev = _device(args)
    params = dict(_BENCH)
    if args.replicas:
        params["n_replicas"] = args.replicas
    out = orset_anti_entropy(params.pop("n_replicas"), device=dev, **params)
    out["device"] = str(dev)
    print(json.dumps(out))
    return 0


def cmd_scenario(args) -> int:
    import inspect

    from lasp_tpu_torch.bench_scenarios import SCENARIOS

    fn = SCENARIOS[args.name]
    kwargs = {}
    if "device" in inspect.signature(fn).parameters:
        kwargs["device"] = _device(args)
    if args.replicas:
        if "n_replicas" not in inspect.signature(fn).parameters:
            print(
                f"error: scenario {args.name!r} has a fixed population; "
                "--replicas is not applicable",
                file=sys.stderr,
            )
            return 2
        kwargs["n_replicas"] = args.replicas
    print(json.dumps(fn(**kwargs)))
    return 0


def cmd_bridge(args) -> int:
    """Serve the Erlang backend bridge until interrupted (the release's
    long-running node role; BEAM side: bridge/erlang/lasp_tpu_backend.erl
    with LASP_TPU_BRIDGE_HOST/PORT pointing here)."""
    import time

    from lasp_tpu_torch.bridge import BridgeServer

    server = BridgeServer(host=args.host, port=args.port,
                          n_actors=args.actors, data_dir=args.data_dir,
                          device=_device(args))
    port = server.start()
    print(json.dumps({"listening": f"{args.host}:{port}"}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def _metrics_workload(n_replicas: int, dev) -> None:
    """The built-in observability smoke workload: a small replicated
    gossip run that exercises every instrumented layer — per-type merges
    (orset / orswot / gcounter client writes), a dataflow edge (map), a
    gossip population run to quiescence, and a loopback bridge exchange —
    so a bare ``lasp_tpu metrics`` emits a representative snapshot
    without needing a live system to scrape."""
    from lasp_tpu_torch.bridge import BridgeClient, BridgeServer
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, ring
    from lasp_tpu_torch.store import Store
    from lasp_tpu_torch.telemetry import span

    with span("cli.metrics_workload", replicas=n_replicas):
        store = Store(n_actors=8, device=dev)
        ads = store.declare(type="lasp_orset", n_elems=16)
        hits = store.declare(type="riak_dt_gcounter")
        tags = store.declare(type="riak_dt_orswot", n_elems=16)
        graph = Graph(store)
        graph.map(ads, lambda x: ("seen", x))
        rt = ReplicatedRuntime(
            store, graph, n_replicas, ring(n_replicas, min(2, n_replicas - 1)),
            device=dev,
        )
        for r in range(n_replicas):
            rt.update_at(r % n_replicas, ads, ("add", f"ad{r}"), f"w{r}")
            rt.update_at(r % n_replicas, hits, ("increment",), f"w{r}")
            rt.update_at(r % n_replicas, tags, ("add", f"t{r}"), f"w{r}")
        rt.run_to_convergence(max_rounds=64)
        # loopback bridge exchange: verbs land in the same process
        # registry the snapshot reads
        from lasp_tpu_torch.bridge.etf import Atom

        with BridgeServer(port=0, device=dev) as server:
            with BridgeClient("127.0.0.1", server.port) as c:
                c.start("metrics_demo")
                c.declare(b"v", "lasp_gset", n_elems=8)
                c.update(b"v", (Atom("add"), b"x"), b"w")
                c.read(b"v")
                c.metrics()


def cmd_metrics(args) -> int:
    """Telemetry snapshot console (the riak-admin status role for the
    metrics subsystem): Prometheus text to stdout, optional JSONL event
    dump, optional watch loop, optional live-bridge scrape."""
    import time

    from lasp_tpu_torch import telemetry

    def emit() -> None:
        if args.bridge:
            from lasp_tpu_torch.bridge import BridgeClient

            host, _, port = args.bridge.rpartition(":")
            with BridgeClient(host or "127.0.0.1", int(port)) as c:
                resp = c.metrics()
            if not (isinstance(resp, tuple) and len(resp) == 2):
                raise RuntimeError(f"bridge metrics verb failed: {resp!r}")
            sys.stdout.write(
                resp[1].decode() if isinstance(resp[1], bytes) else str(resp[1])
            )
        else:
            sys.stdout.write(telemetry.render_prometheus())
        if args.jsonl:
            telemetry.dump_jsonl(sys.stdout)
        sys.stdout.flush()

    if not args.bridge:
        if args.replicas < 2:
            print(
                f"error: --replicas must be >= 2 (a {args.replicas}-replica "
                "population has no gossip edges to observe)",
                file=sys.stderr,
            )
            return 2
        _metrics_workload(args.replicas, _device(args))
    if args.watch:
        try:
            while True:
                emit()
                print(f"--- watch: next snapshot in {args.watch}s ---")
                time.sleep(args.watch)
                if not args.bridge:
                    _metrics_workload(args.replicas, _device(args))
        except KeyboardInterrupt:
            return 0
    emit()
    return 0


def _observatory_runtime(n_replicas: int, dev):
    """The live mesh behind ``top``/``trace`` when no --bridge is given:
    an OR-Set + G-Counter population with a combinator edge (``ads`` ->
    map -> ``seen_ads``), seeded at scattered replicas but NOT yet
    converged — so the observatory has real divergence to watch drain.
    Returns the runtime (its store/graph ride on the instance)."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, ring
    from lasp_tpu_torch.store import Store

    n = n_replicas
    store = Store(n_actors=max(16, n), device=dev)
    ads = store.declare(id="ads", type="lasp_orset", n_elems=32)
    hits = store.declare(id="hits", type="riak_dt_gcounter")
    graph = Graph(store)
    graph.map(ads, lambda x: ("seen", x), dst="seen_ads")
    rt = ReplicatedRuntime(store, graph, n, ring(n, min(2, n - 1)),
                           device=dev)
    rt.update_batch(
        ads,
        [(r, ("add", f"ad{r}"), f"w{r}") for r in range(0, n, max(1, n // 8))],
    )
    rt.update_batch(
        hits,
        [(r, ("increment",), f"w{r}") for r in range(0, n, max(1, n // 4))],
    )
    return rt


def _render_top(health: dict, shard_lag_label: str = "shard lag") -> str:
    """One refresh frame of the ``top`` view as text (pure function of a
    health snapshot, so the CLI test can pin the rendering)."""
    lines = []
    eta = health.get("quiescence_eta")
    lines.append(
        f"convergence: round={health.get('round', 0)} "
        f"replicas={health.get('n_replicas', 0)} "
        f"residual={health.get('residual_total')} "
        f"eta={'?' if eta is None else eta}"
    )
    probe = health.get("probe") or {}
    lag_by_var = probe.get("lag_by_var", {})
    lines.append(f"{'VAR':<20} {'RESIDUAL':>8} {'STALE':>6} {'LAG':>6}")
    residual_by_var = health.get("residual_by_var", {})
    staleness = health.get("staleness", {})
    for v in sorted(residual_by_var, key=lambda x: -residual_by_var[x]):
        lines.append(
            f"{str(v):<20} {residual_by_var[v]:>8} "
            f"{staleness.get(v, 0):>6} {lag_by_var.get(v, '-'):>6}"
        )
    if probe.get("shard_lag"):
        lines.append(
            f"{shard_lag_label}: "
            + "  ".join(
                f"s{i}={sl}" for i, sl in enumerate(probe["shard_lag"])
            )
        )
        lines.append(
            f"worst replica: {probe.get('worst_replica')} "
            f"(lag {probe.get('worst_replica_lag')})"
        )
    alerts = health.get("alerts", [])
    for a in alerts:
        lines.append(f"ALERT: {a}")
    if not alerts:
        lines.append("alerts: none")
    return "\n".join(lines)


def cmd_top(args) -> int:
    """Live cluster-health view (the riak-admin ``top`` role): per-var
    residual/staleness/lag table, per-shard lag, alert lines — refreshed
    from a live bridge's ``{health}`` verb or from a built-in observed
    mesh stepping toward quiescence."""
    import time

    from lasp_tpu_torch.telemetry import get_monitor

    rt = None
    if not args.bridge:
        if args.replicas < 2:
            print(
                "error: --replicas must be >= 2 (nothing to observe)",
                file=sys.stderr,
            )
            return 2
        rt = _observatory_runtime(args.replicas, _device(args))
    iterations = args.iterations
    i = 0
    try:
        while True:
            if args.bridge:
                from lasp_tpu_torch.bridge import BridgeClient

                host, _, port = args.bridge.rpartition(":")
                with BridgeClient(host or "127.0.0.1", int(port)) as c:
                    resp = c.health()
                if not (isinstance(resp, tuple) and len(resp) == 2):
                    raise RuntimeError(f"bridge health verb failed: {resp!r}")
                health = json.loads(
                    resp[1].decode()
                    if isinstance(resp[1], bytes)
                    else str(resp[1])
                )
            else:
                rt.step()  # one observed gossip round per refresh
                mon = get_monitor()
                mon.probe(rt, n_shards=args.shards)
                health = mon.health()
            print(_render_top(health))
            print("---", flush=True)
            i += 1
            if iterations and i >= iterations:
                return 0
            time.sleep(args.refresh)
    except KeyboardInterrupt:
        return 0


def cmd_trace(args) -> int:
    """Causal-history export: drive the observed mesh (variable ``ads``
    through the ``seen_ads`` map edge), collect the event-log records
    relevant to ``--var`` — its own binds/updates/deliveries plus, via
    the dataflow lineage, its upstream sources' — and write a
    Perfetto/Chrome-trace JSON (open in ui.perfetto.dev or
    chrome://tracing)."""
    from lasp_tpu_torch.telemetry import events as tel_events
    from lasp_tpu_torch.telemetry import get_monitor

    if args.deep:
        tel_events.set_deep(True)
    rt = _observatory_runtime(args.replicas, _device(args))
    if args.var not in rt.store.ids():
        # validate BEFORE the convergence run: a typo'd --var must not
        # cost the whole workload
        print(
            f"error: unknown variable {args.var!r} "
            f"(workload vars: {sorted(map(str, rt.store.ids()))})",
            file=sys.stderr,
        )
        return 2
    rt.run_to_convergence(max_rounds=args.max_rounds, block=args.block)
    rt.graph.propagate()  # fold the combinator edges' provenance in
    get_monitor().probe(rt)
    lineage = rt.graph.lineage(args.var)
    history = tel_events.causal_history(args.var, lineage)
    with open(args.export, "w") as fp:
        n = tel_events.export_chrome_trace(fp, event_records=history)
    print(json.dumps({
        "var": args.var,
        "events": len(history),
        "trace_events": n,
        "lineage": {
            v: entry["srcs"] for v, entry in lineage.items()
        },
        "export": args.export,
    }))
    return 0


def cmd_flight(args) -> int:
    """Flight-recorder console: drive the observed mesh's fully fused
    convergence (``converge_on_device`` — zero per-round host syncs),
    then print the windows the on-device ring retained: per-round
    per-variable residual records, exactly what the fused dispatch did
    round by round. ``--export`` writes the full snapshot JSON
    (windows + drop counters) for offline diffing."""
    from lasp_tpu_torch.telemetry import device as tel_flight

    if args.replicas < 2:
        print("error: --replicas must be >= 2 (nothing to record)",
              file=sys.stderr)
        return 2
    rt = _observatory_runtime(args.replicas, _device(args))
    rounds = rt.converge_on_device(max_rounds=args.max_rounds)
    rt.graph.propagate()  # the dataflow megakernel's window too
    ws = tel_flight.windows()
    print(tel_flight.render(ws))
    print(f"converged in {rounds} rounds; "
          f"{len(ws)} flight windows retained")
    if args.export:
        with open(args.export, "w") as fp:
            json.dump(tel_flight.snapshot(), fp, indent=2)
        print(f"exported -> {args.export}")
    return 0


def cmd_roofline(args) -> int:
    """Per-kernel roofline table (the cost-ledger console): achieved
    GB/s and roofline fraction per kernel signature against the device
    capability registry, from a built-in mixed-codec workload (or
    whatever the process already ran when imported in-process).
    ``--export`` writes the full JSON; ``--profile DIR`` additionally
    records the workload with ``torch.profiler`` and writes its Chrome
    trace (Perfetto-openable) into DIR."""
    from lasp_tpu_torch.bench_scenarios import roofline_workload
    from lasp_tpu_torch.telemetry import device_capability, get_ledger

    if args.replicas < 2:
        print("error: --replicas must be >= 2 (no gossip edges)",
              file=sys.stderr)
        return 2
    dev = _device(args)
    if args.profile:
        import os

        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            roofline_workload(args.replicas, rounds=args.rounds, device=dev)
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        roofline_workload(args.replicas, rounds=args.rounds, device=dev)
    cap = device_capability()
    ledger = get_ledger()
    snap = ledger.snapshot()
    peak = cap["peak_GBps"]
    print(
        f"device: {cap['platform']}/{cap['device_kind']}  "
        f"roofline {peak if peak is not None else '?'} GB/s "
        f"({cap['source']})"
    )
    print(f"{'KERNEL':<42} {'DISP':>5} {'ROUNDS':>6} {'MB':>9} "
          f"{'ms':>9} {'GB/s':>8} {'ROOF%':>7}")
    for ent in snap:
        gbps = ent["achieved_GBps"]
        frac = ent["roofline_frac"]
        print(
            f"{ent['kernel']:<42} {ent['dispatches']:>5} "
            f"{ent['rounds']:>6} {ent['bytes'] / 1e6:>9.3f} "
            f"{ent['seconds'] * 1e3:>9.2f} "
            f"{gbps if gbps is not None else '-':>8} "
            f"{('%.2f%%' % (100 * frac)) if frac is not None else '-':>7}"
        )
    summary = ledger.summary()
    print(
        f"total: {summary['totals']['dispatches']} dispatches, "
        f"{summary['totals']['bytes'] / 1e6:.3f} MB, "
        f"achieved {summary['achieved_GBps']} GB/s, "
        f"roofline_frac {summary['roofline_frac']}"
    )
    if args.export:
        with open(args.export, "w") as f:
            json.dump(
                {"capability": cap, "kernels": snap, "summary": summary},
                f, indent=2,
            )
        print(f"exported: {args.export}")
    if args.profile:
        print(f"profile trace: {args.profile}/trace.json (open in "
              "Perfetto / chrome://tracing)")
    return 0


def cmd_inspect(args) -> int:
    from lasp_tpu_torch.store import HostStore
    from lasp_tpu_torch.store.checkpoint import loads_manifest

    with HostStore(args.path) as hs:
        manifest = hs.get("manifest")
        out = {"stats": hs.stats(), "keys": hs.keys()}
        if manifest is not None:
            # restricted unpickler: inspect runs on ARBITRARY paths and a
            # stock pickle.loads would execute attacker-controlled code
            m = loads_manifest(manifest)
            out["kind"] = m.get("kind")
            if "vars" in m:  # runtime snapshots: inline entries
                out["vars"] = {
                    str(vid): entry["type_name"]
                    for vid, entry in m["vars"].items()
                }
            else:  # store logs: header + per-var varmeta records
                from lasp_tpu_torch.store.checkpoint import _varmeta_key

                out["vars"] = {}
                for vid in m.get("var_ids", []):
                    raw = hs.get(_varmeta_key(vid))
                    entry = loads_manifest(raw) if raw is not None else None
                    out["vars"][str(vid)] = (
                        entry["type_name"] if entry else "<missing varmeta>"
                    )
            if "n_replicas" in m:
                out["n_replicas"] = m["n_replicas"]
        print(json.dumps(out, indent=2, default=str))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lasp_tpu_torch", description=__doc__)
    # every verb takes --device (the port's counterpart of JAX's
    # JAX_PLATFORMS); resolved in the verb, never while parsing
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device to run on (default: cuda; "
                             "'cpu' runs off the card)")
    sub = p.add_subparsers(dest="verb", required=True)

    def verb(name: str, **kw):
        return sub.add_parser(name, parents=[common], **kw)

    verb("status", help="devices + version (ringready analogue)")

    from lasp_tpu_torch.config import get_config

    cfg = get_config()
    sim = verb("simulate", help="run a gossip population to fixpoint")
    sim.add_argument("--replicas", type=int, default=1024)
    sim.add_argument("--topology", choices=["ring", "random", "scale_free"],
                     default="random")
    sim.add_argument("--fanout", type=int, default=cfg.fanout)
    sim.add_argument(
        "--type",
        default="lasp_orset",
        # set family writes ("add", item); the G-Counter writes
        # ("increment",) per writer lane — other types (ivar/map) have no
        # meaningful one-op simulate shape and stay excluded
        choices=["lasp_gset", "lasp_orset", "lasp_orset_gbtree",
                 "riak_dt_gcounter", "riak_dt_orswot"],
    )
    sim.add_argument("--elems", type=int, default=64)
    sim.add_argument("--writers", type=int, default=8)
    sim.add_argument("--max-rounds", type=int, default=256)

    bench = verb("bench", help="run the headline benchmark "
                                         "(bench.py's OR-Set anti-entropy)")
    bench.add_argument("--replicas", type=int, default=0)

    ch = verb(
        "chaos",
        help="fault-injection soak: run a population through a nemesis "
             "preset and verify the convergence-under-failure "
             "invariants (docs/RESILIENCE.md)",
    )
    # literal list (not chaos.PRESETS): importing the chaos package here
    # would import torch at every CLI start; tests/test_torch_cli.py pins
    # this against the registry
    ch.add_argument("--preset", required=True,
                    choices=["ring-cut", "rolling-crash", "flaky-links",
                             "slow-shard", "delay-links"])
    ch.add_argument("--replicas", type=int, default=64)
    ch.add_argument("--topology", choices=["ring", "random", "scale_free"],
                    default="ring")
    ch.add_argument("--fanout", type=int, default=cfg.fanout)
    ch.add_argument("--type", default="lasp_gset",
                    choices=["lasp_gset", "lasp_orset", "riak_dt_orswot"])
    ch.add_argument("--elems", type=int, default=64)
    ch.add_argument("--writers", type=int, default=8)
    ch.add_argument("--seed", type=int, default=0)
    ch.add_argument("--rounds", type=int, default=12,
                    help="fault-window length in gossip rounds")
    ch.add_argument("--max-rounds", type=int, default=4096,
                    help="soak budget (rounds) before giving up")
    ch.add_argument("--mode", choices=["dense", "frontier"],
                    default="dense")
    ch.add_argument("--no-replay", action="store_true",
                    help="skip the replay-determinism second run")

    qu = verb(
        "quorum",
        help="quorum coordination soak: batched get/put FSMs under a "
             "nemesis preset + the no-acked-write-lost invariant "
             "(docs/RESILIENCE.md)",
    )
    qu.add_argument("--preset", required=True,
                    choices=["ring-cut", "rolling-crash", "flaky-links",
                             "slow-shard", "delay-links"])
    qu.add_argument("--replicas", type=int, default=32)
    qu.add_argument("--topology", choices=["ring", "random", "scale_free"],
                    default="ring")
    qu.add_argument("--fanout", type=int, default=cfg.fanout)
    qu.add_argument("--writes", type=int, default=12,
                    help="quorum puts issued across the fault window")
    qu.add_argument("--reads", type=int, default=8,
                    help="degraded quorum gets issued alongside")
    qu.add_argument("--n", type=int, default=3, help="preflist width N")
    qu.add_argument("--r", type=int, default=2, help="read quorum R")
    qu.add_argument("--w", type=int, default=2, help="write quorum W")
    qu.add_argument("--timeout", type=int, default=4,
                    help="per-attempt wait in rounds")
    qu.add_argument("--retries", type=int, default=3,
                    help="coordinator re-picks before a partial-quorum "
                         "failure")
    qu.add_argument("--seed", type=int, default=0)
    qu.add_argument("--rounds", type=int, default=10,
                    help="fault-window length in gossip rounds")
    qu.add_argument("--engine", choices=["batched", "sequential"],
                    default="batched")
    qu.add_argument("--no-replay", action="store_true",
                    help="skip the replay-determinism second run")
    qu.add_argument("--hints", default=None, metavar="PATH",
                    help="durable hint-log path (default: in-memory)")
    qu.add_argument("--prune-hints", action="store_true",
                    help="after the harness converges fault-free, "
                         "reclaim every remaining hint record (safe: "
                         "the population has verifiably absorbed them) "
                         "and report the count")

    aae = verb(
        "aae",
        help="active anti-entropy scrub: inject silent corruption "
             "(bit-rot / corrupt-partition presets), detect it via the "
             "Merkle hash forest, localize, quorum-repair, and verify "
             "the healed population bit-equal to a fault-free twin "
             "(docs/RESILIENCE.md 'Active anti-entropy')",
    )
    # literal list (no torch at parse, like --preset above);
    # tests/test_torch_cli.py pins it against CORRUPTION_PRESETS
    aae.add_argument("--preset", default="bit-rot",
                     choices=["bit-rot", "corrupt-partition"])
    aae.add_argument("--replicas", type=int, default=32)
    aae.add_argument("--topology", choices=["ring", "random",
                                            "scale_free"],
                     default="ring")
    aae.add_argument("--fanout", type=int, default=cfg.fanout)
    aae.add_argument("--type", default="lasp_gset",
                     choices=["lasp_gset", "lasp_orset",
                              "riak_dt_orswot"])
    aae.add_argument("--elems", type=int, default=64)
    aae.add_argument("--writers", type=int, default=8)
    aae.add_argument("--seed", type=int, default=0)
    aae.add_argument("--rounds", type=int, default=8,
                     help="corruption-window length in gossip rounds")
    aae.add_argument("--scrub-every", type=int, default=1,
                     help="verify/exchange cadence in rounds (bounds "
                          "detection latency; cadences > 1 require "
                          "--mode frontier — dense all-dirty marks "
                          "launder corruption between scrubs)")
    aae.add_argument("--mode", choices=["dense", "frontier"],
                     default="dense")
    aae.add_argument("--seg-size", type=int, default=8,
                     help="Merkle tree leaves per segment")
    aae.add_argument("--max-rounds", type=int, default=512)
    aae.add_argument("--no-replay", action="store_true",
                     help="skip the replay-determinism second run")

    sv = verb(
        "serve",
        help="serving-front-end soak: open-loop simulated clients "
             "(Zipf keys, write+read+watch mix) through the coalescing "
             "ingest + vectorized threshold fan-out, with admission "
             "control, a composite nemesis, and the no-acked-write-lost "
             "check (docs/SERVING.md)",
    )
    sv.add_argument("--replicas", type=int, default=32)
    sv.add_argument("--clients", type=int, default=2000,
                    help="simulated client fleet size")
    sv.add_argument("--ticks", type=int, default=24,
                    help="run length in serving cycles")
    sv.add_argument("--arrivals", type=int, default=400,
                    help="open-loop request arrivals per tick")
    sv.add_argument("--burst", type=int, default=5,
                    help="mid-run overload multiplier (1 = no burst)")
    sv.add_argument("--watches", type=int, default=1000,
                    help="standing threshold watches registered up front")
    sv.add_argument("--parity", type=int, default=4096,
                    help="post-run vectorized-vs-per-watch threshold "
                         "parity size (0 = skip)")
    sv.add_argument("--no-chaos", action="store_true",
                    help="skip the composite nemesis")
    sv.add_argument("--seed", type=int, default=7)

    scen = verb("scenario", help="run a BASELINE eval config")
    # literal list (not the SCENARIOS registry): importing bench_scenarios
    # here would import torch in every CLI invocation including --help;
    # tests/test_torch_cli.py pins this against the registry
    scen.add_argument(
        "name",
        choices=["aae_scrub", "adcounter_10m", "adcounter_6",
                 "bridge_throughput",
                 "chaos_heal", "dataflow_chain", "elastic_rebalance",
                 "frontier_sparse",
                 "gset_1k", "ingest_storm", "many_vars", "mesh_scale",
                 "orset_100k",
                 "packed_vs_dense",
                 "partitioned_gossip", "pipeline_1m", "quorum_kv",
                 "serve_load"],
    )
    scen.add_argument("--replicas", type=int, default=0,
                      help="override the population for sized scenarios")

    met = verb(
        "metrics",
        help="telemetry snapshot: Prometheus text (+ JSONL events); "
             "runs a 2-replica gossip workload unless --bridge scrapes "
             "a live server",
    )
    met.add_argument("--replicas", type=int, default=2,
                     help="population of the built-in workload")
    met.add_argument("--jsonl", action="store_true",
                     help="also dump span + metric events as JSONL")
    met.add_argument("--watch", type=float, default=0,
                     metavar="SECONDS",
                     help="re-emit every SECONDS until interrupted")
    met.add_argument("--bridge", default=None, metavar="HOST:PORT",
                     help="scrape a live bridge's {metrics} verb instead "
                          "of running the built-in workload")

    top = verb(
        "top",
        help="live cluster-health view: per-var residual/staleness/lag "
             "table + shard lag + alerts, refreshed against a running "
             "mesh (or --bridge scraping a live {health} verb)",
    )
    top.add_argument("--replicas", type=int, default=64,
                     help="population of the built-in observed mesh")
    top.add_argument("--refresh", type=float, default=1.0,
                     metavar="SECONDS", help="delay between frames")
    top.add_argument("--iterations", type=int, default=0,
                     help="stop after N frames (0 = until interrupted)")
    top.add_argument("--shards", type=int, default=None,
                     help="shard count for the lag aggregation "
                          "(default: the runtime's partition plan, else 1)")
    top.add_argument("--bridge", default=None, metavar="HOST:PORT",
                     help="scrape a live bridge's {health} verb instead "
                          "of running the built-in mesh")

    tr = verb(
        "trace",
        help="export a variable's causal event history (its own events "
             "plus upstream combinator sources) as Perfetto/Chrome-trace "
             "JSON",
    )
    tr.add_argument("--var", required=True,
                    help="variable to trace (workload vars: ads, "
                         "seen_ads, hits)")
    tr.add_argument("--export", required=True, metavar="FILE",
                    help="output path for the Chrome-trace JSON")
    tr.add_argument("--replicas", type=int, default=64)
    tr.add_argument("--max-rounds", type=int, default=256)
    tr.add_argument("--deep", action="store_true",
                    help="turn on deep tracing (per-op / per-merge / "
                         "per-edge events) for the driven workload")
    tr.add_argument("--block", type=int, default=1,
                    help="fused-window size for the driven convergence "
                         "(>1 runs device-resident blocks; the flight "
                         "recorder keeps the per-round records real)")

    fl = verb(
        "flight",
        help="drive a fused convergence and dump the on-device flight "
             "recorder: per-round residual records retained by the "
             "in-loop ring (docs/OBSERVABILITY.md)",
    )
    fl.add_argument("--replicas", type=int, default=64)
    fl.add_argument("--max-rounds", type=int, default=256)
    fl.add_argument("--export", default=None, metavar="FILE",
                    help="write the full flight snapshot as JSON")

    roof = verb(
        "roofline",
        help="per-kernel cost-ledger table: achieved GB/s + roofline "
             "fraction per kernel signature against the device "
             "capability registry (docs/OBSERVABILITY.md)",
    )
    roof.add_argument("--replicas", type=int, default=256,
                      help="population of the built-in workload")
    roof.add_argument("--rounds", type=int, default=3,
                      help="re-dirty/convergence cycles to drive")
    roof.add_argument("--export", default=None, metavar="FILE",
                      help="write capability + per-kernel table as JSON")
    roof.add_argument("--profile", default=None, metavar="DIR",
                      help="record the workload with torch.profiler and "
                           "write its Chrome trace (Perfetto-openable) to "
                           "DIR/trace.json")

    ins = verb("inspect", help="list a checkpoint's contents")
    ins.add_argument("path")

    br = verb("bridge", help="serve the Erlang backend bridge")
    br.add_argument("--host", default="127.0.0.1")
    br.add_argument("--port", type=int, default=9190)
    br.add_argument("--actors", type=int, default=cfg.n_actors)
    br.add_argument("--data-dir", default=None,
                    help="durable per-name stores (eleveldb role); "
                         "omit for in-memory")

    args = p.parse_args(argv)
    return {
        "status": cmd_status,
        "simulate": cmd_simulate,
        "bench": cmd_bench,
        "chaos": cmd_chaos,
        "quorum": cmd_quorum,
        "aae": cmd_aae,
        "serve": cmd_serve,
        "scenario": cmd_scenario,
        "metrics": cmd_metrics,
        "top": cmd_top,
        "trace": cmd_trace,
        "flight": cmd_flight,
        "roofline": cmd_roofline,
        "inspect": cmd_inspect,
        "bridge": cmd_bridge,
    }[args.verb](args)


if __name__ == "__main__":
    sys.exit(main())
