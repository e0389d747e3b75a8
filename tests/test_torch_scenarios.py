"""The port's BASELINE scenarios and the ingest A/B against ``lasp_tpu``'s:
``gset_1k`` at its 1,024 replicas, ``orset_100k`` at 2,048 and
``pipeline_1m`` at 4,096 must give JAX's rounds and values; the port's
``ingest_storm`` runs at a small size, and its schedule, replayed through
both packages' ``ingest_cycle``, gives the same states and reports. Only
counts and values are compared: a time taken on the CPU says nothing about
the card."""

import jax
import numpy as np
import pytest
import torch

import lasp_tpu.bench_scenarios as jb
import lasp_tpu.dataflow as jdf
import lasp_tpu.mesh as jmesh
import lasp_tpu.store as jstore
import lasp_tpu_torch.bench_scenarios as tb
from lasp_tpu_torch.lattice.base import tree_leaves

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)


def test_gset_1k_matches_jax():
    want = jb.gset_1k()
    got = tb.gset_1k(device="cpu")
    for key in ("scenario", "rounds", "union_size", "intersection_size",
                "engine", "check"):
        assert got[key] == want[key], key
    assert got["rounds"] > 2


def test_orset_100k_matches_jax_at_2048():
    want = jb.orset_100k(2048)
    got = tb.orset_100k(2048, device="cpu")
    for key in ("scenario", "rounds", "n_elems", "n_tokens",
                "state_bytes_per_replica", "check"):
        assert got[key] == want[key], key
    for key in ("productive_rounds_per_block", "diverged_replicas_at_seed"):
        assert got["convergence"][key] == want["convergence"][key], key


def test_pipeline_1m_matches_jax_at_4096():
    want = jb.pipeline_1m(4096)
    got = tb.pipeline_1m(4096, device="cpu")
    for key in ("scenario", "rounds", "folded_count", "engine", "check"):
        assert got[key] == want[key], key
    assert got["folded_count"] == 16


def test_ingest_storm_small():
    out = tb.ingest_storm(n_replicas=32, n_vars=16, cycles=3, ops_per_cycle=150,
                          gate=None, device="cpu")
    assert out["scenario"] == "ingest_storm_16x32"
    assert out["dispatches"]["got"] == out["dispatches"]["expected"] > 3
    assert out["normalize_alloc_bytes"] < 65536
    assert out["kinds"] == list(tb.INGEST_KINDS)
    assert out["ingest_speedup"] > 0 and out["gate"] is None
    with pytest.raises(RuntimeError, match="under the 1000000.0x gate"):
        tb.ingest_storm(n_replicas=16, n_vars=4, cycles=1, ops_per_cycle=20,
                        reps=1, gate=1e6, device="cpu")


def test_ingest_schedule_replays_identically_through_both_packages():
    """The port's copy of ``_ingest_schedule`` is JAX's function; its
    cycles, replayed through JAX's and the port's ``ingest_cycle`` on the
    same store, give the same reports, states and frontier marks, and
    converge in the same rounds."""
    n, n_vars, seed = 32, 8, 31
    trt, ids = tb.ingest_storm_runtime(n, n_vars, seed=seed, device="cpu")
    sched = tb._ingest_schedule(ids, tb.INGEST_KINDS, n, 3, 100, seed)
    assert sched == jb._ingest_schedule(ids, tb.INGEST_KINDS, n, 3, 100, seed)
    store = jstore.Store(n_actors=4)
    for v in ids:
        tv = trt.store.variable(v)
        caps = {"riak_dt_gcounter": {"n_actors": 4},
                "lasp_gset": {"n_elems": 16},
                "riak_dt_orswot": {"n_elems": 8, "n_actors": 4},
                "lasp_orset": {"n_elems": 8, "n_actors": 4,
                               "tokens_per_actor": 8},
                # lasp_tpu/bench_scenarios.py's ingest_storm map
                "riak_dt_map": {"fields": [("tags", "lasp_gset", {"n_elems": 8}),
                                           ("hits", "riak_dt_gcounter", {})],
                                "n_actors": 4}}[tv.type_name]
        store.declare(id=v, type=tv.type_name, **caps)
    jrt = jmesh.ReplicatedRuntime(store, jdf.Graph(store), n,
                                  jmesh.random_regular(n, 3, seed=seed))
    for cycle in sched:
        jrep, trep = jrt.ingest_cycle(cycle), trt.ingest_cycle(cycle)
        assert jrep == trep
    assert {trt.store.variable(v).type_name for v in ids} == set(tb.INGEST_KINDS)
    for v in ids:
        tl, jl = tree_leaves(trt.states[v]), jax.tree_util.tree_leaves(jrt.states[v])
        assert len(tl) == len(jl), v
        for a, b in zip(tl, jl):
            assert np.array_equal(a.numpy(), np.asarray(b)), v
        assert np.array_equal(jrt._frontier[v], trt._frontier[v]), v
    assert trt.run_to_convergence(mode="frontier") == jrt.run_to_convergence(
        mode="frontier")
    for v in ids:
        assert trt.coverage_value(v) == jrt.coverage_value(v)


def _without_seconds(rec):
    if isinstance(rec, dict):
        return {k: _without_seconds(v) for k, v in rec.items()
                if "seconds" not in k and k not in ("device", "speedup")}
    return rec


def test_aae_scrub_matches_jax_at_24():
    """Every preset's drill (asserted in both scenarios): the same
    injections, detections, repairs, bytes and exchange counts."""
    want = jb.aae_scrub(n_replicas=24)
    got = tb.aae_scrub(n_replicas=24, device="cpu")
    assert list(got["presets"]) == list(want["presets"])
    for preset, rec in want["presets"].items():
        rec = _without_seconds(rec)
        mine = _without_seconds(got["presets"][preset])
        mine.pop("scrubs"), mine.pop("rounds")
        # JAX rounds the fraction to 4 places; the port reports it whole
        assert round(mine.pop("repair_frac_of_resync"), 4) == rec.pop(
            "repair_frac_of_resync")
        assert mine == rec, preset
    assert got["rehash"]["n_replicas"] == 1024 and got["rehash"]["hot_rows"] == 2


def _fresh_ledgers():
    """Both packages' kernel cost ledgers start empty: a signature's first
    dispatch is banked as its compile bucket, so the byte totals depend on
    the ledger's history."""
    import lasp_tpu.telemetry as jtel
    import lasp_tpu_torch.telemetry as ttel

    jtel.reset()
    ttel.reset()


def test_elastic_rebalance_matches_jax_at_64_96():
    _fresh_ledgers()
    want = jb.elastic_rebalance()
    got = tb.elastic_rebalance(device="cpu")
    for leg in ("grow", "leave"):
        w, g = _without_seconds(want[leg]), _without_seconds(got[leg])
        if leg == "grow":
            # the kernel cost ledger's gossip bytes, as JAX's
            assert g.pop("staged_gossip_ledger_bytes") == w.pop(
                "staged_gossip_ledger_bytes")
            assert round(g.pop("wire_vs_full_resync"), 2) == w.pop("wire_vs_full_resync")
        assert g == w, leg
    assert got["epoch"] == want["epoch"] == 2
    assert got["grow"]["transfer_bytes"] <= got["grow"]["full_resync_bytes"]


def test_elastic_rebalance_random_regular_small(monkeypatch):
    """The card's topology (``random_regular(n, 3, seed)``) held against
    JAX's scenario, whose ``ring`` import is swapped for the same table:
    every count of both legs equal."""
    monkeypatch.setattr(jmesh, "ring",
                        lambda n, _k=2: jmesh.random_regular(n, 3, seed=31))
    _fresh_ledgers()
    want = jb.elastic_rebalance(n_replicas=48, grow_to=72, per_cycle=6)
    got = tb.elastic_rebalance(n_replicas=48, grow_to=72, per_cycle=6,
                               topology="random_regular", device="cpu")
    for leg in ("grow", "leave"):
        w, g = _without_seconds(want[leg]), _without_seconds(got[leg])
        if leg == "grow":
            # the kernel cost ledger's gossip bytes, as JAX's
            assert g.pop("staged_gossip_ledger_bytes") == w.pop(
                "staged_gossip_ledger_bytes")
            assert round(g.pop("wire_vs_full_resync"), 2) == w.pop("wire_vs_full_resync")
        assert g == w, leg
    assert got["grow"]["max_cycle_transfers"] <= 6
    assert got["grow"]["pending_high_water"] <= 24
    assert got["leave"]["transfer_bytes"] > 0


def test_serve_load_matches_jax_small():
    kw = dict(n_replicas=16, n_clients=300, ticks=8, arrivals_per_tick=60,
              seed_watches=50, parity_thresholds=400, seed=7)
    want = jb.serve_load(**kw)
    got = tb.serve_load(device="cpu", **kw)
    for rep in (want, got):
        rep.pop("overlap_seconds")
    assert _without_seconds(got) == _without_seconds(want)
    assert got["no_write_lost"] and got["threshold_parity"]["parity"]


# -- the scenarios of the user-surface slice -----------------------------------


def test_scenarios_registry_has_jax_keys():
    assert list(tb.SCENARIOS) == list(jb.SCENARIOS)
    for name in ("partitioned_gossip", "mesh_scale"):
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            tb.SCENARIOS[name]()


def _gset_population(pkg, n, n_vars, n_elems, write_vars, n_writes, seed):
    """``frontier_sparse``'s population, built by either package."""
    if pkg == "jax":
        store = jstore.Store(n_actors=4)
        make = lambda: jmesh.ReplicatedRuntime(  # noqa: E731
            store, jdf.Graph(store), n, jmesh.random_regular(n, 3, seed=seed))
    else:
        from lasp_tpu_torch.dataflow import Graph
        from lasp_tpu_torch.mesh import ReplicatedRuntime, random_regular
        from lasp_tpu_torch.store import Store

        store = Store(n_actors=4, device="cpu")
        make = lambda: ReplicatedRuntime(  # noqa: E731
            store, Graph(store), n, random_regular(n, 3, seed=seed), device="cpu")
    ids = [store.declare(id=f"v{i}", type="lasp_gset", n_elems=n_elems)
           for i in range(n_vars)]
    rt = make()
    rng = np.random.RandomState(seed)
    for v in ids[:write_vars]:
        rows = rng.choice(n, size=n_writes, replace=False)
        rt.update_batch(v, [(int(r), ("add", f"w{int(r) % 8}"), f"client{int(r)}")
                            for r in rows])
    return rt, ids


def test_frontier_sparse_matches_jax_small():
    kw = dict(n_replicas=512, n_vars=4, n_elems=32, write_frac=0.02)
    want = jb.frontier_sparse(**kw)
    got = tb.frontier_sparse(device="cpu", **kw)
    for key in ("scenario", "rounds", "dense_rows_touched", "write_density",
                "write_vars", "n_vars", "engine", "check"):
        assert got[key] == want[key], key
    assert got["cuda_rows"]["max_abs_err"] == 0
    assert got["cuda_rows"]["mode"] == "plain-parity"
    # the frontier arm round by round, at the default crossover: the same
    # residuals and rows touched as JAX's (the scenario's own replays
    # autotune the crossover from host timings)
    trt, ids = _gset_population("torch", 512, 4, 32, 2, 10, 13)
    jrt, _ = _gset_population("jax", 512, 4, 32, 2, 10, 13)
    assert trt.run_to_convergence(mode="frontier") == jrt.run_to_convergence(
        mode="frontier") == got["rounds"]
    assert trt.round_residuals == [r["residual"] for r in jrt.trace.rounds]
    assert trt.frontier_rows_total == jrt.frontier_rows_total


def test_many_vars_matches_jax_small():
    kw = dict(n_replicas=96, n_vars=12, reps=1)
    want = jb.many_vars(**kw)
    got = tb.many_vars(device="cpu", **kw)
    for key in ("scenario", "rounds", "plan", "n_vars", "hot_vars", "engine",
                "check"):
        assert got[key] == want[key], key
    assert got["cuda_rows"]["max_abs_err"] == 0
    # the residual sequence the scenario asserted across its arms, against
    # JAX's frontier rounds on the same population
    jstore_ = jstore.Store(n_actors=4)
    trt, ids = tb.many_vars_runtime(96, 12, 2, 3, 23, "auto", device="cpu")
    for v in ids:
        tv = trt.store.variable(v)
        caps = {"lasp_gset": {"n_elems": 16}, "riak_dt_gcounter": {"n_actors": 4},
                "riak_dt_orswot": {"n_elems": 8, "n_actors": 4}}[tv.type_name]
        jstore_.declare(id=v, type=tv.type_name, **caps)
    jrt = jmesh.ReplicatedRuntime(jstore_, jdf.Graph(jstore_), 96,
                                  jmesh.random_regular(96, 3, seed=23), plan="auto")
    rng = np.random.RandomState(23)
    kinds = ("lasp_gset", "riak_dt_gcounter", "riak_dt_orswot")
    for j, v in enumerate(ids):
        rows = rng.choice(96, 12 if j < 2 else 1, replace=False)
        kind = kinds[j % 3]
        if kind == "lasp_gset":
            ops = [(int(r), ("add", f"e{int(r) % 8}"), f"a{int(r)}") for r in rows]
        elif kind == "riak_dt_gcounter":
            ops = [(int(r), ("increment",), ("lane", int(r) % 4)) for r in rows]
        else:
            ops = [(int(r), ("add", f"x{int(r) % 8}"), f"w{int(r) % 4}") for r in rows]
        jrt.update_batch(v, ops)
    def drive(rt):
        residuals = [rt.frontier_step()]
        while residuals[-1]:
            residuals.append(rt.frontier_step())
        return residuals

    assert got["residuals"] == drive(jrt) == drive(trt)
    for v in ids:
        for a, b in zip(tree_leaves(trt.states[v]),
                        jax.tree_util.tree_leaves(jrt.states[v])):
            assert np.array_equal(a.numpy(), np.asarray(b)), v


def _jax_packed_vs_dense_runtime(n, packed):
    """JAX's ``packed_vs_dense`` population (its nested ``build``,
    ``lasp_tpu/bench_scenarios.py:1905``), built here as it builds it."""
    store = jstore.Store(n_actors=8)
    graph = jdf.Graph(store)
    v = store.declare(id="src", type="lasp_orset", n_elems=16, n_actors=8,
                      tokens_per_actor=4)
    graph.map(v, lambda x: x + "!", dst="out", dst_elems=16)
    rt = jmesh.ReplicatedRuntime(store, graph, n,
                                 jmesh.random_regular(n, 3, seed=9),
                                 packed=packed)
    rt.update_batch(v, [(0, ("add_all", [f"e{i}" for i in range(8)]), "w")])
    return rt


def _states_equal(trt, jrt):
    from lasp_tpu_torch.bridge_state import to_numpy

    for v in ("src", "out"):
        got = to_numpy(trt.states[v])
        want = jax.tree_util.tree_leaves(jrt.states[v])
        assert len(got) == len(want), v
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b)), v


@pytest.mark.parametrize("mode", ["dense", "packed"])
def test_packed_vs_dense_matches_jax_small(mode):
    """Each arm of ``packed_vs_dense`` at 256 replicas against JAX's on the
    same population: states equal after one fused block of 4, then the
    rounds to convergence, the states there and the ``out`` value; the
    scenario's own record carries JAX's constant fields."""
    jrt = _jax_packed_vs_dense_runtime(256, mode == "packed")
    trt = tb.packed_vs_dense_runtime(256, mode == "packed", device="cpu")
    _states_equal(trt, jrt)
    assert trt.fused_steps(4) == jrt.fused_steps(4)
    _states_equal(trt, jrt)
    rounds = trt.run_to_convergence(block=4)
    assert rounds == jrt.run_to_convergence(block=4)
    _states_equal(trt, jrt)
    assert trt.coverage_value("out") == jrt.coverage_value("out")
    want = jb.packed_vs_dense(n_replicas=256, blocks=1, block=4)
    got = tb.packed_vs_dense(n_replicas=256, blocks=1, block=4, device="cpu")
    for key in ("scenario", "n_replicas", "rounds_timed", "engine", "check"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("mode", ["dense", "packed"])
def test_dense_round_in_row_blocks_matches_jax(mode, monkeypatch):
    """A dense round over populations larger than ``gossip.SWEEP_BYTES``
    and ``CHUNK_BYTES`` runs its replica-local sweep, its gathers and joins
    and its residual a block of rows at a time (``packed_vs_dense`` at
    1,048,576 replicas): with both cut to 40 rows of the dense ``out``
    leaves (the sweep in blocks of 18 rows, the dense gossip in blocks of
    40, the last ones short), each arm still steps through JAX's residuals
    and states."""
    import lasp_tpu_torch.mesh.gossip as tgossip

    monkeypatch.setattr(tgossip, "CHUNK_BYTES", 40 * 16 * 512)
    monkeypatch.setattr(tgossip, "SWEEP_BYTES", 40 * 16 * 512)
    jrt = _jax_packed_vs_dense_runtime(256, mode == "packed")
    trt = tb.packed_vs_dense_runtime(256, mode == "packed", device="cpu")
    for _ in range(6):
        assert trt.step() == jrt.step()
        _states_equal(trt, jrt)
    assert trt.run_to_convergence(block=4) == jrt.run_to_convergence(block=4)
    _states_equal(trt, jrt)


def test_roofline_workload_families_map_to_jax():
    """The port's ledger families after ``roofline_workload`` are JAX's,
    ``pallas_*`` as ``cuda_*``, less ``shard_exchange`` (sharding, A5);
    both probes hold their kernel's plain version bit for bit."""
    import lasp_tpu.telemetry as jtel
    import lasp_tpu_torch.telemetry as ttel

    _fresh_ledgers()
    jb.roofline_workload(32, rounds=1)
    rt = tb.roofline_workload(32, rounds=1, device="cpu")
    rename = {"pallas_dense": "cuda_dense", "pallas_rows": "cuda_rows"}
    want = {rename.get(e["kernel"].split(":")[0], e["kernel"].split(":")[0])
            for e in jtel.get_ledger().snapshot()} - {"shard_exchange"}
    got = {e["kernel"].split(":")[0] for e in ttel.get_ledger().snapshot()}
    assert got == want
    assert rt.cuda_rows_probe["max_abs_err"] == 0
    assert rt.cuda_dense_probe["max_abs_err"] == 0
    assert rt.cuda_rows_probe["bytes_moved"] > 0


def test_bridge_throughput_counts_every_op():
    out = tb.bridge_throughput(n_ops=100, device="cpu")
    assert out["scenario"] == "bridge_throughput_100"
    assert out["etf_impl"] in ("native", "python")
    assert out["codec"]["merge_batch_16x32elem"]["frame_bytes"] > 40_000
    assert out["loopback_roundtrips_per_s"] > 0
