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
