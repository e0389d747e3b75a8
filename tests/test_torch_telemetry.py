"""The port's telemetry core against ``lasp_tpu.telemetry``: the same
emissions render the same Prometheus text, metric events and JSONL lines,
and the same causal event records (timestamps aside); the registry's typing
rules, the span ring (with a ``torch.profiler`` range while a profiler
records), the event log's bounds and deep tier, and the
``ConvergenceMonitor``'s feeds, alerts and population probe. Tolerance
zero."""

import io
import json
import os

import numpy as np
import pytest
import torch

import lasp_tpu.mesh as jmesh
import lasp_tpu.store as jstore
import lasp_tpu.telemetry as jtel
import lasp_tpu.telemetry.convergence as jconv
import lasp_tpu.telemetry.events as jevents
import lasp_tpu.telemetry.export as jexport
import lasp_tpu.telemetry.registry as jreg
import lasp_tpu.telemetry.spans as jspans
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.store as tstore
import lasp_tpu_torch.telemetry as ttel
import lasp_tpu_torch.telemetry.convergence as tconv
import lasp_tpu_torch.telemetry.events as tevents
import lasp_tpu_torch.telemetry.export as texport
import lasp_tpu_torch.telemetry.registry as treg
import lasp_tpu_torch.telemetry.spans as tspans
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.mesh import random_regular
from lasp_tpu_torch.dataflow import Graph as TGraph
from lasp_tpu_torch.utils.metrics import Timer

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "telemetry", "golden_prometheus.txt")


@pytest.fixture(autouse=True)
def _reset_on_exit():
    """Both packages' registry and event ring end each test fresh: the ring
    bound test drops events, and ``events_dropped_total`` lives in the
    process-global registry that a later file on the same worker reads
    (``tests/telemetry/test_events.py::test_ring_bounds_and_counts_drops``)."""
    yield
    for tel in (jtel, ttel):
        tel.events.clear()
        tel.reset()


def _emit(reg_mod, reg):
    """One emission sequence, routed into ``reg`` through the package's
    module-level helpers (the emitters' path)."""
    with reg_mod.scratch_registry() as scratch:
        reg_mod.counter("chaos_faults_injected_total",
                        help="chaos fault events activated, by kind",
                        kind="crash").inc()
        reg_mod.counter("chaos_faults_injected_total",
                        help="chaos fault events activated, by kind",
                        kind="restore").inc(2)
        reg_mod.counter("quorum_wire_bytes_total", help="bytes",
                        kind="push").inc(4096)
        reg_mod.gauge("chaos_replicas_crashed", help="down").set(3)
        reg_mod.gauge("quorum_inflight", help="inflight").inc(5)
        reg_mod.gauge("quorum_inflight", help="inflight").dec(2)
        h = reg_mod.histogram("quorum_latency_rounds", help="rounds",
                              kind="get", buckets=(1, 2, 4, 8, 16, 32, 64))
        for x in (1, 1, 3, 9, 70):
            h.observe(x)
        d = reg_mod.histogram("merge_seconds", help="s", type="lasp_orset")
        for x in (1e-6, 0.003, 0.2, 11.0):
            d.observe(x)
        reg_mod.counter("escape_total", help="escapes", k='a"b\\c\nd').inc(1.5)
        reg.update(scratch.snapshot())


def test_same_emissions_render_same_prometheus_text():
    jsnap, tsnap = {}, {}
    _emit(jreg, jsnap)
    _emit(treg, tsnap)
    assert tsnap == jsnap
    assert texport.render_prometheus(tsnap) == jexport.render_prometheus(jsnap)
    assert texport.metric_events(tsnap) == jexport.metric_events(jsnap)
    # the JSONL dump: the same metric lines (the span ring is process state)
    tspans.clear()
    jspans.clear()
    bufs = []
    for exp, snap in ((jexport, jsnap), (texport, tsnap)):
        buf = io.StringIO()
        n = exp.dump_jsonl(buf, snap)
        assert n == len(buf.getvalue().splitlines())
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]


def test_golden_prometheus_file():
    reg = treg.MetricRegistry()
    reg.counter("gossip_rounds_total", help="gossip rounds executed").inc(7)
    reg.gauge("gossip_residual", help="per-var residual", var="v0").set(2)
    reg.gauge("gossip_residual", help="per-var residual", var="v1").set(0)
    h = reg.histogram("merge_seconds", help="merge wall time",
                      buckets=(0.001, 0.01, 0.1), type="lasp_orset")
    for x in (0.0005, 0.05, 5.0):
        h.observe(x)
    reg.counter("bridge_requests_total", help="requests", verb="update").inc(3)
    reg.counter("escape_total", help="escapes", k='a"b\\c\nd').inc(1)
    with open(GOLDEN) as f:
        assert texport.render_prometheus(reg.snapshot()) == f.read()


def test_registry_rules_equal_jax():
    for mod in (jreg, treg):
        reg = mod.MetricRegistry()
        reg.counter("x_total")
        with pytest.raises(TypeError, match="one instrument type"):
            reg.gauge("x_total")
        with pytest.raises(ValueError):
            reg.counter("y_total").inc(-1)
        with pytest.raises(ValueError):
            reg.histogram("h", buckets=(2, 1))
        assert "h" not in reg.names()  # a rejected spec registers nothing
        snap = reg.snapshot()
        reg.counter("x_total").inc(3)
        assert snap["x_total"]["series"][0]["value"] == 0  # deep copy
        g = mod.CounterGroup(("binds", "updates"))
        g["binds"] = 2
        with pytest.raises(KeyError):
            g["nope"] = 1
        with pytest.raises(ValueError):
            g["binds"] = -1
        assert g.snapshot() == {"binds": 2, "updates": 0}
    gen = treg.generation()
    treg.set_enabled(False)
    try:
        assert treg.counter("off_total") is treg.NULL_COUNTER
        assert treg.histogram("off_h") is treg.NULL_HISTOGRAM
        with tspans.span("off"):
            pass
    finally:
        treg.set_enabled(True)
    with treg.scratch_registry():
        assert treg.generation() == gen + 1
    assert treg.generation() == gen + 2


def _events_run(ev, set_round):
    ev.clear()
    ev.configure(ring_size=6)
    try:
        set_round(3)
        ev.emit("chaos", replica=4, action="crash", round=2)
        ev.emit("quorum", round=5, action="round", fired=2, failed=0)
        ev.emit("chaos", var="kv", action="degraded_read", quorum=[1, 2])
        ev.emit_deep("merge", var="kv")
        ev.set_deep(True)
        ev.emit_deep("merge", var="kv", n=1)
        ev.set_deep(False)
        for i in range(5):
            ev.emit("membership", kind="resize", old_n=i, new_n=i + 1)
        with pytest.raises(ValueError, match="unknown event type"):
            ev.emit("nope")
        recs = [{k: v for k, v in r.items() if k != "ts"} for r in ev.events()]
        hist = [r["seq"] for r in ev.causal_history("kv")]
        st = ev.stats()
        buf = io.StringIO()
        n = ev.export_chrome_trace(buf, span_records=[])
        trace = json.loads(buf.getvalue())["traceEvents"]
        for t in trace:
            t.pop("ts")
        return recs, hist, {k: st[k] for k in ("ring", "ring_size", "seq", "dropped")}, n, \
            sorted(trace, key=lambda t: t["args"]["seq"])
    finally:
        ev.configure(ring_size=ev.DEFAULT_RING_SIZE)
        ev.clear()


def test_event_records_equal_jax():
    assert tevents.EVENT_TYPES == jevents.EVENT_TYPES
    want = _events_run(jevents, jevents.set_round)
    got = _events_run(tevents, tevents.set_round)
    assert got == want
    recs = got[0]
    assert len(recs) == 6 and got[2]["dropped"] == 3  # the ring bound


def test_spans_nest_record_errors_and_annotate(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    tspans.clear()
    tspans.configure(jsonl_path=path)
    try:
        with tspans.span("chaos.soak", mode="dense"):
            assert tspans.current_path() == "chaos.soak"
            with tspans.span("chaos.fused_window", rounds=8):
                assert tspans.current_path() == "chaos.soak>chaos.fused_window"
        with pytest.raises(KeyError):
            with tspans.span("quorum.step", round=1):
                raise KeyError("x")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tspans.span("annotated"):
                torch.ones(4).sum()
    finally:
        tspans.configure(jsonl_path="")
    names = [e.name for e in prof.events()]
    assert "annotated" in names
    recs = tspans.events()
    assert [r["path"] for r in recs] == [
        "chaos.soak>chaos.fused_window", "chaos.soak", "quorum.step", "annotated"]
    assert recs[0]["attrs"] == {"rounds": 8} and recs[2]["error"] == "KeyError"
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    assert [r["name"] for r in lines] == [r["name"] for r in recs]
    with Timer() as t:
        pass
    assert t.elapsed >= 0.0


def _feed(mon):
    mon.observe_round(("a", "b"), [64, 2], 0.01, n_replicas=8)
    mon.observe_round(("a", "b"), [32, 0], 0.01)
    mon.observe_round(("a", "b"), [16, 0], 0.01)
    mon.observe_frontier(("a", "b"), [5, 0])
    mon.observe_opaque_rounds(4, quiescent=None)
    mon.observe_round(("a", "b"), [1, 0], 0.01)
    mon.observe_chaos(rounds=12, rounds_to_heal=3, healed=True)
    mon.observe_quorum(completed=4, failed=0, put_p50_rounds=1.0)
    mon.observe_ingest(ops=10, dispatches=2, grouped_vars=4, fallback_vars=1,
                       pad_slots=3, table_slots=12)
    mon.observe_membership("resize", 8, 6)
    mon.add_alert("custom", lambda snap: snap["round"] > 5)
    mon.add_alert("broken", lambda snap: 1 / 0)
    snap = mon.snapshot()
    return snap, mon.alerts(snap), mon.quiescence_eta(), mon.top_divergent(1)


def test_convergence_monitor_feeds_equal_jax():
    jm = jconv.ConvergenceMonitor(thresholds={"max_stale_rounds": 2})
    tm = tconv.ConvergenceMonitor(thresholds={"max_stale_rounds": 2})
    assert _feed(tm) == _feed(jm)
    with pytest.raises(TypeError, match="unknown alert thresholds"):
        tconv.ConvergenceMonitor(thresholds={"nope": 1})
    health = tm.health()
    # the roofline view is the kernel cost ledger's summary, as in JAX
    assert "alerts" in health
    assert set(health["roofline"]) == set(jm.health()["roofline"])
    assert ttel.get_monitor() is tconv.get_monitor()


def test_probe_equal_jax():
    """The on-demand lag probe over the same populations: per-var lag,
    worst replica and per-shard lag."""
    n = 24
    nbrs = random_regular(n, 3, seed=2)
    probes = []
    for port in (False, True):
        store = tstore.Store(device="cpu", n_actors=8) if port else jstore.Store(n_actors=8)
        store.declare(id="g", type="lasp_gset", n_elems=8)
        store.declare(id="c", type="riak_dt_gcounter")
        rt = (tmesh.ReplicatedRuntime(store, TGraph(store), n, nbrs, device="cpu")
              if port else jmesh.ReplicatedRuntime(store, JGraph(store), n, nbrs))
        rt.update_at(3, "g", ("add", "x"), "w")
        rt.update_at(17, "c", ("increment", 2), "w")
        rt.step()
        mon = (tconv if port else jconv).ConvergenceMonitor()
        probes.append([mon.probe(rt), mon.probe(rt, n_shards=5)])
    assert probes[1] == probes[0]
    assert probes[1][0]["worst_replica_lag"] > 0
    assert np.sum(probes[1][1]["shard_lag"]) > 0


def test_module_surfaces_match_jax():
    """The port's telemetry exports JAX's names and JAX's exports the
    port's, each the same kind of object."""
    for name in ttel.__all__:
        assert hasattr(jtel, name), name
    for name in jtel.__all__:
        assert hasattr(ttel, name), name
        assert callable(getattr(ttel, name)) == callable(getattr(jtel, name)), name
    assert set(ttel.__all__) == set(jtel.__all__)
    assert tevents.DEFAULT_RING_SIZE == jevents.DEFAULT_RING_SIZE
    assert tspans.DEFAULT_RING_SIZE == jspans.DEFAULT_RING_SIZE
    assert treg.DEFAULT_BUCKETS == jreg.DEFAULT_BUCKETS
    assert tconv.DEFAULT_THRESHOLDS == jconv.DEFAULT_THRESHOLDS
