"""The port's telemetry, name for name with ``lasp_tpu``'s: one seeded drive
of every telemetry site (``chip_smoke.telemetry_drive``: the engine
population's widths at 32 replicas, update_batch and update_at, an
actor-guard refusal, dense and frontier steps, converge_on_device, the
three blocking reads, a resize, a map -> filter -> union -> product chain
propagated fused and per edge) runs through both packages, and the two
transcripts — metric families, labels, counter and gauge values, histogram
counts, causal events without their seconds, span names in order — are
equal with the deep tier off and on, once the port's own names
(``PORT_ONLY``, ROADMAP C13, each of the ring and the registry asserted
on the drive) are left out. Beside it: every literal metric, span
and event name of ``lasp_tpu`` exists in the port (JAX's Pallas race
counter excepted, ROADMAP C12); twins of
``tests/telemetry/test_integration_gossip.py``, of the propagate records
in ``tests/dataflow/test_fusion.py`` and of
``tests/dataflow/test_frontier_skip.py``; ``capture_scenario``'s trace and
clock; the overhead guard's report keys. Tolerance zero."""

import ast
import json
import os
import pathlib
import types
import warnings

import pytest
import torch

import chip_smoke
import lasp_tpu.dataflow as jdf
import lasp_tpu.mesh as jmesh
import lasp_tpu.mesh.runtime as jrt_mod
import lasp_tpu.store as jstore
import lasp_tpu.telemetry as jtel
import lasp_tpu_torch.dataflow as tdf
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.mesh.runtime as trt_mod
import lasp_tpu_torch.store as tstore
import lasp_tpu_torch.telemetry as ttel
from lasp_tpu_torch import cli

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: the one JAX name the port does not emit: the winners of JAX's race
#: between its XLA and Pallas arms (ROADMAP C12)
NOT_CARRIED = {"gossip_pallas_race_total"}
#: the names the port emits and JAX does not (ROADMAP C13): the spans of
#: the converge step's and the frontier round's parts and of the whole
#: operations around them, the profiler ranges of a sweep's chunk and of
#: the codec (never in the ring), and the counters the benchmark reads
PORT_ONLY_SPANS = {
    "dataflow.sweep", "gossip.pull", "frontier.reach", "frontier.dispatch",
    "frontier.reseed", "gossip.frontier_converge", "telemetry.emit",
    "mesh.ingest_cycle", "mesh.replica_value",
}
PORT_ONLY_RANGES = {"dataflow.trigger", "packed.pack", "packed.unpack"}
PORT_ONLY_METRICS = {
    "gossip_rounds_run_total", "gossip_frontier_dense_rounds_total",
    "ingest_cycle_ops_total",
}
PORT_ONLY = PORT_ONLY_SPANS | PORT_ONLY_RANGES | PORT_ONLY_METRICS


@pytest.fixture(autouse=True)
def _fresh():
    """Both packages' registry, event ring, span ring and flight log start
    and end each test fresh (the deep tier off), so no count leaks into
    another file's process-global reads."""
    for tel in (jtel, ttel):
        tel.reset()
        tel.events.clear()
        tel.clear_spans()
    yield
    for tel in (jtel, ttel):
        tel.events.set_deep(False)
        tel.events.clear()
        tel.clear_spans()
        tel.device.clear()
        tel.reset()


def _modules(port: bool):
    if port:
        return types.SimpleNamespace(
            Store=tstore.Store, Graph=tdf.Graph,
            ReplicatedRuntime=tmesh.ReplicatedRuntime,
            random_regular=tmesh.random_regular,
            ActorCollisionError=trt_mod.ActorCollisionError, telemetry=ttel)
    return types.SimpleNamespace(
        Store=jstore.Store, Graph=jdf.Graph,
        ReplicatedRuntime=jmesh.ReplicatedRuntime,
        random_regular=jmesh.random_regular,
        ActorCollisionError=jrt_mod.ActorCollisionError, telemetry=jtel)


# -- the transcript -----------------------------------------------------------


@pytest.mark.parametrize("deep", [False, True], ids=["coarse", "deep"])
def test_transcript_equals_jax(deep):
    want = chip_smoke.telemetry_drive(_modules(False), 32, deep, {})
    got = chip_smoke.telemetry_drive(_modules(True), 32, deep, {"device": "cpu"})
    assert ttel.spans.PORT_ONLY == PORT_ONLY
    assert ttel.spans.RANGES == PORT_ONLY_RANGES
    # every port-only name of the ring and the registry is on the drive,
    # no range is in the ring, and only those names are dropped
    assert {m[0] for m in got["metrics"]} >= PORT_ONLY_METRICS
    assert set(got["spans"]) >= PORT_ONLY_SPANS
    assert not set(got["spans"]) & PORT_ONLY_RANGES
    assert not PORT_ONLY & ({m[0] for m in want["metrics"]} | set(want["spans"]))
    got["metrics"] = [m for m in got["metrics"] if m[0] not in PORT_ONLY]
    got["spans"] = [n for n in got["spans"] if n not in PORT_ONLY]
    assert got["checks"] == want["checks"]
    assert got["metrics"] == want["metrics"]
    assert got["events"] == want["events"]
    assert got["spans"] == want["spans"]
    assert got["dropped"] == want["dropped"] == 0
    names = {m[0] for m in got["metrics"]}
    # every family this slice ports is on the drive
    assert {
        "dataflow_rounds_total", "dataflow_propagate_seconds",
        "dataflow_edge_recomputes_total", "dataflow_edges_skipped_total",
        "dataflow_plan_cache_hits_total", "dataflow_plan_cache_built_total",
        "dataflow_edge_refreshes_total", "merge_seconds", "update_batch_seconds",
        "ingest_fallback_total", "actor_guard_rejections_total",
        "membership_epoch", "step_dispatches_total", "step_dispatch_seconds",
    } <= names
    etypes = {e[0] for e in got["events"]}
    assert {"propagate", "propagate_sweep", "frontier_skip", "threshold_fire",
            "update"} <= etypes
    assert ("merge" in etypes) == deep and ("edge_recompute" in etypes) == deep
    fires = [e[4] for e in got["events"] if e[0] == "threshold_fire"]
    assert [dict(a).get("verb") for a in fires] == [
        "read_until", "read_any_until", "read_until", None]
    spans = set(got["spans"])
    assert {"dataflow.propagate", "mesh.update_batch", "gossip.ingest_apply",
            "gossip.plan_round"} <= spans
    assert {"merge.lasp_orset", "merge.riak_dt_gcounter",
            "merge.riak_dt_orswot", "merge.riak_dt_map"} <= spans


# -- the static inventory -------------------------------------------------------

_EMITTERS = {"counter", "gauge", "histogram", "span", "emit", "emit_deep"}


def _emitted_names(pkg: pathlib.Path) -> set:
    """Every literal first argument of an emitter call in ``pkg`` (an
    f-string span name as its literal prefix plus ``*``)."""
    out = set()
    for path in pkg.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if name not in _EMITTERS:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.add(arg.value)
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                out.add(arg.values[0].value + "*")
    return out


def test_every_jax_name_is_emitted_by_the_port():
    jax_names = _emitted_names(ROOT / "lasp_tpu")
    port_names = _emitted_names(ROOT / "lasp_tpu_torch")
    assert {"merge.*", "dataflow.propagate", "propagate_sweep",
            "step_dispatches_total"} <= jax_names
    assert jax_names - port_names == NOT_CARRIED
    assert not NOT_CARRIED & port_names
    roadmap = (ROOT / "ROADMAP.md").read_text()
    assert "C12" in roadmap and "gossip_pallas_race_total" in roadmap


# -- twins of tests/telemetry/test_integration_gossip.py ------------------------


def _value(snap, name, **labels):
    fam = snap.get(name)
    assert fam is not None, f"metric {name} missing from snapshot"
    for s in fam["series"]:
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s
    raise AssertionError(f"{name} has no series matching {labels}: {fam}")


def test_two_replica_workload_covers_all_layers(capsys):
    assert cli.main(["metrics", "--jsonl", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    snap = ttel.get_registry().snapshot()
    assert _value(snap, "gossip_rounds_total")["value"] > 0
    assert _value(snap, "gossip_bytes_exchanged_total")["value"] > 0
    for s in snap["gossip_residual"]["series"]:
        assert s["value"] == 0
    for tn in ("lasp_orset", "riak_dt_gcounter", "riak_dt_orswot"):
        series = _value(snap, "merge_seconds", type=tn)
        assert series["count"] > 0
        assert series["sum"] >= 0
    assert _value(snap, "dataflow_edge_recomputes_total", kind="map")["value"] > 0
    for verb in ("start", "declare", "idem", "read", "metrics"):
        assert _value(snap, "bridge_requests_total", verb=verb)["value"] == 1
        assert _value(snap, "bridge_request_seconds", verb=verb)["count"] == 1
    assert "bridge_errors_total" not in snap
    assert "# TYPE gossip_rounds_total counter" in out
    jlines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert {line["kind"] for line in jlines} == {"span", "metric"}
    span_names = {line["name"] for line in jlines if line["kind"] == "span"}
    assert "gossip.round" in span_names
    assert any(n.startswith("merge.") for n in span_names)
    assert any(n.startswith("bridge.") for n in span_names)
    assert "gossip_rounds_total" in {
        line["name"] for line in jlines if line["kind"] == "metric"}


def test_step_trace_facade_mirrors_into_registry():
    from lasp_tpu_torch.utils.metrics import StepTrace

    t = StepTrace()
    t.bump("merges", 5)
    t.bump("merges")
    t.record_round(3, 0.25)
    assert t.summary() == {
        "rounds": 1, "seconds": 0.25, "residual_path": [3], "merges": 6,
    }
    snap = ttel.get_registry().snapshot()
    assert _value(snap, "step_dispatches_total")["value"] == 1
    assert _value(snap, "step_dispatch_seconds")["count"] == 1


def test_bridge_metrics_verb_scrapes_without_start():
    from lasp_tpu_torch.bridge import BridgeClient, BridgeServer
    from lasp_tpu_torch.bridge.etf import Atom

    with BridgeServer(port=0, device="cpu") as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            ok, text = c.metrics()
            assert ok == Atom("ok")
            assert isinstance(text, bytes)
            _ok, text2 = c.metrics()
            assert b'bridge_requests_total{verb="metrics"}' in text2


def test_actor_guard_rejections_counted():
    store = tstore.Store(n_actors=4, device="cpu")
    v = store.declare(type="riak_dt_gcounter")
    rt = tmesh.ReplicatedRuntime(store, tdf.Graph(store), 4, tmesh.ring(4, 2),
                                 debug_actors=True, device="cpu")
    rt.update_at(0, v, ("increment",), "w")
    with pytest.raises(trt_mod.ActorCollisionError):
        rt.update_at(1, v, ("increment",), "w")
    snap = ttel.get_registry().snapshot()
    assert _value(snap, "actor_guard_rejections_total")["value"] == 1


# -- twins of the propagate records in tests/dataflow/ --------------------------


def _counter_value(name, **labels):
    fam = ttel.get_registry().snapshot().get(name)
    if not fam:
        return 0
    return sum(s["value"] for s in fam["series"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def _mixed_graph():
    """``tests/dataflow/test_fusion.py``'s graph: OR-SWOT bind_to chains,
    G-Set maps into a union, an OR-Set filter into a product."""
    store = tstore.Store(n_actors=2, device="cpu")
    g = tdf.Graph(store)
    for c in range(2):
        store.declare(id=f"o{c}_0", type="riak_dt_orswot", n_elems=4, n_actors=2)
        for d in range(3):
            g.bind_to(f"o{c}_{d + 1}", f"o{c}_{d}")
    a = store.declare(id="a", type="lasp_gset", n_elems=8)
    b = store.declare(id="b", type="lasp_gset", n_elems=8)
    m1 = g.map(a, lambda x: x * 10, dst="m1", dst_elems=8)
    m2 = g.map(b, lambda x: x * 10, dst="m2", dst_elems=8)
    g.union(m1, m2, dst="u")
    s = store.declare(id="s", type="lasp_orset", n_elems=4, n_actors=2,
                      tokens_per_actor=8)
    f = g.filter(s, lambda t: True, dst="f")
    g.product(f, s, dst="p")
    return store, g


def _last_propagate():
    return [e for e in ttel.events.events() if e["etype"] == "propagate"][-1]


def test_auto_mode_is_fused_and_default():
    store, g = _mixed_graph()
    assert g.fusion == "auto"
    store.update("a", ("add", 1), "w")
    g.propagate()
    assert _last_propagate()["attrs"]["fused"] is True


def test_fused_and_subset_executables_share_one_cache():
    store, g = _mixed_graph()
    store.update("a", ("add", 1), "w")
    g.propagate(mode="fused")
    store.update("a", ("add", 2), "w")
    g.propagate(mode="per_edge")
    assert {k[0] for k in g._cache._entries} == {"fused", "subset"}
    store.update("a", ("add", 3), "w")
    g.propagate(mode="fused")  # builds the {a}-dirty entry
    hits0 = _counter_value("dataflow_plan_cache_hits_total", kind="fused")
    store.update("a", ("add", 4), "w")
    g.propagate(mode="fused")  # the same dirty pattern: a cache hit
    assert _counter_value("dataflow_plan_cache_hits_total", kind="fused") > hits0
    assert _counter_value("dataflow_plan_cache_built_total", kind="fused") >= 1


def test_poison_lookup_is_not_a_hit():
    from lasp_tpu_torch.dataflow import plan as dplan

    cache = dplan.PropagateCache()
    cache.poison(("fused", (0,)))
    assert cache.get(("fused", (0,))) is dplan.POISON
    cache.put(("subset", (1,)), "s1")
    assert cache.get(("subset", (1,))) == "s1"
    assert _counter_value("dataflow_plan_cache_hits_total", kind="fused") == 0
    assert _counter_value("dataflow_plan_cache_hits_total", kind="subset") == 1
    assert _counter_value("dataflow_plan_cache_built_total", kind="subset") == 1


def test_stack_fallback_counted_beside_its_warning():
    from lasp_tpu_torch.dataflow import plan as dplan

    class Unstackable:
        kind = "map"
        stackable = True

        def contribution(self, _t, _s):
            raise TypeError("no stacked form")

    edges = [Unstackable(), Unstackable()]
    states = {"x": torch.zeros(2)}
    for e in edges:
        e.srcs = ("x",)
    tables = [torch.zeros(1), torch.zeros(1)]
    with pytest.warns(RuntimeWarning, match="cannot stack"):
        groups = dplan.guard_groups(edges, [[0, 1]], states, tables)
    assert groups == [[0], [1]] and not any(e.stackable for e in edges)
    assert _counter_value("dataflow_plan_fallbacks_total", reason="stack") == 1


def test_propagate_event_carries_per_dst_changed_counts():
    store, g = _mixed_graph()
    store.update("a", ("add", 1), "w")
    g.propagate(mode="fused")
    attrs = _last_propagate()["attrs"]
    assert attrs["fused"] is True and attrs["rounds"] >= 1
    by_dst = attrs["changed_by_dst"]
    assert by_dst["m1"] >= 1 and by_dst["u"] >= 1
    assert set(by_dst) == {e.dst for e in g.edges}


def test_causal_history_includes_fused_propagate_summary():
    store, g = _mixed_graph()
    store.update("a", ("add", 1), "w")
    g.propagate(mode="fused")
    hist = ttel.events.causal_history("u", lineage=g.lineage("u"))
    assert any(r["etype"] == "propagate" for r in hist)
    assert any(r["etype"] == "propagate_sweep" for r in hist)


def test_fused_host_syncs_unchanged_by_the_emission():
    """The emission reads only what the block syncs brought to the host:
    a fused propagate still syncs once a block of sweeps."""
    from lasp_tpu_torch.ops.fused import DATAFLOW_BLOCK

    store, g = _mixed_graph()
    for c in range(2):
        store.update(f"o{c}_0", ("add", f"e{c}"), "w")
    store.update("a", ("add", 1), "w")
    g.propagate(mode="fused")
    lp = g.last_propagate
    assert lp["path"] == "fused"
    assert lp["host_syncs"] == -(-lp["sweeps"] // DATAFLOW_BLOCK)
    assert _last_propagate()["attrs"]["sweeps"] == lp["sweeps"]


def test_untouched_chain_is_skipped():
    store = tstore.Store(n_actors=4, device="cpu")
    g = tdf.Graph(store)
    a = store.declare(id="a", type="lasp_gset", n_elems=8)
    b = g.map(a, lambda x: x * 10, dst="b", dst_elems=8)
    c = g.map(b, lambda x: x + 1, dst="c", dst_elems=8)
    x = store.declare(id="x", type="lasp_gset", n_elems=8)
    y = g.map(x, lambda t: -t, dst="y", dst_elems=8)
    store.update(a, ("add", 1), "w")
    store.update(x, ("add", 5), "w")
    g.propagate()
    assert store.value(c) == {11}
    assert store.value(y) == {-5}
    before = _counter_value("dataflow_edges_skipped_total")
    store.update(a, ("add", 2), "w")
    assert g.propagate() >= 1
    assert store.value(c) == {11, 21}
    assert store.value(y) == {-5}
    assert _counter_value("dataflow_edges_skipped_total") > before
    assert any(e["etype"] == "frontier_skip" for e in ttel.events.events())


# -- the profiler hooks and the overhead guard ----------------------------------


def test_profile_capture_writes_trace(tmp_path):
    out, trace_dir = ttel.capture_scenario(
        lambda: int(torch.arange(8).sum()), log_dir=str(tmp_path / "t"))
    assert out == 28
    assert os.path.isdir(trace_dir)
    files = [os.path.join(dp, f) for dp, _dn, fn in os.walk(trace_dir) for f in fn]
    assert files, "profiler trace produced no files"
    assert json.loads(pathlib.Path(trace_dir, "trace.json").read_text())["traceEvents"]
    snap = ttel.get_registry().snapshot()
    assert _value(snap, "profile_capture_seconds")["count"] == 1
    with pytest.raises(KeyError):
        with ttel.profile(str(tmp_path / "p")):
            raise KeyError("the body's error survives")


def test_overhead_arms_have_jax_report_keys(monkeypatch):
    """The step and dataflow arms run in both packages; the frontier, AAE
    and flight arms (their own tests' subject) stand in as stubs."""
    import lasp_tpu.telemetry.overhead as jover
    import lasp_tpu_torch.telemetry.overhead as tover

    for mod in (jover, tover):
        monkeypatch.setattr(mod, "_measure_frontier", lambda *a, **k: {
            "round_seconds": 1e-3, "dispatches_per_round": 1})
        monkeypatch.setattr(mod, "_measure_aae", lambda *a, **k: {})
        monkeypatch.setattr(mod, "_measure_flight", lambda *a, **k: {})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jover.measure_overhead(n_replicas=16, step_samples=1, emission_samples=4)
        got = tover.measure_overhead(n_replicas=16, step_samples=1, emission_samples=4,
                                     device="cpu")
    assert set(got) == set(want)
    assert set(got["dataflow"]) == set(want["dataflow"])
    assert got["dataflow"]["sweeps_per_propagate"] == want["dataflow"]["sweeps_per_propagate"]
