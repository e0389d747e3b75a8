"""The port's own spans and counters (``telemetry.spans.PORT_ONLY``): where
they nest under ``converge_on_device``, ``run_to_convergence(mode="auto")``,
``ingest_cycle`` and ``replica_value``; that each is a user annotation of
a ``torch.profiler`` trace; that ``gossip_rounds_run_total`` less
``gossip_rounds_total`` counts the no-op rounds and
``gossip_frontier_dense_rounds_total`` the frontier rounds that took the
dense arm; that telemetry off records nothing and moves no state, residual
or round; and that the benchmark's readers of the two counters equal the
wrappers they stand beside, on tiny CPU runs of each cell."""

import copy
import time

import numpy as np
import pytest
import torch

import lasp_tpu_torch.telemetry as tel
from lasp_tpu_torch.dataflow import Graph
from lasp_tpu_torch.lattice.base import tree_leaves
from lasp_tpu_torch.mesh import ReplicatedRuntime, random_regular
from lasp_tpu_torch.store import Store
from lasp_tpu_torch.telemetry import registry, spans

torch.set_num_threads(1)

N = 64


@pytest.fixture(autouse=True)
def _fresh():
    tel.reset()
    tel.clear_spans()
    yield
    registry.set_enabled(True)
    tel.clear_spans()
    tel.reset()


def _server(x_idx, threshold=2):
    """The trigger of a miniature ad counter: once the views reach the
    threshold, every replica removes the ads of ``x_idx``."""
    table = torch.ones(4, dtype=torch.int64)
    table[torch.as_tensor(x_idx, dtype=torch.int64)] = 0

    def server(dense):
        over = torch.sum(dense["views"].counts, dtype=torch.int32) >= threshold
        st = dense["a"]
        mask = torch.stack([over, torch.zeros((), dtype=torch.bool)])[table]
        return {"a": st._replace(removed=st.removed | (st.exists & mask[:, None]))}

    return server


def _adcounter(packed=True):
    """Two ad sets unioned, a view counter and the server trigger."""
    store = Store(n_actors=4, device="cpu")
    graph = Graph(store)
    for v in ("a", "b"):
        store.declare(id=v, type="lasp_orset", n_elems=4, n_actors=1,
                      tokens_per_actor=1)
    graph.union("a", "b", dst="u")
    store.declare(id="views", type="riak_dt_gcounter")
    rt = ReplicatedRuntime(store, graph, N, random_regular(N, 3, seed=9),
                           packed=packed, device="cpu")
    rt.ingest_cycle({"a": [(0, ("add_all", ["x", "y"]), "p")],
                     "b": [(1, ("add", "z"), "q")],
                     "views": [(2, ("increment",), "c0"), (3, ("increment",), "c1")]})
    rt.register_trigger(_server(rt.intern_terms("a", ["x"])), touches=("a", "views"))
    return rt


def _store(plan="auto"):
    """Three OR-Set records (one plan group) and a counter (a singleton
    group), no dataflow: the frontier scheduler's population."""
    store = Store(n_actors=4, device="cpu")
    for i in range(3):
        store.declare(id=f"r{i}", type="lasp_orset", n_elems=8, n_actors=4,
                      tokens_per_actor=2)
    store.declare(id="c", type="riak_dt_gcounter", n_actors=4)
    rt = ReplicatedRuntime(store, Graph(store), N, random_regular(N, 3, seed=4),
                           plan=plan, device="cpu")
    rt.ingest_cycle({"r0": [(5, ("add", "x"), "a0")],
                     "r1": [(9, ("add_all", ["y", "z"]), "a1")],
                     "c": [(7, ("increment",), "a2")]})
    return rt


def _paths() -> set:
    return {r["path"] for r in tel.span_events()}


def _counter(name: str) -> float:
    fam = registry.get_registry().snapshot().get(name)
    return sum(s["value"] for s in fam["series"]) if fam else 0.0


def _states(rt) -> dict:
    return {v: [x.clone() for x in tree_leaves(rt.states[v])] for v in rt.var_ids}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        len(a[v]) == len(b[v]) and all(torch.equal(x, y) for x, y in zip(a[v], b[v]))
        for v in a)


# -- where the spans nest --------------------------------------------------------


def _annotations(fn) -> list:
    """``(start, end, name)`` in ns of every user annotation of a CPU
    ``torch.profiler`` trace of ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation())


def _inside(ranges: list, name: str, within: str) -> int:
    """How many ``name`` ranges there are; raises unless each lies inside
    a ``within`` range."""
    outer = [(a, b) for a, b, n in ranges if n == within]
    inner = [(a, b) for a, b, n in ranges if n == name]
    for a, b in inner:
        assert any(lo <= a and b <= hi for lo, hi in outer), (name, within)
    return len(inner)


@pytest.mark.parametrize("packed", [False, True])
def test_converge_step_spans_nest(packed):
    rt = _adcounter(packed)
    assert "mesh.ingest_cycle>gossip.ingest_apply" in _paths()
    tel.clear_spans()
    assert rt.converge_on_device() > 0
    paths = _paths()
    assert {"gossip.converge", "gossip.converge>dataflow.sweep",
            "gossip.converge>gossip.pull"} <= paths
    assert not any(p.endswith("telemetry.emit") for p in paths)
    # the regions of a chunk or a codec call are ranges, never ring records
    assert not {r["name"] for r in tel.span_events()} & spans.RANGES
    tel.clear_spans()
    rt.step()
    assert {"gossip.round>dataflow.sweep", "gossip.round>gossip.pull",
            "telemetry.emit"} <= _paths()


@pytest.mark.parametrize("packed", [False, True])
def test_converge_step_ranges_nest(packed):
    rt = _adcounter(packed)
    ranges = _annotations(rt.converge_on_device)
    assert _inside(ranges, "dataflow.sweep", "gossip.converge") > 0
    assert _inside(ranges, "gossip.pull", "gossip.converge") > 0
    assert _inside(ranges, "dataflow.trigger", "dataflow.sweep") > 0
    n_codec = sum(_inside(ranges, n, "dataflow.sweep")
                  for n in ("packed.pack", "packed.unpack"))
    assert (n_codec > 0) == packed
    # telemetry off: no span and no range reaches the profiler
    registry.set_enabled(False)
    try:
        rt.mark_dirty("a")
        off = {n for _a, _b, n in _annotations(rt.converge_on_device)}
    finally:
        registry.set_enabled(True)
    assert not off & spans.PORT_ONLY


@pytest.mark.parametrize("plan", ["auto", "off"])
def test_frontier_spans_nest(plan):
    rt = _store(plan)
    tel.clear_spans()
    assert rt.run_to_convergence(mode="auto") > 1
    paths = _paths()
    top = "gossip.frontier_converge>gossip.frontier_round"
    inner = top + (">gossip.plan_round" if plan == "auto" else "")
    assert {top, f"{inner}>frontier.reach", f"{inner}>frontier.dispatch",
            f"{inner}>frontier.reseed",
            "gossip.frontier_converge>telemetry.emit"} <= paths
    # the launches ride inside their dispatch span
    assert not any("frontier.reach>" in p or "frontier.reseed>" in p for p in paths)
    tel.clear_spans()
    rt.replica_value("r1", 0)
    assert [r["path"] for r in tel.span_events()] == ["mesh.replica_value"]


def test_every_port_span_is_a_profiler_annotation():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rt = _adcounter(packed=True)
        rt.converge_on_device()
        rt.step()
        st = _store()
        st.run_to_convergence(mode="auto")
        st.replica_value("r0", 3)
    res = prof.profiler.kineto_results
    annotated = {e.name() for e in res.events() if e.is_user_annotation()}
    port_spans = {n for n in spans.PORT_ONLY if "." in n}
    assert port_spans <= annotated
    assert {"gossip.converge", "gossip.frontier_round", "gossip.plan_round"} <= annotated


# -- the counters ------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["converge", "fused", "step", "read_until"])
def test_rounds_run_less_exact_rounds_are_the_noop_rounds(entry):
    rt = _adcounter()
    inner, calls = rt._dense_round, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    rt._dense_round = counted
    run0, exact0 = _counter("gossip_rounds_run_total"), _counter("gossip_rounds_total")
    if entry == "converge":
        exact = rt.converge_on_device()
    elif entry == "fused":
        exact = rt.run_to_convergence(block=3)
    elif entry == "step":
        exact = rt.run_to_convergence()
    else:
        rt.read_until(N - 1, "views", 2)
        exact = _counter("gossip_rounds_total") - exact0
    run = _counter("gossip_rounds_run_total") - run0
    assert run == calls[0] > 0
    noop = calls[0] - exact
    if entry == "fused":
        # a fused block records every round it ran: no round is past the count
        assert _counter("gossip_rounds_total") - exact0 == run
    else:
        assert run - (_counter("gossip_rounds_total") - exact0) == noop
    if entry == "converge":
        assert 0 < noop < 8


@pytest.mark.parametrize("window,budget", [(1, 10_000), (4, 10_000), (4, 2)])
def test_partitioned_loop_counts_the_rounds_it_ran(window, budget, monkeypatch):
    from lasp_tpu_torch.mesh import shard_gossip
    from lasp_tpu_torch.mesh.comm import Mesh

    inner, calls = shard_gossip._grouped_exchange_local, [0]

    def counted_local(*args, **kwargs):
        local = inner(*args, **kwargs)

        def one_round(*a, **k):
            calls[0] += 1
            return local(*a, **k)

        return one_round

    # one variable, one group: each call of its round body is one round run
    monkeypatch.setattr(shard_gossip, "_grouped_exchange_local", counted_local)
    store = Store(n_actors=8, device="cpu")
    store.declare(id="v", type="riak_dt_orswot", n_elems=8, n_actors=4)
    rt = ReplicatedRuntime(store, Graph(store), 96, random_regular(96, 3, seed=3),
                           device="cpu")
    rt.update_at(1, "v", ("add", "a"), "w")
    rt.update_at(48, "v", ("add", "b"), "x")
    rt.shard(Mesh([torch.device("cpu")] * 8, ("replicas",)), axis="replicas",
             partition=True, partition_mode="alltoall")
    run0, exact0 = _counter("gossip_rounds_run_total"), _counter("gossip_rounds_total")
    signed = rt.converge_on_device(max_rounds=budget, strict=False, sync_every=window)
    assert _counter("gossip_rounds_total") - exact0 == abs(signed)
    assert _counter("gossip_rounds_run_total") - run0 == calls[0] >= abs(signed)
    assert calls[0] - abs(signed) < window
    assert (signed > 0) == (budget > 2)


def test_frontier_dense_rounds_are_the_rounds_past_the_crossover():
    rt = _store()
    rt.mark_dirty("r0")  # every row: r0's next round takes the dense arm
    inner, falls = rt.frontier_step, []

    def counted(*args, **kwargs):
        out = inner(*args, **kwargs)
        falls.append(rt.frontier_dense_falls_last)
        return out

    rt.frontier_step = counted
    run0 = _counter("gossip_rounds_run_total")
    rounds = rt.run_to_convergence(mode="auto")
    assert _counter("gossip_frontier_rounds_total") == len(falls) == rounds
    dense = sum(f > 0 for f in falls)
    assert 0 < dense < rounds
    assert _counter("gossip_frontier_dense_rounds_total") == dense
    # a frontier round is never past the fixed point
    assert _counter("gossip_rounds_run_total") - run0 == rounds


def test_ingest_cycle_counts_every_op_it_takes():
    rt = _store(plan="off")
    before = _counter("ingest_cycle_ops_total")
    rep = rt.ingest_cycle({"r2": [(1, ("add", "p"), "a0"), (2, ("add", "q"), "a1")],
                           "c": [(3, ("increment",), "a3")]})
    assert _counter("ingest_cycle_ops_total") - before == rep["ops"] == 3


# -- telemetry off ---------------------------------------------------------------


def _drive(rt_adc, rt_store) -> tuple:
    rounds = [rt_adc.converge_on_device()]
    rt_store.mark_dirty("r0")
    rounds.append(rt_store.run_to_convergence(mode="auto"))
    rt_store.ingest_cycle({"r1": [(11, ("add", "w"), "a2")]})
    rounds.append(rt_store.run_to_convergence(mode="auto"))
    return rounds, list(rt_adc.round_residuals), list(rt_store.round_residuals)


def test_telemetry_off_records_nothing_and_moves_nothing():
    on = (_adcounter(), _store())
    out_on = _drive(*on)
    registry.set_enabled(False)
    try:
        off = (_adcounter(), _store())
        tel.reset()
        tel.clear_spans()
        out_off = _drive(*off)
        assert tel.span_events() == []
        assert registry.get_registry().snapshot() == {}
    finally:
        registry.set_enabled(True)
    assert out_off == out_on
    for a, b in zip(on, off):
        assert _same(_states(a), _states(b))
        for v in a.var_ids:
            assert np.array_equal(a._frontier[v], b._frontier[v])


# -- the benchmark's readers against their wrapper twins ------------------------

#: the tiny sizes of a CPU run of each configuration and mix
TINY = {"adcounter-converge": ({"n_replicas": 4096}, {}),
        "kvs-zipf-burst": ({"n_replicas": 2000, "recordcount": 20},
                           {"operationcount": 200})}
TWINS = {"adcounter-converge": ("noop_rounds_counted.adcounter",
                                "noop_round_share.adcounter"),
         "kvs-zipf-burst": ("sparse_rounds_counted.burst", "sparse_round_share.burst")}


@pytest.mark.parametrize("workload", sorted(TINY))
def test_counter_readers_equal_their_wrappers(workload):
    from benchmark.harness import layout
    from benchmark.harness.session import run_cell

    spec = layout.load_spec()
    cell = layout.find_cell(spec, workload)
    config = copy.deepcopy(layout.config_of(spec, cell))
    mix = copy.deepcopy(layout.traffic_of(cell))
    config.update(TINY[workload][0])
    mix.update(TINY[workload][1])
    result, _info = run_cell(spec, cell, 2**31 + 11, 0.5, True, torch.device("cpu"),
                             time.perf_counter(), config=config, mix=mix)
    assert result["correct"] is True
    counted, wrapped = TWINS[workload]
    got = result["metrics"]
    assert got[counted]["value"] == got[wrapped]["value"]
    # the span readers find their spans on the CPU too
    names = {m["name"] for m in layout.per_layer_of(spec, cell)}
    host = {n for n in names if n.split(".")[0] in (
        "frontier_host_ms", "frontier_reach_ms", "ingest_span_ms_per_kop",
        "read_span_ms_per_kop")}
    assert host <= set(got)
    assert all(got[n]["value"] > 0 for n in host)


#: the readers of the port's own names, by module
READERS = ("noop_rounds_counted", "repack_span_share", "sweep_share",
           "sparse_rounds_counted", "frontier_host_ms", "frontier_reach_ms",
           "ingest_span_ms_per_kop", "read_span_ms_per_kop")


@pytest.mark.parametrize("reader", READERS)
def test_reader_installs_only_where_the_program_names_it(reader, monkeypatch):
    import importlib

    from benchmark.harness.session import Context

    mod = importlib.import_module(f"benchmark.metrics.{reader}")
    ctx = Context(None, None, "cpu")
    mod.install(ctx)
    assert reader in ctx.own
    # a program from before the port named any span or counter of its own
    # leaves the metric out of the line
    with monkeypatch.context() as m:
        m.delattr(spans, "PORT_ONLY")
        ctx = Context(None, None, "cpu")
        mod.install(ctx)
        assert ctx.own == {} and mod.read(ctx) is None
    # one that names its own but not this reader's fails the run
    with monkeypatch.context() as m:
        m.setattr(spans, "PORT_ONLY", frozenset({"gossip_rounds_run_total"})
                  if reader != "noop_rounds_counted" else frozenset({"packed.pack"}))
        with pytest.raises(RuntimeError, match="emits no"):
            mod.install(Context(None, None, "cpu"))
    registry.set_enabled(False)
    with pytest.raises(RuntimeError, match="telemetry is off"):
        mod.install(Context(None, None, "cpu"))
