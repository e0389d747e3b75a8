"""The port's fused propagate (``dataflow.plan``, ``ops.fused.
fused_dataflow_rounds``, ``Graph.propagate``) against ``lasp_tpu``'s: the
non-telemetry cases of tests/dataflow/test_fusion.py, each also held
against the JAX package on the same script (round counts, values and every
variable's state bit for bit, tolerance zero), the round budget across
block boundaries, and ``dataflow_chain`` at a small shape."""

import warnings

import jax
import numpy as np
import pytest
import torch

import lasp_tpu.dataflow.plan as jplan
from lasp_tpu.bench_scenarios import _build_dataflow_chains as j_chains
from lasp_tpu.bench_scenarios import dataflow_chain as j_dataflow_chain
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.store import Store as JStore
from lasp_tpu_torch import bridge_state
from lasp_tpu_torch.bench_scenarios import _build_dataflow_chains as t_chains
from lasp_tpu_torch.bench_scenarios import dataflow_chain as t_dataflow_chain
from lasp_tpu_torch.dataflow import Graph as TGraph
from lasp_tpu_torch.dataflow import plan as dplan
from lasp_tpu_torch.store import Store as TStore

torch.set_num_threads(1)


def _port_store(**kw):
    return TStore(device="cpu", **kw)


def _leaves(store, v) -> list:
    st = store.state(v)
    if isinstance(st[0], torch.Tensor):
        out = bridge_state.to_numpy(st)
        return [np.array(x) for x in jax.tree_util.tree_leaves(out)]
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(st)]


def _states_equal(a, b) -> bool:
    assert list(a.ids()) == list(b.ids())
    for v in a.ids():
        la, lb = _leaves(a, v), _leaves(b, v)
        if len(la) != len(lb) or not all(
            x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb)
        ):
            return False
    return True


def _mixed_graph(Store, Graph):
    """Every edge kind x every dataflow codec family: parallel OR-SWOT
    bind_to chains, stacked G-Set map chains feeding a union, an OR-Set
    filter feeding a product."""
    store = Store(n_actors=2)
    g = Graph(store)
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


def _port_mixed():
    return _mixed_graph(_port_store, TGraph)


def _drive(store, g, mode) -> list:
    """A write / propagate interleaving touching every chain, with a
    removal mid-stream (vclock dots moving under equal clocks)."""
    rounds = []
    for c in range(2):
        store.update(f"o{c}_0", ("add", f"e{c}"), "w")
    store.update("a", ("add", 1), "w")
    store.update("s", ("add", "z"), "w")
    rounds.append(g.propagate(mode=mode))
    store.update("o0_0", ("remove", "e0"), "w")
    store.update("b", ("add", 2), "w")
    rounds.append(g.propagate(mode=mode))
    store.update("a", ("add", 3), "w")
    rounds.append(g.propagate(mode=mode))
    return rounds


@pytest.mark.parametrize("mode", ["fused", "auto", "per_edge"])
def test_fused_bit_identical_to_per_edge_and_jax(mode):
    js, jg = _mixed_graph(JStore, JGraph)
    j_rounds = _drive(js, jg, "fused")
    ts, tg = _port_mixed()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any fallback is a failure
        t_rounds = _drive(ts, tg, mode)
    assert t_rounds == j_rounds
    assert _states_equal(js, ts)
    assert ts.value("u") == {10, 20, 30}
    assert ts.value("o0_3") == set()  # the removal reached the chain tail
    assert ts.value("o1_3") == {"e1"}
    assert tg.last_propagate["path"] == ("per_edge" if mode == "per_edge" else "fused")


def test_auto_mode_is_fused_and_default():
    store, g = _port_mixed()
    assert g.fusion == "auto"
    store.update("a", ("add", 1), "w")
    g.propagate()  # default mode
    assert g.last_propagate["path"] == "fused"
    assert {k[0] for k in g._cache._entries} == {"fused"}


def test_unknown_mode_rejected():
    store, g = _port_mixed()
    store.update("a", ("add", 1), "w")
    with pytest.raises(ValueError, match="unknown propagate mode"):
        g.propagate(mode="bogus")


# -- compiler internals ----------------------------------------------------------


def _chain_graphs():
    out = []
    for Store, Graph in ((JStore, JGraph), (_port_store, TGraph)):
        store = Store(n_actors=2)
        g = Graph(store)
        a = store.declare(id="a", type="lasp_gset", n_elems=4)
        b = g.map(a, lambda x: x, dst="b", dst_elems=4)
        g.map(b, lambda x: x, dst="c", dst_elems=4)
        x = store.declare(id="x", type="lasp_gset", n_elems=4)
        g.map(x, lambda x: x, dst="y", dst_elems=4)
        out.append(g)
    return out


def test_closure_edges_forward_closure_and_never_ran():
    jg, tg = _chain_graphs()
    for ran, dirty in (([False] * 3, set()), ([True] * 3, {"a"}),
                       ([True] * 3, {"b"}), ([True] * 3, {"x"}),
                       ([True] * 3, set()), ([True, False, True], {"b"})):
        got = dplan.closure_edges(tg.edges, ran, dirty)
        assert got == jplan.closure_edges(jg.edges, ran, dirty)
    assert dplan.closure_edges(tg.edges, [True] * 3, {"a"}) == (0, 1)


def _levels_graph(Store, Graph):
    store = Store(n_actors=2)
    g = Graph(store)
    for i in range(3):
        v = store.declare(id=f"v{i}", type="lasp_gset", n_elems=4)
        m = g.map(v, lambda x: x, dst=f"m{i}", dst_elems=4)
        g.map(m, lambda x: x, dst=f"t{i}", dst_elems=4)
    return store, g


def test_level_groups_match_jax():
    _, jg = _levels_graph(JStore, JGraph)
    _, tg = _levels_graph(_port_store, TGraph)
    idx = tuple(range(6))
    groups = dplan.level_groups(tg.edges, idx)
    assert groups == jplan.level_groups(jg.edges, idx)
    assert sorted(sorted(grp) for grp in groups) == [[0, 2, 4], [1, 3, 5]]
    # the mixed graph: every edge kind, levels and signatures
    _, jm = _mixed_graph(JStore, JGraph)
    _, tm = _port_mixed()
    idx = tuple(range(len(tm.edges)))
    assert dplan.level_groups(tm.edges, idx) == jplan.level_groups(jm.edges, idx)


def test_pre_poisoned_edge_stays_singleton():
    store = _port_store(n_actors=2)
    g = TGraph(store)
    for i in range(2):
        v = store.declare(id=f"v{i}", type="lasp_gset", n_elems=4)
        g.map(v, lambda x: x, dst=f"m{i}", dst_elems=4)
    g.edges[0].stackable = False  # the operator pre-poison hook
    groups = dplan.level_groups(g.edges, (0, 1))
    assert sorted(sorted(grp) for grp in groups) == [[0], [1]]
    store.update("v0", ("add", 1), "w")
    store.update("v1", ("add", 2), "w")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g.propagate(mode="fused")
    assert store.value("m0") == {1} and store.value("m1") == {2}


def test_guard_demotes_unstackable_group_loudly():
    """A group that fails to evaluate stacked is demoted to singletons with
    a RuntimeWarning, and its edges are marked non-stackable."""
    store = _port_store(n_actors=2)
    g = TGraph(store)
    for i in range(2):
        v = store.declare(id=f"v{i}", type="lasp_gset", n_elems=4)
        g.map(v, lambda x: x, dst=f"m{i}", dst_elems=4)
    g.refresh()
    states = {v: store.state(v) for v in store.ids()}
    tables = g.device_tables(store.device)
    groups = dplan.level_groups(g.edges, (0, 1))
    assert any(len(grp) == 2 for grp in groups)

    def broken(tables, src):
        raise ValueError("cannot batch this")

    g.edges[0].contribution = broken
    with pytest.warns(RuntimeWarning, match="cannot stack"):
        out = dplan.guard_groups(g.edges, groups, states, tables)
    assert sorted(sorted(grp) for grp in out) == [[0], [1]]
    assert not g.edges[0].stackable and not g.edges[1].stackable


def test_demoted_group_keeps_values():
    """An edge whose contribution refuses ``torch.func.vmap`` (a
    data-dependent shape) is demoted loudly; the propagate's values and
    rounds stay the per-edge path's."""
    def build():
        store = _port_store(n_actors=2)
        g = TGraph(store)
        for i in range(2):
            v = store.declare(id=f"v{i}", type="lasp_gset", n_elems=4)
            g.map(v, lambda x: x + 1, dst=f"m{i}", dst_elems=4)
        return store, g

    def nonzero_contribution(edge):
        orig = edge.contribution

        def contribution(tables, src):
            out = orig(tables, src)
            _ = src.mask.nonzero()  # data-dependent: vmap refuses it
            return out

        return contribution

    runs = []
    for mode in ("auto", "per_edge"):
        store, g = build()
        for e in g.edges:
            e.contribution = nonzero_contribution(e)
        store.update("v0", ("add", 1), "w")
        store.update("v1", ("add", 2), "w")
        if mode == "auto":
            with pytest.warns(RuntimeWarning, match="cannot stack"):
                r = g.propagate(mode=mode)
            assert not any(e.stackable for e in g.edges)
        else:
            r = g.propagate(mode=mode)
        runs.append((r, store.value("m0"), store.value("m1")))
    assert runs[0] == runs[1] == (1, {2}, {3})


def test_dispatch_failure_falls_back_loudly_then_poisons(monkeypatch):
    store, g = _port_mixed()
    store.update("a", ("add", 1), "w")
    g.propagate(mode="per_edge")  # every edge has run once

    def boom(*_a, **_k):
        raise RuntimeError("trace exploded")

    monkeypatch.setattr(dplan, "compile_fused", boom)
    store.update("a", ("add", 2), "w")
    with pytest.warns(RuntimeWarning, match="fell back to the per-edge"):
        g.propagate(mode="auto")
    assert store.value("m1") == {10, 20}
    # the dirty pattern is poisoned: straight per-edge, no second warning
    store.update("a", ("add", 3), "w")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g.propagate(mode="auto")
    assert store.value("m1") == {10, 20, 30}


def test_strict_fused_mode_raises_instead_of_falling_back(monkeypatch):
    store, g = _port_mixed()
    store.update("a", ("add", 1), "w")

    def boom(*_a, **_k):
        raise RuntimeError("trace exploded")

    monkeypatch.setattr(dplan, "compile_fused", boom)
    with pytest.raises(RuntimeError, match="trace exploded"):
        g.propagate(mode="fused")
    with pytest.raises(RuntimeError, match="refuses the fallback"):
        g.propagate(mode="fused")


# -- the shared cache ----------------------------------------------------------------


def test_propagate_cache_fifo_bound_and_kinds():
    cache = dplan.PropagateCache(capacity=2)
    cache.put(("subset", (0,)), "s0")
    cache.put(("fused", (0, 1), 3), "f0")
    assert len(cache) == 2
    cache.put(("subset", (1,)), "s1")  # evicts the oldest (FIFO)
    assert len(cache) == 2
    assert cache.get(("subset", (0,))) is None
    assert cache.get(("fused", (0, 1), 3)) == "f0"
    assert cache.get(("subset", (1,))) == "s1"
    cache.poison(("fused", (2,)))  # poisoning respects the bound too
    assert len(cache) == 2 and cache.get(("fused", (2,))) is dplan.POISON


def test_fused_and_subset_entries_share_one_cache():
    store, g = _port_mixed()
    store.update("a", ("add", 1), "w")
    g.propagate(mode="fused")
    store.update("a", ("add", 2), "w")
    g.propagate(mode="per_edge")
    assert {k[0] for k in g._cache._entries} == {"fused", "subset"}
    store.update("a", ("add", 3), "w")
    g.propagate(mode="fused")  # builds the {a}-dirty entry
    ent = g._cache.get(("fused", (6, 8)))
    store.update("a", ("add", 4), "w")
    g.propagate(mode="fused")  # same dirty pattern: the same entry
    assert g._cache.get(("fused", (6, 8))) is ent


def test_graph_mutation_invalidates_cache():
    store = _port_store(n_actors=2)
    g = TGraph(store)
    a = store.declare(id="a", type="lasp_gset", n_elems=4)
    g.map(a, lambda x: x, dst="b", dst_elems=4)
    store.update(a, ("add", 1), "w")
    g.propagate(mode="fused")
    assert len(g._cache) >= 1
    cache = g._cache
    g.map("b", lambda x: x, dst="c", dst_elems=4)  # re-means edge indices
    store.update(a, ("add", 2), "w")
    g.propagate(mode="fused")
    assert g._cache is not cache
    assert store.value("c") == {1, 2}


# -- parity corners ------------------------------------------------------------------


def _depth_chain(Store, Graph, depth):
    store = Store(n_actors=2)
    g = Graph(store)
    cur = store.declare(id="a", type="lasp_gset", n_elems=4)
    for d in range(depth):
        cur = g.map(cur, lambda x: x, dst=f"c{d}", dst_elems=4)
    return store, g


@pytest.mark.parametrize("depth", [2, 11])
def test_round_budget_matches_jax_across_blocks(depth):
    """Every budget from too small to enough, on a chain whose sweeps fit
    one block (depth 2) and one that spans two (depth 11, 12 sweeps):
    the same round counts, the same non-convergence raises."""
    for budget in range(1, depth + 3):
        outs = []
        for Store, Graph, mode in ((JStore, JGraph, "fused"),
                                   (_port_store, TGraph, "fused"),
                                   (_port_store, TGraph, "per_edge")):
            store, g = _depth_chain(Store, Graph, depth)
            store.update("a", ("add", 1), "w")
            try:
                outs.append(g.propagate(max_rounds=budget, mode=mode))
            except RuntimeError as exc:
                assert "did not converge" in str(exc)
                outs.append("raised")
            # the budget raise leaves the graph retryable
            outs.append(g.propagate(mode=mode))
            outs.append(store.value(f"c{depth - 1}"))
        assert outs[0:3] == outs[3:6] == outs[6:9], (budget, outs)


def test_non_convergence_raises_in_both_modes():
    for mode in ("fused", "per_edge"):
        store, g = _depth_chain(_port_store, TGraph, 2)
        store.update("a", ("add", 1), "w")
        with pytest.raises(RuntimeError, match="did not converge"):
            g.propagate(max_rounds=1, mode=mode)
        assert g.propagate(mode=mode) >= 1
        assert store.value("c1") == {1}
        if mode == "fused":
            # the budget is an argument, not part of the cache key
            fused_keys = [k for k in g._cache._entries if k[0] == "fused"]
            assert len(fused_keys) == 1, fused_keys


def test_empty_frontier_is_zero_rounds_both_modes():
    for mode in ("fused", "per_edge"):
        store = _port_store(n_actors=2)
        g = TGraph(store)
        a = store.declare(id="a", type="lasp_gset", n_elems=4)
        g.map(a, lambda x: x, dst="b", dst_elems=4)
        store.update(a, ("add", 1), "w")
        g.propagate(mode=mode)
        assert g.propagate(mode=mode) == 0


def test_fused_interner_growth_refreshes_tables():
    store = _port_store(n_actors=2)
    g = TGraph(store)
    a = store.declare(id="a", type="lasp_gset", n_elems=8)
    g.map(a, lambda x: x * 10, dst="b", dst_elems=8)
    store.update(a, ("add", 1), "w")
    g.propagate(mode="fused")
    assert store.value("b") == {10}
    store.update(a, ("add", 2), "w")  # a new term: the table refreshes
    g.propagate(mode="fused")
    assert store.value("b") == {10, 20}


# -- dataflow_chain --------------------------------------------------------------------


def test_dataflow_chain_matches_jax():
    got = t_dataflow_chain(3, 3, reps=1, device="cpu")
    want = j_dataflow_chain(3, 3, reps=1)
    for key in ("scenario", "n_edges", "n_chains", "depth", "rounds"):
        assert got[key] == want[key], key
    assert got["plan"]["groups"] == want["plan"]["groups"]
    assert got["plan"]["edges_stacked"] == want["plan"]["edges_stacked"]
    assert got["timing"]["fused"]["host_syncs"] == 1
    # each arm on JAX's clock (the engine's dataflow_propagate_seconds),
    # the whole call's wall time beside it
    for arm in ("per_edge", "fused"):
        assert {"roundloop_seconds", "propagate_seconds", "seconds_each",
                "rounds"} <= set(got["timing"][arm])
        assert got["impl_block_seconds"][arm] == got["timing"][arm]["roundloop_seconds"]
        assert 0 < got["timing"][arm]["roundloop_seconds"] <= got["timing"][arm]["propagate_seconds"]
    assert got["timing"]["per_edge"]["host_syncs"] == got["timing"]["per_edge"]["sweeps"]
    # the wave's final states, bit for bit, against JAX's fused propagate
    (js, jg), (ts, tg) = j_chains(3, 3), t_chains(3, 3, device="cpu")
    for store in (js, ts):
        store.update("g0_0", ("add", 0), "w")
        store.update("s1_0", ("add", "e1"), "w")
        store.update("o2_0", ("add", "x2"), "w")
    assert tg.propagate(mode="fused") == jg.propagate(mode="fused") == got["rounds"]
    assert _states_equal(js, ts)
