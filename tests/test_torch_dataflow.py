"""The port's dataflow graph and the store's bind / watch layer against
``lasp_tpu``'s: every combinator test of tests/dataflow/test_combinators.py
runs as one script through both packages on the same ops, and the values
each step observes (decoded values, ``propagate`` round counts, watch
firings) and the final states of every variable must agree exactly
(tolerance zero: every value is a bit or an integer)."""

import types

import numpy as np
import pytest
import torch

import lasp_tpu.dataflow as jdf
import lasp_tpu.dataflow.plan as jplan
import lasp_tpu.lattice as jl
import lasp_tpu.store as jstore
import lasp_tpu_torch.dataflow as tdf
import lasp_tpu_torch.dataflow.plan as tplan
import lasp_tpu_torch.lattice as tl
import lasp_tpu_torch.store as tstore
from lasp_tpu_torch import bridge_state

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)

JAX = types.SimpleNamespace(
    name="jax", Graph=jdf.Graph, Threshold=jl.Threshold,
    store=lambda **kw: jstore.Store(**kw),
    bottom=lambda var: var.codec.new(var.spec),
)
PORT = types.SimpleNamespace(
    name="torch", Graph=tdf.Graph, Threshold=tl.Threshold,
    store=lambda **kw: tstore.Store(device="cpu", **kw),
    bottom=lambda var: var.codec.new(var.spec, device="cpu"),
)

SET_TYPES = ["lasp_gset", "lasp_orset"]


def _make(ns):
    store = ns.store(n_actors=4)
    return store, ns.Graph(store)


def _states(store) -> dict:
    out = {}
    for v in store.ids():
        st = store.state(v)
        out[v] = (bridge_state.to_numpy(st) if isinstance(st[0], torch.Tensor)
                  else tuple(np.asarray(x) for x in st))
    return out


def _twin(script, *args):
    """Run ``script(ns, *args) -> (store, observations)`` through both
    packages; observations and every variable's final state must agree."""
    j_store, j_obs = script(JAX, *args)
    t_store, t_obs = script(PORT, *args)
    assert t_obs == j_obs
    j_states, t_states = _states(j_store), _states(t_store)
    assert list(t_states) == list(j_states)
    for v, leaves in j_states.items():
        for a, b in zip(t_states[v], leaves):
            assert a.dtype == b.dtype and np.array_equal(a, b), v
    return t_obs


# -- the scripts of tests/dataflow/test_combinators.py --------------------------


def map_incremental(ns, type_name):
    store, graph = _make(ns)
    s1 = store.declare(type=type_name, n_elems=8)
    store.update(s1, ("add_all", [1, 2, 3]), "a")
    s2 = graph.map(s1, lambda x: x * 2)
    obs = [graph.propagate(), store.value(s2)]
    store.update(s1, ("add_all", [4, 5, 6]), "a")
    obs += [graph.propagate(), store.value(s1), store.value(s2)]
    assert obs[-1] == frozenset({2, 4, 6, 8, 10, 12})
    return store, obs


def fold_flatmap(ns, type_name):
    store, graph = _make(ns)
    s1 = store.declare(type=type_name, n_elems=8)
    store.update(s1, ("add_all", [1, 2, 3]), "a")
    s2 = graph.fold(s1, lambda x: [x, x + 10])
    obs = [graph.propagate(), store.value(s2)]
    store.update(s1, ("add", 4), "a")
    obs += [graph.propagate(), store.value(s2)]
    assert obs[-1] == frozenset({1, 2, 3, 4, 11, 12, 13, 14})
    return store, obs


def filter_even(ns, type_name):
    store, graph = _make(ns)
    s1 = store.declare(type=type_name, n_elems=8)
    store.update(s1, ("add_all", [1, 2, 3, 4, 5, 6]), "a")
    s2 = graph.filter(s1, lambda x: x % 2 == 0)
    obs = [graph.propagate(), store.value(s2)]
    assert obs[-1] == frozenset({2, 4, 6})
    return store, obs


def union(ns, type_name):
    store, graph = _make(ns)
    s1 = store.declare(type=type_name, n_elems=8)
    s2 = store.declare(type=type_name, n_elems=8)
    store.update(s1, ("add_all", [1, 2, 3]), "a")
    store.update(s2, ("add_all", ["a", "b", "c"]), "a")
    s3 = graph.union(s1, s2)
    obs = [graph.propagate(), store.value(s3)]
    assert obs[-1] == frozenset({1, 2, 3, "a", "b", "c"})
    return store, obs


def intersection(ns, type_name):
    store, graph = _make(ns)
    s1 = store.declare(type=type_name, n_elems=8)
    s2 = store.declare(type=type_name, n_elems=8)
    store.update(s1, ("add_all", [1, 2, 3]), "a")
    store.update(s2, ("add_all", [3, 4, 5]), "a")
    s3 = graph.intersection(s1, s2)
    obs = [graph.propagate(), store.value(s3)]
    store.update(s2, ("add", 1), "a")
    obs += [graph.propagate(), store.value(s3)]
    assert obs[-1] == frozenset({1, 3})
    return store, obs


def product(ns, type_name):
    store, graph = _make(ns)
    s1 = store.declare(type=type_name, n_elems=4)
    s2 = store.declare(type=type_name, n_elems=4)
    store.update(s1, ("add_all", [1, 2]), "a")
    store.update(s2, ("add_all", ["x", "y"]), "a")
    s3 = graph.product(s1, s2)
    obs = [graph.propagate(), store.value(s3)]
    assert obs[-1] == frozenset({(1, "x"), (1, "y"), (2, "x"), (2, "y")})
    return store, obs


def bind_to(ns, type_name):
    store, graph = _make(ns)
    s1 = store.declare(type=type_name, n_elems=8)
    store.update(s1, ("add_all", [1, 2]), "a")
    s2 = graph.bind_to(None, s1)
    obs = [graph.propagate(), store.value(s2)]
    store.update(s1, ("add", 3), "a")
    obs += [graph.propagate(), store.value(s2)]
    assert obs[-1] == frozenset({1, 2, 3})
    return store, obs


def map_remove_propagates(ns):
    store, graph = _make(ns)
    s1 = store.declare(type="lasp_orset", n_elems=8)
    store.update(s1, ("add_all", [1, 2, 3]), "a")
    s2 = graph.map(s1, lambda x: x * 2)
    obs = [graph.propagate(), store.value(s2)]
    store.update(s1, ("remove", 2), "a")
    obs += [graph.propagate(), store.value(s1), store.value(s2)]
    assert obs[-1] == frozenset({2, 6})
    return store, obs


def map_collision_keeps_tokens_separate(ns):
    store, graph = _make(ns)
    s1 = store.declare(type="lasp_orset", n_elems=8)
    store.update(s1, ("add_all", [2, 3]), "a")
    s2 = graph.map(s1, lambda x: x // 2)  # both -> 1
    obs = [graph.propagate(), store.value(s2)]
    store.update(s1, ("remove", 2), "a")
    obs += [graph.propagate(), store.value(s2)]
    store.update(s1, ("remove", 3), "a")
    obs += [graph.propagate(), store.value(s2)]
    assert obs[3] == frozenset({1}) and obs[-1] == frozenset()
    return store, obs


def filter_remove_propagates(ns):
    store, graph = _make(ns)
    s1 = store.declare(type="lasp_orset", n_elems=8)
    store.update(s1, ("add_all", [1, 2, 3, 4]), "a")
    s2 = graph.filter(s1, lambda x: x % 2 == 0)
    obs = [graph.propagate(), store.value(s2)]
    store.update(s1, ("remove", 2), "a")
    obs += [graph.propagate(), store.value(s2)]
    assert obs[-1] == frozenset({4})
    return store, obs


def union_left_bias(ns):
    store, graph = _make(ns)
    s1 = store.declare(type="lasp_orset", n_elems=8)
    s2 = store.declare(type="lasp_orset", n_elems=8)
    store.update(s1, ("add", "x"), "a")
    store.update(s1, ("remove", "x"), "a")  # member but dead in the left
    store.update(s2, ("add", "x"), "b")  # live in the right
    s3 = graph.union(s1, s2)
    obs = [graph.propagate(), store.value(s3)]
    assert obs[-1] == frozenset()
    return store, obs


def intersection_causal_union(ns):
    store, graph = _make(ns)
    s1 = store.declare(type="lasp_orset", n_elems=8)
    s2 = store.declare(type="lasp_orset", n_elems=8)
    store.update(s1, ("add", "x"), "a")
    store.update(s1, ("remove", "x"), "a")
    store.update(s2, ("add", "x"), "b")
    s3 = graph.intersection(s1, s2)
    obs = [graph.propagate(), store.value(s3)]
    assert obs[-1] == frozenset({"x"})
    return store, obs


def product_remove_propagates(ns):
    store, graph = _make(ns)
    s1 = store.declare(type="lasp_orset", n_elems=4)
    s2 = store.declare(type="lasp_orset", n_elems=4)
    store.update(s1, ("add_all", [1, 2]), "a")
    store.update(s2, ("add_all", ["x", "y"]), "a")
    s3 = graph.product(s1, s2)
    obs = [graph.propagate()]
    store.update(s1, ("remove", 1), "a")
    obs += [graph.propagate(), store.value(s3)]
    assert obs[-1] == frozenset({(2, "x"), (2, "y")})
    return store, obs


def pipeline_union_product_filter(ns):
    store, graph = _make(ns)
    ads_a = store.declare(type="lasp_orset", n_elems=4)
    ads_b = store.declare(type="lasp_orset", n_elems=4)
    clients = store.declare(type="lasp_orset", n_elems=4)
    store.update(ads_a, ("add_all", ["a1", "a2"]), "pub_a")
    store.update(ads_b, ("add", "b1"), "pub_b")
    store.update(clients, ("add_all", ["c1", "c2"]), "srv")
    ads = graph.union(ads_a, ads_b)
    pairs = graph.product(ads, clients)
    only_c1 = graph.filter(pairs, lambda xy: xy[1] == "c1")
    obs = [graph.propagate(), store.value(only_c1)]
    store.update(ads_a, ("remove", "a1"), "pub_a")
    obs += [graph.propagate(), store.value(only_c1), graph.lineage(only_c1)]
    assert obs[0] <= 4 and obs[-2] == frozenset({("a2", "c1"), ("b1", "c1")})
    return store, obs


def propagate_wakes_threshold_watch(ns):
    store, graph = _make(ns)
    s1 = store.declare(type="lasp_orset", n_elems=8)
    s2 = graph.map(s1, lambda x: x + 1)
    store.update(s1, ("add", 1), "a")
    obs = [graph.propagate()]
    # watch for any strict growth of the (already non-empty) output
    watch = store.read(s2, ns.Threshold(store.state(s2), strict=True))
    obs.append(watch.done)
    store.update(s1, ("add", 2), "a")
    obs.append(watch.done)  # nothing propagated yet
    obs += [graph.propagate(), watch.done, watch.result[:2]]
    assert obs[1:3] == [False, False] and obs[4]
    return store, obs


def ivar_bind_to(ns):
    store, graph = _make(ns)
    a = store.declare(type="lasp_ivar")
    b = graph.bind_to(None, a)
    store.update(a, ("set", "hello"), "actor")
    obs = [graph.propagate(), store.value(b)]
    assert obs[-1] == "hello"
    return store, obs


def union_diamond_frozen_copy(ns):
    store = ns.store(n_actors=4)
    src = store.declare(id="s", type="lasp_orset", n_elems=8, tokens_per_actor=8)
    graph = ns.Graph(store)
    d0 = graph.union(src, src, dst="d0")  # derived mirror of src
    d1 = graph.union(d0, src, dst="d1")  # diamond: src via both
    store.update(src, ("add", "x"), "w")
    obs = [graph.propagate(), store.value(d1)]
    store.update(src, ("remove", "x"), "w")
    obs += [graph.propagate(), store.value(src), store.value(d0), store.value(d1)]
    # the frozen right-path copy survives (the documented reference delta)
    assert obs[-3:] == [frozenset(), frozenset(), frozenset({"x"})]
    return store, obs


@pytest.mark.parametrize("type_name", SET_TYPES)
@pytest.mark.parametrize("script", [
    map_incremental, fold_flatmap, filter_even, union, intersection, product,
    bind_to,
], ids=lambda f: getattr(f, "__name__", None))
def test_combinator_matches_jax(script, type_name):
    _twin(script, type_name)


@pytest.mark.parametrize("script", [
    map_remove_propagates, map_collision_keeps_tokens_separate,
    filter_remove_propagates, union_left_bias, intersection_causal_union,
    product_remove_propagates, pipeline_union_product_filter,
    propagate_wakes_threshold_watch, ivar_bind_to, union_diamond_frozen_copy,
], ids=lambda f: f.__name__)
def test_causality_matches_jax(script):
    _twin(script)


# -- the bind / watch layer ------------------------------------------------------


def watches(ns):
    """read / read_any / wait_needed on a G-Counter and an OR-Set: which
    watch fires at which write, and what it carries."""
    store = ns.store(n_actors=4)
    c = store.declare(id="c", type="riak_dt_gcounter")
    s = store.declare(id="s", type="lasp_orset", n_elems=4)
    t = store.declare(id="t", type="lasp_orset", n_elems=4)
    fired = []
    lazy_c = store.wait_needed(c, ns.Threshold(3, strict=False))
    lazy_s = store.wait_needed(s)
    obs = [lazy_c.done, lazy_s.done]
    r3 = store.read(c, 3)  # covers lazy_c's threshold
    r_any = store.read_any([(c, ns.Threshold(5, strict=True)), (s, None)])
    obs += [lazy_c.done, lazy_s.done, r3.done, r_any.done, r_any.result[0]]
    r_strict = store.read(t, ns.Threshold(None, strict=True))
    r_any2 = store.read_any([(c, 5), (t, ns.Threshold(None, strict=True))])
    r_strict.callback = fired.append
    obs += [r_strict.done, r_any2.done]
    store.update(c, ("increment", 2), "a")
    obs += [r3.done, r_any2.done]
    store.update(c, ("increment",), "a")
    obs += [r3.done, r3.result[0], r_any2.done]
    store.update(t, ("add", "e"), "a")
    obs += [r_strict.done, r_any2.done, r_any2.result[0], len(fired)]
    store.update(c, ("increment", 2), "b")
    obs += [r_any2.result[0], store.value(c), store.variable(c).waiting,
            store.variable(t).waiting]
    # a wait_needed with a reader already parked fires at once
    r_wait = store.read(s, ns.Threshold(None, strict=True))
    obs += [r_wait.done, store.wait_needed(s).done]
    return store, obs


def test_watches_match_jax():
    obs = _twin(watches)
    assert obs[:2] == [False, False] and obs[2] and obs[3]


def bind_gate(ns):
    """bind merges and gates: a second value bound to a defined IVar joins
    to a non-inflation and is ignored (no write, no dirty mark); a stale
    state is merged in (a join, never a rollback); bind_raw overwrites."""
    store = ns.store(n_actors=4)
    iv = store.declare(id="iv", type="lasp_ivar")
    c = store.declare(id="c", type="riak_dt_gcounter")
    s = store.declare(id="s", type="lasp_orset", n_elems=4)
    store.update(iv, ("set", "first"), "a")
    var = store.variable(iv)
    m0 = store.mutations
    store.bind(iv, var.codec.set(var.spec, ns.bottom(var), 7))
    obs = [store.value(iv), store.mutations - m0, sorted(store.dirty_since(m0))]
    store.update(c, ("increment", 3), "a")
    old = store.state(c)
    store.update(c, ("increment", 2), "b")
    store.update(s, ("add", "x"), "a")
    before = store.state(s)
    store.update(s, ("remove", "x"), "a")
    m1 = store.mutations
    store.bind(c, old)
    store.bind(s, before)  # the join keeps the tombstone
    obs += [store.value(c), store.value(s), store.mutations - m1]
    store.bind_raw(c, old)
    obs += [store.value(c), sorted(store.dirty_since(m1))]
    return store, obs


def test_bind_ignores_non_inflation_matches_jax():
    obs = _twin(bind_gate)
    assert obs[:3] == ["first", 0, []]
    assert obs[3:5] == [5, frozenset()] and obs[6] == 3


def test_ingest_merges_matches_jax():
    def script(ns):
        store = ns.store(n_actors=4)
        c = store.declare(id="c", type="riak_dt_gcounter")
        store.update(c, ("increment", 4), "a")
        low = store.state(c)
        store.update(c, ("increment", 1), "b")
        writes = store.ingest({c: low})  # a stale batch never rolls back
        return store, [writes, store.value(c)]

    assert _twin(script) == [0, 5]


@pytest.mark.parametrize("ns", [JAX, PORT], ids=lambda ns: ns.name)
def test_redeclare_derived_refuses_written_and_watched(ns):
    store, graph = _make(ns)
    src = store.declare(id="src", type="lasp_orset", n_elems=4)
    out = store.declare(id="out", type="lasp_orset", n_elems=4)
    store.update(out, ("add", "x"), "a")
    with pytest.raises(RuntimeError, match="already written"):
        graph.map(src, lambda x: x, dst="out")
    watched = store.declare(id="w", type="lasp_orset", n_elems=4)
    store.read(watched, ns.Threshold(None, strict=True))
    with pytest.raises(RuntimeError, match="watchers attached"):
        graph.map(src, lambda x: x, dst="w")
    # a bottom output with default capacities takes the derived layout
    fresh = store.declare(id="fresh", type="lasp_orset", n_elems=4)
    m0 = store.mutations
    graph.map(src, lambda x: x, dst="fresh")
    assert store.variable(fresh).spec.token_space == 4 * store.variable(src).spec.n_tokens
    assert store.mutations == m0 + 1 and store.dirty_since(m0) == {"fresh"}


def test_closure_edges_matches_jax():
    """The dirty closure over a diamond with a dangling branch, from every
    dirty set, with and without never-ran edges."""
    def edges(ns):
        store, graph = _make(ns)
        ids = [store.declare(id=f"s{i}", type="lasp_gset", n_elems=4) for i in range(3)]
        u = graph.union(ids[0], ids[1], dst="u")
        graph.map(u, lambda x: x, dst="m")
        graph.intersection(u, ids[2], dst="i")
        graph.union("m", "i", dst="top")
        return graph.edges

    j_edges, t_edges = edges(JAX), edges(PORT)
    for ran in ([True] * 4, [True, False, True, True], [False] * 4):
        for dirty in ({"s0"}, {"s2"}, {"u"}, {"m", "i"}, set()):
            want = jplan.closure_edges(j_edges, ran, dirty)
            assert tplan.closure_edges(t_edges, ran, dirty) == want


def test_propagate_modes():
    store, graph = _make(PORT)
    s1 = store.declare(type="lasp_gset", n_elems=4)
    graph.map(s1, lambda x: x)
    store.update(s1, ("add", 1), "a")
    with pytest.raises(ValueError, match="unknown propagate mode"):
        graph.propagate(mode="sideways")
    assert graph.propagate(mode="per_edge") == 1
    store.update(s1, ("add", 2), "a")
    assert graph.propagate(mode="auto") == 1
    assert graph.propagate(mode="auto") == 0  # clean: nothing written since
