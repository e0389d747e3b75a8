"""Tombstone compaction on the port against ``lasp_tpu``: the store's and
the runtime's ``compact_orset`` (dense and packed) and ``compact_map_field``
(tests/mesh/test_fused_steps.py and tests/apps/test_kvs_replica.py), and
``compaction_window`` (tests/mesh/test_compaction_window.py). Each scenario
runs once through each package with the JAX test's own assertions, and the
two records of what it observed (slots reclaimed, interner order, states
bit for bit, round counts, exceptions) must be equal."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasp_tpu.mesh as jmesh
import lasp_tpu.store as jstore
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.store as tstore
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.lattice import Threshold as JThreshold
from lasp_tpu.mesh import ring
from lasp_tpu_torch import bridge_state
from lasp_tpu_torch.dataflow import Graph as TGraph
from lasp_tpu_torch.lattice import Threshold as TThreshold
from lasp_tpu_torch.lattice.base import tree_map

torch.set_num_threads(1)


def _pkg(port: bool):
    if port:
        return types.SimpleNamespace(
            port=True, Threshold=TThreshold,
            Store=lambda **kw: tstore.Store(device="cpu", **kw),
            RT=lambda *a, **kw: tmesh.ReplicatedRuntime(*a, device="cpu", **kw),
            Graph=TGraph,
            flat=lambda s: _np_leaves(bridge_state.to_numpy(s)),
            row0=lambda rt, v: tree_map(
                lambda x: x[0], rt._to_dense_row(v, rt.states[v])),
        )
    return types.SimpleNamespace(
        port=False, Threshold=JThreshold, Store=jstore.Store, RT=jmesh.ReplicatedRuntime,
        Graph=JGraph,
        flat=lambda s: [np.asarray(x) for x in jax.tree_util.tree_leaves(s)],
        row0=lambda rt, v: jax.tree_util.tree_map(
            lambda x: x[0], rt._to_dense_states(v)),
    )


def _np_leaves(tree) -> list:
    """numpy leaves of a converted state, depth first, None skipped."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _np_leaves(part)]
    return [tree.copy()]


def _twin(scenario):
    records = []
    for port in (False, True):
        p = _pkg(port)
        obs = []
        scenario(p, obs)
        records.append(obs)
    jrec, trec = records
    assert len(jrec) == len(trec)
    for i, (x, y) in enumerate(zip(jrec, trec)):
        if isinstance(x, list):  # leaves
            assert len(x) == len(y), i
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and np.array_equal(u, v), i
        else:
            assert x == y, (i, x, y)
    return trec


def _raises(obs, exc, fn, *args, match=None):
    with pytest.raises(exc, match=match) as info:
        fn(*args)
    obs.append((type(info.value).__name__, str(info.value)))


@pytest.mark.parametrize("packed", [False, True])
def test_runtime_compact_orset_reclaims_after_convergence(packed):
    def scn(p, obs):
        store = p.Store(n_actors=2)
        store.declare(id="s", type="lasp_orset", n_elems=4, n_actors=2,
                      tokens_per_actor=2)
        rt = p.RT(store, p.Graph(store), 8, ring(8, 2), packed=packed)
        rt.update_batch("s", [(0, ("add", f"e{i}"), "w") for i in range(4)])
        obs.append(rt.run_to_convergence())
        rt.update_batch("s", [(0, ("remove_all", ["e0", "e1", "e2"]), "w")])
        _raises(obs, RuntimeError, rt.compact_orset, "s", match="not converged")
        obs.append(rt.run_to_convergence())
        assert rt.compact_orset("s") == 3
        obs.append(tuple(store.variable("s").elems.terms()))
        obs.append(p.flat(rt.states["s"]))
        obs.append(p.flat(store.state("s")))
        assert rt.coverage_value("s") == {"e3"}
        assert rt.divergence("s") == 0
        rt.update_batch("s", [(2, ("add_all", ["f1", "f2", "f3"]), "w")])
        obs.append(rt.run_to_convergence())
        assert rt.coverage_value("s") == {"e3", "f1", "f2", "f3"}
        obs.append(p.flat(rt.states["s"]))

    _twin(scn)


def test_store_compact_orset_single_replica():
    def scn(p, obs):
        store = p.Store(n_actors=2)
        store.declare(id="s", type="lasp_orset", n_elems=3)
        for e in ("a", "b", "c"):
            store.update("s", ("add", e), "w")
        store.update("s", ("remove_all", ["a", "b"]), "w")
        assert store.compact_orset("s") == 2
        obs.append(p.flat(store.state("s")))
        assert store.value("s") == {"c"}
        store.update("s", ("add", "d"), "w")
        store.update("s", ("add", "e"), "w")
        assert store.value("s") == {"c", "d", "e"}
        obs.append(p.flat(store.state("s")))
        # non-OR-Set types have no tombstones; parked watches refuse
        store.declare(id="g", type="lasp_gset", n_elems=2)
        _raises(obs, TypeError, store.compact_orset, "g")
        store.read("s", p.Threshold(store.state("s"), strict=True))  # parks
        _raises(obs, RuntimeError, store.compact_orset, "s", match="watches")

    _twin(scn)


def test_compact_refuses_trigger_touched_variable():
    def scn(p, obs):
        store = p.Store(n_actors=2)
        store.declare(id="s", type="lasp_orset", n_elems=4)
        rt = p.RT(store, p.Graph(store), 4, ring(4, 1))
        rt.update_batch("s", [(0, ("add", "e"), "w")])
        rt.register_trigger(lambda dense: {}, touches=["s"])
        obs.append(rt.run_to_convergence(block=4))
        _raises(obs, RuntimeError, rt.compact_orset, "s", match="trigger")

    _twin(scn)


def test_compact_map_field_store_and_runtime():
    """A map's OR-Set field compacts in the store and across the
    population (the runtime's gates: divergence 0, no trigger)."""
    key = ("X", "lasp_orset")

    def scn(p, obs):
        store = p.Store(n_actors=4)
        m = store.declare(id="kvs", type="riak_dt_map",
                          fields=[(key, "lasp_orset", {"n_elems": 4,
                                                       "tokens_per_actor": 2})],
                          reset_on_readd=True)
        rt = p.RT(store, p.Graph(store), 6, ring(6, 2))
        for cycle in range(2):
            rt.update_at(cycle, m, ("update", [("update", key, ("add", f"v{cycle}"))]),
                         f"w{cycle}")
            obs.append(rt.run_to_convergence(max_rounds=32))
            rt.update_at(3, m, ("update", [("remove", key)]), "w3")
            obs.append(rt.run_to_convergence(max_rounds=32))
        rt.update_at(4, m, ("update", [("update", key, ("add", "live"))]), "w3")
        _raises(obs, RuntimeError, rt.compact_map_field, m, key, match="not converged")
        obs.append(rt.run_to_convergence(max_rounds=32))
        rt.register_trigger(builder=lambda: (lambda dense: {}), touches=[m])
        _raises(obs, RuntimeError, rt.compact_map_field, m, key, match="trigger")
        with rt.compaction_window() as w:
            obs.append(w.compact_map_field(m, key))
        obs.append(p.flat(rt.states[m]))
        obs.append(tuple(store.variable(m).map_aux[0].elems.terms()))
        assert rt.coverage_value(m) == {key: frozenset({"live"})}
        rt.update_at(5, m, ("update", [("update", key, ("add", "after"))]), "w5")
        obs.append(rt.run_to_convergence(max_rounds=32))
        assert rt.coverage_value(m) == {key: frozenset({"live", "after"})}
        obs.append(p.flat(rt.states[m]))
        _raises(obs, KeyError, store.compact_map_field, "kvs", ("C", "no_field"))

    _twin(scn)


# -- compaction_window (tests/mesh/test_compaction_window.py) ----------------


def _waste_pct(p, rt, var_id) -> int:
    var = rt.store.variable(var_id)
    return var.codec.stats(var.spec, p.row0(rt, var_id))["waste_pct"]


def _sentinel_rt(p, n=8):
    store = p.Store(n_actors=4)
    s = store.declare(id="s", type="lasp_orset", n_elems=32)
    flag = store.declare(id="flag", type="lasp_gset", n_elems=2)
    rt = p.RT(store, p.Graph(store), n, ring(n, 2))

    def make_trigger():
        (sent_idx,) = rt.intern_terms(s, ["sentinel"])
        (f_idx,) = rt.intern_terms(flag, ["raised"])
        if p.port:
            # the port's trigger runs under torch.func.vmap: the flag's
            # bit comes from an index table, not an in-place write
            onehot = torch.arange(2) == int(f_idx)

            def trig(dense):
                st, fl = dense[s], dense[flag]
                live = (st.exists[int(sent_idx)] & ~st.removed[int(sent_idx)]).any()
                return {flag: fl._replace(mask=fl.mask | (onehot & live))}
        else:
            def trig(dense):
                st, fl = dense[s], dense[flag]
                live = (st.exists[sent_idx] & ~st.removed[sent_idx]).any()
                return {flag: fl._replace(mask=fl.mask.at[f_idx].set(
                    fl.mask[f_idx] | live))}
        return trig

    rt.register_trigger(builder=make_trigger, touches=[s, flag])
    return rt, s, flag


def test_soak_waste_returns_to_zero_mid_run():
    def scn(p, obs):
        rt, s, flag = _sentinel_rt(p)
        for k in range(2):
            rt.update_at(k, s, ("add", f"keep{k}"), f"a{k}")
        for i in range(12):
            rt.update_at(i % 8, s, ("add", f"churn{i}"), f"a{i % 4}")
        obs.append(rt.run_to_convergence(max_rounds=32))
        for i in range(12):
            rt.update_at(0, s, ("remove", f"churn{i}"), "a0")
        obs.append(rt.run_to_convergence(max_rounds=32))
        assert _waste_pct(p, rt, s) > 50
        before = len(rt.store.variable(s).elems)
        with rt.compaction_window() as w:
            reclaimed = w.compact_orset(s)
        assert reclaimed == 13 and before == 15
        assert sorted(rt.store.variable(s).elems.terms()) == [
            "keep0", "keep1", "sentinel"]
        assert _waste_pct(p, rt, s) == 0
        obs.append(p.flat(rt.states[s]))
        rt.update_at(3, s, ("add", "sentinel"), "a3")
        obs.append(rt.run_to_convergence(max_rounds=32))
        assert rt.coverage_value(flag) == {"raised"}
        assert rt.coverage_value(s) == {"keep0", "keep1", "sentinel"}
        assert rt.divergence(s) == 0
        obs.append(p.flat(rt.states[s]))
        obs.append(p.flat(rt.states[flag]))

    _twin(scn)


def test_window_refuses_plain_fn_triggers():
    def scn(p, obs):
        store = p.Store(n_actors=2)
        s = store.declare(id="s", type="lasp_orset", n_elems=8)
        rt = p.RT(store, p.Graph(store), 4, ring(4, 2))
        rt.register_trigger(lambda dense: {}, touches=[s])

        def enter():
            with rt.compaction_window():
                pass

        _raises(obs, RuntimeError, enter, match="builder")

    _twin(scn)


def test_window_restores_triggers_on_body_error():
    def scn(p, obs):
        rt, s, flag = _sentinel_rt(p)

        def boom():
            with rt.compaction_window():
                raise ValueError("boom")

        _raises(obs, ValueError, boom, match="boom")
        assert len(rt._triggers) == 1
        rt.update_at(0, s, ("add", "sentinel"), "a0")
        obs.append(rt.run_to_convergence(max_rounds=32))
        assert rt.coverage_value(flag) == {"raised"}

    _twin(scn)


def test_window_keeps_other_triggers_when_one_builder_fails():
    def scn(p, obs):
        store = p.Store(n_actors=2)
        s = store.declare(id="s", type="lasp_orset", n_elems=8)
        rt = p.RT(store, p.Graph(store), 4, ring(4, 2))
        calls = {"good": 0, "bad": 0}
        flaky = {"armed": False}

        def good_builder():
            calls["good"] += 1
            return lambda dense: {}

        def bad_builder():
            calls["bad"] += 1
            if flaky["armed"]:
                raise RuntimeError("re-intern failed")
            return lambda dense: {}

        rt.register_trigger(builder=good_builder, touches=[s])
        rt.register_trigger(builder=bad_builder, touches=[s])
        flaky["armed"] = True

        def enter():
            with rt.compaction_window():
                pass

        _raises(obs, RuntimeError, enter, match="DROPPED")
        assert len(rt._triggers) == 1
        assert calls["good"] == 2
        obs.append(dict(calls))

    _twin(scn)


def test_window_keeps_triggers_registered_inside_body():
    def scn(p, obs):
        store = p.Store(n_actors=2)
        s = store.declare(id="s", type="lasp_orset", n_elems=8)
        rt = p.RT(store, p.Graph(store), 4, ring(4, 2))
        rt.register_trigger(builder=lambda: (lambda dense: {}), touches=[s])
        with rt.compaction_window() as w:
            w.register_trigger(builder=lambda: (lambda dense: {}), touches=[s])
        assert len(rt._triggers) == 2

    _twin(scn)


def test_window_works_in_packed_mode():
    def scn(p, obs):
        store = p.Store(n_actors=4)
        s = store.declare(id="s", type="lasp_orset", n_elems=16, tokens_per_actor=2)
        rt = p.RT(store, p.Graph(store), 4, ring(4, 2), packed=True)
        rt.register_trigger(builder=lambda: (lambda dense: {}), touches=[s])
        for i in range(8):
            rt.update_at(i % 4, s, ("add", f"e{i}"), f"a{i % 4}")
        obs.append(rt.run_to_convergence(max_rounds=16))
        for i in range(8):
            rt.update_at(1, s, ("remove", f"e{i}"), "a1")
        obs.append(rt.run_to_convergence(max_rounds=16))
        with rt.compaction_window() as w:
            assert w.compact_orset(s) == 8
        obs.append(p.flat(rt.states[s]))
        rt.update_at(2, s, ("add", "fresh"), "a2")
        obs.append(rt.run_to_convergence(max_rounds=16))
        assert rt.coverage_value(s) == {"fresh"}
        obs.append(p.flat(rt.states[s]))

    _twin(scn)


def test_reindex_orset_state_matches_jax():
    """The reindex itself on a seeded ``[R, E, T]`` population: surviving
    rows moved to the front verbatim, freed rows zeroed."""
    rng = np.random.RandomState(9)
    exists = rng.rand(16, 10, 6) < 0.4
    removed = exists & (rng.rand(16, 10, 6) < 0.5)
    order = np.asarray([1, 4, 5, 9])
    import lasp_tpu.lattice as jl
    import lasp_tpu_torch.lattice as tl

    want = jstore.Store.reindex_orset_state(
        jl.ORSetState(jnp.asarray(exists), jnp.asarray(removed)), order)
    got = tstore.Store.reindex_orset_state(
        tl.ORSetState(torch.as_tensor(exists), torch.as_tensor(removed)), order)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    empty = tstore.Store.reindex_orset_state(
        tl.ORSetState(torch.as_tensor(exists), torch.as_tensor(removed)), [])
    assert not any(bool(x.any()) for x in empty)
