"""The KVS-replica workload on the port against ``lasp_tpu``: the cases of
tests/apps/test_kvs_replica.py (all but the checkpoint ones, which wait for
the port's checkpoint store) run once through each package on the same
inputs. Every scenario keeps the JAX test's own assertions and records what
it observes — decoded values, states (every leaf, bit for bit), round
counts, exceptions (type and text) and warnings — and the two records must
be equal (tolerance zero)."""

import types
import warnings

import jax
import numpy as np
import pytest
import torch

import lasp_tpu.mesh as jmesh
import lasp_tpu.store as jstore
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.store as tstore
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.lattice import CrdtMap as JCrdtMap
from lasp_tpu.lattice import Threshold as JThreshold
from lasp_tpu.mesh import random_regular, ring
from lasp_tpu.utils.interning import CapacityError as JCapacityError
from lasp_tpu_torch.dataflow import Graph as TGraph
from lasp_tpu_torch.lattice import CrdtMap as TCrdtMap
from lasp_tpu_torch.lattice import Threshold as TThreshold
from lasp_tpu_torch.lattice.base import tree_leaves
from lasp_tpu_torch.utils.interning import CapacityError as TCapacityError

torch.set_num_threads(1)


def _flat_port(state) -> list:
    return [x.detach().cpu().numpy().copy() for x in tree_leaves(state)]


def _flat_jax(state) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


class _Obs(list):
    """What a scenario observed, in order."""

    def __init__(self, p):
        super().__init__()
        self.p = p

    def state(self, state):
        self.append(("state", self.p.flat(state)))

    def raises(self, exc_types, fn, *args, **kwargs):
        with pytest.raises(exc_types) as info:
            fn(*args, **kwargs)
        self.append(("raised", type(info.value).__name__, str(info.value)))
        return info.value


def _pkg(port: bool):
    if port:
        return types.SimpleNamespace(
            Store=lambda **kw: tstore.Store(device="cpu", **kw),
            RT=lambda *a, **kw: tmesh.ReplicatedRuntime(*a, device="cpu", **kw),
            Graph=TGraph, CrdtMap=TCrdtMap, Threshold=TThreshold,
            PreconditionError=tstore.PreconditionError,
            CapacityError=TCapacityError, flat=_flat_port,
        )
    return types.SimpleNamespace(
        Store=jstore.Store, RT=jmesh.ReplicatedRuntime, Graph=JGraph,
        CrdtMap=JCrdtMap, Threshold=JThreshold,
        PreconditionError=jstore.PreconditionError,
        CapacityError=JCapacityError, flat=_flat_jax,
    )


def _same(a, b):
    assert len(a) == len(b), (len(a), len(b))
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, tuple) and x and x[0] == "state":
            assert len(x[1]) == len(y[1]), f"entry {i}: leaf counts"
            for u, v in zip(x[1], y[1]):
                assert u.dtype == v.dtype and u.shape == v.shape, f"entry {i}"
                assert np.array_equal(u, v), f"entry {i}: leaf values"
        else:
            assert x == y, f"entry {i}: {x!r} != {y!r}"


def _twin(scenario):
    """Run ``scenario(p, obs)`` through both packages; the records must
    be equal. Returns the port's record."""
    records = []
    for port in (False, True):
        obs = _Obs(_pkg(port))
        scenario(obs.p, obs)
        records.append(obs)
    _same(*records)
    return records[1]


KX = ("X", "lasp_orset")
KY = ("Y", "riak_dt_gcounter")


def _kvs(p, reset=False):
    store = p.Store(n_actors=4)
    m = store.declare(
        id="kvs", type="riak_dt_map",
        fields=[(KX, "lasp_orset", {"n_elems": 4}),
                (KY, "riak_dt_gcounter", {})],
        reset_on_readd=reset,
    )
    return store, m


def _put_get_remove(p, obs):
    store, m = _kvs(p)
    store.update(m, ("update", [("update", KX, ("add", "Chris"))]), "replica1")
    assert store.value(m) == {KX: frozenset({"Chris"})}
    store.update(m, ("update", [("remove", KX)]), "replica1")
    assert store.value(m) == {}
    obs.raises(p.PreconditionError, store.update, m,
               ("update", [("remove", KX)]), "replica1")
    obs.state(store.state(m))


def _mixed_fields(p, obs):
    store, m = _kvs(p)
    store.update(m, ("update", [("update", KX, ("add", "a")),
                                ("update", KY, ("increment", 5))]), "r1")
    store.update(m, ("update", [("update", KY, ("increment",))]), "r2")
    assert store.value(m) == {KX: frozenset({"a"}), KY: 6}
    obs.state(store.state(m))


def _remove_readd_presence(p, obs):
    store, m = _kvs(p)
    store.update(m, ("update", [("update", KX, ("add", "v1"))]), "r1")
    store.update(m, ("update", [("remove", KX)]), "r1")
    assert store.value(m) == {}
    store.update(m, ("update", [("update", KX, ("add", "v2"))]), "r1")
    obs.append(store.value(m))
    obs.state(store.state(m))


def _gossip_convergence(p, obs):
    store, m = _kvs(p)
    rt = p.RT(store, p.Graph(store), 4, ring(4, 2))
    rt.update_at(0, m, ("update", [("update", KX, ("add", "from0"))]), "r0")
    rt.update_at(2, m, ("update", [("update", KX, ("add", "from2"))]), "r2")
    obs.append(rt.run_to_convergence(max_rounds=16))
    assert rt.coverage_value(m) == {KX: frozenset({"from0", "from2"})}
    for r in range(4):
        assert rt.replica_value(m, r) == {KX: frozenset({"from0", "from2"})}
    rt.update_at(1, m, ("update", [("remove", KX)]), "r1")
    obs.append(rt.run_to_convergence(max_rounds=16))
    assert rt.coverage_value(m) == {}
    obs.state(rt.states[m])


def _reset_remove_readd(p, obs):
    store, m = _kvs(p, reset=True)
    store.update(m, ("update", [("update", KX, ("add", "Chris"))]), "r1")
    store.update(m, ("update", [("remove", KX)]), "r1")
    assert store.value(m) == {}
    store.update(m, ("update", [("update", KX, ("add", "v2"))]), "r1")
    assert store.value(m) == {KX: frozenset({"v2"})}
    store.update(m, ("update", [("update", KY, ("increment", 5))]), "r1")
    store.update(m, ("update", [("remove", KY)]), "r1")
    store.update(m, ("update", [("update", KY, ("increment", 2))]), "r1")
    assert store.value(m)[KY] == 2
    obs.state(store.state(m))


def _reset_over_gossip(p, obs):
    store, m = _kvs(p, reset=True)
    rt = p.RT(store, p.Graph(store), 4, ring(4, 2))
    rt.update_at(0, m, ("update", [("update", KX, ("add", "v1"))]), "r0")
    obs.append(rt.run_to_convergence(max_rounds=16))
    rt.update_at(1, m, ("update", [("remove", KX)]), "r1")
    rt.update_at(1, m, ("update", [("update", KX, ("add", "v2"))]), "r1")
    obs.append(rt.run_to_convergence(max_rounds=16))
    assert rt.divergence(m) == 0
    for r in range(4):
        assert rt.replica_value(m, r) == {KX: frozenset({"v2"})}
    obs.state(rt.states[m])


def _reset_concurrent_update(p, obs):
    store, m = _kvs(p, reset=True)
    var = store.variable(m)
    store.update(m, ("update", [("update", KX, ("add", "v1"))]), "r1")
    a = store._apply_op(var, var.state, ("update", [("remove", KX)]), "r1")
    b = store._apply_op(var, var.state, ("update", [("update", KX, ("add", "v2"))]), "r2")
    merged = p.CrdtMap.merge(var.spec, a, b)
    assert bool(p.CrdtMap.value(var.spec, merged)[var.spec.field_index(KX)])
    assert store._decode_value(var, merged)[KX] == frozenset({"v2"})
    merged2 = p.CrdtMap.merge(var.spec, b, a)
    assert store._decode_value(var, merged2)[KX] == frozenset({"v2"})
    for s in (a, b, merged, merged2):
        obs.state(s)


def _reset_concurrent_counter(p, obs):
    store, m = _kvs(p, reset=True)
    var = store.variable(m)
    store.update(m, ("update", [("update", KY, ("increment", 5))]), "r1")
    a = store._apply_op(var, var.state, ("update", [("remove", KY)]), "r1")
    b = store._apply_op(var, var.state, ("update", [("update", KY, ("increment", 3))]), "r2")
    merged = p.CrdtMap.merge(var.spec, a, b)
    assert store._decode_value(var, merged)[KY] == 3
    store.bind_raw(m, merged)
    store.update(m, ("update", [("update", KY, ("increment", 2))]), "r3")
    assert store.value(m)[KY] == 5
    obs.state(merged)
    obs.state(store.state(m))


def _reset_gset_epoch_gated(p, obs):
    store = p.Store(n_actors=4)
    key = ("S", "lasp_gset")
    m = store.declare(id="kvs", type="riak_dt_map",
                      fields=[(key, "lasp_gset", {"n_elems": 8})],
                      reset_on_readd=True)
    var = store.variable(m)
    store.update(m, ("update", [("update", key, ("add", "seen"))]), "r1")
    store.update(m, ("update", [("remove", key)]), "r1")
    store.update(m, ("update", [("update", key, ("add", "seen"))]), "r1")
    assert store.value(m) == {key: frozenset({"seen"})}
    a = store._apply_op(var, var.state, ("update", [("remove", key)]), "r1")
    b = store._apply_op(var, var.state, ("update", [("update", key, ("add", "fresh"))]), "r2")
    merged = p.CrdtMap.merge(var.spec, a, b)
    assert bool(p.CrdtMap.value(var.spec, merged)[var.spec.field_index(key)])
    assert store._decode_value(var, merged)[key] == frozenset()
    obs.state(merged)


def _reset_orset_pool_cost(p, obs):
    store = p.Store(n_actors=4)
    m = store.declare(id="kvs", type="riak_dt_map",
                      fields=[(KX, "lasp_orset",
                               {"n_elems": 4, "tokens_per_actor": 3})],
                      reset_on_readd=True)
    for _cycle in range(3):
        store.update(m, ("update", [("update", KX, ("add", "x"))]), "r1")
        assert store.value(m) == {KX: frozenset({"x"})}
        store.update(m, ("update", [("remove", KX)]), "r1")
        assert store.value(m) == {}
    obs.raises(p.CapacityError, store.update, m,
               ("update", [("update", KX, ("add", "x"))]), "r1")
    obs.state(store.state(m))


def _reset_merge_is_lattice(p, obs):
    store, m = _kvs(p, reset=True)
    var = store.variable(m)
    store.update(m, ("update", [("update", KX, ("add", "x"))]), "r1")
    base = var.state
    s1 = store._apply_op(var, base, ("update", [("remove", KX)]), "r1")
    s2 = store._apply_op(var, base, ("update", [("update", KX, ("add", "y"))]), "r2")
    s3 = store._apply_op(var, s1, ("update", [("update", KX, ("add", "z"))]), "r3")
    spec, cm = var.spec, p.CrdtMap

    def eq(x, y):
        return bool(cm.equal(spec, x, y))

    for s in (s1, s2, s3):
        assert eq(cm.merge(spec, s, s), s)
    for x, y in [(s1, s2), (s1, s3), (s2, s3)]:
        assert eq(cm.merge(spec, x, y), cm.merge(spec, y, x))
    lhs = cm.merge(spec, cm.merge(spec, s1, s2), s3)
    rhs = cm.merge(spec, s1, cm.merge(spec, s2, s3))
    assert eq(lhs, rhs)
    obs.state(lhs)
    obs.append(bool(cm.is_strict_inflation(spec, s1, lhs)))
    obs.append(bool(cm.is_inflation(spec, s2, s1)))


def _vectorized(caught) -> bool:
    return not any("no vectorized kernel" in str(w.message) for w in caught)


def _reset_batch_routes_per_op(p, obs):
    store = p.Store(n_actors=8)
    key = ("X", "lasp_gset")
    m = store.declare(id="kvs", type="riak_dt_map",
                      fields=[(key, "lasp_gset", {"n_elems": 8})],
                      n_actors=8, reset_on_readd=True)
    rt = p.RT(store, p.Graph(store), 8, ring(8, 2))
    with_remove = [
        (0, ("update", key, ("add", "a")), "w0"),
        (0, ("remove", key), "w0"),
        (0, ("update", key, ("add", "b")), "w0"),
    ]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rt.update_batch(m, with_remove)
    assert not _vectorized(caught)
    obs.append([str(w.message) for w in caught])
    assert rt.replica_value(m, 0) == {key: frozenset({"b"})}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rt.update_batch(m, [(1, ("update", key, ("add", "c")), "w1")])
    assert _vectorized(caught)
    assert rt.replica_value(m, 1) == {key: frozenset({"c"})}
    obs.state(rt.states[m])
    obs.append(np.flatnonzero(rt._frontier[m]).tolist())


def _orswot_roundtrip(p, obs):
    store = p.Store(n_actors=4)
    s = store.declare(type="riak_dt_orswot", n_elems=4)
    store.update(s, ("add_all", ["a", "b"]), "w1")
    assert store.value(s) == frozenset({"a", "b"})
    store.update(s, ("remove", "a"), "w1")
    assert store.value(s) == frozenset({"b"})
    obs.state(store.state(s))


def _population_batched(p, obs):
    n = 512
    store = p.Store(n_actors=8)
    m = store.declare(id="kvs", type="riak_dt_map",
                      fields=[(("X", "lasp_gset"), "lasp_gset", {"n_elems": 16}),
                              (KY, "riak_dt_gcounter", {})],
                      n_actors=8)
    rt = p.RT(store, p.Graph(store), n, random_regular(n, 3, seed=4))
    rng = np.random.RandomState(4)
    ops = []
    for i in range(1000):
        w = int(rng.randint(8))
        if i % 3 == 0:
            ops.append((w, ("update", KY, ("increment",)), f"w{w}"))
        else:
            ops.append((w, ("update", ("X", "lasp_gset"),
                            ("add", f"k{rng.randint(16)}")), f"w{w}"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rt.update_batch(m, ops)
    assert _vectorized(caught)
    obs.state(rt.states[m])
    obs.append(np.flatnonzero(rt._frontier[m]).tolist())
    rounds = rt.converge_on_device()
    assert rounds >= 1
    obs.append(rounds)
    v = rt.coverage_value(m)
    n_incr = sum(1 for _r, op, _a in ops if op[1][1] == "riak_dt_gcounter")
    assert v[KY] == n_incr
    added = {op[2][1] for _r, op, _a in ops if op[1][0] == "X"}
    assert v[("X", "lasp_gset")] == frozenset(added)
    assert rt.divergence(m) == 0
    obs.state(rt.states[m])


def _dynamic_no_schema(p, obs):
    store = p.Store(n_actors=4)
    m = store.declare(type="riak_dt_map")
    store.update(m, ("update", [("update", KX, ("add", "Chris"))]), "r1")
    assert store.value(m) == {KX: frozenset({"Chris"})}
    store.update(m, ("update", [("update", KY, ("increment", 3)),
                                ("update", KX, ("add", "b"))]), "r1")
    assert store.value(m) == {KX: frozenset({"Chris", "b"}), KY: 3}
    store.update(m, ("update", [("remove", KX)]), "r1")
    assert store.value(m) == {KY: 3}
    obs.raises(p.PreconditionError, store.update, m,
               ("update", [("remove", ("Z", "lasp_orset"))]), "r1")
    assert len(store.variable(m).spec.fields) == 2
    obs.state(store.state(m))


def _dynamic_reset_no_schema(p, obs):
    store = p.Store(n_actors=4)
    m = store.declare(type="riak_dt_map", reset_on_readd=True)
    store.update(m, ("update", [("update", KX, ("add", "Chris"))]), "r1")
    store.update(m, ("update", [("remove", KX)]), "r1")
    store.update(m, ("update", [("update", KX, ("add", "v2"))]), "r1")
    assert store.value(m) == {KX: frozenset({"v2"})}
    store.update(m, ("update", [("update", KY, ("increment", 2))]), "r1")
    assert store.value(m)[KY] == 2
    obs.state(store.state(m))


def _admission_key_validation(p, obs):
    store = p.Store(n_actors=4)
    m = store.declare(type="riak_dt_map")
    obs.raises(KeyError, store.update, m,
               ("update", [("update", "bare", ("add", "x"))]), "r1")
    obs.raises(TypeError, store.update, m,
               ("update", [("update", ("A", "no_such_type"), ("add", "x"))]), "r1")
    store.update(m, ("update", [("update", ("N", "riak_dt_map"), ("update", []))]),
                 "r1")
    assert store.value(m) == {("N", "riak_dt_map"): {}}
    obs.raises(TypeError, store.declare, type="riak_dt_map",
               fields=[(("N", "riak_dt_map"), "riak_dt_map",
                        {"reset_on_readd": True})])
    obs.state(store.state(m))


def _watch_thresholds_grow(p, obs):
    store = p.Store(n_actors=4)
    m = store.declare(type="riak_dt_map")
    store.update(m, ("update", [("update", KX, ("add", "a"))]), "r1")
    var = store.variable(m)
    watch = store.read(m, p.Threshold(var.state, strict=True))
    assert not watch.done
    store.update(m, ("update", [("update", KY, ("increment",))]), "r1")
    assert watch.done
    obs.state(watch.result[2])


def _mesh_growth_update_at(p, obs):
    store = p.Store(n_actors=4)
    m = store.declare(type="riak_dt_map")
    rt = p.RT(store, p.Graph(store), 4, ring(4, 2))
    rt.update_at(0, m, ("update", [("update", KX, ("add", "from0"))]), "r0")
    obs.append(rt.run_to_convergence(max_rounds=16))
    assert rt.coverage_value(m) == {KX: frozenset({"from0"})}
    rt.update_at(2, m, ("update", [("update", KY, ("increment", 7))]), "r2")
    obs.append(rt.run_to_convergence(max_rounds=16))
    assert rt.divergence(m) == 0
    for r in range(4):
        assert rt.replica_value(m, r) == {KX: frozenset({"from0"}), KY: 7}
    obs.state(rt.states[m])


def _mesh_growth_update_batch(p, obs):
    store = p.Store(n_actors=8)
    m = store.declare(type="riak_dt_map")
    rt = p.RT(store, p.Graph(store), 4, ring(4, 2))
    ops = []
    for w in range(4):
        ops.append((w, ("update", ("S", "lasp_gset"), ("add", f"e{w}")), f"w{w}"))
        ops.append((w, ("update", ("C", "riak_dt_gcounter"), ("increment",)), f"w{w}"))
    rt.update_batch(m, ops)
    obs.state(rt.states[m])
    obs.append(rt.run_to_convergence(max_rounds=16))
    v = rt.coverage_value(m)
    assert v[("S", "lasp_gset")] == frozenset({"e0", "e1", "e2", "e3"})
    assert v[("C", "riak_dt_gcounter")] == 4
    assert rt.divergence(m) == 0


def _dynamic_statem(p, obs):
    import random

    for seed in range(3):
        rng = random.Random(seed)
        store = p.Store(n_actors=8)
        m = store.declare(type="riak_dt_map")
        pool = [(f"K{i}", "lasp_gset") for i in range(5)] + [
            (f"C{i}", "riak_dt_gcounter") for i in range(3)
        ]
        for _step in range(60):
            key = rng.choice(pool)
            actor = f"w{rng.randrange(8)}"
            roll = rng.random()
            if roll < 0.55:
                inner = (("add", f"e{rng.randrange(6)}") if key[1] == "lasp_gset"
                         else ("increment",))
                store.update(m, ("update", [("update", key, inner)]), actor)
            elif roll < 0.75:
                try:
                    store.update(m, ("update", [("remove", key)]), actor)
                except p.PreconditionError as exc:
                    obs.append(("not_present", str(exc)))
            else:
                k2 = rng.choice(pool)
                if k2[1] == "lasp_gset" and key[1] == "lasp_gset":
                    store.update(m, ("update", [
                        ("update", key, ("add", f"e{rng.randrange(6)}")),
                        ("update", k2, ("add", f"e{rng.randrange(6)}")),
                    ]), actor)
            obs.append(store.value(m))
        obs.state(store.state(m))


def _batch_admission_atomic(p, obs):
    store = p.Store(n_actors=8)
    m = store.declare(type="riak_dt_map")
    rt = p.RT(store, p.Graph(store), 4, ring(4, 2))
    obs.raises(KeyError, rt.update_batch, m, [
        (0, ("update", ("A", "lasp_gset"), ("add", "x")), "w0"),
        (1, ("update", "bad_key", ("add", "y")), "w1"),
    ])
    assert store.variable(m).spec.fields == ()
    rt.update_at(0, m, ("update", ("A", "lasp_gset"), ("add", "z")), "w0")
    obs.append(rt.run_to_convergence(max_rounds=16))
    assert rt.coverage_value(m) == {("A", "lasp_gset"): frozenset({"z"})}
    obs.state(rt.states[m])


def _dynamic_statem_reset(p, obs):
    import random

    for seed in range(2):
        rng = random.Random(seed + 100)
        store = p.Store(n_actors=8)
        m = store.declare(type="riak_dt_map", reset_on_readd=True)
        pool = [(f"K{i}", "lasp_orset") for i in range(3)] + [
            (f"C{i}", "riak_dt_gcounter") for i in range(2)
        ]
        for _step in range(60):
            key = rng.choice(pool)
            actor = f"w{rng.randrange(8)}"
            try:
                if rng.random() < 0.6:
                    inner = (("add", f"e{rng.randrange(5)}")
                             if key[1] == "lasp_orset"
                             else ("increment", rng.randint(1, 3)))
                    store.update(m, ("update", [("update", key, inner)]), actor)
                else:
                    store.update(m, ("update", [("remove", key)]), actor)
            except (p.CapacityError, p.PreconditionError) as exc:
                obs.append((type(exc).__name__, str(exc)))
            obs.append(store.value(m))
        obs.state(store.state(m))


def _compact_sustains_churn(p, obs):
    store = p.Store(n_actors=4)
    m = store.declare(id="kvs", type="riak_dt_map",
                      fields=[(KX, "lasp_orset",
                               {"n_elems": 4, "tokens_per_actor": 3})],
                      reset_on_readd=True)
    for _cycle in range(10):
        store.update(m, ("update", [("update", KX, ("add", "x"))]), "r1")
        assert store.value(m) == {KX: frozenset({"x"})}
        store.update(m, ("update", [("remove", KX)]), "r1")
        assert store.value(m) == {}
        got = store.compact_map_field(m, KX)
        assert got >= 1
        obs.append(got)
    obs.state(store.state(m))
    store.update(m, ("update", [("update", ("C", "riak_dt_gcounter"),
                                 ("increment",))]), "r1")
    obs.raises(TypeError, store.compact_map_field, m, ("C", "riak_dt_gcounter"))


def _runtime_compact_population(p, obs):
    store = p.Store(n_actors=8)
    m = store.declare(type="riak_dt_map", reset_on_readd=True)
    rt = p.RT(store, p.Graph(store), 4, ring(4, 2))
    for cycle in range(3):
        rt.update_at(0, m, ("update", [("update", KX, ("add", f"v{cycle}"))]), "w0")
        obs.append(rt.run_to_convergence(max_rounds=16))
        rt.update_at(2, m, ("update", [("remove", KX)]), "w2")
        obs.append(rt.run_to_convergence(max_rounds=16))
        assert rt.coverage_value(m) == {}
    rt.update_at(1, m, ("update", [("update", KX, ("add", "live"))]), "w1")
    obs.raises(RuntimeError, rt.compact_map_field, m, KX)
    obs.append(rt.run_to_convergence(max_rounds=16))
    got = rt.compact_map_field(m, KX)
    assert got >= 1
    obs.append(got)
    obs.state(rt.states[m])
    assert rt.coverage_value(m) == {KX: frozenset({"live"})}
    rt.update_at(3, m, ("update", [("update", KX, ("add", "after"))]), "w3")
    obs.append(rt.run_to_convergence(max_rounds=16))
    assert rt.coverage_value(m) == {KX: frozenset({"live", "after"})}
    assert rt.divergence(m) == 0
    obs.state(rt.states[m])


KN = ("N", "riak_dt_map")
KC = ("c", "riak_dt_gcounter")
KS = ("s", "lasp_orset")


def _nested_schemaless(p, obs):
    store = p.Store(n_actors=8)
    m = store.declare(type="riak_dt_map")
    store.update(m, ("update", [("update", KN,
                                 ("update", [("update", KC, ("increment", 3))]))]),
                 "r1")
    store.update(m, ("update", [("update", KN, ("update", KS, ("add", "x")))]), "r1")
    assert store.value(m) == {KN: {KC: 3, KS: frozenset({"x"})}}
    k2 = ("D", "riak_dt_map")
    store.update(m, ("update", [("update", KN,
                                 ("update", k2, ("update", KC, ("increment",))))]),
                 "r2")
    assert store.value(m)[KN][k2] == {KC: 1}
    store.update(m, ("update", [("update", KN, ("remove", KS))]), "r1")
    assert KS not in store.value(m)[KN]
    obs.raises(p.PreconditionError, store.update, m,
               ("update", [("update", KN, ("remove", ("zz", "lasp_gset")))]), "r1")
    obs.state(store.state(m))


def _nested_reset_recurses(p, obs):
    store = p.Store(n_actors=8)
    m = store.declare(type="riak_dt_map", reset_on_readd=True)
    store.update(m, ("update", [("update", KN, ("update", KC, ("increment", 5)))]), "r1")
    store.update(m, ("update", [("remove", KN)]), "r1")
    assert store.value(m) == {}
    store.update(m, ("update", [("update", KN, ("update", KC, ("increment", 2)))]), "r1")
    assert store.value(m) == {KN: {KC: 2}}
    store.update(m, ("update", [("update", KN, ("remove", KC))]), "r1")
    assert store.value(m)[KN] == {}
    store.update(m, ("update", [("update", KN, ("update", KC, ("increment", 4)))]), "r1")
    assert store.value(m)[KN] == {KC: 4}
    var = store.variable(m)
    a = store._apply_op(var, var.state, ("update", [("remove", KN)]), "r1")
    b = store._apply_op(var, var.state,
                        ("update", [("update", KN, ("update", KC, ("increment", 7)))]),
                        "r2")
    merged = p.CrdtMap.merge(var.spec, a, b)
    assert store._decode_value(var, merged) == {KN: {KC: 7}}
    obs.state(merged)


def _nested_mesh_convergence(p, obs):
    store = p.Store(n_actors=8)
    m = store.declare(type="riak_dt_map")
    rt = p.RT(store, p.Graph(store), 4, ring(4, 2))
    rt.update_at(0, m, ("update", [("update", KN, ("update", KC, ("increment", 2)))]),
                 "w0")
    obs.append(rt.run_to_convergence(max_rounds=16))
    rt.update_at(2, m, ("update", [("update", KN, ("update", KS, ("add", "deep")))]),
                 "w2")
    obs.append(rt.run_to_convergence(max_rounds=16))
    assert rt.divergence(m) == 0
    assert rt.coverage_value(m) == {KN: {KC: 2, KS: frozenset({"deep"})}}
    obs.state(rt.states[m])


def _compact_nested_path(p, obs):
    store = p.Store(n_actors=4)
    m = store.declare(type="riak_dt_map", reset_on_readd=True)
    path = (KN, KS)
    for _cycle in range(6):
        store.update(m, ("update", [("update", KN, ("update", KS, ("add", "x")))]), "r1")
        assert store.value(m)[KN][KS] == frozenset({"x"})
        store.update(m, ("update", [("update", KN, ("remove", KS))]), "r1")
        got = store.compact_map_field(m, path)
        assert got >= 1
        obs.append(got)
    obs.state(store.state(m))
    store2 = p.Store(n_actors=8)
    m2 = store2.declare(type="riak_dt_map", reset_on_readd=True)
    rt = p.RT(store2, p.Graph(store2), 4, ring(4, 2))
    for cycle in range(3):
        rt.update_at(0, m2, ("update", [("update", KN, ("update", KS,
                                                        ("add", f"v{cycle}")))]), "w0")
        obs.append(rt.run_to_convergence(max_rounds=16))
        rt.update_at(2, m2, ("update", [("update", KN, ("remove", KS))]), "w2")
        obs.append(rt.run_to_convergence(max_rounds=16))
    assert rt.compact_map_field(m2, path) >= 1
    rt.update_at(1, m2, ("update", [("update", KN, ("update", KS, ("add", "after")))]),
                 "w1")
    obs.append(rt.run_to_convergence(max_rounds=16))
    assert rt.coverage_value(m2)[KN][KS] == frozenset({"after"})
    assert rt.divergence(m2) == 0
    obs.state(rt.states[m2])


_SCENARIOS = {
    "put_get_remove": _put_get_remove,
    "mixed_fields_and_batched_ops": _mixed_fields,
    "map_remove_readd_presence": _remove_readd_presence,
    "map_gossip_convergence": _gossip_convergence,
    "reset_mode_remove_readd_resets_contents": _reset_remove_readd,
    "reset_mode_propagates_over_gossip": _reset_over_gossip,
    "reset_mode_concurrent_update": _reset_concurrent_update,
    "reset_mode_concurrent_counter_increment": _reset_concurrent_counter,
    "reset_mode_gset_field_is_epoch_gated": _reset_gset_epoch_gated,
    "reset_mode_orset_sequential_cycles_and_pool_cost": _reset_orset_pool_cost,
    "reset_mode_merge_is_lattice": _reset_merge_is_lattice,
    "reset_mode_batch_routes_through_per_op_path": _reset_batch_routes_per_op,
    "orswot_store_roundtrip": _orswot_roundtrip,
    "kvs_population_scale_batched": _population_batched,
    "dynamic_declare_no_schema": _dynamic_no_schema,
    "dynamic_reset_mode_no_schema": _dynamic_reset_no_schema,
    "dynamic_admission_key_validation": _admission_key_validation,
    "dynamic_watch_thresholds_grow": _watch_thresholds_grow,
    "dynamic_mesh_growth_update_at": _mesh_growth_update_at,
    "dynamic_mesh_growth_update_batch": _mesh_growth_update_batch,
    "dynamic_statem": _dynamic_statem,
    "dynamic_batch_admission_is_atomic": _batch_admission_atomic,
    "dynamic_statem_reset_mode": _dynamic_statem_reset,
    "compact_map_field_sustains_reset_churn": _compact_sustains_churn,
    "runtime_compact_map_field_population": _runtime_compact_population,
    "nested_map_schemaless_flow": _nested_schemaless,
    "nested_map_reset_remove_recurses": _nested_reset_recurses,
    "nested_map_mesh_convergence": _nested_mesh_convergence,
    "compact_nested_map_field_path": _compact_nested_path,
}


@pytest.mark.parametrize("case", sorted(_SCENARIOS))
def test_kvs_replica_matches_jax(case):
    """One case of tests/apps/test_kvs_replica.py through both packages:
    its own assertions hold on each, and the two records are equal."""
    _twin(_SCENARIOS[case])
