"""The port's mesh programs (``lasp_tpu_torch.programs``,
``lasp_tpu_torch.mesh.programs`` and the runtime's ``register`` /
``process`` / ``execute`` / ``programs``) against ``lasp_tpu``: twins of
``tests/mesh/test_programs.py`` and of ``tests/apps/test_riak_index.py``
(run on both packages' ``ReplicatedRuntime``, every event at row 0), and a
seeded event stream with equal results at every step. Each scenario runs
through both packages on the same inputs; what it observes (program values,
populations after convergence, round counts, raised errors) must be
equal."""

import types
import zlib

import numpy as np
import pytest
import torch

import lasp_tpu.mesh as jmesh
import lasp_tpu.programs as jprog
import lasp_tpu.store as jstore
import lasp_tpu.telemetry as jtel
import lasp_tpu.utils.interning as jintern
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.programs as tprog
import lasp_tpu_torch.store as tstore
import lasp_tpu_torch.telemetry as ttel
import lasp_tpu_torch.utils.interning as tintern
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.mesh.topology import random_regular, ring
from lasp_tpu.programs.riak_index import BASE_NAME
from lasp_tpu_torch.bench_scenarios import riak_index_events, riak_index_reference
from lasp_tpu_torch.bridge_state import to_numpy
from lasp_tpu_torch.dataflow import Graph as TGraph

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    """Both packages' global ledger, flight window log, event ring and
    metric registry start and end each test fresh."""
    for tel in (jtel, ttel):
        tel.reset()
        tel.events.clear()
        tel.device.clear()
    yield
    for tel in (jtel, ttel):
        tel.events.clear()
        tel.device.clear()
        tel.reset()


def _pkg(port: bool):
    if port:
        return types.SimpleNamespace(
            port=True, prog=tprog, CapacityError=tintern.CapacityError,
            Store=lambda **kw: tstore.Store(device="cpu", **kw),
            RT=lambda *a, **kw: tmesh.ReplicatedRuntime(*a, device="cpu", **kw),
            Graph=TGraph,
            pop=lambda rt, v: [np.asarray(x) for x in to_numpy(rt.states[v])],
        )
    import jax

    return types.SimpleNamespace(
        port=False, prog=jprog, CapacityError=jintern.CapacityError,
        Store=jstore.Store, RT=jmesh.ReplicatedRuntime, Graph=JGraph,
        pop=lambda rt, v: [np.asarray(x)
                           for x in jax.tree_util.tree_leaves(rt.states[v])],
    )


def _twin(scenario, *args):
    """Run ``scenario(P, obs, *args)`` on both packages; the observation
    lists must be equal (populations compared leaf by leaf, bit for bit)."""
    records = []
    for port in (False, True):
        obs: list = []
        scenario(_pkg(port), obs, *args)
        records.append(obs)
    jax_obs, port_obs = records
    assert len(jax_obs) == len(port_obs)
    for a, b in zip(jax_obs, port_obs):
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.shape == y.shape and np.array_equal(
                    x.view(np.uint8), np.ascontiguousarray(y).view(np.uint8)
                )
        else:
            assert a == b
    return jax_obs


def _rt(P, n=16, k=2, topo=ring, **kw):
    store = P.Store(n_actors=8)
    return P.RT(store, P.Graph(store), n, topo(n, k), **kw)


def _route(key, n):
    return zlib.crc32(str(key).encode()) % n


# -- twins of tests/mesh/test_programs.py --------------------------------------

def sc_keylist_over_population(P, obs):
    rt = _rt(P)
    rt.register("keylist", P.prog.ExampleKeylistProgram, n_elems=16)
    for i, key in enumerate(["k1", "k2", "k3", "k4"]):
        rt.process((key, f"v{i}"), "put", f"actor{i}", replica=(i * 5) % 16)
    obs.append(rt.execute("keylist"))
    pid = rt._programs["keylist"].id
    obs.append(rt.replica_value(pid, 0))
    obs.append(rt.run_to_convergence(max_rounds=64))
    obs.append(rt.divergence(pid))
    obs.append([rt.replica_value(pid, r) for r in range(rt.n_replicas)])
    obs.append(P.pop(rt, pid))


def sc_example_program(P, obs):
    rt = _rt(P, n=8, k=2)
    rt.register("acc", P.prog.ExampleProgram, n_elems=16)
    rt.process("obj1", "put", "a0", replica=0)
    rt.process("obj2", "delete", "a1", replica=3)
    obs.append(rt.execute("acc"))
    obs.append(P.pop(rt, rt._programs["acc"].id))


def sc_register_idempotent(P, obs):
    rt = _rt(P, n=8)
    rt.register("keylist", P.prog.ExampleKeylistProgram, n_elems=8)
    pid = rt._programs["keylist"].id
    rt.register("keylist", P.prog.ExampleKeylistProgram, n_elems=8)
    obs.append((pid, rt._programs["keylist"].id, list(rt.programs)))


def sc_no_write_during_execute(P, obs):
    class Misbehaved(P.prog.ExampleKeylistProgram):
        def execute(self, session):
            session.store.update(self.id, ("add", "sneaky"), "x")

    rt = _rt(P, n=8)
    rt.register("bad", Misbehaved, n_elems=8)
    with pytest.raises(RuntimeError, match="coverage execute") as e:
        rt.execute("bad")
    obs.append(str(e.value))


def sc_index_views_and_delete(P, obs):
    RiakObject, view_name = P.prog.RiakObject, P.prog.view_name
    rt = _rt(P, n=16, k=3)
    rt.register(BASE_NAME, P.prog.RiakIndexProgram, n_elems=32, token_space=16)

    def put(key, vclock, specs=()):
        r = _route(key, rt.n_replicas)
        rt.process(RiakObject(key=key, vclock=vclock, metadata=f"m-{key}",
                              index_specs=specs), "put", f"client-{r}", replica=r)

    put("alpha", ("vc", 1), specs=(("add", "color", "red"),))
    put("beta", ("vc", 2), specs=(("add", "color", "blue"),))
    put("gamma", ("vc", 3), specs=(("add", "color", "red"),))
    obs.append(sorted(rt.programs))
    put("alpha", ("vc", 1.1), specs=(("add", "color", "red"),))
    put("gamma", ("vc", 3.1), specs=(("add", "color", "red"),))
    obs.append(rt.execute(BASE_NAME))
    obs.append(rt.execute(view_name("color", "red")))
    r = _route("beta", rt.n_replicas)
    rt.process(RiakObject(key="beta", vclock=("vc", 4)), "delete",
               f"client-{r}", replica=r)
    obs.append(rt.execute(BASE_NAME))
    put("alpha", ("vc", 5), specs=(("add", "color", "red"),))
    prog = rt._programs[BASE_NAME]
    session = rt._session()
    session.replica = None
    entries = prog.execute(session)
    obs.append(sorted(entries))
    assert len([k for k, _m in entries if k == "alpha"]) == 1
    obs.append(rt.run_to_convergence(max_rounds=64))
    obs.append(rt.divergence(prog.id))
    obs.append(rt.execute(BASE_NAME))
    obs.append(P.pop(rt, prog.id))


def sc_handoff_idempotent_unknown_reason(P, obs):
    RiakObject = P.prog.RiakObject
    rt = _rt(P, n=8, k=2)
    rt.register(BASE_NAME, P.prog.RiakIndexProgram, n_elems=8, token_space=8,
                auto_views=False)
    obj = RiakObject(key="k", vclock=("vc", 1), metadata="m")
    rt.process(obj, "put", "a0", replica=0)
    obs.append(rt.execute(BASE_NAME))
    rt.process(obj, "handoff", "a1", replica=3)
    obs.append(rt.execute(BASE_NAME))
    obs.append(rt.run_to_convergence(max_rounds=64))
    prog = rt._programs[BASE_NAME]
    obs.append(rt.divergence(prog.id))
    with pytest.raises(NotImplementedError, match="unsupported object-event") as e:
        rt.process(obj, "putt", "a0", replica=0)
    obs.append(str(e.value))
    obs.append(rt.execute(BASE_NAME))
    obs.append(P.pop(rt, prog.id))


def sc_put_handoff_delete(P, obs):
    RiakObject = P.prog.RiakObject
    rt = _rt(P, n=8, k=2)
    rt.register(BASE_NAME, P.prog.RiakIndexProgram, n_elems=8, token_space=8,
                auto_views=False)
    prog = rt._programs[BASE_NAME]
    obj = RiakObject(key="k", vclock=("vc", 1), metadata="m")
    rt.process(obj, "put", "a0", replica=0)
    n_before = len(rt.store.variable(prog.id).elems)
    rt.process(obj, "handoff", "a0", replica=0)
    obs.append((rt.execute(BASE_NAME), n_before,
                len(rt.store.variable(prog.id).elems)))
    rt.process(RiakObject(key="k2", vclock=("vc", 7), metadata="m2"),
               "handoff", "a1", replica=5)
    obs.append(rt.execute(BASE_NAME))
    rt.process(obj, "delete", "a0", replica=0)
    obs.append(rt.execute(BASE_NAME))
    rt.process(obj, "handoff", "a0", replica=0)
    obs.append(rt.execute(BASE_NAME))
    obs.append(rt.run_to_convergence(max_rounds=64))
    obs.append(rt.execute(BASE_NAME))
    obs.append(P.pop(rt, prog.id))


def sc_stale_handoff(P, obs):
    RiakObject = P.prog.RiakObject
    rt = _rt(P, n=8, k=2)
    rt.register(BASE_NAME, P.prog.RiakIndexProgram, n_elems=8, token_space=8,
                auto_views=False)
    rt.process(RiakObject(key="k", vclock=("vc", 1), metadata="old"), "put", "a0",
               replica=0)
    rt.process(RiakObject(key="k", vclock=("vc", 2), metadata="new"), "put", "a0",
               replica=0)
    obs.append(rt.execute(BASE_NAME))
    for _ in range(2):
        rt.process(RiakObject(key="k", vclock=("vc", 1), metadata="old"),
                   "handoff", "a1", replica=0)
        obs.append(rt._programs[BASE_NAME].execute(rt._session()))
    assert obs[-1] == {("k", "new")}


def sc_handoff_subset_views(P, obs):
    RiakObject, view_name = P.prog.RiakObject, P.prog.view_name
    rt = _rt(P, n=8, k=2)
    rt.register(BASE_NAME, P.prog.RiakIndexProgram, n_elems=8, token_space=8)
    rt.process(RiakObject(key="seed", vclock=("vc", 0),
                          index_specs=(("add", "color", "red"),)), "put", "a0",
               replica=0)
    rt.process(RiakObject(key="h", vclock=("vc", 1),
                          index_specs=(("add", "color", "red"),)), "handoff", "a1",
               replica=2)
    obs.append(rt.execute(BASE_NAME))
    obs.append(rt.execute(view_name("color", "red")))


def sc_capacity_recovery(P, obs):
    RiakObject = P.prog.RiakObject
    rt = _rt(P, n=8, k=2)
    rt.register(BASE_NAME, P.prog.RiakIndexProgram, n_elems=6, token_space=8,
                auto_views=False)
    for i in range(10):
        key = f"churn{i % 2}"
        rt.process(RiakObject(key=key, vclock=("vc", i)), "put", "c0", replica=3)
        rt.process(RiakObject(key=key, vclock=("vc", i)), "delete", "c0", replica=3)
    rt.process(RiakObject(key="live", vclock=("vc", 99)), "put", "c0", replica=3)
    obs.append(rt.execute(BASE_NAME))
    prog = rt._programs[BASE_NAME]
    obs.append(len(rt.store.variable(prog.id).elems))
    assert obs[-1] <= 6
    obs.append(rt.run_to_convergence(max_rounds=32))
    obs.append(rt.divergence(prog.id))
    obs.append(rt.execute(BASE_NAME))
    obs.append(P.pop(rt, prog.id))


def sc_nested_execute_binding(P, obs):
    seen = []

    class Nosy(P.prog.ExampleKeylistProgram):
        def process(self, session, object, reason, actor):
            session.runtime.execute("keylist")
            super().process(session, object, reason, actor)

    class After(P.prog.ExampleKeylistProgram):
        def process(self, session, object, reason, actor):
            seen.append(session.replica)
            super().process(session, object, reason, actor)

    rt = _rt(P, n=8, k=2)
    rt.register("keylist", P.prog.ExampleKeylistProgram, n_elems=8)
    rt.register("nosy", Nosy, n_elems=8)
    rt.register("after", After, n_elems=8)
    rt.process(("k1", 1), "put", "a0", replica=5)
    obs.append(list(seen))
    obs.append(rt.execute("after"))


def sc_packed_runtime(P, obs):
    store = P.Store(n_actors=8)
    rt = P.RT(store, P.Graph(store), 8, ring(8, 2), packed=True)
    rt.register("keylist", P.prog.ExampleKeylistProgram, n_elems=16)
    rt.register("acc", P.prog.ExampleProgram, n_elems=16)
    for i, key in enumerate(["k1", "k2", "k3"]):
        rt.process((key, i), "put", f"actor{i}", replica=(i * 3) % 8)
    obs.append(rt.execute("keylist"))
    obs.append(rt.execute("acc"))
    obs.append(rt.run_to_convergence(max_rounds=16))
    pid = rt._programs["keylist"].id
    obs.append(rt.divergence(pid))
    obs.append([rt.replica_value(pid, r) for r in range(8)])
    obs.append(P.pop(rt, rt._programs["acc"].id))


def sc_membership_changes(P, obs):
    rt = _rt(P, n=8, k=2)
    rt.register("keylist", P.prog.ExampleKeylistProgram, n_elems=16)
    rt.process(("before", 0), "put", "a0", replica=2)
    rt.resize(12, ring(12, 2))
    rt.process(("after-grow", 1), "put", "a1", replica=10)
    obs.append(rt.execute("keylist"))
    obs.append(rt.run_to_convergence(max_rounds=32))
    rt.resize(6, ring(6, 2), graceful=True)
    obs.append(rt.execute("keylist"))
    rt.process(("after-shrink", 2), "put", "a2", replica=5)
    obs.append(rt.run_to_convergence(max_rounds=32))
    pid = rt._programs["keylist"].id
    obs.append(rt.divergence(pid))
    obs.append([rt.replica_value(pid, r) for r in range(6)])
    obs.append(P.pop(rt, pid))


def sc_quorum_execute(P, obs):
    rt = _rt(P, n=12, k=3, topo=random_regular)
    rt.register("keylist", P.prog.ExampleKeylistProgram, n_elems=8)
    rt.process(("k1", 1), "put", "a0", replica=2)
    rt.process(("k2", 2), "put", "a1", replica=9)
    obs.append(rt.execute("keylist", replicas=[2, 3]))
    obs.append(rt.execute("keylist", replicas=[2, 9]))
    obs.append(rt.run_to_convergence(max_rounds=64))
    obs.append(rt.execute("keylist", replicas=[0]))


def sc_replica_out_of_range(P, obs):
    rt = _rt(P, n=8)
    rt.register("keylist", P.prog.ExampleKeylistProgram, n_elems=8)
    with pytest.raises(IndexError) as e:
        rt.process(("k", 0), "put", "a0", replica=8)
    obs.append(str(e.value))


MESH_CASES = [
    sc_keylist_over_population, sc_example_program, sc_register_idempotent,
    sc_no_write_during_execute, sc_index_views_and_delete,
    sc_handoff_idempotent_unknown_reason, sc_put_handoff_delete, sc_stale_handoff,
    sc_handoff_subset_views, sc_capacity_recovery, sc_nested_execute_binding,
    sc_packed_runtime, sc_membership_changes, sc_quorum_execute,
    sc_replica_out_of_range,
]


@pytest.mark.parametrize("scenario", MESH_CASES, ids=lambda f: f.__name__[3:])
def test_mesh_program_twins(scenario):
    _twin(scenario)


# -- twins of tests/apps/test_riak_index.py, on the ReplicatedRuntime ---------

class _RowSession:
    """JAX's ``api.Session`` surface these cases use, over a runtime: every
    event at row 0, ``execute`` the coverage execute."""

    def __init__(self, P):
        store = P.Store(n_actors=4)
        self.rt = P.RT(store, P.Graph(store), 4, ring(4, 2))
        self.P = P

    def register(self, name, cls, **kw):
        return self.rt.register(name, cls, **kw)

    def process(self, obj, reason, actor):
        self.rt.process(obj, reason, actor, replica=0)

    def execute(self, name):
        return self.rt.execute(name)

    def entries(self, name):
        return self.rt._programs[name].execute(self.rt._session())

    @property
    def programs(self):
        return self.rt.programs


def _put(sess, key, vclock, metadata=None, specs=()):
    sess.process(sess.P.prog.RiakObject(key=key, vclock=vclock, metadata=metadata,
                                        index_specs=tuple(specs)), "put", "idx")


def ri_total_index_replaces_stale(P, obs):
    sess = _RowSession(P)
    sess.register(BASE_NAME, P.prog.RiakIndexProgram)
    _put(sess, "k1", ("a", 1), "m1")
    _put(sess, "k2", ("b", 1), "m2")
    obs.append(sess.execute(BASE_NAME))
    _put(sess, "k1", ("a", 2), "m1-v2")
    entries = sess.entries(BASE_NAME)
    obs.append(sorted(entries))
    assert [e for e in entries if e[0] == "k1"] == [("k1", "m1-v2")]


def ri_delete_removes_entries(P, obs):
    sess = _RowSession(P)
    sess.register(BASE_NAME, P.prog.RiakIndexProgram)
    _put(sess, "k1", ("a", 1))
    _put(sess, "k2", ("b", 1))
    sess.process(P.prog.RiakObject(key="k1", vclock=("a", 2)), "delete", "idx")
    obs.append(sess.execute(BASE_NAME))
    sess.process(P.prog.RiakObject(key="ghost", vclock=("c", 1)), "delete", "idx")
    obs.append(sess.execute(BASE_NAME))


def ri_auto_views(P, obs):
    view_name = P.prog.view_name
    sess = _RowSession(P)
    sess.register(BASE_NAME, P.prog.RiakIndexProgram)
    _put(sess, "k1", ("a", 1), "m1", [("add", "color", "red")])
    obs.append(sorted(sess.programs))
    _put(sess, "k2", ("b", 1), "m2", [("add", "color", "red")])
    _put(sess, "k3", ("c", 1), "m3", [("add", "color", "blue")])
    _put(sess, "k4", ("d", 1), "m4", [("add", "size", "xl")])
    _put(sess, "k1", ("a", 2), "m1", [("add", "color", "red")])
    obs.append(sess.execute(view_name("color", "red")))
    obs.append(sess.execute(view_name("color", "blue")))
    _put(sess, "k3", ("c", 2), "m3", [("add", "color", "blue")])
    obs.append(sess.execute(view_name("color", "blue")))
    obs.append(sess.execute(view_name("size", "xl")))
    obs.append(sess.execute(BASE_NAME))


def ri_non_matching_value(P, obs):
    view_name = P.prog.view_name
    sess = _RowSession(P)
    sess.register(view_name("color", "red"), P.prog.RiakIndexProgram,
                  index_name="color", index_value="red", auto_views=False)
    _put(sess, "k1", ("a", 1), None, [("add", "color", "green")])
    _put(sess, "k2", ("b", 1), None, [("add", "color", "red")])
    _put(sess, "k3", ("c", 1), None, [("remove", "color", "red")])
    obs.append(sess.execute(view_name("color", "red")))


def ri_replayed_vclock(P, obs):
    sess = _RowSession(P)
    sess.register(BASE_NAME, P.prog.RiakIndexProgram)
    for _ in range(3):
        _put(sess, "k1", ("a", 1), "m1")
    obs.append(sorted(sess.entries(BASE_NAME)))
    _put(sess, "k1", ("a", 2), "m1")
    obs.append(sorted(sess.entries(BASE_NAME)))


def ri_delete_then_readd(P, obs):
    sess = _RowSession(P)
    sess.register(BASE_NAME, P.prog.RiakIndexProgram)
    _put(sess, "k1", ("a", 1))
    sess.process(P.prog.RiakObject(key="k1", vclock=("a", 2)), "delete", "idx")
    _put(sess, "k1", ("a", 3))
    obs.append(sess.execute(BASE_NAME))


def ri_token_collision(P, obs):
    sess = _RowSession(P)
    sess.register(BASE_NAME, P.prog.RiakIndexProgram, token_space=1)
    _put(sess, "k1", ("a", 1), "m")
    sess.process(P.prog.RiakObject(key="k1", vclock=("a", 2)), "delete", "idx")
    _put(sess, "k1", ("a", 3), "m")
    obs.append(sess.execute(BASE_NAME))


def ri_autocompact(P, obs):
    sess = _RowSession(P)
    sess.register(BASE_NAME, P.prog.RiakIndexProgram, n_elems=4, token_space=4)
    for v in range(20):
        _put(sess, "k1", ("a", v), f"m{v}")
    obs.append(sess.entries(BASE_NAME))
    _put(sess, "k2", ("b", 1), "x")
    sess.process(P.prog.RiakObject(key="k1", vclock=("a", 99)), "delete", "idx")
    for v in range(6):
        _put(sess, "k3", ("c", v), f"y{v}")
    obs.append(sess.execute(BASE_NAME))
    obs.append(P.pop(sess.rt, sess.rt._programs[BASE_NAME].id))


def ri_compact_raises_when_full(P, obs):
    sess = _RowSession(P)
    sess.register(BASE_NAME, P.prog.RiakIndexProgram, n_elems=3, token_space=4)
    for i in range(3):
        _put(sess, f"k{i}", (f"a{i}", 1), "m")
    with pytest.raises(P.CapacityError) as e:
        _put(sess, "k-one-too-many", ("z", 1), "m")
    obs.append(str(e.value))


INDEX_CASES = [
    ri_total_index_replaces_stale, ri_delete_removes_entries, ri_auto_views,
    ri_non_matching_value, ri_replayed_vclock, ri_delete_then_readd,
    ri_token_collision, ri_autocompact, ri_compact_raises_when_full,
]


@pytest.mark.parametrize("scenario", INDEX_CASES, ids=lambda f: f.__name__[3:])
def test_riak_index_twins(scenario):
    _twin(scenario)


# -- a seeded event stream over both packages ----------------------------------

def sc_event_stream(P, obs, seed):
    rt = _rt(P, n=12, k=3, topo=random_regular)
    rt.register(BASE_NAME, P.prog.RiakIndexProgram, n_elems=16, token_space=16)
    rt.register("keylist", P.prog.ExampleKeylistProgram, n_elems=16)
    for obj, reason in riak_index_events(seed, 48, 6, index_values=4):
        rt.process(obj, reason, "idx", replica=_route(obj[0], rt.n_replicas))
        obs.append({n: rt.execute(n) for n in sorted(rt.programs)})
    obs.append(rt.run_to_convergence(max_rounds=64))
    for name in sorted(rt.programs):
        obs.append(P.pop(rt, rt._programs[name].id))


@pytest.mark.parametrize("seed", [3, 11])
def test_event_stream_twin(seed):
    _twin(sc_event_stream, seed)


# -- the 2i scenario and its plain reference -------------------------------------

def test_riak_index_reference_equals_jax_runtime():
    """``bench_scenarios.riak_index_reference`` (the host model the card's
    programs phase is held to) against JAX's runtime fed the same stream."""
    events = riak_index_events(5, 200, 10, index_names=2, index_values=3)
    rt = _rt(_pkg(False), n=12, k=3, topo=random_regular)
    rt.register(BASE_NAME, jprog.RiakIndexProgram, n_elems=16, token_space=16)
    rt.register("keylist", jprog.ExampleKeylistProgram, n_elems=16)
    for obj, reason in events:
        rt.process(obj, reason, "idx", replica=_route(obj[0], rt.n_replicas))
    want = riak_index_reference(events)
    assert sorted(rt.programs) == sorted(want)
    assert {n: rt.execute(n) for n in rt.programs} == want


def test_riak_index_scenario_on_the_cpu():
    from lasp_tpu_torch.bench_scenarios import riak_index_2i

    out = riak_index_2i(n_replicas=16, n_events=160, n_keys=12, index_values=4,
                        device="cpu")
    assert out["programs"] == out["views"] + 2 and out["compactions"] > 0
    assert out["check"].startswith("sweep == execute")
