"""The port's ring-coverage queries (``lasp_tpu_torch.quorum.coverage``)
against ``lasp_tpu.quorum.coverage``: twins of
``tests/quorum/test_coverage.py``, ``coverage_sweep`` equal to
``coverage_value`` for every codec at odd populations and odd shard
counts, and the grouped sweep's operator count independent of the group
width G."""

import types
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import lasp_tpu.mesh as jmesh
import lasp_tpu.programs as jprog
import lasp_tpu.quorum as jquorum
import lasp_tpu.quorum.coverage as jcov
import lasp_tpu.store as jstore
import lasp_tpu.telemetry as jtel
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.programs as tprog
import lasp_tpu_torch.quorum as tquorum
import lasp_tpu_torch.quorum.coverage as tcov
import lasp_tpu_torch.store as tstore
import lasp_tpu_torch.telemetry as ttel
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.mesh.topology import random_regular, ring
from lasp_tpu.programs.riak_index import BASE_NAME
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
            port=True, prog=tprog, quorum=tquorum, cov=tcov,
            Store=lambda **kw: tstore.Store(device="cpu", **kw),
            RT=lambda *a, **kw: tmesh.ReplicatedRuntime(*a, device="cpu", **kw),
            Graph=TGraph,
        )
    return types.SimpleNamespace(
        port=False, prog=jprog, quorum=jquorum, cov=jcov, Store=jstore.Store,
        RT=jmesh.ReplicatedRuntime, Graph=JGraph,
    )


def _twin(scenario, *args):
    out = [scenario(_pkg(port), *args) for port in (False, True)]
    assert out[0] == out[1]
    return out[1]


def _mixed_rt(P, R=12, topo=ring, k=2):
    store = P.Store(n_actors=8)
    ids = [store.declare(id=f"g{i}", type="lasp_gset", n_elems=16) for i in range(4)]
    ids.append(store.declare(id="c0", type="riak_dt_gcounter"))
    ids.append(store.declare(id="o0", type="riak_dt_orswot", n_elems=16, n_actors=8))
    rt = P.RT(store, P.Graph(store), R, topo(R, k))
    for i in range(4):
        rt.update_at((i * 3) % R, f"g{i}", ("add", f"e{i}"), f"w{i}")
    rt.update_at(5, "c0", ("increment",), "wc")
    rt.update_at(7, "o0", ("add", "tag"), "wo")
    return rt, ids


# -- twins of tests/quorum/test_coverage.py -----------------------------------

def sc_sweep_matches_coverage_value(P):
    rt, ids = _mixed_rt(P)
    out = []
    for n_shards in (1, 4):
        sw = P.quorum.coverage_sweep(rt, n_shards=n_shards)
        for v in ids:
            assert sw[v] == rt.coverage_value(v), (v, n_shards)
        out.append(sw)
    return out


def sc_sweep_groups_by_signature(P):
    rt, _ids = _mixed_rt(P, R=14)
    before = set(P.cov._sweep_cache)
    P.quorum.coverage_sweep(rt, n_shards=4)
    new = [k for k in P.cov._sweep_cache if k not in before]
    # the module-level cache is left as it was: tests/quorum/test_coverage.py
    # counts the keys that R=14 adds, and may run later in this process
    try:
        gs = [k for k in new if k[2] == 4]
        assert len(gs) == 1
        assert len(new) == 3
        return sorted((k[0].__name__, k[2], k[3], k[4]) for k in new)
    finally:
        for k in new:
            del P.cov._sweep_cache[k]


def sc_sweep_after_more_writes(P):
    rt, _ids = _mixed_rt(P, R=10, topo=random_regular, k=3)
    rounds = rt.run_to_convergence(max_rounds=64)
    rt.update_at(0, "g0", ("add", "late"), "w9")
    sw = P.quorum.coverage_sweep(rt)
    assert sw["g0"] == rt.coverage_value("g0") >= {"e0", "late"}
    return rounds, sw


def sc_ring_coverage_feeds_views(P):
    R = 10
    store = P.Store(n_actors=8)
    rt = P.RT(store, P.Graph(store), R, ring(R, 2))
    rt.register(BASE_NAME, P.prog.RiakIndexProgram, n_elems=32, token_space=32)
    for i in range(6):
        rt.process(P.prog.RiakObject(
            key=f"k{i}", vclock=("vc", i),
            index_specs=(("add", "color", "red" if i % 2 else "blue"),),
        ), "put", f"a{i}", replica=i % R)
    rounds = rt.run_to_convergence(max_rounds=64)
    out = P.quorum.ring_coverage_execute(rt)
    assert set(out) == set(rt.programs)
    for name in out:
        assert out[name] == rt.execute(name), name
    assert P.prog.view_name("color", "red") in out
    assert out[BASE_NAME] == {f"k{i}" for i in range(6)}
    return rounds, out


def sc_unknown_program_is_loud(P):
    rt, _ids = _mixed_rt(P)
    with pytest.raises(KeyError, match="nope") as e:
        P.quorum.ring_coverage_execute(rt, names=["nope"])
    return str(e.value)


@pytest.mark.parametrize("scenario", [
    sc_sweep_matches_coverage_value, sc_sweep_groups_by_signature,
    sc_sweep_after_more_writes, sc_ring_coverage_feeds_views,
    sc_unknown_program_is_loud,
], ids=lambda f: f.__name__[3:])
def test_coverage_twins(scenario):
    _twin(scenario)


# -- every codec, odd populations, odd shard counts ---------------------------

MAP_FIELDS = [(("g", "lasp_gset"), "lasp_gset", {"n_elems": 5}),
              (("c", "riak_dt_gcounter"), "riak_dt_gcounter", {})]


def sc_every_codec(P, R, n_shards, packed):
    store = P.Store(n_actors=4)
    store.declare(id="gs", type="lasp_gset", n_elems=8)
    store.declare(id="gs2", type="lasp_gset", n_elems=8)
    store.declare(id="gc", type="riak_dt_gcounter", n_actors=4)
    store.declare(id="iv", type="lasp_ivar")
    store.declare(id="os", type="lasp_orset", n_elems=6, n_actors=4, tokens_per_actor=2)
    store.declare(id="ob", type="lasp_orset_gbtree", n_elems=6, n_actors=4,
                  tokens_per_actor=2)
    store.declare(id="ow", type="riak_dt_orswot", n_elems=6, n_actors=4)
    store.declare(id="mp", type="riak_dt_map", fields=MAP_FIELDS, n_actors=4)
    rt = P.RT(store, P.Graph(store), R, random_regular(R, 3, seed=4), packed=packed)
    rng = np.random.default_rng(R * 10 + n_shards)
    for a in range(4):
        row = int(rng.integers(R))
        rt.update_at(row, "gs", ("add", f"e{a}"), f"w{a}")
        rt.update_at(int(rng.integers(R)), "gs2", ("add", f"f{a}"), f"w{a}")
        rt.update_at(row, "gc", ("increment", a + 1), f"w{a}")
        rt.update_at(row, "os", ("add", f"o{a}"), f"w{a}")
        rt.update_at(row, "ob", ("add", f"b{a}"), f"w{a}")
        rt.update_at(row, "ow", ("add", f"t{a}"), f"w{a}")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rt.update_at(row, "mp", ("update", ("g", "lasp_gset"), ("add", f"m{a}")),
                         f"w{a}")
    rt.update_at(int(rng.integers(R)), "iv", ("set", "payload"), "w0")
    sw = P.quorum.coverage_sweep(rt, n_shards=n_shards)
    for v in rt.var_ids:
        assert sw[v] == rt.coverage_value(v), v
    return sw


@pytest.mark.parametrize("R,n_shards,packed", [
    (9, 1, False), (11, 3, False), (13, 5, True), (15, 7, False), (7, 9, True),
])
def test_sweep_equals_coverage_value_every_codec(R, n_shards, packed):
    _twin(sc_every_codec, R, n_shards, packed)


# -- the grouped sweep's operators do not grow with G --------------------------

class _OpCount(TorchDispatchMode):
    """Counts the operators that compute (a view computes nothing and
    launches no kernel: a member's shard slice is one)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


def _ops_per_sweep(g: int, R: int = 21, n_shards: int = 4) -> int:
    store = tstore.Store(device="cpu", n_actors=2)
    ids = [store.declare(id=f"v{i}", type="lasp_orset_gbtree", n_elems=8,
                         n_actors=1, tokens_per_actor=8) for i in range(g)]
    rt = tmesh.ReplicatedRuntime(store, TGraph(store), R, ring(R, 2), device="cpu")
    codec, spec = rt._mesh_meta(ids[0])
    fn = tcov._sweep_fn(codec, spec, g, R, n_shards)
    members = [rt._population(v) for v in ids]
    with _OpCount() as count:
        fn(members)
    return count.n


def test_sweep_operator_count_independent_of_group_width():
    counts = {g: _ops_per_sweep(g) for g in (1, 5, 17)}
    assert len(set(counts.values())) == 1, counts
