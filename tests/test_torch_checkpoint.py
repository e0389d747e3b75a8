"""The port's host store and checkpoints against ``lasp_tpu``'s: the log
engines on both backends and across packages, and checkpoints read by both
packages: JAX-saved -> port-loaded and port-saved -> JAX-loaded, for
stores (every lattice type, a reset-mode map) and runtimes (packed OR-Set,
OR-SWOT, map), bit for bit; ``load_runtime_rows`` + ``reseed_row``;
elastic ``load_runtime``; the reset-mode map's tombs backfill gate; and the
restricted unpickler (tolerance zero: every value is a bit or an
integer)."""

import pickle

import jax
import numpy as np
import pytest
import torch

import lasp_tpu.store.checkpoint as jck
import lasp_tpu.store.host_store as jhs
import lasp_tpu_torch.store.checkpoint as tck
import lasp_tpu_torch.store.host_store as ths
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.mesh import ReplicatedRuntime as JRT
from lasp_tpu.mesh import random_regular, ring
from lasp_tpu.store import Store as JStore
from lasp_tpu_torch import bridge_state
from lasp_tpu_torch.dataflow import Graph as TGraph
from lasp_tpu_torch.mesh import ReplicatedRuntime as TRT
from lasp_tpu_torch.store import Store as TStore

torch.set_num_threads(1)

BACKENDS = ["native", "python-fallback"]


@pytest.fixture(params=BACKENDS)
def backend(request, monkeypatch):
    if request.param == "python-fallback":
        monkeypatch.setattr(ths, "_native", lambda: None)
    elif ths._native() is None:
        pytest.skip("native library not built")
    return request.param


def _np_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _np_leaves(part)]
    return [np.array(tree)]


def _jleaves(state) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _tleaves(state) -> list:
    return _np_leaves(bridge_state.to_numpy(state))


def _same(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


# -- the host store ----------------------------------------------------------------


def test_put_get_delete_compact_roundtrip(tmp_path, backend):
    p = str(tmp_path / "kv.log")
    with ths.HostStore(p) as s:
        assert s.backend == backend
        s.put("a", b"hello")
        s.put("b", b"\x00" * 1000)
        s.put("a", b"hello2")  # supersede
        s.put("with\nnewline ☃", b"v")
        assert s.get("a") == b"hello2" and s.get("missing") is None
        assert s.delete("b") and not s.delete("b")
        assert s.stats()["keys"] == 2 and s.stats()["wasted_bytes"] > 0
        s.compact()
        assert s.stats()["wasted_bytes"] == 0
    with ths.HostStore(p) as s:  # the index is rebuilt from the log
        assert s.get("a") == b"hello2" and s.get("b") is None
        assert sorted(s.keys()) == ["a", "with\nnewline ☃"]


def test_torn_write_recovery(tmp_path, backend):
    p = str(tmp_path / "torn.log")
    with ths.HostStore(p) as s:
        s.put("good", b"A" * 100)
    with open(p, "ab") as f:  # a crash mid-record
        f.write(b"\x52\x50\x53\x4c" + b"garbage-partial-record")
    with ths.HostStore(p) as s:
        assert s.get("good") == b"A" * 100
        s.put("after", b"B")
        assert s.get("after") == b"B"


@pytest.mark.parametrize("writer_native", [True, False])
def test_log_format_shared_across_packages_and_engines(tmp_path, monkeypatch,
                                                       writer_native):
    """Each package's engines read the files the other package's wrote."""
    if ths._native() is None or jhs._NATIVE is None:
        pytest.skip("native library not built")
    p = str(tmp_path / "x.log")
    if not writer_native:
        monkeypatch.setattr(ths, "_native", lambda: None)
    with ths.HostStore(p) as s:
        s.put("k1", b"from-port")
    monkeypatch.setattr(jhs, "_NATIVE", jhs._NATIVE if not writer_native else None)
    with jhs.HostStore(p) as s:
        assert s.get("k1") == b"from-port"
        s.put("k2", b"from-jax")
    monkeypatch.undo()
    with ths.HostStore(p) as s:
        assert s.backend == "native"
        assert (s.get("k1"), s.get("k2")) == (b"from-port", b"from-jax")


# -- stores ------------------------------------------------------------------------


def _fill_store(store):
    """Every lattice type, a default map and a reset-mode map with a
    tombstoned field (the scripts of tests/store/test_persistence.py)."""
    o = store.declare(id="o", type="lasp_orset", n_elems=8)
    c = store.declare(id="c", type="riak_dt_gcounter")
    v = store.declare(id="v", type="lasp_ivar")
    g = store.declare(id="g", type="lasp_gset", n_elems=4)
    w = store.declare(id="w", type="riak_dt_orswot", n_elems=4)
    m = store.declare(id="m", type="riak_dt_map",
                      fields=[(("X", "lasp_orset"), "lasp_orset", {"n_elems": 4})])
    r = store.declare(id="r", type="riak_dt_map", reset_on_readd=True,
                      fields=[(("X", "lasp_orset"), "lasp_orset", {"n_elems": 4}),
                              (("Y", "riak_dt_gcounter"), "riak_dt_gcounter", {})])
    store.update(o, ("add_all", ["a", "b"]), "w1")
    store.update(o, ("remove", "a"), "w1")
    store.update(c, ("increment", 7), "w2")
    store.update(v, ("set", ("compound", "payload")), "w1")
    store.update(g, ("add", 3), "w1")
    store.update(w, ("add_all", ["p", "q"]), "w1")
    store.update(w, ("remove", "p"), "w2")
    store.update(m, ("update", [("update", ("X", "lasp_orset"), ("add", "f"))]), "w3")
    kx, ky = ("X", "lasp_orset"), ("Y", "riak_dt_gcounter")
    store.update(r, ("update", [("update", kx, ("add", "v1")),
                                ("update", ky, ("increment", 2))]), "r1")
    store.update(r, ("update", [("remove", kx)]), "r1")
    store.update(r, ("update", [("update", kx, ("add", "v2"))]), "r1")
    return ("o", "c", "v", "g", "w", "m", "r")


def _check_store_pair(jstore, tstore, ids):
    assert list(tstore.ids()) == list(jstore.ids())
    assert tstore.mutations == jstore.mutations
    for vid in ids:
        assert tstore.value(vid) == jstore.value(vid), vid
        _same(_jleaves(jstore.state(vid)), _tleaves(tstore.state(vid)))
        jv, tv = jstore.variable(vid), tstore.variable(vid)
        for attr in ("elems", "ivar_payloads", "actors"):
            ji, ti = getattr(jv, attr), getattr(tv, attr)
            assert (ji is None) == (ti is None)
            if ji is not None:
                assert list(ti.terms()) == list(ji.terms()), (vid, attr)


def test_jax_saved_store_loads_in_the_port(tmp_path):
    js = JStore(n_actors=4)
    ids = _fill_store(js)
    path = str(tmp_path / "j.lasp")
    jck.save_store(js, path)
    ts = tck.load_store(path, device="cpu")
    _check_store_pair(js, ts, ids)
    assert type(ts.variable("m").spec).__module__ == "lasp_tpu_torch.lattice.map"
    # the loaded store keeps working as the JAX one does
    for s in (js, ts):
        s.update("o", ("add", "c"), "w1")
        s.update("r", ("update", [("remove", ("X", "lasp_orset"))]), "r1")
    _check_store_pair(js, ts, ids)


def test_port_saved_store_loads_in_jax(tmp_path):
    ts = TStore(n_actors=4, device="cpu")
    ids = _fill_store(ts)
    js = JStore(n_actors=4)
    _fill_store(js)
    path = str(tmp_path / "t.lasp")
    tck.save_store(ts, path)
    loaded = jck.load_store(path)  # JAX's own restricted reader
    _check_store_pair(loaded, ts, ids)
    _check_store_pair(loaded, tck.load_store(path, device="cpu"), ids)
    # the leaf records are byte for byte the JAX package's own
    jpath = str(tmp_path / "j.lasp")
    jck.save_store(js, jpath)
    with jhs.HostStore(path) as a, jhs.HostStore(jpath) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for key in a.keys():
            if key.startswith("leaf/"):
                assert a.get(key) == b.get(key), key


def test_store_legacy_inline_manifest(tmp_path):
    js = JStore(n_actors=4)
    js.declare(id="o", type="lasp_orset", n_elems=8)
    js.declare(id="c", type="riak_dt_gcounter")
    js.update("o", ("add_all", ["a", "b"]), "w1")
    js.update("c", ("increment", 3), "w2")
    path = str(tmp_path / "legacy.log")
    jck.save_store(js, path)
    with jhs.HostStore(path) as hs:
        header = jck.loads_manifest(hs.get("manifest"))
        header["vars"] = {vid: jck.loads_manifest(hs.get(jck._varmeta_key(vid)))
                          for vid in header.pop("var_ids")}
        header["metrics"] = dict(js.metrics)
        header["mutations"] = js.mutations
        hs.delete("counters")
        hs.put("manifest", pickle.dumps(header))
    ts = tck.load_store(path, device="cpu")
    assert ts.value("o") == frozenset({"a", "b"}) and ts.value("c") == 3
    assert ts.mutations == js.mutations


def test_load_store_refusals(tmp_path):
    store = TStore(n_actors=4, device="cpu")
    store.declare(id="c", type="riak_dt_gcounter")
    rt = TRT(store, TGraph(store), 4, ring(4, 2), device="cpu")
    path = str(tmp_path / "rt.log")
    tck.save_runtime(rt, path)
    with pytest.raises(IOError, match="runtime checkpoint"):
        tck.load_store(path, device="cpu")
    bad = str(tmp_path / "bad.log")
    with ths.HostStore(bad) as hs:
        hs.put("manifest", pickle.dumps({"kind": "store", "n_actors": 2}))
    with pytest.raises(IOError, match="neither 'var_ids'"):
        tck.load_store(bad, device="cpu")
    store2 = TStore(n_actors=2, device="cpu")
    store2.declare(id="s", type="lasp_orset", n_elems=4)
    snap = str(tmp_path / "s.log")
    tck.save_store(store2, snap)
    with pytest.raises(IOError, match="not a runtime checkpoint"):
        tck.load_runtime_rows(snap, 0)


# -- runtimes ----------------------------------------------------------------------


def _fill_runtime(store, graph, rt_cls, packed, **kw):
    store.declare(id="s", type="lasp_orset", n_elems=8, n_actors=4, tokens_per_actor=2)
    store.declare(id="w", type="riak_dt_orswot", n_elems=8, n_actors=4)
    store.declare(id="m", type="riak_dt_map", n_actors=4, reset_on_readd=True,
                  fields=[(("G", "lasp_gset"), "lasp_gset", {"n_elems": 4}),
                          (("C", "riak_dt_gcounter"), "riak_dt_gcounter", {})])
    rt = rt_cls(store, graph, 12, random_regular(12, 3, seed=6), packed=packed, **kw)
    rt.update_batch("s", [(1, ("add_all", ["a", "b"]), "w0"), (7, ("add", "c"), "w1")])
    rt.update_batch("s", [(1, ("remove", "a"), "w0")])
    rt.update_batch("w", [(2, ("add", "x"), "w0"), (9, ("add", "y"), "w1")])
    rt.update_batch("m", [(4, ("update", [("update", ("G", "lasp_gset"), ("add", 1)),
                                          ("update", ("C", "riak_dt_gcounter"),
                                           ("increment", 2))]), "w2")])
    rt.step()  # one round: rows still differ
    return rt


def _twin_runtimes(packed):
    js = JStore(n_actors=4)
    jrt = _fill_runtime(js, JGraph(js), JRT, packed)
    ts = TStore(n_actors=4, device="cpu")
    trt = _fill_runtime(ts, TGraph(ts), TRT, packed, device="cpu")
    return jrt, trt


def _check_runtime_pair(jrt, trt):
    assert trt.n_replicas == jrt.n_replicas and trt.packed == jrt.packed
    assert np.array_equal(np.asarray(trt._host_neighbors), np.asarray(jrt.neighbors))
    assert trt.var_ids == jrt.var_ids
    for v in jrt.var_ids:
        _same(_jleaves(jrt.states[v]), _tleaves(trt.states[v]))
        assert np.array_equal(trt._frontier[v], jrt._frontier[v]), v


@pytest.mark.parametrize("packed", [False, True])
def test_runtime_checkpoints_read_by_both_packages(tmp_path, packed):
    jrt, trt = _twin_runtimes(packed)
    _check_runtime_pair(jrt, trt)
    jpath, tpath = str(tmp_path / "j.lasp"), str(tmp_path / "t.lasp")
    jck.save_runtime(jrt, jpath)
    tck.save_runtime(trt, tpath)
    pairs = [
        (jck.load_runtime(jpath), tck.load_runtime(jpath, device="cpu")),
        (jck.load_runtime(tpath), tck.load_runtime(tpath, device="cpu")),
    ]
    for jl, tl in pairs:
        _check_runtime_pair(jrt, tl)
        _check_runtime_pair(jl, tl)
        # restored rows are all-dirty; both converge alike
        assert tl.run_to_convergence() == jl.run_to_convergence()
        _check_runtime_pair(jl, tl)
        for v in ("s", "w", "m"):
            assert tl.coverage_value(v) == jl.coverage_value(v)
            assert tl.divergence(v) == jl.divergence(v) == 0


@pytest.mark.parametrize("packed", [False, True])
def test_load_runtime_rows_then_reseed_row(tmp_path, packed):
    jrt, trt = _twin_runtimes(packed)
    path = str(tmp_path / "rows.lasp")
    tck.save_runtime(trt, path)
    for rt in (jrt, trt):
        rt.run_to_convergence()
        rt.update_batch("s", [(3, ("add", "later"), "w3")])
    jrows = jck.load_runtime_rows(path, 2)
    trows = tck.load_runtime_rows(path, 2)
    for v in jrows:
        _same([np.asarray(x) for x in jrows[v]], trows[v])
    jrt.reseed_row(2, jrows)
    trt.reseed_row(2, trows)
    _check_runtime_pair(jrt, trt)
    # the restored row is the saved one
    saved = tck.load_runtime(path, device="cpu")
    for v in trt.var_ids:
        _same([x[2] for x in _tleaves(saved.states[v])],
              [x[2] for x in _tleaves(trt.states[v])])
    assert trt.run_to_convergence(mode="dense") == jrt.run_to_convergence(mode="dense")
    _check_runtime_pair(jrt, trt)
    with pytest.raises(IndexError, match="out of range"):
        tck.load_runtime_rows(path, 12)


@pytest.mark.parametrize("packed", [False, True])
def test_elastic_load_runtime(tmp_path, packed):
    jrt, trt = _twin_runtimes(packed)
    path = str(tmp_path / "e.lasp")
    tck.save_runtime(trt, path)
    for n in (20, 5):
        nb = random_regular(n, 3, seed=n)
        jl = jck.load_runtime(path, n_replicas=n, neighbors=nb)
        tl = tck.load_runtime(path, n_replicas=n, neighbors=nb, device="cpu")
        _check_runtime_pair(jl, tl)
        assert tl.membership_epoch == jl.membership_epoch == 1
        assert tl.run_to_convergence() == jl.run_to_convergence()
        _check_runtime_pair(jl, tl)
    tl = tck.load_runtime(path, neighbors=ring(12, 2), device="cpu")  # swap only
    assert tl.membership_epoch == 1
    with pytest.raises(ValueError, match="neighbors"):
        tck.load_runtime(path, n_replicas=5, device="cpu")


# -- the tombs backfill gate (tests/store/test_checkpoint_gate.py) ------------------


class _FakeHS:
    def __init__(self, records):
        self._r = dict(records)

    def get(self, key):
        return self._r.get(key)


def _map_var(reset: bool):
    store = TStore(n_actors=4, device="cpu")
    if reset:
        m = store.declare(id="m", type="riak_dt_map", n_actors=4, reset_on_readd=True,
                          fields=[(("C", "riak_dt_gcounter"), "riak_dt_gcounter",
                                   {"n_actors": 4})])
        store.update(m, ("update", [("update", ("C", "riak_dt_gcounter"),
                                     ("increment", 3))]), "w")
    else:
        m = store.declare(id="m", type="riak_dt_map", n_actors=4,
                          fields=[(("G", "lasp_gset"), "lasp_gset", {"n_elems": 4})])
        store.update(m, ("update", [("update", ("G", "lasp_gset"), ("add", "a"))]), "w")
    return store.variable(m)


def _prefix(var, keep):
    leaves = tck._np_leaves(var.state)
    entry = {"type_name": var.type_name,
             "leaves": [(str(x.dtype), x.shape) for x in leaves][:keep]}
    return _FakeHS({f"leaf/m/{i}": x.tobytes() for i, x in enumerate(leaves[:keep])}), entry


def test_tombs_backfill_gate():
    from lasp_tpu_torch.lattice.base import tree_leaves

    var = _map_var(reset=True)
    n_tombs = len(tree_leaves(var.state.tombs))
    total = len(tree_leaves(var.state))
    assert n_tombs >= 1
    hs, entry = _prefix(var, total - n_tombs)
    out = tck._get_state(hs, "m", var.state, entry)
    _same(_tleaves(out), _tleaves(var.state))
    hs, entry = _prefix(var, total - n_tombs - 1)  # one non-tombs leaf short
    with pytest.raises(IOError, match="truncated"):
        tck._get_state(hs, "m", var.state, entry)
    plain = _map_var(reset=False)  # a default-mode map has no tombs planes
    hs, entry = _prefix(plain, len(tree_leaves(plain.state)) - 1)
    with pytest.raises(IOError, match="truncated"):
        tck._get_state(hs, "m", plain.state, entry)
    store = TStore(n_actors=4, device="cpu")
    store.declare(id="m", type="lasp_orset", n_elems=4, n_actors=2)
    orset = store.variable("m")
    hs, entry = _prefix(orset, 1)
    with pytest.raises(IOError, match="truncated"):
        tck._get_state(hs, "m", orset.state, entry)


def test_pre_tombs_reset_map_snapshot_from_jax_migrates(tmp_path):
    js = JStore(n_actors=4)
    m = js.declare(id="kvs", type="riak_dt_map", reset_on_readd=True,
                   fields=[(("Y", "riak_dt_gcounter"), "riak_dt_gcounter", {})])
    ky = ("Y", "riak_dt_gcounter")
    js.update(m, ("update", [("update", ky, ("increment", 3))]), "r1")
    var = js.variable(m)
    var.state = var.state._replace(tombs=None)  # the older leaf layout
    path = str(tmp_path / "old.log")
    jck.save_store(js, path)
    restored = tck.load_store(path, device="cpu")
    assert restored.value(m)[ky] == 3
    restored.update(m, ("update", [("remove", ky)]), "r1")
    restored.update(m, ("update", [("update", ky, ("increment", 4))]), "r1")
    assert restored.value(m)[ky] == 4


# -- the restricted unpickler ------------------------------------------------------


class _Evil:
    def __reduce__(self):
        import os

        return (os.system, ("true",))


def test_unpickler_refuses_foreign_globals(tmp_path):
    payload = pickle.dumps({"kind": "store", "vars": {}, "bomb": _Evil()})
    with pytest.raises(pickle.UnpicklingError, match="may not reference"):
        tck.loads_manifest(payload)
    path = str(tmp_path / "evil.lasp")
    with ths.HostStore(path) as hs:
        hs.put("manifest", payload)
    with pytest.raises(pickle.UnpicklingError):
        tck.load_store(path, device="cpu")
    # the JAX package's other modules are refused, not imported
    from lasp_tpu.mesh.plan import PlanGroup

    with pytest.raises(pickle.UnpicklingError, match="may not reference"):
        tck.loads_manifest(pickle.dumps(PlanGroup))
    # a lattice / ops name the port lacks is refused cleanly
    with pytest.raises(pickle.UnpicklingError, match="does not have"):
        tck.loads_manifest(pickle.dumps(jhs.HostStore).replace(
            b"lasp_tpu.store.host_store", b"lasp_tpu.lattice.nonesuch"))


def test_writer_names_the_jax_classes():
    from lasp_tpu.lattice.map import MapSpec as JMapSpec
    from lasp_tpu_torch.store.store import Store

    store = Store(n_actors=2, device="cpu")
    store.declare(id="m", type="riak_dt_map",
                  fields=[(("G", "lasp_gset"), "lasp_gset", {"n_elems": 4})])
    spec = store.variable("m").spec
    raw = tck.dumps_manifest({"spec": spec})
    assert b"lasp_tpu_torch" not in raw
    got = jck.loads_manifest(raw)["spec"]
    assert isinstance(got, JMapSpec)
    assert got.fields[0][1].__module__ == "lasp_tpu.lattice.gset"
    back = tck.loads_manifest(raw)["spec"]
    assert back == spec
