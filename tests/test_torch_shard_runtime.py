"""``ReplicatedRuntime.shard`` of the port over 8 virtual ``cpu`` shard
slots against ``lasp_tpu``'s runtime over JAX's 8 CPU devices, tolerance
zero: twins of ``tests/mesh/test_shard_frontier.py`` and of the engine half
of ``tests/mesh/test_partitioned_gossip.py`` — the sparse frontier round,
grouped and singleton members, the hierarchical converge's exact rounds,
budget and resume, the halo lifecycle (converge then writes, the dense
crossover, compaction, resize, re-shard), the exchange accounting and the
monitor's probe, the refusals, the joint slices layout, ``read_until`` and
a checkpoint under partition — and the sharded scenarios
``partitioned_gossip`` and ``mesh_scale`` at small shapes."""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import lasp_tpu.bench_scenarios as jbench
import lasp_tpu.dataflow as jdf
import lasp_tpu.mesh as jmesh
import lasp_tpu.store as jstore
import lasp_tpu.telemetry as jtel
import lasp_tpu_torch.bench_scenarios as tbench
import lasp_tpu_torch.dataflow as tdf
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.store as tstore
import lasp_tpu_torch.telemetry as ttel
from lasp_tpu.mesh.topology import locality_order, random_regular, ring, scale_free
from lasp_tpu_torch.bridge_state import to_numpy
from lasp_tpu_torch.lattice.base import tree_leaves as ttree_leaves
from lasp_tpu_torch.mesh import shard_gossip as tsg
from lasp_tpu_torch.mesh.comm import Mesh, build_mesh

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    for tel in (jtel, ttel):
        tel.reset()
        tel.events.clear()
        tel.device.clear()
    yield
    for tel in (jtel, ttel):
        tel.events.clear()
        tel.device.clear()
        tel.reset()


PORT = types.SimpleNamespace(
    port=True, Graph=tdf.Graph,
    Store=lambda **kw: tstore.Store(device="cpu", **kw),
    RT=lambda *a, **kw: tmesh.ReplicatedRuntime(*a, device="cpu", **kw),
    mesh=lambda: Mesh(CPU8, ("replicas",)),
)
JAX = types.SimpleNamespace(
    port=False, Graph=jdf.Graph, Store=jstore.Store, RT=jmesh.ReplicatedRuntime,
    mesh=lambda: JMesh(np.array(jax.devices()[:8]), ("replicas",)),
)


def _topo(n, seed=3):
    return locality_order(scale_free(n, 3, seed=seed))[1]


def _build(pkg, n=96, seed=3, codec="gset", n_vars=1, packed=False, plan="auto"):
    store = pkg.Store(n_actors=8)
    ids = []
    for i in range(n_vars):
        if codec == "gset":
            ids.append(store.declare(id=f"v{i}", type="lasp_gset", n_elems=16))
        elif codec == "orswot":
            ids.append(store.declare(id=f"v{i}", type="riak_dt_orswot",
                                     n_elems=8, n_actors=4))
        else:
            ids.append(store.declare(id=f"v{i}", type="lasp_orset", n_elems=8))
    rt = pkg.RT(store, pkg.Graph(store), n, _topo(n, seed), packed=packed, plan=plan)
    for i, v in enumerate(ids):
        rt.update_at((7 * i + 1) % n, v, ("add", "a"), f"w{i}")
        rt.update_at((n // 2 + i) % n, v, ("add", "b"), f"x{i}")
    return rt, ids


def _np(state) -> list:
    """Host leaves of either package's population."""
    if isinstance(ttree_leaves(state)[0], torch.Tensor):
        return [np.asarray(x) for x in to_numpy(state)]
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _same(a, b) -> bool:
    la, lb = _np(a), _np(b)
    return len(la) == len(lb) and all(
        np.array_equal(x.view(np.int32) if x.dtype == np.uint32 else x,
                       y.view(np.int32) if y.dtype == np.uint32 else y)
        for x, y in zip(la, lb))


def _shard(rt, pkg, mode="alltoall"):
    rt.shard(pkg.mesh(), axis="replicas", partition=True, partition_mode=mode)


# -- the sparse frontier round ------------------------------------------------------


@pytest.mark.parametrize("mode,codec,packed", [
    ("gather", "gset", False),
    ("alltoall", "orswot", False),
    ("alltoall", "orset", True),
    ("gather", "orset", True),
])
def test_sparse_frontier_bit_identical_per_round(mode, codec, packed):
    jf, ids = _build(JAX, codec=codec, packed=packed)
    tf, _ = _build(PORT, codec=codec, packed=packed)
    td, _ = _build(PORT, codec=codec, packed=packed)
    ref, _ = _build(PORT, codec=codec, packed=packed)
    _shard(jf, JAX, mode)
    _shard(tf, PORT, mode)
    _shard(td, PORT, mode)
    for rnd in range(64):
        rj, rf, rd, rr = jf.frontier_step(), tf.frontier_step(), td.step(), ref.step()
        assert rj == rf == rd == rr, (rnd, rj, rf, rd, rr)
        assert tf.part_exchange_rows_last == jf.part_exchange_rows_last, rnd
        for v in ids:
            assert _same(jf.states[v], tf.states[v]), (rnd, v)
            assert _same(tf.states[v], td.states[v]), (rnd, v)
            assert _same(tf.states[v], ref.states[v]), (rnd, v)
        if rd == 0:
            break
    assert rd == 0
    assert tf.part_exchange_bytes_total == jf.part_exchange_bytes_total
    assert tf.part_dense_plane_bytes_total == jf.part_dense_plane_bytes_total
    assert tf.divergence(ids[0]) == 0


def test_grouped_and_singleton_members_match_plan_off():
    def mixed(pkg, plan):
        store = pkg.Store(n_actors=8)
        a = store.declare(id="a", type="lasp_gset", n_elems=16)
        b = store.declare(id="b", type="lasp_gset", n_elems=16)
        c = store.declare(id="c", type="riak_dt_orswot", n_elems=8, n_actors=4)
        rt = pkg.RT(store, pkg.Graph(store), 96, _topo(96), plan=plan)
        rt.update_at(1, a, ("add", "p"), "w0")
        rt.update_at(50, b, ("add", "q"), "w1")
        rt.update_at(9, c, ("add", "r"), "w2")
        return rt, (a, b, c)

    rj, ids = mixed(JAX, "auto")
    rg, _ = mixed(PORT, "auto")
    rs, _ = mixed(PORT, "off")
    rd, _ = mixed(PORT, "auto")
    _shard(rj, JAX, "gather")
    for rt in (rg, rs, rd):
        _shard(rt, PORT, "gather")
    assert any(len(g.var_ids) > 1 for g in rg._ensure_plan().groups)
    for rnd in range(64):
        a, b, c, d = rj.frontier_step(), rg.frontier_step(), rs.frontier_step(), rd.step()
        assert a == b == c == d, (rnd, a, b, c, d)
        for v in ids:
            assert _same(rj.states[v], rg.states[v]), (rnd, v)
            assert _same(rg.states[v], rs.states[v]), (rnd, v)
            assert _same(rg.states[v], rd.states[v]), (rnd, v)
        if d == 0:
            break
    assert d == 0
    assert rg.part_exchange_bytes_total == rj.part_exchange_bytes_total


def test_run_to_convergence_auto_takes_frontier_path():
    rt, ids = _build(PORT)
    twin, _ = _build(PORT)
    _shard(rt, PORT)
    reg = ttel.registry.get_registry()
    frontier_rounds = reg.counter("gossip_frontier_rounds_total",
                                  help="frontier-scheduled gossip rounds executed")
    before = frontier_rounds.value
    r_auto = rt.run_to_convergence(mode="auto")
    r_dense = 0
    while True:
        r_dense += 1
        if twin.step() == 0:
            break
    assert r_auto == r_dense
    assert frontier_rounds.value > before
    for v in ids:
        assert _same(rt.states[v], twin.states[v])


def test_auto_fallback_on_dataflow_edges_partitioned():
    store = PORT.Store(n_actors=8)
    s = store.declare(id="s", type="lasp_orset", n_elems=16)
    graph = PORT.Graph(store)
    graph.map(s, lambda x: f"m:{x}", dst="out", dst_elems=32)
    rt = PORT.RT(store, graph, 96, _topo(96))
    rt.update_at(0, s, ("add", "a"), "w0")
    _shard(rt, PORT)
    rt.run_to_convergence(mode="auto", max_rounds=64)
    assert rt.coverage_value("out") == frozenset({"m:a"})
    with pytest.raises(RuntimeError, match="frontier gossip"):
        rt.run_to_convergence(mode="frontier", max_rounds=4)


# -- the hierarchical converge ------------------------------------------------------


@pytest.mark.parametrize("mode,window", [("gather", 1), ("gather", 8), ("alltoall", 4)])
def test_hier_converge_exact_rounds_one_dispatch(mode, window):
    rj, ids = _build(JAX, codec="orswot")
    rt, _ = _build(PORT, codec="orswot")
    host, _ = _build(PORT, codec="orswot")
    _shard(rj, JAX, mode)
    _shard(rt, PORT, mode)
    host_rounds = 0
    while True:
        host_rounds += 1
        if host.step() == 0:
            break
    rows_before = len(rt.round_residuals)
    tsg.reset_exchange()
    r = rt.converge_on_device(sync_every=window)
    assert r == host_rounds == rj.converge_on_device(sync_every=window)
    assert len(rt.round_residuals) == rows_before + 1  # one dispatch, one row
    # one host read (one psum) a window
    assert tsg.EXCHANGED["psum"]["calls"] == -(-r // window)
    for v in ids:
        assert _same(rt.states[v], host.states[v])
        assert _same(rt.states[v], rj.states[v])
    assert rt.converge_on_device(sync_every=window) == 1


def test_hier_converge_budget_and_resume():
    rt, ids = _build(PORT)
    rj, _ = _build(JAX)
    _shard(rt, PORT)
    _shard(rj, JAX)
    host, _ = _build(PORT)
    host_rounds = 0
    while True:
        host_rounds += 1
        if host.step() == 0:
            break
    signed = rt.converge_on_device(max_rounds=2, strict=False, sync_every=4)
    assert signed == rj.converge_on_device(max_rounds=2, strict=False,
                                          sync_every=4) == -2
    rt2, _ = _build(PORT)
    _shard(rt2, PORT)
    with pytest.raises(RuntimeError, match="no convergence within"):
        rt2.converge_on_device(max_rounds=2, sync_every=4)
    assert rt.converge_on_device(sync_every=4) == host_rounds - 2
    for v in ids:
        assert _same(rt.states[v], host.states[v])


def test_hier_converge_flight_ring_matches_jax():
    rt, ids = _build(PORT, n_vars=2)
    rj, _ = _build(JAX, n_vars=2)
    _shard(rt, PORT)
    _shard(rj, JAX)
    assert rt.converge_on_device(sync_every=4) == rj.converge_on_device(sync_every=4)
    got = ttel.device.last_window("converge")
    want = jtel.device.last_window("converge")
    assert got.records == want.records and got.rounds == want.rounds
    assert tuple(got.columns) == tuple(want.columns)


# -- the halo lifecycle ---------------------------------------------------------------


def test_halo_survives_converge_then_writes():
    rt, ids = _build(PORT, n_vars=2)
    twin, _ = _build(PORT, n_vars=2)
    _shard(rt, PORT)
    _shard(twin, PORT)
    rt.converge_on_device()
    while twin.step():
        pass
    assert not rt._part_halo  # the opaque block dropped every halo
    for i, v in enumerate(ids):
        rt.update_at(11 + i, v, ("add", "late"), f"l{i}")
        twin.update_at(11 + i, v, ("add", "late"), f"l{i}")
    for rnd in range(64):
        rf, rd = rt.frontier_step(), twin.step()
        assert rf == rd, rnd
        for v in ids:
            assert _same(rt.states[v], twin.states[v]), (rnd, v)
        if rd == 0:
            break
    assert rd == 0


def test_halo_survives_dense_crossover_interleaving():
    rt, ids = _build(PORT)
    twin, _ = _build(PORT)
    _shard(rt, PORT)
    _shard(twin, PORT)
    rt.frontier_crossover = 0.05  # almost everything takes the dense arm
    for wave in range(2):
        for rnd in range(64):
            rf, rd = rt.frontier_step(), twin.step()
            assert rf == rd, (wave, rnd)
            assert _same(rt.states[ids[0]], twin.states[ids[0]]), (wave, rnd)
            if rd == 0:
                break
        assert rd == 0
        rt.frontier_crossover = 0.25
        rt.update_at(2, ids[0], ("add", "z"), "zz")
        twin.update_at(2, ids[0], ("add", "z"), "zz")


def test_compaction_drops_halo():
    def build(pkg):
        store = pkg.Store(n_actors=8)
        s = store.declare(id="s", type="lasp_orset", n_elems=8)
        rt = pkg.RT(store, pkg.Graph(store), 96, _topo(96))
        rt.update_at(1, s, ("add", "keep"), "w0")
        rt.update_at(50, s, ("add", "drop"), "w1")
        return rt, s

    rt, s = build(PORT)
    ref, _ = build(PORT)
    _shard(rt, PORT)
    rt.frontier_crossover = 1.0  # sparse only: halos stay live
    for r in (rt, ref):
        seq = r.frontier_step if r is rt else r.step
        while seq():
            pass
        r.update_at(7, s, ("remove", "drop"), "w1")
        while seq():
            pass
    assert rt._part_halo
    assert rt.compact_orset(s) == ref.compact_orset(s) > 0
    assert s not in rt._part_halo
    hot = int(rt._partition["plan"]["cut_rows"][0])
    for r in (rt, ref):
        r.update_at(hot, s, ("add", "after"), "w2")
    for rnd in range(64):
        rf, rd = rt.frontier_step(), ref.step()
        assert rf == rd, rnd
        assert _same(rt.states[s], ref.states[s]), rnd
        if rd == 0:
            break
    assert rd == 0
    assert rt.coverage_value(s) == frozenset({"keep", "after"})


def test_exchange_accounting_and_probe():
    from lasp_tpu.telemetry.convergence import get_monitor as jmon
    from lasp_tpu_torch.telemetry.convergence import get_monitor as tmon

    runs = {}
    for pkg in (PORT, JAX):
        rt, ids = _build(pkg, n=256)
        _shard(rt, pkg)
        rt.frontier_crossover = 1.0
        while rt.frontier_step():
            pass
        assert rt._part_halo
        hot = int(rt._partition["plan"]["cut_rows"][0])
        rt.update_at(hot, ids[0], ("add", "s2"), "s2")
        xb0, db0 = rt.part_exchange_bytes_total, rt.part_dense_plane_bytes_total
        rt.frontier_step()  # a one-row dirty set: payload << plane
        payload = rt.part_exchange_bytes_total - xb0
        plane = rt.part_dense_plane_bytes_total - db0
        assert 0 < payload < plane
        probe = (tmon if pkg.port else jmon)().probe(rt)
        runs[pkg.port] = (payload, plane, rt.part_exchange_rows_last, probe)
    assert runs[True][:3] == runs[False][:3]
    got, want = runs[True][3], runs[False][3]
    assert got["n_shards"] == want["n_shards"] == 8
    assert got["shard_lag"] == want["shard_lag"]
    for key in ("frontier_cut_rows", "cut_rows", "shard_exchange"):
        assert got[key] == want[key], key
    assert got["shard_exchange"]["interior_overlap_frac"] is not None


def test_resize_and_reshard_drop_halos_and_keep_serving():
    rt, ids = _build(PORT)
    _shard(rt, PORT)
    rt.frontier_crossover = 1.0
    while rt.frontier_step():
        pass
    assert rt._part_halo
    rt.resize(104, random_regular(104, 3, seed=9))
    assert not rt._part_halo and rt._partition is None
    assert rt._frontier_shards is None
    rt.run_to_convergence(mode="auto", max_rounds=128)
    assert rt.divergence(ids[0]) == 0
    # re-sharding without partition returns to the gather path
    rt2, _ = _build(PORT)
    _shard(rt2, PORT)
    rt2.shard(PORT.mesh(), axis="replicas")
    assert rt2._partition is None and rt2._frontier_shards == 8
    rt2.run_to_convergence(mode="auto", max_rounds=128)
    assert rt2.divergence(ids[0]) == 0


# -- the engine step under shard(partition=True) ------------------------------------


def _edged(pkg, n=256, seed=3):
    store = pkg.Store(n_actors=8)
    s = store.declare(id="s", type="lasp_orset", n_elems=16)
    graph = pkg.Graph(store)
    graph.map(s, lambda x: f"m:{x}", dst="out", dst_elems=32)
    rt = pkg.RT(store, graph, n, _topo(n, seed))
    rt.update_at(0, s, ("add_all", ["a", "b"]), "w0")
    rt.update_at(n // 2, s, ("add", "c"), "w1")
    return rt, s


@pytest.mark.parametrize("mode", ["gather", "alltoall"])
def test_engine_step_partitioned_matches_unsharded(mode):
    rt, s = _edged(PORT)
    ref, _ = _edged(PORT)
    rj, _ = _edged(JAX)
    _shard(rt, PORT, mode)
    _shard(rj, JAX, mode)
    assert rt._partition["mode"] == mode
    for rnd in range(64):
        a, b, c = rt.step(), ref.step(), rj.step()
        assert a == b == c, rnd
        for v in (s, "out"):
            assert _same(rt.states[v], ref.states[v]), (rnd, v)
            assert _same(rt.states[v], rj.states[v]), (rnd, v)
        if a == 0:
            break
    assert a == 0
    assert rt.coverage_value(s) == frozenset({"a", "b", "c"})
    assert rt.coverage_value("out") == rj.coverage_value("out")


def test_partitioned_dense_step_runs_k1_per_shard(monkeypatch):
    """Packed OR-Set planes take the K1 wrapper once a shard, on the shard's
    ``[block | received]`` source of B + H rows writing B rows."""
    from lasp_tpu_torch.ops import cuda_gossip

    calls = []
    inner = cuda_gossip.gossip_round_dense

    def recording(exists, removed, neighbors, out=None):
        calls.append((tuple(exists.shape), tuple(neighbors.shape)))
        return inner(exists, removed, neighbors, out=out)

    monkeypatch.setattr(cuda_gossip, "gossip_round_dense", recording)
    rt, ids = _build(PORT, n=128, codec="orset", packed=True)
    twin, _ = _build(PORT, n=128, codec="orset", packed=True)
    _shard(rt, PORT, "gather")
    calls.clear()
    assert rt.step() == twin.step()
    h = 8 * rt._partition["plan"]["m"]
    assert calls == [((16 + h, calls[0][0][1]), (16, 3))] * 8
    assert _same(rt.states[ids[0]], twin.states[ids[0]])


def test_engine_step_partitioned_rejects_edge_mask_and_shift():
    rt, _s = _edged(PORT, n=64)
    _shard(rt, PORT)
    with pytest.raises(ValueError, match="edge_mask"):
        rt.step(edge_mask=np.ones((64, 3), dtype=bool))
    plain, _ids = _build(PORT, n=64)
    _shard(plain, PORT)
    with pytest.raises(ValueError, match="edge_mask"):
        plain.frontier_step(edge_mask=np.ones((64, 3), dtype=bool))
    store = PORT.Store(n_actors=4)
    store.declare(id="x", type="lasp_gset", n_elems=4)
    rt2 = PORT.RT(store, PORT.Graph(store), 64, ring(64, 2))
    with pytest.raises(ValueError, match="shift-structured"):
        _shard(rt2, PORT)
    assert rt2._partition is None


def test_failed_partition_reshard_leaves_runtime_intact():
    rt, s = _edged(PORT, n=64)
    _shard(rt, PORT)
    rt.run_to_convergence(max_rounds=32)
    plan_before = rt._partition["plan"]
    with pytest.raises(ValueError, match="not (found )?in mesh"):
        rt.shard(PORT.mesh(), axis="no_such_axis", partition=True)
    with pytest.raises(ValueError, match="partition_mode"):
        rt.shard(PORT.mesh(), axis="replicas", partition=True,
                 partition_mode="broadcast")
    assert rt._partition["plan"] is plan_before
    rt.update_at(5, s, ("add", "d"), "w5")
    rt.run_to_convergence(max_rounds=32)
    assert rt.divergence(s) == 0


@pytest.mark.parametrize("partition", [True, False])
def test_shard_refuses_a_mesh_on_another_device(partition):
    rt, s = _edged(PORT, n=64)
    before = [x.clone() for x in ttree_leaves(rt.states[s])]
    with pytest.raises(ValueError, match="meta.*cpu"):
        rt.shard(Mesh([torch.device("meta")] * 8, ("replicas",)),
                 axis="replicas", partition=partition)
    assert rt.device == torch.device("cpu") and rt._partition is None
    assert all(torch.equal(a, b) for a, b in zip(before, ttree_leaves(rt.states[s])))
    rt.update_at(5, s, ("add", "d"), "w5")
    rt.run_to_convergence(max_rounds=32)
    assert rt.divergence(s) == 0


def test_engine_step_partitioned_joint_slices_layout():
    rt, s = _edged(PORT)
    ref, _ = _edged(PORT)
    rt.shard(build_mesh(devices=CPU8, slice_of=lambda i: i % 2), partition=True)
    assert rt._partition["axis"] == ("slices", "replicas")
    assert rt._partition["plan"]["n_shards"] == 8
    assert rt.run_to_convergence(max_rounds=64) == ref.run_to_convergence(max_rounds=64)
    assert rt.divergence(s) == 0
    for v in (s, "out"):
        assert _same(rt.states[v], ref.states[v])


def test_read_until_and_checkpoint_under_partition(tmp_path):
    from lasp_tpu_torch.store import load_runtime, save_runtime

    rt, s = _edged(PORT, n=64)
    _shard(rt, PORT)
    rt.update_at(0, s, ("add", "blocking"), "w9")
    zero = type(rt.states[s])(*(x[40] * 0 for x in rt.states[s]))
    from lasp_tpu_torch.lattice import Threshold

    assert rt.read_until(40, s, Threshold(zero, strict=True), max_rounds=64) is not None
    rt.run_to_convergence(max_rounds=64)
    want = rt.coverage_value(s)
    assert "blocking" in want
    path = str(tmp_path / "part_rt.log")
    save_runtime(rt, path)
    restored = load_runtime(path, device="cpu")
    restored.run_to_convergence(max_rounds=64)
    assert restored.coverage_value(s) == want
    _shard(restored, PORT)
    restored.update_at(3, s, ("add", "post-restore"), "w10")
    restored.run_to_convergence(max_rounds=64)
    assert restored.coverage_value(s) == want | {"post-restore"}


def test_session_runtime_shards():
    from lasp_tpu_torch.api.session import Session

    sess = Session(n_actors=4, device="cpu")
    sess.declare(id="g", type="lasp_gset", n_elems=8)
    rt = sess.replicate(64, topology="scale_free", fanout=3, locality=False)
    rt.update_at(3, "g", ("add", "x"), "w")
    _shard(rt, PORT)
    rt.run_to_convergence(mode="auto", max_rounds=64)
    assert rt.coverage_value("g") == frozenset({"x"}) and rt.divergence("g") == 0


# -- the sharded scenarios ----------------------------------------------------------


def test_partitioned_gossip_scenario_equals_jax():
    got = tbench.partitioned_gossip(n_replicas=512, rounds=2, device="cpu")
    want = jbench.partitioned_gossip(n_replicas=512, rounds=2)
    for key in ("scenario", "n_replicas", "n_shards", "cut",
                "dense_allgather_bytes_per_round",
                "exchange_allgather_bytes_per_round", "alltoall_bytes_per_round",
                "wire_reduction", "wire_reduction_alltoall", "check"):
        assert got[key] == want[key], key
    assert got["alltoall_buffer_bytes_per_round"] == 8 * got["alltoall_bytes_per_round"]


def test_mesh_scale_scenario_equals_jax():
    got = tbench.mesh_scale(n_replicas=1 << 11, cycles=1, device="cpu")
    want = jbench.mesh_scale(n_replicas=1 << 11, cycles=1)
    for key in ("scenario", "n_replicas", "n_shards", "cut_rows", "per_shard",
                "rounds_to_quiescence", "cut_rows_sparse_bytes",
                "cut_rows_dense_bytes", "wire_cut_total", "wire_cut_at_5pct_dirty",
                "wire_gate", "interior_overlap_frac", "write_density"):
        assert got[key] == want[key], key
    strip = [{k: v for k, v in r.items()} for r in got["per_round"]]
    assert strip == want["per_round"]
    assert got["hier_converge"]["rounds"] == want["hier_converge"]["rounds"] == (
        got["hier_converge"]["host_loop_rounds"])
    # the card's row (peak_GBps) makes roofline_frac non-null; the CPU has none
    assert got["impl_roofline"]["shard_exchange"]["achieved_GBps"] is not None
