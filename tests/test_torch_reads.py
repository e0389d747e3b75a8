"""The port's parked reads and fused-block handle against ``lasp_tpu``'s:
``read_until`` / ``read_any_until`` (device-parked and host-probed),
``begin_fused_steps`` / ``FusedBlockHandle.finish`` and ``fused_steps``
(the read and handle cases of tests/mesh/test_fused_steps.py and
tests/serve/test_engine.py). Returned rows, states after the call,
``round_residuals`` against the JAX trace's residuals, and the same
``TimeoutError`` cases (tolerance zero)."""

import numpy as np
import pytest
import torch

import lasp_tpu.dataflow as jdf
import lasp_tpu.lattice as jlat
import lasp_tpu.mesh as jmesh
import lasp_tpu.store as jstore
import lasp_tpu_torch.dataflow as tdf
import lasp_tpu_torch.lattice as tlat
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.store as tstore
from lasp_tpu.mesh import random_regular, ring
from lasp_tpu_torch import bridge_state
from lasp_tpu_torch.mesh.runtime import _device_expressible

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)


def _pkg(port):
    if port:
        return tstore, tdf, tmesh, tlat, {"device": "cpu"}
    return jstore, jdf, jmesh, jlat, {}


def _counters(port, n=16, k=1, writes=(("c", 0, 5),)):
    st, df, mesh, _lat, kw = _pkg(port)
    store = st.Store(n_actors=2, **kw)
    for v in sorted({w[0] for w in writes}):
        store.declare(id=v, type="riak_dt_gcounter")
    rt = mesh.ReplicatedRuntime(store, df.Graph(store), n, ring(n, k), **kw)
    for v, r, by in writes:
        rt.update_batch(v, [(r, ("increment", by), "w")])
    return rt


def _twins(make, **kw):
    return make(False, **kw), make(True, **kw)


def _thr(port, state, strict=False):
    return _pkg(port)[3].Threshold(state, strict)


def _same(jrt, trt):
    for v in jrt.var_ids:
        for a, b in zip(bridge_state.to_numpy(trt.states[v]), jrt.states[v]):
            assert np.array_equal(a, np.asarray(b)), v
        assert np.array_equal(jrt._frontier[v], trt._frontier[v]), v
    assert trt.round_residuals == [r["residual"] for r in jrt.trace.rounds]


def _rows_equal(jrow, trow):
    for a, b in zip(bridge_state.to_numpy(trow), jrow):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("on_device", [True, False])
def test_read_until_matches_jax(on_device):
    jrt, trt = _twins(_counters)
    kw = {"on_device": on_device, "block": 4}
    rows = [rt.read_until(8, "c", _thr(port, 5), **kw)
            for port, rt in ((False, jrt), (True, trt))]
    _rows_equal(*rows)
    _same(jrt, trt)
    # already met: returns without stepping
    rows = [rt.read_until(8, "c", _thr(port, 5), **kw)
            for port, rt in ((False, jrt), (True, trt))]
    _rows_equal(*rows)
    _same(jrt, trt)
    # unreachable: the quiescent fast-fail with the labelled error
    for port, rt in ((False, jrt), (True, trt)):
        with pytest.raises(TimeoutError, match="unreachable"):
            rt.read_until(8, "c", _thr(port, 99), max_rounds=1000, **kw)
    _same(jrt, trt)


def test_read_until_budget_exhaustion_matches_jax():
    jrt, trt = _twins(_counters)
    msgs = []
    for port, rt in ((False, jrt), (True, trt)):
        with pytest.raises(TimeoutError) as ei:
            rt.read_until(8, "c", _thr(port, 5), max_rounds=2, on_device=True)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "unreachable" not in msgs[1]
    _same(jrt, trt)


def test_device_parked_stops_on_the_met_round():
    """The device wait stops on exactly the round that meets the threshold:
    the population is left as after that round (a host twin stepping one
    round at a time agrees), not after a block."""
    dev = _counters(True)
    host = _counters(True)
    row = dev.read_until(8, "c", tlat.Threshold(5), on_device=True)
    rounds = 0
    while host.read_at(8, "c", tlat.Threshold(5)) is None:
        host.step()
        rounds += 1
    assert rounds == 8 and int(row.counts.sum()) == 5
    for a, b in zip(dev.states["c"], host.states["c"]):
        assert torch.equal(a, b)
    # the replica just past the reader has not been reached yet
    assert dev.read_at(7, "c", tlat.Threshold(5)) is None


def test_read_until_auto_parks_on_device(monkeypatch):
    """The default wait pulls no row per round: ``read_at`` runs once, for
    the final met row; ``on_device=False`` probes every round."""
    def build():
        store = tstore.Store(n_actors=4, device="cpu")
        s = store.declare(id="w", type="lasp_orset", n_elems=64, tokens_per_actor=4)
        rt = tmesh.ReplicatedRuntime(store, tdf.Graph(store), 32, ring(32, 2),
                                     packed=True, device="cpu")
        rt.update_at(0, s, ("add", "seed"), "a0")
        return rt, s, rt.read_at(0, s)

    calls = {"n": 0}
    orig = tmesh.ReplicatedRuntime.read_at

    def counting(self, *a, **kw):
        calls["n"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(tmesh.ReplicatedRuntime, "read_at", counting)
    rt, s, want = build()
    calls["n"] = 0
    assert rt.read_until(16, s, tlat.Threshold(want), max_rounds=64) is not None
    assert calls["n"] == 1
    rt2, s2, want2 = build()
    calls["n"] = 0
    assert rt2.read_until(16, s2, tlat.Threshold(want2), max_rounds=64,
                          on_device=False) is not None
    assert calls["n"] > 2


def test_device_expressible_routing():
    assert _device_expressible(5)
    assert _device_expressible((np.zeros(3), np.ones((2, 2), bool)))
    assert _device_expressible((torch.zeros(3), torch.ones(2, dtype=torch.bool)))
    assert not _device_expressible(np.array([object()], dtype=object))
    assert not _device_expressible({"not", "arrayable"})


def test_read_until_quiescent_on_final_block_still_labeled():
    jrt, trt = _twins(_counters, n=8, k=2, writes=(("c", 0, 1),))
    for port, rt in ((False, jrt), (True, trt)):
        with pytest.raises(TimeoutError, match="unreachable"):
            rt.read_until(0, "c", _thr(port, 99), max_rounds=8, block=8)
    _same(jrt, trt)


@pytest.mark.parametrize("packed", [False, True])
def test_read_until_set_threshold_matches_jax(packed):
    """A set-typed threshold state (a separate store's OR-Set holding x)
    rides into the device wait, dense and packed."""
    rows = []
    rts = []
    for port in (False, True):
        st, df, mesh, lat, kw = _pkg(port)
        store = st.Store(n_actors=2, **kw)
        s = store.declare(id="s", type="lasp_orset", n_elems=4, n_actors=2,
                          tokens_per_actor=2)
        rt = mesh.ReplicatedRuntime(store, df.Graph(store), 16, ring(16, 2),
                                    packed=packed, **kw)
        rt.update_batch(s, [(0, ("add", "x"), "w")])
        probe = st.Store(n_actors=2, **kw)
        p = probe.declare(id="p", type="lasp_orset", n_elems=4, n_actors=2,
                          tokens_per_actor=2)
        probe.update(p, ("add", "x"), "w")
        rows.append(rt.read_until(9, s, lat.Threshold(probe.state(p)), on_device=True))
        rts.append(rt)
    _rows_equal(*rows)
    _same(*rts)


@pytest.mark.parametrize("on_device", [True, False])
def test_read_any_until_first_match_wins(on_device):
    writes = (("a", 0, 5), ("b", 9, 3))
    jrt, trt = _twins(_counters, writes=writes)
    hits = []
    for port, rt in ((False, jrt), (True, trt)):
        hits.append(rt.read_any_until(
            8, [("a", _thr(port, 5)), ("b", _thr(port, 3))], block=4,
            on_device=on_device))
    assert hits[0][0] == hits[1][0] == "b"
    _rows_equal(hits[0][1], hits[1][1])
    _same(jrt, trt)
    for port, rt in ((False, jrt), (True, trt)):
        with pytest.raises(TimeoutError, match="none is reachable"):
            rt.read_any_until(8, [("a", _thr(port, 99)), ("b", _thr(port, 99))],
                              max_rounds=500, block=4, on_device=on_device)
    _same(jrt, trt)
    # a same-round tie at the reader: list order wins
    for port, rt in ((False, jrt), (True, trt)):
        var, _row = rt.read_any_until(0, [("b", _thr(port, 0)), ("a", _thr(port, 0))],
                                      on_device=on_device)
        assert var == "b"
    with pytest.raises(ValueError, match="at least one read"):
        trt.read_any_until(0, [])


def test_read_max_rounds_zero_probes_once():
    jrt, trt = (_counters(p, n=8, k=2, writes=(("c", 3, 5),)) for p in (False, True))
    for port, rt in ((False, jrt), (True, trt)):
        row = rt.read_until(3, "c", _thr(port, 5), max_rounds=0)
        assert int(row.counts.sum()) == 5
        with pytest.raises(TimeoutError, match="within 0 rounds"):
            rt.read_until(0, "c", _thr(port, 5), max_rounds=0)
        var, _row = rt.read_any_until(3, [("c", _thr(port, 5))], max_rounds=0)
        assert var == "c"
    _same(jrt, trt)


def test_exit_protocol_overflow_guard():
    for port, rt in ((False, _counters(False)), (True, _counters(True))):
        with pytest.raises(ValueError, match="int32 exit protocol"):
            rt.read_any_until(8, [("c", _thr(port, 5))] * 4, max_rounds=2**28)


def test_device_met_with_host_disagreement_raises(monkeypatch):
    trt = _counters(True)
    monkeypatch.setattr(tmesh.ReplicatedRuntime, "read_at", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="host re-check disagrees"):
        trt.read_until(8, "c", tlat.Threshold(5), on_device=True)


@pytest.mark.parametrize("packed", [False, True])
def test_late_declared_variable_readable_on_all_paths(packed):
    st, df, mesh, lat, kw = _pkg(True)
    store = st.Store(n_actors=2, **kw)
    rt = mesh.ReplicatedRuntime(store, df.Graph(store), 8, ring(8, 2),
                                packed=packed, **kw)
    store.declare(id="late", type="lasp_orset", n_elems=4, n_actors=2,
                  tokens_per_actor=2)
    assert rt.coverage_value("late") == frozenset()
    rt.update_batch("late", [(0, ("add", "x"), "w")])
    assert rt.coverage_value("late") == frozenset({"x"})
    rt.run_to_convergence(block=4)
    assert rt.quorum_value("late", [3, 4]) == frozenset({"x"})
    store.declare(id="late_c", type="riak_dt_gcounter")
    rt.update_batch("late_c", [(0, ("increment", 2), "w")])
    row = rt.read_until(5, "late_c", lat.Threshold(2), on_device=True)
    assert row is not None and int(row.counts.sum()) == 2


# -- the fused-block handle ---------------------------------------------------


def _gsets(port, n=16, plan="auto"):
    st, df, mesh, _lat, kw = _pkg(port)
    store = st.Store(n_actors=4, **kw)
    store.declare(id="kv", type="lasp_gset", n_elems=16)
    store.declare(id="c", type="riak_dt_gcounter", n_actors=4)
    rt = mesh.ReplicatedRuntime(store, df.Graph(store), n,
                                random_regular(n, 3, seed=4), plan=plan, **kw)
    rt.update_at(0, "kv", ("add", "seed"), "c0")
    rt.update_batch("c", [(5, ("increment", 2), "a1")])
    return rt


def test_handle_is_deferred_and_idempotent():
    jrt, trt = _twins(_gsets)
    handle = trt.begin_fused_steps(4)
    assert handle.pending
    first = handle.finish()
    assert not handle.pending and handle.finish() == first
    assert jrt.fused_steps(4) == first
    _same(jrt, trt)
    assert sum("seed" in trt.replica_value("kv", r) for r in range(16)) > 1
    assert isinstance(trt.fused_steps(2), int)


@pytest.mark.parametrize("plan", ["auto", "off"])
def test_ingest_between_begin_and_finish_matches_jax(plan):
    """Writes issued before ``finish`` land on the window's outputs, as
    JAX's do on its output futures: the same return value and states as
    fused_steps followed by the same cycle, and JAX's marks and residuals
    (``finish`` settles the frontier after the cycle's marks, as JAX's
    does)."""
    jrt, trt = _twins(_gsets, plan=plan)
    twin = _gsets(True, plan=plan)
    cycle = {"kv": [(3, ("add", "b"), "c1"), (0, ("add", "seed"), "c0")],
             "c": [(9, ("increment",), "a2")]}
    results = []
    for rt in (jrt, trt):
        handle = rt.begin_fused_steps(8)
        rt.ingest_cycle(cycle)
        results.append(handle.finish())
    results.append(twin.fused_steps(8))
    twin.ingest_cycle(cycle)
    assert results[0] == results[1] == results[2]
    _same(jrt, trt)
    for v in trt.var_ids:
        for a, b in zip(trt.states[v], twin.states[v]):
            assert torch.equal(a, b)
    assert trt.run_to_convergence() == jrt.run_to_convergence()
    assert trt.coverage_value("kv") == {"seed", "b"}


def test_failed_sync_restores_the_states_before_the_window():
    trt = _gsets(True)
    before = {v: [x.clone() for x in trt.states[v]] for v in trt.var_ids}
    residuals = list(trt.round_residuals)
    handle = trt.begin_fused_steps(4)

    class Lost:
        def __int__(self):
            raise RuntimeError("lost device")

    handle._first_zero = Lost()
    with pytest.raises(RuntimeError, match="lost device"):
        handle.finish()
    for v in trt.var_ids:
        assert all(torch.equal(a, b) for a, b in zip(trt.states[v], before[v]))
    assert trt.round_residuals == residuals


def test_failed_enqueue_restores_the_states():
    trt = _gsets(True)
    before = {v: [x.clone() for x in trt.states[v]] for v in trt.var_ids}
    calls = {"n": 0}
    inner = trt._dense_round

    def flaky(edge_mask, tables):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("round 3 failed")
        return inner(edge_mask, tables)

    trt._dense_round = flaky
    with pytest.raises(RuntimeError, match="round 3 failed"):
        trt.begin_fused_steps(4)
    for v in trt.var_ids:
        assert all(torch.equal(a, b) for a, b in zip(trt.states[v], before[v]))
