"""The port's open-loop load harness (``lasp_tpu_torch.serve.harness``)
against ``lasp_tpu.serve.harness``: twins of ``tests/serve/test_load.py``
(steady state, a burst through the ladder, chaos with the composite
nemesis, deadlines under pressure, replay determinism) and of the
vectorized threshold parity. Reports are equal key for key, per-tick
traces included, wall-clock overlap seconds aside."""

import numpy as np
import pytest
import torch

import lasp_tpu.telemetry as jtel
from lasp_tpu.mesh.topology import random_regular
from lasp_tpu.serve import harness as jh
from lasp_tpu_torch.serve import harness as th

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_telemetry_fresh():
    """The JAX runs here emit into ``lasp_tpu``'s process-wide event ring
    and metric registry; each test leaves both as a fresh process has them,
    so a later test of that telemetry in the same worker (which reads the
    cumulative ``events_dropped_total``) sees none of these runs."""
    yield
    jtel.events.clear()
    jtel.reset()


def _both(**kw):
    want = jh.run_load(**kw)
    got = th.run_load(device="cpu", **kw)
    for rep in (want, got):
        rep.pop("overlap_seconds")
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    return got


def test_small_run_steady_state():
    rep = _both(n_replicas=12, n_clients=200, ticks=6, n_vars=3,
                arrivals_per_tick=50, seed=3, seed_watches=40, record_trace=True)
    offered = sum(rep["offered"].values())
    terminal = (sum(rep["completed"].values()) + sum(rep["errors"].values())
                + sum(rep["expired"].values()) + sum(rep["shed"].values()))
    assert offered == terminal + rep["watch_parked_final"]
    assert rep["no_write_lost"] is True


def test_burst_sheds_typed_and_ladder_climbs():
    rep = _both(n_replicas=12, n_clients=200, ticks=9, n_vars=3,
                arrivals_per_tick=70,
                capacity={"write": 128, "read": 128, "watch": 128},
                burst_at=3, burst_ticks=3, burst_factor=6, seed=5,
                record_trace=True)
    assert sum(rep["shed"].values()) > 0 and rep["ladder"]["max_level"] >= 1
    assert all(":" in k for k in rep["shed"]) and rep["client_retries"] > 0


def test_chaos_run_keeps_acked_writes_and_threshold_parity():
    rep = _both(n_replicas=16, n_clients=150, ticks=13, n_vars=3,
                arrivals_per_tick=40, chaos=True, seed=9,
                parity_thresholds=512, record_trace=True)
    assert rep["chaos"]["healed"] and rep["chaos"]["crashes"] == 2
    assert rep["threshold_parity"]["parity"] is True


def test_deadlines_expire_under_pressure():
    rep = _both(n_replicas=12, n_clients=100, ticks=8, n_vars=3,
                arrivals_per_tick=60,
                capacity={"write": 64, "read": 64, "watch": 64},
                burst_at=3, burst_ticks=4, burst_factor=8,
                deadline_ticks=2, seed=11)
    assert sum(rep["expired"].values()) > 0


def test_same_seed_replays_and_client_seed():
    kw = dict(n_replicas=12, n_clients=200, ticks=6, n_vars=3,
              arrivals_per_tick=60, seed_watches=20,
              capacity={"write": 96, "read": 96, "watch": 96},
              burst_at=2, burst_ticks=2, burst_factor=6, record_trace=True,
              device="cpu")
    r1 = th.run_load(seed=3, **kw)
    r2 = th.run_load(seed=3, **kw)
    r3 = th.run_load(seed=4, **kw)
    assert r1["trace"] and r1["trace"] == r2["trace"] != r3["trace"]
    for run_seed in (0, 7):
        for client in (0, 3, 999):
            assert th.client_seed(run_seed, client) == jh.client_seed(run_seed, client)


@pytest.mark.parametrize("n", [5, 24, 64])
def test_composite_nemesis_equals_jax(n):
    nbrs = random_regular(n, 3, seed=2)
    for seed in (0, 4):
        want = jh.composite_nemesis(n, nbrs, seed=seed, rounds=12)
        got = th.composite_nemesis(n, nbrs, seed=seed, rounds=12)
        assert [tuple(e) for e in got.events] == [tuple(e) for e in want.events]
        assert got.horizon == want.horizon
    with pytest.raises(ValueError):
        th.composite_nemesis(4, random_regular(4, 3, seed=2))


def test_threshold_parity_equals_jax():
    """``threshold_parity`` on the same counter population: the fired
    count of the batched pass (and the per-watch reference) equals JAX's."""
    import lasp_tpu.mesh as jmesh
    import lasp_tpu.store as jstore
    import lasp_tpu_torch.mesh as tmesh
    import lasp_tpu_torch.store as tstore
    from lasp_tpu.dataflow import Graph as JGraph
    from lasp_tpu.mesh import ring
    from lasp_tpu_torch.dataflow import Graph as TGraph

    out = []
    for port in (False, True):
        store = tstore.Store(n_actors=32, device="cpu") if port else jstore.Store(n_actors=32)
        store.declare(id="c", type="riak_dt_gcounter", n_actors=64)
        rt = (tmesh.ReplicatedRuntime(store, TGraph(store), 8, ring(8, 2), device="cpu")
              if port else jmesh.ReplicatedRuntime(store, JGraph(store), 8, ring(8, 2)))
        for i in range(40):
            rt.update_at(i % 8, "c", ("increment",), f"a{i % 8}")
        out.append((th if port else jh).threshold_parity(rt, "c", 3000, seed=11))
    assert out[0] == out[1] and out[1]["parity"] is True
    assert np.isfinite(out[1]["fired"])
