"""The port's kernel cost ledger and capability row
(``lasp_tpu_torch.telemetry.roofline`` / ``.capability``) against
``lasp_tpu.telemetry``: the analytic half of
``tests/telemetry/test_roofline.py``, ``kernel_traffic`` equal to JAX's for
every family over a grid of shapes (``cuda_dense`` / ``cuda_rows`` held to
``pallas_dense`` / ``pallas_rows``), ``state_row_bytes`` for every codec,
the ledger's labels, totals and summary, the card's peak rows, and the
quorum step's ledger record twinned against
``tests/quorum/test_engine.py::test_quorum_step_lands_in_roofline_ledger``."""

import itertools
import time

import pytest
import torch

import lasp_tpu.mesh as jmesh
import lasp_tpu.quorum as jquorum
import lasp_tpu.store as jstore
import lasp_tpu.telemetry as jtel
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.quorum as tquorum
import lasp_tpu_torch.store as tstore
import lasp_tpu_torch.telemetry as ttel
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.mesh.topology import random_regular, ring
from lasp_tpu.telemetry import roofline as jroof
from lasp_tpu_torch.dataflow import Graph as TGraph
from lasp_tpu_torch.telemetry import capability as tcap
from lasp_tpu_torch.telemetry import registry as treg
from lasp_tpu_torch.telemetry import roofline as troof

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
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


#: the port's family -> JAX's (the CUDA kernels replace the Pallas ones)
JAX_FAMILY = {"cuda_dense": "pallas_dense", "cuda_rows": "pallas_rows"}


def test_families_are_jax_with_the_cuda_kernels():
    assert tuple(JAX_FAMILY.get(f, f) for f in troof.FAMILIES) == jroof.FAMILIES


GRID = list(itertools.product(
    (4, 1024, 8192),        # row bytes
    (7, 100_000),           # replicas
    (0, 3),                 # fanout
    (None, 16, 16_384),     # rows (bucket)
    (1, 17),                # G
    (1, 9),                 # window
    (True, False),          # leafwise
))


@pytest.mark.parametrize("family", troof.FAMILIES)
def test_kernel_traffic_equals_jax(family):
    for rb, r, k, rows, g, t, leafwise in GRID:
        kw = dict(row_bytes=rb, n_replicas=r, fanout=k, rows=rows, g_active=g,
                  window=t, leafwise=leafwise, exchange_rows=5, n_vars=3)
        got = troof.kernel_traffic(family, **kw)
        want = jroof.kernel_traffic(JAX_FAMILY.get(family, family), **kw)
        assert (got.bytes_moved, got.joins, got.xla_lo, got.xla_hi) == (
            want.bytes_moved, want.joins, want.xla_lo, want.xla_hi), kw


@pytest.mark.parametrize("family,k,r,rb,f,g", [
    # PERF.md §6's widest main-path shapes: K1, K2, K3
    ("cuda_dense", 3, 262_144, 8192, None, 1),
    ("cuda_rows", 3, 100_000, 1024, 16_384, 1),
    ("cuda_rows", 3, 100_000, 148, 32_768, 25),
])
def test_kernel_families_are_the_gather_model(family, k, r, rb, f, g):
    """``cuda_dense``: (K+2)·R·row_bytes; ``cuda_rows``: (K+2)·F·row_bytes
    plus the slots' K+2 indices, G members."""
    est = troof.kernel_traffic(family, row_bytes=rb, n_replicas=r, fanout=k,
                               rows=f, g_active=g)
    if family == "cuda_dense":
        assert est.bytes_moved == (k + 2) * r * rb
    else:
        assert est.bytes_moved == g * (k + 2) * f * (rb + 4)


def test_traffic_model_scales_with_population():
    a = troof.kernel_traffic("dense", row_bytes=64, n_replicas=256, fanout=3)
    b = troof.kernel_traffic("dense", row_bytes=64, n_replicas=512, fanout=3)
    assert b.bytes_moved == 2 * a.bytes_moved and b.joins == 2 * a.joins


def test_traffic_model_rejects_unknown_family():
    with pytest.raises(ValueError):
        troof.kernel_traffic("warp_drive", row_bytes=8, n_replicas=8, fanout=2)
    with pytest.raises(ValueError):
        troof.kernel_traffic("pallas_rows", row_bytes=8, n_replicas=8, fanout=2)


# -- state_row_bytes ------------------------------------------------------------

MAP_FIELDS = [(("g", "lasp_gset"), "lasp_gset", {"n_elems": 5}),
              (("n", "riak_dt_map"), "riak_dt_map",
               {"fields": [(("c", "riak_dt_gcounter"), "riak_dt_gcounter", {})]})]


def _rts(packed):
    out = []
    for store_mod, graph, mesh, kw in ((jstore, JGraph, jmesh, {}),
                                       (tstore, TGraph, tmesh, {"device": "cpu"})):
        store = store_mod.Store(n_actors=4, **kw)
        store.declare(id="gs", type="lasp_gset", n_elems=13)
        store.declare(id="gc", type="riak_dt_gcounter", n_actors=5)
        store.declare(id="iv", type="lasp_ivar")
        store.declare(id="os", type="lasp_orset", n_elems=6, n_actors=3,
                      tokens_per_actor=5)
        store.declare(id="ob", type="lasp_orset_gbtree", n_elems=40, n_actors=2,
                      tokens_per_actor=3)
        store.declare(id="ow", type="riak_dt_orswot", n_elems=7, n_actors=3)
        store.declare(id="mp", type="riak_dt_map", fields=MAP_FIELDS, n_actors=4)
        out.append(mesh.ReplicatedRuntime(store, graph(store), 11, ring(11, 2),
                                          packed=packed, **kw))
    return out


@pytest.mark.parametrize("packed", [False, True])
def test_state_row_bytes_every_codec(packed):
    jrt, trt = _rts(packed)
    for v in jrt.var_ids:
        want = jroof.state_row_bytes(jrt.states[v], 11)
        assert troof.state_row_bytes(trt.states[v], 11) == want, v
        assert trt._row_bytes(v) == want, v


# -- the ledger -----------------------------------------------------------------

RECORDS = [
    ("rows", "GSet", dict(n_replicas=64, fanout=3, seconds=1.0, row_bytes=16, rows=16)),
    ("rows", "GSet", dict(n_replicas=64, fanout=3, seconds=0.001, row_bytes=16, rows=16)),
    ("rows", "GSet", dict(n_replicas=64, fanout=3, seconds=0.002, row_bytes=16, rows=16)),
    ("cuda_rows", "FlatORSet", dict(n_replicas=100, fanout=3, seconds=0.5, row_bytes=64,
                                    rows=32, g_active=4)),
    ("cuda_rows", "FlatORSet", dict(n_replicas=100, fanout=3, seconds=0.25, row_bytes=64,
                                    rows=32, g_active=4)),
    ("converge", "store3", dict(n_replicas=100, fanout=3, seconds=0.5, bytes_moved=999,
                                joins=7, rounds=9)),
    ("converge", "store3", dict(n_replicas=100, fanout=3, seconds=0.5, bytes_moved=999,
                                joins=7, rounds=9)),
    ("dataflow_fused", "Graph", dict(n_replicas=1, fanout=4, seconds=0.1, row_bytes=77,
                                     window=5, rounds=5, n_vars=4)),
    ("dataflow_fused", "Graph", dict(n_replicas=1, fanout=4, seconds=0.1, row_bytes=77,
                                     window=5, rounds=5, n_vars=4)),
]

_RATE_KEYS = ("achieved_GBps", "roofline_frac", "peak_GBps")


def _ledger_view(roof, family_of):
    led = roof.KernelLedger()
    for fam, codec, kw in RECORDS:
        led.record(family_of(fam), codec, **kw)
    rows = [{k: v for k, v in r.items() if k != "roofline_frac"}
            for r in led.snapshot()]
    for r in rows:
        r["kernel"] = r["kernel"].replace("pallas_", "cuda_")
        r["family"] = r["family"].replace("pallas_", "cuda_")
    summ = led.summary()
    for k in _RATE_KEYS[1:]:
        summ.pop(k)
    for r in summ["kernels"]:
        r.pop("roofline_frac")
        r["kernel"] = r["kernel"].replace("pallas_", "cuda_")
        r["family"] = r["family"].replace("pallas_", "cuda_")
    return rows, led.totals(), summ


def test_ledger_labels_totals_summary_equal_jax():
    got = _ledger_view(troof, lambda f: f)
    want = _ledger_view(jroof, lambda f: JAX_FAMILY.get(f, f))
    assert got == want
    rows = got[0]
    assert {r["kernel"] for r in rows} >= {
        "rows:GSet:R64k3:b16", "cuda_rows:FlatORSet:R100k3:b32:G4",
        "converge:store3:R100k3"}


def test_ledger_compile_bucket_and_rates():
    led = troof.KernelLedger()
    led.record("rows", "GSet", n_replicas=64, fanout=3, seconds=1.0,
               row_bytes=16, rows=16)
    snap = led.snapshot()[0]
    assert snap["compile_dispatches"] == 1
    assert snap["dispatches"] == 0 and snap["seconds"] == 0.0
    assert snap["achieved_GBps"] is None
    for _ in range(3):
        led.record("rows", "GSet", n_replicas=64, fanout=3, seconds=0.001,
                   row_bytes=16, rows=16)
    snap = led.snapshot()[0]
    assert snap["dispatches"] == 3
    assert snap["compile_seconds"] == pytest.approx(1.0)
    est = troof.kernel_traffic("rows", row_bytes=16, n_replicas=64, fanout=3, rows=16)
    assert snap["bytes"] == 3 * est.bytes_moved
    assert snap["achieved_GBps"] == round(snap["bytes"] / snap["seconds"] / 1e9, 3)
    # no card here: no roofline denominator, so no fraction
    assert snap["roofline_frac"] is None


def test_ledger_detaches_on_generation_change():
    led = troof.get_ledger()
    with treg.scratch_registry():
        scratch = troof.get_ledger()
        assert scratch is not led
        scratch.record("dense", "GSet", n_replicas=8, fanout=2, seconds=0.1,
                       row_bytes=8)
    after = troof.get_ledger()
    assert after is not scratch
    assert after.totals()["dispatches"] == 0


def test_ledger_noop_when_disabled():
    led = troof.KernelLedger()
    treg.set_enabled(False)
    try:
        led.record("dense", "GSet", n_replicas=8, fanout=2, seconds=0.1, row_bytes=8)
    finally:
        treg.set_enabled(True)
    assert led.totals()["dispatches"] == 0
    assert led.totals()["compile_seconds"] == 0.0


def test_health_carries_roofline_view():
    view = ttel.get_monitor().health()["roofline"]
    assert set(view) == set(jtel.get_monitor().health()["roofline"])


def _frontier_store(store_mod, graph, mesh, kw):
    store = store_mod.Store(n_actors=4, **kw)
    ids = [store.declare(id=f"v{i}", type="lasp_gset", n_elems=16) for i in range(6)]
    rt = mesh.ReplicatedRuntime(store, graph(store), 128,
                                random_regular(128, 3, seed=2), **kw)
    return rt, ids


def test_ledger_attribution_sums_to_round_wall_time():
    """Ledger-attributed dispatch seconds sum to at most, and a share of,
    the round loop's wall time (warm signatures only)."""
    rt, ids = _frontier_store(tstore, TGraph, tmesh, {"device": "cpu"})
    for i, v in enumerate(ids):
        rt.update_batch(v, [(i, ("add", "x"), f"a{i}")])
    while rt.frontier_step():
        pass
    ledger = troof.get_ledger()
    t0_totals = ledger.totals()
    t0 = time.perf_counter()
    rounds = 0
    for rep in range(2):
        for i, v in enumerate(ids):
            rt.update_batch(v, [((i + rep) % 128, ("add", f"y{rep}"), f"b{i}")])
        while rt.frontier_step():
            rounds += 1
    wall = time.perf_counter() - t0
    d = ledger.totals()
    attributed = d["seconds"] - t0_totals["seconds"]
    assert rounds > 0
    assert 0 < attributed <= wall * 1.02, (attributed, wall)
    assert attributed >= 0.05 * wall, (attributed, wall)
    assert d["dispatches"] - t0_totals["dispatches"] > 0


def test_runtime_ledger_bytes_equal_jax():
    """The same frontier run through both runtimes: every signature's
    dispatches, rounds, bytes and joins equal (the port's plain arms record
    under the XLA arms' family names)."""
    views = []
    for store_mod, graph, mesh, kw, tel in (
            (jstore, JGraph, jmesh, {}, jtel),
            (tstore, TGraph, tmesh, {"device": "cpu"}, ttel)):
        rt, ids = _frontier_store(store_mod, graph, mesh, kw)
        for rep in range(3):
            for i, v in enumerate(ids):
                rt.update_batch(v, [((5 * i + rep) % 128, ("add", f"y{rep}"), f"b{i}")])
            while rt.frontier_step():
                pass
        rt.step()
        rt.step()
        views.append(sorted(
            (r["kernel"], r["dispatches"], r["rounds"], r["bytes"], r["joins"])
            for r in tel.get_ledger().snapshot()
        ))
    assert views[1] == views[0]


# -- capability -------------------------------------------------------------------

@pytest.mark.parametrize("kind,gbps", [
    ("NVIDIA H100 80GB HBM3", 3350.0),
    ("NVIDIA H100 PCIe", 2000.0),
    ("NVIDIA H100 NVL", 3900.0),
    ("NVIDIA H200", 4800.0),
    ("NVIDIA H200 NVL", 4800.0),
    ("quantum-accelerator-9000", None),
])
def test_peak_gbps_for_card_kinds(kind, gbps):
    assert tcap.peak_gbps_for_kind(kind) == gbps


def test_capability_pinned_kinds_equal_jax():
    from lasp_tpu.telemetry import capability as jcap

    for kind in ("TPU v5e", "TPU v5 lite", "TPU v5p", "TPU v4", "TPU v6e", "cpu",
                 "quantum-accelerator-9000"):
        assert tcap.peak_gbps_for_kind(kind) == jcap.peak_gbps_for_kind(kind)


def test_device_capability_without_a_card_has_no_peak():
    cap = tcap.device_capability(refresh=True)
    assert cap == {"platform": "cpu", "device_kind": "cpu", "peak_GBps": None,
                   "source": "unknown"}
    assert tcap.cached_peak_gbps() is None


def test_device_capability_names_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *_a: "NVIDIA H100 80GB HBM3")
    try:
        cap = tcap.device_capability(refresh=True)
        assert cap["platform"] == "gpu" and cap["peak_GBps"] == 3350.0
        assert cap["source"] == "pinned" and tcap.cached_peak_gbps() == 3350.0
    finally:
        monkeypatch.undo()
        tcap.device_capability(refresh=True)


def test_capability_host_probe_cached():
    bw1 = tcap.measure_host_bandwidth(size_mb=16)
    bw2 = tcap.measure_host_bandwidth(size_mb=16)
    assert bw1 > 0 and bw1 == bw2


def test_capability_gauge_survives_registry_generation():
    cap = tcap.device_capability(refresh=True)
    treg.reset()
    assert "capability_peak_GBps" not in treg.get_registry().snapshot()
    assert tcap.device_capability() is cap  # a cache hit re-emits
    assert "capability_peak_GBps" in treg.get_registry().snapshot()
    treg.reset()
    with treg.scratch_registry():
        tcap.device_capability()
    assert "capability_peak_GBps" not in treg.get_registry().snapshot()
    tcap.device_capability()
    assert "capability_peak_GBps" in treg.get_registry().snapshot()


# -- the quorum step's record -----------------------------------------------------

def _quorum_rows(store_mod, graph, mesh, quorum, kw, tel):
    store = store_mod.Store(n_actors=16, **kw)
    v = store.declare(id="kv", type="lasp_gset", n_elems=32)
    rt = mesh.ReplicatedRuntime(store, graph(store), 8, ring(8, 2), **kw)
    qr = quorum.QuorumRuntime(rt)
    for i in range(4):  # warm past the compile bucket
        qr.submit_put(v, ("add", f"x{i}"), f"w{i}", coordinator=i)
        qr.step()
    return sorted(
        (r["kernel"], r["dispatches"], r["rounds"], r["bytes"], r["joins"],
         r["compile_dispatches"])
        for r in tel.get_ledger().snapshot() if r["family"] == "quorum_step"
    )


def test_quorum_step_lands_in_roofline_ledger():
    want = _quorum_rows(jstore, JGraph, jmesh, jquorum, {}, jtel)
    got = _quorum_rows(tstore, TGraph, tmesh, tquorum, {"device": "cpu"}, ttel)
    assert got and got[0][1] >= 1
    assert got == want
