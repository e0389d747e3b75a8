"""The port's flight ring and window log (``lasp_tpu_torch.telemetry.device``)
and the configuration it reads (``lasp_tpu_torch.config``) against
``lasp_tpu``: twins of ``tests/telemetry/test_device.py``, the windows of
every fused path (``converge_on_device``, ``begin_fused_steps(...).finish()``,
the fused propagate, ``ChaosRuntime.fused_steps``,
``ServeFrontend.report()["flight"]``) equal to JAX's at a ring shorter and
longer than the window, ``LaspConfig.from_env`` accepting and refusing the
same environments, and ``measure_overhead``'s report keys."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasp_tpu.chaos as jchaos
import lasp_tpu.config as jcfg
import lasp_tpu.mesh as jmesh
import lasp_tpu.serve as jserve
import lasp_tpu.store as jstore
import lasp_tpu.telemetry as jtel
import lasp_tpu_torch.chaos as tchaos
import lasp_tpu_torch.config as tcfg
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.serve as tserve
import lasp_tpu_torch.store as tstore
import lasp_tpu_torch.telemetry as ttel
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.mesh.topology import ring
from lasp_tpu.telemetry import device as jdev
from lasp_tpu_torch.dataflow import Graph as TGraph
from lasp_tpu_torch.telemetry import device as tdev

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    """Both packages' metric registry, event ring, flight window log and
    kernel ledger start and end each test fresh, and their configs return
    to the defaults."""
    for tel in (jtel, ttel):
        tel.reset()
        tel.events.clear()
        tel.device.clear()
    yield
    for tel, cfg in ((jtel, jcfg), (ttel, tcfg)):
        tel.events.clear()
        tel.device.clear()
        tel.reset()
        cfg._CONFIG = None


def _pkg(port: bool):
    if port:
        return types.SimpleNamespace(
            port=True, tel=ttel, dev=tdev, cfg=tcfg, chaos=tchaos, serve=tserve,
            Store=lambda **kw: tstore.Store(device="cpu", **kw),
            RT=lambda *a, **kw: tmesh.ReplicatedRuntime(*a, device="cpu", **kw),
            Graph=TGraph,
        )
    return types.SimpleNamespace(
        port=False, tel=jtel, dev=jdev, cfg=jcfg, chaos=jchaos, serve=jserve,
        Store=jstore.Store, RT=jmesh.ReplicatedRuntime, Graph=JGraph,
    )


# -- ring write / decode (twins of test_device.py's ring cases) ----------------

def _filled_ring(k, rounds, width=2):
    ring_ = np.zeros((k, width), np.int32)
    for j in range(rounds):
        ring_[j % k] = [j + 1, 10 * (j + 1)]
    return ring_


@pytest.mark.parametrize("k,rounds", [(8, 5), (4, 4), (4, 7), (4, 0), (1, 3)])
def test_decode_ring_equals_jax(k, rounds):
    """No wraparound, exactly full, wraparound keeping the suffix oldest
    first, zero rounds: the same records and overwritten count, from a
    host array and from a tensor."""
    host = _filled_ring(k, rounds)
    want = jdev.decode_ring(host, rounds)
    assert tdev.decode_ring(host, rounds) == want
    assert tdev.decode_ring(torch.from_numpy(host), rounds) == want
    if rounds == 7:
        assert want[1] == 3 and [r[0] for r in want[0]] == [4, 5, 6, 7]


def test_ring_write_matches_jax_traced_ring():
    k, rounds, width = 4, 7, 3

    @jax.jit
    def run():
        def body(i, ring_):
            rec = jnp.stack([i + 1, 10 * (i + 1), 100 * (i + 1)])
            return jdev.ring_write(ring_, i, rec)
        return jax.lax.fori_loop(0, rounds, body, jdev.ring_init(k, width))

    want = np.asarray(run())
    ring_ = tdev.ring_init(k, width)
    assert ring_.dtype == torch.int32 and tuple(ring_.shape) == (k, width)
    index = torch.arange(rounds)
    for i in range(rounds):
        # the round index as a tensor on the ring's device (no host sync)
        rec = torch.stack([index[i] + 1, 10 * (index[i] + 1), 100 * (index[i] + 1)])
        out = tdev.ring_write(ring_, index[i] if i % 2 else i, rec)
        assert out is ring_  # in place
    assert np.array_equal(ring_.numpy(), want)
    assert tdev.decode_ring(ring_, rounds) == jdev.decode_ring(want, rounds)


def test_ring_write_when_keeps_the_old_record():
    ring_ = tdev.ring_init(2, 2)
    tdev.ring_write(ring_, 0, torch.tensor([1, 2]))
    tdev.ring_write(ring_, torch.tensor(0), torch.tensor([7, 7]),
                    when=torch.tensor(False))
    tdev.ring_write(ring_, torch.tensor(1), torch.tensor([3, 4]),
                    when=torch.tensor(True))
    assert ring_.tolist() == [[1, 2], [3, 4]]


# -- the window log (twins of test_device.py's log cases) ----------------------

def _window(dev, family="converge", records=((3, 1), (0, 0)), **kw):
    return dev.FlightWindow(
        family=family, columns=("a", "b"), rounds=len(records),
        overwritten=kw.pop("overwritten", 0),
        records=[list(r) for r in records],
        seconds=0.01, quiescent=kw.pop("quiescent", True), **kw,
    )


def _flight_metrics(tel):
    snap = tel.get_registry().snapshot()
    return {k: v for k, v in snap.items() if k.startswith("flight_")}


def sc_log_and_counters(P):
    P.dev.record_window(_window(P.dev))
    P.dev.record_window(_window(P.dev, family="fused_block", quiescent=None))
    P.dev.record_window(_window(P.dev, records=((5, 2), (1, 0), (0, 0)),
                                overwritten=4, first_round=7))
    ws = P.dev.windows()
    return (
        [w.to_dict() for w in ws],
        [w.family for w in P.dev.windows("converge")],
        P.dev.last_window().to_dict(), P.dev.last_window("fused_block").quiescent,
        [w.residual_curve() for w in ws],
        P.dev.stats(), P.dev.snapshot(), P.dev.render(), P.dev.render([]),
        _flight_metrics(P.tel),
        P.tel.render_prometheus(),
    )


def sc_disabled_and_generation(P):
    out = []
    P.tel.set_enabled(False)
    try:
        P.dev.record_window(_window(P.dev))
        out.append(len(P.dev.windows()))
    finally:
        P.tel.set_enabled(True)
    P.dev.record_window(_window(P.dev))
    out.append(len(P.dev.windows()))
    P.tel.reset()  # a new registry generation detaches the log
    out.append(len(P.dev.windows()))
    P.dev.record_window(_window(P.dev))
    P.dev.clear()
    out.append(P.dev.stats())
    return out


@pytest.mark.parametrize("scenario", [sc_log_and_counters, sc_disabled_and_generation],
                         ids=["log_and_counters", "disabled_and_generation"])
def test_window_log_twin(scenario):
    assert scenario(_pkg(True)) == scenario(_pkg(False))


# -- the fused paths ------------------------------------------------------------

def _build_runtime(P, n=16):
    store = P.Store(n_actors=4)
    a = store.declare(id="a", type="lasp_gset", n_elems=8)
    store.declare(id="c", type="riak_dt_gcounter", n_actors=4)
    rt = P.RT(store, P.Graph(store), n, ring(n, 2))
    rt.update_batch(a, [(0, ("add", "x"), "w0"), (7, ("add", "y"), "w1")])
    rt.update_at(3, "c", ("increment", 2), "w2")
    return rt


def _win(w):
    return None if w is None else (
        w.family, w.columns, w.rounds, w.overwritten,
        [list(map(int, r)) for r in w.records], w.quiescent,
    )


def _with_depth(P, k):
    if k is not None:
        P.cfg.set_config(P.cfg.LaspConfig(flight_rounds=k))


def sc_converge(P, k):
    _with_depth(P, k)
    rt = _build_runtime(P)
    rounds = rt.converge_on_device(max_rounds=64)
    w = P.dev.last_window("converge")
    mon = P.tel.get_monitor()
    deliveries = [(e["round"], e["attrs"]["residual"], e["attrs"]["fused"])
                  for e in P.tel.events.events()
                  if e["etype"] == "delivery" and "fused" in e["attrs"]]
    return rounds, _win(w), w.residual_curve(), mon.round, deliveries


def sc_converge_budget(P, k):
    _with_depth(P, k)
    rt = _build_runtime(P)
    signed = rt.converge_on_device(max_rounds=3, strict=False)
    return signed, _win(P.dev.last_window("converge"))


def sc_fused_block(P, k, block):
    _with_depth(P, k)
    rt = _build_runtime(P)
    first = rt.begin_fused_steps(block).finish()
    firsts = [first, rt.fused_steps(block)]
    return firsts, [_win(w) for w in P.dev.windows("fused_block")], \
        P.tel.get_monitor().round


def sc_dataflow(P, k):
    _with_depth(P, k)
    store = P.Store(n_actors=2)
    g = P.Graph(store)
    prev = store.declare(id="c0", type="lasp_gset", n_elems=8)
    for i in range(1, 6):
        prev = g.map(prev, lambda x: x, dst=f"c{i}", dst_elems=8)
    store.update("c0", ("add", 1), "w")
    r1 = g.propagate(mode="fused")
    store.update("c0", ("add", 2), "w")
    r2 = g.propagate(mode="fused")
    return (r1, r2), [_win(w) for w in P.dev.windows("dataflow_fused")]


def sc_chaos(P, k):
    _with_depth(P, k)
    rt = _build_runtime(P, n=24)
    sched = P.chaos.ChaosSchedule(24, rt._host_neighbors, [
        P.chaos.Partition(1, 5, 2), P.chaos.FlakyLinks(0, 9, 0.3),
    ], seed=3)
    ch = P.chaos.ChaosRuntime(rt, sched)
    totals = ch.fused_steps(6) + ch.fused_steps(5)
    return totals, [_win(w) for w in P.dev.windows("chaos_window")]


def sc_serve(P, k):
    _with_depth(P, k)
    store = P.Store(n_actors=16)
    store.declare(id="kv", type="lasp_gset", n_elems=64)
    rt = P.RT(store, P.Graph(store), 16, ring(16, 2))
    fe = P.serve.ServeFrontend(rt, gossip_block=6)
    for cyc in range(3):
        for i in range(4):
            fe.submit_write("kv", ("add", f"k{cyc}-{i}"), f"c{i}", replica=i)
        fe.cycle()
    fl = fe.report()["flight"]
    fl.pop("seconds")
    return fl


@pytest.mark.parametrize("k", [3, 64])
@pytest.mark.parametrize("scenario", [sc_converge, sc_converge_budget, sc_dataflow,
                                      sc_chaos, sc_serve],
                         ids=lambda f: getattr(f, "__name__", "")[3:])
def test_fused_path_windows_equal_jax(scenario, k):
    want, got = scenario(_pkg(False), k), scenario(_pkg(True), k)
    assert got == want


@pytest.mark.parametrize("k,block", [(4, 12), (64, 12), (64, 3)])
def test_fused_block_windows_equal_jax(k, block):
    assert sc_fused_block(_pkg(True), k, block) == sc_fused_block(_pkg(False), k, block)


def test_converge_curve_matches_unfused_bit_for_bit():
    """The tentpole parity claim in the port: a converge window's records
    are the per-round residual vectors unfused stepping reports, and its
    residual curve the runtime's per-round residuals."""
    rt_u = _build_runtime(_pkg(True))
    mon = ttel.get_monitor()
    curve_u = []
    for _ in range(64):
        total = rt_u.step()
        curve_u.append([int(mon.vars[v]["residual"]) for v in rt_u.var_ids])
        if total == 0:
            break
    ttel.reset()
    ttel.events.clear()
    rt_f = _build_runtime(_pkg(True))
    rounds = rt_f.converge_on_device(max_rounds=64)
    w = tdev.last_window("converge")
    assert w.overwritten == 0 and rounds == len(curve_u)
    assert [list(r) for r in w.records] == curve_u
    assert [t for _r, t in w.residual_curve()] == rt_u.round_residuals
    assert ttel.get_monitor().round == rounds


def test_no_ring_with_telemetry_off():
    rt = _build_runtime(_pkg(True))
    ttel.set_enabled(False)
    try:
        assert rt.converge_on_device(max_rounds=64) > 0
        assert rt.fused_steps(4) >= 0
    finally:
        ttel.set_enabled(True)
    assert tdev.windows() == []


# -- the configuration ----------------------------------------------------------

ENVS = [
    {},
    {"LASP_FLIGHT_ROUNDS": "16", "LASP_N_ACTORS": "8"},
    {"LASP_FANOUT": "4", "LASP_FUSED_BLOCK": "2", "LASP_GOSSIP_IMPL": "pallas"},
    {"LASP_BENCH_REPLICAS": "1024", "LASP_BENCH_PROBE_WINDOW": "10"},
    {"LASP_TELEMETRY_JSONL": "/dev/null", "LASP_DRYRUN_TIMEOUT": "5",
     "LASP_STATEM_DEPTH": "3", "LASP_WATCH_X": "1", "LASP_ONESHOT_Y": "2"},
    {"LASP_ETF": "python", "LASP_MESH_STATE_AXIS": "2", "PATH": "/bin"},
    {"LASP_FLIGHT_ROUNDZ": "16"},
    {"LASP_GOSSIP_IMPL": "cuda"},
    {"LASP_ETF": "native"},
    {"LASP_FLIGHT_ROUNDS": "0"},
    {"LASP_FANOUT": "three"},
]


def _from_env(cfg, env):
    try:
        return "ok", cfg.LaspConfig.from_env(env).validate()
    except (ValueError, TypeError) as exc:
        return type(exc).__name__, str(exc)


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(e) or "empty")
def test_config_from_env_equal_jax(env):
    verdict, cfg = _from_env(tcfg, env)
    want_verdict, want = _from_env(jcfg, env)
    assert verdict == want_verdict
    if verdict == "ok":
        assert tcfg.dataclasses.asdict(cfg) == jcfg.dataclasses.asdict(want)
    else:
        assert cfg == want


def test_flight_rounds_reads_the_config():
    assert tdev.flight_rounds() == jdev.flight_rounds() == 64
    tcfg.set_config(tcfg.LaspConfig(flight_rounds=5))
    assert tdev.flight_rounds() == 5
    with pytest.raises(ValueError, match="flight_rounds"):
        tcfg.set_config(tcfg.LaspConfig(flight_rounds=0))


# -- the overhead guard ----------------------------------------------------------

def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_measure_overhead_report_has_jax_keys():
    """Structure only on the CPU (the 5% budget is measured on the card)."""
    from lasp_tpu.telemetry.overhead import measure_overhead as jmeasure
    from lasp_tpu_torch.telemetry.overhead import measure_overhead as tmeasure

    kw = dict(n_replicas=64, step_samples=2, emission_samples=30)
    got = tmeasure(device="cpu", **kw)
    assert _keys(got) == _keys(jmeasure(**kw))
    for arm in ("frontier", "dataflow", "aae", "flight"):
        assert got[arm]["overhead_frac"] >= 0
    assert got["step_seconds"] > 0 and got["flight"]["window_seconds"] > 0
    assert got["ledger"]["cost_per_record_s"] >= 0


@pytest.mark.parametrize("k,first,n", [(4, 3, 7), (8, 0, 3), (3, 5, 3), (1, 2, 4)])
def test_ring_write_block_equals_round_by_round(k, first, n):
    """A window's rounds in one copy land where round-by-round writes put
    them (the last K survive)."""
    recs = [torch.tensor([r + 1, 10 * (r + 1)], dtype=torch.int32)
            for r in range(first, first + n)]
    a, b = tdev.ring_init(k, 2), tdev.ring_init(k, 2)
    for i, rec in enumerate(recs):
        tdev.ring_write(a, first + i, rec)
    tdev.ring_write_block(b, first, recs)
    assert torch.equal(a, b)
    tdev.ring_write_block(b, first, torch.stack(recs))
    assert torch.equal(a, b)


def sc_window_clock_after_reset(P):
    """ROADMAP C4, a fault of the reference the port keeps for parity: the
    first window drained after ``telemetry.reset()`` with no monitor feed
    in between takes its first round from the old generation's clock."""
    store = P.Store(n_actors=4)
    a = store.declare(id="a", type="lasp_gset", n_elems=8)
    rt = P.RT(store, P.Graph(store), 16, ring(16, 2))
    rt.update_batch(a, [(0, ("add", "x"), "w0")])
    rt.converge_on_device(max_rounds=64)
    rt.update_at(3, a, ("add", "y"), "w1")  # update_at feeds no monitor
    P.tel.reset()
    rt.converge_on_device(max_rounds=64)
    w = P.dev.last_window("converge")
    return w.first_round, w.rounds, P.tel.get_monitor().round


def test_window_clock_after_reset_equals_jax():
    got = sc_window_clock_after_reset(_pkg(True))
    assert got == sc_window_clock_after_reset(_pkg(False))
    first_round, rounds, monitor_round = got
    assert first_round == rounds + 1 and monitor_round == rounds  # the fault
