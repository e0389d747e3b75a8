"""The port's serving front-end (``lasp_tpu_torch.serve``) against
``lasp_tpu.serve``: twins of ``tests/serve/test_admission.py``,
``test_subscriptions.py`` and ``test_engine.py``. Each scenario runs
through both packages on the same inputs; what it observes (admission
decisions and ladder logs, fired watch ids, ticket outcomes and results,
accounting, state fingerprints) must be equal."""

import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import lasp_tpu.chaos as jchaos
import lasp_tpu.chaos.invariants as jinv
import lasp_tpu.mesh as jmesh
import lasp_tpu.serve as jserve
import lasp_tpu.serve.requests as jrq
import lasp_tpu.store as jstore
import lasp_tpu.store.checkpoint as jckpt
import lasp_tpu.telemetry as jtel
import lasp_tpu_torch.chaos as tchaos
import lasp_tpu_torch.chaos.invariants as tinv
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.serve as tserve
import lasp_tpu_torch.serve.requests as trq
import lasp_tpu_torch.store as tstore
import lasp_tpu_torch.store.checkpoint as tckpt
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.lattice import Threshold as JThreshold
from lasp_tpu.lattice.gset import GSet as JGSet
from lasp_tpu.mesh import ring
from lasp_tpu_torch.dataflow import Graph as TGraph
from lasp_tpu_torch.lattice import Threshold as TThreshold
from lasp_tpu_torch.lattice.base import tree_map
from lasp_tpu_torch.lattice.gset import GSet as TGSet

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


def _pkg(port: bool):
    if port:
        return types.SimpleNamespace(
            port=True, serve=tserve, rq=trq, chaos=tchaos, inv=tinv,
            Threshold=TThreshold, GSet=TGSet,
            Store=lambda **kw: tstore.Store(device="cpu", **kw),
            RT=lambda *a, **kw: tmesh.ReplicatedRuntime(*a, device="cpu", **kw),
            Graph=TGraph, ckpt=tckpt,
            new=lambda var: var.codec.new(var.spec, device="cpu"),
            row=lambda rt, v, r: tree_map(lambda x: x[r].clone(), rt._population(v)),
            true=lambda: torch.tensor(True),
        )
    return types.SimpleNamespace(
        port=False, serve=jserve, rq=jrq, chaos=jchaos, inv=jinv,
        Threshold=JThreshold, GSet=JGSet,
        Store=jstore.Store, RT=jmesh.ReplicatedRuntime, Graph=JGraph, ckpt=jckpt,
        new=lambda var: var.codec.new(var.spec),
        row=lambda rt, v, r: jax.tree_util.tree_map(lambda x: x[r], rt._population(v)),
        true=lambda: jax.numpy.asarray(True),
    )


def _twin(scenario, *args, **kw):
    records = []
    for port in (False, True):
        obs: list = []
        scenario(_pkg(port), obs, *args, **kw)
        records.append(obs)
    jrec, trec = records
    assert len(jrec) == len(trec)
    for i, (x, y) in enumerate(zip(jrec, trec)):
        assert x == y, (i, x, y)
    return trec


def _raises(obs, exc_types, fn, *a, **kw):
    try:
        fn(*a, **kw)
    except exc_types as exc:
        obs.append(type(exc).__name__)
        return exc
    obs.append("ok")
    return None


def _fp(P, rt) -> str:
    return P.inv.fingerprint(P.inv.snapshot_states(rt))


def _ticket_obs(t):
    res = t.result
    if isinstance(res, (set, frozenset)):
        res = sorted(res)
    return (t.kind, t.var_id, t.status, res, t.error, t.retry_after_ms)


# -- admission (a copy of JAX's module: same decisions, same logs) --------------

def test_admission_scenarios_equal_jax():
    def scen(P, obs):
        rq = P.rq
        q = P.serve.BoundedQueue(3)
        obs.append([q.offer(i) for i in range(4)])
        obs.append((q.depth, q.high_water, q.drain(2), q.drain(None), q.high_water))
        q = P.serve.BoundedQueue(4)
        for i in range(4):
            q.offer(i)
        q.drain(None)
        obs.append((q.take_window(), q.take_window()))
        ac = P.serve.AdmissionController(capacity={"write": 2, "read": 2, "watch": 2})
        obs.append([ac.admit(rq.Ticket(rq.WRITE, "v")) for _ in range(3)])
        obs.append(ac.admit(rq.Ticket(rq.READ, "v")))
        ac = P.serve.AdmissionController(
            capacity={"write": 10, "read": 10, "watch": 10},
            enter=(0.5, 0.75, 0.9), exit=(0.3, 0.5, 0.7), hysteresis_cycles=2)
        for _ in range(10):
            ac.queues["write"].offer(object())
        obs.append(ac.observe_cycle(0.01, 0))
        ac.queues["write"].drain(None)
        obs.append([ac.observe_cycle(0.01, d) for d in (10, 0, 0, 0, 0)])
        obs.append(ac.transitions)
        for _ in range(4):
            ac.queues["read"].offer(object())
        obs.append(ac.admit(rq.Ticket(rq.READ, "v", priority=rq.PRIO_LOW)))
        obs.append(ac.admit(rq.Ticket(rq.WRITE, "v")))
        obs.append((ac.coalesce_multiplier(), ac.probe("write"), ac.probe("read"),
                    ac.snapshot()))
        ac = P.serve.AdmissionController(
            capacity={"write": 100, "read": 10, "watch": 10},
            min_retry_ms=5, max_retry_ms=2000)
        obs.append(ac.retry_after_ms("write"))
        ac.observe_cycle(0.1, 50)
        for _ in range(20):
            ac.queues["write"].offer(object())
        obs.append(ac.retry_after_ms("write"))
        _raises(obs, TypeError, P.serve.AdmissionController, capacity={"writes": 1})
        _raises(obs, ValueError, P.serve.AdmissionController,
                enter=(0.5, 0.7, 0.9), exit=(0.6, 0.5, 0.7))
        t = rq.Ticket(rq.WRITE, "v")
        obs.append((t.complete("r", 1.0), t.fail("nope", 2.0), t.status,
                    t.result, t.latency()))
        e = P.serve.OverloadError("busy", retry_after_ms=7)
        obs.append((str(e), e.retry_after_ms, P.serve.LADDER, P.serve.KINDS))

    _twin(scen)


# -- subscriptions ------------------------------------------------------------------

R = 8


def _sub_rt(P, **declares):
    store = P.Store(n_actors=32)
    for vid, (tname, caps) in declares.items():
        store.declare(id=vid, type=tname, **caps)
    return store, P.RT(store, P.Graph(store), R, ring(R, 2))


def _accessors(store, rt):
    def pop_of(v):
        return rt._to_dense_row(v, rt._population(v))

    def meta_of(v):
        var = store.variable(v)
        return var.codec, var.spec

    return pop_of, meta_of


def _parity(P, obs, store, rt, cases):
    """Register ``cases`` ``(var, threshold, replica)`` on two tables; the
    batched claims of one and the per-watch verdicts of the other are
    observed (and must agree within the package too)."""
    tables = (P.serve.SubscriptionTable(), P.serve.SubscriptionTable())
    for vid, thr, replica in cases:
        var = store.variable(vid)
        for t in tables:
            t.register(vid, var.codec, var.spec, thr, replica=replica)
    pop_of, meta_of = _accessors(store, rt)
    vec = sorted(s for s, _ in tables[0].evaluate(pop_of, meta_of))
    ref = sorted(s for s, _ in tables[1].evaluate_pervar(pop_of, meta_of, claim=False))
    obs.append((vec, ref))
    assert vec == ref


def test_parity_gset_orset_orswot_thresholds():
    def scen(P, obs):
        store, rt = _sub_rt(P, g=("lasp_gset", {"n_elems": 16}),
                            o=("lasp_orset", {"n_elems": 8, "tokens_per_actor": 4}),
                            w=("riak_dt_orswot", {"n_elems": 8}))
        rt.update_at(2, "g", ("add", "a"), "w0")
        rt.update_at(2, "g", ("add", "b"), "w0")
        rt.update_at(1, "o", ("add", "x"), "a0")
        rt.update_at(1, "w", ("add", "x"), "a0")
        rt.update_at(1, "w", ("add", "y"), "a0")
        g = store.variable("g")
        bottom = P.new(g)
        has_a = g.codec.add(g.spec, bottom, g.elems.intern("a"))
        has_c = g.codec.add(g.spec, bottom, g.elems.intern("c"))
        T = P.Threshold
        cases = [("g", T(bottom, False), 2), ("g", T(bottom, True), 2),
                 ("g", T(has_a, False), 2), ("g", T(has_a, True), 2),
                 ("g", T(has_c, False), 2), ("g", T(has_a, False), 0)]
        for vid in ("o", "w"):
            b = P.new(store.variable(vid))
            cases += [(vid, T(b, True), 1), (vid, T(b, True), 0)]
        wstate = rt._to_dense_row("w", P.row(rt, "w", 1))
        cases += [("w", T(wstate, False), 1), ("w", T(wstate, False), 3)]
        _parity(P, obs, store, rt, cases)

    _twin(scen)


def test_parity_gcounter_ivar_and_map():
    def scen(P, obs):
        store, rt = _sub_rt(P, c=("riak_dt_gcounter", {"n_actors": 8}),
                            i=("lasp_ivar", {}),
                            m=("riak_dt_map", {"fields": [("s", "lasp_gset", {"n_elems": 4})]}))
        for _k in range(5):
            rt.update_at(3, "c", ("increment",), "a3")
        rt.update_at(2, "i", ("set", "ready"), "a0")
        rt.update_at(4, "m", ("update", "s", ("add", "k")), "w0")
        T = P.Threshold
        ib = P.new(store.variable("i"))
        mb = P.new(store.variable("m"))
        cases = [("c", T(5, False), 3), ("c", T(5, True), 3), ("c", T(4, True), 3),
                 ("c", T(0, False), 0), ("c", T(1, False), 0),
                 ("i", T(ib, True), 2), ("i", T(ib, True), 0),
                 ("i", T(ib, False), 0), ("i", T(ib, False), 2),
                 ("m", T(mb, True), 4), ("m", T(mb, True), 0)]
        _parity(P, obs, store, rt, cases)

    _twin(scen)


def test_subscription_table_lifecycle_equals_jax(tmp_path):
    """Structure mismatch, resize clamp, checkpoint restore, deadline
    expiry, cancel, rehome, the unknown-override fallback and slot
    compaction."""
    def scen(P, obs, path):
        T = P.Threshold
        store, rt = _sub_rt(P, g=("lasp_gset", {"n_elems": 8}),
                            c=("riak_dt_gcounter", {"n_actors": 8}))
        pop_of, meta_of = _accessors(store, rt)
        g, c = store.variable("g"), store.variable("c")
        table = P.serve.SubscriptionTable()
        table.register("g", g.codec, g.spec, T(P.new(g), False))
        _raises(obs, TypeError, table.register, "g", g.codec, g.spec, T(3, False))
        table.register("c", c.codec, c.spec, T(3, False))
        # resize clamp, then a write on the clamp target
        table = P.serve.SubscriptionTable()
        sid = table.register("g", g.codec, g.spec, T(P.new(g), True),
                             replica=R - 1, payload="park")
        obs.append(table.evaluate(pop_of, meta_of))
        rt.update_at(2, "g", ("add", "k"), "w0")
        P.ckpt.save_runtime(rt, path)
        rt.resize(4, ring(4, 2))
        obs.append(table.evaluate(pop_of, meta_of))
        rt.update_at(3, "g", ("add", "k2"), "w1")
        obs.append(table.evaluate(pop_of, meta_of) == [(sid, "park")])
        # checkpoint restore
        table = P.serve.SubscriptionTable()
        sid = table.register("g", g.codec, g.spec, T(P.new(g), True), replica=1,
                             payload="p2")
        obs.append(table.evaluate(pop_of, meta_of))
        rt.reseed_row(1, P.ckpt.load_runtime_rows(path, 2))
        obs.append(table.evaluate(pop_of, meta_of) == [(sid, "p2")])
        # deadlines, cancel, len
        table = P.serve.SubscriptionTable()
        due = table.register("c", c.codec, c.spec, T(1, False), deadline=10.0,
                             payload="due")
        keep = table.register("c", c.codec, c.spec, T(1, False), payload="keep")
        obs.append((table.expire(now=9.0), table.expire(now=11.0) == [(due, "due")]))
        rt.update_at(0, "c", ("increment",), "a0")
        obs.append(table.evaluate(pop_of, meta_of) == [(keep, "keep")])
        sid = table.register("c", c.codec, c.spec, T(100, False), payload="p")
        obs.append((len(table), table.cancel(sid), table.cancel(sid), len(table)))
        # rehome on a shrink: ring fold, then expire semantics
        table = P.serve.SubscriptionTable()
        for r in range(4):
            table.register("c", c.codec, c.spec, T(50, False), replica=r, payload=r)
        rt.resize(3, ring(3, 2))
        obs.append(table.rehome(3))
        for r in range(4):
            table.register("c", c.codec, c.spec, T(50, False), replica=r + 3,
                           payload=("x", r))
        res = table.rehome(3, expire=True)
        obs.append((res["rehomed"], sorted(p for _s, p in res["expired"])))
        obs.append(sorted(int(x) for x in table._groups["c"].replica[:table._groups["c"].n]))

        class Weird(P.GSet):
            name = "weird_set"

            @classmethod
            def threshold_met(cls, spec, state, threshold):
                return P.true()

        table = P.serve.SubscriptionTable()
        sid = table.register("g", Weird, g.spec, T(P.new(g), True), payload="w")
        obs.append(table.evaluate(pop_of, lambda v: (Weird, g.spec)) == [(sid, "w")])
        obs.append(table.pervar_fallbacks)
        # churn -> compaction; the survivor's index re-points
        table = P.serve.SubscriptionTable()
        rt.update_at(0, "c", ("increment", 5), "a0")
        for i in range(600):
            table.register("c", c.codec, c.spec, T(1, False), payload=i)
        surv = table.register("c", c.codec, c.spec, T(50, False), payload="keep")
        obs.append((len(table.evaluate(pop_of, meta_of)), len(table)))
        for _i in range(100):
            table.register("c", c.codec, c.spec, T(1, False))
        table.evaluate(pop_of, meta_of)
        table.evaluate(pop_of, meta_of)
        obs.append(table._groups["c"].cap)
        rt.update_at(0, "c", ("increment", 50), "a0")
        obs.append(table.evaluate(pop_of, meta_of) == [(surv, "keep")])

    _twin(scen, str(tmp_path / "ckpt"))


def test_fire_exactly_once_under_concurrent_evaluators():
    store, rt = _sub_rt(_pkg(True), c=("riak_dt_gcounter", {"n_actors": 8}))
    pop_of, meta_of = _accessors(store, rt)
    table = tserve.SubscriptionTable()
    cvar = store.variable("c")
    n = 300
    for i in range(n):
        table.register("c", cvar.codec, cvar.spec, TThreshold(1 + (i % 20), False),
                       replica=i % R, payload=i)
    fired: list = []
    lock = threading.Lock()
    stop = threading.Event()

    def evaluator():
        while not stop.is_set():
            hits = table.evaluate(pop_of, meta_of)
            with lock:
                fired.extend(hits)

    threads = [threading.Thread(target=evaluator) for _ in range(2)]
    for t in threads:
        t.start()
    for _k in range(25):
        rt.update_batch("c", [(r, ("increment",), f"a{r}") for r in range(R)])
    stop.set()
    for t in threads:
        t.join()
    fired.extend(table.evaluate(pop_of, meta_of))
    ids = [s for s, _p in fired]
    assert len(ids) == len(set(ids)) == n


# -- the front-end ----------------------------------------------------------------

RE = 12


def _fe_rt(P, n=RE, **declares):
    store = P.Store(n_actors=64)
    if not declares:
        declares = {
            "kv": ("lasp_gset", {"n_elems": 64}),
            "os": ("lasp_orset", {"n_elems": 32, "tokens_per_actor": 4}),
            "ctr": ("riak_dt_gcounter", {"n_actors": 64}),
        }
    for vid, (tname, caps) in declares.items():
        store.declare(id=vid, type=tname, **caps)
    return store, P.RT(store, P.Graph(store), n, ring(n, 2))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_coalesced_cycle_is_bit_identical_to_sequential():
    def scen(P, obs):
        rng = np.random.RandomState(3)
        requests = []
        for i in range(120):
            kind = i % 3
            r = int(rng.randint(RE))
            if kind == 0:
                requests.append(("kv", ("add", f"k{int(rng.randint(30))}"), f"c{i}", r))
            elif kind == 1:
                requests.append(("os", ("add", f"e{int(rng.randint(16))}"), f"c{i}", r))
            else:
                requests.append(("ctr", ("increment", 2), f"a{r}", r))
        _s1, rt_seq = _fe_rt(P)
        for var, op, actor, r in requests:
            rt_seq.update_at(r, var, op, actor)
        _s2, rt_co = _fe_rt(P)
        fe = P.serve.ServeFrontend(rt_co, gossip_block=0, write_backup=False)
        tickets = [fe.submit_write(var, op, actor, replica=r)
                   for var, op, actor, r in requests]
        st = fe.cycle()
        st.pop("seconds")
        obs.append(st)
        obs.append([_ticket_obs(t) for t in tickets])
        obs.append((_fp(P, rt_seq), _fp(P, rt_co)))

    rec = _twin(scen)
    assert rec[-1][0] == rec[-1][1]


def _chaos_fe(P, events, **kw):
    store, rt = _fe_rt(P)
    sched = P.chaos.ChaosSchedule(RE, ring(RE, 2), events, seed=1)
    ch = P.chaos.ChaosRuntime(rt, sched)
    return store, rt, ch, P.serve.ServeFrontend(ch, **kw)


def test_acks_survive_crash_and_reroute_or_fail_typed():
    def scen(P, obs):
        C = P.chaos
        _s, rt, ch, fe = _chaos_fe(P, [C.Crash(2, 4), C.Restore(6, 4)],
                                   chaos_mode="dense")
        t = fe.submit_write("kv", ("add", "precious"), "c0", replica=4)
        fe.cycle()
        obs.append((_ticket_obs(t), {k: sorted(v) for k, v in fe.acked_terms.items()}))
        for _ in range(10):
            fe.cycle()
        rt.run_to_convergence(max_rounds=256)
        P.inv.check_no_write_lost(rt, fe.acked_terms)
        obs.append((_fp(P, rt), fe.unreplicated_acks))
        _s, rt, ch, fe = _chaos_fe(P, [C.Crash(0, 7), C.Restore(8, 7)])
        fe.cycle()
        ts = [fe.submit_write("kv", ("add", "x"), "c0", replica=7),
              fe.submit_write("ctr", ("increment",), "a7", replica=7),
              fe.submit_write("os", ("add", "x"), "a7", replica=7),
              fe.submit_write("kv", ("add", "y"), "c0", replica=7)]
        fe.cycle()
        obs.append([_ticket_obs(t) for t in ts])
        obs.append(fe.report()["errors"])

    rec = _twin(scen)
    assert rec[2][1][2] == "error" and rec[2][0][2] == "done"


def test_bad_requests_deadlines_threshold_reads_and_sheds():
    def scen(P, obs):
        T = P.Threshold
        _s, rt = _fe_rt(P)
        fe = P.serve.ServeFrontend(rt, gossip_block=0)
        ts = [fe.submit_read("no_such_var"), fe.submit_write("os", ("add", "x"), "c0"),
              fe.submit_watch("also_missing", T(1)),
              fe.submit_write("kv", ("frobnicate", "x"), "c0")]
        fe.cycle()
        ts.append(fe.submit_write("kv", ("add", "z"), "c1"))
        fe.cycle()
        obs.append([(t.status, (t.error or "").split(":")[0]) for t in ts])
        clock = FakeClock()
        _s, rt = _fe_rt(P)
        fe = P.serve.ServeFrontend(rt, gossip_block=0, clock=clock)
        ts = [fe.submit_write("kv", ("add", "late"), "c0", deadline=5.0),
              fe.submit_read("kv", deadline=5.0)]
        clock.t = 6.0
        fe.cycle()
        w = fe.submit_watch("ctr", T(100), deadline=8.0)
        fe.cycle()
        obs.append(w.status)
        clock.t = 9.0
        fe.cycle()
        obs.append([_ticket_obs(t) for t in ts + [w]])
        obs.append((sorted(rt.coverage_value("kv")), fe.expired))
        _s, rt = _fe_rt(P)
        fe = P.serve.ServeFrontend(rt, gossip_block=0)
        t = fe.submit_read("kv", T(None, strict=True), replica=2)
        fe.cycle()
        obs.append(t.status)
        fe.submit_write("kv", ("add", "hello"), "c0", replica=2)
        fe.cycle()
        obs.append(_ticket_obs(t))
        _s, rt = _fe_rt(P)
        fe = P.serve.ServeFrontend(rt, gossip_block=0, admission=P.serve.AdmissionController(
            capacity={"write": 4, "read": 4, "watch": 4}))
        ts = [fe.submit_write("kv", ("add", f"k{i}"), "c0") for i in range(10)]
        obs.append([(t.status, t.error, t.retry_after_ms) for t in ts])
        obs.append(fe.drain())
        rep = fe.report()
        # flight: JAX's reads a process-wide ring (other tests' windows)
        for k in ("overlap_seconds", "latency", "admission", "flight"):
            rep.pop(k)
        obs.append(rep)
        ac = P.serve.AdmissionController(capacity={"write": 64, "read": 8, "watch": 8},
                                         widen_factor=4)
        fe = P.serve.ServeFrontend(rt, gossip_block=0, coalesce_max=8, admission=ac)
        obs.append(fe._coalesce_window())
        for _ in range(60):
            ac.queues["write"].offer(object())
        ac.observe_cycle(0.01, 0)
        obs.append((ac.level, fe._coalesce_window()))

    rec = _twin(scen)
    assert rec[0][0] == ("error", "KeyError") and rec[-1] == (3, 32)


def test_gossip_windows_overlap_ingest_like_jax():
    """The serve cycle's fused gossip window (``begin_fused_steps``) with
    host ingest in between: equal states, rounds and outcomes."""
    def scen(P, obs):
        _s, rt = _fe_rt(P)
        rt.update_at(0, "kv", ("add", "seed"), "c0")
        handle = rt.begin_fused_steps(4)
        obs.append(handle.pending)
        first = handle.finish()
        obs.append((first, handle.finish(), handle.pending))
        rt.update_at(3, "kv", ("add", "a"), "c0")
        handle = rt.begin_fused_steps(2)
        rt.update_batch("kv", [(0, ("add", "b"), "c1")])
        handle.finish()
        obs.append(rt.run_to_convergence(max_rounds=64))
        obs.append(sorted(rt.coverage_value("kv")))
        _s, rt = _fe_rt(P)
        clock = FakeClock()
        fe = P.serve.ServeFrontend(rt, gossip_block=2, clock=clock)
        ts = []
        for cyc in range(4):
            clock.t = float(cyc)
            ts += [fe.submit_write("kv", ("add", f"k{cyc}-{i}"), f"c{i}", replica=i)
                   for i in range(5)]
            ts.append(fe.submit_read("kv", replica=cyc))
            fe.cycle()
        obs.append([_ticket_obs(t) for t in ts])
        rep = fe.report()
        # the last fused window's flight record (its curve's round clock is
        # the process-wide monitor's, so the totals are compared)
        fl = rep["flight"]
        obs.append((rep["gossip_rounds"], rep["cycles"], fl["rounds"],
                    fl["overwritten"], fl["quiescent"],
                    [t for _r, t in fl["residual_curve"]],
                    rep["ingest_dispatches"]))
        obs.append(_fp(P, rt))

    _twin(scen)


def test_serve_loop_resolves_concurrent_submissions():
    store, rt = _fe_rt(_pkg(True), kv=("lasp_gset", {"n_elems": 128}))
    fe = tserve.ServeFrontend(rt, gossip_block=2)
    tickets = []
    with tserve.ServeLoop(fe, idle_sleep=0.001):
        def client(base):
            for i in range(20):
                tickets.append(fe.submit_write("kv", ("add", f"k{base}-{i}"), f"c{base}"))

        threads = [threading.Thread(target=client, args=(b,)) for b in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        deadline = time.monotonic() + 30
        while any(t.status == "queued" for t in tickets) and time.monotonic() < deadline:
            time.sleep(0.01)
    assert all(t.status == "done" for t in tickets)
    assert len(rt.coverage_value("kv")) == 80


def test_report_feeds_health_serve_section():
    from lasp_tpu_torch.telemetry import get_monitor

    from lasp_tpu_torch.telemetry import device as tdev

    tdev.clear()  # the window log is process-wide
    _s, rt = _fe_rt(_pkg(True))
    fe = tserve.ServeFrontend(rt, gossip_block=0)
    fe.submit_write("kv", ("add", "x"), "c0")
    fe.cycle()
    rep = fe.report()
    assert rep["flight"] is None  # no fused window ran
    health = get_monitor().health()
    assert health["serve"]["offered"] >= 1 and "level" in health["serve"]
