"""The port's staged membership (``MembershipStaging`` / ``MembershipPlan``,
``membership.handoff``, ``membership.coordinator``, ``membership.harness``)
against ``lasp_tpu.membership``: twins of
``tests/membership/test_{coordinator,handoff,harness}.py`` and of the
staging half of ``test_plan.py``. Each scenario runs through both packages
on the same inputs; what it observes (plans, reports, transfers, frontier
marks, values, state fingerprints, exceptions) must be equal."""

import types

import jax
import numpy as np
import pytest
import torch

import lasp_tpu.chaos as jchaos
import lasp_tpu.chaos.invariants as jinv
import lasp_tpu.membership as jmem
import lasp_tpu.mesh as jmesh
import lasp_tpu.quorum as jquorum
import lasp_tpu.serve as jserve
import lasp_tpu.store as jstore
import lasp_tpu.telemetry as jtel
import lasp_tpu_torch.chaos as tchaos
import lasp_tpu_torch.chaos.invariants as tinv
import lasp_tpu_torch.membership as tmem
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.quorum as tquorum
import lasp_tpu_torch.serve as tserve
import lasp_tpu_torch.store as tstore
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.lattice import Threshold as JThreshold
from lasp_tpu.mesh import ring
from lasp_tpu_torch.bridge_state import to_numpy
from lasp_tpu_torch.dataflow import Graph as TGraph
from lasp_tpu_torch.lattice import Threshold as TThreshold
from lasp_tpu_torch.lattice.base import tree_map

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
            port=True, chaos=tchaos, inv=tinv, mem=tmem, quorum=tquorum,
            serve=tserve, Threshold=TThreshold,
            Store=lambda **kw: tstore.Store(device="cpu", **kw),
            RT=lambda *a, **kw: tmesh.ReplicatedRuntime(*a, device="cpu", **kw),
            Graph=TGraph,
            new=lambda var: var.codec.new(var.spec, device="cpu"),
            row=lambda rt, v, r: tree_map(lambda x: x[r].clone(), rt._population(v)),
            host_row=lambda rt, v, r: to_numpy(
                tree_map(lambda x: x[r], rt._population(v))),
            leaves=lambda st: [np.asarray(x) for x in to_numpy(st)],
        )
    return types.SimpleNamespace(
        port=False, chaos=jchaos, inv=jinv, mem=jmem, quorum=jquorum,
        serve=jserve, Threshold=JThreshold,
        Store=jstore.Store, RT=jmesh.ReplicatedRuntime, Graph=JGraph,
        new=lambda var: var.codec.new(var.spec),
        row=lambda rt, v, r: jax.tree_util.tree_map(lambda x: x[r], rt._population(v)),
        host_row=lambda rt, v, r: jax.tree_util.tree_map(
            lambda x: np.asarray(x[r]), rt._population(v)),
        leaves=lambda st: [np.asarray(x) for x in jax.tree_util.tree_leaves(st)],
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


def _frontiers(rt) -> dict:
    return {v: np.flatnonzero(rt._frontier[v]).tolist() for v in rt.var_ids}


# -- the coordinator ----------------------------------------------------------

def _build(P, n=8, packed=False):
    store = P.Store(n_actors=8)
    store.declare(id="g", type="lasp_gset", n_elems=16)
    store.declare(id="o", type="lasp_orset", n_elems=16)
    store.declare(id="w", type="riak_dt_orswot", n_elems=16)
    return store, P.RT(store, P.Graph(store), n, ring(n, 2), packed=packed)


WRITES1 = [(0, "g", ("add", "a"), "p"), (3, "o", ("add", "b"), "q"),
           (5, "w", ("add", "c"), "r")]
WRITES2 = [(1, "g", ("add", "d"), "p2"), (2, "o", ("add", "e"), "q2")]


@pytest.mark.parametrize("packed", [False, True])
def test_round_trip_bit_identical_to_static_twin(packed):
    def scen(P, obs):
        _store, rt = _build(P, packed=packed)
        for r, v, op, a in WRITES1:
            rt.update_at(r, v, op, a)
        rt.run_to_convergence()
        mc = P.mem.MembershipCoordinator(rt, per_cycle=3)
        mc.stage_join(12)
        obs.append(mc.plan().describe())
        plan = mc.commit()
        obs.append((rt.membership_epoch, plan.epoch))
        obs.append(mc.run_to_settled())
        for r, v, op, a in WRITES2:
            rt.update_at(r, v, op, a)
        mc.stage_leave(8)
        mc.commit()
        obs.append(mc.run_to_settled())
        obs.append(rt.run_to_convergence())
        _s2, twin = _build(P, packed=packed)
        for r, v, op, a in WRITES1 + WRITES2:
            twin.update_at(r, v, op, a)
        twin.run_to_convergence()
        obs.append(P.inv.states_equal(P.inv.snapshot_states(rt),
                                      P.inv.snapshot_states(twin)))
        obs.append(_fp(P, rt))

    assert _twin(scen)[-2] is True


def test_join_seeds_new_rows_and_row_scoped_frontier():
    def scen(P, obs):
        _store, rt = _build(P)
        rt.update_at(2, "g", ("add", "seeded"), "p")
        rt.run_to_convergence()
        mc = P.mem.MembershipCoordinator(rt, per_cycle=8)
        mc.stage_join(12)
        plan = mc.commit()
        obs.append(plan.describe())
        obs.append(_frontiers(rt))
        obs.append(mc.cycle())
        obs.append(sorted(rt.replica_value("g", 10)))
        obs.append(_frontiers(rt))
        obs.append(mc.run_to_settled())
        obs.append(rt.run_to_convergence())
        obs.append((sorted(rt.replica_value("g", 11)), rt.divergence("g")))

    rec = _twin(scen)
    assert rec[3] == ["seeded"]


def test_leave_keeps_serving_while_transfers_drain():
    def scen(P, obs):
        _store, rt = _build(P)
        rt.update_at(7, "g", ("add", "late"), "p")
        mc = P.mem.MembershipCoordinator(rt, per_cycle=1)
        mc.stage_leave(6)
        mc.commit()
        obs.append(rt.n_replicas)
        obs.append(mc.step())
        obs.append((rt.n_replicas, mc.rebalancing))
        rt.update_at(6, "o", ("add", "mid"), "q")
        obs.append(mc.run_to_settled())
        obs.append((sorted(rt.coverage_value("g")), sorted(rt.coverage_value("o"))))
        obs.append(_fp(P, rt))

    _twin(scen)


def test_down_drops_immediately():
    def scen(P, obs):
        _store, rt = _build(P)
        rt.update_at(7, "g", ("add", "doomed"), "p")
        mc = P.mem.MembershipCoordinator(rt)
        mc.stage_down(6)
        obs.append(mc.commit().describe())
        obs.append((rt.n_replicas, mc.rebalancing))
        rt.run_to_convergence()
        obs.append(sorted(rt.coverage_value("g")))
        obs.append(mc.report())

    _twin(scen)


def test_finalize_defers_while_partitioned():
    def scen(P, obs):
        _store, rt = _build(P)
        rt.update_at(6, "g", ("add", "held"), "p")
        sched = P.chaos.ChaosSchedule(8, ring(8, 2), [P.chaos.Partition(0, 5, 2)])
        ch = P.chaos.ChaosRuntime(rt, sched)
        ch.step()
        mc = P.mem.MembershipCoordinator(ch, per_cycle=8)
        mc.stage_leave(6)
        mc.commit()
        obs.append(mc.cycle())
        obs.append((rt.n_replicas, mc.rebalancing))
        obs.append(mc.run_to_settled())
        obs.append((rt.n_replicas, sorted(rt.coverage_value("g")), rt.membership_epoch))
        obs.append(_fp(P, rt))

    rec = _twin(scen)
    assert rec[0]["parked"] == 2


def test_crashed_departer_falls_back_to_hints():
    def scen(P, obs):
        _store, rt = _build(P)
        rt.update_at(6, "g", ("add", "acked"), "p")
        rt.update_at(6, "o", ("add", "unacked"), "q")
        hints = P.quorum.HintLog()
        hints.append("g", np.asarray([6], dtype=np.int64), P.host_row(rt, "g", 6), rid=0)
        sched = P.chaos.ChaosSchedule(8, ring(8, 2), [P.chaos.Crash(0, 6)])
        ch = P.chaos.ChaosRuntime(rt, sched)
        mc = P.mem.MembershipCoordinator(ch, per_cycle=8, hints=hints)
        ch.step()
        mc.stage_leave(6)
        mc.commit()
        obs.append(mc.run_to_settled())
        obs.append(sorted(rt.coverage_value("g")))
        rt.run_to_convergence()
        obs.append(sorted(rt.coverage_value("o")))
        obs.append(_fp(P, rt))

    rec = _twin(scen)
    assert 6 in rec[0]["lost_sources"] and "acked" in rec[1]


def test_serve_watches_rehome_at_finalize():
    def scen(P, obs):
        store, rt = _build(P)
        fe = P.serve.ServeFrontend(rt)
        gvar = store.variable("g")
        sid = fe.subs.register("g", gvar.codec, gvar.spec,
                               P.Threshold(P.new(gvar), True), replica=7,
                               payload="park")
        mc = P.mem.MembershipCoordinator(rt, serve=fe)
        mc.stage_leave(6)
        mc.commit()
        obs.append(mc.run_to_settled())
        _var, slot = fe.subs._index[sid]
        obs.append(int(fe.subs._groups["g"].replica[slot]))

    assert _twin(scen)[-1] == 1


def test_commit_refused_while_rebalancing_and_staging_rules():
    def scen(P, obs):
        _store, rt = _build(P)
        mc = P.mem.MembershipCoordinator(rt, per_cycle=1)
        _raises(obs, ValueError, mc.plan)
        _raises(obs, ValueError, mc.stage_join, 8)
        _raises(obs, ValueError, mc.stage_leave, 9)
        mc.stage_join(10)
        mc.stage_join(12)  # chains: one 8 -> 12 plan
        _raises(obs, ValueError, mc.stage_leave, 6)
        obs.append(mc.plan().describe())
        mc.commit()
        mc.staging.stage_join(16)
        _raises(obs, RuntimeError, mc.commit)
        mc.staging.clear()
        obs.append(mc.staging.staged)

    assert _twin(scen)[5] == "RuntimeError"


# -- handoff -------------------------------------------------------------------

def _hbuild(P, n=8, packed=False):
    store = P.Store(n_actors=8)
    store.declare(id="g", type="lasp_gset", n_elems=16)
    store.declare(id="g2", type="lasp_gset", n_elems=16)
    store.declare(id="o", type="lasp_orset", n_elems=16)
    store.declare(id="w", type="riak_dt_orswot", n_elems=16)
    rt = P.RT(store, P.Graph(store), n, ring(n, 2), packed=packed)
    rt.update_at(5, "g", ("add", "a"), "p")
    rt.update_at(6, "g2", ("add", "b"), "p2")
    rt.update_at(6, "o", ("add", "c"), "q")
    rt.update_at(7, "w", ("add", "d"), "r")
    return rt


@pytest.mark.parametrize("packed", [False, True])
def test_grouped_transfer_equals_jax_and_per_pair_joins(packed):
    def scen(P, obs):
        pairs = [(5, 0), (6, 1), (7, 2)]
        rt = _hbuild(P, packed=packed)
        ref = _hbuild(P, packed=packed)
        for src, dst in pairs:
            for v in ref.var_ids:
                ref.join_rows(v, np.asarray([dst], dtype=np.int64),
                              [P.row(ref, v, src)])
        obs.append(P.mem.grouped_transfer(rt, pairs))
        obs.append(_fp(P, rt))
        obs.append(_fp(P, rt) == _fp(P, ref))
        obs.append(_frontiers(rt) == _frontiers(ref))
        obs.append(_frontiers(rt))
        obs.append(P.mem.grouped_transfer(rt, pairs))  # idempotent
        obs.append(_fp(P, rt))
        _raises(obs, ValueError, P.mem.grouped_transfer, rt, [(5, 0), (6, 0)])

    rec = _twin(scen)
    assert rec[0] > 0 and rec[2] and rec[3] and rec[5] == 0


def test_engine_caps_defers_parks_and_resumes():
    def scen(P, obs):
        rt = _hbuild(P)
        ch = P.chaos.ChaosRuntime(rt, P.chaos.ChaosSchedule(8, ring(8, 2), events=()))
        eng = P.mem.HandoffEngine(ch, [(5, 0), (6, 0), (7, 2)], per_cycle=2)
        obs.append(eng.cycle())
        obs.append(eng.cycle())
        obs.append((eng.outstanding, eng.max_batch, eng.transfer_bytes))
        rt = _hbuild(P)
        sched = P.chaos.ChaosSchedule(8, ring(8, 2), [P.chaos.Partition(0, 4, 2)])
        ch = P.chaos.ChaosRuntime(rt, sched)
        eng = P.mem.HandoffEngine(ch, [(5, 0), (6, 5)], per_cycle=4)
        ch.step()
        obs.append(eng.cycle())
        while eng.outstanding and ch.round < 12:
            ch.step()
            obs.append((ch.round, eng.cycle()))
        obs.append(sorted(rt.replica_value("g", 0)))
        rt = _hbuild(P)
        ch = P.chaos.ChaosRuntime(rt, P.chaos.ChaosSchedule(8, ring(8, 2),
                                                            [P.chaos.Crash(0, 5)]))
        ch.step()
        eng = P.mem.HandoffEngine(ch, [(5, 0)], per_cycle=4)
        obs.append(eng.cycle())

    rec = _twin(scen)
    assert rec[0]["transfers"] == 2 and rec[-1]["parked"] == 1


# -- the harness -----------------------------------------------------------------

def _hb(P, n=12, packed=False):
    def build():
        store = P.Store(n_actors=32)
        store.declare(id="kv", type="lasp_orset", n_elems=64, tokens_per_actor=8)
        store.declare(id="g", type="lasp_gset", n_elems=64)
        return P.RT(store, P.Graph(store), n, ring(n, 2), packed=packed)

    return build


DIRECT_WRITES = [
    (1, 0, "kv", ("add", "w0"), "a0"),
    (5, 3, "g", ("add", "w1"), "a1"),
    (10, 7, "kv", ("add", "w2"), "a2"),
]


def _harness(P, obs, plan_ops, **kw):
    sched = kw.pop("schedule_of", None)
    if sched is not None:
        kw["schedule"] = sched(P)
    twin_n = kw.pop("twin_n", 12)
    if kw.pop("twin", False):
        kw["build_twin"] = _hb(P, n=twin_n, packed=kw.get("packed", False))
    packed = kw.pop("packed", False)
    obs.append(P.mem.run_membership_harness(_hb(P, packed=packed), plan_ops, **kw))


@pytest.mark.parametrize("preset", ["ring-cut", "flaky-links"])
@pytest.mark.parametrize("packed", [False, True])
def test_harness_direct_workload_twin_bit_equality(preset, packed):
    rec = _twin(_harness, [(2, "join", 18), (8, "leave", 12)], twin=True,
                packed=packed, preset=preset, seed=5, nemesis_rounds=8,
                writes=DIRECT_WRITES, per_cycle=3)
    assert rec[0]["bit_identical_to_twin"] and rec[0]["replay_identical"]


def test_harness_quorum_workload_rolling_crash():
    rec = _twin(_harness, [(3, "join", 16), (9, "leave", 12)],
                preset="rolling-crash", seed=7, nemesis_rounds=10,
                quorum_writes=[(1, "kv", ("add", "q0"), "c0", 0),
                               (4, "kv", ("add", "q1"), "c1", 13),
                               (8, "kv", ("add", "q2"), "c2", 5),
                               (10, "kv", ("add", "q3"), "c3", 14)],
                per_cycle=2)
    assert rec[0]["no_write_lost"]


def test_harness_partition_during_handoff_and_crashed_departer():
    def part(P):
        return P.chaos.ChaosSchedule(12, ring(12, 2), [P.chaos.Partition(6, 14, 2)],
                                     seed=3)

    _twin(_harness, [(2, "join", 16), (7, "leave", 12)], schedule_of=part,
          quorum_writes=[(1, "kv", ("add", "p0"), "d0", 2),
                         (6, "kv", ("add", "p1"), "d1", 9),
                         (9, "kv", ("add", "p2"), "d2", 4)], per_cycle=2)

    def crash(P):
        return P.chaos.ChaosSchedule(12, ring(12, 2), [P.chaos.Crash(5, 10)], seed=11)

    rec = _twin(_harness, [(6, "leave", 10)], schedule_of=crash,
                quorum_writes=[(1, "kv", ("add", "h0"), "e0", 3),
                               (2, "kv", ("add", "h1"), "e1", 10)],
                per_cycle=1, max_rounds=256)
    assert rec[0]["final_n"] == 10 and rec[0]["membership"]["lost_sources"]


def test_harness_join_leave_down_with_a_write_on_a_crashed_row():
    def sched(P):
        return P.chaos.ChaosSchedule(12, ring(12, 2),
                                     [P.chaos.Crash(2, 5), P.chaos.Restore(8, 5)], seed=1)

    rec = _twin(_harness, [(4, "join", 16), (10, "leave", 12), (14, "down", 11)],
                twin=True, twin_n=11, schedule_of=sched,
                writes=[(1, 0, "g", ("add", "w0"), "a0"),
                        (3, 5, "g", ("add", "dropped"), "a1"),
                        (9, 2, "g", ("add", "w2"), "a2")], per_cycle=3)
    assert rec[0]["bit_identical_to_twin"] and rec[0]["epoch"] == 3


def test_harness_plan_ops_carry_neighbour_tables(monkeypatch):
    """The port's plan ops may carry the target topology (a fourth
    element): on ``random_regular(n, 3)`` tables, held against JAX's
    harness with its staging default swapped for the same tables."""
    import lasp_tpu.mesh.topology as jtopo

    monkeypatch.setattr(jtopo, "ring", lambda n, _k=2: jmesh.random_regular(n, 3, seed=n))

    def topo(n):
        return jmesh.random_regular(n, 3, seed=n)

    def scenario(P, obs):
        def build(n):
            def make():
                store = P.Store(n_actors=32)
                store.declare(id="kv", type="lasp_orset", n_elems=64,
                              tokens_per_actor=8)
                store.declare(id="g", type="lasp_gset", n_elems=64)
                return P.RT(store, P.Graph(store), n, topo(n))

            return make

        ops = [(4, "join", 16), (10, "leave", 12), (14, "down", 11)]
        if P.port:
            ops = [op + (topo(op[2]),) for op in ops]
        for kw in (dict(build_twin=build(11),
                        writes=[(1, 0, "g", ("add", "w0"), "a0"),
                                (9, 2, "kv", ("add", "w2"), "a2")]),
                   dict(quorum_writes=[(1, "kv", ("add", "q0"), "c0", 0),
                                       (8, "kv", ("add", "q1"), "c1", 5)])):
            obs.append(P.mem.run_membership_harness(
                build(12), ops, preset="rolling-crash", seed=7,
                nemesis_rounds=10, per_cycle=3, **kw))

    rec = _twin(scenario)
    assert rec[0]["bit_identical_to_twin"] and rec[1]["no_write_lost"]
    assert rec[0]["final_n"] == rec[1]["final_n"] == 11
