"""The port's quorum layer against ``lasp_tpu.quorum``: the FSM helpers and
the batched transition (a PyTorch step here, a jitted kernel there) on
randomized control planes; twins of ``tests/quorum/test_engine.py``,
``test_epoch_fence.py`` and ``test_hints_prune.py`` — results, ack
sequences (the protocol trace), repair and push accounting, final states
and ``report`` — for the batched and the sequential engine, the durable
hint log and the epoch fence. Each scenario runs through both packages
and what it observes must be equal (tolerance zero)."""

import numpy as np
import pytest
import torch

import lasp_tpu.chaos as jchaos
import lasp_tpu.quorum.fsm as jfsm
import lasp_tpu_torch.quorum as tquorum
import lasp_tpu_torch.quorum.fsm as tfsm
from lasp_tpu.mesh import random_regular, ring, scale_free
from tests.test_torch_chaos import _fp, _pkg, _twin

torch.set_num_threads(1)


def _results(qr) -> list:
    return [qr.result(rid, raise_on_error=False) for rid in range(qr._next_rid)]


def _build(P, R, nbrs, type="lasp_gset", packed=False, **caps):
    store = P.Store(n_actors=16)
    caps.setdefault("n_elems", 32)
    if type == "riak_dt_orswot":
        caps.setdefault("n_actors", 16)
    v = store.declare(id="kv", type=type, **caps)
    rt = P.RT(store, P.Graph(store), R, nbrs, packed=packed)
    return rt, v


# -- the FSM layer -------------------------------------------------------------

def test_preflist_coordinator_and_bucket_equal_jax():
    for coord, n, r in ((0, 3, 8), (6, 3, 8), (5, 1, 6), (99, 4, 100)):
        assert tfsm.preflist(coord, n, r).tolist() == jfsm.preflist(coord, n, r).tolist()
    with pytest.raises(ValueError):
        tfsm.preflist(0, 9, 8)
    rng = np.random.RandomState(0)
    for _ in range(20):
        crashed = rng.rand(12) < 0.5
        for c in range(12):
            assert tfsm.next_live_coordinator(c, crashed) == jfsm.next_live_coordinator(
                c, crashed)
    assert tfsm.next_live_coordinator(1, np.ones(6, bool)) is None
    assert [tfsm.bucket_of(b) for b in (0, 1, 8, 9, 100, 4096)] == [
        jfsm.bucket_of(b) for b in (0, 1, 8, 9, 100, 4096)]
    assert tfsm.STATE_NAMES == jfsm.STATE_NAMES


@pytest.mark.parametrize("topology", ["ring", "random", "scale_free"])
def test_components_equal_jax(topology):
    R = 40
    nbrs = {"ring": ring(R, 2), "random": random_regular(R, 3, seed=7),
            "scale_free": scale_free(R, 2, seed=3)}[topology]
    for preset in jchaos.PRESETS:
        js = jchaos.nemesis(preset, R, nbrs, seed=2, rounds=6)
        for rnd in range(js.horizon + 1):
            live = ~js.crashed_at(rnd)
            want = jfsm.components(nbrs, js.mask_at(rnd), live)
            got = tfsm.components(nbrs, js.mask_at(rnd), live)
            assert got.dtype == want.dtype and np.array_equal(got, want)


def _random_control_plane(rng, b, n, R):
    state = rng.choice(
        [jfsm.WAITING_R, jfsm.WAITING_N, jfsm.DONE, jfsm.FAILED],
        size=b, p=[0.5, 0.3, 0.1, 0.1],
    ).astype(np.int32)
    coord = rng.randint(0, R, size=b).astype(np.int32)
    picks = np.stack([jfsm.preflist(c, n, R) for c in coord]).astype(np.int32)
    pick_valid = np.ones((b, n), dtype=bool)
    for i in rng.choice(b, size=b // 4, replace=False):
        pick_valid[i, rng.randint(1, n):] = False
    acks = (rng.rand(b, n) < 0.3) & pick_valid
    deadline = rng.randint(0, 8, size=b).astype(np.int32)
    need = rng.randint(1, n + 1, size=b).astype(np.int32)
    degraded = rng.rand(b) < 0.3
    return state, coord, picks, pick_valid, acks, deadline, need, degraded


@pytest.mark.parametrize("topology", ["ring", "random"])
def test_transition_batched_equal_jax_and_sequential(topology):
    """The PyTorch batched step equals JAX's jitted kernel and both
    sequential references on every output, over randomized control planes
    × masked reachability × batch sizes across bucket boundaries."""
    R, n = 16, 3
    nbrs = ring(R, 2) if topology == "ring" else random_regular(R, 3, seed=7)
    sched = jchaos.ChaosSchedule(
        R, nbrs, [jchaos.Partition(0, 3, 2), jchaos.DelayLinks(3, 6, frac=0.5, delay=1),
                  jchaos.Crash(1, 5), jchaos.Crash(2, 11)], seed=9)
    rng = np.random.RandomState(42)
    for rnd in range(6):
        live = ~sched.crashed_at(rnd)
        comp = jfsm.components(nbrs, sched.mask_at(rnd), live)
        for b in (1, 5, 8, 17, 64):
            plane = _random_control_plane(rng, b, n, R)
            got = tfsm.transition_batched(*plane, comp, live, rnd, device="cpu")
            want = jfsm.transition_batched(*plane, comp, live, rnd)
            seq = tfsm.transition_sequential(*plane, comp, live, rnd)
            jseq = jfsm.transition_sequential(*plane, comp, live, rnd)
            for g, w, s, js in zip(got, want, seq, jseq):
                assert g.dtype == w.dtype and g.shape == w.shape, (rnd, b)
                assert np.array_equal(g, w) and np.array_equal(s, w), (rnd, b)
                assert np.array_equal(js, w), (rnd, b)


# -- QuorumRuntime: twins of tests/quorum/test_engine.py ------------------------

def test_put_reaches_w_then_finalizes_all_n():
    def scenario(P, obs):
        rt, v = _build(P, 8, ring(8, 2))
        qr = P.quorum.QuorumRuntime(rt)
        rid = qr.submit_put(v, ("add", "x"), "w0", coordinator=2)
        obs.append(qr.step())
        obs.append((qr.result(rid), rt.replica_value(v, 3), qr.acked_terms,
                    qr.trace, qr.report(), _fp(P, rt)))

    _twin(scenario)


def test_get_value_is_quorum_join_and_repairs():
    def scenario(P, obs):
        rt, v = _build(P, 8, ring(8, 2))
        rt.update_at(5, v, ("add", "y"), "w5")
        qr = P.quorum.QuorumRuntime(rt)
        rid = qr.submit_get(v, coordinator=5)
        obs.append(qr.step())
        obs.append((qr.result(rid), rt.replica_value(v, 6), qr.repaired_rows,
                    qr.wire_bytes, qr.trace, _fp(P, rt)))

    _twin(scenario)


def test_timeout_repick_moves_coordinator_past_crash():
    def scenario(P, obs):
        nbrs = ring(8, 2)
        rt, v = _build(P, 8, nbrs)
        rt.update_at(4, v, ("add", "z"), "w4")
        c = P.chaos
        ch = c.ChaosRuntime(rt, c.ChaosSchedule(
            8, nbrs, [c.Crash(0, 0), c.Restore(6, 0)], seed=1))
        qr = P.quorum.QuorumRuntime(ch, timeout=2, retries=2)
        rid = qr.submit_get(v, coordinator=0)
        while qr.inflight:
            obs.append(qr.step())
        obs.append((qr.result(rid), qr.report(), qr.trace, _fp(P, rt)))

    _twin(scenario)


def test_strict_and_degraded_gets_under_a_partition():
    def scenario(P, obs):
        R = 16
        nbrs = ring(R, 2)
        c = P.chaos
        for degraded in (False, True):
            rt, v = _build(P, R, nbrs)
            rt.update_at(15, v, ("add", "edge"), "w15")
            qr = P.quorum.QuorumRuntime(c.ChaosRuntime(rt, c.ChaosSchedule(
                R, nbrs, [c.Partition(0, 10, 8)], seed=2)), timeout=2, retries=1)
            rid = qr.submit_get(v, coordinator=15, r=3, degraded=degraded)
            obs.append(qr.step())
            obs.append(qr.result(rid, raise_on_error=False))
            while qr.inflight:
                obs.append(qr.step())
            obs.append((qr.result(rid, raise_on_error=False), qr.report(),
                        qr.trace, _fp(P, rt)))
            if not degraded:
                try:
                    qr.result(rid)
                except P.quorum.PartialQuorumError as exc:
                    obs.append(str(exc))

    _twin(scenario)


def test_inflight_batch_advances_together():
    def scenario(P, obs):
        R = 32
        rt, v = _build(P, R, ring(R, 2), n_elems=256)
        qr = P.quorum.QuorumRuntime(rt)
        for i in range(64):
            qr.submit_put(v, ("add", f"e{i}"), f"w{i}", coordinator=i % R)
        for i in range(64):
            qr.submit_get(v, coordinator=(i * 7) % R)
        obs.append(qr.step())
        obs.append((qr.inflight, _results(qr), qr.trace, qr.report(), _fp(P, rt)))

    _twin(scenario)


@pytest.mark.parametrize("type_name,packed,topo", [
    ("lasp_gset", False, "ring"),
    ("riak_dt_orswot", False, "random"),
    ("lasp_orset", True, "ring"),
])
@pytest.mark.parametrize("preset", ["flaky-links", "rolling-crash"])
def test_batched_and_sequential_engines_equal_jax(type_name, packed, topo, preset):
    """The contract of ``test_batched_engine_bit_identical_to_sequential``
    across both packages: the port's batched and sequential engines and
    JAX's two all give the same trace, results, accounting and final
    fingerprint."""
    R = 16
    nbrs = ring(R, 2) if topo == "ring" else random_regular(R, 3, seed=3)

    def scenario(P, obs):
        for engine in ("batched", "sequential"):
            rt, v = _build(P, R, nbrs, type=type_name, packed=packed)
            ch = P.chaos.ChaosRuntime(rt, P.chaos.nemesis(preset, R, nbrs, seed=5,
                                                          rounds=6))
            qr = P.quorum.QuorumRuntime(ch, engine=engine, timeout=3, retries=3)
            for i in range(14):
                if i < 6:
                    coord = (i * 5) % R
                    if not ch.crashed[coord]:
                        qr.submit_put(v, ("add", f"e{i}"), f"w{i}", coordinator=coord)
                    qr.submit_get(v, coordinator=int(np.flatnonzero(~ch.crashed)[0]),
                                  degraded=True)
                qr.step()
            while qr.inflight:
                qr.step()
            rep = qr.report()
            obs.append({
                "trace": qr.trace, "fp": _fp(P, rt), "results": _results(qr),
                "report": {k: x for k, x in rep.items() if k != "engine"},
                "accounting": (qr.repaired_rows, qr.pushed_rows, qr.wire_bytes,
                               qr.completed, qr.failed, qr.retries),
            })
        assert obs[0] == obs[1]  # batched == sequential within a package

    _twin(scenario)


def _adversarial_loss_schedule(P, R, nbrs):
    c = P.chaos
    return c.ChaosSchedule(R, nbrs, [
        c.Partition(0, 8, 3), c.Crash(2, 0), c.Crash(2, 1), c.Crash(2, 2),
        c.Restore(4, 0), c.Restore(4, 1), c.Restore(4, 2)], seed=1)


@pytest.mark.parametrize("sabotage", [False, True])
def test_acked_write_and_total_preflist_crash(sabotage):
    """With the hint log the acked write survives the crash of its whole
    preflist; with the log pruned before every step it is lost."""
    def scenario(P, obs):
        R = 9
        nbrs = ring(R, 2)
        rt, v = _build(P, R, nbrs)
        ch = P.chaos.ChaosRuntime(rt, _adversarial_loss_schedule(P, R, nbrs))
        qr = P.quorum.QuorumRuntime(ch, timeout=3, retries=2)
        qr.submit_put(v, ("add", "precious"), "w0", coordinator=0)
        while qr.inflight or ch.round <= ch.schedule.horizon:
            if sabotage:
                qr.hints.prune()
            obs.append(qr.step())
        rt.run_to_convergence()
        try:
            P.inv.check_no_write_lost(rt, qr.acked_terms)
            obs.append("kept")
        except P.inv.InvariantViolation:
            obs.append("lost")
        obs.append((rt.coverage_value(v), qr.hints.replays, qr.trace, _fp(P, rt)))

    trec = _twin(scenario)
    assert trec[-2] == ("lost" if sabotage else "kept")


def test_hint_log_durable_roundtrip(tmp_path):
    def scenario(P, obs):
        path = str(tmp_path / f"hints_{P.port}.log")
        rt, v = _build(P, 8, ring(8, 2))
        qr = P.quorum.QuorumRuntime(rt, hints=path)
        qr.submit_put(v, ("add", "x"), "w0", coordinator=0)
        obs.append(qr.step())
        log2 = P.quorum.HintLog(path)
        obs.append((len(qr.hints), len(log2)))
        rt.reseed_row(1, None)
        obs.append(rt.replica_value(v, 1))
        obs.append(log2.replay(rt, 1))
        obs.append((rt.replica_value(v, 1), log2.replay(rt, 1)))
        obs.append((log2.prune(), len(P.quorum.HintLog(path))))

    _twin(scenario)


def test_run_quorum_harness_rolling_crash(tmp_path):
    """The harness end to end, with replay, in memory and with a durable
    hint log re-entered over a populated file."""
    def scenario(P, obs):
        R = 16
        nbrs = ring(R, 2)

        def build():
            store = P.Store(n_actors=16)
            store.declare(id="kv", type="lasp_gset", n_elems=32)
            return P.RT(store, P.Graph(store), R, nbrs)

        sched = P.chaos.nemesis("rolling-crash", R, nbrs, seed=11, rounds=9)
        obs.append(P.inv.run_quorum_harness(
            build, sched,
            writes=[(rnd, "kv", ("add", f"t{rnd}"), f"w{rnd}", (rnd * 3) % R)
                    for rnd in range(4)],
            reads=[(3, "kv", 1)], timeout=3, retries=3))
        path = str(tmp_path / f"hints_{P.port}.log")
        sched2 = P.chaos.nemesis("rolling-crash", 12, ring(12, 2), seed=4, rounds=8)

        def build12():
            store = P.Store(n_actors=16)
            store.declare(id="kv", type="lasp_gset", n_elems=32)
            return P.RT(store, P.Graph(store), 12, ring(12, 2))

        for _ in range(2):
            obs.append(P.inv.run_quorum_harness(
                build12, sched2,
                writes=[(i, "kv", ("add", f"t{i}"), f"w{i}", (i * 5) % 12)
                        for i in range(2)],
                hints_path=path, timeout=3, retries=3, engine="sequential"))

    _twin(scenario)


def test_repicked_coordinator_receives_the_write():
    def scenario(P, obs):
        R = 6
        nbrs = ring(R, 2)
        rt, v = _build(P, R, nbrs)
        qr = P.quorum.QuorumRuntime(P.chaos.ChaosRuntime(rt, P.chaos.ChaosSchedule(
            R, nbrs, [P.chaos.Partition(0, 20, 2)], seed=0)), timeout=2, retries=3)
        rid = qr.submit_put(v, ("add", "x"), "w", coordinator=2)
        while qr.inflight:
            obs.append(qr.step())
        res = qr.result(rid)
        obs.append((res, [rt.quorum_value(v, [r]) for r in res["acks"]],
                    qr.trace, _fp(P, rt)))

    _twin(scenario)


def test_report_lands_in_health_surface():
    from lasp_tpu_torch.telemetry import get_monitor

    rt, v = _build(_pkg(True), 8, ring(8, 2))
    qr = tquorum.QuorumRuntime(rt)
    qr.submit_put(v, ("add", "x"), "w0", coordinator=0)
    qr.step()
    rep = qr.report()
    health = get_monitor().health()
    assert health["quorum"]["completed"] == rep["completed"]
    assert health["quorum"]["put_p50_rounds"] == rep["put_p50_rounds"]
    assert qr.fsm_seconds > 0


def test_submit_validation():
    def scenario(P, obs):
        rt, v = _build(P, 8, ring(8, 2))
        qr = P.quorum.QuorumRuntime(rt)
        for fn, args, kw in ((qr.submit_get, ("nope",), {}),
                             (qr.submit_get, (v,), {"coordinator": 99}),
                             (qr.submit_get, (v,), {"r": 4}),
                             (P.quorum.QuorumRuntime, (rt,), {"engine": "warp"}),
                             (P.quorum.QuorumRuntime, (rt,), {"n": 9})):
            try:
                fn(*args, **kw)
                obs.append("ok")
            except (KeyError, IndexError, ValueError) as exc:
                obs.append(type(exc).__name__)

    _twin(scenario)


# -- the epoch fence: twins of tests/quorum/test_epoch_fence.py --------------------

def _fence_rt(P, n=8):
    store = P.Store(n_actors=16)
    store.declare(id="kv", type="lasp_gset", n_elems=32)
    return P.RT(store, P.Graph(store), n, ring(n, 2))


def _partitioned(P, n=8, rounds=16):
    rt = _fence_rt(P, n)
    return rt, P.chaos.ChaosRuntime(rt, P.chaos.ChaosSchedule(
        n, rt._host_neighbors, [P.chaos.Partition(0, rounds, 4)]))


@pytest.mark.parametrize("case", [
    "fail_typed", "reprepare", "remap", "grow", "shrink_spares", "fresh", "too_wide",
])
def test_epoch_fence_equal_jax(case):
    def scenario(P, obs):
        Q = P.quorum
        if case == "fail_typed":
            rt, ch = _partitioned(P)
            qr = Q.QuorumRuntime(ch, timeout=32, retries=0)
            rid = qr.submit_get("kv", coordinator=6, r=3)
            qr.step()
            obs.append(qr.result(rid, raise_on_error=False))
            rt.resize(4, ring(4, 2), graceful=False)
            qr.step()
            try:
                qr.result(rid)
            except P.Stale as exc:
                obs.append((exc.current_epoch, rt.membership_epoch))
        elif case in ("reprepare", "grow", "shrink_spares"):
            rt, ch = _partitioned(P, rounds=4 if case == "reprepare" else 3)
            qr = Q.QuorumRuntime(ch, timeout=32, retries=2)
            coord = {"reprepare": 6, "grow": 5, "shrink_spares": 0}[case]
            rid = qr.submit_get("kv", coordinator=coord, r=3)
            qr.step()
            if case == "reprepare":
                rt.resize(4, ring(4, 2), graceful=False)
            elif case == "grow":
                rt.resize(12, ring(12, 2))
            else:
                rt.resize(6, ring(6, 2), graceful=False)
            for _ in range(12):
                qr.step()
                if qr.result(rid, raise_on_error=False)["status"] == "done":
                    break
            obs.append(qr.result(rid, raise_on_error=False))
        elif case == "remap":
            rt = _fence_rt(P)
            qr = Q.QuorumRuntime(rt, timeout=6, retries=0)
            qr.submit_put("kv", ("add", "k"), "w0", coordinator=6)
            rt.resize(4, ring(4, 2), graceful=True)
            while qr.inflight:
                qr.step()
            obs.append(rt.coverage_value("kv"))
        elif case == "fresh":
            rt = _fence_rt(P)
            qr = Q.QuorumRuntime(rt, timeout=6, retries=1)
            rt.resize(4, ring(4, 2), graceful=True)
            qr.submit_put("kv", ("add", "fresh"), "w1", coordinator=1)
            while qr.inflight:
                qr.step()
        else:
            rt = _fence_rt(P)
            qr = Q.QuorumRuntime(rt, n=6, timeout=6, retries=2)
            rid = qr.submit_put("kv", ("add", "wide"), "w0", coordinator=0, n=6, w=2)
            rt.resize(4, ring(4, 2), graceful=True)
            qr.step()
            try:
                qr.result(rid)
            except P.Stale as exc:
                obs.append("preflist width" in str(exc))
            qr.submit_put("kv", ("add", "fits"), "w1", coordinator=1, n=3, w=2)
            while qr.inflight:
                qr.step()
        obs.append((_results(qr), qr.trace, qr.report(), _fp(P, rt)))

    _twin(scenario)


# -- hint reclamation and restore ordering: twins of test_hints_prune.py ------------

def test_prune_replayed_semantics(tmp_path):
    def scenario(P, obs):
        R = 9
        rt, v = _build(P, R, ring(R, 2))
        log = P.quorum.HintLog(str(tmp_path / f"prune_{P.port}.log"))
        rt.update_at(0, v, ("add", "x"), "w")
        rt.update_at(4, v, ("add", "y"), "u")
        row_x, row_y = P.row(rt, v, 0), P.row(rt, v, 4)
        log.append(v, np.asarray([0, 1, 2]), row_x, rid=0)
        log.append(v, np.asarray([4, 5, 6]), row_y, rid=1)
        obs.append((log.prune_replayed(rt, 0), len(log)))
        rt.join_rows(v, np.asarray([1, 2]), row_x)
        live = np.ones(R, dtype=bool)
        live[2] = False
        obs.append(log.prune_replayed(rt, 0, live=live))
        obs.append((log.prune_replayed(rt, 0), len(log)))
        log2 = P.quorum.HintLog(log.path)
        obs.append((len(log2), len(log2.pending_for(4)), len(log2.pending_for(0))))

    _twin(scenario)


@pytest.mark.parametrize("case", ["repeat_crash", "prune_then_restore", "adversarial",
                                  "replay_before_serve"])
def test_hint_replay_and_reclaim_equal_jax(case):
    def scenario(P, obs):
        R = 9
        rt, v = _build(P, R, ring(R, 2))
        c = P.chaos
        events = {
            "repeat_crash": [c.Crash(2, 1), c.Restore(4, 1), c.Crash(6, 1),
                             c.Restore(8, 1)],
            "prune_then_restore": [c.Crash(2, 1), c.Restore(4, 1), c.Crash(6, 2),
                                   c.Restore(8, 2)],
            "adversarial": [c.Partition(0, 8, 3), c.Crash(2, 0), c.Crash(2, 1),
                            c.Crash(2, 2), c.Restore(4, 0), c.Restore(4, 1),
                            c.Restore(4, 2)],
            "replay_before_serve": [c.Partition(2, 12, R), c.Crash(3, 1),
                                    c.Restore(5, 1)],
        }[case]
        ch = c.ChaosRuntime(rt, c.ChaosSchedule(R, rt._host_neighbors, events, seed=3))
        qr = P.quorum.QuorumRuntime(ch, timeout=3 if case != "replay_before_serve" else 2,
                                    retries=2 if case != "replay_before_serve" else 1)
        qr.submit_put(v, ("add", "precious"), "w0", coordinator=0)
        if case == "replay_before_serve":
            while ch.round < 5:
                qr.step()
            qr.submit_get(v, coordinator=1, degraded=True, r=1, n=1)
            qr.step()
        while qr.inflight or ch.round <= ch.schedule.horizon:
            qr.step()
        rt.run_to_convergence()
        obs.append((rt.coverage_value(v), qr.hints.replays, len(qr.hints),
                    _results(qr), qr.trace, qr.report(), _fp(P, rt)))

    _twin(scenario)


def test_restore_from_quiescent_checkpoint_degrades_frontier(tmp_path):
    def scenario(P, obs):
        R = 9
        rt, v = _build(P, R, ring(R, 2))
        rt.update_at(0, v, ("add", "x"), "w")
        rt.run_to_convergence()
        obs.append(rt.frontier_size(v))
        path = str(tmp_path / f"ckpt_{P.port}")
        P.save_runtime(rt, path)
        rt.update_at(2, v, ("add", "later"), "u")
        rt.run_to_convergence()
        rt.reseed_row(3, P.load_rows(path, 3))
        obs.append(bool(rt._frontier[v].all()))
        obs.append(rt.run_to_convergence())
        obs.append((rt.replica_value(v, 3), _fp(P, rt)))

    _twin(scenario)


def test_quorum_kv_scenario_matches_jax():
    """``bench_scenarios.quorum_kv`` at 32 replicas under every preset: the
    same per-preset rounds, request outcomes, latency percentiles,
    staleness, wire bytes and hint replays as JAX's; the sequential engine
    gives the batched engine's states and protocol trace."""
    import lasp_tpu.bench_scenarios as jb
    import lasp_tpu_torch.bench_scenarios as tb

    kw = dict(client_rounds=3, puts_per_round=3, gets_per_round=3)
    want = jb.quorum_kv(32, **kw)
    got = tb.quorum_kv(32, device="cpu", **kw)
    assert list(got["presets"]) == list(want["presets"])
    for preset, w in want["presets"].items():
        g = got["presets"][preset]
        for key, value in w.items():
            if key != "seconds":
                assert g[key] == value, (preset, key)
    seq = tb.quorum_kv(32, device="cpu", presets=("rolling-crash",),
                       engine="sequential", **kw)["presets"]["rolling-crash"]
    bat = got["presets"]["rolling-crash"]
    for key in ("state_fingerprint", "trace_sha256", "requests", "completed",
                "repair_wire_bytes"):
        assert seq[key] == bat[key], key
