"""The port's chaos layer against ``lasp_tpu.chaos``: the schedule's masks
for every preset and corruption preset on ring, random-regular and
scale-free topologies; twins of each ``tests/chaos/test_engine.py`` case
(crash freeze, write refusal, restore, degraded reads and read-repair,
partition confinement, fused windows, actor retirement, checkpoint
restore), silent corruption, the crash freeze around dataflow sweeps, and
the invariant checks (``run_harness``'s preset matrix is in
``test_torch_chaos_harness.py``). Each
scenario runs through both packages and what it observes (values, states
bit for bit as fingerprints, residuals, reports, exceptions) must be equal
(tolerance zero)."""

import types

import jax
import numpy as np
import pytest
import torch

import lasp_tpu.chaos as jchaos
import lasp_tpu.chaos.invariants as jinv
import lasp_tpu.chaos.schedule as jsched
import lasp_tpu.mesh as jmesh
import lasp_tpu.quorum as jquorum
import lasp_tpu.store as jstore
import lasp_tpu.store.checkpoint as jckpt
import lasp_tpu_torch.chaos as tchaos
import lasp_tpu_torch.chaos.invariants as tinv
import lasp_tpu_torch.chaos.schedule as tsched
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.quorum as tquorum
import lasp_tpu_torch.store as tstore
import lasp_tpu_torch.store.checkpoint as tckpt
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.mesh import random_regular, ring, scale_free
from lasp_tpu.membership import HandoffPartitionError as JHandoff
from lasp_tpu.membership import StaleEpochError as JStale
from lasp_tpu.mesh.runtime import ActorCollisionError as JActorCollision
from lasp_tpu_torch.dataflow import Graph as TGraph
from lasp_tpu_torch.lattice.base import tree_map
from lasp_tpu_torch.membership import HandoffPartitionError as THandoff
from lasp_tpu_torch.membership import StaleEpochError as TStale
from lasp_tpu_torch.mesh.runtime import ActorCollisionError as TActorCollision

torch.set_num_threads(1)

N = 32


def _pkg(port: bool):
    """One package's entry points, by the names the scenarios use (shared
    with ``test_torch_chaos_harness.py`` and ``test_torch_quorum.py``)."""
    if port:
        return types.SimpleNamespace(
            port=True, chaos=tchaos, inv=tinv, quorum=tquorum,
            Store=lambda **kw: tstore.Store(device="cpu", **kw),
            RT=lambda *a, **kw: tmesh.ReplicatedRuntime(*a, device="cpu", **kw),
            Graph=TGraph, save_runtime=tckpt.save_runtime,
            load_rows=tckpt.load_runtime_rows, ActorCollision=TActorCollision,
            Stale=TStale, HandoffError=THandoff,
            residuals=lambda rt: list(rt.round_residuals),
            row=lambda rt, v, r: tree_map(lambda x: x[r].clone(), rt._population(v)),
        )
    return types.SimpleNamespace(
        port=False, chaos=jchaos, inv=jinv, quorum=jquorum,
        Store=jstore.Store, RT=jmesh.ReplicatedRuntime, Graph=JGraph,
        save_runtime=jckpt.save_runtime, load_rows=jckpt.load_runtime_rows,
        ActorCollision=JActorCollision, Stale=JStale, HandoffError=JHandoff,
        residuals=lambda rt: [r["residual"] for r in rt.trace.rounds],
        row=lambda rt, v, r: jax.tree_util.tree_map(lambda x: x[r], rt._population(v)),
    )


def _fp(P, rt) -> str:
    return P.inv.fingerprint(P.inv.snapshot_states(rt))


def _twin(scenario, *args):
    """Run ``scenario(P, obs, *args)`` through both packages; their
    observation lists must be equal."""
    records = []
    for port in (False, True):
        obs: list = []
        scenario(_pkg(port), obs, *args)
        records.append(obs)
    jrec, trec = records
    assert len(jrec) == len(trec)
    for i, (x, y) in enumerate(zip(jrec, trec)):
        assert x == y, (i, x, y)
    return trec


def _raises(obs, exc_types, fn, *a, **kw):
    """Record the exception type name ``fn`` raised (one of ``exc_types``),
    or ``"ok"``."""
    try:
        fn(*a, **kw)
    except exc_types as exc:
        obs.append(type(exc).__name__)
        return exc
    obs.append("ok")
    return None


# -- the schedule: masks equal JAX's -----------------------------------------

_TOPOS = {
    "ring": lambda n: ring(n, 2),
    "random": lambda n: random_regular(n, 3, seed=1),
    "scale_free": lambda n: scale_free(n, 2, seed=2),
}


def _schedule_record(s) -> list:
    rec = [s.horizon, s.describe()]
    for rnd in range(s.horizon + 3):
        m = s.mask_at(rnd)
        rec.append(None if m is None else m.tobytes())
        rec.append(s.crashed_at(rnd).tobytes())
        rec.append(s.duplicate_links_at(rnd))
        rec.append([tuple(ev) for ev in s.actions_at(rnd)])
        rec.append([(i, tuple(ev), shot) for i, ev, shot in s.corruptions_at(rnd)])
        rec.append(s.next_action_round(rnd))
        rec.append([tuple(ev) for ev in s.active_at(rnd)])
    rec.append(s.masks(0, s.horizon + 2).tobytes())
    return rec


@pytest.mark.parametrize("topology", sorted(_TOPOS))
@pytest.mark.parametrize(
    "preset", sorted(jchaos.PRESETS + jchaos.CORRUPTION_PRESETS)
)
def test_preset_masks_equal_jax(preset, topology):
    assert tchaos.PRESETS == jchaos.PRESETS
    assert tchaos.CORRUPTION_PRESETS == jchaos.CORRUPTION_PRESETS
    nbrs = _TOPOS[topology](48)
    for seed in (0, 9):
        js = jchaos.nemesis(preset, 48, nbrs, seed=seed, rounds=8)
        ts = tchaos.nemesis(preset, 48, nbrs, seed=seed, rounds=8)
        assert _schedule_record(ts) == _schedule_record(js)
        # a re-based timeline (a shrunk population) compiles alike too
        small = _TOPOS[topology](40)
        assert _schedule_record(ts.rebase(40, small)) == _schedule_record(
            js.rebase(40, small))


def _every_event(P):
    c = P.chaos
    return [
        c.Partition(1, 6, 3), c.FlakyLinks(0, 9, 0.35),
        c.DelayLinks(2, 10, frac=0.4, delay=2), c.DuplicateLinks(0, 7, 0.5),
        c.SlowShard(3, 11, shard=2, n_shards=4, period=3),
        c.Crash(2, 5), c.Restore(6, 5, source="checkpoint"), c.Crash(4, 17),
        c.Restore(9, 17), c.CorruptRows(3, kind="rollback", n_rows=2),
        c.BitRot(4, 10, every=3, kind="truncate"),
    ]


@pytest.mark.parametrize("topology", sorted(_TOPOS))
def test_composite_schedule_equal_jax(topology):
    """Every event kind at once, overlapping: masks, crash sets, duplicate
    counts, actions and corruption shots per round, and the mask stack."""
    nbrs = _TOPOS[topology](48)
    js = jchaos.ChaosSchedule(48, nbrs, _every_event(_pkg(False)), seed=5)
    ts = tchaos.ChaosSchedule(48, nbrs, _every_event(_pkg(True)), seed=5)
    assert _schedule_record(ts) == _schedule_record(js)
    # a stable fault window returns ONE mask object (the frontier contract)
    p = tchaos.ChaosSchedule(48, nbrs, [tchaos.Partition(2, 6, 2)], seed=1)
    assert p.mask_at(3) is p.mask_at(4)


def test_mix_and_shard_rows_equal_jax():
    keys = np.random.RandomState(0).randint(0, 2**62, size=4096).astype(np.uint64)
    for salt in (0, 7919, 2**63 + 5, -3):
        assert np.array_equal(tsched._mix(keys, salt), jsched._mix(keys, salt))
    from lasp_tpu.mesh.shard_gossip import shard_rows

    for n, s, k in ((100, 4, 3), (7, 4, 0), (3, 8, 7), (1000, 3, 1)):
        assert np.array_equal(tsched.shard_rows(n, s, k), shard_rows(n, s, k))


def test_schedule_validation_equal_jax():
    def scenario(P, obs):
        c, nbrs = P.chaos, ring(N, 2)
        errs = (ValueError, TypeError)
        _raises(obs, errs, c.ChaosSchedule, N, nbrs, [c.Restore(2, 3)])
        _raises(obs, errs, c.ChaosSchedule, N, nbrs, [c.Crash(1, 3), c.Crash(2, 3)])
        _raises(obs, errs, c.ChaosSchedule, N, nbrs, [c.Partition(5, 5, 2)])
        _raises(obs, errs, c.ChaosSchedule, N, nbrs, [("boom", 1)])
        _raises(obs, errs, c.ChaosSchedule, N, nbrs, [c.Crash(1, N)])
        _raises(obs, errs, c.ChaosSchedule, N, nbrs, [c.BitRot(1, 4, kind="melt")])
        _raises(obs, errs, c.nemesis, "split-brain", N, nbrs)
        _raises(obs, errs, c.nemesis, "ring-cut", N, nbrs, frobnicate=1)

    _twin(scenario)


# -- ChaosRuntime: twins of tests/chaos/test_engine.py ------------------------

def _build(P, nbrs, type="lasp_gset", n=N, **caps):
    store = P.Store(n_actors=8)
    caps.setdefault("n_elems", 16)
    v = store.declare(id="v", type=type, **caps)
    rt = P.RT(store, P.Graph(store), n, nbrs)
    return rt, v


def test_crashed_row_freezes_and_writes_refused():
    def scenario(P, obs):
        nbrs = ring(N, 2)
        rt, v = _build(P, nbrs)
        rt.update_at(0, v, ("add", "x"), "w0")
        ch = P.chaos.ChaosRuntime(rt, P.chaos.ChaosSchedule(
            N, nbrs, [P.chaos.Crash(0, 9), P.chaos.Restore(6, 9)], seed=1))
        for _ in range(4):
            obs.append(ch.step())
        obs.append((rt.replica_value(v, 9), _fp(P, rt)))
        _raises(obs, P.chaos.ReplicaDownError, ch.write_at, 9, v, ("add", "y"), "w9")
        exc = _raises(obs, P.chaos.ReplicaDownError, ch.write_batch, v,
                      [(3, ("add", "a"), "c3"), (9, ("add", "y"), "w9"),
                       (4, ("add", "b"), "c4")])
        obs.append(exc.batch_index)
        obs.append(ch.soak())
        obs.append((rt.replica_value(v, 9), rt.coverage_value(v),
                    rt.divergence(v), _fp(P, rt), P.residuals(rt)))

    _twin(scenario)


def test_degraded_read_answers_live_and_repair_bounded():
    def scenario(P, obs):
        nbrs = ring(N, 2)
        rt, v = _build(P, nbrs)
        c = P.chaos
        ch = c.ChaosRuntime(rt, c.ChaosSchedule(
            N, nbrs, [c.Partition(0, 8, 2), c.Crash(0, N - 1),
                      c.Restore(8, N - 1)], seed=2))
        rt.update_at(0, v, ("add", "x"), "w0")
        for _ in range(3):
            obs.append(ch.step())
        obs.append(ch.degraded_read(v, k=2))
        obs.append((ch.degraded_reads, ch.repaired_rows, ch.repair_bytes))
        obs.append(rt.replica_value(v, int(ch.live_replicas()[1])))
        obs.append(ch.soak())
        obs.append((rt.divergence(v), _fp(P, rt), P.residuals(rt)))

    _twin(scenario)


def test_degraded_read_never_crosses_a_partition():
    def scenario(P, obs):
        nbrs = ring(N, 2)
        rt, v = _build(P, nbrs)
        ch = P.chaos.ChaosRuntime(rt, P.chaos.ChaosSchedule(
            N, nbrs, [P.chaos.Partition(0, 12, 2)], seed=4))
        rt.update_at(2, v, ("add", "left"), "wl")
        rt.update_at(N - 2, v, ("add", "right"), "wr")
        for _ in range(6):
            obs.append(ch.step(mode="frontier"))
        obs.append(ch.degraded_read(v, k=3, coordinator=2))
        obs.append(ch.degraded_read(v, k=3, coordinator=N - 2))
        obs.append([rt.replica_value(v, r) for r in range(N)])
        obs.append(ch._reachable_live(2).tobytes())
        obs.append(ch.soak(mode="frontier"))
        obs.append((rt.coverage_value(v), _fp(P, rt), P.residuals(rt)))

    _twin(scenario)


def test_degraded_read_quorum_larger_than_reachable_clamps():
    def scenario(P, obs):
        nbrs = ring(N, 2)
        rt, v = _build(P, nbrs)
        ch = P.chaos.ChaosRuntime(rt, P.chaos.ChaosSchedule(
            N, nbrs, [P.chaos.Partition(0, 8, 8)], seed=3))
        rt.update_at(1, v, ("add", "near"), "w1")
        rt.update_at(20, v, ("add", "far"), "w2")
        for _ in range(4):
            obs.append(ch.step())
        obs.append(ch.degraded_read(v, k=12, coordinator=0))
        qr = P.quorum.QuorumRuntime(ch, n=3, r=3, timeout=2, retries=0)
        rid = qr.submit_get(v, coordinator=30, r=3)
        while qr.inflight:
            obs.append(qr.step())
        obs.append(qr.result(rid, raise_on_error=False))
        _raises(obs, P.quorum.PartialQuorumError, qr.result, rid)
        obs.append((qr.trace, _fp(P, rt)))

    _twin(scenario)


def test_degraded_read_repair_false_accounting():
    def scenario(P, obs):
        nbrs = ring(N, 2)
        rt, v = _build(P, nbrs)
        ch = P.chaos.ChaosRuntime(rt, P.chaos.ChaosSchedule(
            N, nbrs, [P.chaos.Partition(0, 8, 2)], seed=5))
        rt.update_at(0, v, ("add", "x"), "w0")
        obs.append(ch.step())
        before = _fp(P, rt)
        obs.append(ch.degraded_read(v, k=3, repair=False))
        obs.append((ch.repaired_rows, ch.repair_bytes, _fp(P, rt) == before))
        obs.append(ch.degraded_read(v, k=3, repair=True))
        obs.append((ch.repaired_rows, ch.repair_bytes, _fp(P, rt)))

    _twin(scenario)


def test_degraded_read_confined_under_delay_links_mask():
    def scenario(P, obs):
        nbrs = ring(N, 2)
        rt, v = _build(P, nbrs)
        ch = P.chaos.ChaosRuntime(rt, P.chaos.ChaosSchedule(
            N, nbrs, [P.chaos.DelayLinks(0, 12, frac=1.0, delay=3)], seed=6))
        rt.update_at(0, v, ("add", "x"), "w0")
        rt.update_at(5, v, ("add", "y"), "w5")
        obs.append(ch.step())
        for coord in (0, 5, 9):
            obs.append(ch.degraded_read(v, k=3, coordinator=coord))
        obs.append(ch.soak())
        obs.append((rt.coverage_value(v), _fp(P, rt), P.residuals(rt)))

    _twin(scenario)


def test_degraded_read_without_live_replicas_raises():
    def scenario(P, obs):
        nbrs = ring(4, 2)
        rt, v = _build(P, nbrs, n=4, n_elems=4)
        c = P.chaos
        ch = c.ChaosRuntime(rt, c.ChaosSchedule(
            4, nbrs, [c.Crash(0, r) for r in range(4)]
            + [c.Restore(3, r) for r in range(4)], seed=0))
        obs.append(ch.step())
        _raises(obs, c.ReplicaDownError, ch.degraded_read, v)
        _raises(obs, c.ReplicaDownError, ch.degraded_read, v, coordinator=1)

    _twin(scenario)


def test_crash_retires_actor_lanes():
    def scenario(P, obs):
        nbrs = ring(N, 2)
        store = P.Store(n_actors=8)
        v = store.declare(id="v", type="riak_dt_orswot", n_elems=8, n_actors=8)
        rt = P.RT(store, P.Graph(store), N, nbrs, debug_actors=True)
        rt.update_at(3, v, ("add", "e"), "w3")
        ch = P.chaos.ChaosRuntime(rt, P.chaos.ChaosSchedule(
            N, nbrs, [P.chaos.Crash(0, 3), P.chaos.Restore(4, 3)], seed=0))
        obs.append(ch.soak())
        _raises(obs, P.ActorCollision, rt.update_at, 3, v, ("add", "f"), "w3")
        rt.update_at(3, v, ("add", "f"), "w3b")
        obs.append((sorted(rt._actor_sites.values()), rt.coverage_value(v),
                    _fp(P, rt)))

    _twin(scenario)


@pytest.mark.parametrize("type_name,caps", [
    ("lasp_gset", {}),
    ("riak_dt_orswot", {"n_actors": 8, "n_elems": 8}),
])
def test_fused_windows_match_per_round_and_split_on_actions(type_name, caps):
    def scenario(P, obs):
        nbrs = random_regular(N, 3, seed=4)

        def build():
            rt, v = _build(P, nbrs, type=type_name, **caps)
            rt.update_batch(
                v, [(0, ("add", "x"), "c0"), (11, ("add", "y"), "c11")])
            return rt, v

        c = P.chaos
        ev = [c.FlakyLinks(0, 6, 0.3), c.Crash(3, 7), c.Restore(6, 7)]
        ra, _ = build()
        rb, _ = build()
        ca = c.ChaosRuntime(ra, c.ChaosSchedule(N, nbrs, ev, seed=5))
        cb = c.ChaosRuntime(rb, c.ChaosSchedule(N, nbrs, ev, seed=5))
        obs.append(ca.soak(block=1))
        obs.append(cb.soak(block=4))
        obs.append((_fp(P, ra), _fp(P, rb), P.residuals(rb)))
        rc, vc = build()
        cc = c.ChaosRuntime(rc, c.ChaosSchedule(N, nbrs, ev, seed=5))
        _raises(obs, RuntimeError, cc.fused_steps, 8)
        obs.append(cc.fused_steps(3))  # [0, 3): before the crash
        obs.append((cc.round, cc.duplicates_suppressed, _fp(P, rc)))

    _twin(scenario)


def test_engine_refuses_mismatched_schedule():
    def scenario(P, obs):
        nbrs = ring(N, 2)
        rt, _v = _build(P, nbrs)
        c = P.chaos
        _raises(obs, ValueError, c.ChaosRuntime, rt,
                c.ChaosSchedule(N, ring(N, 4), [], seed=0))
        _raises(obs, ValueError, c.ChaosRuntime, rt,
                c.ChaosSchedule(N * 2, ring(N * 2, 2), [], seed=0))

    _twin(scenario)


def test_checkpoint_restore_row(tmp_path):
    def scenario(P, obs):
        nbrs = random_regular(N, 3, seed=6)
        store = P.Store(n_actors=8)
        v = store.declare(id="s", type="lasp_orset", n_elems=8, n_actors=8,
                          tokens_per_actor=2)
        rt = P.RT(store, P.Graph(store), N, nbrs)
        rt.update_at(3, v, ("add", "keep"), "w3")
        rt.update_at(3, v, ("add", "gone"), "w3")
        rt.run_to_convergence()
        path = str(tmp_path / f"chaos_ck_{P.port}.hs")
        P.save_runtime(rt, path)
        rt.update_at(3, v, ("remove", "gone"), "w3")
        ch = P.chaos.ChaosRuntime(rt, P.chaos.ChaosSchedule(
            N, nbrs, [P.chaos.Crash(1, 3),
                      P.chaos.Restore(5, 3, source="checkpoint")], seed=3),
            checkpoint=path)
        obs.append(ch.soak())
        obs.append((rt.coverage_value(v), rt.divergence(v), _fp(P, rt),
                    P.residuals(rt)))
        # a checkpoint restore without a path is refused
        rt2, v2 = _build(P, nbrs)
        ch2 = P.chaos.ChaosRuntime(rt2, P.chaos.ChaosSchedule(
            N, nbrs, [P.chaos.Crash(0, 1),
                      P.chaos.Restore(1, 1, source="checkpoint")], seed=0))
        obs.append(ch2.step())
        _raises(obs, RuntimeError, ch2.step)

    _twin(scenario)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("preset", sorted(jchaos.CORRUPTION_PRESETS))
def test_silent_corruption_equal_jax(preset, packed):
    """CorruptRows / BitRot mutate the same rows of the same variables the
    same way (JAX's dtypes: a packed word's rollback halves it as
    ``uint32``), round by round, in both modes."""
    def scenario(P, obs):
        nbrs = ring(24, 2)
        store = P.Store(n_actors=8)
        store.declare(id="g", type="lasp_gset", n_elems=16)
        store.declare(id="s", type="riak_dt_orswot", n_elems=8, n_actors=8)
        store.declare(id="o", type="lasp_orset", n_elems=8, n_actors=8,
                      tokens_per_actor=2)
        store.declare(id="c", type="riak_dt_gcounter")
        rt = P.RT(store, P.Graph(store), 24, nbrs, packed=packed)
        for r in range(0, 24, 5):
            rt.update_at(r, "g", ("add", f"e{r % 6}"), f"w{r}")
            rt.update_at(r, "s", ("add", f"s{r % 4}"), f"w{r}")
            rt.update_at(r, "o", ("add", f"o{r % 4}"), f"w{r}")
            rt.update_at(r, "c", ("increment", r + 1), f"w{r}")
        ch = P.chaos.ChaosRuntime(rt, P.chaos.nemesis(
            preset, 24, nbrs, seed=3, rounds=10, every=1) if preset == "bit-rot"
            else P.chaos.nemesis(preset, 24, nbrs, seed=3, rounds=10))
        for _ in range(14):
            obs.append((ch.step(mode="frontier" if packed else "dense"),
                        ch.last_corrupted, _fp(P, rt)))
        obs.append(ch.injected_corruptions)

    trec = _twin(scenario)
    assert trec[-1], "no corruption landed"


def test_crash_freezes_rows_around_dataflow_sweeps():
    """A crashed replica executes nothing: with a dataflow edge its row is
    written back after the step (out of place), as JAX's ``.at[].set``."""
    def scenario(P, obs):
        nbrs = ring(N, 2)
        store = P.Store(n_actors=8)
        a = store.declare(id="a", type="lasp_gset", n_elems=8)
        b = store.declare(id="b", type="lasp_gset", n_elems=8)
        g = P.Graph(store)
        g.map(a, lambda x: x, dst=b)
        rt = P.RT(store, g, N, nbrs)
        rt.update_at(4, a, ("add", "p"), "w4")
        rt.update_at(9, a, ("add", "q"), "w9")
        c = P.chaos
        ch = c.ChaosRuntime(rt, c.ChaosSchedule(
            N, nbrs, [c.Crash(0, 9), c.Crash(1, 5), c.Restore(5, 9),
                      c.Restore(6, 5)], seed=0))
        obs.append(ch._needs_freeze())
        for _ in range(3):
            obs.append((ch.step(), rt.replica_value(b, 9), rt.replica_value(b, 5),
                        _fp(P, rt)))
        _raises(obs, RuntimeError, ch.fused_steps, 1)
        obs.append(ch.soak())
        obs.append((rt.coverage_value(b), _fp(P, rt), P.residuals(rt)))

    _twin(scenario)


# -- the invariant harness's teeth (its preset matrix: test_torch_chaos_harness.py)

def test_harness_catches_destination_change():
    def scenario(P, obs):
        nbrs = ring(N, 2)
        calls = {"n": 0}

        def flaky_build():
            store = P.Store(n_actors=8)
            g = store.declare(id="g", type="lasp_gset", n_elems=16)
            rt = P.RT(store, P.Graph(store), N, nbrs)
            calls["n"] += 1
            rt.update_at(0, g, ("add", "a"), "w0")
            if calls["n"] > 1:
                rt.update_at(0, g, ("add", "b"), "w0")
            return rt

        schedule = P.chaos.nemesis("ring-cut", N, nbrs, seed=1, rounds=4)
        exc = _raises(obs, P.inv.InvariantViolation, P.inv.run_harness,
                      flaky_build, schedule, mode="dense", replay=False)
        obs.append("fixed point differs" in str(exc))
        # check_inflation flags a deflated row unless it is exempt
        rt = flaky_build()
        prev = P.inv.snapshot_states(rt)
        rt.reseed_row(0)
        _raises(obs, P.inv.InvariantViolation, P.inv.check_inflation, rt, prev)
        P.inv.check_inflation(rt, prev, exempt_rows=[0])
        _raises(obs, P.inv.InvariantViolation, P.inv.check_no_resurrection,
                rt, "g", {"b"})

    _twin(scenario)


def test_soak_report_reaches_the_monitor_and_events():
    from lasp_tpu_torch import telemetry

    nbrs = ring(N, 2)
    rt, v = _build(_pkg(True), nbrs)
    rt.update_at(0, v, ("add", "x"), "w0")
    telemetry.events.clear()
    ch = tchaos.ChaosRuntime(rt, tchaos.nemesis("rolling-crash", N, nbrs,
                                                seed=2, rounds=6))
    rep = ch.soak(reads_per_round=1, read_var=v)
    snap = telemetry.get_monitor().snapshot()
    assert snap["chaos"]["rounds_to_heal"] == rep["rounds_to_heal"]
    actions = [e["attrs"]["action"] for e in telemetry.events.events("chaos")]
    assert actions.count("crash") == rep["crashes"] == 3
    assert actions[-1] == "soak_done"
    assert rep["degraded_reads"] > 0


def test_chaos_heal_scenario_matches_jax():
    """``bench_scenarios.chaos_heal`` at 256 replicas: the same rounds,
    rounds to heal, crashes, restores, degraded reads and repair traffic as
    JAX's, the healed states bit-equal to the fault-free twin's (the
    scenario raises otherwise). Times on the CPU are not compared."""
    import lasp_tpu.bench_scenarios as jb
    import lasp_tpu_torch.bench_scenarios as tb

    want = jb.chaos_heal(256, block=4)
    got = tb.chaos_heal(256, block=4, device="cpu")
    for key in ("scenario", "n_replicas", "fanout", "nemesis", "fault_rounds",
                "rounds", "rounds_to_heal", "healed", "crashes", "restores",
                "degraded_reads", "repaired_rows", "repair_bytes", "check"):
        assert got[key] == want[key], key
    assert got["fused_windows"] > 0 and got["stepped_rounds"] > 0
    assert got["fused_rounds"] + got["stepped_rounds"] == got["rounds"]


@pytest.mark.parametrize("case", [
    "unguarded", "partitioned", "crash_leave", "after_heal", "crashed_departer",
    "rebase_after_grow", "faultfree_wrapper",
])
def test_graceful_leave_handoff_guard_equal_jax(case):
    """Twins of ``tests/mesh/test_membership.py``'s chaos guard cases: a
    graceful leave under an active partition or out of a crashed row is
    refused typed (``HandoffPartitionError``), crash leaves and post-heal
    leaves go through, the guard re-bases after an unstepped grow, and a
    fault-free wrapper keeps a nemesis wrapper's guard."""
    def scenario(P, obs):
        err = P.HandoffError
        store = P.Store(n_actors=4)
        store.declare(id="a", type="lasp_orset", n_elems=8)
        store.declare(id="b", type="lasp_orset", n_elems=8)
        rt = P.RT(store, P.Graph(store), 8, ring(8, 2))
        rt.update_batch("a", [(0, ("add", "x"), "p")])
        rt.update_batch("b", [(4, ("add", "y"), "q")])
        rt.update_batch("a", [(7, ("add", "sealed"), "w7")])
        c = P.chaos
        nbrs = np.asarray(rt._host_neighbors)
        events = ([c.Crash(0, 6)] if case == "crashed_departer"
                  else [c.Partition(0, 3 if case == "after_heal" else 6, 2)])
        ch = c.ChaosRuntime(rt, c.ChaosSchedule(8, nbrs, events))
        if case == "rebase_after_grow":
            rt.resize(12, ring(12, 2))
            _raises(obs, err, rt.resize, 6, ring(6, 2), graceful=True)
            obs.append((rt.n_replicas, ch.sync_membership(), ch.crashed.tolist()))
            return
        ch.step()
        if case == "unguarded":
            rt._handoff_guard = None
        if case == "faultfree_wrapper":
            c.ChaosRuntime(rt, c.ChaosSchedule(8, nbrs, ()))
        if case == "after_heal":
            while ch.round <= ch.schedule.horizon:
                ch.step()
        exc = _raises(obs, err, rt.resize, 4, ring(4, 2),
                      graceful=case != "crash_leave")
        obs.append(None if exc is None else ("partition" in str(exc), "crashed" in str(exc)))
        obs.append((rt.n_replicas, rt.membership_epoch))
        if exc is None:
            rt.run_to_convergence()
            obs.append((rt.coverage_value("a"), _fp(P, rt)))

    _twin(scenario)


@pytest.mark.parametrize("kind", ["bitflip", "rollback", "truncate"])
def test_mutate_row_in_jax_dtypes(kind):
    """``_mutate_row`` on packed words whose bit 31 is set (negative in the
    port's ``int32`` view, large in JAX's ``uint32``): every kind mutates the
    lane JAX mutates, by JAX's arithmetic, across salts and rows."""
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    planes = None

    def scenario(P, obs):
        nonlocal planes
        nbrs = ring(8, 2)
        store = P.Store(n_actors=8)
        store.declare(id="o", type="lasp_orset", n_elems=8, n_actors=8,
                      tokens_per_actor=2)
        store.declare(id="c", type="riak_dt_gcounter")
        rt = P.RT(store, P.Graph(store), 8, nbrs, packed=True)
        st = rt.states["o"]
        if planes is None:
            planes = [(rng.randint(0, 2**32, size=tuple(x.shape), dtype=np.uint64)
                       | (1 << 31)).astype(np.uint32) for x in st]
            planes[0][3] = 0  # a row holding nothing to roll back or truncate
            planes[1][3] = 0
        rt.states["o"] = type(st)(*[
            torch.from_numpy(x.view(np.int32).copy()) if P.port else jnp.asarray(x)
            for x in planes])
        ch = P.chaos.ChaosRuntime(rt, P.chaos.ChaosSchedule(8, nbrs, [], seed=0))
        for row in (0, 3, 5):
            for salt in (0, 7, 77, 12345, 2**30 + 11):
                obs.append((ch._mutate_row("o", row, kind, salt), _fp(P, rt)))
                obs.append((ch._mutate_row("c", row, kind, salt), _fp(P, rt)))

    _twin(scenario)
