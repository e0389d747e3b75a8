"""The port's active anti-entropy (``lasp_tpu_torch.aae``) against
``lasp_tpu.aae``: row hashes of every codec, dense and packed (G-Counter,
IVar and a nested map included), bit for bit; the forest's lifecycle;
the vectorized sweep against JAX's pair-by-pair loop (``stride = m/2``,
components, crashed rows, colliding roots); the runtime's AAE marks;
the memoized ``_reachable_live`` against the BFS under every preset; and
twins of ``tests/aae/`` (scrubber lifecycle, escalation, the corruption
drill matrix). Each scenario runs through both packages on the same
seeded inputs and what it observes must be equal (tolerance zero)."""

import types

import jax
import numpy as np
import pytest
import torch

import lasp_tpu.aae as jaae
import lasp_tpu.aae.exchange as jexchange
import lasp_tpu.chaos as jchaos
import lasp_tpu.chaos.invariants as jinv
import lasp_tpu.mesh as jmesh
import lasp_tpu.serve as jserve
import lasp_tpu.store as jstore
import lasp_tpu.telemetry as jtel
import lasp_tpu_torch.aae as taae
import lasp_tpu_torch.aae.exchange as texchange
import lasp_tpu_torch.chaos as tchaos
import lasp_tpu_torch.chaos.invariants as tinv
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.serve as tserve
import lasp_tpu_torch.store as tstore
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.mesh import random_regular, ring
from lasp_tpu_torch.aae.hashtree import _np_mix_levels
from lasp_tpu_torch.dataflow import Graph as TGraph
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

R = 12


def _poke_jax(rt, var, field, idx, val):
    pop = rt.states[var]
    rt.states[var] = pop._replace(**{field: getattr(pop, field).at[idx].set(val)})


def _poke_port(rt, var, field, idx, val):
    pop = rt.states[var]
    leaf = getattr(pop, field).clone()
    leaf[idx] = val
    rt.states[var] = pop._replace(**{field: leaf})


def _pkg(port: bool):
    if port:
        return types.SimpleNamespace(
            port=True, aae=taae, chaos=tchaos, inv=tinv, serve=tserve,
            Store=lambda **kw: tstore.Store(device="cpu", **kw),
            RT=lambda *a, **kw: tmesh.ReplicatedRuntime(*a, device="cpu", **kw),
            Graph=TGraph, poke=_poke_port,
            row=lambda rt, v, r: tree_map(lambda x: x[r].clone(), rt._population(v)),
            sweep_of=lambda order, pairs: texchange.SweepArrays(
                a=np.asarray([p[0] for p in pairs], np.int64),
                b=np.asarray([p[1] for p in pairs], np.int64),
                div=np.asarray([[v in p[2] for v in order] for p in pairs], bool),
                var_order=tuple(order), rounds=1, comparisons=5, components=1),
        )
    return types.SimpleNamespace(
        port=False, aae=jaae, chaos=jchaos, inv=jinv, serve=jserve,
        Store=jstore.Store, RT=jmesh.ReplicatedRuntime, Graph=JGraph,
        poke=_poke_jax,
        row=lambda rt, v, r: jax.tree_util.tree_map(lambda x: x[r], rt._population(v)),
        sweep_of=lambda order, pairs: {
            "pairs": pairs, "divergent": {}, "rounds": 1, "comparisons": 5,
            "components": 1},
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


def _fp(P, rt) -> str:
    return P.inv.fingerprint(P.inv.snapshot_states(rt))


def _hashes(P, rt):
    return {v: P.aae.row_hashes(rt._population(v)).tolist() for v in rt.var_ids}


# -- row hashes ----------------------------------------------------------------

def _all_codecs(P, packed):
    store = P.Store(n_actors=8)
    for i in range(3):
        store.declare(id=f"g{i}", type="lasp_gset", n_elems=24)
    store.declare(id="o", type="riak_dt_orswot", n_elems=12, n_actors=4)
    store.declare(id="p", type="lasp_orset", n_elems=12, tokens_per_actor=4)
    store.declare(id="c", type="riak_dt_gcounter", n_actors=8)
    store.declare(id="i", type="lasp_ivar")
    store.declare(id="m", type="riak_dt_map", fields=[
        ("s", "lasp_gset", {"n_elems": 4}),
        ("n", "riak_dt_gcounter", {}),
        ("inner", "riak_dt_map", {"fields": [("t", "lasp_orset", {"n_elems": 4})]}),
    ])
    rt = P.RT(store, P.Graph(store), R, ring(R, 2), packed=packed)
    for i in range(3):
        rt.update_at(i % R, f"g{i}", ("add", f"e{i}"), f"w{i}")
    rt.update_at(1, "o", ("add", "x"), "a0")
    rt.update_at(2, "p", ("add", "y"), "b0")
    rt.update_at(4, "c", ("increment", 3), "c0")
    rt.update_at(5, "i", ("set", "ready"), "d0")
    rt.update_at(6, "m", ("update", "s", ("add", "k")), "w0")
    rt.update_at(6, "m", ("update", "n", ("increment", 2)), "w0")
    rt.update_at(7, "m", ("update", "inner", ("update", "t", ("add", "z"))), "w1")
    rt.step()
    return rt


@pytest.mark.parametrize("packed", [False, True])
def test_row_hashes_equal_jax_for_every_codec(packed):
    def scen(P, obs):
        rt = _all_codecs(P, packed)
        obs.append(_hashes(P, rt))
        # and each subset / group arm agrees with its own full hashes
        pop = rt._population("o")
        rows = np.asarray([0, 3, 7], dtype=np.int64)
        obs.append(P.aae.subset_row_hashes(pop, rows).tolist())
        if P.port:
            from lasp_tpu_torch.mesh.plan import stack_group
        else:
            from lasp_tpu.mesh.plan import stack_group
        stacked = stack_group([rt._population(f"g{i}") for i in range(3)])
        obs.append(P.aae.group_row_hashes(stacked).tolist())

    _twin(scen)


def test_chunked_hash_equals_whole():
    import lasp_tpu_torch.aae.hashtree as ht

    rt = _all_codecs(_pkg(True), False)
    whole = {v: ht.row_hashes(rt._population(v)) for v in rt.var_ids}
    old = ht._CHUNK_WORDS
    ht._CHUNK_WORDS = 5
    try:
        for v in rt.var_ids:
            assert np.array_equal(ht.row_hashes(rt._population(v)), whole[v]), v
    finally:
        ht._CHUNK_WORDS = old


@pytest.mark.parametrize("var", ["g0", "o", "p", "c"])
def test_single_bit_flip_changes_exactly_its_row_hash(var):
    def scen(P, obs):
        rt = _all_codecs(P, False)
        before = P.aae.row_hashes(rt._population(var))
        pop = rt.states[var]
        field = pop._fields[0]
        leaf = np.array(np.asarray(getattr(pop, field)))
        flat = leaf.reshape(R, -1)
        if flat.dtype == np.bool_:
            val = not bool(flat[4, 0])
        else:
            val = int(flat[4, 0] ^ 1)
        idx = (4,) + (0,) * (leaf.ndim - 1)
        P.poke(rt, var, field, idx, val)
        after = P.aae.row_hashes(rt._population(var))
        obs.append(after.tolist())
        obs.append(np.flatnonzero(after != before).tolist())

    rec = _twin(scen)
    assert rec[1] == [4]


# -- the forest ------------------------------------------------------------------

def _forest_rt(P, n_gsets=3, packed=False):
    store = P.Store(n_actors=8)
    for i in range(n_gsets):
        store.declare(id=f"g{i}", type="lasp_gset", n_elems=24)
    store.declare(id="o", type="riak_dt_orswot", n_elems=12, n_actors=4)
    store.declare(id="p", type="lasp_orset", n_elems=12, tokens_per_actor=4)
    rt = P.RT(store, P.Graph(store), R, ring(R, 2), packed=packed)
    for i in range(n_gsets):
        rt.update_at(i % R, f"g{i}", ("add", f"e{i}"), f"w{i}")
    rt.update_at(1, "o", ("add", "x"), "a0")
    rt.update_at(2, "p", ("add", "y"), "b0")
    return rt


def _forest_obs(forest):
    return [
        {v: forest.committed[v].tolist() for v in forest.var_order},
        forest.segmat.tolist(), forest.roots.tolist(),
        dict(forest.rows_hashed), forest.segments_rehashed,
        {v: np.flatnonzero(m).tolist() for v, m in forest.dirty.items()},
    ]


@pytest.mark.parametrize("packed", [False, True])
def test_forest_lifecycle_equals_jax(packed):
    """Refresh, the incremental arm, clean segments, verify against an
    untracked write, epochs and a late declare — the forest's every view
    equal to JAX's after each step."""
    def scen(P, obs):
        rt = _forest_rt(P, n_gsets=12, packed=packed)
        forest = P.aae.HashForest(rt, seg_size=4)
        obs.append(forest.refresh())
        obs += _forest_obs(forest)
        obs.append(forest.refresh())  # quiescent: zero work
        rt.update_at(5, "g1", ("add", "fresh"), "w9")
        obs.append(forest.refresh())  # incremental
        obs += _forest_obs(forest)
        P.poke(rt, "g0", "mask", (6, 3), True)  # silent
        obs.append(forest.refresh(verify=True))
        rt.update_at(2, "g0", ("add", "ok"), "wk")  # tracked
        obs.append(forest.refresh(verify=True))
        rt._invalidate_plan("mask_change")
        obs.append(forest.refresh())
        rt._invalidate_plan("resize")
        obs.append(forest.refresh())
        obs += _forest_obs(forest)
        rt.store.declare(id="late", type="lasp_gset", n_elems=8)
        rt._population("late")
        obs.append(forest.refresh())
        obs.append(list(forest.var_order))
        obs.append(forest.rehash_rows("o", [1, 2]).tolist())
        obs += _forest_obs(forest)
        d = forest.describe()
        d.pop("hash_seconds", None)
        obs.append(d)

    _twin(scen)


def test_runtime_marks_equal_jax():
    """``_aae_mark`` at JAX's sites: after every tracked mutation (writes,
    dense / frontier / fused rounds, planned rounds, joins, reseeds,
    ``mark_dirty``) the forest's dirty masks equal JAX's, and so do the
    epochs."""
    def scen(P, obs):
        rt = _forest_rt(P)
        forest = P.aae.HashForest(rt)
        forest.refresh()

        def snap(tag):
            obs.append((tag, {v: np.flatnonzero(m).tolist()
                              for v, m in forest.dirty.items()},
                        rt._aae_state_epoch, rt._aae_tree_epoch))
            forest.refresh()

        rt.update_at(3, "g0", ("add", "a"), "w1")
        snap("update_at")
        rt.update_batch("p", [(4, ("add", "q"), "b1"), (9, ("add", "r"), "b2")])
        snap("update_batch")
        rt.frontier_step()
        snap("frontier")
        rt.frontier_step()
        snap("frontier2")
        rt.step()
        snap("dense")
        rt.fused_steps(2)
        snap("fused")
        rt.join_rows("g1", np.asarray([7], np.int64), [P.row(rt, "g1", 1)])
        snap("join_rows")
        rt.reseed_row(5)
        snap("reseed_row")
        rt.mark_dirty("o")
        snap("mark_dirty")
        rt.mark_dirty("g2", rows=[2, 11])
        snap("mark_dirty_rows")
        mask = np.ones((R, 2), dtype=bool)
        mask[3] = False
        rt.frontier_step(mask)
        snap("masked_frontier")
        rt.plan_mode = "off"
        rt.update_at(8, "g2", ("add", "b"), "w2")
        rt.frontier_step(mask)
        snap("pervar_frontier")

    _twin(scen)


def test_verify_flags_chaos_corruption_not_tracked_writes():
    """A direct state write (``ChaosRuntime``'s corruption) is flagged by
    ``refresh(verify=True)``; a tracked write is not — as in JAX."""
    def scen(P, obs):
        rt = _forest_rt(P)
        sched = P.chaos.ChaosSchedule(R, rt._host_neighbors, [
            P.chaos.CorruptRows(1, kind="bitflip", n_rows=2)], seed=4)
        ch = P.chaos.ChaosRuntime(rt, sched)
        forest = P.aae.HashForest(rt)
        forest.refresh()
        ch.step()
        forest.refresh()
        ch._apply_actions(1)  # the injection alone, before any gossip
        obs.append(ch.last_corrupted)
        out = forest.refresh(verify=True)
        obs.append(out)
        rt.update_at(0, "g0", ("add", "tracked"), "w5")
        obs.append(forest.refresh(verify=True))

    rec = _twin(scen)
    assert sorted(rec[1]["corrupt"]) == sorted(rec[0])
    assert rec[2]["corrupt"] == []


# -- the exchange ------------------------------------------------------------------

def test_exchange_pair_and_sweep_equal_jax_on_a_live_forest():
    def scen(P, obs):
        store = P.Store(n_actors=8)
        for i in range(6):
            store.declare(id=f"v{i}", type="lasp_gset", n_elems=16)
        rt = P.RT(store, P.Graph(store), R, ring(R, 2))
        forest = P.aae.HashForest(rt, seg_size=4)
        forest.refresh()
        obs.append(P.aae.exchange_pair(forest, 2, 9))
        obs.append(P.aae.sweep(forest))
        rt.update_at(5, "v3", ("add", "d7"), "w7")
        rt.update_at(2, "v1", ("add", "d8"), "w8")
        forest.refresh()
        obs.append(P.aae.exchange_pair(forest, 5, 6))
        obs.append(P.aae.sweep(forest))
        comp = np.asarray([0] * 6 + [6] * 6, dtype=np.int32)
        obs.append(P.aae.sweep(forest, components=comp))
        live = np.ones(R, dtype=bool)
        live[4] = False
        obs.append(P.aae.sweep(forest, live=live))

    _twin(scen)


class _Forest:
    """A forest's read views over a given leaf matrix (what the exchange
    reads), with roots optionally forced equal to exercise collisions."""

    def __init__(self, leafmat, seg, collide=()):
        self._leaf = leafmat
        self.seg = seg
        self.segmat, self.roots = _np_mix_levels(leafmat, seg)
        for a, b in collide:
            self.roots[b] = self.roots[a]
        self.var_order = tuple(f"v{i}" for i in range(leafmat.shape[0]))

    def leaf_matrix(self):
        return self._leaf


@pytest.mark.parametrize("seed", range(6))
def test_vectorized_sweep_equals_jax_loop(seed):
    """The sweep's numpy pass against JAX's pair-by-pair loop (the plain
    version) on random leaf matrices: even and odd member rings (the
    ``stride = m/2`` duplicates), components, crashed rows, a short last
    segment and forced root collisions."""
    rng = np.random.RandomState(seed)
    v = int(rng.randint(1, 11))
    n = int(rng.choice([2, 7, 16, 33, 64]))
    leaf = rng.randint(0, 3 if seed % 2 else 2, size=(v, n)).astype(np.uint32)
    if seed == 0:
        leaf[:] = 5  # a converged population: the stride-1 early exit
    collide = [(0, 1), (2, 3)] if n > 3 else ()
    forest = _Forest(leaf, seg=int(rng.choice([1, 3, 8])), collide=collide)
    comps = [None, rng.randint(0, 3, size=n).astype(np.int32) * 5]
    lives = [None, rng.rand(n) > 0.2]
    for comp in comps:
        for live in lives:
            want = jexchange.sweep(forest, comp, live)
            got = texchange.sweep(forest, comp, live)
            assert got["pairs"] == want["pairs"]
            assert got == want
            for a in range(min(n, 6)):
                b = (a * 5 + 1) % n
                assert texchange.exchange_pair(forest, a, b) == \
                    jexchange.exchange_pair(forest, a, b)


# -- reachability: the memo against the BFS -----------------------------------------

@pytest.mark.parametrize(
    "preset", sorted(tchaos.PRESETS + tchaos.CORRUPTION_PRESETS)
)
def test_reachable_live_memo_equals_bfs(preset):
    """Every coordinator (crashed ones included) at every round of each
    preset: the memoized labelling gives the BFS's ``bool[R]``."""
    n = 32
    nbrs = random_regular(n, 3, seed=2)
    store = tstore.Store(n_actors=8, device="cpu")
    store.declare(id="g", type="lasp_gset", n_elems=8)
    rt = tmesh.ReplicatedRuntime(store, TGraph(store), n, nbrs, device="cpu")
    sched = tchaos.nemesis(preset, n, nbrs, seed=3, rounds=8)
    ch = tchaos.ChaosRuntime(rt, sched)
    crashed_seen = 0
    while ch.round <= sched.horizon + 1:
        ch.step()
        for rnd in (ch.round - 1, ch.round):
            for c in range(n):
                crashed_seen += int(ch.crashed[c])
                assert np.array_equal(ch._reachable_live(c, rnd=rnd),
                                      ch._reachable_live_bfs(c, rnd=rnd)), (rnd, c)
    if preset == "rolling-crash":
        assert crashed_seen > 0


# -- the scrubber --------------------------------------------------------------------

def _scrub_rt(P):
    store = P.Store(n_actors=8)
    store.declare(id="g", type="lasp_gset", n_elems=24)
    rt = P.RT(store, P.Graph(store), R, ring(R, 2))
    for w in range(4):
        rt.update_at((w * 3) % R, "g", ("add", f"e{w}"), f"w{w}")
    return rt


def _scrubber_obs(sc):
    rep = dict(sc.report())
    return [sc.detected, sc.incidents, sorted(sc.pending), rep]


def _soak(ch, sched, cap=64):
    stats = []
    while ch.round < cap:
        stats.append(ch.step())
        if stats[-1] == 0 and ch.round > sched.horizon:
            break
    return stats


def test_scrubber_detects_localizes_and_overwrites():
    def scen(P, obs):
        rt = _scrub_rt(P)
        sched = P.chaos.ChaosSchedule(R, rt._host_neighbors,
                                      [P.chaos.CorruptRows(2, kind="bitflip")], seed=3)
        ch = P.chaos.ChaosRuntime(rt, sched)
        sc = P.aae.AAEScrubber(ch)
        obs.append(_soak(ch, sched))
        obs.append(ch.injected_corruptions)
        obs += _scrubber_obs(sc)
        obs.append(sorted(rt.coverage_value("g")))
        obs.append(_fp(P, rt))

    rec = _twin(scen)
    assert rec[2] and rec[3] and not rec[4]


def test_scrubber_pending_repair_waits_out_isolation():
    def scen(P, obs):
        rt = _scrub_rt(P)
        events = [P.chaos.Partition(1, 5, R), P.chaos.CorruptRows(2, kind="bitflip")]
        sched = P.chaos.ChaosSchedule(R, rt._host_neighbors, events, seed=7)
        ch = P.chaos.ChaosRuntime(rt, sched)
        sc = P.aae.AAEScrubber(ch)
        for _ in range(3):
            ch.step()
        obs += _scrubber_obs(sc)
        obs.append(_soak(ch, sched))
        obs += _scrubber_obs(sc)
        obs.append(_fp(P, rt))

    rec = _twin(scen)
    assert len(rec[0]) == 1 and len(rec[2]) == 1 and not rec[7]


def test_scrubber_join_fixed_point_escalates(monkeypatch):
    def scen(P, obs):
        rt = _scrub_rt(P)
        rt.run_to_convergence()
        sc = P.aae.AAEScrubber(rt)
        sc.forest.refresh()
        calls = {"n": 0}
        real = sc.forest.rehash_rows

        def rigged(var_id, rows):
            out = real(var_id, rows)
            calls["n"] += 1
            if calls["n"] == 1 and len(rows) == 2:
                return np.asarray([1, 2], dtype=np.uint32)
            return out

        monkeypatch.setattr(sc.forest, "rehash_rows", rigged)
        sw = P.sweep_of(sc.forest.var_order, [(2, 3, ["g"])])
        obs.append(sc._repair_divergence(0, sw, None, np.ones(R, dtype=bool)))
        obs += _scrubber_obs(sc)
        obs.append(_fp(P, rt))

    rec = _twin(scen)
    assert rec[0] == (1, 2)


def test_scrubber_late_attach_deflation_repairs_by_join():
    def scen(P, obs):
        rt = _scrub_rt(P)
        rt.run_to_convergence()
        P.poke(rt, "g", "mask", 5, False)
        sc = P.aae.AAEScrubber(rt)
        obs.append(sc.scrub())
        obs.append(sc.scrub())
        obs += _scrubber_obs(sc)
        obs.append(_fp(P, rt))

    rec = _twin(scen)
    assert rec[0]["joins"] >= 1 and rec[1]["divergent_rows"] == 0


def test_scrubber_join_repairs_walk_pairs_in_order_with_the_frontier_gate():
    """Several divergent pairs over two variables on quiet frontiers: the
    joins run in the sweep's order, and once a join dirties a variable's
    frontier its later pairs are skipped — JAX's loop, pair for pair."""
    def scen(P, obs):
        store = P.Store(n_actors=8)
        store.declare(id="g", type="lasp_gset", n_elems=24)
        store.declare(id="h", type="lasp_gset", n_elems=24)
        rt = P.RT(store, P.Graph(store), 16, ring(16, 2))
        rt.update_at(0, "g", ("add", "a"), "w0")
        rt.update_at(0, "h", ("add", "b"), "w1")
        rt.run_to_convergence()
        for r in (3, 9, 13):
            P.poke(rt, "g", "mask", r, False)
        P.poke(rt, "h", "mask", 7, False)
        sc = P.aae.AAEScrubber(rt)
        for _ in range(3):
            obs.append(sc.scrub())
            obs.append({v: np.flatnonzero(rt._frontier[v]).tolist()
                        for v in rt.var_ids})
        obs += _scrubber_obs(sc)
        obs.append(_fp(P, rt))

    _twin(scen)


def test_serve_background_scrub_runs_and_defers():
    def scen(P, obs):
        rt = _scrub_rt(P)
        sc = P.aae.AAEScrubber(rt)
        fe = P.serve.ServeFrontend(rt, admission=P.serve.AdmissionController(),
                                   gossip_block=0, aae=sc, scrub_every=1)
        fe.cycle()
        obs.append((fe.scrubs_run, fe.scrubs_skipped))
        fe.admission.level = 2
        fe.cycle()
        obs.append((fe.scrubs_run, fe.scrubs_skipped))
        fe.admission.level = 0
        fe.cycle()
        rep = fe.report()
        obs.append((rep["aae_scrubs"], rep["aae_scrubs_deferred"]))

    assert _twin(scen)[-1] == (2, 1)


def test_report_lands_in_health_surface():
    from lasp_tpu_torch.telemetry import get_monitor

    rt = _scrub_rt(_pkg(True))
    sc = taae.AAEScrubber(rt)
    sc.scrub()
    rep = sc.report()
    health = get_monitor().health()
    assert health["aae"]["scrubs"] == rep["scrubs"]
    assert rep["repair_bytes"] <= rep["full_resync_bytes"]
    assert set(sc.seconds()) == {"hash", "exchange", "repair"}


# -- the corruption drill (run_aae_harness) ---------------------------------------

_CODECS = {
    "gset": dict(type="lasp_gset", n_elems=32),
    "orswot": dict(type="riak_dt_orswot", n_elems=16, n_actors=8),
    "packed_orset": dict(type="lasp_orset", n_elems=16, tokens_per_actor=4),
}


def _builder(P, codec_key):
    caps = dict(_CODECS[codec_key])

    def build():
        store = P.Store(n_actors=16)
        store.declare(id="v", **caps)
        rt = P.RT(store, P.Graph(store), R, ring(R, 2),
                  packed=codec_key == "packed_orset")
        for w in range(4):
            rt.update_at((w * 3 + 1) % R, "v", ("add", f"e{w}"), f"w{w}")
        return rt

    return build


def _drill(P, obs, codec, sched_of, **kw):
    sched = sched_of(P)
    rep = P.inv.run_aae_harness(_builder(P, codec), sched, **kw)
    rep.pop("seconds", None)
    obs.append(rep)


@pytest.mark.parametrize("preset", sorted(jchaos.CORRUPTION_PRESETS))
@pytest.mark.parametrize("codec", sorted(_CODECS))
def test_corruption_drill_matrix(codec, preset):
    def sched_of(P):
        return P.chaos.nemesis(preset, R, ring(R, 2), seed=9, rounds=6)

    rec = _twin(_drill, codec, sched_of, scrub_every=1, replay=False)
    assert rec[0]["detected_and_repaired"] and rec[0]["injected"] >= 1


def test_drill_replay_and_wider_frontier_cadence():
    def replay(P):
        return P.chaos.nemesis("corrupt-partition", R, ring(R, 2), seed=4, rounds=6)

    assert _twin(_drill, "gset", replay, scrub_every=1, replay=True)[0]["replay_identical"]

    def late(P):
        return P.chaos.ChaosSchedule(R, ring(R, 2), [P.chaos.CorruptRows(9, kind="bitflip")],
                                     seed=6)

    rec = _twin(_drill, "gset", late, scrub_every=2, mode="frontier", replay=False)
    assert rec[0]["detection_latency_rounds"] == [1]


def test_dense_wide_cadence_is_refused():
    sched = tchaos.nemesis("bit-rot", R, ring(R, 2), seed=9, rounds=6)
    with pytest.raises(ValueError, match="launder"):
        tinv.run_aae_harness(_builder(_pkg(True), "gset"), sched, scrub_every=3,
                             replay=False)


def test_drill_has_teeth_without_a_scrubber():
    def scen(P, obs):
        build = _builder(P, "gset")
        sched = P.chaos.nemesis("bit-rot", R, ring(R, 2), seed=9, rounds=6,
                                kind="bitflip", every=2)
        free = build()
        free.run_to_convergence()
        free_states = P.inv.snapshot_states(free)
        rt = build()
        ch = P.chaos.ChaosRuntime(rt, sched)
        obs.append(_soak(ch, sched, cap=128))
        obs.append(ch.injected_corruptions)
        obs.append(P.inv.states_equal(P.inv.snapshot_states(rt), free_states))

    rec = _twin(scen)
    assert rec[1] and rec[2] is False
