"""The port's row and membership primitives against ``lasp_tpu``'s:
``join_rows``, ``reseed_row``, ``resize`` (grow, graceful and crash leave,
topology swap; packed and dense), ``membership_grow`` /
``membership_drop_tail`` with row-scoped ``dirty_rows``, the actor-site
remap, and the numpy helpers of ``membership.plan``. The non-chaos cases of
tests/mesh/test_membership.py run as scenarios through both packages; what
each observes (values, states bit for bit, frontier masks, epochs, actor
sites, round counts, exceptions) must be equal (tolerance zero)."""

import types

import jax
import numpy as np
import pytest
import torch

import lasp_tpu.mesh as jmesh
import lasp_tpu.membership.plan as jmplan
import lasp_tpu.store as jstore
import lasp_tpu_torch.membership.plan as tmplan
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.store as tstore
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.lattice import Threshold as JThreshold
from lasp_tpu.mesh import random_regular, ring
from lasp_tpu_torch import bridge_state
from lasp_tpu_torch.dataflow import Graph as TGraph
from lasp_tpu_torch.lattice import Threshold as TThreshold
from lasp_tpu_torch.lattice.base import tree_map

torch.set_num_threads(1)


def _np_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _np_leaves(part)]
    return [np.array(tree)]


def _pkg(port: bool):
    if port:
        return types.SimpleNamespace(
            port=True, Threshold=TThreshold, plan=tmplan,
            Store=lambda **kw: tstore.Store(device="cpu", **kw),
            RT=lambda *a, **kw: tmesh.ReplicatedRuntime(*a, device="cpu", **kw),
            Graph=TGraph,
            flat=lambda s: _np_leaves(bridge_state.to_numpy(s)),
            row=lambda rt, v, r: type(rt.states[v])(*bridge_state.to_numpy(
                type(rt.states[v])(*[x[r].clone() for x in rt.states[v]]))),
            tree_row=lambda st, r: tree_map(lambda x: x[r].clone(), st),
        )
    return types.SimpleNamespace(
        port=False, Threshold=JThreshold, plan=jmplan, Store=jstore.Store,
        RT=jmesh.ReplicatedRuntime, Graph=JGraph,
        flat=lambda s: [np.asarray(x) for x in jax.tree_util.tree_leaves(s)],
        row=lambda rt, v, r: type(rt.states[v])(*[np.asarray(x[r]) for x in rt.states[v]]),
        tree_row=lambda st, r: jax.tree_util.tree_map(lambda x: np.asarray(x[r]), st),
    )


def _twin(scenario, *args):
    records = []
    for port in (False, True):
        obs: list = []
        scenario(_pkg(port), obs, *args)
        records.append(obs)
    jrec, trec = records
    assert len(jrec) == len(trec)
    for i, (x, y) in enumerate(zip(jrec, trec)):
        if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y), i
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and np.array_equal(u, v), i
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y), i
        else:
            assert x == y, (i, x, y)
    return trec


def _raises(obs, exc, fn, *args, match=None, **kw):
    with pytest.raises(exc, match=match) as info:
        fn(*args, **kw)
    obs.append((type(info.value).__name__, str(info.value)))


def _record(obs, p, rt):
    """Everything a membership event may touch, for the twin compare."""
    obs.append(rt.n_replicas)
    obs.append(rt.membership_epoch)
    obs.append(np.asarray(rt._host_neighbors, dtype=np.int64))
    for v in rt.var_ids:
        obs.append(rt._frontier[v].copy())
        obs.append(p.flat(rt.states[v]))
        obs.append(p.flat(rt._to_dense_states(v)))


def _runtime(p, n=8, packed=False, with_edge=True, **kw):
    store = p.Store(n_actors=4)
    graph = p.Graph(store)
    a = store.declare(id="a", type="lasp_orset", n_elems=8)
    b = store.declare(id="b", type="lasp_orset", n_elems=8)
    if with_edge:
        graph.union(a, b, dst="u")
    rt = p.RT(store, graph, n, ring(n, 2), packed=packed, **kw)
    rt.update_batch("a", [(0, ("add", "x"), "p")])
    rt.update_batch("b", [(n // 2, ("add", "y"), "q")])
    return rt


# -- resize (tests/mesh/test_membership.py) -------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_grow_new_rows_catch_up_by_gossip(packed):
    def scn(p, obs):
        rt = _runtime(p, 8, packed=packed)
        obs.append(rt.run_to_convergence())
        rt.resize(16, ring(16, 2))
        _record(obs, p, rt)
        assert rt.replica_value("a", 12) == frozenset()
        rt.update_batch("a", [(15, ("add", "z"), "p")])
        obs.append(rt.run_to_convergence())
        for r in (0, 8, 12, 15):
            assert rt.replica_value("a", r) == {"x", "z"}
            assert rt.replica_value("u", r) == {"x", "y", "z"}
        assert rt.divergence("u") == 0
        _record(obs, p, rt)

    _twin(scn)


@pytest.mark.parametrize("packed", [False, True])
def test_graceful_leave_preserves_ungossiped_writes(packed):
    def scn(p, obs):
        rt = _runtime(p, 8, packed=packed)
        rt.update_batch("a", [(7, ("add", "only-at-7"), "p")])
        rt.resize(4, ring(4, 2), graceful=True)
        _record(obs, p, rt)
        obs.append(rt.run_to_convergence())
        assert rt.coverage_value("a") == {"x", "only-at-7"}
        assert rt.coverage_value("u") == {"x", "y", "only-at-7"}
        assert rt.divergence("a") == 0
        _record(obs, p, rt)

    _twin(scn)


@pytest.mark.parametrize("packed", [False, True])
def test_crash_leave_loses_only_ungossiped_state(packed):
    def scn(p, obs):
        rt = _runtime(p, 8, packed=packed)
        obs.append(rt.run_to_convergence())
        rt.update_batch("a", [(7, ("add", "doomed"), "p")])
        rt.resize(4, ring(4, 2), graceful=False)
        _record(obs, p, rt)
        obs.append(rt.run_to_convergence())
        assert rt.coverage_value("a") == {"x"}
        assert rt.coverage_value("u") == {"x", "y"}
        _record(obs, p, rt)

    _twin(scn)


def test_resize_validates_topology():
    def scn(p, obs):
        rt = _runtime(p, 8)
        _raises(obs, ValueError, rt.resize, 4, ring(8, 2), match="new_n")
        _raises(obs, ValueError, rt.resize, 4, np.array([[0, 5]] * 4),
                match="out of range")
        obs.append(rt.membership_epoch)

    _twin(scn)


def test_shrink_then_grow_round_trip_with_trigger():
    def scn(p, obs):
        rt = _runtime(p, 8)
        seen = {}

        def trig(dense):
            seen["fired"] = True
            return {}

        rt.register_trigger(trig)
        obs.append(rt.run_to_convergence(block=4))
        rt.resize(2, ring(2, 1))
        obs.append(rt.run_to_convergence(block=4))
        rt.resize(12, random_regular(12, 3, seed=1))
        rt.update_batch("b", [(11, ("add", "late"), "q")])
        obs.append(rt.run_to_convergence(block=4))
        assert seen.get("fired")
        assert rt.coverage_value("u") == {"x", "y", "late"}
        assert rt.divergence("u") == 0
        _record(obs, p, rt)

    _twin(scn)


def test_resize_then_converge_on_device_and_device_read():
    def scn(p, obs):
        store = p.Store(n_actors=2)
        store.declare(id="c", type="riak_dt_gcounter")
        rt = p.RT(store, p.Graph(store), 8, ring(8, 2))
        rt.update_batch("c", [(0, ("increment", 3), "w")])
        obs.append(rt.converge_on_device())
        assert rt.read_until(5, "c", p.Threshold(3), on_device=True) is not None
        rt.resize(12, ring(12, 2))
        obs.append(rt.converge_on_device())
        assert rt.read_until(11, "c", p.Threshold(3), on_device=True) is not None
        rt.resize(6, ring(6, 2))
        obs.append(rt.converge_on_device())
        obs.append(int(rt.coverage_value("c")))
        _record(obs, p, rt)

    _twin(scn)


@pytest.mark.parametrize("packed", [False, True])
def test_departing_state_lands_at_claim_successor(packed):
    """8 -> 4 (one source a target) and 8 -> 3 (targets 0 and 1 take two
    sources each: the handoff folds them before the merge)."""
    def scn(p, obs, new_n):
        rt = _runtime(p, 8, packed=packed, with_edge=False)
        rt.update_batch("a", [(5, ("add", "only-5"), "p")])
        rt.update_batch("a", [(7, ("add", "only-7"), "q")])
        rt.update_batch("b", [(6, ("add", "only-6"), "q")])
        rt.resize(new_n, ring(new_n, 2), graceful=True)
        assert "only-5" in rt.replica_value("a", 5 % new_n)
        assert "only-7" in rt.replica_value("a", 7 % new_n)
        assert "only-6" in rt.replica_value("b", 6 % new_n)
        _record(obs, p, rt)
        obs.append(rt.run_to_convergence(mode="frontier"))
        assert rt.divergence("a") == 0
        _record(obs, p, rt)

    _twin(scn, 4)
    _twin(scn, 3)


def test_epoch_advances_on_every_membership_change():
    def scn(p, obs):
        rt = _runtime(p, 8)
        assert rt.membership_epoch == 0
        rt.resize(12, ring(12, 2))
        rt.resize(6, ring(6, 2), graceful=True)
        rt.resize(4, ring(4, 2), graceful=False)
        rt.resize(4, ring(4, 2))  # topology swap fences too
        assert rt.membership_epoch == 4
        _record(obs, p, rt)

    _twin(scn)


def test_resize_drops_views_of_the_old_population():
    """A mask object reused across a resize is re-checked against the new
    topology (its views were cached by identity), and frontier rounds run
    on the new neighbour table."""
    def scn(p, obs):
        store = p.Store(n_actors=2)
        store.declare(id="c", type="riak_dt_gcounter")
        rt = p.RT(store, p.Graph(store), 8, ring(8, 2))
        mask = np.ones((8, 2), dtype=bool)
        rt.update_batch("c", [(0, ("increment", 2), "w")])
        obs.append(rt.run_to_convergence(edge_mask=mask, mode="frontier"))
        rt.resize(6, ring(6, 2))
        # both refuse the stale mask (JAX in numpy's broadcast, the port in
        # its shape check), with their own messages
        with pytest.raises(ValueError):
            rt.run_to_convergence(edge_mask=mask, mode="frontier")
        rt.update_batch("c", [(5, ("increment", 1), "v")])
        obs.append(rt.run_to_convergence(mode="frontier"))
        obs.append(int(rt.coverage_value("c")))
        _record(obs, p, rt)

    _twin(scn)


# -- join_rows and reseed_row ---------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_join_rows_broadcast_and_per_row(packed):
    def scn(p, obs):
        store = p.Store(n_actors=4)
        store.declare(id="s", type="lasp_orset", n_elems=8, n_actors=4,
                      tokens_per_actor=2)
        store.declare(id="w", type="riak_dt_orswot", n_elems=8, n_actors=4)
        store.declare(id="c", type="riak_dt_gcounter", n_actors=4)
        rt = p.RT(store, p.Graph(store), 12, random_regular(12, 3, seed=2),
                  packed=packed)
        for v, op in (("s", ("add", "e")), ("w", ("add", "f")), ("c", ("increment", 2))):
            rt.update_batch(v, [(1, op, "a0"), (9, op, "a1")])
        obs.append(rt.run_to_convergence(mode="frontier"))
        rt.update_batch("s", [(3, ("add", "g"), "a2")])
        rt.update_batch("w", [(3, ("remove", "f"), "a2")])
        rt.update_batch("c", [(3, ("increment", 5), "a2")])
        for v in ("s", "w", "c"):
            rt._frontier[v][:] = False
            top = p.row(rt, v, 3)
            # broadcast: row 3 itself is unchanged, the others take the join
            obs.append(rt.join_rows(v, [3, 0, 7, 11], top))
            obs.append(rt._frontier[v].copy())
            # per-row sequence: each row joins its own contribution
            rows = [p.row(rt, v, r) for r in (0, 5)]
            obs.append(rt.join_rows(v, [4, 6], rows))
            obs.append(rt.join_rows(v, [4, 6], rows))  # idempotent: 0
            obs.append(p.flat(rt.states[v]))
            _raises(obs, ValueError, rt.join_rows, v, [2, 2], top, match="duplicate")
            _raises(obs, IndexError, rt.join_rows, v, [12], top, match="out of")
            _raises(obs, ValueError, rt.join_rows, v, [1, 2], rows[:1],
                    match="contribution")
        obs.append(rt.join_rows("s", [], ()))
        obs.append(rt.run_to_convergence(mode="frontier"))
        obs.append(sorted(rt.coverage_value("s")))
        obs.append(sorted(rt.coverage_value("w")))
        obs.append(int(rt.coverage_value("c")))
        _record(obs, p, rt)

    _twin(scn)


@pytest.mark.parametrize("packed", [False, True])
def test_reseed_row_bottom_and_supplied(packed):
    def scn(p, obs):
        rt = _runtime(p, 8, packed=packed, with_edge=False)
        obs.append(rt.run_to_convergence(mode="frontier"))
        saved = {v: p.row(rt, v, 2) for v in ("a", "b")}
        rt.reseed_row(2)  # to bottom
        assert rt.replica_value("a", 2) == frozenset()
        _record(obs, p, rt)
        obs.append(rt.run_to_convergence(mode="frontier"))
        rt.update_batch("a", [(2, ("add", "post"), "p")])
        # supplied rows: a row state for a, the leaf-list form for b
        rt.reseed_row(2, {"a": saved["a"], "b": list(saved["b"])})
        assert rt.replica_value("a", 2) == {"x"}
        _record(obs, p, rt)
        obs.append(rt.run_to_convergence(mode="frontier"))
        bad = [np.zeros((3,), dtype=x.dtype) for x in saved["a"]]
        _raises(obs, ValueError, rt.reseed_row, 1, {"a": bad}, match="leaf shape")
        _raises(obs, IndexError, rt.reseed_row, 8)
        obs.append(rt.membership_epoch)

    _twin(scn)


# -- the staged commit primitives -------------------------------------------------


def test_membership_grow_and_drop_tail_row_scoped():
    def scn(p, obs):
        store = p.Store(n_actors=4)
        store.declare(id="c", type="riak_dt_gcounter", n_actors=6)
        store.declare(id="w", type="riak_dt_orswot", n_elems=4, n_actors=6)
        old = random_regular(10, 3, seed=3)
        rt = p.RT(store, p.Graph(store), 10, old, debug_actors=True)
        rt.update_batch("c", [(2, ("increment", 1), "a0"), (8, ("increment", 2), "a1")])
        rt.update_batch("w", [(9, ("add", "z"), "a2")])
        obs.append(rt.run_to_convergence(mode="frontier"))
        rt.update_batch("c", [(4, ("increment", 1), "a3")])
        new = random_regular(14, 3, seed=4)
        dirty = p.plan.changed_delivery_rows(old, new, 10, 14)
        obs.append(dirty)
        rt.membership_grow(14, new, dirty_rows=dirty)
        _record(obs, p, rt)
        obs.append(rt.run_to_convergence(mode="frontier"))
        rt.update_batch("w", [(12, ("add", "tail"), "t0")])
        rt.update_batch("c", [(13, ("increment", 4), "t1")])
        obs.append(sorted(rt._actor_sites.items(), key=repr))
        small = random_regular(11, 3, seed=5)
        tgt = p.plan.claim_targets(14, 11)
        # rows 12 and 13 hand off (as a transfer schedule would), 11 retires
        for v in ("c", "w"):
            rt.join_rows(v, [int(tgt[1]), int(tgt[2])],
                         [p.row(rt, v, 12), p.row(rt, v, 13)])
        rt.membership_drop_tail(
            11, small, dirty_rows=p.plan.changed_delivery_rows(new, small, 14, 11),
            actor_targets={12: int(tgt[1]), 13: int(tgt[2])},
        )
        obs.append(sorted(rt._actor_sites.items(), key=repr))
        _record(obs, p, rt)
        obs.append(rt.run_to_convergence(mode="frontier"))
        obs.append(int(rt.coverage_value("c")))
        obs.append(sorted(rt.coverage_value("w")))
        _raises(obs, ValueError, rt.membership_grow, 11, small, match="exceed")
        _raises(obs, ValueError, rt.membership_drop_tail, 12, ring(12, 2),
                match="below")
        rt.resize(8, ring(8, 2), graceful=False)  # crash: sites >= 8 retire
        obs.append(sorted(rt._actor_sites.items(), key=repr))

    _twin(scn)


@pytest.mark.parametrize("old_n,new_n", [(8, 3), (100, 99), (5, 4), (64, 7)])
def test_claim_helpers_match_jax(old_n, new_n):
    assert np.array_equal(tmplan.claim_targets(old_n, new_n),
                          jmplan.claim_targets(old_n, new_n))
    assert np.array_equal(tmplan.seed_sources(new_n, old_n),
                          jmplan.seed_sources(new_n, old_n))
    assert tmplan.claim_row(old_n - 1, new_n) == jmplan.claim_row(old_n - 1, new_n)
    a = random_regular(old_n, 3, seed=old_n) if old_n > 3 else ring(old_n, 1)
    b = random_regular(new_n, 3, seed=new_n) if new_n > 3 else ring(new_n, 1)
    for args in ((a, b, old_n, new_n), (b, a, new_n, old_n)):
        got, want = tmplan.changed_delivery_rows(*args), jmplan.changed_delivery_rows(*args)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="claim_targets"):
        tmplan.claim_targets(new_n, old_n)
    with pytest.raises(ValueError, match="seed_sources"):
        tmplan.seed_sources(old_n, new_n)


def test_reseed_row_zero_dim_leaves_from_numpy():
    """An I-Var row (0-d leaves) restored from numpy leaves, the form
    ``load_runtime_rows`` returns."""
    def scn(p, obs):
        store = p.Store(n_actors=2)
        store.declare(id="v", type="lasp_ivar")
        rt = p.RT(store, p.Graph(store), 4, ring(4, 1))
        rt.update_batch("v", [(0, ("set", "x"), "w")])
        obs.append(rt.run_to_convergence())
        row = [np.array(x) for x in p.row(rt, "v", 2)]
        rt.reseed_row(1)
        obs.append(rt.replica_value("v", 1))
        rt.reseed_row(1, {"v": row})
        obs.append(rt.replica_value("v", 1))
        _record(obs, p, rt)

    _twin(scn)


def test_map_rows_join_reseed_and_resize():
    """A reset-mode map (nested fields, ``None`` leaves) through
    ``join_rows`` (broadcast and per row), ``reseed_row`` and a graceful
    shrink folding two sources into one target."""
    def scn(p, obs):
        store = p.Store(n_actors=4)
        store.declare(id="m", type="riak_dt_map", n_actors=4, reset_on_readd=True,
                      fields=[(("G", "lasp_gset"), "lasp_gset", {"n_elems": 4}),
                              (("C", "riak_dt_gcounter"), "riak_dt_gcounter", {})])
        rt = p.RT(store, p.Graph(store), 8, ring(8, 2))
        kg, kc = ("G", "lasp_gset"), ("C", "riak_dt_gcounter")
        rt.update_batch("m", [(1, ("update", [("update", kg, ("add", "a")),
                                              ("update", kc, ("increment", 2))]), "w0"),
                              (6, ("update", [("update", kg, ("add", "b"))]), "w1")])
        row = p.tree_row(rt.states["m"], 1)
        obs.append(rt.join_rows("m", [0, 3, 5], row))
        obs.append(rt.join_rows("m", [2, 4], [p.tree_row(rt.states["m"], 6),
                                              p.tree_row(rt.states["m"], 1)]))
        _record(obs, p, rt)
        rt.reseed_row(3)
        rt.update_batch("m", [(7, ("update", [("update", kg, ("add", "c"))]), "w2")])
        rt.resize(3, ring(3, 1), graceful=True)  # rows 3..7 fold onto 0..2
        _record(obs, p, rt)
        obs.append(rt.run_to_convergence(mode="frontier"))
        obs.append(rt.coverage_value("m"))
        _record(obs, p, rt)

    _twin(scn)
