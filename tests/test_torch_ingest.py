"""The port's write path against ``lasp_tpu``'s: grouped ingest
(``mesh.ingest`` op tables, ``ingest_cycle`` / ``update_batch``), the map's
per-variable arm and late-declare sync, and the ``debug_actors`` guard. The
cases of tests/mesh/test_ingest.py, tests/mesh/test_map_late_sync.py and
tests/mesh/test_actor_guard.py (those free of resize) run through both
packages on the same inputs: states bit for bit, the same exceptions, the
same frontier marks and the same cycle reports (tolerance zero)."""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import lasp_tpu.mesh as jmesh
import lasp_tpu.mesh.ingest as jingest
import lasp_tpu.store as jstore
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.mesh.ingest as tingest
import lasp_tpu_torch.store as tstore
from lasp_tpu.dataflow import Graph as JGraph
from lasp_tpu.mesh import ring
from lasp_tpu.utils.interning import CapacityError as JCapacityError
from lasp_tpu_torch import bridge_state
from lasp_tpu_torch.dataflow import Graph as TGraph
from lasp_tpu_torch.lattice.base import tree_leaves
from lasp_tpu_torch.utils.interning import CapacityError as TCapacityError

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)

N = 6


def _pkg(port):
    if port:
        return tstore, TGraph, tmesh, {"device": "cpu"}
    return jstore, JGraph, jmesh, {}


def _declare_all(store):
    store.declare(id="g", type="lasp_gset", n_elems=16)
    store.declare(id="c", type="riak_dt_gcounter", n_actors=4)
    store.declare(id="o", type="lasp_orset", n_elems=8, n_actors=4,
                  tokens_per_actor=4)
    store.declare(id="w", type="riak_dt_orswot", n_elems=8, n_actors=4)
    store.declare(id="i", type="lasp_ivar")
    store.declare(id="m", type="riak_dt_map",
                  fields=[("tags", "lasp_gset", {"n_elems": 8}),
                          ("hits", "riak_dt_gcounter", {})],
                  n_actors=4)


def _build(port, plan="auto", packed=False, debug_actors=False):
    st, graph, mesh, kw = _pkg(port)
    store = st.Store(n_actors=4, **kw)
    _declare_all(store)
    return mesh.ReplicatedRuntime(store, graph(store), N, ring(N, 2), plan=plan,
                                  packed=packed, debug_actors=debug_actors, **kw)


def _twins(**kw):
    return _build(False, **kw), _build(True, **kw)


_OPS = {
    "g": [(0, ("add", "a"), "x"), (1, ("add_all", ["b", "c"]), "x"),
          (0, ("add", "a"), "x"), (2, ("add", "b"), "x")],
    "c": [(0, ("increment",), "a0"), (1, ("increment", 3), "a1"),
          (0, ("increment", 2), "a0")],
    "o": [(0, ("add", "e1"), "a0"), (0, ("add_all", ["e2", "e3"]), "a0"),
          (0, ("remove", "e1"), "a0"), (0, ("add", "e1"), "a1"),
          (3, ("add", "e2"), "a3"), (0, ("remove_all", ["e2", "e3"]), "a0")],
    "w": [(2, ("add", "s1"), "a2"), (2, ("add_all", ["s2", "s3"]), "a2"),
          (2, ("remove", "s1"), "a2"), (4, ("add", "s1"), "a0"),
          (2, ("add", "s1"), "a2")],
    "i": [(0, ("set", "v1"), "x"), (0, ("set", "v2"), "x"),
          (3, ("set", "v3"), "x")],
    "m": [(0, ("update", "tags", ("add", "t1")), "w0"),
          (1, ("update", "hits", ("increment", 2)), "w1"),
          (0, ("remove", "tags"), "w0"),
          (0, ("update", "tags", ("add", "t2")), "w0")],
}


def _np_leaves(tree) -> list:
    """The numpy leaves of a converted port state, depth first, None
    skipped (``jax.tree_util.tree_leaves``'s order)."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _np_leaves(part)]
    return [tree]


def _same_var(jrt, trt, v):
    got = _np_leaves(bridge_state.to_numpy(trt.states[v]))
    want = jax.tree_util.tree_leaves(jrt.states[v])
    assert len(got) == len(want), f"{v}: leaf counts"
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{v}: states"
    fj, ft = jrt._frontier.get(v), trt._frontier.get(v)
    assert np.array_equal(
        fj if fj is not None else np.zeros(N, bool),
        ft if ft is not None else np.zeros(N, bool),
    ), f"{v}: frontier marks"


def _same_report(jrep, trep):
    jrep, trep = dict(jrep), dict(trep)
    jerr, terr = jrep.pop("errors"), trep.pop("errors")
    assert list(jerr) == list(terr)
    for v in jerr:
        assert type(jerr[v]).__name__ == type(terr[v]).__name__
        assert str(jerr[v]) == str(terr[v])
    assert jrep == trep


@pytest.mark.parametrize("var", sorted(_OPS))
@pytest.mark.parametrize("plan", ["auto", "off"])
@pytest.mark.parametrize("packed", [False, True])
def test_update_batch_matches_jax_and_per_op(var, plan, packed):
    """Every codec × plan mode × layout: the port's batch equals JAX's
    (states and marks); under ``plan="auto"`` both equal the port's own
    per-op ``update_at`` loop, marks included (the exact marks)."""
    jrt, trt = _twins(plan=plan, packed=packed)
    jrt.update_batch(var, list(_OPS[var]))
    trt.update_batch(var, list(_OPS[var]))
    _same_var(jrt, trt, var)
    ref = _build(True, plan=plan, packed=packed)
    for r, op, actor in _OPS[var]:
        ref.update_at(r, var, op, actor)
    for a, b in zip(tree_leaves(ref.states[var]), tree_leaves(trt.states[var])):
        assert torch.equal(a, b)
    if plan == "auto":
        assert np.array_equal(ref._frontier[var], trt._frontier[var])


@pytest.mark.parametrize("packed", [False, True])
def test_encoded_tables_match_jax(packed):
    """The port's op tables equal JAX's column for column (host arrays), and
    so do the padded stacks and bucket accounting."""
    jrt, trt = _twins(packed=packed)
    for var, ops in _OPS.items():
        got = []
        for rt, mod in ((jrt, jingest), (trt, tingest)):
            v = rt.store.variable(var)
            table, err = mod.encode_batch(rt, v, v.type_name, rt.states[var],
                                          rt._normalize_ops(list(ops)))
            assert err is None
            got.append(table)
        jt, tt = got
        if var == "m":  # no op table: the map takes the per-variable arm
            assert jt is None and tt is None
            continue
        assert (tt.kind, tt.var_id, tt.n_ops, tt.slots) == (
            jt.kind, jt.var_id, jt.n_ops, jt.slots)
        assert list(tt.arrays) == list(jt.arrays)
        for name in jt.arrays:
            a, b = tt.arrays[name], np.asarray(jt.arrays[name])
            assert a.dtype == b.dtype and np.array_equal(a, b), (var, name)
        js, jb, jp = jingest.stack_tables([jt, jt], N)
        ts, tb, tp = tingest.stack_tables([tt, tt], N)
        assert (tb, tp) == (jb, jp)
        for name in js:
            assert np.array_equal(ts[name], js[name]), (var, name)


@pytest.mark.parametrize("packed", [False, True])
def test_plan_auto_matches_plan_off_whole_store(packed):
    jrt, trt = _twins(packed=packed)
    off = _build(True, plan="off", packed=packed)
    for var, ops in _OPS.items():
        jrt.update_batch(var, list(ops))
        trt.update_batch(var, list(ops))
        off.update_batch(var, list(ops))
    for var in _OPS:
        _same_var(jrt, trt, var)
        for a, b in zip(tree_leaves(off.states[var]), tree_leaves(trt.states[var])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("packed", [False, True])
def test_ingest_cycle_reports_and_group_applies(packed):
    """A multi-variable cycle: one group apply per plan group (two G-Sets
    share one), the same report as JAX's, and exact marks."""
    reports = []
    for port in (False, True):
        st, graph, mesh, kw = _pkg(port)
        store = st.Store(n_actors=4, **kw)
        for g in ("g1", "g2"):
            store.declare(id=g, type="lasp_gset", n_elems=16)
        store.declare(id="c1", type="riak_dt_gcounter", n_actors=4)
        store.declare(id="o1", type="lasp_orset", n_elems=8, n_actors=4)
        rt = mesh.ReplicatedRuntime(store, graph(store), N, ring(N, 2),
                                    packed=packed, **kw)
        before = tingest.GROUP_APPLIES
        reports.append((rt, rt.ingest_cycle({
            "g1": [(0, ("add", "a"), "x")],
            "g2": [(1, ("add", "b"), "x"), (2, ("add", "c"), "x"),
                   (2, ("add", "c"), "x")],
            "c1": [(0, ("increment",), "a0")],
            "o1": [(3, ("add_all", ["p", "q"]), "a1"), (3, ("remove", "p"), "a1")],
        })))
        if port:
            assert tingest.GROUP_APPLIES - before == 3
    (jrt, jrep), (trt, trep) = reports
    _same_report(jrep, trep)
    assert trep["dispatches"] == trep["groups"] == 3
    assert trep["fallback_vars"] == [] and trep["errors"] == {}
    for v in ("g1", "g2", "c1", "o1"):
        _same_var(jrt, trt, v)
        assert trt.coverage_value(v) == jrt.coverage_value(v)
    assert np.flatnonzero(trt._frontier["g2"]).tolist() == [1, 2]


def test_gset_add_of_present_element_marks_nothing():
    """The exact marks: a G-Set add of an element already at the row
    changes nothing and marks nothing (the per-variable arm marks it)."""
    for plan, want in (("auto", []), ("off", [0])):
        jrt, trt = _twins(plan=plan)
        for rt in (jrt, trt):
            rt.update_batch("g", [(0, ("add", "a"), "x")])
            rt._frontier["g"][:] = False
            rt.update_batch("g", [(0, ("add", "a"), "x")])
        _same_var(jrt, trt, "g")
        assert np.flatnonzero(trt._frontier["g"]).tolist() == want


def test_orset_remove_not_present_identical():
    """OR-Set remove of an absent element fails at its position with the
    prefix persisted: the same error, batch index, state and marks."""
    ops = [(0, ("add", "e1"), "a0"), (1, ("remove", "missing"), "a1"),
           (2, ("add", "e2"), "a2")]
    jrt, trt = _twins()
    excs = []
    for rt, exc_t in ((jrt, jstore.PreconditionError), (trt, tstore.PreconditionError)):
        with pytest.raises(exc_t) as ei:
            rt.update_batch("o", list(ops))
        excs.append(ei.value)
    assert excs[0].batch_index == excs[1].batch_index == 1
    assert str(excs[0]) == str(excs[1])
    _same_var(jrt, trt, "o")


@pytest.mark.parametrize("packed", [False, True])
def test_orset_tombstones_of_one_pair_or_together(packed):
    """remove, add, remove of one element at one row in one batch: two
    tombstone rows for one (row, elem) target, OR-ed as JAX's bool max."""
    ops = [(0, ("add", "e1"), "a0"), (0, ("remove", "e1"), "a0"),
           (0, ("add", "e1"), "a0"), (0, ("remove", "e1"), "a0"),
           (0, ("add", "e1"), "a1")]
    jrt, trt = _twins(packed=packed)
    jrt.update_batch("o", list(ops))
    trt.update_batch("o", list(ops))
    _same_var(jrt, trt, "o")
    assert trt.coverage_value("o") == jrt.coverage_value("o") == {"e1"}


def test_capacity_prefix_and_exhausted_pool_identical():
    ops = [(0, ("add", f"t{i}"), "a0") for i in range(20)]
    jrt, trt = _twins()
    for rt, exc_t in ((jrt, JCapacityError), (trt, TCapacityError)):
        with pytest.raises(exc_t):
            rt.update_batch("g", list(ops))
    _same_var(jrt, trt, "g")
    # five adds of one element at one row under one actor: the pool holds 4
    pool = [(1, ("add", "x"), "a0")] * 5
    for packed in (False, True):
        jrt, trt = _twins(packed=packed)
        excs = []
        for rt, exc_t in ((jrt, JCapacityError), (trt, TCapacityError)):
            with pytest.raises(exc_t) as ei:
                rt.update_batch("o", list(pool))
            excs.append(ei.value)
        assert str(excs[0]) == str(excs[1])
        assert excs[0].batch_index == excs[1].batch_index == 4
        _same_var(jrt, trt, "o")


def test_ivar_first_set_wins_and_exact_marks():
    jrt, trt = _twins()
    for rt in (jrt, trt):
        rt.update_batch("i", [(0, ("set", "v1"), "x")])
        rt._frontier["i"][:] = False
        rt.update_batch("i", [(0, ("set", "v2"), "x"), (1, ("set", "v3"), "x")])
    _same_var(jrt, trt, "i")
    assert np.flatnonzero(trt._frontier["i"]).tolist() == [1]
    assert trt.replica_value("i", 0) == "v1" and trt.replica_value("i", 1) == "v3"


def test_isolate_errors_and_variable_twice():
    jrt, trt = _twins()
    cycle = {"o": [(0, ("remove", "absent"), "a0")], "g": [(1, ("add", "ok"), "x")]}
    jrep = jrt.ingest_cycle(cycle, isolate_errors=True)
    trep = trt.ingest_cycle(cycle, isolate_errors=True)
    _same_report(jrep, trep)
    assert set(trep["errors"]) == {"o"}
    assert isinstance(trep["errors"]["o"], tstore.PreconditionError)
    assert trt.coverage_value("g") == {"ok"}
    for rt in (jrt, trt):
        with pytest.raises(ValueError, match="appears twice"):
            rt.ingest_cycle([("g", [(0, ("add", "z"), "x")]),
                             ("g", [(1, ("add", "z"), "x")])])
    # not isolated: the first error raises after every variable landed
    for rt, exc_t in ((jrt, jstore.PreconditionError), (trt, tstore.PreconditionError)):
        with pytest.raises(exc_t):
            rt.ingest_cycle({"o": [(2, ("remove", "absent"), "a0")],
                             "c": [(2, ("increment",), "a2")]})
    for v in ("o", "g", "c"):
        _same_var(jrt, trt, v)


def test_malformed_op_applies_nothing():
    """An unsupported verb is a batch-level error: nothing applied, the
    terms interned before it stay interned (both packages)."""
    jrt, trt = _twins()
    for rt in (jrt, trt):
        with pytest.raises(ValueError, match="unsupported op"):
            rt.update_batch("g", [(0, ("add", "a"), "x"), (1, ("remove", "a"), "x")])
    _same_var(jrt, trt, "g")
    assert len(trt.store.variable("g").elems) == len(jrt.store.variable("g").elems) == 1


def test_group_failure_does_not_strand_cycle(monkeypatch):
    """A failing group apply fails its own batches; the other group still
    lands and every batch's bookkeeping (superset marks) still runs."""
    real = tingest.apply_group

    def failing(kind, states, tables, n_replicas):
        if kind == "gcounter":
            raise RuntimeError("injected apply failure")
        return real(kind, states, tables, n_replicas)

    monkeypatch.setattr(tingest, "apply_group", failing)
    trt = _build(True)
    report = trt.ingest_cycle({"c": [(0, ("increment",), "a0")],
                               "g": [(1, ("add", "ok"), "x")]}, isolate_errors=True)
    assert "injected apply failure" in str(report["errors"]["c"])
    assert "g" not in report["errors"] and report["dispatches"] == 1
    assert trt.coverage_value("g") == {"ok"}
    assert trt._frontier["c"][0]  # the failed batch's superset mark
    assert np.flatnonzero(trt._frontier["g"]).tolist() == [1]


_EDGE_OPS = {
    "g": [("add", "a"), ("add", "b"), ("add", "c")],
    "c": [("increment",), ("increment", 2), ("increment",)],
    "o": [("add", "e1"), ("add", "e2"), ("remove", "e1")],
    "w": [("add", "s1"), ("add", "s2"), ("remove", "s1")],
    "i": [("set", "v1"), ("set", "v2"), ("set", "v3")],
    "m": [("update", "tags", ("add", "t1")), ("update", "hits", ("increment",)),
          ("remove", "tags")],
}


@pytest.mark.parametrize("var", sorted(_EDGE_OPS))
@pytest.mark.parametrize("plan", ["auto", "off"])
def test_rows_outside_the_population_refused(var, plan):
    """Rows outside ``[0, R)`` do what they do in JAX, on both ingest arms
    (``plan="auto"``: the op tables; ``"off"``: the per-variable arm): a
    negative row wraps, an out-of-range row reads as JAX's gathers read it
    and drops from every scatter, and the per-variable arm's dirty marking
    raises ``IndexError``. States, marks, interners, actor-guard sites and
    the exception (type and text) match; the port's card never sees the
    bad index (it is filtered on the host)."""
    for packed in ((False, True) if var == "o" else (False,)):
        for bad in (N, -1, N + 3):
            a, b, c = _EDGE_OPS[var]
            ops = [(0, a, "a0"), (bad, b, "a1"), (bad, c, "a1"), (1, a, "a2")]
            errs = []
            rts = []
            for port in (False, True):
                rt = _build(port, plan=plan, packed=packed, debug_actors=True)
                try:
                    rt.update_batch(var, list(ops))
                    errs.append(None)
                except Exception as exc:  # compared below, type and text
                    errs.append((type(exc).__name__, str(exc)))
                rts.append(rt)
            jrt, trt = rts
            assert errs[0] == errs[1], (packed, bad, errs)
            _same_var(jrt, trt, var)
            jv, tv = jrt.store.variable(var), trt.store.variable(var)
            for name in ("elems", "actors", "ivar_payloads"):
                ji, ti = getattr(jv, name), getattr(tv, name)
                assert (ji is None) == (ti is None)
                if ji is not None:
                    assert ji.terms() == ti.terms(), name
            assert trt._actor_sites == jrt._actor_sites


def test_normalize_ops_is_copy_on_write():
    big = [(0, ("increment",), "a0")] * 1000
    assert tmesh.ReplicatedRuntime._normalize_ops(big) is big
    terms = iter(["a", "b"])
    ops = [(0, ("add", "z"), "x"), (1, ("add_all", terms), "x")]
    out = tmesh.ReplicatedRuntime._normalize_ops(ops)
    assert out is not ops and out[0] is ops[0] and out[1][1] == ("add_all", ["a", "b"])
    # a generator is materialised once
    gen = ((r, ("add", "q"), "x") for r in range(3))
    assert len(tmesh.ReplicatedRuntime._normalize_ops(gen)) == 3


def test_bucket_of_and_empty_tables():
    assert [tingest.bucket_of(n) for n in (0, 1, 8, 9, 100)] == [
        jingest.bucket_of(n) for n in (0, 1, 8, 9, 100)] == [0, 8, 8, 16, 128]
    jrt, trt = _twins()
    for rt in (jrt, trt):
        rt.update_batch("i", [(0, ("set", "v1"), "x")])
        # every set lands on a defined row: an empty table, no apply
        rep = rt.ingest_cycle({"i": [(0, ("set", "v2"), "x")]})
        assert rep["dispatches"] == 0 and rep["grouped_vars"] == 1
    _same_var(jrt, trt, "i")


# -- the actor guard (tests/mesh/test_actor_guard.py, map- and resize-free) --


def _guard_rt(port, type_name="riak_dt_orswot", debug=True, n_actors=4, **caps):
    st, graph, mesh, kw = _pkg(port)
    store = st.Store(n_actors=n_actors, **kw)
    if type_name != "riak_dt_gcounter":
        caps.setdefault("n_elems", 8)
    store.declare(id="s", type=type_name, **caps)
    return mesh.ReplicatedRuntime(store, graph(store), 4, ring(4, 2),
                                  debug_actors=debug, **kw)


def _both(fn, **kw):
    """Run ``fn(rt, collision_error)`` on twin runtimes; the states after
    must agree."""
    rts = []
    for port in (False, True):
        rt = _guard_rt(port, **kw)
        fn(rt, (tmesh if port else jmesh).ActorCollisionError)
        rts.append(rt)
    jrt, trt = rts
    for a, b in zip(bridge_state.to_numpy(trt.states["s"]), jrt.states["s"]):
        assert np.array_equal(a, np.asarray(b))
    assert trt._actor_sites == jrt._actor_sites
    return jrt, trt


def test_guard_silent_loss_without_guard_raises_with_guard():
    def off(rt, _err):
        rt.update_at(0, "s", ("add", "x"), "shared-actor")
        rt.update_at(2, "s", ("add", "y"), "shared-actor")  # colliding dot
        rt.run_to_convergence(max_rounds=16)
        assert rt.coverage_value("s") != {"x", "y"}  # the silent loss

    _both(off, debug=False)

    def on(rt, err):
        rt.update_at(0, "s", ("add", "x"), "shared-actor")
        with pytest.raises(err, match="shared-actor"):
            rt.update_at(2, "s", ("add", "y"), "shared-actor")

    _both(on)


def test_guard_same_site_and_removes_pass():
    def same_site(rt, _err):
        rt.update_at(1, "s", ("add", "x"), "a1")
        rt.update_at(1, "s", ("add", "y"), "a1")
        rt.update_at(2, "s", ("add", "z"), "a2")
        rt.run_to_convergence(max_rounds=16)
        assert rt.coverage_value("s") == {"x", "y", "z"}

    _both(same_site)

    def removes(rt, _err):
        rt.update_at(0, "s", ("add", "x"), "a0")
        rt.run_to_convergence(max_rounds=16)
        rt.update_at(3, "s", ("remove", "x"), "a0")
        rt.run_to_convergence(max_rounds=16)
        assert rt.coverage_value("s") == frozenset()

    _both(removes)


def test_guard_gcounter_lane_and_seed_increments():
    def lane(rt, err):
        rt.update_at(0, "s", ("increment", 2), "w")
        with pytest.raises(err):
            rt.update_at(1, "s", ("increment",), "w")

    _both(lane, type_name="riak_dt_gcounter")

    def seeded(rt, err):
        rt.seed_increments("s", [0, 1, 2], [0, 1, 2])
        with pytest.raises(err):
            rt.seed_increments("s", [3], [1])  # lane 1 lives at row 1
        rt.seed_increments("s", [1], [1])
        with pytest.raises(err):
            rt.seed_increments("s", [0, 3], [3, 3])  # lane 3 from two rows
        rt.seed_increments("s", [0, 0], [3, 3])

    _both(seeded, type_name="riak_dt_gcounter")


def test_guard_cross_surface_lane_alias():
    def term_first(rt, err):
        rt.update_at(0, "s", ("increment",), "w")  # interns "w" -> lane 0
        with pytest.raises(err):
            rt.seed_increments("s", [3], [0])
        rt.seed_increments("s", [0], [0])

    _both(term_first, type_name="riak_dt_gcounter")

    def seed_first(rt, err):
        rt.seed_increments("s", [2], [0])
        with pytest.raises(err):
            rt.update_at(1, "s", ("increment",), "w0")

    _both(seed_first, type_name="riak_dt_gcounter")


def test_guard_update_batch_all_or_nothing():
    def batch(rt, err):
        with pytest.raises(err):
            rt.update_batch("s", [(0, ("add", "x"), "w"), (1, ("add", "y"), "w")])
        assert rt.coverage_value("s") == frozenset()
        rt.update_batch("s", [(2, ("add", "z"), "w")])
        assert rt.replica_value("s", 2) == {"z"}
        with pytest.raises(err):
            rt.update_batch("s", [(0, ("add", "q"), "w")])

    for plan in ("auto", "off"):
        for port in (False, True):
            st, graph, mesh, kw = _pkg(port)
            store = st.Store(n_actors=4, **kw)
            store.declare(id="s", type="riak_dt_orswot", n_elems=8)
            rt = mesh.ReplicatedRuntime(store, graph(store), 4, ring(4, 2),
                                        debug_actors=True, plan=plan, **kw)
            batch(rt, mesh.ActorCollisionError)
            f = rt._frontier.get("s")
            assert f is not None and np.flatnonzero(f).tolist() == [2]


def test_guard_partial_batch_registers_only_applied_sites():
    def capacity(rt, _err):
        cap_t = TCapacityError if isinstance(rt, tmesh.ReplicatedRuntime) else JCapacityError
        with pytest.raises(cap_t):
            rt.update_batch("s", [(0, ("add", "e0"), "w0"), (0, ("add", "e1"), "w0"),
                                  (1, ("add", "e2"), "w1")])
        assert ("s", "w1") not in rt._actor_sites
        assert rt._actor_sites.get(("s", "w0")) == 0

    _both(capacity, n_actors=2, n_elems=2)

    def precondition(rt, err):
        pre_t = (tstore if isinstance(rt, tmesh.ReplicatedRuntime) else jstore
                 ).PreconditionError
        with pytest.raises(pre_t):
            rt.update_batch("s", [(0, ("add", "x"), "w"), (1, ("remove", "missing"), "a")])
        assert rt.replica_value("s", 0) == {"x"}
        with pytest.raises(err):
            rt.update_at(2, "s", ("add", "y"), "w")

    _both(precondition)

    def orset_failure(rt, err):
        pre_t = (tstore if isinstance(rt, tmesh.ReplicatedRuntime) else jstore
                 ).PreconditionError
        with pytest.raises(pre_t):
            rt.update_batch("s", [(0, ("add", "a"), "w0"),
                                  (1, ("remove", "never-added"), "w1"),
                                  (2, ("add", "b"), "w2")])
        with pytest.raises(err):
            rt.update_at(3, "s", ("add", "c"), "w0")
        rt.update_at(3, "s", ("add", "c"), "w2")
        rt.run_to_convergence(max_rounds=8)
        assert rt.coverage_value("s") == {"a", "c"}

    _both(orset_failure, type_name="lasp_orset", n_actors=8, tokens_per_actor=4)


def test_guard_seed_increments_shape_error_and_off_by_default():
    def shape(rt, _err):
        with pytest.raises(Exception):
            rt.seed_increments("s", [0, 1], [0, 1], by=[[1, 2, 3]])
        assert not rt._actor_sites
        rt.seed_increments("s", [3], [0])

    _both(shape, type_name="riak_dt_gcounter")

    def off(rt, _err):
        rt.update_at(0, "s", ("add", "x"), "w")
        rt.update_at(1, "s", ("add", "y"), "w")  # no raise (documented caveat)

    _both(off, debug=False)


# -- the map's write path (tests/mesh/test_ingest.py, test_map_late_sync.py) --


def test_map_rides_the_per_variable_arm():
    """A multi-variable cycle with a map: one group apply per plan group of
    the encodable variables, none for the map (its ``fallback_vars``
    entry), the same report and states as JAX's."""
    reports = []
    for port in (False, True):
        st, graph, mesh, kw = _pkg(port)
        store = st.Store(n_actors=4, **kw)
        for g in ("g1", "g2"):
            store.declare(id=g, type="lasp_gset", n_elems=16)
        store.declare(id="c1", type="riak_dt_gcounter", n_actors=4)
        store.declare(id="m1", type="riak_dt_map",
                      fields=[("hits", "riak_dt_gcounter", {})], n_actors=4)
        rt = mesh.ReplicatedRuntime(store, graph(store), N, ring(N, 2), **kw)
        before = tingest.GROUP_APPLIES
        reports.append((rt, rt.ingest_cycle({
            "g1": [(0, ("add", "a"), "x")],
            "g2": [(1, ("add", "b"), "x"), (2, ("add", "c"), "x")],
            "c1": [(0, ("increment",), "a0")],
            "m1": [(0, ("update", "hits", ("increment",)), "w0")],
        })))
        if port:
            assert tingest.GROUP_APPLIES - before == 2
    (jrt, jrep), (trt, trep) = reports
    _same_report(jrep, trep)
    assert trep["dispatches"] == 2 and trep["fallback_vars"] == ["m1"]
    assert trt.coverage_value("m1") == jrt.coverage_value("m1") == {"hits": 1}
    for v in ("g1", "g2", "c1", "m1"):
        _same_var(jrt, trt, v)


def _late_rt(port):
    st, graph, mesh, kw = _pkg(port)
    store = st.Store(n_actors=4, **kw)
    rt = mesh.ReplicatedRuntime(store, graph(store), N, ring(N, 2), **kw)
    # declared after the runtime: no population yet, so the late-declare
    # sync must run before any field admission
    store.declare(id="m", type="riak_dt_map", n_actors=4)
    return store, rt


KEY = ("S", "lasp_gset")
KEY2 = ("C", "riak_dt_gcounter")


def test_map_late_declared_fields_identical():
    """Fields admitted mid-batch on a late-declared map: the batch equals
    JAX's and the port's own per-op ``update_at`` loop."""
    ops = [
        (0, ("update", [("update", KEY, ("add", "x"))]), "w0"),
        (1, ("update", [("update", KEY2, ("increment", 2))]), "w1"),
        (0, ("update", [("update", KEY2, ("increment",))]), "w0"),
    ]
    (_js, jrt), (_ts, trt) = _late_rt(False), _late_rt(True)
    jrt.update_batch("m", list(ops))
    trt.update_batch("m", list(ops))
    _same_var(jrt, trt, "m")
    _ref_store, ref = _late_rt(True)
    for r, op, actor in ops:
        ref.update_at(r, "m", op, actor)
    assert ref.coverage_value("m") == trt.coverage_value("m")
    for a, b in zip(tree_leaves(ref.states["m"]), tree_leaves(trt.states["m"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("verb", ["update_at", "update_batch"])
def test_late_declared_map_first_update_admits_fresh_key(verb):
    outs = []
    for port in (False, True):
        store, rt = _late_rt(port)
        if verb == "update_at":
            rt.update_at(1, "m", ("update", [("update", KEY, ("add", "a"))]), "w")
            assert rt.replica_value("m", 1) == {KEY: {"a"}}
        else:
            rt.update_batch("m", [
                (0, ("update", [("update", KEY, ("add", "x"))]), "w0"),
                (2, ("update", [("update", KEY2, ("increment", 2))]), "w2"),
            ])
        assert rt.states["m"].dots.shape[-2] == store.variable("m").spec.n_fields
        outs.append((rt, rt.run_to_convergence()))
    (jrt, jr), (trt, tr) = outs
    assert jr == tr
    assert trt.coverage_value("m") == jrt.coverage_value("m")
    _same_var(jrt, trt, "m")


def test_population_relayouts_fields_admitted_behind_runtimes_back():
    outs = []
    for port in (False, True):
        store, rt = _late_rt(port)
        rt.update_at(0, "m", ("update", [("update", KEY, ("add", "a"))]), "w")
        var = store.variable("m")
        before = var.spec.n_fields
        # an import path grows the store variable directly
        triple = type(store).resolve_dynamic_field(var.spec, KEY2)
        type(store).grow_map_fields(var, [triple])
        assert rt.states["m"].dots.shape[-2] == before
        assert rt.replica_value("m", 0) == {KEY: {"a"}}
        assert rt.states["m"].dots.shape[-2] == before + 1
        rt.update_at(1, "m", ("update", [("update", KEY2, ("increment",))]), "w2")
        outs.append((rt, rt.run_to_convergence()))
        assert rt.coverage_value("m") == {KEY: {"a"}, KEY2: 1}
    (jrt, jr), (trt, tr) = outs
    assert jr == tr
    _same_var(jrt, trt, "m")


def test_population_with_more_fields_than_spec_raises():
    msgs = []
    for port in (False, True):
        store, rt = _late_rt(port)
        rt.update_at(0, "m", ("update", [("update", KEY, ("add", "a"))]), "w")
        var = store.variable("m")
        var.spec = dataclasses.replace(var.spec, fields=())
        with pytest.raises(RuntimeError, match="field planes") as ei:
            rt.replica_value("m", 0)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("plan", ["auto", "off"])
def test_map_batch_failures_identical(plan):
    """The map batch's per-op atomicity: a remove of an absent field fails
    at its position (the prefix persists, the failing op's own earlier
    sub-ops rewind), a malformed sub-op refuses the whole batch, and an
    unbatchable schema (an OR-Set field) warns and goes per op."""
    cases = [
        [(0, ("update", [("update", "tags", ("add", "a")),
                         ("update", "hits", ("increment",))]), "w0"),
         (1, ("update", [("update", "tags", ("add", "b")),
                         ("remove", "nope")]), "w1"),
         (2, ("update", "hits", ("increment", 3)), "w2")],
        [(0, ("update", "tags", ("add", "a")), "w0"),
         (1, ("update", "hits", ("increment", 0)), "w1")],
        [(0, ("update", "tags", ("add", "a")), "w0"),
         (1, ("remove", "tags"), "w1"), (1, ("remove", "tags"), "w1")],
    ]
    for ops in cases:
        jrt, trt = _twins(plan=plan, debug_actors=True)
        errs = []
        for rt in (jrt, trt):
            try:
                rt.update_batch("m", list(ops))
                errs.append(None)
            except Exception as exc:  # compared below
                errs.append((type(exc).__name__, str(exc),
                             getattr(exc, "batch_index", None)))
        assert errs[0] == errs[1] and errs[0] is not None
        _same_var(jrt, trt, "m")
        assert trt._actor_sites == jrt._actor_sites
    caught = []
    for port in (False, True):
        st, graph, mesh, kw = _pkg(port)
        store = st.Store(n_actors=4, **kw)
        store.declare(id="m", type="riak_dt_map", n_actors=4,
                      fields=[("o", "lasp_orset", {"n_elems": 4})])
        rt = mesh.ReplicatedRuntime(store, graph(store), N, ring(N, 2),
                                    plan=plan, **kw)
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            rt.update_batch("m", [(0, ("update", "o", ("add", "x")), "w0"),
                                  (3, ("update", "o", ("add", "y")), "w3")])
        caught.append([str(w.message) for w in got])
        caught.append(rt)
    assert caught[0] == caught[2] and "no vectorized kernel" in caught[0][0]
    _same_var(caught[1], caught[3], "m")


def test_guard_map_update():
    """``debug_actors`` on a map: a field update mints a presence dot on
    the actor's lane, so a second site raises; a remove mints nothing."""
    key = ("X", "lasp_gset")
    sites = []
    for port in (False, True):
        st, graph, mesh, kw = _pkg(port)
        store = st.Store(n_actors=4, **kw)
        m = store.declare(id="m", type="riak_dt_map",
                          fields=[(key, "lasp_gset", {"n_elems": 4})])
        rt = mesh.ReplicatedRuntime(store, graph(store), 4, ring(4, 2),
                                    debug_actors=True, **kw)
        rt.update_at(0, m, ("update", [("update", key, ("add", "a"))]), "w")
        with pytest.raises((tmesh if port else jmesh).ActorCollisionError):
            rt.update_at(2, m, ("update", [("update", key, ("add", "b"))]), "w")
        rt.run_to_convergence(max_rounds=16)
        rt.update_at(3, m, ("update", [("remove", key)]), "w")
        with pytest.raises((tmesh if port else jmesh).ActorCollisionError):
            rt.update_batch(m, [(1, ("update", key, ("add", "c")), "w")])
        sites.append(rt._actor_sites)
    assert sites[0] == sites[1]
