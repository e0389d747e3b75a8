"""The port's CRDT map codec (``lasp_tpu_torch.lattice.map``) against
``lasp_tpu.lattice.map`` on seeded random populations: every contract
function, the update moves (``touch``, ``set_field``, ``remove``,
``reset_observed``, ``effective_field``) and ``grow``, in both re-add modes
and with a nested submap field. The port runs on the whole ``[R, ...]``
population at once; JAX is ``vmap``-ed over the rows. Tolerance zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasp_tpu.store.store as jss
from lasp_tpu.lattice import CrdtMap as JMap
from lasp_tpu_torch import bridge_state
from lasp_tpu_torch.lattice import CrdtMap as TMap
from lasp_tpu_torch.lattice.base import tree_leaves
import lasp_tpu_torch.store.store as tss

torch.set_num_threads(1)

R = 48
A = 3

SUB = [(("c2", "riak_dt_gcounter"), "riak_dt_gcounter", {}),
       (("g2", "lasp_gset"), "lasp_gset", {"n_elems": 4})]
FIELDS = [
    (("g", "lasp_gset"), "lasp_gset", {"n_elems": 5}),
    (("c", "riak_dt_gcounter"), "riak_dt_gcounter", {}),
    (("i", "lasp_ivar"), "lasp_ivar", {}),
    (("o", "lasp_orset"), "lasp_orset", {"n_elems": 3, "tokens_per_actor": 2}),
    (("w", "riak_dt_orswot"), "riak_dt_orswot", {"n_elems": 3}),
    (("n", "riak_dt_map"), "riak_dt_map", {"fields": SUB}),
]


def _specs(fields, reset):
    return (jss.build_map_spec(fields, A, reset_on_readd=reset),
            tss.build_map_spec(fields, A, reset_on_readd=reset))


def _random_pop(rng, js):
    """A random ``[R, ...]`` population of ``js``'s layout as numpy
    leaves (None kept where the layout has None)."""

    def gen(x):
        shape = (R,) + tuple(x.shape)
        if x.dtype == jnp.bool_:
            return rng.rand(*shape) < 0.35
        return rng.randint(0, 4, size=shape).astype(np.asarray(x).dtype)

    return jax.tree_util.tree_map(gen, JMap.new(js))


def _partner(rng, a):
    """Per row: equal, grown (a join with random) or unrelated, the same
    pick on every leaf, so equal and both inflations go both ways."""
    pick = rng.randint(0, 3, size=R)

    def leaf(x):
        rnd = (rng.rand(*x.shape) < 0.3 if x.dtype == bool
               else rng.randint(0, 5, size=x.shape).astype(x.dtype))
        grown = (x | rnd) if x.dtype == bool else np.maximum(x, rnd)
        sel = pick.reshape((R,) + (1,) * (x.ndim - 1))
        return np.where(sel == 1, grown, np.where(sel == 2, rnd, x)).astype(x.dtype)

    return jax.tree_util.tree_map(leaf, a)


def _pair(np_state, ts):
    return (jax.tree_util.tree_map(jnp.asarray, np_state),
            bridge_state.from_numpy("riak_dt_map", ts, np_state, device="cpu"))


def _same(port_state, jax_state):
    got = [x.numpy() for x in tree_leaves(port_state)]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_state)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def _vmap(fn, *xs):
    return jax.vmap(fn)(*xs)


@pytest.mark.parametrize("reset", [False, True])
def test_lattice_functions_match_jax(reset):
    rng = np.random.RandomState(7 + reset)
    js, ts = _specs(FIELDS, reset)
    a_np = _random_pop(rng, js)
    ja, ta = _pair(a_np, ts)
    jb, tb = _pair(_partner(rng, a_np), ts)
    _same(TMap.merge(ts, ta, tb), _vmap(lambda x, y: JMap.merge(js, x, y), ja, jb))
    for fn in ("equal", "is_inflation", "is_strict_inflation"):
        got = getattr(TMap, fn)(ts, ta, tb).numpy()
        want = np.asarray(_vmap(lambda x, y, f=fn: getattr(JMap, f)(js, x, y), ja, jb))
        assert got.shape == (R,) and np.array_equal(got, want), fn
        assert got.any() and not got.all() or fn == "is_strict_inflation", fn
    assert np.array_equal(TMap.value(ts, ta).numpy(),
                          np.asarray(_vmap(lambda x: JMap.value(js, x), ja)))
    # the merge is a join: idempotent and commutative on the port
    m = TMap.merge(ts, ta, tb)
    assert bool(TMap.equal(ts, TMap.merge(ts, m, m), m).all())
    assert bool(TMap.equal(ts, TMap.merge(ts, tb, ta), m).all())


@pytest.mark.parametrize("reset", [False, True])
def test_update_moves_match_jax(reset):
    rng = np.random.RandomState(21 + reset)
    js, ts = _specs(FIELDS, reset)
    ja, ta = _pair(_random_pop(rng, js), ts)
    for f in range(len(FIELDS)):
        _same(TMap.remove(ts, ta, f), _vmap(lambda x, f=f: JMap.remove(js, x, f), ja))
        _same(TMap.touch(ts, ta, f, f % A),
              _vmap(lambda x, f=f: JMap.touch(js, x, f, f % A), ja))
        _same(TMap.effective_field(ts, ta, f),
              _vmap(lambda x, f=f: JMap.effective_field(js, x, f), ja))
    _same(TMap.set_field(ts, ta, 0, ta.fields[0]._replace(mask=~ta.fields[0].mask)),
          _vmap(lambda x: JMap.set_field(js, x, 0, x.fields[0]._replace(
              mask=~x.fields[0].mask)), ja))
    if reset:
        _same(TMap.reset_observed(ts, ta),
              _vmap(lambda x: JMap.reset_observed(js, x), ja))
    # a single state (no batch dims) takes the same moves
    one = jax.tree_util.tree_map(lambda x: x[3], ja)
    tone = bridge_state.from_numpy(
        "riak_dt_map", ts, jax.tree_util.tree_map(np.asarray, one), device="cpu"
    )
    _same(TMap.remove(ts, tone, 5), JMap.remove(js, one, 5))
    assert bool(TMap.equal(ts, tone, tone))


@pytest.mark.parametrize("reset", [False, True])
def test_grow_matches_jax(reset):
    """A population laid out for a field prefix (and a submap of one
    field) grows to the full schema: new top-level fields and a nested
    field appended, bottom slots everywhere, storage of its own."""
    rng = np.random.RandomState(5 + reset)
    small = FIELDS[:3] + [(("n", "riak_dt_map"), "riak_dt_map",
                           {"fields": SUB[:1]})]
    full = small[:3] + [small[3][:2] + ({"fields": SUB},), FIELDS[3], FIELDS[4]]
    js_small, ts_small = _specs(small, reset)
    js_full, ts_full = _specs(full, reset)
    ja, ta = _pair(_random_pop(rng, js_small), ts_small)
    tg = TMap.grow(ts_full, ta)
    _same(tg, JMap.grow(js_full, ja))
    assert TMap.grow(ts_full, tg) is tg  # nothing left to grow
    # the appended slots own their storage: a row write stays in its row
    tg.fields[4].exists[0, 0, 0] = True
    assert not bool(tg.fields[4].exists[1:].any())
    # single-state growth and new() agree with JAX too
    _same(TMap.new(ts_full, device="cpu"), JMap.new(js_full))
    _same(TMap.grow(ts_full, TMap.new(ts_small, device="cpu")),
          JMap.grow(js_full, JMap.new(js_small)))


def test_bridge_round_trips_a_map_population():
    """``bridge_state`` carries a JAX ``CrdtMap`` population (nested
    fields, epochs and tombs with their None entries) into the port and
    back unchanged."""
    rng = np.random.RandomState(3)
    for reset in (False, True):
        js, ts = _specs(FIELDS, reset)
        np_state = _random_pop(rng, js)
        ja, ta = _pair(np_state, ts)
        back = bridge_state.to_numpy(ta)
        assert (back.epochs is None) == (not reset)
        assert (back.tombs is None) == (not reset)
        if reset:
            assert [t is None for t in back.tombs] == [
                t is None for t in ja.tombs]
        flat_back = jax.tree_util.tree_leaves(back)
        flat_in = jax.tree_util.tree_leaves(np_state)
        assert len(flat_back) == len(flat_in)
        for x, y in zip(flat_back, flat_in):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    with pytest.raises(ValueError, match="embedded states"):
        js, ts = _specs(FIELDS, False)
        bad = _random_pop(rng, js)
        bridge_state.from_numpy(
            "riak_dt_map", ts, bad._replace(fields=bad.fields[:2]), device="cpu"
        )


@pytest.mark.parametrize("mode", ["dense", "frontier", "device"])
def test_map_population_rounds_match_jax(mode):
    """Map populations through the runtime's rounds: two maps of one spec
    (a plan group, no rows plan: per-member plain rounds) and a reset-mode
    map with an OR-Set field (the per-op write path), converged densely,
    by the frontier scheduler or with ``converge_on_device``: per-round
    residuals, round counts, states and coverage values equal JAX's."""
    import warnings

    import lasp_tpu.mesh as jmesh
    import lasp_tpu.store as jstore
    import lasp_tpu_torch.mesh as tmesh
    import lasp_tpu_torch.store as tstore
    from lasp_tpu.dataflow import Graph as JGraph
    from lasp_tpu.mesh import random_regular
    from lasp_tpu_torch.dataflow import Graph as TGraph

    n = 96
    plain = [(("g", "lasp_gset"), "lasp_gset", {"n_elems": 6}),
             (("c", "riak_dt_gcounter"), "riak_dt_gcounter", {})]
    rng = np.random.RandomState(17)
    homes = rng.choice(n, 4, replace=False)
    writes = {
        v: [(int(homes[a]), ("update", ("g", "lasp_gset"), ("add", f"e{rng.randint(6)}"))
             if i % 2 else ("update", ("c", "riak_dt_gcounter"), ("increment",)),
             f"w{a}") for i, a in enumerate(rng.randint(0, 4, size=12))]
        for v in ("m1", "m2")
    }
    writes["m3"] = [(int(homes[a]), ("update", ("o", "lasp_orset"), ("add", f"o{a}")),
                     f"w{a}") for a in range(4)]
    writes["m3"].append((int(homes[0]), ("remove", ("o", "lasp_orset")), "w0"))
    outs = []
    for port in (False, True):
        st, graph, mesh = ((tstore, TGraph, tmesh) if port else (jstore, JGraph, jmesh))
        kw = {"device": "cpu"} if port else {}
        store = st.Store(n_actors=4, **kw)
        for v in ("m1", "m2"):
            store.declare(id=v, type="riak_dt_map", fields=plain, n_actors=4)
        store.declare(id="m3", type="riak_dt_map", n_actors=4, reset_on_readd=True)
        rt = mesh.ReplicatedRuntime(store, graph(store), n,
                                    random_regular(n, 3, seed=2), **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for v, ops in writes.items():
                rt.update_batch(v, list(ops))
        if mode == "device":
            rounds = rt.converge_on_device()
        else:
            rounds = rt.run_to_convergence(mode=mode)
        outs.append((rt, rounds))
    (jrt, jr), (trt, tr) = outs
    assert jr == tr
    assert trt.round_residuals == [r["residual"] for r in jrt.trace.rounds]
    for v in ("m1", "m2", "m3"):
        _same(trt.states[v], jrt.states[v])
        assert trt.coverage_value(v) == jrt.coverage_value(v)
        assert trt.divergence(v) == jrt.divergence(v) == 0
    if mode == "frontier":
        assert trt._ensure_plan().describe()["vars_per_group"] == [2, 1]
