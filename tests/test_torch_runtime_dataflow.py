"""The port's replicated runtime with a dataflow graph and a reactive
trigger, against ``lasp_tpu``'s: the miniature ad counter of
tests/mesh/test_fused_steps.py (union pipeline, a view counter, a server
trigger that removes an over-threshold ad) at 32 replicas, packed and
dense. Per-round residuals, round counts (the signed budget case of
``converge_on_device`` included) and final states must agree bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasp_tpu.dataflow as jdf
import lasp_tpu.mesh as jmesh
import lasp_tpu.store as jstore
import lasp_tpu_torch.dataflow as tdf
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.store as tstore
from lasp_tpu.mesh.topology import random_regular
from lasp_tpu_torch import bridge_state

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)

N = 32


def _server_jax(x_idx, threshold):
    def server(dense):
        over = jnp.sum(dense["views"].counts, dtype=jnp.int32) >= threshold
        st = dense["a"]
        mask = jnp.zeros((4,), bool).at[jnp.asarray(x_idx)].set(over)
        return {"a": st._replace(removed=st.removed | (st.exists & mask[:, None]))}

    return server


def _server_port(x_idx, threshold):
    # one replica's view (the runtime vmaps it): the mask is a gather of
    # [over, False] through an element -> slot table
    table = torch.ones(4, dtype=torch.int64)
    table[torch.as_tensor(x_idx, dtype=torch.int64)] = 0

    def server(dense):
        over = torch.sum(dense["views"].counts, dtype=torch.int32) >= threshold
        st = dense["a"]
        mask = torch.stack([over, torch.zeros((), dtype=torch.bool)])[table]
        return {"a": st._replace(removed=st.removed | (st.exists & mask[:, None]))}

    return server


def _adcounter(port, packed, threshold=2, touches=None):
    """tests/mesh/test_fused_steps.py's ``_adcounter_runtime`` in either
    package."""
    st, df, mesh = (tstore, tdf, tmesh) if port else (jstore, jdf, jmesh)
    kw = {"device": "cpu"} if port else {}
    store = st.Store(n_actors=4, **kw)
    graph = df.Graph(store)
    a = store.declare(id="a", type="lasp_orset", n_elems=4, n_actors=1,
                      tokens_per_actor=1)
    b = store.declare(id="b", type="lasp_orset", n_elems=4, n_actors=1,
                      tokens_per_actor=1)
    graph.union(a, b, dst="u")
    store.declare(id="views", type="riak_dt_gcounter")
    rt = mesh.ReplicatedRuntime(store, graph, N, random_regular(N, 3, seed=9),
                                packed=packed, **kw)
    rt.update_batch("a", [(0, ("add_all", ["x", "y"]), "p")])
    rt.update_batch("b", [(1, ("add", "z"), "q")])
    rt.update_batch("views", [(2, ("increment",), "c0"), (3, ("increment",), "c1")])
    x_idx = rt.intern_terms("a", ["x"])
    make = _server_port if port else _server_jax
    rt.register_trigger(make(x_idx, threshold), touches=touches)
    return rt


def _twins(packed, **kw):
    return _adcounter(False, packed, **kw), _adcounter(True, packed, **kw)


def _same_states(jrt, trt):
    assert trt.var_ids == jrt.var_ids
    for v in jrt.var_ids:
        for a, b in zip(bridge_state.to_numpy(trt.states[v]), jrt.states[v]):
            b = np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), v


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("touches", [None, ("a", "views")])
def test_step_residuals_and_states_match_jax(packed, touches):
    jrt, trt = _twins(packed, touches=touches)
    residuals = []
    while True:
        r = jrt.step()
        assert trt.step() == r
        residuals.append(r)
        _same_states(jrt, trt)
        if r == 0:
            break
    assert len(residuals) > 2 and trt.round_residuals == residuals
    for v in jrt.var_ids:
        assert trt.coverage_value(v) == jrt.coverage_value(v)
        assert trt.divergence(v) == jrt.divergence(v) == 0
    # the trigger fired everywhere: x removed once the views reached 2
    assert trt.coverage_value("u") == {"y", "z"}


@pytest.mark.parametrize("packed", [False, True])
def test_block_convergence_matches_jax(packed):
    jrt, trt = _twins(packed)
    assert trt.run_to_convergence(block=4) == jrt.run_to_convergence(block=4)
    _same_states(jrt, trt)
    assert trt.round_residuals == [-1, 0]


@pytest.mark.parametrize("packed", [False, True])
def test_converge_on_device_matches_jax(packed):
    jrt, trt = _twins(packed)
    warm = jrt.converge_on_device(max_rounds=1, strict=False)
    assert warm == -1 and trt.converge_on_device(max_rounds=1, strict=False) == warm
    _same_states(jrt, trt)
    rounds = jrt.converge_on_device()
    assert trt.converge_on_device() == rounds > 1
    _same_states(jrt, trt)
    assert trt.round_residuals == [-1, 0]
    # one run from scratch takes the warm round plus the rest
    jrt2, trt2 = _twins(packed)
    assert trt2.converge_on_device() == jrt2.converge_on_device() == rounds + 1


@pytest.mark.parametrize("packed", [False, True])
def test_converge_on_device_budget(packed):
    jrt, trt = _twins(packed)
    # more than one block of the port's loop, short of the fixed point
    for rt in (jrt, trt):
        with pytest.raises(RuntimeError, match="no convergence within 3 rounds"):
            rt.converge_on_device(max_rounds=3)
    _same_states(jrt, trt)
    assert trt.converge_on_device(max_rounds=2, strict=False) == (
        jrt.converge_on_device(max_rounds=2, strict=False))
    _same_states(jrt, trt)
    for bad in ({"max_rounds": 0}, {"sync_every": -1}):
        with pytest.raises(ValueError):
            trt.converge_on_device(**bad)


@pytest.mark.parametrize("packed", [False, True])
def test_new_term_after_convergence_matches_jax(packed):
    """A write that interns a new term after a convergence (the tables the
    union indexes grow) converges to JAX's values a second time."""
    jrt, trt = _twins(packed)
    assert trt.converge_on_device() == jrt.converge_on_device()
    for rt in (jrt, trt):
        rt.update_batch("b", [(7, ("add_all", ["w", "v"]), "q")])
        rt.update_at(9, "a", ("add", "t"), "p")
    assert trt.run_to_convergence() == jrt.run_to_convergence()
    _same_states(jrt, trt)
    assert trt.coverage_value("u") == jrt.coverage_value("u") == {"y", "z", "w", "v", "t"}


def test_seed_increments_accumulates_duplicates():
    """Duplicate (row, lane) pairs add up, as JAX's ``.at[].add`` does."""
    rts = []
    for port in (False, True):
        st, df, mesh = (tstore, tdf, tmesh) if port else (jstore, jdf, jmesh)
        kw = {"device": "cpu"} if port else {}
        store = st.Store(n_actors=4, **kw)
        store.declare(id="c", type="riak_dt_gcounter", n_actors=4)
        rt = mesh.ReplicatedRuntime(store, df.Graph(store), N,
                                    random_regular(N, 3, seed=9), **kw)
        rt.seed_increments("c", [3, 3, 5, 3], [1, 1, 0, 2])
        rt.seed_increments("c", np.array([[5, 6]]), np.array([[0, 3]]), by=4)
        rts.append(rt)
    jrt, trt = rts
    _same_states(jrt, trt)
    assert trt.states["c"].counts[3].tolist() == [0, 2, 1, 0]
    assert trt.states["c"].counts[5].tolist() == [5, 0, 0, 0]
    assert trt.frontier_size("c") == jrt.frontier_size("c") == 3
    assert trt.run_to_convergence() == jrt.run_to_convergence()
    assert trt.coverage_value("c") == jrt.coverage_value("c") == 12
    with pytest.raises(IndexError):
        trt.seed_increments("c", [N], [0])


def test_trigger_contract_errors():
    trt = _adcounter(True, True)
    with pytest.raises(ValueError, match="exactly one"):
        trt.register_trigger()
    with pytest.raises(ValueError, match="exactly one"):
        trt.register_trigger(lambda d: {}, builder=lambda: (lambda d: {}))
    with pytest.raises(TypeError, match="not a callable"):
        trt.register_trigger(builder=lambda: None)
    # a write outside the declared touches, in both packages
    for port in (False, True):
        st, df, mesh = (tstore, tdf, tmesh) if port else (jstore, jdf, jmesh)
        kw = {"device": "cpu"} if port else {}
        store = st.Store(n_actors=4, **kw)
        store.declare(id="a", type="lasp_orset", n_elems=4)
        store.declare(id="g", type="lasp_gset", n_elems=4)
        rt = mesh.ReplicatedRuntime(store, df.Graph(store), N,
                                    random_regular(N, 3, seed=9), packed=True, **kw)
        rt.register_trigger(lambda d: {"g": d["a"]}, touches=("a",))
        with pytest.raises(KeyError, match="outside its declared touches"):
            rt.step()


@pytest.mark.parametrize("packed", [False, True])
def test_frontier_refused_auto_runs_dense(packed):
    jrt, trt = _twins(packed)
    with pytest.raises(RuntimeError, match="frontier gossip unavailable"):
        trt.run_to_convergence(mode="frontier")
    with pytest.raises(RuntimeError, match="frontier_step unavailable"):
        trt.frontier_step()
    assert trt.run_to_convergence(mode="auto") == jrt.run_to_convergence(mode="auto")
    _same_states(jrt, trt)
    # the dense step: one residual a round
    assert len(trt.round_residuals) > 2 and trt.round_residuals[-1] == 0


# -- seed_increments / seed_tokens index semantics (JAX's scatter rules) -----


def _seed_twins(packed, type_name, **caps):
    rts = []
    for port in (False, True):
        st, df, mesh = (tstore, tdf, tmesh) if port else (jstore, jdf, jmesh)
        kw = {"device": "cpu"} if port else {}
        store = st.Store(n_actors=4, **kw)
        store.declare(id="v", type=type_name, **caps)
        rts.append(mesh.ReplicatedRuntime(store, df.Graph(store), 16,
                                          random_regular(16, 3, seed=9),
                                          packed=packed, **kw))
    return rts


def _seed_both(jrt, trt, verb, *args):
    """Call ``verb`` on both runtimes: the same exception type (or none),
    then bit-equal states and frontier masks."""
    outcome = []
    for rt in (jrt, trt):
        try:
            getattr(rt, verb)("v", *args)
            outcome.append(None)
        except Exception as exc:  # noqa: BLE001 - the type is what is compared
            outcome.append(type(exc))
    assert outcome[0] == outcome[1], outcome
    _same_states(jrt, trt)
    assert np.array_equal(jrt._frontier["v"], trt._frontier["v"])
    return outcome[1]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rows,lanes,raised", [
    ([-1], [0], None),        # a negative row wraps to row 15
    ([2], [-1], None),        # a negative lane wraps to lane 3
    ([2], [4], None),         # an out-of-range lane drops; row 2 still dirty
    ([16], [0], IndexError),  # the add drops, the dirty marking raises
    ([2, 16], [1, 0], IndexError),  # row 2 lands, then the marking raises
    ([-17], [0], IndexError),
    ([3, 3, -1], [0, -4, 9], None),
])
def test_seed_increments_index_semantics_match_jax(packed, rows, lanes, raised):
    jrt, trt = _seed_twins(packed, "riak_dt_gcounter", n_actors=4)
    assert _seed_both(jrt, trt, "seed_increments", rows, lanes, 3) is raised


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rows,elems,tokens,raised", [
    ([1], [4], [0], None),     # element out of range: dropped
    ([1], [0], [99], None),    # token out of range: dropped (packed: word 2)
    ([1], [-1], [0], None),    # dense wraps to element 3; packed drops
    ([1], [0], [-1], None),    # dense wraps to token 15; packed drops
    ([1], [0], [20], None),    # packed: aliases into element 1 token 4
    ([-1], [2], [3], None),    # a negative row wraps
    ([16], [0], [0], IndexError),
    ([2, 16], [1, 1], [5, 5], IndexError),
    ([0, 0, 5], [3, 3, 2], [15, 15, 0], None),  # a duplicate triple
])
def test_seed_tokens_index_semantics_match_jax(packed, rows, elems, tokens, raised):
    jrt, trt = _seed_twins(packed, "lasp_orset", n_elems=4)
    assert _seed_both(jrt, trt, "seed_tokens", rows, elems, tokens) is raised
    if raised is None:
        assert trt.run_to_convergence() == jrt.run_to_convergence()
        assert trt.coverage_value("v") == jrt.coverage_value("v")
