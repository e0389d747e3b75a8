"""The port's dispatch plan (``lasp_tpu_torch.mesh.plan`` and the runtime's
planned frontier round) against ``lasp_tpu``'s, after tests/mesh/test_plan.py:
the same grouping and ``describe()``, and — at 512 replicas over a mixed
G-Set / G-Counter / OR-SWOT / OR-Set store — the same per-round residuals,
rows touched, dense falls, round counts and final states under
``plan="auto"`` and ``plan="off"``, with and without an edge mask. Tolerance
zero: every value is a bit or an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasp_tpu.dataflow as jdf
import lasp_tpu.lattice as jl
import lasp_tpu.mesh as jmesh
import lasp_tpu.mesh.plan as jplan
import lasp_tpu.store as jstore
import lasp_tpu_torch.dataflow as tdf
import lasp_tpu_torch.lattice as tl
import lasp_tpu_torch.mesh as tmesh
import lasp_tpu_torch.mesh.plan as tplan
import lasp_tpu_torch.store as tstore
from lasp_tpu.mesh.topology import edge_failure_mask, random_regular, ring
from lasp_tpu_torch import bridge_state

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)

N = 512
JAX = (jstore, jdf, jmesh)
PORT = (tstore, tdf, tmesh)


def _declare_mixed(store):
    ids = [store.declare(id=f"g{i}", type="lasp_gset", n_elems=16) for i in range(3)]
    ids += [store.declare(id=f"c{i}", type="riak_dt_gcounter", n_actors=4)
            for i in range(2)]
    ids += [store.declare(id=f"o{i}", type="riak_dt_orswot", n_elems=8, n_actors=4)
            for i in range(2)]
    ids += [store.declare(id=f"s{i}", type="lasp_orset", n_elems=8, n_actors=4,
                          tokens_per_actor=2) for i in range(2)]
    # a codec with no row-sparse kernel plan: its group takes the plain rounds
    ids += [store.declare(id=f"i{i}", type="lasp_ivar") for i in range(2)]
    return ids


def _seed(rt, ids, seed=7, writes=4):
    """Client writes at ``writes`` rows per variable, one actor per row."""
    rng = np.random.RandomState(seed)
    for v in ids:
        rows = rng.choice(rt.n_replicas, writes, replace=False)
        tn = rt.store.variable(v).type_name
        if tn == "riak_dt_gcounter":
            ops = [(int(r), ("increment", i + 1), f"w{i}") for i, r in enumerate(rows)]
        elif tn == "lasp_gset":
            ops = [(int(r), ("add", f"e{r % 4}"), f"w{i}") for i, r in enumerate(rows)]
        elif tn == "lasp_ivar":
            ops = [(int(r), ("set", "p"), f"w{i}") for i, r in enumerate(rows)]
        else:
            ops = [(int(r), ("add_all", [f"x{r % 8}", f"x{(r + 1) % 8}"]), f"w{i}")
                   for i, r in enumerate(rows)]
            ops.append((int(rows[0]), ("remove", f"x{rows[0] % 8}"), "w0"))
        rt.update_batch(v, ops)


def _runtime(pkg, plan, nbrs, packed=False, declare=_declare_mixed, n=N):
    store_mod, df_mod, mesh_mod = pkg
    kw = {} if pkg is JAX else {"device": "cpu"}
    store = store_mod.Store(n_actors=4, **kw)
    ids = declare(store)
    rt = mesh_mod.ReplicatedRuntime(store, df_mod.Graph(store), n, nbrs,
                                    packed=packed, plan=plan, **kw)
    return rt, ids


def _same_states(trt, jrt, ids):
    for v in ids:
        got = bridge_state.to_numpy(trt.states[v])
        want = [np.asarray(x) for x in jrt.states[v]]
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(got, want)), v


def _same_port_states(a, b, ids):
    for v in ids:
        assert all(torch.equal(x, y) for x, y in zip(a.states[v], b.states[v])), v


# -- grouping -------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_describe_matches_jax(packed):
    nbrs = random_regular(N, 3, seed=5)
    jrt, _ = _runtime(JAX, "auto", nbrs, packed)
    trt, _ = _runtime(PORT, "auto", nbrs, packed)
    want = jrt._ensure_plan().describe()
    got = trt._ensure_plan().describe()
    assert got == want
    assert got["vars_per_group"] == [3, 2, 2, 2, 2]
    if packed:
        assert got["signatures"][3][0] == "FlatORSet"
    assert _runtime(PORT, "off", nbrs, packed)[0]._ensure_plan() is None


class _FakeRuntime:
    """The two attributes ``compile_plan`` reads."""

    def __init__(self, metas):
        self.var_ids = tuple(metas)
        self._metas = metas
        self.n_replicas = 8

    def _mesh_meta(self, v):
        return self._metas[v]


def test_grouping_order_and_unhashable_singletons_match_jax():
    """First appearance of each signature orders the groups, members keep
    ``var_ids`` order, and a spec that does not hash rides alone, last."""
    plans = []
    for lat, mod in ((jl, jplan), (tl, tplan)):
        g16, g8 = lat.GSetSpec(n_elems=16), lat.GSetSpec(n_elems=8)
        metas = {
            "a": (lat.GSet, g16), "u": (lat.GSet, [16]), "b": (lat.GCounter,
                                                                lat.GCounterSpec(4)),
            "c": (lat.GSet, g16), "d": (lat.GSet, g8), "e": (lat.GCounter,
                                                             lat.GCounterSpec(4)),
        }
        plan = mod.compile_plan(_FakeRuntime(metas))
        plans.append(([g.var_ids for g in plan.groups], plan.describe()))
        assert mod.hashable_signature(lat.GSet, [1]) is None
        assert mod.hashable_signature(lat.GSet, g16) == (lat.GSet, g16)
    assert plans[0] == plans[1]
    assert plans[1][0] == [("a", "c"), ("b", "e"), ("d",), ("u",)]


def test_stack_and_unstack_group_match_jax():
    rng = np.random.RandomState(3)
    leaves = [[rng.randint(0, 9, size=(6, 4)).astype(np.int32),
               rng.randint(0, 9, size=(6, 5, 4)).astype(np.int32)] for _ in range(3)]
    jstates = [jl.ORSWOTState(*map(jnp.asarray, x)) for x in leaves]
    tstates = [tl.ORSWOTState(*map(torch.as_tensor, x)) for x in leaves]
    jst, tst = jplan.stack_group(jstates), tplan.stack_group(tstates)
    for a, b in zip(bridge_state.to_numpy(tst), jst):
        assert np.array_equal(a, np.asarray(b))
    for got, want in zip(tplan.unstack_group(tst, 3), tstates):
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_unknown_plan_mode_raises():
    store = tstore.Store(device="cpu")
    with pytest.raises(ValueError, match="plan mode"):
        tmesh.ReplicatedRuntime(store, tdf.Graph(store), 8, ring(8, 2),
                                plan="banana", device="cpu")


# -- planned rounds: bit-identity -------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("topology", ["random", "ring"])
def test_planned_rounds_match_pervar_and_jax(topology, masked):
    """Round by round: the port's planned runtime against JAX's planned
    runtime (residual, rows touched, dense falls, states) and against the
    port's per-variable runtime (residual, states), to the fixed point."""
    # ring(N, 8) pulls from offsets ±1..±4: a diameter of 64 rounds
    nbrs = random_regular(N, 3, seed=11) if topology == "random" else ring(N, 8)
    mask = (edge_failure_mask(N, nbrs.shape[1], 0.25, seed=5, neighbors=nbrs)
            if masked else None)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    jrt, ids = _runtime(JAX, "auto", nbrs)
    trt, _ = _runtime(PORT, "auto", nbrs)
    off, _ = _runtime(PORT, "off", nbrs)
    for rt in (jrt, trt, off):
        _seed(rt, ids)
    _same_states(trt, jrt, ids)
    sparse_grouped = 0
    for rnd in range(200):
        rj, rt_, ro = jrt.frontier_step(jm), trt.frontier_step(tm), off.frontier_step(tm)
        assert rt_ == rj == ro, rnd
        assert trt.frontier_rows_last == jrt.frontier_rows_last, rnd
        assert trt.frontier_dense_falls_last == jrt.frontier_dense_falls_last, rnd
        assert off.frontier_rows_last == trt.frontier_rows_last, rnd
        sparse_grouped += trt.frontier_dense_falls_last < len(ids) and rj > 0
        _same_port_states(trt, off, ids)
        if rj == 0:
            break
    else:
        pytest.fail("no convergence")
    assert sparse_grouped > 0
    assert trt.round_residuals == off.round_residuals
    assert trt.round_residuals == [r["residual"] for r in jrt.trace.rounds]
    _same_states(trt, jrt, ids)
    assert trt._ensure_plan().describe() == jrt._ensure_plan().describe()
    for v in ids:
        assert trt.coverage_value(v) == jrt.coverage_value(v)
        assert trt.divergence(v) == jrt.divergence(v)
        if not masked:
            assert trt.divergence(v) == 0


def _two_gsets(store):
    return [store.declare(id="hot", type="lasp_gset", n_elems=16),
            store.declare(id="cold", type="lasp_gset", n_elems=16)]


def test_quiescent_member_rides_group_as_empty_rowmask():
    n = 32
    nbrs = random_regular(n, 3, seed=23)
    trt, (hot, cold) = _runtime(PORT, "auto", nbrs, declare=_two_gsets, n=n)
    trt.update_batch(hot, [(0, ("add", "h"), "a0")])
    assert trt.frontier_size(cold) == 0
    before = [x.clone() for x in trt.states[cold]]
    assert trt.frontier_step() > 0  # the hot member spread
    assert [len(g) for g in trt._plan.groups] == [2]
    assert all(torch.equal(x, y) for x, y in zip(trt.states[cold], before))
    assert trt.frontier_size(cold) == 0


def test_hot_member_promotes_only_itself_to_dense():
    """One all-dirty member takes the dense arm; its small-frontier peer
    stays sparse: rows touched is R plus the peer's reach, as in JAX."""
    n = 64
    nbrs = random_regular(n, 3, seed=41)
    rts = [_runtime(pkg, "auto", nbrs, declare=_two_gsets, n=n)[0] for pkg in (JAX, PORT)]
    for rt in rts:
        rt.update_batch("cold", [(0, ("add", "c"), "a0")])
        rt.update_batch("hot", [(int(r), ("add", f"h{r % 4}"), f"w{r}")
                                for r in range(n)])
        assert rt.frontier_size("hot") == n
        rt.frontier_step()
    jrt, trt = rts
    assert trt.frontier_rows_last == jrt.frontier_rows_last
    assert n < trt.frontier_rows_last < 2 * n
    assert trt.frontier_dense_falls_last == jrt.frontier_dense_falls_last == 1
    _same_states(trt, jrt, ("hot", "cold"))


def test_plan_invalidated_on_late_declare_and_mask_change():
    n = 32
    nbrs = random_regular(n, 3, seed=5)
    rts = [_runtime(pkg, "auto", nbrs, declare=_two_gsets, n=n)[0] for pkg in (JAX, PORT)]
    for rt in rts:
        rt.update_batch("hot", [(1, ("add", "h"), "a1")])
        rt.frontier_step()
    trt = rts[1]
    plan0 = trt._plan
    assert plan0 is not None and plan0.n_vars == 2
    for rt in rts:  # a late declare: the next write replicates it
        rt.store.declare(id="late", type="lasp_gset", n_elems=16)
        rt.update_batch("late", [(2, ("add", "l"), "a2")])
    assert trt._plan is None
    for rt in rts:
        rt.frontier_step()
    assert trt._plan.describe() == rts[0]._plan.describe()
    assert trt._plan.describe()["vars_per_group"] == [3]
    mask = edge_failure_mask(n, 3, 0.25, seed=1, neighbors=nbrs)
    plan1 = trt._plan
    trt._frontier_sync_mask(torch.as_tensor(mask))
    assert trt._plan is None  # the mask object changed
    trt.frontier_step(trt._frontier_mask_ref)
    assert trt._plan is not None and trt._plan is not plan1
