"""The slice as a whole: twin ``Store`` + ``ReplicatedRuntime``s, one from
``lasp_tpu`` and one from the port, fed the same client writes at 512
replicas and converged the same way. Per-round residuals, round counts,
final states, ``coverage_value`` and ``divergence`` must agree exactly
(tolerance zero: every value is a bit or an integer)."""

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
from lasp_tpu.mesh.topology import edge_failure_mask, random_regular, ring
from lasp_tpu_torch import bridge_state

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)

N = 512
IDS = ("s", "g", "c")


def _topology(name):
    # ring(N, 8) pulls from offsets ±1..±4: a diameter of 64 rounds
    return random_regular(N, 3, seed=11) if name == "random" else ring(N, 8)


def _writes(rt, rng):
    """One OR-Set, one G-Set, one G-Counter and, where declared, one
    OR-SWOT, written through ``update_batch`` (adds, in-batch removes) and
    ``update_at``."""
    writers = rng.choice(N, 10, replace=False)
    ops = []
    for a, r in enumerate(writers[:6]):
        mine = [f"e{(3 * a + j) % 16}" for j in range(3)]
        ops.append((int(r), ("add_all", mine), f"w{a}"))
        if a % 3 == 0:
            ops.append((int(r), ("remove", mine[1]), f"w{a}"))
    rt.update_batch("s", ops)
    rt.update_at(int(writers[6]), "s", ("add", "late"), "w6")
    rt.update_batch("g", [(int(r), ("add", f"x{r % 7}"), f"c{r}")
                          for r in writers[4:]])
    rt.update_batch("c", [(int(r), ("increment", a + 1), f"w{a}")
                          for a, r in enumerate(writers[:8])])
    rt.update_at(int(writers[8]), "c", ("increment",), "w8")
    if "o" not in rt.store.ids():
        return
    ops = []
    for a, r in enumerate(writers[:6]):
        mine = [f"o{(2 * a + j) % 12}" for j in range(3)]
        ops.append((int(r), ("add_all", mine), f"w{a}"))
        if a % 2 == 0:
            ops.append((int(r), ("remove", mine[0]), f"w{a}"))
        if a == 3:
            ops.append((int(r), ("remove_all", mine[1:]), f"w{a}"))
            ops.append((int(r), ("add", "back"), f"w{a}"))
    rt.update_batch("o", ops)
    rt.update_at(int(writers[7]), "o", ("add", "solo"), "w7")
    rt.update_at(int(writers[1]), "o", ("remove", "o2"), "w1")


def _build(pkg, nbrs, packed):
    store_mod, df_mod, mesh_mod = pkg
    kw = {} if store_mod is jstore else {"device": "cpu"}
    store = store_mod.Store(n_actors=8, **kw)
    store.declare(id="s", type="lasp_orset", n_elems=40, n_actors=8,
                  tokens_per_actor=2)
    store.declare(id="g", type="lasp_gset", n_elems=16)
    store.declare(id="c", type="riak_dt_gcounter", n_actors=16)
    if not packed:  # packing changes the OR-Set only: one OR-SWOT run suffices
        store.declare(id="o", type="riak_dt_orswot", n_elems=24)
    if store_mod is jstore:
        rt = mesh_mod.ReplicatedRuntime(store, df_mod.Graph(store), N, nbrs,
                                        packed=packed, plan="off")
    else:
        rt = mesh_mod.ReplicatedRuntime(store, df_mod.Graph(store), N, nbrs,
                                        packed=packed, device="cpu")
    _writes(rt, np.random.RandomState(3))
    return rt


JAX = (jstore, jdf, jmesh)
PORT = (tstore, tdf, tmesh)


def _twins(topology, packed):
    nbrs = _topology(topology)
    return _build(JAX, nbrs, packed), _build(PORT, nbrs, packed), nbrs


def _assert_same_states(trt, jrt):
    assert trt.var_ids == jrt.var_ids
    for v in trt.var_ids:
        got = bridge_state.to_numpy(trt.states[v])
        want = [np.asarray(x) for x in jrt.states[v]]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), v


def _jax_residuals(jrt):
    return [r["residual"] for r in jrt.trace.rounds]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("run", ["dense", "block4", "frontier"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("topology", ["random", "ring"])
def test_run_to_convergence_matches_jax(topology, packed, run, masked):
    jrt, trt, nbrs = _twins(topology, packed)
    _assert_same_states(trt, jrt)  # the writes landed identically
    mask = (edge_failure_mask(N, nbrs.shape[1], 0.25, seed=5, neighbors=nbrs)
            if masked else None)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    kw = {"block": 4} if run == "block4" else {
        "mode": "frontier" if run == "frontier" else "dense"}
    rounds_j = jrt.run_to_convergence(edge_mask=jm, **kw)
    rounds_t = trt.run_to_convergence(edge_mask=tm, **kw)
    assert rounds_t == rounds_j > 1
    assert trt.round_residuals == _jax_residuals(jrt)
    _assert_same_states(trt, jrt)
    for v in trt.var_ids:
        assert trt.coverage_value(v) == jrt.coverage_value(v)
        assert trt.divergence(v) == jrt.divergence(v)
        if not masked:
            assert trt.divergence(v) == 0
    if not masked:
        assert trt.coverage_value("c") == sum(range(1, 9)) + 1
        assert "late" in trt.coverage_value("s")
    if not masked and not packed:
        assert {"solo", "back"} <= trt.coverage_value("o")
        assert "o7" not in trt.coverage_value("o")  # its writer removed it


@pytest.mark.parametrize("packed", [False, True])
def test_frontier_and_dense_steps_match_jax_round_by_round(packed):
    """Per-round states, not just the fixed point: the port's
    ``frontier_step`` and ``step`` each against ``lasp_tpu``'s, with a
    crossover that sends some rounds down the dense arm."""
    jf, tf, _ = _twins("random", packed)
    jd, td, _ = _twins("random", packed)
    for rt in (jf, tf):
        rt.frontier_crossover = 0.1
    sparse_rounds = 0
    for rnd in range(64):
        rj, rt_ = jf.frontier_step(), tf.frontier_step()
        assert rt_ == rj, rnd
        assert tf.frontier_rows_last == jf.frontier_rows_last, rnd
        assert tf.frontier_dense_falls_last == jf.frontier_dense_falls_last, rnd
        sparse_rounds += tf.frontier_dense_falls_last < len(tf.var_ids) and rt_ > 0
        _assert_same_states(tf, jf)
        dj, dt = jd.step(), td.step()
        assert dt == dj == rj, rnd
        _assert_same_states(td, jd)
        if rj == 0:
            break
    else:
        pytest.fail("no convergence")
    assert sparse_rounds > 0  # the row-sparse arm ran


def test_seed_tokens_and_reads_match_jax():
    """Device-side bulk seeding (duplicate triples included) and the row
    reads ``read_at`` / ``replica_value`` / ``quorum_value``."""
    rng = np.random.RandomState(9)
    rows = rng.randint(0, N, size=40)
    elems = rng.randint(0, 32, size=40)
    tokens = rng.randint(0, 16, size=40)
    rows[-1], elems[-1], tokens[-1] = rows[0], elems[0], tokens[0]
    for packed in (False, True):
        jrt, trt, _ = _twins("random", packed)
        jrt.intern_terms("s", [f"t{i}" for i in range(16)])
        trt.intern_terms("s", [f"t{i}" for i in range(16)])
        jrt.seed_tokens("s", rows, elems, tokens)
        trt.seed_tokens("s", rows, elems, tokens)
        _assert_same_states(trt, jrt)
        r0 = int(rows[0])
        assert trt.replica_value("s", r0) == jrt.replica_value("s", r0)
        assert trt.quorum_value("s", rows[:5]) == jrt.quorum_value("s", rows[:5])
        assert trt.run_to_convergence(mode="auto") == jrt.run_to_convergence(
            mode="auto")
        _assert_same_states(trt, jrt)
        for v in trt.var_ids:
            got, want = trt.read_at(r0, v), jrt.read_at(r0, v)
            assert (got is None) == (want is None)
            if got is not None:
                assert all(np.array_equal(a, np.asarray(b)) for a, b in
                           zip(bridge_state.to_numpy(got), want))


@pytest.mark.parametrize("plan", ["auto", "off"])
def test_orswot_batch_failure_matches_jax(plan):
    """An OR-SWOT batch whose k-th op fails not_present: the ops before it
    persist, ``batch_index == k``, nothing of op k or later applies, and
    the element and actor interners hold exactly what JAX's do; then the
    twins converge (dense under one plan mode, frontier under the other)."""
    nbrs = random_regular(64, 3, seed=2)

    def build(pkg):
        store_mod, df_mod, mesh_mod = pkg
        kw = {} if store_mod is jstore else {"device": "cpu"}
        store = store_mod.Store(n_actors=4, **kw)
        store.declare(id="o", type="riak_dt_orswot", n_elems=8)
        rt = mesh_mod.ReplicatedRuntime(store, df_mod.Graph(store), 64, nbrs,
                                        plan=plan, **kw)
        rt.update_batch("o", [(3, ("add", "pre"), "w3")])
        return rt

    ops = [
        (3, ("add_all", ["a", "b"]), "w3"),
        (5, ("add", "c"), "w5"),
        (3, ("remove_all", ["a", "pre"]), "w3"),
        (5, ("remove_all", ["c", "c"]), "w5"),  # second "c" is gone: fails
        (9, ("add", "late"), "w9"),
    ]
    jrt, trt = build(JAX), build(PORT)
    errors = []
    for rt in (jrt, trt):
        with pytest.raises(Exception, match="not_present") as info:
            rt.update_batch("o", ops)
        errors.append(info.value)
    assert [e.batch_index for e in errors] == [3, 3]
    assert type(errors[1]).__name__ == type(errors[0]).__name__ == "PreconditionError"
    for a, b in zip(bridge_state.to_numpy(trt.states["o"]), jrt.states["o"]):
        assert np.array_equal(a, np.asarray(b))
    jv, tv = jrt.store.variable("o"), trt.store.variable("o")
    assert tv.elems.terms() == jv.elems.terms() == ["pre", "a", "b", "c"]
    assert tv.actors.terms() == jv.actors.terms() == ["w3", "w5"]
    assert trt.replica_value("o", 3) == jrt.replica_value("o", 3) == {"b"}
    assert trt.replica_value("o", 5) == jrt.replica_value("o", 5) == {"c"}
    mode = "dense" if plan == "off" else "frontier"
    assert trt.run_to_convergence(mode=mode) == jrt.run_to_convergence(mode=mode)
    assert trt.coverage_value("o") == jrt.coverage_value("o") == {"b", "c"}
    assert trt.divergence("o") == jrt.divergence("o") == 0


def test_runtime_refuses_what_is_not_ported():
    """What is still not ported raises: a mesh over two devices (ROADMAP
    A5b). Sharding over one device's slots, resizing, mesh programs and the
    fused propagate are ported and run."""
    from lasp_tpu_torch.mesh.comm import Mesh
    from lasp_tpu_torch.programs import ExampleKeylistProgram

    store = tstore.Store(device="cpu")
    store.declare(id="s", type="lasp_gset", n_elems=4)
    rt = tmesh.ReplicatedRuntime(store, tdf.Graph(store), 8, ring(8, 2),
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="A5b"):
        rt.shard(Mesh([torch.device("cpu"), torch.device("meta")], ("replicas",)))
    rt.shard(Mesh([torch.device("cpu")] * 2, ("replicas",)))
    rt.register("keys", ExampleKeylistProgram, n_elems=4)
    rt.process(("k", 1), "put", "a", replica=3)
    assert rt.execute("keys") == {"k"}
    rt.resize(8, ring(8, 2))  # a topology swap
    assert rt.membership_epoch == 1
    graph = tdf.Graph(store)
    graph.map("s", lambda x: x)
    store.update("s", ("add", 1), "a")
    assert graph.propagate(mode="fused") == 1
