"""The port's sharded gossip (``lasp_tpu_torch.mesh.shard_gossip``) against
``lasp_tpu.mesh.shard_gossip`` on JAX's 8 CPU devices, the port on 8
virtual ``cpu`` shard slots, tolerance zero: every plan table array for
array, the ring rounds for k = 1-3, the sharded coverage join, the
partitioned rounds of a G-Set and a packed OR-Set in both wire modes, the
sparse frontier round and the hierarchical converge body, and the
exchange's own count of the rows and bytes it moved against the plan (in
place of JAX's boundary-sized HLO tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import lasp_tpu.mesh.shard_gossip as jsg
import lasp_tpu_torch.mesh.shard_gossip as tsg
from lasp_tpu.lattice import GSet as JGSet
from lasp_tpu.lattice import GSetSpec as JGSetSpec
from lasp_tpu.lattice.base import replicate as jreplicate
from lasp_tpu.mesh.gossip import gossip_round as jgossip_round
from lasp_tpu.mesh.gossip import join_all as jjoin_all
from lasp_tpu.mesh.topology import locality_order, random_regular, ring, scale_free
from lasp_tpu.ops import PackedORSet as JPacked
from lasp_tpu.ops import PackedORSetSpec as JPackedSpec
from lasp_tpu_torch.lattice import GSet, GSetSpec
from lasp_tpu_torch.lattice.base import replicate
from lasp_tpu_torch.mesh.comm import Mesh
from lasp_tpu_torch.ops import PackedORSet, PackedORSetSpec

torch.set_num_threads(1)

S = 8


def _jmesh():
    return JMesh(np.array(jax.devices()[:S]), ("replicas",))


def _tmesh():
    return Mesh([torch.device("cpu")] * S, ("replicas",))


def _topo(n, seed=3, builder=scale_free):
    return locality_order(builder(n, 3, seed=seed))[1]


def _leaves_equal(jstate, tstate) -> bool:
    for a, b in zip(jax.tree_util.tree_leaves(jstate), tstate):
        a = np.asarray(a)
        b = b.cpu().numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        if not np.array_equal(a, b):
            return False
    return True


def _gset(n, e=16, seed=0, p=0.05):
    mask = np.random.RandomState(seed).rand(n, e) < p
    j = jreplicate(JGSet.new(JGSetSpec(n_elems=e)), n)._replace(mask=jnp.asarray(mask))
    t = replicate(GSet.new(GSetSpec(n_elems=e), device="cpu"), n)._replace(
        mask=torch.as_tensor(mask))
    return JGSet, JGSetSpec(n_elems=e), j, GSet, GSetSpec(n_elems=e), t


def _packed(n, seed=4):
    kw = dict(n_elems=8, n_actors=4, tokens_per_actor=2)
    jspec, tspec = JPackedSpec(**kw), PackedORSetSpec(**kw)
    rng = np.random.RandomState(seed)
    ex = rng.randint(0, 256, size=(n, jspec.n_elems, jspec.n_words)).astype(np.uint32)
    rm = ex & rng.randint(0, 256, size=ex.shape).astype(np.uint32)
    j = jreplicate(JPacked.new(jspec), n)._replace(
        exists=jnp.asarray(ex), removed=jnp.asarray(rm))
    t = replicate(PackedORSet.new(tspec, device="cpu"), n)._replace(
        exists=torch.as_tensor(ex.view(np.int32)),
        removed=torch.as_tensor(rm.view(np.int32)))
    return JPacked, jspec, j, PackedORSet, tspec, t


def _put(states, mesh):
    sh = NamedSharding(mesh, P("replicas"))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), states)


# -- the host plan, array for array --------------------------------------------


@pytest.mark.parametrize("builder,n,seed", [
    (scale_free, 256, 3), (scale_free, 128, 9), (random_regular, 256, 2),
])
def test_plan_tables_equal_jax(builder, n, seed):
    nn = _topo(n, seed, builder)
    want = jsg.partitioned_gossip_plan(nn, S)
    got = tsg.partitioned_gossip_plan(nn, S)
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[key].dtype == w.dtype and np.array_equal(got[key], w), key
        else:
            assert got[key] == w, key
    with pytest.raises(ValueError, match="do not divide"):
        tsg.partitioned_gossip_plan(nn[:n - 1], S)


@pytest.mark.parametrize("mode", ["gather", "alltoall"])
def test_sparse_exchange_tables_equal_jax(mode):
    n = 256
    nn = _topo(n)
    plan = tsg.partitioned_gossip_plan(nn, S)
    rng = np.random.RandomState(1)
    for dirty in (None, rng.rand(n) < 0.02, rng.rand(n) < 0.3, np.zeros(n, bool)):
        want = jsg.sparse_exchange_tables(plan, mode, dirty)
        got = tsg.sparse_exchange_tables(plan, mode, dirty)
        for key, w in want.items():
            assert np.array_equal(got[key], w), (mode, key)
    with pytest.raises(ValueError, match="unknown partitioned gossip mode"):
        tsg.sparse_exchange_tables(plan, "broadcast")


def test_accounting_helpers_equal_jax():
    n = 200
    nn = _topo(n)
    rng = np.random.RandomState(5)
    frontier = rng.rand(n) < 0.1
    for shards in (1, 3, 8):
        assert np.array_equal(tsg.shard_frontier_counts(frontier, shards),
                              jsg.shard_frontier_counts(frontier, shards))
        for s in range(shards):
            assert np.array_equal(tsg.shard_rows(n, shards, s),
                                  jsg.shard_rows(n, shards, s))
        assert tsg.shard_cut_bytes(nn, shards, 24) == jsg.shard_cut_bytes(nn, shards, 24)
    with pytest.raises(ValueError, match="out of range"):
        tsg.shard_rows(n, 4, 4)
    plan = tsg.partitioned_gossip_plan(nn, S)
    assert tsg.frontier_cut_rows(frontier, plan) == jsg.frontier_cut_rows(frontier, plan)
    for b, floor, cap in ((0, 8, 64), (5, 4, 64), (9, 8, 64), (100, 8, 64), (3, 1, 2)):
        assert tsg._pow2_bucket(b, floor, cap) == jsg._pow2_bucket(b, floor, cap)
    grid = Mesh(np.array([torch.device("cpu")] * 8, dtype=object).reshape(2, 4),
                ("slices", "replicas"))
    assert tsg.axis_extent(grid, ("slices", "replicas")) == 8
    assert tsg.axis_extent(grid, "replicas") == 4


# -- ring rounds and the sharded join --------------------------------------------


def test_ring_offsets_equal_jax():
    for k in range(1, 7):
        assert tsg.ring_offsets(k) == jsg.ring_offsets(k)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_ring_rounds_equal_jax(k):
    n = 64
    jc, js, jst, tc, ts, tst = _gset(n, seed=4, p=0.1)
    want, jchanged = jsg.ring_gossip_rounds(jc, js, _put(jst, _jmesh()), _jmesh(), 2, k=k)
    tsg.reset_exchange()
    got, tchanged = tsg.ring_gossip_rounds(tc, ts, tst, _tmesh(), 2, k=k)
    assert _leaves_equal(want, got) and bool(jchanged) == bool(tchanged)
    # each offset's slab: |off| rows from every shard, once a round
    rows = 2 * S * sum(abs(o) for o in tsg.ring_offsets(k))
    assert tsg.EXCHANGED["ppermute"]["rows"] == rows
    assert tsg.EXCHANGED["ppermute"]["bytes"] == rows * 16
    ref = jgossip_round(jc, js, jgossip_round(jc, js, jst, jnp.asarray(ring(n, k))),
                        jnp.asarray(ring(n, k)))
    assert _leaves_equal(ref, got)


def test_ring_rounds_packed_orset_and_block_too_small():
    jc, js, jst, tc, ts, tst = _packed(64, seed=5)
    want, _ = jsg.ring_gossip_rounds(jc, js, _put(jst, _jmesh()), _jmesh(), 3, k=2)
    got, _ = tsg.ring_gossip_rounds(tc, ts, tst, _tmesh(), 3, k=2)
    assert _leaves_equal(want, got)
    small = tsg.ring_gossip_round_fn(tc, ts, _tmesh(), k=5)
    with pytest.raises(ValueError, match="exceeds per-shard block"):
        small(tree_rows(tst, 16))
    tsg.ring_gossip_shardmap_dryrun(_tmesh(), 64)


def tree_rows(state, n):
    return type(state)(*(x[:n] for x in state))


def test_sharded_join_all_equals_jax():
    n = 72  # odd per-shard blocks (9 rows) exercise join_all's padding
    jc, js, jst, tc, ts, tst = _packed(n, seed=8)
    want = jsg.sharded_join_all(jc, js, jst, _jmesh())
    tsg.reset_exchange()
    got = tsg.sharded_join_all(tc, ts, tst, _tmesh())
    assert _leaves_equal(want, got)
    assert _leaves_equal(jjoin_all(jc, js, jst), got)
    assert tsg.EXCHANGED["all_gather"]["rows"] == S  # one row a shard


# -- partitioned rounds ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["gather", "alltoall"])
@pytest.mark.parametrize("kind,n,rounds", [("gset", 256, 3), ("packed", 128, 2)])
def test_partitioned_rounds_equal_jax(mode, kind, n, rounds):
    nn = _topo(n, seed=9 if kind == "packed" else 3)
    plan = tsg.partitioned_gossip_plan(nn, S)
    jc, js, jst, tc, ts, tst = (_gset(n) if kind == "gset" else _packed(n))
    want, jch = jsg.partitioned_gossip_rounds(jc, js, _put(jst, _jmesh()), _jmesh(),
                                              plan, rounds, mode=mode)
    tsg.reset_exchange()
    got, tch = tsg.partitioned_gossip_rounds(tc, ts, tst, _tmesh(), plan, rounds,
                                             mode=mode)
    assert _leaves_equal(want, got) and bool(jch) == bool(tch)
    ref = jst
    for _ in range(rounds):
        ref = jgossip_round(jc, js, ref, jnp.asarray(nn))
    assert _leaves_equal(ref, got)
    # the exchange moved the plan's rows, never the population: the union
    # buffer (S * m rows) or the per-destination slices (S * S * m2 rows)
    row_bytes = sum(x[0].numel() * x.element_size() for x in tst)
    if mode == "gather":
        per_round = S * plan["m"]
        ent = tsg.EXCHANGED["all_gather"]
        assert plan["stats"]["exchange_rows_per_round"] <= per_round < n
    else:
        per_round = S * S * plan["m2"]
        ent = tsg.EXCHANGED["all_to_all"]
        assert S * plan["m2"] == plan["stats"]["alltoall_rows_per_round"] < n
    assert ent["calls"] == rounds
    assert ent["rows"] == rounds * per_round
    assert ent["bytes"] == rounds * per_round * row_bytes


@pytest.mark.parametrize("mode", ["gather", "alltoall"])
def test_grouped_round_equals_members_and_jax(mode):
    n = 128
    nn = _topo(n)
    plan = tsg.partitioned_gossip_plan(nn, S)
    sets = [_gset(n, seed=s) for s in (1, 2, 3)]
    jc, js, tc, ts = sets[0][0], sets[0][1], sets[0][3], sets[0][4]
    jstack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[s[2] for s in sets])
    tstack = type(sets[0][5])(*(torch.stack(x) for x in zip(*[s[5] for s in sets])))
    jsend, jidx = jsg.partition_tables(plan, _jmesh(), mode=mode)
    jfn = jax.jit(jsg.partitioned_gossip_round_grouped(jc, js, _jmesh(), plan, mode=mode))
    want = jfn(jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(_jmesh(), P(None, "replicas"))),
        jstack), jsend, jidx)
    tsend, tidx = tsg.partition_tables(plan, _tmesh(), mode=mode)
    got = tsg.partitioned_gossip_round_grouped(tc, ts, _tmesh(), plan, mode=mode)(
        tstack, tsend, tidx)
    assert _leaves_equal(want, got)
    one = tsg.partitioned_gossip_round_fn(tc, ts, _tmesh(), plan, mode=mode)
    for g, s in enumerate(sets):
        assert torch.equal(one(s[5], tsend, tidx).mask, got.mask[g])


def test_round_refuses_a_mismatched_plan_and_mode():
    plan = tsg.partitioned_gossip_plan(_topo(64), 4)
    with pytest.raises(ValueError, match="plan was built for 4 shards"):
        tsg.partitioned_gossip_round_fn(GSet, GSetSpec(n_elems=4), _tmesh(), plan)
    plan8 = tsg.partitioned_gossip_plan(_topo(64), S)
    with pytest.raises(ValueError, match="unknown partitioned gossip mode"):
        tsg.partitioned_gossip_round_fn(GSet, GSetSpec(n_elems=4), _tmesh(), plan8,
                                        mode="broadcast")


# -- the sparse frontier round and the converge body -----------------------------


def _frontier_inputs(plan, mode, n, seed=6):
    rng = np.random.RandomState(seed)
    dirty = np.zeros(n, dtype=bool)
    dirty[plan["cut_rows"][: 5]] = True
    tabs = jsg.sparse_exchange_tables(plan, mode, dirty)
    block = plan["block"]
    rows_i = np.zeros((S, 1, 8), np.int32)
    valid_i = np.zeros((S, 1, 8), bool)
    rows_b = np.zeros((S, 1, 8), np.int32)
    valid_b = np.zeros((S, 1, 8), bool)
    bmask = plan["boundary_mask"]
    for s in range(S):
        own = np.arange(s * block, (s + 1) * block)
        inner = rng.permutation(own[~bmask[own]])[:6]
        outer = rng.permutation(own[bmask[own]])[:6]
        rows_i[s, 0, : inner.size] = inner - s * block
        valid_i[s, 0, : inner.size] = True
        rows_b[s, 0, : outer.size] = outer - s * block
        valid_b[s, 0, : outer.size] = True
    return tabs, rows_i, valid_i, rows_b, valid_b


@pytest.mark.parametrize("mode", ["gather", "alltoall"])
def test_frontier_round_equals_jax(mode):
    n = 256
    nn = _topo(n)
    plan = tsg.partitioned_gossip_plan(nn, S)
    jc, js, jst, tc, ts, tst = _gset(n, seed=2, p=0.2)
    tabs, ri, vi, rb, vb = _frontier_inputs(plan, mode, n)
    jhalo = jsg.make_halo(jst, plan, mode, _jmesh())
    jfn = jsg.partitioned_frontier_round_fn(jc, js, _jmesh(), plan, mode=mode,
                                            n_g=1, donate=False)
    _s, jidx = jsg.partition_tables(plan, _jmesh(), mode=mode)
    # a full-cut resync first (fresh halo), then the sparse payload
    full = jsg.sparse_exchange_tables(plan, mode, None)
    jout, jh, _a, _b = jfn((_put(jst, _jmesh()),), (jhalo,), jnp.asarray(full["pay_slot"]),
                           jnp.asarray(full["pay_pos"]), jnp.asarray(ri), jnp.asarray(vi),
                           jnp.asarray(rb), jnp.asarray(vb), jidx)
    want = jfn(jout, jh, jnp.asarray(tabs["pay_slot"]), jnp.asarray(tabs["pay_pos"]),
               jnp.asarray(ri), jnp.asarray(vi), jnp.asarray(rb), jnp.asarray(vb), jidx)
    thalo = tsg.make_halo(tst, plan, mode)
    tfn = tsg.partitioned_frontier_round_fn(tc, ts, _tmesh(), plan, mode=mode, n_g=1)
    _s, tidx = tsg.partition_tables(plan, _tmesh(), mode=mode)
    tout, th, _a, _b = tfn((tst,), (thalo,), full["pay_slot"], full["pay_pos"],
                           ri, vi, rb, vb, tidx)
    tsg.reset_exchange()
    got = tfn(tout, th, tabs["pay_slot"], tabs["pay_pos"], ri, vi, rb, vb, tidx)
    assert _leaves_equal(want[0][0], got[0][0])
    assert _leaves_equal(want[1][0], got[1][0])  # the halos
    assert np.array_equal(np.asarray(want[2]), got[2].numpy())
    assert np.array_equal(np.asarray(want[3]), got[3].numpy())
    kind = "all_to_all" if mode == "alltoall" else "all_gather"
    assert tsg.EXCHANGED[kind]["rows"] == tabs["payload_rows"]
    assert tsg.EXCHANGED[kind]["bytes"] == tabs["payload_rows"] * 16


@pytest.mark.parametrize("mode,window", [("gather", 1), ("gather", 8), ("alltoall", 3)])
def test_converge_body_equals_jax(mode, window):
    n = 128
    nn = _topo(n)
    plan = tsg.partitioned_gossip_plan(nn, S)
    a, b = _gset(n, seed=1, p=0.02), _gset(n, seed=2, p=0.02)
    groups_j = ((a[0], a[1], 2),)
    groups_t = ((a[3], a[4], 2),)
    jsend, jidx = jsg.partition_tables(plan, _jmesh(), mode=mode)
    jfn = jsg.partitioned_converge_fn(groups_j, _jmesh(), plan, mode=mode,
                                      window=window, donate=False, flight_rounds=4)
    jouts, jsigned, jring = jfn(((_put(a[2], _jmesh()), _put(b[2], _jmesh())),),
                                jsend, jidx, 64)
    tsend, tidx = tsg.partition_tables(plan, _tmesh(), mode=mode)
    tfn = tsg.partitioned_converge_fn(groups_t, _tmesh(), plan, mode=mode,
                                      window=window, flight_rounds=4)
    tsg.reset_exchange()
    touts, tsigned, tring = tfn(((a[5], b[5]),), tsend, tidx, 64)
    assert int(jsigned) == tsigned > 0
    for jm, tm in zip(jouts[0], touts[0]):
        assert _leaves_equal(jm, tm)
    assert np.array_equal(np.asarray(jring), tring.numpy())
    # one psum a window: ceil(rounds run / window)
    assert tsg.EXCHANGED["psum"]["calls"] == -(-tsigned // window)
    # the budget: signed negative, the rounds that ran
    jshort = jfn(((_put(a[2], _jmesh()), _put(b[2], _jmesh())),), jsend, jidx, 2)
    tshort = tfn(((a[5], b[5]),), tsend, tidx, 2)
    assert int(jshort[1]) == tshort[1] == -2
    with pytest.raises(ValueError, match="window"):
        tsg.partitioned_converge_fn(groups_t, _tmesh(), plan, window=0)
