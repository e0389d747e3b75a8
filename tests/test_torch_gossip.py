"""The port's gossip rounds and population reads against
``lasp_tpu.mesh.gossip``, and the copied topology tables against
``lasp_tpu.mesh.topology``. Same numpy-seeded populations into both
packages; the tolerance is zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasp_tpu.lattice as jl
import lasp_tpu.mesh.gossip as jg
import lasp_tpu.mesh.topology as jtopo
import lasp_tpu.ops as jops
import lasp_tpu_torch.lattice as tl
import lasp_tpu_torch.mesh.gossip as tg
import lasp_tpu_torch.mesh.topology as ttopo
import lasp_tpu_torch.ops as tops
from lasp_tpu_torch import bridge_state

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)

N, K = 96, 3


def _population(name, rng):
    """(jax codec, port codec, jax spec, port spec, numpy leaves)."""
    rows = rng.rand(N) < 0.15  # a few rows carry client writes
    if name == "lasp_gset":
        leaves = [(rng.rand(N, 10) < 0.3) & rows[:, None]]
        return jl.GSet, tl.GSet, jl.GSetSpec(10), tl.GSetSpec(10), leaves
    if name == "riak_dt_gcounter":
        c = (rng.randint(0, 4, size=(N, 5)) * rows[:, None]).astype(np.int32)
        return (jl.GCounter, tl.GCounter, jl.GCounterSpec(5),
                tl.GCounterSpec(5), [c])
    if name == "lasp_ivar":
        leaves = [rows.copy(), (rng.randint(0, 3, size=N) * rows).astype(np.int32)]
        return jl.IVar, tl.IVar, jl.IVarSpec(), tl.IVarSpec(), leaves
    if name == "riak_dt_orswot":
        clock = (rng.randint(0, 5, size=(N, 4)) * rows[:, None]).astype(np.int32)
        dots = np.minimum(rng.randint(0, 6, size=(N, 6, 4)), clock[:, None, :])
        dots = (dots * (rng.rand(N, 6, 1) < 0.5)).astype(np.int32)
        return (jl.ORSWOT, tl.ORSWOT, jl.ORSWOTSpec(6, 4), tl.ORSWOTSpec(6, 4),
                [clock, dots])
    ex = (rng.rand(N, 4, 6) < 0.3) & rows[:, None, None]
    rm = ex & (rng.rand(N, 4, 6) < 0.4)
    dj = jl.ORSetSpec(n_elems=4, n_actors=3, tokens_per_actor=2)
    dt = tl.ORSetSpec(n_elems=4, n_actors=3, tokens_per_actor=2)
    if name == "lasp_orset":
        return jl.ORSet, tl.ORSet, dj, dt, [ex, rm]
    if name == "lasp_orset_flat":
        js, ts = jops.FlatORSetSpec(dense=dj), tops.FlatORSetSpec(dense=dt)
        st = jops.FlatORSet.pack(js, jl.ORSetState(jnp.asarray(ex), jnp.asarray(rm)))
        return jops.FlatORSet, tops.FlatORSet, js, ts, [np.asarray(x) for x in st]
    assert name == "lasp_orset_packed"
    js = jops.PackedORSetSpec(n_elems=4, n_actors=3, tokens_per_actor=2)
    ts = tops.PackedORSetSpec(n_elems=4, n_actors=3, tokens_per_actor=2)
    st = jops.pack_orset(js, jl.ORSetState(jnp.asarray(ex), jnp.asarray(rm)))
    return jops.PackedORSet, tops.PackedORSet, js, ts, [np.asarray(x) for x in st]


NAMES = ("lasp_gset", "riak_dt_gcounter", "lasp_ivar", "lasp_orset",
         "lasp_orset_flat", "lasp_orset_packed", "riak_dt_orswot")


def _pair(name, seed=0):
    jc, tc, js, ts, leaves = _population(name, np.random.RandomState(seed))
    jstate = type(jc.new(js))(*map(jnp.asarray, leaves))
    tstate = bridge_state.from_numpy(name, ts, leaves, device="cpu")
    return jc, tc, js, ts, jstate, tstate


def _same(tstate, jstate):
    got = bridge_state.to_numpy(tstate)
    want = [np.asarray(x) for x in jstate]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_gossip_round_matches_jax_to_the_fixed_point(name, masked):
    jc, tc, js, ts, jst, tst = _pair(name)
    nbrs = jtopo.random_regular(N, K, seed=4)
    mask = jtopo.edge_failure_mask(N, K, 0.3, seed=5, neighbors=nbrs) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    tn = torch.as_tensor(nbrs)
    for _ in range(40):
        jnew = jg.gossip_round(jc, js, jst, jnp.asarray(nbrs), jm)
        tnew = tg.gossip_round(tc, ts, tst, tn, tm)
        _same(tnew, jnew)
        done = bool(jl.tree_all_equal(jst, jnew))
        assert done == bool(tl.tree_all_equal(tst, tnew))
        jst, tst = jnew, tnew
        if done:
            break
    else:
        pytest.fail("no fixed point")
    assert int(tg.divergence(tc, ts, tst)) == int(jg.divergence(jc, js, jst))
    assert bool(tg.converged(tc, ts, tst)) == bool(jg.converged(jc, js, jst))


@pytest.mark.parametrize("name", NAMES)
def test_rows_round_join_all_and_reads_match_jax(name):
    jc, tc, js, ts, jst, tst = _pair(name, seed=3)
    nbrs = jtopo.random_regular(N, K, seed=8)
    rng = np.random.RandomState(1)
    mask = jtopo.edge_failure_mask(N, K, 0.3, seed=2, neighbors=nbrs)
    for edge_mask in (None, mask):
        rows = np.concatenate([rng.randint(0, N, size=20), [7, 7]])  # dup pad
        valid = np.arange(rows.size) < 20
        jm = None if edge_mask is None else jnp.asarray(edge_mask)
        tm = None if edge_mask is None else torch.as_tensor(edge_mask)
        jnew, jch = jg.gossip_round_rows(jc, js, jst, jnp.asarray(nbrs),
                                         jnp.asarray(rows), jm, jnp.asarray(valid))
        tnew, tch = tg.gossip_round_rows(tc, ts, tst, torch.as_tensor(nbrs),
                                         torch.as_tensor(rows), tm,
                                         torch.as_tensor(valid))
        _same(tnew, jnew)
        assert np.array_equal(tch.numpy(), np.asarray(jch))
    _same(tg.join_all(tc, ts, tst), jg.join_all(jc, js, jst))
    sub = [0, 5, 17, 95]
    _same(tg.quorum_read(tc, ts, tst, sub), jg.quorum_read(jc, js, jst, sub))
    assert np.array_equal(tg.diverged_rows(tc, ts, tst).numpy(),
                          np.asarray(jg.diverged_rows(jc, js, jst)))
    assert int(tg.divergence(tc, ts, tst)) == int(jg.divergence(jc, js, jst)) > 0
    assert not bool(tg.converged(tc, ts, tst))
    assert tg.round_traffic_bytes(tst, K) == jg.round_traffic_bytes(jst, K)
    assert tg.rows_traffic_bytes(tst, 9, K) == jg.rows_traffic_bytes(jst, 9, K)


@pytest.mark.parametrize("name", NAMES)
def test_grouped_and_shift_rounds_match_jax(name):
    """``gossip_round_grouped`` / ``gossip_round_rows_grouped`` (a leading
    group axis written out) and ``gossip_round_shift[_grouped]``
    (``torch.roll``) against JAX's vmapped and rolled rounds, with and
    without an edge mask."""
    pairs = [_pair(name, seed) for seed in (5, 6, 7)]
    jc, tc, js, ts = pairs[0][:4]
    jstack = type(pairs[0][4])(*(jnp.stack(x) for x in zip(*(p[4] for p in pairs))))
    tstack = type(pairs[0][5])(*(torch.stack(x) for x in zip(*(p[5] for p in pairs))))
    nbrs = jtopo.random_regular(N, K, seed=9)
    ring = jtopo.ring(N, 4)
    offsets = jtopo.shift_offsets(ring, N)
    assert offsets is not None
    rng = np.random.RandomState(10)
    rows = rng.randint(0, N, size=(3, 12))
    rows[:, -1] = rows[:, 0]  # a duplicate pad slot
    valid = np.stack([np.ones(12, bool), np.arange(12) < 5, np.zeros(12, bool)])
    for masked in (False, True):
        mask = jtopo.edge_failure_mask(N, K, 0.3, seed=11, neighbors=nbrs) if masked else None
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else torch.as_tensor(mask)
        _same(tg.gossip_round_grouped(tc, ts, tstack, torch.as_tensor(nbrs), tm),
              jg.gossip_round_grouped(jc, js, jstack, jnp.asarray(nbrs), jm))
        jnew, jch = jg.gossip_round_rows_grouped(
            jc, js, jstack, jnp.asarray(nbrs), jnp.asarray(rows),
            jnp.asarray(valid), jm)
        tnew, tch = tg.gossip_round_rows_grouped(
            tc, ts, tstack, torch.as_tensor(nbrs), torch.as_tensor(rows),
            torch.as_tensor(valid), tm)
        _same(tnew, jnew)
        assert np.array_equal(tch.numpy(), np.asarray(jch))
        assert not tch[2].any()
        rmask = jtopo.edge_failure_mask(N, 4, 0.3, seed=12, neighbors=ring) if masked else None
        jrm = None if rmask is None else jnp.asarray(rmask)
        trm = None if rmask is None else torch.as_tensor(rmask)
        tshift = tg.gossip_round_shift(tc, ts, pairs[0][5], offsets, trm)
        _same(tshift, jg.gossip_round_shift(jc, js, pairs[0][4], offsets, jrm))
        # on a ring the roll is the gather over the neighbour table
        _same(tshift, jg.gossip_round(jc, js, pairs[0][4], jnp.asarray(ring), jrm))
        _same(tg.gossip_round_shift_grouped(tc, ts, tstack, offsets, trm),
              jg.gossip_round_shift_grouped(jc, js, jstack, offsets, jrm))


def test_frontier_reach_matches_jax():
    nbrs = jtopo.random_regular(N, K, seed=2)
    f = np.random.RandomState(3).rand(N) < 0.1
    for include_self in (False, True):
        assert np.array_equal(
            tg.frontier_reach(f, nbrs, include_self),
            jg.frontier_reach(f, nbrs, include_self),
        )


@pytest.mark.parametrize("n", [1, 17, 512])
def test_topology_tables_are_identical(n):
    for k in (1, 2, 3, 8):
        assert np.array_equal(ttopo.ring(n, k), jtopo.ring(n, k))
        assert np.array_equal(ttopo.random_regular(n, k, seed=n),
                              jtopo.random_regular(n, k, seed=n))
        assert np.array_equal(ttopo.scale_free(n, k, seed=3),
                              jtopo.scale_free(n, k, seed=3))
        assert ttopo.shift_offsets(ttopo.ring(n, k), n) == jtopo.shift_offsets(
            jtopo.ring(n, k), n)
    nb = jtopo.scale_free(n, 3, seed=1)
    for a, b in zip(ttopo.locality_order(nb), jtopo.locality_order(nb)):
        assert np.array_equal(a, b)
    assert np.array_equal(
        ttopo.edge_failure_mask(n, 3, 0.25, seed=4, neighbors=nb),
        jtopo.edge_failure_mask(n, 3, 0.25, seed=4, neighbors=nb),
    )
    assert np.array_equal(ttopo.partition_mask(n, nb, 2),
                          jtopo.partition_mask(n, nb, 2))
