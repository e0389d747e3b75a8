"""The port's fused round loops against ``lasp_tpu.ops.fused``: the
per-block productive counts of ``fused_gossip_rounds_count``, the results
of ``fused_frontier_rounds`` and ``fused_gossip_rounds``, and the chaos
windows ``fused_chaos_rounds`` / ``fused_chaos_rounds_grouped`` and
``fused_gossip_rounds_grouped`` (states and residuals, tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasp_tpu.ops.fused as jf
from lasp_tpu.mesh import random_regular, ring
from lasp_tpu_torch.ops import fused as tf
from tests.test_torch_gossip import N, _pair, _same

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("name,topology,masked", [
    ("lasp_orset_packed", "random", False),
    ("lasp_orset_flat", "ring", False),
    ("riak_dt_gcounter", "random", True),
])
def test_productive_counts_per_block_match_jax(name, topology, masked):
    jc, tc, js, ts, jst, tst = _pair(name, seed=6)
    nbrs = random_regular(N, 3, seed=2) if topology == "random" else ring(N, 2)
    mask = (np.random.RandomState(3).rand(*nbrs.shape) > 0.2) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    block = 3
    counts_j, counts_t = [], []
    for _ in range(40):
        jst, pj = jf.fused_gossip_rounds_count(jc, js, jst, jnp.asarray(nbrs),
                                               block, jm)
        tst, pt = tf.fused_gossip_rounds_count(tc, ts, tst, torch.as_tensor(nbrs),
                                               block, tm)
        assert pt.dtype == torch.int32 and pt.dim() == 0
        counts_j.append(int(pj))
        counts_t.append(int(pt))
        _same(tst, jst)
        if int(pj) < block:
            break
    assert counts_t == counts_j
    assert sum(counts_j) > block  # the run spanned more than one block


def test_fused_gossip_rounds_matches_jax():
    jc, tc, js, ts, jst, tst = _pair("lasp_orset_packed", seed=9)
    nbrs = random_regular(N, 3, seed=5)
    for n_rounds in (1, 2, 5):
        jout, jch = jf.fused_gossip_rounds(jc, js, jst, jnp.asarray(nbrs), n_rounds)
        tout, tch = tf.fused_gossip_rounds(tc, ts, tst, torch.as_tensor(nbrs), n_rounds)
        _same(tout, jout)
        assert bool(tch) == bool(jch)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_frontier_rounds_match_jax_and_exit_early(masked):
    jc, tc, js, ts, jst, tst = _pair("lasp_gset", seed=4)
    nbrs = random_regular(N, 3, seed=7)
    mask = (np.random.RandomState(8).rand(N, 3) > 0.3) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    f0 = np.asarray(jst.mask).any(axis=1)
    budget = 50
    jout, jf_end, ji = jf.fused_frontier_rounds(
        jc, js, jst, jnp.asarray(nbrs), jnp.asarray(f0), budget, jm)
    tout, tf_end, ti = tf.fused_frontier_rounds(
        tc, ts, tst, torch.as_tensor(nbrs), torch.as_tensor(f0), budget, tm)
    _same(tout, jout)
    assert np.array_equal(tf_end.numpy(), np.asarray(jf_end))
    assert int(ti) == int(ji) < budget
    # an empty frontier runs no round at all
    out0, _f, i0 = tf.fused_frontier_rounds(
        tc, ts, tst, torch.as_tensor(nbrs), torch.zeros(N, dtype=torch.bool), budget)
    assert int(i0) == 0 and all(torch.equal(a, b) for a, b in zip(out0, tst))


def _chaos_masks(nbrs, seed):
    """A seeded chaos window: flaky links, a partition opening mid-window
    and a crash, as the schedule stacks them (``bool[T, R, K]``)."""
    from lasp_tpu_torch.chaos import ChaosSchedule, Crash, FlakyLinks, Partition, Restore

    s = ChaosSchedule(N, nbrs, [FlakyLinks(0, 6, 0.4), Partition(2, 5, 2),
                                Crash(1, 7), Restore(4, 7)], seed=seed)
    return s.masks(0, 8)


@pytest.mark.parametrize("name", ["lasp_gset", "riak_dt_orswot", "lasp_orset_packed"])
def test_fused_chaos_rounds_match_jax(name):
    """One chaos window: states and the ``int32[T]`` per-round residuals
    equal JAX's ``fori_loop`` over the stacked masks, and equal stepping the
    masks one round at a time."""
    from lasp_tpu_torch.mesh.gossip import gossip_round

    jc, tc, js, ts, jst, tst = _pair(name, seed=12)
    nbrs = random_regular(N, 3, seed=13)
    masks = _chaos_masks(nbrs, seed=3)
    jout, jres = jf.fused_chaos_rounds(jc, js, jst, jnp.asarray(nbrs), jnp.asarray(masks))
    tout, tres = tf.fused_chaos_rounds(tc, ts, tst, torch.as_tensor(nbrs), masks)
    _same(tout, jout)
    assert tres.dtype == torch.int32 and tres.shape == (8,)
    assert tres.tolist() == np.asarray(jres).tolist()
    ref, ref_res = tst, []
    for t in range(8):
        new = gossip_round(tc, ts, ref, torch.as_tensor(nbrs), torch.as_tensor(masks[t]))
        ref_res.append(int((~tc.equal(ts, ref, new)).sum()))
        ref = new
    _same(ref, jout)
    assert ref_res == tres.tolist()


@pytest.mark.parametrize("name", ["riak_dt_gcounter", "lasp_orset_flat", "riak_dt_orswot"])
def test_grouped_fused_rounds_match_jax(name):
    """``fused_gossip_rounds_grouped`` (``changed: bool[G]``) and
    ``fused_chaos_rounds_grouped`` (``int32[T, G]``) over a stacked group
    with one quiescent member, against JAX's vmapped ``fori_loop``s."""
    pairs = [_pair(name, seed) for seed in (21, 22)]
    jc, tc, js, ts = pairs[0][:4]
    jq = type(pairs[0][4])(*(x[:1].repeat(N, 0) for x in pairs[0][4]))
    tq = type(pairs[0][5])(*(x[:1].repeat((N,) + (1,) * (x.dim() - 1)) for x in pairs[0][5]))
    jstack = type(jq)(*(jnp.stack(x) for x in zip(pairs[0][4], pairs[1][4], jq)))
    tstack = type(tq)(*(torch.stack(x) for x in zip(pairs[0][5], pairs[1][5], tq)))
    nbrs = random_regular(N, 3, seed=14)
    for masked in (False, True):
        mask = (np.random.RandomState(15).rand(N, 3) > 0.3) if masked else None
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else torch.as_tensor(mask)
        for n_rounds in (1, 4):
            jout, jch = jf.fused_gossip_rounds_grouped(
                jc, js, jstack, jnp.asarray(nbrs), n_rounds, jm)
            tout, tch = tf.fused_gossip_rounds_grouped(
                tc, ts, tstack, torch.as_tensor(nbrs), n_rounds, tm)
            _same(tout, jout)
            assert tch.tolist() == np.asarray(jch).tolist()
            assert tch.tolist()[-1] is False  # the quiescent member
    masks = _chaos_masks(nbrs, seed=4)
    jout, jres = jf.fused_chaos_rounds_grouped(
        jc, js, jstack, jnp.asarray(nbrs), jnp.asarray(masks))
    tout, tres = tf.fused_chaos_rounds_grouped(
        tc, ts, tstack, torch.as_tensor(nbrs), torch.as_tensor(masks))
    _same(tout, jout)
    assert tres.dtype == torch.int32 and tres.shape == (8, 3)
    assert tres.tolist() == np.asarray(jres).tolist()
    # per member, the grouped window is the per-variable window
    for g in range(3):
        member = type(tstack)(*(x[g] for x in tstack))
        out_g, res_g = tf.fused_chaos_rounds(tc, ts, member, torch.as_tensor(nbrs), masks)
        assert res_g.tolist() == tres[:, g].tolist()
        assert all(torch.equal(a, b[g]) for a, b in zip(out_g, tout))
