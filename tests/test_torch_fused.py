"""The port's fused round loops against ``lasp_tpu.ops.fused``: the
per-block productive counts of ``fused_gossip_rounds_count`` and the
results of ``fused_frontier_rounds`` and ``fused_gossip_rounds``."""

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
