"""The port's gossip kernels (``lasp_tpu_torch.ops.cuda_gossip``) against
the Pallas kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; these tests hold it
bit-for-bit (tolerance zero: every value is a bit or an integer) against
``pallas_gossip_round`` / ``pallas_gossip_round_rows`` in interpret mode
and against the XLA rounds, on the matrices of tests/ops/test_pallas_gossip.py
and tests/ops/test_pallas_rows.py. The kernel-vs-plain cases need the card
and live in tests/test_torch_cuda_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lasp_tpu.mesh import gossip_round as jax_gossip_round
from lasp_tpu.mesh import random_regular
from lasp_tpu.mesh.gossip import gossip_round_rows as jax_rows
from lasp_tpu.mesh.gossip import gossip_round_rows_grouped as jax_rows_grouped
from lasp_tpu.ops import PackedORSet as JPackedORSet
from lasp_tpu.ops import PackedORSetSpec as JPackedSpec
from lasp_tpu.ops.pallas_gossip import (
    flatten_plane,
    pallas_gossip_round,
    pallas_gossip_round_rows,
    pallas_gossip_round_rows_grouped,
    unflatten_plane,
)
from lasp_tpu_torch import bridge_state
from lasp_tpu_torch.lattice import GCounterSpec, GSetSpec, ORSWOTSpec
from lasp_tpu_torch.mesh import gossip as tgossip
from lasp_tpu_torch.ops import cuda_gossip as cg
from lasp_tpu_torch.ops.packed import PackedORSet, PackedORSetSpec
from tests.ops.test_pallas_gossip import seeded_states
from tests.ops.test_pallas_rows import K, N, seeded

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"
_PORT = {
    "gset": ("lasp_gset", lambda s: GSetSpec(n_elems=s.n_elems)),
    "gcounter": ("riak_dt_gcounter", lambda s: GCounterSpec(n_actors=s.n_actors)),
    "packed": ("lasp_orset_packed", lambda s: PackedORSetSpec(
        n_elems=s.n_elems, n_actors=s.n_actors,
        tokens_per_actor=s.tokens_per_actor)),
    "orswot": ("riak_dt_orswot", lambda s: ORSWOTSpec(
        n_elems=s.n_elems, n_actors=s.n_actors)),
}


def leaves_np(state) -> list:
    return [np.asarray(x) for x in state]


def port_state(kind, jspec, jstate, device=CPU):
    name, to_spec = _PORT[kind]
    return bridge_state.from_numpy(name, to_spec(jspec), leaves_np(jstate), device)


def assert_same(port_state_, jax_state) -> None:
    for got, want in zip(bridge_state.to_numpy(port_state_), leaves_np(jax_state)):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


def port_codec(kind):
    from lasp_tpu_torch.lattice import ORSWOT, GCounter, GSet

    return {"gset": GSet, "gcounter": GCounter, "packed": PackedORSet,
            "orswot": ORSWOT}[kind]


# -- K1: dense round ----------------------------------------------------------


def _k1_case(spec, n, k, seed, block):
    states = seeded_states(spec, n)
    nbrs = random_regular(n, k, seed=seed)
    ref = jax_gossip_round(JPackedORSet, spec, states, jnp.asarray(nbrs))
    fe, _d = flatten_plane(states.exists)
    fr, _ = flatten_plane(states.removed)
    oe, orr = pallas_gossip_round(fe, fr, jnp.asarray(nbrs), block=block,
                                  interpret=True)
    pallas = (unflatten_plane(oe, states.exists.shape),
              unflatten_plane(orr, states.removed.shape))
    ex = torch.tensor(np.asarray(states.exists).view(np.int32).reshape(n, -1))
    rm = torch.tensor(np.asarray(states.removed).view(np.int32).reshape(n, -1))
    got = cg.gossip_round_dense(ex, rm, torch.as_tensor(nbrs))
    for g, p, x in zip(got, pallas, ref):
        g = g.numpy().view(np.uint32).reshape(np.asarray(x).shape)
        assert np.array_equal(g, np.asarray(p))
        assert np.array_equal(g, np.asarray(x))


@pytest.mark.parametrize("n,k", [(32, 2), (64, 3)])
def test_dense_plain_matches_pallas_and_xla(n, k):
    _k1_case(JPackedSpec(n_elems=16, n_actors=8, tokens_per_actor=8), n, k, 3, 8)


def test_dense_plain_matches_pallas_at_the_headline_shape():
    """128 elems x 64 actors x 4 tokens = 1,024 words per plane (8 KiB per
    replica over both planes), at 32 replicas."""
    _k1_case(JPackedSpec(n_elems=128, n_actors=64, tokens_per_actor=4), 32, 3, 7, 4)


def test_wrappers_refuse_tensors_off_the_cpu_and_cuda():
    """A tensor that is not on the CPU takes the kernel path, whose checks
    refuse anything but CUDA tensors — never a silent plain fallback."""
    ex = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    nb = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cg.gossip_round_dense(ex, ex, nb)
    with pytest.raises(ValueError, match="CUDA"):
        cg.gossip_round_rows("or", [ex[None]], nb,
                             torch.zeros((1, 2), dtype=torch.int32))


# -- K2 / K3: row-sparse round (K3 is the "orswot" kind) -----------------------


@pytest.mark.parametrize("kind", ("gset", "gcounter", "packed", "orswot"))
@pytest.mark.parametrize("bucket", [5, 16, 33])
def test_rows_plain_matches_pallas_across_codecs_and_buckets(kind, bucket):
    codec, spec, st = seeded(kind)
    nbrs = random_regular(N, K, seed=3)
    rows = np.random.RandomState(bucket).randint(0, N, size=bucket)
    ref = jax_rows(codec, spec, st, jnp.asarray(nbrs), jnp.asarray(rows))
    pal = pallas_gossip_round_rows(codec, spec, st, jnp.asarray(nbrs),
                                   jnp.asarray(rows), interpret=True)
    got_s, got_c = cg.cuda_gossip_round_rows(
        port_codec(kind), None, port_state(kind, spec, st),
        torch.as_tensor(nbrs), torch.as_tensor(rows),
    )
    for want_s, want_c in (ref, pal):
        assert_same(got_s, want_s)
        assert np.array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("kind", ("gset", "packed", "orswot"))
def test_rows_plain_matches_pallas_under_edge_mask(kind):
    codec, spec, st = seeded(kind)
    nbrs = random_regular(N, K, seed=5)
    rng = np.random.RandomState(7)
    mask = rng.rand(N, K) > 0.4
    rows = rng.randint(0, N, size=12)
    ref = jax_rows(codec, spec, st, jnp.asarray(nbrs), jnp.asarray(rows),
                   jnp.asarray(mask))
    pal = pallas_gossip_round_rows(codec, spec, st, jnp.asarray(nbrs),
                                   jnp.asarray(rows), jnp.asarray(mask),
                                   interpret=True)
    got_s, got_c = cg.cuda_gossip_round_rows(
        port_codec(kind), None, port_state(kind, spec, st),
        torch.as_tensor(nbrs), torch.as_tensor(rows), torch.as_tensor(mask),
    )
    for want_s, want_c in (ref, pal):
        assert_same(got_s, want_s)
        assert np.array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("kind", ("gset", "gcounter", "packed", "orswot"))
def test_grouped_plain_matches_pallas_with_valid_masks(kind):
    """G=3: a dense member, a pad tail, a fully invalid (quiescent) member."""
    codec, spec, st = seeded(kind)
    g, f = 3, 10
    stacked = jax.tree_util.tree_map(lambda x: jnp.stack([x, x[::-1], x]), st)
    nbrs = random_regular(N, K, seed=9)
    rows = np.random.RandomState(11).randint(0, N, size=(g, f))
    valid = np.stack([np.ones(f, bool), np.arange(f) < 4, np.zeros(f, bool)])
    args = (jnp.asarray(nbrs), jnp.asarray(rows), jnp.asarray(valid))
    ref = jax_rows_grouped(codec, spec, stacked, *args)
    pal = pallas_gossip_round_rows_grouped(codec, spec, stacked, *args,
                                           interpret=True)
    got_s, got_c = cg.cuda_gossip_round_rows_grouped(
        port_codec(kind), None, port_state(kind, spec, stacked),
        torch.as_tensor(nbrs), torch.as_tensor(rows), torch.as_tensor(valid),
    )
    for want_s, want_c in (ref, pal):
        assert_same(got_s, want_s)
        assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert not got_c[2].any()


def test_grouped_plain_matches_pallas_with_edge_mask_and_duplicates():
    codec, spec, st = seeded("gcounter")
    stacked = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), st)
    nbrs = random_regular(N, K, seed=13)
    mask = np.random.RandomState(17).rand(N, K) > 0.3
    rows = np.asarray([[1, 1, 4, 9, 9, 9, 20, 33]] * 2)
    valid = np.asarray([[True] * 8, [True, True, True, False] + [False] * 4])
    args = (jnp.asarray(nbrs), jnp.asarray(rows), jnp.asarray(valid),
            jnp.asarray(mask))
    ref = jax_rows_grouped(codec, spec, stacked, *args)
    pal = pallas_gossip_round_rows_grouped(codec, spec, stacked, *args,
                                           interpret=True)
    got_s, got_c = cg.cuda_gossip_round_rows_grouped(
        port_codec("gcounter"), None, port_state("gcounter", spec, stacked),
        torch.as_tensor(nbrs), torch.as_tensor(rows), torch.as_tensor(valid),
        torch.as_tensor(mask),
    )
    for want_s, want_c in (ref, pal):
        assert_same(got_s, want_s)
        assert np.array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("kind", ("gset", "gcounter", "packed", "orswot"))
def test_rows_wrappers_take_int64_and_int32_rows(kind):
    """K2's and K3's wrappers take the runtime's int64 rows and a caller's
    int32 rows as they are, and return bool changed flags: either dtype
    gives Pallas's joined rows and flags, under an edge mask."""
    codec, spec, st = seeded(kind)
    stacked = jax.tree_util.tree_map(lambda x: jnp.stack([x, x[::-1]]), st)
    nbrs = random_regular(N, K, seed=41)
    rng = np.random.RandomState(43)
    rows = rng.randint(0, N, size=(2, 12))
    mask = rng.rand(N, K) > 0.3
    valid = np.ones(rows.shape, bool)
    pal_s, pal_c = pallas_gossip_round_rows_grouped(
        codec, spec, stacked, jnp.asarray(nbrs), jnp.asarray(rows),
        jnp.asarray(valid), jnp.asarray(mask), interpret=True)
    state = port_state(kind, spec, stacked)
    plan = cg.rows_plan_of(port_codec(kind), None, state)
    for dtype in (torch.int64, torch.int32):
        idx = torch.as_tensor(rows, dtype=dtype)
        joined, changed = cg.rows_round(plan, list(state), torch.as_tensor(nbrs),
                                        idx, torch.as_tensor(mask))
        assert changed.dtype == torch.bool
        assert np.array_equal(changed.numpy(), np.asarray(pal_c))
        assert_same(type(state)(*(cg.scatter_rows(leaf, idx, j)
                                  for leaf, j in zip(state, joined))), pal_s)


def test_raw_changed_flag_equals_codec_equal_on_packed():
    """K2's changed flag is a raw leaf inequality; the contract
    (``mesh.gossip.gossip_round_rows``) uses ``~codec.equal`` with the
    removed plane masked by exists. They agree on reachable states, round
    after round."""
    _codec, spec, st = seeded("packed")
    pspec = _PORT["packed"][1](spec)
    state = port_state("packed", spec, st)
    nbrs = torch.as_tensor(random_regular(N, K, seed=19))
    rng = np.random.RandomState(23)
    for _ in range(4):
        assert not bool(((state.removed & ~state.exists) != 0).any())
        rows = torch.as_tensor(rng.randint(0, N, size=16))
        a, ca = cg.cuda_gossip_round_rows(PackedORSet, pspec, state, nbrs, rows)
        b, cb = tgossip.gossip_round_rows(PackedORSet, pspec, state, nbrs, rows)
        assert torch.equal(ca, cb)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        state = tgossip.gossip_round(PackedORSet, pspec, state, nbrs)


def test_vclock_grouped_plain_matches_pallas_with_edge_mask_and_duplicates():
    """K3's plain version, grouped, under an edge mask with duplicate row
    slots and a member whose slots are all invalid."""
    codec, spec, st = seeded("orswot")
    stacked = jax.tree_util.tree_map(lambda x: jnp.stack([x, x[::-1], x]), st)
    nbrs = random_regular(N, K, seed=13)
    mask = np.random.RandomState(17).rand(N, K) > 0.3
    rows = np.asarray([[1, 1, 4, 9, 9, 9, 20, 33]] * 3)
    valid = np.asarray([[True] * 8, [True, True, True, False] + [False] * 4,
                        [False] * 8])
    args = (jnp.asarray(nbrs), jnp.asarray(rows), jnp.asarray(valid),
            jnp.asarray(mask))
    ref = jax_rows_grouped(codec, spec, stacked, *args)
    pal = pallas_gossip_round_rows_grouped(codec, spec, stacked, *args,
                                           interpret=True)
    got_s, got_c = cg.cuda_gossip_round_rows_grouped(
        port_codec("orswot"), None, port_state("orswot", spec, stacked),
        torch.as_tensor(nbrs), torch.as_tensor(rows), torch.as_tensor(valid),
        torch.as_tensor(mask),
    )
    for want_s, want_c in (ref, pal):
        assert_same(got_s, want_s)
        assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert not got_c[2].any()


def test_vclock_plain_skip_equals_substitution_round_after_round():
    """K3 skips dead edges; the contract round (``mesh.gossip``'s, with the
    codec's merge) substitutes the own state. On states built by add /
    remove / merge they agree, states and changed flags, as the
    population gossips under a mask."""
    from lasp_tpu_torch.lattice import ORSWOT

    _codec, spec, st = seeded("orswot")
    pspec = _PORT["orswot"][1](spec)
    state = port_state("orswot", spec, st)
    nbrs = torch.as_tensor(random_regular(N, K, seed=19))
    rng = np.random.RandomState(29)
    mask = torch.as_tensor(rng.rand(N, K) > 0.35)
    for _ in range(5):
        rows = torch.as_tensor(rng.randint(0, N, size=16))
        a, ca = cg.cuda_gossip_round_rows(ORSWOT, pspec, state, nbrs, rows, mask)
        b, cb = tgossip.gossip_round_rows(ORSWOT, pspec, state, nbrs, rows, mask)
        assert torch.equal(ca, cb)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert torch.equal(ca, ~ORSWOT.equal(pspec, *(
            type(state)(*(x[rows] for x in s)) for s in (state, a))))
        state = tgossip.gossip_round(ORSWOT, pspec, state, nbrs, mask)


def test_member_lists_match_stacked_leaves():
    """K2 and K3 take a leaf as one [G, R, ...] tensor or as its G member
    tensors; both give the same joined rows and changed flags, and the
    member scatter writes each member in place."""
    rng = np.random.RandomState(31)
    nbrs = torch.as_tensor(random_regular(N, K, seed=37))
    rows = torch.as_tensor(rng.randint(0, N, size=(3, 9)))
    mask = torch.as_tensor(rng.rand(N, K) > 0.3)
    for kind in ("gcounter", "orswot"):
        _codec, spec, st = seeded(kind)
        stacked = port_state(kind, spec, jax.tree_util.tree_map(
            lambda x: jnp.stack([x, x[::-1], x]), st))
        plan = cg.rows_plan_of(port_codec(kind), None, stacked)
        members = [[x.clone() for x in leaf.unbind(0)] for leaf in stacked]
        want, want_c = cg.rows_round(plan, list(stacked), nbrs, rows, mask)
        got, got_c = cg.rows_round(plan, members, nbrs, rows, mask)
        assert torch.equal(got_c, want_c)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        for leaf, ms, j in zip(stacked, members, got):
            before = [m.data_ptr() for m in ms]
            cg.scatter_rows(ms, rows, j)
            assert [m.data_ptr() for m in ms] == before
            assert torch.equal(torch.stack(ms), cg.scatter_rows(leaf, rows, j))
