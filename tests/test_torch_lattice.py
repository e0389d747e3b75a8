"""The port's lattice codecs against ``lasp_tpu``'s on seeded random
states: every contract function (merge / equal / value / is_inflation /
is_strict_inflation / threshold_met), the update ops, and the packed and
flat OR-Set conversions. Inputs are made with numpy and handed to both
packages; the tolerance is zero (bits and integers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasp_tpu.lattice as jl
import lasp_tpu.ops as jops
import lasp_tpu_torch.lattice as tl
import lasp_tpu_torch.ops as tops
from lasp_tpu_torch import bridge_state

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)

R = 64


def _orset_planes(rng, e, t, r=R):
    exists = rng.rand(r, e, t) < 0.4
    removed = exists & (rng.rand(r, e, t) < 0.3)
    return exists, removed


def _grow(rng, a, kind):
    """A partner population for ``a``: some rows equal, some grown, some
    unrelated — so equal / inflation / strict inflation all go both ways."""
    pick = rng.randint(0, 3, size=R)
    out = []
    for leaf in a:
        b = leaf.copy()
        rnd = kind(leaf.shape)
        grown = (leaf | rnd) if leaf.dtype == bool else np.maximum(leaf, rnd)
        sel = pick.reshape((R,) + (1,) * (leaf.ndim - 1))
        b = np.where(sel == 1, grown, np.where(sel == 2, rnd, b))
        out.append(b.astype(leaf.dtype))
    return out


CASES = {}


def _case(name):
    def deco(fn):
        CASES[name] = fn
        return fn
    return deco


@_case("lasp_gset")
def _gset(rng):
    js, ts = jl.GSetSpec(n_elems=12), tl.GSetSpec(n_elems=12)
    a = [rng.rand(R, 12) < 0.3]
    b = _grow(rng, a, lambda s: rng.rand(*s) < 0.2)
    return jl.GSet, tl.GSet, js, ts, a, b


@_case("riak_dt_gcounter")
def _gcounter(rng):
    js, ts = jl.GCounterSpec(n_actors=6), tl.GCounterSpec(n_actors=6)
    a = [rng.randint(0, 5, size=(R, 6)).astype(np.int32)]
    b = _grow(rng, a, lambda s: rng.randint(0, 6, size=s).astype(np.int32))
    return jl.GCounter, tl.GCounter, js, ts, a, b


@_case("lasp_ivar")
def _ivar(rng):
    js, ts = jl.IVarSpec(), tl.IVarSpec()
    a = [rng.rand(R) < 0.5, rng.randint(0, 3, size=R).astype(np.int32)]
    b = [rng.rand(R) < 0.5, rng.randint(0, 3, size=R).astype(np.int32)]
    b[1] = np.where(rng.rand(R) < 0.5, a[1], b[1])
    return jl.IVar, tl.IVar, js, ts, a, b


@_case("lasp_orset")
def _orset(rng):
    js = jl.ORSetSpec(n_elems=6, n_actors=3, tokens_per_actor=2)
    ts = tl.ORSetSpec(n_elems=6, n_actors=3, tokens_per_actor=2)
    a = list(_orset_planes(rng, 6, 6))
    b = _grow(rng, a, lambda s: rng.rand(*s) < 0.2)
    # tombstone bits outside exists: equal must mask them out
    b[1] = b[1] | (rng.rand(R, 6, 6) < 0.05)
    return jl.ORSet, tl.ORSet, js, ts, a, b


@_case("lasp_orset_packed")
def _packed(rng):
    js = jops.PackedORSetSpec(n_elems=5, n_actors=3, tokens_per_actor=16)
    ts = tops.PackedORSetSpec(n_elems=5, n_actors=3, tokens_per_actor=16)

    def pack(planes):
        st = jops.pack_orset(js, jl.ORSetState(*map(jnp.asarray, planes)))
        return [np.asarray(x) for x in st]

    a = pack(_orset_planes(rng, 5, 48))
    b = pack(_grow(rng, list(_orset_planes(rng, 5, 48)),
                   lambda s: rng.rand(*s) < 0.2))
    b = [np.where(rng.rand(R, 1, 1) < 0.3, x, y) for x, y in zip(a, b)]
    return jops.PackedORSet, tops.PackedORSet, js, ts, a, b


@_case("lasp_orset_flat")
def _flat(rng):
    dj = jl.ORSetSpec(n_elems=5, n_actors=3, tokens_per_actor=2)
    js = jops.FlatORSetSpec(dense=dj)
    ts = tops.FlatORSetSpec(dense=tl.ORSetSpec(n_elems=5, n_actors=3,
                                               tokens_per_actor=2))

    def pack(planes):
        st = jops.FlatORSet.pack(js, jl.ORSetState(*map(jnp.asarray, planes)))
        return [np.asarray(x) for x in st]

    a = pack(_orset_planes(rng, 5, 6))
    b = pack(_orset_planes(rng, 5, 6))
    b = [np.where(rng.rand(R, 1) < 0.3, x, y) for x, y in zip(a, b)]
    return jops.FlatORSet, tops.FlatORSet, js, ts, a, b


def _orswot_ops(rng, clock, dots, n_ops):
    """Apply ``n_ops`` rounds of random OR-SWOT adds (each row's own actor
    lane bumped, the element's dots replaced by the fresh dot) and removes
    to every row: states a replica can reach."""
    clock, dots = clock.copy(), dots.copy()
    r, e, a = dots.shape
    idx = np.arange(r)
    for _ in range(n_ops):
        el, ac = rng.randint(0, e, size=r), rng.randint(0, a, size=r)
        add = rng.rand(r) >= 0.3
        ia, ea, aa = idx[add], el[add], ac[add]
        clock[ia, aa] += 1
        dots[ia, ea, :] = 0
        dots[ia, ea, aa] = clock[ia, aa]
        dots[idx[~add], el[~add], :] = 0
    return clock, dots


def _orswot_reachable(rng, e, a, n_ops, r=R):
    zero = (np.zeros((r, a), np.int32), np.zeros((r, e, a), np.int32))
    return _orswot_ops(rng, *zero, n_ops)


@_case("riak_dt_orswot")
def _orswot(rng):
    js = jl.ORSWOTSpec(n_elems=7, n_actors=4)
    ts = tl.ORSWOTSpec(n_elems=7, n_actors=4)
    a = list(_orswot_reachable(rng, 7, 4, 6))
    grown = _orswot_ops(rng, *a, 3)
    other = _orswot_reachable(rng, 7, 4, 5)
    pick = rng.randint(0, 3, size=R)
    b = [np.where(pick.reshape((R,) + (1,) * (x.ndim - 1)) == 1, g,
                  np.where(pick.reshape((R,) + (1,) * (x.ndim - 1)) == 2, o, x))
         for x, g, o in zip(a, grown, other)]
    return jl.ORSWOT, tl.ORSWOT, js, ts, a, b


def _vmap(fn, *states):
    return jax.vmap(fn)(*states)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _leaves_equal(port_state, jax_state):
    got = bridge_state.to_numpy(port_state) if isinstance(port_state, tuple) \
        else (_np(port_state),)
    want = [np.asarray(x) for x in jax_state] if isinstance(jax_state, tuple) \
        else [np.asarray(jax_state)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_contract_functions_match_jax(name):
    rng = np.random.RandomState(sorted(CASES).index(name) + 11)
    jc, tc, js, ts, a, b = CASES[name](rng)
    ja = type(jc.new(js))(*map(jnp.asarray, a))
    jb = type(jc.new(js))(*map(jnp.asarray, b))
    ta = bridge_state.from_numpy(name, ts, a, device="cpu")
    tb = bridge_state.from_numpy(name, ts, b, device="cpu")

    _leaves_equal(tc.merge(ts, ta, tb), _vmap(lambda x, y: jc.merge(js, x, y), ja, jb))
    for fn in ("equal", "is_inflation", "is_strict_inflation"):
        got = getattr(tc, fn)(ts, ta, tb)
        want = _vmap(lambda x, y, f=fn: getattr(jc, f)(js, x, y), ja, jb)
        assert np.array_equal(_np(got), np.asarray(want)), fn
        assert _np(got).any() or fn != "is_inflation"
    got_v = tc.value(ts, ta)
    want_v = _vmap(lambda x: jc.value(js, x), ja)
    _leaves_equal(got_v, want_v)
    # thresholds: each row's own partner state (or numeric bound)
    for strict in (False, True) if hasattr(jc, "threshold_met") else ():
        if name == "riak_dt_gcounter":
            for thr in (0, 7, 12):
                got = tc.threshold_met(ts, ta, tl.Threshold(thr, strict))
                want = _vmap(lambda x: jc.threshold_met(
                    js, x, jl.Threshold(thr, strict)), ja)
                assert np.array_equal(_np(got), np.asarray(want))
            continue
        got = tc.threshold_met(ts, ta, tl.Threshold(tb, strict))
        want = _vmap(lambda x, y: jc.threshold_met(
            js, x, jl.Threshold(y, strict)), ja, jb)
        assert np.array_equal(_np(got), np.asarray(want)), strict


@pytest.mark.parametrize("name", sorted(CASES))
def test_new_is_the_same_bottom(name):
    jc, tc, js, ts, _a, _b = CASES[name](np.random.RandomState(0))
    _leaves_equal(tc.new(ts, device="cpu"), jc.new(js))


def test_pack_unpack_round_trips_match_jax():
    rng = np.random.RandomState(5)
    djs = jl.ORSetSpec(n_elems=7, n_actors=5, tokens_per_actor=9)  # T=45
    dts = tl.ORSetSpec(n_elems=7, n_actors=5, tokens_per_actor=9)
    planes = _orset_planes(rng, 7, 45)
    jdense = jl.ORSetState(*map(jnp.asarray, planes))
    tdense = tl.ORSetState(*map(torch.as_tensor, planes))
    pjs = jops.PackedORSetSpec(n_elems=7, n_actors=5, tokens_per_actor=9)
    pts = tops.PackedORSetSpec(n_elems=7, n_actors=5, tokens_per_actor=9)
    tpacked = tops.pack_orset(pts, tdense)
    _leaves_equal(tpacked, jops.pack_orset(pjs, jdense))
    back = tops.unpack_orset(pts, tpacked)
    _leaves_equal(back, jops.unpack_orset(pjs, jops.pack_orset(pjs, jdense)))
    assert torch.equal(back.exists, tdense.exists)
    assert torch.equal(back.removed, tdense.removed & tdense.exists)
    fjs, fts = jops.FlatORSetSpec(dense=djs), tops.FlatORSetSpec(dense=dts)
    tflat = tops.FlatORSet.pack(fts, tdense)
    _leaves_equal(tflat, jops.FlatORSet.pack(fjs, jdense))
    fback = tops.FlatORSet.unpack(fts, tflat)
    assert torch.equal(fback.exists, tdense.exists)
    assert torch.equal(fback.removed, tdense.removed & tdense.exists)
    # the sign bit survives the int32 storage
    assert (tpacked.exists < 0).any()


def test_packed_update_ops_match_jax():
    rng = np.random.RandomState(9)
    js = jops.PackedORSetSpec(n_elems=6, n_actors=4, tokens_per_actor=12)
    ts = tops.PackedORSetSpec(n_elems=6, n_actors=4, tokens_per_actor=12)
    jst = jl.replicate(jops.PackedORSet.new(js), R)
    tst = tl.replicate(tops.PackedORSet.new(ts, device="cpu"), R)
    for step in range(30):  # pools fill up: exhausted adds are no-ops
        e = rng.randint(0, 6, size=R)
        a = rng.randint(0, 4, size=R)
        jst = jax.vmap(lambda i, j, s: jops.PackedORSet.add(js, s, i, j))(
            jnp.asarray(e), jnp.asarray(a), jst)
        tst = tops.PackedORSet.add(ts, tst, torch.as_tensor(e), torch.as_tensor(a))
        if step % 4 == 3:
            jst = jax.vmap(lambda i, s: jops.PackedORSet.remove(js, s, i))(
                jnp.asarray(e), jst)
            tst = tops.PackedORSet.remove(ts, tst, torch.as_tensor(e))
        if step % 7 == 6:
            t = rng.randint(0, 48, size=R)
            jst = jax.vmap(lambda i, k, s: jops.PackedORSet.add_by_token(
                js, s, i, k))(jnp.asarray(e), jnp.asarray(t), jst)
            tst = tops.PackedORSet.add_by_token(
                ts, tst, torch.as_tensor(e), torch.as_tensor(t))
        _leaves_equal(tst, jst)
    row = type(tst)(*(x[0] for x in tst))
    jrow = type(jst)(*(x[0] for x in jst))
    for e in range(6):
        for a in range(4):
            assert bool(tops.PackedORSet.add_exhausted(ts, row, e, a)) == bool(
                jops.PackedORSet.add_exhausted(js, jrow, e, a))


def test_scalar_update_ops_match_jax():
    rng = np.random.RandomState(4)
    ojs = jl.ORSetSpec(n_elems=4, n_actors=3, tokens_per_actor=2)
    ots = tl.ORSetSpec(n_elems=4, n_actors=3, tokens_per_actor=2)
    jo, to = jl.ORSet.new(ojs), tl.ORSet.new(ots, device="cpu")
    gjs, gts = jl.GCounterSpec(n_actors=3), tl.GCounterSpec(n_actors=3)
    jg, tg = jl.GCounter.new(gjs), tl.GCounter.new(gts, device="cpu")
    sjs, sts = jl.GSetSpec(n_elems=5), tl.GSetSpec(n_elems=5)
    jset, tset = jl.GSet.new(sjs), tl.GSet.new(sts, device="cpu")
    ji, ti = jl.IVar.new(jl.IVarSpec()), tl.IVar.new(tl.IVarSpec(), device="cpu")
    for _ in range(25):
        e, a = int(rng.randint(4)), int(rng.randint(3))
        jo, to = jl.ORSet.add(ojs, jo, e, a), tl.ORSet.add(ots, to, e, a)
        if rng.rand() < 0.3:
            jo, to = jl.ORSet.remove(ojs, jo, e), tl.ORSet.remove(ots, to, e)
        if rng.rand() < 0.2:
            t = int(rng.randint(6))
            jo = jl.ORSet.add_by_token(ojs, jo, e, t)
            to = tl.ORSet.add_by_token(ots, to, e, t)
        assert bool(tl.ORSet.add_exhausted(ots, to, e, a)) == bool(
            jl.ORSet.add_exhausted(ojs, jo, e, a))
        jg, tg = jl.GCounter.increment(gjs, jg, a, e + 1), tl.GCounter.increment(
            gts, tg, a, e + 1)
        jset, tset = jl.GSet.add(sjs, jset, e), tl.GSet.add(sts, tset, e)
        p = int(rng.randint(3))
        ji, ti = jl.IVar.set(jl.IVarSpec(), ji, p), tl.IVar.set(tl.IVarSpec(), ti, p)
        _leaves_equal(to, jo)
        _leaves_equal(tg, jg)
        _leaves_equal(tset, jset)
        _leaves_equal(ti, ji)
    assert tl.ORSet.stats(ots, to) == jl.ORSet.stats(ojs, jo)


def test_flat_scatter_tokens_matches_jax():
    rng = np.random.RandomState(2)
    dj = jl.ORSetSpec(n_elems=6, n_actors=4, tokens_per_actor=4)
    dt = tl.ORSetSpec(n_elems=6, n_actors=4, tokens_per_actor=4)
    js, ts = jops.FlatORSetSpec(dense=dj), tops.FlatORSetSpec(dense=dt)
    flat = np.unique(rng.randint(0, R * 6 * 16, size=300))
    rows, rest = np.divmod(flat, 6 * 16)
    elems, toks = np.divmod(rest, 16)
    jst = jl.replicate(jops.FlatORSet.new(js), R)
    tst = tl.replicate(tops.FlatORSet.new(ts, device="cpu"), R)
    jst = jops.FlatORSet.scatter_tokens(js, jst, jnp.asarray(rows),
                                        jnp.asarray(elems), jnp.asarray(toks))
    tst = tops.FlatORSet.scatter_tokens(ts, tst, rows, elems, toks)
    _leaves_equal(tst, jst)


def test_orswot_ops_and_stats_match_jax():
    """``add`` / ``remove`` / ``value`` / ``member_mask`` / ``stats`` one op
    at a time, and ``merge`` of the evolving state with a second replica's."""
    rng = np.random.RandomState(12)
    js, ts = jl.ORSWOTSpec(n_elems=5, n_actors=3), tl.ORSWOTSpec(n_elems=5, n_actors=3)
    jo, to = jl.ORSWOT.new(js), tl.ORSWOT.new(ts, device="cpu")
    jp, tp = jl.ORSWOT.new(js), tl.ORSWOT.new(ts, device="cpu")
    for step in range(40):
        e, a = int(rng.randint(5)), int(rng.randint(3))
        if rng.rand() < 0.3:
            jo, to = jl.ORSWOT.remove(js, jo, e), tl.ORSWOT.remove(ts, to, e)
        else:
            jo, to = jl.ORSWOT.add(js, jo, e, a), tl.ORSWOT.add(ts, to, e, a)
        jp, tp = jl.ORSWOT.add(js, jp, (e + 1) % 5, 2), tl.ORSWOT.add(ts, tp, (e + 1) % 5, 2)
        if step % 5 == 4:
            jo, to = jl.ORSWOT.merge(js, jo, jp), tl.ORSWOT.merge(ts, to, tp)
        _leaves_equal(to, jo)
        for fn in ("value", "member_mask"):
            assert np.array_equal(getattr(tl.ORSWOT, fn)(ts, to).numpy(),
                                  np.asarray(getattr(jl.ORSWOT, fn)(js, jo)))
        assert tl.ORSWOT.stats(ts, to) == jl.ORSWOT.stats(js, jo)
    assert tl.ORSWOT.name == jl.ORSWOT.name == "riak_dt_orswot"
    assert tl.get_type("riak_dt_orswot") is tl.ORSWOT


def test_dots_helpers_match_jax():
    import lasp_tpu.lattice.dots as jd
    import lasp_tpu_torch.lattice.dots as td

    rng = np.random.RandomState(21)
    ca, da = _orswot_reachable(rng, 6, 5, 5)
    cb, db = _orswot_ops(rng, ca, da, 2)
    cb[::3], db[::3] = _orswot_reachable(rng, 6, 5, 4)[0][::3], _orswot_reachable(
        rng, 6, 5, 4)[1][::3]
    j = [jnp.asarray(x) for x in (ca, da, cb, db)]
    t = [torch.as_tensor(x) for x in (ca, da, cb, db)]
    got = td.merge_dots(*t)
    want = jax.vmap(jd.merge_dots)(*j)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(td.clock_inflation(t[0], t[2]).numpy(),
                          np.asarray(jax.vmap(jd.clock_inflation)(j[0], j[2])))
    assert np.array_equal(
        td.strict_clock_inflation(*t).numpy(),
        np.asarray(jax.vmap(jd.strict_clock_inflation)(*j)),
    )
    for e, a in ((0, 0), (5, 4), (2, 1)):
        got = td.mint_dot(t[0][3], t[1][3], e, a)
        want = jd.mint_dot(j[0][3], j[1][3], e, a)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(t[0][3].numpy(), ca[3])  # mint_dot copies


@pytest.mark.parametrize("name", ["riak_dt_orswot", "riak_dt_gcounter", "lasp_orset_packed"])
def test_bridge_state_round_trips(name):
    """numpy -> port -> numpy gives back the same leaves, dtypes included,
    with leading replica and group dims, and a wrong trailing shape is
    refused."""
    _jc, _tc, _js, ts, a, _b = CASES[name](np.random.RandomState(3))
    for leaves in (a, [np.stack([x, x[::-1]]) for x in a]):
        back = bridge_state.to_numpy(bridge_state.from_numpy(name, ts, leaves, device="cpu"))
        for got, want in zip(back, leaves):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="trailing shape"):
        bridge_state.from_numpy(name, ts, [x[..., :1] for x in a], device="cpu")
