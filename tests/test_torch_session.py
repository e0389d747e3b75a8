"""The port's ``Session`` (``lasp_tpu_torch.api``) against the JAX package's:
twins of ``tests/api/test_session.py`` run through both packages with equal
values, and one verb sequence — declare, combinators, updates,
``replicate`` onto 64 replicas, writes, convergence, ``nemesis``,
``quorum``, ``aae``, ``serve``, programs — whose replicated states
(``bridge_state.to_numpy``) and per-round residuals must be equal."""

import warnings

import numpy as np
import pytest
import torch

import lasp_tpu
import lasp_tpu.api.session as jsession_mod
import lasp_tpu_torch
import lasp_tpu_torch.api.session as tsession_mod
from lasp_tpu.lattice import GSet as JGSet
from lasp_tpu.lattice import GSetSpec as JGSetSpec
from lasp_tpu.lattice import Threshold as JThreshold
from lasp_tpu_torch.bridge_state import to_numpy
from lasp_tpu_torch.lattice import GSet, GSetSpec, Threshold

torch.set_num_threads(1)

JSession, TSession = lasp_tpu.Session, lasp_tpu_torch.Session


def _sessions(**kw):
    return JSession(**kw), TSession(device="cpu", **kw)


def test_ivar_bind_and_read():
    for s, thr in zip(_sessions(), (JThreshold, Threshold)):
        v = s.declare("lasp_ivar")
        w = s.read(v, thr(None, strict=True))
        assert not w.done
        s.update(v, ("set", 42), "actor")
        assert w.done
        assert s.value(v) == 42
        s.update(v, ("set", 42), "actor")
        assert s.value(v) == 42
        s.update(v, ("set", 99), "actor")
        assert s.value(v) == 42


def test_ivar_dataflow_chain():
    for s in _sessions():
        i1, i2, i3 = (s.declare("lasp_ivar") for _ in range(3))
        s.bind_to(i2, i1)
        s.bind_to(i3, i2)
        s.update(i1, ("set", "hello"), "a")
        assert s.value(i3) == "hello"


def test_wait_needed_fires_on_reader():
    for s, thr in zip(_sessions(), (JThreshold, Threshold)):
        v = s.declare("lasp_ivar")
        wn = s.wait_needed(v)
        assert not wn.done
        s.read(v, thr(None, strict=True))
        assert wn.done


def test_read_any_first_match():
    for s, codec, spec, thr in zip(_sessions(), (JGSet, GSet),
                                   (JGSetSpec, GSetSpec), (JThreshold, Threshold)):
        a = s.declare("lasp_gset", n_elems=4)
        b = s.declare("lasp_gset", n_elems=4)
        bottom = codec.new(spec(n_elems=4)) if codec is JGSet else codec.new(
            spec(n_elems=4), device="cpu")
        t = thr(bottom, strict=True)
        w = s.read_any([(a, t), (b, t)])
        assert not w.done
        s.update(b, ("add", "x"), "actor")
        assert w.done and w.result[0] == b


def test_monotonic_threshold_read():
    for s, thr in zip(_sessions(), (JThreshold, Threshold)):
        c = s.declare("riak_dt_gcounter")
        w5 = s.read(c, thr(5))
        for i in range(4):
            s.update(c, ("increment",), f"client{i}")
        assert not w5.done
        s.update(c, ("increment", 2), "client4")
        assert w5.done and s.value(c) == 6


def test_combinator_verbs_roundtrip():
    got = []
    for s in _sessions():
        src = s.declare("lasp_orset", n_elems=8)
        s.update(src, ("add_all", [1, 2, 3, 4]), "a")
        doubled = s.map(src, lambda x: x * 2)
        evens = s.filter(src, lambda x: x % 2 == 0)
        other = s.declare("lasp_orset", n_elems=8)
        s.update(other, ("add_all", [3, 4, 5]), "a")
        got.append((s.value(doubled), s.value(evens),
                    s.value(s.union(src, other)),
                    s.value(s.intersection(src, other))))
    assert got[0] == got[1] == (frozenset({2, 4, 6, 8}), frozenset({2, 4}),
                                frozenset({1, 2, 3, 4, 5}), frozenset({3, 4}))


def test_program_registration_and_execute():
    from lasp_tpu.programs import ExampleKeylistProgram as JKeys
    from lasp_tpu.programs import ExampleProgram as JExample
    from lasp_tpu_torch.programs import ExampleKeylistProgram as TKeys
    from lasp_tpu_torch.programs import ExampleProgram as TExample

    got = []
    for s, ex, keys in zip(_sessions(), (JExample, TExample), (JKeys, TKeys)):
        s.register("example", ex, n_elems=16)
        s.register("keylist", keys, n_elems=16)
        s.register("example", ex)
        s.process(("k1", "v1"), "put", "actor1")
        s.process(("k2", "v2"), "put", "actor2")
        got.append((s.execute("example"), s.execute("keylist")))
    assert got[0] == got[1] == (frozenset({("k1", "v1"), ("k2", "v2")}),
                                frozenset({"k1", "k2"}))


def test_thread_runs_function():
    for s in _sessions():
        v = s.declare("lasp_gset", n_elems=4)
        s.thread(lambda: s.update(v, ("add", "t"), "thread"))
        assert s.value(v) == frozenset({"t"})


def test_session_replicate_on_ramp():
    got = []
    for s, thr in zip(_sessions(n_actors=8), (JThreshold, Threshold)):
        v = s.declare("lasp_orset", n_elems=8)
        out = s.map(v, lambda x: x.upper())
        s.update(v, ("add", "a"), actor="w")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            rt = s.replicate(64, topology="random", fanout=3, seed=3)
        assert rt.replica_value(out, 63) == {"A"}
        assert rt.replica_value(v, 63) == {"a"}
        rt.update_at(5, v, ("add", "b"), "w5")
        rounds = rt.run_to_convergence(max_rounds=32)
        assert rt.divergence(v) == 0
        row = rt.read_until(60, v, thr(rt.read_at(5, v)), max_rounds=32)
        assert row is not None
        got.append((rounds, rt.coverage_value(out)))
    assert got[0] == got[1] and got[1][1] == {"A", "B"}


def test_session_replicate_rejects_unknown_topology():
    s = TSession(device="cpu")
    s.declare("lasp_gset", n_elems=4)
    with pytest.raises(ValueError, match="unknown topology"):
        s.replicate(8, topology="hypercube")


def test_replicate_locality_ordering():
    from lasp_tpu.mesh.topology import locality_order, scale_free

    perm_ref, nn_ref = locality_order(scale_free(64, 3, seed=3))
    s = TSession(n_actors=4, device="cpu")
    v = s.declare("lasp_gset", n_elems=4)
    s.update(v, ("add", "x"), actor="w")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        rt = s.replicate(64, topology="scale_free", seed=3)
    assert rt.locality_perm is not None
    assert np.array_equal(rt.neighbors.cpu().numpy(), nn_ref)
    assert np.array_equal(rt.locality_perm, perm_ref)
    rt.run_to_convergence(max_rounds=64)
    assert rt.coverage_value(v) == frozenset({"x"})
    s2 = TSession(n_actors=4, device="cpu")
    s2.declare("lasp_gset", n_elems=4)
    assert s2.replicate(16, topology="ring").locality_perm is None
    assert s2.replicate(16, topology="scale_free", locality=False).locality_perm is None


def test_locality_reorder_note_emitted_once():
    from lasp_tpu_torch.mesh import ring

    tsession_mod._locality_note_emitted = False
    s = TSession(n_actors=4, device="cpu")
    s.declare("lasp_gset", n_elems=4)
    with pytest.warns(UserWarning, match="locality_perm"):
        rt = s.replicate(16, topology="scale_free", fanout=3, seed=1)
    assert rt.locality_perm is not None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s.replicate(16, topology="random", fanout=3, seed=2)
    tsession_mod._locality_note_emitted = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s.replicate(16, topology="ring")
        s.replicate(16, topology="scale_free", locality=False)
        s.replicate(16, neighbors=ring(16, 2))
    # the flag is the port's own: JAX's note is untouched by the port's
    assert jsession_mod is not tsession_mod


def test_session_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSession()


def _verb_sequence(pkg):
    """One session driven through every verb; returns what both packages
    must agree on."""
    if pkg == "jax":
        from lasp_tpu.programs import ExampleKeylistProgram as Keys

        s = JSession(n_actors=16)
    else:
        from lasp_tpu_torch.programs import ExampleKeylistProgram as Keys

        s = TSession(n_actors=16, device="cpu")
    src = s.declare("lasp_orset", id="src", n_elems=16)
    cnt = s.declare("riak_dt_gcounter", id="cnt")
    s.map(src, lambda x: x + "!", dst="seen")
    s.update(src, ("add_all", ["a", "b"]), "w0")
    s.update(cnt, ("increment", 3), "w0")
    s.register("keys", Keys, n_elems=8)
    s.process(("k1", 1), "put", "w0")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        rt = s.replicate(64, topology="random", fanout=3, seed=5)
    rt.update_batch(src, [(7, ("add", "c"), "w7"), (40, ("remove", "a"), "w0")])
    rt.update_batch(cnt, [(9, ("increment",), "w9"), (33, ("increment", 2), "w3")])
    rounds = rt.run_to_convergence(max_rounds=64)
    out = {
        "rounds": rounds,
        "residuals": list(rt.round_residuals) if pkg == "torch"
        else [r["residual"] for r in rt.trace.rounds],
        "values": {v: rt.coverage_value(v) for v in ("src", "cnt", "seen")},
        "perm": rt.locality_perm.tolist(),
        "session": (s.value("src"), s.value("cnt"), s.execute("keys")),
    }
    chaos = s.nemesis(rt, "ring-cut", seed=3, rounds=6)
    report = chaos.soak(max_rounds=256)
    out["chaos"] = report["rounds_to_heal"]
    kv = s.quorum(chaos)
    rid = kv.submit_put("src", ("add", "q"), "client0")
    for _ in range(12):
        kv.step()
    out["quorum"] = kv.result(rid)["status"]
    scrub = s.aae(rt)
    stats = scrub.scrub()
    out["aae"] = {k: stats[k] for k in (
        "round", "corrupt_detected", "divergent_vars", "divergent_rows",
        "joins", "exchange_rounds", "comparisons", "rows_hashed")}
    fe = s.serve(rt)
    t = fe.submit_write("src", ("add", "z"), "client1")
    fe.cycle()
    out["serve"] = t.status
    rt.run_to_convergence(max_rounds=64)
    out["final"] = {v: rt.coverage_value(v) for v in ("src", "cnt", "seen")}
    if pkg == "torch":
        states = {v: [np.asarray(x) for x in to_numpy(rt.states[v])]
                  for v in ("src", "cnt", "seen")}
    else:
        states = {v: [np.asarray(x) for x in rt.states[v]]
                  for v in ("src", "cnt", "seen")}
    return out, states


def test_verb_sequence_matches_jax_at_64_replicas():
    want, want_states = _verb_sequence("jax")
    got, got_states = _verb_sequence("torch")
    assert got == want
    for v in want_states:
        for a, b in zip(got_states[v], want_states[v]):
            assert a.dtype == b.dtype and np.array_equal(a, b), v
