"""Membership, Lasp's programs, the map's writes, the actor guard and the
``Session`` wrappers across processes on the CPU: two OS processes joined
by ``comm.init_distributed`` (gloo, ``file://`` init) into one mesh of 8
shard slots, 4 a process, each holding only its shards' rows of a
64-replica runtime on the gather path (``shard(mesh)``, no partition).
Every process runs the same drives (SPMD) through ``lasp_tpu_torch``:
``resize`` 64 -> 96 -> 100 (which does not divide over the 8 shards) -> 64
graceful -> 40 crash; ``membership_grow`` / ``membership_drop_tail`` with
row-scoped ``dirty_rows``; ``shard(mesh, partition=True)`` again after a
resize; ``elastic_rebalance``'s staged arm through the
``MembershipCoordinator`` and one preset of the membership harness; the
2i index and keylist programs registered before the runtime shards;
``riak_dt_map`` writes that admit fields; the actor guard's collisions;
``Session.replicate`` then ``nemesis`` / ``quorum`` / ``serve``. Each
drive's observations (values, round counts, residuals, error messages,
states as ``int32`` views) are held, bit for bit, against the same drive
on one process of ``lasp_tpu`` in this process, which the workers never
import. ``Session.aae`` refuses for parity with the reference.

The workers are this file run as a script (``__main__`` below)."""

import json
import os
import signal
import subprocess
import sys
import types
import zlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

R = 64
IDS = ("ads", "views", "tags")
#: the 2i drive's stream: ``riak_index_2i``'s at 64 replicas, 128 events
INDEX = {"seed": 29, "n_events": 128, "n_keys": 48, "index_names": 2, "index_values": 8}
REFERENCE_FAILURE = "Fetching value for `jax.Array` that spans non-addressable"


def _rr(n, seed):
    from lasp_tpu_torch.mesh.topology import random_regular

    return random_regular(n, 3, seed=seed)


def _ring(n):
    from lasp_tpu_torch.mesh.topology import ring

    return ring(n, 2)


# -- the package adapters -----------------------------------------------------------


def _port(shard=None, reshard=None):
    """The port, its runtimes sharded by ``shard(rt)`` (the workers) or not."""
    import lasp_tpu_torch.chaos as chaos
    import lasp_tpu_torch.programs as prog
    from lasp_tpu_torch import Session
    from lasp_tpu_torch.bridge_state import to_numpy
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.membership import (
        MembershipCoordinator, changed_delivery_rows, run_membership_harness)
    from lasp_tpu_torch.mesh import ReplicatedRuntime
    from lasp_tpu_torch.quorum.coverage import ring_coverage_execute
    from lasp_tpu_torch.store import Store

    return types.SimpleNamespace(
        port=True, chaos=chaos, prog=prog, Graph=Graph,
        Session=lambda **kw: Session(device="cpu", **kw),
        Store=lambda **kw: Store(device="cpu", **kw),
        RT=lambda *a, **kw: ReplicatedRuntime(*a, device="cpu", **kw),
        Coordinator=MembershipCoordinator, changed_delivery_rows=changed_delivery_rows,
        harness=run_membership_harness, ring_coverage_execute=ring_coverage_execute,
        shard=shard or (lambda rt: rt), reshard=reshard or (lambda rt: rt),
        residuals=lambda rt: list(rt.round_residuals),
        flat=lambda rt, v: [_as_int32(x) for x in
                            _leaves(to_numpy(rt._whole_population(v)))],
    )


def _jax():
    import jax

    import lasp_tpu.chaos as chaos
    import lasp_tpu.programs as prog
    from lasp_tpu import Session
    from lasp_tpu.dataflow import Graph
    from lasp_tpu.membership import (
        MembershipCoordinator, changed_delivery_rows, run_membership_harness)
    from lasp_tpu.mesh import ReplicatedRuntime
    from lasp_tpu.quorum.coverage import ring_coverage_execute
    from lasp_tpu.store import Store

    return types.SimpleNamespace(
        port=False, chaos=chaos, prog=prog, Graph=Graph, Session=Session, Store=Store,
        RT=ReplicatedRuntime, Coordinator=MembershipCoordinator,
        changed_delivery_rows=changed_delivery_rows, harness=run_membership_harness,
        ring_coverage_execute=ring_coverage_execute,
        shard=lambda rt: rt, reshard=lambda rt: rt,
        residuals=lambda rt: [r["residual"] for r in rt.trace.rounds],
        flat=lambda rt, v: [_as_int32(x) for x in jax.tree_util.tree_leaves(rt.states[v])],
    )


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [tree]


def _as_int32(x):
    x = np.array(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


class _Obs:
    """One drive's observations: values in order, and state leaves."""

    def __init__(self):
        self.values, self.arrays = [], {}

    def add(self, value):
        self.values.append(value)

    def states(self, p, rt, label):
        for v in rt.var_ids:
            for i, x in enumerate(p.flat(rt, v)):
                self.arrays[f"{label}/{v}/{i}"] = x

    def raises(self, fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — the outcome is observed
            self.add([type(exc).__name__, str(exc)])
        else:
            self.add(None)


def _json(x):
    """A value as JSON keeps it: sets sorted, numpy scalars and tuples plain."""
    if isinstance(x, (set, frozenset)):
        return sorted(map(str, x))
    if isinstance(x, dict):
        return {str(k): _json(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


# -- the drives, for either package --------------------------------------------------


def _writes(rt, batch):
    rt.update_batch("views", [(r, ("increment", by), f"w{a}") for r, a, _t, by in batch])
    rt.update_batch("tags", [(r, ("add", t), f"w{a}") for r, a, t, _by in batch])


def _membership_rt(p, nbrs):
    """The membership variables (packed OR-Set 64 x 16 x 4, G-Counter,
    OR-SWOT 64 x 16) on ``nbrs``, 16 writers at their home rows, sharded."""
    store = p.Store(n_actors=16)
    store.declare(id="ads", type="lasp_orset", n_elems=64, n_actors=16, tokens_per_actor=4)
    store.declare(id="views", type="riak_dt_gcounter", n_actors=16)
    store.declare(id="tags", type="riak_dt_orswot", n_elems=64, n_actors=16)
    n = nbrs.shape[0]
    rt = p.shard(p.RT(store, p.Graph(store), n, nbrs, packed=True))
    homes = [int(r) for r in np.random.RandomState(5).choice(n, 16, replace=False)]
    rt.update_batch("ads", [(homes[a], ("add_all", [f"ad{2 * a}", f"ad{2 * a + 1}"]),
                             f"w{a}") for a in range(16)])
    rt.update_batch("ads", [(homes[a], ("remove", f"ad{2 * a}"), f"w{a}")
                            for a in range(0, 16, 4)])
    _writes(rt, [(homes[a], a, f"t{a}", a + 1) for a in range(16)])
    return rt


def _settle(p, obs, rt, label):
    """Dense convergence, then the values, divergence and states."""
    obs.add(rt.run_to_convergence(max_rounds=256))
    obs.add([rt.n_replicas, rt.membership_epoch])
    obs.add({v: rt.coverage_value(v) for v in IDS})
    obs.add({v: rt.divergence(v) for v in IDS})
    obs.add([rt.replica_value("views", r) for r in (0, rt.n_replicas // 2, rt.n_replicas - 1)])
    obs.states(p, rt, label)


def _resize_drive(p, obs):
    """``resize`` to 96 (and ``shard(partition=True)`` again), to 100 (no
    split over 8 shards), a graceful leave to 64 after writes past it, a
    crash leave to 40 after tail writes; each converged."""
    rt = _membership_rt(p, _rr(R, 0))
    _settle(p, obs, rt, "start")
    rt.resize(96, _rr(96, 1))
    p.reshard(rt)
    _settle(p, obs, rt, "grow96")
    rt.resize(100, _rr(100, 2))
    _writes(rt, [(51, 0, "b0", 2), (52, 1, "b1", 3), (99, 2, "b2", 4), (96, 3, "b3", 5)])
    _settle(p, obs, rt, "grow100")
    _writes(rt, [(64 + 9 * a, a, f"g{a}", 2) for a in range(4)])
    rt.update_batch("ads", [(70 + a, ("add", f"ad{48 + a}"), f"w{a}") for a in range(4)])
    rt.resize(R, _rr(R, 3))
    _settle(p, obs, rt, "graceful64")
    _writes(rt, [(40 + a, a, f"lost{a}", 100 + a) for a in range(4)])
    rt.resize(40, _rr(40, 4), graceful=False)
    _settle(p, obs, rt, "crash40")
    obs.add(p.residuals(rt))


def _staged_drive(p, obs):
    """``membership_grow`` to 96 and ``membership_drop_tail`` to 80 with
    ``changed_delivery_rows`` on rings (only the rows near the wrap change
    delivery): the row-scoped frontiers, then convergence."""
    rt = _membership_rt(p, _ring(R))
    rt.run_to_convergence()
    grown = _ring(96)
    dirty = p.changed_delivery_rows(rt._host_neighbors, grown, R, 96)
    rt.membership_grow(96, grown, dirty_rows=dirty)
    obs.add([int(np.asarray(dirty).size)] + [rt.frontier_size(v) for v in IDS])
    _settle(p, obs, rt, "grow")
    _writes(rt, [(90, 3, "d3", 7)])
    shrunk = _ring(80)
    dirty = p.changed_delivery_rows(grown, shrunk, 96, 80)
    rt.membership_drop_tail(80, shrunk, dirty_rows=dirty, actor_targets={90: 10})
    obs.add([int(np.asarray(dirty).size)] + [rt.frontier_size(v) for v in IDS])
    _settle(p, obs, rt, "drop")
    obs.add(p.residuals(rt))


def _coordinator_drive(p, obs):
    """``elastic_rebalance(64, grow_to=96)``'s staged arm, in dense rounds:
    a ``MembershipCoordinator`` grows the population with capped seed
    transfers under serve waves, then a staged leave drains back to 64."""
    n, grow_to, per_cycle = R, 96, 8
    rng = np.random.RandomState(31)
    waves = []
    for i in range(11):
        rows = rng.choice(n, size=4, replace=False)
        waves.append([
            ("kv", [(int(r), ("add", f"k{i}_{j}"), f"c{int(r)}") for j, r in enumerate(rows)]),
            ("tag", [(int(rows[0]), ("add", f"t{i}"), f"a{i % 16}")]),
            ("clk", [(int(rows[1]), ("add", f"e{i}"), f"b{i % 16}")]),
        ])
    store = p.Store(n_actors=64)
    store.declare(id="kv", type="lasp_gset", n_elems=256)
    store.declare(id="tag", type="lasp_orset", n_elems=64)
    store.declare(id="clk", type="riak_dt_orswot", n_elems=64)
    rt = p.shard(p.RT(store, p.Graph(store), n, _ring(n)))
    rt.update_batch("kv", [(r, ("add", f"seed{r % 8}"), f"s{r % 32}") for r in range(0, n, 4)])
    obs.add(rt.run_to_convergence())
    mc = p.Coordinator(rt, per_cycle=per_cycle)
    mc.stage_join(grow_to, _ring(grow_to))
    obs.add(_json(mc.commit().transfers))
    steps = []
    for i in range(256):
        if i < 6:
            for var, ops in waves[i]:
                rt.update_batch(var, ops)
        quorum = rt.quorum_value("kv", np.asarray([0, 1, 2]))
        steps.append([mc.step(mode="dense"), len(quorum)])
        if not mc.rebalancing and i >= 5 and steps[-1][0]["residual"] == 0:
            break
    obs.add(steps)
    for i in range(6, 11):
        for var, ops in waves[i]:
            rt.update_batch(var, ops)
        obs.add(rt.step())
    obs.add(rt.run_to_convergence())
    mc.stage_leave(n, _ring(n))
    mc.commit()
    obs.add(mc.run_to_settled(mode="dense"))
    obs.add([rt.n_replicas, rt.membership_epoch])
    obs.add({v: rt.coverage_value(v) for v in rt.var_ids})
    obs.states(p, rt, "settled")


def _harness_drive(p, obs):
    """``run_membership_harness`` under ``rolling-crash``: a join to 96, a
    leave back to 64 and a down to 56 with quorum puts, replayed."""
    def build():
        store = p.Store(n_actors=32)
        store.declare(id="kv", type="lasp_orset", n_elems=64, tokens_per_actor=8)
        store.declare(id="g", type="lasp_gset", n_elems=64)
        return p.shard(p.RT(store, p.Graph(store), R, _rr(R, 64)))

    rep = p.harness(
        build, [(3, "join", 96), (9, "leave", 64), (15, "down", 56)],
        preset="rolling-crash", seed=7, nemesis_rounds=10, per_cycle=16,
        quorum_writes=[(r, "kv", ("add", f"q{r}"), f"c{r}", (r * 37) % 32)
                       for r in (1, 4, 8, 10, 13)])
    obs.add(rep)


def _programs_drive(p, obs):
    """``riak_index_2i``'s drive at 64 replicas: the 2i index (auto views)
    and the keylist program registered, then the runtime sharded; every
    event processed at its key's row (filled views compact); converged; the
    ring-coverage execute, each program's execute and a quorum execute."""
    from lasp_tpu_torch.bench_scenarios import riak_index_events

    base = p.prog.riak_index.BASE_NAME
    store = p.Store(n_actors=16)
    rt = p.RT(store, p.Graph(store), R, _rr(R, INDEX["seed"]))
    rt.register(base, p.prog.RiakIndexProgram)
    rt.register("keylist", p.prog.ExampleKeylistProgram)
    rt = p.shard(rt)
    compactions = []
    inner = rt.compact_orset

    def counting(var_id):
        compactions.append(inner(var_id))
        return compactions[-1]

    rt.compact_orset = counting
    events = riak_index_events(INDEX["seed"], INDEX["n_events"], INDEX["n_keys"],
                               INDEX["index_names"], INDEX["index_values"])
    for obj, reason in events:
        rt.process(obj, reason, "idx", replica=zlib.crc32(obj[0].encode()) % R)
    obs.add(compactions)
    obs.add(rt.run_to_convergence(mode="auto"))
    swept = p.ring_coverage_execute(rt, n_shards=4)
    names = sorted(rt.programs)
    obs.add(names)
    obs.add({n: swept[n] for n in names})
    obs.add({n: rt.execute(n) == swept[n] for n in names})
    obs.add({n: rt.execute(n, replicas=[3, 33, 60]) == swept[n] for n in names})
    obs.add(p.residuals(rt))
    obs.states(p, rt, "indexed")


def _map_writes_drive(p, obs):
    """Writes to a ``riak_dt_map`` declared after the runtime sharded: a
    first touch admits a G-Counter field (``update_at``), a batch admits a
    G-Set field and a nested map's field; converged."""
    store = p.Store(n_actors=4)
    store.declare(id="c", type="riak_dt_gcounter")
    rt = p.shard(p.RT(store, p.Graph(store), R, _rr(R, 8)))
    store.declare(id="m", type="riak_dt_map")
    k = ("k", "riak_dt_gcounter")
    rt.update_at(3, "m", ("update", k, ("increment", 2)), "a")
    obs.add(rt.replica_value("m", 3))
    rt.update_batch("m", [
        (50, ("update", ("s", "lasp_gset"), ("add", "x")), "b"),
        (33, ("update", [("update", k, ("increment", 1)),
                         ("update", ("s", "lasp_gset"), ("add", "y"))]), "c"),
        (60, ("update", ("n", "riak_dt_map"),
              ("update", ("inner", "riak_dt_gcounter"), ("increment", 4))), "d"),
    ])
    obs.add(rt.run_to_convergence(max_rounds=64))
    obs.add(rt.coverage_value("m"))
    obs.add(rt.divergence("m"))
    obs.raises(lambda: rt.update_batch("m", [(5, ("remove", ("absent", "lasp_gset")), "a")]))
    obs.states(p, rt, "map")


def _guard_drive(p, obs):
    """``debug_actors``: a second write site of one actor raises from
    ``update_at``, ``update_batch`` and ``seed_increments``, naming the
    replica rows; a graceful leave moves a departed site to its claim
    target; a crash leave retires one."""
    store = p.Store(n_actors=8)
    store.declare(id="c", type="riak_dt_gcounter", n_actors=8)
    store.declare(id="s", type="riak_dt_orswot", n_elems=8, n_actors=8)
    rt = p.shard(p.RT(store, p.Graph(store), R, _rr(R, 9), debug_actors=True))
    rt.update_at(3, "c", ("increment", 1), "zz")
    obs.raises(lambda: rt.update_at(50, "c", ("increment", 1), "zz"))
    rt.update_batch("s", [(40, ("add", "e1"), "yy"), (40, ("add", "e2"), "yy")])
    obs.raises(lambda: rt.update_batch("s", [(41, ("add", "e3"), "yy")]))
    obs.raises(lambda: rt.seed_increments("c", [5, 6], [4, 4]))
    rt.seed_increments("c", [61], [5])
    rt.update_at(60, "s", ("add", "e4"), "xx")
    rt.resize(40, _rr(40, 10))  # 60 -> 20, 61 -> 21
    obs.raises(lambda: rt.update_at(20, "s", ("add", "e5"), "xx"))
    obs.raises(lambda: rt.update_at(22, "s", ("add", "e6"), "xx"))
    obs.raises(lambda: rt.seed_increments("c", [22], [5]))
    rt.update_at(30, "c", ("increment", 1), "vv")
    rt.resize(24, _rr(24, 11), graceful=False)
    obs.raises(lambda: rt.update_at(5, "c", ("increment", 1), "vv"))
    obs.add(rt.run_to_convergence(max_rounds=64))
    obs.add({v: rt.coverage_value(v) for v in ("c", "s")})
    obs.states(p, rt, "guard")


def _session_drive(p, obs):
    """``Session.replicate(64, topology="random", fanout=3, seed=0,
    packed=True)`` over the session phase's variables (a ``map`` edge
    included), sharded; its writers converged; then ``nemesis("ring-cut")``'s
    dense soak, a ``quorum`` put and get, ``serve`` on a tick clock."""
    import warnings

    s = p.Session(n_actors=16)
    s.declare(type="lasp_orset", id="ads", n_elems=64, n_actors=16, tokens_per_actor=4)
    s.declare(type="riak_dt_gcounter", id="views", n_actors=16)
    s.declare(type="lasp_gset", id="tags", n_elems=16)
    s.map("tags", lambda x: x + "!", dst="seen")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the locality note
        rt = p.shard(s.replicate(R, topology="random", fanout=3, seed=0, packed=True))
    writers = np.random.RandomState(5).choice(R, 16, replace=False)
    for a, r in enumerate(writers):
        mine = [f"ad{(a * 4 + j) % 64}" for j in range(4)]
        rt.update_batch("ads", [(int(r), ("add_all", mine), f"w{a}")])
        rt.update_batch("views", [(int(r), ("increment", a + 1), f"w{a}")])
        rt.update_batch("tags", [(int(r), ("add", f"t{a % 8}"), f"w{a}")])
    obs.add(rt.run_to_convergence())
    chaos = s.nemesis(rt, "ring-cut", seed=0)
    soak = chaos.soak()
    obs.add({k: v for k, v in soak.items() if "second" not in k})
    kv = s.quorum(chaos)
    put = kv.submit_put("ads", ("add", "ad63"), "w0")
    get = kv.submit_get("ads")
    for _ in range(64):
        kv.step()
        if "pending" not in (kv.result(put)["status"], kv.result(get)["status"]):
            break
    obs.add([kv.result(put)["status"], kv.result(get)["status"]])
    ticks = iter(range(1 << 20))
    fe = s.serve(rt, clock=lambda: float(next(ticks)))
    ticket = fe.submit_write("views", ("increment",), "w1")
    fe.cycle()
    obs.add(ticket.status)
    obs.add({v: rt.coverage_value(v) for v in ("ads", "views", "tags", "seen")})
    if p.port:
        obs.raises(lambda: s.aae(rt))
    obs.states(p, rt, "session")


DRIVES = {"resize": _resize_drive, "staged": _staged_drive,
          "coordinator": _coordinator_drive, "harness": _harness_drive,
          "programs": _programs_drive, "map": _map_writes_drive,
          "guard": _guard_drive, "session": _session_drive}
#: the drives ``lasp_tpu`` runs in a helper process beside the test's own
HELPER = ("coordinator", "harness", "programs", "map")


def _run(p, names) -> tuple:
    """The drives ``names`` through package ``p``: ``(values, arrays)``."""
    values, arrays = {}, {}
    for name in names:
        obs = _Obs()
        DRIVES[name](p, obs)
        values[name] = _json(obs.values)
        arrays.update({f"{name}/{k}": x for k, x in obs.arrays.items()})
    return values, arrays


# -- the worker ---------------------------------------------------------------------


def _worker(rank: int, init: str, out_dir: str) -> None:
    import lasp_tpu_torch.bench_scenarios as bench
    from lasp_tpu_torch.mesh import comm

    assert comm.init_distributed(init, 2, rank), "a cluster must join"
    mesh = comm.build_mesh(devices=comm.global_slots(4, device="cpu"),
                           slice_of=lambda s: s.process_index)
    res, arrays = {"rank": rank, "layouts": {}}, {}

    def shard(rt):
        rt.shard(mesh)
        assert rt._dist is not None and rt._partition is None
        return rt

    def reshard(rt):
        rt.shard(mesh, partition=True)
        assert rt._partition is not None
        res["layouts"]["partitioned"] = [rt._dist["lo"], rt._dist["hi"]]
        return rt

    values, arrays = _run(_port(shard, reshard), DRIVES)
    res.update(values)
    # the layout of a population that does not divide over the 8 shards
    store = bench.Store(n_actors=4, device="cpu")
    store.declare(id="c", type="riak_dt_gcounter")
    rt = shard(bench.ReplicatedRuntime(store, bench.Graph(store), R, _rr(R, 0), device="cpu"))
    rt.resize(100, _rr(100, 2))
    res["layouts"]["100"] = [rt._dist["lo"], rt._dist["hi"], int(rt.states["c"].counts.shape[0])]
    try:
        rt.shard(mesh)
        res["layouts"]["reshard100"] = None
    except ValueError as exc:
        res["layouts"]["reshard100"] = f"{type(exc).__name__}: {exc}"
    # riak_index_2i itself on a runtime sharded once its programs registered
    rep = bench.riak_index_2i(n_replicas=R, n_events=INDEX["n_events"], device="cpu",
                              shard=shard)
    res["riak_index_2i"] = {k: rep[k] for k in ("compactions", "converge_rounds", "values",
                                                 "programs", "views", "check")}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


# -- the tests ---------------------------------------------------------------------


def _wait(procs, timeout):
    outs, failures = [], []
    for r, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                if q.poll() is None:
                    q.send_signal(signal.SIGTERM)
            out, err = proc.communicate()
            failures.append(f"worker {r} timed out\n{err[-4000:]}")
        outs.append((proc.returncode, out, err))
    for q in procs:
        if q.poll() is None:
            q.kill()
            q.communicate()
    return outs, failures


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two port workers' results by rank, and ``lasp_tpu``'s one-process
    records of the same drives, computed here while the workers run."""
    out = tmp_path_factory.mktemp("distributed_membership")
    init = f"file://{out / 'group'}"
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args],
                              env=env, cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for args in ([str(r), init, str(out)] for r in range(2))]
    procs.append(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "jax", str(out)],
        env=dict(env, JAX_PLATFORMS="cpu"), cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    try:
        values, arrays = _run(_jax(), [n for n in DRIVES if n not in HELPER])
    finally:
        outs, failures = _wait(procs, 240)
    failures += [f"process {r} rc={rc}\n{err[-4000:]}"
                 for r, (rc, _o, err) in enumerate(outs) if rc]
    assert not failures, "\n".join(failures)
    with open(out / "jax.json") as f:
        values.update(json.load(f))
    arrays.update(np.load(out / "jax.npz"))
    want = {"values": values, "arrays": arrays}
    got = []
    for r in range(2):
        with open(out / f"rank{r}.json") as f:
            res = json.load(f)
        res["arrays"] = dict(np.load(out / f"rank{r}.npz"))
        got.append(res)
    return want, got


def _same(want, got, name, values=None):
    assert (values or got[name]) == want["values"][name], name
    keys = sorted(k for k in want["arrays"] if k.startswith(name + "/"))
    assert keys and keys == sorted(k for k in got["arrays"] if k.startswith(name + "/")), name
    for k in keys:
        w, g = want["arrays"][k], got["arrays"][k]
        assert w.dtype == g.dtype and np.array_equal(w, g), k


def test_resize_across_processes_equals_jax(runs):
    """``resize`` 64 -> 96 (sharded again with ``partition=True``) -> 100,
    which does not divide over the 8 shards (uneven runs: rank 0 holds
    ``[0, 52)``, rank 1 ``[52, 100)``; ``shard`` again refuses that
    population, whose 4-shard ``"replicas"`` fallback would span both
    processes) -> 64 graceful -> 40 crash: every round count, value,
    residual and state."""
    want, ranks = runs
    for res in ranks:
        _same(want, res, "resize")
        assert res["layouts"]["partitioned"] == [[0, 48], [48, 96]][res["rank"]]
        assert res["layouts"]["100"] == [[0, 52, 52], [52, 100, 48]][res["rank"]]
        assert res["layouts"]["reshard100"].startswith("ValueError: shard 0 of axis")


def test_staged_commits_across_processes_equal_jax(runs):
    """``membership_grow`` / ``membership_drop_tail`` with ``dirty_rows``:
    the row-scoped frontier sizes, the rounds and states after each."""
    want, ranks = runs
    for res in ranks:
        _same(want, res, "staged")


def test_coordinator_rebalance_across_processes_equals_jax(runs):
    """The coordinator's staged grow under serve waves and its staged
    leave: the transfer schedule, every cycle's report, the settled report,
    the values and the states."""
    want, ranks = runs
    for res in ranks:
        _same(want, res, "coordinator")


def test_membership_harness_across_processes_equals_jax(runs):
    """One harness preset (``rolling-crash``, quorum writes): the report —
    no acked write lost, replay identical."""
    want, ranks = runs
    for res in ranks:
        assert res["harness"] == want["values"]["harness"]
        rep = res["harness"][0]
        assert rep["no_write_lost"] and rep["replay_identical"] and rep["final_n"] == 56


def test_programs_across_processes_equal_jax(runs):
    """The 2i index and keylist programs on a runtime sharded after they
    registered: compactions, rounds, every program's value by the sweep,
    execute and a quorum execute, and the states; ``riak_index_2i`` itself
    passes its checks across processes with the same counts."""
    want, ranks = runs
    for res in ranks:
        _same(want, res, "programs")
        compactions, rounds, names, values = want["values"]["programs"][:4]
        rep = res["riak_index_2i"]
        assert rep["check"].startswith("sweep == execute")
        assert rep["compactions"] == len(compactions) > 0
        assert rep["converge_rounds"] == rounds
        assert rep["values"] == {n: len(values[n]) for n in names}


def test_map_writes_across_processes_equal_jax(runs):
    """A map declared after the runtime sharded: field admission by
    ``update_at`` and by a batch (a nested map's field too), the values,
    an absent field's remove refused, and the states."""
    want, ranks = runs
    for res in ranks:
        _same(want, res, "map")


def test_actor_guard_across_processes_names_global_rows(runs):
    """The guard's collisions raise on both ranks with JAX's messages,
    which name the replica rows ("at replica 3; writing from replica 50"),
    and its sites follow a graceful leave and retire at a crash leave."""
    want, ranks = runs
    for res in ranks:
        _same(want, res, "guard")
        msg = res["guard"][0]
        assert msg[0] == "ActorCollisionError"
        assert "at replica 3; writing from replica 50" in msg[1]


def test_session_wrappers_across_processes_equal_jax(runs):
    """``Session.replicate`` then ``shard``: the convergence, the
    ``nemesis`` soak, the ``quorum`` put and get, a ``serve`` cycle on a
    shared clock, the values and states; ``Session.aae`` refuses for
    parity, naming the reference's failure and ROADMAP A5c.8."""
    want, ranks = runs
    for res in ranks:
        got = res["session"]
        _same(want, res, "session", values=got[:-1])
        name, msg = got[-1]
        assert name == "NotImplementedError" and REFERENCE_FAILURE in msg
        assert "A5c.8" in msg and "Session.aae" in msg


def _jax_helper(out_dir: str) -> None:
    """The :data:`HELPER` drives on one process of ``lasp_tpu``, written to
    ``out_dir/jax.json`` and ``jax.npz``."""
    values, arrays = _run(_jax(), HELPER)
    np.savez(os.path.join(out_dir, "jax.npz"), **arrays)
    with open(os.path.join(out_dir, "jax.json"), "w") as f:
        json.dump(values, f)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_helper(sys.argv[2])
    else:
        _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
