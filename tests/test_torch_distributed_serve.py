"""Serving across processes on the CPU: two OS processes joined by
``comm.init_distributed`` (gloo, ``file://`` init) into one mesh of 8
shard slots, 4 a process, each holding only its 4 shards' rows of a
64-replica runtime on the gather path (``shard(mesh)``, no partition).
Every process runs the same drives (SPMD) through ``lasp_tpu_torch``:
``apply_batch`` with an eager function; ``join_rows`` and ``reseed_row``;
``read_until`` / ``read_any_until``; removes, ``compact_orset`` and a
``compaction_window`` over a builder-backed trigger; ``compact_map_field``;
``ChaosRuntime.soak``
under every preset with degraded reads; ``quorum_kv``'s drive under every
preset; ``serve_load``'s drive. Each drive's observations (counts, round
residuals, states as ``int32`` views, fingerprints) are held, bit for bit,
against the same drive on one process of ``lasp_tpu`` in this process,
which the workers never import.

Beside them: the verbs still refused across processes (the gather path's
frontier round past the crossover, ``HashForest``, ``save_runtime``, for
parity with the reference; membership, programs and map writes run, held
in ``tests/test_torch_distributed_membership.py``; the sparse frontier
rounds run, held in ``tests/test_torch_distributed_frontier.py``), and a
test that pins the parity claim by running ``lasp_tpu`` itself across two
processes, where those three verbs raise, and where a small frontier's
sparse arm runs, as the port's does.

The workers are this file run as a script (``__main__`` below)."""

import json
import os
import signal
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

R = 64
CHAOS = ("ring-cut", "rolling-crash", "flaky-links", "slow-shard",
         "delay-links", "bit-rot")
#: ``serve_load``'s parameters at 64 replicas, its depth cut for the CPU
SERVE = dict(n_replicas=R, n_clients=400, ticks=6, arrivals_per_tick=60,
             burst_factor=5, seed_watches=100, parity_thresholds=400, seed=7)
REFERENCE_FAILURE = "Fetching value for `jax.Array` that spans non-addressable"


def _nbrs(seed):
    from lasp_tpu_torch.mesh.topology import random_regular

    return random_regular(R, 3, seed=seed)


# -- the package adapters -----------------------------------------------------------


def _port(shard=None):
    """The port, its runtimes sharded by ``shard(rt)`` (the workers) or not."""
    import lasp_tpu_torch.chaos as chaos
    from lasp_tpu_torch.bridge_state import to_numpy
    from lasp_tpu_torch.quorum.coverage import coverage_sweep
    from lasp_tpu_torch.telemetry.convergence import get_monitor
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.lattice import Threshold
    from lasp_tpu_torch.mesh import ReplicatedRuntime
    from lasp_tpu_torch.store import Store

    def bump(s):
        counts = s.counts.clone()
        counts[torch.tensor([0, 37, 50]), torch.tensor([0, 1, 2])] += torch.tensor(
            [5, 2, 3], dtype=counts.dtype)
        return s._replace(counts=counts)

    def set_bits(s):
        mask = s.mask.clone()
        mask[torch.tensor([3, 60]), torch.tensor([1, 6])] = True
        return s._replace(mask=mask)

    def trigger(rt, s_idx, f_idx):
        onehot = torch.arange(2, device=rt.device) == int(f_idx)

        def trig(dense):
            st, fl = dense["ads"], dense["flag"]
            live = (st.exists[int(s_idx)] & ~st.removed[int(s_idx)]).any()
            return {"flag": fl._replace(mask=fl.mask | (onehot & live))}
        return trig

    return types.SimpleNamespace(
        port=True, chaos=chaos, Threshold=Threshold, Graph=Graph,
        coverage_sweep=coverage_sweep, monitor=get_monitor,
        Store=lambda **kw: Store(device="cpu", **kw),
        RT=lambda *a, **kw: ReplicatedRuntime(*a, device="cpu", **kw),
        shard=shard or (lambda rt: rt),
        row=lambda rt, v, r: rt._row_of(v, r),
        flat=lambda rt, v: [_as_int32(x) for x in
                            _leaves(to_numpy(rt._whole_population(v)))],
        flat_row=lambda row: [_as_int32(x).tolist() for x in _leaves(to_numpy(row))],
        bump=bump, set_bits=set_bits, trigger=trigger,
    )


def _jax():
    import jax
    import jax.numpy as jnp

    import lasp_tpu.chaos as chaos
    from lasp_tpu.dataflow import Graph
    from lasp_tpu.quorum.coverage import coverage_sweep
    from lasp_tpu.telemetry.convergence import get_monitor
    from lasp_tpu.lattice import Threshold
    from lasp_tpu.mesh import ReplicatedRuntime
    from lasp_tpu.store import Store

    def bump(s):
        return s._replace(counts=s.counts.at[jnp.array([0, 37, 50]), jnp.array([0, 1, 2])]
                          .add(jnp.array([5, 2, 3], dtype=s.counts.dtype)))

    def set_bits(s):
        return s._replace(mask=s.mask.at[jnp.array([3, 60]), jnp.array([1, 6])].set(True))

    def trigger(_rt, s_idx, f_idx):
        def trig(dense):
            st, fl = dense["ads"], dense["flag"]
            live = (st.exists[s_idx] & ~st.removed[s_idx]).any()
            return {"flag": fl._replace(mask=fl.mask.at[f_idx].set(fl.mask[f_idx] | live))}
        return trig

    return types.SimpleNamespace(
        port=False, chaos=chaos, Threshold=Threshold, Graph=Graph, Store=Store,
        coverage_sweep=coverage_sweep, monitor=get_monitor,
        RT=ReplicatedRuntime, shard=lambda rt: rt,
        row=lambda rt, v, r: jax.tree_util.tree_map(lambda x: x[r], rt.states[v]),
        flat=lambda rt, v: [_as_int32(x) for x in jax.tree_util.tree_leaves(rt.states[v])],
        flat_row=lambda row: [_as_int32(x).tolist() for x in jax.tree_util.tree_leaves(row)],
        bump=bump, set_bits=set_bits, trigger=trigger,
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
    if isinstance(x, np.generic):
        return x.item()
    return x


# -- the drives, for either package --------------------------------------------------


def _apply_drive(p, obs):
    """``apply_batch`` of an eager function on a G-Counter and a G-Set: the
    function sees every row; the whole frontier goes dirty."""
    store = p.Store(n_actors=4)
    store.declare(id="c", type="riak_dt_gcounter", n_actors=4)
    store.declare(id="g", type="lasp_gset", n_elems=8)
    rt = p.shard(p.RT(store, p.Graph(store), R, _nbrs(5)))
    rt.apply_batch("c", p.bump)
    rt.apply_batch("g", p.set_bits)
    obs.add([rt.frontier_size(v) for v in ("c", "g")])
    probe = p.monitor().probe(rt, n_shards=8)
    obs.add({k: probe[k] for k in ("n_replicas", "lag_by_var", "worst_replica",
                                   "worst_replica_lag", "shard_lag")})
    obs.states(p, rt, "applied")
    obs.add(_steps(rt))
    obs.add([rt.coverage_value("c"), rt.coverage_value("g")])
    obs.states(p, rt, "converged")


def _steps(rt) -> list:
    """The residual of every ``step()`` up to the quiescent one."""
    out = [int(rt.step())]
    while out[-1]:
        out.append(int(rt.step()))
    return out


def _rows_drive(p, obs):
    """The row verbs, the parked reads and compaction on a packed runtime:
    an OR-Set of 32 elements, a G-Counter of 16 actors and a flag G-Set."""
    store = p.Store(n_actors=16)
    store.declare(id="ads", type="lasp_orset", n_elems=32, n_actors=8, tokens_per_actor=4)
    store.declare(id="views", type="riak_dt_gcounter", n_actors=16)
    store.declare(id="flag", type="lasp_gset", n_elems=2)
    rt = p.shard(p.RT(store, p.Graph(store), R, _nbrs(3), packed=True))
    homes = [int(r) for r in np.random.RandomState(5).choice(R, 8, replace=False)]
    rt.update_batch("ads", [(h, ("add_all", [f"e{2 * a}", f"e{2 * a + 1}"]), f"w{a}")
                            for a, h in enumerate(homes)])
    rt.update_batch("views", [(h, ("increment", a + 1), f"w{a}")
                              for a, h in enumerate(homes)])
    # join_rows before the population converges: broadcast and per row
    for v in ("ads", "views"):
        obs.add(rt.join_rows(v, [5, 40, 63], p.row(rt, v, homes[0])))
        obs.add(rt.join_rows(v, [10, 33], [p.row(rt, v, homes[1]), p.row(rt, v, homes[2])]))
        obs.add(rt.join_rows(v, [10, 33], [p.row(rt, v, homes[1]), p.row(rt, v, homes[2])]))
        obs.add(rt.frontier_size(v))
    obs.raises(lambda: rt.join_rows("views", [2, 2], p.row(rt, "views", 0)))
    obs.raises(lambda: rt.join_rows("views", [R], p.row(rt, "views", 0)))
    obs.states(p, rt, "joined")
    obs.add(_steps(rt))
    saved = p.row(rt, "views", 0)
    rt.reseed_row(37)
    rt.reseed_row(20, {"views": saved})
    obs.add([rt.frontier_size(v) for v in rt.var_ids])
    obs.raises(lambda: rt.reseed_row(R))
    obs.states(p, rt, "reseeded")
    obs.add(rt.run_to_convergence(block=8))
    # the parked reads: device-parked, host-probed, first match, unreachable
    total = int(rt.coverage_value("views"))
    rt.update_batch("views", [(7, ("increment", 9), "r0")])
    obs.add(p.flat_row(rt.read_until(60, "views", p.Threshold(total + 9))))
    obs.states(p, rt, "read_until")
    rt.update_batch("views", [(9, ("increment", 4), "r1")])
    obs.add(p.flat_row(rt.read_until(61, "views", p.Threshold(total + 13), on_device=False)))
    rt.update_batch("ads", [(11, ("add", "hot"), "w7")])
    rt.update_batch("views", [(12, ("increment", 2), "r2")])
    var, row = rt.read_any_until(
        50, [("views", p.Threshold(total + 1000)), ("views", p.Threshold(total + 15))])
    obs.add([var, p.flat_row(row)])
    obs.raises(lambda: rt.read_until(2, "views", p.Threshold(total + 1000)))
    obs.states(p, rt, "reads")
    # removes, then compaction on the converged population
    rt.update_batch("ads", [(homes[a], ("remove", f"e{2 * a}"), f"w{a}")
                            for a in range(0, 8, 2)])
    obs.raises(lambda: rt.compact_orset("ads"))
    obs.add(rt.run_to_convergence(block=8))
    obs.add(rt.compact_orset("ads"))
    obs.add(list(store.variable("ads").elems.terms()))
    obs.states(p, rt, "compacted")

    def make_trigger():
        (s_idx,) = rt.intern_terms("ads", ["sentinel"])
        (f_idx,) = rt.intern_terms("flag", ["raised"])
        return p.trigger(rt, s_idx, f_idx)

    rt.register_trigger(builder=make_trigger, touches=["ads", "flag"])
    obs.raises(lambda: rt.compact_orset("ads"))
    rt.update_batch("ads", [(homes[a], ("remove", f"e{2 * a + 1}"), f"w{a}")
                            for a in range(0, 8, 2)])
    with rt.compaction_window(max_rounds=256) as w:
        obs.add(w.compact_orset("ads"))
    obs.add(list(store.variable("ads").elems.terms()))
    rt.update_batch("ads", [(3, ("add", "sentinel"), "w3")])
    obs.add(rt.run_to_convergence(max_rounds=256))
    obs.add([rt.coverage_value(v) for v in rt.var_ids])
    obs.add(p.coverage_sweep(rt))
    obs.add([rt.divergence(v) for v in rt.var_ids])
    obs.states(p, rt, "window")


def _map_drive(p, obs):
    """``compact_map_field`` across processes: a map written before the
    runtime shards (map writes stay with ROADMAP A5c.12) and converged, its
    OR-Set field then compacted on every process's rows."""
    key = ("X", "lasp_orset")
    store = p.Store(n_actors=4)
    store.declare(id="kvs", type="riak_dt_map",
                  fields=[(key, "lasp_orset", {"n_elems": 4, "tokens_per_actor": 2})],
                  reset_on_readd=True)
    rt = p.RT(store, p.Graph(store), R, _nbrs(7))
    for cycle in range(2):
        rt.update_at(cycle, "kvs", ("update", [("update", key, ("add", f"v{cycle}"))]),
                     f"w{cycle}")
        obs.add(rt.run_to_convergence(max_rounds=64))
        rt.update_at(3, "kvs", ("update", [("remove", key)]), "w3")
    rt.update_at(4, "kvs", ("update", [("update", key, ("add", "live"))]), "w3")
    obs.add(rt.run_to_convergence(max_rounds=64))
    rt = p.shard(rt)
    obs.add(rt.compact_map_field("kvs", key))
    obs.add(list(store.variable("kvs").map_aux[0].elems.terms()))
    obs.add(rt.coverage_value("kvs"))
    obs.add(rt.divergence("kvs"))
    obs.states(p, rt, "compacted")


def _chaos_drive(p, obs, preset):
    """A packed OR-Set and a G-Set through one preset's dense soak, with a
    degraded read and its read-repair each faulty round, fused windows of
    4 between the actions."""
    from lasp_tpu_torch.chaos.invariants import fingerprint

    store = p.Store(n_actors=16)
    store.declare(id="ads", type="lasp_orset", n_elems=16, n_actors=8, tokens_per_actor=4)
    store.declare(id="soak", type="lasp_gset", n_elems=32)
    rt = p.RT(store, p.Graph(store), R, _nbrs(17), packed=True)
    rows = np.random.RandomState(17).choice(R, 8, replace=False)
    rt.update_batch("soak", [(int(r), ("add", f"w{int(r) % 32}"), f"c{int(r)}") for r in rows])
    rt.update_batch("ads", [(int(r), ("add", f"a{k}"), f"w{k}") for k, r in enumerate(rows)])
    rt = p.shard(rt)
    ch = p.chaos.ChaosRuntime(rt, p.chaos.nemesis(preset, R, rt._host_neighbors, seed=9))
    rep = ch.soak(mode="dense", block=4, reads_per_round=1, read_var="soak")
    obs.add(rep)
    obs.add(ch.injected_corruptions)
    obs.add(ch.degraded_read("soak", k=3, coordinator=1))
    obs.add([rt.coverage_value(v) for v in rt.var_ids])
    snap = {v: [np.asarray(x) for x in p.flat(rt, v)] for v in rt.var_ids}
    obs.add(fingerprint(snap))
    obs.states(p, rt, "healed")


# -- the worker ---------------------------------------------------------------------


def _refusals(rt, out_dir) -> dict:
    """What a cross-process gather-path runtime still refuses, by verb."""
    from lasp_tpu_torch.aae import HashForest
    from lasp_tpu_torch.chaos import ChaosRuntime, nemesis
    from lasp_tpu_torch.programs import ExampleKeylistProgram
    from lasp_tpu_torch.serve import ServeFrontend, ServeLoop
    from lasp_tpu_torch.store.checkpoint import save_runtime

    got = {}
    # a one-row frontier on a quiescent population: the sparse arm runs
    rt.run_to_convergence()
    rt.update_batch("c", [(0, ("increment", 1), "a")])
    got["frontier_step_sparse"] = [
        [rt.frontier_step(), rt.frontier_rows_last, rt.frontier_dense_falls_last]
        for _ in range(2)]
    for verb, call in (
        # every row dirty: the dense arm, which the reference fails on
        ("frontier_step_all_dirty", lambda: (rt.mark_dirty(), rt.frontier_step())),
        ("HashForest", lambda: HashForest(rt)),
        ("save_runtime", lambda: save_runtime(rt, os.path.join(out_dir, "rt.lasp"))),
        ("soak_frontier", lambda: ChaosRuntime(rt, nemesis("ring-cut", R, rt._host_neighbors))
         .soak(mode="frontier")),
        ("ServeLoop", lambda: ServeLoop(ServeFrontend(rt, clock=lambda: 0.0)).start()),
        ("resize", lambda: rt.resize(R, rt._host_neighbors)),
        ("register", lambda: rt.register("p", ExampleKeylistProgram)),
    ):
        try:
            call()
            got[verb] = None
        except (NotImplementedError, RuntimeError) as exc:
            got[verb] = f"{type(exc).__name__}: {exc}"
    return got


def _shared_clock(rt) -> dict:
    """A ``ServeFrontend`` with no clock is refused; on a clock both
    processes read alike (a tick counter) and the admission ladder's
    measured cycle seconds, agreed between the processes, both run the
    same cycles."""
    from lasp_tpu_torch.serve import ServeFrontend

    try:
        ServeFrontend(rt)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    ticks = iter(range(1 << 20))
    fe = ServeFrontend(rt, gossip_block=2, clock=lambda: float(next(ticks)))
    for r in (3, 40):
        fe.submit_write("c", ("increment", 2), f"x{r}", replica=r)
        fe.submit_read("c", replica=r + 1, deadline=fe.clock() + 60.0)
    stats = [fe.cycle() for _ in range(2)]
    return {"refused": refused,
            "cycles": [{k: s[k] for k in ("writes_applied", "reads_resolved", "level")}
                       for s in stats],
            "completed": fe.completed, "value": rt.coverage_value("c")}


def _worker(rank: int, init: str, out_dir: str) -> None:
    import lasp_tpu_torch.bench_scenarios as bench
    import lasp_tpu_torch.mesh.gossip as gossip
    from lasp_tpu_torch.chaos import PRESETS
    from lasp_tpu_torch.chaos.invariants import fingerprint, snapshot_states
    from lasp_tpu_torch.mesh import comm
    from lasp_tpu_torch.serve import harness

    assert comm.init_distributed(init, 2, rank), "a cluster must join"
    mesh = comm.build_mesh(devices=comm.global_slots(4, device="cpu"),
                           slice_of=lambda s: s.process_index)

    def shard(rt):
        rt.shard(mesh)
        assert rt._dist is not None and rt._partition is None
        return rt

    p = _port(shard)
    res, arrays = {"rank": rank}, {}

    def run(name, drive, *args):
        obs = _Obs()
        drive(p, obs, *args)
        res[name] = _json(obs.values)
        arrays.update({f"{name}/{k}": x for k, x in obs.arrays.items()})

    run("apply", _apply_drive)
    run("rows", _rows_drive)
    run("map", _map_drive)
    for preset in CHAOS:
        run(f"chaos/{preset}", _chaos_drive, preset)
    res["quorum"] = {}
    for preset in PRESETS:
        rt = shard(bench.quorum_kv_runtime(bench.random_regular(R, 3, seed=23), "cpu"))
        rec = bench.quorum_kv_preset(rt, preset)
        res["quorum"][preset] = _json({k: v for k, v in rec.items()
                                       if k not in ("seconds", "fsm_seconds")})
    kw = {k: v for k, v in SERVE.items() if k not in ("burst_factor",)}
    rt = shard(harness.load_runtime(R, seed=SERVE["seed"], n_clients=SERVE["n_clients"],
                                    device="cpu"))
    rep = harness.run_load(
        **kw, chaos=True, burst_at=max(2, SERVE["ticks"] // 2),
        burst_ticks=max(2, SERVE["ticks"] // 8), burst_factor=SERVE["burst_factor"],
        runtime=rt)
    rep.pop("overlap_seconds")
    res["serve"] = _json(rep)
    res["serve_fingerprint"] = fingerprint(snapshot_states(rt))
    # an opaque function's population past the sweep bound is refused
    c = bench.Store(n_actors=4, device="cpu")
    c.declare(id="c", type="riak_dt_gcounter")
    rt = shard(bench.ReplicatedRuntime(c, bench.Graph(c), R, bench.random_regular(R, 3),
                                       device="cpu"))
    keep, gossip.SWEEP_BYTES = gossip.SWEEP_BYTES, 64
    try:
        rt.apply_batch("c", lambda s: s)
        res["apply_refused"] = None
    except ValueError as exc:
        res["apply_refused"] = str(exc)
    finally:
        gossip.SWEEP_BYTES = keep
    res["shared_clock"] = _shared_clock(rt)
    res["refused"] = _refusals(rt, out_dir)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def _jax_worker(out_dir: str) -> None:
    """A ``lasp_tpu`` process of a two-process group (the environment of
    ``tests/mesh/test_multiprocess.py``): the gather path's frontier round
    on an all-dirty frontier, ``HashForest`` and ``save_runtime`` on a
    runtime sharded across the processes, then two frontier rounds from a
    one-row frontier."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from lasp_tpu.aae import HashForest
    from lasp_tpu.dataflow import Graph
    from lasp_tpu.mesh import ReplicatedRuntime, ring
    from lasp_tpu.mesh.comm import build_mesh, init_distributed
    from lasp_tpu.store import Store
    from lasp_tpu.store.checkpoint import save_runtime

    assert init_distributed(), "env wiring should trigger initialization"
    store = Store(n_actors=4)
    c = store.declare(id="c", type="riak_dt_gcounter")
    rt = ReplicatedRuntime(store, Graph(store), R, ring(R, 2))
    rt.shard(build_mesh(slice_of=lambda d: d.process_index))
    rt.apply_batch(c, jax.jit(lambda s: s._replace(counts=s.counts.at[5, 2].add(3))))
    got = {}
    for verb, call in (
        ("frontier_step", rt.frontier_step),
        ("HashForest", lambda: HashForest(rt).refresh()),
        ("save_runtime", lambda: save_runtime(
            rt, os.path.join(out_dir, f"rt{jax.process_index()}.lasp"))),
    ):
        try:
            call()
            got[verb] = None
        except Exception as exc:  # noqa: BLE001 — the failure is the result
            got[verb] = f"{type(exc).__name__}: {exc}"
    # a small frontier: one dirty row, whose reach stays under the crossover,
    # rides the sparse arm, which runs across processes
    rt = ReplicatedRuntime(store, Graph(store), R, ring(R, 2))
    rt.shard(build_mesh(slice_of=lambda d: d.process_index))
    rt.update_batch(c, [(5, ("increment", 3), "a")])
    try:
        got["frontier_step_sparse"] = [
            [rt.frontier_step(), rt.frontier_rows_last, rt.frontier_dense_falls_last]
            for _ in range(2)]
    except Exception as exc:  # noqa: BLE001 — the failure is the result
        got["frontier_step_sparse"] = f"{type(exc).__name__}: {exc}"
    with open(os.path.join(out_dir, f"jax{jax.process_index()}.json"), "w") as f:
        json.dump(got, f)
    print(f"WORKER-OK process={jax.process_index()}", flush=True)


# -- the tests ---------------------------------------------------------------------


def _spawn(args_of, env_of):
    """Two workers: this file with ``args_of(rank)``, in ``env_of(rank)``."""
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

    def env(r):
        out = dict(env_of(r), PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
            out.pop(name, None)
        return out

    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args_of(r)],
                             env=env(r), cwd=repo, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(2)]


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


def _jax_drives() -> dict:
    """The drives on one process of ``lasp_tpu``: ``{"values", "arrays"}``."""
    p = _jax()
    out, arrays = {}, {}

    def run(name, drive, *args):
        obs = _Obs()
        drive(p, obs, *args)
        out[name] = _json(obs.values)
        arrays.update({f"{name}/{k}": x for k, x in obs.arrays.items()})

    run("apply", _apply_drive)
    run("rows", _rows_drive)
    run("map", _map_drive)
    for preset in CHAOS:
        run(f"chaos/{preset}", _chaos_drive, preset)
    return {"values": out, "arrays": arrays}


def _jax_scenarios(out_dir: str) -> None:
    """``quorum_kv`` and ``serve_load`` on one process of ``lasp_tpu`` (a
    helper process of the fixture, beside the drives), their records and
    the served states' fingerprint written to ``out_dir/jax.json``."""
    import lasp_tpu.bench_scenarios as jb
    import lasp_tpu.mesh as jmesh
    from lasp_tpu.chaos.invariants import fingerprint, snapshot_states

    out = {"quorum": _json({k: {f: v for f, v in rec.items()
                                if f not in ("seconds", "fsm_seconds")}
                            for k, rec in jb.quorum_kv(R)["presets"].items()})}
    built = []
    base = jmesh.ReplicatedRuntime

    class Kept(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    jmesh.ReplicatedRuntime = Kept
    try:
        rep = jb.serve_load(**SERVE)
    finally:
        jmesh.ReplicatedRuntime = base
    for key in ("overlap_seconds", "seconds", "scenario", "engine", "check", "device"):
        rep.pop(key, None)
    out["serve"] = _json(rep)
    (rt,) = built
    out["serve_fingerprint"] = fingerprint(snapshot_states(rt))
    with open(os.path.join(out_dir, "jax.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two port workers' results by rank, and ``lasp_tpu``'s one-process
    records of the same drives, computed while the workers run: the drives
    here, the two scenarios in a helper process."""
    out = tmp_path_factory.mktemp("distributed_serve")
    init = f"file://{out / 'group'}"
    procs = _spawn(lambda r: (str(r), init, str(out)), lambda _r: os.environ)
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    helper = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "jax-scenarios", str(out)],
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", "")),
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        want = _jax_drives()
    finally:
        outs, failures = _wait(procs + [helper], 240)
    failures += [f"process {r} rc={rc}\n{err[-4000:]}"
                 for r, (rc, _o, err) in enumerate(outs) if rc]
    assert not failures, "\n".join(failures)
    with open(out / "jax.json") as f:
        want["values"].update(json.load(f))
    got = []
    for r in range(2):
        with open(out / f"rank{r}.json") as f:
            res = json.load(f)
        res["arrays"] = dict(np.load(out / f"rank{r}.npz"))
        got.append(res)
    return want, got


def _same(want, got, name):
    assert got[name] == want["values"][name], name
    keys = sorted(k for k in want["arrays"] if k.startswith(name + "/"))
    assert keys == sorted(k for k in got["arrays"] if k.startswith(name + "/")), name
    for k in keys:
        w, g = want["arrays"][k], got["arrays"][k]
        assert w.dtype == g.dtype and np.array_equal(w, g), k


def test_apply_batch_across_processes_equals_jax(runs):
    """An eager function of the whole population: the states it writes,
    the all-dirty frontiers, the rounds and residuals of the convergence
    after it."""
    want, ranks = runs
    for res in ranks:
        _same(want, res, "apply")
        assert "SWEEP_BYTES" in res["apply_refused"]


def test_row_verbs_parked_reads_and_compaction_equal_jax(runs):
    """``join_rows`` (broadcast, per row, idempotent, refusals),
    ``reseed_row`` (bottom and supplied), ``read_until`` (parked and
    host-probed), ``read_any_until``, an unreachable threshold's
    ``TimeoutError`` (which names its rounds), removes, ``compact_orset``
    and a ``compaction_window`` over a builder-backed trigger: every
    return value, every round residual and the states after each step."""
    want, ranks = runs
    for res in ranks:
        _same(want, res, "rows")


def test_compact_map_field_across_processes_equals_jax(runs):
    """A map's OR-Set field compacted after the runtime shards: the slots
    reclaimed, the field's new element order, the value and the states."""
    want, ranks = runs
    for res in ranks:
        _same(want, res, "map")


@pytest.mark.parametrize("preset", CHAOS)
def test_chaos_soak_and_degraded_reads_equal_jax(runs, preset):
    """``ChaosRuntime.soak(mode="dense")`` with a degraded read and its
    read-repair each faulty round: the soak report, the injected
    corruptions, a final degraded read, every round's residual, the
    healed states and their fingerprint."""
    want, ranks = runs
    for res in ranks:
        _same(want, res, f"chaos/{preset}")


def test_quorum_kv_equals_jax(runs):
    """``quorum_kv``'s drive under every preset: each preset's record,
    both fingerprints (states and protocol trace) included."""
    want, ranks = runs
    want = want["values"]["quorum"]
    for res in ranks:
        assert res["quorum"].keys() == want.keys()
        for preset, rec in want.items():
            assert {k: res["quorum"][preset][k] for k in rec} == rec, preset


def test_serve_load_equals_jax(runs):
    """``serve_load``'s drive at 64 replicas (depth cut for the CPU): the
    report (no acked write lost, threshold parity, typed sheds, per-kind
    outcomes and latencies) and the state fingerprint after heal."""
    want, ranks = runs
    for res in ranks:
        assert res["serve"] == want["values"]["serve"]
        assert res["serve_fingerprint"] == want["values"]["serve_fingerprint"]
        assert res["serve"]["no_write_lost"] and res["serve"]["threshold_parity"]["parity"]
        assert all(":" in k for k in res["serve"]["shed"])


def test_serve_across_processes_needs_a_shared_clock(runs):
    """With no clock ``ServeFrontend`` refuses across processes; on a
    shared clock both processes run the same cycles."""
    _want, ranks = runs
    a, b = (res["shared_clock"] for res in ranks)
    assert a == b
    assert "needs a clock that every process reads alike" in a["refused"]
    assert a["completed"]["write"] == 2 and a["completed"]["read"] == 2


def test_refusals_across_processes_name_their_reason(runs):
    """The parity refusals name the reference's own failure; ``resize``,
    ``register`` and the sparse frontier rounds from a one-row frontier
    run; a frontier round past the crossover (every row dirty) refuses; a
    frontier soak and ``ServeLoop`` refuse before anything runs."""
    _want, ranks = runs
    for res in ranks:
        got = res["refused"]
        for verb, item in (("frontier_step_all_dirty", 2), ("HashForest", 8),
                           ("save_runtime", 10), ("soak_frontier", 2)):
            assert got[verb] is not None and REFERENCE_FAILURE in got[verb], verb
            assert f"A5c.{item}" in got[verb] and "parity" in got[verb], verb
        assert "past the crossover" in got["frontier_step_all_dirty"]
        assert "all-dirty" in got["soak_frontier"]
        sparse = got["frontier_step_sparse"]
        assert len(sparse) == 2 and all(res > 0 and rows > 0 and falls == 0
                                        for res, rows, falls in sparse), sparse
        assert got["frontier_step_sparse"] == ranks[0]["refused"]["frontier_step_sparse"]
        assert got["resize"] is None and got["register"] is None
        assert got["ServeLoop"].startswith("RuntimeError: ServeLoop runs cycles")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_reference_fails_on_the_parity_verbs_across_processes(tmp_path):
    """The parity claim: ``lasp_tpu`` itself, two processes x 4 CPU
    devices joined by ``comm.init_distributed``, raises on the gather
    path's frontier round (at its dense arm, an all-dirty frontier),
    ``HashForest`` and ``save_runtime``. Its sparse arm runs: from a
    one-row frontier it takes two rounds with no dense fall, as the port's
    does (``tests/test_torch_distributed_frontier.py``)."""
    port = _free_port()

    def env(pid):
        return dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                    JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid), JAX_PLATFORMS="cpu",
                    XLA_FLAGS="--xla_force_host_platform_device_count=4")

    procs = _spawn(lambda r: ("jax", str(tmp_path)), env)
    outs, failures = _wait(procs, 180)
    assert not failures, "\n".join(failures)
    for i, (rc, out, err) in enumerate(outs):
        if rc != 0 and "Multiprocess computations aren't implemented on the CPU" in out + err:
            pytest.skip("jaxlib CPU backend lacks multiprocess collectives")
        assert rc == 0, f"worker {i} rc={rc}\nstdout:{out}\nstderr:{err[-4000:]}"
        assert f"WORKER-OK process={i}" in out
        with open(tmp_path / f"jax{i}.json") as f:
            got = json.load(f)
        for verb in ("frontier_step", "HashForest", "save_runtime"):
            assert got[verb] is not None and REFERENCE_FAILURE in got[verb], (verb, got)
        assert got["frontier_step_sparse"] == [[2, 2, 0], [2, 3, 0]], got


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_worker(sys.argv[2])
    elif sys.argv[1] == "jax-scenarios":
        _jax_scenarios(sys.argv[2])
    else:
        _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
