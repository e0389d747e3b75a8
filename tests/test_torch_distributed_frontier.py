"""The gather path's frontier scheduler across processes on the CPU: two OS
processes joined by ``comm.init_distributed`` (gloo, ``file://`` init) into
one mesh of 8 shard slots, 4 a process, each holding only its shards' rows
of a runtime on the gather path (``shard(mesh)``, no partition). Every
process runs the same drives (SPMD) through ``lasp_tpu_torch``:
``frontier_step`` rounds on the sparse arm (K2 / K3's plain versions on
each process's reachable rows, the neighbour rows it does not hold moved by
``comm.all_to_all``) while every variable's reach stays under the
crossover, then the round past it, which refuses for parity with the
reference and leaves every state and frontier as it was, then
``run_to_convergence(mode="auto")``, whose rounds past the crossover take
the dense gather step. The drives cover JAX's own two-process pin (a
G-Counter on ``ring(64, 2)``), every codec under ``plan="auto"`` (several
same-signature variables a group) and ``plan="off"``, a fixed edge mask,
and a population of 100 rows over the 8 shards (uneven runs). Each drive's
observations (every round's residual, ``frontier_rows_last``, dense falls
and frontier rows; round counts; states as ``int32`` views; values) are
held, bit for bit, against the same drive on one process of ``lasp_tpu``
in this process, which the workers never import. A sparse round carries
only the rows its reach reads, fewer bytes than a dense gather round.

The workers are this file run as a script (``__main__`` below)."""

import functools
import json
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

R = 128
#: actors a variable: one a written row, up to a quarter of the rows
A = R // 4
REFERENCE_FAILURE = "Fetching value for `jax.Array` that spans non-addressable"
MAP_FIELDS = [(("n", "riak_dt_gcounter"), "riak_dt_gcounter", {}),
              (("s", "lasp_gset"), "lasp_gset", {"n_elems": 8})]


def _rr(n, seed):
    from lasp_tpu_torch.mesh.topology import random_regular

    return random_regular(n, 3, seed=seed)


def _edge_mask(nbrs):
    from lasp_tpu_torch.mesh.topology import edge_failure_mask

    return edge_failure_mask(nbrs.shape[0], nbrs.shape[1], 0.25, seed=5, neighbors=nbrs)


# -- the package adapters -----------------------------------------------------------


def _port(shard=None, refuse=None, arms=None):
    """The port, its runtimes sharded by ``shard(rt)`` (the workers) or not;
    ``refuse(rt, mask, label)`` observes the dense-arm refusal and ``arms``
    takes each ``auto`` run's dense gather steps (workers)."""
    from lasp_tpu_torch.bridge_state import to_numpy
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, ring
    from lasp_tpu_torch.store import Store

    return types.SimpleNamespace(
        port=True, Graph=Graph, ring=ring,
        Store=lambda **kw: Store(device="cpu", **kw),
        RT=lambda *a, **kw: ReplicatedRuntime(*a, device="cpu", **kw),
        shard=shard or (lambda rt: rt), refuse=refuse, arms=arms,
        mask=lambda m: torch.as_tensor(m),
        residuals=lambda rt: list(rt.round_residuals),
        flat=lambda rt, v: [_as_int32(x) for x in
                            _leaves(to_numpy(rt._whole_population(v)))],
    )


def _jax():
    import jax
    import jax.numpy as jnp

    from lasp_tpu.dataflow import Graph
    from lasp_tpu.mesh import ReplicatedRuntime, ring
    from lasp_tpu.store import Store

    return types.SimpleNamespace(
        port=False, Graph=Graph, ring=ring, Store=Store, RT=ReplicatedRuntime,
        shard=lambda rt: rt, refuse=None, arms=None, mask=jnp.asarray,
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

    def __init__(self, name):
        self.name = name
        self.values, self.arrays = [], {}

    def add(self, value):
        self.values.append(value)

    def states(self, p, rt, label):
        for v in rt.var_ids:
            for i, x in enumerate(p.flat(rt, v)):
                self.arrays[f"{label}/{v}/{i}"] = x


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


def _seed(rt, ids, seed, writes):
    """Client writes at ``writes`` rows a variable, one actor a row."""
    rng = np.random.RandomState(seed)
    for v in ids:
        rows = rng.choice(rt.n_replicas, writes, replace=False)
        tn = rt.store.variable(v).type_name
        if tn == "riak_dt_gcounter":
            ops = [(int(r), ("increment", i + 1), f"w{i}") for i, r in enumerate(rows)]
        elif tn == "lasp_gset":
            ops = [(int(r), ("add", f"e{r % 4}"), f"w{i}") for i, r in enumerate(rows)]
        elif tn == "lasp_ivar":
            ops = [(int(rows[0]), ("set", f"p{seed}"), "w0")]
        elif tn == "riak_dt_map":
            ops = [(int(r), ("update", [("update", ("n", "riak_dt_gcounter"),
                                         ("increment", i + 1)),
                                        ("update", ("s", "lasp_gset"), ("add", f"m{r % 8}"))]),
                    f"w{i}") for i, r in enumerate(rows)]
        else:
            ops = [(int(r), ("add_all", [f"x{r % 8}", f"x{(r + 1) % 8}"]), f"w{i}")
                   for i, r in enumerate(rows)]
            ops.append((int(rows[0]), ("remove", f"x{rows[0] % 8}"), "w0"))
        rt.update_batch(v, ops)


def _next_is_sparse(rt, mask) -> bool:
    """Does every variable's next frontier round stay under the crossover?"""
    thresh = rt.frontier_crossover * rt.n_replicas
    for v in rt.var_ids:
        live = np.asarray(rt._frontier[v])[rt._host_neighbors]
        if mask is not None:
            live = live & mask
        if live.any(axis=1).sum() > thresh:
            return False
    return True


def _sparse_rounds(p, obs, rt, label, mask=None, limit=12):
    """``frontier_step`` while the next round stays on the sparse arm, under
    ``mask`` (``(host mask, the object the runtime was given)``) or none:
    each round's residual, ``frontier_rows_last``, dense falls and frontier
    rows; then the states; then the round past the crossover (observed by
    the port's workers, which refuse it)."""
    host, held = mask or (None, None)
    rounds = []
    for _ in range(limit):
        if not _next_is_sparse(rt, host):
            if p.refuse is not None:
                p.refuse(rt, held, obs.name)
            break
        res = rt.frontier_step(held)
        rounds.append([int(res), rt.frontier_rows_last, rt.frontier_dense_falls_last,
                       {v: np.flatnonzero(np.asarray(rt._frontier[v])).tolist()
                        for v in rt.var_ids}])
        if not res:
            break
    obs.add(rounds)
    obs.states(p, rt, label)


def _auto(p, obs, rt, label, mask=None):
    """``run_to_convergence(mode="auto")``: its rounds and every round's
    residual, then the states."""
    n0 = len(p.residuals(rt))
    if p.arms is not None:
        from lasp_tpu_torch.telemetry import counter

        dense = counter("gossip_frontier_dense_fallbacks_total",
                        reason="dense_arm_across_processes")
        d0 = dense.value
    obs.add([rt.run_to_convergence(max_rounds=256, edge_mask=mask, mode="auto"),
             p.residuals(rt)[n0:]])
    if p.arms is not None:
        p.arms[f"{obs.name}:{label}"] = dense.value - d0
    obs.states(p, rt, label)


def _pin_drive(p, obs):
    """JAX's own two-process drive: a G-Counter on ``ring(64, 2)``, one
    increment at row 5, two frontier rounds."""
    store = p.Store(n_actors=4)
    c = store.declare(id="c", type="riak_dt_gcounter")
    rt = p.shard(p.RT(store, p.Graph(store), 64, p.ring(64, 2)))
    rt.update_batch(c, [(5, ("increment", 3), "a")])
    obs.add([[int(rt.frontier_step()), rt.frontier_rows_last, rt.frontier_dense_falls_last]
             for _ in range(2)])
    obs.states(p, rt, "pinned")


def _declare_codecs(store):
    ids = [store.declare(id=f"g{i}", type="lasp_gset", n_elems=16) for i in range(3)]
    ids += [store.declare(id=f"c{i}", type="riak_dt_gcounter", n_actors=A) for i in range(2)]
    ids += [store.declare(id=f"o{i}", type="riak_dt_orswot", n_elems=8, n_actors=A)
            for i in range(2)]
    ids += [store.declare(id=f"s{i}", type="lasp_orset", n_elems=8, n_actors=A,
                          tokens_per_actor=2) for i in range(2)]
    ids += [store.declare(id="i0", type="lasp_ivar")]
    ids += [store.declare(id="m0", type="riak_dt_map", fields=MAP_FIELDS)]
    return ids


def _codecs_drive(p, obs, plan):
    """Every codec (G-Set, G-Counter, OR-SWOT, packed OR-Set, IVar, a map),
    three writes a variable: the sparse rounds, the refused round past the
    crossover, ``auto`` to quiescence; writes at 2% of the rows and
    ``auto`` again; every frontier all-dirty with writes at a quarter of
    the rows and ``auto`` again; the coverage values."""
    store = p.Store(n_actors=A)
    ids = _declare_codecs(store)
    rt = p.shard(p.RT(store, p.Graph(store), R, _rr(R, 11), packed=True, plan=plan))
    _seed(rt, ids, seed=7, writes=3)
    _sparse_rounds(p, obs, rt, "sparse")
    _auto(p, obs, rt, "auto")
    _seed(rt, ids, seed=8, writes=R // 50)
    _auto(p, obs, rt, "auto_sparse_writes")
    rt.mark_dirty()
    _seed(rt, ids, seed=9, writes=R // 4)
    _auto(p, obs, rt, "auto_all_dirty")
    obs.add({v: rt.coverage_value(v) for v in ids})


def _masked_drive(p, obs):
    """A fixed edge mask object (~25% dead edges): the population converged
    dense under it, then three writes a variable, the sparse rounds under
    it, the refused round and ``auto`` under it."""
    store = p.Store(n_actors=4)
    ids = [store.declare(id=f"g{i}", type="lasp_gset", n_elems=16) for i in range(2)]
    ids += [store.declare(id="c0", type="riak_dt_gcounter", n_actors=4),
            store.declare(id="o0", type="riak_dt_orswot", n_elems=8, n_actors=4)]
    nbrs = _rr(R, 13)
    mask = _edge_mask(nbrs)
    rt = p.shard(p.RT(store, p.Graph(store), R, nbrs))
    held = p.mask(mask)
    obs.add(rt.run_to_convergence(edge_mask=held))
    _seed(rt, ids, seed=3, writes=3)
    _sparse_rounds(p, obs, rt, "sparse", (mask, held))
    _auto(p, obs, rt, "auto", held)


def _uneven_drive(p, obs):
    """100 rows over the 8 shards (runs of 52 and 48 rows a process): a
    G-Counter, a G-Set and an OR-SWOT resized 64 -> 100, converged, then
    writes, the sparse rounds and ``auto``."""
    store = p.Store(n_actors=4)
    ids = [store.declare(id="c0", type="riak_dt_gcounter", n_actors=4),
           store.declare(id="g0", type="lasp_gset", n_elems=16),
           store.declare(id="o0", type="riak_dt_orswot", n_elems=8, n_actors=4)]
    rt = p.shard(p.RT(store, p.Graph(store), 64, _rr(64, 0)))
    rt.resize(100, _rr(100, 2))
    obs.add(rt.run_to_convergence(max_rounds=256))
    _seed(rt, ids, seed=5, writes=2)
    _sparse_rounds(p, obs, rt, "sparse")
    _auto(p, obs, rt, "auto")


DRIVES = {
    "pin": _pin_drive,
    "codecs/auto": functools.partial(_codecs_drive, plan="auto"),
    "codecs/off": functools.partial(_codecs_drive, plan="off"),
    "masked": _masked_drive,
    "uneven": _uneven_drive,
}


def _run(p, names) -> tuple:
    """The drives ``names`` through package ``p``: ``(values, arrays)``."""
    values, arrays = {}, {}
    for name in names:
        obs = _Obs(name)
        DRIVES[name](p, obs)
        values[name] = _json(obs.values)
        arrays.update({f"{name}/{k}": x for k, x in obs.arrays.items()})
    return values, arrays


# -- the worker ---------------------------------------------------------------------


def _refusal(refused: dict):
    """``refuse(rt, mask, label)``: the round past the crossover, which must
    raise and leave every state, frontier and counter as it was."""

    def refuse(rt, mask, label):
        from lasp_tpu_torch.bridge_state import to_numpy

        def snapshot():
            return ({v: [np.asarray(x).copy() for x in _leaves(to_numpy(rt._whole_population(v)))]
                     for v in rt.var_ids},
                    {v: rt._frontier[v].copy() for v in rt.var_ids},
                    [list(rt.round_residuals), rt.frontier_rows_last,
                     rt.frontier_rows_total, rt.frontier_dense_falls_last])

        before = snapshot()
        try:
            rt.frontier_step(mask)
            msg = None
        except RuntimeError as exc:
            msg = f"{type(exc).__name__}: {exc}"
        after = snapshot()
        same = (before[2] == after[2]
                and all(np.array_equal(before[1][v], after[1][v]) for v in rt.var_ids)
                and all(a.dtype == b.dtype and np.array_equal(a, b)
                        for v in rt.var_ids for a, b in zip(before[0][v], after[0][v])))
        refused[label] = {"message": msg, "unchanged": same}

    return refuse


def _carried_bytes(shard) -> dict:
    """One sparse frontier round and one dense gather step of the same
    population (a G-Counter and a G-Set, two writes each, ``plan="off"``):
    the bytes this process carried by collective, and the bytes the sparse
    round's ``all_to_all`` should carry, counted here from the reach: the
    rows of this process's run that the other's reachable rows read."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, comm
    from lasp_tpu_torch.store import Store

    store = Store(n_actors=4, device="cpu")
    ids = [store.declare(id="c", type="riak_dt_gcounter", n_actors=4),
           store.declare(id="g", type="lasp_gset", n_elems=16)]
    rt = shard(ReplicatedRuntime(store, Graph(store), R, _rr(R, 17), plan="off",
                                 device="cpu"))
    _seed(rt, ids, seed=4, writes=2)
    lo, hi = rt._dist["lo"], rt._dist["hi"]
    want = 0
    for v in ids:
        reach = np.flatnonzero(rt._frontier[v][rt._host_neighbors].any(axis=1))
        theirs = reach[(reach < lo) | (reach >= hi)]
        read = np.unique(rt._host_neighbors[theirs])
        want += int(((read >= lo) & (read < hi)).sum()) * rt._row_bytes(v)

    def carried(fn):
        before = {k: e["bytes"] for k, e in comm.CARRIED.items()}
        fn()
        return {k: e["bytes"] - before[k] for k, e in comm.CARRIED.items()}

    return {"sparse": carried(rt.frontier_step), "dense": carried(rt.step),
            "want_all_to_all": want, "dense_falls": rt.frontier_dense_falls_last}


def _worker(rank: int, init: str, out_dir: str) -> None:
    from lasp_tpu_torch.mesh import comm

    assert comm.init_distributed(init, 2, rank), "a cluster must join"
    mesh = comm.build_mesh(devices=comm.global_slots(4, device="cpu"),
                           slice_of=lambda s: s.process_index)
    res = {"rank": rank, "refused": {}, "arms": {}}

    def shard(rt):
        rt.shard(mesh)
        assert rt._dist is not None and rt._partition is None
        return rt

    values, arrays = _run(_port(shard, _refusal(res["refused"]), res["arms"]), DRIVES)
    res.update(values)
    res["bytes"] = _carried_bytes(shard)
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
    out = tmp_path_factory.mktemp("distributed_frontier")
    init = f"file://{out / 'group'}"
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), init,
                               str(out)], env=env, cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        values, arrays = _run(_jax(), DRIVES)
    finally:
        outs, failures = _wait(procs, 240)
    failures += [f"process {r} rc={rc}\n{err[-4000:]}"
                 for r, (rc, _o, err) in enumerate(outs) if rc]
    assert not failures, "\n".join(failures)
    want = {"values": values, "arrays": arrays}
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
    assert keys and keys == sorted(k for k in got["arrays"] if k.startswith(name + "/")), name
    for k in keys:
        w, g = want["arrays"][k], got["arrays"][k]
        assert w.dtype == g.dtype and np.array_equal(w, g), k


def _refused(res, label):
    """The round past the crossover refused for parity, nothing moved."""
    got = res["refused"][label]
    msg = got["message"]
    assert msg is not None and msg.startswith("RuntimeError: frontier_step unavailable"), msg
    assert "past the crossover" in msg and "A5c.2" in msg and "parity" in msg, msg
    assert REFERENCE_FAILURE in msg, msg
    assert got["unchanged"], label


def test_jax_two_process_pin_runs_on_the_sparse_arm(runs):
    """JAX's own two-process drive (``tests/test_torch_distributed_serve.py``
    pins it on ``lasp_tpu``): ``[[2, 2, 0], [2, 3, 0]]`` on both ranks."""
    want, ranks = runs
    assert want["values"]["pin"][0] == [[2, 2, 0], [2, 3, 0]]
    for res in ranks:
        _same(want, res, "pin")


@pytest.mark.parametrize("plan", ["auto", "off"])
def test_every_codec_across_processes_equals_jax(runs, plan):
    """G-Sets, G-Counters, OR-SWOTs, packed OR-Sets, an IVar and a map
    (same-signature variables share a launch under ``plan="auto"``): every
    sparse round's residual, ``frontier_rows_last``, dense falls and
    frontier rows, the states after them; ``auto``'s rounds and residuals
    from sparse writes, again from 2% of the rows, and from all-dirty
    frontiers; the states after each and the coverage values."""
    want, ranks = runs
    name = f"codecs/{plan}"
    rounds = want["values"][name][0]
    assert len(rounds) >= 2 and all(r[2] == 0 for r in rounds), rounds
    for res in ranks:
        _same(want, res, name)
        _refused(res, name)


def test_masked_sparse_rounds_across_processes_equal_jax(runs):
    """A fixed edge mask object: reach counts only live edges, and a dead
    edge's neighbour row is never moved."""
    want, ranks = runs
    assert want["values"]["masked"][1], "no sparse round under the mask"
    for res in ranks:
        _same(want, res, "masked")
        _refused(res, "masked")


def test_dense_arm_refuses_and_leaves_every_state_unchanged(runs):
    """The round past the crossover raises the parity ``RuntimeError``
    naming ROADMAP A5c.2 and the reference's own failure, on both ranks,
    before any member of any group moves: states, frontiers, residuals and
    the frontier counters as they were."""
    _want, ranks = runs
    for res in ranks:
        assert set(res["refused"]) == {"codecs/auto", "codecs/off", "masked", "uneven"}
        for label in res["refused"]:
            _refused(res, label)
    assert ranks[0]["refused"] == ranks[1]["refused"]


def test_uneven_population_across_processes_equals_jax(runs):
    """100 rows over 8 shards: rank 0 holds ``[0, 52)``, rank 1 ``[52,
    100)``; the sparse rounds and ``auto`` as on one process."""
    want, ranks = runs
    for res in ranks:
        _same(want, res, "uneven")
        _refused(res, "uneven")


def test_auto_convergence_across_processes_equals_jax(runs):
    """``run_to_convergence(mode="auto")``: the round count and every
    round's residual equal the one-process frontier convergence, from
    sparse writes and from all-dirty frontiers (the latter starts on the
    dense gather step, so both arms ran)."""
    want, ranks = runs
    for res in ranks:
        for name in ("codecs/auto", "codecs/off"):
            got, theirs = res[name], want["values"][name]
            for i, label in ((1, "auto"), (2, "auto_sparse_writes"), (3, "auto_all_dirty")):
                assert got[i] == theirs[i], (name, label)
                rounds, residuals = got[i]
                assert rounds == len(residuals) and residuals[-1] == 0, (name, label)
                # the dense gather step took only the rounds past the crossover
                assert 0 < res["arms"][f"{name}:{label}"] < rounds, (name, label)
        assert ranks[0]["arms"] == res["arms"]


def test_sparse_round_carries_only_the_rows_its_reach_reads(runs):
    """A sparse round moves, by ``all_to_all``, exactly the rows of this
    rank's run that the other rank's reachable rows read, plus one flag
    byte a reachable row, and gathers no population: fewer bytes than the
    dense gather round of the same population."""
    _want, ranks = runs
    for res in ranks:
        b = res["bytes"]
        assert b["dense_falls"] == 0
        assert b["sparse"]["all_to_all"] == b["want_all_to_all"] > 0
        assert 0 < b["sparse"]["all_gather"] < R
        assert sum(b["sparse"].values()) < b["dense"]["all_gather"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
