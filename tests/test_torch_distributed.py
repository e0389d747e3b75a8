"""The port's multi-process runtime on the CPU: two OS processes joined by
``comm.init_distributed`` (gloo, ``file://`` init) into one mesh of 8
shard slots, 4 a process, slices outermost — the twin of
``tests/mesh/test_multiprocess.py``. Each process holds only its 4 shards'
rows. Held, tolerance zero, against ``lasp_tpu``'s 8-device run in this
process (``tests/conftest.py`` forces 8 CPU devices) and against the
port's one-process run over 8 virtual slots: the JAX worker's checks
(gather path, ring slabs, per-destination exchange), the membership
variables' drive in both exchange modes (rounds, every round's residual,
the gathered states of each segment), ``partitioned_gossip`` and
``mesh_scale`` at small sizes, and what still refuses across processes.

The worker is this file run as a script (``__main__`` below): both
processes run it once and write their results for the tests to read."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

R = 64
N_MEMBERSHIP = 2000
MODES = ("gather", "alltoall")
SEGMENTS = ("step", "frontier_step", "run_to_convergence_auto", "converge_on_device")


# -- the membership drive, for either package ---------------------------------------


def _membership(store_cls, graph_cls, rt_cls, nbrs):
    """The membership variables (packed OR-Set 64 x 16 x 4, G-Counter,
    OR-SWOT 64 x 16) on ``nbrs``, 16 writers at their home rows."""
    store = store_cls(n_actors=16)
    store.declare(id="ads", type="lasp_orset", n_elems=64, n_actors=16,
                  tokens_per_actor=4)
    store.declare(id="views", type="riak_dt_gcounter", n_actors=16)
    store.declare(id="tags", type="riak_dt_orswot", n_elems=64, n_actors=16)
    n = nbrs.shape[0]
    rt = rt_cls(store, graph_cls(store), n, nbrs, packed=True)
    homes = [int(r) for r in np.random.RandomState(5).choice(n, 16, replace=False)]
    rt.update_batch("ads", [(homes[a], ("add_all", [f"ad{2 * a}", f"ad{2 * a + 1}"]),
                             f"w{a}") for a in range(16)])
    rt.update_batch("ads", [(homes[a], ("remove", f"ad{2 * a}"), f"w{a}")
                            for a in range(0, 16, 4)])
    _writes(rt, [(homes[a], a, f"t{a}", a + 1) for a in range(16)])
    return rt


def _writes(rt, batch):
    rt.update_batch("views", [(r, ("increment", by), f"w{a}") for r, a, _t, by in batch])
    rt.update_batch("tags", [(r, ("add", t), f"w{a}") for r, a, t, _by in batch])


def _drive(rt, n, snapshot):
    """``chip_smoke.py``'s shard drive: ``step()`` to the fixed point; 16
    writes and ``frontier_step()``; 16 more and ``run_to_convergence(mode=
    "auto")``; 16 more and ``converge_on_device()``. Returns the rounds of
    each segment and ``snapshot(rt)`` at its end, and the residual each
    ``step()`` / ``frontier_step()`` returned."""
    rows = np.random.RandomState(29).choice(n, 48, replace=False)
    out, residuals = [], []

    def writes(k):
        batch = [(int(rows[16 * k + a]), a, f"s{k}.{a}", a + 1) for a in range(16)]
        rt.update_batch("ads", [(r, ("add", f"ad{(a + 7 * k) % 64}"), f"w{a}")
                                for r, a, _t, _b in batch])
        _writes(rt, batch)

    def loop(fn):
        rounds = 1
        while True:
            residuals.append(int(fn()))
            if not residuals[-1]:
                return rounds
            rounds += 1

    runs = (lambda: loop(rt.step), lambda: loop(rt.frontier_step),
            lambda: rt.run_to_convergence(mode="auto"), rt.converge_on_device)
    for k, run in enumerate(runs):
        if k:
            writes(k - 1)
        out.append((int(run()), snapshot(rt)))
    return out, residuals


def _topology(n):
    from lasp_tpu_torch.mesh import locality_order, scale_free

    return locality_order(scale_free(n, 3, seed=1))[1]


def _port_leaves(rt) -> dict:
    from lasp_tpu_torch.bridge_state import to_numpy

    return {v: [np.asarray(x).copy() for x in to_numpy(rt.states[v])]
            for v in rt.var_ids}


# -- the worker --------------------------------------------------------------------


def _worker(rank: int, init: str, out_dir: str) -> None:
    import lasp_tpu_torch.bench_scenarios as bench
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.lattice import GSet, GSetSpec
    from lasp_tpu_torch.lattice.base import replicate, tree_map
    from lasp_tpu_torch.mesh import ReplicatedRuntime, comm, ring
    from lasp_tpu_torch.mesh import shard_gossip as sg
    from lasp_tpu_torch.mesh.topology import locality_order, scale_free
    from lasp_tpu_torch.ops import PackedORSet, PackedORSetSpec
    from lasp_tpu_torch.programs import ExampleKeylistProgram
    from lasp_tpu_torch.store import Store

    assert comm.init_distributed(init, 2, rank), "a cluster must join"
    assert comm.process_index() == rank and comm.process_count() == 2
    slots = comm.global_slots(4, device="cpu")
    mesh = comm.build_mesh(devices=slots, slice_of=lambda s: s.process_index)
    assert mesh.shape == {"slices": 2, "replicas": 4, "state": 1}, mesh.shape
    assert comm.n_slices(slots, slice_of=lambda s: s.process_index) == 2
    assert mesh.cross_process and mesh.device == torch.device("cpu")
    res: dict = {"rank": rank, "backend": comm.backend()}
    arrays: dict = {}

    def RT(*a, **kw):
        return ReplicatedRuntime(*a, device="cpu", **kw)

    # (1) the JAX worker's twin: the gather path over the joint axis
    store = Store(n_actors=4, device="cpu")
    c = store.declare(id="c", type="riak_dt_gcounter")
    rt = RT(store, Graph(store), R, ring(R, 2))
    rt.shard(mesh)
    res["held_rows"] = int(rt.states[c].counts.shape[0])
    rt.update_batch(c, [(0, ("increment", 5), "a"), (37, ("increment", 2), "b")])
    res["rounds"] = rt.run_to_convergence(max_rounds=R + 4, block=8)
    res["divergence"] = rt.divergence(c)
    res["row13_total"] = rt.replica_value(c, 13)
    res["coverage"] = rt.coverage_value(c)
    refused = {}
    for verb, call in (
        ("apply_batch", lambda: rt.apply_batch(c, lambda s: s)),
        ("resize", lambda: rt.resize(R, ring(R, 2))),
        ("join_rows", lambda: rt.join_rows(c, [0], [rt._row_of(c, 40)])),
        ("read_until", lambda: rt.read_until(0, c)),
        ("register", lambda: rt.register("p", ExampleKeylistProgram)),
        # every row dirty: the dense arm, which the reference fails on
        ("frontier_step_all_dirty", lambda: (rt.mark_dirty(), rt.frontier_step())),
    ):
        try:
            call()
            refused[verb] = None
        except (NotImplementedError, RuntimeError) as exc:
            refused[verb] = f"{type(exc).__name__}: {exc}"
    from lasp_tpu_torch.aae import HashForest
    from lasp_tpu_torch.store.checkpoint import save_runtime

    for verb, call in (("HashForest", lambda: HashForest(rt)),
                       ("save_runtime", lambda: save_runtime(rt, out_dir))):
        try:
            call()
            refused[verb] = None
        except NotImplementedError as exc:
            refused[verb] = f"{type(exc).__name__}: {exc}"
    res["refused"] = refused
    # the JAX worker's sparse drive: one dirty row on ring(64, 2)
    rt = RT(store, Graph(store), R, ring(R, 2))
    rt.shard(mesh)
    rt.update_batch(c, [(5, ("increment", 3), "a")])
    res["frontier_step_sparse"] = [
        [rt.frontier_step(), rt.frontier_rows_last, rt.frontier_dense_falls_last]
        for _ in range(2)]

    # the ring slabs across the process boundary
    flat = comm.Mesh(mesh.devices.reshape(-1), ("replicas",))
    first, count = comm.local_shards(flat, "replicas")
    b = R // 8
    spec = PackedORSetSpec(n_elems=4, n_actors=4, tokens_per_actor=1)
    rng = np.random.RandomState(0)
    pop = replicate(PackedORSet.new(spec, device="cpu"), R)._replace(
        exists=torch.as_tensor(rng.randint(0, 16, size=(R, spec.n_elems, spec.n_words)),
                               dtype=torch.int32))
    mine = tree_map(lambda x: x[first * b:(first + count) * b], pop)
    out, changed = sg.ring_gossip_rounds(PackedORSet, spec, mine, flat, 1, k=2)
    arrays["ring_exists"] = out.exists.numpy()
    res["ring_changed"] = bool(changed)
    sg.ring_gossip_shardmap_dryrun(mesh, R)

    # the per-destination exchange across the process boundary
    _, nn = locality_order(scale_free(R, 3, seed=4))
    plan = sg.partitioned_gossip_plan(nn, 8)
    gspec = GSetSpec(n_elems=8)
    gpop = replicate(GSet.new(gspec, device="cpu"), R)
    mask = gpop.mask.clone()
    mask[0, 0] = True
    mask[41, 3] = True
    gpop = gpop._replace(mask=mask[first * b:(first + count) * b].clone())
    gout, _ = sg.partitioned_gossip_rounds(GSet, gspec, gpop, flat, plan, 24,
                                           mode="alltoall")
    every = comm.all_gather(gout.mask.unsqueeze(0), flat).reshape(R, -1)
    res["uniform"] = bool(torch.all(every == every[0:1]))
    res["bits"] = int(every[0].sum())
    # the collective layer's uneven splits: rank 0 sends 1 row to itself
    # and 2 to rank 1, rank 1 sends 3 to rank 0 and 1 to itself
    mine = torch.arange(3 + rank, dtype=torch.int64) + 10 * rank
    res["all_to_all_splits"] = comm.all_to_all(
        mine, flat, splits=[1, 2] if rank == 0 else [3, 1]).tolist()
    res["ppermute"] = comm.ppermute(torch.tensor([rank]), flat, 1).tolist()
    res["all_reduce_max"] = comm.all_reduce(torch.tensor([rank, -rank]), flat,
                                            "max").tolist()

    # (2) the membership drive in both modes
    nbrs = _topology(N_MEMBERSHIP)
    for mode in MODES:
        rt = _membership(lambda **kw: Store(device="cpu", **kw), Graph, RT, nbrs)
        rt.shard(mesh, partition=True, partition_mode=mode)
        sg.reset_exchange()
        got, stepped = _drive(rt, N_MEMBERSHIP, _port_leaves)
        res[mode] = {
            "rounds": [r for r, _s in got],
            "stepped": stepped,
            "residuals": list(rt.round_residuals),
            "coverage": {v: sorted(map(str, x)) if isinstance(x, (set, frozenset))
                         else x for v, x in
                         ((v, rt.coverage_value(v)) for v in rt.var_ids)},
            "divergence": {v: rt.divergence(v) for v in rt.var_ids},
            "lo_hi": [rt._dist["lo"], rt._dist["hi"]],
            "exchanged": {k: dict(e) for k, e in sg.EXCHANGED.items()},
            "carried": {k: dict(e) for k, e in comm.CARRIED.items()},
            "process_bytes_total": rt.part_process_bytes_total,
        }
        for seg, (_r, leaves) in zip(SEGMENTS, got):
            for v, ls in leaves.items():
                for i, x in enumerate(ls):
                    arrays[f"{mode}/{seg}/{v}/{i}"] = x

    # (3) the sharded scenarios over the process group's slots
    res["partitioned_gossip"] = bench.partitioned_gossip(n_replicas=512, rounds=2,
                                                         device="cpu")
    res["mesh_scale"] = bench.mesh_scale(n_replicas=1 << 11, cycles=1, device="cpu")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f, default=lambda o: sorted(map(str, o))
                  if isinstance(o, (set, frozenset)) else str(o))
    torch.distributed.destroy_process_group()


# -- the tests ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two workers once; their results, by rank."""
    out = tmp_path_factory.mktemp("distributed")
    init = f"file://{out / 'group'}"
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), init,
                          str(out)], env=env, cwd=repo, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for r in range(2)
    ]
    failures = []
    for r, p in enumerate(procs):
        try:
            _out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            _out, err = p.communicate()
            failures.append(f"worker {r} timed out\n{err[-4000:]}")
            continue
        if p.returncode:
            failures.append(f"worker {r} rc={p.returncode}\n{err[-4000:]}")
    assert not failures, "\n".join(failures)
    got = []
    for r in range(2):
        with open(out / f"rank{r}.json") as f:
            res = json.load(f)
        res["arrays"] = dict(np.load(out / f"rank{r}.npz"))
        got.append(res)
    return got


def test_two_process_engine_matches_the_jax_worker(ranks):
    """The checks of ``tests/mesh/multiprocess_worker.py``, each process
    holding 32 of the 64 rows."""
    for res in ranks:
        assert res["backend"]["backend"] == "gloo"
        assert res["held_rows"] == R // 2
        assert res["rounds"] >= 1
        assert res["divergence"] == 0
        assert res["row13_total"] == 7
        assert res["coverage"] == 7
        assert res["uniform"] and res["bits"] == 2
    assert ranks[0]["all_to_all_splits"] == [0, 10, 11, 12]
    assert ranks[1]["all_to_all_splits"] == [1, 2, 13]
    assert ranks[0]["ppermute"] == [1] and ranks[1]["ppermute"] == [0]
    assert ranks[0]["all_reduce_max"] == ranks[1]["all_reduce_max"] == [1, 0]


def test_ring_slabs_equal_the_one_process_ring(ranks):
    from lasp_tpu_torch.lattice.base import replicate
    from lasp_tpu_torch.mesh import shard_gossip as sg
    from lasp_tpu_torch.mesh.comm import Mesh
    from lasp_tpu_torch.ops import PackedORSet, PackedORSetSpec

    spec = PackedORSetSpec(n_elems=4, n_actors=4, tokens_per_actor=1)
    rng = np.random.RandomState(0)
    pop = replicate(PackedORSet.new(spec, device="cpu"), R)._replace(
        exists=torch.as_tensor(rng.randint(0, 16, size=(R, spec.n_elems, spec.n_words)),
                               dtype=torch.int32))
    want, changed = sg.ring_gossip_rounds(PackedORSet, spec, pop,
                                          Mesh([torch.device("cpu")] * 8, ("replicas",)), 1)
    got = np.concatenate([res["arrays"]["ring_exists"] for res in ranks])
    assert np.array_equal(got, want.exists.numpy())
    assert all(res["ring_changed"] == bool(changed) for res in ranks)


def _jax_membership(mode):
    import jax
    from jax.sharding import Mesh as JMesh

    import lasp_tpu.dataflow as jdf
    import lasp_tpu.mesh as jmesh
    import lasp_tpu.store as jstore

    rt = _membership(jstore.Store, jdf.Graph, jmesh.ReplicatedRuntime,
                     _topology(N_MEMBERSHIP))
    rt.shard(JMesh(np.array(jax.devices()[:8]), ("replicas",)), axis="replicas",
             partition=True, partition_mode=mode)

    def snap(r):
        return {v: [np.asarray(x).copy() for x in jax.tree_util.tree_leaves(r.states[v])]
                for v in r.var_ids}

    return _drive(rt, N_MEMBERSHIP, snap)


def _port_membership(mode):
    import lasp_tpu_torch.dataflow as tdf
    import lasp_tpu_torch.mesh as tmesh
    import lasp_tpu_torch.store as tstore
    from lasp_tpu_torch.mesh.comm import Mesh

    rt = _membership(lambda **kw: tstore.Store(device="cpu", **kw), tdf.Graph,
                     lambda *a, **kw: tmesh.ReplicatedRuntime(*a, device="cpu", **kw),
                     _topology(N_MEMBERSHIP))
    rt.shard(Mesh([torch.device("cpu")] * 8, ("replicas",)), axis="replicas",
             partition=True, partition_mode=mode)
    run, stepped = _drive(rt, N_MEMBERSHIP, _port_leaves)
    return run, stepped, list(rt.round_residuals)


def _as_int32(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


@pytest.mark.parametrize("mode", MODES)
def test_membership_drive_equals_jax_and_one_process(ranks, mode):
    """The membership variables at 2,000 replicas, both exchange modes:
    every segment's rounds, the residual of every stepped round and the
    two processes' blocks, concatenated, equal JAX's 8-device run and the
    port's one-process run (and every entry of ``round_residuals`` the
    one-process run's)."""
    jax_run, jax_stepped = _jax_membership(mode)
    one_run, one_stepped, one_res = _port_membership(mode)
    for res in ranks:
        assert res[mode]["rounds"] == [r for r, _s in jax_run] == [r for r, _s in one_run]
        assert res[mode]["stepped"] == jax_stepped == one_stepped
        assert res[mode]["residuals"] == one_res
        assert all(d == 0 for d in res[mode]["divergence"].values())
        assert res[mode]["exchanged"] == ranks[0][mode]["exchanged"]
    assert ranks[0][mode]["lo_hi"] == [0, N_MEMBERSHIP // 2]
    assert ranks[1][mode]["lo_hi"] == [N_MEMBERSHIP // 2, N_MEMBERSHIP]
    for k, seg in enumerate(SEGMENTS):
        for v, want in jax_run[k][1].items():
            for i, (wj, wo) in enumerate(zip(want, one_run[k][1][v])):
                got = np.concatenate(
                    [res["arrays"][f"{mode}/{seg}/{v}/{i}"] for res in ranks])
                assert np.array_equal(_as_int32(got), _as_int32(wj)), (seg, v, i)
                assert np.array_equal(_as_int32(got), _as_int32(wo)), (seg, v, i)
    # the group carried only the exchanges' rows: less than the states
    for res in ranks:
        assert 0 < res[mode]["process_bytes_total"]
        assert res[mode]["carried"]["all_reduce"]["calls"] > 0


def test_membership_coverage_across_processes(ranks):
    for res in ranks:
        cov = res["alltoall"]["coverage"]
        assert cov["views"] == sum(a + 1 for a in range(16)) * 4
        assert len(cov["ads"]) == len(set(cov["ads"])) > 0
        assert cov == ranks[0]["alltoall"]["coverage"] == res["gather"]["coverage"]


def test_sharded_scenarios_equal_the_one_process_run(ranks):
    import lasp_tpu_torch.bench_scenarios as tbench

    pg = tbench.partitioned_gossip(n_replicas=512, rounds=2, device="cpu")
    ms = tbench.mesh_scale(n_replicas=1 << 11, cycles=1, device="cpu")
    for res in ranks:
        got = res["partitioned_gossip"]
        assert got["processes"] == 2 and pg["processes"] == 1
        for key in ("scenario", "n_replicas", "n_shards", "cut",
                    "dense_allgather_bytes_per_round",
                    "exchange_allgather_bytes_per_round", "alltoall_bytes_per_round",
                    "alltoall_buffer_bytes_per_round", "wire_reduction",
                    "wire_reduction_alltoall", "check"):
            assert got[key] == pg[key], key
        assert all(b > 0 for b in got["process_bytes_per_round"].values())
        got = res["mesh_scale"]
        for key in ("scenario", "n_replicas", "n_shards", "cut_rows", "per_shard",
                    "rounds_to_quiescence", "cut_rows_sparse_bytes",
                    "cut_rows_dense_bytes", "wire_cut_total", "wire_cut_at_5pct_dirty",
                    "wire_gate", "interior_overlap_frac", "write_density", "per_round"):
            assert got[key] == ms[key], key
        assert got["hier_converge"]["rounds"] == ms["hier_converge"]["rounds"] == (
            got["hier_converge"]["host_loop_rounds"])
    for name, want in (("partitioned_gossip", pg["block_hashes"]),
                       ("mesh_scale", ms["block_hashes"])):
        got = {}
        for res in ranks:
            part = res[name]["block_hashes"]
            if name == "mesh_scale":
                for v, hashes in part.items():
                    got.setdefault(v, {}).update(hashes)
            else:
                got.update(part)
        want = ({v: {str(k): h for k, h in hs.items()} for v, hs in want.items()}
                if name == "mesh_scale" else {str(k): h for k, h in want.items()})
        assert got == want, name


def test_verbs_outside_the_slice_refuse_across_processes(ranks):
    """The serving verbs, ``resize``, ``register`` and the gather path's
    sparse frontier rounds run across processes now (the JAX worker's
    one-row drive: ``[[2, 2, 0], [2, 3, 0]]``); a frontier round past the
    crossover (every row dirty), ``HashForest`` and ``save_runtime``
    refuse for parity, naming the reference's own failure there."""
    for res in ranks:
        got = res["refused"]
        for verb in ("apply_batch", "join_rows", "read_until", "resize", "register"):
            assert got[verb] is None, (verb, got[verb])
        assert res["frontier_step_sparse"] == [[2, 2, 0], [2, 3, 0]]
        for verb, item in (("frontier_step_all_dirty", 2), ("HashForest", 8),
                           ("save_runtime", 10)):
            msg = got[verb]
            assert msg is not None and f"A5c.{item}" in msg, (verb, msg)
            assert "parity" in msg and "Fetching value for `jax.Array` that spans " \
                "non-addressable" in msg, (verb, msg)
        assert got["HashForest"].startswith("NotImplementedError")
        assert got["frontier_step_all_dirty"].startswith(
            "RuntimeError: frontier_step unavailable")
        assert "past the crossover" in got["frontier_step_all_dirty"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
