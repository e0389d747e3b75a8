"""The port's shard mesh (``lasp_tpu_torch.mesh.comm``) against
``lasp_tpu.mesh.comm``: twins of ``tests/mesh/test_comm.py`` for
``build_mesh``, ``n_slices`` and the single-process ``init_distributed``,
with 8 virtual ``cpu`` slots where JAX has its 8 CPU devices, and what
waits for ROADMAP A5b (two devices, several processes) refused by name."""

import jax
import numpy as np
import pytest
import torch

import lasp_tpu.mesh.comm as jcomm
import lasp_tpu_torch.mesh.comm as tcomm
from lasp_tpu.mesh.topology import ring
from lasp_tpu_torch.dataflow import Graph
from lasp_tpu_torch.mesh import ReplicatedRuntime
from lasp_tpu_torch.store import Store

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def test_init_distributed_noop_without_cluster(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    assert tcomm.init_distributed() is jcomm.init_distributed() is False
    assert tcomm.init_distributed(num_processes=1) is False
    assert jcomm.init_distributed(num_processes=1) is False


def test_init_distributed_joins_the_env_cluster_with_gloo_on_cpu(monkeypatch):
    """With a cluster in the environment the address, world size and rank
    go to ``torch.distributed.init_process_group``, and CPU ranks take
    gloo; an explicit ``file://`` address passes through as it is."""
    import torch.distributed as dist

    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append(dict(backend=backend, **kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(tcomm._GROUP, "backend", None)
    monkeypatch.setitem(tcomm._GROUP, "reason", None)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert tcomm.init_distributed() is True
    assert tcomm.init_distributed("file:///tmp/lasp-pg", 4, 3) is True
    assert seen == [
        {"backend": "gloo", "init_method": "tcp://localhost:29500",
         "world_size": 2, "rank": 1},
        {"backend": "gloo", "init_method": "file:///tmp/lasp-pg",
         "world_size": 4, "rank": 3},
    ]
    assert tcomm.backend()["backend"] == "gloo"
    assert "no card" in tcomm.backend()["reason"]


def test_build_mesh_flat_single_slice():
    got = tcomm.build_mesh(devices=CPU8)
    want = jcomm.build_mesh()
    assert got.axis_names == tuple(want.axis_names) == ("slices", "replicas", "state")
    assert got.shape == dict(want.shape) == {"slices": 1, "replicas": 8, "state": 1}
    assert tcomm.n_slices(CPU8) == jcomm.n_slices() == 1
    assert got.device == torch.device("cpu") and got.size == 8


def test_build_mesh_default_is_one_slot_of_the_default_device(monkeypatch):
    import lasp_tpu_torch.mesh.comm as comm

    monkeypatch.setattr(comm, "resolve_device", lambda d=None: torch.device("cpu"))
    mesh = comm.build_mesh()
    assert mesh.shape == {"slices": 1, "replicas": 1, "state": 1}


def test_build_mesh_state_axis_and_validation():
    got = tcomm.build_mesh(state=2, devices=CPU8)
    assert got.shape == dict(jcomm.build_mesh(state=2).shape)
    assert got.shape["replicas"] == 4 and got.shape["state"] == 2
    for kw, match in (({"state": 3}, "does not divide"),
                      ({"replicas": 8, "state": 2}, "exceeds")):
        with pytest.raises(ValueError, match=match):
            tcomm.build_mesh(devices=CPU8, **kw)
        with pytest.raises(ValueError, match=match):
            jcomm.build_mesh(**kw)


def test_build_mesh_two_virtual_slices():
    """The multi-slice layout through ``slice_of``: JAX maps devices, the
    port maps slot positions (its slots are one device)."""
    devs = jax.devices()
    by_half_j = {d: i // 4 for i, d in enumerate(devs)}
    by_half_t = {i: i // 4 for i in range(8)}
    got = tcomm.build_mesh(devices=CPU8, slice_of=by_half_t.get)
    want = jcomm.build_mesh(slice_of=by_half_j.get)
    assert got.shape == dict(want.shape) == {"slices": 2, "replicas": 4, "state": 1}
    assert tcomm.n_slices(CPU8, slice_of=by_half_t.get) == 2
    assert np.asarray(got.devices).shape == np.asarray(want.devices).shape
    got2 = tcomm.build_mesh(state=2, devices=CPU8, slice_of=by_half_t.get)
    assert got2.shape == dict(jcomm.build_mesh(state=2, slice_of=by_half_j.get).shape)


def test_mesh_over_two_devices_names_a5b():
    with pytest.raises(NotImplementedError, match="A5b"):
        tcomm.Mesh([torch.device("cpu"), torch.device("meta")], ("replicas",))
    with pytest.raises(NotImplementedError, match="A5b"):
        tcomm.build_mesh(devices=[torch.device("cpu"), torch.device("meta")])
    with pytest.raises(NotImplementedError, match="one process per device"):
        tcomm.Mesh([torch.device("cpu"), torch.device("meta")], ("replicas",))
    with pytest.raises(ValueError, match="axis names"):
        tcomm.Mesh(CPU8, ("slices", "replicas"))


def test_shardings_split_over_the_joint_axes():
    mesh = tcomm.build_mesh(devices=CPU8)
    assert tcomm.population_sharding(mesh).spec == (("slices", "replicas"),)
    assert tcomm.neighbor_sharding(mesh).spec == (("slices", "replicas"), None)
    assert tcomm.population_sharding(mesh).mesh is mesh


def _runtime(n):
    store = Store(n_actors=2, device="cpu")
    v = store.declare(id="v", type="lasp_gset", n_elems=4)
    rt = ReplicatedRuntime(store, Graph(store), n, ring(n, 2), device="cpu")
    rt.update_batch(v, [(0, ("add", "k"), "w")])
    return rt, v


def test_runtime_shard_on_two_slice_mesh():
    mesh = tcomm.build_mesh(devices=CPU8, slice_of={i: i // 4 for i in range(8)}.get)
    rt, v = _runtime(32)
    rt.shard(mesh)
    assert rt._frontier_shards == 8 and rt._partition is None
    rt.run_to_convergence(block=4)
    assert rt.coverage_value(v) == frozenset({"k"})
    assert rt.divergence(v) == 0


def test_runtime_shard_falls_back_when_joint_axis_does_not_divide():
    mesh = tcomm.build_mesh(devices=CPU8, slice_of={i: i // 4 for i in range(8)}.get)
    rt, v = _runtime(12)  # 12 % 8 != 0, 12 % 4 == 0
    rt.shard(mesh)
    assert rt._frontier_shards == 4
    rt.run_to_convergence(block=4)
    assert rt.coverage_value(v) == frozenset({"k"})
    rt2, _ = _runtime(10)  # divides neither extent
    with pytest.raises(ValueError, match="resize the population"):
        rt2.shard(mesh)


# -- the collective layer's one-process arm against PR 13's copies -----------------


def _one_process_mesh():
    return tcomm.Mesh(CPU8, ("replicas",))


def test_one_process_collectives_return_their_input():
    mesh = _one_process_mesh()
    x = torch.arange(24, dtype=torch.int32).reshape(8, 3)
    assert tcomm.all_gather(x, mesh) is x
    assert tcomm.all_to_all(x, mesh) is x
    assert tcomm.ppermute(x, mesh, 1) is x
    assert tcomm.all_reduce(x, mesh, "max") is x
    with pytest.raises(ValueError, match="reduction"):
        tcomm.all_reduce(x, mesh, "min")
    assert not mesh.cross_process and mesh.processes == (0,)
    assert tcomm.local_shards(mesh, "replicas") == (0, 8)


def test_per_destination_exchange_equals_the_slot_copy():
    """``shard_gossip._to_destinations`` over the one-process arm is PR 13's
    copy: destination d reads ``buf[:, d]`` from every owner."""
    from lasp_tpu_torch.mesh.shard_gossip import _to_destinations

    buf = torch.as_tensor(np.random.RandomState(3).randint(0, 99, (8, 8, 5, 2)))
    got = _to_destinations(buf, 8, _one_process_mesh())
    want = buf.transpose(0, 1).reshape(8, 8 * 5, 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("off", [1, -1, 2, -2])
def test_ring_slabs_equal_the_rolled_blocks(off):
    """``_shift_pull``'s boundary slabs through ``comm.ppermute`` equal the
    global pull-shift ``x[(r + off) % R]``, PR 13's ``torch.roll``."""
    from lasp_tpu_torch.lattice import GSet, GSetSpec
    from lasp_tpu_torch.lattice.base import replicate
    from lasp_tpu_torch.mesh.shard_gossip import _shift_pull

    r = 32
    st = replicate(GSet.new(GSetSpec(n_elems=4), device="cpu"), r)._replace(
        mask=torch.as_tensor(np.random.RandomState(1).rand(r, 4) < 0.5))
    got = _shift_pull(st, off, _one_process_mesh())
    assert torch.equal(got.mask, torch.roll(st.mask, -off, 0))


def test_slot_is_its_index_and_names_its_process():
    s = tcomm.Slot(5, 1, "cpu")
    assert int(s) == 5 and s.process_index == 1 and s.device == torch.device("cpu")
    assert {5: "x"}.get(s) == "x"  # slice_of tables keyed by position still work


def test_process_group_mesh_layout(monkeypatch):
    """A mesh of two processes' slots (the group faked): slices outermost,
    each process's run of shards, and the refusals of bad layouts."""
    monkeypatch.setattr(tcomm, "process_index", lambda: 1)
    monkeypatch.setattr(tcomm, "process_count", lambda: 2)
    slots = [tcomm.Slot(i, i // 4, "cpu") for i in range(8)]
    mesh = tcomm.build_mesh(devices=slots, slice_of=lambda s: s.process_index)
    assert mesh.shape == {"slices": 2, "replicas": 4, "state": 1}
    assert mesh.cross_process and mesh.processes == (0, 1)
    assert tcomm.local_shards(mesh, ("slices", "replicas")) == (4, 4)
    assert tcomm.shard_owners(mesh, ("slices", "replicas")).tolist() == [0] * 4 + [1] * 4
    with pytest.raises(ValueError, match="spans processes"):
        tcomm.shard_owners(mesh, "replicas")
    flat = tcomm.Mesh(mesh.devices.reshape(-1), ("replicas",))
    assert tcomm.local_shards(flat, "replicas") == (4, 4)
    # interleaved processes break the contiguous runs
    mixed = tcomm.Mesh([tcomm.Slot(i, i % 2, "cpu") for i in range(8)], ("replicas",))
    with pytest.raises(ValueError, match="contiguous"):
        tcomm.local_shards(mixed, "replicas")
    with pytest.raises(NotImplementedError, match="one device"):
        tcomm.Mesh([tcomm.Slot(0, 1, "cpu"), tcomm.Slot(1, 1, "meta"),
                    tcomm.Slot(2, 0, "cpu")], ("replicas",))
    with pytest.raises(ValueError, match="mixes"):
        tcomm.Mesh([tcomm.Slot(0, 1, "cpu"), torch.device("cpu")], ("replicas",))


def test_backend_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert tcomm.choose_backend(4)[0] == "nccl"
    assert tcomm.choose_backend(8)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    name, reason = tcomm.choose_backend(2)
    assert name == "gloo" and "NCCL refuses" in reason


def test_rank_device_rule(monkeypatch):
    import lasp_tpu_torch.device as tdev

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tdev.resolve_device(None) == torch.device("cuda", 1)
    assert tdev.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert tdev.resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.resolve_device(None)


def test_row_window_keeps_jax_row_rules():
    """The write window's positions keep JAX's rules: a negative row wraps
    once; a row still outside maps outside the window on its side, where a
    clamped read finds the population's first or last row."""
    from lasp_tpu_torch.mesh.runtime import _RowWindow

    win = _RowWindow([5, -3, 40, 7, 5, -100], 32)
    assert win.rows.tolist() == [0, 5, 7, 29, 31]
    got = win.compact([5, -3, 40, 7, -100, 31]).tolist()
    t = win.rows.size
    assert got[:2] == [1, 3] and got[3] == 2 and got[5] == 4
    assert got[2] >= t and got[4] + t < 0
    clamp = np.clip(np.where(np.array(got) < 0, np.array(got) + t, got), 0, t - 1)
    assert win.rows[clamp].tolist() == [5, 29, 31, 7, 0, 31]
