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


def test_init_distributed_with_a_cluster_names_a5b(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(NotImplementedError, match="A5b"):
        tcomm.init_distributed()
    with pytest.raises(NotImplementedError, match="A5b"):
        tcomm.init_distributed("localhost:1234", 4, 1)


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
