"""mesh_comm: the shard mesh and the process wiring (port of
``lasp_tpu.mesh.comm``).

The JAX package maps the reference's disterl transport onto XLA
collectives over a ``jax.sharding.Mesh`` of devices. The port shards the
replica axis over S *shard slots* of one device: every slot names the same
``torch.device`` (the card, or the CPU in the tests), and each shard owns a
contiguous block of the population. The collectives become explicit
exchange steps between the shards' blocks (:mod:`.shard_gossip`).

What one device cannot hold waits for ROADMAP A5b: a mesh whose slots name
two distinct devices, and a multi-process runtime (``init_distributed``
with a cluster in the environment). Both raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

_A5B = (
    "meshes over several devices and multi-process runtimes are not ported "
    "yet (ROADMAP A5b); the port shards over virtual slots of one device"
)


class Mesh:
    """A grid of shard slots with named axes: ``devices`` is an object
    array of ``torch.device`` (slots may repeat a device — virtual
    shards), ``axis_names`` its axes, ``shape`` ``{axis: extent}``. Every
    slot must name one device."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = torch.device(given[pos])
        axis_names = tuple(str(a) for a in axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"a {grid.ndim}-D slot grid needs {grid.ndim} axis names, "
                f"got {axis_names}"
            )
        distinct = {str(d) for d in grid.flat}
        if len(distinct) > 1:
            raise NotImplementedError(f"{_A5B}: slots name {sorted(distinct)}")
        if not distinct:
            raise ValueError("a mesh needs at least one shard slot")
        self.devices = grid
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))
        #: the one device every slot names
        self.device = grid.flat[0]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


class Sharding(NamedTuple):
    """Where a replica-axis tensor lives on a mesh: ``spec`` names, per
    tensor dimension, the mesh axes that dimension splits over (None =
    whole on every shard), as JAX's ``PartitionSpec`` does."""

    mesh: Mesh
    spec: tuple


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join a multi-process runtime. Arguments default from
    ``torch.distributed``'s ``env://`` variables (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). A single-process
    environment (nothing set, or one process) is a no-op returning False,
    as in JAX. With a cluster set it raises ``NotImplementedError``: the
    multi-process runtime is ROADMAP A5b."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (
            f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '')}"
        )
    if num_processes is None:
        env = os.environ.get("WORLD_SIZE")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("RANK")
        process_id = int(env) if env else None
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    raise NotImplementedError(
        f"{_A5B}: {num_processes} processes at {coordinator_address} "
        f"(rank {process_id})"
    )


def _slice_index(slot: int) -> int:
    return 0


def n_slices(devices: Optional[Sequence] = None, slice_of=None) -> int:
    """Distinct slices among ``devices`` (``slice_of(slot index)``)."""
    devices = list(devices) if devices is not None else [resolve_device(None)]
    slice_of = slice_of or _slice_index
    return len({slice_of(i) for i in range(len(devices))})


def build_mesh(
    replicas: int = -1,
    state: Optional[int] = None,
    devices: Optional[Sequence] = None,
    slice_of=None,
) -> Mesh:
    """The canonical mesh, axes ``("slices", "replicas", "state")``, as
    JAX builds it: ``replicas`` shards the population (``-1`` takes every
    slot left), ``state`` comes from ``config.mesh_state_axis`` when None,
    ``slices`` is outermost. ``devices`` lists the shard slots (default:
    one slot of the default device — pass ``[torch.device("cpu")] * 8``
    for eight virtual shards of the CPU). ``slice_of`` maps a slot's
    index in ``devices`` to its slice id (virtual slots of one device are
    told apart by position, where JAX reads ``device.slice_index``)."""
    if state is None:
        from ..config import get_config

        state = get_config().mesh_state_axis
    devices = list(devices) if devices is not None else [resolve_device(None)]
    slice_of = slice_of or _slice_index
    slices: dict[int, list] = {}
    for i, d in enumerate(devices):
        slices.setdefault(slice_of(i), []).append(d)
    ns = len(slices)
    per_slice = min(len(v) for v in slices.values())
    if state < 1 or per_slice % state:
        raise ValueError(
            f"state axis {state} does not divide the {per_slice} devices "
            f"per slice"
        )
    max_replicas = per_slice // state
    if replicas == -1:
        replicas = max_replicas
    if replicas * state > per_slice:
        raise ValueError(
            f"replicas*state = {replicas * state} exceeds {per_slice} "
            f"devices per slice"
        )
    grid = np.empty((ns, replicas, state), dtype=object)
    for si, key in enumerate(sorted(slices)):
        slots = slices[key][: replicas * state]
        for j, d in enumerate(slots):
            grid[si, j // state, j % state] = d
    return Mesh(grid, ("slices", "replicas", "state"))


def population_sharding(mesh: Mesh) -> Sharding:
    """A ``[R, ...]`` population split over BOTH the slice axis and the
    replicas axis (coarse across slices, fine inside each)."""
    return Sharding(mesh, (("slices", "replicas"),))


def neighbor_sharding(mesh: Mesh) -> Sharding:
    """The ``[R, K]`` neighbour table, rows placed with their replicas."""
    return Sharding(mesh, (("slices", "replicas"), None))
