"""mesh_comm: the shard mesh, the process wiring and the collective layer
(port of ``lasp_tpu.mesh.comm``).

The JAX package maps the reference's disterl transport onto XLA
collectives over a ``jax.sharding.Mesh`` of devices, across processes
joined by ``jax.distributed``. The port shards the replica axis over S
*shard slots*; each shard owns a contiguous block of the population.

- One process: every slot names the same ``torch.device`` (the card, or
  the CPU in the tests) and the collectives are copies between the slots'
  blocks of one tensor.
- Several processes, joined by :func:`init_distributed` over
  ``torch.distributed``: the mesh's slots are :class:`Slot` s, each naming
  its process and that process's one device, and a process holds only
  its own slots' blocks. The collectives below then cross the process
  boundary: NCCL when every rank has a card of its own, else gloo with
  device tensors staged through pinned host buffers (:func:`backend`).

Several devices in one process are refused: the port reaches several
cards with one process per card, PyTorch's own idiom (ROADMAP C8).

Each collective of the layer (:func:`all_gather`, :func:`all_to_all`,
:func:`ppermute`, :func:`all_reduce`) works on this process's stack of
its local shards and has two arms: the one-process arm, where this
process holds every shard, returns its input (the exchange is the
caller's copy between slots), and the cross-process arm moves the stacks
between the ranks. :data:`CARRIED` counts what the process group carried,
:data:`STAGE_S` where the cross-process arm's seconds went.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

_ONE_DEVICE = (
    "the slots of one process must name one device: reach several devices "
    "with one process per device, joined by comm.init_distributed (the "
    "multi-process runtime, ROADMAP A5b)"
)

#: per collective kind, the calls that crossed processes and the bytes
#: this process sent to other processes through the group (the data each
#: other rank receives from this one)
CARRIED = {
    kind: {"calls": 0, "bytes": 0}
    for kind in ("all_gather", "all_to_all", "ppermute", "all_reduce")
}

#: seconds of the cross-process arm by stage: ``pack`` (the card's work
#: since :func:`pack_begin`, up to the collective's entry), ``d2h`` and
#: ``h2d`` (the staging copies through pinned host buffers) and
#: ``collective`` (the process group's call)
STAGE_S = {"pack": 0.0, "d2h": 0.0, "collective": 0.0, "h2d": 0.0}

#: the joined group's backend and why it was chosen (:func:`backend`)
_GROUP = {"backend": None, "reason": None}
_PACK_T0 = [None]


def reset_carried() -> None:
    for ent in CARRIED.values():
        ent.update(calls=0, bytes=0)
    for k in STAGE_S:
        STAGE_S[k] = 0.0


def carried_bytes() -> int:
    """Bytes this process has sent through the group since
    :func:`reset_carried`, over every collective kind."""
    return sum(ent["bytes"] for ent in CARRIED.values())


def _dist():
    import torch.distributed as dist

    return dist


def _joined() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the joined group (0 when none is joined):
    JAX's ``jax.process_index()``."""
    return _dist().get_rank() if _joined() else 0


def process_count() -> int:
    """Processes in the joined group (1 when none is joined): JAX's
    ``jax.process_count()``."""
    return _dist().get_world_size() if _joined() else 1


def backend() -> dict:
    """``{"backend", "reason"}`` of the joined group (both None when no
    group was joined through :func:`init_distributed`)."""
    return dict(_GROUP)


def choose_backend(num_processes: int) -> tuple:
    """``(backend, reason)`` by the fixed rule: NCCL when every rank has a
    card of its own (the ranks on this host, ``LOCAL_WORLD_SIZE``, default
    every rank, at most the cards), otherwise gloo with device tensors
    staged through pinned host buffers. NCCL refuses two ranks on one
    device, so ranks sharing a card take gloo."""
    if not torch.cuda.is_available():
        return "gloo", "the ranks have no card: CPU tensors"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    cards = torch.cuda.device_count()
    if local <= cards:
        return "nccl", f"{local} ranks on this host, {cards} cards: a card each"
    return "gloo", (
        f"{local} ranks share {cards} card(s) and NCCL refuses two ranks on "
        "one device: gloo, staged through pinned host buffers"
    )


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the multi-process runtime (the disterl node-joining role).
    Arguments default from ``torch.distributed``'s ``env://`` variables
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). A
    single-process environment (nothing set, or one process) is a no-op
    returning False, as in JAX; otherwise the process joins the group with
    ``torch.distributed.init_process_group`` and it returns True.
    ``coordinator_address`` is ``host:port`` (TCP) or ``file://<path>``
    (a shared file). The backend follows :func:`choose_backend`; on a
    card the rank's device (``device.resolve_device(None)``, by
    ``LOCAL_RANK``) becomes the current one."""
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
    if process_id is None:
        raise ValueError(
            f"{num_processes} processes at {coordinator_address} need this "
            "process's rank (RANK or process_id)"
        )
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    name, reason = choose_backend(num_processes)
    if torch.cuda.is_available():
        torch.cuda.set_device(resolve_device(None))
    _dist().init_process_group(
        name, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id),
    )
    _GROUP.update(backend=name, reason=reason)
    return True


class Slot(int):
    """One shard slot of a process group's mesh. The int is the slot's
    global index; ``process_index`` and ``device`` name its process and
    that process's device (JAX's ``device.process_index``)."""

    def __new__(cls, index: int, process_index: int, device):
        self = int.__new__(cls, index)
        self.process_index = int(process_index)
        self.device = torch.device(device)
        return self

    def __repr__(self) -> str:
        return (f"Slot({int(self)}, process_index={self.process_index}, "
                f"device={self.device})")


def global_slots(slots_per_process: int = 1, device=None) -> list:
    """Every process's slots in process order: process ``p`` contributes
    ``slots_per_process`` :class:`Slot` s naming its device (``device``,
    default ``resolve_device(None)``; the ranks exchange their devices
    once, a collective every rank makes). Without a joined group: this
    process's slots alone."""
    if slots_per_process < 1:
        raise ValueError(f"slots_per_process must be >= 1, got {slots_per_process}")
    mine = str(resolve_device(device))
    devs = [mine]
    if process_count() > 1:
        devs = [None] * process_count()
        _dist().all_gather_object(devs, mine)
    return [
        Slot(p * slots_per_process + j, p, d)
        for p, d in enumerate(devs) for j in range(slots_per_process)
    ]


class Mesh:
    """A grid of shard slots with named axes: ``devices`` is an object
    array of ``torch.device`` (slots may repeat a device — virtual shards)
    or of :class:`Slot` (a process group's mesh), ``axis_names`` its axes,
    ``shape`` ``{axis: extent}``. A one-process mesh's slots name one
    device; a process group's mesh names, per process, one device, and
    ``device`` is this process's."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            x = given[pos]
            grid[pos] = x if isinstance(x, Slot) else torch.device(x)
        axis_names = tuple(str(a) for a in axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"a {grid.ndim}-D slot grid needs {grid.ndim} axis names, "
                f"got {axis_names}"
            )
        slots = list(grid.flat)
        if not slots:
            raise ValueError("a mesh needs at least one shard slot")
        n_slot = sum(isinstance(s, Slot) for s in slots)
        if n_slot and n_slot != len(slots):
            raise ValueError("a mesh mixes process-group slots and devices")
        me = process_index()
        by_proc: dict = {}
        for s in slots:
            p = s.process_index if n_slot else me
            by_proc.setdefault(p, set()).add(str(s.device if n_slot else s))
        for p, devs in by_proc.items():
            if len(devs) > 1:
                raise NotImplementedError(
                    f"{_ONE_DEVICE}: process {p}'s slots name {sorted(devs)}")
        if me not in by_proc:
            raise ValueError(f"process {me} holds no slot of this mesh")
        self.devices = grid
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))
        #: the processes whose slots the mesh holds, in order
        self.processes = tuple(sorted(by_proc))
        if self.cross_process and self.processes != tuple(range(process_count())):
            # the collectives run over the whole group
            raise ValueError(
                f"a process group's mesh must hold a slot of every one of "
                f"its {process_count()} processes, got {self.processes}"
            )
        #: the one device this process's slots name
        self.device = next(
            (s.device for s in slots if s.process_index == me) if n_slot
            else iter(slots)
        )

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def cross_process(self) -> bool:
        """Whether the slots span several processes."""
        return len(self.processes) > 1

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, device={self.device}, "
                f"processes={len(self.processes)})")


class Sharding(NamedTuple):
    """Where a replica-axis tensor lives on a mesh: ``spec`` names, per
    tensor dimension, the mesh axes that dimension splits over (None =
    whole on every shard), as JAX's ``PartitionSpec`` does."""

    mesh: Mesh
    spec: tuple


def shard_owners(mesh: Mesh, axis) -> np.ndarray:
    """``int64[S]``: the process that holds each shard of a population
    split over ``axis`` (a name or tuple of names), in shard order. Each
    shard's slots (the other axes) must sit in one process, and the
    processes must hold contiguous, equal runs of shards in process order
    (slices outermost, as :func:`build_mesh` lays them out)."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    dims = [mesh.axis_names.index(a) for a in names]
    rest = [d for d in range(mesh.devices.ndim) if d not in dims]
    grid = np.transpose(mesh.devices, dims + rest)
    n = int(np.prod([mesh.devices.shape[d] for d in dims]))
    grid = grid.reshape(n, -1)
    owners = np.zeros(n, dtype=np.int64)
    for s in range(n):
        procs = {getattr(x, "process_index", mesh.processes[0]) for x in grid[s]}
        if len(procs) != 1:
            raise ValueError(
                f"shard {s} of axis {names} spans processes {sorted(procs)}: "
                "split over the axes that separate the processes (the "
                "joint (slices, replicas) axis of build_mesh)"
            )
        owners[s] = procs.pop()
    counts = np.bincount(owners, minlength=len(mesh.processes))
    if (np.any(np.diff(owners) < 0) or len(set(counts.tolist())) != 1):
        raise ValueError(
            f"the processes must hold equal contiguous runs of shards in "
            f"process order, got owners {owners.tolist()}"
        )
    return owners


def local_shards(mesh: Mesh, axis) -> tuple:
    """``(first, count)``: this process's run of shards of ``axis``
    (every shard, ``(0, S)``, on a one-process mesh)."""
    owners = shard_owners(mesh, axis)
    if not mesh.cross_process:
        return 0, int(owners.size)
    mine = np.flatnonzero(owners == process_index())
    return int(mine[0]), int(mine.size)


def n_slices(devices: Optional[Sequence] = None, slice_of=None) -> int:
    """Distinct slices among ``devices`` (``slice_of(slot)``; see
    :func:`build_mesh`)."""
    devices = _slot_list(devices)
    slice_of = slice_of or _slice_index
    return len({slice_of(_slot_key(i, d)) for i, d in enumerate(devices)})


def _slice_index(slot) -> int:
    return 0


def _slot_key(i: int, d):
    """What ``slice_of`` receives for slot ``i``: the :class:`Slot`
    itself (an int, its global index), else the slot's position."""
    return d if isinstance(d, Slot) else i


def _slot_list(devices) -> list:
    if devices is not None:
        return list(devices)
    if process_count() > 1:
        return global_slots()
    return [resolve_device(None)]


def build_mesh(
    replicas: int = -1,
    state: Optional[int] = None,
    devices: Optional[Sequence] = None,
    slice_of=None,
    slots_per_process: Optional[int] = None,
) -> Mesh:
    """The canonical mesh, axes ``("slices", "replicas", "state")``, as
    JAX builds it: ``replicas`` shards the population (``-1`` takes every
    slot left), ``state`` comes from ``config.mesh_state_axis`` when None,
    ``slices`` is outermost. ``devices`` lists the shard slots; by default
    every process's :func:`global_slots` when a group is joined
    (``slots_per_process`` each, default 1), else one slot of the default
    device (pass ``[torch.device("cpu")] * 8`` for eight virtual shards of
    the CPU). ``slice_of`` maps a slot to its slice id: a :class:`Slot`
    is passed as itself (``slice_of=lambda s: s.process_index`` puts each
    process in a slice, as JAX's worker does), a plain device slot by its
    position in ``devices``."""
    if state is None:
        from ..config import get_config

        state = get_config().mesh_state_axis
    if devices is None and slots_per_process is not None:
        devices = global_slots(slots_per_process)
    devices = _slot_list(devices)
    slice_of = slice_of or _slice_index
    slices: dict = {}
    for i, d in enumerate(devices):
        slices.setdefault(slice_of(_slot_key(i, d)), []).append(d)
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


# ---------------------------------------------------------------------------
# the collective layer
# ---------------------------------------------------------------------------


def pack_begin() -> None:
    """Mark the start of an exchange's pack on the card: the cross-process
    arm's next collective books the card's time since then as ``pack``."""
    _PACK_T0[0] = time.perf_counter()


def _staged(x: torch.Tensor) -> bool:
    return x.device.type == "cuda" and _GROUP["backend"] != "nccl"


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the group's backend takes it: gloo reads host memory, so a
    card's tensor is copied into a pinned host buffer."""
    x = x.contiguous()
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    t = time.perf_counter()
    if _PACK_T0[0] is not None:
        STAGE_S["pack"] += t - _PACK_T0[0]
        _PACK_T0[0] = None
    if not _staged(x):
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    STAGE_S["d2h"] += time.perf_counter() - t
    return host


def _from_wire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if y.device == like.device:
        return y
    t = time.perf_counter()
    out = y.to(like.device)
    if like.device.type == "cuda":
        torch.cuda.synchronize(like.device)
    STAGE_S["h2d"] += time.perf_counter() - t
    return out


def _timed_call(kind: str, sent: int, fn) -> None:
    t = time.perf_counter()
    fn()
    STAGE_S["collective"] += time.perf_counter() - t
    CARRIED[kind]["calls"] += 1
    CARRIED[kind]["bytes"] += int(sent)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[L, ...]``: this process's stack of its local shards' values ->
    ``[S, ...]``: every shard's, in shard order (the processes' stacks
    concatenated; every process holds L shards). One process: ``x``."""
    if not mesh.cross_process:
        return x
    dist = _dist()
    wire = _to_wire(x)
    outs = [torch.empty_like(wire) for _ in range(process_count())]
    _timed_call("all_gather", wire.nbytes * (len(outs) - 1),
                lambda: dist.all_gather(outs, wire))
    return _from_wire(torch.cat(outs), x)


def all_to_all(x: torch.Tensor, mesh: Mesh, splits=None, recv=None) -> torch.Tensor:
    """Rows for every process, in process order (``splits[p]`` rows for
    process ``p``) -> the rows every process sent this one, in process
    order. Without ``splits`` every process sends every process the same
    share of an ``x`` of the same rows everywhere (the exchanges' SPMD
    buffers); with them the processes first swap their counts, unless
    ``recv`` gives the rows this process takes from each (a plan every
    process computed alike). One process: ``x``."""
    if not mesh.cross_process:
        return x
    dist = _dist()
    world, me = process_count(), process_index()
    n = int(x.shape[0])
    if splits is None:
        if n % world:
            raise ValueError(f"{n} rows do not split over {world} processes")
        splits = recv = [n // world] * world
    else:
        splits = [int(s) for s in splits]
        if sum(splits) != n or len(splits) != world:
            raise ValueError(
                f"splits {splits} do not cover {n} rows of {world} processes")
        if recv is None:
            counts = torch.tensor(splits, dtype=torch.int64)
            recv_counts = torch.empty_like(counts)
            dist.all_to_all_single(recv_counts, counts)
            recv = recv_counts.tolist()
        recv = [int(r) for r in recv]
    wire = _to_wire(x)
    out = torch.empty((sum(recv),) + tuple(wire.shape[1:]), dtype=wire.dtype,
                      device=wire.device)
    row = wire[0].nbytes if n else 0
    _timed_call("all_to_all", row * (n - splits[me]),
                lambda: dist.all_to_all_single(out, wire, recv, splits))
    return _from_wire(out, x)


def ppermute(x: torch.Tensor, mesh: Mesh, shift: int) -> torch.Tensor:
    """The ``x`` of process ``(rank + shift) % P``: each process sends its
    ``x`` to ``(rank - shift) % P`` (``batch_isend_irecv`` between the two
    neighbours). One process: ``x``."""
    if not mesh.cross_process or shift % process_count() == 0:
        return x
    dist = _dist()
    world, me = process_count(), process_index()
    wire = _to_wire(x)
    out = torch.empty_like(wire)
    ops = [dist.P2POp(dist.isend, wire, (me - shift) % world),
           dist.P2POp(dist.irecv, out, (me + shift) % world)]

    def run():
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _timed_call("ppermute", wire.nbytes, run)
    return _from_wire(out, x)


def all_reduce(x: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` (``"sum"`` or ``"max"``) of every process's
    ``x``. One process: ``x``."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown reduction {op!r} ('sum' or 'max')")
    if not mesh.cross_process:
        return x
    dist = _dist()
    wire = _to_wire(x).clone()
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    _timed_call("all_reduce", wire.nbytes * (process_count() - 1),
                lambda: dist.all_reduce(wire, op=red))
    return _from_wire(wire, x)
