"""The CUDA gossip kernels and their plain PyTorch versions (port of
``lasp_tpu.ops.pallas_gossip``).

Three kernels, hand-written for Hopper in ``csrc/`` and bound with ctypes:

- **K1** :func:`gossip_round_dense` (``csrc/gossip_round_dense.cu``)
  replaces ``pallas_gossip_round``: a dense pull round over the two packed
  OR-Set planes, ``out[r] = plane[r] | OR_k plane[neighbors[r, k]]``.
- **K2** :func:`gossip_round_rows` (``csrc/gossip_round_rows.cu``)
  replaces ``pallas_gossip_round_rows[_grouped]``, leafwise family: the
  row-sparse frontier round's gather + join, returning the joined rows
  ``[G, F, ...]`` and the raw per-slot changed flags.
- **K3** :func:`gossip_round_rows_vclock` (same source) replaces the vclock
  family of that entry point (``_vclock_join``): the same round with the
  OR-SWOT join ``lattice.dots.merge_dots`` over ``(clock, dots)``.

K2 and K3 take each leaf of a group either as one ``[G, R, ...]`` tensor or
as the G member tensors ``[R, ...]`` themselves; the kernels read members
through a table of base pointers, so the runtime's planned rounds never
stack member populations. The scatter of the joined rows back into the
population stays outside the kernels, as on the TPU.

Each wrapper runs its plain version for tensors on the CPU, and only there:
for CUDA tensors it launches the kernel or raises. Each launch adds one to
:data:`LAUNCHES` and to its shape's count in :data:`SHAPES`.

The launch schedules are pure functions of shapes, here where the CPU tests
reach them: :func:`dense_slab_words` picks K1's column-slab width,
:func:`rows_schedule` K2's vector width and team size, and
:func:`vclock_schedule` K3's copy path and stage chunk.

The TPU-only helpers are not ported: ``tuned_rows_block`` sized blocks for
2 MiB of VMEM (the CUDA launch shape comes from the schedules above and the
card's limits inside the launchers), and ``flatten_plane`` /
``unflatten_plane`` padded rows to the TPU's 128-lane width, which the CUDA
kernels do not need.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from ..lattice.base import any_trailing
from ..lattice.dots import merge_dots
from . import _build

#: kernel launches since the last :func:`reset_launches`, by kernel name
LAUNCHES = {
    "gossip_round_dense": 0, "gossip_round_rows": 0,
    "gossip_round_rows_vclock": 0,
}

#: the fields of each kernel's launch-shape key in :data:`SHAPES`
SHAPE_FIELDS = {
    "gossip_round_dense": ("R", "D", "K", "slab_words", "S"),
    "gossip_round_rows": ("G", "F", "R", "width", "leaves", "K", "dtype",
                          "op", "masked", "vec_bytes", "team_lanes"),
    "gossip_round_rows_vclock": ("G", "F", "R", "A", "E", "K", "masked",
                                 "bulk", "chunk_words"),
}

#: kernel launches since the last :func:`reset_launches`, by kernel name and
#: launch-shape key (a tuple of the kernel's :data:`SHAPE_FIELDS`)
SHAPES = {name: collections.Counter() for name in LAUNCHES}

#: the most neighbour columns the dense kernel stages in shared memory
MAX_FANOUT = 32


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        SHAPES[name].clear()


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_launch(name: str, rc: int, shape: tuple) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    LAUNCHES[name] += 1
    SHAPES[name][shape] += 1


def _require_cuda(name: str, *tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(
                f"{name}: every tensor must lie on one CUDA device "
                f"(got {[str(x.device) for x in tensors]})"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def address_alignment(*tensors) -> int:
    """The largest of 16, 8, 4, 2 and 1 bytes that divides every tensor's
    address."""
    bits = 16
    for t in tensors:
        bits |= t.data_ptr()
    return bits & -bits


# ---------------------------------------------------------------------------
# K1: dense round over packed planes
# ---------------------------------------------------------------------------


def gossip_round_dense_plain(exists, removed, neighbors):
    """Plain PyTorch K1: ``out[r] = plane[r] | OR_k plane[neighbors[r, k]]``
    for both ``int32[S, D]`` word planes and ``neighbors: int32[R, K]``,
    ``R <= S``: the first R rows are the rows of the round, the rest only
    sources (a shard's ``[block | received]`` buffer)."""
    nb = neighbors.long()
    r = nb.shape[0]
    acc_e, acc_r = exists[:r], removed[:r]
    for k in range(nb.shape[1]):
        acc_e = acc_e | exists[nb[:, k]]
        acc_r = acc_r | removed[nb[:, k]]
    return acc_e, acc_r


#: the most bytes one slab of one plane may span: K1's slab sweep (PERF.md,
#: from ``chip_smoke.py``) found slabs past the L2 faster than narrower ones
#: on 4 KB rows, where each row's slab segment is a DRAM access of its own
DENSE_SLAB_BYTES = 64 << 20
#: K1 cuts a row into at least this many slabs (the same sweep: on 512-byte
#: rows a quarter row beat a half row)
DENSE_MIN_SLABS = 4
#: K1's narrowest slab: one 32-byte sector of each row
DENSE_MIN_SLAB_WORDS = 8


def dense_vector_words(d: int, *tensors) -> int:
    """The words K1 moves per load for rows of ``d`` words: 4 (16 bytes)
    when ``d`` and every tensor's address allow it, else 2, else 1 — the
    launcher's own rule (``csrc/gossip_round_dense.cu``)."""
    aligned = address_alignment(*tensors)
    if d % 4 == 0 and aligned == 16:
        return 4
    if d % 2 == 0 and aligned >= 8:
        return 2
    return 1


def dense_slab_words(r: int, d: int, vec: int) -> int:
    """K1's column-slab width, in words, for ``[r, d]`` planes loaded
    ``vec`` words at a time: the widest power-of-two slab (a multiple of
    ``vec``, at least :data:`DENSE_MIN_SLAB_WORDS`) that spans at most
    :data:`DENSE_SLAB_BYTES` and leaves at least :data:`DENSE_MIN_SLABS`
    slabs a row; the whole row only when a row is no wider than the
    narrowest slab. Slabs beat whole rows even where both planes fit the
    L2 (PERF.md)."""
    w = max(DENSE_MIN_SLAB_WORDS, vec)
    while 2 * w * DENSE_MIN_SLABS <= d and r * (2 * w) * 4 <= DENSE_SLAB_BYTES:
        w *= 2
    return min(w, d)


def dense_slab_columns(d: int, slab_words: int) -> list:
    """The ``(start, stop)`` word ranges of K1's slabs over a row of ``d``
    words, in the order the kernel walks them (the last may be narrower)."""
    return [(c, min(c + slab_words, d)) for c in range(0, d, slab_words)]


@functools.cache
def _dense_fn():
    fn = _build.library("gossip_round_dense").lasp_gossip_round_dense
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _dense_launch(exists, removed, neighbors, out_e, out_r, slab_words: int) -> None:
    """One K1 launch in column slabs of ``slab_words`` words (checked CUDA
    tensors): ``R = neighbors.shape[0]`` rows written from ``S =
    exists.shape[0]`` source rows."""
    src, d = exists.shape
    r, k = neighbors.shape
    dev = exists.device
    with torch.cuda.device(dev):
        rc = _dense_fn()(
            exists.data_ptr(), removed.data_ptr(), neighbors.data_ptr(),
            out_e.data_ptr(), out_r.data_ptr(), r, d, k, slab_words,
            _stream_ptr(dev),
        )
    _check_launch("gossip_round_dense", rc, (r, d, k, slab_words, src))


def gossip_round_dense(exists, removed, neighbors, out=None):
    """K1. ``exists`` / ``removed``: ``int32[S, D]`` words (read as uint32);
    ``neighbors``: ``int32[R, K]``, ``R <= S``, with every entry in ``[0,
    S)`` (callers validate the table once, on the host). Row ``r < R`` of
    the result joins source row ``r`` with its K neighbour rows; source rows
    past R are read only as neighbours (a shard's ``[block | received]``
    buffer, ``S = B + H``, ``R = B``). Returns the joined ``[R, D]`` planes.

    ``out`` (CUDA only): a pair of ``int32[R, D]`` buffers to write into —
    the fused loops pass the buffers of the round before last, so two
    buffers ping-pong. They must not alias the inputs: the round reads
    the state from before the round."""
    if exists.device.type == "cpu":
        return gossip_round_dense_plain(exists, removed, neighbors)
    name = "gossip_round_dense"
    _require_cuda(name, exists, removed, neighbors)
    if exists.dim() != 2 or exists.shape != removed.shape:
        raise ValueError(
            f"{name}: planes must be [R, D] of one shape, got "
            f"{tuple(exists.shape)} and {tuple(removed.shape)}"
        )
    if exists.dtype != torch.int32 or removed.dtype != torch.int32:
        raise ValueError(f"{name}: planes must be int32 words")
    src, d = exists.shape
    if neighbors.dtype != torch.int32 or neighbors.dim() != 2 or not (
        neighbors.shape[0] <= src
    ):
        raise ValueError(f"{name}: neighbors must be int32[R, K] with R <= {src}")
    r, k = neighbors.shape
    if k > MAX_FANOUT:
        raise ValueError(f"{name}: fanout {k} exceeds {MAX_FANOUT}")
    if out is None:
        out_e = exists.new_empty((r, d))
        out_r = removed.new_empty((r, d))
    else:
        out_e, out_r = out
        _require_cuda(name, out_e, out_r)
        if out_e.shape != (r, d) or out_r.shape != (r, d) or (
            out_e.dtype != torch.int32 or out_r.dtype != torch.int32
        ):
            raise ValueError(f"{name}: out buffers must be int32[{r}, {d}]")
        inputs = {exists.data_ptr(), removed.data_ptr()}
        if out_e.data_ptr() in inputs or out_r.data_ptr() in inputs:
            raise ValueError(f"{name}: out buffers alias the input planes")
    vec = dense_vector_words(d, exists, removed, out_e, out_r)
    # the slab's span is taken over the S source rows, not the R rows
    # written: the K gathers of a slab reach any source row, so that span
    # is what ``DENSE_SLAB_BYTES`` caps
    _dense_launch(exists, removed, neighbors, out_e, out_r,
                  dense_slab_words(src, d, vec))
    return out_e, out_r


# ---------------------------------------------------------------------------
# K2 / K3: row-sparse frontier round
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowsPlan:
    """How one codec's state maps onto the row-sparse kernels."""

    kind: str  # "leafwise" (K2) | "vclock" (K3)
    op: "str | None" = None  # leafwise op ("or" | "max")


def rows_plan_of(codec, spec, states) -> "RowsPlan | None":
    """The kernel plan for ``codec``'s states, or None when this codec
    cannot ride the row-sparse kernels (its merge has other structure)."""
    del spec
    kind = getattr(codec, "leafwise_join", None)
    if kind in ("or", "max"):
        return RowsPlan(kind="leafwise", op=kind)
    if getattr(states, "_fields", None) == ("clock", "dots"):
        return RowsPlan(kind="vclock")
    return None


def _members(leaf) -> list:
    """The G member tensors ``[R, ...]`` of one leaf given as a ``[G, R,
    ...]`` tensor (views of it) or as the members themselves."""
    return list(leaf.unbind(0)) if isinstance(leaf, torch.Tensor) else list(leaf)


def _stacked(leaf) -> torch.Tensor:
    """One leaf as ``[G, R, ...]``: the plain versions' layout (stacking a
    member list copies it — fine for the CPU and for parity checks)."""
    return leaf if isinstance(leaf, torch.Tensor) else torch.stack(list(leaf))


def _is_cpu(leaf) -> bool:
    first = leaf if isinstance(leaf, torch.Tensor) else leaf[0]
    return first.device.type == "cpu"


def _join(op: str):
    return torch.bitwise_or if op == "or" else torch.maximum


def _gather_plan(neighbors, rows, edge_mask):
    """Shared index work of the plain versions: ``(g_idx [G, 1], rows
    [G, F], neighbour rows [G, F, K], live edges [G, F, K] or None)``."""
    rows = rows.long()
    g_idx = torch.arange(rows.shape[0], device=rows.device)[:, None]
    nb = neighbors.long()[rows]
    live = edge_mask[rows] if edge_mask is not None else None
    return g_idx, rows, nb, live


def gossip_round_rows_plain(op, leaves, neighbors, rows, edge_mask=None):
    """Plain PyTorch K2: for leaves ``[G, R, ...]`` (or G member lists) and
    ``rows: int[G, F]``, fold ``op`` over each slot's own row and its K
    neighbour rows in k order, skipping dead edges under ``edge_mask:
    bool[R, K]``. Returns ``(joined rows [G, F, ...] per leaf, changed:
    bool[G, F])`` with ``changed = any(acc != own)`` over every leaf."""
    join = _join(op)
    g_idx, rows, nb, live = _gather_plan(neighbors, rows, edge_mask)
    outs = []
    changed = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
    for leaf in map(_stacked, leaves):
        own = leaf[g_idx, rows]
        acc = own
        extra = (1,) * (own.dim() - 2)
        for k in range(nb.shape[-1]):
            merged = join(acc, leaf[g_idx, nb[..., k]])
            if live is None:
                acc = merged
            else:
                acc = torch.where(live[..., k].reshape(live.shape[:2] + extra),
                                  merged, acc)
        changed = changed | any_trailing(acc != own, own.dim() - 2)
        outs.append(acc)
    return outs, changed


def gossip_round_rows_vclock_plain(clock, dots, neighbors, rows, edge_mask=None):
    """Plain PyTorch K3: ``clock [G, R, A]``, ``dots [G, R, E, A]`` (or G
    member lists), ``rows: int[G, F]``; folds ``merge_dots`` over each
    slot's own row and its K neighbour rows in k order, skipping dead
    edges. Returns ``((clock [G, F, A], dots [G, F, E, A]), changed:
    bool[G, F])`` with ``changed = any(acc != own)`` over both leaves.

    Skipping a dead edge equals the XLA round's own-state substitution only
    on reachable states (``dots <= own clock`` pointwise), which is all a
    runtime ever holds."""
    clock, dots = _stacked(clock), _stacked(dots)
    g_idx, rows, nb, live = _gather_plan(neighbors, rows, edge_mask)
    own_c, own_d = clock[g_idx, rows], dots[g_idx, rows]
    ca, da = own_c, own_d
    for k in range(nb.shape[-1]):
        idx = nb[..., k]
        mc, md = merge_dots(ca, da, clock[g_idx, idx], dots[g_idx, idx])
        if live is None:
            ca, da = mc, md
        else:
            lk = live[..., k]
            ca = torch.where(lk[..., None], mc, ca)
            da = torch.where(lk[..., None, None], md, da)
    changed = any_trailing(ca != own_c, 1) | any_trailing(da != own_d, 2)
    return (ca, da), changed


#: the leaf dtypes and joins K2 has a kernel for (``int32`` ``"or"``:
#: packed words, int32 storage holding uint32 bits)
ROWS_JOINS = frozenset({(torch.bool, "or"), (torch.int32, "max"),
                        (torch.int32, "or")})


@functools.cache
def _rows_fn():
    fn = _build.library("gossip_round_rows").lasp_gossip_round_rows
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _vclock_fn():
    fn = _build.library("gossip_round_rows").lasp_gossip_round_rows_vclock
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class RowsSchedule(NamedTuple):
    """K2's launch: each lane of a team of ``team_lanes`` lanes loads
    ``vec_bytes`` of a leaf row at a time; a team owns one (member, slot)
    item and walks a row wider than ``team_lanes * vec_bytes`` in steps of
    that many bytes."""

    vec_bytes: int
    team_lanes: int


def rows_schedule(row_bytes: int, aligned: int) -> RowsSchedule:
    """K2's schedule for leaf rows of ``row_bytes`` bytes whose members and
    outputs all start on multiples of ``aligned`` bytes
    (:func:`address_alignment`): the widest vector of 16, 8, 4 or 1 bytes
    that divides both, so every row of every member and output starts on a
    vector; and the fewest lanes, a power of two, at most 32, whose vectors
    cover a row. Rows of int32 (4-byte aligned, 4-byte multiples) never go
    below 4 bytes, so ``max`` always folds whole int32 lanes."""
    vec = next(v for v in (16, 8, 4, 1) if row_bytes % v == 0 and aligned % v == 0)
    team = 1
    while team * vec < row_bytes and team < 32:
        team *= 2
    return RowsSchedule(vec, team)


#: the most bytes one stage of K3's shared-memory ring holds (the ring's
#: depth is the kernel's own, ``kStages`` in ``csrc/gossip_round_rows.cu``)
VCLOCK_STAGE_BYTES = 32 << 10


@dataclasses.dataclass(frozen=True)
class VclockSchedule:
    """K3's ring: ``bulk`` (1-D bulk copies,
    16-byte folds) or 4-byte ``cp.async`` copies; ``chunk_words`` dots words
    of each staged row a stage holds (the whole row when it fits)."""

    bulk: bool
    chunk_words: int


def vclock_schedule(n_actors: int, n_elems: int, k: int,
                    aligned: bool) -> VclockSchedule:
    """K3's schedule for ``clock [A]`` / ``dots [E, A]`` rows and fanout
    ``k``. Bulk copies need 16-byte multiples and addresses: ``A % 4 == 0``
    and ``aligned`` (every member's base 16-byte aligned); anything else
    takes the 4-byte path. A stage holds the K+1 clock rows and, per row, a
    chunk of its dots of at most :data:`VCLOCK_STAGE_BYTES` in all; a row
    wider than that is staged in chunks (multiples of 4 words). Raises
    ``ValueError`` when the K+1 clock rows alone leave no room."""
    clock_stride = -(-n_actors // 4) * 4
    room = VCLOCK_STAGE_BYTES // 4 // (k + 1) - clock_stride
    room -= room % 4
    if room < 4:
        raise ValueError(
            f"gossip_round_rows_vclock: {k + 1} clock rows of {n_actors} actors "
            f"leave no room for dots in a {VCLOCK_STAGE_BYTES}-byte stage"
        )
    row_words = n_elems * n_actors
    return VclockSchedule(bulk=aligned and n_actors % 4 == 0,
                          chunk_words=min(row_words, room))


def vclock_launch_schedule(clocks, dotss, k: int) -> VclockSchedule:
    """Checks K3's members (``clock int32[R, A]``, ``dots int32[R, E, A]``,
    one shape per leaf) and returns their schedule; alignment is read from
    the members' addresses."""
    c0, d0 = clocks[0], dotss[0]
    if c0.dtype != torch.int32 or d0.dtype != torch.int32 or c0.dim() != 2 or (
        d0.dim() != 3 or d0.shape[0] != c0.shape[0] or d0.shape[2] != c0.shape[1]
    ):
        raise ValueError(
            "gossip_round_rows_vclock: members need clock int32[R, A] and "
            "dots int32[R, E, A]"
        )
    aligned = address_alignment(*clocks, *dotss) == 16
    return vclock_schedule(d0.shape[2], d0.shape[1], k, aligned)


def _pointer_table(members):
    """Host array of the members' base pointers (the launchers copy it into
    a kernel parameter; no device table is allocated)."""
    return (ctypes.c_void_p * len(members))(*(m.data_ptr() for m in members))


def _rows_launch_args(name, member_leaves, neighbors, rows, edge_mask):
    """Checks shared by the K2 and K3 wrappers: one CUDA device, contiguous
    members of one dtype and row shape per leaf, ``rows [G, F]`` and an
    ``int32[N, K]`` table with ``N <= R`` member rows, a ``bool[N, K]``
    mask. A table shorter than the members serves a shard's ``[block |
    halo]`` buffer: the rows of the round are block rows (``< N``), the halo
    rows only neighbours, so they need no table rows (padding them with
    self-edges would cost ``H x K`` table entries a launch for rows no slot
    names). The kernels read int64 or
    int32 rows and the bytes of the mask as they are; only rows of another
    dtype are converted (a kernel of its own). Returns ``(device, rows int64
    or int32, mask uint8 view or None, G, R, F, K)``."""
    first = member_leaves[0][0]
    g = len(member_leaves[0])
    if rows.dtype not in (torch.int64, torch.int32):
        rows = rows.long()
    rows = rows.to(first.device).contiguous()
    mask = None
    if edge_mask is not None:
        if edge_mask.dtype != torch.bool or edge_mask.shape != neighbors.shape:
            raise ValueError(f"{name}: edge_mask must be bool{tuple(neighbors.shape)}")
        mask = edge_mask.to(first.device).contiguous().view(torch.uint8)
    flat = [m for leaf in member_leaves for m in leaf]
    dev = _require_cuda(
        name, *flat, neighbors, rows, *(() if mask is None else (mask,))
    )
    for leaf in member_leaves:
        if len(leaf) != g or any(
            m.dtype != leaf[0].dtype or m.shape != leaf[0].shape for m in leaf
        ):
            raise ValueError(f"{name}: members of a leaf must share dtype and shape")
    if g == 0 or first.dim() < 1 or rows.dim() != 2 or rows.shape[0] != g:
        raise ValueError(f"{name}: G members [R, ...] need rows [G, F]")
    r = first.shape[0]
    if neighbors.dtype != torch.int32 or neighbors.dim() != 2 or not (
        neighbors.shape[0] <= r
    ):
        raise ValueError(f"{name}: neighbors must be int32[N, K] with N <= {r}")
    return dev, rows, mask, g, r, rows.shape[1], neighbors.shape[1]


def gossip_round_rows(op, leaves, neighbors, rows, edge_mask=None):
    """K2. ``leaves``: one or two leaves, each a ``[G, R, ...]`` tensor or
    the G member tensors ``[R, ...]``, all of one dtype and row shape (bool
    for ``"or"``, int32 for ``"or"`` on packed words or ``"max"``);
    ``neighbors``: ``int32[R, K]``; ``rows: int[G, F]`` (pad slots may
    repeat a row; int64 and int32 are read as they are); ``edge_mask``:
    optional ``bool[R, K]``. Returns ``(joined rows [G, F, ...] per leaf,
    changed: bool[G, F])``. For CUDA tensors of those dtypes a call is one
    kernel launch (:func:`rows_schedule` picks its vectors and teams)."""
    if _is_cpu(leaves[0]):
        return gossip_round_rows_plain(op, leaves, neighbors, rows, edge_mask)
    name = "gossip_round_rows"
    if not 1 <= len(leaves) <= 2:
        raise ValueError(f"{name}: one or two leaves, got {len(leaves)}")
    members = [_members(leaf) for leaf in leaves]
    row_shape, dtype = tuple(members[0][0].shape[1:]), members[0][0].dtype
    if any(tuple(ms[0].shape[1:]) != row_shape or ms[0].dtype != dtype
           for ms in members):
        raise ValueError(f"{name}: leaves must share dtype and row shape")
    if (dtype, op) not in ROWS_JOINS:
        raise ValueError(f"{name}: no kernel for {dtype} leaves joined by {op!r}")
    dev, rows, mask, g, r, f, k = _rows_launch_args(
        name, members, neighbors, rows, edge_mask
    )
    width = math.prod(row_shape)
    outs = [torch.empty((g, f) + row_shape, dtype=dtype, device=dev) for _ in members]
    changed = torch.empty((g, f), dtype=torch.bool, device=dev)
    if f == 0 or width == 0:
        return outs, changed.zero_()
    row_bytes = width * members[0][0].element_size()
    sched = rows_schedule(row_bytes, address_alignment(
        *(m for ms in members for m in ms), *outs))
    with torch.cuda.device(dev):
        rc = _rows_fn()(
            0 if op == "or" else 1, sched.vec_bytes, sched.team_lanes,
            _pointer_table(members[0]), _pointer_table(members[-1]),
            outs[0].data_ptr(), outs[-1].data_ptr(), len(members),
            rows.data_ptr(), int(rows.dtype == torch.int64), neighbors.data_ptr(),
            None if mask is None else mask.data_ptr(), changed.data_ptr(),
            g, f, row_bytes, k, _stream_ptr(dev),
        )
    _check_launch(name, rc, (g, f, r, width, len(members), k,
                             str(dtype).removeprefix("torch."), op,
                             int(mask is not None), *sched))
    return outs, changed


def gossip_round_rows_vclock(clock, dots, neighbors, rows, edge_mask=None):
    """K3. ``clock``: ``int32[G, R, A]`` or G members ``[R, A]``; ``dots``:
    ``int32[G, R, E, A]`` or G members ``[R, E, A]``; ``neighbors``,
    ``rows`` and ``edge_mask`` as for K2. Returns ``((clock [G, F, A],
    dots [G, F, E, A]), changed: bool[G, F])``."""
    if _is_cpu(clock):
        return gossip_round_rows_vclock_plain(clock, dots, neighbors, rows, edge_mask)
    name = "gossip_round_rows_vclock"
    clocks, dotss = _members(clock), _members(dots)
    dev, rows, mask, g, r, f, k = _rows_launch_args(
        name, [clocks, dotss], neighbors, rows, edge_mask
    )
    sched = vclock_launch_schedule(clocks, dotss, k)
    n_elems, n_actors = dotss[0].shape[1], dotss[0].shape[2]
    out_c = torch.empty((g, f, n_actors), dtype=torch.int32, device=dev)
    out_d = torch.empty((g, f, n_elems, n_actors), dtype=torch.int32, device=dev)
    changed = torch.empty((g, f), dtype=torch.bool, device=dev)
    if f == 0 or n_elems * n_actors == 0:
        return (out_c, out_d), changed.zero_()
    with torch.cuda.device(dev):
        rc = _vclock_fn()(
            _pointer_table(clocks), _pointer_table(dotss),
            out_c.data_ptr(), out_d.data_ptr(), rows.data_ptr(),
            int(rows.dtype == torch.int64),
            neighbors.data_ptr(), None if mask is None else mask.data_ptr(),
            changed.data_ptr(), g, f, n_elems, n_actors, k, int(sched.bulk),
            sched.chunk_words, _stream_ptr(dev),
        )
    _check_launch(name, rc, (g, f, r, n_actors, n_elems, k, int(mask is not None),
                             int(sched.bulk), sched.chunk_words))
    return (out_c, out_d), changed


def rows_round(plan: RowsPlan, leaves, neighbors, rows, edge_mask=None):
    """The plan's kernel (K2 or K3) over ``leaves`` (a state's leaves, each
    stacked or as member lists): ``(joined rows per leaf, changed)``."""
    if plan.kind == "vclock":
        return gossip_round_rows_vclock(*leaves, neighbors, rows, edge_mask)
    return gossip_round_rows(plan.op, list(leaves), neighbors, rows, edge_mask)


def scatter_rows(leaf, rows, joined):
    """Write ``joined[g, f]`` back at row ``rows[g, f]`` of member g — the
    epilogue every row-sparse round owes. ``leaf`` is a ``[G, R, ...]``
    tensor (copied) or the G member tensors (written in place). Duplicate
    pad slots write identical values (the join is idempotent)."""
    rows = rows.long()
    if not isinstance(leaf, torch.Tensor):
        for member, r, j in zip(leaf, rows, joined):
            member[r] = j
        return leaf
    out = leaf.clone()
    g_idx = torch.arange(rows.shape[0], device=rows.device)[:, None]
    out[g_idx, rows] = joined
    return out


def cuda_gossip_round_rows_grouped(codec, spec, states, neighbors, rows,
                                   valid, edge_mask=None):
    """Twin of ``lasp_tpu.ops.pallas_gossip.pallas_gossip_round_rows_grouped``
    (and of ``mesh.gossip.gossip_round_rows_grouped``): ``states`` leaves
    ``[G, R, ...]``, ``rows: int[G, F]``, ``valid: bool[G, F]``; returns
    ``(new_states, changed: bool[G, F])``. The raw-inequality changed flag
    equals ``~codec.equal`` on reachable states (``removed`` is a subset of
    ``exists`` under every op and merge; OR-SWOT's ``equal`` is raw
    equality)."""
    plan = rows_plan_of(codec, spec, states)
    if plan is None:
        raise ValueError(
            f"{getattr(codec, 'name', codec)}: no row-sparse kernel plan "
            "(codec is neither leafwise nor a (clock, dots) pair)"
        )
    rows = torch.as_tensor(rows, device=states[0].device).long()
    joined, changed = rows_round(plan, states, neighbors, rows, edge_mask)
    new_states = type(states)(
        *(scatter_rows(leaf, rows, j) for leaf, j in zip(states, joined))
    )
    valid = torch.as_tensor(valid, dtype=torch.bool, device=changed.device)
    return new_states, changed & valid


def cuda_gossip_round_rows(codec, spec, states, neighbors, rows,
                           edge_mask=None, valid=None):
    """One ``[R, ...]`` population: the grouped round at G=1."""
    states_g = type(states)(*(x[None] for x in states))
    rows_g = torch.as_tensor(rows, device=states[0].device)[None]
    valid_g = (
        torch.ones(rows_g.shape, dtype=torch.bool, device=rows_g.device)
        if valid is None else torch.as_tensor(valid, device=rows_g.device)[None]
    )
    new_g, changed = cuda_gossip_round_rows_grouped(
        codec, spec, states_g, neighbors, rows_g, valid_g, edge_mask
    )
    return type(states)(*(x[0] for x in new_g)), changed[0]
