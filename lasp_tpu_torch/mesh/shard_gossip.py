"""Sharded gossip over a mesh of shard slots (port of
``lasp_tpu.mesh.shard_gossip``).

The population's replica axis splits into S contiguous blocks of
``B = R / S`` rows, one per shard. A shard's round reads only its own
block and the rows it received from other shards; every cross-shard read
goes through an explicit exchange step that moves only the rows a plan
names, and counts the rows and bytes it moved (:data:`EXCHANGED`). The
JAX package's collectives become:

- ``ppermute`` (ring rounds): the ``|off|``-row boundary slab copied from
  the adjacent shard's block (:func:`_shift_pull`);
- ``all_gather`` of the union buffer (``mode="gather"``): one ``[S, M]``
  buffer of every shard's ``send_idx`` rows, read by every shard;
- ``all_to_all`` (``mode="alltoall"``): one ``[S_owner, S_dest, M2]``
  buffer of per-destination slices, read transposed (destination ``d``
  reads ``buf[:, d]``);
- ``psum`` (the hierarchical converge): a sum of the per-shard residual
  partials on the device.

Every exchange goes through ``comm``'s collective layer. On a one-process
mesh every shard slot names one device: each block is a view ``[s·B,
(s+1)·B)`` of one population tensor and the collectives return their
input, so the exchange is the copy between blocks. On a process group's
mesh a process holds only its run of L shards (``comm.local_shards``): its
populations are ``[L·B, ...]``, the union buffer is an ``all_gather`` of
every process's send rows, the per-destination slices an ``all_to_all``,
the ring slabs a ``ppermute`` between neighbouring processes and the
residual partials an ``all_reduce``; the frontier round's changed flags are
all-gathered so every process's host frontier stays the same.

A shard's local round reads its ``[block | received]`` buffer through the
plan's combined index (``idx`` / ``idx2``: ``[0, B)`` the block, ``[B, B
+ H)`` the received rows): packed OR-Set planes through
the CUDA kernel K1 (a source of ``B + H`` rows, ``B`` rows written),
row-sparse frontier joins through K2 (leafwise codecs) and K3 (OR-SWOT) on
the same buffer; their plain versions on the CPU.

The host-side plan (``partitioned_gossip_plan``, ``sparse_exchange_tables``
and the accounting helpers) is numpy, copied from the JAX module, and equal
to it array for array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice.base import tree_leaves, tree_map
from ..ops import cuda_gossip
from . import comm
from .comm import Mesh, local_shards
from .gossip import _leafwise_op, _word_planes, join_all

#: rows and bytes every exchange kind moved since :func:`reset_exchange`;
#: ``rows`` counts state rows (all leaves of a row once), ``bytes`` the
#: bytes of every leaf, pad slots included (they are real buffer slots).
#: These are JAX's per-shard counts of the whole mesh, the same on every
#: process; what the process group carried is ``comm.CARRIED``
EXCHANGED = {
    kind: {"calls": 0, "rows": 0, "bytes": 0}
    for kind in ("ppermute", "all_gather", "all_to_all", "psum")
}


def reset_exchange() -> None:
    for ent in EXCHANGED.values():
        ent.update(calls=0, rows=0, bytes=0)
    comm.reset_carried()


def _row_nbytes(state) -> int:
    """Bytes of one replica row over every leaf of ``state`` (``[N, ...]``
    leaves)."""
    return sum(x[0].numel() * x.element_size() if x.shape[0] else 0
               for x in tree_leaves(state))


def _moved(kind: str, rows: int, row_bytes: int) -> None:
    ent = EXCHANGED[kind]
    ent["calls"] += 1
    ent["rows"] += int(rows)
    ent["bytes"] += int(rows) * int(row_bytes)


def ring_offsets(k: int) -> list[int]:
    """The offset sequence of ``topology.ring``: +1, -1, +2, -2, ..."""
    offsets: list[int] = []
    step = 1
    while len(offsets) < k:
        offsets.append(step)
        if len(offsets) < k:
            offsets.append(-step)
        step += 1
    return offsets


def _shift_pull(states, off: int, mesh: Mesh, axis="replicas"):
    """This process's blocks of a global pull-shift, ``result[r] =
    x[(r+off) % R]`` for a block-sharded leading axis: the local rows plus
    the ``|off|``-row boundary slab from the adjacent shard's block (shard
    ``i`` receives the head of ``i+1`` for ``off > 0``, the tail of ``i-1``
    for ``off < 0``); the slab of the shard past this process's run comes
    from the neighbouring process (``comm.ppermute``)."""
    n_dev = axis_extent(mesh, axis)
    _first, n_loc = local_shards(mesh, axis)
    r = tree_leaves(states)[0].shape[0]
    block = r // n_loc
    if block < abs(off):
        raise ValueError(
            f"ring offset {off} exceeds per-shard block of {block} "
            f"rows; lower k or use fewer devices"
        )
    m = abs(off)

    def one(x):
        blocks = x.reshape((n_loc, block) + tuple(x.shape[1:]))
        if off > 0:
            heads = blocks[:, :m]  # [L, off]: i <- i+1
            recv = torch.cat([heads[1:], comm.ppermute(heads[:1], mesh, 1)])
            out = torch.cat([blocks[:, m:], recv], dim=1)
        else:
            tails = blocks[:, -m:]  # [L, m]: i <- i-1
            recv = torch.cat([comm.ppermute(tails[-1:], mesh, -1), tails[:-1]])
            out = torch.cat([recv, blocks[:, :-m]], dim=1)
        return out.reshape(x.shape)

    out = tree_map(one, states)
    _moved("ppermute", n_dev * m, _row_nbytes(states))
    return out


def ring_gossip_round_fn(codec, spec, mesh: Mesh, k: int = 2,
                         axis: str = "replicas"):
    """``states -> states``: ONE ring-gossip round with explicit boundary
    slabs, equal to ``gossip_round(codec, spec, states, ring(R, k))`` for
    block-sharded states; a shard's block must hold at least the largest
    slab (``ceil(k / 2)`` rows)."""
    offsets = ring_offsets(k)

    def round_fn(states):
        acc = states
        for off in offsets:
            acc = codec.merge(spec, acc, _shift_pull(states, off, mesh, axis))
        return acc

    return round_fn


def _changed_any(codec, spec, a, b, mesh: Mesh) -> torch.Tensor:
    """0-d bool: some row of ``b`` differs from ``a`` by ``codec.equal``,
    on any process."""
    changed = ~torch.all(codec.equal(spec, a, b))
    if not mesh.cross_process:
        return changed
    return comm.all_reduce(changed.to(torch.int32).reshape(1), mesh, "max")[0] > 0


def ring_gossip_rounds(codec, spec, states, mesh: Mesh, n_rounds: int,
                       k: int = 2, axis: str = "replicas"):
    """``n_rounds`` ring rounds; returns ``(new_states, changed)`` (0-d
    bool: some row changed over the rounds)."""
    round_fn = ring_gossip_round_fn(codec, spec, mesh, k=k, axis=axis)
    out = states
    for _ in range(n_rounds):
        out = round_fn(out)
    return out, _changed_any(codec, spec, states, out, mesh)


def sharded_join_all(codec, spec, states, mesh: Mesh, axis: str = "replicas",
                     block: "int | None" = None):
    """Coverage / quorum merge of a block-sharded population (this
    process's blocks): each shard folds its block to one state, ONE gather
    moves the S partials (one row a shard, not the population) and a fold
    joins them in shard order, so every process gets the same bits. Equal
    to :func:`.gossip.join_all`. ``block``: a shard's rows, where the
    population does not divide over the shards (the last runs are short or
    empty; an empty shard's partial is the lattice bottom)."""
    n_dev = axis_extent(mesh, axis)
    _first, n_loc = local_shards(mesh, axis)
    lead = tree_leaves(states)[0]
    r = lead.shape[0]
    if block is None:
        if r % n_loc:
            raise ValueError(f"{r} replicas do not divide over {n_loc} shards")
        block = r // n_loc
    b = block
    tops = [
        join_all(codec, spec, tree_map(lambda x, s=s: x[s * b:(s + 1) * b], states))
        if s * b < r else codec.new(spec, device=lead.device)
        for s in range(n_loc)
    ]
    gathered = tree_map(lambda *xs: comm.all_gather(torch.stack(xs), mesh), *tops)
    _moved("all_gather", n_dev, _row_nbytes(gathered))
    return join_all(codec, spec, gathered)


def partitioned_gossip_plan(neighbors, n_shards: int) -> dict:
    """Host-side boundary-exchange plan for an irregular topology under a
    block sharding (pair with ``topology.locality_order`` for a small
    cut). Each shard contributes only the rows some OTHER shard
    references, and a combined index reads each neighbour from the local
    block or the received rows, so the exchange scales with the cut, not
    the population.

    Returns ``{"send_idx": int32[S, M] (block-local row ids, pad 0),
    "idx": int32[R, K] (combined index: [0, B) local block, [B, B+S*M)
    union-buffer position), "send2_idx": int32[S, S, M2] (owner s's rows
    for destination t, pad 0), "idx2": int32[R, K] (against [0, B) local |
    [B, B+S*M2) received), "n_shards", "block", "m", "m2", "cut_rows",
    "cut_pos", "pair_rows", "pair_dst", "pair_pos", "boundary_mask",
    "stats"}`` — JAX's plan, array for array."""
    nbrs = np.asarray(neighbors).astype(np.int64)
    R, K = nbrs.shape
    if R % n_shards:
        raise ValueError(f"{R} replicas do not divide over {n_shards} shards")
    B = R // n_shards
    src_shard = (np.arange(R) // B)[:, None]  # [R, 1]
    owner = nbrs // B  # [R, K]
    cross = owner != src_shard
    send_rows = np.unique(nbrs[cross]) if cross.any() else np.empty(0, np.int64)
    per_owner = np.bincount(send_rows // B, minlength=n_shards)
    m = max(int(per_owner.max()) if len(send_rows) else 0, 1)
    send_idx = np.zeros((n_shards, m), dtype=np.int64)
    pos_of = np.zeros(R, dtype=np.int64)  # buffer position of each sent row
    for s in range(n_shards):
        rows = send_rows[send_rows // B == s]
        send_idx[s, : len(rows)] = rows - s * B
        pos_of[rows] = np.arange(len(rows)) + s * m
    idx = np.where(cross, B + pos_of[nbrs], nbrs - src_shard * B)

    # per-destination (all-to-all) tables: unique (row, needing-shard)
    # pairs, grouped by (owner, destination) with stable in-group order,
    # so destination t's received buffer lays out as [owner s][slot p]
    need_rows = nbrs[cross]
    need_dst = np.broadcast_to(src_shard, nbrs.shape)[cross]
    pair_keys = np.unique((need_rows * n_shards + need_dst))
    p_rows = pair_keys // n_shards
    p_dst = pair_keys % n_shards
    p_owner = p_rows // B
    group = p_owner * n_shards + p_dst  # sort key: (owner, destination)
    order = np.argsort(group * (R + 1) + p_rows, kind="stable")
    p_rows, p_dst, p_owner, group = (
        p_rows[order], p_dst[order], p_owner[order], group[order]
    )
    counts2 = np.bincount(group, minlength=n_shards * n_shards)
    offd = counts2.copy()
    offd[np.arange(n_shards) * (n_shards + 1)] = 0  # diagonal is free
    m2 = max(int(offd.max()), 1)
    starts = np.zeros(n_shards * n_shards + 1, dtype=np.int64)
    np.cumsum(counts2, out=starts[1:])
    send2_idx = np.zeros((n_shards, n_shards, m2), dtype=np.int64)
    slot = np.arange(len(p_rows)) - starts[group]
    keep = slot < m2  # diagonal groups may exceed m2; they are never read
    send2_idx[p_owner[keep], p_dst[keep], slot[keep]] = (
        p_rows[keep] - p_owner[keep] * B
    )
    # receiving shard t reads row g (owner s) at B + s*m2 + slot
    sorted_keys = group * (R + 1) + p_rows
    edge_keys = (
        (owner * n_shards + src_shard) * (R + 1) + nbrs
    )  # per cross edge: its (owner, MY shard, row) key
    pos = np.searchsorted(sorted_keys, edge_keys)
    flat2 = B + owner * m2 + (pos - starts[owner * n_shards + src_shard])
    idx2 = np.where(cross, flat2, nbrs - src_shard * B)

    # the sparse exchange's static layout: the cut's rows and their
    # union-buffer positions, the (owner, destination) pairs and their
    # receive-halo positions; boundary_mask marks rows with a
    # cross-shard neighbour (the interior / boundary split)
    pair_rows = p_rows[keep]
    pair_dst = p_dst[keep]
    pair_pos = p_owner[keep] * m2 + slot[keep]
    boundary_mask = cross.any(axis=1)

    stats = {
        "n_replicas": R,
        "n_shards": n_shards,
        "edges": int(R * K),
        "cross_edges": int(cross.sum()),
        "send_rows": int(len(send_rows)),
        "max_send": int(per_owner.max()) if len(send_rows) else 0,
        "allgather_rows_per_round": R,
        "exchange_rows_per_round": n_shards * (
            int(per_owner.max()) if len(send_rows) else 0
        ),
    }
    stats["m2"] = m2
    stats["alltoall_rows_per_round"] = n_shards * m2
    # the cut IS the exchange's wire cost: a bad (non-locality-ordered)
    # renumbering shows in a scrape
    from ..telemetry import events as tel_events
    from ..telemetry import gauge

    gauge(
        "gossip_partition_cut_rows",
        help="distinct rows some other shard references (the cut)",
    ).set(stats["send_rows"])
    gauge(
        "gossip_partition_cross_edges",
        help="neighbor-table edges crossing a shard boundary",
    ).set(stats["cross_edges"])
    tel_events.emit(
        "membership", kind="partition_plan", n_shards=int(n_shards),
        cut_rows=int(stats["send_rows"]),
        cross_edges=int(stats["cross_edges"]),
    )
    return {
        "send_idx": send_idx.astype(np.int32),
        "idx": idx.astype(np.int32),
        "send2_idx": send2_idx.astype(np.int32),
        "idx2": idx2.astype(np.int32),
        "n_shards": n_shards,
        "block": B,
        "m": m,
        "m2": m2,
        "cut_rows": send_rows.astype(np.int64),
        "cut_pos": pos_of[send_rows].astype(np.int64),
        "pair_rows": pair_rows.astype(np.int64),
        "pair_dst": pair_dst.astype(np.int64),
        "pair_pos": pair_pos.astype(np.int64),
        "boundary_mask": boundary_mask,
        "stats": stats,
    }


def alltoall_mode(mode: str) -> bool:
    if mode not in ("gather", "alltoall"):
        raise ValueError(f"unknown partitioned gossip mode {mode!r}")
    return mode == "alltoall"


def _check_plan(plan: dict, mesh: Mesh, axis) -> None:
    if plan["n_shards"] != axis_extent(mesh, axis):
        # a mismatched plan would read every block at the wrong offsets
        raise ValueError(
            f"plan was built for {plan['n_shards']} shards but mesh axis "
            f"{axis!r} has {axis_extent(mesh, axis)} devices — rebuild "
            "the plan"
        )


def _owner_rows(table: torch.Tensor, block: int) -> torch.Tensor:
    """Population row ids (int64, flat) of a send table whose leading
    axis is the owning shard and whose entries are block-local."""
    s = table.shape[0]
    base = torch.arange(s, device=table.device, dtype=torch.int64) * block
    base = base.reshape((s,) + (1,) * (table.dim() - 1))
    return (table.long() + base).reshape(-1)


def _to_destinations(buf, n_loc: int, mesh: Mesh):
    """The per-destination exchange of one leaf: ``buf`` ``[L_owner,
    S_dest, M2, ...]`` (this process's owners' slices for every
    destination) -> ``[L_dest, S_owner * M2, ...]`` (what each local
    destination receives from every owner, owner-major). The slices travel
    process-major through ``comm.all_to_all``."""
    tail = tuple(buf.shape[3:])
    s, m2 = buf.shape[1], buf.shape[2]
    n_proc = s // n_loc
    wire = buf.reshape((n_loc, n_proc, n_loc, m2) + tail).transpose(0, 1)
    got = comm.all_to_all(wire.reshape((-1,) + tail), mesh)
    got = got.reshape((s, n_loc, m2) + tail)  # [S_owner, L_dest, M2]
    return got.transpose(0, 1).reshape((n_loc, s * m2) + tail)


def _exchange(state, send_tbl: torch.Tensor, plan: dict, alltoall: bool,
              mesh: Mesh, first: int, n_loc: int):
    """The dense exchange of one population (this process's ``[L·B, ...]``
    blocks): per leaf, the rows every local shard receives — gather mode
    ``[H, ...]`` (the union buffer, the same for every shard, H = S*M),
    alltoall mode ``[L, H2, ...]`` (each local destination's slices from
    every owner, H2 = S*M2)."""
    S, B = plan["n_shards"], plan["block"]
    comm.pack_begin()
    rows = _owner_rows(send_tbl[first:first + n_loc], B)
    if alltoall:
        m2 = send_tbl.shape[2]
        recv = tree_map(
            lambda x: _to_destinations(
                x.index_select(0, rows).reshape((n_loc, S, m2) + tuple(x.shape[1:])),
                n_loc, mesh),
            state,
        )
        _moved("all_to_all", S * S * m2, _row_nbytes(state))
        return recv
    m = send_tbl.shape[1]
    recv = tree_map(
        lambda x: comm.all_gather(
            x.index_select(0, rows).reshape((n_loc, m) + tuple(x.shape[1:])), mesh
        ).reshape((S * m,) + tuple(x.shape[1:])),
        state,
    )
    _moved("all_gather", S * m, _row_nbytes(state))
    return recv


def _full(x, recv, n_loc: int, alltoall: bool):
    """``[L, B + H, ...]``: every local shard's ``[block | received]``
    buffer."""
    blocks = x.reshape((n_loc, x.shape[0] // n_loc) + tuple(x.shape[1:]))
    if not alltoall:
        recv = recv.unsqueeze(0).expand((n_loc,) + tuple(recv.shape))
    return torch.cat([blocks, recv], dim=1)


def _exchange_round(codec, spec, plan: dict, mode: str, mesh: Mesh, axis):
    """The round body every partitioned entry shares: ``one(state,
    send_tbl, idx) -> state`` for one population (this process's ``[L·B,
    ...]`` blocks). The exchange moves the plan's rows, then each local
    shard joins its block's rows with their K neighbours from its ``[block
    | received]`` buffer in k order through the combined index ``idx``
    (``int32[R, K]``, shard s's rows ``[s·B, (s+1)·B)``). Packed OR-Set
    planes run K1 once a shard."""
    alltoall = alltoall_mode(mode)
    B = plan["block"]
    first, n_loc = local_shards(mesh, axis)
    op = _leafwise_op(codec)

    def one(state, send_tbl, idx):
        recv = _exchange(state, send_tbl, plan, alltoall, mesh, first, n_loc)
        full = tree_map(lambda x, g: _full(x, g, n_loc, alltoall), state, recv)
        if op is not None and _word_planes(codec, state):
            out_e = torch.empty_like(state.exists).reshape(n_loc, B, -1)
            out_r = torch.empty_like(state.removed).reshape(n_loc, B, -1)
            fe = full.exists.reshape(n_loc, full.exists.shape[1], -1)
            fr = full.removed.reshape(n_loc, full.removed.shape[1], -1)
            cuda = fe.device.type == "cuda"
            for sl in range(n_loc):
                s = first + sl
                nb = idx[s * B:(s + 1) * B]
                e2, r2 = cuda_gossip.gossip_round_dense(
                    fe[sl], fr[sl], nb, out=(out_e[sl], out_r[sl]) if cuda else None
                )
                if not cuda:
                    out_e[sl], out_r[sl] = e2, r2
            return type(state)(out_e.reshape(state.exists.shape),
                               out_r.reshape(state.removed.shape))
        sidx = torch.arange(n_loc, device=idx.device)[:, None]
        nb = idx[first * B:(first + n_loc) * B].long().reshape(n_loc, B, -1)
        if op is not None:

            def leaf(f):
                acc = f[:, :B]
                for k in range(nb.shape[2]):
                    acc = op(acc, f[sidx, nb[:, :, k]])
                return acc.reshape((n_loc * B,) + tuple(f.shape[2:]))

            return tree_map(leaf, full)
        acc = state
        for k in range(nb.shape[2]):
            nbr = tree_map(
                lambda f, _k=k: f[sidx, nb[:, :, _k]].reshape(
                    (n_loc * B,) + tuple(f.shape[2:])), full
            )
            acc = codec.merge(spec, acc, nbr)
        return acc

    return one


def partitioned_gossip_round_fn(codec, spec, mesh: Mesh, plan: dict,
                                axis="replicas", mode: str = "gather"):
    """``(states, send_tbl, idx_tbl) -> states``: ONE gossip round of an
    irregular topology through the boundary exchange of ``plan``, equal
    to ``gossip_round(codec, spec, states, neighbors)`` (on a process
    group's mesh, to its rows of this process's blocks). ``mode="gather"``
    moves the union buffer (tables ``send_idx`` / ``idx``),
    ``"alltoall"`` the per-destination slices (``send2_idx`` / ``idx2``);
    :func:`partition_tables` makes them."""
    _check_plan(plan, mesh, axis)
    one = _exchange_round(codec, spec, plan, mode, mesh, axis)
    return one


def _grouped_exchange_local(codec, spec, plan: dict, mode: str, mesh: Mesh,
                            axis="replicas"):
    """The body of ONE grouped boundary-exchange round: ``local(members,
    send_tbl, idx) -> members`` over a dispatch-plan group's member
    populations, each where it lies (no ``[G, R, ...]`` stack). Shared by
    :func:`partitioned_gossip_round_grouped` and
    :func:`partitioned_converge_fn`, as in JAX: a round-rule change cannot
    diverge the two."""
    one = _exchange_round(codec, spec, plan, mode, mesh, axis)

    def local(members, send_tbl, idx):
        return [one(m, send_tbl, idx) for m in members]

    return local


def partitioned_gossip_round_grouped(codec, spec, mesh: Mesh, plan: dict,
                                     axis="replicas", mode: str = "gather"):
    """Grouped twin of :func:`partitioned_gossip_round_fn`: ``(states,
    send_tbl, idx_tbl) -> states`` over ``[G, R, ...]`` leaves, each member
    bit-identical to the ungrouped round."""
    _check_plan(plan, mesh, axis)
    alltoall_mode(mode)
    local = _grouped_exchange_local(codec, spec, plan, mode, mesh, axis)

    def run(states, send_tbl, idx):
        g = tree_leaves(states)[0].shape[0]
        members = [tree_map(lambda x, i=i: x[i], states) for i in range(g)]
        out = local(members, send_tbl, idx)
        return tree_map(lambda *xs: torch.stack(xs), *out)

    return run


# ---------------------------------------------------------------------------
# sparse boundary exchange: the sharded-frontier path
# ---------------------------------------------------------------------------
#
# The dense partitioned round re-ships the whole cut every round. The
# sparse exchange ships only the cut rows that are frontier-dirty,
# bucket-padded; every variable keeps a HALO of the boundary rows'
# last-shipped values at exactly the positions the combined index tables
# read. After the scatter, halo[p] holds the current value of cut row p
# (dirty rows were just shipped, clean rows have not changed since), so
# the joins read what the dense exchange would. The runtime owns the halo
# lifecycle: a fresh halo ships the full cut once, and every path that
# changes rows without frontier knowledge drops the halos.


def _pow2_bucket(n: int, floor: int, cap: int) -> int:
    """Power-of-two padded bucket for ``n`` slots (one kernel shape per
    band, not per distinct count), capped at the dense extent."""
    b = max(int(floor), 1)
    while b < n:
        b <<= 1
    return max(min(b, int(cap)), int(n), 1)


def sparse_exchange_tables(plan: dict, mode: str, dirty=None,
                           min_bucket: int = 8) -> dict:
    """Host-side payload tables for one sparse boundary exchange: which
    cut rows ship this round (``dirty: bool[R]``, None = the full cut, the
    fresh-halo resync) and where they land in the receive halo.

    Returns ``{"pay_slot", "pay_pos", "bucket", "payload_rows",
    "real_rows", "halo_len", "dense_rows"}``; ``payload_rows`` is the
    padded row count the exchange moves and ``dense_rows`` the dense cut
    plane's under the same convention.

    - gather: ``pay_slot int32[S, D]`` (block-local ids of shard s's
      dirty cut rows, pad 0), ``pay_pos int32[S, D]`` (union-buffer
      positions; pad = halo_len, dropped at the scatter).
    - alltoall: ``pay_slot int32[S, S, D2]`` (owner-major
      per-destination slices), ``pay_pos int32[S, S, D2]``
      (receiver-major positions into the destination's own halo; pad =
      halo_len)."""
    B = plan["block"]
    S = plan["n_shards"]
    if alltoall_mode(mode):
        pr, pd, pp = plan["pair_rows"], plan["pair_dst"], plan["pair_pos"]
        m2 = plan["m2"]
        halo_len = S * m2
        if dirty is not None:
            sel = np.asarray(dirty, bool)[pr]
            pr, pd, pp = pr[sel], pd[sel], pp[sel]
        owner = pr // B
        key = owner * S + pd
        order = np.argsort(key, kind="stable")
        pr, pd, pp, owner, key = (
            pr[order], pd[order], pp[order], owner[order], key[order]
        )
        counts = np.bincount(key, minlength=S * S)
        need = int(counts.max()) if len(pr) else 0
        bucket = _pow2_bucket(need, min_bucket, m2)
        starts = np.zeros(S * S + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        j = np.arange(len(pr)) - starts[key]
        pay_slot = np.zeros((S, S, bucket), dtype=np.int32)
        pay_pos = np.full((S, S, bucket), halo_len, dtype=np.int32)
        pay_slot[owner, pd, j] = (pr - owner * B).astype(np.int32)
        pay_pos[pd, owner, j] = pp.astype(np.int32)
        return {
            "pay_slot": pay_slot,
            "pay_pos": pay_pos,
            "bucket": int(bucket),
            "payload_rows": int(S * S * bucket),
            "real_rows": int(len(pr)),
            "halo_len": int(halo_len),
            "dense_rows": int(S * S * m2),
        }
    cut_rows, cut_pos = plan["cut_rows"], plan["cut_pos"]
    m = plan["m"]
    halo_len = S * m
    if dirty is not None:
        sel = np.asarray(dirty, bool)[cut_rows]
        cut_rows, cut_pos = cut_rows[sel], cut_pos[sel]
    owner = cut_rows // B
    counts = np.bincount(owner, minlength=S)
    need = int(counts.max()) if len(cut_rows) else 0
    bucket = _pow2_bucket(need, min_bucket, m)
    starts = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    j = np.arange(len(cut_rows)) - starts[owner]
    pay_slot = np.zeros((S, bucket), dtype=np.int32)
    pay_pos = np.full((S, bucket), halo_len, dtype=np.int32)
    pay_slot[owner, j] = (cut_rows - owner * B).astype(np.int32)
    pay_pos[owner, j] = cut_pos.astype(np.int32)
    return {
        "pay_slot": pay_slot,
        "pay_pos": pay_pos,
        "bucket": int(bucket),
        "payload_rows": int(S * bucket),
        "real_rows": int(len(cut_rows)),
        "halo_len": int(halo_len),
        "dense_rows": int(S * m),
    }


def make_halo(states, plan: dict, mode: str, mesh: "Mesh | None" = None,
              axis="replicas"):
    """A zero boundary halo for one population: gather mode one union
    buffer ``[H, ...]`` (H = S*m) that every shard reads, alltoall mode
    each local shard's own receive buffer ``[L, H2, ...]`` (H2 = S*m2; L =
    S without a ``mesh`` or on a one-process mesh). Zeros are safe: the
    runtime ships the full cut on a fresh halo's first round, so every
    position a join reads is written first."""
    S = plan["n_shards"]
    if alltoall_mode(mode):
        h2 = S * plan["m2"]
        n_loc = local_shards(mesh, axis)[1] if mesh is not None else S
        return tree_map(
            lambda x: torch.zeros((n_loc, h2) + tuple(x.shape[1:]), dtype=x.dtype,
                                  device=x.device),
            states,
        )
    h = S * plan["m"]
    return tree_map(
        lambda x: torch.zeros((h,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device),
        states,
    )


def _member_rows_join(codec, spec, k_cols: int):
    """One member's row join for a codec with no row-sparse kernel plan:
    ``(src, block, rows, nbr_idx) -> (new_rows, changed)`` — gather
    ``rows``' pre-round states from ``block`` and their K neighbours from
    ``src`` (the block for interior rows, ``[block | halo]`` for boundary
    rows), fold the join in k order, flag raw inequality."""
    leaf_op = _leafwise_op(codec)

    def join(src, block, rows, nbr_idx):
        old = tree_map(lambda x: x[rows], block)
        if leaf_op is not None:

            def leaf(xs, o):
                acc = o
                for k in range(k_cols):
                    acc = leaf_op(acc, xs[nbr_idx[:, k]])
                return acc

            new = tree_map(leaf, src, old)
        else:
            acc = old
            for k in range(k_cols):
                nbr = tree_map(lambda x, _k=k: x[nbr_idx[:, _k]], src)
                acc = codec.merge(spec, acc, nbr)
            new = acc
        return new, ~codec.equal(spec, old, new)

    return join


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def partitioned_frontier_round_fn(codec, spec, mesh: Mesh, plan: dict,
                                  axis="replicas", mode: str = "gather",
                                  n_g: int = 1):
    """The sparse boundary-exchange frontier round of one dispatch-plan
    group (``n_g`` same-codec members; singletons ride as G=1):

    ``fn(states_tuple, halo_tuple, pay_slot, pay_pos, rows_i, valid_i,
    rows_b, valid_b, idx_tbl) -> (states_tuple, halo_tuple, changed_i:
    bool[S, G, Fi], changed_b: bool[S, G, Fb])``

    ``rows_*`` / ``valid_*`` are each shard's members' frontier-reachable
    rows (block-local ids, bucket-padded, valid slots first; every shard's,
    the host plan being the same on every process), split
    INTERIOR (every neighbour in the block) and BOUNDARY (some neighbour
    in the halo). The dirty cut rows are exchanged first and scattered
    into the halos; then each shard joins its interior rows from its
    block and its boundary rows from its ``[block | halo]`` buffer (K2 or
    K3 at G members, their plain versions on the CPU), every join reading
    pre-round state; the joined valid rows are written back into the
    member populations in place. Pad slots are never written. Equal to
    the dense partitioned round by the frontier-reach and halo
    invariants. The payload tables and rows come from the host (numpy),
    which also knows the valid slots, so no scatter target is filtered on
    the device. On a process group's mesh the states and halos are this
    process's, it joins its own shards' rows, and the changed flags come
    back all-gathered, every shard's on every process."""
    _check_plan(plan, mesh, axis)
    alltoall = alltoall_mode(mode)
    S, B = plan["n_shards"], plan["block"]
    first, n_loc = local_shards(mesh, axis)
    k_cols = (plan["idx2"] if alltoall else plan["idx"]).shape[1]
    plain_join = _member_rows_join(codec, spec, k_cols)

    def run(states_tuple, halo_tuple, pay_slot, pay_pos, rows_i, valid_i,
            rows_b, valid_b, idx_tbl):
        members = list(states_tuple)
        halos = list(halo_tuple)
        if len(members) != n_g or len(halos) != n_g:
            raise ValueError(f"expected {n_g} members and halos")
        dev = idx_tbl.device
        slot = _host(pay_slot)
        pos = _host(pay_pos)
        # 1) the dirty cut rows of this process's owners onto the wire:
        #    one payload buffer per member leaf, pad slots included
        comm.pack_begin()
        src_rows = _owner_rows(torch.as_tensor(slot[first:first + n_loc],
                                               device=dev), B)
        if alltoall:
            d2 = slot.shape[2]
            # local destination dl's slice from owner o, slot j arrives at
            # received row (dl*S + o)*D2 + j and lands at its halo position
            # pos[d, o, j]
            d_i, o_i, j_i = np.nonzero(pos[first:first + n_loc] < S * plan["m2"])
            buf_at = (d_i * S + o_i) * d2 + j_i
            halo_at = d_i * (S * plan["m2"]) + pos[d_i + first, o_i, j_i]
            n_rows, kind = S * S * d2, "all_to_all"

            def wire(x):
                tail = tuple(x.shape[1:])
                return _to_destinations(
                    x.reshape((n_loc, S, d2) + tail), n_loc, mesh
                ).reshape((-1,) + tail)
        else:
            s_i, j_i = np.nonzero(pos < S * plan["m"])
            buf_at = s_i * slot.shape[1] + j_i
            halo_at = pos[s_i, j_i]
            n_rows, kind = slot.size, "all_gather"

            def wire(x):
                tail = tuple(x.shape[1:])
                return comm.all_gather(
                    x.reshape((n_loc, -1) + tail), mesh).reshape((-1,) + tail)
        buf_at = torch.as_tensor(buf_at, dtype=torch.int64, device=dev)
        halo_at = torch.as_tensor(halo_at, dtype=torch.int64, device=dev)
        # 2) halo scatter: every cut position now holds its row's current
        #    value
        for m, h in zip(members, halos):
            payload = tree_map(lambda x: wire(x.index_select(0, src_rows)), m)
            _moved(kind, n_rows, _row_nbytes(m))

            def land(hx, px):
                flat = hx.reshape((-1,) + tuple(px.shape[1:]))
                flat.index_copy_(0, halo_at, px.index_select(0, buf_at))

            tree_map(land, h, payload)
        # 3) the joins of every shard, reading pre-round state
        ri_h, vi_h = _host(rows_i), _host(valid_i).astype(bool)
        rb_h, vb_h = _host(rows_b), _host(valid_b).astype(bool)
        f_i = ri_h.shape[2]
        # this process's shards' flags, interior and boundary side by side
        flags = torch.zeros((n_loc, n_g, f_i + rb_h.shape[2]), dtype=torch.bool,
                            device=dev)
        ch_i, ch_b = flags[:, :, :f_i], flags[:, :, f_i:]
        writes: list = [[] for _ in range(n_g)]  # per member: (rows, joined)
        kplan = cuda_gossip.rows_plan_of(codec, spec, members[0])
        for sl in range(n_loc):
            s = first + sl
            nb = idx_tbl[s * B:(s + 1) * B]
            blocks = [tree_map(lambda x: x[sl * B:(sl + 1) * B], m) for m in members]
            for rows_h, valid_h, changed, src_of in (
                (ri_h, vi_h, ch_i, lambda g: blocks[g]),
                (rb_h, vb_h, ch_b, lambda g: tree_map(
                    lambda b, h: torch.cat(
                        [b, h[sl] if alltoall else h], dim=0),
                    blocks[g], halos[g])),
            ):
                n_valid = valid_h[s].sum(axis=1)
                if not n_valid.any():
                    continue
                # pad slots read a valid row of this launch: a pad's row 0
                # may be a boundary row, whose halo neighbours lie outside
                # an interior launch's block (the kernels check no bounds)
                rows_s = rows_h[s].astype(np.int64)
                rows_s[~valid_h[s]] = rows_s[valid_h[s]][0]
                rows = torch.as_tensor(rows_s, device=dev)
                srcs = [src_of(g) for g in range(n_g)]
                if kplan is not None:
                    leaves = [list(ls) for ls in zip(*(tree_leaves(x) for x in srcs))]
                    joined, ch = cuda_gossip.rows_round(kplan, leaves, nb, rows)
                    per_member = [
                        (tuple(j[g] for j in joined), ch[g]) for g in range(n_g)
                    ]
                else:
                    nbl = nb.long()
                    per_member = [
                        plain_join(srcs[g], blocks[g], rows[g], nbl[rows[g]])
                        for g in range(n_g)
                    ]
                changed[sl] = torch.stack([c for _j, c in per_member]) & torch.as_tensor(
                    valid_h[s], device=dev)
                for g, (joined_g, _c) in enumerate(per_member):
                    n = int(n_valid[g])
                    if n:
                        writes[g].append((rows_h[s, g, :n] + sl * B,
                                          [x[:n] for x in tree_leaves(joined_g)]))
        # 4) epilogue: the joined valid rows written back in place (valid
        #    rows are unique and interior / boundary disjoint)
        for m, ws in zip(members, writes):
            if not ws:
                continue
            tgt = torch.as_tensor(np.concatenate([r for r, _v in ws]),
                                  dtype=torch.int64, device=dev)
            for li, x in enumerate(tree_leaves(m)):
                x.index_copy_(0, tgt, torch.cat([v[li] for _r, v in ws]))
        flags = comm.all_gather(flags, mesh)  # [S, G, Fi + Fb]
        return tuple(members), tuple(halos), flags[:, :, :f_i], flags[:, :, f_i:]

    return run


def partitioned_converge_fn(groups, mesh: Mesh, plan: dict,
                            axis="replicas", mode: str = "gather",
                            window: int = 8, flight_rounds: int = 0,
                            count_rounds=None):
    """The sharded ``converge_on_device``: boundary-exchange rounds to the
    store-wide fixed point with quiescence found by a HIERARCHICAL
    residual reduction. Each round every shard's per-member changed-row
    count in its block lands in a ``[window, S, V]`` partials tensor on the
    device (no cross-shard step); every ``window`` rounds ONE sum over the
    shard axis (the ``psum``) gives the global per-round residuals, and
    the host reads them once: the loop stops at the first zero round.
    Unexecuted slots of a short last window keep the sentinel 1 a shard.
    The count (final quiescent round included) equals the host loop's; up
    to ``window - 1`` no-op rounds may run past the fixed point.

    ``groups``: ``(codec, spec, n_members)`` per dispatch-plan group.
    Returns ``fn(member_states, send_tbl, idx_tbl, max_rounds) ->
    (member_states, signed_rounds)`` (positive = exact rounds to
    quiescence, negative = budget exhausted after ``-rounds``), and with
    ``flight_rounds=K > 0`` also the ``int32[K, V]`` flight ring of the
    global per-member rows of the rounds that count. ``count_rounds``, if
    given, is called with the number of rounds each window ran, the
    no-op rounds past the fixed point included."""
    if window < 1:
        raise ValueError("window must be >= 1")
    _check_plan(plan, mesh, axis)
    locals_ = [
        _grouped_exchange_local(codec, spec, plan, mode, mesh, axis)
        for codec, spec, _n in groups
    ]
    S, B = plan["n_shards"], plan["block"]
    _first, n_loc = local_shards(mesh, axis)
    flight_k = int(flight_rounds)
    n_members = sum(n for _c, _s, n in groups)

    def run(member_states, send_tbl, idx_tbl, mr):
        from ..telemetry import device as tel_flight

        sts = [list(ms) for ms in member_states]
        dev = idx_tbl.device
        mr = int(mr)
        ring = (tel_flight.ring_init(flight_k, n_members, device=dev)
                if flight_k else None)
        rounds, done_at = 0, -1
        while done_at < 0 and rounds < mr:
            t = min(window, mr - rounds)
            partials = torch.ones((window, n_loc, n_members), dtype=torch.int32,
                                  device=dev)
            for i in range(t):
                per = []
                new_sts = []
                for (codec, spec, _n), loc, old in zip(groups, locals_, sts):
                    new = loc(old, send_tbl, idx_tbl)
                    for o, nw in zip(old, new):
                        ch = ~codec.equal(spec, o, nw)
                        per.append(ch.reshape(n_loc, B).sum(1, dtype=torch.int32))
                    new_sts.append(new)
                sts = new_sts
                partials[i] = torch.stack(per, dim=1)
            if count_rounds is not None:
                count_rounds(t)
            # the psum: this process's shards, then one all_reduce a window
            totals = comm.all_reduce(partials.sum(1, dtype=torch.int32), mesh)
            _moved("psum", S * window, n_members * 4)
            per_round = totals.sum(1).cpu().numpy()  # the window's host read
            zero = np.flatnonzero(per_round[:t] == 0)
            t_eff = int(zero[0]) + 1 if zero.size else t
            if zero.size:
                done_at = rounds + t_eff
            if ring is not None:
                tel_flight.ring_write_block(ring, rounds, totals[:t_eff])
            rounds += t
        signed = done_at if done_at > 0 else -rounds
        outs = tuple(tuple(ms) for ms in sts)
        if flight_k:
            return outs, signed, ring
        return outs, signed

    return run


def shard_frontier_counts(frontier, n_shards: int):
    """``int64[S]``: dirty-replica frontier rows per contiguous shard
    block. Trailing rows of a non-divisible population fold into the last
    block."""
    f = np.asarray(frontier, dtype=bool)
    n = f.shape[0]
    block = max(n // int(n_shards), 1)
    counts = np.zeros(int(n_shards), dtype=np.int64)
    for s in range(int(n_shards)):
        lo = s * block
        hi = (s + 1) * block if s < n_shards - 1 else n
        counts[s] = int(f[lo:hi].sum())
    return counts


def shard_rows(n_replicas: int, n_shards: int, shard: int):
    """``int64[...]``: the replica rows of one contiguous shard block,
    under exactly the blocking :func:`shard_frontier_counts` uses."""
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not 0 <= int(shard) < n_shards:
        raise ValueError(f"shard {shard} out of range for {n_shards} shards")
    block = max(int(n_replicas) // n_shards, 1)
    lo = int(shard) * block
    hi = (int(shard) + 1) * block if shard < n_shards - 1 else int(n_replicas)
    return np.arange(min(lo, n_replicas), min(hi, n_replicas), dtype=np.int64)


def shard_cut_bytes(neighbors, n_shards: int, row_bytes: int) -> dict:
    """Per-shard boundary-exchange accounting for a block sharding of
    ``neighbors``: the rows each shard must contribute because some OTHER
    shard references them (the cut), counted per shard and converted to
    bytes at ``row_bytes`` per row."""
    nbrs = np.asarray(neighbors).astype(np.int64)
    R, K = nbrs.shape
    n_shards = int(n_shards)
    B = max(R // n_shards, 1)
    src_shard = (np.arange(R) // B).clip(max=n_shards - 1)[:, None]
    owner = (nbrs // B).clip(max=n_shards - 1)
    cross = owner != src_shard
    cut_mask = np.zeros(R, dtype=bool)
    if cross.any():
        cut_mask[np.unique(nbrs[cross])] = True
    counts = shard_frontier_counts(cut_mask, n_shards)
    return {
        "cut_rows": int(cut_mask.sum()),
        "cross_edges": int(cross.sum()),
        "per_shard_cut_rows": [int(c) for c in counts],
        "per_shard_cut_bytes": [int(c) * int(row_bytes) for c in counts],
        "row_bytes": int(row_bytes),
    }


def frontier_cut_rows(frontier, plan: dict) -> int:
    """How many of the plan's cut rows are frontier-dirty — the rows whose
    next exchange carries new state. Upper bound: the plan's pad slots
    alias each shard's block-row 0."""
    f = np.asarray(frontier, dtype=bool)
    B = plan["block"]
    send = np.asarray(plan["send_idx"])  # [S, M] block-local ids, pad 0
    rows = send + np.arange(send.shape[0])[:, None] * B
    return int(np.unique(rows[f[rows]]).size)


def axis_extent(mesh: Mesh, axis) -> int:
    """Total shard count of a mesh axis name or tuple of names."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    n = 1
    for a in names:
        n *= mesh.shape[a]
    return n


def partition_tables(plan: dict, mesh: Mesh, mode: str = "gather") -> tuple:
    """``plan``'s tables for ``mode`` as int32 tensors on the mesh's
    device: ``(send, idx)``."""
    if mode == "alltoall":
        send, idx = plan["send2_idx"], plan["idx2"]
    else:
        send, idx = plan["send_idx"], plan["idx"]
    return (
        torch.as_tensor(send, dtype=torch.int32, device=mesh.device).contiguous(),
        torch.as_tensor(idx, dtype=torch.int32, device=mesh.device).contiguous(),
    )


def partitioned_gossip_rounds(codec, spec, states, mesh: Mesh, plan: dict,
                              n_rounds: int, axis="replicas",
                              mode: str = "gather"):
    """``n_rounds`` boundary-exchange rounds. Returns ``(new_states,
    changed)`` like :func:`ring_gossip_rounds`."""
    round_fn = partitioned_gossip_round_fn(
        codec, spec, mesh, plan, axis=axis, mode=mode
    )
    send_idx, idx = partition_tables(plan, mesh, mode=mode)
    out = states
    for _ in range(n_rounds):
        out = round_fn(out, send_idx, idx)
    return out, _changed_any(codec, spec, states, out, mesh)


def ring_gossip_shardmap_dryrun(mesh: Mesh, n_replicas: int) -> None:
    """Run-and-check proof that the ring path and the sharded join work on
    the mesh's shard slots: one ring round and one coverage join of a
    seeded packed OR-Set, each against the unsharded reference (on a
    process group's mesh, this process's blocks against their rows of
    it)."""
    from ..lattice.base import replicate
    from ..ops import PackedORSet, PackedORSetSpec
    from .gossip import gossip_round
    from .topology import ring

    flat = Mesh(mesh.devices.reshape(-1), (str(mesh.axis_names[0]),))
    axis = flat.axis_names[0]
    spec = PackedORSetSpec(n_elems=4, n_actors=4, tokens_per_actor=1)
    rng = np.random.RandomState(0)
    states = replicate(PackedORSet.new(spec, device=flat.device), n_replicas)._replace(
        exists=torch.as_tensor(
            rng.randint(0, 16, size=(n_replicas, spec.n_elems, spec.n_words)),
            dtype=torch.int32, device=flat.device,
        )
    )
    first, n_loc = local_shards(flat, axis)
    b = n_replicas // flat.size
    mine = tree_map(lambda x: x[first * b:(first + n_loc) * b], states)
    out, _changed = ring_gossip_rounds(PackedORSet, spec, mine, flat, 1, k=2,
                                       axis=axis)
    nbrs = torch.as_tensor(ring(n_replicas, 2), dtype=torch.int32,
                           device=flat.device)
    ref = gossip_round(PackedORSet, spec, states, nbrs)
    assert all(torch.equal(a, x[first * b:(first + n_loc) * b])
               for a, x in zip(out, ref)), "ppermute ring != dense ring"
    top = sharded_join_all(PackedORSet, spec, mine, flat, axis=axis)
    ref_top = join_all(PackedORSet, spec, states)
    assert all(torch.equal(a, b) for a, b in zip(top, ref_top)), (
        "sharded join != dense join")
