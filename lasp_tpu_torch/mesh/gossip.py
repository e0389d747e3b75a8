"""Gossip / anti-entropy rounds over a leading replica axis (port of
``lasp_tpu.mesh.gossip``).

Bulk-synchronous pull gossip: every replica gathers its neighbours' states
and joins them in, all replicas at once. ``neighbors`` is an ``int32[R, K]``
tensor on the population's device. A leafwise-"or" codec held as two
32-bit word planes (the packed and flat OR-Sets) runs its unmasked round
through the CUDA kernel K1 (``ops.cuda_gossip.gossip_round_dense``); every
other round is plain PyTorch, as the JAX package leaves it to XLA.

The shift variants (:func:`gossip_round_shift`, ``torch.roll`` per
constant-offset column) and the grouped variants (a leading group dimension
``[G, R, ...]`` written out where JAX vmaps) are here as functions of their
own. The runtime keeps gathering over the neighbour table on every topology
(on a ring the gather gives the roll's result), so packed OR-Sets keep
running through K1; and its planned rounds step each member population in
place rather than stacking members into ``[G, R, ...]`` copies.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice.base import tree_leaves, tree_map
from ..ops.cuda_gossip import gossip_round_dense


#: the most bytes of one leaf that a dense round's gathers, joins and
#: equality checks touch at once: a larger leaf (a dense population of many
#: GiB) runs a block of rows at a time, so the round holds one block's
#: temporaries beside the states rather than copies of the whole leaf
CHUNK_BYTES = 1 << 28

#: a dense round's replica-local sweep runs over every row at once unless
#: its variables' rows, viewed dense, pass this many bytes in all; then it
#: runs in blocks of :data:`CHUNK_BYTES`. Whole, it holds about four dense
#: copies of them at once (views, contributions, merges, the gate): the
#: north star's 7.7 GiB sweep fits so on an 80 GB card, ``packed_vs_dense``'s
#: 17 GiB at 1,048,576 replicas does not
SWEEP_BYTES = 8 << 30


def chunk_rows(x) -> int:
    """Rows of the replica-axis leaf ``x`` in one block of at most
    :data:`CHUNK_BYTES`; at least ``x.shape[0]`` when the leaf fits."""
    row = (x[0].numel() * x.element_size()) if x.shape[0] else 0
    return max(1, CHUNK_BYTES // max(row, 1))


def changed_rows(codec, spec, a, b) -> torch.Tensor:
    """0-d ``int32``: the replica rows where populations ``a`` and ``b``
    differ by ``codec.equal`` (a round's residual), counted a block of
    :func:`chunk_rows` rows at a time."""
    leaves = tree_leaves(a)
    n = leaves[0].shape[0]
    step = min(chunk_rows(x) for x in leaves)
    if step >= n:
        return torch.sum(~codec.equal(spec, a, b), dtype=torch.int32)
    total = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    for s in range(0, n, step):
        rows = slice(s, s + step)
        total += torch.sum(
            ~codec.equal(spec, tree_map(lambda x: x[rows], a),
                         tree_map(lambda x: x[rows], b)),
            dtype=torch.int32,
        )
    return total


def _tree_where(pred, a, b):
    """Leafwise select with ``pred`` broadcast from the left."""

    def sel(x, y):
        p = pred.reshape(tuple(pred.shape) + (1,) * (x.dim() - pred.dim()))
        return torch.where(p, x, y)

    return tree_map(sel, a, b)


def _leafwise_op(codec):
    """The elementwise join a codec's ``leafwise_join`` declares, or None;
    an unknown value is a loud error."""
    kind = getattr(codec, "leafwise_join", None)
    if kind is None:
        return None
    if kind == "or":
        return torch.bitwise_or
    if kind == "max":
        return torch.maximum
    raise ValueError(
        f"{getattr(codec, 'name', codec)}: unknown leafwise_join {kind!r} "
        "(expected 'or', 'max', or None)"
    )


def _word_planes(codec, states) -> bool:
    """Is this the (exists, removed) pair of 32-bit word planes K1 joins?"""
    return (
        getattr(codec, "leafwise_join", None) == "or"
        and getattr(states, "_fields", None) == ("exists", "removed")
        and states.exists.dtype == torch.int32
        and states.removed.shape == states.exists.shape
        and states.exists.dim() >= 2
    )


def gossip_round(codec, spec, states, neighbors, edge_mask=None, out=None):
    """One pull-gossip round: ``new[r] = join(state[r], state[n])`` for each
    ``n`` in ``neighbors[r, :]``. ``edge_mask: bool[R, K]`` (True = alive)
    injects failures: a dead edge contributes the replica's own state.

    ``out``: optional buffers (a state of the same type and shapes) that
    the K1 route writes into; other routes allocate."""
    op = _leafwise_op(codec)
    if op is not None and edge_mask is None:
        if _word_planes(codec, states):
            r = states.exists.shape[0]
            e2, r2 = gossip_round_dense(
                states.exists.reshape(r, -1),
                states.removed.reshape(r, -1),
                neighbors,
                out=None if out is None else (
                    out.exists.reshape(r, -1), out.removed.reshape(r, -1)
                ),
            )
            return type(states)(
                e2.view(states.exists.shape), r2.view(states.removed.shape)
            )
        nb = neighbors.long()

        def join_rows(x, rows):
            acc = x[rows]
            for k in range(nb.shape[1]):
                acc = op(acc, x[nb[rows, k]])
            return acc

        def leaf(x):
            step = chunk_rows(x)
            if step >= x.shape[0]:
                return join_rows(x, slice(None))
            out = torch.empty_like(x)
            for s in range(0, x.shape[0], step):
                out[s:s + step] = join_rows(x, slice(s, s + step))
            return out

        return tree_map(leaf, states)
    nb = neighbors.long()
    acc = states
    for k in range(nb.shape[1]):
        nbr = tree_map(lambda x: x[nb[:, k]], states)
        if edge_mask is not None:
            nbr = _tree_where(edge_mask[:, k], nbr, states)
        acc = codec.merge(spec, acc, nbr)
    return acc


def gossip_round_shift(codec, spec, states, offsets, edge_mask=None):
    """:func:`gossip_round` for a shift-structured topology (every
    neighbour column ``k`` the constant offset ``offsets[k]``,
    ``topology.shift_offsets``): the column gather ``x[(r + off) % R]`` is
    ``torch.roll(x, -off, 0)``."""
    return _shift_round(codec, spec, states, offsets, edge_mask, dim=0)


def _shift_round(codec, spec, states, offsets, edge_mask, dim: int):
    op = _leafwise_op(codec)
    if op is not None and edge_mask is None:

        def leaf(x):
            acc = x
            for off in offsets:
                acc = op(acc, torch.roll(x, -int(off), dims=dim))
            return acc

        return tree_map(leaf, states)
    acc = states
    for k, off in enumerate(offsets):
        nbr = tree_map(lambda x: torch.roll(x, -int(off), dims=dim), states)
        if edge_mask is not None:
            nbr = _tree_where(_replica_pred(edge_mask[:, k], dim), nbr, states)
        acc = codec.merge(spec, acc, nbr)
    return acc


def _replica_pred(pred, dim: int):
    """A ``bool[R]`` predicate placed on the replica axis ``dim`` (1 under a
    leading group axis), broadcast from the left by :func:`_tree_where`."""
    return pred if dim == 0 else pred.reshape((1,) * dim + tuple(pred.shape))


# -- grouped rounds: a leading group axis [G, R, ...] -------------------------
#
# The JAX package vmaps the per-variable rounds over a stacked group; here
# the group axis is written out: every gather indexes dim 1 and the codecs'
# merges are batch-polymorphic. Same computation, same bits per member.


def gossip_round_grouped(codec, spec, states, neighbors, edge_mask=None):
    """:func:`gossip_round` over ``[G, R, ...]`` leaves; ``neighbors`` and
    ``edge_mask`` are shared by every member (one topology, one mask)."""
    nb = neighbors.long()
    op = _leafwise_op(codec)
    if op is not None and edge_mask is None:

        def leaf(x):
            acc = x
            for k in range(nb.shape[1]):
                acc = op(acc, x[:, nb[:, k]])
            return acc

        return tree_map(leaf, states)
    acc = states
    for k in range(nb.shape[1]):
        nbr = tree_map(lambda x: x[:, nb[:, k]], states)
        if edge_mask is not None:
            nbr = _tree_where(_replica_pred(edge_mask[:, k], 1), nbr, states)
        acc = codec.merge(spec, acc, nbr)
    return acc


def gossip_round_shift_grouped(codec, spec, states, offsets, edge_mask=None):
    """:func:`gossip_round_shift` over ``[G, R, ...]`` leaves (the rolls run
    along the replica axis, dim 1)."""
    return _shift_round(codec, spec, states, offsets, edge_mask, dim=1)


def gossip_round_rows_grouped(codec, spec, states, neighbors, rows, valid,
                              edge_mask=None):
    """:func:`gossip_round_rows` over ``[G, R, ...]`` leaves: ``rows:
    int[G, F]`` (each member's reachable rows, padded to the group bucket),
    ``valid: bool[G, F]`` (which slots are real). Returns ``(new_states,
    changed: bool[G, F])``. A member with no valid slot reports no change,
    and at its fixed point rides through bit-unchanged."""
    dev = states[0].device
    rows = torch.as_tensor(rows, device=dev).long()
    g_idx = torch.arange(rows.shape[0], device=dev)[:, None]
    nbr_idx = neighbors.long()[rows]  # [G, F, K]
    old = tree_map(lambda x: x[g_idx, rows], states)
    op = _leafwise_op(codec)
    if op is not None and edge_mask is None:

        def leaf(x, o):
            acc = o
            for k in range(nbr_idx.shape[-1]):
                acc = op(acc, x[g_idx, nbr_idx[..., k]])
            return acc

        new_rows = tree_map(leaf, states, old)
    else:
        acc = old
        for k in range(nbr_idx.shape[-1]):
            nbr = tree_map(lambda x: x[g_idx, nbr_idx[..., k]], states)
            if edge_mask is not None:
                nbr = _tree_where(edge_mask[rows, k], nbr, old)
            acc = codec.merge(spec, acc, nbr)
        new_rows = acc
    changed = ~codec.equal(spec, old, new_rows)
    changed = changed & torch.as_tensor(valid, dtype=torch.bool, device=dev)

    def scatter(x, nr):
        out = x.clone()
        out[g_idx, rows] = nr
        return out

    return tree_map(scatter, states, new_rows), changed


def frontier_reach(frontier, neighbors, include_self: bool = False):
    """Host-side frontier expansion: ``bool[R]`` of replicas that CAN change
    in the next pull round (one of their fan-in neighbours inflated last
    round)."""
    f = np.asarray(frontier, dtype=bool)
    reach = f[np.asarray(neighbors)].any(axis=1)
    if include_self:
        reach = reach | f
    return reach


def gossip_round_rows(codec, spec, states, neighbors, rows, edge_mask=None,
                      valid=None):
    """Masked pull-gossip round over ONLY the replica rows named by
    ``rows``; all other rows ride through untouched. Returns ``(new_states,
    changed: bool[F])``; ``rows`` may repeat a row (bucket padding — the
    duplicate writes are identical by idempotence), and ``valid: bool[F]``
    marks pad slots for the changed accounting only (the pad-slot contract
    of ``lasp_tpu/mesh/gossip.py:151-162``).

    This function defines the round's contract in plain PyTorch; the CUDA
    kernel K2 (``ops.cuda_gossip``) is held bit-identical to it, states and
    changed flags alike."""
    dev = states[0].device
    rows = torch.as_tensor(rows, device=dev).long()
    nbr_idx = neighbors.long()[rows]  # [F, K]
    old = tree_map(lambda x: x[rows], states)
    op = _leafwise_op(codec)
    if op is not None and edge_mask is None:

        def leaf(x, o):
            acc = o
            for k in range(nbr_idx.shape[1]):
                acc = op(acc, x[nbr_idx[:, k]])
            return acc

        new_rows = tree_map(leaf, states, old)
    else:
        acc = old
        for k in range(nbr_idx.shape[1]):
            nbr = tree_map(lambda x: x[nbr_idx[:, k]], states)
            if edge_mask is not None:
                nbr = _tree_where(edge_mask[rows, k], nbr, old)
            acc = codec.merge(spec, acc, nbr)
        new_rows = acc
    changed = ~codec.equal(spec, old, new_rows)
    if valid is not None:
        changed = changed & torch.as_tensor(valid, dtype=torch.bool, device=dev)
    new_states = tree_map(lambda x, nr: x.index_copy(0, rows, nr), states, new_rows)
    return new_states, changed


def join_all(codec, spec, states):
    """Full join over the replica axis (the coverage-query merge): log-depth
    halving; odd lengths pad by duplicating the last replica."""
    n = states[0].shape[0]
    while n > 1:
        if n % 2:
            states = tree_map(lambda x: torch.cat([x, x[-1:]], dim=0), states)
            n += 1
        half = n // 2
        states = codec.merge(
            spec,
            tree_map(lambda x: x[:half], states),
            tree_map(lambda x: x[half:], states),
        )
        n = half
    return tree_map(lambda x: x[0], states)


def quorum_read(codec, spec, states, replica_indices):
    """Join the states of a replica subset — the R-of-N quorum read."""
    idx = torch.as_tensor(replica_indices, device=states[0].device).long()
    return join_all(codec, spec, tree_map(lambda x: x[idx], states))


def converged(codec, spec, states) -> torch.Tensor:
    """0-d bool: every replica equals the global join (the fixed point)."""
    top = join_all(codec, spec, states)
    return torch.all(codec.equal(spec, states, top))


def diverged_rows(codec, spec, states) -> torch.Tensor:
    """``bool[R]``: which replica rows still differ from the global join."""
    top = join_all(codec, spec, states)
    return ~codec.equal(spec, states, top)


def divergence(codec, spec, states) -> torch.Tensor:
    """Number of replicas not yet at the global join (0-d int64)."""
    return torch.sum(diverged_rows(codec, spec, states))


def _leaf_bytes(states) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(states))


def rows_traffic_bytes(states, n_rows: int, fanout: int = 1) -> int:
    """Host-side wire estimate for a partial exchange of ``n_rows`` rows,
    ``fanout`` times each (metadata only)."""
    if n_rows <= 0 or states[0].shape[0] == 0:
        return 0
    return (_leaf_bytes(states) // states[0].shape[0]) * int(n_rows) * int(fanout)


def round_traffic_bytes(states, fanout: int) -> int:
    """Host-side estimate of the bytes ONE pull round moves: the whole
    population's state, ``fanout`` times (metadata only)."""
    return _leaf_bytes(states) * int(fanout)
