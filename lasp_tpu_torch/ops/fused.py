"""Fused multi-round gossip (port of ``lasp_tpu.ops.fused``).

The JAX package runs a block of rounds inside one ``lax.fori_loop``; here a
block is a Python loop whose counters stay device tensors, so a block costs
no host sync until its caller reads the result. Rounds on the K1 route
ping-pong two buffers: round ``i`` writes into the buffers round ``i - 2``
wrote, never into the caller's states.
"""

from __future__ import annotations

import torch

from ..mesh.gossip import _tree_where, gossip_round, gossip_round_grouped


def _rounds(codec, spec, states, neighbors, n_rounds, edge_mask, per_round=None):
    s, spare = states, None
    for _ in range(n_rounds):
        new = gossip_round(codec, spec, s, neighbors, edge_mask, out=spare)
        if per_round is not None:
            per_round(s, new)
        spare = s if s is not states else None
        s = new
    return s


def gossip_rounds(codec, spec, states, neighbors, n_rounds: int, edge_mask=None):
    """``n_rounds`` pull rounds and nothing else: no equality reductions
    (the headline's timed block)."""
    return _rounds(codec, spec, states, neighbors, n_rounds, edge_mask)


def fused_gossip_rounds(codec, spec, states, neighbors, n_rounds: int,
                        edge_mask=None):
    """Run ``n_rounds`` rounds; returns ``(new_states, changed)`` with
    ``changed`` a 0-d bool tensor (any replica differs from entry)."""
    out = _rounds(codec, spec, states, neighbors, n_rounds, edge_mask)
    return out, ~torch.all(codec.equal(spec, states, out))


def fused_gossip_rounds_count(codec, spec, states, neighbors, n_rounds: int,
                              edge_mask=None):
    """Like :func:`fused_gossip_rounds` but returns ``(new_states,
    n_productive)``: the int32 0-d device count of rounds in the block that
    changed any replica. Gossip is monotone and deterministic, so
    productive rounds are a prefix of the block (``lasp_tpu/ops/
    fused.py:32-54``): a count below ``n_rounds`` means the fixed point was
    reached inside the block, and the running sum of counts is the exact
    number of rounds to convergence."""
    prod = torch.zeros((), dtype=torch.int32, device=states[0].device)

    def count(prev, new):
        prod.add_((~torch.all(codec.equal(spec, prev, new))).to(torch.int32))

    out = _rounds(codec, spec, states, neighbors, n_rounds, edge_mask, count)
    return out, prod


def window_masks(masks, device) -> torch.Tensor:
    """A chaos window's ``bool[T, R, K]`` masks on the states' device, in
    one copy (a numpy stack or a tensor already there)."""
    return torch.as_tensor(masks, dtype=torch.bool, device=device)


def fused_chaos_rounds(codec, spec, states, neighbors, masks):
    """One window of a chaos schedule — ``masks: bool[T, R, K]``, one
    edge-alive mask per round (``chaos.ChaosSchedule.masks``) — as T masked
    rounds. JAX runs them in one ``lax.fori_loop`` over the stacked masks;
    here the stack goes to the device once and a Python loop runs the same
    masked :func:`~lasp_tpu_torch.mesh.gossip.gossip_round` per round, so
    the per-round states are bit-identical to stepping the masks one at a
    time.

    Returns ``(new_states, residuals)`` with ``residuals: int32[T]`` on the
    device — replica rows each round changed — read by the caller in one
    host sync."""
    dev = states[0].device
    masks = window_masks(masks, dev)
    s, res = states, []
    for t in range(masks.shape[0]):
        new = gossip_round(codec, spec, s, neighbors, masks[t])
        res.append(torch.sum(~codec.equal(spec, s, new), dtype=torch.int32))
        s = new
    return s, torch.stack(res)


def fused_gossip_rounds_grouped(codec, spec, states, neighbors, n_rounds: int,
                                edge_mask=None):
    """Grouped member of the fused family: ``states`` leaves are ``[G, R,
    ...]`` (a dispatch-plan group's stacked variables) and ``n_rounds``
    rounds of :func:`~lasp_tpu_torch.mesh.gossip.gossip_round_grouped` run
    over the group. Returns ``(new_states, changed: bool[G])``, which
    members the block changed at all; bit-identical per member to
    :func:`fused_gossip_rounds` on each variable alone."""
    out = states
    for _ in range(n_rounds):
        out = gossip_round_grouped(codec, spec, out, neighbors, edge_mask)
    return out, ~torch.all(codec.equal(spec, states, out), dim=1)


def fused_chaos_rounds_grouped(codec, spec, states, neighbors, masks):
    """Grouped twin of :func:`fused_chaos_rounds`: one chaos window
    (``masks: bool[T, R, K]``) over one group (leaves ``[G, R, ...]``).
    Returns ``(new_states, residuals: int32[T, G])`` on the device, replica
    rows each round changed per member."""
    dev = states[0].device
    masks = window_masks(masks, dev)
    s, res = states, []
    for t in range(masks.shape[0]):
        new = gossip_round_grouped(codec, spec, s, neighbors, masks[t])
        res.append(torch.sum(~codec.equal(spec, s, new), dim=1, dtype=torch.int32))
        s = new
    return s, torch.stack(res)


def fused_frontier_rounds(codec, spec, states, neighbors, frontier,
                          n_rounds: int, edge_mask=None):
    """Frontier-carried twin of :func:`fused_gossip_rounds_count`: up to
    ``n_rounds`` rounds with a device-resident dirty mask ``frontier:
    bool[R]``, exiting as soon as the frontier is empty. Only rows reachable
    from the frontier may change each round (``reach[r] =
    any(frontier[neighbors[r, :]])``, dead edges excluded); the new
    frontier is the rows the round inflated. Testing the frontier for
    emptiness is the one host read per round — eager PyTorch cannot leave
    a loop on a device value without it. Returns ``(new_states,
    new_frontier, n_rounds_run)``, the last a 0-d int32 tensor."""
    nb = neighbors.long()
    s, f, i = states, frontier, 0
    while i < n_rounds and bool(f.any()):
        fanin = f[nb]  # [R, K]
        if edge_mask is not None:
            fanin = fanin & edge_mask
        reach = fanin.any(dim=1)
        new = gossip_round(codec, spec, s, neighbors, edge_mask)
        new = _tree_where(reach, new, s)
        f = ~codec.equal(spec, s, new)
        s = new
        i += 1
    return s, f, torch.tensor(i, dtype=torch.int32, device=f.device)


#: sweeps a block of :func:`fused_dataflow_rounds` runs between host syncs
DATAFLOW_BLOCK = 8


def fused_dataflow_rounds(round_fn, states, tables, n_dsts: int, max_rounds: int,
                          flight_rounds: int = 0):
    """The fused propagate's fixed-point loop: the leveled Jacobi sweep
    ``round_fn(states, tables) -> (states, changed: bool[n_dsts])``
    (``dataflow.plan.make_round_fn``) repeated until a sweep changes no
    dst or ``max_rounds`` sweeps ran. JAX runs it in one ``while_loop``;
    eager PyTorch has none, so sweeps run in blocks of at most 8, each
    capped by the budget left, with one host sync a block that reads the
    block's stacked changed flags.

    Returns JAX's ``(new_states, per_dst_counts: int32[n_dsts], sweeps,
    pending)``: ``sweeps`` counts up to and including the first
    unproductive sweep, ``per_dst_counts[i]`` the sweeps among those that
    changed ``dst_order[i]``, and ``pending`` whether the budget ran out
    while flags were still set. Sweeps a block runs past the fixed point
    are no-ops by idempotence (the sweep is a function of the states,
    which the unproductive sweep left unchanged); the states returned are
    the unproductive sweep's own, as JAX's loop returns them.

    With ``flight_rounds=K > 0`` a fifth output is the modulo-``K`` flight
    ring (``telemetry.device``) of per-sweep changed flags, ``int32[K,
    n_dsts]`` with sweep ``i`` at slot ``i % K``, holding the sweeps JAX's
    loop runs (the unproductive one included, the no-op sweeps after it
    not). The flags reach the host with each block's sync, so the ring is
    written there and costs the card nothing."""
    from ..telemetry.device import ring_init, ring_write

    ring = ring_init(flight_rounds, n_dsts) if flight_rounds else None
    s = states
    counts = torch.zeros((n_dsts,), dtype=torch.int32)
    sweeps = 0
    out = None
    while sweeps < max_rounds:
        block = min(DATAFLOW_BLOCK, max_rounds - sweeps)
        outs, flags = [], []
        for _ in range(block):
            s, changed = round_fn(s, tables)
            outs.append(s)
            flags.append(changed)
        rows = torch.stack(flags).to(device="cpu", dtype=torch.int32)  # the sync
        productive = rows.any(dim=1)
        kept = block if bool(productive.all()) else int((~productive).nonzero()[0, 0]) + 1
        counts += rows[:kept].sum(dim=0, dtype=torch.int32)
        if ring is not None:
            for i in range(kept):
                ring_write(ring, sweeps + i, rows[i])
        sweeps += kept
        if kept < block or not bool(productive[kept - 1]):
            out = (outs[kept - 1], counts, sweeps, False)
            break
    if out is None:
        out = (s, counts, sweeps, True)
    return out + (ring,) if ring is not None else out


__all__ = [
    "fused_chaos_rounds",
    "fused_chaos_rounds_grouped",
    "fused_dataflow_rounds",
    "fused_frontier_rounds",
    "fused_gossip_rounds",
    "fused_gossip_rounds_count",
    "fused_gossip_rounds_grouped",
    "gossip_rounds",
]
