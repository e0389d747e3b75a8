"""The quorum request FSM: vocabulary, reachability, and the two
transition implementations (port of ``lasp_tpu.quorum.fsm``: the numpy
parts are copies; the batched transition is a PyTorch step on the
runtime's device where JAX jits one).

One in-flight request is the reference's coordinator FSM
(``src/lasp_update_fsm.erl:174-216``): prepare (pick the preflist) →
waiting(R) (accumulate replies) → finalize/repair → waiting_n(N) →
done/failed. Here a BATCH of requests is a struct-of-arrays —

    state     int32[B]   one of the STATE_* codes below
    coord     int32[B]   coordinator replica row
    picks     int32[B,N] the preflist (N replica rows, coordinator first)
    acks      bool [B,N] which picks have replied
    deadline  int32[B]   absolute round the current wait expires at
    need      int32[B]   client quorum (R for gets, W for puts)
    degraded  bool [B]   R-of-live degradation (first-replies of whatever
                         is reachable, the ChaosRuntime.degraded_read rule)

— and one round advances EVERY request with one tensor step on the
device (:func:`transition_batched`) over the round's reachability. Reply
semantics are mask-derived: a picked replica replies in a round iff it
is live and in the coordinator's connected component of the live-edge
graph under that round's chaos mask (:func:`components` — one labeling
per round, shared by every request; a partitioned coordinator hears
only from ITS side of the cut, exactly the degraded-read confinement
rule of ``chaos.engine``).

:func:`transition_sequential` is the per-request scalar reference: the
same transition rules applied one request at a time in submit order.
The two are asserted bit-identical (states, ack sets, fired flags)
across codecs × topologies × chaos presets by
``tests/test_torch_quorum.py`` — the batched step is the same machine,
vectorized, never a different protocol.
"""

from __future__ import annotations

import numpy as np
import torch

# -- state vocabulary (the reference FSM's state atoms) ---------------------
PREPARE = 0    #: submitted, preflist not yet picked
WAITING_R = 1  #: execute fired, accumulating replies toward the client quorum
WAITING_N = 2  #: client answered, finalizing toward all-N acks
REPAIR = 3     #: quorum fired THIS round: value/repair/hint work executes
DONE = 4       #: terminal: answered and finalized
FAILED = 5     #: terminal: retries exhausted without a quorum

STATE_NAMES = {
    PREPARE: "prepare",
    WAITING_R: "waiting_r",
    WAITING_N: "waiting_n",
    REPAIR: "repair",
    DONE: "done",
    FAILED: "failed",
}


def preflist(coord: int, n: int, n_replicas: int) -> np.ndarray:
    """The deterministic N-row preflist of a coordinator: the ring walk
    ``[coord, coord+1, ...] mod R`` (riak_core's successor-vnode
    preflist, ``src/lasp_core.erl:231-235``). Static — liveness is
    handled by acks/timeouts, not by the pick (the reference's preflist
    is static per ring epoch too)."""
    if n > n_replicas:
        raise ValueError(
            f"preflist of {n} from a {n_replicas}-replica population"
        )
    return (int(coord) + np.arange(int(n), dtype=np.int64)) % int(n_replicas)


def next_live_coordinator(coord: int, crashed: np.ndarray) -> "int | None":
    """The re-pick rule: the first LIVE replica strictly after ``coord``
    in ring order (wrapping), or None when every replica is down.
    Deterministic — re-pick is part of the replayable protocol."""
    n = crashed.shape[0]
    for step in range(1, n + 1):
        cand = (int(coord) + step) % n
        if not crashed[cand]:
            return cand
    return None


def components(neighbors: np.ndarray, mask, live: np.ndarray) -> np.ndarray:
    """``int32[R]`` connected-component labels of the LIVE-edge graph:
    two replicas share a label iff a path of alive links (this round's
    chaos mask, both endpoints live) connects them. Labels are the
    minimum member index (deterministic). Crashed replicas keep their
    own index as label and are additionally excluded by the ``live``
    guard at every use site.

    One labeling per round serves every in-flight request — the batched
    generalization of ``ChaosRuntime._reachable_live``'s per-call BFS.
    Min-label propagation with path halving: O(E · log R) host work."""
    nbrs = np.asarray(neighbors)
    R, K = nbrs.shape
    live = np.asarray(live, dtype=bool)
    alive = np.ones((R, K), dtype=bool) if mask is None else np.asarray(
        mask, dtype=bool
    ).copy()
    alive &= live[:, None] & live[nbrs]
    rows = np.repeat(np.arange(R, dtype=np.int64), K)[alive.ravel()]
    cols = nbrs.ravel()[alive.ravel()]
    comp = np.arange(R, dtype=np.int64)
    while True:
        new = comp.copy()
        if rows.size:
            np.minimum.at(new, rows, comp[cols])
            np.minimum.at(new, cols, comp[rows])
        new = new[new]  # path halving: labels chase their own label
        if np.array_equal(new, comp):
            break
        comp = new
    return comp.astype(np.int32)


# -- the transition step ----------------------------------------------------
#
# Both implementations advance WAITING_R / WAITING_N requests one round:
#
#   reach[b,i]  = live[coord] & live[picks] & comp[picks] == comp[coord]
#   acks'       = acks | (reach & pick_valid)        (replies accumulate)
#   eff_need    = degraded ? max(1, min(need, reachable picks)) : need
#   quorum_now  = WAITING_R & popcount(acks') >= eff_need   -> REPAIR
#   timeout_now = WAITING_R & ~quorum_now & round >= deadline
#   done_now    = WAITING_N & (all valid picks acked | round >= deadline)
#
# PREPARE processing, retry/fail resolution of timeout_now, and the
# REPAIR-state join work are HOST decisions (they touch the store /
# hint log) — see engine.py. The kernel's outputs are exactly the flags
# the host needs, so one dispatch serves thousands of requests.

_BUCKET_MIN = 8


def bucket_of(n: int) -> int:
    """Pad the active-request axis to a power-of-two bucket (the JAX
    kernel's compile bucket, kept so both packages step the same padded
    batch; the frontier engine's bucket discipline)."""
    b = _BUCKET_MIN
    while b < n:
        b *= 2
    return b


def _astype(x, dtype):
    """``x.astype(dtype)`` for numpy arrays and torch tensors alike (the
    one call the two namespaces spell differently)."""
    return x.to(dtype) if isinstance(x, torch.Tensor) else x.astype(dtype)


def _transition_rules(xp, state, coord, picks, pick_valid, acks, deadline,
                      need, degraded, valid, comp, live, rnd):
    """THE transition rule set over an array namespace ``xp``: numpy (the
    sequential reference and host-side checks) or torch (the batched step
    on the card; JAX traces the same rules with ``jax.numpy``). Integer
    index arrays must be ones ``xp`` indexes with (int64 tensors for
    torch)."""
    active = valid & ((state == WAITING_R) | (state == WAITING_N))
    c_ok = live[coord]
    reach = (
        c_ok[:, None]
        & live[picks]
        & (comp[picks] == comp[coord][:, None])
        & pick_valid
    )
    new_acks = xp.where(active[:, None], acks | reach, acks)
    newly = new_acks & ~acks
    ackn = _astype(new_acks.sum(axis=1), xp.int32)
    reach_n = _astype(reach.sum(axis=1), xp.int32)
    n_valid = _astype(pick_valid.sum(axis=1), xp.int32)
    eff_need = _astype(xp.where(
        degraded, xp.minimum(need, reach_n).clip(min=1), need
    ), xp.int32)
    quorum_now = valid & (state == WAITING_R) & (ackn >= eff_need)
    timeout_now = (
        valid & (state == WAITING_R) & ~quorum_now & (rnd >= deadline)
    )
    done_now = (
        valid & (state == WAITING_N) & ((ackn >= n_valid) | (rnd >= deadline))
    )
    new_state = xp.where(quorum_now, REPAIR, state)
    new_state = _astype(xp.where(done_now, DONE, new_state), state.dtype)
    return new_state, new_acks, newly, quorum_now, timeout_now, done_now


def transition_batched(state, coord, picks, pick_valid, acks, deadline,
                       need, degraded, comp, live, rnd: int, device=None):
    """Advance EVERY request one round in one tensor step on ``device``
    (default CUDA). Arrays are the batch's struct-of-arrays slices (numpy,
    length B), padded to :func:`bucket_of` slots as JAX pads them; returns
    numpy ``(state', acks', newly, quorum_now, timeout_now, done_now)`` —
    bit-identical to :func:`transition_sequential` on the same inputs."""
    from ..device import resolve_device

    dev = resolve_device(device)
    b = state.shape[0]
    bucket = bucket_of(b)
    pad = bucket - b

    def padded(x):
        if pad:
            x = np.concatenate(
                [x, np.zeros((pad,) + x.shape[1:], dtype=x.dtype)]
            )
        return torch.as_tensor(x, device=dev)

    valid = np.zeros(bucket, dtype=bool)
    valid[:b] = True
    out = _transition_rules(
        torch, padded(state), padded(coord).long(), padded(picks).long(),
        padded(pick_valid),
        padded(acks), padded(deadline), padded(need), padded(degraded),
        torch.as_tensor(valid, device=dev),
        torch.as_tensor(np.asarray(comp), device=dev),
        torch.as_tensor(np.asarray(live, dtype=bool), device=dev),
        int(rnd),
    )
    return tuple(o[:b].cpu().numpy() for o in out)


def transition_sequential(state, coord, picks, pick_valid, acks, deadline,
                          need, degraded, comp, live, rnd: int):
    """The per-request scalar reference: identical rules, one request at
    a time (the shape of the reference's one-gen_fsm-per-request
    machine). The bit-identity oracle for :func:`transition_batched`."""
    b = state.shape[0]
    outs = [
        np.empty_like(state), acks.copy(),
        np.zeros_like(acks), np.zeros(b, dtype=bool),
        np.zeros(b, dtype=bool), np.zeros(b, dtype=bool),
    ]
    for i in range(b):
        sl = slice(i, i + 1)
        one = _transition_rules(
            np, state[sl], coord[sl], picks[sl], pick_valid[sl], acks[sl],
            deadline[sl], need[sl], degraded[sl],
            np.ones(1, dtype=bool), comp, live, rnd,
        )
        for o, v in zip(outs, one):
            o[sl] = v
    return tuple(outs)
