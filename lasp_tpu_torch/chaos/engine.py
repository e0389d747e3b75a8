"""ChaosRuntime: drive a replicated population through a fault timeline
(port of ``lasp_tpu.chaos.engine``).

Wraps a :class:`~lasp_tpu_torch.mesh.runtime.ReplicatedRuntime` with a
:class:`~lasp_tpu_torch.chaos.schedule.ChaosSchedule`: each chaos round
processes the round's crash/restore actions, compiles the round's fault
state into the edge mask the gossip rounds accept, and dispatches the
runtime's OWN step (dense or frontier — no chaos-specific path). On top
ride the replication-facing verbs the reference gets from its quorum FSMs:

- **crash** (fail-stop): every link touching the replica dies, its row
  freezes (a crashed row with dataflow edges/triggers is snapshotted
  around the step so local sweeps cannot move it), client writes to it
  are refused, and its actor lanes are retired (the riak_dt
  never-reuse-an-actor incarnation rule, as in ``resize`` crash);
- **restore**: the row re-seeds from the lattice bottom or an attached
  runtime checkpoint's saved row (``store.checkpoint.load_runtime_rows``)
  and every frontier degrades to all-dirty — gossip then performs the
  hinted-handoff-style catch-up;
- **degraded reads**: :meth:`ChaosRuntime.degraded_read` answers from K
  live replicas of a variable (Lasp's R=2 first-replies quorum,
  ``src/lasp_read_fsm.erl:125-146``) and triggers READ-REPAIR as a masked
  partial join — the quorum's join is merged back into exactly the rows
  read (``src/lasp_update_fsm.erl:189-216``), with the wire cost accounted
  per repaired row (``chaos_repair_bytes_total``).

Masked rounds take the masked paths of the gossip rounds: the CUDA kernels
K2 / K3 read the ``bool[R, K]`` mask in frontier rounds; a masked dense
round is plain PyTorch (K1 takes no mask), as in JAX. A fused window
stacks its masks on the device once and runs the runtime's dense round per
round with that round's slice, reading the ``int32[T, V]`` residuals in
one host sync; those rows are the window's flight record
(``chaos_window``), drained into the telemetry plane with its ledger
row.

On a runtime sharded across processes (the gather path) every process
runs the same timeline: each round's full mask reaches the runtime, whose
gather round takes this process's rows of it; crashed rows freeze and
corruptions land at the process that holds them; degraded reads and their
repairs read rows from their owners and write through the runtime's owner
window. Frontier rounds refuse there: the reference's fail there too.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..bridge_state import to_numpy
from ..lattice.base import tree_leaves, tree_map, tree_unflatten
from ..mesh.gossip import join_all, rows_traffic_bytes
from ..mesh.runtime import _across_reason
from ..ops.fused import window_masks
from ..telemetry import counter, events as tel_events, gauge, span
from ..telemetry.convergence import get_monitor


class ReplicaDownError(RuntimeError):
    """A client verb targeted a crashed replica. The reference's FSMs
    route around a down vnode via the preflist; the simulation surfaces
    the routing decision to the caller instead (use
    :meth:`ChaosRuntime.degraded_read` / a live replica row)."""


#: device masks a wrapper keeps (masks churn per round under flaky links)
_MASK_CACHE = 8


class ChaosRuntime:
    """One population + one fault timeline; see the module doc."""

    def __init__(self, runtime, schedule, checkpoint: "str | None" = None):
        if runtime.n_replicas != schedule.n_replicas:
            raise ValueError(
                f"schedule is for {schedule.n_replicas} replicas, runtime "
                f"has {runtime.n_replicas}"
            )
        if not np.array_equal(
            np.asarray(schedule.neighbors), runtime._host_neighbors
        ):
            raise ValueError(
                "schedule was compiled for a different neighbor table — "
                "build it from this runtime's topology"
            )
        self.rt = runtime
        self.schedule = schedule
        #: runtime checkpoint path backing Restore(source="checkpoint")
        self.checkpoint = checkpoint
        # graceful-leave handoff guard: a resize merge under this wrapper
        # must not move departing state across an active partition or out
        # of a crashed row. A FAULT-FREE wrapper (the QuorumRuntime
        # convenience wrap) installs nothing — its guard would be vacuous,
        # and overwriting here would neuter the guard of a real nemesis
        # wrapper sharing the runtime.
        if schedule.events:
            runtime._handoff_guard = self._check_handoff
        #: the membership epoch this wrapper's bookkeeping is based on —
        #: the O(1) staleness guard of :meth:`sync_membership`
        self._synced_epoch = runtime.membership_epoch
        self.round = 0
        self.crashed = np.zeros(runtime.n_replicas, dtype=bool)
        #: rows restored at the LAST step — the invariant harness's
        #: monotonicity exemption (a reseed is deliberately non-monotone)
        self.last_restored: list = []
        #: (var, row) pairs corrupted at the LAST step (silent state
        #: mutation — CorruptRows/BitRot events)
        self.last_corrupted: list = []
        #: full injection ledger: {"round", "var", "row", "kind"}
        self.injected_corruptions: list = []
        #: an attached AAE scrubber (``aae.AAEScrubber``: ``on_round_start``
        #: / ``on_round_end``)
        self.aae = None
        #: the reachability of the last (round, crash state) asked about:
        #: [key, mask, int32[R] labels or None, {label: reachable bool[R]}],
        #: see :meth:`_labels`
        self._label_memo = [None, None, None, {}]
        self.degraded_reads = 0
        self.repair_bytes = 0
        self.repaired_rows = 0
        self.duplicates_suppressed = 0
        self.crashes = 0
        self.restores = 0
        #: fused windows run and the rounds they held (one host sync each)
        self.fused_windows = 0
        self.fused_rounds = 0
        #: host mask identity -> (host mask, device mask)
        self._mask_cache: dict = {}

    # -- membership -----------------------------------------------------------
    def _check_handoff(self, sources, targets) -> None:
        """Refuse a graceful-leave handoff that would bypass the active
        fault state (installed as ``rt._handoff_guard``): a crashed
        departer's frozen row cannot be read gracefully, and a
        source→target pair spanning a partition cut would tunnel state
        through the mask host-side. Raises the typed
        :class:`~lasp_tpu_torch.membership.errors.HandoffPartitionError`."""
        from ..membership.errors import HandoffPartitionError

        # judge against bookkeeping re-based onto the CURRENT extent
        self.sync_membership()
        down = [int(s) for s in sources if self.crashed[int(s)]]
        if down:
            raise HandoffPartitionError(
                f"graceful leave refused: departing replica(s) "
                f"{down[:4]} are crashed — their frozen rows cannot be "
                "handed off; restore them first or take "
                "graceful=False (crash-leave) semantics"
            )
        down = [int(t) for t in targets if self.crashed[int(t)]]
        if down:
            raise HandoffPartitionError(
                f"graceful leave refused: claim target(s) {down[:4]} "
                "are crashed — a handoff cannot land on a down row"
            )
        mask = self.schedule.mask_at(self.round)
        if mask is None:
            return
        from ..quorum.fsm import components

        comp = components(self.rt._host_neighbors, mask, ~self.crashed)
        bad = [
            (int(s), int(t)) for s, t in zip(sources, targets)
            if comp[int(s)] != comp[int(t)]
        ]
        if bad:
            raise HandoffPartitionError(
                f"graceful leave refused: handoff pair(s) {bad[:4]} "
                "span a partition under the active chaos mask — the "
                "merge would be a host-side side channel through the "
                "cut; wait for heal or run the staged "
                "MembershipCoordinator (transfers park until reachable)"
            )

    def sync_membership(self) -> bool:
        """Re-base this wrapper's fault bookkeeping onto the runtime's
        CURRENT membership (after a resize / staged commit): the crashed
        vector resizes (surviving rows keep their flags; dropped rows
        leave with theirs), and the schedule re-compiles against the new
        extent/topology. Returns True when anything changed."""
        if self.rt.membership_epoch == self._synced_epoch:
            return False
        self._synced_epoch = self.rt.membership_epoch
        R = self.rt.n_replicas
        nbrs = self.rt._host_neighbors
        if (
            self.crashed.shape[0] == R
            and self.schedule.n_replicas == R
            and np.array_equal(np.asarray(self.schedule.neighbors), nbrs)
        ):
            return False
        old = self.crashed
        keep = min(old.shape[0], R)
        crashed = np.zeros(R, dtype=bool)
        crashed[:keep] = old[:keep]
        self.crashed = crashed
        self.schedule = self.schedule.rebase(R, nbrs)
        # the cached device masks are the old [R, K] shape
        self._mask_cache.clear()
        return True

    # -- fault actions --------------------------------------------------------
    def _crash(self, replica: int) -> None:
        if self.crashed[replica]:
            raise RuntimeError(f"replica {replica} is already down")
        self.crashed[replica] = True
        self.crashes += 1
        # the riak_dt incarnation rule: the dead row's actor lanes retire
        for key, site in list(self.rt._actor_sites.items()):
            if site == int(replica):
                self.rt._actor_sites[key] = -1
        counter(
            "chaos_faults_injected_total",
            help="chaos fault events activated, by kind",
            kind="crash",
        ).inc()
        tel_events.emit(
            "chaos", replica=int(replica), action="crash",
            round=self.round,
        )

    def _restore(self, replica: int, source: str) -> None:
        if not self.crashed[replica]:
            raise RuntimeError(f"replica {replica} is not down")
        rows = None
        if source == "checkpoint":
            if self.checkpoint is None:
                raise RuntimeError(
                    "Restore(source='checkpoint') needs a checkpoint "
                    "path — pass ChaosRuntime(..., checkpoint=path)"
                )
            from ..store.checkpoint import load_runtime_rows

            rows = load_runtime_rows(self.checkpoint, replica)
        self.rt.reseed_row(replica, rows)
        self.crashed[replica] = False
        self.restores += 1
        self.last_restored.append(int(replica))
        counter(
            "chaos_faults_injected_total",
            help="chaos fault events activated, by kind",
            kind="restore",
        ).inc()
        tel_events.emit(
            "chaos", replica=int(replica), action="restore",
            round=self.round, source=source,
        )

    def _apply_actions(self, rnd: int) -> None:
        from .schedule import Crash

        self.last_restored = []
        self.last_corrupted = []
        for ev in self.schedule.actions_at(rnd):
            if isinstance(ev, Crash):
                self._crash(ev.replica)
            else:
                self._restore(ev.replica, ev.source)
        for idx, ev, shot in self.schedule.corruptions_at(rnd):
            self._inject_corruption(ev, idx, shot, rnd)

    # -- silent corruption (CorruptRows / BitRot) -----------------------------
    def _inject_corruption(self, ev, idx: int, shot: int,
                           rnd: int) -> None:
        """Apply one corruption event: mutate ``ev.n_rows`` seeded LIVE
        replica rows directly in device state, bypassing every
        dirty-tracking path. Pure function of ``(seed, schedule, round,
        state)`` — replays bit-identically, and draws the rows the JAX
        package draws."""
        from .schedule import _mix

        live = np.flatnonzero(~self.crashed)
        if live.size == 0:
            return
        base = (
            (self.schedule.seed * 1_000_003 + idx * 7919)
            ^ ((rnd + 1) * 2_654_435)
        ) + shot * 65_537
        var_ids = (
            [ev.var] if ev.var is not None else list(self.rt.var_ids)
        )
        if not var_ids:
            return
        for j in range(int(ev.n_rows)):
            draw = _mix(
                np.asarray([j * 3 + 1, j * 3 + 2, j * 3 + 3],
                           dtype=np.uint64),
                base,
            )
            row = int(live[int(draw[0] * live.size) % live.size])
            var = var_ids[int(draw[1] * len(var_ids)) % len(var_ids)]
            salt = int(draw[2] * (1 << 31))
            if not self._mutate_row(var, row, ev.kind, salt):
                continue  # target held nothing to corrupt this way
            rec = {"round": int(rnd), "var": var, "row": row,
                   "kind": ev.kind}
            self.injected_corruptions.append(rec)
            self.last_corrupted.append((var, row))
            counter(
                "chaos_faults_injected_total",
                help="chaos fault events activated, by kind",
                kind="corrupt",
            ).inc()
            tel_events.emit(
                "chaos", var=var, replica=row, action="corrupt",
                kind=ev.kind, round=int(rnd),
            )

    def _mutate_row(self, var: str, row: int, kind: str,
                    salt: int) -> bool:
        """One row mutation by kind; returns False when the target row
        carried nothing this kind can corrupt. The row is mutated on the
        host in the JAX package's dtypes (packed words as ``uint32``, so a
        rollback halves the same lane JAX halves) and written back out of
        place: the population's leaves are replaced, never written. Across
        processes every process reads the row from its owner and the owner
        writes it."""
        rt = self.rt
        pop = rt._population(var)
        leaves = tree_leaves(pop)
        host = [np.array(x) for x in tree_leaves(to_numpy(rt._row_of(var, row)))]
        changed = False
        if kind == "bitflip":
            for off in range(len(host)):
                li = (salt + off) % len(host)
                flat = host[li].reshape(-1)
                if flat.size == 0:
                    continue
                pos = (salt // 7) % flat.size
                if flat.dtype == np.bool_:
                    flat[pos] = ~flat[pos]
                else:
                    # bits-1: np.int32(1 << 31) would overflow the
                    # scalar conversion for signed dtypes
                    bits = flat.dtype.itemsize * 8 - 1
                    flat[pos] = flat[pos] ^ flat.dtype.type(
                        1 << ((salt // 11) % bits)
                    )
                changed = True
                break
        elif kind == "rollback":
            # halve a positive integer lane (counter/clock rollback);
            # prefer the FIRST int leaf (gcounter counts, orswot clock)
            for off in range(len(host)):
                flat = host[off].reshape(-1)
                if flat.dtype == np.bool_ or flat.size == 0:
                    continue
                positive = np.flatnonzero(flat.astype(np.int64) > 0)
                if positive.size == 0:
                    continue
                pos = int(positive[(salt // 7) % positive.size])
                flat[pos] = flat[pos] // 2
                changed = True
                break
        elif kind == "truncate":
            # zero the tail half of the LAST wire plane
            flat = host[-1].reshape(-1)
            tail = flat[flat.size // 2:]
            if tail.size and np.any(tail != 0):
                tail[:] = 0
                changed = True
        else:
            raise ValueError(f"unknown corruption kind {kind!r}")
        if not changed:
            return False

        keep, local = rt._held_rows([row])

        def put(leaf, h):
            out = leaf.clone()
            if keep[0]:
                out[int(local[0])] = rt._row_leaf(h, leaf)
            return out

        # direct state write ON PURPOSE: no dirty marks — the corruption
        # is silent, which is what an AAE verify pass exists to catch
        rt.states[var] = tree_unflatten(
            pop, [put(x, h) for x, h in zip(leaves, host)]
        )
        return True

    def _needs_freeze(self) -> bool:
        """Gossip alone cannot move a crashed row (its every edge is
        masked); only local dataflow sweeps / triggers can — freeze is
        needed exactly then."""
        return bool(self.crashed.any()) and bool(
            self.rt.graph.edges or self.rt._triggers
        )

    def _account_duplicates(self, rnd: int, alive=None) -> None:
        """At-least-once accounting for one executed round: duplicated
        deliveries are no-ops under the idempotent join, so they only
        COUNT."""
        dup = self.schedule.duplicate_links_at(rnd, alive=alive)
        if dup:
            self.duplicates_suppressed += dup
            counter(
                "chaos_duplicate_deliveries_total",
                help="duplicated gossip deliveries absorbed by join "
                     "idempotence (DuplicateLinks accounting)",
            ).inc(dup)

    def _emit_round_gauges(self, mask) -> None:
        gauge(
            "chaos_replicas_crashed",
            help="replicas currently failed-stop under chaos",
        ).set(int(self.crashed.sum()))
        gauge(
            "chaos_links_dead",
            help="directed gossip edges dead under the current chaos "
                 "mask",
        ).set(0 if mask is None else int((~np.asarray(mask)).sum()))

    # -- stepping -------------------------------------------------------------
    def step(self, mode: str = "dense") -> int:
        """ONE chaos round: apply this round's crash/restore actions,
        compile the round's mask, dispatch the runtime's own step
        (``mode`` = ``"dense"`` | ``"frontier"``), and freeze crashed
        rows across it. Returns the step's residual (the engine
        contract). Deterministic in ``(seed, schedule, state)``."""
        rnd = self.round
        if mode == "frontier" and self.rt._gather_across():
            # refused before the round's actions run: nothing moves
            raise RuntimeError(
                "frontier chaos rounds unavailable: a fault window's change "
                "degrades every frontier to all-dirty, the dense arm, which "
                f"across processes is {_across_reason(2)}"
            )
        self.sync_membership()
        self._apply_actions(rnd)
        if self.aae is not None:
            self.aae.on_round_start(rnd)
        mask = self.schedule.mask_at(rnd)
        self._account_duplicates(rnd, alive=mask)
        frozen = None
        if self._needs_freeze():
            # each process freezes the crashed rows it holds
            _keep, local = self.rt._held_rows(np.flatnonzero(self.crashed))
            crash_rows = torch.as_tensor(local, device=self.rt.device)
            frozen = {
                v: tree_map(lambda x: x[crash_rows], self.rt.states[v])
                for v in self.rt.var_ids
            }
        dmask = None if mask is None else self._device_mask(mask)
        if mode == "frontier":
            residual = self.rt.frontier_step(dmask)
        elif mode == "dense":
            residual = self.rt.step(dmask)
        else:
            raise ValueError(f"unknown mode {mode!r} (dense | frontier)")
        if frozen is not None:
            # a down replica executes nothing: local sweeps that moved
            # its row are rolled back, out of place (the step's inputs
            # may share storage with these leaves)
            for v in self.rt.var_ids:
                self.rt.states[v] = tree_map(
                    lambda x, fr: x.index_copy(0, crash_rows, fr),
                    self.rt.states[v], frozen[v],
                )
        self._emit_round_gauges(mask)
        self.round += 1
        if self.aae is not None:
            self.aae.on_round_end(rnd)
        return residual

    def _device_mask(self, mask):
        """One device transfer per DISTINCT host mask, keyed by OBJECT
        IDENTITY (the schedule returns the same array across a stable
        fault window — the identity the frontier mask-tagging keys on).
        The cache entry holds the host array itself: ``id()`` alone is
        unsound, because a freed mask's address (and so its id) is reused
        by the next allocation, and a stale hit would dispatch the WRONG
        mask — the stored reference both pins the id and lets the hit
        verify ``is`` before trusting it. The runtime is primed with the
        pair, so its step copies the mask neither way."""
        cached = self._mask_cache.get(id(mask))
        if cached is not None and cached[0] is mask:
            dev = cached[1]
        else:
            # bound the cache: masks churn per round under flaky links
            for k in list(self._mask_cache)[: -(_MASK_CACHE - 1)]:
                del self._mask_cache[k]
            dev = torch.as_tensor(mask, device=self.rt.device)
            self._mask_cache[id(mask)] = (mask, dev)
        self.rt._prime_mask(dev, np.asarray(mask, dtype=bool))
        return dev

    def fused_steps(self, n_rounds: int) -> list:
        """Run ``n_rounds`` chaos rounds with one host sync: the window's
        per-round masks stack into a ``bool[T, R, K]`` device tensor (one
        copy) and the runtime's full dense round (sweep + gossip + per-var
        residuals) runs once per round with that round's mask — the chaos
        twin of ``ReplicatedRuntime.fused_steps``. A round here is the
        runtime's whole step over every variable, as JAX's window runs its
        step function, so the window does not go through
        ``ops.fused.fused_chaos_rounds`` (one variable's gossip alone); it
        shares that function's mask stack. The window must contain
        no crash/restore action (those need host-side row surgery;
        :meth:`soak` splits windows at action rounds) and no live crash
        freeze with dataflow edges. Returns the per-round residual totals
        (read from the device's ``int32[T, V]`` in one sync)."""
        if n_rounds < 1:
            raise ValueError("n_rounds must be >= 1")
        nxt = self.schedule.next_action_round(self.round - 1)
        if nxt is not None and nxt < self.round + n_rounds:
            raise RuntimeError(
                f"fused chaos window [{self.round}, "
                f"{self.round + n_rounds}) crosses a crash/restore "
                f"action at round {nxt} — split the window there"
            )
        if self._needs_freeze():
            raise RuntimeError(
                "fused chaos windows cannot freeze crashed rows around "
                "dataflow sweeps — step per round while replicas are "
                "down on a graph-carrying runtime"
            )
        rt = self.rt
        tables = rt._ensure_step()
        # per-round masks invalidate row knowledge wholesale (the
        # conservative opaque-block rule); sync against a sentinel so the
        # degrade happens ONCE here, not per mask
        rt._frontier_sync_mask(self)
        masks = self.schedule.masks(self.round, self.round + n_rounds)
        states_in = dict(rt.states)
        with span("chaos.fused_window", rounds=n_rounds):
            t0 = time.perf_counter()
            try:
                dev_masks = window_masks(masks, rt.device)
                res = []
                for t in range(n_rounds):
                    # the round's slice and its host view, copied neither way
                    mask_t = dev_masks[t]
                    rt._prime_mask(mask_t, masks[t])
                    res.append(rt._dense_round(mask_t, tables))
                res = torch.stack(res).cpu().numpy()  # [T, V]: the one sync
            except Exception:
                rt._restore_states(states_in)
                raise
            elapsed = time.perf_counter() - t0
        totals = res.sum(axis=1) if res.size else np.zeros(n_rounds, np.int64)
        # masks varied inside the block: even a zero tail only proves a
        # MASKED fixed point — degrade (the opaque-block rule)
        rt._frontier_after_opaque(False)
        rt.trace.record_round(int(totals[-1]), elapsed)
        rt._record_rounds(n_rounds)
        # flight drain: the window's [T, V] residual rows are its record
        # (T rows, no modulo; quiescent=None — a masked zero round proves
        # only a MASKED fixed point), plus the exact ledger join tally; the
        # stacked-mask window is its own ledger family, keyed by length
        joins = rt._drain_flight("chaos_window", res, n_rounds, None, elapsed)
        rt._ledger_record_store("chaos_window", elapsed, n_rounds,
                                block=n_rounds, joins=joins)
        self.fused_windows += 1
        self.fused_rounds += n_rounds
        for t in range(n_rounds):
            self._account_duplicates(self.round, alive=masks[t])
            self.round += 1
        self._emit_round_gauges(masks[-1])
        if self.aae is not None:
            self.aae.on_round_end(self.round - 1)
        return [int(x) for x in totals]

    # -- degraded reads + read-repair -----------------------------------------
    def live_replicas(self) -> np.ndarray:
        return np.flatnonzero(~self.crashed)

    def _labels(self, rnd: int) -> np.ndarray:
        """``int32[R]`` live-component labels under the round-``rnd`` mask
        and the current crash state (``quorum.fsm.components``), memoized:
        every caller in one round and crash state (a scrub's pairing, each
        written row's backup, a degraded read) shares one labelling."""
        from ..quorum.fsm import components

        memo = self._reach_memo(rnd)
        if memo[2] is None:
            memo[2] = components(self.rt._host_neighbors, memo[1], ~self.crashed)
        return memo[2]

    def _reach_memo(self, rnd: int) -> list:
        """The memo entry of round ``rnd`` under the current crash state,
        its mask compiled once (``schedule.mask_at`` recompiles per call)."""
        key = (int(rnd), id(self.schedule), self.rt.membership_epoch,
               np.packbits(self.crashed).tobytes())
        if self._label_memo[0] != key:
            self._label_memo = [key, self.schedule.mask_at(int(rnd)), None, {}]
        return self._label_memo

    def _reachable_live(self, coordinator: int,
                        rnd: "int | None" = None) -> np.ndarray:
        """``bool[R]``: live replicas the coordinator can actually REACH
        over links alive under the round-``rnd`` mask (default: the
        CURRENT round). A quorum must come from here — a host-side read
        spanning a partition would be a side channel through the cut.
        Chaos masks are pair-symmetric, so this is undirected connectivity
        over the live pairs: the rows sharing the coordinator's label in
        the memoized labelling (:meth:`_labels`), masked by ``live``. A
        crashed coordinator's label is its own index, which no live row
        carries, so it reaches nothing — what JAX's BFS
        (:meth:`_reachable_live_bfs`) gives."""
        live = ~self.crashed
        rnd = self.round if rnd is None else int(rnd)
        if self._reach_memo(rnd)[1] is None:
            return live
        label = self._labels(rnd)
        by_label = self._label_memo[3]
        lab = int(label[int(coordinator)])
        got = by_label.get(lab)
        if got is None:
            got = by_label[lab] = (label == lab) & live
            got.flags.writeable = False  # shared by the component's callers
        return got

    def _reachable_live_bfs(self, coordinator: int,
                            rnd: "int | None" = None) -> np.ndarray:
        """The plain version of :meth:`_reachable_live`: JAX's host BFS of
        up to R sweeps over the live pairs."""
        live = ~self.crashed
        mask = self.schedule.mask_at(
            self.round if rnd is None else int(rnd)
        )
        nbrs = self.rt._host_neighbors
        if mask is None:
            return live
        alive_edge = np.asarray(mask, bool) & live[nbrs] & live[:, None]
        comp = np.zeros(self.rt.n_replicas, dtype=bool)
        comp[coordinator] = True
        for _ in range(self.rt.n_replicas):
            # expand over live pairs in BOTH roles: rows pulling a
            # component member, and rows a component member pulls
            fwd = (alive_edge & comp[nbrs]).any(axis=1)
            rev = np.zeros_like(comp)
            rev[nbrs[alive_edge & comp[:, None]]] = True
            new = comp | fwd | rev
            if (new == comp).all():
                break
            comp = new
        return comp & live

    def degraded_read(self, var_id: str, k: int = 2, repair: bool = True,
                      coordinator: "int | None" = None):
        """Quorum read from K LIVE, REACHABLE replicas — the reference's
        R=2 first-replies read under failures: crashed rows are excluded,
        and the quorum is drawn from the replicas the ``coordinator``
        (default: the first live replica) can reach over links alive under
        the current round's mask. The first ``k`` such rows (deterministic
        preflist order) answer; their join is the returned value.

        With ``repair=True`` (default) the read triggers READ-REPAIR as a
        masked partial join (``ReplicatedRuntime.join_rows``): the
        quorum's join merges back into exactly the rows read, changed rows
        mark frontier-dirty, and the wire cost is accounted per row
        actually changed. Returns the decoded value."""
        live = self.live_replicas()
        if live.size == 0:
            raise ReplicaDownError(
                f"degraded_read({var_id!r}): every replica is down"
            )
        if coordinator is None:
            coordinator = int(live[0])
        elif self.crashed[coordinator]:
            raise ReplicaDownError(
                f"degraded_read({var_id!r}): coordinator {coordinator} "
                "is down"
            )
        reachable = np.flatnonzero(self._reachable_live(int(coordinator)))
        k = min(int(k), int(reachable.size))
        # coordinator-first preflist order (its own row always replies)
        picks = np.concatenate(
            [[int(coordinator)], reachable[reachable != int(coordinator)]]
        ).astype(np.int64)[:k]
        value = self.rt.quorum_value(var_id, picks)
        self.degraded_reads += 1
        counter(
            "chaos_degraded_reads_total",
            help="quorum reads answered from live replicas while the "
                 "population was degraded",
        ).inc()
        repaired = 0
        if repair:
            pop = self.rt._population(var_id)
            codec, spec = self.rt._mesh_meta(var_id)
            top = join_all(codec, spec, self.rt._rows_of(var_id, picks))
            repaired = self.rt.join_rows(var_id, picks, top)
            if repaired:
                bytes_ = rows_traffic_bytes(pop, repaired)
                self.repair_bytes += bytes_
                self.repaired_rows += repaired
                counter(
                    "chaos_repair_bytes_total",
                    help="estimated bytes moved by degraded-read "
                         "read-repair partial joins",
                ).inc(bytes_)
        tel_events.emit(
            "chaos", var=var_id, action="degraded_read",
            quorum=[int(p) for p in picks], repaired_rows=repaired,
        )
        return value

    def write_at(self, replica: int, var_id: str, op: tuple, actor) -> None:
        """``update_at`` with availability semantics: a write routed to a
        crashed replica is REFUSED."""
        if self.crashed[replica]:
            raise ReplicaDownError(
                f"replica {replica} is down; route the write to a live "
                f"replica ({self.live_replicas()[:4].tolist()}...)"
            )
        self.rt.update_at(replica, var_id, op, actor)

    def write_batch(self, var_id: str, ops) -> None:
        """``update_batch`` with availability semantics — the batched twin
        of :meth:`write_at`: the ops BEFORE the first one targeting a
        crashed replica apply, the refused op raises
        :class:`ReplicaDownError` (``batch_index`` set) with nothing of
        itself or its suffix applied."""
        ops = list(ops)
        down = next(
            (k for k, (r, _op, _a) in enumerate(ops)
             if self.crashed[int(r)]),
            None,
        )
        if down is None:
            self.rt.update_batch(var_id, ops)
            return
        if down:
            self.rt.update_batch(var_id, ops[:down])
        replica = int(ops[down][0])
        err = ReplicaDownError(
            f"replica {replica} is down; route the write to a live "
            f"replica ({self.live_replicas()[:4].tolist()}...)"
        )
        err.batch_index = down
        raise err

    # -- the soak driver ------------------------------------------------------
    def soak(self, max_rounds: int = 4096, mode: str = "dense",
             block: int = 1,
             reads_per_round: int = 0, read_var: "str | None" = None,
             read_quorum: int = 2) -> dict:
        """Run the WHOLE timeline and measure recovery: rounds execute
        (optionally issuing ``reads_per_round`` degraded reads against
        ``read_var`` while faults are active) until every fault has
        cleared AND the population quiesces. ``block > 1`` runs
        action-free windows through :meth:`fused_steps` on runtimes
        without graphs/triggers.

        Returns the soak report: ``rounds``, ``rounds_to_heal`` (rounds
        past the schedule horizon to quiescence — the recovery metric),
        ``degraded_reads`` / ``repair_bytes`` / ``repaired_rows``,
        ``duplicates_suppressed``, ``crashes`` / ``restores``, and
        ``healed`` (no replica left down). The report also lands in the
        ConvergenceMonitor's ``chaos`` section and the
        ``chaos_rounds_to_heal`` gauge."""
        horizon = self.schedule.horizon
        residual = -1
        with span("chaos.soak", mode=mode, horizon=horizon):
            while self.round < max_rounds:
                rnd = self.round
                in_window = rnd < horizon
                can_fuse = (
                    block > 1
                    and mode == "dense"
                    and not (self.rt.graph.edges or self.rt._triggers)
                    and not (reads_per_round and in_window)
                )
                nxt = self.schedule.next_action_round(rnd - 1)
                if can_fuse and (nxt is None or nxt > rnd):
                    width = block if nxt is None else min(block, nxt - rnd)
                    # actions take effect at round start: a window may
                    # not even BEGIN on an action or injection round
                    if not self.schedule.actions_at(rnd) and not (
                        self.schedule.corruptions_at(rnd)
                    ):
                        res = self.fused_steps(width)
                        residual = res[-1]
                        if residual == 0 and self.round > horizon:
                            break
                        continue
                residual = self.step(mode=mode)
                if reads_per_round and in_window and read_var is not None:
                    for _ in range(reads_per_round):
                        self.degraded_read(read_var, k=read_quorum)
                if residual == 0 and self.round > horizon:
                    break
            else:
                raise RuntimeError(
                    f"chaos soak did not quiesce within {max_rounds} "
                    "rounds"
                )
        healed = not bool(self.crashed.any())
        rounds_to_heal = max(0, self.round - horizon)
        gauge(
            "chaos_rounds_to_heal",
            help="rounds from the last fault clearing to quiescence in "
                 "the latest chaos soak",
        ).set(rounds_to_heal)
        report = {
            "rounds": self.round,
            "horizon": horizon,
            "rounds_to_heal": rounds_to_heal,
            "healed": healed,
            "residual": int(residual),
            "crashes": self.crashes,
            "restores": self.restores,
            "degraded_reads": self.degraded_reads,
            "repaired_rows": self.repaired_rows,
            "repair_bytes": self.repair_bytes,
            "duplicates_suppressed": self.duplicates_suppressed,
        }
        get_monitor().observe_chaos(**report)
        tel_events.emit("chaos", action="soak_done", **report)
        return report
