"""Incremental ownership handoff — the transfer engine (port of
``lasp_tpu.membership.handoff``).

A committed membership plan's ``transfers`` (``(source_row, target_row)``
pairs) execute INCREMENTALLY, interleaved with live gossip / serve cycles:

- **capped**: at most ``per_cycle`` transfers dispatch per cycle;
- **grouped**: a cycle's pairs join every variable's source rows into its
  target rows, plan group by plan group (``mesh.plan.signature_of``);
  where JAX stacks a group and vmaps one jitted gather-merge-scatter, each
  member here takes a gather, the codec's batched ``merge`` / ``equal``
  and an in-place ``index_copy_`` over the real targets (no pad slot is
  built, so none reaches the card);
- **chaos-aware**: a pair dispatches only when source and target are live
  and share a component under the current chaos mask (the chaos engine's
  memoized labelling, ``quorum.fsm.components``); unreachable pairs PARK;
- **idempotent**: a transfer is a partial join, so the coordinator's
  finalize SWEEP re-joins pairs until a clean pass.

Each plan group's transfer is one ``handoff_transfer`` record in the
kernel cost ledger (``rows`` the real pairs: the port builds no pad slot);
:attr:`HandoffEngine.transfer_seconds` totals the dispatches' host time,
device work included.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..lattice.base import tree_leaves, tree_map
from ..mesh.plan import signature_of
from ..telemetry import counter, events as tel_events, gauge, span
from ..telemetry.roofline import get_ledger
from ..utils.metrics import Timer

_OUTCOMES_HELP = (
    "staged ownership transfers, by outcome (done = dispatched this cycle, "
    "parked = deferred unreachable, lost_src = departer crashed at "
    "finalize)"
)


def grouped_transfer(rt, pairs) -> int:
    """Join each pair's source row into its target row for EVERY variable,
    plan group by plan group. ``pairs``: ``[(src, dst), ...]`` with UNIQUE
    targets (the engine's cycle selection defers duplicate targets). Every
    target row takes its merge; the rows that changed mark frontier- and
    AAE-dirty. Returns the rows changed across variables. Across processes
    a variable's source and target rows are pulled to every process, the
    same merge runs there (so every process marks the same rows) and the
    targets land by owner (``rt._owner_window``)."""
    if not pairs:
        return 0
    srcs = np.asarray([p[0] for p in pairs], dtype=np.int64)
    dsts = np.asarray([p[1] for p in pairs], dtype=np.int64)
    if np.unique(dsts).size != dsts.size:
        raise ValueError(
            "grouped_transfer: duplicate target rows in one cycle — "
            "the scatter would race; defer the duplicates"
        )
    by_sig: dict = {}
    for v in rt.var_ids:
        sig = signature_of(rt, v)
        by_sig.setdefault(sig if sig is not None else ("__singleton__", v),
                          []).append(v)
    n_replicas = rt.n_replicas
    win = None
    if rt._dist is not None:
        from ..mesh.runtime import _RowWindow

        win = _RowWindow(np.concatenate([srcs, dsts]), n_replicas)
        srcs, dsts = win.compact(srcs), win.compact(dsts)
    src_idx = torch.as_tensor(srcs, device=rt.device)
    dst_idx = torch.as_tensor(dsts, device=rt.device)
    total_changed = 0
    with span("membership.transfer", rows=len(pairs), groups=len(by_sig)):
        for members in by_sig.values():
            t0 = time.perf_counter()
            for v in members:
                with (rt._owner_window((v,), win) if win is not None
                      else contextlib.nullcontext()):
                    total_changed += _transfer(rt, v, srcs, dsts, src_idx, dst_idx)
            # the members' changed flags came to the host: the group's
            # seconds close there
            codec, _spec = rt._mesh_meta(members[0])
            get_ledger().record(
                "handoff_transfer",
                getattr(codec, "name", type(codec).__name__),
                n_replicas=n_replicas,
                fanout=1,
                seconds=time.perf_counter() - t0,
                row_bytes=rt._row_bytes(members[0]),
                rows=len(pairs),
                g_active=len(members),
            )
    return total_changed


def _transfer(rt, v: str, srcs, dsts, src_idx, dst_idx) -> int:
    """:func:`grouped_transfer`'s join of one variable's source rows into
    its target rows (replica rows, or window positions across processes).
    Returns the rows changed."""
    pop = rt._population(v)
    codec, spec = rt._mesh_meta(v)
    src_rows = tree_map(lambda x: x[src_idx], pop)
    dst_rows = tree_map(lambda x: x[dst_idx], pop)
    merged = codec.merge(spec, dst_rows, src_rows)
    changed = (~codec.equal(spec, dst_rows, merged)).cpu().numpy()
    for x, m in zip(tree_leaves(pop), tree_leaves(merged)):
        x.index_copy_(0, dst_idx, m.to(x.dtype))
    ch_rows = dsts[changed]
    if ch_rows.size:
        rt._mark_dirty_rows(v, ch_rows)
    return int(ch_rows.size)


class HandoffEngine:
    """Executes one plan's transfer schedule incrementally (see the module
    doc); driven by ``MembershipCoordinator``, one :meth:`cycle` per
    interleaved gossip round."""

    def __init__(self, ch, transfers, *, per_cycle: int = 8,
                 old_n: "int | None" = None, new_n: "int | None" = None):
        self.ch = ch
        self.rt = ch.rt
        self.per_cycle = max(1, int(per_cycle))
        #: the plan's transition extents (telemetry provenance)
        self.old_n = int(old_n if old_n is not None else ch.rt.n_replicas)
        self.new_n = int(new_n if new_n is not None else ch.rt.n_replicas)
        #: pending (src, dst) pairs, deterministic schedule order
        self.pending: list = list(transfers)
        self.completed: list = []
        self.cycles = 0
        self.parked_events = 0
        self.transferred = 0
        self.changed_rows = 0
        self.transfer_bytes = 0
        self.transfer_seconds = 0.0
        self.max_batch = 0
        self.pending_high_water = len(self.pending)

    @property
    def outstanding(self) -> int:
        return len(self.pending)

    def _reachable(self, comp, src: int, dst: int) -> bool:
        return (
            not self.ch.crashed[src]
            and not self.ch.crashed[dst]
            and comp[src] == comp[dst]
        )

    def _components(self):
        mask = self.ch.schedule.mask_at(self.ch.round)
        if mask is None and not self.ch.crashed.any():
            # fault-free round: one component, everything reachable
            return np.zeros(self.rt.n_replicas, dtype=np.int32)
        return self.ch._labels(self.ch.round)

    def _select_and_dispatch(self, pairs, cap) -> tuple:
        """THE selection rule of :meth:`cycle` and the finalize sweep:
        dispatch up to ``cap`` mutually-reachable pairs with DISTINCT
        targets in one grouped call; everything else stays in schedule
        order. Returns ``(batch, rest, parked, changed_rows)``."""
        comp = self._components()
        batch, rest, parked, seen = [], [], 0, set()
        for src, dst in pairs:
            ok = self._reachable(comp, src, dst)
            if ok and (cap is None or len(batch) < cap) and dst not in seen:
                batch.append((src, dst))
                seen.add(dst)
            else:
                if not ok:
                    parked += 1
                rest.append((src, dst))
        changed = self._dispatch(batch) if batch else 0
        return batch, rest, parked, changed

    def dispatch_pairs(self, pairs) -> "tuple[int, int, list]":
        """Uncapped sweep: dispatch EVERY reachable pair (duplicate targets
        in successive waves). Returns ``(dispatched, changed_rows,
        parked_pairs)``."""
        dispatched = changed = 0
        remaining = list(pairs)
        while True:
            batch, remaining, parked, ch = self._select_and_dispatch(
                remaining, None
            )
            dispatched += len(batch)
            changed += ch
            if not batch or len(remaining) == parked:
                return dispatched, changed, remaining

    def _dispatch(self, batch) -> int:
        with Timer() as t:
            changed = grouped_transfer(self.rt, batch)
        self.transfer_seconds += t.elapsed
        bytes_ = sum(self.rt._row_bytes(v) for v in self.rt.var_ids) * len(batch)
        self.transfer_bytes += bytes_
        self.changed_rows += changed
        counter(
            "membership_transfer_bytes_total",
            help="estimated bytes moved by staged ownership-transfer "
                 "partial joins",
        ).inc(bytes_)
        return changed

    def cycle(self) -> dict:
        """One transfer cycle: take up to ``per_cycle`` pending pairs whose
        endpoints are mutually reachable this round, dispatch them grouped,
        park the rest. Returns the cycle's accounting."""
        self.cycles += 1
        out = {"transfers": 0, "parked": 0, "changed_rows": 0,
               "outstanding": len(self.pending)}
        if not self.pending:
            return out
        batch, rest, parked, changed = self._select_and_dispatch(
            self.pending, self.per_cycle
        )
        self.pending = rest
        self.completed.extend(batch)
        self.transferred += len(batch)
        self.parked_events += parked
        self.max_batch = max(self.max_batch, len(batch))
        counter("membership_transfers_total", help=_OUTCOMES_HELP,
                outcome="done").inc(len(batch))
        if parked:
            counter("membership_transfers_total", help=_OUTCOMES_HELP,
                    outcome="parked").inc(parked)
        gauge(
            "membership_pending_transfers",
            help="ownership transfers still pending in the active "
                 "membership plan",
        ).set(len(self.pending))
        if batch or parked:
            tel_events.emit(
                "membership", kind="transfer_cycle",
                old_n=self.old_n, new_n=self.new_n,
                transfers=len(batch), parked=parked,
                changed_rows=changed, outstanding=len(self.pending),
            )
        out.update({
            "transfers": len(batch), "parked": parked,
            "changed_rows": changed, "outstanding": len(self.pending),
        })
        return out
