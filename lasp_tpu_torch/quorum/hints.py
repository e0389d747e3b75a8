"""The durable hint log behind hinted handoff on ``Restore`` (port of
``lasp_tpu.quorum.hints``).

Dynamo/riak hinted handoff: a write whose home replica is unreachable
lands on a fallback node together with a HINT naming the intended home;
when the home returns, the fallback hands the write off before the home
rejoins quorums. The TPU rebuild keeps the protocol's guarantee with a
simpler mechanism suited to the simulation's single host: every
client-ACKED put appends one record — ``(var, preflist, wire row)`` —
to this log; when a crashed replica restores
(``ChaosRuntime._restore`` → the engine's restore hook), every record
whose preflist names it is JOINED into the restored row before the
replica serves another quorum. Join idempotence makes replay harmless
(a row that already absorbed the write is a no-op), and the log is the
mechanism behind the no-acknowledged-write-lost invariant
(``chaos.invariants.check_no_write_lost``): a put acked at W=2 whose
ack replicas BOTH crash and restore from the lattice bottom would
otherwise be lost entirely — the rolling-crash nemesis's signature
failure.

Durability: with a ``path``, every append pickles the record to an
append-only file (flushed per record, the bitcask discipline of the
bridge's host log) and a fresh :class:`HintLog` over the same path
replays the survivors — a process restart keeps its acked writes.
Records hold host numpy rows in this package's leaf dtypes (packed words
as the ``int32`` view) and are read back by this package only.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..lattice.base import tree_map
from ..telemetry import counter, gauge


def _host_row(row):
    """A row state as host numpy copies (never views of live tensors)."""
    return tree_map(
        lambda x: x.detach().cpu().numpy().copy()
        if hasattr(x, "detach") else np.array(x),
        row,
    )


class HintLog:
    """Append-only log of client-acked quorum puts; see the module doc.

    Records are host trees (numpy leaves) of ONE replica row in the
    runtime's MESH wire format, so replay is a plain leafwise join
    against the live population."""

    def __init__(self, path: "str | None" = None):
        self.path = path
        self.records: list = []  # (var_id, picks int64[N], row-tree, rid)
        #: replica -> record indices naming it (restores scan only their
        #: own slice, not the whole history)
        self._by_replica: dict = {}
        self.replays = 0
        if path is not None and os.path.exists(path):
            self._load(path)

    def __len__(self) -> int:
        return len(self.records)

    def _load(self, path: str) -> None:
        with open(path, "rb") as fp:
            while True:
                try:
                    self._index(pickle.load(fp))
                except EOFError:
                    break

    def _index(self, rec) -> None:
        idx = len(self.records)
        self.records.append(rec)
        for r in rec[1]:
            self._by_replica.setdefault(int(r), []).append(idx)

    def append(self, var_id: str, picks, row, rid: int) -> None:
        """Record one acked put. ``row`` is the put's wire-format row
        (device or host leaves; stored as host copies so the log never
        pins device buffers)."""
        host_row = _host_row(row)
        rec = (var_id, np.asarray(picks, dtype=np.int64).copy(), host_row,
               int(rid))
        self._index(rec)
        if self.path is not None:
            with open(self.path, "ab") as fp:
                pickle.dump(rec, fp)
                fp.flush()
                os.fsync(fp.fileno())
        gauge(
            "quorum_hints_pending",
            help="hinted-handoff records held for crashed-replica catch-up",
        ).set(len(self.records))

    def pending_for(self, replica: int) -> list:
        """Records whose preflist names ``replica`` — what a restore
        must hand off before the row rejoins quorums. Indexed per
        replica, so a restore scans its own slice, not the whole
        history. Records PERSIST after a replay on purpose: a replica
        that crashes AGAIN and reseeds from bottom needs them again
        (re-joins are idempotent no-ops on caught-up rows); reclaim via
        :meth:`prune` once the population has verifiably converged."""
        return [
            self.records[i]
            for i in self._by_replica.get(int(replica), ())
        ]

    def replay(self, runtime, replica: int,
               target: "int | None" = None) -> int:
        """Hand off every pending hint naming ``replica``: each
        record's row joins into ``states[var][target]`` — ``target``
        defaults to ``replica`` itself (the restore path); a membership
        finalize passes the departed replica's CLAIM SUCCESSOR instead
        (the lost_src fallback: the replica will never restore, so its
        acked writes land where its ownership went). An exact no-op
        where gossip already caught the target up — idempotence.
        Returns the number of rows actually changed. The restore caller
        (the quorum engine's restore hook) runs this BEFORE the replica
        serves another quorum — the ordering hinted handoff promises."""
        tgt = int(replica if target is None else target)
        changed = 0
        for var_id, _picks, row, _rid in self.pending_for(replica):
            if var_id not in runtime.var_ids:
                continue
            changed += runtime.join_rows(
                var_id, np.asarray([tgt], dtype=np.int64), [row]
            )
        self.replays += 1
        if changed:
            counter(
                "quorum_hint_replays_total",
                help="hinted-handoff rows handed to restored replicas "
                     "(rows actually changed by replay)",
            ).inc(changed)
        return changed

    def prune(self) -> int:
        """Drop every record (call once the population has verifiably
        converged past the log's writes — e.g. after a fault-free
        ``run_to_convergence``). Returns the number dropped. The durable
        file is truncated too."""
        n = len(self.records)
        self.records.clear()
        self._by_replica.clear()
        if self.path is not None and os.path.exists(self.path):
            with open(self.path, "wb"):
                pass
        gauge(
            "quorum_hints_pending",
            help="hinted-handoff records held for crashed-replica catch-up",
        ).set(0)
        return n

    def _reindex(self, keep: list) -> None:
        """Replace the record set (prune rewrite): in-memory index and
        the durable file both rebuild from the survivors."""
        self.records = []
        self._by_replica = {}
        for rec in keep:
            self._index(rec)
        if self.path is not None:
            tmp = self.path + ".prune"
            with open(tmp, "wb") as fp:
                for rec in self.records:
                    pickle.dump(rec, fp)
                fp.flush()
                os.fsync(fp.fileno())
            os.replace(tmp, self.path)
        gauge(
            "quorum_hints_pending",
            help="hinted-handoff records held for crashed-replica catch-up",
        ).set(len(self.records))

    def prune_replayed(self, runtime, replica: int,
                       live=None) -> int:
        """Reclaim the hints a completed replay has RE-ACKED at full
        preflist strength: a record naming ``replica`` drops iff EVERY
        replica its preflist names is live and that replica's row
        already dominates the hinted row (the join would be an exact
        no-op — the write is held at all N homes again, the riak
        delete-after-handoff point). Anything weaker stays: a record
        whose preflist still has a crashed or lagging member remains
        load-bearing for the next bottom-restore (the
        no-acknowledged-write-lost contract). Returns records
        reclaimed. Called from the quorum engine's post-replay restore
        hook; repeat crashes therefore no longer accumulate fully
        re-acked records without bound."""
        pending = self._by_replica.get(int(replica))
        if not pending:
            return 0
        if live is None:
            live = np.ones(runtime.n_replicas, dtype=bool)
        live = np.asarray(live, dtype=bool)
        drop: set = set()
        for i in pending:
            var_id, picks, row, _rid = self.records[i]
            if var_id not in runtime.var_ids:
                continue
            if not live[np.asarray(picks, dtype=np.int64)].all():
                continue
            pop = runtime._population(var_id)
            codec, spec = runtime._mesh_meta(var_id)
            dev_row = tree_map(
                lambda h, x: runtime._row_leaf(h, x), row, pop
            )
            dominated = True
            for p in picks:
                cur = runtime._row_of(var_id, int(p))
                merged = codec.merge(spec, cur, dev_row)
                if not bool(codec.equal(spec, merged, cur)):
                    dominated = False
                    break
            if dominated:
                drop.add(i)
        if not drop:
            return 0
        self._reindex(
            [rec for i, rec in enumerate(self.records) if i not in drop]
        )
        counter(
            "quorum_hints_pruned_total",
            help="hinted-handoff records reclaimed after full-preflist "
                 "re-ack (post-replay restore path)",
        ).inc(len(drop))
        return len(drop)
