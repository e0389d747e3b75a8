"""Targeted repair (port of ``lasp_tpu.aae.repair``): divergence joins,
corruption quarantine, quorum overwrite, and the :class:`AAEScrubber`
driver that ties detection to repair.

1. **Inflationary divergence** (a row is behind): the exchange's divergent
   (var, row) pairs repair by a bidirectional partial join
   (``ReplicatedRuntime.join_rows`` of the pair's join into both rows).
2. **Non-inflationary corruption**: a row whose recomputed hash disagrees
   with its own last-committed hash (the verify pass), or a pair that
   still diverges after its join, escalates to a QUORUM-READ of healthy
   peers (live, reachable in the row's chaos component, not themselves
   flagged) with an authoritative overwrite and an incident record. A row
   with no reachable healthy peer parks as a PENDING repair and retries
   every scrub until its partition heals.

A write that existed ONLY on the corrupted row at corruption time cannot
be recovered (anti-entropy restores a replica from its peers).
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice.base import tree_leaves, tree_map
from ..mesh.gossip import quorum_read, rows_traffic_bytes
from ..telemetry import counter, events as tel_events, gauge, span
from ..telemetry.convergence import get_monitor
from ..utils.metrics import Timer
from . import exchange as _exchange
from .hashtree import HashForest


def overwrite_row(rt, var_id: str, row: int, picks: np.ndarray) -> int:
    """Authoritatively overwrite one replica row with the join of the
    ``picks`` quorum rows. The row marks frontier-dirty and AAE-dirty (a
    tracked mutation). Returns the estimated wire bytes (quorum reads +
    the write-back)."""
    pop = rt._population(var_id)
    codec, spec = rt._mesh_meta(var_id)
    top = quorum_read(codec, spec, pop, np.asarray(picks, dtype=np.int64))
    for x, t in zip(tree_leaves(pop), tree_leaves(top)):
        x[int(row)] = t
    rt._mark_dirty_rows(var_id, [int(row)])
    rt._aae_mark(var_id, [int(row)])
    return rows_traffic_bytes(pop, int(len(picks)) + 1)


def _repairs_counter(kind: str):
    return counter(
        "aae_repairs_total",
        help="AAE repairs applied, by kind (join: divergence partial "
             "joins; overwrite: corruption quorum overwrites)",
        kind=kind,
    )


def _repair_bytes_counter(kind: str):
    return counter(
        "aae_repair_bytes_total",
        help="estimated wire bytes moved by AAE repairs, by kind",
        kind=kind,
    )


class AAEScrubber:
    """Active anti-entropy over one population: hash forest + exchange +
    repair, driven per chaos round or on demand.

    ``runtime`` is a :class:`~lasp_tpu_torch.chaos.ChaosRuntime` (the
    scrubber attaches itself as the engine's per-round hook unless
    ``auto_attach=False``) or a bare ``ReplicatedRuntime`` (call
    :meth:`scrub` yourself). ``scrub_every`` sets the verify / exchange
    cadence in rounds; the per-round incremental refresh always runs.
    Besides JAX's counts, :attr:`exchange_seconds` and
    :attr:`repair_seconds` total the host time of the sweeps and repairs
    (the hash time is the forest's ``hash_seconds``)."""

    def __init__(self, runtime, *, seg_size: int = 8,
                 scrub_every: int = 1, quorum: int = 3,
                 auto_attach: bool = True):
        getattr(runtime, "rt", runtime)._refuse_across("AAE repair", 8)
        from ..chaos.engine import ChaosRuntime

        if isinstance(runtime, ChaosRuntime):
            self.ch = runtime
            self.rt = runtime.rt
        else:
            self.ch = None
            self.rt = runtime
        self.scrub_every = max(1, int(scrub_every))
        self.quorum = max(1, int(quorum))
        self.forest = HashForest(self.rt, seg_size=seg_size)
        #: detection ledger: {"round", "var", "row", "source"[, "pair"]}
        self.detected: list = []
        #: incident records of the corruption escalations
        self.incidents: list = []
        #: (var, row) -> {"round", "source", "attempts"} awaiting a
        #: reachable healthy quorum
        self.pending: dict = {}
        self.scrubs = 0
        self.repaired_joins = 0
        self.repaired_overwrites = 0
        self.repair_bytes = 0
        self.exchange_rounds = 0
        self.comparisons = 0
        self.divergent_rows = 0
        self.exchange_seconds = 0.0
        self.repair_seconds = 0.0
        if self.ch is not None and auto_attach:
            self.ch.aae = self

    # -- chaos-engine hooks ---------------------------------------------------
    def on_round_start(self, rnd: int) -> None:
        """After the round's actions (corruption injection included) and
        BEFORE the gossip dispatch: a corrupt row detected here never
        gossips outward."""
        if rnd % self.scrub_every == 0:
            self.scrub(rnd)

    def on_round_end(self, rnd: int) -> None:
        """Post-dispatch incremental refresh: commit the hashes of every row
        this round legitimately changed."""
        self.forest.refresh()

    # -- topology views --------------------------------------------------------
    def _mask_and_live(self, rnd: "int | None"):
        if self.ch is None:
            return None, np.ones(self.rt.n_replicas, dtype=bool)
        r = self.ch.round if rnd is None else int(rnd)
        return self.ch.schedule.mask_at(r), ~self.ch.crashed

    def _components(self, rnd, mask, live):
        if mask is None and live.all():
            return None
        return self.ch._labels(self.ch.round if rnd is None else int(rnd))

    # -- the scrub -------------------------------------------------------------
    def scrub(self, rnd: "int | None" = None) -> dict:
        """One full scrub: verify -> corruption repair -> exchange sweep ->
        divergence repair (with join-fixed-point escalation) -> commit.
        Returns the scrub stats."""
        if rnd is None:
            rnd = self.ch.round if self.ch is not None else self.scrubs
        mask, live = self._mask_and_live(rnd)
        comp = self._components(rnd, mask, live)
        with span("aae.scrub", round=int(rnd)):
            ver = self.forest.refresh(verify=True)
            fresh_corrupt = []
            for v, r in ver["corrupt"]:
                self._record_detection(rnd, v, r, "self_hash")
                fresh_corrupt.append((v, r))
            repaired, still_pending = self._repair_corrupt(
                rnd, fresh_corrupt, comp, live
            )
            with Timer() as t:
                sw = _exchange.sweep_arrays(self.forest, comp, live)
                divergent = sw.divergent_rows()
            self.exchange_seconds += t.elapsed
            n_div = sum(len(rs) for rs in divergent.values())
            self.exchange_rounds += sw.rounds
            self.comparisons += sw.comparisons
            self.divergent_rows += n_div
            joined, escalated = self._repair_divergence(rnd, sw, comp, live)
            stats = {
                "round": int(rnd),
                "corrupt_detected": len(fresh_corrupt),
                "corrupt_repaired": repaired,
                "pending": still_pending,
                "divergent_vars": len(divergent),
                "divergent_rows": n_div,
                "joins": joined,
                "escalated": escalated,
                "exchange_rounds": sw.rounds,
                "comparisons": sw.comparisons,
                "rows_hashed": ver["rows_hashed"],
            }
        self.scrubs += 1
        counter(
            "aae_scrubs_total",
            help="AAE scrubs executed (verify + exchange + repair)",
        ).inc()
        gauge(
            "aae_pending_repairs",
            help="corrupt rows detected but awaiting a reachable "
                 "healthy quorum",
        ).set(len(self.pending))
        if stats["corrupt_detected"] or stats["divergent_rows"]:
            tel_events.emit(
                "aae", action="scrub", round=int(rnd),
                corrupt=stats["corrupt_detected"],
                divergent=stats["divergent_rows"],
                repaired=stats["corrupt_repaired"] + stats["joins"],
            )
        return stats

    def _record_detection(self, rnd, var, row, source,
                          pair: "int | None" = None) -> None:
        rec = {
            "round": int(rnd), "var": var, "row": int(row),
            "source": source,
        }
        if pair is not None:
            # a join_fixed_point detection localizes to a PAIR: both
            # endpoints repair, and the invariant accepts either one
            rec["pair"] = int(pair)
        self.detected.append(rec)
        counter(
            "aae_corruption_detected_total",
            help="silent-corruption detections, by source (self_hash: "
                 "committed-hash mismatch on a clean row; "
                 "join_fixed_point: a pair still diverging after its "
                 "repair join)",
            source=source,
        ).inc()
        tel_events.emit(
            "aae", action="detect", var=var, replica=int(row),
            round=int(rnd), source=source,
        )

    # -- repairs ---------------------------------------------------------------
    def _healthy_quorum(self, var, row, comp, live,
                        exclude) -> "np.ndarray | None":
        """The first ``quorum`` healthy peers of ``row`` in ring order: live,
        in ``row``'s component, and not themselves flagged this scrub. None
        when no peer is reachable (the pending case)."""
        n = self.rt.n_replicas
        picks = []
        for step in range(1, n):
            cand = (int(row) + step) % n
            if not live[cand]:
                continue
            if comp is not None and comp[cand] != comp[int(row)]:
                continue
            if (var, cand) in exclude:
                continue
            picks.append(cand)
            if len(picks) >= self.quorum:
                break
        return np.asarray(picks, dtype=np.int64) if picks else None

    def _repair_corrupt(self, rnd, fresh, comp, live):
        """Quorum-overwrite every fresh detection plus every parked pending
        repair; rows with no reachable healthy peer (or crashed rows) stay
        pending."""
        work = {(v, int(r)): {"round": int(rnd), "source": "self_hash",
                              "attempts": 0}
                for v, r in fresh}
        for key, info in self.pending.items():
            work.setdefault(key, info)
        exclude = set(work)
        repaired = 0
        self.pending = {}
        with span("aae.repair"), Timer() as t:
            for (v, r), info in work.items():
                info["attempts"] += 1
                if not live[r]:
                    self.pending[(v, r)] = info  # frozen until restore
                    continue
                picks = self._healthy_quorum(v, r, comp, live, exclude)
                if picks is None:
                    self.pending[(v, r)] = info
                    continue
                bytes_ = overwrite_row(self.rt, v, r, picks)
                self.forest.rehash_rows(v, [r])
                self.repair_bytes += bytes_
                self.repaired_overwrites += 1
                repaired += 1
                _repairs_counter("overwrite").inc()
                _repair_bytes_counter("overwrite").inc(bytes_)
                self.incidents.append({
                    "round": int(rnd), "var": v, "row": int(r),
                    "source": info["source"],
                    "quorum": [int(p) for p in picks],
                    "attempts": info["attempts"],
                })
                tel_events.emit(
                    "aae", action="incident", var=v, replica=int(r),
                    round=int(rnd), source=info["source"],
                    quorum=[int(p) for p in picks],
                )
        self.repair_seconds += t.elapsed
        return repaired, len(self.pending)

    def _repair_divergence(self, rnd, sw, comp, live):
        """Bidirectional partial joins over the sweep's divergent pairs, in
        its order; a pair whose rows STILL hash differently after the join
        escalates both rows to corruption repair. A variable whose frontier
        is active is skipped (gossip owns that divergence); a join that
        changes rows dirties the frontier, so later pairs of that variable
        are skipped too, as in JAX's loop. Only the pairs with a variable
        whose frontier was quiet at the start are walked."""
        joined = 0
        escalated = []
        rt = self.rt
        order = sw.var_order
        quiet = np.asarray([
            not (rt._frontier.get(v) is not None and rt._frontier[v].any())
            for v in order
        ], dtype=bool)
        walk = np.flatnonzero((sw.div & quiet).any(axis=1)) if sw.a.size else []
        with span("aae.repair"), Timer() as t:
            for p in walk:
                a, b = int(sw.a[p]), int(sw.b[p])
                for vi in np.flatnonzero(sw.div[p]):
                    v = order[vi]
                    f = rt._frontier.get(v)
                    if f is not None and f.any():
                        continue  # gossip already owns this divergence
                    pop = rt._population(v)
                    codec, spec = rt._mesh_meta(v)
                    idx = torch.as_tensor([a, b], device=rt.device)
                    pair = tree_map(lambda x: x[idx], pop)
                    lub = codec.merge(spec, tree_map(lambda x: x[0], pair),
                                      tree_map(lambda x: x[1], pair))
                    rt.join_rows(v, np.asarray([a, b], dtype=np.int64), lub)
                    rt._aae_mark(v, [a, b])
                    bytes_ = rows_traffic_bytes(pop, 2)
                    self.repair_bytes += bytes_
                    self.repaired_joins += 1
                    joined += 1
                    _repairs_counter("join").inc()
                    _repair_bytes_counter("join").inc(bytes_)
                    ha, hb = self.forest.rehash_rows(v, [a, b])
                    if ha != hb:
                        for r, other in ((a, b), (b, a)):
                            if (v, r) not in self.pending:
                                self._record_detection(
                                    rnd, v, r, "join_fixed_point", pair=other,
                                )
                                self.pending[(v, r)] = {
                                    "round": int(rnd),
                                    "source": "join_fixed_point",
                                    "attempts": 0,
                                }
                                escalated.append((v, r))
        self.repair_seconds += t.elapsed
        if escalated:
            # escalations repair in the same scrub
            self._repair_corrupt(rnd, [], comp, live)
            return joined, len(escalated)
        return joined, 0

    # -- reporting -------------------------------------------------------------
    def full_resync_bytes(self) -> int:
        """What a full-state resync of the population would move."""
        return sum(self.rt._row_bytes(v) for v in self.rt.var_ids) * self.rt.n_replicas

    def report(self) -> dict:
        """The AAE accounting (also folded into the monitor's ``aae``)."""
        rep = {
            "scrubs": self.scrubs,
            "detected": len(self.detected),
            "incidents": len(self.incidents),
            "pending": len(self.pending),
            "repaired_joins": self.repaired_joins,
            "repaired_overwrites": self.repaired_overwrites,
            "repair_bytes": self.repair_bytes,
            "full_resync_bytes": self.full_resync_bytes(),
            "exchange_rounds": self.exchange_rounds,
            "comparisons": self.comparisons,
            "divergent_rows": self.divergent_rows,
            "rows_hashed": dict(self.forest.rows_hashed),
            "segments_rehashed": self.forest.segments_rehashed,
        }
        get_monitor().observe_aae(**rep)
        return rep

    def seconds(self) -> dict:
        """Host seconds by part: ``hash`` (device work included),
        ``exchange`` (sweeps), ``repair`` (joins and overwrites, their
        rehashes included)."""
        return {"hash": self.forest.hash_seconds,
                "exchange": self.exchange_seconds,
                "repair": self.repair_seconds}
