"""ConvergenceMonitor: live per-variable / per-replica / per-shard
convergence state over the gossip residual stream (port of
``lasp_tpu.telemetry.convergence``).

The gossip step already computes a per-variable residual vector (how
many replica rows each round changed, ``mesh/runtime.py`` — the PR-1
telemetry feed); this module turns that stream plus on-demand
population probes into the operator surface the ``{health}`` bridge
verb, ``lasp_tpu top`` and the bench artifact's convergence summary
read:

- **per-var residual + staleness** — ``staleness[var]`` counts rounds
  since the variable's state last changed anywhere (rounds since
  inflation). While a variable is DIVERGED (some replica behind the
  global join) growing staleness means the mesh is stuck, not done —
  the ``stuck`` alert combines the two;
- **divergence top-K** — the variables changing at the most replicas
  last round (where to look first);
- **quiescence ETA** — geometric extrapolation of the total-residual
  decay (pull gossip on a fixed topology contracts the diverged set
  roughly geometrically; the ETA is a hint, not a promise);
- **per-replica / per-shard lag** — :meth:`probe` compares every
  replica row against the global join per variable (one device
  reduction per variable, O(population) device work but zero per-round
  cost — strictly an on-demand surface) and aggregates worst/mean lag
  per shard under a block sharding;
- **pluggable alerts** — threshold config (max staleness while
  diverged, max replica lag, residual floor) plus arbitrary predicate
  callbacks over the snapshot.

Hot-path contract: :meth:`observe_round` is dict updates plus cached
gauge writes, no device work. The feeds are the runtime's per-step
emission and flight drains, the chaos soaks (:meth:`observe_chaos`) and
the quorum reports (:meth:`observe_quorum`); :meth:`probe` reads the
populations on demand, and on a partitioned runtime the boundary
exchange's cut and wire ledger.
"""

from __future__ import annotations

import math
import threading

from . import registry as _registry
from . import events as _events

#: default alert thresholds (all overridable per monitor)
DEFAULT_THRESHOLDS = {
    # a diverged variable whose state stopped changing for this many
    # rounds is STUCK (divergence can no longer drain by gossip alone)
    "max_stale_rounds": 16,
    # worst per-replica lag (variables a replica is behind on) before
    # the replica is flagged lagging
    "max_replica_lag": None,
    # residual persisting at/above this fraction of the population for
    # max_stale_rounds flags a thrashing (non-contracting) mesh
    "max_residual_frac": None,
}


class ConvergenceMonitor:
    """Aggregates the per-round residual stream; see the module doc."""

    def __init__(self, history: int = 512, thresholds: "dict | None" = None,
                 top_k: int = 8):
        self._lock = threading.Lock()
        self.history = int(history)
        self.top_k = int(top_k)
        self.thresholds = dict(DEFAULT_THRESHOLDS)
        if thresholds:
            unknown = set(thresholds) - set(DEFAULT_THRESHOLDS)
            if unknown:
                raise TypeError(
                    f"unknown alert thresholds {sorted(unknown)} "
                    f"(known: {sorted(DEFAULT_THRESHOLDS)})"
                )
            self.thresholds.update(thresholds)
        self._alert_fns: list = []  # (name, fn(snapshot) -> bool)
        self._gen = _registry.generation()
        self._reset_state()

    def _reset_state(self) -> None:
        self.round = 0
        self.n_replicas = 0
        #: var -> {"residual", "last_change_round", "total_changes"}
        self.vars: dict = {}
        #: bounded total-residual history [(round, total), ...]
        self.residual_curve: list = []
        self.memberships: list = []  # [(round, kind, old_n, new_n)]
        self.last_probe: "dict | None" = None
        #: var -> dirty-replica frontier size after the last frontier
        #: round (delta-gossip scheduling; empty when dense-only)
        self.frontier: dict = {}
        #: latest chaos soak report (rounds_to_heal, degraded reads,
        #: repair bytes — chaos.ChaosRuntime.soak); empty outside soaks
        self.chaos: dict = {}
        #: latest quorum coordination report (latency percentiles,
        #: repair/push traffic, hint-log state — quorum.QuorumRuntime.
        #: report); empty until a quorum engine runs
        self.quorum: dict = {}
        #: latest serving front-end report (offered/completed/shed
        #: counts, parked watches, degradation-ladder level —
        #: serve.ServeFrontend.report); empty until a front-end reports
        self.serve: dict = {}
        #: latest active-anti-entropy report (detections, incidents,
        #: repair traffic, hash work — aae.AAEScrubber.report); empty
        #: until a scrubber reports
        self.aae: dict = {}
        #: CUMULATIVE grouped-ingest accounting (ops, dispatches,
        #: grouped vs fallback vars, bucket-pad waste — fed per
        #: ``ReplicatedRuntime.ingest_cycle``); empty until a cycle runs
        self.ingest: dict = {}
        self._tel: "dict | None" = None

    def _check_generation(self) -> None:
        """A test-time ``telemetry.reset()`` must detach cached gauges
        AND drop state accumulated against the old registry — the same
        generation discipline as the runtime's instrument cache."""
        gen = _registry.generation()
        if gen != self._gen:
            self._gen = gen
            self._reset_state()

    # -- the hot feed --------------------------------------------------------
    def observe_round(self, var_ids, residuals, seconds: float = 0.0,
                      n_replicas: "int | None" = None) -> None:
        """One executed gossip round: ``residuals[i]`` replicas changed
        ``var_ids[i]``. Called from the step's telemetry emission."""
        with self._lock:
            self._check_generation()
            self.round += 1
            if n_replicas:
                self.n_replicas = int(n_replicas)
            total = 0
            rnd = self.round
            vars_ = self.vars
            for v, r in zip(var_ids, residuals):
                r = int(r)
                total += r
                ent = vars_.get(v)
                if ent is None:
                    ent = vars_[v] = {
                        "residual": 0, "last_change_round": 0,
                        "total_changes": 0,
                    }
                if r:
                    ent["residual"] = r
                    ent["last_change_round"] = rnd
                    ent["total_changes"] += r
                elif ent["residual"]:
                    # steady state (most vars quiescent most rounds): a
                    # 0 -> 0 transition writes nothing — the hot-feed
                    # cost then scales with CHANGED vars, not vars
                    ent["residual"] = 0
            self.residual_curve.append((self.round, total))
            del self.residual_curve[: -self.history]
            # amortized gauge sweep: per-var staleness is a SAMPLED
            # surface (scrapes are seconds apart, rounds are ms apart),
            # so sweeping every var's gauge every round pays O(vars)
            # for values no scrape will ever see. Sweep when the var
            # census changes (fresh series must exist), at quiescence
            # (the moment exact staleness matters), and every 8th round
            # otherwise — gauges are then at most 8 rounds stale, the
            # monitor's own dict state (snapshot/health) stays exact.
            if (
                total == 0
                or self.round % 8 == 0
                or self._tel is None
                or self._tel["vars"] != tuple(self.vars)
            ):
                self._set_gauges()

    def observe_opaque_rounds(self, n: int,
                              quiescent: "bool | None" = None) -> None:
        """Advance the round clock for fused blocks / on-device while
        loops, whose per-round residual vectors never reach the host.
        ``quiescent=True`` records a terminal zero-residual point (the
        run reached its fixed point inside the dispatch)."""
        if n <= 0:
            return
        with self._lock:
            self._check_generation()
            self.round += int(n)
            if quiescent is not None:
                self.residual_curve.append(
                    (self.round, 0 if quiescent else -1)
                )
                del self.residual_curve[: -self.history]
                if quiescent:
                    for ent in self.vars.values():
                        ent["residual"] = 0

    def observe_frontier(self, var_ids, sizes) -> None:
        """Dirty-set sizes after a frontier-scheduled round — the
        delta-gossip twin of the residual feed: residual says how many
        rows CHANGED, the frontier says how many can still change."""
        with self._lock:
            self._check_generation()
            frontier = self.frontier
            for v, n in zip(var_ids, sizes):
                n = int(n)
                if frontier.get(v) != n:  # skip the quiescent majority
                    frontier[v] = n

    def observe_chaos(self, **report) -> None:
        """Fold a chaos soak's outcome into the health surface — the
        resilience twin of the residual feed: ``rounds_to_heal``,
        ``degraded_reads``, ``repair_bytes``, ``healed`` etc. from
        ``chaos.ChaosRuntime.soak`` land under the snapshot's ``chaos``
        key (the ``{health}`` verb and ``lasp_tpu top`` read it)."""
        with self._lock:
            self._check_generation()
            self.chaos.update(report)
            self.chaos["round"] = self.round

    def observe_quorum(self, **report) -> None:
        """Fold a quorum coordination report into the health surface —
        latency percentiles, completion/failure counts, repair and
        replication traffic, hint-log state from
        ``quorum.QuorumRuntime.report`` land under the snapshot's
        ``quorum`` key (the ``{health}`` verb and ``lasp_tpu top``
        read it alongside ``chaos``)."""
        with self._lock:
            self._check_generation()
            self.quorum.update(report)
            self.quorum["round"] = self.round

    def observe_serve(self, **report) -> None:
        """Fold a serving front-end's accounting into the health
        surface — offered/completed/shed/expired counts, parked
        watches, and the degradation-ladder level from
        ``serve.ServeFrontend.report`` land under the snapshot's
        ``serve`` key (the ``{health}`` verb and ``lasp_tpu top`` read
        it alongside ``chaos`` and ``quorum``)."""
        with self._lock:
            self._check_generation()
            self.serve.update(report)
            self.serve["round"] = self.round

    def observe_aae(self, **report) -> None:
        """Fold an active-anti-entropy report into the health surface —
        scrub counts, corruption detections/incidents, pending and
        applied repairs, repair-vs-resync traffic, and hash work by
        mode from ``aae.AAEScrubber.report`` land under the snapshot's
        ``aae`` key (the ``{health}`` verb and ``lasp_tpu top`` read it
        alongside ``chaos``/``quorum``/``serve``)."""
        with self._lock:
            self._check_generation()
            self.aae.update(report)
            self.aae["round"] = self.round

    def observe_ingest(self, *, ops: int, dispatches: int,
                       grouped_vars: int, fallback_vars: int,
                       pad_slots: int = 0, table_slots: int = 0) -> None:
        """Fold one grouped-ingest cycle's accounting into the health
        surface (``ReplicatedRuntime.ingest_cycle``). CUMULATIVE on
        purpose — unlike the latest-report sections, ingest is a
        per-cycle hot path and operators want rates, so the snapshot
        carries running totals plus the derived occupancy/pad views
        under the ``ingest`` key (the ``{health}`` verb and ``lasp_tpu
        top`` read it alongside ``serve``)."""
        with self._lock:
            self._check_generation()
            ing = self.ingest
            ing["cycles"] = ing.get("cycles", 0) + 1
            ing["ops"] = ing.get("ops", 0) + int(ops)
            ing["dispatches"] = ing.get("dispatches", 0) + int(dispatches)
            ing["grouped_vars"] = (
                ing.get("grouped_vars", 0) + int(grouped_vars)
            )
            ing["fallback_vars"] = (
                ing.get("fallback_vars", 0) + int(fallback_vars)
            )
            ing["pad_slots"] = ing.get("pad_slots", 0) + int(pad_slots)
            ing["table_slots"] = (
                ing.get("table_slots", 0) + int(table_slots)
            )
            if ing["dispatches"]:
                ing["vars_per_dispatch"] = round(
                    ing["grouped_vars"] / ing["dispatches"], 3
                )
            if ing["table_slots"]:
                ing["pad_frac"] = round(
                    ing["pad_slots"] / ing["table_slots"], 4
                )
            ing["round"] = self.round

    def observe_membership(self, kind: str, old_n: int, new_n: int) -> None:
        with self._lock:
            self._check_generation()
            self.memberships.append((self.round, kind, int(old_n), int(new_n)))
            del self.memberships[: -self.history]
            self.n_replicas = int(new_n)
            # lag/staleness accumulated against the old population no
            # longer means anything row-wise; keep per-var stats (they
            # are population-sums) but drop the stale probe
            self.last_probe = None

    # -- cached gauges (generation-keyed, like the runtime's cache) ----------
    def _set_gauges(self) -> None:
        if not _registry.enabled():
            return
        tel = self._tel
        if tel is None or tel["vars"] != tuple(self.vars):
            reg = _registry.get_registry()
            tel = self._tel = {
                "vars": tuple(self.vars),
                "stale": {
                    v: reg.gauge(
                        "convergence_staleness",
                        help="rounds since the variable's state last "
                             "changed anywhere (rounds since inflation)",
                        var=v,
                    )
                    for v in self.vars
                },
                "eta": reg.gauge(
                    "convergence_quiescence_eta_rounds",
                    help="estimated rounds to quiescence from the "
                         "residual decay (-1: no converging trend)",
                ),
            }
        for v, ent in self.vars.items():
            tel["stale"][v].set(self.round - ent["last_change_round"])
        eta = self._eta_locked()
        tel["eta"].set(-1 if eta is None else eta)

    # -- derived views -------------------------------------------------------
    def staleness(self) -> dict:
        """``{var: rounds since its state last changed}``."""
        with self._lock:
            return {
                v: self.round - ent["last_change_round"]
                for v, ent in self.vars.items()
            }

    def top_divergent(self, k: "int | None" = None) -> list:
        """``[(var, residual), ...]`` — the variables the last observed
        round changed at the most replicas, descending."""
        with self._lock:
            out = sorted(
                ((v, ent["residual"]) for v, ent in self.vars.items()),
                key=lambda x: (-x[1], x[0]),
            )
        return out[: (k or self.top_k)]

    def quiescence_eta(self) -> "int | None":
        with self._lock:
            return self._eta_locked()

    def _eta_locked(self) -> "int | None":
        """Geometric extrapolation of the total-residual decay. None
        when there is no converging trend (too little history, residual
        growing, or opaque -1 markers at the tail)."""
        if self.residual_curve and self.residual_curve[-1][1] < 0:
            # the LAST observation is an opaque non-quiescent marker
            # (fused block ran out without reaching the fixed point):
            # the current residual is unknown, and an older zero point
            # must not read as "converged"
            return None
        pts = [(r, t) for r, t in self.residual_curve[-8:] if t >= 0]
        if not pts:
            return None
        if pts[-1][1] == 0:
            return 0
        if len(pts) < 2:
            return None
        (r0, t0), (r1, t1) = pts[-2], pts[-1]
        if t1 >= t0 or t0 <= 0 or r1 <= r0:
            return None
        decay = (t1 / t0) ** (1.0 / (r1 - r0))  # per-round contraction
        if decay >= 1.0:
            return None
        # rounds until the residual extrapolates below 1
        eta = math.ceil(math.log(1.0 / t1) / math.log(decay))
        return max(1, min(eta, 100_000))

    # -- on-demand population probe ------------------------------------------
    def probe(self, runtime, n_shards: "int | None" = None) -> dict:
        """Compare every replica row against the global join, per
        variable: ``lag[r]`` = number of variables replica ``r`` is
        behind on. Aggregates per shard (contiguous row blocks, the
        runtime's partition plan shard count by default). One device
        reduction per variable — an on-demand surface (the ``top`` CLI,
        the ``{health}`` verb), never the per-round hot path."""
        import numpy as np

        from ..mesh.gossip import diverged_rows

        if n_shards is None:
            part = getattr(runtime, "_partition", None)
            n_shards = part["plan"]["n_shards"] if part else 1
        n = runtime.n_replicas
        lag = np.zeros((n,), dtype=np.int64)
        per_var: dict = {}
        for v in runtime.var_ids:
            codec, spec = runtime._mesh_meta(v)
            # the whole population: across processes, every process's rows
            behind = (
                diverged_rows(codec, spec, runtime._whole_population(v))
                .cpu().numpy().astype(np.int64)
            )
            lag += behind
            per_var[v] = int(behind.sum())
        shard_lag = []
        if n_shards and n_shards > 0 and n:
            # contiguous near-equal blocks; a non-dividing population
            # splits with remainder rows in the leading shards rather
            # than silently dropping the aggregation
            shard_lag = [
                int(chunk.max(initial=0))
                for chunk in np.array_split(lag, min(int(n_shards), n))
            ]
        worst = int(lag.max(initial=0))
        probe = {
            "round": self.round,
            "n_replicas": n,
            "n_shards": int(n_shards or 1),
            "lag_by_var": per_var,
            "worst_replica": int(lag.argmax()) if n else 0,
            "worst_replica_lag": worst,
            "mean_replica_lag": round(float(lag.mean()), 4) if n else 0.0,
            "shard_lag": shard_lag,
        }
        part = getattr(runtime, "_partition", None)
        masks = getattr(runtime, "_frontier", None)
        if part is not None and masks:
            # dirty ∩ cut: how many exchange rows carry new state (a full
            # cut with an empty intersection ships pure no-ops)
            from ..mesh.shard_gossip import frontier_cut_rows

            union = np.zeros((n,), dtype=bool)
            for m in masks.values():
                if m.shape[0] == n:
                    union |= m
            probe["frontier_cut_rows"] = frontier_cut_rows(union, part["plan"])
            probe["cut_rows"] = int(part["plan"]["stats"]["send_rows"])
            # the sparse exchange's cumulative wire ledger and the interior
            # / boundary split of its joins
            moved = getattr(runtime, "part_exchange_bytes_total", 0)
            plane = getattr(runtime, "part_dense_plane_bytes_total", 0)
            ir = getattr(runtime, "part_interior_rows_total", 0)
            br = getattr(runtime, "part_boundary_rows_total", 0)
            probe["shard_exchange"] = {
                "payload_bytes_total": int(moved),
                "dense_plane_bytes_total": int(plane),
                "wire_cut": round(plane / moved, 2) if moved else None,
                "interior_rows_total": int(ir),
                "boundary_rows_total": int(br),
                "interior_overlap_frac": (
                    round(ir / (ir + br), 4) if (ir + br) else None
                ),
            }
        if _registry.enabled():
            reg = _registry.get_registry()
            for v, behind in per_var.items():
                reg.gauge(
                    "convergence_lag_replicas",
                    help="replica rows behind the global join, per var "
                         "(on-demand probe)",
                    var=v,
                ).set(behind)
            for s, sl in enumerate(shard_lag):
                reg.gauge(
                    "convergence_shard_lag",
                    help="worst per-replica lag inside each contiguous "
                         "shard block (on-demand probe)",
                    shard=s,
                ).set(sl)
        with self._lock:
            self._check_generation()
            self.last_probe = probe
        return probe

    # -- alerts ---------------------------------------------------------------
    def add_alert(self, name: str, fn) -> None:
        """Register ``fn(snapshot) -> bool`` — True raises alert
        ``name`` in :meth:`alerts` output."""
        self._alert_fns.append((str(name), fn))

    def alerts(self, snap: "dict | None" = None) -> list:
        """Alert lines for ``snap`` (default: a fresh snapshot — pass
        one to evaluate alerts against exactly the state a caller is
        about to report, as :meth:`health` does)."""
        if snap is None:
            snap = self.snapshot()
        out = []
        thr = self.thresholds
        max_stale = thr["max_stale_rounds"]
        probe = snap.get("probe")
        lag_by_var = (probe or {}).get("lag_by_var", {})
        if max_stale is not None:
            for v, stale in snap["staleness"].items():
                if stale < max_stale:
                    continue
                # staleness only alarms while the variable is DIVERGED:
                # quiescent-and-stale is just "done". Without a probe,
                # a nonzero last residual is the divergence signal.
                diverged = (
                    lag_by_var.get(v, 0) > 0
                    if probe is not None
                    else snap["residual_by_var"].get(v, 0) > 0
                )
                if diverged:
                    out.append(
                        f"stuck: {v} diverged but unchanged for "
                        f"{stale} rounds"
                    )
        max_lag = thr["max_replica_lag"]
        if max_lag is not None and probe is not None:
            if probe["worst_replica_lag"] > max_lag:
                out.append(
                    f"lagging: replica {probe['worst_replica']} is "
                    f"{probe['worst_replica_lag']} variables behind "
                    f"(threshold {max_lag})"
                )
        max_frac = thr["max_residual_frac"]
        if (
            max_frac is not None
            and snap["n_replicas"]
            and snap["residual_total"] is not None
            and snap["residual_total"]
            >= max_frac * snap["n_replicas"]
            and min(snap["staleness"].values(), default=0) == 0
            and snap["round"] >= (max_stale or 0)
            and (snap["quiescence_eta"] is None)
        ):
            out.append(
                f"thrashing: residual {snap['residual_total']} is not "
                f"contracting at round {snap['round']}"
            )
        for name, fn in self._alert_fns:
            try:
                if fn(snap):
                    out.append(name)
            except Exception as exc:  # a broken alert must not kill health
                out.append(f"alert {name!r} raised {type(exc).__name__}")
        return out

    # -- the exported view ----------------------------------------------------
    def snapshot(self) -> dict:
        """The full monitor state as plain data — what ``{health}``,
        ``lasp_tpu top`` and the bench artifact embed."""
        with self._lock:
            self._check_generation()
            curve = list(self.residual_curve)
            total = curve[-1][1] if curve else None
            if total is not None and total < 0:
                total = None  # opaque tail: unknown residual
            return {
                "round": self.round,
                "n_replicas": self.n_replicas,
                "residual_total": total,
                "residual_by_var": {
                    v: ent["residual"] for v, ent in self.vars.items()
                },
                "staleness": {
                    v: self.round - ent["last_change_round"]
                    for v, ent in self.vars.items()
                },
                "total_changes_by_var": {
                    v: ent["total_changes"] for v, ent in self.vars.items()
                },
                "top_divergent": sorted(
                    ((v, ent["residual"]) for v, ent in self.vars.items()),
                    key=lambda x: (-x[1], x[0]),
                )[: self.top_k],
                "quiescence_eta": self._eta_locked(),
                "frontier_by_var": dict(self.frontier),
                "chaos": dict(self.chaos),
                "quorum": dict(self.quorum),
                "serve": dict(self.serve),
                "aae": dict(self.aae),
                "ingest": dict(self.ingest),
                "residual_curve": curve[-64:],
                "memberships": list(self.memberships),
                "probe": self.last_probe,
                "thresholds": dict(self.thresholds),
            }

    def health(self) -> dict:
        """Snapshot + alerts — the one-call surface of the bridge's
        ``{health}`` verb and ``Session.health()``."""
        snap = self.snapshot()
        # alerts judge the SAME snapshot the payload carries: a scrape
        # concurrent with stepping must never pair round-N fields with
        # round-N+1 alerts
        snap["alerts"] = self.alerts(snap)
        # the roofline view: the kernel cost ledger's condensation
        try:
            from .roofline import get_ledger

            snap["roofline"] = get_ledger().summary()
        except Exception:
            snap["roofline"] = None
        return snap


# ---------------------------------------------------------------------------
# process-global monitor (the registry pattern: one sink, many feeders)
# ---------------------------------------------------------------------------

_monitor = ConvergenceMonitor()


def get_monitor() -> ConvergenceMonitor:
    return _monitor


def record_membership(kind: str, old_n: int, new_n: int, **attrs) -> None:
    """The one emission point for population membership changes: feeds
    the global monitor AND the causal event log, so resize callers
    (``ReplicatedRuntime.resize``, elastic checkpoint restore) cannot
    drop or double one of the two."""
    _monitor.observe_membership(kind, old_n, new_n)
    _events.emit(
        "membership", kind=kind, old_n=int(old_n), new_n=int(new_n), **attrs
    )
