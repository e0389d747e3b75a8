"""Declarative, deterministic fault timelines — the nemesis schedule (a
copy of ``lasp_tpu.chaos.schedule``, which is numpy only: every mask
equals the JAX package's bit for bit).

The reference's failure story is implicit: riak_core N=3 preflists with
R/W=2 quorums survive a down vnode, and read-repair reconstructs it on
return (``src/lasp_update_fsm.erl:174-216``, ``src/lasp_vnode.erl:
454-472``). This module makes the *fault side* of that story explicit
and reproducible: a :class:`ChaosSchedule` is a timeline of fault events
(partitions, flaky/delayed/duplicated links, replica crash/restore,
slow-shard throttling) that COMPILES, per round, into exactly the
``edge_mask: bool[R, K]`` perturbation the existing gossip kernels
already accept (``mesh.gossip.gossip_round`` /
``gossip_round_rows`` / ``gossip_round_shift``, ``ops.fused``). No new
collective path exists for chaos — the DrJAX discipline (PAPERS.md,
arXiv:2403.07128): failure semantics expressed inside the traced
computation stay jit-friendly and bit-reproducible.

Determinism contract: every mask is a pure function of ``(seed,
schedule, round)`` — per-link randomness comes from a counter-based
hash over the ORDER-FREE link key (both directions of a pair draw the
same uniform), so every schedule is symmetric by construction and the
same ``(seed, schedule)`` replays to identical per-round masks on any
host (no RandomState stream ordering involved).

Fault semantics under CRDT gossip (why two of the classic nemeses are
mask-expressible at all):

- **delay**: pull-gossip state is monotone and join-idempotent, so a
  message delayed ``d`` rounds is SUBSUMED by the first later delivery
  — the peer's newer state contains everything the delayed frame
  carried. A delayed-delivery buffer that holds frames ``d`` rounds and
  then flushes is therefore observationally equal to masking the link
  for ``d`` rounds and letting the next pull through; ``DelayLinks``
  compiles to exactly that mask window.
- **duplication**: an idempotent join makes a duplicated delivery a
  literal no-op (``join(s, x, x) == join(s, x)``). ``DuplicateLinks``
  perturbs no mask; it exists so soaks COUNT the duplicates the
  protocol absorbed (``chaos_duplicate_deliveries_total``) — the
  at-least-once tolerance claim, measured instead of asserted.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Partition(NamedTuple):
    """Split the population into ``n_groups`` contiguous groups for
    rounds ``[start, stop)``: only intra-group links stay alive
    (``topology.partition_mask`` semantics, symmetric by construction).
    Healing = the window ending."""

    start: int
    stop: int
    n_groups: int = 2


class FlakyLinks(NamedTuple):
    """Per-round Bernoulli link loss in ``[start, stop)``: each LINK
    (order-free replica pair) independently drops with ``drop_rate``
    each round, both directions together. The draw is counter-based on
    ``(seed, link, round)`` — reproducible, stream-order-free."""

    start: int
    stop: int
    drop_rate: float = 0.2


class DelayLinks(NamedTuple):
    """Delayed delivery on a seeded ``frac`` subset of links for rounds
    ``[start, stop)``: an affected link's buffer flushes only every
    ``delay + 1`` rounds (mask-window compilation — see the module doc
    for why this equals a real delayed-delivery buffer under monotone
    idempotent joins)."""

    start: int
    stop: int
    frac: float = 0.3
    delay: int = 2


class DuplicateLinks(NamedTuple):
    """At-least-once delivery on a seeded ``frac`` subset of links:
    every delivery in the window arrives twice. A no-op under the
    idempotent join (the point) — compiled into accounting, not masks."""

    start: int
    stop: int
    frac: float = 0.3


class Crash(NamedTuple):
    """Replica ``replica`` fails-stop at the start of round ``at``:
    every link touching it dies (it neither contributes state nor
    pulls), its row freezes, and client writes to it are refused until
    a :class:`Restore`."""

    at: int
    replica: int


class Restore(NamedTuple):
    """Replica ``replica`` returns at the start of round ``at``, its row
    re-seeded from the lattice bottom (``source="bottom"``) or from a
    runtime checkpoint row (``source="checkpoint"`` — the engine's
    attached snapshot), then caught up by gossip (every frontier
    degrades to all-dirty: the hinted-handoff-style recovery)."""

    at: int
    replica: int
    source: str = "bottom"


class SlowShard(NamedTuple):
    """Throttle one contiguous shard block for rounds ``[start, stop)``:
    links touching the shard's rows (``shard_gossip.shard_rows``
    blocking) deliver only every ``period``-th round — a lagging device
    / oversubscribed host, not a failure."""

    start: int
    stop: int
    shard: int = 0
    n_shards: int = 4
    period: int = 3


#: silent-corruption mutation kinds (``docs/RESILIENCE.md`` fault
#: model): ``bitflip`` flips one state bit (a flipped exists-bit —
#: possibly INFLATIONARY: the one corruption class gossip would spread
#: outward), ``rollback`` halves a positive counter lane (counter
#: rollback — non-inflationary), ``truncate`` zeroes the tail half of
#: the row's last wire plane (truncated dot planes).
CORRUPTION_KINDS = ("bitflip", "rollback", "truncate")


class CorruptRows(NamedTuple):
    """SILENT corruption at the start of round ``at``: ``n_rows``
    seeded live replica rows of a seeded variable (``var`` None = drawn
    over the store) mutate per ``kind`` — directly in device state,
    bypassing every dirty-tracking path (that is the fault class:
    bit-rot, a bad kernel, a botched restore). Pure function of
    ``(seed, schedule, round)`` like every other event; no mask
    effect. Detection/repair is the AAE layer's job
    (the AAE layer) — without it, gossip happily joins the
    corruption outward."""

    at: int
    kind: str = "bitflip"
    n_rows: int = 1
    var: "str | None" = None


class BitRot(NamedTuple):
    """Windowed :class:`CorruptRows`: one seeded injection every
    ``every``-th round of ``[start, stop)`` — ambient media decay
    rather than a point event."""

    start: int
    stop: int
    every: int = 2
    kind: str = "bitflip"
    n_rows: int = 1
    var: "str | None" = None


#: event kinds with a [start, stop) activity window
_WINDOWED = (Partition, FlakyLinks, DelayLinks, DuplicateLinks,
             SlowShard, BitRot)


def shard_rows(n_replicas: int, n_shards: int, shard: int) -> np.ndarray:
    """``int64[...]``: the replica-row indices of one contiguous shard
    block (``lasp_tpu.mesh.shard_gossip.shard_rows``: trailing rows of a
    non-divisible population fold into the last block) — the
    :class:`SlowShard` fault-injection unit."""
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not 0 <= int(shard) < n_shards:
        raise ValueError(f"shard {shard} out of range for {n_shards} shards")
    block = max(int(n_replicas) // n_shards, 1)
    lo = int(shard) * block
    hi = (int(shard) + 1) * block if shard < n_shards - 1 else int(n_replicas)
    return np.arange(min(lo, n_replicas), min(hi, n_replicas), dtype=np.int64)


def _mix(keys: np.ndarray, salt: int) -> np.ndarray:
    """Counter-based uniform in [0, 1) per key — splitmix64-style
    finalizer, deterministic across hosts (no RandomState streams)."""
    x = keys.astype(np.uint64)
    x = x * np.uint64(0x9E3779B97F4A7C15) + np.uint64(salt & (2**64 - 1))
    x ^= x >> np.uint64(33)
    x = x * np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    return (x % np.uint64(1 << 53)).astype(np.float64) / float(1 << 53)


class ChaosSchedule:
    """A reproducible fault timeline over one population + topology.

    ``events`` is any iterable of the event tuples above; ``seed`` feeds
    every stochastic draw. The schedule is immutable and stateless apart
    from a content-keyed mask cache: rounds whose fault state is
    identical return the SAME mask object, so the frontier engine's
    identity-keyed mask tagging (``ReplicatedRuntime._frontier_sync_mask``)
    keeps its dirty-set knowledge across a stable fault window instead
    of degrading every round."""

    def __init__(self, n_replicas: int, neighbors, events=(), seed: int = 0):
        from ..mesh.topology import _pair_keys

        self.n_replicas = int(n_replicas)
        self.neighbors = np.asarray(neighbors)
        if (
            self.neighbors.ndim != 2
            or self.neighbors.shape[0] != self.n_replicas
        ):
            raise ValueError(
                f"neighbors must be [{n_replicas}, K], got "
                f"{self.neighbors.shape}"
            )
        self.seed = int(seed)
        self.events = tuple(events)
        for ev in self.events:
            if isinstance(ev, _WINDOWED):
                if ev.stop <= ev.start:
                    raise ValueError(f"empty fault window: {ev!r}")
                if isinstance(ev, BitRot):
                    if ev.kind not in CORRUPTION_KINDS:
                        raise ValueError(
                            f"{ev!r}: kind must be one of "
                            f"{CORRUPTION_KINDS}"
                        )
                    if ev.every < 1 or ev.n_rows < 1:
                        raise ValueError(
                            f"{ev!r}: every and n_rows must be >= 1"
                        )
            elif isinstance(ev, CorruptRows):
                if ev.kind not in CORRUPTION_KINDS:
                    raise ValueError(
                        f"{ev!r}: kind must be one of {CORRUPTION_KINDS}"
                    )
                if ev.n_rows < 1:
                    raise ValueError(f"{ev!r}: n_rows must be >= 1")
            elif isinstance(ev, (Crash, Restore)):
                if not 0 <= ev.replica < self.n_replicas:
                    raise ValueError(
                        f"{ev!r}: replica out of range for {n_replicas}"
                    )
                if isinstance(ev, Restore) and ev.source not in (
                    "bottom", "checkpoint",
                ):
                    raise ValueError(
                        f"{ev!r}: source must be 'bottom' or 'checkpoint'"
                    )
            else:
                raise TypeError(f"unknown chaos event {ev!r}")
        self._pair_keys = _pair_keys(self.neighbors)
        # validate crash/restore pairing ONCE: a restore without a
        # preceding crash (or a double crash) is a schedule bug that
        # would otherwise surface rounds later as a confusing freeze
        downs: set = set()
        for ev in self._actions_sorted():
            if isinstance(ev, Crash):
                if ev.replica in downs:
                    raise ValueError(
                        f"{ev!r}: replica already crashed and not restored"
                    )
                downs.add(ev.replica)
            elif isinstance(ev, Restore):
                if ev.replica not in downs:
                    raise ValueError(f"{ev!r}: replica is not crashed")
                downs.discard(ev.replica)
        #: first round with every fault cleared (windows closed, crashed
        #: replicas restored) — the heal point soaks measure recovery
        #: from. max() over an empty timeline = round 0 (no faults).
        horizon = 0
        for ev in self.events:
            horizon = max(
                horizon, ev.stop if isinstance(ev, _WINDOWED) else ev.at
            )
        self.horizon = horizon
        self._mask_cache: "tuple | None" = None  # (bytes, mask or None)

    # -- event queries --------------------------------------------------------
    def _actions_sorted(self):
        return sorted(
            (ev for ev in self.events if isinstance(ev, (Crash, Restore))),
            key=lambda ev: (ev.at, isinstance(ev, Crash)),
        )

    def actions_at(self, rnd: int) -> list:
        """Crash/Restore events taking effect at the START of ``rnd``
        (restores ordered before crashes, so a same-round
        restore-then-crash of different replicas resolves sanely)."""
        return [ev for ev in self._actions_sorted() if ev.at == rnd]

    def next_action_round(self, rnd: int) -> "int | None":
        """First round > ``rnd`` with a crash/restore action or a
        corruption injection (None when the timeline holds no further
        actions) — fused chaos windows must break there to process the
        action host-side."""
        future = [ev.at for ev in self.events
                  if isinstance(ev, (Crash, Restore)) and ev.at > rnd]
        for ev in self.events:
            if isinstance(ev, CorruptRows) and ev.at > rnd:
                future.append(ev.at)
            elif isinstance(ev, BitRot):
                if rnd < ev.start:
                    nxt = ev.start
                else:
                    k = (rnd - ev.start) // ev.every + 1
                    nxt = ev.start + k * ev.every
                if nxt < ev.stop:
                    future.append(nxt)
        return min(future) if future else None

    def corruptions_at(self, rnd: int) -> list:
        """Corruption injections due at the START of ``rnd``:
        ``[(event_index, event, shot), ...]`` where ``shot`` is the
        occurrence ordinal inside a :class:`BitRot` window (0 for point
        :class:`CorruptRows`) — the per-occurrence seed column."""
        out = []
        for i, ev in enumerate(self.events):
            if isinstance(ev, CorruptRows) and ev.at == rnd:
                out.append((i, ev, 0))
            elif (
                isinstance(ev, BitRot)
                and ev.start <= rnd < ev.stop
                and (rnd - ev.start) % ev.every == 0
            ):
                out.append((i, ev, (rnd - ev.start) // ev.every))
        return out

    def crashed_at(self, rnd: int) -> np.ndarray:
        """``bool[R]``: replicas down DURING round ``rnd`` (actions take
        effect at round start)."""
        down = np.zeros(self.n_replicas, dtype=bool)
        for ev in self._actions_sorted():
            if ev.at > rnd:
                break
            down[ev.replica] = isinstance(ev, Crash)
        return down

    def active_at(self, rnd: int) -> list:
        """Windowed fault events active during round ``rnd``."""
        return [
            ev for ev in self.events
            if isinstance(ev, _WINDOWED) and ev.start <= rnd < ev.stop
        ]

    def duplicate_links_at(self, rnd: int, alive=None) -> int:
        """How many LIVE directed edges deliver TWICE this round under
        active ``DuplicateLinks`` windows (the at-least-once accounting;
        idempotence makes the duplicates no-ops). Only edges that
        actually deliver count: dead links (this round's mask — pass
        ``alive`` when the caller already holds it to skip the rebuild),
        crashed endpoints, and structural self-edges deliver nothing and
        are excluded."""
        windows = [
            (i, ev) for i, ev in enumerate(self.events)
            if isinstance(ev, DuplicateLinks) and ev.start <= rnd < ev.stop
        ]
        if not windows:
            return 0
        if alive is None:
            alive = self.mask_at(rnd)
        delivering = (
            np.ones(self.neighbors.shape, dtype=bool)
            if alive is None
            else np.asarray(alive, dtype=bool)
        )
        r = np.arange(self.n_replicas, dtype=np.int64)[:, None]
        delivering = delivering & (self.neighbors != r)  # self-edges: no-op
        total = 0
        for i, ev in windows:
            u = _mix(self._pair_keys, self.seed * 1_000_003 + i * 7919)
            total += int(((u < ev.frac) & delivering).sum())
        return total

    # -- mask compilation -----------------------------------------------------
    def mask_at(self, rnd: int) -> "np.ndarray | None":
        """The edge-alive mask round ``rnd`` runs under: ``bool[R, K]``
        (True = alive), or None when no fault is active (the unmasked
        fast path). Symmetric by construction — every kill is keyed on
        the order-free link — and content-cached: consecutive rounds
        with identical fault state share ONE array object (the frontier
        mask-identity contract)."""
        from ..mesh.topology import symmetrize_edge_mask

        nbrs = self.neighbors
        R, K = nbrs.shape
        alive = np.ones((R, K), dtype=bool)
        any_fault = False
        for i, ev in enumerate(self.events):
            if not isinstance(ev, _WINDOWED) or not (
                ev.start <= rnd < ev.stop
            ):
                continue
            if isinstance(ev, Partition):
                group = (np.arange(R) * ev.n_groups) // R
                alive &= group[:, None] == group[nbrs]
                any_fault = True
            elif isinstance(ev, FlakyLinks):
                u = _mix(
                    self._pair_keys,
                    (self.seed * 1_000_003 + i * 7919) ^ (rnd * 2_654_435),
                )
                alive &= u >= ev.drop_rate
                any_fault = True
            elif isinstance(ev, DelayLinks):
                u = _mix(self._pair_keys, self.seed * 1_000_003 + i * 7919)
                affected = u < ev.frac
                # the buffered link flushes only every delay+1 rounds
                if (rnd - ev.start) % (ev.delay + 1) != ev.delay:
                    alive &= ~affected
                    any_fault = True
            elif isinstance(ev, SlowShard):
                if (rnd - ev.start) % ev.period != 0:
                    rows = shard_rows(R, ev.n_shards, ev.shard)
                    touched = np.zeros(R, dtype=bool)
                    touched[rows] = True
                    alive &= ~(touched[:, None] | touched[nbrs])
                    any_fault = True
            # DuplicateLinks: accounting only, no mask effect
        down = self.crashed_at(rnd)
        if down.any():
            # fail-stop: a crashed replica neither contributes state
            # (peers pulling it substitute their own rows) nor pulls
            alive &= ~(down[:, None] | down[nbrs])
            any_fault = True
        if not any_fault:
            # keep the cache: periodic faults (SlowShard, DelayLinks)
            # alternate masked/unmasked rounds with RECURRING content —
            # the cached object keeps identity stable across the cycle
            return None
        alive = symmetrize_edge_mask(nbrs, alive)
        key = alive.tobytes()
        if self._mask_cache is not None and self._mask_cache[0] == key:
            return self._mask_cache[1]
        self._mask_cache = (key, alive)
        return alive

    def masks(self, start: int, stop: int) -> np.ndarray:
        """``bool[stop-start, R, K]`` — the stacked per-round masks of a
        window (all-alive planes where no fault is active), the operand
        of ``ops.fused.fused_chaos_rounds``."""
        if stop <= start:
            raise ValueError(f"empty window [{start}, {stop})")
        out = np.ones(
            (stop - start,) + tuple(self.neighbors.shape), dtype=bool
        )
        for t, rnd in enumerate(range(start, stop)):
            m = self.mask_at(rnd)
            if m is not None:
                out[t] = m
        return out

    def rebase(self, n_replicas: int, neighbors) -> "ChaosSchedule":
        """The same timeline re-compiled for a CHANGED membership
        (``ChaosRuntime.sync_membership``): crash/restore events naming
        a replica outside the new extent are dropped as pairs (a
        departed replica can neither crash nor restore), windowed
        events re-derive their masks from the new topology naturally.
        Determinism is preserved — the same seed drives the new extent's
        draws, so a replay that re-bases at the same round reproduces
        the same masks."""
        n = int(n_replicas)
        dropped = {
            ev.replica for ev in self.events
            if isinstance(ev, (Crash, Restore)) and ev.replica >= n
        }
        events = tuple(
            ev for ev in self.events
            if not (isinstance(ev, (Crash, Restore))
                    and ev.replica in dropped)
        )
        return ChaosSchedule(n, neighbors, events, seed=self.seed)

    def describe(self) -> dict:
        """Plain-data timeline summary (CLI / bench artifact embedding)."""
        return {
            "n_replicas": self.n_replicas,
            "seed": self.seed,
            "horizon": self.horizon,
            "events": [
                {"kind": type(ev).__name__, **ev._asdict()}
                for ev in self.events
            ],
        }


# ---------------------------------------------------------------------------
# nemesis presets
# ---------------------------------------------------------------------------

#: canonical preset names (CLI spelling; underscores accepted too).
#: These are the CRASH/PARTITION-class presets: every one upholds the
#: full ``run_harness`` invariant suite (inflation + post-heal
#: bit-equality) with no repair layer attached.
PRESETS = ("ring-cut", "rolling-crash", "flaky-links", "slow-shard",
           "delay-links")

#: CORRUPTION-class presets (silent state mutation — a different fault
#: class: without the AAE layer attached nothing detects them and the
#: fixed point is NOT the fault-free one; see the fault-model table in
#: docs/RESILIENCE.md). Soaked via ``chaos.invariants.run_aae_harness``
#: / ``lasp_tpu aae``, never the plain invariant harness.
CORRUPTION_PRESETS = ("bit-rot", "corrupt-partition")


def nemesis(preset: str, n_replicas: int, neighbors, *, seed: int = 0,
            rounds: int = 12, start: int = 2, **kwargs) -> ChaosSchedule:
    """Build a preset nemesis schedule — the soak verbs' vocabulary:

    - ``ring-cut``: a 2-way (``n_groups``) partition for ``rounds``
      rounds, then heal — the classic split-brain/merge.
    - ``rolling-crash``: ``crashes`` replicas fail-stop one after
      another, each down for ``down`` rounds then restored from
      ``source`` (bottom by default) — the rolling-restart nemesis.
    - ``flaky-links``: every link drops with ``drop_rate`` per round
      for ``rounds`` rounds, plus a ``DuplicateLinks`` overlay — lossy,
      at-least-once fabric.
    - ``slow-shard``: shard ``shard`` of ``n_shards`` only exchanges
      every ``period``-th round — the straggler device.
    - ``delay-links``: a ``frac`` subset of links buffers deliveries
      ``delay`` rounds — cross-DC latency skew.

    All presets are deterministic in ``(seed, arguments)`` and heal by
    ``schedule.horizon``; extra ``kwargs`` override the preset's knobs.
    """
    name = preset.replace("_", "-")
    n = int(n_replicas)
    stop = start + int(rounds)
    if name == "ring-cut":
        ev = [Partition(start, stop, int(kwargs.pop("n_groups", 2)))]
    elif name == "rolling-crash":
        crashes = int(kwargs.pop("crashes", min(3, max(1, n // 8))))
        down = int(kwargs.pop("down", max(2, rounds // 3)))
        stagger = int(kwargs.pop("stagger", max(1, down // 2)))
        source = kwargs.pop("source", "bottom")
        rng = np.random.RandomState(seed)
        victims = rng.choice(n, size=min(crashes, n), replace=False)
        ev = []
        for i, r in enumerate(victims):
            at = start + i * stagger
            ev.append(Crash(at, int(r)))
            ev.append(Restore(at + down, int(r), source=source))
    elif name == "flaky-links":
        drop = float(kwargs.pop("drop_rate", 0.25))
        dup = float(kwargs.pop("duplicate_frac", 0.2))
        ev = [FlakyLinks(start, stop, drop),
              DuplicateLinks(start, stop, dup)]
    elif name == "slow-shard":
        ev = [SlowShard(
            start, stop,
            shard=int(kwargs.pop("shard", 0)),
            n_shards=int(kwargs.pop("n_shards", 4)),
            period=int(kwargs.pop("period", 3)),
        )]
    elif name == "delay-links":
        ev = [DelayLinks(
            start, stop,
            frac=float(kwargs.pop("frac", 0.3)),
            delay=int(kwargs.pop("delay", 2)),
        )]
    elif name == "bit-rot":
        # ambient silent corruption: one seeded injection every
        # `every`-th round of the window (all three mutation kinds
        # cycle unless pinned) — the fault class only the AAE layer
        # can detect (docs/RESILIENCE.md "Active anti-entropy")
        every = int(kwargs.pop("every", 2))
        n_rows = int(kwargs.pop("n_rows", 1))
        kind = kwargs.pop("kind", None)
        if kind is not None:
            ev = [BitRot(start, stop, every=every, kind=kind,
                         n_rows=n_rows)]
        else:
            ev = [
                BitRot(start + i, stop, every=every * 3, kind=k,
                       n_rows=n_rows)
                for i, k in enumerate(CORRUPTION_KINDS)
                if start + i < stop
            ]
    elif name == "corrupt-partition":
        # corruption INSIDE a split brain: detection and quorum repair
        # must both stay confined to the corrupt row's component — the
        # combined nemesis the acceptance drill runs
        n_groups = int(kwargs.pop("n_groups", 2))
        n_rows = int(kwargs.pop("n_rows", 1))
        ev = [Partition(start, stop, n_groups),
              CorruptRows(start + 1, kind="bitflip", n_rows=n_rows),
              CorruptRows(min(start + 3, stop - 1), kind="rollback",
                          n_rows=n_rows)]
    else:
        raise ValueError(
            f"unknown nemesis preset {preset!r} "
            f"(known: {PRESETS + CORRUPTION_PRESETS})"
        )
    if kwargs:
        raise TypeError(
            f"nemesis({name!r}): unknown options {sorted(kwargs)}"
        )
    return ChaosSchedule(n, neighbors, ev, seed=seed)
