"""Public API facade: the full Lasp verb set against one session (port of
``lasp_tpu.api.session``; the session's store and every runtime it builds
live on one device, CUDA by default).

Rebuild of ``src/lasp.erl`` (exports :26-51). The reference's verbs are
synchronous wrappers that spawn a coordination FSM and block in
``wait_for_reqid`` (``src/lasp.erl:384-392``); here the store is local and
dataflow is bulk-synchronous, so each mutating verb optionally runs the
graph to its fixed point (``auto_propagate``) — which is *stronger* than
the reference's guarantee (its tests need ``timer:sleep`` for dataflow to
catch up; ours are deterministic after ``propagate``).

Per-verb parity (reference ``src/lasp.erl``):

- ``declare/1,2`` :157-170 → :meth:`Session.declare`
- ``update/3`` :180-184 → :meth:`Session.update`
- ``bind/2`` :194-198, ``bind_to/2`` :201-207 → :meth:`bind` / :meth:`bind_to`
- ``read/1,2`` :222-235 (default threshold ``{strict, undefined}``),
  ``read_any/1`` :241-245 → :meth:`read` / :meth:`read_any`
- ``filter/map/fold/union/intersection/product`` :252-321 → same names
- ``wait_needed/1,2`` :331-337 → :meth:`wait_needed`
- ``thread/3`` :327-329 → :meth:`thread` (runs the function once against
  the local store; the reference spawns it on each of N replicas, which the
  mesh layer's replica axis subsumes)
- ``register/4`` :84-86, ``execute/2`` :99-111, ``process/4`` :129-150 →
  program registry (the L5 layer, ``src/lasp_program.erl``)

Replication-facing verbs (``preflist/3``, ``mk_reqid/0``) have no meaning
without the FSM machinery; their role (replica placement) lives in
``lasp_tpu_torch.mesh``.
"""

from __future__ import annotations

from typing import Any, Optional

from ..dataflow import Graph
from ..lattice import Threshold
from ..store import Store, Watch
from ..telemetry import counter, get_monitor, render_prometheus


#: one-time flag for the locality-renumbering note (see
#: Session.replicate): emitted at the FIRST reordering replicate of the
#: process, not per call — it is a heads-up, not an error
_locality_note_emitted = False


def _count_verb(verb: str) -> None:
    counter(
        "session_ops_total",
        help="public Lasp verbs dispatched through Session, by verb",
        verb=verb,
    ).inc()


class Session:
    """One Lasp session: a store + a dataflow graph + a program registry,
    on ``device`` (default CUDA; without a card pass ``device="cpu"``)."""

    def __init__(self, n_actors: int = 16, auto_propagate: bool = True,
                 device=None):
        self.store = Store(n_actors=n_actors, device=device)
        self.device = self.store.device
        self.graph = Graph(self.store)
        self.auto_propagate = auto_propagate
        self.programs: dict[str, Any] = {}

    # -- variables -----------------------------------------------------------
    def declare(self, type: str = "lasp_ivar", id: Optional[str] = None, **caps) -> str:
        """``lasp:declare/1,2`` (``src/lasp.erl:157-170``)."""
        return self.store.declare(id=id, type=type, **caps)

    def update(self, id: str, op: tuple, actor) -> None:
        """``lasp:update/3`` (``src/lasp.erl:180-184``)."""
        _count_verb("update")
        self.store.update(id, op, actor)
        self._maybe_propagate()

    def bind(self, id: str, state) -> None:
        """``lasp:bind/2`` (``src/lasp.erl:194-198``)."""
        _count_verb("bind")
        self.store.bind(id, state)
        self._maybe_propagate()

    def bind_to(self, dst: str, src: str) -> str:
        """``lasp:bind_to/2`` (``src/lasp.erl:201-207``)."""
        out = self.graph.bind_to(dst, src)
        self._maybe_propagate()
        return out

    # -- reads ---------------------------------------------------------------
    def read(self, id: str, threshold=None) -> Watch:
        """``lasp:read/1,2`` (``src/lasp.erl:222-235``). With no threshold
        the default is "whatever is there" (bottom, non-strict) — note the
        reference's ``read/1`` uses ``{strict, undefined}`` for ivars (wait
        for a bind); pass ``Threshold(None, strict=True)`` for that."""
        _count_verb("read")
        self._maybe_propagate()
        return self.store.read(id, threshold)

    def read_any(self, reads: list) -> Watch:
        """``lasp:read_any/1`` (``src/lasp.erl:241-245``)."""
        self._maybe_propagate()
        return self.store.read_any(reads)

    def wait_needed(self, id: str, threshold=None) -> Watch:
        """``lasp:wait_needed/1,2`` (``src/lasp.erl:331-337``)."""
        return self.store.wait_needed(id, threshold)

    def value(self, id: str):
        """Decoded observable value (``Type:value/1`` on a quorum read)."""
        _count_verb("value")
        self._maybe_propagate()
        return self.store.value(id)

    def metrics_text(self) -> str:
        """Prometheus text exposition of the process-global telemetry
        registry — the in-process twin of the bridge's ``metrics`` verb
        and the CLI's ``metrics`` verb."""
        return render_prometheus()

    def health(self) -> dict:
        """ConvergenceMonitor snapshot + alerts — the in-process twin of
        the bridge's ``{health}`` verb and the CLI's ``top`` verb."""
        return get_monitor().health()

    # -- combinators ---------------------------------------------------------
    def map(self, src: str, fn, dst: Optional[str] = None) -> str:
        out = self.graph.map(src, fn, dst)
        self._maybe_propagate()
        return out

    def filter(self, src: str, fn, dst: Optional[str] = None) -> str:
        out = self.graph.filter(src, fn, dst)
        self._maybe_propagate()
        return out

    def fold(self, src: str, fn, dst: Optional[str] = None) -> str:
        out = self.graph.fold(src, fn, dst)
        self._maybe_propagate()
        return out

    def union(self, left: str, right: str, dst: Optional[str] = None) -> str:
        out = self.graph.union(left, right, dst)
        self._maybe_propagate()
        return out

    def intersection(self, left: str, right: str, dst: Optional[str] = None) -> str:
        out = self.graph.intersection(left, right, dst)
        self._maybe_propagate()
        return out

    def product(self, left: str, right: str, dst: Optional[str] = None) -> str:
        out = self.graph.product(left, right, dst)
        self._maybe_propagate()
        return out

    def thread(self, fn, *args) -> None:
        """``lasp:thread/3`` (``src/lasp.erl:327-329``): run a function
        against the store (the reference spawns it on all N replicas of a
        preflist, ``src/lasp_core.erl:231-235``; the replica axis of the
        mesh layer plays that role here)."""
        fn(*args)

    def propagate(self) -> int:
        """Run the dataflow graph to its fixed point now."""
        return self.graph.propagate()

    def _maybe_propagate(self):
        if self.auto_propagate and self.graph.edges:
            self.graph.propagate()

    # -- replication ---------------------------------------------------------
    def replicate(self, n_replicas: int, neighbors=None, *, topology="ring",
                  fanout: int = 3, seed: int = 0, packed: bool = False,
                  locality: bool = True,
                  **kwargs):
        """Lift this session onto a replicated population — the one-call
        path from the single-store verbs to the mesh layer (the
        reference gets replication implicitly from riak_core; here it is
        explicit and this is the on-ramp). Current variable state seeds
        EVERY replica row; the session's dataflow graph becomes the
        population's per-replica sweep; programs keep working at the
        session level (register mesh-level programs on the returned
        runtime). ``neighbors`` overrides ``topology`` (one of ring /
        random / scale_free) + ``fanout`` + ``seed``; extra kwargs reach
        :class:`~lasp_tpu_torch.mesh.runtime.ReplicatedRuntime`
        (``packed``, ``debug_actors``, ``plan``); the runtime runs on the
        session's device. Irregular built-in topologies are
        locality-ordered by default (a graph isomorphism, kept for parity
        with the JAX package, whose sharded gossip then ships the cut, not
        the population). NOTE: the renumbering means replica INDICES no
        longer match the raw builder's (e.g. ``scale_free`` hubs are no
        longer the low indices); the permutation is exposed as
        ``rt.locality_perm`` (``perm[new_index] = builder_index``), and
        the O(R) host-side walk costs a few seconds at 10M replicas.
        ``locality=False`` opts out, and an explicit ``neighbors`` table
        is never reordered."""
        from ..mesh import ReplicatedRuntime
        from ..mesh.topology import (
            locality_order,
            random_regular,
            ring,
            scale_free,
        )

        perm = None
        if neighbors is None:
            builder = {
                "ring": lambda: ring(n_replicas, fanout),
                "random": lambda: random_regular(n_replicas, fanout,
                                                 seed=seed),
                "scale_free": lambda: scale_free(n_replicas, fanout,
                                                 seed=seed),
            }.get(topology)
            if builder is None:
                raise ValueError(
                    f"unknown topology {topology!r} "
                    "(ring | random | scale_free)"
                )
            neighbors = builder()
            if locality and topology != "ring":
                perm, neighbors = locality_order(neighbors)
                global _locality_note_emitted
                if not _locality_note_emitted:
                    _locality_note_emitted = True
                    import warnings

                    warnings.warn(
                        "Session.replicate(locality=True) renumbers the "
                        f"{topology!r} topology's replica indices (a graph "
                        "isomorphism that keeps sharded gossip's cut "
                        "small); experiments keyed to the raw builder's "
                        "indices (e.g. scale_free hubs at low ids) must "
                        "translate through rt.locality_perm, or pass "
                        "locality=False. This note prints once per "
                        "process (docs/GUIDE.md §replication).",
                        UserWarning,
                        stacklevel=2,
                    )
        rt = ReplicatedRuntime(
            self.store, self.graph, n_replicas, neighbors,
            packed=packed, device=self.device, **kwargs,
        )
        # builder-index of each replica row (None when no reordering
        # happened) — experiments keyed to raw builder indices translate
        # through this
        rt.locality_perm = perm
        return rt

    def nemesis(self, runtime, preset: str, *, seed: int = 0,
                rounds: int = 12, checkpoint: "str | None" = None,
                **kwargs):
        """Wrap a replicated runtime (from :meth:`replicate`) in a
        :class:`~lasp_tpu_torch.chaos.ChaosRuntime` driving a preset fault
        timeline — the session-level on-ramp to the chaos mesh
        (docs/RESILIENCE.md):

        >>> rt = session.replicate(64)
        >>> chaos = session.nemesis(rt, "ring-cut", seed=3)
        >>> report = chaos.soak()          # rounds_to_heal, repair bytes

        ``preset`` is one of :data:`lasp_tpu_torch.chaos.PRESETS` (ring-cut /
        rolling-crash / flaky-links / slow-shard / delay-links); extra
        kwargs reach the preset builder (drop rates, crash counts, …);
        ``checkpoint`` backs ``Restore(source="checkpoint")`` rows. The
        soak outcome lands in :meth:`health` under ``chaos``."""
        from ..chaos import ChaosRuntime, nemesis as build_nemesis

        _count_verb("nemesis")
        schedule = build_nemesis(
            preset, runtime.n_replicas, runtime._host_neighbors,
            seed=seed, rounds=rounds, **kwargs,
        )
        return ChaosRuntime(runtime, schedule, checkpoint=checkpoint)

    def quorum(self, runtime, *, n: int = 3, r: int = 2, w: int = 2,
               hints: "str | None" = None, **kwargs):
        """Wrap a replicated runtime (from :meth:`replicate`) — or a
        :class:`~lasp_tpu_torch.chaos.ChaosRuntime` from :meth:`nemesis` — in
        a :class:`~lasp_tpu_torch.quorum.QuorumRuntime`: the batched
        request-coordination layer (Dynamo-style N/R/W get/put FSMs,
        read-repair, hinted handoff — docs/RESILIENCE.md "Quorum
        coordination"):

        >>> rt = session.replicate(64)
        >>> chaos = session.nemesis(rt, "rolling-crash")
        >>> kv = session.quorum(chaos)
        >>> rid = kv.submit_put("kv", ("add", "x"), "client0")
        >>> kv.step(); kv.result(rid)

        ``n``/``r``/``w`` default to the reference's N=3, R=W=2;
        ``hints`` names a durable hint-log path (default in-memory);
        extra kwargs reach :class:`QuorumRuntime` (``timeout``,
        ``retries``, ``engine``, ``mode``). The coordination report
        lands in :meth:`health` under ``quorum``."""
        from ..quorum import QuorumRuntime

        _count_verb("quorum")
        return QuorumRuntime(runtime, n=n, r=r, w=w, hints=hints,
                             **kwargs)

    def aae(self, runtime, **kwargs):
        """Wrap a replicated runtime (from :meth:`replicate`) — or a
        :class:`~lasp_tpu_torch.chaos.ChaosRuntime` from :meth:`nemesis` — in
        an :class:`~lasp_tpu_torch.aae.AAEScrubber`: active anti-entropy via
        vectorized Merkle hashtrees, pairwise tree exchange, and
        targeted quorum repair (docs/RESILIENCE.md "Active
        anti-entropy"):

        >>> rt = session.replicate(64)
        >>> chaos = session.nemesis(rt, "rolling-crash")
        >>> scrub = session.aae(chaos)      # attaches per-round hooks
        >>> chaos.soak(); scrub.report()    # detections, repairs

        On a chaos runtime the scrubber attaches itself to the engine's
        per-round hooks (detect/repair before each gossip dispatch,
        commit after); on a bare runtime call ``scrub()`` yourself (or
        hand it to ``ServeFrontend(aae=...)`` for background scrubs).
        Extra kwargs reach :class:`AAEScrubber` (``seg_size``,
        ``scrub_every``, ``quorum``, ``auto_attach``). The AAE report
        lands in :meth:`health` under ``aae``. On a runtime sharded across
        processes it refuses for parity: JAX's forest hashes the population
        on the host, which fails there (ROADMAP A5c.8, C9)."""
        getattr(runtime, "rt", runtime)._refuse_across("Session.aae", 8)
        from ..aae import AAEScrubber

        _count_verb("aae")
        return AAEScrubber(runtime, **kwargs)

    def serve(self, runtime, **kwargs):
        """Wrap a replicated runtime (from :meth:`replicate`) — or a
        :class:`~lasp_tpu_torch.chaos.ChaosRuntime` from :meth:`nemesis` — in
        a :class:`~lasp_tpu_torch.serve.ServeFrontend`: the overload-hardened
        ingestion front-end (bounded admission queues, coalesced
        ``update_batch`` megabatches, vectorized threshold fan-out,
        deadline propagation, the degradation ladder —
        docs/SERVING.md):

        >>> rt = session.replicate(64)
        >>> fe = session.serve(rt)
        >>> t = fe.submit_write("kv", ("add", "x"), "client0")
        >>> fe.cycle(); t.status
        'done'

        Extra kwargs reach :class:`ServeFrontend` (``admission``,
        ``gossip_block``, ``coalesce_max``, ``clock``,
        ``write_backup``). The serving report lands in :meth:`health`
        under ``serve``. On a runtime sharded across processes pass a
        ``clock`` that every process reads alike."""
        from ..serve import ServeFrontend

        _count_verb("serve")
        return ServeFrontend(runtime, **kwargs)

    # -- programs (L5, src/lasp_program.erl) ---------------------------------
    def register(self, name: str, program_cls, *args, **kwargs) -> str:
        """``lasp:register/4`` (``src/lasp.erl:84-86``): instantiate a
        program and run its ``init``. The reference ships source code to
        every partition and compiles it there (``src/lasp_vnode.erl:
        276-366``) because BEAM hot-loads code at runtime; a traced Python
        class needs no deployment step."""
        if name in self.programs:
            return name  # idempotent, like the vnode's dets check
        program = program_cls(*args, **kwargs)
        program.init(self)
        self.programs[name] = program
        return name

    def execute(self, name: str):
        """``lasp:execute/2`` (``src/lasp.erl:99-111``): the program's
        current result, decoded, after its ``value`` filter."""
        program = self.programs[name]
        return program.value(program.execute(self))

    def process(self, object, reason, actor) -> None:
        """``lasp:process/4`` (``src/lasp.erl:129-150``): notify every
        registered program of an object event (the riak_kv put/delete/
        handoff hook path)."""
        # snapshot: a program may register NEW programs while processing
        # (the index program auto-creates views, src/lasp_riak_index_
        # program.erl:162-176); like the reference's async create_views,
        # a view registered by this event first sees the NEXT event
        for program in list(self.programs.values()):
            program.process(self, object, reason, actor)
        self._maybe_propagate()
