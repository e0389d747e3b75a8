"""Replicated runtime: the store × a replica population × a topology (port
of the ``lasp_tpu.mesh.runtime.ReplicatedRuntime`` core).

Every variable's state carries a leading replica axis ``[R, ...]`` on the
runtime's device; client operations apply at chosen replica rows and
bulk-synchronous gossip rounds spread them. Ported:

- construction, including ``packed=True`` (OR-Set families held in the flat
  bit-packed wire format, ``ops.flatpack``), ``plan="auto" | "off"`` and
  ``debug_actors`` (the actor-collision guard: :class:`ActorCollisionError`
  at a second write site of one actor lane);
- the write path: ``update_at``; ``ingest_cycle``, which under
  ``plan="auto"`` resolves each variable's ops into an op table and lands
  each dispatch-plan group's tables in one group apply (``mesh.ingest``)
  with exact dirty marks, and under ``plan="off"`` runs the per-variable
  arm; ``update_batch`` (one variable's cycle); ``apply_batch``;
  ``seed_tokens`` and ``seed_increments`` with JAX's index semantics
  (negative indices wrap, out-of-range ones drop, filtered on the host
  before the scatter);
- the dense engine: ``step``, ``begin_fused_steps`` (a
  :class:`FusedBlockHandle` whose ``finish`` syncs), ``fused_steps``,
  ``run_to_convergence(block=)`` and ``converge_on_device`` (fused blocks
  of at most 8 rounds, one host sync a block). A step is the local round —
  the dataflow graph's sweep and the reactive triggers
  (``register_trigger``) on dense views of every replica — then gossip;
  unmasked rounds of packed OR-Sets run through the CUDA kernel K1. The
  dense step stays per variable under either plan mode (the JAX step is
  grouped; the results are the same by construction);
- the frontier scheduler: ``mark_dirty``, ``frontier_step``,
  ``run_to_convergence(mode="frontier" | "auto")``, for a runtime with no
  dataflow edges and no triggers. With ``plan="off"``
  every variable takes its own round; with ``plan="auto"`` (the default,
  as in JAX) same-signature variables share one row-sparse kernel launch
  per group per round (``mesh.plan``). Sparse rounds run through the CUDA
  kernels K2 (leafwise codecs) and K3 (OR-SWOT), their plain versions for
  a population on the CPU; the dense crossover is decided per variable;
- reads: ``coverage_value``, ``replica_value``, ``quorum_value``,
  ``divergence``, ``read_at``, and the parked reads ``read_until`` /
  ``read_any_until``: by default the wait runs one round at a time with
  the threshold predicate evaluated on the device at the replica's row and
  one int32 crossing to the host a round; ``on_device=False`` probes the
  row from the host between (fused) rounds.

Rows are updated in place (client writes, sparse-round scatters) where the
JAX runtime rebinds donated buffers: do not hold ``rt.states[v]`` leaves
across a write or a round and expect the old values. A planned round reads
each member population where it lies (the kernels take a table of member
base pointers) and never stacks a group's populations.

Maps (``riak_dt_map``) ride every path: ``update_at`` and the batches
admit first-touched ``{Name, Type}`` keys and re-lay out the population
(``_grow_map_population``); a batch whose fields are all G-Counters,
G-Sets or IVars takes the vectorized ``_map_batch``, any other shape the
per-op path with a warning, as in JAX; a map has no op table and no rows
plan, so it takes the per-variable ingest arm and plain-PyTorch gossip
rounds. Compaction: ``compact_orset`` (dense and packed),
``compact_map_field`` and the ``compaction_window`` context.

Row primitives and membership: ``join_rows`` (the masked partial join
under read-repair, quorum puts and hinted handoff; only changed rows are
marked dirty), ``reseed_row`` (a row back to bottom or to supplied wire
rows, e.g. ``store.checkpoint.load_runtime_rows``), ``resize`` (join,
graceful leave folded into the claim successors, crash leave, topology
swap) and the staged commits ``membership_grow`` /
``membership_drop_tail`` with row-scoped ``dirty_rows``. Every membership
commit advances ``membership_epoch``, re-validates the topology and drops
every view sized by the old population; departed actor sites move to
their claim successor or retire to ``-1``.

Mesh programs: ``register`` / ``process`` / ``execute`` / ``programs``
(``mesh.programs.MeshSession`` binds a program's reads and writes to one
row, or to the coverage join). Telemetry: every stepping entry feeds the
metric registry, the ConvergenceMonitor, the causal event log and the
kernel cost ledger (``_emit_step_telemetry``, ``_emit_frontier_telemetry``,
``_ledger_record_var`` / ``_ledger_record_store``), and the fused windows
(``begin_fused_steps``, ``converge_on_device``) carry a flight ring on the
device, drained after their sync (``_drain_flight``). Sharding is a later
slice (``shard`` raises ``NotImplementedError``).
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import time
import warnings

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..dataflow.plan import tree_select
from ..device import resolve_device
from ..lattice.base import replicate, tree_leaves, tree_map, tree_unflatten
from ..lattice.map import CrdtMap, map_subs
from ..membership.plan import claim_targets
from ..ops import cuda_gossip
from ..ops.flatpack import FlatORSet, FlatORSetSpec
from ..store.store import PreconditionError
from ..telemetry import counter, gauge, histogram, span
from ..telemetry import device as tel_flight
from ..telemetry import events as tel_events
from ..telemetry import registry as tel_registry
from ..telemetry.convergence import get_monitor, record_membership
from ..telemetry.roofline import get_ledger
from ..utils.interning import CapacityError
from . import gossip as gossip_mod
from . import ingest as ingest_mod
from .gossip import (
    _word_planes,
    changed_rows,
    divergence,
    frontier_reach,
    gossip_round,
    gossip_round_rows,
    join_all,
    quorum_read,
    round_traffic_bytes,
)
from .plan import compile_plan

#: store types held flat-bit-packed on the mesh when ``packed=True``
_PACKABLE = ("lasp_orset", "lasp_orset_gbtree")

#: rounds a fused block of ``converge_on_device`` runs between host syncs
_CONVERGE_BLOCK = 8


class _CapacityWalk:
    """Free-slot accounting for one interner across a batch walk: counts
    the new terms an op needs without interning, so a failing op can be
    refused before anything mutates."""

    def __init__(self, interner):
        self.interner = interner
        self.free = (
            interner.capacity - len(interner) if interner is not None else None
        )
        self.seen: set = set()

    def take(self, terms):
        """Reserve slots for the new terms among ``terms``; returns the
        ``CapacityError`` to raise (nothing reserved) or None."""
        if self.interner is None:
            return None
        need = [
            t for t in dict.fromkeys(terms)
            if t not in self.interner and t not in self.seen
        ]
        if self.free is not None and len(need) > self.free:
            return CapacityError(
                f"{self.interner.kind} universe full "
                f"({self.interner.capacity}); cannot intern "
                f"{need[self.free]!r} — declare the variable with a "
                "larger capacity"
            )
        if self.free is not None:
            self.free -= len(need)
        self.seen.update(need)
        return None


def _not_ported(what: str):
    raise NotImplementedError(
        f"ReplicatedRuntime.{what} is not ported to lasp_tpu_torch yet"
    )


def _leaves(tree) -> list:
    """The leaves of a threshold state: tuples, lists and dicts flatten,
    ``None`` (a map's absent tombstone) has none, anything else is a
    leaf."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    return [tree]


def _device_expressible(state) -> bool:
    """Can this threshold state ride into the device-parked wait? Every
    codec threshold (lattice states, numeric counter bounds) can; a
    host-only payload (an object-dtype leaf) cannot, and the wait then
    probes from the host."""
    try:
        for leaf in _leaves(state):
            dt = getattr(leaf, "dtype", None)
            if dt is None:
                dt = np.asarray(leaf).dtype  # plain Python leaf
            if dt == object:
                return False
        return True
    except (TypeError, ValueError):
        return False


def _vmap_rows(fn, tree):
    """``torch.func.vmap(fn)(tree)`` over the replica axis of every tensor
    in ``tree``, where ``tree`` and ``fn``'s result may hold None leaves (a
    map's absent epochs and tombstones), which vmap itself refuses: the
    None leaves stay out of the mapped call and are put back around it."""
    leaves, spec = pytree.tree_flatten(tree)
    live = [i for i, x in enumerate(leaves) if x is not None]
    out_shape = {}

    def flat_fn(*xs):
        full = list(leaves)
        for i, x in zip(live, xs):
            full[i] = x
        out_leaves, out_shape["spec"] = pytree.tree_flatten(
            fn(pytree.tree_unflatten(full, spec))
        )
        out_shape["none"] = [x is None for x in out_leaves]
        return tuple(x for x in out_leaves if x is not None)

    outs = iter(torch.func.vmap(flat_fn)(*(leaves[i] for i in live)))
    return pytree.tree_unflatten(
        [None if none else next(outs) for none in out_shape["none"]],
        out_shape["spec"],
    )


class ActorCollisionError(RuntimeError):
    """Two replica rows minted per-actor lane events under one actor
    (raised only under the opt-in ``debug_actors`` guard). The riak_dt
    actor requirement: an actor names one writing site; colliding dot
    counters read as observed-and-removed, and same-lane counter increments
    max-merge into lost counts — silently."""


class _PendingBatch:
    """One variable's prepared, not yet applied op batch inside an ingest
    cycle: the host phases ran (``_batch_begin``); the dispatch outcome and
    the bookkeeping inputs gather here until ``_batch_finalize``."""

    __slots__ = ("var", "var_id", "tn", "ops", "states", "cap_err",
                 "guard_actors", "table", "err", "marks", "encode_failed")

    def __init__(self, var, var_id, tn, ops, states, cap_err, guard_actors):
        self.var = var
        self.var_id = var_id
        self.tn = tn
        self.ops = ops
        self.states = states
        self.cap_err = cap_err
        self.guard_actors = guard_actors
        #: the resolved op table (``mesh.ingest``); None = per-variable arm
        self.table = None
        #: dispatch / encode error (``cap_err`` stays apart: it defers)
        self.err = None
        #: exact changed rows from the group apply; None = per-variable arm
        #: (superset marking)
        self.marks = None
        self.encode_failed = False


class FusedBlockHandle:
    """An enqueued, not yet synced fused block (``begin_fused_steps``):
    :meth:`finish` waits for the block's first-quiescent index and does the
    round bookkeeping ``fused_steps`` does inline. ``finish`` is
    idempotent: the first call resolves, later calls return the result."""

    __slots__ = ("_rt", "_block", "_first_zero", "_states_in", "_flight",
                 "_t0", "_result")

    def __init__(self, rt, block, first_zero, states_in, flight, t0):
        self._rt = rt
        self._block = block
        self._first_zero = first_zero
        #: the states from before the window, held until the sync
        #: succeeds: the port never donates, so a failed sync restores them
        self._states_in = states_in
        #: the window's flight ring (``int32[K, V]`` per-round residual
        #: records on the device), drained after the sync; None with
        #: telemetry off
        self._flight = flight
        self._t0 = t0
        self._result: "int | None" = None

    @property
    def pending(self) -> bool:
        return self._result is None

    def finish(self) -> int:
        if self._result is not None:
            return self._result
        rt = self._rt
        try:
            first_zero = int(self._first_zero)  # the window's one device sync
        except Exception:
            if self._states_in is not None:
                rt._restore_states(self._states_in)
            raise
        finally:
            self._states_in = None
        elapsed = time.perf_counter() - self._t0
        block = self._block
        rt._frontier_after_opaque(first_zero >= 0)
        rt.round_residuals.append(-1 if first_zero < 0 else 0)
        rt._record_rounds(block)  # the block runs every one of its rounds
        # the flight drain rides the sync above: real per-round residual
        # records, and the exact changed-state tally for the ledger
        flight, self._flight = self._flight, None
        joins = None
        if flight is not None:
            joins = rt._drain_flight(
                "fused_block", flight, block, first_zero >= 0, elapsed
            )
        rt._ledger_record_store("fused_block", elapsed, block, block=block,
                                joins=joins)
        self._result = first_zero
        return first_zero


class ReplicatedRuntime:
    """Simulates ``n_replicas`` copies of a store under a gossip topology,
    bulk-synchronously, on one device."""

    _FRONTIER_MIN_BUCKET = 16

    def __init__(self, store, graph, n_replicas: int, neighbors,
                 packed: bool = False, plan: str = "auto",
                 debug_actors: bool = False, device=None):
        if plan not in ("auto", "off"):
            raise ValueError(f"unknown plan mode {plan!r} ('auto' or 'off')")
        self.device = resolve_device(device)
        self.store = store
        self.graph = graph
        self.n_replicas = int(n_replicas)
        nbrs = np.asarray(neighbors)
        if nbrs.ndim != 2 or nbrs.shape[0] != self.n_replicas:
            raise ValueError(
                f"neighbors must be [{self.n_replicas}, K], got {nbrs.shape}"
            )
        if nbrs.size and (nbrs.min() < 0 or nbrs.max() >= self.n_replicas):
            # the kernels index rows with these: validated once, here
            raise ValueError("neighbor indices out of range")
        #: host copy (frontier reachability runs on the host)
        self._host_neighbors = nbrs.astype(np.int32)
        self.neighbors = torch.as_tensor(
            self._host_neighbors, device=self.device
        ).contiguous()
        self.packed = packed
        #: opt-in actor-collision guard; the write-site registry maps
        #: (var_id, actor identity) -> home replica
        self.debug_actors = debug_actors
        self._actor_sites: dict = {}
        self.states: dict = {}
        self._packed_specs: dict[str, FlatORSetSpec] = {}
        #: per-var dirty-replica frontier masks (host ``np.bool_[R]``)
        self._frontier: dict[str, np.ndarray] = {}
        #: the edge_mask object the frontier masks are relative to
        self._frontier_mask_ref = None
        #: (mask object, host bool[R, K], device bool[R, K]) of the last mask
        self._mask_views = (None, None, None)
        #: reachable-row share above which a frontier round runs dense
        self.frontier_crossover = 0.25
        #: one entry per round, the JAX ``StepTrace`` residual convention:
        #: the changed-state count of a step / frontier step, and per fused
        #: block -1 (no quiescent round in it) or 0
        self.round_residuals: list[int] = []
        self.frontier_rows_last = 0
        #: rows every frontier round so far touched (frontier_sparse's
        #: crossover autotune reads its deltas)
        self.frontier_rows_total = 0
        self.frontier_dense_falls_last = 0
        self._elem_masks: dict = {}
        #: "auto" groups same-signature variables into one kernel launch per
        #: group per frontier round; "off" steps every variable on its own
        self.plan_mode = plan
        #: the compiled DispatchPlan, or None until the next stepping call
        self._plan = None
        #: reactive rules run in every step: ``(fn, touches | None, builder)``
        self._triggers: list = []
        #: edge count the round function was built for (-1: never)
        self._n_edges = -1
        #: monotone membership epoch, advanced by every resize / staged
        #: commit (consumers holding population-relative indices fence on it)
        self.membership_epoch = 0
        #: ``fn(sources, targets)`` vetting a graceful leave's handoff pairs
        #: (``chaos.ChaosRuntime`` installs its guard here)
        self._handoff_guard = None
        #: per-var row footprint, cleared with the plan (:meth:`_row_bytes`)
        self._row_bytes_cache: dict = {}
        #: AAE bookkeeping (``aae.HashForest``): an attached forest parks its
        #: dirty accumulator here and every tracked row mutation ORs into it
        #: (:meth:`_aae_mark`). Structural events bump the STATE epoch
        #: (committed hashes drop), a mask flip bumps the TREE epoch (only the
        #: tree levels rebuild): :meth:`_invalidate_plan`.
        self._aae_dirty: "dict | None" = None
        self._aae_state_epoch = 0
        self._aae_tree_epoch = 0
        #: mesh-level programs by name and their session (:meth:`register`)
        self._programs: dict = {}
        self._program_session = None
        #: hot-path instrument cache (:meth:`_instruments`)
        self._tel_cache = None
        #: bytes one pull round moves (``_traffic_estimate``), refreshed by
        #: every stepping entry
        self._round_traffic = 0
        self._sync_graph()

    def _sync_graph(self) -> None:
        """Fold in edges and variables added to the graph or store after
        construction: rebuild the graph's round function and replicate
        every declared variable that has no population yet."""
        graph = self.graph
        graph.refresh()
        if graph.edges:
            graph._build()
        self._n_edges = len(graph.edges)
        for v in self.store.ids():
            var = self.store.variable(v)
            if v in self.states:
                continue
            state = tree_map(lambda x: x.to(self.device), var.state)
            if self.packed and var.type_name in _PACKABLE:
                self._packed_specs[v] = FlatORSetSpec(dense=var.spec)
                state = FlatORSet.pack(self._packed_specs[v], state)
            self.states[v] = replicate(state, self.n_replicas)
        for v in self.states:
            self._frontier.setdefault(v, np.zeros(self.n_replicas, dtype=bool))
        self.var_ids = tuple(self.states)
        # a late-declared variable changes the census and maybe a signature
        self._invalidate_plan("var_set")

    # -- dispatch plan ---------------------------------------------------------
    def _invalidate_plan(self, reason: str) -> None:
        """Drop the compiled dispatch plan so the next stepping call
        regroups. ``reason``: ``var_set`` (late declare) or ``mask_change``
        (edge-mask identity changed), the port's triggers of the JAX set
        (``plan_invalidation_total`` counts them by reason). The
        row-footprint cache drops with it, and the AAE epochs advance as
        JAX's do: a mask flip bumps the tree epoch, a restore neither (the
        reseeded row is marked AAE-dirty itself), anything else the state
        epoch."""
        self._row_bytes_cache.clear()
        if reason == "mask_change":
            self._aae_tree_epoch += 1
        elif reason != "restore":
            self._aae_state_epoch += 1
        if self._plan is None:
            return
        self._plan = None
        counter(
            "plan_invalidation_total",
            help="dispatch-plan invalidations by trigger",
            reason=reason,
        ).inc()

    def _ensure_plan(self):
        """The current :class:`~.plan.DispatchPlan`, or None with planning
        off; compiled lazily (a host-only grouping walk)."""
        if self.plan_mode == "off":
            return None
        if self._plan is None:
            self._plan = compile_plan(self)
        return self._plan

    # -- mesh-side codec selection -------------------------------------------
    def _mesh_meta(self, var_id: str):
        """(codec, spec) as the mesh sees the variable."""
        if var_id in self._packed_specs:
            return FlatORSet, self._packed_specs[var_id]
        var = self.store.variable(var_id)
        return var.codec, var.spec

    def _to_dense_row(self, var_id: str, row):
        if var_id in self._packed_specs:
            return FlatORSet.unpack(self._packed_specs[var_id], row)
        return row

    def _from_dense_row(self, var_id: str, row):
        if var_id in self._packed_specs:
            return FlatORSet.pack(self._packed_specs[var_id], row)
        return row

    def _masks(self, edge_mask):
        """(host, device) views of one edge mask, cached by identity."""
        if edge_mask is None:
            return None, None
        ref, host, dev = self._mask_views
        if ref is not edge_mask:
            if isinstance(edge_mask, torch.Tensor):
                host = edge_mask.detach().cpu().numpy().astype(bool)
            else:
                host = np.asarray(edge_mask, dtype=bool)
            if host.shape != self._host_neighbors.shape:
                raise ValueError(
                    f"edge_mask must be bool{self._host_neighbors.shape}"
                )
            dev = torch.as_tensor(host, device=self.device)
            self._mask_views = (edge_mask, host, dev)
        return host, dev

    def _prime_mask(self, dev: torch.Tensor, host: np.ndarray) -> None:
        """Make ``dev`` (a ``bool[R, K]`` mask on this runtime's device)
        the cached mask, with ``host`` its host copy: a step under ``dev``
        then copies the mask neither way (the chaos layer's per-round
        masks)."""
        self._mask_views = (dev, host, dev)

    # -- reactive triggers -----------------------------------------------------
    def register_trigger(self, fn=None, touches=None, *, builder=None) -> None:
        """Register a per-replica reactive rule run inside every step:
        ``fn(dense_states: dict) -> dict[var_id, candidate_state]``, the
        reference's server-process pattern (a blocking threshold read, then
        an update; ``riak_test/lasp_advertisement_counter_test.erl:197-235``)
        as a per-round predicate at every replica. ``fn`` is written for one
        replica's dense states and runs under ``torch.func.vmap`` over the
        replica axis, so it means what it means in the JAX package: no
        in-place writes into captured tensors and no ``.item()`` inside it.
        Each candidate lands through merge + the inflation gate, per
        replica (``src/lasp_core.erl:301-311``).

        ``touches`` lists every var_id the trigger reads or writes; in
        packed mode only the graph's and the triggers' variables are
        unpacked to dense views. ``None`` means "may touch anything" and
        unpacks every variable. ``builder`` (keyword-only, instead of
        ``fn``): a zero-argument callable returning the trigger fn, called
        once now."""
        if (fn is None) == (builder is None):
            raise ValueError("register_trigger takes exactly one of fn or builder")
        if builder is not None:
            fn = builder()
            if not callable(fn):
                raise TypeError(f"trigger builder returned {fn!r}, not a callable")
        self._triggers.append(
            (fn, frozenset(touches) if touches is not None else None, builder)
        )

    # -- mesh-level programs (L5 over L2, src/lasp_vnode.erl:276-366) ----------
    def _session(self):
        if self._program_session is None:
            from .programs import MeshSession

            self._program_session = MeshSession(self)
        return self._program_session

    def register(self, name: str, program_cls, *args, **kwargs) -> str:
        """Deploy a program over the replica population — ``lasp:register/4
        global`` (``src/lasp_register_global_fsm.erl:103-130``). ``init``
        declares the program's accumulator variable, which the runtime
        replicates over every row on its device (register on every
        partition). Idempotent, like the vnode's dets check
        (``src/lasp_vnode.erl:283-291``)."""
        if name in self._programs:
            return name
        program = program_cls(*args, **kwargs)
        program.init(self._session())
        self._programs[name] = program
        return name

    def process(self, object, reason, actor, replica: int = 0) -> None:
        """Targeted object-event delivery — ``lasp:process/4`` via the
        PROCESS_R=1 FSM (``src/lasp_process_fsm.erl:113-135``): every
        registered program's ``process`` runs against the ONE replica row
        named by ``replica``, whose local view it reads and writes; the
        write spreads to the population by gossip. Deliver all events for
        one logical key to the same row: remove-then-add programs (the 2i
        index) read their own earlier writes from the local row."""
        if not 0 <= replica < self.n_replicas:
            raise IndexError(
                f"replica {replica} out of range for {self.n_replicas}"
            )
        session = self._session()
        prev = session.replica
        session.replica = replica
        try:
            # snapshot: a program may register programs (create_views); a
            # view registered by this event first sees the NEXT event, like
            # the reference's async spawn
            for program in list(self._programs.values()):
                program.process(session, object, reason, actor)
        finally:
            session.replica = prev

    def execute(self, name: str, replicas=None):
        """Program result over the population. ``replicas=None`` is the
        ring-coverage execute: the program reads the GLOBAL join of its
        accumulator (``src/lasp_execute_coverage_fsm.erl:57-94``). A replica
        list is the preflist-quorum variant (``src/lasp_execute_fsm.erl:
        135-148``): the join of just those rows."""
        program = self._programs[name]
        session = self._session()
        # save/restore: a program's process callback may call execute
        # (consulting another program's result); the row binding must
        # survive for the rest of the delivery loop
        prev_replica, prev_quorum = session.replica, session.quorum
        session.replica, session.quorum = None, replicas
        try:
            return program.value(program.execute(session))
        finally:
            session.replica, session.quorum = prev_replica, prev_quorum

    @property
    def programs(self) -> dict:
        """Registered programs by name (a copy)."""
        return dict(self._programs)

    # -- not ported yet --------------------------------------------------------
    def shard(self, *args, **kwargs):
        _not_ported("shard")

    # -- the actor guard (debug_actors) ----------------------------------------
    #: the types whose ops mint per-actor lane events: the OR-SWOT (vclock
    #: dots; colliding counters read as observed-and-removed), the G-Counter
    #: (same-lane increments at two rows max-merge into lost counts) and the
    #: OR-Sets (counter-based tokens allocate row-locally per (elem, actor)
    #: pool: two rows minting under one actor reuse slots)
    _ACTOR_LANE_TYPES = frozenset({
        "riak_dt_orswot", "riak_dt_map", "riak_dt_gcounter",
        "lasp_orset", "lasp_orset_gbtree",
    })

    def _actor_guard_keys(self, var, actor, fresh_offset: int = 0) -> list:
        """Registry keys naming one physical actor lane. ``update_at`` and
        ``update_batch`` name actors by term, ``seed_increments`` by lane
        index; a term registers under its ``("lane", idx)`` alias too, and
        a lane index resolves back to its term. A term not yet interned
        will land at ``len(var.actors) + fresh_offset`` (the interner
        assigns slots in order; the offset counts the other fresh actors
        before it in the same batch)."""
        keys = [(var.id, actor)]
        if var.actors is None:
            return keys
        if isinstance(actor, tuple) and len(actor) == 2 and actor[0] == "lane":
            idx = actor[1]
            if idx < len(var.actors):
                keys.append((var.id, var.actors.terms()[idx]))
        elif actor in var.actors:
            keys.append((var.id, ("lane", var.actors.index_of(actor))))
        else:
            keys.append((var.id, ("lane", len(var.actors) + fresh_offset)))
        return keys

    def _guard_actor_check(self, var, replica: int, actor) -> list:
        """The guard's check half: raise at an actor's second write site;
        return the registry keys for :meth:`_guard_actor_commit`, which runs
        only once the write applied (a failed write registers no site)."""
        keys = self._actor_guard_keys(var, actor)
        for key in keys:
            prev = self._actor_sites.get(key)
            if prev is not None and prev != int(replica):
                if prev < 0:
                    raise ActorCollisionError(
                        f"actor {actor!r} departed with a crashed row "
                        f"(its {var.id!r} tokens may still circulate via "
                        "gossip) and may never mint again — use a fresh "
                        "actor name for the new incarnation (the riak_dt "
                        "never-reuse-an-actor rule)"
                    )
                raise ActorCollisionError(
                    f"actor {actor!r} already minted lane events for "
                    f"{var.id!r} at replica {prev}; writing from replica "
                    f"{int(replica)} would collide its per-actor lane "
                    "(vclock dots / counter lanes merge by max: silent "
                    "element loss or lost increments). Use one actor per "
                    "writing replica."
                )
        return keys

    def _guard_actor_commit(self, keys, replica: int) -> None:
        for key in keys:
            self._actor_sites.setdefault(key, int(replica))

    @staticmethod
    def _op_mints_lane(var, op: tuple) -> bool:
        """Does this client op mint per-actor lane events? Removes read
        lanes but mint nothing, so two-site removes are safe."""
        tn = var.type_name
        if tn == "riak_dt_gcounter":
            return op[0] == "increment"
        if tn in ("riak_dt_orswot", "lasp_orset", "lasp_orset_gbtree"):
            return op[0] in ("add", "add_all")
        if tn == "riak_dt_map":
            # a field update mints a presence dot on the map clock's lane
            return any(
                isinstance(s, tuple) and s and s[0] == "update"
                for s in map_subs(op)
            )
        return False

    # -- client operations ---------------------------------------------------
    def update_at(self, replica: int, var_id: str, op: tuple, actor) -> None:
        """Apply a store op at one replica row: the codec op + merge +
        inflation gate run directly on the row (``lasp_core:update`` then
        ``bind``, ``src/lasp_core.erl:283-312``); gossip carries it on.
        Under ``debug_actors`` a lane-minting op from a second replica of
        one actor raises :class:`ActorCollisionError`."""
        var = self.store.variable(var_id)
        if var.type_name == "riak_dt_map":
            # sync a late-declared map's population before any spec growth
            # (a grown spec with no population would leave the two apart)
            self._population(var_id)
            if self.store.admit_map_fields(var, op):
                # dynamic field admission grew the field axis: re-lay out
                # the population before reading this replica's row
                self._grow_map_population(var)
        guarded = (
            self.debug_actors
            and var.type_name in self._ACTOR_LANE_TYPES
            and self._op_mints_lane(var, op)
        )
        if guarded:
            self._guard_actor_check(var, replica, actor)
        pop = self._population(var_id)
        wire_row = tree_map(lambda x: x[replica], pop)
        row = self._to_dense_row(var_id, wire_row)
        candidate = self.store._apply_op(var, row, op, actor)
        merged = var.codec.merge(var.spec, row, candidate)
        if bool(var.codec.is_inflation(var.spec, row, merged)):
            new_row = self._from_dense_row(var_id, merged)
            for x, r in zip(tree_leaves(pop), tree_leaves(new_row)):
                x[replica] = r
            if guarded:
                # keys re-derived after the apply interned the actor (its
                # ("lane", idx) alias); a non-inflation mints nothing
                self._guard_actor_commit(self._actor_guard_keys(var, actor), replica)
            self._mark_dirty_rows(var_id, [replica])
        # a non-inflation is silently ignored (the bind rule); new terms
        # fold into the edge tables
        self.graph.refresh()

    def update_batch(self, var_id: str, ops) -> None:
        """Vectorized client writes: ``ops`` is an iterable of ``(replica,
        op_tuple, actor)``, applied with the sequential semantics of per-op
        :meth:`update_at`. One variable's :meth:`ingest_cycle`: under
        ``plan="auto"`` the batch becomes an op table and one group apply
        with exact dirty marks; under ``plan="off"`` it takes the
        per-variable arm and marks every row it touched. A mid-batch
        failure (capacity, exhausted pool, not_present) persists the op
        prefix before it and then raises."""
        self.ingest_cycle(((var_id, ops),))

    def apply_batch(self, var_id: str, fn) -> None:
        """Device-side batched update: ``fn(states[R, ...]) -> states``. The
        opaque ``fn`` may touch any row, so the variable's whole frontier
        goes dirty (pass rows to :meth:`mark_dirty` afterwards to tighten
        it)."""
        self.states[var_id] = fn(self.states[var_id])
        self.mark_dirty(var_id)

    @staticmethod
    def _normalize_ops(ops) -> list:
        """Materialize the op list once, rebuilding only the entries whose
        multi-term payload must be copied (``add_all`` / ``remove_all``: a
        one-shot iterator would reach the dispatch drained). Scalar ops
        keep their tuples, so a batch of them returns the input list
        itself."""
        ops = ops if isinstance(ops, list) else list(ops)
        out = None
        for i, item in enumerate(ops):
            op = item[1]
            if (
                isinstance(op, tuple)
                and len(op) > 1
                and op[0] in ("add_all", "remove_all")
            ):
                if out is None:
                    out = ops[:i]
                out.append((item[0], (op[0], list(op[1]), *op[2:]), item[2]))
            elif out is not None:
                out.append(item)
        return ops if out is None else out

    def _batch_begin(self, var_id: str, ops) -> "_PendingBatch | None":
        """The host phases of a batched write: normalize, check the rows,
        the capacity prefix, the actor guard's staging. Returns None for an
        empty batch; raises batch-level errors (``ActorCollisionError``)
        with nothing applied. Rows are taken as given, as JAX takes them: a
        negative row wraps, and a row outside the population reads as JAX's
        gathers read it and drops from every scatter, both settled on the
        host (``_gather_rows``, ``_keep_rows``, ``mesh.ingest``), so the
        card never sees it; the per-variable arm's dirty marking then
        raises ``IndexError`` for it, as JAX's does."""
        ops = self._normalize_ops(ops)
        var = self.store.variable(var_id)
        tn = var.type_name
        if tn == "riak_dt_map":
            # late-declare sync before admission (the update_at rule), then
            # pre-admit every first-touched key of the batch and re-lay out
            # the population once: admission is observably a no-op until its
            # update lands. The scan validates every op's keys before
            # anything mutates.
            self._population(var_id)
            plan = self.store.scan_map_admissions(var, (op for _r, op, _a in ops))
            if plan:
                self.store.grow_map_plan(var, plan)
                self._grow_map_population(var)
        states = self._population(var_id)
        if not ops:
            return None
        # the longest op prefix whose new terms / actors fit applies, then
        # the overflow raises; walked before the guard, so the guard judges
        # exactly the ops that can apply in this call
        n_fit, cap_err = self._capacity_prefix(var, tn, ops)
        if cap_err is not None:
            ops = ops[:n_fit]
        guard_actors = None
        if self.debug_actors and tn in self._ACTOR_LANE_TYPES:
            # checked before any mutation: a collision is a batch-level
            # error, all or nothing (nothing applied, registry unchanged)
            staged: dict = {}
            fresh: dict = {}  # actors not yet interned -> arrival order
            for r, op, actor in ops:
                if not self._op_mints_lane(var, op):
                    continue
                if var.actors is not None and actor not in var.actors:
                    fresh.setdefault(actor, len(fresh))
                off = fresh.get(actor, 0)
                for key in self._actor_guard_keys(var, actor, off):
                    prev = self._actor_sites.get(key, staged.get(key))
                    if prev is None:
                        staged[key] = int(r)
                    elif prev != int(r):
                        raise ActorCollisionError(
                            f"update_batch({var_id!r}): actor {actor!r} "
                            + ("departed with a crashed row and may "
                               "never mint again (use a fresh actor "
                               "name for the new incarnation)"
                               if prev < 0 else
                               f"mints lane events at replicas {prev} "
                               f"and {int(r)}")
                            + " — one actor per writing replica "
                            "(see debug_actors/_guard_actor_check)"
                        )
            # sites register at finalize, only for the ops that applied
            guard_actors = [
                (actor, int(r), k)
                for k, (r, op, actor) in enumerate(ops)
                if self._op_mints_lane(var, op)
            ]
        return _PendingBatch(var, var_id, tn, ops, states, cap_err, guard_actors)

    def ingest_cycle(self, ops_by_var, isolate_errors: bool = False) -> dict:
        """Apply one cycle of client writes across variables: ``ops_by_var``
        maps ``var_id -> [(replica, op, actor), ...]`` (a dict or an
        iterable of pairs; each variable's order is kept).

        Under ``plan="auto"`` every encodable variable's ops resolve into an
        op table (``mesh.ingest``) and each dispatch-plan group's tables
        land in one group apply, whose changed rows become exact dirty
        marks (the per-op ``update_at`` marks). ``plan="off"`` runs the
        per-variable arm, which marks every row a batch touched.

        Errors per variable are ``update_batch``'s: a mid-batch data failure
        persists the op prefix before it. With ``isolate_errors=False`` the
        first failing variable's error raises after every variable's
        bookkeeping landed; ``isolate_errors=True`` returns them in the
        report. Returns ``{"errors", "ops", "dispatches", "groups",
        "grouped_vars", "pad_slots", "table_slots", "fallback_vars"}``."""
        items = ops_by_var.items() if hasattr(ops_by_var, "items") else ops_by_var
        pendings: list = []
        errors: dict = {}
        seen: set = set()
        for var_id, ops in items:
            if var_id in seen:
                # a second batch of one variable would encode against the
                # population from before the first
                raise ValueError(
                    f"ingest_cycle: variable {var_id!r} appears twice "
                    "in one cycle (merge its op lists)"
                )
            seen.add(var_id)
            try:
                p = self._batch_begin(var_id, ops)
            except Exception as exc:
                if not isolate_errors:
                    raise
                errors[var_id] = exc
                continue
            if p is not None:
                pendings.append(p)
        # encode: each batch's op table, on the host
        tabled: list = []
        for p in pendings:
            if self.plan_mode != "auto":
                continue
            try:
                p.table, enc_err = ingest_mod.encode_batch(
                    self, p.var, p.tn, p.states, p.ops
                )
                if enc_err is not None:
                    p.err = enc_err
            except Exception as exc:
                # a malformed op: nothing applied; the terms interned so
                # far still fold into the edge tables at finalize
                p.err, p.table, p.encode_failed = exc, None, True
            except BaseException as exc:
                # an interrupt lands this batch's bookkeeping, then goes on
                p.err, p.table, p.encode_failed = exc, None, True
                self._batch_finalize(p)
                raise
            if p.table is not None:
                tabled.append(p)
        # the per-variable arm: plan="off", or a type with no op table
        for p in pendings:
            if p.table is not None or p.encode_failed:
                continue
            try:
                self._dispatch_batch(p.var, p.tn, p.states, p.ops)
            except Exception as exc:
                p.err = exc
            except BaseException as exc:
                p.err = exc
                self._batch_finalize(p)
                raise
        report = self._ingest_apply_groups(tabled)
        for p in pendings:
            self._batch_finalize(p)
            final = p.err if p.err is not None else p.cap_err
            if final is not None:
                errors[p.var_id] = final
        report["errors"] = errors
        report["ops"] = sum(len(p.ops) for p in pendings)
        report["fallback_vars"] = [
            p.var_id for p in pendings if p.table is None and not p.encode_failed
        ]
        if tabled or report["ops"]:
            self._observe_ingest(report)
        if errors and not isolate_errors:
            raise next(iter(errors.values()))
        return report

    def _observe_ingest(self, report: dict) -> None:
        """Fold the cycle's ingest accounting into the convergence
        observatory (``health()["ingest"]``): a dict update."""
        if self._instruments() is None:  # telemetry disabled
            return
        get_monitor().observe_ingest(
            ops=report["ops"],
            dispatches=report["dispatches"],
            grouped_vars=report["grouped_vars"],
            fallback_vars=len(report["fallback_vars"]),
            pad_slots=report.get("pad_slots", 0),
            table_slots=report.get("table_slots", 0),
        )

    def _ingest_apply_groups(self, tabled: list) -> dict:
        """Land the cycle's op tables: group them by the gossip plan's
        signature rule and land each group in one group apply
        (``mesh.ingest.apply_group``), whose per-member changed rows become
        the pendings' exact marks. A failing group fails its own batches
        (their marks stay None: superset marking) and not the cycle."""
        groups: dict = {}
        for p in tabled:
            if p.table.slots == 0:
                p.marks = ()  # nothing survived the trims: no apply, no marks
                continue
            key = (ingest_mod.group_key(self, p.var_id), p.table.kind)
            groups.setdefault(key, []).append(p)
        n_groups = slots = padded = 0
        for (_sig, kind), members in groups.items():
            tables = [p.table for p in members]
            t0 = time.perf_counter()
            try:
                changed = ingest_mod.apply_group(
                    kind, [self.states[p.var_id] for p in members], tables,
                    self.n_replicas,
                )
            except Exception as exc:
                for p in members:
                    p.err = exc
                continue
            for p, ch in zip(members, changed):
                p.marks = np.flatnonzero(ch)
            buckets, pad_slots = ingest_mod.table_buckets(tables)
            self._ledger_record_var(
                "ingest_apply", members[0].var_id, time.perf_counter() - t0,
                rows=max((b for _n, b in buckets), default=0),
                g_active=len(members),
            )
            n_groups += 1
            slots += sum(b for _n, b in buckets) * len(members)
            padded += pad_slots
        if n_groups:
            counter(
                "ingest_apply_dispatches_total",
                help="grouped ingest kernel dispatches (one per active "
                     "dispatch-plan group per cycle)",
            ).inc(n_groups)
            counter(
                "ingest_ops_total",
                help="client ops applied through the grouped ingest arm",
            ).inc(sum(p.table.n_ops for p in tabled))
            counter(
                "ingest_pad_slots_total",
                help="bucket-padding waste of stacked ingest tables "
                     "(pad scatter slots, dropped in-kernel)",
            ).inc(padded)
            gauge(
                "ingest_group_occupancy",
                help="variables served per grouped ingest dispatch in "
                     "the last cycle (mean)",
            ).set(round(len([p for p in tabled if p.table.slots]) / n_groups, 3))
        return {
            "dispatches": n_groups,
            "groups": n_groups,
            "grouped_vars": len(tabled),
            "pad_slots": padded,
            "table_slots": slots,
        }

    def _batch_finalize(self, p: "_PendingBatch") -> None:
        """The bookkeeping every batch owes, applied or failed: dirty marks
        (the group apply's exact rows, else every row the batch touched — a
        superset), the edge tables' refresh (a failed batch's persisted
        prefix interned terms too), the actor guard's site commits for the
        ops that applied."""
        counter(
            "update_batch_ops_total",
            help="client ops submitted through update_batch",
        ).inc(len(p.ops))
        # one coarse causal record per batch (the hot-path rule)
        tel_events.emit(
            "update", var=p.var_id, ops=len(p.ops), type=p.tn,
            failed=p.err is not None,
        )
        if p.marks is not None:
            if len(p.marks):
                self._mark_dirty_rows(p.var_id, p.marks)
        else:
            self._mark_dirty_rows(p.var_id, [r for r, _op, _a in p.ops])
        self.graph.refresh()
        if p.guard_actors is not None:
            # the batch paths stamp the failing op's index on the error:
            # ops at or after it minted nothing and commit nothing
            fail_idx = (
                getattr(p.err, "batch_index", len(p.ops))
                if p.err is not None else len(p.ops)
            )
            for actor, r, k in p.guard_actors:
                if k < fail_idx:
                    self._guard_actor_commit(self._actor_guard_keys(p.var, actor), r)

    @staticmethod
    def _capacity_prefix(var, tn, ops):
        """``(n_ops, err)``: the longest op prefix whose term/actor interning
        fits the declared universes, and the ``CapacityError`` the first
        overflowing op would raise (or None)."""
        walk_e = _CapacityWalk(var.elems)
        walk_a = _CapacityWalk(var.actors)
        for k, (_r, op, actor) in enumerate(ops):
            verb = op[0]
            err = None
            if tn == "riak_dt_gcounter":
                err = walk_a.take([actor])
            elif verb in ("add", "add_all"):
                terms = op[1] if verb == "add_all" else [op[1]]
                err = walk_e.take(terms)
                if err is None and tn != "lasp_gset":
                    err = walk_a.take([actor])
            if err is not None:
                return k, err
        return len(ops), None

    #: map field types the vectorized map batch embeds: the batch bodies
    #: the per-variable arm runs, applied to the field's embedded population
    _MAP_FIELD_BATCH = {
        "riak_dt_gcounter": "_gcounter_batch",
        "lasp_gset": "_gset_batch",
        "lasp_ivar": "_ivar_batch",
    }

    def _dispatch_batch(self, var, tn, states, ops) -> None:
        if tn == "riak_dt_gcounter":
            self._gcounter_batch(var, states, ops)
        elif tn == "lasp_gset":
            self._gset_batch(var, states, ops)
        elif tn in _PACKABLE:
            self._orset_batch(var, ops)
        elif tn == "riak_dt_orswot":
            self._orswot_batch(var, ops)
        elif tn == "lasp_ivar":
            self._ivar_batch(var, states, ops)
        elif tn == "riak_dt_map" and all(
            fcodec.name in self._MAP_FIELD_BATCH
            for _k, fcodec, _s in var.spec.fields
        ) and not self._map_reset_remove_batch(var, ops):
            self._map_batch(var, states, ops)
        elif tn == "riak_dt_map":
            # maps embedding a field type with no batch body (OR-Set,
            # OR-SWOT, a submap), or reset-mode batches holding a remove
            # (epoch bumps and bottom-resets interleave with inner ops in
            # ways the two-pass batch cannot express): per-op update_at,
            # exact sequential semantics at one dispatch per op, loudly
            warnings.warn(
                f"update_batch({tn!r}): no vectorized kernel for this "
                f"shape; applying {len(ops)} ops via per-op update_at "
                "(one dispatch per op — fine for control-plane writes, "
                "not for population-scale seeding)",
                stacklevel=3,
            )
            for r, op, actor in ops:
                self.update_at(r, var.id, op, actor)
        else:
            raise ValueError(f"update_batch: unsupported type {tn!r}")

    @staticmethod
    def _map_reset_remove_batch(var, ops) -> bool:
        """True iff the map is in reset mode and the batch holds a field
        remove (what the two-pass map batch cannot express)."""
        if not var.spec.reset_on_readd:
            return False
        for _r, op, _actor in ops:
            for sub in map_subs(op):
                if isinstance(sub, tuple) and sub and sub[0] == "remove":
                    return True
        return False

    def _grow_map_population(self, var) -> None:
        """Re-lay out a map's population after field admission: bottom
        planes for the new fields. The member's leaf shapes changed, so the
        dispatch plan regroups (the port compiles no step to drop)."""
        self.states[var.id] = CrdtMap.grow(var.spec, self.states[var.id])
        self._invalidate_plan("map_growth")

    def _map_batch(self, var, states, ops) -> None:
        """Vectorized ``riak_dt_map`` batch with sequential, per-op-atomic
        semantics: presence dots are simulated on the host over the touched
        rows only (one gather), embedded field ops land through the batch
        bodies of their types (:attr:`_MAP_FIELD_BATCH`) on the field's
        embedded population, and the presence planes land in one scatter
        each, in place, one write per row.

        Op shapes: ``("update", Key, InnerOp)``, ``("remove", Key)`` and
        the batched ``("update", [SubOps])``, whose sub-ops apply
        atomically. A failing op (an absent remove: ``PreconditionError``;
        interner overflow: ``CapacityError``) applies nothing of itself (an
        undo log rewinds its partial presence writes) while every op before
        it persists, then the error raises: the per-op ``update_at`` loop's
        state, for data-dependent failures. Malformed shapes (unknown
        verbs, unknown field names, non-positive increments) raise up front
        with nothing applied."""
        spec = var.spec
        # pass 0: flatten and validate shapes (nothing applied yet)
        flat = []  # (op_index, replica, ("update", f, inner) | ("remove", f, key), actor)
        for k, (r, op, actor) in enumerate(ops):
            for sub in map_subs(op):
                if sub[0] == "update" and len(sub) == 3:
                    f = spec.field_index(sub[1])  # KeyError: unknown field
                    inner = sub[2]
                    if not isinstance(inner, tuple):
                        raise ValueError(f"update_batch: unsupported op {inner!r}")
                    _key, fcodec, _fspec = spec.fields[f]
                    if fcodec.name == "riak_dt_gcounter":
                        if inner[0] != "increment":
                            raise ValueError(
                                f"update_batch: unsupported op {inner!r}"
                            )
                        if len(inner) > 1 and inner[1] < 1:
                            raise ValueError(
                                "update_batch: G-Counter increment must "
                                f"be >= 1, got {inner[1]!r}"
                            )
                    elif fcodec.name == "lasp_gset":
                        if inner[0] not in ("add", "add_all"):
                            raise ValueError(
                                f"update_batch: unsupported op {inner!r}"
                            )
                        if inner[0] == "add_all":
                            # materialised once: the capacity walk and the
                            # field body both iterate it
                            inner = ("add_all", list(inner[1]))
                    elif inner[0] != "set":
                        raise ValueError(f"update_batch: unsupported op {inner!r}")
                    flat.append((k, r, ("update", f, inner), actor))
                elif sub[0] == "remove" and len(sub) == 2:
                    try:
                        f = spec.field_index(sub[1])
                    except KeyError:
                        # a never-admitted field is absent: not_present at
                        # this op's position (pass 1)
                        f = -1
                    flat.append((k, r, ("remove", f, sub[1]), actor))
                else:
                    raise ValueError(f"update_batch: unsupported map op {sub!r}")
        if not flat:
            return
        # one gather of the touched rows' presence planes; the sorted set of
        # rows is what de-duplicates the scatters below
        tr = np.asarray(sorted({r for _k, r, _s, _a in flat}), dtype=np.int64)
        row_of = {int(r): i for i, r in enumerate(tr)}
        at = self._gather_rows(tr)
        local_clock = states.clock[at].cpu().numpy().copy()  # [T, A]
        local_dots = states.dots[at].cpu().numpy().copy()  # [T, F, A]
        # pass 1: the sequential walk. Capacity is checked per op against
        # free counters; presence checks see the simulated state at the op's
        # own position
        err = None
        inner_ops: dict = {}  # field -> [(r, inner, actor)]
        walk_a = _CapacityWalk(var.actors)
        walk_e = {f: _CapacityWalk(shim.elems) for f, shim in enumerate(var.map_aux)}
        for _k, giter in itertools.groupby(flat, key=lambda x: x[0]):
            group = list(giter)
            undo: list = []
            inner_mark = {f: len(v) for f, v in inner_ops.items()}
            for _k, r, sub, actor in group:
                t = row_of[int(r)]
                if sub[0] == "remove":
                    f = sub[1]
                    if f < 0 or not (local_dots[t, f] > 0).any():
                        err = PreconditionError(f"not_present: {sub[2]!r}")
                        break
                    undo.append((t, f, local_dots[t, f].copy(), None, None))
                    local_dots[t, f] = 0
                    continue
                _u, f, inner = sub
                if inner[0] in ("add", "add_all"):
                    terms = inner[1] if inner[0] == "add_all" else [inner[1]]
                    err = walk_e[f].take(terms)
                    if err is not None:
                        break
                err = walk_a.take([actor])
                if err is not None:
                    break
                a = var.actors.intern(actor)
                undo.append((t, f, local_dots[t, f].copy(), a, local_clock[t, a]))
                local_clock[t, a] += 1
                # the mint replaces the field's dot row with the fresh single
                # dot (lattice/dots.py mint_dot, the riak_dt touch)
                local_dots[t, f] = 0
                local_dots[t, f, a] = local_clock[t, a]
                inner_ops.setdefault(f, []).append((r, inner, actor))
            if err is not None:
                err.batch_index = _k  # this op and every later one: unapplied
                # rewind this op's partial presence writes and inner appends
                for t, f, dots_old, a, clock_old in reversed(undo):
                    local_dots[t, f] = dots_old
                    if a is not None:
                        local_clock[t, a] = clock_old
                for f, mark in inner_mark.items():
                    del inner_ops[f][mark:]
                for f in list(inner_ops):
                    if f not in inner_mark:
                        del inner_ops[f]
                break
        # pass 2: each touched field's ops through its type's batch body,
        # into the field's embedded population; then the presence planes
        for f, fops in inner_ops.items():
            if not fops:
                continue
            _key, fcodec, _fspec = spec.fields[f]
            body = getattr(self, self._MAP_FIELD_BATCH[fcodec.name])
            body(var.map_aux[f], states.fields[f], fops)
        rows, keep = self._keep_rows(tr)
        if keep.any():
            # a wrapped negative row can meet its positive twin: the later
            # entry (sorted order, the scatter's last write) wins alone
            pos = np.flatnonzero(keep)
            _u, last = np.unique(rows[pos][::-1], return_index=True)
            pos = pos[::-1][last]
            idx = self._index(rows[pos])
            states.clock[idx] = torch.as_tensor(local_clock[pos], device=self.device)
            states.dots[idx] = torch.as_tensor(local_dots[pos], device=self.device)
        if err is not None:
            raise err  # the earlier ops landed in place

    def _index(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, dtype=np.int64), device=self.device)

    def _gather_rows(self, rows) -> torch.Tensor:
        """Replica rows for a gather, by JAX's plain-indexing rule: a
        negative row wraps once, then every row clamps into the
        population (what the per-variable arm's ``x[rows]`` reads)."""
        idx = np.asarray(rows, dtype=np.int64)
        idx = np.where(idx < 0, idx + self.n_replicas, idx)
        return self._index(np.clip(idx, 0, self.n_replicas - 1))

    def _keep_rows(self, rows) -> tuple:
        """``(rows, keep)`` for a scatter, by JAX's rule: a negative row
        wraps once, a row still outside the population drops (``keep`` is
        the host mask of the entries that land)."""
        return ingest_mod.wrap_index(
            np.asarray(rows, dtype=np.int64), self.n_replicas
        )

    # The batch bodies of the leafwise types write only into the ``states``
    # they are given: a variable's population, or (from ``_map_batch``) a
    # map field's embedded population.

    def _gcounter_batch(self, var, states, ops) -> None:
        rows, lanes, by = [], [], []
        for r, op, actor in ops:
            if op[0] != "increment":
                raise ValueError(f"update_batch: unsupported op {op!r}")
            amount = op[1] if len(op) > 1 else 1
            if amount < 1:
                raise ValueError(
                    f"update_batch: G-Counter increment must be >= 1, "
                    f"got {amount!r}"
                )
            rows.append(r)
            lanes.append(var.actors.intern(actor))
            by.append(amount)
        rows, keep = self._keep_rows(rows)
        states.counts.index_put_(
            (self._index(rows[keep]), self._index(np.asarray(lanes)[keep])),
            torch.as_tensor(np.asarray(by)[keep], device=self.device)
            .to(states.counts.dtype),
            accumulate=True,
        )

    def _gset_batch(self, var, states, ops) -> None:
        rows, elems = [], []
        for r, op, _actor in ops:
            if op[0] == "add":
                rows.append(r)
                elems.append(var.elems.intern(op[1]))
            elif op[0] == "add_all":
                for e in op[1]:
                    rows.append(r)
                    elems.append(var.elems.intern(e))
            else:
                raise ValueError(f"update_batch: unsupported op {op!r}")
        rows, keep = self._keep_rows(rows)
        if keep.any():
            states.mask[self._index(rows[keep]), self._index(np.asarray(elems)[keep])] = True

    def _ivar_batch(self, var, states, ops) -> None:
        rows, payloads = [], []
        for r, op, _actor in ops:
            if op[0] != "set":
                raise ValueError(f"update_batch: unsupported op {op!r}")
            rows.append(r)
            payloads.append(var.ivar_payloads.intern(op[1]))
        rows = np.asarray(rows, dtype=np.int64)
        payloads = np.asarray(payloads, dtype=np.int64)
        # sequential semantics: per row the FIRST set wins, and an
        # already-defined row keeps its value (single assignment)
        _, first = np.unique(rows, return_index=True)
        rows, payloads = rows[first], payloads[first]
        open_rows = ~states.defined[self._gather_rows(rows)].cpu().numpy()
        rows, payloads = rows[open_rows], payloads[open_rows]
        rows, keep = self._keep_rows(rows)
        rows, payloads = rows[keep], payloads[keep]
        idx = self._index(rows)
        states.defined[idx] = True
        states.value[idx] = torch.as_tensor(
            payloads, dtype=states.value.dtype, device=self.device
        )

    def _orset_batch(self, var, ops) -> None:
        """Batched OR-Set adds/removes with sequential semantics: ops group
        into consecutive add/remove phases, each landing as one scatter;
        token slots allocate as the scalar ``add`` does (first free slot of
        the actor's pool) from the affected rows' pools gathered to the
        host. On a mid-batch failure every op before the failing one
        persists, the failing op applies nothing, and the error raises."""
        k = var.spec.tokens_per_actor
        phases: list[tuple[str, list]] = []
        for opk, (r, op, actor) in enumerate(ops):
            verb = op[0]
            if verb in ("add", "add_all"):
                kind = "add"
                a = var.actors.intern(actor)
                terms = op[1] if verb == "add_all" else [op[1]]
                items = [(r, var.elems.intern(e), a * k, e, opk) for e in terms]
            elif verb in ("remove", "remove_all"):
                kind = "remove"
                terms = op[1] if verb == "remove_all" else [op[1]]
                # an unknown term is not_present AT ITS POSITION: index -1
                items = [
                    (r, var.elems.index_of(e) if e in var.elems else -1, e, opk)
                    for e in terms
                ]
            else:
                raise ValueError(f"update_batch: unsupported op {op!r}")
            if phases and phases[-1][0] == kind:
                phases[-1][1].extend(items)
            else:
                phases.append((kind, items))
        if var.id in self._packed_specs:
            self._orset_batch_packed(var, phases)
            return
        states = self.states[var.id]
        exists, removed = states.exists, states.removed
        for kind, items in phases:
            rows = np.asarray([it[0] for it in items], dtype=np.int64)
            elems = np.asarray([it[1] for it in items], dtype=np.int64)
            if kind == "add":
                bases = np.asarray([it[2] for it in items], dtype=np.int64)
                pool_idx = bases[:, None] + np.arange(k)[None, :]
                gathered = exists[
                    self._gather_rows(rows)[:, None], self._index(elems)[:, None],
                    self._index(pool_idx),
                ].cpu().numpy()
                allocs, err = self._alloc_pool_slots(var.id, items, gathered, k)
                allocs = allocs[: self._atomic_prefix(items, len(allocs), err)]
                a_rows, keep = self._keep_rows([items[i][0] for i, _ in allocs])
                if keep.any():
                    a_elems = np.asarray([items[i][1] for i, _ in allocs])
                    a_slots = np.asarray([items[i][2] + s for i, s in allocs])
                    idx = (
                        self._index(a_rows[keep]),
                        self._index(a_elems[keep]),
                        self._index(a_slots[keep]),
                    )
                    exists[idx] = True
                    removed[idx] = False
            else:
                valid = elems >= 0
                safe = np.where(valid, elems, 0)
                r_t, e_t = self._gather_rows(rows), self._index(safe)
                live = (exists[r_t, e_t] & ~removed[r_t, e_t]).any(dim=-1)
                live = live.cpu().numpy() & valid
                n_ok, err = self._check_removes(items, live)
                ok = self._atomic_prefix(items, n_ok, err)
                ok_r, keep = self._keep_rows(rows[:ok])
                if keep.any():
                    ok_r = self._index(ok_r[keep])
                    ok_e = self._index(safe[:ok][keep])
                    removed[ok_r, ok_e] = removed[ok_r, ok_e] | exists[ok_r, ok_e]
            if err is not None:
                raise err  # earlier ops already landed in place

    @staticmethod
    def _atomic_prefix(items, n_ok: int, err) -> int:
        """Shrink a validated item prefix to whole ops: when item ``n_ok``
        fails, its own op's earlier items are discarded too."""
        if err is None:
            return n_ok
        fail_op = items[n_ok][-1]
        err.batch_index = fail_op
        while n_ok and items[n_ok - 1][-1] == fail_op:
            n_ok -= 1
        return n_ok

    @staticmethod
    def _alloc_pool_slots(var_id: str, items, pools: np.ndarray, k: int):
        """First-free-slot allocation over gathered ``[B, k]`` pool
        occupancy (per-add rescan; a (row, elem, actor) pool's occupancy
        evolves within the batch). Returns ``(allocs, err)``."""
        pool_state: dict[tuple, np.ndarray] = {}
        allocs: list[tuple[int, int]] = []
        for i, item in enumerate(items):
            r, e, base, term = item[:4]
            key = (int(r), int(e), int(base))
            pool = pool_state.setdefault(key, pools[i].copy())
            free = np.flatnonzero(~pool)
            if len(free) == 0:
                return allocs, CapacityError(
                    f"{var_id}: token pool exhausted for {term!r} at replica "
                    f"{key[0]} (tokens_per_actor={k}); raise tokens_per_actor"
                )
            slot = int(free[0])
            pool[slot] = True
            allocs.append((i, slot))
        return allocs, None

    @staticmethod
    def _check_removes(items, live: np.ndarray):
        """Sequential remove validation: ``(n_ok, err)``; a duplicate (row,
        elem) in one phase fails at its position."""
        seen: set[tuple[int, int]] = set()
        for i, item in enumerate(items):
            r, e, term = item[:3]
            key = (int(r), int(e))
            if key in seen or not live[i]:
                return i, PreconditionError(f"not_present: {term!r}")
            seen.add(key)
        return len(items), None

    def _orswot_batch(self, var, ops) -> None:
        """Batched OR-SWOT adds/removes with sequential, per-op-atomic
        semantics: ``add`` bumps the (replica, actor) clock and replaces the
        element's dots with the fresh single dot; ``remove`` requires
        presence (not_present otherwise). A failing op applies nothing of
        itself, every op before it persists. A term-level precheck walks the
        ops first, before any interning (so a failing batch leaves the
        interners as the per-op loop would); the surviving prefix is then
        simulated on a host overlay of only the touched entries and lands in
        O(batch) device scatters, in place."""
        fail_op, err = self._orswot_precheck(var, ops)
        if err is not None:
            err.batch_index = fail_op  # ops[fail_op:] never applied
            ops = ops[:fail_op]
        if not ops:
            if err is not None:
                raise err
            return
        # flat (kind, replica, elem_idx, actor_idx) items: every op of the
        # prefix is known to succeed
        flat: list[tuple] = []
        for r, op, actor in ops:
            verb = op[0]
            if verb in ("add", "add_all"):
                a = var.actors.intern(actor)
                terms = op[1] if verb == "add_all" else [op[1]]
                flat.extend(("add", int(r), var.elems.intern(e), a) for e in terms)
            else:
                terms = op[1] if verb == "remove_all" else [op[1]]
                flat.extend(
                    ("remove", int(r), var.elems.index_of(e), -1) for e in terms
                )
        if flat:  # an add_all / remove_all of no terms touches nothing
            self._orswot_apply(var.id, flat)
        if err is not None:
            raise err

    def _orswot_apply(self, var_id: str, flat) -> None:
        """Land validated ``(kind, replica, elem, actor)`` items: gather the
        touched dots rows and clock lanes once, replay the items in order on
        the host, scatter the results back in place."""
        states = self.states[var_id]
        pairs = sorted({(r, e) for _k, r, e, _a in flat})
        actors = sorted({(r, a) for _k, r, _e, a in flat if a >= 0})
        pe = np.asarray([p[1] for p in pairs], dtype=np.int64)
        ca = np.asarray([a[1] for a in actors], dtype=np.int64)
        dot_rows = dict(zip(pairs, states.dots[
            self._gather_rows([p[0] for p in pairs]), self._index(pe)
        ].cpu().numpy().copy()))
        clocks = dict(zip(actors, states.clock[
            self._gather_rows([a[0] for a in actors]), self._index(ca)
        ].cpu().numpy().tolist()))
        for kind, r, e, a in flat:
            if kind == "add":
                clocks[(r, a)] += 1
                row = np.zeros_like(dot_rows[(r, e)])
                row[a] = clocks[(r, a)]
                dot_rows[(r, e)] = row
            else:
                dot_rows[(r, e)][:] = 0
        pr, keep = self._keep_rows([p[0] for p in pairs])
        if keep.any():
            states.dots[self._index(pr[keep]), self._index(pe[keep])] = torch.as_tensor(
                np.stack([dot_rows[p] for p in pairs])[keep], device=self.device
            )
        cr, keep = self._keep_rows([a[0] for a in actors])
        if keep.any():
            states.clock[self._index(cr[keep]), self._index(ca[keep])] = torch.as_tensor(
                np.asarray([clocks[a] for a in actors], dtype=np.int32)[keep],
                device=self.device,
            )

    def _orswot_precheck(self, var, ops):
        """``(fail_op, err)``: walk the ops at term level (no interning, no
        state change) tracking element presence, and report the first op
        whose remove would fail not_present. Initial presence of known terms
        comes from one gather; unknown terms are absent by definition."""
        states = self.states[var.id]
        probe: list[tuple] = []
        for r, op, _actor in ops:
            if op[0] in ("remove", "remove_all"):
                terms = op[1] if op[0] == "remove_all" else [op[1]]
                probe.extend((int(r), t) for t in terms if t in var.elems)
        probe = sorted(set(probe), key=lambda p: (p[0], repr(p[1])))
        live: dict = {}
        if probe:
            rs = np.asarray([p[0] for p in probe], dtype=np.int64)
            es = np.asarray([var.elems.index_of(p[1]) for p in probe], dtype=np.int64)
            present = (ingest_mod.take_pairs(states.dots, rs, es) > 0).any(axis=-1)
            live = {p: bool(v) for p, v in zip(probe, present)}
        for k, (r, op, _actor) in enumerate(ops):
            verb = op[0]
            if verb in ("add", "add_all"):
                for t in op[1] if verb == "add_all" else [op[1]]:
                    live[(int(r), t)] = True
            elif verb in ("remove", "remove_all"):
                for t in op[1] if verb == "remove_all" else [op[1]]:
                    if not live.get((int(r), t), False):
                        return k, PreconditionError(f"not_present: {t!r}")
                    live[(int(r), t)] = False
            else:
                raise ValueError(f"update_batch: unsupported op {op!r}")
        return len(ops), None

    def _elem_word_masks(self, var_id: str) -> np.ndarray:
        """uint32[E, W]: per-element word masks of the flat bit layout."""
        if var_id not in self._elem_masks:
            pspec = self._packed_specs[var_id]
            d = pspec.dense
            masks = np.zeros((d.n_elems, pspec.n_words), dtype=np.uint32)
            b = np.arange(pspec.n_bits, dtype=np.int64)
            np.bitwise_or.at(
                masks, (b // d.n_tokens, b // 32),
                (np.uint32(1) << (b % 32).astype(np.uint32)),
            )
            self._elem_masks[var_id] = masks
        return self._elem_masks[var_id]

    def _words(self, values: np.ndarray) -> torch.Tensor:
        """uint32 host words -> the int32 device words holding their bits."""
        return torch.as_tensor(
            np.ascontiguousarray(values, dtype=np.uint32).view(np.int32),
            device=self.device,
        )

    def _orset_batch_packed(self, var, phases) -> None:
        """Packed-mode twin of the dense phase application (same helpers,
        same persist-then-raise), on the flat bit-packed words."""
        pspec = self._packed_specs[var.id]
        d = pspec.dense
        k = d.tokens_per_actor
        elem_masks = self._elem_word_masks(var.id)
        states = self.states[var.id]
        exists, removed = states.exists, states.removed
        for kind, items in phases:
            rows = np.asarray([it[0] for it in items], dtype=np.int64)
            if kind == "add":
                elems = np.asarray([it[1] for it in items], dtype=np.int64)
                bases = np.asarray([it[2] for it in items], dtype=np.int64)
                bits = elems[:, None] * d.n_tokens + bases[:, None] + np.arange(k)
                words, shifts = bits // 32, bits % 32
                gathered = exists[
                    self._gather_rows(rows)[:, None], self._index(words)
                ].cpu().numpy().view(np.uint32)
                pools = ((gathered >> shifts.astype(np.uint32)) & 1).astype(bool)
                allocs, err = self._alloc_pool_slots(var.id, items, pools, k)
                allocs = allocs[: self._atomic_prefix(items, len(allocs), err)]
                # (row, word) -> mask of freshly minted bits, pre-combined
                set_masks: dict[tuple[int, int], int] = {}
                for i, slot in allocs:
                    b = int(bits[i, slot])
                    wkey = (int(items[i][0]), b // 32)
                    set_masks[wkey] = set_masks.get(wkey, 0) | (1 << (b % 32))
                rws, keep = self._keep_rows([w[0] for w in set_masks])
                if keep.any():
                    rws = self._index(rws[keep])
                    wds = self._index(np.asarray([w[1] for w in set_masks])[keep])
                    msk = self._words(np.asarray(list(set_masks.values()),
                                                 dtype=np.uint32)[keep])
                    exists[rws, wds] = exists[rws, wds] | msk
                    removed[rws, wds] = removed[rws, wds] & ~msk
            else:
                elems = np.asarray([it[1] for it in items], dtype=np.int64)
                valid = elems >= 0
                safe = np.where(valid, elems, 0)
                r_t = self._gather_rows(rows)
                ex_rows = exists[r_t].cpu().numpy().view(np.uint32)
                rm_rows = removed[r_t].cpu().numpy().view(np.uint32)
                live = ((ex_rows & ~rm_rows) & elem_masks[safe]).any(axis=-1)
                live = live & valid
                n_ok, err = self._check_removes(items, live)
                ok = self._atomic_prefix(items, n_ok, err)
                per_row: dict[int, np.ndarray] = {}
                for r, e, _term, _opk in items[:ok]:
                    m = per_row.setdefault(
                        int(r), np.zeros(pspec.n_words, np.uint32)
                    )
                    m |= elem_masks[int(e)]
                urows, keep = self._keep_rows(list(per_row))
                if keep.any():
                    urows = self._index(urows[keep])
                    umasks = self._words(np.stack(list(per_row.values()))[keep])
                    removed[urows] = removed[urows] | (exists[urows] & umasks)
            if err is not None:
                raise err  # earlier ops already landed in place

    def intern_terms(self, var_id: str, terms) -> np.ndarray:
        """Intern terms into the variable's element universe; their dense
        indices drive device-side scatters."""
        var = self.store.variable(var_id)
        out = np.asarray([var.elems.intern(t) for t in terms], dtype=np.int32)
        self.graph.refresh()
        return out

    def intern_actors(self, var_id: str, actors) -> np.ndarray:
        var = self.store.variable(var_id)
        return np.asarray([var.actors.intern(a) for a in actors], dtype=np.int32)

    def seed_tokens(self, var_id: str, rows, elems, tokens) -> None:
        """Device-side bulk add: token ``tokens[i]`` of element ``elems[i]``
        live at replica ``rows[i]`` in one scatter (reference op
        ``src/lasp_orset.erl:101-102``). Indices follow JAX's scatter:
        negative ones wrap, out-of-range ones drop (filtered before the
        scatter, so the card only sees valid indices); a row outside the
        population then raises ``IndexError`` from the dirty marking, after
        the rest landed. In packed mode duplicate triples are dropped on the
        host first: the add-scatter that stands in for a scatter-OR would
        carry a duplicate into an unrelated bit."""
        states = self._population(var_id)
        rows_np = np.asarray(rows, dtype=np.int64).ravel()
        elems_np = np.asarray(elems, dtype=np.int64).ravel()
        tokens_np = np.asarray(tokens, dtype=np.int64).ravel()
        if var_id in self._packed_specs:
            d = self.store.variable(var_id).spec
            flat = (rows_np * d.n_elems + elems_np) * d.n_tokens + tokens_np
            uniq, first = np.unique(flat, return_index=True)
            if len(uniq) != len(flat):
                first.sort()
                rows_np, elems_np, tokens_np = (
                    rows_np[first], elems_np[first], tokens_np[first]
                )
            self.states[var_id] = FlatORSet.scatter_tokens(
                self._packed_specs[var_id], states, rows_np, elems_np, tokens_np,
            )
        else:
            r_cap, e_cap, t_cap = states.exists.shape
            r, r_ok = ingest_mod.wrap_index(rows_np, r_cap)
            e, e_ok = ingest_mod.wrap_index(elems_np, e_cap)
            t, t_ok = ingest_mod.wrap_index(tokens_np, t_cap)
            ok = r_ok & e_ok & t_ok
            idx = (self._index(r[ok]), self._index(e[ok]), self._index(t[ok]))
            states.exists[idx] = True
            states.removed[idx] = False
        self._mark_dirty_rows(var_id, rows_np)

    def seed_increments(self, var_id: str, rows, lanes, by=1) -> None:
        """Device-side bulk G-Counter increments at ``(rows[i], lanes[i])``
        — the population-scale client-view writes of the ad-counter configs
        (``riak_test/lasp_adcounter_test.erl:57-120`` client loop).
        Duplicate ``(row, lane)`` pairs accumulate. Indices follow JAX's
        scatter: negative rows and lanes wrap, an add at an out-of-range
        lane drops (its row is still marked dirty), and a row outside the
        population raises ``IndexError`` from the dirty marking after the
        rest of the call landed. Under ``debug_actors`` a lane written from
        two rows raises :class:`ActorCollisionError` with nothing
        applied."""
        states = self._population(var_id)
        staged = None
        if self.debug_actors:
            # the lane index is the actor identity on this surface; its
            # ("lane", idx) spelling aliases the interned term, so term
            # writes collide with it too. Staged: all checked, then applied
            var = self.store.variable(var_id)
            staged = {}
            for lane, row in zip(np.asarray(lanes).ravel().tolist(),
                                 np.asarray(rows).ravel().tolist()):
                for key in self._actor_guard_keys(var, ("lane", int(lane))):
                    prev = self._actor_sites.get(key, staged.get(key))
                    if prev is None:
                        staged[key] = int(row)
                    elif prev != int(row):
                        raise ActorCollisionError(
                            f"seed_increments({var_id!r}): lane {lane} "
                            f"written from replicas {prev} and {int(row)}"
                            " — one actor lane, one writing replica"
                        )
        rows_np = np.asarray(rows, dtype=np.int64).ravel()
        lanes_np = np.asarray(lanes, dtype=np.int64).ravel()
        by_np = np.broadcast_to(np.asarray(by), np.shape(rows)).ravel()
        r_cap, l_cap = states.counts.shape
        r, r_ok = ingest_mod.wrap_index(rows_np, r_cap)
        lane, l_ok = ingest_mod.wrap_index(lanes_np, l_cap)
        ok = r_ok & l_ok
        states.counts.index_put_(
            (self._index(r[ok]), self._index(lane[ok])),
            torch.as_tensor(by_np[ok], device=self.device).to(states.counts.dtype),
            accumulate=True,
        )
        self._mark_dirty_rows(var_id, rows_np)
        if staged:
            # registered after the write: a shape error above leaves no
            # site for rows that were never written
            self._actor_sites.update(staged)

    # -- per-step telemetry (the registry, the monitor, the event log, the
    # kernel cost ledger and the flight ring) ----------------------------------
    def _instruments(self) -> "dict | None":
        """Hot-path instrument cache (None when telemetry is disabled): the
        name + label registry lookups are resolved once, keyed on the
        registry generation (``telemetry.reset()`` detaches them), the var
        set and the edge-kind census."""
        if not tel_registry.enabled():
            return None
        gen = tel_registry.generation()
        kinds = tuple(e.kind for e in self.graph.edges)
        cache = self._tel_cache
        if (cache is not None and cache[0] == gen and cache[1] == self.var_ids
                and cache[2] == kinds):
            return cache[3]
        reg = tel_registry.get_registry()
        by_kind: dict = {}
        for k in kinds:
            by_kind[k] = by_kind.get(k, 0) + 1
        inst = {
            "rounds": reg.counter(
                "gossip_rounds_total", help="gossip rounds executed"
            ),
            "bytes": reg.counter(
                "gossip_bytes_exchanged_total",
                help="estimated bytes moved by gossip gathers (see "
                     "gossip.round_traffic_bytes)",
            ),
            "round_seconds": reg.histogram(
                "gossip_round_seconds",
                help="wall time per unfused gossip round",
            ),
            "residual": [
                reg.gauge(
                    "gossip_residual",
                    help="replicas whose state the last round changed, "
                         "per var",
                    var=v,
                )
                for v in self.var_ids
            ],
            "frontier_rows": [
                reg.gauge(
                    "gossip_frontier_rows",
                    help="dirty-replica frontier size after the last "
                         "frontier round, per var",
                    var=v,
                )
                for v in self.var_ids
            ],
            "frontier_last": [None] * len(self.var_ids),
            "residual_last": [None] * len(self.var_ids),
            "frontier_rounds": reg.counter(
                "gossip_frontier_rounds_total",
                help="frontier-scheduled gossip rounds executed",
            ),
            "plan_vars_per_dispatch": reg.gauge(
                "gossip_plan_vars_per_dispatch",
                help="mean variables served per stacked dispatch under "
                     "the current plan (refreshed per planned frontier "
                     "round)",
            ),
            # each step re-evaluates every edge's contribution once per
            # round: (counter, edges of the kind)
            "edge_recomputes": [
                (
                    reg.counter(
                        "dataflow_edge_recomputes_total",
                        help="edge contribution evaluations, by "
                             "combinator kind",
                        kind=k,
                    ),
                    cnt,
                )
                for k, cnt in by_kind.items()
            ],
        }
        self._tel_cache = (gen, self.var_ids, kinds, inst)
        return inst

    def _record_rounds(self, n: int) -> None:
        """Registry bookkeeping for ``n`` executed gossip rounds — the one
        emission point of every dense stepping entry."""
        tel = self._instruments()
        if tel is None:
            return
        tel["rounds"].inc(n)
        tel["bytes"].inc(self._round_traffic * n)
        for c, edges_of_kind in tel["edge_recomputes"]:
            c.inc(n * edges_of_kind)

    def _ledger_fanout(self) -> int:
        """The per-replica neighbour fanout: the one definition behind the
        ledger's signatures and the bytes counter."""
        return (
            int(self._host_neighbors.shape[1])
            if self._host_neighbors.ndim == 2 else 0
        )

    def _ledger_record_var(self, family: str, var_id: str, seconds: float,
                           rows: "int | None" = None,
                           g_active: int = 1) -> None:
        """Attribute one per-var / per-group dispatch to the kernel cost
        ledger under its (codec, R, fanout, bucket, G) signature."""
        if not tel_registry.enabled():
            return
        codec, _spec = self._mesh_meta(var_id)
        get_ledger().record(
            family,
            codec.__name__,
            n_replicas=self.n_replicas,
            fanout=self._ledger_fanout(),
            seconds=seconds,
            row_bytes=self._row_bytes(var_id),
            rows=rows,
            g_active=g_active,
            leafwise=getattr(codec, "leafwise_join", None) is not None,
        )

    def _ledger_record_store(self, family: str, seconds: float, rounds: int,
                             block: "int | None" = None,
                             joins: "int | None" = None) -> None:
        """Attribute one whole-store window (step, fused block, converge,
        chaos window): bytes are the per-round wire estimate the bytes
        counter uses; ``block`` keys fixed-length windows; ``joins``, when
        the flight ring kept every round, is the exact changed-state tally
        in place of the ``R·fanout·V·rounds`` bound."""
        if not tel_registry.enabled():
            return
        n_vars = max(len(self.var_ids), 1)
        get_ledger().record(
            family,
            f"store{n_vars}",
            n_replicas=self.n_replicas,
            fanout=self._ledger_fanout(),
            seconds=seconds,
            bytes_moved=self._round_traffic * rounds,
            joins=(
                joins if joins is not None
                else self.n_replicas * self._ledger_fanout() * n_vars * rounds
            ),
            rounds=rounds,
            rows=block,
            n_vars=n_vars,
        )

    def _emit_step_telemetry(self, res_vec, residual: int,
                             elapsed: float) -> None:
        """The whole per-step host-side emission (factored out so the
        overhead guard times exactly this path): the residual trace always
        records; registry, monitor and events no-op when disabled."""
        self.round_residuals.append(residual)
        self._record_rounds(1)
        self._ledger_record_store("step", elapsed, 1)
        tel = self._instruments()
        if tel is not None:
            res_list = [int(r) for r in res_vec.tolist()]
            res_last = tel["residual_last"]
            for i, (g, r) in enumerate(zip(tel["residual"], res_list)):
                g.set(r)
                # keeps the frontier path's skip-if-unchanged cache coherent
                res_last[i] = r
            tel["round_seconds"].observe(elapsed)
            mon = get_monitor()
            mon.observe_round(self.var_ids, res_list, elapsed, self.n_replicas)
            tel_events.set_round(mon.round)
            tel_events.emit(
                "delivery",
                residual=int(residual),
                seconds=round(elapsed, 6),
                n_replicas=self.n_replicas,
            )

    def _flight_ring(self):
        """A fresh flight ring for one fused window (``int32[K, V]`` on the
        runtime's device), or None with telemetry off."""
        if not tel_registry.enabled():
            return None
        return tel_flight.ring_init(
            tel_flight.flight_rounds(), len(self.var_ids), device=self.device
        )

    def _drain_flight(self, family: str, ring, rounds: int,
                      quiescent: "bool | None", elapsed: float) -> "int | None":
        """Drain one fused window's flight ring into the host telemetry
        plane, after the sync the caller already made: per retained round
        ``ConvergenceMonitor.observe_round`` (the curve points the unfused
        step gives) and one ``delivery`` event with round provenance; the
        overwritten prefix only advances the monitor's clock; the window
        lands in ``telemetry.device``'s log. Returns the exact
        changed-state total (the ledger's joins), or None when telemetry
        is off or the ring lost rounds."""
        if rounds <= 0 or self._instruments() is None:
            return None
        ids = self.var_ids
        records, overwritten = tel_flight.decode_ring(ring, rounds)
        mon = get_monitor()
        if overwritten:
            mon.observe_opaque_rounds(overwritten, None)
        first_round = mon.round + 1
        per_round = elapsed / max(rounds, 1)
        for rec in records:
            mon.observe_round(ids, rec, per_round, self.n_replicas)
        tel_events.set_round(mon.round)
        for i, rec in enumerate(records):
            tel_events.emit(
                "delivery",
                round=first_round + i,
                residual=int(sum(rec)),
                fused=family,
                n_replicas=self.n_replicas,
            )
        tel_flight.record_window(tel_flight.FlightWindow(
            family=family,
            columns=tuple(str(v) for v in ids),
            rounds=int(rounds),
            overwritten=int(overwritten),
            records=records,
            seconds=float(elapsed),
            quiescent=quiescent,
            first_round=first_round,
        ))
        total = sum(sum(rec) for rec in records)
        return None if overwritten else int(total)

    @staticmethod
    def _record_quiescence(rounds: int) -> int:
        histogram(
            "gossip_rounds_to_quiescence",
            help="rounds a convergence run took to reach the fixed point",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 1024),
        ).observe(rounds)
        return rounds

    def _emit_frontier_telemetry(self, per_var_changed, total: int,
                                 rows_touched: int, skipped: int,
                                 dense_falls: int, elapsed: float,
                                 dispatches: int) -> None:
        """The frontier round's host-side emission, the frontier twin of
        :meth:`_emit_step_telemetry`: the same trace row and monitor feed,
        bytes scaled by the rows actually gathered, per-var gauges set only
        when their value moved."""
        self.round_residuals.append(total)
        tel = self._instruments()
        if tel is None:
            return
        tel["rounds"].inc(1)
        frac = rows_touched / max(self.n_replicas * len(self.var_ids), 1)
        tel["bytes"].inc(int(self._round_traffic * frac))
        for c, edges_of_kind in tel["edge_recomputes"]:
            c.inc(edges_of_kind)
        tel["frontier_rounds"].inc()
        if dense_falls:
            counter(
                "gossip_frontier_dense_fallbacks_total",
                help="dense rounds/runs taken where frontier "
                     "scheduling was requested, by reason",
                reason="crossover",
            ).inc(dense_falls)
        res_last, f_last = tel["residual_last"], tel["frontier_last"]
        for i, c in enumerate(per_var_changed):
            c = int(c)
            if res_last[i] != c:
                tel["residual"][i].set(c)
                res_last[i] = c
            # the post-round frontier IS the round's changed mask
            if f_last[i] != c:
                tel["frontier_rows"][i].set(c)
                f_last[i] = c
        if dispatches and self._plan is not None:
            tel["plan_vars_per_dispatch"].set(
                round((len(self.var_ids) - skipped) / dispatches, 3)
            )
        tel["round_seconds"].observe(elapsed)
        mon = get_monitor()
        mon.observe_round(self.var_ids, per_var_changed, elapsed, self.n_replicas)
        mon.observe_frontier(self.var_ids, per_var_changed)
        tel_events.set_round(mon.round)
        tel_events.emit(
            "delivery",
            residual=int(total),
            seconds=round(elapsed, 6),
            n_replicas=self.n_replicas,
            frontier_rows=int(rows_touched),
        )
        if skipped:
            tel_events.emit(
                "frontier_skip", skipped=int(skipped), of=len(self.var_ids),
            )

    def _kernel_family(self, var_id: str, masked: bool, rows: bool) -> str:
        """The ledger family of one dispatch of ``var_id``: the CUDA
        kernel's (``cuda_rows`` for K2 / K3, ``cuda_dense`` for K1) where
        the round launches it, else the plain arm's (``rows`` /
        ``dense``)."""
        codec, spec = self._mesh_meta(var_id)
        st = self.states[var_id]
        if st[0].device.type == "cuda":
            if rows and cuda_gossip.rows_plan_of(codec, spec, st) is not None:
                return "cuda_rows"
            if not rows and not masked and _word_planes(codec, st):
                return "cuda_dense"
        return "rows" if rows else "dense"

    # -- dense engine ----------------------------------------------------------
    def _ensure_step(self) -> tuple:
        """Shared prologue of every dense stepping call: fold in edges added
        to the graph, and the edge tables on the runtime's device, read
        anew (client writes grow the interners the tables index)."""
        if self._n_edges != len(self.graph.edges):
            self._sync_graph()
        # the per-round wire estimate behind gossip_bytes_exchanged_total and
        # the whole-store ledger rows (metadata only)
        self._round_traffic = self._traffic_estimate()
        return self.graph.device_tables(self.device)

    def _traffic_estimate(self) -> int:
        """Bytes ONE pull round moves: every variable's whole population,
        once per neighbour slot (``mesh.gossip.round_traffic_bytes``)."""
        k = self._ledger_fanout()
        return sum(round_traffic_bytes(st, k) for st in self.states.values())

    def _row_bytes(self, var_id: str) -> int:
        """One variable's per-replica-row byte footprint (metadata only,
        cached until a shape-changing event clears it with the plan)."""
        rb = self._row_bytes_cache.get(var_id)
        if rb is None:
            leaves = tree_leaves(self.states[var_id])
            total = sum(x.numel() * x.element_size() for x in leaves)
            rb = self._row_bytes_cache[var_id] = total // max(self.n_replicas, 1)
        return rb

    def _needed(self) -> frozenset:
        """The variables the local round views dense: the graph's and the
        triggers' touch sets, or every variable when a trigger declared
        none."""
        if any(touch is None for _fn, touch, _b in self._triggers):
            return frozenset(self.var_ids)
        needed = frozenset(self.graph._var_ids) | frozenset(
            v for _fn, touch, _b in self._triggers for v in touch
        )
        return needed & frozenset(self.var_ids)

    def _local_round(self, states: dict, tables) -> dict:
        """The replica-local half of a step, over every replica at once:
        unpack the needed variables, run the graph's round, land each
        trigger's candidates through merge + the inflation gate per replica,
        repack (``FlatORSet.pack`` canonicalises the tombstones, as the
        JAX step does). Where the needed variables' rows, viewed dense,
        pass ``gossip.SWEEP_BYTES`` in all, it runs blocks of
        ``gossip.CHUNK_BYTES`` into new populations (every part of it is
        replica-local), so it holds one block's dense views and
        temporaries, not the whole population's."""
        needed = self._needed()
        row = sum(
            x.numel() * x.element_size()
            for v in needed for x in tree_leaves(self.store.variable(v).state)
        )
        if row * self.n_replicas <= gossip_mod.SWEEP_BYTES:
            return self._local_rows(states, tables, needed)
        step = max(1, gossip_mod.CHUNK_BYTES // row)
        out = dict(states)
        for v in needed:
            out[v] = tree_map(torch.empty_like, states[v])
        for s in range(0, self.n_replicas, step):
            part = self._local_rows(
                {v: tree_map(lambda x: x[s:s + step], states[v]) for v in needed},
                tables, needed,
            )
            for v in needed:
                for dst, src in zip(tree_leaves(out[v]), tree_leaves(part[v])):
                    dst[s:s + step] = src
        return out

    def _local_rows(self, states: dict, tables, needed) -> dict:
        """:meth:`_local_round` over the rows ``states`` holds."""
        dense = {
            v: self._to_dense_row(v, x) for v, x in states.items() if v in needed
        }
        if self.graph.edges:
            flow = {v: dense[v] for v in self.graph._var_ids}
            dense.update(self.graph._round_fn(flow, tables))
        for trig, _touch, _b in self._triggers:
            for v, cand in _vmap_rows(trig, dense).items():
                if v not in dense:
                    raise KeyError(f"trigger wrote {v!r} outside its declared touches")
                var = self.store.variable(v)
                codec, spec = var.codec, var.spec
                merged = codec.merge(spec, dense[v], cand)
                ok = codec.is_inflation(spec, dense[v], merged)
                # bind rule: non-inflations silently ignored
                dense[v] = tree_select(ok, merged, dense[v])
        out = dict(states)
        out.update({v: self._from_dense_row(v, x) for v, x in dense.items()})
        return out

    def _dense_round(self, edge_mask, tables) -> torch.Tensor:
        """One step: the local round (with dataflow edges or triggers),
        then one gossip round over every variable. Returns the per-var
        residual vector — rows whose state changed from before the local
        round to after the gossip, by ``codec.equal`` — as an int32 device
        tensor, without a host sync."""
        _host, mask = self._masks(edge_mask)
        prev = dict(self.states)
        swept = (
            self._local_round(prev, tables)
            if self.graph.edges or self._triggers else dict(prev)
        )
        res = []
        for v in self.var_ids:
            codec, spec = self._mesh_meta(v)
            # the swept state is dropped once gossiped: at most one of them
            # is live beside the round's inputs and outputs
            new = gossip_round(codec, spec, swept.pop(v), self.neighbors, mask)
            res.append(changed_rows(codec, spec, prev[v], new))
            self.states[v] = new
        if not res:
            return torch.zeros((0,), dtype=torch.int32, device=self.device)
        return torch.stack(res)

    def step(self, edge_mask=None) -> int:
        """One bulk-synchronous round: local dataflow sweep and triggers,
        then gossip. Returns the number of (replica, variable) states it
        CHANGED (0 on the quiescent round)."""
        tables = self._ensure_step()
        self._frontier_sync_mask(edge_mask)
        with span("gossip.round", annotate=True):
            t0 = time.perf_counter()
            # the host read of the residual vector closes the timing window
            res_vec = self._dense_round(edge_mask, tables).cpu()
            elapsed = time.perf_counter() - t0
        residual = int(res_vec.sum())
        self._frontier_after_dense(res_vec.numpy())
        self._emit_step_telemetry(res_vec, residual, elapsed)
        return residual

    def _enqueue_block(self, block: int, edge_mask, tables, ring=None,
                       base: int = 0, gated: bool = False) -> torch.Tensor:
        """Enqueue ``block`` full steps; returns the device-side 0-based
        index of the block's first quiescent round, or -1, without a host
        sync. With a flight ``ring``, round ``i``'s per-var residual vector
        lands at slot ``(base + i) % K``: the block's rounds in one copy
        after the block, or, ``gated``, one write a round (its index kept on
        the device) of only the rounds up to and including the first
        quiescent one (``converge_on_device``'s loop stops there, so the
        no-op rounds after it are not rounds of the run)."""
        first_zero = torch.full((), -1, dtype=torch.int32, device=self.device)
        index = (
            torch.arange(block, dtype=torch.int64, device=self.device) + base
            if ring is not None and gated else None
        )
        records = []
        for i in range(block):
            res_vec = self._dense_round(edge_mask, tables)
            if index is not None:
                tel_flight.ring_write(ring, index[i], res_vec, when=first_zero < 0)
            elif ring is not None:
                records.append(res_vec)
            first_zero = torch.where(
                (first_zero < 0) & (res_vec.sum() == 0), i, first_zero
            )
        if records:
            # an ungated window keeps every round: one copy for the block
            tel_flight.ring_write_block(ring, base, records)
        return first_zero

    def _restore_states(self, states_in: dict) -> None:
        """Put back the populations of a window that failed (the port never
        donates, so they are intact)."""
        self.states.clear()
        self.states.update(states_in)

    def begin_fused_steps(self, block: int, edge_mask=None) -> FusedBlockHandle:
        """Enqueue a fused block of ``block`` full steps without waiting for
        it: the returned :class:`FusedBlockHandle`'s ``finish`` syncs and
        does the round bookkeeping. ``self.states`` holds the block's
        outputs at once, so work issued before ``finish`` (an
        ``ingest_cycle``) queues behind the window on the stream; host work
        in between overlaps the card's. A failure while enqueueing or at
        the sync restores the states from before the window."""
        tables = self._ensure_step()
        self._frontier_sync_mask(edge_mask)
        states_in = dict(self.states)
        t0 = time.perf_counter()
        ring = self._flight_ring()
        try:
            first_zero = self._enqueue_block(block, edge_mask, tables, ring)
        except Exception:
            self._restore_states(states_in)
            raise
        return FusedBlockHandle(self, block, first_zero, states_in, ring, t0)

    def fused_steps(self, block: int, edge_mask=None) -> int:
        """Run ``block`` full steps (sweep + triggers + gossip + residual)
        with one host sync at the end (``begin_fused_steps(...).finish()``).
        Returns the 0-based index within the block of the first quiescent
        round (residual 0), or -1 if every round changed something; a
        quiescent step is a fixed point of the whole step (join idempotence
        and the triggers' inflation gate), so the rounds after it are
        no-ops."""
        return self.begin_fused_steps(block, edge_mask).finish()

    def converge_on_device(self, max_rounds: int = 10_000, edge_mask=None,
                           strict: bool = True, sync_every: int = 8) -> int:
        """Run to the fixed point with no per-round host sync: fused blocks
        of at most 8 full steps, each capped by the budget left, with the
        host reading one device-side first-quiescent index a block (eager
        PyTorch has no ``while_loop``; the JAX runtime runs the same steps
        in one).

        Returns the exact rounds to convergence, the final quiescent round
        included (the :meth:`run_to_convergence` count). When the budget
        runs out it raises, or with ``strict=False`` returns
        ``-rounds_executed``. Up to 7 no-op rounds may run past the fixed
        point inside the last block; the flight ring (``_drain_flight``,
        family ``converge``) records only the rounds JAX's loop runs, the
        quiescent one included. ``sync_every`` is checked as in JAX; the
        partitioned arm that reads it stays with ``shard``, which is not
        ported."""
        if max_rounds < 1:
            raise ValueError("max_rounds must be >= 1")
        if sync_every < 0:
            raise ValueError("sync_every must be >= 0")
        tables = self._ensure_step()
        self._frontier_sync_mask(edge_mask)
        rounds = 0
        signed = None
        with span("gossip.converge", annotate=True):
            t0 = time.perf_counter()
            # the flight ring records the rounds JAX's while loop runs, in
            # its order: a block's no-op rounds after the fixed point are
            # gated out on the device
            ring = self._flight_ring()
            while signed is None:
                block = min(_CONVERGE_BLOCK, max_rounds - rounds)
                first = int(self._enqueue_block(
                    block, edge_mask, tables, ring, base=rounds, gated=True
                ))  # the block's one host sync
                if first >= 0:
                    signed = rounds + first + 1
                else:
                    rounds += block
                    if rounds >= max_rounds:
                        signed = -rounds
            elapsed = time.perf_counter() - t0
        self._frontier_after_opaque(signed > 0)
        # 0 = reached the fixed point; -1 = the budget ran out
        self.round_residuals.append(0 if signed > 0 else -1)
        self._record_rounds(abs(signed))
        joins = None
        if ring is not None:
            joins = self._drain_flight(
                "converge", ring, abs(signed), signed > 0, elapsed
            )
        if signed:
            self._ledger_record_store("converge", elapsed, abs(signed),
                                      joins=joins)
        if signed > 0:
            self._record_quiescence(signed)
        if signed < 0 and strict:
            raise RuntimeError(f"no convergence within {-signed} rounds")
        return signed

    def run_to_convergence(self, max_rounds: int = 10_000, edge_mask=None,
                           block: int = 1, mode: str = "dense") -> int:
        """Step until no state changes; returns rounds taken (the quiescent
        round counted). ``block > 1`` runs dense rounds in fused blocks with
        an exact count. ``mode``: ``"dense"``, ``"frontier"`` (dirty-set
        scheduling; raises where the runtime needs the dense sweep) or
        ``"auto"`` (frontier where supported, dense otherwise)."""
        if mode not in ("dense", "frontier", "auto"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode != "dense":
            reason = self._frontier_unsupported()
            if reason is None:
                return self._frontier_convergence(max_rounds, edge_mask)
            if mode == "frontier":
                raise RuntimeError(f"frontier gossip unavailable here: {reason}")
            # auto degraded to dense, observably
            key = "dataflow"
            counter(
                "gossip_frontier_dense_fallbacks_total",
                help="dense rounds/runs taken where frontier scheduling "
                     "was requested, by reason",
                reason=key,
            ).inc()
            tel_events.emit("frontier_skip", fallback=key, mode="auto")
        if block > 1:
            rounds = 0
            while rounds < max_rounds:
                b = min(block, max_rounds - rounds)
                first_zero = self.fused_steps(b, edge_mask)
                if first_zero >= 0:
                    return self._record_quiescence(rounds + first_zero + 1)
                rounds += b
            raise RuntimeError(f"no convergence within {max_rounds} rounds")
        for i in range(max_rounds):
            if self.step(edge_mask) == 0:
                return self._record_quiescence(i + 1)
        raise RuntimeError(f"no convergence within {max_rounds} rounds")

    # -- frontier engine -------------------------------------------------------
    def mark_dirty(self, var_id: "str | None" = None, rows=None) -> None:
        """Mark replica rows frontier-dirty (after direct state surgery);
        ``var_id`` None = every variable, ``rows`` None = every row."""
        targets = (var_id,) if var_id is not None else tuple(self.states)
        for v in targets:
            if v not in self.states:
                raise KeyError(v)
            if rows is None:
                self._frontier[v] = np.ones(self.n_replicas, dtype=bool)
                self._aae_mark(v, None)
            else:
                self._mark_dirty_rows(v, rows)

    def _mark_dirty_rows(self, var_id: str, rows) -> None:
        f = self._frontier.get(var_id)
        if f is None or f.shape[0] != self.n_replicas:
            f = self._frontier[var_id] = np.zeros(self.n_replicas, bool)
        f[np.asarray(rows, dtype=np.int64)] = True
        self._aae_mark(var_id, rows)

    def _aae_mark(self, var_id: "str | None" = None, rows=None) -> None:
        """OR tracked row mutations into an attached AAE forest's dirty
        accumulator (``var_id`` None = every variable, ``rows`` None = every
        row); one attribute read when no forest is attached. A mutation that
        bypasses this (direct state surgery without :meth:`mark_dirty`) is
        what the AAE verify pass flags as silent corruption."""
        d = self._aae_dirty
        if d is None:
            return
        for v in ((var_id,) if var_id is not None else self.var_ids):
            m = d.get(v)
            if m is None or m.shape[0] != self.n_replicas:
                m = d[v] = np.zeros(self.n_replicas, dtype=bool)
            if rows is None:
                m.fill(True)
            else:
                m[np.asarray(rows, dtype=np.int64)] = True

    def _frontier_sync_mask(self, edge_mask) -> None:
        """Frontier knowledge holds only for the mask it was learned under:
        a different mask object degrades every frontier to all-dirty."""
        if edge_mask is not self._frontier_mask_ref:
            for v in list(self._frontier):
                self._frontier_fill(v, True)
            self._frontier_mask_ref = edge_mask
            self._invalidate_plan("mask_change")

    def _frontier_fill(self, var_id: str, value: bool) -> None:
        f = self._frontier.get(var_id)
        if f is not None and f.shape[0] == self.n_replicas and f.flags.writeable:
            f.fill(value)
        else:
            self._frontier[var_id] = np.full(self.n_replicas, value, bool)

    def _frontier_after_dense(self, res_vec) -> None:
        """After an unfused dense round: residual 0 proves the variable
        quiescent (empty frontier); anything else changed unknown rows."""
        for v, r in zip(self.var_ids, np.asarray(res_vec).tolist()):
            self._frontier_fill(v, bool(r))
            if r:
                self._aae_mark(v, None)

    def _frontier_after_opaque(self, quiescent: bool) -> None:
        """After a fused block: quiescence clears every frontier, anything
        else degrades them to all-dirty. AAE dirtiness degrades always: a
        block that quiesced still changed rows on its way."""
        for v in self.var_ids:
            self._frontier_fill(v, not quiescent)
            self._aae_mark(v, None)

    def frontier_size(self, var_id: str) -> int:
        self._population(var_id)
        return int(self._frontier[var_id].sum())

    def _frontier_unsupported(self) -> "str | None":
        """None when the frontier engine can schedule this runtime, else
        the reason the dense sweep is required."""
        if self.graph.edges or self._triggers:
            return (
                "dataflow edges / triggers sweep every replica row locally "
                "(a row can change from its own state)"
            )
        return None

    def frontier_step(self, edge_mask=None) -> int:
        """ONE frontier-scheduled round: per variable, expand the dirty mask
        by reverse-neighbour reachability, gather + join only the reachable
        rows, and reseed the frontier with the rows that inflated. A
        variable with an empty frontier is skipped; one whose reachable
        set exceeds ``frontier_crossover * n_replicas`` runs the dense round.
        Under the dispatch plan (``plan="auto"``) the sparse rounds of a
        group's active members share one kernel launch. Returns the total
        (replica, variable) states changed — the :meth:`step` contract,
        with identical per-round states."""
        reason = self._frontier_unsupported()
        if reason is not None:
            raise RuntimeError(f"frontier_step unavailable: {reason}")
        self._frontier_sync_mask(edge_mask)
        if not self._round_traffic:
            self._round_traffic = self._traffic_estimate()
        plan = self._ensure_plan()
        skipped = sum(not self._frontier_mask_of(v).any() for v in self.var_ids)
        with span("gossip.frontier_round", annotate=True):
            t0 = time.perf_counter()
            if plan is None:
                stats = self._frontier_round_pervar(edge_mask)
            else:
                stats = self._frontier_round_planned(plan, edge_mask)
            elapsed = time.perf_counter() - t0
        total = sum(stats["per_var_changed"])
        self.frontier_rows_last = stats["rows_touched"]
        self.frontier_rows_total += stats["rows_touched"]
        self.frontier_dense_falls_last = stats["dense_falls"]
        self._emit_frontier_telemetry(
            stats["per_var_changed"], total, stats["rows_touched"], skipped,
            stats["dense_falls"], elapsed, stats["dispatches"],
        )
        return total

    def _frontier_round_pervar(self, edge_mask) -> dict:
        """One round with one dispatch per variable (``plan="off"``)."""
        per_var, rows_touched, dense_falls, dispatches = [], 0, 0, 0
        for v in self.var_ids:
            changed, touched, dense = self._frontier_round_onevar(v, edge_mask)
            per_var.append(changed)
            rows_touched += touched
            dense_falls += dense
            dispatches += touched > 0
        return {"per_var_changed": per_var, "rows_touched": rows_touched,
                "dense_falls": dense_falls, "dispatches": dispatches}

    def _frontier_round_planned(self, plan, edge_mask) -> dict:
        """One round under the dispatch plan: per group, the active members'
        reachable rows ride ONE row-sparse launch (members pad to the group
        bucket with invalid slots); a quiescent member is skipped and rides
        through bit-unchanged; the dense crossover is decided per member, so
        one hot member promotes only itself. Singleton groups take the
        per-variable round. Per-member states and residuals are those of
        the per-variable round."""
        changed_of: dict = {}
        rows_touched = dense_falls = dispatches = 0
        for group in plan.groups:
            if len(group) == 1:
                v = group.var_ids[0]
                changed_of[v], touched, dense = self._frontier_round_onevar(
                    v, edge_mask
                )
                rows_touched += touched
                dense_falls += dense
                dispatches += touched > 0
                continue
            active = []  # (var_id, reachable rows)
            for v in group.var_ids:
                f = self._frontier_mask_of(v)
                if not f.any():
                    continue
                rows = self._frontier_reach_rows(f, edge_mask)
                if rows.size == 0:
                    self._frontier[v] = np.zeros(self.n_replicas, bool)
                    continue
                active.append((v, rows))
            thresh = self.frontier_crossover * self.n_replicas
            dense_subset = [(v, r) for v, r in active if r.size > thresh]
            sparse_subset = [(v, r) for v, r in active if r.size <= thresh]
            dense_ids = [v for v, _r in dense_subset]
            dispatches += bool(dense_ids) + bool(sparse_subset)
            for v, mask in zip(dense_ids, self._plan_dense_round(dense_ids, edge_mask)):
                self._frontier[v] = mask
                changed_of[v] = int(mask.sum())
                if changed_of[v]:
                    self._aae_mark(v, np.flatnonzero(mask))
            dense_falls += len(dense_subset)
            rows_touched += self.n_replicas * len(dense_subset)
            if sparse_subset:
                max_rows = max(r.size for _v, r in sparse_subset)
                bucket = max(self._frontier_bucket(max_rows), max_rows)
                rows_mat = np.zeros((len(sparse_subset), bucket), dtype=np.int64)
                valid = np.zeros((len(sparse_subset), bucket), dtype=bool)
                for i, (_v, rows) in enumerate(sparse_subset):
                    rows_mat[i, : rows.size] = rows
                    rows_mat[i, rows.size:] = rows[0]
                    valid[i, : rows.size] = True
                    rows_touched += int(rows.size)
                changed = self._plan_sparse_round(
                    [v for v, _r in sparse_subset], rows_mat, valid, edge_mask
                )
                for i, (v, rows) in enumerate(sparse_subset):
                    mask = np.zeros(self.n_replicas, dtype=bool)
                    ch = changed[i, : rows.size]
                    mask[rows[ch]] = True
                    self._frontier[v] = mask
                    changed_of[v] = int(mask.sum())
                    if changed_of[v]:
                        self._aae_mark(v, rows[ch])
        return {
            "per_var_changed": [changed_of.get(v, 0) for v in self.var_ids],
            "rows_touched": rows_touched,
            "dense_falls": dense_falls,
            "dispatches": dispatches,
        }

    def _plan_dense_round(self, var_ids, edge_mask) -> list:
        """Dense crossover arm for a group's hot members: each member's full
        round and per-row change mask. The JAX plan stacks the members and
        vmaps one round; here each member steps where it lies (a stack would
        copy every member population), with the same values. The ledger
        takes the group's one ``grouped_dense`` row, as JAX's dispatch."""
        if not var_ids:
            return []
        t0 = time.perf_counter()
        out = [self._frontier_dense_round(v, edge_mask, ledger=False)
               for v in var_ids]
        self._ledger_record_var("grouped_dense", var_ids[0],
                                time.perf_counter() - t0, g_active=len(var_ids))
        return out

    def _plan_sparse_round(self, var_ids, rows_mat: np.ndarray,
                           valid: np.ndarray, edge_mask) -> np.ndarray:
        """One group's row-sparse round over its active members (``rows_mat``
        ``[G, F]``, bucket-padded); returns ``changed: bool[G, F]`` on the
        host, valid slots only."""
        _host, mask = self._masks(edge_mask)
        t0 = time.perf_counter()
        changed = self._rows_round(var_ids, self._index(rows_mat), mask)
        changed = changed.cpu().numpy() & valid  # the dispatch's sync
        family = self._kernel_family(var_ids[0], mask is not None, rows=True)
        self._ledger_record_var(
            "cuda_rows" if family == "cuda_rows" else "grouped_rows",
            var_ids[0], time.perf_counter() - t0, rows=int(rows_mat.shape[1]),
            g_active=len(var_ids),
        )
        return changed

    def _rows_round(self, var_ids, row_idx: torch.Tensor, mask) -> torch.Tensor:
        """The row-sparse round of same-signature members ``var_ids`` over
        ``row_idx: [G, F]``: K2 or K3 (their plain versions on the CPU) read
        the member populations where they lie, and the joined rows are
        scattered back into each member in place. A codec with no kernel
        plan takes the plain per-member round. Returns the raw ``changed:
        bool[G, F]`` (device)."""
        codec, spec = self._mesh_meta(var_ids[0])
        members = [self.states[v] for v in var_ids]
        plan = cuda_gossip.rows_plan_of(codec, spec, members[0])
        if plan is None:
            changed = []
            for v, rows in zip(var_ids, row_idx):
                self.states[v], ch = gossip_round_rows(
                    codec, spec, self.states[v], self.neighbors, rows, mask
                )
                changed.append(ch)
            return torch.stack(changed)
        leaves = [list(ls) for ls in zip(*members)]  # per leaf, G members
        joined, changed = cuda_gossip.rows_round(
            plan, leaves, self.neighbors, row_idx, mask
        )
        for ms, j in zip(leaves, joined):
            cuda_gossip.scatter_rows(ms, row_idx, j)
        return changed

    def _frontier_mask_of(self, var_id: str) -> np.ndarray:
        f = self._frontier.get(var_id)
        if f is None or f.shape[0] != self.n_replicas:
            f = self._frontier[var_id] = np.ones(self.n_replicas, bool)
        return f

    def _frontier_reach_rows(self, f: np.ndarray, edge_mask) -> np.ndarray:
        """Row indices reachable from a frontier mask this round (live
        fan-in only under ``edge_mask``)."""
        host, _dev = self._masks(edge_mask)
        if host is not None:
            return np.flatnonzero((f[self._host_neighbors] & host).any(axis=1))
        return np.flatnonzero(frontier_reach(f, self._host_neighbors))

    def _frontier_round_onevar(self, v: str, edge_mask) -> tuple:
        """One variable's frontier round: ``(changed_count, rows_touched,
        dense_falls)``."""
        f = self._frontier_mask_of(v)
        if not f.any():
            return 0, 0, 0
        rows = self._frontier_reach_rows(f, edge_mask)
        if rows.size == 0:
            # dirty rows whose every out-edge is dead deliver nothing
            self._frontier[v] = np.zeros(self.n_replicas, bool)
            return 0, 0, 0
        if rows.size > self.frontier_crossover * self.n_replicas:
            changed_mask = self._frontier_dense_round(v, edge_mask)
            touched, dense = self.n_replicas, 1
        else:
            changed_mask = self._frontier_sparse_round(v, rows, edge_mask)
            touched, dense = int(rows.size), 0
        self._frontier[v] = changed_mask
        if changed_mask.any():
            self._aae_mark(v, np.flatnonzero(changed_mask))
        return int(changed_mask.sum()), touched, dense

    def _frontier_bucket(self, n: int) -> int:
        b = self._FRONTIER_MIN_BUCKET
        while b < n:
            b <<= 1
        return min(b, self.n_replicas)

    def _frontier_sparse_round(self, var_id: str, rows: np.ndarray,
                               edge_mask) -> np.ndarray:
        """The row-sparse round for one variable over the reachable rows,
        padded to a power-of-two bucket with repeats of the first row (one
        kernel shape per bucket): K2 or K3 at G=1 (:meth:`_rows_round`).
        Returns the new frontier (the rows that inflated)."""
        bucket = self._frontier_bucket(rows.size)
        if bucket < rows.size:  # n_replicas-capped bucket
            padded = rows
        else:
            padded = np.full(bucket, rows[0], dtype=np.int64)
            padded[: rows.size] = rows
        _host, mask = self._masks(edge_mask)
        t0 = time.perf_counter()
        changed = self._rows_round((var_id,), self._index(padded)[None], mask)[0]
        out = np.zeros(self.n_replicas, dtype=bool)
        out[rows[changed[: rows.size].cpu().numpy()]] = True  # the sync
        self._ledger_record_var(
            self._kernel_family(var_id, mask is not None, rows=True), var_id,
            time.perf_counter() - t0, rows=int(padded.size),
        )
        return out

    def _frontier_dense_round(self, var_id: str, edge_mask,
                              ledger: bool = True) -> np.ndarray:
        """Dense crossover arm of :meth:`frontier_step` for one variable:
        the full round plus the per-row change vector."""
        codec, spec = self._mesh_meta(var_id)
        _host, mask = self._masks(edge_mask)
        t0 = time.perf_counter()
        prev = self.states[var_id]
        new = gossip_round(codec, spec, prev, self.neighbors, mask)
        changed = ~codec.equal(spec, prev, new)
        self.states[var_id] = new
        out = changed.cpu().numpy().copy()  # the dispatch's sync
        if ledger:
            self._ledger_record_var(
                self._kernel_family(var_id, mask is not None, rows=False),
                var_id, time.perf_counter() - t0,
            )
        return out

    def _frontier_convergence(self, max_rounds: int, edge_mask) -> int:
        for i in range(max_rounds):
            if self.frontier_step(edge_mask) == 0:
                return self._record_quiescence(i + 1)
        raise RuntimeError(f"no convergence within {max_rounds} rounds")

    # -- reads ------------------------------------------------------------------
    def _population(self, var_id: str):
        """The variable's [R, ...] states, replicating a variable declared
        after the runtime was built, the late-declare rule every read and
        write routes through. A map's population is re-checked against its
        spec's field axis here."""
        if var_id not in self.states:
            if var_id not in self.store.ids():
                raise KeyError(var_id)
            self._sync_graph()
        var = self.store.variable(var_id)
        if var.type_name == "riak_dt_map":
            # fields admitted on the store variable behind this runtime's
            # back re-lay out the population here (bottom planes, observably
            # a no-op); more planes than the spec cannot come from growth
            states = self.states[var_id]
            if states.dots.shape[-2] > var.spec.n_fields:
                raise RuntimeError(
                    f"{var_id}: population states carry "
                    f"{states.dots.shape[-2]} field planes but the spec "
                    f"declares {var.spec.n_fields} — the spec shrank "
                    "behind this runtime's back (field axes only grow; "
                    "rebuild the runtime from the store)"
                )
            # grow() returns the same object when nothing changed
            grown = CrdtMap.grow(var.spec, states)
            if grown is not states:
                self.states[var_id] = grown
                self._invalidate_plan("map_growth")
        return self.states[var_id]

    def coverage_value(self, var_id: str):
        """Global join + decode — the coverage query
        (``src/lasp_execute_coverage_fsm.erl:78-94``)."""
        pop = self._population(var_id)
        var = self.store.variable(var_id)
        codec, spec = self._mesh_meta(var_id)
        top = join_all(codec, spec, pop)
        return self.store._decode_value(var, self._to_dense_row(var_id, top))

    def replica_value(self, var_id: str, replica: int):
        var = self.store.variable(var_id)
        row = tree_map(lambda x: x[replica], self._population(var_id))
        return self.store._decode_value(var, self._to_dense_row(var_id, row))

    def quorum_value(self, var_id: str, replicas):
        """R-of-N quorum read: join the given replica rows and decode."""
        replicas = np.asarray(replicas, dtype=np.int64)
        if replicas.size == 0:
            raise ValueError("quorum_value needs at least one replica")
        if replicas.min() < 0 or replicas.max() >= self.n_replicas:
            raise IndexError(
                f"replica indices {replicas.tolist()} out of range for "
                f"{self.n_replicas} replicas"
            )
        pop = self._population(var_id)
        var = self.store.variable(var_id)
        codec, spec = self._mesh_meta(var_id)
        top = quorum_read(codec, spec, pop, replicas)
        return self.store._decode_value(var, self._to_dense_row(var_id, top))

    def divergence(self, var_id: str) -> int:
        pop = self._population(var_id)
        codec, spec = self._mesh_meta(var_id)
        return int(divergence(codec, spec, pop))

    # -- row primitives -----------------------------------------------------------
    def _row_leaf(self, x, live: torch.Tensor) -> torch.Tensor:
        """One supplied row leaf as a tensor of the live population's dtype
        on its device. A wire leaf from numpy keeps its bits: JAX's
        ``uint32`` packed words become the port's ``int32`` view."""
        if not isinstance(x, torch.Tensor):
            a = np.asarray(x)
            if a.dtype == np.uint32 and live.dtype == torch.int32:
                a = a.view(np.int32)
            x = torch.from_numpy(np.array(a))  # a copy; 0-d leaves stay 0-d
        return x.to(device=self.device, dtype=live.dtype)

    def join_rows(self, var_id: str, rows, contribs) -> int:
        """Masked partial join: merge contribution rows into the named
        replica rows, the primitive behind read-repair, quorum put
        replication and hinted handoff. ``rows`` must be UNIQUE replica
        indices; ``contribs`` is a sequence of wire-format row states (one
        per row) or a single row state joined into every named row (the
        read-repair broadcast). Only the rows the join changes are marked
        frontier-dirty. Returns the number of rows changed; re-applying is
        a no-op (idempotent join)."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return 0
        if rows.min() < 0 or rows.max() >= self.n_replicas:
            raise IndexError(
                f"join_rows({var_id!r}): rows {rows.tolist()} out of "
                f"range for {self.n_replicas} replicas"
            )
        if np.unique(rows).size != rows.size:
            raise ValueError(
                f"join_rows({var_id!r}): duplicate rows — fold same-row "
                "contributions with codec.merge first (the scatter would "
                "race otherwise)"
            )
        pop = self._population(var_id)  # before _mesh_meta (late declare)
        codec, spec = self._mesh_meta(var_id)
        n = int(rows.size)
        # a bare state NamedTuple is ONE row (broadcast); only a plain
        # list / tuple is a per-row sequence (the reseed_row rule)
        if isinstance(contribs, (list, tuple)) and not hasattr(contribs, "_fields"):
            if len(contribs) != n:
                raise ValueError(
                    f"join_rows({var_id!r}): {len(contribs)} contribution "
                    f"rows for {n} target rows"
                )
            stacked = tree_map(
                lambda live, *xs: torch.stack([self._row_leaf(x, live) for x in xs]),
                pop, *contribs,
            )
        else:
            stacked = tree_map(
                lambda live, x: self._row_leaf(x, live).unsqueeze(0).expand(
                    (n,) + tuple(live.shape[1:])),
                pop, contribs,
            )
        idx = self._index(rows)
        rows_st = tree_map(lambda x: x[idx], pop)
        merged = codec.merge(spec, rows_st, stacked)
        changed = (~codec.equal(spec, rows_st, merged)).cpu().numpy()
        n_changed = int(changed.sum())
        if n_changed:
            # every named row takes its merge, as JAX's ``.at[rows].set``
            for x, m in zip(tree_leaves(pop), tree_leaves(merged)):
                x[idx] = m
            self._mark_dirty_rows(var_id, rows[changed])
        return n_changed

    def _to_dense_states(self, var_id: str):
        """The variable's population in its dense codec's layout (packed
        OR-Sets unpacked; the int32 word views stay views)."""
        if var_id in self._packed_specs:
            return FlatORSet.unpack(self._packed_specs[var_id], self.states[var_id])
        return self.states[var_id]

    def reseed_row(self, replica: int, rows: "dict | None" = None) -> None:
        """Re-seed ONE replica row of every variable, the crash-restore
        reconstruction (``src/lasp_vnode.erl:454-472``): the row restarts
        at the lattice bottom, or at the supplied per-variable row
        ``rows[var_id]`` (a row state in this runtime's mesh wire format,
        or the leaf list ``store.checkpoint.load_runtime_rows`` returns),
        and gossip rebuilds the rest from its peers. Leaf shapes are
        checked against the live rows. Every frontier degrades to all-dirty
        afterwards: the row must be caught up even from quiescent peers. AAE
        dirtiness stays row-scoped (only this row's state changed)."""
        if not 0 <= replica < self.n_replicas:
            raise IndexError(f"replica {replica} out of range for {self.n_replicas}")
        for v in self.var_ids:
            codec, spec = self._mesh_meta(v)
            st = self.states[v]
            if rows is not None and v in rows:
                row = rows[v]
                if isinstance(row, (list, tuple)) and not hasattr(row, "_fields"):
                    # leaf-list form (load_runtime_rows)
                    row = tree_unflatten(tree_map(lambda x: x[0], st), row)
                for live, rl in zip(tree_leaves(st), tree_leaves(row)):
                    if tuple(live.shape[1:]) != tuple(np.shape(rl)):
                        raise ValueError(
                            f"reseed_row({v!r}): restored row leaf shape "
                            f"{tuple(np.shape(rl))} does not match the live row "
                            f"layout {tuple(live.shape[1:])} — restore "
                            "from a checkpoint of this runtime's spec"
                        )
            else:
                row = codec.new(spec, device=self.device)
            for x, r in zip(tree_leaves(st), tree_leaves(row)):
                x[replica] = self._row_leaf(r, x)
        for v in self.var_ids:
            self._frontier_fill(v, True)
        self._aae_mark(None, [replica])
        self._invalidate_plan("restore")

    # -- elastic membership --------------------------------------------------------
    @staticmethod
    def _validate_topology(new_n: int, new_neighbors) -> np.ndarray:
        new_neighbors = np.asarray(new_neighbors)
        if new_neighbors.ndim != 2 or new_neighbors.shape[0] != new_n:
            raise ValueError(
                f"new_neighbors must be [new_n={new_n}, K], "
                f"got {new_neighbors.shape}"
            )
        if new_neighbors.size and (
            new_neighbors.min() < 0 or new_neighbors.max() >= new_n
        ):
            raise ValueError("new_neighbors indices out of range")
        return new_neighbors

    def _handoff(self, codec, spec, head, tail, targets: np.ndarray) -> None:
        """Graceful leave's fold, in place: each claim target ``t`` of
        ``head`` joins ``join_all`` of the tail rows that claim it, as JAX's
        per-target loop does, batched over targets: the sources of every
        target are folded rank by rank (a target's k-th source in tail
        order), then merged into the targets at once."""
        uniq, group = np.unique(targets, return_inverse=True)
        order = np.argsort(group, kind="stable")  # by target, tail order within
        rank = np.empty(targets.size, dtype=np.int64)
        rank[order] = np.arange(targets.size) - np.searchsorted(group[order], group[order])
        src0 = np.flatnonzero(rank == 0)
        h = tree_map(lambda x: x[self._index(src0[np.argsort(group[src0])])], tail)
        for k in range(1, int(rank.max()) + 1):
            srck = np.flatnonzero(rank == k)
            pos = self._index(group[srck])
            cur = tree_map(lambda x: x[pos], h)
            merged = codec.merge(spec, cur, tree_map(lambda x: x[self._index(srck)], tail))
            for x, m in zip(tree_leaves(h), tree_leaves(merged)):
                x[pos] = m
        tgt = self._index(uniq)
        merged = codec.merge(spec, tree_map(lambda x: x[tgt], head), h)
        for x, m in zip(tree_leaves(head), tree_leaves(merged)):
            x[tgt] = m

    def resize(self, new_n: int, new_neighbors, graceful: bool = True) -> None:
        """Grow or shrink the replica population mid-run, the one-shot
        commit of riak_core staged membership (``src/lasp_console.erl:
        31-94``).

        Join (``new_n > n_replicas``): new rows start at the lattice bottom
        and catch up by gossip over the new topology. Leave (``new_n <
        n_replicas``): with ``graceful=True`` each departing row's state
        joins into its claim successor ``row % new_n``
        (``membership.plan.claim_targets``) before the rows drop, vetted by
        ``_handoff_guard`` when one is set; ``graceful=False`` models a
        crash: departing state is lost unless it already gossiped. The
        topology is re-supplied (``new_neighbors: int[new_n, K]``, checked
        by :meth:`_validate_topology`) and the membership epoch advances."""
        new_neighbors = self._validate_topology(new_n, new_neighbors)
        old_n = self.n_replicas
        actor_targets = None
        targets = None
        if new_n < old_n and graceful:
            sources = np.arange(new_n, old_n, dtype=np.int64)
            targets = claim_targets(old_n, new_n)
            if self._handoff_guard is not None:
                self._handoff_guard(sources, targets)
            actor_targets = {int(s): int(t) for s, t in zip(sources, targets)}
        for v in self.var_ids:
            codec, spec = self._mesh_meta(v)
            st = self.states[v]
            if new_n < old_n:
                head = tree_map(lambda x: x[:new_n].clone(), st)
                if graceful:
                    self._handoff(codec, spec, head,
                                  tree_map(lambda x: x[new_n:], st), targets)
                self.states[v] = head
            elif new_n > old_n:
                fresh = replicate(codec.new(spec, device=self.device), new_n - old_n)
                self.states[v] = tree_map(
                    lambda a, b: torch.cat([a, b], dim=0), st, fresh
                )
        if new_n > old_n:
            kind = "join"
        elif new_n < old_n:
            kind = "leave_graceful" if graceful else "leave_crash"
        else:
            kind = "topology_swap"
        self._finish_membership(
            kind, old_n, new_n, new_neighbors,
            dirty_rows=None, actor_targets=actor_targets,
        )

    def membership_grow(self, new_n: int, new_neighbors, dirty_rows=None) -> None:
        """Staged-join commit primitive: append ``new_n - n_replicas``
        bottom rows and advance the membership epoch. ``dirty_rows``
        (``membership.plan.changed_delivery_rows``) scopes the frontier
        degrade to the rows whose delivery changed; None keeps the blanket
        all-dirty."""
        new_neighbors = self._validate_topology(new_n, new_neighbors)
        old_n = self.n_replicas
        if new_n <= old_n:
            raise ValueError(
                f"membership_grow: new_n={new_n} must exceed the current "
                f"{old_n}-replica population"
            )
        for v in self.var_ids:
            codec, spec = self._mesh_meta(v)
            fresh = replicate(codec.new(spec, device=self.device), new_n - old_n)
            self.states[v] = tree_map(
                lambda a, b: torch.cat([a, b], dim=0), self.states[v], fresh
            )
        self._finish_membership(
            "join_staged", old_n, new_n, new_neighbors,
            dirty_rows=dirty_rows, actor_targets=None,
        )

    def membership_drop_tail(self, new_n: int, new_neighbors, *,
                             dirty_rows=None, actor_targets=None,
                             kind: str = "leave_staged") -> None:
        """Staged-leave commit primitive: truncate the departing tail
        without a merge (ownership was handed off row by row before).
        ``actor_targets`` maps a departing row to the claim successor that
        received its handoff (missing entries retire to ``-1``);
        ``dirty_rows`` scopes the frontier degrade; None keeps the
        blanket."""
        new_neighbors = self._validate_topology(new_n, new_neighbors)
        old_n = self.n_replicas
        if new_n >= old_n:
            raise ValueError(
                f"membership_drop_tail: new_n={new_n} must be below the "
                f"current {old_n}-replica population"
            )
        for v in self.var_ids:
            self.states[v] = tree_map(lambda x: x[:new_n].clone(), self.states[v])
        self._finish_membership(
            kind, old_n, new_n, new_neighbors,
            dirty_rows=dirty_rows, actor_targets=actor_targets,
        )

    def _finish_membership(self, kind: str, old_n: int, new_n: int,
                           new_neighbors, *, dirty_rows, actor_targets) -> None:
        """Shared membership-commit epilogue: advance the epoch, swap the
        topology and drop every view sized by the old population (the mask
        views, the frontier's mask reference), degrade frontiers (blanket
        when ``dirty_rows`` is None, row-scoped otherwise, surviving rows'
        dirty bits kept), remap or retire departed actor sites, and drop
        the dispatch plan. ``kind`` names the event for
        ``record_membership`` (the monitor and the causal log)."""
        record_membership(kind, old_n, new_n)
        self.n_replicas = new_n
        self._host_neighbors = np.asarray(new_neighbors).astype(np.int32)
        self.neighbors = torch.as_tensor(
            self._host_neighbors, device=self.device
        ).contiguous()
        # the kernels do no bounds checks: nothing sized by the old
        # population may survive (a reused mask object would skip the
        # shape check of ``_masks``)
        self._mask_views = (None, None, None)
        self._frontier_mask_ref = None
        keep = min(old_n, new_n)
        for v in list(self._frontier):
            old_f = self._frontier[v]
            if dirty_rows is None:
                # no transfer knowledge: fresh rows start at bottom and must
                # be caught up even from quiescent peers
                self._frontier[v] = np.ones(new_n, dtype=bool)
                continue
            f = np.zeros(new_n, dtype=bool)
            if old_f.shape[0] >= keep:
                f[:keep] |= old_f[:keep]
            rows = np.asarray(dirty_rows, dtype=np.int64)
            if rows.size:
                f[rows] = True
            self._frontier[v] = f
        # a departed actor's tokens may still circulate: a graceful / staged
        # leave joined its row into the claim successor, where the actor may
        # continue; otherwise the binding retires to -1, a site no row
        # matches (the never-reuse-an-actor incarnation rule)
        if new_n < old_n:
            for key, site in list(self._actor_sites.items()):
                if site >= new_n:
                    target = (
                        actor_targets.get(site) if actor_targets is not None else None
                    )
                    self._actor_sites[key] = int(target) if target is not None else -1
        self.membership_epoch += 1
        # the replica extent is part of every grouping signature
        self._invalidate_plan("resize")

    # -- compaction -------------------------------------------------------------
    # The JAX runtime also drops the variable's boundary halo after a
    # reindex; the port has no partitioned mesh, so there is no halo.

    def _compaction_gates(self, verb: str, var_id: str, why_converged: str,
                          why_triggers: str) -> None:
        """Divergence 0 (a dropped tombstone could otherwise come back from
        a divergent peer) and no trigger touching the variable (closures
        bake element indices in the old order); the messages are JAX's."""
        if self.divergence(var_id) != 0:
            raise RuntimeError(
                f"{verb}({var_id!r}): population not converged; "
                f"run_to_convergence first{why_converged}"
            )
        for _fn, touch, _b in self._triggers:
            if touch is None or var_id in touch:
                raise RuntimeError(
                    f"{verb}({var_id!r}): a registered trigger touches this "
                    f"variable {why_triggers}"
                )

    def compact_orset(self, var_id: str) -> int:
        """Reclaim the element slots of fully tombstoned OR-Set entries
        across the whole population (the reclamation the reference's
        ``waste_pct`` stat cues, ``src/lasp_orset.erl:178-191``). Requires
        divergence 0: every row is then identical, so one reindex of every
        row keeps them equivalent. A packed population is unpacked, reindexed
        and packed again. Returns slots reclaimed."""
        self._compaction_gates(
            "compact_orset", var_id,
            " (a dropped tombstone could be resurrected by a divergent peer)",
            "— trigger closures typically hold element indices baked in the "
            "OLD order (intern_terms results), which compaction reassigns",
        )
        var = self.store.variable(var_id)
        dense = self._to_dense_row(var_id, self.states[var_id])
        # the converged population is the authority
        row0 = tree_map(lambda x: x[0], dense)
        order, fresh = self.store.compact_plan(var_id, state=row0)
        reclaimed = len(var.elems) - len(fresh)
        if not reclaimed:
            return 0
        var.state = self.store.reindex_orset_state(var.state, order)
        dense = self.store.reindex_orset_state(dense, order)
        self.states[var_id] = self._from_dense_row(var_id, dense)
        var.elems = fresh
        # projection tables follow the element order
        self.graph.refresh()
        return reclaimed

    def compact_map_field(self, var_id: str, key) -> int:
        """Population-wide :meth:`Store.compact_map_field`: reclaim one
        OR-Set field's fully tombstoned element slots in every replica row
        (``key`` a field key or a path into nested submaps), under the
        :meth:`compact_orset` gates. Maps are never packed, so the planes
        reindex where they lie. Returns slots reclaimed."""
        self._compaction_gates(
            "compact_map_field", var_id, "",
            "(closures bake element orders)",
        )
        var = self.store.variable(var_id)
        states = self._population(var_id)
        row0 = tree_map(lambda x: x[0], states)
        idxs, shim, order, fresh = self.store.compact_map_plan(
            var_id, key, state=row0
        )
        reclaimed = len(shim.elems) - len(fresh)
        if not reclaimed:
            return 0
        leaf_of = self.store._nested_field
        var.state = self.store._replace_nested_field(
            var.codec, var.spec, var.state, idxs,
            self.store.reindex_orset_state(leaf_of(var.state, idxs), order),
        )
        self.states[var_id] = self.store._replace_nested_field(
            var.codec, var.spec, states, idxs,
            self.store.reindex_orset_state(leaf_of(states, idxs), order),
        )
        shim.elems = fresh
        return reclaimed

    @contextlib.contextmanager
    def compaction_window(self, max_rounds: int = 10_000, edge_mask=None,
                          block: int = 32):
        """Stop-the-world tombstone reclamation for a population with
        registered triggers, which :meth:`compact_orset`'s gates otherwise
        refuse. Entering requires every trigger to be builder-backed (a
        plain fn may hold element indices in the old order), quiesces the
        triggers and runs the engine to its fixed point (the divergence-0
        gate). The body compacts what it likes. On exit, error or not, the
        builders run again so the closures re-intern against the compacted
        order; a trigger whose builder fails is dropped, loudly. Triggers
        registered inside the body are kept. The port compiles no step, so
        there is no step cache to drop."""
        for _fn, _touch, b in self._triggers:
            if b is None:
                raise RuntimeError(
                    "compaction_window: a registered trigger has no "
                    "builder — register it with register_trigger("
                    "builder=...) so it can be rebuilt against the "
                    "compacted element order"
                )
        saved = list(self._triggers)
        self._triggers = []
        body_ok = False
        try:
            self.run_to_convergence(
                max_rounds=max_rounds, edge_mask=edge_mask, block=block
            )
            yield self
            body_ok = True
        finally:
            rebuilt, failures = [], []
            for _f, touch, b in saved:
                try:
                    built = b()
                    if not callable(built):
                        raise TypeError(
                            f"trigger builder returned {built!r}, not a "
                            "callable"
                        )
                    rebuilt.append((built, touch, b))
                except Exception as exc:  # reported below
                    failures.append((b, exc))
            self._triggers = rebuilt + self._triggers
            if failures:
                # a failed builder's old closure holds pre-compaction
                # indices: the trigger is dropped. Raising here would mask
                # the body's own exception, so only a clean body raises.
                msg = (
                    "compaction_window: trigger rebuild failed for "
                    f"{len(failures)} builder(s); those triggers were "
                    f"DROPPED (first error: {failures[0][1]!r})"
                )
                if body_ok:
                    raise RuntimeError(msg) from failures[0][1]
                print(f"lasp_tpu_torch: {msg}", file=sys.stderr)

    def read_at(self, replica: int, var_id: str, threshold=None):
        """Non-blocking threshold check against one replica's row (the
        vnode-local read, ``src/lasp_vnode.erl:402-407``): the dense row
        state when the threshold is met, else None."""
        var = self.store.variable(var_id)
        thr = self._device_threshold(self.store._resolve_threshold(var, threshold))
        row = self._to_dense_row(
            var_id, tree_map(lambda x: x[replica], self._population(var_id))
        )
        if bool(var.codec.threshold_met(var.spec, row, thr)):
            return row
        return None

    def _device_threshold(self, thr):
        """A resolved threshold with its state on the runtime's device (a
        numeric bound as a 0-d tensor, copied once rather than at every
        check)."""
        if isinstance(thr.state, tuple):
            return thr._replace(state=tree_map(lambda x: x.to(self.device), thr.state))
        if isinstance(thr.state, (int, np.integer)):
            return thr._replace(state=torch.as_tensor(thr.state, device=self.device))
        return thr

    def read_until(self, replica: int, var_id: str, threshold=None,
                   max_rounds: int = 10_000, edge_mask=None, block: int = 1,
                   on_device: "bool | None" = None):
        """Blocking monotonic threshold read (``lasp:read/2`` semantics,
        ``src/lasp_core.erl:329-364``): steps the mesh until the threshold
        is met at the given replica, then returns that replica's dense row.

        ``on_device`` (default ``None`` = auto) picks the wait:

        - **device-parked** (whenever the threshold state can ride to the
          device, which every codec threshold can): one round at a time,
          the predicate evaluated on the device at the replica's row, one
          int32 (the met index, quiescence or neither) crossing to the host
          a round and no row pulled; it stops on exactly the round that
          meets the threshold (eager PyTorch has no ``while_loop``, so this
          is the JAX device loop a round at a time);
        - **host-probed** (``on_device=False``, or an object-dtype
          threshold): rounds run in fused blocks of ``block`` between host
          probes of the row (the wake-up coarsens to the block; a
          threshold is monotonic, so later rounds never unmeet it).

        Once the population quiesces with the threshold unmet it can never
        be met, so the wait raises ``TimeoutError`` at once."""
        if on_device is None:
            var = self.store.variable(var_id)
            threshold = self.store._resolve_threshold(var, threshold)
            on_device = _device_expressible(threshold.state)
        if on_device:
            return self._read_until_on_device(
                replica, var_id, threshold, max_rounds, edge_mask
            )
        row, rounds, quiescent = self._step_until(
            lambda: self.read_at(replica, var_id, threshold),
            max_rounds, edge_mask, block,
        )
        if row is not None:
            return row
        raise TimeoutError(
            f"threshold not met at replica {replica} within {rounds} rounds"
            + (" (population quiescent: the threshold is unreachable)"
               if quiescent else "")
        )

    def _step_until(self, probe, max_rounds, edge_mask, block):
        """The host-probed loop of the blocking reads: rounds (in fused
        blocks when ``block > 1``, single steps for a remainder) until
        ``probe()`` returns non-None, the population quiesces, or the budget
        is spent. Returns ``(probe_result, rounds, quiescent)``, the
        quiescent round counted."""
        rounds, quiescent = 0, False
        while rounds < max_rounds:
            hit = probe()
            if hit is not None:
                return hit, rounds, quiescent
            if block > 1 and max_rounds - rounds >= block:
                at = self.fused_steps(block, edge_mask)
                quiescent = at >= 0
                rounds += at + 1 if quiescent else block
            else:
                quiescent = self.step(edge_mask) == 0
                rounds += 1
            if quiescent:
                break
        return probe(), rounds, quiescent

    def read_any_until(self, replica: int, reads, max_rounds: int = 10_000,
                       edge_mask=None, block: int = 1,
                       on_device: "bool | None" = None):
        """First-match-wins blocking read over ``[(var_id, threshold),
        ...]`` at one replica (``lasp:read_any/1``,
        ``src/lasp_core.erl:369-420``): steps the population until any
        listed threshold is met and returns ``(var_id, row)`` of the first
        (list order breaks a same-round tie). Raises ``TimeoutError`` at
        once when the population quiesces with every threshold unmet.
        ``on_device`` as in :meth:`read_until`."""
        reads = list(reads)  # probed every round: an iterator would drain
        if not reads:
            raise ValueError("read_any_until needs at least one read")
        if on_device is None:
            reads = [
                (v, self.store._resolve_threshold(self.store.variable(v), t))
                for v, t in reads
            ]
            on_device = all(_device_expressible(t.state) for _v, t in reads)
        if on_device:
            return self._read_any_until_on_device(
                replica, reads, max_rounds, edge_mask
            )

        def probe():
            for var_id, threshold in reads:
                row = self.read_at(replica, var_id, threshold)
                if row is not None:
                    return var_id, row
            return None

        hit, rounds, quiescent = self._step_until(probe, max_rounds, edge_mask, block)
        if hit is not None:
            return hit
        raise TimeoutError(
            f"no threshold met at replica {replica} within {rounds} rounds"
            + (" (population quiescent: none is reachable)" if quiescent else "")
        )

    def _wait_status(self, replica: int, metas, quiescent) -> torch.Tensor:
        """The device wait's one int32 a round: the index of the first
        listed threshold met at the replica's row, else ``n`` when the
        round was quiescent (``quiescent``: a 0-d bool), else ``n + 1``."""
        flags = [
            codec.threshold_met(
                spec,
                self._to_dense_row(v, tree_map(lambda x: x[replica], self.states[v])),
                thr,
            ).reshape(1)
            for v, codec, spec, thr in metas
        ]
        always = torch.ones((1,), dtype=torch.bool, device=self.device)
        # argmax returns the first maximum: the first met read wins
        return torch.argmax(torch.cat(flags + [quiescent.reshape(1), always]).to(torch.uint8))

    def _read_any_until_on_device(self, replica, reads, max_rounds, edge_mask):
        """The device-parked wait (JAX's ``lax.while_loop``) one round at a
        time: exit code 0 (met), 1 (budget spent) or 2 (quiescent unmet),
        the round count, the ``max_rounds < 1`` probe-once idiom, the int32
        exit-protocol guard, the host re-check of a device "met" and one
        ``round_residuals`` entry (0 if met, else -1)."""
        if max_rounds < 1:
            # the host loop's max_rounds=0 idiom: probe once, never step
            for var_id, threshold in reads:
                row = self.read_at(replica, var_id, threshold)
                if row is not None:
                    return var_id, row
            raise TimeoutError(
                f"no threshold met at replica {replica} within 0 rounds"
                if len(reads) > 1 else
                f"threshold not met at replica {replica} within 0 rounds"
            )
        if (max_rounds + 1) * 4 * len(reads) >= 2**31:
            # JAX packs (rounds * 4 + code) * n_reads + which into one
            # int32; the port keeps its bound so both refuse the same calls
            raise ValueError(
                f"max_rounds={max_rounds} with {len(reads)} reads "
                "overflows the device wait's int32 exit protocol — "
                "lower max_rounds or split the read list"
            )
        for var_id, _t in reads:
            self._population(var_id)  # sync in late-declared variables
        resolved = [
            (v, self.store._resolve_threshold(self.store.variable(v), t))
            for v, t in reads
        ]
        metas = [
            (v, self.store.variable(v).codec, self.store.variable(v).spec,
             self._device_threshold(t))
            for v, t in resolved
        ]
        tables = self._ensure_step()
        self._frontier_sync_mask(edge_mask)
        n_reads = len(resolved)
        states_in = dict(self.states)
        rounds = 0
        try:
            status = int(self._wait_status(
                replica, metas, torch.zeros((), dtype=torch.bool, device=self.device)
            ))
            while status == n_reads + 1 and rounds < max_rounds:
                residual = self._dense_round(edge_mask, tables).sum()
                rounds += 1
                status = int(self._wait_status(replica, metas, residual == 0))
        except Exception:
            self._restore_states(states_in)
            raise
        code = 0 if status < n_reads else (2 if status == n_reads else 1)
        if rounds > 0 or code == 2:
            self._frontier_after_opaque(code == 2)
        self.round_residuals.append(0 if code == 0 else -1)
        verb = "read_until" if n_reads == 1 else "read_any_until"
        if code == 0:
            var_id, thr = resolved[status]
            row = self.read_at(replica, var_id, thr)
            if row is None:
                # met on the device must be met on the host
                raise RuntimeError(
                    f"{verb}({var_id!r}): device wait reported the "
                    "threshold met but the host re-check disagrees — "
                    "device/host threshold predicate mismatch"
                )
            return var_id, row
        if n_reads == 1:
            raise TimeoutError(
                f"threshold not met at replica {replica} within {rounds} rounds"
                + (" (population quiescent: the threshold is unreachable)"
                   if code == 2 else "")
            )
        raise TimeoutError(
            f"no threshold met at replica {replica} within {rounds} rounds"
            + (" (population quiescent: none is reachable)" if code == 2 else "")
        )

    def _read_until_on_device(self, replica, var_id, threshold, max_rounds,
                              edge_mask):
        """The single-threshold device wait: the n=1 case of
        :meth:`_read_any_until_on_device`."""
        _v, row = self._read_any_until_on_device(
            replica, [(var_id, threshold)], max_rounds, edge_mask
        )
        return row
