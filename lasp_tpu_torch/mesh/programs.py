"""Mesh-level program deployment (a copy of ``lasp_tpu.mesh.programs``): the
reference registers a program on
EVERY partition (``src/lasp_vnode.erl:276-366``), feeds each instance
object-change notifications targeted at one partition (PROCESS_R=1,
``src/lasp_process_fsm.erl:113-135``), and answers ``execute(global)`` by
merging every partition's accumulator CRDT with ``Type:merge`` before
applying ``Type:value`` + ``Module:value``
(``src/lasp_execute_coverage_fsm.erl:50-97``).

The port, as the JAX package: a program's accumulator variable is declared once in the
runtime's store and — like every variable — carries the replicated
``[R, ...]`` axis, which IS "registered on every partition" here. Event
delivery targets one replica row (``ReplicatedRuntime.process(...,
replica=r)``); the program's ``process`` callback then runs against a
:class:`MeshSession` whose reads/writes are bound to that row (the
vnode-local store view). ``execute`` rebinds the same adapter to coverage
mode, where ``value`` is the global join over the replica axis — the
coverage-FSM merge — before the program's own ``value`` filter.

Same-key discipline: the reference hashes a key to ONE partition, so every
event for a key reaches the same program instance — remove-then-add
sequences (the 2i index) rely on seeing their own earlier writes. Callers
here own that routing: deliver all events for one logical key to the same
replica row (e.g. ``zlib.crc32(key) % n_replicas``; Python's ``hash`` of a
string differs from process to process)."""

from __future__ import annotations

from typing import Any


class _StoreProxy:
    """The ``session.store`` facet programs write through
    (``session.store.update(id, op, actor)`` in
    ``programs/examples.py`` / ``programs/riak_index.py``)."""

    def __init__(self, session: "MeshSession"):
        self._session = session

    def update(self, var_id: str, op: tuple, actor) -> None:
        s = self._session
        if s.replica is None:
            raise RuntimeError(
                "programs may not write during a coverage execute "
                "(the reference's execute path is read-only too)"
            )
        s.runtime.update_at(s.replica, var_id, op, actor)

    def compact_orset(self, var_id: str) -> int:
        rt = self._session.runtime
        try:
            return rt.compact_orset(var_id)
        except RuntimeError:
            # mid-delivery the just-written row hasn't gossiped, so the
            # divergence-0 gate refuses; converge the population first —
            # monotone state exposure, safe during delivery — then retry.
            # A trigger-refusal re-raises from the second attempt. JAX
            # converges with dense rounds; the port takes the frontier
            # scheduler where the runtime supports it (``mode="auto"``: the
            # same rounds and states, only the dirty rows' work)
            rt.run_to_convergence(mode="auto")
            return rt.compact_orset(var_id)


class MeshSession:
    """The program-facing session surface over a ReplicatedRuntime.

    ``replica`` is the bound partition row during ``process`` delivery;
    ``None`` means coverage mode (``execute``), where reads join the whole
    population and writes are refused."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.replica: "int | None" = None
        #: replica subset for quorum-mode execute; None = full coverage
        self.quorum = None
        self.store = _StoreProxy(self)

    def declare(self, **kwargs) -> str:
        var_id = self.runtime.store.declare(**kwargs)
        # replicate the accumulator over the population NOW — register on
        # every partition, not on first use
        self.runtime._population(var_id)
        return var_id

    def value(self, var_id: str) -> Any:
        if self.replica is not None:
            return self.runtime.replica_value(var_id, self.replica)
        if self.quorum is not None:
            return self.runtime.quorum_value(var_id, self.quorum)
        return self.runtime.coverage_value(var_id)

    def register(self, name: str, program_cls, *args, **kwargs) -> str:
        """Programs registering programs (the index program's
        ``create_views``) land on the runtime registry."""
        return self.runtime.register(name, program_cls, *args, **kwargs)
