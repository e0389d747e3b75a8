"""Materialized 2i index views — the reference's one non-trivial program
(a copy of ``lasp_tpu.programs.riak_index``, numpy and hashlib only).

Rebuild of ``src/lasp_riak_index_program.erl`` (:59-176) and the
``lasp_transform`` parameterization machinery (``src/lasp_transform.erl:
32-128``): a riak_kv-style secondary-index materialized view over an
OR-Set, fed object-change notifications.

Semantics (reference lines in parentheses):

- on ``put``: remove any stale entries for the object's key (:67-68,
  remove-then-add), then add ``(key, metadata)`` keyed by a token DERIVED
  FROM THE COORDINATOR'S VCLOCK (:146-149) — the same logical write mints
  the same token on every replica, so cross-replica merges of the view
  are idempotent;
- a *total* index (no index name) indexes every object (:71-74); a
  *subset view* indexes only objects whose index specs carry a matching
  ``(add, name, value)`` entry (:75-89);
- the top-level index auto-registers one parameterized sub-view per index
  spec it observes (:92-98, ``create_views`` :162-176);
- on ``delete``: remove the key's entries (:102-104); ``handoff``
  (:105-107 is a TODO in the reference) RE-INDEXES idempotently — a
  handoff notification re-describes an object whose entries the
  receiving instance may never have seen, so a key with NO live entry
  takes the put path and an already-indexed key is left untouched (a
  handoff frame carries no ordering authority; the vclock-derived
  token keeps the replay merge-idempotent);
- ``execute`` streams the set; ``value`` projects keys only (:117-121).

Where the reference needs a parse_transform + per-vnode recompilation to
stamp ``(module, index_name, index_value)`` into a copy of the source
(``src/lasp_transform.erl:111-128``, applied at ``src/lasp_vnode.erl:
294-331``) — because BEAM parameterizes code by generating modules — the
port (like the JAX package) parameterizes by CONSTRUCTION: a view is an instance of this
class with ``index_name``/``index_value`` set, registered under the same
derived name the reference would generate. No runtime compiler, same
many-instances-of-one-source capability.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional

from .base import Program

#: the reference's base module name; derived view names append -name-value
#: exactly like create_views' list_to_atom (:164-166)
BASE_NAME = "lasp_riak_index_program"


@dataclasses.dataclass(frozen=True)
class RiakObject:
    """The slice of a riak_object the program reads (:60-63): key, the
    coordinator's vclock, opaque metadata, and 2i index specs — an
    iterable of ``(op, index_name, index_value)`` tuples."""

    key: Any
    vclock: Any
    metadata: Any = None
    index_specs: tuple = ()


def view_name(index_name: str, index_value: str) -> str:
    return f"{BASE_NAME}-{index_name}-{index_value}"


class RiakIndexProgram(Program):
    type_name = "lasp_orset_gbtree"

    def __init__(
        self,
        index_name: Optional[str] = None,
        index_value: Optional[str] = None,
        n_elems: int = 64,
        token_space: int = 64,
        auto_views: bool = True,
    ):
        self.index_name = index_name
        self.index_value = index_value
        self.n_elems = n_elems
        self.token_space = token_space
        self.auto_views = auto_views
        self.id: Optional[str] = None

    @property
    def name(self) -> str:
        if self.index_name is None:
            return BASE_NAME
        return view_name(self.index_name, self.index_value)

    def init(self, session) -> None:
        # one accumulator OR-Set per instance, named like the generated
        # module (the normalize_to_binary'd Id of :53-55)
        self.id = session.declare(
            type=self.type_name,
            id=self.name,
            n_elems=self.n_elems,
            n_actors=1,
            tokens_per_actor=self.token_space,
        )

    # -- event hook ----------------------------------------------------------
    def process(self, session, object, reason, actor) -> None:
        obj = object if isinstance(object, RiakObject) else RiakObject(*object)
        # only additive specs create/select views (:168-173)
        specs = [s for s in obj.index_specs if s[0] == "add"]
        if reason == "put":
            self._remove_entries_for_key(session, obj.key, actor)
            if self.index_name is None:
                self._add_entry(session, obj, actor)
            else:
                for _op, name, value in specs:
                    if name == self.index_name and value == self.index_value:
                        self._add_entry(session, obj, actor)
            if self.index_name is None and self.auto_views:
                self._create_views(session, specs)
        elif reason == "delete":
            self._remove_entries_for_key(session, obj.key, actor)
        elif reason == "handoff":
            # ownership moved: the notification RE-DESCRIBES an object
            # the receiving instance may never have indexed (:105-107
            # leaves this as a TODO in the reference). Re-index
            # IDEMPOTENTLY, gated PER KEY: only a key with NO live
            # entry takes the put path. A key that already has an
            # opinion — this exact write, or any other version — is
            # left alone: the put path is the sole authority on
            # ordering, and a handoff frame carries none (running the
            # put path for a STALE re-description would remove the
            # newer live entry, whose tombstoned token then suppresses
            # every later replay — the entry would be unrecoverable).
            # Replaying the same handoff is a no-op (the key is now
            # indexed), and a handoff after a delete of the SAME write
            # stays deleted: the re-add lands on its own tombstoned
            # vclock-derived token.
            if not self._key_indexed(session, obj.key):
                self.process(session, obj, "put", actor)
        else:
            # an unrecognized reason is a caller bug (a misspelled verb
            # would otherwise drop the notification silently — an index
            # that quietly misses writes is worse than a crash)
            raise NotImplementedError(
                f"{self.name}: unsupported object-event reason {reason!r} "
                "(expected 'put', 'delete', or 'handoff')"
            )

    # -- results -------------------------------------------------------------
    def execute(self, session):
        """Live ``(key, metadata)`` entries. Stored elements additionally
        carry the full vclock digest (see :meth:`_add_entry`); it is an
        internal identity component, stripped here."""
        return {(key, metadata) for key, metadata, _digest in
                session.value(self.id)}

    def value(self, output):
        """Keys only, not metadata (:119-121)."""
        return {key for key, _metadata in output}

    # -- internals -----------------------------------------------------------
    def _key_indexed(self, session, key) -> bool:
        """Does the view hold ANY live entry for ``key``? The handoff
        idempotence gate: an indexed key already has an opinion (this
        version or another), and only the put path — which carries
        ordering authority — may replace it."""
        return any(e[0] == key for e in session.value(self.id))

    def _remove_entries_for_key(self, session, key, actor) -> None:
        """Remove every (key, *) entry currently in the view (:127-139)."""
        stale = [e for e in session.value(self.id) if e[0] == key]
        if stale:
            session.store.update(self.id, ("remove_all", stale), actor)

    def compact(self, session) -> int:
        """Reclaim element slots held by fully-tombstoned entries.

        Every distinct write interns a fresh ``(key, metadata, digest)``
        element, and remove-stale only tombstones tokens — so the element
        universe fills with dead entries over the view's lifetime (the
        ``waste_pct`` the reference reports but never reclaims,
        ``src/lasp_orset.erl:178-191``). Dropping an element row is safe
        because the view variable is program-private: under a single-store
        session nothing else holds its state, and under mesh delivery
        ``MeshSession``'s compact converges the population to divergence 0
        first, so the uniform reindex covers every replica row that could
        reintroduce the tombstones. (The one observable difference: a
        byte-identical
        replay of a write whose entry was deleted AND compacted re-indexes
        the key; without compaction the tombstone suppresses it.) Live
        rows are kept verbatim, including their tombstoned tokens.

        Returns the number of slots reclaimed."""
        return session.store.compact_orset(self.id)

    def _add_entry(self, session, obj: RiakObject, actor) -> None:
        """Entry keyed by the hashed coordinator vclock (:141-149), so the
        same logical write is idempotent across replicas while distinct
        writes never collide.

        The reference uses the raw 16-byte md5 as the OR-Set token; a
        dense token space is bounded, so folding the digest to
        ``% token_space`` alone would let two DIFFERENT vclocks collide
        (~1/token_space per delete/re-put cycle) — and a collision with a
        tombstoned token is silently suppressed by the merge gate
        (``src/lasp_orset.erl:128-134``), dropping an acknowledged write.
        Instead the FULL 128-bit digest rides in the element identity
        ``(key, metadata, digest)``: distinct writes occupy distinct
        element rows (fresh token planes, no cross-write collisions), and
        a byte-identical replay lands on the same element + token —
        idempotent, and still tombstone-suppressed after a delete, exactly
        like the reference."""
        from ..utils.interning import CapacityError

        digest = hashlib.md5(repr(obj.vclock).encode()).digest()
        token = int.from_bytes(digest[:8], "little") % self.token_space
        op = (
            "add_by_token",
            token,
            (obj.key, obj.metadata, int.from_bytes(digest, "little")),
        )
        try:
            session.store.update(self.id, op, actor)
        except CapacityError:
            # dead entries exhaust the universe over the view's lifetime;
            # reclaim them and retry — only a genuinely-full LIVE view
            # stays loud
            if self.compact(session) == 0:
                raise
            session.store.update(self.id, op, actor)

    def _create_views(self, session, specs) -> None:
        """Register one parameterized sub-view per observed index spec
        (:162-176). ``session.register`` is idempotent, mirroring the
        reference's fire-and-forget spawn ("if this fails ... it will be
        generated on the next write")."""
        for _op, name, value in specs:
            session.register(
                view_name(name, value),
                RiakIndexProgram,
                index_name=name,
                index_value=value,
                n_elems=self.n_elems,
                token_space=self.token_space,
                auto_views=False,
            )
