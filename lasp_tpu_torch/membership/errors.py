"""Typed error surface of the membership layer (a copy of
``lasp_tpu.membership.errors``).

Both errors are import-light on purpose (numpy-free, jax-free): the
quorum engine, the chaos engine, and the serving front-end all raise or
catch them without pulling the membership machinery in."""

from __future__ import annotations


class StaleEpochError(RuntimeError):
    """An operation carried population-relative indices minted under an
    OLDER membership epoch than the runtime's current one — a quorum
    request whose preflist spans a ``resize``/staged commit, a coverage
    plan over a changed ring, a watch parked on a departed row. The
    riak_core analogue is ``{error, ring_changed}``: the caller must
    re-pick against the current ring, never silently read rows whose
    meaning changed (``mesh/runtime.py`` ``quorum_value``: a stale
    index after a resize would silently read the wrong quorum).

    Attributes: ``submitted_epoch`` (the epoch the indices were minted
    under), ``current_epoch`` (the runtime's epoch at detection)."""

    def __init__(self, message: str, *, submitted_epoch: int = -1,
                 current_epoch: int = -1):
        super().__init__(message)
        self.submitted_epoch = int(submitted_epoch)
        self.current_epoch = int(current_epoch)


class HandoffPartitionError(RuntimeError):
    """A graceful-leave handoff was refused because it would move state
    outside the coordinator's reachable component — merging a departing
    row across an active partition cut, or reading a crashed departer's
    frozen row. The host-side merge would be a side channel through the
    very cut the nemesis installed (the degraded-read confinement rule
    applied to membership). Recovery paths: wait for heal, run the
    staged ``MembershipCoordinator`` (whose transfers PARK until the
    pair is reachable), or take the crash-leave semantics explicitly
    (``graceful=False``)."""
