"""Staged membership plans: join/leave/down -> plan -> commit (a
numpy-only copy of ``lasp_tpu.membership.plan``; the tests hold its outputs
equal to the originals).

- :func:`claim_row` / :func:`claim_targets`: a departing row hands its
  state to the ring-fold successor ``row % new_n``
  (``ReplicatedRuntime.resize``'s graceful leave);
- :func:`seed_sources`: a joining row's claim predecessor ``row % old_n``;
- :func:`changed_delivery_rows`: the rows whose state must be re-delivered
  under a new neighbour table (``membership_grow(dirty_rows=...)``);
- :class:`MembershipStaging` / :class:`MembershipPlan`: the staged command
  set and the immutable plan a commit executes
  (``coordinator.MembershipCoordinator`` owns commit / step / finalize).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def claim_row(row: int, new_n: int) -> int:
    """The claim successor of ONE departed row: the one definition of the
    claim rule."""
    return int(row) % int(new_n)


def claim_targets(old_n: int, new_n: int) -> np.ndarray:
    """``int64[old_n - new_n]``: the claim successor of each departing row
    ``new_n + i``, the ring fold ``row % new_n``."""
    if not 0 < new_n < old_n:
        raise ValueError(
            f"claim_targets: need 0 < new_n < old_n, got "
            f"new_n={new_n}, old_n={old_n}"
        )
    return np.asarray(
        [claim_row(r, new_n) for r in range(new_n, old_n)], dtype=np.int64
    )


def seed_sources(old_n: int, new_n: int) -> np.ndarray:
    """``int64[new_n - old_n]``: the seed source of each joining row
    ``old_n + i``, its claim predecessor ``row % old_n``."""
    if not 0 < old_n < new_n:
        raise ValueError(
            f"seed_sources: need 0 < old_n < new_n, got "
            f"old_n={old_n}, new_n={new_n}"
        )
    return np.arange(old_n, new_n, dtype=np.int64) % old_n


def changed_delivery_rows(old_neighbors, new_neighbors,
                          old_n: int, new_n: int) -> np.ndarray:
    """Rows whose state must be RE-DELIVERED under the new neighbour table:
    every new row (``>= old_n``), and every row ``j`` that some row ``i``'s
    new pull list references but its old one did not. Surviving pairs keep
    their delivery knowledge."""
    old = np.asarray(old_neighbors)
    new = np.asarray(new_neighbors)
    dirty = np.zeros(new_n, dtype=bool)
    dirty[old_n:] = True  # grow: new rows (no-op slice on shrink)
    keep = min(old_n, new_n)
    if keep and new.shape[0] >= keep:
        # was new[i, k] referenced by old[i, :]? [keep, K_new]
        seen = (new[:keep, :, None] == old[:keep, None, :]).any(axis=-1)
        fresh_refs = new[:keep][~seen]
        fresh_refs = fresh_refs[fresh_refs < new_n]
        dirty[fresh_refs] = True
    for i in range(keep, new.shape[0]):
        # a new row's every pull source is newly referenced
        refs = new[i][new[i] < new_n]
        dirty[refs] = True
    return np.flatnonzero(dirty).astype(np.int64)


@dataclasses.dataclass(frozen=True, eq=False)
class MembershipPlan:
    """One computed membership transition — what a ``commit`` executes.

    ``kind``: ``"join"`` (grow + seed transfers), ``"leave"`` (transfer
    schedule then tail drop), ``"down"`` (immediate crash-drop, no
    transfers). ``epoch`` is the membership epoch the commit will
    advance the runtime to; ``transfers`` is the deterministic
    ``((source_row, target_row), ...)`` schedule; ``dirty_rows`` the
    row-scoped frontier degrade (:func:`changed_delivery_rows`)."""

    kind: str
    old_n: int
    new_n: int
    epoch: int
    new_neighbors: np.ndarray
    transfers: tuple
    dirty_rows: "np.ndarray | None"

    def describe(self) -> dict:
        """Plain-data plan summary — the console's ``plan`` output
        (CLI / harness / artifact embedding)."""
        return {
            "kind": self.kind,
            "old_n": self.old_n,
            "new_n": self.new_n,
            "epoch": self.epoch,
            "transfers": [[int(s), int(d)] for s, d in self.transfers],
            "dirty_rows": (
                None if self.dirty_rows is None
                else [int(r) for r in self.dirty_rows]
            ),
        }


class MembershipStaging:
    """The console's staging area: accumulate join/leave/down commands,
    then :meth:`plan` collapses them into one :class:`MembershipPlan`.

    Commands chain (stage_join(12) then stage_join(16) plans one 8→16
    transition); opposite directions in one staging area are refused —
    commit the first plan before reversing (the riak_core console's
    one-direction-per-plan discipline, kept honest rather than silently
    net-ing out)."""

    def __init__(self, runtime):
        self.rt = runtime
        self._kind: "str | None" = None
        self._target_n: "int | None" = None
        self._neighbors = None

    def _stage(self, kind: str, new_n: int, new_neighbors) -> None:
        new_n = int(new_n)
        base = self._target_n if self._target_n is not None \
            else self.rt.n_replicas
        if kind == "join" and new_n <= base:
            raise ValueError(
                f"stage_join({new_n}): population is already {base}"
            )
        if kind in ("leave", "down") and not 0 < new_n < base:
            raise ValueError(
                f"stage_{kind}({new_n}): need 0 < new_n < {base}"
            )
        if self._kind is not None and self._kind != kind:
            raise ValueError(
                f"a {self._kind!r} plan is already staged — commit (or "
                f"clear) it before staging {kind!r} (one direction per "
                "plan)"
            )
        self._kind = kind
        self._target_n = new_n
        self._neighbors = new_neighbors

    def stage_join(self, new_n: int, new_neighbors=None) -> None:
        self._stage("join", new_n, new_neighbors)

    def stage_leave(self, new_n: int, new_neighbors=None) -> None:
        self._stage("leave", new_n, new_neighbors)

    def stage_down(self, new_n: int, new_neighbors=None) -> None:
        self._stage("down", new_n, new_neighbors)

    def clear(self) -> None:
        self._kind = None
        self._target_n = None
        self._neighbors = None

    @property
    def staged(self) -> bool:
        return self._kind is not None

    def plan(self) -> MembershipPlan:
        """Compute the plan of the staged commands against the CURRENT
        population (claim table, transfer schedule, row-scoped frontier
        set, target epoch). Pure — staging stays intact until
        :meth:`clear` / the coordinator's commit."""
        if self._kind is None:
            raise ValueError("nothing staged — stage_join/leave/down first")
        old_n = self.rt.n_replicas
        new_n = self._target_n
        nbrs = self._neighbors
        if nbrs is None:
            from ..mesh.topology import ring

            nbrs = ring(new_n, max(2, self.rt._host_neighbors.shape[1]))
        nbrs = np.asarray(nbrs)
        if self._kind == "join":
            transfers = tuple(
                (int(s), int(d))
                for s, d in zip(seed_sources(old_n, new_n),
                                range(old_n, new_n))
            )
        elif self._kind == "leave":
            transfers = tuple(
                (int(s), int(d))
                for s, d in zip(range(new_n, old_n),
                                claim_targets(old_n, new_n))
            )
        else:  # down: crash semantics, nothing to transfer
            transfers = ()
        dirty = changed_delivery_rows(
            self.rt._host_neighbors, nbrs, old_n, new_n
        )
        return MembershipPlan(
            kind=self._kind,
            old_n=old_n,
            new_n=new_n,
            epoch=self.rt.membership_epoch + 1,
            new_neighbors=nbrs,
            transfers=transfers,
            dirty_rows=dirty,
        )


__all__ = [
    "MembershipPlan",
    "MembershipStaging",
    "changed_delivery_rows",
    "claim_row",
    "claim_targets",
    "seed_sources",
]
