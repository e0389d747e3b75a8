"""Membership plans: the claim rule and the row-scoped frontier degrade (a
numpy-only copy of the functions of ``lasp_tpu.membership.plan``; the tests
hold their outputs ``np.array_equal`` to the originals).

- :func:`claim_row` / :func:`claim_targets`: a departing row hands its
  state to the ring-fold successor ``row % new_n``
  (``ReplicatedRuntime.resize``'s graceful leave);
- :func:`seed_sources`: a joining row's claim predecessor ``row % old_n``;
- :func:`changed_delivery_rows`: the rows whose state must be re-delivered
  under a new neighbour table (``membership_grow(dirty_rows=...)``).

``MembershipStaging`` / ``MembershipPlan`` and the coordinator are a later
slice.
"""

from __future__ import annotations

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


__all__ = ["changed_delivery_rows", "claim_row", "claim_targets", "seed_sources"]
