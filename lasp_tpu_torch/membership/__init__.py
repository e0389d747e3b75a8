"""Epoch-fenced live membership (port of ``lasp_tpu.membership``): staged
join/leave/rebalance with vectorized ownership handoff.

- :mod:`.plan` — the claim rule, seed sources, the row-scoped frontier
  set, :class:`MembershipStaging` / :class:`MembershipPlan`;
- :mod:`.handoff` — :class:`HandoffEngine`: per-cycle-capped, chaos-aware
  transfer cycles, grouped by dispatch-plan signature;
- :mod:`.coordinator` — :class:`MembershipCoordinator`: stage -> plan ->
  commit -> interleaved rebalance -> finalize (idempotent sweep,
  crashed-departer hint fallback, serve watch re-homing);
- :mod:`.harness` — :func:`run_membership_harness`;
- :mod:`.errors` — :class:`StaleEpochError`, :class:`HandoffPartitionError`.
"""

from .errors import HandoffPartitionError, StaleEpochError
from .plan import (
    MembershipPlan,
    MembershipStaging,
    changed_delivery_rows,
    claim_row,
    claim_targets,
    seed_sources,
)

__all__ = [
    "HandoffEngine",
    "HandoffPartitionError",
    "MembershipCoordinator",
    "MembershipPlan",
    "MembershipStaging",
    "StaleEpochError",
    "changed_delivery_rows",
    "claim_row",
    "claim_targets",
    "grouped_transfer",
    "run_membership_harness",
    "seed_sources",
]

#: lazily resolved (PEP 562): the coordinator / handoff / harness pull in
#: the chaos and quorum machinery; the error types alone (the quorum
#: engine's fence) must import without a cycle
_LAZY = {
    "HandoffEngine": ("handoff", "HandoffEngine"),
    "grouped_transfer": ("handoff", "grouped_transfer"),
    "MembershipCoordinator": ("coordinator", "MembershipCoordinator"),
    "run_membership_harness": ("harness", "run_membership_harness"),
}


def __getattr__(name: str):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(name)
    import importlib

    mod = importlib.import_module(f".{entry[0]}", __name__)
    return getattr(mod, entry[1])
