"""Elastic membership (port of ``lasp_tpu.membership``): the claim rule,
the row-scoped frontier degrade and the typed errors. The staged
coordinator is a later slice."""

from .errors import HandoffPartitionError, StaleEpochError
from .plan import changed_delivery_rows, claim_row, claim_targets, seed_sources

__all__ = [
    "HandoffPartitionError",
    "StaleEpochError",
    "changed_delivery_rows",
    "claim_row",
    "claim_targets",
    "seed_sources",
]
