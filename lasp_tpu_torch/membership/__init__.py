"""Elastic membership (port of ``lasp_tpu.membership``): the claim rule and
the row-scoped frontier degrade. The staged coordinator is a later slice."""

from .plan import changed_delivery_rows, claim_row, claim_targets, seed_sources

__all__ = ["changed_delivery_rows", "claim_row", "claim_targets", "seed_sources"]
