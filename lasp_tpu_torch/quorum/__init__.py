"""Vectorized quorum coordination (port of ``lasp_tpu.quorum``): the
reference's request FSMs (N=3, R=W=2, ``src/lasp_update_fsm.erl:174-216``,
``src/lasp_read_fsm.erl:125-146``) as a struct-of-arrays batch advanced by
one tensor step a round on the runtime's device, over the reachability the
chaos masks give.

- :mod:`.fsm` — state vocabulary, preflists, per-round component labels,
  the batched PyTorch transition and the sequential numpy reference;
- :mod:`.engine` — :class:`QuorumRuntime`: submit / step / drain over a
  ``ChaosRuntime``, read-repair and put replication as two-phase masked
  partial joins, timeouts, retries, the epoch fence and the report;
- :mod:`.hints` — the durable hint log behind hinted handoff on restore;
- :mod:`.coverage` — ring-coverage queries: ``coverage_sweep`` (grouped
  partition-sweep map-merge, one plan per dispatch-plan group) and
  ``ring_coverage_execute`` over the mesh programs. They need only the
  contiguous ``shard_rows`` blocks, never the sharded gossip.
"""

from .coverage import coverage_sweep, ring_coverage_execute

from ..membership.errors import StaleEpochError
from .engine import PartialQuorumError, QuorumRuntime
from .fsm import DONE, FAILED, PREPARE, REPAIR, STATE_NAMES, WAITING_N, WAITING_R
from .hints import HintLog

__all__ = [
    "QuorumRuntime",
    "PartialQuorumError",
    "StaleEpochError",
    "HintLog",
    "PREPARE",
    "WAITING_R",
    "WAITING_N",
    "REPAIR",
    "DONE",
    "FAILED",
    "STATE_NAMES",
    "coverage_sweep",
    "ring_coverage_execute",
]
