"""Chaos mesh (port of ``lasp_tpu.chaos``): deterministic fault injection,
crash/recovery, and convergence-under-failure invariants.

- :mod:`.schedule` — seeded fault timelines (:class:`ChaosSchedule`, the
  event vocabulary, the :func:`nemesis` presets) that compile per round
  into the ``bool[R, K]`` edge masks the gossip rounds accept; a copy of
  the JAX package's numpy module, mask for mask;
- :mod:`.engine` — :class:`ChaosRuntime`, wrapping a
  ``ReplicatedRuntime`` with crash/restore row surgery, degraded quorum
  reads + read-repair partial joins, fused mask windows and the
  :meth:`~ChaosRuntime.soak` driver;
- :mod:`.invariants` — the harness asserting monotone inflation,
  post-heal bit-equality with a fault-free run, replay determinism, no
  resurrection, (with the quorum layer) no acknowledged write lost, and
  (with an AAE scrubber) corruption detected, localized and repaired.
"""

from .engine import ChaosRuntime, ReplicaDownError
from .invariants import (
    InvariantViolation,
    check_corruption_detected_and_repaired,
    check_inflation,
    check_no_resurrection,
    check_no_write_lost,
    fingerprint,
    run_aae_harness,
    run_harness,
    run_quorum_harness,
    snapshot_states,
    states_equal,
)
from .schedule import (
    CORRUPTION_KINDS,
    CORRUPTION_PRESETS,
    PRESETS,
    BitRot,
    ChaosSchedule,
    CorruptRows,
    Crash,
    DelayLinks,
    DuplicateLinks,
    FlakyLinks,
    Partition,
    Restore,
    SlowShard,
    nemesis,
)

__all__ = [
    "CORRUPTION_KINDS",
    "CORRUPTION_PRESETS",
    "PRESETS",
    "BitRot",
    "ChaosRuntime",
    "ChaosSchedule",
    "CorruptRows",
    "Crash",
    "DelayLinks",
    "DuplicateLinks",
    "FlakyLinks",
    "InvariantViolation",
    "Partition",
    "ReplicaDownError",
    "Restore",
    "SlowShard",
    "check_corruption_detected_and_repaired",
    "check_inflation",
    "check_no_resurrection",
    "check_no_write_lost",
    "fingerprint",
    "nemesis",
    "run_aae_harness",
    "run_harness",
    "run_quorum_harness",
    "snapshot_states",
    "states_equal",
]
