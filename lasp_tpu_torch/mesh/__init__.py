"""Mesh layer: replication, gossip / anti-entropy, the dispatch plan and
reads over a leading replica axis, grouped ingest and the parked reads,
the mesh programs, and sharding over the shard slots of one device
(``comm``, ``shard_gossip``; port of ``lasp_tpu.mesh``)."""

from .gossip import (
    converged,
    divergence,
    frontier_reach,
    gossip_round,
    gossip_round_rows,
    join_all,
    quorum_read,
)
from .runtime import ActorCollisionError, FusedBlockHandle, ReplicatedRuntime
from .topology import (
    assert_symmetric_mask,
    edge_failure_mask,
    locality_order,
    partition_mask,
    random_regular,
    ring,
    scale_free,
    shard_cut_stats,
    symmetrize_edge_mask,
)

__all__ = [
    "ActorCollisionError",
    "FusedBlockHandle",
    "ReplicatedRuntime",
    "assert_symmetric_mask",
    "converged",
    "divergence",
    "edge_failure_mask",
    "frontier_reach",
    "gossip_round",
    "gossip_round_rows",
    "join_all",
    "locality_order",
    "partition_mask",
    "quorum_read",
    "random_regular",
    "ring",
    "scale_free",
    "shard_cut_stats",
    "symmetrize_edge_mask",
]
