"""Sharded parameter-server fleet and the hierarchy's group tier.

Counterpart of `pytorch_ps_mpi_tpu/shard/`.  The single `AsyncPSServer`
owns the whole parameter tree: the ceiling on model size, fleet size and
request traffic.  This package partitions the tree across K PS shards (the
server-group design of Li et al., OSDI 2014), each shard a full
`AsyncPSServer` with its own version counter, quorum policy, robust
reducer, eviction bookkeeping and auto-checkpoint, and puts group-local
aggregators between the workers and the root:

* `partition` — rule-driven leaf→shard assignment with a size-balanced
  greedy fallback: the static `ShardPlan` both sides agree on at HELO
  time, and the `FleetManifest` of a coordinated snapshot;
* `router` — the worker-side multiplexer: one gradient a step, split into
  per-shard GRAD frames with per-shard versions;
* `fleet` — runs and supervises the K shards, with hot standbys promoted
  onto a dead shard's port, coordinated snapshots, and a dead shard
  restored from its own auto-checkpoint;
* `hierarchy` — `LocalAggregator` (a group's PS that reduces each fill
  and forwards one AGGR frame to the root, a single PS or a fleet),
  `GroupWorker` (redial, then direct fallback to the root) and
  `Hierarchy` (G aggregators supervised, a killed one restarted in place).
"""

from .fleet import PSFleet, fleet_manifest_path
from .hierarchy import GroupWorker, Hierarchy, LocalAggregator
from .partition import (FleetManifest, ShardInfo, ShardPlan,
                        build_shard_plan, match_partition_rules)
from .router import ShardRouter

__all__ = [
    "ShardPlan",
    "ShardInfo",
    "FleetManifest",
    "build_shard_plan",
    "match_partition_rules",
    "ShardRouter",
    "PSFleet",
    "fleet_manifest_path",
    "LocalAggregator",
    "GroupWorker",
    "Hierarchy",
]
