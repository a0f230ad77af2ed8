"""Elastic cluster subsystem: membership gossip, epoch-fenced failover,
and live shard reassignment.

Reference: the reference FiloDB is a peer-to-peer cluster — Akka Cluster
gossip deathwatch feeds ShardManager auto-reassignment, shard ownership
moves between nodes on failure, and queries route around known-bad time
windows to a buddy cluster (FailureProvider/PromQlExec, SURVEY §5
"Failure detection / elastic recovery"). Here the same story is built
from the framework's own parts:

  * :mod:`membership` — heartbeat/health gossip over the broker wire
    framing, alive→suspect→dead with COUNTED (not timed) suspicion and a
    seeded deterministic probe schedule, so FaultPlan drives failure
    scenarios without wall-clock luck;
  * :mod:`epoch` — monotonic leadership epochs fencing broker-partition
    writers (file-persisted sidecars) and store-ring shard writers
    (persisted to the durable ring), closing the PR 6 "leadership is
    convention, not fenced" known limit;
  * :mod:`gossip` — the ``OP_GOSSIP``-family wire ops (gossip digest
    exchange, epoch read/claim/announce, REJOIN log sync) shared by the
    broker tier and the standalone membership agent;
  * live shard rebalance — flush→handoff→catch-up→cutover orchestration
    lives on :class:`~filodb_tpu_torch.standalone.FiloServer`
    (``rebalance_shard`` / ``adopt_shard``), epoch-fenced so exactly one
    owner ever ingests a moving shard.
"""

from .epoch import (EPOCH_DATASET, FencedWriteError, PartitionEpochs,
                    StoreFence)
from .gossip import (CLUSTER_OPS, OP_EPOCH_LEAD, OP_EPOCH_READ, OP_EPOCH_SET,
                     OP_GOSSIP, OP_SYNC, ClusterError, ClusterLink,
                     GossipServer, serve_cluster)
from .membership import (DEAD, SUSPECT, ALIVE, GossipAgent, MembershipTable)

__all__ = [
    "EPOCH_DATASET", "FencedWriteError", "PartitionEpochs", "StoreFence",
    "CLUSTER_OPS", "OP_GOSSIP", "OP_EPOCH_READ", "OP_EPOCH_LEAD",
    "OP_EPOCH_SET", "OP_SYNC", "ClusterError", "ClusterLink", "GossipServer",
    "serve_cluster", "ALIVE", "SUSPECT", "DEAD", "GossipAgent",
    "MembershipTable",
]
