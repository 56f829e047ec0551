"""L9: deterministic whole-cluster simulation harness.

Role-equivalent to the reference's burn-test infrastructure
(accord-core/src/test/java/accord/{burn,impl/basic,impl/list,verify}): an
entire multi-node cluster -- network, clocks, executors, storage -- runs as a
single-threaded, seed-keyed event loop, so every run is bit-for-bit
replayable and strict serializability can be checked against a model store.
"""
from accord_tpu_torch.sim.queue import PendingQueue
from accord_tpu_torch.sim.cluster import Cluster, ClusterConfig

__all__ = ["PendingQueue", "Cluster", "ClusterConfig"]
