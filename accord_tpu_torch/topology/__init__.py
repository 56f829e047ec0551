from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.topology.topology import Topology
from accord_tpu_torch.topology.topologies import Topologies
from accord_tpu_torch.topology.manager import TopologyManager

__all__ = ["Shard", "Topology", "Topologies", "TopologyManager"]
