"""Epoch-sync gossip.

Role-equivalent to the reference's ConfigurationService epoch-sync
acknowledgements (api/ConfigurationService.java Listener.onEpochSyncComplete +
TopologyManager.onEpochSyncComplete): a node announces it has locally synced
an epoch (stores updated, added ranges bootstrapped); receivers record the
ack, and once a quorum of every prior-epoch shard has acked, the epoch is
synced -- coordinations stop contacting the superseded replica sets.
"""
from __future__ import annotations

from accord_tpu_torch.messages.base import Reply, Request, SimpleReply
from accord_tpu_torch.primitives.timestamp import NodeId


class EpochSyncComplete(Request):
    def __init__(self, node_id: NodeId, epoch: int):
        self.node_id = node_id
        self.epoch = epoch
        self.wait_for_epoch = epoch

    @property
    def has_side_effects(self) -> bool:
        return True  # sync state must survive a restart

    def process(self, node, from_node, reply_context) -> None:
        node.topology_manager.on_epoch_sync_complete(self.node_id, self.epoch)
        node.reply(from_node, reply_context, SimpleReply.OK)

    def __repr__(self):
        return f"EpochSyncComplete(node={self.node_id}, epoch={self.epoch})"
