"""Home-shard gossip: existence and durability notifications.

Role-equivalent to the reference's InformOfTxnId / InformDurable /
InformHomeDurable (messages/InformOfTxnId.java:29, InformDurable.java:39,
InformHomeDurable.java, senders coordinate/Persist.java:88,
coordinate/InformHomeOfTxn.java:55, coordinate/MaybeRecover.java:109): the
home shard owns each transaction's liveness, so

  - a non-home replica stuck with an UNDECIDED command tells the home shard
    the txn exists (InformOfTxnId) instead of racing its own recovery,
  - the coordinator broadcasts majority-durability once Apply reaches a
    quorum (InformDurable), so progress engines stop treating the txn as
    recovery work, and
  - a probe that discovers a durable outcome forwards that knowledge to the
    home shard (InformHomeDurable), whose engine may be probing redundantly.
"""
from __future__ import annotations

from typing import Optional

from accord_tpu_torch.local.status import Durability, Status
from accord_tpu_torch.messages.base import Reply, Request, SimpleReply
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId


class InformOfTxnId(Request):
    """Tell the home shard a txn exists (reference InformOfTxnId.java:29):
    home stores witness the command (record + route) and register it with
    their progress engine, which then drives recovery for it."""

    def __init__(self, txn_id: TxnId, route: Route):
        self.txn_id = txn_id
        self.route = route
        self.wait_for_epoch = txn_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        node.counters["inform_of_txn_received"] += 1
        handled = False
        for store in node.command_stores.all():
            if not store.ranges.contains_key(self.route.home_key):
                continue
            if not store.current_owned().contains_key(self.route.home_key):
                continue
            if store.is_truncated(self.txn_id, self.route.participants):
                handled = True
                continue
            cmd = store.command(self.txn_id)
            if cmd.route is None:
                cmd.route = self.route
            if not cmd.has_been(Status.PRE_ACCEPTED):
                # reference Commands.informHome: witness without status
                # change; the progress engine takes it from here
                store.progress_log.informed_of_txn(cmd)
            handled = True
        node.reply(from_node, reply_context,
                   SimpleReply.OK if handled else SimpleReply.NACK)

    def __repr__(self):
        return f"InformOfTxnId({self.txn_id!r})"


class InformDurable(Request):
    """Durability gossip from the persist path (reference InformDurable.java:39,
    sent by Persist.java:88 on the applied quorum): every replica of the
    route records that the outcome is durable at `durability`, so progress
    engines treat the txn as fetch-only work, never recovery work."""

    def __init__(self, txn_id: TxnId, route: Route,
                 execute_at: Optional[Timestamp], durability: Durability):
        self.txn_id = txn_id
        self.route = route
        self.execute_at = execute_at
        self.durability = durability
        self.wait_for_epoch = txn_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        node.counters["inform_durable_received"] += 1
        for store in node.command_stores.all():
            if not store.current_owned().intersects(self.route.participants):
                continue
            cmd = store.command_if_present(self.txn_id)
            if cmd is None:
                # never resurrect a blank record just to store a bit: absent
                # records have no tracked entry, so nothing would consume it
                continue
            if cmd.status == Status.TRUNCATED:
                continue
            if cmd.route is None:
                cmd.route = self.route
            cmd.durability = cmd.durability.merge(self.durability)
        node.reply(from_node, reply_context, SimpleReply.OK)

    def __repr__(self):
        return f"InformDurable({self.txn_id!r}, {self.durability.name})"


class InformHomeDurable(Request):
    """Fire-and-forget durability report addressed to the home shard
    (reference InformHomeDurable.java): a replica/probe that learned the
    outcome is durable forwards it so the home engine stops driving."""

    def __init__(self, txn_id: TxnId, route: Route,
                 execute_at: Optional[Timestamp], durability: Durability):
        self.txn_id = txn_id
        self.route = route
        self.execute_at = execute_at
        self.durability = durability
        self.wait_for_epoch = txn_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        node.counters["inform_home_durable_received"] += 1
        for store in node.command_stores.all():
            if not store.ranges.contains_key(self.route.home_key) \
                    or not store.current_owned().contains_key(
                        self.route.home_key):
                continue
            cmd = store.command_if_present(self.txn_id)
            if cmd is None or cmd.status == Status.TRUNCATED:
                continue
            if cmd.route is None:
                cmd.route = self.route
            cmd.durability = cmd.durability.merge(self.durability)
        # no reply: fire-and-forget (reference sends no ack either)

    def __repr__(self):
        return f"InformHomeDurable({self.txn_id!r}, {self.durability.name})"
