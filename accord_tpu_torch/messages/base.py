"""Message plumbing (reference: messages/Message.java, Request, Reply,
Callback/SafeCallback, messages/TxnRequest.java:42).

A Request is processed replica-side via `process(node, from_node, reply_ctx)`;
most fan out over the intersecting CommandStores with map-reduce and send one
Reply. `wait_for_epoch` defers processing until the replica knows the epoch.
"""
from __future__ import annotations

import enum
from typing import Optional


class Request:
    wait_for_epoch: int = 0

    def process(self, node, from_node: int, reply_context) -> None:
        raise NotImplementedError

    @property
    def has_side_effects(self) -> bool:
        """Whether a host journal must persist this message (reference:
        MessageType.hasSideEffects)."""
        return True


class Reply:
    pass


class SimpleReply(Reply, enum.Enum):
    OK = "ok"
    NACK = "nack"


class Callback:
    """Coordinator-side response handler for one round of requests
    (reference: messages/Callback.java)."""

    def on_success(self, from_node: int, reply: Reply) -> None:
        raise NotImplementedError

    def on_failure(self, from_node: int, failure: BaseException) -> None:
        raise NotImplementedError

    def on_slow_response(self, from_node: int) -> None:
        pass


class Timeout(RuntimeError):
    pass
