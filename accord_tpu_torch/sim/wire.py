"""The wire boundary: every simulated message round-trips through an explicit
encode/decode so nodes exchange VALUE copies, never live object references.

Role-equivalent to the serialization discipline the reference enforces via its
test Journal's reflection-diff and the maelstrom GSON codecs (test
impl/basic/Journal.java:59, accord-maelstrom Json.java): a whole class of
cross-node state-sharing bugs (one replica mutating an object another replica
also holds) is structurally impossible once messages are serialized. The codec
is pickle-based -- the sim needs a faithful value copy, not an interoperable
format; a production embedding supplies its own codec behind the same two
functions.
"""
from __future__ import annotations

import pickle


def encode(message) -> bytes:
    """Serialize a Request/Reply at send time (so mutation-after-send is
    also caught: the receiver sees the state as of the send)."""
    return pickle.dumps(message, protocol=pickle.HIGHEST_PROTOCOL)


def decode(payload: bytes):
    return pickle.loads(payload)
