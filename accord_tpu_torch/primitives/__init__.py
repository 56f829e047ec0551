from accord_tpu_torch.primitives.timestamp import (
    Timestamp, TxnId, Ballot, TxnKind, Domain, NodeId,
)
from accord_tpu_torch.primitives.keyspace import Key, Keys, Range, Ranges
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.deps import KeyDeps, RangeDeps, Deps
from accord_tpu_torch.primitives.txn import Txn, PartialTxn
from accord_tpu_torch.primitives.writes import Writes

__all__ = [
    "Timestamp", "TxnId", "Ballot", "TxnKind", "Domain", "NodeId",
    "Key", "Keys", "Range", "Ranges", "Route",
    "KeyDeps", "RangeDeps", "Deps", "Txn", "PartialTxn", "Writes",
]
