from accord_tpu_torch.messages.base import Request, Reply, Callback, SimpleReply
from accord_tpu_torch.messages.preaccept import PreAccept, PreAcceptOk, PreAcceptNack
from accord_tpu_torch.messages.accept import Accept, AcceptOk, AcceptNack, AcceptRedundant
from accord_tpu_torch.messages.commit import Commit, CommitOk
from accord_tpu_torch.messages.apply_msg import Apply, ApplyOk
from accord_tpu_torch.messages.read import ReadTxnData, ReadOk, ReadNack
from accord_tpu_torch.messages.recover import (
    AcceptInvalidate, BeginRecovery, CheckStatus, CheckStatusOk,
    CommitInvalidate, DepsEntry, DepsTier, InvalidateNack, InvalidateOk,
    RecoverNack, RecoverOk, WaitOnCommit, WaitOnCommitOk,
)
from accord_tpu_torch.messages.wait import (
    AppliedOk, ApplyThenWaitUntilApplied, WaitUntilApplied,
)
from accord_tpu_torch.messages.fetch import FetchData, FetchOk
from accord_tpu_torch.messages.epoch import EpochSyncComplete
from accord_tpu_torch.messages.inform import (
    InformDurable, InformHomeDurable, InformOfTxnId,
)

__all__ = [
    "Request", "Reply", "Callback", "SimpleReply",
    "PreAccept", "PreAcceptOk", "PreAcceptNack",
    "Accept", "AcceptOk", "AcceptNack", "AcceptRedundant",
    "Commit", "CommitOk", "Apply", "ApplyOk",
    "ReadTxnData", "ReadOk", "ReadNack",
    "BeginRecovery", "RecoverOk", "RecoverNack", "DepsEntry", "DepsTier",
    "WaitOnCommit", "WaitOnCommitOk",
    "AcceptInvalidate", "InvalidateOk", "InvalidateNack", "CommitInvalidate",
    "CheckStatus", "CheckStatusOk",
    "AppliedOk", "ApplyThenWaitUntilApplied", "WaitUntilApplied",
    "FetchData", "FetchOk", "EpochSyncComplete",
    "InformOfTxnId", "InformDurable", "InformHomeDurable",
]
