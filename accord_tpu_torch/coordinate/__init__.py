from accord_tpu_torch.coordinate.errors import (
    CoordinationFailed, Timeout, Preempted, Invalidated, Exhausted,
)
from accord_tpu_torch.coordinate.tracking import (
    RequestStatus, QuorumTracker, FastPathTracker, ReadTracker, AppliedTracker,
)
from accord_tpu_torch.coordinate.transaction import CoordinateTransaction

__all__ = [
    "CoordinationFailed", "Timeout", "Preempted", "Invalidated", "Exhausted",
    "RequestStatus", "QuorumTracker", "FastPathTracker", "ReadTracker",
    "AppliedTracker", "CoordinateTransaction",
]
