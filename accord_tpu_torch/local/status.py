"""The protocol status lattice.

Role-equivalent to the reference's Status/SaveStatus (local/Status.java:47,
SaveStatus.java:51): each replica-local command progresses monotonically
through these states. We collapse the reference's two-level Status x SaveStatus
refinement into one ordered enum plus a Durability dimension; the `Known`
knowledge vector is recoverable from (status, fields present) which is how the
recovery/CheckStatus merge logic consumes it.

Order matters: `has_been` compares ordinals. INVALIDATED and TRUNCATED are
terminal and sort above APPLIED deliberately -- anything merged against them
yields the terminal state.
"""
from __future__ import annotations

import enum

from accord_tpu_torch.primitives.timestamp import Ballot


class Phase(enum.IntEnum):
    NONE = 0
    PRE_ACCEPT = 1
    ACCEPT = 2
    COMMIT = 3
    EXECUTE = 4
    PERSIST = 5
    CLEANUP = 6


class Status(enum.IntEnum):
    NOT_DEFINED = 0
    PRE_ACCEPTED = 1
    ACCEPTED_INVALIDATE = 2   # ballot-accepted an invalidation proposal
    ACCEPTED = 3              # ballot-accepted a slow-path executeAt proposal
    PRE_COMMITTED = 4         # executeAt decided (learned out-of-band), deps not yet
    COMMITTED = 5             # executeAt + deps decided
    STABLE = 6                # deps stable: execution dependencies registered
    READY_TO_EXECUTE = 7      # all local dependencies satisfied; awaiting read/apply
    PRE_APPLIED = 8           # outcome (writes/result) known, deps not yet applied
    APPLIED = 9               # writes durably applied locally
    INVALIDATED = 10          # terminal: agreed never to execute
    TRUNCATED = 11            # terminal: erased after durability

    @property
    def phase(self) -> Phase:
        return _PHASES[self]

    def has_been(self, other: "Status") -> bool:
        return self >= other

    @property
    def is_terminal(self) -> bool:
        return self in (Status.INVALIDATED, Status.TRUNCATED)

    @property
    def is_committed(self) -> bool:
        """executeAt is decided (and the txn not invalidated)."""
        return Status.COMMITTED <= self <= Status.APPLIED or self == Status.PRE_COMMITTED

    @property
    def is_stable(self) -> bool:
        return Status.STABLE <= self <= Status.APPLIED

    @property
    def is_decided(self) -> bool:
        return self >= Status.PRE_COMMITTED

    @property
    def definition_is_known(self) -> bool:
        return self in (Status.PRE_ACCEPTED, Status.ACCEPTED) or self >= Status.COMMITTED and self != Status.INVALIDATED and self != Status.TRUNCATED


_PHASES = {
    Status.NOT_DEFINED: Phase.NONE,
    Status.PRE_ACCEPTED: Phase.PRE_ACCEPT,
    Status.ACCEPTED_INVALIDATE: Phase.ACCEPT,
    Status.ACCEPTED: Phase.ACCEPT,
    Status.PRE_COMMITTED: Phase.COMMIT,
    Status.COMMITTED: Phase.COMMIT,
    Status.STABLE: Phase.EXECUTE,
    Status.READY_TO_EXECUTE: Phase.EXECUTE,
    Status.PRE_APPLIED: Phase.PERSIST,
    Status.APPLIED: Phase.PERSIST,
    Status.INVALIDATED: Phase.CLEANUP,
    Status.TRUNCATED: Phase.CLEANUP,
}


def recovery_rank(status: Status, ballot) -> tuple:
    """Sort key for recovery-reply comparison, mirroring the reference's
    Status.max tie-break rules (local/Status.java Phase.tieBreakWithBallot):
    compare phase first; within the Accept phase the BALLOT decides (an
    AcceptedInvalidate at a higher ballot supersedes an Accepted at a lower
    one — ranking by raw status ordinal would resurrect a txn whose
    invalidation a later recovery already accepted); otherwise status ordinal
    decides, with ballot as the final tie-break."""
    phase = status.phase
    tiebreak = ballot if phase == Phase.ACCEPT else Ballot.ZERO
    return (phase, tiebreak, status, ballot)


class Durability(enum.IntEnum):
    """Cluster-wide durability knowledge for a txn (reference:
    Status.Durability local/Status.java:862)."""

    NOT_DURABLE = 0
    LOCAL = 1            # durable on this replica
    MAJORITY = 2         # durable on a majority of every shard
    UNIVERSAL = 3        # durable on every replica

    def merge(self, other: "Durability") -> "Durability":
        return max(self, other)


class ProgressToken:
    """Compact summary of a command's observed activity (reference:
    primitives/ProgressToken.java): (durability, phase, promised ballot).
    Totally ordered so a liveness driver can tell whether ANYTHING moved
    cluster-wide between two probes of a stalled txn -- even when the local
    record did not -- and reset its escalation backoff accordingly."""

    __slots__ = ("durability", "status", "promised")

    def __init__(self, durability: Durability, status: Status, promised: Ballot):
        self.durability = durability
        self.status = status
        self.promised = promised

    def _key(self):
        return (self.durability, self.status.phase, self.promised, self.status)

    def merge(self, other: "ProgressToken") -> "ProgressToken":
        return ProgressToken(self.durability.merge(other.durability),
                             max(self.status, other.status),
                             max(self.promised, other.promised))

    def __eq__(self, other):
        return isinstance(other, ProgressToken) and self._key() == other._key()

    def __lt__(self, other):
        return self._key() < other._key()

    def __le__(self, other):
        return self._key() <= other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"ProgressToken({self.durability.name}, {self.status.name}, "
                f"{self.promised!r})")


ProgressToken.NONE = ProgressToken(Durability.NOT_DURABLE, Status.NOT_DEFINED,
                                   Ballot.ZERO)
