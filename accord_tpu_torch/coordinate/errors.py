"""Coordination failure taxonomy (reference: coordinate/CoordinationFailed
hierarchy -- Timeout, Preempted, Invalidated, Exhausted, ...)."""
from __future__ import annotations


class CoordinationFailed(RuntimeError):
    pass


class Timeout(CoordinationFailed):
    """Insufficient replies before expiry; outcome unknown."""


class Preempted(CoordinationFailed):
    """A recovery coordinator took over (higher ballot witnessed)."""


class Invalidated(CoordinationFailed):
    """The transaction was invalidated and will never execute."""


class Exhausted(CoordinationFailed):
    """Every candidate replica failed (e.g. all read sources)."""


class TopologyMismatch(CoordinationFailed):
    """Route does not match the topology (e.g. key not owned by any shard)."""
