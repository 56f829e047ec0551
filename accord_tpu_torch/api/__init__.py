"""L3: the SPI seam between the protocol engine and the host system.

Role-equivalent to the reference's accord.api package (api/Agent.java:33,
MessageSink.java:28, Scheduler.java:26, DataStore.java:39,
ConfigurationService.java:60, ProgressLog.java:59, Read/Write/Update/Query/
Data/Result): everything external -- network, storage, topology service,
timers, metrics -- is pluggable behind these interfaces. The simulator (sim/),
the maelstrom harness, and any production embedding implement them.
"""
from __future__ import annotations

import abc
import enum
from typing import Any, Callable, Iterable, Optional, TYPE_CHECKING

from accord_tpu_torch.primitives.keyspace import Key, Keys, Ranges, Seekables
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.utils.async_ import AsyncResult

if TYPE_CHECKING:
    from accord_tpu_torch.primitives.txn import Txn


# ---------------------------------------------------------------------------
# Execution SPI: the host defines what data operations mean.
# ---------------------------------------------------------------------------

class Data(abc.ABC):
    """Opaque read result fragments, mergeable across keys/replicas."""

    @abc.abstractmethod
    def merge(self, other: "Data") -> "Data": ...


class Read(abc.ABC):
    @abc.abstractmethod
    def read(self, key: Key, safe_store, execute_at: Timestamp) -> Optional[Data]:
        """Read one key at execute_at against the host DataStore."""

    @abc.abstractmethod
    def keys(self) -> Seekables: ...

    def slice(self, ranges: Ranges) -> "Read":
        return self

    def merge(self, other: "Read") -> "Read":
        """Combine two slices of the same logical read (used by
        PartialTxn.union)."""
        raise NotImplementedError(type(self).__name__)


class Write(abc.ABC):
    @abc.abstractmethod
    def apply(self, key: Key, safe_store, execute_at: Timestamp) -> None: ...

    def apply_ranges(self, ranges: Ranges, safe_store, execute_at: Timestamp) -> None:
        raise NotImplementedError


class Update(abc.ABC):
    @abc.abstractmethod
    def apply(self, execute_at: Timestamp, data: Optional[Data]) -> Write:
        """Compute the Write from the read Data."""

    @abc.abstractmethod
    def keys(self) -> Seekables: ...

    def slice(self, ranges: Ranges) -> "Update":
        return self

    def merge(self, other: "Update") -> "Update":
        raise NotImplementedError(type(self).__name__)


class Query(abc.ABC):
    @abc.abstractmethod
    def compute(self, txn_id: TxnId, execute_at: Timestamp, keys: Seekables,
                data: Optional[Data], read: Optional[Read], update: Optional[Update]):
        """Compute the client-visible Result."""


class Result:
    """Marker base for client-visible results."""


class DataStore(abc.ABC):
    """Storage SPI. Bootstrap range-fetch protocol added with topology change
    support (reference: api/DataStore.java:39-113)."""


# ---------------------------------------------------------------------------
# Host callbacks and tunables.
# ---------------------------------------------------------------------------

class Agent(abc.ABC):
    """Host callbacks (reference: api/Agent.java:33-98)."""

    def on_recover(self, node, outcome, failure) -> None:
        pass

    def on_inconsistent_timestamp(self, command, prev: Timestamp, next_ts: Timestamp) -> None:
        raise AssertionError(f"inconsistent timestamp: {prev} vs {next_ts}")

    def on_failed_bootstrap(self, phase: str, ranges: Ranges, retry: Callable, failure) -> None:
        pass

    def on_stale(self, stale_since: Timestamp, ranges: Ranges) -> None:
        pass

    def on_uncaught_exception(self, failure: BaseException) -> None:
        raise failure

    def on_handled_exception(self, failure: BaseException) -> None:
        pass

    def pre_accept_timeout_ms(self) -> float:
        return 1000.0

    def expires_at_ms(self, request, now_ms: float) -> float:
        return now_ms + 2000.0

    def empty_txn(self, kind, keys: Seekables) -> "Txn":
        from accord_tpu_torch.primitives.txn import Txn
        return Txn(kind, keys)


class EventsListener:
    """Metrics hooks (reference: api/EventsListener.java:26-68)."""

    def on_committed(self, command) -> None: ...
    def on_stable(self, command) -> None: ...
    def on_executed(self, command) -> None: ...
    def on_applied(self, command, apply_start_ms: float) -> None: ...
    def on_fast_path_taken(self, txn_id: TxnId) -> None: ...
    def on_slow_path_taken(self, txn_id: TxnId) -> None: ...
    def on_recover(self, txn_id: TxnId) -> None: ...
    def on_preempted(self, txn_id: TxnId) -> None: ...
    def on_timeout(self, txn_id: TxnId) -> None: ...
    def on_invalidated(self, txn_id: TxnId) -> None: ...


# ---------------------------------------------------------------------------
# Communication backend SPI -- the entire network lives behind this.
# ---------------------------------------------------------------------------

class MessageSink(abc.ABC):
    """reference: api/MessageSink.java:28-34 -- four methods, nothing else."""

    @abc.abstractmethod
    def send(self, to: int, request) -> None: ...

    @abc.abstractmethod
    def send_with_callback(self, to: int, request, callback) -> None:
        """callback: messages.Callback receiving success(reply)/failure."""

    @abc.abstractmethod
    def reply(self, to: int, reply_context, reply) -> None: ...


class Scheduler(abc.ABC):
    """Timer SPI (reference: api/Scheduler.java:26-60)."""

    class Scheduled:
        def cancel(self) -> None: ...

    @abc.abstractmethod
    def once(self, delay_ms: float, fn: Callable[[], None]) -> "Scheduler.Scheduled": ...

    @abc.abstractmethod
    def recurring(self, interval_ms: float, fn: Callable[[], None]) -> "Scheduler.Scheduled": ...

    @abc.abstractmethod
    def now(self, fn: Callable[[], None]) -> None: ...


# ---------------------------------------------------------------------------
# Topology service SPI.
# ---------------------------------------------------------------------------

class ConfigurationService(abc.ABC):
    """Epoch source (reference: api/ConfigurationService.java:60)."""

    @abc.abstractmethod
    def current_topology(self): ...

    @abc.abstractmethod
    def get_topology_for_epoch(self, epoch: int): ...

    def fetch_topology_for_epoch(self, epoch: int) -> None:
        pass

    def acknowledge_epoch(self, epoch: int) -> None:
        pass

    def register_listener(self, listener) -> None:
        pass


class TopologySorter(abc.ABC):
    """Orders replicas for contact preference (reference: api/TopologySorter.java)."""

    @abc.abstractmethod
    def compare_key(self, node_id: int, shards) -> Any:
        """Sort key: lower = contact earlier."""


class LeastRecentlyContacted(TopologySorter):
    def compare_key(self, node_id: int, shards):
        return node_id


class BarrierType(enum.Enum):
    LOCAL = "local"
    GLOBAL_SYNC = "global_sync"
    GLOBAL_ASYNC = "global_async"


# ---------------------------------------------------------------------------
# Liveness SPI.
# ---------------------------------------------------------------------------

class ProgressLog(abc.ABC):
    """Per-CommandStore liveness driver (reference: api/ProgressLog.java:59):
    informed of each local command's lifecycle; responsible for noticing
    stalls and driving recovery/fetch."""

    def preaccepted(self, command, is_home: bool) -> None: ...
    def accepted(self, command, is_home: bool) -> None: ...
    def committed(self, command, is_home: bool) -> None: ...
    def stable(self, command, is_home: bool) -> None: ...
    def readyToExecute(self, command) -> None: ...
    def executed(self, command, is_home: bool) -> None: ...
    def durable(self, command) -> None: ...
    def waiting(self, blocked_by: TxnId, blocked_until, participants) -> None: ...
    def clear(self, txn_id: TxnId) -> None: ...
    def informed_of_txn(self, command) -> None:
        """A peer informed the home shard this txn exists (reference:
        InformOfTxnId -> Commands.informHome): take liveness ownership."""
    def gap_marked(self) -> None:
        """The store marked a data gap; an impl may schedule self-healing
        (the reference's Agent.onStale is the analogous host cue)."""
