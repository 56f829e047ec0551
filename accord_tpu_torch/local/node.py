"""Node: the composition root and facade.

Role-equivalent to the reference's Node (local/Node.java:100): owns the
MessageSink, ConfigurationService, TopologyManager, CommandStores, Agent,
Scheduler and the hybrid logical clock; entry points coordinate()/receive().
Everything is constructor-injected (the reference's config philosophy,
SURVEY.md section 5).
"""
from __future__ import annotations

import collections
import itertools
from typing import Callable, Dict, Optional, Tuple

from accord_tpu_torch.api import Agent, ConfigurationService, EventsListener, MessageSink, Scheduler
from accord_tpu_torch.local.stores import CommandStores
from accord_tpu_torch.primitives.keyspace import Keys, Ranges, Seekables
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Domain, NodeId, Timestamp, TxnId, TxnKind
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.topology.manager import TopologyManager
from accord_tpu_torch.topology.topologies import Topologies
from accord_tpu_torch.utils.async_ import AsyncResult
from accord_tpu_torch.utils.invariants import Invariants
from accord_tpu_torch.utils.rng import RandomSource


class TimeService:
    """Clock SPI (reference: local/NodeTimeService.java). now_micros must be
    monotone non-decreasing per node; the simulator supplies logical time."""

    def now_micros(self) -> int:
        raise NotImplementedError


class Node:
    def __init__(self, node_id: NodeId, *, message_sink: MessageSink,
                 config_service: ConfigurationService, scheduler: Scheduler,
                 agent: Agent, rng: RandomSource, time_service: TimeService,
                 data_store, num_stores: int = 1,
                 progress_log_factory: Optional[Callable] = None,
                 deps_resolver=None, deps_batch_window_ms: Optional[float] = 0.0,
                 device_latency_ms: float = 4.0,
                 device_poll_ms: Optional[float] = None,
                 events: Optional[EventsListener] = None):
        self.id = node_id
        # lightweight observability: protocol event counts (probes sent,
        # informs exchanged, ...); the burn report and gossip tests read them
        self.counters: collections.Counter = collections.Counter()
        # unified metrics: txn lifecycle counters/latency histograms land
        # here; metrics_snapshot() folds in every attached resolver's and
        # exec plane's registry (obs/metrics.py)
        from accord_tpu_torch.obs.metrics import MetricsRegistry
        self.metrics = MetricsRegistry()
        # str -> None sink for emit_metrics_snapshot (the maelstrom runner
        # points it at its stderr logger); None: snapshots are not emitted
        self.metrics_sink: Optional[Callable[[str], None]] = None
        self.message_sink = message_sink
        self.config_service = config_service
        self.scheduler = scheduler
        self.agent = agent
        self.rng = rng
        self.time_service = time_service
        self.data_store = data_store
        self.events = events or EventsListener()
        self.topology_manager = TopologyManager(node_id)
        self._num_stores = num_stores
        self._progress_log_factory = progress_log_factory
        self._deps_resolver = deps_resolver
        # micro-batch coalescing window for the device deps path (None =
        # inline, no deferral; see CommandStore.submit_preaccept). The
        # window is per NODE: one tick drains every store's pending items
        # and fuses them into a single device dispatch (ops/resolver.py)
        self.deps_batch_window_ms = deps_batch_window_ms
        # simulated dispatch->harvest delay of the async device pipeline:
        # models real accelerator latency AND gives the pipeline depth that
        # hides the host<->device round trip (see ops/resolver.py)
        self.device_latency_ms = device_latency_ms
        # readiness-poll cadence for harvesting in-flight device calls early
        # (resolver._ensure_poll / exec_plane): None disables polling -- the
        # right default under the sim scheduler, where poll events would
        # perturb sequence numbers; real-device deploys (maelstrom) enable it
        self.device_poll_ms = device_poll_ms
        self.command_stores: Optional[CommandStores] = None
        # HLC state (reference: Node.uniqueNow CAS loop, local/Node.java:348)
        self._last_hlc = 0
        # coordinator-side reply demux
        self._next_message_id = itertools.count(1)
        self._callbacks: Dict[int, Tuple[object, object]] = {}  # msg_id -> (callback, timeout_handle)
        self._store_factory = None

        topology = config_service.current_topology()
        if topology is not None:
            self.on_topology_update(topology)

    # -- topology ------------------------------------------------------------
    def on_topology_update(self, topology) -> None:
        """(reference: Node.onTopologyUpdate, local/Node.java:248): register
        the epoch, recompute store ownership, bootstrap added ranges, then
        announce sync-complete to the cluster."""
        if self.topology_manager.has_epoch(topology.epoch):
            return
        # waiters fire only after store ownership below is applied (see
        # TopologyManager.notify_epoch)
        self.topology_manager.on_topology_update(topology, notify=False)
        if self.command_stores is None:
            kwargs = {}
            if self._store_factory is not None:
                kwargs["store_factory"] = self._store_factory
            # stores carve up the WHOLE cluster domain; ownership per epoch
            # is applied by update_topology below
            self.command_stores = CommandStores(
                self, self._num_stores, topology.ranges(),
                progress_log_factory=self._progress_log_factory,
                deps_resolver=self._deps_resolver, **kwargs)
        epoch = topology.epoch
        result = self.command_stores.update_topology(topology)
        self.topology_manager.notify_epoch(epoch)
        result.on_success(lambda _: self._on_epoch_locally_synced(epoch)) \
            .on_failure(self.agent.on_uncaught_exception)

    def _on_epoch_locally_synced(self, epoch: int) -> None:
        """All added ranges bootstrapped: ack the epoch to the cluster
        (reference: ConfigurationService.acknowledgeEpoch +
        Listener.onEpochSyncComplete gossip)."""
        from accord_tpu_torch.messages.epoch import EpochSyncComplete
        self.topology_manager.on_epoch_sync_complete(self.id, epoch)
        self.config_service.acknowledge_epoch(epoch)
        if epoch <= 1:
            return  # genesis epoch is born synced; no gossip needed
        targets = set(self.topology_manager.for_epoch(epoch).nodes())
        if self.topology_manager.has_epoch(epoch - 1):
            # superseded replicas track sync too: they serve until handover
            targets |= set(self.topology_manager.for_epoch(epoch - 1).nodes())
        for to in sorted(targets):
            if to != self.id:
                _ReliableSend(self, to, EpochSyncComplete(self.id, epoch)).send()

    def with_epoch(self, epoch: int, fn: Callable[[], None]) -> None:
        """Run fn once the topology for `epoch` is known locally (reference:
        Node.withEpoch, local/Node.java:596)."""
        if epoch <= self.epoch or self.topology_manager.has_epoch(epoch):
            fn()
            return
        self.config_service.fetch_topology_for_epoch(epoch)
        self.topology_manager.await_epoch(epoch).on_success(lambda _: fn())

    @property
    def epoch(self) -> int:
        return self.topology_manager.epoch

    def topology(self) -> TopologyManager:
        return self.topology_manager

    # -- time / id generation ------------------------------------------------
    def unique_now(self, at_least: Optional[Timestamp] = None) -> Timestamp:
        hlc = max(self.time_service.now_micros(), self._last_hlc + 1)
        epoch = self.epoch
        if at_least is not None:
            if at_least.hlc >= hlc:
                hlc = at_least.hlc + 1
            epoch = max(epoch, at_least.epoch)
        self._last_hlc = hlc
        return Timestamp(epoch, hlc, 0, self.id)

    def next_txn_id(self, kind: TxnKind, domain: Domain) -> TxnId:
        now = self.unique_now()
        return TxnId.create(now.epoch, now.hlc, self.id, kind, domain)

    def now_millis(self) -> float:
        return self.time_service.now_micros() / 1000.0

    # -- client entry points -------------------------------------------------
    def coordinate(self, txn: Txn, txn_id: Optional[TxnId] = None) -> AsyncResult:
        """Coordinate a transaction; completes with its Result.
        (reference: Node.coordinate, local/Node.java:586)"""
        from accord_tpu_torch.coordinate.transaction import CoordinateTransaction
        if txn_id is None:
            txn_id = self.next_txn_id(txn.kind, txn.domain)
        route = self.compute_route(txn)
        from accord_tpu_torch.primitives.timestamp import TxnKind as _K
        if txn.kind is _K.EPHEMERAL_READ:
            from accord_tpu_torch.coordinate.ephemeral import CoordinateEphemeralRead
            return CoordinateEphemeralRead.coordinate(self, txn_id, txn, route)
        return CoordinateTransaction.coordinate(self, txn_id, txn, route)

    def compute_route(self, txn: Txn) -> Route:
        home_key = _pick_home_key(txn.keys)
        return txn.to_route(home_key)

    # -- messaging -----------------------------------------------------------
    def send(self, to: NodeId, request, callback=None) -> None:
        """(reference: Node.send helpers local/Node.java:437-540)"""
        if callback is None:
            self.message_sink.send(to, request)
        else:
            self.message_sink.send_with_callback(to, request, callback)

    def send_to_many(self, nodes, request_factory: Callable[[NodeId], object], callback) -> None:
        for to in nodes:
            self.send(to, request_factory(to), callback)

    def reply(self, to: NodeId, reply_context, reply) -> None:
        if reply is None:
            # nothing to say (e.g. no local store intersected the scope):
            # stay silent and let the sender's timeout/escalation handle it
            return
        self.message_sink.reply(to, reply_context, reply)

    def receive(self, request, from_node: NodeId, reply_context) -> None:
        """Ingress for protocol requests (reference: Node.receive,
        local/Node.java:718): defers until the request's epoch is known."""
        wait_for = getattr(request, "wait_for_epoch", 0)
        self.with_epoch(wait_for, lambda: self.scheduler.now(
            lambda: self._process(request, from_node, reply_context)))

    def _process(self, request, from_node: NodeId, reply_context) -> None:
        try:
            request.process(self, from_node, reply_context)
        except BaseException as e:  # noqa: BLE001 -- agent decides
            self.agent.on_uncaught_exception(e)

    def receive_local(self, request) -> None:
        """Ingress for LocalRequests (reference: Node.localRequest +
        MessageType side-effect flagging): side-effecting local messages
        (Propagate) must pass through the host's journal hook so a restart's
        replay reconstructs the state they created. The sim cluster installs
        `local_request_sink` to journal + round-trip them; without a sink
        they process directly."""
        sink = getattr(self, "local_request_sink", None)
        if sink is not None:
            sink(request)
        else:
            self.receive(request, self.id, None)

    # -- observability -------------------------------------------------------
    def metrics_snapshot(self) -> Dict[str, object]:
        """One flat dict of everything this node knows: its own registry
        (txn.* latencies), the legacy protocol counters (prefixed node.*),
        and every attached resolver's / exec plane's registry snapshot."""
        snap = self.metrics.snapshot()
        for name, v in sorted(self.counters.items()):
            snap[f"node.{name}"] = v
        seen = set()
        if self.command_stores is not None:
            for store in self.command_stores.all():
                for obj in (store.deps_resolver,
                            getattr(store, "exec_plane", None),
                            getattr(store, "cmd_plane", None)):
                    if obj is None or id(obj) in seen:
                        continue
                    seen.add(id(obj))
                    sub = getattr(obj, "snapshot", None)
                    if sub is not None:
                        snap.update(sub())
        return snap

    def emit_metrics_snapshot(self, reason: str = "final") -> None:
        """Write a one-line JSON metrics snapshot through metrics_sink (the
        maelstrom runner's stderr logger). No sink: silently skip."""
        if self.metrics_sink is None:
            return
        import json
        self.metrics_sink("metrics %s node=%s %s" % (
            reason, self.id, json.dumps(self.metrics_snapshot(),
                                        sort_keys=True)))

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self) -> None:
        """Graceful stop of the device deps pipeline: flush every attached
        resolver's staged (encode-ahead) plans AND in-flight device calls
        for this node, so no enqueued AsyncResult strands once the scheduler
        stops delivering this node's events. Idempotent -- a second call
        (serve-mode Ctrl-C racing a client-driven shutdown) returns without
        re-draining the already-flushed pipeline -- and safe when no
        scheduler owns outstanding timers (an external event loop drives the
        drain to completion synchronously; the resolver skips arming harvest
        timers it would never see fire). A node with no batched resolver is
        a no-op. Ends by emitting a final metrics snapshot through
        metrics_sink (when one is installed)."""
        if getattr(self, "_shutdown_done", False):
            return
        self._shutdown_done = True
        if self.command_stores is not None:
            drained = set()
            for store in self.command_stores.all():
                resolver = store.deps_resolver
                if resolver is None or id(resolver) in drained:
                    continue
                drained.add(id(resolver))
                drain = getattr(resolver, "drain", None)
                if drain is not None:
                    drain(self)
        self.emit_metrics_snapshot("shutdown")


class _ReliableSend:
    """Fire-and-forget with retries: epoch gossip must survive chaos, so
    re-send on timeout/failure with backoff until acked or exhausted."""

    def __init__(self, node: Node, to: NodeId, request, attempts: int = 30,
                 backoff_ms: float = 250.0):
        self.node = node
        self.to = to
        self.request = request
        self.attempts = attempts
        self.backoff_ms = backoff_ms

    def send(self) -> None:
        self.node.send(self.to, self.request, self)

    def on_success(self, from_node, reply) -> None:
        pass

    def on_failure(self, from_node, failure) -> None:
        if self.attempts <= 0:
            return
        self.attempts -= 1
        self.node.scheduler.once(self.backoff_ms, self.send)
        self.backoff_ms = min(self.backoff_ms * 1.5, 2000.0)


def _pick_home_key(seekables: Seekables):
    """Deterministic home-key selection: the first participant (the reference
    picks trySelectHomeKey from the route; any deterministic choice works)."""
    if isinstance(seekables, Keys):
        Invariants.check_argument(len(seekables) > 0, "txn with no keys")
        return seekables[0]
    Invariants.check_argument(len(seekables) > 0, "txn with no ranges")
    return seekables[0].start
