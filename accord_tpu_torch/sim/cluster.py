"""Whole-cluster assembly for simulation.

Role-equivalent to the reference's test Cluster (test impl/basic/
Cluster.java:374-447): builds N Nodes wired to one PendingQueue-backed
network/scheduler/clock, a static sharded topology over an integer hash-key
domain, list-store storage and a collecting agent.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from accord_tpu_torch.api import Agent, ConfigurationService
from accord_tpu_torch.local.node import Node
from accord_tpu_torch.primitives.keyspace import Range, Ranges
from accord_tpu_torch.primitives.timestamp import NodeId
from accord_tpu_torch.sim.list_store import ListStore
from accord_tpu_torch.sim.network import SimNetwork
from accord_tpu_torch.sim.queue import PendingQueue
from accord_tpu_torch.sim import wire
from accord_tpu_torch.sim.scheduler import SimScheduler, SimTimeService
from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.topology.topology import Topology
from accord_tpu_torch.utils.rng import RandomSource


class ClusterConfig:
    def __init__(self, num_nodes: int = 3, rf: int = 3, num_shards: int = 4,
                 key_domain: int = 1 << 16, stores_per_node: int = 2,
                 timeout_ms: float = 1000.0, deps_resolver_factory=None,
                 deps_batch_window_ms=0.0, device_latency_ms: float = 4.0,
                 device_poll_ms=None,
                 progress: bool = True, progress_interval_ms: float = 250.0,
                 progress_stall_ms: float = 1500.0,
                 progress_home_defer: float = 3.0,
                 progress_inform_home: bool = True, serialize: bool = True,
                 durability: bool = False, durability_interval_ms: float = 500.0,
                 preaccept_timeout_ms: float = 1000.0,
                 exec_plane: bool = False, exec_tick_ms: float = 2.0,
                 exec_fuse: bool = True, exec_compact: bool = False,
                 exec_device=None, recovery_scan=None,
                 cmd_plane: bool = False, cmd_plane_cap: int = 1024,
                 cmd_plane_key_cap: int = 1024,
                 cmd_plane_authoritative: bool = False, cmd_device=None,
                 store_delays: bool = False, store_delay_max_us: int = 2000,
                 clock_drift: bool = False, clock_offset_max_us: int = 100_000,
                 clock_drift_max_ppm: int = 10_000,
                 device_messages: bool = False, link_matrix=None,
                 mailbox_depth: int = 64, mailbox_words: int = 384):
        self.num_nodes = num_nodes
        self.rf = min(rf, num_nodes)
        self.num_shards = num_shards
        self.key_domain = key_domain
        self.stores_per_node = stores_per_node
        self.timeout_ms = timeout_ms
        # factory() -> DepsResolver; None = host scan (the reference path)
        self.deps_resolver_factory = deps_resolver_factory
        self.deps_batch_window_ms = deps_batch_window_ms  # None = inline
        self.device_latency_ms = device_latency_ms  # async harvest delay
        # readiness-poll cadence for early harvest of in-flight device calls.
        # Default OFF under the sim scheduler: poll events consume sim
        # sequence numbers, so enabling them perturbs otherwise-identical
        # burns. Real-device deploys (maelstrom) default it on.
        self.device_poll_ms = device_poll_ms
        self.progress = progress  # enable the liveness/recovery engine
        self.progress_interval_ms = progress_interval_ms
        self.progress_stall_ms = progress_stall_ms
        # home-shard ownership (reference ProgressShard): non-home undecided
        # entries defer by this factor and inform the home shard before
        # probing themselves; defer=1.0 + inform=False restores naive
        # every-replica-probes behavior (the gossip test compares the two)
        self.progress_home_defer = progress_home_defer
        self.progress_inform_home = progress_inform_home
        self.serialize = serialize  # wire-codec round-trip for every message
        # background durability rounds (CoordinateShardDurable rotation);
        # the burn enables them and stops them at workload completion
        self.durability = durability
        self.durability_interval_ms = durability_interval_ms
        # preaccept expiry (Agent.pre_accept_timeout_ms); high-concurrency
        # benches raise it together with the network timeout
        self.preaccept_timeout_ms = preaccept_timeout_ms
        # device execution scheduler (ops/exec_plane.py): release execution
        # wavefronts from the device frontier kernel instead of the host walk
        self.exec_plane = exec_plane
        self.exec_tick_ms = exec_tick_ms
        # fuse the exec planes' per-store frontier calls into one per-node
        # dispatch (ExecCoordinator); solo planes keep the plain kernel
        self.exec_fuse = exec_fuse
        # compacted frontier readback (frontier_compact): harvest the exact
        # released-row index list + checksum instead of the full bitmask;
        # checksum mismatch falls back to the legacy decode, counted
        self.exec_compact = exec_compact
        # the exec planes' device: None is the card (raises without one),
        # "cpu" runs the frontier kernels' plain versions
        self.exec_device = exec_device
        # recovery candidate selection mode for ProgressEngine sweeps:
        # None = per-entry host walk (the reference path), "host" = the
        # scan predicate evaluated on the cmd-arena host shadows, "device"
        # = one recovery_scan device query per sweep (host-verified)
        self.recovery_scan = recovery_scan
        # device command arena (ops/cmd_plane.py): batch-evaluate PreAccept
        # witnesses, Accept ballot checks and Commit/Apply promotions in one
        # cmd_tick dispatch per drain, host handlers as residuals. False =
        # the pure Python state machines (the differential baseline)
        self.cmd_plane = cmd_plane
        self.cmd_plane_cap = cmd_plane_cap
        self.cmd_plane_key_cap = cmd_plane_key_cap
        # PR 12's arena-authoritative mode as a cluster flag: device
        # promotions decide status transitions even with the store attached;
        # Python handlers are consulted only for ops the device cannot
        # decide (see CmdPlane.authoritative)
        self.cmd_plane_authoritative = cmd_plane_authoritative
        # the cmd planes' device: None is the card (raises without one),
        # "cpu" runs the kernels' plain versions
        self.cmd_device = cmd_device
        # adversarial simulator knobs (reference: DelayedCommandStores async
        # loads + per-node clock drift, burn/BurnTest.java:330-340)
        self.store_delays = store_delays
        self.store_delay_max_us = store_delay_max_us
        self.clock_drift = clock_drift
        self.clock_offset_max_us = clock_offset_max_us
        self.clock_drift_max_ppm = clock_drift_max_ppm
        # device message plane (sim/network.DeviceMessageNetwork +
        # ops/mailbox.py): batched ticketed delivery with payload bytes
        # riding the fused protocol_tick's mailbox stage. False = one host
        # event per message (the bit-identical differential baseline)
        self.device_messages = device_messages
        # optional sim/network.LinkMatrix applied at construction (both
        # modes draw from the same per-link dict it installs)
        self.link_matrix = link_matrix
        self.mailbox_depth = mailbox_depth
        self.mailbox_words = mailbox_words


def build_topology(cfg: ClusterConfig, epoch: int = 1) -> Topology:
    """Split [0, key_domain) into num_shards ranges; assign rf replicas
    round-robin (the reference burn test's initial topology shape)."""
    width = cfg.key_domain // cfg.num_shards
    shards = []
    for i in range(cfg.num_shards):
        start = i * width
        end = cfg.key_domain if i == cfg.num_shards - 1 else (i + 1) * width
        nodes = [1 + (i + j) % cfg.num_nodes for j in range(cfg.rf)]
        shards.append(Shard(Range(start, end), nodes))
    return Topology(epoch, shards)


class SimTopologyService:
    """Cluster-global epoch authority (role-equivalent to the reference burn
    test's BurnTestConfigurationService): owns the epoch sequence and delivers
    every epoch to every node IN ORDER with random per-node delays, so nodes
    learn topology changes asynchronously but never with gaps."""

    def __init__(self, cluster: "Cluster", initial: Topology):
        self.cluster = cluster
        self.rng = cluster.rng.fork()
        self.epochs = {initial.epoch: initial}
        self._delivered: Dict[NodeId, int] = {}
        self._delivering: set = set()

    def latest(self) -> Topology:
        return self.epochs[max(self.epochs)]

    def delivered_topology(self, node_id: NodeId) -> Topology:
        """The newest epoch this node has been handed (its 'current')."""
        return self.epochs[self._delivered.get(node_id, 1)]

    def delivered_epoch(self, node_id: NodeId) -> int:
        return self._delivered.get(node_id, 1)

    def mark_initial(self, node_id: NodeId) -> None:
        self._delivered[node_id] = 1

    def reset_delivery(self, node_id: NodeId) -> None:
        """A restarted node re-learns the whole epoch history from scratch
        (its construction reads epoch 1, then _pump walks it forward)."""
        self._delivered[node_id] = 1
        self._delivering.discard(node_id)

    def issue(self, topology: Topology) -> None:
        assert topology.epoch == max(self.epochs) + 1, \
            f"epoch gap: {topology.epoch} after {max(self.epochs)}"
        self.epochs[topology.epoch] = topology
        for node_id in list(self.cluster.nodes):
            self._pump(node_id)

    def request(self, node_id: NodeId) -> None:
        self._pump(node_id)

    def _pump(self, node_id: NodeId) -> None:
        if node_id in self._delivering:
            return
        nxt = self._delivered.get(node_id, 1) + 1
        if nxt not in self.epochs:
            return
        self._delivering.add(node_id)
        topology = self.epochs[nxt]

        def deliver():
            self._delivering.discard(node_id)
            self._delivered[node_id] = nxt
            node = self.cluster.nodes.get(node_id)
            if node is not None:
                node.on_topology_update(topology)
            self._pump(node_id)

        self.cluster.queue.add(self.rng.next_int_between(1_000, 100_000), deliver)


class SimConfigService(ConfigurationService):
    def __init__(self, service: SimTopologyService, node_id: NodeId):
        self._service = service
        self._node_id = node_id

    def current_topology(self) -> Topology:
        return self._service.delivered_topology(self._node_id)

    def get_topology_for_epoch(self, epoch: int) -> Optional[Topology]:
        return self._service.epochs.get(epoch)

    def fetch_topology_for_epoch(self, epoch: int) -> None:
        self._service.request(self._node_id)


class SimAgent(Agent):
    """Collects failures instead of crashing the loop; tests assert empty."""

    def __init__(self, cluster: "Cluster", node_id: NodeId):
        self.cluster = cluster
        self.node_id = node_id

    def on_uncaught_exception(self, failure: BaseException) -> None:
        self.cluster.failures.append((self.node_id, failure))

    def on_inconsistent_timestamp(self, command, prev, next_ts) -> None:
        self.cluster.failures.append(
            (self.node_id, AssertionError(
                f"inconsistent timestamp for {command}: {prev} vs {next_ts}")))

    def pre_accept_timeout_ms(self) -> float:
        return self.cluster.config.preaccept_timeout_ms


class Cluster:
    def __init__(self, seed: int, config: Optional[ClusterConfig] = None):
        self.config = config or ClusterConfig()
        self.rng = RandomSource(seed)
        self.queue = PendingQueue()
        # point the flight recorder's fallback clock at deterministic sim
        # time: node-less record sites (delta uploads) then timestamp from
        # the same clock as everything else and same-seed traces stay
        # byte-identical (last cluster constructed wins; recording is
        # run-scoped)
        from accord_tpu_torch.obs.trace import REC
        REC.clock = lambda q=self.queue: q.now_micros
        if self.config.device_messages:
            from accord_tpu_torch.sim.network import DeviceMessageNetwork
            self.network = DeviceMessageNetwork(
                self.queue, self.rng.fork(),
                timeout_ms=self.config.timeout_ms,
                serialize=self.config.serialize,
                link_matrix=self.config.link_matrix,
                mailbox_depth=self.config.mailbox_depth,
                mailbox_words=self.config.mailbox_words)
        else:
            self.network = SimNetwork(self.queue, self.rng.fork(),
                                      timeout_ms=self.config.timeout_ms,
                                      serialize=self.config.serialize,
                                      link_matrix=self.config.link_matrix)
        self.scheduler = SimScheduler(self.queue)
        self.time_service = SimTimeService(self.queue)
        self.topology = build_topology(self.config)
        self.failures: List = []
        self.nodes: Dict[NodeId, Node] = {}
        self.stores: Dict[NodeId, ListStore] = {}
        self.progress_engines: Dict[NodeId, object] = {}
        self.exec_coordinators: Dict[NodeId, object] = {}
        self.topology_service = SimTopologyService(self, self.topology)
        # crash/restart machinery (reference: test Journal + pseudo-restart):
        # per-node liveness cells (kill ghost timers), per-node constructor
        # closures, and a journal of delivered side-effect requests
        self._alive: Dict[NodeId, list] = {}
        # counters of crashed incarnations (a restart builds a fresh Node,
        # so whole-run tallies must fold these in; see total_counters)
        import collections as _collections
        self.retired_counters = _collections.Counter()
        self._node_rngs: Dict[NodeId, RandomSource] = {}
        self.journals: Dict[NodeId, List] = {}
        self._crash_epoch: Dict[NodeId, int] = {}
        self.network.on_deliver = self._journal_record
        for node_id in range(1, self.config.num_nodes + 1):
            self.stores[node_id] = ListStore()
            self.journals[node_id] = []
            self._node_rngs[node_id] = self.rng.fork()
            self.topology_service.mark_initial(node_id)
            self._build_node(node_id)
        self.durability_schedulers = []
        self._durability_should_stop = None

    def _journal_record(self, dst: NodeId, src: NodeId, payload: bytes) -> None:
        # the recipient's delivered-epoch is journaled with each record: a
        # replay must process each record against the topology knowledge the
        # node had when it first processed it (a real journal persists this
        # as record metadata). Without it, an epoch-2 record whose scope the
        # node only owned via epoch 3 replays against epoch-2 ownership, no
        # store intersects, and the record is silently dropped -- the round-4
        # "lost in rebuild" residual.
        self.journals[dst].append(
            (src, payload, self.topology_service.delivered_epoch(dst)))

    def _build_node(self, node_id: NodeId) -> Node:
        from accord_tpu_torch.sim.scheduler import NodeScheduler
        alive = [True]
        self._alive[node_id] = alive
        progress_factory = None
        engine = None
        if self.config.progress:
            from accord_tpu_torch.impl.progress import ProgressEngine
            engine = ProgressEngine(
                interval_ms=self.config.progress_interval_ms,
                stall_ms=self.config.progress_stall_ms,
                home_defer=self.config.progress_home_defer,
                inform_home=self.config.progress_inform_home,
                recovery_scan=self.config.recovery_scan)
            progress_factory = engine.log_for
        time_service = self.time_service
        if self.config.clock_drift:
            from accord_tpu_torch.sim.scheduler import DriftingTimeService
            drift_rng = self._node_rngs[node_id].fork()
            offset = drift_rng.next_int(2 * self.config.clock_offset_max_us) \
                - self.config.clock_offset_max_us
            ppm = drift_rng.next_int(2 * self.config.clock_drift_max_ppm) \
                - self.config.clock_drift_max_ppm
            time_service = DriftingTimeService(self.queue, offset, ppm)
        node = Node(
            node_id,
            message_sink=self.network.sink_for(node_id),
            config_service=SimConfigService(self.topology_service, node_id),
            scheduler=NodeScheduler(self.queue, alive),
            agent=SimAgent(self, node_id),
            rng=self._node_rngs[node_id].fork(),
            time_service=time_service,
            data_store=self.stores[node_id],
            num_stores=self.config.stores_per_node,
            progress_log_factory=progress_factory,
            deps_resolver=(self.config.deps_resolver_factory()
                           if self.config.deps_resolver_factory else None),
            deps_batch_window_ms=self.config.deps_batch_window_ms,
            device_latency_ms=self.config.device_latency_ms,
            device_poll_ms=self.config.device_poll_ms,
        )
        if engine is not None:
            engine.bind(node)
            self.progress_engines[node_id] = engine
        # zero-config tier padding: when the resolver supports
        # pad_store_tiers and the caller didn't pick one, derive it from
        # the wiring-time store count -- fused dispatches then compile one
        # store tier no matter how many stores a slice touches
        resolver = node._deps_resolver
        if resolver is not None \
                and getattr(resolver, "pad_store_tiers", 0) is None \
                and self.config.stores_per_node > 1:
            resolver.pad_store_tiers = self.config.stores_per_node
        if self.config.exec_plane:
            from accord_tpu_torch.ops.exec_plane import (ExecCoordinator,
                                                         ExecPlane)
            coordinator = None
            if self.config.exec_fuse and self.config.stores_per_node > 1:
                coordinator = ExecCoordinator(
                    node, tick_ms=self.config.exec_tick_ms,
                    device_latency_ms=self.config.device_latency_ms,
                    compact=self.config.exec_compact,
                    device=self.config.exec_device)
                self.exec_coordinators[node_id] = coordinator
            for store in node.command_stores.all():
                store.exec_plane = ExecPlane(
                    store, tick_ms=self.config.exec_tick_ms,
                    device_latency_ms=self.config.device_latency_ms,
                    compact=self.config.exec_compact,
                    device=self.config.exec_device)
                if coordinator is not None:
                    coordinator.register(store.exec_plane)
        if self.config.cmd_plane:
            from accord_tpu_torch.ops.cmd_plane import CmdPlane
            for store in node.command_stores.all():
                store.cmd_plane = CmdPlane(
                    store, initial_cap=self.config.cmd_plane_cap,
                    key_cap=self.config.cmd_plane_key_cap,
                    authoritative=self.config.cmd_plane_authoritative,
                    device=self.config.cmd_device)
        if self.config.store_delays:
            # async store-op delays (reference: DelayedCommandStores): each
            # store defers every op by a deterministic random delay,
            # injecting the reentrancy/interleaving surface inline stores
            # never exercise
            for store in node.command_stores.all():
                delay_rng = self._node_rngs[node_id].fork()
                store.async_delay_us = (
                    lambda r=delay_rng,
                    m=self.config.store_delay_max_us: r.next_int(m))
        def local_sink(req, nid=node_id, n=node):
            # journal side-effecting LocalRequests (Propagate) exactly like
            # delivered network messages, and process the wire round-tripped
            # copy so live behavior matches a future replay
            from accord_tpu_torch.sim.network import ReplyContext
            payload = wire.encode(req)
            if getattr(req, "has_side_effects", True):
                self.journals[nid].append(
                    (nid, payload, self.topology_service.delivered_epoch(nid)))
            n.receive(wire.decode(payload), nid, ReplyContext(nid, -1))

        node.local_request_sink = local_sink
        self.nodes[node_id] = node
        self.network.register_node(node)
        return node

    # -- crash / restart ------------------------------------------------------
    def crash_node(self, node_id: NodeId) -> dict:
        """Kill a node: its timers stop re-arming, its sends and deliveries
        are muted, in-flight messages to it are lost, and its registered
        reply callbacks are purged (a late timeout must not resurrect the
        dead incarnation's coordinations once the node restarts). Returns a
        snapshot of its stable+ command state for the rebuild diff."""
        snapshot = self.stable_snapshot(node_id)
        self.retired_counters.update(self.nodes[node_id].counters)
        self._crash_epoch[node_id] = self.topology_service.delivered_epoch(node_id)
        self._alive[node_id][0] = False
        self.network.dead.add(node_id)
        self.network.purge_callbacks_of(node_id)
        return snapshot

    def restart_node(self, node_id: NodeId, on_ready=None,
                     on_healthy=None) -> int:
        """Bring the node back as a FRESH process: empty command state, the
        (durable) data store retained, topology re-learned from epoch 1, and
        the journal of side-effect messages replayed -- exactly a restart's
        recovery path. Replayed requests' replies address long-gone message
        ids and are dropped by the reply demux.

        Each journal record is gated on the delivered-epoch it was recorded
        under, so replay reconstructs the ownership conditions of the
        original processing (records were journaled with monotonic epochs,
        so gating preserves journal order). `on_ready` fires once the replay
        has fully processed AND the catch-up fetch has been issued -- callers
        anchor rebuild checks on it. `on_healthy` fires once the catch-up
        bootstraps have COMPLETED (gaps filled, safe to read): overlapping
        restarts leave multiple nodes with data gaps on the same ranges, and
        gapped fetch sources nack each other into a cluster-wide bootstrap
        livelock -- callers gate the NEXT crash on it, the way operators roll
        one node at a time waiting for health. Returns the scheduled replay
        span in sim microseconds (a lower bound on readiness; prefer the
        callbacks)."""
        from accord_tpu_torch.sim.network import ReplyContext
        crash_epoch = self._crash_epoch.get(
            node_id, self.topology_service.delivered_epoch(node_id))
        self.topology_service.reset_delivery(node_id)
        self.network.dead.discard(node_id)
        node = self._build_node(node_id)
        self.topology_service.request(node_id)  # re-pump epochs 2..latest
        replay_rng = self._node_rngs[node_id].fork()
        entries = list(self.journals[node_id])
        remaining = [len(entries)]

        def catch_up():
            # writes applied by the cluster WHILE this node was down were
            # never journaled here (its disk missed them). The durable data
            # store was retained and replay reconstructed everything
            # delivered pre-crash, so the only missing state is the downtime
            # window -- whose outcomes are GUARANTEED recoverable: the
            # universal durability floor cannot advance past a down replica
            # (QueryDurableBefore needs every node), so tier-B truncation
            # never erases them. A local Barrier over the owned ranges waits
            # for everything below a fresh sync point to apply HERE; records
            # this node never saw are repaired by the progress engine's
            # blocked-dep CheckStatus -> Propagate machinery (which carries
            # writes). A snapshot re-bootstrap -- the prior design -- marked
            # the FULL owned ranges as a data gap; concurrent restarts then
            # nacked each other's fetches into a cluster-wide livelock.
            from accord_tpu_torch.coordinate.syncpoint import Barrier
            owned = Ranges.EMPTY
            for s in node.command_stores.all():
                owned = owned.union(s.current_owned())
            if on_ready is not None:
                on_ready()
            if owned.is_empty():
                if on_healthy is not None:
                    on_healthy()
                return
            alive = self._alive[node_id]
            attempt = [0]

            def run_barrier():
                attempt[0] += 1
                Barrier.local(node, owned) \
                    .on_success(lambda _: (on_healthy() if on_healthy is not None
                                           else None)) \
                    .on_failure(retry)

            def retry(_failure):
                if not alive[0]:
                    return  # crashed again; the next restart catches up
                node.scheduler.once(min(400.0 * attempt[0], 3000.0),
                                    run_barrier)

            run_barrier()

        def schedule_catch_up():
            # replay done; also wait until every pre-crash epoch has been
            # re-learned (the catch-up bootstrap's fresh sync point advances
            # reject floors -- running it before the replayed records'
            # epochs arrive would reject the very records being rebuilt)
            node.with_epoch(crash_epoch,
                            lambda: self.queue.add(200_000, catch_up))

        def entry_done():
            remaining[0] -= 1
            if remaining[0] == 0:
                schedule_catch_up()

        delay = 1_000
        for (src, payload, epoch_at) in entries:
            # spread the replay over a little sim time, preserving order
            delay += 50 + replay_rng.next_int(50)

            def deliver(s=src, p=payload, e=epoch_at):
                def run(_=None):
                    node.receive(wire.decode(p), s, ReplyContext(s, -1))
                    entry_done()
                node.with_epoch(e, run)

            self.queue.add(delay, deliver)
        if not entries:
            schedule_catch_up()
        if self._durability_should_stop is not None:
            # the rotation died with the old incarnation's scheduler:
            # restart it for the new one
            from accord_tpu_torch.impl.durability import DurabilityScheduling
            sched = DurabilityScheduling(
                node, interval_ms=self.config.durability_interval_ms,
                should_stop=self._durability_should_stop)
            sched.start()
            self.durability_schedulers.append(sched)
        return delay + 200_000

    def stable_snapshot(self, node_id: NodeId) -> dict:
        """(store_id, txn_id) -> (status, execute_at, participants) for
        stable+ commands: what a journal replay must reconstruct (reference:
        Journal's reflection diff of rebuilt commands). Participants are
        snapshotted so the rebuild diff can scope its truncation excusal to
        the command's OWN keys, not any floored range of the store."""
        from accord_tpu_torch.local.status import Status
        out = {}
        for s in self.nodes[node_id].command_stores.all():
            for txn_id, cmd in s.commands.items():
                if cmd.status.is_stable:
                    participants = cmd.route.participants \
                        if cmd.route is not None else (
                            cmd.txn.keys if cmd.txn is not None else s.ranges)
                    out[(s.store_id, txn_id)] = (
                        cmd.status, cmd.execute_at, participants)
        return out

    def verify_rebuild(self, node_id: NodeId, snapshot: dict) -> None:
        """Every stable+ command of the pre-crash snapshot must be rebuilt
        with the SAME executeAt and at least stable status (or have been
        legitimately finished as terminal by floors that advanced since)."""
        stores = {s.store_id: s for s in self.nodes[node_id].command_stores.all()}
        for (store_id, txn_id), (status, execute_at, participants) \
                in snapshot.items():
            s = stores[store_id]
            cmd = s.command_if_present(txn_id)
            if cmd is not None and cmd.status.is_stable \
                    and not cmd.status.is_terminal:
                assert cmd.execute_at == execute_at, \
                    f"store {store_id}: {txn_id} executeAt {cmd.execute_at} != {execute_at}"
                continue
            # missing / terminal / resurrected-empty records are fine iff the
            # command's OWN participants reach below the truncation horizon
            # (floors that advanced since legitimately finished it; an empty
            # record may be a waiter's _init_waiting_on resurrection AFTER a
            # legitimate truncation). Scoped to the snapshotted participants
            # -- an unrelated floored range of the store must not excuse a
            # genuinely lost command -- but with the same ANY-part
            # granularity the engine's own truncation decisions use (cleanup
            # erases on the store's txn SLICE; the resolver finalizes on the
            # route scope).
            ok = s.is_truncated(txn_id, participants) or (
                cmd is not None and cmd.status.is_terminal)
            assert ok, (f"store {store_id}: {txn_id} "
                        + ("lost in rebuild" if cmd is None
                           else f"rebuilt only to {cmd.status.name}"))

    def start_durability(self, should_stop=None) -> None:
        """Start background durability rotation on every node. The caller
        supplies should_stop so a simulated run can quiesce (a recurring task
        with no stop condition would keep the event queue alive forever)."""
        from accord_tpu_torch.impl.durability import DurabilityScheduling
        self._durability_should_stop = should_stop or (lambda: False)
        for node in self.nodes.values():
            sched = DurabilityScheduling(
                node, interval_ms=self.config.durability_interval_ms,
                should_stop=should_stop)
            sched.start()
            self.durability_schedulers.append(sched)

    def node(self, node_id: NodeId) -> Node:
        return self.nodes[node_id]

    def total_counters(self) -> Dict[str, int]:
        """Whole-run protocol event counts: live nodes plus every crashed
        incarnation's tallies."""
        totals: Dict[str, int] = dict(self.retired_counters)
        for node in self.nodes.values():
            for k, v in node.counters.items():
                totals[k] = totals.get(k, 0) + v
        return totals

    def current_topology(self) -> Topology:
        return self.topology_service.latest()

    def issue_topology(self, topology: Topology) -> None:
        """Publish a new epoch to the cluster (delivered per-node, in order,
        with random delays)."""
        self.topology_service.issue(topology)

    def any_node(self) -> Node:
        return self.nodes[self.rng.pick(sorted(self.nodes))]

    def drain(self, max_events: Optional[int] = None) -> int:
        return self.queue.drain(max_events)

    def check_no_failures(self) -> None:
        if self.failures:
            node_id, failure = self.failures[0]
            raise AssertionError(
                f"{len(self.failures)} node failure(s); first on node {node_id}: "
                f"{failure!r}") from failure

    def converged_key_lists(self) -> Dict[object, tuple]:
        """At quiescence every replica of a key must hold the same list;
        returns the authoritative map (and asserts convergence)."""
        out: Dict[object, tuple] = {}
        final = self.current_topology()
        for node_id, store in self.stores.items():
            owned = final.ranges_for_node(node_id)
            for key, entries in store.data.items():
                if not owned.contains_key(key):
                    continue
                lst = tuple(v for _, v in entries)
                if key in out:
                    if out[key] != lst:
                        raise AssertionError(
                            f"replica divergence on key {key}: {out[key]} vs "
                            f"{lst} (node {node_id})")
                else:
                    out[key] = lst
        return out
