"""Simulated network: per-link latency, drops, partitions, reply demux and
timeouts.

Role-equivalent to the reference's NodeSink (test impl/basic/NodeSink.java:42)
with its per-link Action {DELIVER, DROP, DELIVER_WITH_FAILURE, FAILURE} and
the periodically re-randomized link topology (Cluster.Link). One SimNetwork is
shared by the cluster; each node gets a SimMessageSink facade bound to its id.

The DEVICE MESSAGE PLANE (DeviceMessageNetwork, `device_messages=True` on the
cluster config) is the drop-in twin that removes the per-message Python event
cost: instead of one PendingQueue event per delivery, every message consumes
a TICKET from the queue's shared sequence stream at exactly the call site the
baseline would have scheduled its deliver event, parks in a side heap keyed
(deliver_at, ticket), and ONE cursor event -- re-armed under the head
message's own ticket, so it occupies precisely the heap position the
baseline's event would have -- drains every consecutively-due message per
callback. Payload bytes of flushed messages additionally ride the device
mailbox arena (ops/mailbox.py) through the fused protocol_tick program when a
ClusterTickEngine attaches; delivery always verifies the device words against
the staged bytes and falls back to the host copy on any mismatch, so the
device path can DEGRADE but never diverge. Drop/latency draws stay host-side
on the same rng stream as the baseline (that is what makes `--reconcile` and
the device-vs-host history differential bit-identical); partitions and the
per-link matrix are mirrored to the device as masks, uploaded once per link
epoch.
"""
from __future__ import annotations

import enum
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from accord_tpu_torch.api import MessageSink
from accord_tpu_torch.messages.base import Callback, Timeout
from accord_tpu_torch.obs.trace import REC
from accord_tpu_torch.primitives.timestamp import NodeId
from accord_tpu_torch.sim.queue import PendingQueue
from accord_tpu_torch.sim import wire
from accord_tpu_torch.utils.rng import RandomSource


class ReplyContext:
    __slots__ = ("origin", "msg_id")

    def __init__(self, origin: NodeId, msg_id: int):
        self.origin = origin
        self.msg_id = msg_id


class LinkConfig:
    """Behaviour of the from->to link at a point in time."""

    __slots__ = ("min_latency_us", "max_latency_us", "drop_probability")

    def __init__(self, min_latency_us: int = 500, max_latency_us: int = 20_000,
                 drop_probability: float = 0.0):
        self.min_latency_us = min_latency_us
        self.max_latency_us = max_latency_us
        self.drop_probability = drop_probability


class LinkMatrix:
    """Dense node x node link behaviour: min/max latency and drop
    probability per DIRECTED link, 1-based node ids. This is the "uploaded
    once per epoch" config shape of the device message plane -- the same
    object also seeds the host SimNetwork's per-link dict (apply_to), so
    a regional-latency burn runs bit-identically through both paths."""

    __slots__ = ("n", "min_lat", "max_lat", "drop")

    def __init__(self, num_nodes: int,
                 default: Optional[LinkConfig] = None):
        d = default or LinkConfig()
        self.n = num_nodes
        shape = (num_nodes + 1, num_nodes + 1)
        self.min_lat = np.full(shape, d.min_latency_us, np.int32)
        self.max_lat = np.full(shape, d.max_latency_us, np.int32)
        self.drop = np.full(shape, d.drop_probability, np.float64)

    def set(self, a: NodeId, b: NodeId, config: LinkConfig) -> None:
        self.min_lat[a, b] = config.min_latency_us
        self.max_lat[a, b] = config.max_latency_us
        self.drop[a, b] = config.drop_probability

    def config(self, a: NodeId, b: NodeId) -> LinkConfig:
        return LinkConfig(int(self.min_lat[a, b]), int(self.max_lat[a, b]),
                          float(self.drop[a, b]))

    def apply_to(self, network: "SimNetwork") -> None:
        """Install every directed link on a SimNetwork (both the host
        baseline and the device twin draw from the same per-link dict, so
        one matrix gives both modes identical behaviour)."""
        for a in range(1, self.n + 1):
            for b in range(1, self.n + 1):
                if a != b:
                    network.set_link(a, b, self.config(a, b))

    @classmethod
    def regional(cls, num_nodes: int, regions: int = 3,
                 local: Tuple[int, int] = (200, 2_000),
                 near: Tuple[int, int] = (1_000, 8_000),
                 far: Tuple[int, int] = (5_000, 40_000),
                 asymmetry: float = 0.25,
                 drop_probability: float = 0.0) -> "LinkMatrix":
        """A 3-region (configurable) latency matrix with ASYMMETRIC
        inter-region links: region r -> region s costs `far` scaled up by
        `asymmetry` per region of eastward distance, so the two directions
        of a cross-region link differ -- the traffic shape ROADMAP item 1
        names as beyond the host event queue's reach at scale."""
        m = cls(num_nodes)
        region = lambda nid: (nid - 1) * regions // num_nodes  # noqa: E731
        for a in range(1, num_nodes + 1):
            for b in range(1, num_nodes + 1):
                ra, rb = region(a), region(b)
                if ra == rb:
                    lo, hi = local
                elif abs(ra - rb) == 1:
                    lo, hi = near
                else:
                    lo, hi = far
                if ra != rb:
                    # eastward (ra < rb) links are slower than their
                    # westward twins: scale by per-hop asymmetry
                    scale = 1.0 + asymmetry * max(0, rb - ra)
                    lo, hi = int(lo * scale), int(hi * scale)
                m.set(a, b, LinkConfig(lo, max(hi, lo + 1),
                                       drop_probability))
        return m


class SimNetwork:
    def __init__(self, queue: PendingQueue, rng: RandomSource,
                 timeout_ms: float = 1000.0, serialize: bool = True,
                 link_matrix: Optional[LinkMatrix] = None):
        self.queue = queue
        self.rng = rng
        self.timeout_ms = timeout_ms
        # round-trip every message through the wire codec so nodes never
        # share live objects (reference: Journal reflection-diff discipline)
        self.serialize = serialize
        self.nodes: Dict[NodeId, object] = {}  # node_id -> Node
        self._msg_ids = itertools.count(1)
        # msg_id -> (callback, replier may be any node, timeout handle)
        self._pending: Dict[int, Tuple[Callback, object]] = {}
        self._default_link = LinkConfig()
        self._links: Dict[Tuple[NodeId, NodeId], LinkConfig] = {}
        self.partitioned: set = set()  # set of frozenset({a, b}) pairs cut off
        self.dead: set = set()         # crashed nodes: sends and deliveries muted
        # bumped on every topology edit (set_link / set_partitioned): the
        # device message plane re-uploads its partition mask per epoch
        self.link_version = 0
        # journal hook: (dst, src, payload_bytes, request) for every
        # side-effect-bearing request actually delivered (crash/restart
        # rebuilds command state by replaying these; reference: Journal)
        self.on_deliver = None
        self.stats: Dict[str, int] = {"sent": 0, "delivered": 0, "dropped": 0,
                                      "timeouts": 0, "replies": 0}
        if link_matrix is not None:
            link_matrix.apply_to(self)

    def register_node(self, node) -> None:
        self.nodes[node.id] = node

    def sink_for(self, node_id: NodeId) -> "SimMessageSink":
        return SimMessageSink(self, node_id)

    def link(self, a: NodeId, b: NodeId) -> LinkConfig:
        return self._links.get((a, b), self._default_link)

    def set_link(self, a: NodeId, b: NodeId, config: LinkConfig) -> None:
        self._links[(a, b)] = config
        self.link_version += 1

    def set_partitioned(self, a: NodeId, b: NodeId, partitioned: bool) -> None:
        pair = frozenset((a, b))
        if partitioned:
            self.partitioned.add(pair)
        else:
            self.partitioned.discard(pair)
        self.link_version += 1

    def message_plane_snapshot(self) -> Dict[str, int]:
        """Device-message-plane counters; empty on the host baseline."""
        return {}

    # -- transport -----------------------------------------------------------
    def _should_drop(self, src: NodeId, dst: NodeId) -> bool:
        if src == dst:
            return False
        if frozenset((src, dst)) in self.partitioned:
            return True
        return self.rng.decide(self.link(src, dst).drop_probability)

    def _latency(self, src: NodeId, dst: NodeId) -> int:
        if src == dst:
            return self.rng.next_int_between(50, 500)
        cfg = self.link(src, dst)
        return self.rng.next_int_between(cfg.min_latency_us, cfg.max_latency_us)

    def send_request(self, src: NodeId, dst: NodeId, request,
                     callback: Optional[Callback]) -> None:
        if src in self.dead:
            return  # a crashed incarnation's residual sends are muted
        self.stats["sent"] += 1
        if REC.enabled:
            REC.instant(src, "net", "send", self.queue.now_micros,
                        args={"to": dst, "msg": type(request).__name__})
        msg_id = next(self._msg_ids)
        if callback is not None:
            timeout_handle = self.queue.add(
                int(self.timeout_ms * 1000),
                lambda: self._on_timeout(msg_id, dst))
            self._pending[msg_id] = (callback, timeout_handle, src)
        if self._should_drop(src, dst):
            self.stats["dropped"] += 1
            return
        # encode at send time: the receiver must observe the request as of
        # the send, and must never share live state with the sender
        payload = wire.encode(request) if self.serialize and src != dst else None
        ctx = ReplyContext(src, msg_id)

        def deliver():
            node = self.nodes.get(dst)
            if node is None or dst in self.dead:
                # destination down: behaves like a drop (sender's timeout
                # fires). Resolved at DELIVERY time so a crash between send
                # and arrival loses the message, as it should.
                self.stats["dropped"] += 1
                return
            self._count("delivered")
            if REC.enabled:
                REC.instant(dst, "net", "deliver", self.queue.now_micros,
                            args={"from": src,
                                  "msg": type(request).__name__})
            if self.on_deliver is not None \
                    and getattr(request, "has_side_effects", True):
                self.on_deliver(dst, src,
                                payload if payload is not None
                                else wire.encode(request))
            msg = wire.decode(payload) if payload is not None else request
            node.receive(msg, src, ctx)

        self.queue.add(self._latency(src, dst), deliver)

    def send_reply(self, src: NodeId, ctx: ReplyContext, reply) -> None:
        if src in self.dead:
            return
        self.stats["replies"] += 1
        if self._should_drop(src, ctx.origin):
            self.stats["dropped"] += 1
            return
        payload = wire.encode(reply) if self.serialize and src != ctx.origin else None
        self.queue.add(self._latency(src, ctx.origin),
                       lambda: self._deliver_reply(src, ctx, reply, payload))

    def _deliver_reply(self, src: NodeId, ctx: ReplyContext, reply, payload=None) -> None:
        if ctx.origin in self.dead:
            return  # the requester crashed; its callbacks died with it
        entry = self._pending.pop(ctx.msg_id, None)
        if entry is None:
            return  # no callback registered or already timed out
        callback, timeout_handle, _ = entry
        timeout_handle.cancel()
        callback.on_success(src, wire.decode(payload) if payload is not None else reply)

    def _on_timeout(self, msg_id: int, dst: NodeId) -> None:
        entry = self._pending.pop(msg_id, None)
        if entry is None:
            return
        callback, _, origin = entry
        if origin in self.dead:
            return  # a dead incarnation's callback must never fire
        self.stats["timeouts"] += 1
        callback.on_failure(dst, Timeout(f"no reply from {dst}"))

    def purge_callbacks_of(self, origin: NodeId) -> None:
        """Drop every pending callback registered by `origin`'s CURRENT
        incarnation -- a restarted node must not have its predecessor's
        coordinations resurrected by late replies or timeouts firing after
        the dead flag is lifted."""
        stale = [mid for mid, (_, _, o) in self._pending.items() if o == origin]
        for mid in stale:
            _, handle, _ = self._pending.pop(mid)
            handle.cancel()

    def _count(self, key: str) -> None:
        self.stats[key] += 1


class _MailMsg:
    """One in-flight message on the device plane: its heap key (deliver
    time, ticket) -- exactly the (time, seq) the baseline's per-message
    deliver event would carry -- the host closure to fire, and the device
    mailbox staging state."""

    __slots__ = ("at", "ticket", "fire", "kind", "src", "dst", "payload",
                 "slot", "released")

    def __init__(self, kind: int, src: NodeId, dst: NodeId,
                 payload: Optional[bytes]):
        self.kind = kind
        self.src = src
        self.dst = dst
        self.payload = payload
        self.at = 0
        self.ticket = 0
        self.fire: Optional[Callable[[], None]] = None
        self.slot = None       # (dst, slot_index) once staged on device
        self.released = False  # already delivered; flush must skip it

    def __lt__(self, other: "_MailMsg") -> bool:
        return (self.at, self.ticket) < (other.at, other.ticket)


class DeviceMessageNetwork(SimNetwork):
    """SimNetwork twin behind `device_messages=True`.

    Stat updates, rng draws (drop then latency) and seq consumption happen
    at EXACTLY the baseline's call sites; the only difference is that the
    deliver closure parks in a side heap under its own ticket and one
    cursor event -- re-armed at the head message's (time, ticket) -- drains
    every consecutively-due message per Python callback. `queue.peek()` is
    re-checked on every drain iteration, so events created by a delivery
    (replies, timeouts, cluster ticks) interleave in the same total order
    the baseline would produce. Payload bytes additionally ride the device
    mailbox arena (ops/mailbox.py) once a ClusterTickEngine attaches;
    `_resolve` verifies the routed device words against the staged host
    bytes on every delivery and falls back to the host copy on any
    mismatch, so the device path can degrade but never diverge."""

    def __init__(self, *args, mailbox_depth: int = 64,
                 mailbox_words: int = 384, **kwargs):
        super().__init__(*args, **kwargs)
        self.mailbox_depth = mailbox_depth
        self.mailbox_words = mailbox_words
        self._side: List[_MailMsg] = []       # heap keyed (at, ticket)
        self._unstaged: List[_MailMsg] = []   # posted since last flush
        self._cursor = None                   # parked drain Cancellable
        self._cursor_key: Optional[Tuple[int, int]] = None
        self._draining = False
        self._engine = None
        self._plane = None                    # MailboxPlane once attached
        self._kinds: Dict[str, int] = {}      # message-kind interning
        self.mstats: Dict[str, int] = {
            "device_messages_delivered": 0,
            "mailbox_verify_fallbacks": 0,
            "mailbox_early_deliveries": 0,
            "message_plane_batches": 0,
            "message_plane_fires": 0,
        }

    # -- engine attachment / device staging ---------------------------------
    def attach_engine(self, engine, shards: int = 1) -> None:
        """Called by ClusterTickEngine once it discovers this network; from
        here on flushed payload bytes ride the device mailbox arena.
        `shards` > 1 (the engine passes the mesh's 'data' extent when the
        resolver is sharded) lays the plane out node-major over shards so
        the sharded megakernel's all_to_all routing stage can carry it."""
        if self._engine is engine:
            return
        from accord_tpu_torch.ops.mailbox import MailboxPlane, nodes_device
        self._engine = engine
        self._plane = MailboxPlane(max(self.nodes, default=0),
                                   depth=self.mailbox_depth,
                                   words=self.mailbox_words,
                                   shards=shards,
                                   device=nodes_device(self.nodes))

    def message_kind(self, name: str) -> int:
        k = self._kinds.get(name)
        if k is None:
            k = len(self._kinds) + 1
            self._kinds[name] = k
        return k

    def mailbox_flush(self):
        """Stage every not-yet-staged in-flight message into the device
        emit lanes; returns the emit block for protocol_tick, or None when
        there is nothing new to route."""
        if self._plane is None:
            return None
        pending, self._unstaged = self._unstaged, []
        live = [e for e in pending if not e.released and e.payload is not None]
        if not live:
            return None
        if self._plane.link_version != self.link_version:
            self._plane.set_partitions(self.partitioned, self.link_version)
        return self._plane.stage_batch(live)

    def mailbox_adopt(self, outs) -> None:
        if self._plane is not None:
            self._plane.adopt(outs)

    def message_plane_snapshot(self) -> Dict[str, int]:
        s: Dict[str, int] = {
            "mailbox_depth_high_water": 0,
            "mailbox_overflow_spills": 0,
            "mailbox_bytes_staged": 0,
        }
        s.update(self.mstats)
        if self._plane is not None:
            s.update(self._plane.counters())
        batches = s.get("message_plane_batches", 0)
        fires = s.get("message_plane_fires", 0)
        s["messages_per_host_callback"] = (
            round(fires / batches, 3) if batches else 0.0)
        return s

    # -- transport (baseline order, ticketed parking) ------------------------
    def send_request(self, src: NodeId, dst: NodeId, request,
                     callback: Optional[Callback]) -> None:
        if src in self.dead:
            return
        self.stats["sent"] += 1
        if REC.enabled:
            REC.instant(src, "net", "send", self.queue.now_micros,
                        args={"to": dst, "msg": type(request).__name__})
        msg_id = next(self._msg_ids)
        if callback is not None:
            timeout_handle = self.queue.add(
                int(self.timeout_ms * 1000),
                lambda: self._on_timeout(msg_id, dst))
            self._pending[msg_id] = (callback, timeout_handle, src)
        if self._should_drop(src, dst):
            self.stats["dropped"] += 1
            return
        payload = wire.encode(request) if self.serialize and src != dst else None
        ctx = ReplyContext(src, msg_id)
        entry = _MailMsg(self.message_kind(type(request).__name__),
                         src, dst, payload)

        def deliver():
            node = self.nodes.get(dst)
            if node is None or dst in self.dead:
                self.stats["dropped"] += 1
                return
            self._count("delivered")
            if REC.enabled:
                REC.instant(dst, "net", "deliver", self.queue.now_micros,
                            args={"from": src,
                                  "msg": type(request).__name__})
            body = self._resolve(entry)
            if self.on_deliver is not None \
                    and getattr(request, "has_side_effects", True):
                self.on_deliver(dst, src,
                                body if body is not None
                                else wire.encode(request))
            msg = wire.decode(body) if body is not None else request
            node.receive(msg, src, ctx)

        # latency draw THEN ticket: the baseline evaluates the add() delay
        # argument (one rng draw) before add() consumes the seq counter
        entry.at = self.queue.now_micros + self._latency(src, dst)
        entry.ticket = self.queue.ticket()
        entry.fire = deliver
        self._post(entry)

    def send_reply(self, src: NodeId, ctx: ReplyContext, reply) -> None:
        if src in self.dead:
            return
        self.stats["replies"] += 1
        if self._should_drop(src, ctx.origin):
            self.stats["dropped"] += 1
            return
        payload = wire.encode(reply) if self.serialize and src != ctx.origin else None
        entry = _MailMsg(self.message_kind(type(reply).__name__),
                         src, ctx.origin, payload)

        def deliver():
            self._deliver_reply(src, ctx, reply, self._resolve(entry))

        entry.at = self.queue.now_micros + self._latency(src, ctx.origin)
        entry.ticket = self.queue.ticket()
        entry.fire = deliver
        self._post(entry)

    # -- parking and the batched drain ---------------------------------------
    def _post(self, entry: _MailMsg) -> None:
        heapq.heappush(self._side, entry)
        self._unstaged.append(entry)
        if not self._draining:
            self._park()

    def _park(self) -> None:
        """Keep exactly one cursor event in the queue, armed at the side
        heap's head (time, ticket) -- the precise slot the baseline's
        deliver event for that message would occupy."""
        if not self._side:
            if self._cursor is not None:
                self._cursor.cancel()
                self._cursor = None
                self._cursor_key = None
            return
        head = self._side[0]
        key = (head.at, head.ticket)
        if self._cursor is not None and not self._cursor.cancelled \
                and self._cursor_key == key:
            return
        if self._cursor is not None:
            self._cursor.cancel()
        self._cursor = self.queue.add_ticketed_at(head.at, head.ticket,
                                                  self._drain)
        self._cursor_key = key

    def _drain(self) -> None:
        """Deliver the head message, then every further side-heap message
        due before the queue's next live event. peek() is re-read on every
        iteration so replies/timeouts/ticks created by a delivery regain
        control exactly where the baseline would hand it to them."""
        self._draining = True
        self._cursor = None
        self._cursor_key = None
        self.mstats["message_plane_batches"] += 1
        q = self.queue
        first = True
        try:
            while self._side:
                head = self._side[0]
                if not first:
                    nxt = q.peek()
                    if nxt is not None and nxt < (head.at, head.ticket):
                        break
                    q.now_micros = max(q.now_micros, head.at)
                heapq.heappop(self._side)
                first = False
                head.released = True
                self.mstats["message_plane_fires"] += 1
                self._release(head)
                head.fire()
        finally:
            self._draining = False
            self._park()

    def _release(self, entry: _MailMsg) -> None:
        # free the device slot BEFORE firing: the fire path may drop the
        # message (dead destination) and must not leak the slot
        if entry.slot is not None and self._plane is not None:
            self._plane.release(entry.slot)

    def _resolve(self, entry: _MailMsg) -> Optional[bytes]:
        """Bytes to decode at delivery: the device-routed mailbox copy when
        it landed and verifies against the staged host bytes, else the host
        copy (counted). The host copy is always retained, so the device
        path can never diverge -- only degrade, visibly."""
        if entry.payload is None:
            return None  # loopback / serialize=False: live object delivery
        plane = self._plane
        if plane is None or entry.slot is None:
            if plane is not None:
                self.mstats["mailbox_early_deliveries"] += 1
            return entry.payload
        dev = plane.read_landed(entry)
        if dev == entry.payload:
            self.mstats["device_messages_delivered"] += 1
            return dev
        self.mstats["mailbox_verify_fallbacks"] += 1
        return entry.payload


class SimMessageSink(MessageSink):
    def __init__(self, network: SimNetwork, node_id: NodeId):
        self.network = network
        self.node_id = node_id

    def send(self, to: NodeId, request) -> None:
        self.network.send_request(self.node_id, to, request, None)

    def send_with_callback(self, to: NodeId, request, callback: Callback) -> None:
        self.network.send_request(self.node_id, to, request, callback)

    def reply(self, to: NodeId, reply_context: ReplyContext, reply) -> None:
        self.network.send_reply(self.node_id, reply_context, reply)
