"""The device message plane through the port (accord_tpu_torch/ops/mailbox.py,
sim/network.DeviceMessageNetwork), with the plain versions on the CPU: the
port of tests/test_message_plane.py, plus the routing stage (K17's plain
version) and MailboxPlane held against the JAX package's on the same
inputs, and a megakernel device-messages burn held against the JAX
package's history and mailbox counters.

Every comparison is exact (bit-equal lanes, equal histories and counters).
One counter differs by construction: `mailbox_bytes_staged` counts pickled
payload bytes, and a pickle names its classes' modules, which are
`accord_tpu_torch.*` here and `accord_tpu.*` there.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from accord_tpu.ops import mailbox as jmb
from accord_tpu.sim.mesh_burn import run_mesh_burn as jax_mesh_burn
from accord_tpu_torch.ops import carry
from accord_tpu_torch.ops.mailbox import (MailboxPlane, mailbox_route,
                                          mailbox_route_plain, pack_words,
                                          unpack_words)
from accord_tpu_torch.sim.burn import run_burn
from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
from accord_tpu_torch.sim.network import (DeviceMessageNetwork, LinkConfig,
                                          LinkMatrix, SimNetwork)
from accord_tpu_torch.sim.queue import PendingQueue
from accord_tpu_torch.utils.rng import RandomSource
from torch_kernel_cases import ROUTE_HAZARDS, route_case

pytestmark = pytest.mark.message_plane

_ROUTE = jax.jit(jmb._mailbox_route_body)


# -- queue ticket primitives --------------------------------------------------

def test_queue_tickets_share_event_sequence():
    """ticket() consumes the same counter add() stamps onto events, so a
    ticketed message occupies exactly the heap position the baseline's
    deliver event would have."""
    q = PendingQueue()
    fired = []
    q.add(10, lambda: fired.append("a"))    # seq 0
    t = q.ticket()                          # seq 1 -- the parked message
    q.add(10, lambda: fired.append("c"))    # seq 2
    q.add_ticketed_at(q.now_micros + 10, t, lambda: fired.append("b"))
    q.drain()
    assert fired == ["a", "b", "c"]


def test_queue_peek_skips_cancelled_heads():
    q = PendingQueue()
    t0 = q.now_micros
    h = q.add(5, lambda: None)
    q.add(9, lambda: None)
    assert q.peek() == (t0 + 5, 0)
    h.cancel()
    assert q.peek() == (t0 + 9, 1)
    q.drain()
    assert q.peek() is None


# -- payload packing ----------------------------------------------------------

def test_pack_unpack_roundtrip():
    for n in (0, 1, 3, 4, 5, 63, 64, 251, 252):
        payload = bytes(range(256))[:n]
        w = pack_words(payload, 64)
        assert w is not None and w.shape == (64,)
        assert unpack_words(w) == payload
        assert np.array_equal(w, jmb.pack_words(payload, 64))
    assert pack_words(b"x" * 252, 64) is not None
    assert pack_words(b"x" * 253, 64) is None


# -- link matrix --------------------------------------------------------------

def test_link_matrix_regional_asymmetry():
    m = LinkMatrix.regional(12, regions=3, asymmetry=0.5)
    east = m.config(1, 12)
    west = m.config(12, 1)
    assert east.min_latency_us > west.min_latency_us
    assert east.max_latency_us > west.max_latency_us
    a, b = m.config(1, 2), m.config(2, 1)
    assert (a.min_latency_us, a.max_latency_us) == \
        (b.min_latency_us, b.max_latency_us)


def test_link_matrix_latency_draws_within_bounds():
    m = LinkMatrix(4)
    m.set(1, 2, LinkConfig(100, 200))
    m.set(2, 1, LinkConfig(5_000, 9_000))
    net = SimNetwork(PendingQueue(), RandomSource(3), link_matrix=m)
    for _ in range(50):
        assert 100 <= net._latency(1, 2) <= 200
        assert 5_000 <= net._latency(2, 1) <= 9_000


# -- unit-level network behaviour --------------------------------------------

class _StubNode:
    def __init__(self, nid):
        self.id = nid
        self.got = []

    def receive(self, msg, src, ctx):
        self.got.append((msg, src))


def _pair(net_cls, seed=7, **kw):
    q = PendingQueue()
    net = net_cls(q, RandomSource(seed), serialize=False, **kw)
    a, b = _StubNode(1), _StubNode(2)
    net.register_node(a)
    net.register_node(b)
    return q, net, a, b


def test_device_network_delivery_order_matches_host():
    results = []
    for cls in (SimNetwork, DeviceMessageNetwork):
        q, net, a, b = _pair(cls)
        for i in range(40):
            net.send_request(1 if i % 3 else 2, 2 if i % 3 else 1, i, None)
        q.drain()
        results.append((list(b.got), list(a.got), dict(net.stats)))
    assert results[0] == results[1]


def test_drop_accounting_matches_host():
    for cls in (SimNetwork, DeviceMessageNetwork):
        q, net, a, b = _pair(cls)
        net.set_link(1, 2, LinkConfig(100, 200, drop_probability=1.0))
        for i in range(10):
            net.send_request(1, 2, i, None)
            net.send_request(2, 1, i, None)
        q.drain()
        assert net.stats["dropped"] == 10
        assert net.stats["delivered"] == 10
        assert b.got == []
        assert len(a.got) == 10


def test_partition_symmetry():
    for cls in (SimNetwork, DeviceMessageNetwork):
        q, net, a, b = _pair(cls)
        net.set_partitioned(1, 2, True)
        net.send_request(1, 2, "x", None)
        net.send_request(2, 1, "y", None)
        q.drain()
        assert a.got == [] and b.got == []
        net.set_partitioned(1, 2, False)
        net.send_request(1, 2, "x", None)
        net.send_request(2, 1, "y", None)
        q.drain()
        assert len(a.got) == 1 and len(b.got) == 1


def test_mailbox_partition_mask_symmetric():
    plane = MailboxPlane(4, depth=4, words=8, device="cpu")
    plane.set_partitions({frozenset((1, 3))}, version=1)
    part = plane.part.numpy()
    assert bool(part[1, 3]) and bool(part[3, 1])
    assert not part[1, 2] and not part[2, 4]
    assert plane.counters()["mailbox_partition_epochs"] == 1


def test_mailbox_plane_needs_card_or_cpu_and_one_shard():
    """The plane's device is the card unless the CPU is asked for; a
    sharded plane takes one device, or one per shard (a list of one
    repeated device keeps one node-major arena)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MailboxPlane(4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MailboxPlane(4, shards=2, device=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="3 devices for 2 shards"):
        MailboxPlane(4, shards=2, device=["cpu"] * 3)
    plane = MailboxPlane(4, shards=2, device=["cpu"] * 2)
    assert plane.shard_devices is None
    assert (plane.npsh, plane.rows_nodes) == (3, 6)


# -- burn differentials (engine-less batched drain) ---------------------------

def test_burn_differential_batched_drain():
    kw = dict(ops=60, nodes=3, concurrency=4, collect_log=True)
    host = run_burn(7, **kw)
    dev = run_burn(7, device_messages=True, **kw)
    assert host.log == dev.log
    assert dev.counters["message_plane_batches"] > 0
    assert dev.counters["messages_per_host_callback"] > 2.0
    assert dev.counters["mailbox_verify_fallbacks"] == 0
    assert "message_plane_batches" not in host.counters


def test_burn_differential_range_traffic_and_chaos():
    kw = dict(ops=50, nodes=3, concurrency=4, collect_log=True,
              chaos_drop=0.08, chaos_partitions=True,
              range_read_ratio=0.2, range_write_ratio=0.1)
    host = run_burn(13, **kw)
    dev = run_burn(13, device_messages=True, **kw)
    assert host.log == dev.log


def test_burn_device_messages_reconcile():
    kw = dict(ops=50, nodes=3, concurrency=4, collect_log=True,
              device_messages=True)
    assert run_burn(19, **kw).log == run_burn(19, **kw).log


# -- K17: the routing stage against the JAX body ------------------------------

def _lanes(rng, n, depth, words, L, n_emit, collide=False, cuts=()):
    """Seeded emit lanes: n_emit real emits with distinct (dst, slot), the
    rest keep=False pads; `collide` makes one landed emit target node n,
    slot depth-1 (row rows-1, where every non-landing emit gathers back)."""
    pairs = [(d, s) for d in range(1, n + 1) for s in range(depth)]
    pick = rng.choice(len(pairs), n_emit, replace=False)
    src = np.zeros(L, np.int32)
    dst = np.zeros(L, np.int32)
    slot = np.zeros(L, np.int32)
    keep = np.zeros(L, bool)
    for i, p in enumerate(pick):
        dst[i], slot[i] = pairs[p]
        src[i] = rng.integers(1, n + 1)
        keep[i] = True
    if collide:
        src[0], dst[0], slot[0] = n, n, depth - 1
        others = (dst[1:n_emit] == n) & (slot[1:n_emit] == depth - 1)
        keep[1:n_emit][others] = False
    kind = rng.integers(1, 20, L).astype(np.int32)
    seq = rng.integers(0, 1 << 31, L).astype(np.int32)
    w = rng.integers(-(1 << 31), 1 << 31, (L, words)).astype(np.int32)
    part = np.zeros((n + 1, n + 1), bool)
    for a, b in cuts:
        part[a, b] = part[b, a] = True
    return src, dst, slot, keep, kind, seq, w, part


@pytest.mark.parametrize("n,depth,words,L,n_emit,collide,cuts", [
    (4, 4, 8, 8, 5, False, ()),             # keep=False pads
    (4, 4, 8, 16, 16, True, ((1, 2), (3, 4))),  # a full ring + cuts
    (3, 2, 16, 8, 6, True, ((1, 3),)),      # every slot, the collision
])
def test_mailbox_route_plain_matches_jax(n, depth, words, L, n_emit,
                                         collide, cuts):
    """Tolerance: bit-equal on all five outputs (arena, meta, landed
    words, landed meta, land), including a non-landing emit's gather-back
    of row rows-1 after an emit landed there in the same call."""
    rng = np.random.default_rng(17 + L + n)
    rows = (n + 1) * depth
    arena = rng.integers(-50, 50, (rows, words)).astype(np.int32)
    meta = rng.integers(-5, 5, (rows, 3)).astype(np.int32)
    src, dst, slot, keep, kind, seq, w, part = _lanes(
        rng, n, depth, words, L, n_emit, collide, cuts)
    if cuts:
        src[1], dst[1] = cuts[0]    # a cut link on a kept lane
        keep[1] = True
    ref = _ROUTE(arena, meta, src, dst, slot, keep, kind, seq, w, part)
    a, m, p = carry.mailbox_state(arena, meta, part)
    got = mailbox_route(a, m, *(torch.from_numpy(x) for x in (
        src, dst, slot, keep, kind, seq, w)), p)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())
    assert got[0] is a and got[1] is m          # updated in place
    land = np.asarray(ref[4])
    if collide:
        assert land[0] and (~land).any()
        assert np.array_equal(np.asarray(ref[2])[~land][0], w[0])


def test_mailbox_route_plain_out_of_range_lanes():
    """Lanes the plane never stages (dst past the last node, negative
    src) follow the reference's gather and .at[] rules bit for bit."""
    rng = np.random.default_rng(3)
    n, depth, words, L = 3, 2, 8, 8
    rows = (n + 1) * depth
    arena = np.zeros((rows, words), np.int32)
    meta = np.zeros((rows, 3), np.int32)
    src = np.array([1, -1, 2, 9, 0, 3, 1, 2], np.int32)
    dst = np.array([5, 2, -1, 1, 0, 3, 2, 1], np.int32)
    slot = np.array([0, 1, 0, 0, 1, 1, 0, 3], np.int32)
    keep = np.ones(L, bool)
    kind = np.arange(L, dtype=np.int32)
    seq = np.arange(L, dtype=np.int32) * 7
    w = rng.integers(0, 100, (L, words)).astype(np.int32)
    part = np.zeros((n + 1, n + 1), bool)
    ref = _ROUTE(arena, meta, src, dst, slot, keep, kind, seq, w, part)
    a, m, p = carry.mailbox_state(arena, meta, part)
    got = mailbox_route_plain(a, m, *(torch.from_numpy(x) for x in (
        src, dst, slot, keep, kind, seq, w)), p)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("hazard", ROUTE_HAZARDS)
def test_mailbox_route_plain_clamped_rows_match_jax(hazard):
    """K17's clamped rows (tests/torch_kernel_cases.route_case): a lane
    landing on row rows-1 or row 0 while other lanes gather that row
    back, a negative dst whose flat wraps once, a flat < -rows, a landed
    flat >= rows and every link cut. Tolerance: bit-equal on all five
    outputs; a writer's words come back on every lane reading its row."""
    rng = np.random.default_rng(40 + ROUTE_HAZARDS.index(hazard))
    ins, writers = route_case(rng, 4, 4, 8, 16, hazard)
    ref = _ROUTE(*ins)
    a, m, p = carry.mailbox_state(ins[0], ins[1], ins[9])
    got = mailbox_route_plain(a, m, *(torch.from_numpy(x)
                                      for x in ins[2:9]), p)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())
    landed, land = np.asarray(ref[2]), np.asarray(ref[4])
    for q in writers:
        assert (landed == ins[8][q]).all(1).sum() > 1
    if hazard == "wrap_once":
        assert land[-1] and np.array_equal(landed[-1], ins[8][-1])
    assert land.any() != (hazard == "all_cut")


class _Entry:
    def __init__(self, src, dst, kind, ticket, payload):
        self.src, self.dst, self.kind = src, dst, kind
        self.ticket, self.payload = ticket, payload
        self.slot = None


def test_mailbox_plane_matches_jax_plane():
    """The same entries through both planes (with a partition epoch, a
    ring that fills, an oversize payload, and releases between batches):
    the same emit lanes, the same routed outputs, the same landed reads
    and every counter equal."""
    rng = np.random.default_rng(11)
    planes = (jmb.MailboxPlane(4, depth=3, words=16),
              MailboxPlane(4, depth=3, words=16, device="cpu"))
    for p in planes:
        p.set_partitions({frozenset((1, 2))}, version=1)
    reads = ([], [])
    for batch in range(3):
        specs = []
        for i in range(7):
            src, dst = (int(x) for x in rng.choice(np.arange(1, 5), 2,
                                                   replace=False))
            size = 70 if i == 6 else int(rng.integers(0, 40))
            specs.append((src, dst, int(rng.integers(1, 9)),
                          batch * 100 + i + (1 << 31) * (i % 2),
                          rng.bytes(size)))
        for k, plane in enumerate(planes):
            ents = [_Entry(*s) for s in specs]
            block = plane.stage_batch(ents)
            if k == 0:
                outs = _ROUTE(*block)
                jlanes = [np.asarray(x) for x in block[2:9]]
            else:
                assert all(np.array_equal(a, b)
                           for a, b in zip(jlanes, block[2:9]))
                outs = mailbox_route(*block)
                for r, g in zip(jouts, outs):
                    assert np.array_equal(np.asarray(r), g.numpy())
            plane.adopt(outs)
            if k == 0:
                jouts = outs
            reads[k].append([e.slot is not None and plane.read_landed(e)
                             for e in ents])
            for e in ents[:4]:
                if e.slot is not None:
                    plane.release(e.slot)
    assert reads[0] == reads[1]
    assert planes[0].counters() == planes[1].counters()
    assert planes[1].counters()["mailbox_overflow_spills"] > 0


# -- fused mailbox routing (tick engine attached) -----------------------------

def _mail_counters(rep):
    return {k: v for k, v in rep.counters.items()
            if ("mailbox" in k or "message" in k)
            and k != "mailbox_bytes_staged"}


def test_megakernel_device_messages_differential():
    """The full path on the CPU: payload bytes ride the mailbox stage of
    the single fused protocol_tick, every delivery verifies against the
    staged host bytes, and the committed history is bit-identical to the
    host-message megakernel run and to the JAX package's device-messages
    run, with equal mailbox counters."""
    kw = dict(ops=40, nodes=3, megakernel=True, collect_log=True)
    host, _ = run_mesh_burn(5, device="cpu", **kw)
    dev, eng = run_mesh_burn(5, device_messages=True, device="cpu", **kw)
    ref, _ = jax_mesh_burn(5, device_messages=True, **kw)
    assert host.log == dev.log == ref.log
    c = dev.counters
    assert c["device_messages_delivered"] > 0
    assert c["mailbox_verify_fallbacks"] == 0
    assert c["mailbox_overflow_spills"] == 0
    assert c["launches_per_tick"] == 1.0
    assert c["messages_per_host_callback"] > 2.0
    assert _mail_counters(dev) == _mail_counters(ref)
    assert c["mailbox_bytes_staged"] > 0
    assert eng._net._plane.device == torch.device("cpu")


@pytest.mark.slow
def test_megakernel_device_messages_chaos_seeds():
    kw = dict(ops=70, nodes=4, megakernel=True, collect_log=True,
              chaos_drop=0.05, chaos_partitions=True, crash_restart=True,
              device="cpu")
    for seed in (23, 31):
        host, _ = run_mesh_burn(seed, **kw)
        dev, _ = run_mesh_burn(seed, device_messages=True, **kw)
        assert host.log == dev.log, f"chaos diverged at seed {seed}"
        assert dev.counters["mailbox_verify_fallbacks"] == 0


@pytest.mark.slow
def test_cmd_defer_retired_rides_fused_program():
    """collect_repair blocks ride the fused tick: host-twinned PreAccept
    deferrals fold back through the repair stage, counted retired, with
    the history unchanged (and equal to the JAX package's)."""
    kw = dict(ops=60, nodes=3, megakernel=True, cmd_plane=True,
              collect_log=True)
    host, _ = run_mesh_burn(9, device="cpu", **kw)
    dev, _ = run_mesh_burn(9, device_messages=True, device="cpu", **kw)
    ref, _ = jax_mesh_burn(9, device_messages=True, **kw)
    assert host.log == dev.log == ref.log
    assert dev.counters.get("cmd_defer_retired", 0) > 0
    assert dev.counters["cmd_defer_retired"] == \
        ref.counters["cmd_defer_retired"]


@pytest.mark.slow
def test_seeded_mailbox_corruption_caught_by_verify():
    kw = dict(ops=40, nodes=3, megakernel=True, collect_log=True,
              device="cpu")
    host, _ = run_mesh_burn(5, **kw)
    dev, _ = run_mesh_burn(5, device_messages=True, device_chaos=True,
                           device_fault_rates={"mailbox_rate": 0.25}, **kw)
    assert host.log == dev.log
    injected = dev.device_faults["mailbox"]
    assert injected > 0, "mailbox fault rate 0.25 never drew"
    assert dev.counters["mailbox_verify_fallbacks"] == injected
    assert dev.counters["device_messages_delivered"] > 0


@pytest.mark.slow
def test_tiny_mailbox_overflow_degrades_gracefully():
    kw = dict(ops=40, nodes=3, megakernel=True, collect_log=True,
              device="cpu")
    host, _ = run_mesh_burn(5, **kw)
    dev, _ = run_mesh_burn(5, device_messages=True,
                           mailbox_depth=2, mailbox_words=16, **kw)
    assert host.log == dev.log
    assert dev.counters["mailbox_overflow_spills"] > 0


@pytest.mark.slow
def test_regional_link_matrix_both_paths():
    m = LinkMatrix.regional(6, regions=3)
    kw = dict(ops=50, nodes=6, megakernel=True, collect_log=True,
              link_matrix=m, device="cpu")
    host, _ = run_mesh_burn(17, **kw)
    dev, _ = run_mesh_burn(17, device_messages=True, **kw)
    assert host.log == dev.log
