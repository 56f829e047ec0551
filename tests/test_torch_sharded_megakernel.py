"""The sharded protocol megakernel through the port
(parallel/mesh.sharded_protocol_tick, ops/mailbox.py's sharded layout and
K23's plain version): the port of tests/test_sharded_megakernel.py, on the
CPU mesh `make_mesh(devices=["cpu"] * 8)` (data 4 x model 2, the conftest
mesh's shape), where every stage runs its plain version.

The contract is the megakernel's, extended across shards: bit-identical
committed histories, exactly one launch per dispatching tick, and the
cross-shard mailbox hop landing every payload on its destination shard's
ring. Each tick-level case holds the port's sharded program against the
port's single-device program and the JAX package's sharded_protocol_tick;
K23's plain version is held against the JAX `_sharded_mailbox_route_part`
under shard_map on the raw landed arrays. Each burn's history must equal
the port's per-node host loop and the JAX package's run_mesh_burn (its
per-node host loop, which compiles in seconds; the cases against the JAX
package's sharded megakernel burn, whose shard_map programs take longer
to compile, and the seed sweep and the 64-node reconcile are `slow`, as
in the reference).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from accord_tpu.ops import mailbox as jmb
from accord_tpu.ops.encoding import WITNESS_TABLE
from accord_tpu.parallel import mesh as jpm
from accord_tpu.sim.mesh_burn import run_mesh_burn as jax_mesh_burn
from accord_tpu.sim.network import _MailMsg as _JaxMailMsg
from accord_tpu_torch.ops import carry
from accord_tpu_torch.ops import kernels as tk
from accord_tpu_torch.ops.mailbox import (MailboxPlane, sharded_mailbox_route,
                                          sharded_mailbox_route_plain,
                                          shard_parts)
from accord_tpu_torch.parallel import mesh as tpm
from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
from accord_tpu_torch.sim.network import _MailMsg

pytestmark = pytest.mark.sharded_megakernel


@pytest.fixture(scope="module")
def mesh():
    m = tpm.make_mesh(devices=["cpu"] * 8)
    assert m.shape["data"] > 1, "the mesh must shard the node axis"
    return m


@pytest.fixture(scope="module")
def jmesh():
    m = jpm.make_mesh()
    assert len(jax.devices()) >= 8, "conftest should force 8 virtual devices"
    return m


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(ref, got)


def _gate_fused(counters):
    assert counters["megakernel_dispatches"] > 0
    assert counters["launches_per_tick"] == 1.0
    assert counters["sharded_megakernel_fallbacks"] == 0


# -- the sharded mailbox layout and K23 ---------------------------------------

def test_mesh_reports_message_plane_support(mesh):
    assert tpm.mesh_supports_message_plane(mesh)


def _entries(rng, n, count, cls, payload=lambda rng, i: bytes([i]) * 8):
    ents = []
    for i in range(count):
        e = cls(kind=1 + i % 3, src=int(rng.integers(1, n + 1)),
                dst=int(rng.integers(1, n + 1)), payload=payload(rng, i))
        e.ticket = i
        ents.append(e)
    return ents


def test_mailbox_sharded_staging_layout():
    """The sharded emit-lane layout, host side only: lanes grouped by
    (src shard, dst shard) at segment (s*S+t)*bcap, each entry's return
    position receiver-major at (t*S+s)*bcap + j, node v owning rows on
    shard v // npsh -- the same lanes as the JAX plane's -- and the
    shards=1 layout degenerating to the flat staging order."""
    n, S = 6, 4
    rng = np.random.default_rng(4)
    state = rng.bit_generator.state
    ents = _entries(rng, n, 12, _MailMsg)
    rng.bit_generator.state = state
    jents = _entries(rng, n, 12, _JaxMailMsg)
    p = MailboxPlane(n, depth=8, words=16, shards=S, device="cpu")
    assert p.npsh == 2 and p.rows_nodes == 8
    out = p.stage_batch(ents)
    jp = jmb.MailboxPlane(n, depth=8, words=16, shards=S)
    jout = jp.stage_batch(jents)
    assert out is not None
    assert tuple(out[0].shape) == (8 * 8, 16) and tuple(out[9].shape) == (8, 8)
    for a, b in zip(out[2:9], jout[2:9]):
        np.testing.assert_array_equal(a, np.asarray(b))
    e_src, e_dst, e_keep = out[2], out[3], out[5]
    bcap = len(e_src) // (S * S)
    for e, je in zip(ents, jents):
        _batch, pos, dst, _idx = e.slot
        assert pos == je.slot[1] and e.slot[2:] == je.slot[2:]
        s, t = e.src // p.npsh, e.dst // p.npsh
        j = pos - (t * S + s) * bcap
        assert 0 <= j < bcap
        send = (s * S + t) * bcap + j
        assert e_keep[send]
        assert e_src[send] == e.src and e_dst[send] == e.dst
        assert dst == e.dst
    for pos in np.flatnonzero(e_keep):
        s, t = e_src[pos] // p.npsh, e_dst[pos] // p.npsh
        assert (s * S + t) * bcap <= pos < (s * S + t) * bcap + bcap

    rng.bit_generator.state = state
    ents1 = _entries(rng, n, 12, _MailMsg)
    p1 = MailboxPlane(n, depth=8, words=16, shards=1, device="cpu")
    assert p1.npsh == n + 1 and p1.rows_nodes == n + 1
    p1.stage_batch(ents1)
    for j, e in enumerate(ents1):
        assert e.slot[1] == j


def _route_inputs(rng, S, npsh, depth, W, bcap):
    """Random raw route inputs with landed lanes on distinct (dst, slot)
    rings (the plane's staging guarantees it), pads, lanes whose
    destination is another shard's node, and a partition cutting links
    between nodes of different shards."""
    rows_nodes = npsh * S
    L = S * S * bcap
    arena = rng.integers(-9, 9, (rows_nodes * depth, W)).astype(np.int32)
    meta = rng.integers(-9, 9, (rows_nodes * depth, 3)).astype(np.int32)
    part = np.zeros((rows_nodes, rows_nodes), bool)
    for a, b in ((1, npsh + 1), (2, 3 * npsh - 1), (npsh, npsh + 1)):
        part[a, b] = part[b, a] = True
    e = {k: np.zeros(L, np.int32) for k in ("src", "dst", "slot", "kind",
                                            "seq")}
    keep = np.zeros(L, bool)
    words = np.zeros((L, W), np.int32)
    free = {v: list(rng.permutation(depth)) for v in range(rows_nodes)}
    for s in range(S):
        for t in range(S):
            for j in range(int(rng.integers(0, bcap + 1))):
                q = (s * S + t) * bcap + j
                src = int(rng.integers(s * npsh, (s + 1) * npsh))
                dst = int(rng.integers(t * npsh, (t + 1) * npsh))
                if not free[dst]:
                    continue
                e["src"][q], e["dst"][q] = src, dst
                e["slot"][q] = free[dst].pop()
                e["kind"][q] = int(rng.integers(1, 5))
                e["seq"][q] = int(rng.integers(0, 1 << 20))
                keep[q] = True
                words[q] = rng.integers(-1 << 30, 1 << 30, W)
    return (arena, meta, e["src"], e["dst"], e["slot"], keep, e["kind"],
            e["seq"], words, part)


def test_sharded_route_plain_matches_jax_shard_map(jmesh):
    """K23's plain version against the JAX package's
    _sharded_mailbox_route_part under shard_map over 'data', on the raw
    arrays: the updated arena and meta, the landed words and meta
    receiver-major (a non-landing lane gathers its destination shard's
    last row) and the land flags -- with partitions between shards."""
    S = jmesh.shape["data"]

    def part_fn(*args):
        return jmb._sharded_mailbox_route_part(S, "data", *args)
    d1, d2 = P("data"), P("data", None)
    route = jax.jit(jpm.shard_map(
        part_fn, mesh=jmesh,
        in_specs=(d2, d2, d1, d1, d1, d1, d1, d1, d2, d2),
        out_specs=(d2, d2, d2, d2, d1)))
    rng = np.random.default_rng(11)
    landed = cut = 0
    for npsh, depth, W, bcap in ((2, 4, 8, 4), (3, 8, 16, 8)):
        ins = _route_inputs(rng, S, npsh, depth, W, bcap)
        ref = route(*ins)
        arena, meta, part = _t(ins[0]), _t(ins[1]), _t(ins[9])
        got = sharded_mailbox_route_plain(
            S, shard_parts(arena, S), shard_parts(meta, S),
            *(_t(x) for x in ins[2:9]), shard_parts(part, S))
        _same(ref[0], arena)
        _same(ref[1], meta)
        for a, b in zip(ref[2:], got[2:]):
            _same(a, b)
        # the wrapper on CPU tensors runs the same plain version
        arena2, meta2 = _t(ins[0]), _t(ins[1])
        got2 = sharded_mailbox_route(S, arena2, meta2, *ins[2:9], part)
        assert torch.equal(arena2, arena) and all(
            torch.equal(a, b) for a, b in zip(got2[2:], got[2:]))
        land = np.asarray(ref[4])
        keep_recv = ins[5][_recv_positions(S, bcap)]
        landed += int(land.sum())
        cut += int((keep_recv & ~land).sum())
    assert landed and cut, "differential vacuous"


def _recv_positions(S, bcap):
    """Receiver-major position p -> its send position q."""
    p = np.arange(S * S * bcap)
    t, r = p // (S * bcap), p % (S * bcap)
    return (r // bcap * S + t) * bcap + r % bcap


def test_mailbox_cross_shard_parity(mesh, jmesh):
    """The same staged entries routed through the shards=1 single-device
    layout and the shards=data sharded layout land identically --
    including a partition whose endpoints live on DIFFERENT shards -- and
    the sharded plane's raw landed block equals the JAX package's sharded
    tick's."""
    data = mesh.shape["data"]
    table = _t(WITNESS_TABLE)
    rng = np.random.default_rng(3)
    n = 6

    def payload(rng, i):
        return bytes(rng.integers(0, 256, 20).astype(np.uint8))
    state = rng.bit_generator.state
    ents1 = _entries(rng, n, 24, _MailMsg, payload)
    rng.bit_generator.state = state
    ents_s = _entries(rng, n, 24, _MailMsg, payload)
    rng.bit_generator.state = state
    ents_j = _entries(rng, n, 24, _JaxMailMsg, payload)
    parts = {frozenset((1, 4))}     # npsh = ceil(7/4) = 2: shards 0 and 2

    p1 = MailboxPlane(n, depth=8, words=16, shards=1, device="cpu")
    p1.set_partitions(parts, version=1)
    p1.adopt(tk.protocol_tick(table, mailbox=p1.stage_batch(ents1))[5])
    ps = MailboxPlane(n, depth=8, words=16, shards=data, device="cpu")
    ps.set_partitions(parts, version=1)
    out = tpm.sharded_protocol_tick(mesh, table,
                                    mailbox=ps.stage_batch(ents_s))[5]
    ps.adopt(out)
    jp = jmb.MailboxPlane(n, depth=8, words=16, shards=data)
    jp.set_partitions(parts, version=1)
    jout = jpm.sharded_protocol_tick(jmesh, jnp.asarray(WITNESS_TABLE),
                                     mailbox=jp.stage_batch(ents_j))[5]
    for a, b in zip(jout, out):
        _same(a, b)
    cut = 0
    for e1, es in zip(ents1, ents_s):
        r1, rs = p1.read_landed(e1), ps.read_landed(es)
        assert r1 == rs, (e1.src, e1.dst)
        if frozenset((e1.src, e1.dst)) == frozenset((1, 4)):
            assert r1 is None
            cut += 1
        else:
            assert r1 == e1.payload
    assert cut, "the partition cut nothing"


def test_mailbox_per_shard_arenas_match_node_major(mesh):
    """A plane that keeps one arena slice and partition-mask block per
    shard (its layout when the shards are on different cards, here forced
    onto the CPU) routes and reads back exactly as the node-major plane:
    the same landed payloads, the same rings."""
    data = mesh.shape["data"]
    table = _t(WITNESS_TABLE)
    rng = np.random.default_rng(7)

    def payload(rng, i):
        return bytes(rng.integers(0, 256, 30).astype(np.uint8))
    state = rng.bit_generator.state
    ents_a = _entries(rng, 9, 30, _MailMsg, payload)
    rng.bit_generator.state = state
    ents_b = _entries(rng, 9, 30, _MailMsg, payload)
    planes = []
    for ents, per_shard in ((ents_a, False), (ents_b, True)):
        p = MailboxPlane(9, depth=8, words=16, shards=data, device="cpu")
        if per_shard:
            p.shard_devices = (torch.device("cpu"),) * data
        p.set_partitions({frozenset((2, 7))}, version=1)
        p.adopt(tpm.sharded_protocol_tick(mesh, table,
                                          mailbox=p.stage_batch(ents))[5])
        planes.append(p)
    a, b = planes
    assert isinstance(b.arena, tuple) and len(b.arena) == data
    assert torch.equal(a.arena, torch.cat(b.arena))
    assert torch.equal(a.part, torch.cat(b.part))
    for ea, eb in zip(ents_a, ents_b):
        assert a.read_landed(ea) == b.read_landed(eb)


# -- tick-level differentials (sharded program vs single-device program) ------
# The inputs keep every finalize's word offset within its window (word_off
# <= words - w): there the JAX package's sharded finalize slices the packed
# block differently from its single-device finalize_csr (ROADMAP, queue 3),
# and the port follows finalize_csr.

def _key_tick(rng, data, model):
    cap = 32 * data * 2
    K = 32 * model
    b, z, ns, kc, oc = 16, 32, 2, 8, 64
    w = cap // 32
    arenas = [((rng.random((cap, K)) < 0.1).astype(np.float32),
               rng.integers(0, 100, (cap, 3)).astype(np.int32),
               rng.integers(0, 6, cap).astype(np.int32),
               rng.random(cap) < 0.9) for _ in range(ns)]
    lanes = (rng.integers(0, b, z).astype(np.int32),
             rng.integers(0, K, z).astype(np.int32),
             rng.integers(0, ns, b).astype(np.int32),
             rng.integers(50, 150, (b, 3)).astype(np.int32),
             rng.integers(0, 6, b).astype(np.int32),
             np.arange(ns, dtype=np.int32))
    kid = rng.integers(0, 2 ** 32, (kc, w), dtype=np.uint64).astype(np.uint32)
    fin = (rng.integers(0, b, 12).astype(np.int32),
           rng.integers(0, kc, 12).astype(np.int32),
           rng.integers(-1, cap, b).astype(np.int32))
    jar = tuple(tuple(jnp.asarray(x) for x in a) for a in arenas)
    tar = tuple(tuple(carry.arena_lanes((a[0], a[1], a[1], a[2], a[3]))[i]
                      for i in (0, 1, 3, 4)) for a in arenas)
    jkey = tuple(jnp.asarray(x) for x in lanes) + (jar,)
    tkey = lanes + (tar,)
    jfins = tuple(("key", 0, lo, b, w, 0, jnp.asarray(kid),
                   *(jnp.asarray(x) for x in fin), jar[0][1], oc)
                  for lo in (0, w))
    tfins = tuple(("key", 0, lo, b, w, 0, carry.kid_table(kid),
                   *(_t(x) for x in fin), tar[0][1], oc) for lo in (0, w))
    return jkey, jfins, tkey, tfins


def test_sharded_tick_key_finalize_matches_single_device(mesh, jmesh):
    """Key resolve + two finalize-CSR compactions on different store
    spans: the port's sharded program equals its single-device program
    and the JAX package's sharded program, packed words and every CSR
    output, bit for bit."""
    rng = np.random.default_rng(1)
    jkey, jfins, tkey, tfins = _key_tick(rng, mesh.shape["data"],
                                         mesh.shape["model"])
    table = _t(WITNESS_TABLE)
    ref = jpm.sharded_protocol_tick(jmesh, jnp.asarray(WITNESS_TABLE),
                                    key_in=jkey, fins=jfins)
    got = tpm.sharded_protocol_tick(mesh, table, key_in=tkey, fins=tfins)
    one = tk.protocol_tick(table, key_in=tkey, fins=tfins)
    _same(ref[0], got[0])
    _same(ref[0], one[0])
    totals = []
    for fr, fg, fo in zip(ref[2], got[2], one[2]):
        for a, c, d in zip(fr, fg, fo):
            _same(a, c)
            _same(a, d)
        totals.append(int(np.asarray(fr[0])[-1]))
    assert all(totals), f"a finalize found no deps: {totals}"


def test_sharded_tick_range_resolve_matches_single_device(mesh, jmesh):
    data, model = mesh.shape["data"], mesh.shape["model"]
    rng = np.random.default_rng(2)
    cap = 32 * data * 2
    K = 32 * model
    b, z, ns = 16, 32, 2
    arenas = [((rng.random((cap, K)) < 0.1).astype(np.float32),
               rng.integers(0, 100, (cap, 3)).astype(np.int32),
               rng.integers(0, 6, cap).astype(np.int32),
               rng.random(cap) < 0.9) for _ in range(ns)]
    rcap = max(64, 32 * data)
    rars = [(rng.integers(0, 50, rcap).astype(np.int32),
             rng.integers(50, 100, rcap).astype(np.int32),
             rng.integers(0, 100, (rcap, 3)).astype(np.int32),
             rng.integers(0, 6, rcap).astype(np.int32),
             rng.random(rcap) < 0.9) for _ in range(2)]
    sst = rng.integers(0, ns, b).astype(np.int32)
    sb = rng.integers(50, 150, (b, 3)).astype(np.int32)
    sknd = rng.integers(0, 6, b).astype(np.int32)
    slots = np.arange(ns, dtype=np.int32)
    iv_of = rng.integers(0, b, z).astype(np.int32)
    iv_s = rng.integers(0, 80, z).astype(np.int32)
    iv_e = (iv_s + rng.integers(1, 20, z)).astype(np.int32)
    srng = rng.random(b) < 0.5
    lanes = (iv_of, iv_s, iv_e, sst, sb, sknd, srng)
    jrng = (tuple(map(jnp.asarray, lanes))
            + (jnp.asarray(slots), tuple(tuple(map(jnp.asarray, r))
                                         for r in rars),
               jnp.asarray(slots), tuple(tuple(map(jnp.asarray, a))
                                         for a in arenas)))
    tar = tuple(tuple(carry.arena_lanes((a[0], a[1], a[1], a[2], a[3]))[i]
                      for i in (0, 1, 3, 4)) for a in arenas)
    trng = lanes + (slots, tuple(carry.range_lanes(r) for r in rars), slots,
                    tar)
    table = _t(WITNESS_TABLE)
    ref = jpm.sharded_protocol_tick(jmesh, jnp.asarray(WITNESS_TABLE),
                                    rng_in=jrng)
    got = tpm.sharded_protocol_tick(mesh, table, rng_in=trng)
    one = tk.protocol_tick(table, rng_in=trng)
    for a, c, d in zip(ref[1], got[1], one[1]):
        _same(a, c)
        _same(a, d)
    assert int(np.asarray(ref[1][0]).any()) and int(np.asarray(
        ref[1][1]).any()), "differential vacuous"


# -- burn differentials (sharded engine vs the host loops) ---------------------

def _legs(mesh, seed, sharded_kw, **kw):
    """(port per-node host loop, port sharded megakernel, JAX per-node host
    loop) histories of one seeded burn, and the sharded run's counters."""
    kw = dict(collect_log=True, **kw)
    host, _ = run_mesh_burn(seed, megakernel=False, mesh_tick=False,
                            device="cpu", **kw)
    sh, _ = run_mesh_burn(seed, megakernel=True, sharded=True, mesh=mesh,
                          **sharded_kw, **kw)
    ref, _ = jax_mesh_burn(seed, megakernel=False, mesh_tick=False, **kw)
    return host.log, sh.log, ref.log, sh.counters


def test_sharded_burn_matches_single_device_and_host(mesh):
    kw = dict(ops=30, nodes=3)
    host, sh, ref, c = _legs(mesh, 5, {}, **kw)
    single, _ = run_mesh_burn(5, megakernel=True, device="cpu",
                              collect_log=True, **kw)
    assert host == single.log == sh == ref
    _gate_fused(c)


def test_sharded_burn_range_traffic(mesh):
    host, sh, ref, c = _legs(mesh, 9, {}, ops=25, nodes=3,
                             range_read_ratio=0.3, range_write_ratio=0.2)
    assert host == sh == ref
    _gate_fused(c)


def test_sharded_device_messages_match_host(mesh):
    host, sh, ref, c = _legs(mesh, 5, dict(device_messages=True), ops=30,
                             nodes=3)
    assert host == sh == ref
    _gate_fused(c)
    assert c["device_messages_delivered"] > 0
    assert c["mailbox_verify_fallbacks"] == 0
    assert c["mailbox_overflow_spills"] == 0


def test_sharded_chaos_crash_restart_parity(mesh):
    """Seeded drops + partitions (masks spanning shard boundaries) +
    crash/restart stay bit-identical through the sharded plane."""
    host, sh, ref, c = _legs(mesh, 23, dict(device_messages=True), ops=30,
                             nodes=4, chaos_drop=0.05, chaos_partitions=True,
                             crash_restart=True)
    assert host == sh == ref
    assert c["mailbox_verify_fallbacks"] == 0


def test_tiny_ring_spills_degrade_not_diverge(mesh):
    """A 2-slot ring cannot hold the traffic: entries spill to the host
    path (counted) and the committed history does not move."""
    host, sh, ref, c = _legs(mesh, 5, dict(device_messages=True), ops=25,
                             nodes=3, mailbox_depth=2, mailbox_words=16)
    assert host == sh == ref
    assert c["mailbox_overflow_spills"] > 0
    assert c["mailbox_verify_fallbacks"] == 0


def test_sharded_exec_flush_goes_through_the_mesh(mesh, monkeypatch):
    """The exec-only flush of a sharded engine (a harvest coming due with
    no cluster tick in between) launches through sharded_protocol_tick, as
    the reference's flush_exec does, and the exec-in-megakernel burn
    commits the JAX package's history."""
    calls = {"exec_only": 0}
    real = tpm.sharded_protocol_tick

    def spy(m, table, **kw):
        if set(kw) == {"execs"}:
            calls["exec_only"] += 1
        return real(m, table, **kw)
    monkeypatch.setattr(tpm, "sharded_protocol_tick", spy)
    kw = dict(ops=30, nodes=4, rf=3, stores_per_node=2, key_count=24,
              concurrency=8, exec_plane=True, exec_compact=True,
              collect_log=True)
    sh, eng = run_mesh_burn(13, megakernel=True, exec_in_megakernel=True,
                            sharded=True, mesh=mesh, **kw)
    ref, _ = jax_mesh_burn(13, megakernel=False, mesh_tick=False, **kw)
    assert sh.log == ref.log
    snap = eng.snapshot()
    assert snap["exec_scan_blocks"] > 0
    assert snap["exec_flush_ticks"] > 0
    assert calls["exec_only"] == snap["exec_flush_ticks"]
    _gate_fused(snap)


# -- against the JAX package's sharded megakernel burn (slow) ------------------

@pytest.mark.slow
def test_sharded_burn_matches_jax_sharded_megakernel(mesh):
    kw = dict(ops=30, nodes=3, collect_log=True, device_messages=True,
              megakernel=True, sharded=True)
    sh, _ = run_mesh_burn(5, mesh=mesh, **kw)
    ref, _ = jax_mesh_burn(5, **kw)
    assert sh.log == ref.log
    for k in ("device_messages_delivered", "mailbox_overflow_spills",
              "mailbox_verify_fallbacks", "megakernel_dispatches",
              "launches_per_tick", "sharded_megakernel_fallbacks"):
        assert sh.counters[k] == ref.counters[k], k


@pytest.mark.slow
def test_sharded_chaos_seed_sweep(mesh):
    kw = dict(ops=40, nodes=4, collect_log=True, chaos_drop=0.05,
              chaos_partitions=True)
    for seed in (7, 8, 9, 10):
        host, _ = run_mesh_burn(seed, megakernel=True, device="cpu", **kw)
        dev, _ = run_mesh_burn(seed, megakernel=True, device_messages=True,
                               sharded=True, mesh=mesh, **kw)
        assert host.log == dev.log, f"seed {seed} diverged"
        assert dev.counters["mailbox_verify_fallbacks"] == 0


@pytest.mark.slow
def test_sharded_reconcile_64_nodes(mesh):
    """The --reconcile contract at cluster scale: two same-seed sharded
    megakernel burns are bit-identical, and match the per-node loop."""
    kw = dict(ops=40, nodes=64, rf=5, collect_log=True)
    a, _ = run_mesh_burn(11, megakernel=True, sharded=True, mesh=mesh, **kw)
    b, _ = run_mesh_burn(11, megakernel=True, sharded=True, mesh=mesh, **kw)
    assert a.log == b.log, "sharded megakernel burn is non-deterministic"
    loop, _ = run_mesh_burn(11, megakernel=False, mesh_tick=False,
                            device="cpu", **kw)
    assert a.log == loop.log
    _gate_fused(a.counters)
