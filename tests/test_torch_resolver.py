"""The port's BatchDepsResolver (on the CPU, its kernels' plain versions)
against the JAX BatchDepsResolver and the host scan.

Every scenario is written once and run on both packages: the same seed
builds the same cluster, registrations and subjects, and the answers are
compared as canonical tuples (keys and txn-id strings), since the two
packages' Deps classes are distinct types. The port must also match its
own host scan, and never fall back to it (host_fallbacks == 0).
"""
from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import pytest


def _pkg(root: str) -> SimpleNamespace:
    m = {name: importlib.import_module(f"{root}.{name}") for name in (
        "local.cfk", "local.commands", "ops.resolver", "primitives.keyspace",
        "primitives.timestamp", "primitives.txn", "sim.cluster",
        "sim.list_store")}
    ts = m["primitives.timestamp"]
    ls = m["sim.list_store"]
    return SimpleNamespace(
        root=root, CfkStatus=m["local.cfk"].CfkStatus,
        commands=m["local.commands"],
        BatchDepsResolver=m["ops.resolver"].BatchDepsResolver,
        Keys=m["primitives.keyspace"].Keys, TxnId=ts.TxnId,
        TxnKind=ts.TxnKind, Domain=ts.Domain, Timestamp=ts.Timestamp,
        Txn=m["primitives.txn"].Txn, Cluster=m["sim.cluster"].Cluster,
        ClusterConfig=m["sim.cluster"].ClusterConfig,
        ListQuery=ls.ListQuery, ListRead=ls.ListRead,
        ListUpdate=ls.ListUpdate)


JAX = _pkg("accord_tpu")
PORT = _pkg("accord_tpu_torch")


def _resolver(P, **kw):
    if P is PORT:
        kw["device"] = "cpu"
    return P.BatchDepsResolver(**kw)


def _canon(deps):
    """Deps -> ((key, (txn id strings...)), ...) for both packages."""
    assert deps.range_deps.is_empty()
    return tuple((int(k), tuple(str(t) for t in ids))
                 for k, ids in deps.key_deps.items())


def _node(P, stores=1):
    cluster = P.Cluster(1, P.ClusterConfig(
        num_nodes=1, rf=1, num_shards=1, stores_per_node=stores,
        progress=False))
    node = cluster.nodes[1]
    return cluster, node, node.command_stores.stores


def _preaccept_population(P, store, node, keys_list):
    ids = []
    for i, keys in enumerate(keys_list):
        k = P.Keys(keys)
        txn = P.Txn(P.TxnKind.WRITE, k, read=P.ListRead(k),
                    update=P.ListUpdate(k, i + 1), query=P.ListQuery())
        tid = node.next_txn_id(txn.kind, txn.domain)
        P.commands.preaccept(store, tid, txn.slice(store.ranges, False),
                             node.compute_route(txn))
        ids.append(tid)
    return ids


def _register_keys(P, store, node, key_lists):
    tids = []
    for i, ks in enumerate(key_lists):
        ts = node.unique_now()
        kind = P.TxnKind.WRITE if i % 3 else P.TxnKind.READ
        tid = P.TxnId.create(ts.epoch, ts.hlc, ts.node, kind, P.Domain.KEY)
        store.register(tid, P.Keys(ks), P.CfkStatus.WITNESSED, ts)
        tids.append(tid)
    return tids


def _far(P, node):
    return P.Timestamp(node.epoch, node.time_service.now_micros() + 50_000,
                       0, node.id)


def _store_lo(store):
    return min(int(r.start) for r in store.ranges)


# -- scenarios (each returns canonical answers + the resolver) ---------------
def _sync_single_store(P, seed):
    rng = np.random.default_rng(seed)
    _, node, (store,) = _node(P)
    keys_list = [sorted(set(rng.integers(0, 40, rng.integers(1, 4))
                            .tolist())) for _ in range(60)]
    ids = _preaccept_population(P, store, node, keys_list)
    res = _resolver(P, num_buckets=128, initial_cap=128)
    store.deps_resolver = res
    pick = rng.choice(len(ids), 24, replace=False)
    subjects = [(ids[i], P.Keys(keys_list[i]),
                 store.command(ids[i]).execute_at) for i in pick]
    got = res.resolve_batch(store, subjects)
    host = [store.host_calculate_deps(t, k, b) for t, k, b in subjects]
    return [_canon(d) for d in got], [_canon(d) for d in host], res


def _async_two_store(P, seed, overlap_host=True, finalize=True):
    rng = np.random.default_rng(seed)
    cluster, node, stores = _node(P, stores=2)
    res = _resolver(P, num_buckets=128, initial_cap=64,
                    overlap_host=overlap_host, finalize_on_device=finalize)
    for s in stores:
        s.deps_resolver = res
        s.batch_window_ms = 0.5
    node.device_latency_ms = 5.0
    answers, hosts = [], []
    for wave in range(3):
        # registrations between waves: the arenas outgrow initial_cap once
        # their device lanes exist, so growth runs on the device (arena_grow)
        for s in stores:
            lo = _store_lo(s)
            _register_keys(P, s, node, [
                sorted({lo + int(k) for k in rng.integers(0, 48, 1 + i % 4)})
                for i in range(30)])
        subs = []
        for s in stores:
            lo = _store_lo(s)
            for i in range(6 + 4 * wave):
                kind = P.TxnKind.WRITE if i % 2 else P.TxnKind.READ
                owned = s.owned(P.Keys(sorted(
                    {lo + int(k) for k in rng.integers(0, 48, 1 + i % 3)})))
                subs.append((s, node.next_txn_id(kind, P.Domain.KEY), owned,
                             _far(P, node)))
        outs = [res.enqueue_deps(s, t, o, b) for s, t, o, b in subs]
        cluster.queue.drain(max_events=100_000)
        assert all(o.done for o in outs)
        answers += [_canon(o.value()) for o in outs]
        hosts += [_canon(s.host_calculate_deps(t, o, b))
                  for s, t, o, b in subs]
    return answers, hosts, res


@pytest.mark.parametrize("seed", [7, 8])
def test_resolve_batch_single_store_vs_jax_and_host(seed):
    port, port_host, res = _sync_single_store(PORT, seed)
    ref, ref_host, _ = _sync_single_store(JAX, seed)
    assert port == ref
    assert port == port_host and ref_host == port_host
    assert sum(len(d) for d in port) > 0, "differential vacuous"
    assert res.host_fallbacks == 0 and res.finalized_decodes > 0


@pytest.mark.parametrize("seed", [11, 12])
def test_fused_two_store_async_vs_jax_and_host(seed):
    port, port_host, res = _async_two_store(PORT, seed)
    ref, _, jres = _async_two_store(JAX, seed)
    assert port == ref
    assert port == port_host
    assert sum(len(d) for d in port) > 0
    assert res.host_fallbacks == 0 and res.finalize_fallbacks == 0
    # the fused path and the staged launches actually engaged
    assert res.dispatches == jres.dispatches > 0
    assert res.staged_dispatches == res.dispatches
    assert all(a.cap > 64 for a in res._arenas.values())   # grew


def test_staged_vs_serial_and_legacy_decode():
    """overlap_host=False (serial tick) and finalize_on_device=False (the
    legacy unpackbits decode) answer exactly like the host scan, as the
    staged, finalized default does, and like the JAX resolver in the same
    mode. (Registrations between waves take their ids from the clock, so
    the three modes' histories differ from each other.)"""
    for kw in ({}, {"overlap_host": False}, {"finalize": False}):
        got, host, _ = _async_two_store(PORT, 21, **kw)
        ref, _, _ = _async_two_store(JAX, 21, **kw)
        assert got == host == ref
    _, _, sres = _async_two_store(PORT, 21, overlap_host=False)
    _, _, lres = _async_two_store(PORT, 21, finalize=False)
    assert sres.staged_dispatches == 0
    assert lres.legacy_decodes > 0 and lres.finalized_decodes == 0


def _compaction_between_stage_and_dispatch(P):
    rng = np.random.default_rng(37)
    cluster, node, (store,) = _node(P)
    res = _resolver(P, num_buckets=128, initial_cap=128)
    store.deps_resolver = res
    store.batch_window_ms = 0.5
    node.device_latency_ms = 50.0
    chaff_keys = [sorted(set(rng.integers(100, 140, 2).tolist()))
                  for _ in range(50)]
    chaff = _preaccept_population(P, store, node, chaff_keys)
    live_keys = [sorted(set(rng.integers(0, 12, 2).tolist()))
                 for _ in range(40)]
    live = _preaccept_population(P, store, node, live_keys)
    arena = res._arenas[id(store)]
    for t, ks in zip(chaff, chaff_keys):
        res.on_prune(store, t, ks)
    subs = []
    for i in range(20, 26):
        keys = P.Keys(live_keys[i])
        before = store.command(live[i]).execute_at
        subs.append((live[i], keys, before,
                     res.enqueue_deps(store, live[i], keys, before)))
    while not res._staged.get(id(node)):
        assert cluster.queue.process_one(), "stage never cut a plan"
    assert res.dispatches == 0
    gen0 = arena.gen
    assert arena.compact()
    assert gen0 in arena.retired_ids
    while not all(out.done for *_, out in subs):
        assert cluster.queue.process_one(), "harvest never fired"
    cluster.queue.drain(max_events=10_000)
    assert gen0 not in arena.retired_ids
    got = [_canon(out.value()) for *_, out in subs]
    host = [_canon(store.host_calculate_deps(t, k, b)) for t, k, b, _ in subs]
    return got, host, res


def test_compaction_between_stage_and_dispatch():
    """compact() between encode-ahead and the deferred launch: the
    plan-time pin carries the harvest across it on the device path."""
    port, host, res = _compaction_between_stage_and_dispatch(PORT)
    ref, _, _ = _compaction_between_stage_and_dispatch(JAX)
    assert port == ref == host
    assert sum(len(d) for d in port) > 0
    assert res.stale_harvests >= 1 and res.host_fallbacks == 0


def _overflow_bump(P):
    rng = np.random.default_rng(17)
    _, node, (store,) = _node(P)
    res = _resolver(P, num_buckets=128, initial_cap=1024)
    store.deps_resolver = res
    hot = 7
    for _ in range(300):
        ts = node.unique_now()
        tid = P.TxnId.create(ts.epoch, ts.hlc, ts.node, P.TxnKind.WRITE,
                             P.Domain.KEY)
        ks = {hot} | {int(k) for k in rng.integers(0, 1 << 16, 2)}
        store.register(tid, P.Keys(sorted(ks)), P.CfkStatus.WITNESSED, ts)
    pol = res._outcap(res._arenas[id(store)], "key")
    pol.observe(8, 8)       # a quiet dispatch: the estimate pins 256
    far = _far(P, node)
    owned = store.owned(P.Keys([hot]))
    out = []
    for _ in range(2):
        tid = node.next_txn_id(P.TxnKind.WRITE, P.Domain.KEY)
        out.append((_canon(res.resolve_one(store, tid, owned, far)),
                    _canon(store.host_calculate_deps(tid, owned, far))))
    return out, res, pol


def test_finalize_overflow_bumps_tier_and_falls_back_exactly():
    port, res, pol = _overflow_bump(PORT)
    ref, _, _ = _overflow_bump(JAX)
    assert [p[0] for p in port] == [r[0] for r in ref]
    assert all(dev == host for dev, host in port)
    assert len(port[0][0][0][1]) >= 300     # more deps than the 256 rung
    assert res.finalize_fallbacks == 1 and res.legacy_decodes == 1
    assert res.finalized_decodes == 1       # the second call, bumped
    assert pol.current >= 2048 and res.outcap_tier_switches >= 1
    assert res.host_fallbacks == 0


def test_range_subject_resolves_on_device_like_host_scan():
    """A range registration lands in the store's interval arena and a range
    subject resolves on the device path exactly like the host scan --
    nothing raises NotImplementedError any more."""
    P = PORT
    _, node, (store,) = _node(P)
    res = _resolver(P)
    store.deps_resolver = res
    ts = node.unique_now()
    tid = P.TxnId.create(ts.epoch, ts.hlc, ts.node, P.TxnKind.WRITE,
                         P.Domain.RANGE)
    rngs = importlib.import_module("accord_tpu_torch.primitives.keyspace")
    store.register(tid, rngs.Ranges([rngs.Range(0, 10)]),
                   P.CfkStatus.WITNESSED, ts)
    assert res._arenas[id(store)].ranges.rows_of[tid]
    subj = node.next_txn_id(P.TxnKind.WRITE, P.Domain.RANGE)
    owned = store.owned(rngs.Ranges([rngs.Range(5, 20)]))
    far = _far(P, node)
    got = res.resolve_one(store, subj, owned, far)
    assert got == store.host_calculate_deps(subj, owned, far)
    assert tid in got.range_deps.all_txn_ids()
    assert res.range_subject_device_decodes == 1
    assert res.host_fallbacks == res.range_fallbacks == 0


def test_inline_max_conflict_answers_and_batched_declines():
    """Batched mode declines the device max-conflict, exactly like the
    reference; inline mode (no batch window) answers it through the
    max_conflict kernel's plain version here, without raising."""
    P = PORT
    _, node, (store,) = _node(P)
    res = _resolver(P)
    store.deps_resolver = res
    tids = _register_keys(P, store, node, [[1, 2], [2, 3]])
    tid = node.next_txn_id(P.TxnKind.WRITE, P.Domain.KEY)
    store.batch_window_ms = 2.0
    assert res.max_conflict(store, tid, P.Keys([2])) == (False, None)
    store.batch_window_ms = None
    handled, ts = res.max_conflict(store, tid, P.Keys([2]))
    assert handled and ts.hlc == max(t.hlc for t in tids)
    assert res.max_conflict(store, tid, P.Keys([50])) == (True, None)


def test_warmup_runs_every_kernel_at_small_tiers():
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.ops.resolver import warmup
    tk.reset_launches()
    warmup(num_buckets=64, cap=64, batch_tiers=(8,), scatter_tiers=(8,),
           nnz_tiers=(32,), scatter_nnz_tiers=(64,), store_tiers=(1, 2),
           out_tiers=(256,), kid_cap=32, device="cpu")
    assert all(v == 0 for v in tk.LAUNCHES.values())   # CPU: plain only


def _two_calls_in_flight_with_poll(P):
    """Two dispatches in flight with the readiness poll armed, then a
    compaction: both harvests translate their retired rows."""
    rng = np.random.default_rng(21)
    cluster, node, (store,) = _node(P)
    res = _resolver(P, num_buckets=128, initial_cap=128)
    store.deps_resolver = res
    store.batch_window_ms = 0.5
    node.device_latency_ms = 50.0
    node.device_poll_ms = 1.0
    chaff_keys = [sorted(set(rng.integers(100, 140, 2).tolist()))
                  for _ in range(50)]
    chaff = _preaccept_population(P, store, node, chaff_keys)
    live_keys = [sorted(set(rng.integers(0, 12, 2).tolist()))
                 for _ in range(40)]
    live = _preaccept_population(P, store, node, live_keys)
    arena = res._arenas[id(store)]
    for t, ks in zip(chaff, chaff_keys):
        res.on_prune(store, t, ks)

    def enqueue(idxs):
        out = []
        for i in idxs:
            keys = P.Keys(live_keys[i])
            before = store.command(live[i]).execute_at
            out.append((live[i], keys, before,
                        res.enqueue_deps(store, live[i], keys, before)))
        return out

    subs = enqueue(range(20, 26))
    while res.dispatches < 1:
        assert cluster.queue.process_one()
    subs += enqueue(range(30, 36))
    while res.dispatches < 2:
        assert cluster.queue.process_one()
    assert len(res._inflight[id(node)]) == 2 and id(node) in res._polling
    assert arena.compact()
    while not all(out.done for *_, out in subs):
        assert cluster.queue.process_one()
    cluster.queue.drain(max_events=10_000)
    got = [_canon(out.value()) for *_, out in subs]
    host = [_canon(store.host_calculate_deps(t, k, b)) for t, k, b, _ in subs]
    return got, host, res


def test_two_calls_in_flight_poll_and_compaction():
    port, host, res = _two_calls_in_flight_with_poll(PORT)
    ref, _, _ = _two_calls_in_flight_with_poll(JAX)
    assert port == ref == host
    assert sum(len(d) for d in port) > 0
    assert res.stale_harvests == 2 and res.host_fallbacks == 0
    assert res.polls_armed >= 1 and res.prefetched >= 1
