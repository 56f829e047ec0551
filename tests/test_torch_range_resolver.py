"""The port's range-domain resolver (on the CPU, its kernels' plain
versions) against the JAX BatchDepsResolver and the host scans.

The single-device scenarios of the JAX package's range tests, each written
once and run on both packages from one seed: a randomized mix of key and
range subjects against key and range conflict state (rows wider than the
retired MAXK=16 scatter, a grown interval arena), truncation and prune of
range txns, the interval arena compacting while calls are in flight, the
covered-bucket contraction, and the inline max-conflict query. Answers are
compared as canonical tuples (the packages' Deps classes are distinct
types); the port must match its own host scan and never leave the device
path (host_fallbacks == range_fallbacks == 0).
"""
from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_resolver import JAX, PORT, _node, _resolver

DOMAIN = 1 << 16


def _ranges(P) -> SimpleNamespace:
    ks = importlib.import_module(f"{P.root}.primitives.keyspace")
    return SimpleNamespace(Range=ks.Range, Ranges=ks.Ranges)


def _canon(deps):
    """Deps -> (key deps, range deps) as ints, range reprs and id strings."""
    keys = tuple((int(k), tuple(str(t) for t in ids))
                 for k, ids in deps.key_deps.items())
    rngs = tuple((repr(r), tuple(str(t) for t in ids))
                 for r, ids in deps.range_deps.items())
    return keys, rngs


def _register_mixed(P, store, node, rng, n_key=60, n_range=40):
    """Key txns (some wider than the old MAXK=16) + range txns of 1-2
    pieces, registered through the store funnel so the attached resolver
    mirrors them."""
    R = _ranges(P)
    tss, rids = [], []
    for i in range(n_key):
        ts = node.unique_now()
        kind = P.TxnKind.WRITE if i % 3 else P.TxnKind.READ
        tid = P.TxnId.create(ts.epoch, ts.hlc, ts.node, kind, P.Domain.KEY)
        width = 40 if i % 11 == 0 else 1 + int(rng.integers(0, 4))
        keys = P.Keys(sorted({int(k) for k in rng.integers(0, DOMAIN, width)}))
        store.register(tid, keys, P.CfkStatus.WITNESSED, ts)
        tss.append(ts)
    for i in range(n_range):
        ts = node.unique_now()
        kind = P.TxnKind.WRITE if i % 2 else P.TxnKind.READ
        tid = P.TxnId.create(ts.epoch, ts.hlc, ts.node, kind, P.Domain.RANGE)
        pieces = []
        for _ in range(1 + int(rng.integers(0, 2))):
            s = int(rng.integers(0, DOMAIN - 64))
            pieces.append(R.Range(s, s + 1 + int(rng.integers(0, 2048))))
        store.register(tid, R.Ranges(pieces), P.CfkStatus.WITNESSED, ts)
        rids.append(tid)
        tss.append(ts)
    return rids, tss


def _subjects(P, store, node, rng, tss, n=40):
    R = _ranges(P)
    far = P.Timestamp(node.epoch, node.time_service.now_micros() + 50_000,
                      0, node.id)
    subs = []
    for i in range(n):
        kind = P.TxnKind.WRITE if i % 2 else P.TxnKind.READ
        if i % 3 == 0:
            pieces = [R.Range(s, s + 1 + int(rng.integers(0, 4096)))
                      for s in (int(rng.integers(0, DOMAIN - 64)),)]
            if i % 6 == 0:
                s2 = int(rng.integers(0, DOMAIN - 64))
                pieces.append(R.Range(s2, s2 + 1 + int(rng.integers(0, 512))))
            owned = store.owned(R.Ranges(pieces))
            tid = node.next_txn_id(kind, P.Domain.RANGE)
        else:
            width = 24 if i % 9 == 0 else 1 + int(rng.integers(0, 4))
            owned = store.owned(P.Keys(sorted(
                {int(k) for k in rng.integers(0, DOMAIN, width)})))
            tid = node.next_txn_id(kind, P.Domain.KEY)
        # mixed bounds: mostly future (sees everything), sometimes a
        # registered txn's timestamp (exercises the lex-before mask)
        before = far if i % 4 else tss[int(rng.integers(0, len(tss)))]
        subs.append((tid, owned, before))
    return subs


def _store(P, num_buckets=128, initial_cap=128, **kw):
    cluster, node, (store,) = _node(P)
    res = _resolver(P, num_buckets=num_buckets, initial_cap=initial_cap,
                    **kw)
    store.deps_resolver = res
    return cluster, node, store, res


def _zero(res):
    assert res.host_fallbacks == 0
    assert res.range_fallbacks == 0
    assert res.finalize_fallbacks == 0


# -- scenarios ---------------------------------------------------------------
def _mixed(P, **kw):
    rng = np.random.default_rng(42)
    _, node, store, res = _store(P, **kw)
    _, tss = _register_mixed(P, store, node, rng)
    arena = res._arenas[id(store)]
    assert max(len(m) for m in arena.row_mods if m is not None) > 16
    assert arena.ranges.count > 64 and arena.ranges.cap > 64   # it grew
    got, host = [], []
    for tid, owned, before in _subjects(P, store, node, rng, tss):
        host.append(_canon(store.host_calculate_deps(tid, owned, before)))
        got.append(_canon(res.resolve_one(store, tid, owned, before)))
    return got, host, res


def _truncate_and_prune(P):
    """Mirror store._deregister for half the range txns (range_txns and
    range_index popped, then the resolver's on_truncate hook): the arena
    drops their rows, and no answer names a truncated txn."""
    rng = np.random.default_rng(7)
    _, node, store, res = _store(P)
    rids, tss = _register_mixed(P, store, node, rng, n_key=30, n_range=30)
    arena = res._arenas[id(store)]
    for tid in rids[::2]:
        store.range_txns.pop(tid, None)
        store.range_index.remove(tid)
        res.on_truncate(store, tid)
        assert tid not in arena.ranges.rows_of
    for tid in rids[1::2]:
        assert tid in arena.ranges.rows_of
    got, host = [], []
    for tid, owned, before in _subjects(P, store, node, rng, tss, n=24):
        host.append(_canon(store.host_calculate_deps(tid, owned, before)))
        got.append(_canon(res.resolve_one(store, tid, owned, before)))
    truncated = {str(t) for t in rids[::2]}
    for keys, rngs in got:
        for _, ids in keys + rngs:
            assert not (set(ids) & truncated)
    return got, host, res


def _compaction_in_flight(P):
    """Truncate + compact the INTERVAL arena while mixed-domain calls are in
    flight: the pinned id snapshot must translate the stale candidates (no
    host fallback) and every answer must equal the post-truncation host
    scan."""
    R = _ranges(P)
    rng = np.random.default_rng(11)
    cluster, node, store, res = _store(P)
    store.batch_window_ms = 0.5
    node.device_latency_ms = 50.0
    node.device_poll_ms = 1.0
    rids, _ = _register_mixed(P, store, node, rng, n_key=30, n_range=40)
    arena = res._arenas[id(store)]
    far = P.Timestamp(node.epoch, node.time_service.now_micros() + 50_000,
                      0, node.id)
    subs = []
    for i in range(6):
        if i % 2 == 0:
            s = int(rng.integers(0, DOMAIN - 4096))
            owned = store.owned(R.Ranges([R.Range(s, s + 4096)]))
            tid = node.next_txn_id(P.TxnKind.WRITE, P.Domain.RANGE)
        else:
            owned = store.owned(P.Keys(sorted(
                {int(k) for k in rng.integers(0, DOMAIN, 3)})))
            tid = node.next_txn_id(P.TxnKind.WRITE, P.Domain.KEY)
        subs.append((tid, owned, far, res.enqueue_deps(store, tid, owned,
                                                       far)))
    while res.dispatches < 1:
        assert cluster.queue.process_one(), "tick never fired"
    assert all(not out.done for *_, out in subs)
    for tid in rids[:30]:
        store.range_txns.pop(tid, None)
        store.range_index.remove(tid)
        res.on_truncate(store, tid)
    rgen0 = arena.ranges.gen
    assert arena.ranges.compact(), "compaction should reclaim truncated rows"
    assert arena.ranges.gen == rgen0 + 1
    assert rgen0 in arena.ranges.retired_ids
    while not all(out.done for *_, out in subs):
        assert cluster.queue.process_one(), "harvest never fired"
    assert res.stale_harvests >= 1
    cluster.queue.drain(max_events=10_000)
    assert rgen0 not in arena.ranges.retired_ids  # pin released on harvest
    got = [_canon(out.value()) for *_, out in subs]
    host = [_canon(store.host_calculate_deps(t, o, b)) for t, o, b, _ in subs]
    return got, host, res


def _mixed_candidate_decode(P):
    """The mixed differential with finalize_on_device=False: range subjects
    and key subjects' range deps decode from the raw candidate buffers
    (re-filtered against the store's maps), not the finalized lanes."""
    return _mixed(P, finalize_on_device=False)


_SCENARIOS = {"mixed_differential": _mixed,
              "mixed_candidate_decode": _mixed_candidate_decode,
              "truncation_and_prune": _truncate_and_prune,
              "compaction_with_calls_in_flight": _compaction_in_flight}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_range_scenario_vs_jax_and_host(name):
    port, port_host, res = _SCENARIOS[name](PORT)
    ref, ref_host, jres = _SCENARIOS[name](JAX)
    assert port == port_host, "port != its host scan"
    assert port == ref, "port != JAX resolver"
    assert ref_host == port_host
    assert any(k for k, _ in port) and any(r for _, r in port), "vacuous"
    _zero(res)
    assert res.range_subject_device_decodes \
        == jres.range_subject_device_decodes
    assert res.finalized_decodes == jres.finalized_decodes
    assert res.legacy_decodes == jres.legacy_decodes
    assert (res.finalized_decodes > 0) == res.finalize_on_device


def test_covered_bucket_contraction():
    """covered_buckets marks EXACTLY the buckets some interval key hashes
    into -- randomized CSR lists with padding rows and >= K-wide intervals
    -- as the JAX kernel does; two narrow intervals far apart mark four
    buckets, not the hull between them; a straddle of a multiple of K
    wraps around the ring."""
    import jax.numpy as jnp
    from accord_tpu.ops.kernels import covered_buckets as jax_cov
    from accord_tpu_torch.ops.kernels import _unpack_bits, covered_buckets

    def port_cov(iv_of, iv_s, iv_e, b):
        words = covered_buckets(*(torch.tensor(a, dtype=torch.int32)
                                  for a in (iv_of, iv_s, iv_e)), b, K)
        return _unpack_bits(words).numpy()

    K = 128
    rng = np.random.default_rng(97)
    partial_rows = 0
    for _ in range(10):
        b = 1 + int(rng.integers(0, 5))
        iv_of, iv_s, iv_e = [], [], []
        for subj in range(b):
            for _ in range(1 + int(rng.integers(0, 3))):
                s = int(rng.integers(0, 1 << 16))
                w = int(rng.integers(1, 2 * K + 8)) if rng.integers(0, 2) \
                    else int(rng.integers(1, 8))
                iv_of.append(subj)
                iv_s.append(s)
                iv_e.append(s + w)
        iv_of += [b, b]                          # padding rows: dropped
        iv_s += [0, 0]
        iv_e += [0, 5]
        got = port_cov(iv_of, iv_s, iv_e, b)
        truth = np.zeros((b, K), bool)
        for o, s, e in zip(iv_of, iv_s, iv_e):
            if o >= b:
                continue
            if e - s >= K:
                truth[o, :] = True
            else:
                truth[o, np.arange(s, e) % K] = True
        assert (got == truth).all(), "contraction != hashed-bucket truth"
        ref = np.asarray(jax_cov(*(jnp.asarray(a, jnp.int32)
                                   for a in (iv_of, iv_s, iv_e)), b, K, 0, K)
                         .astype(jnp.float32)) > 0.5
        assert (got == ref).all(), "port != JAX covered_buckets"
        partial_rows += int(((truth.sum(axis=1) > 0)
                             & (truth.sum(axis=1) < K)).sum())
    assert partial_rows > 0, "vacuous: every row was all-wide"
    got = port_cov([0, 0], [10, 2000], [12, 2002], 1)[0]
    marked = set(np.nonzero(got)[0].tolist())
    assert marked == {10, 11, 2000 % K, 2001 % K}
    assert len(marked) < max(marked) - min(marked) + 1
    got = port_cov([0], [K * 5 - 2], [K * 5 + 2], 1)[0]
    assert set(np.nonzero(got)[0].tolist()) == {K - 2, K - 1, 0, 1}


def _max_conflicts(P):
    """Inline max-conflict over registered key txns (keys 0..59 of 64
    buckets; some invalidated, which still count: MaxConflicts is
    monotone). Subjects: keys the arena holds (handled on the device),
    keys in the free buckets 60..63 (no conflict), and keys k + 64 that
    share a bucket with a registered key but no key (a bucket collision:
    the host decides)."""
    rng = np.random.default_rng(5)
    _, node, store, res = _store(P, num_buckets=64, initial_cap=64)
    store.batch_window_ms = None
    regs = []
    for i in range(90):
        ts = node.unique_now()
        tid = P.TxnId.create(ts.epoch, ts.hlc, ts.node, P.TxnKind.WRITE,
                             P.Domain.KEY)
        keys = P.Keys(sorted({int(k) for k in rng.integers(0, 60, 2)}))
        status = P.CfkStatus.INVALIDATED if i % 13 == 5 \
            else P.CfkStatus.WITNESSED
        store.register(tid, keys, status, ts)
        regs.append((set(keys), ts))
    subjects = []
    for i in range(40):
        if i % 10 == 0:
            keys = P.Keys([60 + i // 10])        # a free bucket
        elif i % 10 == 1:
            keys = P.Keys([64 + int(rng.integers(0, 60))])   # collision
        else:
            keys = P.Keys(sorted({int(k) for k in rng.integers(0, 60, 2)}))
        subjects.append((node.next_txn_id(P.TxnKind.WRITE, P.Domain.KEY),
                         keys))
    batch = res.max_conflict_batch(store, subjects)
    one = [res.max_conflict(store, t, k) for t, k in subjects[:5]]
    canon = [(ok, str(ts)) for ok, ts in batch + one]
    return canon, batch, regs, subjects, res


def test_max_conflict_batch_vs_jax():
    port, batch, regs, subjects, res = _max_conflicts(PORT)
    ref, *_ = _max_conflicts(JAX)
    assert port == ref
    handled = [(ok, ts) for ok, ts in batch if ok and ts is not None]
    assert len(handled) >= 30, "vacuous"
    assert all(batch[i] == (True, None) for i in range(0, 40, 10))  # free
    assert sum(not batch[i][0] for i in range(1, 40, 10)) >= 2  # collisions
    # a handled answer is the max registered timestamp on the subject's
    # keys (invalidated registrations included)
    for (tid, keys), (ok, ts) in zip(subjects, batch):
        if ok:
            hits = [t for ks, t in regs if ks & set(keys)]
            assert ts == (max(hits) if hits else None), (tid, keys)
    assert res.dispatches == 0                   # no deps dispatch needed
