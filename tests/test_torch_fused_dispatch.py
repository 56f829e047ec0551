"""Field-granular upload accounting and the plane flushes, port vs JAX.

The port of `tests/test_fused_dispatch.py:263` (a status bump ships only
the exec-ts lane, an invalidation only the valid lane, and the bytes stay
below the full-row baseline), run on both packages from one seed with the
port's resolver on the CPU: `upload_bytes`, `upload_bytes_by_field` and
`upload_bytes_full_equiv` must be equal after every step. Then the exec
plane's and the cmd plane's flushes (ops/deltas.flush_lanes, one K4
launch a flush and chunk on the card): after a burn with both planes, each
plane's device lanes and upload counters equal the JAX planes'; and
flush_lanes leaves the lanes and the accounting flush_lane leaves.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from accord_tpu.sim import burn as jax_burn
from accord_tpu.sim.cluster import ClusterConfig as JaxConfig
from accord_tpu_torch.ops import carry
from accord_tpu_torch.ops import kernels as tk
from accord_tpu_torch.ops.deltas import flush_lane, flush_lanes
from accord_tpu_torch.sim import burn as port_burn
from accord_tpu_torch.sim.cluster import ClusterConfig as PortConfig
from tests.test_torch_resolver import JAX, PORT, _far, _node, _resolver


def _register_writes(P, store, node, key_lists):
    tids = []
    for ks in key_lists:
        ts = node.unique_now()
        tid = P.TxnId.create(ts.epoch, ts.hlc, ts.node, P.TxnKind.WRITE,
                             P.Domain.KEY)
        store.register(tid, P.Keys(ks), P.CfkStatus.WITNESSED, ts)
        tids.append(tid)
    return tids


def _counters(res):
    return (res.upload_bytes, dict(res.upload_bytes_by_field),
            res.upload_bytes_full_equiv)


def _upload_accounting(P):
    rng = np.random.default_rng(13)
    _, node, (store,) = _node(P)
    res = _resolver(P, num_buckets=128, initial_cap=128)
    store.deps_resolver = res
    key_lists = [sorted({int(k) for k in rng.integers(0, 64, 3)})
                 for _ in range(30)]
    tids = _register_writes(P, store, node, key_lists)

    def probe():
        tid = node.next_txn_id(P.TxnKind.WRITE, P.Domain.KEY)
        keys = P.Keys(key_lists[int(rng.integers(0, len(key_lists)))])
        far = _far(P, node)
        dev = res.resolve_one(store, tid, keys, far)
        assert dev == store.host_calculate_deps(tid, keys, far)

    steps = []
    probe()                                   # initial full upload
    steps.append(_counters(res))
    for tid, ks in list(zip(tids, key_lists))[:10]:      # exec-ts lane
        store.register(tid, P.Keys(ks), P.CfkStatus.COMMITTED,
                       node.unique_now())
    for tid, ks in list(zip(tids, key_lists))[10:13]:    # valid lane
        store.register(tid, P.Keys(ks), P.CfkStatus.INVALIDATED,
                       node.unique_now())
    probe()                                   # granular delta upload
    steps.append(_counters(res))
    return steps


def test_field_granular_upload_accounting_matches_jax():
    ref = _upload_accounting(JAX)
    got = _upload_accounting(PORT)
    assert got == ref
    (ub0, by0, eq0), (ub1, by1, eq1) = got
    assert by0["full"] > 0 and ub0 == eq0     # full uploads ARE the baseline
    assert by1["full"] == by0["full"], "bump re-uploaded full rows"
    assert by1["ts"] > by0["ts"] and by1["valid"] > by0["valid"]
    assert 0 < ub1 - ub0 < eq1 - eq0
    assert ub1 < eq1


def _burn_clusters(monkeypatch, seed, ops):
    """One burn with exec and cmd planes on each package; the clusters."""
    clusters = {}
    for name, mod, cfg in (
            ("jax", jax_burn, JaxConfig(exec_plane=True, cmd_plane=True)),
            ("port", port_burn, PortConfig(exec_plane=True, cmd_plane=True,
                                           exec_device="cpu",
                                           cmd_device="cpu"))):
        orig = mod.Cluster

        def capture(*a, _orig=orig, _name=name, **kw):
            clusters[_name] = c = _orig(*a, **kw)
            return c
        monkeypatch.setattr(mod, "Cluster", capture)
        rep = mod.run_burn(seed, ops=ops, collect_log=True, config=cfg)
        clusters[name + "_log"] = rep.log
    assert clusters["jax_log"] == clusters["port_log"]
    return clusters["jax"], clusters["port"]


def _stores(cluster):
    for nid in sorted(cluster.nodes):
        yield from cluster.nodes[nid].command_stores.stores


@pytest.mark.parametrize("seed", (5, 12))
def test_plane_flushes_match_jax(monkeypatch, seed):
    """After a burn, each exec plane's and cmd plane's dirty rows flushed
    (flush_lanes): the device lanes and the upload counters equal the JAX
    planes' (the reference's bool adjacency packed as the port keeps it)."""
    jc, pc = _burn_clusters(monkeypatch, seed, 40)
    flushed = 0
    for js, ps in zip(_stores(jc), _stores(pc)):
        jx, px = js.exec_plane, ps.exec_plane
        flushed += bool(px._dirty_ts or px._dirty_flags)
        jl, pl = jx._sync_device(), px._sync_device()
        assert torch.equal(carry.packed_adjacency(np.asarray(jl[0])), pl[0])
        for a, b in zip(jl[1:], pl[1:]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert (px.upload_bytes, px.upload_bytes_by_field,
                px.upload_bytes_full_equiv) == (
            jx.upload_bytes, jx.upload_bytes_by_field,
            jx.upload_bytes_full_equiv)
        jm, pm = js.cmd_plane, ps.cmd_plane
        flushed += any(bool(r) for r in pm._dirty.values())
        jm._flush()
        pm._flush()
        assert sorted(jm._device) == sorted(pm._device)
        for k in jm._device:
            np.testing.assert_array_equal(np.asarray(jm._device[k]),
                                          pm._device[k].numpy())
        assert pm.upload_bytes == jm.upload_bytes
    assert flushed > 0, "no plane had dirty rows to flush"


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_flush_lanes_equals_flush_lane(seed):
    """flush_lanes over eight lanes (chunks of 8 and 64, 70 rows in two
    chunks, an empty lane, bool and [cap, 3] lanes) leaves what flush_lane
    lane by lane leaves, with the same accounting calls in the same
    order."""
    rng = np.random.default_rng(seed)
    host = [rng.integers(-9, 9, 200).astype(np.int32),
            rng.integers(-9, 9, (200, 3)).astype(np.int32),
            rng.random(200) < 0.5,
            rng.integers(-9, 9, (40, 3)).astype(np.int32),
            rng.random(40) < 0.5] + [
            rng.integers(-9, 9, 100).astype(np.int32) for _ in range(3)]
    rows = [sorted(rng.choice(len(h), n, replace=False).tolist())
            for h, n in zip(host, (70, 3, 0, 40, 9, 64, 65, 1))]
    logs = ([], [])
    lanes = [torch.from_numpy(h.copy()) for h in host]
    launches = dict(tk.LAUNCHES)
    one = [flush_lane(lane, r, h, lambda nb, m: logs[0].append((nb, m)))
           for lane, r, h in zip(lanes, rows, host)]
    many = flush_lanes([(lane, r, h, lambda nb, m: logs[1].append((nb, m)))
                        for lane, r, h in zip(lanes, rows, host)])
    assert tk.LAUNCHES == launches, "a CPU flush launched a CUDA kernel"
    assert logs[0] == logs[1] and logs[0]
    for a, b in zip(one, many):
        assert torch.equal(a, b)
