"""The port's device command plane (accord_tpu_torch/ops/cmd_plane.py) on
the CPU, against the port's own host handlers and the JAX package's plane.

The port's counterparts of tests/test_cmd_plane.py: with and without the
plane the engine produces BIT-identical outcomes, status histories,
executeAt choices, ballots and HLC clocks, and the JAX package's plane
produces the same on the same script or seed, with equal cmd_plane_*
counters (timers left out). Plus the exec-frontier units of the recovery
scan, the defer_batch twin of tests/test_megakernel.py, the repair round
trip (collect_repair -> kernels.cmd_repair -> adopt_repair equals a plain
flush), the chain-based shadow sync (equal to the device columns after
every dispatch), and the plane's default device. Every plane here runs
with `device="cpu"` / `ClusterConfig(cmd_device="cpu")`: the kernels'
plain versions. There is no counterpart of test_warmup_zero_recompiles:
the port has no jit cache, nothing to compile beyond nvcc at first use.
"""
from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

PORT, REF = "accord_tpu_torch", "accord_tpu"


def _pkg(name: str) -> SimpleNamespace:
    m = lambda mod: importlib.import_module(f"{name}.{mod}")  # noqa: E731
    ts = m("primitives.timestamp")
    deps = m("primitives.deps")
    ls = m("sim.list_store")
    cl = m("sim.cluster")
    return SimpleNamespace(
        name=name, commands=m("local.commands"), Deps=deps.Deps,
        KeyDeps=deps.KeyDeps, Keys=m("primitives.keyspace").Keys,
        Ballot=ts.Ballot, Timestamp=ts.Timestamp, TxnKind=ts.TxnKind,
        Txn=m("primitives.txn").Txn, Cluster=cl.Cluster,
        ClusterConfig=cl.ClusterConfig, ListQuery=ls.ListQuery,
        ListRead=ls.ListRead, ListUpdate=ls.ListUpdate,
        burn=m("sim.burn").run_burn, cmd=m("ops.cmd_plane"))


def _cfg(P, **kw):
    if P.name == PORT and kw.get("cmd_plane"):
        kw.setdefault("cmd_device", "cpu")
    return P.ClusterConfig(**kw)


def _env(P, cmd_plane: bool):
    cluster = P.Cluster(1, _cfg(P, num_nodes=1, rf=1, num_shards=1,
                                stores_per_node=1, progress=False,
                                cmd_plane=cmd_plane))
    node = cluster.nodes[1]
    return cluster, node, node.command_stores.stores[0]


def _mk_txn(P, keys, value):
    k = P.Keys(sorted(keys))
    return P.Txn(P.TxnKind.WRITE, k, read=P.ListRead(k),
                 update=P.ListUpdate(k, value), query=P.ListQuery())


def _snap(store, node, tid):
    cmd = store.command_if_present(tid)
    if cmd is None:
        return ("absent", node._last_hlc)
    return (int(cmd.status), cmd.execute_at, cmd.promised,
            cmd.accepted_ballot, cmd.txn is not None, int(cmd.durability),
            node._last_hlc)


def _script(rng: random.Random, n_ops: int):
    """tests/test_cmd_plane.py's abstract op script over txn refs."""
    ops = []
    n_txns = 0
    live = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.35 or not live:
            ref = n_txns
            n_txns += 1
            live.append(ref)
            keys = rng.sample(range(1, 9), rng.randint(1, 3))
            ops.append(("new", ref, tuple(keys), ref + 1))
        else:
            ref = rng.choice(live)
            r2 = rng.random()
            if r2 < 0.2:
                ops.append(("re_pa", ref, rng.choice((0, 1, 2, 5))))
            elif r2 < 0.45:
                ops.append(("accept", ref, rng.choice((1, 2, 5)),
                            rng.randint(0, 50), rng.random() < 0.5))
            elif r2 < 0.75:
                ops.append(("commit", ref, rng.random() < 0.2))
            else:
                ops.append(("apply", ref))
        if rng.random() < 0.06:
            ops.append(("compact",))
    return ops


def _realize(P, env, script):
    """tests/test_cmd_plane.py's _realize (batch_plane, compact_live)."""
    cluster, node, store = env
    hist = []
    tids, txns, routes = {}, {}, {}
    part = lambda t: t.slice(store.ranges, include_query=False)  # noqa: E731

    def run_one(op):
        kind = op[0]
        if kind == "compact":
            if store.cmd_plane is not None:
                store.cmd_plane.compact()
            hist.append(("compacted",))
            return
        ref = op[1]
        if kind == "new":
            txn = _mk_txn(P, op[2], op[3])
            tid = node.next_txn_id(txn.kind, txn.domain)
            tids[ref], txns[ref] = tid, txn
            routes[ref] = node.compute_route(txn)
            out = store.submit_preaccept(tid, part(txn), routes[ref])
            got = {}
            out.on_success(lambda v: got.update(v=v))
            outcome = got["v"][0]
        else:
            tid, txn, route = tids[ref], txns[ref], routes[ref]
            cmd = store.command_if_present(tid)
            if kind == "re_pa":
                ballot = P.Ballot.ZERO if op[2] == 0 \
                    else P.Ballot(1, op[2], 0, 1)
                if store.cmd_plane is not None:
                    outcome = store.cmd_plane.eval_batch([
                        P.cmd.CmdOp.preaccept(tid, part(txn), route,
                                              ballot)])[0].outcome
                else:
                    outcome = P.commands.preaccept(store, tid, part(txn),
                                                   route, ballot)
            elif kind == "accept":
                base = cmd.execute_at if cmd is not None \
                    and cmd.execute_at is not None else tid
                proposal = P.Timestamp(base.epoch, base.hlc + op[3], 0, 1)
                deps = P.Deps(P.KeyDeps.of(
                    {sorted(txn.keys)[0]: [tid]})) if op[4] else None
                outcome = store.accept_op(tid, P.Ballot(1, op[2], 0, 1),
                                          route, store.owned(txn.keys),
                                          proposal, deps)
            else:
                ea = cmd.execute_at if cmd is not None \
                    and cmd.execute_at is not None else tid.as_timestamp()
                if kind == "commit":
                    if op[2]:
                        ea = P.Timestamp(ea.epoch, ea.hlc + 1, ea.flags,
                                         ea.node)
                    outcome = store.commit_op(tid, route, part(txn), ea,
                                              P.Deps.NONE)
                else:
                    outcome = store.apply_op(tid, route, part(txn), ea,
                                             P.Deps.NONE, None, None)
        hist.append((kind, ref, outcome, _snap(store, node, tids[ref])))
        cluster.drain()

    for op in script:
        run_one(op)
    return hist


def _plane_counters(counters: dict) -> dict:
    return {k: v for k, v in counters.items()
            if k.startswith(("cmd_", "recovery_scan_"))
            and not k.endswith("_s")}


@pytest.fixture(scope="module")
def port():
    return _pkg(PORT)


@pytest.fixture(scope="module")
def ref():
    return _pkg(REF)


@pytest.mark.parametrize("seed", [3, 17, 40, 71])
def test_randomized_differential(port, ref, seed):
    """Ballot contention + redundant deliveries + compaction in flight:
    identical histories host vs plane, and the port's plane equal to the
    JAX package's, with equal counters."""
    script = _script(random.Random(seed), 60)
    host = _realize(port, _env(port, False), script)
    penv = _env(port, True)
    dev = _realize(port, penv, script)
    renv = _env(ref, True)
    jdev = _realize(ref, renv, script)
    assert host == dev, f"seed {seed}: the port's plane diverged from host"
    assert repr(dev) == repr(jdev), f"seed {seed}: port != JAX package"
    assert _plane_counters(penv[2].cmd_plane.snapshot()) == \
        _plane_counters(renv[2].cmd_plane.snapshot())
    assert penv[2].cmd_plane.dispatches > 0


def test_differential_under_truncation(port):
    """With a truncation floor active the plane admits nothing; the host
    fallback keeps the histories identical."""
    script = _script(random.Random(9), 60)
    hists = []
    for flag in (False, True):
        env = _env(port, flag)
        store = env[2]
        floor = port.Timestamp(1, 10, 0, 1)
        store.truncated_before = store.truncated_before.with_range(
            1, 5, floor, port.Timestamp.merge_max)
        hists.append(_realize(port, env, script))
        if flag:
            assert store.cmd_plane.fallbacks > 0
    assert hists[0] == hists[1]


def test_compaction_in_flight(port):
    """Ops hold TxnIds, not rows: compacting between op construction and
    eval_batch re-resolves rows at dispatch; applied txns re-seed."""
    from accord_tpu_torch.local.commands import AcceptOutcome, CommitOutcome
    from accord_tpu_torch.local.status import Status
    CmdOp = port.cmd.CmdOp
    cluster, node, store = _env(port, True)
    plane = store.cmd_plane
    txn = _mk_txn(port, [3], 1)
    tid = node.next_txn_id(txn.kind, txn.domain)
    route = node.compute_route(txn)
    part = txn.slice(store.ranges, include_query=False)
    assert plane.eval_batch([CmdOp.preaccept(tid, part, route)])[0] \
        .outcome == AcceptOutcome.SUCCESS
    ea = store.command(tid).execute_at
    ops = [CmdOp.commit(tid, route, part, ea, port.Deps.NONE),
           CmdOp.apply(tid, route, part, ea, port.Deps.NONE)]
    plane.compact()
    before = plane.compactions
    res = plane.eval_batch(ops)
    assert [r.outcome for r in res] == [CommitOutcome.SUCCESS,
                                       CommitOutcome.SUCCESS]
    cluster.drain()
    assert store.command(tid).status == Status.APPLIED
    plane.compact()
    assert plane.compactions == before + 1
    assert tid not in plane.row_of
    res = plane.eval_batch([CmdOp.commit(tid, route, part, ea,
                                         port.Deps.NONE)])
    assert res[0].outcome == CommitOutcome.REDUNDANT
    assert tid in plane.row_of


def _burn_trio(port, ref, seed, kw, **cfg):
    host = port.burn(seed, config=_cfg(port, **cfg), **kw)
    dev = port.burn(seed, config=_cfg(port, cmd_plane=True, **cfg), **kw)
    jdev = ref.burn(seed, config=_cfg(ref, cmd_plane=True, **cfg), **kw)
    assert host.acked == dev.acked == kw["ops"]
    assert host.log == dev.log, "cmd_plane burn diverged from host burn"
    assert dev.log == jdev.log, "port's cmd_plane burn != JAX package's"
    assert _plane_counters(dev.counters) == _plane_counters(jdev.counters)
    assert dev.counters.get("cmd_plane_dispatches", 0) > 0
    assert dev.counters.get("cmd_plane_checksum_mismatches", 0) == 0
    return dev


def test_burn_differential(port, ref):
    """Full cluster: identical burn logs with the plane under every
    replica's PreAccept/Accept/Commit/Apply."""
    _burn_trio(port, ref, 7, dict(ops=60, write_ratio=0.85, key_count=6,
                                  collect_log=True))


def test_burn_differential_contended(port, ref):
    """High write ratio on few keys, durability rounds: the slow path."""
    _burn_trio(port, ref, 23, dict(ops=80, write_ratio=0.95, key_count=3,
                                   collect_log=True), durability=True)


def test_burn_differential_authoritative(port, ref):
    """cmd_plane_authoritative: device promotions decide with the store
    attached; the history stays bit-identical."""
    dev = _burn_trio(port, ref, 7, dict(ops=60, write_ratio=0.85,
                                        key_count=6, collect_log=True),
                     cmd_plane_authoritative=True)
    assert dev.counters["cmd_plane_dispatches"] > 0


def _resolver_burn(P, seed, ops):
    """A burn whose PreAccepts queue in the batch resolver, so every store's
    run drains through its plane's eval_batch."""
    res = importlib.import_module(f"{P.name}.ops.resolver")
    kw = dict(device="cpu") if P.name == PORT else {}
    cfg = _cfg(P, num_nodes=3, rf=3, cmd_plane=True, deps_batch_window_ms=2.0,
               device_latency_ms=8.0,
               deps_resolver_factory=lambda: res.BatchDepsResolver(
                   num_buckets=128, **kw))
    return P.burn(seed, ops=ops, concurrency=16, key_count=6,
                  collect_log=True, config=cfg)


def test_resolver_drain_through_plane_matches_jax(port, ref):
    """The batch resolver's PreAccept drain routes each store's run through
    the plane: the port's history and plane counters equal the JAX
    package's on the same seed."""
    dev = _resolver_burn(port, 5, 40)
    jdev = _resolver_burn(ref, 5, 40)
    assert dev.acked == 40 and dev.lost == 0
    assert dev.log == jdev.log
    assert _plane_counters(dev.counters) == _plane_counters(jdev.counters)
    assert dev.counters.get("cmd_plane_dispatches", 0) > 0


def test_drain_propagates_plane_errors(port, monkeypatch):
    """An error of eval_batch (a kernel that fails to build or launch)
    leaves the drain instead of being answered by the host handlers."""
    class PlaneFailure(Exception):
        pass

    orig = port.cmd.CmdPlane.eval_batch
    spans = []

    def failing(self, ops):
        # only the drain's PreAccept spans fail: the store's own
        # accept/commit/apply ops propagate their errors anyway
        if all(op.kind == port.cmd.CMD_OP_PREACCEPT for op in ops):
            spans.append(len(ops))
            if len(spans) > 3:
                raise PlaneFailure("cmd_tick failed")
        return orig(self, ops)

    monkeypatch.setattr(port.cmd.CmdPlane, "eval_batch", failing)
    with pytest.raises(PlaneFailure):
        _resolver_burn(port, 5, 40)
    assert len(spans) == 4


def test_recovery_burn_host_and_device_scan_match_jax(port, ref):
    """bench_recovery_storm's storm config through run_burn (no
    megakernel), authoritative, with drops and a 300 ms stall so the scan
    finds candidates: host scan == device scan == the JAX package's device
    scan, equal counters, zero fallbacks."""
    kw = dict(ops=48, key_count=24, concurrency=8, crash_restart=True,
              chaos_drop=0.05, collect_log=True)
    cfg = dict(num_nodes=4, rf=3, stores_per_node=2, cmd_plane=True,
               cmd_plane_authoritative=True, progress_stall_ms=300.0)
    h = port.burn(17, config=_cfg(port, recovery_scan="host", **cfg), **kw)
    d = port.burn(17, config=_cfg(port, recovery_scan="device", **cfg), **kw)
    j = ref.burn(17, config=_cfg(ref, recovery_scan="device", **cfg), **kw)
    assert h.log == d.log == j.log
    dc = _plane_counters(d.counters)
    assert dc == _plane_counters(j.counters)
    assert dc["recovery_scan_candidates"] > 0
    assert dc["recovery_scan_dispatches"] > 0
    assert dc.get("recovery_scan_fallbacks", 0) == 0


def test_plane_metrics_reach_node_snapshot(port):
    _cluster, node, store = _env(port, True)
    txn = _mk_txn(port, [2], 1)
    tid = node.next_txn_id(txn.kind, txn.domain)
    store.submit_preaccept(tid, txn.slice(store.ranges, include_query=False),
                           node.compute_route(txn))
    snap = node.metrics_snapshot()
    assert snap.get("cmd_plane_dispatches", 0) >= 1
    assert snap.get("cmd_plane_upload_bytes", 0) > 0
    assert snap.get("cmd_fastpath_device_evals", 0) >= 1


def _twin_script(P, defer):
    """tests/test_megakernel.py's defer_batch script: three spans (fresh
    PreAccepts; redundant re-delivery + ballot contention; a commit
    mid-batch)."""
    CmdOp = P.cmd.CmdOp
    _cluster, node, store = _env(P, True)
    plane = store.cmd_plane
    lanes = []
    sink = lambda t, s, c: lanes.append((t.copy(), s.copy(), c.copy()))  # noqa: E731
    txns = []
    for i in range(6):
        txn = _mk_txn(P, [1 + (i % 4), 5], i + 1)
        tid = node.next_txn_id(txn.kind, txn.domain)
        txns.append((tid, txn, node.compute_route(txn)))
    part = lambda t: t.slice(store.ranges, include_query=False)  # noqa: E731
    ev = (lambda b: plane.defer_batch(b, sink=sink)) if defer \
        else plane.eval_batch
    out = []

    def run(batch):
        out.append([(r.outcome, int(r.status) if r.status is not None
                     else None, r.execute_at) for r in ev(batch)])

    run([CmdOp.preaccept(t, part(x), r) for t, x, r in txns[:4]])
    run([CmdOp.preaccept(txns[0][0], part(txns[0][1]), txns[0][2]),
         CmdOp.preaccept(txns[1][0], part(txns[1][1]), txns[1][2],
                         P.Ballot(1, 5, 0, 1)),
         CmdOp.preaccept(txns[4][0], part(txns[4][1]), txns[4][2])])
    ea = store.command_if_present(txns[2][0]).execute_at
    run([CmdOp.preaccept(txns[5][0], part(txns[5][1]), txns[5][2]),
         CmdOp.commit(txns[2][0], txns[2][2], part(txns[2][1]), ea,
                      P.Deps.NONE),
         CmdOp.preaccept(txns[3][0], part(txns[3][1]), txns[3][2],
                         P.Ballot(1, 2, 0, 1))])
    snaps = [_snap(store, node, t) for t, _, _ in txns]
    return out, snaps, plane, lanes


def test_defer_batch_twin_matches_eval_batch(port, ref):
    """The host integer twin of cmd_tick's PreAccept lane: the results and
    the state of eval_batch, and only the mid-batch commit dispatches; the
    port's twin equals the JAX package's, lanes included."""
    dev_out, dev_snaps, _dp, _ = _twin_script(port, defer=False)
    twin_out, twin_snaps, twin_plane, lanes = _twin_script(port, defer=True)
    assert twin_out == dev_out
    assert twin_snaps == dev_snaps
    assert int(twin_plane.dispatches) == 1
    assert int(twin_plane.deferred_spans) >= 2
    j_out, j_snaps, _jp, j_lanes = _twin_script(ref, defer=True)
    assert repr(j_out) == repr(twin_out)
    assert repr(j_snaps) == repr(twin_snaps)
    assert len(lanes) == len(j_lanes)
    for a, b in zip(lanes, j_lanes):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _columns(plane):
    return {k: v.clone() for k, v in plane._device.items()}


def test_repair_round_trip_equals_flush(port):
    """After deferred spans dirty the shadows, collect_repair ->
    kernels.cmd_repair -> adopt_repair leaves the device columns a plain
    _flush() leaves (a twin plane), with nothing dirty; a following
    eval_batch answers identically on both."""
    from accord_tpu_torch.ops import kernels as tk
    CmdOp = port.cmd.CmdOp
    out_r, _s, plane_r, _l = _twin_script(port, defer=True)
    out_f, _s2, plane_f, _l2 = _twin_script(port, defer=True)
    got = plane_r.collect_repair()
    assert got not in (None, "clean")
    block, meta = got
    assert len(block) == 18
    plane_r.adopt_repair(tk.cmd_repair(*block), meta, spans=2)
    assert plane_r.defer_retired == 2
    assert not any(plane_r._dirty.values()) and not plane_r._kdirty
    assert plane_r.collect_repair() == "clean"
    plane_f._flush()
    a, b = _columns(plane_r), _columns(plane_f)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the shadows ARE the columns now
    assert np.array_equal(plane_r.status_h, a["status"].numpy())
    assert np.array_equal(plane_r.kvalid_h, a["kvalid"].numpy())

    def follow(plane):
        store = plane.store
        node = store.node
        txn = _mk_txn(port, [1, 5], 99)
        tid = node.next_txn_id(txn.kind, txn.domain)
        part = txn.slice(store.ranges, include_query=False)
        res = plane.eval_batch([CmdOp.preaccept(tid, part,
                                                node.compute_route(txn))])
        return [(r.outcome, r.status, r.execute_at) for r in res]

    assert follow(plane_r) == follow(plane_f)


def test_shadow_sync_from_chains_equals_device_columns(port, monkeypatch):
    """The port takes a touched row's new shadow values from its last
    writer's chain instead of reading the columns back: after every
    dispatch of a contended burn, a flush leaves the device columns equal
    to the shadows everywhere."""
    from accord_tpu_torch.ops.cmd_plane import CmdPlane
    checked = []
    orig = CmdPlane._run_device

    def run_device(self, run, results):
        orig(self, run, results)
        if run and self._device is not None and not self._device_stale:
            self._flush()
            d = self._device
            for name in ("status", "flags", "promised", "accepted",
                         "execute_at", "durability"):
                assert np.array_equal(self._shadow_of(name),
                                      d[name].numpy()), name
            assert np.array_equal(self.kmax_h, d["kmax"].numpy())
            assert np.array_equal(self.kvalid_h, d["kvalid"].numpy())
            checked.append(len(run))

    monkeypatch.setattr(CmdPlane, "_run_device", run_device)
    rep = port.burn(23, ops=40, write_ratio=0.95, key_count=3,
                    config=_cfg(port, cmd_plane=True, durability=True))
    assert rep.acked == 40
    assert len(checked) > 100


class _Store:
    node = None


def test_recovery_scan_host_predicate_twin(port):
    """recovery_scan_host against a pure-python fold of the predicate:
    live band (terminals above APPLIED out) and stall age, row-ascending;
    the device scan (plain version here) answers the same."""
    from accord_tpu_torch.ops.kernels import (CMD_ST_APPLIED,
                                              CMD_ST_PRE_ACCEPTED)
    plane = port.cmd.CmdPlane(_Store(), initial_cap=64,
                              apply_to_store=False, device="cpu")
    rng = np.random.default_rng(11)
    n = 40
    plane.n_rows = n
    plane.status_h[:n] = rng.integers(0, 12, n)
    plane.touched_h[:n] = rng.integers(0, 900, n)
    tids = [f"t{i}" for i in range(n)]
    plane.tid_by_row = list(tids)
    plane.row_of = {t: i for i, t in enumerate(tids)}
    now, stall = 1000, 300
    expect = [tids[i] for i in range(n)
              if CMD_ST_PRE_ACCEPTED <= plane.status_h[i] < CMD_ST_APPLIED
              and now - plane.touched_h[i] >= stall]
    assert expect, "fixture must produce candidates"
    assert plane.recovery_scan_host(now, stall) == expect
    assert plane.recovery_scan_device(now, stall) == expect
    assert plane.recovery_scan_dispatches == 1
    assert plane.recovery_scan_candidates == len(expect)
    assert plane.recovery_scan_fallbacks == 0


def test_plane_defaults_to_the_card(port):
    """CmdPlane(device=None) and ClusterConfig(cmd_plane=True) mean the
    card: without one they raise instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.cmd.CmdPlane(_Store())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.Cluster(1, port.ClusterConfig(num_nodes=1, rf=1, num_shards=1,
                                           progress=False, cmd_plane=True))
