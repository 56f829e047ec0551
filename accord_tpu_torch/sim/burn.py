"""The burn test: seeded random workload against a simulated cluster with
strict-serializability verification.

Role-equivalent to the reference's BurnTest (test burn/BurnTest.java:107):
generate ~N random read/read-write transactions over a hash-key domain, drive
them through randomly chosen coordinators with bounded concurrency on the
single-threaded logical clock, verify every ack'd result, then check replica
convergence and final-state consistency at quiescence.

CLI:  python -m accord_tpu_torch.sim.burn --seed 1 --ops 1000 [--nodes 3]
      [--count K]  run K consecutive seeds
      [--reconcile] run each seed twice and require identical event logs
      [--device-chaos] device resolvers + seeded device-plane fault
                       injection (dispatch exceptions, stuck harvests,
                       corrupted readbacks, overflow storms)
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

from accord_tpu_torch.coordinate.errors import Invalidated
from accord_tpu_torch.primitives.keyspace import Keys, Range, Ranges
from accord_tpu_torch.primitives.timestamp import Domain, TxnKind
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.sim.cluster import Cluster, ClusterConfig
from accord_tpu_torch.sim.network import LinkConfig
from accord_tpu_torch.sim.list_store import (
    ListQuery, ListRangeRead, ListRangeUpdate, ListRead, ListResult,
    ListUpdate,
)
from accord_tpu_torch.sim.verifier import StrictSerializabilityVerifier
from accord_tpu_torch.utils.rng import RandomSource


class BurnReport:
    def __init__(self):
        self.acked = 0
        self.failed = 0
        self.lost = 0       # submitted but never completed (should be 0 at quiescence)
        self.events = 0
        self.elapsed_sim_ms = 0.0
        self.log: List[str] = []
        # cluster-wide protocol event counts (sum of node.counters): probes
        # sent, informs exchanged -- the home-shard gossip tests compare them
        self.counters: Dict[str, int] = {}
        # cluster-wide MetricsRegistry: every node's registry merged at the
        # end of the run (txn latency histograms, resolver counters); bench
        # JSON reads its snapshot()
        self.registry = None
        # per-kind device-plane injection counts when --device-chaos ran
        # (ops/fault_plane.py), else None
        self.device_faults: Optional[Dict[str, int]] = None

    def as_dict(self) -> dict:
        d = {"acked": self.acked, "failed": self.failed, "lost": self.lost,
             "events": self.events, "elapsed_sim_ms": self.elapsed_sim_ms,
             "counters": dict(self.counters)}
        if self.device_faults is not None:
            d["device_faults"] = dict(self.device_faults)
        return d


def run_burn(seed: int, ops: int = 1000, *, nodes: int = 3, rf: int = 3,
             key_count: int = 32, concurrency: int = 8,
             write_ratio: float = 0.7, max_keys_per_txn: int = 3,
             zipf_theta: float = 0.0,
             ephemeral_read_ratio: float = 0.0,
             chaos_drop: float = 0.0, chaos_partitions: bool = False,
             topology_churn: bool = False, churn_interval_ms: float = 1000.0,
             crash_restart: bool = False, crash_down_ms: float = 800.0,
             range_read_ratio: float = 0.0, range_write_ratio: float = 0.0,
             max_range_width: int = 2048,
             device_chaos: bool = False,
             device_fault_rates: Optional[Dict[str, float]] = None,
             device_messages: bool = False,
             config: Optional[ClusterConfig] = None,
             collect_log: bool = False) -> BurnReport:
    cfg = config or ClusterConfig(num_nodes=nodes, rf=rf)
    if device_messages:
        cfg.device_messages = True
    cluster = Cluster(seed, cfg)
    wl_rng = cluster.rng.fork()
    chaos_rng = cluster.rng.fork()
    # forked UNCONDITIONALLY so every later fork (churn, crash) stays
    # stream-aligned between a chaos run and the fault-free run of the same
    # seed -- the bit-identical-history comparison depends on it
    dev_rng = cluster.rng.fork()
    plane = None
    if device_chaos:
        from accord_tpu_torch.ops.fault_plane import DeviceFaultPlane
        rates = device_fault_rates if device_fault_rates is not None else {
            "dispatch_exc_rate": 0.03, "stuck_rate": 0.03,
            "corrupt_rate": 0.03, "overflow_rate": 0.01,
        }
        plane = DeviceFaultPlane(dev_rng, **rates)
    verifier = StrictSerializabilityVerifier()
    report = BurnReport()
    state = {"submitted": 0, "completed": 0, "next_value": 1}

    # keys drawn from a hot set spread over the hash domain; zipf_theta > 0
    # skews picks toward the head (the contended-throughput bench shape)
    key_space = sorted(wl_rng.sample(range(cfg.key_domain), key_count))
    if zipf_theta > 0.0:
        def pick_key():
            return key_space[wl_rng.zipf(len(key_space), zipf_theta)]
    else:
        def pick_key():
            return wl_rng.pick(key_space)

    def gen_range() -> Ranges:
        anchor = pick_key()
        width = 1 + wl_rng.next_int(max_range_width)
        start = max(0, anchor - wl_rng.next_int(width))
        end = min(cfg.key_domain, start + width)
        return Ranges([Range(start, max(end, start + 1))])

    def gen_txn() -> Tuple[Txn, Optional[int], Dict]:
        if range_read_ratio > 0.0 and wl_rng.decide(range_read_ratio):
            # range-domain READ over an interval of the hash domain
            # (reference burn generates range reads, BurnTest.java:123)
            ranges = gen_range()
            txn = Txn(TxnKind.READ, ranges, read=ListRangeRead(ranges),
                      query=ListQuery())
            return txn, None, {}
        if range_write_ratio > 0.0 and wl_rng.decide(range_write_ratio):
            # range-domain WRITE: conflicts/deps ride the RANGE domain
            # (RangeDeps write paths), while the value lands on the hot keys
            # inside the range so the strict-serializability verifier knows
            # the write set up front
            ranges = gen_range()
            rng0 = ranges[0]
            targets = Keys(k for k in key_space
                           if rng0.start <= k < rng0.end)
            value = state["next_value"]
            state["next_value"] += 1
            txn = Txn(TxnKind.WRITE, ranges, read=ListRangeRead(ranges),
                      update=ListRangeUpdate(ranges, targets, value),
                      query=ListQuery())
            return txn, value, {k: value for k in targets}
        if ephemeral_read_ratio > 0.0 and wl_rng.decide(ephemeral_read_ratio):
            # SINGLE-key ephemeral read: strict-serializable (multi-key
            # ephemeral reads are only per-key linearizable -- reference
            # CoordinateEphemeralRead.java class doc -- and would trip the
            # cross-key checker)
            key = pick_key()
            txn = Txn(TxnKind.EPHEMERAL_READ, Keys([key]),
                      read=ListRead(Keys([key])), query=ListQuery())
            return txn, None, {}
        nkeys = wl_rng.next_int_between(1, max_keys_per_txn + 1)
        chosen = Keys(pick_key() for _ in range(nkeys))
        is_write = wl_rng.decide(write_ratio)
        read = ListRead(chosen)
        if is_write:
            value = state["next_value"]
            state["next_value"] += 1
            update = ListUpdate(chosen, value)
            txn = Txn(TxnKind.WRITE, chosen, read=read, update=update,
                      query=ListQuery())
            return txn, value, {k: value for k in chosen}
        return Txn(TxnKind.READ, chosen, read=read, query=ListQuery()), None, {}

    def submit():
        if state["submitted"] >= ops:
            return
        state["submitted"] += 1
        txn, value, writes = gen_txn()
        start_us = cluster.queue.now_micros
        if value is not None:
            verifier.on_issue_write(value, start_us)
        attempt(txn, value, writes, start_us, retries=3)

    down: set = set()      # crashed node ids (never used as coordinators)
    inflight: Dict = {}    # token -> (coordinator_id, fail_fn): a crashed
                           # coordinator's client callbacks die with it, so
                           # the workload fails those attempts itself (the
                           # real client's timeout)
    tokens = iter(range(1 << 30))

    def attempt(txn, value, writes, start_us, retries):
        up = [n for n in range(1, cfg.num_nodes + 1) if n not in down]
        node = cluster.nodes[wl_rng.pick(up)]
        token = next(tokens)
        done_flag = [False]

        def complete(result, failure):
            if done_flag[0]:
                return
            done_flag[0] = True
            inflight.pop(token, None)
            end_us = cluster.queue.now_micros
            if failure is None:
                state["completed"] += 1
                report.acked += 1
                assert isinstance(result, ListResult)
                verifier.witness(start_us, end_us, result.reads, writes)
                if collect_log:
                    report.log.append(
                        f"{end_us} ack {result.txn_id} reads={sorted(result.reads.items())} w={value}")
            elif isinstance(failure, Invalidated) and retries > 0:
                # an invalidation PROVES the txn never executed and never
                # will (e.g. it raced a durability sync point's reject
                # floor): retrying with a fresh txn id is always safe --
                # unlike a timeout, whose outcome is unknown
                attempt(txn, value, writes, start_us, retries - 1)
                return
            else:
                state["completed"] += 1
                report.failed += 1
                if collect_log:
                    report.log.append(f"{end_us} fail {type(failure).__name__} w={value}")
            # keep the pipeline full
            cluster.queue.add(wl_rng.next_int(5_000), submit)

        inflight[token] = (node.id, lambda f: complete(None, f))
        node.coordinate(txn).add_callback(complete)

    # chaos: periodically re-randomize link behavior (drops, partitions) the
    # way the reference's burn test reshuffles Cluster.Link every 5s of sim
    # time (reference test Cluster.java:458-462); heals once every op has
    # completed so recovery can finish the stragglers before quiescence.
    def heal():
        net = cluster.network
        net.partitioned.clear()
        for a in cluster.nodes:
            for b in cluster.nodes:
                if a != b:
                    net.set_link(a, b, LinkConfig())

    def chaos_tick():
        if state["completed"] >= ops:
            heal()
            return
        net = cluster.network
        net.partitioned.clear()
        if chaos_partitions and chaos_rng.decide(0.4):
            victim = 1 + chaos_rng.next_int(cfg.num_nodes)
            for other in cluster.nodes:
                if other != victim:
                    net.set_partitioned(victim, other, True)
        for a in cluster.nodes:
            for b in cluster.nodes:
                if a == b:
                    continue
                drop = chaos_rng.next_float() * chaos_drop
                net.set_link(a, b, LinkConfig(drop_probability=drop))
        cluster.queue.add(2_000_000, chaos_tick)

    if chaos_drop > 0.0 or chaos_partitions:
        cluster.queue.add(500_000, chaos_tick)

    # topology churn: split/merge/move shards every simulated second (the
    # reference's TopologyRandomizer, test topology/TopologyRandomizer.java:60);
    # stops once the workload completes so stragglers can recover to quiescence.
    if topology_churn:
        from accord_tpu_torch.sim.topology_randomizer import TopologyRandomizer
        TopologyRandomizer(cluster, cluster.rng.fork(),
                           interval_us=int(churn_interval_ms * 1000),
                           should_stop=lambda: state["completed"] >= ops).start()

    # crash/restart: kill each node once (staggered, one at a time so every
    # quorum survives), replay its journal on restart and diff the rebuilt
    # command state against the pre-crash snapshot (reference: Journal +
    # pseudo-restart, test impl/basic/Journal.java:59)
    if crash_restart:
        crash_rng = cluster.rng.fork()

        def schedule_crash(nid: int, at_us: int):
            def crash():
                if state["completed"] >= ops:
                    return  # workload done
                if down:
                    # another node is still down/recovering: defer rather
                    # than silently skip this node's crash
                    cluster.queue.add(int(crash_down_ms * 1000 * 2), crash)
                    return
                down.add(nid)
                snapshot = cluster.crash_node(nid)
                from accord_tpu_torch.coordinate.errors import Timeout as _T
                for token, (coord, fail) in list(inflight.items()):
                    if coord == nid:
                        fail(_T(f"coordinator n{nid} crashed"))

                def restart():
                    def verify():
                        cluster.verify_rebuild(nid, snapshot)

                    # rebuild diff anchors on ACTUAL replay+catch-up issue
                    # (epoch re-learning can outlast the scheduled replay
                    # span); the NEXT crash waits for bootstrap completion
                    # (on_healthy -> down cleared) -- overlapping full-range
                    # gaps on multiple nodes livelock the fetch protocol
                    cluster.restart_node(
                        nid,
                        on_ready=lambda: cluster.queue.add(1_500_000, verify),
                        on_healthy=lambda: down.discard(nid))

                cluster.queue.add(int(crash_down_ms * 1000), restart)

            cluster.queue.add(at_us, crash)

        for i, nid in enumerate(sorted(cluster.nodes)):
            schedule_crash(nid, 1_500_000 + i * int(crash_down_ms * 1000 * 4)
                           + crash_rng.next_int(500_000))

    if cfg.durability:
        cluster.start_durability(
            should_stop=lambda: state["completed"] >= ops)

    # kick off with bounded concurrency
    for i in range(min(concurrency, ops)):
        cluster.queue.add(wl_rng.next_int(20_000), submit)

    if plane is not None:
        from accord_tpu_torch.ops import fault_plane
        with fault_plane.scoped(plane):
            report.events = cluster.drain(max_events=ops * 20000)
        report.device_faults = dict(plane.injected)
    else:
        report.events = cluster.drain(max_events=ops * 20000)
    report.elapsed_sim_ms = (cluster.queue.now_micros - 1_000_000) / 1000.0
    report.lost = state["submitted"] - state["completed"]

    if not cluster.queue.is_empty():
        # the final-state checks below are only meaningful at quiescence;
        # hitting the event cap usually means a liveness bug (or a straggler
        # recovery tail larger than the cap) -- report it as such rather than
        # as a bogus divergence
        raise AssertionError(
            f"no quiescence after {report.events} events "
            f"({len(cluster.queue)} pending, sim {report.elapsed_sim_ms:.0f}ms, "
            f"completed {state['completed']}/{state['submitted']})")
    cluster.check_no_failures()
    verifier.check_final_state(cluster.converged_key_lists())
    report.counters = cluster.total_counters()
    # fold command-plane counters (dispatches, upload bytes, fastpath evals,
    # fallbacks) in beside the engine counters so burn JSON carries them
    for node in cluster.nodes.values():
        for store in node.command_stores.all():
            for plane in (store.cmd_plane,
                          getattr(store, "exec_plane", None)):
                if plane is not None:
                    for k, v in plane.snapshot().items():
                        if isinstance(v, (int, float)):
                            report.counters[k] = \
                                report.counters.get(k, 0) + v
    # per-node exec coordinators (fused frontier dispatch) fold in beside
    # their planes' counters
    for coord in getattr(cluster, "exec_coordinators", {}).values():
        for k, v in coord.snapshot().items():
            if isinstance(v, (int, float)):
                report.counters[k] = report.counters.get(k, 0) + v
    # device message plane counters (empty dict on the host baseline)
    for k, v in cluster.network.message_plane_snapshot().items():
        report.counters[k] = v
    from accord_tpu_torch.obs.metrics import MetricsRegistry
    report.registry = MetricsRegistry()
    for node in cluster.nodes.values():
        report.registry.merge_from(node.metrics)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="accord_tpu burn test")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ops", type=int, default=1000)
    ap.add_argument("--count", type=int, default=1, help="number of seeds to run")
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--rf", type=int, default=3)
    ap.add_argument("--keys", type=int, default=32)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--zipf-theta", type=float, default=0.0,
                    help="skew key picks toward the hot-set head (0 = uniform)")
    ap.add_argument("--ephemeral-read-ratio", type=float, default=0.0,
                    help="fraction of txns issued as single-key ephemeral reads")
    ap.add_argument("--chaos-drop", type=float, default=0.0,
                    help="max per-link drop probability (re-randomized every 2s)")
    ap.add_argument("--range-read-ratio", type=float, default=0.0)
    ap.add_argument("--range-write-ratio", type=float, default=0.0)
    ap.add_argument("--chaos-partitions", action="store_true",
                    help="periodically partition a random node")
    ap.add_argument("--topology-churn", action="store_true",
                    help="randomly split/merge/move shards during the burn")
    ap.add_argument("--churn-interval-ms", type=float, default=1000.0)
    ap.add_argument("--crash-restart", action="store_true",
                    help="crash+restart each node once (journal replay)")
    ap.add_argument("--crash-down-ms", type=float, default=800.0,
                    help="simulated downtime before a crashed node restarts")
    ap.add_argument("--device-chaos", action="store_true",
                    help="device resolvers + seeded device-plane fault "
                         "injection (see ops/fault_plane.py)")
    ap.add_argument("--device-messages", action="store_true",
                    help="route replica traffic through the device mailbox "
                         "plane fused into protocol_tick (see sim/network.py)")
    ap.add_argument("--reconcile", action="store_true",
                    help="run each seed twice; require identical logs")
    args = ap.parse_args(argv)

    config_factory = None
    if args.device_chaos:
        # the injected faults land on the DEVICE dispatch path, so the run
        # needs device resolvers; a fresh config per run keeps --reconcile
        # legs from sharing resolver state
        from accord_tpu_torch.ops.resolver import BatchDepsResolver
        from accord_tpu_torch.sim.cluster import ClusterConfig as _CC

        def config_factory():
            return _CC(
                num_nodes=args.nodes, rf=args.rf,
                deps_resolver_factory=lambda: BatchDepsResolver(
                    num_buckets=128),
                deps_batch_window_ms=2.0, device_latency_ms=8.0)

    ok = True
    for seed in range(args.seed, args.seed + args.count):
        kwargs = dict(ops=args.ops, nodes=args.nodes, rf=args.rf,
                      key_count=args.keys, concurrency=args.concurrency,
                      zipf_theta=args.zipf_theta,
                      ephemeral_read_ratio=args.ephemeral_read_ratio,
                      chaos_drop=args.chaos_drop,
                      range_read_ratio=args.range_read_ratio,
                      range_write_ratio=args.range_write_ratio,
                      chaos_partitions=args.chaos_partitions,
                      topology_churn=args.topology_churn,
                      churn_interval_ms=args.churn_interval_ms,
                      crash_restart=args.crash_restart,
                      crash_down_ms=args.crash_down_ms,
                      device_chaos=args.device_chaos,
                      device_messages=args.device_messages)
        try:
            if config_factory is not None:
                kwargs["config"] = config_factory()
            r = run_burn(seed, collect_log=args.reconcile, **kwargs)
            if args.reconcile:
                if config_factory is not None:
                    kwargs["config"] = config_factory()
                r2 = run_burn(seed, collect_log=True, **kwargs)
                if r.log != r2.log:
                    print(f"seed {seed}: NON-DETERMINISTIC ({len(r.log)} vs {len(r2.log)} entries)")
                    ok = False
                    continue
            print(json.dumps({"seed": seed, **r.as_dict(),
                              "deterministic": args.reconcile or None}))
        except AssertionError as e:
            print(f"seed {seed}: FAILED: {e}")
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
