"""Cluster-on-mesh burn: node id as a batch axis (ROADMAP item 2).

The stock burn (sim/burn.py) ticks each node's resolver from its own
scheduler event, so a cluster tick costs one device dispatch PER NODE and
cluster scale is bounded by host single-thread dispatch overhead no matter
how fast the kernels run. This module lifts PR 4's store-id-lane fusion one
level up: a ClusterTickEngine takes over tick scheduling for every node's
resolver (resolver.tick_driver), drains and encodes each pending node
host-side exactly as before, then stacks every node's encoded dispatch
plans into ONE node-major device call per cluster tick (ops/node_lane.py)
-- key/range arena lane blocks under globally unique (plan, store) slots, a
traced `subj_node` routing lane, one contiguous packed readback demuxed by
per-plan word spans (the `_Group` row-offset-table pattern).

Determinism and differential testing: the sim network, scheduler, fault
planes, and every host-side protocol decision are untouched -- the engine
replaces only WHERE the resolve kernels run. Both engine modes share one
event schedule, so `mesh_tick=True` (node-lane merged dispatch) commits
bit-identical histories to `mesh_tick=False` (the per-node Python launch
loop over the same plans), and `--reconcile` holds in both. The merged
kernel's per-plan output slices are bit-identical to the per-plan kernel
calls by construction (exact 0/1 bf16 integer products, per-block slot
masks, 32-aligned word spans, baseline `_pad_fused` padding replicated
inside each plan's span -- see ops/node_lane.py).

The protocol megakernel (megakernel=True, single device): the whole tick
collapses further, into ONE fused device program (ops/kernels.protocol_tick)
-- key+range node-lane resolve, every merged plan's finalize-CSR compaction
demuxed IN-KERNEL at its merge span (checksum word included), and the
fast-path electorate-quorum count over the tick's PreAccept lanes. The
cmd-plane spans that used to dispatch synchronously inside each node's
drain instead decide on the HOST INTEGER TWIN (cmd_plane.defer_batch) --
the drain needs decisions before the dispatch is assembled -- and their
transition lanes ride the same program's quorum stage. Harvest demux is
pure host slicing of the one contiguous readback (node_lane.MergedView),
so post-warmup a cluster tick costs exactly one device program launch
(`launches_per_tick`). mesh_tick=False (the per-node loop) and
megakernel=False (the unfused <=2-dispatch merge) stay live as
bit-identical differential baselines under --reconcile. On a sharded
resolver the same megakernel staging launches through
parallel/mesh.sharded_protocol_tick instead -- one fused MESH program per
cluster tick, replica payloads riding the cross-shard mailbox all_to_all
-- with work that cannot fuse (heterogeneous resolver configs, unrecorded
plan args) counted in `sharded_megakernel_fallbacks` and launched through
the unfused sharded pair.

CLI:  python -m accord_tpu_torch.sim.mesh_burn --seed 1 --ops 500 --nodes 8
      [--python-loop]  per-node launch loop (the differential baseline)
      [--megakernel]   one fused protocol_tick program per cluster tick
      [--reconcile]    run each seed twice; require identical event logs
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np

from accord_tpu_torch.obs.trace import CLUSTER_PID, REC, node_ts
from accord_tpu_torch.sim.burn import BurnReport, run_burn
from accord_tpu_torch.sim.cluster import ClusterConfig

logger = logging.getLogger(__name__)


class ClusterTickEngine:
    """Owns tick scheduling for every adopted resolver: one cluster-wide
    tick event replaces the per-node `scheduler.once` arms, and each firing
    drains + stages every pending node in node-id order, then launches all
    plans -- through one merged node-lane dispatch (mesh_tick=True) or the
    per-node loop (mesh_tick=False, the bit-identical baseline).

    The engine discovers the shared PendingQueue from the first noting
    node's scheduler and arms its tick on the RAW queue (not a
    NodeScheduler), so one node's crash cannot kill the cluster tick; dead
    nodes are skipped at fire time via their scheduler's alive cell, which
    is exactly the baseline's NodeScheduler-guard semantics."""

    def __init__(self, mesh_tick: bool = True, megakernel: bool = False,
                 device_messages: bool = False,
                 exec_in_megakernel: bool = False):
        self.mesh_tick = mesh_tick
        # megakernel rides the mesh_tick staging (it consumes the same
        # recorded plan args); cmd spans defer to the host twin so their
        # transition lanes can join the fused program's quorum stage
        self.megakernel = megakernel and mesh_tick
        self.cmd_defer = self.megakernel
        # exec planes join the megakernel: ExecCoordinator compact blocks
        # stage here (stage_exec) and ride the next fused protocol_tick;
        # a harvest coming due with no cluster tick in between flushes the
        # queued blocks as one exec-only fused tick (flush_exec), so
        # launches_per_tick holds 1.0 with exec traffic included
        self.exec_in_megakernel = exec_in_megakernel and self.megakernel
        self._exec_blocks: List = []
        self._exec_wtable = None     # witness table for exec-only flushes
        self._exec_mesh = None       # sharded resolver's mesh, if any
        # device message plane: replica payloads ride the mailbox routing
        # stage of the same fused program (requires the megakernel; the
        # DeviceMessageNetwork batches deliveries either way)
        self.device_messages = device_messages and self.megakernel
        self._net = None               # DeviceMessageNetwork once discovered
        # planes with deferred twin spans whose flush debt should fold into
        # the next fused tick as repair scatters: id -> [plane, span_count]
        self._defer_spans: Dict[int, list] = {}
        # fast-path electorate majority for the in-kernel quorum count
        # (run_mesh_burn sets it from rf)
        self.quorum_size = 1
        self._pending: Dict[tuple, tuple] = {}
        self._armed = False
        self._queue = None
        # registry counters (folded into the burn report / bench JSON; see
        # obs/metrics.GLOSSARY)
        self.cluster_ticks = 0
        self.node_lane_dispatches = 0
        self.mesh_tick_fallbacks = 0
        self.megakernel_dispatches = 0
        self.sharded_megakernel_fallbacks = 0
        self.fastpath_quorum_txns = 0
        self.exec_scan_blocks = 0
        self.exec_flush_ticks = 0
        # per-plan deferred kernel calls staged this run -- in loop mode
        # each is one device dispatch; in mesh mode they collapse into
        # node_lane_dispatches (bench reads this attribute directly; it
        # is not a glossary counter). Includes cmd_tick spans fired
        # synchronously inside each node's drain (note_cmd_dispatches).
        self.plan_kernel_launches = 0
        # device program launches attributable to the tick path (merged
        # dispatches, per-plan demux slices, finalize launches, cmd spans):
        # the numerator of launches_per_tick. In megakernel mode every
        # fused tick contributes exactly 1.
        self.protocol_launches = 0
        self._ticks_with_dispatch = 0
        self._nodes_in_dispatches = 0
        self._rows_used = 0
        self._rows_total = 0
        # deferred cmd-plane transition lanes awaiting the next fused tick
        # (note_cmd_lanes), and fused quorum outputs awaiting their lazy
        # host readback (drained at the next fire/snapshot)
        self._cmd_lanes: List[tuple] = []
        self._pending_quorum: List[tuple] = []
        self._warned_cfgs: set = set()
        self._warned_sharded: set = set()
        # set when a sharded mesh cannot carry the message plane: keeps
        # host messages without re-probing (and re-counting) every note
        self._mail_plane_blocked = False

    def adopt(self, resolver):
        """Attach this engine as the resolver's tick driver (wrap the
        cluster's deps_resolver_factory with this so restarts' fresh
        resolvers re-attach automatically)."""
        resolver.tick_driver = self
        return resolver

    def snapshot(self) -> Dict[str, float]:
        self._drain_quorum()
        n = self.node_lane_dispatches
        t = self._ticks_with_dispatch
        return {
            "cluster_ticks": self.cluster_ticks,
            "node_lane_dispatches": n,
            "nodes_per_dispatch": (self._nodes_in_dispatches / n) if n else 0.0,
            "node_pad_fraction": (
                (self._rows_total - self._rows_used) / self._rows_total
                if self._rows_total else 0.0),
            "mesh_tick_fallbacks": self.mesh_tick_fallbacks,
            "megakernel_dispatches": self.megakernel_dispatches,
            "sharded_megakernel_fallbacks": self.sharded_megakernel_fallbacks,
            "launches_per_tick": (self.protocol_launches / t) if t else 0.0,
            "fastpath_quorum_txns": self.fastpath_quorum_txns,
            "exec_scan_blocks": self.exec_scan_blocks,
            "exec_flush_ticks": self.exec_flush_ticks,
        }

    # -- exec-plane hooks (ops/exec_plane.ExecCoordinator) -----------------
    def stage_exec(self, planes, out_cap: int, node):
        """An ExecCoordinator's compacted frontier block, staged to ride
        the next fused protocol_tick. Returns an ExecTicket the coordinator
        holds in place of a launched result; the block's device compute is
        the same _frontier_compact_body either way, so WHERE it launches is
        invisible to the simulation (no scheduler events, no rng draws --
        histories stay bit-identical to the standalone coordinator)."""
        from accord_tpu_torch.ops.exec_plane import ExecTicket
        if self._exec_wtable is None:
            res = getattr(node, "_deps_resolver", None)
            self._exec_wtable = getattr(res, "_table", None)
            self._exec_mesh = getattr(res, "mesh", None)
        ticket = ExecTicket(planes, out_cap)
        self._exec_blocks.append(ticket)
        return ticket

    def _pop_exec_tickets(self):
        if not (self.exec_in_megakernel and self._exec_blocks):
            return ()
        tickets, self._exec_blocks = tuple(self._exec_blocks), []
        return tickets

    def _fulfill_exec(self, tickets, exec_outs) -> None:
        from accord_tpu_torch.ops.resolver import _DevBuf
        for t, out in zip(tickets, exec_outs):
            lanes = _DevBuf(tuple(out[:3]))
            lanes.copy_async()
            t.result = (lanes, out[3])
        self.exec_scan_blocks += len(tickets)

    def flush_exec(self) -> None:
        """Launch every queued exec block as ONE exec-only fused tick: the
        coordinator's harvest came due before any cluster tick fired. The
        flush is its own tick in the launch ledger (one launch, one tick
        with dispatch), so launches_per_tick == 1.0 holds by construction
        even on exec-dominated idle tails."""
        tickets = self._pop_exec_tickets()
        if not tickets:
            return
        execs = tuple((t.planes, t.out_cap) for t in tickets)
        if self._exec_mesh is not None:
            from accord_tpu_torch.parallel.mesh import sharded_protocol_tick
            exec_outs = sharded_protocol_tick(
                self._exec_mesh, self._exec_wtable, execs=execs)[7]
        else:
            from accord_tpu_torch.ops.kernels import protocol_tick
            exec_outs = protocol_tick(self._exec_wtable, execs=execs)[7]
        self._fulfill_exec(tickets, exec_outs)
        self.exec_flush_ticks += 1
        self.megakernel_dispatches += 1
        self.protocol_launches += 1
        self._ticks_with_dispatch += 1

    # -- cmd-plane hooks (resolver._drain_and_preaccept) -------------------
    def note_cmd_dispatches(self, n: int) -> None:
        """A drain's synchronous cmd_tick spans fired n device dispatches
        (non-deferred mode): they belong to this tick's launch count."""
        self.plan_kernel_launches += n
        self.protocol_launches += n

    def note_cmd_lanes(self, q_txn, q_ts, q_code) -> None:
        """A deferred cmd-plane span's transition lanes (host-twin
        decided): stacked into the next fused tick's quorum stage."""
        self._cmd_lanes.append((q_txn, q_ts, q_code))

    def note_cmd_defer(self, plane) -> None:
        """Device-messages mode: a deferred twin span ran on `plane`; its
        shadow-write flush debt should retire inside the next fused tick
        (collect_repair) instead of a standalone flush dispatch."""
        ent = self._defer_spans.get(id(plane))
        if ent is None:
            self._defer_spans[id(plane)] = [plane, 1]
        else:
            ent[1] += 1

    def _collect_cmd_repairs(self):
        """Repair blocks for every plane that deferred since the last fused
        tick. Planes whose arena is not live (None) keep their debt for the
        ordinary lazy _flush; planes already clean (an interleaved flush
        repaired them) fold nothing."""
        pending, self._defer_spans = self._defer_spans, {}
        blocks, adopts = [], []
        for plane, spans in pending.values():
            rep = plane.collect_repair()
            if rep is None or rep == "clean":
                continue
            block, meta = rep
            blocks.append(block)
            adopts.append((plane, meta, spans))
        return blocks, adopts

    def _drain_quorum(self) -> None:
        """Count fast-path quorum txns from completed fused ticks: the
        device `met` lane is read back lazily (here, a tick later or at
        snapshot), never on the tick's critical path."""
        for met_dev, q_txn in self._pending_quorum:
            met = met_dev.cpu().numpy()
            hit = {tuple(int(x) for x in q_txn[i])
                   for i in np.nonzero(met[:len(q_txn)])[0]}
            self.fastpath_quorum_txns += len(hit)
        self._pending_quorum = []

    # -- resolver hook ----------------------------------------------------
    def note_work(self, resolver, node, window_ms: float) -> None:
        """Called by the resolver in place of arming its own tick. Dedupes
        per (resolver, node); the first note after an idle period arms the
        cluster tick at that node's effective window."""
        self._queue = node.scheduler.queue
        if self.device_messages and self._net is None \
                and not self._mail_plane_blocked:
            net = getattr(getattr(node, "message_sink", None),
                          "network", None)
            if net is not None and hasattr(net, "attach_engine"):
                shards = 1
                mesh = getattr(resolver, "mesh", None)
                if mesh is not None:
                    from accord_tpu_torch.parallel.mesh import (
                        mesh_supports_message_plane)
                    if mesh_supports_message_plane(mesh):
                        shards = mesh.shape["data"]
                    else:
                        # messages keep the host path; payloads never stage
                        self._mail_plane_blocked = True
                        self._note_sharded_fallback(
                            "mesh does not support the message plane")
                if not self._mail_plane_blocked:
                    net.attach_engine(self, shards=shards)
                    self._net = net
        key = (id(resolver), id(node))
        if key not in self._pending:
            self._pending[key] = (resolver, node)
        if not self._armed:
            self._armed = True
            self._queue.add(int((window_ms or 0.0) * 1000), self._fire)

    # -- the cluster tick -------------------------------------------------
    def _fire(self) -> None:
        self._armed = False
        self._drain_quorum()
        pend = sorted(self._pending.values(), key=lambda rn: rn[1].id)
        self._pending = {}
        if not pend:
            return
        self.cluster_ticks += 1
        # launches attributed to this tick = the delta over the whole fire
        # (drains fire synchronous cmd spans before staging completes)
        l0 = self.protocol_launches
        t0 = _time.perf_counter()
        rec_ts = node_ts(pend[0][1]) if REC.enabled else 0
        staged: List[tuple] = []
        for res, node in pend:
            if not node.scheduler.alive[0]:
                # crashed since noting work: its queued items die with the
                # incarnation, exactly as the baseline's NodeScheduler
                # guard would have dropped the armed tick
                continue
            items = res._drain_and_preaccept(node)
            res._adapt(node, len(items))
            plans = [res._stage(node, sub) for sub in res._slices(items)]
            if plans:
                staged.append((res, node, plans))
        if staged:
            for _res, _node, plans in staged:
                for plan in plans:
                    self.plan_kernel_launches += (
                        (plan.key_call is not None)
                        + (plan.range_call is not None))
            if self.mesh_tick:
                self._merged_launch(staged)
            else:
                for res, node, plans in staged:
                    for plan in plans:
                        self.protocol_launches += (
                            (plan.key_call is not None)
                            + (plan.range_call is not None)
                            + len(plan.fin_calls) + len(plan.rfin_calls)
                            + len(plan.kfin_calls))
                        res._launch(node, plan)
        launched = self.protocol_launches - l0
        if launched:
            self._ticks_with_dispatch += 1
        if REC.enabled:
            REC.complete(CLUSTER_PID, "cluster", "cluster_tick", rec_ts,
                         dur=round((_time.perf_counter() - t0) * 1e6, 3),
                         args={"nodes": len(staged), "launches": launched,
                               "megakernel": self.megakernel})

    def _merged_launch(self, staged: List[tuple]) -> None:
        """Stack every plan's recorded kernel inputs into at most one key
        and one range node-lane dispatch, swap each plan's deferred calls
        for demux slices of the merged results, then launch the plans in
        node-id order -- fault draws, harvest scheduling, and decode all
        run the stock per-plan path against bit-identical buffers."""
        from accord_tpu_torch.ops import node_lane as nl
        res0 = staged[0][0]
        mesh = getattr(res0, "mesh", None)
        key_entries: List[tuple] = []
        rng_entries: List[tuple] = []
        lane_nodes = set()
        for res, node, plans in staged:
            mergeable = res.num_buckets == res0.num_buckets
            if not mergeable:
                self._warn_config(res, res0)
            for plan in plans:
                if not mergeable:
                    # heterogeneous resolver config: this plan launches its
                    # own kernels (still correct, just not merged)
                    if plan.key_call is not None or plan.range_call is not None:
                        self.mesh_tick_fallbacks += 1
                        if self.megakernel and mesh is not None:
                            self._note_sharded_fallback(
                                "heterogeneous resolver config")
                    continue
                if (plan.key_call is not None and plan.key_args is None) or \
                        (plan.range_call is not None and plan.range_args is None):
                    self.mesh_tick_fallbacks += 1
                    if self.megakernel and mesh is not None:
                        self._note_sharded_fallback("unrecorded plan args")
                    continue
                if plan.key_args is not None:
                    key_entries.append((plan, plan.key_args))
                    lane_nodes.add(id(node))
                if plan.range_args is not None:
                    rng_entries.append((plan, plan.range_args))
                    lane_nodes.add(id(node))
        km = rm = None
        packed = rpacked = kpacked = None
        if key_entries:
            km = nl.build_key_merge(key_entries, res0._pad_key_block,
                                    res0.pad_node_tiers)
        if rng_entries:
            rm = nl.build_range_merge(rng_entries, res0._pad_key_block,
                                      res0._pad_range_block,
                                      res0.pad_node_tiers)
        if self.megakernel:
            self._megakernel_launch(staged, key_entries, rng_entries,
                                    km, rm, lane_nodes, nl, res0, mesh)
            return
        if mesh is not None:
            from accord_tpu_torch.parallel.mesh import sharded_node_tick
            packed, rpacked, kpacked = sharded_node_tick(
                mesh, km, rm, res0._table)
        else:
            if km is not None:
                packed = nl.run_key_merge(km, res0._table)
            if rm is not None:
                rpacked, kpacked = nl.run_range_merge(rm, res0._table)
        ndisp = (1 if km is not None else 0) + (1 if rm is not None else 0)
        if ndisp:
            self.node_lane_dispatches += ndisp
            self._nodes_in_dispatches += len(lane_nodes) * ndisp
        for merge in (km, rm):
            if merge is not None:
                self._rows_used += merge.rows_used
                self._rows_total += merge.rows_padded
        # unfused launch ledger: the merged dispatches, each plan's demux
        # lane_slice calls, every finalize launch, and unmerged plans'
        # own resolve kernels
        merged_ids = ({id(p) for p, _ in key_entries}
                      | {id(p) for p, _ in rng_entries})
        self.protocol_launches += ndisp + len(key_entries)
        for _p, args in rng_entries:
            self.protocol_launches += (int(bool(args["has_r"]))
                                       + int(bool(args["has_k"])))
        for res, node, plans in staged:
            for plan in plans:
                self.protocol_launches += (
                    len(plan.fin_calls) + len(plan.rfin_calls)
                    + len(plan.kfin_calls))
                if id(plan) not in merged_ids:
                    self.protocol_launches += (
                        (plan.key_call is not None)
                        + (plan.range_call is not None))
        # the demux: every plan's window of a merged result in one
        # lane_slice_many launch; each plan's call returns its view
        if km is not None:
            views = nl.lane_slice_many(
                (packed,), [(0, r0, wlo, b, w)
                            for (r0, b, wlo, w), _e in zip(km.spans,
                                                           key_entries)])
            for (plan, _args), view in zip(key_entries, views):
                plan.key_call = lambda view=view: view
        if rm is not None:
            wins = []
            for (_plan, args), (r0, b, rwlo, rw, kwlo, kw) \
                    in zip(rng_entries, rm.spans):
                if args["has_r"]:
                    wins.append((0, r0, rwlo, b, rw))
                if args["has_k"]:
                    wins.append((1, r0, kwlo, b, kw))
            views = iter(nl.lane_slice_many((rpacked, kpacked), wins))
            for (plan, args), _span in zip(rng_entries, rm.spans):
                rp = next(views) if args["has_r"] else None
                kp = next(views) if args["has_k"] else None
                plan.range_call = lambda rp=rp, kp=kp: (rp, kp)
        for res, node, plans in staged:
            for plan in plans:
                res._launch(node, plan)

    def _warn_config(self, res, res0) -> None:
        """Satellite diagnostics for heterogeneous resolver configs: the
        mismatch is counted per plan in mesh_tick_fallbacks; here it is
        logged ONCE per config-pair signature so a misconfigured cluster
        is visible without flooding the burn."""
        sig = (type(res).__name__, res.num_buckets,
               type(res0).__name__, res0.num_buckets)
        if sig in self._warned_cfgs:
            return
        self._warned_cfgs.add(sig)
        logger.warning(
            "mesh tick: resolver config %s(num_buckets=%s) cannot merge "
            "with %s(num_buckets=%s); its plans launch unfused "
            "(counted in mesh_tick_fallbacks)", *sig)

    def _note_sharded_fallback(self, reason: str) -> None:
        """Satellite diagnostics mirroring mesh_tick_fallbacks' convention
        for the sharded megakernel: every piece of work the fused mesh
        program cannot carry bumps the counter, and each distinct reason
        logs once per engine so a degraded multi-chip run is visible
        without flooding the burn."""
        self.sharded_megakernel_fallbacks += 1
        if reason not in self._warned_sharded:
            self._warned_sharded.add(reason)
            logger.warning(
                "sharded megakernel: %s -- that work keeps the unfused "
                "sharded path (counted in sharded_megakernel_fallbacks)",
                reason)

    def _megakernel_launch(self, staged, key_entries, rng_entries, km, rm,
                           lane_nodes, nl, res0, mesh=None) -> None:
        """ONE fused device program for the whole cluster tick
        (ops/kernels.protocol_tick): the merged key+range resolve, every
        merged plan's finalize compaction demuxed in-kernel at its merge
        span, and the quorum count over the drains' deferred cmd lanes.
        Plan calls are swapped for host-side views/results of the fused
        outputs (node_lane.MergedView slices the one contiguous readback),
        then every plan launches through the stock path -- fault draws,
        harvest scheduling, decode, and generation pins are untouched, so
        histories stay bit-identical to the unfused merge and to the
        per-node loop. With `mesh` set (sharded resolvers) the identical
        staging launches through parallel/mesh.sharded_protocol_tick --
        the same one-launch ledger, the resolve/finalize stages sharded
        over the mesh, and the mailbox stage exchanging cross-shard
        payloads in-program."""
        import functools

        from accord_tpu_torch.ops.kernels import protocol_tick
        from accord_tpu_torch.ops.tiers import mega_lane_tier
        if mesh is not None:
            from accord_tpu_torch.parallel.mesh import sharded_protocol_tick
            tick = functools.partial(sharded_protocol_tick, mesh)
        else:
            tick = protocol_tick

        # host lanes go as numpy: on the card protocol_tick writes them
        # into its graph's parameter block, one copy for the whole tick
        key_in = rng_in = None
        if km is not None:
            key_in = (km.subj_of, km.subj_keys, km.subj_node, km.sb,
                      km.sknd, km.slots, km.blocks)
        if rm is not None:
            rng_in = (rm.iv_of, rm.iv_s, rm.iv_e, rm.subj_node, rm.sb,
                      rm.sknd, rm.srng, rm.r_slots, rm.r_blocks, rm.k_slots,
                      rm.k_blocks)
        # finalize specs, index-aligned with each plan's deferred calls
        fins: List[tuple] = []
        fin_sched: List[tuple] = []     # (plan, "fin"|"rfin"|"kfin", gi)
        if km is not None:
            for (plan, _args), (r0, b, wlo, w) in zip(key_entries, km.spans):
                for gi, (_g, spec) in enumerate(plan.fin_args):
                    (_k, kid_rows, j_subj, j_kid, j_srow, act_ts,
                     off, oc) = spec
                    fins.append(("key", r0, wlo, b, w, off, kid_rows,
                                 j_subj, j_kid, j_srow, act_ts, oc))
                    fin_sched.append((plan, "fin", gi))
        if rm is not None:
            for (plan, _args), (r0, b, _rwlo, _rw, kwlo, kw) \
                    in zip(rng_entries, rm.spans):
                for gi, (_g, spec) in enumerate(plan.rfin_args):
                    iv0, iv1, iv2, j_ok, j_sb, j_sknd, rsnap, oc = spec
                    fins.append(("range", iv0, iv1, iv2, j_ok, j_sb,
                                 j_sknd, rsnap, oc))
                    fin_sched.append((plan, "rfin", gi))
                for gi, (_g, spec) in enumerate(plan.kfin_args):
                    (_k, kid_rows, j_subj, j_kid, j_srow, act_ts,
                     off, oc) = spec
                    fins.append(("rkey", r0, kwlo, b, kw, off, kid_rows,
                                 j_subj, j_kid, j_srow, act_ts, oc))
                    fin_sched.append((plan, "kfin", gi))
        # stack the drains' deferred cmd transition lanes for the quorum
        # count, padded to the MEGA_LANE_TIERS ladder
        lanes, self._cmd_lanes = self._cmd_lanes, []
        quorum = None
        q_txn_np = None
        if lanes:
            q_txn = np.concatenate([t for t, _, _ in lanes])
            q_ts = np.concatenate([t for _, t, _ in lanes])
            q_code = np.concatenate([c for _, _, c in lanes])
            nlanes = q_txn.shape[0]
            t = mega_lane_tier(nlanes)
            pt = np.zeros((t, 3), np.int32)
            pt[:nlanes] = q_txn
            ps = np.full((t, 3), np.iinfo(np.int32).min, np.int32)
            ps[:nlanes] = q_ts
            pc = np.zeros(t, np.int32)
            pc[:nlanes] = q_code
            pv = np.zeros(t, bool)
            pv[:nlanes] = True
            quorum = (pt, ps, pc, pv)
            q_txn_np = q_txn
        # device message plane: stage this tick's in-flight replica traffic
        # into the mailbox emit lanes, and fold the deferred cmd twins'
        # flush debt in as repair scatters -- both ride the same single
        # fused program
        mail = None
        if self.device_messages and self._net is not None:
            mail = self._net.mailbox_flush()
        rep_blocks, rep_adopts = ((), ())
        if self.device_messages:
            rep_blocks, rep_adopts = self._collect_cmd_repairs()
        exec_tickets = self._pop_exec_tickets()
        execs = tuple((t.planes, t.out_cap) for t in exec_tickets)
        if km is not None or rm is not None or fins or quorum is not None \
                or mail is not None or rep_blocks or execs:
            (packed_out, rng_out, fin_outs, _cmd, q_out, mail_out,
             rep_outs, exec_outs) = tick(
                res0._table, key_in=key_in, rng_in=rng_in,
                fins=tuple(fins), quorum=quorum,
                quorum_size=self.quorum_size, mailbox=mail,
                cmd_repairs=rep_blocks, execs=execs)
            if mail is not None:
                self._net.mailbox_adopt(mail_out)
            for (plane, meta, spans), outs in zip(rep_adopts, rep_outs):
                plane.adopt_repair(outs, meta, spans)
            self._fulfill_exec(exec_tickets, exec_outs)
            self.megakernel_dispatches += 1
            self.protocol_launches += 1
            if km is not None or rm is not None:
                self.node_lane_dispatches += 1
                self._nodes_in_dispatches += len(lane_nodes)
            for merge in (km, rm):
                if merge is not None:
                    self._rows_used += merge.rows_used
                    self._rows_total += merge.rows_padded
            if quorum is not None:
                # q_out[2] (quorum met per lane) reads back lazily next tick
                self._pending_quorum.append((q_out[2], q_txn_np))
            # swap each merged plan's deferred calls for host-side views of
            # the fused outputs: demux is slicing of the one contiguous
            # readback -- no further device dispatches this tick
            if km is not None:
                pbuf = nl.MergedBuffer(packed_out)
                for (plan, _args), (r0, b, wlo, w) \
                        in zip(key_entries, km.spans):
                    plan.key_call = (
                        lambda v=nl.MergedView(pbuf, r0, b, wlo, w): v)
            if rm is not None:
                rbuf = nl.MergedBuffer(rng_out[0])
                kbuf = nl.MergedBuffer(rng_out[1])
                for (plan, args), (r0, b, rwlo, rw, kwlo, kw) \
                        in zip(rng_entries, rm.spans):
                    rv = (nl.MergedView(rbuf, r0, b, rwlo, rw)
                          if args["has_r"] else None)
                    kv = (nl.MergedView(kbuf, r0, b, kwlo, kw)
                          if args["has_k"] else None)
                    plan.range_call = (lambda rv=rv, kv=kv: (rv, kv))
            for (plan, lane, gi), out_i in zip(fin_sched, fin_outs):
                calls = getattr(plan, lane + "_calls")
                g, _fn = calls[gi]
                calls[gi] = (g, (lambda *_a, o=out_i: o))
        # launch every plan through the stock path; unmerged (fallback)
        # plans fire their own kernels and are ledgered loop-style
        merged_ids = ({id(p) for p, _ in key_entries}
                      | {id(p) for p, _ in rng_entries})
        for res, node, plans in staged:
            for plan in plans:
                if id(plan) not in merged_ids:
                    self.protocol_launches += (
                        (plan.key_call is not None)
                        + (plan.range_call is not None)
                        + len(plan.fin_calls) + len(plan.rfin_calls)
                        + len(plan.kfin_calls))
                res._launch(node, plan)


def run_mesh_burn(seed: int, ops: int = 500, *, nodes: int = 8,
                  rf: int = 3, num_shards: Optional[int] = None,
                  stores_per_node: int = 2, mesh_tick: bool = True,
                  megakernel: bool = False,
                  device_messages: bool = False,
                  link_matrix=None,
                  mailbox_depth: int = 64, mailbox_words: int = 384,
                  progress_interval_ms: float = 250.0,
                  key_count: int = 64, concurrency: int = 16,
                  batch_window_ms: float = 2.0,
                  device_latency_ms: float = 4.0,
                  num_buckets: int = 128,
                  pad_node_tiers=None,
                  exec_plane: bool = False,
                  exec_compact: bool = False,
                  exec_in_megakernel: bool = False,
                  exec_tick_ms: float = 2.0,
                  recovery_scan=None,
                  cmd_plane: bool = False,
                  cmd_plane_authoritative: bool = False,
                  resolver_kwargs: Optional[dict] = None,
                  collect_log: bool = False,
                  engine: Optional[ClusterTickEngine] = None,
                  sharded: bool = False, device=None, mesh=None,
                  **burn_kwargs) -> Tuple[BurnReport, ClusterTickEngine]:
    """Run one seeded burn with the whole cluster ticked by a
    ClusterTickEngine. mesh_tick=True launches every node's resolve as one
    node-lane dispatch per cluster tick; mesh_tick=False launches the same
    plans through the per-node Python loop (the bit-identical baseline);
    megakernel=True fuses the whole tick into one protocol_tick program
    (sharded=True routes the same staging through the sharded protocol
    megakernel, one fused mesh program per tick). Returns
    (report, engine) -- the report's counters already carry the engine's
    node-lane metrics."""
    from accord_tpu_torch.ops.resolver import BatchDepsResolver

    eng = engine or ClusterTickEngine(mesh_tick=mesh_tick,
                                      megakernel=megakernel,
                                      device_messages=device_messages,
                                      exec_in_megakernel=exec_in_megakernel)
    eng.quorum_size = min(rf, nodes) // 2 + 1
    rkw = dict(resolver_kwargs or {})
    rkw.setdefault("num_buckets", num_buckets)
    rkw.setdefault("pad_node_tiers", pad_node_tiers)

    if sharded:
        from accord_tpu_torch.ops.resolver import ShardedBatchDepsResolver
        from accord_tpu_torch.parallel.mesh import make_mesh
        the_mesh = mesh if mesh is not None else make_mesh()
        # the resolvers' arenas and the planes on the mesh's first device
        if device is None:
            device = the_mesh.device(0, 0)
        rkw.setdefault("device", device)

        def factory():
            return eng.adopt(ShardedBatchDepsResolver(mesh=the_mesh, **rkw))
    else:
        # device=None is the card (the resolvers and planes raise without
        # one); "cpu" runs every kernel's plain version
        rkw.setdefault("device", device)

        def factory():
            return eng.adopt(BatchDepsResolver(**rkw))

    cfg = ClusterConfig(
        num_nodes=nodes, rf=min(rf, nodes),
        num_shards=num_shards if num_shards is not None else max(4, nodes),
        stores_per_node=stores_per_node,
        deps_resolver_factory=factory,
        deps_batch_window_ms=batch_window_ms,
        device_latency_ms=device_latency_ms,
        exec_plane=exec_plane, exec_tick_ms=exec_tick_ms,
        exec_compact=exec_compact, exec_device=device,
        recovery_scan=recovery_scan,
        cmd_plane=cmd_plane, cmd_device=device,
        cmd_plane_authoritative=cmd_plane_authoritative,
        device_messages=device_messages,
        link_matrix=link_matrix,
        mailbox_depth=mailbox_depth, mailbox_words=mailbox_words,
        progress_interval_ms=progress_interval_ms)
    report = run_burn(seed, ops, nodes=nodes, rf=min(rf, nodes),
                      key_count=key_count, concurrency=concurrency,
                      config=cfg, collect_log=collect_log, **burn_kwargs)
    for k, v in eng.snapshot().items():
        report.counters[k] = v
    return report, eng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="accord_tpu cluster-on-mesh burn")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ops", type=int, default=500)
    ap.add_argument("--count", type=int, default=1)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--rf", type=int, default=3)
    ap.add_argument("--stores-per-node", type=int, default=2)
    ap.add_argument("--keys", type=int, default=64)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--range-read-ratio", type=float, default=0.0)
    ap.add_argument("--range-write-ratio", type=float, default=0.0)
    ap.add_argument("--crash-restart", action="store_true")
    ap.add_argument("--cmd-plane", action="store_true")
    ap.add_argument("--cmd-plane-authoritative", action="store_true")
    ap.add_argument("--exec-plane", action="store_true",
                    help="device execution frontier scheduler")
    ap.add_argument("--exec-compact", action="store_true",
                    help="compacted frontier readback (implies --exec-plane)")
    ap.add_argument("--exec-in-megakernel", action="store_true",
                    help="stage exec frontier blocks into the fused "
                         "protocol_tick (implies --exec-compact + "
                         "--megakernel)")
    ap.add_argument("--recovery-scan", choices=["host", "device"],
                    default=None,
                    help="progress-sweep candidate selection through the "
                         "cmd-arena scan (host twin or device query)")
    ap.add_argument("--python-loop", action="store_true",
                    help="per-node launch loop (the differential baseline)")
    ap.add_argument("--sharded", action="store_true",
                    help="run resolvers on the device mesh (with "
                         "--megakernel: one shard_map program per tick)")
    ap.add_argument("--megakernel", action="store_true",
                    help="one fused protocol_tick program per cluster tick")
    ap.add_argument("--device-messages", action="store_true",
                    help="replica traffic through the device mailbox "
                         "routing stage (implies --megakernel staging)")
    ap.add_argument("--reconcile", action="store_true",
                    help="run each seed twice; require identical logs")
    ap.add_argument("--device", default=None,
                    help="the kernels' device: the card by default, 'cpu' "
                         "for the plain versions")
    args = ap.parse_args(argv)

    ok = True
    for seed in range(args.seed, args.seed + args.count):
        kwargs = dict(
            ops=args.ops, nodes=args.nodes, rf=args.rf,
            stores_per_node=args.stores_per_node, key_count=args.keys,
            concurrency=args.concurrency,
            range_read_ratio=args.range_read_ratio,
            range_write_ratio=args.range_write_ratio,
            crash_restart=args.crash_restart,
            cmd_plane=args.cmd_plane or args.cmd_plane_authoritative,
            cmd_plane_authoritative=args.cmd_plane_authoritative,
            mesh_tick=not args.python_loop,
            sharded=args.sharded,
            megakernel=(args.megakernel or args.device_messages
                        or args.exec_in_megakernel),
            device_messages=args.device_messages,
            exec_plane=(args.exec_plane or args.exec_compact
                        or args.exec_in_megakernel),
            exec_compact=args.exec_compact or args.exec_in_megakernel,
            exec_in_megakernel=args.exec_in_megakernel,
            recovery_scan=args.recovery_scan, device=args.device)
        try:
            r, eng = run_mesh_burn(seed, collect_log=args.reconcile,
                                   **kwargs)
            if args.reconcile:
                r2, _ = run_mesh_burn(seed, collect_log=True, **kwargs)
                if r.log != r2.log:
                    print(f"seed {seed}: NON-DETERMINISTIC "
                          f"({len(r.log)} vs {len(r2.log)} entries)")
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
