#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (accord_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse   # the same phases on the CPU, small
                                       # (exercises the script; no result)

Phases, each of which fails the run (exit 1, no result line) on any error.
Each burn below is a path: every kernel's launch count is zeroed just
before it and read just after, and the kernels of that path must have
launched.
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel from accord_tpu_torch/csrc (nvcc, in parallel);
  3. key burn: a 5-node cluster commits rw-register txns (4 keys, Zipf
     0.99 over 16 hot keys) through the port's BatchDepsResolver on the
     card (K1-K4 must launch); the same seed with the resolver on the CPU
     must commit the identical history, with zero host, finalize and
     checksum fallbacks;
  4. range-mix burn, this slice's path at the JAX package's range-mix
     configuration (bench.py's bench_range_mix): 5 nodes, rf 3, 10% range
     reads, 10% range writes, durability rounds every 1000 ms (range sync
     points); card vs CPU identical history, lost 0, zero host, range and
     checksum fallbacks, the finalize and legacy-decode counts equal to
     the CPU leg's (at this seed both packages trip the same few sequence
     guards: registrations that widen a row or free range rows while a
     call is in flight, which the mutation fence does not cover), range
     subjects decoded on the device, and K4's range entry, K5 and K6
     launched;
  5. inline leg: no batch window (the JAX package's inline range-read
     differential), card vs CPU identical, the max_conflict kernel (K7)
     launched;
  6. the PreAccept batch: 10,000 in-flight writes over 1,000 keys, 4,096
     subjects through the async pipeline, every answer equal to the host
     scan; then the same with 1,024 in-flight range writes added and 20%
     range subjects (the shape at which K5 and K6 do real work);
  7. exec burn, fused: bench.py's bench_exec_plane leg (seed 31, Zipf 0.99
     over 16 hot keys, durability every 1000 ms, two stores per node, host
     deps) with the port's exec planes PRIMARY on the card (releases only
     from harvested frontiers; the host WaitingOn asserts each one): card
     vs CPU identical history, lost 0, every exec plane and coordinator
     counter equal, granular ts/flags uploads > 0 and the upload bytes
     below the whole-row baseline; exec_scatter (K8) and the fused
     frontier (K9) launched;
  8. exec burn, compacted: the same with frontier_compact harvests and the
     port's BatchDepsResolver on the card too (deps and execution both on
     the device): card vs CPU identical, zero compact fallbacks, overflows
     and every counter equal to the CPU leg's; frontier_compact launched;
  9. exec solo leg: one store per node, so each plane runs the plain
     execution_frontier; card vs CPU identical;
 10. exec frontier batch, the kernels at their largest: (a) bench.py's
     10k-in-flight compact harvest (5 planes x 2048 rows, all pending, 40
     released per plane) through frontier_compact and
     fused_execution_frontier, every released set the expected one; (b)
     one 16384-row plane with ~10,000 pending rows waiting on up to 8
     earlier rows each, signed exec_ts with ~10% undecided, ~5% awaits_all
     and half the rest applied: a 64-row exec_scatter, then
     execution_frontier and frontier_compact, equal to the plain versions;
 11. cmd burn: the key burn's cluster (5 nodes, rf 3, Zipf 0.99 over 16
     hot keys, 4-key txns: owned keys fill KPAD = 4) with the resolver AND
     the command planes on the card (every replica's PreAccept witness,
     Accept ballot checks, Commit/Apply promotions through cmd_tick, K10),
     400 ops: card vs CPU identical history, every cmd_plane_* counter
     equal, zero checksum mismatches, cmd_tick launched exactly once per
     cmd_plane dispatch;
 12. authoritative + recovery leg: bench.py's bench_recovery_storm storm
     config through run_burn (seed 17, 48 ops, 4 nodes, rf 3, 2 stores per
     node, 24 keys, concurrency 8, crash-restart; no megakernel), planes
     authoritative (cmd_tick with promote), recovery candidates by ONE
     recovery_scan query per progress sweep (K11), 5% drops and a 300 ms
     stall so the scan finds candidates: card vs CPU identical, equal to
     the host-scan run, candidates > 0, zero scan fallbacks and overflows
     (no scan answered by the host), every counter equal to the CPU leg's;
 13. repair leg: tests/test_megakernel.py's defer_batch script on a card
     plane (fresh PreAccepts; redundant re-delivery with ballot
     contention; a commit mid-batch), then collect_repair -> cmd_repair
     (K12) -> adopt_repair: the columns equal a twin plane's after a plain
     flush, and a following eval_batch answers identically;
 14. cmd batch at 10k in flight (bench.py's bench_cmd_plane streams:
     10,000 txns of 1-3 keys over 256, arena cap 16384, 512-op dispatches,
     arena-only with promote): the PreAccept -> Commit -> Apply decision
     history on the card equals the Python handlers', every row APPLIED at
     the handlers' executeAt, zero fallbacks; committed txn/s of both;
 15. recovery batch (bench_recovery_storm's scan leg): 10,240 rows, the
     last third APPLIED, stall ages from default_rng(29), stall 1000 ms;
     after one warm sweep every scan at now0 + 0/20/40/60 equals
     recovery_scan_host and a python walk, one dispatch per scan, zero
     fallbacks and overflows;
 16. megakernel sweep (bench.py's bench_megakernel sizes, seed 6: 64
     nodes x 120 ops, 256 x 50, 1024 x 24) through run_mesh_burn on the
     card in megakernel and merged modes, plus the per-node loop at 64
     nodes: a warm pass, then a timed pass whose every mode is a path.
     Histories identical across modes, the 64-node megakernel history
     equal to the CPU's, launches_per_tick 1.0 and one protocol_tick
     replay per fused dispatch, no graph captured or evicted and no
     mesh_tick fallback in the timed pass; committed txn/s, ticks, nodes
     per dispatch and host ms per tick per mode; per size, the warm
     pass's captures and the graph cache's graphs, pinned and device
     bytes after it;
 17. the key+range leg (seed 9, 40 ops, 4 nodes, 20% range reads, 10%
     range writes): fused = merged = loop on the card = the CPU, K14 in
     the graph; the cmd-plane leg (3 nodes, authoritative, 32 ops):
     card = CPU = unfused, fast-path quorum txns > 0 and equal to the
     CPU's, cmd counters (deferred spans) equal, K16 in the graph; the
     exec leg (bench.py's exec-in-megakernel config: seed 13, 40 ops, 4
     nodes, rf 3, 2 stores, 24 keys, concurrency 8, exec_compact): the
     standalone compact coordinator's history, exec blocks > 0,
     launches_per_tick 1.0;
 18. merged tick at 10k in flight: 128 (plan, store) blocks of cap 2048
     and 1,024 buckets, 30,000 live rows, 4,096 subjects in 128 plans of
     32, one key finalize each, 4,096 quorum lanes: the replay bit-equal
     to the plain protocol_tick, every plan's deps equal to the host
     scan, the 128 key finalizes ONE finalize_csr_tab launch; the replay,
     the key stage alone and with its finalizes (the finalize stage is
     the difference), K13, K2 and K16 alone, and the stages launched one
     by one, timed; then the tick's 128 key finalizes, recorded, replayed
     through K2's table entry (one launch) and through 128 per-spec
     finalize_csr calls, each set captured in one CUDA graph and replayed
     twice: both bit-equal to the plain versions, both replay times;
 19. message plane (bench.py's bench_message_plane config: seed 6, rf 5,
     concurrency 24, megakernel; 64 nodes x 60 ops, 256 x 30, 1024 x 12):
     replica payloads ride the mailbox stage (K17) of the one replay a
     tick, device_messages=True against the host network, after a warm
     pass of both: one history per size, and the 64-node one equal to the
     CPU's; launches_per_tick 1.0, zero overflow spills and verify
     fallbacks, no graph captured after the warm pass, K17 launched;
     messages per host callback, host ms per tick, the largest tick's
     replay ms;
 20. the graft entry (accord_tpu_torch/graft_entry.py, the twin of
     __graft_entry__.entry): deps_matrix -> transitive_closure(7) ->
     execution_wavefronts(7) on example_batch(n=128, k=256) on the card,
     (deps, levels) bit-equal to the plain versions on the CPU (K18-K20
     must launch);
 21. the execute-DAG kernels at a real size: K18 at BASELINE's PreAccept
     shape (4,096 subjects x 16,384 arena rows, 1,024 buckets, 10,000
     live rows of 4 keys over 1,000); K19 (13 iterations) and K20 (64
     levels) at N 8,192 on a bench_dag-style DAG, logging how many of
     K19's squarings did work (the rest return at once after a fixpoint;
     the count equal to the plain version's); K21 at bench_dag's
     100,000 nodes and 192 levels (the packed adjacency, 1.25 GB, made on
     the card from a torch.Generator seeded 5 with bench_dag's density
     rule), settled, its depth reported;
 22. the sharded deps data plane (accord_tpu_torch/parallel/mesh.py):
     make_mesh() on the machine's cards (1 x 1 on one H100) and the
     virtual 4 x 2 mesh make_mesh(devices=[card] * 8). Paths: the key
     burn (800 ops) and the range-mix burn (400 ops) with
     ShardedBatchDepsResolver on the virtual mesh, each committing the
     single-device card run's history (the key burn: finalized decodes
     > 0, no legacy decode, finalize or host fallback, shard_merge_s > 0,
     no graph captured); run_mesh_burn(sharded=True) at 64 nodes x 120
     ops (seed 6) = the unsharded merged run's history, no mesh-tick
     fallback; dryrun_multichip(8). Then sharded_deps_step on 8,192 live
     rows of the PreAccept batch's arena (K 1,024), 4 rounds = K18 ->
     K19 -> K20; each sharded entry point on
     the batches' real-size calls (the 10k PreAccept batch's K1 and K2,
     the range batch's K5; as one store and as two) bit-equal on the
     virtual mesh, the real mesh, the single-device kernel and its plain
     version, timed beside the single-device kernel; each shard wrapper
     and K22 combining step bit-equal to its plain version on its
     largest recorded call;
 24. the sharded protocol megakernel (parallel/mesh.sharded_protocol_tick,
     one CUDA graph replay a tick) on make_mesh() (1 x 1 on one H100,
     where the mailbox keeps the single-device layout) and the virtual 4 x
     2 mesh: warmup_sharded (timed; a second call captures nothing); the
     10k merged tick through both meshes bit-equal to the single-device
     replay, with the key stage alone and with its 128 finalizes against
     their plain versions; the sharded megakernel sweep (seed 6; 64 x 120,
     256 x 50) after a warm pass, each history the single-device
     megakernel's (64 nodes: and the per-node loop's), launches_per_tick
     1.0, one replay per fused dispatch, zero sharded-megakernel
     fallbacks, no graph captured or evicted (kernels.CAPTURES) and
     jit_cache_sizes() unchanged; the
     key+range leg (K14's shard tables) and the exec-in-megakernel leg
     (the exec-only flush through the mesh), each the single-device
     history; the sharded message plane (bench_message_plane's config;
     64 x 60, 256 x 30) with device messages, each history the host
     network's, zero spills and verify fallbacks, messages per host
     callback; the reference's MULTICHIP legs (bench.py:1662-1700,
     :1860-1895: 4 nodes, 40 ops, 256 buckets, cap 512, the sharded loop's
     history; 16 nodes, rf 5, concurrency 32, 50 ops, the host network's,
     >= 10 messages per host callback) with the capture gate; K23 on the
     message plane's largest mailbox block and at the 1,024-lane tier (W
     384), each against its plain version;
 23. kernels: each kernel's wrapper is called again on the card on the
     exact inputs its path (and a batch) gave it, and held bit-equal
     against its plain PyTorch version on the same inputs; kernel, plain
     and (where one exists) single-library-call times come from CUDA
     events, and each call's bound from the bytes it must move (3.35 TB/s)
     or the operations it must do (67 T 32-bit op/s). cmd_tick is replayed
     on a tier-8 dispatch of the cmd burn and a tier-512 dispatch of the
     cmd batch, with its time per op (the walk is serial). K13 replays
     the sweep's largest tick and the 10k tick, K14 the key+range leg's,
     K15 a recorded demux (lane_slice_many: a merged dispatch's windows in
     one launch), K16 the cmd leg's lanes and the 10k tick's 4,096;
     protocol_tick its graph (ms: the replay alone; call_ms: with the
     host's per-tick program build). K4 replays the key burn's, the
     batches' and the range burn's calls and the exec and cmd planes'
     lane tables (flush_lanes); K4's and K15's wrappers also report
     device_ms (100 calls captured in one CUDA graph, replayed, over 100)
     beside ms (the wrapper called in a loop between events, which reads
     the host's enqueue rate), and library_device_ms likewise; the merged
     sweep's lane_slice launches are at most its merged dispatches. K10,
     K2 (finalize_csr and its table entry finalize_csr_tab, replayed on
     the sweep's largest tick's and the 10k tick's key finalizes), K6, K9's
     compact entry and K11 also report device_ms, and a torch.profiler
     trace of one eager call: K10 and K2 one kernel, K6, K9 and K11 their
     words kernel and the one compaction kernel, no memset or copy. K18
     and K19 report device_ms (K19: 10 calls a graph) and, beside the
     bf16 matmul of one stage (library_ms), the whole function as a
     PyTorch chain (library_chain_ms, library_chain_device_ms); their
     traces show K18 one kernel and K19 `iterations` + 2 (pack, squarings,
     unpack), and at the dense batch's size each is set against the
     matmul yardstick (`vs_library`: K19 against 13 squarings). Every
     kernel must have launched on its path. The build phase holds K10's
     walking kernel to 0 bytes of stack frame and spills (ptxas -v).
     K1 (single and fused), K3, K5, K7, K8, K9's plain entry and K12 also
     report device_ms; K1 and K13 are also split at their key body
     (kernels.resolve_launcher, node_lane.key_launcher): the body alone
     bit-equal to the call, its device ms (body_device_ms; K13's
     device_ms adds its subject pass), a trace of one body launch (one
     kernel a store block, no memset or copy) and of one call (the
     subject pass's memset and K13's table copy, nothing added), and the
     parent's key body (tools/deps_block_parent.cu, built beside the
     kernels) on the same inputs, bit-equal and timed interleaved with it
     (parent_vs_new); their library_ms is the overlap stage as one bf16
     matmul of the unpacked bitmaps. The 10k tick's replay and the
     sharded 10k tick's key stage are timed beside the parent's too, and
     K5's calls with the parent's key body (the whole call, a graph).
     K5's fused entry reports device_ms too, and K14 the device ms of
     its launches (range_launcher: its tables uploaded before). K3
     (arena_scatter and its keys-only entry), K5 (range_deps_resolve,
     fused_range_deps_resolve, covered_buckets) and K14 are also set
     beside the parent's range body and K3 (tools/range_block_parent.cu,
     built beside the kernels; bit-equal, device ms interleaved:
     range_parent_vs_new), K14's range stage alone as a protocol_tick
     graph (stage_parent_vs_new) and the sharded key+range leg's range
     stage likewise; traces of one call show K3 and the covered pass one
     kernel, K5 the range kernel (its covered words in the same launch)
     and a key body a key block, K14's launches two kernels, none a
     memset or copy. K17 (mailbox_route) and K23 also report device_ms
     (their calls captured in a CUDA graph: both route in place, a
     replay rewriting the rows its lanes name).
The last four lines are the parent-vs-new line (K1 at the PreAccept
batch, K13 at the sweep's largest and the 10k tick, K5 at the range
batch, the 10k replay, the sharded 10k key stage; under "range_body"
the range body's and K3's), the card line, one JSON line of kernels,
and the result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
INT32_OPS_PER_S = 67e12          # 32-bit ops outside the tensor cores
# K18's B*A*K/32 word ANDs run on the tensor cores (mma.sync b1.and.popc),
# whose b1 rate NVIDIA's H100 data sheet does not publish: no operations
# term, so K18's bound (and a shard's) is its bytes
DEPS_MATRIX_OPS = 0
KERNELS = (
    ("deps_resolve", "accord_tpu_torch/csrc/deps_resolve.cu",
     "accord_tpu/ops/kernels.py:268"),
    ("finalize_csr", "accord_tpu_torch/csrc/finalize_csr.cu",
     "accord_tpu/ops/kernels.py:697"),
    ("finalize_csr_tab", "accord_tpu_torch/csrc/finalize_csr.cu",
     "accord_tpu/ops/kernels.py:697"),
    ("arena_scatter", "accord_tpu_torch/csrc/arena_scatter.cu",
     "accord_tpu/ops/kernels.py:822"),
    ("row_scatter", "accord_tpu_torch/csrc/row_scatter.cu",
     "accord_tpu/ops/kernels.py:242"),
    ("range_scatter", "accord_tpu_torch/csrc/row_scatter.cu",
     "accord_tpu/ops/kernels.py:852"),
    ("range_resolve", "accord_tpu_torch/csrc/range_resolve.cu",
     "accord_tpu/ops/kernels.py:415"),
    ("range_finalize", "accord_tpu_torch/csrc/range_finalize.cu",
     "accord_tpu/ops/kernels.py:766"),
    ("max_conflict", "accord_tpu_torch/csrc/max_conflict.cu",
     "accord_tpu/ops/kernels.py:65"),
    ("exec_scatter", "accord_tpu_torch/csrc/exec_scatter.cu",
     "accord_tpu/ops/kernels.py:224"),
    ("execution_frontier", "accord_tpu_torch/csrc/exec_frontier.cu",
     "accord_tpu/ops/kernels.py:143"),
    ("fused_execution_frontier", "accord_tpu_torch/csrc/exec_frontier.cu",
     "accord_tpu/ops/kernels.py:174"),
    ("frontier_compact", "accord_tpu_torch/csrc/exec_frontier.cu",
     "accord_tpu/ops/kernels.py:651"),
    ("cmd_tick", "accord_tpu_torch/csrc/cmd_tick.cu",
     "accord_tpu/ops/kernels.py:1032"),
    ("recovery_scan", "accord_tpu_torch/csrc/recovery_scan.cu",
     "accord_tpu/ops/kernels.py:682"),
    ("cmd_repair", "accord_tpu_torch/csrc/cmd_repair.cu",
     "accord_tpu/ops/kernels.py:1347"),
    ("node_deps_resolve", "accord_tpu_torch/csrc/node_resolve.cu",
     "accord_tpu/ops/node_lane.py:89"),
    ("node_range_resolve", "accord_tpu_torch/csrc/node_resolve.cu",
     "accord_tpu/ops/node_lane.py:133"),
    ("lane_slice", "accord_tpu_torch/csrc/row_scatter.cu",
     "accord_tpu/ops/node_lane.py:190"),
    ("quorum_count", "accord_tpu_torch/csrc/quorum.cu",
     "accord_tpu/ops/kernels.py:1410"),
    ("protocol_tick", "accord_tpu_torch/csrc/tick_graph.cu",
     "accord_tpu/ops/kernels.py:1434"),
    ("mailbox_route", "accord_tpu_torch/csrc/mailbox_route.cu",
     "accord_tpu/ops/mailbox.py:75"),
    ("deps_matrix", "accord_tpu_torch/csrc/dense_dag.cu",
     "accord_tpu/ops/kernels.py:36"),
    ("transitive_closure", "accord_tpu_torch/csrc/dense_dag.cu",
     "accord_tpu/ops/kernels.py:97"),
    ("execution_wavefronts", "accord_tpu_torch/csrc/dense_dag.cu",
     "accord_tpu/ops/kernels.py:113"),
    ("dag_wavefronts_packed", "accord_tpu_torch/csrc/dense_dag.cu",
     "accord_tpu/ops/kernels.py:197"),
)
# the yardstick PyTorch call behind a kernel's library_ms where it computes
# one stage of the kernel's function (timed only; never on the path)
LIBRARY_CALL = {
    "deps_resolve": "torch.matmul of the unpacked bf16 bucket bitmaps "
                    "(subjects x every block's rows): the overlap stage only",
    "node_deps_resolve": "torch.matmul of the unpacked bf16 bucket bitmaps "
                         "(subjects x every block's rows): the overlap stage "
                         "only",
    "deps_matrix": "torch.matmul of the unpacked bf16 bitmaps: the overlap "
                   "stage only",
    "transitive_closure": "torch.matmul of R in bf16: one squaring"}
# the PyTorch chain that computes a kernel's whole function (timed as
# library_chain_ms / library_chain_device_ms; never on the path)
LIBRARY_CHAIN = {
    "deps_matrix": "bf16 matmul of the unpacked bitmaps > 0.5, the witness "
                   "gather, lex-before and valid, ANDed",
    "transitive_closure": "iterations x (R in bf16, bf16 matmul, > 0.5, "
                          "OR into R)"}
DENSE_KERNELS = ("deps_matrix", "transitive_closure", "execution_wavefronts",
                 "dag_wavefronts_packed")
EXEC_KERNELS = ("exec_scatter", "execution_frontier",
                "fused_execution_frontier", "frontier_compact")
# kernel-module functions recorded on the paths, by kernel
RECORDED = {"deps_resolve": ("deps_resolve", "fused_deps_resolve"),
            "finalize_csr": ("finalize_csr",),
            "finalize_csr_tab": ("finalize_csr_tab",),
            "arena_scatter": ("arena_scatter", "arena_scatter_keys"),
            "row_scatter": ("scatter_rows", "kid_word_scatter",
                            "arena_grow", "lane_table"),
            "range_scatter": ("range_scatter",),
            "range_resolve": ("range_deps_resolve",
                              "fused_range_deps_resolve", "covered_buckets"),
            "range_finalize": ("range_finalize_csr", "segment_compact"),
            "max_conflict": ("max_conflict",),
            **{k: (k,) for k in EXEC_KERNELS},
            "cmd_tick": ("cmd_tick",), "recovery_scan": ("recovery_scan",),
            "cmd_repair": ("cmd_repair",),
            "node_deps_resolve": ("node_fused_deps_resolve",),
            "node_range_resolve": ("node_fused_range_deps_resolve",),
            "lane_slice": ("lane_slice", "lane_slice_many"),
            "quorum_count": ("quorum_count",),
            "protocol_tick": ("protocol_tick",),
            "mailbox_route": ("mailbox_route",),
            **{k: (k,) for k in DENSE_KERNELS}}
# the path whose launches each kernel's entry reports
PATH_OF = {"deps_resolve": "key_burn", "finalize_csr": "key_burn",
           "finalize_csr_tab": "mega_sweep",
           "arena_scatter": "key_burn", "row_scatter": "key_burn",
           "range_scatter": "range_burn", "range_resolve": "range_burn",
           "range_finalize": "range_burn", "max_conflict": "inline",
           "exec_scatter": "exec_burn", "execution_frontier": "exec_solo",
           "fused_execution_frontier": "exec_burn",
           "frontier_compact": "exec_compact", "cmd_tick": "cmd_burn",
           "recovery_scan": "recovery_burn", "cmd_repair": "repair",
           "node_deps_resolve": "mega_sweep", "node_range_resolve":
           "mega_range", "lane_slice": "merged_sweep",
           "quorum_count": "mega_cmd", "protocol_tick": "mega_sweep",
           "mailbox_route": "message_plane", "deps_matrix": "graft_entry",
           "transitive_closure": "graft_entry",
           "execution_wavefronts": "graft_entry",
           "dag_wavefronts_packed": "dag_100k"}


class SmokeFailure(Exception):
    pass


# numbers one phase measures and a later one reports beside its own
SUMMARY: dict = {}


class FixedCalls:
    """A Recorder's get() over calls built by a phase itself."""

    def __init__(self, **calls):
        self.calls = calls

    def get(self, name):
        return self.calls.get(name)


def log(*a) -> None:
    print(*a, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- recording the main path's kernel inputs ---------------------------------
class Recorder:
    """Wraps the named functions of the kernel module, node_lane and the
    mesh module (callers reach them through the module at call time;
    `names`: every RECORDED function by default) and keeps, per function,
    the arguments of its largest call, so the kernel phase replays exactly
    what the path gave each kernel. `cmd_tier` keeps cmd_tick's first call
    at that op tier instead. `promoted` counts cmd_tick's calls with
    promote on. Recording launches nothing itself."""

    def __init__(self, tk, cmd_tier=None, names=None):
        self.tk = tk
        self.calls = {}
        self.orig = {}
        self.cmd_tier = cmd_tier
        self.promoted = 0
        self.names = names if names is not None else tuple(
            n for ns in RECORDED.values() for n in ns)

    def __enter__(self):
        import torch
        from accord_tpu_torch.ops import node_lane
        from accord_tpu_torch.parallel import mesh as pm
        for name in self.names:
            if name == "mailbox_route":
                continue   # a graph stage: kept from protocol_tick's
            mod = next(m for m in (self.tk, node_lane, pm)
                       if hasattr(m, name))
            fn = getattr(mod, name)
            self.orig[name] = (mod, fn)

            def wrapped(*args, _fn=fn, _name=name, **kw):
                size = sum(a.numel() for a in _flat((args, kw))
                           if torch.is_tensor(a))
                best = self.calls.get(_name)
                if _name == "cmd_tick":
                    self.promoted += bool(kw.get("promote"))
                    if self.cmd_tier is not None:
                        if best is None \
                                and args[9].shape[0] == self.cmd_tier:
                            self.calls[_name] = (size, args, kw)
                        return _fn(*args, **kw)
                mail = kw.get("mailbox") if _name in (
                    "protocol_tick", "sharded_protocol_tick") else None
                if mail is not None:
                    stage = "mailbox_route" if _name == "protocol_tick" \
                        else "sharded_mailbox_route"
                    m = self.calls.get(stage)
                    if m is None or mail[2].shape[0] > m[0]:
                        self.calls[stage] = (
                            mail[2].shape[0], tuple(mail), {})
                if best is None or size > best[0]:
                    self.calls[_name] = (size, args, kw)
                return _fn(*args, **kw)

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, (mod, fn) in self.orig.items():
            setattr(mod, name, fn)

    def get(self, name):
        c = self.calls.get(name)
        return None if c is None else (c[1], c[2])


def _flat(xs):
    for x in xs:
        if isinstance(x, (tuple, list)):
            yield from _flat(x)
        elif isinstance(x, dict):
            yield from _flat(tuple(x.values()))
        else:
            yield x


def _on(x, dev):
    """numpy arrays (host lanes) as tensors on `dev`, through containers."""
    import numpy as np
    import torch
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_on(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    return x


# -- timing and comparison ---------------------------------------------------
def time_ms(fn, iters: int, cuda: bool) -> float:
    import torch
    fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the wrappers whose rows (PERF.md 1-9, 13, 16-19, 21-26, 30, 31) also give
# device time (K17's mailbox_route routes in place: a replay rewrites the
# rows its lanes name)
DEVICE_TIMED = ("scatter_rows", "kid_word_scatter", "arena_grow",
                "lane_table", "range_scatter", "lane_slice",
                "lane_slice_many", "cmd_tick", "finalize_csr",
                "finalize_csr_tab", "range_finalize_csr", "frontier_compact",
                "recovery_scan", "deps_matrix", "transitive_closure",
                "deps_resolve", "fused_deps_resolve", "range_deps_resolve",
                "fused_range_deps_resolve", "arena_scatter", "max_conflict",
                "exec_scatter", "execution_frontier", "cmd_repair",
                "arena_scatter_keys", "covered_buckets", "mailbox_route")
# the key body's wrappers (csrc/deps_block.cuh: K1, K13), each split at its
# body by a launcher (the subject pass, and K13's table upload, run first):
# the body's kernels a launch, which a trace must show with no memset or
# copy, and the memsets and copies of a whole call (the subject pass's
# memset; K13's table upload), which the body adds nothing to
BODY_A_LAUNCH = {"deps_resolve": lambda args: 1,
                 "fused_deps_resolve": lambda args: len(args[6]),
                 "node_fused_deps_resolve": lambda args: 1}
CALL_MOVES = {"deps_resolve": 1, "fused_deps_resolve": 1,
              "node_fused_deps_resolve": 2}
# the parent's key body beside the shipped one (tools/deps_block_variants):
# by label, printed on a line before the card line
PARENT_VS_NEW: dict = {}
# the parent's range body and K3 beside the shipped ones
# (tools/range_block_variants), by (label, wrapper) or stage name
RANGE_VS_PARENT: dict = {}
RANGE_PAIRED = ("arena_scatter", "arena_scatter_keys", "covered_buckets",
                "range_deps_resolve", "fused_range_deps_resolve",
                "node_fused_range_deps_resolve")
# calls captured in one graph where a call takes milliseconds (else 100)
GRAPH_CALLS = {"transitive_closure": 10, "node_fused_deps_resolve": 4}
# the kernels one eager call launches, by wrapper (a torch.profiler trace,
# which must also show no memset or copy; finalize_csr_tab: its launch,
# the table uploaded before; transitive_closure: a squaring an iteration,
# the pack and the unpack, whatever the data)
KERNELS_A_CALL = {"cmd_tick": 1, "finalize_csr": 1, "finalize_csr_tab": 1,
                  "segment_compact": 1, "range_finalize_csr": 2,
                  "frontier_compact": 2, "recovery_scan": 2,
                  "deps_matrix": 1,
                  "transitive_closure": lambda args: int(args[1]) + 2,
                  # K3 and the covered pass one launch; K5 the range side
                  # (with the covered words) and a key body a key block
                  "arena_scatter": 1, "arena_scatter_keys": 1,
                  "covered_buckets": 1, "range_deps_resolve": 2,
                  "fused_range_deps_resolve": lambda args: int(
                      bool(args[8] or args[10])) + len(args[10])}


TRACE_TRIES = 6


def _device_events(fn) -> list:
    """The names of the device activities a torch.profiler trace shows in
    one call of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def trace_call(fn, call=None, want=None) -> dict:
    """The kernels and the memsets and copies a torch.profiler trace shows
    on the card in one call of fn (after a warm call). A trace that holds
    no device activity at all says nothing of the call (the profiler
    delivered none): it is taken again, after a pause and a warm call, up
    to TRACE_TRIES times. Late in a long process the profiler also drops
    events of the port's kernels (a trace empty, or short of its first
    kernels, where the same call traces whole in a fresh process). So
    where the trace is empty, or other than `want` kernels, and `call` =
    (the name in the kernel module, args, kw, whether it is a launcher)
    is given, the trace is taken in a fresh process on the same inputs,
    and the caller's check judges that one."""
    import torch
    for attempt in range(TRACE_TRIES):
        if attempt:
            time.sleep(0.5)
        fn()
        torch.cuda.synchronize()
        names = _device_events(fn)
        if names:
            break
    moves = [n for n in names if "memset" in n.lower()
             or "memcpy" in n.lower()]
    got = {"kernels": [n.split("(")[0] for n in names if n not in moves],
           "moves": moves}
    if call is not None and (not names or (want is not None
                                           and len(got["kernels"]) != want)):
        log(f"trace: {got} in this process; taken again in a fresh one")
        got = _trace_in_child(*call)
        log(f"trace: in a fresh process: {got}")
    return got


def _trace_in_child(fn_name: str, args, kw, launcher=False) -> dict:
    """trace_call of kernels.<fn_name>(*args, **kw) (or node_lane's; with
    `launcher`, of the launch that call returns first) in a fresh
    process, the inputs
    passed through a torch.save file in the build directory."""
    import torch
    from accord_tpu_torch.ops import _ext
    root = os.path.dirname(os.path.abspath(__file__))
    _ext.BUILD.mkdir(parents=True, exist_ok=True)
    path = _ext.BUILD / f"trace_args.{os.getpid()}.pt"
    torch.save((fn_name, args, kw, launcher), path)
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke as s; "
            "from accord_tpu_torch.ops import kernels as tk; "
            "from accord_tpu_torch.ops import node_lane as nl; "
            "n, a, k, l = torch.load(sys.argv[2], weights_only=False); "
            "f = getattr(tk, n, None) or getattr(nl, n); "
            "fn = f(*a, **k)[0] if l else (lambda: f(*a, **k)); "
            "print(json.dumps(s.trace_call(fn)))")
    try:
        res = subprocess.run([sys.executable, "-c", code, root, str(path)],
                             capture_output=True, text=True, timeout=300,
                             cwd=root)
    finally:
        path.unlink(missing_ok=True)
    check(res.returncode == 0, f"{fn_name}: the trace in a fresh process "
          f"failed:\n{res.stdout[-1000:]}{res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def graph_ms(fn, n: int = 100) -> float:
    """Device ms per call of `fn`: n calls captured in one CUDA graph, the
    graph replayed between CUDA events and the time divided by n, so the
    host's enqueue is not in the window."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = time_ms(graph.replay, 5, True) / n
    del graph
    return ms


def last_graph_replay():
    """The replay of the last protocol_tick call's CUDA graph as it stands
    (its parameter block unchanged): one tick's device work alone. The
    graph cache keeps the most recently replayed graph last; the last
    call's inputs and outputs must still be alive."""
    from accord_tpu_torch.ops import tick_graph
    return next(reversed(tick_graph._GRAPHS.values())).graph.replay


def max_abs_err(a, b) -> int:
    """Largest |kernel - plain| over every output (0 means bit-equal; the
    outputs are integers and bit words)."""
    import torch
    ta = [t for t in _flat(a if isinstance(a, tuple) else (a,))]
    tb = [t for t in _flat(b if isinstance(b, tuple) else (b,))]
    check(len(ta) == len(tb), "output arity differs")
    worst = 0
    for x, y in zip(ta, tb):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"output shape/dtype differs: {x.shape} {x.dtype} vs "
              f"{y.shape} {y.dtype}")
        if x.numel():
            d = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
            worst = max(worst, int(d))
    return worst


def nbytes(*ts) -> int:
    import torch
    return sum(t.numel() * t.element_size() for t in _flat(ts)
               if torch.is_tensor(t))


# -- per-kernel work: replay, compare, time, bound ---------------------------
def body_launcher(tk, fn_name, args):
    """(launcher's name, its args): the key body's launcher (see
    BODY_A_LAUNCH) of a recorded call of fn_name."""
    if fn_name == "deps_resolve":
        of, keys, sb, sknd, bm, ts, kinds, valid, table = args
        return "resolve_launcher", (of, keys, None, sb, sknd, None,
                                    ((bm, ts, kinds, valid),), table)
    if fn_name == "fused_deps_resolve":
        return "resolve_launcher", tuple(args)
    return "key_launcher", tuple(args)


def body_report(tk, fn_name, kern, args, kw, out, want_call) -> dict:
    """The key body of one recorded call on the card: its launcher's body
    bit-equal to the call's output, its device ms alone (body_device_ms)
    and, for K13, with the subject pass (device_ms); a trace of one body
    launch (its kernels, no memset or copy) and of one whole call (the
    subject pass's memset, K13's table copy, nothing more); the parent's
    body beside it (tools/deps_block_variants: bit-equal, device ms)."""
    from accord_tpu_torch.ops import node_lane as nl
    from accord_tpu_torch.tools import deps_block_variants as dbv
    lname, largs = body_launcher(tk, fn_name, args)
    mk = getattr(tk, lname, None) or getattr(nl, lname)

    def make():
        return mk(*largs)
    launch, bout = make()
    launch()
    check(max_abs_err(bout, out) == 0,
          f"{fn_name}: the body launcher's output differs from the call's")
    extra = {"body_device_ms": graph_ms(launch)}
    if fn_name == "node_fused_deps_resolve":
        extra["device_ms"] = graph_ms(lambda: launch(True))
    n_body = BODY_A_LAUNCH[fn_name](args)
    extra["body_trace"] = trace_call(launch, (lname, largs, {}, True),
                                     n_body)
    t = extra["body_trace"]
    check(len(t["kernels"]) == n_body and not t["moves"],
          f"{fn_name}: one body launch ran {t['kernels']} and moved "
          f"{t['moves']}, not {n_body} kernel(s) and no memset or copy")
    extra["trace"] = trace_call(lambda: kern(*args, **kw),
                                (fn_name, args, kw), n_body + 1)
    t = extra["trace"]
    memsets = [m for m in t["moves"] if "memset" in m.lower()]
    check(len(t["kernels"]) == n_body + 1 and len(memsets) == 1
          and len(t["moves"]) <= want_call,
          f"{fn_name}: one call ran {t['kernels']} and moved {t['moves']}, "
          f"not the subject pass, {n_body} body kernel(s), one memset and "
          f"at most {want_call} move(s)")
    pair = dbv.body_pair(make)
    check(pair["bit_equal"], f"{fn_name}: the parent's key body answers "
          "differently")
    extra["parent_vs_new"] = pair
    return extra


def range_pairs(tk, fn_name, kern, args, kw, label) -> dict:
    """The parent's range body and K3 (tools/range_block_variants) beside
    the shipped ones on one recorded call: the whole call in a CUDA graph
    (K14: its launches, the tables up before; and its range stage alone
    as a protocol_tick graph), bit-equal, device ms of each side."""
    from accord_tpu_torch.ops import node_lane as nl
    from accord_tpu_torch.tools import range_block_variants as rbv
    out = {}
    if fn_name == "node_fused_range_deps_resolve":
        def make():
            launch, rp, kp = nl.range_launcher(*args, **kw)
            return launch, (rp, kp)
        pair = rbv.body_pair(make)
        wt = args[-1]
        stage = rbv.replay_pair(
            lambda: tk.protocol_tick(wt, rng_in=tuple(args[:-1])),
            lambda r: r[1])
        check(stage["bit_equal"], f"{fn_name}: the parent's range stage "
              "answers differently")
        stage["plain_equal"] = max_abs_err(
            tk.protocol_tick(wt, rng_in=tuple(args[:-1]))[1],
            nl.node_fused_range_deps_resolve_plain(*args, **kw)) == 0
        check(stage["plain_equal"], f"{fn_name}: the range stage's replay "
              "differs from the plain version")
        out["stage_parent_vs_new"] = stage
        RANGE_VS_PARENT[(label, fn_name + ":stage")] = stage
    else:
        pair = rbv.call_pair(lambda: kern(*args, **kw))
    check(pair["bit_equal"], f"{fn_name}: the parent's range body / K3 "
          "answers differently")
    RANGE_VS_PARENT[(label, fn_name)] = pair
    out["range_parent_vs_new"] = pair
    return out


def kernel_report(tk, name: str, rec: Recorder, cuda: bool, iters: int,
                  label: str = ""):
    """Replay each recorded call of `name`'s wrappers on the card: kernel
    vs plain (bit-equal), each timed. The call with the largest inputs is
    the kernel's headline; every call's row is kept. Three wrappers the
    path does not call on their own replay on inputs derived from a
    recorded call: arena_grow on the recorded arena_scatter's lanes,
    doubled; lane_slice on the largest window of a recorded
    lane_slice_many; arena_scatter_keys on its bitmap and CSR; covered_buckets on the recorded range query's interval CSR
    (K5 runs the same pass inside); segment_compact on the stab words of
    the recorded range_finalize_csr call (K6 runs the same passes); the
    node-lane resolves and the quorum count on a recorded protocol_tick's
    stages (inside the megakernel's graph they run by no wrapper). Host
    lanes (numpy) go to the card before the replay. protocol_tick's `ms`
    is its graph's replay alone; `call_ms` adds the host's per-tick
    program build."""
    from accord_tpu_torch.ops import mailbox as mb
    from accord_tpu_torch.ops import node_lane as nl
    dev = "cuda" if cuda else "cpu"
    plain_of = {
        "deps_resolve": tk.deps_resolve_plain,
        "fused_deps_resolve": tk.fused_deps_resolve_plain,
        "finalize_csr": tk.finalize_csr_plain,
        "finalize_csr_tab": tk.finalize_csr_tab_plain,
        "arena_scatter": tk.arena_scatter_plain,
        "arena_scatter_keys": tk.arena_scatter_keys_plain,
        "scatter_rows": tk._scatter_lane_plain,
        "kid_word_scatter": tk.kid_word_scatter_plain,
        "arena_grow": tk.arena_grow_plain,
        "range_scatter": tk.range_scatter_plain,
        "lane_table": tk.lane_table_plain,
        "range_deps_resolve": tk.range_deps_resolve_plain,
        "fused_range_deps_resolve": tk.fused_range_deps_resolve_plain,
        "covered_buckets": tk.covered_buckets_plain,
        "range_finalize_csr": tk.range_finalize_csr_plain,
        "segment_compact": tk.segment_compact_plain,
        "max_conflict": tk.max_conflict_plain,
        "exec_scatter": tk.exec_scatter_plain,
        "execution_frontier": tk.execution_frontier_plain,
        "fused_execution_frontier": tk.fused_execution_frontier_plain,
        "frontier_compact": tk.frontier_compact_plain,
        "cmd_tick": tk.cmd_tick_plain,
        "recovery_scan": tk.recovery_scan_plain,
        "cmd_repair": tk.cmd_repair_plain,
        "node_fused_deps_resolve": nl.node_fused_deps_resolve_plain,
        "node_fused_range_deps_resolve":
            nl.node_fused_range_deps_resolve_plain,
        "lane_slice": nl.lane_slice_plain,
        "lane_slice_many": nl.lane_slice_many_plain,
        "quorum_count": tk.quorum_count_plain,
        "protocol_tick": tk.protocol_tick_plain,
        "mailbox_route": mb.mailbox_route_plain,
        **{k: getattr(tk, k + "_plain") for k in DENSE_KERNELS},
    }
    calls = []
    for fn_name in RECORDED[name]:
        got = rec.get(fn_name)
        if got is None:
            got = derived_call(tk, fn_name, rec)
        if got is not None:
            calls.append((fn_name, *got))
    check(calls, f"{name}: no recorded call to replay")
    rows = []
    for fn_name, args, kw in calls:
        args, kw = _on(args, dev), _on(kw, dev)
        kern = getattr(tk, fn_name, None) or getattr(nl, fn_name, None) \
            or getattr(mb, fn_name)
        plain = plain_of[fn_name]
        if fn_name == "mailbox_route":
            # in place: each side routes into its own copy of the arena
            out = kern(*_fresh(args))
            err = max_abs_err(out, plain(*_fresh(args)))
        else:
            out = kern(*args, **kw)
            err = max_abs_err(out, plain(*args, **kw))
        ms = time_ms(lambda: kern(*args, **kw), iters, cuda)
        extra = {}
        want = KERNELS_A_CALL.get(fn_name)
        want = want(args) if callable(want) else want
        if fn_name == "finalize_csr_tab" and cuda:
            # its launch alone: the table goes up before the capture
            launch, _outs = tk.fin_tab_launcher(args[0])
            extra["device_ms"] = graph_ms(launch)
            extra["specs"] = len(args[0])
            extra["trace"] = trace_call(
                launch, ("fin_tab_launcher", (args[0],), {}, True), want)
        elif fn_name in DEVICE_TIMED and cuda:
            # the host's enqueue left out: 100 calls in one CUDA graph
            extra["device_ms"] = graph_ms(lambda: kern(*args, **kw),
                                          GRAPH_CALLS.get(fn_name, 100))
        if fn_name == "node_fused_range_deps_resolve" and cuda:
            # its tables go up from pinned memory a call, which a graph
            # must not capture: the launches alone, the tables up before
            launch, _rp, _kp = nl.range_launcher(*args, **kw)
            extra["device_ms"] = graph_ms(launch)
            # one range launch (with the covered words), one key launch
            n_k14 = int(bool(args[8] or args[10])) + int(bool(args[10]))
            extra["trace"] = trace_call(
                launch, ("range_launcher", args, kw, True), n_k14)
            t = extra["trace"]
            check(len(t["kernels"]) == n_k14 and not t["moves"],
                  f"{fn_name}: its launches ran {t['kernels']} and moved "
                  f"{t['moves']}, not {n_k14} kernel(s) and no memset or "
                  "copy")
        if fn_name in BODY_A_LAUNCH and cuda:
            extra.update(body_report(tk, fn_name, kern, args, kw, out,
                                     CALL_MOVES[fn_name]))
        if fn_name == "range_deps_resolve" and cuda:
            # K5 with the parent's key body: the whole call in a graph
            from accord_tpu_torch.tools import deps_block_variants as dbv
            pair = dbv.call_pair(lambda: kern(*args, **kw))
            check(pair["bit_equal"], f"{fn_name}: the parent's key body "
                  "answers differently")
            extra["parent_vs_new"] = pair
        if fn_name in RANGE_PAIRED and cuda:
            extra.update(range_pairs(tk, fn_name, kern, args, kw, label))
        if want is not None and cuda:
            if "trace" not in extra:
                extra["trace"] = trace_call(lambda: kern(*args, **kw),
                                            (fn_name, args, kw)
                                            if hasattr(tk, fn_name)
                                            else None, want)
            t = extra["trace"]
            check(len(t["kernels"]) == want and not t["moves"],
                  f"{fn_name}: one call launched {t['kernels']} and moved "
                  f"{t['moves']}, not {want} kernel(s) and no memset or "
                  "copy")
        if fn_name == "protocol_tick" and cuda:
            out = kern(*args, **kw)      # the last call: its graph replays
            extra["call_ms"] = ms
            ms = time_ms(last_graph_replay(), iters, cuda)
        plain_ms = time_ms(lambda: plain(*args, **kw), max(1, iters // 10),
                           cuda)
        bytes_, ops, library = bound_inputs(tk, fn_name, args, kw, out)
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        if library is not None and "device_ms" in extra:
            extra["library_device_ms"] = graph_ms(
                library, GRAPH_CALLS.get(fn_name, 100))
        chain = library_chain(tk, fn_name, args)
        if chain is not None:
            extra["library_chain_ms"] = time_ms(chain, max(1, iters // 10),
                                                cuda)
            if "device_ms" in extra:
                extra["library_chain_device_ms"] = graph_ms(
                    chain, GRAPH_CALLS.get(fn_name, 100))
        row = {"call": fn_name, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "share": bound_ms / ms if ms > 0 else None,
               "bytes": bytes_, "ops": ops,
               "library_ms": (time_ms(library, iters, cuda)
                              if library is not None else None),
               "input_mb": nbytes(args, kw) / 1e6, **extra}
        if fn_name == "cmd_tick":
            # the walk is serial: its time per op, beside the bytes bound
            row["op_tier"] = int(args[9].shape[0])
            row["ms_per_op"] = ms / row["op_tier"]
            row["promote"] = bool(kw.get("promote"))
        log(f"  {json.dumps(row)}")
        rows.append(row)
        if "parent_vs_new" in row:
            have = PARENT_VS_NEW.get((label, fn_name))
            if have is None or have["input_mb"] < row["input_mb"]:
                PARENT_VS_NEW[(label, fn_name)] = dict(
                    row["parent_vs_new"], input_mb=row["input_mb"])
    head = max(rows, key=lambda r: r["input_mb"])
    return dict(head, max_abs_err=max(r["max_abs_err"] for r in rows),
                calls=rows)


def dense_vs_library(name: str, row: dict) -> dict:
    """K18's and K19's device ms at the dense batch's size against the
    bf16 matmul yardstick in the same run: K18 against the overlap
    matmul, K19 against 13 x one squaring (its 13 iterations)."""
    times = 13 if name == "transitive_closure" else 1
    got = {"device_ms": row["device_ms"],
           "library_device_ms_x": times * row["library_device_ms"],
           "library_chain_device_ms": row["library_chain_device_ms"]}
    got["below_library"] = got["device_ms"] < got["library_device_ms_x"]
    log(f"{name}: device {got['device_ms']:.4f} ms vs {times} x the bf16 "
        f"matmul {got['library_device_ms_x']:.4f} ms (whole torch chain "
        f"{got['library_chain_device_ms']:.4f}): "
        f"{'below' if got['below_library'] else 'NOT below'}")
    return got


def _fresh(args):
    """A mailbox block with its arena and meta cloned (K17 updates them in
    place)."""
    return (args[0].clone(), args[1].clone()) + tuple(args[2:])


def derived_call(tk, fn_name, rec):
    """(args, kwargs) for a wrapper the path does not call on its own,
    from the recorded call that runs the same passes (see kernel_report),
    or None."""
    if fn_name in ("arena_grow", "arena_scatter_keys"):
        lanes = rec.get("arena_scatter")
        if lanes is not None:
            args = lanes[0]
            if fn_name == "arena_scatter_keys":
                return (args[0], args[5], args[6], args[7]), {}
            return args[:5], {"new_cap": 2 * args[0].shape[0]}
    if fn_name == "lane_slice":
        # one window of a recorded merged dispatch's demux: its largest
        got = rec.get("lane_slice_many")
        if got is not None:
            packed, spans = got[0]
            s, r0, w0, rows, words = max(spans, key=lambda w: w[3] * w[4])
            return (packed[s], r0, w0, rows, words), {}
    if fn_name == "covered_buckets":
        for src in ("range_deps_resolve", "fused_range_deps_resolve"):
            got = rec.get(src)
            if got is None:
                continue
            args = got[0]
            if src == "range_deps_resolve":
                k_bm, sb = args[11], args[3]
            else:
                karenas, sb = args[10], args[4]
                if not karenas:
                    continue
                k_bm = karenas[0][0]
            return (args[0], args[1], args[2], sb.shape[0],
                    k_bm.shape[1] * 32), {}
    if fn_name == "segment_compact":
        got = rec.get("range_finalize_csr")
        if got is not None:
            args, kw = got
            m, _ = tk.range_stab_words_plain(*args)
            return (m, kw["out_cap"]), {}
    tick = rec.get("protocol_tick")
    if fn_name == "finalize_csr_tab" and tick is not None:
        # the recorded tick's key finalizes over its key stage's result
        (wt, *_), kw = tick
        if kw.get("key_in") and any(f[0] == "key" for f in kw["fins"]):
            return (key_fin_specs(tk, wt, kw),), {}
    if tick is not None:
        (wt, *_), kw = tick
        if fn_name == "node_fused_deps_resolve" and kw.get("key_in"):
            return (*kw["key_in"], wt), {}
        if fn_name == "node_fused_range_deps_resolve" and kw.get("rng_in"):
            return (*kw["rng_in"], wt), {}
        if fn_name == "quorum_count" and kw.get("quorum") is not None:
            return (*kw["quorum"], kw["quorum_size"]), {}
    return None


def key_fin_specs(tk, wt, kw) -> list:
    """finalize_csr's arguments for each key finalize of a protocol_tick
    call: the key stage's merged result computed on wt's device (K13), a
    spec's rows of it, and its word span as finalize_csr's word_off."""
    from accord_tpu_torch.ops import node_lane as nl
    key_in = _on(kw["key_in"], wt.device)
    packed = nl.node_fused_deps_resolve(*key_in, wt)
    specs = []
    for f in kw["fins"]:
        if f[0] != "key":
            continue
        _k, r0, w0, rows, words, off, kid_rows = f[:7]
        r = nl.dyn_start(r0, packed.shape[0], rows)
        c = nl.dyn_start(w0, packed.shape[1], words)
        off = min(max(int(off), 0), words - kid_rows.shape[1])
        specs.append((packed[r:r + rows], c + off,
                      *_on(tuple(f[6:11]), wt.device), f[11]))
    return specs


def tick_bound(tk, args, kw, out):
    """protocol_tick's (bytes, operations, None), from its stages' own
    rules. Bytes: each input read once -- a tensor that several stages
    read (the witness table, a block's ts that is also a finalize's
    act_ts) once, of a kid table only the rows its slots name (K2's rule),
    of an exec plane's adjacency only its pending rows (K9's) -- and each
    output written once. The merged results that the finalizes read back
    in place are the tick's outputs, not inputs again, and no stage's
    scratch counts. Operations: the resolve stages' (K13's and K14's
    rules), 3 per slot word of a key finalize, 4 per interval x range row
    of a range finalize, 4 per pair of quorum lanes."""
    import torch
    wt = args[0]
    reads = {}

    def take(*xs, key="all"):
        for t in _flat(xs):
            if torch.is_tensor(t) and t.numel():
                reads[(t.data_ptr(), key)] = nbytes(t)

    take(wt)
    ops = 0
    if kw.get("key_in"):
        take(kw["key_in"])
        ops += bound_inputs(tk, "node_fused_deps_resolve",
                            (*kw["key_in"], wt), {}, ())[1]
    if kw.get("rng_in"):
        take(kw["rng_in"])
        ops += bound_inputs(tk, "node_fused_range_deps_resolve",
                            (*kw["rng_in"], wt), {}, ())[1]
    for f in kw.get("fins", ()):
        if f[0] == "range":
            take(f[1:-1])
            ops += 4 * f[1].numel() * f[7][0].numel()
            continue
        kid_rows, slot_subj, slot_kid, subj_row, act_ts = f[6:11]
        take(slot_subj, slot_kid, subj_row, act_ts)
        kc, w = kid_rows.shape
        for r in torch.unique(slot_kid[(slot_kid >= 0) & (slot_kid < kc)]
                              ).tolist():
            reads[(kid_rows.data_ptr(), ("kid", r))] = w * 4
        ops += 3 * slot_subj.numel() * w
    for c in kw.get("cmds", ()):
        take(c[:-1])
    if kw.get("quorum") is not None:
        take(kw["quorum"])
        ops += 4 * kw["quorum"][0].shape[0] ** 2
    for r in kw.get("cmd_repairs", ()):
        take(r)
    for planes, _cap in kw.get("execs", ()):
        for adj, *lanes in planes:
            take(lanes)
            npend = int(lanes[2].sum())
            reads[(adj.data_ptr(), "pending")] = npend * adj.shape[1] * 4
    return sum(reads.values()) + nbytes(out), ops, None


def closure_ops(tk, adj, iters: int) -> int:
    """The word ORs K19's squarings need on this data: set bits x N/32 of
    each squaring up to and including the first that changes nothing
    (every later one repeats it)."""
    import torch
    nw = (adj.shape[0] + 31) // 32
    ops, r = 0, adj
    for _ in range(int(iters)):
        ops += int(r.sum()) * nw
        nxt = tk.transitive_closure_step_plain(r)
        if torch.equal(nxt, r):
            break
        r = nxt
    return ops


def library_chain(tk, fn_name, args):
    """The PyTorch chain computing the whole function of `fn_name` on
    these inputs (LIBRARY_CHAIN), its operands prepared outside, or
    None."""
    import torch
    if fn_name == "deps_matrix":
        sw, sb, sk, aw, at, ak, av, wt = args
        s_bf = tk._unpack_bits(sw).to(torch.bfloat16)
        a_bf = tk._unpack_bits(aw).to(torch.bfloat16).T.contiguous()
        n0, n1 = wt.shape

        def chain():
            overlap = torch.matmul(s_bf, a_bf) > 0.5
            witness = wt[tk._gather_index(sk, n0)[:, None],
                         tk._gather_index(ak, n1)[None, :]] == 1
            before = tk._lex_before(at[None, :, :], sb[:, None, :])
            return overlap & witness & before & av[None, :]
        return chain
    if fn_name == "transitive_closure":
        adj, iters = args

        def chain():
            r = adj
            for _ in range(int(iters)):
                rb = r.to(torch.bfloat16)
                r = r | (torch.matmul(rb, rb) > 0.5)
            return r
        return chain
    return None


def bound_inputs(tk, fn_name, args, kw, out):
    """(bytes the function must move, 32-bit operations it must do, one
    library call computing the same function or None) for this call's
    inputs: each input read once, each output written once."""
    import torch
    if fn_name == "protocol_tick":
        return tick_bound(tk, args, kw, out)
    if fn_name == "mailbox_route":
        # every lane's small fields and its part entry read once; a landed
        # lane's words read once and written to its arena row once (+ its
        # meta); the gather-back's outputs written once
        arena, meta, src, dst, slot, keep, kind, seq, words, part = args
        lanes, w = words.shape
        landed = int(out[4].sum())
        small = nbytes(src, dst, slot, keep, kind, seq) + lanes
        return (small + 2 * landed * (w * 4 + 12) + nbytes(out[2:]), 0,
                None)
    if fn_name == "deps_matrix":
        # its word ANDs run on the tensor cores (b1 MMA), for which the
        # data sheet gives no rate: bound by bytes (DEPS_MATRIX_OPS)
        sw, aw = args[0], args[3]
        s_bf = tk._unpack_bits(sw).to(torch.bfloat16)
        a_bf = tk._unpack_bits(aw).to(torch.bfloat16).T.contiguous()
        return (nbytes(args) + nbytes(out), DEPS_MATRIX_OPS,
                lambda: torch.matmul(s_bf, a_bf))
    if fn_name == "transitive_closure":
        adj, iters = args
        rf = adj.to(torch.bfloat16)
        return (nbytes(adj) + nbytes(out), closure_ops(tk, adj, iters),
                lambda: torch.matmul(rf, rf))
    if fn_name == "execution_wavefronts":
        adj, levels = args
        return nbytes(adj) + nbytes(out), int(levels) * int(adj.sum()), None
    if fn_name == "dag_wavefronts_packed":
        adj = args[0]
        return nbytes(adj) + nbytes(out), adj.numel(), None
    if fn_name == "lane_slice":
        packed, r0, w0, rows, words = args
        from accord_tpu_torch.ops.node_lane import dyn_start
        r = dyn_start(r0, packed.shape[0], rows)
        w = dyn_start(w0, packed.shape[1], words)
        return (2 * rows * words * packed.element_size(), 0,
                lambda: packed[r:r + rows, w:w + words].clone())
    if fn_name == "quorum_count":
        t = args[0].shape[0]
        return nbytes(args) + nbytes(out), 4 * t * t, None
    if fn_name in ("deps_resolve", "fused_deps_resolve",
                   "node_fused_deps_resolve"):
        if fn_name == "deps_resolve":
            subj_of, subj_keys, sb, sknd, bm, ts, kinds, valid, table = args
            blocks, mines = [(bm, ts, kinds, valid)], [None]
        else:
            subj_of, subj_keys, store, sb, sknd, slots, blocks, table = args
            mines = [store == slots[s] for s in range(len(blocks))]
        # the AND work this data needs: for each pair whose cheap masks
        # pass, an AND and an OR a nonzero word of the subject's (the other
        # words cannot meet a row)
        nk = table.shape[0]
        nw = blocks[0][0].shape[1]
        words = tk._subject_words(subj_of, subj_keys, sb.shape[0], nw * 32)
        nzw = (words != 0).sum(1).to(torch.int64)
        ops = 0
        for (bm, ts, kinds, valid), mine in zip(blocks, mines):
            w = table[tk._gather_index(sknd, nk)[:, None],
                      tk._gather_index(kinds, nk)[None, :]] == 1
            m = w & tk._lex_before(ts[None], sb[:, None]) & valid[None]
            if mine is not None:
                m &= mine[:, None]
            ops += 2 * int((m.sum(1) * nzw).sum())
        bytes_ = nbytes(args) + nbytes(out)
        # the yardstick: the overlap stage as one bf16 matmul of the
        # unpacked bitmaps, subjects x every block's rows
        s_bf = tk._unpack_bits(words).to(torch.bfloat16)
        a_bf = torch.cat([tk._unpack_bits(blk[0]) for blk in blocks]) \
            .to(torch.bfloat16).T.contiguous()
        return bytes_, ops, lambda: torch.matmul(s_bf, a_bf)
    if fn_name == "finalize_csr_tab":
        b_ = o_ = 0
        for sp, o in zip(args[0], out):
            bb, oo, _ = bound_inputs(tk, "finalize_csr", sp[:7],
                                     {"out_cap": sp[7]}, o)
            b_, o_ = b_ + bb, o_ + oo
        return b_, o_, None
    if fn_name == "finalize_csr":
        packed, word_off, kid_rows, slot_subj, slot_kid, subj_row, act_ts = \
            args
        kc, w = kid_rows.shape
        kids = torch.unique(slot_kid[(slot_kid >= 0) & (slot_kid < kc)])
        b = packed.shape[0]
        bytes_ = (b * w * 4 + kids.numel() * w * 4
                  + nbytes(slot_subj, slot_kid, subj_row, act_ts)
                  + nbytes(out))
        ops = 3 * slot_subj.numel() * w
        return bytes_, ops, None
    if fn_name in ("range_deps_resolve", "fused_range_deps_resolve",
                   "node_fused_range_deps_resolve"):
        if fn_name == "range_deps_resolve":
            (iv_of, iv_s, iv_e, sb, sknd, srng, r_start, r_end, r_ts,
             r_kinds, r_valid, k_bm, k_ts, k_kinds, k_valid, table) = args
            rblocks = [(r_start, r_end, r_ts, r_kinds, r_valid)]
            kblocks = [(k_bm, k_ts, k_kinds, k_valid)]
            kmines = [srng]
        else:
            (iv_of, iv_s, iv_e, store, sb, sknd, srng, r_slots, rblocks,
             k_slots, kblocks, table) = args
            kmines = [(store == k_slots[s]) & srng
                      for s in range(len(kblocks))]
        nv = iv_of.shape[0]
        ops = 4 * nv * sum(r[0].shape[0] for r in rblocks)
        nk = table.shape[0]
        pairs = 0
        for (bm, ts, kinds, valid), mine in zip(kblocks, kmines):
            w = table[tk._gather_index(sknd, nk)[:, None],
                      tk._gather_index(kinds, nk)[None, :]] == 1
            m = w & tk._lex_before(ts[None], sb[:, None]) & valid[None] \
                & mine[:, None]
            pairs += int(m.sum())
        if kblocks:
            ops += 2 * pairs * kblocks[0][0].shape[1]
        return nbytes(args) + nbytes(out), ops, None
    if fn_name == "covered_buckets":
        iv_of, iv_s, iv_e, b, k = args
        return (nbytes(iv_of, iv_s, iv_e) + nbytes(out),
                2 * iv_of.shape[0] * k, None)
    if fn_name == "range_finalize_csr":
        iv_of, iv_s, iv_e, ent_ok = args[:4]
        r_start = args[6]
        nv, rcap = iv_of.shape[0], r_start.shape[0]
        # the stab matrix read once (as bits), the lanes, the outputs
        bytes_ = nv * rcap // 8 + nbytes(args) + nbytes(out)
        return bytes_, 4 * nv * rcap, None
    if fn_name == "segment_compact":
        return nbytes(args) + nbytes(out), 0, None
    if fn_name == "max_conflict":
        subj, bm, ex, valid = args
        # the word ANDs the data needs (a row stops at its first meeting
        # word) over valid rows, then 3 lane compares per overlapping row
        meet = (subj[:, None, :] & bm[None, :, :]) != 0
        first = torch.where(meet.any(-1),
                            meet.to(torch.int8).argmax(-1) + 1,
                            torch.full(meet.shape[:2], bm.shape[1],
                                       device=bm.device))
        ands = int((first * valid[None, :]).sum())
        overlaps = int((meet.any(-1) & valid[None, :]).sum())
        return nbytes(args) + nbytes(out), ands + 3 * overlaps, None
    if fn_name in ("execution_frontier", "fused_execution_frontier",
                   "frontier_compact"):
        planes = ((args,) if fn_name == "execution_frontier" else args[0])
        # the pending rows' adjacency read once (the kernel skips the
        # others), 15 bytes of lanes per row, the outputs written; one
        # and-not per pending row word
        bytes_, ops = nbytes(out), 0
        for adj, _ts, _app, pending, _aw in planes:
            cap, w = adj.shape
            npend = int(pending.sum())
            bytes_ += npend * w * 4 + 15 * cap
            ops += npend * w
        return bytes_, ops, None
    if fn_name == "cmd_repair":
        # the eight drop-mode scatters as eight index_copy calls on the
        # in-range indices (filtered here, outside the timed call)
        cols, (ridx, *rvals), (kidx, km_v, kv_v) = \
            args[:8], args[8:15], args[15:]
        rok = tk._norm_index(ridx, cols[0].shape[0])[1]
        kok = tk._norm_index(kidx, cols[6].shape[0])[1]
        r64, k64 = ridx[rok].to(torch.int64), kidx[kok].to(torch.int64)
        vals = [v[rok] for v in rvals] + [km_v[kok], kv_v[kok]]
        idxs = [r64] * 6 + [k64] * 2

        def lib():
            return [torch.index_copy(c, 0, i, v)
                    for c, i, v in zip(cols, idxs, vals)]
        return nbytes(args) + nbytes(out), 0, lib
    if fn_name == "scatter_rows":
        dst, idx, rows = args
        lib = None
        ni = tk._norm_index(idx, dst.shape[0])[1]
        if bool(ni.all()):
            idx64 = idx.to(torch.int64)
            lib = (lambda: torch.index_copy(dst, 0, idx64, rows))
        return nbytes(args) + nbytes(out), 0, lib
    if fn_name in ("lane_table", "range_scatter", "exec_scatter",
                   "arena_grow"):
        # per lane one call, summed: index_copy on the in-range indices
        # (normalised and filtered here, outside the timed call), torch.cat
        # with its pad for a grown lane
        if fn_name == "lane_table":
            lanes = [tk._lane_spec(lane) for lane in args[0]]
        elif fn_name == "arena_grow":
            new_cap = kw["new_cap"] if "new_cap" in kw else args[5]
            lanes = [(a, None, None, new_cap, f)
                     for a, f in zip(args[:5], tk._GROW_FILL)]
        else:
            idx = args[5]
            lanes = [(a, idx, r, a.shape[0], 0)
                     for a, r in zip(args[:5], args[6:11])]
        calls = []
        for src, idx, rows, n_rows, fill in lanes:
            if idx is None:
                pad = torch.full((n_rows - src.shape[0], *src.shape[1:]),
                                 fill, dtype=src.dtype, device=src.device)
                calls.append(lambda src=src, pad=pad: torch.cat([src, pad]))
                continue
            i, ok = tk._norm_index(idx, src.shape[0])
            calls.append(lambda src=src, i=i[ok], r=rows[ok]:
                         torch.index_copy(src, 0, i, r))
        return (nbytes(args) + nbytes(kw.values()) + nbytes(out), 0,
                lambda: [c() for c in calls])
    if fn_name == "kid_word_scatter":
        # out of place index_put on the in-range coordinates
        kid_rows, kid_idx, word_idx, words = args
        kc, w = kid_rows.shape
        a, a_ok = tk._norm_index(kid_idx, kc)
        b, b_ok = tk._norm_index(word_idx, w)
        ok = a_ok & b_ok
        coords, vals = (a[ok], b[ok]), words[ok]
        return (nbytes(args) + nbytes(out), 0,
                lambda: torch.index_put(kid_rows, coords, vals))
    if fn_name == "lane_slice_many":
        # each window read once and written once; a clone of each window
        packed, spans = args
        from accord_tpu_torch.ops.node_lane import dyn_start
        views = []
        for src, r0, w0, rows, words in spans:
            t = packed[src]
            r = dyn_start(r0, t.shape[0], rows)
            c = dyn_start(w0, t.shape[1], words)
            views.append(t[r:r + rows, c:c + words])
        return (2 * sum(v.numel() * v.element_size() for v in views), 0,
                lambda: [v.clone() for v in views])
    return nbytes(args) + nbytes(kw.values()) + nbytes(out), 0, None


# -- phases ------------------------------------------------------------------
def card_line(cuda: bool) -> str:
    if not cuda:
        return "cpu rehearsal"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def build_phase() -> float:
    from accord_tpu_torch.ops import _ext
    t0 = time.perf_counter()
    for stem in sorted(_ext.build()):
        _ext.lib(stem)
    for stem, text in sorted(_ext.ptxas_log.items()):
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in
                     re.findall(r"(\d+) bytes spill stores", text))
        log(f"  ptxas {stem}: {len(regs)} kernels, at most "
            f"{max(regs, default=0)} registers, {spills} bytes spilled")
        if stem == "cmd_tick":
            # K10's walking kernel: no stack frame and no spills
            lines = text.splitlines()
            for i, line in enumerate(lines):
                if "Function properties for" in line \
                        and "cmd_tick_kernel" in line:
                    props = lines[i + 1].strip()
                    log(f"    {line.split()[-1]}: {props}")
                    frame = [int(x) for x in re.findall(r"(\d+) bytes",
                                                        props)]
                    check(len(frame) == 3 and frame == [0, 0, 0],
                          f"K10's walking kernel: {props}")
    return time.perf_counter() - t0


def _resolver(device: str, mesh=None, **kw):
    """The port's BatchDepsResolver on `device`, or with `mesh` its
    ShardedBatchDepsResolver (on the mesh's first device)."""
    from accord_tpu_torch.ops.resolver import (BatchDepsResolver,
                                               ShardedBatchDepsResolver)
    if mesh is not None:
        return ShardedBatchDepsResolver(mesh=mesh, **kw)
    return BatchDepsResolver(device=device, **kw)


def burn(device: str, ops: int, resolvers: list, seed: int = 9, mesh=None,
         **extra):
    """The key burn; `extra` adds ClusterConfig options (the cmd burn's
    command planes); `mesh` shards the resolvers over it."""
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    def factory():
        r = _resolver(device, mesh, num_buckets=1024, initial_cap=2048,
                      max_dispatch=256)
        resolvers.append(r)
        return r

    cfg = ClusterConfig(num_nodes=5, rf=3, deps_resolver_factory=factory,
                        deps_batch_window_ms=16.0, device_latency_ms=80.0,
                        timeout_ms=8000.0, preaccept_timeout_ms=8000.0,
                        progress_stall_ms=5000.0, **extra)
    t0 = time.perf_counter()
    rep = run_burn(seed, ops=ops, key_count=16, zipf_theta=0.99,
                   max_keys_per_txn=4, concurrency=1024, write_ratio=0.7,
                   config=cfg, collect_log=True)
    return rep, time.perf_counter() - t0


def range_mix_burn(device: str, ops: int, resolvers: list, seed: int = 21,
                   mesh=None):
    """bench.py's bench_range_mix leg, unchanged: 5 nodes, rf 3, two
    stores per node, Zipf 0.99 over 16 hot keys, 10% range reads and 10%
    range writes, durability rounds every 1000 ms; `mesh` shards the
    resolvers over it."""
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    def factory():
        r = _resolver(device, mesh, num_buckets=1024, initial_cap=2048,
                      max_dispatch=256)
        resolvers.append(r)
        return r

    cfg = ClusterConfig(num_nodes=5, rf=3, deps_resolver_factory=factory,
                        deps_batch_window_ms=2.0, device_latency_ms=8.0,
                        device_poll_ms=1.0, durability=True,
                        durability_interval_ms=1000.0, timeout_ms=8000.0,
                        preaccept_timeout_ms=8000.0,
                        progress_stall_ms=5000.0)
    t0 = time.perf_counter()
    rep = run_burn(seed, ops=ops, key_count=16, zipf_theta=0.99,
                   write_ratio=0.6, range_read_ratio=0.1,
                   range_write_ratio=0.1, collect_log=True, config=cfg)
    return rep, time.perf_counter() - t0


def inline_burn(device: str, resolvers: list):
    """tests/test_ranges.py's inline range-read differential: no batch
    window, so deps resolve synchronously and max_conflict runs on the
    device."""
    from accord_tpu_torch.ops.resolver import BatchDepsResolver
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    def factory():
        r = BatchDepsResolver(num_buckets=128, device=device)
        resolvers.append(r)
        return r

    t0 = time.perf_counter()
    rep = run_burn(11, ops=80, range_read_ratio=0.25, collect_log=True,
                   config=ClusterConfig(deps_resolver_factory=factory,
                                        deps_batch_window_ms=None))
    return rep, time.perf_counter() - t0


def exec_burn(device: str, ops: int, stores: int = 2, compact: bool = False,
              resolvers=None):
    """bench.py's bench_exec_plane leg, unchanged: seed 31, Zipf 0.99 over
    16 hot keys, durability rounds every 1000 ms, the exec planes primary
    on `device` (two stores per node: the ExecCoordinator fuses their
    frontiers), host deps. `compact` harvests through frontier_compact;
    `resolvers` (a list) puts the port's BatchDepsResolver on the same
    device."""
    from accord_tpu_torch.ops.resolver import BatchDepsResolver
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    cfg = dict(exec_plane=True, exec_device=device, exec_compact=compact,
               stores_per_node=stores, durability=True,
               durability_interval_ms=1000.0)
    if resolvers is not None:
        def factory():
            r = BatchDepsResolver(num_buckets=1024, initial_cap=2048,
                                  max_dispatch=256, device=device)
            resolvers.append(r)
            return r
        cfg.update(deps_resolver_factory=factory, deps_batch_window_ms=2.0)
    t0 = time.perf_counter()
    rep = run_burn(31, ops=ops, key_count=16, zipf_theta=0.99,
                   collect_log=True, config=ClusterConfig(**cfg))
    return rep, time.perf_counter() - t0


def cmd_counters(rep) -> dict:
    """Every command-plane and recovery-scan counter of a burn, summed over
    planes (the wall-clock timers left out)."""
    return {k: v for k, v in rep.counters.items()
            if k.startswith(("cmd_", "recovery_scan_"))
            and not k.endswith("_s")}


def recovery_burn(device: str, scan: str):
    """bench.py's bench_recovery_storm storm config through run_burn, no
    megakernel: seed 17, 48 ops, 4 nodes, rf 3, two stores per node, 24
    keys, concurrency 8, crash-restart, the command planes authoritative
    on `device`; 5% message drops and a 300 ms progress stall, so the
    recovery scan (`scan`: "host" or "device") returns candidates."""
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    cfg = ClusterConfig(num_nodes=4, rf=3, stores_per_node=2,
                        cmd_plane=True, cmd_device=device,
                        cmd_plane_authoritative=True, recovery_scan=scan,
                        progress_stall_ms=300.0)
    t0 = time.perf_counter()
    rep = run_burn(17, ops=48, key_count=24, concurrency=8,
                   crash_restart=True, chaos_drop=0.05, collect_log=True,
                   config=cfg)
    return rep, time.perf_counter() - t0


def _one_store(device=None):
    """A one-node, one-store cluster (no progress engine); with `device`,
    its store carries a command plane there."""
    from accord_tpu_torch.sim.cluster import Cluster, ClusterConfig
    extra = {} if device is None else dict(cmd_plane=True, cmd_device=device)
    cluster = Cluster(1, ClusterConfig(num_nodes=1, rf=1, num_shards=1,
                                       stores_per_node=1, progress=False,
                                       **extra))
    node = cluster.nodes[1]
    return cluster, node, node.command_stores.stores[0]


def _write_txn(keys, value):
    from accord_tpu_torch.primitives.keyspace import Keys
    from accord_tpu_torch.primitives.timestamp import TxnKind
    from accord_tpu_torch.primitives.txn import Txn
    from accord_tpu_torch.sim.list_store import (ListQuery, ListRead,
                                                 ListUpdate)
    k = Keys(sorted(keys))
    return Txn(TxnKind.WRITE, k, read=ListRead(k),
               update=ListUpdate(k, value), query=ListQuery())


def _twin_spans(device: str, defer: bool, after=None):
    """tests/test_megakernel.py's defer_batch script on a plane on
    `device`: fresh PreAccepts; redundant re-delivery with ballot
    contention; a commit mid-batch. With `after`, the device columns are
    built first and `after(plane)` runs after each of the three spans.
    -> (results, plane)."""
    from accord_tpu_torch.ops.cmd_plane import CmdOp
    from accord_tpu_torch.primitives.deps import Deps
    from accord_tpu_torch.primitives.timestamp import Ballot
    _cluster, node, store = _one_store(device)
    plane = store.cmd_plane
    txns = []
    for i in range(6):
        txn = _write_txn([1 + (i % 4), 5], i + 1)
        tid = node.next_txn_id(txn.kind, txn.domain)
        txns.append((tid, txn, node.compute_route(txn)))

    def part(t):
        return t.slice(store.ranges, include_query=False)

    if after is not None:
        plane._flush()    # the device columns live before the first span
    ev = ((lambda b: plane.defer_batch(b, sink=lambda *_: None)) if defer
          else plane.eval_batch)
    out = []
    for batch in (
            [CmdOp.preaccept(t, part(x), r) for t, x, r in txns[:4]],
            [CmdOp.preaccept(txns[0][0], part(txns[0][1]), txns[0][2]),
             CmdOp.preaccept(txns[1][0], part(txns[1][1]), txns[1][2],
                             Ballot(1, 5, 0, 1)),
             CmdOp.preaccept(txns[4][0], part(txns[4][1]), txns[4][2])],
            None):
        if batch is None:
            ea = store.command_if_present(txns[2][0]).execute_at
            batch = [
                CmdOp.preaccept(txns[5][0], part(txns[5][1]), txns[5][2]),
                CmdOp.commit(txns[2][0], txns[2][2], part(txns[2][1]), ea,
                             Deps.NONE),
                CmdOp.preaccept(txns[3][0], part(txns[3][1]), txns[3][2],
                                Ballot(1, 2, 0, 1))]
        out.append([(r.outcome, r.status, r.execute_at) for r in ev(batch)])
        if after is not None:
            after(plane)
    return out, plane


def repair_leg(device: str) -> dict:
    """The defer_batch script twice on `device`; after each span one plane
    retires its flush debt through collect_repair -> kernels.cmd_repair
    -> adopt_repair, the twin through a plain _flush(): equal columns
    after every span, and a following eval_batch answers identically on
    both. The answers equal eval_batch's on a third plane."""
    import torch
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.ops.cmd_plane import CmdOp
    repaired, flushed, sizes = [], [], []

    def snapshot(plane):
        return {k: v.cpu() for k, v in plane._device.items()}

    def repair(plane):
        got = plane.collect_repair()
        check(got not in (None, "clean"),
              f"repair leg: nothing to repair ({got})")
        block, meta = got
        plane.adopt_repair(tk.cmd_repair(*block), meta, spans=1)
        check(plane.collect_repair() == "clean",
              "repair leg: rows still dirty after adopt_repair")
        sizes.append((len(meta[0]), len(meta[1])))
        repaired.append(snapshot(plane))

    def flush(plane):
        plane._flush()
        flushed.append(snapshot(plane))

    out_r, plane_r = _twin_spans(device, defer=True, after=repair)
    out_t, plane_t = _twin_spans(device, defer=True, after=flush)
    out_e, _plane_e = _twin_spans(device, defer=False)
    check(out_r == out_t == out_e, "repair leg: defer_batch answered "
          "differently from eval_batch")
    for span, (a, b) in enumerate(zip(repaired, flushed)):
        for name in a:
            check(torch.equal(a[name], b[name]),
                  f"repair leg: column {name} after span {span} differs "
                  "from the flushed twin's")
    check(any(k for _r, k in sizes), "repair leg: no kid was repaired")

    def follow(plane):
        store = plane.store
        node = store.node
        txn = _write_txn([1, 5], 99)
        tid = node.next_txn_id(txn.kind, txn.domain)
        part = txn.slice(store.ranges, include_query=False)
        res = plane.eval_batch([CmdOp.preaccept(tid, part,
                                                node.compute_route(txn))])
        return [(r.outcome, r.status, r.execute_at) for r in res]

    check(follow(plane_r) == follow(plane_t),
          "repair leg: the following eval_batch answered differently")
    return {"repairs": sizes, "deferred_spans": int(plane_r.deferred_spans),
            "retired": int(plane_r.defer_retired),
            "dispatches": int(plane_r.dispatches)}


def _cmd_stream(node, store, n: int, seed: int):
    """n write txns of 1-3 keys over 256 (bench.py's streams), ids minted
    up front: (txn id, route, the store's slice)."""
    import random
    rng = random.Random(seed)
    out = []
    for v in range(n):
        txn = _write_txn(rng.sample(range(1, 257), rng.randint(1, 3)), v)
        tid = node.next_txn_id(txn.kind, txn.domain)
        out.append((tid, node.compute_route(txn),
                    txn.slice(store.ranges, include_query=False)))
    return out


def cmd_batch(device: str, n: int) -> dict:
    """bench.py's bench_cmd_plane at n in flight: the Python handlers (the
    store entry points) vs an arena-only plane on `device` (cmd_tick with
    promote, 512-op dispatches, arena cap 16384): PreAccept -> Commit ->
    Apply decision histories equal, every row APPLIED at the handlers'
    final executeAt, zero fallbacks."""
    import torch
    from accord_tpu_torch.ops import cmd_plane as cp
    from accord_tpu_torch.ops.cmd_plane import CmdOp, CmdPlane
    from accord_tpu_torch.ops.kernels import CMD_ST_APPLIED
    from accord_tpu_torch.primitives.deps import Deps
    chunk, arena_cap = 512, 16_384
    _hc, hnode, hstore = _one_store()
    htxns = _cmd_stream(hnode, hstore, n, 11)
    hist_host, eas = [], {}
    t0 = time.perf_counter()
    for tid, route, part in htxns:
        got = {}
        hstore.submit_preaccept(tid, part, route) \
            .on_success(lambda v, g=got: g.update(v=v))
        ea = hstore.command(tid).execute_at
        eas[tid] = ea
        hist_host.append(("pa", got["v"][0], ea))
    for tid, route, part in htxns:
        out = hstore.commit_op(tid, route, part, eas[tid], Deps.NONE)
        hist_host.append(("cm", out, hstore.command(tid).execute_at))
    host_committed_s = time.perf_counter() - t0
    for tid, route, part in htxns:
        out = hstore.apply_op(tid, route, part, eas[tid], Deps.NONE, None,
                              None)
        hist_host.append(("ap", out, hstore.command(tid).execute_at))
    host_final = {tid: hstore.command(tid).execute_at for tid, *_ in htxns}

    _dc, dnode, dstore = _one_store()
    dtxns = _cmd_stream(dnode, dstore, n, 11)
    check([t[0] for t in dtxns] == [t[0] for t in htxns],
          "cmd batch: the legs minted different txn ids")
    plane = CmdPlane(dstore, initial_cap=arena_cap, key_cap=1024, kpad=4,
                     apply_to_store=False, device=device)
    hist_dev, deas = [], {}
    span_s = {}

    def phase(tag, mk_op):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, n, chunk):
            span = dtxns[i:i + chunk]
            res = plane.eval_batch([mk_op(*t) for t in span])
            for (tid, *_), r in zip(span, res):
                if tag == "pa":
                    deas[tid] = r.execute_at
                hist_dev.append((tag, r.outcome, r.execute_at))
        span_s[tag] = time.perf_counter() - t0

    phase("pa", lambda tid, route, part: CmdOp.preaccept(tid, part, route))
    phase("cm", lambda tid, route, part: CmdOp.commit(tid, route, part,
                                                      deas[tid], Deps.NONE))
    phase("ap", lambda tid, route, part: CmdOp.apply(tid, route, part,
                                                     deas[tid], Deps.NONE))
    check(int(plane.fallbacks) == 0,
          f"cmd batch: {int(plane.fallbacks)} ops fell back to the host")
    if hist_dev != hist_host:
        i = next(i for i, (a, b) in enumerate(zip(hist_host, hist_dev))
                 if a != b)
        raise SmokeFailure(f"cmd batch: decision histories diverge at op "
                           f"{i}: host {hist_host[i]} card {hist_dev[i]}")
    for tid, row in plane.row_of.items():
        check(int(plane.status_h[row]) == CMD_ST_APPLIED,
              f"cmd batch: {tid} did not reach APPLIED in the arena")
        check(cp._dec(*(int(x) for x in plane.ea_h[row]))
              == host_final[tid],
              f"cmd batch: final executeAt differs for {tid}")
    dev_committed_s = span_s["pa"] + span_s["cm"]
    return {"inflight": n, "chunk": chunk, "arena_cap": arena_cap,
            "dispatches": int(plane.dispatches),
            "fallbacks": int(plane.fallbacks),
            "checksum_mismatches": int(plane.checksum_mismatches),
            "handlers_committed_txn_per_s": n / host_committed_s,
            "device_committed_txn_per_s": n / dev_committed_s,
            "device_phase_s": span_s}


def recovery_batch(device: str, n: int) -> dict:
    """bench_recovery_storm's scan leg: n rows parked in one arena-only
    plane on `device` through real PreAccept/Commit/Apply dispatches (the
    last third driven to APPLIED: the scan must skip them), stall ages
    from default_rng(29), stall 1000 ms; one warm sweep, then every scan
    at now0 + 0/20/40/60 equal to recovery_scan_host and to a python walk,
    one dispatch per scan, zero fallbacks and overflows."""
    import numpy as np
    from accord_tpu_torch.ops.cmd_plane import CmdOp, CmdPlane
    from accord_tpu_torch.ops.kernels import (CMD_ST_APPLIED,
                                              CMD_ST_PRE_ACCEPTED)
    from accord_tpu_torch.primitives.deps import Deps
    chunk, arena_cap, stall_ms, ks = 512, 16_384, 1_000, (0, 20, 40, 60)
    _c, node, store = _one_store()
    txns = _cmd_stream(node, store, n, 7)
    plane = CmdPlane(store, initial_cap=arena_cap, key_cap=1024, kpad=4,
                     apply_to_store=False, device=device)
    eas = {}
    for i in range(0, n, chunk):
        span = txns[i:i + chunk]
        res = plane.eval_batch([CmdOp.preaccept(t, p, r)
                                for t, r, p in span])
        for (tid, *_), r in zip(span, res):
            eas[tid] = r.execute_at
    tail = txns[n - n // 3:]
    for i in range(0, len(tail), chunk):
        span = tail[i:i + chunk]
        plane.eval_batch([CmdOp.commit(t, r, p, eas[t], Deps.NONE)
                          for t, r, p in span])
        plane.eval_batch([CmdOp.apply(t, r, p, eas[t], Deps.NONE)
                          for t, r, p in span])
    arng = np.random.default_rng(29)
    now0 = int(node.now_millis()) + 100_000
    plane.touched_h[:plane.n_rows] = \
        now0 - arng.integers(0, 1_100, plane.n_rows, dtype=np.int32)
    plane._touched_stale = True

    def py_walk(now):
        out = []
        for tid, row in plane.row_of.items():
            st = int(plane.status_h[row])
            if CMD_ST_PRE_ACCEPTED <= st < CMD_ST_APPLIED \
                    and now - int(plane.touched_h[row]) >= stall_ms:
                out.append(tid)
        return out

    for k in ks:
        plane.recovery_scan_device(now0 + k, stall_ms)
    warm = {"fallbacks": int(plane.recovery_scan_fallbacks),
            "overflows": int(plane.recovery_scan_overflows)}
    d0 = int(plane.recovery_scan_dispatches)
    sizes, wall = [], {"device": 0.0, "host": 0.0, "walk": 0.0}
    for k in ks:
        t0 = time.perf_counter()
        dev = plane.recovery_scan_device(now0 + k, stall_ms)
        t1 = time.perf_counter()
        host = plane.recovery_scan_host(now0 + k, stall_ms)
        t2 = time.perf_counter()
        walk = py_walk(now0 + k)
        t3 = time.perf_counter()
        wall["device"] += t1 - t0
        wall["host"] += t2 - t1
        wall["walk"] += t3 - t2
        check(dev == host == walk,
              f"recovery batch: scan at now0+{k} differs from the host's")
        sizes.append(len(dev))
    check(int(plane.recovery_scan_dispatches) - d0 == len(ks),
          "recovery batch: not one dispatch per scan")
    check(int(plane.recovery_scan_fallbacks) == 0
          and int(plane.recovery_scan_overflows) == 0,
          "recovery batch: scan fallbacks or overflows")
    check(min(sizes) > 0, "recovery batch: vacuous (no candidates)")
    live = int(((plane.status_h >= CMD_ST_PRE_ACCEPTED)
                & (plane.status_h < CMD_ST_APPLIED)).sum())
    return {"rows": int(plane.n_rows), "live": live, "candidates": sizes,
            "warm_sweep": warm,
            "ms_per_scan": {k: v * 1e3 / len(ks) for k, v in wall.items()},
            "scan_dispatches": int(plane.recovery_scan_dispatches)}


def exec_counters(rep) -> dict:
    """Every exec plane and coordinator counter of a burn, summed over
    planes and coordinators (the wall-clock harvest stall left out)."""
    return {k: v for k, v in rep.counters.items()
            if k.startswith(("exec.", "exec_coord."))
            and not k.endswith("harvest_stall_s")}


def frontier_batch(device: str, rehearse: bool, recs, seed: int = 31) -> dict:
    """The frontier kernels at their largest. (a) bench.py's compacted
    harvest at 10k in flight: 5 planes x 2048 rows, every row pending, rows
    0/1 gate each other, every other row but 40 per plane waits on row 0
    (undecided executeAt); the compacted and the fused frontier must
    release exactly the 40. (b) one 16384-row plane: ~10,000 pending rows
    each waiting on up to 8 earlier rows (the wait sets of 4-key txns at
    10k in flight over 1k keys), signed exec_ts with ~10% undecided, ~5%
    awaits_all, half of the other rows applied; 64 dirty rows re-shipped
    through exec_scatter, then execution_frontier and frontier_compact,
    each equal to its plain version. recs: the Recorders of (a) and (b)."""
    import numpy as np
    import torch
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.ops.tiers import OutCapTiers

    rng = np.random.default_rng(seed)
    neg = np.iinfo(np.int32).min
    up = (lambda a: tk.upload(np.ascontiguousarray(a), device))
    ecap, nplanes, per_plane = (256 if rehearse else 2048), 5, 40
    words = ecap // 32
    planes, expected = [], []
    for _ in range(nplanes):
        rel = np.sort(rng.choice(np.arange(2, ecap), per_plane,
                                 replace=False))
        adj = np.zeros((ecap, words), np.uint32)
        adj[0, 0] |= np.uint32(1 << 1)
        adj[1, 0] |= np.uint32(1)
        gated = np.ones(ecap, bool)
        gated[rel] = False
        gated[:2] = False
        adj[gated, 0] |= np.uint32(1)
        planes.append((up(adj.view(np.int32)),
                       up(np.full((ecap, 3), neg, np.int32)),
                       up(np.zeros(ecap, bool)), up(np.ones(ecap, bool)),
                       up(np.zeros(ecap, bool))))
        expected.append(rel.tolist())
    tiers = OutCapTiers(tk.FRONTIER_OUT_TIERS, tk.FRONTIER_OUT_TIERS[-1] * 2)
    out_cap = tiers.pick(nplanes * per_plane)
    with recs[0]:
        res = tk.frontier_compact(tuple(planes), out_cap=out_cap)
        fused = tk.fused_execution_frontier(tuple(planes)).cpu().numpy()
    indptr, rows, csum, _ = (t.cpu().numpy() for t in res)
    check(int(indptr[-1]) == nplanes * per_plane,
          f"frontier batch (a): bound {int(indptr[-1])} != "
          f"{nplanes * per_plane}")
    check(tk.frontier_checksum_host(indptr, rows) == int(csum) & 0xFFFFFFFF,
          "frontier batch (a): checksum mismatch")
    for s, exp in enumerate(expected):
        seg = rows[indptr[s]:indptr[s + 1]] - 32 * s * words
        check(seg.tolist() == exp,
              f"frontier batch (a): plane {s} compacted release set wrong")
        bits = np.unpackbits(fused[s * words:(s + 1) * words].view(np.uint8),
                             bitorder="little")
        check(np.nonzero(bits)[0].tolist() == exp,
              f"frontier batch (a): plane {s} fused release set wrong")

    cap = 1024 if rehearse else 16384
    npend = 600 if rehearse else 10_000
    pending = np.zeros(cap, bool)
    pending[rng.choice(cap, npend, replace=False)] = True
    adj = np.zeros((cap, cap // 32), np.uint32)
    w = np.repeat(np.nonzero(pending)[0], 8)
    k = rng.integers(0, 9, npend).repeat(8)     # 0-8 deps per waiter
    w = w[(np.tile(np.arange(8), npend) < k) & (w > 0)]
    d = (rng.random(w.size) * w).astype(np.int64)
    np.bitwise_or.at(adj, (w, d >> 5), np.uint32(1) << (d & 31)
                     .astype(np.uint32))
    ts = np.empty((cap, 3), np.int32)
    ts[:, 0] = rng.integers(-(1 << 20), 1 << 20, cap)
    ts[:, 1:] = rng.integers(neg, np.iinfo(np.int32).max, (cap, 2),
                             dtype=np.int64)
    ts[rng.random(cap) < 0.1] = neg
    applied = ~pending & (rng.random(cap) < 0.5)
    awaits = rng.random(cap) < 0.05
    base = (up(adj.view(np.int32)), up(ts), up(applied), up(pending),
            up(awaits))
    dirty = np.sort(rng.choice(np.nonzero(pending)[0], 64,
                               replace=False)).astype(np.int32)
    uploads = (up(dirty), up(adj[dirty].view(np.int32)), up(ts[dirty]),
               up(applied[dirty]), up(pending[dirty]), up(awaits[dirty]))
    with recs[1]:
        lanes = tk.exec_scatter(*base, *uploads)
        out = tk.execution_frontier(*lanes)
        res = tk.frontier_compact((lanes,), out_cap=tiers.pick(npend))
    check(max_abs_err(lanes, tk.exec_scatter_plain(*base, *uploads)) == 0,
          "frontier batch (b): exec_scatter != its plain version")
    plain = tk.execution_frontier_plain(*lanes)
    check(torch.equal(out, plain),
          "frontier batch (b): execution_frontier != its plain version")
    released = int(tk._popcount_u32(out).sum())
    ref = tk.frontier_compact_plain((lanes,), out_cap=tiers.pick(npend))
    check(max_abs_err(res, ref) == 0,
          "frontier batch (b): frontier_compact != its plain version")
    check(int(res[0][-1]) == released and released > 0,
          f"frontier batch (b): bound {int(res[0][-1])} vs {released} "
          "released")
    return {"a": {"planes": nplanes, "cap": ecap, "released": per_plane,
                  "out_cap": out_cap},
            "b": {"cap": cap, "pending": npend, "edges": int(w.size),
                  "released": released}}


COUNTERS = ("host_fallbacks", "range_fallbacks", "finalize_fallbacks",
            "legacy_decodes", "checksum_mismatches", "dispatches",
            "subjects", "finalized_decodes", "range_subject_device_decodes")


def clean(resolvers) -> dict:
    return {k: sum(int(getattr(r, k)) for r in resolvers) for k in COUNTERS}


def preaccept_batch(device: str, active: int, subjects_n: int,
                    ranges: int = 0, range_share: float = 0.0) -> dict:
    """bench.py's "Synthetic PreAccept batch" on the port: 10k in-flight
    writes over 1k keys (4 each) in one store, 4,096 fresh subjects through
    the async pipeline, each answer checked against the host scan. With
    `ranges`, that many in-flight range writes of 1-2 pieces (widths
    1-2048 over the 2^16 key domain, the burn's max_range_width) join the
    arena, and `range_share` of the subjects are range subjects of the
    same shape."""
    import torch
    from accord_tpu_torch.local.cfk import CfkStatus
    from accord_tpu_torch.ops.resolver import BatchDepsResolver
    from accord_tpu_torch.primitives.keyspace import Keys, Range, Ranges
    from accord_tpu_torch.primitives.timestamp import Domain, TxnId, TxnKind
    from accord_tpu_torch.sim.cluster import Cluster, ClusterConfig
    from accord_tpu_torch.utils.rng import RandomSource

    resolver = BatchDepsResolver(num_buckets=1024, initial_cap=16384,
                                 max_dispatch=1024, device=device)
    cluster = Cluster(3, ClusterConfig(
        num_nodes=1, rf=1, stores_per_node=1, num_shards=1, progress=False,
        deps_resolver_factory=lambda: resolver, deps_batch_window_ms=None))
    node = cluster.nodes[1]
    store = node.command_stores.all()[0]
    rng = RandomSource(17)
    for _ in range(active):
        ts = node.unique_now()
        tid = TxnId.create(ts.epoch, ts.hlc, ts.node, TxnKind.WRITE,
                           Domain.KEY)
        store.register(tid, Keys(rng.next_int(1000) for _ in range(4)),
                       CfkStatus.WITNESSED, ts)

    def pieces():
        out = []
        for _ in range(1 + rng.next_int(2)):
            s = rng.next_int((1 << 16) - 2048)
            out.append(Range(s, s + 1 + rng.next_int(2048)))
        return Ranges(out)

    for _ in range(ranges):
        ts = node.unique_now()
        tid = TxnId.create(ts.epoch, ts.hlc, ts.node, TxnKind.WRITE,
                           Domain.RANGE)
        store.register(tid, pieces(), CfkStatus.WITNESSED, ts)
    subjects = []
    for i in range(subjects_n):
        ts = node.unique_now()
        if range_share and i % round(1 / range_share) == 0:
            tid = TxnId.create(ts.epoch, ts.hlc, ts.node, TxnKind.WRITE,
                               Domain.RANGE)
            owned = store.owned(pieces())
        else:
            tid = TxnId.create(ts.epoch, ts.hlc, ts.node, TxnKind.WRITE,
                               Domain.KEY)
            owned = store.owned(Keys(rng.next_int(1000) for _ in range(4)))
        subjects.append((tid, owned, ts))
    store.batch_window_ms = 2.0
    node.device_latency_ms = 80.0
    node.device_poll_ms = 1.0
    outs = []
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tid, keys, before in subjects:
        outs.append(resolver.enqueue_deps(store, tid, keys, before))
    cluster.queue.drain(max_events=1_000_000)
    wall = time.perf_counter() - t0
    check(all(o.done and o.failure is None for o in outs),
          "PreAccept batch: a resolution failed or never completed")
    bad = sum(1 for (tid, keys, before), o in zip(subjects, outs)
              if o.value() != store.host_calculate_deps(tid, keys, before))
    check(bad == 0, f"PreAccept batch: {bad}/{subjects_n} subjects differ "
          "from the host scan")
    deps = sum(len(o.value().key_deps.all_txn_ids()) for o in outs)
    rdeps = sum(len(o.value().range_deps.all_txn_ids()) for o in outs)
    check(deps > 0, "PreAccept batch: vacuous (no deps at all)")
    check(not ranges or rdeps > 0,
          "PreAccept batch: vacuous (no range deps at all)")
    return {"subjects": subjects_n, "active": active,
            "active_ranges": ranges, "range_share": range_share,
            "wall_s": wall,
            "subjects_per_s": subjects_n / wall,
            "device_block_us_per_subject":
                (resolver.harvest_stall_s + resolver.decode_s)
                / subjects_n * 1e6,
            "dispatches": int(resolver.dispatches),
            "mean_deps_per_subject": deps / subjects_n,
            "mean_range_deps_per_subject": rdeps / subjects_n,
            **{k: v for k, v in clean([resolver]).items()
               if k.endswith("fallbacks") or k in (
                   "checksum_mismatches", "legacy_decodes",
                   "range_subject_device_decodes")}}


def run(rehearse: bool) -> dict:
    import torch
    cuda = torch.cuda.is_available() and not rehearse
    device = "cuda" if cuda else "cpu"
    from accord_tpu_torch.ops import kernels as tk

    card = card_line(cuda)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if cuda:
        log(f"device: {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}")
        from accord_tpu_torch.tools import deps_block_variants as dbv
        from accord_tpu_torch.tools import range_block_variants as rbv
        parent = dbv.start_build()
        rparent = rbv.start_build()
        build_s = build_phase()
        dbv.finish_build(parent)
        rbv.finish_build(rparent)
        log(f"build: {build_s:.2f} s (all csrc/*.cu, nvcc in parallel; the "
            "parent's key body, tools/deps_block_parent.cu, and range body "
            "and K3, tools/range_block_parent.cu, beside them)")

    ops = 800 if not rehearse else 120
    launches = {}
    # 3. key burn: the PR-1 path, launches counted
    key_rec = Recorder(tk)
    dev_res = []
    tk.reset_launches()
    with key_rec:
        rep, wall = burn(device, ops, dev_res)
    if cuda:
        torch.cuda.synchronize()
    launches["key_burn"] = dict(tk.LAUNCHES)
    log(f"burn[{device}]: acked {rep.acked} failed {rep.failed} lost "
        f"{rep.lost} in {wall:.2f} s -> {rep.acked / wall:.1f} acked txn/s; "
        f"launches {launches['key_burn']}; {clean(dev_res)}")
    check(rep.lost == 0 and rep.acked > 0, "burn: lost or no acked txns")
    stats = clean(dev_res)
    for k in ("host_fallbacks", "finalize_fallbacks", "checksum_mismatches"):
        check(stats[k] == 0, f"burn: {k} = {stats[k]}")
    if cuda:
        for name in ("deps_resolve", "finalize_csr", "arena_scatter",
                     "row_scatter"):
            check(launches["key_burn"][name] > 0,
                  f"burn: kernel {name} never launched")
    cpu_res = []
    rep_cpu, wall_cpu = burn("cpu", ops, cpu_res)
    log(f"burn[cpu]: acked {rep_cpu.acked} in {wall_cpu:.2f} s; "
        f"{clean(cpu_res)}")
    check(rep_cpu.log == rep.log,
          "burn: the card's history differs from the CPU's")
    log(f"burn: {len(rep.log)} log lines identical on {device} and cpu")

    # 4. range-mix burn: this slice's path, launches counted
    range_ops = 400 if not rehearse else 60
    range_rec = Recorder(tk)
    rdev = []
    tk.reset_launches()
    with range_rec:
        rrep, rwall = range_mix_burn(device, range_ops, rdev)
    if cuda:
        torch.cuda.synchronize()
    launches["range_burn"] = dict(tk.LAUNCHES)
    rstats = clean(rdev)
    log(f"range_burn[{device}]: acked {rrep.acked} failed {rrep.failed} "
        f"lost {rrep.lost} in {rwall:.2f} s -> {rrep.acked / rwall:.1f} "
        f"acked txn/s; launches {launches['range_burn']}; {rstats}")
    check(rrep.lost == 0 and rrep.acked > 0,
          "range burn: lost or no acked txns")
    for k in ("host_fallbacks", "range_fallbacks", "checksum_mismatches"):
        check(rstats[k] == 0, f"range burn: {k} = {rstats[k]}")
    check(rstats["range_subject_device_decodes"] > 0,
          "range burn: no range subject decoded on the device")
    if cuda:
        for name in ("range_scatter", "range_resolve", "range_finalize"):
            check(launches["range_burn"][name] > 0,
                  f"range burn: kernel {name} never launched")
    rcpu = []
    rrep_cpu, rwall_cpu = range_mix_burn("cpu", range_ops, rcpu)
    log(f"range_burn[cpu]: acked {rrep_cpu.acked} in {rwall_cpu:.2f} s; "
        f"{clean(rcpu)}")
    check(rrep_cpu.log == rrep.log,
          "range burn: the card's history differs from the CPU's")
    check(clean(rcpu) == rstats,
          f"range burn: the card's resolver counters {rstats} differ from "
          f"the CPU's {clean(rcpu)}")
    log(f"range_burn: {len(rrep.log)} log lines identical on {device} and "
        "cpu")

    # 5. inline leg: max_conflict on the device, launches counted
    inline_rec = Recorder(tk)
    ires = []
    tk.reset_launches()
    with inline_rec:
        irep, iwall = inline_burn(device, ires)
    if cuda:
        torch.cuda.synchronize()
    launches["inline"] = dict(tk.LAUNCHES)
    log(f"inline[{device}]: acked {irep.acked} lost {irep.lost} in "
        f"{iwall:.2f} s; launches {launches['inline']}; {clean(ires)}")
    check(irep.lost == 0 and irep.acked == 80, "inline: lost or not acked")
    check(clean(ires)["host_fallbacks"] == 0, "inline: host fallbacks")
    if cuda:
        check(launches["inline"]["max_conflict"] > 0,
              "inline: kernel max_conflict never launched")
    irep_cpu, _ = inline_burn("cpu", [])
    check(irep_cpu.log == irep.log,
          "inline: the card's history differs from the CPU's")
    log(f"inline: {len(irep.log)} log lines identical on {device} and cpu")

    # 6. the PreAccept batches (their own kernel inputs recorded too)
    pa_rec = Recorder(tk)
    with pa_rec:
        pa = preaccept_batch(device, 10_000 if not rehearse else 1_000,
                             4_096 if not rehearse else 256)
    log(f"preaccept_batch[{device}]: {json.dumps(pa)}")
    pr_rec = Recorder(tk)
    with pr_rec:
        par = preaccept_batch(device, 10_000 if not rehearse else 1_000,
                              4_096 if not rehearse else 256,
                              ranges=1_024 if not rehearse else 128,
                              range_share=0.2)
    log(f"preaccept_batch_ranges[{device}]: {json.dumps(par)}")
    for batch in (pa, par):
        for k in ("host_fallbacks", "range_fallbacks", "finalize_fallbacks",
                  "checksum_mismatches"):
            check(batch[k] == 0, f"PreAccept batch: {k} = {batch[k]}")
    check(par["range_subject_device_decodes"] > 0,
          "PreAccept batch: no range subject decoded on the device")

    # 7-9. the exec plane: fused, compacted (+ resolver), solo
    exec_ops = 400 if not rehearse else 60
    exec_recs = {}
    for path, ops_, kw in (
            ("exec_burn", exec_ops, {}),
            ("exec_compact", exec_ops, {"compact": True}),
            ("exec_solo", 120 if not rehearse else 40, {"stores": 1})):
        rec = exec_recs[path] = Recorder(tk)
        with_res = path == "exec_compact"
        eres = [] if with_res else None
        tk.reset_launches()
        with rec:
            erep, ewall = exec_burn(device, ops_, resolvers=eres, **kw)
        if cuda:
            torch.cuda.synchronize()
        launches[path] = dict(tk.LAUNCHES)
        ecnt = exec_counters(erep)
        log(f"{path}[{device}]: acked {erep.acked} failed {erep.failed} lost "
            f"{erep.lost} in {ewall:.2f} s -> {erep.acked / ewall:.1f} acked "
            f"txn/s; launches {launches[path]}; {json.dumps(ecnt)}"
            + (f"; resolver {clean(eres)}" if with_res else ""))
        check(erep.lost == 0 and erep.acked == ops_,
              f"{path}: lost or unacked txns")
        check(ecnt.get("exec.releases", 0) > 0, f"{path}: no releases")
        cres = [] if with_res else None
        crep, cwall = exec_burn("cpu", ops_, resolvers=cres, **kw)
        log(f"{path}[cpu]: acked {crep.acked} in {cwall:.2f} s")
        check(crep.log == erep.log,
              f"{path}: the card's history differs from the CPU's")
        check(exec_counters(crep) == ecnt,
              f"{path}: the card's exec counters {ecnt} differ from the "
              f"CPU's {exec_counters(crep)}")
        if with_res:
            check(clean(cres) == clean(eres),
                  f"{path}: the card's resolver counters differ from the "
                  "CPU's")
            for k in ("host_fallbacks", "checksum_mismatches"):
                check(clean(eres)[k] == 0, f"{path}: {k} = {clean(eres)[k]}")
            check(ecnt.get("exec_coord.compact_fallbacks", 0) == 0,
                  f"{path}: compact fallbacks")
        log(f"{path}: {len(erep.log)} log lines identical on {device} and "
            "cpu")
        if path == "exec_burn":
            ts_flags = (ecnt.get("exec.upload_bytes.ts", 0)
                        + ecnt.get("exec.upload_bytes.flags", 0))
            check(ts_flags > 0, "exec burn: no granular ts/flags uploads")
            check(ecnt["exec.upload_bytes"]
                  < ecnt["exec.upload_bytes_full_equiv"],
                  "exec burn: granular uploads not below the whole-row "
                  "baseline")
            check(ecnt.get("exec_coord.fused_dispatches", 0) > 0,
                  "exec burn: no fused dispatch")
        if cuda:
            must = {"exec_scatter", *(n for n in EXEC_KERNELS
                                      if PATH_OF[n] == path)}
            if with_res:
                must |= {"deps_resolve", "finalize_csr"}
            for name in sorted(must):
                check(launches[path][name] > 0,
                      f"{path}: kernel {name} never launched")

    # 10. the frontier kernels at their largest
    fa_rec, fb_rec = Recorder(tk), Recorder(tk)
    fb = frontier_batch(device, rehearse, (fa_rec, fb_rec))
    log(f"frontier_batch[{device}]: {json.dumps(fb)}")

    # 11. cmd burn: the key burn's cluster with the command planes on the
    #     card too, launches counted
    cmd_ops = 400 if not rehearse else 60
    cmd_rec = Recorder(tk, cmd_tier=8)
    cdev = []
    tk.reset_launches()
    with cmd_rec:
        crep, cwall = burn(device, cmd_ops, cdev, cmd_plane=True,
                           cmd_device=device)
    if cuda:
        torch.cuda.synchronize()
    launches["cmd_burn"] = dict(tk.LAUNCHES)
    ccnt = cmd_counters(crep)
    log(f"cmd_burn[{device}]: acked {crep.acked} failed {crep.failed} lost "
        f"{crep.lost} in {cwall:.2f} s -> {crep.acked / cwall:.1f} acked "
        f"txn/s; launches {launches['cmd_burn']}; {json.dumps(ccnt)}; "
        f"resolver {clean(cdev)}")
    check(crep.lost == 0 and crep.acked > 0, "cmd burn: lost or no acked")
    check(ccnt.get("cmd_plane_dispatches", 0) > 0, "cmd burn: no dispatch")
    check(ccnt.get("cmd_plane_checksum_mismatches", 0) == 0,
          "cmd burn: checksum mismatches")
    for k in ("host_fallbacks", "finalize_fallbacks", "checksum_mismatches"):
        check(clean(cdev)[k] == 0, f"cmd burn: resolver {k}")
    if cuda:
        check(launches["cmd_burn"]["cmd_tick"]
              == ccnt["cmd_plane_dispatches"],
              f"cmd burn: cmd_tick launched "
              f"{launches['cmd_burn']['cmd_tick']} times for "
              f"{ccnt['cmd_plane_dispatches']} dispatches")
        for name in ("deps_resolve", "finalize_csr", "row_scatter"):
            check(launches["cmd_burn"][name] > 0,
                  f"cmd burn: kernel {name} never launched")
    ccpu = []
    crep_cpu, cwall_cpu = burn("cpu", cmd_ops, ccpu, cmd_plane=True,
                               cmd_device="cpu")
    log(f"cmd_burn[cpu]: acked {crep_cpu.acked} in {cwall_cpu:.2f} s")
    check(crep_cpu.log == crep.log,
          "cmd burn: the card's history differs from the CPU's")
    check(cmd_counters(crep_cpu) == ccnt,
          f"cmd burn: the card's cmd counters {ccnt} differ from the CPU's "
          f"{cmd_counters(crep_cpu)}")
    check(clean(ccpu) == clean(cdev),
          "cmd burn: the card's resolver counters differ from the CPU's")
    log(f"cmd_burn: {len(crep.log)} log lines identical on {device} and cpu")

    # 12. authoritative + recovery leg, launches counted
    rec_rec = Recorder(tk)
    tk.reset_launches()
    with rec_rec:
        rrep_d, rwall_d = recovery_burn(device, "device")
    if cuda:
        torch.cuda.synchronize()
    launches["recovery_burn"] = dict(tk.LAUNCHES)
    rcnt = cmd_counters(rrep_d)
    log(f"recovery_burn[{device}]: acked {rrep_d.acked} lost {rrep_d.lost} "
        f"in {rwall_d:.2f} s; launches {launches['recovery_burn']}; "
        f"promote calls {rec_rec.promoted}; {json.dumps(rcnt)}")
    check(rrep_d.lost == 0 and rrep_d.acked == 48,
          "recovery burn: lost or unacked txns")
    check(rcnt.get("recovery_scan_candidates", 0) > 0,
          "recovery burn: the scan found no candidate")
    # an out_cap overflow is answered by the host scan (the reference's
    # degradation, counted); held at 0 so every scan here is the kernel's
    log(f"recovery_burn[{device}]: scan fallbacks "
        f"{rcnt.get('recovery_scan_fallbacks', 0)} overflows "
        f"{rcnt.get('recovery_scan_overflows', 0)} checksum mismatches "
        f"{rcnt.get('cmd_plane_checksum_mismatches', 0)}")
    check(rcnt.get("recovery_scan_fallbacks", 0) == 0,
          "recovery burn: scan fallbacks")
    check(rcnt.get("recovery_scan_overflows", 0) == 0,
          "recovery burn: scan overflows answered by the host scan")
    check(rcnt.get("cmd_plane_checksum_mismatches", 0) == 0,
          "recovery burn: checksum mismatches")
    check(rec_rec.promoted > 0
          and rec_rec.promoted == rcnt["cmd_plane_dispatches"],
          "recovery burn: cmd_tick did not run with promote")
    if cuda:
        check(launches["recovery_burn"]["recovery_scan"]
              == rcnt["recovery_scan_dispatches"] > 0,
              "recovery burn: recovery_scan launches != scan dispatches")
        check(launches["recovery_burn"]["cmd_tick"]
              == rcnt["cmd_plane_dispatches"] > 0,
              "recovery burn: cmd_tick launches != dispatches")
    rrep_c, rwall_c = recovery_burn("cpu", "device")
    rrep_h, rwall_h = recovery_burn(device, "host")
    log(f"recovery_burn[cpu]: {rwall_c:.2f} s; host scan on {device}: "
        f"{rwall_h:.2f} s")
    check(rrep_c.log == rrep_d.log,
          "recovery burn: the card's history differs from the CPU's")
    check(rrep_h.log == rrep_d.log,
          "recovery burn: the device scan's history differs from the host "
          "scan's")
    check(cmd_counters(rrep_c) == rcnt,
          f"recovery burn: the card's counters {rcnt} differ from the "
          f"CPU's {cmd_counters(rrep_c)}")
    log(f"recovery_burn: {len(rrep_d.log)} log lines identical on {device}, "
        "cpu and with the host scan")

    # 13. repair leg, launches counted
    rep_rec = Recorder(tk)
    tk.reset_launches()
    with rep_rec:
        rleg = repair_leg(device)
    if cuda:
        torch.cuda.synchronize()
    launches["repair"] = dict(tk.LAUNCHES)
    log(f"repair[{device}]: {json.dumps(rleg)}; launches "
        f"{launches['repair']}")
    if cuda:
        check(launches["repair"]["cmd_repair"] > 0,
              "repair leg: cmd_repair never launched")

    # 14-15. the command plane at 10k in flight
    cb_rec = Recorder(tk)
    with cb_rec:
        cb = cmd_batch(device, 10_000 if not rehearse else 600)
    log(f"cmd_batch[{device}]: {json.dumps(cb)}")
    rb_rec = Recorder(tk)
    with rb_rec:
        rb = recovery_batch(device, 10_240 if not rehearse else 600)
    log(f"recovery_batch[{device}]: {json.dumps(rb)}")

    # 16-19. the cluster tick: the megakernel sweep, the key+range, cmd and
    #        exec legs, the merged tick at 10k in flight
    sweep_recs = {"mega_sweep": Recorder(tk), "merged_sweep": Recorder(tk)}
    sweep_rows, sweep_logs = megakernel_sweep(device, cuda, rehearse, tk,
                                              launches, sweep_recs)
    leg_recs = {"mega_range": Recorder(tk), "mega_cmd": Recorder(tk)}
    cluster_legs(device, cuda, tk, launches, leg_recs)
    tick_10k = merged_tick(device, cuda, rehearse, tk)
    tick10k = FixedCalls(protocol_tick=tick_10k["args"])

    # 19-21. the message plane, the graft entry, the execute-DAG kernels
    mail_recs = {"message_plane": Recorder(tk)}
    mail = message_plane(device, cuda, rehearse, tk, launches, mail_recs)
    mail_big = mail["largest_leg"]
    graft_rec = graft_leg(device, cuda, tk, launches)
    dense_batch, dag_rec = dense_legs(device, cuda, rehearse, tk, launches)

    # 22. the sharded deps data plane: the real mesh and the virtual 4 x 2
    sharded_entries = sharded_phase(
        device, cuda, rehearse, tk, launches,
        {"key_burn": rep.log, "range_burn": rrep.log},
        sharded_batches(tk, 4, pa_rec, pr_rec, range_rec))

    # 24. the sharded protocol megakernel: the real mesh and the virtual
    sharded_mega = sharded_mega_phase(
        device, cuda, rehearse, tk, launches,
        dict(sweep_rows=sweep_rows, sweep_logs=sweep_logs,
             mail_logs=mail["logs"], tick_10k=tick_10k))

    # 23. kernels: replay the recorded inputs, kernel vs plain, timed
    iters = 50 if cuda else 2
    path_rec = {"key_burn": key_rec, "range_burn": range_rec,
                "inline": inline_rec, **exec_recs, "cmd_burn": cmd_rec,
                "recovery_burn": rec_rec, "repair": rep_rec, **sweep_recs,
                **leg_recs, **mail_recs, "graft_entry": graft_rec,
                "dag_100k": dag_rec}
    # further inputs each kernel is replayed on, by label (the first
    # two keep their PR-1/PR-2 names in the kernels line)
    extra_rec = {"key_burn": [("preaccept_batch", pa_rec),
                              ("range_burn", range_rec)],
                 "range_burn": [("preaccept_batch", pr_rec)],
                 "inline": [], "cmd_burn": [("cmd_batch", cb_rec)],
                 "recovery_burn": [("recovery_batch", rb_rec)],
                 "repair": [], "mega_sweep": [("merged_tick_10k", tick10k)],
                 "merged_sweep": [], "mega_range": [],
                 "mega_cmd": [("merged_tick_10k", tick10k)],
                 "message_plane": [("largest_leg", mail_big)],
                 "graft_entry": [("real_size",
                                                       dense_batch)],
                 "dag_100k": []}
    exec_extra = [("exec_burn", exec_recs["exec_burn"]),
                  ("exec_compact", exec_recs["exec_compact"]),
                  ("frontier_batch_a", fa_rec),
                  ("frontier_batch_b", fb_rec)]
    entries = []
    for name, source, replaces in KERNELS:
        path = PATH_OF[name]
        log(f"kernel {name}, {path} inputs:")
        head = kernel_report(tk, name, path_rec[path], cuda, iters, path)
        reports = [head]
        if name in EXEC_KERNELS:
            extra = [(lab, r) for lab, r in exec_extra
                     if lab != path and r.get(name) is not None]
        else:
            extra = extra_rec[path]
        if name == "row_scatter":
            # the plane flushes' lane tables (flush_lanes)
            extra = extra + [("exec_burn", exec_recs["exec_burn"]),
                             ("cmd_burn", cmd_rec)]
        labelled = []
        for label, rec in extra:
            log(f"kernel {name}, {label} inputs:")
            labelled.append((label, kernel_report(tk, name, rec, cuda,
                                                  iters, label)))
            reports.append(labelled[-1][1])
        for k in reports:
            check(k["max_abs_err"] == 0,
                  f"kernel {name} disagrees with its plain version")
        if cuda:
            check(launches[path][name] > 0,
                  f"{path}: kernel {name} never launched")
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[path][name],
            "path": path, **({"library_call": LIBRARY_CALL[name]}
                             if name in LIBRARY_CALL else {}),
            **({"library_chain": LIBRARY_CHAIN[name]}
               if name in LIBRARY_CHAIN else {}),
            "max_abs_err": max(k["max_abs_err"] for k in reports),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "call": head["call"],
            "calls": [_brief(r) for r in head["calls"]],
            **{k: head[k] for k in ("op_tier", "ms_per_op", "device_ms",
                                    "library_device_ms", "library_chain_ms",
                                    "library_chain_device_ms", "specs",
                                    "trace", "body_device_ms",
                                    "body_trace", "parent_vs_new",
                                    "range_parent_vs_new",
                                    "stage_parent_vs_new")
               if k in head},
            "launches_by_path": {p: launches[p][name] for p in launches}}
        for label, r in labelled:
            entry[label] = dict(_brief(r),
                                calls=[_brief(c) for c in r["calls"]])
        if cuda and name in LIBRARY_CHAIN:
            entry["vs_library"] = dense_vs_library(name, entry["real_size"])
        entries.append(entry)
    entries.extend(sharded_entries)
    entries.extend(sharded_mega)
    return {"card": card, "entries": entries, "cuda": cuda,
            "acked_per_s": rep.acked / wall,
            "parent_vs_new": parent_vs_new_line()}


# the parent-vs-new line's entries: (label, wrapper) of kernel_report
PARENT_VS_NEW_KEYS = {
    "k1_preaccept_batch": ("preaccept_batch", "deps_resolve"),
    "k13_sweep_largest_tick": ("mega_sweep", "node_fused_deps_resolve"),
    "k13_tick_10k": ("merged_tick_10k", "node_fused_deps_resolve"),
    "k5_range_batch": ("preaccept_batch", "range_deps_resolve")}


# the range body's and K3's entries: (label, wrapper[:stage])
RANGE_VS_PARENT_KEYS = {
    "k3_key_burn": ("key_burn", "arena_scatter"),
    "k3_range_burn": ("range_burn", "arena_scatter"),
    "k3_cap_16384": ("preaccept_batch", "arena_scatter"),
    "k3_keys_key_burn": ("key_burn", "arena_scatter_keys"),
    "k3_keys_range_burn": ("range_burn", "arena_scatter_keys"),
    "k5_range_burn": ("range_burn", "range_deps_resolve"),
    "k5_fused_range_burn": ("range_burn", "fused_range_deps_resolve"),
    "k5_range_batch": ("preaccept_batch", "range_deps_resolve"),
    "k5_covered_range_burn": ("range_burn", "covered_buckets"),
    "k5_covered_range_batch": ("preaccept_batch", "covered_buckets"),
    "k14_key_range_leg": ("mega_range", "node_fused_range_deps_resolve"),
    "mega_range_stage": ("mega_range",
                         "node_fused_range_deps_resolve:stage")}


def parent_vs_new_line() -> dict:
    """The key body's device ms beside the parent's (same card, same
    process, interleaved): K1 at the PreAccept batch, K13 at the sweep's
    largest tick and at the 10k tick (the body launch alone), K5 at the
    range batch (the whole call), the 10k tick's replay, and the sharded
    10k tick's key stage (its replay); under "range_body", the range body's
    and K3's beside theirs (RANGE_VS_PARENT_KEYS, and the sharded key+range
    leg's range stage)."""
    out = {}
    for key, (label, fn) in PARENT_VS_NEW_KEYS.items():
        got = PARENT_VS_NEW.get((label, fn))
        if got is not None:
            out[key] = got
    for key in ("tick_10k_replay", "node_key_shard_10k_key_stage"):
        if key in PARENT_VS_NEW:
            out[key] = PARENT_VS_NEW[key]
    rng = {key: RANGE_VS_PARENT[k] for key, k in RANGE_VS_PARENT_KEYS.items()
           if k in RANGE_VS_PARENT}
    if "sharded_range_stage" in RANGE_VS_PARENT:
        rng["sharded_range_stage"] = RANGE_VS_PARENT["sharded_range_stage"]
    if rng:
        out["range_body"] = rng
    return out


# -- the cluster tick (mesh burn) and the protocol megakernel ----------------
def mesh_leg(device: str, seed: int, ops: int, mode: str, **kw):
    """One run_mesh_burn: mode "mega" (one protocol_tick graph replay per
    cluster tick), "merged" (the node-lane dispatch, K13/K14 + lane_slice
    demux + per-plan finalizes) or "loop" (the per-node launch loop)."""
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    t0 = time.perf_counter()
    rep, eng = run_mesh_burn(seed, ops, device=device, collect_log=True,
                             mesh_tick=mode != "loop",
                             megakernel=mode == "mega", **kw)
    return rep, eng.snapshot(), time.perf_counter() - t0


def megakernel_sweep(device: str, cuda: bool, rehearse: bool, tk, launches,
                     recs) -> dict:
    """bench.py's bench_megakernel sizes (seed 6: 64 nodes x 120 ops, 256 x
    50, 1024 x 24) in megakernel and merged modes, plus the per-node loop
    at 64 nodes: a warm pass, then a timed pass whose every mode is one
    path (counts zeroed before, read after). Histories identical across
    modes; launches_per_tick 1.0 and one protocol_tick replay per fused
    dispatch; no graph captured or evicted and no mesh_tick fallback in
    the timed pass; the 64-node megakernel history equal to the CPU's.
    The warm pass logs each size's captures and the graph cache after it.
    After the timed pass, each size's largest tick is replayed alone for
    its device ms."""
    import torch
    sizes = ((64, 120), (256, 50), (1024, 24)) if not rehearse \
        else ((16, 40), (32, 16))
    plan = [(n, o, m) for n, o in sizes for m in ("mega", "merged")] \
        + [(sizes[0][0], sizes[0][1], "loop")]
    warm = {}
    for n, o, m in plan:                       # warm: captures happen here
        c0 = dict(tk.CAPTURES)
        mesh_leg(device, 6, o, m, nodes=n)
        if m == "mega":
            warm[n] = {"captures": tk.CAPTURES["protocol_tick"]
                       - c0["protocol_tick"],
                       "evictions": tk.CAPTURES["evictions"]
                       - c0["evictions"]}
            if cuda:
                from accord_tpu_torch.ops import tick_graph
                # the whole cache after this size's warm run
                warm[n]["cache_after"] = tick_graph.cache_stats()
            log(f"sweep warm {n} nodes: {json.dumps(warm[n])}")
    if cuda:
        torch.cuda.synchronize()
    rows, logs, size_recs = {}, {}, {}
    for path, mode in (("mega_sweep", "mega"), ("merged_sweep", "merged"),
                       ("loop_sweep", "loop")):
        tk.reset_launches()
        fused = merged = 0
        with recs.get(path) or Recorder(tk):
            for n, o, m in plan:
                if m != mode:
                    continue
                with Recorder(tk) as size_recs[(n, m)]:
                    rep, snap, wall = mesh_leg(device, 6, o, m, nodes=n)
                if cuda:
                    torch.cuda.synchronize()
                check(rep.lost == 0 and rep.acked == o,
                      f"sweep {m} {n} nodes: lost or unacked")
                check(snap["mesh_tick_fallbacks"] == 0,
                      f"sweep {m} {n} nodes: mesh_tick fallbacks")
                if m == "mega":
                    check(snap["launches_per_tick"] == 1.0,
                          f"sweep {n} nodes: launches_per_tick "
                          f"{snap['launches_per_tick']}")
                    fused += snap["megakernel_dispatches"]
                merged += snap["node_lane_dispatches"]
                logs[(n, m)] = rep.log
                row = {"nodes": n, "ops": o, "mode": m, "wall_s": wall,
                       "committed_txn_per_s": rep.acked / wall,
                       "cluster_ticks": snap["cluster_ticks"],
                       "nodes_per_dispatch": snap["nodes_per_dispatch"],
                       "launches_per_tick": snap["launches_per_tick"],
                       "host_ms_per_tick":
                           wall * 1e3 / max(1, snap["cluster_ticks"])}
                rows[f"{m}_{n}"] = row
                log(f"sweep[{device}]: {json.dumps(row)}")
        launches[path] = dict(tk.LAUNCHES)
        captures = tk.CAPTURES["protocol_tick"]
        log(f"sweep {path}: launches {launches[path]}; graph captures "
            f"{captures}, evictions {tk.CAPTURES['evictions']}")
        check(captures == 0 and tk.CAPTURES["evictions"] == 0,
              f"sweep {path}: {captures} graphs captured, "
              f"{tk.CAPTURES['evictions']} evicted after the warm pass")
        if cuda and mode == "mega":
            check(launches[path]["protocol_tick"] == fused > 0,
                  f"sweep: {launches[path]['protocol_tick']} protocol_tick "
                  f"replays for {fused} fused dispatches")
            check(launches[path]["node_deps_resolve"] > 0,
                  "sweep: K13 never ran in the graph")
        if cuda and mode == "merged":
            for name in ("node_deps_resolve", "lane_slice", "finalize_csr"):
                check(launches[path][name] > 0,
                      f"sweep merged: kernel {name} never launched")
            # K15 demuxes a whole merged dispatch in one launch
            check(launches[path]["lane_slice"] <= merged,
                  f"sweep merged: {launches[path]['lane_slice']} lane_slice "
                  f"launches for {merged} merged key and range dispatches")
            log(f"sweep merged: {launches[path]['lane_slice']} lane_slice "
                f"launches, {merged} merged dispatches")
    for n, _o in sizes:
        check(logs[(n, "mega")] == logs[(n, "merged")],
              f"sweep {n} nodes: megakernel history != merged")
    n0, o0 = sizes[0]
    check(logs[(n0, "loop")] == logs[(n0, "mega")],
          f"sweep {n0} nodes: the per-node loop's history differs")
    cpu, _snap, cwall = mesh_leg("cpu", 6, o0, "mega", nodes=n0)
    check(cpu.log == logs[(n0, "mega")],
          f"sweep {n0} nodes: the card's megakernel history != the CPU's")
    log(f"sweep: {n0}-node megakernel history equal on {device} and cpu "
        f"({cwall:.2f} s on the cpu)")
    if cuda:
        for n, _o in sizes:
            args, kw = size_recs[(n, "mega")].get("protocol_tick")
            out = tk.protocol_tick(*args, **kw)   # noqa: F841 (kept alive)
            ms = time_ms(last_graph_replay(), 20, cuda)
            rows[f"mega_{n}"]["ms_per_replay_largest_tick"] = ms
            rows[f"mega_{n}"]["warm"] = warm[n]
            log(f"sweep: {n} nodes, the largest tick's replay {ms:.4f} ms")
    return rows, logs


def cluster_legs(device: str, cuda: bool, tk, launches, recs) -> dict:
    """tests/test_megakernel.py's key+range and cmd-plane legs and
    bench.py's exec-in-megakernel leg, on the card, each against the CPU
    (and the unfused modes), each megakernel run one path."""
    import torch
    out = {}
    # key + range: seed 9, 40 ops, 4 nodes, 20% range reads, 10% writes
    kw = dict(nodes=4, range_read_ratio=0.2, range_write_ratio=0.1)
    tk.reset_launches()
    with recs["mega_range"]:
        mega, snap, wall = mesh_leg(device, 9, 40, "mega", **kw)
    if cuda:
        torch.cuda.synchronize()
    launches["mega_range"] = dict(tk.LAUNCHES)
    merged = mesh_leg(device, 9, 40, "merged", **kw)[0]
    loop = mesh_leg(device, 9, 40, "loop", **kw)[0]
    cpu = mesh_leg("cpu", 9, 40, "mega", **kw)[0]
    check(mega.log == merged.log == loop.log,
          "key+range leg: fused, merged and loop histories differ")
    check(mega.log == cpu.log, "key+range leg: card != cpu")
    check(snap["launches_per_tick"] == 1.0, "key+range leg: launches/tick")
    if cuda:
        check(launches["mega_range"]["node_range_resolve"] > 0,
              "key+range leg: K14 never ran")
        check(launches["mega_range"]["protocol_tick"]
              == snap["megakernel_dispatches"] > 0,
              "key+range leg: replays != fused dispatches")
    out["key_range"] = {"acked": mega.acked, "wall_s": wall, **snap}
    log(f"key_range[{device}]: {json.dumps(out['key_range'])}; launches "
        f"{launches['mega_range']}")
    # cmd plane, authoritative: 3 nodes, 32 ops, seed 13
    kw = dict(nodes=3, cmd_plane=True, cmd_plane_authoritative=True)
    tk.reset_launches()
    with recs["mega_cmd"]:
        mega, snap, wall = mesh_leg(device, 13, 32, "mega", **kw)
    if cuda:
        torch.cuda.synchronize()
    launches["mega_cmd"] = dict(tk.LAUNCHES)
    cpu, csnap, _ = mesh_leg("cpu", 13, 32, "mega", **kw)
    unfused = mesh_leg(device, 13, 32, "merged", **kw)[0]
    check(mega.log == cpu.log == unfused.log,
          "cmd leg: card, cpu and unfused histories differ")
    check(snap["fastpath_quorum_txns"] > 0
          and snap["fastpath_quorum_txns"] == csnap["fastpath_quorum_txns"],
          f"cmd leg: fast-path quorum txns {snap['fastpath_quorum_txns']} "
          f"vs cpu {csnap['fastpath_quorum_txns']}")
    check(cmd_counters(mega) == cmd_counters(cpu),
          "cmd leg: the card's cmd counters differ from the CPU's")
    check(cmd_counters(mega).get("cmd_deferred_spans", 0) > 0,
          "cmd leg: no deferred span")
    check(snap["launches_per_tick"] == 1.0, "cmd leg: launches/tick")
    if cuda:
        check(launches["mega_cmd"]["quorum_count"] > 0,
              "cmd leg: K16 never ran")
    out["cmd"] = {"acked": mega.acked, "wall_s": wall, **snap,
                  **{k: v for k, v in cmd_counters(mega).items()
                     if "deferred" in k}}
    log(f"cmd_leg[{device}]: {json.dumps(out['cmd'])}; launches "
        f"{launches['mega_cmd']}")
    # exec in the megakernel: seed 13, 40 ops, 4 nodes, rf 3, 2 stores
    base = dict(nodes=4, rf=3, stores_per_node=2, key_count=24,
                concurrency=8, exec_plane=True, exec_compact=True)
    solo = mesh_leg(device, 13, 40, "mega", **base)[0]
    tk.reset_launches()
    fused, snap, wall = mesh_leg(device, 13, 40, "mega",
                                 exec_in_megakernel=True, **base)
    if cuda:
        torch.cuda.synchronize()
    launches["mega_exec"] = dict(tk.LAUNCHES)
    cpu = mesh_leg("cpu", 13, 40, "mega", exec_in_megakernel=True,
                   **base)[0]
    check(fused.log == solo.log == cpu.log,
          "exec leg: exec-in-megakernel history != the standalone "
          "coordinator's / the CPU's")
    check(snap["exec_scan_blocks"] > 0, "exec leg: no exec block staged")
    check(snap["launches_per_tick"] == 1.0, "exec leg: launches/tick")
    check(fused.counters.get("exec_coord.compact_fallbacks", 0) == 0,
          "exec leg: compact fallbacks")
    if cuda:
        check(launches["mega_exec"]["frontier_compact"] > 0
              and launches["mega_exec"]["protocol_tick"]
              == snap["megakernel_dispatches"],
              "exec leg: the exec stage never ran in a replay")
    out["exec"] = {"acked": fused.acked, "wall_s": wall, **snap}
    log(f"exec_leg[{device}]: {json.dumps(out['exec'])}")
    return out


def merged_tick_inputs(device: str, rehearse: bool, tk) -> dict:
    """The merged tick at 10k in flight's inputs (see merged_tick): the
    key merge (key_in), the key finalize specs, the quorum lanes and the
    witness table on `device`, with the host rows the check reads."""
    import numpy as np
    import torch
    from accord_tpu_torch.ops import carry
    from accord_tpu_torch.ops import node_lane as nl
    from accord_tpu_torch.ops.encoding import WITNESS_TABLE
    nodes, stores, cap, k = (64, 2, 2048, 1024) if not rehearse \
        else (8, 2, 256, 128)
    writes, nkeys, per_plan = (10_000, 1_000, 32) if not rehearse \
        else (500, 100, 32)
    rng = np.random.default_rng(10_000)
    nblk = nodes * stores
    table = np.asarray(WITNESS_TABLE, np.int32)
    # rows: each write lands on rf=3 nodes, in the store of its first key
    wkeys = rng.integers(0, nkeys, (writes, 4))
    blk_rows = [[] for _ in range(nblk)]
    for w in range(writes):
        st = int(wkeys[w, 0]) % stores
        for nd in rng.choice(nodes, 3, replace=False):
            blk_rows[nd * stores + st].append(w)
    hlc0 = 1000
    blocks, kid_tabs, host_rows = [], [], []
    for rows in blk_rows:
        n = len(rows)
        check(n <= cap, "merged tick: a block overflows its cap")
        bits = np.zeros((cap, k), bool)
        ts = np.zeros((cap, 3), np.int32)
        kinds = np.zeros(cap, np.int32)
        valid = np.zeros(cap, bool)
        kid = np.zeros((nkeys, cap // 32), np.uint32)
        for r, w in enumerate(rows):
            bits[r, wkeys[w] % k] = True
            ts[r] = (1, hlc0 + w, w % 7)
            kinds[r] = 1 + (w % 2)
            valid[r] = True
            for key in set(int(x) for x in wkeys[w]):
                kid[key, r >> 5] |= np.uint32(1) << np.uint32(r & 31)
        packed = carry.pack_bitmaps(bits.astype(np.float32))
        blocks.append(tuple(torch.from_numpy(np.ascontiguousarray(a))
                            .to(device) for a in (
                                packed.view(np.int32), ts, kinds, valid)))
        kid_tabs.append(torch.from_numpy(kid.view(np.int32)).to(device))
        host_rows.append((rows, ts, kinds, valid))
    # plans: one per block, 32 subjects of 1-4 keys
    entries, fins, subj = [], [], []
    for p in range(nblk):
        sk = [sorted(set(int(x) for x in rng.integers(
            0, nkeys, 1 + rng.integers(0, 4)))) for _ in range(per_plan)]
        sb = np.zeros((per_plan, 3), np.int32)
        sb[:, 0] = 1
        sb[:, 1] = hlc0 + rng.integers(0, writes, per_plan)
        sknd = rng.integers(1, 3, per_plan).astype(np.int32)
        of = np.concatenate([[i] * len(x) for i, x in enumerate(sk)])
        keys = np.concatenate(sk) % k
        z = tk.nnz_tier(len(of))
        subj_of = np.full(z, per_plan, np.int32)
        subj_of[:len(of)] = of
        subj_keys = np.zeros(z, np.int32)
        subj_keys[:len(keys)] = keys
        entries.append((p, dict(
            sb=sb, sknd=sknd, subj_store=np.zeros(per_plan, np.int32),
            subj_of=subj_of, subj_keys=subj_keys, ngroups=1, slots=[0],
            ksnaps=[(blocks[p][0], blocks[p][1], None, blocks[p][2],
                     blocks[p][3])], fused=False)))
        subj.append((sk, sb, sknd))
    km = nl.build_key_merge(
        entries, lambda c: tuple(torch.zeros_like(t[:c]) if t.dim() == 1
                                 else torch.zeros(c, t.shape[1],
                                                  dtype=t.dtype,
                                                  device=t.device)
                                 for t in blocks[0]))
    for p, (r0, b, w0, w) in enumerate(km.spans):
        sk = subj[p][0]
        slot_subj = np.concatenate([[i] * len(x) for i, x in enumerate(sk)])
        slot_kid = np.concatenate(sk)
        s = tk.nnz_tier(len(slot_subj))
        a_subj = np.full(s, b, np.int32)
        a_subj[:len(slot_subj)] = slot_subj
        a_kid = np.full(s, nkeys, np.int32)
        a_kid[:len(slot_kid)] = slot_kid
        kid = kid_tabs[p].cpu().numpy().view(np.uint32)
        bound = sum(int(np.unpackbits(kid[x].view(np.uint8)).sum())
                    for x in slot_kid)
        fins.append(("key", r0, w0, b, w, 0, kid_tabs[p],
                     torch.from_numpy(a_subj).to(device),
                     torch.from_numpy(a_kid).to(device),
                     torch.full((b,), -1, dtype=torch.int32, device=device),
                     blocks[p][1], tk.out_tier(max(1, bound))))
    lanes = 4096 if not rehearse else 256
    q_txn = rng.integers(0, 50, (lanes, 3)).astype(np.int32)
    q_ts = np.where(rng.random((lanes, 1)) < 0.7, q_txn,
                    q_txn + 1).astype(np.int32)
    quorum = (q_txn, q_ts, rng.choice([0, 0, 0, 1, 2], lanes)
              .astype(np.int32), np.ones(lanes, bool))
    wt = torch.from_numpy(table).to(device)
    key_in = (km.subj_of, km.subj_keys, km.subj_node, km.sb, km.sknd,
              km.slots, km.blocks)
    kw = dict(key_in=key_in, fins=tuple(fins), quorum=quorum,
              quorum_size=2)
    return dict(wt=wt, key_in=key_in, kw=kw, km=km, subj=subj,
                host_rows=host_rows, wkeys=wkeys, table=table,
                blk_rows=blk_rows, fins=fins, quorum=quorum, lanes=lanes)


def merged_tick(device: str, cuda: bool, rehearse: bool, tk) -> dict:
    """One merged cluster tick at 10k in flight: 128 (plan, store) blocks
    (64 nodes x 2 stores), arenas of cap 2048 with 1,024 buckets holding
    30,000 live rows (10,000 writes of 4 keys over 1,000 keys, rf 3, as
    the synthetic PreAccept batch), 4,096 subject rows in 128 plans of 32
    (1-4 keys each, one key finalize each) and 4,096 quorum lanes. The
    replay equals the plain protocol_tick bit for bit, and every plan's
    decoded deps equal the host scan. Timed: the replay; K13, K2 (all 128)
    and K16 alone; the same stages launched one by one."""
    import torch
    from accord_tpu_torch.ops import node_lane as nl
    t = merged_tick_inputs(device, rehearse, tk)
    wt, key_in, kw, km, subj, host_rows, wkeys, table, blk_rows, fins, \
        quorum, lanes = (t[x] for x in (
            "wt", "key_in", "kw", "km", "subj", "host_rows", "wkeys",
            "table", "blk_rows", "fins", "quorum", "lanes"))
    plain = tk.protocol_tick_plain(wt, **_on(kw, device))
    c0 = tk.CAPTURES["protocol_tick"]
    l0 = dict(tk.LAUNCHES)
    got = tk.protocol_tick(wt, **kw)
    if cuda:
        torch.cuda.synchronize()
        check(tk.LAUNCHES["finalize_csr_tab"] - l0["finalize_csr_tab"] == 1
              and tk.LAUNCHES["finalize_csr"] == l0["finalize_csr"],
              "merged tick: the key finalizes are not one table launch")
    err = max_abs_err(got, plain)
    check(err == 0, f"merged tick: replay differs from the plain version "
          f"(max abs err {err})")
    # decode every plan's finalized deps and hold them to the host scan
    bad = 0
    for p, (fin, out) in enumerate(zip(fins, got[2])):
        indptr, dep_rows = (t.cpu().numpy() for t in out[:2])
        check(int(indptr[-1]) <= fin[-1], "merged tick: out_cap overflow")
        sk, sb, sknd = subj[p]
        rows, ts, kinds, valid = host_rows[p]
        slot = 0
        for i, keys in enumerate(sk):
            got_rows = set()
            for _key in keys:
                got_rows |= set(dep_rows[indptr[slot]:indptr[slot + 1]]
                                .tolist())
                slot += 1
            want = {r for r, w in enumerate(rows)
                    if set(keys) & set(int(x) for x in wkeys[w])
                    and table[sknd[i], kinds[r]] == 1
                    and tuple(ts[r]) < tuple(sb[i])}
            bad += got_rows != want
    check(bad == 0, f"merged tick: {bad} subjects' deps differ from the "
          "host scan")
    check(sum(int(o[0][-1]) for o in got[2]) > 0,
          "merged tick: vacuous (no deps at all)")
    out = {"blocks": len(km.blocks), "live_rows": sum(map(len, blk_rows)),
           "subjects": km.rows_used, "quorum_lanes": lanes,
           "captures": tk.CAPTURES["protocol_tick"] - c0,
           "deps": int(sum(int(o[0][-1]) for o in got[2])),
           "merged_mb": got[0].numel() * 4 / 1e6}
    if cuda:
        iters = 20
        out["replay_ms"] = time_ms(last_graph_replay(), iters, cuda)
        # the key finalize stage: the replay of the key stage with the
        # finalizes less the replay of the key stage alone
        k_only = tk.protocol_tick(wt, key_in=key_in)  # noqa: F841 (alive)
        out["key_stage_replay_ms"] = time_ms(last_graph_replay(), iters,
                                             cuda)
        k_fins = tk.protocol_tick(wt, key_in=key_in,  # noqa: F841
                                  fins=tuple(fins))
        out["key_fins_replay_ms"] = time_ms(last_graph_replay(), iters,
                                            cuda)
        out["fin_stage_ms"] = out["key_fins_replay_ms"] \
            - out["key_stage_replay_ms"]
        out["call_ms"] = time_ms(lambda: tk.protocol_tick(wt, **kw),
                                 iters, cuda)
        dkey = _on(key_in, device)
        out["k13_ms"] = time_ms(lambda: nl.node_fused_deps_resolve(
            *dkey, wt), iters, cuda)
        packed = nl.node_fused_deps_resolve(*dkey, wt)

        def k2_all():
            for f in fins:
                tk.finalize_csr(packed[f[1]:f[1] + f[3]], f[2] + f[5],
                                *f[6:11], out_cap=f[11])
        out["k2_all_ms"] = time_ms(k2_all, iters, cuda)
        dq = _on(quorum, device)
        out["k16_ms"] = time_ms(lambda: tk.quorum_count(*dq, 2), iters, cuda)

        def one_by_one():
            pk = nl.node_fused_deps_resolve(*dkey, wt)
            for f in fins:
                tk.finalize_csr(pk[f[1]:f[1] + f[3]], f[2] + f[5],
                                *f[6:11], out_cap=f[11])
            tk.quorum_count(*dq, 2)
        out["one_by_one_ms"] = time_ms(one_by_one, iters, cuda)
        # the whole replay with the parent's key body (its own graph)
        from accord_tpu_torch.tools import deps_block_variants as dbv
        pair = dbv.replay_pair(lambda: tk.protocol_tick(wt, **kw),
                               lambda o: o[0])
        check(pair["bit_equal"], "merged tick: the parent's key body "
              "answers differently")
        PARENT_VS_NEW["tick_10k_replay"] = out["parent_vs_new"] = pair
    log(f"merged_tick[{device}]: {json.dumps(out)}")
    out["fin_table"] = fin_table(device, cuda, tk, wt, kw)
    return {"out": out, "args": ((wt,), kw)}


def fin_table(device: str, cuda: bool, tk, wt, kw) -> dict:
    """The 10k tick's key finalizes, recorded, through K2's table entry
    (one launch) and through per-spec finalize_csr calls (one launch each),
    each set captured in one CUDA graph and replayed twice: both bit-equal
    to the plain versions after each replay; both replay times."""
    import torch
    specs = key_fin_specs(tk, _on(wt, device), kw)
    plain = tk.finalize_csr_tab_plain(specs)
    out = {"specs": len(specs)}
    if not cuda:
        check(max_abs_err(tk.finalize_csr_tab(specs), plain) == 0,
              "finalize table: differs from the plain versions")
        return out
    launch, tab_outs = tk.fin_tab_launcher(specs)
    launch()
    per = [tk.finalize_csr(*sp) for sp in specs]     # warm, the scratch
    torch.cuda.synchronize()
    g_tab, g_per = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(g_tab):
        launch()
    with torch.cuda.graph(g_per):
        per = [tk.finalize_csr(*sp) for sp in specs]
    for _ in range(2):
        g_tab.replay()
        g_per.replay()
        torch.cuda.synchronize()
        check(max_abs_err(tab_outs, plain) == 0
              and max_abs_err(tuple(per), plain) == 0,
              "finalize table: a replay differs from the plain versions")
    out["table_replay_ms"] = time_ms(g_tab.replay, 20, cuda)
    out["per_spec_replay_ms"] = time_ms(g_per.replay, 20, cuda)
    out["per_spec_launches"] = len(specs)
    log(f"finalize table[{device}]: {json.dumps(out)}")
    return out



# -- the message plane, the graft entry, the execute-DAG kernels -------------
def message_plane(device: str, cuda: bool, rehearse: bool, tk, launches,
                  recs) -> dict:
    """bench.py's bench_message_plane sizes (seed 6, rf 5, concurrency 24,
    megakernel; 64 nodes x 60 ops, 256 x 30, 1024 x 12): a warm pass of
    device_messages=True and the host network at every size, then a timed
    pass whose device-messages runs are one path (counts zeroed before,
    read after). One history per size, the 64-node one equal to the CPU's
    device-messages run; launches_per_tick 1.0, zero overflow spills and
    verify fallbacks, no graph captured or evicted after the warm pass,
    K17 launched in the replays. -> the rows by size, and under
    "largest_leg" the largest mailbox block the largest size recorded."""
    import torch
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    sizes = ((64, 60), (256, 30), (1024, 12)) if not rehearse \
        else ((16, 20), (32, 12))
    base = dict(rf=5, concurrency=24, megakernel=True, collect_log=True)

    def leg(dev, n, o, mail):
        t0 = time.perf_counter()
        rep, eng = run_mesh_burn(6, o, nodes=n, device=dev,
                                 device_messages=mail, **base)
        return rep, eng.snapshot(), time.perf_counter() - t0

    for n, o in sizes:                      # warm: captures happen here
        c0 = tk.CAPTURES["protocol_tick"]
        leg(device, n, o, True)
        leg(device, n, o, False)
        log(f"message_plane warm {n} nodes: "
            f"{tk.CAPTURES['protocol_tick'] - c0} graphs captured")
    if cuda:
        torch.cuda.synchronize()
    rows, recs_by_size = {}, {}
    tk.reset_launches()
    with recs["message_plane"]:
        for n, o in sizes:
            with Recorder(tk) as recs_by_size[n]:
                dev, snap, wall = leg(device, n, o, True)
            if cuda:
                torch.cuda.synchronize()
            c = dev.counters
            check(dev.lost == 0 and dev.acked == o,
                  f"message plane {n} nodes: lost or unacked")
            check(c["launches_per_tick"] == 1.0,
                  f"message plane {n} nodes: launches_per_tick "
                  f"{c['launches_per_tick']}")
            for k in ("mailbox_overflow_spills", "mailbox_verify_fallbacks"):
                check(c[k] == 0, f"message plane {n} nodes: {k} = {c[k]}")
            check(c["device_messages_delivered"] > 0,
                  f"message plane {n} nodes: nothing delivered from the "
                  "device")
            rows[n] = {"nodes": n, "ops": o, "wall_s": wall,
                       "committed_txn_per_s": dev.acked / wall,
                       "cluster_ticks": snap["cluster_ticks"],
                       "host_ms_per_tick":
                           wall * 1e3 / max(1, snap["cluster_ticks"]),
                       **{k: c[k] for k in (
                           "messages_per_host_callback",
                           "device_messages_delivered",
                           "mailbox_early_deliveries",
                           "mailbox_depth_high_water",
                           "mailbox_bytes_staged", "launches_per_tick")},
                       "log": dev.log}
    launches["message_plane"] = dict(tk.LAUNCHES)
    check(tk.CAPTURES["protocol_tick"] == 0
          and tk.CAPTURES["evictions"] == 0,
          f"message plane: {tk.CAPTURES['protocol_tick']} graphs captured, "
          f"{tk.CAPTURES['evictions']} evicted after the warm pass")
    if cuda:
        check(launches["message_plane"]["mailbox_route"] > 0,
              "message plane: K17 never ran in a replay")
    for n, o in sizes:
        host, hsnap, hwall = leg(device, n, o, False)
        check(host.log == rows[n]["log"],
              f"message plane {n} nodes: device-messages history != the "
              "host network's")
        rows[n]["host_network_wall_s"] = hwall
    n0, o0 = sizes[0]
    cpu, _snap, cwall = leg("cpu", n0, o0, True)
    check(cpu.log == rows[n0]["log"],
          f"message plane {n0} nodes: the card's history != the CPU's")
    log(f"message_plane: {n0}-node history equal on {device} and cpu "
        f"({cwall:.2f} s on the cpu)")
    logs = {}
    for n, _o in sizes:
        logs[n] = rows[n].pop("log")
        if cuda:
            args, kw = recs_by_size[n].get("protocol_tick")
            kw = dict(kw, mailbox=_fresh(kw["mailbox"]))
            out = tk.protocol_tick(*args, **kw)   # noqa: F841 (kept alive)
            rows[n]["ms_per_replay_largest_tick"] = time_ms(
                last_graph_replay(), 20, cuda)
        log(f"message_plane[{device}]: {json.dumps(rows[n])}")
    log(f"message_plane: launches {launches['message_plane']}")
    big = recs_by_size[sizes[-1][0]].get("mailbox_route")
    check(big is not None, "message plane: the largest leg routed nothing")
    return dict(rows, largest_leg=FixedCalls(mailbox_route=big), logs=logs)


def graft_leg(device: str, cuda: bool, tk, launches):
    """The graft entry's step on `device` (one path), (deps, levels)
    bit-equal to entry("cpu")'s; -> a Recorder holding its kernel calls."""
    import torch
    from accord_tpu_torch import graft_entry
    rec = Recorder(tk)
    step, args = graft_entry.entry(device)
    tk.reset_launches()
    with rec:
        deps, levels = step(*args)
    if cuda:
        torch.cuda.synchronize()
    launches["graft_entry"] = dict(tk.LAUNCHES)
    pstep, pargs = graft_entry.entry("cpu")
    pdeps, plevels = pstep(*pargs)
    check(torch.equal(deps.cpu(), pdeps) and torch.equal(levels.cpu(),
                                                         plevels),
          "graft entry: the card's (deps, levels) differ from the plain "
          "versions'")
    check(bool(pdeps.any()) and int(plevels.max()) > 0,
          "graft entry: vacuous")
    if cuda:
        for name in ("deps_matrix", "transitive_closure",
                     "execution_wavefronts"):
            check(launches["graft_entry"][name] == 1,
                  f"graft entry: kernel {name} did not launch once")
    log(f"graft_entry[{device}]: deps {int(pdeps.sum())} of "
        f"{pdeps.numel()}, depth {int(plevels.max())}; launches "
        f"{ {k: launches['graft_entry'][k] for k in DENSE_KERNELS} }")
    return rec


def _dag_words(n: int, device: str, seed: int):
    """bench.py's bench_dag adjacency, made on `device` from a
    torch.Generator: the AND of thin = round(log2(n/2/12)) random 32-bit
    draws (~12 deps a node), under the lower-triangular mask (node w
    depends only on d < w). i32[n, n/32]."""
    import numpy as np
    import torch
    from accord_tpu_torch.ops import kernels as tk
    words = n // 32
    thin = max(4, round(np.log2(n / 2 / 12)))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    adj = torch.full((n, words), -1, dtype=torch.int32, device=device)
    for _ in range(thin):
        adj &= torch.randint(-(1 << 31), 1 << 31, (n, words),
                             dtype=torch.int32, device=device,
                             generator=gen)
    w_idx = torch.arange(n, device=device)[:, None]
    j_idx = torch.arange(words, device=device)[None, :]
    full = (j_idx + 1) * 32 <= w_idx
    low = (torch.ones((), dtype=torch.int64, device=device)
           << (w_idx % 32)) - 1
    partial = torch.where(j_idx == w_idx // 32, tk._to_i32(low),
                          torch.zeros((), dtype=torch.int32, device=device))
    mask = torch.where(full, torch.full((), -1, dtype=torch.int32,
                                        device=device), partial)
    return adj & mask


def dense_batch_args(device: str, rehearse: bool):
    """The dense batch's inputs on `device`: deps_matrix's arguments at
    the PreAccept batch's shape (4,096 subjects of 1-4 keys, 16,384
    actives of 4 keys, 10,000 live, 1,024 buckets) and the N 8,192 DAG
    (bench_dag's generator) as bool[N, N] for K19 and K20."""
    import numpy as np
    import torch
    from accord_tpu_torch.ops import carry
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.ops.encoding import WITNESS_TABLE
    rng = np.random.default_rng(18)
    b, cap, k, live, nkeys = (4_096, 16_384, 1_024, 10_000, 1_000) \
        if not rehearse else (256, 1_024, 256, 600, 100)
    def bitmaps(rows, lo, hi):
        m = np.zeros((rows, k), np.float32)
        for r in range(rows):
            m[r, rng.integers(0, nkeys, rng.integers(lo, hi + 1)) % k] = 1
        return m
    sw = carry.packed(bitmaps(b, 1, 4), device)
    aw = carry.packed(bitmaps(cap, 4, 4), device)
    sb = np.stack([np.ones(b), rng.integers(0, live, b),
                   rng.integers(0, 7, b)], 1).astype(np.int32)
    ts = np.stack([np.ones(cap), np.arange(cap), np.arange(cap) % 7],
                  1).astype(np.int32)
    dm_args = (sw, torch.from_numpy(sb).to(device),
               torch.from_numpy(rng.integers(1, 3, b).astype(np.int32))
               .to(device), aw, torch.from_numpy(ts).to(device),
               torch.from_numpy(rng.integers(1, 3, cap).astype(np.int32))
               .to(device), torch.arange(cap, device=device) < live,
               torch.from_numpy(WITNESS_TABLE).to(device))
    n_mid = 8_192 if not rehearse else 512
    return dm_args, tk._unpack_bits(_dag_words(n_mid, device, 5))


def dense_legs(device: str, cuda: bool, rehearse: bool, tk, launches):
    """K18-K20 at a real size (FixedCalls, the graft path's batch) and the
    100k-node DAG (K21, its own path: counts zeroed before, read after),
    settled, bit-equal to the plain version on the card. Logs how many of
    K19's 13 squarings did work (the rest return at once)."""
    import torch
    dm_args, mid = dense_batch_args(device, rehearse)
    n_mid = mid.shape[0]
    batch = FixedCalls(deps_matrix=(dm_args, {}),
                       transitive_closure=((mid, 13), {}),
                       execution_wavefronts=((mid, 64), {}))
    out = tk.deps_matrix(*dm_args)
    check(bool(out.any()), "deps_matrix batch: vacuous")
    worked = torch.zeros(1, dtype=torch.int32, device=device)
    want = torch.zeros(1, dtype=torch.int32, device=device)
    tk.transitive_closure(mid, 13, worked=worked)
    tk.transitive_closure_plain(mid, 13, want)
    check(int(worked) == int(want), f"transitive_closure: {int(worked)} "
          f"squarings did work, the plain version counts {int(want)}")
    SUMMARY["closure_squarings_worked"] = int(worked)
    log(f"dense batch: deps_matrix {tuple(out.shape)} with "
        f"{int(out.sum())} deps; DAG N {n_mid} with {int(mid.sum())} edges; "
        f"transitive_closure(13): {int(worked)} squarings did work, "
        f"{13 - int(worked)} returned at once")
    # the 100k DAG: K21 on its own path
    n = 100_000 if not rehearse else 4_096
    levels = 192
    adj = _dag_words(n, device, 5)
    edges = int(tk._popcount_u32(adj).sum())
    rec = FixedCalls(dag_wavefronts_packed=((adj, levels), {}))
    tk.reset_launches()
    t0 = time.perf_counter()
    lv = tk.dag_wavefronts_packed(adj, levels)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["dag_100k"] = dict(tk.LAUNCHES)
    plain = tk.dag_wavefronts_packed_plain(adj, levels)
    check(torch.equal(lv, plain),
          "DAG: K21 differs from its plain version")
    depth, settled = int(lv.max()), bool((lv >= 0).all())
    check(settled, "DAG: not every node settled within 192 levels")
    if cuda:
        check(launches["dag_100k"]["dag_wavefronts_packed"] == 1,
              "DAG: K21 did not launch once")
    log(f"dag[{device}]: N {n} ({adj.numel() * 4 / 1e9:.3f} GB packed), "
        f"levels {levels}, depth {depth}, settled {settled}, edges "
        f"{edges}, first call {wall * 1e3:.3f} ms")
    return batch, rec


# -- the sharded deps data plane (accord_tpu_torch/parallel/mesh.py) --------
MESH_PY = "accord_tpu/parallel/mesh.py"
# the sharded entry points: (name, source, replaces, the path whose
# launches the entry reports)
SHARDED_FNS = (
    ("sharded_deps_resolve",
     "accord_tpu_torch/parallel/mesh.py (K1 csrc/deps_resolve.cu, K22 "
     "csrc/mesh_combine.cu)", MESH_PY + ":170", "sharded_key_burn"),
    ("sharded_range_deps_resolve",
     "accord_tpu_torch/parallel/mesh.py (K5 csrc/range_resolve.cu, K22)",
     MESH_PY + ":256", "sharded_range_burn"),
    ("sharded_fused_deps_resolve",
     "accord_tpu_torch/parallel/mesh.py (K1, K22)", MESH_PY + ":400",
     "sharded_key_burn"),
    ("sharded_fused_range_deps_resolve",
     "accord_tpu_torch/parallel/mesh.py (K5, K22)", MESH_PY + ":441",
     "sharded_range_burn"),
    ("sharded_finalize_csr",
     "accord_tpu_torch/parallel/mesh.py (K2 csrc/finalize_csr.cu, K22)",
     MESH_PY + ":663", "sharded_key_burn"),
    ("sharded_deps_step",
     "accord_tpu_torch/parallel/mesh.py (K18-K20 csrc/dense_dag.cu, K22)",
     MESH_PY + ":89", "sharded_dryrun"),
)
# each kernel wrapper a shard or a combining step launches: (LAUNCHES
# key, the recorded functions, source, replaces, path)
SHARD_WRAPPERS = (
    ("deps_resolve_shard", ("deps_resolve_shard",),
     "accord_tpu_torch/csrc/deps_resolve.cu",
     MESH_PY + ":184 (shard_map body; :329 fused)", "sharded_key_burn"),
    ("range_resolve_shard", ("range_block_shard", "range_key_shard"),
     "accord_tpu_torch/csrc/range_resolve.cu",
     MESH_PY + ":277 (shard_map body; :360 fused)", "sharded_range_burn"),
    ("finalize_shard", ("finalize_shard_count", "finalize_shard_compact"),
     "accord_tpu_torch/csrc/finalize_csr.cu",
     MESH_PY + ":570 (_sharded_finalize_body's shard part)",
     "sharded_key_burn"),
    ("or_fold", ("_or_fold_model",), "accord_tpu_torch/csrc/mesh_combine.cu",
     MESH_PY + ":200 (psum over 'model'; :111, :291, :351, :390)",
     "sharded_key_burn"),
    ("lane_concat", ("_concat_lane_blocks",),
     "accord_tpu_torch/csrc/mesh_combine.cu", MESH_PY + ":224",
     "sharded_key_burn"),
    ("counts_scan", ("_gather_counts",),
     "accord_tpu_torch/csrc/mesh_combine.cu",
     MESH_PY + ":609 (all_gather + prefix sums)", "sharded_key_burn"),
    ("fragment_merge", ("_sum_merge_fragments",),
     "accord_tpu_torch/csrc/mesh_combine.cu",
     MESH_PY + ":654 (fragment sum, dep_ts, checksum)", "sharded_key_burn"),
    ("deps_matrix_shard", ("deps_matrix_shard",),
     "accord_tpu_torch/csrc/dense_dag.cu", MESH_PY + ":106",
     "sharded_dryrun"),
    ("pack_rows", ("pack_rows",), "accord_tpu_torch/csrc/dense_dag.cu",
     MESH_PY + ":132 (the closure's bf16 cast)", "sharded_dryrun"),
    ("closure_rows", ("closure_rows",), "accord_tpu_torch/csrc/dense_dag.cu",
     MESH_PY + ":128", "sharded_dryrun"),
    ("wavefront_rows", ("wavefront_rows",),
     "accord_tpu_torch/csrc/dense_dag.cu", MESH_PY + ":144",
     "sharded_dryrun"),
)
SHARD_CALLS = tuple(f for _n, fns, *_ in SHARD_WRAPPERS for f in fns)
SHARDED_PATHS = ("sharded_key_burn", "sharded_range_burn",
                 "sharded_mesh_burn", "sharded_dryrun")


def _pairs(tk, sknd, kinds, sb, ts, valid, table, mine=None) -> int:
    """Subject x row pairs whose cheap masks pass (K1's bucket AND runs
    only there): witness, lex-before, valid (and the block's mine)."""
    nk = table.shape[0]
    w = table[tk._gather_index(sknd, nk)[:, None],
              tk._gather_index(kinds, nk)[None, :]] == 1
    m = w & tk._lex_before(ts[None], sb[:, None]) & valid[None]
    if mine is not None:
        m &= mine[:, None]
    return int(m.sum())


# the shard wrappers' output buffers, which a replay writes into clones of
OUT_PARAMS = ("out", "counts", "bound", "frag")
# a shard wrapper's plain version where it is not `<name>_plain`
PLAIN_OF = {"deps_matrix_shard": "deps_matrix_plain"}


def _mesh_fn(tk, pm, name: str):
    return getattr(pm if name.startswith("_") else tk, name)


def shard_replay(tk, pm, fn_name, args, kw):
    """(kernel thunk, plain thunk, the call's arguments by name) for a
    recorded shard-wrapper or combining-step call: the wrapper re-called
    with clones of its output buffers (so a replay leaves the recorded
    ones alone) and its plain version on the same inputs, each returning
    the outputs to compare (a wrapper that writes at out[:, col] gives
    that span; a bound-only finalize count, which has no counts, its
    bound)."""
    import inspect
    import torch
    fn = _mesh_fn(tk, pm, fn_name)
    plain = _mesh_fn(tk, pm, PLAIN_OF.get(fn_name, fn_name + "_plain"))
    bound = inspect.signature(fn).bind(*args, **kw)
    bound.apply_defaults()
    a = dict(bound.arguments)
    call = {k: v.clone() if k in OUT_PARAMS and torch.is_tensor(v) else v
            for k, v in a.items()}
    pargs = [a[k] for k in inspect.signature(plain).parameters]
    col = a.get("col")

    def kern():
        return fn(**call)

    def plain_fn():
        return plain(*pargs)

    def pair():
        k, p = kern(), plain_fn()
        if isinstance(k, tuple):
            keep = [i for i, x in enumerate(k) if x is not None]
            return tuple(k[i] for i in keep), tuple(p[i] for i in keep)
        if col is not None:
            k = k[:, col:col + p.shape[1]]
        return k, p
    return kern, plain_fn, pair, a


def shard_cost(tk, fn_name, a):
    """(bytes, ops) of a shard-wrapper or combining-step call by the
    table's rule: its inputs each read once (a finalize shard's blk and kid
    only by the rows its slots name, the merge's act_ts only where dep_rows
    points), its outputs each written once."""
    import torch
    ins = [v for k, v in a.items() if k not in OUT_PARAMS]
    if fn_name == "deps_resolve_shard":
        mine = None if a["subj_store"] is None \
            else a["subj_store"] == a["slot"]
        ops = 2 * _pairs(tk, a["subj_kinds"], a["kinds"], a["subj_before"],
                         a["ts"], a["valid"], a["witness_table"], mine) \
            * a["bm"].shape[1]
        out_b = a["subj_before"].shape[0] * a["bm"].shape[0] // 32 * 4
    elif fn_name == "range_block_shard":
        rows = a["r_start"].shape[0]
        ops = 4 * a["iv_of"].shape[0] * rows
        out_b = a["subj_before"].shape[0] * rows // 32 * 4
    elif fn_name == "range_key_shard":
        mine = a["subj_is_range"] if a["subj_store"] is None \
            else (a["subj_store"] == a["slot"]) & a["subj_is_range"]
        nwl = a["bm"].shape[1]
        ops = 2 * _pairs(tk, a["subj_kinds"], a["kinds"], a["subj_before"],
                         a["ts"], a["valid"], a["witness_table"], mine) \
            * nwl + 2 * a["iv_of"].shape[0] * nwl * 32
        out_b = a["subj_before"].shape[0] * a["bm"].shape[0] // 32 * 4
    elif fn_name in ("finalize_shard_count", "finalize_shard_compact"):
        kid, skid, ssub = a["kid"], a["slot_kid"], a["slot_subj"]
        kc, wl = kid.shape
        kids = torch.unique(skid[(skid >= 0) & (skid < kc)])
        ins = [ssub, skid, a["subj_row"]]
        if fn_name == "finalize_shard_count":
            out_b = 4 * ssub.shape[0] + 4
        else:
            ins.append(a["seg_base"])
            out_b = 4 * int(a["out_cap"])
        out_b += a["blk"].shape[0] * wl * 4 + kids.numel() * wl * 4
        ops = 3 * ssub.shape[0] * wl
    elif fn_name == "_or_fold_model":
        parts = a["parts"]
        data, _model, b, wl = parts.shape
        ops = parts.numel()
        out_b = b * data * wl * parts.element_size()
    elif fn_name == "_concat_lane_blocks":
        ops, out_b = 0, nbytes(a["blocks"])
    elif fn_name == "_gather_counts":
        counts = a["counts"]
        ops = 2 * counts.numel()
        out_b = 4 * (2 * counts.shape[1] + 2 + counts.numel())
    elif fn_name == "_sum_merge_fragments":
        frags = a["frags"]
        ins = [frags, a["indptr"]]
        ops = frags.numel()
        out_b = 16 * frags.shape[1] + 4 + 12 * frags.shape[1]
    elif fn_name == "deps_matrix_shard":
        ops, out_b = DEPS_MATRIX_OPS, a["out"].numel()
    elif fn_name == "pack_rows":
        ops, out_b = 0, nbytes(a["out"])
    elif fn_name == "closure_rows":
        full, row0 = a["full"], a["row0"]
        ops = int(tk._popcount_u32(full[row0:row0 + a["nrows"]]).sum()) \
            * full.shape[1]
        out_b = nbytes(a["out"])
    elif fn_name == "wavefront_rows":
        ops = int(tk._popcount_u32(a["p_rows"]).sum())
        out_b = nbytes(a["out"])
    else:
        raise SmokeFailure(f"no bound rule for {fn_name}")
    return nbytes(ins) + out_b, ops


def shard_wrapper_entries(tk, rec: Recorder, launches, cuda: bool,
                          iters: int) -> list:
    """One kernels-line entry per shard wrapper and combining step: each
    recorded function replayed (kernel vs plain, bit-equal, timed,
    bounded); the headline is its largest call."""
    import torch
    from accord_tpu_torch.parallel import mesh as pm
    entries = []
    for name, fns, source, replaces, path in SHARD_WRAPPERS:
        rows = []
        for fn_name in fns:
            got = rec.get(fn_name)
            check(got is not None, f"{name}: {fn_name} never called")
            kern, plain, pair, a = shard_replay(tk, pm, fn_name, *got)
            bytes_, ops = shard_cost(tk, fn_name, a)
            lib = (lambda: torch.cat(list(a["blocks"]), dim=1)) \
                if fn_name == "_concat_lane_blocks" else None
            err = max_abs_err(*pair())
            ms = time_ms(kern, iters, cuda)
            plain_ms = time_ms(plain, max(1, iters // 10), cuda)
            t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            row = {"call": fn_name, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": "bytes" if t_bytes >= t_ops
                   else "operations",
                   "share": bound_ms / ms if ms > 0 else None,
                   "bytes": bytes_, "ops": ops,
                   "library_ms": (time_ms(lib, iters, cuda)
                                  if lib is not None else None),
                   "input_mb": nbytes(got) / 1e6}
            log(f"  shard {name}: {json.dumps(row)}")
            check(err == 0, f"{name} ({fn_name}) disagrees with its plain "
                  "version")
            rows.append(row)
        head = max(rows, key=lambda r: r["input_mb"])
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[path][name],
            "path": path, "max_abs_err": 0, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            **({"library_call": "torch.cat of the blocks"}
               if name == "lane_concat" else {}),
            "call": head["call"], "calls": [_brief(r) for r in rows],
            "launches_by_path": {p: launches[p][name]
                                 for p in SHARDED_PATHS if p in launches}})
    return entries


def _pad_rows(t, rows: int, fill=0):
    """t with its leading dimension padded to `rows` with `fill`."""
    import torch
    if t.shape[0] >= rows:
        return t
    pad = torch.full((rows - t.shape[0], *t.shape[1:]), fill, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t, pad])


def _range_call(args, data: int):
    """A recorded single-store range_deps_resolve call with its range arena
    padded (invalid rows) to a multiple of 32 * data rows."""
    args = list(args)
    mult = 32 * data
    rcap = -(-args[6].shape[0] // mult) * mult
    for i in (6, 7, 8, 9, 10):
        args[i] = _pad_rows(args[i], rcap)
    return tuple(args)


def _step_inputs(pa_call, n: int):
    """The dense step's in-flight batch: the first n live rows of the
    PreAccept batch's recorded arena (bench.py's synthetic PreAccept batch:
    writes of 4 keys drawn from 1,000, 1,024 buckets) -> (packed words,
    ts, kinds, witness table)."""
    (_of, _keys, _sb, _sknd, bm, ts, kinds, valid, table), _kw = pa_call
    live = valid.nonzero().flatten()[:n]
    check(live.numel() == n, f"sharded_deps_step: the PreAccept arena has "
          f"{int(valid.sum())} live rows, fewer than {n}")
    return bm[live], ts[live], kinds[live], table


def _step_single(tk, args, iters: int, plain: bool = False):
    """K18 -> K19 -> K20 with `iters` rounds on one device (or their plain
    versions) -> (deps, levels)."""
    import torch
    words, ts, kinds, table = args
    valid = torch.ones(words.shape[0], dtype=torch.bool, device=words.device)
    if plain:
        deps = tk.deps_matrix_plain(words, ts, kinds, words, ts, kinds,
                                    valid, table)
        closed = tk.transitive_closure_plain(deps, iters)
        return deps, tk.execution_wavefronts_plain(closed, iters)
    deps = tk.deps_matrix(words, ts, kinds, words, ts, kinds, valid, table)
    closed = tk.transitive_closure(deps, iters)
    return deps, tk.execution_wavefronts(closed, iters)


STEP_ROUNDS = 4   # sharded_deps_step's closure and wavefront rounds


def _sharded_fn(pm, name: str, mesh, args):
    """The sharded entry point `name` built for `mesh` and these args'
    store counts."""
    if name == "sharded_deps_step":
        return pm.sharded_deps_step(mesh, STEP_ROUNDS)
    if name == "sharded_fused_deps_resolve":
        return pm.sharded_fused_deps_resolve(mesh, len(args[6]))
    if name == "sharded_fused_range_deps_resolve":
        return pm.sharded_fused_range_deps_resolve(mesh, len(args[8]),
                                                   len(args[10]))
    return getattr(pm, name)(mesh)


def sharded_fn_entries(tk, vmesh, real, batch, launches, cuda: bool,
                       iters: int) -> list:
    """Each sharded entry point at the batch's real size on the virtual
    mesh, bit-equal to the real mesh's call, the single-device kernel and
    the single-device plain version; timed beside the single-device
    kernel (`single_ms`); the bound is the single-device function's, by
    the table's rule."""
    from accord_tpu_torch.parallel import mesh as pm
    entries = []
    for name, source, replaces, path in SHARDED_FNS:
        (args, kw), single_name = batch[name]
        fns = {m: _sharded_fn(pm, name, m, args) for m in (vmesh, real)}

        def shard(m=vmesh, fns=fns, args=args, kw=kw):
            return fns[m](*args, **kw)
        if name == "sharded_deps_step":
            def single(plain=False):
                return _step_single(tk, args, STEP_ROUNDS, plain)

            def plain_fn():
                return single(True)
            deps, levels = single()
            b1, o1, _ = bound_inputs(tk, "deps_matrix", (
                args[0], args[1], args[2], args[0], args[1], args[2],
                None, args[3]), {}, deps)
            closed_ops = closure_ops(tk, deps, STEP_ROUNDS)
            r = tk.transitive_closure_plain(deps, STEP_ROUNDS)
            bytes_ = b1 + nbytes(levels)
            ops = o1 + closed_ops + STEP_ROUNDS * int(r.sum())
        else:
            def single(fn=getattr(tk, single_name)):
                return fn(*args, **kw)

            def plain_fn(fn=getattr(tk, single_name + "_plain")):
                return fn(*args, **kw)
            out = single()
            bytes_, ops, _ = bound_inputs(tk, single_name, args, kw, out)
        got = shard()
        err = max(max_abs_err(got, shard(real)), max_abs_err(got, single()),
                  max_abs_err(got, plain_fn()))
        check(err == 0, f"{name}: the virtual mesh's answer differs from "
              "the real mesh's, the single-device kernel's or the plain "
              "version's")
        ms = time_ms(shard, iters, cuda)
        real_ms = time_ms(lambda: shard(real), iters, cuda)
        single_ms = time_ms(single, iters, cuda)

        plain_ms = time_ms(plain_fn, max(1, iters // 10), cuda)
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[path][name],
            "path": path, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "share": bound_ms / ms if ms > 0 else None,
            "single_device": single_name or "deps_matrix -> "
            "transitive_closure -> execution_wavefronts",
            "single_ms": single_ms, "real_mesh_ms": real_ms,
            "input_mb": nbytes(args, kw) / 1e6,
            "launches_by_path": {p: launches[p][name]
                                 for p in SHARDED_PATHS if p in launches}}
        log(f"  sharded {name}: {json.dumps(entry)}")
        entries.append(entry)
    return entries


def sharded_phase(device: str, cuda: bool, rehearse: bool, tk, launches,
                  logs: dict, batch_recs: dict):
    """The sharded deps data plane (accord_tpu_torch/parallel/mesh.py):
    make_mesh() on the machine's cards, then the virtual 4 x 2 mesh
    make_mesh(devices=[card] * 8). Paths (counts zeroed before, read
    after): the key burn and the range-mix burn with ShardedBatchDepsResolver
    (the histories of the single-device card runs), the sharded merged
    mesh burn (the unsharded merged run's history, no mesh-tick fallback),
    the dry run's twin dryrun_multichip(8). Then sharded_deps_step on
    8,192 of the PreAccept arena's live rows (K 1,024), 4 rounds, and
    every entry point at the batches' real size against the real mesh,
    the single-device kernel and the plain version; every shard wrapper
    and combining step against its plain version. -> the kernels-line
    entries."""
    import torch
    from accord_tpu_torch.graft_entry import dryrun_multichip
    from accord_tpu_torch.parallel import mesh as pm
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    real = pm.make_mesh() if cuda else pm.make_mesh(devices=["cpu"])
    vmesh = pm.make_mesh(devices=[real.device(0, 0)] * 8)
    log(f"mesh: make_mesh() is data {real.shape['data']} x model "
        f"{real.shape['model']} on {real.devices}; the virtual mesh is data "
        f"{vmesh.shape['data']} x model {vmesh.shape['model']} on "
        f"{vmesh.device(0, 0)}")
    rec = Recorder(tk, names=SHARD_CALLS)
    with rec:
        # the key burn (the BASELINE rw-register cluster, 800 ops)
        ops = 800 if not rehearse else 120
        res = []
        tk.reset_launches()
        rep, wall = burn(device, ops, res, mesh=vmesh)
        if cuda:
            torch.cuda.synchronize()
        launches["sharded_key_burn"] = {**tk.LAUNCHES, **tk.ENTRY_LAUNCHES}
        stats = dict(clean(res), shard_merge_s=sum(
            float(r.shard_merge_s) for r in res))
        log(f"sharded_key_burn[{device}]: acked {rep.acked} in {wall:.2f} "
            f"s -> {rep.acked / wall:.1f} acked txn/s; {json.dumps(stats)}")
        check(rep.log == logs["key_burn"],
              "sharded key burn: the history differs from the single-device "
              "card run's and the CPU's")
        check(stats["finalized_decodes"] > 0 and stats["legacy_decodes"] == 0
              and stats["finalize_fallbacks"] == 0
              and stats["host_fallbacks"] == 0
              and stats["shard_merge_s"] > 0,
              f"sharded key burn: counters {stats}")
        check(tk.CAPTURES["protocol_tick"] == 0,
              "sharded key burn: a CUDA graph was captured")
        # the range-mix burn (bench_range_mix's config)
        rops = 400 if not rehearse else 60
        rres = []
        tk.reset_launches()
        rrep, rwall = range_mix_burn(device, rops, rres, mesh=vmesh)
        if cuda:
            torch.cuda.synchronize()
        launches["sharded_range_burn"] = {**tk.LAUNCHES, **tk.ENTRY_LAUNCHES}
        rstats = clean(rres)
        log(f"sharded_range_burn[{device}]: acked {rrep.acked} in "
            f"{rwall:.2f} s; {json.dumps(rstats)}")
        check(rrep.log == logs["range_burn"],
              "sharded range burn: the history differs from the "
              "single-device card run's")
        check(rrep.lost == 0 and rstats["host_fallbacks"] == 0
              and rstats["range_fallbacks"] == 0
              and rstats["checksum_mismatches"] == 0,
              f"sharded range burn: counters {rstats}")
        # the sharded merged mesh burn (the sweep's 64 nodes x 120 ops)
        n, o = (64, 120) if not rehearse else (16, 40)
        tk.reset_launches()
        t0 = time.perf_counter()
        srep, eng = run_mesh_burn(6, o, nodes=n, collect_log=True,
                                  sharded=True, mesh=vmesh)
        if cuda:
            torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        launches["sharded_mesh_burn"] = {**tk.LAUNCHES, **tk.ENTRY_LAUNCHES}
        snap = eng.snapshot()
        t0 = time.perf_counter()
        merged, meng = run_mesh_burn(6, o, nodes=n, collect_log=True,
                                     device=device)
        mwall = time.perf_counter() - t0
        mticks = max(1, meng.snapshot()["cluster_ticks"])
        log(f"sharded_mesh_burn[{device}]: {n} nodes x {o} ops, acked "
            f"{srep.acked} in {swall:.2f} s, {snap['cluster_ticks']} ticks, "
            f"{swall * 1e3 / max(1, snap['cluster_ticks']):.2f} host ms per "
            f"tick, node_lane_dispatches {snap['node_lane_dispatches']}; "
            f"the unsharded merged run {mwall:.2f} s, "
            f"{mwall * 1e3 / mticks:.2f} host ms per tick")
        SUMMARY["sharded_merged_host_ms_per_tick"] = \
            swall * 1e3 / max(1, snap["cluster_ticks"])
        check(srep.log == merged.log,
              "sharded mesh burn: the history differs from the unsharded "
              "merged run's")
        check(snap["mesh_tick_fallbacks"] == 0 and srep.lost == 0,
              "sharded mesh burn: mesh-tick fallbacks or lost txns")
        # the dry run's twin
        tk.reset_launches()
        dryrun_multichip(8, device=None if cuda else "cpu")
        if cuda:
            torch.cuda.synchronize()
        launches["sharded_dryrun"] = {**tk.LAUNCHES, **tk.ENTRY_LAUNCHES}
        # the step at the dense leg's size, on the PreAccept batch's rows
        n_step = 8_192 if not rehearse else 512
        step_args = _step_inputs(batch_recs["deps_resolve"], n_step)
        deps, levels = pm.sharded_deps_step(vmesh, STEP_ROUNDS)(*step_args)
        one = _step_single(tk, step_args, STEP_ROUNDS)
        check(max_abs_err((deps, levels), one) == 0,
              "sharded_deps_step: differs from K18 -> K19 -> K20")
        log(f"sharded_deps_step[{device}]: N {n_step}, {int(deps.sum())} "
            f"deps, depth {int(levels.max())}")
        batch = {
            "sharded_deps_resolve": (batch_recs["deps_resolve"],
                                     "deps_resolve"),
            "sharded_fused_deps_resolve": (batch_recs["fused_deps_resolve"],
                                           "fused_deps_resolve"),
            "sharded_range_deps_resolve": (batch_recs["range_deps_resolve"],
                                           "range_deps_resolve"),
            "sharded_fused_range_deps_resolve": (
                batch_recs["fused_range_deps_resolve"],
                "fused_range_deps_resolve"),
            "sharded_finalize_csr": (batch_recs["finalize_csr"],
                                     "finalize_csr"),
            "sharded_deps_step": ((step_args, {}), None)}
        for name, ((args, kw), _single) in batch.items():
            if name != "sharded_deps_step":   # its call ran above
                _sharded_fn(pm, name, vmesh, args)(*args, **kw)
    for path in SHARDED_PATHS:
        log(f"{path}: launches "
            f"{ {k: launches[path][k] for k in launches[path] if launches[path][k]} }")
    if cuda:
        for path, names in (
                ("sharded_key_burn", ("sharded_deps_resolve",
                                      "sharded_fused_deps_resolve",
                                      "sharded_finalize_csr",
                                      "deps_resolve_shard", "finalize_shard",
                                      "or_fold", "lane_concat",
                                      "counts_scan", "fragment_merge")),
                ("sharded_range_burn", ("sharded_fused_range_deps_resolve",
                                        "range_resolve_shard", "or_fold")),
                ("sharded_mesh_burn", ("sharded_fused_deps_resolve",
                                       "deps_resolve_shard", "or_fold",
                                       "lane_concat")),
                ("sharded_dryrun", ("sharded_deps_step",
                                    "sharded_deps_resolve",
                                    "deps_matrix_shard", "pack_rows",
                                    "closure_rows", "wavefront_rows",
                                    "or_fold"))):
            for name in names:
                check(launches[path][name] > 0,
                      f"{path}: {name} never launched")
        check(launches["sharded_mesh_burn"]["node_deps_resolve"] == 0,
              "sharded mesh burn: the unsharded K13 launched")
        check(launches["sharded_key_burn"]["deps_resolve"] == 0,
              "sharded key burn: the single-device K1 launched")
    iters = 20 if cuda else 1
    return (sharded_fn_entries(tk, vmesh, real, batch, launches, cuda, iters)
            + shard_wrapper_entries(tk, rec, launches, cuda, iters))


def sharded_batches(tk, data: int, pa_rec, pr_rec, range_rec):
    """The sharded entry points' real-size inputs, from recorded calls:
    the 10k PreAccept batch's K1 and K2 calls (bench.py:53-62's shape:
    10,000 live rows in cap 16,384, 1,024 buckets), as one store and as
    two stores; the range batch's K5 call (1,024 range writes, 20% range
    subjects) and the range-mix burn's, its range arena padded with
    invalid rows to a multiple of 32 * data; as two stores each side."""
    import torch
    out = {}
    args, kw = pa_rec.get("deps_resolve")
    out["deps_resolve"] = (args, kw)
    of, keys, sb, sknd, bm, ts, kinds, valid, table = args
    b = sb.shape[0]
    store = (torch.arange(b, device=sb.device) % 2).to(torch.int32)
    slots = torch.arange(2, dtype=torch.int32, device=sb.device)
    out["fused_deps_resolve"] = ((of, keys, store, sb, sknd, slots,
                                  ((bm, ts, kinds, valid),) * 2, table), {})
    out["finalize_csr"] = pa_rec.get("finalize_csr")
    rng_calls = [c for c in (pr_rec.get("range_deps_resolve"),
                             range_rec.get("range_deps_resolve"))
                 if c is not None]
    check(rng_calls, "sharded: no recorded range_deps_resolve call")
    rargs = _range_call(rng_calls[0][0], data)
    out["range_deps_resolve"] = (rargs, {})
    (iv_of, iv_s, iv_e, sb, sknd, srng, *rar) = rargs[:11]
    kar = rargs[11:15]
    table = rargs[15]
    b = sb.shape[0]
    store = (torch.arange(b, device=sb.device) % 2).to(torch.int32)
    slots = torch.arange(2, dtype=torch.int32, device=sb.device)
    out["fused_range_deps_resolve"] = ((
        iv_of, iv_s, iv_e, store, sb, sknd, srng, slots, (tuple(rar),) * 2,
        slots, (tuple(kar),) * 2, table), {})
    return out


# -- the sharded protocol megakernel (parallel/mesh.sharded_protocol_tick) ---
MAILBOX_PY = "accord_tpu/ops/mailbox.py"
# its kernels-line entries: (name, source, replaces, the path whose
# launches the entry reports)
SHARDED_MEGA = (
    ("sharded_protocol_tick",
     "accord_tpu_torch/ops/tick_graph.py + csrc/tick_graph.cu (one CUDA "
     "graph a tick: csrc/node_resolve.cu, finalize_csr.cu, mesh_combine.cu,"
     " mailbox_shard.cu and the replicated stages' kernels)",
     MESH_PY + ":821 (builder :683)", "sharded_mega_sweep"),
    ("node_key_shard", "accord_tpu_torch/csrc/node_resolve.cu",
     MESH_PY + ":718 (kpart: _fused_key_resolve_blocks in shard_map)",
     "sharded_mega_sweep"),
    ("node_range_shard", "accord_tpu_torch/csrc/node_resolve.cu",
     MESH_PY + ":737 (rpart: _fused_range_resolve_blocks in shard_map)",
     "sharded_mega_range"),
    ("finalize_shard_tab", "accord_tpu_torch/csrc/finalize_csr.cu",
     MESH_PY + ":779 (_sharded_finalize_body in the tick)",
     "sharded_mega_sweep"),
    ("sharded_mailbox_route", "accord_tpu_torch/csrc/mailbox_shard.cu",
     MAILBOX_PY + ":100", "sharded_message_plane"),
)
SHARDED_MEGA_PATHS = ("sharded_warmup", "sharded_mega_sweep",
                      "sharded_mega_range", "sharded_message_plane")


def _bound_row(ms, plain_ms, bytes_, ops, err, **extra) -> dict:
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share": bound_ms / ms if ms and ms > 0 else None,
            "bytes": bytes_, "ops": ops, "library_ms": None, **extra}


def _shard_mail_block(S: int, npsh: int, depth: int, w: int, bcap: int,
                      seed: int = 23):
    """A sharded mailbox block at a full tier, as host arrays: every
    segment (s, t) 3/4 full of lanes from shard s's nodes to shard t's, on
    distinct rings, with links cut between shards (K23's widest case)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rows_nodes, L = npsh * S, S * S * bcap
    part = np.zeros((rows_nodes, rows_nodes), bool)
    for a in range(1, rows_nodes, 7):
        b = (a + npsh) % rows_nodes
        part[a, b] = part[b, a] = True
    src, dst, slot, kind, seq = (np.zeros(L, np.int32) for _ in range(5))
    keep = np.zeros(L, bool)
    words = np.zeros((L, w), np.int32)
    used = set()
    for s in range(S):
        for t in range(S):
            for j in range(bcap * 3 // 4):
                q = (s * S + t) * bcap + j
                d = int(rng.integers(t * npsh, (t + 1) * npsh))
                sl = int(rng.integers(0, depth))
                if (d, sl) in used:
                    continue
                used.add((d, sl))
                src[q] = int(rng.integers(s * npsh, (s + 1) * npsh))
                dst[q], slot[q], keep[q] = d, sl, True
                kind[q], seq[q] = rng.integers(1, 9), rng.integers(0, 1 << 30)
                words[q] = rng.integers(-(1 << 31), 1 << 31, w)
    arena = np.zeros((rows_nodes * depth, w), np.int32)
    meta = np.zeros((rows_nodes * depth, 3), np.int32)
    return (arena, meta, src, dst, slot, keep, kind, seq, words, part)


def _k23_row(mb, S: int, block, device: str, cuda: bool, iters: int):
    """K23 standalone on one mailbox block: kernel vs plain (each on its
    own copy of the arena and meta), timed, bounded (every lane's small
    fields and part entry read once, a landed lane's words read once and
    written to its ring row once with its meta, the gather-back written
    once)."""
    args = _on(block, device)
    lanes = args[2:9]

    def kern(fresh=True):
        # timed in place: routing the same lanes again rewrites the same rows
        return mb.sharded_mailbox_route(S, *(_fresh(args) if fresh
                                             else args))

    def plain():
        a, m = _fresh(args)[:2]
        return (a, m) + mb.sharded_mailbox_route_plain(
            S, mb.shard_parts(a, S), mb.shard_parts(m, S), *lanes,
            mb.shard_parts(args[9], S))[2:]
    out = kern()
    err = max_abs_err(out, plain())
    ms = time_ms(lambda: kern(False), iters, cuda)
    plain_ms = time_ms(plain, max(1, iters // 10), cuda)
    L, w = lanes[6].shape
    landed = int(out[4].sum())
    small = nbytes(*lanes[:6]) + L
    extra = {}
    if cuda:
        # the host's enqueue left out: 100 calls in one CUDA graph
        extra["device_ms"] = graph_ms(lambda: kern(False))
    return _bound_row(ms, plain_ms, small + 2 * landed * (w * 4 + 12)
                      + nbytes(out[2:]), 0, err, lanes=L, words=w,
                      landed=landed, input_mb=nbytes(args) / 1e6, **extra)


def sharded_mega_phase(device: str, cuda: bool, rehearse: bool, tk,
                       launches, prev: dict) -> list:
    """The sharded protocol megakernel (parallel/mesh.sharded_protocol_tick:
    one CUDA graph replay a tick on a card) on make_mesh() (1 x 1 on one
    H100, where the mailbox keeps the single-device layout) and the
    virtual 4 x 2 mesh make_mesh(devices=[card] * 8):
      a. warmup_sharded (timed; a second call captures nothing);
      b. the 10k merged tick: both meshes' outputs bit-equal to the
         single-device replay's, replay ms beside it; the key stage alone
         and with the finalizes, against their plain versions;
      c. the sharded megakernel sweep (seed 6; 64 x 120, 256 x 50) after a
         warm pass: each history the single-device megakernel's (and at 64
         nodes the per-node loop's), launches_per_tick 1.0, one replay per
         fused dispatch, zero sharded-megakernel fallbacks, no capture
         or eviction (kernels.CAPTURES; jit_cache_sizes unchanged); host
         ms per tick beside the
         single-device megakernel's and the sharded merged run's; the
         key+range leg (K14's shard tables) and the exec-in-megakernel leg
         (the exec-only flush through the mesh), each the single-device
         history;
      d. the sharded message plane (bench_message_plane: seed 6, rf 5,
         concurrency 24; 64 x 60, 256 x 30), device_messages=True: each
         history the host network's, zero spills, verify and sharded
         fallbacks, no capture, messages per host callback;
      e. the reference's MULTICHIP legs (bench.py:1662-1700, :1860-1895)
         with the capture gate in place of its compile count;
      f. K23 on the 256-node leg's largest mailbox block and at the
         1,024-lane tier (W 384) against its plain version.
    -> the kernels-line entries."""
    import torch
    from accord_tpu_torch.ops import mailbox as mb
    from accord_tpu_torch.ops import node_lane as nl
    from accord_tpu_torch.parallel import mesh as pm
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    real = pm.make_mesh() if cuda else pm.make_mesh(devices=["cpu"])
    vmesh = pm.make_mesh(devices=[real.device(0, 0)] * 8)
    iters = 20 if cuda else 1
    rows = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def burn(seed, ops, mesh, **kw):
        t0 = time.perf_counter()
        rep, eng = run_mesh_burn(seed, ops, collect_log=True,
                                 sharded=mesh is not None, mesh=mesh,
                                 device=None if mesh is not None else device,
                                 **kw)
        sync()
        return rep, eng.snapshot(), time.perf_counter() - t0

    def gate_fused(what, snap):
        check(snap["megakernel_dispatches"] > 0
              and snap["launches_per_tick"] == 1.0
              and snap["sharded_megakernel_fallbacks"] == 0
              and snap["mesh_tick_fallbacks"] == 0,
              f"{what}: dispatches {snap['megakernel_dispatches']}, "
              f"launches_per_tick {snap['launches_per_tick']}, sharded "
              f"fallbacks {snap['sharded_megakernel_fallbacks']}")

    def replay_ms(call):
        """The replay of the graph `call` (a sharded_protocol_tick)
        replayed last, its outputs kept alive; on the CPU the call."""
        out = call()
        sync()
        if not cuda:
            return time_ms(call, iters, cuda), out
        return time_ms(last_graph_replay(), iters, cuda), out

    def no_capture(what, cache):
        """The gate of a timed window opened by tk.reset_launches(): no
        sharded or single-device graph captured and none evicted in it,
        and the held graphs unchanged."""
        check(tk.CAPTURES["sharded_protocol_tick"] == 0
              and tk.CAPTURES["protocol_tick"] == 0
              and tk.CAPTURES["evictions"] == 0
              and tk.jit_cache_sizes() == cache,
              f"{what}: graphs captured or evicted after warmup "
              f"({json.dumps(tk.CAPTURES)})")

    # a. warmup_sharded: timed and its captures counted here (it is a loop
    # of captures, each graph held against its plain version below, not a
    # kernel of its own: it is on no kernels-line entry)
    wkw = dict(num_buckets=128, cap=4096 if not rehearse else 512,
               batch_tiers=(8, 64), nnz_tiers=(32, 256), store_tiers=(1, 2),
               out_tiers=(256,), mega_quorum_sizes=(2, 3), exec_tiers=(32,))
    tk.reset_launches()
    t0 = time.perf_counter()
    pm.warmup_sharded(vmesh, **wkw)
    sync()
    warm = {"call": "warmup_sharded(virtual 4 x 2 mesh)",
            "ms": (time.perf_counter() - t0) * 1e3,
            "graphs_captured": tk.CAPTURES["sharded_protocol_tick"],
            "launches": sum(tk.LAUNCHES.values())}
    launches["sharded_warmup"] = {**tk.LAUNCHES, **tk.ENTRY_LAUNCHES}
    pm.warmup_sharded(real, **wkw)
    cache0 = tk.jit_cache_sizes()
    tk.reset_launches()
    t0 = time.perf_counter()
    pm.warmup_sharded(vmesh, **wkw)
    sync()
    warm["again_ms"] = (time.perf_counter() - t0) * 1e3
    no_capture("warmup_sharded: a second call", cache0)
    t0 = time.perf_counter()
    pm.warmup_sharded(pm.make_mesh(devices=["cpu"] * 8), **wkw)
    warm["cpu_mesh_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"sharded warmup[{device}]: {json.dumps(warm)}")

    # b. the 10k merged tick
    (wt,), kw = prev["tick_10k"]["args"]
    single_ms, single = replay_ms(lambda: tk.protocol_tick(wt, **kw))
    tick = {"single_device_replay_ms": single_ms}
    for label, m in (("virtual", vmesh), ("real", real)):
        ms, got = replay_ms(lambda m=m: pm.sharded_protocol_tick(m, wt, **kw))
        err = max_abs_err(got, single)
        check(err == 0, f"10k tick on the {label} mesh: the sharded program "
              f"differs from the single-device replay (err {err})")
        tick[f"{label}_replay_ms"] = ms
        tick[f"{label}_call_ms"] = time_ms(
            lambda m=m: pm.sharded_protocol_tick(m, wt, **kw), iters, cuda)
    key_in, fins = kw["key_in"], kw["fins"]
    dkey = _on(key_in, device)
    key_ms, kout = replay_ms(
        lambda: pm.sharded_protocol_tick(vmesh, wt, key_in=key_in))
    kplain = nl.node_fused_deps_resolve_plain(*dkey, wt)
    kb, ko, _ = bound_inputs(tk, "node_fused_deps_resolve", (*dkey, wt), {},
                             kout[0])
    rows["node_key_shard"] = _bound_row(
        key_ms, time_ms(lambda: nl.node_fused_deps_resolve_plain(*dkey, wt),
                        max(1, iters // 10), cuda),
        kb, ko, max_abs_err(kout[0], kplain),
        call="the 10k tick's key stage alone (one replay: 2 subject "
        "passes, 1,024 shard entries in one launch, the 'model' fold)")
    if cuda:
        # a replay is device time; the parent's key body beside it
        from accord_tpu_torch.tools import deps_block_variants as dbv
        pair = dbv.replay_pair(
            lambda: pm.sharded_protocol_tick(vmesh, wt, key_in=key_in),
            lambda o: o[0])
        check(pair["bit_equal"], "sharded 10k tick: the parent's key body "
              "answers differently")
        rows["node_key_shard"].update(device_ms=key_ms, parent_vs_new=pair)
        PARENT_VS_NEW["node_key_shard_10k_key_stage"] = pair
    kf_ms, fout = replay_ms(lambda: pm.sharded_protocol_tick(
        vmesh, wt, key_in=key_in, fins=fins))

    def fin_args(f):
        return (tk._window(kplain, f[1], f[2], f[3], f[4]), f[5], *f[6:11])

    def fins_plain():
        return tuple(tk.finalize_csr_plain(*fin_args(f), f[11])
                     for f in fins)
    fplain = fins_plain()
    fb = fo = 0
    for f, o in zip(fins, fplain):
        b_, o_, _ = bound_inputs(tk, "finalize_csr", fin_args(f),
                                 {"out_cap": f[11]}, o)
        fb, fo = fb + b_, fo + o_
    rows["finalize_shard_tab"] = _bound_row(
        kf_ms - key_ms, time_ms(fins_plain, 1, cuda), fb, fo,
        max(max_abs_err(fout[0], kplain), max_abs_err(fout[2], fplain)),
        call=f"the 10k tick's {len(fins)} key finalizes (the replay with "
        "them less the key stage's alone)", replay_with_key_ms=kf_ms)
    log(f"sharded 10k tick[{device}]: {json.dumps(tick)}")
    check(rows["node_key_shard"]["max_abs_err"] == 0
          and rows["finalize_shard_tab"]["max_abs_err"] == 0,
          "10k tick: a graph-form stage differs from its plain version")

    # c. the sharded megakernel sweep
    sizes = ((64, 120), (256, 50)) if not rehearse else ((16, 40), (32, 16))
    n0, o0 = sizes[0]
    for n, o in sizes:
        burn(6, o, vmesh, nodes=n, megakernel=True)
    burn(6, o0, real, nodes=n0, megakernel=True)
    cache1 = tk.jit_cache_sizes()
    tk.reset_launches()
    rec = Recorder(tk, names=("sharded_protocol_tick",))
    fused = 0
    sweep = {}
    with rec:
        for n, o in sizes:
            rep, snap, wall = burn(6, o, vmesh, nodes=n, megakernel=True)
            gate_fused(f"sharded sweep {n} nodes", snap)
            check(rep.log == prev["sweep_logs"][(n, "mega")],
                  f"sharded sweep {n} nodes: history != the single-device "
                  "megakernel's")
            if n == n0:
                check(rep.log == prev["sweep_logs"][(n, "loop")],
                      f"sharded sweep {n} nodes: history != the per-node "
                      "loop's")
            fused += snap["megakernel_dispatches"]
            hms = wall * 1e3 / max(1, snap["cluster_ticks"])
            sweep[n] = {"nodes": n, "ops": o, "wall_s": wall,
                        "committed_txn_per_s": rep.acked / wall,
                        "cluster_ticks": snap["cluster_ticks"],
                        "host_ms_per_tick": hms,
                        "single_device_mega_host_ms_per_tick":
                            prev["sweep_rows"][f"mega_{n}"][
                                "host_ms_per_tick"],
                        "launches_per_tick": snap["launches_per_tick"]}
            if n == n0:
                sweep[n]["sharded_merged_host_ms_per_tick"] = \
                    SUMMARY.get("sharded_merged_host_ms_per_tick")
            log(f"sharded sweep[{device}]: {json.dumps(sweep[n])}")
    launches["sharded_mega_sweep"] = {**tk.LAUNCHES, **tk.ENTRY_LAUNCHES}
    rep, snap, wall = burn(6, o0, real, nodes=n0, megakernel=True)
    gate_fused("sharded sweep on make_mesh()", snap)
    check(rep.log == prev["sweep_logs"][(n0, "mega")],
          "sharded sweep on make_mesh(): history != the single-device one")
    sweep["real_mesh"] = {"nodes": n0, "wall_s": wall, "host_ms_per_tick":
                          wall * 1e3 / max(1, snap["cluster_ticks"])}
    no_capture("sharded sweep (after warmup_sharded and the warm pass)",
               cache1)
    if cuda:
        ls = launches["sharded_mega_sweep"]
        check(ls["sharded_protocol_tick"] == fused > 0,
              f"sharded sweep: {ls['sharded_protocol_tick']} replays for "
              f"{fused} fused dispatches")
        for name in ("node_key_shard", "or_fold", "finalize_shard_tab",
                     "counts_scan", "fragment_merge"):
            check(ls[name] > 0, f"sharded sweep: {name} never ran in a "
                  "replay")
        check(ls["protocol_tick"] == 0 and ls["node_deps_resolve"] == 0,
              "sharded sweep: the single-device program ran")
    # the sweep's largest tick: the graph against the plain program
    (mesh_a, wt_a), tkw = rec.get("sharded_protocol_tick")
    s_ms, s_out = replay_ms(lambda: pm.sharded_protocol_tick(
        mesh_a, wt_a, **tkw))
    dkw = _on(tkw, device)
    s_plain = tk.protocol_tick_plain(wt_a, **dkw)
    sb_, so_, _ = tick_bound(tk, (wt_a,), dkw, s_out)
    rows["sharded_protocol_tick"] = _bound_row(
        s_ms, time_ms(lambda: tk.protocol_tick_plain(wt_a, **dkw),
                      max(1, iters // 10), cuda),
        sb_, so_, max_abs_err(s_out, s_plain),
        call=f"the {sizes[-1][0]}-node sweep's largest tick",
        call_ms=time_ms(lambda: pm.sharded_protocol_tick(mesh_a, wt_a,
                                                         **tkw),
                        iters, cuda),
        tick_10k=tick, sweep=sweep, warmup=warm)
    check(rows["sharded_protocol_tick"]["max_abs_err"] == 0,
          "sharded sweep: the largest tick's replay differs from the plain "
          "program")
    # the key+range leg and the exec leg
    kr = dict(nodes=4, range_read_ratio=0.2, range_write_ratio=0.1,
              megakernel=True)
    burn(9, 40, vmesh, **kr)
    tk.reset_launches()
    ticks, orig = [], pm.sharded_protocol_tick

    def keep(*a, **k):        # every tick with a range stage, kept alive
        if k.get("rng_in") is not None:
            ticks.append((a, k))
        return orig(*a, **k)
    pm.sharded_protocol_tick = keep
    try:
        rrep, rsnap, _ = burn(9, 40, vmesh, **kr)
    finally:
        pm.sharded_protocol_tick = orig
    launches["sharded_mega_range"] = {**tk.LAUNCHES, **tk.ENTRY_LAUNCHES}
    gate_fused("sharded key+range leg", rsnap)
    check(rrep.log == burn(9, 40, None, **kr)[0].log,
          "sharded key+range leg: history != the single-device megakernel's")
    if cuda:
        check(launches["sharded_mega_range"]["node_range_shard"] > 0,
              "sharded key+range leg: K14's shard table never ran")
    check(ticks, "sharded key+range leg: no tick had a range stage")
    (mesh_r, wt_r), rkw_ = max(ticks, key=lambda t: sum(
        len(x) for x in (t[1]["rng_in"][8], t[1]["rng_in"][10])))
    drng = _on(rkw_["rng_in"], device)
    r_ms, r_out = replay_ms(lambda: pm.sharded_protocol_tick(
        mesh_r, wt_r, rng_in=rkw_["rng_in"]))
    rb_, ro_, _ = bound_inputs(tk, "node_fused_range_deps_resolve",
                               (*drng, wt_r), {}, r_out[1])
    rows["node_range_shard"] = _bound_row(
        r_ms, time_ms(lambda: nl.node_fused_range_deps_resolve_plain(
            *drng, wt_r), max(1, iters // 10), cuda), rb_, ro_,
        max_abs_err(r_out[1], nl.node_fused_range_deps_resolve_plain(
            *drng, wt_r)),
        call="the key+range leg's largest tick's range stage alone (one "
        "replay: the range shard table and the gated key shard table)")
    check(rows["node_range_shard"]["max_abs_err"] == 0,
          "sharded key+range leg: the range stage differs from its plain "
          "version")
    if cuda:
        # the parent's range shard beside it (tools/range_block_variants)
        from accord_tpu_torch.tools import range_block_variants as rbv
        pair = rbv.replay_pair(lambda: pm.sharded_protocol_tick(
            mesh_r, wt_r, rng_in=rkw_["rng_in"]), lambda r: r[1])
        check(pair["bit_equal"], "sharded key+range leg: the parent's "
              "range shard answers differently")
        rows["node_range_shard"]["parent_vs_new"] = pair
        RANGE_VS_PARENT["sharded_range_stage"] = pair
    base = dict(nodes=4, rf=3, stores_per_node=2, key_count=24,
                concurrency=8, exec_plane=True, exec_compact=True,
                exec_in_megakernel=True, megakernel=True)
    ex, esnap, _ = burn(13, 40, vmesh, **base)
    gate_fused("sharded exec leg", esnap)
    check(ex.log == burn(13, 40, None, **base)[0].log
          and esnap["exec_scan_blocks"] > 0,
          "sharded exec leg: history != the single-device one, or no exec "
          "block")
    log(f"sharded legs[{device}]: key+range {json.dumps(rsnap)}; exec "
        f"{json.dumps(esnap)}")

    # d. the sharded message plane
    msizes = ((64, 60), (256, 30)) if not rehearse else ((16, 20), (32, 12))
    mbase = dict(rf=5, concurrency=24, megakernel=True, device_messages=True)
    for n, o in msizes:
        burn(6, o, vmesh, nodes=n, **mbase)
    burn(6, msizes[0][1], real, nodes=msizes[0][0], **mbase)
    cache2 = tk.jit_cache_sizes()
    tk.reset_launches()
    mrec = Recorder(tk, names=("sharded_protocol_tick",))
    plane = {}
    with mrec:
        for n, o in msizes:
            rep, snap, wall = burn(6, o, vmesh, nodes=n, **mbase)
            gate_fused(f"sharded message plane {n} nodes", snap)
            c = rep.counters
            check(rep.log == prev["mail_logs"][n],
                  f"sharded message plane {n} nodes: history != the host "
                  "network's")
            for k in ("mailbox_overflow_spills", "mailbox_verify_fallbacks"):
                check(c[k] == 0, f"sharded message plane {n} nodes: {k} = "
                      f"{c[k]}")
            check(c["device_messages_delivered"] > 0,
                  f"sharded message plane {n} nodes: nothing delivered")
            plane[n] = {"nodes": n, "ops": o, "wall_s": wall,
                        "host_ms_per_tick":
                            wall * 1e3 / max(1, snap["cluster_ticks"]),
                        **{k: c[k] for k in (
                            "messages_per_host_callback",
                            "device_messages_delivered",
                            "mailbox_depth_high_water")}}
            log(f"sharded message plane[{device}]: {json.dumps(plane[n])}")
    launches["sharded_message_plane"] = {**tk.LAUNCHES, **tk.ENTRY_LAUNCHES}
    rep, snap, _ = burn(6, msizes[0][1], real, nodes=msizes[0][0], **mbase)
    gate_fused("sharded message plane on make_mesh()", snap)
    check(rep.log == prev["mail_logs"][msizes[0][0]],
          "sharded message plane on make_mesh(): history differs")
    no_capture("sharded message plane (after the warm pass)", cache2)
    if cuda:
        check(launches["sharded_message_plane"]["sharded_mailbox_route"] > 0,
              "sharded message plane: K23 never ran in a replay")

    # e. the reference's MULTICHIP legs
    mc = {}
    rkw = dict(nodes=4, resolver_kwargs=dict(num_buckets=256,
                                             initial_cap=512))
    burn(6, 40, vmesh, megakernel=True, **rkw)
    burn(6, 40, vmesh, mesh_tick=False, **rkw)
    c3 = tk.jit_cache_sizes()
    tk.reset_launches()
    sh, ssnap, _ = burn(6, 40, vmesh, megakernel=True, **rkw)
    lp = burn(6, 40, vmesh, mesh_tick=False, **rkw)[0]
    gate_fused("MULTICHIP megakernel leg", ssnap)
    check(sh.log == lp.log,
          "MULTICHIP megakernel leg: history != the sharded loop's")
    no_capture("MULTICHIP megakernel leg", c3)
    mc["megakernel"] = {k: ssnap[k] for k in (
        "megakernel_dispatches", "launches_per_tick",
        "sharded_megakernel_fallbacks")}
    mkw = dict(nodes=16, rf=5, concurrency=32, megakernel=True)
    burn(6, 50, vmesh, device_messages=True, **mkw)
    burn(6, 50, vmesh, **mkw)
    c4 = tk.jit_cache_sizes()
    tk.reset_launches()
    dev, dsnap, _ = burn(6, 50, vmesh, device_messages=True, **mkw)
    host = burn(6, 50, vmesh, **mkw)[0]
    c = dev.counters
    gate_fused("MULTICHIP message leg", dsnap)
    no_capture("MULTICHIP message leg", c4)
    check(dev.log == host.log
          and c["mailbox_overflow_spills"] == 0
          and c["mailbox_verify_fallbacks"] == 0
          and c["device_messages_delivered"] > 0
          and c["messages_per_host_callback"] >= 10.0,
          f"MULTICHIP message leg: {json.dumps(c)}")
    mc["message"] = {k: c[k] for k in ("launches_per_tick",
                                       "messages_per_host_callback",
                                       "device_messages_delivered")}
    log(f"sharded MULTICHIP legs[{device}]: {json.dumps(mc)}")

    # f. K23 standalone: the 256-node leg's largest block, the 1,024 tier
    big = mrec.get("sharded_mailbox_route")
    check(big is not None, "sharded message plane: no mailbox block")
    S = vmesh.shape["data"]
    k23 = _k23_row(mb, S, big[0], device, cuda, iters)
    k23["call"] = "the sharded message plane's largest mailbox block"
    n_big = msizes[-1][0]
    k23["lanes_1024"] = _k23_row(
        mb, S, _shard_mail_block(S, -(-(n_big + 1) // S), 64, 384, 64),
        device, cuda, iters)
    check(k23["max_abs_err"] == 0 and k23["lanes_1024"]["max_abs_err"] == 0,
          "K23 disagrees with its plain version")
    rows["sharded_mailbox_route"] = dict(k23, plane=plane, multichip=mc)
    log(f"K23[{device}]: {json.dumps(k23)}")

    entries = []
    for name, source, replaces, path in SHARDED_MEGA:
        row = rows[name]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[path][name],
            "path": path, **row,
            "launches_by_path": {p: launches[p].get(name, 0)
                                 for p in SHARDED_MEGA_PATHS}})
        if cuda:
            check(launches[path][name] > 0, f"{path}: {name} never launched")
    return entries


def _brief(row: dict) -> dict:
    return {k: row[k] for k in ("call", "ms", "plain_ms", "bound_ms",
                                "bound_by", "share", "library_ms",
                                "op_tier", "ms_per_op", "device_ms",
                                "library_device_ms", "library_chain_ms",
                                "library_chain_device_ms", "specs")
            if k in row}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rehearse = "--rehearse" in argv
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import accord_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from the repository root", file=sys.stderr)
        return 1
    try:
        res = run(rehearse)
    except Exception as e:  # noqa: BLE001 -- every phase failure fails
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    if rehearse:
        print("chip_smoke: rehearsal on the CPU finished; no result",
              file=sys.stderr)
        return 3
    log(json.dumps({"parent_vs_new": res["parent_vs_new"]}))
    log(res["card"])
    log(json.dumps({"kernels": res["entries"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
