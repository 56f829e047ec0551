"""Time the sharded tick's key stage (ops/tick_graph.py `_stage_key_shard`:
the single-device stage, K1's subject pass and ONE node_key_resolve launch
over K13's block table, which reads a row's bucket words whole -- every
'model' slice folded in the launch -- and writes the tick's output in
place) and K17 (csrc/mailbox_route.cu: the
scatter and the gather-back in ONE launch) beside their parents, on the
same card in the same process.

The parents build alone (nvcc, seconds: plain C interfaces), both files
at once:
  tools/sharded_key_parent.cu    the parent's node_key_shard: a KeyShard
                                 entry per (block, 'data', 'model' shard),
                                 each writing its 'model' partial;
                                 `parent_key_stage()` puts the parent's
                                 graph stage in place of the shipped one
                                 (a subject pass a 'model' slice, that
                                 launch into fixed memory, K22's or_fold
                                 into a fixed-memory result, scattered to
                                 the tick's buffer by the graph's last
                                 table_copy)
  tools/mailbox_route_parent.cu  K17's parent, the scatter then the
                                 gather-back as a second kernel, with the
                                 shipped C signature: `parent_k17()` binds
                                 it in ops/_ext.py's entry cache
                                 (deps_block_variants.bound), so every K17
                                 launch inside, eager or captured (the
                                 protocol megakernel's mailbox stage too),
                                 runs the parent's kernels
The pair helpers (A B B A interleaved graph replays, three rounds, the
median; every pair bit-equal):

    key_stage_pair(mesh, wt, key_in, fins)  a sharded_protocol_tick graph
                                 of the key stage (and the finalizes:
                                 `fins`), its outputs compared, the replay
                                 with each stage, and each graph's kernel
                                 nodes by function (graph_kernels)
    shard_launch_alone(mesh, key_in, wt)    the stage's launch alone (the
                                 subject words made before), CALLS a
                                 graph: the parent's node_key_shard into
                                 fresh partials and K13's table (the
                                 shipped launch), each at an aligned and
                                 a misaligned output, on the same inputs
    k17_pair(block)              one mailbox_route call on a mailbox block
                                 (card tensors), each side routing in place
                                 into its own copy of the arena and meta,
                                 K17_CALLS calls a graph
    tick_pair(mesh, wt, kw)      a whole sharded_protocol_tick graph
                                 replayed with each side's key stage
    k17_tick_pair(args, kw)      a protocol_tick graph with a mailbox
                                 stage replayed with each K17, with each
                                 graph's kernel nodes by function

Run alone it times the key stage at the 10k tick (chip_smoke.py's merged
tick: 128 blocks, 4,096 subjects) on the virtual 4 x 2 mesh and on
make_mesh(), alone, with its finalizes and in the whole tick (beside the
single-device tick's replay), with the launch alone and the kernels'
ptxas properties (the 1 x 1 gap, PERF.md §6), and K17 on a 1,024-lane, W
384 block and inside a protocol_tick graph:

    python -m accord_tpu_torch.tools.key_stage_mailbox_variants

Needs a card and nvcc. Prints the card line and one JSON object.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np

from accord_tpu_torch.tools import deps_block_variants as dbv

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = pathlib.Path(__file__).resolve().parent
PARENTS = {"key": HERE / "sharded_key_parent.cu",
           "k17": HERE / "mailbox_route_parent.cu"}
CALLS = 20
K17_CALLS = 100
_LIBS: dict = {}
_LOGS: dict = {}
_PARTS_AT: list = []     # the parent stage's partials' offset in fixed memory
_VP, _I = ctypes.c_void_p, ctypes.c_int
# the parent's node_key_shard (tools/sharded_key_parent.cu)
_KEY_SHARD_ARGS = (_VP, _I, _I, *(_VP,) * 5, _I, _I, _VP, _I, _I, _VP)


def _so(name: str) -> pathlib.Path:
    from accord_tpu_torch.ops import _ext
    return _ext.BUILD / "key_stage_mailbox_variants" / f"{name}.so"


# K17's scan for the clamped rows' writers in two copies of the shipped
# source: cut out (the barrier kept; its answers are wrong wherever a
# lane lands on a clamped row, so it is timed only, to price the scan),
# and with each thread's index loads issued SCAN_X lanes at once
_SCAN = "  if (__syncthreads_or(need)) {"
_SCAN_END = "  if (live && lane == 0)"
_NO_SCAN = "  __syncthreads();\n"
SCAN_X = 4
_SCAN_X = """  if (__syncthreads_or(need)) {
    for (int j0 = threadIdx.x; j0 < L; j0 += SCAN_X * MT) {
      unsigned char kj[SCAN_X];
      int dj[SCAN_X], sj[SCAN_X];
#pragma unroll
      for (int u = 0; u < SCAN_X; ++u) {
        const int j = j0 + u * MT;
        const bool first = j == threadIdx.x;
        kj[u] = j < L ? (first ? c_keep : keep[j]) : 0;
        dj[u] = j < L && !first ? dst[j] : c_dst;
        sj[u] = j < L && !first ? slot[j] : c_slot;
      }
#pragma unroll
      for (int u = 0; u < SCAN_X; ++u) {
        const int j = j0 + u * MT;
        const int rj = norm_index(land_flat(dj[u], sj[u], rows, n1), rows);
        if (kj[u] == 0 || (rj != rows - 1 && rj != 0) ||
            lane_cut(t, src[j], dj[u], n1))
          continue;
        if (rj == rows - 1) s_writer[0] = j;
        if (rj == 0) s_writer[1] = j;
      }
    }
  }
"""


def _k17_copy(name: str, scan: str) -> pathlib.Path:
    """A copy of csrc/mailbox_route.cu whose scan is `scan`."""
    from accord_tpu_torch.ops import _ext
    text = (_ext.CSRC / "mailbox_route.cu").read_text()
    start, end = text.find(_SCAN), text.find(_SCAN_END)
    if text.count(_SCAN) != 1 or end < start:
        raise RuntimeError("mailbox_route.cu: the clamped rows' scan moved")
    dst = _so(name).with_suffix(".cu")
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(f"#define SCAN_X {SCAN_X}\n" + text[:start] + scan
                   + text[end:])
    return dst


def start_build():
    """Start nvcc on both parents' files and K17's two scan copies (to
    overlap the shipped build); finish_build waits for them."""
    from accord_tpu_torch.ops import _ext
    procs = {}
    srcs = {**PARENTS,
            "k17_no_scan": _k17_copy("k17_no_scan", _NO_SCAN),
            "k17_scan_x": _k17_copy("k17_scan_x", _SCAN_X)}
    for name, src in srcs.items():
        so = _so(name)
        so.parent.mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [_ext.nvcc(), *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_ext.CSRC), "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def finish_build(procs) -> dict:
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {proc.args[-1]}:\n{log}")
        _LOGS[name] = log
        _LIBS[name] = ctypes.CDLL(str(_so(name)))
    return _LIBS


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        finish_build(start_build())
    return _LIBS[name]


def _fn(lib, name: str, argtypes):
    """lib's entry `name` with its argtypes, raising on a CUDA error."""
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int

    def call(*args):
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"parent {name}: CUDA error {rc}")
    return call


def _host_np(x) -> np.ndarray:
    """A slot lane as int32 numpy (to expand it per shard entry)."""
    x = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
    return x.astype(np.int32)


def _parent_table(P, blocks, data: int, model: int, parts, sws, b: int,
                  wtot: int) -> list:
    """The int64 words of the parent's KeyShard table: per (block, data
    shard d, model shard m) the lane pointers at the shard's first row
    (the bucket words at its 'model' column slice), its subject words
    sws[m], its 'model' partial (parts + m * b * wtot words), (rows | out
    word column << 32) and the arena's row stride."""
    from accord_tpu_torch.ops import tick_graph as tg
    nw = blocks[0][0].shape[1]
    nwl = nw // model
    words = []
    off = 0
    for bm, ts, kinds, valid in blocks:
        cap = bm.shape[0]
        cl = cap // data
        bm_r, ts_r, kd_r, vl_r = (P.ptr(x) for x in (bm, ts, kinds, valid))
        for d in range(data):
            r0 = d * cl
            for m in range(model):
                words += [tg._shift(bm_r, 4 * (r0 * nw + m * nwl)),
                          tg._shift(ts_r, 12 * r0), tg._shift(kd_r, 4 * r0),
                          tg._shift(vl_r, r0), sws[m],
                          tg._shift(parts, 4 * m * b * wtot),
                          cl | ((off + r0 // 32) << 32), nw]
        off += cap // 32
    return words


def _parent_stage_fn(lib):
    """The parent's _stage_key_shard: a subject pass a 'model' slice, the
    parent's node_key_shard into the partials, K22's or_fold into a
    fixed-memory result that the graph's table_copy scatters."""
    import torch
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.ops import node_lane as nl
    from accord_tpu_torch.ops import tick_graph as tg
    from accord_tpu_torch.parallel import mesh as pm
    shard = _fn(lib, "node_key_shard", _KEY_SHARD_ARGS)

    def stage(P, ext, wt_ref, nk, key_in, mesh):
        subj_of, subj_keys, subj_node, sb, sknd, slots, blocks = key_in
        data, model = mesh.shape["data"], mesh.shape["model"]
        b = sb.shape[0]
        nw = nl.key_words(blocks, "sharded_protocol_tick")
        nwl = pm._bucket_words(mesh, nw, "sharded_protocol_tick")
        tg._shard_rows(blocks, data, "key")
        _nblk, max_cap, wtot = nl.block_dims(blocks)
        P.sig.append(("skey_parent", len(blocks)))
        of, keys, node, r_sb, r_sk = (P.inp(x) for x in (
            subj_of, subj_keys, subj_node, sb, sknd))
        r_sl = P.inp(np.repeat(_host_np(slots), data * model))
        parts = P.alloc("f", 4 * model * b * wtot)
        _PARTS_AT.append(parts[1])
        sws = [P.alloc("f", 4 * b * nwl) for _ in range(model)]
        tab = P.table(_parent_table(P, blocks, data, model, parts, sws, b,
                                    wtot))
        f_ref, view = P.out((b, wtot), torch.int32)
        nnz = subj_of.shape[0]
        nent = len(blocks) * data * model

        def go(B):
            A = tg._addrs(B)
            for m in range(model):
                ext.entry("deps_resolve", "deps_subjects_slice",
                          tk._DEPS_SUBJ_ARGS)(
                    A(of), A(keys), nnz, b, nw * 32, m * nwl * 32, nwl * 32,
                    A(sws[m]), ext.stream())
            shard(A(tab), nent, max_cap // data, A(r_sb), A(r_sk), A(node),
                  A(r_sl), None, b, nwl, A(wt_ref), nk, wtot, ext.stream())
            ext.entry("mesh_combine", "or_fold", pm._OR_FOLD_ARGS)(
                A(parts), 1, model, b, wtot, A(f_ref), wtot, 0, ext.stream())
        P.launches.append(go)
        P.count("node_key_shard")
        P.count("or_fold")
        return f_ref, view, wtot
    return stage


@contextlib.contextmanager
def parent_key_stage():
    """Inside, the sharded tick's key stage is the parent's chain (the
    tick graphs' cache set aside, as deps_block_variants.bound does)."""
    from accord_tpu_torch.ops import tick_graph as tg
    lib = _lib("key")
    orig = tg._stage_key_shard
    tg._stage_key_shard = _parent_stage_fn(lib)
    try:
        with dbv.bound(lib, {}, "parent sharded key stage"):
            yield
    finally:
        tg._stage_key_shard = orig


@contextlib.contextmanager
def parent_k17():
    """Inside, K17's C entry resolves to the parent's library."""
    from accord_tpu_torch.ops import mailbox as mb
    with dbv.bound(_lib("k17"), {("mailbox_route", "mailbox_route"):
                                 mb._ROUTE_ARGS}, "parent K17"):
        yield


def graph_kernels(tick) -> dict:
    """function name -> kernel nodes of a tick graph (an
    ops/tick_graph._TickGraph): its body captured again into a graph kept
    for inspection, printed by libcuda's cuGraphDebugDotPrint, where a
    kernel node's line names its function."""
    import os
    import tempfile

    import torch
    from accord_tpu_torch.ops import tick_graph as tg
    g = torch.cuda.CUDAGraph(keep_graph=True)
    side = tg._side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        g.capture_begin(capture_error_mode="relaxed")
        try:
            tick.body()
        finally:
            g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    cu = ctypes.CDLL("libcuda.so.1")
    fd, path = tempfile.mkstemp(suffix=".dot")
    os.close(fd)
    try:
        if cu.cuGraphDebugDotPrint(ctypes.c_void_p(g.raw_cuda_graph()),
                                   path.encode(), 1) != 0:
            raise RuntimeError("cuGraphDebugDotPrint failed")
        with open(path) as f:
            text = f.read()
    finally:
        os.unlink(path)
    names: dict = {}
    for ln in text.splitlines():
        m = re.search(r"(?:_Z\d+)?([A-Za-z]\w*_kernel)", ln)
        if m:
            names[m.group(1)] = names.get(m.group(1), 0) + 1
    return names


def _tick_pair(call, first, parent) -> dict:
    """dbv.replay_pair of a tick call, with the kernel nodes of each
    side's graph by function name."""
    from accord_tpu_torch.ops import tick_graph as tg
    kernels = {}
    with parent():
        call()
        kernels["parent_kernels"] = graph_kernels(
            next(reversed(tg._GRAPHS.values())))
    call()
    kernels["new_kernels"] = graph_kernels(
        next(reversed(tg._GRAPHS.values())))
    return dict(dbv.replay_pair(call, first, parent=parent), **kernels)


def key_stage_pair(mesh, wt, key_in, fins=()) -> dict:
    """The sharded tick's key stage (with `fins`: and its finalizes) as a
    graph replayed with each side's stage: outputs bit-equal."""
    return tick_pair(mesh, wt, dict(key_in=key_in, fins=fins))


def tick_pair(mesh, wt, kw) -> dict:
    """A sharded_protocol_tick graph (sharded_protocol_tick(mesh, wt,
    **kw)) replayed with each side's key stage: its resolve, finalize,
    cmd and quorum outputs bit-equal."""
    from accord_tpu_torch.parallel import mesh as pm
    return _tick_pair(lambda: pm.sharded_protocol_tick(mesh, wt, **kw),
                      lambda o: o[:5], parent_key_stage)


def shard_launch_alone(mesh, key_in, wt) -> dict:
    """The key stage's launch alone on the 10k tick's inputs, CALLS a
    graph (the subject words made before): the parent's node_key_shard
    into partials and K13's table (the shipped stage's launch) into the
    result, each at its buffer's base and 16 bytes on (an address that is
    16-byte but not 32-byte aligned, as a graph's fixed memory may place
    a region), and K13's launcher into its own output; every K13 output
    equal, every parent's partials OR-folded = K13's."""
    import torch
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.ops import node_lane as nl
    from accord_tpu_torch.ops import tick_graph as tg
    ext = tk._ext()
    *lanes, blocks = key_in
    dev = blocks[0][0].device
    of, keys, node, sb, sknd, slots = (nl._dev_lane(x, dev) for x in lanes)
    data, model = mesh.shape["data"], mesh.shape["model"]
    b, nw = sb.shape[0], blocks[0][0].shape[1]
    nwl = nw // model
    dims = nl.block_dims(blocks)
    _nblk, max_cap, wtot = dims
    # K13 (its subject words made by its launcher)
    k13, k13_out = nl.key_launcher(*lanes, blocks, wt)
    sw = torch.empty(b, nw, dtype=torch.int32, device=dev)
    tk._deps_subjects(ext, of, keys, b, nw * 32, 0, nw * 32, sw,
                      ext.stream().value)
    sws = torch.empty(model, b, nwl, dtype=torch.int32, device=dev)
    for m in range(model):
        tk._deps_subjects(ext, of, keys, b, nw * 32, m * nwl * 32, nwl * 32,
                          sws[m], ext.stream().value)
    psl = nl.upload(np.repeat(_host_np(slots), data * model), dev)
    shard = _fn(_lib("key"), "node_key_shard", _KEY_SHARD_ARGS)
    P = tg._Prog(dev)

    def ints(words):
        return [tg._addr((None, None, None), w) if isinstance(w, tuple)
                else w for w in words]

    def k13_at(off: int):
        buf = torch.empty(b * wtot + 8, dtype=torch.int32, device=dev)
        tab = nl._upload_table(nl.key_table(blocks, buf.data_ptr() + off),
                               dev)

        def go(keep=(tab, buf)):
            nl.launch_key_blocks(ext, tk._addr, tab, dims, sw, sb, sknd,
                                 node, slots, None, b, nw, wt, wt.shape[0])
        return go, buf[off // 4:off // 4 + b * wtot].view(b, wtot)

    def parent_at(off: int):
        buf = torch.empty(model * b * wtot + 8, dtype=torch.int32,
                          device=dev)
        ptab = nl._upload_table(ints(_parent_table(
            P, blocks, data, model, ("a", buf.data_ptr() + off),
            [("a", sws[m].data_ptr()) for m in range(model)], b, wtot)),
            dev)

        def go(keep=(ptab, buf)):
            shard(ptab.data_ptr(), len(blocks) * data * model,
                  max_cap // data, sb.data_ptr(), sknd.data_ptr(),
                  node.data_ptr(), psl.data_ptr(), None, b, nwl,
                  wt.data_ptr(), wt.shape[0], wtot, ext.stream())
        parts = buf[off // 4:off // 4 + model * b * wtot]
        return go, parts.view(model, b, wtot)
    runs = {"k13_launcher": (k13, k13_out)}
    for off in (0, 16):
        runs[f"parent_at_{off}"] = parent_at(off)
        runs[f"k13_table_at_{off}"] = k13_at(off)
    for fn, _out in runs.values():
        fn()
    torch.cuda.synchronize()
    equal = True
    for name, (_fn_, out) in runs.items():
        if name.startswith("parent"):
            folded = out[0].clone()
            for m in range(1, model):
                folded |= out[m]
            out = folded
        equal &= bool(torch.equal(out, k13_out))
    t = dbv._interleaved({name: (dbv._capture(fn, CALLS).replay, CALLS)
                          for name, (fn, _o) in runs.items()})
    return {"entries": {"parent": len(blocks) * data * model,
                        "k13_table": len(blocks)},
            **{f"{k}_ms": v["ms"] for k, v in t.items()},
            "bit_equal": equal}


def ptxas_props() -> dict:
    """Registers, spill bytes and stack frame of the parent's
    node_key_shard_kernel and the shipped node_key_kernel (from each
    build's `-Xptxas -v` log)."""
    from accord_tpu_torch.ops import _ext
    _lib("key")

    def props(log: str, fn: str) -> str:
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and fn in ln:
                rest = " ".join(x.strip() for x in lines[i + 1:i + 4])
                m = re.search(r"(\d+ bytes stack frame.*?)ptxas info\s*: "
                              r"(Used \d+ registers)", rest)
                return f"{m.group(1)}{m.group(2)}" if m else rest
        return "not found"
    log = _ext.ptxas_log.get("node_resolve")
    if log is None:          # built by an earlier process: build it again
        so = _so("node_resolve")
        log = subprocess.run(
            [_ext.nvcc(), *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_ext.CSRC), "-o", str(so), str(_ext.CSRC / "node_resolve.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            check=True).stdout
    return {"parent node_key_shard_kernel": props(_LOGS["key"],
                                                  "node_key_shard_kernel"),
            "node_key_kernel": props(log, "node_key_kernel")}


def k17_pair(block) -> dict:
    """The shipped and the parent's K17 on one mailbox block (card
    tensors: arena, meta, the seven emit lanes, part), each side routing
    in place into its own copy of the arena and meta (routing the same
    lanes again rewrites the same rows): outputs bit-equal, device ms a
    call from a graph of K17_CALLS calls."""
    import torch
    from accord_tpu_torch.ops import mailbox as mb
    arena, meta, *lanes, part = block
    mine = (arena.clone(), meta.clone())
    theirs = (arena.clone(), meta.clone())

    def call(am):
        return mb.mailbox_route(*am, *lanes, part)
    out = call(mine)
    with parent_k17():
        p_out = call(theirs)
        p_graph = dbv._capture(lambda: call(theirs), K17_CALLS)
    torch.cuda.synchronize()
    equal = dbv._same(out, p_out)
    graph = dbv._capture(lambda: call(mine), K17_CALLS)
    t = dbv._interleaved({"new": (graph.replay, K17_CALLS),
                          "parent": (p_graph.replay, K17_CALLS)})
    return {"new_ms": t["new"]["ms"], "parent_ms": t["parent"]["ms"],
            "new_samples": t["new"]["samples"],
            "parent_samples": t["parent"]["samples"],
            "lanes": int(lanes[0].shape[0]), "words": int(arena.shape[1]),
            "landed": int(out[4].sum()), "bit_equal": equal}


def k17_tick_pair(args, kw) -> dict:
    """A protocol_tick graph with a mailbox stage (protocol_tick(*args,
    **kw)) replayed with each K17: its mailbox outputs bit-equal, each
    graph's kernel nodes."""
    from accord_tpu_torch.ops import kernels as tk
    return _tick_pair(lambda: tk.protocol_tick(*args, **kw),
                      lambda o: o[5], parent_k17)


def k17_scan_cost(block, spread: bool = False) -> dict:
    """K17 on one mailbox block beside its two scan copies (_NO_SCAN: what
    the scan costs; _SCAN_X: its loads SCAN_X lanes at once, bit-equal to
    the shipped kernel), K17_CALLS calls a graph, interleaved. `spread`
    permutes the lanes, so that every block of MW = 8 positions holds a
    reader (and scans)."""
    import torch
    from accord_tpu_torch.ops import mailbox as mb
    arena, meta, *lanes, part = block
    if spread:
        perm = torch.from_numpy(np.random.default_rng(3).permutation(
            lanes[0].shape[0])).to(lanes[0].device)
        lanes = [x[perm].contiguous() for x in lanes]
    sides = {k: (arena.clone(), meta.clone())
             for k in ("new", "no_scan", "scan_x")}

    def call(am):
        return mb.mailbox_route(*am, *lanes, part)
    out = call(sides["new"])
    graphs = {"new": (dbv._capture(lambda: call(sides["new"]), K17_CALLS)
                      .replay, K17_CALLS)}
    equal = True
    for k in ("no_scan", "scan_x"):
        with dbv.bound(_lib(f"k17_{k}"), {("mailbox_route", "mailbox_route"):
                                          mb._ROUTE_ARGS}, f"K17 {k}"):
            got = call(sides[k])
            graphs[k] = (dbv._capture(lambda k=k: call(sides[k]), K17_CALLS)
                         .replay, K17_CALLS)
        torch.cuda.synchronize()
        if k == "scan_x":
            equal = dbv._same(out, got)
    t = dbv._interleaved(graphs)
    readers = 8 * int((~out[4]).view(-1, 8).any(1).sum()) \
        if out[4].shape[0] % 8 == 0 else None
    return {**{f"{k}_ms": v["ms"] for k, v in t.items()},
            "scan_ms": t["new"]["ms"] - t["no_scan"]["ms"],
            "scan_share": 1 - t["no_scan"]["ms"] / t["new"]["ms"],
            "lanes": int(lanes[0].shape[0]), "words": int(arena.shape[1]),
            "landed": int(out[4].sum()),
            "positions_in_scanning_blocks": readers, "spread": spread,
            "bit_equal": equal}


def mail_block(n: int, depth: int, w: int, lanes: int, landed: int,
               dev, seed: int = 5) -> tuple:
    """A mailbox block of `lanes` emit lanes on n nodes' rings of `depth`
    slots x `w` words: `landed` lanes land on distinct rows (one on node
    n's last slot, which every pad gathers back), one kept lane on a cut
    link, the rest pads."""
    import torch
    rng = np.random.default_rng(seed)
    rows = (n + 1) * depth
    pick = rng.choice(np.arange(depth, rows - 1), landed - 1, replace=False)
    dst = np.zeros(lanes, np.int32)
    slot = np.zeros(lanes, np.int32)
    dst[:landed - 1], slot[:landed - 1] = pick // depth, pick % depth
    dst[landed - 1], slot[landed - 1] = n, depth - 1
    src = np.zeros(lanes, np.int32)
    src[:landed] = rng.integers(1, n + 1, landed)
    keep = np.zeros(lanes, bool)
    keep[:landed] = True
    part = np.zeros((n + 1, n + 1), bool)
    part[1, 2] = part[2, 1] = True
    src[landed], dst[landed], keep[landed] = 1, 2, True
    kind = rng.integers(1, 20, lanes).astype(np.int32)
    seq = rng.integers(0, 1 << 31, lanes).astype(np.int32)
    words = rng.integers(-(1 << 31), 1 << 31, (lanes, w)).astype(np.int32)
    arena = rng.integers(-50, 50, (rows, w)).astype(np.int32)
    meta = rng.integers(-5, 5, (rows, 3)).astype(np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (
        arena, meta, src, dst, slot, keep, kind, seq, words, part))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("key_stage_mailbox_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from accord_tpu_torch.ops import _ext
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.parallel import mesh as pm
    procs = start_build()
    _ext.build()
    finish_build(procs)
    t = smoke.merged_tick_inputs("cuda", False, tk)
    wt, key_in, fins = t["wt"], t["key_in"], tuple(t["fins"])
    res = {"ptxas": ptxas_props(), "key_stage": {}, "k17": {}}
    out = tk.protocol_tick(wt, **t["kw"])    # noqa: F841 (kept alive)
    res["single_device_replay_ms"] = smoke.time_ms(
        smoke.last_graph_replay(), 20, True)
    for label, m in (("virtual_4x2", pm.make_mesh(devices=["cuda:0"] * 8)),
                     ("make_mesh", pm.make_mesh())):
        _PARTS_AT.clear()
        alone = key_stage_pair(m, wt, key_in)
        res["key_stage"][label] = {
            "key_stage": alone,
            # where the parent's key-only graph put its partials
            "parent_parts_fixed_offset": _PARTS_AT[0],
            "with_fins": key_stage_pair(m, wt, key_in, fins),
            "tick": tick_pair(m, wt, t["kw"]),
            "launch_alone": shard_launch_alone(m, key_in, wt)}
    block = mail_block(63, 64, 384, 1024, 700, "cuda")
    res["k17"]["lanes_1024"] = k17_pair(block)
    res["k17"]["tick"] = k17_tick_pair((wt,), {"mailbox": block})
    # the clamped rows' scan: O(L^2 / MW) index loads a launch
    res["k17_scan"] = {
        f"lanes_{lanes}{'_spread' if spread else ''}": k17_scan_cost(
            mail_block(n, 64, 384, lanes, landed, "cuda"), spread)
        for n, lanes, landed in ((15, 256, 180), (63, 1024, 700),
                                 (255, 4096, 2800))
        for spread in (False, True)}
    ok = all(r["bit_equal"] for part in res["key_stage"].values()
             for r in part.values() if isinstance(r, dict)) and all(
        r["bit_equal"] for r in (*res["k17"].values(),
                                 *res["k17_scan"].values()))
    print(smoke.card_line(True))
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
