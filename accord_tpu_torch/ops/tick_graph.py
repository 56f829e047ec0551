"""kernels.protocol_tick on the card: one CUDA graph per static signature,
replayed once per cluster tick.

A CUDA graph fixes every kernel argument at capture, while each tick
brings fresh arena snapshots (the port's kernels are functional, so every
snapshot is a new tensor) and needs outputs that outlive the tick (merged
results are read back a tick or more later). So no stage kernel of the
graph takes a per-tick pointer as an argument. A tick's program has three
byte regions:

  param  host-written each tick into a pinned buffer that belongs to the
         graph; the graph's first node copies it to fixed device memory.
         It holds the host lanes (the merge's subject lanes, the quorum
         lanes, the mailbox emit lanes), the node-lane block tables (arena
         pointers, output pointer), the mailbox table (the plane's arena,
         meta and partition-mask pointers: the arena is updated in place),
         one FinIn per key finalize (its packed window, kid table and
         lanes) and the FinEnt table that runs them all in ONE launch of
         K2's table entry, and the copy tables below.
  fixed  device memory that belongs to the graph, zeroed when allocated:
         the tick's device inputs that a stage reads by argument
         (gathered by the graph's second node, csrc/tick_graph.cu
         table_copy), scratch (the compaction's tile states and K10's
         ticket start at zero and every replay leaves them so), and every
         stage output but the merged results.
  out    a fresh device buffer per tick: the merged results, written in
         place through the block tables' output pointers, and every other
         output, scattered there by the graph's last node. The caller's
         tensors are views of it, so a later replay never overwrites them.

The program is rebuilt on the host every tick (_Prog: pure bookkeeping);
its signature -- every stage's statics, every input's shape, dtype and
place -- keys the graph. The first tick of a signature runs the program
once eagerly (loading each kernel and checking each launch outside
capture), captures it (counted in kernels.CAPTURES) and replays it; later
ticks write the pinned buffer (after the previous replay of that graph
has consumed it) and replay. The cache holds at most MAX_GRAPHS graphs
and MAX_GRAPH_BYTES of their memory, least recently replayed out first
(cache_stats() reports its size and memory). Each replay adds one to LAUNCHES["protocol_tick"] and one per
stage kernel it launches: a stage launches through its kernel's shared
launch function (kernels.launch_*, node_lane.launch_*) once, at capture,
so its count is kept per replay here rather than in that function.

The sharded protocol megakernel (parallel/mesh.sharded_protocol_tick, on a
mesh whose shards share this card) is the same program with its resolve,
key finalize and mailbox stages in shard form -- launches over shard
tables whose records the param block carries, then the mesh's combining
steps (K22) on fixed memory, and K23 for the mailbox -- keyed by the mesh
too and counted under "sharded_protocol_tick".
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

from accord_tpu_torch.ops import kernels as K
from accord_tpu_torch.ops import node_lane as nl
from accord_tpu_torch.parallel import mesh as pm

_ALIGN = 16
# captured graphs by signature, least recently replayed first; past
# MAX_GRAPHS graphs or MAX_GRAPH_BYTES of their memory the oldest go
# (counted in kernels.CAPTURES["evictions"]), so varied traffic cannot
# pin memory without end
MAX_GRAPHS = 256
MAX_GRAPH_BYTES = 1 << 30
_GRAPHS: "OrderedDict[tuple, _TickGraph]" = OrderedDict()
_CHECKED: List[bool] = []


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else x.nbytes


def _dt(x) -> str:
    return str(x.dtype)


_ITEMSIZE = {torch.int32: 4, torch.bool: 1}


def _size(shape, dtype) -> int:
    n = _ITEMSIZE[dtype]
    for d in shape:
        n *= d
    return n


class _Prog:
    """One tick's program: region sizes, this tick's fill, and the stage
    launches (closures over region offsets only, so every tick of a
    signature launches the same graph)."""

    def __init__(self, dev):
        self.dev = dev
        self.sig: list = []
        self.size = {"p": 0, "f": 0, "o": 0}
        self.host: list = []      # (param off, numpy array)
        self.words: list = []     # (param off, [int | ref]) int64 words
        self.calls: list = []     # fn(pin address, bases) param writers
        self.gathers: list = []   # (src pointer, fixed off, bytes)
        self.scatters: list = []  # (fixed off, out off, bytes)
        self.launches: list = []  # fn(bases) under capture
        self.counts: Dict[str, int] = {}
        self.fin_tab: list = []   # the key finalizes of K2's table launch

    def alloc(self, space: str, nbytes: int) -> tuple:
        off = self.size[space]
        self.size[space] += _pad(max(int(nbytes), 1))
        return (space, off)

    def count(self, name: str) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1

    def inp(self, x) -> tuple:
        """An operand read by argument: host data into param, a card
        tensor gathered into fixed memory."""
        if isinstance(x, (int, np.integer, bool, np.bool_)):
            x = np.asarray(x, dtype=np.int32)
        if isinstance(x, torch.Tensor) and x.is_cuda:
            if not x.is_contiguous():
                raise ValueError("protocol_tick inputs must be contiguous")
            ref = self.alloc("f", _nbytes(x))
            self.gathers.append((x.data_ptr(), ref[1], _nbytes(x)))
            self.sig.append(("d", tuple(x.shape), _dt(x)))
            return ref
        a = np.ascontiguousarray(x.numpy() if isinstance(x, torch.Tensor)
                                 else x)
        ref = self.alloc("p", a.nbytes)
        self.host.append((ref[1], a))
        self.sig.append(("h", a.shape, str(a.dtype)))
        return ref

    def ptr(self, x) -> tuple:
        """An operand read through a pointer in the param block: a card
        tensor in place, host data via param."""
        if isinstance(x, torch.Tensor) and x.is_cuda:
            if not x.is_contiguous():
                raise ValueError("protocol_tick inputs must be contiguous")
            self.sig.append(("a", tuple(x.shape), _dt(x)))
            return ("a", x.data_ptr())
        return self.inp(x)

    def out(self, shape, dtype) -> tuple:
        """A stage output: fixed memory, scattered to the tick's buffer."""
        n = _size(shape, dtype)
        f = self.alloc("f", n)
        o = self.alloc("o", n)
        self.scatters.append((f[1], o[1], n))
        return f, (o[1], n, tuple(shape), dtype)

    def direct_out(self, shape, dtype) -> tuple:
        """An output written in place through a table's pointer."""
        n = _size(shape, dtype)
        o = self.alloc("o", n)
        return o, (o[1], n, tuple(shape), dtype)

    def table(self, words: list) -> tuple:
        ref = self.alloc("p", 8 * len(words))
        self.words.append((ref[1], words))
        return ref


def _addr(bases, ref) -> int:
    space, v = ref
    if space == "a":
        return v
    base = bases["pfo".index(space)]
    if base is None:
        raise RuntimeError("a graph launch may not address the tick's "
                           "output buffer")
    return base + v


def _A(bases, ref) -> ctypes.c_void_p:
    return ctypes.c_void_p(_addr(bases, ref))


def _addrs(bases):
    """The `A` of the shared launch functions (kernels.launch_*,
    node_lane.launch_*) over this graph's regions: a ref's address, None
    as null."""
    return lambda ref: ctypes.c_void_p(None) if ref is None \
        else _A(bases, ref)


# -- the stages ---------------------------------------------------------------
# Each stage lays out its operands and appends one closure that launches
# its kernels through the same launch function as the kernel's wrapper;
# the closures hold region refs and ints only, never a tick's tensors.
def _stage_key(P, ext, wt_ref, nk, key_in):
    subj_of, subj_keys, subj_node, sb, sknd, slots, blocks = key_in
    b = sb.shape[0]
    nw = nl.key_words(blocks, "protocol_tick")
    dims = nl.block_dims(blocks)
    P.sig.append(("key", len(blocks)))
    of, keys, node, r_sb, r_sk, r_sl = (P.inp(x) for x in (
        subj_of, subj_keys, subj_node, sb, sknd, slots))
    nnz = subj_of.shape[0]
    o_ref, view = P.direct_out((b, dims[2]), torch.int32)
    tab = P.table(nl.key_table(blocks, o_ref, ptr=P.ptr))
    sw = P.alloc("f", b * nw * 4)
    P.launches.append(lambda B: nl.launch_node_deps(
        ext, _addrs(B), of, keys, nnz, sw, tab, dims, r_sb, r_sk, node, r_sl,
        b, nw, wt_ref, nk))
    P.count("node_deps_resolve")
    return o_ref, view, dims[2]


def _stage_range(P, ext, wt_ref, nk, rng_in):
    (iv_of, iv_s, iv_e, subj_node, sb, sknd, srng, r_slots, rblocks,
     k_slots, kblocks) = rng_in
    b = sb.shape[0]
    nv = iv_of.shape[0]
    P.sig.append(("rng", len(rblocks), len(kblocks)))
    of, ivs, ive, node, r_sb, r_sk, r_rng, r_rsl, r_ksl = (
        P.inp(x) for x in (iv_of, iv_s, iv_e, subj_node, sb, sknd, srng,
                           r_slots, k_slots))
    rdims = nl.block_dims(rblocks, range_side=True)
    kdims = nl.block_dims(kblocks)
    r_ref, r_view = P.direct_out((b, rdims[2]), torch.int32)
    k_ref, k_view = P.direct_out((b, kdims[2]), torch.int32)
    rside = kside = None
    if rdims[2]:
        rside = (P.table(nl.range_table(rblocks, r_ref, ptr=P.ptr)), rdims,
                 r_rsl)
    if kdims[2]:
        nw = nl.key_words(kblocks, "protocol_tick")
        kside = (P.table(nl.key_table(kblocks, k_ref, ptr=P.ptr)), kdims,
                 r_ksl, P.alloc("f", b * nw * 4), nw)
    if rside or kside:
        P.launches.append(lambda B: nl.launch_node_range_deps(
            ext, _addrs(B), of, ivs, ive, nv, r_sb, r_sk, node, r_rng, b,
            wt_ref, nk, rside, kside))
        P.count("node_range_resolve")
    return (r_ref, r_view, rdims[2]), (k_ref, k_view, kdims[2])


def _fixed_csr_scratch(P, nspec: int, ctiles: int) -> tuple:
    """The zeroed fixed-memory scratch of a one-launch compaction (the
    graph's fixed region is zeroed when allocated, and every replay leaves
    the scratch zeroed again)."""
    return P.alloc("f", K.csr_scratch_bytes(nspec, ctiles))


def _stage_fin_key(P, ext, spec, args, src):
    """A key/rkey finalize: its FinIn (written into the param block every
    tick) and its outputs. The tick's key finalizes run as ONE launch of
    K2's table entry (_stage_fin_tab)."""
    kind, rows, words, out_cap = spec
    (r0, w_lo, word_off, kid_rows, slot_subj, slot_kid, subj_row,
     act_ts) = args
    if src is None:
        raise ValueError(f"protocol_tick: a {kind!r} finalize needs its "
                         "resolve stage")
    s_ref, s_view, wt = src
    nr = s_view[2][0]
    kc, w = kid_rows.shape
    s = slot_subj.shape[0]
    r = nl.dyn_start(r0, nr, rows)
    c = nl.dyn_start(w_lo, wt, words)
    off = min(max(int(word_off), 0), words - w)     # finalize_csr's rule
    P.sig.append(("fin", kind, rows, words, out_cap))
    packed = (s_ref[0], s_ref[1] + 4 * (r * wt + c))
    k_ptr, ss, sk, sr = (P.ptr(x) for x in (kid_rows, slot_subj, slot_kid,
                                            subj_row))
    lib = ext.lib("finalize_csr")
    fin = P.alloc("p", int(lib.fin_in_bytes()))

    def write(pin_addr, bases, fin=fin, packed=packed):
        lib.fin_in_pack(
            ctypes.c_void_p(pin_addr + fin[1]), _A(bases, packed),
            ctypes.c_int(rows), ctypes.c_int(wt), ctypes.c_int(off),
            _A(bases, k_ptr), ctypes.c_int(kc), ctypes.c_int(w),
            _A(bases, ss), _A(bases, sk), ctypes.c_int(s), _A(bases, sr))
    P.calls.append(write)
    ts = P.inp(act_ts)
    outs = [P.out(sh, torch.int32) for sh in ((s + 1,), (out_cap,),
                                              (out_cap, 3), (), ())]
    P.fin_tab.append((fin, s, w, ts, int(out_cap), [o[0] for o in outs]))
    return tuple(o[1] for o in outs)


def _stage_fin_tab(P, ext) -> None:
    """Every key/rkey finalize of the tick in ONE launch of K2's table
    entry: the FinEnt records in the param block (written every tick, as
    their FinIns are), the scratch in fixed memory."""
    lib = ext.lib("finalize_csr")
    ent_b = int(lib.fin_ent_bytes())
    ents = P.fin_tab
    n = len(ents)
    firsts, tiles, ctiles = K.fin_tab_layout(
        [(s, w, oc) for _f, s, w, _t, oc, _o in ents])
    tab = P.alloc("p", ent_b * n)
    scratch = _fixed_csr_scratch(P, n, ctiles)

    def write(pin_addr, bases):
        sc = _addr(bases, scratch)
        for k, (fin, s, w, ts, out_cap, outs) in enumerate(ents):
            K.fin_ent_pack(ext, pin_addr + tab[1] + k * ent_b,
                           _addr(bases, fin), s, w, _addr(bases, ts),
                           out_cap, [_addr(bases, o) for o in outs], sc, n,
                           k, firsts[k])
    P.calls.append(write)

    def go(B):
        ext.entry("finalize_csr", "finalize_csr_tab",
                  (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p))(
            _addr(B, tab), n, tiles, ctiles, _addr(B, scratch),
            ext.stream())
    P.launches.append(go)
    P.count("finalize_csr_tab")


def _stage_fin_range(P, ext, wt_ref, nk, out_cap, args):
    iv_of, iv_s, iv_e, ent_ok, sb, sknd, rsnap = args
    nv = iv_of.shape[0]
    b = sb.shape[0]
    rcap = rsnap[0].shape[0]
    w = K.range_words(rcap)
    P.sig.append(("rfin", out_cap))
    lanes = [P.inp(x) for x in (iv_of, iv_s, iv_e, ent_ok, sb, sknd,
                                *rsnap)] + [wt_ref]
    words = P.alloc("f", nv * w * 4)
    outs = [P.out(sh, torch.int32) for sh in ((nv + 1,), (out_cap,),
                                              (out_cap, 3), (), ())]
    o_refs = [o[0] for o in outs]
    scratch = _fixed_csr_scratch(P, 1, K.csr_tiles(nv * w, out_cap)[0])
    P.launches.append(lambda B: K.launch_range_finalize(
        ext, _addrs(B), lanes, nv, b, rcap, nk, out_cap, words, o_refs,
        scratch))
    P.count("range_finalize")
    return tuple(o[1] for o in outs)


def _stage_cmd(P, ext, c):
    promote = bool(c[-1])
    cols, clock, ops = c[:8], c[8], c[9:21]
    scal = (clock,) + tuple(c[21:25])
    cap, kcap = cols[0].shape[0], cols[6].shape[0]
    n, kpad = ops[5].shape
    if not 1 <= kpad <= K._CMD_KPAD_MAX:
        raise ValueError("protocol_tick: cmd kpad out of range")
    P.sig.append(("cmd", promote))
    col_refs = [P.inp(x) for x in cols]
    op_refs = [P.inp(x) for x in ops]
    sc = P.inp(np.asarray([int(v) for v in scal], dtype=np.int32)
               if not any(isinstance(v, torch.Tensor) and v.is_cuda
                          for v in scal)
               else torch.stack([v.reshape(()).to(torch.int32)
                                 for v in scal]))
    outs = [P.out(tuple(x.shape), x.dtype) for x in cols]
    cw = K.CMD_ROW_LANES + 4 * kpad
    res = [P.out(sh, torch.int32) for sh in ((), (n,), (n, 3), (n,), (),
                                             (n, cw))]
    oclock, code, ots, ost, csum, chains = res
    ticket = P.alloc("f", 16)     # zeroed; each replay leaves it so

    def go(B):
        ext.call("cmd_tick", "cmd_tick_dsc", *(_A(B, r) for r in col_refs),
                 *(_A(B, o[0]) for o in outs), cap, kcap,
                 *(_A(B, r) for r in op_refs), n, kpad, _A(B, sc),
                 int(promote), _A(B, code[0]), _A(B, ost[0]),
                 _A(B, ots[0]), _A(B, chains[0]), _A(B, oclock[0]),
                 _A(B, csum[0]), _A(B, ticket), ext.stream())
    P.launches.append(go)
    P.count("cmd_tick")
    return tuple(o[1] for o in outs) + tuple(x[1] for x in res)


def _stage_quorum(P, ext, quorum, qsize: int):
    t = K.check_quorum_lanes(quorum)
    P.sig.append(("quorum", int(qsize)))
    lanes = [P.inp(x) for x in quorum]
    outs = [P.out((t,), dt) for dt in (torch.bool, torch.int32, torch.bool)]
    o_refs = [o[0] for o in outs]
    P.launches.append(lambda B: K.launch_quorum(ext, _addrs(B), lanes, t,
                                                qsize, o_refs))
    P.count("quorum_count")
    return tuple(o[1] for o in outs)


def _stage_repair(P, ext, rep):
    cols, vals = rep[:8], rep[8:]
    K.check_repair_lanes(cols, vals)
    dims = K.repair_dims(cols, vals)
    P.sig.append(("repair",))
    refs = [P.inp(x) for x in rep]
    outs = [P.out(tuple(x.shape), x.dtype) for x in cols]
    o_refs = [o[0] for o in outs]
    P.launches.append(lambda B: K.launch_cmd_repair(
        ext, _addrs(B), refs[:8], o_refs, refs[8:], dims))
    P.count("cmd_repair")
    return tuple(o[1] for o in outs)


def _stage_exec(P, ext, planes, out_cap: int):
    n = len(planes)
    w_tot = K.check_planes(planes)
    P.sig.append(("exec", out_cap))
    lanes = [[P.inp(t) for t in p] for p in planes]
    caps = [p[0].shape[0] for p in planes]
    outs = [P.out(sh, torch.int32) for sh in ((n + 1,), (out_cap,), (),
                                              (w_tot,))]
    # frontier_compact's outputs are (indptr, rows, csum, packed); the
    # launch takes (packed, indptr, rows, csum)
    o_refs = [outs[3][0], outs[0][0], outs[1][0], outs[2][0]]
    scratch = _fixed_csr_scratch(P, 1, K.csr_tiles(n * w_tot, out_cap)[0])
    P.launches.append(lambda B: K.launch_frontier_compact(
        ext, _addrs(B), lanes, caps, out_cap, o_refs, scratch))
    P.count("frontier_compact")
    return tuple(o[1] for o in outs)


def _stage_mail(P, ext, mailbox):
    """K17: the arena, meta and partition-mask pointers go through a
    param-block table (the arena is updated in place, never gathered into
    fixed memory); the emit lanes go in the param block; the landed
    gather-back is scattered into the tick's buffer."""
    from accord_tpu_torch.ops import mailbox as mb
    dims = mb.check_mail_lanes(mailbox)
    arena, meta, *lanes, part = mailbox
    if not all(isinstance(t, torch.Tensor) and t.is_cuda
               for t in (arena, meta, part)):
        raise ValueError("protocol_tick: the mailbox arena, meta and "
                         "partition mask must be card tensors")
    L, W = dims[0], dims[1]
    P.sig.append(("mail",))
    tab = P.table([P.ptr(arena), P.ptr(meta), P.ptr(part)])
    refs = [P.inp(x) for x in lanes]
    outs = [P.out(sh, dt) for sh, dt in (((L, W), torch.int32),
                                         ((L, 3), torch.int32),
                                         ((L,), torch.bool))]
    o_refs = [o[0] for o in outs]
    P.launches.append(lambda B: mb.launch_mailbox_route(
        ext, _addrs(B), tab, None, refs, o_refs, dims))
    P.count("mailbox_route")
    return (arena, meta) + tuple(o[1] for o in outs)


# -- the sharded protocol megakernel's stages ---------------------------------
# parallel/mesh.sharded_protocol_tick on a mesh whose shards share one card:
# the JAX package's shard_map regions become launches over SHARD tables
# (csrc/node_resolve.cu node_key_shard, csrc/finalize_csr.cu
# fin_shard_*_tab) whose records, like the single-device tables, are
# written into the param block every tick, followed by the mesh's K22
# combining steps on fixed memory; K23 routes the mailbox.
def _host_np(x) -> np.ndarray:
    """A slot lane as numpy (to expand it per shard entry on the host)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _shift(ref, nbytes: int) -> tuple:
    return (ref[0], ref[1] + int(nbytes))


def _shard_rows(blocks, data: int, who: str) -> None:
    for blk in blocks:
        pm._check_rows(f"sharded_protocol_tick: a {who} block",
                       blk[0].shape[0], data)


def _shard_key_table(P, blocks, data: int, model: int, parts, sws, b: int,
                     wtot: int) -> list:
    """The int64 words of a KeyShard table: per (block, data shard d,
    model shard m) the lane pointers at the shard's first row (the bucket
    words at its 'model' column slice), its subject words sws[m], its
    'model' partial (parts + m * b * wtot words), (rows | out word column
    << 32) and the arena's row stride."""
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
                words += [_shift(bm_r, 4 * (r0 * nw + m * nwl)),
                          _shift(ts_r, 12 * r0), _shift(kd_r, 4 * r0),
                          _shift(vl_r, r0), sws[m],
                          _shift(parts, 4 * m * b * wtot),
                          cl | ((off + r0 // 32) << 32), nw]
        off += cap // 32
    return words


# node_key_shard (csrc/node_resolve.cu), a lean launch (_ext.entry)
_KEY_SHARD_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   *(ctypes.c_void_p,) * 5, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p)


def _key_shard_launch(ext, A, subj, tab, nent: int, max_cl: int, sb, sknd,
                      node, slots, gate, b: int, nw: int, nwl: int, model: int,
                      sws, parts, out, wtot: int, wt, nk: int) -> None:
    """The subject words of each 'model' slice -- K1's subject pass over
    subj = (subj_of, subj_keys, nnz); subj None: K14's key side, whose
    covered words the range stage's launch wrote -- one K13 launch over
    the shard table, and the 'model' partials OR-folded (K22) into
    `out`."""
    if subj is not None:
        for m in range(model):
            ext.call("deps_resolve", "deps_subjects_slice", A(subj[0]),
                     A(subj[1]), subj[2], b, nw * 32, m * nwl * 32, nwl * 32,
                     A(sws[m]), ext.stream())
    ext.entry("node_resolve", "node_key_shard", _KEY_SHARD_ARGS)(
        A(tab), nent, max_cl, A(sb), A(sknd), A(node), A(slots), A(gate), b,
        nwl, A(wt), nk, wtot, ext.stream())
    ext.call("mesh_combine", "or_fold", A(parts), 1, model, b, wtot, A(out),
             wtot, 0, ext.stream())


def _stage_key_shard(P, ext, wt_ref, nk, key_in, mesh):
    """The key resolve per (store block x 'data' shard x 'model' shard)."""
    subj_of, subj_keys, subj_node, sb, sknd, slots, blocks = key_in
    data, model = mesh.shape["data"], mesh.shape["model"]
    b = sb.shape[0]
    nw = nl.key_words(blocks, "sharded_protocol_tick")
    nwl = pm._bucket_words(mesh, nw, "sharded_protocol_tick")
    _shard_rows(blocks, data, "key")
    _nblk, max_cap, wtot = nl.block_dims(blocks)
    P.sig.append(("skey", len(blocks)))
    of, keys, node, r_sb, r_sk = (P.inp(x) for x in (
        subj_of, subj_keys, subj_node, sb, sknd))
    r_sl = P.inp(np.repeat(_host_np(slots).astype(np.int32), data * model))
    parts = P.alloc("f", 4 * model * b * wtot)
    sws = [P.alloc("f", 4 * b * nwl) for _ in range(model)]
    tab = P.table(_shard_key_table(P, blocks, data, model, parts, sws, b,
                                   wtot))
    f_ref, view = P.out((b, wtot), torch.int32)
    subj = (of, keys, subj_of.shape[0])
    nent = len(blocks) * data * model
    P.launches.append(lambda B: _key_shard_launch(
        ext, _addrs(B), subj, tab, nent, max_cap // data, r_sb, r_sk, node,
        r_sl, None, b, nw, nwl, model, sws, parts, f_ref, wtot, wt_ref, nk))
    P.count("node_key_shard")
    P.count("or_fold")
    return f_ref, view, wtot


def _stage_range_shard(P, ext, wt_ref, nk, rng_in, mesh):
    """The range side per (range block x 'data' shard) -- the interval
    compares have no bucket dimension, so 'model' replicas would repeat
    them -- through K14's range table, in ONE launch with the covered
    words of every 'model' slice; the key side per (key block x 'data' x
    'model' shard) gated by subj_is_range."""
    (iv_of, iv_s, iv_e, subj_node, sb, sknd, srng, r_slots, rblocks,
     k_slots, kblocks) = rng_in
    data, model = mesh.shape["data"], mesh.shape["model"]
    b = sb.shape[0]
    nv = iv_of.shape[0]
    P.sig.append(("srng", len(rblocks), len(kblocks)))
    of, ivs, ive, node, r_sb, r_sk, r_rng = (P.inp(x) for x in (
        iv_of, iv_s, iv_e, subj_node, sb, sknd, srng))
    rdims = nl.block_dims(rblocks, range_side=True)
    kdims = nl.block_dims(kblocks)
    r_ref, r_view = P.out((b, rdims[2]), torch.int32)
    k_ref, k_view = P.out((b, kdims[2]), torch.int32)
    rtab = r_sl = None
    nent_r = rmax = 0
    if rdims[2]:
        _shard_rows(rblocks, data, "range")
        r_sl = P.inp(np.repeat(_host_np(r_slots).astype(np.int32), data))
        words = [r_ref, len(rblocks) * data]
        off = 0
        for blk in rblocks:
            rcap = blk[0].shape[0]
            rl = rcap // data
            st, en, ts, kd, vl = (P.ptr(x) for x in blk)
            for d in range(data):
                r0 = d * rl
                words += [_shift(st, 4 * r0), _shift(en, 4 * r0),
                          _shift(ts, 12 * r0), _shift(kd, 4 * r0),
                          _shift(vl, r0), rl | ((off + r0 // 32) << 32)]
            off += rcap // 32
        rtab = P.table(words)
        nent_r = len(rblocks) * data
        rmax = rdims[1] // data
    cov = None
    nw = nwl = 0
    if kdims[2]:
        nw = nl.key_words(kblocks, "sharded_protocol_tick")
        nwl = pm._bucket_words(mesh, nw, "sharded_protocol_tick")
        # the covered words of every 'model' slice, slice m at word
        # m * b * nwl
        cov = P.alloc("f", 4 * model * b * nwl)

    def rgo(B, rtab=rtab, r_sl=r_sl, cov=cov):
        A = _addrs(B)
        ext.entry("node_resolve", "node_range_resolve", nl._NODE_RANGE_ARGS)(
            A(rtab), nent_r, rmax, A(of), A(ivs), A(ive), nv, A(r_sb),
            A(r_sk), A(node), A(r_sl), b, A(wt_ref), nk, rdims[2], A(cov),
            0, nwl * 32, nw * 32, model, ext.stream())
    if rdims[2] or kdims[2]:
        P.launches.append(rgo)
        P.count("node_range_shard")
    if kdims[2]:
        _shard_rows(kblocks, data, "key")
        k_sl = P.inp(np.repeat(_host_np(k_slots).astype(np.int32),
                               data * model))
        parts = P.alloc("f", 4 * model * b * kdims[2])
        covs = [_shift(cov, 4 * m * b * nwl) for m in range(model)]
        ktab = P.table(_shard_key_table(P, kblocks, data, model, parts, covs,
                                        b, kdims[2]))
        nent = len(kblocks) * data * model
        P.launches.append(lambda B: _key_shard_launch(
            ext, _addrs(B), None, ktab, nent, kdims[1] // data, r_sb, r_sk,
            node, k_sl, r_rng, b, nw, nwl, model, covs, parts, k_ref,
            kdims[2], wt_ref, nk))
        P.count("node_key_shard")
        P.count("or_fold")
    return (r_ref, r_view, rdims[2]), (k_ref, k_view, kdims[2])


def _stage_fin_shard(P, ext, spec, args, src, mesh):
    """A key/rkey finalize as parallel/mesh.sharded_finalize_csr's chain,
    in table form: one count launch over every (data, model) shard's
    record, K22's counts_scan, one compaction launch over every data
    shard's record, K22's fragment_merge."""
    kind, rows, words, out_cap = spec
    (r0, w_lo, word_off, kid_rows, slot_subj, slot_kid, subj_row,
     act_ts) = args
    if src is None:
        raise ValueError(f"sharded_protocol_tick: a {kind!r} finalize needs "
                         "its resolve stage")
    data, model = mesh.shape["data"], mesh.shape["model"]
    s_ref, s_view, wt = src
    nr = s_view[2][0]
    kc, w = kid_rows.shape
    if w % data:
        raise ValueError(f"sharded_protocol_tick: a span of {w} words does "
                         f"not split over data={data}")
    wl = w // data
    s = slot_subj.shape[0]
    r = nl.dyn_start(r0, nr, rows)
    c = nl.dyn_start(w_lo, wt, words)
    off = min(max(int(word_off), 0), words - w)     # finalize_csr's rule
    P.sig.append(("sfin", kind, rows, words, out_cap))
    k_ptr, ss, sk, sr = (P.ptr(x) for x in (kid_rows, slot_subj, slot_kid,
                                            subj_row))
    ts = P.inp(act_ts)
    lib = ext.lib("finalize_csr")
    rec = int(lib.shard_fin_bytes())
    split = s % model == 0
    ents = [(d, m) for d in range(data) for m in range(model)
            if split or m == 0]
    ctab = P.alloc("p", rec * len(ents))
    xtab = P.alloc("p", rec * data)
    counts = P.alloc("f", 4 * data * s)
    bounds = P.alloc("f", 4 * data * model)
    seg = P.alloc("f", 4 * data * s)
    frags = P.alloc("f", 4 * data * out_cap)
    acc = P.alloc("f", 12)
    outs = [P.out(sh, torch.int32) for sh in ((s + 1,), (out_cap,),
                                              (out_cap, 3), (), ())]
    indptr, dep_rows, dep_ts, bound, csum = (o[0] for o in outs)
    blk_ref = _shift(s_ref, 4 * (r * wt + c + off))
    vp = ctypes.c_void_p

    def write(pin_addr, bases):
        blk, kid = _addr(bases, blk_ref), _addr(bases, k_ptr)
        lanes = [_A(bases, x) for x in (ss, sk, sr)]
        cnt, bnd = _addr(bases, counts), _addr(bases, bounds)
        sgb, frg = _addr(bases, seg), _addr(bases, frags)
        for i, (d, m) in enumerate(ents + [(d, 0) for d in range(data)]):
            lo, hi = (m * (s // model), (m + 1) * (s // model)) if split \
                else (0, s)
            dst = pin_addr + (ctab[1] + i * rec if i < len(ents)
                              else xtab[1] + (i - len(ents)) * rec)
            lib.shard_fin_pack(
                vp(dst), vp(blk + 4 * d * wl), ctypes.c_int(wt),
                ctypes.c_int(rows), vp(kid + 4 * d * wl), ctypes.c_int(w),
                ctypes.c_int(kc), ctypes.c_int(wl), ctypes.c_int(d * wl),
                *lanes, vp(cnt + 4 * d * s if m == 0 else None),
                vp(bnd + 4 * (d * model + m)), ctypes.c_int(lo),
                ctypes.c_int(hi), vp(sgb + 4 * d * s),
                vp(frg + 4 * d * out_cap))
    P.calls.append(write)

    def go(B):
        A = _addrs(B)
        ext.call("finalize_csr", "fin_shard_count_tab", A(ctab), len(ents),
                 s, A(bounds), data * model, ext.stream())
        ext.call("mesh_combine", "counts_scan", A(counts), data, s,
                 A(bounds), data * model, A(indptr), A(seg), A(bound),
                 ext.stream())
        ext.call("finalize_csr", "fin_shard_compact_tab", A(xtab), data, s,
                 out_cap, A(frags), data * out_cap, ext.stream())
        ext.call("mesh_combine", "fragment_merge", A(frags), data, out_cap,
                 A(ts), act_ts.shape[0], s, A(indptr), A(dep_rows),
                 A(dep_ts), A(csum), A(acc), ext.stream())
    P.launches.append(go)
    for name in ("finalize_shard_tab", "finalize_shard_tab", "counts_scan",
                 "fragment_merge"):
        P.count(name)
    return tuple(o[1] for o in outs)


def _stage_mail_shard(P, ext, mailbox, mesh):
    """K23: the node-major arena, meta and partition-mask pointers through
    a param-block table (updated in place), the emit lanes in the param
    block, the landed outputs scattered into the tick's buffer."""
    from accord_tpu_torch.ops import mailbox as mb
    S = mesh.shape["data"]
    dims = mb.check_shard_mail_lanes(S, mailbox) + (S,)
    arena, meta, *lanes, part = mailbox
    if not all(isinstance(t, torch.Tensor) and t.is_cuda
               for t in (arena, meta, part)):
        raise ValueError("sharded_protocol_tick: the mailbox arena, meta "
                         "and partition mask must be card tensors")
    L, W = dims[0], dims[1]
    P.sig.append(("smail", S))
    tab = P.table([P.ptr(arena), P.ptr(meta), P.ptr(part)])
    refs = [P.inp(x) for x in lanes]
    outs = [P.out(sh, dt) for sh, dt in (((L, W), torch.int32),
                                         ((L, 3), torch.int32),
                                         ((L,), torch.bool))]
    o_refs = [o[0] for o in outs]
    P.launches.append(lambda B: mb.launch_sharded_mailbox_route(
        ext, _addrs(B), tab, None, refs, None, o_refs, dims, 0, S))
    P.count("sharded_mailbox_route")
    return (arena, meta) + tuple(o[1] for o in outs)


def _copy_launch(P, ext, tab, ents) -> None:
    n = len(ents)
    most = max(e[2] for e in ents)
    grid = max(1, min(1024, (most // 16 + 255) // 256))

    def go(B):
        ext.call("tick_graph", "table_copy", _A(B, tab), n, grid,
                 ext.stream())
    return go


def _build(ext, dev, witness_table, key_in, rng_in, fin_statics, fin_traced,
           cmds, quorum, quorum_size, mailbox, cmd_repairs, execs,
           mesh=None) -> tuple:
    """One tick's program; with `mesh` (every shard on `dev`) the sharded
    megakernel's: its resolve, key/rkey finalize and mailbox stages run
    sharded, the rest exactly as the single-device program runs them."""
    P = _Prog(dev)
    if mesh is not None:
        P.sig.append(("mesh", mesh.devices))
    nk = witness_table.shape[0]
    wt_ref = P.inp(witness_table)
    packed = rng = None
    views = {"packed": (), "rng": ()}
    if key_in is not None:
        packed = _stage_key(P, ext, wt_ref, nk, key_in) if mesh is None \
            else _stage_key_shard(P, ext, wt_ref, nk, key_in, mesh)
        views["packed"] = packed[1]
    if rng_in is not None:
        rng = _stage_range(P, ext, wt_ref, nk, rng_in) if mesh is None \
            else _stage_range_shard(P, ext, wt_ref, nk, rng_in, mesh)
        views["rng"] = (rng[0][1], rng[1][1])
    fins = []
    for spec, args in zip(fin_statics, fin_traced):
        if spec[0] == "range":
            fins.append(_stage_fin_range(P, ext, wt_ref, nk, spec[1], args))
            continue
        src = packed if spec[0] == "key" else (rng[1] if rng else None)
        fins.append(_stage_fin_key(P, ext, spec, args, src) if mesh is None
                    else _stage_fin_shard(P, ext, spec, args, src, mesh))
    if P.fin_tab:
        _stage_fin_tab(P, ext)
    cmd_outs = [_stage_cmd(P, ext, c) for c in cmds]
    q_out = _stage_quorum(P, ext, quorum, quorum_size) \
        if quorum is not None else ()
    mail = ()
    if mailbox is not None:
        mail = _stage_mail(P, ext, mailbox) if mesh is None \
            else _stage_mail_shard(P, ext, mailbox, mesh)
    reps = [_stage_repair(P, ext, r) for r in cmd_repairs]
    exs = [_stage_exec(P, ext, pl, int(oc)) for pl, oc in execs]
    # the copy tables close the layout: the gather runs first, the scatter
    # last; their entry counts and sizes are part of the signature
    pre, post = [], []
    if P.gathers:
        gtab = P.alloc("p", 24 * len(P.gathers))
        pre.append(_copy_launch(P, ext, gtab, P.gathers))
        P.sig.append(("gather", tuple(g[2] for g in P.gathers)))
    else:
        gtab = None
    if P.scatters:
        stab = P.alloc("p", 24 * len(P.scatters))
        post.append(_copy_launch(P, ext, stab, P.scatters))
    else:
        stab = None
    P.launches = pre + P.launches + post
    P.sig.append(tuple(sorted(P.size.items())))
    layout = (views, fins, cmd_outs, q_out, mail, reps, exs)
    return P, layout, gtab, stab


class _TickGraph:
    """One captured program: its pinned param buffer, fixed device memory
    and graph, and the event of its last replay."""

    def __init__(self, P: _Prog, kind: str):
        self.kind = kind
        self.pin_t = torch.empty(max(P.size["p"], _ALIGN), dtype=torch.uint8,
                                 pin_memory=True)
        self.pin = self.pin_t.numpy()
        self.pin_addr = self.pin_t.data_ptr()
        self.pdev = torch.empty(self.pin_t.shape[0], dtype=torch.uint8,
                                device=P.dev)
        # zeroed once: the compaction's and cmd_tick's scratch in it must
        # start at zero (every replay leaves it so)
        self.fixed = torch.zeros(max(P.size["f"], _ALIGN), dtype=torch.uint8,
                                 device=P.dev)
        self.nbytes = 2 * self.pin_t.numel() + self.fixed.numel()
        self.launches = P.launches
        self.graph = None
        self.event = None

    def bases(self, out) -> tuple:
        return (self.pdev.data_ptr(), self.fixed.data_ptr(), out.data_ptr())

    def body(self) -> None:
        B = (self.pdev.data_ptr(), self.fixed.data_ptr(), None)
        self.pdev.copy_(self.pin_t, non_blocking=True)
        for go in self.launches:
            go(B)

    def capture(self) -> None:
        # capture_begin/_end on a side stream, as torch.cuda.graph does,
        # without its gc.collect() and empty_cache(): a burn captures a
        # graph per new signature while its whole cluster is on the heap
        g = torch.cuda.CUDAGraph()
        side = _side_stream()
        cur = torch.cuda.current_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            g.capture_begin(capture_error_mode="relaxed")
            try:
                self.body()
            finally:
                g.capture_end()
        cur.wait_stream(side)
        self.graph = g


_SIDE: List[torch.cuda.Stream] = []


def _side_stream():
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    return _SIDE[0]


def _fill(g: _TickGraph, P: _Prog, bases, gtab, stab) -> None:
    pin = g.pin
    for off, a in P.host:
        pin[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    pin64 = pin.view(np.int64)
    for off, words in P.words:
        pin64[off // 8:off // 8 + len(words)] = [
            _addr(bases, w) if isinstance(w, tuple) else w for w in words]
    for fn in P.calls:
        fn(g.pin_addr, bases)
    if gtab is not None:
        ents = np.array([(src, bases[1] + f, n) for src, f, n in P.gathers],
                        dtype=np.int64)
        pin64[gtab[1] // 8:gtab[1] // 8 + ents.size] = ents.reshape(-1)
    if stab is not None:
        ents = np.array([(bases[1] + f, bases[2] + o, n)
                         for f, o, n in P.scatters], dtype=np.int64)
        pin64[stab[1] // 8:stab[1] // 8 + ents.size] = ents.reshape(-1)


def _view(out, spec):
    off, n, shape, dtype = spec
    return out[off:off + n].view(dtype).view(shape)


def _check_layouts(ext) -> None:
    """The tables above must match the C structs (once per process)."""
    if _CHECKED:
        return
    nl.table_sizes_ok()
    for lib, fn, size in (("tick_graph", "copy_ent_bytes", 24),
                          ("mailbox_route", "mailbox_tab_bytes", 24),
                          ("mailbox_shard", "mailbox_shard_tab_bytes", 24),
                          ("node_resolve", "node_shard_bytes", 64)):
        if int(getattr(ext.lib(lib), fn)()) != size:
            raise RuntimeError(f"{lib}.{fn}: the table layout differs from "
                               "ops/tick_graph.py")
    _CHECKED.append(True)


def run_protocol_tick(witness_table, key_in, rng_in, fin_statics,
                      fin_traced, cmds, quorum, quorum_size, mailbox,
                      cmd_repairs, execs, mesh=None):
    """Build this tick's program, replay its graph (capturing it on the
    first tick of its signature). With `mesh` it is the sharded protocol
    megakernel's program (parallel/mesh.sharded_protocol_tick), counted
    under "sharded_protocol_tick"."""
    ext = K._ext()
    dev = witness_table.device
    _check_layouts(ext)
    kind = "protocol_tick" if mesh is None else "sharded_protocol_tick"
    P, layout, gtab, stab = _build(ext, dev, witness_table, key_in, rng_in,
                                   fin_statics, fin_traced, cmds, quorum,
                                   quorum_size, mailbox, cmd_repairs, execs,
                                   mesh)
    sig = tuple(P.sig)
    g = _GRAPHS.get(sig)
    out = torch.empty(max(P.size["o"], _ALIGN), dtype=torch.uint8,
                      device=dev)
    fresh = g is None
    if fresh:
        g = _TickGraph(P, kind)
    elif g.event is not None:
        g.event.synchronize()     # the last replay has read the pin buffer
    _fill(g, P, g.bases(out), gtab, stab)
    if fresh:
        g.body()                  # eager: loads and checks every launch
        g.capture()
        _GRAPHS[sig] = g
        K.CAPTURES[kind] += 1
        while len(_GRAPHS) > 1 and (len(_GRAPHS) > MAX_GRAPHS
                                    or _held_bytes() > MAX_GRAPH_BYTES):
            _evict()
    else:
        _GRAPHS.move_to_end(sig)
    g.graph.replay()
    g.event = torch.cuda.Event()
    g.event.record()
    K.LAUNCHES[kind] += 1
    for name, n in P.counts.items():
        K.LAUNCHES[name] += n
    views, fins, cmd_outs, q_out, mail, reps, exs = layout

    def vs(specs):
        return tuple(_view(out, s) for s in specs)
    packed = _view(out, views["packed"]) if views["packed"] else ()
    rng = tuple(_view(out, s) for s in views["rng"])
    return (packed, rng, tuple(vs(f) for f in fins),
            tuple(vs(c) for c in cmd_outs), vs(q_out) if q_out else (),
            mail[:2] + vs(mail[2:]) if mail else (),
            tuple(vs(r) for r in reps), tuple(vs(e) for e in exs))


def _evict() -> None:
    """Drop the least recently replayed graph, once its last replay is
    done with its parameter buffer and fixed memory."""
    _sig, g = _GRAPHS.popitem(last=False)
    if g.event is not None:
        g.event.synchronize()
    K.CAPTURES["evictions"] += 1


def _held_bytes() -> int:
    return sum(g.nbytes for g in _GRAPHS.values())


def held_graphs() -> Dict[str, int]:
    """Graphs the cache holds, by program kind ("protocol_tick",
    "sharded_protocol_tick"): captured minus evicted."""
    held: Dict[str, int] = {}
    for g in _GRAPHS.values():
        held[g.kind] = held.get(g.kind, 0) + 1
    return held


def cache_stats() -> dict:
    """The graph cache: graphs held, and the bytes they pin (pinned host
    parameter buffers) and hold on the card (their device copies and
    fixed memory)."""
    return {"graphs": len(_GRAPHS),
            "pinned_bytes": sum(g.pin_t.numel() for g in _GRAPHS.values()),
            "device_bytes": sum(g.pdev.numel() + g.fixed.numel()
                                for g in _GRAPHS.values())}
