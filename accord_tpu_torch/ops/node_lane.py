"""The node-id batch axis of the cluster tick (sim/mesh_burn.py): every
node's encoded dispatch plans of one cluster tick stack into ONE device
call, routed by a `subj_node` lane -- the port of the JAX package's
`ops/node_lane.py`.

The merge is a pure re-batching, bit-identical to the per-node launch
loop: each plan's subject lanes stack row-major into one node-major block
(CSR entries remap by the plan's row offset); each (plan, store-group)
arena block gets a globally unique slot id (`plan_base + local group
index`, plan bases advancing by `len(groups) + 1` so each plan's padding
sentinel matches nothing); block caps are 32-row multiples, so packed
word spans never straddle blocks; and each plan demuxes its
`[row_off : row_off + b, w_lo : w_lo + words]` window of the merged
result. The merged subject axis pads to NODE_SUBJECT_TIERS, the merged CSR
to the shared nnz ladder, the block count to the resolver's
`pad_node_tiers` ladder with all-invalid blocks under slot -1, and a
multi-block span's width to its node-block tier -- so node churn re-lands
on the same shapes (and, on the card, on the same captured graphs of
kernels.protocol_tick).

The builders (build_key_merge / build_range_merge) are the reference's
numpy host code, line for line, so the merged layout -- block order, pad
blocks, span widths -- is the reference's. The kernels:

  K13 node_fused_deps_resolve        csrc/node_resolve.cu node_key_resolve
      (the reference's :89, body :110): K1 over a device block table,
      one launch for all blocks
  K14 node_fused_range_deps_resolve  csrc/node_resolve.cu
      node_range_resolve + node_key_resolve (:133, body :151): K5 with a
      block table on each side; the range side and the covered-bucket
      pass are one launch
  K15 lane_slice_many, lane_slice    csrc/row_scatter.cu lane_slice_many
      (:190, a dynamic_slice a window): every window of a merged
      dispatch in one launch, over a window table

Each is a plain PyTorch version for CPU tensors (the tests) and the CUDA
kernel for CUDA tensors, counted in kernels.LAUNCHES. The arenas' bucket
bitmaps are packed int32 [cap, K/32] as everywhere in the port; packed
results are int32 bit patterns.
"""
from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from accord_tpu_torch.ops.kernels import (LAUNCHES, _addr, _check_cuda,
                                          _ext, _host_lane,
                                          fused_deps_resolve_plain,
                                          fused_range_deps_resolve_plain,
                                          nnz_tier, upload)
from accord_tpu_torch.ops.tiers import snap

# Merged subject-row ladder: a cluster tick at N nodes stacks up to
# N * max_dispatch subject rows, so the named tiers run past SUBJECT_TIERS;
# oversized totals fall onto power-of-two buckets like every other ladder.
NODE_SUBJECT_TIERS = (64, 256, 1024, 4096)

# Default block-count ladder for pad_node_tiers when the resolver doesn't
# pin one: snaps the per-tick (plan, store) block count so node churn of a
# few replicas (crash / restart / membership change) stays on one tier.
NODE_BLOCK_TIERS = (2, 4, 8, 16, 32, 64, 128, 256)


def node_subject_tier(n: int) -> int:
    """Padded merged-subject row count for a cluster tick of n rows."""
    return snap(n, NODE_SUBJECT_TIERS, 8192)


def node_block_tier(n: int, tiers: Optional[Sequence[int]] = None) -> int:
    """Padded lane-block count for a cluster tick of n (plan, group)
    blocks. `tiers` comes from resolver.pad_node_tiers when set (an int is
    treated as a single named tier)."""
    if tiers is None:
        tiers = NODE_BLOCK_TIERS
    elif isinstance(tiers, int):
        tiers = (tiers,)
    tiers = tuple(tiers)
    return snap(n, tiers, tiers[-1] if tiers else 2)


# -- the block tables (csrc/node_resolve.cu TabHdr / KeyBlk / RngBlk) -------
_HDR_WORDS = 2      # TabHdr: out pointer, block count (int64 each)
_BLK_WORDS = 6      # KeyBlk / RngBlk: 48 bytes


def key_table(blocks, out_ptr: int, ptr=None) -> list:
    """The int64 words of a K13 block table: the header, then per block
    the four lane pointers and (cap | word offset << 32). `ptr(t)` gives a
    lane's address (default: the tensor's data pointer); the table is
    values, so the protocol megakernel's graph rewrites it per tick."""
    ptr = ptr or (lambda t: t.data_ptr())
    words = [out_ptr, len(blocks)]
    off = 0
    for bm, ts, kinds, valid in blocks:
        cap = bm.shape[0]
        words += [ptr(bm), ptr(ts), ptr(kinds), ptr(valid),
                  cap | (off << 32), 0]
        off += cap // 32
    return words


def range_table(blocks, out_ptr: int, ptr=None, off: int = 0) -> list:
    """The int64 words of the range body's block table (K14's in device
    memory, K5's by value: kernels.range_spec): the header, then per block
    the five lane pointers and (cap | word offset << 32), the offsets from
    `off` in block order."""
    ptr = ptr or (lambda t: t.data_ptr())
    words = [out_ptr, len(blocks)]
    for start, end, ts, kinds, valid in blocks:
        cap = start.shape[0]
        words += [ptr(start), ptr(end), ptr(ts), ptr(kinds), ptr(valid),
                  cap | (off << 32)]
        off += cap // 32
    return words


def table_sizes_ok() -> None:
    """The table layout above must be the C structs' (checked once per
    process on the card)."""
    sizes = (ctypes.c_int * 3)()
    _ext().lib("node_resolve").node_table_sizes(sizes)
    if tuple(sizes) != (8 * _HDR_WORDS, 8 * _BLK_WORDS, 8 * _BLK_WORDS):
        raise RuntimeError(f"node_resolve table layout {tuple(sizes)} "
                           "differs from ops/node_lane.py")


def key_words(blocks, who: str) -> int:
    """The bucket words K/32 that every key block of a table shares."""
    nw = blocks[0][0].shape[1]
    if nw > 32 or any(a[0].shape[1] != nw for a in blocks):
        raise ValueError(f"{who}: key blocks must share a bucket count "
                         "K <= 1024")
    return nw


def block_dims(blocks, range_side: bool = False) -> Tuple[int, int, int]:
    """(block count, largest cap, packed words in all) of a block table;
    a range side's caps must be multiples of 32."""
    caps = [a[0].shape[0] for a in blocks]
    if range_side and any(c % 32 for c in caps):
        raise ValueError("range arena caps must be multiples of 32")
    return len(caps), max(caps, default=0), sum(c // 32 for c in caps)


# node_key_resolve (csrc/node_resolve.cu) and K1's subject pass, lean
# launches (kernels._ext's entry): pointers as c_void_p or ints
_VP, _I = ctypes.c_void_p, ctypes.c_int
_NODE_KEY_ARGS = (_VP, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP, _I,
                  _I, _VP)
_DEPS_SUBJ_ARGS = (_VP, _VP, _I, _I, _I, _VP, _VP)
# node_range_resolve (csrc/node_resolve.cu: K14's range side and covered
# pass, one launch)
_NODE_RANGE_ARGS = (_VP, _I, _I, _VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _I,
                    _VP, _I, _I, _VP, _I, _I, _I, _I, _VP)


# -- the launches ---------------------------------------------------------------
# K13's and K14's launch sequences, on device addresses: `A(x)` gives an
# operand's address (kernels._addr over the wrappers' tensors; the protocol
# megakernel's graph maps its memory regions), dims come from block_dims.
# The wrappers below and ops/tick_graph.py both launch through these.
def launch_key_blocks(ext, A, tab, dims, sw, sb, sknd, node, slots, gate,
                      b: int, nw: int, wt, nk: int) -> None:
    """node_key_resolve over the key block table at `tab`, on the subject
    words `sw` i32[b, nw]; `gate` (bool[b] or None) admits subject rows."""
    nblk, max_cap, wtot = dims
    ext.entry("node_resolve", "node_key_resolve", _NODE_KEY_ARGS)(
        A(tab), nblk, max_cap, A(sw), A(sb), A(sknd), A(node), A(slots),
        A(gate), b, nw, A(wt), nk, wtot, ext.stream())


def launch_node_deps(ext, A, of, keys, nnz: int, sw, tab, dims, sb, sknd,
                     node, slots, b: int, nw: int, wt, nk: int) -> None:
    """K13: K1's subject-word pass over the subject CSR (of, keys; nnz
    entries) into `sw`, then the key block table."""
    ext.entry("deps_resolve", "deps_subjects", _DEPS_SUBJ_ARGS)(
        A(of), A(keys), nnz, b, nw * 32, A(sw), ext.stream())
    launch_key_blocks(ext, A, tab, dims, sw, sb, sknd, node, slots, None, b,
                      nw, wt, nk)


def launch_node_range_deps(ext, A, of, ivs, ive, nv: int, sb, sknd, node,
                           srng, b: int, wt, nk: int, rside, kside) -> None:
    """K14: ONE node_range_resolve launch over the range block table
    (rside: rtab, rdims, r_slots -- or None) that also writes the covered
    words of the key side (kside: ktab, kdims, k_slots, cov scratch, nw --
    or None), then the key block table gated by subj_is_range."""
    rtab, (nr, rmax, rtot), rsl = rside if rside is not None \
        else (None, (0, 0, 0), None)
    cov, nw = (kside[3], kside[4]) if kside is not None else (None, 0)
    if rside is not None or kside is not None:
        ext.entry("node_resolve", "node_range_resolve", _NODE_RANGE_ARGS)(
            A(rtab), nr, rmax, A(of), A(ivs), A(ive), nv, A(sb), A(sknd),
            A(node), A(rsl), b, A(wt), nk, rtot, A(cov), 0, nw * 32,
            nw * 32, 1, ext.stream())
    if kside is not None:
        ktab, kdims, ksl = kside[:3]
        launch_key_blocks(ext, A, ktab, kdims, cov, sb, sknd, node, ksl,
                          srng, b, nw, wt, nk)


def _dev_lane(x, dev) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return upload(x, dev)
    if not x.is_cuda:
        return x.to(dev, non_blocking=True)
    return x


def _upload_table(words, dev) -> torch.Tensor:
    return upload(np.asarray(words, dtype=np.int64), dev)


# -- K13: node_fused_deps_resolve --------------------------------------------
def node_fused_deps_resolve_plain(subj_of, subj_keys, subj_node, subj_before,
                                  subj_kinds, slots, arenas, witness_table):
    """fused_deps_resolve with the node slot lane: block s answers only the
    subjects with subj_node == slots[s]."""
    dev = arenas[0][0].device
    return fused_deps_resolve_plain(
        *(_host_lane(x, dev) for x in (subj_of, subj_keys, subj_node,
                                       subj_before, subj_kinds, slots)),
        arenas, witness_table)


def node_fused_deps_resolve(subj_of, subj_keys, subj_node, subj_before,
                            subj_kinds, slots, arenas, witness_table):
    """Cluster-tick twin of kernels.fused_deps_resolve: ONE call answers
    every node's key-domain deps slice. `arenas` is a tuple of (plan,
    store) blocks (packed bitmaps i32[cap, K/32], ts i32[cap, 3], kinds
    i32[cap], valid bool[cap]) in plan-major order, pad blocks under slot
    -1; `subj_node` routes each stacked subject row to its plan's blocks
    through the globally unique slot ids. Lanes may be numpy arrays.
    -> i32[B, sum(cap_s)/32], blocks in tuple order."""
    if not arenas[0][0].is_cuda:
        return node_fused_deps_resolve_plain(
            subj_of, subj_keys, subj_node, subj_before, subj_kinds, slots,
            arenas, witness_table)
    launch, out = key_launcher(subj_of, subj_keys, subj_node, subj_before,
                               subj_kinds, slots, arenas, witness_table)
    launch()
    LAUNCHES["node_deps_resolve"] += 1
    return out


def key_launcher(subj_of, subj_keys, subj_node, subj_before, subj_kinds,
                 slots, arenas, witness_table):
    """K13 on the card, split at its body: the lanes and the block table
    go up and K1's subject pass runs now -> (launch, out). launch() is the
    one node_key_resolve launch over every block (a CUDA graph can capture
    it alone); launch(True) runs the subject pass again first (the whole
    call's device work)."""
    ext = _ext()
    dev = arenas[0][0].device
    of, keys, node, sb, sknd, sl = (_dev_lane(x, dev) for x in (
        subj_of, subj_keys, subj_node, subj_before, subj_kinds, slots))
    _check_cuda(of, keys, node, sb, sknd, sl, witness_table,
                *[t for a in arenas for t in a])
    b = sb.shape[0]
    nw = key_words(arenas, "node_fused_deps_resolve")
    dims = block_dims(arenas)
    words = torch.empty(b, nw, dtype=torch.int32, device=dev)
    out = torch.empty(b, dims[2], dtype=torch.int32, device=dev)
    tab = _upload_table(key_table(arenas, out.data_ptr()), dev)

    def subjects():
        ext.entry("deps_resolve", "deps_subjects", _DEPS_SUBJ_ARGS)(
            of.data_ptr(), keys.data_ptr(), of.shape[0], b, nw * 32,
            words.data_ptr(), ext.raw_stream(dev.index))
    subjects()

    def launch(subjects_too=False, keep=(of, keys, node, sb, sknd, sl, tab)):
        if subjects_too:
            subjects()
        launch_key_blocks(ext, _addr, tab, dims, words, sb, sknd, node, sl,
                          None, b, nw, witness_table, witness_table.shape[0])
    return launch, out


# -- K14: node_fused_range_deps_resolve --------------------------------------
def node_fused_range_deps_resolve_plain(iv_of, iv_start, iv_end, subj_node,
                                        subj_before, subj_kinds,
                                        subj_is_range, r_slots, rarenas,
                                        k_slots, karenas, witness_table):
    dev = witness_table.device
    lanes = [_host_lane(x, dev) for x in (iv_of, iv_start, iv_end,
                                          subj_node, subj_before, subj_kinds,
                                          subj_is_range)]
    return fused_range_deps_resolve_plain(
        *lanes, _host_lane(r_slots, dev), rarenas, _host_lane(k_slots, dev),
        karenas, witness_table)


def node_fused_range_deps_resolve(iv_of, iv_start, iv_end, subj_node,
                                  subj_before, subj_kinds, subj_is_range,
                                  r_slots, rarenas, k_slots, karenas,
                                  witness_table):
    """Cluster-tick twin of kernels.fused_range_deps_resolve: every node's
    range-arena stab and key-arena hull query in one call, routed and
    ordered like node_fused_deps_resolve; either block tuple may be empty
    (that side returns a zero-width result).
    -> (i32[B, sum(rcap_s)/32], i32[B, sum(cap_s)/32])"""
    first = rarenas[0][0] if rarenas else (karenas[0][0] if karenas
                                           else None)
    if first is None or not first.is_cuda:
        return node_fused_range_deps_resolve_plain(
            iv_of, iv_start, iv_end, subj_node, subj_before, subj_kinds,
            subj_is_range, r_slots, rarenas, k_slots, karenas,
            witness_table)
    launch, rp, kp = range_launcher(iv_of, iv_start, iv_end, subj_node,
                                    subj_before, subj_kinds, subj_is_range,
                                    r_slots, rarenas, k_slots, karenas,
                                    witness_table)
    launch()
    if rp.shape[1] or kp.shape[1]:
        LAUNCHES["node_range_resolve"] += 1
    return rp, kp


def range_launcher(iv_of, iv_start, iv_end, subj_node, subj_before,
                   subj_kinds, subj_is_range, r_slots, rarenas, k_slots,
                   karenas, witness_table):
    """K14 on the card with its tables uploaded -> (launch, rp, kp);
    launch() runs its launches (a CUDA graph can capture them)."""
    first = rarenas[0][0] if rarenas else karenas[0][0]
    ext = _ext()
    dev = first.device
    of, ivs, ive, node, sb, sknd, srng, rsl, ksl = (
        _dev_lane(x, dev) for x in (iv_of, iv_start, iv_end, subj_node,
                                    subj_before, subj_kinds, subj_is_range,
                                    r_slots, k_slots))
    _check_cuda(of, ivs, ive, node, sb, sknd, srng, rsl, ksl, witness_table,
                *[t for a in rarenas for t in a],
                *[t for a in karenas for t in a])
    b = sb.shape[0]
    rdims = block_dims(rarenas, range_side=True)
    kdims = block_dims(karenas)
    rp = torch.empty(b, rdims[2], dtype=torch.int32, device=dev)
    kp = torch.empty(b, kdims[2], dtype=torch.int32, device=dev)
    rside = kside = None
    if rdims[2]:
        rside = (_upload_table(range_table(rarenas, rp.data_ptr()), dev),
                 rdims, rsl)
    if kdims[2]:
        nw = key_words(karenas, "node_fused_range_deps_resolve")
        kside = (_upload_table(key_table(karenas, kp.data_ptr()), dev),
                 kdims, ksl,
                 torch.empty(b, nw, dtype=torch.int32, device=dev), nw)

    def launch(keep=(of, ivs, ive, node, sb, sknd, srng, rsl, ksl)):
        launch_node_range_deps(ext, _addr, of, ivs, ive, of.shape[0], sb,
                               sknd, node, srng, b, witness_table,
                               witness_table.shape[0], rside, kside)
    return launch, rp, kp


# -- K15: lane_slice ----------------------------------------------------------
def _slice_starts(packed, row_off: int, word_off: int, rows: int,
                  words: int) -> Tuple[int, int]:
    """jax.lax.dynamic_slice's starts: a negative start counts from the
    end, then each is clamped so the window stays in range."""
    return (dyn_start(row_off, packed.shape[0], rows),
            dyn_start(word_off, packed.shape[1], words))


def dyn_start(i, n: int, size: int) -> int:
    """One jax.lax.dynamic_slice start index over an axis of n."""
    i = int(i)
    if i < 0:
        i += n
    return min(max(i, 0), n - size)


def lane_slice_plain(packed, row_off, word_off, rows: int, words: int):
    r0, w0 = _slice_starts(packed, row_off, word_off, rows, words)
    return packed[r0:r0 + rows, w0:w0 + words].clone()


LANE_SLICE_SOURCES = 4     # csrc/row_scatter.cu LS_SRCS
LANE_SLICE_WINDOWS = 1024  # csrc/row_scatter.cu LS_LARGE: windows a launch


def _slice_launch(packed, wins, offs, out) -> None:
    """K15 over the window rows `wins` (source, r0, w0, rows, words, out
    offset) of the sources `packed` into the flat `out`; `offs` (window
    0's device offsets) or None. Counts its launches."""
    ext = _ext()
    # the host table (csrc/row_scatter.cu lane_slice_many): the sources,
    # then the windows, int64 each
    spec = []
    for t in packed:
        spec += (0, 0, 0) if t is None else (t.data_ptr(), *t.shape)
    for win in wins:
        spec += win
    ext.entry("row_scatter", "lane_slice_many",
              (ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p))(
        struct.pack(f"<{len(spec)}q", *spec), len(packed), len(wins), offs,
        out.data_ptr(), ext.raw_stream(out.device.index))
    LAUNCHES["lane_slice"] += -(-len(wins) // LANE_SLICE_WINDOWS)


def lane_slice_many_plain(packed, spans):
    return [lane_slice_plain(packed[s], r0, w0, rows, words)
            for s, r0, w0, rows, words in spans]


def lane_slice_many(packed, spans):
    """lane_slice over many windows: `spans` holds (source, row_off,
    word_off, rows, words) each, over the 2-D 32-bit tensors `packed` (up
    to LANE_SLICE_SOURCES; a source no window names may be None). On the
    card ONE launch (per LANE_SLICE_WINDOWS windows) writes every window
    into one flat buffer, each at a 16-byte boundary; the windows come back
    as contiguous [rows, words] views of it, in order."""
    if not spans:
        return []
    first = packed[spans[0][0]]
    if not first.is_cuda:
        return lane_slice_many_plain(packed, spans)
    if len(packed) > LANE_SLICE_SOURCES:
        raise ValueError(f"lane_slice_many: {len(packed)} sources (at most "
                         f"{LANE_SLICE_SOURCES})")
    srcs = [t for t in packed if t is not None]
    _check_cuda(*srcs)
    if any(t.element_size() != 4 or t.dim() != 2 or t.dtype != first.dtype
           for t in srcs):
        raise ValueError("lane_slice_many: sources must be 2-D 32-bit "
                         "tensors of one dtype")
    wins, offs, off = [], [], 0
    for s, r0, w0, rows, words in spans:
        t = packed[s]
        if rows > t.shape[0] or words > t.shape[1] or rows < 0 or words < 0:
            raise ValueError("lane_slice_many: window larger than its "
                             "source")
        wins.append((s, int(r0), int(w0), rows, words, off))
        offs.append(off)
        off += -(-rows * words // 4) * 4
    out = torch.empty(off, dtype=first.dtype, device=first.device)
    _slice_launch(packed, wins, None, out)
    return [out.as_strided((rows, words), (words, 1), o)
            for o, (_s, _r, _w, rows, words) in zip(offs, spans)]


def lane_slice(packed, row_off, word_off, rows: int, words: int):
    """Demux one plan's span out of the merged packed result: the window
    [row_off : row_off + rows, word_off : word_off + words], with
    jax.lax.dynamic_slice's start rules (negative from the end, clamped):
    lane_slice_many's one-window entry. On the card the offsets may be
    an i32[2] device tensor (`row_off`, with word_off None): the kernel
    reads them from device memory, so a captured launch replays with new
    offsets."""
    device_offs = isinstance(row_off, torch.Tensor) and word_off is None
    if not packed.is_cuda:
        if device_offs:
            row_off, word_off = (int(v) for v in row_off.tolist())
        return lane_slice_plain(packed, row_off, word_off, rows, words)
    if not device_offs:
        return lane_slice_many((packed,),
                               ((0, row_off, word_off, rows, words),))[0]
    _check_cuda(packed, row_off)
    if rows > packed.shape[0] or words > packed.shape[1]:
        raise ValueError("lane_slice: window larger than the source")
    out = torch.empty(rows, words, dtype=packed.dtype, device=packed.device)
    _slice_launch((packed,), ((0, 0, 0, rows, words, 0),),
                  row_off.data_ptr(), out)
    return out


# -- the megakernel's harvest half ---------------------------------------------
class MergedBuffer:
    """One merged device result shared by every plan's MergedView: one
    non_blocking copy into pinned host memory behind a CUDA event, one
    host materialization; views slice it host-side (the megakernel's
    per-plan demux costs no device work). On the CPU the tensor is the
    host copy."""

    __slots__ = ("dev", "event", "host", "_np")

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self.host = None
        self._np = None
        self.event = None
        if dev.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def copy_async(self) -> None:
        if self.host is not None:
            return
        if self.event is None:
            self.host = self.dev
            return
        h = torch.empty(self.dev.shape, dtype=self.dev.dtype,
                        pin_memory=True)
        h.copy_(self.dev, non_blocking=True)
        self.host = h
        self.event = torch.cuda.Event()
        self.event.record()

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def array(self) -> np.ndarray:
        if self._np is None:
            self.copy_async()
            if self.event is not None:
                self.event.synchronize()
            self._np = self.host.numpy()
        return self._np


class MergedView:
    """A plan's [r0:+rows, w0:+words] window of a MergedBuffer, speaking
    the resolver's device-value protocol (ready / copy_async / read, as
    resolver._DevBuf). read() returns a COPY of the window: the fault
    plane may bit-flip one plan's fetched arrays (ops/fault_plane.py), and
    sibling plans sharing the merged buffer must never see it."""

    __slots__ = ("buf", "r0", "rows", "w0", "words")

    def __init__(self, buf: MergedBuffer, r0: int, rows: int,
                 w0: int, words: int):
        self.buf = buf
        self.r0 = r0
        self.rows = rows
        self.w0 = w0
        self.words = words

    @property
    def shape(self):
        return (self.rows, self.words)

    def ready(self) -> bool:
        return self.buf.ready()

    def copy_async(self) -> None:
        self.buf.copy_async()

    def read(self) -> np.ndarray:
        h = self.buf.array()[self.r0:self.r0 + self.rows,
                             self.w0:self.w0 + self.words]
        return np.array(h, copy=True)

    def __array__(self, dtype=None, copy=None):
        return self.read() if dtype is None else self.read().astype(dtype)


class KeyMerge:
    """The stacked inputs + demux spans for one cluster tick's key-domain
    merge. Built host-side from each plan's recorded `key_args` (the exact
    arrays its own kernel call would have consumed); `spans[i]` is plan i's
    (row_off, rows, word_off, words) slice of the merged packed output."""

    __slots__ = ("subj_of", "subj_keys", "subj_node", "sb", "sknd",
                 "slots", "blocks", "spans", "rows_used", "rows_padded")

    def __init__(self, subj_of, subj_keys, subj_node, sb, sknd, slots,
                 blocks, spans, rows_used, rows_padded):
        self.subj_of = subj_of
        self.subj_keys = subj_keys
        self.subj_node = subj_node
        self.sb = sb
        self.sknd = sknd
        self.slots = slots
        self.blocks = blocks
        self.spans = spans
        self.rows_used = rows_used
        self.rows_padded = rows_padded


class RangeMerge:
    """The stacked inputs + demux spans for one cluster tick's range-domain
    merge; `spans[i]` is (row_off, rows, r_word_off, r_words, k_word_off,
    k_words) -- zero-width sides mean the plan had no blocks there."""

    __slots__ = ("iv_of", "iv_s", "iv_e", "subj_node", "sb", "sknd", "srng",
                 "r_slots", "r_blocks", "k_slots", "k_blocks", "spans",
                 "rows_used", "rows_padded")

    def __init__(self, iv_of, iv_s, iv_e, subj_node, sb, sknd, srng,
                 r_slots, r_blocks, k_slots, k_blocks, spans,
                 rows_used, rows_padded):
        self.iv_of = iv_of
        self.iv_s = iv_s
        self.iv_e = iv_e
        self.subj_node = subj_node
        self.sb = sb
        self.sknd = sknd
        self.srng = srng
        self.r_slots = r_slots
        self.r_blocks = r_blocks
        self.k_slots = k_slots
        self.k_blocks = k_blocks
        self.spans = spans
        self.rows_used = rows_used
        self.rows_padded = rows_padded


def _layout(arg_list) -> Tuple[List[int], List[int], int, int]:
    """Common row layout over the plans in merge order: per-plan row
    offsets, per-plan padded widths, the padded total, and the used total.
    Key and range merges share one layout per plan set so subj rows line
    up with both CSRs."""
    offs, widths, off = [], [], 0
    for args in arg_list:
        b = args["sb"].shape[0]
        offs.append(off)
        widths.append(b)
        off += b
    total = node_subject_tier(off) if off else 0
    return offs, widths, off, total


def build_key_merge(entries, pad_block, node_tiers=None) -> KeyMerge:
    """Stack each plan's recorded key_args into one node-major dispatch.
    `entries` is [(plan, key_args)] in launch order; `pad_block(cap)`
    returns a cached empty key-arena 4-tuple (the resolver's pad-block
    pool, BatchDepsResolver._pad_key_block).

    Each fused plan's recorded `pad_tier` mirrors its resolver's
    pad_store_tiers: the baseline `_pad_fused` tops each FUSED call's block
    list up to it at launch time, so each fused plan's packed buffer
    carries those pad word columns. The merge replicates that padding
    INSIDE the plan's span -- the demuxed slice's live word columns equal
    the baseline buffer bit for bit (a multi-block span may then widen to
    its node-block-tier word width with further all-zero columns, which the
    group-span decode never reads -- that's what pins lane_slice's compiled
    shapes to a bounded ladder)."""
    arg_list = [args for _, args in entries]
    offs, widths, used, b_total = _layout(arg_list)
    sb = np.zeros((b_total, 3), np.int32)
    sknd = np.zeros(b_total, np.int32)
    subj_node = np.full(b_total, -9, np.int32)
    # recorded CSRs are already tier-padded per plan; restack only the live
    # entries so the merged nnz tier tracks the real total
    live_of, live_keys = [], []
    slots_all: List[int] = []
    blocks: List[tuple] = []
    spans: List[tuple] = []
    base = 0
    w_off = 0
    for p, (plan, args) in enumerate(entries):
        b = widths[p]
        r0 = offs[p]
        sb[r0:r0 + b] = args["sb"]
        sknd[r0:r0 + b] = args["sknd"]
        ngroups = args["ngroups"]
        # global slot ids: plan_base + local group index; the plan's
        # padding sentinel (plan_base + ngroups) matches no block
        subj_node[r0:r0 + b] = base + args["subj_store"]
        local = args["subj_of"]
        mask = local < b
        live_of.append(np.where(mask, local + r0, 0)[mask])
        live_keys.append(args["subj_keys"][mask])
        w_lo = w_off
        nreal = 0
        nspan = 0
        cap_plan = 0
        caps = set()
        for gslot, snap_ in zip(args["slots"], args["ksnaps"]):
            bm, ts, _ex, kinds, valid = snap_
            blocks.append((bm, ts, kinds, valid))
            slots_all.append(base + int(gslot))
            w_off += bm.shape[0] // 32
            nreal += 1
            caps.add(bm.shape[0])
            cap_plan = max(cap_plan, bm.shape[0])
        nspan = nreal
        tier_p = args["pad_tier"] if args["fused"] else None
        if tier_p and nreal < tier_p:
            pad = pad_block(cap_plan)
            for _ in range(tier_p - nreal):
                blocks.append(pad)
                slots_all.append(-1)
                w_off += cap_plan // 32
            nspan = tier_p
        # demux-span WIDTH tier (the lane_slice zero-recompile fix): pad a
        # multi-block uniform-cap span out to the node-block tier's word
        # width with empty blocks, so harvest slice shapes land on the
        # (subject tier x block tier) ladder instead of minting one shape
        # per participating store count. Single-block spans are already
        # tiered by the arena cap ladder; mixed-cap spans (arenas caught
        # mid-growth) keep their exact width.
        if nspan > 1 and len(caps) == 1 and cap_plan:
            bw = cap_plan // 32
            want = node_block_tier(nspan, node_tiers) * bw
            pad = pad_block(cap_plan)
            while w_off - w_lo < want:
                blocks.append(pad)
                slots_all.append(-1)
                w_off += bw
        spans.append((r0, b, w_lo, w_off - w_lo))
        base += ngroups + 1
    # block-count tier: cached empty blocks under slot -1 (no subject's
    # lane is negative), capacity matching the widest real block so the
    # compiled shape tracks arena growth
    tier = node_block_tier(len(blocks), node_tiers)
    if blocks and len(blocks) < tier:
        cap = max(b[0].shape[0] for b in blocks)
        pad = pad_block(cap)
        while len(blocks) < tier:
            blocks.append(pad)
            slots_all.append(-1)
    total_live = sum(a.shape[0] for a in live_of)
    z = nnz_tier(total_live) if total_live else nnz_tier(1)
    subj_of = np.full(z, b_total, np.int32)
    subj_keys = np.zeros(z, np.int32)
    if total_live:
        subj_of[:total_live] = np.concatenate(live_of)
        subj_keys[:total_live] = np.concatenate(live_keys)
    return KeyMerge(subj_of, subj_keys, subj_node, sb, sknd,
                    np.asarray(slots_all, np.int32), tuple(blocks), spans,
                    used, b_total)


def build_range_merge(entries, pad_key_block, pad_range_block,
                      node_tiers=None) -> RangeMerge:
    """Stack each plan's recorded range_args into one node-major dispatch:
    the merged interval CSR plus plan-major range-arena and key-arena
    block lists (independently tier-padded). Each fused plan's recorded
    `pad_tier` replicates the baseline's per-plan `_pad_fused` padding
    inside that plan's span on BOTH sides (see build_key_merge); a side
    whose baseline result is discarded (has_r/has_k False) contributes no
    blocks at all."""
    arg_list = [args for _, args in entries]
    offs, widths, used, b_total = _layout(arg_list)
    sb = np.zeros((b_total, 3), np.int32)
    sknd = np.zeros(b_total, np.int32)
    srng = np.zeros(b_total, bool)
    subj_node = np.full(b_total, -9, np.int32)
    live_of, live_s, live_e = [], [], []
    r_slots: List[int] = []
    k_slots: List[int] = []
    r_blocks: List[tuple] = []
    k_blocks: List[tuple] = []
    spans: List[tuple] = []
    base = 0
    rw_off = kw_off = 0
    for p, (plan, args) in enumerate(entries):
        b = widths[p]
        r0 = offs[p]
        sb[r0:r0 + b] = args["sb"]
        sknd[r0:r0 + b] = args["sknd"]
        srng[r0:r0 + b] = args["srng"]
        ngroups = args["ngroups"]
        subj_node[r0:r0 + b] = base + args["subj_store"]
        local = args["iv_of"]
        mask = local < b
        live_of.append(np.where(mask, local + r0, 0)[mask])
        live_s.append(args["iv_s"][mask])
        live_e.append(args["iv_e"][mask])
        rw_lo, kw_lo = rw_off, kw_off
        tier_p = args["pad_tier"] if args["fused"] else None
        nreal_r = 0
        rcap_plan = 0
        rcaps = set()
        if args["has_r"]:
            for gslot, snap_ in zip(args["r_slots"], args["rsnaps"]):
                r_blocks.append(snap_)
                r_slots.append(base + int(gslot))
                rw_off += snap_[0].shape[0] // 32
                nreal_r += 1
                rcaps.add(snap_[0].shape[0])
                rcap_plan = max(rcap_plan, snap_[0].shape[0])
            nspan_r = nreal_r
            if tier_p and nreal_r < tier_p:
                pad = pad_range_block(rcap_plan)
                for _ in range(tier_p - nreal_r):
                    r_blocks.append(pad)
                    r_slots.append(-1)
                    rw_off += rcap_plan // 32
                nspan_r = tier_p
            # span-width tier, exactly as build_key_merge
            if nspan_r > 1 and len(rcaps) == 1 and rcap_plan:
                bw = rcap_plan // 32
                want = node_block_tier(nspan_r, node_tiers) * bw
                pad = pad_range_block(rcap_plan)
                while rw_off - rw_lo < want:
                    r_blocks.append(pad)
                    r_slots.append(-1)
                    rw_off += bw
        nreal_k = 0
        kcap_plan = 0
        kcaps = set()
        if args["has_k"]:
            for gslot, snap_ in zip(args["k_slots"], args["ksnaps"]):
                bm, ts, _ex, kinds, valid = snap_
                k_blocks.append((bm, ts, kinds, valid))
                k_slots.append(base + int(gslot))
                kw_off += bm.shape[0] // 32
                nreal_k += 1
                kcaps.add(bm.shape[0])
                kcap_plan = max(kcap_plan, bm.shape[0])
            nspan_k = nreal_k
            if tier_p and nreal_k < tier_p:
                pad = pad_key_block(kcap_plan)
                for _ in range(tier_p - nreal_k):
                    k_blocks.append(pad)
                    k_slots.append(-1)
                    kw_off += kcap_plan // 32
                nspan_k = tier_p
            if nspan_k > 1 and len(kcaps) == 1 and kcap_plan:
                bw = kcap_plan // 32
                want = node_block_tier(nspan_k, node_tiers) * bw
                pad = pad_key_block(kcap_plan)
                while kw_off - kw_lo < want:
                    k_blocks.append(pad)
                    k_slots.append(-1)
                    kw_off += bw
        spans.append((r0, b, rw_lo, rw_off - rw_lo, kw_lo, kw_off - kw_lo))
        base += ngroups + 1
    rtier = node_block_tier(len(r_blocks), node_tiers) if r_blocks else 0
    if r_blocks and len(r_blocks) < rtier:
        cap = max(blk[0].shape[0] for blk in r_blocks)
        pad = pad_range_block(cap)
        while len(r_blocks) < rtier:
            r_blocks.append(pad)
            r_slots.append(-1)
    ktier = node_block_tier(len(k_blocks), node_tiers) if k_blocks else 0
    if k_blocks and len(k_blocks) < ktier:
        cap = max(blk[0].shape[0] for blk in k_blocks)
        pad = pad_key_block(cap)
        while len(k_blocks) < ktier:
            k_blocks.append(pad)
            k_slots.append(-1)
    total_live = sum(a.shape[0] for a in live_of)
    z = nnz_tier(total_live) if total_live else nnz_tier(1)
    iv_of = np.full(z, b_total, np.int32)
    iv_s = np.zeros(z, np.int32)
    iv_e = np.zeros(z, np.int32)
    if total_live:
        iv_of[:total_live] = np.concatenate(live_of)
        iv_s[:total_live] = np.concatenate(live_s)
        iv_e[:total_live] = np.concatenate(live_e)
    return RangeMerge(iv_of, iv_s, iv_e, subj_node, sb, sknd, srng,
                      np.asarray(r_slots, np.int32), tuple(r_blocks),
                      np.asarray(k_slots, np.int32), tuple(k_blocks),
                      spans, used, b_total)


def run_key_merge(merge: KeyMerge, witness_table):
    """Launch the merged key-domain dispatch (K13)."""
    return node_fused_deps_resolve(
        merge.subj_of, merge.subj_keys, merge.subj_node, merge.sb,
        merge.sknd, merge.slots, merge.blocks, witness_table)


def run_range_merge(merge: RangeMerge, witness_table):
    """Launch the merged range-domain dispatch (K14)."""
    return node_fused_range_deps_resolve(
        merge.iv_of, merge.iv_s, merge.iv_e, merge.subj_node, merge.sb,
        merge.sknd, merge.srng, merge.r_slots, merge.r_blocks,
        merge.k_slots, merge.k_blocks, witness_table)
