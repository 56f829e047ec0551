"""The resolver's device kernels: CUDA wrappers and their plain versions.

Each public function here is the counterpart of one function of the JAX
package's `ops/kernels.py` and returns bit for bit what it returns, with
two deliberate differences of representation:

  * packed words (32 arena rows per word, lowest row in the least
    significant bit) are carried as int32 bit patterns, because torch has
    no `>>` for uint32 on the CPU; the checksum word is an int32 too;
  * the arena's bucket bitmaps are PACKED, int32 [cap, K/32], instead of
    f32 [cap, K] (ops/carry.py converts a JAX arena).

For a CUDA tensor each wrapper launches its hand-written kernel from
`accord_tpu_torch/csrc/` (built on first use, see ops/_ext.py) and adds one
to its kernel's count in LAUNCHES; for a CPU tensor it runs the plain
PyTorch version beside it. There is no fallback from one to the other.

  kernel         source                  replaces (the JAX ops/kernels.py)
  deps_resolve   csrc/deps_resolve.cu    deps_resolve :268,
                                         fused_deps_resolve :305
  finalize_csr   csrc/finalize_csr.cu    finalize_csr :697 (body :736);
                 (finalize_csr_tab:      the table entry runs many in
                 one launch)             one launch (the tick's key
                                         finalizes)
  arena_scatter  csrc/arena_scatter.cu   arena_scatter :822,
                                         arena_scatter_keys :840
  row_scatter    csrc/row_scatter.cu     scatter_rows :242,
                 (the lane table; one    kid_word_scatter :250,
                 launch a call)          arena_grow :864; lane_table
                                         is all of them over up to 8
                                         lanes (a plane flush)
  range_scatter  csrc/row_scatter.cu     range_scatter :852
  range_resolve  csrc/range_resolve.cu   range_deps_resolve :415,
                                         fused_range_deps_resolve :367,
                                         covered_buckets :344
  range_finalize csrc/range_finalize.cu  range_finalize_csr :766 (body
                                         :799), _segment_compact :473
  max_conflict   csrc/max_conflict.cu    max_conflict :65
  exec_scatter   csrc/exec_scatter.cu    exec_scatter :224
  execution_frontier, fused_execution_frontier, frontier_compact
                 csrc/exec_frontier.cu   execution_frontier :143,
                                         fused_execution_frontier :174,
                                         frontier_compact :651 (body :619)
  cmd_tick       csrc/cmd_tick.cu        cmd_tick :1032 (body :1101)
  recovery_scan  csrc/recovery_scan.cu   recovery_scan :682 (body :667)
  cmd_repair     csrc/cmd_repair.cu      _cmd_repair_body :1347
  quorum_count   csrc/quorum.cu          protocol_tick's quorum stage
                                         :1410-1418
  protocol_tick  ops/tick_graph.py       protocol_tick :1434 (builder
                                         :1368): one CUDA graph per static
                                         signature, replayed once per call
  mailbox_route  csrc/mailbox_route.cu   ops/mailbox.py _mailbox_route_body
                 (wrapper in ops/mailbox.py) :75, protocol_tick's mailbox
                                         stage :1377, :1420-1421
  sharded_mailbox_route                  ops/mailbox.py
                 csrc/mailbox_shard.cu   _sharded_mailbox_route_part :100
                 (wrapper in ops/mailbox.py)
  deps_matrix, transitive_closure, execution_wavefronts,
  dag_wavefronts_packed
                 csrc/dense_dag.cu       deps_matrix :36,
                                         transitive_closure :97,
                                         execution_wavefronts :113,
                                         dag_wavefronts_packed :197
The node-lane kernels (K13-K15) live in ops/node_lane.py and count here
too. The mesh shards' entries (the last section below) run K1, K5, K2 and
K18-K20 on one shard of a sharded call of parallel/mesh.py, whose
combining steps (K22, csrc/mesh_combine.cu) and sharded entry points count
here as well, as do the sharded protocol megakernel's replays and stages
(parallel/mesh.sharded_protocol_tick, ops/tick_graph.py).

The exec plane's adjacency is PACKED too, int32 [cap, cap/32] (dep d in
bit d & 31 of word d >> 5), where the reference keeps bool [cap, cap].

Scatter indices follow jnp's `.at[]` rules: a negative index counts from
the end, and one still out of range is dropped (the padding sentinels B,
cap and KC), where torch's own indexing would raise.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from accord_tpu_torch.ops.tiers import snap

INT32_MIN = -(1 << 31)
_M32 = 0xFFFFFFFF

# launches per kernel (one per wrapper call that reached the card; K4's and
# K15's count kernel launches, which is one a call; finalize_csr_tab counts
# its table launches, each running many finalizes)
LAUNCHES: Dict[str, int] = {"deps_resolve": 0, "finalize_csr": 0,
                            "finalize_csr_tab": 0,
                            "arena_scatter": 0, "row_scatter": 0,
                            "range_scatter": 0, "range_resolve": 0,
                            "range_finalize": 0, "max_conflict": 0,
                            "exec_scatter": 0, "execution_frontier": 0,
                            "fused_execution_frontier": 0,
                            "frontier_compact": 0, "cmd_tick": 0,
                            "recovery_scan": 0, "cmd_repair": 0,
                            "node_deps_resolve": 0, "node_range_resolve": 0,
                            "lane_slice": 0, "quorum_count": 0,
                            "protocol_tick": 0, "mailbox_route": 0,
                            "deps_matrix": 0, "transitive_closure": 0,
                            "execution_wavefronts": 0,
                            "dag_wavefronts_packed": 0,
                            # a mesh shard's launches (parallel/mesh.py)
                            "deps_resolve_shard": 0,
                            "range_resolve_shard": 0, "finalize_shard": 0,
                            "deps_matrix_shard": 0, "pack_rows": 0,
                            "closure_rows": 0, "wavefront_rows": 0,
                            # K22, the mesh's combining steps
                            "or_fold": 0, "lane_concat": 0,
                            "counts_scan": 0, "fragment_merge": 0,
                            # the sharded protocol megakernel: its replays,
                            # its shard-table stages, K23
                            "sharded_protocol_tick": 0, "node_key_shard": 0,
                            "node_range_shard": 0, "finalize_shard_tab": 0,
                            "sharded_mailbox_route": 0,
                            # the eager sharded entries with every shard on
                            # one card: their single-device twins' launches
                            # (K1, K13, K5, K14, K2), counted apart
                            "deps_resolve_one_card": 0,
                            "node_deps_one_card": 0,
                            "range_resolve_one_card": 0,
                            "node_range_one_card": 0,
                            "finalize_one_card": 0}

# the launches above made inside each sharded entry point (parallel/mesh.py
# launches nothing itself: its shards and combining steps do)
ENTRY_LAUNCHES: Dict[str, int] = {"sharded_deps_resolve": 0,
                                  "sharded_range_deps_resolve": 0,
                                  "sharded_fused_deps_resolve": 0,
                                  "sharded_fused_range_deps_resolve": 0,
                                  "sharded_finalize_csr": 0,
                                  "sharded_deps_step": 0,
                                  # sharded_protocol_tick across cards,
                                  # stage by stage (no graph)
                                  "sharded_protocol_tick_stages": 0}

# CUDA graphs captured by protocol_tick and sharded_protocol_tick (one per
# new static signature): after a warm pass, a run over the same traffic
# must capture none; and graphs dropped from their bounded cache
# (ops/tick_graph.py MAX_GRAPHS, MAX_GRAPH_BYTES)
CAPTURES: Dict[str, int] = {"protocol_tick": 0, "sharded_protocol_tick": 0,
                            "evictions": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in ENTRY_LAUNCHES:
        ENTRY_LAUNCHES[k] = 0
    for k in CAPTURES:
        CAPTURES[k] = 0


def _ext():
    from accord_tpu_torch.ops import _ext as ext
    return ext


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device`, never aliasing `a`. To a card
    it goes through pinned memory with a non-blocking copy (a pageable
    copy would wait for every launch queued before it)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def upload_many(arrays, device):
    """Host arrays as tensors on `device` through ONE host-to-device copy:
    packed into one byte buffer, each at a 16-byte boundary, and viewed
    back with its own dtype and shape (never aliasing the arrays)."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // 16) * 16
    buf = np.empty(total, np.uint8)
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    dev = upload(buf, device)
    return [dev[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, o in zip(arrays, offs)]


def _addr(x) -> ctypes.c_void_p:
    """A launch operand's device address: a tensor's data pointer, a
    ctypes pointer as it is, None as null. The wrappers pass this as the
    `A` of the shared launch functions; ops/tick_graph.py passes its own,
    over the graph's memory regions."""
    if x is None:
        return ctypes.c_void_p(None)
    if isinstance(x, ctypes.c_void_p):
        return x
    return ctypes.c_void_p(x.data_ptr())


def _dtype_name(x) -> str:
    """'int32', 'bool', ... for a tensor or a numpy array alike."""
    return str(x.dtype).replace("torch.", "")


def _check_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous tensors on "
                             f"one device (got {t.device}, "
                             f"contiguous={t.is_contiguous()})")


# -- bit helpers (plain) -----------------------------------------------------
def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value -> the int32 with the same bits."""
    v = v & _M32
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its u32 value in int64."""
    return x.to(torch.int64) & _M32


def _pack_bits(m: torch.Tensor) -> torch.Tensor:
    """bool[B, A] -> i32[B, A/32] bit patterns, lowest row in bit 0."""
    b, a = m.shape
    weights = torch.ones(32, dtype=torch.int64, device=m.device) \
        << torch.arange(32, device=m.device)
    words = (m.reshape(b, a // 32, 32).to(torch.int64) * weights).sum(-1)
    return _to_i32(words)


def _popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount per 32-bit word (int32 bit patterns) -> int32."""
    v = _u32(x)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & _M32) >> 24).to(torch.int32)


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """i32[..., W] bit patterns -> bool[..., W*32]."""
    shifts = torch.arange(32, device=words.device)
    bits = (_u32(words)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).bool()


def _norm_index(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """jnp `.at[]` index rules: (normalized index, in-range mask)."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, idx, torch.zeros_like(idx)), ok


def _gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """jnp gather rules: wrap negatives once, then clamp."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, n - 1)


def _lex_before(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b lexicographically over 3 int32 lanes (broadcasting)."""
    return ((a[..., 0] < b[..., 0])
            | ((a[..., 0] == b[..., 0])
               & ((a[..., 1] < b[..., 1])
                  | ((a[..., 1] == b[..., 1]) & (a[..., 2] < b[..., 2])))))


# -- K1: deps_resolve / fused_deps_resolve -----------------------------------
def _subject_words(subj_of, subj_keys, b: int, k: int, base: int = 0,
                   k_local=None) -> torch.Tensor:
    """Packed subject bitmaps i32[B, k_local/32] of the bucket slice [base,
    base + k_local) of k buckets (one device: the whole of k) from the
    subject CSR; entries out of range (pad subj_of == B) are dropped, and
    a key is normalised over k before the slice test."""
    k_local = k if k_local is None else k_local
    s, s_ok = _norm_index(subj_of, b)
    key, k_ok = _norm_index(subj_keys, k)
    col = key - base
    ok = s_ok & k_ok & (col >= 0) & (col < k_local)
    bm = torch.zeros(b, k_local, dtype=torch.bool, device=subj_of.device)
    bm[s[ok], col[ok]] = True
    return _pack_bits(bm)


def _resolve_block_plain(subj_words, subj_before, subj_kinds, mine,
                         act_bm, act_ts, act_kinds, act_valid,
                         witness_table) -> torch.Tensor:
    b = subj_words.shape[0]
    cap = act_bm.shape[0]
    if mine is not None:
        # only the block's own subjects can have a bit: compute those rows
        rows = torch.nonzero(mine).flatten()
        out = torch.zeros(b, cap // 32, dtype=torch.int32,
                          device=act_bm.device)
        if rows.numel():
            out[rows] = _resolve_block_plain(
                subj_words[rows], subj_before[rows], subj_kinds[rows], None,
                act_bm, act_ts, act_kinds, act_valid, witness_table)
        return out
    nk = witness_table.shape[0]
    sk = _gather_index(subj_kinds, nk)
    ak = _gather_index(act_kinds, nk)
    witness = witness_table[sk[:, None], ak[None, :]] == 1
    before = _lex_before(act_ts[None, :, :], subj_before[:, None, :])
    mask = witness & before & act_valid[None, :]
    overlap = torch.zeros(b, cap, dtype=torch.bool, device=act_bm.device)
    # bound the [chunk, cap, K/32] AND temporary to ~64M words
    step = max(1, (1 << 26) // max(1, cap * act_bm.shape[1]))
    for lo in range(0, b, step):
        sw = subj_words[lo:lo + step]
        overlap[lo:lo + step] = ((sw[:, None, :] & act_bm[None, :, :]) != 0) \
            .any(-1)
    return _pack_bits(overlap & mask)


def deps_resolve_plain(subj_of, subj_keys, subj_before, subj_kinds,
                       act_bitmaps, act_ts, act_kinds, act_valid,
                       witness_table) -> torch.Tensor:
    b = subj_before.shape[0]
    k = act_bitmaps.shape[1] * 32
    words = _subject_words(subj_of, subj_keys, b, k)
    return _resolve_block_plain(words, subj_before, subj_kinds, None,
                                act_bitmaps, act_ts, act_kinds, act_valid,
                                witness_table)


def fused_deps_resolve_plain(subj_of, subj_keys, subj_store, subj_before,
                             subj_kinds, slots, arenas,
                             witness_table) -> torch.Tensor:
    b = subj_before.shape[0]
    k = arenas[0][0].shape[1] * 32
    words = _subject_words(subj_of, subj_keys, b, k)
    outs = []
    for s, (bm, ts, kinds, valid) in enumerate(arenas):
        mine = subj_store == slots[s]
        outs.append(_resolve_block_plain(words, subj_before, subj_kinds,
                                         mine, bm, ts, kinds, valid,
                                         witness_table))
    return torch.cat(outs, dim=1)


_VP, _I = ctypes.c_void_p, ctypes.c_int
# deps_subjects_slice and deps_block (csrc/deps_resolve.cu), lean launches
_DEPS_SUBJ_ARGS = (_VP, _VP, _I, _I, _I, _I, _I, _VP, _VP)
_DEPS_BLOCK_ARGS = (_VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _VP, _VP, _VP, _I,
                    _I, _VP, _I, _VP, _I, _I, _VP)


def _deps_subjects(ext, subj_of, subj_keys, b: int, k_total: int, base: int,
                   k_local: int, words, st: int) -> None:
    """K1's subject pass: the packed subject words of the bucket slice
    [base, base + k_local) of k_total into `words` (zeroed first)."""
    ext.entry("deps_resolve", "deps_subjects_slice", _DEPS_SUBJ_ARGS)(
        subj_of.data_ptr(), subj_keys.data_ptr(), subj_of.shape[0], b,
        k_total, base, k_local, words.data_ptr(), st)


def resolve_launcher(subj_of, subj_keys, subj_store, subj_before,
                     subj_kinds, slots, arenas, witness_table):
    """K1 on the card, split at its body: the subject pass runs now (its
    words in a fresh buffer) -> (launch, out). launch() is the body, one
    deps_block launch per store block writing its span of out [B,
    sum(cap)/32]; a CUDA graph can capture it alone."""
    ext = _ext()
    b = subj_before.shape[0]
    nw = arenas[0][0].shape[1]
    if nw > 32:
        raise ValueError(f"deps_resolve kernel takes K <= 1024 buckets "
                         f"(got {nw * 32})")
    _check_cuda(subj_of, subj_keys, subj_before, subj_kinds, witness_table,
                *[t for a in arenas for t in a],
                *((subj_store, slots) if slots is not None else ()))
    dev = subj_before.device
    st = ext.raw_stream(dev.index)
    words = torch.empty(b, nw, dtype=torch.int32, device=dev)
    _deps_subjects(ext, subj_of, subj_keys, b, nw * 32, 0, nw * 32, words,
                   st)
    wtot = sum(a[0].shape[0] // 32 for a in arenas)
    out = torch.empty(b, wtot, dtype=torch.int32, device=dev)
    calls, off = [], 0
    store = subj_store.data_ptr() if subj_store is not None else None
    for s, (bm, ts, kinds, valid) in enumerate(arenas):
        cap = bm.shape[0]
        if bm.shape[1] != nw:
            raise ValueError("arena blocks differ in bucket count")
        calls.append((words.data_ptr(), subj_before.data_ptr(),
                      subj_kinds.data_ptr(), store,
                      slots.data_ptr() + 4 * s if slots is not None
                      else None, b, bm.data_ptr(), nw, ts.data_ptr(),
                      kinds.data_ptr(), valid.data_ptr(), cap, nw,
                      witness_table.data_ptr(), witness_table.shape[0],
                      out.data_ptr(), wtot, off))
        off += cap // 32

    def launch(words=words, idx=dev.index):
        body = ext.entry("deps_resolve", "deps_block", _DEPS_BLOCK_ARGS)
        st = ext.raw_stream(idx)
        for c in calls:
            body(*c, st)
    return launch, out


def _resolve_cuda(subj_of, subj_keys, subj_store, subj_before, subj_kinds,
                  slots, arenas, witness_table,
                  count: str = "deps_resolve") -> torch.Tensor:
    launch, out = resolve_launcher(subj_of, subj_keys, subj_store,
                                   subj_before, subj_kinds, slots, arenas,
                                   witness_table)
    launch()
    LAUNCHES[count] += 1
    return out


def deps_resolve(subj_of, subj_keys, subj_before, subj_kinds,
                 act_bitmaps, act_ts, act_kinds, act_valid,
                 witness_table) -> torch.Tensor:
    """Packed dependency words i32[B, cap/32] of every subject against one
    store arena: bucket overlap (subject CSR vs packed bitmaps), AND
    `witness_table[subj_kind, row_kind] == 1`, AND row ts < subject's
    before (3-lane lexicographic), AND valid. CSR padding uses subj_of == B.
    """
    if act_bitmaps.is_cuda:
        return _resolve_cuda(subj_of, subj_keys, None, subj_before,
                             subj_kinds, None,
                             ((act_bitmaps, act_ts, act_kinds, act_valid),),
                             witness_table)
    return deps_resolve_plain(subj_of, subj_keys, subj_before, subj_kinds,
                              act_bitmaps, act_ts, act_kinds, act_valid,
                              witness_table)


def fused_deps_resolve(subj_of, subj_keys, subj_store, subj_before,
                       subj_kinds, slots, arenas,
                       witness_table) -> torch.Tensor:
    """deps_resolve over a tuple of store arenas (bitmaps, ts, kinds,
    valid); block s answers only subjects with subj_store == slots[s]; the
    packed blocks concatenate on the word axis."""
    if arenas[0][0].is_cuda:
        return _resolve_cuda(subj_of, subj_keys, subj_store, subj_before,
                             subj_kinds, slots, arenas, witness_table)
    return fused_deps_resolve_plain(subj_of, subj_keys, subj_store,
                                    subj_before, subj_kinds, slots, arenas,
                                    witness_table)


# -- K2: finalize_csr --------------------------------------------------------
def _packed_segment_compact(m: torch.Tensor, out_cap: int):
    """Bit-packed segment compaction: m i32[S, W] -> (indptr i32[S+1],
    dep_rows i32[out_cap]); dep_rows holds the set bits' row indices in
    (segment, row) order, the first out_cap of them, 0 beyond."""
    counts = _popcount_u32(m).sum(dim=1, dtype=torch.int64)
    indptr = torch.zeros(m.shape[0] + 1, dtype=torch.int64, device=m.device)
    indptr[1:] = torch.cumsum(counts, 0)
    _, rows = torch.nonzero(_unpack_bits(m), as_tuple=True)
    dep_rows = torch.zeros(out_cap, dtype=torch.int32, device=m.device)
    n = min(out_cap, rows.shape[0])
    dep_rows[:n] = rows[:n].to(torch.int32)
    return _to_i32(indptr), dep_rows


def _csum_fold(x: torch.Tensor, seed: int) -> int:
    """Position-weighted wrapping u32 fold of one lane (int64 arithmetic
    masked to 32 bits)."""
    v = _u32(x.reshape(-1))
    v = v ^ (v >> 16)
    idx = torch.arange(v.shape[0], dtype=torch.int64, device=x.device)
    return int(((v * ((2 * idx + seed) & _M32)) & _M32).sum().item()) & _M32


def csr_checksum(indptr, dep_rows, dep_ts) -> torch.Tensor:
    """The finalize integrity word, as an int32 bit pattern (0-d)."""
    word = (_csum_fold(indptr, 1) ^ _csum_fold(dep_rows, 5)
            ^ _csum_fold(dep_ts, 9))
    return _to_i32(torch.tensor(word, dtype=torch.int64,
                                device=indptr.device))


def csr_checksum_host(indptr, dep_rows, dep_ts) -> int:
    """numpy twin of csr_checksum, over fetched host copies (u32 value)."""
    def fold(x, seed):
        v = np.ascontiguousarray(x).view(np.uint32).reshape(-1)
        v = v ^ (v >> np.uint32(16))
        idx = np.arange(v.shape[0], dtype=np.uint32)
        return (v * (np.uint32(2) * idx + np.uint32(seed))).sum(
            dtype=np.uint32)
    return int(fold(indptr, 1) ^ fold(dep_rows, 5) ^ fold(dep_ts, 9))


def _span_offset(packed, kid_rows, word_off: int) -> int:
    """jax.lax.dynamic_slice clamps the start so the span stays in range."""
    return min(max(int(word_off), 0), packed.shape[1] - kid_rows.shape[1])


def finalize_csr_plain(packed, word_off, kid_rows, slot_subj, slot_kid,
                       subj_row, act_ts, out_cap: int):
    b = packed.shape[0]
    kc, w = kid_rows.shape
    off = _span_offset(packed, kid_rows, word_off)
    blk = packed[:, off:off + w]
    ok = (slot_subj >= 0) & (slot_subj < b) & (slot_kid >= 0) \
        & (slot_kid < kc)
    kid_m = kid_rows[slot_kid.to(torch.int64).clamp(0, kc - 1)]
    bound = torch.where(ok, _popcount_u32(kid_m).sum(1, dtype=torch.int64),
                        torch.zeros_like(ok, dtype=torch.int64)).sum()
    so = slot_subj.to(torch.int64).clamp(0, b - 1)
    m = torch.where(ok[:, None], blk[so] & kid_m,
                    torch.zeros_like(kid_m))
    r = subj_row[so].to(torch.int64)
    widx = torch.arange(w, device=packed.device)
    self_word = (r >= 0)[:, None] & (widx[None, :] == (r >> 5)[:, None])
    selfbit = torch.where(self_word, _to_i32(1 << (r & 31))[:, None],
                          torch.zeros((), dtype=torch.int32,
                                      device=packed.device))
    m = m & ~selfbit
    indptr, dep_rows = _packed_segment_compact(m, out_cap)
    dep_ts = act_ts[dep_rows.to(torch.int64)]
    return (indptr, dep_rows, dep_ts, _to_i32(bound),
            csr_checksum(indptr, dep_rows, dep_ts))


# The one-launch compaction (csrc/common.cuh launch_csr) of K2, K6, K9's
# compact entry and K11: its tiles and its zeroed scratch.
CSR_TILE_WORDS = 1024       # csrc/common.cuh CW: words a compaction tile
_CSR_HDR = 16               # sizeof(CsrHdr)
_CSR_ACC = 16               # sizeof(CsrAcc), one a spec


@functools.lru_cache(maxsize=None)
def csr_sizes() -> Tuple[int, int, int]:
    """(words a compaction tile, positions a pad tile, words a K6 tile), as
    the built sources define them (csrc/common.cuh CW and CP,
    csrc/range_finalize.cu RF_TW)."""
    ext = _ext()
    fin = ext.lib("finalize_csr")
    got = (int(fin.csr_tile_words()), int(fin.csr_pad_positions()),
           int(ext.lib("range_finalize").range_finalize_tile_words()))
    if got[0] != CSR_TILE_WORDS:
        raise RuntimeError("CSR_TILE_WORDS differs from common.cuh CW")
    return got


def csr_tiles(n_words: int, out_cap: int,
              tile_words: int = CSR_TILE_WORDS) -> Tuple[int, int]:
    """(compaction tiles, pad tiles) of one compaction over n_words words
    (tile_words a compaction tile) into out_cap rows."""
    return (-(-int(n_words) // tile_words),
            max(1, -(-int(out_cap) // csr_sizes()[1])))


def csr_scratch_bytes(nspec: int, ctiles: int) -> int:
    """Zeroed scratch bytes of a compaction launch over nspec specs with
    ctiles compaction tiles in all (its header, partial sums a spec, a
    state word a tile)."""
    return _CSR_HDR + _CSR_ACC * nspec + 8 * ctiles


# per card: the zeroed scratch every eager compaction and cmd_tick launch
# shares (see zeroed_scratch)
_SCRATCH: Dict[int, torch.Tensor] = {}


def zeroed_scratch(dev, nbytes: int) -> int:
    """The device address of at least nbytes of card `dev`'s zeroed
    scratch. The kernels that take it (the one-launch compaction, K10's
    ticket) leave it zeroed at their end, and the port launches them on
    one stream a card, in order, so every call shares one buffer: no
    allocation and no memset a call. Allocated (zeroed) once and grown
    when a call needs more, which may not happen inside a graph capture
    (capture after one eager call of the same size)."""
    dev = torch.device(dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    buf = _SCRATCH.get(idx)
    if buf is None or buf.numel() < nbytes:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("zeroed_scratch: the scratch must grow, "
                               "which a graph capture cannot; call the "
                               "kernel once before capturing it")
        old = 0 if buf is None else buf.numel()
        buf = torch.zeros(max(int(nbytes), 2 * old, 1 << 16),
                          dtype=torch.uint8, device=torch.device("cuda", idx))
        _SCRATCH[idx] = buf
    return buf.data_ptr()


def _csr_scratch(dev, n_words: int,
                 tile_words: int = CSR_TILE_WORDS) -> int:
    """The zeroed scratch of one spec's compaction over n_words words."""
    return zeroed_scratch(dev, csr_scratch_bytes(
        1, csr_tiles(n_words, 0, tile_words)[0]))


def _i32_outs(dev, *shapes):
    """Fresh int32 outputs of these shapes, views of ONE allocation."""
    sizes = [int(np.prod(sh, dtype=np.int64)) for sh in shapes]
    buf = torch.empty(max(1, sum(sizes)), dtype=torch.int32, device=dev)
    outs, off = [], 0
    for sh, n in zip(shapes, sizes):
        outs.append(buf[off:off + n].view(sh))
        off += n
    return outs


_FIN_ARGS = (_VP, _I, _I, _I, _VP, _I, _I, _VP, _VP, _I, _VP, _VP, _I,
             _VP, _VP, _VP, _VP, _VP, _VP, _VP)


def _finalize_cuda(packed, word_off, kid_rows, slot_subj, slot_kid,
                   subj_row, act_ts, out_cap: int,
                   count: str = "finalize_csr"):
    ext = _ext()
    _check_cuda(packed, kid_rows, slot_subj, slot_kid, subj_row, act_ts)
    dev = packed.device
    b, wt = packed.shape
    kc, w = kid_rows.shape
    s = slot_subj.shape[0]
    off = _span_offset(packed, kid_rows, word_off)
    outs = _i32_outs(dev, (s + 1,), (out_cap,), (out_cap, 3), (), ())
    ext.entry("finalize_csr", "finalize_csr", _FIN_ARGS)(
        packed.data_ptr(), b, wt, off, kid_rows.data_ptr(), kc, w,
        slot_subj.data_ptr(), slot_kid.data_ptr(), s, subj_row.data_ptr(),
        act_ts.data_ptr(), out_cap, *(o.data_ptr() for o in outs),
        _csr_scratch(dev, s * w), ext.raw_stream(dev.index))
    LAUNCHES[count] += 1
    return tuple(outs)


def finalize_csr(packed, word_off, kid_rows, slot_subj, slot_kid,
                 subj_row, act_ts, out_cap: int):
    """Exact, already-translated dep lists from one store's word span of
    the packed deps result: (indptr i32[S+1], dep_rows i32[out_cap],
    dep_ts i32[out_cap, 3], bound i32, csum i32 bit pattern); see
    csrc/finalize_csr.cu for the contract."""
    if packed.is_cuda:
        return _finalize_cuda(packed, word_off, kid_rows, slot_subj,
                              slot_kid, subj_row, act_ts, out_cap)
    return finalize_csr_plain(packed, word_off, kid_rows, slot_subj,
                              slot_kid, subj_row, act_ts, out_cap)


def finalize_csr_tab_plain(specs):
    return tuple(finalize_csr_plain(*sp) for sp in specs)


def fin_tab_layout(dims):
    """The tiles of a finalize table over specs of dims (s, w, out_cap):
    (each spec's (tile0, pad0), all tiles, compaction tiles)."""
    tiles = [csr_tiles(s * w, oc) for s, w, oc in dims]
    ctiles = sum(t[0] for t in tiles)
    firsts, c0, p0 = [], 0, ctiles
    for nt, npad in tiles:
        firsts.append((c0, p0))
        c0 += nt
        p0 += npad
    return firsts, p0, ctiles


def fin_ent_pack(ext, dst: int, fin: int, s: int, w: int, act_ts: int,
                 out_cap: int, outs, scratch: int, nspec: int, k: int,
                 first) -> None:
    """Write spec k's FinEnt record (csrc/finalize_csr.cu) to host address
    dst: its FinIn at device address fin, its act_ts and five outputs
    (device addresses), the table's scratch and its first tiles."""
    ext.entry("finalize_csr", "fin_ent_pack",
              (_VP, _VP, _I, _I, _VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _I,
               _I, _I, _I))(dst, fin, s, w, act_ts, out_cap, *outs, scratch,
                            nspec, k, *first)


# the sharded finalize table (csrc/finalize_csr.cu fin_shard_tab): its
# records, packed on the host, and its launch
_SHARD_FIN_PACK_ARGS = (_VP, _VP, _I, _I, _VP, _I, _I, _I, _I, _VP, _VP,
                        _VP)
_SHARD_ENT_PACK_ARGS = (_VP, _VP, _I, _I, _I, _VP, _I, _VP, _VP, _VP, _VP,
                        _VP, _VP, _I, _I, _I, _I)
_FIN_TAB_ARGS = (_VP, _I, _I, _I, _VP, _VP)


def shard_fin_pack(ext, dst: int, blk: int, blk_stride: int, b: int,
                   kid: int, kid_stride: int, kc: int, wl: int, base_w: int,
                   slot_subj: int, slot_kid: int, subj_row: int) -> None:
    """Write one data shard's ShardFin record to host address dst: its
    columns of the packed span (blk, row stride blk_stride, b rows) and of
    the kid table (kid, row stride kid_stride, kc rows) from word base_w,
    wl words, and the slot lanes (device addresses)."""
    ext.entry("finalize_csr", "shard_fin_pack", _SHARD_FIN_PACK_ARGS)(
        dst, blk, blk_stride, b, kid, kid_stride, kc, wl, base_w, slot_subj,
        slot_kid, subj_row)


def shard_ent_pack(ext, dst: int, rec: int, data: int, wl: int, s: int,
                   act_ts: int, out_cap: int, outs, scratch: int, nspec: int,
                   k: int, first) -> None:
    """Write finalize k's ShardEnt record to host address dst: its `data`
    ShardFin records at device address rec, its act_ts and five outputs
    (device addresses), the table's scratch and its first tiles
    (fin_tab_layout over s slots of data * wl words)."""
    ext.entry("finalize_csr", "shard_ent_pack", _SHARD_ENT_PACK_ARGS)(
        dst, rec, data, wl, s, act_ts, out_cap, *outs, scratch, nspec, k,
        *first)


def launch_fin_shard_tab(ext, tab: int, n: int, tiles: int, ctiles: int,
                         scratch: int, stream: int) -> None:
    """ONE launch of the sharded finalize table over n ShardEnt records at
    device address tab."""
    ext.entry("finalize_csr", "fin_shard_tab", _FIN_TAB_ARGS)(
        tab, n, tiles, ctiles, scratch, stream)


def fin_tab_launcher(specs):
    """K2's table entry over finalize specs, each (packed, word_off,
    kid_rows, slot_subj, slot_kid, subj_row, act_ts, out_cap) on one card:
    its FinIn and FinEnt records uploaded (one copy) and its outputs made
    -> (launch, outs). launch() is the ONE kernel launch that runs every
    finalize (a CUDA graph can capture it alone); outs are each spec's
    five outputs (finalize_csr's)."""
    ext = _ext()
    dev = specs[0][0].device
    lib = ext.lib("finalize_csr")
    fin_b, ent_b = int(lib.fin_in_bytes()), int(lib.fin_ent_bytes())
    n = len(specs)
    dims, outs = [], []
    for sp in specs:
        _check_cuda(specs[0][0], sp[0], *sp[2:7])
        s, w, out_cap = sp[3].shape[0], sp[2].shape[1], int(sp[7])
        dims.append((s, w, out_cap))
        outs.append(tuple(_i32_outs(dev, (s + 1,), (out_cap,),
                                    (out_cap, 3), (), ())))
    firsts, tiles, ctiles = fin_tab_layout(dims)
    scratch = zeroed_scratch(dev, csr_scratch_bytes(n, ctiles))
    host = torch.empty(n * (fin_b + ent_b), dtype=torch.uint8,
                       pin_memory=True)
    tab = torch.empty(host.shape[0], dtype=torch.uint8, device=dev)
    h0, d0 = host.data_ptr(), tab.data_ptr()
    for k, (sp, (s, w, out_cap)) in enumerate(zip(specs, dims)):
        packed, word_off, kid_rows, slot_subj, slot_kid, subj_row, act_ts = \
            sp[:7]
        lib.fin_in_pack(_VP(h0 + k * fin_b), _VP(packed.data_ptr()),
                        _I(packed.shape[0]), _I(packed.shape[1]),
                        _I(_span_offset(packed, kid_rows, word_off)),
                        _VP(kid_rows.data_ptr()), _I(kid_rows.shape[0]),
                        _I(w), _VP(slot_subj.data_ptr()),
                        _VP(slot_kid.data_ptr()), _I(s),
                        _VP(subj_row.data_ptr()))
        fin_ent_pack(ext, h0 + n * fin_b + k * ent_b, d0 + k * fin_b, s, w,
                     act_ts.data_ptr(), out_cap,
                     [o.data_ptr() for o in outs[k]], scratch, n, k,
                     firsts[k])
    tab.copy_(host, non_blocking=True)
    entry = ext.entry("finalize_csr", "finalize_csr_tab", _FIN_TAB_ARGS)

    def launch(tab=tab):
        entry(d0 + n * fin_b, n, tiles, ctiles, scratch,
              ext.raw_stream(dev.index))
        LAUNCHES["finalize_csr_tab"] += 1
    return launch, tuple(outs)


def finalize_csr_tab(specs):
    """finalize_csr over many specs, each (packed, word_off, kid_rows,
    slot_subj, slot_kid, subj_row, act_ts, out_cap): a tuple of each
    spec's five outputs. On the card ONE launch of K2's table entry runs
    them all (the protocol megakernel's key finalizes are one such node);
    the FinIn and FinEnt records go up in one copy (fin_tab_launcher)."""
    specs = tuple(specs)
    if not specs or not specs[0][0].is_cuda:
        return finalize_csr_tab_plain(specs)
    launch, outs = fin_tab_launcher(specs)
    launch()
    return outs


# -- K3: arena_scatter / arena_scatter_keys ----------------------------------
def _set_bits_plain(bitmaps, key_rows, key_mods) -> torch.Tensor:
    cap, nw = bitmaps.shape
    r, r_ok = _norm_index(key_rows, cap)
    k, k_ok = _norm_index(key_mods, nw * 32)
    ok = r_ok & k_ok
    bit = torch.unique(r[ok] * (nw * 32) + k[ok])
    word = bit >> 5
    add = torch.zeros(cap * nw, dtype=torch.int64, device=bitmaps.device)
    add.index_add_(0, word, torch.ones_like(bit) << (bit & 31))
    return bitmaps | _to_i32(add).reshape(cap, nw)


def _scatter_lane_plain(dst, idx, rows) -> torch.Tensor:
    out = dst.clone()
    i, ok = _norm_index(idx, dst.shape[0])
    out[i[ok]] = rows[ok]
    return out


def arena_scatter_plain(bitmaps, ts, exec_ts, kinds, valid, rows, key_rows,
                        key_mods, ts_rows, exec_rows, kind_rows, valid_rows):
    cap = bitmaps.shape[0]
    i, ok = _norm_index(rows, cap)
    cleared = bitmaps.clone()
    cleared[i[ok]] = 0
    return (_set_bits_plain(cleared, key_rows, key_mods),
            _scatter_lane_plain(ts, rows, ts_rows),
            _scatter_lane_plain(exec_ts, rows, exec_rows),
            _scatter_lane_plain(kinds, rows, kind_rows),
            _scatter_lane_plain(valid, rows, valid_rows))


def arena_scatter_keys_plain(bitmaps, rows, key_rows, key_mods):
    i, ok = _norm_index(rows, bitmaps.shape[0])
    cleared = bitmaps.clone()
    cleared[i[ok]] = 0
    return _set_bits_plain(cleared, key_rows, key_mods)


# arena_scatter (csrc/arena_scatter.cu: K3, one launch), a lean launch
_ARENA_SCATTER_ARGS = (_VP, _VP, _I, _I, *(_VP,) * 8, _VP, _I, _VP, _VP, _I,
                       *(_VP,) * 4, _I, _VP)


def _lane_views(buf: torch.Tensor, like) -> list:
    """Views of one uint8 buffer laid out as the tensors `like` (each at a
    16-byte aligned offset), each of its tensor's dtype and shape."""
    views, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        views.append(buf[off:off + n].view(t.dtype).view(t.shape))
        off += (n + 15) // 16 * 16
    return views


def _lanes_bytes(like) -> int:
    return sum((t.numel() * t.element_size() + 15) // 16 * 16 for t in like)


def _arena_scatter_cuda(bitmaps, rows, key_rows, key_mods, lanes=None):
    cap, nw = bitmaps.shape
    _check_cuda(bitmaps, rows, key_rows, key_mods,
                *(lanes if lanes is not None else ()))
    dev = bitmaps.device
    if lanes is not None:
        ts, exec_ts, kinds, valid, ts_rows, exec_rows, kind_rows, \
            valid_rows = lanes
        like = (bitmaps, ts, exec_ts, kinds, valid)
        # the five outputs in one allocation
        bm_out, *outs = _lane_views(
            torch.empty(_lanes_bytes(like), dtype=torch.uint8, device=dev),
            like)
        lane_ptrs = (outs[0].data_ptr(), ts.data_ptr(), outs[1].data_ptr(),
                     exec_ts.data_ptr(), outs[2].data_ptr(),
                     kinds.data_ptr(), outs[3].data_ptr(), valid.data_ptr())
        row_ptrs = (ts_rows.data_ptr(), exec_rows.data_ptr(),
                    kind_rows.data_ptr(), valid_rows.data_ptr())
    else:
        bm_out = torch.empty_like(bitmaps)
        outs = []
        lane_ptrs = (None,) * 8
        row_ptrs = (None,) * 4
    _ext().entry("arena_scatter", "arena_scatter", _ARENA_SCATTER_ARGS)(
        bm_out.data_ptr(), bitmaps.data_ptr(), cap, nw, *lane_ptrs,
        rows.data_ptr(), rows.shape[0], key_rows.data_ptr(),
        key_mods.data_ptr(), key_rows.shape[0], *row_ptrs,
        int(lanes is not None), _ext().raw_stream(dev.index))
    LAUNCHES["arena_scatter"] += 1
    return bm_out, outs


def arena_scatter(bitmaps, ts, exec_ts, kinds, valid, rows, key_rows,
                  key_mods, ts_rows, exec_rows, kind_rows, valid_rows):
    """Dirty rows into a fresh copy of the arena: each row's packed bitmap
    cleared, then its CSR (row, bucket) bits set (pad row == cap dropped);
    the ts / exec_ts / kinds / valid rows set."""
    if bitmaps.is_cuda:
        bm, outs = _arena_scatter_cuda(
            bitmaps, rows, key_rows, key_mods,
            (ts, exec_ts, kinds, valid, ts_rows, exec_rows, kind_rows,
             valid_rows))
        return (bm, *outs)
    return arena_scatter_plain(bitmaps, ts, exec_ts, kinds, valid, rows,
                               key_rows, key_mods, ts_rows, exec_rows,
                               kind_rows, valid_rows)


def arena_scatter_keys(bitmaps, rows, key_rows, key_mods):
    """arena_scatter for key-set-only changes: the bitmap alone."""
    if bitmaps.is_cuda:
        return _arena_scatter_cuda(bitmaps, rows, key_rows, key_mods)[0]
    return arena_scatter_keys_plain(bitmaps, rows, key_rows, key_mods)


# -- K4: the lane table (lane_table, scatter_rows, kid_word_scatter,
#    arena_grow, range_scatter) ---------------------------------------------
LANE_TABLE_MAX = 8          # csrc/row_scatter.cu LT_MAX


def _row_bytes(t: torch.Tensor) -> int:
    return t.element_size() * (t.numel() // max(t.shape[0], 1))


def _fill_pattern(t: torch.Tensor, fill: int) -> int:
    """A fill value as csrc/row_scatter.cu's 32-bit pattern (byte o of a
    lane gets byte o & 3 of it)."""
    size = t.element_size()
    if size not in (1, 2, 4):
        raise ValueError(f"lane table: no fill for {t.dtype}")
    v = int(fill) & ((1 << (8 * size)) - 1)
    while size < 4:
        v |= v << (8 * size)
        size *= 2
    return v


def _lane_table(lanes, counter: str = "row_scatter") -> None:
    """ONE K4 launch over up to LANE_TABLE_MAX lanes, each a tuple (out,
    src, rows, idx, widx, n_src, fill): out = src's first n_src rows, the
    rest `fill`; then out[idx[i]] = rows[i] (widx set: word widx[i] of
    row idx[i] = the i-th word of rows). idx, widx and rows may be None.
    Adds one to LAUNCHES[counter] when it launches (some lane not
    empty)."""
    if not 0 < len(lanes) <= LANE_TABLE_MAX:
        raise ValueError(f"lane table: {len(lanes)} lanes (1 to "
                         f"{LANE_TABLE_MAX})")
    ext = _ext()
    # the host table (csrc/row_scatter.cu: LT_FIELDS int64 a lane), which
    # the C entry copies into the launch's parameters
    spec = []
    for out, src, rows, idx, widx, n_src, fill in lanes:
        spec += (out.data_ptr(), src.data_ptr(),
                 0 if rows is None else rows.data_ptr(),
                 0 if idx is None else idx.data_ptr(),
                 0 if widx is None else widx.data_ptr(),
                 out.shape[0], n_src, _row_bytes(out),
                 0 if idx is None else idx.shape[0],
                 _fill_pattern(out, fill))
    if any(lane[0].numel() > 0 for lane in lanes):
        ext.entry("row_scatter", "lane_table",
                  (ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p))(
            struct.pack(f"<{len(spec)}q", *spec), len(lanes),
            ext.raw_stream(lanes[0][0].device.index))
        LAUNCHES[counter] += 1


def _check_lane(dst, idx, rows) -> None:
    if rows.dtype != dst.dtype or rows.shape[1:] != dst.shape[1:] \
            or rows.shape[0] != idx.shape[0] or idx.dtype != torch.int32:
        raise ValueError("scatter: rows must match dst's row shape and "
                         "dtype, one int32 index a row")


def _lane_spec(lane):
    """(src, idx, rows, n_rows, fill) of a lane_table lane."""
    src, idx, rows, *grow = lane
    n_rows, fill = grow if grow else (src.shape[0], 0)
    return src, idx, rows, n_rows, fill


def lane_table_plain(lanes):
    out = []
    for lane in lanes:
        src, idx, rows, n_rows, fill = _lane_spec(lane)
        pad = torch.full((n_rows - src.shape[0], *src.shape[1:]), fill,
                         dtype=src.dtype, device=src.device)
        dst = torch.cat([src, pad])
        out.append(dst if idx is None else _scatter_lane_plain(dst, idx,
                                                               rows))
    return tuple(out)


def lane_table(lanes):
    """K4's lane table: for each lane (src, idx, rows[, n_rows, fill]) a
    fresh lane of n_rows rows (default src's) holding src's rows, then
    `fill` (arena growth), with out[idx[i]] = rows[i] (out of range
    dropped; idx None: no patch). ONE launch on the card for up to
    LANE_TABLE_MAX lanes, each with its own index list: scatter_rows,
    arena_grow, range_scatter and ops/deltas.flush_lanes' plane flush."""
    if not lanes[0][0].is_cuda:
        return lane_table_plain(lanes)
    _check_cuda(*(t for lane in lanes for t in lane[:3] if t is not None))
    specs, outs = [], []
    for lane in lanes:
        src, idx, rows, n_rows, fill = _lane_spec(lane)
        if n_rows < src.shape[0]:
            raise ValueError("lane_table: fewer rows than the source")
        if idx is not None:
            _check_lane(src, idx, rows)
        out = torch.empty((n_rows, *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        outs.append(out)
        specs.append((out, src, rows, idx, None, src.shape[0], fill))
    _lane_table(specs)
    return tuple(outs)


def scatter_rows(dst, idx, rows):
    """A fresh copy of dst with dst[idx[i]] = rows[i] (out of range
    dropped; duplicates carry identical data)."""
    if not dst.is_cuda:
        return _scatter_lane_plain(dst, idx, rows)
    _check_cuda(dst, idx, rows)
    _check_lane(dst, idx, rows)
    out = torch.empty_like(dst)
    _lane_table(((out, dst, rows, idx, None, dst.shape[0], 0),))
    return out


def kid_word_scatter_plain(kid_rows, kid_idx, word_idx, words):
    kc, w = kid_rows.shape
    a, a_ok = _norm_index(kid_idx, kc)
    b, b_ok = _norm_index(word_idx, w)
    ok = a_ok & b_ok
    out = kid_rows.clone()
    out[a[ok], b[ok]] = words[ok]
    return out


def kid_word_scatter(kid_rows, kid_idx, word_idx, words):
    """A fresh copy of the kid table with whole words set at (kid, word);
    padding coordinates use kid == KC and are dropped."""
    if not kid_rows.is_cuda:
        return kid_word_scatter_plain(kid_rows, kid_idx, word_idx, words)
    _check_cuda(kid_rows, kid_idx, word_idx, words)
    z = kid_idx.shape[0]
    if (kid_rows.element_size() != 4 or words.element_size() != 4
            or word_idx.shape[0] != z or words.shape[0] != z
            or kid_idx.dtype != torch.int32
            or word_idx.dtype != torch.int32):
        raise ValueError("kid_word_scatter: 32-bit table and words, one "
                         "int32 (kid, word) a word")
    out = torch.empty_like(kid_rows)
    _lane_table(((out, kid_rows, words, kid_idx, word_idx,
                  kid_rows.shape[0], 0),))
    return out


_GROW_FILL = (0, 0, INT32_MIN, 0, 0)


def arena_grow_plain(bitmaps, ts, exec_ts, kinds, valid, new_cap: int):
    grow = new_cap - bitmaps.shape[0]
    out = []
    for a, fill in zip((bitmaps, ts, exec_ts, kinds, valid), _GROW_FILL):
        pad = torch.full((grow, *a.shape[1:]), fill, dtype=a.dtype,
                         device=a.device)
        out.append(torch.cat([a, pad]))
    return tuple(out)


def arena_grow(bitmaps, ts, exec_ts, kinds, valid, new_cap: int):
    """The arena lanes copied into new_cap rows: pad 0, INT32_MIN for
    exec_ts, False for valid (one launch over the five lanes)."""
    if not bitmaps.is_cuda:
        return arena_grow_plain(bitmaps, ts, exec_ts, kinds, valid, new_cap)
    return lane_table([(a, None, None, new_cap, fill) for a, fill in zip(
        (bitmaps, ts, exec_ts, kinds, valid), _GROW_FILL)])


def range_scatter_plain(starts, ends, ts, kinds, valid, rows, start_rows,
                        end_rows, ts_rows, kind_rows, valid_rows):
    return tuple(_scatter_lane_plain(dst, rows, src) for dst, src in (
        (starts, start_rows), (ends, end_rows), (ts, ts_rows),
        (kinds, kind_rows), (valid, valid_rows)))


def range_scatter(starts, ends, ts, kinds, valid, rows, start_rows,
                  end_rows, ts_rows, kind_rows, valid_rows):
    """Dirty rows into fresh copies of the five range-arena lanes
    (starts/ends/kinds i32[rcap], ts i32[rcap, 3], valid bool[rcap]):
    lane[rows[i]] = src[i], out of range dropped; padding duplicates
    row[0] with identical data. One launch over the five lanes, which
    share the index list."""
    lanes = (starts, ends, ts, kinds, valid)
    srcs = (start_rows, end_rows, ts_rows, kind_rows, valid_rows)
    if not starts.is_cuda:
        return range_scatter_plain(*lanes, rows, *srcs)
    _check_cuda(*lanes, rows, *srcs)
    rcap = starts.shape[0]
    if (valid.dtype != torch.bool or tuple(ts.shape) != (rcap, 3)
            or any(t.dtype != torch.int32 for t in (starts, ends, ts, kinds))):
        raise ValueError("range_scatter: lanes must be i32[rcap] x2, "
                         "i32[rcap, 3], i32[rcap], bool[rcap]")
    for dst, src in zip(lanes, srcs):
        _check_lane(dst, rows, src)
    outs = tuple(torch.empty_like(t) for t in lanes)
    _lane_table([(out, dst, src, rows, None, rcap, 0)
                 for out, dst, src in zip(outs, lanes, srcs)],
                "range_scatter")
    return outs


# -- K5: covered_buckets / range_deps_resolve / fused_range_deps_resolve -----
def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int64 value of its low 32 bits read as int32 (the
    reference's wrapping int32 arithmetic)."""
    return ((v + (1 << 31)) & _M32) - (1 << 31)


def covered_buckets_plain(iv_of, iv_start, iv_end, b: int, k: int,
                          base: int = 0, k_total=None) -> torch.Tensor:
    """Packed covered-bucket words i32[b, k/32] (bucket 32j + i in bit i of
    word j, the key arena's layout) of the bucket slice [base, base + k) of
    k_total buckets (one device: base 0, k_total = k): bucket j is covered
    by [s, e) iff (j - s) mod k_total < e - s in wrapping int32; widths
    <= 0 or >= k_total cover every bucket. k_total must be a power of two
    (so the mod commutes with the int32 wrap); entries with iv_of out of
    range (padding b) are dropped, a negative iv_of counts from the end."""
    k_total = k if k_total is None else k_total
    if k_total & (k_total - 1) or k_total % 32 or k % 32:
        raise ValueError(f"covered_buckets: k_total={k_total} must be a "
                         "power of two >= 32")
    s = iv_start.to(torch.int64)
    width = _wrap_i32(iv_end.to(torch.int64) - s)
    wide = (width <= 0) | (width >= k_total)
    j = base + torch.arange(k, dtype=torch.int64, device=iv_start.device)
    cov = wide[:, None] | (((j[None, :] - s[:, None]) & (k_total - 1))
                           < width[:, None])
    o, ok = _norm_index(iv_of, b)
    out = torch.zeros(b, k, dtype=torch.int32, device=iv_start.device)
    out.index_add_(0, o[ok], cov[ok].to(torch.int32))
    return _pack_bits(out > 0)


def _range_any_plain(iv_of, iv_start, iv_end, b: int, r_start, r_end):
    """bool[b, rcap]: some interval of the subject overlaps the row."""
    hit = (iv_start[:, None] < r_end[None, :]) \
        & (r_start[None, :] < iv_end[:, None])
    o, ok = _norm_index(iv_of, b)
    acc = torch.zeros(b, r_start.shape[0], dtype=torch.int32,
                      device=r_start.device)
    acc.index_add_(0, o[ok], hit[ok].to(torch.int32))
    return acc > 0


def _range_block_plain(any_r, subj_before, subj_kinds, mine, r_ts, r_kinds,
                       r_valid, witness_table) -> torch.Tensor:
    nk = witness_table.shape[0]
    witness = witness_table[_gather_index(subj_kinds, nk)[:, None],
                            _gather_index(r_kinds, nk)[None, :]] == 1
    before = _lex_before(r_ts[None, :, :], subj_before[:, None, :])
    m = any_r & witness & before & r_valid[None, :]
    if mine is not None:
        m &= mine[:, None]
    return _pack_bits(m)


def range_deps_resolve_plain(iv_of, iv_start, iv_end, subj_before,
                             subj_kinds, subj_is_range, r_start, r_end,
                             r_ts, r_kinds, r_valid, k_bm, k_ts, k_kinds,
                             k_valid, witness_table):
    b = subj_before.shape[0]
    any_r = _range_any_plain(iv_of, iv_start, iv_end, b, r_start, r_end)
    rp = _range_block_plain(any_r, subj_before, subj_kinds, None, r_ts,
                            r_kinds, r_valid, witness_table)
    cov = covered_buckets_plain(iv_of, iv_start, iv_end, b,
                                k_bm.shape[1] * 32)
    kp = _resolve_block_plain(cov, subj_before, subj_kinds, subj_is_range,
                              k_bm, k_ts, k_kinds, k_valid, witness_table)
    return rp, kp


def fused_range_deps_resolve_plain(iv_of, iv_start, iv_end, subj_store,
                                   subj_before, subj_kinds, subj_is_range,
                                   r_slots, rarenas, k_slots, karenas,
                                   witness_table):
    b = subj_before.shape[0]
    dev = subj_before.device
    routs = []
    for s, (r_start, r_end, r_ts, r_kinds, r_valid) in enumerate(rarenas):
        any_r = _range_any_plain(iv_of, iv_start, iv_end, b, r_start, r_end)
        routs.append(_range_block_plain(
            any_r, subj_before, subj_kinds, subj_store == r_slots[s], r_ts,
            r_kinds, r_valid, witness_table))
    kouts = []
    if karenas:
        cov = covered_buckets_plain(iv_of, iv_start, iv_end, b,
                                    karenas[0][0].shape[1] * 32)
    for s, (k_bm, k_ts, k_kinds, k_valid) in enumerate(karenas):
        mine = (subj_store == k_slots[s]) & subj_is_range
        kouts.append(_resolve_block_plain(cov, subj_before, subj_kinds, mine,
                                          k_bm, k_ts, k_kinds, k_valid,
                                          witness_table))
    empty = torch.zeros(b, 0, dtype=torch.int32, device=dev)
    return (torch.cat(routs, dim=1) if routs else empty,
            torch.cat(kouts, dim=1) if kouts else empty)


# range_resolve (csrc/range_resolve.cu: K5's range side over a table of
# range blocks passed by value, and the covered-bucket pass, ONE launch)
# and range_key_block (K5's key side, the key body), lean launches
_RANGE_ARGS = (ctypes.c_char_p, _I, _VP, _VP, _VP, _I, _VP, _VP, _VP, _VP,
               _I, _VP, _I, _I, _VP, _I, _I, _I, _I, _VP)
_RANGE_KEY_ARGS = (_VP,) * 6 + (_I, _VP, _I, _VP, _VP, _VP, _I, _I, _VP, _I,
                               _VP, _I, _I, _VP)


def range_spec(blocks, out_ptr: int, off: int = 0) -> bytes:
    """The host table range_resolve takes by value: node_lane.range_table's
    words of the range blocks (start, end, ts, kinds, valid), packed."""
    from accord_tpu_torch.ops.node_lane import range_table
    words = range_table(blocks, out_ptr, off=off)
    return struct.pack(f"<{len(words)}q", *words)


def launch_range(ext, spec: bytes, nblk: int, iv, b: int, sb, sknd, store,
                 slots, wt, out_stride: int, cov=None, cov_base: int = 0,
                 k_local: int = 0, k_total: int = 0, slices: int = 1) -> None:
    """One range_resolve launch: the nblk range blocks of `spec`
    (range_spec; `store` and `slots` None for one store: no slot mask)
    and, with `cov` (i32[b, k_local/32] a slice), the covered words of the
    bucket slices [cov_base + m * k_local, + k_local) of k_total buckets,
    m < slices, slice m at cov's word m * b * k_local/32. A covered pass
    alone (nblk 0) may leave sb, sknd and wt None."""
    iv_of, iv_s, iv_e = iv

    def p(t):
        return None if t is None else t.data_ptr()
    ext.entry("range_resolve", "range_resolve", _RANGE_ARGS)(
        spec, nblk, iv_of.data_ptr(), iv_s.data_ptr(), iv_e.data_ptr(),
        iv_of.shape[0], p(sb), p(sknd), p(store), p(slots), b, p(wt),
        1 if wt is None else wt.shape[0], out_stride, p(cov), cov_base,
        k_local, k_total, slices, ext.raw_stream(iv_of.device.index))


def _range_resolve_cuda(iv_of, iv_start, iv_end, subj_store, subj_before,
                        subj_kinds, subj_is_range, r_slots, rarenas,
                        k_slots, karenas, witness_table,
                        count: str = "range_resolve"):
    ext = _ext()
    _check_cuda(iv_of, iv_start, iv_end, subj_before, subj_kinds,
                subj_is_range, witness_table,
                *[t for a in rarenas for t in a],
                *[t for a in karenas for t in a],
                *((subj_store,) if subj_store is not None else ()),
                *((r_slots,) if rarenas and r_slots is not None else ()),
                *((k_slots,) if karenas and k_slots is not None else ()))
    dev = subj_before.device
    b = subj_before.shape[0]
    if any(a[0].shape[0] % 32 for a in rarenas):
        raise ValueError("range arena rcap must be a multiple of 32")
    rtot = sum(a[0].shape[0] // 32 for a in rarenas)
    ktot = sum(a[0].shape[0] // 32 for a in karenas)
    rp = torch.empty(b, rtot, dtype=torch.int32, device=dev)
    kp = torch.empty(b, ktot, dtype=torch.int32, device=dev)
    if not (rtot or ktot):
        return rp, kp
    nw = karenas[0][0].shape[1] if ktot else 0
    if nw > 32:
        raise ValueError(f"range_deps_resolve kernel takes K <= 1024 "
                         f"buckets (got {nw * 32})")
    if any(a[0].shape[1] != nw for a in karenas):
        raise ValueError("arena blocks differ in bucket count")
    cov = torch.empty(b, nw, dtype=torch.int32, device=dev) if ktot else None
    fused = subj_store is not None
    rblocks = rarenas if rtot else ()
    # the range side over every range block, and the covered words: one
    # launch
    launch_range(ext, range_spec(rblocks, rp.data_ptr()), len(rblocks),
                 (iv_of, iv_start, iv_end), b, subj_before, subj_kinds,
                 subj_store if fused and rblocks else None,
                 r_slots if fused and rblocks else None, witness_table, rtot,
                 cov, 0, nw * 32, nw * 32)
    st = ext.raw_stream(dev.index)
    off = 0
    for s, (k_bm, k_ts, k_kinds, k_valid) in enumerate(karenas):
        cap = k_bm.shape[0]
        ext.entry("range_resolve", "range_key_block", _RANGE_KEY_ARGS)(
            cov.data_ptr(), subj_before.data_ptr(), subj_kinds.data_ptr(),
            subj_is_range.data_ptr(),
            subj_store.data_ptr() if fused else None,
            k_slots[s:s + 1].data_ptr() if fused else None, b,
            k_bm.data_ptr(), nw, k_ts.data_ptr(), k_kinds.data_ptr(),
            k_valid.data_ptr(), cap, nw, witness_table.data_ptr(),
            witness_table.shape[0], kp.data_ptr(), ktot, off, st)
        off += cap // 32
    LAUNCHES[count] += 1
    return rp, kp


def covered_buckets(iv_of, iv_start, iv_end, b: int, k: int) -> torch.Tensor:
    """The covered-bucket words i32[b, k/32] of a subject interval CSR (see
    covered_buckets_plain); on the card, K5's covered pass alone."""
    if not iv_of.is_cuda:
        return covered_buckets_plain(iv_of, iv_start, iv_end, b, k)
    if k & (k - 1) or k % 32 or k > 1024:
        raise ValueError(f"covered_buckets: k={k} must be a power of two "
                         "in [32, 1024]")
    _check_cuda(iv_of, iv_start, iv_end)
    cov = torch.empty(b, k // 32, dtype=torch.int32, device=iv_of.device)
    launch_range(_ext(), range_spec((), 0), 0, (iv_of, iv_start, iv_end), b,
                 None, None, None, None, None, 0, cov, 0, k, k)
    LAUNCHES["range_resolve"] += 1
    return cov


def range_deps_resolve(iv_of, iv_start, iv_end, subj_before, subj_kinds,
                       subj_is_range, r_start, r_end, r_ts, r_kinds,
                       r_valid, k_bm, k_ts, k_kinds, k_valid, witness_table):
    """The range-overlap query, one store: (rpacked i32[B, rcap/32],
    kpacked i32[B, cap/32]). Range side: some interval of the subject
    (iv_of CSR, padding B dropped) overlaps the row (iv_start < r_end &
    r_start < iv_end), AND witness, before and valid. Key side, range
    subjects only: the subject's covered buckets meet the row's packed
    bucket words, AND witness, before and valid."""
    if not r_start.is_cuda:
        return range_deps_resolve_plain(
            iv_of, iv_start, iv_end, subj_before, subj_kinds, subj_is_range,
            r_start, r_end, r_ts, r_kinds, r_valid, k_bm, k_ts, k_kinds,
            k_valid, witness_table)
    return _range_resolve_cuda(
        iv_of, iv_start, iv_end, None, subj_before, subj_kinds,
        subj_is_range, None, ((r_start, r_end, r_ts, r_kinds, r_valid),),
        None, ((k_bm, k_ts, k_kinds, k_valid),), witness_table)


def fused_range_deps_resolve(iv_of, iv_start, iv_end, subj_store,
                             subj_before, subj_kinds, subj_is_range,
                             r_slots, rarenas, k_slots, karenas,
                             witness_table):
    """range_deps_resolve over tuples of store blocks: range block s (and
    key block s) answers only subjects with subj_store == its slot; blocks
    concatenate on the word axis in tuple order; an empty tuple gives a
    zero-width output."""
    first = rarenas[0][0] if rarenas else (karenas[0][0] if karenas
                                           else subj_before)
    if not first.is_cuda:
        return fused_range_deps_resolve_plain(
            iv_of, iv_start, iv_end, subj_store, subj_before, subj_kinds,
            subj_is_range, r_slots, rarenas, k_slots, karenas,
            witness_table)
    return _range_resolve_cuda(iv_of, iv_start, iv_end, subj_store,
                               subj_before, subj_kinds, subj_is_range,
                               r_slots, rarenas, k_slots, karenas,
                               witness_table)


# -- K6: segment_compact / range_finalize_csr --------------------------------
def segment_compact_plain(m: torch.Tensor, out_cap: int):
    """Dense segment compaction over PACKED rows: m i32[S, N/32] ->
    (indptr i32[S+1], dep_rows i32[out_cap]); dep_rows holds the set
    columns in (segment, column) order, the first out_cap of them, 0
    beyond; indptr[S] > out_cap signals overflow."""
    return _packed_segment_compact(m, out_cap)


def segment_compact(m: torch.Tensor, out_cap: int):
    """The reference's `_segment_compact` (dense 0/1 hits [S, N]) on the
    packed form of the same hits; on the card, K6's compaction passes."""
    if not m.is_cuda:
        return segment_compact_plain(m, out_cap)
    ext = _ext()
    _check_cuda(m)
    s, w = m.shape
    dev = m.device
    indptr, dep_rows = _i32_outs(dev, (s + 1,), (out_cap,))
    ext.entry("range_finalize", "segment_compact",
              (_VP, _I, _I, _I, _VP, _VP, _VP, _VP))(
        m.data_ptr(), s, w, out_cap, indptr.data_ptr(), dep_rows.data_ptr(),
        _csr_scratch(dev, s * w), ext.raw_stream(dev.index))
    LAUNCHES["range_finalize"] += 1
    return indptr, dep_rows


def range_stab_words_plain(iv_of, iv_start, iv_end, ent_ok, subj_before,
                           subj_kinds, r_start, r_end, r_ts, r_kinds,
                           r_valid, witness_table):
    """range_finalize_csr's first stage: (packed words i32[NV, rcap/32] of
    stab & witness & before, the stab count)."""
    b = subj_before.shape[0]
    nk = witness_table.shape[0]
    o = iv_of.to(torch.int64).clamp(0, b - 1)
    inb = (iv_of >= 0) & (iv_of < b) & ent_ok
    hit = (iv_start[:, None] < r_end[None, :]) \
        & (r_start[None, :] < iv_end[:, None])
    stab = hit & r_valid[None, :] & inb[:, None]
    witness = witness_table[_gather_index(subj_kinds[o], nk)[:, None],
                            _gather_index(r_kinds, nk)[None, :]] == 1
    before = _lex_before(r_ts[None, :, :], subj_before[o][:, None, :])
    return _pack_bits(stab & witness & before), stab.sum(dtype=torch.int64)


def range_finalize_csr_plain(iv_of, iv_start, iv_end, ent_ok, subj_before,
                             subj_kinds, r_start, r_end, r_ts, r_kinds,
                             r_valid, witness_table, out_cap: int):
    m, bound = range_stab_words_plain(
        iv_of, iv_start, iv_end, ent_ok, subj_before, subj_kinds, r_start,
        r_end, r_ts, r_kinds, r_valid, witness_table)
    indptr, dep_rows = _packed_segment_compact(m, out_cap)
    dep_ts = r_ts[dep_rows.to(torch.int64)]
    return (indptr, dep_rows, dep_ts, _to_i32(bound),
            csr_checksum(indptr, dep_rows, dep_ts))


def range_finalize_csr(iv_of, iv_start, iv_end, ent_ok, subj_before,
                       subj_kinds, r_start, r_end, r_ts, r_kinds, r_valid,
                       witness_table, out_cap: int):
    """Exact range-arena deps per interval entry: stab = the entry overlaps
    the row & row valid & 0 <= iv_of < B & ent_ok; kept rows further pass
    witness and before (gathered through clip(iv_of)); -> (indptr
    i32[NV+1], dep_rows i32[out_cap], dep_ts i32[out_cap, 3], bound i32 =
    the stab count, csum i32 bit pattern), padded and checksummed like
    finalize_csr (see csrc/range_finalize.cu)."""
    if not r_start.is_cuda:
        return range_finalize_csr_plain(
            iv_of, iv_start, iv_end, ent_ok, subj_before, subj_kinds,
            r_start, r_end, r_ts, r_kinds, r_valid, witness_table, out_cap)
    ext = _ext()
    lanes = (iv_of, iv_start, iv_end, ent_ok, subj_before, subj_kinds,
             r_start, r_end, r_ts, r_kinds, r_valid, witness_table)
    _check_cuda(*lanes)
    dev = r_start.device
    nv = iv_of.shape[0]
    rcap = r_start.shape[0]
    w = range_words(rcap)
    outs = _i32_outs(dev, (nv + 1,), (out_cap,), (out_cap, 3), (), ())
    launch_range_finalize(ext, _addr, lanes, nv, subj_before.shape[0], rcap,
                          witness_table.shape[0], out_cap, outs,
                          _VP(_csr_scratch(dev, nv * w, csr_sizes()[2])))
    LAUNCHES["range_finalize"] += 1
    return tuple(outs)


def range_words(rcap: int) -> int:
    """The packed words of a range arena's rows (its cap a multiple of
    32)."""
    if rcap % 32:
        raise ValueError(f"range arena rcap {rcap} % 32 != 0")
    return rcap // 32


# range_finalize_csr (csrc/range_finalize.cu), a lean launch
_RANGE_FIN_ARGS = (_VP,) * 4 + (_I, _VP, _VP, _I) + (_VP,) * 5 \
    + (_I, _VP, _I, _I) + (_VP,) * 7


def launch_range_finalize(ext, A, lanes, nv: int, b: int, rcap: int,
                          nk: int, out_cap: int, outs, scratch):
    """K6's launch on device addresses (`A(x)`, see _addr): lanes are
    range_finalize_csr's twelve inputs in order, outs its five outputs,
    scratch the compaction's zeroed scratch. range_finalize_csr and the
    protocol megakernel's graph both launch K6 here (ONE launch, no
    memset: the stab words are built inside the compaction's tiles)."""
    of, ivs, ive, ok, sb, sk, r0, r1, r2, r3, r4, wt = (A(x) for x in lanes)
    ext.entry("range_finalize", "range_finalize_csr", _RANGE_FIN_ARGS)(
        of, ivs, ive, ok, nv, sb, sk, b, r0, r1, r2, r3, r4, rcap, wt, nk,
        out_cap, *(A(o) for o in outs), A(scratch), ext.stream())


# -- K7: max_conflict --------------------------------------------------------
def max_conflict_plain(subj_words, act_bm, act_exec_ts, act_valid):
    b = subj_words.shape[0]
    cap = act_bm.shape[0]
    overlap = torch.zeros(b, cap, dtype=torch.bool, device=act_bm.device)
    step = max(1, (1 << 26) // max(1, cap * act_bm.shape[1]))
    for lo in range(0, b, step):
        sw = subj_words[lo:lo + step]
        overlap[lo:lo + step] = ((sw[:, None, :] & act_bm[None, :, :]) != 0) \
            .any(-1)
    mask = overlap & act_valid[None, :]
    neg = torch.tensor(INT32_MIN, dtype=torch.int32, device=act_bm.device)
    lanes, tie = [], mask
    for ln in range(3):
        col = act_exec_ts[None, :, ln].expand(b, cap)
        m = torch.where(tie, col, neg).max(dim=1).values
        tie = tie & (col == m[:, None])
        lanes.append(m)
    row = torch.where(tie.any(dim=1), tie.to(torch.int8).argmax(dim=1),
                      torch.full((b,), -1, device=act_bm.device))
    return torch.stack(lanes, dim=1), row.to(torch.int32)


# max_conflict (csrc/max_conflict.cu), a lean launch
_MAX_CONFLICT_ARGS = (_VP, _I, _I, _VP, _VP, _VP, _I, _VP, _VP, _VP)


def max_conflict(subj_words, act_bm, act_exec_ts, act_valid):
    """Per subject (packed bucket words i32[B, K/32]): the lexicographic
    3-lane max of exec_ts over the valid rows whose bucket words meet the
    subject's -> (i32[B, 3], INT32_MIN lanes where none; i32[B], the first
    winning row among exact ties, -1 where none)."""
    if not act_bm.is_cuda:
        return max_conflict_plain(subj_words, act_bm, act_exec_ts, act_valid)
    ext = _ext()
    _check_cuda(subj_words, act_bm, act_exec_ts, act_valid)
    b, nw = subj_words.shape
    if act_bm.shape[1] != nw:
        raise ValueError("max_conflict: subject and arena bucket counts "
                         "differ")
    dev = act_bm.device
    lanes = torch.empty(b, 3, dtype=torch.int32, device=dev)
    row = torch.empty(b, dtype=torch.int32, device=dev)
    ext.entry("max_conflict", "max_conflict", _MAX_CONFLICT_ARGS)(
        subj_words.data_ptr(), b, nw, act_bm.data_ptr(),
        act_exec_ts.data_ptr(), act_valid.data_ptr(), act_bm.shape[0],
        lanes.data_ptr(), row.data_ptr(), ext.raw_stream(dev.index))
    LAUNCHES["max_conflict"] += 1
    return lanes, row


# -- K8: exec_scatter -------------------------------------------------------
def _check_exec_lanes(adj, exec_ts, applied, pending, awaits_all) -> None:
    cap = adj.shape[0]
    if (cap % 32 or tuple(adj.shape) != (cap, cap // 32)
            or adj.dtype != torch.int32 or exec_ts.dtype != torch.int32
            or tuple(exec_ts.shape) != (cap, 3)
            or any(t.dtype != torch.bool or tuple(t.shape) != (cap,)
                   for t in (applied, pending, awaits_all))):
        raise ValueError("exec lanes must be i32[cap, cap/32] (cap % 32 == "
                         "0), i32[cap, 3] and three bool[cap]")


def exec_scatter_plain(adj, exec_ts, applied, pending, awaits_all, rows,
                       adj_rows, ts_rows, applied_rows, pending_rows,
                       awaits_rows):
    return tuple(_scatter_lane_plain(dst, rows, src) for dst, src in (
        (adj, adj_rows), (exec_ts, ts_rows), (applied, applied_rows),
        (pending, pending_rows), (awaits_all, awaits_rows)))


# exec_scatter (csrc/exec_scatter.cu: K8, one launch), a lean launch
_EXEC_SCATTER_ARGS = (*(_VP,) * 10, _I, _I, _VP, _I, *(_VP,) * 6)


def exec_scatter(adj, exec_ts, applied, pending, awaits_all, rows, adj_rows,
                 ts_rows, applied_rows, pending_rows, awaits_rows):
    """Dirty rows into fresh copies of the exec arena's five lanes (packed
    adjacency i32[cap, cap/32], exec_ts i32[cap, 3], applied / pending /
    awaits_all bool[cap]): lane[rows[i]] = src[i], out of range dropped;
    padding duplicates rows[0] with identical data. On the card the five
    lanes come back as views of one allocation."""
    lanes = (adj, exec_ts, applied, pending, awaits_all)
    srcs = (adj_rows, ts_rows, applied_rows, pending_rows, awaits_rows)
    if not adj.is_cuda:
        return exec_scatter_plain(*lanes, rows, *srcs)
    ext = _ext()
    _check_cuda(*lanes, rows, *srcs)
    _check_exec_lanes(*lanes)
    cap, w = adj.shape
    m = rows.shape[0]
    if (tuple(adj_rows.shape) != (m, w) or tuple(ts_rows.shape) != (m, 3)
            or any(t.dtype != d.dtype or t.shape[0] != m
                   for t, d in zip(srcs, lanes))):
        raise ValueError("exec_scatter: row data must match the lanes' row "
                         "shapes and dtypes")
    if rows.dtype != torch.int32:
        raise ValueError("exec_scatter: one int32 index a row")
    # the five outputs in one allocation, each lane 16-byte aligned
    outs = tuple(_lane_views(torch.empty(_lanes_bytes(lanes),
                                         dtype=torch.uint8,
                                         device=adj.device), lanes))
    ext.entry("exec_scatter", "exec_scatter", _EXEC_SCATTER_ARGS)(
        *(t.data_ptr() for t in outs), *(t.data_ptr() for t in lanes), cap,
        w, rows.data_ptr(), m, *(t.data_ptr() for t in srcs),
        ext.raw_stream(adj.device.index))
    LAUNCHES["exec_scatter"] += 1
    return outs


# -- K9: execution_frontier / fused_execution_frontier / frontier_compact ----
FRONTIER_OUT_TIERS = (32, 256, 2048)
_FRONTIER_MAX_PLANES = 32    # csrc/exec_frontier.cu FMAXP


def _lex_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a <= b lexicographically over 3 int32 lanes (broadcasting)."""
    return ~_lex_before(b, a)


def _frontier_ready(adj, exec_ts, applied, pending, awaits_all):
    """bool[cap]: pending rows whose gates are all clear. A gate is a wait
    edge adj[w, d] on a dep that is not applied and either executes no
    later than w (exec_ts[d] <=lex exec_ts[w]) or w awaits all its deps.
    Walks only the set bits of the packed adjacency."""
    cap = adj.shape[0]
    wi, ji = torch.nonzero(adj, as_tuple=True)
    bits = (_u32(adj[wi, ji])[:, None]
            >> torch.arange(32, device=adj.device)) & 1
    k, b = torch.nonzero(bits, as_tuple=True)
    w = wi[k]
    d = ji[k] * 32 + b
    gate = ~applied[d] & (awaits_all[w] | _lex_le(exec_ts[d], exec_ts[w]))
    gated = torch.zeros(cap, dtype=torch.bool, device=adj.device)
    gated[w[gate]] = True
    return pending & ~gated


def execution_frontier_plain(adj, exec_ts, applied, pending, awaits_all):
    ready = _frontier_ready(adj, exec_ts, applied, pending, awaits_all)
    return _pack_bits(ready.reshape(1, -1))[0]


def fused_execution_frontier_plain(planes):
    return torch.cat([execution_frontier_plain(*p) for p in planes])


def check_planes(planes) -> int:
    """The frontier kernels' plane count and lanes; -> the planes' packed
    words in all."""
    n = len(planes)
    if not 1 <= n <= _FRONTIER_MAX_PLANES:
        raise ValueError(f"frontier kernels take 1-{_FRONTIER_MAX_PLANES} "
                         f"planes (got {n})")
    for p in planes:
        _check_exec_lanes(*p)
    return sum(p[0].shape[0] // 32 for p in planes)


def _plane_arrays(A, lanes, caps) -> tuple:
    """The C entries' per-plane arrays: five pointer arrays (the planes'
    operands through `A`) and the caps."""
    n = len(lanes)
    ptrs = [(ctypes.c_void_p * n)(*(A(p[k]).value for p in lanes))
            for k in range(5)]
    return (*ptrs, (ctypes.c_int * n)(*caps))


def _plane_table(ext, planes):
    """The checked planes' C arrays and their packed words in all."""
    w_tot = check_planes(planes)
    for p in planes:
        _check_cuda(*p, *planes[0])
    return (_plane_arrays(_addr, planes, [p[0].shape[0] for p in planes]),
            w_tot)


# K9's entries (csrc/exec_frontier.cu), lean launches (_ext.entry): the
# per-plane arrays (five pointer arrays, the caps) pass as pointers
_FRONTIER_ARGS = (_I,) + (_VP,) * 8
_FRONTIER_COMPACT_ARGS = (_I,) + (_VP,) * 6 + (_I,) + (_VP,) * 6


def frontier_scratch_bytes(w_tot: int) -> int:
    """Zeroed scratch bytes of K9's compact entry over w_tot output words.
    The kernel uses the first word (its exit ticket, left zeroed); the
    size is a one-spec launch_csr compaction's over the words, so the
    C entry's scratch contract is unchanged."""
    return csr_scratch_bytes(1, int(w_tot))


def launch_frontier_compact(ext, A, lanes, caps, out_cap: int, outs,
                            scratch) -> None:
    """K9's compact entry on device addresses (`A(x)`, see _addr): lanes
    are the planes' five operands each, caps their row counts, outs
    (packed, indptr, rows, csum), scratch frontier_scratch_bytes zeroed
    bytes. frontier_compact and the protocol megakernel's graph both
    launch it here (ONE launch: a block an output word, the last block
    by ticket compacting them)."""
    packed, indptr, rows, csum = (A(o) for o in outs)
    ext.entry("exec_frontier", "frontier_compact", _FRONTIER_COMPACT_ARGS)(
        len(lanes), *_plane_arrays(A, lanes, caps), out_cap, packed, indptr,
        rows, csum, A(scratch), ext.stream())


def _frontier_cuda(planes) -> torch.Tensor:
    ext = _ext()
    table, w_tot = _plane_table(ext, planes)
    dev = planes[0][0].device
    out = torch.empty(w_tot, dtype=torch.int32, device=dev)
    ext.entry("exec_frontier", "exec_frontier", _FRONTIER_ARGS)(
        len(planes), *table, out.data_ptr(), ext.raw_stream(dev.index))
    return out


def execution_frontier(adj, exec_ts, applied, pending, awaits_all):
    """The exec plane's release test -> packed i32[cap/32]: pending rows
    with no wait edge on a dep that is not applied and (exec_ts[d] <=lex
    exec_ts[w] or w awaits all). INT32_MIN lanes mark an undecided
    executeAt, which always gates."""
    if not adj.is_cuda:
        return execution_frontier_plain(adj, exec_ts, applied, pending,
                                        awaits_all)
    out = _frontier_cuda(((adj, exec_ts, applied, pending, awaits_all),))
    LAUNCHES["execution_frontier"] += 1
    return out


def fused_execution_frontier(planes):
    """execution_frontier over a tuple of store planes (caps may differ),
    the packed words concatenated in tuple order -> i32[sum(cap_s)/32]."""
    if not planes[0][0].is_cuda:
        return fused_execution_frontier_plain(planes)
    out = _frontier_cuda(tuple(planes))
    LAUNCHES["fused_execution_frontier"] += 1
    return out


def frontier_checksum(indptr, rows) -> torch.Tensor:
    """The compacted frontier's integrity word, as an int32 bit pattern
    (0-d): the finalize fold with seeds 13 (indptr) and 17 (rows)."""
    word = _csum_fold(indptr, 13) ^ _csum_fold(rows, 17)
    return _to_i32(torch.tensor(word, dtype=torch.int64,
                                device=indptr.device))


def frontier_checksum_host(indptr, rows) -> int:
    """numpy twin of frontier_checksum, over fetched host copies (u32
    value)."""
    def fold(x, seed):
        v = np.ascontiguousarray(x).view(np.uint32).reshape(-1)
        v = v ^ (v >> np.uint32(16))
        idx = np.arange(v.shape[0], dtype=np.uint32)
        return (v * (np.uint32(2) * idx + np.uint32(seed))).sum(
            dtype=np.uint32)
    return int(fold(indptr, 13) ^ fold(rows, 17))


def frontier_compact_plain(planes, out_cap: int):
    packs = [execution_frontier_plain(*p) for p in planes]
    w_tot = sum(p.shape[0] for p in packs)
    m = torch.zeros(len(packs), w_tot, dtype=torch.int32,
                    device=packs[0].device)
    off = 0
    for s, p in enumerate(packs):
        m[s, off:off + p.shape[0]] = p
        off += p.shape[0]
    indptr, rows = _packed_segment_compact(m, out_cap)
    return indptr, rows, frontier_checksum(indptr, rows), torch.cat(packs)


def frontier_compact(planes, out_cap: int):
    """The fused frontier of a tuple of store planes, compacted: (indptr
    i32[S+1], rows i32[out_cap], csum i32 bit pattern, packed
    i32[sum(W_s)]). Store s is segment s; its rows are GLOBAL bit indices
    (32 * its first word + arena row), ascending; indptr is exact even past
    out_cap (rows beyond it are dropped, 0-padded); csum folds indptr and
    all out_cap rows; packed is the fused frontier, kept for the fallback
    decode."""
    if not planes[0][0].is_cuda:
        return frontier_compact_plain(planes, out_cap)
    ext = _ext()
    w_tot = check_planes(planes)
    _check_cuda(*(t for p in planes for t in p))
    n = len(planes)
    dev = planes[0][0].device
    packed, indptr, rows, csum = _i32_outs(dev, (w_tot,), (n + 1,),
                                           (out_cap,), ())
    launch_frontier_compact(ext, _addr, planes,
                            [p[0].shape[0] for p in planes], out_cap,
                            (packed, indptr, rows, csum),
                            _VP(zeroed_scratch(dev,
                                               frontier_scratch_bytes(w_tot))))
    LAUNCHES["frontier_compact"] += 1
    return indptr, rows, csum, packed


# -- the device command plane (ops/cmd_plane.py): K10-K12 --------------------
# Status ladder constants mirrored from local.status.Status; ops/cmd_plane.py
# asserts them against the enum at import, so the mirrors cannot drift.
CMD_ST_PRE_ACCEPTED = 1
CMD_ST_ACCEPTED = 3
CMD_ST_COMMITTED = 5
CMD_ST_STABLE = 6
CMD_ST_READY = 7
CMD_ST_PRE_APPLIED = 8
CMD_ST_APPLIED = 9
CMD_ST_INVALIDATED = 10
CMD_ST_TRUNCATED = 11

# outcome codes in the low 3 bits of out_code; the high bits carry facts the
# host residuals need
CMD_OUT_SUCCESS = 0
CMD_OUT_REDUNDANT = 1
CMD_OUT_REJECTED_BALLOT = 2
CMD_OUT_TRUNCATED = 3
CMD_OUT_INSUFFICIENT = 4
CMD_OUT_INCONSISTENT_BIT = 8    # redundant commit/apply with executeAt drift
CMD_OUT_WAS_STABLE_BIT = 16     # apply arrived on an already-stable command

# op kinds in op_kind
CMD_OP_PREACCEPT = 0
CMD_OP_ACCEPT = 1
CMD_OP_COMMIT = 2
CMD_OP_APPLY = 3

# op_flags bits (host admission encodes these per op)
CMD_F_PERMIT_FAST = 1    # ballot == Ballot.ZERO
CMD_F_EPOCH_OK = 2       # txn_id.epoch >= node.epoch at encode time
CMD_F_EXPIRED = 4        # preaccept expiry fired (decided by the host)
CMD_F_MSG_HAS_TXN = 8    # the commit/apply message carries a txn body
CMD_F_VALID = 16         # real op (padding slots leave this clear)
CMD_F_DEPS_EMPTY = 32    # commit/apply deps empty (promote-eligible)

# batched-op padding ladder for cmd_tick dispatches
CMD_OP_TIERS = (8, 64, 512)
# row values per op in cmd_tick's chain output: status, flags, promised[3],
# accepted[3], execute_at[3], durability; then (kmax[3], kvalid) per kid slot
CMD_ROW_LANES = 12
_CMD_KPAD_MAX = 8    # csrc/cmd_tick.cu KMAX

RECOVERY_OUT_TIERS = (32, 256, 2048)


def cmd_op_tier(n: int) -> int:
    """Padded op count for a cmd_tick dispatch carrying n ops."""
    return snap(n, CMD_OP_TIERS, 4096)


def _w32(x: int) -> int:
    """A Python int wrapped to int32, as XLA's int32 arithmetic wraps."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _lex_max_masked(rows, valid):
    """Lexicographic max over the 3-lane tuples rows[i] where valid[i] ->
    (max lanes, any valid); INT32_MIN lanes when nothing is valid."""
    best = None
    for r, v in zip(rows, valid):
        if v and (best is None or tuple(r) > best):
            best = tuple(r)
    if best is None:
        return (INT32_MIN, INT32_MIN, INT32_MIN), False
    return best, True


def cmd_checksum(out_code, out_status, out_ts, clock) -> torch.Tensor:
    """cmd_tick's integrity word, as an int32 bit pattern (0-d): the
    position-weighted fold with seeds 3 (codes), 7 (statuses), 11 (the
    witnessed timestamps) and 13 (the clock)."""
    word = (_csum_fold(out_code, 3) ^ _csum_fold(out_status, 7)
            ^ _csum_fold(out_ts, 11) ^ _csum_fold(clock.reshape(1), 13))
    return _to_i32(torch.tensor(word, dtype=torch.int64,
                                device=out_code.device))


def cmd_checksum_host(out_code, out_status, out_ts, clock) -> int:
    """numpy twin of cmd_checksum, over fetched host copies (u32 value)."""
    def fold(x, seed):
        v = np.ascontiguousarray(x, dtype=np.int32).view(np.uint32) \
            .reshape(-1)
        v = v ^ (v >> np.uint32(16))
        idx = np.arange(v.shape[0], dtype=np.uint32)
        return (v * (np.uint32(2) * idx + np.uint32(seed))).sum(
            dtype=np.uint32)
    return int(fold(out_code, 3) ^ fold(out_status, 7) ^ fold(out_ts, 11)
               ^ fold(np.asarray([clock], dtype=np.int32), 13))


def cmd_tick_block(n: int, kpad: int, device):
    """The result block of one cmd_tick dispatch: ONE int32 buffer, so the
    host reads it back with one copy (`cmd_tick_readback`), and its views
    (out_code i32[n], out_status i32[n], out_ts i32[n, 3], chains i32[n,
    CMD_ROW_LANES + 4 * kpad], clock i32 0-d, csum i32 0-d)."""
    c = CMD_ROW_LANES + 4 * kpad
    e = n * (5 + c)
    blk = torch.empty(e + 2, dtype=torch.int32, device=device)
    return (blk, blk[:n], blk[n:2 * n], blk[2 * n:5 * n].view(n, 3),
            blk[5 * n:e].view(n, c), blk[e], blk[e + 1])


def cmd_tick_readback(out) -> np.ndarray:
    """cmd_tick's result block (out_code .. csum, one buffer: see
    cmd_tick_block) on the host, with one blocking copy into pinned
    memory from a card."""
    code = out[9]
    total = code.shape[0] * (5 + out[13].shape[1]) + 2
    blk = torch.as_strided(code, (total,), (1,), code.storage_offset())
    if blk.data_ptr() + 4 * (total - 1) != out[12].data_ptr():
        raise ValueError("cmd_tick_readback: not one cmd_tick_block")
    if not blk.is_cuda:
        return blk.numpy().copy()
    host = torch.empty(total, dtype=torch.int32, pin_memory=True)
    host.copy_(blk)
    return host.numpy()


def _cmd_walk(rv, kmv, kvv, clock, kind_l, flags_l, txn_l, bal_l, exec_l,
              keys_l, now_l, prev_l, kprev_l, node_epoch, lane2_clean,
              lane2_rej, dur_local, promote):
    """cmd_tick's sequential walk over Python ints, op by op (the JAX
    body's fori_loop): rv[i] is op i's 12-lane row view, kmv[i][s] /
    kvv[i][s] its kid slot views; each op reads its previous writer's
    chain value through op_prev / op_kprev, and overwrites its own slot
    with its post-values. -> (clock, out_code, out_ts, out_status)."""
    n = len(kind_l)
    kpad = len(keys_l[0]) if n else 0
    neg = INT32_MIN
    out_code, out_ts, out_status = [], [], []
    for i in range(n):
        kind = kind_l[i]
        f = flags_l[i]
        valid = (f & CMD_F_VALID) != 0
        prev = prev_l[i]
        src = rv[min(prev, n - 1)] if prev >= 0 else rv[i]
        st, fl = src[0], src[1]
        pr, ab, ea, du = tuple(src[2:5]), tuple(src[5:8]), \
            tuple(src[8:11]), src[11]
        txn, bal, oex = tuple(txn_l[i]), tuple(bal_l[i]), tuple(exec_l[i])
        kids = keys_l[i]
        permit_fast = (f & CMD_F_PERMIT_FAST) != 0
        epoch_ok = (f & CMD_F_EPOCH_OK) != 0
        expired = (f & CMD_F_EXPIRED) != 0
        msg_has_txn = (f & CMD_F_MSG_HAS_TXN) != 0
        deps_empty = (f & CMD_F_DEPS_EMPTY) != 0
        now = now_l[i]

        has_txn = (fl & 1) != 0
        ea_set = ea[0] != neg
        terminal = st in (CMD_ST_INVALIDATED, CMD_ST_TRUNCATED)
        pr_gt_bal = bal < pr
        pr_max_bal = bal if pr < bal else pr
        term_code = (CMD_OUT_REJECTED_BALLOT if st == CMD_ST_INVALIDATED
                     else CMD_OUT_TRUNCATED)

        # kid chain: each slot reads its previous in-batch writer's
        # post-value (link p * kpad + s), else the pre-batch gather
        kv_raw, km = [], []
        for s in range(kpad):
            link = kprev_l[i][s]
            if link >= 0:
                lp, ls = min(link // kpad, n - 1), link % kpad
                kv_raw.append(kvv[lp][ls])
                km.append(tuple(kmv[lp][ls]))
            else:
                kv_raw.append(kvv[i][s])
                km.append(tuple(kmv[i][s]))
        kv = [bool(v) and k >= 0 for v, k in zip(kv_raw, kids)]
        mc, mc_any = _lex_max_masked(km, kv)

        def unow(al_ep, al_hlc, lane2):
            h = max(now, _w32(clock + 1))
            if al_hlc >= h:
                h = _w32(al_hlc + 1)
            return (max(node_epoch, al_ep), h, lane2), h

        # PreAccept (commands.preaccept)
        rej_w, rej_h = unow(txn[0], txn[1], lane2_rej)
        al = mc if mc_any else txn
        slow_w, slow_h = unow(al[0], al[1], lane2_clean)
        fast = permit_fast and (not mc_any or not txn < mc) and epoch_ok
        witness = rej_w if expired else (txn if fast else slow_w)
        wit_clock = rej_h if expired else (clock if fast else slow_h)
        pa_blocked = terminal or pr_gt_bal
        pa_code = (term_code if terminal
                   else CMD_OUT_REJECTED_BALLOT if pr_gt_bal
                   else CMD_OUT_REDUNDANT if has_txn and permit_fast
                   else CMD_OUT_SUCCESS)
        pa_wit = not pa_blocked and not has_txn and not ea_set
        if pa_blocked or has_txn:
            pa_st = st
        else:
            pa_st = max(st, CMD_ST_PRE_ACCEPTED) if ea_set \
                else CMD_ST_PRE_ACCEPTED
        pa_fl = fl if pa_blocked else fl | 1
        pa_pr = pr if pa_blocked else pr_max_bal
        pa_ea = witness if pa_wit else ea

        # Accept (commands.accept)
        committed = st >= CMD_ST_COMMITTED
        if terminal:
            ac_code = term_code
        elif pr_gt_bal or committed:
            ac_code = CMD_OUT_REDUNDANT if committed \
                else CMD_OUT_REJECTED_BALLOT
        else:
            ac_code = CMD_OUT_SUCCESS
        ac_ok = not terminal and not pr_gt_bal and not committed
        ac_st = CMD_ST_ACCEPTED if ac_ok else st
        ac_pr = bal if ac_ok else pr
        ac_ab = bal if ac_ok else ab
        ac_ea = oex if ac_ok else ea

        # Commit -> STABLE (commands.commit)
        ea_eq = ea == oex
        stable = st >= CMD_ST_STABLE
        cm_incons = stable and not terminal and not ea_eq
        cm_insuf = not stable and not has_txn and not msg_has_txn
        cm_ok = not stable and not cm_insuf
        if stable:
            cm_code = CMD_OUT_REDUNDANT + (CMD_OUT_INCONSISTENT_BIT
                                           if cm_incons else 0)
        else:
            cm_code = CMD_OUT_INSUFFICIENT if cm_insuf else CMD_OUT_SUCCESS
        cm_new_st = CMD_ST_STABLE
        if promote and deps_empty:
            cm_new_st = CMD_ST_READY
        cm_st = cm_new_st if cm_ok else st
        cm_fl = fl | 1 if cm_ok and msg_has_txn else fl
        cm_ea = oex if cm_ok else ea
        cm_regval = txn if oex < txn else oex

        # Apply -> PRE_APPLIED (commands.apply)
        preapplied = st >= CMD_ST_PRE_APPLIED
        was_stable = st >= CMD_ST_STABLE
        ap_incons = preapplied and not terminal and not ea_eq
        ap_insuf = not preapplied and not has_txn and not msg_has_txn
        ap_ok = not preapplied and not ap_insuf
        if preapplied:
            ap_code = CMD_OUT_REDUNDANT + (CMD_OUT_INCONSISTENT_BIT
                                           if ap_incons else 0)
        elif ap_insuf:
            ap_code = CMD_OUT_INSUFFICIENT
        else:
            ap_code = CMD_OUT_SUCCESS + (CMD_OUT_WAS_STABLE_BIT
                                         if was_stable else 0)
        ap_new_st = CMD_ST_PRE_APPLIED
        ap_du = du
        if promote:
            if deps_empty:
                ap_new_st = CMD_ST_APPLIED
            if ap_ok and deps_empty:
                ap_du = max(du, dur_local)
        ap_st = ap_new_st if ap_ok else st
        ap_fl = fl | 1 if ap_ok and msg_has_txn else fl
        ap_ea = oex if ap_ok else ea

        # select per kind (any kind past COMMIT is an apply), gate on valid
        sel = (0 if kind == CMD_OP_PREACCEPT else 1 if kind == CMD_OP_ACCEPT
               else 2 if kind == CMD_OP_COMMIT else 3)
        if valid:
            new_st = (pa_st, ac_st, cm_st, ap_st)[sel]
            new_fl = (pa_fl, fl, cm_fl, ap_fl)[sel]
            new_pr = (pa_pr, ac_pr, pr, pr)[sel]
            new_ab = (ab, ac_ab, ab, ab)[sel]
            new_ea = (pa_ea, ac_ea, cm_ea, ap_ea)[sel]
            new_du = (du, du, du, ap_du)[sel]
        else:
            new_st, new_fl, new_pr, new_ab, new_ea, new_du = \
                st, fl, pr, ab, ea, du
        code = (pa_code, ac_code, cm_code, ap_code)[sel]
        ts_out = (pa_ea, ac_ea, cm_ea, ap_ea)[sel]
        do_reg = valid and (pa_wit, ac_ok, cm_ok, ap_ok)[sel]
        regval = (witness, oex, cm_regval, cm_regval)[sel]

        rv[i] = [new_st, new_fl, *new_pr, *new_ab, *new_ea, new_du]
        for s in range(kpad):
            better = not kv[s] or km[s] < regval
            take = do_reg and better and kids[s] >= 0
            kmv[i][s] = list(regval if take else km[s])
            kvv[i][s] = bool(kv_raw[s]) or do_reg
        if valid and sel == 0 and pa_wit:
            clock = wit_clock
        out_code.append(code if valid else -1)
        out_ts.append(list(ts_out))
        out_status.append(new_st)
    return clock, out_code, out_ts, out_status


def cmd_tick_plain(status, flags, promised, accepted, execute_at, durability,
                   kmax, kmax_valid, clock, op_kind, op_row, op_txn,
                   op_ballot, op_exec, op_keys, op_flags, op_now, op_prev,
                   op_rlast, op_kprev, op_klast, node_epoch, lane2_clean,
                   lane2_rej, dur_local, promote: bool = False):
    cap, kcap = status.shape[0], kmax.shape[0]
    n, kpad = op_keys.shape
    dev = status.device
    rowc = op_row.to(torch.int64).clamp(0, cap - 1)
    kidc = op_keys.to(torch.int64).clamp(0, kcap - 1)
    rv = torch.cat([status[rowc, None], flags[rowc, None], promised[rowc],
                    accepted[rowc], execute_at[rowc],
                    durability[rowc, None]], 1).tolist()
    kmv = kmax[kidc].tolist()
    kvv = kmax_valid[kidc].tolist()
    clk, code, ts, st = _cmd_walk(
        rv, kmv, kvv, int(clock), op_kind.tolist(), op_flags.tolist(),
        op_txn.tolist(), op_ballot.tolist(), op_exec.tolist(),
        op_keys.tolist(), op_now.tolist(), op_prev.tolist(),
        op_kprev.tolist(), int(node_epoch), int(lane2_clean),
        int(lane2_rej), int(dur_local), bool(promote))
    _blk, out_code, out_status, out_ts, chains, out_clock, csum = \
        cmd_tick_block(n, kpad, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out_code.copy_(torch.tensor(code, **i32))
    out_status.copy_(torch.tensor(st, **i32))
    out_ts.copy_(torch.tensor(ts, **i32).reshape(n, 3))
    r_ch = torch.tensor(rv, **i32)
    k_km = torch.tensor(kmv, **i32).reshape(n, kpad, 3)
    k_kv = torch.tensor(kvv, dtype=torch.bool, device=dev)
    chains.copy_(torch.cat([r_ch, torch.cat(
        [k_km, k_kv.to(torch.int32)[..., None]], 2).reshape(n, 4 * kpad)],
        1))
    out_clock.fill_(clk)
    # one writeback: each row's / kid's last in-batch writer carries the
    # chain's final value (padding and earlier writers drop)
    wrow = torch.where(op_rlast, op_row, torch.full_like(op_row, cap))
    cols = (status, flags, promised, accepted, execute_at, durability)
    lanes = (r_ch[:, 0], r_ch[:, 1], r_ch[:, 2:5], r_ch[:, 5:8],
             r_ch[:, 8:11], r_ch[:, 11])
    new = tuple(_scatter_lane_plain(c, wrow, v) for c, v in zip(cols, lanes))
    wkid = torch.where(op_klast, op_keys,
                       torch.full_like(op_keys, kcap)).reshape(-1)
    n_kmax = _scatter_lane_plain(kmax, wkid, k_km.reshape(-1, 3))
    n_kvalid = _scatter_lane_plain(kmax_valid, wkid, k_kv.reshape(-1))
    csum.copy_(cmd_checksum(out_code, out_status, out_ts, out_clock))
    return (*new, n_kmax, n_kvalid, out_clock, out_code, out_ts, out_status,
            csum, chains)


def _check_cmd_cols(status, flags, promised, accepted, execute_at,
                    durability, kmax, kvalid) -> None:
    cap, kcap = status.shape[0], kmax.shape[0]
    i32 = (status, flags, promised, accepted, execute_at, durability, kmax)
    if (any(_dtype_name(t) != "int32" for t in i32)
            or _dtype_name(kvalid) != "bool"
            or any(tuple(t.shape) != (cap,) for t in (flags, durability))
            or any(tuple(t.shape) != (cap, 3)
                   for t in (promised, accepted, execute_at))
            or tuple(status.shape) != (cap,)
            or tuple(kmax.shape) != (kcap, 3)
            or tuple(kvalid.shape) != (kcap,)):
        raise ValueError("cmd columns must be i32[cap] x2, i32[cap, 3] x3, "
                         "i32[cap], i32[kcap, 3] and bool[kcap]")


# cmd_tick's C entry: 16 column pointers, cap, kcap, 12 op-lane pointers,
# n, kpad, 5 scalars, promote, 6 result pointers, the ticket, the stream
_CMD_TICK_ARGS = ((_VP,) * 16 + (_I, _I) + (_VP,) * 12 + (_I,) * 8
                  + (_VP,) * 8)


@functools.lru_cache(maxsize=64)
def _cmd_sig(cap: int, kcap: int, n: int, kpad: int) -> tuple:
    """(dtype, shape) of cmd_tick's eight columns and twelve op lanes."""
    i32, b8 = torch.int32, torch.bool
    shapes = ((cap,), (cap,), (cap, 3), (cap, 3), (cap, 3), (cap,),
              (kcap, 3), (kcap,), (n,), (n,), (n, 3), (n, 3), (n, 3),
              (n, kpad), (n,), (n,), (n,), (n,), (n, kpad), (n, kpad))
    dtypes = (i32,) * 7 + (b8,) + (i32,) * 9 + (b8, i32, b8)
    return tuple((d, torch.Size(sh)) for d, sh in zip(dtypes, shapes))


def cmd_tick(status, flags, promised, accepted, execute_at, durability,
             kmax, kmax_valid, clock, op_kind, op_row, op_txn, op_ballot,
             op_exec, op_keys, op_flags, op_now, op_prev, op_rlast, op_kprev,
             op_klast, node_epoch, lane2_clean, lane2_rej, dur_local,
             promote: bool = False):
    """One dispatch evaluating a batch of protocol transitions IN ORDER over
    the command arena's columns (the reference's cmd_tick, see
    csrc/cmd_tick.cu for the contract): PreAccept witness, Accept ballot
    checks, Commit/Apply promotions; `promote` also runs the empty-deps
    maybe_execute promotion. -> (the eight columns, fresh; clock i32 0-d,
    out_code i32[n], out_ts i32[n, 3], out_status i32[n], csum i32 bit
    pattern, chains i32[n, CMD_ROW_LANES + 4 * kpad]). `chains` is not in
    the reference: op i's post-values of its row and kid slots, so the
    last writer of a row or kid holds that row's or kid's new column
    values; the outputs from out_code on are one cmd_tick_block."""
    cols = (status, flags, promised, accepted, execute_at, durability, kmax,
            kmax_valid)
    ops = (op_kind, op_row, op_txn, op_ballot, op_exec, op_keys, op_flags,
           op_now, op_prev, op_rlast, op_kprev, op_klast)
    scalars = (clock, node_epoch, lane2_clean, lane2_rej, dur_local)
    if not status.is_cuda:
        return cmd_tick_plain(*cols, clock, *ops, node_epoch, lane2_clean,
                              lane2_rej, dur_local, promote=promote)
    ext = _ext()
    ts = cols + ops
    _check_cuda(*ts)
    n, kpad = op_keys.shape
    if not 1 <= kpad <= _CMD_KPAD_MAX \
            or [(t.dtype, t.shape) for t in ts] != list(_cmd_sig(
                status.shape[0], kmax.shape[0], n, kpad)):
        _check_cmd_cols(*cols)
        raise ValueError(f"cmd_tick: op lanes must be i32/bool[n] and "
                         f"[n, 3] / [n, kpad] with 1 <= kpad <= "
                         f"{_CMD_KPAD_MAX}")
    dev = status.device
    outs = tuple(torch.empty_like(t) for t in cols)
    _blk, code, ost, ots, chains, oclock, csum = cmd_tick_block(n, kpad, dev)
    ext.entry("cmd_tick", "cmd_tick", _CMD_TICK_ARGS)(
        *(t.data_ptr() for t in cols), *(t.data_ptr() for t in outs),
        status.shape[0], kmax.shape[0], *(t.data_ptr() for t in ops), n,
        kpad, *(int(s) for s in scalars), int(bool(promote)),
        code.data_ptr(), ost.data_ptr(), ots.data_ptr(), chains.data_ptr(),
        oclock.data_ptr(), csum.data_ptr(), zeroed_scratch(dev, 16),
        ext.raw_stream(dev.index))
    LAUNCHES["cmd_tick"] += 1
    return (*outs, oclock, code, ots, ost, csum, chains)


def recovery_scan_plain(status, touched_ms, now_ms, stall_ms, out_cap: int):
    st = status
    live = (st >= CMD_ST_PRE_ACCEPTED) & (st < CMD_ST_APPLIED)
    age = _wrap_i32(_w32(int(now_ms)) - touched_ms.to(torch.int64))
    stalled = live & (age >= _w32(int(stall_ms)))
    indptr, rows = _packed_segment_compact(
        _pack_bits(stalled.reshape(1, -1)), out_cap)
    return indptr, rows, frontier_checksum(indptr, rows)


def recovery_scan(status, touched_ms, now_ms, stall_ms, out_cap: int):
    """Recovery candidates of a command arena, compacted: rows whose status
    is in the live band (PRE_ACCEPTED <= status < APPLIED, so the
    INVALIDATED/TRUNCATED terminals above it are out) and whose last touch
    is at least stall_ms old ((now_ms - touched_ms) in wrapping int32).
    status/touched_ms: i32[cap] (cap % 32 == 0); now_ms/stall_ms: ints.
    -> (indptr i32[2], rows i32[out_cap], csum i32 bit pattern): the
    frontier_compact contract (indptr exact past out_cap, checksum seeds
    13/17 over indptr and all out_cap rows)."""
    cap = status.shape[0]
    if cap % 32 or touched_ms.shape != status.shape \
            or status.dtype != torch.int32 \
            or touched_ms.dtype != torch.int32:
        raise ValueError("recovery_scan: status/touched_ms must be "
                         "i32[cap] with cap % 32 == 0")
    if not status.is_cuda:
        return recovery_scan_plain(status, touched_ms, now_ms, stall_ms,
                                   out_cap)
    ext = _ext()
    _check_cuda(status, touched_ms)
    dev = status.device
    words = cap // 32
    packed, indptr, rows, csum = _i32_outs(dev, (words,), (2,), (out_cap,),
                                           ())
    ext.entry("recovery_scan", "recovery_scan",
              (_VP, _VP, _I, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP))(
        status.data_ptr(), touched_ms.data_ptr(), cap, _w32(int(now_ms)),
        _w32(int(stall_ms)), out_cap, packed.data_ptr(), indptr.data_ptr(),
        rows.data_ptr(), csum.data_ptr(), _csr_scratch(dev, words),
        ext.raw_stream(dev.index))
    LAUNCHES["recovery_scan"] += 1
    return indptr, rows, csum


def cmd_repair_plain(status, flags, promised, accepted, execute_at,
                     durability, kmax, kvalid, rows_idx, st_v, fl_v, pr_v,
                     ab_v, ea_v, du_v, kid_idx, km_v, kv_v):
    rows = (st_v, fl_v, pr_v, ab_v, ea_v, du_v)
    cols = (status, flags, promised, accepted, execute_at, durability)
    return (*(_scatter_lane_plain(c, rows_idx, v)
              for c, v in zip(cols, rows)),
            _scatter_lane_plain(kmax, kid_idx, km_v),
            _scatter_lane_plain(kvalid, kid_idx, kv_v))


def cmd_repair(status, flags, promised, accepted, execute_at, durability,
               kmax, kvalid, rows_idx, st_v, fl_v, pr_v, ab_v, ea_v, du_v,
               kid_idx, km_v, kv_v):
    """The command plane's shadow repair (the reference's _cmd_repair_body):
    fresh copies of the eight columns with the host shadows' values
    scattered over the dirty rows (rows_idx, values st_v..du_v) and kids
    (kid_idx, km_v, kv_v). Indices follow the `.at[]` rules: the padding
    sentinels cap / kcap drop."""
    cols = (status, flags, promised, accepted, execute_at, durability, kmax,
            kvalid)
    vals = (rows_idx, st_v, fl_v, pr_v, ab_v, ea_v, du_v, kid_idx, km_v,
            kv_v)
    if not status.is_cuda:
        return cmd_repair_plain(*cols, *vals)
    ext = _ext()
    _check_cuda(*cols, *vals)
    check_repair_lanes(cols, vals)
    outs = tuple(torch.empty_like(t) for t in cols)
    launch_cmd_repair(ext, _addr, cols, outs, vals,
                      repair_dims(cols, vals))
    LAUNCHES["cmd_repair"] += 1
    return outs


def repair_dims(cols, vals) -> tuple:
    """(cap, kcap, rows m, kids k) of a cmd_repair block."""
    return (cols[0].shape[0], cols[6].shape[0], vals[0].shape[0],
            vals[7].shape[0])


def check_repair_lanes(cols, vals) -> None:
    """cmd_repair's eight columns and ten index/value lanes."""
    _check_cmd_cols(*cols)
    m, k = vals[0].shape[0], vals[7].shape[0]
    shapes = ((m,), (m,), (m,), (m, 3), (m, 3), (m, 3), (m,), (k,), (k, 3),
              (k,))
    if (any(tuple(t.shape) != s for t, s in zip(vals, shapes))
            or any(_dtype_name(t) != "int32" for t in vals[:-1])
            or _dtype_name(vals[-1]) != "bool"):
        raise ValueError("cmd_repair: index and value lanes must match the "
                         "columns' row shapes and dtypes")


def launch_cmd_repair(ext, A, cols, outs, vals, dims) -> None:
    """K12's launch on device addresses (`A(x)`, see _addr): the eight
    columns, their eight fresh outputs, the ten index/value lanes; dims
    (cap, kcap, rows m, kids k). cmd_repair and the protocol megakernel's
    graph both launch it here."""
    cap, kcap, m, k = dims
    ext.call("cmd_repair", "cmd_repair", *(A(t) for t in cols),
             *(A(t) for t in outs), cap, kcap, *(A(t) for t in vals), m, k,
             ext.stream())


# -- K16: the fast-path quorum count; the protocol megakernel ---------------
def quorum_count_plain(txn, ts, code, valid, qsize: int):
    fast = valid & ((code & 7) == CMD_OUT_SUCCESS) & (ts == txn).all(1)
    same = (txn[:, None, :] == txn[None, :, :]).all(2)
    votes = (same & fast[None, :]).sum(1, dtype=torch.int32)
    return fast, votes, fast & (votes >= qsize)


def quorum_count(txn, ts, code, valid, qsize: int):
    """The fast-path electorate count over a tick's PreAccept transition
    lanes (txn, ts i32[t, 3], code i32[t], valid bool[t]): a lane is a
    fast-path witness iff valid, its code SUCCEEDED and it echoed its txn
    id unchanged; votes[i] counts the fast lanes of the same txn; met =
    fast & votes >= qsize. -> (fast bool[t], votes i32[t], met bool[t])."""
    if not txn.is_cuda:
        return quorum_count_plain(txn, ts, code, valid, qsize)
    ext = _ext()
    lanes = (txn, ts, code, valid)
    _check_cuda(*lanes)
    t = check_quorum_lanes(lanes)
    dev = txn.device
    outs = (torch.empty(t, dtype=torch.bool, device=dev),
            torch.empty(t, dtype=torch.int32, device=dev),
            torch.empty(t, dtype=torch.bool, device=dev))
    launch_quorum(ext, _addr, lanes, t, qsize, outs)
    LAUNCHES["quorum_count"] += 1
    return outs


def check_quorum_lanes(lanes) -> int:
    """K16's lanes (tensors or numpy arrays); -> the lane count t."""
    txn, ts, code, valid = lanes
    t = txn.shape[0]
    if (tuple(txn.shape) != (t, 3) or tuple(ts.shape) != (t, 3)
            or tuple(code.shape) != (t,) or tuple(valid.shape) != (t,)
            or _dtype_name(valid) != "bool"
            or any(_dtype_name(x) != "int32" for x in (txn, ts, code))):
        raise ValueError("quorum_count: lanes must be i32[t, 3] x2, i32[t] "
                         "and bool[t]")
    return t


# quorum_count and quorum_geometry (csrc/quorum.cu), lean launches
_QUORUM_ARGS = (_VP,) * 4 + (_I, _I) + (_VP,) * 4
_QUORUM_GEOM_ARGS = (_I, _VP)


def launch_quorum(ext, A, lanes, t: int, qsize: int, outs) -> None:
    """K16's launch on device addresses (`A(x)`, see _addr): lanes (txn,
    ts, code, valid) of t lanes, outs (fast, votes, met). quorum_count
    and the protocol megakernel's graph both launch it here (ONE launch:
    a cluster of CTAs a tile of lanes, csrc/quorum.cu)."""
    ext.entry("quorum", "quorum_count", _QUORUM_ARGS)(
        *(A(x) for x in lanes), t, int(qsize), *(A(o) for o in outs),
        ext.stream())


def quorum_geometry(t: int) -> dict:
    """K16's launch at t lanes on the current card: threads a CTA (a lane
    i each), the cluster size (slices of the lanes j a CTA's tile is split
    into), the clusters of the grid, and the clusters the card holds at
    once (cudaOccupancyMaxActiveClusters)."""
    out = (ctypes.c_int * 4)()
    _ext().entry("quorum", "quorum_geometry", _QUORUM_GEOM_ARGS)(
        int(t), ctypes.addressof(out))
    return dict(zip(("threads", "cluster", "clusters", "max_active"), out))


def _fin_split(fins):
    """Split finalize specs into (static signature, traced args) and
    stable-sort them by static signature, so a tick's program depends on
    its signature MULTISET, not on the order its plans arrived in (on the
    card: one captured graph per multiset). Returns (fin_statics,
    fin_traced, order); _fin_unsort(outs, order) undoes the sort."""
    fin_statics, fin_traced = [], []
    for f in fins:
        if f[0] == "range":
            fin_statics.append(("range", f[8]))
            fin_traced.append(tuple(f[1:8]))
        else:
            fin_statics.append((f[0], f[3], f[4], f[11]))
            fin_traced.append((f[1], f[2]) + tuple(f[5:11]))
    order = sorted(range(len(fin_statics)), key=lambda i: fin_statics[i])
    return ([fin_statics[i] for i in order],
            [fin_traced[i] for i in order], order)


def _fin_unsort(fin_outs, order):
    """Undo _fin_split's canonical sort: callers demux fin_outs
    positionally against the fins they passed in."""
    if order == list(range(len(order))):
        return tuple(fin_outs)
    back = [0] * len(order)
    for pos, i in enumerate(order):
        back[i] = pos
    return tuple(fin_outs[back[i]] for i in range(len(order)))


def _window(src, r0, w_lo, rows: int, words: int):
    """jax.lax.dynamic_slice of [rows, words] at (r0, w_lo)."""
    from accord_tpu_torch.ops.node_lane import dyn_start
    r = dyn_start(r0, src.shape[0], rows)
    w = dyn_start(w_lo, src.shape[1], words)
    return src[r:r + rows, w:w + words]


def _host_lane(x, dev):
    """A numpy lane as a tensor on `dev` (the plain path)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return x


def _protocol_tick_plain(witness_table, key_in, rng_in, fin_statics,
                         fin_traced, cmds, quorum, quorum_size, mailbox,
                         cmd_repairs, execs):
    """The reference's program, stage by stage, with the plain versions."""
    from accord_tpu_torch.ops import node_lane as nl
    dev = witness_table.device
    packed = ()
    rng_out = ()
    if key_in is not None:
        packed = nl.node_fused_deps_resolve_plain(*key_in, witness_table)
    if rng_in is not None:
        rng_out = nl.node_fused_range_deps_resolve_plain(*rng_in,
                                                         witness_table)
    fin_outs = []
    for spec, args in zip(fin_statics, fin_traced):
        if spec[0] == "range":
            iv_of, iv_s, iv_e, ent_ok, f_sb, f_sknd, rsnap = args
            fin_outs.append(range_finalize_csr_plain(
                *(_host_lane(x, dev) for x in (iv_of, iv_s, iv_e, ent_ok,
                                               f_sb, f_sknd)),
                *rsnap, witness_table, spec[1]))
            continue
        kind, rows, words, out_cap = spec
        (r0, w_lo, word_off, kid_rows, slot_subj, slot_kid, subj_row,
         act_ts) = args
        src = packed if kind == "key" else rng_out[1]
        fin_outs.append(finalize_csr_plain(
            _window(src, r0, w_lo, rows, words), int(word_off), kid_rows,
            *(_host_lane(x, dev) for x in (slot_subj, slot_kid, subj_row)),
            act_ts, out_cap))
    cmd_outs = tuple(cmd_tick_plain(*(_host_lane(x, dev) for x in c[:-1]),
                                    promote=bool(c[-1])) for c in cmds)
    q_out = ()
    if quorum is not None:
        q_out = quorum_count_plain(*(_host_lane(x, dev) for x in quorum),
                                   int(quorum_size))
    mail_out = ()
    if mailbox is not None:
        from accord_tpu_torch.ops.mailbox import mailbox_route_plain
        mail_out = mailbox_route_plain(*(_host_lane(x, dev)
                                         for x in mailbox))
    rep_outs = tuple(cmd_repair_plain(*(_host_lane(x, dev) for x in r))
                     for r in cmd_repairs)
    exec_outs = tuple(frontier_compact_plain(pl, int(oc))
                      for pl, oc in execs)
    return (packed, rng_out, tuple(fin_outs), cmd_outs, q_out, mail_out,
            rep_outs, exec_outs)


def protocol_tick(witness_table, key_in=None, rng_in=None, fins=(),
                  cmds=(), quorum=None, quorum_size=1, mailbox=None,
                  cmd_repairs=(), execs=()):
    """The protocol megakernel: ONE device program per cluster tick
    covering the node-lane resolves (K13, K14), every plan's finalize
    compaction read in place at its merge span (K2, K6), cmd_tick blocks
    (K10), the fast-path quorum count (K16), the device message plane's
    mailbox routing (K17), cmd-plane repair scatters (K12) and exec
    frontier compactions (K9). On the card the program is a
    CUDA graph per static signature (ops/tick_graph.py), replayed once per
    call and counted in LAUNCHES["protocol_tick"] (captures in CAPTURES);
    on the CPU the plain versions run in order.

    key_in:  node_fused_deps_resolve's args minus witness_table, or None
    rng_in:  node_fused_range_deps_resolve's args minus witness_table
    fins:    finalize specs, one per (plan, group), in harvest order:
               ("key",  row_off, w_lo, rows, words, word_off, kid_rows,
                slot_subj, slot_kid, subj_row, act_ts, out_cap)
               ("rkey", ... the same, on the range stage's key-side output)
               ("range", iv_of, iv_s, iv_e, ent_ok, sb, sknd, rsnap 5-tuple,
                out_cap)
             key/rkey specs read their plan's [rows x words] window of the
             merged result (dynamic_slice rules) and finalize it at the
             group's word offset.
    cmds:    cmd_tick argument tuples (every positional arg, promote last)
    quorum:  (txn i32[t, 3], ts i32[t, 3], code i32[t], valid bool[t])
             padded to a MEGA_LANE_TIERS tier; quorum_size the electorate
             majority
    mailbox: ops/mailbox.MailboxPlane.stage_batch's block (arena, meta,
             e_src, e_dst, e_slot, e_keep, e_kind, e_seq, e_words, part):
             the arena and meta update in place, and mail_out is
             (arena, meta, landed_words, landed_meta, land)
    cmd_repairs: CmdPlane.collect_repair blocks (cmd_repair's 18 args)
    execs:   ((planes, out_cap), ...) frontier_compact blocks
    Lanes may be numpy arrays. -> (packed, (rpacked, kpacked), fin_outs,
    cmd_outs, (fast, votes, met), mail_out, rep_outs, exec_outs); absent
    stages return (); cmd_outs and exec_outs follow cmd_tick's and
    frontier_compact's output tuples."""
    if witness_table.is_cuda:
        from accord_tpu_torch.ops.tick_graph import run_protocol_tick
        runner = run_protocol_tick
    else:
        runner = _protocol_tick_plain
    return _protocol_tick(runner, witness_table, key_in, rng_in, fins, cmds,
                          quorum, quorum_size, mailbox, cmd_repairs, execs)


def protocol_tick_plain(witness_table, key_in=None, rng_in=None, fins=(),
                        cmds=(), quorum=None, quorum_size=1, mailbox=None,
                        cmd_repairs=(), execs=()):
    """protocol_tick's plain version on any device: the stages' plain
    versions in order."""
    return _protocol_tick(_protocol_tick_plain, witness_table, key_in,
                          rng_in, fins, cmds, quorum, quorum_size, mailbox,
                          cmd_repairs, execs)


def _protocol_tick(runner, witness_table, key_in, rng_in, fins, cmds,
                   quorum, quorum_size, mailbox, cmd_repairs, execs):
    if mailbox is not None:
        from accord_tpu_torch.ops.mailbox import check_mail_lanes
        check_mail_lanes(mailbox)
        mailbox = tuple(mailbox)
    fin_statics, fin_traced, order = _fin_split(fins)
    out = runner(witness_table, key_in, rng_in, fin_statics, fin_traced,
                 tuple(cmds), quorum, quorum_size, mailbox,
                 tuple(cmd_repairs), tuple(execs))
    return out[:2] + (_fin_unsort(out[2], order),) + out[3:]


def jit_cache_sizes() -> dict:
    """The reference's compiled-variant counts of the warmable hot-path
    kernels (accord_tpu/ops/kernels.py:1535), with its keys. The port's
    hand kernels take every shape as launch arguments and are not
    specialised on it, so every kernel's entry is 0 here; the one thing
    made per static signature is a CUDA graph, so protocol_tick and
    sharded_protocol_tick read the graphs each holds (captured minus
    evicted, ops/tick_graph.py). A bench snapshots this around a timed
    window: equal snapshots mean no capture after warmup."""
    from accord_tpu_torch.ops import tick_graph
    held = tick_graph.held_graphs()
    keys = ("deps_resolve", "range_deps_resolve", "fused_deps_resolve",
            "fused_range_deps_resolve", "arena_scatter", "arena_scatter_keys",
            "scatter_rows", "range_scatter", "finalize_csr",
            "range_finalize_csr", "kid_word_scatter",
            "fused_execution_frontier", "frontier_compact", "recovery_scan",
            "cmd_tick", "protocol_tick", "node_fused_deps_resolve",
            "node_fused_range_deps_resolve", "lane_slice",
            "sharded_protocol_tick")
    return {k: held.get(k, 0) for k in keys}


# -- K18-K21: the execute-DAG kernels (csrc/dense_dag.cu) ---------------------
def deps_matrix_plain(subj_words, subj_before, subj_kinds, act_words, act_ts,
                      act_kinds, act_valid, witness_table):
    """The reference's deps_matrix on packed bitmaps: the overlap is the
    0/1 matmul > 0.5, as there (exact: the addends are 0 or 1)."""
    s = _unpack_bits(subj_words).to(torch.float32)
    a = _unpack_bits(act_words).to(torch.float32)
    overlap = (s @ a.T) > 0.5
    n0, n1 = witness_table.shape
    witness = witness_table[_gather_index(subj_kinds, n0)[:, None],
                            _gather_index(act_kinds, n1)[None, :]] == 1
    before = _lex_before(act_ts[None, :, :], subj_before[:, None, :])
    return overlap & witness & before & act_valid[None, :]


def deps_matrix(subj_words, subj_before, subj_kinds, act_words, act_ts,
                act_kinds, act_valid, witness_table):
    """K18, the pairwise dependency matrix (the reference's deps_matrix):
    dep[b, a] iff subject b's and active a's bucket bitmaps share a bucket,
    subject b's kind witnesses a's (witness_table[kind_b, kind_a] == 1,
    gather rules), act_ts[a] is lex-before subj_before[b] and act_valid[a].
    Bitmaps are packed, i32[B, K/32] and i32[A, K/32] (carry.pack_bitmaps),
    for any K a multiple of 32. -> bool[B, A]."""
    if not subj_words.is_cuda:
        return deps_matrix_plain(subj_words, subj_before, subj_kinds,
                                 act_words, act_ts, act_kinds, act_valid,
                                 witness_table)
    lanes = (subj_words, subj_before, subj_kinds, act_words, act_ts,
             act_kinds, act_valid, witness_table)
    b, kw = subj_words.shape
    a = act_words.shape[0]
    if (tuple(act_words.shape) != (a, kw)
            or tuple(subj_before.shape) != (b, 3)
            or tuple(subj_kinds.shape) != (b,)
            or tuple(act_ts.shape) != (a, 3) or tuple(act_kinds.shape) != (a,)
            or tuple(act_valid.shape) != (a,) or witness_table.dim() != 2
            or act_valid.dtype != torch.bool
            or any(x.dtype != torch.int32 for x in lanes
                   if x is not act_valid)):
        raise ValueError("deps_matrix: packed words i32[B, K/32] and "
                         "i32[A, K/32], ts i32[., 3], kinds i32[.], valid "
                         "bool[A], witness_table i32[k0, k1]")
    ext = _ext()
    _check_cuda(*lanes)
    dev = subj_words.device
    out = torch.empty(b, a, dtype=torch.bool, device=dev)
    n0, n1 = witness_table.shape
    ext.entry("dense_dag", "deps_matrix", _DEPS_MATRIX_ARGS)(
        *(x.data_ptr() for x in lanes), n0, n1, b, a, kw, out.data_ptr(),
        ext.raw_stream(dev.index))
    LAUNCHES["deps_matrix"] += 1
    return out


_DEPS_MATRIX_ARGS = (_VP,) * 8 + (_I,) * 5 + (_VP, _VP)
_DEPS_STRIDED_ARGS = (_VP, _I, _VP, _VP, _VP, _I) + (_VP,) * 4 + (_I,) * 5 \
    + (_VP, _VP)
# K19's zeroed flag words (csrc/dense_dag.cu CT_FLAGS)
_CLOSURE_FLAG_BYTES = 4 * 5
_CLOSURE_ARGS = (_VP, _I, _I) + (_VP,) * 6
_CLOSURE_ROWS_ARGS = (_VP, _I, _I, _I) + (_VP,) * 3


def transitive_closure_step_plain(r):
    """One squaring of the reference's closure: R | (R @ R > 0.5)."""
    rf = r.to(torch.float32)
    return r | ((rf @ rf) > 0.5)


def transitive_closure_plain(adj, iterations: int, worked=None):
    """Every squaring, as the reference runs them. `worked` (i32[1]), if
    given, gets the squarings up to and including the first that changes
    nothing: the ones the kernel does work in."""
    r = adj.clone()
    busy, settled = 0, worked is None
    for _ in range(int(iterations)):
        nxt = transitive_closure_step_plain(r)
        if not settled:
            busy += 1
            settled = bool(torch.equal(nxt, r))
        r = nxt
    if worked is not None:
        worked.fill_(busy)
    return r


def _check_square_bool(adj, who: str) -> int:
    n = adj.shape[0]
    if adj.dim() != 2 or adj.shape[1] != n or adj.dtype != torch.bool:
        raise ValueError(f"{who}: adjacency must be bool[N, N]")
    return n


def transitive_closure(adj, iterations: int, worked=None):
    """K19: reachability by repeated squaring, R |= (R @ R > 0.5), exactly
    `iterations` times, each from the previous R (the reference's
    transitive_closure). bool[N, N] -> bool[N, N]. The kernel returns at
    once from each squaring after one that changed nothing (exact);
    `worked` (i32[1] on adj's device), if given, gets the number of
    squarings that did work."""
    if not adj.is_cuda:
        return transitive_closure_plain(adj, iterations, worked)
    ext = _ext()
    n = _check_square_bool(adj, "transitive_closure")
    _check_cuda(adj)
    if worked is not None and (worked.dtype != torch.int32
                               or worked.numel() != 1
                               or worked.device != adj.device):
        raise ValueError("transitive_closure: worked must be i32[1] on "
                         "adj's device")
    dev = adj.device
    nw = (n + 31) // 32
    pa = torch.empty(n, nw, dtype=torch.int32, device=dev)
    pb = torch.empty_like(pa)
    out = torch.empty_like(adj)
    ext.entry("dense_dag", "transitive_closure", _CLOSURE_ARGS)(
        adj.data_ptr(), n, int(iterations), pa.data_ptr(), pb.data_ptr(),
        out.data_ptr(), zeroed_scratch(dev, _CLOSURE_FLAG_BYTES),
        None if worked is None else worked.data_ptr(),
        ext.raw_stream(dev.index))
    LAUNCHES["transitive_closure"] += 1
    return out


# execution_wavefronts (csrc/dense_dag.cu): its lean launch; its zeroed
# flags are dag_wavefronts_packed's (_DAG_FLAG_BYTES: the grid barrier's
# count and generation, the exit ticket; left zeroed)
_WAVE_ARGS = (_VP, _I, _I, _VP, _VP, _VP, _VP)


def execution_wavefronts_plain(adj, max_levels: int):
    n = adj.shape[0]
    level = torch.zeros(n, dtype=torch.int32, device=adj.device)
    zero = torch.zeros((), dtype=torch.int32, device=adj.device)
    for _ in range(int(max_levels)):
        dep = torch.where(adj, level[None, :] + 1, zero)
        level = torch.maximum(level, dep.max(dim=1).values)
    return level


def execution_wavefronts(adj, max_levels: int):
    """K20: topological execution levels, level'[i] = max(level[i],
    max_j adj[i, j] * (level[j] + 1)) from zeros for `max_levels` rounds,
    each from the previous round's levels (the reference's
    execution_wavefronts; under a cycle the levels climb with the rounds).
    bool[N, N] -> i32[N]."""
    if not adj.is_cuda:
        return execution_wavefronts_plain(adj, max_levels)
    ext = _ext()
    n = _check_square_bool(adj, "execution_wavefronts")
    _check_cuda(adj)
    dev = adj.device
    nw = (n + 31) // 32
    packed = torch.empty(n, nw, dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    ext.entry("dense_dag", "execution_wavefronts", _WAVE_ARGS)(
        adj.data_ptr(), n, max(0, int(max_levels)), packed.data_ptr(),
        out.data_ptr(), zeroed_scratch(dev, _DAG_FLAG_BYTES),
        ext.raw_stream(dev.index))
    LAUNCHES["execution_wavefronts"] += 1
    return out


def dag_wavefronts_packed_plain(adj_packed, max_levels: int):
    n, words = adj_packed.shape
    dev = adj_packed.device
    applied = torch.zeros(words, dtype=torch.int32, device=dev)
    level = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for i in range(int(max_levels)):
        blocked = ((adj_packed & ~applied[None, :]) != 0).any(1)
        ready = ~blocked & (level < 0)
        level = torch.where(ready, torch.full_like(level, i), level)
        applied = applied | _pack_bits(ready.reshape(1, n))[0]
    return level


# dag_wavefronts_packed (csrc/dense_dag.cu): its zeroed flags (the grid
# barrier's count and generation, the exit ticket; left zeroed) and lean
# launch
_DAG_FLAG_BYTES = 4 * 3
_DAG_ARGS = (_VP, _I, _I, _I, _VP, _VP, _VP, _I, _VP)


def dag_wavefronts_packed(adj_packed, max_levels: int, max_blocks: int = 0):
    """K21: release rounds over a packed DAG (the reference's
    dag_wavefronts_packed): adj_packed i32[N, N/32], bit d of row w set
    iff w depends on d. Round i: rows with no dependency outside the
    previous rounds' applied set, and no level yet, get level i and join
    the applied set. -> i32[N], -1 where never settled. On the card ONE
    launch, which stops at the first round that settles nothing (exact:
    every later round would be a no-op) and walks only unsettled rows.
    max_blocks caps its grid (0: every block the card holds at once); a
    smaller grid gives each lane more rows, which the card tests use to
    walk several rows a lane at small N."""
    n, words = adj_packed.shape
    if n != 32 * words or adj_packed.dtype != torch.int32:
        raise ValueError("dag_wavefronts_packed: adjacency must be "
                         "i32[N, N/32]")
    if not adj_packed.is_cuda:
        return dag_wavefronts_packed_plain(adj_packed, max_levels)
    ext = _ext()
    _check_cuda(adj_packed)
    dev = adj_packed.device
    levels = max(0, int(max_levels))   # no round below 0, as a fori_loop
    level = torch.empty(n, dtype=torch.int32, device=dev)
    lib = ext.lib("dense_dag")
    lib.dag_buf_ints.restype = ctypes.c_longlong
    buf = torch.empty(int(lib.dag_buf_ints(n, levels)), dtype=torch.int32,
                      device=dev)
    ext.entry("dense_dag", "dag_wavefronts_packed", _DAG_ARGS)(
        adj_packed.data_ptr(), n, words, levels, level.data_ptr(),
        buf.data_ptr(), zeroed_scratch(dev, _DAG_FLAG_BYTES),
        int(max_blocks), ext.raw_stream(dev.index))
    LAUNCHES["dag_wavefronts_packed"] += 1
    return level


# -- padded-size ladders (the JAX package's tiers, kept for bit-equal
#    shapes: the same dispatches pad to the same sizes) ----------------------
# -- mesh shards: K1, K5, K2 and K18-K20 at shard-local offsets -------------
# A sharded call of parallel/mesh.py runs each shard's part through one of
# these wrappers on the shard's device, on views of the consumer's arrays
# (a 'data' row block; a 'model' word slice, read in place through its row
# stride) or on copies of them. Each writes its packed words into `out`
# (a contiguous [B, W] tensor on the shard's device) at column `col` and
# returns `out`; the plain versions compute the same block on the CPU.
def _rows_view(t: torch.Tensor, who: str) -> int:
    """The row stride of a 2-D operand read in place (its rows must be
    contiguous)."""
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{who}: a 2-D operand with contiguous rows")
    return t.stride(0)


def _check_out(out: torch.Tensor, col: int, width: int, dev, who: str):
    if (out.dim() != 2 or not out.is_contiguous() or out.device != dev
            or col < 0 or col + width > out.shape[1]
            or out.dtype != torch.int32):
        raise ValueError(f"{who}: out must be a contiguous int32 [B, W] on "
                         f"{dev} with room for {width} words at {col}")


def deps_resolve_shard_plain(subj_of, subj_keys, subj_store, slot,
                             subj_before, subj_kinds, bm, ts, kinds, valid,
                             witness_table, k_total: int, base: int):
    b = subj_before.shape[0]
    words = _subject_words(subj_of, subj_keys, b, k_total, base,
                           bm.shape[1] * 32)
    mine = None if subj_store is None else subj_store == slot
    return _resolve_block_plain(words, subj_before, subj_kinds, mine, bm, ts,
                                kinds, valid, witness_table)


def deps_resolve_shard(subj_of, subj_keys, subj_store, slot, subj_before,
                       subj_kinds, bm, ts, kinds, valid, witness_table,
                       k_total: int, base: int, out, col: int = 0):
    """K1 on one mesh shard: the subjects' keys in the bucket slice [base,
    base + K_l) of k_total (K_l = bm.shape[1] * 32; bm is the shard's rows
    of the arena's word slice) against the shard's arena rows -> the
    block's packed words [B, cap_l/32] at out[:, col]. subj_store/slot
    (slot a one-entry tensor) mask a fused store block; None for one
    store."""
    cap, nwl = bm.shape
    if not bm.is_cuda:
        out[:, col:col + cap // 32] = deps_resolve_shard_plain(
            subj_of, subj_keys, subj_store, slot, subj_before, subj_kinds,
            bm, ts, kinds, valid, witness_table, k_total, base)
        return out
    if nwl > 32 or cap % 32:
        raise ValueError("deps_resolve_shard: K_l <= 1024 buckets and a "
                         "cap that is a multiple of 32")
    ext = _ext()
    stride = _rows_view(bm, "deps_resolve_shard")
    fused = subj_store is not None
    _check_cuda(subj_of, subj_keys, subj_before, subj_kinds, ts, kinds,
                valid, witness_table, *((subj_store, slot) if fused else ()))
    dev = subj_before.device
    _check_out(out, col, cap // 32, dev, "deps_resolve_shard")
    b = subj_before.shape[0]
    words = torch.empty(b, nwl, dtype=torch.int32, device=dev)
    st = ext.raw_stream(dev.index)
    _deps_subjects(ext, subj_of, subj_keys, b, k_total, base, nwl * 32,
                   words, st)
    ext.entry("deps_resolve", "deps_block", _DEPS_BLOCK_ARGS)(
        words.data_ptr(), subj_before.data_ptr(), subj_kinds.data_ptr(),
        subj_store.data_ptr() if fused else None,
        slot.data_ptr() if fused else None, b, bm.data_ptr(), stride,
        ts.data_ptr(), kinds.data_ptr(), valid.data_ptr(), cap, nwl,
        witness_table.data_ptr(), witness_table.shape[0], out.data_ptr(),
        out.shape[1], col, st)
    LAUNCHES["deps_resolve_shard"] += 1
    return out


def range_block_shard_plain(iv_of, iv_start, iv_end, subj_store, slot,
                            subj_before, subj_kinds, r_start, r_end, r_ts,
                            r_kinds, r_valid, witness_table):
    b = subj_before.shape[0]
    any_r = _range_any_plain(iv_of, iv_start, iv_end, b, r_start, r_end)
    mine = None if subj_store is None else subj_store == slot
    return _range_block_plain(any_r, subj_before, subj_kinds, mine, r_ts,
                              r_kinds, r_valid, witness_table)


def range_block_shard(iv_of, iv_start, iv_end, subj_store, slot,
                      subj_before, subj_kinds, r_start, r_end, r_ts, r_kinds,
                      r_valid, witness_table, out, col: int = 0):
    """K5's range side on one mesh shard: the interval stab over the
    shard's 'data' rows of a range arena -> [B, rcap_l/32] at
    out[:, col]."""
    rcap = r_start.shape[0]
    if not r_start.is_cuda:
        out[:, col:col + rcap // 32] = range_block_shard_plain(
            iv_of, iv_start, iv_end, subj_store, slot, subj_before,
            subj_kinds, r_start, r_end, r_ts, r_kinds, r_valid,
            witness_table)
        return out
    if rcap % 32:
        raise ValueError(f"range_block_shard: rcap {rcap} % 32 != 0")
    ext = _ext()
    fused = subj_store is not None
    _check_cuda(iv_of, iv_start, iv_end, subj_before, subj_kinds, r_start,
                r_end, r_ts, r_kinds, r_valid, witness_table,
                *((subj_store, slot) if fused else ()))
    dev = subj_before.device
    _check_out(out, col, rcap // 32, dev, "range_block_shard")
    launch_range(ext, range_spec(((r_start, r_end, r_ts, r_kinds,
                                   r_valid),), out.data_ptr(), col), 1,
                 (iv_of, iv_start, iv_end), subj_before.shape[0],
                 subj_before, subj_kinds, subj_store if fused else None,
                 slot if fused else None, witness_table, out.shape[1])
    LAUNCHES["range_resolve_shard"] += 1
    return out


def range_key_shard_plain(iv_of, iv_start, iv_end, subj_store, slot,
                          subj_before, subj_kinds, subj_is_range, bm, ts,
                          kinds, valid, witness_table, k_total: int,
                          base: int):
    b = subj_before.shape[0]
    cov = covered_buckets_plain(iv_of, iv_start, iv_end, b,
                                bm.shape[1] * 32, base, k_total)
    mine = subj_is_range if subj_store is None \
        else (subj_store == slot) & subj_is_range
    return _resolve_block_plain(cov, subj_before, subj_kinds, mine, bm, ts,
                                kinds, valid, witness_table)


def range_key_shard(iv_of, iv_start, iv_end, subj_store, slot, subj_before,
                    subj_kinds, subj_is_range, bm, ts, kinds, valid,
                    witness_table, k_total: int, base: int, out,
                    col: int = 0):
    """K5's key side on one mesh shard: the range subjects' covered
    buckets in the slice [base, base + K_l) of k_total against the shard's
    rows of the key arena's word slice -> [B, cap_l/32] at out[:, col]."""
    cap, nwl = bm.shape
    if not bm.is_cuda:
        out[:, col:col + cap // 32] = range_key_shard_plain(
            iv_of, iv_start, iv_end, subj_store, slot, subj_before,
            subj_kinds, subj_is_range, bm, ts, kinds, valid, witness_table,
            k_total, base)
        return out
    if nwl > 32 or cap % 32:
        raise ValueError("range_key_shard: K_l <= 1024 buckets and a cap "
                         "that is a multiple of 32")
    ext = _ext()
    stride = _rows_view(bm, "range_key_shard")
    fused = subj_store is not None
    _check_cuda(iv_of, iv_start, iv_end, subj_before, subj_kinds,
                subj_is_range, ts, kinds, valid, witness_table,
                *((subj_store, slot) if fused else ()))
    dev = subj_before.device
    _check_out(out, col, cap // 32, dev, "range_key_shard")
    b = subj_before.shape[0]
    null = ext.ctypes_null()
    st = ext.stream()
    cov = torch.empty(b, nwl, dtype=torch.int32, device=dev)
    launch_range(ext, range_spec((), 0), 0, (iv_of, iv_start, iv_end), b,
                 None, None, None, None, None, 0, cov, base, nwl * 32,
                 k_total)
    ext.entry("range_resolve", "range_key_block", _RANGE_KEY_ARGS)(
        ext.ptr(cov), ext.ptr(subj_before), ext.ptr(subj_kinds),
        ext.ptr(subj_is_range), ext.ptr(subj_store) if fused else null,
        ext.ptr(slot) if fused else null, b, ext.ptr(bm), stride,
        ext.ptr(ts), ext.ptr(kinds), ext.ptr(valid), cap, nwl,
        ext.ptr(witness_table), witness_table.shape[0], ext.ptr(out),
        out.shape[1], col, st)
    LAUNCHES["range_resolve_shard"] += 1
    return out


def _shard_masked(blk, kid, slot_subj, slot_kid, subj_row, base_w: int):
    """(masked words i32[S, wl], kid words i32[S, wl], in-range slots) of
    one 'data' shard's word columns [base_w, base_w + wl) of a finalize
    span: finalize_csr_plain's masking with shard-global word indices."""
    b = blk.shape[0]
    kc, wl = kid.shape
    ok = (slot_subj >= 0) & (slot_subj < b) & (slot_kid >= 0) \
        & (slot_kid < kc)
    kid_m = kid[slot_kid.to(torch.int64).clamp(0, kc - 1)]
    so = slot_subj.to(torch.int64).clamp(0, b - 1)
    m = torch.where(ok[:, None], blk[so] & kid_m, torch.zeros_like(kid_m))
    r = subj_row[so].to(torch.int64)
    widx = base_w + torch.arange(wl, device=blk.device)
    self_word = (r >= 0)[:, None] & (widx[None, :] == (r >> 5)[:, None])
    selfbit = torch.where(self_word, _to_i32(1 << (r & 31))[:, None],
                          torch.zeros((), dtype=torch.int32,
                                      device=blk.device))
    return m & ~selfbit, kid_m, ok


# K2's per-shard launches (csrc/finalize_csr.cu), lean launches
_SHARD_COUNT_ARGS = (_VP, _I, _I, _VP, _I, _I, _I, _I, _VP, _VP, _I, _VP,
                     _VP, _VP, _I, _I, _VP)
_SHARD_COMPACT_ARGS = (_VP, _I, _I, _VP, _I, _I, _I, _I, _VP, _VP, _I, _VP,
                       _VP, _I, _VP, _VP)


def finalize_shard_count_plain(blk, kid, slot_subj, slot_kid, subj_row,
                               base_w: int, bound_lo: int, bound_hi: int):
    m, kid_m, ok = _shard_masked(blk, kid, slot_subj, slot_kid, subj_row,
                                 base_w)
    counts = _popcount_u32(m).sum(1, dtype=torch.int64)
    kb = torch.where(ok, _popcount_u32(kid_m).sum(1, dtype=torch.int64),
                     torch.zeros_like(ok, dtype=torch.int64))
    return _to_i32(counts), _to_i32(kb[bound_lo:bound_hi].sum())


def finalize_shard_count(blk, kid, slot_subj, slot_kid, subj_row,
                         base_w: int, bound_lo: int, bound_hi: int, counts,
                         bound):
    """K2's count pass on one mesh shard, whose word columns [base_w,
    base_w + wl) of the finalize span are blk (the packed result's) and
    kid (the kid table's): each slot's popcount of its masked words into
    counts i32[S] (None: a 'model' replica that only bounds), and the kid
    words' popcount of the slots in [bound_lo, bound_hi) into the 0-d
    bound (the out-cap bound's 'model' slot-block split). Writes and
    returns (counts, bound)."""
    if not blk.is_cuda:
        c, bd = finalize_shard_count_plain(blk, kid, slot_subj, slot_kid,
                                           subj_row, base_w, bound_lo,
                                           bound_hi)
        if counts is not None:
            counts.copy_(c)
        bound.copy_(bd)
        return counts, bound
    ext = _ext()
    _check_cuda(slot_subj, slot_kid, subj_row, bound,
                *((counts,) if counts is not None else ()))
    bound.zero_()
    ext.entry("finalize_csr", "fin_shard_count", _SHARD_COUNT_ARGS)(
        blk.data_ptr(), _rows_view(blk, "finalize_shard_count"),
        blk.shape[0], kid.data_ptr(),
        _rows_view(kid, "finalize_shard_count"), kid.shape[0], kid.shape[1],
        base_w, slot_subj.data_ptr(), slot_kid.data_ptr(),
        slot_subj.shape[0], subj_row.data_ptr(),
        counts.data_ptr() if counts is not None else None, bound.data_ptr(),
        bound_lo, bound_hi, ext.raw_stream(blk.device.index))
    LAUNCHES["finalize_shard"] += 1
    return counts, bound


def finalize_shard_compact_plain(blk, kid, slot_subj, slot_kid, subj_row,
                                 base_w: int, seg_base, out_cap: int):
    m, _, _ = _shard_masked(blk, kid, slot_subj, slot_kid, subj_row, base_w)
    bits = _unpack_bits(m)                                 # [S, wl * 32]
    rank = torch.cumsum(bits.to(torch.int64), 1) - bits.to(torch.int64)
    pos = seg_base.to(torch.int64)[:, None] + rank
    rows = base_w * 32 + torch.arange(bits.shape[1], device=m.device)
    keep = bits & (pos >= 0) & (pos < out_cap)
    frag = torch.zeros(out_cap, dtype=torch.int32, device=m.device)
    frag[pos[keep]] = rows.expand_as(pos)[keep].to(torch.int32)
    return frag


def finalize_shard_compact(blk, kid, slot_subj, slot_kid, subj_row,
                           base_w: int, seg_base, out_cap: int, frag=None):
    """K2's compaction on one mesh shard: every set bit of a slot's masked
    words, as row (base_w + word) * 32 + bit, at seg_base[slot] + its rank
    in the slot's words, into the shard's fragment i32[out_cap] (zero
    elsewhere: positions >= out_cap drop, and the fragments merge by a
    sum)."""
    dev = blk.device
    if frag is None:
        frag = torch.empty(out_cap, dtype=torch.int32, device=dev)
    if not blk.is_cuda:
        frag.copy_(finalize_shard_compact_plain(
            blk, kid, slot_subj, slot_kid, subj_row, base_w, seg_base,
            out_cap))
        return frag
    ext = _ext()
    _check_cuda(slot_subj, slot_kid, subj_row, seg_base, frag)
    ext.entry("finalize_csr", "fin_shard_compact", _SHARD_COMPACT_ARGS)(
        blk.data_ptr(), _rows_view(blk, "finalize_shard_compact"),
        blk.shape[0], kid.data_ptr(),
        _rows_view(kid, "finalize_shard_compact"), kid.shape[0],
        kid.shape[1], base_w, slot_subj.data_ptr(), slot_kid.data_ptr(),
        slot_subj.shape[0], subj_row.data_ptr(), seg_base.data_ptr(),
        out_cap, frag.data_ptr(), ext.raw_stream(blk.device.index))
    LAUNCHES["finalize_shard"] += 1
    return frag


def deps_matrix_shard(subj_words, subj_before, subj_kinds, act_words,
                      act_ts, act_kinds, act_valid, witness_table, out):
    """K18 on one mesh shard: a row block of subjects against every active
    row, on one 'model' word slice of both bitmaps (read in place through
    their row strides) -> bool [B_l, A] written to `out`."""
    if not subj_words.is_cuda:
        out.copy_(deps_matrix_plain(subj_words, subj_before, subj_kinds,
                                    act_words, act_ts, act_kinds, act_valid,
                                    witness_table))
        return out
    b, kw = subj_words.shape
    a = act_words.shape[0]
    sws = _rows_view(subj_words, "deps_matrix_shard")
    aws = _rows_view(act_words, "deps_matrix_shard")
    if (act_words.shape[1] != kw or tuple(out.shape) != (b, a)
            or out.dtype != torch.bool or act_valid.dtype != torch.bool):
        raise ValueError("deps_matrix_shard: word slices of one width, "
                         "valid bool[A], out bool[B_l, A]")
    ext = _ext()
    _check_cuda(subj_before, subj_kinds, act_ts, act_kinds, act_valid,
                witness_table, out)
    n0, n1 = witness_table.shape
    ext.entry("dense_dag", "deps_matrix_strided", _DEPS_STRIDED_ARGS)(
        subj_words.data_ptr(), sws, subj_before.data_ptr(),
        subj_kinds.data_ptr(), act_words.data_ptr(), aws, act_ts.data_ptr(),
        act_kinds.data_ptr(), act_valid.data_ptr(), witness_table.data_ptr(),
        n0, n1, b, a, kw, out.data_ptr(), ext.raw_stream(out.device.index))
    LAUNCHES["deps_matrix_shard"] += 1
    return out


def pack_rows_plain(m: torch.Tensor) -> torch.Tensor:
    rows, n = m.shape
    nw = (n + 31) // 32
    pad = torch.zeros(rows, nw * 32, dtype=torch.bool, device=m.device)
    pad[:, :n] = m
    return _pack_bits(pad)


def pack_rows(m: torch.Tensor, out) -> torch.Tensor:
    """bool [rows, N] -> packed i32 [rows, ceil(N/32)] into `out` (a
    closure's row block as K19 reads it)."""
    if not m.is_cuda:
        out.copy_(pack_rows_plain(m))
        return out
    rows, n = m.shape
    if (m.dtype != torch.bool or out.dtype != torch.int32
            or tuple(out.shape) != (rows, (n + 31) // 32)):
        raise ValueError("pack_rows: bool [rows, N] into i32 "
                         "[rows, ceil(N/32)]")
    ext = _ext()
    _check_cuda(m, out)
    ext.entry("dense_dag", "pack_rows", (_VP, _I, _I, _VP, _VP))(
        m.data_ptr(), rows, n, out.data_ptr(), ext.raw_stream(m.device.index))
    LAUNCHES["pack_rows"] += 1
    return out


def closure_rows_plain(full: torch.Tensor, n: int, row0: int, nrows: int):
    r = _unpack_bits(full)[:, :n]
    rows = r[row0:row0 + nrows]
    sq = (rows.to(torch.float32) @ r.to(torch.float32)) > 0.5
    return pack_rows_plain(rows | sq)


def closure_rows(full, n: int, row0: int, nrows: int, out):
    """One Jacobi round of K19 on a row block: rows [row0, row0 + nrows)
    of R | (R @ R > 0.5), R the gathered packed matrix full i32[N, N/32]
    -> packed i32 [nrows, N/32] in `out`."""
    if not full.is_cuda:
        out.copy_(closure_rows_plain(full, n, row0, nrows))
        return out
    ext = _ext()
    nw = (n + 31) // 32
    if (tuple(full.shape) != (n, nw) or tuple(out.shape) != (nrows, nw)
            or full.dtype != torch.int32 or out.dtype != torch.int32):
        raise ValueError("closure_rows: packed full i32[N, ceil(N/32)], "
                         "out i32[nrows, ceil(N/32)]")
    if row0 < 0 or row0 + nrows > n:
        raise ValueError("closure_rows: rows outside [0, N)")
    _check_cuda(full, out)
    dev = full.device
    ext.entry("dense_dag", "closure_rows", _CLOSURE_ROWS_ARGS)(
        full.data_ptr(), n, row0, nrows, out.data_ptr(),
        zeroed_scratch(dev, _CLOSURE_FLAG_BYTES), ext.raw_stream(dev.index))
    LAUNCHES["closure_rows"] += 1
    return out


def wavefront_rows_plain(p_rows, levels, row0: int):
    n = levels.shape[0]
    adj = _unpack_bits(p_rows)[:, :n]
    zero = torch.zeros((), dtype=torch.int32, device=levels.device)
    dep = torch.where(adj, levels[None, :] + 1, zero)
    return torch.maximum(levels[row0:row0 + p_rows.shape[0]],
                         dep.max(dim=1).values)


def wavefront_rows(p_rows, levels, row0: int, out):
    """One round of K20 on a row block: level'[i] = max(level[i],
    max_j adj[i, j] * (level[j] + 1)) for the block's packed rows p_rows
    i32[nrows, N/32] (rows row0..), against the gathered levels i32[N]
    -> i32[nrows] in `out`."""
    if not p_rows.is_cuda:
        out.copy_(wavefront_rows_plain(p_rows, levels, row0))
        return out
    n = levels.shape[0]
    nrows = p_rows.shape[0]
    if (p_rows.shape[1] != (n + 31) // 32 or tuple(out.shape) != (nrows,)
            or levels.dtype != torch.int32 or out.dtype != torch.int32):
        raise ValueError("wavefront_rows: packed rows i32[nrows, "
                         "ceil(N/32)], levels i32[N], out i32[nrows]")
    ext = _ext()
    _check_cuda(p_rows, levels, out)
    ext.call("dense_dag", "wavefront_rows", _addr(p_rows), _addr(levels), n,
             row0, nrows, _addr(out), ext.stream())
    LAUNCHES["wavefront_rows"] += 1
    return out


def pad_to(x: np.ndarray, size: int, axis: int = 0) -> np.ndarray:
    """Pad axis up to `size` with zeros."""
    if x.shape[axis] == size:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, size - x.shape[axis])
    return np.pad(x, pad)


def bucket_size(n: int, minimum: int = 8) -> int:
    """Next power-of-two bucket >= n (>= minimum)."""
    return snap(n, (), minimum)


SUBJECT_TIERS = (8, 64, 128)


def subject_tier(n: int) -> int:
    """Padded subject-batch size for a dispatch of n subjects."""
    return snap(n, SUBJECT_TIERS, 256)


NNZ_TIERS = (32, 256, 2048)
SCATTER_NNZ_TIERS = (64, 512)


def nnz_tier(n: int) -> int:
    """Padded CSR entry count for a dispatch carrying n subject entries."""
    return snap(n, NNZ_TIERS, 4096)


def scatter_nnz_tier(n: int) -> int:
    """Padded CSR entry count for an arena-scatter chunk of n key entries."""
    return snap(n, SCATTER_NNZ_TIERS, 1024)


OUT_TIERS = (256, 2048, 16384)
OUT_TIER_FLOOR = 32768


def out_tier(n: int) -> int:
    """Padded finalized-CSR entry count for a dispatch with n bound hits."""
    return snap(n, OUT_TIERS, OUT_TIER_FLOOR)
