"""The key path's device kernels: CUDA wrappers and their plain versions.

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
  finalize_csr   csrc/finalize_csr.cu    finalize_csr :697 (body :736)
  arena_scatter  csrc/arena_scatter.cu   arena_scatter :822,
                                         arena_scatter_keys :840
  row_scatter    csrc/row_scatter.cu     scatter_rows :242,
                                         kid_word_scatter :250,
                                         arena_grow :864

Scatter indices follow jnp's `.at[]` rules: a negative index counts from
the end, and one still out of range is dropped (the padding sentinels B,
cap and KC), where torch's own indexing would raise.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from accord_tpu_torch.ops.tiers import snap

INT32_MIN = -(1 << 31)
_M32 = 0xFFFFFFFF

# launches per kernel (one per wrapper call that reached the card)
LAUNCHES: Dict[str, int] = {"deps_resolve": 0, "finalize_csr": 0,
                            "arena_scatter": 0, "row_scatter": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
def _subject_words(subj_of, subj_keys, b: int, k: int) -> torch.Tensor:
    """Packed subject bitmaps i32[B, K/32] from the subject CSR; entries
    out of range (pad subj_of == B) are dropped."""
    s, s_ok = _norm_index(subj_of, b)
    key, k_ok = _norm_index(subj_keys, k)
    ok = s_ok & k_ok
    bm = torch.zeros(b, k, dtype=torch.bool, device=subj_of.device)
    bm[s[ok], key[ok]] = True
    return _pack_bits(bm)


def _resolve_block_plain(subj_words, subj_before, subj_kinds, mine,
                         act_bm, act_ts, act_kinds, act_valid,
                         witness_table) -> torch.Tensor:
    b = subj_words.shape[0]
    cap = act_bm.shape[0]
    nk = witness_table.shape[0]
    sk = _gather_index(subj_kinds, nk)
    ak = _gather_index(act_kinds, nk)
    witness = witness_table[sk[:, None], ak[None, :]] == 1
    before = _lex_before(act_ts[None, :, :], subj_before[:, None, :])
    mask = witness & before & act_valid[None, :]
    if mine is not None:
        mask &= mine[:, None]
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


def _resolve_cuda(subj_of, subj_keys, subj_store, subj_before, subj_kinds,
                  slots, arenas, witness_table) -> torch.Tensor:
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
    words = torch.empty(b, nw, dtype=torch.int32, device=dev)
    st = ext.stream()
    ext.call("deps_resolve", "deps_subjects", ext.ptr(subj_of),
             ext.ptr(subj_keys), subj_of.shape[0], b, nw * 32,
             ext.ptr(words), st)
    wtot = sum(a[0].shape[0] // 32 for a in arenas)
    out = torch.empty(b, wtot, dtype=torch.int32, device=dev)
    off = 0
    for s, (bm, ts, kinds, valid) in enumerate(arenas):
        cap = bm.shape[0]
        if bm.shape[1] != nw:
            raise ValueError("arena blocks differ in bucket count")
        ext.call("deps_resolve", "deps_block", ext.ptr(words),
                 ext.ptr(subj_before), ext.ptr(subj_kinds),
                 ext.ptr(subj_store) if subj_store is not None
                 else ext.ctypes_null(),
                 ext.ptr(slots[s:s + 1]) if slots is not None
                 else ext.ctypes_null(), b,
                 ext.ptr(bm), ext.ptr(ts), ext.ptr(kinds), ext.ptr(valid),
                 cap, nw, ext.ptr(witness_table), witness_table.shape[0],
                 ext.ptr(out), wtot, off, st)
        off += cap // 32
    LAUNCHES["deps_resolve"] += 1
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


def _finalize_cuda(packed, word_off, kid_rows, slot_subj, slot_kid,
                   subj_row, act_ts, out_cap: int):
    ext = _ext()
    _check_cuda(packed, kid_rows, slot_subj, slot_kid, subj_row, act_ts)
    dev = packed.device
    b, wt = packed.shape
    kc, w = kid_rows.shape
    s = slot_subj.shape[0]
    off = _span_offset(packed, kid_rows, word_off)
    nblocks = max(1, int(ext.lib("finalize_csr").finalize_blocks(
        ext.ctypes.c_longlong(s * w))))
    indptr = torch.empty(s + 1, dtype=torch.int32, device=dev)
    dep_rows = torch.empty(out_cap, dtype=torch.int32, device=dev)
    dep_ts = torch.empty(out_cap, 3, dtype=torch.int32, device=dev)
    bound = torch.empty((), dtype=torch.int32, device=dev)
    csum = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(2, nblocks, dtype=torch.int32, device=dev)
    ext.call("finalize_csr", "finalize_csr", ext.ptr(packed), b, wt, off,
             ext.ptr(kid_rows), kc, w, ext.ptr(slot_subj),
             ext.ptr(slot_kid), s, ext.ptr(subj_row), ext.ptr(act_ts),
             out_cap, ext.ptr(indptr), ext.ptr(dep_rows), ext.ptr(dep_ts),
             ext.ptr(bound), ext.ptr(csum), ext.ptr(scratch[0]),
             ext.ptr(scratch[1]), ext.stream())
    LAUNCHES["finalize_csr"] += 1
    return indptr, dep_rows, dep_ts, bound, csum


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


def _arena_scatter_cuda(bitmaps, rows, key_rows, key_mods, lanes=None):
    ext = _ext()
    cap, nw = bitmaps.shape
    _check_cuda(bitmaps, rows, key_rows, key_mods,
                *(lanes if lanes is not None else ()))
    bm_out = torch.empty_like(bitmaps)
    null = ext.ctypes_null()
    if lanes is not None:
        ts, exec_ts, kinds, valid, ts_rows, exec_rows, kind_rows, \
            valid_rows = lanes
        outs = [torch.empty_like(t) for t in (ts, exec_ts, kinds, valid)]
        lane_ptrs = [ext.ptr(outs[0]), ext.ptr(ts), ext.ptr(outs[1]),
                     ext.ptr(exec_ts), ext.ptr(outs[2]), ext.ptr(kinds),
                     ext.ptr(outs[3]), ext.ptr(valid)]
        row_ptrs = [ext.ptr(ts_rows), ext.ptr(exec_rows),
                    ext.ptr(kind_rows), ext.ptr(valid_rows)]
    else:
        outs = []
        lane_ptrs = [null] * 8
        row_ptrs = [null] * 4
    ext.call("arena_scatter", "arena_scatter", ext.ptr(bm_out),
             ext.ptr(bitmaps), cap, nw, *lane_ptrs, ext.ptr(rows),
             rows.shape[0], ext.ptr(key_rows), ext.ptr(key_mods),
             key_rows.shape[0], *row_ptrs, int(lanes is not None),
             ext.stream())
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


# -- K4: scatter_rows / kid_word_scatter / arena_grow ------------------------
def scatter_rows(dst, idx, rows):
    """A fresh copy of dst with dst[idx[i]] = rows[i] (out of range
    dropped; duplicates carry identical data)."""
    if not dst.is_cuda:
        return _scatter_lane_plain(dst, idx, rows)
    ext = _ext()
    _check_cuda(dst, idx, rows)
    if rows.dtype != dst.dtype or rows.shape[1:] != dst.shape[1:]:
        raise ValueError("scatter_rows: rows must match dst's row shape "
                         "and dtype")
    out = torch.empty_like(dst)
    n = dst.shape[0]
    row_bytes = dst.element_size() * (dst.numel() // max(n, 1))
    ext.call("row_scatter", "row_scatter", ext.ptr(out), ext.ptr(dst), n,
             row_bytes, ext.ptr(idx), idx.shape[0], ext.ptr(rows),
             ext.stream())
    LAUNCHES["row_scatter"] += 1
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
    ext = _ext()
    _check_cuda(kid_rows, kid_idx, word_idx, words)
    out = torch.empty_like(kid_rows)
    kc, w = kid_rows.shape
    ext.call("row_scatter", "word_scatter2d", ext.ptr(out),
             ext.ptr(kid_rows), kc, w, ext.ptr(kid_idx), ext.ptr(word_idx),
             ext.ptr(words), kid_idx.shape[0], ext.stream())
    LAUNCHES["row_scatter"] += 1
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
    exec_ts, False for valid."""
    if not bitmaps.is_cuda:
        return arena_grow_plain(bitmaps, ts, exec_ts, kinds, valid, new_cap)
    ext = _ext()
    _check_cuda(bitmaps, ts, exec_ts, kinds, valid)
    out = []
    st = ext.stream()
    for a, fill in zip((bitmaps, ts, exec_ts, kinds, valid), _GROW_FILL):
        per_row = a.numel() // max(a.shape[0], 1)
        dst = torch.empty((new_cap, *a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        entry = "grow_u8" if a.element_size() == 1 else "grow_u32"
        if a.element_size() not in (1, 4):
            raise ValueError(f"arena_grow: unsupported lane {a.dtype}")
        ext.call("row_scatter", entry, ext.ptr(dst),
                 ext.ctypes.c_longlong(new_cap * per_row), ext.ptr(a),
                 ext.ctypes.c_longlong(a.numel()), fill, st)
        out.append(dst)
    LAUNCHES["row_scatter"] += 1
    return tuple(out)


# -- padded-size ladders (the JAX package's tiers, kept for bit-equal
#    shapes: the same dispatches pad to the same sizes) ----------------------
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
