"""State carry-over: a JAX arena's lanes, as numpy arrays, into the port's
device lanes.

The reference arena (`_StoreArena.device_arrays()`) holds bucket bitmaps
as f32 [cap, K] 0/1 values; the port packs them to int32 [cap, K/32] words
(bucket 32j + i in bit i of word j), which is what its deps kernel tests
overlap against. The other lanes keep their types. The kid table
(`_StoreArena.kid_arrays()`, u32 [KC, cap/32]) becomes the same words as
int32 bit patterns. The range arena (`_RangeArena.device_arrays()`) keeps
its five lanes as they are; the reference's other 0/1 matrices -- the f32
subject bitmaps of `max_conflict`, the bf16 `covered_buckets` matrix, the
dense i32 hits of `_segment_compact` -- pack the same way as the arena
bitmaps, and so does a dense bool DAG adjacency (`packed_adjacency`,
dag_wavefronts_packed's layout). A JAX MailboxPlane's arena, meta arena
and partition mask become the port plane's tensors (`mailbox_state`).
The tests use this to feed one state to both implementations.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def pack_bitmaps(bitmaps: np.ndarray) -> np.ndarray:
    """[cap, K] 0/1 matrix (f32, bf16 or int; set where > 0.5) -> int32
    [cap, K/32]."""
    cap, k = bitmaps.shape
    if k % 32:
        raise ValueError(f"bucket count {k} is not a multiple of 32")
    bits = (np.asarray(bitmaps).astype(np.float32) > 0.5) \
        .reshape(cap, k // 32, 32)
    words = np.packbits(bits, axis=-1, bitorder="little")
    return np.ascontiguousarray(words).view("<u4").reshape(cap, k // 32) \
        .view(np.int32)


def words_to_i32(words: np.ndarray) -> np.ndarray:
    """u32 words -> the int32 array with the same bits."""
    return np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)


def arena_lanes(lanes: Sequence[np.ndarray], device="cpu") \
        -> Tuple[torch.Tensor, ...]:
    """(bitmaps f32[cap,K], ts i32[cap,3], exec_ts i32[cap,3],
    kinds i32[cap], valid bool[cap]) -> the port's five device lanes."""
    bm, ts, ex, kinds, valid = (np.asarray(a) for a in lanes)
    out = (pack_bitmaps(bm), ts.astype(np.int32), ex.astype(np.int32),
           kinds.astype(np.int32), valid.astype(bool))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in out)


def kid_table(kid_rows: np.ndarray, device="cpu") -> torch.Tensor:
    """u32 [KC, cap/32] -> int32 [KC, cap/32] bit patterns on `device`."""
    return torch.from_numpy(words_to_i32(kid_rows)).to(device)


def range_lanes(lanes: Sequence[np.ndarray], device="cpu") \
        -> Tuple[torch.Tensor, ...]:
    """(starts i32[rcap], ends i32[rcap], ts i32[rcap, 3], kinds i32[rcap],
    valid bool[rcap]) -> the port's five range lanes on `device`."""
    dtypes = (np.int32, np.int32, np.int32, np.int32, bool)
    return tuple(torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).astype(t))).to(device) for a, t in zip(lanes, dtypes))


def packed(matrix: np.ndarray, device="cpu") -> torch.Tensor:
    """A [n, K] 0/1 matrix -> its packed int32 [n, K/32] words on
    `device` (max_conflict's subject bitmaps, covered buckets, hits)."""
    return torch.from_numpy(pack_bitmaps(matrix)).to(device)


def mailbox_state(arena: np.ndarray, meta: np.ndarray, part: np.ndarray,
                  device="cpu") -> Tuple[torch.Tensor, ...]:
    """A JAX MailboxPlane's arena i32[(n+1)*depth, W], meta arena
    i32[rows, 3] and partition mask bool[n+1, n+1] (as numpy) -> the
    port's three tensors on `device` (MailboxPlane.arena, .meta, .part)."""
    dtypes = (np.int32, np.int32, bool)
    return tuple(torch.from_numpy(np.array(a, dtype=t)).to(device)
                 for a, t in zip((arena, meta, part), dtypes))


def packed_adjacency(adj: np.ndarray, device="cpu") -> torch.Tensor:
    """A dense bool adjacency [N, N] (row w depends on column d) -> int32
    [N, ceil(N/32)] words, column d in bit d & 31 of word d >> 5, the
    columns past N zero (dag_wavefronts_packed's layout)."""
    adj = np.asarray(adj, bool)
    n, m = adj.shape
    pad = np.zeros((n, -(-m // 32) * 32), bool)
    pad[:, :m] = adj
    return packed(pad, device)
