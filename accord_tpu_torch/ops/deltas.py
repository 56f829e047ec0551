"""Shared field-granular delta-upload helper.

Every device mirror in this codebase (the resolver's key/range arenas and
the exec plane's wait-graph arena) keeps authoritative host shadows and
ships only dirty rows to the device. For single-lane deltas (an exec-ts
bump, a valid flip, an applied/pending flag change) they all follow the
same shape discipline: sort the dirty rows, chunk them to the 8/64 row
tiers the generic `scatter_rows` kernel is warmed for, pad a short chunk
by repeating its first row (duplicate scatter indexes write identical
data, so double writes are harmless), and account the shipped bytes.

This module is that discipline, written once -- so the arena and the exec
plane cannot drift apart on chunking, padding, or accounting, and new jit
tiers cannot appear inside a bench's timed window because one caller chose
a different chunk bound. (Port: the scatter is the row_scatter CUDA kernel,
csrc/row_scatter.cu, on a CUDA lane; `src[idx]` is a fresh host array, so
the upload never aliases live host state. `flush_lanes` is a plane's
whole flush: the same chunks and accounting lane by lane, but each chunk
of every lane ships in ONE host-to-device copy and scatters in ONE K4
launch over the lane table.)
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from accord_tpu_torch.obs.trace import REC

# the warmable row tiers every lane delta chunks to (see kernels.scatter_rows
# and resolver.warmup)
LANE_ROW_TIERS = (8, 64)


def lane_row_tier(n: int) -> int:
    """Smallest warmed row tier holding `n` rows (n <= 64 by chunking)."""
    from accord_tpu_torch.ops.tiers import snap
    return snap(n, LANE_ROW_TIERS, LANE_ROW_TIERS[-1])


def _chunks(rows: Sequence[int], src: np.ndarray,
            on_chunk: Callable[[int, int], None]):
    """(idx, data) per chunk of a lane's dirty rows: tiers 8/64, a short
    chunk padded by its first row; accounted as each chunk is made."""
    out = []
    for lo in range(0, len(rows), LANE_ROW_TIERS[-1]):
        chunk = rows[lo:lo + LANE_ROW_TIERS[-1]]
        m = lane_row_tier(len(chunk))
        idx = np.full(m, chunk[0], dtype=np.int32)
        idx[:len(chunk)] = chunk
        data = src[idx]
        on_chunk(idx.nbytes + data.nbytes, m)
        if REC.enabled:
            # no node in scope here: the recorder's configured clock (sim
            # time under the cluster/maelstrom) timestamps the upload
            REC.instant(0, "deltas", "lane_upload", REC.now_us(),
                        args={"bytes": idx.nbytes + data.nbytes, "tier": m})
        out.append((idx, data))
    return out


def flush_lane(lane, rows: Sequence[int], src: np.ndarray,
               on_chunk: Callable[[int, int], None]):
    """Scatter `src[rows]` into the device array `lane` row-wise and return
    the updated lane. `rows` must be sorted dirty row indices; `src` is the
    host shadow the rows are gathered from (fancy indexing COPIES, so the
    async device computation never aliases live host state). `on_chunk`
    receives (uploaded_bytes, padded_row_tier) per chunk for the caller's
    upload accounting."""
    if not rows:
        return lane
    from accord_tpu_torch.ops.kernels import scatter_rows, upload
    for idx, data in _chunks(rows, src, on_chunk):
        lane = scatter_rows(lane, upload(idx, lane.device),
                            upload(data, lane.device))
    return lane


def flush_lanes(lanes) -> list:
    """flush_lane over a plane's lanes, each (lane, rows, src, on_chunk)
    as flush_lane takes them; returns the updated lanes in order. Every
    lane is chunked and accounted exactly as flush_lane would (so upload
    counters match it), lane by lane; then chunk k of every lane ships in
    ONE host-to-device copy and scatters in ONE launch of the lane table
    (up to kernels.LANE_TABLE_MAX lanes a launch)."""
    from accord_tpu_torch.ops.kernels import (LANE_TABLE_MAX, lane_table,
                                              upload_many)
    out = [spec[0] for spec in lanes]
    chunks = [_chunks(rows, src, on_chunk) if rows else []
              for _lane, rows, src, on_chunk in lanes]
    for k in range(max((len(c) for c in chunks), default=0)):
        have = [i for i, c in enumerate(chunks) if k < len(c)]
        for lo in range(0, len(have), LANE_TABLE_MAX):
            part = have[lo:lo + LANE_TABLE_MAX]
            staged = upload_many([a for i in part for a in chunks[i][k]],
                                 out[part[0]].device)
            new = lane_table([(out[i], staged[2 * j], staged[2 * j + 1])
                              for j, i in enumerate(part)])
            for i, lane in zip(part, new):
                out[i] = lane
    return out
