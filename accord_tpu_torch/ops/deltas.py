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
the upload never aliases live host state.)
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
        lane = scatter_rows(lane, upload(idx, lane.device),
                            upload(data, lane.device))
    return lane
