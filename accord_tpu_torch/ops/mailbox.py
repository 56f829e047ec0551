"""Device mailbox arena: replica traffic as a routing stage in protocol_tick.

The port's counterpart of the JAX package's `ops/mailbox.py`, single-device
layout only. Each node lane owns a bounded ring of `depth` slots x `words`
int32 payload words in one flat arena of shape [(n+1)*depth, words] (rows
0..depth-1 are the unused node-0 lane, matching the 1-based node ids of
every other lane family). A parallel meta arena [(n+1)*depth, 3] carries
(src, kind, seq) per slot: kind is the interned message-class id, seq the
message's queue ticket, so delivery can verify provenance and ordering.

Message flow per cluster tick:

  emit    -- DeviceMessageNetwork.mailbox_flush() packs every in-flight
             payload (sim/wire bytes, word 0 = byte length header) into
             emit lanes padded to a MEGA_LANE_TIERS tier, allocating one
             slot in the destination's ring (lowest-free-first);
  route   -- K17 `mailbox_route` (csrc/mailbox_route.cu), a stage of the
             protocol megakernel (kernels.protocol_tick, ops/tick_graph.py),
             lands each kept emit at row dst*depth+slot unless the
             partition mask cuts the (src, dst) link, IN PLACE in the
             plane's arena (the plane is its only owner), then gathers the
             landed words + meta back so the host can verify without
             copying the whole arena;
  drain   -- deliveries read the gathered copy via read_landed(), compare
             it against the staged host bytes, and fall back to the host
             copy on any mismatch -- the device path degrades, never
             diverges.

An emit whose payload exceeds the slot width or whose destination ring is
full keeps its host bytes and bumps `mailbox_overflow_spills`.

The arena, the meta arena and the partition mask live on the plane's
device (None: the card, raising without one; "cpu": the plain version);
the emit lanes stay numpy, as protocol_tick's other host lanes do.
`shards > 1` (the JAX package's node-major sharded layout) is not ported:
ROADMAP queue 1 item 4.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from accord_tpu_torch.ops import kernels as K
from accord_tpu_torch.ops.tiers import mega_lane_tier


def pack_words(payload: bytes, width: int) -> Optional[np.ndarray]:
    """Encode payload bytes as [width] int32: word 0 the byte length, the
    rest the zero-padded little-words of the payload. None when the payload
    cannot fit (caller spills to the host path)."""
    if len(payload) > 4 * (width - 1):
        return None
    w = np.zeros(width, np.int32)
    w[0] = len(payload)
    if payload:
        buf = payload + b"\0" * (-len(payload) % 4)
        arr = np.frombuffer(buf, np.int32)
        w[1:1 + arr.size] = arr
    return w


def unpack_words(w: np.ndarray) -> bytes:
    """Inverse of pack_words: header-length bytes out of the word lanes."""
    n = int(w[0])
    return np.ascontiguousarray(w[1:1 + (n + 3) // 4],
                                np.int32).tobytes()[:n]


# -- K17: the routing stage --------------------------------------------------
def check_mail_lanes(mailbox) -> tuple:
    """A mailbox block (arena, meta, e_src, e_dst, e_slot, e_keep, e_kind,
    e_seq, e_words, part; lanes tensors or numpy arrays) -> (lanes L,
    words W, rows, node lanes n1); raises ValueError on any other shape or
    dtype."""
    if not isinstance(mailbox, (tuple, list)) or len(mailbox) != 10:
        raise ValueError("mailbox: a block is (arena, meta, e_src, e_dst, "
                         "e_slot, e_keep, e_kind, e_seq, e_words, part)")
    arena, meta, src, dst, slot, keep, kind, seq, words, part = mailbox
    rows, w = arena.shape
    n1 = part.shape[0]
    lanes = src.shape[0]
    dt = K._dtype_name
    if (tuple(meta.shape) != (rows, 3) or tuple(part.shape) != (n1, n1)
            or n1 == 0 or rows % n1
            or any(tuple(x.shape) != (lanes,)
                   for x in (dst, slot, keep, kind, seq))
            or tuple(words.shape) != (lanes, w)
            or dt(keep) != "bool" or dt(part) != "bool"
            or any(dt(x) != "int32" for x in (arena, meta, src, dst, slot,
                                               kind, seq, words))):
        raise ValueError("mailbox: arena i32[(n+1)*depth, W], meta "
                         "i32[rows, 3], part bool[n+1, n+1], emit lanes "
                         "i32[L] (keep bool[L]) and words i32[L, W]")
    return lanes, w, rows, n1


def mailbox_route_plain(arena, meta, e_src, e_dst, e_slot, e_keep, e_kind,
                        e_seq, e_words, part):
    """The reference's _mailbox_route_body, updating arena and meta IN
    PLACE. land = keep & ~part[src, dst] (gather rules: a negative index
    wraps once, then clamps); a landed emit writes its words and (src,
    kind, seq) to row dst*depth + slot, every other one targets row `rows`
    and drops (`.at[]` rules); then arena[min(flat, rows-1)] and its meta
    are gathered back, after the scatter. -> (arena, meta, landed_words,
    landed_meta, land)."""
    rows = arena.shape[0]
    n1 = part.shape[0]
    depth = rows // n1
    land = e_keep & ~part[K._gather_index(e_src, n1),
                          K._gather_index(e_dst, n1)]
    flat = torch.where(land, e_dst * depth + e_slot,
                       torch.full_like(e_dst, rows))
    idx, ok = K._norm_index(flat, rows)
    arena[idx[ok]] = e_words[ok]
    meta[idx[ok]] = torch.stack([e_src, e_kind, e_seq], 1)[ok]
    back = K._gather_index(torch.minimum(flat, torch.full_like(flat,
                                                               rows - 1)),
                           rows)
    return arena, meta, arena[back], meta[back], land


def launch_mailbox_route(ext, A, tab, planes, lanes, outs, dims) -> None:
    """K17's launch on device addresses (`A(x)`, see kernels._addr): the
    arena, meta and partition mask either through `tab` (int64 words read
    on the device: the protocol megakernel's graph) or, with tab None, as
    `planes` (the three tensors: mailbox_route); lanes (e_src, e_dst,
    e_slot, e_keep, e_kind, e_seq, e_words); outs (landed_words,
    landed_meta, land); dims (L, W, rows, n1). The scatter and the
    gather-back are two kernels in stream order, so every gather sees the
    whole tick's scatter."""
    ext.call("mailbox_route", "mailbox_route", A(tab),
             *(A(x) for x in (planes or (None, None, None))),
             *(A(x) for x in lanes), *dims, *(A(o) for o in outs),
             ext.stream())


def mailbox_route(arena, meta, e_src, e_dst, e_slot, e_keep, e_kind, e_seq,
                  e_words, part):
    """K17: the device message plane's routing stage on one device (see
    mailbox_route_plain for the contract). The emit lanes may be numpy
    arrays (MailboxPlane.stage_batch's); arena and meta update in place."""
    if not arena.is_cuda:
        return mailbox_route_plain(arena, meta, *(
            K._host_lane(x, arena.device) for x in (
                e_src, e_dst, e_slot, e_keep, e_kind, e_seq, e_words)), part)
    from accord_tpu_torch.ops.node_lane import _dev_lane
    ext = K._ext()
    dev = arena.device
    lanes = tuple(_dev_lane(x, dev) for x in (e_src, e_dst, e_slot, e_keep,
                                              e_kind, e_seq, e_words))
    dims = check_mail_lanes((arena, meta, *lanes, part))
    K._check_cuda(arena, meta, part, *lanes)
    L, W = dims[0], dims[1]
    outs = (torch.empty(L, W, dtype=torch.int32, device=dev),
            torch.empty(L, 3, dtype=torch.int32, device=dev),
            torch.empty(L, dtype=torch.bool, device=dev))
    launch_mailbox_route(ext, K._addr, None, (arena, meta, part), lanes,
                         outs, dims)
    K.LAUNCHES["mailbox_route"] += 1
    return (arena, meta) + outs


# -- the host-side plane ------------------------------------------------------
def nodes_device(nodes) -> Optional[torch.device]:
    """The device of the deps resolvers the tick engine adopted: the first
    node (of a network's node map) whose resolver holds a witness table,
    else None (the card)."""
    for node in nodes.values():
        table = getattr(getattr(node, "_deps_resolver", None), "_table",
                        None)
        if isinstance(table, torch.Tensor):
            return table.device
    return None


class _Batch:
    """One flush's worth of landed device outputs, materialized host-side
    lazily (one transfer per launch, not per message). Entries reference
    their batch through slot tuples; the batch is garbage once the last of
    them delivers -- no explicit retirement needed."""

    __slots__ = ("outs", "host")

    def __init__(self):
        self.outs = None   # (landed, landed_meta, land) device tensors
        self.host = None   # same, as numpy, on first read


class MailboxPlane:
    """Host-side manager of the device mailbox arena: slot allocation per
    destination ring, emit-lane staging, partition-mask epochs, and the
    verify-on-read landing buffers."""

    def __init__(self, num_nodes: int, depth: int = 64, words: int = 384,
                 shards: int = 1, device=None):
        from accord_tpu_torch.ops.resolver import _resolve_device
        if int(shards) > 1:
            raise NotImplementedError(
                "MailboxPlane(shards > 1): the sharded mailbox layout is not "
                "ported yet -- ROADMAP queue 1 item 4")
        self.device = _resolve_device(device, "MailboxPlane")
        self.n = int(num_nodes)
        self.depth = int(depth)
        self.words = int(words)
        self.rows_nodes = self.n + 1
        self.arena = None       # device tensors, created on first stage
        self.meta = None
        self.part = None        # device partition mask for current epoch
        self.link_version: Optional[int] = None
        self._free: Dict[int, List[int]] = {}
        self._launched: Optional[_Batch] = None  # staged, awaiting adopt
        self.c: Dict[str, int] = {
            "mailbox_depth_high_water": 0,
            "mailbox_overflow_spills": 0,
            "mailbox_bytes_staged": 0,
            "mailbox_partition_epochs": 0,
        }

    # -- epoch config --------------------------------------------------------
    def set_partitions(self, partitioned, version: int) -> None:
        mask = np.zeros((self.rows_nodes, self.rows_nodes), bool)
        for pair in partitioned:
            a, b = tuple(pair)
            mask[a, b] = mask[b, a] = True
        self.part = K.upload(mask, self.device)
        self.link_version = version
        self.c["mailbox_partition_epochs"] += 1

    # -- staging -------------------------------------------------------------
    def stage_batch(self, entries):
        """Allocate a destination slot per entry (lowest-free-first, so the
        order is deterministic), pack payloads into emit lanes, and return
        the kernel-ready mailbox block -- or None when every entry spilled.
        Entries that cannot be slotted keep slot=None and deliver from
        their host bytes (counted as overflow spills)."""
        staged = []
        for e in entries:
            w = pack_words(e.payload, self.words)
            free = self._free.get(e.dst)
            if free is None:
                free = self._free[e.dst] = list(range(self.depth - 1, -1, -1))
            if w is None or not free:
                self.c["mailbox_overflow_spills"] += 1
                continue
            idx = free.pop()
            occupancy = self.depth - len(free)
            if occupancy > self.c["mailbox_depth_high_water"]:
                self.c["mailbox_depth_high_water"] = occupancy
            staged.append((e, idx, w))
        if not staged:
            return None
        if self.arena is None:
            rows = self.rows_nodes * self.depth
            self.arena = torch.zeros((rows, self.words), dtype=torch.int32,
                                     device=self.device)
            self.meta = torch.zeros((rows, 3), dtype=torch.int32,
                                    device=self.device)
        if self.part is None:
            self.set_partitions((), self.link_version or 0)
        cap = mega_lane_tier(len(staged))
        e_src = np.zeros(cap, np.int32)
        e_dst = np.zeros(cap, np.int32)
        e_slot = np.zeros(cap, np.int32)
        e_keep = np.zeros(cap, bool)
        e_kind = np.zeros(cap, np.int32)
        e_seq = np.zeros(cap, np.int32)
        e_words = np.zeros((cap, self.words), np.int32)
        batch = _Batch()
        for pos, (e, idx, w) in enumerate(staged):
            e.slot = (batch, pos, e.dst, idx)
            e_src[pos] = e.src
            e_dst[pos] = e.dst
            e_slot[pos] = idx
            e_keep[pos] = True
            e_kind[pos] = e.kind
            e_seq[pos] = e.ticket & 0x7FFFFFFF
            e_words[pos] = w
            self.c["mailbox_bytes_staged"] += len(e.payload)
        self._launched = batch
        return (self.arena, self.meta, e_src, e_dst, e_slot, e_keep,
                e_kind, e_seq, e_words, self.part)

    def adopt(self, outs) -> None:
        """Take the routing stage's outputs for the batch staged by the
        matching stage_batch call: the arena and meta (updated in place,
        so the same tensors) plus the landed gather the deliveries will
        verify against."""
        arena, meta, landed, landed_meta, land = outs
        self.arena = arena
        self.meta = meta
        if self._launched is not None:
            self._launched.outs = (landed, landed_meta, land)
            self._launched = None

    # -- delivery ------------------------------------------------------------
    def read_landed(self, entry) -> Optional[bytes]:
        """The device-routed copy of an entry's payload, or None when it
        never landed (partition mask, not yet launched) -- the caller then
        delivers the retained host bytes."""
        batch, pos, _dst, _idx = entry.slot
        if batch.host is None:
            if batch.outs is None:
                return None  # staged but its launch never adopted
            batch.host = tuple(t.cpu().numpy() for t in batch.outs)
            batch.outs = None
        words, meta, land = batch.host
        if not bool(land[pos]):
            return None
        if int(meta[pos, 0]) != entry.src or int(meta[pos, 1]) != entry.kind \
                or int(meta[pos, 2]) != (entry.ticket & 0x7FFFFFFF):
            return None
        w = words[pos]
        from accord_tpu_torch.ops import fault_plane as _fp
        if _fp.ACTIVE is not None:
            w = np.array(w)  # corrupt a local copy, never the batch buffer
            if not _fp.ACTIVE.corrupt_mailbox(w):
                w = words[pos]
        return unpack_words(w)

    def release(self, slot) -> None:
        """Free a delivered entry's ring slot (LIFO reuse keeps allocation
        deterministic)."""
        _batch, _pos, dst, idx = slot
        self._free[dst].append(idx)

    def counters(self) -> Dict[str, int]:
        return dict(self.c)
