"""Device mailbox arena: replica traffic as a routing stage in protocol_tick.

The port's counterpart of the JAX package's `ops/mailbox.py`. Each node
lane owns a bounded ring of `depth` slots x `words` int32 payload words in
one flat arena of shape [(n+1)*depth, words] (rows 0..depth-1 are the
unused node-0 lane, matching the 1-based node ids of
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

Sharded meshes (`shards > 1`, the layout of the sharded protocol
megakernel, parallel/mesh.sharded_protocol_tick): the node lanes pad up so
shard boundaries fall on node boundaries (node v lives on shard v // npsh,
npsh = ceil((n+1) / shards)), the arena and the partition mask shard
node-major over the mesh's 'data' axis, and the emit lanes stage GROUPED
by (src shard, dst shard): segment (s, t) of the flat lane arrays holds the
lanes shard s emits toward shard t, and each entry's landed copy comes back
receiver-major at (t * shards + s) * bcap + j. K23 `sharded_mailbox_route`
(csrc/mailbox_shard.cu) routes them: the land decision on the source
shard, the segment moved to its destination, the scatter and gather-back
there. When every shard is on one device the plane keeps one node-major
arena there (shard t's rows a view); with a device per shard (`device` a
list of the mesh's 'data'-shard cards) each shard's arena slice and its
rows of the partition mask live on its card. shards == 1 is the exact
single-device layout.
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


# -- K23: the cross-shard routing stage ----------------------------------------
def shard_parts(x, shards: int) -> list:
    """A sharded plane's per-shard tensors: the entries of a per-card tuple,
    or `shards` equal row blocks (views) of one node-major tensor."""
    if isinstance(x, (tuple, list)):
        return list(x)
    rows = x.shape[0] // shards
    return [x[t * rows:(t + 1) * rows] for t in range(shards)]


def check_shard_mail_lanes(shards: int, mailbox) -> tuple:
    """A sharded mailbox block (arena, meta, e_src, e_dst, e_slot, e_keep,
    e_kind, e_seq, e_words, part), arena/meta/part either node-major
    tensors or tuples of `shards` per-shard tensors -> (lanes L, words W,
    rows_l, npsh, rows_nodes, bcap); raises ValueError on any other shape
    or dtype."""
    if not isinstance(mailbox, (tuple, list)) or len(mailbox) != 10:
        raise ValueError("mailbox: a block is (arena, meta, e_src, e_dst, "
                         "e_slot, e_keep, e_kind, e_seq, e_words, part)")
    arena, meta, src, dst, slot, keep, kind, seq, words, part = mailbox
    S = int(shards)
    dt = K._dtype_name
    try:
        ar, mt, pt = (shard_parts(x, S) for x in (arena, meta, part))
    except (AttributeError, ZeroDivisionError) as e:
        raise ValueError(f"mailbox: sharded planes ({e})") from None
    lanes = src.shape[0]
    if S < 1 or len(ar) != S or len(mt) != S or len(pt) != S \
            or lanes % (S * S):
        raise ValueError(f"mailbox: {S} shards need {S} arena, meta and "
                         "partition slices and S*S*bcap emit lanes")
    rows_l, w = ar[0].shape
    npsh, rows_nodes = pt[0].shape
    if (npsh == 0 or rows_nodes != npsh * S or rows_l % npsh
            or any(tuple(a.shape) != (rows_l, w) for a in ar)
            or any(tuple(m.shape) != (rows_l, 3) for m in mt)
            or any(tuple(p.shape) != (npsh, rows_nodes) for p in pt)
            or any(tuple(x.shape) != (lanes,)
                   for x in (dst, slot, keep, kind, seq))
            or tuple(words.shape) != (lanes, w)
            or dt(keep) != "bool" or any(dt(p) != "bool" for p in pt)
            or any(dt(x) != "int32" for x in (*ar, *mt, src, dst, slot,
                                               kind, seq, words))):
        raise ValueError("mailbox: sharded arena i32[shards*npsh*depth, W], "
                         "meta i32[rows, 3], part bool[rows_nodes, "
                         "rows_nodes] (or per-shard slices), emit lanes "
                         "i32[S*S*bcap] (keep bool) and words i32[L, W]")
    return lanes, w, rows_l, npsh, rows_nodes, lanes // (S * S)


def _recv_order(shards: int, bcap: int, dev) -> torch.Tensor:
    """The exchange as an index: receiver-major position p = (t * S + s) *
    bcap + j reads send position q = (s * S + t) * bcap + j."""
    S = shards
    p = torch.arange(S * S * bcap, device=dev)
    t, r = p // (S * bcap), p % (S * bcap)
    s, j = r // bcap, r % bcap
    return (s * S + t) * bcap + j


def sharded_mailbox_route_plain(shards, arena_l, meta_l, e_src, e_dst,
                                e_slot, e_keep, e_kind, e_seq, e_words,
                                part_l):
    """The reference's _sharded_mailbox_route_part over every 'data' shard,
    updating each shard's arena and meta slice IN PLACE. arena_l / meta_l /
    part_l: the per-shard slices (arena i32[npsh*depth, W], part
    bool[npsh, rows_nodes]); emit lanes flat [S*S*bcap], segment (s, t)
    the lanes shard s emits toward shard t. Shard s decides land = keep &
    ~part_l[s][clip(src - s*npsh, 0, npsh-1), dst] (the column gather wraps
    once, then clamps); the all_to_all hands segment (s, t) to shard t,
    which scatters each landed lane at (dst - t*npsh)*depth + slot when
    that node is its own (.at[] rules: drop what is out of range), then
    gathers back arena[min(flat, rows_l - 1)] -- the LOCAL last row for a
    lane that did not land. -> (arena_l, meta_l, landed_words,
    landed_meta, land), the last three receiver-major."""
    S = int(shards)
    npsh, rows_nodes = part_l[0].shape
    rows_l = arena_l[0].shape[0]
    depth = rows_l // npsh
    L = e_src.shape[0]
    bcap = L // (S * S)
    land_send = torch.empty(L, dtype=torch.bool, device=e_src.device)
    for s in range(S):
        seg = slice(s * S * bcap, (s + 1) * S * bcap)
        loc = (e_src[seg] - s * npsh).clamp(0, npsh - 1).to(torch.int64)
        land_send[seg] = e_keep[seg] & ~part_l[s][
            loc, K._gather_index(e_dst[seg], rows_nodes)]
    q = _recv_order(S, bcap, e_src.device)
    landed = torch.empty_like(e_words)
    landed_meta = torch.empty(L, 3, dtype=torch.int32, device=e_src.device)
    land = land_send[q]
    for t in range(S):
        seg = slice(t * S * bcap, (t + 1) * S * bcap)
        qs = q[seg]
        r_src, r_dst, r_slot = e_src[qs], e_dst[qs], e_slot[qs]
        r_land = land[seg]
        loc = r_dst - t * npsh
        flat = torch.where(r_land & (loc >= 0) & (loc < npsh),
                           loc * depth + r_slot,
                           torch.full_like(r_dst, rows_l))
        idx, ok = K._norm_index(flat, rows_l)
        arena_l[t][idx[ok]] = e_words[qs][ok]
        meta_l[t][idx[ok]] = torch.stack([r_src, e_kind[qs], e_seq[qs]],
                                         1)[ok]
        back = K._gather_index(torch.clamp(flat, max=rows_l - 1), rows_l)
        landed[seg] = arena_l[t][back]
        landed_meta[seg] = meta_l[t][back]
    return arena_l, meta_l, landed, landed_meta, land


def launch_sharded_mailbox_route(ext, A, tab, planes, lanes, land_in, outs,
                                 dims, t0: int, nt: int) -> None:
    """K23's scatter + gather-back launch on device addresses (`A(x)`, see
    kernels._addr) for destination shards t0 .. t0+nt-1: the arena, meta
    and partition mask through `tab` (the sharded megakernel's graph) or,
    with tab None, as `planes`; lanes (e_src, e_dst, e_slot, e_keep,
    e_kind, e_seq, e_words); land_in (land flags gathered from the source
    cards) or None (decided here from the mask); outs (landed, landed_meta,
    land); dims check_shard_mail_lanes' plus shards."""
    L, W, rows_l, npsh, rows_nodes, bcap, S = dims
    ext.call("mailbox_shard", "mailbox_shard_route", A(tab),
             *(A(x) for x in (planes or (None, None, None))),
             *(A(x) for x in lanes), A(land_in), S, t0, nt, bcap, W, rows_l,
             npsh, rows_nodes, *(A(o) for o in outs), ext.stream())


def sharded_mailbox_route(shards, arena, meta, e_src, e_dst, e_slot, e_keep,
                          e_kind, e_seq, e_words, part):
    """K23: the cross-shard routing stage of the sharded protocol
    megakernel (see sharded_mailbox_route_plain for the contract). arena,
    meta and part are one node-major tensor each (every shard on one
    device: one scatter and one gather-back launch over all S*S*bcap
    positions, the exchange an index permutation) or tuples of per-shard
    tensors on the shards' cards (the land decision on each source card,
    its land segments peer-copied to the destinations, the scatter and
    gather-back on each destination card; the landed outputs stay per
    card, as tuples). Emit lanes may be numpy arrays; arena and meta update
    in place. -> (arena, meta, landed_words, landed_meta, land)."""
    S = int(shards)
    first = arena[0] if isinstance(arena, (tuple, list)) else arena
    if not first.is_cuda:
        lanes = tuple(K._host_lane(x, first.device) for x in (
            e_src, e_dst, e_slot, e_keep, e_kind, e_seq, e_words))
        check_shard_mail_lanes(S, (arena, meta, *lanes, part))
        out = sharded_mailbox_route_plain(
            S, shard_parts(arena, S), shard_parts(meta, S), *lanes,
            shard_parts(part, S))
        return (arena, meta) + out[2:]
    from accord_tpu_torch.ops.node_lane import _dev_lane
    ext = K._ext()
    if not isinstance(arena, (tuple, list)):
        dev = arena.device
        lanes = tuple(_dev_lane(x, dev) for x in (e_src, e_dst, e_slot,
                                                  e_keep, e_kind, e_seq,
                                                  e_words))
        dims = check_shard_mail_lanes(S, (arena, meta, *lanes, part)) + (S,)
        K._check_cuda(arena, meta, part, *lanes)
        L, W = dims[0], dims[1]
        outs = (torch.empty(L, W, dtype=torch.int32, device=dev),
                torch.empty(L, 3, dtype=torch.int32, device=dev),
                torch.empty(L, dtype=torch.bool, device=dev))
        launch_sharded_mailbox_route(ext, K._addr, None, (arena, meta, part),
                                     lanes, None, outs, dims, 0, S)
        K.LAUNCHES["sharded_mailbox_route"] += 1
        return (arena, meta) + outs
    # a card per shard: the lanes on every card, land on the sources
    devs = [a.device for a in arena]
    lanes_on = {d: tuple(_dev_lane(x, d) for x in (e_src, e_dst, e_slot,
                                                   e_keep, e_kind, e_seq,
                                                   e_words))
                for d in dict.fromkeys(devs)}
    dims = check_shard_mail_lanes(
        S, (arena, meta, *lanes_on[devs[0]], part)) + (S,)
    L, W, rows_l, npsh, rows_nodes, bcap, _ = dims
    sends = []
    for s in range(S):
        ln = lanes_on[devs[s]]
        K._check_cuda(arena[s], meta[s], part[s], *ln)
        land_s = torch.empty(S * bcap, dtype=torch.bool, device=devs[s])
        with torch.cuda.device(devs[s]):
            ext.call("mailbox_shard", "mailbox_shard_land", K._addr(part[s]),
                     s, S, bcap, npsh, rows_nodes, K._addr(ln[0]),
                     K._addr(ln[1]), K._addr(ln[3]), K._addr(land_s),
                     ext.stream())
        sends.append(land_s)
    outs = []
    for t in range(S):
        d = devs[t]
        recv = torch.cat([sends[s][t * bcap:(t + 1) * bcap].to(d)
                          for s in range(S)])
        o = (torch.empty(S * bcap, W, dtype=torch.int32, device=d),
             torch.empty(S * bcap, 3, dtype=torch.int32, device=d),
             torch.empty(S * bcap, dtype=torch.bool, device=d))
        with torch.cuda.device(d):
            launch_sharded_mailbox_route(
                ext, K._addr, None, (arena[t], meta[t], part[t]),
                lanes_on[d], recv, o, dims, t, 1)
        outs.append(o)
    K.LAUNCHES["sharded_mailbox_route"] += 1
    return (arena, meta) + tuple(tuple(o[i] for o in outs) for i in range(3))


# -- the host-side plane ------------------------------------------------------
def nodes_device(nodes):
    """Where the tick engine's adopted deps resolvers keep their tensors:
    the mesh's 'data'-shard cards (a list) when a sharded resolver's mesh
    puts those shards on different cards, else the device of the first
    node (of a network's node map) whose resolver holds a witness table,
    else None (the card)."""
    for node in nodes.values():
        res = getattr(node, "_deps_resolver", None)
        mesh = getattr(res, "mesh", None)
        if mesh is not None:
            devs = [mesh.device(d, 0) for d in range(mesh.shape["data"])]
            if len(set(devs)) > 1:
                return devs
        table = getattr(res, "_table", None)
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
        self.n = int(num_nodes)
        self.depth = int(depth)
        self.words = int(words)
        # shards > 1: pad the node-lane count so shard boundaries fall on
        # node boundaries (node v -> shard v // npsh); shards == 1 keeps
        # rows_nodes == n + 1, the exact single-device layout
        self.shards = max(int(shards), 1)
        self.npsh = -(-(self.n + 1) // self.shards)
        self.rows_nodes = self.npsh * self.shards
        # a device list names each shard's card; one card (or a list of
        # one repeated device) keeps one node-major arena there
        self.shard_devices = None
        if isinstance(device, (list, tuple)):
            if len(device) != self.shards:
                raise ValueError(f"MailboxPlane: {len(device)} devices for "
                                 f"{self.shards} shards")
            devs = [_resolve_device(d, "MailboxPlane") for d in device]
            if len(set(devs)) > 1:
                self.shard_devices = tuple(devs)
            device = devs[0]
        self.device = _resolve_device(device, "MailboxPlane")
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
        if self.shard_devices is None:
            self.part = K.upload(mask, self.device)
        else:
            # each shard's rows beside its arena slice
            p = self.npsh
            self.part = tuple(K.upload(mask[s * p:(s + 1) * p], d)
                              for s, d in enumerate(self.shard_devices))
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
            self.arena = self._zeros(self.words)
            self.meta = self._zeros(3)
        if self.part is None:
            self.set_partitions((), self.link_version or 0)
        # lanes stage grouped by (src shard, dst shard): segment (s, t) of
        # the flat arrays holds shard s's emits toward shard t, so the
        # sharded route delivers each segment whole. With shards == 1
        # there is one group and this is exactly the flat staging order.
        S, npsh = self.shards, self.npsh
        groups: Dict[tuple, list] = {}
        for ent in staged:
            e = ent[0]
            groups.setdefault((e.src // npsh, e.dst // npsh), []).append(ent)
        bcap = mega_lane_tier(max(len(g) for g in groups.values()))
        cap = S * S * bcap
        e_src = np.zeros(cap, np.int32)
        e_dst = np.zeros(cap, np.int32)
        e_slot = np.zeros(cap, np.int32)
        e_keep = np.zeros(cap, bool)
        e_kind = np.zeros(cap, np.int32)
        e_seq = np.zeros(cap, np.int32)
        e_words = np.zeros((cap, self.words), np.int32)
        batch = _Batch()
        for (s, t), ents in groups.items():
            for j, (e, idx, w) in enumerate(ents):
                pos = (s * S + t) * bcap + j
                # the landed block comes back receiver-major (identity for
                # shards == 1): the entry's return position swaps s and t
                e.slot = (batch, (t * S + s) * bcap + j, e.dst, idx)
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

    def _zeros(self, width: int):
        """A zeroed node-major arena of `width` int32 columns: one tensor,
        or one slice per shard on its card."""
        if self.shard_devices is None:
            return torch.zeros((self.rows_nodes * self.depth, width),
                               dtype=torch.int32, device=self.device)
        return tuple(torch.zeros((self.npsh * self.depth, width),
                                 dtype=torch.int32, device=d)
                     for d in self.shard_devices)

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
            # one host transfer per batch (per shard with a card each)
            batch.host = tuple(
                np.concatenate([p.cpu().numpy() for p in t])
                if isinstance(t, tuple) else t.cpu().numpy()
                for t in batch.outs)
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
