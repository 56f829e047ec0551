"""The port's device mesh and the sharded deps data plane: the counterpart
of the JAX package's `parallel/mesh.py` for its sharded resolves
(`sharded_deps_resolve` :170, `sharded_range_deps_resolve` :256,
`sharded_fused_deps_resolve` :400, `sharded_fused_range_deps_resolve`
:441), the sharded finalize (`sharded_finalize_csr` :663, body :524), the
unfused sharded node tick (`sharded_node_tick` :490), the graft dry-run
step (`sharded_deps_step` :89) and the sharded protocol megakernel
(`sharded_protocol_tick` :821, builder :683, `warmup_sharded` :865).

A single-controller mesh, as the reference's: one Python process drives a
(data, model) grid of torch devices. `make_mesh()` takes every visible
card; a device list may repeat one device, as the reference's tests use 8
virtual CPU devices, so `make_mesh(devices=["cpu"] * 8)` is the tests'
data 4 x model 2 mesh and `make_mesh(devices=["cuda:0"] * 8)` runs the
same shards on one card, where every shard offset, the 'model' fold and
the fragment merge go through the kernels.

  'data'  arena rows: each shard answers its block of the node's active
          rows (and of a finalize span's word columns);
  'model' key buckets: each shard contracts its slice of the bucket words.

Each sharded call is a loop over the shards. A shard's work is a launch of
an existing kernel at shard-local offsets (ops/kernels.py's mesh-shard
wrappers: K1, K5, K2, K18-K20) on the shard's device, over views of the
consumer's arrays when the device is shared and copies of them otherwise.
A collective is "bring each shard's tensor to the consumer's device (a
no-op on a shared device, a peer copy between cards), then combine it with
a kernel": the combining steps below (K22, csrc/mesh_combine.cu) replace
the reference's psum, all_gather and concatenate. The consumer is
`mesh.device(0, 0)`, where the resolver keeps its arenas.

Word order equals row order only because every arena's capacity is a
multiple of 32 * data (so each shard's rows are whole words); the
entries check that on every call, since the arenas double between calls.
NCCL and meshes across hosts are a later item (ROADMAP).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from accord_tpu_torch.ops import kernels as tk
from accord_tpu_torch.ops.encoding import WITNESS_TABLE

AXES = ("data", "model")


def _device(x) -> torch.device:
    """A torch.device with a card's index made explicit ("cuda" is the
    current card), so equal devices compare equal."""
    dev = torch.device(x)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A (data, model) grid of torch devices; `devices[d][m]` runs shard
    (d, m). Hashable, so sharded entry points cache per mesh."""

    def __init__(self, devices: Sequence[Sequence]):
        rows = tuple(tuple(_device(x) for x in row) for row in devices)
        if not rows or not rows[0] \
                or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("Mesh: a non-empty rectangular grid of devices")
        self.devices = rows
        self.shape = dict(zip(AXES, (len(rows), len(rows[0]))))

    def device(self, d: int = 0, m: int = 0) -> torch.device:
        return self.devices[d][m]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, "
                f"model={self.shape['model']}, devices={self.devices})")


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """2D mesh ('data', 'model'); 'model' gets 2 when n is even and >= 4,
    else 1 (the reference's rule). With no `devices`, every visible card
    (the first `n_devices` of them); raises where there is none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible (pass devices=, e.g. "
                "['cpu'] * 8, for the plain versions)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices:
            devices = devices[:n_devices]
    devices = [_device(x) for x in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("make_mesh: no devices")
    model = 2 if n % 2 == 0 and n >= 4 else 1
    data = n // model
    return Mesh([devices[d * model:(d + 1) * model] for d in range(data)])


def mesh_supports_message_plane(mesh: Mesh) -> bool:
    """Whether the device mailbox plane may ride a sharded mesh: the
    reference's predicate (True). MailboxPlane(shards=data) lays the rings
    out node-major over the 'data' shards, and the sharded protocol
    megakernel routes them with K23 (ops/mailbox.sharded_mailbox_route)."""
    return True


def one_card(mesh: Mesh) -> bool:
    """Whether every shard of the mesh is on the same device."""
    return len({d for row in mesh.devices for d in row}) == 1


# -- moving shards' tensors ---------------------------------------------------
def _on(t, dev):
    """A shard's operand on its device: the tensor itself (a view) when
    the device is the same, else a copy; numpy host lanes upload."""
    if t is None:
        return None
    if isinstance(t, np.ndarray):
        return tk.upload(t, dev)
    return t if t.device == dev else t.to(dev)


def _dest(full: torch.Tensor, dev) -> torch.Tensor:
    """Where a shard on `dev` writes its part of `full` (a consumer-side
    buffer): `full` itself on a shared device, else a fresh tensor on
    `dev` that _land brings back."""
    if full.device == dev:
        return full
    return torch.empty(full.shape, dtype=full.dtype, device=dev)


def _land(full: torch.Tensor, part: torch.Tensor) -> None:
    """The collective's transfer: a shard's result into the consumer's
    buffer (nothing to move when the shard wrote it in place)."""
    if part is not full:
        full.copy_(part)


def _check_rows(what: str, n: int, data: int) -> None:
    if n % (32 * data):
        raise ValueError(f"{what}: {n} rows are not a multiple of 32 * "
                         f"data ({32 * data}), so word order would not "
                         "equal row order")


def _bucket_words(mesh: Mesh, nw: int, who: str) -> int:
    model = mesh.shape["model"]
    if nw % model:
        raise ValueError(f"{who}: {nw * 32} buckets do not split into "
                         f"{model} 'model' slices of whole words")
    return nw // model


# -- K22: the combining steps --------------------------------------------------
def _or_fold_model_plain(parts: torch.Tensor) -> torch.Tensor:
    """parts i32[data, model, B, wl] -> i32[B, data * wl]: the OR over
    'model', each data shard's words at its lane span."""
    data, model, b, wl = parts.shape
    folded = parts[:, 0]
    for m in range(1, model):
        folded = folded | parts[:, m]
    return folded.permute(1, 0, 2).reshape(b, data * wl)


def _or_fold_model(parts: torch.Tensor, out: torch.Tensor,
                   col: int = 0) -> torch.Tensor:
    """Replaces `psum(partial, 'model') > 0.5`: the 'model' partials of
    every data shard (32-bit words, i32[data, model, B, wl] on the
    consumer) OR-ed into out[:, col + d * wl ...]. Never a sum: the
    partials are packed bits."""
    data, model, b, wl = parts.shape
    if not parts.is_cuda:
        out[:, col:col + data * wl] = _or_fold_model_plain(parts)
        return out
    ext = tk._ext()
    tk._check_cuda(parts, out)
    ext.call("mesh_combine", "or_fold", ext.ptr(parts), data, model, b, wl,
             ext.ptr(out), out.shape[1], col, ext.stream())
    tk.LAUNCHES["or_fold"] += 1
    return out


def _concat_lane_blocks_plain(blocks: Sequence[torch.Tensor]):
    return torch.cat(list(blocks), dim=1)


def _concat_lane_blocks(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """The per-store packed blocks of a fused call, side by side on the
    lane axis in store order (the reference's :224; the blocks are already
    whole on the consumer, so no store's lanes interleave with
    another's)."""
    if len(blocks) == 1:
        return blocks[0]
    if not blocks[0].is_cuda:
        return _concat_lane_blocks_plain(blocks)
    ext = tk._ext()
    tk._check_cuda(*blocks)
    b = blocks[0].shape[0]
    out = torch.empty(b, sum(x.shape[1] for x in blocks), dtype=torch.int32,
                      device=blocks[0].device)
    segs = int(ext.lib("mesh_combine").lane_concat_segs())
    off = 0
    for lo in range(0, len(blocks), segs):
        chunk = blocks[lo:lo + segs]
        n = len(chunk)
        src = (ctypes.c_void_p * n)(*(x.data_ptr() for x in chunk))
        w = (ctypes.c_int * n)(*(x.shape[1] for x in chunk))
        offs = []
        for x in chunk:
            offs.append(off)
            off += x.shape[1]
        ext.call("mesh_combine", "lane_concat", n, src, w,
                 (ctypes.c_int * n)(*offs), b, ext.ptr(out), out.shape[1],
                 ext.stream())
        tk.LAUNCHES["lane_concat"] += 1
    return out


def _gather_counts_plain(counts: torch.Tensor, bounds: torch.Tensor):
    """(indptr i32[S+1], seg_base i32[data, S], bound i32) from the
    gathered per-shard slot counts i32[data, S] and bound partials."""
    data, s = counts.shape
    c64 = counts.to(torch.int64)
    col = c64.sum(0)
    indptr = torch.zeros(s + 1, dtype=torch.int64, device=counts.device)
    indptr[1:] = torch.cumsum(col, 0)
    below = torch.cumsum(c64, 0) - c64
    seg_base = indptr[None, :s] + below
    return (tk._to_i32(indptr), tk._to_i32(seg_base),
            tk._to_i32(bounds.to(torch.int64).sum()))


def _gather_counts(counts: torch.Tensor, bounds: torch.Tensor):
    """Replaces `all_gather(counts_l, 'data')` and the prefix sums of the
    reference's :609-616: the [data, S] counts the shards brought to the
    consumer -> (indptr, each shard's exclusive write base in every slot's
    segment, the bound summed over its per-shard partials)."""
    if not counts.is_cuda:
        return _gather_counts_plain(counts, bounds)
    ext = tk._ext()
    tk._check_cuda(counts, bounds)
    data, s = counts.shape
    dev = counts.device
    indptr = torch.empty(s + 1, dtype=torch.int32, device=dev)
    seg_base = torch.empty(data, s, dtype=torch.int32, device=dev)
    bound = torch.empty((), dtype=torch.int32, device=dev)
    ext.call("mesh_combine", "counts_scan", ext.ptr(counts), data, s,
             ext.ptr(bounds), bounds.numel(), ext.ptr(indptr),
             ext.ptr(seg_base), ext.ptr(bound), ext.stream())
    tk.LAUNCHES["counts_scan"] += 1
    return indptr, seg_base, bound


def _sum_merge_fragments_plain(frags, indptr, act_ts):
    dep_rows = tk._to_i32(frags.to(torch.int64).sum(0))
    dep_ts = act_ts[tk._gather_index(dep_rows, act_ts.shape[0])]
    return dep_rows, dep_ts, tk.csr_checksum(indptr, dep_rows, dep_ts)


def _sum_merge_fragments(frags: torch.Tensor, indptr: torch.Tensor,
                         act_ts: torch.Tensor):
    """The shards' disjoint dep_rows fragments i32[data, out_cap] summed
    (zeros elsewhere), dep_ts = act_ts[dep_rows], and the checksum folded
    over the merged (indptr, dep_rows, dep_ts) -> (dep_rows, dep_ts,
    csum)."""
    if not frags.is_cuda:
        return _sum_merge_fragments_plain(frags, indptr, act_ts)
    ext = tk._ext()
    tk._check_cuda(frags, indptr, act_ts)
    data, out_cap = frags.shape
    dev = frags.device
    dep_rows = torch.empty(out_cap, dtype=torch.int32, device=dev)
    dep_ts = torch.empty(out_cap, 3, dtype=torch.int32, device=dev)
    csum = torch.empty((), dtype=torch.int32, device=dev)
    acc = torch.empty(3, dtype=torch.int32, device=dev)
    ext.call("mesh_combine", "fragment_merge", ext.ptr(frags), data,
             out_cap, ext.ptr(act_ts), act_ts.shape[0], indptr.shape[0] - 1,
             ext.ptr(indptr), ext.ptr(dep_rows), ext.ptr(dep_ts),
             ext.ptr(csum), ext.ptr(acc), ext.stream())
    tk.LAUNCHES["fragment_merge"] += 1
    return dep_rows, dep_ts, csum


def _at(dev: torch.device):
    """A shard's launch context: its card current, so its kernels launch
    there on that card's current stream (nothing to set on the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _entry(mesh: Mesh, name: str, fn):
    """A sharded entry point, run with the consumer's card current (the
    combining steps launch there); the kernel launches its shards and
    combining steps made are added to tk.ENTRY_LAUNCHES[name]."""
    cons = mesh.device(0, 0)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        before = sum(tk.LAUNCHES.values())
        try:
            with _at(cons):
                return fn(*args, **kwargs)
        finally:
            tk.ENTRY_LAUNCHES[name] += sum(tk.LAUNCHES.values()) - before

    return call


# -- row 34: the sharded resolves ------------------------------------------------
def _key_blocks(mesh: Mesh, subj_of, subj_keys, subj_store, subj_before,
                subj_kinds, slots, arenas, table, gate=None,
                intervals=None) -> List[torch.Tensor]:
    """Per-store packed blocks [B, cap_s/32] on the consumer of key arenas
    sharded rows over 'data' and buckets over 'model'. Shard (d, m) runs
    K1 (or, with `intervals` = (iv_of, iv_start, iv_end) and `gate` =
    subj_is_range, K5's key side) on its rows' word slice; the 'model'
    partials OR-fold into each data shard's lane span."""
    data, model = mesh.shape["data"], mesh.shape["model"]
    cons = mesh.device(0, 0)
    b = subj_before.shape[0]
    nw = arenas[0][0].shape[1]
    nwl = _bucket_words(mesh, nw, "sharded resolve")
    k_total = nw * 32
    outs = []
    for s, (bm, ts, kinds, valid) in enumerate(arenas):
        cap = bm.shape[0]
        _check_rows("key arena", cap, data)
        if bm.shape[1] != nw:
            raise ValueError("arena blocks differ in bucket count")
        cl = cap // data
        parts = torch.empty(data, model, b, cl // 32, dtype=torch.int32,
                            device=cons)
        for d in range(data):
            rows = slice(d * cl, (d + 1) * cl)
            for m in range(model):
                dev = mesh.device(d, m)
                with _at(dev):
                    out = _dest(parts[d, m], dev)
                    slot = None if slots is None \
                        else _on(slots[s:s + 1], dev)
                    args = (_on(subj_store, dev), slot,
                            _on(subj_before, dev), _on(subj_kinds, dev))
                    bm_l = _on(bm[rows, m * nwl:(m + 1) * nwl], dev)
                    lanes = (_on(ts[rows], dev), _on(kinds[rows], dev),
                             _on(valid[rows], dev), _on(table, dev))
                    if intervals is None:
                        tk.deps_resolve_shard(
                            _on(subj_of, dev), _on(subj_keys, dev), *args,
                            bm_l, *lanes, k_total, m * nwl * 32, out)
                    else:
                        tk.range_key_shard(
                            *(_on(x, dev) for x in intervals), *args,
                            _on(gate, dev), bm_l, *lanes, k_total,
                            m * nwl * 32, out)
                _land(parts[d, m], out)
        blk = torch.empty(b, cap // 32, dtype=torch.int32, device=cons)
        outs.append(_or_fold_model(parts, blk))
    return outs


def _range_blocks(mesh: Mesh, iv_of, iv_start, iv_end, subj_store,
                  subj_before, subj_kinds, slots, rarenas,
                  table) -> List[torch.Tensor]:
    """Per-store packed blocks [B, rcap_s/32] on the consumer of range
    arenas sharded rows over 'data' (the interval compares have no bucket
    dimension, so 'model' replicas would repeat them: shard (d, 0)
    answers)."""
    data = mesh.shape["data"]
    cons = mesh.device(0, 0)
    b = subj_before.shape[0]
    outs = []
    for s, (r_start, r_end, r_ts, r_kinds, r_valid) in enumerate(rarenas):
        rcap = r_start.shape[0]
        _check_rows("range arena", rcap, data)
        rl = rcap // data
        out = torch.empty(b, rcap // 32, dtype=torch.int32, device=cons)
        for d in range(data):
            dev = mesh.device(d, 0)
            rows = slice(d * rl, (d + 1) * rl)
            if dev == cons:
                dst, col = out, d * rl // 32
            else:
                dst = torch.empty(b, rl // 32, dtype=torch.int32, device=dev)
                col = 0
            with _at(dev):
                tk.range_block_shard(
                    *(_on(x, dev) for x in (iv_of, iv_start, iv_end,
                                            subj_store)),
                    None if slots is None else _on(slots[s:s + 1], dev),
                    _on(subj_before, dev), _on(subj_kinds, dev),
                    *(_on(x[rows], dev) for x in (r_start, r_end, r_ts,
                                                  r_kinds, r_valid)),
                    _on(table, dev), dst, col)
            if dst is not out:
                out[:, d * rl // 32:(d + 1) * rl // 32] = dst
        outs.append(out)
    return outs


@functools.lru_cache(maxsize=8)
def sharded_deps_resolve(mesh: Mesh):
    """Mesh-sharded twin of kernels.deps_resolve: arena rows over 'data',
    key buckets over 'model' (the overlap OR-folds across it) -> the
    packed i32[B, cap/32] on the consumer, lane order equal to row order.
    Contracts: cap % (32 * data) == 0 and (K/32) % model == 0."""

    def call(subj_of, subj_keys, subj_before, subj_kinds, act_bm, act_ts,
             act_kinds, act_valid, table):
        return _key_blocks(mesh, subj_of, subj_keys, None, subj_before,
                           subj_kinds, None,
                           ((act_bm, act_ts, act_kinds, act_valid),),
                           table)[0]

    return _entry(mesh, "sharded_deps_resolve", call)


@functools.lru_cache(maxsize=8)
def sharded_range_deps_resolve(mesh: Mesh):
    """Mesh-sharded twin of kernels.range_deps_resolve: range-arena rows
    over 'data'; the key side contracts the subject intervals' covered
    buckets over 'model' against the key arena sharded like
    sharded_deps_resolve -> (rpacked, kpacked) on the consumer. Contracts:
    rcap and cap % (32 * data) == 0."""

    def call(iv_of, iv_start, iv_end, subj_before, subj_kinds, subj_is_range,
             r_start, r_end, r_ts, r_kinds, r_valid, k_bm, k_ts, k_kinds,
             k_valid, table):
        ivs = (iv_of, iv_start, iv_end)
        rp = _range_blocks(mesh, *ivs, None, subj_before, subj_kinds, None,
                           ((r_start, r_end, r_ts, r_kinds, r_valid),),
                           table)[0]
        kp = _key_blocks(mesh, None, None, None, subj_before, subj_kinds,
                         None, ((k_bm, k_ts, k_kinds, k_valid),), table,
                         gate=subj_is_range, intervals=ivs)[0]
        return rp, kp

    return _entry(mesh, "sharded_range_deps_resolve", call)


@functools.lru_cache(maxsize=32)
def sharded_fused_deps_resolve(mesh: Mesh, nstores: int):
    """Mesh-sharded twin of kernels.fused_deps_resolve: NSTORES arenas,
    each sharded like sharded_deps_resolve and answering only its slot's
    subjects; the per-store blocks concatenate after the shard loop, never
    interleaved across stores (_concat_lane_blocks)."""

    def call(subj_of, subj_keys, subj_store, subj_before, subj_kinds, slots,
             arenas, table):
        if len(arenas) != nstores:
            raise ValueError(f"sharded_fused_deps_resolve({nstores}) got "
                             f"{len(arenas)} arenas")
        return _concat_lane_blocks(_key_blocks(
            mesh, subj_of, subj_keys, subj_store, subj_before, subj_kinds,
            slots, arenas, table))

    return _entry(mesh, "sharded_fused_deps_resolve", call)


@functools.lru_cache(maxsize=32)
def sharded_fused_range_deps_resolve(mesh: Mesh, nr: int, nk: int):
    """Mesh-sharded twin of kernels.fused_range_deps_resolve: NR range
    arenas (rows over 'data') and NK key arenas (the covered-bucket test
    over 'model') in one call; per-store blocks concatenate after the
    shard loop. An empty side returns a (B, 0) buffer."""

    def call(iv_of, iv_start, iv_end, subj_store, subj_before, subj_kinds,
             subj_is_range, r_slots, rarenas, k_slots, karenas, table):
        if len(rarenas) != nr or len(karenas) != nk:
            raise ValueError(f"sharded_fused_range_deps_resolve({nr}, {nk})"
                             f" got {len(rarenas)}, {len(karenas)} arenas")
        cons = mesh.device(0, 0)
        b = subj_before.shape[0]
        ivs = (iv_of, iv_start, iv_end)
        empty = torch.zeros(b, 0, dtype=torch.int32, device=cons)
        rp = _concat_lane_blocks(_range_blocks(
            mesh, *ivs, subj_store, subj_before, subj_kinds, r_slots,
            rarenas, table)) if nr else empty
        kp = _concat_lane_blocks(_key_blocks(
            mesh, None, None, subj_store, subj_before, subj_kinds, k_slots,
            karenas, table, gate=subj_is_range, intervals=ivs)) \
            if nk else empty
        return rp, kp

    return _entry(mesh, "sharded_fused_range_deps_resolve", call)


def sharded_node_tick(mesh: Mesh, key_merge, range_merge, table):
    """Multi-device twin of the node-lane cluster tick (ops/node_lane.py):
    a whole cluster's merged key/range dispatches on the mesh. The merged
    inputs are a fused cross-store call with more blocks and a
    node-qualified slot space, so this runs the sharded fused entries at
    the merge's block count -- same layout, so the engine's per-plan span
    demux is unchanged. -> (packed, rpacked, kpacked), any of them None
    when that merge is absent."""
    cons = mesh.device(0, 0)
    packed = rpacked = kpacked = None
    if key_merge is not None and key_merge.blocks:
        km = key_merge
        kern = sharded_fused_deps_resolve(mesh, len(km.blocks))
        packed = kern(*(_on(x, cons) for x in (
            km.subj_of, km.subj_keys, km.subj_node, km.sb, km.sknd,
            km.slots)), km.blocks, table)
    if range_merge is not None \
            and (range_merge.r_blocks or range_merge.k_blocks):
        rm = range_merge
        kern = sharded_fused_range_deps_resolve(mesh, len(rm.r_blocks),
                                                len(rm.k_blocks))
        rpacked, kpacked = kern(
            *(_on(x, cons) for x in (rm.iv_of, rm.iv_s, rm.iv_e,
                                     rm.subj_node, rm.sb, rm.sknd, rm.srng,
                                     rm.r_slots)),
            rm.r_blocks, _on(rm.k_slots, cons), rm.k_blocks, table)
    return packed, rpacked, kpacked


# -- row 35a: the sharded finalize ---------------------------------------------
@functools.lru_cache(maxsize=8)
def sharded_finalize_csr(mesh: Mesh):
    """Mesh-sharded twin of kernels.finalize_csr: the compaction split over
    'data' word columns of the finalize span, bit-identical to K2's
    (indptr, dep_rows, dep_ts, bound, csum).

      1. shard (d, 0) popcounts its slots' masked words (K2's count pass,
         shard-global word indices for the self-bit clear); the out-cap
         bound's kid popcount splits over 'model' slot blocks when
         S % model == 0 (shard (d, m) bounds slots [m S/model, (m+1)
         S/model)), else shard (d, 0) bounds every slot -- integer sums,
         so either is exact;
      2. the counts gather to the consumer: indptr and each shard's write
         base in every slot's segment (K22 counts_scan);
      3. shard (d, 0) writes its set bits at those bases into its
         fragment, positions >= out_cap dropped (K2's compaction pass);
      4. the fragments sum-merge, dep_ts gathers and the checksum folds
         over the merged triple (K22 fragment_merge).
    Overflow keeps K2's contract: indptr[-1] > out_cap, the exact total
    taken from the counts. Contract: the span's words % data == 0."""
    data, model = mesh.shape["data"], mesh.shape["model"]
    cons = mesh.device(0, 0)

    def call(packed, word_off, kid_rows, slot_subj, slot_kid, subj_row,
             act_ts, out_cap: int):
        kc, w = kid_rows.shape
        if w % data:
            raise ValueError(f"sharded_finalize_csr: a span of {w} words "
                             f"does not split over data={data}")
        wl = w // data
        off = tk._span_offset(packed, kid_rows, word_off)
        s = slot_subj.shape[0]
        split = s % model == 0
        counts = torch.empty(data, s, dtype=torch.int32, device=cons)
        bounds = torch.zeros(data * model, dtype=torch.int32, device=cons)
        shard_in = {}
        for d in range(data):
            for m in range(model):
                if split:
                    lo, hi = m * (s // model), (m + 1) * (s // model)
                elif m == 0:
                    lo, hi = 0, s
                else:
                    continue
                dev = mesh.device(d, m)
                with _at(dev):
                    ins = (_on(packed[:, off + d * wl:off + (d + 1) * wl],
                               dev),
                           _on(kid_rows[:, d * wl:(d + 1) * wl], dev),
                           _on(slot_subj, dev), _on(slot_kid, dev),
                           _on(subj_row, dev))
                    if m == 0:
                        shard_in[d] = ins
                    c_out = _dest(counts[d], dev) if m == 0 else None
                    b_out = _dest(bounds[d * model + m], dev)
                    tk.finalize_shard_count(*ins, d * wl, lo, hi, c_out,
                                            b_out)
                if c_out is not None:
                    _land(counts[d], c_out)
                _land(bounds[d * model + m], b_out)
        indptr, seg_base, bound = _gather_counts(counts, bounds)
        frags = torch.empty(data, out_cap, dtype=torch.int32, device=cons)
        for d in range(data):
            dev = mesh.device(d, 0)
            with _at(dev):
                frag = _dest(frags[d], dev)
                tk.finalize_shard_compact(*shard_in[d], d * wl,
                                          _on(seg_base[d], dev), out_cap,
                                          frag)
            _land(frags[d], frag)
        dep_rows, dep_ts, csum = _sum_merge_fragments(frags, indptr, act_ts)
        return indptr, dep_rows, dep_ts, bound, csum

    return _entry(mesh, "sharded_finalize_csr", call)


# -- row 33: the graft dry-run step --------------------------------------------
def _gather_rows(mesh: Mesh, reps: dict, d: int, rows: slice) -> None:
    """all_gather over 'data' of one row block: shard d wrote it into its
    device's replica (reps[device]); every other device's replica takes a
    copy."""
    src = reps[mesh.device(d, 0)]
    for rep in reps.values():
        if rep is not src:
            rep[rows] = src[rows]


def _gathered_rounds(mesh: Mesh, reps: dict, nl: int, rounds: int,
                     shard_round) -> dict:
    """`rounds` Jacobi rounds over replicated arrays (one per data shard's
    device): data shard d writes its row block of the next round,
    shard_round(d, rows, this round's replica, destination), then the
    blocks all-gather."""
    data = mesh.shape["data"]
    for _ in range(rounds):
        nxt = {dev: torch.empty_like(t) for dev, t in reps.items()}
        for d in range(data):
            rows = slice(d * nl, (d + 1) * nl)
            dev = mesh.device(d, 0)
            with _at(dev):
                shard_round(d, rows, reps[dev], nxt[dev][rows])
        for d in range(data):
            _gather_rows(mesh, nxt, d, slice(d * nl, (d + 1) * nl))
        reps = nxt
    return reps


def sharded_deps_step(mesh: Mesh, closure_iters: int = 8):
    """The multi-device deps step -> step(words, ts, kinds, table) ->
    (deps bool[N, N], levels i32[N]) on the consumer.

      words  i32[N, K/32]  packed key bitmaps of the in-flight batch
      ts     i32[N, 3]     packed txn timestamps
      kinds  i32[N]
      table  i32[6, 6]     witness table
    Rows over 'data', bucket words over 'model': shard (d, m) runs K18 on
    its row block and word slice against every row's word slice, and the
    'model' partials OR-fold. Then exactly `closure_iters` Jacobi closure
    rounds (each data shard squares its packed row block against the
    gathered full matrix, K19's row entry) and `closure_iters` wavefront
    rounds over the gathered levels (K20's row entry). Contracts:
    N % data == 0 and (K/32) % model == 0."""
    data, model = mesh.shape["data"], mesh.shape["model"]
    cons = mesh.device(0, 0)
    iters = int(closure_iters)

    def step(words, ts, kinds, table):
        n, nw = words.shape
        if n % data:
            raise ValueError(f"sharded_deps_step: N={n} does not split "
                             f"over data={data}")
        if n % 4:
            raise ValueError("sharded_deps_step: N must be a multiple of 4 "
                             "(the 'model' fold ORs the bool rows as words)")
        nwl = _bucket_words(mesh, nw, "sharded_deps_step")
        nl = n // data
        deps = torch.empty(n, n, dtype=torch.bool, device=cons)
        valid = torch.ones(n, dtype=torch.bool, device=cons)
        for d in range(data):
            rows = slice(d * nl, (d + 1) * nl)
            parts = torch.empty(1, model, nl, n, dtype=torch.bool,
                                device=cons)
            for m in range(model):
                dev = mesh.device(d, m)
                cols = slice(m * nwl, (m + 1) * nwl)
                with _at(dev):
                    out = _dest(parts[0, m], dev)
                    tk.deps_matrix_shard(
                        _on(words[rows, cols], dev), _on(ts[rows], dev),
                        _on(kinds[rows], dev), _on(words[:, cols], dev),
                        _on(ts, dev), _on(kinds, dev), _on(valid, dev),
                        _on(table, dev), out)
                _land(parts[0, m], out)
            _or_fold_model(parts.view(torch.int32), deps[rows].view(
                torch.int32))
        # every data shard's device keeps a replica of the gathered matrix
        devs = {mesh.device(d, 0) for d in range(data)}
        closed = {dev: torch.empty(n, (n + 31) // 32, dtype=torch.int32,
                                   device=dev) for dev in devs}
        for d in range(data):
            rows = slice(d * nl, (d + 1) * nl)
            dev = mesh.device(d, 0)
            with _at(dev):
                tk.pack_rows(_on(deps[rows], dev), closed[dev][rows])
            _gather_rows(mesh, closed, d, rows)
        closed = _gathered_rounds(
            mesh, closed, nl, iters, lambda d, rows, full, dst:
            tk.closure_rows(full, n, rows.start, nl, dst))
        lv = _gathered_rounds(
            mesh, {dev: torch.zeros(n, dtype=torch.int32, device=dev)
                   for dev in devs}, nl, iters,
            lambda d, rows, lvl, dst: tk.wavefront_rows(
                closed[mesh.device(d, 0)][rows], lvl, rows.start, dst))
        return deps, lv[cons]

    return _entry(mesh, "sharded_deps_step", step)


# -- row 35b: the sharded protocol megakernel ----------------------------------
def _sharded_tick_eager(mesh: Mesh, wt, key_in, rng_in, fin_statics,
                        fin_traced, cmds, quorum, quorum_size, mailbox,
                        cmd_repairs, execs):
    """The sharded program stage by stage: the sharded entries above for
    the resolves and every key/rkey finalize, K23 for the mailbox, and the
    replicated stages (range finalize, cmd_tick, quorum, cmd_repair,
    frontier_compact) as one kernels.protocol_tick on the consumer. On the
    CPU every step is a plain version; across cards each shard's kernels
    launch on its card."""
    from accord_tpu_torch.ops.mailbox import sharded_mailbox_route
    cons = mesh.device(0, 0)
    packed = ()
    rng_out = ()
    if key_in is not None:
        *lanes, blocks = key_in
        packed = sharded_fused_deps_resolve(mesh, len(blocks))(
            *(_on(x, cons) for x in lanes), blocks, wt)
    if rng_in is not None:
        (iv_of, iv_s, iv_e, snode, sb, sknd, srng, r_slots, rblocks,
         k_slots, kblocks) = rng_in
        rng_out = sharded_fused_range_deps_resolve(
            mesh, len(rblocks), len(kblocks))(
            *(_on(x, cons) for x in (iv_of, iv_s, iv_e, snode, sb, sknd,
                                     srng, r_slots)),
            rblocks, _on(k_slots, cons), kblocks, wt)
    fin_outs: list = [None] * len(fin_statics)
    rep_fins = []
    for i, (spec, args) in enumerate(zip(fin_statics, fin_traced)):
        if spec[0] == "range":
            rep_fins.append((i, ("range",) + tuple(args) + (spec[1],)))
            continue
        kind, rows, words, out_cap = spec
        (r0, w_lo, word_off, kid_rows, slot_subj, slot_kid, subj_row,
         act_ts) = args
        src = packed if kind == "key" else rng_out[1]
        fin_outs[i] = sharded_finalize_csr(mesh)(
            tk._window(src, r0, w_lo, rows, words), int(word_off), kid_rows,
            *(_on(x, cons) for x in (slot_subj, slot_kid, subj_row)),
            _on(act_ts, cons), out_cap=out_cap)
    mail_out = ()
    if mailbox is not None:
        mail_out = sharded_mailbox_route(mesh.shape["data"], *mailbox)
    cmd_outs = q_out = rep_outs = exec_outs = ()
    if rep_fins or cmds or quorum is not None or cmd_repairs or execs:
        _p, _r, rfin, cmd_outs, q_out, _m, rep_outs, exec_outs = \
            tk.protocol_tick(wt, fins=tuple(f for _i, f in rep_fins),
                             cmds=cmds, quorum=quorum,
                             quorum_size=quorum_size,
                             cmd_repairs=cmd_repairs, execs=execs)
        for (i, _f), out in zip(rep_fins, rfin):
            fin_outs[i] = out
    return (packed, rng_out, tuple(fin_outs), cmd_outs, q_out, mail_out,
            rep_outs, exec_outs)


def sharded_protocol_tick(mesh: Mesh, witness_table, key_in=None,
                          rng_in=None, fins=(), cmds=(), quorum=None,
                          quorum_size=1, mailbox=None, cmd_repairs=(),
                          execs=()):
    """Multi-device twin of kernels.protocol_tick (the reference's :821,
    builder :683): ONE program per cluster tick. Same argument contract
    (see protocol_tick's docstring) with `mesh` first; key_in/rng_in are
    the node-lane merge inputs sharded_node_tick would dispatch (the
    resolves run per store block x 'data' shard x 'model' shard, the
    'model' partials OR-folded), every key/rkey finalize runs as the
    sharded finalize (counts, counts_scan, shard compaction,
    fragment_merge), and `mailbox` is a MailboxPlane staged with shards ==
    mesh.shape['data'] (K23 lands the cross-shard payloads). The range
    finalize, cmd_tick, quorum, cmd_repair and frontier_compact stages run
    once, on the consumer mesh.device(0, 0), as in the single-device
    program. Finalize specs sort canonically by static signature
    (kernels._fin_split), so the program depends on the signature
    multiset. Outputs are bit-identical to protocol_tick's.

    When every shard is on one card, the program is one CUDA graph per
    static signature and mesh (ops/tick_graph.py), replayed once per call
    and counted in LAUNCHES["sharded_protocol_tick"] (captures in
    CAPTURES). Across cards it runs stage by stage (_sharded_tick_eager),
    each shard's kernels on its card: no graph replays, and the kernels it
    launches are counted in ENTRY_LAUNCHES["sharded_protocol_tick_stages"]
    (beside each kernel's own count). On the CPU the same walk runs the
    plain versions."""
    if mailbox is not None:
        from accord_tpu_torch.ops.mailbox import check_shard_mail_lanes
        check_shard_mail_lanes(mesh.shape["data"], mailbox)
        mailbox = tuple(mailbox)
    fin_statics, fin_traced, order = tk._fin_split(fins)
    args = (witness_table, key_in, rng_in, fin_statics, fin_traced,
            tuple(cmds), quorum, quorum_size, mailbox, tuple(cmd_repairs),
            tuple(execs))
    with _at(mesh.device(0, 0)):
        if witness_table.is_cuda and one_card(mesh):
            from accord_tpu_torch.ops.tick_graph import run_protocol_tick
            out = run_protocol_tick(*args, mesh=mesh)
        else:
            before = sum(tk.LAUNCHES.values())
            try:
                out = _sharded_tick_eager(mesh, *args)
            finally:
                tk.ENTRY_LAUNCHES["sharded_protocol_tick_stages"] += \
                    sum(tk.LAUNCHES.values()) - before
    return out[:2] + (tk._fin_unsort(out[2], order),) + out[3:]


def sharded_protocol_tick_cache_sizes() -> int:
    """The sharded protocol megakernel's held CUDA graphs (every mesh and
    static signature), folded into kernels.jit_cache_sizes."""
    from accord_tpu_torch.ops.tick_graph import held_graphs
    return held_graphs().get("sharded_protocol_tick", 0)


def warmup_sharded(mesh: Mesh, num_buckets: int = 256, cap: int = 4096,
                   batch_tiers: Tuple[int, ...] = (8, 64, 128),
                   nnz_tiers: Optional[Tuple[int, ...]] = None,
                   range_cap: Optional[int] = None,
                   store_tiers: Tuple[int, ...] = (1, 2),
                   out_tiers: Tuple[int, ...] = (),
                   kid_cap: int = 4096,
                   cmd_caps: Tuple[int, ...] = (),
                   cmd_key_caps: Tuple[int, ...] = (1024,),
                   cmd_kpad: int = 4,
                   cmd_op_tiers: Optional[Tuple[int, ...]] = None,
                   cmd_promote_modes: Tuple[bool, ...] = (False,),
                   node_tiers: Tuple[int, ...] = (),
                   node_batch_tiers: Optional[Tuple[int, ...]] = None,
                   mega_quorum_sizes: Tuple[int, ...] = (),
                   mega_lane_tiers: Optional[Tuple[int, ...]] = None,
                   exec_caps: Tuple[int, ...] = (),
                   exec_tiers: Tuple[int, ...] = (),
                   recovery_tiers: Tuple[int, ...] = ()) -> None:
    """The reference's warmup_sharded (:865), with its signature. The
    port's hand kernels are not specialised on shape (kernels.
    jit_cache_sizes), so a launch per tier would warm nothing past the
    kernels' first build: this builds them once (on a card), and captures
    what a shape does make, a CUDA graph of the sharded protocol
    megakernel -- the quorum-only ticks per `mega_quorum_sizes` x lane tier
    and the exec-only ticks per (exec cap, plane count 1 and each
    `store_tiers` entry above 1, `exec_tiers` out_cap), the graphs a warm
    burn's idle and exec-only ticks replay. The other arguments (the
    resolve, finalize, cmd, node and recovery tiers the reference compiles)
    are accepted and have no effect. Lanes live on the consumer
    mesh.device(0, 0); on the CPU the ticks run the plain program."""
    from accord_tpu_torch.ops.tiers import MEGA_LANE_TIERS
    cons = mesh.device(0, 0)
    if cons.type == "cuda":
        tk._ext().lib("tick_graph")   # builds and loads every library
    table = tk.upload(WITNESS_TABLE, cons)
    lt = (tuple(mega_lane_tiers) if mega_lane_tiers is not None
          else MEGA_LANE_TIERS[:2])
    for qs in mega_quorum_sizes:
        for t in lt:
            sharded_protocol_tick(
                mesh, table, quorum=(np.zeros((t, 3), np.int32),
                                     np.zeros((t, 3), np.int32),
                                     np.zeros(t, np.int32),
                                     np.zeros(t, bool)),
                quorum_size=qs)
    for ecap in (tuple(exec_caps) or (1024,)) if exec_tiers else ():
        plane = (torch.zeros(ecap, ecap // 32, dtype=torch.int32,
                             device=cons),
                 torch.full((ecap, 3), tk.INT32_MIN, dtype=torch.int32,
                            device=cons),
                 *(torch.zeros(ecap, dtype=torch.bool, device=cons)
                   for _ in range(3)))
        for n in (1,) + tuple(s for s in store_tiers if s > 1):
            for oc in exec_tiers:
                sharded_protocol_tick(mesh, table,
                                      execs=((tuple(plane for _ in range(n)),
                                              oc),))
    if cons.type == "cuda":
        torch.cuda.synchronize(cons)


# -- example inputs --------------------------------------------------------------
def example_batch(n: int = 64, k: int = 256, seed: int = 0):
    """Deterministic example inputs for compile checks and dry runs."""
    rng = np.random.default_rng(seed)
    bitmaps = (rng.random((n, k)) < 0.05).astype(np.float32)
    hlcs = np.sort(rng.integers(0, 100_000, n))
    ts = np.stack([np.zeros(n, np.int32), hlcs.astype(np.int32),
                   rng.integers(0, 1 << 16, n).astype(np.int32)], axis=1)
    kinds = rng.integers(0, 2, n).astype(np.int32)  # READ/WRITE mix
    return bitmaps, ts, kinds, WITNESS_TABLE.copy()


def example_resolve_batch(cap: int = 512, k: int = 256, b: int = 16,
                          nnz: int = 64, seed: int = 0):
    """Deterministic random inputs in deps_resolve's exact signature shape
    (CSR subject entries padded with out-of-bounds row B, 3-lane int32
    timestamps, arena lanes) -- shared by the dry-run and the
    sharded-vs-single differential tests so the invariants live in one
    place."""
    rng = np.random.default_rng(seed)
    live = rng.random(nnz) < 0.6
    subj_of = np.where(live, rng.integers(0, b, nnz), b).astype(np.int32)
    subj_keys = rng.integers(0, k, nnz).astype(np.int32)
    sb = np.stack([np.zeros(b, np.int32),
                   rng.integers(1000, 100_000, b).astype(np.int32),
                   rng.integers(0, 100, b).astype(np.int32)], 1)
    sknd = rng.integers(0, 5, b).astype(np.int32)
    act_bm = (rng.random((cap, k)) < 0.05).astype(np.float32)
    act_ts = np.stack([np.zeros(cap, np.int32),
                       rng.integers(0, 90_000, cap).astype(np.int32),
                       rng.integers(0, 100, cap).astype(np.int32)], 1)
    act_kinds = rng.integers(0, 5, cap).astype(np.int32)
    act_valid = rng.random(cap) < 0.9
    return (subj_of, subj_keys, sb, sknd, act_bm, act_ts, act_kinds,
            act_valid, WITNESS_TABLE.copy())
