"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each test builds its inputs from a numpy seed, runs the plain version on
the CPU and the kernel on the card, and requires bit-equal outputs (every
output is an integer or a bit word). The card is looked for inside a
fixture, so every worker collects the same tests; without one they skip.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from accord_tpu_torch.ops import kernels as tk
from accord_tpu_torch.ops import mailbox as tmb
from accord_tpu_torch.ops.encoding import WITNESS_TABLE
from torch_kernel_cases import (ARENA_SCATTER_CASES, CLOSURE_CASES,
                                CLOSURE_ITERS, CMD_CASES, CMD_SCALARS,
                                CONFLICT_CASES, DAG_CASES, DEPS_CASES,
                                FRONTIER_CASES, KEY_BODY_CASES, KEY_BODY_RUN_CASES,
                                KEY_SHARD_CASES, QUORUM_CARD_TIERS,
                                QUORUM_CASES, RANGE_BODY_CASES,
                                RANGE_FIN_CASES, arena_scatter_case,
                                closure_case, cmd_case, conflict_case,
                                dag_case, dag_levels, deps_case,
                                finalize_many_tiles, key_body_case,
                                frontier_case, pack_words, quorum_case,
                                quorum_lanes, range_body_case,
                                range_fin_case, ROUTE_HAZARDS, route_case,
                                SHARD_FIN_CASES,
                                SHARD_ROUTE_HAZARDS, merge_fragments_case,
                                shard_fin_case, shard_route_case,
                                WAVEFRONT_CASES, wavefront_case)

pytestmark = pytest.mark.gpu
I32_MIN = np.iinfo(np.int32).min


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(plain, kernel):
    if isinstance(plain, (tuple, list)):
        assert len(plain) == len(kernel)
        for p, k in zip(plain, kernel):
            _eq(p, k)
        return
    assert plain.dtype == kernel.dtype and plain.shape == kernel.shape
    assert torch.equal(plain, kernel.cpu())


def _words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)


def _arena(rng, cap, k):
    bm = _words(rng, (cap, k // 32)) & _words(rng, (cap, k // 32)) \
        & _words(rng, (cap, k // 32)) & _words(rng, (cap, k // 32))
    ts = rng.integers(-50, 50, (cap, 3)).astype(np.int32)
    ts[rng.random(cap) < 0.1, 0] = I32_MIN
    ex = np.full((cap, 3), I32_MIN, np.int32)
    kinds = rng.integers(0, 6, cap).astype(np.int32)
    valid = rng.random(cap) < 0.8
    return [_t(a) for a in (bm, ts, ex, kinds, valid)]


def _subjects(rng, b, k, nnz):
    n = nnz * 3 // 4
    subj_of = np.full(nnz, b, np.int32)
    subj_of[:n] = np.sort(rng.integers(0, b, n))
    subj_keys = np.zeros(nnz, np.int32)
    subj_keys[:n] = rng.integers(0, k, n)
    sb = rng.integers(-50, 50, (b, 3)).astype(np.int32)
    sknd = rng.integers(0, 6, b).astype(np.int32)
    return [_t(a) for a in (subj_of, subj_keys, sb, sknd)]


def _cu(ts, dev):
    return [t.to(dev) for t in ts]


@pytest.mark.parametrize("b,cap,k", [(8, 64, 128), (256, 2048, 1024),
                                     (100, 544, 160)])
def test_deps_resolve_kernel(cuda, b, cap, k):
    rng = np.random.default_rng(b + cap)
    arena = _arena(rng, cap, k)
    subj = _subjects(rng, b, k, 4 * b)
    table = _t(WITNESS_TABLE)
    plain = tk.deps_resolve(*subj, arena[0], arena[1], arena[3], arena[4],
                            table)
    a, s = _cu(arena, cuda), _cu(subj, cuda)
    n0 = tk.LAUNCHES["deps_resolve"]
    got = tk.deps_resolve(*s, a[0], a[1], a[3], a[4], table.to(cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["deps_resolve"] == n0 + 1
    _eq(plain, got)
    assert plain.any()


def test_fused_deps_resolve_kernel(cuda):
    rng = np.random.default_rng(7)
    b, k = 128, 256
    arenas = [_arena(rng, 1024, k), _arena(rng, 512, k),
              _arena(rng, 1024, k)]
    subj = _subjects(rng, b, k, 512)
    store = _t(rng.integers(0, 3, b).astype(np.int32))
    slots = _t(np.array([0, 1, -1], np.int32))
    table = _t(WITNESS_TABLE)
    blocks = [(a[0], a[1], a[3], a[4]) for a in arenas]
    plain = tk.fused_deps_resolve(subj[0], subj[1], store, subj[2], subj[3],
                                  slots, blocks, table)
    cblocks = [tuple(t.to(cuda) for t in blk) for blk in blocks]
    s = _cu(subj, cuda)
    got = tk.fused_deps_resolve(s[0], s[1], store.to(cuda), s[2], s[3],
                                slots.to(cuda), cblocks, table.to(cuda))
    _eq(plain, got)


@pytest.mark.parametrize("out_cap", [256, 1 << 17])
def test_finalize_csr_kernel(cuda, out_cap):
    rng = np.random.default_rng(out_cap)
    b, cap, kc, s = 128, 2048, 256, 512
    w = cap // 32
    packed = _t(_words(rng, (b, 2 * w)))
    kid_rows = _t(_words(rng, (kc, w)) & _words(rng, (kc, w))
                  & _words(rng, (kc, w)))
    slot_subj = np.full(s, b, np.int32)
    slot_subj[:s - 9] = np.sort(rng.integers(0, b, s - 9))
    slot_kid = np.full(s, kc, np.int32)
    slot_kid[:s - 9] = rng.integers(0, kc, s - 9)
    subj_row = _t(rng.integers(-1, cap, b).astype(np.int32))
    act_ts = _t(rng.integers(I32_MIN, 1 << 30, (cap, 3)).astype(np.int32))
    args = [packed, None, kid_rows, _t(slot_subj), _t(slot_kid), subj_row,
            act_ts]
    for off in (0, w, 5 * w):       # 5w clamps to the last span, like JAX
        args[1] = off
        plain = tk.finalize_csr(*args, out_cap=out_cap)
        got = tk.finalize_csr(*[a.to(cuda) if torch.is_tensor(a) else a
                                for a in args], out_cap=out_cap)
        _eq(plain, got)
        assert (int(plain[0][-1]) > out_cap) == (out_cap == 256)


def test_arena_scatter_kernels(cuda):
    rng = np.random.default_rng(3)
    cap, k = 2048, 1024
    arena = _arena(rng, cap, k)
    m, z = 64, 512
    chunk = np.sort(rng.choice(cap, 40, replace=False)).astype(np.int32)
    rows = np.full(m, chunk[0], np.int32)
    rows[:40] = chunk
    key_rows = np.full(z, cap, np.int32)
    key_rows[:400] = np.repeat(chunk, 10)
    key_mods = np.zeros(z, np.int32)
    key_mods[:400] = rng.integers(0, k, 400)
    lane_rows = [arena[1][rows], arena[2][rows], arena[3][rows],
                 arena[4][rows]]
    ups = [_t(rows), _t(key_rows), _t(key_mods)] + lane_rows
    plain = tk.arena_scatter(*arena, *ups)
    got = tk.arena_scatter(*_cu(arena, cuda), *_cu(ups, cuda))
    _eq(plain, got)
    plain_k = tk.arena_scatter_keys(arena[0], *ups[:3])
    got_k = tk.arena_scatter_keys(arena[0].to(cuda), *_cu(ups[:3], cuda))
    _eq(plain_k, got_k)


def test_row_scatter_kernels(cuda):
    rng = np.random.default_rng(4)
    cap, kc = 2048, 512
    arena = _arena(rng, cap, 1024)
    idx = np.full(64, cap, np.int32)
    idx[:50] = rng.choice(cap, 50, replace=False)
    for lane in (arena[1], arena[2], arena[4]):
        data = lane[rng.integers(0, cap, 64)]
        plain = tk.scatter_rows(lane, _t(idx), data)
        got = tk.scatter_rows(lane.to(cuda), _t(idx).to(cuda),
                              data.to(cuda))
        _eq(plain, got)
    kid_rows = _t(_words(rng, (kc, cap // 32)))
    kid_idx = np.full(512, kc, np.int32)
    kid_idx[:300] = rng.integers(0, kc, 300)
    word_idx = rng.integers(0, cap // 32, 512).astype(np.int32)
    coords = kid_idx[:300].astype(np.int64) * 64 + word_idx[:300]
    _, first = np.unique(coords, return_index=True)   # dedupe like the host
    keep = np.full(512, False)
    keep[first] = True
    keep[300:] = True
    words = _t(_words(rng, 512)[keep])
    ki, wi = _t(kid_idx[keep]), _t(word_idx[keep])
    plain = tk.kid_word_scatter(kid_rows, ki, wi, words)
    got = tk.kid_word_scatter(kid_rows.to(cuda), ki.to(cuda), wi.to(cuda),
                              words.to(cuda))
    _eq(plain, got)
    plain_g = tk.arena_grow(*arena, new_cap=2 * cap)
    got_g = tk.arena_grow(*_cu(arena, cuda), new_cap=2 * cap)
    _eq(plain_g, got_g)


def _unaligned(t, shift):
    """`t` as a view `shift` elements into a larger buffer (a lane whose
    base is not 16-byte aligned)."""
    big = torch.empty((t.shape[0] + 1, *t.shape[1:]), dtype=t.dtype)
    flat = big.reshape(-1)[shift:shift + t.numel()]
    flat.copy_(t.reshape(-1))
    return flat.view(t.shape)


def _lane_case(rng, cap, row, dtype, m):
    """A lane of `cap` rows of shape `row`, and m indices with duplicates
    (same data), a negative one and out-of-range ones, plus their rows."""
    shape = (cap, *row)
    if dtype == torch.bool:
        src = _t(rng.random(shape) < 0.5)
    else:
        src = _t(_words(rng, shape))
    idx = rng.integers(0, cap, m).astype(np.int32)
    if m >= 4:
        idx[1] = idx[0]                           # duplicate, same data
        idx[2] = -1 - int(rng.integers(0, cap))   # negative: wraps once
        idx[3] = cap + 5                          # out of range: dropped
    rows = src[_t(rng.integers(0, cap, m))].clone()
    norm = np.where(idx < 0, idx + cap, idx)
    first = {}
    for j, r in enumerate(norm.tolist()):          # duplicates: same data
        if 0 <= r < cap:
            rows[j] = rows[first.setdefault(r, j)]
    return src, _t(idx), rows


@pytest.mark.parametrize("row,dtype", [((), torch.bool), ((), torch.int32),
                                       ((3,), torch.int32),
                                       ((512,), torch.int32)])
@pytest.mark.parametrize("shift", [0, 1])
def test_lane_table_kernel(cuda, row, dtype, shift):
    """K4's lane table against its plain version at row bytes 1, 4, 12
    and 2 KB: lanes of different caps in one table, m = 0, a grow lane
    with a fill, lanes whose base is not 16-byte aligned; one launch a
    call, bit-equal."""
    rng = np.random.default_rng(len(row) + shift)
    lanes = []
    for cap, m in ((64, 8), (2048, 64), (300, 0), (1, 8)):
        src, idx, rows = _lane_case(rng, cap, row, dtype, m)
        if shift:
            src, rows = _unaligned(src, shift), _unaligned(rows, shift)
        lanes.append((src, idx, rows))
    grow_src = _lane_case(rng, 100, row, dtype, 8)[0]
    fill = True if dtype == torch.bool else I32_MIN
    lanes.append((grow_src, None, None, 257, fill))
    plain = tk.lane_table(lanes)
    n0 = tk.LAUNCHES["row_scatter"]
    got = tk.lane_table([tuple(_on(lane, cuda)) for lane in lanes])
    torch.cuda.synchronize()
    assert tk.LAUNCHES["row_scatter"] == n0 + 1
    _eq(plain, got)
    for src, idx, rows in lanes[:4]:
        n0 = tk.LAUNCHES["row_scatter"]
        got = tk.scatter_rows(*_on([src, idx, rows], cuda))
        torch.cuda.synchronize()
        assert tk.LAUNCHES["row_scatter"] == n0 + 1
        _eq(tk.scatter_rows(src, idx, rows), got)


@pytest.mark.parametrize("shift", [0, 1])
def test_kid_word_scatter_2k_rows(cuda, shift):
    """The 2-D word form at a 2 KB kid row (cap 16,384), padding
    coordinates (kid == KC) and a negative word index; one launch."""
    rng = np.random.default_rng(16 + shift)
    kc, w = 96, 512
    kid_rows = _t(_words(rng, (kc, w)))
    z = 1024
    coords = rng.choice(kc * w, 900, replace=False)
    ki = np.full(z, kc, np.int32)
    ki[:900] = coords // w
    wi = rng.integers(0, w, z).astype(np.int32)
    wi[:900] = coords % w
    wi[5] -= w
    words = _t(_words(rng, z))
    args = [kid_rows, _t(ki), _t(wi), words]
    if shift:
        args[0], args[3] = _unaligned(args[0], 1), _unaligned(args[3], 1)
    plain = tk.kid_word_scatter(*args)
    n0 = tk.LAUNCHES["row_scatter"]
    got = tk.kid_word_scatter(*_on(args, cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["row_scatter"] == n0 + 1
    _eq(plain, got)


def test_arena_grow_one_launch(cuda):
    rng = np.random.default_rng(8)
    arena = _arena(rng, 544, 1024)
    n0 = tk.LAUNCHES["row_scatter"]
    got = tk.arena_grow(*_cu(arena, cuda), new_cap=1088)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["row_scatter"] == n0 + 1
    _eq(tk.arena_grow(*arena, new_cap=1088), got)


def test_flush_lanes_kernel(cuda):
    """A plane flush: eight lanes, some with 70 dirty rows (two chunks),
    one K4 launch per chunk; the lanes and the upload accounting equal the
    CPU's."""
    from accord_tpu_torch.ops.deltas import flush_lanes
    rng = np.random.default_rng(9)
    host = [rng.integers(-9, 9, 512).astype(np.int32),
            rng.integers(-9, 9, (512, 3)).astype(np.int32),
            rng.random(512) < 0.5] * 2 + [
            rng.integers(-9, 9, (64, 3)).astype(np.int32),
            rng.random(64) < 0.5]
    rows = [sorted(rng.choice(len(h), n, replace=False).tolist())
            for h, n in zip(host, (70, 3, 0, 64, 65, 8, 20, 20))]
    def specs(dev, log):
        return [(torch.zeros(h.shape, dtype=_t(h).dtype, device=dev), r, h,
                 lambda nb, m: log.append((nb, m)))
                for h, r in zip(host, rows)]
    cpu_log, card_log = [], []
    plain = flush_lanes(specs("cpu", cpu_log))
    n0 = tk.LAUNCHES["row_scatter"]
    got = flush_lanes(specs(cuda, card_log))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["row_scatter"] == n0 + 2     # two chunks
    _eq(list(plain), list(got))
    assert cpu_log == card_log and cpu_log


# -- range-domain and max-conflict kernels (K4 range entry, K5, K6, K7) ------
I32_MAX = np.iinfo(np.int32).max


def _range_arena(rng, rcap, domain=1 << 16):
    starts = rng.integers(0, domain, rcap).astype(np.int32)
    ends = (starts + rng.integers(1, 2048, rcap)).astype(np.int32)
    ts = rng.integers(-50, 50, (rcap, 3)).astype(np.int32)
    ts[rng.random(rcap) < 0.1, 0] = I32_MIN
    kinds = rng.integers(0, 6, rcap).astype(np.int32)
    valid = rng.random(rcap) < 0.8
    return [_t(a) for a in (starts, ends, ts, kinds, valid)]


def _intervals(rng, b, nv, domain=1 << 16):
    """An interval CSR with padding (iv_of == b), a negative iv_of, widths
    0, < 0, >= 1024, and endpoints whose difference wraps int32."""
    n = nv - nv // 8
    iv_of = np.full(nv, b, np.int32)
    iv_of[:n] = np.sort(rng.integers(0, b, n))
    iv_of[n - 1] = -1
    iv_s = rng.integers(0, domain, nv).astype(np.int32)
    width = np.where(rng.random(nv) < 0.6, 1, rng.integers(1, 2048, nv))
    iv_e = (iv_s + width).astype(np.int32)
    iv_e[3], iv_e[5] = iv_s[3], iv_s[5] - 7
    iv_e[7] = iv_s[7] + 5000
    iv_s[9], iv_e[9] = I32_MAX - 2, I32_MIN + 3
    iv_s[11], iv_e[11] = I32_MIN + 1, I32_MAX
    sb = rng.integers(-50, 50, (b, 3)).astype(np.int32)
    sb[: b // 2] = (I32_MAX, 0, 0)
    sknd = rng.integers(0, 6, b).astype(np.int32)
    srng = rng.random(b) < 0.5
    return [_t(a) for a in (iv_of, iv_s, iv_e, sb, sknd, srng)]


def _on(ts, dev):
    return [t.to(dev) if torch.is_tensor(t) else
            tuple(_on(t, dev)) if isinstance(t, (tuple, list)) else t
            for t in ts]


@pytest.mark.parametrize("rcap,m", [(64, 8), (2048, 64)])
def test_range_scatter_kernel(cuda, rcap, m):
    rng = np.random.default_rng(rcap + m)
    lanes = _range_arena(rng, rcap)
    chunk = np.sort(rng.choice(rcap, min(m, 40), replace=False))
    rows = np.full(m, chunk[0], np.int32)
    rows[:len(chunk)] = chunk
    rows[len(chunk) - 1] -= rcap                 # negative: wraps once
    src = [t[_t(rng.integers(0, rcap, m))] for t in _range_arena(rng, rcap)]
    for t in src:
        t[_t(rows == chunk[0])] = t[0].clone()
    args = [*lanes, _t(rows), *src]
    plain = tk.range_scatter(*args)
    n0 = tk.LAUNCHES["range_scatter"]
    got = tk.range_scatter(*_on(args, cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["range_scatter"] == n0 + 1
    _eq(plain, got)


@pytest.mark.parametrize("b,nv,k", [(8, 32, 128), (256, 2048, 1024)])
def test_covered_buckets_kernel(cuda, b, nv, k):
    rng = np.random.default_rng(b + nv)
    iv_of, iv_s, iv_e = _intervals(rng, b, nv)[:3]
    plain = tk.covered_buckets(iv_of, iv_s, iv_e, b, k)
    got = tk.covered_buckets(*_on([iv_of, iv_s, iv_e], cuda), b, k)
    _eq(plain, got)


@pytest.mark.parametrize("b,nv,rcap,cap,k", [(8, 32, 64, 64, 128),
                                             (256, 2048, 2048, 4096, 1024)])
def test_range_deps_resolve_kernel(cuda, b, nv, rcap, cap, k):
    rng = np.random.default_rng(rcap + cap)
    iv = _intervals(rng, b, nv)
    r = _range_arena(rng, rcap)
    ka = _arena(rng, cap, k)
    args = [*iv, *r, ka[0], ka[1], ka[3], ka[4], _t(WITNESS_TABLE)]
    plain = tk.range_deps_resolve(*args)
    n0 = tk.LAUNCHES["range_resolve"]
    got = tk.range_deps_resolve(*_on(args, cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["range_resolve"] == n0 + 1
    _eq(plain, got)
    assert plain[0].any() and plain[1].any()


@pytest.mark.parametrize("nr,nk", [(1, 1), (2, 2), (3, 1), (0, 2), (2, 0),
                                   (0, 0)])
def test_fused_range_deps_resolve_kernel(cuda, nr, nk):
    rng = np.random.default_rng(10 * nr + nk)
    b, k = 128, 256
    iv_of, iv_s, iv_e, sb, sknd, srng = _intervals(rng, b, 1024)
    nblk = max(nr, nk, 1)
    store = _t(rng.integers(0, nblk + 1, b).astype(np.int32))
    rblocks = [tuple(_range_arena(rng, 64 * (1 + i))) for i in range(nr)]
    kblocks = [tuple(a[j] for j in (0, 1, 3, 4))
               for a in (_arena(rng, 512 * (1 + i % 2), k)
                         for i in range(nk))]
    r_slots = _t(np.arange(nr, dtype=np.int32)[::-1].copy())
    k_slots = _t(np.arange(nk, dtype=np.int32))
    args = [iv_of, iv_s, iv_e, store, sb, sknd, srng, r_slots,
            tuple(rblocks), k_slots, tuple(kblocks), _t(WITNESS_TABLE)]
    plain = tk.fused_range_deps_resolve(*args)
    n0 = tk.LAUNCHES["range_resolve"]
    got = tk.fused_range_deps_resolve(*_on(args, cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["range_resolve"] == n0 + (1 if nr or nk else 0)
    _eq(plain, got)


@pytest.mark.parametrize("out_cap", [64, 1 << 17])
def test_range_finalize_kernel(cuda, out_cap):
    rng = np.random.default_rng(out_cap)
    b, nv, rcap = 256, 2048, 2048
    iv_of, iv_s, iv_e, sb, sknd, _ = _intervals(rng, b, nv)
    ent_ok = _t(rng.random(nv) < 0.8)
    r = _range_arena(rng, rcap)
    r[1][:] = r[0] + 4096                        # wide rows: many stabs
    args = [iv_of, iv_s, iv_e, ent_ok, sb, sknd, *r, _t(WITNESS_TABLE)]
    plain = tk.range_finalize_csr(*args, out_cap=out_cap)
    n0 = tk.LAUNCHES["range_finalize"]
    got = tk.range_finalize_csr(*_on(args, cuda), out_cap=out_cap)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["range_finalize"] == n0 + 1
    _eq(plain, got)
    assert (int(plain[0][-1]) > out_cap) == (out_cap == 64)
    m, _ = tk.range_stab_words_plain(*args)
    _eq(tk.segment_compact(m, out_cap), tk.segment_compact(m.to(cuda),
                                                           out_cap))


def _conflict_shape(b, cap, k):
    """max_conflict's inputs at (b, cap, k) from a seed: subject 0 all
    zero, subject 1 meeting one row whose lanes are all INT32_MIN, the
    rest 2 buckets each; ~1 bucket a row, exact exec_ts ties."""
    rng = np.random.default_rng(b + cap)
    bm = _words(rng, (cap, k // 32)) & _words(rng, (cap, k // 32)) \
        & _words(rng, (cap, k // 32)) & _words(rng, (cap, k // 32)) \
        & _words(rng, (cap, k // 32))
    ex = rng.integers(-2, 2, (cap, 3)).astype(np.int32)   # exact ties
    ex[rng.random(cap) < 0.2, 0] = I32_MIN
    ex[rng.random(cap) < 0.1] = I32_MIN
    valid = rng.random(cap) < 0.9
    subj = np.zeros((b, k // 32), np.int32)
    for i in range(2, b):
        for bucket in rng.integers(0, k, 2):
            subj[i, bucket >> 5] |= np.int32(np.uint32(1 << (bucket & 31))
                                             .view(np.int32))
    only = cap - 5                               # subject 1 meets one row,
    bm[:, 0] &= ~np.int32(1)                     # whose lanes are all MIN
    bm[only, 0] |= 1
    valid[only] = True
    ex[only] = I32_MIN
    subj[1, 0] = 1
    return [_t(subj), _t(bm), _t(ex), _t(valid)], only


@pytest.mark.parametrize("case", [(8, 4096, 128), (64, 16384, 1024),
                                  *CONFLICT_CASES], ids=str)
def test_max_conflict_kernel(cuda, case):
    """K7 against its plain version, ONE launch a call: at the inline
    leg's shape and at (64, 16,384, 1,024) (four row batches a subject),
    and on the shared cases the CPU tests hold the plain version to the
    JAX kernel on (all-zero subjects beside live ones, ties first met in
    the last, ragged row batch, one all-INT32_MIN meeting row, every row
    invalid, K 32 and 1,024, a subject of six nonzero words whose rows
    meet only the sixth)."""
    if isinstance(case, str):
        subj, bits, ex, valid = conflict_case(case)
        args = [_t(pack_words(subj)), _t(pack_words(bits)), _t(ex),
                _t(valid)]
    else:
        args, only = _conflict_shape(*case)
    plain = tk.max_conflict(*args)
    n0 = tk.LAUNCHES["max_conflict"]
    got = tk.max_conflict(*_on(args, cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["max_conflict"] == n0 + 1
    _eq(plain, got)
    if not isinstance(case, str):
        assert int(plain[1][0]) == -1 and int(plain[1][1]) == only
        assert (plain[1][2:] >= 0).all()


def _exec_plane(rng, cap, pending=0.6):
    """An exec arena with the compare's hazards: signed exec_ts with
    undecided (INT32_MIN), INT32_MAX and equal triples, set diagonal
    bits, awaits_all rows; up to 8 wait edges per row, packed straight
    into int32 [cap, cap/32] words."""
    deps = rng.integers(0, cap, (cap, 8))
    deps[rng.random((cap, 8)) < 0.3] = -1
    diag = rng.random(cap) < 0.05
    deps[diag, 0] = np.nonzero(diag)[0]
    w, k = np.nonzero(deps >= 0)
    d = deps[w, k]
    words = np.zeros((cap, cap // 32), np.uint32)
    np.bitwise_or.at(words, (w, d >> 5), np.uint32(1) << (d & 31)
                     .astype(np.uint32))
    ts = rng.integers(-4, 4, (cap, 3)).astype(np.int32)
    ts[rng.random(cap) < 0.1] = I32_MIN
    ts[rng.random(cap) < 0.05] = np.iinfo(np.int32).max
    eq = rng.choice(cap, cap // 8, replace=False)
    ts[eq] = ts[eq[0]]
    return [_t(words.view(np.int32)), _t(ts), _t(rng.random(cap) < 0.4),
            _t(rng.random(cap) < pending), _t(rng.random(cap) < 0.05)]


@pytest.mark.parametrize("cap,m", [(64, 8), (2048, 64), (16384, 64),
                                   (96, 24), (96, 80), (32, 40)])
def test_exec_scatter_kernel(cuda, cap, m):
    """K8 (ONE launch, a CTA a span of 16 rows of all five lanes) = its
    plain version: caps of 1 to 1,024 spans, more dirty rows than a span
    holds, duplicates, a negative index and one out of range; its five
    outputs views of one allocation."""
    rng = np.random.default_rng(cap + m)
    lanes = _exec_plane(rng, cap)
    n = m // 2
    targets = rng.choice(cap, n, replace=False).astype(np.int32)
    pick = np.concatenate([np.arange(n), rng.integers(0, n, m - n)])
    rows = targets[pick]
    rows[n] -= cap                     # negative: wraps once
    rows[-1] = cap                     # dropped
    adj_rows = _words(rng, (n, cap // 32))[pick]
    ts_rows = rng.integers(-3, 3, (n, 3)).astype(np.int32)[pick]
    flags = [(rng.random(n) < 0.5)[pick] for _ in range(3)]
    args = [*lanes, _t(rows), _t(adj_rows), _t(ts_rows),
            *(_t(f) for f in flags)]
    plain = tk.exec_scatter(*args)
    n0 = tk.LAUNCHES["exec_scatter"]
    got = tk.exec_scatter(*_on(args, cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["exec_scatter"] == n0 + 1
    _eq(plain, got)
    base = got[0].untyped_storage().data_ptr()
    assert all(g.untyped_storage().data_ptr() == base for g in got)


@pytest.mark.parametrize("cap", [1024, 16384])
def test_exec_scatter_one_kernel_a_call(cuda, cap):
    """One K8 call, captured in a CUDA graph, is ONE kernel node: no copy
    of the lanes before it, no memset, no second kernel."""
    rng = np.random.default_rng(cap)
    lanes = _on(_exec_plane(rng, cap), cuda)
    rows = _t(rng.choice(cap, 64, replace=False).astype(np.int32)).to(cuda)
    srcs = [_t(_words(rng, (64, cap // 32))).to(cuda),
            _t(rng.integers(-3, 3, (64, 3)).astype(np.int32)).to(cuda),
            *(_t(rng.random(64) < 0.5).to(cuda) for _ in range(3))]
    assert _graph_node_types(
        lambda: tk.exec_scatter(*lanes, rows, *srcs)) == [0]


def _frontier_planes(name):
    """The shared K9 case `name` as the port's lanes (packed adjacency)."""
    planes, out_cap = frontier_case(name)
    return [[_t(pack_words(adj)), _t(ts), _t(app), _t(pend), _t(aw)]
            for adj, ts, app, pend, aw in planes], out_cap


@pytest.mark.parametrize("case", [
    pytest.param((64, 0.6), id="64-0.6"),
    pytest.param((2048, 1.0), id="2048-1.0"),
    pytest.param((16384, 0.6), id="16384-0.6"), *FRONTIER_CASES])
def test_execution_frontier_kernel(cuda, case):
    """K9's one-store entry (a block an output word) = its plain version:
    caps 64 to 16,384, and each plane of a shared case
    (tests/torch_kernel_cases.py) alone."""
    if isinstance(case, str):
        calls = _frontier_planes(case)[0]
    else:
        cap, pending = case
        calls = [_exec_plane(np.random.default_rng(cap), cap, pending)]
    for lanes in calls:
        plain = tk.execution_frontier(*lanes)
        n0 = tk.LAUNCHES["execution_frontier"]
        got = tk.execution_frontier(*_on(lanes, cuda))
        torch.cuda.synchronize()
        assert tk.LAUNCHES["execution_frontier"] == n0 + 1
        _eq(plain, got)
    if not isinstance(case, str):
        assert int(tk._popcount_u32(plain).sum()) > 0


@pytest.mark.parametrize("caps", [(64, 128), (2048, 1024, 64), (96,),
                                  *FRONTIER_CASES])
def test_fused_execution_frontier_kernel(cuda, caps):
    if isinstance(caps, str):
        planes = _frontier_planes(caps)[0]
    else:
        rng = np.random.default_rng(sum(caps))
        planes = [_exec_plane(rng, c) for c in caps]
    plain = tk.fused_execution_frontier(planes)
    n0 = tk.LAUNCHES["fused_execution_frontier"]
    got = tk.fused_execution_frontier([_on(p, cuda) for p in planes])
    torch.cuda.synchronize()
    assert tk.LAUNCHES["fused_execution_frontier"] == n0 + 1
    _eq(plain, got)


@pytest.mark.parametrize("caps,out_cap", [
    ((64,), 4), ((128, 64, 96), 32), ((2048,) * 5, 256), ((16384,), 2048),
    ((16384,), 1 << 14), ((32,), 8), ((32768,), 2048),
    *((c, None) for c in FRONTIER_CASES)])
def test_frontier_compact_kernel(cuda, caps, out_cap):
    """K9's compact entry (ONE launch: a block an output word, the last
    block by ticket compacting them) = its plain version: one block (cap
    32), 3 to 1,024 blocks (5 x 2,048 rows: 320; cap 16,384: 512, at
    out_cap 2,048 and 16,384; cap 32,768, whose rows take two passes of
    a warp's slots), the shared K9 cases."""
    if isinstance(caps, str):
        planes, out_cap = _frontier_planes(caps)
    else:
        rng = np.random.default_rng(len(caps) * 7 + out_cap)
        planes = [_exec_plane(rng, c) for c in caps]
    plain = tk.frontier_compact(planes, out_cap=out_cap)
    n0 = tk.LAUNCHES["frontier_compact"]
    got = tk.frontier_compact([_on(p, cuda) for p in planes],
                              out_cap=out_cap)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["frontier_compact"] == n0 + 1
    _eq(plain, got)
    indptr, rows, csum, _ = (t.cpu().numpy() for t in got)
    assert tk.frontier_checksum_host(indptr, rows) \
        == int(csum) & 0xFFFFFFFF
    # a second call on the scratch the first left zeroed
    _eq(plain, tk.frontier_compact([_on(p, cuda) for p in planes],
                                   out_cap=out_cap))


@pytest.mark.parametrize("caps", [(64, 96), (2048,) * 5])
def test_frontier_compact_tick_graph_replays_twice(cuda, caps):
    """K9's compact entry as a protocol_tick stage (its ticket in the
    graph's zeroed fixed memory): the tick called twice, the second a
    replay of the first's graph, equals the plain version both times, at
    5 and at 320 blocks."""
    rng = np.random.default_rng(sum(caps))
    planes = tuple(tuple(_exec_plane(rng, c, 1.0)) for c in caps)
    wt = _t(WITNESS_TABLE)
    plain = tk.protocol_tick(wt, execs=((planes, 4096),))
    c_planes = tuple(tuple(_on(p, cuda)) for p in planes)
    for _ in range(2):
        c0 = tk.LAUNCHES["frontier_compact"]
        got = tk.protocol_tick(wt.to(cuda), execs=((c_planes, 4096),))
        torch.cuda.synchronize()
        assert tk.LAUNCHES["frontier_compact"] == c0 + 1
        _eq(plain, got)


def test_exec_plane_burn_small_cap_matches_cpu(cuda):
    """Exec planes on the card from 32 rows, so they compact and grow (a
    rebuild re-uploads every row at the new packed width): the burn's
    history and exec counters equal the same burn's on the CPU."""
    from accord_tpu_torch.ops.exec_plane import ExecPlane
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    orig = ExecPlane.__init__
    planes = []

    def init(self, store, **kw):
        kw["initial_cap"] = 32
        orig(self, store, **kw)
        planes.append(self)

    def leg(device):
        cfg = ClusterConfig(exec_plane=True, exec_device=device,
                            durability=True, durability_interval_ms=300.0)
        r = run_burn(21, ops=120, concurrency=32, collect_log=True,
                     config=cfg)
        return r, {k: v for k, v in r.counters.items()
                   if k.startswith(("exec.", "exec_coord."))
                   and not k.endswith("harvest_stall_s")}

    ExecPlane.__init__ = init
    try:
        n0 = tk.LAUNCHES["exec_scatter"]
        card, card_counters = leg("cuda")
        torch.cuda.synchronize()
        assert tk.LAUNCHES["exec_scatter"] > n0
        card_planes, planes[:] = list(planes), []
        cpu, cpu_counters = leg("cpu")
    finally:
        ExecPlane.__init__ = orig
    assert card.log == cpu.log and card.lost == 0
    assert card_counters == cpu_counters
    assert max(p._gen for p in card_planes) > 0, "no plane compacted"
    assert max(p.cap for p in card_planes) > 32, "no plane grew"
    assert [p.cap for p in card_planes] == [p.cap for p in planes]


# -- the command plane: K10 cmd_tick, K11 recovery_scan, K12 cmd_repair ------
BAL0 = (0, 0, I32_MIN)


def _cmd_lanes(rng, n):
    a = np.empty((n, 3), np.int32)
    a[:, 0] = rng.integers(0, 3, n)
    a[:, 1] = rng.integers(7, 18, n)
    a[:, 2] = I32_MIN + rng.integers(0, 6, n)
    return a


def _cmd_columns(rng, cap, kcap):
    status = rng.choice([0, 1, 3, 5, 6, 7, 8, 9, 10, 11], cap).astype(
        np.int32)
    flags = rng.integers(0, 2, cap).astype(np.int32)
    pr, ab, ea = (_cmd_lanes(rng, cap) for _ in range(3))
    pr[rng.random(cap) < 0.4] = BAL0
    ab[rng.random(cap) < 0.5] = BAL0
    ea[rng.random(cap) < 0.4] = I32_MIN
    dur = rng.integers(0, 5, cap).astype(np.int32)
    kmax = _cmd_lanes(rng, kcap)
    kmax[rng.random(kcap) < 0.2] = I32_MIN
    return [status, flags, pr, ab, ea, dur, kmax, rng.random(kcap) < 0.6]


def _cmd_ops(rng, n_real, tier, rows, kids, now, kpad=4):
    """An op batch as CmdPlane._run_device builds it: chains through
    op_prev / op_kprev, last writers flagged, padding slots after n_real."""
    kind = np.zeros(tier, np.int32)
    row = np.zeros(tier, np.int32)
    txn = np.zeros((tier, 3), np.int32)
    bal = np.zeros((tier, 3), np.int32)
    exe = np.full((tier, 3), I32_MIN, np.int32)
    keys = np.full((tier, kpad), -1, np.int32)
    flags = np.zeros(tier, np.int32)
    op_now = np.full(tier, now, np.int32)
    prev = np.full(tier, -1, np.int32)
    rlast = np.zeros(tier, bool)
    kprev = np.full((tier, kpad), -1, np.int32)
    klast = np.zeros((tier, kpad), bool)
    last_row, last_kid = {}, {}
    for j in range(n_real):
        kind[j] = rng.integers(0, 4)
        r = int(rng.choice(rows))
        row[j] = r
        txn[j] = _cmd_lanes(rng, 1)[0]
        bal[j] = BAL0 if rng.random() < 0.6 else _cmd_lanes(rng, 1)[0]
        if rng.random() < 0.7:
            exe[j] = _cmd_lanes(rng, 1)[0]
        ks = rng.choice(kids, rng.integers(0, min(kpad, len(kids)) + 1),
                        replace=False)
        keys[j, :len(ks)] = ks
        f = tk.CMD_F_VALID
        for bit, p in ((tk.CMD_F_PERMIT_FAST, 0.6), (tk.CMD_F_EPOCH_OK, 0.8),
                       (tk.CMD_F_EXPIRED, 0.15), (tk.CMD_F_MSG_HAS_TXN, 0.6),
                       (tk.CMD_F_DEPS_EMPTY, 0.6)):
            if rng.random() < p:
                f |= bit
        flags[j] = f
        prev[j] = last_row.get(r, -1)
        last_row[r] = j
        for s, kid in enumerate(ks):
            if kid in last_kid:
                p, ps = last_kid[kid]
                kprev[j, s] = p * kpad + ps
            last_kid[kid] = (j, s)
    for j in last_row.values():
        rlast[j] = True
    for j, s in last_kid.values():
        klast[j, s] = True
    return [kind, row, txn, bal, exe, keys, flags, op_now, prev, rlast,
            kprev, klast]


@pytest.mark.parametrize("tier,n_real,cap,kcap,nrows,promote,clock", [
    (8, 8, 64, 32, 6, False, 15), (8, 3, 64, 32, 6, True, 15),
    (64, 60, 1024, 256, 24, True, 14),
    (512, 512, 16384, 1024, 300, False, 20),
    (512, 400, 16384, 1024, 300, True, I32_MIN + 5),
    (4096, 3000, 16384, 1024, 2000, True, 2 ** 31 - 1)])
def test_cmd_tick_kernel(cuda, tier, n_real, cap, kcap, nrows, promote,
                         clock):
    """K10 against cmd_tick_plain: every output, the chains included,
    both promote modes, tiers 8 / 64 / 512 (shared memory) and 4096 (the
    chains in global memory), padding slots, the int32 clock edge."""
    rng = np.random.default_rng(tier + n_real)
    cols = [_t(a) for a in _cmd_columns(rng, cap, kcap)]
    ops = [_t(a) for a in _cmd_ops(
        rng, n_real, tier, rows=rng.choice(cap, nrows, replace=False),
        kids=rng.choice(kcap, max(4, nrows // 3), replace=False), now=16)]
    scal = (1, I32_MIN + 1, ((0x8000 << 16) | 1) - (1 << 31), 3)
    plain = tk.cmd_tick_plain(*cols, clock, *ops, *scal, promote=promote)
    n0 = tk.LAUNCHES["cmd_tick"]
    got = tk.cmd_tick(*(c.to(cuda) for c in cols), clock,
                      *(o.to(cuda) for o in ops), *scal, promote=promote)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["cmd_tick"] == n0 + 1
    _eq(plain, got)
    blk = tk.cmd_tick_readback(got)
    assert tk.cmd_checksum_host(blk[:tier], blk[tier:2 * tier],
                                blk[2 * tier:5 * tier], int(blk[-2])) \
        == int(blk[-1]) & 0xFFFFFFFF


@pytest.mark.parametrize("cap,out_cap,now,stall", [
    (64, 4, 1000, 300), (1024, 2048, 1000, 0), (16384, 2048, 1000, 300),
    (16384, 256, I32_MIN, 1)])
def test_recovery_scan_kernel(cuda, cap, out_cap, now, stall):
    """K11 against recovery_scan_plain: band edges, touched past now,
    wrapping ages, out_cap below and above the count."""
    rng = np.random.default_rng(cap + out_cap)
    status = rng.integers(0, 12, cap).astype(np.int32)
    touched = rng.integers(0, 2000, cap).astype(np.int32)
    status[:6] = [0, 1, 8, 9, 10, 11]
    touched[6:12] = [1000, 1001, 700, 5000, 2 ** 31 - 1, I32_MIN]
    plain = tk.recovery_scan_plain(_t(status), _t(touched), now, stall,
                                   out_cap)
    n0 = tk.LAUNCHES["recovery_scan"]
    got = tk.recovery_scan(_t(status).to(cuda), _t(touched).to(cuda), now,
                           stall, out_cap)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["recovery_scan"] == n0 + 1
    _eq(plain, got)


@pytest.mark.parametrize("cap,kcap,m,k", [(64, 32, 8, 8),
                                          (16384, 1024, 64, 64)])
def test_cmd_repair_kernel(cuda, cap, kcap, m, k):
    """K12 against cmd_repair_plain; padding indices cap / kcap drop."""
    rng = np.random.default_rng(cap + m)
    cols = [_t(a) for a in _cmd_columns(rng, cap, kcap)]
    nr, nk = m - 3, k - 2
    rows_idx = np.full(m, cap, np.int32)
    rows_idx[:nr] = np.sort(rng.choice(cap, nr, replace=False))
    kid_idx = np.full(k, kcap, np.int32)
    kid_idx[:nk] = np.sort(rng.choice(kcap, nk, replace=False))
    vals = [_t(a) for a in (
        rows_idx, rng.integers(0, 12, m).astype(np.int32),
        rng.integers(0, 2, m).astype(np.int32), _cmd_lanes(rng, m),
        _cmd_lanes(rng, m), _cmd_lanes(rng, m),
        rng.integers(0, 5, m).astype(np.int32), kid_idx,
        _cmd_lanes(rng, k), rng.random(k) < 0.5)]
    plain = tk.cmd_repair_plain(*cols, *vals)
    n0 = tk.LAUNCHES["cmd_repair"]
    got = tk.cmd_repair(*(c.to(cuda) for c in cols),
                        *(v.to(cuda) for v in vals))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["cmd_repair"] == n0 + 1
    _eq(plain, got)


def test_cmd_plane_burn_matches_cpu(cuda):
    """A contended burn with the cmd planes on the card (authoritative, a
    device recovery scan): history and every plane counter equal to the
    same burn's with the planes on the CPU; cmd_tick launched once per
    dispatch."""
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    def leg(device):
        cfg = ClusterConfig(cmd_plane=True, cmd_device=device,
                            cmd_plane_authoritative=True, durability=True,
                            recovery_scan="device", progress_stall_ms=300.0)
        r = run_burn(23, ops=60, write_ratio=0.95, key_count=3,
                     chaos_drop=0.05, collect_log=True, config=cfg)
        return r, {k: v for k, v in r.counters.items()
                   if k.startswith(("cmd_", "recovery_scan_"))
                   and not k.endswith("_s")}

    n0 = tk.LAUNCHES["cmd_tick"]
    card, card_counters = leg("cuda")
    torch.cuda.synchronize()
    cpu, cpu_counters = leg("cpu")
    assert card.log == cpu.log and card.lost == 0
    assert card_counters == cpu_counters
    assert card_counters["cmd_plane_dispatches"] > 0
    assert card_counters.get("cmd_plane_checksum_mismatches", 0) == 0
    assert tk.LAUNCHES["cmd_tick"] - n0 == \
        card_counters["cmd_plane_dispatches"]


# -- the cluster tick: K13-K16 and the protocol megakernel's graph ----------
def _deep(x, dev):
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_deep(v, dev) for v in x)
    return x


def _key_plan(rng, b, caps, k, fused):
    ng = len(caps)
    n = b - 2
    store = np.full(b, ng, np.int32)
    store[:n] = rng.integers(0, ng, n)
    nnz = 4 * b
    subj_of = np.full(nnz, b, np.int32)
    subj_of[:3 * b] = np.sort(rng.integers(0, n, 3 * b))
    subj_keys = rng.integers(0, k, nnz).astype(np.int32)
    args = dict(sb=rng.integers(-50, 50, (b, 3)).astype(np.int32),
                sknd=rng.integers(0, 6, b).astype(np.int32),
                subj_store=store, subj_of=subj_of, subj_keys=subj_keys,
                ngroups=ng, slots=list(range(ng)), fused=fused,
                ksnaps=[_arena(rng, c, k) for c in caps])
    if fused:
        args["pad_tier"] = None
    return args


def _range_plan(rng, b, rcaps, kcaps, k, has_r=True, has_k=True):
    ng = max(len(rcaps), len(kcaps), 1)
    iv_of, iv_s, iv_e, sb, sknd, srng = (
        t.numpy() for t in _intervals(rng, b, 4 * b))
    store = np.full(b, ng, np.int32)
    store[:b - 2] = rng.integers(0, ng, b - 2)
    return dict(iv_of=iv_of, iv_s=iv_s, iv_e=iv_e, sb=sb, sknd=sknd,
                srng=srng, subj_store=store, ngroups=ng,
                r_slots=list(range(len(rcaps))),
                rsnaps=[_range_arena(rng, c) for c in rcaps],
                k_slots=list(range(len(kcaps))),
                ksnaps=[_arena(rng, c, k) for c in kcaps],
                has_r=has_r, has_k=has_k, fused=True, pad_tier=None)


def _pads(k):
    def key(cap):
        return (torch.zeros((cap, k // 32), dtype=torch.int32),
                torch.zeros((cap, 3), dtype=torch.int32),
                torch.zeros(cap, dtype=torch.int32),
                torch.zeros(cap, dtype=torch.bool))

    def rng_(cap):
        return (torch.zeros(cap, dtype=torch.int32),
                torch.zeros(cap, dtype=torch.int32),
                torch.zeros((cap, 3), dtype=torch.int32),
                torch.zeros(cap, dtype=torch.int32),
                torch.zeros(cap, dtype=torch.bool))
    return key, rng_


def _merges(seed, k=128):
    from accord_tpu_torch.ops import node_lane as nl
    rng = np.random.default_rng(seed)
    pad_key, pad_rng = _pads(k)
    kplans = [_key_plan(rng, 8, (64,), k, False),
              _key_plan(rng, 64, (128, 128), k, True),
              _key_plan(rng, 8, (64, 128), k, True),
              _key_plan(rng, 64, (64, 64, 64), k, True)]
    rplans = [_range_plan(rng, 8, (64,), (64,), k),
              _range_plan(rng, 64, (64, 96), (128, 128), k),
              _range_plan(rng, 8, (32,), (64,), k, has_k=False)]
    km = nl.build_key_merge(list(enumerate(kplans)), pad_key)
    rm = nl.build_range_merge(list(enumerate(rplans)), pad_key, pad_rng)
    return km, rm


def _key_in(km):
    return (km.subj_of, km.subj_keys, km.subj_node, km.sb, km.sknd,
            km.slots, km.blocks)


def _rng_in(rm):
    return (rm.iv_of, rm.iv_s, rm.iv_e, rm.subj_node, rm.sb, rm.sknd,
            rm.srng, rm.r_slots, rm.r_blocks, rm.k_slots, rm.k_blocks)


@pytest.mark.parametrize("seed", [1, 2])
def test_node_lane_kernels(cuda, seed):
    """K13 and K14 (both sides, and each side alone) against their plain
    versions on merges with pad blocks, multi-block and mixed-cap spans;
    one launch each."""
    from accord_tpu_torch.ops import node_lane as nl
    km, rm = _merges(seed)
    wt = _t(WITNESS_TABLE)
    plain = nl.node_fused_deps_resolve(*_key_in(km), wt)
    n0 = tk.LAUNCHES["node_deps_resolve"]
    got = nl.node_fused_deps_resolve(*_deep(_key_in(km), cuda), wt.to(cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["node_deps_resolve"] == n0 + 1
    _eq(plain, got)
    assert plain.any()
    args = _rng_in(rm)
    for r_on, k_on in ((True, True), (True, False), (False, True)):
        a = list(args)
        if not r_on:
            a[8] = ()
        if not k_on:
            a[10] = ()
        plain = nl.node_fused_range_deps_resolve(*a, wt)
        got = nl.node_fused_range_deps_resolve(*_deep(a, cuda), wt.to(cuda))
        _eq(plain, got)


@pytest.mark.parametrize("r0,w0,rows,words", [(0, 0, 64, 8), (7, 3, 8, 4),
                                              (300, 100, 64, 64),
                                              (-5, -2, 8, 4)])
def test_lane_slice_kernel(cuda, r0, w0, rows, words):
    """K15 against its plain version, offsets by value and from device
    memory, clamped and negative starts included."""
    from accord_tpu_torch.ops import node_lane as nl
    rng = np.random.default_rng(rows + words)
    src = _t(_words(rng, (256, 96)))
    plain = nl.lane_slice(src, r0, w0, rows, words)
    got = nl.lane_slice(src.to(cuda), r0, w0, rows, words)
    _eq(plain, got)
    offs = torch.tensor([r0, w0], dtype=torch.int32, device=cuda)
    _eq(plain, nl.lane_slice(src.to(cuda), offs, None, rows, words))


def test_lane_slice_many_kernel(cuda):
    """K15's window table against its plain version: two sources, negative
    and clamped offsets, 16-byte and 4-byte windows, one launch for 200
    windows (the large table) and two for 1,100."""
    from accord_tpu_torch.ops import node_lane as nl
    rng = np.random.default_rng(15)
    packed = (_t(_words(rng, (256, 96))), _t(_words(rng, (128, 33))))
    spans = [(0, 0, 0, 64, 8), (1, 7, 3, 8, 4), (0, 300, 100, 64, 64),
             (0, -5, -2, 8, 4), (1, 120, 30, 16, 5), (0, 4, 4, 1, 92)]
    for n in (6, 200, 1100):
        win = list(spans)
        while len(win) < n:
            s = int(rng.integers(0, 2))
            nr, nw = packed[s].shape
            rows, words = int(rng.integers(0, 40)), int(rng.integers(0, nw))
            win.append((s, int(rng.integers(-nr, nr)),
                        int(rng.integers(-nw, nw)), rows, words))
        plain = nl.lane_slice_many(packed, win)
        n0 = tk.LAUNCHES["lane_slice"]
        got = nl.lane_slice_many(tuple(_on(packed, cuda)), win)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["lane_slice"] == n0 + -(-n // 1024)
        _eq(plain, got)


def _quorum(rng, t):
    n = t - t // 5
    pool = rng.integers(-5, 5, (max(2, n // 3), 3)).astype(np.int32)
    txn = np.zeros((t, 3), np.int32)
    txn[:n] = pool[rng.integers(0, len(pool), n)]
    ts = np.full((t, 3), I32_MIN, np.int32)
    ts[:n] = np.where(rng.random((n, 1)) < 0.7, txn[:n],
                      rng.integers(-5, 5, (n, 3)))
    code = np.zeros(t, np.int32)
    code[:n] = rng.choice([0, 0, 0, 1, 2, 8, 9, -1], n)
    valid = np.zeros(t, bool)
    valid[:n] = True
    return txn, ts, code, valid


@pytest.mark.parametrize("t", [64, 256, 1024, *QUORUM_CARD_TIERS,
                               *QUORUM_CASES], ids=str)
def test_quorum_count_kernel(cuda, t):
    """K16 against its plain version, ONE launch a call: at each lane tier
    (one CTA and a cluster of 1 at 64 lanes; clusters of 2 and 8; above
    the ladder at 8,192 and 16,384, a CTA looping over several chunks of
    its slice) and on the shared cases the CPU tests hold the plain
    version to the JAX stage on. The occupancy API places the cluster."""
    if isinstance(t, str):
        lanes, qsize = quorum_case(t)
        lanes = [_t(a) for a in lanes]
    else:
        lanes, qsize = [_t(a) for a in _quorum(np.random.default_rng(t),
                                               t)], 2
    n = lanes[0].shape[0]
    plain = tk.quorum_count(*lanes, qsize)
    n0 = tk.LAUNCHES["quorum_count"]
    got = tk.quorum_count(*(x.to(cuda) for x in lanes), qsize)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["quorum_count"] == n0 + 1
    _eq(plain, got)
    geo = tk.quorum_geometry(n)
    assert geo["max_active"] >= 1, geo
    if n == 64:
        assert geo["cluster"] == 1, geo
    if n == 4096:
        # the 10k tick's tier: clusters of 8, every one resident at once
        assert geo["cluster"] == 8, geo
        assert geo["max_active"] >= geo["clusters"], geo


@pytest.mark.parametrize("t", [100, 4096])
def test_quorum_stage_replays_twice(cuda, t):
    """K16 as the megakernel's quorum stage: a protocol_tick graph of the
    stage alone, called twice with the same lanes and then with new lanes
    of the same shape (each call after the first a replay of its graph),
    equal to the plain version every time."""
    wt = _t(WITNESS_TABLE)
    c0 = tk.CAPTURES["protocol_tick"]
    l0 = tk.LAUNCHES["quorum_count"]
    for seed in (t, t, t + 1):
        lanes = quorum_lanes(t, seed)
        plain = tk.quorum_count(*(_t(a) for a in lanes), 3)
        got = tk.protocol_tick(wt.to(cuda), quorum=lanes, quorum_size=3)[4]
        torch.cuda.synchronize()
        _eq(plain, got)
    assert tk.CAPTURES["protocol_tick"] - c0 <= 1
    assert tk.LAUNCHES["quorum_count"] - l0 == 3


def test_quorum_and_max_conflict_one_kernel_a_call(cuda):
    """One K16 call (a cluster of 1 at 64 lanes, of 8 at 4,096) and one K7
    call (pads beside a live subject), each captured in a CUDA graph, is
    ONE kernel node and no other (no memset or copy)."""
    calls = []
    for t in (64, 4096):
        lanes = [_t(a).to(cuda) for a in quorum_lanes(t, t)]
        calls.append(lambda lanes=lanes: tk.quorum_count(*lanes, 2))
    subj, bits, ex, valid = conflict_case("ties_in_last_batch")
    args = _on([_t(pack_words(subj)), _t(pack_words(bits)), _t(ex),
                _t(valid)], cuda)
    calls.append(lambda: tk.max_conflict(*args))
    for fn in calls:
        assert _graph_node_types(fn) == [0]


def _fin_key(rng, kind, span, k_w, out_cap, kc=40):
    r0, b, w0, words = span
    kid_rows = _words(rng, (kc, k_w))
    s = 32
    slot_subj = np.full(s, b, np.int32)
    slot_subj[:s - 4] = rng.integers(0, b, s - 4)
    slot_kid = np.full(s, kc, np.int32)
    slot_kid[:s - 4] = rng.integers(0, kc, s - 4)
    subj_row = rng.integers(-1, 32 * k_w, b).astype(np.int32)
    act_ts = rng.integers(-40, 40, (32 * k_w, 3)).astype(np.int32)
    return (kind, r0, w0, b, words, int(rng.integers(0, words - k_w + 1)),
            _t(kid_rows), _t(slot_subj), _t(slot_kid), _t(subj_row),
            _t(act_ts), out_cap)


def _fin_range(rng, b, rcap, out_cap):
    iv_of, iv_s, iv_e, sb, sknd, _srng = _intervals(rng, b, 32)
    return ("range", iv_of, iv_s, iv_e, _t(rng.random(32) < 0.8), sb, sknd,
            tuple(_range_arena(rng, rcap)), out_cap)


def _tick(seed):
    """One cluster tick with every stage protocol_tick has on the card:
    key and range resolves, key / rkey / range finalizes given out of
    signature order, a cmd_tick block, a repair block, an exec block and
    the quorum lanes. Shapes depend only on the structure, so two seeds
    share one static signature."""
    rng = np.random.default_rng(seed)
    km, rm = _merges(seed)
    fins = (_fin_range(rng, 16, 64, 256),
            _fin_key(rng, "key", km.spans[1], 4, 2048),
            _fin_key(rng, "key", km.spans[0], 2, 256),
            _fin_range(rng, 8, 32, 2048),
            _fin_key(rng, "rkey", rm.spans[1][:2] + rm.spans[1][4:], 4, 256))
    cap, kcap = 64, 32
    cols = [_t(a) for a in _cmd_columns(rng, cap, kcap)]
    ops = [_t(a) for a in _cmd_ops(rng, 6, 8, rows=np.arange(cap),
                                   kids=np.arange(kcap), now=500)]
    cmd = (*cols, 40, *ops, 1, I32_MIN + 1, -200, 2, True)
    rcols = [_t(a) for a in _cmd_columns(rng, cap, kcap)]
    rows_idx = np.full(8, cap, np.int32)
    rows_idx[:5] = np.sort(rng.choice(cap, 5, replace=False))
    kid_idx = np.full(8, kcap, np.int32)
    kid_idx[:6] = np.sort(rng.choice(kcap, 6, replace=False))
    rep = (*rcols, *(_t(a) for a in (
        rows_idx, rng.integers(0, 12, 8).astype(np.int32),
        rng.integers(0, 2, 8).astype(np.int32), _cmd_lanes(rng, 8),
        _cmd_lanes(rng, 8), _cmd_lanes(rng, 8),
        rng.integers(0, 5, 8).astype(np.int32), kid_idx, _cmd_lanes(rng, 8),
        rng.random(8) < 0.5)))
    planes = (tuple(_exec_plane(rng, 64)), tuple(_exec_plane(rng, 96)))
    return dict(key_in=_key_in(km), rng_in=_rng_in(rm), fins=fins,
                cmds=(cmd,), quorum=_quorum(rng, 64), quorum_size=2,
                cmd_repairs=(rep,), execs=((planes, 256),))


def test_protocol_tick_graph_matches_plain(cuda):
    """The graph program against the plain protocol_tick: every output
    bit-equal, one replay, each stage kernel counted once."""
    wt = _t(WITNESS_TABLE)
    kw = _tick(5)
    plain = tk.protocol_tick(wt, **kw)
    l0 = dict(tk.LAUNCHES)
    got = tk.protocol_tick(wt.to(cuda), **_deep(kw, cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["protocol_tick"] == l0["protocol_tick"] + 1
    for name, n in (("node_deps_resolve", 1), ("node_range_resolve", 1),
                    ("finalize_csr_tab", 1), ("finalize_csr", 0),
                    ("range_finalize", 2),
                    ("cmd_tick", 1), ("quorum_count", 1), ("cmd_repair", 1),
                    ("frontier_compact", 1)):
        assert tk.LAUNCHES[name] == l0[name] + n, name
    _eq(plain, got)
    for fin in plain[2]:
        assert int(fin[0][-1]) > 0


def test_protocol_tick_graph_replays_new_snapshots(cuda):
    """Two ticks of one signature with new arena tensors and values: the
    second replays the first's graph (no capture), and the first tick's
    outputs are still intact after the second ran."""
    wt = _t(WITNESS_TABLE)
    a, b = _tick(6), _tick(7)
    pa, pb = tk.protocol_tick(wt, **a), tk.protocol_tick(wt, **b)
    c0 = tk.CAPTURES["protocol_tick"]
    ga = tk.protocol_tick(wt.to(cuda), **_deep(a, cuda))
    c1 = tk.CAPTURES["protocol_tick"]
    gb = tk.protocol_tick(wt.to(cuda), **_deep(b, cuda))
    torch.cuda.synchronize()
    assert tk.CAPTURES["protocol_tick"] == c1 <= c0 + 1
    _eq(pb, gb)
    _eq(pa, ga)


def test_protocol_tick_graph_cache_evicts_oldest(cuda, monkeypatch):
    """With room for one graph, a second signature evicts the first
    (counted); the evicted graph's outputs stay intact, and the first
    signature's next call captures again and still matches the plain
    version."""
    from collections import OrderedDict
    from accord_tpu_torch.ops import tick_graph
    monkeypatch.setattr(tick_graph, "_GRAPHS", OrderedDict())
    monkeypatch.setattr(tick_graph, "MAX_GRAPHS", 1)
    wt = _t(WITNESS_TABLE)
    a = _tick(8)
    b = dict(a, execs=())                  # another signature
    pa, pb = tk.protocol_tick(wt, **a), tk.protocol_tick(wt, **b)
    c0, e0 = tk.CAPTURES["protocol_tick"], tk.CAPTURES["evictions"]
    ga = tk.protocol_tick(wt.to(cuda), **_deep(a, cuda))
    gb = tk.protocol_tick(wt.to(cuda), **_deep(b, cuda))
    ga2 = tk.protocol_tick(wt.to(cuda), **_deep(a, cuda))
    torch.cuda.synchronize()
    assert tk.CAPTURES["protocol_tick"] == c0 + 3
    assert tk.CAPTURES["evictions"] == e0 + 2
    assert tick_graph.cache_stats()["graphs"] == 1
    _eq(pa, ga)
    _eq(pb, gb)
    _eq(pa, ga2)


def test_megakernel_burn_card_matches_cpu_no_capture_after_warmup(cuda):
    """The crash-restart megakernel burn (a node's lane pads out and back
    under pad_node_tiers): the card's history is the CPU's, one replay per
    dispatching tick, and a second run of the same traffic captures no
    graph."""
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    kw = dict(nodes=4, crash_restart=True, crash_down_ms=400.0,
              pad_node_tiers=8, megakernel=True, collect_log=True)
    cpu, _ = run_mesh_burn(29, 70, device="cpu", **kw)
    run_mesh_burn(29, 70, device=cuda, **kw)
    c0 = tk.CAPTURES["protocol_tick"]
    p0 = tk.LAUNCHES["protocol_tick"]
    card, eng = run_mesh_burn(29, 70, device=cuda, **kw)
    snap = eng.snapshot()
    assert tk.CAPTURES["protocol_tick"] == c0
    assert card.log == cpu.log
    assert snap["launches_per_tick"] == 1.0
    assert tk.LAUNCHES["protocol_tick"] - p0 == \
        snap["megakernel_dispatches"] > 0


# -- K17: the mailbox routing stage; K18-K21: the execute-DAG kernels -------
@pytest.mark.parametrize("n,depth,words,lanes,n_emit", [
    (4, 4, 8, 8, 5), (16, 8, 384, 64, 64), (63, 64, 384, 1024, 700)])
def test_mailbox_route_kernel(cuda, n, depth, words, lanes, n_emit):
    """K17 on the card = its plain version on the CPU: arena and meta
    updated in place, the landed gather-back, land; with a cut link, pads,
    and a landed emit at node n, slot depth-1 (where every non-landing
    emit gathers back, after the scatter)."""
    from accord_tpu_torch.ops.mailbox import mailbox_route, \
        mailbox_route_plain
    rng = np.random.default_rng(lanes + n)
    rows = (n + 1) * depth
    arena = rng.integers(-50, 50, (rows, words)).astype(np.int32)
    meta = rng.integers(-5, 5, (rows, 3)).astype(np.int32)
    pick = rng.choice(n * depth, n_emit, replace=False)
    dst = np.zeros(lanes, np.int32)
    slot = np.zeros(lanes, np.int32)
    dst[:n_emit], slot[:n_emit] = 1 + pick // depth, pick % depth
    src = np.zeros(lanes, np.int32)
    src[:n_emit] = rng.integers(1, n + 1, n_emit)
    keep = np.zeros(lanes, bool)
    keep[:n_emit] = True
    hit = np.nonzero((dst == n) & (slot == depth - 1))[0]
    if hit.size == 0:
        dst[0], slot[0] = n, depth - 1
        keep[np.nonzero((dst == n) & (slot == depth - 1))[0][1:]] = False
    src[0] = dst[0]
    part = np.zeros((n + 1, n + 1), bool)
    part[1, 2] = part[2, 1] = True
    src[1], dst[1], keep[1] = 1, 2, True
    kind = rng.integers(1, 20, lanes).astype(np.int32)
    seq = rng.integers(0, 1 << 31, lanes).astype(np.int32)
    w = rng.integers(-(1 << 31), 1 << 31, (lanes, words)).astype(np.int32)
    lanes_ = [_t(x) for x in (src, dst, slot, keep, kind, seq, w)]
    plain = mailbox_route_plain(_t(arena).clone(), _t(meta).clone(),
                                *lanes_, _t(part))
    a, m = _t(arena).to(cuda), _t(meta).to(cuda)
    got = mailbox_route(a, m, *(x.to(cuda) for x in lanes_),
                        _t(part).to(cuda))
    torch.cuda.synchronize()
    assert got[0] is a and got[1] is m
    _eq(plain, got)


@pytest.mark.parametrize("b,a,k", [(37, 70, 96), (256, 1000, 1024),
                                   (64, 130, 32)])
def test_deps_matrix_kernel(cuda, b, a, k):
    rng = np.random.default_rng(b + a)
    sw = _words(rng, (b, k // 32)) & _words(rng, (b, k // 32)) \
        & _words(rng, (b, k // 32))
    aw = _words(rng, (a, k // 32)) & _words(rng, (a, k // 32)) \
        & _words(rng, (a, k // 32))
    sb = rng.integers(-3, 3, (b, 3)).astype(np.int32)
    ts = rng.integers(-3, 3, (a, 3)).astype(np.int32)
    ts[::5, 0] = I32_MIN
    ts[1] = sb[0]
    sk = rng.integers(-2, 8, b).astype(np.int32)
    ak = rng.integers(-8, 8, a).astype(np.int32)
    valid = rng.random(a) < 0.8
    args = [_t(x) for x in (sw, sb, sk, aw, ts, ak, valid, WITNESS_TABLE)]
    plain = tk.deps_matrix(*args)
    got = tk.deps_matrix(*(x.to(cuda) for x in args))
    torch.cuda.synchronize()
    _eq(plain, got)
    assert plain.any()


def _wave_big(name, dev):
    """(adj bool[n, n] made on the card, max_levels) of a K20 card case:
    dag_8192_64 a lower-triangular DAG of 8,192 rows, each edge with
    probability 1/256 (bench_dag's density; deeper than 64), at 64
    levels; dense_2048 a lower-triangular DAG of density 1/2 over 2,048
    rows (most rows' columns do not fit the kernel's shared memory: read
    packed from L2), 40 levels; n_32768 32,768 rows of density 1/4,096,
    6 levels (the levels, 128 KB, read from L2)."""
    n, p, levels = {"dag_8192_64": (8192, 1 / 256, 64),
                    "dense_2048": (2048, 0.5, 40),
                    "n_32768": (32768, 1 / 4096, 6)}[name]
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    adj = torch.rand(n, n, device=dev, generator=gen) < p
    return torch.tril(adj, -1), levels


@pytest.mark.parametrize("case", [
    pytest.param((50, 0.04, False), id="50-0.04-False"),
    pytest.param((300, 0.01, True), id="300-0.01-True"),
    pytest.param((1024, 0.004, True), id="1024-0.004-True"),
    *WAVEFRONT_CASES, "dag_8192_64", "dense_2048", "n_32768"])
def test_closure_and_wavefront_kernels(cuda, case):
    """K19 and K20 = their plain versions, iterations/levels below and
    above the depth, with a cycle where dag is False; K20 on the shared
    cases (one block: up to 128 rows, the levels in shared memory) and,
    against the plain version run on the card, at N 8,192 with 64 levels,
    on rows too wide for shared memory and at N 32,768 (levels read from
    L2)."""
    if isinstance(case, str) and case not in WAVEFRONT_CASES:
        adj, levels = _wave_big(case, cuda)
        got = tk.execution_wavefronts(adj, levels)
        torch.cuda.synchronize()
        _eq(tk.execution_wavefronts_plain(adj, levels).cpu(), got)
        return
    if isinstance(case, str):
        adj, levels = wavefront_case(case)
        wave = (levels,)
    else:
        n, p, dag = case
        rng = np.random.default_rng(n)
        adj = rng.random((n, n)) < p
        if dag:
            adj = np.tril(adj, -1)
        wave = (0, 3, 40)
    t = _t(adj)
    for it in (0, 2, 11):
        _eq(tk.transitive_closure(t, it),
            tk.transitive_closure(t.to(cuda), it))
    for lv in wave:
        n0 = tk.LAUNCHES["execution_wavefronts"]
        _eq(tk.execution_wavefronts(t, lv),
            tk.execution_wavefronts(t.to(cuda), lv))
        assert tk.LAUNCHES["execution_wavefronts"] == n0 + 1
    torch.cuda.synchronize()


def test_execution_wavefronts_one_kernel_graph_replays(cuda):
    """One K20 call, captured in a CUDA graph, is ONE kernel node (no
    memset or copy), one block or many, levels cut or past the fixpoint;
    replayed twice (its barrier flags zero again after every call) it
    equals the plain version both times, as does a call after a dirty
    barrier generation."""
    for name, n in (("cycle_levels_40", 96), ("dag", 1031)):
        adj = _t(wavefront_case(name)[0] if n == 96
                 else closure_case("dag", n))
        c_adj = adj.to(cuda)
        for lv in (0, 3, 40):
            assert _graph_node_types(
                lambda: tk.execution_wavefronts(c_adj, lv)) == [0], (n, lv)
            plain = tk.execution_wavefronts(adj, lv)
            for out in _graph_twice(
                    lambda: tk.execution_wavefronts(c_adj, lv)):
                _eq(plain, out)
    # nine blocks at 1,031 rows: the barrier's flags, dirty generation
    idx = torch.cuda.current_device()
    flags = tk._SCRATCH[idx][:tk._DAG_FLAG_BYTES].view(torch.int32)
    flags[1] = 12345
    got = tk.execution_wavefronts(c_adj, 40)
    torch.cuda.synchronize()
    _eq(tk.execution_wavefronts(adj, 40), got)
    assert not bool(flags.any()), flags.cpu()


@pytest.mark.parametrize("n,p,levels", [(256, 0.03, 5), (4096, 0.002, 192)])
def test_dag_wavefronts_packed_kernel(cuda, n, p, levels):
    """K21 = its plain version: rounds cut below the depth, a cycle that
    never settles (-1)."""
    from accord_tpu_torch.ops import carry
    rng = np.random.default_rng(n + levels)
    adj = np.tril(rng.random((n, n)) < p, -1)
    adj[10, 11] = adj[11, 10] = True
    words = carry.packed_adjacency(adj)
    plain = tk.dag_wavefronts_packed(words, levels)
    got = tk.dag_wavefronts_packed(words.to(cuda), levels)
    torch.cuda.synchronize()
    _eq(plain, got)
    assert int(plain[10]) == -1


def test_message_plane_burn_card_matches_cpu(cuda):
    """bench_message_plane's config at 64 nodes, cut to 20 ops: the
    device-messages megakernel burn on the card commits the CPU's history
    with its mailbox counters, one replay a tick, K17 in the graph."""
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    kw = dict(nodes=64, rf=5, concurrency=24, megakernel=True,
              device_messages=True, collect_log=True)
    cpu, _ = run_mesh_burn(6, 20, device="cpu", **kw)
    k0 = tk.LAUNCHES["mailbox_route"]
    card, eng = run_mesh_burn(6, 20, device=cuda, **kw)
    c = card.counters
    assert card.log == cpu.log
    assert {k: v for k, v in c.items() if "mailbox" in k} == \
        {k: v for k, v in cpu.counters.items() if "mailbox" in k}
    assert c["launches_per_tick"] == 1.0
    assert c["mailbox_verify_fallbacks"] == 0
    assert c["device_messages_delivered"] > 0
    assert tk.LAUNCHES["mailbox_route"] > k0
    assert eng._net._plane.arena.is_cuda


def test_protocol_tick_mailbox_stage_matches_plain(cuda):
    """The mailbox stage inside the tick's graph (arena through the param
    table, updated in place) = the plain protocol_tick, on two ticks of
    one signature (the second replays with new lanes)."""
    from accord_tpu_torch.ops.mailbox import MailboxPlane
    rng = np.random.default_rng(31)
    planes = (MailboxPlane(6, depth=4, words=16, device="cpu"),
              MailboxPlane(6, depth=4, words=16, device=cuda))

    class E:
        def __init__(self, i):
            self.src, self.dst = (int(x) for x in rng.choice(
                np.arange(1, 7), 2, replace=False))
            self.kind, self.ticket = 1 + i % 5, 1000 + i
            self.payload = rng.bytes(int(rng.integers(0, 60)))

    c0 = tk.CAPTURES["protocol_tick"]
    for tick in range(2):
        ents = [E(10 * tick + i) for i in range(7)]
        outs = []
        for plane in planes:
            plane.set_partitions({frozenset((1, 2))}, version=tick)
            block = plane.stage_batch(ents)
            wt = _t(WITNESS_TABLE).to(plane.device)
            out = tk.protocol_tick(wt, mailbox=block)[5]
            plane.adopt(out)
            outs.append(out)
        torch.cuda.synchronize()
        _eq(outs[0], outs[1])
        assert outs[1][0] is planes[1].arena
    assert tk.CAPTURES["protocol_tick"] - c0 == 1


# K17's clamped-row cases: (n, depth, W, L), each with n >= 3 and L >= 8
ROUTE_CASE_SHAPES = ((4, 4, 8, 16), (5, 3, 7, 24), (6, 4, 640, 40),
                     (63, 64, 384, 1024))


def _route_inputs(shape, hazard):
    rng = np.random.default_rng(sum(shape) + ROUTE_HAZARDS.index(hazard))
    ins, writers = route_case(rng, *shape, hazard)
    plain = tmb.mailbox_route_plain(_t(ins[0]).clone(), _t(ins[1]).clone(),
                                    *(_t(x) for x in ins[2:9]), _t(ins[9]))
    return ins, writers, plain


@pytest.mark.parametrize("hazard", ROUTE_HAZARDS)
@pytest.mark.parametrize("shape", ROUTE_CASE_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_mailbox_route_clamped_rows_kernel(cuda, shape, hazard):
    """K17's ONE launch = its plain version where a gather-back reads a
    clamped row another lane lands on in the same launch, a negative dst
    wraps once, a flat falls below -rows or past the arena, or every link
    is cut (tests/torch_kernel_cases.route_case); W 7 moves words one by
    one, W 640 past a lane's first four 16-byte vectors."""
    ins, writers, plain = _route_inputs(shape, hazard)
    a, m = _t(ins[0]).to(cuda), _t(ins[1]).to(cuda)
    n0 = tk.LAUNCHES["mailbox_route"]
    got = tmb.mailbox_route(a, m, *ins[2:9], _t(ins[9]).to(cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["mailbox_route"] == n0 + 1
    assert got[0] is a and got[1] is m
    _eq(plain, got)
    words = _t(ins[8])
    for q in writers:        # the write is read back somewhere else
        assert int((plain[2] == words[q]).all(1).sum()) > 1


def test_mailbox_route_one_kernel_a_call(cuda):
    """One K17 call (lanes already on the card), captured in a CUDA graph,
    is ONE kernel node: the scatter and the gather-back in one launch, no
    memset or copy."""
    ins, _w, _p = _route_inputs(ROUTE_CASE_SHAPES[3], "last_row")
    a, m, *lanes, part = (_t(x).to(cuda) for x in ins)
    assert _graph_node_types(lambda: tmb.mailbox_route(
        a, m, *lanes, part)) == [0]


@pytest.mark.parametrize("hazard", ROUTE_HAZARDS)
def test_protocol_tick_mailbox_stage_clamped_rows(cuda, hazard):
    """The mailbox stage inside the tick's graph (K17 through the param
    table) = the plain version on each clamped-row case, the arena and
    meta updated in place."""
    ins, _w, plain = _route_inputs(ROUTE_CASE_SHAPES[1], hazard)
    block = (_t(ins[0]).to(cuda), _t(ins[1]).to(cuda), *ins[2:9],
             _t(ins[9]).to(cuda))
    n0 = tk.LAUNCHES["mailbox_route"]
    got = tk.protocol_tick(_t(WITNESS_TABLE).to(cuda), mailbox=block)[5]
    torch.cuda.synchronize()
    assert tk.LAUNCHES["mailbox_route"] == n0 + 1
    assert got[0] is block[0] and got[1] is block[1]
    _eq(plain, got)


# -- the sharded deps data plane on a virtual mesh (cuda:0 x 8) ---------------
def _meshes(cuda):
    from accord_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(devices=["cpu"] * 8), make_mesh(devices=[cuda] * 8)


def _resolve_lanes(seed, cap, k, b, nnz=96):
    from accord_tpu_torch.ops import carry
    from accord_tpu_torch.parallel.mesh import example_resolve_batch
    lanes = example_resolve_batch(cap=cap, k=k, b=b, nnz=nnz, seed=seed)
    args = [_t(a) for a in lanes]
    args[4] = carry.packed(lanes[4])
    return args


def _range_lanes(rng, b, nv, rcap):
    s = rng.integers(0, 1 << 11, nv).astype(np.int32)
    e = (s + rng.integers(1, 40, nv)).astype(np.int32)
    e[3] = s[3] + 5000
    s[4], e[4] = I32_MIN + 5, np.iinfo(np.int32).max - 5
    of = rng.integers(0, b, nv).astype(np.int32)
    of[::7] = b
    rs = rng.integers(0, 1 << 11, rcap).astype(np.int32)
    ivs = [_t(of), _t(s), _t(e)]
    rar = (_t(rs), _t((rs + rng.integers(1, 300, rcap)).astype(np.int32)),
           _t(rng.integers(-50, 50, (rcap, 3)).astype(np.int32)),
           _t(rng.integers(0, 6, rcap).astype(np.int32)),
           _t(rng.random(rcap) < 0.9))
    return ivs, rar


def _counts_launched(before, names, counts=tk.LAUNCHES):
    for name in names:
        assert counts[name] > before[name], f"{name} never launched"


# the launches an eager sharded entry's one-card form never makes: a shard
# kernel's or a K22 combine's
ONE_CARD_ZERO = ("deps_resolve_shard", "range_resolve_shard",
                 "finalize_shard", "finalize_shard_tab", "or_fold",
                 "lane_concat", "counts_scan", "fragment_merge")


def _one_card_entry(mesh, name, entry, args, kw=None):
    """entry(*args, **kw) on a one-card mesh with card inputs: bit-equal to
    the per-shard form run on the same card; the launches made inside it
    equal its single-device twin's on the same inputs, and none is a shard
    kernel's or a K22 combine's. -> its outputs."""
    from accord_tpu_torch.parallel import mesh as pm
    from accord_tpu_torch.tools.sharded_eager_variants import _twin
    kw = kw or {}
    before, entries = dict(tk.LAUNCHES), dict(tk.ENTRY_LAUNCHES)
    got = entry(*args, **kw)
    torch.cuda.synchronize()
    made = tk.ENTRY_LAUNCHES[f"sharded_{name}"] \
        - entries[f"sharded_{name}"]
    for k in ONE_CARD_ZERO:
        assert tk.LAUNCHES[k] == before[k], f"{name}: {k} launched"
    t0 = sum(tk.LAUNCHES.values())
    _eq(tuple(x.cpu() for x in got) if isinstance(got, tuple)
        else got.cpu(), _twin(name)(*args, **kw))
    torch.cuda.synchronize()
    assert made == sum(tk.LAUNCHES.values()) - t0 > 0, name
    per = getattr(pm, f"per_shard_{name}")(mesh, *args, **kw)
    torch.cuda.synchronize()
    _eq(tuple(x.cpu() for x in per) if isinstance(per, tuple)
        else per.cpu(), got)
    return got


def test_sharded_resolves_kernels(cuda):
    """Every sharded resolve on the card's virtual 4 x 2 mesh and on
    make_mesh() = the same call on the CPU mesh (the per-shard plain
    chain) = the single-device kernel: on one card each entry is its
    single-device twin's launches, no shard kernel and no K22 combine,
    bit-equal to the per-shard form run on the same card (which launches
    the shard entries and K22's fold and concat)."""
    from accord_tpu_torch.parallel import mesh as pm
    cpu, card = _meshes(cuda)
    meshes = (card, pm.make_mesh(devices=[cuda]))
    rng = np.random.default_rng(7)
    before, entries = dict(tk.LAUNCHES), dict(tk.ENTRY_LAUNCHES)
    args = _resolve_lanes(1, 1024, 1024, 64)
    want = pm.sharded_deps_resolve(cpu)(*args)
    _eq(tk.deps_resolve(*args), want)
    for mesh in meshes:
        _eq(want, _one_card_entry(mesh, "deps_resolve",
                                  pm.sharded_deps_resolve(mesh),
                                  _deep(args, cuda)))
    # fused over two stores of different caps, then with a pad block
    b = 64
    subj = _resolve_lanes(2, 128, 1024, b)
    arenas = [tuple(_resolve_lanes(3 + s, cap, 1024, b)[4:8])
              for s, cap in enumerate((512, 256))]
    store = _t(rng.integers(0, 3, b).astype(np.int32))
    for sl in ([0, 1], [0, -1]):
        fargs = (subj[0], subj[1], store, subj[2], subj[3],
                 _t(np.array(sl, np.int32)), arenas, subj[8])
        want = pm.sharded_fused_deps_resolve(cpu, 2)(*fargs)
        for mesh in meshes:
            _eq(want, _one_card_entry(
                mesh, "fused_deps_resolve",
                pm.sharded_fused_deps_resolve(mesh, 2), _deep(fargs, cuda)))
    # range: one store, then fused 2 x 2, 1 x 0 and 0 x 2
    ivs, rar = _range_lanes(rng, b, 200, 256)
    sb, sknd, tab = subj[2], subj[3], subj[8]
    srng = _t(rng.random(b) < 0.5)
    key = tuple(_resolve_lanes(9, 512, 1024, b)[4:8])
    rargs = (*ivs, sb, sknd, srng, *rar, *key, tab)
    want = pm.sharded_range_deps_resolve(cpu)(*rargs)
    _eq(tk.range_deps_resolve(*rargs), want)
    assert bool((want[0] != 0).any()) and bool((want[1] != 0).any())
    for mesh in meshes:
        _eq(want, _one_card_entry(mesh, "range_deps_resolve",
                                  pm.sharded_range_deps_resolve(mesh),
                                  _deep(rargs, cuda)))
    for nr, nk in ((2, 2), (1, 0), (0, 2)):
        rars = tuple(_range_lanes(rng, b, 8, 128 * (s + 1))[1]
                     for s in range(nr))
        kars = tuple(tuple(_resolve_lanes(20 + s, 128 * (2 - s), 1024,
                                          b)[4:8]) for s in range(nk))
        fr = (*ivs, store, sb, sknd, srng, _t(np.arange(nr, dtype=np.int32)),
              rars, _t(np.arange(nk, dtype=np.int32)), kars, tab)
        want = pm.sharded_fused_range_deps_resolve(cpu, nr, nk)(*fr)
        for mesh in meshes:
            _eq(want, _one_card_entry(
                mesh, "fused_range_deps_resolve",
                pm.sharded_fused_range_deps_resolve(mesh, nr, nk),
                _deep(fr, cuda)))
    torch.cuda.synchronize()
    _counts_launched(before, ("deps_resolve_shard", "range_resolve_shard",
                              "or_fold", "lane_concat",
                              "deps_resolve_one_card", "node_deps_one_card",
                              "range_resolve_one_card",
                              "node_range_one_card"))
    _counts_launched(entries, ("sharded_deps_resolve",
                               "sharded_fused_deps_resolve",
                               "sharded_range_deps_resolve",
                               "sharded_fused_range_deps_resolve"),
                     tk.ENTRY_LAUNCHES)


@pytest.mark.parametrize("s,out_cap,spans,off,density", [
    (32, 256, 1, 0, 0.004), (64, 256, 2, 16, 0.02), (33, 64, 1, 0, 0.5),
    (32, 256, 2, 40, 0.02), (4096, 1 << 15, 1, 0, 0.01)])
def test_sharded_finalize_kernel(cuda, s, out_cap, spans, off, density):
    """The sharded finalize on the card's virtual 4 x 2 mesh and on
    make_mesh() = the CPU mesh's = K2, fitting and overflowing, at word_off
    != 0, past words - w (the clamp) and with S % model != 0 (the bound
    unsplit): on one card ONE K2 launch, no shard or K22 launch, bit-equal
    to the per-shard form on the same card."""
    from accord_tpu_torch.parallel import mesh as pm
    cpu, card = _meshes(cuda)
    rng = np.random.default_rng(s + off)
    cap = 32 * 4 * 4 if s < 1000 else 16384
    w = cap // 32
    b, kc = 16 if s < 1000 else 4096, 128 if s < 1000 else 4096

    def words(rows, n, p):
        return _t(np.packbits(rng.random((rows, n, 32)) < p, axis=-1,
                              bitorder="little").view(np.int32)
                  .reshape(rows, n))

    args = (words(b, spans * w, density), off, words(kc, w, 0.1),
            _t(rng.integers(-1, b + 2, s).astype(np.int32)),
            _t(rng.integers(0, kc + 1, s).astype(np.int32)),
            _t(rng.integers(-1, cap, b).astype(np.int32)),
            _t(rng.integers(0, 1 << 20, (cap, 3)).astype(np.int32)))
    before, entries = dict(tk.LAUNCHES), dict(tk.ENTRY_LAUNCHES)
    want = pm.sharded_finalize_csr(cpu)(*args, out_cap=out_cap)
    _eq(tk.finalize_csr(*args, out_cap=out_cap), want)
    for mesh in (card, pm.make_mesh(devices=[cuda])):
        _eq(want, _one_card_entry(mesh, "finalize_csr",
                                  pm.sharded_finalize_csr(mesh),
                                  _deep(args, cuda), {"out_cap": out_cap}))
    _counts_launched(before, ("finalize_shard", "counts_scan",
                              "fragment_merge", "finalize_one_card"))
    _counts_launched(entries, ("sharded_finalize_csr",), tk.ENTRY_LAUNCHES)


def _shard_fin_specs(names, data, seed, dev):
    specs = []
    for name in names:
        packed, off, kid, ssub, skid, srow, ts, out_cap = shard_fin_case(
            name, data, seed)
        specs.append(tuple(_t(a).to(dev) if isinstance(a, np.ndarray) else a
                           for a in (packed.view(np.int32), off,
                                     kid.view(np.int32), ssub, skid, srow,
                                     ts, out_cap)))
    return specs


@pytest.mark.parametrize("names", [
    tuple(sorted(SHARD_FIN_CASES)),
    ("fits",) * 40 + ("many_tiles", "overflow") * 4,
    ("no_slots",)])
def test_sharded_finalize_tab_kernel(cuda, names):
    """The sharded finalize table on the card's virtual 4 x 2 mesh (ONE
    launch for every finalize) = its plain version on the CPU mesh; its
    launch captured in a CUDA graph and replayed twice in a row over
    outputs filled with garbage between the replays: the zeroed scratch
    survives a replay."""
    from accord_tpu_torch.parallel import mesh as pm
    cpu, card = _meshes(cuda)
    want = pm.sharded_finalize_tab_plain(cpu, _shard_fin_specs(names, 4, 3,
                                                                "cpu"))
    specs = _shard_fin_specs(names, 4, 3, cuda)
    before = tk.LAUNCHES["finalize_shard_tab"]
    got = pm.sharded_finalize_tab(card, specs)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["finalize_shard_tab"] == before + 1
    _eq(want, got)
    launch, outs = pm.sharded_finalize_tab_launcher(card, specs)
    launch()
    torch.cuda.synchronize()
    _eq(want, outs)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch()
    for _ in range(2):
        for o in outs:
            for t in o:
                t.fill_(-7)
        graph.replay()
        torch.cuda.synchronize()
        _eq(want, outs)
    # the eager wrapper after the replays: the scratch is still zeroed
    _eq(want, pm.sharded_finalize_tab(card, specs))


@pytest.mark.parametrize("out_cap,total", [(64, 40), (300, 300), (48, 90),
                                           (1 << 16, 50_000),
                                           (200_003, 250_000), (16, 0)])
def test_fragment_merge_kernel(cuda, out_cap, total):
    """K22's merge in ONE launch = _sum_merge_fragments_plain: one block
    and many (the last block by ticket writes the checksum and zeroes the
    scratch), fitting, full, overflowing, empty; called twice and replayed
    twice in a CUDA graph, every result the same."""
    from accord_tpu_torch.parallel import mesh as pm
    rng = np.random.default_rng(out_cap + total)
    frags, indptr, ts = merge_fragments_case(rng, 4, out_cap, total, 5000)
    want = pm._sum_merge_fragments_plain(_t(frags), _t(indptr), _t(ts))
    args = tuple(_t(a).to(cuda) for a in (frags, indptr, ts))
    before = tk.LAUNCHES["fragment_merge"]
    for _ in range(2):
        got = pm._sum_merge_fragments(*args)
        torch.cuda.synchronize()
        _eq(want, got)
    assert tk.LAUNCHES["fragment_merge"] == before + 2
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = pm._sum_merge_fragments(*args)
    for _ in range(2):
        for t in got:
            t.fill_(-7)
        graph.replay()
        torch.cuda.synchronize()
        _eq(want, got)


@pytest.mark.parametrize("data,s", [(4, 0), (4, 33), (4, 4096), (2, 4097),
                                    (8, 12289), (1, 70000)])
def test_counts_scan_kernel(cuda, data, s):
    """K22's counts_scan (one block of 1,024 threads, 4 slots a thread a
    pass) = _gather_counts_plain: no slot, a partial pass, the batch's
    4,096 slots in one pass, several passes, counts large enough that
    the int32 prefix wraps."""
    from accord_tpu_torch.parallel import mesh as pm
    rng = np.random.default_rng(data * 100_003 + s)
    counts = rng.integers(0, 1 << 27, (data, s)).astype(np.int32)
    counts[:, rng.random(s) < 0.3] = 0
    bounds = rng.integers(0, 1 << 30, data * 2).astype(np.int32)
    want = pm._gather_counts_plain(_t(counts), _t(bounds))
    before = tk.LAUNCHES["counts_scan"]
    got = pm._gather_counts(_t(counts).to(cuda), _t(bounds).to(cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["counts_scan"] == before + 1
    _eq(want, got)


def test_sharded_deps_step_kernels(cuda):
    """sharded_deps_step on the card's virtual mesh = the CPU mesh's = K18
    -> K19 -> K20 with the same rounds, and the graft dry run's twin."""
    from accord_tpu_torch.graft_entry import dryrun_multichip
    from accord_tpu_torch.ops import carry
    from accord_tpu_torch.parallel import mesh as pm
    cpu, card = _meshes(cuda)
    rng = np.random.default_rng(5)
    n, k = 512, 256
    bm = (rng.random((n, k)) < 0.02).astype(np.float32)
    ts = np.stack([np.zeros(n), np.sort(rng.integers(0, 9999, n)),
                   rng.integers(0, 99, n)], 1).astype(np.int32)
    kinds = rng.integers(0, 2, n).astype(np.int32)
    args = (carry.packed(bm), _t(ts), _t(kinds), _t(WITNESS_TABLE))
    before, entries = dict(tk.LAUNCHES), dict(tk.ENTRY_LAUNCHES)
    want = pm.sharded_deps_step(cpu, 4)(*args)
    got = pm.sharded_deps_step(card, 4)(*_deep(args, cuda))
    torch.cuda.synchronize()
    _eq(want, got)
    valid = torch.ones(n, dtype=torch.bool)
    one = tk.deps_matrix(args[0], args[1], args[2], args[0], args[1],
                         args[2], valid, args[3])
    _eq(one, got[0])
    _eq(tk.execution_wavefronts(tk.transitive_closure(one, 4), 4), got[1])
    _counts_launched(before, ("deps_matrix_shard", "pack_rows",
                              "closure_rows", "wavefront_rows", "or_fold"))
    _counts_launched(entries, ("sharded_deps_step",), tk.ENTRY_LAUNCHES)
    dryrun_multichip(8)


def test_sharded_burns_card_match_cpu(cuda):
    """A key burn and a range-mix burn with ShardedBatchDepsResolver on the
    card's virtual mesh commit the CPU mesh's histories; the sharded merged
    mesh burn at 16 nodes commits the unsharded merged run's. On the card
    every sharded resolve and finalize is its one-card form: no shard
    kernel and no K22 combine launches."""
    from accord_tpu_torch.ops.resolver import ShardedBatchDepsResolver
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    cpu, card = _meshes(cuda)

    def no_shard_launches(what):
        torch.cuda.synchronize()
        for k in ONE_CARD_ZERO:
            assert tk.LAUNCHES[k] == 0, f"{what}: {k} launched"

    for ranges in (False, True):
        logs = []
        for mesh in (cpu, card):
            res = []

            def factory(mesh=mesh, res=res):
                r = ShardedBatchDepsResolver(mesh=mesh, num_buckets=1024,
                                             initial_cap=2048)
                res.append(r)
                return r

            extra = dict(durability=True, durability_interval_ms=1000.0) \
                if ranges else {}
            mix = dict(range_read_ratio=0.1, range_write_ratio=0.1) \
                if ranges else {}
            tk.reset_launches()
            rep = run_burn(9, ops=120, key_count=16, zipf_theta=0.99,
                           max_keys_per_txn=4, write_ratio=0.7,
                           collect_log=True, **mix,
                           config=ClusterConfig(
                               num_nodes=5, rf=3,
                               deps_resolver_factory=factory,
                               deps_batch_window_ms=16.0, **extra))
            assert rep.lost == 0
            assert sum(r.host_fallbacks for r in res) == 0
            assert sum(r.finalized_decodes for r in res) > 0
            if mesh is card:
                no_shard_launches("range-mix burn" if ranges else "key burn")
                assert tk.ENTRY_LAUNCHES["sharded_finalize_csr"] \
                    == tk.LAUNCHES["finalize_one_card"] > 0
            logs.append(rep.log)
        assert logs[0] == logs[1]
    kw = dict(nodes=16, collect_log=True)
    tk.reset_launches()
    sharded, eng = run_mesh_burn(6, 40, sharded=True, mesh=card, **kw)
    no_shard_launches("mesh burn")
    assert tk.LAUNCHES["node_deps_one_card"] > 0
    merged, _ = run_mesh_burn(6, 40, device=cuda, **kw)
    assert sharded.log == merged.log
    assert eng.snapshot()["mesh_tick_fallbacks"] == 0


def test_sharded_mesh_across_every_card(cuda):
    """make_mesh() over every visible card (2 or more): each shard's
    operands and results cross cards through peer copies, and every
    sharded entry, the dry run and a sharded burn still answer as one
    device does."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 or more cards: a mesh across cards")
    from accord_tpu_torch.graft_entry import dryrun_multichip
    from accord_tpu_torch.ops import carry
    from accord_tpu_torch.ops.resolver import (BatchDepsResolver,
                                               ShardedBatchDepsResolver)
    from accord_tpu_torch.parallel import mesh as pm
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    mesh = pm.make_mesh()
    assert len({d for row in mesh.devices for d in row}) == n
    home = mesh.device(0, 0)
    rng = np.random.default_rng(11)
    args = _deep(_resolve_lanes(1, 1024, 1024, 64), home)
    _eq(tk.deps_resolve(*args).cpu(), pm.sharded_deps_resolve(mesh)(*args))
    b = 64
    ivs, rar = _range_lanes(rng, b, 200, 256)
    key = tuple(_resolve_lanes(9, 512, 1024, b)[4:8])
    rargs = _deep((*ivs, args[2], args[3], _t(rng.random(b) < 0.5), *rar,
                   *key, args[8]), home)
    for want, got in zip(tk.range_deps_resolve(*rargs),
                         pm.sharded_range_deps_resolve(mesh)(*rargs)):
        _eq(want.cpu(), got)
    store = _t(rng.integers(0, 3, b).astype(np.int32))
    fargs = _deep((args[0], args[1], store, args[2], args[3],
                   _t(np.array([0, 1], np.int32)),
                   [tuple(_resolve_lanes(3 + s, cap, 1024, b)[4:8])
                    for s, cap in enumerate((512, 256))], args[8]), home)
    _eq(tk.fused_deps_resolve(*fargs).cpu(),
        pm.sharded_fused_deps_resolve(mesh, 2)(*fargs))
    w = 64

    def words(rows, cols, p):
        return _t(np.packbits(rng.random((rows, cols, 32)) < p, axis=-1,
                              bitorder="little").view(np.int32)
                  .reshape(rows, cols))

    fin = _deep((words(16, 2 * w, 0.05), w, words(64, w, 0.2),
                 _t(rng.integers(-1, 18, 64).astype(np.int32)),
                 _t(rng.integers(0, 65, 64).astype(np.int32)),
                 _t(rng.integers(-1, 32 * w, 16).astype(np.int32)),
                 _t(rng.integers(0, 99, (32 * w, 3)).astype(np.int32))),
                home)
    for out_cap in (64, 4096):
        _eq(tuple(x.cpu() for x in tk.finalize_csr(*fin, out_cap=out_cap)),
            pm.sharded_finalize_csr(mesh)(*fin, out_cap=out_cap))
    bm = (rng.random((256, 256)) < 0.02).astype(np.float32)
    step_args = (carry.packed(bm, home),
                 _t(np.stack([np.zeros(256), np.arange(256),
                              np.zeros(256)], 1).astype(np.int32)).to(home),
                 _t(rng.integers(0, 2, 256).astype(np.int32)).to(home),
                 _t(WITNESS_TABLE).to(home))
    deps, levels = pm.sharded_deps_step(mesh, 4)(*step_args)
    valid = torch.ones(256, dtype=torch.bool, device=home)
    one = tk.deps_matrix(*step_args[:3], *step_args[:3], valid,
                         step_args[3])
    _eq(one.cpu(), deps)
    _eq(tk.execution_wavefronts(tk.transitive_closure(one, 4), 4).cpu(),
        levels)
    dryrun_multichip(n)
    logs = []
    for make in (lambda: BatchDepsResolver(num_buckets=1024,
                                           initial_cap=2048, device=home),
                 lambda: ShardedBatchDepsResolver(mesh=mesh,
                                                  num_buckets=1024,
                                                  initial_cap=2048)):
        rep = run_burn(9, ops=120, key_count=16, zipf_theta=0.99,
                       max_keys_per_txn=4, write_ratio=0.7,
                       collect_log=True,
                       config=ClusterConfig(num_nodes=5, rf=3,
                                            deps_resolver_factory=make,
                                            deps_batch_window_ms=16.0))
        logs.append(rep.log)
    assert logs[0] == logs[1]
    kw = dict(nodes=16, collect_log=True)
    sharded, eng = run_mesh_burn(6, 40, sharded=True, mesh=mesh, **kw)
    merged, _ = run_mesh_burn(6, 40, device=home, **kw)
    assert sharded.log == merged.log
    assert eng.snapshot()["mesh_tick_fallbacks"] == 0


# -- the sharded protocol megakernel and K23 (the virtual 4 x 2 mesh) ---------
def _shard_route_inputs(rng, S, npsh, depth, W, bcap):
    """Raw K23 inputs: landed lanes on distinct (dst, slot) rings, pads,
    lanes toward every shard, links cut between nodes of different
    shards; lane 0 of segment (0, S-1) lands on the last ring row of shard
    S-1, where that shard's non-landing lanes gather back."""
    rows_nodes = npsh * S
    L = S * S * bcap
    arena = rng.integers(-9, 9, (rows_nodes * depth, W)).astype(np.int32)
    meta = rng.integers(-9, 9, (rows_nodes * depth, 3)).astype(np.int32)
    part = np.zeros((rows_nodes, rows_nodes), bool)
    for a, b in ((1, npsh + 1), (0, rows_nodes - 1), (npsh, npsh + 1)):
        a, b = a % rows_nodes, b % rows_nodes
        part[a, b] = part[b, a] = True
    src, dst, slot, kind, seq = (np.zeros(L, np.int32) for _ in range(5))
    keep = np.zeros(L, bool)
    words = np.zeros((L, W), np.int32)
    free = {v: list(rng.permutation(depth)) for v in range(rows_nodes)}
    last = rows_nodes - 1
    free[last].remove(depth - 1)
    for s in range(S):
        for t in range(S):
            for j in range(int(rng.integers(bcap // 2, bcap + 1))):
                q = (s * S + t) * bcap + j
                d = int(rng.integers(t * npsh, (t + 1) * npsh))
                if s == 0 and t == S - 1 and j == 0:
                    d, sl = last, depth - 1
                elif free[d]:
                    sl = free[d].pop()
                else:
                    continue
                src[q] = int(rng.integers(s * npsh, (s + 1) * npsh))
                dst[q], slot[q] = d, sl
                kind[q], seq[q] = rng.integers(1, 9), rng.integers(0, 1 << 30)
                keep[q] = True
                words[q] = rng.integers(-(1 << 31), 1 << 31, W)
    return (arena, meta, src, dst, slot, keep, kind, seq, words, part)


@pytest.mark.parametrize("S,npsh,depth,W,bcap", [
    (4, 2, 4, 8, 4), (4, 17, 64, 384, 64), (1, 65, 64, 384, 1024),
    (4, 65, 64, 384, 64)])
def test_sharded_mailbox_route_kernel(cuda, S, npsh, depth, W, bcap):
    """K23 on the card = its plain version on the CPU: every shard's arena
    and meta updated in place, the landed words and meta receiver-major
    (a non-landing lane gathers back its destination shard's last row,
    after the scatter), land -- with cuts between shards and pads."""
    from accord_tpu_torch.ops.mailbox import sharded_mailbox_route
    rng = np.random.default_rng(S * 1000 + bcap)
    ins = _shard_route_inputs(rng, S, npsh, depth, W, bcap)
    arena, meta, part = _t(ins[0]), _t(ins[1]), _t(ins[9])
    plain = sharded_mailbox_route(S, arena, meta, *ins[2:9], part)
    ca, cm = arena.to(cuda), meta.to(cuda)
    n0 = tk.LAUNCHES["sharded_mailbox_route"]
    got = sharded_mailbox_route(S, _t(ins[0]).to(cuda), _t(ins[1]).to(cuda),
                                *ins[2:9], part.to(cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["sharded_mailbox_route"] == n0 + 1
    _eq(plain, got)
    assert int(plain[4].sum()) > 0 and not bool(plain[4].all())
    del ca, cm


# the card test's shapes (S, npsh, depth, W, bcap), each with bcap >= 4
ROUTE_CARD_SHAPES = ((4, 2, 4, 8, 4), (4, 17, 64, 384, 64),
                     (1, 65, 64, 384, 1024), (4, 65, 64, 384, 64))


def _route_hazard(S, npsh, depth, W, bcap, hazard):
    rng = np.random.default_rng(S * 1000 + bcap + len(hazard))
    ins, writers = shard_route_case(rng, S, npsh, depth, W, bcap, hazard)
    plain = tmb.sharded_mailbox_route(
        S, _t(ins[0]), _t(ins[1]), *ins[2:9], _t(ins[9]))
    return ins, writers, plain


@pytest.mark.parametrize("hazard", SHARD_ROUTE_HAZARDS)
@pytest.mark.parametrize("shape", ROUTE_CARD_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_sharded_mailbox_route_clamped_rows_kernel(cuda, shape, hazard):
    """K23's ONE launch = its plain version where a gather-back reads a
    clamped row another lane lands on in the same launch (tests/
    torch_kernel_cases.shard_route_case): the reader takes the writer's
    words and meta, never the arena row a block of the launch writes."""
    S = shape[0]
    ins, writers, plain = _route_hazard(*shape, hazard)
    n0 = tk.LAUNCHES["sharded_mailbox_route"]
    got = tmb.sharded_mailbox_route(
        S, _t(ins[0]).to(cuda), _t(ins[1]).to(cuda), *ins[2:9],
        _t(ins[9]).to(cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["sharded_mailbox_route"] == n0 + 1
    _eq(plain, got)
    words = _t(ins[8])
    for q in writers:        # the write is read back somewhere else
        assert int((plain[2] == words[q]).all(1).sum()) > 1


def test_sharded_mailbox_route_one_kernel_a_call(cuda):
    """One K23 call on a shared card (lanes already on it), captured in a
    CUDA graph, is ONE kernel node: the scatter and the gather-back in one
    launch, no memset or copy."""
    S, npsh, depth, W, bcap = ROUTE_CARD_SHAPES[3]
    ins, _w, _p = _route_hazard(S, npsh, depth, W, bcap, "last_row")
    a, m, *lanes, part = (_t(x).to(cuda) for x in ins)
    assert _graph_node_types(lambda: tmb.sharded_mailbox_route(
        S, a, m, *lanes, part)) == [0]


@pytest.mark.parametrize("hazard", SHARD_ROUTE_HAZARDS)
def test_sharded_mailbox_route_tuple_form_one_card(cuda, hazard):
    """K23's tuple form (a tensor a shard, as across cards) with every
    shard on this one card: the land kernel on each source shard, the land
    segments gathered, then the route kernel with land_in on each
    destination shard -- one route launch a destination -- = the plain
    version, the clamped-row hazards included."""
    S, npsh, depth, W, bcap = ROUTE_CARD_SHAPES[1]
    ins, _w, plain = _route_hazard(S, npsh, depth, W, bcap, hazard)
    rows, n1 = npsh * depth, npsh
    ga = tuple(_t(ins[0][t * rows:(t + 1) * rows]).to(cuda)
               for t in range(S))
    gm = tuple(_t(ins[1][t * rows:(t + 1) * rows]).to(cuda)
               for t in range(S))
    gp = tuple(_t(ins[9][t * n1:(t + 1) * n1]).to(cuda) for t in range(S))
    n0 = tk.LAUNCHES["sharded_mailbox_route"]
    got = tmb.sharded_mailbox_route(S, ga, gm, *ins[2:9], gp)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["sharded_mailbox_route"] == n0 + 1
    _eq(plain[0], torch.cat([x.cpu() for x in got[0]]))
    _eq(plain[1], torch.cat([x.cpu() for x in got[1]]))
    for want, parts in zip(plain[2:], got[2:]):
        assert len(parts) == S
        _eq(want, torch.cat([x.cpu() for x in parts]))
    # one route kernel a destination shard (and one land kernel a source)
    lanes = [_t(x).to(cuda) for x in ins[2:9]]
    dot = _graph_dot(lambda: tmb.sharded_mailbox_route(
        S, ga, gm, *lanes, gp))
    nodes = dot.splitlines()
    assert sum("mailbox_shard_route_kernel" in ln for ln in nodes) == S, dot
    assert sum("mailbox_shard_land_kernel" in ln for ln in nodes) == S, dot


def _shard_merges(seed, k=128):
    """Merges whose every block splits into 4 'data' shards of whole
    words (caps multiples of 128) and every span into 4 word shards."""
    from accord_tpu_torch.ops import node_lane as nl
    rng = np.random.default_rng(seed)
    pad_key, pad_rng = _pads(k)
    kplans = [_key_plan(rng, 8, (128,), k, False),
              _key_plan(rng, 64, (256, 256), k, True),
              _key_plan(rng, 8, (128, 256), k, True)]
    rplans = [_range_plan(rng, 8, (128,), (128,), k),
              _range_plan(rng, 64, (128, 256), (256, 256), k),
              _range_plan(rng, 8, (128,), (128,), k, has_k=False)]
    km = nl.build_key_merge(list(enumerate(kplans)), pad_key)
    rm = nl.build_range_merge(list(enumerate(rplans)), pad_key, pad_rng)
    return km, rm


def _shard_tick(seed, mail_plane=None):
    """A tick with every stage the sharded megakernel has: key and range
    resolves, key / rkey / range finalizes out of signature order, cmd,
    repair, exec and quorum blocks, and (with a plane) the mailbox."""
    from accord_tpu_torch.sim.network import _MailMsg
    rng = np.random.default_rng(seed)
    kw = _tick(seed)
    km, rm = _shard_merges(seed)
    kw["key_in"], kw["rng_in"] = _key_in(km), _rng_in(rm)
    kw["fins"] = (_fin_range(rng, 16, 64, 256),
                  _fin_key(rng, "key", km.spans[1], 8, 2048),
                  _fin_key(rng, "key", km.spans[0], 4, 256),
                  _fin_key(rng, "rkey",
                           rm.spans[1][:2] + rm.spans[1][4:], 8, 256))
    if mail_plane is not None:
        ents = []
        for i in range(40):
            e = _MailMsg(kind=1 + i % 3, src=int(rng.integers(1, 8)),
                         dst=int(rng.integers(1, 8)),
                         payload=bytes(rng.integers(0, 256, 40)
                                       .astype(np.uint8)))
            e.ticket = i
            ents.append(e)
        mail_plane.set_partitions({frozenset((1, 6))}, version=1)
        kw["mailbox"] = mail_plane.stage_batch(ents)
        kw["entries"] = ents
    return kw


def test_sharded_protocol_tick_graph_matches_plain(cuda):
    """The sharded megakernel's graph on the card's virtual mesh against
    the single-device plain protocol_tick and the CPU mesh's sharded
    program: every output bit-equal, one replay, each stage kernel
    counted once per use; the mailbox plane's landed payloads equal."""
    from accord_tpu_torch.ops.mailbox import MailboxPlane
    from accord_tpu_torch.parallel.mesh import sharded_protocol_tick
    cpu, card = _meshes(cuda)
    wt = _t(WITNESS_TABLE)
    pc = MailboxPlane(7, depth=16, words=16, shards=4, device="cpu")
    pg = MailboxPlane(7, depth=16, words=16, shards=4, device=cuda)
    kw_c, kw_g = _shard_tick(3, pc), _shard_tick(3, pg)
    ents_c, ents_g = kw_c.pop("entries"), kw_g.pop("entries")
    cpu_out = sharded_protocol_tick(cpu, wt, **kw_c)
    single = tk.protocol_tick(wt, **{k: v for k, v in kw_c.items()
                                     if k != "mailbox"})
    l0 = dict(tk.LAUNCHES)
    got = sharded_protocol_tick(card, wt.to(cuda), **_deep(kw_g, cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["sharded_protocol_tick"] == \
        l0["sharded_protocol_tick"] + 1
    assert tk.LAUNCHES["protocol_tick"] == l0["protocol_tick"]
    for name, n in (("node_key_shard", 2), ("node_range_shard", 1),
                    ("or_fold", 0), ("finalize_shard_tab", 1),
                    ("counts_scan", 0), ("fragment_merge", 0),
                    ("range_finalize", 1), ("cmd_tick", 1),
                    ("quorum_count", 1), ("cmd_repair", 1),
                    ("frontier_compact", 1), ("sharded_mailbox_route", 1),
                    ("node_deps_resolve", 0), ("finalize_csr", 0)):
        assert tk.LAUNCHES[name] == l0[name] + n, name
    _eq(cpu_out, got)
    for i in (0, 1, 2, 3, 4, 6, 7):
        _eq(single[i], got[i])
    pc.adopt(cpu_out[5])
    pg.adopt(got[5])
    landed = 0
    for ec, eg in zip(ents_c, ents_g):
        assert ec.slot is not None and eg.slot is not None
        rc, rg = pc.read_landed(ec), pg.read_landed(eg)
        assert rc == rg
        landed += rc is not None
    assert landed > 0
    for fin in single[2]:
        assert int(fin[0][-1]) > 0


def test_sharded_protocol_tick_graph_replays_new_snapshots(cuda):
    """Two sharded ticks of one signature: the second replays the first's
    graph (no capture) and both keep their outputs."""
    from accord_tpu_torch.parallel.mesh import sharded_protocol_tick
    cpu, card = _meshes(cuda)
    wt = _t(WITNESS_TABLE)
    a, b = _shard_tick(4), _shard_tick(5)
    pa = sharded_protocol_tick(cpu, wt, **a)
    pb = sharded_protocol_tick(cpu, wt, **b)
    ga = sharded_protocol_tick(card, wt.to(cuda), **_deep(a, cuda))
    c1 = tk.CAPTURES["sharded_protocol_tick"]
    held = tk.jit_cache_sizes()["sharded_protocol_tick"]
    gb = sharded_protocol_tick(card, wt.to(cuda), **_deep(b, cuda))
    torch.cuda.synchronize()
    assert tk.CAPTURES["sharded_protocol_tick"] == c1
    assert tk.jit_cache_sizes()["sharded_protocol_tick"] == held >= 1
    _eq(pb, gb)
    _eq(pa, ga)


def test_sharded_megakernel_burn_card_matches_cpu_no_capture(cuda):
    """run_mesh_burn(sharded=True, megakernel=True, device_messages=True,
    exec_in_megakernel=True) on the card's virtual mesh commits the CPU
    mesh's history; after warmup_sharded and one warm run, a second run
    captures no graph (jit_cache_sizes unchanged), replays once per fused
    dispatch, and falls back nowhere."""
    from accord_tpu_torch.parallel.mesh import warmup_sharded
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    cpu, card = _meshes(cuda)
    kw = dict(nodes=4, megakernel=True, device_messages=True,
              exec_plane=True, exec_compact=True, exec_in_megakernel=True,
              crash_restart=True, collect_log=True)
    ref, _ = run_mesh_burn(23, 40, sharded=True, mesh=cpu, **kw)
    warmup_sharded(card, num_buckets=128, cap=512, batch_tiers=(8,),
                   nnz_tiers=(32,), mega_quorum_sizes=(2,),
                   exec_tiers=(32,))
    run_mesh_burn(23, 40, sharded=True, mesh=card, **kw)
    cache0 = tk.jit_cache_sizes()
    r0 = tk.LAUNCHES["sharded_protocol_tick"]
    got, eng = run_mesh_burn(23, 40, sharded=True, mesh=card, **kw)
    snap = eng.snapshot()
    assert tk.jit_cache_sizes() == cache0
    assert got.log == ref.log
    assert snap["launches_per_tick"] == 1.0
    assert snap["sharded_megakernel_fallbacks"] == 0
    assert tk.LAUNCHES["sharded_protocol_tick"] - r0 == \
        snap["megakernel_dispatches"] > 0
    assert got.counters["mailbox_verify_fallbacks"] == 0
    assert got.counters["device_messages_delivered"] > 0


def test_sharded_megakernel_across_every_card(cuda):
    """make_mesh() over every visible card (2 or more): the sharded tick
    runs stage by stage on each shard's card (K23 with a land exchange
    between cards), replays no graph, and answers as the CPU mesh does; a
    sharded megakernel device-messages burn commits the CPU mesh's
    history, each fused dispatch several kernel launches."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 or more cards: a mesh across cards")
    from accord_tpu_torch.ops.mailbox import (MailboxPlane,
                                              sharded_mailbox_route)
    from accord_tpu_torch.parallel import mesh as pm
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    mesh = pm.make_mesh()
    S = mesh.shape["data"]
    devs = [mesh.device(d, 0) for d in range(S)]
    rng = np.random.default_rng(S)
    ins = _shard_route_inputs(rng, S, 9, 8, 64, 32)
    arena, meta, part = _t(ins[0]), _t(ins[1]), _t(ins[9])
    plain = sharded_mailbox_route(S, arena, meta, *ins[2:9], part)
    rows = arena.shape[0] // S
    ga = tuple(_t(ins[0][t * rows:(t + 1) * rows]).to(devs[t])
               for t in range(S))
    gm = tuple(_t(ins[1][t * rows:(t + 1) * rows]).to(devs[t])
               for t in range(S))
    gp = tuple(part[t * 9:(t + 1) * 9].to(devs[t]) for t in range(S))
    got = sharded_mailbox_route(S, ga, gm, *ins[2:9], gp)
    torch.cuda.synchronize()
    _eq(arena, torch.cat([a.cpu() for a in got[0]]))
    _eq(meta, torch.cat([m.cpu() for m in got[1]]))
    for want, parts in zip(plain[2:], got[2:]):
        _eq(want, torch.cat([p.cpu() for p in parts]))
    cpu = pm.make_mesh(devices=["cpu"] * n)
    wt = _t(WITNESS_TABLE)
    kw = _shard_tick(9)
    l0 = tk.LAUNCHES["sharded_protocol_tick"]
    s0 = tk.ENTRY_LAUNCHES["sharded_protocol_tick_stages"]
    _eq(pm.sharded_protocol_tick(cpu, wt, **kw),
        pm.sharded_protocol_tick(mesh, wt.to(devs[0]),
                                 **_deep(kw, devs[0])))
    # stage by stage across cards: no graph replay, many kernel launches
    assert tk.LAUNCHES["sharded_protocol_tick"] == l0
    assert tk.ENTRY_LAUNCHES["sharded_protocol_tick_stages"] - s0 > S
    plane = MailboxPlane(7, shards=S, device=devs)
    assert plane.shard_devices is not None
    bkw = dict(nodes=4, megakernel=True, device_messages=True,
               collect_log=True)
    ref, _ = run_mesh_burn(5, 40, device="cpu", **bkw)
    s0 = tk.ENTRY_LAUNCHES["sharded_protocol_tick_stages"]
    got_b, eng = run_mesh_burn(5, 40, sharded=True, mesh=mesh, **bkw)
    assert got_b.log == ref.log
    snap = eng.snapshot()
    assert tk.LAUNCHES["sharded_protocol_tick"] == l0
    assert tk.ENTRY_LAUNCHES["sharded_protocol_tick_stages"] - s0 > \
        snap["megakernel_dispatches"] > 0
    assert snap["sharded_megakernel_fallbacks"] == 0
    assert got_b.counters["mailbox_verify_fallbacks"] == 0


# -- K10 and K2's compaction redesigned: one launch a call -------------------
@pytest.mark.parametrize("tier", [64, 512])
@pytest.mark.parametrize("name", CMD_CASES)
def test_cmd_tick_kernel_shared_cases(cuda, name, tier):
    """K10 against its plain version on the CPU tests' fixtures (kpad 1, 3
    and 8; a run of every kind on one row; kid links across slots; an
    all-PreAccept batch whose clock carries through every op), at the
    op tiers 64 and 512 (the chains in shared memory)."""
    cols, clock, ops, promote = cmd_case(name, tier)
    cols, ops = [_t(a) for a in cols], [_t(a) for a in ops]
    plain = tk.cmd_tick_plain(*cols, clock, *ops, *CMD_SCALARS,
                              promote=promote)
    got = tk.cmd_tick(*_on(cols, cuda), clock, *_on(ops, cuda),
                      *CMD_SCALARS, promote=promote)
    torch.cuda.synchronize()
    _eq(plain, got)


@pytest.mark.parametrize("name", ["random_kpad8", "one_row_run",
                                  "all_preaccept_slow"])
def test_cmd_tick_kernel_tier_4096(cuda, name):
    """Tier 4096: the chains no longer fit shared memory and live in the
    chain output (kpad 8 is the widest row)."""
    cols, clock, ops, promote = cmd_case(name, 4096)
    cols, ops = [_t(a) for a in cols], [_t(a) for a in ops]
    plain = tk.cmd_tick_plain(*cols, clock, *ops, *CMD_SCALARS,
                              promote=promote)
    got = tk.cmd_tick(*_on(cols, cuda), clock, *_on(ops, cuda),
                      *CMD_SCALARS, promote=promote)
    torch.cuda.synchronize()
    _eq(plain, got)


def _trace_kernels(fn):
    """(kernel names, memsets and copies) the profiler saw on the card in
    one call of fn (after a warm call); a trace with no device activity
    at all (the profiler delivered none) is taken again, after a pause
    and a warm call, up to 3 times (as chip_smoke.trace_call does)."""
    import time
    from torch.profiler import ProfilerActivity, profile
    names = []
    for attempt in range(3):
        if attempt:
            time.sleep(0.5)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    moves = [n for n in names if "memset" in n.lower()
             or "memcpy" in n.lower()]
    return [n for n in names if n not in moves], moves


def test_one_kernel_a_call(cuda):
    """A profiler trace of one eager call: K10, K2 and K9's three entries
    (at 24 and at 192 output words) are ONE kernel and no memset or copy;
    K11 is its predicate kernel and the one compaction kernel."""
    rng = np.random.default_rng(31)
    cols, clock, ops, promote = cmd_case("random_kpad3", 512)
    c_cols, c_ops = _on([_t(a) for a in cols], cuda), \
        _on([_t(a) for a in ops], cuda)
    fin = [_t(a) if isinstance(a, np.ndarray) else a
           for a in finalize_many_tiles(5)]
    fin[0], fin[2] = fin[0].view(torch.int32), fin[2].view(torch.int32)
    c_fin = _on(fin, cuda)
    status = _t(rng.integers(0, 12, 4096).astype(np.int32)).to(cuda)
    touched = _t(rng.integers(0, 2000, 4096).astype(np.int32)).to(cuda)
    planes = [_on(_exec_plane(rng, 256), cuda) for _ in range(3)]
    wide = [_on(_exec_plane(rng, 2048), cuda) for _ in range(3)]
    calls = {
        "cmd_tick": (lambda: tk.cmd_tick(*c_cols, clock, *c_ops,
                                         *CMD_SCALARS, promote=promote), 1),
        "finalize_csr": (lambda: tk.finalize_csr(*c_fin, out_cap=4096), 1),
        "finalize_csr_tab": (lambda: tk.finalize_csr_tab(
            [(*c_fin, 4096), (*c_fin, 256)]), 1),
        "recovery_scan": (lambda: tk.recovery_scan(status, touched, 1000,
                                                   300, 256), 2),
        "frontier_compact": (lambda: tk.frontier_compact(planes, 256), 1),
        "frontier_compact_wide": (lambda: tk.frontier_compact(wide, 4096),
                                   1),
        "execution_frontier": (lambda: tk.execution_frontier(*wide[0]), 1),
        "fused_execution_frontier": (
            lambda: tk.fused_execution_frontier(wide), 1)}
    for name, (fn, want) in calls.items():
        kernels, moves = _trace_kernels(fn)
        if name == "finalize_csr_tab":
            moves = [m for m in moves if "HtoD" not in m]   # its table
        assert len(kernels) == want and not moves, (name, kernels, moves)


@pytest.mark.parametrize("out_cap,total_zero", [(256, False),
                                                (1 << 18, False),
                                                (256, True)])
def test_finalize_csr_many_tiles_kernel(cuda, out_cap, total_zero):
    """K2 over 48 compaction tiles (the CPU test's fixture): the eager
    entry and the table entry against the plain version."""
    args = [_t(a) if isinstance(a, np.ndarray) else a
            for a in finalize_many_tiles(11, total_zero=total_zero)]
    args[0], args[2] = args[0].view(torch.int32), args[2].view(torch.int32)
    plain = tk.finalize_csr(*args, out_cap=out_cap)
    dev = _on(args, cuda)
    got = tk.finalize_csr(*dev, out_cap=out_cap)
    tab = tk.finalize_csr_tab([(*dev, out_cap)])
    torch.cuda.synchronize()
    _eq(plain, got)
    _eq(plain, tab[0])


def _fin_specs(seed, n):
    """n finalize specs of differing widths, slot counts, spans and
    out_caps (one with no slots, one past its out_cap)."""
    rng = np.random.default_rng(seed)
    specs = []
    for k in range(n):
        b, w = int(rng.integers(4, 40)), int(rng.choice([1, 4, 64, 96]))
        s = 0 if k == 3 else int(rng.integers(1, 300))
        kc = 24
        packed = _words(rng, (b, 2 * w))
        kid = _words(rng, (kc, w)) & _words(rng, (kc, w))
        slot_subj = rng.integers(-1, b + 1, s).astype(np.int32)
        slot_kid = rng.integers(-1, kc + 1, s).astype(np.int32)
        subj_row = rng.integers(-1, 32 * w, b).astype(np.int32)
        act_ts = rng.integers(-50, 50, (32 * w, 3)).astype(np.int32)
        out_cap = 8 if k == 5 else int(rng.choice([64, 1024, 4096]))
        specs.append((_t(packed), int(rng.integers(0, w + 3)), _t(kid),
                      _t(slot_subj), _t(slot_kid), _t(subj_row),
                      _t(act_ts), out_cap))
    return specs


def test_finalize_csr_tab_matches_per_spec(cuda):
    """The table entry (one launch for 40 finalizes) = the per-spec eager
    calls = the plain versions."""
    specs = _fin_specs(3, 40)
    plain = [tk.finalize_csr(*sp) for sp in specs]
    dev = [tuple(_on(list(sp), cuda)) for sp in specs]
    per = [tk.finalize_csr(*sp) for sp in dev]
    n0 = tk.LAUNCHES["finalize_csr_tab"]
    tab = tk.finalize_csr_tab(dev)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["finalize_csr_tab"] == n0 + 1
    _eq(plain, per)
    _eq(plain, list(tab))
    assert int(plain[5][0][-1]) > 8


def test_graph_replays_cmd_tick_and_fin_tab_twice(cuda):
    """protocol_tick's graph with a cmd_tick_dsc stage and the key
    finalizes' table node: the same tick twice (the second a replay of
    the first's graph) gives the plain outputs both times, so the
    kernels' scratch (K10's ticket, the compaction's tile states and
    partial sums) is zero again after a replay."""
    wt = _t(WITNESS_TABLE)
    kw = _tick(8)
    kw = {k: kw[k] for k in ("key_in", "rng_in", "fins", "cmds")}
    plain = tk.protocol_tick(wt, **kw)
    c0 = tk.CAPTURES["protocol_tick"]
    dkw = _deep(kw, cuda)
    first = tk.protocol_tick(wt.to(cuda), **dkw)
    second = tk.protocol_tick(wt.to(cuda), **dkw)
    torch.cuda.synchronize()
    assert tk.CAPTURES["protocol_tick"] - c0 <= 1
    _eq(plain, first)
    _eq(plain, second)


def test_compaction_many_tiles_kernels(cuda):
    """K9's compact entry over 32 planes (64 compaction tiles), K11 over
    2^21 rows (64 tiles) and segment_compact over 128 tiles: each one
    launch of the compaction, against the plain versions."""
    rng = np.random.default_rng(77)
    planes = [_exec_plane(rng, 2048) for _ in range(32)]
    for out_cap in (512, 1 << 16):
        plain = tk.frontier_compact(planes, out_cap=out_cap)
        got = tk.frontier_compact([_on(p, cuda) for p in planes],
                                  out_cap=out_cap)
        torch.cuda.synchronize()
        _eq(plain, got)
    cap = 1 << 21
    status = _t(rng.integers(0, 12, cap).astype(np.int32))
    touched = _t(rng.integers(0, 2000, cap).astype(np.int32))
    for out_cap in (2048, 1 << 20):
        plain = tk.recovery_scan(status, touched, 1000, 300, out_cap)
        got = tk.recovery_scan(status.to(cuda), touched.to(cuda), 1000, 300,
                               out_cap)
        torch.cuda.synchronize()
        _eq(plain, got)
    m = _t(_words(rng, (512, 256)))
    for out_cap in (1000, 1 << 22):
        _eq(tk.segment_compact(m, out_cap),
            tk.segment_compact(m.to(cuda), out_cap))


# -- K18 and K19 redesigned: register tiles, blocked boolean product ---------
def _deps_args(name):
    sbm, sb, sk, abm, ts, ak, valid = deps_case(name)
    return [_t(x) for x in (pack_words(sbm), sb, sk, pack_words(abm), ts, ak,
                            valid, WITNESS_TABLE)]


@pytest.mark.parametrize("name", DEPS_CASES)
def test_deps_matrix_kernel_shared_cases(cuda, name):
    """K18 against its plain version on the CPU tests' fixtures: K 32,
    all-zero bitmaps, odd B and A over two chunks, bucket-sparse rows, a
    ragged 33-word chunk."""
    args = _deps_args(name)
    plain = tk.deps_matrix_plain(*args)
    got = tk.deps_matrix(*_on(args, cuda))
    torch.cuda.synchronize()
    _eq(plain, got)


def test_deps_matrix_strided_kernel(cuda):
    """deps_matrix_shard (`deps_matrix_strided`) on word slices read in
    place through their row strides (17, 32 and 1 words of 32), odd B and
    A, into an aligned and a byte-offset (unaligned) output."""
    sw, sb, sk, aw, ts, ak, valid, wt = _deps_args("odd_two_chunks")
    b, a = sw.shape[0], aw.shape[0]
    c_sw, c_aw = sw.to(cuda), aw.to(cuda)
    rest = _on([sb, sk, ts, ak, valid, wt], cuda)
    for lo, hi in ((3, 20), (0, 32), (16, 17)):
        plain = tk.deps_matrix_plain(sw[:, lo:hi].contiguous(), sb, sk,
                                     aw[:, lo:hi].contiguous(), ts, ak,
                                     valid, wt)
        for shift in (0, 1):
            out = torch.empty(b * a + shift, dtype=torch.bool,
                              device=cuda)[shift:].view(b, a)
            got = tk.deps_matrix_shard(c_sw[:, lo:hi], rest[0], rest[1],
                                       c_aw[:, lo:hi], rest[2], rest[3],
                                       rest[4], rest[5], out)
            torch.cuda.synchronize()
            assert got is out
            _eq(plain, got)


@pytest.mark.parametrize("name", CLOSURE_CASES)
def test_transitive_closure_kernel_shared_cases(cuda, name):
    """K19 against its plain version (run on the card) at odd N 77 and
    1,031 (33 words: the 4-byte copies) and N 1,024 (the 16-byte ones):
    iterations 0, 1, below the depth, past the fixpoint; its count of
    working squarings equal to the plain version's."""
    for n in (77, 1031, 1024):
        adj = _t(closure_case(name, n)).to(cuda)
        for it in CLOSURE_ITERS + (13,):
            w_plain = torch.zeros(1, dtype=torch.int32, device=cuda)
            w = torch.full((1,), -1, dtype=torch.int32, device=cuda)
            plain = tk.transitive_closure_plain(adj, it, w_plain)
            got = tk.transitive_closure(adj, it, worked=w)
            torch.cuda.synchronize()
            _eq(plain.cpu(), got)
            assert int(w) == int(w_plain), (n, it, int(w), int(w_plain))


def test_closure_rows_kernel_unaligned(cuda):
    """closure_rows (one Jacobi round of K19 on a row block) at row0 not
    aligned to the 64-row tile, one row, the whole matrix; 33 and 32
    words."""
    for n in (1031, 1024):
        full = tk.pack_rows_plain(_t(closure_case("cycles", n)))
        c_full = full.to(cuda)
        for row0, nrows in ((0, n), (37, 201), (n - 1, 1), (64, 64)):
            plain = tk.closure_rows_plain(full, n, row0, nrows)
            out = torch.empty(nrows, full.shape[1], dtype=torch.int32,
                              device=cuda)
            got = tk.closure_rows(c_full, n, row0, nrows, out)
            torch.cuda.synchronize()
            _eq(plain, got)


def _graph_twice(fn):
    """fn's output from a CUDA graph of one call, replayed twice."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(out.cpu())
    return outs


def test_dense_kernels_second_call_and_graph_replay(cuda):
    """A second eager call and two replays of a captured call equal the
    first call: K19's flags scratch (tile counter, ticket, done) is zero
    again after every call, the early exit included; K18 likewise."""
    adj = _t(closure_case("dag", 1031)).to(cuda)
    w = torch.zeros(1, dtype=torch.int32, device=cuda)
    first = tk.transitive_closure(adj, 20, worked=w).cpu()
    assert 0 < int(w) < 20                       # the early exit ran
    _eq(first, tk.transitive_closure(adj, 20))
    for out in _graph_twice(lambda: tk.transitive_closure(adj, 20)):
        _eq(first, out)
    _eq(first, tk.transitive_closure(adj, 20))
    args = _on(_deps_args("sparse_buckets"), cuda)
    first = tk.deps_matrix(*args).cpu()
    for out in _graph_twice(lambda: tk.deps_matrix(*args)):
        _eq(first, out)


def test_transitive_closure_after_dirty_flags(cuda):
    """Flags that a faulted call could leave set (done, a count of working
    squarings) cost the next call no correctness: its first squaring
    reads no done and restarts the count, and the call leaves the flags
    zeroed."""
    adj = _t(closure_case("dag", 1031)).to(cuda)
    tk.transitive_closure(adj, 1)                # the scratch exists
    idx = torch.cuda.current_device()
    flags = tk._SCRATCH[idx][:tk._CLOSURE_FLAG_BYTES].view(torch.int32)
    for it in (0, 1, 20):
        flags[3], flags[4] = 1, 7
        w_plain = torch.zeros(1, dtype=torch.int32, device=cuda)
        w = torch.full((1,), -1, dtype=torch.int32, device=cuda)
        got = tk.transitive_closure(adj, it, worked=w)
        _eq(tk.transitive_closure_plain(adj, it, w_plain).cpu(), got)
        assert int(w) == int(w_plain), (it, int(w), int(w_plain))
        assert not bool(flags.any()), flags.cpu()


def test_dense_kernels_launches_a_call(cuda):
    """A profiler trace of one call: K19 is `iterations` squaring launches
    plus its pack and unpack, whatever the data (past the fixpoint too),
    K18 one launch; neither has a memset or a copy."""
    adj = _t(closure_case("dag", 1031)).to(cuda)
    for it in (0, 3, 20):
        kernels, moves = _trace_kernels(
            lambda: tk.transitive_closure(adj, it))
        assert len(kernels) == it + 2 and not moves, (it, kernels, moves)
    args = _on(_deps_args("odd_two_chunks"), cuda)
    kernels, moves = _trace_kernels(lambda: tk.deps_matrix(*args))
    assert len(kernels) == 1 and not moves, (kernels, moves)


def test_transitive_closure_above_the_old_limit(cuda):
    """N 49,184 (1,537 words; the old kernel's cap was 49,152): K19 at 2
    iterations. The edges lie among 2,000 nodes spread over the range, so
    the closure is the plain version's on their induced 2,000 x 2,000
    graph, and every other bit stays clear."""
    n, m = 49_184, 2_000
    rng = np.random.default_rng(49)
    nodes = np.sort(rng.choice(n, m, replace=False))
    sub = rng.random((m, m)) < 2.0 / m
    ii, jj = np.nonzero(sub)
    adj = torch.zeros(n, n, dtype=torch.bool, device=cuda)
    adj[_t(nodes[ii]).to(cuda), _t(nodes[jj]).to(cuda)] = True
    got = tk.transitive_closure(adj, 2)
    want = tk.transitive_closure_plain(_t(sub), 2)
    idx = _t(nodes).to(cuda)
    _eq(want, got[idx][:, idx])
    assert int(got.sum()) == int(want.sum()) > int(sub.sum())


# -- the key body (csrc/deps_block.cuh) on its tiling's edges ----------------
def _body_case(name):
    c = key_body_case(name)
    blocks = [tuple(_t(a) for a in (pack_words(bits), ts, kd, v))
              for bits, ts, kd, v in c["blocks"]]
    lanes = {x: _t(c[x]) for x in ("subj_of", "subj_keys", "subj_store",
                                   "sb", "sknd", "slots", "iv_of", "iv_s",
                                   "iv_e", "srng")}
    return lanes, blocks


def _body_launches(launch, want):
    """A profiler trace of one body launch: `want` key-body kernels and no
    memset or copy. The profiler can drop a kernel's event (a trace short
    of launches the outputs show ran): a short trace is taken again, up
    to 3 times; a longer one, or a memset or copy, fails at once."""
    for _ in range(3):
        kernels, moves = _trace_kernels(launch)
        assert len(kernels) <= want and not moves, (kernels, moves)
        if len(kernels) == want:
            return
    assert len(kernels) == want, kernels


BODY_CASES = [*KEY_BODY_CASES, *KEY_BODY_RUN_CASES]


@pytest.mark.parametrize("name", BODY_CASES)
def test_key_body_cases_kernels(cuda, name):
    """K1 (single and fused), K13, K14's key side and K5's key side on the
    key body's tiling edges (tests/torch_kernel_cases.py; with 128 blocks
    a CTA walks a run of subject tiles): each bit-equal
    to its plain version, one counted launch a call, and one body launch
    one kernel a store block (K13: one for every block) with no memset
    or copy."""
    from accord_tpu_torch.ops import node_lane as nl
    L, P = _body_case(name)
    G = {k: v.to(cuda) for k, v in L.items()}
    D = [tuple(t.to(cuda) for t in blk) for blk in P]
    wt, gwt = _t(WITNESS_TABLE), _t(WITNESS_TABLE).to(cuda)

    def single(X, B, w):
        return (X["subj_of"], X["subj_keys"], X["sb"], X["sknd"], *B[0], w)

    def fused(X, B, w):
        return (X["subj_of"], X["subj_keys"], X["subj_store"], X["sb"],
                X["sknd"], X["slots"], tuple(B), w)

    def rng(X, B, w):
        return (X["iv_of"], X["iv_s"], X["iv_e"], X["subj_store"], X["sb"],
                X["sknd"], X["srng"], X["slots"][:0], (), X["slots"],
                tuple(B), w)
    for fn, args, count in (
            (tk.deps_resolve, single, "deps_resolve"),
            (tk.fused_deps_resolve, fused, "deps_resolve"),
            (nl.node_fused_deps_resolve, fused, "node_deps_resolve"),
            (nl.node_fused_range_deps_resolve, rng, "node_range_resolve"),
            (tk.fused_range_deps_resolve, rng, "range_resolve")):
        plain = fn(*args(L, P, wt))
        n0 = tk.LAUNCHES[count]
        got = fn(*args(G, D, gwt))
        torch.cuda.synchronize()
        assert tk.LAUNCHES[count] == n0 + 1, (fn.__name__, count)
        _eq(plain, got)
    launch, out = tk.resolve_launcher(*fused(G, D, gwt))
    _body_launches(launch, len(D))
    _eq(tk.fused_deps_resolve(*fused(L, P, wt)), out)
    launch, out = nl.key_launcher(*fused(G, D, gwt))
    _body_launches(launch, 1)
    _eq(nl.node_fused_deps_resolve(*fused(L, P, wt)), out)


@pytest.mark.parametrize("case", KEY_SHARD_CASES, ids=lambda c: c[0])
def test_key_body_shard_cases_kernel(cuda, case):
    """K1's mesh-shard entry on a case's rows and 'model' word slice, read
    in place (row stride nw > its words), into an odd column of a wider
    output: the words around it untouched, the span = the plain version."""
    name, r0, rows, base, kl, col = case
    L, P = _body_case(name)
    bm, ts, kd, v = (t[r0:r0 + rows] for t in P[0])
    k = bm.shape[1] * 32
    args = (L["subj_of"], L["subj_keys"], L["subj_store"], L["slots"][:1],
            L["sb"], L["sknd"])
    plain = torch.full((L["sb"].shape[0], col + rows // 32 + 2), -1,
                       dtype=torch.int32)
    tk.deps_resolve_shard(*args, bm[:, base // 32:(base + kl) // 32], ts, kd,
                          v, _t(WITNESS_TABLE), k, base, plain, col)
    gbm = bm.to(cuda)
    got = plain.new_full(plain.shape, -1).to(cuda)
    tk.deps_resolve_shard(*(a.to(cuda) for a in args),
                          gbm[:, base // 32:(base + kl) // 32],
                          ts.to(cuda), kd.to(cuda), v.to(cuda),
                          _t(WITNESS_TABLE).to(cuda), k, base, got, col)
    _eq(plain, got)
    assert (plain[:, col:col + rows // 32] != 0).any()


def _pad_blocks(blocks, rows: int, words: int):
    """Each block's rows padded to a multiple of `rows` with invalid rows,
    its bucket words to a multiple of `words` with zero words."""
    out = []
    for bm, ts, kd, v in blocks:
        cap, nw = bm.shape
        pr, pw = -cap % rows, -nw % words
        out.append((torch.nn.functional.pad(bm, (0, pw, 0, pr)),
                    torch.nn.functional.pad(ts, (0, 0, 0, pr)),
                    torch.nn.functional.pad(kd, (0, pr)),
                    torch.nn.functional.pad(v, (0, pr))))
    return tuple(out)


@pytest.mark.parametrize("shape", ((1, 1), (2, 2), (4, 2), (2, 4)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", BODY_CASES)
def test_key_body_cases_node_key_shard(cuda, name, shape):
    """The sharded megakernel's key stage (node_key_resolve over K13's
    block table, reading a row's bucket words whole -- every 'model'
    slice) on each case, on a data x model mesh of the card: the
    case's caps padded with invalid rows to whole words a 'data' shard and
    its bucket words with zero words to whole 'model' slices; one replay,
    the stage's one launch, no or_fold, the packed words = K13's plain
    version on the same blocks."""
    from accord_tpu_torch.ops import node_lane as nl
    from accord_tpu_torch.parallel.mesh import Mesh, sharded_protocol_tick
    L, P = _body_case(name)
    data, model = shape
    P = _pad_blocks(P, 32 * data, model)
    mesh = Mesh([[cuda] * model] * data)
    key = [L[x].numpy() for x in ("subj_of", "subj_keys", "subj_store",
                                  "sb", "sknd", "slots")]
    wt = _t(WITNESS_TABLE)
    plain = nl.node_fused_deps_resolve(*(_t(a) for a in key), P, wt)
    l0 = dict(tk.LAUNCHES)
    got = sharded_protocol_tick(mesh, wt.to(cuda), key_in=(
        *key, tuple(tuple(t.to(cuda) for t in b) for b in P)))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["node_key_shard"] == l0["node_key_shard"] + 1
    assert tk.LAUNCHES["or_fold"] == l0["or_fold"]
    _eq(plain, got[0])


def test_sharded_tick_across_cards_form_folds_with_or_fold(cuda,
                                                           monkeypatch):
    """The across-card form of the sharded tick (parallel/mesh.py
    _sharded_tick_eager, the stage-by-stage walk a mesh over several cards
    runs), here on one card's virtual 4 x 2 mesh with the eager entries
    made to take their across-card (per-shard) form: its key resolve still
    ORs the 'model' partials with K22's or_fold, and answers as the graph
    and K13's plain version do. Left to choose, the same walk on one card
    takes the one-card form: K13 itself, no or_fold."""
    from accord_tpu_torch.ops import node_lane as nl
    from accord_tpu_torch.parallel import mesh as pm
    L, P = _body_case("foreign_tile_pad_block")
    P = _pad_blocks(P, 128, 2)
    mesh = pm.make_mesh(devices=[cuda] * 8)
    key = [L[x].numpy() for x in ("subj_of", "subj_keys", "subj_store",
                                  "sb", "sknd", "slots")]
    wt = _t(WITNESS_TABLE)
    plain = nl.node_fused_deps_resolve(*(_t(a) for a in key), P, wt)
    key_in = (*key, tuple(tuple(t.to(cuda) for t in b) for b in P))
    l0 = dict(tk.LAUNCHES)
    with monkeypatch.context() as m:
        m.setattr(pm, "_runs_one_card", lambda mesh, probe: False)
        eager = pm._sharded_tick_eager(mesh, wt.to(cuda), key_in, None, (),
                                       (), (), None, 1, None, (), ())
    torch.cuda.synchronize()
    assert tk.LAUNCHES["or_fold"] > l0["or_fold"]
    assert tk.LAUNCHES["sharded_protocol_tick"] == \
        l0["sharded_protocol_tick"]
    _eq(plain, eager[0])
    l1 = dict(tk.LAUNCHES)
    one = pm._sharded_tick_eager(mesh, wt.to(cuda), key_in, None, (), (), (),
                                 None, 1, None, (), ())
    torch.cuda.synchronize()
    assert tk.LAUNCHES["or_fold"] == l1["or_fold"]
    assert tk.LAUNCHES["node_deps_one_card"] == l1["node_deps_one_card"] + 1
    _eq(plain, one[0])
    graph = pm.sharded_protocol_tick(mesh, wt.to(cuda), key_in=key_in)
    _eq(plain, graph[0])


# -- the range body (csrc/range_block.cuh) and K3 (csrc/arena_scatter.cu) --
def _range_case(name):
    c = range_body_case(name)
    heads = [_t(c[x]) for x in ("iv_of", "iv_s", "iv_e", "subj_store", "sb",
                                "sknd", "srng")]
    rblocks = tuple(tuple(_t(x) for x in a) for a in c["rblocks"])
    kblocks = tuple((_t(pack_words(bits)), _t(ts), _t(kd), _t(v))
                    for bits, ts, kd, v in c["kblocks"])
    return c, (*heads, _t(c["r_slots"]), rblocks, _t(c["k_slots"]), kblocks,
               _t(WITNESS_TABLE))


@pytest.mark.parametrize("name", list(RANGE_BODY_CASES))
def test_range_body_cases_kernels(cuda, name):
    """K5 (fused and single), K14 and the covered pass on the range body's
    edges (tests/torch_kernel_cases.py): each bit-equal to its plain
    version, one counted launch a call; a call's trace shows one range
    kernel (its covered words in the same launch) and a key body a key
    block, no memset and no copy; K14's launches the same, one for all
    key blocks; a mesh shard's range launch at an odd column of a wider
    output leaves the words around it alone."""
    from accord_tpu_torch.ops import node_lane as nl
    c, args = _range_case(name)
    g = tuple(_on(args, cuda))
    nr, nk = len(args[8]), len(args[10])
    for fn, count in ((tk.fused_range_deps_resolve, "range_resolve"),
                      (nl.node_fused_range_deps_resolve,
                       "node_range_resolve")):
        plain = fn(*args)
        n0 = tk.LAUNCHES[count]
        got = fn(*g)
        torch.cuda.synchronize()
        assert tk.LAUNCHES[count] == n0 + 1, count
        _eq(plain, got)
    _body_launches(lambda: tk.fused_range_deps_resolve(*g),
                   int(bool(nr or nk)) + nk)
    launch, _rp, _kp = nl.range_launcher(*g)
    _body_launches(launch, int(bool(nr or nk)) + int(bool(nk)))
    single = (args[0], args[1], args[2], args[4], args[5], args[6],
              *args[8][0], *args[10][0], args[11])
    _eq(tk.range_deps_resolve(*single),
        tk.range_deps_resolve(*_on(single, cuda)))
    b, k = args[4].shape[0], c["k"]
    _eq(tk.covered_buckets(*args[:3], b, k),
        tk.covered_buckets(*_on(args[:3], cuda), b, k))
    r = args[8][0]
    out = torch.full((b, 3 + r[0].shape[0] // 32 + 2), -1, dtype=torch.int32)
    shard = (*args[:3], args[3], args[7][:1], args[4], args[5], *r,
             args[11])
    plain = tk.range_block_shard(*shard, out.clone(), 3)
    got = tk.range_block_shard(*_on(shard, cuda), out.to(cuda), 3)
    _eq(plain, got)


@pytest.mark.parametrize("name", list(ARENA_SCATTER_CASES))
def test_arena_scatter_cases_kernels(cuda, name):
    """K3 and its keys-only form on their padding edges: bit-equal to the
    plain versions, one counted launch a call, one kernel and no memset or
    copy in a call's trace."""
    c = arena_scatter_case(name)
    arena = [_t(pack_words(c["bits"])), *(_t(c[x]) for x in (
        "ts", "ex", "kinds", "valid"))]
    ups = [_t(c[x]) for x in ("rows", "key_rows", "key_mods", "ts_rows",
                              "ex_rows", "kind_rows", "valid_rows")]
    ga, gu = _cu(arena, cuda), _cu(ups, cuda)
    plain = tk.arena_scatter(*arena, *ups)
    n0 = tk.LAUNCHES["arena_scatter"]
    got = tk.arena_scatter(*ga, *gu)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["arena_scatter"] == n0 + 1
    _eq(plain, got)
    _eq(tk.arena_scatter_keys(arena[0], *ups[:3]),
        tk.arena_scatter_keys(ga[0], *gu[:3]))
    _body_launches(lambda: tk.arena_scatter(*ga, *gu), 1)
    _body_launches(lambda: tk.arena_scatter_keys(ga[0], *gu[:3]), 1)


# -- K6 range_finalize_csr (csrc/range_finalize.cu): ONE launch ------------
def _fin_args(name, witness=True):
    c = range_fin_case(name)
    wt = WITNESS_TABLE if c["witness"] is None or not witness \
        else c["witness"]
    return [_t(a) for a in c["lanes"]] + [_t(np.asarray(wt, np.int32))], \
        c["out_cap"]


@pytest.mark.parametrize("name", list(RANGE_FIN_CASES))
def test_range_finalize_kernel_shared_cases(cuda, name):
    """K6 against its plain version on the shared cases (the CPU tests
    hold the plain version to the JAX kernel on them): rcap 32 and 96,
    every row invalid, NV 0, iv_of and kinds out of range, witness entries
    other than 0/1, out_cap 0 and overflowed, 44 compaction tiles; one
    launch counted a call."""
    args, out_cap = _fin_args(name)
    plain = tk.range_finalize_csr(*args, out_cap=out_cap)
    n0 = tk.LAUNCHES["range_finalize"]
    got = tk.range_finalize_csr(*_on(args, cuda), out_cap=out_cap)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["range_finalize"] == n0 + 1
    _eq(plain, got)


def test_range_finalize_one_kernel_a_call(cuda):
    """A profiler trace of one eager K6 call: ONE kernel (the compaction,
    its stab words built inside its tiles) and no memset or copy, at 44
    compaction tiles, at one word a row set and at NV 0."""
    for name in ("many_tiles", "rcap32_one_word", "nv0"):
        args, out_cap = _fin_args(name)
        args = _on(args, cuda)
        kernels, moves = _trace_kernels(
            lambda: tk.range_finalize_csr(*args, out_cap=out_cap))
        assert len(kernels) == 1 and not moves, (name, kernels, moves)


def test_range_finalize_stage_replays_twice(cuda):
    """K6 as the megakernel's range-finalize stage: a protocol_tick graph
    of two range finalizes, called twice (the second a replay of the
    first's graph), equal to the plain versions both times, so the
    compaction's scratch is zero again after a replay."""
    wt = _t(WITNESS_TABLE)
    fins = []
    for name in ("rcap96_three_words", "out_cap_overflow"):
        args, out_cap = _fin_args(name, witness=False)
        fins.append(("range", *args[:6], tuple(args[6:11]), out_cap))
    fins = tuple(fins)
    plain = tk.protocol_tick(wt, fins=fins)
    c0 = tk.CAPTURES["protocol_tick"]
    l0 = tk.LAUNCHES["range_finalize"]
    dfins = _deep(fins, cuda)
    first = [tuple(t.cpu() for t in f)
             for f in tk.protocol_tick(wt.to(cuda), fins=dfins)[2]]
    second = tk.protocol_tick(wt.to(cuda), fins=dfins)[2]
    torch.cuda.synchronize()
    assert tk.CAPTURES["protocol_tick"] - c0 <= 1
    assert tk.LAUNCHES["range_finalize"] - l0 == 4
    _eq(list(plain[2]), first)
    _eq(list(plain[2]), list(second))


# -- K21 dag_wavefronts_packed (csrc/dense_dag.cu): ONE launch -------------
def _dag_words(name):
    from accord_tpu_torch.ops import carry
    return carry.packed_adjacency(dag_case(name))


@pytest.mark.parametrize("name", DAG_CASES)
def test_dag_wavefronts_packed_kernel_shared_cases(cuda, name):
    """K21 against its plain version on the shared cases (the CPU tests
    hold the plain version to the JAX kernel on them) at max_levels 0, 1,
    the depth, depth + 1 and far past the fixpoint: a cycle and a row
    waiting on it, a chain, cycles only, no edges, a dense DAG, and rows
    wider than the 64 words the kernel keeps (read on in a later round;
    some run out of kept words inside one ballot)."""
    words = _dag_words(name)
    n = words.shape[0]
    depth = int(tk.dag_wavefronts_packed_plain(words, n + 1).max())
    c_words = words.to(cuda)
    for levels in dag_levels(depth):
        plain = tk.dag_wavefronts_packed(words, levels)
        got = tk.dag_wavefronts_packed(c_words, levels)
        torch.cuda.synchronize()
        _eq(plain, got)


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("name", ["wide_rows", "dag_with_cycle"])
def test_dag_wavefronts_packed_kernel_rows_a_lane(cuda, name, blocks):
    """K21 on a grid capped at `blocks` blocks of 1,024 lanes: at 4,096
    rows a lane owns 4 rows (one block) or 2, the last lanes 1 (three
    blocks), so its live-row mask walks several rows, settled and not,
    between barriers; at 256 rows a lane owns one row or none. Against
    the plain version at every dag_levels count."""
    words = _dag_words(name)
    n = words.shape[0]
    depth = int(tk.dag_wavefronts_packed_plain(words, n + 1).max())
    c_words = words.to(cuda)
    for levels in dag_levels(depth):
        plain = tk.dag_wavefronts_packed(words, levels)
        got = tk.dag_wavefronts_packed(c_words, levels, max_blocks=blocks)
        torch.cuda.synchronize()
        _eq(plain, got)


def test_dag_wavefronts_packed_graph_replays_twice(cuda):
    """K21 captured in a CUDA graph and replayed twice equals the eager
    call and the plain version both times (its flags are zero again after
    every call, and a replay rebuilds its lists and applied sets); a
    second eager call too."""
    words = _dag_words("dag_with_cycle")
    c_words = words.to(cuda)
    plain = tk.dag_wavefronts_packed(words, 40)
    _eq(plain, tk.dag_wavefronts_packed(c_words, 40))
    for out in _graph_twice(lambda: tk.dag_wavefronts_packed(c_words, 40)):
        _eq(plain, out)
    _eq(plain, tk.dag_wavefronts_packed(c_words, 40))


def test_dag_wavefronts_packed_after_dirty_flags(cuda):
    """A barrier generation left at any value costs the next call no
    correctness (its barriers wait for a change, not a value), and the
    call leaves the flags zeroed; the scratch lists, counts and applied
    sets hold garbage from torch.empty and are rebuilt in the call."""
    words = _dag_words("chain")
    c_words = words.to(cuda)
    tk.dag_wavefronts_packed(c_words, 3)        # the scratch exists
    idx = torch.cuda.current_device()
    flags = tk._SCRATCH[idx][:tk._DAG_FLAG_BYTES].view(torch.int32)
    for levels, gen in ((0, 7), (5, -1), (300, 12345)):
        flags[1] = gen
        got = tk.dag_wavefronts_packed(c_words, levels)
        torch.cuda.synchronize()
        _eq(tk.dag_wavefronts_packed(words, levels), got)
        if levels:
            assert not bool(flags.any()), flags.cpu()


def _captured(fn):
    """One call of fn captured in a CUDA graph kept for inspection, after
    a warm call on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return graph


def _graph_node_types(fn):
    """The node types (cuda.h's CUgraphNodeType: 0 a kernel, 1 a
    copy, 2 a memset, ...) of one call of fn captured in a CUDA graph,
    after a warm call. Late in a long process the profiler can deliver no
    event of a cooperative launch at all; a capture records every
    operation the call puts on its stream."""
    import ctypes
    graph = _captured(fn)
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes[:count.value]:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(t)) == 0
        types.append(t.value)
    return types


def _graph_dot(fn):
    """One call of fn captured in a CUDA graph, as libcuda's verbose DOT
    description (cuGraphDebugDotPrint), where a kernel node's label names
    its function on one line -- the kernels of a call without the profiler, whose use here
    can leave it delivering no events to the tests after."""
    import ctypes
    import os
    import tempfile
    graph = _captured(fn)
    cu = ctypes.CDLL("libcuda.so.1")
    fd, path = tempfile.mkstemp(suffix=".dot")
    os.close(fd)
    try:
        assert cu.cuGraphDebugDotPrint(
            ctypes.c_void_p(graph.raw_cuda_graph()), path.encode(), 1) == 0
        with open(path) as f:
            return f.read()
    finally:
        os.unlink(path)


def test_dag_wavefronts_packed_one_kernel_a_call(cuda):
    """One K21 call, captured in a CUDA graph, is ONE kernel node and no
    other (no memset or copy), whatever the data and the level count
    (cut, past the fixpoint, 0)."""
    for name, levels in (("dag_with_cycle", 3), ("dag_with_cycle", 192),
                         ("no_edges", 0), ("all_cycles", 50)):
        c_words = _dag_words(name).to(cuda)
        types = _graph_node_types(
            lambda: tk.dag_wavefronts_packed(c_words, levels))
        assert types == [0], (name, types)
