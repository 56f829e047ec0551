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
from accord_tpu_torch.ops.encoding import WITNESS_TABLE

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


@pytest.mark.parametrize("b,cap,k", [(8, 4096, 128), (64, 16384, 1024)])
def test_max_conflict_kernel(cuda, b, cap, k):
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
    args = [_t(subj), _t(bm), _t(ex), _t(valid)]
    plain = tk.max_conflict(*args)
    n0 = tk.LAUNCHES["max_conflict"]
    got = tk.max_conflict(*_on(args, cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["max_conflict"] == n0 + 1
    _eq(plain, got)
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


@pytest.mark.parametrize("cap,m", [(64, 8), (2048, 64), (16384, 64)])
def test_exec_scatter_kernel(cuda, cap, m):
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


@pytest.mark.parametrize("cap,pending", [(64, 0.6), (2048, 1.0),
                                         (16384, 0.6)])
def test_execution_frontier_kernel(cuda, cap, pending):
    rng = np.random.default_rng(cap)
    lanes = _exec_plane(rng, cap, pending)
    plain = tk.execution_frontier(*lanes)
    n0 = tk.LAUNCHES["execution_frontier"]
    got = tk.execution_frontier(*_on(lanes, cuda))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["execution_frontier"] == n0 + 1
    _eq(plain, got)
    assert int(tk._popcount_u32(plain).sum()) > 0


@pytest.mark.parametrize("caps", [(64, 128), (2048, 1024, 64), (96,)])
def test_fused_execution_frontier_kernel(cuda, caps):
    rng = np.random.default_rng(sum(caps))
    planes = [_exec_plane(rng, c) for c in caps]
    plain = tk.fused_execution_frontier(planes)
    n0 = tk.LAUNCHES["fused_execution_frontier"]
    got = tk.fused_execution_frontier([_on(p, cuda) for p in planes])
    torch.cuda.synchronize()
    assert tk.LAUNCHES["fused_execution_frontier"] == n0 + 1
    _eq(plain, got)


@pytest.mark.parametrize("caps,out_cap", [((64,), 4), ((128, 64, 96), 32),
                                          ((2048,) * 5, 256),
                                          ((16384,), 2048),
                                          ((16384,), 1 << 14)])
def test_frontier_compact_kernel(cuda, caps, out_cap):
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
