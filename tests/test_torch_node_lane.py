"""The cluster tick's node-lane kernels and the protocol megakernel, plain
versions, against the JAX package on the CPU.

The merges are built by BOTH packages' build_key_merge / build_range_merge
from the same recorded plan args (numpy lanes; JAX f32 [cap, K] bitmaps,
packed for the port), so the merged layout -- block order, pad blocks
under slot -1, multi-block span widths, mixed caps -- must agree field for
field, and K13's / K14's plain versions must return the JAX kernels' words
bit for bit. lane_slice and the quorum count (K16) are held against the
JAX functions, and the plain protocol_tick against the JAX program on one
recorded tick with key, rkey and range finalize specs (given out of
signature order), a cmd_tick block, a repair block, an exec block and the
quorum stage: every output bit-equal, in the caller's fin order. Zero
tolerance: every output is an integer or a bit word.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accord_tpu.ops import kernels as jk
from accord_tpu.ops import node_lane as jnl
from accord_tpu.ops.encoding import WITNESS_TABLE
from accord_tpu_torch.ops import carry
from accord_tpu_torch.ops import kernels as tk
from accord_tpu_torch.ops import node_lane as tnl
from tests.test_torch_cmd_kernels import _columns, _ops, _repair_inputs
from tests.test_torch_exec_kernels import _jax as _jplane
from tests.test_torch_exec_kernels import _plane
from tests.test_torch_exec_kernels import _port as _tplane
from torch_kernel_cases import (KEY_BODY_CASES, QUORUM_CASES, key_body_case,
                                pack_words, quorum_case)

K = 128
KC = 40
I32_MIN = np.iinfo(np.int32).min


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(ref, got)


def _key_arena(rng, cap):
    bm = (rng.random((cap, K)) < 0.04).astype(np.float32)
    ts = rng.integers(-40, 40, (cap, 3)).astype(np.int32)
    ts[rng.random(cap) < 0.1, 0] = I32_MIN
    ex = np.full((cap, 3), I32_MIN, np.int32)
    kinds = rng.integers(0, 6, cap).astype(np.int32)
    valid = rng.random(cap) < 0.8
    return bm, ts, ex, kinds, valid


def _range_arena(rng, rcap):
    start = rng.integers(0, 3000, rcap).astype(np.int32)
    end = (start + rng.integers(1, 400, rcap)).astype(np.int32)
    ts = rng.integers(-40, 40, (rcap, 3)).astype(np.int32)
    kinds = rng.integers(0, 6, rcap).astype(np.int32)
    valid = rng.random(rcap) < 0.8
    return start, end, ts, kinds, valid


def _jkey(a):
    return tuple(jnp.asarray(x) for x in a)


def _tkey(a):
    return carry.arena_lanes(a)


def _subjects(rng, b, ngroups):
    n = b - 2
    sb = rng.integers(-40, 40, (b, 3)).astype(np.int32)
    sknd = rng.integers(0, 6, b).astype(np.int32)
    store = np.full(b, ngroups, np.int32)       # padding rows: ngroups
    store[:n] = rng.integers(0, ngroups, n)
    srng = np.zeros(b, bool)
    srng[:n] = rng.random(n) < 0.4
    return sb, sknd, store, srng


def _key_plan(rng, b, caps, fused, pad_tier=None):
    """One plan's recorded key_args, for both packages."""
    ng = len(caps)
    sb, sknd, store, _srng = _subjects(rng, b, ng)
    nnz = 64
    n = 50
    subj_of = np.full(nnz, b, np.int32)
    subj_of[:n] = np.sort(rng.integers(0, b - 2, n))
    subj_keys = np.zeros(nnz, np.int32)
    subj_keys[:n] = rng.integers(0, K, n)
    arenas = [_key_arena(rng, c) for c in caps]
    common = dict(sb=sb, sknd=sknd, subj_store=store, subj_of=subj_of,
                  subj_keys=subj_keys, ngroups=ng,
                  slots=list(range(ng)), fused=fused)
    if fused:
        common["pad_tier"] = pad_tier
    j = dict(common, ksnaps=[_jkey(a) for a in arenas])
    t = dict(common, ksnaps=[_tkey(a) for a in arenas])
    return j, t


def _jpad_key(cap):
    return (jnp.zeros((cap, K), jnp.float32), jnp.zeros((cap, 3), jnp.int32),
            jnp.zeros(cap, jnp.int32), jnp.zeros(cap, bool))


def _tpad_key(cap):
    return (torch.zeros((cap, K // 32), dtype=torch.int32),
            torch.zeros((cap, 3), dtype=torch.int32),
            torch.zeros(cap, dtype=torch.int32),
            torch.zeros(cap, dtype=torch.bool))


def _jpad_range(cap):
    return (jnp.zeros(cap, jnp.int32), jnp.zeros(cap, jnp.int32),
            jnp.zeros((cap, 3), jnp.int32), jnp.zeros(cap, jnp.int32),
            jnp.zeros(cap, bool))


def _tpad_range(cap):
    return (torch.zeros(cap, dtype=torch.int32),
            torch.zeros(cap, dtype=torch.int32),
            torch.zeros((cap, 3), dtype=torch.int32),
            torch.zeros(cap, dtype=torch.int32),
            torch.zeros(cap, dtype=torch.bool))


# plans: single-group (unfused), two-block uniform span (widened to its
# block tier), mixed caps (exact width), a pad_tier plan, three groups
KEY_PLANS = [(8, (64,), False, None), (64, (128, 128), True, None),
             (8, (64, 128), True, None), (64, (64,), True, 2),
             (8, (64, 64, 64), True, None)]


def _key_merges(seed, node_tiers=None):
    rng = np.random.default_rng(seed)
    jent, tent = [], []
    for i, (b, caps, fused, tier) in enumerate(KEY_PLANS):
        j, t = _key_plan(rng, b, caps, fused, tier)
        jent.append((i, j))
        tent.append((i, t))
    jm = jnl.build_key_merge(jent, _jpad_key, node_tiers)
    tm = tnl.build_key_merge(tent, _tpad_key, node_tiers)
    return jm, tm


def _check_key_layout(jm, tm):
    for f in ("subj_of", "subj_keys", "subj_node", "sb", "sknd", "slots"):
        np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f),
                                      err_msg=f)
    assert jm.spans == tm.spans
    assert (jm.rows_used, jm.rows_padded) == (tm.rows_used, tm.rows_padded)
    assert len(jm.blocks) == len(tm.blocks)
    for jb, tb in zip(jm.blocks, tm.blocks):
        assert jb[0].shape[0] == tb[0].shape[0]
        _same(carry.pack_bitmaps(np.asarray(jb[0])).view(np.int32), tb[0])
        for x, y in zip(jb[1:], tb[1:]):
            _same(x, y)


@pytest.mark.parametrize("seed,node_tiers", [(1, None), (2, 16), (3, None)])
def test_key_merge_and_k13_plain_match_jax(seed, node_tiers):
    jm, tm = _key_merges(seed, node_tiers)
    _check_key_layout(jm, tm)
    assert -1 in tm.slots.tolist(), "no pad block in the merge"
    assert any(w > caps[0] // 32 * len(caps)
               for (_r, _b, _w0, w), (_bb, caps, _f, _t)
               in zip(tm.spans, KEY_PLANS)), "no widened span"
    ref = jnl.run_key_merge(jm, jnp.asarray(WITNESS_TABLE))
    got = tnl.run_key_merge(tm, _t(WITNESS_TABLE))
    _same(ref, got)
    assert np.asarray(ref).any(), "vacuous: no dependency bit"


@pytest.mark.parametrize("name", list(KEY_BODY_CASES))
def test_key_body_cases_k13_and_k14_key_side_match_jax(name):
    """K13 and K14's key side (range subjects' covered buckets, gated by
    subj_is_range; no range blocks) on the key body's tiling edges
    (tests/torch_kernel_cases.py): the case's store lane routes subjects
    as the node slot lane, the pad block under slot -1."""
    c = key_body_case(name)
    wt = np.asarray(WITNESS_TABLE)
    jar = tuple((jnp.asarray(bits.astype(np.float32)), jnp.asarray(ts),
                 jnp.asarray(kd), jnp.asarray(v))
                for bits, ts, kd, v in c["blocks"])
    tar = tuple((_t(pack_words(bits)), _t(ts), _t(kd), _t(v))
                for bits, ts, kd, v in c["blocks"])
    names = ("subj_of", "subj_keys", "subj_store", "sb", "sknd", "slots")
    ref = jnl.node_fused_deps_resolve(*(jnp.asarray(c[x]) for x in names),
                                      jar, jnp.asarray(wt))
    got = tnl.node_fused_deps_resolve(*(_t(c[x]) for x in names), tar,
                                      _t(wt))
    _same(ref, got)
    assert np.asarray(ref).any(), "vacuous: no dependency bit"
    rng_names = ("iv_of", "iv_s", "iv_e", "subj_store", "sb", "sknd",
                 "srng")
    empty = np.zeros(0, np.int32)
    _rp, ref = jnl.node_fused_range_deps_resolve(
        *(jnp.asarray(c[x]) for x in rng_names), jnp.asarray(empty), (),
        jnp.asarray(c["slots"]), jar, jnp.asarray(wt))
    _grp, got = tnl.node_fused_range_deps_resolve(
        *(_t(c[x]) for x in rng_names), _t(empty), (), _t(c["slots"]), tar,
        _t(wt))
    _same(ref, got)
    assert np.asarray(ref).any(), "vacuous: no key-side bit"


def _range_plan(rng, b, rcaps, kcaps, fused, has_r=True, has_k=True,
                pad_tier=None):
    ng = max(len(rcaps), len(kcaps))
    sb, sknd, store, srng = _subjects(rng, b, ng)
    nv = 32
    n = 24
    iv_of = np.full(nv, b, np.int32)
    iv_of[:n] = np.sort(rng.integers(-2, b - 2, n))
    iv_s = rng.integers(0, 3000, nv).astype(np.int32)
    iv_e = (iv_s + rng.integers(-5, 300, nv)).astype(np.int32)
    iv_e[:3] = iv_s[:3] + 5000                   # wide: every bucket
    rarenas = [_range_arena(rng, c) for c in rcaps]
    karenas = [_key_arena(rng, c) for c in kcaps]
    common = dict(iv_of=iv_of, iv_s=iv_s, iv_e=iv_e, sb=sb, sknd=sknd,
                  srng=srng, subj_store=store, ngroups=ng,
                  r_slots=list(range(len(rcaps))),
                  k_slots=list(range(len(kcaps))), has_r=has_r, has_k=has_k,
                  fused=fused)
    if fused:
        common["pad_tier"] = pad_tier
    j = dict(common, rsnaps=[_jkey(a) for a in rarenas],
             ksnaps=[_jkey(a) for a in karenas])
    t = dict(common, rsnaps=[carry.range_lanes(a) for a in rarenas],
             ksnaps=[_tkey(a) for a in karenas])
    return j, t


RANGE_PLANS = [(8, (64,), (64,), False, True, True, None),
               (64, (64, 64), (128, 128), True, True, True, None),
               (8, (32, 64), (64,), True, True, False, None),
               (8, (64,), (64, 128), True, False, True, 2)]


def _range_merges(seed, plans=RANGE_PLANS):
    rng = np.random.default_rng(seed)
    jent, tent = [], []
    for i, (b, rc, kc, fused, hr, hk, tier) in enumerate(plans):
        j, t = _range_plan(rng, b, rc, kc, fused, hr, hk, tier)
        jent.append((i, j))
        tent.append((i, t))
    jm = jnl.build_range_merge(jent, _jpad_key, _jpad_range)
    tm = tnl.build_range_merge(tent, _tpad_key, _tpad_range)
    return jm, tm


def _check_range_layout(jm, tm):
    for f in ("iv_of", "iv_s", "iv_e", "subj_node", "sb", "sknd", "srng",
              "r_slots", "k_slots"):
        np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f),
                                      err_msg=f)
    assert jm.spans == tm.spans
    assert len(jm.r_blocks) == len(tm.r_blocks)
    assert len(jm.k_blocks) == len(tm.k_blocks)
    for jb, tb in zip(jm.r_blocks, tm.r_blocks):
        for x, y in zip(jb, tb):
            _same(x, y)


@pytest.mark.parametrize("seed", [4, 5])
def test_range_merge_and_k14_plain_match_jax(seed):
    jm, tm = _range_merges(seed)
    _check_range_layout(jm, tm)
    rp, kp = jnl.run_range_merge(jm, jnp.asarray(WITNESS_TABLE))
    grp, gkp = tnl.run_range_merge(tm, _t(WITNESS_TABLE))
    _same(rp, grp)
    _same(kp, gkp)
    assert np.asarray(rp).any() and np.asarray(kp).any()


@pytest.mark.parametrize("side", ["range-only", "key-only"])
def test_k14_plain_one_side_empty(side):
    """Either block tuple may be empty: that side is a zero-width result."""
    plans = [(8, (64,), (64,), True, side == "range-only",
              side == "key-only", None)]
    jm, tm = _range_merges(6, plans)
    _check_range_layout(jm, tm)
    rp, kp = jnl.run_range_merge(jm, jnp.asarray(WITNESS_TABLE))
    grp, gkp = tnl.run_range_merge(tm, _t(WITNESS_TABLE))
    _same(rp, grp)
    _same(kp, gkp)
    assert (grp.shape[1] == 0) == (side == "key-only")
    assert (gkp.shape[1] == 0) == (side == "range-only")


@pytest.mark.parametrize("r0,w0,rows,words", [
    (0, 0, 8, 4), (5, 3, 16, 8), (60, 30, 8, 4),      # the last two clamp
    (-3, 2, 8, 2), (20, -1, 64, 32)])
def test_lane_slice_plain_matches_jax(r0, w0, rows, words):
    rng = np.random.default_rng(r0 + 7 * w0)
    packed = rng.integers(0, 1 << 32, (64, 32), dtype=np.uint64) \
        .astype(np.uint32)
    ref = jnl.lane_slice(jnp.asarray(packed), r0, w0, rows=rows, words=words)
    got = tnl.lane_slice(_t(packed.view(np.int32)), r0, w0, rows, words)
    _same(ref, got)
    got2 = tnl.lane_slice(_t(packed.view(np.int32)),
                          _t(np.array([r0, w0], np.int32)), None, rows, words)
    _same(ref, got2)


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_lane_slice_many_plain_matches_jax(seed):
    """lane_slice_many over two sources: every window, negative and clamped
    offsets and empty windows included, equals the JAX lane_slice of its
    source."""
    rng = np.random.default_rng(seed)
    packed = [rng.integers(0, 1 << 32, shape, dtype=np.uint64)
              .astype(np.uint32) for shape in ((64, 32), (40, 9))]
    spans = [(0, 0, 0, 8, 4), (1, 60, 30, 8, 4), (0, -3, 2, 8, 2),
             (1, 5, -1, 40, 9), (0, 20, 0, 0, 4)]
    for _ in range(12):
        s = int(rng.integers(0, 2))
        nr, nw = packed[s].shape
        spans.append((s, int(rng.integers(-nr - 4, nr + 4)),
                      int(rng.integers(-nw - 4, nw + 4)),
                      int(rng.integers(1, nr + 1)),
                      int(rng.integers(1, nw + 1))))
    got = tnl.lane_slice_many(tuple(_t(p.view(np.int32)) for p in packed),
                              spans)
    assert len(got) == len(spans)
    for (s, r0, w0, rows, words), g in zip(spans, got):
        ref = jnl.lane_slice(jnp.asarray(packed[s]), r0, w0, rows=rows,
                             words=words)
        _same(ref, g)


def _quorum_case():
    t1, t2 = (1, 10, 3), (1, 11, 4)
    txn = np.array([t1, t1, t2, t1, (0, 0, 0)], np.int32)
    ts = np.array([t1, t1, t2, (1, 99, 5), (0, 0, 0)], np.int32)
    code = np.array([0, 0, 0, 0, 0], np.int32)
    valid = np.array([True, True, True, True, False])
    return txn, ts, code, valid


def _random_quorum(rng, t):
    n = max(1, t - t // 5)
    txn = np.zeros((t, 3), np.int32)
    pool = rng.integers(-5, 5, (max(2, n // 3), 3)).astype(np.int32)
    txn[:n] = pool[rng.integers(0, len(pool), n)]
    ts = np.full((t, 3), I32_MIN, np.int32)
    ts[:n] = np.where(rng.random((n, 1)) < 0.7, txn[:n],
                      rng.integers(-5, 5, (n, 3)))
    code = np.zeros(t, np.int32)
    code[:n] = rng.choice([0, 0, 0, 1, 2, 8, 9, -1], n)
    valid = np.zeros(t, bool)
    valid[:n] = True
    return txn, ts, code, valid


@pytest.mark.parametrize("case", ["unit", 64, 256, 1024])
def test_quorum_count_plain_matches_jax(case):
    lanes = _quorum_case() if case == "unit" else \
        _random_quorum(np.random.default_rng(case), case)
    qsize = 2
    ref = jk.protocol_tick(jnp.zeros((8, 8), jnp.bfloat16),
                           quorum=tuple(jnp.asarray(x) for x in lanes),
                           quorum_size=qsize)[4]
    got = tk.quorum_count(*(_t(x) for x in lanes), qsize)
    for r, g in zip(ref, got):
        _same(r, g)
    got2 = tk.protocol_tick(_t(WITNESS_TABLE), quorum=lanes,
                            quorum_size=qsize)[4]
    for r, g in zip(ref, got2):
        _same(r, g)
    if case == "unit":
        fast, votes, met = (g.tolist() for g in got)
        assert fast == [True, True, True, False, False]
        assert votes[:3] == [2, 2, 1]

        assert met == [True, True, False, False, False]


@pytest.mark.parametrize("name", list(QUORUM_CASES))
def test_quorum_count_shared_cases(name):
    """K16's plain version (and the plain protocol_tick's quorum stage) vs
    the JAX stage on the shared cases the card tests hold the kernel to:
    t 100 and 1,000 (no tile multiple), one txn on every lane, no fast
    lane, qsize 1 and above t, padding whose txn (0, 0, 0) meets real fast
    lanes', codes with bits above the low three."""
    lanes, qsize = quorum_case(name)
    ref = jk.protocol_tick(jnp.zeros((8, 8), jnp.bfloat16),
                           quorum=tuple(jnp.asarray(x) for x in lanes),
                           quorum_size=qsize)[4]
    got = tk.quorum_count(*(_t(x) for x in lanes), qsize)
    for r, g in zip(ref, got):
        _same(r, g)
    for r, g in zip(ref, tk.protocol_tick(_t(WITNESS_TABLE), quorum=lanes,
                                          quorum_size=qsize)[4]):
        _same(r, g)
    fast, votes, met = (np.asarray(r) for r in ref)
    t = len(fast)
    pad = slice(t - t // 5, t)
    if name == "no_fast":
        assert not fast.any() and not votes.any()
    elif name == "one_txn":
        assert (votes[:t - t // 5] == fast.sum()).all()
    elif name == "qsize_above_t":
        assert fast.any() and not met.any()
    elif name == "qsize1":
        assert (met == fast).all()
    elif name == "pad_meets_fast":
        assert (votes[pad] > 0).all() and not fast[pad].any()
    else:
        assert fast.any() and met.any()


def _fin_key(rng, kind, span, kc, w, out_cap, b_plan):
    r0, b, w0, words = span[:4] if kind == "key" else \
        (span[0], span[1], span[4], span[5])
    kid_rows = rng.integers(0, 1 << 32, (kc, w), dtype=np.uint64) \
        .astype(np.uint32)
    s = 32
    slot_subj = np.full(s, b, np.int32)
    slot_subj[:s - 4] = rng.integers(0, b_plan, s - 4)
    slot_kid = np.full(s, kc, np.int32)
    slot_kid[:s - 4] = rng.integers(0, kc, s - 4)
    subj_row = rng.integers(-1, 32 * w, b).astype(np.int32)
    act_ts = rng.integers(-40, 40, (32 * w, 3)).astype(np.int32)
    word_off = int(rng.integers(0, max(1, words - w + 1)))
    lanes = (kid_rows, slot_subj, slot_kid, subj_row, act_ts)
    jspec = (kind, r0, w0, b, words, word_off, jnp.asarray(kid_rows),
             *(jnp.asarray(x) for x in lanes[1:]), out_cap)
    tspec = (kind, r0, w0, b, words, word_off, carry.kid_table(kid_rows),
             *(_t(x) for x in lanes[1:]), out_cap)
    return jspec, tspec


def _fin_range(rng, b, rcap, out_cap):
    nv = 32
    iv_of = rng.integers(-1, b + 1, nv).astype(np.int32)
    iv_s = rng.integers(0, 3000, nv).astype(np.int32)
    iv_e = (iv_s + rng.integers(1, 300, nv)).astype(np.int32)
    ent_ok = rng.random(nv) < 0.8
    sb = rng.integers(-40, 40, (b, 3)).astype(np.int32)
    sknd = rng.integers(0, 6, b).astype(np.int32)
    ra = _range_arena(rng, rcap)
    lanes = (iv_of, iv_s, iv_e, ent_ok, sb, sknd)
    jspec = ("range", *(jnp.asarray(x) for x in lanes), _jkey(ra), out_cap)
    tspec = ("range", *lanes, carry.range_lanes(ra), out_cap)
    return jspec, tspec


def test_protocol_tick_plain_matches_jax():
    rng = np.random.default_rng(11)
    jkm, tkm = _key_merges(12)
    jrm, trm = _range_merges(13)
    jfins, tfins = [], []
    # out of signature order: range, key (two shapes), rkey
    for spec in (_fin_range(rng, 16, 64, 256),
                 _fin_key(rng, "key", tkm.spans[1], KC, 4, 2048, 60),
                 _fin_key(rng, "key", tkm.spans[0], KC, 2, 256, 6),
                 _fin_range(rng, 8, 32, 2048),
                 _fin_key(rng, "rkey", trm.spans[1], KC, 4, 256, 60)):
        jfins.append(spec[0])
        tfins.append(spec[1])
    cap, kcap, kpad_n = 64, 32, 8
    cols = _columns(rng, cap, kcap)
    ops = _ops(rng, 6, kpad_n, np.arange(cap), np.arange(kcap), 500)
    scal = (1, -100, -200, 2)                    # epoch, lane2s, dur_local
    clock = 40
    jcmd = (*(jnp.asarray(a) for a in cols), jnp.int32(clock),
            *(jnp.asarray(a) for a in ops),
            *(jnp.int32(s) for s in scal), True)
    tcmd = (*(_t(a) for a in cols), clock, *(_t(a) for a in ops), *scal,
            True)
    rcols, rvals = _repair_inputs(rng, cap, kcap, 8, 8)
    planes = [_plane(rng, 64), _plane(rng, 96)]
    quorum = _random_quorum(rng, 64)
    jo = jk.protocol_tick(
        jnp.asarray(WITNESS_TABLE),
        key_in=(*(jnp.asarray(getattr(jkm, f)) for f in (
            "subj_of", "subj_keys", "subj_node", "sb", "sknd", "slots")),
            jkm.blocks),
        rng_in=(*(jnp.asarray(getattr(jrm, f)) for f in (
            "iv_of", "iv_s", "iv_e", "subj_node", "sb", "sknd", "srng",
            "r_slots")), jrm.r_blocks, jnp.asarray(jrm.k_slots),
            jrm.k_blocks),
        fins=tuple(jfins), cmds=(jcmd,),
        quorum=tuple(jnp.asarray(x) for x in quorum), quorum_size=2,
        cmd_repairs=(tuple(jnp.asarray(a) for a in rcols + rvals),),
        execs=((tuple(_jplane(p) for p in planes), 256),))
    to = tk.protocol_tick(
        _t(WITNESS_TABLE),
        key_in=(tkm.subj_of, tkm.subj_keys, tkm.subj_node, tkm.sb, tkm.sknd,
                tkm.slots, tkm.blocks),
        rng_in=(trm.iv_of, trm.iv_s, trm.iv_e, trm.subj_node, trm.sb,
                trm.sknd, trm.srng, trm.r_slots, trm.r_blocks, trm.k_slots,
                trm.k_blocks),
        fins=tuple(tfins), cmds=(tcmd,), quorum=quorum, quorum_size=2,
        cmd_repairs=(tuple(_t(a) for a in rcols + rvals),),
        execs=((tuple(_tplane(p) for p in planes), 256),))
    _same(jo[0], to[0])
    for r, g in zip(jo[1], to[1]):
        _same(r, g)
    assert len(jo[2]) == len(to[2]) == 5
    for i, (rf, gf) in enumerate(zip(jo[2], to[2])):
        assert len(rf) == len(gf) == 5
        for r, g in zip(rf, gf):
            _same(r, g)
        assert int(np.asarray(rf[0])[-1]) > 0, f"fin {i} vacuous"
    (rc,), (gc,) = jo[3], to[3]
    assert len(gc) == 14
    for r, g in zip(rc, gc[:13]):
        _same(r, g)
    for r, g in zip(jo[4], to[4]):
        _same(r, g)
    assert jo[5] == () and to[5] == ()
    for r, g in zip(jo[6][0], to[6][0]):
        _same(r, g)
    (re,), (ge,) = jo[7], to[7]
    # exec outputs: the reference's packed lane is bool-per-row; the port's
    # is the packed words (ops/exec_plane.py keeps it packed)
    for r, g in zip(re[:3], ge[:3]):
        _same(r, g)
    _same(np.packbits(np.asarray(re[3]).reshape(-1, 32)[:, ::-1], axis=1)
          .view(">u4").reshape(-1).astype(np.uint32)
          if np.asarray(re[3]).dtype == bool else re[3], ge[3])


def test_protocol_tick_mailbox_raises():
    """The mailbox stage is ported (tests/test_torch_message_plane.py); a
    malformed mailbox block raises before any stage runs."""
    with pytest.raises(ValueError, match="mailbox"):
        tk.protocol_tick(_t(WITNESS_TABLE), mailbox=(1,))
