"""The port's key-path kernels, plain versions, against the JAX kernels.

Every input is made from a numpy seed and reaches both sides as numpy;
the JAX kernels run on the CPU as the JAX package's own tests run them.
The tolerance is zero: every output is an integer or a bit word, and the
port's int32 words are compared as the reference's uint32 bit patterns.
Inputs include padding sentinels (B, cap, KC), duplicate dirty rows,
INT32_MIN lanes, words with bit 31 set, a two-store fused call with a -1
dummy slot, and an out_cap overflow.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accord_tpu.ops import kernels as jk
from accord_tpu.ops.encoding import WITNESS_TABLE
from accord_tpu_torch.ops import carry
from accord_tpu_torch.ops import kernels as tk
from torch_kernel_cases import (ARENA_SCATTER_CASES, KEY_BODY_CASES,
                                KEY_SHARD_CASES, arena_scatter_case,
                                finalize_many_tiles, key_body_case,
                                pack_words)

B, CAP, K, KC = 64, 256, 128, 48
I32_MIN = np.iinfo(np.int32).min
SEEDS = (1, 2, 3)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(ref, got):
    """Bit-equal: a JAX array (any int/uint/bool type) vs a torch tensor."""
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(ref, got)


def _arena(rng, cap=CAP, k=K):
    bm = (rng.random((cap, k)) < 0.03).astype(np.float32)
    ts = rng.integers(-50, 50, (cap, 3)).astype(np.int32)
    ts[rng.random(cap) < 0.1, 0] = I32_MIN
    ex = np.full((cap, 3), I32_MIN, np.int32)
    ex[: cap // 2] = rng.integers(-5, 5, (cap // 2, 3))
    kinds = rng.integers(0, 6, cap).astype(np.int32)
    valid = rng.random(cap) < 0.8
    return bm, ts, ex, kinds, valid


def _subjects(rng, b=B, k=K, nnz=256, fill=0.8):
    n = int(nnz * fill)
    subj_of = np.full(nnz, b, np.int32)          # padding entries: B
    subj_of[:n] = np.sort(rng.integers(0, b, n))
    subj_keys = np.zeros(nnz, np.int32)
    subj_keys[:n] = rng.integers(0, k, n)
    sb = rng.integers(-50, 50, (b, 3)).astype(np.int32)
    sknd = rng.integers(0, 6, b).astype(np.int32)
    return subj_of, subj_keys, sb, sknd


@pytest.mark.parametrize("seed", SEEDS)
def test_deps_resolve(seed):
    rng = np.random.default_rng(seed)
    bm, ts, ex, kinds, valid = _arena(rng)
    subj_of, subj_keys, sb, sknd = _subjects(rng)
    ref = jk.deps_resolve(jnp.asarray(subj_of), jnp.asarray(subj_keys),
                          jnp.asarray(sb), jnp.asarray(sknd), jnp.asarray(bm),
                          jnp.asarray(ts), jnp.asarray(kinds),
                          jnp.asarray(valid), jnp.asarray(WITNESS_TABLE))
    lanes = carry.arena_lanes((bm, ts, ex, kinds, valid))
    got = tk.deps_resolve(_t(subj_of), _t(subj_keys), _t(sb), _t(sknd),
                          lanes[0], lanes[1], lanes[3], lanes[4],
                          _t(WITNESS_TABLE))
    _same(ref, got)
    assert np.asarray(ref).any(), "vacuous: no dependency bit set"


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_deps_resolve_two_stores_and_dummy_slot(seed):
    rng = np.random.default_rng(seed)
    a0, a1 = _arena(rng), _arena(rng, cap=128)
    dummy = (np.zeros((CAP, K), np.float32), np.zeros((CAP, 3), np.int32),
             np.full((CAP, 3), I32_MIN, np.int32), np.zeros(CAP, np.int32),
             np.zeros(CAP, bool))
    subj_of, subj_keys, sb, sknd = _subjects(rng)
    subj_store = rng.integers(0, 2, B).astype(np.int32)
    subj_store[-5:] = 2                          # padding rows: len(groups)
    slots = np.array([0, 1, -1], np.int32)
    arenas = (a0, a1, dummy)
    ref = jk.fused_deps_resolve(
        jnp.asarray(subj_of), jnp.asarray(subj_keys),
        jnp.asarray(subj_store), jnp.asarray(sb), jnp.asarray(sknd),
        jnp.asarray(slots),
        tuple((jnp.asarray(a[0]), jnp.asarray(a[1]), jnp.asarray(a[3]),
               jnp.asarray(a[4])) for a in arenas),
        jnp.asarray(WITNESS_TABLE))
    port = [carry.arena_lanes(a) for a in arenas]
    got = tk.fused_deps_resolve(
        _t(subj_of), _t(subj_keys), _t(subj_store), _t(sb), _t(sknd),
        _t(slots), tuple((p[0], p[1], p[3], p[4]) for p in port),
        _t(WITNESS_TABLE))
    _same(ref, got)
    assert np.asarray(ref).any()


def _jax_arena(block):
    bits, ts, kinds, valid = block
    return (jnp.asarray(bits.astype(np.float32)), jnp.asarray(ts),
            jnp.asarray(kinds), jnp.asarray(valid))


def _port_arena(block):
    bits, ts, kinds, valid = block
    return _t(pack_words(bits)), _t(ts), _t(kinds), _t(valid)


@pytest.mark.parametrize("name", list(KEY_BODY_CASES))
def test_key_body_cases_match_jax(name):
    """K1 single (the case's first block) and fused (every block, slots
    with a pad block, padding subjects) on the key body's tiling edges:
    caps 32 / 96 / mixed with odd word offsets, B 1 / 63 / 65 / 130, K 32
    and 128, a subject with no key, subjects with a key in every word, a
    foreign subject tile, negative CSR rows, keys and kinds."""
    c = key_body_case(name)
    wt = np.asarray(WITNESS_TABLE)
    lanes = [jnp.asarray(c[x]) for x in ("subj_of", "subj_keys", "sb",
                                         "sknd")]
    ref = jk.deps_resolve(*lanes, *_jax_arena(c["blocks"][0]),
                          jnp.asarray(wt))
    got = tk.deps_resolve(_t(c["subj_of"]), _t(c["subj_keys"]), _t(c["sb"]),
                          _t(c["sknd"]), *_port_arena(c["blocks"][0]),
                          _t(wt))
    _same(ref, got)
    ref = jk.fused_deps_resolve(
        lanes[0], lanes[1], jnp.asarray(c["subj_store"]), lanes[2],
        lanes[3], jnp.asarray(c["slots"]),
        tuple(_jax_arena(x) for x in c["blocks"]), jnp.asarray(wt))
    got = tk.fused_deps_resolve(
        _t(c["subj_of"]), _t(c["subj_keys"]), _t(c["subj_store"]),
        _t(c["sb"]), _t(c["sknd"]), _t(c["slots"]),
        tuple(_port_arena(x) for x in c["blocks"]), _t(wt))
    _same(ref, got)
    assert np.asarray(ref).any(), "vacuous: no dependency bit set"


@pytest.mark.parametrize("case", KEY_SHARD_CASES, ids=lambda c: c[0])
def test_key_body_shard_cases_match_jax(case):
    """K1's mesh-shard entry on a case's first block: rows [r0, r0 + rows)
    and the bucket slice [base, base + kl) read in place (row stride nw >
    the slice's words), fused on block 0's slot, written at an odd column
    of a wider output; the JAX kernel on the same rows with the bitmaps
    cleared outside the slice answers the same words."""
    name, r0, rows, base, kl, col = case
    c = key_body_case(name)
    wt = np.asarray(WITNESS_TABLE)
    bits, ts, kinds, valid = (x[r0:r0 + rows] for x in c["blocks"][0])
    k = bits.shape[1]
    masked = np.zeros_like(bits)
    masked[:, base:base + kl] = bits[:, base:base + kl]
    ref = jk.fused_deps_resolve(
        jnp.asarray(c["subj_of"]), jnp.asarray(c["subj_keys"]),
        jnp.asarray(c["subj_store"]), jnp.asarray(c["sb"]),
        jnp.asarray(c["sknd"]), jnp.asarray(c["slots"][:1]),
        (_jax_arena((masked, ts, kinds, valid)),), jnp.asarray(wt))
    words = _t(pack_words(bits))
    out = torch.full((c["sb"].shape[0], col + rows // 32 + 2), -1,
                     dtype=torch.int32)
    tk.deps_resolve_shard(
        _t(c["subj_of"]), _t(c["subj_keys"]), _t(c["subj_store"]),
        _t(c["slots"][:1]), _t(c["sb"]), _t(c["sknd"]),
        words[:, base // 32:(base + kl) // 32], _t(ts), _t(kinds),
        _t(valid), _t(wt), k, base, out, col)
    _same(ref, out[:, col:col + rows // 32])
    assert (out[:, :col] == -1).all() and (out[:, col + rows // 32:] ==
                                           -1).all()
    assert np.asarray(ref).any(), "vacuous: no dependency bit set"


def _finalize_inputs(rng, s=64, out_cap=2048):
    wt = 3 * CAP // 32
    packed = rng.integers(0, 1 << 32, (B, wt), dtype=np.uint64) \
        .astype(np.uint32)
    packed[:, ::3] |= np.uint32(1 << 31)         # bit 31 words
    kid_rows = rng.integers(0, 1 << 32, (KC, CAP // 32), dtype=np.uint64) \
        .astype(np.uint32) & rng.integers(0, 1 << 32, (KC, CAP // 32),
                                          dtype=np.uint64).astype(np.uint32)
    n = s - 6
    slot_subj = np.full(s, B, np.int32)          # padding slots: B / KC
    slot_subj[:n] = np.sort(rng.integers(0, B, n))
    slot_kid = np.full(s, KC, np.int32)
    slot_kid[:n] = rng.integers(0, KC, n)
    subj_row = rng.integers(-1, CAP, B).astype(np.int32)
    act_ts = rng.integers(-100, 100, (CAP, 3)).astype(np.int32)
    act_ts[0] = (I32_MIN, 7, -3)
    return packed, kid_rows, slot_subj, slot_kid, subj_row, act_ts, out_cap


def _finalize_both(packed, word_off, kid_rows, slot_subj, slot_kid,
                   subj_row, act_ts, out_cap):
    ref = jk.finalize_csr(jnp.asarray(packed), jnp.asarray(word_off,
                                                           jnp.int32),
                          jnp.asarray(kid_rows), jnp.asarray(slot_subj),
                          jnp.asarray(slot_kid), jnp.asarray(subj_row),
                          jnp.asarray(act_ts), out_cap=out_cap)
    got = tk.finalize_csr(_t(carry.words_to_i32(packed)), word_off,
                          carry.kid_table(kid_rows), _t(slot_subj),
                          _t(slot_kid), _t(subj_row), _t(act_ts),
                          out_cap=out_cap)
    return ref, got


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("word_off", [0, CAP // 32])
def test_finalize_csr(seed, word_off):
    rng = np.random.default_rng(seed)
    packed, kid_rows, slot_subj, slot_kid, subj_row, act_ts, _ = \
        _finalize_inputs(rng)
    ref, got = _finalize_both(packed, word_off, kid_rows, slot_subj,
                              slot_kid, subj_row, act_ts, 8192)
    for r, g in zip(ref, got):
        _same(r, g)
    total = int(np.asarray(ref[0])[-1])
    assert 0 < total <= 8192
    # the host re-derivation of the checksum agrees with the device word
    assert tk.csr_checksum_host(*(g.numpy() for g in got[:3])) \
        == int(got[4].numpy().view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_finalize_csr_overflow(seed):
    """indptr[-1] past out_cap is the overflow signal: dep_rows keeps the
    first out_cap rows, and the bound and checksum still agree."""
    rng = np.random.default_rng(seed)
    packed, kid_rows, slot_subj, slot_kid, subj_row, act_ts, _ = \
        _finalize_inputs(rng)
    ref, got = _finalize_both(packed, CAP // 32, kid_rows, slot_subj,
                              slot_kid, subj_row, act_ts, 256)
    for r, g in zip(ref, got):
        _same(r, g)
    assert int(np.asarray(ref[0])[-1]) > 256


@pytest.mark.parametrize("out_cap,total_zero", [(256, False),
                                                (1 << 18, False),
                                                (256, True)])
def test_finalize_csr_many_tiles(out_cap, total_zero):
    """48 compaction tiles of the card's one-launch compaction (192 slots
    x 256 words): the total past out_cap, below it, and 0 -- the fixture
    the card test holds K2 and its table entry to."""
    packed, word_off, kid_rows, slot_subj, slot_kid, subj_row, act_ts = \
        finalize_many_tiles(11, total_zero=total_zero)
    assert slot_subj.shape[0] * kid_rows.shape[1] \
        >= 40 * tk.CSR_TILE_WORDS
    ref, got = _finalize_both(packed, word_off, kid_rows, slot_subj,
                              slot_kid, subj_row, act_ts, out_cap)
    for r, g in zip(ref, got):
        _same(r, g)
    total = int(np.asarray(ref[0])[-1])
    if total_zero:
        assert total == 0 and int(got[3]) == 0
    else:
        assert (total > out_cap) == (out_cap == 256) and total > 0
    assert tk.csr_checksum_host(*(g.numpy() for g in got[:3])) \
        == int(got[4].numpy().view(np.uint32))


def _scatter_inputs(rng, m=8, z=64):
    chunk = np.sort(rng.choice(CAP, 5, replace=False)).astype(np.int32)
    rows = np.full(m, chunk[0], np.int32)        # padding repeats row 0
    rows[:len(chunk)] = chunk
    n = 40
    key_rows = np.full(z, CAP, np.int32)         # padding entries: cap
    key_rows[:n] = np.repeat(chunk, 8)
    key_mods = np.zeros(z, np.int32)
    key_mods[:n] = rng.integers(0, K, n)
    ts_rows = rng.integers(-9, 9, (m, 3)).astype(np.int32)
    ts_rows[rows == chunk[0]] = ts_rows[0]
    ex_rows = np.full((m, 3), I32_MIN, np.int32)
    kind_rows = rng.integers(0, 6, m).astype(np.int32)
    kind_rows[rows == chunk[0]] = kind_rows[0]
    valid_rows = np.ones(m, bool)
    return rows, key_rows, key_mods, ts_rows, ex_rows, kind_rows, valid_rows


@pytest.mark.parametrize("seed", SEEDS)
def test_arena_scatter(seed):
    rng = np.random.default_rng(seed)
    arena = _arena(rng)
    ups = _scatter_inputs(rng)
    ref = jk.arena_scatter(*(jnp.asarray(a) for a in arena),
                           *(jnp.asarray(a) for a in ups))
    got = tk.arena_scatter(*carry.arena_lanes(arena), *(_t(a) for a in ups))
    _same(carry.pack_bitmaps(np.asarray(ref[0])), got[0])
    for r, g in zip(ref[1:], got[1:]):
        _same(r, g)


@pytest.mark.parametrize("seed", SEEDS)
def test_arena_scatter_keys(seed):
    rng = np.random.default_rng(seed)
    arena = _arena(rng)
    rows, key_rows, key_mods = _scatter_inputs(rng)[:3]
    ref = jk.arena_scatter_keys(jnp.asarray(arena[0]), jnp.asarray(rows),
                                jnp.asarray(key_rows), jnp.asarray(key_mods))
    got = tk.arena_scatter_keys(carry.arena_lanes(arena)[0], _t(rows),
                                _t(key_rows), _t(key_mods))
    _same(carry.pack_bitmaps(np.asarray(ref)), got)


@pytest.mark.parametrize("name", list(ARENA_SCATTER_CASES))
def test_arena_scatter_cases_match_jax(name):
    """K3 on its padding edges (tests/torch_kernel_cases.py): duplicate
    padding rows, negative row and key indices, CSR entries naming rows
    not in `rows` (their bits OR into the copied row), key_rows == cap,
    m 0, z 0 and K 96."""
    c = arena_scatter_case(name)
    arena = (c["bits"].astype(np.float32), c["ts"], c["ex"], c["kinds"],
             c["valid"])
    ups = tuple(c[x] for x in ("rows", "key_rows", "key_mods", "ts_rows",
                               "ex_rows", "kind_rows", "valid_rows"))
    ref = jk.arena_scatter(*(jnp.asarray(a) for a in arena),
                           *(jnp.asarray(a) for a in ups))
    got = tk.arena_scatter(*carry.arena_lanes(arena), *(_t(a) for a in ups))
    _same(carry.pack_bitmaps(np.asarray(ref[0])), got[0])
    for r, g in zip(ref[1:], got[1:]):
        _same(r, g)
    ref = jk.arena_scatter_keys(*(jnp.asarray(a) for a in (arena[0],
                                                           *ups[:3])))
    got = tk.arena_scatter_keys(carry.arena_lanes(arena)[0],
                                *(_t(a) for a in ups[:3]))
    _same(carry.pack_bitmaps(np.asarray(ref)), got)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lane", ["ts", "exec_ts", "valid"])
def test_scatter_rows(seed, lane):
    rng = np.random.default_rng(seed)
    arena = _arena(rng)
    src = {"ts": arena[1], "exec_ts": arena[2], "valid": arena[4]}[lane]
    idx = np.full(8, CAP, np.int32)              # out of range: dropped
    idx[:6] = rng.choice(CAP, 6, replace=False)
    idx[6] = idx[0]                              # duplicate, same data
    data = src[rng.integers(0, CAP, 8)]
    data[6] = data[0]
    if lane == "exec_ts":
        data[1] = I32_MIN
    ref = jk.scatter_rows(jnp.asarray(src), jnp.asarray(idx),
                          jnp.asarray(data))
    got = tk.scatter_rows(_t(src), _t(idx), _t(data))
    _same(ref, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_kid_word_scatter(seed):
    rng = np.random.default_rng(seed)
    kid_rows = rng.integers(0, 1 << 32, (KC, CAP // 32), dtype=np.uint64) \
        .astype(np.uint32)
    z = 64
    kid_idx = np.full(z, KC, np.int32)           # padding coordinates: KC
    coords = rng.choice(KC * (CAP // 32), 50, replace=False)
    kid_idx[:50] = coords // (CAP // 32)
    word_idx = np.zeros(z, np.int32)
    word_idx[:50] = coords % (CAP // 32)
    words = rng.integers(0, 1 << 32, z, dtype=np.uint64).astype(np.uint32)
    words[::2] |= np.uint32(1 << 31)
    ref = jk.kid_word_scatter(jnp.asarray(kid_rows), jnp.asarray(kid_idx),
                              jnp.asarray(word_idx), jnp.asarray(words))
    got = tk.kid_word_scatter(carry.kid_table(kid_rows), _t(kid_idx),
                              _t(word_idx), _t(carry.words_to_i32(words)))
    _same(ref, got)


def _dirty(rng, cap, m, src):
    """m scatter indices into a lane of `cap` rows with a duplicate (same
    data), a negative index, and out-of-range ones (cap, -cap - 1); and
    their rows, gathered from `src`."""
    idx = rng.integers(0, cap, m).astype(np.int32)
    if m >= 4:
        idx[1] = idx[0]
        idx[2] = -1 - int(rng.integers(0, cap))
        idx[3] = cap
    if m >= 5:
        idx[4] = -cap - 1
    data = src[rng.integers(0, len(src), m)]
    norm = np.where(idx < 0, idx + cap, idx)
    first = {}
    for j, r in enumerate(norm.tolist()):
        if 0 <= r < cap:
            data[j] = data[first.setdefault(r, j)]
    return idx, data


@pytest.mark.parametrize("seed", SEEDS)
def test_lane_table_plain_matches_jax(seed):
    """One lane table holding scatter lanes of different caps (negative,
    out-of-range and duplicate indices, m = 0), the five range-arena lanes
    sharing one index list, and the five arena lanes grown: each lane
    bit-equal to the JAX scatter_rows, range_scatter and arena_grow."""
    rng = np.random.default_rng(seed)
    arena = _arena(rng)
    lanes, refs = [], []
    for src, cap, m in ((arena[1], CAP, 8), (arena[4], CAP, 64),
                        (arena[2][:40], 40, 0), (arena[3][:7], 7, 8)):
        src = np.ascontiguousarray(src)
        idx, data = _dirty(rng, cap, m, src)
        lanes.append((_t(src), _t(idx), _t(data)))
        refs.append(jk.scatter_rows(jnp.asarray(src), jnp.asarray(idx),
                                    jnp.asarray(data)))
    got = tk.lane_table(lanes)
    assert len(got) == len(refs)
    for r, g in zip(refs, got):
        _same(r, g)
    rcap = 96
    starts = rng.integers(0, 1 << 16, rcap).astype(np.int32)
    rlanes = (starts, starts + 7, rng.integers(-50, 50, (rcap, 3))
              .astype(np.int32), rng.integers(0, 6, rcap).astype(np.int32),
              rng.random(rcap) < 0.5)
    rows = _dirty(rng, rcap, 8, np.arange(rcap))[0]
    rdata = [lane[np.where(rows < 0, rows + rcap, rows) % rcap]
             for lane in rlanes]
    ref = jk.range_scatter(*(jnp.asarray(a) for a in (*rlanes, rows,
                                                      *rdata)))
    got = tk.lane_table([(_t(lane), _t(rows), _t(d))
                         for lane, d in zip(rlanes, rdata)])
    for r, g in zip(ref, got):
        _same(r, g)
    ref = jk.arena_grow(*(jnp.asarray(a) for a in arena), new_cap=2 * CAP)
    lanes = carry.arena_lanes(arena)
    got = tk.lane_table([(lane, None, None, 2 * CAP, fill) for lane, fill
                         in zip(lanes, (0, 0, I32_MIN, 0, False))])
    _same(carry.pack_bitmaps(np.asarray(ref[0])), got[0])
    for r, g in zip(ref[1:], got[1:]):
        _same(r, g)


@pytest.mark.parametrize("seed", SEEDS)
def test_arena_grow(seed):
    rng = np.random.default_rng(seed)
    arena = _arena(rng)
    ref = jk.arena_grow(*(jnp.asarray(a) for a in arena), new_cap=2 * CAP)
    got = tk.arena_grow(*carry.arena_lanes(arena), new_cap=2 * CAP)
    _same(carry.pack_bitmaps(np.asarray(ref[0])), got[0])
    for r, g in zip(ref[1:], got[1:]):
        _same(r, g)


def test_popcount_and_checksum_helpers():
    """The bit helpers on words with bit 31 set: SWAR popcount, and the
    device checksum word against its numpy twin."""
    rng = np.random.default_rng(5)
    w = rng.integers(0, 1 << 32, 512, dtype=np.uint64).astype(np.uint32)
    w[:8] = (0xFFFFFFFF, 0x80000000, 1, 0, 0x7FFFFFFF, 0x80000001, 3, 5)
    pc = tk._popcount_u32(_t(carry.words_to_i32(w))).numpy()
    np.testing.assert_array_equal(pc, np.asarray(jk._popcount_u32(
        jnp.asarray(w))))
    ip = rng.integers(-5, 1 << 20, 33).astype(np.int32)
    dr = rng.integers(0, 1 << 14, 256).astype(np.int32)
    dt = rng.integers(I32_MIN, 1 << 30, (256, 3)).astype(np.int32)
    word = int(tk.csr_checksum(_t(ip), _t(dr), _t(dt)).numpy()
               .view(np.uint32))
    assert word == int(np.asarray(jk.csr_checksum(
        jnp.asarray(ip), jnp.asarray(dr), jnp.asarray(dt))))
    assert word == tk.csr_checksum_host(ip, dr, dt)


def test_wrappers_use_plain_version_only_on_cpu():
    """A CPU tensor takes the plain version and counts no launch."""
    tk.reset_launches()
    rng = np.random.default_rng(9)
    arena = carry.arena_lanes(_arena(rng))
    subj_of, subj_keys, sb, sknd = _subjects(rng)
    tk.deps_resolve(_t(subj_of), _t(subj_keys), _t(sb), _t(sknd),
                    arena[0], arena[1], arena[3], arena[4],
                    _t(WITNESS_TABLE))
    assert all(v == 0 for v in tk.LAUNCHES.values())


def test_tier_helpers_match_jax():
    """The padded-size ladders decide every dispatch's shapes; both
    packages must pad the same dispatch to the same sizes."""
    for n in list(range(0, 300)) + list(range(300, 70000, 997)):
        for name in ("subject_tier", "nnz_tier", "scatter_nnz_tier",
                     "out_tier", "bucket_size"):
            assert getattr(tk, name)(n) == getattr(jk, name)(n), (name, n)
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    for size, axis in ((3, 0), (8, 0), (9, 1)):
        np.testing.assert_array_equal(tk.pad_to(a, size, axis),
                                      jk.pad_to(a, size, axis))
