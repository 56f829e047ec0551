"""The port's range-domain and max-conflict kernels, plain versions,
against the JAX kernels.

Every input is made from a numpy seed and reaches both sides as numpy;
the JAX kernels run on the CPU as the JAX package's own tests run them.
The tolerance is zero: every output is an integer or a bit word, the
port's int32 words compared as the reference's uint32 bit patterns, and
the reference's 0/1 matrices (covered buckets, dense hits, subject
bitmaps) compared in the port's packed form (ops/carry.py). The cases
cover the hazards of the port: CSR padding (iv_of == B) and negative
iv_of, interval widths <= 0 and >= K, endpoints whose difference wraps
int32, words with bit 31 set, an out_cap too small for the hits, ent_ok
gating, ties, INT32_MIN lanes and no conflict in max_conflict, and fused
calls of 0-3 blocks on either side.
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
from accord_tpu_torch.ops import node_lane as nl
from torch_kernel_cases import (CONFLICT_BATCH_ROWS, CONFLICT_CASES,
                                MANY_WORD_BUCKETS, RANGE_BODY_CASES,
                                RANGE_FIN_CASES,
                                conflict_case, pack_words, range_body_case,
                                range_fin_case)

B, RCAP, CAP, K = 16, 96, 128, 128
I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _same(ref, got):
    """Bit-equal: a JAX array (any int/uint/bool type) vs a torch tensor."""
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(ref, got)


def _range_arena(rng, rcap=RCAP, domain=4096):
    starts = rng.integers(0, domain, rcap).astype(np.int32)
    ends = (starts + rng.integers(1, 600, rcap)).astype(np.int32)
    ts = rng.integers(-40, 40, (rcap, 3)).astype(np.int32)
    ts[rng.random(rcap) < 0.1, 0] = I32_MIN
    kinds = rng.integers(0, 6, rcap).astype(np.int32)
    valid = rng.random(rcap) < 0.8
    return starts, ends, ts, kinds, valid


def _key_arena(rng, cap=CAP, k=K):
    bm = (rng.random((cap, k)) < 0.04).astype(np.float32)
    ts = rng.integers(-40, 40, (cap, 3)).astype(np.int32)
    ex = np.full((cap, 3), I32_MIN, np.int32)
    kinds = rng.integers(0, 6, cap).astype(np.int32)
    valid = rng.random(cap) < 0.8
    return bm, ts, ex, kinds, valid


def _intervals(rng, b=B, nv=64, domain=4096, hazards=True):
    """An interval CSR: point intervals and ranges, sorted iv_of, padding
    entries (iv_of == b) at the tail, and -- with hazards -- one negative
    iv_of (counts from the end), empty and inverted widths, one wider than
    K, and one whose endpoints wrap int32."""
    n = nv - 6
    iv_of = np.full(nv, b, np.int32)
    iv_of[:n] = np.sort(rng.integers(0, b, n))
    iv_s = rng.integers(0, domain, nv).astype(np.int32)
    width = np.where(rng.random(nv) < 0.5, 1, rng.integers(1, 300, nv))
    iv_e = (iv_s + width).astype(np.int32)
    if hazards:
        iv_of[n - 1] = -1
        iv_e[3] = iv_s[3]                        # width 0
        iv_e[5] = iv_s[5] - 7                    # width < 0
        iv_e[7] = iv_s[7] + 5 * K                # width >= K
        iv_s[9], iv_e[9] = I32_MAX - 2, I32_MIN + 3   # wraps: width 6
        iv_s[11], iv_e[11] = I32_MIN + 1, I32_MAX     # wraps: width -2
    sb = rng.integers(-40, 40, (b, 3)).astype(np.int32)
    sb[: b // 2] = (I32_MAX, 0, 0)               # half see every row
    sknd = rng.integers(0, 6, b).astype(np.int32)
    srng = rng.random(b) < 0.5
    return iv_of, iv_s, iv_e, sb, sknd, srng


# -- K4 range entry ----------------------------------------------------------
@pytest.mark.parametrize("seed,m", [(1, 8), (2, 64)])
def test_range_scatter(seed, m):
    rng = np.random.default_rng(seed)
    lanes = _range_arena(rng)
    chunk = np.sort(rng.choice(RCAP, min(m, 40), replace=False))
    rows = np.full(m, chunk[0], np.int32)        # padding repeats row 0
    rows[:len(chunk)] = chunk
    rows[len(chunk) - 1] = rows[len(chunk) - 1] - RCAP   # negative: wraps
    srcs = [a[rng.integers(0, RCAP, m)] for a in _range_arena(rng)]
    for s in srcs:
        s[rows == chunk[0]] = s[0]               # duplicates carry row 0's
    ref = jk.range_scatter(*_j(*lanes), *_j(rows, *srcs))
    got = tk.range_scatter(*carry.range_lanes(lanes), _t(rows),
                           *(_t(s) for s in srcs))
    for r, g in zip(ref, got):
        _same(r, g)


# -- K5 ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_covered_buckets(seed):
    rng = np.random.default_rng(seed)
    iv_of, iv_s, iv_e = _intervals(rng)[:3]
    ref = jk.covered_buckets(*_j(iv_of, iv_s, iv_e), B, K, 0, K)
    got = tk.covered_buckets(_t(iv_of), _t(iv_s), _t(iv_e), B, K)
    _same(carry.pack_bitmaps(np.asarray(ref)).view(np.uint32),
          got)
    cov = np.asarray(ref).astype(np.float32) > 0.5
    assert cov.all(axis=1).any() and (~cov.all(axis=1)).any()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_range_deps_resolve(seed):
    rng = np.random.default_rng(seed)
    iv_of, iv_s, iv_e, sb, sknd, srng = _intervals(rng)
    r = _range_arena(rng)
    k = _key_arena(rng)
    ref = jk.range_deps_resolve(*_j(iv_of, iv_s, iv_e, sb, sknd, srng, *r,
                                    k[0], k[1], k[3], k[4], WITNESS_TABLE))
    kl = carry.arena_lanes(k)
    got = tk.range_deps_resolve(
        _t(iv_of), _t(iv_s), _t(iv_e), _t(sb), _t(sknd), _t(srng),
        *carry.range_lanes(r), kl[0], kl[1], kl[3], kl[4], _t(WITNESS_TABLE))
    for rr, g in zip(ref, got):
        _same(rr, g)
    assert all(np.asarray(x).any() for x in ref), "vacuous"


@pytest.mark.parametrize("nr,nk", [(1, 1), (2, 2), (3, 1), (0, 2), (2, 0),
                                   (0, 0)])
def test_fused_range_deps_resolve(nr, nk):
    rng = np.random.default_rng(10 * nr + nk)
    iv_of, iv_s, iv_e, sb, sknd, srng = _intervals(rng)
    nblk = max(nr, nk, 1)
    subj_store = rng.integers(0, nblk, B).astype(np.int32)
    subj_store[-2:] = nblk                       # padding rows: len(groups)
    rs = [_range_arena(rng, rcap=64 * (1 + i)) for i in range(nr)]
    ks = [_key_arena(rng, cap=64 * (2 - i % 2)) for i in range(nk)]
    r_slots = np.arange(nr, dtype=np.int32)[::-1].copy()
    k_slots = np.arange(nk, dtype=np.int32)
    ref = jk.fused_range_deps_resolve(
        *_j(iv_of, iv_s, iv_e, subj_store, sb, sknd, srng, r_slots),
        tuple(_j(*a) for a in rs), jnp.asarray(k_slots),
        tuple(_j(a[0], a[1], a[3], a[4]) for a in ks),
        jnp.asarray(WITNESS_TABLE))
    kls = [carry.arena_lanes(a) for a in ks]
    got = tk.fused_range_deps_resolve(
        _t(iv_of), _t(iv_s), _t(iv_e), _t(subj_store), _t(sb), _t(sknd),
        _t(srng), _t(r_slots), tuple(carry.range_lanes(a) for a in rs),
        _t(k_slots), tuple((p[0], p[1], p[3], p[4]) for p in kls),
        _t(WITNESS_TABLE))
    for rr, g in zip(ref, got):
        _same(rr, g)
    if nr:
        assert np.asarray(ref[0]).any()
    if nk:
        assert np.asarray(ref[1]).any()


@pytest.mark.parametrize("name", list(RANGE_BODY_CASES))
def test_range_body_cases_match_jax(name):
    """K5 fused (every block) and single (the first of each side), K14
    (the node form of the same call) and the covered pass on the range
    body's edges (tests/torch_kernel_cases.py): the interval list shuffled
    with negative and padding iv_of, widths <= 0 and >= K, int32 wraps,
    nv 0, range blocks of different caps, one under a slot no subject
    holds, a foreign subject tile, a tile with 1,200 intervals."""
    c = range_body_case(name)
    wt = np.asarray(WITNESS_TABLE)
    b, k = c["sb"].shape[0], c["k"]
    heads = ("iv_of", "iv_s", "iv_e", "subj_store", "sb", "sknd", "srng")
    jr = tuple(_j(*a) for a in c["rblocks"])
    jkb = tuple(_j(bits.astype(np.float32), ts, kd, v)
                for bits, ts, kd, v in c["kblocks"])
    pr = tuple(tuple(_t(x) for x in a) for a in c["rblocks"])
    pk = tuple((_t(pack_words(bits)), _t(ts), _t(kd), _t(v))
               for bits, ts, kd, v in c["kblocks"])
    ref = jk.fused_range_deps_resolve(
        *_j(*(c[x] for x in heads), c["r_slots"]), jr,
        jnp.asarray(c["k_slots"]), jkb, jnp.asarray(wt))
    args = (*(_t(c[x]) for x in heads), _t(c["r_slots"]), pr,
            _t(c["k_slots"]), pk, _t(wt))
    for got in (tk.fused_range_deps_resolve(*args),
                nl.node_fused_range_deps_resolve(*args)):
        for rr, g in zip(ref, got):
            _same(rr, g)
    assert np.asarray(ref[0]).any() or not c["iv_of"].shape[0], "vacuous"
    single = [c[x] for x in ("iv_of", "iv_s", "iv_e", "sb", "sknd", "srng")]
    ref = jk.range_deps_resolve(*_j(*single, *c["rblocks"][0]), *jkb[0],
                                jnp.asarray(wt))
    got = tk.range_deps_resolve(*(_t(x) for x in single), *pr[0], *pk[0],
                                _t(wt))
    for rr, g in zip(ref, got):
        _same(rr, g)
    ref = jk.covered_buckets(*_j(*single[:3]), b, k, 0, k)
    got = tk.covered_buckets(*(_t(x) for x in single[:3]), b, k)
    _same(carry.pack_bitmaps(np.asarray(ref)).view(np.uint32), got)


# -- K6 ----------------------------------------------------------------------
@pytest.mark.parametrize("seed,out_cap", [(1, 4096), (2, 4096), (3, 64)])
def test_segment_compact(seed, out_cap):
    rng = np.random.default_rng(seed)
    hits = (rng.random((40, 96)) < 0.2).astype(np.int32)
    hits[5] = 0                                  # an empty segment
    hits[:, 31] |= rng.random(40) < 0.5          # bit 31 of word 0
    ref = jk._segment_compact(jnp.asarray(hits), out_cap)
    got = tk.segment_compact(carry.packed(hits), out_cap)
    for rr, g in zip(ref, got):
        _same(rr, g)
    total = int(np.asarray(ref[0])[-1])
    assert (total > out_cap) == (out_cap == 64)


def _range_finalize_both(rng, out_cap):
    iv_of, iv_s, iv_e, sb, sknd, _ = _intervals(rng)
    ent_ok = rng.random(iv_of.shape[0]) < 0.8
    ent_ok[-3:] = True                           # padding entries gated
    r = _range_arena(rng)                        #   by iv_of, not ent_ok
    ref = jk.range_finalize_csr(*_j(iv_of, iv_s, iv_e, ent_ok, sb, sknd, *r,
                                    WITNESS_TABLE), out_cap=out_cap)
    got = tk.range_finalize_csr(
        _t(iv_of), _t(iv_s), _t(iv_e), _t(ent_ok), _t(sb), _t(sknd),
        *carry.range_lanes(r), _t(WITNESS_TABLE), out_cap=out_cap)
    return ref, got


@pytest.mark.parametrize("seed,out_cap", [(1, 4096), (2, 4096), (3, 4096),
                                          (4, 32)])
def test_range_finalize_csr(seed, out_cap):
    ref, got = _range_finalize_both(np.random.default_rng(seed), out_cap)
    for rr, g in zip(ref, got):
        _same(rr, g)
    total = int(np.asarray(ref[0])[-1])
    assert total > 0 and (total > out_cap) == (out_cap == 32)
    assert int(np.asarray(ref[3])) >= total      # the stab-count bound
    assert tk.csr_checksum_host(*(g.numpy() for g in got[:3])) \
        == int(got[4].numpy().view(np.uint32))


@pytest.mark.parametrize("name", list(RANGE_FIN_CASES))
def test_range_finalize_shared_cases_match_jax(name):
    """K6's plain version against the JAX kernel on the one-launch
    kernel's edges (tests/torch_kernel_cases.py, which the card tests run
    the kernel on): rcap 32 and 96, every row invalid, NV 0, iv_of below 0
    and >= B, kinds out of range, witness entries other than 0/1, out_cap
    0 and overflowed, 44 compaction tiles."""
    c = range_fin_case(name)
    wt = np.asarray(WITNESS_TABLE if c["witness"] is None else c["witness"],
                    np.int32)
    ref = jk.range_finalize_csr(*_j(*c["lanes"], wt), out_cap=c["out_cap"])
    got = tk.range_finalize_csr(*(_t(a) for a in c["lanes"]), _t(wt),
                                out_cap=c["out_cap"])
    for rr, g in zip(ref, got):
        _same(rr, g)
    total, bound = int(np.asarray(ref[0])[-1]), int(np.asarray(ref[3]))
    assert bound >= total
    if name == "all_rows_invalid" or name == "nv0":
        assert bound == 0
    else:
        assert total > 0, "vacuous"
    if name == "out_cap_overflow":
        assert total > c["out_cap"]


# -- K7 ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_max_conflict(seed):
    """Ties broken by the lowest row, INT32_MIN lanes winning over no
    conflict, invalid rows ignored, and a subject with no overlap."""
    rng = np.random.default_rng(seed)
    b, cap = 16, CAP
    bm, _, _, _, valid = _key_arena(rng)
    ex = rng.integers(-2, 2, (cap, 3)).astype(np.int32)   # many exact ties
    ex[rng.random(cap) < 0.2, 0] = I32_MIN
    ex[rng.random(cap) < 0.1] = I32_MIN                   # all-MIN rows
    subj = (rng.random((b, K)) < 0.05).astype(np.float32)
    subj[0] = 0.0                                # no conflict at all
    bm[: cap // 2, 0] = 0.0
    only = cap // 2 + 3                          # subject 1 meets one row,
    subj[1] = 0.0                                # whose lanes are all MIN
    subj[1, 0] = 1.0
    bm[cap // 2:, 0] = 0.0
    bm[only, 0] = 1.0
    valid[only] = True
    ex[only] = I32_MIN
    ref = jk.max_conflict(*_j(subj, bm, ex, valid))
    got = tk.max_conflict(carry.packed(subj), carry.packed(bm), _t(ex),
                          _t(valid))
    for rr, g in zip(ref, got):
        _same(rr, g)
    lanes, rows = (np.asarray(x) for x in ref)
    assert rows[0] == -1 and (lanes[0] == I32_MIN).all()
    assert rows[1] == only and (lanes[1] == I32_MIN).all()
    assert (rows[2:] >= 0).any()


@pytest.mark.parametrize("name", list(CONFLICT_CASES))
def test_max_conflict_shared_cases(name):
    """K7's plain version vs the JAX kernel on the shared cases the card
    tests hold the kernel to: all-zero subjects beside live ones, exact
    ties whose lowest row lies past the card's first row batch, one
    meeting row with all-INT32_MIN lanes, every row invalid, K 32 (one
    word) and K 1,024 (32 words), a subject of six nonzero words whose
    rows meet only the sixth."""
    subj, bits, ex, valid = conflict_case(name)
    ref = jk.max_conflict(*_j(subj.astype(np.float32),
                              bits.astype(np.float32), ex, valid))
    got = tk.max_conflict(_t(pack_words(subj)), _t(pack_words(bits)),
                          _t(ex), _t(valid))
    for rr, g in zip(ref, got):
        _same(rr, g)
    lanes, rows = (np.asarray(x) for x in ref)
    zero = ~subj.any(1)
    assert zero.any() and (rows[zero] == -1).all() \
        and (lanes[zero] == I32_MIN).all()
    if name == "all_rows_invalid":
        assert (rows == -1).all()
    else:
        assert (rows >= 0).any()
    if name == "ties_in_last_batch":
        assert rows[1] == 5000 > CONFLICT_BATCH_ROWS
        assert (lanes[1] == 7).all()
    if name == "single_min_row":
        assert rows[1] == len(valid) - 5 and (lanes[1] == I32_MIN).all()
    if name == "meet_past_fourth_word":
        words = np.flatnonzero(pack_words(subj)[1])
        assert len(words) == 6
        assert not bits[:, list(MANY_WORD_BUCKETS[:-1])].any()
        assert rows[1] >= 0 and bits[rows[1], MANY_WORD_BUCKETS[-1]]


def test_new_wrappers_use_plain_version_only_on_cpu():
    """CPU tensors take the plain versions and count no launch."""
    tk.reset_launches()
    rng = np.random.default_rng(4)
    ref, _ = _range_finalize_both(rng, 256)
    iv_of, iv_s, iv_e = _intervals(rng)[:3]
    tk.covered_buckets(_t(iv_of), _t(iv_s), _t(iv_e), B, K)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    assert {"range_scatter", "range_resolve", "range_finalize",
            "max_conflict"} <= set(tk.LAUNCHES)
