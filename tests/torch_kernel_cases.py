"""Inputs shared by the port's CPU kernel tests and its card tests.

Everything here is numpy made from a seed (no JAX, no torch), so the CPU
tests (tests/test_torch_cmd_kernels.py, tests/test_torch_kernels.py) hold
the plain versions against the JAX kernels on these cases and the card
tests (tests/test_torch_gpu.py) hold the CUDA kernels against the plain
versions on the same cases.

cmd_tick's op batches are built as the command plane builds them: rows and
kid slots chained through op_prev / op_kprev (p * kpad + s), last writers
flagged, padding slots of kind 0 on row 0 with kids -1 and no VALID flag.
"""
from __future__ import annotations

import numpy as np

I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max
BAL0 = (0, 0, I32_MIN)

# csrc/cmd_tick.cu's op flags
F_PERMIT_FAST, F_EPOCH_OK, F_EXPIRED, F_MSG_HAS_TXN, F_VALID, F_DEPS_EMPTY = \
    1, 2, 4, 8, 16, 32


def lanes3(rng, n):
    """Timestamp-like lanes: small epochs and hlcs, lane2 near -2^31."""
    a = np.empty((n, 3), np.int32)
    a[:, 0] = rng.integers(0, 3, n)
    a[:, 1] = rng.integers(7, 18, n)
    a[:, 2] = I32_MIN + rng.integers(0, 6, n)
    return a


def cmd_columns(rng, cap, kcap):
    """The eight command-arena columns with every status and the ballot,
    executeAt and kid-max hazards."""
    status = rng.choice([0, 1, 3, 5, 6, 7, 8, 9, 10, 11], cap).astype(
        np.int32)
    flags = rng.integers(0, 2, cap).astype(np.int32)
    pr, ab, ea = (lanes3(rng, cap) for _ in range(3))
    pr[rng.random(cap) < 0.4] = BAL0
    ab[rng.random(cap) < 0.5] = BAL0
    ea[rng.random(cap) < 0.4] = I32_MIN
    dur = rng.integers(0, 5, cap).astype(np.int32)
    kmax = lanes3(rng, kcap)
    kmax[rng.random(kcap) < 0.2] = I32_MIN
    return [status, flags, pr, ab, ea, dur, kmax, rng.random(kcap) < 0.6]


def _empty_ops(tier, kpad, now):
    return [np.zeros(tier, np.int32), np.zeros(tier, np.int32),
            np.zeros((tier, 3), np.int32), np.zeros((tier, 3), np.int32),
            np.full((tier, 3), I32_MIN, np.int32),
            np.full((tier, kpad), -1, np.int32), np.zeros(tier, np.int32),
            np.full(tier, now, np.int32), np.full(tier, -1, np.int32),
            np.zeros(tier, bool), np.full((tier, kpad), -1, np.int32),
            np.zeros((tier, kpad), bool)]


def _link(ops, kpad):
    """op_prev / op_rlast / op_kprev / op_klast from op_row and op_keys
    over the ops that carry VALID (the plane's chains)."""
    kind, row, _t, _b, _e, keys, flags, _n, prev, rlast, kprev, klast = ops
    last_row, last_kid = {}, {}
    for j in np.nonzero(flags & F_VALID)[0]:
        r = int(row[j])
        prev[j] = last_row.get(r, -1)
        last_row[r] = j
        for s in range(kpad):
            kid = int(keys[j, s])
            if kid < 0:
                continue
            if kid in last_kid:
                p, ps = last_kid[kid]
                kprev[j, s] = p * kpad + ps
            last_kid[kid] = (j, s)
    for j in last_row.values():
        rlast[j] = True
    for j, s in last_kid.values():
        klast[j, s] = True
    return ops


def _random_flags(rng):
    f = F_VALID
    for bit, p in ((F_PERMIT_FAST, 0.6), (F_EPOCH_OK, 0.8), (F_EXPIRED, 0.15),
                   (F_MSG_HAS_TXN, 0.6), (F_DEPS_EMPTY, 0.6)):
        if rng.random() < p:
            f |= bit
    return f


def cmd_ops(rng, n_real, tier, rows, kids, now, kpad=4):
    """A random op batch: n_real ops of every kind over `rows` and `kids`
    (up to kpad kids an op, in random slots), padding after n_real."""
    ops = _empty_ops(tier, kpad, now)
    kind, row, txn, bal, exe, keys, flags, op_now = ops[:8]
    for j in range(n_real):
        kind[j] = rng.integers(0, 4)
        row[j] = int(rng.choice(rows))
        txn[j] = lanes3(rng, 1)[0]
        bal[j] = BAL0 if rng.random() < 0.6 else lanes3(rng, 1)[0]
        if rng.random() < 0.7:
            exe[j] = lanes3(rng, 1)[0]
        ks = rng.choice(kids, rng.integers(0, min(kpad, len(kids)) + 1),
                        replace=False)
        slots = rng.choice(kpad, len(ks), replace=False)
        keys[j, slots] = ks
        flags[j] = _random_flags(rng)
        op_now[j] = min(now + int(rng.integers(-2, 3)), I32_MAX)
    return _link(ops, kpad)


def one_row_run(rng, tier, kpad, row=5):
    """Every real op on ONE row (op_prev = i - 1 throughout), the four
    kinds interleaved in a repeating order with random ballots and flags;
    each op names one or two kids of a small set."""
    ops = _empty_ops(tier, kpad, 50)
    kind, rows, txn, bal, exe, keys, flags = ops[:7]
    order = (0, 1, 0, 2, 3, 1, 2, 0, 3, 3, 2, 1)
    for j in range(tier):
        kind[j] = order[j % len(order)]
        rows[j] = row
        txn[j] = (0, 12, I32_MIN + 1)
        bal[j] = BAL0 if rng.random() < 0.5 else (0, int(rng.integers(1, 6)),
                                                  I32_MIN + 1)
        exe[j] = (0, 30 + int(rng.integers(0, 3)), I32_MIN + 1)
        for s in rng.choice(kpad, min(kpad, 1 + j % 2), replace=False):
            keys[j, s] = int(rng.integers(0, 3))
        flags[j] = _random_flags(rng) | F_VALID
    return _link(ops, kpad)


def kid_links_across_slots(rng, tier, kpad, nkids=6):
    """Each op names every kid of a small set in a rotated slot order, so a
    kid's previous writer is mostly in another slot (p * kpad + s' with
    s' != s); rows are distinct, so only the kid chains link ops."""
    ops = _empty_ops(tier, kpad, 40)
    kind, rows, txn, bal, exe, keys, flags = ops[:7]
    for j in range(tier):
        kind[j] = rng.integers(0, 4)
        rows[j] = j
        txn[j] = lanes3(rng, 1)[0]
        bal[j] = BAL0 if rng.random() < 0.7 else lanes3(rng, 1)[0]
        exe[j] = lanes3(rng, 1)[0]
        for s in range(kpad):
            keys[j, s] = (s + j) % nkids if s < nkids else -1
        flags[j] = _random_flags(rng)
    return _link(ops, kpad)


def all_preaccept_slow(rng, tier, kpad, cap):
    """Every op a PreAccept of a fresh row (status 0, no definition, no
    executeAt) without PERMIT_FAST and not expired: each takes the slow
    path, witnesses unique_now and moves the clock, so the clock carries
    through every op. -> (columns, ops)."""
    cols = cmd_columns(rng, cap, 4 * kpad)
    cols[0][:] = 0
    cols[1][:] = 0
    cols[2][:] = BAL0
    cols[4][:] = I32_MIN
    ops = _empty_ops(tier, kpad, 100)
    kind, rows, txn, bal, exe, keys, flags, op_now = ops[:8]
    for j in range(tier):
        kind[j] = 0
        rows[j] = j % cap
        txn[j] = (0, int(rng.integers(0, 200)), I32_MIN + 1)
        bal[j] = BAL0
        for s in range(kpad):
            keys[j, s] = int(rng.integers(0, 4 * kpad))
        flags[j] = F_VALID | F_EPOCH_OK | F_MSG_HAS_TXN
        op_now[j] = 100 + int(rng.integers(-3, 3))
    return cols, _link(ops, kpad)


# node_epoch, lane2_clean, lane2_rej, dur_local
CMD_SCALARS = (1, I32_MIN + 1, ((0x8000 << 16) | 1) - (1 << 31), 3)
CMD_CASES = ("random_kpad1", "random_kpad3", "random_kpad8", "one_row_run",
             "kid_links_across_slots", "all_preaccept_slow")


def cmd_case(name, tier=64):
    """(columns, clock, ops, promote) of the K10 fixture `name` at an op
    tier of `tier` (the CPU tests' 64; the card tests also run 512)."""
    if name.startswith("random_kpad"):
        kpad = int(name[len("random_kpad"):])
        rng = np.random.default_rng(100 + kpad + tier)
        cap, kcap = max(64, 2 * tier), 48
        return (cmd_columns(rng, cap, kcap), 20,
                cmd_ops(rng, tier - tier // 8, tier,
                        rows=rng.choice(cap, tier // 4, replace=False),
                        kids=rng.choice(kcap, 10, replace=False), now=16,
                        kpad=kpad), kpad % 2 == 1)
    rng = np.random.default_rng(tier)
    if name == "one_row_run":
        return cmd_columns(rng, 16, 8), 30, one_row_run(rng, tier, 4), True
    if name == "kid_links_across_slots":
        return (cmd_columns(rng, tier, 8), 25,
                kid_links_across_slots(rng, tier, 4), False)
    if name == "all_preaccept_slow":
        cols, ops = all_preaccept_slow(rng, tier, 4, tier)
        return cols, 10, ops, False
    raise KeyError(name)


def finalize_many_tiles(seed, total_zero=False, s=192, w=256, b=48):
    """A finalize over s slots x w words (192 x 256 = 48 compaction tiles
    of 1,024 words): (packed u32[b, 2w], word_off, kid_rows u32[40, w],
    slot_subj, slot_kid, subj_row, act_ts) as numpy, the kid masks dense
    enough that the total is far past a small out_cap; `total_zero`
    clears every kid mask so the total is 0."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (b, 2 * w), dtype=np.uint64) \
        .astype(np.uint32)
    kc = 40
    kid = (rng.integers(0, 1 << 32, (kc, w), dtype=np.uint64)
           & rng.integers(0, 1 << 32, (kc, w), dtype=np.uint64)) \
        .astype(np.uint32)
    if total_zero:
        kid[:] = 0
    slot_subj = np.full(s, b, np.int32)
    slot_subj[:s - 5] = np.sort(rng.integers(0, b, s - 5))
    slot_kid = np.full(s, kc, np.int32)
    slot_kid[:s - 5] = rng.integers(0, kc, s - 5)
    subj_row = rng.integers(-1, 32 * w, b).astype(np.int32)
    act_ts = rng.integers(-1000, 1000, (32 * w, 3)).astype(np.int32)
    return words, w // 2, kid, slot_subj, slot_kid, subj_row, act_ts


# -- K18 deps_matrix and K19 transitive_closure (csrc/dense_dag.cu) ---------
def pack_words(bits):
    """bool/0-1 [rows, K] (K a multiple of 32) -> int32 [rows, K/32], column
    32*w + i in bit i of word w (the port's packed rows)."""
    b = np.asarray(bits).astype(bool)
    return np.packbits(b, axis=1, bitorder="little").view("<u4") \
        .view(np.int32)


DEPS_CASES = ("kw1", "all_zero", "odd_two_chunks", "sparse_buckets",
              "ragged_chunk")


def deps_case(name):
    """deps_matrix's inputs for the fixture `name` as numpy: (subject
    bitmaps f32[B, K], subj_before i32[B, 3], subj_kinds i32[B], active
    bitmaps f32[A, K], act_ts i32[A, 3], act_kinds i32[A], act_valid
    bool[A]), with INT32_MIN lanes, equal triples and out-of-range kinds.
    kw1: K 32 (one word). all_zero: zero bitmaps (no overlap at all).
    odd_two_chunks: odd B and A, K 1,024 (two 16-word chunks).
    sparse_buckets: 1-4 buckets a subject and 4 an active in 1,024, as
    the PreAccept batch's bitmaps. ragged_chunk: K 1,056 (33 words)."""
    b, a, k, seed = {"kw1": (37, 70, 32, 1), "all_zero": (40, 90, 96, 2),
                     "odd_two_chunks": (97, 301, 1024, 3),
                     "sparse_buckets": (130, 600, 1024, 4),
                     "ragged_chunk": (67, 259, 1056, 5)}[name]
    rng = np.random.default_rng(seed)
    if name == "sparse_buckets":
        sbm = np.zeros((b, k), np.float32)
        abm = np.zeros((a, k), np.float32)
        for r in range(b):
            sbm[r, rng.integers(0, 200, rng.integers(1, 5))] = 1
        for r in range(a):
            abm[r, rng.integers(0, 200, 4)] = 1
    else:
        p = max(0.03, 3 / k)
        sbm = (rng.random((b, k)) < p).astype(np.float32)
        abm = (rng.random((a, k)) < p).astype(np.float32)
    if name == "all_zero":
        sbm[:] = 0
        abm[:] = 0
    sb = rng.integers(-3, 3, (b, 3)).astype(np.int32)
    ts = rng.integers(-3, 3, (a, 3)).astype(np.int32)
    ts[::5, 0] = I32_MIN
    sb[::7, 0] = I32_MIN
    ts[1] = sb[0]
    sbm[0] = abm[1]
    sk = rng.integers(-2, 8, b).astype(np.int32)
    ak = rng.integers(-8, 8, a).astype(np.int32)
    valid = rng.random(a) < 0.8
    return sbm, sb, sk, abm, ts, ak, valid


CLOSURE_CASES = ("dag", "cycles", "chain")
# 0, one squaring, below the depth, and well past the fixpoint
CLOSURE_ITERS = (0, 1, 2, 20)


def closure_case(name, n):
    """bool[n, n] adjacency of the K19 fixture `name`: dag a random
    lower-triangular DAG (i depends on earlier rows, as the port's deps
    are); cycles a random graph with cycles; chain the path where row i
    depends on i - 1 (depth n - 1: ceil(log2(n - 1)) squarings close it)."""
    rng = np.random.default_rng(n + len(name))
    if name == "chain":
        adj = np.zeros((n, n), bool)
        adj[np.arange(1, n), np.arange(n - 1)] = True
        return adj
    adj = rng.random((n, n)) < 3.0 / n
    if name == "dag":
        adj = np.tril(adj, -1)
    return adj


# -- K1/K13's key body (csrc/deps_block.cuh): the tiling's edges -----------
# (subjects B, block caps, buckets K, seed): caps 32 and 96 (under one
# 32-word tile), B 1 / 63 / 65 / 130 (ragged 64-subject tiles), K 32 and
# 128 (nw 1 and 4), mixed caps whose word offsets are odd (1, 4, 6; the
# output row stride 22 words), a cap of 34 words (two tiles, the second
# 2 words), a subject tile foreign to every block but one, a pad block.
KEY_BODY_CASES = {
    "cap32_b1_k32": (1, (32,), 32, 1),
    "cap96_b63_k128": (63, (96,), 128, 2),
    "b65_mixed_caps_odd_off": (65, (32, 96, 64, 512), 128, 3),
    "b130_dense_words_two_tiles": (130, (1088,), 1024, 4),
    "foreign_tile_pad_block": (130, (64, 512, 64), 256, 5),
    "negative_keys_kinds": (65, (64, 32), 64, 6),
}
# a node table's shape at which a CTA walks a run of subject tiles (the
# grid would exceed 2,048 CTAs: 128 blocks x 33 tiles, runs of 2, the last
# run half past B); the card tests only (a 128-block JAX trace is slow)
KEY_BODY_RUN_CASES = {"tile_runs_128_blocks": (2053, (32,) * 128, 64, 7)}
# a mesh shard of a case's first block: (case, first row, rows, first
# bucket, buckets, output column): the shard reads a 'model' word slice of
# a wider arena in place (row stride nw > its nwl) into an odd column
KEY_SHARD_CASES = (("b130_dense_words_two_tiles", 544, 544, 512, 512, 3),
                   ("cap96_b63_k128", 32, 64, 64, 64, 1),
                   ("b65_mixed_caps_odd_off", 0, 32, 32, 32, 5))


def key_body_case(name, nk=6):
    """The inputs of one KEY_BODY_CASES case as numpy: subj_of, subj_keys
    i32[nnz] (the CSR; pad entries B, a few negative rows and keys, which
    count from the end), subj_store i32[B] (the block each subject asks;
    B's padding value len(caps) matches no block), sb i32[B, 3], sknd
    i32[B] (30% of kinds in -3 .. nk + 2: wrapped once, then clamped), slots i32[S]
    (the pad block's -1), blocks: per block (bits bool[cap, K], ts i32[cap,
    3], kinds i32[cap], valid bool[cap]; rows 32-63 of each block all
    invalid), and a range CSR over the buckets for K14's key side: iv_of,
    iv_s, iv_e i32[nv] (pad B) and srng bool[B]. Subject 1 has no key;
    in the dense case subjects 2-9 have a key in every word."""
    b, caps, k, seed = {**KEY_BODY_CASES, **KEY_BODY_RUN_CASES}[name]
    rng = np.random.default_rng(100 + seed)
    nblk = len(caps)
    pad = name == "foreign_tile_pad_block"
    slots = np.arange(nblk, dtype=np.int32)
    if pad:
        slots[-1] = -1
    store = rng.integers(0, nblk - pad, b).astype(np.int32)
    store[3::11] = nblk                         # padding subjects
    if pad:
        store[64:128] = 1                       # tile 1: block 1's only
    hot = min(k, 48)                            # most keys in a hot range

    def draw(n):
        return np.where(rng.random(n) < 0.7, rng.integers(0, hot, n),
                        rng.integers(0, k, n))

    def kinds(n):
        return np.where(rng.random(n) < 0.3, rng.integers(-3, nk + 3, n),
                        rng.integers(0, nk - 1, n)).astype(np.int32)
    keys = []
    for s in range(b):
        n = int(rng.integers(1, 5))
        ks = draw(n)
        if name == "negative_keys_kinds":
            ks = np.where(rng.random(n) < 0.4, ks - k, ks)
        keys.append(ks)
    if b > 1:
        keys[1] = np.zeros(0, np.int64)
    if name == "b130_dense_words_two_tiles":
        for s in range(2, 10):
            keys[s] = 32 * np.arange(k // 32) + rng.integers(0, 32, k // 32)
    of = np.concatenate([np.full(len(x), i) for i, x in enumerate(keys)])
    kk = np.concatenate(keys)
    if name == "negative_keys_kinds":
        neg = rng.random(of.shape[0]) < 0.2
        of = np.where(neg, of - b, of)
    nnz = of.shape[0] + 5
    subj_of = np.full(nnz, b, np.int32)
    subj_of[:of.shape[0]] = of
    subj_keys = np.zeros(nnz, np.int32)
    subj_keys[:kk.shape[0]] = kk
    sb = rng.integers(-3, 3, (b, 3)).astype(np.int32)
    sb[3::7, 0] = I32_MIN
    sknd = kinds(b)
    blocks = []
    for z, cap in enumerate(caps):
        bits = np.zeros((cap, k), bool)
        for r in range(cap):
            bits[r, draw(int(rng.integers(1, 5)))] = True
        ts = rng.integers(-3, 3, (cap, 3)).astype(np.int32)
        ts[::5, 0] = I32_MIN
        kd = kinds(cap)
        valid = rng.random(cap) < 0.8
        valid[32:64] = False
        if pad and z == nblk - 1:
            valid[:] = False
        blocks.append((bits, ts, kd, valid))
    nv = b + 3
    iv_of = np.full(nv, b, np.int32)
    iv_of[:b] = rng.permutation(b)
    iv_s = rng.integers(0, k, nv).astype(np.int32)
    iv_e = (iv_s + rng.integers(-3, k // 4 + 2, nv)).astype(np.int32)
    iv_e[:2] = iv_s[:2] + 2 * k                 # wide: every bucket
    srng = rng.random(b) < 0.6
    return dict(subj_of=subj_of, subj_keys=subj_keys, subj_store=store,
                sb=sb, sknd=sknd, slots=slots, blocks=blocks, iv_of=iv_of,
                iv_s=iv_s, iv_e=iv_e, srng=srng)


# -- K5's range body (csrc/range_block.cuh) ----------------------------------
# (subjects B, range caps, key caps, buckets K, intervals nv, seed): the
# interval list in shuffled order with negative iv_of (counting from the
# end) and padding iv_of == B spread through it, widths <= 0 and >= K and
# endpoints that wrap int32; range blocks of different caps, one of them
# under a slot no subject holds; a subject tile of no block's slot; nv 0;
# and one subject tile with more intervals than the body stages at once
# (RB_IV_CAP, 1,024), read in rounds.
RANGE_BODY_CASES = {
    "shuffled_neg_pad_b130": (130, (96,), (128,), 256, 400, 1),
    "nv0": (65, (64,), (64,), 128, 0, 2),
    "rcaps_unowned_block": (130, (64, 160, 32), (128, 64), 256, 500, 3),
    "one_tile_1200_intervals": (64, (128,), (64,), 128, 1200, 4),
}


def range_body_case(name, nk=6):
    """The inputs of one RANGE_BODY_CASES case as numpy: iv_of, iv_s,
    iv_e i32[nv]; subj_store i32[B] (the padding value len(blocks) names
    no block; subjects 64-127 of a case with B > 128 name none either),
    sb i32[B, 3], sknd i32[B], srng bool[B]; r_slots i32[R] (the last
    range block's slot held by no subject when R > 1) and rblocks (start,
    end, ts, kinds, valid per range block); k_slots i32[Z] and kblocks
    (bits bool[cap, K], ts, kinds, valid per key block)."""
    b, rcaps, caps, k, nv, seed = RANGE_BODY_CASES[name]
    rng = np.random.default_rng(200 + seed)
    nblk = max(len(rcaps), len(caps))
    store = rng.integers(0, nblk, b).astype(np.int32)
    store[5::9] = nblk                          # padding subjects
    if b > 128:
        store[64:128] = nblk                    # a tile of no block's slot
    r_slots = np.arange(len(rcaps), dtype=np.int32)[::-1].copy()
    if len(rcaps) > 1:
        r_slots[-1] = nblk + 7                  # a block no subject asks
    k_slots = np.arange(len(caps), dtype=np.int32)
    domain = 4096
    iv_of = np.full(nv, b, np.int32)
    n = nv * 7 // 8
    iv_of[:n] = rng.integers(0, b, n)
    if name == "one_tile_1200_intervals":
        iv_of[:n] = rng.integers(0, 8, n)       # all in one tile's head
    neg = rng.random(nv) < 0.15
    iv_of = np.where(neg & (iv_of < b), iv_of - b, iv_of).astype(np.int32)
    iv_s = rng.integers(0, domain, nv).astype(np.int32)
    width = np.where(rng.random(nv) < 0.5, 1, rng.integers(1, 300, nv))
    iv_e = (iv_s + width).astype(np.int32)
    if nv:
        iv_e[0] = iv_s[0]                       # width 0
        iv_e[1] = iv_s[1] - 7                   # width < 0
        iv_e[2] = iv_s[2] + 5 * k               # width >= K
        iv_s[3], iv_e[3] = I32_MAX - 2, I32_MIN + 3   # wraps: width 6
        iv_s[4], iv_e[4] = I32_MIN + 1, I32_MAX       # wraps: width -2
    perm = rng.permutation(nv)
    iv_of, iv_s, iv_e = iv_of[perm], iv_s[perm], iv_e[perm]
    sb = rng.integers(-40, 40, (b, 3)).astype(np.int32)
    sb[: b // 2] = (I32_MAX, 0, 0)              # half see every row
    sb[3::7, 0] = I32_MIN
    sknd = np.where(rng.random(b) < 0.3, rng.integers(-3, nk + 3, b),
                    rng.integers(0, nk - 1, b)).astype(np.int32)
    srng = rng.random(b) < 0.6
    rblocks = []
    for rcap in rcaps:
        st = rng.integers(0, domain, rcap).astype(np.int32)
        en = (st + rng.integers(1, 600, rcap)).astype(np.int32)
        ts = rng.integers(-40, 40, (rcap, 3)).astype(np.int32)
        ts[rng.random(rcap) < 0.1, 0] = I32_MIN
        kd = rng.integers(-2, nk + 2, rcap).astype(np.int32)
        valid = rng.random(rcap) < 0.8
        valid[32:64] = False                    # a row word of no valid row
        rblocks.append((st, en, ts, kd, valid))
    kblocks = []
    for cap in caps:
        bits = rng.random((cap, k)) < 0.04
        ts = rng.integers(-40, 40, (cap, 3)).astype(np.int32)
        kd = rng.integers(0, nk, cap).astype(np.int32)
        valid = rng.random(cap) < 0.8
        kblocks.append((bits, ts, kd, valid))
    return dict(iv_of=iv_of, iv_s=iv_s, iv_e=iv_e, subj_store=store, sb=sb,
                sknd=sknd, srng=srng, r_slots=r_slots, rblocks=rblocks,
                k_slots=k_slots, kblocks=kblocks, k=k)


# -- K3 arena_scatter (csrc/arena_scatter.cu) --------------------------------
# (cap, K, dirty rows m, CSR entries z, seed): duplicate padding rows (the
# first dirty row repeated, its data identical), negative row and key
# indices (counting from the end), CSR entries naming rows not in `rows`,
# padding key_rows == cap, m 0, z 0, and K 96 (3 words a row: no 16-byte
# vectors).
ARENA_SCATTER_CASES = {
    "dup_pad_foreign_csr": (256, 128, 64, 512, 1),
    "negative_indices": (320, 256, 16, 200, 2),
    "m0": (128, 128, 0, 64, 3),
    "z0": (128, 128, 8, 0, 4),
    "k96_scalar_words": (96, 96, 8, 40, 5),
}


def arena_scatter_case(name):
    """One ARENA_SCATTER_CASES case as numpy: the arena (bits bool[cap,
    K], ts, exec_ts i32[cap, 3], kinds i32[cap], valid bool[cap]) and the
    update (rows i32[m], key_rows, key_mods i32[z], ts_rows, exec_rows
    i32[m, 3], kind_rows i32[m], valid_rows bool[m]); entries that name one
    row carry that row's data."""
    cap, k, m, z, seed = ARENA_SCATTER_CASES[name]
    rng = np.random.default_rng(300 + seed)
    bits = rng.random((cap, k)) < 0.1
    ts = rng.integers(-9, 9, (cap, 3)).astype(np.int32)
    ex = rng.integers(-9, 9, (cap, 3)).astype(np.int32)
    ex[::5, 0] = I32_MIN
    kinds = rng.integers(0, 6, cap).astype(np.int32)
    valid = rng.random(cap) < 0.5
    chunk = rng.choice(cap, max(1, m * 2 // 3), replace=False)
    rows = np.full(m, chunk[0], np.int32)       # padding repeats row 0
    rows[:min(m, len(chunk))] = chunk[:m]
    if m > 4:
        rows[1::4] -= cap                       # negative: counts from end
    nrow = rows % cap if m else rows
    new_ts = rng.integers(-9, 9, (cap, 3)).astype(np.int32)
    new_ex = rng.integers(-9, 9, (cap, 3)).astype(np.int32)
    new_kd = rng.integers(0, 6, cap).astype(np.int32)
    new_vl = rng.random(cap) < 0.5
    key_rows = np.full(z, cap, np.int32)        # padding entries: cap
    n = z * 3 // 4
    if n:
        pool = np.concatenate([nrow, rng.integers(0, cap, 6)])
        key_rows[:n] = rng.choice(pool, n)      # some rows not in `rows`
        key_rows[: n // 5] -= cap               # negative rows
    key_mods = rng.integers(0, k, z).astype(np.int32)
    key_mods[1::7] -= k                         # negative keys
    key_mods[2::11] = -k - 1                    # past -K: dropped
    return dict(bits=bits, ts=ts, ex=ex, kinds=kinds, valid=valid,
                rows=rows, key_rows=key_rows, key_mods=key_mods,
                ts_rows=new_ts[nrow], ex_rows=new_ex[nrow],
                kind_rows=new_kd[nrow], valid_rows=new_vl[nrow])


# -- K6 range_finalize_csr (csrc/range_finalize.cu) -------------------------
# (B, NV, rcap, out_cap, seed, hazard): rcap 32 (one word a row set, so a
# compaction tile spans 1,024 entries), rcap 96 (three words: the tile's
# columns not a power of two), every row invalid, NV 0, iv_of below 0 and
# >= B, subject and row kinds below 0 and >= nk, witness entries other than
# 0 and 1, out_cap 0, an out_cap the hits overflow, and a call of 44
# compaction tiles.
RANGE_FIN_CASES = {
    "rcap32_one_word": (16, 1500, 32, 4096, 1, ""),
    "rcap96_three_words": (16, 300, 96, 4096, 2, ""),
    "all_rows_invalid": (8, 64, 64, 256, 3, "invalid"),
    "nv0": (8, 0, 64, 16, 4, ""),
    "iv_of_out_of_range": (8, 200, 64, 4096, 5, "iv_of"),
    "kinds_out_of_range": (8, 200, 64, 4096, 6, "kinds"),
    "witness_not_0_1": (8, 200, 64, 4096, 7, "witness"),
    "out_cap0": (8, 64, 64, 0, 8, ""),
    "out_cap_overflow": (8, 200, 128, 32, 9, ""),
    "many_tiles": (64, 700, 2048, 1 << 16, 10, ""),
}


def range_fin_case(name, nk=6):
    """range_finalize_csr's inputs of one RANGE_FIN_CASES case as numpy:
    dict(lanes=[iv_of, iv_s, iv_e, ent_ok, sb, sknd, r_start, r_end, r_ts,
    r_kinds, r_valid], witness (None: the encoding's WITNESS_TABLE, else
    an i32[nk, nk] table), out_cap)."""
    b, nv, rcap, out_cap, seed, hazard = RANGE_FIN_CASES[name]
    rng = np.random.default_rng(600 + seed)
    iv_of = np.sort(rng.integers(0, b, nv)).astype(np.int32)
    iv_of[nv - nv // 8:] = b                    # padding entries at the tail
    if hazard == "iv_of":
        iv_of = rng.integers(-2 * b, 2 * b, nv).astype(np.int32)
    iv_s = rng.integers(0, 4096, nv).astype(np.int32)
    width = np.where(rng.random(nv) < 0.5, 1, rng.integers(-3, 600, nv))
    iv_e = (iv_s + width).astype(np.int32)
    if nv > 12:
        iv_s[9], iv_e[9] = I32_MAX - 2, I32_MIN + 3     # wraps: width 6
        iv_s[11], iv_e[11] = I32_MIN + 1, I32_MAX       # wraps: width -2
    ent_ok = rng.random(nv) < 0.85
    sb = rng.integers(-40, 40, (b, 3)).astype(np.int32)
    sb[: b // 2] = (I32_MAX, 0, 0)              # half see every row
    sb[1::5, 0] = I32_MIN
    lo, hi = (-nk - 2, 2 * nk) if hazard == "kinds" else (0, nk)
    sknd = rng.integers(lo, hi, b).astype(np.int32)
    r_start = rng.integers(0, 4096, rcap).astype(np.int32)
    r_end = (r_start + rng.integers(1, 900, rcap)).astype(np.int32)
    r_ts = rng.integers(-40, 40, (rcap, 3)).astype(np.int32)
    r_ts[rng.random(rcap) < 0.1, 0] = I32_MIN
    r_kinds = rng.integers(lo, hi, rcap).astype(np.int32)
    r_valid = rng.random(rcap) < 0.8
    if hazard == "invalid":
        r_valid[:] = False
    witness = None
    if hazard == "witness":
        witness = rng.integers(-1, 3, (nk, nk)).astype(np.int32)
    return dict(lanes=[iv_of, iv_s, iv_e, ent_ok, sb, sknd, r_start, r_end,
                       r_ts, r_kinds, r_valid],
                witness=witness, out_cap=out_cap)


# -- K21 dag_wavefronts_packed (csrc/dense_dag.cu) ---------------------------
DAG_CASES = ("dag_with_cycle", "chain", "all_cycles", "no_edges", "dense",
             "wide_rows")
# rows of a case (256 where not named)
DAG_ROWS = {"wide_rows": 4096}
# blocking words the card's kernel keeps a row (csrc/dense_dag.cu DW_C)
DAG_KEPT_WORDS = 64


def dag_case(name):
    """bool[n, n] adjacency (row w depends on d where [w, d] is set) of the
    K21 fixture `name`: dag_with_cycle a random lower-triangular DAG with
    a 2-cycle and a row waiting on it (never settled); chain row i on
    i - 1 (depth n - 1); all_cycles a ring through every row plus random
    edges (nothing settles); no_edges (everything settles in round 0);
    dense a lower-triangular DAG of density 1/2; wide_rows 4,096 rows in
    8 layers, each row on a random share (5% to 50%) of the rows of lower
    layers, the rows shuffled: most rows have more nonzero words than the
    kernel keeps (so it reads such a row on in a later round), some cross
    that count inside one 32-word ballot, and a 2-cycle holds its rows
    and their waiters back."""
    n = DAG_ROWS.get(name, 256)
    rng = np.random.default_rng(700 + n + len(name))
    if name == "wide_rows":
        layer = rng.permutation(np.arange(n) * 8 // n)
        share = rng.uniform(0.05, 0.5, n)
        adj = (layer[None, :] < layer[:, None]) \
            & (rng.random((n, n)) < share[:, None])
        a, b = np.flatnonzero(layer == 5)[:2]
        adj[a, b] = adj[b, a] = True
    elif name == "dag_with_cycle":
        adj = np.tril(rng.random((n, n)) < 4.0 / n, -1)
        adj[10, 11] = adj[11, 10] = True
        adj[12, 10] = True
    elif name == "chain":
        adj = np.zeros((n, n), bool)
        adj[np.arange(1, n), np.arange(n - 1)] = True
    elif name == "all_cycles":
        adj = rng.random((n, n)) < 2.0 / n
        adj[np.arange(n), (np.arange(n) + 1) % n] = True
    elif name == "no_edges":
        adj = np.zeros((n, n), bool)
    else:
        adj = np.tril(rng.random((n, n)) < 0.5, -1)
    return adj


def dag_levels(depth):
    """The max_levels a K21 case runs at: 0, 1, the depth (the deepest
    row left unsettled), depth + 1 (just enough) and far past it."""
    return sorted({0, 1, max(depth, 0), depth + 1, depth + 41})


def dag_wide_row_hazards(words):
    """(rows with more nonzero words than the kernel keeps, rows whose
    kept-word count runs out inside a 32-word ballot: their last kept
    word and the next nonzero one share the ballot) of packed rows
    words[n, n/32]."""
    nz = words != 0
    wide = nz.sum(1) > DAG_KEPT_WORDS
    inside = np.zeros_like(wide)
    for r in np.flatnonzero(wide):
        at = np.flatnonzero(nz[r])
        inside[r] = at[DAG_KEPT_WORDS - 1] // 32 == at[DAG_KEPT_WORDS] // 32
    return wide, inside


# -- K16 quorum_count (csrc/quorum.cu) ----------------------------------------
# name -> (lanes t, quorum size, seed, kind); the card adds 4,096, 8,192
# and 16,384 lanes (QUORUM_CARD_TIERS: clusters of 8, a CTA looping over
# several chunks of its slice above the ladder)
QUORUM_CASES = {
    "t100": (100, 2, 1, "random"),         # one CTA, a cluster of 1
    "t1000": (1000, 2, 2, "random"),       # a cluster of 7, ragged slices
    "one_txn": (256, 2, 3, "one_txn"),     # every lane the same txn
    "no_fast": (256, 2, 4, "no_fast"),
    "qsize1": (256, 1, 5, "random"),
    "qsize_above_t": (256, 257, 6, "random"),
    "pad_meets_fast": (256, 2, 7, "pad_meets_fast"),
    "high_code_bits": (256, 2, 8, "high_code_bits"),
}
QUORUM_CARD_TIERS = (4096, 8192, 16384)


def quorum_lanes(t, seed, kind="random"):
    """(txn i32[t, 3], ts i32[t, 3], code i32[t], valid bool[t]): a tick's
    PreAccept transition lanes, the last fifth padding (txn 0, ts
    INT32_MIN, code 0, invalid). kind: "random" (txns from a small pool,
    70% echoed, codes 0 0 0 1 2 8 9 -1), "one_txn" (every lane one txn),
    "no_fast" (no lane echoes its txn), "pad_meets_fast" (real fast lanes
    with txn (0, 0, 0), which the padding's txn meets), "high_code_bits"
    (codes with bits above the low three: 8 and 16 pass, 9, -1 and 15 do
    not)."""
    rng = np.random.default_rng(seed)
    n = t - t // 5
    pool = rng.integers(-5, 5, (max(2, n // 3), 3)).astype(np.int32)
    txn = np.zeros((t, 3), np.int32)
    txn[:n] = pool[rng.integers(0, len(pool), n)]
    if kind == "one_txn":
        txn[:] = pool[0]
    echo = rng.random((n, 1)) < 0.7
    ts = np.full((t, 3), I32_MIN, np.int32)
    ts[:n] = np.where(echo, txn[:n], txn[:n] + 1)
    code = np.zeros(t, np.int32)
    code[:n] = rng.choice([0, 0, 0, 1, 2, 8, 9, -1], n)
    if kind == "no_fast":
        ts[:n] = txn[:n] + 1
    elif kind == "pad_meets_fast":
        zero = np.arange(0, n, 7)
        txn[zero] = ts[zero] = 0
        code[zero] = 0
    elif kind == "high_code_bits":
        code[:n] = rng.choice([8, 16, 9, -1, 15, -8], n)
    valid = np.zeros(t, bool)
    valid[:n] = True
    return txn, ts, code, valid


def quorum_case(name):
    """(lanes, qsize) of the QUORUM_CASES case `name`."""
    t, qsize, seed, kind = QUORUM_CASES[name]
    return quorum_lanes(t, seed, kind), qsize


# -- K7 max_conflict (csrc/max_conflict.cu) ---------------------------------
# name -> (subjects b, arena rows cap, buckets k, seed, kind); every case
# has all-zero subjects beside live ones (a bucketed batch's pads)
CONFLICT_CASES = {
    "zero_beside_live": (8, 512, 128, 1, "random"),
    "ties_in_last_batch": (8, 7000, 128, 2, "ties_late"),
    "single_min_row": (8, 512, 128, 3, "single_min"),
    "all_rows_invalid": (8, 512, 128, 4, "invalid"),
    "nw1": (8, 512, 32, 5, "random"),
    "nw32": (8, 512, 1024, 6, "random"),
    "meet_past_fourth_word": (8, 512, 1024, 7, "many_words"),
}
# the buckets of "meet_past_fourth_word"'s subject 1, in six words; its
# rows meet only the last one's
MANY_WORD_BUCKETS = (33, 97, 161, 300, 420, 900)
# the rows one batch of the card's kernel covers (1,024 threads x 4 rows)
CONFLICT_BATCH_ROWS = 4096


def conflict_case(name):
    """max_conflict's inputs of the CONFLICT_CASES case `name` as numpy:
    (subject bits bool[b, k], arena bits bool[cap, k], exec_ts i32[cap, 3],
    valid bool[cap]). Subjects 0, 2 and the last are all zero; live ones
    hold 1-3 buckets. exec_ts has exact ties, INT32_MIN lane 0s and
    all-INT32_MIN rows. kind "ties_late": subject 1's best triple is tied
    on rows 5,000, 5,001 and 6,999 only (its lowest winner past the first
    CONFLICT_BATCH_ROWS rows, the last batch ragged); "single_min":
    subject 1 meets one row, whose lanes are all INT32_MIN; "invalid":
    every row invalid; "many_words": subject 1 holds MANY_WORD_BUCKETS,
    six buckets in six words, and rows meet only the sixth."""
    b, cap, k, seed, kind = CONFLICT_CASES[name]
    rng = np.random.default_rng(seed)
    bits = rng.random((cap, k)) < 3.0 / k
    ex = rng.integers(-2, 2, (cap, 3)).astype(np.int32)
    ex[rng.random(cap) < 0.2, 0] = I32_MIN
    ex[rng.random(cap) < 0.1] = I32_MIN
    valid = rng.random(cap) < 0.9
    subj = np.zeros((b, k), bool)
    for i in range(b):
        if i not in (0, 2, b - 1):
            subj[i, rng.integers(0, k, 1 + i % 3)] = True
    if kind == "ties_late":
        subj[1] = False
        subj[1, 5] = True
        bits[:, 5] = rng.random(cap) < 0.3
        ex[bits[:, 5], 0] = np.minimum(ex[bits[:, 5], 0], 1)
        late = [5000, 5001, 6999]
        bits[late, 5] = True
        valid[late] = True
        ex[late] = (7, 7, 7)
    elif kind == "single_min":
        subj[1] = False
        subj[1, 0] = True
        bits[:, 0] = False
        bits[cap - 5, 0] = True
        valid[cap - 5] = True
        ex[cap - 5] = I32_MIN
    elif kind == "invalid":
        valid[:] = False
    elif kind == "many_words":
        subj[1] = False
        subj[1, list(MANY_WORD_BUCKETS)] = True
        bits[:, list(MANY_WORD_BUCKETS[:-1])] = False
        bits[:, MANY_WORD_BUCKETS[-1]] = rng.random(cap) < 0.05
    return subj, bits, ex, valid


# -- K9 execution_frontier / frontier_compact (csrc/exec_frontier.cu) -------
# name -> out_cap of the compacted call (the released count is data's)
FRONTIER_CASES = {
    "all_pending_awaits_all": 256,
    "none_pending": 32,
    "all_applied": 256,
    "self_edges": 256,
    "equal_and_undecided_ts": 256,
    "caps_32_96_2048": 2048,     # 68 words: the card's one-block-a-word path
    "out_cap_below_released": 8,
    "planes_32": 2048,           # 80 words in 32 planes of 1-4 words
}


def frontier_plane(rng, cap, density=0.03, pending=0.6, awaits=0.15,
                   applied=0.35):
    """One exec plane (bool adjacency [cap, cap], signed exec_ts [cap, 3],
    applied, pending, awaits_all) with the compare's hazards: INT32_MIN
    (undecided) and INT32_MAX rows, runs of equal triples, set diagonal
    bits."""
    adj = rng.random((cap, cap)) < density
    adj[np.arange(cap), np.arange(cap)] |= rng.random(cap) < 0.05
    ts = rng.integers(-4, 4, (cap, 3)).astype(np.int32)
    ts[rng.random(cap) < 0.1] = I32_MIN
    ts[rng.random(cap) < 0.05] = I32_MAX
    eq = rng.choice(cap, max(2, cap // 8), replace=False)
    ts[eq] = ts[eq[0]]
    return (adj, ts, rng.random(cap) < applied, rng.random(cap) < pending,
            rng.random(cap) < awaits)


def frontier_case(name):
    """(planes, out_cap) of the K9 fixture `name`, each plane (adj bool
    [cap, cap], exec_ts, applied, pending, awaits_all) in numpy:
    all_pending_awaits_all every row pending and awaiting all its deps;
    none_pending no row pending (nothing released, total 0); all_applied
    every dep applied (every pending row released); self_edges a set
    diagonal on half the rows, some of them applied (a row is gated by
    itself unless applied); equal_and_undecided_ts exec_ts drawn from
    three triples, one of them INT32_MIN in every lane, another INT32_MIN
    in its first lane only; caps_32_96_2048 planes of 32, 96 and 2,048
    rows in one call; out_cap_below_released an out_cap of 8 below ~100
    released rows (indptr exact, rows dropped); planes_32 the most planes
    a call takes, of 32-128 rows."""
    rng = np.random.default_rng(900 + len(name))
    out_cap = FRONTIER_CASES[name]
    if name == "all_pending_awaits_all":
        planes = [frontier_plane(rng, 256, pending=1.0, awaits=1.0,
                                 applied=0.8, density=0.01)]
    elif name == "none_pending":
        planes = [frontier_plane(rng, 128, pending=0.0)]
    elif name == "all_applied":
        planes = [frontier_plane(rng, 256, applied=1.0, density=0.1)]
    elif name == "self_edges":
        adj, ts, app, pend, aw = frontier_plane(rng, 256, density=0.004)
        half = rng.random(256) < 0.5
        adj[np.arange(256), np.arange(256)] = half
        app = half & (rng.random(256) < 0.3)
        planes = [(adj, ts, app, pend, aw)]
    elif name == "equal_and_undecided_ts":
        adj, _ts, app, pend, aw = frontier_plane(rng, 256, density=0.02)
        triples = np.array([[I32_MIN] * 3, [I32_MIN, 5, 5], [1, 2, 3]],
                           np.int32)
        ts = triples[rng.integers(0, 3, 256)]
        planes = [(adj, ts, app, pend, aw)]
    elif name == "caps_32_96_2048":
        planes = [frontier_plane(rng, 32, density=0.1),
                  frontier_plane(rng, 96, density=0.05),
                  frontier_plane(rng, 2048, density=0.002)]
    elif name == "out_cap_below_released":
        planes = [frontier_plane(rng, 256, density=0.003, applied=0.6)]
    else:
        planes = [frontier_plane(rng, 32 * (1 + k % 4), density=0.05)
                  for k in range(32)]
    return planes, out_cap


# -- K20 execution_wavefronts (csrc/dense_dag.cu) ----------------------------
# name -> max_levels
WAVEFRONT_CASES = {
    "depth_eq_levels": 9,
    "depth_levels_minus_1": 10,
    "cycle_levels_0": 0,
    "cycle_levels_1": 1,
    "cycle_levels_40": 40,
    "self_loop": 12,
    "n_77": 30,
}


def wavefront_case(name):
    """(adj bool [n, n], max_levels) of the K20 fixture `name`:
    depth_eq_levels a DAG of depth 9 (rows in 10 layers, each on random
    rows of lower layers, a path through every layer) at 9 levels, so the
    last round still raises a level; depth_levels_minus_1 the same DAG at 10 levels (the levels
    settle in the last round); cycle_levels_* a random DAG with a 3-cycle
    and rows waiting on it (their levels climb with the rounds) at 0, 1
    and 40 levels; self_loop a DAG whose rows 5 and 70 depend on
    themselves; n_77 a random DAG of 77 rows (not a multiple of 32), far
    fewer levels deep than 30."""
    levels = WAVEFRONT_CASES[name]
    rng = np.random.default_rng(500 + len(name))
    n = 77 if name == "n_77" else 96
    adj = np.tril(rng.random((n, n)) < 0.02, -1)
    if name.startswith("depth_"):
        layer = rng.permutation(np.arange(n) % 10)
        adj = (layer[None, :] < layer[:, None]) & (rng.random((n, n)) < 0.05)
        for lv in range(1, 10):     # a path through every layer
            adj[np.flatnonzero(layer == lv)[0],
                np.flatnonzero(layer == lv - 1)[0]] = True
    elif name.startswith("cycle_"):
        adj[20, 21] = adj[21, 22] = adj[22, 20] = True
        adj[40, 21] = adj[60, 40] = True
    elif name == "self_loop":
        adj[5, 5] = adj[70, 70] = True
        adj[80, 70] = True
    return adj, levels


# K17's clamped rows: a lane that does not read back its own ring row
# gathers row rows - 1 (a lane that does not land, or a landed flat past
# the arena: flat >= rows) or row 0 (flat < -rows), after the whole tick's
# scatter -- where another lane of the same tick may land; a flat in
# [-rows, 0) (a negative dst) wraps once and lands
ROUTE_HAZARDS = ("last_row", "wrap_once", "below_rows", "past_rows",
                 "all_cut")


def route_case(rng, n, depth, W, L, hazard):
    """Raw K17 inputs (arena, meta, the seven emit lanes, part) over n
    nodes' rings ((n + 1) * depth rows): random landed lanes on distinct
    rows, a kept lane on a cut link, keep=False pads, and at the end the
    hazard's lanes: `last_row` -- one lands on row rows - 1, which every
    pad gathers back; `wrap_once` -- a negative dst whose flat wraps once
    (it lands on node n's slot 1 and reads back its own row) beside one
    landing on row rows - 1; `below_rows` -- one with flat < -rows (it
    gathers back row 0) after one that lands on row 0; `past_rows` -- a
    landed flat >= rows (dropped: it gathers back row rows - 1) after one
    that lands on row rows - 1; `all_cut` -- every link cut, so no lane
    lands. -> (inputs, the lanes landing on a clamped row)."""
    assert n >= 3 and L >= 8 and hazard in ROUTE_HAZARDS
    n1, rows = n + 1, (n + 1) * depth
    arena = rng.integers(-9, 9, (rows, W)).astype(np.int32)
    meta = rng.integers(-9, 9, (rows, 3)).astype(np.int32)
    part = np.zeros((n1, n1), bool)
    part[1, 2] = part[2, 1] = True
    src, dst, slot, kind, seq = (np.zeros(L, np.int32) for _ in range(5))
    keep = np.zeros(L, bool)
    words = np.zeros((L, W), np.int32)

    def put(i, s, d, sl):
        src[i], dst[i], slot[i] = s, d, sl
        kind[i], seq[i] = int(rng.integers(1, 5)), int(rng.integers(0, 1 << 20))
        keep[i] = True
        words[i] = rng.integers(-1 << 30, 1 << 30, W)

    # the hazards' rows stay off the random lanes: rows - 1, row 0 and
    # node n's slot 1
    taken = {rows - 1, 0, rows - depth + 1}
    free = [r for r in range(depth, rows) if r not in taken]
    rng.shuffle(free)
    nland = min(int(rng.integers(L // 4, L // 2)), len(free))
    for i in range(nland):
        r = free.pop()
        put(i, int(rng.integers(1, n1)), r // depth, r % depth)
    put(nland, 1, 2, 0)                      # a cut link: does not land
    q = L - 1
    writers = []
    if hazard == "last_row":
        put(q, n, n, depth - 1)
        writers = [q]
    elif hazard == "wrap_once":
        put(q - 1, n, n, depth - 1)
        put(q, n, -1, 1)                     # flat 1 - depth: node n, slot 1
        writers = [q - 1]
    elif hazard == "below_rows":
        put(q - 1, n, 0, 0)                  # row 0
        put(q, n, -(n1 + 1), 0)              # flat < -rows: reads row 0
        writers = [q - 1]
    elif hazard == "past_rows":
        put(q - 1, n, n, depth - 1)
        put(q, n, n, depth + 2)              # flat rows + 2: dropped
        writers = [q - 1]
    else:
        part[:] = True
    return (arena, meta, src, dst, slot, keep, kind, seq, words,
            part), writers


# K23's clamped rows: a position that does not read back its own ring row
# gathers its destination shard's row rows_l - 1 (a lane that does not
# land, padding, or a landed flat past the ring) or row 0 (flat <
# -rows_l), after the whole tick's scatter -- where another lane of the
# same tick may land
SHARD_ROUTE_HAZARDS = ("last_row", "first_row")


def shard_route_case(rng, S, npsh, depth, W, bcap, hazard):
    """Raw sharded-route inputs (arena, meta, the seven emit lanes, part)
    with landed lanes on distinct (dst, slot) rings, pads in every segment
    and cut links, plus, for every destination shard t, lanes of segment
    (t + 1 mod S, t) on uncut links: `last_row` -- one lands on row
    rows_l - 1, which t's pads gather back; `first_row` -- one lands on
    row 0, one has flat < -rows_l (gathers back row 0), one a flat in
    [-rows_l, 0) (wraps once to row 1: its own row) and one a flat past
    the ring (dropped: gathers back row rows_l - 1). -> (inputs, the send
    positions of the lanes landing on the clamped row)."""
    assert bcap >= 4 and hazard in SHARD_ROUTE_HAZARDS
    rows_nodes, rows_l = npsh * S, npsh * depth
    L = S * S * bcap
    arena = rng.integers(-9, 9, (rows_nodes * depth, W)).astype(np.int32)
    meta = rng.integers(-9, 9, (rows_nodes * depth, 3)).astype(np.int32)
    part = np.zeros((rows_nodes, rows_nodes), bool)
    for a, b in ((1, npsh + 1), (2, 3 * npsh - 1), (npsh, npsh + 1)):
        a, b = a % rows_nodes, b % rows_nodes
        part[a, b] = part[b, a] = True
    src, dst, slot, kind, seq = (np.zeros(L, np.int32) for _ in range(5))
    keep = np.zeros(L, bool)
    words = np.zeros((L, W), np.int32)
    free = {v: list(rng.permutation(depth)) for v in range(rows_nodes)}
    for t in range(S):                      # the hazard lanes' rows
        if hazard == "last_row":
            free[t * npsh + npsh - 1].remove(depth - 1)
        else:
            free[t * npsh] = [sl for sl in free[t * npsh] if sl > 1]

    def put(q, s, d, sl):
        src[q], dst[q], slot[q] = s, d, sl
        kind[q], seq[q] = int(rng.integers(1, 5)), int(rng.integers(0, 1 << 20))
        keep[q] = True
        words[q] = rng.integers(-1 << 30, 1 << 30, W)

    for s in range(S):
        for t in range(S):
            for j in range(int(rng.integers(0, bcap - 3))):
                d = int(rng.integers(t * npsh, (t + 1) * npsh))
                if free[d]:
                    put((s * S + t) * bcap + j,
                        int(rng.integers(s * npsh, (s + 1) * npsh)), d,
                        free[d].pop())
    writers = []
    for t in range(S):
        s = (t + 1) % S
        q = (s * S + t) * bcap + bcap - 1
        sv, t0 = s * npsh + npsh - 1, t * npsh
        if hazard == "last_row":
            put(q, sv, t0 + npsh - 1, depth - 1)
        else:
            loc = npsh - 1
            put(q, sv, t0, 0)
            put(q - 1, sv, t0 + loc, -(rows_l + 1) - loc * depth)
            put(q - 2, sv, t0, 1 - rows_l)
            put(q - 3, sv, t0 + loc, rows_l + 3)
        for d in dst[q - 3:q + 1]:
            part[sv, d] = part[d, sv] = False
        writers.append(q)
    return (arena, meta, src, dst, slot, keep, kind, seq, words,
            part), writers


# -- the sharded finalize (csrc/finalize_csr.cu fin_shard_tab, K22's merge) --
# One finalize each, on a mesh with `data` shards (spans of 4 words a
# shard): the hazards of the one-launch table and of the reference's
# (data, model) split. Several of them make one tick's table.
SHARD_FIN_CASES = {
    # name: (slots, out_cap, spans, word_off, packed density)
    "fits": (32, 256, 1, 0, 0.02),
    "overflow": (64, 64, 1, 0, 0.5),          # indptr[S] > out_cap
    "slots_not_split": (33, 2048, 1, 0, 0.1),  # S % model != 0: bound unsplit
    "word_off": (32, 1024, 2, 4, 0.05),       # a fused span, word_off != 0
    "off_past_end": (32, 1024, 2, 40, 0.05),  # clamps to words - w
    "negative_subj_row": (48, 2048, 1, 0, 0.1),
    "out_of_range_slots": (40, 2048, 1, 0, 0.1),
    "no_slots": (0, 64, 1, 0, 0.1),           # S = 0
    "many_tiles": (256, 1 << 13, 1, 0, 0.003),  # 64 compaction tiles
}


def shard_fin_case(name, data, seed=0):
    """One finalize of SHARD_FIN_CASES as numpy: (packed u32[b, spans *
    w], word_off, kid_rows u32[kc, w], slot_subj, slot_kid, subj_row,
    act_ts, out_cap), w = 4 * data words (data * 4 of the 'many_tiles'
    case's 64 words a shard). `negative_subj_row`: every subject's row
    negative (no self bit); `out_of_range_slots`: a third of the slots
    name a subject or a kid out of range (either end)."""
    s, out_cap, spans, off, density = SHARD_FIN_CASES[name]
    rng = np.random.default_rng(seed * 100 + len(name))
    w = data * (64 if name == "many_tiles" else 4)
    b, kc = 24, 40
    packed = np.packbits(rng.random((b, spans * w, 32)) < density, axis=-1,
                         bitorder="little").view(np.uint32) \
        .reshape(b, spans * w)
    kid = np.packbits(rng.random((kc, w, 32)) < 0.4, axis=-1,
                      bitorder="little").view(np.uint32).reshape(kc, w)
    slot_subj = rng.integers(0, b, s).astype(np.int32)
    slot_kid = rng.integers(0, kc, s).astype(np.int32)
    subj_row = rng.integers(-1, 32 * w, b).astype(np.int32)
    if name == "negative_subj_row":
        subj_row = -rng.integers(1, 1 << 20, b).astype(np.int32)
    if name == "out_of_range_slots":
        bad = rng.permutation(s)[:s // 3]
        for i, j in enumerate(bad):
            if i % 2:
                slot_subj[j] = (-1, b, b + 7, -b)[i % 4]
            else:
                slot_kid[j] = (-1, kc, kc + 3, -kc)[i % 4]
    act_ts = rng.integers(-1 << 20, 1 << 20, (32 * w, 3)).astype(np.int32)
    return (packed, off, kid, slot_subj, slot_kid, subj_row, act_ts,
            out_cap)


def merge_fragments_case(rng, data, out_cap, total, ts_rows):
    """K22 merge inputs: `data` fragments i32[data, out_cap], each position
    below `total` set in exactly one of them (rows in [-ts_rows - 3,
    ts_rows + 3): the gather wraps a negative row once, then clamps),
    zeros elsewhere; indptr i32[9] ending at `total`; act_ts
    i32[ts_rows, 3]."""
    frags = np.zeros((data, out_cap), np.int32)
    n = min(total, out_cap)
    owner = rng.integers(0, data, n)
    frags[owner, np.arange(n)] = rng.integers(-ts_rows - 3, ts_rows + 3, n)
    indptr = np.sort(rng.integers(0, total + 1, 9)).astype(np.int32)
    indptr[0], indptr[-1] = 0, total
    act_ts = rng.integers(-1 << 30, 1 << 30, (ts_rows, 3)).astype(np.int32)
    return frags, indptr, act_ts
