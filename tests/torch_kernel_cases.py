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
