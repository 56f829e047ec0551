"""The port's command-plane kernels, plain versions, against the JAX kernels.

Every input is made from a numpy seed and reaches both sides as numpy; the
JAX kernels run on the CPU as the JAX package's own tests run them. The
tolerance is zero: every output is an integer, the port's int32 checksum
compared as the reference's uint32 bit pattern.

cmd_tick's op batches are built as the plane builds them (rows and kid
slots chained through op_prev / op_kprev, last writers flagged, padding
slots of kind 0 on row 0 with kids -1 and no VALID flag), over columns
with every hazard of the port: terminal statuses, Ballot.ZERO's lane2 of
-2^31, undecided (INT32_MIN) executeAts, expired PreAccepts, ballot
contention, clocks and hlcs at INT32_MAX (the int32 wrap of unique_now).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accord_tpu.ops import kernels as jk
from accord_tpu_torch.ops import kernels as tk
from torch_kernel_cases import CMD_CASES, CMD_SCALARS, cmd_case

I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max
KPAD = 4
BAL0 = (0, 0, I32_MIN)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(ref, got)


def _lanes(rng, n, lo=-3, hi=4):
    """Timestamp-like lanes: small epochs/hlcs, lane2 around -2^31."""
    a = np.empty((n, 3), np.int32)
    a[:, 0] = rng.integers(0, 3, n)
    a[:, 1] = rng.integers(lo + 10, hi + 14, n)
    a[:, 2] = I32_MIN + rng.integers(0, 6, n)
    return a


def _columns(rng, cap, kcap):
    status = rng.choice([0, 1, 3, 5, 6, 7, 8, 9, 10, 11], cap).astype(
        np.int32)
    flags = rng.integers(0, 2, cap).astype(np.int32)
    promised = _lanes(rng, cap)
    promised[rng.random(cap) < 0.4] = BAL0
    accepted = _lanes(rng, cap)
    accepted[rng.random(cap) < 0.5] = BAL0
    ea = _lanes(rng, cap)
    ea[rng.random(cap) < 0.4] = I32_MIN
    dur = rng.integers(0, 5, cap).astype(np.int32)
    kmax = _lanes(rng, kcap)
    kmax[rng.random(kcap) < 0.2] = I32_MIN
    kvalid = rng.random(kcap) < 0.6
    return [status, flags, promised, accepted, ea, dur, kmax, kvalid]


def _ops(rng, n_real, tier, rows, kids, now, wrap=False):
    """An op batch as CmdPlane._run_device builds it."""
    kind = np.zeros(tier, np.int32)
    row = np.zeros(tier, np.int32)
    txn = np.zeros((tier, 3), np.int32)
    bal = np.zeros((tier, 3), np.int32)
    exe = np.full((tier, 3), I32_MIN, np.int32)
    keys = np.full((tier, KPAD), -1, np.int32)
    flags = np.zeros(tier, np.int32)
    op_now = np.full(tier, now, np.int32)
    prev = np.full(tier, -1, np.int32)
    rlast = np.zeros(tier, bool)
    kprev = np.full((tier, KPAD), -1, np.int32)
    klast = np.zeros((tier, KPAD), bool)
    last_row, last_kid = {}, {}
    for j in range(n_real):
        kind[j] = rng.integers(0, 4)
        r = int(rng.choice(rows))
        row[j] = r
        txn[j] = _lanes(rng, 1)[0]
        bal[j] = BAL0 if rng.random() < 0.6 else _lanes(rng, 1)[0]
        if rng.random() < 0.7:
            exe[j] = _lanes(rng, 1)[0]
        if wrap and rng.random() < 0.5:
            txn[j, 1] = I32_MAX
        ks = rng.choice(kids, rng.integers(0, min(KPAD, len(kids)) + 1),
                        replace=False)
        keys[j, :len(ks)] = ks
        f = tk.CMD_F_VALID
        for bit, p in ((tk.CMD_F_PERMIT_FAST, 0.6), (tk.CMD_F_EPOCH_OK, 0.8),
                       (tk.CMD_F_EXPIRED, 0.15), (tk.CMD_F_MSG_HAS_TXN, 0.6),
                       (tk.CMD_F_DEPS_EMPTY, 0.6)):
            if rng.random() < p:
                f |= bit
        flags[j] = f
        op_now[j] = min(now + int(rng.integers(-2, 3)), I32_MAX)
        prev[j] = last_row.get(r, -1)
        last_row[r] = j
        for s, kid in enumerate(ks):
            if kid in last_kid:
                p, ps = last_kid[kid]
                kprev[j, s] = p * KPAD + ps
            last_kid[kid] = (j, s)
    for j in last_row.values():
        rlast[j] = True
    for j, s in last_kid.values():
        klast[j, s] = True
    return [kind, row, txn, bal, exe, keys, flags, op_now, prev, rlast,
            kprev, klast]


def _tick_both(cols, clock, ops, scal, promote):
    ref = jk.cmd_tick(*(jnp.asarray(a) for a in cols), jnp.int32(clock),
                      *(jnp.asarray(a) for a in ops),
                      *(jnp.int32(s) for s in scal), promote=promote)
    got = tk.cmd_tick_plain(*(_t(a) for a in cols), clock,
                            *(_t(a) for a in ops), *scal, promote=promote)
    return ref, got


def _check_tick(ref, got, ops):
    assert len(got) == 14
    for r, g in zip(ref, got[:13]):
        _same(r, g)
    # the chains (port only): each last writer's chain IS its row's / kid's
    # new column values
    chains = got[13].numpy()
    row, rlast, keys, klast = ops[1], ops[9], ops[5], ops[11]
    cols = [np.asarray(c) for c in ref[:8]]
    for j in np.nonzero(rlast)[0]:
        r = row[j]
        want = [cols[0][r], cols[1][r], *cols[2][r], *cols[3][r],
                *cols[4][r], cols[5][r]]
        assert chains[j, :tk.CMD_ROW_LANES].tolist() == \
            [int(x) for x in want]
    for j, s in zip(*np.nonzero(klast)):
        k = keys[j, s]
        base = tk.CMD_ROW_LANES + 4 * s
        assert chains[j, base:base + 3].tolist() == cols[6][k].tolist()
        assert chains[j, base + 3] == int(cols[7][k])


@pytest.mark.parametrize("tier,n_real,promote,seed", [
    (8, 8, False, 1), (8, 5, True, 2), (8, 1, False, 3),
    (64, 64, True, 4), (64, 40, False, 5), (64, 17, True, 6)])
def test_cmd_tick_plain_matches_jax(tier, n_real, promote, seed):
    """Row chains and kid chains across several ops (few rows and kids),
    padding slots, every status, both promote modes."""
    rng = np.random.default_rng(seed)
    cap, kcap = 32, 16
    cols = _columns(rng, cap, kcap)
    ops = _ops(rng, n_real, tier, rows=rng.choice(cap, 6, replace=False),
               kids=np.arange(kcap)[:6], now=20)
    scal = (1, -(1 << 31) + 1, ((0x8000 << 16) | 1) - (1 << 31), 3)
    ref, got = _tick_both(cols, 15, ops, scal, promote)
    _check_tick(ref, got, ops)
    # the batch did real work: codes of every op kind, and rows changed
    assert (got[9][:n_real] >= 0).all() and (got[9][n_real:] == -1).all()


@pytest.mark.parametrize("promote", [False, True])
def test_cmd_tick_plain_wraps_int32(promote):
    """unique_now at the int32 edge: clock + 1 and al_hlc + 1 wrap."""
    rng = np.random.default_rng(7)
    cols = _columns(rng, 32, 16)
    cols[0][:] = 0                     # every row fresh: PreAccepts witness
    cols[4][:] = I32_MIN
    cols[6][:, 1] = I32_MAX            # max conflicts at the hlc edge
    ops = _ops(rng, 8, 8, rows=np.arange(8), kids=np.arange(8), now=I32_MAX,
               wrap=True)
    ops[0][:8] = tk.CMD_OP_PREACCEPT
    ref, got = _tick_both(cols, I32_MAX, ops, (0, I32_MIN + 2, 5, 1),
                          promote)
    _check_tick(ref, got, ops)


def test_cmd_tick_plain_padding_slots_are_computed():
    """A padding slot gathers row 0 and kid 0, reports status[0] and an
    out_ts from the witness arithmetic, code -1; the checksum folds it."""
    rng = np.random.default_rng(8)
    cols = _columns(rng, 32, 16)
    cols[0][0], cols[1][0], cols[2][0] = 6, 0, BAL0
    cols[4][0] = I32_MIN
    ops = _ops(rng, 2, 8, rows=[3, 4], kids=[1, 2], now=99)
    ref, got = _tick_both(cols, 40, ops, (1, I32_MIN + 1, 7, 2), False)
    _check_tick(ref, got, ops)
    assert got[9][2:].tolist() == [-1] * 6
    assert got[11][2:].tolist() == [6] * 6
    assert (got[10][2:, 1] != I32_MIN).all()


def test_cmd_tick_plain_chain_on_one_row_and_kid():
    """Every op on one row and one kid: PreAccept, re-PreAccept at a higher
    then a lower ballot, Accept, Commit, Apply, then redundant deliveries
    with executeAt drift -- each reads its predecessor's chain value."""
    rng = np.random.default_rng(9)
    cols = _columns(rng, 32, 16)
    cols[0][5], cols[1][5] = 0, 0
    cols[2][5], cols[3][5], cols[4][5] = BAL0, BAL0, (I32_MIN,) * 3
    ops = _ops(rng, 0, 8, rows=[5], kids=[2], now=50)
    kinds = [0, 0, 0, 1, 2, 3, 2, 3]
    bals = [BAL0, (0, 3, I32_MIN + 1), (0, 2, I32_MIN + 1),
            (0, 4, I32_MIN + 1), BAL0, BAL0, BAL0, BAL0]
    ea = (0, 30, I32_MIN + 1)
    drift = (0, 31, I32_MIN + 1)
    for j in range(8):
        ops[0][j] = kinds[j]
        ops[1][j] = 5
        ops[2][j] = (0, 12, I32_MIN + 1)
        ops[3][j] = bals[j]
        ops[4][j] = drift if j >= 6 else ea
        ops[5][j, 0] = 2
        ops[6][j] = (tk.CMD_F_VALID | tk.CMD_F_EPOCH_OK | tk.CMD_F_MSG_HAS_TXN
                     | tk.CMD_F_DEPS_EMPTY
                     | (tk.CMD_F_PERMIT_FAST if bals[j] == BAL0 else 0))
        ops[8][j] = j - 1
        ops[10][j, 0] = (j - 1) * KPAD if j else -1
    ops[9][:] = False
    ops[9][7] = True
    ops[11][:] = False
    ops[11][7, 0] = True
    for promote in (False, True):
        ref, got = _tick_both(cols, 20, ops, (0, I32_MIN + 1, 9, 1), promote)
        _check_tick(ref, got, ops)
        codes = got[9].tolist()
        assert codes[2] == tk.CMD_OUT_REJECTED_BALLOT
        assert codes[6] & tk.CMD_OUT_INCONSISTENT_BIT


def test_cmd_tick_plain_terminal_and_expired():
    """INVALIDATED / TRUNCATED rows answer every kind with their terminal
    code; expired PreAccepts witness at the REJECTED lane2."""
    rng = np.random.default_rng(10)
    cols = _columns(rng, 32, 16)
    cols[0][:4] = [10, 11, 10, 11]
    cols[0][4:8] = 0
    cols[4][4:8] = I32_MIN
    ops = _ops(rng, 8, 8, rows=np.arange(8), kids=np.arange(4), now=70)
    ops[6][4:8] |= tk.CMD_F_EXPIRED
    ops[0][4:8] = tk.CMD_OP_PREACCEPT
    for promote in (False, True):
        ref, got = _tick_both(cols, 60, ops, (1, I32_MIN + 1, 77, 1),
                              promote)
        _check_tick(ref, got, ops)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_cmd_tick_plain_random_columns_large_cap(seed):
    """Tier 64 over a 1024-row arena, chains on a 24-row working set."""
    rng = np.random.default_rng(seed)
    cols = _columns(rng, 1024, 256)
    ops = _ops(rng, 60, 64, rows=rng.choice(1024, 24, replace=False),
               kids=rng.choice(256, 12, replace=False), now=16)
    ref, got = _tick_both(cols, 14, ops, (2, I32_MIN + 3, 11, 1),
                          bool(seed % 2))
    _check_tick(ref, got, ops)


def test_cmd_checksum_host_matches_jax():
    rng = np.random.default_rng(14)
    code = rng.integers(-1, 30, 64).astype(np.int32)
    st = rng.integers(-1, 12, 64).astype(np.int32)
    ts = rng.integers(I32_MIN, I32_MAX, (64, 3), dtype=np.int64) \
        .astype(np.int32)
    for clock in (0, -5, I32_MAX, I32_MIN):
        want = int(np.asarray(jk.cmd_checksum(
            jnp.asarray(code), jnp.asarray(st), jnp.asarray(ts),
            jnp.int32(clock))))
        assert tk.cmd_checksum_host(code, st, ts, clock) == want
        assert jk.cmd_checksum_host(code, st, ts, clock) == want
        got = tk.cmd_checksum(_t(code), _t(st), _t(ts),
                              torch.tensor(clock, dtype=torch.int32))
        assert int(got) & 0xFFFFFFFF == want


def _recovery_inputs(rng, cap):
    status = rng.integers(0, 12, cap).astype(np.int32)
    touched = rng.integers(0, 2000, cap).astype(np.int32)
    # band edges and clocks past now
    status[:6] = [0, 1, 8, 9, 10, 11]
    touched[6:10] = [1000, 1001, 700, 701]
    touched[10:12] = [5000, I32_MAX]
    touched[12:14] = [I32_MIN, -7]
    return status, touched


@pytest.mark.parametrize("cap,out_cap,now,stall", [
    (64, 4, 1000, 300), (64, 256, 1000, 300), (1024, 32, 1000, 300),
    (1024, 2048, 1000, 0), (256, 64, I32_MAX, 1), (256, 64, I32_MIN, 1),
    (256, 64, 1000, -5)])
def test_recovery_scan_plain_matches_jax(cap, out_cap, now, stall):
    """Band edges, touched > now, wrapping ages, out_cap below and above
    the count with indptr exact."""
    rng = np.random.default_rng(cap + out_cap)
    status, touched = _recovery_inputs(rng, cap)
    ref = jk.recovery_scan(jnp.asarray(status), jnp.asarray(touched),
                           jnp.int32(now), jnp.int32(stall), out_cap=out_cap)
    got = tk.recovery_scan_plain(_t(status), _t(touched), now, stall,
                                 out_cap)
    for r, g in zip(ref, got):
        _same(r, g)
    assert tk.recovery_scan(_t(status), _t(touched), now, stall,
                            out_cap)[0].tolist() == got[0].tolist()
    indptr, rows, csum = (g.numpy() for g in got)
    assert jk.frontier_checksum_host(indptr, rows) == \
        int(csum) & 0xFFFFFFFF


def _repair_inputs(rng, cap, kcap, m, k):
    cols = _columns(rng, cap, kcap)
    nr = max(1, m - 3)
    rows_idx = np.full(m, cap, np.int32)
    rows_idx[:nr] = np.sort(rng.choice(cap, nr, replace=False))
    nk = max(1, k - 2)
    kid_idx = np.full(k, kcap, np.int32)
    kid_idx[:nk] = np.sort(rng.choice(kcap, nk, replace=False))
    vals = [rng.integers(0, 12, m).astype(np.int32),
            rng.integers(0, 2, m).astype(np.int32), _lanes(rng, m),
            _lanes(rng, m), _lanes(rng, m),
            rng.integers(0, 5, m).astype(np.int32)]
    return cols, [rows_idx, *vals, kid_idx, _lanes(rng, k),
                  rng.random(k) < 0.5]


@pytest.mark.parametrize("cap,kcap,m,k", [(32, 16, 8, 8), (1024, 256, 64, 8),
                                          (64, 1024, 8, 64)])
def test_cmd_repair_plain_matches_jax(cap, kcap, m, k):
    """Eight drop-mode scatters; the padding indices cap / kcap drop."""
    rng = np.random.default_rng(cap + m)
    cols, vals = _repair_inputs(rng, cap, kcap, m, k)
    ref = jk._cmd_repair_body(*(jnp.asarray(a) for a in cols),
                              *(jnp.asarray(a) for a in vals))
    got = tk.cmd_repair(*(_t(a) for a in cols), *(_t(a) for a in vals))
    assert len(got) == 8
    for r, g in zip(ref, got):
        _same(r, g)


# -- the K10 fixtures the card tests reuse (tests/torch_kernel_cases.py) -----
@pytest.mark.parametrize("name", CMD_CASES)
def test_cmd_tick_plain_matches_jax_on_shared_cases(name):
    """kpad 1 / 3 / 8 batches, a run of every kind on one row (op_prev =
    i - 1 throughout), kid links across slots, and an all-PreAccept batch
    whose every op takes the slow path."""
    cols, clock, ops, promote = cmd_case(name)
    ref, got = _tick_both(cols, clock, ops, CMD_SCALARS, promote)
    _check_tick(ref, got, ops)
    kprev, prev = ops[10], ops[8]
    if name == "one_row_run":
        assert prev[0] == -1 and (prev[1:] == np.arange(len(prev) - 1)).all()
    if name == "kid_links_across_slots":
        links = kprev[kprev >= 0]
        slots = np.nonzero(kprev >= 0)[1]
        assert (links % kprev.shape[1] != slots).sum() > len(links) // 2
    if name == "all_preaccept_slow":
        # every op witnessed a new hlc: the clock moved through all of them
        assert (got[9].numpy() == tk.CMD_OUT_SUCCESS).all()
        hlc = got[10][:, 1].numpy().astype(np.int64)
        assert (np.diff(hlc) > 0).all()
        assert int(got[8]) == int(hlc[-1])
