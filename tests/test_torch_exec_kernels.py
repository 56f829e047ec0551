"""The port's exec-plane kernels, plain versions, against the JAX kernels.

Every input is made from a numpy seed and reaches both sides as numpy; the
JAX kernels run on the CPU as the JAX package's own tests run them. The
tolerance is zero: every output is an integer or a bit word, the port's
int32 words compared as the reference's uint32 bit patterns. The
reference's adjacency is bool [cap, cap]; the port's is packed int32
[cap, cap/32], compared as `np.packbits(adj, axis=1, bitorder="little")
.view(np.int32)`. The cases cover the hazards of the port: signed
lexicographic compares with INT32_MIN (undecided), INT32_MAX and equal
triples, a set diagonal, awaits_all rows, duplicate and negative scatter
indices and padding out of range, fused planes of different caps, and an
out_cap too small for the released rows (indptr stays exact).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accord_tpu.ops import kernels as jk
from accord_tpu_torch.ops import kernels as tk

I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pack(adj_bool):
    """bool [n, cap] -> the port's packed int32 [n, cap/32]."""
    return np.ascontiguousarray(
        np.packbits(np.asarray(adj_bool), axis=1, bitorder="little")) \
        .view(np.int32)


def _same(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(ref, got)


def _plane(rng, cap, density=0.08):
    """One exec arena with every hazard: signed exec_ts with undecided
    (INT32_MIN), INT32_MAX and equal triples, set diagonal bits, awaits_all
    rows, applied deps."""
    adj = rng.random((cap, cap)) < density
    adj[np.arange(cap), np.arange(cap)] |= rng.random(cap) < 0.1
    ts = rng.integers(-4, 4, (cap, 3)).astype(np.int32)
    ts[rng.random(cap) < 0.1] = I32_MIN
    ts[rng.random(cap) < 0.05] = I32_MAX
    ts[rng.random(cap) < 0.05, 0] = I32_MIN
    ts[rng.random(cap) < 0.05, 2] = I32_MAX
    # a run of equal triples
    eq = rng.choice(cap, cap // 8, replace=False)
    ts[eq] = ts[eq[0]]
    applied = rng.random(cap) < 0.35
    pending = rng.random(cap) < 0.6
    awaits = rng.random(cap) < 0.15
    return adj, ts, applied, pending, awaits


def _port(plane):
    adj, ts, applied, pending, awaits = plane
    return (_t(_pack(adj)), _t(ts), _t(applied), _t(pending), _t(awaits))


def _jax(plane):
    return tuple(jnp.asarray(a) for a in plane)


@pytest.mark.parametrize("cap,seed", [(64, 0), (96, 1), (128, 2)])
def test_execution_frontier_matches_jax(cap, seed):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        plane = _plane(rng, cap)
        ref = jk.execution_frontier(*_jax(plane))
        got = tk.execution_frontier(*_port(plane))
        _same(ref, got)


def test_frontier_gates_undecided_equal_and_diagonal():
    """The compare's edges, one waiter (row 0) at a time: an undecided dep
    (INT32_MIN lanes) and an equal-exec_ts dep gate, a later dep does not,
    an INT32_MAX waiter is gated by every decided dep, a set diagonal gates
    its own row unless applied, and awaits_all gates on any unapplied
    dep."""
    cap = 64

    def run(w_ts, d_ts, diag=False, awaits=False, d_applied=False):
        adj = np.zeros((cap, cap), bool)
        adj[0, 1] = True
        adj[0, 0] = diag
        ts = np.full((cap, 3), 7, np.int32)
        ts[0], ts[1] = w_ts, d_ts
        applied = np.zeros(cap, bool)
        applied[1] = d_applied
        pending = np.zeros(cap, bool)
        pending[0] = True
        aw = np.zeros(cap, bool)
        aw[0] = awaits
        plane = (adj, ts, applied, pending, aw)
        ref = np.asarray(jk.execution_frontier(*_jax(plane)))
        got = tk.execution_frontier(*_port(plane))
        _same(ref, got)
        return bool(ref[0] & 1)

    neg, mx = [I32_MIN] * 3, [I32_MAX] * 3
    assert not run([1, 2, 3], neg)                 # undecided dep gates
    assert not run([1, 2, 3], [1, 2, 3])           # equal gates
    assert run([1, 2, 3], [1, 2, 4])               # later dep: released
    assert run([1, 2, 3], [1, 2, 4], d_applied=True)
    assert not run([1, 2, 3], [1, 2, 4], awaits=True)
    assert run([1, 2, 3], [1, 2, 4], awaits=True, d_applied=True)
    assert not run(mx, [I32_MAX, I32_MAX, I32_MAX - 1])
    assert run([I32_MIN, 0, 0], [I32_MIN, 0, 1])   # signed, not unsigned
    assert not run([-1, 0, 0], [I32_MIN, I32_MAX, I32_MAX])
    assert not run([1, 2, 3], [1, 2, 4], diag=True)
    assert run([1, 2, 3], [1, 2, 4], diag=False)


@pytest.mark.parametrize("caps", [(64,), (64, 128), (128, 64, 96)])
def test_fused_execution_frontier_matches_jax(caps):
    rng = np.random.default_rng(len(caps) + sum(caps))
    planes = [_plane(rng, c) for c in caps]
    ref = jk.fused_execution_frontier(tuple(_jax(p) for p in planes))
    got = tk.fused_execution_frontier(tuple(_port(p) for p in planes))
    _same(ref, got)


@pytest.mark.parametrize("caps", [(64,), (128, 64), (64, 96, 128)])
@pytest.mark.parametrize("out_cap", [4, 128])
def test_frontier_compact_matches_jax(caps, out_cap):
    rng = np.random.default_rng(7 * len(caps) + out_cap)
    planes = [_plane(rng, c, density=0.03) for c in caps]
    ref = jk.frontier_compact(tuple(_jax(p) for p in planes),
                              out_cap=out_cap)
    got = tk.frontier_compact(tuple(_port(p) for p in planes),
                              out_cap=out_cap)
    for r, g in zip(ref, got):
        _same(r, g)
    indptr, rows, csum, packed = (g.numpy() for g in got)
    total = int(indptr[-1])
    released = np.nonzero(np.unpackbits(packed.view(np.uint8),
                                        bitorder="little"))[0]
    assert total == released.size          # exact, overflow or not
    if out_cap == 4:
        assert total > out_cap, "fixture must overflow the small out_cap"
    assert tk.frontier_checksum_host(indptr, rows) \
        == int(csum) & 0xFFFFFFFF
    assert tk.frontier_checksum_host(indptr, rows) \
        == jk.frontier_checksum_host(np.asarray(ref[0]), np.asarray(ref[1]))


def test_frontier_checksum_matches_jax():
    rng = np.random.default_rng(5)
    indptr = np.sort(rng.integers(0, 1 << 20, 5)).astype(np.int32)
    rows = rng.integers(I32_MIN, I32_MAX, 37, dtype=np.int64) \
        .astype(np.int32)
    ref = np.asarray(jk.frontier_checksum(jnp.asarray(indptr),
                                          jnp.asarray(rows)))
    got = tk.frontier_checksum(_t(indptr), _t(rows))
    assert int(ref) == int(got) & 0xFFFFFFFF
    assert tk.frontier_checksum_host(indptr, rows) == int(ref)


def _scatter_inputs(rng, cap, m):
    """m dirty-row updates: distinct targets, then duplicates that repeat
    an earlier entry's data, a negative index (wraps once) and padding
    indices out of range (cap, -cap - 1: dropped)."""
    plane = _plane(rng, cap)
    n = m // 2
    targets = rng.choice(cap, n, replace=False).astype(np.int32)
    adj_rows = rng.random((n, cap)) < 0.1
    ts_rows = rng.integers(-3, 3, (n, 3)).astype(np.int32)
    ts_rows[0] = I32_MIN
    flags = [rng.random(n) < 0.5 for _ in range(3)]
    pick = rng.integers(0, n, m - n)
    rows = np.concatenate([targets, targets[pick]])
    rows[n] = targets[pick[0]] - cap            # same row, negative index
    rows[-1] = cap                              # dropped
    rows[-2] = -cap - 1                         # dropped
    full = np.concatenate([np.arange(n), pick])
    return plane, rows, adj_rows[full], ts_rows[full], \
        [f[full] for f in flags]


@pytest.mark.parametrize("cap,m", [(64, 8), (128, 64)])
def test_exec_scatter_matches_jax(cap, m):
    rng = np.random.default_rng(cap + m)
    plane, rows, adj_rows, ts_rows, flags = _scatter_inputs(rng, cap, m)
    ref = jk.exec_scatter(*_jax(plane), jnp.asarray(rows),
                          jnp.asarray(_pack(adj_rows).view(np.uint32)),
                          jnp.asarray(ts_rows),
                          *(jnp.asarray(f) for f in flags))
    got = tk.exec_scatter(*_port(plane), _t(rows), _t(_pack(adj_rows)),
                          _t(ts_rows), *(_t(f) for f in flags))
    _same(_pack(np.asarray(ref[0])), got[0])
    for r, g in zip(ref[1:], got[1:]):
        _same(r, g)
    # the scatter's result is the plane the frontier reads next
    _same(jk.execution_frontier(*ref), tk.execution_frontier(*got))
