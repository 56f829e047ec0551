"""The execute-DAG kernels' plain versions (K18 deps_matrix, K19
transitive_closure, K20 execution_wavefronts, K21 dag_wavefronts_packed)
against the JAX package's kernels on the CPU, and the port's graft entry
against `__graft_entry__.entry()`.

Inputs are made with numpy from a seed and fed to both; the JAX kernels
take f32 bitmaps and bool or u32 matrices, the port packed int32 words
(ops/carry.py). Tolerance: bit-equal everywhere (bool and int32 outputs).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import __graft_entry__
from accord_tpu.ops import kernels as jk
from accord_tpu.ops.encoding import WITNESS_TABLE
from accord_tpu_torch import graft_entry
from accord_tpu_torch.ops import carry
from accord_tpu_torch.ops import kernels as tk

I32_MIN = np.iinfo(np.int32).min


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _deps_inputs(seed, b, a, k):
    rng = np.random.default_rng(seed)
    p = max(0.06, 4 / k)
    sbm = (rng.random((b, k)) < p).astype(np.float32)
    abm = (rng.random((a, k)) < p).astype(np.float32)
    sb = rng.integers(-3, 3, (b, 3)).astype(np.int32)
    ts = rng.integers(-3, 3, (a, 3)).astype(np.int32)
    # sentinels and exact ties: INT32_MIN lanes, equal triples
    ts[::5, 0] = I32_MIN
    sb[::7, 0] = I32_MIN
    ts[1] = sb[0]
    sbm[0] = abm[1]
    sk = rng.integers(-2, 8, b).astype(np.int32)     # out-of-range kinds
    ak = rng.integers(-8, 8, a).astype(np.int32)
    valid = rng.random(a) < 0.8
    return sbm, sb, sk, abm, ts, ak, valid


@pytest.mark.parametrize("b,a,k,seed", [(8, 40, 32, 1), (37, 70, 96, 2),
                                        (64, 130, 256, 3)])
def test_deps_matrix_plain_matches_jax(b, a, k, seed):
    sbm, sb, sk, abm, ts, ak, valid = _deps_inputs(seed, b, a, k)
    ref = np.asarray(jk.deps_matrix(sbm, sb, sk, abm, ts, ak, valid,
                                    WITNESS_TABLE))
    got = tk.deps_matrix(carry.packed(sbm), _t(sb), _t(sk), carry.packed(abm),
                         _t(ts), _t(ak), _t(valid), _t(WITNESS_TABLE))
    assert got.dtype == torch.bool
    assert np.array_equal(ref, got.numpy())
    assert ref.any() and not ref.all()


def test_deps_matrix_ties_are_not_before():
    """Equal triples are not lex-before; an INT32_MIN lane is before any
    other; an invalid row never depends."""
    k = 32
    bm = np.ones((3, k), np.float32)
    sb = np.array([[0, 5, 5]] * 3, np.int32)
    ts = np.array([[0, 5, 5], [I32_MIN, 9, 9], [0, 5, 4]], np.int32)
    kinds = np.full(3, 1, np.int32)
    valid = np.array([True, True, False])
    ref = np.asarray(jk.deps_matrix(bm, sb, kinds, bm, ts, kinds, valid,
                                    WITNESS_TABLE))
    got = tk.deps_matrix(carry.packed(bm), _t(sb), _t(kinds),
                         carry.packed(bm), _t(ts), _t(kinds), _t(valid),
                         _t(WITNESS_TABLE)).numpy()
    assert np.array_equal(ref, got)
    assert not got[:, 0].any() and not got[:, 2].any()


def _random_adj(seed, n, p, dag):
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < p
    if dag:
        adj = np.tril(adj, -1)
    return adj


@pytest.mark.parametrize("n,p,dag,iters", [
    (40, 0.05, True, 0), (40, 0.05, True, 2), (50, 0.04, False, 3),
    (70, 0.03, True, 7)])
def test_transitive_closure_plain_matches_jax(n, p, dag, iters):
    """Iterations below the depth (a cut closure), cycles, N not a
    multiple of 32."""
    adj = _random_adj(n + iters, n, p, dag)
    ref = np.asarray(jk.transitive_closure(adj, iters))
    got = tk.transitive_closure(_t(adj), iters).numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("n,p,dag,levels", [
    (40, 0.05, True, 0), (40, 0.08, True, 2), (50, 0.04, False, 40),
    (70, 0.03, True, 70)])
def test_execution_wavefronts_plain_matches_jax(n, p, dag, levels):
    """max_levels below the DAG's depth, and a cycle, where the levels
    climb to the round count."""
    adj = _random_adj(n * 3 + levels, n, p, dag)
    ref = np.asarray(jk.execution_wavefronts(adj, levels))
    got = tk.execution_wavefronts(_t(adj), levels).numpy()
    assert np.array_equal(ref, got)
    if not dag and levels:
        assert ref.max() == levels


def _dag_packed(seed, n, p):
    adj = _random_adj(seed, n, p, True)
    adj[10, 11] = adj[11, 10] = True          # a cycle: never settles
    adj[12, 10] = True                        # waits on the cycle
    return adj, carry.pack_bitmaps(adj.astype(np.float32))


@pytest.mark.parametrize("n,p,levels", [(64, 0.05, 0), (256, 0.03, 3),
                                        (256, 0.03, 192)])
def test_dag_wavefronts_packed_plain_matches_jax(n, p, levels):
    """Rounds below the depth, rows never settled (-1), a cycle."""
    adj, words = _dag_packed(n + levels, n, p)
    ref = np.asarray(jk.dag_wavefronts_packed(words.view(np.uint32), levels))
    got = tk.dag_wavefronts_packed(_t(words), levels).numpy()
    assert np.array_equal(ref, got)
    if levels:
        assert ref[10] == ref[11] == ref[12] == -1
        assert (ref >= 0).any()


def test_dense_adjacency_carries_to_packed_words():
    adj, words = _dag_packed(5, 96, 0.05)
    assert np.array_equal(carry.packed_adjacency(adj).numpy(), words)


def test_graft_entry_matches_reference():
    step, args = __graft_entry__.entry()
    deps, levels = (np.asarray(x) for x in step(*args))
    pstep, pargs = graft_entry.entry("cpu")
    pdeps, plevels = pstep(*pargs)
    assert np.array_equal(deps, pdeps.numpy())
    assert np.array_equal(levels, plevels.numpy())
    assert deps.any() and levels.max() > 0


def test_graft_entry_default_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
