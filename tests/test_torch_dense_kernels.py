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
from torch_kernel_cases import (CLOSURE_CASES, CLOSURE_ITERS, DAG_CASES,
                                DEPS_CASES, WAVEFRONT_CASES, closure_case,
                                dag_case, dag_levels, dag_wide_row_hazards,
                                deps_case, pack_words, wavefront_case)

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


@pytest.mark.parametrize("name", DEPS_CASES)
def test_deps_matrix_shared_cases_match_jax(name):
    """The fixtures the card tests hold K18 to (K 32, all-zero bitmaps,
    odd B and A over two chunks, bucket-sparse rows, a ragged chunk):
    the plain version = the JAX kernel, packed by the fixtures' own
    packer."""
    sbm, sb, sk, abm, ts, ak, valid = deps_case(name)
    ref = np.asarray(jk.deps_matrix(sbm, sb, sk, abm, ts, ak, valid,
                                    WITNESS_TABLE))
    assert np.array_equal(pack_words(sbm), carry.packed(sbm).numpy())
    got = tk.deps_matrix(_t(pack_words(sbm)), _t(sb), _t(sk),
                         _t(pack_words(abm)), _t(ts), _t(ak), _t(valid),
                         _t(WITNESS_TABLE))
    assert np.array_equal(ref, got.numpy())
    assert ref.any() == (name != "all_zero")


@pytest.mark.parametrize("iters", CLOSURE_ITERS)
@pytest.mark.parametrize("name", CLOSURE_CASES)
def test_transitive_closure_shared_cases_match_jax(name, iters):
    """K19's fixtures at an odd N: iterations 0, 1, below the depth and
    well past the fixpoint; a DAG, a graph with cycles, a chain."""
    adj = closure_case(name, 77)
    ref = np.asarray(jk.transitive_closure(adj, iters))
    got = tk.transitive_closure(_t(adj), iters).numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("iters,busy", [(0, 0), (3, 3), (7, 7), (8, 8),
                                        (20, 8)])
def test_transitive_closure_plain_counts_working_squarings(iters, busy):
    """`worked` counts the squarings up to and including the first that
    changes nothing: a 100-node chain closes in ceil(log2 99) = 7, the 8th
    confirms it."""
    adj = _t(closure_case("chain", 100))
    worked = torch.full((1,), -1, dtype=torch.int32)
    closed = tk.transitive_closure(adj, iters, worked=worked)
    assert int(worked) == busy
    assert torch.equal(closed, tk.transitive_closure_plain(adj, iters))
    if iters >= 7:
        assert torch.equal(closed, torch.tril(torch.ones(100, 100,
                                                         dtype=torch.bool),
                                              -1))


@pytest.mark.parametrize("case", [
    *(pytest.param(c, id="-".join(map(str, c)))
      for c in ((40, 0.05, True, 0), (40, 0.08, True, 2),
                (50, 0.04, False, 40), (70, 0.03, True, 70))),
    *WAVEFRONT_CASES])
def test_execution_wavefronts_plain_matches_jax(case):
    """max_levels below the DAG's depth, and a cycle, where the levels
    climb to the round count; the shared K20 cases (which the card tests
    run the kernel on): a DAG whose depth equals max_levels and one whose
    depth is max_levels - 1, a cycle at 0, 1 and 40 levels, self-loops, N
    not a multiple of 32."""
    if isinstance(case, str):
        adj, levels = wavefront_case(case)
    else:
        n, p, dag, levels = case
        adj = _random_adj(n * 3 + levels, n, p, dag)
    ref = np.asarray(jk.execution_wavefronts(adj, levels))
    got = tk.execution_wavefronts(_t(adj), levels).numpy()
    assert np.array_equal(ref, got)
    cyclic = isinstance(case, str) and case.startswith(("cycle", "self"))
    if (not isinstance(case, str) and not case[2] and levels) or cyclic:
        assert ref.max() == levels
    if isinstance(case, str) and case.startswith("depth_"):
        assert ref.max() == 9


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


@pytest.mark.parametrize("name", DAG_CASES)
def test_dag_wavefronts_packed_shared_cases_match_jax(name):
    """K21's plain version against the JAX kernel on the persistent
    kernel's edges (tests/torch_kernel_cases.py, which the card tests run
    the kernel on): max_levels 0, 1, exactly the depth and depth + 1, far
    past the fixpoint; a cycle and a row waiting on it, a chain, a graph of
    cycles only (nothing settles), no edges (everything settles in round
    0), a dense DAG, and rows wider than the kernel's kept words (some
    settled, some whose kept count runs out inside a ballot)."""
    adj = dag_case(name)
    words = carry.pack_bitmaps(adj.astype(np.float32))
    n = adj.shape[0]
    full = np.asarray(jk.dag_wavefronts_packed(words.view(np.uint32), n + 1))
    depth = int(full.max())
    for levels in dag_levels(depth):
        ref = np.asarray(jk.dag_wavefronts_packed(words.view(np.uint32),
                                                  levels))
        got = tk.dag_wavefronts_packed(_t(words), levels).numpy()
        assert np.array_equal(ref, got), levels
        if levels == depth + 1:
            assert np.array_equal(ref, full)
        if 0 < levels <= depth:
            assert (ref < 0).sum() > (full < 0).sum()
    expect = {"chain": n - 1, "all_cycles": -1, "no_edges": 0}
    if name in expect:
        assert depth == expect[name]
    if name == "wide_rows":
        wide, inside = dag_wide_row_hazards(words)
        assert (wide & (full >= 1)).any() and inside.any()
        assert (full < 0).any() and depth >= 5


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
