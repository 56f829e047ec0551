"""The port's sharded deps data plane in the suite: the port of
tests/test_mesh_resolver.py case by case, on the CPU mesh
`make_mesh(devices=["cpu"] * 8)` (data 4 x model 2, the conftest mesh's
shape), where every shard runs its kernels' plain versions.

The sharded resolver must be differentially identical to the single-device
resolver and the host scan, carry a full burn, commit the JAX package's
histories, and run the unsharded mesh burn's merged tick through
`sharded_node_tick`. "Zero recompiles" reads as no new CUDA graph
captured (`kernels.CAPTURES`): the port compiles nothing per shape.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from accord_tpu_torch.ops import carry
from accord_tpu_torch.ops import kernels as tk
from accord_tpu_torch.parallel.mesh import (example_resolve_batch, make_mesh,
                                            sharded_deps_resolve,
                                            sharded_finalize_csr)
from accord_tpu_torch.sim.burn import run_burn
from accord_tpu_torch.sim.cluster import Cluster, ClusterConfig


def _mesh():
    return make_mesh(devices=["cpu"] * 8)


def _sharded(**kw):
    from accord_tpu_torch.ops.resolver import ShardedBatchDepsResolver
    return ShardedBatchDepsResolver(mesh=_mesh(), num_buckets=256,
                                    initial_cap=512, **kw)


def test_sharded_kernel_matches_single_device():
    """Pure kernel differential: sharded == unsharded on random arenas."""
    mesh = _mesh()
    assert mesh.shape["data"] * mesh.shape["model"] == 8
    kern = sharded_deps_resolve(mesh)
    for trial in range(3):
        lanes = example_resolve_batch(cap=512, k=256, b=16, seed=trial)
        args = [torch.from_numpy(a) for a in lanes]
        args[4] = carry.packed(lanes[4])
        assert torch.equal(kern(*args), tk.deps_resolve(*args)), \
            f"trial {trial} diverged"


def _drive_writes(cluster, n):
    from accord_tpu_torch.primitives.keyspace import Keys
    from accord_tpu_torch.primitives.timestamp import TxnKind
    from accord_tpu_torch.primitives.txn import Txn
    from accord_tpu_torch.sim.list_store import (ListQuery, ListRead,
                                                 ListUpdate)
    for v in range(1, n + 1):
        ks = Keys(sorted({100 + v % 7, 9000 + v % 3}))
        r = cluster.nodes[1 + v % 3].coordinate(
            Txn(TxnKind.WRITE, ks, read=ListRead(ks),
                update=ListUpdate(ks, v), query=ListQuery()))
        cluster.drain()
        assert r.done and r.failure is None, r.failure


def _three_way(seed, sharded):
    """Same live store state, three resolvers, identical answers per key;
    -> the number of keys checked."""
    from accord_tpu_torch.ops.resolver import BatchDepsResolver
    from accord_tpu_torch.primitives.keyspace import Keys
    from accord_tpu_torch.primitives.timestamp import (Domain, Timestamp,
                                                       TxnKind)
    c = Cluster(seed, ClusterConfig())
    _drive_writes(c, 24)
    node = c.nodes[1]
    single = BatchDepsResolver(num_buckets=256, initial_cap=512,
                               device="cpu")
    before = Timestamp(node.epoch, node.time_service.now_micros() + 10_000,
                       0, node.id)
    checked = 0
    for store in node.command_stores.all():
        for key in store.cfks:
            subj = node.next_txn_id(TxnKind.WRITE, Domain.KEY)
            owned = store.owned(Keys([key]))
            host = store.host_calculate_deps(subj, owned, before)
            assert single.resolve_one(store, subj, owned, before) == host, \
                f"single-device != host at key {key}"
            assert sharded.resolve_one(store, subj, owned, before) == host, \
                f"sharded != host at key {key}"
            checked += 1
    return checked


def test_sharded_resolver_matches_host_and_single_device():
    """Same live store state, three resolvers, identical deps answers."""
    assert _three_way(31, _sharded()) >= 5


def test_burn_with_sharded_resolver():
    """A full burn (with durability) on the mesh-sharded data plane."""
    r = run_burn(5, ops=120, write_ratio=0.8, key_count=16,
                 config=ClusterConfig(deps_resolver_factory=_sharded,
                                      deps_batch_window_ms=1.0,
                                      durability=True,
                                      durability_interval_ms=500.0))
    assert r.acked == 120
    assert r.failed == 0


def test_burn_sharded_matches_jax_host_resolver_log():
    """Determinism ACROSS resolvers and packages: the port's sharded
    device path commits the exact event log of the JAX package's host
    scan path (deps supersets could reorder execution; the exact per-key
    decode means they must not)."""
    from accord_tpu.sim.burn import run_burn as jax_run_burn
    from accord_tpu.sim.cluster import ClusterConfig as JaxConfig
    kw = dict(ops=80, write_ratio=0.8, key_count=12, collect_log=True)
    host = jax_run_burn(9, config=JaxConfig(), **kw)
    dev = run_burn(9, config=ClusterConfig(deps_resolver_factory=_sharded,
                                           deps_batch_window_ms=None), **kw)
    assert host.acked == dev.acked == 80
    assert dev.log == host.log


def _packed_words(rng, rows, words, density):
    return np.packbits(rng.random((rows, words, 32)) < density, axis=-1,
                       bitorder="little").view(np.int32) \
        .reshape(rows, words)


def test_sharded_finalize_kernel_matches_single_device():
    """The sharded compaction: per-shard popcount/prefix fragments merged
    into the global CSR bit-identical to kernels.finalize_csr -- indptr,
    dep_rows, dep_ts, the bound and the checksum -- including a fused
    word span (word_off != 0) and overflow (the exact total)."""
    mesh = _mesh()
    data = mesh.shape["data"]
    cap = 32 * data * 4
    w = cap // 32
    kern = sharded_finalize_csr(mesh)
    rng = np.random.default_rng(23)
    overflowed = fit = 0
    for density, out_cap, spans, off in ((0.004, 256, 1, 0),
                                         (0.02, 256, 2, w), (0.5, 64, 1, 0)):
        b, s, kc = 8, 32, 64
        args = (torch.from_numpy(_packed_words(rng, b, spans * w, density)),
                off,
                torch.from_numpy(_packed_words(rng, kc, w, 0.1)),
                torch.from_numpy(rng.integers(-1, b + 2, s).astype(np.int32)),
                torch.from_numpy(rng.integers(0, kc + 1, s).astype(np.int32)),
                torch.from_numpy(rng.integers(-1, cap, b).astype(np.int32)),
                torch.from_numpy(rng.integers(0, 1 << 20, (cap, 3))
                                 .astype(np.int32)))
        single = tk.finalize_csr(*args, out_cap=out_cap)
        sharded = kern(*args, out_cap=out_cap)
        for name, a, c in zip(("indptr", "dep_rows", "dep_ts", "bound",
                               "csum"), single, sharded):
            assert torch.equal(a, c), f"sharded {name} != single-device"
        total = int(single[0][-1])
        overflowed += total > out_cap
        fit += 0 < total <= out_cap
    assert overflowed and fit, "differential vacuous"


def test_model_sharded_kid_bound_matches_single_device():
    """The kid-table out-cap bound is popcounted over 'model' slot blocks
    (each model shard bounds a contiguous slice): across nnz tiers the
    merged bound stays equal to the single-device full reduction."""
    mesh = _mesh()
    assert mesh.shape["model"] > 1, "the mesh must exercise a model axis"
    cap = 32 * mesh.shape["data"] * 4
    w = cap // 32
    kern = sharded_finalize_csr(mesh)
    rng = np.random.default_rng(31)
    for s in (32, 64, 256):
        b, kc = 16, 128
        args = (torch.from_numpy(_packed_words(rng, b, w, 0.05)), 0,
                torch.from_numpy(_packed_words(rng, kc, w, 0.2)),
                torch.from_numpy(rng.integers(-1, b + 2, s).astype(np.int32)),
                torch.from_numpy(rng.integers(0, kc + 1, s).astype(np.int32)),
                torch.from_numpy(rng.integers(-1, cap, b).astype(np.int32)),
                torch.from_numpy(rng.integers(0, 1 << 20, (cap, 3))
                                 .astype(np.int32)))
        single = tk.finalize_csr(*args, out_cap=2048)
        sharded = kern(*args, out_cap=2048)
        assert int(single[3]) == int(sharded[3]) > 0, f"nnz {s}: bound"
        for a, c in zip(single, sharded):
            assert torch.equal(a, c)


def test_sharded_finalize_e2e_and_zero_captures():
    """The sharded resolver rides the finalized-CSR harvest end to end
    (answers == single-device == host, zero legacy decodes, the merge
    timer running), and captures no CUDA graph: the port compiles nothing
    per shape, so the reference's zero-recompile gate holds trivially."""
    tk.reset_launches()
    sharded = _sharded()
    assert _three_way(37, sharded) >= 5
    assert sharded.finalized_decodes > 0, "sharded finalize never engaged"
    assert sharded.legacy_decodes == 0
    assert sharded.finalize_fallbacks == 0
    assert sharded.host_fallbacks == 0
    assert sharded.shard_merge_s > 0.0, "sharded merge timer never ran"
    assert tk.CAPTURES["protocol_tick"] == 0


def test_sharded_mesh_burn_matches_jax_and_unsharded():
    """run_mesh_burn(sharded=True, megakernel=False): the merged tick
    launches through sharded_node_tick, and the history equals the
    unsharded merged run's and the JAX package's sharded run's, with no
    mesh-tick fallback."""
    from accord_tpu.sim.mesh_burn import run_mesh_burn as jax_mesh_burn
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    kw = dict(nodes=4, collect_log=True, range_read_ratio=0.15,
              range_write_ratio=0.1)
    tk.reset_launches()
    rep, eng = run_mesh_burn(5, 40, sharded=True, mesh=_mesh(),
                             device="cpu", **kw)
    plain, _ = run_mesh_burn(5, 40, device="cpu", **kw)
    ref, _ = jax_mesh_burn(5, 40, sharded=True, **kw)
    assert rep.acked == 40 and rep.lost == 0
    assert rep.log == plain.log == ref.log
    snap = eng.snapshot()
    assert snap["node_lane_dispatches"] > 0
    assert snap["mesh_tick_fallbacks"] == 0
    assert tk.LAUNCHES["node_deps_resolve"] == 0   # a CPU mesh: no card


@pytest.mark.parametrize("flag", ["megakernel", "exec_in_megakernel",
                                  "device_messages"])
def test_sharded_mesh_burn_megakernel_paths_raise(flag):
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    with pytest.raises(NotImplementedError, match="rows 32 and 35b"):
        run_mesh_burn(1, 10, nodes=3, sharded=True, mesh=_mesh(),
                      device="cpu", **{flag: True})


def test_dryrun_multichip_on_a_cpu_mesh():
    from accord_tpu_torch.graft_entry import dryrun_multichip
    dryrun_multichip(8, device="cpu")
    dryrun_multichip(1, device="cpu")
