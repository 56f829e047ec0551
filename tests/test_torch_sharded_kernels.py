"""The port's sharded deps data plane (accord_tpu_torch/parallel/mesh.py)
against the JAX package's `parallel/mesh.py`, on the CPU.

The JAX side runs on the conftest mesh of 8 virtual CPU devices (data 4 x
model 2); the port's runs on `make_mesh(devices=["cpu"] * 8)`, the same
4 x 2 grid, where every shard's kernel and every combining step takes its
plain version. Inputs are made with numpy from a seed and fed to both (the
JAX kernels take f32 bitmaps, the port packed int32 words). Tolerance:
bit-equal everywhere -- packed words, indptr, dep_rows, dep_ts, bounds,
checksum words, the bool deps and the levels. Each JAX entry is built once
and reused across trials of one shape, so it compiles once.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from accord_tpu.ops import kernels as jk
from accord_tpu.parallel import mesh as jm
from accord_tpu_torch.ops import carry
from accord_tpu_torch.ops import kernels as tk
from accord_tpu_torch.parallel import mesh as pm
from torch_kernel_cases import (SHARD_FIN_CASES, merge_fragments_case,
                                shard_fin_case)

I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max
DATA, MODEL = 4, 2


@functools.lru_cache(maxsize=1)
def _jmesh():
    mesh = jm.make_mesh()
    assert (mesh.shape["data"], mesh.shape["model"]) == (DATA, MODEL)
    return mesh


@functools.lru_cache(maxsize=1)
def _pmesh():
    return pm.make_mesh(devices=["cpu"] * 8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _words(a) -> np.ndarray:
    """A JAX u32 result as the port's int32 bit patterns."""
    return np.array(a).view(np.int32)


# -- the mesh ----------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_shapes_match_reference(n):
    import jax
    ref = jm.make_mesh(devices=jax.devices()[:n])
    got = pm.make_mesh(devices=["cpu"] * n)
    assert (got.shape["data"], got.shape["model"]) == ref.devices.shape
    assert len(got.devices) * len(got.devices[0]) == n
    assert hash(got) == hash(pm.make_mesh(devices=["cpu"] * n))
    assert got == pm.make_mesh(devices=["cpu"] * n)


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh()
    with pytest.raises(ValueError):
        pm.make_mesh(devices=[])


def test_contract_violations_raise():
    mesh = _pmesh()
    args = [_t(a) for a in jm.example_resolve_batch(cap=96, k=256, b=4)]
    args[4] = carry.packed(jm.example_resolve_batch(cap=96, k=256, b=4)[4])
    with pytest.raises(ValueError, match="32 \\* data"):
        pm.sharded_deps_resolve(mesh)(*args)       # cap 96 % 128 != 0
    narrow = list(args)
    narrow[4] = torch.zeros(128, 1, dtype=torch.int32)   # 32 buckets
    for i in (5, 6, 7):
        narrow[i] = torch.cat([args[i], args[i][:32]])
    with pytest.raises(ValueError, match="'model' slices"):
        pm.sharded_deps_resolve(mesh)(*narrow)
    from accord_tpu_torch.ops.resolver import ShardedBatchDepsResolver
    with pytest.raises(Exception, match="32\\*data"):
        ShardedBatchDepsResolver(mesh=mesh, num_buckets=256,
                                 initial_cap=96)
    with pytest.raises(Exception, match="32\\*model"):
        ShardedBatchDepsResolver(mesh=mesh, num_buckets=32,
                                 initial_cap=128)
    with pytest.raises(ValueError, match="first device"):
        ShardedBatchDepsResolver(mesh=pm.make_mesh(devices=["meta"] * 8),
                                 device="cpu")


def test_entry_counts_only_its_kernels_launches(monkeypatch):
    """A sharded entry's count is the launches its shards and combining
    steps made: none for the plain versions or a call that raises, one a
    shard for a wrapper that counts a launch."""
    mesh = _pmesh()
    host = jm.example_resolve_batch(cap=512, k=256, b=16, seed=0)
    args = [_t(a) for a in host]
    args[4] = carry.packed(host[4])
    tk.reset_launches()
    pm.sharded_deps_resolve(mesh)(*args)
    bad = list(args)
    bad[4] = args[4][:96]
    with pytest.raises(ValueError):
        pm.sharded_deps_resolve(mesh)(*bad)
    assert not any(tk.ENTRY_LAUNCHES.values())
    shard = tk.deps_resolve_shard

    def counted(*a, **kw):
        tk.LAUNCHES["deps_resolve_shard"] += 1
        return shard(*a, **kw)
    monkeypatch.setattr(tk, "deps_resolve_shard", counted)
    want = pm.sharded_deps_resolve(mesh)(*args)
    assert tk.ENTRY_LAUNCHES["sharded_deps_resolve"] == DATA * MODEL
    assert np.array_equal(want.numpy(), tk.deps_resolve(*args).numpy())
    tk.reset_launches()
    assert not any(tk.ENTRY_LAUNCHES.values())


# -- row 34: the sharded resolves --------------------------------------------
@functools.lru_cache(maxsize=1)
def _jax_resolve():
    return jm.sharded_deps_resolve(_jmesh())


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_sharded_deps_resolve_matches_jax(trial):
    host = jm.example_resolve_batch(cap=512, k=256, b=16, seed=trial)
    ref = _words(_jax_resolve()(*host))
    args = [_t(a) for a in host]
    args[4] = carry.packed(host[4])
    got = pm.sharded_deps_resolve(_pmesh())(*args)
    assert np.array_equal(ref, got.numpy())
    assert np.array_equal(got.numpy(), tk.deps_resolve(*args).numpy())
    assert ref.any()


def test_sharded_deps_resolve_wraps_negative_keys_like_one_device():
    """A negative key is normalised over K before a shard tests its bucket
    slice, so the sharded answer is the single-device kernel's (key -1 is
    bucket K-1, as jnp's `.at[]` wraps it on one device)."""
    host = list(jm.example_resolve_batch(cap=512, k=256, b=16, seed=5))
    host[1] = host[1].copy()
    host[1][::3] -= 256                      # the same buckets, negative
    args = [_t(a) for a in host]
    args[4] = carry.packed(host[4])
    got = pm.sharded_deps_resolve(_pmesh())(*args)
    assert np.array_equal(got.numpy(), tk.deps_resolve(*args).numpy())
    ref = _words(jk.deps_resolve(*host))
    assert np.array_equal(got.numpy(), ref) and ref.any()


def _range_inputs(seed, b=16, nv=48, rcap=128, cap=256, k=256):
    rng = np.random.default_rng(seed)
    iv_of = rng.integers(0, b, nv).astype(np.int32)
    iv_of[::11] = b                          # CSR padding, dropped
    iv_of[5] = -1                            # counts from the end
    s = rng.integers(0, 1 << 11, nv).astype(np.int32)
    e = (s + rng.integers(1, 40, nv)).astype(np.int32)
    e[7] = s[7] + 3 * k                      # wider than the buckets
    e[9] = s[9] - 4                          # a negative width
    s[13], e[13] = I32_MIN + 5, I32_MAX - 5  # a width past int32
    sb = np.stack([np.zeros(b, np.int32),
                   rng.integers(1000, 100_000, b).astype(np.int32),
                   rng.integers(0, 100, b).astype(np.int32)], 1)
    sknd = rng.integers(0, 5, b).astype(np.int32)
    srng = rng.random(b) < 0.5
    r_start = rng.integers(0, 1 << 11, rcap).astype(np.int32)
    r_end = (r_start + rng.integers(1, 300, rcap)).astype(np.int32)
    r_ts = np.stack([np.zeros(rcap, np.int32),
                     rng.integers(0, 90_000, rcap).astype(np.int32),
                     rng.integers(0, 100, rcap).astype(np.int32)], 1)
    r_kinds = rng.integers(0, 5, rcap).astype(np.int32)
    r_valid = rng.random(rcap) < 0.9
    k_bm = (rng.random((cap, k)) < 0.03).astype(np.float32)
    k_ts = np.stack([np.zeros(cap, np.int32),
                     rng.integers(0, 90_000, cap).astype(np.int32),
                     rng.integers(0, 100, cap).astype(np.int32)], 1)
    k_kinds = rng.integers(0, 5, cap).astype(np.int32)
    k_valid = rng.random(cap) < 0.9
    return (iv_of, s, e, sb, sknd, srng), \
        (r_start, r_end, r_ts, r_kinds, r_valid), \
        (k_bm, k_ts, k_kinds, k_valid)


def _port_key(arena):
    bm, *rest = arena
    return (carry.packed(bm), *(_t(a) for a in rest))


@functools.lru_cache(maxsize=1)
def _jax_range():
    return jm.sharded_range_deps_resolve(_jmesh())


@pytest.mark.parametrize("trial", [0, 1])
def test_sharded_range_deps_resolve_matches_jax(trial):
    from accord_tpu.ops.encoding import WITNESS_TABLE
    subj, rar, kar = _range_inputs(trial)
    ref = _jax_range()(*subj, *rar, *kar, WITNESS_TABLE)
    got = pm.sharded_range_deps_resolve(_pmesh())(
        *(_t(a) for a in subj), *(_t(a) for a in rar), *_port_key(kar),
        _t(WITNESS_TABLE))
    for r, g in zip(ref, got):
        assert np.array_equal(_words(r), g.numpy())
        assert _words(r).any()
    single = tk.range_deps_resolve(
        *(_t(a) for a in subj), *(_t(a) for a in rar), *_port_key(kar),
        _t(WITNESS_TABLE))
    for s, g in zip(single, got):
        assert torch.equal(s, g)


@functools.lru_cache(maxsize=2)
def _jax_fused(n):
    return jm.sharded_fused_deps_resolve(_jmesh(), n)


@pytest.mark.parametrize("trial", [0, 1])
def test_sharded_fused_deps_resolve_matches_jax(trial):
    from accord_tpu.ops.encoding import WITNESS_TABLE
    rng = np.random.default_rng(50 + trial)
    b, k = 16, 256
    arenas, parenas = [], []
    for s, cap in enumerate((256, 128)):
        a = jm.example_resolve_batch(cap=cap, k=k, b=b, seed=10 * trial + s)
        arenas.append(tuple(a[4:8]))
        parenas.append(_port_key(a[4:8]))
    subj = jm.example_resolve_batch(cap=128, k=k, b=b, nnz=96, seed=trial)
    store = rng.integers(0, 3, b).astype(np.int32)   # slot 2: no block
    slots = np.array([0, 1], np.int32)
    ref = _words(_jax_fused(2)(subj[0], subj[1], store, subj[2], subj[3],
                               slots, tuple(arenas), WITNESS_TABLE))
    got = pm.sharded_fused_deps_resolve(_pmesh(), 2)(
        _t(subj[0]), _t(subj[1]), _t(store), _t(subj[2]), _t(subj[3]),
        _t(slots), tuple(parenas), _t(WITNESS_TABLE))
    assert np.array_equal(ref, got.numpy()) and ref.any()
    assert ref.shape == (b, (256 + 128) // 32)


@functools.lru_cache(maxsize=4)
def _jax_fused_range(nr, nk):
    return jm.sharded_fused_range_deps_resolve(_jmesh(), nr, nk)


@pytest.mark.parametrize("nr,nk", [(2, 2), (1, 0)])
def test_sharded_fused_range_deps_resolve_matches_jax(nr, nk):
    from accord_tpu.ops.encoding import WITNESS_TABLE
    rng = np.random.default_rng(60 + nr)
    subj, _, _ = _range_inputs(70)
    b = subj[3].shape[0]
    rars = [_range_inputs(71 + s, rcap=128 * (s + 1))[1] for s in range(nr)]
    kars = [_range_inputs(81 + s, cap=128 * (2 - s))[2] for s in range(nk)]
    store = rng.integers(0, 3, b).astype(np.int32)
    r_slots = np.arange(nr, dtype=np.int32)
    k_slots = np.arange(nk, dtype=np.int32)[::-1].copy()
    iv, rest = subj[:3], subj[3:]
    ref = _jax_fused_range(nr, nk)(
        *iv, store, *rest, r_slots, tuple(rars), k_slots, tuple(kars),
        WITNESS_TABLE)
    got = pm.sharded_fused_range_deps_resolve(_pmesh(), nr, nk)(
        *(_t(a) for a in iv), _t(store), *(_t(a) for a in rest),
        _t(r_slots), tuple(tuple(_t(a) for a in r) for r in rars),
        _t(k_slots), tuple(_port_key(k) for k in kars), _t(WITNESS_TABLE))
    for r, g in zip(ref, got):
        assert np.array_equal(_words(r), g.numpy())
    assert _words(ref[0]).any()
    assert got[1].shape == (b, sum(128 * (2 - s) for s in range(nk)) // 32)


def test_sharded_fused_two_store_differential():
    """tests/test_fused_dispatch.py:233's two-store case on the port: the
    sharded resolver's fused cross-store dispatch decodes bit-identically
    to the host scans on a mixed key/range workload over two stores."""
    from accord_tpu_torch.local.cfk import CfkStatus
    from accord_tpu_torch.ops.resolver import ShardedBatchDepsResolver
    from accord_tpu_torch.primitives.keyspace import Keys, Range, Ranges
    from accord_tpu_torch.primitives.timestamp import (Domain, Timestamp,
                                                       TxnId, TxnKind)
    from accord_tpu_torch.sim.cluster import Cluster, ClusterConfig

    cluster = Cluster(1, ClusterConfig(num_nodes=1, rf=1, num_shards=1,
                                       stores_per_node=2, progress=False))
    node = cluster.nodes[1]
    stores = node.command_stores.stores
    res = ShardedBatchDepsResolver(mesh=_pmesh(), num_buckets=128,
                                   initial_cap=128)
    for s in stores:
        s.deps_resolver = res
        s.batch_window_ms = 0.5
    node.device_latency_ms = 5.0
    span = 4096
    rng = np.random.default_rng(41)
    for store in stores:
        lo = min(int(r.start) for r in store.ranges)
        for i in range(25):
            ts = node.unique_now()
            kind = TxnKind.WRITE if i % 3 else TxnKind.READ
            tid = TxnId.create(ts.epoch, ts.hlc, ts.node, kind, Domain.KEY)
            width = 20 if i % 9 == 0 else 1 + int(rng.integers(0, 4))
            store.register(tid, Keys(sorted(
                {lo + int(k) for k in rng.integers(0, span, width)})),
                CfkStatus.WITNESSED, ts)
        for i in range(15):
            ts = node.unique_now()
            kind = TxnKind.WRITE if i % 2 else TxnKind.READ
            tid = TxnId.create(ts.epoch, ts.hlc, ts.node, kind, Domain.RANGE)
            s = lo + int(rng.integers(0, span))
            store.register(tid, Ranges([Range(s, s + 1 + int(
                rng.integers(0, 1024)))]), CfkStatus.WITNESSED, ts)
    far = Timestamp(node.epoch, node.time_service.now_micros() + 50_000, 0,
                    node.id)
    subs = []
    wave_rng = np.random.default_rng(9)
    for store in stores:
        lo = min(int(r.start) for r in store.ranges)
        for i in range(9):
            kind = TxnKind.WRITE if i % 2 else TxnKind.READ
            if i % 3 == 0:
                s = lo + int(wave_rng.integers(0, span))
                owned = store.owned(Ranges([Range(s, s + 1 + int(
                    wave_rng.integers(0, 2048)))]))
                tid = node.next_txn_id(kind, Domain.RANGE)
            else:
                width = 1 + int(wave_rng.integers(0, 4))
                owned = store.owned(Keys(sorted(
                    {lo + int(k)
                     for k in wave_rng.integers(0, span, width)})))
                tid = node.next_txn_id(kind, Domain.KEY)
            subs.append((store, tid, owned, far))
    outs = [res.enqueue_deps(store, tid, owned, before)
            for store, tid, owned, before in subs]
    cluster.queue.drain(max_events=100_000)
    assert all(o.done for o in outs)
    assert res.dispatches < 2 * res.ticks, "fused path disengaged"
    assert res.host_fallbacks == 0 and res.range_fallbacks == 0
    key_seen = range_seen = 0
    for (store, tid, owned, before), out in zip(subs, outs):
        host = store.host_calculate_deps(tid, owned, before)
        assert out.value() == host, f"sharded fused diverges on {tid}"
        key_seen += bool(host.key_deps.all_txn_ids())
        range_seen += bool(host.range_deps.all_txn_ids())
    assert key_seen > 0 and range_seen > 0, "differential vacuous"


# -- row 35a: the sharded finalize -------------------------------------------
@functools.lru_cache(maxsize=1)
def _jax_finalize():
    return jm.sharded_finalize_csr(_jmesh())


def _fin_inputs(rng, b, s, kc, cap, spans, density, kid_density):
    w = cap // 32
    packed = np.packbits(rng.random((b, spans * w, 32)) < density, axis=-1,
                         bitorder="little").view(np.uint32) \
        .reshape(b, spans * w)
    kid = np.packbits(rng.random((kc, w, 32)) < kid_density, axis=-1,
                      bitorder="little").view(np.uint32).reshape(kc, w)
    return (packed, kid, rng.integers(-1, b + 2, s).astype(np.int32),
            rng.integers(0, kc + 1, s).astype(np.int32),
            rng.integers(-1, cap, b).astype(np.int32),
            rng.integers(0, 1 << 20, (cap, 3)).astype(np.int32))


def _fin_both(args, off, out_cap, ref_kernel=None):
    import jax.numpy as jnp
    packed, kid, ssub, skid, srow, ts = args
    ref = (ref_kernel or _jax_finalize())(
        jnp.asarray(packed), jnp.asarray(off, jnp.int32), jnp.asarray(kid),
        ssub, skid, srow, ts, out_cap=out_cap)
    port_args = (_t(packed.view(np.int32)), off, _t(kid.view(np.int32)),
                 _t(ssub), _t(skid), _t(srow), _t(ts))
    got = pm.sharded_finalize_csr(_pmesh())(*port_args, out_cap=out_cap)
    single = tk.finalize_csr(*port_args, out_cap=out_cap)
    for name, r, g, s1 in zip(("indptr", "dep_rows", "dep_ts", "bound",
                               "csum"), ref, got, single):
        assert np.array_equal(_words(r), g.numpy()), name
        assert torch.equal(g, s1), name
    return int(got[0][-1])


@pytest.mark.parametrize("density,out_cap,spans,off", [
    (0.004, 256, 1, 0),        # fits
    (0.02, 256, 2, 16),        # a fused span at word_off != 0
    (0.5, 64, 1, 0),           # overflows: the exact total, zero tail
    (0.02, 256, 2, 40)])       # an offset past the end clamps
def test_sharded_finalize_csr_matches_jax(density, out_cap, spans, off):
    """Against the JAX package's sharded finalize; an offset past the end
    (which no resolver span produces) against its single-device kernel,
    whose clamp (jax.lax.dynamic_slice's) the port keeps: the reference's
    sharded lowering reads another window there."""
    rng = np.random.default_rng(int(density * 1000) + off)
    cap = 32 * DATA * 4
    args = _fin_inputs(rng, b=8, s=32, kc=64, cap=cap, spans=spans,
                       density=density, kid_density=0.1)
    w = cap // 32
    clamped = off + w > spans * w
    total = _fin_both(args, off, out_cap,
                      jk.finalize_csr if clamped else None)
    if density == 0.5:
        assert total > out_cap
    else:
        assert 0 < total <= out_cap


@pytest.mark.parametrize("s", [32, 64, 33])
def test_sharded_finalize_bound_model_split_matches_jax(s):
    """The out-cap bound splits over 'model' slot blocks when S % model
    == 0 and stays whole otherwise (33 slots): integer sums, so equal."""
    rng = np.random.default_rng(31 + s)
    args = _fin_inputs(rng, b=16, s=s, kc=128, cap=32 * DATA * 4, spans=1,
                       density=0.05, kid_density=0.2)
    assert _fin_both(args, 0, 2048) > 0


def _jax_fin(name, case):
    """The JAX package's answer for one SHARD_FIN_CASES finalize: its
    sharded finalize on the conftest mesh, or (`off_past_end`) its
    single-device finalize_csr, whose clamp the port keeps; None for
    S = 0, which neither JAX finalize traces (a gather from an empty
    operand)."""
    import jax.numpy as jnp
    packed, off, kid, ssub, skid, srow, ts, out_cap = case
    if ssub.shape[0] == 0:
        return None
    fn = jk.finalize_csr if name == "off_past_end" else _jax_finalize()
    return fn(jnp.asarray(packed), jnp.asarray(off, jnp.int32),
              jnp.asarray(kid), ssub, skid, srow, ts, out_cap=out_cap)


def _port_spec(case):
    packed, off, kid, ssub, skid, srow, ts, out_cap = case
    return (_t(packed.view(np.int32)), off, _t(kid.view(np.int32)),
            _t(ssub), _t(skid), _t(srow), _t(ts), out_cap)


def _check_tab(names, seed):
    """The sharded finalize table's plain version over one tick of
    finalizes (`names` of SHARD_FIN_CASES) against the JAX package's
    sharded finalize, each output bit-equal, and against the port's
    sharded_finalize_csr and single-device finalize_csr."""
    cases = [shard_fin_case(n, DATA, seed) for n in names]
    specs = [_port_spec(c) for c in cases]
    got = pm.sharded_finalize_tab(_pmesh(), specs)
    assert len(got) == len(specs)
    for name, case, sp, g in zip(names, cases, specs, got):
        ref = _jax_fin(name, case)
        eager = pm.sharded_finalize_csr(_pmesh())(*sp[:7], out_cap=sp[7])
        single = tk.finalize_csr(*sp)
        for i, out in enumerate(("indptr", "dep_rows", "dep_ts", "bound",
                                 "csum")):
            if ref is not None:
                assert np.array_equal(_words(ref[i]), g[i].numpy()), \
                    (name, out)
            assert torch.equal(g[i], eager[i]), (name, out)
            assert torch.equal(g[i], single[i]), (name, out)
        total, out_cap = int(g[0][-1]), sp[7]
        if name == "overflow":
            assert total > out_cap
        elif name == "no_slots":
            assert g[0].tolist() == [0] and int(g[3]) == 0
            assert not g[1].any()
            assert torch.equal(g[2], sp[6][:1].expand(out_cap, 3))
        else:
            assert 0 < total <= out_cap, name


@pytest.mark.parametrize("name", sorted(SHARD_FIN_CASES))
def test_sharded_finalize_tab_case_matches_jax(name):
    """Each hazard of the sharded finalize table alone: overflow, S %
    model != 0, word_off past words - w, negative subject rows, slots with
    an out-of-range subject or kid, S = 0, many compaction tiles."""
    _check_tab((name,), seed=1)


def test_sharded_finalize_tab_one_tick_matches_jax():
    """Every case as the finalizes of ONE tick's table (several with the
    same shape, as a tick's stores give), each bit-equal to the JAX
    package's."""
    names = sorted(SHARD_FIN_CASES) + ["fits", "overflow"]
    _check_tab(names, seed=2)


@pytest.mark.parametrize("out_cap,total", [(64, 40), (64, 64), (48, 90),
                                           (2048, 1500), (16, 0)])
def test_fragment_merge_plain_matches_jax(out_cap, total):
    """K22's merge (its plain version, the card kernel's oracle) against
    the JAX package's lines: the fragments summed, dep_ts gathered (a
    negative row wraps once, then clamps), the checksum over the merged
    triple; fitting, full, overflowing and empty."""
    import jax.numpy as jnp
    rng = np.random.default_rng(out_cap + total)
    frags, indptr, ts = merge_fragments_case(rng, DATA, out_cap, total, 50)
    rows = jnp.sum(jnp.asarray(frags), axis=0)
    dep_ts = jnp.asarray(ts)[rows]
    ref = (rows, dep_ts, jk.csr_checksum(jnp.asarray(indptr), rows, dep_ts))
    got = pm._sum_merge_fragments(_t(frags), _t(indptr), _t(ts))
    for r, g in zip(ref, got):
        assert np.array_equal(_words(r), g.numpy())


# -- row 33: the graft dry-run step ------------------------------------------
def test_sharded_deps_step_matches_jax():
    import jax.numpy as jnp
    n, k = max(32, 8 * DATA), 128 * MODEL
    bitmaps, ts, kinds, table = jm.example_batch(n=n, k=k, seed=3)
    deps, levels = jm.sharded_deps_step(_jmesh(), closure_iters=4)(
        jnp.asarray(bitmaps), jnp.asarray(ts), jnp.asarray(kinds),
        jnp.asarray(table))
    step = pm.sharded_deps_step(_pmesh(), closure_iters=4)
    pdeps, plevels = step(carry.packed(bitmaps), _t(ts), _t(kinds),
                          _t(table))
    assert pdeps.dtype == torch.bool and plevels.dtype == torch.int32
    assert np.array_equal(np.asarray(deps), pdeps.numpy())
    assert np.array_equal(np.asarray(levels), plevels.numpy())
    assert pdeps.any() and int(plevels.max()) > 0
    # and the single-device chain K18 -> K19 -> K20 with the same rounds
    valid = torch.ones(n, dtype=torch.bool)
    words = carry.packed(bitmaps)
    one = tk.deps_matrix(words, _t(ts), _t(kinds), words, _t(ts), _t(kinds),
                         valid, _t(table))
    lv = tk.execution_wavefronts(tk.transitive_closure(one, 4), 4)
    assert torch.equal(one, pdeps) and torch.equal(lv, plevels)


# -- the K22 combining steps' contracts ---------------------------------------
def test_or_fold_is_an_or_not_a_sum():
    """Two 'model' partials with the same bit set fold to that bit: a sum
    would carry it into the next bit (the doubled packed word)."""
    parts = torch.tensor([[[[1, -1]], [[1, 3]]]], dtype=torch.int32)
    out = torch.zeros(1, 2, dtype=torch.int32)
    pm._or_fold_model(parts, out)
    assert out.tolist() == [[1, -1]]


def test_gather_counts_and_fragment_merge():
    counts = torch.tensor([[2, 0, 1], [1, 3, 0]], dtype=torch.int32)
    indptr, seg_base, bound = pm._gather_counts(
        counts, torch.tensor([4, 5, 6], dtype=torch.int32))
    assert indptr.tolist() == [0, 3, 6, 7]
    assert seg_base.tolist() == [[0, 3, 6], [2, 3, 7]]
    assert int(bound) == 15
    frags = torch.tensor([[5, 6, 0, 0], [0, 0, 7, 0]], dtype=torch.int32)
    ts = torch.arange(30, dtype=torch.int32).reshape(10, 3)
    rows, dep_ts, csum = pm._sum_merge_fragments(frags, indptr, ts)
    assert rows.tolist() == [5, 6, 7, 0]
    assert torch.equal(dep_ts, ts[[5, 6, 7, 0]])
    assert int(csum) == int(tk.csr_checksum(indptr, rows, dep_ts))
    blocks = [torch.full((2, 1), 3, dtype=torch.int32),
              torch.full((2, 2), 4, dtype=torch.int32)]
    assert pm._concat_lane_blocks(blocks).tolist() == [[3, 4, 4]] * 2


# -- the one-card forms (rows 34 and 35a) --------------------------------------
# Each entry's one-card form (the single-device twin, the form every card
# run on a one-card mesh takes) called on CPU tensors, where it reaches its
# twin's plain version: bit-equal to the per-shard plain chain on the same
# mesh and to the JAX package's sharded entry (on the conftest mesh, at the
# shapes above, so its programs are the ones already compiled). The meshes:
# the virtual 4 x 2 and 1 x 1.
ONE_CARD_MESHES = {"4x2": lambda: _pmesh(),
                   "1x1": lambda: pm.make_mesh(devices=["cpu"])}


def _both_forms(name, mesh, *args):
    """The one-card form's and the per-shard form's answers, bit-equal."""
    one = getattr(pm, f"one_card_{name}")(mesh, *args)
    per = getattr(pm, f"per_shard_{name}")(mesh, *args)
    one_t = one if isinstance(one, tuple) else (one,)
    per_t = per if isinstance(per, tuple) else (per,)
    assert len(one_t) == len(per_t)
    for o, p in zip(one_t, per_t):
        assert o.dtype == p.dtype and torch.equal(o, p)
    return one_t


def _resolve_args(host):
    args = [_t(a) for a in host]
    args[4] = carry.packed(host[4])
    return args


@pytest.mark.parametrize("mesh", sorted(ONE_CARD_MESHES))
@pytest.mark.parametrize("trial", [0, 1])
def test_one_card_deps_resolve_matches_jax(mesh, trial):
    host = jm.example_resolve_batch(cap=512, k=256, b=16, seed=trial)
    ref = _words(_jax_resolve()(*host))
    (got,) = _both_forms("deps_resolve", ONE_CARD_MESHES[mesh](),
                         *_resolve_args(host))
    assert np.array_equal(ref, got.numpy()) and ref.any()


@pytest.mark.parametrize("mesh", sorted(ONE_CARD_MESHES))
def test_one_card_deps_resolve_wraps_negative_keys(mesh):
    """The negative-key wrap the port keeps on every mesh: key -1 is bucket
    K-1, the JAX package's single-device answer."""
    host = list(jm.example_resolve_batch(cap=512, k=256, b=16, seed=5))
    host[1] = host[1].copy()
    host[1][::3] -= 256
    (got,) = _both_forms("deps_resolve", ONE_CARD_MESHES[mesh](),
                         *_resolve_args(host))
    ref = _words(jk.deps_resolve(*host))
    assert np.array_equal(got.numpy(), ref) and ref.any()


@pytest.mark.parametrize("mesh", sorted(ONE_CARD_MESHES))
@pytest.mark.parametrize("trial", [0, 1])
def test_one_card_range_deps_resolve_matches_jax(mesh, trial):
    from accord_tpu.ops.encoding import WITNESS_TABLE
    subj, rar, kar = _range_inputs(trial)
    ref = _jax_range()(*subj, *rar, *kar, WITNESS_TABLE)
    got = _both_forms("range_deps_resolve", ONE_CARD_MESHES[mesh](),
                      *(_t(a) for a in subj), *(_t(a) for a in rar),
                      *_port_key(kar), _t(WITNESS_TABLE))
    for r, g in zip(ref, got):
        assert np.array_equal(_words(r), g.numpy()) and _words(r).any()


@pytest.mark.parametrize("mesh", sorted(ONE_CARD_MESHES))
@pytest.mark.parametrize("slots", ["two_stores", "pad_block"])
def test_one_card_fused_deps_resolve_matches_jax(mesh, slots):
    """Two stores of different caps, and the second block a pad block under
    slot -1 (it answers no subject)."""
    from accord_tpu.ops.encoding import WITNESS_TABLE
    rng = np.random.default_rng(53)
    b, k = 16, 256
    arenas, parenas = [], []
    for s, cap in enumerate((256, 128)):
        a = jm.example_resolve_batch(cap=cap, k=k, b=b, seed=20 + s)
        arenas.append(tuple(a[4:8]))
        parenas.append(_port_key(a[4:8]))
    subj = jm.example_resolve_batch(cap=128, k=k, b=b, nnz=96, seed=3)
    store = rng.integers(0, 3, b).astype(np.int32)
    sl = np.array([0, 1] if slots == "two_stores" else [0, -1], np.int32)
    ref = _words(_jax_fused(2)(subj[0], subj[1], store, subj[2], subj[3],
                               sl, tuple(arenas), WITNESS_TABLE))
    (got,) = _both_forms("fused_deps_resolve", ONE_CARD_MESHES[mesh](),
                         _t(subj[0]), _t(subj[1]), _t(store), _t(subj[2]),
                         _t(subj[3]), _t(sl), tuple(parenas),
                         _t(WITNESS_TABLE))
    assert np.array_equal(ref, got.numpy()) and ref.any()
    if slots == "pad_block":
        assert not ref[:, 256 // 32:].any()


def _fused_range_args(nr, nk):
    rng = np.random.default_rng(60 + nr)
    subj, _, _ = _range_inputs(70)
    b = subj[3].shape[0]
    rars = [_range_inputs(71 + s, rcap=128 * (s + 1))[1] for s in range(nr)]
    kars = [_range_inputs(81 + s, cap=128 * (2 - s))[2] for s in range(nk)]
    store = rng.integers(0, 3, b).astype(np.int32)
    r_slots = np.arange(nr, dtype=np.int32)
    k_slots = np.arange(nk, dtype=np.int32)[::-1].copy()
    iv, rest = subj[:3], subj[3:]
    host = (*iv, store, *rest, r_slots, tuple(rars), k_slots, tuple(kars))
    port = (*(_t(a) for a in iv), _t(store), *(_t(a) for a in rest),
            _t(r_slots), tuple(tuple(_t(a) for a in r) for r in rars),
            _t(k_slots), tuple(_port_key(k) for k in kars))
    return host, port


@pytest.mark.parametrize("mesh", sorted(ONE_CARD_MESHES))
@pytest.mark.parametrize("nr,nk", [(2, 2), (1, 0)])
def test_one_card_fused_range_deps_resolve_matches_jax(mesh, nr, nk):
    from accord_tpu.ops.encoding import WITNESS_TABLE
    host, port = _fused_range_args(nr, nk)
    ref = _jax_fused_range(nr, nk)(*host, WITNESS_TABLE)
    got = _both_forms("fused_range_deps_resolve", ONE_CARD_MESHES[mesh](),
                      *port, _t(WITNESS_TABLE))
    for r, g in zip(ref, got):
        assert np.array_equal(_words(r), g.numpy())
    assert _words(ref[0]).any()


@pytest.mark.parametrize("mesh", sorted(ONE_CARD_MESHES))
@pytest.mark.parametrize("nr,nk", [(0, 2), (0, 0)])
def test_one_card_fused_range_empty_sides(mesh, nr, nk):
    """An empty range side, and both sides empty: (B, 0) buffers, the
    other side the per-shard chain's and the single-device plain
    version's."""
    from accord_tpu.ops.encoding import WITNESS_TABLE
    _host, port = _fused_range_args(nr, nk)
    got = _both_forms("fused_range_deps_resolve", ONE_CARD_MESHES[mesh](),
                      *port, _t(WITNESS_TABLE))
    want = tk.fused_range_deps_resolve_plain(*port, _t(WITNESS_TABLE))
    b = port[4].shape[0]
    assert got[0].shape == (b, 0)
    assert got[1].shape == (b, sum(128 * (2 - s) for s in range(nk)) // 32)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("mesh", sorted(ONE_CARD_MESHES))
@pytest.mark.parametrize("name", sorted(SHARD_FIN_CASES))
def test_one_card_finalize_matches_jax(mesh, name):
    """Each finalize hazard (overflow past out_cap, word_off past words -
    w, S % model != 0, out-of-range slots, S = 0, many tiles): the one-card
    form (K2's plain version) = the per-shard chain = the JAX package's
    sharded finalize (its single-device one for word_off past the end,
    whose clamp the port keeps)."""
    case = shard_fin_case(name, DATA, seed=1)
    sp = _port_spec(case)
    got = _both_forms("finalize_csr", ONE_CARD_MESHES[mesh](), *sp)
    ref = _jax_fin(name, case)
    if ref is not None:
        for r, g in zip(ref, got):
            assert np.array_equal(_words(r), g.numpy())
    if name == "overflow":
        assert int(got[0][-1]) > sp[7]


def _bad_key_cap():
    args = _resolve_args(jm.example_resolve_batch(cap=96, k=256, b=4))
    return "deps_resolve", args, "32 \\* data"


def _bad_bucket_words():
    args = _resolve_args(jm.example_resolve_batch(cap=128, k=256, b=4))
    args[4] = torch.zeros(128, 1, dtype=torch.int32)      # 32 buckets
    return "deps_resolve", args, "'model' slices"


def _bad_second_store():
    args = _resolve_args(jm.example_resolve_batch(cap=128, k=256, b=4))
    arena = tuple(args[4:8])
    short = tuple(t[:96] for t in arena)
    store = torch.zeros(4, dtype=torch.int32)
    return "fused_deps_resolve", (args[0], args[1], store, args[2], args[3],
                                  torch.tensor([0, 1], dtype=torch.int32),
                                  (arena, short), args[8]), "32 \\* data"


def _bad_range_cap():
    from accord_tpu.ops.encoding import WITNESS_TABLE
    subj, rar, kar = _range_inputs(0, rcap=96)
    return "range_deps_resolve", (*(_t(a) for a in subj),
                                  *(_t(a) for a in rar), *_port_key(kar),
                                  _t(WITNESS_TABLE)), "range arena"


def _bad_fused_range_key():
    _host, port = _fused_range_args(1, 1)
    port = list(port)
    port[10] = tuple(tuple(t[:96] for t in k) for k in port[10])
    from accord_tpu.ops.encoding import WITNESS_TABLE
    return "fused_range_deps_resolve", (*port, _t(WITNESS_TABLE)), \
        "key arena"


def _bad_span():
    sp = list(_port_spec(shard_fin_case("fits", DATA, seed=1)))
    sp[2] = sp[2][:, :-1]                        # 15 words over data 4
    return "finalize_csr", sp, "does not split"


@pytest.mark.parametrize("case", [_bad_key_cap, _bad_bucket_words,
                                  _bad_second_store, _bad_range_cap,
                                  _bad_fused_range_key, _bad_span])
def test_one_card_forms_refuse_what_per_shard_refuses(case):
    """An input the per-shard form refuses, the one-card form refuses with
    the same ValueError (before any launch)."""
    name, args, match = case()
    errs = []
    for form in ("one_card", "per_shard"):
        with pytest.raises(ValueError, match=match) as e:
            getattr(pm, f"{form}_{name}")(_pmesh(), *args)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_entries_take_the_one_card_form_only_on_card_inputs(monkeypatch):
    """Each entry runs its one-card form exactly when the inputs are card
    tensors on a one-card mesh (here claimed, to reach the forms' plain
    versions on the CPU), and its per-shard form otherwise; its fused
    arity check comes first either way."""
    from accord_tpu.ops.encoding import WITNESS_TABLE
    mesh = _pmesh()
    wt = _t(WITNESS_TABLE)
    res = _resolve_args(jm.example_resolve_batch(cap=512, k=256, b=16))
    subj, rar, kar = _range_inputs(0)
    rng_args = (*(_t(a) for a in subj), *(_t(a) for a in rar),
                *_port_key(kar), wt)
    _host, frng = _fused_range_args(2, 2)
    store = torch.zeros(16, dtype=torch.int32)
    fused = (res[0], res[1], store, res[2], res[3],
             torch.tensor([0], dtype=torch.int32), (tuple(res[4:8]),), wt)
    fin = _port_spec(shard_fin_case("fits", DATA, seed=1))
    calls = [("deps_resolve", pm.sharded_deps_resolve(mesh), res, {}),
             ("range_deps_resolve", pm.sharded_range_deps_resolve(mesh),
              rng_args, {}),
             ("fused_deps_resolve", pm.sharded_fused_deps_resolve(mesh, 1),
              fused, {}),
             ("fused_range_deps_resolve",
              pm.sharded_fused_range_deps_resolve(mesh, 2, 2),
              (*frng, wt), {}),
             ("finalize_csr", pm.sharded_finalize_csr(mesh), fin[:7],
              {"out_cap": fin[7]})]
    for claim in (False, True):
        taken = []
        for form in ("one_card", "per_shard"):
            for name, *_ in calls:
                fn = getattr(pm, f"{form}_{name}")
                monkeypatch.setattr(
                    pm, f"{form}_{name}",
                    lambda *a, _f=fn, _n=f"{form}_{name}", **k:
                    taken.append(_n) or _f(*a, **k))
        monkeypatch.setattr(pm, "_runs_one_card", lambda m, p, c=claim: c)
        for name, entry, args, kw in calls:
            entry(*args, **kw)
        want = "one_card" if claim else "per_shard"
        assert taken == [f"{want}_{n}" for n, *_ in calls]
        monkeypatch.undo()
    with pytest.raises(ValueError, match="got 2 arenas"):
        pm.sharded_fused_deps_resolve(mesh, 1)(*fused[:6], fused[6] * 2, wt)
