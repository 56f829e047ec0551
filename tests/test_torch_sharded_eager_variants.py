"""The plain leg of accord_tpu_torch/tools/sharded_eager_variants.py on
the CPU at a tiny size: each eager sharded entry's one-card form (its
single-device twin's plain version) against its per-shard form (the plain
chain) on the same inputs, and the sharded burns with each form forced,
whose histories equal the single-device burns'. The tool's times are the
card's; here only that every pair is bit-equal and the legs run."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from accord_tpu_torch.ops import carry
from accord_tpu_torch.parallel import mesh as pm
from accord_tpu_torch.tools import sharded_eager_variants as sev


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _key(seed, cap, b=8, k=256):
    host = pm.example_resolve_batch(cap=cap, k=k, b=b, nnz=24, seed=seed)
    args = [_t(a) for a in host]
    args[4] = carry.packed(host[4])
    return args


def _inputs(name):
    rng = np.random.default_rng(3)
    b = 8
    key = _key(1, 256)
    table = key[8]
    if name == "deps_resolve":
        return key
    store = _t(rng.integers(0, 2, b).astype(np.int32))
    slots = _t(np.array([0, 1], np.int32))
    arenas = (tuple(key[4:8]), tuple(_key(2, 128)[4:8]))
    if name == "fused_deps_resolve":
        return (key[0], key[1], store, key[2], key[3], slots, arenas, table)
    iv_of = _t(rng.integers(0, b + 1, 16).astype(np.int32))
    s = rng.integers(0, 1 << 10, 16).astype(np.int32)
    ivs = (iv_of, _t(s), _t(s + rng.integers(1, 64, 16).astype(np.int32)))
    srng = _t(rng.random(b) < 0.5)
    rs = rng.integers(0, 1 << 10, 128).astype(np.int32)
    rar = (_t(rs), _t(rs + 40), key[5][:128], key[6][:128], key[7][:128])
    if name == "range_deps_resolve":
        return (*ivs, key[2], key[3], srng, *rar, *key[4:8], table)
    if name == "fused_range_deps_resolve":
        return (*ivs, store, key[2], key[3], srng, slots[:1], (rar,), slots,
                arenas, table)
    packed = pm.per_shard_deps_resolve(pm.make_mesh(devices=["cpu"] * 8),
                                       *key)
    return (packed, 0, _t(rng.integers(0, 1 << 31, (6, 8)).astype(np.int32)),
            _t(rng.integers(-1, b, 12).astype(np.int32)),
            _t(rng.integers(0, 6, 12).astype(np.int32)),
            _t(rng.integers(-1, 256, b).astype(np.int32)), key[5], 64)


@pytest.mark.parametrize("name", sev.ENTRIES)
def test_entry_pair_plain_leg(name):
    mesh = pm.make_mesh(devices=["cpu"] * 8)
    got = sev.entry_pair(mesh, name, _inputs(name), iters=1, rounds=1)
    assert got["bit_equal"]
    assert got["wall_ms"] > 0 and got["parent_wall_ms"] > 0
    assert "device_ms" not in got
    assert got["launches"] == got["parent_launches"] == 0


def test_finalize_candidates_plain_leg():
    mesh = pm.make_mesh(devices=["cpu"] * 8)
    args = _inputs("finalize_csr")
    got = sev.finalize_candidates(mesh, args[:7], {"out_cap": args[7]},
                                  iters=1, rounds=1)
    assert got["bit_equal"] and "k2_device_ms" not in got


def test_burns_plain_leg():
    """Tiny key, range-mix and mesh burns: the parent's and the new forms'
    histories equal the single-device burn's, and the new form's run
    called every one-card form it records (the fused key entry and the
    finalize at least)."""
    out, recs = sev.burns("cpu", (24, 20, (4, 10)))
    for leg, forms in out.items():
        assert forms["histories_equal"], leg
        assert forms["new"]["acked"] == forms["single"]["acked"] > 0, leg
    assert recs["key_burn"].n.get("one_card_finalize_csr", 0) > 0
    assert recs["mesh_burn"].n.get("one_card_fused_deps_resolve", 0) > 0
    assert recs["range_burn"].n.get("one_card_fused_range_deps_resolve",
                                    0) > 0 \
        or recs["range_burn"].n.get("one_card_range_deps_resolve", 0) > 0
